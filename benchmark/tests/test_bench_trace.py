"""The trace's arithmetic and the per-layer readers on synthetic traces:
busy time as a union, idle gaps by the host operation that launched the
next device operation, the breakdown's lists, and each reader's number
from kernel times and the cell's shapes."""
import pytest

import counts
import harness


def op(name, t0, t1, corr=0):
    return (name, t0, t1, corr)


def test_busy_is_the_union_of_device_operations():
    ops = [op("a", 0, 10), op("b", 5, 20), op("c", 30, 40)]
    assert harness.busy_ns(ops) == 30


def test_idle_gaps_go_to_the_host_operation_around_the_next_launch():
    trace = {"ops": [op("k1", 100, 200, 1), op("k2", 260, 300, 2), op("k3", 400, 450, 3)],
             "host": [op("aten::mul", 150, 250), op("cudaLaunchKernel", 240, 245, 2),
                      op("aten::copy_", 330, 390), op("cudaLaunchKernel", 380, 385, 3),
                      op("cudaLaunchKernel", 90, 95, 1)]}
    gaps = harness.idle_gaps(trace)
    assert gaps == pytest.approx({"aten::mul": 60e-9, "aten::copy_": 100e-9})
    out = harness.breakdown(trace, trace)
    assert out["device_ops"][0][0] == "k1" and out["device_ops"][0][1] == pytest.approx(100e-9)
    assert len(out["device_ops"]) <= 10 and len(out["idle_gaps"]) <= 10


def shapes():
    return {"k4": {"images": 8000, "h": 160, "w": 160, "kh": 51, "kw": 51, "pool": 2},
            "render": {"rows": 500, "pixels": 25600, "components": 16, "params": 17,
                       "fwd_ops_per_row_pixel": 366.3, "bwd_ops_per_row_pixel": 1550.0},
            "lstsq": {"rows": 500, "pixels": 6400, "depth": 16}}


def ctx_with(ops, steps=10, step_s=0.033, annotations=()):
    trace = {"ops": ops, "annotations": list(annotations), "host": []}
    return dict(trace=trace, host_trace=trace, steps=steps, host_steps=steps,
                window_s=0.4, busy_s=harness.busy_ns(ops) * 1e-9, step_s=step_s,
                shapes=shapes())


def test_k4_bound_is_the_direct_sum_at_the_lstsq_shape():
    ops, nbytes = counts.k4_work(shapes()["k4"])
    assert ops == 2 * 2 * 8000 * 80 * 80 * 52 * 52
    t, by = counts.bound_s(ops, nbytes)
    assert by == "operations" and t == pytest.approx(ops / 67e12)


def test_readers_from_kernel_times():
    k4_s = 2 * counts.bound_s(*counts.k4_work(shapes()["k4"]))[0]  # twice the bound a step
    ops = [op("void direct_conv<5, 5, 1>", 0, int(10 * k4_s * 1e9)),
           op("fused_builder_bwd", 0, 10)]
    ctx = ctx_with(ops)
    k4 = harness.load_module("metrics", "k4_roofline")
    assert k4.read(ctx, lambda: ["direct_conv"]) == pytest.approx(50.0, rel=1e-6)
    launches = harness.load_module("metrics", "launches_per_step")
    assert launches.read(ctx, None) == pytest.approx(0.2)
    idle = harness.load_module("metrics", "device_idle_pct")
    assert idle.read(ctx, None) == pytest.approx(100 * (1 - k4_s / 0.033), rel=1e-6)
    mfu = harness.load_module("metrics", "step_mfu")
    fwd, bwd = counts.render_work(shapes()["render"])
    want = counts.k4_work(shapes()["k4"])[0] + fwd[0] + bwd[0] + counts.lstsq_ops(shapes()["lstsq"])
    assert mfu.read(ctx, None) == pytest.approx(100 * want / 0.033 / 67e12)
    builder = harness.load_module("metrics", "builder_roofline")
    assert builder.read(ctx_with([op("direct_conv", 0, 10)]), lambda: ["fused_builder"]) is None


def test_mapping_build_is_what_lies_outside_the_ranges_and_k4():
    ops = [op("direct_conv<5, 5, 1>", 0, 1000), op("gemm", 1000, 3000),
           op("elementwise_mul", 3000, 7000), op("potrf", 7000, 8000)]
    ann = [op("inversion.gram", 900, 3100), op("inversion.cholesky", 6900, 8100)]
    ctx = ctx_with(ops, steps=2, annotations=ann)
    reader = harness.load_module("metrics", "inversion_build_ms")
    names = ["kernel:direct_conv", "range:inversion.gram", "range:inversion.cholesky"]
    assert reader.read(ctx, lambda: names) == pytest.approx(4000e-6 / 2)
    assert reader.read(ctx_with(ops), lambda: names) is None
