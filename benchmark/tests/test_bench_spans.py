"""The span readers (``metrics/_spans.py`` and the ten ``<layer>_launches`` /
``<layer>_idle_ms`` metrics) on synthetic host-traced stretches: each device
operation to the innermost program span around its launch, found by
correlation id, with the idle gap that ends at it."""
import pytest

import harness
from metrics import _spans

LAYERS = ("loop", "prior", "likelihood", "simulator", "autograd")


def ev(name, t0, t1, corr=0):
    return (name, t0, t1, corr)


def launch(t, corr, name="cudaLaunchKernel"):
    return ev(name, t, t + 5, corr)


def ctx_of(host, ops, steps=1):
    host = sorted(host, key=lambda r: r[1])
    ops = sorted(ops, key=lambda r: r[1])
    return {"host_trace": {"host": host, "ops": ops, "annotations": []}, "host_steps": steps}


def read(ctx, metric):
    reader = harness.load_module("metrics", metric)
    return reader.read(ctx, lambda: harness.list_file(metric))


def readings(ctx, kind):
    return {layer: read(ctx, f"{layer}_{kind}") for layer in LAYERS}


def step_trace():
    """One MAP step: the prior inside the likelihood, the likelihood's own
    tail, the loss in map.step's own code, the update."""
    host = [ev("map.step", 0, 1000), ev("likelihood.log_prob", 100, 500),
            ev("prior.constrain", 150, 250), ev("aten::exp", 155, 170), launch(160, 1),
            ev("aten::sum", 290, 310), launch(300, 2), launch(600, 3),
            ev("map.update", 700, 900), launch(750, 4)]
    ops = [ev("k1", 200, 220, 1), ev("k2", 320, 400, 2), ev("k3", 650, 660, 3),
           ev("k4", 800, 810, 4)]
    return host, ops


def test_operations_and_gaps_go_to_the_innermost_span():
    ctx = ctx_of(*step_trace())
    assert readings(ctx, "launches") == {"loop": 2, "prior": 1, "likelihood": 1,
                                         "simulator": None, "autograd": None}
    idle = readings(ctx, "idle_ms")
    assert idle["prior"] == 0.0  # the stretch's first operation ends no gap
    assert idle["likelihood"] == pytest.approx(100e-6)
    assert idle["loop"] == pytest.approx((250 + 140) * 1e-6)


def test_a_span_of_the_autograd_thread_inside_map_backward_owns_its_launches():
    host = [ev("map.step", 0, 3000), ev("map.backward", 1000, 2000),
            # opened on autograd's device thread while the caller waits
            ev("simulator.render_backward", 1200, 1300), launch(1250, 5),
            ev("direct_conv_transpose", 1500, 1600), launch(1550, 6),
            ev("autograd::engine::evaluate_function: MulBackward0", 1700, 1800),
            launch(1750, 7)]
    ops = [ev("fused_builder_bwd", 1260, 1290, 5), ev("direct_conv", 1560, 1590, 6),
           ev("elementwise", 1900, 1910, 7)]
    ctx = ctx_of(host, ops, steps=2)
    got = readings(ctx, "launches")
    assert got["simulator"] == 1.0 and got["autograd"] == 0.5
    assert read(ctx, "autograd_idle_ms") == pytest.approx(310e-6 / 2)
    assert read(ctx, "simulator_idle_ms") == pytest.approx(270e-6 / 2)


def test_a_driver_launch_maps_by_correlation_id():
    host = [ev("simulator.render", 0, 100), launch(10, 9, name="cuLaunchKernelEx"),
            ev("prior.fldj", 200, 300), launch(210, 11, name="cudaMemsetAsync")]
    ops = [ev("triton_kernel", 50, 60, 9), ev("Memset (Device)", 220, 230, 11)]
    ctx = ctx_of(host, ops)
    assert read(ctx, "simulator_launches") == 1 and read(ctx, "prior_launches") == 1
    assert read(ctx, "prior_idle_ms") == pytest.approx(160e-6)


def test_an_operation_launched_outside_every_program_span_has_no_layer():
    host, ops = step_trace()
    # a launch before the step, one under a range no list file names, one
    # whose correlation id no launch carries
    host += [launch(-50, 20), ev("inversion.gram", 1100, 1200), launch(1150, 21)]
    ops += [ev("early", -40, -30, 20), ev("gemm", 1160, 1190, 21), ev("orphan", 1300, 1310, 99)]
    ctx = ctx_of(host, ops)
    owners = [o for o, _ in _spans.owners(ctx)]
    assert owners == [None, "prior.constrain", "likelihood.log_prob", "map.step", "map.update",
                      None, None]
    assert sum(v or 0 for v in readings(ctx, "launches").values()) == len(ops) - 3


def test_each_layer_lists_the_same_spans_for_both_metrics():
    for layer in LAYERS:
        assert harness.list_file(f"{layer}_launches") == harness.list_file(f"{layer}_idle_ms")
    assert _spans.program_prefixes() == sorted(
        ["map.step", "map.update", "prior.", "likelihood.", "simulator.", "direct_conv_",
         "map.backward"])
