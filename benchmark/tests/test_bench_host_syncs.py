"""``metrics/host_syncs_per_step.py`` on synthetic host-traced stretches:
the synchronising CUDA calls inside whole ``map.step`` spans, per step."""
import harness


def ev(name, t0, t1, corr=0):
    return (name, t0, t1, corr)


def read(host):
    reader = harness.load_module("metrics", "host_syncs_per_step")
    ctx = {"host_trace": {"host": sorted(host, key=lambda r: r[1]), "ops": [],
                          "annotations": []}, "host_steps": 3}
    return reader.read(ctx, lambda: [])


def step(t0, *calls):
    """A whole step at ``t0`` with the named CUDA calls inside."""
    return [ev("map.step", t0, t0 + 1000), ev("map.update", t0 + 800, t0 + 900),
            *(ev(name, t0 + 100 + 10 * k, t0 + 105 + 10 * k) for k, name in enumerate(calls))]


def test_counts_the_synchronising_calls_of_whole_steps():
    host = (step(0, "cudaLaunchKernel", "cudaMemcpyAsync", "cudaStreamSynchronize")
            + step(2000, "cudaMemcpy", "cudaLaunchKernel")
            # the profiler's stop inside the stretch's last, cut step
            + [ev("map.step", 4000, 4500), ev("cudaDeviceSynchronize", 4400, 4450)]
            # outside every step
            + [ev("cudaDeviceSynchronize", 1500, 1510)])
    assert read(host) == 1.0


def test_a_step_without_a_wait_reads_zero():
    host = step(0, "cudaLaunchKernel", "cudaMemcpyAsync", "cudaEventRecord") + step(
        2000, "cuLaunchKernel")
    assert read(host) == 0.0


def test_a_program_without_the_span_reads_nothing():
    assert read([ev("cudaStreamSynchronize", 0, 5), ev("map.update", 10, 20)]) is None
