"""host_syncs_per_step: the CUDA calls that make the host wait for the card
(``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``, their driver forms, and a synchronous
``cudaMemcpy*``) that a MAP step makes, in the host-traced stretch: those
inside a ``map.step`` span that ran whole (it holds its ``map.update``;
the stretch's last step is cut by the profiler's stop, whose own
synchronise it holds), over the number of such spans. After such a call
the card has drained, and it waits for whatever the host issues next.
Nothing where the stretch has no whole ``map.step`` span (a program
without the span)."""

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize")


def is_sync(name):
    return name in SYNCS or (name.startswith(("cudaMemcpy", "cuMemcpy"))
                             and "Async" not in name)


def read(ctx, names):
    host = ctx["host_trace"]["host"]
    updates = [t0 for name, t0, _, _ in host if name == "map.update"]
    steps = [(t0, t1) for name, t0, t1, _ in host
             if name == "map.step" and any(t0 <= u <= t1 for u in updates)]
    if not steps:
        return None
    calls = [t0 for name, t0, _, _ in host if is_sync(name)]
    return sum(any(s0 <= t <= s1 for s0, s1 in steps) for t in calls) / len(steps)
