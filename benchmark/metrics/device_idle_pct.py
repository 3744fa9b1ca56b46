"""device_idle_pct: the share of a step in which no operation of this
process runs on the card: 1 - the device-busy time a step (the union of the
device operations' intervals in the device-only traced stretch, over its
steps) over the median unprofiled step of the same run (CUDA events), so
that the profiler's own host cost does not count as idle."""


def read(ctx, names):
    if not ctx["trace"]["ops"] or not ctx["step_s"]:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["steps"] / ctx["step_s"])
