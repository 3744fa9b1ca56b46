"""inversion_build_ms: device milliseconds a step outside the kernels its
list file names (``kernel:`` substrings) and outside the program's ranges it
names (``range:`` prefixes of record_function names, whose device-side
spans hold the Gram's and the Cholesky's cuBLAS and cuSOLVER kernels): the
mapping build and the rest of the step. Read from the traced stretch that
records host activity, where those ranges exist."""
import bisect


def read(ctx, names):
    kernels = [n[len("kernel:"):] for n in names() if n.startswith("kernel:")]
    ranges = [n[len("range:"):] for n in names() if n.startswith("range:")]
    trace = ctx["host_trace"]
    spans = sorted((t0, t1) for name, t0, t1, _ in trace["annotations"]
                   if any(name.startswith(r) for r in ranges))
    if not spans:
        return None
    starts = [a for a, _ in spans]
    rest = 0
    for name, t0, t1, _ in trace["ops"]:
        if any(k in name for k in kernels):
            continue
        i = bisect.bisect_right(starts, t0) - 1
        if i >= 0 and t1 <= spans[i][1]:
            continue
        rest += t1 - t0
    return rest * 1e-6 / ctx["host_steps"]
