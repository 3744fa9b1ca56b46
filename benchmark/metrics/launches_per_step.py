"""launches_per_step: device operations (kernels, copies and fills, the
program's own and PyTorch's) in the traced stretch, per MAP step."""


def read(ctx, names):
    ops = ctx["trace"]["ops"]
    return len(ops) / ctx["steps"] if ops else None
