"""Shared by the per-layer readers: device seconds a step of the
operations whose names match a metric's list file (one substring a
line)."""


def seconds_a_step(ctx, patterns):
    total = sum((t1 - t0) for name, t0, t1, _ in ctx["trace"]["ops"]
                if any(p in name for p in patterns))
    return total * 1e-9 / ctx["steps"]
