"""simulator_launches: device operations a step launched inside the simulator's
spans (``metrics/_spans.py``)."""
from metrics import _spans


def read(ctx, names):
    return _spans.launches(ctx, names())
