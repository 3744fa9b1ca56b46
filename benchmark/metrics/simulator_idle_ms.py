"""simulator_idle_ms: device idle ms a step in the gaps that end at operations
launched inside the simulator's spans (``metrics/_spans.py``)."""
from metrics import _spans


def read(ctx, names):
    return _spans.idle_ms(ctx, names())
