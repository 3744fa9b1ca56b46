"""builder_roofline: the composable render's bound (the component render
forward and its gradient at the step's shapes, each the larger of its
operations and its bytes, ``counts.render_work``) over the device time a
step of the kernels its list file names."""
import counts
from metrics._kernels import seconds_a_step


def read(ctx, names):
    shape = ctx["shapes"].get("render")
    t = seconds_a_step(ctx, names())
    if shape is None or t <= 0:
        return None
    fwd, bwd = counts.render_work(shape)
    return 100.0 * (counts.bound_s(*fwd)[0] + counts.bound_s(*bwd)[0]) / t
