"""k4_roofline: the PSF convolution's bound (K4 both ways at the step's
shapes, the cheaper algorithm's operations or the bytes, ``counts.k4_work``)
over the device time a step of the kernels its list file names."""
import counts
from metrics._kernels import seconds_a_step


def read(ctx, names):
    shape = ctx["shapes"].get("k4")
    t = seconds_a_step(ctx, names())
    if shape is None or t <= 0:
        return None
    return 100.0 * counts.bound_s(*counts.k4_work(shape))[0] / t
