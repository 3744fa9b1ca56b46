"""step_mfu: the FP32 operations a MAP step needs, counted from the
configuration's shapes (the render forward and gradient, K4 both ways, the
least-squares normal equations, the inversion's Gram, Cholesky and solves),
over the median unprofiled step time of the traced run, as a share of the
card's FP32 peak."""
import counts


def read(ctx, names):
    s, t = ctx["shapes"], ctx["step_s"]
    if not t:
        return None
    ops = 0.0
    if "k4" in s:
        ops += counts.k4_work(s["k4"])[0]
    if "render" in s:
        fwd, bwd = counts.render_work(s["render"])
        ops += fwd[0] + bwd[0]
    if "lstsq" in s:
        ops += counts.lstsq_ops(s["lstsq"])
    if "gram" in s:
        ops += counts.gram_ops(s["gram"])
    return 100.0 * ops / t / counts.PEAKS["fp32_flops"]
