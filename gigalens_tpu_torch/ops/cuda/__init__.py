"""Hand-written CUDA kernels for Hopper (``csrc/``) and their PyTorch twins.

Importing this package builds nothing: ``nvcc`` runs at the first kernel
launch (:func:`_build.load`).
"""
from gigalens_tpu_torch.ops.cuda import (direct_conv, dft_conv, fused_builder, fused_render,
                                         gram_pinv)

_COUNTERS = (fused_render.launches, dft_conv.launches, direct_conv.launches,
             fused_builder.launches, gram_pinv.launches)


def launch_counts() -> dict:
    """Kernel launch counts since the last :func:`reset_launch_counts`."""
    out = {}
    for counts in _COUNTERS:
        out.update(counts)
    return out


def reset_launch_counts() -> None:
    for counts in _COUNTERS:
        for k in counts:
            counts[k] = 0


__all__ = ["dft_conv", "direct_conv", "fused_builder", "fused_render", "gram_pinv",
           "launch_counts", "reset_launch_counts"]
