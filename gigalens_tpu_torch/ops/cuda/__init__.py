"""Hand-written CUDA kernels for Hopper (``csrc/``) and their PyTorch twins.

Importing this package builds nothing: ``nvcc`` runs at the first kernel
launch (:func:`_build.load`).
"""
from gigalens_tpu_torch.ops.cuda import dft_conv, fused_render


def launch_counts() -> dict:
    """Kernel launch counts since the last :func:`reset_launch_counts`."""
    return {**fused_render.launches, **dft_conv.launches}


def reset_launch_counts() -> None:
    for counts in (fused_render.launches, dft_conv.launches):
        for k in counts:
            counts[k] = 0


__all__ = ["dft_conv", "fused_render", "launch_counts", "reset_launch_counts"]
