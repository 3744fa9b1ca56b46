"""gigalens_tpu_torch — the PyTorch/CUDA port of :mod:`gigalens_tpu`.

Module paths mirror the JAX package so each counterpart is easy to find.
The hot path (the fused EPL+Shear+Sersic render and the composable fused
render for every other supported model, forward and backward, and the
DFT-by-matmul PSF convolution) runs as hand-written CUDA kernels for
Hopper (``csrc/``), built with ``nvcc`` at first use; every kernel has a
plain PyTorch twin in the same module, which the wrapper takes for CPU
tensors only.
"""
import torch

# Full f32 everywhere: the exact (HMC/SMC) likelihood path cannot tolerate
# TF32's ~3 decimal digits (low-precision PSF-conv noise of ~0.3 nats wrecks
# Metropolis acceptance; see gigalens_tpu/inference/sequence.py). These are
# PyTorch's defaults for matmul but not for cuDNN; set both explicitly.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from gigalens_tpu_torch.config import SimulatorConfig  # noqa: E402
from gigalens_tpu_torch.model import PhysicalModel  # noqa: E402

__all__ = ["SimulatorConfig", "PhysicalModel", "__version__"]
