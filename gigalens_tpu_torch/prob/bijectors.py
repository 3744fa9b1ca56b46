"""Unconstraining bijectors (PyTorch port of :mod:`gigalens_tpu.prob.bijectors`).

The elementwise bijectors of the priors (Identity, Exp, Softplus, Sigmoid,
Scale, Shift, Chain) and ``FillScaleTriL``, the SVI covariance factor's
parameterization. Each is a stateless object with ``forward``
(unconstrained -> constrained), ``inverse`` and
``forward_log_det_jacobian``, with TFP's convention
``log p(z) = log p(x=forward(z)) + fldj(z)``.
"""
from __future__ import annotations

import math

import torch


def _on(v, like):
    """A parameter next to ``like``: floats pass through, tensors are moved."""
    if isinstance(v, torch.Tensor):
        return v.to(device=like.device, dtype=like.dtype)
    return v


def _log(v):
    return torch.log(v) if isinstance(v, torch.Tensor) else math.log(v)


class Bijector:
    """Elementwise bijector base class."""

    def forward(self, z):
        raise NotImplementedError

    def inverse(self, x):
        raise NotImplementedError

    def forward_log_det_jacobian(self, z):
        """Elementwise log|d forward / dz|."""
        raise NotImplementedError

    # short alias used throughout the package
    def fldj(self, z):
        return self.forward_log_det_jacobian(z)

    def __repr__(self):
        return type(self).__name__


class Identity(Bijector):
    def forward(self, z):
        return z

    def inverse(self, x):
        return x

    def forward_log_det_jacobian(self, z):
        return torch.zeros_like(z)


class Exp(Bijector):
    def forward(self, z):
        return torch.exp(z)

    def inverse(self, x):
        return torch.log(x)

    def forward_log_det_jacobian(self, z):
        return z


def _softplus(z):
    # log(1 + e^z) without torch's linear cut-over above 20 (JAX's softplus
    # is the exact logaddexp(z, 0))
    return torch.logaddexp(z, torch.zeros((), dtype=z.dtype, device=z.device))


class Sigmoid(Bijector):
    """Maps the real line onto the open interval (low, high)."""

    def __init__(self, low=0.0, high=1.0):
        self.low = low
        self.high = high

    def forward(self, z):
        low, high = _on(self.low, z), _on(self.high, z)
        return low + (high - low) * torch.sigmoid(z)

    def inverse(self, x):
        low, high = _on(self.low, x), _on(self.high, x)
        u = (x - low) / (high - low)
        return torch.log(u) - torch.log1p(-u)

    def forward_log_det_jacobian(self, z):
        # log(high-low) + log sigmoid(z) + log sigmoid(-z)
        width = _on(self.high, z) - _on(self.low, z)
        return _log(width) - _softplus(-z) - _softplus(z)


class Softplus(Bijector):
    def __init__(self, shift: float = 0.0):
        self.shift = shift

    def forward(self, z):
        return _softplus(z) + self.shift

    def inverse(self, x):
        x = x - self.shift
        # log(exp(x) - 1) computed stably
        return x + torch.log(-torch.expm1(-x))

    def forward_log_det_jacobian(self, z):
        return -_softplus(-z)


class Scale(Bijector):
    def __init__(self, scale):
        self.scale = scale

    def forward(self, z):
        return z * _on(self.scale, z)

    def inverse(self, x):
        return x / _on(self.scale, x)

    def forward_log_det_jacobian(self, z):
        s = _on(self.scale, z)
        log_abs = torch.log(torch.abs(s)) if isinstance(s, torch.Tensor) else math.log(abs(s))
        return torch.zeros_like(z) + log_abs


class Shift(Bijector):
    def __init__(self, shift):
        self.shift = shift

    def forward(self, z):
        return z + _on(self.shift, z)

    def inverse(self, x):
        return x - _on(self.shift, x)

    def forward_log_det_jacobian(self, z):
        return torch.zeros_like(z)


class Chain(Bijector):
    """Applies bijectors right-to-left (TFP convention): Chain([a, b]) == a(b(z))."""

    def __init__(self, bijectors):
        self.bijectors = tuple(bijectors)

    def forward(self, z):
        for b in reversed(self.bijectors):
            z = b.forward(z)
        return z

    def inverse(self, x):
        for b in self.bijectors:
            x = b.inverse(x)
        return x

    def forward_log_det_jacobian(self, z):
        total = torch.zeros_like(z)
        for b in reversed(self.bijectors):
            total = total + b.forward_log_det_jacobian(z)
            z = b.forward(z)
        return total


def _tril_flat_index(d, device):
    """Flat (row * d + col) positions of the lower triangle, row-major."""
    rows, cols = torch.tril_indices(d, d, device=device)
    return rows * d + cols


def fill_triangular(vec, d):
    """Packs a length d(d+1)/2 vector into a lower-triangular (d, d) matrix.

    Row-major over the lower triangle (``torch.tril_indices`` order), as the
    JAX package packs it, so ``fill_triangular(m[tril_indices(d)], d) ==
    tril(m)`` and a flat SVI vector is interchangeable between the two
    packages. This is **not** TFP's packing. Supports leading batch
    dimensions on ``vec``.
    """
    batch = vec.shape[:-1]
    out = torch.zeros((*batch, d * d), dtype=vec.dtype, device=vec.device)
    out = out.index_copy(-1, _tril_flat_index(d, vec.device), vec)
    return out.reshape(*batch, d, d)


def fill_triangular_inverse(mat):
    d = mat.shape[-1]
    flat = mat.reshape(*mat.shape[:-2], d * d)
    return flat[..., _tril_flat_index(d, mat.device)]


class FillScaleTriL(Bijector):
    """Vector of length d(d+1)/2 -> lower-triangular scale matrix.

    Off-diagonal entries pass through; diagonal entries go through ``diag_bij``
    (default Exp) plus ``diag_shift``, so the result is positive-definite.
    """

    def __init__(self, d, diag_bij: Bijector | None = None, diag_shift: float = 1e-6):
        self.d = d
        self.diag_bij = Exp() if diag_bij is None else diag_bij
        self.diag_shift = diag_shift

    def _eye(self, like):
        return torch.eye(self.d, dtype=torch.bool, device=like.device)

    def forward(self, z):
        m = fill_triangular(z, self.d)
        diag = self.diag_bij.forward(torch.diagonal(m, dim1=-2, dim2=-1)) + self.diag_shift
        return torch.where(self._eye(m), torch.diag_embed(diag), m)

    def inverse(self, x):
        diag = torch.diagonal(x, dim1=-2, dim2=-1) - self.diag_shift
        m = torch.where(self._eye(x), torch.diag_embed(self.diag_bij.inverse(diag)), x)
        return fill_triangular_inverse(m)

    def forward_log_det_jacobian(self, z):
        # only the diagonal entries have a nontrivial Jacobian
        diag_z = torch.diagonal(fill_triangular(z, self.d), dim1=-2, dim2=-1)
        return torch.sum(self.diag_bij.forward_log_det_jacobian(diag_z), dim=-1)
