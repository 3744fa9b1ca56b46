"""Unconstraining bijectors (PyTorch port of :mod:`gigalens_tpu.prob.bijectors`).

Only the bijectors that the Normal, LogNormal, Uniform and TruncatedNormal
priors use. Each is a stateless object with ``forward`` (unconstrained ->
constrained), ``inverse`` and ``forward_log_det_jacobian``, elementwise, with
TFP's convention ``log p(z) = log p(x=forward(z)) + fldj(z)``.
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

