"""Prior distributions (PyTorch port of :mod:`gigalens_tpu.prob.distributions`).

Normal, LogNormal, Uniform and TruncatedNormal: each carries an
``event_shape`` inferred from broadcasting its parameters, the same default
unconstraining ``bijector`` as the JAX package, and reparameterized
``sample(generator, sample_shape)`` drawing from a ``torch.Generator`` on
the generator's device.

Scalar parameters are kept as Python floats rounded to float32 (the JAX
package stores float32 arrays), so they broadcast against tensors on any
device without a host-to-device copy; array parameters are float32 tensors
moved to the operand's device where used.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from gigalens_tpu_torch.prob import bijectors as bij
from gigalens_tpu_torch.prob.bijectors import _log, _on

_LOG_2PI = math.log(2.0 * math.pi)


def _param(v):
    """float32-rounded Python float for a scalar, float32 CPU tensor otherwise."""
    a = np.asarray(v, np.float32)
    if a.ndim == 0:
        return float(a)
    return torch.tensor(a)


def _broadcast_event_shape(*params):
    return tuple(np.broadcast_shapes(*[np.shape(np.asarray(p)) for p in params]))


def _outside(lp, x, low, high):
    """-inf where x lies outside [low, high]."""
    return lp.masked_fill(~((x >= _on(low, x)) & (x <= _on(high, x))), -math.inf)


class Distribution:
    """Base class: scalar family broadcast over ``event_shape``."""

    event_shape: tuple = ()

    def sample(self, generator: torch.Generator, sample_shape=()):
        raise NotImplementedError

    def log_prob(self, x):
        """Sums over event dims; retains batch (sample) dims."""
        raise NotImplementedError

    @property
    def bijector(self) -> bij.Bijector:
        """Default unconstraining bijector (reals -> support)."""
        return bij.Identity()

    @property
    def event_size(self):
        return int(np.prod(self.event_shape, dtype=int)) if self.event_shape else 1

    def _sum_event(self, lp):
        n_event = len(self.event_shape)
        if n_event == 0:
            return lp
        return torch.sum(lp, dim=tuple(range(-n_event, 0)))

    def _draw(self, fn, generator, sample_shape):
        if isinstance(sample_shape, int):
            sample_shape = (sample_shape,)
        shape = tuple(sample_shape) + self.event_shape
        return fn(shape, generator=generator, device=generator.device,
                  dtype=torch.float32)


class Normal(Distribution):
    def __init__(self, loc, scale):
        self.event_shape = _broadcast_event_shape(loc, scale)
        self.loc, self.scale = _param(loc), _param(scale)

    def sample(self, generator, sample_shape=()):
        eps = self._draw(torch.randn, generator, sample_shape)
        return _on(self.loc, eps) + _on(self.scale, eps) * eps

    def log_prob(self, x):
        scale = _on(self.scale, x)
        z = (x - _on(self.loc, x)) / scale
        lp = -0.5 * (z**2 + _LOG_2PI) - _log(scale)
        return self._sum_event(lp)


class LogNormal(Distribution):
    def __init__(self, loc, scale):
        self.event_shape = _broadcast_event_shape(loc, scale)
        self.loc, self.scale = _param(loc), _param(scale)

    def sample(self, generator, sample_shape=()):
        eps = self._draw(torch.randn, generator, sample_shape)
        return torch.exp(_on(self.loc, eps) + _on(self.scale, eps) * eps)

    def log_prob(self, x):
        scale = _on(self.scale, x)
        logx = torch.log(x)
        z = (logx - _on(self.loc, x)) / scale
        lp = -0.5 * (z**2 + _LOG_2PI) - _log(scale) - logx
        return self._sum_event(lp)

    @property
    def bijector(self):
        return bij.Exp()


class Uniform(Distribution):
    def __init__(self, low, high):
        self.event_shape = _broadcast_event_shape(low, high)
        self.low, self.high = _param(low), _param(high)

    def sample(self, generator, sample_shape=()):
        u = self._draw(torch.rand, generator, sample_shape)
        low, high = _on(self.low, u), _on(self.high, u)
        return low + (high - low) * u

    def log_prob(self, x):
        width = _on(self.high, x) - _on(self.low, x)
        lp = torch.zeros_like(x) - _log(width)
        return self._sum_event(_outside(lp, x, self.low, self.high))

    @property
    def bijector(self):
        return bij.Sigmoid(self.low, self.high)


class TruncatedNormal(Distribution):
    """Normal(loc, scale) truncated to [low, high].

    Sampling is by inverse-CDF (``torch.special.ndtri``), so it is
    reparameterized in (loc, scale). The truncation constants are computed
    once, in float32 like the JAX package.
    """

    def __init__(self, loc, scale, low, high):
        self.event_shape = _broadcast_event_shape(loc, scale, low, high)
        self.loc, self.scale = _param(loc), _param(scale)
        self.low, self.high = _param(low), _param(high)

        def f32(v):
            return torch.tensor(np.asarray(v, np.float32))

        a = (f32(low) - f32(loc)) / f32(scale)
        b = (f32(high) - f32(loc)) / f32(scale)
        # Mirror right-tail windows (a > 0) into the left tail where ndtr
        # does not saturate: in float32 ndtr(8) == ndtr(10) == 1.0 exactly,
        # so the naive inverse-CDF would collapse every draw of a far
        # right-tail truncation to `high`.
        right = a > 0
        a_, b_ = torch.where(right, -b, a), torch.where(right, -a, b)
        fa, fb = torch.special.ndtr(a_), torch.special.ndtr(b_)
        self._fa, self._fb = _param(fa), _param(fb)
        self._sign = _param(torch.where(right, -1.0, 1.0))
        # log(Phi(b) - Phi(a)), stable for far-tail windows: computed in the
        # left tail via log_ndtr (scipy's truncnorm construction)
        la, lb = torch.special.log_ndtr(a_), torch.special.log_ndtr(b_)
        self._log_z = _param(lb + torch.log1p(-torch.exp(la - lb)))

    def sample(self, generator, sample_shape=()):
        u = self._draw(torch.rand, generator, sample_shape)
        u = 1e-7 + (1.0 - 2e-7) * u
        fa, fb = _on(self._fa, u), _on(self._fb, u)
        z = torch.special.ndtri(fa + u * (fb - fa))
        x = _on(self.loc, z) + _on(self.scale, z) * (_on(self._sign, z) * z)
        low, high = _on(self.low, x), _on(self.high, x)
        if isinstance(low, float):
            return torch.clamp(x, low, high)
        return torch.minimum(torch.maximum(x, low), high)

    def log_prob(self, x):
        scale = _on(self.scale, x)
        t = (x - _on(self.loc, x)) / scale
        lp = -0.5 * (t**2 + _LOG_2PI) - _log(scale) - _on(self._log_z, x)
        return self._sum_event(_outside(lp, x, self.low, self.high))

    @property
    def bijector(self):
        return bij.Sigmoid(self.low, self.high)
