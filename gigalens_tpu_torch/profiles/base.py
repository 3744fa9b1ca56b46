"""Profile base classes (PyTorch port of :mod:`gigalens_tpu.profiles.base`).

Mass profiles expose ``deriv(x, y, **params) -> (alpha_x, alpha_y)``; light
profiles expose ``light(x, y, **params)``. Coordinates and per-sample
parameters only need to be mutually broadcastable: the simulator calls
profiles with coordinates shaped ``(npix,)`` and parameters shaped
``(bs, 1)``, giving batch-leading ``(bs, npix)`` outputs.

The default ``hessian`` is forward mode (``torch.func.jvp``) where ``deriv``
is plain tensor ops; a profile whose ``deriv`` crosses an
``autograd.Function`` (EPL) takes :meth:`MassProfile.hessian_vjp`, two
reverse-mode ``torch.autograd.grad`` calls with ``create_graph=True``, so
both stay differentiable in the parameters.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List

import torch


class Parameterized(ABC):
    """A named profile with an ordered list of learnable parameter names."""

    _name: str
    _params: List[str]

    def __init__(self, *args, **kwargs):
        self.name = self._name
        self.params = list(self._params)

    def __str__(self):
        return self.name

    def __repr__(self):
        return f"{type(self).__name__}({self.name})"


class MassProfile(Parameterized, ABC):
    """Interface for a mass (deflector) profile."""

    @abstractmethod
    def deriv(self, x, y, **params):
        """Deflection angle (alpha_x, alpha_y) at image-plane coords (x, y)."""

    def hessian(self, x, y, **params):
        """Deflection Jacobian (f_xx, f_xy, f_yx, f_yy) by forward mode.

        Profiles with closed forms override this (SIS, Shear, NFW); a
        profile whose ``deriv`` crosses an ``autograd.Function`` (EPL)
        overrides it with :meth:`hessian_vjp`."""
        x, y = torch.as_tensor(x), torch.as_tensor(y)

        def f(xx, yy):
            return torch.stack(self.deriv(xx, yy, **params))

        ones, zeros = torch.ones_like(x), torch.zeros_like(y)
        _, (f_xx, f_yx) = torch.func.jvp(f, (x, y), (ones, zeros))
        _, (f_xy, f_yy) = torch.func.jvp(f, (x, y), (zeros, ones))
        return f_xx, f_xy, f_yx, f_yy

    def hessian_vjp(self, x, y, **params):
        """Reverse-mode Hessian (the reference's VJP-basis trick): two
        ``torch.autograd.grad`` calls with ``create_graph=True``, so the
        result stays differentiable in the parameters through an
        ``autograd.Function``'s differentiable backward.

        The coordinates are first broadcast to the output's shape, so each
        output element has a coordinate of its own and the rows are exact
        per sample. (The JAX package differentiates the unbroadcast
        coordinates, which sums the Hessian over the batch when the
        parameters carry one; ROADMAP F-ref-5.)"""
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        shape = torch.broadcast_shapes(x.shape, y.shape,
                                       *(torch.as_tensor(v).shape for v in params.values()))
        keep_graph = _needs_graph(x, y, *params.values())
        with torch.enable_grad():
            xb, yb = (_grad_leaf(torch.broadcast_to(c, shape)) for c in (x, y))
            fx, fy = self.deriv(xb, yb, **params)
            ones, zeros = torch.ones_like(fx), torch.zeros_like(fx)
            f_xx, f_yx = torch.autograd.grad((fx, fy), (xb, yb), (ones, zeros),
                                             create_graph=True, allow_unused=True)
            f_xy, f_yy = torch.autograd.grad((fx, fy), (xb, yb), (zeros, ones),
                                             create_graph=True, allow_unused=True)
        out = tuple(torch.zeros_like(fx) if g is None else g
                    for g in (f_xx, f_xy, f_yx, f_yy))
        return out if keep_graph else tuple(g.detach() for g in out)

    def potential(self, x, y, **params):
        """Lensing potential ``psi`` with ``grad(psi) == deriv``; needed only
        for time delays (the Fermat potential)."""
        raise NotImplementedError(
            f"{self.name} does not implement the lensing potential; time "
            "delays require potential() on every deflector in the model"
        )

    def convergence(self, x, y, **params):
        f_xx, _, _, f_yy = self.hessian(x, y, **params)
        return (f_xx + f_yy) / 2

    def shear(self, x, y, **params):
        f_xx, f_xy, _, f_yy = self.hessian(x, y, **params)
        return (f_xx - f_yy) / 2, f_xy


def _needs_graph(*values):
    """Whether a result computed from ``values`` must carry a graph: grad
    mode is on and some value requires grad."""
    return torch.is_grad_enabled() and any(
        isinstance(v, torch.Tensor) and v.requires_grad for v in values)


def _like(v, x):
    """``v`` as a tensor on ``x``'s device: a tensor keeps its dtype,
    anything else (a Python number, a numpy value) takes ``x``'s."""
    if isinstance(v, torch.Tensor):
        return v.to(x.device)
    return torch.as_tensor(v, dtype=x.dtype, device=x.device)


def _grad_leaf(t):
    """``t`` as a tensor that autograd can differentiate with respect to:
    itself (through a copy) when it already carries a graph, else a fresh
    leaf."""
    if t.requires_grad:
        return t * 1.0
    return t.detach().clone().requires_grad_(True)


class LightProfile(Parameterized, ABC):
    """Interface for a light (surface-brightness) profile.

    ``use_lstsq`` marks the amplitude(s) as linear parameters solved by the
    simulator's weighted least squares instead of being sampled; ``depth`` is
    the number of linear components this profile contributes.
    """

    _amp = "Ie"

    def __init__(self, use_lstsq: bool = False, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._use_lstsq = bool(use_lstsq)
        self.depth = 1
        # profiles with numbered amplitudes (shapelets) set _amp = "" and
        # manage their own amplitude params
        if self._amp and not self._use_lstsq and self._amp not in self.params:
            self.params.append(self._amp)

    @property
    def use_lstsq(self) -> bool:
        return self._use_lstsq

    @use_lstsq.setter
    def use_lstsq(self, use_lstsq: bool):
        if self._amp:
            if use_lstsq and not self._use_lstsq:
                self.params.remove(self._amp)
            elif not use_lstsq and self._use_lstsq:
                self.params.append(self._amp)
        self._use_lstsq = bool(use_lstsq)

    @abstractmethod
    def light(self, x, y, **params):
        """Surface brightness at (x, y), broadcast over (batch..., pixels);
        in lstsq mode a leading component axis of size ``depth`` is
        prepended instead of multiplying by the amplitude."""


def rotate(x, y, phi):
    """Rotates coordinates by angle -phi (the lensing-standard frame change)."""
    cos_phi, sin_phi = torch.cos(phi), torch.sin(phi)
    return x * cos_phi + y * sin_phi, -x * sin_phi + y * cos_phi


def hessian_rotate(f_xx, f_xy, f_yy, phi):
    """Transforms a symmetric Hessian back through ``rotate``: R H R^T."""
    cos_2phi = torch.cos(2 * phi)
    sin_2phi = torch.sin(2 * phi)
    a = 0.5 * (f_xx + f_yy)
    b = 0.5 * (f_xx - f_yy) * cos_2phi
    c = f_xy * sin_2phi
    d = f_xy * cos_2phi
    e = 0.5 * (f_xx - f_yy) * sin_2phi
    return a + b + c, d - e, a - b - c


def ellipticity_to_polar(e1, e2, e_max=0.9999):
    """(e1, e2) -> (modulus e, axis ratio q, position angle phi).

    Hardened at exactly e1 = e2 = 0 like the JAX package: the epsilon goes
    inside the sqrt, and the angle's arguments are swapped for the constant
    (0, 1) in the degenerate region so phi = 0 with zero gradient.
    """
    degenerate = (e1 * e1 + e2 * e2) < 1e-24
    phi = torch.atan2(
        torch.where(degenerate, torch.zeros_like(e2), e2),
        torch.where(degenerate, torch.ones_like(e1), e1),
    ) / 2
    e = torch.clamp(torch.sqrt(e1**2 + e2**2 + 1e-24), max=e_max)
    q = (1 - e) / (1 + e)
    return e, q, phi
