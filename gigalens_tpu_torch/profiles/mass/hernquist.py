"""Hernquist-profile deflectors, spherical and elliptical (port of
:mod:`gigalens_tpu.profiles.mass.hernquist`).

Keeton (2001) closed forms with lenstronomy's ``HERNQUIST`` conventions
(``sigma0`` the characteristic convergence, ``Rs`` the scale radius). Every
piecewise function is a total ``torch.where`` with branch-safe inputs, and
the x = 1 branch point is covered by a two-sided Taylor series, so
``deriv`` and ``hessian`` are float32-stable and differentiable everywhere.
"""
from __future__ import annotations

import torch

from gigalens_tpu_torch.profiles.base import MassProfile, ellipticity_to_polar, rotate

_R_MIN = 1e-7
_X_MIN = 1e-6

# two-sided Taylor series at x = 1 (t = x - 1) of
#   alpha/x' = x(1-F)/(x^2-1)         (deflection shape)
#   kappa    = ((2+x^2)F - 3)/(x^2-1)^2  (convergence shape)
_BRANCH_DELTA = 0.03
_ALPHA_SERIES = (1 / 3, -1 / 15, -1 / 35, 17 / 315, -37 / 693)
_KAPPA_SERIES = (4 / 15, -16 / 35, 8 / 15, -368 / 693, 1468 / 3003)


def _horner(t, coeffs):
    acc = torch.full_like(t, coeffs[-1])
    for c in coeffs[-2::-1]:
        acc = acc * t + c
    return acc


def _hern_f(x):
    """F(x): the arctanh/arctan special function; F(1) = 1.

    Below x = 1/2, arctanh(s) with s = sqrt(1 - x^2) is computed as
    log1p((1 + s - x) / x), the same function: arctanh(s), as the JAX
    package computes it, loses digits as s -> 1 and is inf once 1 - x^2
    rounds to 1 in float32 (x below ~2.4e-4, a pixel within ~1e-4 arcsec
    of the centre), with a NaN gradient (ROADMAP F-ref-8)."""
    x = torch.clamp(x, min=_X_MIN)
    x_lo = torch.where(x < 1, x, torch.full_like(x, 0.5))
    x_hi = torch.where(x > 1, x, torch.full_like(x, 2.0))
    s_lo = torch.sqrt(1.0 - x_lo**2)
    small = x_lo < 0.5
    atanh = torch.where(small, torch.log1p((1.0 + s_lo - x_lo) / x_lo),
                        torch.arctanh(torch.where(small, torch.full_like(s_lo, 0.5), s_lo)))
    lo = atanh / s_lo
    hi = torch.arctan(torch.sqrt(x_hi**2 - 1.0)) / torch.sqrt(x_hi**2 - 1.0)
    return torch.where(x < 1, lo, hi)


def _alpha_shape(x):
    """x (1 - F(x)) / (x^2 - 1), series-patched at x = 1 (value 1/3 there)."""
    x = torch.clamp(x, min=_X_MIN)
    near = torch.abs(x - 1.0) < _BRANCH_DELTA
    x_safe = torch.where(near, torch.full_like(x, 2.0), x)
    closed = x_safe * (1.0 - _hern_f(x_safe)) / (x_safe**2 - 1.0)
    return torch.where(near, _horner(x - 1.0, _ALPHA_SERIES), closed)


def _kappa_shape(x):
    """((2 + x^2) F(x) - 3) / (x^2 - 1)^2, series-patched (4/15 at x = 1)."""
    x = torch.clamp(x, min=_X_MIN)
    near = torch.abs(x - 1.0) < _BRANCH_DELTA
    x_safe = torch.where(near, torch.full_like(x, 2.0), x)
    closed = ((2.0 + x_safe**2) * _hern_f(x_safe) - 3.0) / (x_safe**2 - 1.0) ** 2
    return torch.where(near, _horner(x - 1.0, _KAPPA_SERIES), closed)


class Hernquist(MassProfile):
    """Spherical Hernquist lens: alpha(x) = 2 sigma0 Rs x (1-F(x))/(x^2-1)."""

    _name = "HERNQUIST"
    _params = ["sigma0", "Rs", "center_x", "center_y"]

    def deriv(self, x, y, sigma0, Rs, center_x, center_y):
        dx, dy = x - center_x, y - center_y
        R = torch.clamp(torch.sqrt(dx * dx + dy * dy), min=_R_MIN)
        Rs = torch.clamp(torch.as_tensor(Rs), min=_R_MIN)
        X = R / Rs
        # alpha / R = 2 sigma0 shape(X) / X
        a_over_r = 2.0 * sigma0 * _alpha_shape(X) / X
        return a_over_r * dx, a_over_r * dy

    def hessian(self, x, y, sigma0, Rs, center_x, center_y):
        dx, dy = x - center_x, y - center_y
        R = torch.clamp(torch.sqrt(dx * dx + dy * dy), min=_R_MIN)
        Rs = torch.clamp(torch.as_tensor(Rs), min=_R_MIN)
        X = R / Rs
        kappa = sigma0 * _kappa_shape(X)
        # the mean convergence inside R is alpha/R; shear = kbar - kappa
        kbar = 2.0 * sigma0 * _alpha_shape(X) / X
        gamma = kbar - kappa
        c1 = (dy * dy - dx * dx) / (R * R)
        c2 = -2.0 * dx * dy / (R * R)
        return kappa + gamma * c1, gamma * c2, gamma * c2, kappa - gamma * c1

    def convergence(self, x, y, sigma0, Rs, center_x, center_y):
        dx, dy = x - center_x, y - center_y
        R = torch.clamp(torch.sqrt(dx * dx + dy * dy), min=_R_MIN)
        X = R / torch.clamp(torch.as_tensor(Rs), min=_R_MIN)
        return sigma0 * _kappa_shape(X)


class HernquistEllipse(MassProfile):
    """Ellipticity by a coordinate stretch around the spherical Hernquist,
    as :class:`.nfw.NFW_ELLIPSE`."""

    _name = "HERNQUIST_ELLIPSE"
    _params = ["sigma0", "Rs", "e1", "e2", "center_x", "center_y"]

    def __init__(self):
        super().__init__()
        self._sphere = Hernquist()

    def deriv(self, x, y, sigma0, Rs, e1, e2, center_x, center_y):
        _, q, phi = ellipticity_to_polar(e1, e2)
        e = torch.abs(1 - q**2) / (1 + q**2)
        dx, dy = rotate(x - center_x, y - center_y, phi)
        xs, ys = dx * torch.sqrt(1 - e), dy * torch.sqrt(1 + e)
        fx, fy = self._sphere.deriv(xs, ys, sigma0, Rs, 0.0, 0.0)
        fx = fx * torch.sqrt(1 - e)
        fy = fy * torch.sqrt(1 + e)
        return rotate(fx, fy, -phi)
