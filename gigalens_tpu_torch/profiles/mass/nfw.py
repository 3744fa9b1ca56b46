"""NFW-family deflectors (port of :mod:`gigalens_tpu.profiles.mass.nfw`:
NFW, NFW_ELLIPSE and the truncated TNFW).

Wright & Brainerd (2000) g(x), h(x) and F(x). Every piecewise function is a
total ``torch.where`` with branch-safe inputs, so values and gradients stay
finite everywhere. NFW has closed-form ``potential`` and ``hessian``;
NFW_ELLIPSE's Hessian is NFW's closed form at the stretched coordinates,
scaled by the stretch on both sides and rotated back (the Jacobian of its
``deriv``, as the JAX package's forward mode gives it); TNFW takes the
forward-mode default.
"""
from __future__ import annotations

import math

import torch

from gigalens_tpu_torch.profiles.base import (
    MassProfile,
    ellipticity_to_polar,
    hessian_rotate,
    rotate,
)

_R_MIN = 1e-7
_X_MIN = 1e-6

# Near the branch point x = 1 both closed forms cancel catastrophically in
# float32; within |x-1| < delta the two-sided Taylor series at x = 1 takes
# over: g = (1 - log 2) + t/3 - t^2/30 - t^3/105 + 17 t^4/1260 and
# F = 1/3 - 2/5 t + 13/35 t^2 - 20/63 t^3 + 61/231 t^4 (t = x-1).
_BRANCH_DELTA = 0.03
_SMALL_X = 0.05
_F_SERIES = (1 / 3, -2 / 5, 13 / 35, -20 / 63, 61 / 231)
_G_SERIES = (0.30685281944005469, 1 / 3, -1 / 30, -1 / 105, 17 / 1260)
# h(1) = ln^2(2)/2, then the cumulative integral of the g(u)/u Cauchy product
_H_SERIES = (
    0.2402265069591007,
    0.30685281944005469,
    0.013240256946639322,
    -0.019937975181398853,
    0.012572504860063681,
)


def _horner(t, coeffs):
    acc = torch.full_like(t, coeffs[-1])
    for c in coeffs[-2::-1]:
        acc = acc * t + c
    return acc


def _branch_inputs(x):
    """Branch-safe inputs for the two closed forms, clamped at the series
    window's edges, not at x = 1: the series is selected for |x-1| < delta,
    so the closed forms only ever see x outside the window and both value
    and gradient stay finite. The edges themselves (x = 1 -/+ delta) keep
    their own input (``<=``/``>=``): with strict inequalities a float64
    x of exactly 1 -/+ delta would get the placeholder (ROADMAP F-ref-2)."""
    x_lo = torch.where(x <= 1.0 - _BRANCH_DELTA, x, torch.full_like(x, 0.5))
    x_hi = torch.where(x >= 1.0 + _BRANCH_DELTA, x, torch.full_like(x, 2.0))
    return x_lo, x_hi


def _nfw_g(x):
    """g(x) such that alpha = 4 rho0 Rs g(x)/x * x_hat; g(1) = 1 + log(1/2).

    Series regions around the x = 1 branch point and below x = 0.05, where
    the closed form cancels catastrophically in float32:
    g = x^2 (L/2 - 1/4) + x^4 (3L/8 - 7/32), L = log(2/x)."""
    x = torch.clamp(x, min=_X_MIN)
    near = torch.abs(x - 1.0) < _BRANCH_DELTA
    small = x < _SMALL_X
    x_lo, x_hi = _branch_inputs(x)
    lo = torch.log(x / 2.0) + torch.arccosh(1.0 / x_lo) / torch.sqrt(1.0 - x_lo**2)
    hi = torch.log(x / 2.0) + torch.arccos(1.0 / x_hi) / torch.sqrt(x_hi**2 - 1.0)
    series = _horner(x - 1.0, _G_SERIES)
    L = torch.log(2.0 / x)
    small_series = x**2 * (0.5 * L - 0.25) + x**4 * (0.375 * L - 7.0 / 32.0)
    return torch.where(
        small, small_series, torch.where(near, series, torch.where(x < 1, lo, hi))
    )


def _nfw_h(x):
    """h(x) with dh/dx = g(x)/x, the NFW potential's shape; h(1) = ln^2(2)/2."""
    x = torch.clamp(x, min=_X_MIN)
    near = torch.abs(x - 1.0) < _BRANCH_DELTA
    x_lo, x_hi = _branch_inputs(x)
    lo = 0.5 * torch.log(x / 2.0) ** 2 - 0.5 * torch.arccosh(1.0 / x_lo) ** 2
    hi = 0.5 * torch.log(x / 2.0) ** 2 + 0.5 * torch.arccos(1.0 / x_hi) ** 2
    series = _horner(x - 1.0, _H_SERIES)
    return torch.where(near, series, torch.where(x < 1, lo, hi))


def _nfw_f(x):
    """F(x), the convergence shape function; F(1) = 1/3."""
    x = torch.clamp(x, min=_X_MIN)
    near = torch.abs(x - 1.0) < _BRANCH_DELTA
    x_lo, x_hi = _branch_inputs(x)
    lo = 1.0 / (x_lo**2 - 1.0) * (
        1.0 - 2.0 / torch.sqrt(1.0 - x_lo**2)
        * torch.arctanh(torch.sqrt((1.0 - x_lo) / (1.0 + x_lo))))
    hi = 1.0 / (x_hi**2 - 1.0) * (
        1.0 - 2.0 / torch.sqrt(x_hi**2 - 1.0)
        * torch.arctan(torch.sqrt((x_hi - 1.0) / (1.0 + x_hi))))
    series = _horner(x - 1.0, _F_SERIES)
    return torch.where(near, series, torch.where(x < 1, lo, hi))


class NFW(MassProfile):
    _name = "NFW"
    _params = ["Rs", "alpha_Rs", "center_x", "center_y"]

    @staticmethod
    def _rho0(Rs, alpha_Rs):
        """Characteristic density from the deflection at Rs."""
        return alpha_Rs / (4.0 * Rs**2 * (1.0 - math.log(2.0)))

    def _alpha_radial(self, R, Rs, rho0, ax_x, ax_y):
        R = torch.clamp(R, min=_R_MIN)
        Rs = torch.clamp(torch.as_tensor(Rs), min=_R_MIN)
        x = R / Rs
        a = 4.0 * rho0 * Rs * _nfw_g(x) / x**2
        return a * ax_x, a * ax_y

    def deriv(self, x, y, Rs, alpha_Rs, center_x, center_y):
        rho0 = self._rho0(Rs, alpha_Rs)
        dx, dy = x - center_x, y - center_y
        R = torch.sqrt(dx**2 + dy**2)
        return self._alpha_radial(R, Rs, rho0, dx, dy)

    def potential(self, x, y, Rs, alpha_Rs, center_x, center_y):
        rho0 = self._rho0(Rs, alpha_Rs)
        Rs = torch.clamp(torch.as_tensor(Rs), min=_R_MIN)
        dx, dy = x - center_x, y - center_y
        R = torch.clamp(torch.sqrt(dx**2 + dy**2), min=_R_MIN)
        return 4.0 * rho0 * Rs**3 * _nfw_h(R / Rs)

    def hessian(self, x, y, Rs, alpha_Rs, center_x, center_y):
        rho0 = self._rho0(Rs, alpha_Rs)
        Rs = torch.clamp(torch.as_tensor(Rs), min=_R_MIN)
        dx, dy = x - center_x, y - center_y
        R = torch.clamp(torch.sqrt(dx**2 + dy**2), min=_X_MIN)
        X = R / Rs
        gx = _nfw_g(X)
        fx = _nfw_f(X)
        kappa = 2.0 * rho0 * Rs * fx
        a = 2.0 * rho0 * Rs * (2.0 * gx / X**2 - fx)
        gamma1 = a * (dy**2 - dx**2) / R**2
        gamma2 = -a * 2.0 * dx * dy / R**2
        return kappa + gamma1, gamma2, gamma2, kappa - gamma1


class NFW_ELLIPSE(MassProfile):
    """Ellipticity introduced by stretching coordinates around spherical NFW."""

    _name = "NFW_ELLIPSE"
    _params = ["Rs", "alpha_Rs", "e1", "e2", "center_x", "center_y"]

    def __init__(self):
        super().__init__()
        self._nfw = NFW()

    def deriv(self, x, y, Rs, alpha_Rs, e1, e2, center_x, center_y):
        rho0 = NFW._rho0(Rs, alpha_Rs)
        _, q, phi = ellipticity_to_polar(e1, e2)
        e = torch.abs(1 - q**2) / (1 + q**2)

        x, y = rotate(x - center_x, y - center_y, phi)
        xs, ys = x * torch.sqrt(1 - e), y * torch.sqrt(1 + e)
        R = torch.sqrt(xs**2 + ys**2)
        fx, fy = self._nfw._alpha_radial(R, Rs, rho0, xs, ys)
        fx = fx * torch.sqrt(1 - e)
        fy = fy * torch.sqrt(1 + e)
        return rotate(fx, fy, -phi)

    def hessian(self, x, y, Rs, alpha_Rs, e1, e2, center_x, center_y):
        """R(phi)^T S H_NFW(S R(phi) x) S R(phi), S = diag(sqrt(1-e), sqrt(1+e)):
        one closed-form pass in place of two forward-mode ones."""
        _, q, phi = ellipticity_to_polar(e1, e2)
        e = torch.abs(1 - q**2) / (1 + q**2)
        sm, sp = torch.sqrt(1.0 - e), torch.sqrt(1.0 + e)
        xr, yr = rotate(x - center_x, y - center_y, phi)
        f_xx, f_xy, _, f_yy = self._nfw.hessian(xr * sm, yr * sp, Rs, alpha_Rs, 0.0, 0.0)
        f_xx, f_xy, f_yy = hessian_rotate(f_xx * (1.0 - e), f_xy * (sm * sp), f_yy * (1.0 + e),
                                          -phi)
        return f_xx, f_xy, f_xy, f_yy


class TNFW(MassProfile):
    """Truncated NFW (Baltz, Marshall & Oguri 2009), truncation tau = r_trunc/Rs."""

    _name = "TNFW"
    _params = ["Rs", "alpha_Rs", "r_trunc", "center_x", "center_y"]

    # Taylor series of atanh(sqrt(1-x^2))/sqrt(1-x^2) at x = 1
    _F_SERIES = (1.0, -2 / 3, 7 / 15, -12 / 35, 83 / 315)

    @classmethod
    def _F(cls, x):
        x = torch.clamp(x, min=_X_MIN)
        near = torch.abs(x - 1.0) < _BRANCH_DELTA
        x_lo, x_hi = _branch_inputs(x)
        lo = torch.arctanh(torch.sqrt(1.0 - x_lo**2)) / torch.sqrt(1.0 - x_lo**2)
        hi = torch.arctan(torch.sqrt(x_hi**2 - 1.0)) / torch.sqrt(x_hi**2 - 1.0)
        series = _horner(x - 1.0, cls._F_SERIES)
        return torch.where(near, series, torch.where(x < 1, lo, hi))

    @staticmethod
    def _g(X, tau):
        """Baltz+ 2009 lensing mass shape function, float32-stable: below
        X_SWITCH the closed form's ~tau^2 log(x) terms cancel to O(x^2 log
        x), so the exact small-x series takes over there."""
        X_SWITCH = 0.1
        X_safe = torch.clamp(X, min=X_SWITCH / 2)  # branch-safe input for the closed form

        L = torch.log(X_safe / (tau + torch.sqrt(tau**2 + X_safe**2)))
        F = TNFW._F(X_safe)
        closed = tau**2 / (tau**2 + 1.0) ** 2 * (
            (tau**2 + 1.0 + 2.0 * (X_safe**2 - 1.0)) * F
            + tau * math.pi
            + (tau**2 - 1.0) * torch.log(tau)
            + torch.sqrt(tau**2 + X_safe**2) * (-math.pi + L * (tau**2 - 1.0) / tau)
        )

        ln2x = torch.log(2.0 / X)
        ltau = torch.log(tau)
        t2 = tau**2
        denom = 4.0 * (t2 + 1.0) ** 2
        a2 = 0.5 * ln2x + (1.0 - t2**2 + 2.0 * (1.0 - t2) * ltau - 2.0 * math.pi * tau) / denom
        a4 = (3.0 * t2 - 1.0) / (8.0 * t2) * ln2x + (
            -7.0 * t2**3 - 9.0 * t2**2 - t2 + 1.0 + 4.0 * (t2 - 1.0) * ltau
            + 4.0 * math.pi * tau) / (8.0 * t2 * denom)
        series = X**2 * a2 + X**4 * a4
        return torch.where(X < X_SWITCH, series, closed)

    def deriv(self, x, y, Rs, alpha_Rs, r_trunc, center_x, center_y):
        Rs = torch.as_tensor(Rs)
        rho0 = alpha_Rs / (4.0 * Rs**2 * (1.0 + math.log(0.5)))
        dx, dy = x - center_x, y - center_y
        R = torch.maximum(torch.sqrt(dx**2 + dy**2), 1e-4 * Rs)
        X = R / Rs
        tau = r_trunc / Rs
        a = 4.0 * rho0 * Rs * self._g(X, tau) / X**2
        return a * dx, a * dy
