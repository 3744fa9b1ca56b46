"""Dual pseudo-isothermal deflectors, dPIS / dPIE / dPIEP (port of
:mod:`gigalens_tpu.profiles.mass.dpie`).

The difference of two pseudo-isothermal profiles with core radius
``r_core`` and cut radius ``r_cut``,

    kappa(R) = theta_E/2 * r_cut/(r_cut - r_core)
               * (1/sqrt(R^2 + r_core^2) - 1/sqrt(R^2 + r_cut^2)).

The elliptical dPIE deflection is Kassiola & Kovner's complex formula
``J = A * log(u_core/u_cut)``, evaluated with explicit (re, im) float pairs
as the JAX package does, so the arithmetic follows it line for line. The
spherical dPIS and the dPIE have closed-form Hessians (the dPIE's: the
Jacobian of the complex formula, where the JAX package takes forward mode
of ``deriv``); dPIEP takes the forward-mode default.
"""
from __future__ import annotations

import torch

from gigalens_tpu_torch.profiles.base import (
    MassProfile,
    _like,
    ellipticity_to_polar,
    hessian_rotate,
    rotate,
)

_R_MIN = 1e-4


def _sort_core_cut(r_core, r_cut, x):
    """Orders (r_core, r_cut) as (lo, hi), floors lo at ``_R_MIN`` and hi at
    ``lo + _R_MIN``, so ``r_cut/(r_cut - r_core)`` never divides by zero
    (both radii 0 is a zero-luminosity padded galaxy of a scaling relation).
    ``torch.minimum``/``maximum`` split a tie's gradient evenly, as JAX's.
    A Python number takes the coordinates' dtype."""
    r_core, r_cut = _like(r_core, x), _like(r_cut, x)
    lo = torch.minimum(r_core, r_cut)
    hi = torch.maximum(r_core, r_cut)
    lo = torch.maximum(torch.full_like(lo, _R_MIN), lo)
    hi = torch.maximum(hi, lo + _R_MIN)
    return lo, hi


class DPIS(MassProfile):
    """Dual pseudo-isothermal sphere (Eliasdottir 2007 eq. A20)."""

    _name = "dPIS"
    _params = ["theta_E", "r_core", "r_cut", "center_x", "center_y"]

    def deriv(self, x, y, theta_E, r_core, r_cut, center_x, center_y):
        r_core, r_cut = _sort_core_cut(r_core, r_cut, x)
        dx, dy = x - center_x, y - center_y
        r2 = dx**2 + dy**2
        scale = theta_E * r_cut / (r_cut - r_core)
        # f_A20 * r == sqrt(r^2+a^2) - a - sqrt(r^2+s^2) + s
        f = torch.sqrt(r2 + r_core**2) - r_core - torch.sqrt(r2 + r_cut**2) + r_cut
        alpha_over_r = scale * f / torch.clamp(r2, min=_R_MIN**2)
        return alpha_over_r * dx, alpha_over_r * dy

    def hessian(self, x, y, theta_E, r_core, r_cut, center_x, center_y):
        r_core, r_cut = _sort_core_cut(r_core, r_cut, x)
        dx, dy = x - center_x, y - center_y
        r = torch.clamp(torch.sqrt(dx**2 + dy**2), min=_R_MIN)
        scale = theta_E * r_cut / (r_cut - r_core)
        sq_core = torch.sqrt(r_core**2 + r**2)
        sq_cut = torch.sqrt(r_cut**2 + r**2)
        gamma = scale / 2 * (2 * (1.0 / (r_core + sq_core) - 1.0 / (r_cut + sq_cut))
                             - (1.0 / sq_core - 1.0 / sq_cut))
        # kappa = div(alpha)/2, without the reference's extra
        # (r_core+r_cut)/r_cut factor, as the JAX package
        kappa = scale / 2 * (1.0 / sq_core - 1.0 / sq_cut)
        cos_2phi = (dy**2 - dx**2) / r**2
        sin_2phi = -2 * dx * dy / r**2
        gamma1 = cos_2phi * gamma
        gamma2 = sin_2phi * gamma
        return kappa + gamma1, gamma2, gamma2, kappa - gamma1

    def convergence(self, x, y, theta_E, r_core, r_cut, center_x=0.0, center_y=0.0):
        r_core, r_cut = _sort_core_cut(r_core, r_cut, x)
        dx, dy = x - center_x, y - center_y
        r = torch.clamp(torch.sqrt(dx**2 + dy**2), min=_R_MIN)
        scale = theta_E * r_cut / (r_cut - r_core)
        return scale / 2 * (1.0 / torch.sqrt(r_core**2 + r**2)
                            - 1.0 / torch.sqrt(r_cut**2 + r**2))


def _dpie_complex_alpha(x, y, r_core, r_cut, e, q):
    """K&K 4.1.2 dual-radius complex deflection in the ellipse frame, as
    (re, im) float pairs: ``pref * i * log(u_core / u_cut)`` with
    ``u_w = (q x + i (2 sqrt(e) sqrt(w^2 + rem2) - y/q)) / (x + i (2 w sqrt(e) - y))``.

    ``atan2`` takes the sign of a zero imaginary part, so a point on the
    rotated x-axis (``z_im = +-0``, ``z_re < 0``) lands on either side of
    the branch cut exactly as in the JAX package."""
    sqe = torch.sqrt(e)
    rem2 = x**2 / (1.0 + e) ** 2 + y**2 / (1.0 - e) ** 2

    a = q * x  # Re(num), shared
    b_core = 2.0 * sqe * torch.sqrt(r_core**2 + rem2) - y / q  # Im(num_core)
    b_cut = 2.0 * sqe * torch.sqrt(r_cut**2 + rem2) - y / q  # Im(num_cut)
    c = x  # Re(den), shared
    d_core = 2.0 * r_core * sqe - y  # Im(den_core)
    d_cut = 2.0 * r_cut * sqe - y  # Im(den_cut)

    # ratio = (num_core * den_cut) / (den_core * num_cut)
    top_re = a * c - b_core * d_cut
    top_im = a * d_cut + b_core * c
    bot_re = a * c - b_cut * d_core
    bot_im = a * d_core + b_cut * c

    bot2 = bot_re**2 + bot_im**2
    z_re = (top_re * bot_re + top_im * bot_im) / bot2
    z_im = (top_im * bot_re - top_re * bot_im) / bot2

    log_re = 0.5 * torch.log(z_re**2 + z_im**2)
    log_im = torch.atan2(z_im, z_re)

    pref = -0.5 * (1.0 - e**2) / sqe
    # alpha_x + i alpha_y = pref * i * log(z)
    return -pref * log_im, pref * log_re


def _cdiv(pr, pi, qr, qi):
    """(pr + i pi) / (qr + i qi) as a float pair."""
    q2 = qr**2 + qi**2
    return (pr * qr + pi * qi) / q2, (pi * qr - pr * qi) / q2


def _dpie_complex_jacobian(x, y, r_core, r_cut, e, q):
    """The ellipse-frame Jacobian of :func:`_dpie_complex_alpha`:
    ``alpha_x + i alpha_y = pref i L`` with ``L = log num_core - log den_core
    - log num_cut + log den_cut``, so ``d alpha / dv = pref i L_v`` and each
    ``L_v`` is a sum of (d f / dv) / f over the four linear forms.
    Returns (f_xx, f_xy, f_yx, f_yy)."""
    sqe = torch.sqrt(e)
    ax, ay = (1.0 + e) ** 2, (1.0 - e) ** 2
    rem2 = x**2 / ax + y**2 / ay
    lx_r = lx_i = ly_r = ly_i = 0.0
    for w, sign in ((r_core, 1.0), (r_cut, -1.0)):
        s = torch.sqrt(w**2 + rem2)
        num_r, num_i = q * x, 2.0 * sqe * s - y / q
        den_r, den_i = x, 2.0 * w * sqe - y
        # d num/dx = q + i 2 sqe x / (ax s), d num/dy = i (2 sqe y / (ay s) - 1/q);
        # d den/dx = 1, d den/dy = -i
        nx_r, nx_i = _cdiv(q, 2.0 * sqe * x / (ax * s), num_r, num_i)
        ny_r, ny_i = _cdiv(0.0, 2.0 * sqe * y / (ay * s) - 1.0 / q, num_r, num_i)
        d2 = den_r**2 + den_i**2
        lx_r = lx_r + sign * (nx_r - den_r / d2)
        lx_i = lx_i + sign * (nx_i + den_i / d2)
        ly_r = ly_r + sign * (ny_r + den_i / d2)
        ly_i = ly_i + sign * (ny_i + den_r / d2)
    pref = -0.5 * (1.0 - e**2) / sqe
    # pref * i * (l_r + i l_i) = pref * (-l_i + i l_r)
    return -pref * lx_i, -pref * ly_i, pref * lx_r, pref * ly_r


class DPIE(MassProfile):
    """Elliptical dPIE (Lenstool PIEMD convention, r_cut = s of Eliasdottir)."""

    _name = "dPIE"
    _params = ["theta_E", "r_core", "r_cut", "center_x", "center_y", "e1", "e2"]

    # the complex formula divides by sqrt(e): floor the ellipticity far
    # below float32 resolution of the deflection (the e -> 0 limit is
    # smooth, e = 0 exactly is 0/0)
    _E_MIN = 1e-6

    def deriv(self, x, y, theta_E, r_core, r_cut, e1, e2, center_x=0.0, center_y=0.0):
        e, q, phi = ellipticity_to_polar(_like(e1, x), _like(e2, x))
        e = torch.clamp(e, min=self._E_MIN)
        q = (1.0 - e) / (1.0 + e)
        x, y = rotate(x - center_x, y - center_y, phi)
        r_core, r_cut = _sort_core_cut(r_core, r_cut, x)
        scale = theta_E * r_cut / (r_cut - r_core)
        ax, ay = _dpie_complex_alpha(x, y, r_core, r_cut, e, q)
        ax, ay = rotate(ax, ay, -phi)
        return scale * ax, scale * ay

    def hessian(self, x, y, theta_E, r_core, r_cut, e1, e2, center_x=0.0, center_y=0.0):
        """The Jacobian of :meth:`deriv` in closed form (the JAX package
        takes it by forward mode): the ellipse-frame Jacobian of the complex
        formula, rotated back and scaled."""
        e, q, phi = ellipticity_to_polar(_like(e1, x), _like(e2, x))
        e = torch.clamp(e, min=self._E_MIN)
        q = (1.0 - e) / (1.0 + e)
        xr, yr = rotate(x - center_x, y - center_y, phi)
        r_core, r_cut = _sort_core_cut(r_core, r_cut, x)
        scale = theta_E * r_cut / (r_cut - r_core)
        f_xx, f_xy, f_yx, f_yy = _dpie_complex_jacobian(xr, yr, r_core, r_cut, e, q)
        f_xx, f_xy, f_yy = hessian_rotate(f_xx, 0.5 * (f_xy + f_yx), f_yy, -phi)
        return scale * f_xx, scale * f_xy, scale * f_xy, scale * f_yy

    def convergence(self, x, y, theta_E, r_core, r_cut, e1, e2, center_x=0.0, center_y=0.0):
        e, q, phi = ellipticity_to_polar(_like(e1, x), _like(e2, x))
        x, y = rotate(x - center_x, y - center_y, phi)
        r_core, r_cut = _sort_core_cut(r_core, r_cut, x)
        scale = theta_E * r_cut / (r_cut - r_core)
        rem2 = x**2 / (1.0 + e) ** 2 + y**2 / (1.0 - e) ** 2
        return scale / 2 * (1.0 / torch.sqrt(rem2 + r_core**2)
                            - 1.0 / torch.sqrt(rem2 + r_cut**2))


class DPIEP(MassProfile):
    """dPIE with the ellipticity in the potential (pseudo-elliptical mass),
    by a coordinate stretch around the spherical dPIS. Lenstool's parameter
    names (Ra, Rs) are kept."""

    _name = "dPIEP"
    _params = ["theta_E", "Ra", "Rs", "center_x", "center_y", "e1", "e2"]

    def __init__(self):
        super().__init__()
        self._sph = DPIS()

    def deriv(self, x, y, theta_E, Ra, Rs, e1, e2, center_x=0.0, center_y=0.0):
        _, q, phi = ellipticity_to_polar(_like(e1, x), _like(e2, x))
        e = torch.abs(1 - q**2) / (1 + q**2)
        x, y = rotate(x - center_x, y - center_y, phi)
        xs, ys = x * torch.sqrt(1 - e), y * torch.sqrt(1 + e)
        fx, fy = self._sph.deriv(xs, ys, theta_E, Ra, Rs, 0.0, 0.0)
        fx = fx * torch.sqrt(1 - e)
        fy = fy * torch.sqrt(1 + e)
        return rotate(fx, fy, -phi)
