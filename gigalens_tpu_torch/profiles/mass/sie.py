"""Singular isothermal ellipsoid (SIE) and sphere (SIS) deflectors (port of
:mod:`gigalens_tpu.profiles.mass.sie`).

Closed forms of Kormann et al. (1994). The SIS carries an analytic Hessian;
the SIE's is reverse mode (``hessian_vjp``) and the cored NIE's the
forward-mode default.
"""
from __future__ import annotations

import torch

from gigalens_tpu_torch.profiles.base import MassProfile, ellipticity_to_polar, rotate


def _kormann_deriv(x, y, theta_E, q, phi, s_scale, center_x, center_y):
    """Kormann (1994) cored isothermal-ellipsoid deflection in the rotated
    frame; ``s_scale = 0`` is the singular (SIE) case."""
    # intermediate-axis normalization of theta_E
    b = theta_E * torch.sqrt(2 * q / (1 + q**2)) * torch.sqrt((1 + q**2) / 2)
    s = s_scale * torch.sqrt((1 + q**2) / (2 * q**2))

    x, y = rotate(x - center_x, y - center_y, phi)
    psi = torch.sqrt(q**2 * (s**2 + x**2) + y**2)
    # Floor 1 - q^2: at exactly e1 = e2 = 0 float32 rounds q to 1.0 and the
    # raw sqrt gives root = 0, so b/root * arctan(0) = inf * 0 = NaN. With
    # the floor, arctan(root*u)/root resolves to the SIS limit b*x/psi, and
    # the clamp kills the spurious infinite dq branch of the gradient.
    root = torch.sqrt(torch.clamp(1.0 - q**2, min=1e-10))
    fx = b / root * torch.arctan(root * x / (psi + s))
    fy = b / root * torch.arctanh(root * y / (psi + q**2 * s))
    return rotate(fx, fy, -phi)


class SIE(MassProfile):
    _name = "SIE"
    _params = ["theta_E", "e1", "e2", "center_x", "center_y"]

    # softening used only to keep the q -> 1 limit finite
    s_scale = 0.0

    def deriv(self, x, y, theta_E, e1, e2, center_x, center_y):
        _, q, phi = ellipticity_to_polar(e1, e2)
        return _kormann_deriv(x, y, theta_E, q, phi, self.s_scale, center_x, center_y)

    def potential(self, x, y, theta_E, e1, e2, center_x, center_y):
        """Euler identity: the singular isothermal deflection is homogeneous
        of degree 0 in the centered coords, so ``psi = x~ . alpha`` exactly."""
        fx, fy = self.deriv(x, y, theta_E, e1, e2, center_x, center_y)
        return (x - center_x) * fx + (y - center_y) * fy

    def hessian(self, x, y, theta_E, e1, e2, center_x, center_y):
        """Reverse mode: ``torch.func.jvp`` runs Python decompositions of
        every operation, ~4x the host time of a log-density with its
        gradient on the time-delay demo's positions, delays and fluxes."""
        return self.hessian_vjp(x, y, theta_E=theta_E, e1=e1, e2=e2, center_x=center_x,
                                center_y=center_y)


class NIE(MassProfile):
    """Non-singular isothermal ellipsoid: the SIE with the core radius
    ``s_scale`` as a fit parameter."""

    _name = "NIE"
    _params = ["theta_E", "e1", "e2", "s_scale", "center_x", "center_y"]

    def deriv(self, x, y, theta_E, e1, e2, s_scale, center_x, center_y):
        _, q, phi = ellipticity_to_polar(e1, e2)
        return _kormann_deriv(x, y, theta_E, q, phi, s_scale, center_x, center_y)

    def potential(self, x, y, theta_E, e1, e2, s_scale, center_x, center_y):
        """Keeton (2001) cored-isothermal potential: the Euler term plus the
        core correction (which vanishes as ``s_scale -> 0``)."""
        _, q, phi = ellipticity_to_polar(e1, e2)
        b = theta_E * torch.sqrt(2 * q / (1 + q**2)) * torch.sqrt((1 + q**2) / 2)
        s = s_scale * torch.sqrt((1 + q**2) / (2 * q**2))
        xr, yr = rotate(x - center_x, y - center_y, phi)
        psi = torch.sqrt(q**2 * (s**2 + xr**2) + yr**2)
        root = torch.sqrt(torch.clamp(1.0 - q**2, min=1e-10))
        fx = b / root * torch.arctan(root * xr / (psi + s))
        fy = b / root * torch.arctanh(root * yr / (psi + q**2 * s))
        pot = xr * fx + yr * fy
        s_safe = torch.clamp(s, min=1e-12)
        core = b * s * (0.5 * torch.log((psi + s) ** 2 + (1.0 - q**2) * xr**2)
                        - torch.log((1.0 + q) * s_safe))
        return pot - torch.where(s > 0, core, torch.zeros_like(core))


class SIS(MassProfile):
    _name = "SIS"
    _params = ["theta_E", "center_x", "center_y"]

    def deriv(self, x, y, theta_E, center_x, center_y):
        dx, dy = x - center_x, y - center_y
        r = torch.sqrt(dx**2 + dy**2)
        # r = 0 guard: zero deflection at the center, zero gradient there
        zero = r == 0
        a = torch.where(zero, torch.zeros_like(r), theta_E / torch.where(zero, torch.ones_like(r), r))
        return a * dx, a * dy

    def potential(self, x, y, theta_E, center_x, center_y):
        dx, dy = x - center_x, y - center_y
        return theta_E * torch.sqrt(dx**2 + dy**2)

    def hessian(self, x, y, theta_E, center_x, center_y):
        dx, dy = x - center_x, y - center_y
        r3 = (dx**2 + dy**2) ** 1.5
        zero = r3 == 0
        a = torch.where(zero, torch.zeros_like(r3),
                        theta_E / torch.where(zero, torch.ones_like(r3), r3))
        f_xx = dy**2 * a
        f_yy = dx**2 * a
        f_xy = -dx * dy * a
        return f_xx, f_xy, f_xy, f_yy
