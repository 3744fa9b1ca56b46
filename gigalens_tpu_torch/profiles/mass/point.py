"""Point mass and uniform convergence sheet (port of
:mod:`gigalens_tpu.profiles.mass.point`): closed-form deflections,
Hessians and potentials.
"""
from __future__ import annotations

import torch

from gigalens_tpu_torch.profiles.base import MassProfile


class PointMass(MassProfile):
    """alpha = theta_E^2 * r_hat / r: the Schwarzschild (point) lens."""

    _name = "POINT_MASS"
    _params = ["theta_E", "center_x", "center_y"]

    def deriv(self, x, y, theta_E, center_x, center_y):
        dx, dy = x - center_x, y - center_y
        r2 = torch.clamp(dx * dx + dy * dy, min=1e-12)  # finite at the centre
        a = theta_E**2 / r2
        return a * dx, a * dy

    def hessian(self, x, y, theta_E, center_x, center_y):
        dx, dy = x - center_x, y - center_y
        r2 = torch.clamp(dx * dx + dy * dy, min=1e-12)
        c = theta_E**2 / (r2 * r2)
        f_xy = -2.0 * c * dx * dy
        return c * (dy * dy - dx * dx), f_xy, f_xy, c * (dx * dx - dy * dy)

    def potential(self, x, y, theta_E, center_x, center_y):
        dx, dy = x - center_x, y - center_y
        r2 = torch.clamp(dx * dx + dy * dy, min=1e-12)
        return 0.5 * theta_E**2 * torch.log(r2)


class MassSheet(MassProfile):
    """Uniform external convergence: alpha = kappa * (x - c), the tool for
    marginalizing the mass-sheet degeneracy."""

    _name = "MASS_SHEET"
    _params = ["kappa", "center_x", "center_y"]

    def deriv(self, x, y, kappa, center_x, center_y):
        return kappa * (x - center_x), kappa * (y - center_y)

    def hessian(self, x, y, kappa, center_x, center_y):
        x, kappa = torch.as_tensor(x), torch.as_tensor(kappa)
        k = torch.broadcast_to(kappa, torch.broadcast_shapes(x.shape, kappa.shape))
        zero = torch.zeros_like(k)
        return k, zero, zero, k

    def potential(self, x, y, kappa, center_x, center_y):
        dx, dy = x - center_x, y - center_y
        return 0.5 * kappa * (dx * dx + dy * dy)
