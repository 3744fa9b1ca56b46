"""Sersic-family light profiles (port of :mod:`gigalens_tpu.profiles.light.sersic`).

``Ie`` multiplies once (the JAX package's convention, which fixes the
reference's JAX double multiplication).
"""
from __future__ import annotations

import torch

from gigalens_tpu_torch.profiles.base import LightProfile


def _elliptical_radius(x, y, cx, cy, e1, e2):
    """Elliptical radius with |e|-preserving axis-ratio scaling (sqrt(q) in,
    1/sqrt(q) cross), guarded at e1 = e2 = 0 like ``ellipticity_to_polar``."""
    degenerate = (e1 * e1 + e2 * e2) < 1e-24
    phi = torch.atan2(
        torch.where(degenerate, torch.zeros_like(e2), e2),
        torch.where(degenerate, torch.ones_like(e1), e1),
    ) / 2
    c = torch.sqrt(e1**2 + e2**2 + 1e-24)
    q = (1 - c) / (1 + c)
    dx, dy = x - cx, y - cy
    cos_phi, sin_phi = torch.cos(phi), torch.sin(phi)
    xt1 = (cos_phi * dx + sin_phi * dy) * torch.sqrt(q)
    xt2 = (-sin_phi * dx + cos_phi * dy) / torch.sqrt(q)
    return torch.sqrt(xt1**2 + xt2**2)


def _b_n(n_sersic):
    """Ciotti & Bertin approximation used throughout the reference."""
    return 1.9992 * n_sersic - 0.3271


class Sersic(LightProfile):
    _name = "SERSIC"
    _params = ["R_sersic", "n_sersic", "center_x", "center_y"]
    _amp = "Ie"

    def light(self, x, y, R_sersic, n_sersic, center_x, center_y, Ie=None):
        R = _elliptical_radius(
            x, y, center_x, center_y,
            torch.zeros_like(center_x), torch.zeros_like(center_y),
        )
        ret = torch.exp(-_b_n(n_sersic) * ((R / R_sersic) ** (1.0 / n_sersic) - 1.0))
        return ret[None] if self.use_lstsq else Ie * ret


class SersicEllipse(Sersic):
    _name = "SERSIC_ELLIPSE"
    _params = ["R_sersic", "n_sersic", "e1", "e2", "center_x", "center_y"]

    def light(self, x, y, R_sersic, n_sersic, e1, e2, center_x, center_y, Ie=None):
        R = _elliptical_radius(x, y, center_x, center_y, e1, e2)
        ret = torch.exp(-_b_n(n_sersic) * ((R / R_sersic) ** (1.0 / n_sersic) - 1.0))
        return ret[None] if self.use_lstsq else Ie * ret
