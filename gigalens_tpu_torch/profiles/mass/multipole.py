"""Angular multipole perturbation to the lens potential (port of
:mod:`gigalens_tpu.profiles.mass.multipole`).

Keeton (2001) closed form, lenstronomy's ``MULTIPOLE`` convention:

  psi(r, phi)  = r * a_m / (1 - m^2) * cos(m (phi - phi_m))
  kappa        = a_m cos(m (phi - phi_m)) / (2 r)

The order ``m`` is a constructor argument; the radius is floored so the
functions stay finite and differentiable at the centre.
"""
from __future__ import annotations

import torch

from gigalens_tpu_torch.profiles.base import MassProfile

_R_MIN = 1e-7


class Multipole(MassProfile):
    _name = "MULTIPOLE"
    _params = ["a_m", "phi_m", "center_x", "center_y"]

    def __init__(self, m: int = 4):
        super().__init__()
        if m == 1:
            raise ValueError(
                "m = 1 has no potential of this form (1 - m^2 = 0); it is a "
                "pure translation degenerate with the deflector centroid")
        self.m = int(m)

    def _polar(self, x, y, center_x, center_y):
        dx, dy = x - center_x, y - center_y
        r = torch.clamp(torch.sqrt(dx * dx + dy * dy), min=_R_MIN)
        return dx, dy, r, torch.atan2(dy, dx)

    def deriv(self, x, y, a_m, phi_m, center_x, center_y):
        m = self.m
        dx, dy, r, phi = self._polar(x, y, center_x, center_y)
        c = torch.cos(m * (phi - phi_m))
        s = torch.sin(m * (phi - phi_m))
        pref = a_m / (1.0 - m * m)
        cos_p, sin_p = dx / r, dy / r
        return pref * (cos_p * c + m * sin_p * s), pref * (sin_p * c - m * cos_p * s)

    def hessian(self, x, y, a_m, phi_m, center_x, center_y):
        # psi_rr = 0 and the psi_rphi / psi_phi terms cancel, leaving the
        # rank-1 tangential form (a_m cos(m dphi) / r) [[s^2, -sc], [-sc, c^2]]
        dx, dy, r, phi = self._polar(x, y, center_x, center_y)
        base = a_m * torch.cos(self.m * (phi - phi_m)) / r
        cos_p, sin_p = dx / r, dy / r
        f_xy = -base * sin_p * cos_p
        return base * sin_p * sin_p, f_xy, f_xy, base * cos_p * cos_p

    def convergence(self, x, y, a_m, phi_m, center_x, center_y):
        _, _, r, phi = self._polar(x, y, center_x, center_y)
        return a_m * torch.cos(self.m * (phi - phi_m)) / (2.0 * r)
