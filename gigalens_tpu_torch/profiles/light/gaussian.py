"""Gaussian and Moffat light profiles (port of
:mod:`gigalens_tpu.profiles.light.gaussian`), on the Sersic family's
elliptical radius, with the amplitude factored out in lstsq mode.
"""
from __future__ import annotations

import torch

from gigalens_tpu_torch.profiles.base import LightProfile
from gigalens_tpu_torch.profiles.light.sersic import _elliptical_radius


class Gaussian(LightProfile):
    """amp * exp(-R^2 / (2 sigma^2)) on the elliptical radius."""

    _name = "GAUSSIAN"
    _params = ["sigma", "e1", "e2", "center_x", "center_y"]
    _amp = "amp"

    def light(self, x, y, sigma, e1, e2, center_x, center_y, amp=None):
        R = _elliptical_radius(x, y, center_x, center_y, e1, e2)
        ret = torch.exp(-0.5 * (R / sigma) ** 2)
        return ret[None] if self.use_lstsq else amp * ret


class Moffat(LightProfile):
    """amp * (1 + (R/rd)^2)^(-beta): the seeing-limited compact-source shape."""

    _name = "MOFFAT"
    _params = ["rd", "beta", "e1", "e2", "center_x", "center_y"]
    _amp = "amp"

    def light(self, x, y, rd, beta, e1, e2, center_x, center_y, amp=None):
        R = _elliptical_radius(x, y, center_x, center_y, e1, e2)
        ret = (1.0 + (R / rd) ** 2) ** (-beta)
        return ret[None] if self.use_lstsq else amp * ret
