"""External shear (port of :mod:`gigalens_tpu.profiles.mass.shear`)."""
from __future__ import annotations

from gigalens_tpu_torch.profiles.base import MassProfile


class Shear(MassProfile):
    _name = "SHEAR"
    _params = ["gamma1", "gamma2"]

    def deriv(self, x, y, gamma1, gamma2):
        return gamma1 * x + gamma2 * y, gamma2 * x - gamma1 * y
