"""External shear (port of :mod:`gigalens_tpu.profiles.mass.shear`)."""
from __future__ import annotations

import torch

from gigalens_tpu_torch.profiles.base import MassProfile


class Shear(MassProfile):
    _name = "SHEAR"
    _params = ["gamma1", "gamma2"]

    def deriv(self, x, y, gamma1, gamma2):
        return gamma1 * x + gamma2 * y, gamma2 * x - gamma1 * y

    def potential(self, x, y, gamma1, gamma2):
        return 0.5 * gamma1 * (x**2 - y**2) + gamma2 * x * y

    def hessian(self, x, y, gamma1, gamma2):
        gamma1, gamma2 = torch.as_tensor(gamma1), torch.as_tensor(gamma2)
        shape = torch.broadcast_shapes(torch.as_tensor(x).shape, gamma1.shape, gamma2.shape)
        f_xx = torch.broadcast_to(gamma1, shape)
        f_yy = torch.broadcast_to(-gamma1, shape)
        f_xy = torch.broadcast_to(gamma2, shape)
        return f_xx, f_xy, f_xy, f_yy
