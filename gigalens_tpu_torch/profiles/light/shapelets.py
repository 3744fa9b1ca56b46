"""Cartesian shapelet light profiles (port of
:mod:`gigalens_tpu.profiles.light.shapelets`).

Hermite recurrence only (the table-interpolation path raises, as in the JAX
package). Basis B_i(x, y) = phi_{n1}(u) phi_{n2}(v) with u = (x - cx)/beta,
amplitudes named ``amp00, amp01, ...`` in the triangular (n1, n2) ordering.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from gigalens_tpu_torch.profiles.base import LightProfile


def _triangular_order(n_max):
    """(n1, n2) pairs in the reference's ordering."""
    n1, n2 = 0, 0
    pairs = []
    for _ in range((n_max + 1) * (n_max + 2) // 2):
        pairs.append((n1, n2))
        if n1 == 0:
            n1, n2 = n2 + 1, 0
        else:
            n1, n2 = n1 - 1, n2 + 1
    return pairs


def hermite_stack(u, n_max):
    """Physicists' Hermite polynomials H_0..H_nmax at u, stacked on axis 0."""
    hs = [torch.ones_like(u)]
    if n_max >= 1:
        hs.append(2 * u)
    for n in range(1, n_max):
        hs.append(2 * (u * hs[n] - n * hs[n - 1]))
    return torch.stack(hs)


class Shapelets(LightProfile):
    _name = "SHAPELETS"
    _params = ["beta", "center_x", "center_y"]
    _amp = ""  # amplitudes are the numbered amp params below

    def __init__(self, n_max, use_lstsq=False, interpolate=False):
        if interpolate:
            raise NotImplementedError(
                "table-interpolation path intentionally dropped; the Hermite "
                "recurrence is exact"
            )
        self.n_max = int(n_max)
        self.n_layers = (self.n_max + 1) * (self.n_max + 2) // 2
        pairs = _triangular_order(self.n_max)
        self._n1 = np.array([p[0] for p in pairs])
        self._n2 = np.array([p[1] for p in pairs])
        width = len(str(self.n_layers))
        self._amp_names = [f"amp{str(i).zfill(width)}" for i in range(self.n_layers)]

        super().__init__(use_lstsq=use_lstsq)
        self.depth = self.n_layers
        if not use_lstsq:
            self.params.extend(self._amp_names)

        n = np.arange(self.n_max + 1, dtype=np.float64)
        # float32, as the JAX package rounds it
        self._prefactor = (
            1.0 / np.sqrt(2.0**n * np.sqrt(np.pi) * np.array([math.factorial(int(k)) for k in n]))
        ).astype(np.float32)

    # amplitude bookkeeping overrides (LightProfile assumes a single _amp)
    @LightProfile.use_lstsq.setter
    def use_lstsq(self, use_lstsq: bool):
        if use_lstsq and not self._use_lstsq:
            for a in self._amp_names:
                self.params.remove(a)
        elif not use_lstsq and self._use_lstsq:
            self.params.extend(self._amp_names)
        self._use_lstsq = bool(use_lstsq)

    def light(self, x, y, beta, center_x, center_y, **amps):
        u = (x - center_x) / beta
        v = (y - center_y) / beta
        pf = torch.as_tensor(self._prefactor, dtype=u.dtype, device=u.device)
        hu = pf.reshape((-1,) + (1,) * u.ndim) * hermite_stack(u, self.n_max)
        hv = pf.reshape((-1,) + (1,) * v.ndim) * hermite_stack(v, self.n_max)
        gauss = torch.exp(-(u**2 + v**2) / 2.0)
        n1 = torch.as_tensor(self._n1, device=u.device)
        n2 = torch.as_tensor(self._n2, device=u.device)
        basis = gauss[None] * hu[n1] * hv[n2]  # (n_layers, ...)
        if self.use_lstsq:
            return basis
        amp = torch.stack([torch.as_tensor(amps[k]) for k in self._amp_names])
        while amp.ndim < basis.ndim:
            amp = amp[..., None]
        return torch.sum(amp * basis, dim=0)
