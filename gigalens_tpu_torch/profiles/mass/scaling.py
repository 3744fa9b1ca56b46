"""Scaling-relation profile stacks: cluster member galaxies (port of
:mod:`gigalens_tpu.profiles.mass.scaling`).

A catalogue of member galaxies shares one profile family; each galaxy's
parameters scale with its luminosity, ``p_g = scale * (L_g / L_star) **
power[p]``, and the field is the sum over galaxies. The galaxy axis is a
broadcast axis ``(bs, chunk, npix)`` summed chunk by chunk in a Python
loop; the catalogue is padded with zero-luminosity galaxies to whole
chunks (a padded galaxy's scaled parameters are all 0, so it contributes
exactly 0).

Few coordinates (image centroids) are summed over every galaxy in one pass
(``ONE_PASS_ELEMENTS``). Where autograd records a deflection, each chunk is
checkpointed
(``torch.utils.checkpoint``, non-reentrant): the backward recomputes the
chunk instead of keeping its ``(bs, chunk, npix)`` intermediates (at 200
members, bs 64 and 25,600 pixels, one intermediate of a 32-galaxy chunk is
210 MB). Hessians run the loop plainly: a profile's Hessian may be forward
mode (``torch.func.jvp``), which a non-reentrant checkpoint does not
survive under a later backward.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from gigalens_tpu_torch.profiles.base import MassProfile, _needs_graph

# (batch x padded galaxies x points) at or below which the whole catalogue
# is summed in one pass: the chunks bound the memory of whole pixel grids;
# a handful of points (image centroids) needs none, and one pass launches
# a chunk's work once
ONE_PASS_ELEMENTS = 1 << 22


class ScalingRelation(MassProfile):
    def __init__(
        self,
        profile: MassProfile,
        scaling_params: List[str],
        lum_star: float,
        scaling_params_power: Dict[str, float],
        galaxy_catalogue: Dict[str, List],
        chunk_size: Optional[int] = None,
        **kwargs,
    ):
        self.profile = profile
        self._name = f"Scaled-{profile.name}"
        if not hasattr(self, "_params") or self._params is None:
            self._params = list(scaling_params)
        self.scaling_params = list(scaling_params)
        super().__init__(**kwargs)

        lums = np.asarray(galaxy_catalogue["lum"], np.float32)
        self.n_galaxy = int(lums.size)
        self.lum_star = float(lum_star)
        self.power = {k: float(v) for k, v in scaling_params_power.items()}
        self.galaxy_cat = galaxy_catalogue

        if chunk_size is None or chunk_size >= self.n_galaxy:
            self.chunk_size = self.n_galaxy
        else:
            self.chunk_size = int(chunk_size)
        self.n_chunks = -(-self.n_galaxy // self.chunk_size)
        pad = self.n_chunks * self.chunk_size - self.n_galaxy

        constants = list(getattr(self.profile, "constants", []))
        self.not_scaling_params = [
            p for p in list(self.profile.params) + constants if p not in self.scaling_params
        ]

        def _padded(arr, value):
            arr = np.asarray(arr, np.float32)
            if pad:
                arr = np.concatenate([arr, np.full(pad, value, np.float32)])
            return torch.from_numpy(arr.reshape(self.n_chunks, self.chunk_size))

        # per-chunk unscaled multipliers (lum/L*)^power, padded with 0 so a
        # padded galaxy's amplitude vanishes
        self._unscaled = {
            k: _padded((lums / lum_star) ** self.power[k], 0.0) for k in self.scaling_params
        }
        # per-galaxy constants, padded with a copy of the last entry (benign
        # values; the zero amplitude kills the contribution)
        self._galaxy_constants = {
            k: _padded(galaxy_catalogue[k], float(np.asarray(galaxy_catalogue[k])[-1]))
            for k in self.not_scaling_params
        }
        self._tables = {}

    def tables(self, device):
        """(unscaled multipliers, galaxy constants) on ``device``, each
        ``(n_chunks, chunk)``; copied there once."""
        device = torch.device(device)
        hit = self._tables.get(device)
        if hit is None:
            hit = ({k: v.to(device) for k, v in self._unscaled.items()},
                   {k: v.to(device) for k, v in self._galaxy_constants.items()})
            self._tables[device] = hit
        return hit

    # ------------------------------------------------------------------
    def _chunked_sum(self, fn, x, y, scales: Dict, remat: bool = False):
        """sum over galaxies of ``fn(x, y, **params_g)``, chunk by chunk.

        ``scales``: the global scaling factors, (bs, 1) or scalars. ``fn``
        is called with parameters shaped (..., chunk, 1) against the
        coordinates, giving (..., chunk, npix) outputs whose chunk axis is
        summed at once. ``remat`` checkpoints each chunk where autograd
        records."""
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        device = x.device
        scales = {k: torch.as_tensor(v, dtype=x.dtype, device=device) for k, v in scales.items()}
        unscaled, consts = self.tables(device)
        keys = list(self.scaling_params)

        def chunk_out(ci, *scale_vals):
            p = {k: s[..., None] * unscaled[k][ci][:, None] for k, s in zip(keys, scale_vals)}
            c = {k: consts[k][ci][:, None] for k in self.not_scaling_params}
            return tuple(torch.sum(o, dim=-2) for o in fn(x, y, **p, **c))

        vals = [scales[k] for k in keys]
        batch = math.prod(torch.broadcast_shapes(*(v.shape for v in vals)))
        if batch * self.n_chunks * self.chunk_size * x.numel() <= ONE_PASS_ELEMENTS:
            # few coordinates (image centroids): every galaxy in one pass
            unscaled = {k: v.reshape(1, -1) for k, v in unscaled.items()}
            consts = {k: v.reshape(1, -1) for k, v in consts.items()}
            chunks = range(1)
        else:
            chunks = range(self.n_chunks)
        remat = remat and _needs_graph(x, y, *vals)
        acc = None
        for ci in chunks:
            if remat:
                out = checkpoint(chunk_out, ci, *vals, use_reentrant=False)
            else:
                out = chunk_out(ci, *vals)
            acc = out if acc is None else tuple(a + o for a, o in zip(acc, out))
        return acc

    # ------------------------------------------------------------------
    def deriv(self, x, y, **scales):
        fx, fy = self._chunked_sum(self.profile.deriv, x, y, scales, remat=True)
        return fx, fy

    def hessian(self, x, y, **scales):
        return self._chunked_sum(self.profile.hessian, x, y, scales)

    def convergence(self, x, y, **scales):
        def conv(x, y, **p):
            return (self.profile.convergence(x, y, **p),)

        return self._chunked_sum(conv, x, y, scales)[0]

    def shear(self, x, y, **scales):
        return self._chunked_sum(self.profile.shear, x, y, scales)
