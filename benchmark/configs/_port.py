"""Builders of the program under test shared by the configurations: its
prior from a configuration's prior tree, and its simulator configuration
from the configuration's camera and PSF."""
from __future__ import annotations

import numpy as np


def port_prior(tree):
    """The program's ``Prior`` over a configuration's prior tree."""
    from gigalens_tpu_torch.prob import Prior
    from gigalens_tpu_torch.prob import distributions as d

    def dist(spec):
        family, *nums = spec
        return getattr(d, family)(*nums)

    return Prior({g: [{k: dist(v) for k, v in prof.items()} for prof in profs]
                  for g, profs in tree.items()})


def native_psf32(cfg):
    """The configuration's Gaussian PSF on its native pixels, in float32,
    as a user hands it to the program."""
    p = cfg["psf"]
    r = np.arange(p["size"]) - (p["size"] - 1) / 2
    k = np.exp(-(r[None, :] ** 2 + r[:, None] ** 2) / p["denominator"])
    return (k / k.sum()).astype(np.float32)


def sim_config(cfg):
    from gigalens_tpu_torch import SimulatorConfig

    return SimulatorConfig(delta_pix=cfg["delta_pix"], num_pix=cfg["num_pix"],
                           supersample=cfg["supersample"], kernel=native_psf32(cfg))


def supersampled_psf_size(cfg):
    """Taps a side of the PSF on the supersampled grid: the odd size at or
    above supersample x native size."""
    m = cfg["psf"]["size"] * cfg["supersample"]
    return m + 1 - m % 2
