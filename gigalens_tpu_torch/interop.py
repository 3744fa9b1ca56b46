"""Carries state of the JAX reference package across to the port.

The parity tests feed both packages the same numbers; these helpers read
reference objects through ``np.asarray`` and attribute access only, so
this module imports neither ``jax`` nor ``gigalens_tpu``.
"""
from __future__ import annotations

import numpy as np
import torch

from gigalens_tpu_torch.config import SimulatorConfig
from gigalens_tpu_torch.prob import distributions as dist
from gigalens_tpu_torch.prob.prior import Prior

_DISTRIBUTIONS = {
    "Normal": ("loc", "scale"),
    "LogNormal": ("loc", "scale"),
    "Uniform": ("low", "high"),
    "TruncatedNormal": ("loc", "scale", "low", "high"),
}


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(v, fn) for v in tree)
    return fn(tree)


def tree_to_torch(tree, device="cpu", dtype=torch.float32):
    """A nested dict/list of arrays (e.g. a reference ``prior.constrain(z)``
    output) -> the same nesting of tensors on ``device``."""
    return _map_tree(
        tree, lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device)
    )


def _port_distribution(leaf):
    name = type(leaf).__name__
    if name not in _DISTRIBUTIONS:
        raise NotImplementedError(f"distribution {name} is not ported yet")
    args = [np.asarray(getattr(leaf, a)) for a in _DISTRIBUTIONS[name]]
    return getattr(dist, name)(*args)


def prior_from_reference(prior) -> Prior:
    """The port's equivalent of a ``gigalens_tpu`` Prior (same tree, same
    distribution parameters, hence the same z-column order)."""
    return Prior(_map_tree(prior.tree, _port_distribution))


def sim_config_from_reference(cfg) -> SimulatorConfig:
    """The port's copy of a ``gigalens_tpu`` SimulatorConfig."""

    def arr(v):
        return None if v is None else np.asarray(v)

    return SimulatorConfig(
        delta_pix=float(cfg.delta_pix),
        num_pix=cfg.num_pix,
        supersample=int(cfg.supersample),
        kernel=arr(cfg.kernel),
        transform_pix2angle=arr(cfg.transform_pix2angle),
        pix_region=arr(cfg.pix_region),
        use_fft=cfg.use_fft,
        psf_mode=cfg.psf_mode,
        use_fused_render=cfg.use_fused_render,
    )
