"""Carries state of the JAX reference package across to the port.

The parity tests feed both packages the same numbers; these helpers read
reference objects through ``np.asarray`` and attribute access only, so
this module imports neither ``jax`` nor ``gigalens_tpu``.
"""
from __future__ import annotations

import numpy as np
import torch

from gigalens_tpu_torch.config import SimulatorConfig
from gigalens_tpu_torch.model import resolve_device
from gigalens_tpu_torch.prob import distributions as dist
from gigalens_tpu_torch.prob.prior import Prior

_DISTRIBUTIONS = {
    "Normal": ("loc", "scale"),
    "LogNormal": ("loc", "scale"),
    "Uniform": ("low", "high"),
    "TruncatedNormal": ("loc", "scale", "low", "high"),
    "HalfNormal": ("scale",),
}


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(v, fn) for v in tree)
    return fn(tree)


def tree_to_torch(tree, device=None, dtype=torch.float32):
    """A nested dict/list of arrays (e.g. a reference ``prior.constrain(z)``
    output) -> the same nesting of tensors on ``device`` (``None``: the CUDA
    card; the CPU only when asked for by name)."""
    device = resolve_device(device)
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


def _port_profile(prof):
    """The port's profile of the same class name and static settings."""
    from gigalens_tpu_torch.profiles.light import CoreSersic, Sersic, SersicEllipse, Shapelets
    from gigalens_tpu_torch.profiles.mass import EPL, NFW, NFW_ELLIPSE, SIE, SIS, Shear

    name = type(prof).__name__
    if name == "EPL":
        return EPL(prof.niter)
    if name == "Shapelets":
        return Shapelets(prof.n_max, use_lstsq=prof.use_lstsq)
    light = {"Sersic": Sersic, "SersicEllipse": SersicEllipse, "CoreSersic": CoreSersic}
    if name in light:
        return light[name](use_lstsq=prof.use_lstsq)
    mass = {"Shear": Shear, "SIS": SIS, "SIE": SIE, "NFW": NFW, "NFW_ELLIPSE": NFW_ELLIPSE}
    if name in mass:
        return mass[name]()
    raise NotImplementedError(f"profile {name} is not ported yet")


def phys_model_from_reference(phys):
    """The port's equivalent of a ``gigalens_tpu`` PhysicalModel: each
    profile by class name (with ``niter``, ``n_max`` and ``use_lstsq``), and
    the same fixed constants."""
    from gigalens_tpu_torch.model import PhysicalModel

    if getattr(phys, "mp_factors", None) is not None:
        raise NotImplementedError("multi-plane lensing is not ported yet (ROADMAP M14)")

    def consts(cs):
        return [{k: np.array(v) for k, v in d.items()} for d in cs]

    return PhysicalModel(
        [_port_profile(p) for p in phys.lenses],
        [_port_profile(p) for p in phys.lens_light],
        [_port_profile(p) for p in phys.source_light],
        lenses_constants=consts(phys.lenses_constants),
        lens_light_constants=consts(phys.lens_light_constants),
        source_light_constants=consts(phys.source_light_constants),
    )


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


def mvn_from_reference(q_z, device=None) -> dist.MultivariateNormalTriL:
    """The port's MultivariateNormalTriL of a JAX surrogate (``loc`` and
    ``scale_tril`` read as numpy), e.g. to start the port's HMC or SVI from
    the JAX package's own state. ``device=None`` means the CUDA card."""
    return dist.MultivariateNormalTriL(np.array(q_z.loc), np.array(q_z.scale_tril),
                                       device=resolve_device(device))
