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


def _catalogue(rel):
    """A scaling relation's galaxy catalogue as numpy arrays."""
    return {k: np.asarray(v) for k, v in rel.galaxy_cat.items()}


def _port_series_state(prof, out):
    """Copies a JAX ``MassSeries``' state onto its port: the expansion
    constants and point, and the coefficients JAX has computed, as numpy.
    The grid is not carried: the port binds the coefficients to its own
    simulator's grid with ``set_grid`` (values compared once per tensor)."""
    if prof._constants_dict:
        out.set_constants({k: np.asarray(v) for k, v in prof._constants_dict.items()})
    for name in ("_deriv_coefs", "_hessian_coefs"):
        coefs = getattr(prof, name)
        if coefs is not None:
            setattr(out, name, torch.from_numpy(np.array(coefs, np.float32)))
    return out


def _port_profile(prof):
    """The port's profile of the same class name and static settings (and,
    for the cluster profiles, catalogue and series state)."""
    from gigalens_tpu_torch.profiles import light as L
    from gigalens_tpu_torch.profiles import mass as M

    name = type(prof).__name__
    if name == "EPL":
        return M.EPL(prof.niter)
    if name == "Multipole":
        return M.Multipole(prof.m)
    if name == "Shapelets":
        return L.Shapelets(prof.n_max, use_lstsq=prof.use_lstsq)
    if name in ("Sersic", "SersicEllipse", "CoreSersic", "Gaussian", "Moffat"):
        return getattr(L, name)(use_lstsq=prof.use_lstsq)
    if name == "ScalingRelation":
        return M.ScalingRelation(_port_profile(prof.profile), prof.scaling_params,
                                 prof.lum_star, prof.power, _catalogue(prof),
                                 chunk_size=prof.chunk_size)
    if name == "DPIESubhalo":
        return M.DPIESubhalo(prof.lum_star, _catalogue(prof), scaling_params_power=prof.power,
                             chunk_size=prof.chunk_size)
    if name == "MassSeries":
        return _port_series_state(prof, M.MassSeries(
            _port_profile(prof.profile), prof.series_param, prof.amplitude_param, prof.order))
    if name == "ScalingRelationSeries":
        rel = prof._rel
        return _port_series_state(prof, M.ScalingRelationSeries(
            _port_profile(prof.profile), prof.series_param, prof.amplitude_param,
            rel.scaling_params, rel.lum_star, rel.power, _catalogue(rel), order=prof.order,
            chunk_size=rel.chunk_size))
    if name == "DPIESubhaloSeries":
        rel = prof._rel
        return _port_series_state(prof, M.DPIESubhaloSeries(
            rel.lum_star, _catalogue(rel), scaling_params_power=rel.power, order=prof.order,
            chunk_size=rel.chunk_size))
    mass = ("Shear", "SIS", "SIE", "NIE", "NFW", "NFW_ELLIPSE", "TNFW", "DPIS", "DPIE", "DPIEP",
            "Hernquist", "HernquistEllipse", "PointMass", "MassSheet")
    if name in mass:
        return getattr(M, name)()
    raise NotImplementedError(f"profile {name} is not ported yet")


def phys_model_from_reference(phys):
    """The port's equivalent of a ``gigalens_tpu`` PhysicalModel: each
    profile by class name (with its static settings, :func:`_port_profile`), the
    same fixed constants and, for a multi-plane model, its redshifts and
    its recursion coefficients as they are (whatever cosmology made them)."""
    from gigalens_tpu_torch.model import PhysicalModel

    def consts(cs):
        return [{k: np.array(v) for k, v in d.items()} for d in cs]

    multi = getattr(phys, "mp_factors", None) is not None
    out = PhysicalModel(
        [_port_profile(p) for p in phys.lenses],
        [_port_profile(p) for p in phys.lens_light],
        [_port_profile(p) for p in phys.source_light],
        lenses_constants=consts(phys.lenses_constants),
        lens_light_constants=consts(phys.lens_light_constants),
        source_light_constants=consts(phys.source_light_constants),
        lens_redshifts=phys.lens_redshifts if multi else None,
        z_source=phys.z_source if multi else None,
    )
    if multi:
        out.mp_factors = np.array(phys.mp_factors, np.float32)
    return out


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


def pixelated_model_from_reference(model, device=None):
    """The port's PixelatedSourceProbModel of a JAX one: its prior (a
    ``source_pixelated`` group included), observed image, error map, grid,
    fixed ``lam`` and ``chunk``, and its regularizer as it is (``H_reg``
    and ``logdet_H``, so a ``reg_ridge`` comes with them). ``device=None``
    means the CUDA card."""
    from gigalens_tpu_torch.inversion import PixelatedSourceProbModel, SourceGrid

    g = model.grid
    out = PixelatedSourceProbModel(
        prior_from_reference(model.prior), np.asarray(model.observed_image),
        error_map=np.asarray(model.error_map),
        grid=SourceGrid(int(g.n_side), float(g.extent), float(g.center_x), float(g.center_y)),
        lam=model.lam, chunk=model.chunk, device=device)
    out.H_reg = torch.tensor(np.asarray(model.H_reg, np.float32), device=out.device)
    out.logdet_H = float(model.logdet_H)
    return out


def mvn_from_reference(q_z, device=None) -> dist.MultivariateNormalTriL:
    """The port's MultivariateNormalTriL of a JAX surrogate (``loc`` and
    ``scale_tril`` read as numpy), e.g. to start the port's HMC or SVI from
    the JAX package's own state. ``device=None`` means the CUDA card."""
    return dist.MultivariateNormalTriL(np.array(q_z.loc), np.array(q_z.scale_tril),
                                       device=resolve_device(device))
