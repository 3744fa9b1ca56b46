"""Composable fused render: CUDA kernels K5/K6/K7 and their plain twins.

Port of :mod:`gigalens_tpu.ops.pallas.fused_builder`. :func:`build_spec`
walks a ``PhysicalModel`` and gives each profile a *stage*: an opcode, the
offset of its columns in one packed ``(bs, n_cols)`` parameter matrix, and
a few static ints. For every (sample, pixel) the kernels compute

    alpha = sum of the mass stages' deflections   (EPL, SIS, shear, NFW,
                                                   NFW_ELLIPSE, Taylor series)
    beta  = x - alpha
    out   = sum of lens-light stages(x) + source-light stages(beta)

* K5 ``fused_builder_fwd`` (summed): one ``(bs, P)`` surface brightness;
* K6 the same kernel in components mode: ``(depth, bs, P)``, one image per
  linear (lstsq) component, for ``LensSimulator.lstsq_simulate``;
* K7 ``fused_builder_bwd``: the ``(bs, n_cols)`` parameter gradient of
  either mode, by recompute and the stages' hand-derived VJPs in reverse,
  with ``fused_builder_bwd_epilogue``, its per-sample second pass.

All three work in two stages: a per-sample prologue keyed by the stage
program fills one slot of constants per stage, one series table per EPL
stage and, for the summed forward, one folded coefficient table per
shapelet stage (amplitude times both prefactors, so the pixel's shapelet
sum is a nested sum over raw Hermite rows: one FMA a component) in shared
memory, and the pixel stages keep pixel-dependent arithmetic only. K7's
pixel stage reduces, per stage, cotangents of per-sample quantities
(:func:`stage_sums` columns) into ``(bs, n_chunks, n_sums)`` partials; the
epilogue kernel sums the chunks in a fixed order and maps each stage's sums
to its gradient columns (a linear map).

Beside them, the plain PyTorch twins, line for line with
``csrc/stages.cuh``: :func:`tile_forward_twostage` (K5/K6) and
:func:`tile_backward_reference` (K7: :func:`bwd_pixel_terms`, then
:func:`builder_bwd_epilogue`). :func:`fused_builder_reference` (the JAX stage
functions line for line, differentiable by torch autograd) and
:func:`tile_backward_onestage` (the hand VJP with nothing hoisted) are the
one-stage forms: the independent oracles of the tests. The wrappers take the
twins for CPU tensors only; for CUDA tensors they launch the kernels or
raise.

Fixed constants are baked as packed columns (broadcast at pack time); their
gradient columns are computed and dropped by the caller, as in JAX.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from gigalens_tpu_torch.ops.cuda import _build
from gigalens_tpu_torch.ops.cuda import fused_render as fr
from gigalens_tpu_torch.ops.cuda._math import half_angle, half_angle_bwd, powp
from gigalens_tpu_torch.ops.cuda.fused_render import _sersic_bwd, _sersic_light
from gigalens_tpu_torch.profiles.mass.epl import _omega_cs_bwd, _omega_cs_impl, omega_cs
from gigalens_tpu_torch.utils.profiling import span

# stage opcodes, mirrored by csrc/stages.cuh
EPL, SIS, SHEAR, NFW, NFW_E, SERIES = 0, 1, 2, 3, 4, 5
SERSIC_E, SERSIC, CORE_SERSIC, SHAPELETS = 8, 9, 10, 11
MASS_OPS = frozenset((EPL, SIS, SHEAR, NFW, NFW_E, SERIES))

TILE = 256  # pixels per tile of the CUDA kernels (one thread each)
TILES_PER_BLOCK = 4  # pixel tiles one block walks
SHAPELET_CAP = 10  # largest shapelet n_max the kernels take (local H_n arrays)
MAX_STAGES = 32  # stage records in the kernels' by-value argument struct
MAX_COLS = 1024  # packed columns (shared-memory staging of the sample's row)
SLOT = 24  # floats of per-sample constants a stage may hold in shared memory
MAX_SMEM = 232448  # bytes of shared memory a block may opt in to (H100: 227 KB)

# Launch counts of the kernels; each wrapper adds one where it launches its
# kernel and nowhere else.
launches = {"fused_builder_fwd_sum": 0, "fused_builder_fwd_components": 0,
            "fused_builder_bwd": 0}


@dataclasses.dataclass(frozen=True)
class Stage:
    """One profile's stage: opcode, first packed column and static ints."""

    op: int
    off: int
    niter: int = 0  # EPL: series depth
    order: int = 0  # SERIES: Taylor order
    n_max: int = 0  # SHAPELETS: largest polynomial order
    extra: int = -1  # SERIES: index of its coefficient grids in ``extras``
    lstsq: bool = False  # light: amplitude(s) solved by least squares
    is_source: bool = False  # light: evaluated at beta, not x
    depth: int = 1  # light: linear components (SHAPELETS: n_layers)

    @property
    def n_out(self) -> int:
        """Images this light stage emits: its components, or one total."""
        return self.depth if self.lstsq else 1


def shapelet_prefactor(n_max: int) -> np.ndarray:
    """1 / sqrt(2^n sqrt(pi) n!) for n = 0..n_max, rounded to float32 as
    ``Shapelets._prefactor`` is."""
    n = np.arange(n_max + 1, dtype=np.float64)
    fact = np.array([math.factorial(int(k)) for k in n])
    return (1.0 / np.sqrt(2.0**n * np.sqrt(np.pi) * fact)).astype(np.float32)


def _pairs(n_max):
    """(n1, n2) in the shapelets' triangular order: by total order N, then
    n2 = 0..N (the same sequence as ``shapelets._triangular_order``)."""
    return [(N - j, j) for N in range(n_max + 1) for j in range(N + 1)]


class FusedSpec:
    """A compiled plan for one model: stage records and the column layout.

    ``pack_cols`` holds, per packed column, ``(group, prof_idx, name)``, a
    float constant, or ``(group, prof_idx, name, transform)``.
    ``extra_providers`` are callables ``(img_x, img_y) -> (rows, P)`` grid
    or None (a stage's runtime pixel grids; None sends the dispatch site to
    the unfused path).
    """

    def __init__(self, stages, pack_cols, label="", extra_providers=()):
        self.stages = tuple(stages)
        self.mass = tuple(s for s in self.stages if s.op in MASS_OPS)
        self.light = tuple(s for s in self.stages if s.op not in MASS_OPS)
        self.pack_cols = list(pack_cols)
        self.n_cols = len(self.pack_cols)
        self.depth = sum(s.depth for s in self.light)
        self.all_lstsq = all(s.lstsq for s in self.light)
        self.any_lstsq = any(s.lstsq for s in self.light)
        self.label = label
        self.extra_providers = list(extra_providers)

    def gather_extras(self, img_x, img_y):
        """Every provider's grid, or None if any stage's grids are not ready."""
        out = []
        for prov in self.extra_providers:
            arr = prov(img_x, img_y)
            if arr is None:
                return None
            out.append(torch.as_tensor(arr, dtype=torch.float32, device=img_x.device))
        return tuple(out)

    def pack(self, params_dict):
        """Packed (bs, n_cols) matrix from the standard nested params dict
        (constants become broadcast columns)."""
        groups = {g: params_dict.get(g, []) for g in ("lens_mass", "lens_light", "source_light")}
        cols, like = [], None
        for spec in self.pack_cols:
            if isinstance(spec, tuple):
                g, i, name = spec[:3]
                leaf = torch.as_tensor(groups[g][i][name]).reshape(-1)
                if len(spec) == 4:  # column transform (e.g. series dv shift)
                    leaf = spec[3](leaf)
                like = leaf
            else:
                leaf = spec
            cols.append(leaf)
        if like is None:
            raise ValueError("a packed matrix needs at least one fit parameter")
        cols = [
            c if isinstance(c, torch.Tensor) and c.shape == like.shape
            else torch.broadcast_to(torch.as_tensor(c, dtype=like.dtype, device=like.device),
                                    like.shape)
            for c in cols
        ]
        return torch.stack(cols, dim=-1)


def build_spec(phys_model) -> Optional[FusedSpec]:
    """A FusedSpec for ``phys_model``, or None where the JAX builder gives
    None: a multi-plane model (``mp_factors`` set: the stages ray-shoot one
    plane), a profile with no stage, a ``MassSeries`` whose series or
    amplitude parameter is a constant, mixed lstsq and sampled amplitudes,
    or no light profile.

    A ``MassSeries`` becomes a SERIES stage: its series column is packed as
    ``var - var0`` (a pack-time transform; ``var0`` is profile state) and
    its coefficient grid arrives through an extra provider,
    ``MassSeries.series_grid``, which gives None before ``set_deriv`` or off
    the grid (the dispatch site then renders unfused, as in JAX)."""
    from gigalens_tpu_torch.profiles.light.sersic import CoreSersic, Sersic, SersicEllipse
    from gigalens_tpu_torch.profiles.light.shapelets import Shapelets
    from gigalens_tpu_torch.profiles.mass.epl import EPL as EPLProfile
    from gigalens_tpu_torch.profiles.mass.nfw import NFW as NFWProfile
    from gigalens_tpu_torch.profiles.mass.nfw import NFW_ELLIPSE
    from gigalens_tpu_torch.profiles.mass.series import MassSeries
    from gigalens_tpu_torch.profiles.mass.shear import Shear
    from gigalens_tpu_torch.profiles.mass.sie import SIE
    from gigalens_tpu_torch.profiles.mass.sie import SIS as SISProfile

    if getattr(phys_model, "mp_factors", None) is not None:
        return None
    pack_cols: list = []
    stages: list = []
    providers: list = []
    names = []

    def add_cols(group, idx, consts, param_names):
        """A column per param name: fit params reference the dict, constants
        bake their float value. Returns the starting offset."""
        off = len(pack_cols)
        for name in param_names:
            pack_cols.append(float(consts[name]) if name in consts else (group, idx, name))
        return off

    mass_cols = {
        SISProfile: (SIS, ["theta_E", "center_x", "center_y"]),
        Shear: (SHEAR, ["gamma1", "gamma2"]),
        NFWProfile: (NFW, ["Rs", "alpha_Rs", "center_x", "center_y"]),
        NFW_ELLIPSE: (NFW_E, ["Rs", "alpha_Rs", "e1", "e2", "center_x", "center_y"]),
    }
    for i, (prof, consts) in enumerate(zip(phys_model.lenses, phys_model.lenses_constants)):
        kind = type(prof)
        if kind is EPLProfile:
            off = add_cols("lens_mass", i, consts,
                           ["theta_E", "gamma", "e1", "e2", "center_x", "center_y"])
            stages.append(Stage(EPL, off, niter=prof.niter))
        elif kind is SIE:
            # exact EPL special case at gamma = 2 (a constant column)
            off = len(pack_cols)
            pack_cols.append(("lens_mass", i, "theta_E"))
            pack_cols.append(2.0)
            add_cols("lens_mass", i, consts, ["e1", "e2", "center_x", "center_y"])
            stages.append(Stage(EPL, off, niter=EPLProfile.recommended_niter(q_min=0.43, tol=1e-8)))
        elif kind in mass_cols:
            op, pnames = mass_cols[kind]
            stages.append(Stage(op, add_cols("lens_mass", i, consts, pnames)))
        elif isinstance(prof, MassSeries):
            if prof.series_param in consts or prof.amplitude_param in consts:
                return None
            off = len(pack_cols)
            pack_cols.append(("lens_mass", i, prof.series_param, prof.dv))
            pack_cols.append(("lens_mass", i, prof.amplitude_param))
            providers.append(lambda img_x, img_y, prof=prof: prof.series_grid(img_x))
            stages.append(Stage(SERIES, off, order=prof.order, extra=len(providers) - 1))
        else:
            return None
        names.append(kind.__name__)

    light_cols = {
        SersicEllipse: (SERSIC_E, ["R_sersic", "n_sersic", "e1", "e2", "center_x", "center_y"]),
        Sersic: (SERSIC, ["R_sersic", "n_sersic", "center_x", "center_y"]),
        CoreSersic: (CORE_SERSIC, ["R_sersic", "n_sersic", "Rb", "alpha", "gamma",
                                   "e1", "e2", "center_x", "center_y"]),
    }

    def add_light(group, idx, prof, consts, is_source):
        lstsq = bool(prof.use_lstsq)
        kind = type(prof)
        if kind in light_cols:
            op, pnames = light_cols[kind]
            off = add_cols(group, idx, consts, pnames + ([] if lstsq else ["Ie"]))
            stages.append(Stage(op, off, lstsq=lstsq, is_source=is_source))
        elif kind is Shapelets:
            pnames = ["beta", "center_x", "center_y"] + ([] if lstsq else list(prof._amp_names))
            off = add_cols(group, idx, consts, pnames)
            stages.append(Stage(SHAPELETS, off, n_max=prof.n_max, lstsq=lstsq,
                                is_source=is_source, depth=prof.n_layers))
        else:
            return False
        names.append(kind.__name__ + ("[lstsq]" if lstsq else ""))
        return True

    for i, (prof, consts) in enumerate(zip(phys_model.lens_light,
                                           phys_model.lens_light_constants)):
        if not add_light("lens_light", i, prof, consts, False):
            return None
    for i, (prof, consts) in enumerate(zip(phys_model.source_light,
                                           phys_model.source_light_constants)):
        if not add_light("source_light", i, prof, consts, True):
            return None

    spec = FusedSpec(stages, pack_cols, "+".join(names), providers)
    if not spec.light:
        return None
    if spec.any_lstsq and not spec.all_lstsq:
        # mixed linear/sampled amplitudes never reach the stacked solver as
        # one batch; they stay on the unfused path, as in JAX
        return None
    return spec


# ---------------------------------------------------------------------------
# Plain PyTorch twins: the forward stages (JAX fused_builder.py:98-287)
# ---------------------------------------------------------------------------

def _cols(p, off, n):
    """n consecutive (bs, 1) parameter columns starting at ``off``."""
    return [p[:, off + i: off + i + 1] for i in range(n)]


def _epl_deflect(p, x, y, st, extras):
    te, gam, e1, e2, cx, cy = _cols(p, st.off, 6)
    cp, sp = half_angle(e1, e2)
    c = torch.clamp(torch.sqrt(e1**2 + e2**2 + 1e-24), max=1.0)
    q = (1.0 - c) / (1.0 + c)
    dx, dy = x - cx, y - cy
    xr = dx * cp + dy * sp
    yr = -dx * sp + dy * cp
    R = torch.clamp(torch.sqrt((q * xr) ** 2 + yr**2), 1e-10, 1e10)
    t = gam - 1.0
    ox, oy = omega_cs(q * xr / R, yr / R, (1.0 - q) / (1.0 + q), t, st.niter)
    b = te * torch.sqrt(q)
    pref = (2.0 * b) / (1.0 + q) * powp(b / R, t - 1.0)
    ax_r, ay_r = pref * ox, pref * oy
    return ax_r * cp - ay_r * sp, ax_r * sp + ay_r * cp


def _sis_deflect(p, x, y, st, extras):
    te, cx, cy = _cols(p, st.off, 3)
    dx, dy = x - cx, y - cy
    R = torch.clamp(torch.sqrt(dx**2 + dy**2), 1e-10, 1e10)
    return te * dx / R, te * dy / R


def _shear_deflect(p, x, y, st, extras):
    g1, g2 = _cols(p, st.off, 2)
    return g1 * x + g2 * y, g2 * x - g1 * y


_LOG2 = math.log(2.0)
_G_SERIES = (0.30685281944005469, 1 / 3, -1 / 30, -1 / 105, 17 / 1260)


def _nfw_g_tile(x):
    """Wright & Brainerd g(x): arccosh(1/x) = log((1+sqrt(1-x^2))/x) for
    x < 1, arccos(1/x) = atan2(sqrt(x^2-1), 1) for x > 1, and the two-sided
    Taylor series inside the float32 cancellation bands (as the JAX tile;
    its polynomial atan2 is Mosaic's constraint, so native atan2 here)."""
    x = torch.clamp(x, min=1e-6)
    near = torch.abs(x - 1.0) < 0.03
    small = x < 0.05
    x_lo = torch.where(x < 1, x, torch.full_like(x, 0.5))
    x_hi = torch.where(x > 1, x, torch.full_like(x, 2.0))
    s_lo = torch.sqrt(torch.clamp(1.0 - x_lo**2, min=1e-12))
    lo = torch.log(x / 2.0) + torch.log((1.0 + s_lo) / x_lo) / s_lo
    s_hi = torch.sqrt(torch.clamp(x_hi**2 - 1.0, min=1e-12))
    hi = torch.log(x / 2.0) + torch.atan2(s_hi, torch.ones_like(s_hi)) / s_hi
    t = x - 1.0
    series = _G_SERIES[0] + t * (_G_SERIES[1] + t * (_G_SERIES[2] + t * (
        _G_SERIES[3] + t * _G_SERIES[4])))
    L = torch.log(2.0 / x)
    small_series = x**2 * (0.5 * L - 0.25) + x**4 * (0.375 * L - 7.0 / 32.0)
    return torch.where(small, small_series, torch.where(near, series, torch.where(x < 1, lo, hi)))


def _nfw_alpha_radial(R, Rs, rho0, ax_x, ax_y):
    R = torch.clamp(R, min=1e-7)
    Rs = torch.clamp(Rs, min=1e-7)
    xh = R / Rs
    a = 4.0 * rho0 * Rs * _nfw_g_tile(xh) / xh**2
    return a * ax_x, a * ax_y


def _nfw_deflect(p, x, y, st, extras):
    Rs, alpha_Rs, cx, cy = _cols(p, st.off, 4)
    rho0 = alpha_Rs / (4.0 * Rs**2 * (1.0 - _LOG2))
    dx, dy = x - cx, y - cy
    R = torch.sqrt(dx**2 + dy**2)
    return _nfw_alpha_radial(R, Rs, rho0, dx, dy)


def _nfw_e_deflect(p, x, y, st, extras):
    """NFW_ELLIPSE: coordinate-stretched spherical NFW."""
    Rs, alpha_Rs, e1, e2, cx, cy = _cols(p, st.off, 6)
    rho0 = alpha_Rs / (4.0 * Rs**2 * (1.0 - _LOG2))
    cp, sp = half_angle(e1, e2)
    c = torch.clamp(torch.sqrt(e1**2 + e2**2 + 1e-24), max=0.9999)
    q = (1.0 - c) / (1.0 + c)
    e = torch.abs(1.0 - q**2) / (1.0 + q**2)
    dx, dy = x - cx, y - cy
    xr = dx * cp + dy * sp
    yr = -dx * sp + dy * cp
    xs, ys = xr * torch.sqrt(1.0 - e), yr * torch.sqrt(1.0 + e)
    R = torch.sqrt(xs**2 + ys**2)
    fx, fy = _nfw_alpha_radial(R, Rs, rho0, xs, ys)
    fx = fx * torch.sqrt(1.0 - e)
    fy = fy * torch.sqrt(1.0 + e)
    return fx * cp - fy * sp, fx * sp + fy * cp


def _series_deflect(p, x, y, st, extras):
    """Taylor-series deflection amp * sum_n dv^n/n! * G_n(pixel): the grid
    holds rows [0:k] = alpha_x coefficients, [k:2k] = alpha_y (k = order+1).
    The dv = var - var0 shift is a pack-time column transform."""
    dv, amp = _cols(p, st.off, 2)
    grid = extras[st.extra]
    k = st.order + 1
    ax = torch.zeros_like(x * dv)
    ay = torch.zeros_like(ax)
    wn = torch.ones_like(dv)
    for n in range(k):
        if n:
            wn = wn * dv / float(n)
        ax = ax + wn * grid[n]
        ay = ay + wn * grid[k + n]
    return amp * ax, amp * ay


def _sersic_e_light(p, x, y, st):
    R_s, n_s, e1, e2, cx, cy = _cols(p, st.off, 6)
    Ie = 1.0 if st.lstsq else p[:, st.off + 6: st.off + 7]
    return [_sersic_light(x, y, R_s, n_s, e1, e2, cx, cy, Ie)]


def _sersic_sph_light(p, x, y, st):
    R_s, n_s, cx, cy = _cols(p, st.off, 4)
    z = torch.zeros_like(R_s)
    Ie = 1.0 if st.lstsq else p[:, st.off + 4: st.off + 5]
    return [_sersic_light(x, y, R_s, n_s, z, z, cx, cy, Ie)]


def _core_geom(p, x, y, st):
    R_s, n_s, Rb, alpha, gamma, e1, e2, cx, cy = _cols(p, st.off, 9)
    cp, sp = half_angle(e1, e2)
    c = torch.sqrt(e1**2 + e2**2 + 1e-24)
    q = (1.0 - c) / (1.0 + c)
    dx, dy = x - cx, y - cy
    xt1 = (cp * dx + sp * dy) * torch.sqrt(q)
    xt2 = (-sp * dx + cp * dy) / torch.sqrt(q)
    return xt1, xt2


def _core_sersic_light(p, x, y, st):
    R_s, n_s, Rb, alpha, gamma = _cols(p, st.off, 5)
    xt1, xt2 = _core_geom(p, x, y, st)
    R = torch.clamp(torch.sqrt(xt1**2 + xt2**2), 1e-10, 1e10)
    bn = 1.9992 * n_s - 0.3271
    u = (powp(R, alpha) + powp(Rb, alpha)) / powp(R_s, alpha)
    shape = powp(1.0 + powp(Rb / R, alpha), gamma / alpha) * torch.exp(
        -bn * (powp(u, 1.0 / (alpha * n_s)) - 1.0))
    if st.lstsq:
        return [shape]
    return [p[:, st.off + 9: st.off + 10] * shape]


def _hermites(w, n_max):
    hs = [torch.ones_like(w)]
    if n_max >= 1:
        hs.append(2.0 * w)
    for n in range(1, n_max):
        hs.append(2.0 * (w * hs[n] - n * hs[n - 1]))
    return hs


def _shapelet_light(p, x, y, st):
    beta, cx, cy = _cols(p, st.off, 3)
    u = (x - cx) / beta
    v = (y - cy) / beta
    gauss = torch.exp(-(u**2 + v**2) / 2.0)
    pf = [float(f) for f in shapelet_prefactor(st.n_max)]
    hu = [f * h for f, h in zip(pf, _hermites(u, st.n_max))]
    hv = [f * h for f, h in zip(pf, _hermites(v, st.n_max))]
    comps = [gauss * hu[a] * hv[b] for a, b in _pairs(st.n_max)]
    if st.lstsq:
        return comps
    total = 0.0
    for k, comp in enumerate(comps):
        total = total + p[:, st.off + 3 + k: st.off + 4 + k] * comp
    return [total]


_MASS_FWD = {EPL: _epl_deflect, SIS: _sis_deflect, SHEAR: _shear_deflect,
             NFW: _nfw_deflect, NFW_E: _nfw_e_deflect, SERIES: _series_deflect}
_LIGHT_FWD = {SERSIC_E: _sersic_e_light, SERSIC: _sersic_sph_light,
              CORE_SERSIC: _core_sersic_light, SHAPELETS: _shapelet_light}


def _deflect(spec, params, x, y, extras):
    ax = ay = 0.0
    for st in spec.mass:
        dax, day = _MASS_FWD[st.op](params, x, y, st, extras)
        ax, ay = ax + dax, ay + day
    return ax, ay


def tile_forward_reference(spec, params, x, y, extras=()):
    """Plain twin of K5/K6: (bs, n_cols), (P,), (P,) -> list of (bs, P)
    images, one per light stage (its amplitude-scaled total) or, for an
    lstsq stage, one per linear component. Differentiable by autograd."""
    ax, ay = _deflect(spec, params, x, y, extras)
    bx, by = x - ax, y - ay
    comps = []
    for st in spec.light:
        sx, sy = (bx, by) if st.is_source else (x, y)
        comps.extend(_LIGHT_FWD[st.op](params, sx, sy, st))
    return [torch.broadcast_to(c, (params.shape[0], x.shape[0])) for c in comps]


def fused_builder_reference(spec, params, x, y, extras=(), summed: bool = True):
    """Plain twin of K5 (``summed``: the images' sum, (bs, P)) or K6 (the
    components stacked, (depth, bs, P)); differentiable by autograd."""
    comps = tile_forward_reference(spec, params, x, y, extras)
    if summed:
        total = comps[0]
        for c in comps[1:]:
            total = total + c
        return total
    if not spec.all_lstsq:
        raise ValueError("the components render needs every light stage in lstsq mode")
    return torch.stack(comps)


# ---------------------------------------------------------------------------
# The hand-derived VJPs in their one-stage form (every pixel redoes the
# sample's constants and maps its cotangents to parameter gradients).
# Mass stages: (g_ax, g_ay) cotangent -> [(column, cotangent)].
# Light stages: per-output cotangents -> (g_x, g_y, [(column, cotangent)]).
# :func:`tile_backward_onestage` is the independent oracle the two-stage twin
# is held against and the function whose operations make K7's bound; no
# runtime path calls it. The stages with nothing to hoist (SIS, Shear, NFW,
# the Taylor series) are shared with the two-stage twin below.
# ---------------------------------------------------------------------------

def _zero(a):
    return torch.zeros_like(a)


def _epl_bwd(p, x, y, st, extras, g_ax, g_ay):
    te, gam, e1, e2, cx, cy = _cols(p, st.off, 6)
    cp, sp = half_angle(e1, e2)
    m = torch.sqrt(e1**2 + e2**2 + 1e-24)
    cc = torch.clamp(m, max=1.0)
    q = (1.0 - cc) / (1.0 + cc)
    sq = torch.sqrt(q)
    b = te * sq
    t = gam - 1.0
    dx, dy = x - cx, y - cy
    xr = dx * cp + dy * sp
    yr = -dx * sp + dy * cp
    qx = q * xr
    rr = torch.sqrt(qx * qx + yr * yr)
    R = torch.clamp(rr, 1e-10, 1e10)
    cos_t, sin_t = qx / R, yr / R
    f = (1.0 - q) / (1.0 + q)
    ox, oy = _omega_cs_impl(cos_t, sin_t, f, t, st.niter)
    p0 = 2.0 * b / (1.0 + q)
    lbr = torch.log(b / R)
    w = torch.exp((t - 1.0) * lbr)
    pref = p0 * w
    axr, ayr = pref * ox, pref * oy

    # rotation back from the ellipse frame
    g_axr = g_ax * cp + g_ay * sp
    g_ayr = -g_ax * sp + g_ay * cp
    g_cp = g_ax * axr + g_ay * ayr
    g_sp = -g_ax * ayr + g_ay * axr
    # prefactor (2 b / (1 + q)) (b / R)^(t - 1)
    g_pref = g_axr * ox + g_ayr * oy
    g_ox, g_oy = g_axr * pref, g_ayr * pref
    g_arg = g_pref * p0 * w  # cotangent of (t - 1) log(b / R)
    g_t = g_arg * lbr
    g_lbr = g_arg * (t - 1.0)
    g_b = g_lbr / b + g_pref * w * 2.0 / (1.0 + q)
    g_R = -g_lbr / R
    g_q = -g_pref * w * 2.0 * b / ((1.0 + q) * (1.0 + q))
    # series backward: Omega cotangents -> (cos_t, sin_t, f, t) cotangents
    g_c, g_s, g_f, g_tt = _omega_cs_bwd(st.niter, cos_t, sin_t, f, t, g_ox, g_oy)
    g_t = g_t + g_tt
    g_q = g_q - 2.0 * g_f / ((1.0 + q) * (1.0 + q))
    g_q = g_q + g_c * xr / R
    g_xr = g_c * q / R
    g_yr = g_s / R
    g_R = g_R - (g_c * cos_t + g_s * sin_t) / R
    # R -> (q, xr, yr) -> (dx, dy, cos phi, sin phi) -> params; a radius
    # outside the clip band (e.g. a pixel on the center) passes nothing
    g_rr = torch.where((rr > 1e-10) & (rr < 1e10), g_R / rr, _zero(g_R))
    g_qx = g_rr * qx
    g_yr = g_yr + g_rr * yr
    g_q = g_q + g_qx * xr
    g_xr = g_xr + g_qx * q
    g_te = g_b * sq
    g_q = g_q + g_b * te * 0.5 / sq
    g_dx = g_xr * cp - g_yr * sp
    g_dy = g_xr * sp + g_yr * cp
    g_cp = g_cp + g_xr * dx + g_yr * dy
    g_sp = g_sp + g_xr * dy - g_yr * dx
    g_cc = -2.0 * g_q / ((1.0 + cc) * (1.0 + cc))
    g_m = torch.where(m < 1.0, g_cc, _zero(g_cc))
    g_e1, g_e2 = half_angle_bwd(e1, e2, g_cp, g_sp)
    g_e1 = g_e1 + g_m * e1 / m
    g_e2 = g_e2 + g_m * e2 / m
    return list(enumerate([g_te, g_t, g_e1, g_e2, -g_dx, -g_dy], st.off))


def _sis_bwd(p, x, y, st, extras, g_ax, g_ay):
    te, cx, cy = _cols(p, st.off, 3)
    dx, dy = x - cx, y - cy
    rr = torch.sqrt(dx**2 + dy**2)
    R = torch.clamp(rr, 1e-10, 1e10)
    g_te = (g_ax * dx + g_ay * dy) / R
    g_R = -g_te * te / R
    g_rr = torch.where((rr > 1e-10) & (rr < 1e10), g_R / rr, _zero(g_R))
    g_dx = g_ax * te / R + g_rr * dx
    g_dy = g_ay * te / R + g_rr * dy
    return list(enumerate([g_te, -g_dx, -g_dy], st.off))


def _shear_bwd(p, x, y, st, extras, g_ax, g_ay):
    return [(st.off, g_ax * x - g_ay * y), (st.off + 1, g_ax * y + g_ay * x)]


def _nfw_g_tile_bwd(x):
    """(g(x), dg/dx) of :func:`_nfw_g_tile`, differentiating only the
    selected branch (no 0 * inf through an unselected one)."""
    xc = torch.clamp(x, min=1e-6)
    near = torch.abs(xc - 1.0) < 0.03
    small = xc < 0.05
    x_lo = torch.where(xc < 1, xc, torch.full_like(xc, 0.5))
    x_hi = torch.where(xc > 1, xc, torch.full_like(xc, 2.0))
    s_lo = torch.sqrt(torch.clamp(1.0 - x_lo**2, min=1e-12))
    a_lo = torch.log((1.0 + s_lo) / x_lo)
    lo = torch.log(xc / 2.0) + a_lo / s_lo
    ds_lo = -x_lo / s_lo
    da_lo = ds_lo / (1.0 + s_lo) - 1.0 / x_lo
    d_lo = 1.0 / xc + da_lo / s_lo - a_lo * ds_lo / (s_lo * s_lo)
    s_hi = torch.sqrt(torch.clamp(x_hi**2 - 1.0, min=1e-12))
    at = torch.atan2(s_hi, torch.ones_like(s_hi))
    hi = torch.log(xc / 2.0) + at / s_hi
    ds_hi = x_hi / s_hi
    d_hi = 1.0 / xc + ds_hi / (x_hi * x_hi * s_hi) - at * ds_hi / (s_hi * s_hi)
    t = xc - 1.0
    c0, c1, c2, c3, c4 = _G_SERIES
    series = c0 + t * (c1 + t * (c2 + t * (c3 + t * c4)))
    d_series = c1 + t * (2.0 * c2 + t * (3.0 * c3 + t * 4.0 * c4))
    L = torch.log(2.0 / xc)
    small_series = xc**2 * (0.5 * L - 0.25) + xc**4 * (0.375 * L - 7.0 / 32.0)
    d_small = (2.0 * xc * (0.5 * L - 0.25) - 0.5 * xc
               + 4.0 * xc**3 * (0.375 * L - 7.0 / 32.0) - 0.375 * xc**3)
    g = torch.where(small, small_series, torch.where(near, series, torch.where(xc < 1, lo, hi)))
    dg = torch.where(small, d_small, torch.where(near, d_series, torch.where(xc < 1, d_lo, d_hi)))
    return g, torch.where(x > 1e-6, dg, _zero(dg))


def _nfw_radial_bwd(R, Rs, rho0, vx, vy, g_fx, g_fy):
    """VJP of (fx, fy) = a(R, Rs, rho0) * (vx, vy) from
    :func:`_nfw_alpha_radial` -> (g_R / R, g_Rs, g_rho0, g_vx, g_vy); the
    radial cotangent comes divided by R (0 where R's floor holds)."""
    Rc = torch.clamp(R, min=1e-7)
    Rsc = torch.clamp(Rs, min=1e-7)
    xh = Rc / Rsc
    gx, dgx = _nfw_g_tile_bwd(xh)
    a = 4.0 * rho0 * Rsc * gx / xh**2
    g_a = g_fx * vx + g_fy * vy
    g_rho0 = g_a * 4.0 * Rsc * gx / xh**2
    g_Rsc = g_a * 4.0 * rho0 * gx / xh**2
    g_xh = g_a * 4.0 * rho0 * Rsc * (dgx / xh**2 - 2.0 * gx / xh**3)
    g_Rsc = g_Rsc - g_xh * xh / Rsc
    g_Rr = torch.where(R > 1e-7, g_xh / Rsc / R, _zero(g_xh))
    g_Rs = torch.where(Rs > 1e-7, g_Rsc, _zero(g_Rsc))
    return g_Rr, g_Rs, g_rho0, g_fx * a, g_fy * a


def _rho0_bwd(Rs, alpha_Rs, g_rho0, g_Rs):
    """rho0 = alpha_Rs / (4 Rs^2 (1 - log 2)) -> (g_Rs, g_alpha_Rs)."""
    inv = 1.0 / (4.0 * Rs**2 * (1.0 - _LOG2))
    rho0 = alpha_Rs * inv
    return g_Rs - 2.0 * g_rho0 * rho0 / Rs, g_rho0 * inv


def _nfw_bwd(p, x, y, st, extras, g_ax, g_ay):
    Rs, alpha_Rs, cx, cy = _cols(p, st.off, 4)
    rho0 = alpha_Rs / (4.0 * Rs**2 * (1.0 - _LOG2))
    dx, dy = x - cx, y - cy
    R = torch.sqrt(dx**2 + dy**2)
    g_Rr, g_Rs, g_rho0, g_dx, g_dy = _nfw_radial_bwd(R, Rs, rho0, dx, dy, g_ax, g_ay)
    g_dx = g_dx + g_Rr * dx
    g_dy = g_dy + g_Rr * dy
    g_Rs, g_aRs = _rho0_bwd(Rs, alpha_Rs, g_rho0, g_Rs)
    return list(enumerate([g_Rs, g_aRs, -g_dx, -g_dy], st.off))


def _nfw_e_bwd(p, x, y, st, extras, g_ax, g_ay):
    Rs, alpha_Rs, e1, e2, cx, cy = _cols(p, st.off, 6)
    rho0 = alpha_Rs / (4.0 * Rs**2 * (1.0 - _LOG2))
    cp, sp = half_angle(e1, e2)
    m = torch.sqrt(e1**2 + e2**2 + 1e-24)
    c = torch.clamp(m, max=0.9999)
    q = (1.0 - c) / (1.0 + c)
    n1 = 1.0 - q**2
    d1 = 1.0 + q**2
    e = torch.abs(n1) / d1
    se1, se2 = torch.sqrt(1.0 - e), torch.sqrt(1.0 + e)
    dx, dy = x - cx, y - cy
    xr = dx * cp + dy * sp
    yr = -dx * sp + dy * cp
    xs, ys = xr * se1, yr * se2
    R = torch.sqrt(xs**2 + ys**2)
    fx, fy = _nfw_alpha_radial(R, Rs, rho0, xs, ys)
    ox, oy = fx * se1, fy * se2

    # rotation back
    g_ox = g_ax * cp + g_ay * sp
    g_oy = -g_ax * sp + g_ay * cp
    g_cp = g_ax * ox + g_ay * oy
    g_sp = -g_ax * oy + g_ay * ox
    # axis stretch of the output
    g_fx, g_fy = g_ox * se1, g_oy * se2
    g_se1, g_se2 = g_ox * fx, g_oy * fy
    g_Rr, g_Rs, g_rho0, g_xs, g_ys = _nfw_radial_bwd(R, Rs, rho0, xs, ys, g_fx, g_fy)
    g_xs = g_xs + g_Rr * xs
    g_ys = g_ys + g_Rr * ys
    # axis stretch of the input
    g_xr, g_yr = g_xs * se1, g_ys * se2
    g_se1 = g_se1 + g_xs * xr
    g_se2 = g_se2 + g_ys * yr
    g_e = -g_se1 * 0.5 / se1 + g_se2 * 0.5 / se2
    sgn = torch.sign(n1)
    g_q = g_e * (sgn * (-2.0 * q) / d1 - torch.abs(n1) * 2.0 * q / (d1 * d1))
    g_c = -2.0 * g_q / ((1.0 + c) * (1.0 + c))
    g_m = torch.where(m < 0.9999, g_c, _zero(g_c))
    # rotation into the ellipse frame
    g_dx = g_xr * cp - g_yr * sp
    g_dy = g_xr * sp + g_yr * cp
    g_cp = g_cp + g_xr * dx + g_yr * dy
    g_sp = g_sp + g_xr * dy - g_yr * dx
    g_e1, g_e2 = half_angle_bwd(e1, e2, g_cp, g_sp)
    g_e1 = g_e1 + g_m * e1 / m
    g_e2 = g_e2 + g_m * e2 / m
    g_Rs, g_aRs = _rho0_bwd(Rs, alpha_Rs, g_rho0, g_Rs)
    return list(enumerate([g_Rs, g_aRs, g_e1, g_e2, -g_dx, -g_dy], st.off))


def _series_bwd(p, x, y, st, extras, g_ax, g_ay):
    dv, amp = _cols(p, st.off, 2)
    grid = extras[st.extra]
    k = st.order + 1
    sx = sy = dsx = dsy = 0.0
    wn = torch.ones_like(dv)
    for n in range(k):
        if n:
            # d(dv^n / n!)/d dv = dv^(n-1) / (n-1)!, the previous weight
            dsx = dsx + wn * grid[n]
            dsy = dsy + wn * grid[k + n]
            wn = wn * dv / float(n)
        sx = sx + wn * grid[n]
        sy = sy + wn * grid[k + n]
    return [(st.off, amp * (g_ax * dsx + g_ay * dsy)), (st.off + 1, g_ax * sx + g_ay * sy)]


def _sersic_e_bwd(p, x, y, st, cts):
    R_s, n_s, e1, e2, cx, cy = _cols(p, st.off, 6)
    Ie = 1.0 if st.lstsq else p[:, st.off + 6: st.off + 7]
    g_x, g_y, g = _sersic_bwd(cts[0], x, y, R_s, n_s, e1, e2, cx, cy, Ie)
    return g_x, g_y, list(enumerate(g[:6] if st.lstsq else g, st.off))


def _sersic_sph_bwd(p, x, y, st, cts):
    R_s, n_s, cx, cy = _cols(p, st.off, 4)
    z = torch.zeros_like(R_s)
    Ie = 1.0 if st.lstsq else p[:, st.off + 4: st.off + 5]
    g_x, g_y, g = _sersic_bwd(cts[0], x, y, R_s, n_s, z, z, cx, cy, Ie)
    cols = [g[0], g[1], g[4], g[5]] + ([] if st.lstsq else [g[6]])
    return g_x, g_y, list(enumerate(cols, st.off))


def _core_sersic_bwd(p, x, y, st, cts):
    R_s, n_s, Rb, al, ga, e1, e2, cx, cy = _cols(p, st.off, 9)
    cp, sp = half_angle(e1, e2)
    c = torch.sqrt(e1**2 + e2**2 + 1e-24)
    q = (1.0 - c) / (1.0 + c)
    sq = torch.sqrt(q)
    dx, dy = x - cx, y - cy
    a = cp * dx + sp * dy
    b = -sp * dx + cp * dy
    xt1 = a * sq
    xt2 = b / sq
    rr = torch.sqrt(xt1**2 + xt2**2)
    R = torch.clamp(rr, 1e-10, 1e10)
    bn = 1.9992 * n_s - 0.3271
    P1, P2, P3 = powp(R, al), powp(Rb, al), powp(R_s, al)
    u = (P1 + P2) / P3
    lbr = torch.log(Rb / R)
    B = torch.exp(al * lbr)
    A = 1.0 + B
    r = ga / al
    lA = torch.log(A)
    F = torch.exp(r * lA)
    k = 1.0 / (al * n_s)
    lu = torch.log(u)
    W = torch.exp(k * lu)
    E = torch.exp(-bn * (W - 1.0))
    g_shape = cts[0] if st.lstsq else cts[0] * p[:, st.off + 9: st.off + 10]
    g_F = g_shape * E
    g_E = g_shape * F
    g_bn = -g_E * E * (W - 1.0)
    g_W = -g_E * E * bn
    g_k = g_W * W * lu
    g_u = g_W * W * k / u
    g_al = -g_k * k / al
    g_n = -g_k * k / n_s + 1.9992 * g_bn
    g_P12 = g_u / P3  # u = (P1 + P2) / P3
    g_P3 = -g_u * u / P3
    g_al = g_al + g_P12 * P1 * torch.log(R) + g_P12 * P2 * torch.log(Rb) + g_P3 * P3 * torch.log(R_s)
    g_R = g_P12 * P1 * al / R
    g_Rb = g_P12 * P2 * al / Rb
    g_Rs = g_P3 * P3 * al / R_s
    g_r = g_F * F * lA
    g_B = g_F * F * r / A
    g_ga = g_r / al
    g_al = g_al - g_r * ga / (al * al) + g_B * B * lbr
    g_lbr = g_B * B * al
    g_Rb = g_Rb + g_lbr / Rb
    g_R = g_R - g_lbr / R
    # elliptical radius -> geometry (as _sersic_bwd, with R's clip band)
    g_rr = torch.where((rr > 1e-10) & (rr < 1e10), g_R / rr, _zero(g_R))
    g_xt1 = g_rr * xt1
    g_xt2 = g_rr * xt2
    g_a = g_xt1 * sq
    g_b = g_xt2 / sq
    g_sq = g_xt1 * a - g_xt2 * xt2 / sq
    g_cp = g_a * dx + g_b * dy
    g_sp = g_a * dy - g_b * dx
    g_dx = g_a * cp - g_b * sp
    g_dy = g_a * sp + g_b * cp
    g_q = g_sq * 0.5 / sq
    g_c = -2.0 * g_q / ((1.0 + c) * (1.0 + c))
    g_e1, g_e2 = half_angle_bwd(e1, e2, g_cp, g_sp)
    g_e1 = g_e1 + g_c * e1 / c
    g_e2 = g_e2 + g_c * e2 / c
    cols = [g_Rs, g_n, g_Rb, g_al, g_ga, g_e1, g_e2, -g_dx, -g_dy]
    if not st.lstsq:
        cols.append(cts[0] * F * E)
    return g_dx, g_dy, list(enumerate(cols, st.off))


def _shapelet_bwd(p, x, y, st, cts):
    beta, cx, cy = _cols(p, st.off, 3)
    u = (x - cx) / beta
    v = (y - cy) / beta
    gauss = torch.exp(-(u**2 + v**2) / 2.0)
    pf = [float(f) for f in shapelet_prefactor(st.n_max)]
    Hu, Hv = _hermites(u, st.n_max), _hermites(v, st.n_max)
    hu = [f * h for f, h in zip(pf, Hu)]
    hv = [f * h for f, h in zip(pf, Hv)]
    g_gauss = 0.0
    g_hu = [0.0] * (st.n_max + 1)
    g_hv = [0.0] * (st.n_max + 1)
    cols = []
    for k, (n1, n2) in enumerate(_pairs(st.n_max)):
        if st.lstsq:
            w = cts[k]  # cotangent of component k
        else:
            amp = p[:, st.off + 3 + k: st.off + 4 + k]
            cols.append((st.off + 3 + k, cts[0] * gauss * hu[n1] * hv[n2]))
            w = cts[0] * amp
        g_gauss = g_gauss + w * hu[n1] * hv[n2]
        g_hu[n1] = g_hu[n1] + w * gauss * hv[n2]
        g_hv[n2] = g_hv[n2] + w * gauss * hu[n1]
    # d H_n / dw = 2 n H_{n-1}
    g_u = -g_gauss * gauss * u
    g_v = -g_gauss * gauss * v
    for n in range(1, st.n_max + 1):
        g_u = g_u + g_hu[n] * pf[n] * 2.0 * n * Hu[n - 1]
        g_v = g_v + g_hv[n] * pf[n] * 2.0 * n * Hv[n - 1]
    g_x, g_y = g_u / beta, g_v / beta
    g_beta = -(g_u * u + g_v * v) / beta
    return g_x, g_y, [(st.off, g_beta), (st.off + 1, -g_x), (st.off + 2, -g_y)] + cols


_MASS_BWD = {EPL: _epl_bwd, SIS: _sis_bwd, SHEAR: _shear_bwd, NFW: _nfw_bwd,
             NFW_E: _nfw_e_bwd, SERIES: _series_bwd}
_LIGHT_BWD = {SERSIC_E: _sersic_e_bwd, SERSIC: _sersic_sph_bwd,
              CORE_SERSIC: _core_sersic_bwd, SHAPELETS: _shapelet_bwd}


@torch.no_grad()
def tile_backward_onestage(spec, params, x, y, extras, ct, summed: bool):
    """The hand-derived VJP in one stage -> (bs, n_cols) gradient.

    ``ct`` is (bs, P) for the summed render, (depth, bs, P) for the
    components render. The light stages give parameter cotangents and, at
    the source, a cotangent on beta; beta = x - sum alpha, so each mass
    stage receives -ct_beta.
    """
    bs = params.shape[0]
    shape = (bs, x.shape[0])
    grad = torch.zeros((bs, spec.n_cols), dtype=params.dtype, device=params.device)

    def add(cols):
        for col, g in cols:
            grad[:, col] += torch.broadcast_to(g, shape).sum(dim=-1)

    ax, ay = _deflect(spec, params, x, y, extras)
    bx, by = x - ax, y - ay
    g_bx = g_by = 0.0
    comp = 0
    for st in spec.light:
        n = st.n_out
        cts = [ct] * n if summed else [ct[comp + j] for j in range(n)]
        comp += n
        sx, sy = (bx, by) if st.is_source else (x, y)
        g_x, g_y, cols = _LIGHT_BWD[st.op](params, sx, sy, st, cts)
        add(cols)
        if st.is_source:
            g_bx, g_by = g_bx + g_x, g_by + g_y
    for st in spec.mass:
        add(_MASS_BWD[st.op](params, x, y, st, extras, -g_bx, -g_by))
    return grad


# ---------------------------------------------------------------------------
# The two-stage form, line for line with csrc/stages.cuh: per stage, what
# depends on the sample alone (``_CONSTS``), the pixel's forward from those
# constants (``_MASS_FWD2`` / ``_LIGHT_FWD2``: K5/K6 and K7's recompute), the
# pixel's VJP as cotangent terms of per-sample quantities (``_MASS_BWD2`` /
# ``_LIGHT_BWD2``: the stage's sums) and the map from a stage's sums to its
# packed gradient columns (``_EPILOGUE``, linear in the sums). The EPL and
# the Sersics are ops/cuda/fused_render.py's, shared with K1-K3.
# ---------------------------------------------------------------------------

def stage_sums(st: Stage) -> int:
    """Columns of the sums that stage ``st`` reduces in K7."""
    if st.op == SHAPELETS:
        return 3 + (0 if st.lstsq else st.depth)
    return {EPL: fr.EPL_SUMS, SIS: 3, SHEAR: 2, NFW: 4, NFW_E: 8, SERIES: 2,
            SERSIC_E: fr.SERSIC_SUMS, SERSIC: fr.SERSIC_SUMS, CORE_SERSIC: 11}[st.op]


def sum_offsets(spec):
    """({stage: first column of its sums}, n_sums), in the kernels' stage
    order (mass stages first)."""
    offs, n = {}, 0
    for st in spec.mass + spec.light:
        offs[st] = n
        n += stage_sums(st)
    return offs, n


def _epl_consts2(p, st):
    te, gam, e1, e2, cx, cy = _cols(p, st.off, 6)
    return fr.epl_consts(te, gam, e1, e2, cx, cy), fr.series_table(gam, e1, e2, st.niter)


def _epl_fwd2(p, st, k, x, y, extras):
    e, table = k
    g = fr.epl_pixel(e, x, y)
    ox, oy = fr.series_fwd(g["cos_t"], g["sin_t"], table[0], st.niter)
    return (*fr.epl_deflect(e, g, ox, oy), (g, ox, oy))


def _epl_bwd2(p, st, k, keep, x, y, extras, g_ax, g_ay):
    (e, table), (g, ox, oy) = k, keep
    return fr.epl_bwd_pixel(e, g, ox, oy, g_ax, g_ay, table, st.niter)


def _epl_epilogue2(p, st, g):
    te, _, e1, e2, _, _ = _cols(p, st.off, 6)
    return fr.epl_epilogue(te, e1, e2, g)


def _plain_fwd2(deflect):
    """A mass stage with nothing to hoist: its one-stage forward."""
    def fwd(p, st, k, x, y, extras):
        return (*deflect(p, x, y, st, extras), None)
    return fwd


def _plain_bwd2(bwd):
    """A mass stage with nothing to hoist: its one-stage VJP, whose
    parameter cotangents are the stage's sums themselves."""
    def terms(p, st, k, keep, x, y, extras, g_ax, g_ay):
        return [g for _, g in bwd(p, x, y, st, extras, g_ax, g_ay)]
    return terms


def _copy_epilogue2(p, st, g):
    return list(g)


def _nfw_e_stretch(e1, e2):
    m = torch.sqrt(e1**2 + e2**2 + 1e-24)
    c = torch.clamp(m, max=0.9999)
    q = (1.0 - c) / (1.0 + c)
    n1 = 1.0 - q * q
    d1 = 1.0 + q * q
    e = torch.abs(n1) / d1
    return m, c, q, n1, d1, torch.sqrt(1.0 - e), torch.sqrt(1.0 + e)


def _nfw_e_consts2(p, st):
    Rs, alpha_Rs, e1, e2, cx, cy = _cols(p, st.off, 6)
    cp, sp = half_angle(e1, e2)
    *_, se1, se2 = _nfw_e_stretch(e1, e2)
    return dict(cp=cp, sp=sp, se1=se1, se2=se2, Rs=Rs,
                rho0=alpha_Rs / (4.0 * Rs * Rs * (1.0 - _LOG2)), cx=cx, cy=cy)


def _nfw_e_pixel(k, x, y):
    dx, dy = x - k["cx"], y - k["cy"]
    xr = dx * k["cp"] + dy * k["sp"]
    yr = -dx * k["sp"] + dy * k["cp"]
    xs, ys = xr * k["se1"], yr * k["se2"]
    return dict(dx=dx, dy=dy, xr=xr, yr=yr, xs=xs, ys=ys, R=torch.sqrt(xs * xs + ys * ys))


def _nfw_e_fwd2(p, st, k, x, y, extras):
    f = _nfw_e_pixel(k, x, y)
    fx, fy = _nfw_alpha_radial(f["R"], k["Rs"], k["rho0"], f["xs"], f["ys"])
    fx, fy = fx * k["se1"], fy * k["se2"]
    return fx * k["cp"] - fy * k["sp"], fx * k["sp"] + fy * k["cp"], None


def _nfw_e_bwd2(p, st, k, keep, x, y, extras, g_ax, g_ay):
    """Sums: Rs (direct), rho0, cos phi, sin phi, se1, se2, dx, dy."""
    f = _nfw_e_pixel(k, x, y)
    cp, sp, se1, se2 = k["cp"], k["sp"], k["se1"], k["se2"]
    fx, fy = _nfw_alpha_radial(f["R"], k["Rs"], k["rho0"], f["xs"], f["ys"])
    ox, oy = fx * se1, fy * se2
    # rotation back
    g_ox = g_ax * cp + g_ay * sp
    g_oy = -g_ax * sp + g_ay * cp
    g_cp = g_ax * ox + g_ay * oy
    g_sp = -g_ax * oy + g_ay * ox
    # axis stretch of the output
    g_fx, g_fy = g_ox * se1, g_oy * se2
    g_se1, g_se2 = g_ox * fx, g_oy * fy
    g_Rr, g_Rs, g_rho0, g_xs, g_ys = _nfw_radial_bwd(f["R"], k["Rs"], k["rho0"], f["xs"],
                                                     f["ys"], g_fx, g_fy)
    g_xs = g_xs + g_Rr * f["xs"]
    g_ys = g_ys + g_Rr * f["ys"]
    # axis stretch of the input
    g_xr, g_yr = g_xs * se1, g_ys * se2
    g_se1 = g_se1 + g_xs * f["xr"]
    g_se2 = g_se2 + g_ys * f["yr"]
    # rotation into the ellipse frame
    g_cp = g_cp + g_xr * f["dx"] + g_yr * f["dy"]
    g_sp = g_sp + g_xr * f["dy"] - g_yr * f["dx"]
    return [g_Rs, g_rho0, g_cp, g_sp, g_se1, g_se2, g_xr * cp - g_yr * sp, g_xr * sp + g_yr * cp]


def _nfw_e_epilogue2(p, st, g):
    Rs, alpha_Rs, e1, e2, _, _ = _cols(p, st.off, 6)
    m, c, q, n1, d1, se1, se2 = _nfw_e_stretch(e1, e2)
    g_e = -g[4] * 0.5 / se1 + g[5] * 0.5 / se2
    g_q = g_e * (torch.sign(n1) * (-2.0 * q) / d1 - torch.abs(n1) * 2.0 * q / (d1 * d1))
    g_c = -2.0 * g_q / ((1.0 + c) * (1.0 + c))
    g_m = torch.where(m < 0.9999, g_c, _zero(g_c))
    g_e1, g_e2 = half_angle_bwd(e1, e2, g[2], g[3])
    g_Rs, g_aRs = _rho0_bwd(Rs, alpha_Rs, g[1], g[0])
    return [g_Rs, g_aRs, g_e1 + g_m * e1 / m, g_e2 + g_m * e2 / m, -g[6], -g[7]]


def _sersic_row(p, st):
    """The 7 SersicEllipse columns of a Sersic stage: a spherical Sersic has
    zero ellipticity, an lstsq stage unit amplitude."""
    if st.op == SERSIC_E:
        R_s, n_s, e1, e2, cx, cy = _cols(p, st.off, 6)
        amp = st.off + 6
    else:
        R_s, n_s, cx, cy = _cols(p, st.off, 4)
        e1 = e2 = torch.zeros_like(R_s)
        amp = st.off + 4
    Ie = torch.ones_like(R_s) if st.lstsq else p[:, amp: amp + 1]
    return R_s, n_s, e1, e2, cx, cy, Ie


def _sersic_consts2(p, st):
    return fr.sersic_consts(*_sersic_row(p, st))


def _sersic_fwd2(p, st, k, x, y):
    return [k["Ie"] * fr.sersic_fwd_pixel(x, y, k)["E"]]


def _sersic_bwd2(p, st, k, x, y, cts):
    return fr.sersic_bwd_pixel(cts[0], x, y, k)


def _sersic_epilogue2(p, st, g):
    _, _, e1, e2, _, _, _ = _sersic_row(p, st)
    t = fr.sersic_epilogue(e1, e2, g)
    cols = t[:6] if st.op == SERSIC_E else [t[0], t[1], t[4], t[5]]
    return cols + ([] if st.lstsq else [t[6]])


def _core_consts2(p, st):
    R_s, n_s, Rb, al, ga, e1, e2, cx, cy = _cols(p, st.off, 9)
    cp, sp = half_angle(e1, e2)
    c = torch.sqrt(e1**2 + e2**2 + 1e-24)
    q = (1.0 - c) / (1.0 + c)
    sq = torch.sqrt(q)
    isq = 1.0 / sq
    lRb, lRs = torch.log(Rb), torch.log(R_s)
    amp = torch.ones_like(R_s) if st.lstsq else p[:, st.off + 9: st.off + 10]
    return dict(cp=cp, sp=sp, sq=sq, isq=isq, half_isq=0.5 * isq, cx=cx, cy=cy,
                bn=1.9992 * n_s - 0.3271, al=al, r=ga / al, k=1.0 / (al * n_s), lRb=lRb,
                lRs=lRs, P2=torch.exp(al * lRb), P3=torch.exp(al * lRs), amp=amp)


def _core_pixel(k, x, y):
    dx, dy = x - k["cx"], y - k["cy"]
    a = k["cp"] * dx + k["sp"] * dy
    bb = -k["sp"] * dx + k["cp"] * dy
    xt1, xt2 = a * k["sq"], bb * k["isq"]
    rr = torch.sqrt(xt1 * xt1 + xt2 * xt2)
    R = torch.clamp(rr, 1e-10, 1e10)
    lR = torch.log(R)
    P1 = torch.exp(k["al"] * lR)
    u = (P1 + k["P2"]) / k["P3"]
    lbr = k["lRb"] - lR  # log(Rb / R)
    B = torch.exp(k["al"] * lbr)
    A = 1.0 + B
    lA = torch.log(A)
    F = torch.exp(k["r"] * lA)
    lu = torch.log(u)
    W = torch.exp(k["k"] * lu)
    return dict(dx=dx, dy=dy, a=a, xt1=xt1, xt2=xt2, rr=rr, R=R, lR=lR, P1=P1, u=u, lbr=lbr,
                B=B, A=A, lA=lA, F=F, lu=lu, W=W, E=torch.exp(-k["bn"] * (W - 1.0)))


def _core_fwd2(p, st, k, x, y):
    g = _core_pixel(k, x, y)
    return [k["amp"] * (g["F"] * g["E"])]


def _core_bwd2(p, st, k, x, y, cts):
    """Sums: R_s, n_s, Rb, alpha, gamma, cos phi, sin phi, q, dx, dy, Ie."""
    R_s, n_s, Rb, al, ga = _cols(p, st.off, 5)
    g = _core_pixel(k, x, y)
    E, F, W, u, R, B = g["E"], g["F"], g["W"], g["u"], g["R"], g["B"]
    g_shape = cts[0] * k["amp"]
    g_F = g_shape * E
    g_E = g_shape * F
    g_bn = -g_E * E * (W - 1.0)
    g_W = -g_E * E * k["bn"]
    g_k = g_W * W * g["lu"]
    g_u = g_W * W * k["k"] / u
    g_al = -g_k * k["k"] / al
    g_n = -g_k * k["k"] / n_s + 1.9992 * g_bn
    g_P12 = g_u / k["P3"]  # u = (P1 + P2) / P3
    g_P3 = -g_u * u / k["P3"]
    g_al = g_al + g_P12 * g["P1"] * g["lR"] + g_P12 * k["P2"] * k["lRb"] + g_P3 * k["P3"] * k["lRs"]
    g_R = g_P12 * g["P1"] * al / R
    g_Rb = g_P12 * k["P2"] * al / Rb
    g_Rs = g_P3 * k["P3"] * al / R_s
    g_r = g_F * F * g["lA"]
    g_B = g_F * F * k["r"] / g["A"]
    g_ga = g_r / al
    g_al = g_al - g_r * ga / (al * al) + g_B * B * g["lbr"]
    g_lbr = g_B * B * al
    g_Rb = g_Rb + g_lbr / Rb
    g_R = g_R - g_lbr / R
    # elliptical radius -> geometry (as the Sersic's, with R's clip band)
    rr = g["rr"]
    g_rr = torch.where((rr > 1e-10) & (rr < 1e10), g_R / rr, _zero(g_R))
    g_xt1 = g_rr * g["xt1"]
    g_xt2 = g_rr * g["xt2"]
    g_a = g_xt1 * k["sq"]
    g_b = g_xt2 * k["isq"]
    g_x = g_a * k["cp"] - g_b * k["sp"]
    g_y = g_a * k["sp"] + g_b * k["cp"]
    dx, dy = g["dx"], g["dy"]
    g_amp = _zero(g_x) if st.lstsq else cts[0] * F * E
    terms = [g_Rs, g_n, g_Rb, g_al, g_ga, g_a * dx + g_b * dy, g_a * dy - g_b * dx,
             (g_xt1 * g["a"] - g_xt2 * g["xt2"] * k["isq"]) * k["half_isq"], g_x, g_y, g_amp]
    return g_x, g_y, terms


def _core_epilogue2(p, st, g):
    e1, e2 = _cols(p, st.off + 5, 2)
    c = torch.sqrt(e1**2 + e2**2 + 1e-24)
    g_c = -2.0 * g[7] / ((1.0 + c) * (1.0 + c))
    h1, h2 = half_angle_bwd(e1, e2, g[5], g[6])
    return list(g[:5]) + [h1 + g_c * e1 / c, h2 + g_c * e2 / c, -g[8], -g[9]] + (
        [] if st.lstsq else [g[10]])


# -log2(e) / 2: exp(-r^2 / 2) = exp2(c r^2). A float32 tensor takes it
# rounded to float32, the kernels' constant; a float64 one takes it whole.
_NEG_HALF_LOG2E = -0.5 * math.log2(math.e)


def shapelet_table_floats(n_max: int) -> int:
    """Floats of a shapelet stage's folded table in shared memory: row j
    holds n_max - j + 1 coefficients, padded to a float4
    (csrc/stages.cuh: shapelet_table_floats)."""
    return sum(-(-(n_max - j + 1) // 4) * 4 for j in range(n_max + 1))


def _shapelet_consts2(p, st):
    """1 / beta, the center and the folded table a'[i][j] = amp(i, j) pf[i]
    pf[j] of the summed forward (amp(i, j): the amplitude of component
    (n1, n2) = (i, j); 1 for an lstsq stage summed with unit amplitudes)."""
    beta, cx, cy = _cols(p, st.off, 3)
    pf = [float(f) for f in shapelet_prefactor(st.n_max)]
    table = {}
    for j, (n1, n2) in enumerate(_pairs(st.n_max)):
        amp = torch.ones_like(beta) if st.lstsq else p[:, st.off + 3 + j: st.off + 4 + j]
        table[n1, n2] = (amp * pf[n1]) * pf[n2]
    return dict(ib=1.0 / beta, cx=cx, cy=cy, table=table)


def _shapelet_basis(k, x, y, n_max):
    u = (x - k["cx"]) * k["ib"]
    v = (y - k["cy"]) * k["ib"]
    gauss = torch.exp(-(u * u + v * v) / 2.0)
    pf = [float(f) for f in shapelet_prefactor(n_max)]
    Hu, Hv = _hermites(u, n_max), _hermites(v, n_max)
    return u, v, gauss, pf, Hu, Hv, [f * h for f, h in zip(pf, Hu)], [f * h for f, h in zip(pf, Hv)]


def _shapelet_rows(k, x, y, n_max):
    """The forward's pixel quantities: the Gaussian as one exp2 and the raw
    Hermite rows (csrc/stages.cuh: shapelets_fwd_sum / _components)."""
    u = (x - k["cx"]) * k["ib"]
    v = (y - k["cy"]) * k["ib"]
    gauss = torch.exp2(_NEG_HALF_LOG2E * (u * u + v * v))
    return gauss, _hermites(u, n_max), _hermites(v, n_max)


def _shapelet_fwd2(p, st, k, x, y):
    """Components: the pf-scaled rows, the Gaussian in one of them, one
    multiply a component."""
    gauss, Hu, Hv = _shapelet_rows(k, x, y, st.n_max)
    pf = [float(f) for f in shapelet_prefactor(st.n_max)]
    hu = [(f * h) * gauss for f, h in zip(pf, Hu)]
    hv = [f * h for f, h in zip(pf, Hv)]
    return [hu[a] * hv[b] for a, b in _pairs(st.n_max)]


def _shapelet_fwd_sum2(p, st, k, x, y):
    """Summed: gauss * sum_j Hv[j] (sum_i a'[i][j] Hu[i]) against the folded
    table, in the kernel's order."""
    gauss, Hu, Hv = _shapelet_rows(k, x, y, st.n_max)
    total = 0.0
    for j in range(st.n_max + 1):
        t = 0.0
        for i in range(st.n_max - j + 1):
            t = t + k["table"][i, j] * Hu[i]
        total = total + Hv[j] * t
    return [gauss * total]


def _shapelet_bwd2(p, st, k, x, y, cts):
    """Sums: beta, center_x, center_y, then the sampled amplitudes."""
    u, v, gauss, pf, Hu, Hv, hu, hv = _shapelet_basis(k, x, y, st.n_max)
    g_gauss = 0.0
    g_hu = [0.0] * (st.n_max + 1)
    g_hv = [0.0] * (st.n_max + 1)
    amps = []
    for j, (n1, n2) in enumerate(_pairs(st.n_max)):
        if st.lstsq:
            w = cts[j]  # cotangent of component j
        else:
            amps.append(cts[0] * (gauss * hu[n1] * hv[n2]))
            w = cts[0] * p[:, st.off + 3 + j: st.off + 4 + j]
        g_gauss = g_gauss + w * hu[n1] * hv[n2]
        g_hu[n1] = g_hu[n1] + w * gauss * hv[n2]
        g_hv[n2] = g_hv[n2] + w * gauss * hu[n1]
    # d H_n / dw = 2 n H_{n-1}
    g_u = -g_gauss * gauss * u
    g_v = -g_gauss * gauss * v
    for n in range(1, st.n_max + 1):
        g_u = g_u + g_hu[n] * pf[n] * 2.0 * n * Hu[n - 1]
        g_v = g_v + g_hv[n] * pf[n] * 2.0 * n * Hv[n - 1]
    g_x, g_y = g_u * k["ib"], g_v * k["ib"]
    return g_x, g_y, [-(g_u * u + g_v * v) * k["ib"], -g_x, -g_y] + amps


def _no_consts(p, st):
    return None


_CONSTS = {EPL: _epl_consts2, NFW_E: _nfw_e_consts2, SERSIC_E: _sersic_consts2,
           SERSIC: _sersic_consts2, CORE_SERSIC: _core_consts2, SHAPELETS: _shapelet_consts2}
_MASS_FWD2 = {EPL: _epl_fwd2, SIS: _plain_fwd2(_sis_deflect), SHEAR: _plain_fwd2(_shear_deflect),
              NFW: _plain_fwd2(_nfw_deflect), NFW_E: _nfw_e_fwd2,
              SERIES: _plain_fwd2(_series_deflect)}
_MASS_BWD2 = {EPL: _epl_bwd2, SIS: _plain_bwd2(_sis_bwd), SHEAR: _plain_bwd2(_shear_bwd),
              NFW: _plain_bwd2(_nfw_bwd), NFW_E: _nfw_e_bwd2, SERIES: _plain_bwd2(_series_bwd)}
_LIGHT_FWD2 = {SERSIC_E: _sersic_fwd2, SERSIC: _sersic_fwd2, CORE_SERSIC: _core_fwd2,
               SHAPELETS: _shapelet_fwd2}
_LIGHT_BWD2 = {SERSIC_E: _sersic_bwd2, SERSIC: _sersic_bwd2, CORE_SERSIC: _core_bwd2,
               SHAPELETS: _shapelet_bwd2}
_EPILOGUE = {EPL: _epl_epilogue2, NFW_E: _nfw_e_epilogue2, SERSIC_E: _sersic_epilogue2,
             SERSIC: _sersic_epilogue2, CORE_SERSIC: _core_epilogue2}


def stage_consts(spec, params):
    """The prologue: {stage: its per-sample constants} (None where a stage
    has nothing to hoist)."""
    return {st: _CONSTS.get(st.op, _no_consts)(params, st) for st in spec.stages}


def _deflect2(spec, consts, params, x, y, extras):
    """Total deflection from the stages' constants, and what each mass
    stage keeps of its forward for its backward (an EPL: its Omega)."""
    ax = ay = 0.0
    keep = {}
    for st in spec.mass:
        dax, day, keep[st] = _MASS_FWD2[st.op](params, st, consts[st], x, y, extras)
        ax, ay = ax + dax, ay + day
    return ax, ay, keep


@torch.no_grad()
def tile_forward_twostage(spec, params, x, y, extras=(), summed: bool = True):
    """Plain twin of K5 (``summed``: (bs, P)) / K6 ((depth, bs, P)) in the
    kernels' two stages: :func:`stage_consts`, then the pixel forwards."""
    if not summed and not spec.all_lstsq:
        raise ValueError("the components render needs every light stage in lstsq mode")
    consts = stage_consts(spec, params)
    ax, ay, _ = _deflect2(spec, consts, params, x, y, extras)
    bx, by = x - ax, y - ay
    comps = []
    for st in spec.light:
        sx, sy = (bx, by) if st.is_source else (x, y)
        fwd = _shapelet_fwd_sum2 if summed and st.op == SHAPELETS else _LIGHT_FWD2[st.op]
        comps.extend(fwd(params, st, consts[st], sx, sy))
    comps = [torch.broadcast_to(c, (params.shape[0], x.shape[0])) for c in comps]
    if not summed:
        return torch.stack(comps)
    total = comps[0]
    for c in comps[1:]:
        total = total + c
    return total


@torch.no_grad()
def bwd_pixel_terms(spec, params, x, y, extras, ct, summed: bool):
    """K7's pixel stage: the n_sums cotangent terms, each broadcastable to
    (bs, P), in the order of :func:`sum_offsets`; their sums over the pixels
    go to :func:`builder_bwd_epilogue`. Recomputes the forward (keeping each
    EPL's Omega), runs the light stages' VJPs, which give at the source a
    cotangent on beta, then the mass stages' with -ct_beta."""
    consts = stage_consts(spec, params)
    ax, ay, keep = _deflect2(spec, consts, params, x, y, extras)
    bx, by = x - ax, y - ay
    g_bx = g_by = 0.0
    comp = 0
    light = []
    for st in spec.light:
        n = st.n_out
        cts = [ct] * n if summed else [ct[comp + j] for j in range(n)]
        comp += n
        sx, sy = (bx, by) if st.is_source else (x, y)
        g_x, g_y, terms = _LIGHT_BWD2[st.op](params, st, consts[st], sx, sy, cts)
        light += terms
        if st.is_source:
            g_bx, g_by = g_bx + g_x, g_by + g_y
    mass = []
    for st in spec.mass:
        mass += _MASS_BWD2[st.op](params, st, consts[st], keep[st], x, y, extras, -g_bx, -g_by)
    return mass + light


def builder_bwd_epilogue(spec, params, sums):
    """K7's epilogue: (bs, n_sums) sums of the pixel terms -> (bs, n_cols).
    Columns no stage owns get 0."""
    offs, n_sums = sum_offsets(spec)
    if sums.shape != (params.shape[0], n_sums):
        raise ValueError(f"sums must be {(params.shape[0], n_sums)}, got {tuple(sums.shape)}")
    grad = torch.zeros((params.shape[0], spec.n_cols), dtype=params.dtype, device=params.device)
    for st in spec.stages:
        g = [sums[:, offs[st] + j: offs[st] + j + 1] for j in range(stage_sums(st))]
        cols = _EPILOGUE.get(st.op, _copy_epilogue2)(params, st, g)
        grad[:, st.off: st.off + len(cols)] = torch.cat(cols, dim=-1)
    return grad


@torch.no_grad()
def tile_backward_reference(spec, params, x, y, extras, ct, summed: bool):
    """Plain twin of K7 in its two stages: :func:`bwd_pixel_terms`, their
    sums over the pixels, then :func:`builder_bwd_epilogue` -> (bs, n_cols).

    ``ct`` is (bs, P) for the summed render, (depth, bs, P) for the
    components render.
    """
    shape = (params.shape[0], x.shape[0])
    terms = bwd_pixel_terms(spec, params, x, y, extras, ct, summed)
    sums = torch.stack([torch.broadcast_to(t, shape).sum(dim=-1) for t in terms], dim=-1)
    return builder_bwd_epilogue(spec, params, sums)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def smem_bytes(spec, n_sums: int, bwd: bool, summed: bool = True) -> int:
    """Dynamic shared memory of a block (csrc/fused_builder.cu: smem_floats):
    the packed row, SLOT floats a stage, a series table per EPL stage, for
    the summed forward a folded table per shapelet stage and, for K7, Omega
    of each EPL stage and one float per thread per sums column."""
    n_epl = sum(st.op == EPL for st in spec.mass)
    floats = -(-spec.n_cols // 4) * 4 + len(spec.stages) * SLOT + n_epl * 4 * fr.MAX_NITER
    if bwd:
        floats += n_epl * 2 * TILE + n_sums * TILE
    elif summed:
        floats += sum(shapelet_table_floats(st.n_max) for st in spec.light if st.op == SHAPELETS)
    return 4 * floats


def _launch_args(spec, params, x, y, extras, summed, bwd=False):
    """Validates a launch; returns (bs, npix, extras matrix, records, pf, n_sums)."""
    if len(spec.stages) > MAX_STAGES:
        raise ValueError(f"{len(spec.stages)} stages exceed the kernels' {MAX_STAGES}")
    if spec.n_cols > MAX_COLS:
        raise ValueError(f"{spec.n_cols} packed columns exceed the kernels' {MAX_COLS}")
    n_max = max([st.n_max for st in spec.light if st.op == SHAPELETS], default=0)
    if n_max > SHAPELET_CAP:
        raise ValueError(f"shapelet n_max={n_max} exceeds the kernels' cap ({SHAPELET_CAP})")
    for st in spec.mass:
        if st.op == EPL and not 1 <= st.niter <= fr.MAX_NITER:
            raise ValueError(f"niter={st.niter} is outside the kernels' series table "
                             f"(1..{fr.MAX_NITER})")
    if not summed and not spec.all_lstsq:
        raise ValueError("the components render needs every light stage in lstsq mode")
    offs, n_sums = sum_offsets(spec)
    need = smem_bytes(spec, n_sums, bwd, summed)
    if need > MAX_SMEM:
        raise ValueError(f"the stage program needs {need} bytes of shared memory a block "
                         f"({n_sums} sums columns), above the card's {MAX_SMEM}")
    bs, npix = params.shape[0], x.shape[0]
    dev = params.device
    _build.check_arg(params, "params", (bs, spec.n_cols), dev)
    _build.check_arg(x, "x", (npix,), dev)
    _build.check_arg(y, "y", (npix,), dev)
    if bs > 65535:
        raise ValueError(f"bs={bs} exceeds the kernel grid's y limit (65535)")
    rows, row_off = 0, []
    for i, e in enumerate(extras):
        _build.check_arg(e, f"extras[{i}]", (e.shape[0], npix), dev)
        row_off.append(rows)
        rows += e.shape[0]
    ex = torch.cat(list(extras)) if extras else torch.zeros((1,), device=dev)
    recs, comp, n_epl, n_shp = [], 0, 0, 0
    for st in spec.mass + spec.light:
        a = {EPL: st.niter, SERIES: st.order, SHAPELETS: st.n_max}.get(st.op, 0)
        if st.op == SERIES and st.extra >= len(extras):
            raise ValueError(f"series stage needs extras[{st.extra}]")
        # b: a series stage's first grid row, an EPL stage's series table, a
        # shapelet stage's first float among the folded tables
        b = 0
        if st.op == SERIES:
            b = row_off[st.extra]
        elif st.op == EPL:
            b, n_epl = n_epl, n_epl + 1
        elif st.op == SHAPELETS:
            b, n_shp = n_shp, n_shp + shapelet_table_floats(st.n_max)
        recs += [st.op, st.off, a, b, int(st.lstsq) | (int(st.is_source) << 1), comp, offs[st]]
        if st.op not in MASS_OPS:
            comp += st.n_out
    recs = (ctypes.c_int * len(recs))(*recs)
    pf = (ctypes.c_float * (SHAPELET_CAP + 1))(*shapelet_prefactor(SHAPELET_CAP))
    return bs, npix, ex, recs, pf, n_sums


def fused_builder_fwd(spec, params, x, y, extras=(), summed: bool = True):
    """K5 (``summed``: (bs, P)) or K6 (components: (depth, bs, P)).

    CPU tensors take the plain twin; CUDA tensors launch the kernel.
    """
    if params.device.type == "cpu":
        return tile_forward_twostage(spec, params, x, y, extras, summed)
    bs, npix, ex, recs, pf, n_sums = _launch_args(spec, params, x, y, extras, summed)
    shape = (bs, npix) if summed else (spec.depth, bs, npix)
    out = torch.empty(shape, dtype=torch.float32, device=params.device)
    lib, ptr = _build.load(), _build.ptr
    with torch.cuda.device(params.device):
        err = lib.gl_fused_builder_fwd(
            ptr(params), ptr(x), ptr(y), ptr(ex), ptr(out), recs, len(spec.mass),
            len(spec.light), pf, bs, npix, spec.n_cols, n_sums, int(summed),
            _build.stream(params.device),
        )
    _build.check(err, "fused_builder_fwd")
    launches["fused_builder_fwd_sum" if summed else "fused_builder_fwd_components"] += 1
    return out


def fused_builder_bwd(spec, params, x, y, extras, ct, summed: bool = True):
    """K7: (bs, n_cols) parameter gradient. CPU tensors take the plain twin."""
    if params.device.type == "cpu":
        return tile_backward_reference(spec, params, x, y, extras, ct, summed)
    bs, npix, ex, recs, pf, n_sums = _launch_args(spec, params, x, y, extras, summed, bwd=True)
    _build.check_arg(ct, "ct", (bs, npix) if summed else (spec.depth, bs, npix), params.device)
    n_chunks = -(-npix // (TILE * TILES_PER_BLOCK))
    partial = torch.empty((bs, n_chunks, n_sums), dtype=torch.float32, device=params.device)
    grad = torch.empty((bs, spec.n_cols), dtype=torch.float32, device=params.device)
    lib, ptr = _build.load(), _build.ptr
    with torch.cuda.device(params.device):
        err = lib.gl_fused_builder_bwd(
            ptr(params), ptr(x), ptr(y), ptr(ex), ptr(ct), ptr(partial), ptr(grad), recs,
            len(spec.mass), len(spec.light), pf, bs, npix, spec.n_cols, n_sums, int(summed),
            _build.stream(params.device),
        )
    _build.check(err, "fused_builder_bwd")
    launches["fused_builder_bwd"] += 1
    return grad


class _FusedBuilder(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, summed, params, x, y, *extras):
        ctx.spec, ctx.summed = spec, summed
        ctx.save_for_backward(params, x, y, *extras)
        return fused_builder_fwd(spec, params, x, y, extras, summed)

    @staticmethod
    def backward(ctx, ct):
        params, x, y, *extras = ctx.saved_tensors
        with span("simulator.render_backward"):
            g = fused_builder_bwd(ctx.spec, params, x, y, extras, ct.contiguous(), ctx.summed)
        # the coefficient grids are precomputed constants of the sampled
        # parameters, and coordinates carry no gradient (as in JAX)
        return (None, None, g, torch.zeros_like(x), torch.zeros_like(y),
                *(torch.zeros_like(e) for e in extras))


def fused_render_sum(params, x, y, extras, spec: FusedSpec):
    """Total surface brightness: params (bs, n_cols); x, y (P,); extras from
    ``spec.gather_extras`` -> (bs, P). Differentiable in ``params`` (K7)."""
    return _FusedBuilder.apply(spec, True, params, x, y, *extras)


def fused_render_components(params, x, y, extras, spec: FusedSpec):
    """Stacked per-component render for the lstsq solve -> (depth, bs, P)."""
    return _FusedBuilder.apply(spec, False, params, x, y, *extras)
