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
  either mode, by recompute and the stages' hand-derived VJPs in reverse.

Beside them, the plain PyTorch twins: :func:`tile_forward_reference` (the
JAX stage functions line for line, differentiable by torch autograd) and
:func:`tile_backward_reference` (the hand-derived VJP, line for line with
``csrc/stages.cuh``). The wrappers take the twins for CPU tensors only; for
CUDA tensors they launch the kernels or raise.

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
from gigalens_tpu_torch.ops.cuda._math import half_angle, half_angle_bwd, powp
from gigalens_tpu_torch.ops.cuda.fused_render import _sersic_bwd, _sersic_light
from gigalens_tpu_torch.profiles.mass.epl import _omega_cs_bwd, _omega_cs_impl, omega_cs

# stage opcodes, mirrored by csrc/stages.cuh
EPL, SIS, SHEAR, NFW, NFW_E, SERIES = 0, 1, 2, 3, 4, 5
SERSIC_E, SERSIC, CORE_SERSIC, SHAPELETS = 8, 9, 10, 11
MASS_OPS = frozenset((EPL, SIS, SHEAR, NFW, NFW_E, SERIES))

TILE = 256  # pixels per block of the CUDA kernels (one thread each)
SHAPELET_CAP = 10  # largest shapelet n_max the kernels take (local H_n arrays)
MAX_STAGES = 32  # stage records in the kernels' by-value argument struct
MAX_COLS = 1024  # packed columns (shared-memory staging of params and grads)

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
    None: a profile with no stage, mixed lstsq and sampled amplitudes, or
    no light profile. (The Taylor-series stage exists, but its profile,
    ``MassSeries``, is not ported yet: ROADMAP M15.)"""
    from gigalens_tpu_torch.profiles.light.sersic import CoreSersic, Sersic, SersicEllipse
    from gigalens_tpu_torch.profiles.light.shapelets import Shapelets
    from gigalens_tpu_torch.profiles.mass.epl import EPL as EPLProfile
    from gigalens_tpu_torch.profiles.mass.nfw import NFW as NFWProfile
    from gigalens_tpu_torch.profiles.mass.nfw import NFW_ELLIPSE
    from gigalens_tpu_torch.profiles.mass.shear import Shear
    from gigalens_tpu_torch.profiles.mass.sie import SIE
    from gigalens_tpu_torch.profiles.mass.sie import SIS as SISProfile

    pack_cols: list = []
    stages: list = []
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

    spec = FusedSpec(stages, pack_cols, "+".join(names))
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
# Plain PyTorch twins: the hand-derived VJPs, line for line with stages.cuh
# Mass stages: (g_ax, g_ay) cotangent -> [(column, cotangent)].
# Light stages: per-output cotangents -> (g_x, g_y, [(column, cotangent)]).
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
def tile_backward_reference(spec, params, x, y, extras, ct, summed: bool):
    """Plain twin of K7: the hand-derived VJP -> (bs, n_cols) gradient.

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
# Kernel wrappers
# ---------------------------------------------------------------------------

def _launch_args(spec, params, x, y, extras, summed):
    """Validates a launch; returns (bs, npix, extras matrix, records, pf)."""
    if len(spec.stages) > MAX_STAGES:
        raise ValueError(f"{len(spec.stages)} stages exceed the kernels' {MAX_STAGES}")
    if spec.n_cols > MAX_COLS:
        raise ValueError(f"{spec.n_cols} packed columns exceed the kernels' {MAX_COLS}")
    n_max = max([st.n_max for st in spec.light if st.op == SHAPELETS], default=0)
    if n_max > SHAPELET_CAP:
        raise ValueError(f"shapelet n_max={n_max} exceeds the kernels' cap ({SHAPELET_CAP})")
    if not summed and not spec.all_lstsq:
        raise ValueError("the components render needs every light stage in lstsq mode")
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
    recs, comp = [], 0
    for st in spec.mass + spec.light:
        a = {EPL: st.niter, SERIES: st.order, SHAPELETS: st.n_max}.get(st.op, 0)
        if st.op == SERIES and st.extra >= len(extras):
            raise ValueError(f"series stage needs extras[{st.extra}]")
        b = row_off[st.extra] if st.op == SERIES else 0
        recs += [st.op, st.off, a, b, int(st.lstsq) | (int(st.is_source) << 1), comp]
        if st.op not in MASS_OPS:
            comp += st.n_out
    recs = (ctypes.c_int * len(recs))(*recs)
    pf = (ctypes.c_float * (SHAPELET_CAP + 1))(*shapelet_prefactor(SHAPELET_CAP))
    return bs, npix, ex, recs, pf


def fused_builder_fwd(spec, params, x, y, extras=(), summed: bool = True):
    """K5 (``summed``: (bs, P)) or K6 (components: (depth, bs, P)).

    CPU tensors take the plain twin; CUDA tensors launch the kernel.
    """
    if params.device.type == "cpu":
        with torch.no_grad():
            return fused_builder_reference(spec, params, x, y, extras, summed)
    bs, npix, ex, recs, pf = _launch_args(spec, params, x, y, extras, summed)
    shape = (bs, npix) if summed else (spec.depth, bs, npix)
    out = torch.empty(shape, dtype=torch.float32, device=params.device)
    lib, ptr = _build.load(), _build.ptr
    with torch.cuda.device(params.device):
        err = lib.gl_fused_builder_fwd(
            ptr(params), ptr(x), ptr(y), ptr(ex), ptr(out), recs, len(spec.mass),
            len(spec.light), pf, bs, npix, spec.n_cols, int(summed),
            _build.stream(params.device),
        )
    _build.check(err, "fused_builder_fwd")
    launches["fused_builder_fwd_sum" if summed else "fused_builder_fwd_components"] += 1
    return out


def fused_builder_bwd(spec, params, x, y, extras, ct, summed: bool = True):
    """K7: (bs, n_cols) parameter gradient. CPU tensors take the plain twin."""
    if params.device.type == "cpu":
        return tile_backward_reference(spec, params, x, y, extras, ct, summed)
    bs, npix, ex, recs, pf = _launch_args(spec, params, x, y, extras, summed)
    _build.check_arg(ct, "ct", (bs, npix) if summed else (spec.depth, bs, npix), params.device)
    n_tiles = -(-npix // TILE)
    partial = torch.empty((bs, n_tiles, spec.n_cols), dtype=torch.float32,
                          device=params.device)
    lib, ptr = _build.load(), _build.ptr
    with torch.cuda.device(params.device):
        err = lib.gl_fused_builder_bwd(
            ptr(params), ptr(x), ptr(y), ptr(ex), ptr(ct), ptr(partial), recs,
            len(spec.mass), len(spec.light), pf, bs, npix, spec.n_cols, int(summed),
            _build.stream(params.device),
        )
    _build.check(err, "fused_builder_bwd")
    launches["fused_builder_bwd"] += 1
    # second, deterministic pass over the small (bs, n_tiles, n_cols) partials
    return partial.sum(dim=1)


class _FusedBuilder(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, summed, params, x, y, *extras):
        ctx.spec, ctx.summed = spec, summed
        ctx.save_for_backward(params, x, y, *extras)
        return fused_builder_fwd(spec, params, x, y, extras, summed)

    @staticmethod
    def backward(ctx, ct):
        params, x, y, *extras = ctx.saved_tensors
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
