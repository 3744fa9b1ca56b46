"""Fused EPL+Shear ray-shoot + two-Sersic render: CUDA kernels and their twins.

Port of :mod:`gigalens_tpu.ops.pallas.fused_render`. For each (sample,
pixel) it computes

    beta = x - alpha_EPL(x; lens params) - alpha_shear(x)
    out  = SersicEllipse(x; lens-light params) + SersicEllipse(beta; source)

writing only the final surface brightness. Three kernels
(``csrc/fused_render.cu``):

* K1 ``fused_render_fwd<false>``: the forward only (no residuals);
* K2 ``fused_render_fwd<true>``: the forward, also writing the EPL angular
  series Omega = (ox, oy) as the backward's residuals;
* K3 ``fused_render_bwd``: the (bs, 22) parameter gradient from Omega and
  the output cotangent, with no forward series loop: the hand-derived VJP
  of the closed-form output map, one O(1)-memory series backward loop, and
  the VJP of the geometry. Each block writes (bs, n_tiles, 22) partial sums;
  a second, deterministic pass sums the tiles (as the JAX side does).

Beside them, the plain PyTorch twins: :func:`fused_render_reference` (the
forward chain, differentiable by torch autograd through the EPL series
``autograd.Function``) and :func:`fused_render_bwd_reference` (the
hand-derived VJP, line for line with the CUDA device code). The wrappers
take the twins for CPU tensors only; for CUDA tensors they launch the
kernels or raise.

Parameter packing (columns of the (bs, 22) matrix):
    0-5   lens EPL: theta_E, gamma, e1, e2, center_x, center_y
    6-7   shear: gamma1, gamma2
    8-14  lens light Sersic: R_sersic, n_sersic, e1, e2, center_x, center_y, Ie
    15-21 source Sersic: R_sersic, n_sersic, e1, e2, center_x, center_y, Ie
"""
from __future__ import annotations

import torch

from gigalens_tpu_torch.ops.cuda import _build
from gigalens_tpu_torch.ops.cuda._math import half_angle, half_angle_bwd, powp
from gigalens_tpu_torch.profiles.mass.epl import _omega_cs_bwd, _omega_cs_impl, omega_cs

N_PARAMS = 22
TILE = 256  # pixels per block of the CUDA kernels (one thread each)

# Launch counts of the three kernels; each wrapper adds one where it
# launches its kernel and nowhere else.
launches = {"fused_render_fwd": 0, "fused_render_fwd_omega": 0, "fused_render_bwd": 0}


def pack_params(params_dict):
    """Packs the standard nested params dict into the (bs, N_PARAMS) matrix."""
    lm = params_dict["lens_mass"]
    ll = params_dict["lens_light"][0]
    sl = params_dict["source_light"][0]
    cols = [
        lm[0]["theta_E"], lm[0]["gamma"], lm[0]["e1"], lm[0]["e2"],
        lm[0]["center_x"], lm[0]["center_y"],
        lm[1]["gamma1"], lm[1]["gamma2"],
        ll["R_sersic"], ll["n_sersic"], ll["e1"], ll["e2"],
        ll["center_x"], ll["center_y"], ll["Ie"],
        sl["R_sersic"], sl["n_sersic"], sl["e1"], sl["e2"],
        sl["center_x"], sl["center_y"], sl["Ie"],
    ]
    return torch.stack([c.reshape(-1) for c in cols], dim=-1)


# ---------------------------------------------------------------------------
# Plain PyTorch twins
# ---------------------------------------------------------------------------

def _cols(p):
    return [p[:, k : k + 1] for k in range(N_PARAMS)]  # each (bs, 1)


def _sersic_light(x, y, R_s, n_s, e1, e2, cx, cy, Ie):
    cp, sp = half_angle(e1, e2)
    # epsilon inside the sqrt: finite gradient at exactly zero ellipticity
    c = torch.sqrt(e1**2 + e2**2 + 1e-24)
    q = (1.0 - c) / (1.0 + c)
    dx, dy = x - cx, y - cy
    xt1 = (cp * dx + sp * dy) * torch.sqrt(q)
    xt2 = (-sp * dx + cp * dy) / torch.sqrt(q)
    R = torch.sqrt(xt1**2 + xt2**2)
    bn = 1.9992 * n_s - 0.3271
    return Ie * torch.exp(-bn * (powp(R / R_s, 1.0 / n_s) - 1.0))


def _tile_geom(p, x, y):
    """EPL ellipse-frame geometry: (cos_t, sin_t) per pixel, (f, t) per sample."""
    c = _cols(p)
    gam, e1, e2, cx, cy = c[1], c[2], c[3], c[4], c[5]
    cp, sp = half_angle(e1, e2)
    cc = torch.clamp(torch.sqrt(e1**2 + e2**2 + 1e-24), max=1.0)
    q = (1.0 - cc) / (1.0 + cc)
    dx, dy = x - cx, y - cy
    xr = dx * cp + dy * sp
    yr = -dx * sp + dy * cp
    R = torch.clamp(torch.sqrt((q * xr) ** 2 + yr**2), 1e-10, 1e10)
    return q * xr / R, yr / R, (1.0 - q) / (1.0 + q), gam - 1.0


def _tile_out(p, x, y, ox, oy):
    """Surface brightness given the angular series (ox, oy)."""
    c = _cols(p)
    te, gam, e1, e2, cx, cy, g1, g2 = c[:8]
    cp, sp = half_angle(e1, e2)
    cc = torch.clamp(torch.sqrt(e1**2 + e2**2 + 1e-24), max=1.0)
    q = (1.0 - cc) / (1.0 + cc)
    b = te * torch.sqrt(q)
    t = gam - 1.0
    dx, dy = x - cx, y - cy
    xr = dx * cp + dy * sp
    yr = -dx * sp + dy * cp
    R = torch.clamp(torch.sqrt((q * xr) ** 2 + yr**2), 1e-10, 1e10)
    pref = (2.0 * b) / (1.0 + q) * powp(b / R, t - 1.0)
    ax_r, ay_r = pref * ox, pref * oy
    ax = ax_r * cp - ay_r * sp + g1 * x + g2 * y
    ay = ax_r * sp + ay_r * cp + g2 * x - g1 * y
    lens_light = _sersic_light(x, y, *c[8:15])
    src_light = _sersic_light(x - ax, y - ay, *c[15:22])
    return lens_light + src_light


def fused_render_reference(params, x, y, niter: int):
    """Plain twin of K1: (bs, 22), (P,), (P,) -> (bs, P); differentiable
    by torch autograd (through the EPL series ``autograd.Function``)."""
    ct, st, f, t = _tile_geom(params, x, y)
    ox, oy = omega_cs(ct, st, f, t, niter)
    return _tile_out(params, x, y, ox, oy)


@torch.no_grad()
def fused_render_fwd_reference(params, x, y, niter: int):
    """Plain twin of K2: (out, ox, oy), each (bs, P)."""
    ct, st, f, t = _tile_geom(params, x, y)
    ox, oy = _omega_cs_impl(ct, st, f, t, niter)
    return _tile_out(params, x, y, ox, oy), ox, oy


def _sersic_bwd(g, x, y, R_s, n_s, e1, e2, cx, cy, Ie):
    """VJP of :func:`_sersic_light`: (g_x, g_y, [7 parameter cotangents])."""
    cp, sp = half_angle(e1, e2)
    c = torch.sqrt(e1**2 + e2**2 + 1e-24)
    q = (1.0 - c) / (1.0 + c)
    sq = torch.sqrt(q)
    dx, dy = x - cx, y - cy
    a = cp * dx + sp * dy
    b = -sp * dx + cp * dy
    xt1 = a * sq
    xt2 = b / sq
    R = torch.sqrt(xt1**2 + xt2**2)
    bn = 1.9992 * n_s - 0.3271
    k = 1.0 / n_s
    u = R / R_s
    lu = torch.log(u)
    w = torch.exp(k * lu)
    E = torch.exp(-bn * (w - 1.0))
    g_ie = g * E
    g_s = g * Ie * E  # cotangent of the exponent -bn (w - 1)
    g_w = -g_s * bn
    g_bn = -g_s * (w - 1.0)
    g_kl = g_w * w  # cotangent of k * log(u)
    g_k = g_kl * lu
    g_u = g_kl * k / u
    g_r = g_u / R_s
    g_rs = -g_u * u / R_s
    g_n = 1.9992 * g_bn - g_k * k * k
    g_xt1 = g_r * xt1 / R
    g_xt2 = g_r * xt2 / R
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
    return g_dx, g_dy, [g_rs, g_n, g_e1, g_e2, -g_dx, -g_dy, g_ie]


def fused_render_bwd_reference(params, x, y, ox, oy, ct, niter: int):
    """Plain twin of K3: the hand-derived VJP -> (bs, 22) parameter gradient.

    Written line for line with ``fused_render_bwd`` in
    ``csrc/fused_render.cu``: the VJP of the output map (light, shear,
    prefactor) and the VJP of the series geometry share one tail from the
    ellipse-frame quantities (q, xr, yr, R, cos phi, sin phi) to the
    parameters.
    """
    c = _cols(params)
    te, gam, e1, e2, cx, cy, g1, g2 = c[:8]
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
    p0 = 2.0 * b / (1.0 + q)
    lbr = torch.log(b / R)
    w = torch.exp((t - 1.0) * lbr)
    pref = p0 * w
    axr, ayr = pref * ox, pref * oy
    ax = axr * cp - ayr * sp + g1 * x + g2 * y
    ay = axr * sp + ayr * cp + g2 * x - g1 * y

    # light: lens light at x, source at beta = x - alpha
    _, _, g_ll = _sersic_bwd(ct, x, y, *c[8:15])
    g_bx, g_by, g_src = _sersic_bwd(ct, x - ax, y - ay, *c[15:22])

    # shear and the rotation back from the ellipse frame
    g_ax, g_ay = -g_bx, -g_by
    g_g1 = g_ax * x - g_ay * y
    g_g2 = g_ax * y + g_ay * x
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
    cos_t, sin_t = qx / R, yr / R
    f = (1.0 - q) / (1.0 + q)
    g_c, g_s, g_f, g_tt = _omega_cs_bwd(niter, cos_t, sin_t, f, t, g_ox, g_oy)
    g_t = g_t + g_tt
    g_q = g_q - 2.0 * g_f / ((1.0 + q) * (1.0 + q))
    g_q = g_q + g_c * xr / R
    g_xr = g_c * q / R
    g_yr = g_s / R
    g_R = g_R - (g_c * cos_t + g_s * sin_t) / R

    # shared tail: R -> (q, xr, yr) -> (dx, dy, cos phi, sin phi) -> params
    g_rr = torch.where((rr > 1e-10) & (rr < 1e10), g_R, torch.zeros_like(g_R))
    g_qx = g_rr * qx / rr
    g_yr = g_yr + g_rr * yr / rr
    g_q = g_q + g_qx * xr
    g_xr = g_xr + g_qx * q
    g_te = g_b * sq
    g_q = g_q + g_b * te * 0.5 / sq
    g_dx = g_xr * cp - g_yr * sp
    g_dy = g_xr * sp + g_yr * cp
    g_cp = g_cp + g_xr * dx + g_yr * dy
    g_sp = g_sp + g_xr * dy - g_yr * dx
    g_cc = -2.0 * g_q / ((1.0 + cc) * (1.0 + cc))
    g_m = torch.where(m < 1.0, g_cc, torch.zeros_like(g_cc))
    g_e1, g_e2 = half_angle_bwd(e1, e2, g_cp, g_sp)
    g_e1 = g_e1 + g_m * e1 / m
    g_e2 = g_e2 + g_m * e2 / m

    cols = [g_te, g_t, g_e1, g_e2, -g_dx, -g_dy, g_g1, g_g2, *g_ll, *g_src]
    bs = params.shape[0]
    return torch.stack(
        [torch.broadcast_to(g, ct.shape).sum(dim=-1) for g in cols], dim=-1
    ).reshape(bs, N_PARAMS)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_inputs(params, x, y):
    bs, npix = params.shape[0], x.shape[0]
    dev = params.device
    _build.check_arg(params, "params", (bs, N_PARAMS), dev)
    _build.check_arg(x, "x", (npix,), dev)
    _build.check_arg(y, "y", (npix,), dev)
    if bs > 65535:
        raise ValueError(f"bs={bs} exceeds the kernel grid's y limit (65535)")
    return bs, npix


def fused_render_fwd(params, x, y, niter: int, save_omega: bool = False):
    """K1 (``save_omega=False``: out) or K2 (``True``: out, ox, oy).

    CPU tensors take the plain twin; CUDA tensors launch the kernel.
    """
    if params.device.type == "cpu":
        out, ox, oy = fused_render_fwd_reference(params, x, y, niter)
        return (out, ox, oy) if save_omega else out
    bs, npix = _check_inputs(params, x, y)
    out = torch.empty((bs, npix), dtype=torch.float32, device=params.device)
    ox = oy = out  # unused by K1
    if save_omega:
        ox, oy = torch.empty_like(out), torch.empty_like(out)
    lib, ptr = _build.load(), _build.ptr
    with torch.cuda.device(params.device):
        err = lib.gl_fused_render_fwd(
            ptr(params), ptr(x), ptr(y), ptr(out), ptr(ox), ptr(oy),
            bs, npix, int(niter), int(save_omega), _build.stream(params.device),
        )
    _build.check(err, "fused_render_fwd")
    launches["fused_render_fwd_omega" if save_omega else "fused_render_fwd"] += 1
    return (out, ox, oy) if save_omega else out


def fused_render_bwd(params, x, y, ox, oy, ct, niter: int):
    """K3: (bs, 22) parameter gradient. CPU tensors take the plain twin."""
    if params.device.type == "cpu":
        return fused_render_bwd_reference(params, x, y, ox, oy, ct, niter)
    bs, npix = _check_inputs(params, x, y)
    for t, name in ((ox, "ox"), (oy, "oy"), (ct, "ct")):
        _build.check_arg(t, name, (bs, npix), params.device)
    n_tiles = -(-npix // TILE)
    partial = torch.empty((bs, n_tiles, N_PARAMS), dtype=torch.float32,
                          device=params.device)
    lib, ptr = _build.load(), _build.ptr
    with torch.cuda.device(params.device):
        err = lib.gl_fused_render_bwd(
            ptr(params), ptr(x), ptr(y), ptr(ox), ptr(oy), ptr(ct),
            ptr(partial), bs, npix, int(niter), _build.stream(params.device),
        )
    _build.check(err, "fused_render_bwd")
    launches["fused_render_bwd"] += 1
    # second, deterministic pass over the small (bs, n_tiles, 22) partials
    return partial.sum(dim=1)


class _FusedRender(torch.autograd.Function):
    @staticmethod
    def forward(ctx, params, x, y, niter):
        out, ox, oy = fused_render_fwd(params, x, y, niter, save_omega=True)
        ctx.niter = niter
        ctx.save_for_backward(params, x, y, ox, oy)
        return out

    @staticmethod
    def backward(ctx, ct):
        params, x, y, ox, oy = ctx.saved_tensors
        g = fused_render_bwd(params, x, y, ox, oy, ct.contiguous(), ctx.niter)
        return g, None, None, None


def fused_render(params, x, y, niter: int = 18):
    """Fused flat-light render. params: (bs, 22); x, y: (P,) -> (bs, P).

    Differentiable in ``params``: under autograd the forward saves Omega
    (K2) and the backward is K3; otherwise the residual-free K1 runs.
    """
    if torch.is_grad_enabled() and params.requires_grad:
        return _FusedRender.apply(params, x, y, niter)
    return fused_render_fwd(params, x, y, niter)
