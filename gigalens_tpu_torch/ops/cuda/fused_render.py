"""Fused EPL+Shear ray-shoot + two-Sersic render: CUDA kernels and their twins.

Port of :mod:`gigalens_tpu.ops.pallas.fused_render`. For each (sample,
pixel) it computes

    beta = x - alpha_EPL(x; lens params) - alpha_shear(x)
    out  = SersicEllipse(x; lens-light params) + SersicEllipse(beta; source)

writing only the final surface brightness. Three kernels
(``csrc/fused_render.cu``), each in two stages: a per-sample prologue, once
per block, computes what depends on the sample alone (the rotations, axis
ratios, b, 1/n, 1/R_s, and a table of the series' per-term constants), and
a pixel stage keeps pixel-dependent arithmetic only.

* K1 ``fused_render_fwd<false>``: the forward only (no residuals);
* K2 ``fused_render_fwd<true>``: the forward, also writing the EPL angular
  series Omega = (ox, oy) as the backward's residuals. A block walks
  :func:`fwd_tiles` 256-pixel tiles of its sample;
* K3 ``fused_render_bwd``: the (bs, 22) parameter gradient from Omega and
  the output cotangent, with no forward series loop: the hand-derived VJP
  of the closed-form output map, one O(1)-memory series backward loop, and
  the VJP of the geometry. The pixel stage reduces the cotangents of N_SUMS
  per-sample quantities into (bs, n_chunks, N_SUMS) partials; an epilogue
  kernel sums them in a fixed order and maps them, once per sample, to the
  22 gradients (the map is linear).

Beside them, the plain PyTorch twins, line for line with the CUDA device
code (``csrc/lens_math.cuh``): :func:`fused_render_fwd_reference`
(:func:`sample_consts`, then :func:`fwd_pixel`) and
:func:`fused_render_bwd_reference` (:func:`bwd_pixel_terms`, then
:func:`bwd_epilogue`); forward and backward share the pixel functions, as
the kernels do. :func:`fused_render_reference` is the one-stage forward
chain, differentiable by torch autograd (through the EPL series
``autograd.Function``), and :func:`fused_render_fwd_onestage` its K2 form:
the independent oracles of the tests. The wrappers take the twins for CPU
tensors only; for CUDA tensors they launch the kernels or raise.

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
from gigalens_tpu_torch.profiles.mass.epl import _omega_cs_impl, omega_cs

N_PARAMS = 22
TILE = 256  # pixels per block of the CUDA kernels (one thread each)
TILES_PER_BLOCK = 4  # pixel tiles one K3 block walks
FWD_TILES_MAX = 8  # pixel tiles a K1/K2 block walks at most
SMS = 132  # streaming multiprocessors of an H100 SXM
MIN_BLOCKS_PER_SM = 8  # below this a K1/K2 block walks fewer tiles

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
# The one-stage form: every pixel redoes the sample's constants
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
    """The render in its one-stage form: (bs, 22), (P,), (P,) -> (bs, P);
    differentiable by torch autograd (through the EPL series
    ``autograd.Function``). The oracle of K1-K3's checks."""
    ct, st, f, t = _tile_geom(params, x, y)
    ox, oy = omega_cs(ct, st, f, t, niter)
    return _tile_out(params, x, y, ox, oy)


@torch.no_grad()
def fused_render_fwd_onestage(params, x, y, niter: int):
    """(out, ox, oy), each (bs, P), in the one-stage form (every pixel redoes
    the sample's constants): the independent oracle the two-stage twin is
    held against, and the function whose operations make K1/K2's bound. No
    runtime path calls it."""
    ct, st, f, t = _tile_geom(params, x, y)
    ox, oy = _omega_cs_impl(ct, st, f, t, niter)
    return _tile_out(params, x, y, ox, oy), ox, oy


def _sersic_bwd(g, x, y, R_s, n_s, e1, e2, cx, cy, Ie):
    """VJP of :func:`_sersic_light` in the one-stage form (the composable
    render's one-stage oracle uses it): (g_x, g_y, [7 parameter cotangents])."""
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


# ---------------------------------------------------------------------------
# The two-stage form of K1-K3 (and of the composable render's EPL and Sersic
# stages), line for line with csrc/lens_math.cuh: per-sample constants and a
# series table, then pixel stages that hold pixel-dependent arithmetic only,
# then (backward) a per-sample epilogue.
#
# K3's pixel stage reduces, per sample, the cotangents of N_SUMS per-sample
# quantities (columns of the sums):
#   0-6   EPL: b, t, q, cos phi, sin phi, dx, dy (dx = x - center_x, ...)
#   7-8   shear: gamma1, gamma2
#   9-16  lens light Sersic: R_sersic, n_sersic, Ie, cos phi, sin phi, q, dx, dy
#   17-24 source Sersic: the same
# and the epilogue maps those sums, once per sample, to the 22 parameter
# gradients (the map is linear in them: the half-angle VJP, the axis-ratio
# chains, theta_E = b / sqrt(q), the center signs).
# ---------------------------------------------------------------------------
N_SUMS = 25
EPL_SUMS, SERSIC_SUMS = 7, 8
MAX_NITER = 64  # rows of the kernels' per-sample series table


def _epl_q(e1, e2):
    m = torch.sqrt(e1**2 + e2**2 + 1e-24)
    cc = torch.clamp(m, max=1.0)
    return m, cc, (1.0 - cc) / (1.0 + cc)


def epl_consts(te, gam, e1, e2, cx, cy):
    """Per-sample constants of the EPL pixel stages, each (bs, 1)."""
    cp, sp = half_angle(e1, e2)
    _, _, q = _epl_q(e1, e2)
    b = te * torch.sqrt(q)
    i1q2 = 1.0 / ((1.0 + q) * (1.0 + q))
    return dict(cp=cp, sp=sp, q=q, b=b, t=gam - 1.0, p0=2.0 * b / (1.0 + q), ib=1.0 / b,
                two_i1q=2.0 / (1.0 + q), c_qb=2.0 * b * i1q2, c_qf=-2.0 * i1q2, cx=cx, cy=cy)


def series_table(gam, e1, e2, niter: int):
    """(ratio, n / f, s_t, 2n + 1) for n = 1 .. niter - 1, each (bs, niter - 1):
    the terms of the series that depend on the sample alone. The forward
    reads only ``ratio``, the same expression as the one-stage form's."""
    _, _, q = _epl_q(e1, e2)
    f = torch.clamp((1.0 - q) / (1.0 + q), min=1e-20)
    t = gam - 1.0
    n = torch.arange(1, niter, dtype=gam.dtype, device=gam.device)
    ratio = -f * (2.0 * n - (2.0 - t)) / (2.0 * n + (2.0 - t))
    s_t = torch.cumsum(1.0 / (2.0 * n - 2.0 + t) + 1.0 / (2.0 * n + 2.0 - t), dim=-1)
    return ratio, n / f, s_t, torch.broadcast_to(2.0 * n + 1.0, ratio.shape)


def epl_pixel(e, x, y):
    """What the EPL needs of each pixel, forward and backward alike.
    (cos_t, sin_t) are quotients, as the one-stage form has them (the series
    then keeps its bits); everything else takes the one reciprocal."""
    dx, dy = x - e["cx"], y - e["cy"]
    xr = dx * e["cp"] + dy * e["sp"]
    yr = -dx * e["sp"] + dy * e["cp"]
    qx = e["q"] * xr
    rr = torch.sqrt(qx * qx + yr * yr)
    R = torch.clamp(rr, 1e-10, 1e10)
    iR = 1.0 / R
    lbr = torch.log(e["b"] * iR)
    w = torch.exp((e["t"] - 1.0) * lbr)
    return dict(dx=dx, dy=dy, xr=xr, yr=yr, qx=qx, rr=rr, iR=iR, cos_t=qx / R, sin_t=yr / R,
                lbr=lbr, w=w, pref=e["p0"] * w)


def series_fwd(cos_t, sin_t, ratio, niter: int):
    """Omega = sum_n a_n, one complex multiply-add a term on the table."""
    cos_2t = cos_t * cos_t - sin_t * sin_t
    sin_2t = 2.0 * cos_t * sin_t
    a_x, a_y, ox, oy = cos_t, sin_t, cos_t, sin_t
    for n in range(niter - 1):
        r_n = ratio[:, n:n + 1]
        a_x, a_y = r_n * (cos_2t * a_x - sin_2t * a_y), r_n * (sin_2t * a_x + cos_2t * a_y)
        ox, oy = ox + a_x, oy + a_y
    return ox, oy


def epl_deflect(e, g, ox, oy):
    """The EPL deflection (ax, ay) of each pixel from its series (ox, oy)."""
    axr, ayr = g["pref"] * ox, g["pref"] * oy
    return axr * e["cp"] - ayr * e["sp"], axr * e["sp"] + ayr * e["cp"]


def epl_bwd_pixel(e, g, ox, oy, g_ax, g_ay, table, niter: int):
    """Backward pixel stage of the EPL for the cotangent (g_ax, g_ay) on its
    deflection: its EPL_SUMS cotangent terms. The series backward runs on
    the per-sample table."""
    ratio, nf, s_t, c2n1 = table
    iR, cos_t, sin_t = g["iR"], g["cos_t"], g["sin_t"]
    axr, ayr = g["pref"] * ox, g["pref"] * oy
    # the rotation back from the ellipse frame
    g_axr = g_ax * e["cp"] + g_ay * e["sp"]
    g_ayr = -g_ax * e["sp"] + g_ay * e["cp"]
    g_cp = g_ax * axr + g_ay * ayr
    g_sp = -g_ax * ayr + g_ay * axr
    # prefactor (2 b / (1 + q)) (b / R)^(t - 1)
    g_pref = g_axr * ox + g_ayr * oy
    g_ox, g_oy = g_axr * g["pref"], g_ayr * g["pref"]
    g_arg = g_pref * g["pref"]  # cotangent of (t - 1) log(b / R)
    g_t = g_arg * g["lbr"]
    g_lbr = g_arg * (e["t"] - 1.0)
    g_b = g_lbr * e["ib"] + g_pref * g["w"] * e["two_i1q"]
    g_R = -g_lbr * iR
    g_q = -g_pref * g["w"] * e["c_qb"]

    # series backward from the per-sample table: Omega cotangents ->
    # (cos_t, sin_t, f, t) cotangents
    cos_2t = cos_t * cos_t - sin_t * sin_t
    sin_2t = 2.0 * cos_t * sin_t
    a_x, a_y = cos_t, sin_t
    g_th = -g_ox * sin_t + g_oy * cos_t
    g_rho = g_ox * cos_t + g_oy * sin_t
    g_f = g_tt = 0.0
    for n in range(niter - 1):
        r_n = ratio[:, n:n + 1]
        a_x, a_y = r_n * (cos_2t * a_x - sin_2t * a_y), r_n * (sin_2t * a_x + cos_2t * a_y)
        dot = g_ox * a_x + g_oy * a_y
        g_th = g_th + c2n1[:, n:n + 1] * (-g_ox * a_y + g_oy * a_x)
        g_rho = g_rho + c2n1[:, n:n + 1] * dot
        g_f = g_f + nf[:, n:n + 1] * dot
        g_tt = g_tt + s_t[:, n:n + 1] * dot
    g_c = cos_t * g_rho - sin_t * g_th
    g_s = sin_t * g_rho + cos_t * g_th
    g_t = g_t + g_tt
    g_q = g_q + g_f * e["c_qf"]
    g_q = g_q + g_c * g["xr"] * iR
    g_xr = g_c * e["q"] * iR
    g_yr = g_s * iR
    g_R = g_R - (g_c * cos_t + g_s * sin_t) * iR

    # R -> (q, xr, yr) -> (dx, dy, cos phi, sin phi); R = rr where it is not clipped
    rr = g["rr"]
    g_rr = torch.where((rr > 1e-10) & (rr < 1e10), g_R, torch.zeros_like(g_R))
    g_qx = g_rr * g["qx"] * iR
    g_yr = g_yr + g_rr * g["yr"] * iR
    g_q = g_q + g_qx * g["xr"]
    g_xr = g_xr + g_qx * e["q"]
    dx, dy = g["dx"], g["dy"]
    return [g_b, g_t, g_q, g_cp + g_xr * dx + g_yr * dy, g_sp + g_xr * dy - g_yr * dx,
            g_xr * e["cp"] - g_yr * e["sp"], g_xr * e["sp"] + g_yr * e["cp"]]


def epl_epilogue(te, e1, e2, g):
    """The EPL's EPL_SUMS sums (a list of (bs, 1)) -> the gradients of
    (theta_E, gamma, e1, e2, center_x, center_y). Linear in the sums."""
    m, cc, q = _epl_q(e1, e2)
    sq = torch.sqrt(q)
    g_q = g[2] + g[0] * te * 0.5 / sq
    g_cc = -2.0 * g_q / ((1.0 + cc) * (1.0 + cc))
    g_m = torch.where(m < 1.0, g_cc, torch.zeros_like(g_cc))
    g_e1, g_e2 = half_angle_bwd(e1, e2, g[3], g[4])
    return [g[0] * sq, g[1], g_e1 + g_m * e1 / m, g_e2 + g_m * e2 / m, -g[5], -g[6]]


def sersic_consts(R_s, n_s, e1, e2, cx, cy, Ie):
    """Per-sample constants of the Sersic pixel stages, each (bs, 1)."""
    cp, sp = half_angle(e1, e2)
    # epsilon inside the sqrt: finite gradient at exactly zero ellipticity
    c = torch.sqrt(e1**2 + e2**2 + 1e-24)
    q = (1.0 - c) / (1.0 + c)
    sq = torch.sqrt(q)
    isq = 1.0 / sq
    k = 1.0 / n_s
    return dict(cp=cp, sp=sp, sq=sq, isq=isq, half_isq=0.5 * isq, bn=1.9992 * n_s - 0.3271,
                k=k, kk=k * k, kRs=k * R_s, iRs=1.0 / R_s, Ie=Ie, cx=cx, cy=cy)


def sersic_fwd_pixel(x, y, k):
    """What a Sersic needs of each pixel; its surface brightness is Ie * E."""
    dx, dy = x - k["cx"], y - k["cy"]
    a = k["cp"] * dx + k["sp"] * dy
    bb = -k["sp"] * dx + k["cp"] * dy
    xt1, xt2 = a * k["sq"], bb * k["isq"]
    R = torch.sqrt(xt1 * xt1 + xt2 * xt2)
    u = R * k["iRs"]
    lu = torch.log(u)
    w = torch.exp(k["k"] * lu)
    return dict(dx=dx, dy=dy, a=a, xt1=xt1, xt2=xt2, R=R, u=u, lu=lu, w=w,
                E=torch.exp(-k["bn"] * (w - 1.0)))


def sersic_bwd_pixel(g, x, y, k):
    """Backward pixel stage of one Sersic for the cotangent g on its
    surface brightness: (g_x, g_y, its SERSIC_SUMS cotangent terms)."""
    s = sersic_fwd_pixel(x, y, k)
    iR = 1.0 / s["R"]
    g_s = g * k["Ie"] * s["E"]  # cotangent of the exponent -bn (w - 1)
    g_w = -g_s * k["bn"]
    g_bn = -g_s * (s["w"] - 1.0)
    g_kl = g_w * s["w"]  # cotangent of k * log(u)
    g_k = g_kl * s["lu"]
    g_u = g_kl * k["kRs"] * iR  # k / u = k R_s / R
    g_r = g_u * k["iRs"]
    g_xt1, g_xt2 = g_r * s["xt1"] * iR, g_r * s["xt2"] * iR
    g_a, g_b = g_xt1 * k["sq"], g_xt2 * k["isq"]
    g_x = g_a * k["cp"] - g_b * k["sp"]
    g_y = g_a * k["sp"] + g_b * k["cp"]
    dx, dy = s["dx"], s["dy"]
    terms = [-g_u * s["u"] * k["iRs"], 1.9992 * g_bn - g_k * k["kk"], g * s["E"],
             g_a * dx + g_b * dy, g_a * dy - g_b * dx,
             (g_xt1 * s["a"] - g_xt2 * s["xt2"] * k["isq"]) * k["half_isq"], g_x, g_y]
    return g_x, g_y, terms


def sersic_epilogue(e1, e2, g):
    """A Sersic's SERSIC_SUMS sums (a list of (bs, 1)) -> the gradients of
    (R_sersic, n_sersic, e1, e2, center_x, center_y, Ie)."""
    c = torch.sqrt(e1**2 + e2**2 + 1e-24)
    g_c = -2.0 * g[5] / ((1.0 + c) * (1.0 + c))
    h1, h2 = half_angle_bwd(e1, e2, g[3], g[4])
    return [g[0], g[1], h1 + g_c * e1 / c, h2 + g_c * e2 / c, -g[6], -g[7], g[2]]


def sample_consts(params, niter: int):
    """The prologue of K1-K3: (EPL constants, lens-light and source Sersic
    constants, series table), everything that depends on the sample alone."""
    c = _cols(params)
    return (epl_consts(*c[:6]), sersic_consts(*c[8:15]), sersic_consts(*c[15:22]),
            series_table(c[1], c[2], c[3], niter))


def fwd_pixel(consts, params, x, y, niter: int):
    """K1/K2's pixel stage: (out, ox, oy), each (bs, P), line for line with
    ``fused_render_fwd`` in ``csrc/fused_render.cu``."""
    e, ll, src, table = consts
    g1, g2 = params[:, 6:7], params[:, 7:8]
    g = epl_pixel(e, x, y)
    ox, oy = series_fwd(g["cos_t"], g["sin_t"], table[0], niter)
    ax, ay = epl_deflect(e, g, ox, oy)
    ax = ax + g1 * x + g2 * y
    ay = ay + g2 * x - g1 * y
    # lens light at x, source at beta = x - alpha
    out = (ll["Ie"] * sersic_fwd_pixel(x, y, ll)["E"]
           + src["Ie"] * sersic_fwd_pixel(x - ax, y - ay, src)["E"])
    return out, ox, oy


@torch.no_grad()
def fused_render_fwd_reference(params, x, y, niter: int):
    """Plain twin of K1/K2 in their two stages (:func:`sample_consts`, then
    :func:`fwd_pixel`): (out, ox, oy), each (bs, P)."""
    return fwd_pixel(sample_consts(params, niter), params, x, y, niter)


def bwd_pixel_terms(params, x, y, ox, oy, ct, niter: int):
    """K3's pixel stage: the N_SUMS cotangent terms, each (bs, P), whose
    sums over the pixels :func:`bwd_epilogue` takes. Written line for line
    with ``fused_render_bwd`` in ``csrc/fused_render.cu``: every quantity of
    the sample alone (rotations, axis ratios, the series ratios and partial
    sums) comes from the per-sample constants."""
    e, ll, src, table = sample_consts(params, niter)
    g1, g2 = params[:, 6:7], params[:, 7:8]
    g = epl_pixel(e, x, y)
    ax, ay = epl_deflect(e, g, ox, oy)
    ax = ax + g1 * x + g2 * y
    ay = ay + g2 * x - g1 * y

    # light: lens light at x, source at beta = x - alpha
    _, _, t_ll = sersic_bwd_pixel(ct, x, y, ll)
    g_bx, g_by, t_src = sersic_bwd_pixel(ct, x - ax, y - ay, src)

    # shear, then the EPL
    g_ax, g_ay = -g_bx, -g_by
    g_g1 = g_ax * x - g_ay * y
    g_g2 = g_ax * y + g_ay * x
    t_epl = epl_bwd_pixel(e, g, ox, oy, g_ax, g_ay, table, niter)
    return t_epl + [g_g1, g_g2] + t_ll + t_src


def bwd_epilogue(params, sums):
    """K3's epilogue: (bs, N_SUMS) sums of the pixel terms -> (bs, 22)."""
    c = _cols(params)
    g = [sums[:, k:k + 1] for k in range(N_SUMS)]
    out = epl_epilogue(c[0], c[2], c[3], g[:7]) + [g[7], g[8]]
    out += sersic_epilogue(c[10], c[11], g[9:17])
    out += sersic_epilogue(c[17], c[18], g[17:25])
    return torch.cat(out, dim=-1)


def fused_render_bwd_reference(params, x, y, ox, oy, ct, niter: int):
    """Plain twin of K3: the hand-derived VJP -> (bs, 22) parameter gradient,
    in K3's two stages (:func:`bwd_pixel_terms`, then :func:`bwd_epilogue`
    on their sums over the pixels)."""
    terms = bwd_pixel_terms(params, x, y, ox, oy, ct, niter)
    sums = torch.stack([torch.broadcast_to(t, ct.shape).sum(dim=-1) for t in terms], dim=-1)
    return bwd_epilogue(params, sums)


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


def _check_niter(niter):
    if not 1 <= niter <= MAX_NITER:
        raise ValueError(f"niter={niter} is outside the kernels' series table (1..{MAX_NITER})")


def fwd_tiles(bs: int, npix: int) -> int:
    """Pixel tiles a K1/K2 block walks: FWD_TILES_MAX where that leaves every
    SM at least MIN_BLOCKS_PER_SM blocks (two rounds of the four a SM holds),
    else fewer, down to one: more tiles amortise the per-sample prologue,
    too few blocks leave SMs idle at the tail (scripts/torch_k2_tiles.py)."""
    n_tiles = bs * -(-npix // TILE)
    tiles = FWD_TILES_MAX
    while tiles > 1 and n_tiles // tiles < MIN_BLOCKS_PER_SM * SMS:
        tiles //= 2
    return tiles


def fused_render_fwd(params, x, y, niter: int, save_omega: bool = False):
    """K1 (``save_omega=False``: out) or K2 (``True``: out, ox, oy).

    CPU tensors take the plain twin; CUDA tensors launch the kernel.
    """
    if params.device.type == "cpu":
        out, ox, oy = fused_render_fwd_reference(params, x, y, niter)
        return (out, ox, oy) if save_omega else out
    _check_niter(niter)
    bs, npix = _check_inputs(params, x, y)
    out = torch.empty((bs, npix), dtype=torch.float32, device=params.device)
    ox = oy = out  # unused by K1
    if save_omega:
        ox, oy = torch.empty_like(out), torch.empty_like(out)
    lib, ptr = _build.load(), _build.ptr
    with torch.cuda.device(params.device):
        err = lib.gl_fused_render_fwd(
            ptr(params), ptr(x), ptr(y), ptr(out), ptr(ox), ptr(oy),
            bs, npix, int(niter), int(save_omega), fwd_tiles(bs, npix),
            _build.stream(params.device),
        )
    _build.check(err, "fused_render_fwd")
    launches["fused_render_fwd_omega" if save_omega else "fused_render_fwd"] += 1
    return (out, ox, oy) if save_omega else out


def fused_render_bwd(params, x, y, ox, oy, ct, niter: int):
    """K3: (bs, 22) parameter gradient. CPU tensors take the plain twin."""
    if params.device.type == "cpu":
        return fused_render_bwd_reference(params, x, y, ox, oy, ct, niter)
    _check_niter(niter)
    bs, npix = _check_inputs(params, x, y)
    for t, name in ((ox, "ox"), (oy, "oy"), (ct, "ct")):
        _build.check_arg(t, name, (bs, npix), params.device)
    n_chunks = -(-npix // (TILE * TILES_PER_BLOCK))
    partial = torch.empty((bs, n_chunks, N_SUMS), dtype=torch.float32, device=params.device)
    grad = torch.empty((bs, N_PARAMS), dtype=torch.float32, device=params.device)
    lib, ptr = _build.load(), _build.ptr
    with torch.cuda.device(params.device):
        err = lib.gl_fused_render_bwd(
            ptr(params), ptr(x), ptr(y), ptr(ox), ptr(oy), ptr(ct), ptr(partial),
            ptr(grad), bs, npix, int(niter), _build.stream(params.device),
        )
    _build.check(err, "fused_render_bwd")
    launches["fused_render_bwd"] += 1
    return grad


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
