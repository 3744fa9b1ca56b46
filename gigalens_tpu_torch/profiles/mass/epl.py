"""Elliptical power-law (EPL) deflector (port of ``gigalens_tpu.profiles.mass.epl``).

Angular-series solution of Tessore & Metcalf (2015). The deflection in the
ellipse-aligned frame is

    alpha(R, theta) = (2 b)/(1+q) (b/R)^(t-1) * Omega(theta),
    Omega = sum_n a_n,   a_n = [prod_k ratio_k(f, t)] e^{i(2n+1)theta}.

Naive autograd through the series loop stores every iteration's carry —
niter * (bs, npix) * 4 tensors. :class:`_OmegaCS` is an
``autograd.Function`` whose backward exploits the series structure for an
O(1)-memory exact VJP (one fresh loop regenerating a_n on the fly):

    d a_n / d theta = i (2n+1) a_n
    d a_n / d f     = (n / f) a_n
    d a_n / d t     = [sum_k 1/(2k-2+t) + 1/(2k+2-t)] a_n
"""
from __future__ import annotations

import math

import torch

from gigalens_tpu_torch.profiles.base import MassProfile, ellipticity_to_polar, rotate


def _omega_cs_impl(cos_t, sin_t, f, t, niter: int):
    """Raw angular series from (cos theta, sin theta) -> (Re Omega, Im Omega)."""
    cos_2t = cos_t * cos_t - sin_t * sin_t
    sin_2t = 2.0 * cos_t * sin_t
    ax, ay, ox, oy = cos_t, sin_t, cos_t, sin_t
    for n in range(1, niter):
        ratio = -f * (2 * n - (2 - t)) / (2 * n + (2 - t))
        ax, ay = ratio * (cos_2t * ax - sin_2t * ay), ratio * (sin_2t * ax + cos_2t * ay)
        ox, oy = ox + ax, oy + ay
    return ox, oy


def _reduce_to(g, like):
    """Sums a broadcast cotangent back to ``like``'s shape."""
    shape = like.shape
    extra = g.ndim - len(shape)
    if extra:
        g = g.sum(dim=tuple(range(extra)))
    for i, (gs, xs) in enumerate(zip(g.shape, shape)):
        if xs == 1 and gs != 1:
            g = g.sum(dim=i, keepdim=True)
    return g


def _omega_cs_bwd(niter: int, cos_t, sin_t, f, t, ct_x, ct_y):
    """O(1)-memory exact VJP of :func:`_omega_cs_impl` (unreduced shapes).

    a_n is homogeneous of degree 2n+1 in (cos_t, sin_t), so the input
    cotangents decompose into radial and tangential parts:

        g_c = cos_t * g_rho - sin_t * g_th    g_s = sin_t * g_rho + cos_t * g_th
    """
    # f32 rounds f = (1-q)/(1+q) to exactly 0 at zero ellipticity, and the
    # (n / f) partial would then give inf * 0 = NaN; a_n regenerated with
    # f = 1e-20 is ~0 for n >= 1, so g_f comes out 0.
    f = torch.clamp(f, min=1e-20)
    cos_2t = cos_t * cos_t - sin_t * sin_t
    sin_2t = 2.0 * cos_t * sin_t
    ax, ay = cos_t, sin_t
    # s_t (the digamma-like partial sum) depends only on t: keep t's shape
    s_t = torch.zeros_like(t + f)
    g_th = -ct_x * sin_t + ct_y * cos_t
    g_rho = ct_x * cos_t + ct_y * sin_t
    g_f = g_t = 0.0
    for n in range(1, niter):
        ratio = -f * (2 * n - (2 - t)) / (2 * n + (2 - t))
        ax, ay = ratio * (cos_2t * ax - sin_2t * ay), ratio * (sin_2t * ax + cos_2t * ay)
        s_t = s_t + 1.0 / (2 * n - 2 + t) + 1.0 / (2 * n + 2 - t)
        dot = ct_x * ax + ct_y * ay
        g_th = g_th + (2 * n + 1) * (-ct_x * ay + ct_y * ax)
        g_rho = g_rho + (2 * n + 1) * dot
        g_f = g_f + (n / f) * dot
        g_t = g_t + s_t * dot
    g_c = cos_t * g_rho - sin_t * g_th
    g_s = sin_t * g_rho + cos_t * g_th
    return g_c, g_s, g_f, g_t


class _OmegaCS(torch.autograd.Function):
    """Angular series Omega = sum_n a_n with the O(1)-memory backward."""

    @staticmethod
    def forward(ctx, cos_t, sin_t, f, t, niter):
        ctx.niter = niter
        ctx.save_for_backward(cos_t, sin_t, f, t)
        return _omega_cs_impl(cos_t, sin_t, f, t, niter)

    @staticmethod
    def backward(ctx, ct_x, ct_y):
        cos_t, sin_t, f, t = ctx.saved_tensors
        if ct_x is None:
            ct_x = torch.zeros_like(ct_y)
        if ct_y is None:
            ct_y = torch.zeros_like(ct_x)
        g_c, g_s, g_f, g_t = _omega_cs_bwd(ctx.niter, cos_t, sin_t, f, t, ct_x, ct_y)
        return (
            _reduce_to(g_c, cos_t), _reduce_to(g_s, sin_t),
            _reduce_to(g_f, f), _reduce_to(g_t, t), None,
        )


def omega_cs(cos_t, sin_t, f, t, niter: int):
    """(Re Omega, Im Omega) of the EPL angular series, O(1)-memory VJP."""
    return _OmegaCS.apply(cos_t, sin_t, f, t, niter)


class EPL(MassProfile):
    _name = "EPL"
    _params = ["theta_E", "gamma", "e1", "e2", "center_x", "center_y"]

    def __init__(self, niter: int = 18):
        super().__init__()
        self.niter = int(niter)

    @staticmethod
    def recommended_niter(q_min: float, tol: float = 1e-12) -> int:
        """Series depth giving truncation error < tol for axis ratios >= q_min
        (the series converges geometrically with ratio f = (1-q)/(1+q))."""
        f = (1 - q_min) / (1 + q_min)
        if f <= 0:
            return 2
        return int(math.ceil(math.log(tol) / math.log(f))) + 2

    def deriv(self, x, y, theta_E, gamma, e1, e2, center_x, center_y):
        _, q, phi = ellipticity_to_polar(e1, e2, e_max=1.0)
        # theta_E (intermediate-axis convention) -> the scale length b
        b = theta_E * torch.sqrt(2 * q / (1 + q**2)) * torch.sqrt((1 + q**2) / 2)
        t = gamma - 1  # 2D log-slope

        x, y = rotate(x - center_x, y - center_y, phi)
        R = torch.clamp(torch.sqrt((q * x) ** 2 + y**2), 1e-10, 1e10)
        # polar direction algebraically: the series only needs cos/sin
        cos_t, sin_t = q * x / R, y / R

        f = (1 - q) / (1 + q)
        omega_x, omega_y = omega_cs(cos_t, sin_t, f, t, self.niter)

        prefac = (2 * b) / (1 + q) * (b / R) ** (t - 1)
        return rotate(prefac * omega_x, prefac * omega_y, -phi)
