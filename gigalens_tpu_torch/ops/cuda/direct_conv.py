"""PSF convolution with the supersample pool folded in, as a direct strided
sum: the CUDA kernel (K4's direct route) and its plain versions.

Computes the same function as :mod:`gigalens_tpu.ops.pallas.dft_conv` (a
'SAME' convolution with the flipped kernel followed by a p x p mean pool),
by another algorithm. Per sample,

    out[i, j] = sum_{s, t} w[s, t] * x[p*i + s - oy, p*j + t - ox]

with x zero outside the image, ``oy = kh - 1 - kh // 2`` (likewise ``ox``)
and ``w`` the flipped PSF summed over the p x p pool box and divided by
p^2, of size (kh + p - 1, kw + p - 1). Both directions split into p^2
dense stride-1 correlations with ceil((kh + p - 1) / p)-tap sub-kernels of
``w`` (:func:`forward_phases`, :func:`transpose_phases`): the forward sums
them over the p^2 polyphase components x[p*m + b, p*n + b'] of the image,
the transpose (VJP),

    g[m, n] = sum_{i, j} ct[i, j] * w[m + oy - p*i, n + ox - p*j],

writes one to each (m mod p, n mod p) phase of its output. One kernel
(``csrc/direct_conv.cu``) computes both.

:func:`direct_conv_reference` and :func:`direct_conv_transpose_reference`
are the plain versions, written as explicit tap sums; the wrappers take them
for CPU tensors only. :func:`k4_route` is the shape rule that sends a
``PSFConv`` on the card to this kernel or to the DFT chain.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from gigalens_tpu_torch.ops.cuda import _build

# Launch counts per direction; each wrapper adds one where it launches.
launches = {"direct_conv_fwd": 0, "direct_conv_transpose": 0}

# Block shape of the kernel: 16 column lanes x 5 adjacent columns = 80
# output columns; each warp holds 2 row lanes x 5 rows = 10 output rows.
TILE_W, ROWS_PER_WARP, ROWS_PER_THREAD = 80, 10, 5
# Below 4 warps a block the forward loses to the DFT chain (on an H100 at bs
# 500, 160x160: 13.1 ms with 2 warps against the chain's 6.9 at 177 px, 6.1
# with 4 against 6.9 at 175 px; scripts/torch_k4_routes.py).
MAX_WARPS, MIN_WARPS = 8, 4
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on sm_90


def offsets(kh: int, kw: int):
    """(oy, ox): the first image row/column a tap of ``w`` reaches."""
    return kh - 1 - kh // 2, kw - 1 - kw // 2


def pooled_kernel(kernel, pool: int) -> np.ndarray:
    """The flipped kernel summed over the pool box, / pool^2 (float64)."""
    k = np.asarray(kernel, np.float64)[::-1, ::-1]
    kh, kw = k.shape
    w = np.zeros((kh + pool - 1, kw + pool - 1))
    for di in range(pool):
        for dj in range(pool):
            w[di:di + kh, dj:dj + kw] += k
    return w / pool**2


def _take(w, s, t):
    """w[s][:, t] for index vectors s and t, zero past w's edges."""
    ok = (s[:, None] < w.shape[0]) & (t[None, :] < w.shape[1])
    return np.where(ok, w[np.minimum(s, w.shape[0] - 1)][:, np.minimum(t, w.shape[1] - 1)], 0.0)


def forward_phases(w: np.ndarray, pool: int, oy: int, ox: int):
    """The forward's p^2 stride-1 correlations, one per polyphase component
    of the image: sub-kernels (p^2, ku, kv), w[p*u + a, p*v + b] for tap
    phase (a, b), and per-phase (oy, ox, by, bx, ry, rx) = (offsets, the
    component's row/column phase, the output's: 0)."""
    p = pool
    u, v = np.arange(-(-w.shape[0] // p)), np.arange(-(-w.shape[1] // p))
    subs, table = [], []
    for a in range(p):
        al, by = divmod(a - oy, p)  # x row p*(i + u + al) + by
        for b in range(p):
            ac, bx = divmod(b - ox, p)
            subs.append(_take(w, p * u + a, p * v + b))
            table.append((-al, -ac, by, bx, 0, 0))
    return np.stack(subs), np.asarray(table, np.int32)


def transpose_phases(w: np.ndarray, pool: int, oy: int, ox: int):
    """The transpose's p^2 stride-1 correlations of the cotangent, one per
    output phase: sub-kernels (p^2, ku, kv) and per-phase (oy, ox, by, bx,
    ry, rx) = (offsets, the input's row/column phase: 0, the output's)."""
    p = pool
    ku, kv = -(-w.shape[0] // p), -(-w.shape[1] // p)
    subs, table = [], []
    for rm in range(p):
        cq, cr = divmod(rm + oy, p)
        for rn in range(p):
            dq, dr = divmod(rn + ox, p)
            # sub-kernel row u reads tap row p*(ku - 1 - u) + cr (flipped)
            subs.append(_take(w, p * (ku - 1 - np.arange(ku)) + cr,
                              p * (kv - 1 - np.arange(kv)) + dr))
            table.append((ku - 1 - cq, kv - 1 - dq, 0, 0, rm, rn))
    return np.stack(subs), np.asarray(table, np.int32)


def _tap_sum(x, w, stride, oy, ox, oh, ow):
    """sum_{s,t} w[s,t] x[stride*i + s - oy, stride*j + t - ox] -> (n, oh, ow)."""
    n, h, wd = x.shape
    kh, kw = w.shape
    lo_y, lo_x = max(oy, 0), max(ox, 0)
    hi_y = max(stride * (oh - 1) + kh - 1 - oy - (h - 1), 0)
    hi_x = max(stride * (ow - 1) + kw - 1 - ox - (wd - 1), 0)
    xp = F.pad(x, (lo_x, hi_x, lo_y, hi_y))
    by, bx = lo_y - oy, lo_x - ox
    out = torch.zeros((n, oh, ow), dtype=x.dtype, device=x.device)
    for s in range(kh):
        for t in range(kw):
            r0, c0 = by + s, bx + t
            out += w[s, t] * xp[:, r0:r0 + stride * (oh - 1) + 1:stride,
                                c0:c0 + stride * (ow - 1) + 1:stride]
    return out


def direct_conv_reference(x, w, pool: int, oy: int, ox: int):
    """Plain forward: (n, H, W) -> (n, H/p, W/p), explicit tap sums."""
    return _tap_sum(x, w, pool, oy, ox, x.shape[1] // pool, x.shape[2] // pool)


def direct_conv_transpose_reference(ct, w, pool: int, oy: int, ox: int, h: int, wd: int):
    """Plain transpose: (n, H/p, W/p) -> (n, H, W), each tap's product
    scattered back to the input positions it read (the adjoint)."""
    n, oh, ow = ct.shape
    kh, kw = w.shape
    p = pool
    hi_y = max(p * (oh - 1) + kh - 1 - oy - (h - 1), 0)
    hi_x = max(p * (ow - 1) + kw - 1 - ox - (wd - 1), 0)
    g = torch.zeros((n, oy + h + hi_y, ox + wd + hi_x), dtype=ct.dtype, device=ct.device)
    for s in range(kh):
        for t in range(kw):
            g[:, s:s + p * (oh - 1) + 1:p, t:t + p * (ow - 1) + 1:p] += w[s, t] * ct
    return g[:, oy:oy + h, ox:ox + wd]


def by_phases_reference(x, subs, table, n_in: int, gather: int, out_stride: int,
                        oh: int, ow: int):
    """Either direction as the kernel computes it: for each output phase,
    the stride-1 tap sums over its ``n_in`` input phases (components of x
    taken every ``gather``-th row and column), written every
    ``out_stride``-th row and column of the output."""
    n = x.shape[0]
    out = torch.empty((n, oh * out_stride, ow * out_stride), dtype=x.dtype, device=x.device)
    rows = table.tolist()
    for ph in range(len(rows) // n_in):
        acc = 0
        for q in range(ph * n_in, (ph + 1) * n_in):
            oy, ox, by, bx, ry, rx = rows[q]
            acc = acc + _tap_sum(x[:, by::gather, bx::gather], subs[q], 1, oy, ox, oh, ow)
        out[:, ry::out_stride, rx::out_stride] = acc
    return out


def _pitch(width: int) -> int:
    """Shared-memory row pitch >= width at which a warp's two row lanes
    (ROWS_PER_THREAD rows apart) hit disjoint banks: each half warp's 16
    lanes, 5 words apart, take 16 banks, and an offset of 16 banks takes
    the other 16."""
    ldp = width
    while (ROWS_PER_THREAD * ldp) % 32 != 16:
        ldp += 1
    return ldp


def _sub_shape(kh, kw, pool):
    return -(-(kh + pool - 1) // pool), -(-(kw + pool - 1) // pool)


def plan(ku: int, kv: int, n_in: int, oh: int):
    """Launch plan of one direction (``ku x kv`` sub-kernels, ``n_in`` input
    phases, ``oh`` output rows per phase): warps per block, halo rows and
    width, row pitch and dynamic shared memory (bytes), or None when not
    even a block of MIN_WARPS warps fits in shared memory."""
    kvp = -(-kv // 4) * 4
    nw = MIN_WARPS
    while nw < MAX_WARPS and nw * ROWS_PER_WARP < oh:
        nw *= 2
    while nw >= MIN_WARPS:
        hh = nw * ROWS_PER_WARP - 1 + ku
        pw = TILE_W - 1 + kvp
        ldp = _pitch(pw)
        smem = 4 * (n_in * (ku + 2 * (ROWS_PER_THREAD - 1)) * kvp + hh * ldp)
        if smem <= SMEM_LIMIT:
            return dict(warps=nw, hh=hh, pw=pw, ldp=ldp, smem=smem)
        nw //= 2
    return None


def k4_route(kh, kw, pool) -> str:
    """"direct" when both directions of the direct kernel fit a block of
    MIN_WARPS warps in shared memory (PSFs up to 175 px at pool 2), else
    "chain" (the DFT chain). A pure shape rule: nothing is tried at run
    time. The image size does not enter: a short image only lowers the
    warps per block, and the smallest block is always tried."""
    ku, kv = _sub_shape(kh, kw, pool)
    fits = plan(ku, kv, pool * pool, 1) is not None and plan(ku, kv, 1, 1) is not None
    return "direct" if fits else "chain"


def direct_conv_cuda(x, conv: "DirectConv", direction: str):
    """Launches the kernel on x: (bs, H, W) forward or (bs, H/p, W/p)
    transpose, with the weights and phase table ``conv`` holds."""
    pp = conv.pool * conv.pool
    bs = x.shape[0]
    if direction == "fwd":
        in_shape, out_shape = (conv.h, conv.w), (conv.out_h, conv.out_w)
        w, table = conv.w_fwd, conv.table_fwd
    else:
        in_shape, out_shape = (conv.out_h, conv.out_w), (conv.h, conv.w)
        w, table = conv.w_t, conv.table_t
    pl = conv.plans[direction]
    _build.check_arg(x, "x", (bs, *in_shape), x.device)
    _build.check_arg(w, "w", tuple(w.shape), x.device)
    _build.check_arg(table, "phase table", (pp, 6), x.device, dtype=torch.int32)
    if bs > 65535:
        raise ValueError(f"bs={bs} exceeds the kernel grid's z limit (65535)")
    out = torch.empty((bs, *out_shape), dtype=torch.float32, device=x.device)
    lib, ptr = _build.load(), _build.ptr
    fn = lib.gl_direct_conv_fwd if direction == "fwd" else lib.gl_direct_conv_transpose
    with torch.cuda.device(x.device):
        err = fn(ptr(x), ptr(out), ptr(w), ptr(table), bs, conv.h, conv.w, conv.pool,
                 *w.shape[1:], pl["warps"], pl["hh"], pl["pw"], pl["ldp"], pl["smem"],
                 _build.stream(x.device))
    _build.check(err, f"direct_conv ({direction})")
    launches[f"direct_conv_{direction}"] += 1
    return out


class _DirectConvFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, conv):
        ctx.conv = conv
        if x.device.type == "cpu":
            return direct_conv_reference(x, conv.w_ref, conv.pool, conv.oy, conv.ox)
        return direct_conv_cuda(x.contiguous(), conv, "fwd")

    @staticmethod
    def backward(ctx, ct):
        c = ctx.conv
        if ct.device.type == "cpu":
            return direct_conv_transpose_reference(ct, c.w_ref, c.pool, c.oy, c.ox,
                                                   c.h, c.w), None
        return direct_conv_cuda(ct.contiguous(), c, "transpose"), None


class DirectConv:
    """(bs, H, W) -> (bs, H/p, W/p): 'SAME' convolution with ``kernel`` and
    a p x p mean pool, as the direct strided sum. ``pool`` must divide the
    image. Differentiable: the backward is the transpose kernel (the map is
    linear, so nothing is saved). Weights are built once in float64 and
    kept as float32 on ``device``."""

    def __init__(self, kernel, img_shape, pool: int, device):
        kernel = np.asarray(kernel)
        kh, kw = kernel.shape
        self.h, self.w = int(img_shape[0]), int(img_shape[1])
        self.pool = p = int(pool)
        if self.h % p or self.w % p:
            raise ValueError("pool must divide the image shape")
        self.out_h, self.out_w = self.h // p, self.w // p
        self.oy, self.ox = offsets(kh, kw)
        w64 = pooled_kernel(kernel, p)
        device = torch.device(device)

        def f32(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)

        self.w_ref = f32(w64)  # (kh + p - 1, kw + p - 1): the plain versions' weights
        # the kernel's sub-kernels (p^2, ku, kv) and phase tables (p^2, 6)
        subs, table = forward_phases(w64, p, self.oy, self.ox)
        self.w_fwd, self.table_fwd = f32(subs), torch.as_tensor(table, device=device)
        subs, table = transpose_phases(w64, p, self.oy, self.ox)
        self.w_t, self.table_t = f32(subs), torch.as_tensor(table, device=device)
        ku, kv = subs.shape[1:]
        self.plans = dict(fwd=plan(ku, kv, p * p, self.out_h), transpose=plan(ku, kv, 1, self.out_h))
        if device.type == "cuda" and None in self.plans.values():
            raise ValueError(f"a {kh}x{kw} PSF at pool {p} does not fit the direct "
                             "kernel's shared memory; use the chain (k4_route)")

    def __call__(self, x):
        return _DirectConvFn.apply(x, self)
