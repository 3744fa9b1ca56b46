"""PSF convolution as DFT-by-matmul: the CUDA kernel (K4's chain route) and
its twin.

Port of :mod:`gigalens_tpu.ops.pallas.dft_conv`. Per sample,

    out = Re[ Ih @ ((Fh @ x @ FwT) * K) @ IwT ]

with the factor matrices that :func:`gigalens_tpu_torch.ops.psf.dft_factors`
builds (rectangular forward slices; 'SAME' crop and supersample average
pool folded into the inverse factors). The transpose (VJP) of this
real-linear map has the identical structure on the transposed factor set,

    bwd(ct) = Re[ Fh^T @ ((Ih^T @ ct @ IwT^T) * K) @ FwT^T ],

so one kernel (``csrc/dft_conv.cu``, a batched real-pair SGEMM launched
once per stage) serves both directions.

What bounds it on the card is FP32 arithmetic, so the chain runs on half
of the spectrum: ``dft_factors(half=True)`` keeps the spectral columns
0 .. fw // 2 with the conjugate half's weight on K (both directions are
real maps of real arrays, so the other columns repeat these), which halves
the multiply-adds, and :class:`DFTConv` zero-pads the spectral axes to a
multiple of four so every row the kernel copies is 16-byte aligned.
:func:`dft_conv_reference` is the plain twin, the same four products in
the kernel's order on the same factors, taken for CPU tensors only; on
the full factor set it is the JAX package's ``PSFConv._dft_conv``.

Numerics are full float32 on the card (no TF32): stricter than the TPU
kernel's default single bf16 pass, so the JAX package's separate
``dft_hi`` mode has no counterpart here.
"""
from __future__ import annotations

import numpy as np
import torch

from gigalens_tpu_torch.ops.cuda import _build

# Launch counts of the kernel chain per direction; each wrapper adds one
# where it launches and nowhere else.
launches = {"dft_conv_fwd": 0, "dft_conv_transpose": 0}

# The kernel's tiles (csrc/dft_conv.cu): 64 columns, and 80 or 64 rows,
# whichever pads a product's rows less
TILE_COLS, TILE_ROWS = 64, (80, 64)


def chain_macs(h, w, kh, kw, pool, transpose=False, tiles=False):
    """Multiply-adds a sample of the half-spectrum chain on (h, w) images
    with a (kh, kw) PSF: its four products over fw // 2 + 1 spectral columns
    (a complex x complex product counts 4, a real x complex one and the last
    stage's real part 2). ``tiles`` counts what the kernel executes instead:
    the spectral axes padded to a multiple of four, each product's rows to
    its row tile and its columns to the column tile."""
    from gigalens_tpu_torch.ops.psf import _good_fft_size  # psf imports this module

    fh, hw = _good_fft_size(h + kh - 1), _good_fft_size(w + kw - 1) // 2 + 1
    rows, cols, out_rows, out_cols = h, w, h // pool, w // pool
    if transpose:
        rows, cols, out_rows, out_cols = out_rows, out_cols, rows, cols

    def r(m):  # rows of a product as launched
        return min(-(-m // t) * t for t in TILE_ROWS) if tiles else m

    def c(n):  # its columns
        return -(-n // TILE_COLS) * TILE_COLS if tiles else n

    if tiles:
        fh, hw = -(-fh // 4) * 4, -(-hw // 4) * 4
    return (2 * r(rows) * c(hw) * cols + 4 * r(fh) * c(hw) * rows
            + 4 * r(out_rows) * c(hw) * fh + 2 * r(out_rows) * c(out_cols) * hw)


def dft_conv_reference(x, mats):
    """Plain twin: (n, H, W) -> (n, oh, ow) for one factor set
    (Fh, FwT, K, Ih, IwT as real/imaginary pairs), in the kernel's order."""
    fh_re, fh_im, fwt_re, fwt_im, k_re, k_im, ih_re, ih_im, iwt_re, iwt_im = mats
    # 1. cols: T1 = x @ FwT -> (n, H, hw); x is real
    tr = torch.einsum("nik,kj->nij", x, fwt_re)
    ti = torch.einsum("nik,kj->nij", x, fwt_im)
    # 2. rows: Z = (Fh @ T1) * K -> (n, fh, hw)
    zr = torch.einsum("ij,njk->nik", fh_re, tr) - torch.einsum("ij,njk->nik", fh_im, ti)
    zi = torch.einsum("ij,njk->nik", fh_re, ti) + torch.einsum("ij,njk->nik", fh_im, tr)
    pr = zr * k_re - zi * k_im
    pi = zr * k_im + zi * k_re
    # 3. inverse rows (crop/pool folded) -> (n, oh, hw)
    ur = torch.einsum("ij,njk->nik", ih_re, pr) - torch.einsum("ij,njk->nik", ih_im, pi)
    ui = torch.einsum("ij,njk->nik", ih_re, pi) + torch.einsum("ij,njk->nik", ih_im, pr)
    # 4. inverse cols (crop/pool folded), real part only -> (n, oh, ow)
    return torch.einsum("nik,kj->nij", ur, iwt_re) - torch.einsum("nik,kj->nij", ui, iwt_im)


def dft_conv_cuda(x, mats, direction: str):
    """Launches the kernel chain on x (bs, H, W) with one factor set."""
    fh, h = mats[0].shape
    w, hw = mats[2].shape
    oh, ow = mats[6].shape[0], mats[8].shape[1]
    bs = x.shape[0]
    _build.check_arg(x, "x", (bs, h, w), x.device)
    shapes = [(fh, h)] * 2 + [(w, hw)] * 2 + [(fh, hw)] * 2 + [(oh, fh)] * 2 + [(hw, ow)] * 2
    for k, (m, shp) in enumerate(zip(mats, shapes)):
        _build.check_arg(m, f"factor {k}", shp, x.device)
    if bs > 65535:
        raise ValueError(f"bs={bs} exceeds the kernel grid's z limit (65535)")
    out = torch.empty((bs, oh, ow), dtype=torch.float32, device=x.device)
    scratch = [
        torch.empty(shp, dtype=torch.float32, device=x.device)
        for shp in [(bs, h, hw)] * 2 + [(bs, fh, hw)] * 2 + [(bs, oh, hw)] * 2
    ]
    ptrs = [_build.ptr(t) for t in (x, out, *scratch, *mats)]
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.gl_dft_conv(*ptrs, bs, h, w, fh, hw, oh, ow, _build.stream(x.device))
    _build.check(err, f"dft_conv ({direction})")
    launches[f"dft_conv_{direction}"] += 1
    return out


def _run(x, mats, direction):
    if x.device.type == "cpu":
        return dft_conv_reference(x, mats)
    return dft_conv_cuda(x.contiguous(), mats, direction)


class _DFTConvFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, conv):
        ctx.conv = conv
        return _run(x, conv.fwd_mats, "fwd")

    @staticmethod
    def backward(ctx, ct):
        return _run(ct, ctx.conv.bwd_mats, "transpose"), None


def _pad4(a, axis):
    """``a`` zero-padded along ``axis`` to a multiple of four."""
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, -a.shape[axis] % 4)
    return np.pad(a, pad)


class DFTConv:
    """(bs, H, W) -> (bs, out_h, out_w) through the DFT factor chain.

    Built from the numpy factors of ``dft_factors`` (the half-spectrum set
    on every runtime path; the full set computes the same function), as
    float32 tensors on ``device``. Both spectral axes are zero-padded to a
    multiple of four: zero rows and columns add nothing to any product, and
    every matrix the kernel makes then has 16-byte aligned rows.
    Differentiable: the backward runs the transposed factor set through the
    same kernel (convolution is linear, so nothing is saved).
    """

    def __init__(self, fh_re, fh_im, fw_re, fw_im, k_re, k_im,
                 ih_re, ih_im, iw_re, iw_im, *, device):
        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)

        # spectral rows (fh) and columns (hw = fw, or fw // 2 + 1 for the half set)
        fh_re, fh_im, fw_re, fw_im = (_pad4(a, 0) for a in (fh_re, fh_im, fw_re, fw_im))
        k_re, k_im = (_pad4(_pad4(a, 0), 1) for a in (k_re, k_im))
        ih_re, ih_im, iw_re, iw_im = (_pad4(a, 1) for a in (ih_re, ih_im, iw_re, iw_im))
        # forward set: Fh (fh,H), FwT (W,hw), K (fh,hw), Ih (oh,fh), IwT (hw,ow)
        self.fwd_mats = (
            t(fh_re), t(fh_im), t(fw_re.T), t(fw_im.T), t(k_re), t(k_im),
            t(ih_re), t(ih_im), t(iw_re.T), t(iw_im.T),
        )
        # transpose set: "Fh" = Ih^T (fh,oh), "FwT" = IwT^T = Iw (ow,hw),
        # K unchanged, "Ih" = Fh^T (H,fh), "IwT" = FwT^T = Fw (hw,W)
        self.bwd_mats = (
            t(ih_re.T), t(ih_im.T), t(iw_re), t(iw_im), t(k_re), t(k_im),
            t(fh_re.T), t(fh_im.T), t(fw_re), t(fw_im),
        )

    def __call__(self, x):
        return _DFTConvFn.apply(x, self)
