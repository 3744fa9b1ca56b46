"""PSF convolution as DFT-by-matmul: the CUDA kernel (K4) and its twin.

Port of :mod:`gigalens_tpu.ops.pallas.dft_conv`. Per sample,

    out = Re[ Ih @ ((Fh @ x @ FwT) * K) @ IwT ]

with the factor matrices that :class:`~gigalens_tpu_torch.ops.psf.PSFConv`
precomputes (rectangular forward slices; 'SAME' crop and supersample
average pool folded into the inverse factors). The transpose (VJP) of this
real-linear map has the identical structure on the transposed factor set,

    bwd(ct) = Re[ Fh^T @ ((Ih^T @ ct @ IwT^T) * K) @ FwT^T ],

so one kernel (``csrc/dft_conv.cu``, a batched real-pair tiled SGEMM
launched once per stage) serves both directions. :func:`dft_conv_reference`
is the plain twin (the JAX package's ``PSFConv._dft_conv`` einsum chain),
taken for CPU tensors only.

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


def dft_conv_reference(x, mats):
    """Plain twin: (n, H, W) -> (n, oh, ow) for one factor set
    (Fh, FwT, K, Ih, IwT as real/imaginary pairs)."""
    fh_re, fh_im, fwt_re, fwt_im, k_re, k_im, ih_re, ih_im, iwt_re, iwt_im = mats
    # rows: Y = Fh @ X -> (n, fh, W)
    yr = torch.einsum("ij,njk->nik", fh_re, x)
    yi = torch.einsum("ij,njk->nik", fh_im, x)
    # cols: Z = Y @ FwT -> (n, fh, fw)
    zr = torch.einsum("nik,kj->nij", yr, fwt_re) - torch.einsum("nik,kj->nij", yi, fwt_im)
    zi = torch.einsum("nik,kj->nij", yr, fwt_im) + torch.einsum("nik,kj->nij", yi, fwt_re)
    pr = zr * k_re - zi * k_im
    pi = zr * k_im + zi * k_re
    # inverse rows (crop/pool folded) -> (n, oh, fw)
    ur = torch.einsum("ij,njk->nik", ih_re, pr) - torch.einsum("ij,njk->nik", ih_im, pi)
    ui = torch.einsum("ij,njk->nik", ih_re, pi) + torch.einsum("ij,njk->nik", ih_im, pr)
    # inverse cols (crop/pool folded), real part only -> (n, oh, ow)
    return torch.einsum("nik,kj->nij", ur, iwt_re) - torch.einsum("nik,kj->nij", ui, iwt_im)


def dft_conv_cuda(x, mats, direction: str):
    """Launches the kernel chain on x (bs, H, W) with one factor set."""
    fh, h = mats[0].shape
    w, fw = mats[2].shape
    oh, ow = mats[6].shape[0], mats[8].shape[1]
    bs = x.shape[0]
    _build.check_arg(x, "x", (bs, h, w), x.device)
    shapes = [(fh, h)] * 2 + [(w, fw)] * 2 + [(fh, fw)] * 2 + [(oh, fh)] * 2 + [(fw, ow)] * 2
    for k, (m, shp) in enumerate(zip(mats, shapes)):
        _build.check_arg(m, f"factor {k}", shp, x.device)
    if bs > 65535:
        raise ValueError(f"bs={bs} exceeds the kernel grid's z limit (65535)")
    out = torch.empty((bs, oh, ow), dtype=torch.float32, device=x.device)
    scratch = [
        torch.empty(shp, dtype=torch.float32, device=x.device)
        for shp in [(bs, h, fw)] * 2 + [(bs, fh, fw)] * 2 + [(bs, oh, fw)] * 2
    ]
    ptrs = [_build.ptr(t) for t in (x, out, *scratch, *mats)]
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.gl_dft_conv(*ptrs, bs, h, w, fh, fw, oh, ow, _build.stream(x.device))
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


class DFTConv:
    """(bs, H, W) -> (bs, out_h, out_w) through the DFT factor chain.

    Built from the numpy factors PSFConv precomputes, as float32 tensors on
    ``device``. Differentiable: the backward runs the transposed factor set
    through the same kernel (convolution is linear, so nothing is saved).
    """

    def __init__(self, fh_re, fh_im, fw_re, fw_im, k_re, k_im,
                 ih_re, ih_im, iw_re, iw_im, *, device):
        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)

        # forward set: Fh (fh,H), FwT (W,fw), K (fh,fw), Ih (oh,fh), IwT (fw,ow)
        self.fwd_mats = (
            t(fh_re), t(fh_im), t(fw_re.T), t(fw_im.T), t(k_re), t(k_im),
            t(ih_re), t(ih_im), t(iw_re.T), t(iw_im.T),
        )
        # transpose set: "Fh" = Ih^T (fh,oh), "FwT" = IwT^T = Iw (ow,fw),
        # K unchanged, "Ih" = Fh^T (H,fh), "IwT" = FwT^T = Fw (fw,W)
        self.bwd_mats = (
            t(ih_re.T), t(ih_im.T), t(iw_re), t(iw_im), t(k_re), t(k_im),
            t(fh_re.T), t(fh_im.T), t(fw_re), t(fw_im),
        )

    def __call__(self, x):
        return _DFTConvFn.apply(x, self)
