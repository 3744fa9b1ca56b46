"""PSF handling: subgrid resampling (host-side numpy) and batched convolution.

Port of :mod:`gigalens_tpu.ops.psf`. :func:`subgrid_kernel` and the DFT
factor construction are numpy, copied as they are. :class:`PSFConv`
convolves a (..., H, W) batch with a fixed kernel in one of two modes:

* ``"dft"``: the 'SAME' convolution with an optional average pool folded
  in, the JAX package's dense DFT-by-matmul path. On CUDA it takes one of
  two hand-written kernels (K4), chosen at construction by a shape rule
  (:func:`~gigalens_tpu_torch.ops.cuda.direct_conv.k4_route`, kept as
  ``PSFConv.route``): ``"direct"``, a strided sum over the pooled kernel
  (``ops/cuda/direct_conv.py``), or ``"chain"``, the DFT factor chain
  (``ops/cuda/dft_conv.py``) for PSFs too large for it. On the CPU it runs
  the chain's plain twin, the JAX package's ``_dft_conv`` einsum chain.
* ``"fft"``: zero-padded linear convolution by ``torch.fft.rfft2`` /
  ``irfft2`` with the kernel spectrum precomputed (the HMC/SMC "exact" path).

Not ported yet: the ``"direct"`` mode and per-scene kernel stacks (survey
mode). The JAX package's ``MAX_FFT_BATCH`` chunking works around a TPU
FFT fault and has no counterpart here.
"""
from __future__ import annotations

import numpy as np
import torch

from gigalens_tpu_torch.ops.cuda.dft_conv import DFTConv
from gigalens_tpu_torch.ops.cuda.direct_conv import DirectConv, k4_route


# --------------------------------------------------------------------------
# Host-side kernel preparation
# --------------------------------------------------------------------------

def _bilinear_resample(kernel: np.ndarray, factor: int, odd: bool = True) -> np.ndarray:
    """Bilinear interpolation of ``kernel`` onto a grid ``factor``x finer.

    The output grid is centered on the input grid's center; output size is
    ``factor * n`` (forced to the nearest odd size when ``odd``).
    """
    n = kernel.shape[0]
    m = factor * n
    if odd and m % 2 == 0:
        m += 1
    # Coordinates of the fine grid in units of coarse pixels, center-aligned.
    c_in = (n - 1) / 2.0
    c_out = (m - 1) / 2.0
    coords = (np.arange(m) - c_out) / factor + c_in
    x0 = np.clip(np.floor(coords).astype(int), 0, n - 2)
    w = coords - x0
    w = np.clip(w, 0.0, 1.0)

    # separable bilinear interpolation
    rows = kernel[x0, :] * (1 - w)[:, None] + kernel[x0 + 1, :] * w[:, None]
    out = rows[:, x0] * (1 - w)[None, :] + rows[:, x0 + 1] * w[None, :]
    return out


def _downsample_sum(kernel: np.ndarray, factor: int) -> np.ndarray:
    """Sums ``factor x factor`` blocks centered on the kernel center."""
    m = kernel.shape[0]
    n = m // factor
    if n * factor != m:
        pad = (n + 1) * factor - m
        lo = pad // 2
        hi = pad - lo
        kernel = np.pad(kernel, ((lo, hi), (lo, hi)))
        n += 1
    return kernel.reshape(n, factor, n, factor).sum(axis=(1, 3))


def subgrid_kernel(
    kernel: np.ndarray, factor: int, odd: bool = True, num_iter: int = 5
) -> np.ndarray:
    """Resamples a native-pixel PSF kernel onto a ``factor``x supersampled grid.

    Flux-conserving: iteratively corrects the interpolated kernel so that
    block-summing it back to the native grid reproduces the input kernel
    (the same contract as lenstronomy's ``subgrid_kernel``, re-implemented).
    """
    kernel = np.asarray(kernel, np.float64)
    kernel = kernel / kernel.sum()
    if factor == 1:
        return kernel.astype(np.float32)

    fine = _bilinear_resample(kernel, factor, odd=odd)
    fine = np.clip(fine, 0, None)
    fine /= fine.sum()

    for _ in range(num_iter):
        coarse = _downsample_sum(fine, factor)
        # align coarse grid back onto the input kernel's support
        cc = coarse.shape[0]
        if cc > kernel.shape[0]:
            trim = (cc - kernel.shape[0]) // 2
            coarse_c = coarse[trim : trim + kernel.shape[0], trim : trim + kernel.shape[0]]
        else:
            coarse_c = coarse
        ratio = kernel / np.maximum(coarse_c, 1e-12)
        correction = _bilinear_resample(ratio, factor, odd=odd)
        if correction.shape != fine.shape:
            t = (correction.shape[0] - fine.shape[0]) // 2
            correction = correction[t : t + fine.shape[0], t : t + fine.shape[0]]
        fine = np.clip(fine * correction, 0, None)
        fine /= fine.sum()
    return fine.astype(np.float32)


def _good_fft_size(n: int) -> int:
    """Next 5-smooth ("regular") integer >= n; XLA FFT likes small prime radix."""
    if n <= 2:
        return max(n, 1)
    best = 1 << (n - 1).bit_length()  # next power of two as the fallback
    p5 = 1
    while p5 <= best:
        p35 = p5
        while p35 <= best:
            m = p35
            while m < n:
                m *= 2
            best = min(best, m)
            p35 *= 3
        p5 *= 5
    return best


def dft_factors(kernel: np.ndarray, img_shape, pool: int = 1):
    """The DFT chain's ten float32 factors for ``kernel`` on ``img_shape``
    images, in :class:`DFTConv`'s argument order: Fh, Fw (re, im), the
    kernel spectrum K (re, im), and the inverses Ih, Iw (re, im).

    The factors do no wasted work: the forward matrices are rectangular
    (fh, H) / (fw, W) slices (the zero padding contributes nothing), and the
    inverse matrices fold in the 'SAME' crop and, when pool > 1, the
    average pool.
    """
    kernel = np.asarray(kernel, np.float32)
    kh, kw = kernel.shape
    h, w = int(img_shape[0]), int(img_shape[1])
    fh, fw = _good_fft_size(h + kh - 1), _good_fft_size(w + kw - 1)
    kpad = np.zeros((fh, fw), np.float64)
    kpad[:kh, :kw] = kernel
    kfft = np.fft.fft2(kpad)

    def dft(n):
        return np.exp(-2j * np.pi * np.outer(np.arange(n), np.arange(n)) / n)

    def fold(inv, off, size):
        """Crop rows [off, off+size) and mean-pool blocks of pool."""
        sel = inv[off : off + size]
        if pool == 1:
            return sel
        return sel.reshape(size // pool, pool, -1).mean(axis=1)

    Fh, Fw = dft(fh), dft(fw)
    oy, ox = kh // 2, kw // 2
    f32 = np.float32
    return (
        Fh.real[:, :h].astype(f32).copy(), Fh.imag[:, :h].astype(f32).copy(),
        Fw.real[:, :w].astype(f32).copy(), Fw.imag[:, :w].astype(f32).copy(),
        kfft.real.astype(f32), kfft.imag.astype(f32),
        # inverse DFT = conj(F)/n, with crop (+pool) folded in
        fold(Fh.real / fh, oy, h).astype(f32), fold(-Fh.imag / fh, oy, h).astype(f32),
        fold(Fw.real / fw, ox, w).astype(f32), fold(-Fw.imag / fw, ox, w).astype(f32),
    )


# --------------------------------------------------------------------------
# Device-side convolution
# --------------------------------------------------------------------------

class PSFConv:
    """Batched 2-D convolution of (bs, H, W) images with a fixed kernel.

    Both modes give 'SAME'-size output with true convolution orientation
    (kernel flipped), matching the reference's ``lax.conv``; ``pool`` > 1
    (dft mode only) folds the trailing average pool into the inverse
    transform, so the conv emits (H/pool, W/pool) directly. Constants live
    on ``device``, which the caller names (no default).
    """

    def __init__(self, kernel: np.ndarray, img_shape, mode: str = "fft",
                 pool: int = 1, *, device):
        self.kernel = np.asarray(kernel, np.float32)
        if self.kernel.ndim != 2:
            raise NotImplementedError(
                "per-scene PSF stacks (survey mode) are not ported yet (ROADMAP M17)"
            )
        if mode not in ("dft", "fft"):
            raise NotImplementedError(
                f"PSF mode {mode!r} is not ported; use 'dft' or 'fft'"
            )
        self.kh, self.kw = self.kernel.shape
        self.h, self.w = int(img_shape[0]), int(img_shape[1])
        self.mode = mode
        self.device = torch.device(device)
        self.pool = int(pool) if mode == "dft" else 1
        self.route = None  # "direct" or "chain" in dft mode
        fh = _good_fft_size(self.h + self.kh - 1)
        fw = _good_fft_size(self.w + self.kw - 1)
        self.fshape = (fh, fw)

        if mode == "dft":
            p = self.pool
            if p > 1 and (self.h % p or self.w % p):
                raise ValueError("pool must divide the image shape")
            self.out_h, self.out_w = self.h // p, self.w // p
            # the CPU runs the chain's einsum twin: parity with the JAX package
            self.route = "chain"
            if self.device.type == "cuda":
                self.route = k4_route(self.kh, self.kw, p)
            self._dft = self._direct = None
            if self.route == "direct":
                self._direct = DirectConv(self.kernel, (self.h, self.w), p, self.device)
            else:
                factors = dft_factors(self.kernel, (self.h, self.w), p)
                (self._fh_re, self._fh_im, self._fw_re, self._fw_im, self._k_re, self._k_im,
                 self._ih_re, self._ih_im, self._iw_re, self._iw_im) = factors
                self._dft = DFTConv(*factors, device=self.device)
        else:
            kpad = np.zeros((fh, fw), np.float64)
            kpad[: self.kh, : self.kw] = self.kernel
            kfft = np.fft.rfft2(kpad)
            # complex64 spectrum for float32 inputs (the JAX package's), the
            # unrounded complex128 one for float64 inputs
            self._kfft = {
                torch.float32: torch.as_tensor(kfft.astype(np.complex64), device=self.device),
                torch.float64: torch.as_tensor(kfft, device=self.device),
            }
            # 'SAME' crop offsets matching the flipped-kernel convolution
            self._oy = self.kh // 2
            self._ox = self.kw // 2
            self.out_h, self.out_w = self.h, self.w

    def _fft_conv(self, x):
        xf = torch.fft.rfft2(x, s=self.fshape)
        out = torch.fft.irfft2(xf * self._kfft[x.dtype], s=self.fshape)
        return out[..., self._oy : self._oy + self.h, self._ox : self._ox + self.w]

    def __call__(self, img):
        """img: (..., H, W) -> convolved (..., out_h, out_w)."""
        batch_shape = img.shape[:-2]
        x = img.reshape(-1, self.h, self.w)
        if self.mode == "fft":
            out = self._fft_conv(x)
        else:
            out = self._direct(x) if self.route == "direct" else self._dft(x)
        return out.reshape(*batch_shape, self.out_h, self.out_w)


def average_pool(img, factor: int):
    """Non-overlapping mean pooling over the last two axes (reshape + mean)."""
    if factor == 1:
        return img
    *b, h, w = img.shape
    img = img.reshape(*b, h // factor, factor, w // factor, factor)
    return img.mean(dim=(-3, -1))
