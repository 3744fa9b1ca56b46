"""PSF handling: subgrid resampling (host-side numpy) and batched convolution.

Port of :mod:`gigalens_tpu.ops.psf`. :func:`subgrid_kernel` and the DFT
factor construction are numpy, copied as they are. :class:`PSFConv`
convolves a (..., H, W) batch with a fixed kernel in one of two modes:

* ``"dft"``: the 'SAME' convolution with an optional average pool folded
  in, the JAX package's dense DFT-by-matmul path. On CUDA it takes one of
  two hand-written kernels (K4), chosen at construction by a shape rule
  (:func:`~gigalens_tpu_torch.ops.cuda.direct_conv.k4_route`, kept as
  ``PSFConv.route``): ``"direct"``, a strided sum over the pooled kernel
  (``ops/cuda/direct_conv.py``), or ``"chain"``, the DFT factor chain over
  half of the spectrum (``ops/cuda/dft_conv.py``) for the larger PSFs,
  where it is faster. On the CPU it runs the chain's plain twin, the JAX
  package's ``_dft_conv`` einsum chain on the half-spectrum factors.
* ``"fft"``: zero-padded linear convolution by ``torch.fft.rfft2`` /
  ``irfft2`` with the kernel spectrum precomputed (the HMC/SMC "exact" path).
* ``"direct"``: ``F.conv2d`` with the flipped kernel, the JAX package's
  ``lax.conv`` mode for tiny kernels (no pool, no stack; the JAX package
  runs it outside any Pallas kernel too).

A stacked (S, kh, kw) kernel convolves survey batches scene by scene
(fft and dft modes): the sample axis holds S * K scene-major rows, and
each scene's K rows meet that scene's kernel. The JAX package's
``MAX_FFT_BATCH`` chunking works around a TPU FFT fault and has no
counterpart here.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

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


def dft_factors(kernel: np.ndarray, img_shape, pool: int = 1, half: bool = False):
    """The DFT chain's ten float32 factors for ``kernel`` on ``img_shape``
    images, in :class:`DFTConv`'s argument order: Fh, Fw (re, im), the
    kernel spectrum K (re, im), and the inverses Ih, Iw (re, im).

    The factors do no wasted work: the forward matrices are rectangular
    (fh, H) / (fw, W) slices (the zero padding contributes nothing), and the
    inverse matrices fold in the 'SAME' crop and, when pool > 1, the
    average pool. ``half=False`` gives the JAX package's full-spectrum set.

    ``half=True`` keeps the spectral columns 0 .. fw // 2 only (Fw's rows,
    K's and Iw's columns): image and kernel are real, so column fw - c of
    the spectrum is the conjugate of column c and adds the conjugate term
    to the last product, whose real part is all the chain keeps. K then
    carries the weights, 1 for the self-conjugate columns (0 and, for even
    fw, fw / 2) and 2 for the rest, so ``Re[...]`` is unchanged in exact
    arithmetic. The weights sit on K and not on the last factor because the
    forward and the transposed chain share K (the last factor of one is
    the first of the other); they commute through the products either way.
    Half of the chain's multiply-adds go: this is what the card's chain
    kernel and its CPU twin run.
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
    # inverse DFT = conj(F)/n, with crop (+pool) folded in
    Ih = fold(Fh.real / fh, oy, h) + 1j * fold(-Fh.imag / fh, oy, h)
    Iw = fold(Fw.real / fw, ox, w) + 1j * fold(-Fw.imag / fw, ox, w)
    Fh, Fw = Fh[:, :h], Fw[:, :w]
    if half:
        hw = fw // 2 + 1
        weight = np.full(hw, 2.0)
        weight[0] = 1.0
        if fw % 2 == 0:
            weight[-1] = 1.0
        Fw, Iw, kfft = Fw[:hw], Iw[:, :hw], kfft[:, :hw] * weight
    f32 = np.float32
    return tuple(np.ascontiguousarray(part, f32) for m in (Fh, Fw, kfft, Ih, Iw)
                 for part in (m.real, m.imag))


# --------------------------------------------------------------------------
# Device-side convolution
# --------------------------------------------------------------------------

class PSFConv:
    """Batched 2-D convolution of (bs, H, W) images with a fixed kernel.

    Every mode gives 'SAME'-size output with true convolution orientation
    (kernel flipped), matching the reference's ``lax.conv``; ``pool`` > 1
    (dft mode only) folds the trailing average pool into the inverse
    transform, so the conv emits (H/pool, W/pool) directly. Constants live
    on ``device``, which the caller names (no default).

    A stacked (S, kh, kw) ``kernel`` sets ``n_scenes`` = S: :meth:`__call__`
    then reads one batch axis as S * K scene-major rows (all of scene 0's
    samples, then scene 1's, ...) and convolves each scene's rows with its
    own kernel. fft applies an (S, 1, fh, fw // 2 + 1) spectrum in one
    ``torch.fft`` call; dft builds one K4 per scene (every scene's kernel
    has the same shape, so ``route`` is the same for all) and launches it
    on that scene's contiguous rows, as the JAX package sends per-scene
    spectra down its plain path and never down its one-spectrum Pallas
    kernel.
    """

    def __init__(self, kernel: np.ndarray, img_shape, mode: str = "fft",
                 pool: int = 1, *, device):
        self.kernel = np.asarray(kernel, np.float32)
        if self.kernel.ndim not in (2, 3):
            raise ValueError(f"kernel must be (kh, kw) or (S, kh, kw); got {self.kernel.shape}")
        self.n_scenes = self.kernel.shape[0] if self.kernel.ndim == 3 else None
        if mode == "dft_hi":
            # the JAX package's dft with HIGHEST-precision einsums (its TPU
            # matmuls truncate to bf16 otherwise); K4 and its twins are full
            # float32 here already
            mode = "dft"
        if mode not in ("dft", "fft", "direct"):
            raise NotImplementedError(
                f"PSF mode {mode!r} is not ported; use 'dft', 'fft' or 'direct'")
        if mode == "direct" and self.n_scenes is not None:
            raise NotImplementedError(
                "per-scene PSF kernels support mode='fft' or 'dft'; "
                "use one of those for survey batches")
        self.kh, self.kw = self.kernel.shape[-2:]
        self.h, self.w = int(img_shape[0]), int(img_shape[1])
        self.mode = mode
        self.device = torch.device(device)
        self.pool = int(pool) if mode == "dft" else 1
        self.route = None  # "direct" or "chain" in dft mode
        fh = _good_fft_size(self.h + self.kh - 1)
        fw = _good_fft_size(self.w + self.kw - 1)
        self.fshape = (fh, fw)
        self.out_h, self.out_w = self.h // self.pool, self.w // self.pool
        kernels = self.kernel if self.n_scenes is not None else self.kernel[None]

        if mode == "dft":
            p = self.pool
            if p > 1 and (self.h % p or self.w % p):
                raise ValueError("pool must divide the image shape")
            # the CPU runs the chain's einsum twin: parity with the JAX package
            self.route = "chain"
            if self.device.type == "cuda":
                self.route = k4_route(self.kh, self.kw, p, self.h, self.w)
            if self.route == "direct":
                self._scene_convs = [DirectConv(k, (self.h, self.w), p, self.device)
                                     for k in kernels]
            else:
                self._scene_convs = [
                    DFTConv(*dft_factors(k, (self.h, self.w), p, half=True), device=self.device)
                    for k in kernels]
            # the single kernel's conv (scene 0's for a stack)
            self._direct = self._scene_convs[0] if self.route == "direct" else None
            self._dft = self._scene_convs[0] if self.route == "chain" else None
        elif mode == "fft":
            kpad = np.zeros((len(kernels), fh, fw), np.float64)
            kpad[:, : self.kh, : self.kw] = kernels
            kfft = np.fft.rfft2(kpad)
            # (fh, fw') for one kernel, (S, 1, fh, fw') against (S, K, H, W)
            kfft = kfft[0] if self.n_scenes is None else kfft[:, None]
            # complex64 spectrum for float32 inputs (the JAX package's), the
            # unrounded complex128 one for float64 inputs
            self._kfft = {
                torch.float32: torch.as_tensor(kfft.astype(np.complex64), device=self.device),
                torch.float64: torch.as_tensor(kfft, device=self.device),
            }
            # 'SAME' crop offsets matching the flipped-kernel convolution
            self._oy = self.kh // 2
            self._ox = self.kw // 2
        else:
            # OIHW weight, flipped: conv2d correlates
            self._k = torch.as_tensor(np.ascontiguousarray(self.kernel[::-1, ::-1]),
                                      device=self.device)[None, None]

    def _fft_conv(self, x):
        xf = torch.fft.rfft2(x, s=self.fshape)
        out = torch.fft.irfft2(xf * self._kfft[x.dtype], s=self.fshape)
        return out[..., self._oy : self._oy + self.h, self._ox : self._ox + self.w]

    def _check_scene_batch(self, n):
        if n % self.n_scenes:
            raise ValueError(
                f"per-scene PSF: batch {n} is not a multiple of "
                f"n_scenes={self.n_scenes} (samples must be scene-major)")
        return n // self.n_scenes

    def __call__(self, img, scene_axis: int = 0):
        """img: (..., H, W) -> convolved (..., out_h, out_w).

        With a per-scene kernel, batch axis ``scene_axis`` of ``img`` holds
        the S * K scene-major samples; the other batch axes ride along (the
        simulator's lstsq components, (depth, S * K, H, W), pass -3)."""
        if self.n_scenes is None:
            x = img.reshape(-1, self.h, self.w)
            if self.mode == "fft":
                out = self._fft_conv(x)
            elif self.mode == "direct":
                out = F.conv2d(x[:, None], self._k.to(x.dtype), padding="same")[:, 0]
            else:
                out = self._scene_convs[0](x)
            return out.reshape(*img.shape[:-2], self.out_h, self.out_w)

        x = img.movedim(scene_axis, 0)
        lead = x.shape[:-2]
        self._check_scene_batch(lead[0])
        # (S, K * other batch axes, H, W): a view when the scene axis leads
        x = x.reshape(self.n_scenes, -1, self.h, self.w)
        if self.mode == "fft":
            out = self._fft_conv(x)
        else:
            out = torch.cat([conv(x[s]) for s, conv in enumerate(self._scene_convs)])
        return out.reshape(*lead, self.out_h, self.out_w).movedim(0, scene_axis)


def average_pool(img, factor: int):
    """Non-overlapping mean pooling over the last two axes (reshape + mean)."""
    if factor == 1:
        return img
    *b, h, w = img.shape
    img = img.reshape(*b, h // factor, factor, w // factor, factor)
    return img.mean(dim=(-3, -1))
