"""The yardstick: one NVIDIA H100 SXM's peaks and the operations and bytes
the work of a layer needs, counted from its shapes whatever implements it.

A bound is the larger of operations over the FP32 peak (outside the tensor
cores) and bytes over the memory rate, each input read once and each
output written once (float32, 4 bytes). The PSF convolution (K4) counts
the cheaper of its two algorithms at the shape, the direct strided sum over
the pooled kernel or the half-spectrum DFT chain, 2 operations a
multiply-add; the renders count their plain one-stage versions' elementwise
operations (an exp counts 1), a figure each configuration states per row
and pixel; a matrix product counts 2 m n k.
"""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())
F32 = 4


def bound_s(ops, nbytes):
    """(seconds, "operations" | "bytes") of work at the card's peaks."""
    t_ops, t_bytes = ops / PEAKS["fp32_flops"], nbytes / PEAKS["hbm_bytes_per_s"]
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _good_fft_size(n):
    """The next 5-smooth integer at or above ``n``."""
    if n <= 2:
        return max(n, 1)
    best = 1 << (n - 1).bit_length()
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


def k4_macs(h, w, kh, kw, pool, transpose=False):
    """Multiply-adds an image of the cheaper PSF-convolution algorithm:
    the direct sum (output pixels x the pooled kernel's taps) or the
    half-spectrum DFT chain (its four products over the half spectrum)."""
    direct = (h // pool) * (w // pool) * (kh + pool - 1) * (kw + pool - 1)
    fh, hw = _good_fft_size(h + kh - 1), _good_fft_size(w + kw - 1) // 2 + 1
    rows, cols, out_rows, out_cols = h, w, h // pool, w // pool
    if transpose:
        rows, cols, out_rows, out_cols = out_rows, out_cols, rows, cols
    chain = (2 * rows * hw * cols + 4 * fh * hw * rows + 4 * out_rows * hw * fh
             + 2 * out_rows * out_cols * hw)
    return min(direct, chain)


def k4_work(s):
    """(operations, bytes) of one step's K4 both ways for shape ``s``
    ({images, h, w, kh, kw, pool})."""
    n, h, w, p = s["images"], s["h"], s["w"], s["pool"]
    ops = sum(2 * n * k4_macs(h, w, s["kh"], s["kw"], p, t) for t in (False, True))
    kernel = (s["kh"] + p - 1) * (s["kw"] + p - 1)
    one_way = n * (h * w + (h // p) * (w // p)) + kernel
    return ops, 2 * one_way * F32


def render_work(s):
    """(operations, bytes) of the component render forward and its
    gradient ({rows, pixels, components, params, *_ops_per_row_pixel}): the
    forward reads the parameters and coordinates and writes the components;
    the gradient reads them and the components' cotangents and writes the
    parameters' gradient."""
    rp = s["rows"] * s["pixels"]
    comps = s["components"] * rp
    small = s["rows"] * s["params"] + 2 * s["pixels"]
    fwd = (s["fwd_ops_per_row_pixel"] * rp, (small + comps) * F32)
    bwd = (s["bwd_ops_per_row_pixel"] * rp, (small + comps + s["rows"] * s["params"]) * F32)
    return fwd, bwd


def lstsq_ops(s):
    """The weighted normal equations of one step ({rows, pixels, depth}):
    the Gram and right-hand side, the model image, and their gradients."""
    n, p, d = s["rows"], s["pixels"], s["depth"]
    return 2 * (2 * n * p * d * d + 2 * n * p * d + 2 * n * p * d)


def gram_ops(s):
    """The inversion's linear algebra of one step ({rows, n_src, pixels}):
    the Gram C W C^T and its gradient (2 k^2 p each), the Cholesky (k^3/3),
    the factor's inverse (k^3/3), F^{-1} for the gradient (k^3 / 3), the
    right-hand side and the model (2 k p each), per row."""
    n, k, p = s["rows"], s["n_src"], s["pixels"]
    return n * (2 * 2 * k * k * p + 3 * k**3 / 3 + 2 * 2 * k * p)
