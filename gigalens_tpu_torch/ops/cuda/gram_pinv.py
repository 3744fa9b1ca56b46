"""The pseudo-inverse of a batch of small symmetric float64 matrices (the
lstsq solve's Gram) on the card: the CUDA kernel and its twin.

``torch.linalg.pinv`` on a CUDA tensor runs cuSOLVER's batched Jacobi SVD
and then reads its error codes on the host, so a MAP step that solves its
linear amplitudes waited for the card once a step. ``csrc/gram_pinv.cu``
computes ``torch.linalg.pinv(a, rtol=rtol)`` for symmetric ``a`` by
two-sided cyclic Jacobi with nothing read back: one block a matrix, the
round-robin pair order, Rutishauser's rotations, a stopping test on the
device, then ``V diag(w) V^T`` with the eigenvalues at or below ``rtol``
times the largest magnitude dropped (a symmetric matrix's singular values
are its eigenvalues' magnitudes, so the cutoff is torch's).
:func:`gram_pinv_reference` is the twin, the kernel's arithmetic line for
line, vectorised over the batch and over a round's disjoint pairs.

:func:`gram_pinv` routes by what it can observe in its input
(:func:`route`): a CUDA float64 batch of square matrices of depth at most
``MAX_DEPTH`` launches the kernel; any other CUDA tensor takes
``torch.linalg.pinv`` and counts a fallback; a CPU tensor takes
``torch.linalg.pinv``, as the tests' many lstsq evaluations do.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from gigalens_tpu_torch.ops.cuda import _build

# the kernel's launches, and the CUDA calls that took torch.linalg.pinv instead
launches = {"gram_pinv": 0, "gram_pinv_fallback": 0}

MAX_DEPTH = 32  # csrc/gram_pinv.cu: kMaxDepth
MAX_SWEEPS = 40  # kMaxSweeps
TOL2 = 2.0 ** -104  # kTol2: (2^-52)^2


def route(a) -> str:
    """"kernel", "fallback" (``torch.linalg.pinv`` on a CUDA tensor) or
    "cpu", from ``a``'s device, dtype and shape."""
    if a.device.type != "cuda":
        return "cpu"
    n = a.shape[-1] if len(a.shape) >= 2 else 0
    if a.dtype == torch.float64 and a.shape[-2] == n and 1 <= n <= MAX_DEPTH:
        return "kernel"
    return "fallback"


def gram_pinv(a, rtol: float):
    """``torch.linalg.pinv(a, rtol=rtol)`` of a batch of real symmetric
    matrices ``a`` (..., n, n), by the route :func:`route` gives."""
    how = route(a)
    if how == "kernel":
        return gram_pinv_cuda(a, rtol)
    if how == "fallback":
        launches["gram_pinv_fallback"] += 1
    return torch.linalg.pinv(a, rtol=rtol)


def gram_pinv_cuda(a, rtol: float):
    """Launches the kernel on a CUDA float64 (..., n, n) batch."""
    n = a.shape[-1]
    a = a.contiguous()
    out = torch.empty_like(a)
    batch = a.numel() // (n * n)
    if batch == 0:
        return out
    _build.check_arg(a, "a", (*a.shape[:-2], n, n), a.device, torch.float64)
    if not 1 <= n <= MAX_DEPTH:
        raise ValueError(f"depth {n} is outside the kernel's 1..{MAX_DEPTH}")
    lib = _build.load()
    with torch.cuda.device(a.device):
        err = lib.gl_gram_pinv(_build.ptr(a), _build.ptr(out), batch, n, ctypes.c_double(rtol),
                               _build.stream(a.device))
    _build.check(err, "gram_pinv")
    launches["gram_pinv"] += 1
    return out


def _sqrt(x):
    """The correctly rounded square root, as the kernel's: torch's CPU
    ``sqrt`` on float64 may be an ulp off it, numpy's is not."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


@functools.lru_cache(maxsize=None)
def _partners(np_: int):
    """(np_ - 1, np_) partner of each index in each round of the
    round-robin order (the kernel's ``partner``)."""
    m = np_ - 1
    rows = []
    for r in range(m):
        row = [(2 * r - i) % m for i in range(m)] + [r]
        row[r] = m
        rows.append(row)
    return torch.tensor(rows)


def gram_pinv_reference(a, rtol: float):
    """Plain twin of the kernel: (..., n, n) -> (..., n, n) float64."""
    shape, n = a.shape, a.shape[-1]
    a = a.reshape(-1, n, n).to(torch.float64)
    np_ = n + n % 2
    f64 = dict(dtype=torch.float64, device=a.device)
    A = torch.zeros((a.shape[0], np_, np_), **f64)
    A[:, :n, :n] = (a + a.mT) * 0.5
    bad = ~torch.isfinite(A).all(dim=2).all(dim=1)
    A = torch.where(bad[:, None, None], 0.0, A)
    ex = torch.frexp(A.abs().amax(dim=(1, 2)))[1]
    A = torch.ldexp(A, -ex[:, None, None].to(torch.float64))
    V = torch.eye(np_, **f64).expand_as(A).clone()
    idx = torch.arange(np_, device=a.device)
    I, J = idx[:, None], idx[None, :]
    R0, R1 = torch.minimum(I, J), torch.maximum(I, J)
    diag = I == J
    parts = _partners(np_).to(a.device)

    done = torch.zeros_like(bad)
    for sweep in range(MAX_SWEEPS + 1):
        # the test: each row's sums in column order, then over the rows
        off = torch.zeros(A.shape[:2], **f64)
        for k in range(np_):
            x = A[:, :, k]
            off = torch.where(idx != k, off + x * x, off)
        d = torch.diagonal(A, dim1=1, dim2=2)
        row1 = d * d
        o, g = torch.zeros(A.shape[0], **f64), torch.zeros(A.shape[0], **f64)
        for k in range(np_):
            o = o + off[:, k]
        for k in range(np_):
            g = g + row1[:, k]
        done = done | bad | (o <= TOL2 * (o + g)) | (sweep == MAX_SWEEPS)
        if bool(done.all()):
            break
        for r in range(np_ - 1):
            pt = parts[r]
            P = idx[idx < pt]
            Q = pt[P]
            apq = A[:, P, Q]
            rot = apq != 0.0
            tau = (A[:, Q, Q] - A[:, P, P]) / (2.0 * torch.where(rot, apq, 1.0))
            t = torch.copysign(torch.ones_like(tau), tau) / (tau.abs() + _sqrt(1.0 + tau * tau))
            c = 1.0 / _sqrt(1.0 + t * t)
            s = t * c
            t, c, s = (torch.where(rot, v, v0) for v, v0 in ((t, 0.0), (c, 1.0), (s, 0.0)))
            cs, sg, dt = (torch.empty(A.shape[:2], **f64) for _ in range(3))
            cs[:, P], cs[:, Q] = c, c
            sg[:, P], sg[:, Q] = -s, s
            dt[:, P], dt[:, Q] = -t, t
            P0, P1 = pt[R0], pt[R1]
            c0, s0, c1, s1 = cs[:, R0], sg[:, R0], cs[:, R1], sg[:, R1]
            rotated = (c1 * (c0 * A[:, R0, R1] + s0 * A[:, P0, R1])
                       + s1 * (c0 * A[:, R0, P1] + s0 * A[:, P0, P1]))
            on_diag = A[:, I, I] + dt[:, I] * A[:, I, pt[I]]
            An = torch.where(diag, on_diag, torch.where(J == pt[I], 0.0, rotated))
            Vn = cs[:, None, :] * V + sg[:, None, :] * V[:, I, pt[J]]
            A = torch.where(done[:, None, None], A, An)
            V = torch.where(done[:, None, None], V, Vn)

    lam = torch.diagonal(A, dim1=1, dim2=2)[:, :n]
    thr = rtol * lam.abs().amax(dim=1, keepdim=True)
    w = torch.where(lam.abs() > thr, 1.0 / torch.where(lam == 0.0, 1.0, lam), 0.0)
    r0, r1 = R0[:n, :n], R1[:n, :n]
    acc = torch.zeros((A.shape[0], n, n), **f64)
    for k in range(n):
        acc = acc + (w[:, k, None, None] * V[:, r0, k]) * V[:, r1, k]
    p = torch.ldexp(acc, -ex[:, None, None].to(torch.float64))
    p = torch.where(bad[:, None, None], torch.nan, p)
    return p.reshape(shape)
