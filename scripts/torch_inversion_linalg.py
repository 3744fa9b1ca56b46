#!/usr/bin/env python3
"""The inversion's dense linear algebra timed on the card, by library.

    python3 scripts/torch_inversion_linalg.py [--bs 32] [--k 576] [--n 4096]

``PixelatedSourceProbModel`` (``gigalens_tpu_torch/inversion.py``) forms
``F = (C w) C^T + lam H`` for ``bs`` samples of ``k`` source pixels over
``n`` native pixels, factors it, solves one right-hand side in the forward
and one in the backward, and needs ``F^{-1}`` for the gradient of ``log det
F``. This script builds such an F from seeded random C (float32, TF32 off)
and times each step under each of PyTorch's CUDA linear-algebra backends
(``torch.backends.cuda.preferred_linalg_library``: "cusolver" and "magma"):
``cholesky_ex``, ``cholesky_solve`` with one column, ``cholesky_inverse``,
and ``F^{-1}`` as ``solve_triangular(L, I)`` followed by ``Linv^T Linv``;
also the Gram itself. Each time is the host clock over ``--reps`` calls
ending in a synchronize (a call may wait on the host), after one warmup.
Each result is checked against float64 on the card (relative error of the
max). Prints the card's name and power limit, then one JSON line. Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bs", type=int, default=32)
    ap.add_argument("--k", type=int, default=576)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)

    import torch

    from gigalens_tpu_torch.inversion import gradient_regularizer

    if not torch.cuda.is_available():
        print("torch_inversion_linalg: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    side = int(round(args.k ** 0.5))
    H = torch.as_tensor(gradient_regularizer(side)[0], device=dev)
    C = torch.rand((args.bs, side * side, args.n), generator=gen, device=dev) * 0.05
    w = torch.full((args.n,), 100.0, device=dev)
    b = torch.randn((args.bs, side * side, 1), generator=gen, device=dev)
    eye = torch.eye(side * side, device=dev).expand(args.bs, -1, -1)

    def clock(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            out = fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / args.reps, out

    def rel(got, want):
        return float((got.double() - want).abs().max() / want.abs().max())

    out = dict(card=card, bs=args.bs, k=side * side, n=args.n, reps=args.reps)
    gram_ms, F = clock(lambda: torch.matmul(C * w, C.transpose(-1, -2)) + 3.0 * H)
    out["gram_ms"] = gram_ms
    F64 = F.double()
    L64 = torch.linalg.cholesky(F64)
    want = dict(solve=torch.cholesky_solve(b.double(), L64), inverse=torch.cholesky_inverse(L64))
    old = torch.backends.cuda.preferred_linalg_library()
    for lib in ("cusolver", "magma"):
        torch.backends.cuda.preferred_linalg_library(lib)
        row = {}
        row["cholesky_ex_ms"], (L, info) = clock(lambda: torch.linalg.cholesky_ex(F))
        if int(info.abs().max()) != 0:
            raise AssertionError(f"{lib}: F not positive definite")
        row["cholesky_rel"] = rel(L, L64)
        row["cholesky_solve_ms"], s = clock(lambda: torch.cholesky_solve(b, L))
        row["cholesky_solve_rel"] = rel(s, want["solve"])
        row["cholesky_inverse_ms"], Finv = clock(lambda: torch.cholesky_inverse(L))
        row["cholesky_inverse_rel"] = rel(Finv, want["inverse"])

        def tri_inverse():
            Li = torch.linalg.solve_triangular(L, eye, upper=False)
            return torch.matmul(Li.transpose(-1, -2), Li)

        row["triangular_inverse_ms"], Finv = clock(tri_inverse)
        row["triangular_inverse_rel"] = rel(Finv, want["inverse"])
        out[lib] = row
        print(f"{lib}: " + ", ".join(f"{k} {v:.4g}" for k, v in row.items()), flush=True)
    torch.backends.cuda.preferred_linalg_library(old)
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
