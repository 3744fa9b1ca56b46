#!/usr/bin/env python3
"""K4's two routes timed against each other across PSF sizes on the card.

    python3 scripts/torch_k4_routes.py [--bs 500] [--img 160] [--psf 51,95,121,151,161,...]

For each supersampled PSF size (pool 2, ``img`` x ``img`` images, ``bs``
samples of standard-normal input): builds the DFT chain
(``ops/cuda/dft_conv.py``) and, wherever a block of MIN_WARPS warps fits
its shared memory, the direct strided-sum kernel
(``ops/cuda/direct_conv.py``) for the same random PSF; checks that the two
routes agree to 1e-4 of the output's max in both directions, and times
each direction of each route with CUDA events. Prints the card's name and
power limit, then one JSON line per size: both routes' ms, the direct
kernel's launch plan (warps per block, shared memory), and the function's
bound (2 x out pixels x pooled taps FP32 operations over the FP32 peak).
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bs", type=int, default=500)
    ap.add_argument("--img", type=int, default=160)
    ap.add_argument("--psf", default="51,95,121,151,161,163,169,175,177,183")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke as cs
    from gigalens_tpu_torch.ops.cuda import _build
    from gigalens_tpu_torch.ops.cuda import dft_conv as dc
    from gigalens_tpu_torch.ops.cuda import direct_conv as dcv
    from gigalens_tpu_torch.ops.psf import dft_factors

    if not torch.cuda.is_available():
        print("torch_k4_routes: no CUDA device available", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    _build.load()
    dev, pool, h, bs = torch.device("cuda"), 2, args.img, args.bs
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((bs, h, h), generator=gen, device=dev)
    ct = torch.randn((bs, h // pool, h // pool), generator=gen, device=dev)
    rng = np.random.default_rng(0)
    for k in (int(s) for s in args.psf.split(",")):
        kern = rng.random((k, k)).astype(np.float32)
        kern /= kern.sum()
        row = dict(psf=k, img=h, bs=bs, route=dcv.k4_route(k, k, pool))
        chain = dc.DFTConv(*dft_factors(kern, (h, h), pool), device=dev)
        row["fshape"] = list(chain.fwd_mats[4].shape)
        ops = 2 * bs * (h // pool) ** 2 * (k + pool - 1) ** 2
        row["bound_ms"] = 1e3 * ops / cs.FP32_PEAK
        ku, kv = dcv._sub_shape(k, k, pool)
        fits = None not in (dcv.plan(ku, kv, pool * pool, h // pool),
                            dcv.plan(ku, kv, 1, h // pool))
        direct = dcv.DirectConv(kern, (h, h), pool, dev) if fits else None
        if direct is not None:
            row["plans"] = {d: {key: direct.plans[d][key] for key in ("warps", "smem")}
                            for d in ("fwd", "transpose")}
        for direction, arg, mats in (("fwd", x, chain.fwd_mats), ("transpose", ct, chain.bwd_mats)):
            want = dc.dft_conv_cuda(arg, mats, direction)
            row[f"chain_{direction}_ms"] = cs.cuda_ms(lambda: dc.dft_conv_cuda(arg, mats, direction))
            if direct is None:
                continue
            got = dcv.direct_conv_cuda(arg, direct, direction)
            rel, _ = cs.check_rel(f"direct vs chain {direction} at {k} px", got, want, 1e-4)
            row[f"direct_{direction}_ms"] = cs.cuda_ms(
                lambda: dcv.direct_conv_cuda(arg, direct, direction))
            row[f"rel_{direction}"] = rel
        print(json.dumps(row), flush=True)
        del chain, direct
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
