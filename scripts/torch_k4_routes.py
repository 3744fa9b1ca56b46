#!/usr/bin/env python3
"""K4's two routes timed against each other across PSF sizes on the card.

    python3 scripts/torch_k4_routes.py [--bs 500] [--img 160] [--psf 51,61,71,...]

For each supersampled PSF size (pool 2, ``img`` x ``img`` images, ``bs``
samples of standard-normal input): builds the half-spectrum DFT chain
(``ops/cuda/dft_conv.py``) and, wherever a block of MIN_FIT_WARPS warps
fits its shared memory (``direct_conv.fits``), the direct strided-sum kernel
(``ops/cuda/direct_conv.py``) for the same random PSF, whatever
``k4_route`` would pick (``route`` in the output says which); checks that
the two routes agree to 1e-4 of the output's max in both directions, and
times each direction of each route with CUDA events. Prints the card's
name and power limit, then one JSON line per size: both routes' ms, the
direct kernel's launch plan at this batch (thread tile, warps per block,
blocks, load path, shared memory), both
algorithms' multiply-adds a sample (the chain's also as its tiles execute
them, forward and transpose) and the function's bound (the cheaper
algorithm's FP32 operations over the FP32 peak). ``k4_route``
(``ops/cuda/direct_conv.py``) compares the two counts; this script's output
is the measurement that rule rests on: it should name the faster route at
every size. Needs a CUDA device.
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
    ap.add_argument("--psf", default="51,61,65,71,75,81,91,101,121,151,175,177,201,261")
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
        row = dict(psf=k, img=h, bs=bs, route=dcv.k4_route(k, k, pool, h, h))
        chain = dc.DFTConv(*dft_factors(kern, (h, h), pool, half=True), device=dev)
        row["half_spectrum"] = list(chain.fwd_mats[4].shape)
        row["direct_macs"] = dcv.direct_macs(h, h, k, k, pool)
        row["chain_macs"] = dc.chain_macs(h, h, k, k, pool)
        row["chain_tile_macs"] = [dc.chain_macs(h, h, k, k, pool, transpose=t, tiles=True)
                                  for t in (False, True)]
        row["bound_ms"] = 1e3 * 2 * bs * min(row["direct_macs"], row["chain_macs"]) / cs.FP32_PEAK
        ku, kv = dcv._sub_shape(k, k, pool)
        direct = dcv.DirectConv(kern, (h, h), pool, dev) if dcv.fits(ku, kv, pool) else None
        if direct is not None:
            row["plans"] = {d: {key: direct.plan(bs, d)[key]
                                for key in ("rows", "cols", "warps", "blocks", "tma", "smem")}
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
