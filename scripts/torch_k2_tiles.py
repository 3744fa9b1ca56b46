#!/usr/bin/env python3
"""Times K1/K2 (csrc/fused_render.cu) on the card for each number of pixel
tiles a block may walk, at the bench scene's three batch sizes.

    python3 scripts/torch_k2_tiles.py [--bs 500,1000,50] [--reps 20]

Inputs are bench-prior draws on the bench camera's 25,600 supersampled
pixels at niter 23, as chip_smoke.py's kernel checks take them. The C
entry point is called directly with each tile count (the wrapper would
pick ``fused_render.fwd_tiles``); every variant must give the first one's
bits. One JSON line per (kernel, bs, tiles) with the CUDA-event mean, the
tile count the wrapper picks, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bs", default="500,1000,50")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    from gigalens_tpu_torch import bench
    from gigalens_tpu_torch.ops.cuda import _build
    from gigalens_tpu_torch.ops.cuda import fused_render as fr
    from gigalens_tpu_torch.simulator import LensSimulator

    if not torch.cuda.is_available():
        print("torch_k2_tiles: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    phys, cfg, niter = bench.bench_scene(80)
    sim = LensSimulator(phys, cfg, bs=1, device=dev)
    x, y = sim.img_x, sim.img_y
    npix = x.shape[0]
    lib, ptr = _build.load(), _build.ptr

    def launch(params, bufs, save_omega, tiles):
        err = lib.gl_fused_render_fwd(ptr(params), ptr(x), ptr(y), *(ptr(b) for b in bufs),
                                      params.shape[0], npix, niter, int(save_omega), tiles,
                                      _build.stream(dev))
        _build.check(err, "fused_render_fwd")

    for bs in (int(b) for b in args.bs.split(",")):
        gen = torch.Generator(device=dev).manual_seed(0)
        params = fr.pack_params(bench.bench_prior().sample(gen, bs)).contiguous()
        first = None
        for save_omega in (True, False):
            for tiles in (1, 2, 4, 8, 16):
                bufs = [torch.empty((bs, npix), device=dev) for _ in range(3)]
                for _ in range(3):
                    launch(params, bufs, save_omega, tiles)
                torch.cuda.synchronize()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for _ in range(args.reps):
                    launch(params, bufs, save_omega, tiles)
                end.record()
                end.synchronize()
                if first is None:
                    first = bufs
                same = all(torch.equal(a, b) for a, b in
                           zip(first[:3 if save_omega else 1], bufs))
                if not same:
                    raise AssertionError(f"tiles={tiles} changes the result's bits")
                print(json.dumps(dict(
                    kernel="K2" if save_omega else "K1", bs=bs, npix=npix, niter=niter,
                    tiles=tiles, ms=start.elapsed_time(end) / args.reps,
                    picked=fr.fwd_tiles(bs, npix), card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
