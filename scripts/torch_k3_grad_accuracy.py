#!/usr/bin/env python3
"""K3's accuracy on the cotangent the HMC phase really gives it, on the card.

    python3 scripts/torch_k3_grad_accuracy.py START.pt [--package-root DIR] [--n 50]
        [--spreads 0.2,1,3]

``START.pt`` is an SVI posterior written by ``torch_hmc_start_control.py
start``. For each spread s, draws ``n`` states z = loc + s * L eps (seeded),
runs one backward pass of the bench pipeline's HMC log-density (the exact
path: K2, the FFT conv, the likelihood) and records the arguments K3 is
called with: the physical parameters and the likelihood's cotangent on the
render. It then holds K3's gradient against float64 torch autograd of the
forward twin on those arguments. The cotangent is a residual, so the
gradient is a sum of terms that cancel, unlike chip_smoke's check on a
random cotangent. One JSON line per spread: the largest error per column
relative to the column's largest |gradient| (chip_smoke's measure), the
largest error per sample relative to that sample's gradient norm, and the
count of non-finite entries. ``--package-root`` imports
``gigalens_tpu_torch`` from another checkout, so an older commit's K3 is
measured on the same states and cotangents.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("start")
    ap.add_argument("--package-root", default=str(ROOT))
    ap.add_argument("--n", type=int, default=50)
    ap.add_argument("--spreads", default="0.2,1,3")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.package_root).resolve()))

    import torch

    from gigalens_tpu_torch import bench
    from gigalens_tpu_torch.ops.cuda import fused_render as fr

    pipe = bench.Pipeline(bench.config_from_env(), device="cuda")  # raises without a card
    dev = pipe.device
    start = torch.load(args.start)
    loc, tril = start["loc"].to(dev), start["scale_tril"].to(dev)
    sim = pipe.seq._sim(args.n, exact=True)
    k3 = fr.fused_render_bwd
    calls = []

    def recording(*a):
        calls.append(a)
        return k3(*a)

    for spread in (float(s) for s in args.spreads.split(",")):
        gen = torch.Generator(device=dev).manual_seed(7)
        z = loc + spread * (torch.randn((args.n, loc.shape[-1]), generator=gen, device=dev)
                            @ tril.T)
        z.requires_grad_(True)
        calls.clear()
        fr.fused_render_bwd = recording
        try:
            pipe.prob_model.log_prob(sim, z)[0].sum().backward()
        finally:
            fr.fused_render_bwd = k3
        params, x, y, ox, oy, ct = (t.detach() for t in calls[0][:6])
        niter = calls[0][6]
        g = k3(params, x, y, ox, oy, ct, niter).double()
        want = []
        for i in range(0, args.n, 25):
            p = params[i:i + 25].double().requires_grad_(True)
            out = fr.fused_render_reference(p, x.double(), y.double(), niter)
            want.append(torch.autograd.grad((out * ct[i:i + 25].double()).sum(), p)[0])
        want = torch.cat(want)
        err = (g - want).abs()
        col = err.amax(0) / want.abs().amax(0).clamp_min(1e-300)
        row = err.norm(dim=1) / want.norm(dim=1).clamp_min(1e-300)
        print(json.dumps(dict(
            package=str(Path(fr.__file__).resolve().parents[3]), spread=spread, n=args.n,
            col_rel_max=float(col.max()), col_rel_median=float(col.median()),
            sample_rel_max=float(row.max()), sample_rel_median=float(row.median()),
            nonfinite=int((~torch.isfinite(g)).sum()),
            grad_norm_median=float(want.norm(dim=1).median()))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
