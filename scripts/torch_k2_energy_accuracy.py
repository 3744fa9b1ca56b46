#!/usr/bin/env python3
"""K2's accuracy where the HMC phase feels it: in its energy, on the card.

    python3 scripts/torch_k2_energy_accuracy.py START.pt [--package-root DIR] [--n 50]
        [--spreads 0.2,1,3,10,30]

``START.pt`` is an SVI posterior written by ``torch_hmc_start_control.py
start``. For each spread s, draws ``n`` states z = loc + s * L eps (seeded)
and evaluates the bench pipeline's HMC log-density (the exact path: K2, the
FFT conv, the likelihood) twice: with K2's float32 image, and with the
float64 one-stage reference's image rounded to float32 in its place (the
best image float32 can hold; everything downstream is the same code). The
difference is what K2's arithmetic adds to the energy, in nats, the unit
Metropolis acceptance is made of. One JSON line per spread: the largest and
median |difference| per chain, the same relative to |log-density|, the
image's largest error relative to the sample's largest pixel, and the
count of non-finite log-densities. ``--package-root`` imports
``gigalens_tpu_torch`` from another checkout, so an older commit's K2 is
measured on the same states.
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
    ap.add_argument("--spreads", default="0.2,1,3,10,30")
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
    k2 = fr.fused_render_fwd
    images = {}

    def kernel(params, x, y, niter, save_omega=False):
        res = k2(params, x, y, niter, save_omega=save_omega)
        images["kernel"] = (res[0] if save_omega else res).detach()
        return res

    def reference(params, x, y, niter, save_omega=False):
        res = k2(params, x, y, niter, save_omega=save_omega)
        with torch.no_grad():
            p64 = params.detach().double()
            ref = torch.cat([fr.fused_render_reference(p64[i:i + 25], x.double(), y.double(),
                                                       niter)
                             for i in range(0, p64.shape[0], 25)])
        images["reference"] = ref
        return (ref.float(), *res[1:]) if save_omega else ref.float()

    for spread in (float(s) for s in args.spreads.split(",")):
        gen = torch.Generator(device=dev).manual_seed(7)
        z = loc + spread * (torch.randn((args.n, loc.shape[-1]), generator=gen, device=dev)
                            @ tril.T)
        z.requires_grad_(True)  # as the leapfrog calls it: K2, not K1
        lps = {}
        for name, fn in (("kernel", kernel), ("reference", reference)):
            fr.fused_render_fwd = fn
            try:
                lps[name] = pipe.prob_model.log_prob(sim, z)[0].detach().double()
            finally:
                fr.fused_render_fwd = k2
        ok = torch.isfinite(lps["kernel"]) & torch.isfinite(lps["reference"])
        d = (lps["kernel"] - lps["reference"]).abs()[ok]
        rel = d / lps["reference"].abs()[ok].clamp_min(1e-300)
        img_err = (images["kernel"].double() - images["reference"]).abs().amax(1)
        img_rel = (img_err / images["reference"].abs().amax(1).clamp_min(1e-300))[ok]
        print(json.dumps(dict(
            package=str(Path(fr.__file__).resolve().parents[3]), spread=spread, n=args.n,
            abs_max=float(d.max()), abs_median=float(d.median()),
            rel_max=float(rel.max()), rel_median=float(rel.median()),
            image_rel_max=float(img_rel.max()), image_rel_median=float(img_rel.median()),
            nonfinite_kernel=int((~torch.isfinite(lps["kernel"])).sum()),
            nonfinite_reference=int((~torch.isfinite(lps["reference"])).sum()),
            log_prob_median=float(lps["reference"][ok].median()))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
