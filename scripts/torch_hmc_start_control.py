#!/usr/bin/env python3
"""Separates the two inputs of the bench pipeline's HMC phase on the card:
its start (the SVI posterior that MAP and SVI produce) and the kernels the
sampler runs.

    python3 scripts/torch_hmc_start_control.py start OUT.pt [--package-root DIR]
    python3 scripts/torch_hmc_start_control.py hmc START.pt [--seeds 2,3,4] [--package-root DIR]
    python3 scripts/torch_hmc_start_control.py diff START.pt OTHER.pt

``start`` runs the bench pipeline's MAP and SVI phases (``bench`` full
settings, or ``GIGALENS_BENCH_SCALE``) and writes the SVI posterior's
``loc`` and ``scale_tril``. ``hmc`` runs the pipeline's HMC phase, seed by
seed, from a saved start, and prints one JSON line per seed: wall, leapfrogs,
adapted step size, min-ESS, max split-R-hat and post-adaptation divergences.
``diff`` prints how far two starts lie apart: the largest difference of
their means in units of the first's marginal scales, and the range of the
ratio of their marginal scales.
``--package-root`` imports ``gigalens_tpu_torch`` from another checkout (an
older commit unpacked with ``git archive``), so one call can cross either
commit's start with either commit's kernels. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("start", "hmc", "diff"))
    ap.add_argument("path")
    ap.add_argument("other", nargs="?")
    ap.add_argument("--seeds", default="2,3,4")
    ap.add_argument("--package-root", default=str(ROOT))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.package_root).resolve()))

    import numpy as np
    import torch

    from gigalens_tpu_torch import bench
    from gigalens_tpu_torch.prob.distributions import MultivariateNormalTriL
    from gigalens_tpu_torch.utils import effective_sample_size, potential_scale_reduction

    if args.what == "diff":
        a, b = torch.load(args.path), torch.load(args.other)
        sa = a["scale_tril"].double().pow(2).sum(-1).sqrt()
        sb = b["scale_tril"].double().pow(2).sum(-1).sqrt()
        r = sb / sa
        print(json.dumps(dict(max_mean_shift=float(((b["loc"] - a["loc"]).double().abs() / sa).max()),
                              scale_ratio_min=float(r.min()), scale_ratio_max=float(r.max()))))
        return 0
    print(f"package: {Path(bench.__file__).resolve().parents[1]}", flush=True)
    cfg = bench.config_from_env()
    pipe = bench.Pipeline(cfg, device="cuda")  # raises without a card
    if args.what == "start":
        pipe.phase_map()
        pipe.phase_svi()
        torch.save({"loc": pipe.q_z.mean().cpu(), "scale_tril": pipe.q_z.scale_tril.cpu()},
                   args.path)
        return 0

    start = torch.load(args.path)
    q_z = MultivariateNormalTriL(start["loc"], start["scale_tril"], device=pipe.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = pipe.seq.HMC(q_z, n_hmc=cfg["hmc_n"], num_burnin_steps=cfg["burnin"],
                           num_results=cfg["results"], seed=seed)
        bench._sync(pipe.device)
        t = time.perf_counter() - t0
        print(json.dumps(dict(
            start=args.path, seed=seed, t=t, leapfrogs=int(res.total_leapfrogs),
            eps=float(res.step_size),
            min_ess=float(effective_sample_size(res.samples).min()),
            max_rhat=float(potential_scale_reduction(res.samples).max()),
            divergences=int(res.divergences.sum()),
            accept=float(np.mean(res.accept_rate[-100:].cpu().numpy())))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
