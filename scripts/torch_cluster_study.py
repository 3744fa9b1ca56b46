#!/usr/bin/env python3
"""Where config #5's HMC chains part: one arm's full posterior, chain by chain.

    python3 scripts/torch_cluster_study.py [--members dpie|sie] [--source sampled|lstsq]
        [--traj static] [--init-l 8] [--burnin 500] [--results 750] [--mass-windows 1]
        [--seed 3] [--hmc 50] [--jax-truth] [--jax-starts] [--until-svi] [--out DIR]

Runs ``gigalens_tpu_torch.bench.run_cluster`` (the ``--cluster`` pipeline)
with these flags, then prints the JSON row and, per chain: its
acceptance-free movement (the share of results that differ from the
previous draw), its divergences, its mean pixel red-chi2 and log-density
over the last 100 draws, and its means of the three parameters of largest
split-R-hat, against the other chains' median. With ``--out`` it saves
the samples, the per-chain statistics and the truth (unconstrained) to
``DIR/cluster_<members>_<source>[_jax_truth][_jax_starts].npz``. With
``--jax-truth`` the truth is the JAX script's own (``bench.CL_JAX_TRUTH``),
and with ``--jax-starts`` (dpie, sampled source) the MAP starts from the
JAX script's own 128 draws (``bench.CL_JAX_STARTS``, written by
``scripts/cluster_jax_starts.py``) in place of the port's prior draws
from a seeded ``torch.Generator``. Needs a CUDA device unless given
``--device cpu``.
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
    ap.add_argument("--members", default="dpie", choices=["sie", "dpie"])
    ap.add_argument("--source", default="sampled", choices=["sampled", "lstsq"])
    ap.add_argument("--traj", default="static", choices=["chees", "static"])
    ap.add_argument("--init-l", type=int, default=8)
    ap.add_argument("--burnin", type=int, default=500)
    ap.add_argument("--results", type=int, default=750)
    ap.add_argument("--mass-windows", type=int, default=1)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--hmc", type=int, default=50)
    ap.add_argument("--jax-truth", action="store_true",
                    help="the script's own truth (JAX's key-5 draw) in place of the port's "
                         "torch-seeded one")
    ap.add_argument("--jax-starts", action="store_true",
                    help="the MAP from the JAX script's 128 starts (dpie, sampled source)")
    ap.add_argument("--until-svi", action="store_true",
                    help="stop after SVI: print the Laplace factor's diagonal, the SVI losses "
                         "and the share of finite log-densities of the surrogate's draws")
    ap.add_argument("--out", help="directory for the samples and statistics (.npz)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from gigalens_tpu_torch import bench
    from gigalens_tpu_torch.utils import potential_scale_reduction

    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_cluster_study: needs a CUDA device", file=sys.stderr)
        return 1
    truth = bench.CL_JAX_TRUTH[args.members] if args.jax_truth else None
    if args.jax_starts and (args.members, args.source) != ("dpie", "sampled"):
        ap.error("--jax-starts draws the dpie arm's starts (sampled source)")
    start = bench.cluster_jax_starts(args.device) if args.jax_starts else None
    if args.until_svi:
        return until_svi(args, truth, start)
    run = bench.run_cluster(args.members, hmc=args.hmc, burnin=args.burnin,
                            results=args.results, seed=args.seed, traj=args.traj,
                            init_l=args.init_l, mass_windows=args.mass_windows,
                            source=args.source, device=args.device, truth=truth,
                            map_start=start)
    print(json.dumps(run.row), flush=True)
    sc, samples = run.scene, run.samples  # (results, chains, d)
    prior, prob = sc.prior, sc.prob
    n, m, d = samples.shape
    rhat = np.asarray(potential_scale_reduction(samples))
    names = []
    for group, profiles in prior.tree.items():
        for i, p in enumerate(profiles):
            names += [f"{group}[{i}].{k}" for k in sorted(p)]
    names = names if len(names) == d else [f"z{j}" for j in range(d)]
    worst = np.argsort(-rhat)[:3]
    print("split-R-hat by parameter (largest first): " + ", ".join(
        f"{names[j]} {rhat[j]:.3f}" for j in np.argsort(-rhat)[:8]), flush=True)

    last = samples[-100:]
    sim = run._sim(m)
    with torch.no_grad():
        chi2 = torch.stack([prob.stats_pixels(sim, prior.constrain(z))[1] for z in last])
        lp = torch.stack([prob.log_prob(sim, z)[0] for z in last])
    moved = (samples[1:] != samples[:-1]).any(-1).float().mean(0)
    div = run.res.divergences.float()
    means = samples.mean(0)
    med = means.median(0).values
    spread = samples.std(0).median(0).values
    print("chain: moved, divergences, red-chi2, log_prob, then (mean - median) / median "
          "within-chain sd of " + ", ".join(names[j] for j in worst), flush=True)
    for c in range(m):
        dev = [(means[c, j] - med[j]) / spread[j] for j in worst]
        print(f"  {c:3d}: {float(moved[c]):.3f} {int(div[c]):5d} {float(chi2[:, c].mean()):.4f} "
              f"{float(lp[:, c].mean()):10.2f}  " + " ".join(f"{float(v):+7.2f}" for v in dev),
              flush=True)
    truth = dict(sc.truth)
    if sc.source == "lstsq":
        truth["source_light"] = [{k: v for k, v in truth["source_light"][0].items()
                                  if k in ("beta", "center_x", "center_y")}]
    if not args.out:
        return 0
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    tag = ("_jax_truth" if args.jax_truth else "") + ("_jax_starts" if args.jax_starts else "")
    np.savez(out / f"cluster_{args.members}_{args.source}{tag}.npz", samples=samples.cpu().numpy(),
             rhat=rhat, moved=moved.cpu().numpy(), divergences=div.cpu().numpy(),
             chi2=chi2.cpu().numpy(), log_prob=lp.cpu().numpy(), names=np.array(names),
             z_truth=prior.unconstrain(truth).cpu().numpy())
    return 0


def until_svi(args, truth, start):
    """MAP, the FD Laplace and SVI of the ``--cluster`` pipeline, with what
    SVI starts from and what it does printed."""
    import numpy as np
    import torch

    from gigalens_tpu_torch import bench

    sc = bench.cluster_scene(args.members, seed=args.seed, source=args.source,
                             device=args.device, truth=truth)
    run = bench.ClusterRun(sc, device=args.device)
    run.phase_map(start=start)
    run.phase_svi()
    lps = torch.where(torch.isnan(run.lps), -torch.inf, run.lps)
    print(f"best start log_prob {float(lps.max()):.3f}, {int(torch.isnan(run.lps).sum())} NaN "
          f"of {lps.shape[0]}; Laplace factor finite {bool(np.isfinite(run.L0).all())}, "
          f"diagonal {np.round(np.diag(run.L0), 5).tolist()}", flush=True)
    print("SVI losses every 40 steps: " + ", ".join(f"{float(v):.2f}" for v in run.losses[::40]),
          flush=True)
    q = run.q_z
    z = q.sample(torch.Generator(device=run.device).manual_seed(0), 256)
    with torch.no_grad():
        lp = sc.prob.log_prob(run._sim(256), z)[0]
    print(f"surrogate: mean finite {bool(torch.isfinite(q.mean()).all())}, scale_tril finite "
          f"{bool(torch.isfinite(q.scale_tril).all())}, finite log_prob at {int(torch.isfinite(lp).sum())}"
          f" of 256 draws", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
