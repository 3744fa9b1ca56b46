#!/usr/bin/env python3
"""Where config #5's HMC chains part: one arm's full posterior, chain by chain.

    python3 scripts/torch_cluster_study.py [--members dpie|sie] [--source sampled|lstsq]
        [--traj static] [--init-l 8] [--burnin 500] [--results 750] [--mass-windows 1]
        [--seed 3] [--hmc 50] [--jax-truth] [--until-svi] [--out DIR]

Runs ``gigalens_tpu_torch.bench.run_cluster`` (the ``--cluster`` pipeline)
with these flags, then prints the JSON row and, per chain: its
acceptance-free movement (the share of results that differ from the
previous draw), its divergences, its mean pixel red-chi2 and log-density
over the last 100 draws, and its means of the three parameters of largest
split-R-hat, against the other chains' median. With ``--out`` it saves
the samples, the per-chain statistics and the truth (unconstrained) to
``DIR/cluster_<members>_<source>[_jax_truth].npz``. Needs a CUDA device
unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


# the truth of scripts/bench_cluster_posterior.py's own rows: its prior's
# draw at jax.random.PRNGKey(5) (:167), copied as float32 values (BASELINE.md's
# theta_E* 0.352 sie, 0.358 dpie). The halo is the same draw in both arms;
# the truth traces one image, so the script's fits take no positions.
_HALO = dict(Rs=10.866031646728516, alpha_Rs=2.644106864929199, center_x=0.8548650741577148,
             center_y=-0.6076276898384094, e1=0.09020333737134933, e2=-0.09072451293468475)
_AMPS = [2.946794271469116, -2.8893816471099854, -2.1054301261901855, -7.293202877044678,
         1.8643121719360352, 7.970737934112549, -4.233013153076172, 4.726140022277832,
         3.0026659965515137, 6.797476768493652, 3.4189019203186035, -6.829867839813232,
         5.9823713302612305, 1.372706413269043, 8.919219017028809, -7.258894920349121]
JAX_TRUTH = dict(
    sie=dict(lens_mass=[_HALO, dict(theta_E=0.3515036106109619)],
             source_light=[dict({f"amp{i:02d}": a for i, a in enumerate(_AMPS[:15])},
                                beta=0.2991989552974701, center_x=0.2494579255580902,
                                center_y=-0.3853776752948761)]),
    dpie=dict(lens_mass=[_HALO, dict(r_cut=1.667107343673706, theta_E=0.35802045464515686)],
              source_light=[dict({f"amp{i:02d}": a for i, a in enumerate(_AMPS[1:])},
                                 beta=0.47237342596054077, center_x=-0.3853776752948761,
                                 center_y=-0.3011828660964966)]))


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
    truth = JAX_TRUTH[args.members] if args.jax_truth else None
    if args.until_svi:
        return until_svi(args, truth)
    run = bench.run_cluster(args.members, hmc=args.hmc, burnin=args.burnin,
                            results=args.results, seed=args.seed, traj=args.traj,
                            init_l=args.init_l, mass_windows=args.mass_windows,
                            source=args.source, device=args.device,
                            truth=truth)
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
    tag = "_jax_truth" if args.jax_truth else ""
    np.savez(out / f"cluster_{args.members}_{args.source}{tag}.npz", samples=samples.cpu().numpy(),
             rhat=rhat, moved=moved.cpu().numpy(), divergences=div.cpu().numpy(),
             chi2=chi2.cpu().numpy(), log_prob=lp.cpu().numpy(), names=np.array(names),
             z_truth=prior.unconstrain(truth).cpu().numpy())
    return 0


def until_svi(args, truth):
    """MAP, the FD Laplace and SVI of the ``--cluster`` pipeline, with what
    SVI starts from and what it does printed."""
    import numpy as np
    import torch

    from gigalens_tpu_torch import bench
    from gigalens_tpu_torch.inference.sequence import svi_optimizer

    sc = bench.cluster_scene(args.members, seed=args.seed, source=args.source,
                             device=args.device, truth=truth)
    run = bench.ClusterRun(sc, device=args.device)
    run.phase_map()
    lps = torch.where(torch.isnan(run.lps), -torch.inf, run.lps)
    best = run.z_map[torch.argmax(lps)][None, :]
    L0 = run.seq.laplace_scale_tril(best)
    print(f"best start log_prob {float(lps.max()):.3f}, {int(torch.isnan(run.lps).sum())} NaN "
          f"of {lps.shape[0]}; Laplace factor finite {bool(np.isfinite(L0).all())}, diagonal "
          f"{np.round(np.diag(L0), 5).tolist()}", flush=True)
    steps = bench.CL_DEPTHS["vi_steps"]
    q, losses = run.seq.SVI(best, svi_optimizer(steps), n_vi=bench.CL_DEPTHS["vi_n"],
                            num_steps=steps, init_scales=L0, seed=1)
    print("SVI losses every 40 steps: " + ", ".join(f"{float(v):.2f}" for v in losses[::40]),
          flush=True)
    z = q.sample(torch.Generator(device=run.device).manual_seed(0), 256)
    with torch.no_grad():
        lp = sc.prob.log_prob(run._sim(256), z)[0]
    print(f"surrogate: mean finite {bool(torch.isfinite(q.mean()).all())}, scale_tril finite "
          f"{bool(torch.isfinite(q.scale_tril).all())}, finite log_prob at {int(torch.isfinite(lp).sum())}"
          f" of 256 draws", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
