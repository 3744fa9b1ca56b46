"""Why chip_smoke's survey phase runs MAP and HMC as long as it does: the
MAP and HMC settings tried on its catalogue, on the CUDA card.

    python3 scripts/torch_survey_study.py map
    python3 scripts/torch_survey_study.py hmc [--svi-steps 400] [--traj none|chees]
        [--init-l 16] [--windows 2] [--burnin 250] [--results 1250]
        [--prefixes 375,500,750,1000,1250]

``map`` prints the truths' red-chi2 by scene and the best red-chi2 by
scene of ``SurveySequence.MAP`` for seeds 0-2 at 64 x 350, 64 x 700 and
128 x 350 starts x steps. ``hmc`` runs MAP 64 x 700, the per-scene
Laplace and SVI (256 draws a scene) as chip_smoke does, then one grouped
HMC configuration (48 chains a scene, seed 2) and prints its leapfrogs,
host wall, step sizes, divergences, and per scene the max split-R-hat
(with its parameter) and min ESS over the first N results for each
prefix N. The catalogue is ``gigalens_tpu_torch.bench.survey_scene(4)``.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from gigalens_tpu_torch import bench  # noqa: E402
from gigalens_tpu_torch.inference import SurveySequence  # noqa: E402
from gigalens_tpu_torch.inference.sequence import map_optimizer, svi_optimizer  # noqa: E402
from gigalens_tpu_torch.model import SurveyForwardProbModel  # noqa: E402
from gigalens_tpu_torch.utils import effective_sample_size, potential_scale_reduction  # noqa: E402

S, N_STARTS, MAP_STEPS, N_VI, N_HMC = 4, 64, 700, 256, 48


def catalogue(dev):
    prior, phys, cfg, obs = bench.survey_scene(S, 60, 2, dev)
    spm = SurveyForwardProbModel(prior, obs, background_rms=0.2, exp_time=100.0, device=dev)
    return prior, spm, SurveySequence(phys, spm, cfg, device=dev)


def map_study(dev):
    prior, spm, seq = catalogue(dev)
    truths = prior.sample(torch.Generator(device=dev).manual_seed(42), S)
    with torch.no_grad():
        chi = spm.log_prob(seq._sim(S), prior.unconstrain(truths))[1]
    print(f"truth red-chi2 by scene {[round(float(c), 4) for c in chi]}", flush=True)
    for seed in (0, 1, 2):
        for n_starts, steps in ((64, 350), (64, 700), (128, 350)):
            t0 = time.time()
            z = seq.MAP(map_optimizer(steps), n_starts=n_starts, num_steps=steps, seed=seed)
            with torch.no_grad():
                chi = spm.log_prob(seq._sim(S * n_starts), z)[1].reshape(S, -1)
            chi = torch.nan_to_num(chi, nan=float("inf")).amin(1)
            print(f"seed {seed}, {n_starts} starts x {steps} steps ({time.time() - t0:.1f} s): "
                  f"best red-chi2 by scene {[round(float(c), 4) for c in chi]}", flush=True)


def hmc_study(dev, args):
    prior, spm, seq = catalogue(dev)
    names = [f"{g}/{i}/{k}" for g, grp in prior.tree.items() for i, p in enumerate(grp)
             for k in p]
    z = seq.MAP(map_optimizer(MAP_STEPS), n_starts=N_STARTS, num_steps=MAP_STEPS, seed=0)
    best = seq.best_per_scene(z)
    means, trils, _ = seq.SVI(best, svi_optimizer(args.svi_steps), n_vi=N_VI,
                              num_steps=args.svi_steps, init_scales=seq.laplace_scale_trils(best),
                              seed=1)
    torch.cuda.synchronize()
    t0 = time.time()
    res = seq.HMC(means, trils, n_hmc=N_HMC, num_burnin_steps=args.burnin,
                  num_results=args.results, trajectory_adaptation=args.traj,
                  init_l=args.init_l, mass_adaptation=args.windows, seed=2)
    torch.cuda.synchronize()
    wall = time.time() - t0
    print(f"SVI {args.svi_steps} steps; HMC {args.traj} L {args.init_l}, {args.windows} mass "
          f"windows, {args.burnin} + {args.results}: {res.total_leapfrogs} leapfrogs in "
          f"{wall:.1f} s ({1e3 * wall / res.total_leapfrogs:.2f} ms/leapfrog), step sizes "
          f"{[round(float(e), 4) for e in res.step_size]}, divergences "
          f"{res.divergences.reshape(S, -1).sum(1).tolist()}", flush=True)
    for n in [int(p) for p in args.prefixes.split(",")] if args.prefixes else [args.results]:
        chains = res.samples[:n].reshape(n, S, N_HMC, -1)
        rows = []
        for s in range(S):
            rhat = torch.as_tensor(potential_scale_reduction(chains[:, s]))
            ess = torch.as_tensor(effective_sample_size(chains[:, s]))
            rows.append((round(float(rhat.max()), 4), names[int(rhat.argmax())],
                         round(float(ess.min()), 1)))
        print(f"  first {n} results, by scene (max split-R-hat, its parameter, min ESS): {rows}",
              flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("study", choices=["map", "hmc"])
    ap.add_argument("--svi-steps", type=int, default=400)
    ap.add_argument("--traj", default="none", choices=["none", "chees"])
    ap.add_argument("--init-l", type=int, default=16)
    ap.add_argument("--windows", type=int, default=2)
    ap.add_argument("--burnin", type=int, default=250)
    ap.add_argument("--results", type=int, default=1250)
    ap.add_argument("--prefixes", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_survey_study: needs a CUDA device")
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    dev = torch.device("cuda")
    if args.study == "map":
        map_study(dev)
    else:
        hmc_study(dev, args)


if __name__ == "__main__":
    main()
