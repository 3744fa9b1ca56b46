"""Survey mode at production settings on the port (the counterpart of
``scripts/bench_survey_production.py``).

S >= 4 scenes with distinct per-scene PSFs, 60x60 @ 0.065"/px supersample
2, scene-batched MAP -> per-scene Laplace + SVI -> grouped HMC through
``gigalens_tpu_torch.inference.SurveySequence`` on the CUDA card (MAP and
SVI convolve with the direct K4 once a scene, HMC with ``torch.fft``).
Same catalogue (``gigalens_tpu_torch.bench.survey_scene``), knobs and JSON
keys as the JAX script; ``device`` is the card's name.

Gates (printed + JSON): every scene's posterior-mean reduced chi2 in
[0.85, 1.15]; every scene's max split-R-hat <= 1.02.

    python3 scripts/torch_survey_production.py [--scenes 4] [--cpu-quick]
"""
import argparse
import json
import os as _os
import sys as _sys
import time

_REPO_ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
if _REPO_ROOT not in _sys.path:
    _sys.path.insert(0, _REPO_ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gigalens_tpu_torch.bench import survey_scene  # noqa: E402
from gigalens_tpu_torch.inference import SurveySequence  # noqa: E402
from gigalens_tpu_torch.inference.optim import (  # noqa: E402
    chain, polynomial_schedule, scale_by_adam, scale_by_schedule,
)
from gigalens_tpu_torch.model import SurveyForwardProbModel  # noqa: E402
from gigalens_tpu_torch.simulator import LensSimulator  # noqa: E402
from gigalens_tpu_torch.utils import effective_sample_size, potential_scale_reduction  # noqa: E402


def log(msg):
    print(msg, file=_sys.stderr, flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--scenes", type=int, default=4)
    parser.add_argument("--hmc", type=int, default=16)
    parser.add_argument("--burnin", type=int, default=200)
    parser.add_argument("--results", type=int, default=500)
    parser.add_argument("--traj", default="static", choices=["chees", "static"],
                        help="static avoids the ChEES trajectory collapse the JAX package "
                             "measured at small per-scene chain counts")
    parser.add_argument("--init-l", type=int, default=10)
    parser.add_argument("--cpu-quick", action="store_true")
    args = parser.parse_args(argv)

    if args.cpu_quick:
        device = torch.device("cpu")
        num_pix, ss = 24, 1
        map_n, map_steps = 8, 40
        vi_n, vi_steps = 8, 30
        n_hmc, burnin, results = 4, 20, 40
    else:
        if not torch.cuda.is_available():
            raise SystemExit("torch_survey_production: no CUDA device (use --cpu-quick on the CPU)")
        device = torch.device("cuda")
        num_pix, ss = 60, 2
        map_n, map_steps = 64, 350
        vi_n, vi_steps = 256, 400
        n_hmc, burnin, results = args.hmc, args.burnin, args.results

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    S = args.scenes
    prior, phys, cfg, obs = survey_scene(S, num_pix, ss, device)
    log(f"catalogue: {S} scenes {num_pix}px ss{ss}, distinct PSFs {cfg.kernel.shape}")
    spm = SurveyForwardProbModel(prior, obs, background_rms=0.2, exp_time=100.0, device=device)
    seq = SurveySequence(phys, spm, cfg, device=device)

    t0 = time.time()
    opt = chain(scale_by_adam(), scale_by_schedule(
        polynomial_schedule(-1e-2, -1e-2 / 3, 0.5, map_steps)))
    z = seq.MAP(opt, n_starts=map_n, num_steps=map_steps, seed=0)
    best = seq.best_per_scene(z)
    sync()
    t_map = time.time() - t0
    log(f"MAP {t_map:.1f}s")

    t0 = time.time()
    L0 = seq.laplace_scale_trils(best)
    opt2 = chain(scale_by_adam(), scale_by_schedule(
        polynomial_schedule(-1e-6, -3e-3, 2, max(vi_steps // 5, 1))))
    means, trils, losses = seq.SVI(best, opt2, n_vi=vi_n, num_steps=vi_steps, init_scales=L0,
                                   seed=1)
    sync()
    t_svi = time.time() - t0
    log(f"SVI {t_svi:.1f}s")

    t0 = time.time()
    res = seq.HMC(means, trils, n_hmc=n_hmc, num_burnin_steps=burnin, num_results=results,
                  seed=2, segment_steps=250, trajectory_adaptation=args.traj,
                  init_l=args.init_l, mass_adaptation=2)
    sync()
    t_hmc = time.time() - t0
    log(f"HMC {t_hmc:.1f}s")

    T, n, d = res.samples.shape
    C = n // S
    chains = res.samples.reshape(T, S, C, d)
    rows = []
    for s in range(S):
        zs = chains[:, s]  # (T, C, d): the chain axis kept for R-hat
        rows.append(dict(scene=s, min_ess=float(effective_sample_size(zs).min()),
                         max_rhat=float(potential_scale_reduction(zs).max())))
    post_means = chains.reshape(T, S, C, d).transpose(0, 1).reshape(S, T * C, d).mean(1)
    sim_post = LensSimulator(phys, cfg, bs=S, device=device)
    with torch.no_grad():
        chi2 = spm.log_prob(sim_post, post_means)[1].cpu().numpy()
    eps = np.asarray(res.step_size.cpu())
    for s in range(S):
        rows[s]["posterior_red_chi2"] = float(chi2[s])
        rows[s]["eps"] = float(eps[s])
        rows[s]["gates"] = dict(chi2_ok=bool(0.85 <= chi2[s] <= 1.15),
                                rhat_ok=bool(rows[s]["max_rhat"] <= 1.02))
        log(f"scene {s}: chi2 {chi2[s]:.3f} maxRhat {rows[s]['max_rhat']:.3f} "
            f"minESS {rows[s]['min_ess']:.0f} gates {rows[s]['gates']}")

    total = t_map + t_svi + t_hmc
    all_ok = all(r["gates"]["chi2_ok"] and r["gates"]["rhat_ok"] for r in rows)
    print(json.dumps({
        "metric": "survey_production",
        "unit": "s",
        "value": round(total, 2),
        "per_scene_s": round(total / S, 2),
        "phase_s": dict(map=round(t_map, 2), svi=round(t_svi, 2), hmc=round(t_hmc, 2)),
        "scenes": rows,
        "all_gates_pass": all_ok,
        "device": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
    }))


if __name__ == "__main__":
    main()
