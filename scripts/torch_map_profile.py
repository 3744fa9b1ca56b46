#!/usr/bin/env python3
"""Where the time of a MAP or HMC step goes on the card (PyTorch/CUDA port).

    python3 scripts/torch_map_profile.py [--family bench|S|L|hmc] [--trace out.json]

``bench``, ``S``, ``L``: builds one of chip_smoke.py's MAP problems at bs=500
(80x80 px, supersample 2): the bench scene (K1-K4), the shapelet-source
family S (K5/K7 and K4) or the lstsq family L (K6/K7 and K4), warms up
with 5 MAP steps, times 10 MAP steps, then runs 10 more under
``torch.profiler``.

``hmc``: runs the bench pipeline's MAP and SVI phases at the ``full``
configuration (``gigalens_tpu_torch.bench``), 2 HMC steps to warm up, then
20 HMC steps (burn-in only, 50 chains, from the SVI surrogate, seed 2)
unprofiled, then the same 20 steps again under ``torch.profiler``.

Prints the wall time per step (and per leapfrog for hmc), the device-busy
share (the profiled window's device kernel and copy time over the
unprofiled wall time; the port runs on one stream, so kernels do not
overlap), and the device time by kernel name. Needs a CUDA device; prints
the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def device_rows(prof):
    """(device us, calls, name) per kernel, device-side events only (a CPU
    op's device time repeats its kernels'), largest first."""
    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    return sorted(((dev_us(e), e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0), reverse=True)


def map_steps(family, steps):
    """Returns (run, label): ``run()`` runs ``steps`` MAP steps and returns
    the number of steps."""
    import torch

    import chip_smoke as cs
    from gigalens_tpu_torch.inference import ModellingSequence, optim

    dev = torch.device("cuda")
    phys, prob, prior, cfg = cs.problem(family)
    seq = ModellingSequence(phys, prob, cfg, device=dev)
    start = prior.unconstrain(prior.sample(torch.Generator(device=dev).manual_seed(0), cs.BS))

    def opt(n):
        return optim.chain(optim.scale_by_adam(), optim.scale_by_schedule(
            optim.polynomial_schedule(-1e-2, -1e-2 / 3, 0.5, n)))

    seq.MAP(opt(5), start=start, n_samples=cs.BS, num_steps=5)  # warm-up

    def run():
        seq.MAP(opt(steps), start=start, n_samples=cs.BS, num_steps=steps)
        return steps

    return run, f"{family}: MAP steps at bs={cs.BS}"


def hmc_steps(steps):
    """Returns (run, label): ``run()`` runs ``steps`` HMC steps of the bench
    pipeline from its SVI surrogate and returns the leapfrogs integrated."""
    from gigalens_tpu_torch import bench

    pipe = bench.Pipeline(dict(bench.CONFIGS["full"], scale="full"), device="cuda")
    pipe.phase_map()
    pipe.phase_svi()

    def run(n=steps):
        res = pipe.seq.HMC(pipe.q_z, n_hmc=pipe.cfg["hmc_n"], num_burnin_steps=n,
                           num_results=0, seed=2)
        return int(res.total_leapfrogs)

    run(2)  # warm-up: first-call costs stay out of the timed windows
    return run, f"hmc: HMC steps at {pipe.cfg['hmc_n']} chains"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", choices=("bench", "S", "L", "hmc"), default="bench")
    ap.add_argument("--trace", type=Path, default=None, help="chrome trace output")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    print(f"card: {cs.card_line()}", flush=True)
    hmc = args.family == "hmc"
    steps = 20 if hmc else 10
    run, label = hmc_steps(steps) if hmc else map_steps(args.family, steps)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_lf = run()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n_lf_prof = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if args.trace is not None:
        args.trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(args.trace))

    rows = device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e6
    print(f"{label}: {steps} steps: wall {1e3 * plain_wall / steps:.3f} ms/step unprofiled, "
          f"{1e3 * wall / steps:.3f} ms/step profiled; device busy "
          f"{1e3 * busy / steps:.3f} ms/step = {100 * busy / plain_wall:.1f}% of the "
          f"unprofiled wall (idle {100 * (1 - busy / plain_wall):.1f}%)")
    if hmc:
        print(f"hmc: {n_lf} leapfrogs unprofiled, {n_lf_prof} profiled: "
              f"{1e3 * plain_wall / max(n_lf, 1):.3f} ms/leapfrog unprofiled, device busy "
              f"{1e3 * busy / max(n_lf_prof, 1):.3f} ms/leapfrog")
    print("device time by kernel (ms/step, calls/step, name):")
    for us, n, key in rows[:20]:
        print(f"  {us / 1e3 / steps:9.3f}  {n / steps:6.1f}  {key[:110]}")


if __name__ == "__main__":
    main()
