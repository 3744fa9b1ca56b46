#!/usr/bin/env python3
"""Where the time of a MAP step goes on the card (PyTorch/CUDA port).

    python3 scripts/torch_map_profile.py [--trace out.json]

Builds chip_smoke.py's bench scene (bs=500, 80x80 px, supersample 2),
warms up, times 10 MAP steps, then runs 10 more under ``torch.profiler``
and prints: the wall time per step, the device-busy share (the profiled
window's device kernel and copy time over the unprofiled wall time; the
port runs on one stream, so kernels do not overlap), and the device time
by kernel name. Needs a CUDA
device; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STEPS = 10
sys.path.insert(0, str(ROOT))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", type=Path, default=None, help="chrome trace output")
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from gigalens_tpu_torch.inference import ModellingSequence, optim
    from gigalens_tpu_torch.model import ForwardProbModel
    from gigalens_tpu_torch.simulator import LensSimulator

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    print(f"card: {cs.card_line()}", flush=True)
    dev = torch.device("cuda")
    phys, cfg, _ = cs.bench_scene()
    prior = cs.bench_prior()
    truth = prior.sample(torch.Generator(device=dev).manual_seed(42), 1)
    img = LensSimulator(phys, cfg, bs=1, device=dev).simulate(truth)
    prob = ForwardProbModel(prior, img.cpu().numpy(), background_rms=0.2, exp_time=100.0,
                            device=dev)
    seq = ModellingSequence(phys, prob, cfg, device=dev)
    start = prior.unconstrain(prior.sample(torch.Generator(device=dev).manual_seed(0), cs.BS))

    def opt(n):
        return optim.chain(optim.scale_by_adam(), optim.scale_by_schedule(
            optim.polynomial_schedule(-1e-2, -1e-2 / 3, 0.5, n)))

    seq.MAP(opt(5), start=start, n_samples=cs.BS, num_steps=5)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq.MAP(opt(STEPS), start=start, n_samples=cs.BS, num_steps=STEPS)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        seq.MAP(opt(STEPS), start=start, n_samples=cs.BS, num_steps=STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if args.trace is not None:
        args.trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(args.trace))

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side events only: a CPU op's device time repeats its kernels'
    rows = [(dev_us(e), e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    print(f"{STEPS} MAP steps at bs={cs.BS}: wall {1e3 * plain_wall / STEPS:.3f} "
          f"ms/step unprofiled, {1e3 * wall / STEPS:.3f} ms/step profiled; device busy "
          f"{1e3 * busy / STEPS:.3f} ms/step = {100 * busy / plain_wall:.1f}% of the "
          f"unprofiled wall (idle {100 * (1 - busy / plain_wall):.1f}%)")
    print("device time by kernel (ms/step, calls/step, name):")
    for us, n, key in rows[:20]:
        print(f"  {us / 1e3 / STEPS:9.3f}  {n / STEPS:6.1f}  {key[:110]}")


if __name__ == "__main__":
    main()
