#!/usr/bin/env python3
"""Where a cold process's start goes on the card (host clock, each step
ending in a CUDA synchronize).

    python3 scripts/torch_cold_start.py [--out DIR]

Run it twice in a fresh machine: the first process also builds the kernel
library (``nvcc``), the second finds it under ``build/kernels/`` and is
the cold start a user pays in a new process. In order, each timed alone:

1. ``import torch``, then ``import gigalens_tpu_torch.bench``;
2. the kernel library: its key and build (``_build.build``, with the
   seconds spent compiling), then its load (``_build.load``, ctypes);
3. the first CUDA work: the context (a one-element tensor), the first
   cuBLAS GEMM (its handle), the first cuSOLVER call (a float32
   Cholesky) and the lstsq solve's float64 pseudo-inverse (the Jacobi
   kernel, ``ops/cuda/gram_pinv.py``);
4. config #5's series precompute (``bench.cluster_members("dpie")``,
   order 3, on the 48-px scene's supersampled grid), split into its member
   chunks (members 0-15 and 16-19, ``DPIESubhaloSeries`` on each
   sub-catalogue: each chunk's nested ``torch.func.jvp`` calls), then the
   whole stack twice more (warm);
5. the first and second call of each phase's log-density and gradient on
   config #5's dpie scene: MAP (bs 128, the builder tier and the direct
   K4), SVI (bs 256), HMC (bs 50, the exact path) and the FD Laplace; and
   the sie arm's lstsq MAP (bs 128, unfused members).

Prints the card's name and power limit, one line a step and a JSON line,
also written to ``DIR/cold_start[_<n>].json`` with ``--out`` (the first
free ``n``).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="directory for cold_start.json")
    args = ap.parse_args(argv)
    rows = []

    def mark(name, t0, **extra):
        rows.append(dict(step=name, s=time.perf_counter() - t0, **extra))
        print(f"cold start: {name}: {rows[-1]['s']:.3f} s {extra or ''}", flush=True)

    t = time.perf_counter()
    import torch

    mark("import torch", t, since_process_start=time.perf_counter() - T_START)
    if not torch.cuda.is_available():
        print("torch_cold_start: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=30).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    sync = torch.cuda.synchronize

    t = time.perf_counter()
    from gigalens_tpu_torch import bench

    mark("import gigalens_tpu_torch.bench", t)
    from gigalens_tpu_torch.ops.cuda import _build
    from gigalens_tpu_torch.ops.cuda.gram_pinv import gram_pinv

    t = time.perf_counter()
    path, secs, _ = _build.build()
    mark("kernel library: key and build", t, compile_s=secs, library=path.name)
    t = time.perf_counter()
    _build.load()
    mark("kernel library: load", t)

    t = time.perf_counter()
    torch.zeros(1, device=dev)
    sync()
    mark("CUDA context", t)
    t = time.perf_counter()
    a = torch.randn(256, 256, device=dev)
    b = a @ a.T
    sync()
    mark("first cuBLAS GEMM", t)
    t = time.perf_counter()
    spd = b + 256 * torch.eye(256, device=dev)
    torch.linalg.cholesky(spd)
    gram_pinv(spd[:15, :15].double().expand(4, 15, 15), 1e-6)
    sync()
    mark("first cuSOLVER call and pseudo-inverse", t)

    from gigalens_tpu_torch import PhysicalModel, SimulatorConfig
    from gigalens_tpu_torch.profiles.light import Shapelets
    from gigalens_tpu_torch.profiles.mass import NFW_ELLIPSE, DPIESubhaloSeries
    from gigalens_tpu_torch.simulator import LensSimulator

    members = bench.cluster_members("dpie")
    cfg = SimulatorConfig(delta_pix=bench.CL_DELTA, num_pix=bench.CL_DEPTHS["num_pix"],
                          supersample=2, kernel=bench.cluster_psf())
    probe = LensSimulator(PhysicalModel([NFW_ELLIPSE(), members], [], [Shapelets(bench.CL_NMAX)]),
                          cfg, bs=1, device=dev)
    cat = bench.cluster_catalogue(20)
    for lo, hi in ((0, 16), (16, 20)):
        sub = DPIESubhaloSeries(lum_star=1.0, galaxy_catalogue={k: v[lo:hi] for k, v in
                                                                cat.items()},
                                order=bench.CL_ORDER, chunk_size=16)
        sub.set_constants(bench.CL_CONSTS)
        sub.set_grid(probe.img_x, probe.img_y)
        t = time.perf_counter()
        sub.set_deriv()
        sync()
        mark(f"series precompute, members {lo}-{hi - 1} (first)", t)
    members.set_constants(bench.CL_CONSTS)
    members.set_grid(probe.img_x, probe.img_y)
    for call in ("second", "third"):
        t = time.perf_counter()
        members.set_deriv()
        sync()
        mark(f"series precompute, all 20 members ({call} call)", t)

    sc = bench.cluster_scene("dpie", device=dev)
    run = bench.ClusterRun(sc, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for phase, bs, exact in (("MAP", 128, False), ("SVI", 256, False), ("HMC", 50, True)):
        sim = run.seq._sim(bs, exact=exact)
        z0 = sc.prior.unconstrain(sc.prior.sample(gen, bs))
        for call in (1, 2):
            t = time.perf_counter()
            z = z0.clone().requires_grad_(True)
            lp = sc.prob.log_prob(sim, z)[0]
            torch.autograd.grad(lp.sum(), z)
            sync()
            mark(f"dpie {phase} log-density + gradient, bs {bs}, call {call}", t)
    best = sc.prior.unconstrain(sc.truth)
    for call in (1, 2):
        t = time.perf_counter()
        run.seq.laplace_scale_tril(best)
        sync()
        mark(f"dpie FD Laplace, call {call}", t)
    sie = bench.cluster_scene("sie", source="lstsq", device=dev)
    sim = bench.ClusterRun(sie, device=dev).seq._sim(128)
    z0 = sie.prior.unconstrain(sie.prior.sample(gen, 128))
    for call in (1, 2):
        t = time.perf_counter()
        z = z0.clone().requires_grad_(True)
        lp = sie.prob.log_prob(sim, z)[0]
        torch.autograd.grad(lp.sum(), z)
        sync()
        mark(f"sie lstsq MAP log-density + gradient, bs 128, call {call}", t)
    res = dict(card=card, process_s=time.perf_counter() - T_START, steps=rows)
    print(json.dumps(res), flush=True)
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        n = 0
        while (out / f"cold_start{'_' + str(n) if n else ''}.json").exists():
            n += 1
        (out / f"cold_start{'_' + str(n) if n else ''}.json").write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
