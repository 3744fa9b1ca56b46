#!/usr/bin/env python3
"""The direct K4 at every shape the port launches it, for an A/B of two
checkouts on one card, and a sweep of its launch plans.

    python3 scripts/torch_k4_ab.py --out FILE [--package-root DIR] [--sweep]
    python3 scripts/torch_k4_ab.py --compare FILE [FILE ...]

Runs ``gigalens_tpu_torch``'s direct K4 (``ops/cuda/direct_conv.py``),
imported from ``--package-root`` (default: this checkout), both directions
at each shape of SHAPES (the table in ``PERF.md`` section 6: bench MAP and
SVI, the inversion's chunk, the composite demo's MAP and SVI, one survey
scene, config #5's sie lstsq MAP and dpie SVI / MAP, the multi-plane
demo's MAP, and the ragged shapes of ``chip_smoke.py``) on seeded inputs
drawn on the card with a random positive PSF: times each call with CUDA
events, hashes its output (canonical zeros) so that two checkouts can be
held bit for bit, and times one PyTorch call of the same function beside it
(``F.conv2d`` / ``F.conv_transpose2d`` with the pooled kernel, cuDNN without
TF32; a yardstick only). Writes one JSON line a shape and direction to
FILE, with the launch plan the checkout took and the function's bound (the
larger of its FP32 operations over 67 TFLOP/s and its bytes over 3.35
TB/s). ``--sweep`` also times every tile choice of the plan rule
(``direct_conv.tile_choices``, every thread tile of ``VARIANTS``, 1, 2 and
every load buffer, by TMA and by 4-byte copies), each held bit for bit to
the default plan's output. ``--compare`` prints the checkouts' rows side by side: ms of each
(the mean over the files of one checkout, named by the file's stem less
its digits, the first checkout named first), the first's over the second's,
and whether the hashes agree. Prints the card's name and power limit first. Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (label, bs, image side, supersampled PSF side, pool)
SHAPES = (
    ("bench MAP", 500, 160, 51, 2), ("bench SVI", 1000, 160, 51, 2),
    ("inversion chunk", 1536, 128, 19, 2), ("composite MAP", 256, 128, 27, 2),
    ("composite SVI", 200, 128, 27, 2), ("survey scene", 64, 120, 27, 2),
    ("sie lstsq MAP", 1920, 96, 19, 2), ("cluster SVI", 256, 96, 19, 2),
    ("cluster MAP", 128, 96, 19, 2), ("multi-plane MAP", 128, 48, 11, 2),
    ("ragged 170", 2, 170, 51, 2), ("ragged 40", 3, 40, 13, 2), ("pool 3", 3, 42, 9, 3),
    ("pool 1", 2, 50, 9, 1),
)
FP32_PEAK, HBM_RATE = 67e12, 3.35e12


def card_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20, warmup=3):
    """Mean ms a call from CUDA events around ``reps`` calls queued behind
    a ~10 ms spin, so that the events time the device, not the enqueue."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def digest(t):
    return hashlib.sha256((t + 0.0).contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def run(args):
    sys.path.insert(0, str(Path(args.package_root).resolve()))
    import numpy as np
    import torch
    import torch.nn.functional as F

    from gigalens_tpu_torch.ops.cuda import _build
    from gigalens_tpu_torch.ops.cuda import direct_conv as dcv
    from gigalens_tpu_torch.ops.cuda.dft_conv import chain_macs

    if not torch.cuda.is_available():
        print("torch_k4_ab: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; package {dcv.__file__}", flush=True)
    _, secs, log = _build.build(verbose=True)
    print(f"build {secs:.1f} s", flush=True)
    for line in log.splitlines():
        if "direct_conv" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    _build.load()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    out = open(args.out, "w")
    for i, (label, bs, h, k, pool) in enumerate(SHAPES):
        kern = rng.random((k, k))
        conv = dcv.DirectConv(kern / kern.sum(), (h, h), pool, dev)
        gen = torch.Generator(device=dev).manual_seed(i)
        x = torch.randn((bs, h, h), generator=gen, device=dev)
        ct = torch.randn((bs, h // pool, h // pool), generator=gen, device=dev)
        w = conv.w_ref[None, None]
        oy = conv.oy
        for direction, arg in (("fwd", x), ("transpose", ct)):
            got = dcv.direct_conv_cuda(arg, conv, direction)
            torch.cuda.synchronize()
            pl = conv.plan(bs, direction) if hasattr(conv, "plan") else conv.plans[direction]
            row = dict(label=label, bs=bs, img=h, psf=k, pool=pool, direction=direction,
                       card=card, hash=digest(got),
                       ms=cuda_ms(lambda: dcv.direct_conv_cuda(arg, conv, direction)),
                       plan={kk: v for kk, v in pl.items()})
            lib = ((lambda: F.conv2d(arg[:, None], w, stride=pool, padding=oy))
                   if direction == "fwd" else
                   (lambda: F.conv_transpose2d(arg[:, None], w, stride=pool, padding=oy)))
            row["library_ms"] = cuda_ms(lib, reps=5, warmup=1)
            macs = min(dcv.direct_macs(h, h, k, k, pool),
                       chain_macs(h, h, k, k, pool, direction == "transpose"))
            nbytes = 4 * (x.numel() + ct.numel() + conv.w_ref.numel())
            t_ops, t_bytes = 2 * bs * macs / FP32_PEAK, nbytes / HBM_RATE
            row["bound_ms"] = 1e3 * max(t_ops, t_bytes)
            row["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
            if args.sweep:
                row["sweep"] = sweep(dcv, conv, arg, direction, got)
            out.write(json.dumps(row) + "\n")
            out.flush()
            print(f"{label} {direction}: {row['ms']:.4f} ms (library {row['library_ms']:.4f}, "
                  f"bound {row['bound_ms']:.4f}) plan {row['plan']}", flush=True)
        del x, ct, conv
        torch.cuda.empty_cache()
    return 0


def sweep(dcv, conv, arg, direction, want):
    """ms of every tile choice at this shape, each held bit for bit to
    ``want``; the fastest first."""
    import torch

    bs, res = arg.shape[0], []
    n_in = conv.pool ** 2 if direction == "fwd" else 1
    for rows, cols in dcv.VARIANTS:
        for c in dcv.tile_choices(bs, conv.out_h, conv.out_w, conv.ku, conv.kv, conv.pool,
                                  direction, rows, cols):
            n_ld = n_in // (conv.pool if direction == "fwd" else 1)
            for stages, tma in itertools.product(sorted({1, min(2, n_ld), min(n_ld, 4)}),
                                                  (None, False)):
                pl = dcv.launch_plan(bs, conv.out_h, conv.out_w, conv.ku, conv.kv, conv.pool,
                                     direction, rows, cols, c["rb"], c["spb"], stages, tma)
                if pl["smem"] > dcv.SMEM_LIMIT:
                    continue
                got = dcv.direct_conv_cuda(arg, conv, direction, pl)
                if not torch.equal(got, want):
                    raise AssertionError(f"plan {pl} differs from the default plan's output")
                ms = cuda_ms(lambda: dcv.direct_conv_cuda(arg, conv, direction, pl), reps=10,
                             warmup=1)
                res.append(dict(ms=ms, rows=rows, cols=cols, rb=c["rb"], spb=c["spb"],
                                stages=stages, tma=pl["tma"],
                                warps=pl["warps"], blocks=pl["blocks"],
                                live=round(pl["live"], 3)))
    return sorted(res, key=lambda r: r["ms"])


def compare(files):
    rows = {}
    for f in files:
        for line in open(f):
            r = json.loads(line)
            rows.setdefault((r["label"], r["direction"]), []).append((f, r))
    names = list(dict.fromkeys(Path(f).stem.rstrip("0123456789") for f in files))
    print("| shape | direction | " + " | ".join(f"{n} ms" for n in names)
          + " | speed-up | bitwise | library ms | bound ms |")
    print("|---" * (len(names) + 6) + "|")
    for (label, direction), rs in rows.items():
        ms = {n: [r["ms"] for f, r in rs if Path(f).stem.rstrip("0123456789") == n]
              for n in names}
        mean = {n: sum(v) / len(v) for n, v in ms.items() if v}
        hashes = {r["hash"] for _, r in rs}
        sp = mean[names[0]] / mean[names[1]] if len(mean) == 2 else float("nan")
        print(f"| {label} | {direction} | "
              + " | ".join(f"{mean.get(n, float('nan')):.4f}" for n in names)
              + f" | {sp:.2f} | {len(hashes) == 1} | {rs[0][1]['library_ms']:.4f} | "
              f"{rs[0][1]['bound_ms']:.4f} |")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out")
    ap.add_argument("--package-root", default=str(ROOT))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--compare", nargs="+")
    args = ap.parse_args(argv)
    if args.compare:
        compare(args.compare)
        return 0
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
