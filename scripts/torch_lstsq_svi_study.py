#!/usr/bin/env python3
"""Where config #5's sie lstsq SVI parts from the JAX package (on the card).

    python3 scripts/torch_lstsq_svi_study.py [--out DIR] [--device cuda]

The sie arm (ScalingRelation(NIE) members, Shapelets(4) amplitudes solved
by weighted least squares a sample) on the JAX script's own truth
(``bench.CL_JAX_TRUTH``): MAP 128 x 400, the FD Laplace at the
best start, then SVI 256 x 400 (``bench.CL_DEPTHS``) from the same start, factor and
seed with three solves of the normal equations in place of
``simulator._lstsq_coeffs``:

1. "torch": Gram and pseudo-inverse in float32, the pseudo-inverse
   differentiated by autograd through torch's SVD (the port before its
   float64 solve, F-ref-7);
2. "jax": the same in float32 through ``simulator.pinv``, the JAX
   package's derivative;
3. "float64": the Gram and the solve in float64, ``simulator.pinv``.

Each SVI step's draws are recorded with their log-densities and their own
z-gradients (before the ELBO's finite mask). The first step of run 1 where
a draw of finite log-density has a non-finite gradient, or where the
largest gradient norm grows past 100 times that of the first 20 steps, is
the anomaly. At its draws the script holds against each other: the lstsq
amplitudes and their z-gradient (of a fixed random cotangent) in float32
and with the solve in float64, by either derivative, on the device and on
the CPU; the members' z-gradient (of the component images); and the
Gram's singular values. Then the port's own scene (the torch-seeded truth)
runs MAP, Laplace and SVI with solves 2 and 3 (its loss ended at -2063.6
before).

Prints the card's name and power limit, the losses every 40 steps, the
anomaly and the comparisons, and one JSON line, also written to
``DIR/lstsq_svi_study.json`` with ``--out``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))


class Traced:
    """A prob model's ``log_prob`` that keeps each call's draws, their
    log-densities and (once autograd reaches them) their z-gradients."""

    def __init__(self, prob):
        self.prob, self.prior, self.calls = prob, prob.prior, []

    def event_size(self, sim):
        return self.prob.event_size(sim)

    def log_prob(self, sim, z):
        lp, chi2 = self.prob.log_prob(sim, z)
        rec = dict(z=z.detach().clone(), lp=lp.detach().clone())
        self.calls.append(rec)
        if z.requires_grad:
            z.register_hook(lambda g: rec.__setitem__("g", g.detach().clone()))
        return lp, chi2


def svi(run, best, L0, prob, steps, n_vi):
    import torch

    from gigalens_tpu_torch.inference.sequence import svi_optimizer
    from gigalens_tpu_torch.inference.svi import fit_svi

    t0 = time.perf_counter()
    q, losses = fit_svi(prob, run.seq._sim(n_vi), best, svi_optimizer(steps), n_vi=n_vi,
                        init_scales=L0, num_steps=steps, seed=1)
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    z = q.sample(torch.Generator(device=run.device).manual_seed(0), n_vi)
    with torch.no_grad():
        lp = run.scene.prob.log_prob(run._sim(n_vi), z)[0]
    losses = losses.cpu()
    return dict(wall_s=wall, losses_every_40=[float(v) for v in losses[::40]],
                first=float(losses[0]), last=float(losses[-1]),
                all_finite=bool(torch.isfinite(losses).all()),
                draws_finite=int(torch.isfinite(lp).sum()), n_vi=n_vi,
                surrogate_finite=bool(torch.isfinite(q.mean()).all()
                                      and torch.isfinite(q.scale_tril).all()))


def step_table(calls):
    """Per SVI step: finite log-densities, draws of finite log-density with
    a non-finite gradient, and the largest gradient norm among the finite."""
    import torch

    rows = []
    for c in calls:
        fin = torch.isfinite(c["lp"])
        g = c.get("g")
        gfin = torch.isfinite(g).all(-1)
        norms = torch.where(gfin, g.norm(dim=-1), torch.zeros_like(fin, dtype=g.dtype))
        rows.append(dict(finite=int(fin.sum()), bad_grad=int((fin & ~gfin).sum()),
                         max_norm=float(norms.max())))
    return rows


def first_anomaly(table):
    import numpy as np

    base = float(np.median([r["max_norm"] for r in table[:20]]))
    for t, r in enumerate(table):
        if r["bad_grad"] or r["finite"] < table[0]["finite"] or r["max_norm"] > 100 * base:
            return t, base
    return None, base


def solver(dtype, deriv):
    """``_lstsq_coeffs`` of one scene with the Gram and the solve in
    ``dtype`` and the pseudo-inverse's derivative by ``deriv``: "torch"
    (autograd through the SVD) or "jax" (``simulator.pinv``)."""
    import torch

    import gigalens_tpu_torch.simulator as gsim

    inv = (lambda a, rtol: torch.linalg.pinv(a, rtol=rtol)) if deriv == "torch" else gsim.pinv

    def coeffs(imgs, observed_image, err_map):
        depth, n = imgs.shape[:2]
        W = (1.0 / err_map)[..., None]
        Y = (observed_image * W[..., 0]).reshape(1, -1, 1).to(dtype)
        X = (imgs.permute(1, 2, 3, 0) * W).reshape(n, -1, depth).to(dtype)
        Xt = X.transpose(-1, -2)
        return (inv(Xt @ X, 1e-6) @ (Xt @ Y))[..., 0].to(imgs.dtype)

    return coeffs


# the solves compared: (name, Gram and solve dtype, derivative)
VARIANTS = (("torch", "float32", "torch"), ("jax", "float32", "jax"),
            ("float64", "float64", "jax"))


def parts(sc, sim, z, fn, ct, ct_img):
    """Amplitudes by the solve ``fn`` (kept in float64), their z-gradient
    of ``sum(coeffs * ct)``, and the members' z-gradient of ``sum(imgs *
    ct_img)`` at draws ``z``."""
    import torch

    z = z.detach().clone().requires_grad_(True)
    x = sc.prior.constrain(z)
    imgs = sim._postprocess(sim._place(sim._flat_light(x, stack_components=True)))
    (g_img,) = torch.autograd.grad(torch.sum(imgs * ct_img), z, retain_graph=True)
    coeffs = fn(imgs, sc.prob.observed_image, sc.prob.err_map)
    (g,) = torch.autograd.grad(torch.sum(coeffs * ct.to(coeffs.dtype)), z)
    return coeffs.detach().double().cpu(), g.double().cpu(), g_img.double().cpu(), imgs.detach()


def gram_svals(sc, imgs):
    """The float32 Gram's singular values a row, in float64 (descending)."""
    import torch

    depth, n = imgs.shape[:2]
    W = (1.0 / sc.prob.err_map)[..., None]
    X = (imgs.permute(1, 2, 3, 0) * W).reshape(n, -1, depth)
    return torch.linalg.svdvals((X.mT @ X).double().cpu())


def compare(res, name, got, want):
    """Rows with a non-finite entry, and the largest |difference| of the
    finite rows over the reference row's largest |value|."""
    import torch

    fin = torch.isfinite(got).all(-1) & torch.isfinite(want).all(-1)
    scale = want.abs().amax(-1).clamp_min(1e-30)
    rel = ((got - want).abs().amax(-1) / scale)[fin]
    res[name] = dict(nonfinite_rows=int((~torch.isfinite(got).all(-1)).sum()),
                     max_rel=float(rel.max()) if rel.numel() else None,
                     median_rel=float(rel.median()) if rel.numel() else None)
    print(f"  {name}: {res[name]}", flush=True)


def anomaly_study(run, z, dev, truth):
    """The comparisons at the anomaly's draws ``z`` (see the module)."""
    import torch

    from gigalens_tpu_torch import bench

    out = {}
    n = z.shape[0]
    gen = torch.Generator().manual_seed(3)
    ct = torch.randn((n, 15), generator=gen, dtype=torch.float64)
    sc = run.scene
    sim = run._sim(n)
    ct_img = torch.randn((15, n, *sc.obs.shape), generator=gen)
    got = {}
    for where, scene, s in (("device", sc, sim), ("cpu", None, None)):
        if where == "cpu":
            from gigalens_tpu_torch.simulator import LensSimulator

            scene = bench.cluster_scene("sie", source="lstsq", device="cpu", truth=truth,
                                        num_pix=sc.obs.shape[0])
            # the device's observation, so that only the arithmetic differs
            scene.prob.observed_image = sc.prob.observed_image.cpu()
            scene.prob.err_map = sc.prob.err_map.cpu()
            s = LensSimulator(scene.phys, scene.cfg, bs=n, device="cpu")
        zz = z.to(s.device)
        for dtype in ("float32", "float64"):
            for deriv in ("torch", "jax"):
                key = f"{where} {dtype} {deriv}"
                c, g, g_img, imgs = parts(scene, s, zz, solver(getattr(torch, dtype), deriv),
                                          ct.to(s.device), ct_img.to(s.device))
                got[key] = (c, g, g_img)
                if where == "device" and dtype == "float32" and deriv == "jax":
                    sv = gram_svals(scene, imgs)
        del s
    ref = got["cpu float64 jax"]
    print("at the anomaly's draws, against the CPU's float64 solve with JAX's derivative:",
          flush=True)
    for key, (c, g, g_img) in got.items():
        compare(out, f"{key}: amplitudes", c, ref[0])
        compare(out, f"{key}: amplitude z-gradient", g, ref[1])
    compare(out, "device members' z-gradient (images)", got["device float32 jax"][2],
            got["cpu float32 jax"][2])
    rel = sv / sv[:, :1]
    kept = (rel > 1e-6).sum(-1)
    gaps = (sv[:, :-1] - sv[:, 1:]) / sv[:, :1]
    out["svals"] = dict(kept_min=int(kept.min()), kept_max=int(kept.max()),
                        rows_with_dropped=int((kept < 15).sum()),
                        smallest_rel=float(rel[:, -1].min()),
                        largest=float(sv[:, 0].max()),
                        min_rel_gap=float(gaps.min()))
    g_torch = got["device float32 torch"][1]
    worst = int(torch.argmax(torch.nan_to_num(g_torch.abs().amax(-1), nan=torch.inf)))
    out["worst_row"] = dict(index=worst, svals_rel=[float(v) for v in rel[worst]],
                            grad_torch=float(got["device float32 torch"][1][worst].abs().max()),
                            grad_jax=float(got["device float32 jax"][1][worst].abs().max()))
    print(f"Gram singular values: {out['svals']}; worst row {out['worst_row']}", flush=True)
    return out


def card_line():
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="directory for lstsq_svi_study.json")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--num-pix", type=int, help="image size (default: bench.CL_DEPTHS)")
    ap.add_argument("--map", help="MAP starts x steps, e.g. 128x400 (default: bench.CL_DEPTHS)")
    ap.add_argument("--svi", help="SVI draws x steps, e.g. 256x400 (default: bench.CL_DEPTHS)")
    args = ap.parse_args(argv)

    import torch

    import gigalens_tpu_torch.simulator as gsim
    from gigalens_tpu_torch import bench

    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_lstsq_svi_study: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device(args.device)
    res = dict(card=card_line() if dev.type == "cuda" else "cpu")
    print(f"card: {res['card']}", flush=True)
    D = bench.CL_DEPTHS
    num_pix = args.num_pix or D["num_pix"]
    map_n, map_steps = map(int, (args.map or f"{D['map_n']}x{D['map_steps']}").split("x"))
    n_vi, steps = map(int, (args.svi or f"{D['vi_n']}x{D['vi_steps']}").split("x"))
    truth = bench.CL_JAX_TRUTH["sie"]
    for label, scene_truth in (("jax_truth", truth), ("port_truth", None)):
        sc = bench.cluster_scene("sie", source="lstsq", device=dev, truth=scene_truth,
                                 num_pix=num_pix)
        run = bench.ClusterRun(sc, device=dev)
        run.phase_map(map_n, map_steps)
        lps = torch.where(torch.isnan(run.lps), -torch.inf, run.lps)
        best = run.z_map[torch.argmax(lps)][None, :]
        L0 = run.seq.laplace_scale_tril(best)
        res[label] = dict(map_red_chi2=run.row["map_red_chi2"], best_log_prob=float(lps.max()))
        variants = VARIANTS if label == "jax_truth" else VARIANTS[1:]
        for deriv, dtype, how in variants:
            saved = gsim._lstsq_coeffs
            gsim._lstsq_coeffs = solver(getattr(torch, dtype), how)
            traced = Traced(sc.prob)
            try:
                out = svi(run, best, L0, traced, steps, n_vi)
            finally:
                gsim._lstsq_coeffs = saved
            table = step_table(traced.calls)
            t, base = first_anomaly(table)
            out.update(anomaly_step=t, base_max_norm=base,
                       max_norm_every_20=[round(r["max_norm"], 3) for r in table[::20]],
                       bad_grad_steps=sum(1 for r in table if r["bad_grad"]))
            if t is not None:
                out["around_anomaly"] = {str(i): table[i] for i in range(max(t - 3, 0),
                                                                          min(t + 4, steps))}
            res[label][f"svi_{deriv}"] = out
            print(f"{label} SVI, {deriv} solve: {json.dumps(out)}", flush=True)
            if label == "jax_truth" and deriv == "torch":
                at = t if t is not None else int(max(range(len(table)),
                                                     key=lambda i: table[i]["max_norm"]))
                res[label]["study_step"] = at
                res[label]["study"] = anomaly_study(run, traced.calls[at]["z"], dev, truth)
            del traced
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "lstsq_svi_study.json").write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
