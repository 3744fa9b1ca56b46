#!/usr/bin/env python3
"""Does a row's result depend on how many rows a call holds? (on the card)

    python3 scripts/torch_row_independence.py [--out DIR]

Sample sharding (``gigalens_tpu_torch.parallel``) gives N ranks one
process's numbers only where each row of the per-sample work rounds the
same at a rank's share of the rows as at all of them. Part 1 takes each
prob model of the repo's scenes and compares, row by row, ``log_prob`` and
its z-gradient evaluated at k rows against the same rows inside one call
of all ``n`` rows:

- the bench scene (80x80 px, supersample 2, the 25-px PSF): a
  ForwardProbModel on the exact (FFT) path and on the fast (K2/K3, direct
  K4) path;
- the survey scene (``bench.survey_scene``: 4 scenes, 60 px, a PSF a
  scene): a SurveyForwardProbModel, k rows a scene, exact and fast;
- config #5's cluster scene (``bench.cluster_scene``, 48 px): the dpie
  arm's ForwardProbModel on pixels and positions, and the sie arm's
  BackwardProbModel (lstsq source), exact and fast;
- the inversion scene (``chip_smoke.inversion_scene``): the
  PixelatedSourceProbModel.

"plain" is a k-row call on its own; "at global rows" is the same k rows
on a simulator that is rank 0 (and the last rank) of a mesh of n / k
ranks (a ``Mesh`` with no process group: the layout only), whose per-row
pixel reductions run at the global row count (``model.pixel_reduce``).
z: prior draws (seeded 5) scaled by 0.3 in z.

Part 2 is the bench scene's stages (render, conv, image, pixel
log-likelihood, chi2, gradient) at n rows against n / k-row pieces, SMC's
per-particle product ``eps @ L^-T`` as one batched einsum and at the
global row count (``parallel.mesh.at_global_rows``), and a plain
``torch.sum`` over 6400 pixels a row.

Prints the card's name and power limit, one line per comparison, then one
JSON line of max |difference| per comparison (0.0: bitwise), also written
to ``DIR/row_independence.json`` with ``--out``. Needs a CUDA device.

``--inversion-cost`` runs part 3 alone: what that parity costs a rank of
the inversion's joint MAP (``chip_smoke.INV_STARTS`` = 32 starts). For 1,
2, 4, 8 and 32 ranks it times rank 0's step (the pixelated-source model's
``log_prob`` and its z-gradient, median of 20 calls after 3, CUDA
synchronized) and its peak allocated memory, on a simulator of the mesh's
layout and alone (its 32 / N rows with no mesh), holds rank 0's and the
last rank's log-densities and gradients to one process's, and prints one
JSON line, also written to ``DIR/inversion_rank_cost.json`` with
``--out``. ``--inversion-rows`` runs part 1 on the inversion scene alone.

``--inversion-stages`` runs part 4 alone: which of the inversion's stages
round a row by the rows a call holds. At the joint MAP's 32 rows against
their first 1, 2, 4, 8 and 16 in calls of their own (one chunk of source
rows for all): the ray-shooting and its z-gradient (of fixed cotangents),
the mapping matrix and its z-gradient, ``inversion._Marginal`` (source,
log det, b . s, model) and its gradients to C and lam on the 32-row call's
C, and inside it the Gram, the Cholesky, the factor's inverse and the log
det's sum; then a per-row sum over the 4,096 native pixels. Prints one JSON
line of max |difference| per stage and row count, also written to
``DIR/inversion_stages.json`` with ``--out``.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

ROWS = (1, 2, 4, 12, 24, 25, 48)


def _models(dev):
    """(name, prob model, phys, sim_config, prior, global rows n, rows a
    scene divisor S) of each scene."""
    import chip_smoke
    from gigalens_tpu_torch import bench
    from gigalens_tpu_torch.model import ForwardProbModel, SurveyForwardProbModel

    out = []
    phys, cfg, _ = bench.bench_scene(80)
    prior = bench.bench_prior()
    prob = ForwardProbModel(prior, chip_smoke.mesh_observation(), background_rms=bench.BKG,
                            exp_time=bench.EXP_TIME, device=dev)
    out.append(("bench", prob, phys, cfg, prior, 500, 1))
    s_prior, s_phys, s_cfg, s_obs = bench.survey_scene(4, device=dev)
    s_prob = SurveyForwardProbModel(s_prior, s_obs, background_rms=bench.BKG,
                                    exp_time=bench.EXP_TIME, device=dev)
    out.append(("survey", s_prob, s_phys, s_cfg, s_prior, 500, 4))
    for kind, source in (("dpie", "sampled"), ("sie", "lstsq")):
        sc = bench.cluster_scene(kind, source=source, device=dev)
        out.append((f"cluster {kind} {source}", sc.prob, sc.phys, sc.cfg, sc.prior, 500, 1))
    out.append(_inversion(dev))
    return out


def _inversion(dev):
    """The inversion scene's entry of :func:`_models`."""
    import chip_smoke
    from gigalens_tpu_torch.inversion import PixelatedSourceProbModel, SourceGrid

    inv = chip_smoke.inversion_scene(dev)
    model = PixelatedSourceProbModel(inv["prior"], inv["obs"], background_rms=chip_smoke.INV_BKG,
                                     exp_time=chip_smoke.INV_EXP_TIME,
                                     grid=SourceGrid(chip_smoke.INV_NSIDE, chip_smoke.INV_EXTENT),
                                     lam=None, device=dev)
    # 100 rows: 1, 2, 4 and 25 rows a rank divide it
    return "inversion", model, inv["phys"], inv["cfg"], inv["prior"], 100, 1


def part1(dev, res, models=None):
    import torch

    from gigalens_tpu_torch.parallel import Mesh
    from gigalens_tpu_torch.simulator import LensSimulator

    for name, prob, phys, cfg, prior, n, S in models or _models(dev):
        gen = torch.Generator(device=dev).manual_seed(5)
        z = prior.unconstrain(prior.sample(gen, n)) * 0.3
        paths = [("exact", dataclasses.replace(cfg, psf_mode="fft")), ("fast", cfg)]
        if name == "inversion":
            paths = [("fast", cfg)]
        for path, pcfg in paths:
            def call(zz, bs, mesh=None):
                sim = LensSimulator(phys, pcfg, bs=bs, device=dev, mesh=mesh)
                zz = zz.detach().clone().requires_grad_(True)
                lp = prob.log_prob(sim, zz)[0]
                (g,) = torch.autograd.grad(lp.sum(), zz)
                return lp.detach(), g

            def rows_of(t, k, r):
                # rank r's k rows a scene of a scene-major batch of n rows
                return t.reshape(S, n // S, *t.shape[1:])[:, r * k:(r + 1) * k].reshape(
                    S * k, *t.shape[1:])

            whole = call(z, n)
            for k in ROWS:
                if k * S >= n:
                    continue
                got = call(rows_of(z, k, 0), S * k)
                errs = [float((a - rows_of(b, k, 0)).abs().max()) for a, b in zip(got, whole)]
                key = f"{name} {path} plain: {S * k} rows vs {n}"
                res[key] = dict(log_prob=errs[0], grad=errs[1])
                print(key, res[key], flush=True)
            # at global rows: k rows of rank 0 and the last rank of n / (S k) ranks
            for k in ROWS:
                if (n // S) % k or k * S >= n:
                    continue
                size = n // (S * k)
                errs = [0.0, 0.0]
                for r in (0, size - 1):
                    mesh = Mesh(dev)
                    mesh.rank, mesh.size = r, size
                    got = call(rows_of(z, k, r), S * k, mesh)
                    for i, (a, b) in enumerate(zip(got, whole)):
                        errs[i] = max(errs[i], float((a - rows_of(b, k, r)).abs().max()))
                key = f"{name} {path} at global rows: {S * k} rows of {n}"
                res[key] = dict(log_prob=errs[0], grad=errs[1])
                print(key, res[key], flush=True)
            del whole
            torch.cuda.empty_cache()


def part2(dev, res):
    import torch

    import chip_smoke
    from gigalens_tpu_torch import bench
    from gigalens_tpu_torch.inference.sequence import phase_simulator
    from gigalens_tpu_torch.model import ForwardProbModel
    from gigalens_tpu_torch.parallel import Mesh, at_global_rows

    phys, cfg, _ = bench.bench_scene(80)
    prior = bench.bench_prior()
    prob = ForwardProbModel(prior, chip_smoke.mesh_observation(), background_rms=bench.BKG,
                            exp_time=bench.EXP_TIME, device=dev)
    z = prior.unconstrain(prior.sample(torch.Generator(device=dev).manual_seed(5), 1000)) * 0.3

    def stages(sim, zz, exact):
        zz = zz.detach().requires_grad_(True)
        x = prior.constrain(zz)
        out = {}
        if exact:
            flat = sim._flat_light(x)
            out["render"] = flat
            out["conv"] = sim._conv(torch.nan_to_num(sim._place(flat)), scene_axis=-3)
        out["image"] = sim.simulate(x)
        ll, chi2 = prob.stats_pixels(sim, x)
        out["like"], out["chi2"] = ll, chi2
        if exact:
            (out["g_like"],) = torch.autograd.grad(ll.sum(), zz)
        return {k: v.detach() for k, v in out.items()}

    for exact, n, k in ((True, 1000, 500), (True, 50, 25), (True, 48, 24), (True, 48, 12),
                        (True, 16, 4), (False, 500, 250)):
        cache = {}
        whole = stages(phase_simulator(cache, cfg, phys, n, exact, dev), z[:n], exact)
        parts = [stages(phase_simulator(cache, cfg, phys, k, exact, dev), z[i:i + k], exact)
                 for i in range(0, n, k)]
        res[f"{'exact' if exact else 'fast'} {n} vs {n // k} x {k}"] = {
            key: float((whole[key] - torch.cat([p[key] for p in parts])).abs().max())
            for key in whole}

    g = torch.Generator(device=dev).manual_seed(0)
    d = prior.d
    a = torch.randn((200, d, d), generator=g, device=dev)
    tril = torch.linalg.cholesky(a.transpose(1, 2) @ a / 200 + 1e-3 * torch.eye(d, device=dev))
    tril = tril.mean(0, keepdim=True)  # (E = 1, d, d)
    inv_l = torch.linalg.solve_triangular(tril, torch.eye(d, device=dev).expand(tril.shape),
                                          upper=False)
    eps = torch.randn((1000, 1, d), generator=g, device=dev)

    def prod(e):
        return torch.einsum("ped,edi->pei", e, inv_l)

    whole = prod(eps)
    halves = torch.cat([prod(eps[i:i + 500]) for i in (0, 500)])
    padded = []
    for r in range(2):
        mesh = Mesh(dev)
        mesh.rank, mesh.size = r, 2  # the layout of rank r of two, no process group
        padded.append(at_global_rows(prod, eps[r * 500:(r + 1) * 500], mesh))
    res["eps @ L^-T, 1000 vs 2 x 500"] = dict(
        einsum=float((whole - halves).abs().max()),
        at_global_rows=float((whole - torch.cat(padded)).abs().max()))
    for n, k in ((50, 25), (48, 24), (48, 16), (48, 12), (16, 4)):
        x = torch.randn((n, 80, 80), generator=g, device=dev)
        whole = torch.sum(x, dim=(-2, -1))
        parts = torch.cat([torch.sum(x[i:i + k], dim=(-2, -1)) for i in range(0, n, k)])
        res[f"sum of 6400 a row, {n} vs {n // k} x {k}"] = float((whole - parts).abs().max())


def part3(dev, res, reps=20, warm=3):
    import statistics
    import time

    import torch

    import chip_smoke
    from gigalens_tpu_torch.parallel import Mesh
    from gigalens_tpu_torch.simulator import LensSimulator

    _, prob, phys, cfg, prior, _, _ = _inversion(dev)
    n = chip_smoke.INV_STARTS
    gen = torch.Generator(device=dev).manual_seed(5)
    z = prior.unconstrain(prior.sample(gen, n)) * 0.3

    def step(sim, zz):
        zz = zz.detach().clone().requires_grad_(True)
        lp = prob.log_prob(sim, zz)[0]
        (g,) = torch.autograd.grad(lp.sum(), zz)
        return lp.detach(), g

    def measure(k, mesh):
        sim = LensSimulator(phys, cfg, bs=k, device=dev, mesh=mesh)
        for _ in range(warm):
            step(sim, z[:k])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            step(sim, z[:k])
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        return dict(ms=statistics.median(walls),
                    peak_mib=torch.cuda.max_memory_allocated(dev) / 2**20)

    whole = step(LensSimulator(phys, cfg, bs=n, device=dev), z)
    for size in (1, 2, 4, 8, 32):
        k = n // size
        mesh = Mesh(dev)
        mesh.rank, mesh.size = 0, size  # the layout of rank 0 of size, no process group
        row = {"mesh layout": measure(k, mesh)}
        if size > 1:
            row["alone"] = measure(k, None)
            errs = [0.0, 0.0]
            for r in (0, size - 1):
                mesh.rank = r
                got = step(LensSimulator(phys, cfg, bs=k, device=dev, mesh=mesh),
                           z[r * k:(r + 1) * k])
                for i, (a, b) in enumerate(zip(got, whole)):
                    errs[i] = max(errs[i], float((a - b[r * k:(r + 1) * k]).abs().max()))
            row["vs one process"] = dict(log_prob=errs[0], grad=errs[1])
        res[f"inversion rank 0 of {size}: {k} of {n} rows"] = row
        print(f"inversion rank 0 of {size}: {k} of {n} rows {row}", flush=True)
        torch.cuda.empty_cache()


def part4(dev, res):
    import torch

    import chip_smoke
    from gigalens_tpu_torch.inversion import _full_fp32, _Marginal
    from gigalens_tpu_torch.simulator import LensSimulator

    _, model, phys, cfg, prior, _, _ = _inversion(dev)
    n = chip_smoke.INV_STARTS
    z = prior.unconstrain(prior.sample(torch.Generator(device=dev).manual_seed(5), n)) * 0.3
    sims = {k: LensSimulator(phys, cfg, bs=k, device=dev) for k in (1, 2, 4, 8, 16, n)}
    model.chunk = model.chunk_rows(sims[n])  # one chunk of source rows at every row count
    npix = sims[n].img_x.shape[0]
    g = torch.Generator(device=dev).manual_seed(6)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def leaf(t, k):
        return t[:k].detach().clone().requires_grad_(True)

    g_beta = randn(n, 2, npix)

    def rays(k):
        zz = leaf(z, k)
        sim = sims[k]
        bx, by = sim.beta(sim.img_x, sim.img_y, prior.constrain(zz)["lens_mass"])
        b = torch.stack([torch.broadcast_to(t, (k, npix)) for t in (bx, by)], 1)
        (gz,) = torch.autograd.grad(b, zz, g_beta[:k])
        return dict(beta=b.detach(), beta_z_grad=gz)

    C_n = model.mapping_matrix(sims[n], prior.constrain(z)["lens_mass"]).detach()
    g_C = randn(*C_n.shape)

    def mapping(k):
        zz = leaf(z, k)
        C = model.mapping_matrix(sims[k], prior.constrain(zz)["lens_mass"])
        (gz,) = torch.autograd.grad(C, zz, g_C[:k])
        return dict(C=C.detach(), C_z_grad=gz)

    mask = sims[n].img_region
    w = (mask / model.error_map**2).reshape(-1)
    d = (model.observed_image * mask).reshape(-1)
    lam = model._lam_of(prior.constrain(z)).detach()
    k_src = C_n.shape[1]
    cot = (randn(n, k_src), randn(n), randn(n), randn(n, C_n.shape[2]))
    with _full_fp32():
        F_n = torch.matmul(C_n * w, C_n.mT) + lam[:, None, None] * model.H_reg
        L_n = torch.linalg.cholesky_ex(F_n)[0]
    eye = torch.eye(k_src, device=dev)
    resid = randn(n, C_n.shape[2])

    def marginal(k):
        C, lam_k = leaf(C_n, k), leaf(lam, k)
        s, ld, bsd, img, _ = _Marginal.apply(C, w, d, lam_k, model.H_reg)
        gC, glam = torch.autograd.grad((s, ld, bsd, img), (C, lam_k), [c[:k] for c in cot])
        with _full_fp32():
            gram = torch.matmul(C_n[:k] * w, C_n[:k].mT)
            L = torch.linalg.cholesky_ex(F_n[:k])[0]
            Li = torch.linalg.solve_triangular(L_n[:k], eye, upper=False)
        return dict(source=s.detach(), logdet=ld.detach(), bs_dot=bsd.detach(),
                    model=img.detach(), marginal_C_grad=gC, marginal_lam_grad=glam,
                    gram=gram, cholesky=L, factor_inverse=Li,
                    logdet_sum=torch.sum(torch.log(torch.diagonal(L_n[:k], dim1=-2, dim2=-1)), -1),
                    pixel_sum=torch.sum(w * resid[:k] * resid[:k], -1))

    for stage in (rays, mapping, marginal):
        whole = stage(n)
        for k in (1, 2, 4, 8, 16):
            got = stage(k)
            for key, v in got.items():
                res.setdefault(key, {})[f"{k} of {n}"] = float((v - whole[key][:k]).abs().max())
        del whole
        torch.cuda.empty_cache()
    for key, row in res.items():
        print(f"{key}: {row}", flush=True)


def main(argv=None):
    import argparse

    import torch

    import chip_smoke

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="directory for row_independence.json")
    ap.add_argument("--inversion-cost", action="store_true",
                    help="part 3 alone: a rank's step time and peak memory in the "
                         "inversion's joint MAP, at the global rows and alone")
    ap.add_argument("--inversion-rows", action="store_true",
                    help="part 1 on the inversion scene alone")
    ap.add_argument("--inversion-stages", action="store_true",
                    help="part 4 alone: which of the inversion's stages round a row by the "
                         "rows a call holds")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("torch_row_independence: needs a CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    res = {}
    if args.inversion_rows:
        part1(dev, res, [_inversion(dev)])
        name = "inversion_rows.json"
    elif args.inversion_stages:
        part4(dev, res)
        name = "inversion_stages.json"
    elif args.inversion_cost:
        part3(dev, res)
        name = "inversion_rank_cost.json"
    else:
        part1(dev, res)
        part2(dev, res)
        name = "row_independence.json"
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / name).write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
