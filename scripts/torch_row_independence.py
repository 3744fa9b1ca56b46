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
    from gigalens_tpu_torch.inversion import PixelatedSourceProbModel, SourceGrid
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
    inv = chip_smoke.inversion_scene(dev)
    model = PixelatedSourceProbModel(inv["prior"], inv["obs"], background_rms=chip_smoke.INV_BKG,
                                     exp_time=chip_smoke.INV_EXP_TIME,
                                     grid=SourceGrid(chip_smoke.INV_NSIDE, chip_smoke.INV_EXTENT),
                                     lam=None, device=dev)
    out.append(("inversion", model, inv["phys"], inv["cfg"], inv["prior"], 48, 1))
    return out


def part1(dev, res):
    import torch

    from gigalens_tpu_torch.parallel import Mesh
    from gigalens_tpu_torch.simulator import LensSimulator

    for name, prob, phys, cfg, prior, n, S in _models(dev):
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


def main(argv=None):
    import argparse

    import torch

    import chip_smoke

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="directory for row_independence.json")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("torch_row_independence: needs a CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    res = {}
    part1(dev, res)
    part2(dev, res)
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "row_independence.json").write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
