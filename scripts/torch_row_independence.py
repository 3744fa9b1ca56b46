#!/usr/bin/env python3
"""Does a row's result depend on how many rows a call holds? (on the card)

    python3 scripts/torch_row_independence.py

Sample sharding (``gigalens_tpu_torch.parallel``) gives N ranks one rank's
numbers only where each row of the per-sample work rounds the same at a
rank's share of the rows as at all of them. For the bench scene (80x80 px,
supersample 2, the 25-px PSF; prior draws seeded 5, scaled by 0.3 in z)
this compares, at n rows against n / k-row pieces of the same rows: the
exact (FFT) path's render, conv, image, pixel log-likelihood, chi2 and
log-likelihood z-gradient; the fast (direct K4) path's image and
log-likelihood; SMC's per-particle product ``eps @ L^-T`` (``L^-T`` from a
triangular solve, as the sampler forms it) as one batched einsum and at
the global row count (``parallel.mesh.at_global_rows``); and a plain
``torch.sum`` over 6400 pixels a row. Prints the card's name and power
limit, then one JSON line of max |difference| per check (0.0: bitwise).
Needs a CUDA device.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main():
    import torch

    import chip_smoke
    from gigalens_tpu_torch import bench
    from gigalens_tpu_torch.inference.sequence import phase_simulator
    from gigalens_tpu_torch.model import ForwardProbModel
    from gigalens_tpu_torch.parallel import Mesh, at_global_rows

    if not torch.cuda.is_available():
        print("torch_row_independence: needs a CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    dev = torch.device("cuda", 0)
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

    res = {}
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
    for n, k in ((50, 25), (48, 24), (48, 12), (16, 4)):
        x = torch.randn((n, 80, 80), generator=g, device=dev)
        whole = torch.sum(x, dim=(-2, -1))
        parts = torch.cat([torch.sum(x[i:i + k], dim=(-2, -1)) for i in range(0, n, k)])
        res[f"sum of 6400 a row, {n} vs {n // k} x {k}"] = float((whole - parts).abs().max())
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
