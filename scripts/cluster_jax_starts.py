#!/usr/bin/env python3
"""Writes the JAX package's 128 MAP starts of config #5's dpie arm as numbers.

    python3 scripts/cluster_jax_starts.py [--out scripts/cluster_dpie_jax_starts.npy]
    python3 scripts/cluster_jax_starts.py --sie-svi

scripts/bench_cluster_posterior.py's run_pipeline draws its MAP starts
inside ``seq.MAP(opt, n_samples=128, num_steps=400, seed=0)`` (:209):
``prior.unconstrain(prior.sample(jax.random.PRNGKey(0), 128))`` of the
dpie arm's prior (``build_scene``, :89-149). This draws the same starts on
the CPU with the JAX package and saves them as a (128, 26) float32 array
in the prior's flattening order, which the port's ``Prior`` shares, so
``scripts/torch_cluster_study.py --jax-starts`` can run the port's MAP
from them on a machine without JAX.

``--sie-svi`` runs the JAX script's own sie lstsq pipeline up to SVI on
the CPU, as ``run_pipeline`` runs it (:200-232: its ``build_scene("sie",
20, 3)`` on its key-5 truth, MAP from ``seed=0``, the FD Laplace at the
best start, SVI from ``seed=1``), in float32 as the JAX package ships, and
prints the best MAP red-chi2, the SVI loss every 40 steps, the share of
finite losses, and the share of the surrogate's 256 draws whose
log-density is finite, as one JSON line.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
OUT = ROOT / "scripts" / "cluster_dpie_jax_starts.npy"


def jax_starts(n=128, seed=0):
    """(n, 26) float32: the dpie arm's MAP starts as the JAX script draws them."""
    import jax
    import numpy as np

    from gigalens_tpu.prob import Prior
    from gigalens_tpu.prob import distributions as gld
    from gigalens_tpu.profiles.light.shapelets import Shapelets

    amps = {a: gld.Normal(0, 5.0) for a in Shapelets(n_max=4)._amp_names}
    prior = Prior(dict(
        lens_mass=[dict(Rs=gld.LogNormal(np.log(10.0), 0.2),
                        alpha_Rs=gld.LogNormal(np.log(4.0), 0.3),
                        e1=gld.Normal(0, 0.1), e2=gld.Normal(0, 0.1),
                        center_x=gld.Normal(0, 0.5), center_y=gld.Normal(0, 0.5)),
                   dict(theta_E=gld.LogNormal(np.log(0.3), 0.3),
                        r_cut=gld.LogNormal(np.log(1.5), 0.2))],
        source_light=[dict(beta=gld.LogNormal(np.log(0.4), 0.2), center_x=gld.Normal(0, 0.3),
                           center_y=gld.Normal(0, 0.3), **amps)]))
    z = jax.jit(lambda key: prior.unconstrain(prior.sample(key, n)))(jax.random.PRNGKey(seed))
    return np.asarray(z, np.float32)


def sie_svi(map_n=128, map_steps=400, vi_n=256, vi_steps=400):
    """The JAX script's sie lstsq MAP, Laplace and SVI (``run_pipeline``,
    :203-232) on the CPU: a dict of the best MAP red-chi2, the SVI losses
    and the surrogate's finite share."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    argv = sys.argv
    sys.argv = [argv[0], "--members", "sie", "--source", "lstsq"]
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import bench_cluster_posterior as bcp
    finally:
        sys.argv = argv
    from gigalens_tpu.inference import ModellingSequence
    from gigalens_tpu.simulator import LensSimulator

    phys, prior, pm, cfg, _ = bcp.build_scene("sie", 20, 3)
    seq = ModellingSequence(phys, pm, cfg)
    sched = optax.polynomial_schedule(-1e-2, -1e-2 / 3, 0.5, map_steps)
    opt = optax.chain(optax.scale_by_adam(), optax.scale_by_schedule(sched))
    z_map = seq.MAP(opt, n_samples=map_n, num_steps=map_steps, seed=0)
    sim_b = LensSimulator(phys, cfg, bs=map_n)
    lps, _ = jax.jit(lambda z: pm.log_prob(sim_b, z))(z_map)
    _, chi2 = jax.jit(lambda z: pm.stats_pixels(sim_b, prior.constrain(z)))(z_map)
    best = z_map[jnp.argmax(jnp.nan_to_num(lps, nan=-jnp.inf))][None, :]
    L0 = seq.laplace_scale_tril(best)
    sched = optax.polynomial_schedule(-1e-6, -3e-3, 2, max(vi_steps // 5, 1))
    opt = optax.chain(optax.scale_by_adam(), optax.scale_by_schedule(sched))
    q_z, losses = seq.SVI(best, opt, n_vi=vi_n, num_steps=vi_steps,
                          init_scales=np.asarray(L0), seed=1)
    losses = np.asarray(losses, np.float64)
    z = q_z.sample(jax.random.PRNGKey(2), (vi_n,))
    lp_q, _ = jax.jit(lambda zz: pm.log_prob(LensSimulator(phys, cfg, bs=vi_n), zz))(z)
    return dict(map_red_chi2=float(jnp.nanmin(chi2)),
                laplace_diag=np.diag(np.asarray(L0)).tolist(),
                losses_every_40={i: float(losses[i]) for i in range(0, vi_steps, 40)},
                last_loss=float(losses[-1]),
                finite_losses=float(np.isfinite(losses).mean()),
                finite_draws=float(np.isfinite(np.asarray(lp_q)).mean()))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--sie-svi", action="store_true",
                    help="the JAX script's sie lstsq MAP, Laplace and SVI on the CPU")
    args = ap.parse_args(argv)
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    if args.sie_svi:
        import json
        import time

        t0 = time.perf_counter()
        row = sie_svi()
        row.update(device=str(jax.devices()[0]), wall_s=time.perf_counter() - t0)
        print(json.dumps(row))
        return 0
    z = jax_starts()
    np.save(args.out, z)
    print(f"{args.out}: {z.shape} {z.dtype}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
