"""The composite demo's SVI (examples/demo_composite.py through
``gigalens_tpu_torch.demos``) with the Hernquist profile's F(x) as the JAX
package computes it and as the port does (ROADMAP F-ref-8).

Below x = 1 the JAX package evaluates F(x) = arctanh(s) / s, s = sqrt(1 -
x^2): once 1 - x^2 rounds to 1 in float32 (x = R / Rs below ~2.4e-4) it is
inf, the deflection inf and its gradient NaN, at a finite log-density. A
draw whose Hernquist centre lies within ~1e-4 arcsec of a pixel of the
128 x 128 supersampled grid then sends a NaN gradient into the shared
variational parameters. Below x = 1/2 the port evaluates the same
function as log1p((1 + s - x) / x) / s.

For each form: MAP (256 starts x 250 steps, seed 0), the FD Laplace at the
best start and SVI (200 draws x 300 steps, seed 1), as the demo runs them,
with a hook on the SVI draws that records every step whose gradient has a
non-finite row. Prints one JSON line a form: the losses, the count of such
steps, and for the first its step, its rows, how many of them have a
finite log-density and, for those, the distance from the draw's Hernquist
centre to the nearest pixel.

    python3 scripts/torch_composite_study.py [--device cpu] [--forms jax,port]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from gigalens_tpu_torch import demos  # noqa: E402
from gigalens_tpu_torch.inference import ModellingSequence  # noqa: E402
from gigalens_tpu_torch.inference.sequence import map_optimizer, svi_optimizer  # noqa: E402
from gigalens_tpu_torch.profiles.mass import hernquist  # noqa: E402


def jax_form_f(x):
    """F(x) as ``gigalens_tpu/profiles/mass/hernquist.py:45-52`` computes it."""
    x = torch.clamp(x, min=hernquist._X_MIN)
    x_lo = torch.where(x < 1, x, torch.full_like(x, 0.5))
    x_hi = torch.where(x > 1, x, torch.full_like(x, 2.0))
    lo = torch.arctanh(torch.sqrt(1.0 - x_lo**2)) / torch.sqrt(1.0 - x_lo**2)
    hi = torch.arctan(torch.sqrt(x_hi**2 - 1.0)) / torch.sqrt(x_hi**2 - 1.0)
    return torch.where(x < 1, lo, hi)


def run(form, device):
    port_f = hernquist._hern_f
    if form == "jax":
        hernquist._hern_f = jax_form_f
    try:
        return fit(form, device)
    finally:
        hernquist._hern_f = port_f


def fit(form, device):
    p = demos.COMPOSITE_DEPTHS
    sc = demos.composite_scene(p["num_pix"], device)
    prior, prob = sc.prior, sc.prob
    seq = ModellingSequence(sc.phys, prob, sc.cfg, device=device)
    t0 = time.perf_counter()
    z_map = seq.MAP(map_optimizer(p["map_steps"]), n_samples=p["map_n"],
                    num_steps=p["map_steps"], seed=0)
    best = seq.best_map_start(z_map)
    L0 = seq.laplace_scale_tril(best)
    grid_x, grid_y = seq._sim(1).img_x, seq._sim(1).img_y
    bad_steps, step = [], [0]
    log_prob = prob.log_prob

    def watched(sim, z):
        out = log_prob(sim, z)
        if z.requires_grad:
            centre = prior.constrain(z.detach())["lens_mass"][0]
            dist = torch.sqrt((grid_x - centre["center_x"][:, None]) ** 2
                              + (grid_y - centre["center_y"][:, None]) ** 2).amin(-1)
            lp = out[0].detach()
            k = step[0]

            def hook(g):
                rows = ~torch.isfinite(g).all(-1)
                if rows.any():
                    finite = rows & torch.isfinite(lp)
                    bad_steps.append(dict(step=k, rows=int(rows.sum()),
                                          finite_log_prob=int(finite.sum()),
                                          pixel_distance=dist[finite].tolist()))
                return g

            z.register_hook(hook)
            step[0] += 1
        return out

    prob.log_prob = watched
    try:
        q_z, losses = seq.SVI(best, svi_optimizer(p["vi_steps"]), n_vi=p["vi_n"],
                              num_steps=p["vi_steps"], init_scales=L0, seed=1)
    finally:
        del prob.log_prob
    losses = losses.cpu().numpy()
    return dict(form=form, seconds=time.perf_counter() - t0, steps=len(losses),
                elbo_first=float(losses[0]), elbo_last=float(losses[-1]),
                elbo_every_50=[float(v) for v in losses[::50]],
                surrogate_finite=bool(torch.isfinite(q_z.loc).all()
                                      and torch.isfinite(q_z.scale_tril).all()),
                nonfinite_gradient_steps=len(bad_steps),
                first=bad_steps[0] if bad_steps else None)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--forms", default="jax,port")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    for form in args.forms.split(","):
        print(json.dumps(run(form, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
