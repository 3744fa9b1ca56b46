"""Multi-start MAP optimization (port of :mod:`gigalens_tpu.inference.map`).

The step is a plain Python loop on the device: loss = ``-mean(lp) /
event_size`` (the reference's convention), autograd, then the optimizer
update. The per-step minimum reduced chi2 stays on the device until the
end, so the loop never waits for the card. ``laplace_scale_tril`` is not
ported yet (ROADMAP M8).
"""
from __future__ import annotations

import torch

from gigalens_tpu_torch.inference.optim import GradientTransformation


def _nanmin(x):
    return torch.where(torch.isnan(x), torch.inf, x).min()


def fit_map(
    prob_model,
    simulator,
    optimizer: GradientTransformation,
    start=None,
    n_samples: int = 500,
    num_steps: int = 350,
    seed: int = 0,
):
    """Runs multi-start Adam; returns (z, chi2_history).

    ``z`` is the (n_samples, d) unconstrained parameter matrix after
    ``num_steps`` updates; ``chi2_history`` is the per-step minimum reduced
    chi2 across samples, each evaluated before that step's update. Without
    ``start`` the starts are prior draws from a ``torch.Generator`` seeded
    with ``seed`` on the simulator's device.
    """
    event_size = float(prob_model.event_size(simulator))
    if start is None:
        gen = torch.Generator(device=simulator.device).manual_seed(seed)
        prior = prob_model.prior
        z = prior.unconstrain(prior.sample(gen, n_samples))
    else:
        z = torch.as_tensor(start, dtype=torch.float32, device=simulator.device)
    z = z.detach().clone()

    state = optimizer.init(z)
    hist = []
    for _ in range(num_steps):
        z.requires_grad_(True)
        lp, chisq = prob_model.log_prob(simulator, z)
        loss = -torch.mean(lp) / event_size
        (grad,) = torch.autograd.grad(loss, z)
        with torch.no_grad():
            updates, state = optimizer.update(grad, state, z)
            z = z.detach() + updates
            hist.append(_nanmin(chisq.detach()))
    return z, torch.stack(hist) if hist else torch.empty(0, device=z.device)


@torch.no_grad()
def best_start(prob_model, simulator, z):
    """Selects the highest-posterior sample; returns it shaped (1, d)."""
    lp, _ = prob_model.log_prob(simulator, z)
    # diverged starts carry NaN log-posteriors; argmax would pick a NaN
    lp = torch.where(torch.isnan(lp), -torch.inf, lp)
    return z[torch.argmax(lp)][None, :]
