"""Multi-start MAP and the Laplace initializer (port of
:mod:`gigalens_tpu.inference.map`).

The MAP step is a plain Python loop on the device: loss = ``-mean(lp) /
event_size`` (the reference's convention), autograd, then the optimizer
update. The per-step minimum reduced chi2 stays on the device; the loop
waits for the card only where a ``progress`` callback asks for a value.
Under a mesh (:mod:`gigalens_tpu_torch.parallel`) each rank steps its shard
of the starts: the loss is the shard's sum over the global count, so every
row's gradient (and, Adam being elementwise, its update) is the one a
single rank computes; the chi2 minima cross the ranks once a segment.

``laplace_scale_tril`` takes the Hessian of the unconstrained log posterior
at the MAP point, by central differences of one batched gradient
(``method="fd"``) or by double backward (``method="exact"``);
``laplace_scale_trils_survey`` takes the FD Hessians of S scenes' MAP
points from one scene-major gradient batch.
"""
from __future__ import annotations

import torch

from gigalens_tpu_torch.inference.optim import GradientTransformation
from gigalens_tpu_torch.parallel import mesh as pmesh
from gigalens_tpu_torch.utils.profiling import span


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
    segment_steps: int = 0,
    progress=None,
    mesh=None,
    n_groups: int = 1,
):
    """Runs multi-start Adam; returns (z, chi2_history).

    ``z`` is the (n_samples, d) unconstrained parameter matrix after
    ``num_steps`` updates; ``chi2_history`` is the per-step minimum reduced
    chi2 across samples, each evaluated before that step's update. Without
    ``start`` the starts are prior draws from a ``torch.Generator`` seeded
    with ``seed`` on the simulator's device.

    ``progress``, if given, is called after every segment of
    ``segment_steps`` steps (all of them when 0) with ``(steps_done,
    min_reduced_chi2_of_the_segment)``.

    ``mesh`` shards the ``n_samples`` rows (seen as ``n_groups`` groups,
    e.g. a survey's scenes) over its ranks; ``simulator`` is then built at
    one rank's share, and every rank returns the global ``z``.
    """
    event_size = float(prob_model.event_size(simulator))
    if start is None:
        gen = torch.Generator(device=simulator.device).manual_seed(seed)
        prior = prob_model.prior
        z = prior.unconstrain(prior.sample(gen, n_samples))
    else:
        z = torch.as_tensor(start, dtype=torch.float32, device=simulator.device)
    n_global = z.shape[0]
    z = pmesh.shard_samples(z.detach(), mesh, n_groups).clone()
    n_seg = segment_steps if segment_steps > 0 else max(num_steps, 1)

    state = optimizer.init(z)
    hist = []
    for step in range(num_steps):
        with span("map.step", str(step)):
            z.requires_grad_(True)
            lp, chisq = prob_model.log_prob(simulator, z)
            loss = -torch.sum(lp) / n_global / event_size
            with span("map.backward"):
                (grad,) = torch.autograd.grad(loss, z)
            with torch.no_grad():
                with span("map.update"):
                    updates, state = optimizer.update(grad, state, z)
                    z = z.detach() + updates
                hist.append(_nanmin(chisq.detach()))
        done = step + 1
        if progress is not None and (done % n_seg == 0 or done == num_steps):
            seg = hist[(done - 1) // n_seg * n_seg:]
            progress(done, float(pmesh.all_min(mesh, _nanmin(torch.stack(seg)))))
    z = pmesh.gather_samples(z, mesh, n_groups)
    if not hist:
        return z, torch.empty(0, device=z.device)
    return z, pmesh.all_min(mesh, torch.stack(hist))


@torch.no_grad()
def best_start(prob_model, simulator, z, mesh=None):
    """Selects the highest-posterior sample of ``z``; returns it shaped (1,
    d). Under ``mesh`` each rank scores its shard (``simulator`` at one
    rank's share) and the log-posteriors are gathered."""
    lp, _ = prob_model.log_prob(simulator, pmesh.shard_samples(z, mesh))
    lp = pmesh.gather_samples(lp, mesh)
    # diverged starts carry NaN log-posteriors; argmax would pick a NaN
    lp = torch.where(torch.isnan(lp), -torch.inf, lp)
    return z[torch.argmax(lp)][None, :]


def _floored_inv_chol(h, d, floor_ratio):
    """chol(H^{-1}) with the |eigenvalue| floor (shared by both methods)."""
    h = 0.5 * (h + h.T)
    lam, vec = torch.linalg.eigh(h)
    # |lam|: at an approximate optimum the Hessian can be indefinite; the
    # magnitude still measures curvature scale in that direction
    lam = torch.maximum(torch.abs(lam), torch.max(torch.abs(lam)) * floor_ratio)
    cov = (vec / lam) @ vec.T
    cov = 0.5 * (cov + cov.T)
    eye = torch.eye(d, dtype=cov.dtype, device=cov.device)
    return torch.linalg.cholesky(cov + torch.trace(cov) / d * 1e-6 * eye)


def _fd_hessians(prob_model, simulator, zs):
    """(S, d, d) Hessians of the negative log posterior at the rows of ``zs``
    (S, d), by central differences of one gradient of S * 2d scene-major
    rows (row block s: scene s's d forward steps, then its d backward
    ones), with the step ``1e-3 * max(|z|, 1)`` per dimension."""
    S, d = zs.shape
    hstep = 1e-3 * torch.clamp(torch.abs(zs), min=1.0)  # (S, d)
    pert = hstep[:, :, None] * torch.eye(d, dtype=zs.dtype, device=zs.device)
    batch = torch.cat([zs[:, None] + pert, zs[:, None] - pert], dim=1).reshape(S * 2 * d, d)
    batch.requires_grad_(True)
    lp = prob_model.log_prob(simulator, batch)[0]
    (g,) = torch.autograd.grad(-torch.sum(lp), batch)
    g = g.reshape(S, 2 * d, d)
    return (g[:, :d] - g[:, d:]) / (2.0 * hstep[:, :, None])


def laplace_scale_trils_survey(prob_model, simulator, z_best, floor_ratio: float = 1e-6):
    """Per-scene Laplace factors for survey mode: ``laplace_scale_tril``'s
    FD method at each of the S scenes' MAP points ``z_best`` (S, d), from
    one gradient of S * 2d scene-major rows (the simulator must be built
    with ``bs = S * 2 * d``; ``prob_model`` scores scene-major batches).
    Returns the (S, d, d) factors on the simulator's device."""
    zs = torch.as_tensor(z_best, dtype=torch.float32, device=simulator.device).detach()
    d = zs.shape[-1]
    h = _fd_hessians(prob_model, simulator, zs)
    return torch.stack([_floored_inv_chol(hs, d, floor_ratio) for hs in h])


def laplace_scale_tril(prob_model, simulator, z_best, floor_ratio: float = 1e-6,
                       method: str = "exact"):
    """Cholesky factor of the Laplace covariance at the MAP point.

    Computes the Hessian of the unconstrained log posterior at ``z_best``
    (shape (1, d) or (d,)), eigen-floors it for positive-definiteness, and
    returns ``chol(H^{-1})`` as a (d, d) tensor on the simulator's device.

    ``method="fd"``: central differences of the gradient with the step
    ``1e-3 * max(|z|, 1)`` per dimension, all 2d perturbed points in one
    batched gradient (the simulator must be built with ``bs = 2 * d``).
    ``method="exact"``: d rows of double backward through the log posterior
    (``bs = 1``); every profile's custom backward is built from
    differentiable torch ops, so the second derivative is exact.
    """
    z_best = torch.as_tensor(z_best, dtype=torch.float32, device=simulator.device)
    z = z_best.detach().reshape(-1)
    d = z.shape[0]

    if method == "fd":
        return _floored_inv_chol(_fd_hessians(prob_model, simulator, z[None])[0], d, floor_ratio)
    if method != "exact":
        raise ValueError(f"unknown Laplace method {method!r}: use 'fd' or 'exact'")

    def neg_lp(zrow):
        return -prob_model.log_prob(simulator, zrow[None, :])[0][0]

    h = torch.autograd.functional.hessian(neg_lp, z)
    return _floored_inv_chol(h.detach(), d, floor_ratio)
