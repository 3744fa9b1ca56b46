"""Stochastic variational inference with a full-rank MVN surrogate
(port of :mod:`gigalens_tpu.inference.svi`).

The variational family is MultivariateNormalTriL parameterized by
``[mean, FillScaleTriL^{-1}(scale)]`` (or a diagonal scale, mean-field) and
the ELBO is a reparameterized Monte-Carlo estimate over ``n_vi`` draws. The
Adam loop is plain Python on the device; the per-step losses stay there
until the end.

Non-finite draws (F-ref-1): the JAX package masks their ELBO terms in the
forward pass only, and their gradient still reaches the variational
parameters as ``0 * NaN``. Here a hook on the draws also zeroes those
draws' gradient rows, so one pathological draw never poisons the fit.
With every draw finite the two are identical.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from gigalens_tpu_torch.inference.optim import GradientTransformation
from gigalens_tpu_torch.prob.bijectors import FillScaleTriL
from gigalens_tpu_torch.prob.distributions import MultivariateNormalTriL


def _run_adam_loop(loss_and_grad, params0, optimizer, num_steps, generator,
                   segment_steps, polyak_fraction, progress):
    """Adam over ``num_steps`` with Polyak tail averaging.

    ``loss_and_grad(params, generator) -> (loss, grads)``. ``progress``, if
    given, is called after every segment of ``segment_steps`` steps (all of
    them when 0) with ``(steps_done, last_loss)``. Returns
    ``(final_params, losses)``; ``losses[i]`` is the loss at the parameters
    before update i.
    """
    avg_start = (int(num_steps * (1.0 - polyak_fraction))
                 if polyak_fraction > 0 else num_steps)
    n_seg = segment_steps if segment_steps > 0 else max(num_steps, 1)
    params = params0.detach().clone()
    state = optimizer.init(params)
    avg = torch.zeros_like(params)
    n_avg = 0
    losses = []
    for t in range(num_steps):
        loss, grads = loss_and_grad(params, generator)
        with torch.no_grad():
            updates, state = optimizer.update(grads, state, params)
            params = params + updates
            if t >= avg_start:
                avg = avg + params
                n_avg += 1
        losses.append(loss)
        if progress is not None and ((t + 1) % n_seg == 0 or t + 1 == num_steps):
            progress(t + 1, float(loss))
    if polyak_fraction > 0 and n_avg > 0:
        params = avg / n_avg
    empty = torch.empty(0, device=params.device)
    return params, torch.stack(losses) if losses else empty


def surrogate_unpacker(d, full_rank=True):
    """``qz_params -> (mean, tril)``: ``[mean, FillScaleTriL^{-1}(L)]``
    (full rank) or ``[mean, log scales]`` (mean-field, scale =
    exp + 1e-6)."""
    if full_rank:
        cov_bij = FillScaleTriL(d, diag_shift=1e-6)
        return lambda p: (p[:d], cov_bij.forward(p[d:]))
    return lambda p: (p[:d], torch.diag(torch.exp(p[d:]) + 1e-6))


def elbo_loss(prob_model, simulator, mean, tril, eps):
    """Negative ELBO estimate on the draws ``z = mean + eps @ tril.T``,
    averaged over the draws whose term is finite (F-ref-1: the others also
    contribute no gradient)."""
    d = eps.shape[-1]
    z = mean + eps @ tril.T
    # pathwise log q(z(eps)) = -|eps|^2/2 - log det L - d/2 log 2pi: q's own
    # triangular solve of its samples is ill-conditioned once L has large
    # off-diagonal entries
    lp_q = (-0.5 * torch.sum(eps**2, dim=-1)
            - torch.sum(torch.log(torch.abs(torch.diagonal(tril))))
            - 0.5 * d * math.log(2 * math.pi))
    lp_model, _ = prob_model.log_prob(simulator, z)
    val = lp_q - lp_model
    finite = torch.isfinite(val).detach()
    if z.requires_grad:
        # masked draws contribute no gradient, not 0 * NaN
        z.register_hook(lambda g: torch.where(finite[:, None], g, 0.0))
    val = torch.where(finite, val, 0.0)
    return torch.sum(val) / torch.clamp(torch.sum(finite), min=1)


def fit_svi(
    prob_model,
    simulator,
    start,
    optimizer: GradientTransformation,
    n_vi: int = 250,
    init_scales=1e-3,
    num_steps: int = 500,
    seed: int = 0,
    segment_steps: int = 0,
    polyak_fraction: float = 0.25,
    full_rank: bool = True,
    progress=None,
):
    """Returns (q_z: MultivariateNormalTriL, elbo_loss_history).

    ``init_scales``: a scalar (isotropic), a (d,) vector (diagonal) or a
    (d, d) matrix used as the initial factor (e.g. ``laplace_scale_tril``).
    ``polyak_fraction > 0`` returns the surrogate at the average of the
    variational parameters over the last fraction of steps. ``full_rank=
    False`` selects the mean-field ansatz (d log-scales; a matrix
    ``init_scales`` contributes its row norms, the marginal stddevs).
    Draws come from a ``torch.Generator`` seeded with ``seed`` on the
    simulator's device.
    """
    device = simulator.device
    d = prob_model.prior.d
    scale0 = np.asarray(init_scales, np.float32)
    if scale0.size == 1:
        scale0 = np.eye(d, dtype=np.float32) * float(scale0)
    elif scale0.ndim == 1:
        scale0 = np.diag(scale0)
    scale0 = torch.as_tensor(scale0, device=device)
    start = torch.as_tensor(start, dtype=torch.float32, device=device).detach().reshape(d)
    unpack = surrogate_unpacker(d, full_rank)
    if full_rank:
        params0 = torch.cat([start, FillScaleTriL(d, diag_shift=1e-6).inverse(scale0)])
    else:
        # marginal stddevs sqrt(diag(L L^T)) = row norms of L, not |diag(L)|,
        # which underestimates dimensions carried by off-diagonal entries
        diag0 = torch.clamp(torch.sqrt(torch.sum(scale0**2, dim=-1)), min=1e-8)
        params0 = torch.cat([start, torch.log(diag0)])

    def loss_and_grad(qz_params, generator):
        qz_params = qz_params.detach().requires_grad_(True)
        mean, tril = unpack(qz_params)
        eps = torch.randn((n_vi, d), generator=generator, device=device)
        loss = elbo_loss(prob_model, simulator, mean, tril, eps)
        (grad,) = torch.autograd.grad(loss, qz_params)
        return loss.detach(), grad

    generator = torch.Generator(device=device).manual_seed(seed)
    qz_params, losses = _run_adam_loop(
        loss_and_grad, params0, optimizer, num_steps, generator, segment_steps,
        polyak_fraction, progress,
    )
    with torch.no_grad():
        mean, tril = unpack(qz_params)
    return MultivariateNormalTriL(mean, tril), losses


def importance_evidence(prob_model, simulator, q_z, n_samples=4096, seed=0, batch=None,
                        sample=None):
    """Importance-sampled log-evidence with the SVI surrogate as proposal:
    ``log Z = logsumexp(log p(data, z) - log q(z)) - log n`` over draws
    ``z ~ q``, a cross-check of ``SMCResult.log_evidence``. Trust it only
    when the returned ``n_eff`` (the importance weights' effective sample
    size, ``(sum w)^2 / sum w^2``) is well above a few.

    ``simulator`` must be built with ``bs = batch`` (default: ``n_samples``).
    ``sample(batch) -> (batch, d)`` draws from ``q_z`` (default: ``q_z.sample``
    on a generator seeded with ``seed`` on the surrogate's device). Returns
    ``(log_z, n_eff)`` as floats."""
    batch = batch or n_samples
    if sample is None:
        generator = torch.Generator(device=q_z.loc.device).manual_seed(seed)
        sample = lambda b: q_z.sample(generator, (b,))  # noqa: E731
    logw = []
    with torch.no_grad():
        for _ in range(-(-n_samples // batch)):
            z = torch.as_tensor(sample(batch), dtype=torch.float32, device=q_z.loc.device)
            lp, _ = prob_model.log_prob(simulator, z)
            logw.append(lp - q_z.log_prob(z))  # (batch,) log importance weights
        logw = torch.cat(logw)[:n_samples]
        lse = torch.logsumexp(logw, dim=0)
        log_z = lse - math.log(logw.shape[0] * 1.0)
        n_eff = torch.exp(2 * lse - torch.logsumexp(2 * logw, dim=0))
    return float(log_z), float(n_eff)
