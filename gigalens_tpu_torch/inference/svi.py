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

Survey mode (``fit_svi_survey``, ``importance_evidence_survey``): S
surrogates, one a scene, fitted together on batches of S * n scene-major
draws; each scene's ELBO (and its finite-draw mask) is its own, and the
gradient of their sum reaches each surrogate from its own scene only.

Under a mesh (:mod:`gigalens_tpu_torch.parallel`) the surrogates are
replicated and each rank scores its share of every scene's draws. Each
rank divides its draws' loss sum by the global count of finite draws, and
one ``all_reduce`` a step sums the ranks' losses and gradients, as the
JAX package's gradient all-reduce does: N ranks add the draws in another
order than one, so they agree with it to float32 rounding.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from gigalens_tpu_torch.inference.optim import GradientTransformation
from gigalens_tpu_torch.model import resolve_device
from gigalens_tpu_torch.parallel import mesh as pmesh
from gigalens_tpu_torch.prob.bijectors import FillScaleTriL
from gigalens_tpu_torch.prob.distributions import MultivariateNormalTriL


def _run_adam_loop(loss_and_grad, params0, optimizer, num_steps, segment_steps,
                   polyak_fraction, progress):
    """Adam over ``num_steps`` with Polyak tail averaging.

    ``loss_and_grad(params) -> (loss, grads)``. ``progress``, if
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
        loss, grads = loss_and_grad(params)
        with torch.no_grad():
            updates, state = optimizer.update(grads, state, params)
            params = params + updates
            if t >= avg_start:
                avg = avg + params
                n_avg += 1
        losses.append(loss)
        if progress is not None and ((t + 1) % n_seg == 0 or t + 1 == num_steps):
            progress(t + 1, float(loss.max()))  # the worst scene's in survey mode
    if polyak_fraction > 0 and n_avg > 0:
        params = avg / n_avg
    empty = torch.empty((0, *params.shape[:-1]), device=params.device)
    return params, torch.stack(losses) if losses else empty


def surrogate_unpacker(d, full_rank=True):
    """``qz_params -> (mean, tril)``: ``[mean, FillScaleTriL^{-1}(L)]``
    (full rank) or ``[mean, log scales]`` (mean-field, scale =
    exp + 1e-6), along the last axis of ``qz_params`` (a leading scene
    axis gives (S, d) means and (S, d, d) factors)."""
    if full_rank:
        cov_bij = FillScaleTriL(d, diag_shift=1e-6)
        return lambda p: (p[..., :d], cov_bij.forward(p[..., d:]))
    return lambda p: (p[..., :d], torch.diag_embed(torch.exp(p[..., d:]) + 1e-6))


def _log_q(eps, tril):
    """Pathwise log q(z(eps)) = -|eps|^2/2 - log det L - d/2 log 2pi for
    draws ``eps`` (..., n, d) of factors ``tril`` (..., d, d): q's own
    triangular solve of its samples is ill-conditioned once L has large
    off-diagonal entries."""
    log_det = torch.sum(torch.log(torch.abs(torch.diagonal(tril, dim1=-2, dim2=-1))), dim=-1)
    return (-0.5 * torch.sum(eps**2, dim=-1) - log_det[..., None]
            - 0.5 * eps.shape[-1] * math.log(2 * math.pi))


def _elbo_terms(prob_model, simulator, mean, tril, eps):
    """:func:`elbo_loss`'s per-draw terms, 0 where not finite, and the
    finite mask."""
    d = eps.shape[-1]
    z = mean[..., None, :] + eps @ tril.transpose(-1, -2)
    lp_model, _ = prob_model.log_prob(simulator, z.reshape(-1, d))
    val = _log_q(eps, tril) - lp_model.reshape(z.shape[:-1])
    finite = torch.isfinite(val).detach()
    if z.requires_grad:
        # masked draws contribute no gradient, not 0 * NaN
        z.register_hook(lambda g: torch.where(finite[..., None], g, 0.0))
    return torch.where(finite, val, 0.0), finite


def elbo_loss(prob_model, simulator, mean, tril, eps):
    """Negative ELBO estimate on the draws ``z = mean + eps @ tril.T``,
    averaged over the draws whose term is finite (F-ref-1: the others also
    contribute no gradient). With a leading scene axis (``mean`` (S, d),
    ``tril`` (S, d, d), ``eps`` (S, n, d)) the draws are scored as S * n
    scene-major rows and the result is the (S,) per-scene losses."""
    val, finite = _elbo_terms(prob_model, simulator, mean, tril, eps)
    return torch.sum(val, dim=-1) / torch.clamp(torch.sum(finite, dim=-1), min=1)


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
    mesh=None,
):
    """Returns (q_z: MultivariateNormalTriL, elbo_loss_history).

    ``init_scales``: a scalar (isotropic), a (d,) vector (diagonal) or a
    (d, d) matrix used as the initial factor (e.g. ``laplace_scale_tril``).
    ``polyak_fraction > 0`` returns the surrogate at the average of the
    variational parameters over the last fraction of steps. ``full_rank=
    False`` selects the mean-field ansatz (d log-scales; a matrix
    ``init_scales`` contributes its row norms, the marginal stddevs).
    Draws come from a ``torch.Generator`` seeded with ``seed`` on the
    simulator's device. This is :func:`fit_svi_survey` with one scene.
    """
    d = prob_model.prior.d
    scale0 = np.asarray(init_scales, np.float32)
    if scale0.ndim == 2:
        scale0 = scale0[None]  # the one scene's factor
    start = torch.as_tensor(start, dtype=torch.float32, device=simulator.device).reshape(1, d)
    means, trils, losses = fit_svi_survey(
        prob_model, simulator, start, optimizer, n_vi=n_vi, init_scales=scale0,
        num_steps=num_steps, seed=seed, segment_steps=segment_steps,
        polyak_fraction=polyak_fraction, full_rank=full_rank, progress=progress, mesh=mesh)
    return MultivariateNormalTriL(means[0], trils[0]), losses[:, 0]


def _survey_scales(init_scales, S, d):
    """``init_scales`` of :func:`fit_svi_survey` as (S, d, d) float32."""
    scale0 = np.asarray(init_scales, np.float32)
    if scale0.size == 1:
        return np.broadcast_to(np.eye(d, dtype=np.float32) * float(scale0), (S, d, d))
    if scale0.ndim == 1:
        if scale0.shape != (d,):
            raise ValueError(f"1-D init_scales must be ({d},); got {scale0.shape}")
        return np.broadcast_to(np.diag(scale0), (S, d, d))
    if scale0.ndim == 2:
        # (d, d): one factor shared by the scenes; (S, d): per-scene
        # diagonals. With S == d the two readings collide, and a wrong
        # reading would silently start from garbage: demand the 3-D form
        if S == d and scale0.shape == (d, d):
            raise ValueError(
                f"init_scales shape {scale0.shape} is ambiguous with S == d == {d}: pass "
                "(S, d, d) per-scene factors or np.broadcast_to(diag, (S, d, d))")
        if scale0.shape == (d, d):
            return np.broadcast_to(scale0, (S, d, d))
        if scale0.shape == (S, d):
            return np.stack([np.diag(r) for r in scale0])
        raise ValueError(
            f"2-D init_scales must be (d, d) shared or (S, d) per-scene diagonals; got "
            f"{scale0.shape} with S={S}, d={d}")
    if scale0.shape != (S, d, d):
        raise ValueError(f"3-D init_scales must be ({S}, {d}, {d}); got {scale0.shape}")
    return scale0


def fit_svi_survey(
    prob_model,
    simulator,
    starts,
    optimizer: GradientTransformation,
    n_vi: int = 64,
    init_scales=1e-3,
    num_steps: int = 300,
    seed: int = 0,
    mesh=None,
    segment_steps: int = 0,
    polyak_fraction: float = 0.25,
    full_rank: bool = True,
    progress=None,
    draws=None,
):
    """Per-scene SVI for survey mode: S independent MVN surrogates fitted
    together. Returns ``(means (S, d), trils (S, d, d), losses (num_steps,
    S))``, the loss history per scene.

    ``starts`` (S, d) are the initial means (e.g. per-scene MAP points);
    ``prob_model`` scores scene-major batches and ``simulator`` is built
    with ``bs = S * n_vi``. ``init_scales``: a scalar, a (d,) diagonal, one
    (d, d) factor shared by the scenes, (S, d) per-scene diagonals or (S, d,
    d) per-scene factors (e.g. :func:`laplace_scale_trils_survey`).
    ``draws(shape)`` gives each step's (S, n_vi, d) standard normals
    (default: a ``torch.Generator`` seeded with ``seed`` on the simulator's
    device). ``progress`` receives the worst scene's loss. ``mesh`` shards
    each scene's ``n_vi`` draws over its ranks (``simulator`` at one rank's
    share, ``S * n_vi / size``); every rank returns the same surrogates."""
    device = simulator.device
    starts = torch.as_tensor(starts, dtype=torch.float32, device=device).detach()
    S, d = starts.shape
    scale0 = torch.as_tensor(np.ascontiguousarray(_survey_scales(init_scales, S, d)),
                             device=device)
    unpack = surrogate_unpacker(d, full_rank)
    if full_rank:
        params0 = torch.cat([starts, FillScaleTriL(d, diag_shift=1e-6).inverse(scale0)], dim=1)
    else:
        # marginal stddevs sqrt(diag(L L^T)) = row norms of L, not |diag(L)|,
        # which underestimates dimensions carried by off-diagonal entries
        diag0 = torch.clamp(torch.sqrt(torch.sum(scale0**2, dim=-1)), min=1e-8)
        params0 = torch.cat([starts, torch.log(diag0)], dim=1)
    if draws is None:
        generator = torch.Generator(device=device).manual_seed(seed)
        draws = lambda shape: torch.randn(shape, generator=generator, device=device)  # noqa: E731

    sharded = mesh is not None and mesh.size > 1

    def loss_and_grad(qz_params):
        qz_params = qz_params.detach().requires_grad_(True)
        mean, tril = unpack(qz_params)
        eps = torch.as_tensor(draws((S, n_vi, d)), dtype=torch.float32, device=device)
        if not sharded:
            per_scene = elbo_loss(prob_model, simulator, mean, tril, eps)
        else:
            # this rank's draws of every scene over the global finite count
            val, finite = _elbo_terms(prob_model, simulator, mean, tril,
                                      pmesh.shard_samples(eps, mesh, dim=1))
            count = pmesh.all_sum(mesh, torch.sum(finite, dim=-1))
            per_scene = torch.sum(val, dim=-1) / torch.clamp(count, min=1)
        # the sum of independent per-scene losses: each surrogate receives
        # exactly the gradient of its own scene's ELBO
        (grad,) = torch.autograd.grad(torch.sum(per_scene), qz_params)
        if not sharded:
            return per_scene.detach(), grad
        return pmesh.all_sum(mesh, per_scene.detach(), grad)

    qz_params, losses = _run_adam_loop(
        loss_and_grad, params0, optimizer, num_steps, segment_steps,
        polyak_fraction, progress,
    )
    with torch.no_grad():
        mean, tril = unpack(qz_params)
    return mean, tril, losses


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


def importance_evidence_survey(prob_model, simulator, means, trils, n_samples=1024, seed=0,
                               device=None, draws=None):
    """Per-scene importance-sampled log-evidence with the survey surrogates
    ``means`` (S, d) / ``trils`` (S, d, d) as proposals, from one batch of
    S * ``n_samples`` scene-major draws (``simulator`` built with ``bs = S
    * n_samples``): :func:`importance_evidence` a scene, with the same
    trust gate on each scene's weight ESS. ``device`` defaults to the
    simulator's; ``draws(shape)`` gives the (S, n_samples, d) standard
    normals (default: a generator seeded with ``seed``). Returns numpy
    ``(log_z (S,), n_eff (S,))``."""
    device = resolve_device(device if device is not None else getattr(simulator, "device", None))
    means = torch.as_tensor(means, dtype=torch.float32, device=device)
    trils = torch.as_tensor(trils, dtype=torch.float32, device=device)
    S, d = means.shape
    if draws is None:
        generator = torch.Generator(device=device).manual_seed(seed)
        draws = lambda shape: torch.randn(shape, generator=generator, device=device)  # noqa: E731
    eps = torch.as_tensor(draws((S, n_samples, d)), dtype=torch.float32, device=device)
    with torch.no_grad():
        z = means[:, None, :] + eps @ trils.transpose(-1, -2)
        lp, _ = prob_model.log_prob(simulator, z.reshape(S * n_samples, d))
        logw = lp.reshape(S, n_samples) - _log_q(eps, trils)
        lse1 = torch.logsumexp(logw, dim=1)
        lse2 = torch.logsumexp(2 * logw, dim=1)
    log_z = lse1 - math.log(n_samples * 1.0)
    return log_z.cpu().numpy(), torch.exp(2 * lse1 - lse2).cpu().numpy()
