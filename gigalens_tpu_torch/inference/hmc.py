"""Preconditioned Hamiltonian Monte Carlo (port of :mod:`gigalens_tpu.inference.hmc`).

One batched chain loop on the device:

  * momentum ~ N(0, M) with mass matrix M = Sigma^{-1}, drawn through
    L^{-T} (Sigma = L L^T); the kinetic energy is |L^T p|^2 / 2 and the
    leapfrog drift is ``z += eps * (Sigma @ p)``, so Sigma is never
    inverted;
  * scalar step size adapted by Nesterov dual averaging on the cross-chain
    mean acceptance during the first ``num_adaptation_steps`` (0.8 of the
    burn-in);
  * trajectory length static (``init_l`` leapfrog steps) or adapted by
    ChEES with Halton jitter, capped at ``max_leapfrog_steps``;
  * Stan-style windowed mass adaptation (shrunk toward the current
    preconditioner, centred moment accumulators), the |dH| > 25 divergence
    count and the total leapfrog count.

The step counter is a host integer, so the adaptation switches are Python
branches. The leapfrog loop runs ``int(n_steps.max())`` steps, read from
the device once per HMC step: the only per-step host sync.

Under a mesh (:mod:`gigalens_tpu_torch.parallel`) the (G, C) chain view is
sharded along C: every rank holds all G groups and C / size chains of
each, and draws its rows of the global momenta and uniforms. During the
adaptation each step gathers every rank's chains (positions before and
after, proposals, final momenta, acceptance probabilities: ``all_gather``
of (G, C, 4d + 1) floats), and every rank runs the cross-chain statistics
(ChEES's chain means and weighted sums, dual averaging's acceptance mean,
the mass-adaptation moments) on them by the same operations, in the order
one rank runs them. The step size, trajectory length and preconditioner
are then the same on every rank, and so is the leapfrog count read back
each step. After the burn-in no step crosses ranks; the acceptance history
and the samples are gathered at the end. Not ported: the
JAX package's program caches (``_hmc_programs``' ``lru_cache``,
``_cached_log_prob_fn``, ``clear_program_caches``) and ``aot_desc``, which
exist because every TPU program is a remote compile; eager torch compiles
nothing.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from gigalens_tpu_torch.parallel import mesh as pmesh


class DualAveragingState(NamedTuple):
    log_eps: torch.Tensor
    log_eps_bar: torch.Tensor
    h_bar: torch.Tensor
    mu: torch.Tensor       # shrinkage anchor log(10 * eps at (re)start)
    t_start: torch.Tensor  # step at which this adaptation (re)started


class ChEESState(NamedTuple):
    log_t: torch.Tensor   # log total trajectory length T
    adam_m: torch.Tensor
    adam_v: torch.Tensor


class HMCResult(NamedTuple):
    samples: torch.Tensor        # (num_results, n_chains, d)
    accept_rate: torch.Tensor    # (total_steps,) mean accept prob per step
    step_size: torch.Tensor      # final (adapted) step size; (G,) when grouped
    final_state: torch.Tensor    # (n_chains, d)
    trajectory_length: torch.Tensor  # final T (chees) or L * eps
    # (n_chains,) post-adaptation proposals with |dH| > 25
    divergences: torch.Tensor
    # leapfrog steps integrated over the run (max over groups per step)
    total_leapfrogs: int = 0


def _da_init(eps0, t_start=0):
    """eps0 may be a scalar or a (G,) per-group tensor; the state matches it."""
    eps0 = torch.as_tensor(eps0, dtype=torch.float32)
    log_eps = torch.log(eps0)
    return DualAveragingState(
        log_eps, log_eps, torch.zeros_like(log_eps), torch.log(10.0 * eps0),
        torch.full_like(log_eps, float(t_start)),
    )


def _da_update(state: DualAveragingState, t, accept_prob,
               target=0.75, gamma=0.05, t0=10.0, kappa=0.75):
    tf = torch.clamp(t - state.t_start, min=0.0) + 1.0
    w = 1.0 / (tf + t0)
    h_bar = (1.0 - w) * state.h_bar + w * (target - accept_prob)
    log_eps = state.mu - torch.sqrt(tf) / gamma * h_bar
    eta = tf ** (-kappa)
    log_eps_bar = eta * log_eps + (1.0 - eta) * state.log_eps_bar
    return DualAveragingState(log_eps, log_eps_bar, h_bar, state.mu, state.t_start)


def _halton(n, base=2):
    """Van der Corput sequence in (0, 1): deterministic trajectory jitter."""
    seq = np.zeros(n)
    for i in range(n):
        f, r, idx = 1.0, 0.0, i + 1
        while idx > 0:
            f /= base
            r += f * (idx % base)
            idx //= base
        seq[i] = r
    return np.clip(seq, 0.05, 1.0).astype(np.float32)


def _lp_and_grad(log_prob_fn, z):
    """Log density and its gradient per chain (chains are independent, so
    the gradient of the sum is each chain's own); nothing keeps a graph."""
    z = z.detach().requires_grad_(True)
    lp = log_prob_fn(z)
    (g,) = torch.autograd.grad(lp.sum(), z)
    return lp.detach(), g.detach()


class HMCState(NamedTuple):
    """The chain state between steps: the JAX package's scan carry, less
    the step counter and the leapfrog total (host integers here)."""
    z: torch.Tensor       # (n_chains, d)
    lp: torch.Tensor      # (n_chains,)
    grad: torch.Tensor    # (n_chains, d)
    da: DualAveragingState
    ch: ChEESState
    tril: torch.Tensor    # (G, d, d) preconditioner factor, Sigma = L L^T
    s1: torch.Tensor      # (G, d) moment accumulators, centred on z_ref
    s2: torch.Tensor      # (G, d, d)
    cnt: torch.Tensor     # (G,)
    z_ref: torch.Tensor   # (G, d) window-start chain mean
    div: torch.Tensor     # (n_chains,) int32 divergence counts


def _init_state(log_prob_fn, z0, tril, step_size, num_leapfrog_steps, z_ref):
    """The state before step 0 of the chains ``z0`` (this rank's, under a
    mesh); ``tril`` is (G, d, d) and ``z_ref`` (G, d) the groups' mean
    start over every rank's chains."""
    G, d = tril.shape[0], z0.shape[1]
    f32 = dict(dtype=torch.float32, device=z0.device)
    lp, grad = _lp_and_grad(log_prob_fn, z0)
    return HMCState(
        z0, lp, grad, _da_init(torch.full((G,), float(step_size), **f32)),
        ChEESState(torch.full((G,), math.log(num_leapfrog_steps * step_size), **f32),
                   torch.zeros((G,), **f32), torch.zeros((G,), **f32)),
        tril, torch.zeros((G, d), **f32), torch.zeros((G, d, d), **f32),
        torch.zeros((G,), **f32), z_ref,
        torch.zeros((z0.shape[0],), dtype=torch.int32, device=z0.device))


def _hmc_step_fn(log_prob_fn, n_chains, d, n_groups, device, *, num_leapfrog_steps,
                 num_adaptation_steps, switch_ts, do_mass, chees, target_accept,
                 max_leapfrog_steps, chees_lr, mesh=None, chains=None):
    """``step(state, t, h, eps_n, u) -> (state, accept_sums, n_max)``: one
    HMC step (the step body of the JAX package's ``_hmc_programs``) at host
    step ``t`` with Halton jitter ``h``, momentum noise ``eps_n`` (n_chains,
    d) and acceptance uniforms ``u`` (n_chains,), for this rank's
    ``n_chains`` chains of ``mesh`` (all of them without one); ``chains``
    is the global number a group. ``accept_sums`` (G,) are the sums of
    this rank's acceptance probabilities a group, ``n_max`` the number of
    leapfrog steps integrated."""
    G = n_groups
    C = n_chains // G
    C_all = chains or C
    per_group = chees and G > 1
    eye = torch.eye(d, dtype=torch.float32, device=device)

    def rows(fn, a):
        """A per-chain product of (G, C, d) chains at every rank's chain
        count (:func:`~gigalens_tpu_torch.parallel.mesh.at_global_rows`)."""
        return pmesh.at_global_rows(fn, a, mesh, dim=1)

    def grp(a):  # (n, ...) -> (G, C, ...)
        return a.reshape(G, C, *a.shape[1:])

    def flat(a):  # (G, C, ...) -> (n, ...)
        return a.reshape(n_chains, *a.shape[2:])

    def kinetic(p, tril):
        # 0.5 p^T Sigma p as |L^T p|^2 / 2; p (G, C, d), tril (G, d, d)
        return 0.5 * torch.sum(rows(lambda a: torch.einsum("gcd,gdi->gci", a, tril), p) ** 2,
                               dim=-1)

    def leapfrog(z, p, grad, eps, n_steps, n_max, m_inv):
        """z/p/grad (G, C, d); eps (G, 1, 1); n_steps (G,) under chees. Groups
        with shorter trajectories freeze once their steps are exhausted."""
        p = p + 0.5 * eps * grad
        lp, g = None, grad
        for i in range(n_max):
            z_new = z + eps * rows(lambda a: torch.einsum("gcd,gde->gce", a, m_inv), p)
            if per_group:
                live = (i < n_steps)[:, None, None]
                z_new = torch.where(live, z_new, z)
            lp, g = _lp_and_grad(log_prob_fn, flat(z_new))
            lp, g = grp(lp), grp(g)
            p_new = p + eps * g
            if per_group:
                p_new = torch.where(live, p_new, p)
            z, p = z_new, p_new
        p = p - 0.5 * eps * g  # undo the extra half step of the last pass
        return z, p, lp, g

    def chees_grad(z, z_new, p_new, accept_prob_c, m_inv):
        """ChEES gradient estimate w.r.t. trajectory length, per group.

        A proposal that diverged to non-finite values (it is rejected)
        enters as its chain's current state with zero momentum and weight:
        in the JAX package its NaN reaches the cross-chain means and the
        weighted sum (``0 * NaN``), and the trajectory length stays NaN for
        the rest of the run, i.e. one leapfrog per step (F-ref-3)."""
        ok = (torch.isfinite(z_new).all(-1) & torch.isfinite(p_new).all(-1))[..., None]
        z_new = torch.where(ok, z_new, z)
        p_new = torch.where(ok, p_new, 0.0)
        accept_prob_c = torch.where(ok[..., 0], accept_prob_c, 0.0)
        zc = z - torch.mean(z, dim=1, keepdim=True)
        zc_new = z_new - torch.mean(z_new, dim=1, keepdim=True)
        delta = torch.sum(zc_new**2, -1) - torch.sum(zc**2, -1)  # (G, C)
        v_new = torch.einsum("gcd,gde->gce", p_new, m_inv)  # final velocity
        proj = torch.sum(zc_new * v_new, -1)
        w = accept_prob_c
        return torch.sum(w * delta * proj, dim=1) / torch.clamp(torch.sum(w, dim=1), min=1e-6)

    def all_chains(*tensors):
        """Every rank's chains of each (G, C, k) tensor, (G, C_all, k), from
        one gather (the tensors themselves on one rank)."""
        sizes = [a.shape[-1] for a in tensors]
        out = pmesh.gather_samples(torch.cat(tensors, dim=-1), mesh, dim=1)
        # contiguous, so the statistics reduce them as one rank reduces its own
        return [a.contiguous() for a in torch.split(out, sizes, dim=-1)]

    def step(s: HMCState, t: int, h: float, eps_n, u):
        da, ch, tril = s.da, s.ch, s.tril
        adapting = t < num_adaptation_steps
        m_inv = tril @ tril.transpose(-1, -2)  # Sigma per group
        inv_l = torch.linalg.solve_triangular(tril, eye.expand(G, d, d), upper=False)
        eps = torch.exp(da.log_eps if adapting else da.log_eps_bar)  # (G,)
        if chees:
            traj = h * torch.exp(ch.log_t)
            n_steps = torch.clamp(torch.ceil(traj / eps).to(torch.int32), 1, max_leapfrog_steps)
            n_max = int(n_steps.max())  # the one host sync per step
        else:
            n_steps = n_max = num_leapfrog_steps

        p0 = rows(lambda a: torch.einsum("gcd,gdi->gci", a, inv_l), grp(eps_n))  # L^{-T} eps
        z_g, lp_g, grad_g = grp(s.z), grp(s.lp), grp(s.grad)
        z_new, p_new, lp_new, grad_new = leapfrog(
            z_g, p0, grad_g, eps[:, None, None], n_steps, n_max, m_inv)

        log_accept = (lp_new - kinetic(p_new, tril)) - (lp_g - kinetic(p0, tril))
        log_accept = torch.where(torch.isnan(log_accept), -torch.inf, log_accept)
        accept_prob_c = torch.clamp(torch.exp(log_accept), max=1.0)  # (G, C)
        accept = grp(torch.log(u)) < log_accept  # (G, C)

        z = flat(torch.where(accept[..., None], z_new, z_g))
        lp = flat(torch.where(accept, lp_new, lp_g))
        grad = flat(torch.where(accept[..., None], grad_new, grad_g))

        div, s1, s2, cnt, z_ref = s.div, s.s1, s.s2, s.cnt, s.z_ref
        if not adapting:
            # endpoint-energy divergences, post-adaptation: both signs count;
            # NaN energies arrive here as -inf
            div = div + (torch.abs(flat(log_accept)) > 25.0).to(torch.int32)
        else:
            # the adaptation's cross-chain statistics run on every rank's
            # chains (one gather), by the same operations on every rank
            # and in the same order as on one rank
            z_a, zg_a, znew_a, pnew_a, acc_a = all_chains(
                grp(z), z_g, z_new, p_new, accept_prob_c[..., None])
            acc_a = acc_a[..., 0]
            if chees:
                g = chees_grad(zg_a, znew_a, pnew_a, acc_a, m_inv)  # (G,)
                b1, b2, eps_a = 0.9, 0.999, 1e-8
                adam_m = b1 * ch.adam_m + (1 - b1) * g
                adam_v = b2 * ch.adam_v + (1 - b2) * g**2
                m_hat = adam_m / (1 - b1 ** (t + 1))
                v_hat = adam_v / (1 - b2 ** (t + 1))
                log_t = ch.log_t + chees_lr * m_hat / (torch.sqrt(v_hat) + eps_a)
                # keep trajectories within [eps, max_leapfrog * eps]
                log_t = torch.minimum(torch.maximum(log_t, torch.log(eps)),
                                      torch.log(max_leapfrog_steps * eps))
                ch = ChEESState(log_t, adam_m, adam_v)
            da = _da_update(da, t, torch.mean(acc_a, dim=1), target=target_accept)

            # mass windows lie inside the adaptation (switch_ts[-1] <
            # num_adaptation_steps)
            if do_mass and t < switch_ts[-1]:
                # moments centred on the window-start chain mean: raw
                # E[zz^T] - mm^T cancels catastrophically in float32
                zc = z_a - z_ref[:, None]
                s1 = s1 + torch.sum(zc, dim=1)
                s2 = s2 + torch.einsum("gcd,gce->gde", zc, zc)
                cnt = cnt + C_all
            if do_mass and t in switch_ts:
                m = s1 / cnt[:, None]
                cov_est = s2 / cnt[:, None, None] - torch.einsum("gd,ge->gde", m, m)
                # shrink toward the current preconditioner's covariance
                w = (cnt / (cnt + 5.0 * d))[:, None, None]
                cov = w * cov_est + (1.0 - w) * m_inv
                tr = torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1)[:, None, None]
                cov = cov + 1e-3 * (tr / d) * eye
                # cholesky_ex: a group whose estimate is not PD keeps its
                # old factor (JAX's cholesky returns NaN there)
                tril_new, info = torch.linalg.cholesky_ex(cov)
                bad = ((info != 0) | torch.isnan(tril_new).flatten(1).any(1))[:, None, None]
                tril = torch.where(bad, tril, tril_new)
                # restart dual averaging at the current step size and reset
                # the trajectory length (preconditioned time units); the
                # accumulators restart centred on the current state
                eps_cur = torch.exp(da.log_eps)
                ch = ChEESState(torch.log(num_leapfrog_steps * eps_cur),
                                torch.zeros_like(eps_cur), torch.zeros_like(eps_cur))
                da = _da_init(eps_cur, t_start=t)
                s1, s2, cnt = torch.zeros_like(s1), torch.zeros_like(s2), torch.zeros_like(cnt)
                z_ref = torch.mean(z_a, dim=1)
        state = HMCState(z, lp, grad, da, ch, tril, s1, s2, cnt, z_ref, div)
        return state, torch.sum(accept_prob_c, dim=1), n_max

    return step


def sample_hmc(
    log_prob_fn,
    z0,
    generator: torch.Generator,
    *,
    step_size: float = 0.3,
    num_leapfrog_steps: int = 3,
    num_burnin_steps: int = 250,
    num_results: int = 750,
    num_adaptation_steps: Optional[int] = None,
    momentum_covariance=None,
    momentum_covariance_tril=None,
    target_accept: float = 0.75,
    trajectory_adaptation: str = "none",   # "none" | "chees"
    max_leapfrog_steps: int = 30,
    chees_lr: float = 0.025,
    mass_adaptation=True,
    segment_steps: int = 0,
    progress=None,
    n_groups: int = 1,
    mesh=None,
):
    """Batched preconditioned HMC. ``z0``: (n_chains, d); ``log_prob_fn``
    maps (n_chains, d) -> (n_chains,). Draws come from ``generator`` (on
    ``z0``'s device).

    ``mesh`` shards each group's chains over its ranks: ``z0`` and the
    draws are global, ``log_prob_fn`` scores one rank's (n_chains / size,
    d) share, and every rank returns the global result.

    ``n_groups > 1`` runs G independent adaptations over group-major chains:
    pass a per-group ``momentum_covariance_tril`` (G, d, d) (a single (d, d)
    factor is broadcast) and read ``step_size``/``trajectory_length`` back as
    (G,) tensors.

    ``mass_adaptation``: False, or the number of warmup windows (True == 1
    switch halfway through adaptation; ``k`` switches at fractions
    1/(k+1)..k/(k+1)). Each switch re-estimates the covariance from the
    window's pooled samples, restarts dual averaging at the current step
    size and resets the trajectory length.

    ``progress``, if given, is called after every segment of
    ``segment_steps`` steps (all of them when 0) with ``(steps_done,
    mean_accept_prob_of_segment)``.
    """
    z0 = z0.detach().to(torch.float32)
    device = z0.device
    n_chains, d = z0.shape
    G = n_groups
    if n_chains % G:
        raise ValueError(f"{n_chains} chains do not divide into {G} groups")
    if num_adaptation_steps is None:
        num_adaptation_steps = int(0.8 * num_burnin_steps)
    total_steps = num_burnin_steps + num_results
    chees = trajectory_adaptation == "chees"
    windows = int(mass_adaptation)
    switch_ts = tuple(num_adaptation_steps * (k + 1) // (windows + 1) for k in range(windows))
    switch_ts = tuple(sorted({st for st in switch_ts if st >= 10}))
    do_mass = bool(switch_ts) and num_adaptation_steps >= 20

    f32 = dict(dtype=torch.float32, device=device)
    if momentum_covariance_tril is not None:
        tril = torch.as_tensor(momentum_covariance_tril, **f32)
    elif momentum_covariance is not None:
        tril = torch.linalg.cholesky(torch.as_tensor(momentum_covariance, **f32))
    else:
        tril = torch.eye(d, **f32)
    if tril.ndim == 2:
        tril = tril.expand(G, d, d)
    elif tril.shape[0] != G:
        raise ValueError(f"per-group tril has leading dim {tril.shape[0]}, expected {G}")

    chains = n_chains // G
    z_loc = pmesh.shard_samples(z0, mesh, G)
    step = _hmc_step_fn(
        log_prob_fn, z_loc.shape[0], d, G, device, num_leapfrog_steps=num_leapfrog_steps,
        num_adaptation_steps=num_adaptation_steps, switch_ts=switch_ts, do_mass=do_mass,
        chees=chees, target_accept=target_accept, max_leapfrog_steps=max_leapfrog_steps,
        chees_lr=chees_lr, mesh=mesh, chains=chains)
    state = _init_state(log_prob_fn, z_loc, tril.contiguous(), step_size, num_leapfrog_steps,
                        torch.mean(z0.reshape(G, chains, d), dim=1))
    halton = _halton(total_steps) if chees else np.ones(total_steps, np.float32)
    nlf = 0
    zs, accs = [], []
    n_seg = segment_steps if segment_steps > 0 else max(total_steps, 1)
    for t in range(total_steps):
        eps_n = torch.randn((n_chains, d), generator=generator, **f32)
        u = torch.clamp(torch.rand((n_chains,), generator=generator, **f32), min=1e-10)
        state, acc, n_max = step(state, t, float(halton[t]),
                                 pmesh.shard_samples(eps_n, mesh, G),
                                 pmesh.shard_samples(u, mesh, G))
        nlf += n_max
        zs.append(state.z)
        accs.append(acc)
        done = t + 1
        if progress is not None and (done % n_seg == 0 or done == total_steps):
            seg = pmesh.all_sum(mesh, torch.stack(accs[(done - 1) // n_seg * n_seg:]))
            progress(done, float(torch.mean(seg / chains)))

    da, ch = state.da, state.ch
    z = pmesh.gather_samples(state.z, mesh, G)
    samples = (pmesh.gather_samples(torch.stack(zs[num_burnin_steps:]), mesh, G, dim=1)
               if num_results else z.new_zeros((0, n_chains, d)))
    accept_rate = torch.mean(pmesh.all_sum(mesh, torch.stack(accs)) / chains, dim=1)
    final_eps = torch.exp(da.log_eps_bar)
    final_t = torch.exp(ch.log_t) if chees else num_leapfrog_steps * final_eps
    if G == 1:  # the scalar API of the single-fit path
        final_eps, final_t = final_eps[0], final_t[0]
    return HMCResult(samples, accept_rate, final_eps, z, final_t,
                     pmesh.gather_samples(state.div, mesh, G), nlf)


def fit_hmc(
    prob_model,
    simulator,
    q_z,
    init_eps: float = 0.3,
    init_l: int = 3,
    n_hmc: int = 50,
    num_burnin_steps: int = 250,
    num_results: int = 750,
    max_leapfrog_steps: int = 30,
    trajectory_adaptation: str = "chees",
    mass_adaptation=True,
    init_spread: float = 0.2,
    seed: int = 0,
    seeds=None,
    segment_steps: int = 0,
    progress=None,
    mesh=None,
):
    """VI-preconditioned posterior sampling. ``q_z`` (a
    :class:`~gigalens_tpu_torch.prob.distributions.MultivariateNormalTriL`)
    gives M^{-1} = its covariance and the chains' starts: a cloud contracted
    by ``init_spread`` around its mean (draws from an overdispersed q land
    in high-curvature tails whose early divergences trap dual averaging).

    ``seeds`` (a sequence) runs one group of ``n_hmc`` chains per seed, each
    adapting on its own, in one batch: ``samples[:, g*n_hmc:(g+1)*n_hmc]``
    is seed ``seeds[g]``'s posterior. Each seed's start cloud is drawn from
    a ``torch.Generator`` seeded with it on the simulator's device; the
    chain then continues the first seed's generator. Returns
    :class:`HMCResult`. ``mesh`` shards each group's chains over its ranks
    (``simulator`` at one rank's share); every rank returns the global
    result.
    """
    if seeds is not None and len(seeds) > 1:
        n_groups = len(seeds)
    else:
        n_groups = 1
        if seeds:
            seed = seeds[0]
        seeds = [seed]
    device = simulator.device
    loc = q_z.mean().to(device)
    tril = q_z.scale_tril.to(device)

    gens = [torch.Generator(device=device).manual_seed(int(s)) for s in seeds]
    z0 = []
    for gen in gens:
        eps = torch.randn((n_hmc, loc.shape[-1]), generator=gen, device=device)
        z0.append(loc + init_spread * (eps @ tril.T))
    z0 = torch.cat(z0)  # group-major (G * n_hmc, d)

    def log_prob_fn(z):
        return prob_model.log_prob(simulator, z)[0]

    return sample_hmc(
        log_prob_fn, z0, gens[0],
        step_size=init_eps,
        num_leapfrog_steps=init_l,
        num_burnin_steps=num_burnin_steps,
        num_results=num_results,
        momentum_covariance_tril=tril,
        trajectory_adaptation=trajectory_adaptation,
        max_leapfrog_steps=max_leapfrog_steps,
        mass_adaptation=mass_adaptation,
        segment_steps=segment_steps,
        progress=progress,
        n_groups=n_groups,
        mesh=mesh,
    )
