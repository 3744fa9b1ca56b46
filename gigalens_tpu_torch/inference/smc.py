"""Sequential Monte Carlo with adaptive tempering (port of
:mod:`gigalens_tpu.inference.smc`).

The semantics of the JAX package's sampler:

  * tempered target ``prior + aux + (like - aux) * beta``, where ``like``
    and ``aux`` are selectable among {pixels, positions, pixels+positions,
    none} or a callable; the auxiliary likelihood stays on at full strength
    while the target likelihood is annealed in;
  * per-ensemble adaptive temperature steps chosen by bisection so that the
    effective sample size of the incremental weights stays at
    ``ess_threshold_ratio * num_particles``;
  * systematic resampling per ensemble;
  * HMC moves (preconditioned by the particle cloud's covariance) with
    per-particle step-size scalings tuned toward an 0.651 acceptance rate,
    and a per-stage move count chosen like TFP's
    ``simple_heuristic_tuning``;
  * a log-evidence estimate summed over the stages, and an optional post
    chain at beta = 1.

The tempering loop is a host loop: one host read a stage (the minimum
beta and the next stage's move count, which sizes the Python move loop)
and none a move. ``segment_stages`` only paces ``progress``. Every random
draw comes from one :class:`Draws` object, so a test can hand the sampler
the JAX package's arrays in place of the generator's (torch cannot
reproduce JAX's streams). Not ported: ``aot_desc``, which exists for the
TPU's remote compiles.

Under a mesh (:mod:`gigalens_tpu_torch.parallel`) each rank holds P / size
particles of every ensemble and evaluates and moves only those. A stage
starts with one ``all_gather`` of the particles with their cached parts,
gradients and scalings (a few hundred KB at 1000 particles): every rank
then runs the temperature bisection, the evidence increment, the
systematic resampling and the move preconditioner on the global cloud by
the same operations, and takes its rows of the resampled particles. The
stage's acceptances are gathered for the step-size tuning, and the
stage's host read comes out of those two gathers, the same on every rank
and computed in the order one rank computes it.

Degeneracy caveat, as in the JAX package: with ``auxiliar="positions"``,
prior draws near a critical curve carry position log-likelihoods of order
``-1e9``, absorb all weight at the first stage and collapse the ensemble.
Pass ``start=`` a MAP subsample when using a position auxiliary, or anneal
both terms with ``target="pixels+positions", auxiliar="none"``.
"""
from __future__ import annotations

import functools
import math
import time
from typing import NamedTuple

import torch

from gigalens_tpu_torch.model import resolve_device
from gigalens_tpu_torch.parallel import mesh as pmesh


class SMCResult(NamedTuple):
    particles: torch.Tensor      # (P, E, d) final particles at beta = 1
    num_stages: int
    log_scalings: torch.Tensor   # (P, E) final per-particle step-size logs
    post_samples: torch.Tensor   # (post_steps, P*E, d) optional HMC chain
    final_beta: torch.Tensor     # (E,) 1.0 unless max_stage was hit first
    # (E,) per-ensemble log evidence: the sum over stages of the log mean
    # incremental weight, log E_{prior * aux}[exp(like - aux)]. Meaningful
    # with start=None (exact prior draws) and final_beta == 1.
    log_evidence: torch.Tensor = None
    num_moves: int = 0           # HMC moves of the tempering stages
    tempering_s: float = 0.0     # host wall from the first evaluation to the last stage


class Draws:
    """Every random draw of :func:`fit_smc`, from one ``torch.Generator``
    in the order the sampler asks for them: the start (prior draws or
    picks from given starts), then for each stage the resampling uniforms
    and each move's momentum normals and acceptance uniforms, then the
    post chain's moves."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.device = generator.device

    def prior_sample(self, prior, shape):
        return prior.sample(self.generator, shape)

    def start_indices(self, n_start, shape, replace):
        n = math.prod(shape)
        if replace:
            return torch.randint(n_start, shape, generator=self.generator, device=self.device)
        return torch.randperm(n_start, generator=self.generator,
                              device=self.device)[:n].reshape(shape)

    def resample_uniforms(self, n_ensembles):
        """(E,) uniforms of one stage's systematic resampling."""
        return torch.rand((n_ensembles,), generator=self.generator, device=self.device)

    def move(self, shape):
        """(momentum normals of ``shape``, acceptance uniforms in
        [1e-10, 1) of ``shape[:-1]``) for one tempering move."""
        eps_n = torch.randn(shape, generator=self.generator, device=self.device)
        u = torch.rand(shape[:-1], generator=self.generator, device=self.device)
        return eps_n, 1e-10 + (1.0 - 1e-10) * u

    def post_move(self, shape):
        """The same draws for one move of the post chain."""
        return self.move(shape)


def _systematic_resample(u, logw):
    """Systematic resampling indices per ensemble: ``logw`` (P, E) and one
    uniform ``u`` (E,) an ensemble -> (P, E) indices along axis 0 (float32
    softmax, cumsum, left ``searchsorted``, clipped to P - 1)."""
    p = logw.shape[0]
    cdf = torch.cumsum(torch.softmax(logw, dim=0), dim=0)
    pts = (torch.arange(p, dtype=logw.dtype, device=logw.device)[:, None] + u[None, :]) / p
    idx = torch.searchsorted(cdf.T.contiguous(), pts.T.contiguous())
    return torch.clamp(idx, max=p - 1).T


class _Particles(NamedTuple):
    """Particles with their cached log-density parts and part-gradients.

    The tempered target ``lp + aux + (like - aux) * beta`` is affine in
    beta, so the three parts and their three gradients give any stage's
    density and gradient algebraically, with no re-evaluation."""

    z: torch.Tensor       # (P, E, d)
    like: torch.Tensor    # (P, E)
    aux: torch.Tensor     # (P, E)
    lp: torch.Tensor      # (P, E) prior
    g_like: torch.Tensor  # (P, E, d)
    g_aux: torch.Tensor   # (P, E, d)
    g_lp: torch.Tensor    # (P, E, d)


def _select(accept, new: _Particles, old: _Particles) -> _Particles:
    """Per particle: the proposal where accepted, else the old state."""
    return _Particles(*(torch.where(accept[..., None] if a.ndim == 3 else accept, a, b)
                        for a, b in zip(new, old)))


def _gather(idx, a):
    """a[idx[p, e], e] for a (P, E, ...) tensor and (P, E) indices."""
    return a[idx, torch.arange(a.shape[1], device=a.device)[None, :]]


def _pack(part: _Particles, log_scalings):
    """The particles, their parts, gradients and scalings as one (P, E, 4d
    + 4) tensor, the layout :func:`_unpack` reads."""
    cols = [a if a.ndim == 3 else a[..., None] for a in (*part, log_scalings)]
    return torch.cat(cols, dim=-1)


def _unpack(packed, d):
    z, like, aux, lp, g_like, g_aux, g_lp, log_scalings = torch.split(
        packed, [d, 1, 1, 1, d, d, d, 1], dim=-1)
    return (_Particles(z, like[..., 0], aux[..., 0], lp[..., 0], g_like, g_aux, g_lp),
            log_scalings[..., 0])


def _part_fns(prob_model, simulator, target, auxiliar):
    """(target_fn, aux_fn): constrained params for the whole batch -> (n,)
    log-likelihood, or None for "none". A callable selector is used as it
    is. The auxiliary term degrades to "none" when the model lacks it; a
    missing target term would silently sample the prior, so it raises."""

    def stats(name, required):
        if callable(name):
            return name
        missing = (
            "pixels" in name and not getattr(prob_model, "include_pixels", True)
        ) or (
            "positions" in name and not getattr(prob_model, "include_positions", True)
        )
        if missing:
            if required:
                raise ValueError(f"SMC target likelihood {name!r} is not configured "
                                 "on this probabilistic model")
            name = "none"
        if name == "pixels":
            return lambda x: prob_model.stats_pixels(simulator, x)[0]
        if name == "positions":
            return lambda x: prob_model.stats_positions(simulator, x)[0]
        if name == "pixels+positions":
            # both terms annealed from the prior: a pathological particle's
            # increment is then hugely negative (harmless) instead of
            # hugely positive (ensemble collapse); use with auxiliar="none"
            return lambda x: (prob_model.stats_pixels(simulator, x)[0]
                              + prob_model.stats_positions(simulator, x)[0])
        if name == "none":
            return None
        raise ValueError(f"unknown likelihood selector: {name}")

    return stats(target, True), stats(auxiliar, False)


def _eval_particles(prior, target_fn, aux_fn, z) -> _Particles:
    """The three parts (like, aux, prior) and their gradients at z (P, E, d):
    one ``autograd.grad`` a part over the shared ``constrain``, retaining
    the graph until the last; a "none" part is zeros with zero gradient.
    Nothing returned carries a graph."""
    P, E, d = z.shape
    f32 = dict(dtype=torch.float32, device=z.device)
    zf = z.reshape(P * E, d).detach().requires_grad_(True)
    with torch.enable_grad():
        x = prior.constrain(zf)
        parts = [fn(x) if fn is not None else None for fn in (target_fn, aux_fn)]
        parts.append(prior.log_prob(x) + prior.fldj(zf))
        live = [i for i, v in enumerate(parts) if v is not None and v.requires_grad]
        grads = [None] * 3
        for k, i in enumerate(live):
            (grads[i],) = torch.autograd.grad(parts[i].sum(), zf,
                                              retain_graph=k + 1 < len(live))
    vals = [torch.zeros((P, E), **f32) if v is None else v.detach().reshape(P, E)
            for v in parts]
    gs = [torch.zeros((P, E, d), **f32) if g is None else g.reshape(P, E, d) for g in grads]
    return _Particles(z, *vals, *gs)


def fit_smc(
    prob_model,
    simulator,
    start=None,
    num_particles: int = 1000,
    num_ensembles: int = 1,
    num_leapfrog_steps: int = 10,
    post_sampling_steps: int = 100,
    ess_threshold_ratio: float = 0.8,
    max_sampling_per_stage: int = 8,
    min_sampling_per_stage: int = 1,
    max_stage: int = 100,
    target="pixels",
    auxiliar="positions",
    optimal_accept: float = 0.651,
    precondition_moves: bool = True,
    seed: int = 1,
    mesh=None,
    segment_stages: int = 0,
    progress=None,
    device=None,
    draws: Draws = None,
) -> SMCResult:
    """Adaptive-tempering SMC from the prior (``start=None``), from a
    pre-shaped (P, E, d) start, or from a subsample of (n, d) starts (with
    replacement when n < P * E).

    ``device`` defaults to the simulator's (``None`` without a simulator:
    the CUDA card, raising without one). ``draws`` is the source of every
    random draw (default: :class:`Draws` over a generator seeded with
    ``seed`` on the device). ``progress(stage, min_beta)`` is called every
    ``segment_stages`` stages (0: once, when the tempering ends).

    ``mesh`` shards each ensemble's particles over its ranks: the start and
    the draws are global, ``simulator`` (and a callable target) score one
    rank's (P / size) * E rows, and every rank returns the global result."""
    device = resolve_device(device if device is not None else getattr(simulator, "device", None))
    P, E = num_particles, num_ensembles
    n = P * E
    size, rank = (mesh.size, mesh.rank) if mesh is not None else (1, 0)
    if P % size:
        raise ValueError(f"{P} particles do not shard over {size} ranks")
    rows = slice(rank * (P // size), (rank + 1) * (P // size))  # this rank's particles
    prior = prob_model.prior
    d = prior.d
    f32 = dict(dtype=torch.float32, device=device)
    if draws is None:
        draws = Draws(torch.Generator(device=device).manual_seed(seed))

    with torch.no_grad():
        if start is None:
            z0 = prior.unconstrain(draws.prior_sample(prior, (P, E)))
        else:
            start = torch.as_tensor(start, **f32)
            if start.ndim == 3:
                # pre-shaped starts: the caller controls which rows seed
                # which ensemble
                if tuple(start.shape) != (P, E, d):
                    raise ValueError(f"3-D start must be ({P}, {E}, {d}); "
                                     f"got {tuple(start.shape)}")
                z0 = start
            else:
                # fewer starts than particles: duplicates are fine, the HMC
                # moves re-diversify them
                replace = start.shape[0] < n
                z0 = start[draws.start_indices(start.shape[0], (P, E), replace)]
    z0 = pmesh.shard_samples(z0.to(**f32), mesh)

    eval_particles = functools.partial(
        _eval_particles, prior, *_part_fns(prob_model, simulator, target, auxiliar))

    def tempered_of(p: _Particles, beta):
        return p.lp + p.aux + (p.like - p.aux) * beta[None, :]

    def grad_of(p: _Particles, beta):
        b = beta[None, :, None]
        return p.g_lp + p.g_aux + (p.g_like - p.g_aux) * b

    target_log_ess = torch.log(torch.tensor(ess_threshold_ratio * P, **f32))

    def find_delta(incr, beta):
        """Per-ensemble bisection (30 halvings on the device, no host read)
        for the increment delta in (0, 1 - beta] with ESS(exp(delta * incr))
        ~= ess_threshold_ratio * P; incr = like - aux, (P, E)."""

        def log_ess(delta):
            logw = delta[None, :] * incr
            return 2 * torch.logsumexp(logw, dim=0) - torch.logsumexp(2 * logw, dim=0)

        lo = torch.zeros((E,), **f32)
        hi = 1.0 - beta
        for _ in range(30):
            mid = 0.5 * (lo + hi)
            # a negated >= so that a NaN log-ESS (a non-finite increment)
            # also counts as too large a step
            too_small_ess = ~(log_ess(mid) >= target_log_ess)
            hi = torch.where(too_small_ess, mid, hi)
            lo = torch.where(too_small_ess, lo, mid)
        # if even the full remaining step keeps the ESS above target, take it
        full_ok = log_ess(1.0 - beta) >= target_log_ess
        return torch.where(full_ok, 1.0 - beta, 0.5 * (lo + hi))

    def move_tril(z):
        """Per-ensemble preconditioner: the Cholesky factor of the ridged
        particle covariance (full float32). A factorization that fails
        gives NaN, as JAX's Cholesky does, and the stage's moves are then
        all rejected."""
        zc = z - torch.mean(z, dim=0, keepdim=True)
        cov = torch.einsum("ped,pef->edf", zc, zc) / P
        tr = torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1)[:, None, None]
        cov = cov + (1e-3 * tr / d + 1e-10) * torch.eye(d, **f32)
        tril, info = torch.linalg.cholesky_ex(cov)
        return torch.where((info == 0)[:, None, None], tril, math.nan)

    def hmc_move(part: _Particles, beta, log_scalings, tril, eps_n, u):
        """One HMC step a particle at the tempered target, from momentum
        normals ``eps_n`` (P, E, d) and acceptance uniforms ``u`` (P, E),
        this rank's rows of each.
        ``tril`` (E, d, d): momentum ~ N(0, Sigma^-1), drift eps * Sigma p;
        None: identity mass. The leading gradient comes from the cached
        parts, and the proposal's parts are accept-selected into them."""
        eps = torch.exp(log_scalings)[..., None]  # (P, E, 1)
        if tril is None:
            drift = kinetic_t = lambda p: p
            p0 = eps_n
        else:
            m = tril @ tril.transpose(-1, -2)  # Sigma (E, d, d)
            inv_l = torch.linalg.solve_triangular(
                tril, torch.eye(d, **f32).expand(tril.shape), upper=False)
            # per-particle products at every rank's particle count, so each
            # rounds as on one rank (parallel.mesh.at_global_rows)
            drift = lambda p: pmesh.at_global_rows(  # noqa: E731
                lambda a: torch.einsum("ped,edf->pef", a, m), p, mesh)
            kinetic_t = lambda p: pmesh.at_global_rows(  # noqa: E731
                lambda a: torch.einsum("ped,edi->pei", a, tril), p, mesh)
            p0 = pmesh.at_global_rows(
                lambda a: torch.einsum("ped,edi->pei", a, inv_l), eps_n, mesh)

        lp_val = tempered_of(part, beta)
        p = p0 + 0.5 * eps * grad_of(part, beta)
        prt = part
        for _ in range(num_leapfrog_steps):
            prt = eval_particles(prt.z + eps * drift(p))
            p = p + eps * grad_of(prt, beta)
        p_new = p - 0.5 * eps * grad_of(prt, beta)
        lp_new = tempered_of(prt, beta)

        kin0 = 0.5 * torch.sum(kinetic_t(p0) ** 2, dim=-1)
        kin1 = 0.5 * torch.sum(kinetic_t(p_new) ** 2, dim=-1)
        log_accept = (lp_new - kin1) - (lp_val - kin0)
        log_accept = torch.where(torch.isnan(log_accept), -math.inf, log_accept)
        accept = torch.log(u) < log_accept
        return _select(accept, prt, part), torch.clamp(torch.exp(log_accept), max=1.0)

    init_log_scaling = math.log(min(1.0, 2.38**2 / d))
    log1p_target = torch.log1p(torch.tensor(-0.95, **f32))
    shape = (P, E, d)
    seg = segment_stages if segment_stages > 0 else max_stage

    t0 = time.perf_counter()
    with torch.no_grad():
        part = eval_particles(z0)
        beta = torch.zeros((E,), **f32)
        log_scalings = torch.full((P // size, E), init_log_scaling, **f32)
        log_z = torch.zeros((E,), **f32)
        log_p = torch.log(torch.tensor(float(P), **f32))
        num_steps, stage, min_beta, num_moves = max_sampling_per_stage, 0, 0.0, 0
        while min_beta < 1.0 and stage < max_stage:
            u_res = draws.resample_uniforms(E)
            # every rank's particles with their cached parts, gradients
            # and scalings: the stage's schedule and resampling run on the
            # global cloud, identically on every rank
            cloud, scalings = _unpack(pmesh.gather_samples(_pack(part, log_scalings), mesh), d)
            incr = cloud.like - cloud.aux  # cached: no re-evaluation
            delta = find_delta(incr, beta)
            beta_new = torch.clamp(beta + delta, max=1.0)
            logw = (beta_new - beta)[None, :] * incr  # (P, E)
            # the particles enter each stage equally weighted, so log mean(w)
            # estimates log Z(beta_new) / Z(beta); the sum telescopes to the
            # log marginal likelihood (Del Moral et al. 2006)
            log_z = log_z + torch.logsumexp(logw, dim=0) - log_p

            # systematic resampling per ensemble; the cached parts and
            # gradients ride the same gather as the positions
            idx = _systematic_resample(u_res, logw)
            part = _Particles(*(_gather(idx[rows], a) for a in cloud))
            log_scalings = _gather(idx[rows], scalings)

            # the mass is fixed for the stage, from the resampled cloud
            tril = move_tril(_gather(idx, cloud.z)) if precondition_moves else None
            acc_sum = torch.zeros((P // size, E), **f32)
            for _ in range(num_steps):
                eps_n, u = draws.move(shape)
                part, acc = hmc_move(part, beta_new, log_scalings, tril, eps_n[rows], u[rows])
                acc_sum = acc_sum + acc
            num_moves += num_steps

            # heuristic tuning (TFP's simple_heuristic_tuning) on every
            # rank's acceptances, as one rank tunes
            avg_accept = pmesh.gather_samples(acc_sum, mesh) / float(num_steps)
            mean_accept = torch.mean(avg_accept, dim=0, keepdim=True)  # (1, E)
            log_scalings = torch.clamp(log_scalings + (mean_accept - optimal_accept),
                                       -10.0, 2.0)
            p_move = torch.clamp(torch.mean(avg_accept), 1e-3, 1 - 1e-4)
            next_steps = torch.ceil(log1p_target / torch.log1p(-p_move))
            beta, stage = beta_new, stage + 1
            # the stage's one host read
            min_beta, next_steps = torch.stack([beta.min(), next_steps]).tolist()
            num_steps = min(max(int(next_steps), min_sampling_per_stage),
                            max_sampling_per_stage)
            done = not (min_beta < 1.0 and stage < max_stage)
            if progress is not None and (stage % seg == 0 or done):
                progress(stage, min_beta)
        tempering_s = time.perf_counter() - t0

        if post_sampling_steps > 0:
            # a separate sample stream at beta = 1 with the tuned scalings and
            # a fixed mass from the final cloud; the particles stay the
            # tempering output
            tril = move_tril(pmesh.gather_samples(part.z, mesh)) if precondition_moves else None
            ones = torch.ones((E,), **f32)
            prt, post = part, []
            for _ in range(post_sampling_steps):
                eps_n, u = draws.post_move(shape)
                prt, _ = hmc_move(prt, ones, log_scalings, tril, eps_n[rows], u[rows])
                post.append(prt.z)
            post = pmesh.gather_samples(torch.stack(post), mesh, dim=1).reshape(-1, n, d)
        else:
            post = torch.zeros((0, n, d), **f32)
    return SMCResult(pmesh.gather_samples(part.z, mesh), stage,
                     pmesh.gather_samples(log_scalings, mesh), post, beta, log_z, num_moves,
                     tempering_s)
