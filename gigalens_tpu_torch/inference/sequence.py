"""ModellingSequence: the MAP -> Laplace -> SVI -> HMC (/ SMC) pipeline
facade (port of :mod:`gigalens_tpu.inference.sequence`).

Each phase builds its own ``LensSimulator`` with the right batch size, like
the reference: MAP and SVI on the fast path (fused render and, on the card,
the dft-mode conv, K4), HMC and SMC on the exact path (the FFT conv), the
Laplace Hessian on the unfused render with the FFT conv. Every phase runs
on the sequence's device, which is the CUDA card unless the caller names
another (``device="cpu"``). ``fit(checkpoint_dir=...)`` saves each phase's
result and skips the phases already saved on a rerun
(:class:`~gigalens_tpu_torch.utils.checkpoint.PipelineCheckpointer`).

``mesh`` (:mod:`gigalens_tpu_torch.parallel`; default: the world group
when ``torch.distributed`` is initialized, else one rank) shards every
phase's samples over its ranks, one process a device: the batch counts
are rounded to multiples of the mesh size as the JAX package rounds them,
each phase simulator is built at one rank's share, and every phase
returns the global result on every rank, so the caller's code is the same
for one rank and many. MAP, HMC and SMC on N ranks equal one process's
bit for bit at any rows a rank (the per-row reductions that round by the
rows a call holds run at the global row count); SVI's all-reduced gradient
agrees to float32 rounding (:mod:`gigalens_tpu_torch.parallel.mesh` says
which models were measured).
"""
from __future__ import annotations

import dataclasses
import time

import torch

from gigalens_tpu_torch.inference import optim
from gigalens_tpu_torch.inference.hmc import fit_hmc
from gigalens_tpu_torch.inference.map import best_start, fit_map, laplace_scale_tril
from gigalens_tpu_torch.inference.smc import fit_smc
from gigalens_tpu_torch.inference.optim import GradientTransformation
from gigalens_tpu_torch.inference.svi import fit_svi
from gigalens_tpu_torch.model import resolve_device
from gigalens_tpu_torch.parallel import mesh as pmesh
from gigalens_tpu_torch.simulator import LensSimulator
from gigalens_tpu_torch.utils.checkpoint import PipelineCheckpointer
from gigalens_tpu_torch.utils.summary import summarize_posterior


def phase_simulator(cache: dict, sim_config, phys_model, bs: int,
                    exact: bool = False, device=None, mesh=None) -> LensSimulator:
    """Memoized phase simulator. ``exact=True`` (the HMC/SMC path) pins the
    auto PSF mode to the FFT: the JAX package measured its DFT-by-matmul
    path (single bf16 pass on the TPU) at ~0.3 nats of likelihood noise,
    fatal to Metropolis acceptance, and keeps the exact path on the FFT.
    Explicit ``sim_config`` choices are always respected.

    A memo hit requires the SAME config/model objects (identity, plus the
    model's attribute version), so rebinding either after a phase call never
    reuses a simulator built from the old configuration. ``device=None`` is
    the CUDA card (:func:`~gigalens_tpu_torch.model.resolve_device`).
    ``mesh``: ``bs`` is one rank's share of the mesh's global batch (see
    :class:`LensSimulator`)."""
    device = resolve_device(device)
    mesh = mesh if mesh is not None and mesh.size > 1 else None
    key = (bs, exact, str(device), getattr(phys_model, "_version", 0), id(mesh))
    hit = cache.get(key)
    if hit is not None and hit[0] is sim_config and hit[1] is phys_model and hit[2].mesh is mesh:
        return hit[2]
    cfg = sim_config
    if exact and cfg.psf_mode is None and cfg.use_fft is None:
        cfg = dataclasses.replace(cfg, psf_mode="fft")
    sim = LensSimulator(phys_model, cfg, bs=bs, device=device, mesh=mesh)
    cache[key] = (sim_config, phys_model, sim)
    return sim


def map_optimizer(num_steps: int, lr: float = 1e-2) -> GradientTransformation:
    """The MAP recipe: Adam under a power-0.5 decay from ``lr`` to ``lr / 3``
    over exactly ``num_steps`` (JAX's jitted power-0.5 schedule is NaN past
    its transition, so it is never run past it)."""
    return optim.chain(optim.scale_by_adam(), optim.scale_by_schedule(
        optim.polynomial_schedule(-lr, -lr / 3, 0.5, num_steps)))


def svi_optimizer(num_steps: int, lr: float = 3e-3) -> GradientTransformation:
    """The SVI recipe: Adam warmed up quadratically from 1e-6 to ``lr`` over
    the first fifth of ``num_steps``."""
    return optim.chain(optim.scale_by_adam(), optim.scale_by_schedule(
        optim.polynomial_schedule(-1e-6, -lr, 2, max(num_steps // 5, 1))))


def mesh_and_device(mesh, device):
    """A sequence's (mesh, device): ``mesh`` defaults to
    :func:`~gigalens_tpu_torch.parallel.default_mesh` on ``device``, and
    ``device`` to the mesh's."""
    if mesh is None:
        mesh = pmesh.default_mesh(device)
    if device is None:
        return mesh, mesh.device
    device = resolve_device(device)
    # "cuda" names the current card, so an unindexed device matches any index
    indices = (device.index, mesh.device.index)
    if device.type != mesh.device.type or None not in indices and indices[0] != indices[1]:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    return mesh, device


class ModellingSequence:
    def __init__(self, phys_model, prob_model, sim_config, mesh=None, device=None):
        self.phys_model = phys_model
        self.prob_model = prob_model
        self.sim_config = sim_config
        self.mesh, self.device = mesh_and_device(mesh, device)
        self._sims = {}

    def _sim(self, bs: int, exact: bool = False) -> LensSimulator:
        """The phase simulator for a global batch of ``bs`` (built at one
        rank's share); see :func:`phase_simulator` for the exact/fast
        PSF-path policy."""
        return phase_simulator(self._sims, self.sim_config, self.phys_model,
                               bs // self.mesh.size, exact, self.device, self.mesh)

    def _round(self, n: int, what: str) -> int:
        return pmesh.round_to_multiple(n, self.mesh.size, what)

    def MAP(
        self,
        optimizer: GradientTransformation,
        start=None,
        n_samples: int = 500,
        num_steps: int = 350,
        seed: int = 0,
        segment_steps: int = 0,
        progress=None,
    ):
        """Multi-start MAP; returns the (n_samples, d) final z."""
        n_samples = self._round(n_samples, "n_samples")
        z, _ = fit_map(
            self.prob_model, self._sim(n_samples), optimizer, start=start,
            n_samples=n_samples, num_steps=num_steps, seed=seed,
            segment_steps=segment_steps, progress=progress, mesh=self.mesh,
        )
        return z

    def best_map_start(self, z):
        """Highest-posterior MAP sample, shaped (1, d)."""
        return best_start(self.prob_model, self._sim(z.shape[0]), z, mesh=self.mesh)

    def summarize(self, res):
        """Named physical-space posterior summary of an :class:`HMCResult`
        (see :func:`gigalens_tpu_torch.utils.summarize_posterior`)."""
        return summarize_posterior(self.prob_model.prior, res.samples,
                                   divergences=getattr(res, "divergences", None))

    def laplace_scale_tril(self, z_best, method: str = "fd"):
        """chol of the Laplace covariance at the MAP, as a numpy (d, d)
        array: the recommended ``init_scales`` for SVI. ``method="fd"``
        (central differences of one batched gradient, bs = 2d) or
        ``"exact"`` (double backward, bs = 1). Both run on the unfused
        render with the FFT conv, on the sequence's device (under a mesh, on
        every rank, and rank 0's factor is the result)."""
        cfg = dataclasses.replace(self.sim_config, use_fused_render=False, psf_mode="fft")
        bs = 2 * torch.as_tensor(z_best).numel() if method == "fd" else 1
        sim = LensSimulator(self.phys_model, cfg, bs=bs, device=self.device)
        L = laplace_scale_tril(self.prob_model, sim, z_best, method=method)
        return pmesh.replicate(L, self.mesh).cpu().numpy()

    def SVI(
        self,
        start,
        optimizer: GradientTransformation,
        n_vi: int = 250,
        init_scales=1e-3,
        num_steps: int = 500,
        seed: int = 0,
        segment_steps: int = 0,
        full_rank: bool = True,
        progress=None,
    ):
        """Full-rank (or mean-field) SVI on the fast simulator; returns
        ``(q_z, losses)``."""
        n_vi = self._round(n_vi, "n_vi")
        return fit_svi(
            self.prob_model, self._sim(n_vi), start, optimizer, n_vi=n_vi,
            init_scales=init_scales, num_steps=num_steps, seed=seed,
            segment_steps=segment_steps, full_rank=full_rank, progress=progress,
            mesh=self.mesh,
        )

    def HMC(
        self,
        q_z,
        init_eps: float = 0.3,
        init_l: int = 3,
        n_hmc: int = 50,
        num_burnin_steps: int = 250,
        num_results: int = 750,
        max_leapfrog_steps: int = 30,
        trajectory_adaptation: str = "chees",
        mass_adaptation=True,
        seed: int = 0,
        seeds=None,
        segment_steps: int = 0,
        progress=None,
    ):
        """Preconditioned HMC on the exact simulator; ``seeds`` (a sequence)
        runs one independently adapted group of ``n_hmc`` chains per seed."""
        n_hmc = self._round(n_hmc, "n_hmc chains")
        n_total = n_hmc * (len(seeds) if seeds is not None and len(seeds) > 1 else 1)
        return fit_hmc(
            self.prob_model, self._sim(n_total, exact=True), q_z,
            init_eps=init_eps, init_l=init_l, n_hmc=n_hmc,
            num_burnin_steps=num_burnin_steps, num_results=num_results,
            max_leapfrog_steps=max_leapfrog_steps,
            trajectory_adaptation=trajectory_adaptation,
            mass_adaptation=mass_adaptation, seed=seed, seeds=seeds,
            segment_steps=segment_steps, progress=progress, mesh=self.mesh,
        )

    def SMC(
        self,
        start=None,
        num_particles: int = 1000,
        num_ensembles: int = 1,
        num_leapfrog_steps: int = 10,
        post_sampling_steps: int = 100,
        ess_threshold_ratio: float = 0.8,
        max_sampling_per_stage: int = 8,
        max_stage: int = 100,
        target: str = "pixels",
        auxiliar: str = "positions",
        precondition_moves: bool = True,
        seed: int = 1,
        segment_stages: int = 0,
        progress=None,
    ):
        """Adaptive-tempering SMC on the exact simulator at bs = P * E;
        returns an :class:`~gigalens_tpu_torch.inference.smc.SMCResult`."""
        num_particles = self._round(num_particles, "num_particles")
        sim = self._sim(num_particles * num_ensembles, exact=True)
        return fit_smc(
            self.prob_model, sim, start=start, num_particles=num_particles,
            num_ensembles=num_ensembles, num_leapfrog_steps=num_leapfrog_steps,
            post_sampling_steps=post_sampling_steps,
            ess_threshold_ratio=ess_threshold_ratio,
            max_sampling_per_stage=max_sampling_per_stage, max_stage=max_stage,
            target=target, auxiliar=auxiliar, precondition_moves=precondition_moves,
            seed=seed, segment_stages=segment_stages, progress=progress, mesh=self.mesh,
        )

    def fit(
        self,
        n_samples: int = 500,
        map_steps: int = 350,
        n_vi: int = 1000,
        vi_steps: int = 300,
        n_hmc: int = 50,
        num_burnin_steps: int = 250,
        num_results: int = 750,
        map_lr: float = 1e-2,
        svi_lr: float = 3e-3,
        laplace_method: str = "fd",
        seed: int = 0,
        checkpoint_dir=None,
        progress=None,
    ):
        """One-call pipeline: MAP -> Laplace init -> SVI -> HMC.

        Multi-start Adam MAP under a polynomial-decay schedule, SVI started
        from the Laplace covariance at the best MAP point, and ChEES-adapted
        preconditioned HMC started from the surrogate (seed + 2).
        ``checkpoint_dir`` makes the run resumable per phase
        (:class:`~gigalens_tpu_torch.utils.checkpoint.PipelineCheckpointer`):
        a rerun with the same directory loads the finished phases instead
        of running them. ``progress(phase, step, value)`` receives
        per-segment feedback. Returns a dict ``z_map, best, q_z, losses,
        hmc, summary, times``.
        """
        ckpt = None
        if checkpoint_dir is not None:
            ckpt = PipelineCheckpointer(checkpoint_dir, device=self.device, mesh=self.mesh)

        def _progress(phase):
            if progress is None:
                return None
            return lambda step, value: progress(phase, step, value)

        def _sync():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        def _map():
            z = self.MAP(map_optimizer(map_steps, map_lr), n_samples=n_samples,
                         num_steps=map_steps, seed=seed, progress=_progress("map"))
            return z, None

        def _svi():
            L0 = self.laplace_scale_tril(best, method=laplace_method)
            return self.SVI(best, svi_optimizer(vi_steps, svi_lr), n_vi=n_vi, num_steps=vi_steps,
                            init_scales=L0, seed=seed + 1, progress=_progress("svi"))

        def _hmc():
            return self.HMC(q_z, n_hmc=n_hmc, num_burnin_steps=num_burnin_steps,
                            num_results=num_results, seed=seed + 2, progress=_progress("hmc"))

        times = {}
        t0 = time.time()
        z_map, _ = ckpt.run_map(_map) if ckpt else _map()
        best = self.best_map_start(z_map)
        _sync()
        times["map"] = time.time() - t0

        t0 = time.time()
        q_z, losses = ckpt.run_svi(_svi) if ckpt else _svi()
        _sync()
        times["svi"] = time.time() - t0

        t0 = time.time()
        res = ckpt.run_hmc(_hmc) if ckpt else _hmc()
        _sync()
        times["hmc"] = time.time() - t0
        return dict(z_map=z_map, best=best, q_z=q_z, losses=losses, hmc=res,
                    summary=self.summarize(res), times=times)
