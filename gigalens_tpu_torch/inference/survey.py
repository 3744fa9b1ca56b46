"""Survey mode: fit S lens systems of one camera and one model family in
single batches (port of :mod:`gigalens_tpu.inference.survey`).

* one scene-batched likelihood
  (:class:`~gigalens_tpu_torch.model.SurveyForwardProbModel` or
  :class:`~gigalens_tpu_torch.model.SurveyBackwardProbModel`) scores S * K
  scene-major rows in one render batch;
* MAP is the ordinary multi-start fit over all scenes' starts;
* SVI fits S surrogates together (:func:`fit_svi_survey`);
* HMC runs every scene's chains in one batch with per-scene adaptation
  (``sample_hmc(n_groups=S)``: per-scene preconditioner, step size, ChEES
  trajectory length and mass re-estimate);
* SMC runs one ensemble a scene.

Phase simulators come from :func:`phase_simulator`: MAP and SVI take the
fast path (on the card the dft conv, one K4 launch a scene), HMC and SMC
the exact path (the FFT conv). Every phase runs on the sequence's device,
the CUDA card unless the caller names another. Under a ``mesh``
(:mod:`gigalens_tpu_torch.parallel`, default as for
:class:`~gigalens_tpu_torch.inference.ModellingSequence`) the scene-major
batch shards like HMC's chain groups: every rank holds every scene and
its share of each scene's starts, draws, chains or particles (the
per-scene counts are rounded to multiples of the mesh size), so a rank's
batch is itself scene-major; every phase returns the global result.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from gigalens_tpu_torch.interop import _map_tree
from gigalens_tpu_torch.inference.hmc import HMCResult, sample_hmc
from gigalens_tpu_torch.inference.map import fit_map, laplace_scale_trils_survey
from gigalens_tpu_torch.inference.optim import GradientTransformation
from gigalens_tpu_torch.inference.sequence import (
    map_optimizer, mesh_and_device, phase_simulator, svi_optimizer,
)
from gigalens_tpu_torch.inference.smc import Draws, SMCResult, fit_smc
from gigalens_tpu_torch.inference.svi import fit_svi_survey
from gigalens_tpu_torch.model import SurveyBackwardProbModel, SurveyForwardProbModel
from gigalens_tpu_torch.parallel import mesh as pmesh
from gigalens_tpu_torch.simulator import LensSimulator
from gigalens_tpu_torch.utils.summary import summarize_posterior


class _SceneEnsembleAdapter:
    """A scene-major survey model in SMC's (P, E) particle order.

    ``fit_smc`` flattens its particles (P, E, d) to rows ``p * E + e``; the
    survey model scores rows ``s * P + p``. With one ensemble a scene (E =
    S), the two orders are a transpose: rows go to scene-major before the
    model and the per-row stats come back."""

    def __init__(self, survey_model, num_particles: int):
        self._m = survey_model
        self._P = num_particles
        self.prior = survey_model.prior
        self.include_pixels = survey_model.include_pixels
        self.include_positions = survey_model.include_positions

    def _to_scene_major(self, x):
        P, S = self._P, self._m.n_scenes

        def perm(a):
            return a.reshape(P, S, *a.shape[1:]).transpose(0, 1).reshape(P * S, *a.shape[1:])

        return _map_tree(x, perm)

    def _from_scene_major(self, y):
        P, S = self._P, self._m.n_scenes
        return y.reshape(S, P).transpose(0, 1).reshape(P * S)

    def stats_pixels(self, simulator, x):
        ll, chi = self._m.stats_pixels(simulator, self._to_scene_major(x))
        return self._from_scene_major(ll), self._from_scene_major(chi)

    def stats_positions(self, simulator, x):
        ll, chi = self._m.stats_positions(simulator, self._to_scene_major(x))
        return self._from_scene_major(ll), self._from_scene_major(chi)


class SurveySequence:
    """MAP -> Laplace -> SVI -> HMC (/ SMC) over a catalogue of observations.

    ``prob_model`` is a :class:`SurveyForwardProbModel` or
    :class:`SurveyBackwardProbModel`; its ``n_scenes`` fixes S. Batch sizes
    of the methods are per scene, and every batch is scene-major."""

    def __init__(self, phys_model, prob_model, sim_config, mesh=None, device=None):
        if not isinstance(prob_model, (SurveyForwardProbModel, SurveyBackwardProbModel)):
            raise TypeError("SurveySequence requires a SurveyForwardProbModel or "
                            "SurveyBackwardProbModel")
        self.phys_model = phys_model
        self.prob_model = prob_model
        self.sim_config = sim_config
        self.mesh, self.device = mesh_and_device(mesh, device)
        self.n_scenes = prob_model.n_scenes
        self._sims = {}

    def _sim(self, bs: int, exact: bool = False) -> LensSimulator:
        """The phase simulator for a global batch of ``bs`` (built at one
        rank's share); see :func:`phase_simulator` for the exact/fast
        PSF-path policy."""
        return phase_simulator(self._sims, self.sim_config, self.phys_model,
                               bs // self.mesh.size, exact, self.device)

    def _per_scene(self, k: int, what: str) -> int:
        """Rounds a per-scene count so every scene's rows divide the mesh."""
        return pmesh.round_to_multiple(k, self.mesh.size, what)

    def MAP(self, optimizer: GradientTransformation, n_starts: int = 32, num_steps: int = 350,
            seed: int = 0, segment_steps: int = 0, progress=None):
        """Multi-start MAP with ``n_starts`` prior draws a scene; returns the
        (S * n_starts, d) scene-major unconstrained parameters."""
        n = self.n_scenes * self._per_scene(n_starts, "n_starts")
        z, _ = fit_map(self.prob_model, self._sim(n), optimizer, n_samples=n,
                       num_steps=num_steps, seed=seed, segment_steps=segment_steps,
                       progress=progress, mesh=self.mesh, n_groups=self.n_scenes)
        return z

    @torch.no_grad()
    def best_per_scene(self, z):
        """The highest-posterior start of each scene, (S, d)."""
        S = self.n_scenes
        lp, _ = self.prob_model.log_prob(self._sim(z.shape[0]),
                                         pmesh.shard_samples(z, self.mesh, S))
        lp = pmesh.gather_samples(lp, self.mesh, S)
        # diverged starts carry NaN log-posteriors; argmax would pick a NaN
        lp = torch.where(torch.isnan(lp), -torch.inf, lp).reshape(S, -1)
        return z.reshape(S, lp.shape[1], -1)[torch.arange(S, device=z.device),
                                             torch.argmax(lp, dim=1)]

    def laplace_scale_trils(self, z_best):
        """Per-scene Laplace factors at the per-scene MAP points, as a numpy
        (S, d, d) array: the recommended ``init_scales`` for :meth:`SVI`.
        One FD gradient batch of S * 2d rows on the unfused render with the
        FFT conv, on the sequence's device (under a mesh, on every rank, and
        rank 0's factors are the result)."""
        cfg = dataclasses.replace(self.sim_config, use_fused_render=False, psf_mode="fft")
        d = torch.as_tensor(z_best).shape[-1]
        sim = LensSimulator(self.phys_model, cfg, bs=self.n_scenes * 2 * d, device=self.device)
        trils = laplace_scale_trils_survey(self.prob_model, sim, z_best)
        return pmesh.replicate(trils, self.mesh).cpu().numpy()

    def SVI(self, starts, optimizer: GradientTransformation, n_vi: int = 64, init_scales=1e-3,
            num_steps: int = 300, seed: int = 0, segment_steps: int = 0, full_rank: bool = True,
            progress=None):
        """Per-scene surrogates from ``starts`` (S, d) (e.g.
        :meth:`best_per_scene`); returns ``(means (S, d), trils (S, d, d),
        losses (num_steps, S))``."""
        n_vi = self._per_scene(n_vi, "n_vi")
        return fit_svi_survey(
            self.prob_model, self._sim(self.n_scenes * n_vi), starts, optimizer, n_vi=n_vi,
            init_scales=init_scales, num_steps=num_steps, seed=seed, mesh=self.mesh,
            segment_steps=segment_steps, full_rank=full_rank, progress=progress)

    def HMC(self, q_means, q_trils, init_eps: float = 0.3, init_l: int = 3, n_hmc: int = 16,
            num_burnin_steps: int = 250, num_results: int = 750, max_leapfrog_steps: int = 30,
            trajectory_adaptation: str = "chees", mass_adaptation=True,
            init_spread: float = 0.2, seed: int = 0, segment_steps: int = 0,
            progress=None) -> HMCResult:
        """All scenes' chains in one batch, ``n_hmc`` a scene, adapted per
        scene (``sample_hmc(n_groups=S)``) from ``q_means`` (S, d) and
        ``q_trils`` (S, d, d) (:meth:`SVI`). Each scene's chains start in a
        cloud contracted by ``init_spread`` around its surrogate's mean.
        ``samples`` are (num_results, S * n_hmc, d) scene-major (see
        :meth:`scene_samples`); ``step_size`` and ``trajectory_length`` are
        (S,)."""
        S = self.n_scenes
        n_hmc = self._per_scene(n_hmc, "n_hmc chains")
        sim = self._sim(S * n_hmc, exact=True)
        f32 = dict(dtype=torch.float32, device=self.device)
        q_means = torch.as_tensor(q_means, **f32)
        q_trils = torch.as_tensor(q_trils, **f32)
        d = q_means.shape[-1]
        gen = torch.Generator(device=self.device).manual_seed(seed)
        eps = torch.randn((S, n_hmc, d), generator=gen, **f32)
        z0 = (q_means[:, None] + init_spread * (eps @ q_trils.transpose(-1, -2)))

        def log_prob_fn(z):
            return self.prob_model.log_prob(sim, z)[0]

        return sample_hmc(
            log_prob_fn, z0.reshape(S * n_hmc, d), gen, step_size=init_eps,
            num_leapfrog_steps=init_l, num_burnin_steps=num_burnin_steps,
            num_results=num_results, momentum_covariance_tril=q_trils,
            trajectory_adaptation=trajectory_adaptation, max_leapfrog_steps=max_leapfrog_steps,
            mass_adaptation=mass_adaptation, segment_steps=segment_steps, progress=progress,
            n_groups=S, mesh=self.mesh)

    def SMC(self, start=None, num_particles: int = 500, num_leapfrog_steps: int = 10,
            post_sampling_steps: int = 100, ess_threshold_ratio: float = 0.8,
            max_sampling_per_stage: int = 8, max_stage: int = 100, target=None, seed: int = 1,
            segment_stages: int = 0, progress=None) -> SMCResult:
        """Tempered SMC over the catalogue, one ensemble of
        ``num_particles`` a scene, each with its own temperature schedule
        and ``log_evidence`` entry (meaningful from the prior start).

        ``start``: None (prior draws) or the survey MAP output (S * K, d),
        each scene's ensemble drawn from its own scene's rows (with
        replacement when K < P). ``particles`` are (P, S, d);
        ``final_beta`` and ``log_evidence`` (S,); ``post_samples`` rows are
        scene-major (``s * P + p``). The stages run until the slowest scene
        reaches beta = 1. The default ``target`` follows the data:
        "pixels+positions" with positions, else "pixels"; the auxiliary
        term is off."""
        S, P = self.n_scenes, self._per_scene(num_particles, "num_particles")
        sim = self._sim(P * S, exact=True)
        draws = Draws(torch.Generator(device=self.device).manual_seed(seed))
        if start is not None:
            start = torch.as_tensor(start, dtype=torch.float32, device=self.device)
            scenes = start.reshape(S, -1, start.shape[-1])
            K = scenes.shape[1]
            # each scene's own pool, so no scene seeds another's ensemble
            picks = [scenes[s][draws.start_indices(K, (P,), replace=K < P)] for s in range(S)]
            start = torch.stack(picks, dim=1)  # (P, S, d)
        if target is None:
            target = "pixels+positions" if self.prob_model.include_positions else "pixels"
        res = fit_smc(
            # the adapter sees one rank's P / size particles of each scene
            _SceneEnsembleAdapter(self.prob_model, P // self.mesh.size), sim, start=start,
            num_particles=P, mesh=self.mesh,
            num_ensembles=S, num_leapfrog_steps=num_leapfrog_steps,
            post_sampling_steps=post_sampling_steps, ess_threshold_ratio=ess_threshold_ratio,
            max_sampling_per_stage=max_sampling_per_stage, max_stage=max_stage, target=target,
            auxiliar="none", seed=seed, segment_stages=segment_stages, progress=progress,
            draws=draws)
        if res.post_samples.shape[0]:
            # fit_smc's post chain is particle-major (rows p * S + s)
            T, n, d = res.post_samples.shape
            post = res.post_samples.reshape(T, P, S, d).transpose(1, 2).reshape(T, n, d)
            res = res._replace(post_samples=post)
        return res

    def scene_samples(self, res: HMCResult):
        """(num_results, S * C, d) -> (S, num_results * C, d) per-scene draws."""
        T, n, d = res.samples.shape
        S = self.n_scenes
        return res.samples.reshape(T, S, n // S, d).transpose(0, 1).reshape(S, T * (n // S), d)

    def summarize(self, res: HMCResult):
        """A length-S list of per-scene
        :func:`~gigalens_tpu_torch.utils.summarize_posterior` dicts: each
        scene's chains summarized on their own (R-hat, ESS and divergences
        per scene)."""
        T, n, d = res.samples.shape
        S = self.n_scenes
        chains = res.samples.reshape(T, S, n // S, d)
        div = torch.as_tensor(res.divergences).reshape(S, n // S)
        return [summarize_posterior(self.prob_model.prior, chains[:, s], divergences=div[s])
                for s in range(S)]

    def fit(self, n_starts: int = 32, map_steps: int = 350, n_vi: int = 64, vi_steps: int = 300,
            n_hmc: int = 16, num_burnin_steps: int = 250, num_results: int = 750,
            map_lr: float = 1e-2, svi_lr: float = 3e-3, seed: int = 0, progress=None):
        """One-call survey pipeline, MAP -> per-scene Laplace -> SVI -> HMC,
        with :meth:`ModellingSequence.fit`'s recipe run scene-batched.
        ``progress(phase, step, value)`` receives per-segment feedback.
        Returns a dict ``z_map, best, q_means, q_trils, losses, hmc,
        summaries`` (one a scene) and ``times``."""

        def _progress(phase):
            if progress is None:
                return None
            return lambda step, value: progress(phase, step, value)

        def _sync():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        times = {}
        t0 = time.time()
        z_map = self.MAP(map_optimizer(map_steps, map_lr), n_starts=n_starts,
                         num_steps=map_steps, seed=seed, progress=_progress("map"))
        best = self.best_per_scene(z_map)
        _sync()
        times["map"] = time.time() - t0

        t0 = time.time()
        L0 = self.laplace_scale_trils(best)
        q_means, q_trils, losses = self.SVI(
            best, svi_optimizer(vi_steps, svi_lr), n_vi=n_vi, num_steps=vi_steps, init_scales=L0,
            seed=seed + 1, progress=_progress("svi"))
        _sync()
        times["svi"] = time.time() - t0

        t0 = time.time()
        res = self.HMC(q_means, q_trils, n_hmc=n_hmc, num_burnin_steps=num_burnin_steps,
                       num_results=num_results, seed=seed + 2, progress=_progress("hmc"))
        _sync()
        times["hmc"] = time.time() - t0
        return dict(z_map=z_map, best=best, q_means=q_means, q_trils=q_trils, losses=losses,
                    hmc=res, summaries=self.summarize(res), times=times)
