"""End-to-end pipeline benchmark of the port: MAP -> Laplace -> SVI -> HMC wall.

    python3 -m gigalens_tpu_torch.bench

The scene, prior and phase configurations of the JAX package's ``bench.py``:
EPL+Shear lens, SersicEllipse lens light and source, 80x80 px at 0.065"/px,
supersample 2, the 25x25 Gaussian PSF, background_rms 0.2, exp_time 100.
The truth is a prior draw from a ``torch.Generator`` seeded 42 and the
noise is drawn from one seeded 1, both on the device. Phases: multi-start
MAP (500 x 350 steps), FD Laplace + full-rank SVI (n_vi 1000 x 300 steps),
then serial HMC seeds 2, 3, 4 (50 chains, 250 burn-in + 750 results,
ChEES), then the posterior red-chi2 of the last draw.

With ``--smc`` the run adds adaptive-tempering SMC on the same scene
(``scripts/bench_smc.py``'s recipe: 1000 particles x 1 ensemble, 3-leapfrog
preconditioned moves, ESS threshold 0.6, up to 200 stages, 100 post steps,
seed 1, prior start, pixels target) and an ``smc`` block in the JSON line;
the default run's keys and ``value`` are unchanged.

With ``--cluster sie|dpie|both`` it runs config #5's full posterior
instead (:func:`run_cluster`, the counterpart of
``scripts/bench_cluster_posterior.py``: the same scene, phases, flags and
JSON line, ``metric`` ``cluster_full_posterior``).

Knobs: ``GIGALENS_BENCH_SCALE`` (tiny | small | full), ``GIGALENS_BENCH_SVI_STEPS``,
``GIGALENS_BENCH_HMC_SEEDS`` (comma-separated), ``GIGALENS_EPL_NITER``,
``GIGALENS_LAPLACE_METHOD`` (fd | exact), ``GIGALENS_BASELINE_S``.

It runs on the CUDA device and fails when there is none; ``--device cpu``
runs it on the CPU instead.

Under ``torchrun --nproc-per-node N -m gigalens_tpu_torch.bench`` every
process drives its own card (``cuda:LOCAL_RANK``) in one ``nccl`` process
group (``gloo`` with ``--device cpu``), and every phase shards its samples
over the group (:mod:`gigalens_tpu_torch.parallel`), as the JAX bench takes
all devices; only rank 0 logs and prints the JSON line, which then also
carries ``ranks``. A phase that fails on any rank prints that rank's
traceback, tagged with its rank, and ends the job with a nonzero exit
(the other ranks would wait in its collectives): no JSON line then.

Prints ONE JSON line with the keys of the JAX bench (``metric``, ``value``,
``phase_s``, ``seeds``, ``min_ess``, ``max_rhat``, ...), without its
``aot``, ``mfu`` and ``peak_*`` blocks. Each phase runs isolated: a failure
is recorded in ``failed_phases`` with ``complete: false`` and the process
exits nonzero. :func:`run_pipeline` is the same pipeline with no isolation.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import sys
import time
import traceback
import types

import numpy as np
import torch
import torch.distributed as dist

CONFIGS = {
    "tiny": dict(num_pix=40, map_n=32, map_steps=30, vi_n=32, vi_steps=30,
                 hmc_n=8, burnin=20, results=30, hmc_seeds=[2]),
    "small": dict(num_pix=80, map_n=100, map_steps=100, vi_n=100, vi_steps=150,
                  hmc_n=16, burnin=50, results=100, hmc_seeds=[2]),
    "full": dict(num_pix=80, map_n=500, map_steps=350, vi_n=1000, vi_steps=300,
                 hmc_n=50, burnin=250, results=750, hmc_seeds=[2, 3, 4]),
}
# the SMC recipe of scripts/bench_smc.py at each scale
SMC_CONFIGS = {
    "tiny": dict(particles=16, ensembles=1, leapfrog_steps=3, ess_threshold_ratio=0.6,
                 post_steps=4, max_stage=3, seed=1),
    "small": dict(particles=200, ensembles=1, leapfrog_steps=3, ess_threshold_ratio=0.6,
                  post_steps=20, max_stage=200, seed=1),
    "full": dict(particles=1000, ensembles=1, leapfrog_steps=3, ess_threshold_ratio=0.6,
                 post_steps=100, max_stage=200, seed=1),
}
DELTA_PIX, SUPERSAMPLE, BKG, EXP_TIME = 0.065, 2, 0.2, 100.0


def _grouped():
    return dist.is_available() and dist.is_initialized()


def _rank():
    return dist.get_rank() if _grouped() else 0


def log(msg):
    if _rank() == 0:
        print(msg, file=sys.stderr, flush=True)


def log_failure(msg):
    """A failure, on every rank, tagged with the rank under a process group."""
    if _grouped():
        msg = f"[rank {dist.get_rank()} of {dist.get_world_size()}] {msg}"
    print(msg, file=sys.stderr, flush=True)


def config_from_env():
    """The configuration ``GIGALENS_BENCH_SCALE`` names, with the step and
    seed overrides applied."""
    scale = os.environ.get("GIGALENS_BENCH_SCALE", "full")
    cfg = dict(CONFIGS[scale], scale=scale)
    if os.environ.get("GIGALENS_BENCH_SVI_STEPS"):
        cfg["vi_steps"] = int(os.environ["GIGALENS_BENCH_SVI_STEPS"])
    if os.environ.get("GIGALENS_BENCH_HMC_SEEDS"):
        cfg["hmc_seeds"] = [int(s) for s in os.environ["GIGALENS_BENCH_HMC_SEEDS"].split(",")]
    return cfg


def bench_prior():
    from gigalens_tpu_torch.prob import Prior
    from gigalens_tpu_torch.prob import distributions as d

    return Prior(dict(
        lens_mass=[
            dict(theta_E=d.LogNormal(math.log(1.25), 0.25),
                 gamma=d.TruncatedNormal(2, 0.25, 1, 3),
                 e1=d.Normal(0, 0.1), e2=d.Normal(0, 0.1),
                 center_x=d.Normal(0, 0.05), center_y=d.Normal(0, 0.05)),
            dict(gamma1=d.Normal(0, 0.05), gamma2=d.Normal(0, 0.05)),
        ],
        lens_light=[
            dict(R_sersic=d.LogNormal(math.log(1.0), 0.15), n_sersic=d.Uniform(2, 6),
                 e1=d.TruncatedNormal(0, 0.1, -0.3, 0.3),
                 e2=d.TruncatedNormal(0, 0.1, -0.3, 0.3),
                 center_x=d.Normal(0, 0.05), center_y=d.Normal(0, 0.05),
                 Ie=d.LogNormal(math.log(500.0), 0.3)),
        ],
        source_light=[
            dict(R_sersic=d.LogNormal(math.log(0.25), 0.15), n_sersic=d.Uniform(0.5, 4),
                 e1=d.TruncatedNormal(0, 0.15, -0.5, 0.5),
                 e2=d.TruncatedNormal(0, 0.15, -0.5, 0.5),
                 center_x=d.Normal(0, 0.25), center_y=d.Normal(0, 0.25),
                 Ie=d.LogNormal(math.log(150.0), 0.5)),
        ],
    ))


def gaussian_psf():
    """The JAX bench's 25x25 Gaussian fallback PSF."""
    g = np.exp(-((np.arange(25) - 12) ** 2 + (np.arange(25)[:, None] - 12) ** 2) / 8.0)
    return (g / g.sum()).astype(np.float32)


def epl_niter():
    """Series depth: ``GIGALENS_EPL_NITER``, else the convergence bound for
    the prior's axis ratios (q >= 0.43 at 4 sigma, tol 1e-8)."""
    from gigalens_tpu_torch.profiles.mass import EPL

    return int(os.environ.get("GIGALENS_EPL_NITER", 0)) or EPL.recommended_niter(
        q_min=0.43, tol=1e-8)


def bench_scene(num_pix=80, niter=None):
    """(phys, sim_config, niter) of the bench scene."""
    from gigalens_tpu_torch import PhysicalModel, SimulatorConfig
    from gigalens_tpu_torch.profiles.light import SersicEllipse
    from gigalens_tpu_torch.profiles.mass import EPL, Shear

    niter = niter or epl_niter()
    phys = PhysicalModel([EPL(niter), Shear()], [SersicEllipse()], [SersicEllipse()])
    cfg = SimulatorConfig(delta_pix=DELTA_PIX, num_pix=num_pix, supersample=SUPERSAMPLE,
                          kernel=gaussian_psf())
    return phys, cfg, niter


def survey_psfs(n_scenes):
    """Distinct per-scene PSFs (``scripts/bench_survey_production.py:61-81``
    with its fallback base, as the reference's ``psf.npy`` is not in the
    repo): a 13x13 Gaussian rotated by k * 90 degrees and smoothed by a
    scene-dependent Gaussian of sigma 0.5 + 0.35 k native pixels."""
    g = np.exp(-((np.arange(13) - 6) ** 2 + (np.arange(13)[:, None] - 6) ** 2) / 5.0)
    base = (g / g.sum()).astype(np.float32)
    out = []
    for s in range(n_scenes):
        k = np.rot90(base, k=s % 4).copy()
        sig = 0.5 + 0.35 * s
        xx = np.arange(-3, 4)
        g1 = np.exp(-(xx**2) / (2 * sig**2))
        g1 /= g1.sum()
        k = np.apply_along_axis(lambda r: np.convolve(r, g1, mode="same"), 0, k)
        k = np.apply_along_axis(lambda r: np.convolve(r, g1, mode="same"), 1, k)
        out.append((k / k.sum()).astype(np.float32))
    return np.stack(out)


def survey_scene(n_scenes, num_pix=60, supersample=SUPERSAMPLE, device="cuda"):
    """``scripts/bench_survey_production.py``'s catalogue: (prior, phys,
    sim_config, observations (S, H, W) numpy). The bench prior and the
    EPL(niter)+Shear, SersicEllipse lens light and source model at 0.065"
    with :func:`survey_psfs`; the truths are S prior draws from a
    ``torch.Generator`` seeded 42 on ``device``, rendered by the port, and
    observed at background_rms 0.2 / exp_time 100 with numpy noise seeded 1."""
    from gigalens_tpu_torch import PhysicalModel, SimulatorConfig
    from gigalens_tpu_torch.profiles.light import SersicEllipse
    from gigalens_tpu_torch.profiles.mass import EPL, Shear
    from gigalens_tpu_torch.simulator import LensSimulator

    prior = bench_prior()
    phys = PhysicalModel([EPL(epl_niter()), Shear()], [SersicEllipse()], [SersicEllipse()])
    cfg = SimulatorConfig(delta_pix=DELTA_PIX, num_pix=num_pix, supersample=supersample,
                          kernel=survey_psfs(n_scenes))
    truths = prior.sample(torch.Generator(device=device).manual_seed(42), n_scenes)
    with torch.no_grad():
        imgs = LensSimulator(phys, cfg, bs=n_scenes, device=device).simulate(truths)
    imgs = imgs.reshape(n_scenes, num_pix, num_pix).cpu().numpy()
    noise = np.random.default_rng(1).normal(size=imgs.shape).astype(np.float32)
    obs = imgs + noise * np.sqrt(BKG**2 + np.clip(imgs, 0, None) / EXP_TIME)
    return prior, phys, cfg, obs.astype(np.float32)


# config #5's cluster scene (scripts/bench_cluster_posterior.py:86-190):
# the image, noise and position errors, the dpie series' expansion point
# (the prior mean) and the fit's phase sizes (its run_pipeline, :192-316)
CL_DELTA, CL_NMAX, CL_ORDER = 0.2, 4, 3
CL_BKG, CL_EXP_TIME, CL_POS_ERR = 0.1, 500.0, 0.1
CL_CONSTS = dict(r_cut=1.5, r_core=0.08)
CL_DEPTHS = dict(num_pix=48, map_n=128, map_steps=400, vi_n=256, vi_steps=400)
CL_CHI2, CL_RHAT = (0.85, 1.15), 1.02  # the script's gates (:295-298)


def cluster_catalogue(n=20, spread=6.0, e_max=0.2):
    """The member catalogue of scripts/bench_cluster_posterior.py (numpy
    seeded 0): luminosities in [0.3, 3], centres N(0, ``spread``),
    ellipticities uniform in +-``e_max``."""
    rng = np.random.default_rng(0)
    return dict(lum=rng.uniform(0.3, 3.0, n).astype(np.float32),
                center_x=rng.normal(0, spread, n).astype(np.float32),
                center_y=rng.normal(0, spread, n).astype(np.float32),
                e1=rng.uniform(-e_max, e_max, n).astype(np.float32),
                e2=rng.uniform(-e_max, e_max, n).astype(np.float32))


def cluster_psf():
    """The script's 9x9 Gaussian PSF (sigma sqrt(2) native pixels)."""
    g = np.exp(-((np.arange(9) - 4) ** 2 + (np.arange(9)[:, None] - 4) ** 2) / 4.0)
    return (g / g.sum()).astype(np.float32)


def cluster_members(kind, galaxies=20):
    """The member stack of one arm: ``"sie"``, ScalingRelation(NIE) with
    theta_E ~ L^0.5 and a fixed 0.05" core a member; ``"dpie"``,
    DPIESubhaloSeries of order 3. Chunks of min(galaxies, 16) members."""
    from gigalens_tpu_torch.profiles.mass import NIE, DPIESubhaloSeries, ScalingRelation

    cat = cluster_catalogue(galaxies)
    chunk = min(galaxies, 16)
    if kind == "sie":
        cat = dict(cat, s_scale=np.full(galaxies, 0.05, np.float32))
        return ScalingRelation(NIE(), ["theta_E"], lum_star=1.0,
                               scaling_params_power={"theta_E": 0.5}, galaxy_catalogue=cat,
                               chunk_size=chunk)
    if kind == "dpie":
        return DPIESubhaloSeries(lum_star=1.0, galaxy_catalogue=cat, order=CL_ORDER,
                                 chunk_size=chunk)
    raise ValueError(f"cluster members are 'sie' or 'dpie', not {kind!r}")


def cluster_prior(kind, amplitudes=True):
    """The script's prior: the NFW_ELLIPSE halo's, the members' theta_E
    (and dpie's r_cut), the source's beta and centre, and with
    ``amplitudes`` the 15 Shapelets(4) amplitudes N(0, 5)."""
    from gigalens_tpu_torch.prob import Prior
    from gigalens_tpu_torch.prob import distributions as d
    from gigalens_tpu_torch.profiles.light import Shapelets

    members = dict(theta_E=d.LogNormal(math.log(0.3), 0.3))
    if kind == "dpie":
        members["r_cut"] = d.LogNormal(math.log(1.5), 0.2)
    src = dict(beta=d.LogNormal(math.log(0.4), 0.2), center_x=d.Normal(0, 0.3),
               center_y=d.Normal(0, 0.3))
    if amplitudes:
        src.update({a: d.Normal(0, 5.0) for a in Shapelets(CL_NMAX)._amp_names})
    return Prior(dict(
        lens_mass=[dict(Rs=d.LogNormal(math.log(10.0), 0.2),
                        alpha_Rs=d.LogNormal(math.log(4.0), 0.3), e1=d.Normal(0, 0.1),
                        e2=d.Normal(0, 0.1), center_x=d.Normal(0, 0.5),
                        center_y=d.Normal(0, 0.5)),
                   members],
        source_light=[src]))


def cluster_scene(kind, galaxies=20, seed=3, source="sampled", device="cuda", num_pix=48,
                  truth=None):
    """Config #5's cluster scene, one arm (``kind`` ``"sie"`` or
    ``"dpie"``; scripts/bench_cluster_posterior.py:86-190): an NFW_ELLIPSE
    halo, ``galaxies`` luminosity-scaled members (:func:`cluster_members`)
    and a Shapelets(4) source, ``num_pix`` px at 0.2", supersample 2, the
    9x9 Gaussian PSF, bkg 0.1, exp_time 500. The dpie series is expanded at
    the prior-mean point (r_cut 1.5, r_core 0.08) on the image grid. The
    truth is a prior draw (amplitudes sampled) from a ``torch.Generator``
    seeded 5 on ``device`` (torch cannot replay the script's JAX key 5), or
    ``truth``, a parameter tree of numbers; it is rendered by the port, and
    the noise is numpy's seeded ``seed``. The images of the true source come from
    ``utils.find_images``; with two or more, the ``"sampled"`` fit is a
    ForwardProbModel on pixels and those positions (0.1" errors). With
    ``source="lstsq"`` the fit solves the 15 amplitudes by weighted least
    squares a sample (``Shapelets(4, use_lstsq=True)``) in a
    BackwardProbModel, which takes no positions. Returns a namespace: the
    arm's ``kind``, ``galaxies`` and ``source``; the fit's ``phys``,
    ``prior`` and ``prob`` model; the simulator config ``cfg``; the
    ``members`` stack; the ``truth`` (a one-row parameter tree); the
    observation ``obs`` (numpy); the traced ``images`` ((x, y, mu) numpy
    arrays of the true source's images); the series precompute's wall
    ``precompute_s`` (dpie; 0 for sie)."""
    from gigalens_tpu_torch import PhysicalModel, SimulatorConfig
    from gigalens_tpu_torch.model import BackwardProbModel, ForwardProbModel
    from gigalens_tpu_torch.profiles.light import Shapelets
    from gigalens_tpu_torch.profiles.mass import NFW_ELLIPSE
    from gigalens_tpu_torch.simulator import LensSimulator
    from gigalens_tpu_torch.utils import find_images

    if source not in ("sampled", "lstsq"):
        raise ValueError(f"source is 'sampled' or 'lstsq', not {source!r}")
    device = torch.device(device)
    members = cluster_members(kind, galaxies)
    phys = PhysicalModel([NFW_ELLIPSE(), members], [], [Shapelets(CL_NMAX)])
    prior = cluster_prior(kind)
    cfg = SimulatorConfig(delta_pix=CL_DELTA, num_pix=num_pix, supersample=2,
                          kernel=cluster_psf())
    probe = LensSimulator(phys, cfg, bs=1, device=device)
    precompute_s = 0.0
    if kind == "dpie":
        members.set_constants(CL_CONSTS)
        members.set_grid(probe.img_x, probe.img_y)
        _sync(device)
        t0 = time.perf_counter()
        members.set_deriv()
        _sync(device)
        precompute_s = time.perf_counter() - t0
        log(f"[{kind}] series precompute {precompute_s:.1f}s")

    if truth is None:
        truth = prior.sample(torch.Generator(device=device).manual_seed(5), 1)
    else:
        truth = {g: [{k: torch.tensor([v], dtype=torch.float32, device=device)
                      for k, v in p.items()} for p in ps] for g, ps in truth.items()}
    with torch.no_grad():
        clean = probe.simulate(truth).cpu().numpy()
    noise = np.random.default_rng(seed).normal(size=clean.shape).astype(np.float32)
    obs = (clean + noise * np.sqrt(CL_BKG**2 + np.clip(clean, 0, None) / CL_EXP_TIME)
           ).astype(np.float32)
    src = truth["source_light"][0]
    images = find_images(probe, truth["lens_mass"], float(src["center_x"][0]),
                         float(src["center_y"][0]), search_window=4.0)
    log(f"[{kind}] {len(images[0])} multiple images traced")
    if source == "lstsq":
        phys = PhysicalModel([NFW_ELLIPSE(), members], [], [Shapelets(CL_NMAX, use_lstsq=True)])
        prior = cluster_prior(kind, amplitudes=False)
        prob = BackwardProbModel(prior, obs, background_rms=CL_BKG, exp_time=CL_EXP_TIME,
                                 device=device)
    else:
        kw = {}
        if len(images[0]) >= 2:
            err = np.full(len(images[0]), CL_POS_ERR, np.float32)
            kw = dict(centroids_x=[images[0]], centroids_y=[images[1]],
                      centroids_errors_x=[err], centroids_errors_y=[err])
        prob = ForwardProbModel(prior, obs, background_rms=CL_BKG, exp_time=CL_EXP_TIME,
                                device=device, **kw)
    return types.SimpleNamespace(kind=kind, galaxies=galaxies, source=source, phys=phys,
                                 prior=prior, prob=prob, cfg=cfg, members=members, truth=truth,
                                 obs=obs, images=images, precompute_s=precompute_s)


def observe(img, gen, bkg=BKG, exp_time=EXP_TIME):
    """Gaussian + Poisson noise at the bench's background and exposure."""
    return img + torch.randn(img.shape, generator=gen, device=img.device) * torch.sqrt(
        bkg**2 + torch.clamp(img, min=0.0) / exp_time)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _nanmin(x):
    return float(torch.where(torch.isnan(x), torch.inf, x).min())


def new_result(cfg, device_name=None):
    """The JSON line's dict before any phase has run."""
    result = {"metric": "map_svi_hmc_wallclock", "value": None, "unit": "s",
              "vs_baseline": None, "phase_s": {}, "seeds": [], "scale": cfg.get("scale")}
    if device_name is not None:
        result["device"] = device_name
    return result


class Pipeline:
    """The bench pipeline's state and phases, in order: :meth:`phase_map`,
    :meth:`phase_svi`, :meth:`phase_hmc`, :meth:`phase_posterior_chi2`.
    Each fills ``self.result`` (the JSON line's dict) as it completes.

    ``phase_hook(name)``, if given, returns a context manager entered around
    each measured piece: ``map``, ``laplace``, ``svi``, ``hmc`` (once per
    seed), ``posterior_chi2`` and ``smc``.
    """

    def __init__(self, cfg, hmc_seeds=None, device="cuda", phase_hook=None):
        from gigalens_tpu_torch.inference import ModellingSequence
        from gigalens_tpu_torch.model import ForwardProbModel
        from gigalens_tpu_torch.simulator import LensSimulator

        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device (pass device='cpu', or --device cpu, "
                               "to run on the CPU)")
        self.cfg = cfg
        self.hmc_seeds = list(cfg["hmc_seeds"] if hmc_seeds is None else hmc_seeds)
        self.hook = phase_hook or (lambda name: contextlib.nullcontext())
        self.phys, self.sim_config, self.niter = bench_scene(cfg["num_pix"])
        self.prior = bench_prior()
        log(f"device: {self.device}  scale={cfg.get('scale')}  EPL niter={self.niter}")

        self.truth = truth = self.prior.sample(
            torch.Generator(device=self.device).manual_seed(42), 1)
        sim1 = LensSimulator(self.phys, self.sim_config, bs=1, device=self.device)
        with torch.no_grad():
            img = sim1.simulate(truth)
        obs = observe(img, torch.Generator(device=self.device).manual_seed(1))
        self.prob_model = ForwardProbModel(self.prior, obs.cpu().numpy(), background_rms=BKG,
                                           exp_time=EXP_TIME, device=self.device)
        self.seq = ModellingSequence(self.phys, self.prob_model, self.sim_config,
                                     device=self.device)
        self.result = new_result(cfg, torch.cuda.get_device_name(self.device)
                                 if self.device.type == "cuda" else "cpu")
        if self.seq.mesh.group is not None:
            self.result["ranks"] = self.seq.mesh.size

    def _score(self, z):
        """(log_prob, reduced chi2) of ``z`` on the fast simulator."""
        from gigalens_tpu_torch.simulator import LensSimulator

        sim = LensSimulator(self.phys, self.sim_config, bs=z.shape[0], device=self.device)
        with torch.no_grad():
            return self.prob_model.log_prob(sim, z)

    def phase_map(self):
        from gigalens_tpu_torch.inference.sequence import map_optimizer

        cfg = self.cfg
        with self.hook("map"):
            t0 = time.perf_counter()
            z_map = self.seq.MAP(map_optimizer(cfg["map_steps"]), n_samples=cfg["map_n"],
                                 num_steps=cfg["map_steps"], seed=0)
            _sync(self.device)
            self.t_map = time.perf_counter() - t0
        lps, chi2 = self._score(z_map)
        self.z_map, self.lps = z_map, lps
        self.best_chi2 = _nanmin(chi2)
        log(f"MAP: {self.t_map:.1f}s best red-chi2 {self.best_chi2:.3f}")
        self.result["phase_s"]["map"] = round(self.t_map, 2)
        self.result["best_map_red_chi2"] = round(self.best_chi2, 4)

    def phase_svi(self):
        """FD Laplace at the best MAP point, then SVI; the Laplace wall is
        counted inside the SVI phase's, as in the JAX bench."""
        from gigalens_tpu_torch.inference.sequence import svi_optimizer

        cfg = self.cfg
        t0 = time.perf_counter()
        with self.hook("laplace"):
            lps = torch.where(torch.isnan(self.lps), -torch.inf, self.lps)
            best = self.z_map[torch.argmax(lps)][None, :]
            method = os.environ.get("GIGALENS_LAPLACE_METHOD", "fd")
            L0 = self.seq.laplace_scale_tril(best, method=method)
            self.t_laplace = time.perf_counter() - t0
        log(f"laplace init ({method}): {self.t_laplace:.1f}s")
        with self.hook("svi"):
            self.q_z, self.losses = self.seq.SVI(best, svi_optimizer(cfg["vi_steps"]),
                                                 n_vi=cfg["vi_n"],
                                                 num_steps=cfg["vi_steps"], init_scales=L0,
                                                 seed=1)
            _sync(self.device)
            self.t_svi = time.perf_counter() - t0
        self.elbo = (float(self.losses[0]), float(self.losses[-1]))
        log(f"SVI: {self.t_svi:.1f}s elbo {self.elbo[0]:.1f} -> {self.elbo[1]:.1f}")
        self.result["phase_s"]["svi"] = round(self.t_svi, 2)
        self.result["laplace_s"] = round(self.t_laplace, 2)

    def phase_hmc(self):
        """Serial HMC seeds; the headline quality is the last seed's."""
        from gigalens_tpu_torch.utils import effective_sample_size, potential_scale_reduction

        cfg = self.cfg
        rows = []
        for seed in self.hmc_seeds:
            with self.hook("hmc"):
                t0 = time.perf_counter()
                res = self.seq.HMC(self.q_z, n_hmc=cfg["hmc_n"], num_burnin_steps=cfg["burnin"],
                                   num_results=cfg["results"], seed=seed)
                _sync(self.device)
                t_hmc = time.perf_counter() - t0
            ess = effective_sample_size(res.samples)
            rhat = potential_scale_reduction(res.samples)
            accept = float(res.accept_rate[-100:].mean())
            eps, nlf = float(res.step_size), int(res.total_leapfrogs)
            rows.append(dict(seed=seed, t=t_hmc, min_ess=float(ess.min()),
                             ess_per_sec=float(ess.min()) / t_hmc, max_rhat=float(rhat.max()),
                             accept=accept, eps=eps, leapfrogs=nlf))
            log(f"HMC seed {seed}: {t_hmc:.1f}s accept {accept:.2f} eps {eps:.4f} "
                f"min ESS {ess.min():.0f} max rhat {rhat.max():.3f} leapfrogs {nlf} "
                f"({t_hmc / max(nlf, 1) * 1e3:.2f} ms/lf)")
        self.hmc_res, self.seed_rows = res, rows
        self.ess, self.rhat = ess, rhat
        t_med = float(np.median([r["t"] for r in rows]))
        self.result.update({
            "value": round(self.t_map + self.t_svi + t_med, 2),
            "ess_per_sec": round(float(ess.min()) / rows[-1]["t"], 2),
            "ess_per_sec_median": round(float(np.median([r["ess_per_sec"] for r in rows])), 2),
            "seeds": [{k: (round(v, 4) if isinstance(v, float) else v) for k, v in r.items()}
                      for r in rows],
            "hmc_grouped": False,
            "hmc_wall_all_seeds": round(float(np.sum([r["t"] for r in rows])), 2),
            "min_ess": round(float(ess.min()), 1),
            "max_rhat": round(float(rhat.max()), 4),
            "accept_rate": round(rows[-1]["accept"], 3),
        })
        self.result["phase_s"]["hmc"] = round(t_med, 2)

    def phase_posterior_chi2(self):
        """Mean reduced chi2 over the chains' last draw (fast simulator)."""
        with self.hook("posterior_chi2"):
            _, chi2 = self._score(self.hmc_res.samples[-1])
            self.post_chi2 = float(torch.mean(chi2))
        log(f"posterior mean red-chi2 {self.post_chi2:.3f}")
        self.result["posterior_red_chi2"] = round(self.post_chi2, 4)

    def phase_smc(self):
        """Adaptive-tempering SMC from the prior on the exact simulator
        (``SMC_CONFIGS`` of the configuration's scale); fills the
        ``smc`` block: walls (tempering and post chain on the host clock),
        stages, moves, leapfrogs, log-evidence, final beta and the mean
        reduced chi2 of the post chain's last draw (of the particles when
        there is no post chain)."""
        c = SMC_CONFIGS[self.cfg["scale"]]
        with self.hook("smc"):
            t0 = time.perf_counter()
            res = self.seq.SMC(num_particles=c["particles"], num_ensembles=c["ensembles"],
                               num_leapfrog_steps=c["leapfrog_steps"],
                               post_sampling_steps=c["post_steps"],
                               ess_threshold_ratio=c["ess_threshold_ratio"],
                               max_stage=c["max_stage"], seed=c["seed"])
            _sync(self.device)
            wall = time.perf_counter() - t0
        last = (res.post_samples[-1] if c["post_steps"] > 0
                else res.particles.reshape(-1, self.prior.d))
        _, chi2 = self._score(last)
        self.smc_res = res
        leapfrogs = (res.num_moves + c["post_steps"]) * c["leapfrog_steps"]
        block = dict(c, wall_s=round(wall, 3), tempering_s=round(res.tempering_s, 3),
                     post_s=round(wall - res.tempering_s, 3), stages=res.num_stages,
                     moves=res.num_moves, leapfrogs=leapfrogs,
                     ms_per_leapfrog=round(1e3 * wall / max(leapfrogs, 1), 3),
                     log_evidence=[round(float(v), 4) for v in res.log_evidence],
                     final_beta=[float(b) for b in res.final_beta],
                     posterior_red_chi2=round(float(torch.mean(chi2)), 4))
        log(f"SMC: {wall:.1f}s ({res.tempering_s:.1f}s tempering) stages {res.num_stages} "
            f"leapfrogs {leapfrogs} logZ {block['log_evidence']} "
            f"posterior red-chi2 {block['posterior_red_chi2']}")
        self.result["smc"] = block

    def phases(self, smc=False):
        out = [("map", self.phase_map), ("svi", self.phase_svi), ("hmc", self.phase_hmc),
               ("posterior_chi2", self.phase_posterior_chi2)]
        return out + [("smc", self.phase_smc)] if smc else out


def finish(result, failures=()):
    """Marks completeness, fills a partial total and ``vs_baseline``."""
    if failures:
        result["failed_phases"] = list(failures)
    result["complete"] = not failures
    if result["value"] is None and result["phase_s"]:
        # honest partial total: the completed phases' walls
        result["value"] = round(sum(result["phase_s"].values()), 2)
    baseline_s = os.environ.get("GIGALENS_BASELINE_S")
    if baseline_s and result["value"]:
        result["vs_baseline"] = float(baseline_s) / result["value"]
    return result


def run_pipeline(cfg, hmc_seeds=None, device="cuda", phase_hook=None) -> Pipeline:
    """Runs every phase in order with no isolation (a failure raises) and
    returns the :class:`Pipeline`; its ``result`` is the JSON line's dict."""
    pipe = Pipeline(cfg, hmc_seeds, device=device, phase_hook=phase_hook)
    for _, phase in pipe.phases():
        phase()
    finish(pipe.result)
    return pipe


def main(cfg=None, device="cuda", smc=False) -> int:
    """Runs the pipeline (and SMC when ``smc``) with each phase isolated,
    prints the JSON line, and returns 0 only if every phase completed.
    Under a process group a failed phase raises instead, after its
    traceback: the other ranks cannot go on without this one."""
    cfg = cfg or config_from_env()
    failures = []
    result = new_result(cfg)
    try:
        pipe = Pipeline(cfg, device=device)
        result = pipe.result
        for name, phase in pipe.phases(smc):
            try:
                phase()
            except Exception as e:
                log_failure(f"PHASE {name} FAILED:\n{traceback.format_exc(limit=8)}")
                failures.append(dict(phase=name, path="primary",
                                     error=f"{type(e).__name__}: {str(e)[:500]}"))
                break  # every later phase needs this one's output
    except Exception as e:
        log_failure(traceback.format_exc())
        failures.append(dict(phase="setup", path="primary",
                             error=f"{type(e).__name__}: {str(e)[:500]}"))
    if failures and _grouped():
        # the other ranks wait in this phase's collectives for this rank:
        # end it, and with it the job (torchrun stops the other ranks)
        raise RuntimeError(f"rank {dist.get_rank()}: phase {failures[0]['phase']} failed "
                           f"({failures[0]['error']})")
    finish(result, failures)
    if _rank() == 0:
        print(json.dumps(result), flush=True)
    return 0 if result["complete"] else 1


class ClusterRun:
    """The fit of one arm of config #5 on a :func:`cluster_scene`, as
    scripts/bench_cluster_posterior.py's ``run_pipeline`` (:192-316) runs
    it: :meth:`phase_map` (multi-start MAP, polynomial schedule), then for
    HMC :meth:`phase_svi` (the FD Laplace at the best start by log_prob,
    then full-rank SVI) and :meth:`phase_hmc`, or :meth:`phase_smc` from
    the prior; then :meth:`phase_report` (ESS, split-R-hat, the pixel
    red-chi2 of the last draw, theta_E* against the truth, the gates).
    ``row`` is the JSON line's row. ``hook(name)``, if given, returns a
    context manager entered around each phase's timed piece."""

    def __init__(self, scene, device="cuda", hook=None):
        from gigalens_tpu_torch.inference import ModellingSequence

        self.scene, self.device = scene, torch.device(device)
        self.hook = hook or (lambda name: contextlib.nullcontext())
        self.seq = ModellingSequence(scene.phys, scene.prob, scene.cfg, device=self.device)
        n_pos = len(scene.images[0]) if getattr(scene.prob, "include_positions", False) else 0
        self.row = dict(members=scene.kind, galaxies=scene.galaxies, source=scene.source,
                        positions=n_pos)

    def _sim(self, bs):
        """A fast-path simulator (the fused render and, on the card, the
        direct K4) for a batch of ``bs``, as the script's ``LensSimulator``."""
        from gigalens_tpu_torch.simulator import LensSimulator

        return LensSimulator(self.scene.phys, self.scene.cfg, bs=bs, device=self.device)

    def phase_map(self, n=CL_DEPTHS["map_n"], steps=CL_DEPTHS["map_steps"]):
        from gigalens_tpu_torch.inference.sequence import map_optimizer

        with self.hook("map"):
            t0 = time.perf_counter()
            z_map = self.seq.MAP(map_optimizer(steps), n_samples=n, num_steps=steps, seed=0)
            _sync(self.device)
            t_map = time.perf_counter() - t0
        self.set_map(z_map, t_map)

    def set_map(self, z_map, t_map):
        """Takes a MAP result ``z_map`` (its wall ``t_map``): scores it on
        the fast path (log_prob, the pixel red-chi2's minimum)."""
        prior, prob = self.scene.prior, self.scene.prob
        sim = self._sim(z_map.shape[0])
        with torch.no_grad():
            self.lps = prob.log_prob(sim, z_map)[0]
            chi2 = prob.stats_pixels(sim, prior.constrain(z_map))[1]
        self.z_map = z_map
        self.row["t_map"] = t_map
        self.row["map_red_chi2"] = _nanmin(chi2)
        log(f"[{self.scene.kind}] MAP {t_map:.1f}s best red-chi2 {self.row['map_red_chi2']:.3f}")

    def phase_svi(self, n_vi=CL_DEPTHS["vi_n"], steps=CL_DEPTHS["vi_steps"]):
        """The FD Laplace at the best MAP start, then SVI; the Laplace's
        wall is inside ``t_svi``, as in the script."""
        from gigalens_tpu_torch.inference.sequence import svi_optimizer

        with self.hook("svi"):
            t0 = time.perf_counter()
            lps = torch.where(torch.isnan(self.lps), -torch.inf, self.lps)
            best = self.z_map[torch.argmax(lps)][None, :]
            L0 = self.seq.laplace_scale_tril(best)
            self.t_laplace = time.perf_counter() - t0
            self.q_z, losses = self.seq.SVI(best, svi_optimizer(steps), n_vi=n_vi,
                                            num_steps=steps, init_scales=L0, seed=1)
            _sync(self.device)
            self.row["t_svi"] = time.perf_counter() - t0
        log(f"[{self.scene.kind}] SVI {self.row['t_svi']:.1f}s (Laplace {self.t_laplace:.1f}s) "
            f"elbo {float(losses[-1]):.1f}")

    def phase_hmc(self, n_hmc=50, burnin=500, results=750, traj="chees", init_l=8,
                  mass_windows=1, seed=3):
        with self.hook("hmc"):
            t0 = time.perf_counter()
            res = self.seq.HMC(self.q_z, n_hmc=n_hmc, num_burnin_steps=burnin,
                               num_results=results, seed=seed, trajectory_adaptation=traj,
                               init_l=init_l, mass_adaptation=mass_windows)
            _sync(self.device)
            self.row["t_hmc"] = time.perf_counter() - t0
        self.res, self.samples = res, res.samples
        self.row.update(accept=float(res.accept_rate[-100:].mean()),
                        divergent_chain_steps=int(res.divergences.sum()),
                        leapfrogs=int(res.total_leapfrogs))

    def phase_smc(self, particles=1000, results=750, seed=3):
        """Tempered SMC from the prior on pixels (10 leapfrogs a move,
        ``results`` post steps); no surrogate, so ``t_svi`` is 0. Its
        leapfrogs are the moves' and the post chain's."""
        self.row["t_svi"] = 0.0
        with self.hook("smc"):
            t0 = time.perf_counter()
            res = self.seq.SMC(num_particles=particles, num_ensembles=1, num_leapfrog_steps=10,
                               post_sampling_steps=results, target="pixels", auxiliar="none",
                               seed=seed, segment_stages=1)
            _sync(self.device)
            self.row["t_hmc"] = time.perf_counter() - t0
        self.res, self.samples = res, res.post_samples
        self.row.update(smc_stages=res.num_stages,
                        log_evidence=float(res.log_evidence[0]),
                        final_beta=float(res.final_beta[0]), accept=1.0,
                        divergent_chain_steps=0,
                        leapfrogs=(res.num_moves + results) * 10)

    def phase_report(self):
        from gigalens_tpu_torch.utils import effective_sample_size, potential_scale_reduction

        scene, row, samples = self.scene, self.row, self.samples
        with self.hook("report"):
            ess = effective_sample_size(samples)
            rhat = potential_scale_reduction(samples)
            row.update(min_ess=float(ess.min()), max_rhat=float(rhat.max()),
                       ess_per_sec=float(ess.min()) / row["t_hmc"])
            # the PIXEL red-chi2: log_prob's averages in the position term
            with torch.no_grad():
                chi2 = scene.prob.stats_pixels(self._sim(samples.shape[1]),
                                               scene.prior.constrain(samples[-1]))[1]
            row["posterior_red_chi2"] = float(torch.mean(chi2))
            row["total_s"] = row["t_map"] + row["t_svi"] + row["t_hmc"]
            te = scene.prior.constrain(samples.reshape(-1, samples.shape[-1]))
            te = te["lens_mass"][1]["theta_E"]
            row["theta_E_star"] = dict(true=float(scene.truth["lens_mass"][1]["theta_E"][0]),
                                       mean=float(te.mean()), std=float(te.std()))
            row["gates"] = dict(chi2_ok=CL_CHI2[0] <= row["posterior_red_chi2"] <= CL_CHI2[1],
                                rhat_ok=row["max_rhat"] <= CL_RHAT)
        log(f"[{scene.kind}] {'SMC' if 'smc_stages' in row else 'HMC'} {row['t_hmc']:.1f}s "
            f"minESS {row['min_ess']:.0f} maxRhat {row['max_rhat']:.3f} post-chi2 "
            f"{row['posterior_red_chi2']:.3f} gates {row['gates']}")


def run_cluster(kind, galaxies=20, hmc=50, burnin=500, results=750, seed=3, traj="chees",
                init_l=8, mass_windows=1, sampler="hmc", particles=1000, source="sampled",
                device="cuda", num_pix=CL_DEPTHS["num_pix"], map_n=CL_DEPTHS["map_n"],
                map_steps=CL_DEPTHS["map_steps"], vi_n=CL_DEPTHS["vi_n"],
                vi_steps=CL_DEPTHS["vi_steps"], hook=None, truth=None):
    """One arm of config #5 end to end (scripts/bench_cluster_posterior.py's
    ``run_pipeline`` with its flags as arguments, and the phase sizes it
    fixes, ``num_pix`` to ``vi_steps``, and :func:`cluster_scene`'s
    ``truth``, as keywords); returns the
    :class:`ClusterRun`, whose ``row`` is the JSON line's row (with the
    sampler's host ms a leapfrog and, on the card, the peak device memory
    of the run in GiB). A phase that fails raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (pass device='cpu', or --device cpu, "
                           "to run on the CPU)")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    scene = cluster_scene(kind, galaxies=galaxies, seed=seed, source=source, device=device,
                          num_pix=num_pix, truth=truth)
    run = ClusterRun(scene, device=device, hook=hook)
    run.phase_map(map_n, map_steps)
    if sampler == "smc":
        run.phase_smc(particles, results, seed)
    else:
        run.phase_svi(vi_n, vi_steps)
        run.phase_hmc(hmc, burnin, results, traj, init_l, mass_windows, seed)
    run.phase_report()
    run.row["ms_per_leapfrog"] = 1e3 * run.row["t_hmc"] / max(run.row["leapfrogs"], 1)
    if device.type == "cuda":
        run.row["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    return run


def cluster_main(kinds=("sie", "dpie"), device="cuda", **kw) -> int:
    """Runs :func:`run_cluster` for each arm in ``kinds`` (keywords passed
    on) and prints one JSON line, the script's: ``metric``
    ``cluster_full_posterior``, ``unit``, ``value`` (the median
    ``total_s``), ``device``, ``runs``, plus ``complete``. Returns 0 only
    if every arm completed; an arm that raises is logged with its
    traceback and ends the run."""
    rows, failures = [], []
    for kind in kinds:
        try:
            rows.append(run_cluster(kind, device=device, **kw).row)
        except Exception as e:
            log_failure(f"CLUSTER {kind} FAILED:\n{traceback.format_exc(limit=8)}")
            failures.append(dict(members=kind, error=f"{type(e).__name__}: {str(e)[:500]}"))
            break
    if failures and _grouped():
        raise RuntimeError(f"rank {dist.get_rank()}: cluster {failures[0]['members']} failed")
    device = torch.device(device)
    out = {"metric": "cluster_full_posterior", "unit": "s",
           "value": round(float(np.median([r["total_s"] for r in rows])), 2) if rows else None,
           "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                      and torch.cuda.is_available() else str(device)),
           "runs": rows, "complete": not failures}
    if failures:
        out["failed"] = failures
    if _rank() == 0:
        print(json.dumps(out), flush=True)
    return 0 if not failures else 1


def _cli(argv):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--smc", action="store_true",
                    help="also run SMC and add its block to the JSON line")
    cl = ap.add_argument_group(
        "config #5's cluster full posterior (scripts/bench_cluster_posterior.py's flags)")
    cl.add_argument("--cluster", choices=["sie", "dpie", "both"],
                    help="run the cluster arms instead of the bench pipeline")
    cl.add_argument("--galaxies", type=int, default=20)
    cl.add_argument("--hmc", type=int, default=50)
    cl.add_argument("--burnin", type=int, default=500)
    cl.add_argument("--results", type=int, default=750)
    cl.add_argument("--seed", type=int, default=3)
    cl.add_argument("--traj", default="chees", choices=["chees", "static"],
                    help="trajectory adaptation (static uses --init-l leapfrogs)")
    cl.add_argument("--init-l", type=int, default=8)
    cl.add_argument("--mass-windows", type=int, default=1,
                    help="Stan-style warmup covariance re-estimations")
    cl.add_argument("--sampler", default="hmc", choices=["hmc", "smc"])
    cl.add_argument("--particles", type=int, default=1000)
    cl.add_argument("--source", default="sampled", choices=["sampled", "lstsq"],
                    help="shapelet amplitudes sampled (Forward) or solved by weighted "
                         "lstsq (Backward)")
    args = ap.parse_args(argv)

    def run(device):
        if args.cluster is None:
            return main(device=device, smc=args.smc)
        kinds = ["sie", "dpie"] if args.cluster == "both" else [args.cluster]
        return cluster_main(kinds, device=device, galaxies=args.galaxies, hmc=args.hmc,
                            burnin=args.burnin, results=args.results, seed=args.seed,
                            traj=args.traj, init_l=args.init_l,
                            mass_windows=args.mass_windows, sampler=args.sampler,
                            particles=args.particles, source=args.source)

    if "RANK" not in os.environ:
        return run(args.device)
    # under torchrun: one process a device, every phase's samples sharded
    # over the world group (ModellingSequence's default mesh)
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    try:
        return run(device)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(_cli(sys.argv[1:]))
