"""The JAX package's shipped workflows on the port.

    python3 -m gigalens_tpu_torch.demos {composite,timedelay,comparison,multiplane} [--device cpu] [--quick]

Each workflow is a scene builder and a runner, counterparts of:

* ``composite``: ``examples/demo_composite.py``. Hernquist stars, an
  elliptical NFW halo, an m=4 multipole and shear; 64 px at 0.08",
  supersample 2, a 13-px Gaussian PSF; MAP 256 x 250, FD Laplace, SVI 200 x
  300, ChEES HMC 16 x (150 + 400) with seed 2.
* ``timedelay``: ``examples/demo_timedelay.py``. An SIE + Shear quad at
  (z_l, z_s) = (0.5, 2.0), H0 70: its images from ``find_images``, then
  positions, three delays and four fluxes with a sampled D_dt through
  ``ModellingSequence.fit``; D_dt's posterior gives H0.
* ``comparison``: ``examples/demo_model_comparison.py``. The SMC evidence of
  EPL against SIE (each + Shear, a SersicEllipse source) on an EPL truth at
  gamma 2.4; 32 px at 0.065", 256 particles x 2 ensembles from the prior.
* ``multiplane``: ``docs/multiplane.md``'s model (SIE + Shear at z 0.4, SIS
  at 0.9, z_s 2.0) in ``tests/test_multiplane.py``'s configuration (24 px
  at 0.08", supersample 2, a 5-px PSF); MAP 128 x 300 from prior draws,
  then the images of the true source and their magnifications from the
  composed Jacobian, held to central differences of ``beta``.

The truths are the JAX demos' own prior draws, copied as float32 values
(torch cannot replay JAX's PRNG); each observation is the port's render of
its truth plus the demo's numpy noise. The runners' MAP starts come from a
seeded ``torch.Generator``. Each runner returns a dataclass with the
numbers the JAX demo prints and its gates; the CLI prints them and one
JSON line, and exits 0 only if every gate holds. Everything runs on the
CUDA card unless ``device="cpu"`` (``--device cpu``) is asked for, and
raises without a card.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import time
import types

import numpy as np
import torch

from gigalens_tpu_torch import PhysicalModel, SimulatorConfig
from gigalens_tpu_torch.cosmology import FlatLambdaCDM
from gigalens_tpu_torch.inference import ModellingSequence
from gigalens_tpu_torch.inference.sequence import map_optimizer, svi_optimizer
from gigalens_tpu_torch.model import _TD_DAYS, ForwardProbModel, resolve_device
from gigalens_tpu_torch.prob import Prior
from gigalens_tpu_torch.prob import distributions as d
from gigalens_tpu_torch.profiles.light import SersicEllipse
from gigalens_tpu_torch.profiles.mass import (EPL, NFW_ELLIPSE, SIE, SIS, Hernquist, Multipole,
                                              Shear)
from gigalens_tpu_torch.simulator import LensSimulator
from gigalens_tpu_torch.utils import (effective_sample_size, find_images,
                                      potential_scale_reduction)

# gates: the demos' own where they print one, else the bench's. The
# bench's stricter ones (best-MAP red-chi2 <= 1.1, split-R-hat <= 1.02) hold
# a leg where the JAX demo's own run on a CPU meets them; where it misses
# one, the leg is held to what that run reached (PERF.md, PR 15): the
# composite's R-hat is NaN there (F-ref-8), so printed only; the time
# delay's D_dt R-hat 1.136.
CHI2_GATE, RHAT_GATE = 1.1, 1.02
TD_RHAT_GATE = 1.136
POST_CHI2 = (0.85, 1.15)  # a posterior draw's red-chi2
ACCEPT = (0.3, 1.0)  # HMC acceptance, open interval
RECOVERY_STD = 3.0  # composite: |posterior mean - truth| in posterior std
D_DT_STD = 2.0  # time delay: |D_dt mean - truth| in posterior std
BF_MIN = 5.0  # comparison: log BF above max(BF_MIN, ensemble spread)
# tests/test_multiplane.py:138-151: central differences of beta at eps 1e-3
FD_EPS, FD_RTOL, FD_ATOL = 1e-3, 2e-2, 2e-3


def log(msg):
    print(msg, flush=True)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _as_tree(values, device):
    """A one-row parameter tree of float32 tensors from a tree of numbers."""
    def leaf(v):
        return torch.tensor([v], dtype=torch.float32, device=device)

    if isinstance(values, list):
        return [{k: leaf(v) for k, v in p.items()} for p in values]
    return {g: _as_tree(ps, device) for g, ps in values.items()}


def _gaussian_psf(n, denom):
    """exp(-r^2 / denom) on an n x n grid, normalized (the demos' PSFs)."""
    c = (n - 1) // 2
    g = np.exp(-((np.arange(n) - c) ** 2 + (np.arange(n)[:, None] - c) ** 2) / denom)
    return (g / g.sum()).astype(np.float32)


def _observe(clean, rng, bkg, exp_time):
    """The demos' noise: Gaussian at bkg and Poisson at exp_time, numpy."""
    noise = rng.normal(size=clean.shape).astype(np.float32)
    return (clean + noise * np.sqrt(bkg**2 + np.clip(clean, 0, None) / exp_time)).astype(
        np.float32)


def _render(phys, cfg, truth, device):
    with torch.no_grad():
        return LensSimulator(phys, cfg, bs=1, device=device).simulate(truth).cpu().numpy()


def _nanmin(x):
    return float(torch.where(torch.isnan(x), torch.inf, x).min())


def _hook(hook):
    return hook or (lambda name: contextlib.nullcontext())


class _Result:
    def row(self):
        """The JSON line's fields: every field but ``states``."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if f.name != "states"}

    @property
    def ok(self):
        return all(self.gates().values())


# --------------------------------------------------------------------------
# composite: examples/demo_composite.py
# --------------------------------------------------------------------------

# prior.sample(jax.random.PRNGKey(3), 1) of the demo's prior (:115)
COMPOSITE_TRUTH = dict(
    lens_mass=[dict(sigma0=0.45662224292755127, Rs=0.7750028371810913,
                    center_x=0.07985690981149673, center_y=-0.03776833787560463),
               dict(Rs=2.179551839828491, alpha_Rs=0.818161129951477,
                    e1=-0.12483943998813629, e2=-0.039827391505241394,
                    center_x=-0.05269521474838257, center_y=-0.0344621017575264),
               dict(a_m=-0.00714511564001441, phi_m=1.2674928903579712,
                    center_x=-0.03583187609910965, center_y=-0.016279438510537148),
               dict(gamma1=-0.004312177654355764, gamma2=-0.01939178816974163)],
    lens_light=[dict(R_sersic=0.5977236032485962, n_sersic=2.754152774810791,
                     e1=0.16107435524463654, e2=-0.0345718152821064,
                     center_x=-0.029389068484306335, center_y=-0.030101461336016655,
                     Ie=195.97021484375)],
    source_light=[dict(R_sersic=0.1952662318944931, n_sersic=2.0752451419830322,
                       e1=0.2126169353723526, e2=-0.06481137126684189,
                       center_x=-0.2616061270236969, center_y=0.05716169625520706,
                       Ie=190.58798217773438)])
COMPOSITE_DELTA, COMPOSITE_BKG, COMPOSITE_EXP_TIME = 0.08, 0.2, 100.0
# the demo's sizes (:125-127), and its --quick ones
COMPOSITE_DEPTHS = dict(num_pix=64, map_n=256, map_steps=250, vi_n=200, vi_steps=300,
                        hmc_n=16, burnin=150, results=400)
COMPOSITE_QUICK = dict(num_pix=48, map_n=64, map_steps=120, vi_n=32, vi_steps=120,
                       hmc_n=8, burnin=40, results=80)
# the recoveries the demo prints: (name, group, profile index, parameter)
COMPOSITE_RECOVERIES = (("stellar sigma0", "lens_mass", 0, "sigma0"),
                        ("halo alpha_Rs", "lens_mass", 1, "alpha_Rs"),
                        ("multipole a_m", "lens_mass", 2, "a_m"))


def composite_prior():
    """The demo's prior (:52-100)."""
    ln = math.log
    return Prior(dict(
        lens_mass=[
            dict(sigma0=d.LogNormal(ln(0.6), 0.3), Rs=d.LogNormal(ln(0.8), 0.2),
                 center_x=d.Normal(0, 0.05), center_y=d.Normal(0, 0.05)),
            dict(Rs=d.LogNormal(ln(3.0), 0.2), alpha_Rs=d.LogNormal(ln(0.8), 0.3),
                 e1=d.Normal(0, 0.1), e2=d.Normal(0, 0.1), center_x=d.Normal(0, 0.05),
                 center_y=d.Normal(0, 0.05)),
            dict(a_m=d.Normal(0, 0.02), phi_m=d.Normal(0, 0.5), center_x=d.Normal(0, 0.05),
                 center_y=d.Normal(0, 0.05)),
            dict(gamma1=d.Normal(0, 0.05), gamma2=d.Normal(0, 0.05)),
        ],
        lens_light=[dict(R_sersic=d.LogNormal(ln(0.8), 0.15), n_sersic=d.Uniform(2, 6),
                         e1=d.TruncatedNormal(0, 0.1, -0.3, 0.3),
                         e2=d.TruncatedNormal(0, 0.1, -0.3, 0.3),
                         center_x=d.Normal(0, 0.05), center_y=d.Normal(0, 0.05),
                         Ie=d.LogNormal(ln(400.0), 0.3))],
        source_light=[dict(R_sersic=d.LogNormal(ln(0.25), 0.15), n_sersic=d.Uniform(0.5, 4),
                           e1=d.TruncatedNormal(0, 0.15, -0.5, 0.5),
                           e2=d.TruncatedNormal(0, 0.15, -0.5, 0.5),
                           center_x=d.Normal(0, 0.2), center_y=d.Normal(0, 0.2),
                           Ie=d.LogNormal(ln(150.0), 0.5))],
    ))


def composite_psf():
    """The demo's 13-px Gaussian PSF (:109)."""
    return _gaussian_psf(13, 6.0)


def composite_scene(num_pix=COMPOSITE_DEPTHS["num_pix"], device=None):
    """The composite scene: the demo's model, prior and camera
    (``num_pix`` px at 0.08", supersample 2, :func:`composite_psf`), the
    truth :data:`COMPOSITE_TRUTH` rendered by the port, numpy's noise
    seeded 0 at bkg 0.2 / exp_time 100. Returns a namespace ``phys``,
    ``prior``, ``cfg``, ``prob``, ``truth``, ``obs`` (numpy)."""
    device = resolve_device(device)
    phys = PhysicalModel([Hernquist(), NFW_ELLIPSE(), Multipole(m=4), Shear()],
                         [SersicEllipse()], [SersicEllipse()])
    cfg = SimulatorConfig(delta_pix=COMPOSITE_DELTA, num_pix=num_pix, supersample=2,
                          kernel=composite_psf())
    prior = composite_prior()
    truth = _as_tree(COMPOSITE_TRUTH, device)
    obs = _observe(_render(phys, cfg, truth, device), np.random.default_rng(0),
                   COMPOSITE_BKG, COMPOSITE_EXP_TIME)
    prob = ForwardProbModel(prior, obs, background_rms=COMPOSITE_BKG,
                            exp_time=COMPOSITE_EXP_TIME, device=device)
    return types.SimpleNamespace(phys=phys, prior=prior, cfg=cfg, prob=prob, truth=truth,
                                 obs=obs)


@dataclasses.dataclass
class CompositeResult(_Result):
    map_s: float
    map_red_chi2: float  # the best MAP start's
    svi_s: float
    elbo_first: float
    elbo_last: float
    hmc_s: float
    leapfrogs: int
    accept: float  # the last 50 steps' mean
    min_ess: float
    max_rhat: float
    recoveries: dict  # name -> (truth, posterior mean, posterior std)
    posterior_red_chi2: float  # the mean over the chains' last draws
    samples_finite: bool
    states: dict = dataclasses.field(default_factory=dict, repr=False)

    def gates(self):
        g = dict(samples_finite=self.samples_finite,
                 accept=ACCEPT[0] < self.accept < ACCEPT[1],
                 posterior_red_chi2=POST_CHI2[0] <= self.posterior_red_chi2 <= POST_CHI2[1],
                 map_red_chi2=self.map_red_chi2 <= CHI2_GATE)
        for name, (true, mean, std) in self.recoveries.items():
            g[name] = abs(mean - true) <= RECOVERY_STD * std
        return g


def run_composite(device=None, hook=None, **depths):
    """The demo end to end at ``depths`` (keys of :data:`COMPOSITE_DEPTHS`,
    which it defaults to): MAP from prior draws under the demo's schedule
    (seed 0), FD Laplace at the best start, SVI (seed 1), ChEES HMC (seed
    2), then the demo's recoveries and the posterior red-chi2. ``hook(name)``
    returns a context manager entered around the ``map``, ``svi`` and
    ``hmc`` phases. ``states`` holds the sequence, the MAP's final z and
    the surrogate."""
    device = resolve_device(device)
    p = dict(COMPOSITE_DEPTHS, **depths)
    hook = _hook(hook)
    sc = composite_scene(p["num_pix"], device)
    prior, prob = sc.prior, sc.prob
    seq = ModellingSequence(sc.phys, prob, sc.cfg, device=device)

    with hook("map"):
        t0 = time.perf_counter()
        z_map = seq.MAP(map_optimizer(p["map_steps"]), n_samples=p["map_n"],
                        num_steps=p["map_steps"], seed=0)
        _sync(device)
        map_s = time.perf_counter() - t0
    best = seq.best_map_start(z_map)
    with torch.no_grad():
        map_chi2 = _nanmin(prob.log_prob(seq._sim(z_map.shape[0]), z_map)[1])
    log(f"MAP {map_s:.1f}s best red-chi2 {map_chi2:.3f}")

    with hook("svi"):
        t0 = time.perf_counter()
        L0 = seq.laplace_scale_tril(best)
        q_z, losses = seq.SVI(best, svi_optimizer(p["vi_steps"]), n_vi=p["vi_n"],
                              num_steps=p["vi_steps"], init_scales=L0, seed=1)
        _sync(device)
        svi_s = time.perf_counter() - t0
    log(f"SVI {svi_s:.1f}s elbo {float(losses[0]):.1f} -> {float(losses[-1]):.1f}")

    with hook("hmc"):
        t0 = time.perf_counter()
        res = seq.HMC(q_z, n_hmc=p["hmc_n"], num_burnin_steps=p["burnin"],
                      num_results=p["results"], seed=2)
        _sync(device)
        hmc_s = time.perf_counter() - t0
    ess = effective_sample_size(res.samples)
    rhat = potential_scale_reduction(res.samples)
    accept = float(res.accept_rate[-50:].mean())
    log(f"HMC {hmc_s:.1f}s accept {accept:.2f} min ESS {ess.min():.0f} "
        f"max rhat {rhat.max():.3f}")

    post = prior.constrain(res.samples.reshape(-1, prior.d))
    recoveries = {}
    for name, group, i, key in COMPOSITE_RECOVERIES:
        node = post[group][i][key]
        true = COMPOSITE_TRUTH[group][i][key]
        recoveries[name] = (true, float(node.mean()), float(node.std(correction=0)))
        log(f"{name}: true {true:.4f}  posterior {recoveries[name][1]:.4f} +- "
            f"{recoveries[name][2]:.4f}")
    with torch.no_grad():
        chi2_post = float(prob.log_prob(seq._sim(res.samples.shape[1]), res.samples[-1])[1].mean())
    log(f"posterior mean red-chi2 {chi2_post:.4f}")
    return CompositeResult(
        map_s=map_s, map_red_chi2=map_chi2, svi_s=svi_s, elbo_first=float(losses[0]),
        elbo_last=float(losses[-1]), hmc_s=hmc_s, leapfrogs=int(res.total_leapfrogs),
        accept=accept, min_ess=float(ess.min()), max_rhat=float(rhat.max()),
        recoveries=recoveries, posterior_red_chi2=chi2_post,
        samples_finite=bool(torch.isfinite(res.samples).all()),
        states=dict(seq=seq, z_map=z_map, q_z=q_z))


# --------------------------------------------------------------------------
# model comparison: examples/demo_model_comparison.py
# --------------------------------------------------------------------------

# prior_epl.sample(jax.random.PRNGKey(3), 1) with gamma set to 2.4 (:101-102)
COMPARISON_TRUTH = dict(
    lens_mass=[dict(theta_E=1.1462210416793823, gamma=2.4, e1=-0.05877813696861267,
                    e2=-0.06020292267203331, center_x=-0.11891698837280273,
                    center_y=-0.09716107696294785),
               dict(gamma1=-0.044164787977933884, gamma2=-0.007936270907521248)],
    source_light=[dict(R_sersic=0.22321957349777222, n_sersic=1.3586740493774414,
                       e1=0.011214124038815498, e2=-0.15788671374320984,
                       center_x=-0.2275610715150833, center_y=-0.39936625957489014,
                       Ie=333.3538818359375)])
COMPARISON_PIX, COMPARISON_DELTA, COMPARISON_BKG, COMPARISON_EXP_TIME = 32, 0.065, 0.2, 100.0
# the demo's SMC (:119-123) and --particles / --ensembles defaults
COMPARISON_SMC = dict(particles=256, ensembles=2, leapfrog_steps=5, max_stage=80)
COMPARISON_QUICK = dict(particles=64, ensembles=2, leapfrog_steps=5, max_stage=80)


def comparison_priors():
    """(EPL prior, SIE prior) of the demo (:65-95)."""
    ln = math.log

    def common():
        return dict(theta_E=d.LogNormal(ln(1.25), 0.25), e1=d.Normal(0, 0.1),
                    e2=d.Normal(0, 0.1), center_x=d.Normal(0, 0.05), center_y=d.Normal(0, 0.05))

    def shear():
        return dict(gamma1=d.Normal(0, 0.05), gamma2=d.Normal(0, 0.05))

    def source():
        return dict(R_sersic=d.LogNormal(ln(0.25), 0.15), n_sersic=d.Uniform(0.5, 4),
                    e1=d.TruncatedNormal(0, 0.15, -0.5, 0.5),
                    e2=d.TruncatedNormal(0, 0.15, -0.5, 0.5),
                    center_x=d.Normal(0, 0.25), center_y=d.Normal(0, 0.25),
                    Ie=d.LogNormal(ln(150.0), 0.5))

    epl = Prior(dict(lens_mass=[dict(gamma=d.TruncatedNormal(2, 0.25, 1, 3), **common()),
                                shear()],
                     source_light=[source()]))
    sie = Prior(dict(lens_mass=[common(), shear()], source_light=[source()]))
    return epl, sie


def comparison_scene(device=None):
    """The comparison scene: the two arms' models and priors, the camera
    (32 px at 0.065", supersample 1, no PSF), the truth
    :data:`COMPARISON_TRUTH` rendered by the EPL model, numpy's noise seeded
    2 at bkg 0.2 / exp_time 100. Returns a namespace ``arms`` (name ->
    (phys, prior)), ``cfg``, ``truth``, ``obs`` (numpy)."""
    device = resolve_device(device)
    prior_epl, prior_sie = comparison_priors()
    phys_epl = PhysicalModel([EPL(EPL.recommended_niter(0.43, 1e-8)), Shear()], [],
                             [SersicEllipse()])
    phys_sie = PhysicalModel([SIE(), Shear()], [], [SersicEllipse()])
    cfg = SimulatorConfig(delta_pix=COMPARISON_DELTA, num_pix=COMPARISON_PIX, supersample=1)
    truth = _as_tree(COMPARISON_TRUTH, device)
    obs = _observe(_render(phys_epl, cfg, truth, device), np.random.default_rng(2),
                   COMPARISON_BKG, COMPARISON_EXP_TIME)
    return types.SimpleNamespace(arms=dict(EPL=(phys_epl, prior_epl), SIE=(phys_sie, prior_sie)),
                                 cfg=cfg, truth=truth, obs=obs)


@dataclasses.dataclass
class ComparisonResult(_Result):
    arms: dict  # name -> dict(stages, final_beta, log_z, seconds)
    log_bf: float  # EPL against SIE, the ensembles' means
    spread: float  # the largest per-arm ensemble spread
    verdict: str
    states: dict = dataclasses.field(default_factory=dict, repr=False)

    def gates(self):
        g = {}
        for name, a in self.arms.items():
            g[f"{name}_beta"] = all(b == 1.0 for b in a["final_beta"])
            g[f"{name}_log_z"] = (len(a["log_z"]) == a["ensembles"]
                                  and all(math.isfinite(v) for v in a["log_z"]))
        g["decisive"] = self.log_bf > max(BF_MIN, self.spread)
        return g


def run_comparison(device=None, hook=None, **smc):
    """The demo end to end: SMC from the prior for each arm (keys of
    :data:`COMPARISON_SMC`, which it defaults to; 0 post steps, pixels
    target, seed 0), then the log Bayes factor and the demo's verdict.
    ``hook(name)`` is entered around each arm's SMC (``EPL``, ``SIE``).
    ``states`` holds each arm's (sequence, SMCResult)."""
    device = resolve_device(device)
    p = dict(COMPARISON_SMC, **smc)
    hook = _hook(hook)
    sc = comparison_scene(device)
    log(f"truth: EPL gamma=2.4, {COMPARISON_PIX}x{COMPARISON_PIX} observation")
    arms, states = {}, {}
    for name, (phys, prior) in sc.arms.items():
        prob = ForwardProbModel(prior, sc.obs, background_rms=COMPARISON_BKG,
                                exp_time=COMPARISON_EXP_TIME, device=device)
        seq = ModellingSequence(phys, prob, sc.cfg, device=device)
        with hook(name):
            t0 = time.perf_counter()
            res = seq.SMC(start=None, num_particles=p["particles"],
                          num_ensembles=p["ensembles"], num_leapfrog_steps=p["leapfrog_steps"],
                          post_sampling_steps=0, max_stage=p["max_stage"], target="pixels",
                          auxiliar="none", seed=0)
            _sync(device)
            secs = time.perf_counter() - t0
        arms[name] = dict(stages=int(res.num_stages), ensembles=p["ensembles"],
                          final_beta=[float(b) for b in res.final_beta],
                          log_z=[float(v) for v in res.log_evidence], moves=int(res.num_moves),
                          seconds=secs)
        states[name] = (seq, res)
        log(f"{name}: stages={arms[name]['stages']} final_beta={arms[name]['final_beta']} "
            f"logZ={[round(v, 2) for v in arms[name]['log_z']]} ({secs:.0f}s)")
    log_z = {k: np.asarray(a["log_z"]) for k, a in arms.items()}
    bf = float(log_z["EPL"].mean() - log_z["SIE"].mean())
    spread = float(max(np.ptp(log_z["EPL"]), np.ptp(log_z["SIE"])))
    verdict = ("decisively EPL" if bf > max(BF_MIN, spread) else
               "inconclusive" if abs(bf) <= max(BF_MIN, spread) else "SIE (unexpected)")
    log(f"log Bayes factor EPL vs SIE: {bf:+.1f} nats (ensemble spread up to {spread:.1f} nats)")
    log(f"verdict: {verdict}")
    return ComparisonResult(arms=arms, log_bf=bf, spread=spread, verdict=verdict,
                            states=states)


# --------------------------------------------------------------------------
# multi-plane: docs/multiplane.md in tests/test_multiplane.py's configuration
# --------------------------------------------------------------------------

# prior.sample(jax.random.PRNGKey(1), 1) of tests/test_multiplane.py's
# prior (:199)
MULTIPLANE_TRUTH = dict(
    lens_mass=[dict(theta_E=0.8367511630058289, e1=0.014535349793732166,
                    e2=-0.10126554220914841, center_x=0.02659686841070652,
                    center_y=-0.012196001596748829),
               dict(gamma1=-0.08414702862501144, gamma2=0.040813837200403214),
               dict(theta_E=0.3161327838897705, center_x=0.43987974524497986,
                    center_y=-0.27357491850852966)],
    source_light=[dict(R_sersic=0.22667568922042847, n_sersic=1.4213995933532715,
                       e1=0.1912059783935547, e2=0.018342899158596992,
                       center_x=0.1390339732170105, center_y=0.06256124377250671,
                       Ie=8.881957054138184)])
MULTIPLANE_PIX, MULTIPLANE_DELTA, MULTIPLANE_BKG, MULTIPLANE_EXP_TIME = 24, 0.08, 0.05, 1e3
MULTIPLANE_REDSHIFTS, MULTIPLANE_Z_SOURCE = (0.4, 0.4, 0.9), 2.0
MULTIPLANE_MAP = dict(map_n=128, map_steps=300)
MULTIPLANE_QUICK = dict(map_n=32, map_steps=100)


def multiplane_prior():
    """tests/test_multiplane.py's prior (:174-197)."""
    ln = math.log
    return Prior(dict(
        lens_mass=[dict(theta_E=d.LogNormal(ln(0.8), 0.1), e1=d.Normal(0, 0.1),
                        e2=d.Normal(0, 0.1), center_x=d.Normal(0, 0.05),
                        center_y=d.Normal(0, 0.05)),
                   dict(gamma1=d.Normal(0, 0.05), gamma2=d.Normal(0, 0.05)),
                   dict(theta_E=d.LogNormal(ln(0.3), 0.2), center_x=d.Normal(0.4, 0.05),
                        center_y=d.Normal(-0.3, 0.05))],
        source_light=[dict(R_sersic=d.LogNormal(ln(0.2), 0.2), n_sersic=d.Uniform(1, 3),
                           e1=d.TruncatedNormal(0, 0.1, -0.3, 0.3),
                           e2=d.TruncatedNormal(0, 0.1, -0.3, 0.3),
                           center_x=d.Normal(0, 0.1), center_y=d.Normal(0, 0.1),
                           Ie=d.LogNormal(ln(5.0), 0.3))],
    ))


def multiplane_scene(device=None):
    """The multi-plane scene: [SIE, Shear, SIS] at z (0.4, 0.4, 0.9), z_s
    2.0, a SersicEllipse source; 24 px at 0.08", supersample 2, the 5-px
    Gaussian PSF; the truth :data:`MULTIPLANE_TRUTH` rendered by the port
    plus numpy's N(0, 0.05) seeded 0; the likelihood at bkg 0.05 / exp_time
    1e3. Returns a namespace ``phys``, ``prior``, ``cfg``, ``prob``,
    ``truth``, ``obs``."""
    device = resolve_device(device)
    phys = PhysicalModel([SIE(), Shear(), SIS()], [], [SersicEllipse()],
                         lens_redshifts=list(MULTIPLANE_REDSHIFTS),
                         z_source=MULTIPLANE_Z_SOURCE)
    cfg = SimulatorConfig(delta_pix=MULTIPLANE_DELTA, num_pix=MULTIPLANE_PIX, supersample=2,
                          kernel=_gaussian_psf(5, 2.0))
    prior = multiplane_prior()
    truth = _as_tree(MULTIPLANE_TRUTH, device)
    img = _render(phys, cfg, truth, device)
    obs = img + np.random.default_rng(0).normal(size=img.shape).astype(np.float32) * 0.05
    prob = ForwardProbModel(prior, obs, background_rms=MULTIPLANE_BKG,
                            exp_time=MULTIPLANE_EXP_TIME, device=device)
    return types.SimpleNamespace(phys=phys, prior=prior, cfg=cfg, prob=prob, truth=truth,
                                 obs=obs)


def fd_jacobian_check(sim, x, y, lens_params):
    """The composed Jacobian ``sim.hessian`` at (x, y) against central
    differences of ``sim.beta`` (tests/test_multiplane.py:138-151).
    Returns (the largest |hessian - fd| - (atol + rtol |fd|) over the four
    entries, <= 0 where they agree; the magnifications)."""
    with torch.no_grad():
        f = sim.hessian(x, y, lens_params)
        bpx, bpy = sim.beta(x + FD_EPS, y, lens_params)
        bmx, bmy = sim.beta(x - FD_EPS, y, lens_params)
        bqx, bqy = sim.beta(x, y + FD_EPS, lens_params)
        bnx, bny = sim.beta(x, y - FD_EPS, lens_params)
        fd = (1.0 - (bpx - bmx) / (2 * FD_EPS), -(bqx - bnx) / (2 * FD_EPS),
              -(bpy - bmy) / (2 * FD_EPS), 1.0 - (bqy - bny) / (2 * FD_EPS))
        worst = max(float(((a - b).abs() - (FD_ATOL + FD_RTOL * b.abs())).max())
                    for a, b in zip(f, fd))
        mag = sim.magnification(x, y, lens_params)
    return worst, mag


@dataclasses.dataclass
class MultiplaneResult(_Result):
    map_s: float
    map_red_chi2: float  # the best MAP start's
    images: list  # (x, y) of the true source's images
    magnifications: list  # find_images' (float64 Newton) and the composed Jacobian's
    fd_worst: float  # fd_jacobian_check's margin, <= 0 where it holds
    states: dict = dataclasses.field(default_factory=dict, repr=False)

    def gates(self):
        return dict(map_red_chi2=self.map_red_chi2 <= CHI2_GATE,
                    images=len(self.images) >= 1,
                    magnification_fd=self.fd_worst <= 0.0)


def run_multiplane(device=None, hook=None, **depths):
    """MAP from ``map_n`` prior draws (seed 0) for ``map_steps`` under the
    MAP schedule (keys of :data:`MULTIPLANE_MAP`, its default), gated on
    the best red-chi2; then ``find_images`` of the true source and the
    composed-Jacobian magnification at each image against central
    differences. ``hook("map")`` is entered around the MAP. ``states``
    holds the MAP's final z."""
    device = resolve_device(device)
    p = dict(MULTIPLANE_MAP, **depths)
    hook = _hook(hook)
    sc = multiplane_scene(device)
    seq = ModellingSequence(sc.phys, sc.prob, sc.cfg, device=device)
    with hook("map"):
        t0 = time.perf_counter()
        z_map = seq.MAP(map_optimizer(p["map_steps"]), n_samples=p["map_n"],
                        num_steps=p["map_steps"], seed=0)
        _sync(device)
        map_s = time.perf_counter() - t0
    with torch.no_grad():
        chi2 = _nanmin(sc.prob.log_prob(seq._sim(z_map.shape[0]), z_map)[1])
    log(f"multi-plane MAP {p['map_n']} x {p['map_steps']}: {map_s:.1f}s best red-chi2 {chi2:.3f}")

    sim = LensSimulator(sc.phys, sc.cfg, bs=1, device=device)
    src = MULTIPLANE_TRUTH["source_light"][0]
    ix, iy, mu = find_images(sim, sc.truth["lens_mass"], src["center_x"], src["center_y"])
    x = torch.as_tensor(ix, device=device)
    y = torch.as_tensor(iy, device=device)
    worst, mag = fd_jacobian_check(sim, x, y, sc.truth["lens_mass"])
    mag = mag.reshape(-1).cpu().tolist()
    log(f"multi-plane images {np.round(ix, 4).tolist()}, {np.round(iy, 4).tolist()}; "
        f"magnifications {np.round(mu, 3).tolist()} (Newton), {np.round(mag, 3).tolist()} "
        f"(composed Jacobian); against central differences: margin {worst:.3e}")
    return MultiplaneResult(map_s=map_s, map_red_chi2=chi2,
                            images=[(float(a), float(b)) for a, b in zip(ix, iy)],
                            magnifications=[[float(a), float(b)] for a, b in zip(mu, mag)],
                            fd_worst=worst, states=dict(z_map=z_map))


# --------------------------------------------------------------------------
# time-delay cosmography: examples/demo_timedelay.py
# --------------------------------------------------------------------------

TD_Z_LENS, TD_Z_SOURCE, TD_H0, TD_OM0 = 0.5, 2.0, 70.0, 0.3
TD_TRUTH = [dict(theta_E=1.2, e1=0.12, e2=-0.06, center_x=0.0, center_y=0.0),
            dict(gamma1=0.04, gamma2=0.02)]
TD_SOURCE = (0.07, -0.05)
TD_POS_ERR, TD_DELAY_ERR, TD_FLUX_FRAC = 0.004, 0.8, 0.05
# the demo's fit (:124-131) and its --quick sizes
TD_DEPTHS = dict(n_map=200, map_steps=250, n_vi=64, vi_steps=100, n_hmc=32, burnin=500,
                 results=750)
TD_QUICK = dict(n_map=64, map_steps=100, n_vi=64, vi_steps=100, n_hmc=16, burnin=300,
                results=300)


def timedelay_distance(z_lens=TD_Z_LENS, z_source=TD_Z_SOURCE, h0=TD_H0, om0=TD_OM0):
    """(1 + z_l) D_l D_s / D_ls in Mpc."""
    cosmo = FlatLambdaCDM(H0=h0, Om0=om0)
    dl = cosmo.angular_diameter_distance(z_lens)
    ds = cosmo.angular_diameter_distance(z_source)
    dls = cosmo.angular_diameter_distance(z_lens, z_source)
    return (1.0 + z_lens) * dl * ds / dls


def timedelay_prior():
    """The demo's prior (:91-103): D_dt, and the lens at imaging-informed
    tightness."""
    ln = math.log
    return Prior(dict(
        cosmo=[dict(D_dt=d.LogNormal(ln(3500.0), 0.5))],
        lens_mass=[dict(theta_E=d.LogNormal(ln(1.2), 0.05), e1=d.Normal(0.12, 0.02),
                        e2=d.Normal(-0.06, 0.02), center_x=d.Normal(0, 0.01),
                        center_y=d.Normal(0, 0.01)),
                   dict(gamma1=d.Normal(0.04, 0.01), gamma2=d.Normal(0.02, 0.01))],
    ))


def timedelay_scene(seed=0, device=None):
    """The time-delay scene: the quad of :data:`TD_TRUTH` (60 px at 0.06"),
    its first four images by ``find_images`` from :data:`TD_SOURCE`, the
    true delays against image A at the true D_dt, then the demo's noisy
    positions, delays and fluxes (numpy seeded ``seed``) in a
    ForwardProbModel with no pixels. Returns a namespace ``phys``, ``cfg``,
    ``prior``, ``prob``, ``truth``, ``d_dt``, ``images`` ((x, y, mu)
    numpy), ``delays`` (true), ``data`` (the noisy observables)."""
    device = resolve_device(device)
    d_dt = timedelay_distance()
    phys = PhysicalModel([SIE(), Shear()], [], [])
    cfg = SimulatorConfig(delta_pix=0.06, num_pix=60)
    sim = LensSimulator(phys, cfg, bs=1, device=device)
    truth = _as_tree(TD_TRUTH, device)
    ix, iy, mag = find_images(sim, truth, *TD_SOURCE)
    ix, iy, mag = ix[:4], iy[:4], mag[:4]
    x, y = torch.as_tensor(ix, device=device), torch.as_tensor(iy, device=device)
    with torch.no_grad():
        bx, by = sim.beta(x, y, truth)
        tau = sim.fermat_potential(x, y, truth, bx.mean(-1, keepdim=True),
                                   by.mean(-1, keepdim=True)).reshape(-1).cpu().numpy()
    delays = _TD_DAYS * d_dt * (tau[1:] - tau[0])

    rng = np.random.default_rng(seed)
    obs_x = ix + rng.normal(0, TD_POS_ERR, ix.shape).astype(np.float32)
    obs_y = iy + rng.normal(0, TD_POS_ERR, iy.shape).astype(np.float32)
    obs_dt = delays + rng.normal(0, TD_DELAY_ERR, delays.shape)
    fluxes = 3.0 * np.abs(mag)
    obs_f = fluxes * (1 + TD_FLUX_FRAC * rng.normal(0, 1, fluxes.shape))
    n = len(ix)
    prior = timedelay_prior()
    prob = ForwardProbModel(
        prior, centroids_x=[obs_x], centroids_y=[obs_y],
        centroids_errors_x=[np.full(n, TD_POS_ERR, np.float32)],
        centroids_errors_y=[np.full(n, TD_POS_ERR, np.float32)],
        delays=obs_dt.astype(np.float32),
        delay_errors=np.full(n - 1, TD_DELAY_ERR, np.float32),
        image_fluxes=obs_f.astype(np.float32),
        image_flux_errors=(TD_FLUX_FRAC * fluxes).astype(np.float32), device=device)
    return types.SimpleNamespace(
        phys=phys, cfg=cfg, prior=prior, prob=prob, truth=truth, d_dt=d_dt,
        images=(ix, iy, mag), delays=delays,
        data=dict(x=obs_x, y=obs_y, delays=obs_dt, fluxes=obs_f))


@dataclasses.dataclass
class TimeDelayResult(_Result):
    d_dt_true: float
    images: int
    delays_true: list
    d_dt: dict  # D_dt's summary row: mean, std, rhat, ...
    h0: float
    h0_err: float
    theta_E: dict
    e1: dict
    times: dict  # map, svi, hmc
    leapfrogs: int  # HMC's
    max_rhat: float
    samples_finite: bool

    def gates(self):
        return dict(images=self.images == 4, samples_finite=self.samples_finite,
                    d_dt=abs(self.d_dt["mean"] - self.d_dt_true) <= D_DT_STD * self.d_dt["std"],
                    d_dt_rhat=self.d_dt["rhat"] <= TD_RHAT_GATE)


def run_timedelay(device=None, hook=None, seed=0, **depths):
    """The demo end to end: :func:`timedelay_scene` then
    ``ModellingSequence.fit`` at ``depths`` (keys of :data:`TD_DEPTHS`,
    its default) with ``seed``; D_dt's posterior and H0 = 70 D_dt(true) /
    D_dt(mean). ``hook("fit")`` is entered around the fit."""
    device = resolve_device(device)
    p = dict(TD_DEPTHS, **depths)
    hook = _hook(hook)
    sc = timedelay_scene(seed, device)
    d_dt = sc.d_dt
    log(f"true D_dt = {d_dt:.0f} Mpc  (H0 = {TD_H0:.0f})")
    log(f"quad image positions: {np.round(sc.images[0], 3)}, {np.round(sc.images[1], 3)}")
    log(f"true delays vs image A: {np.round(sc.delays, 2)} days")
    seq = ModellingSequence(sc.phys, sc.prob, sc.cfg, device=device)
    t0 = time.perf_counter()
    with hook("fit"):
        out = seq.fit(n_samples=p["n_map"], map_steps=p["map_steps"], n_vi=p["n_vi"],
                      vi_steps=p["vi_steps"], n_hmc=p["n_hmc"], num_burnin_steps=p["burnin"],
                      num_results=p["results"], seed=seed)
    t = out["times"]
    log(f"pipeline: {time.perf_counter() - t0:.1f}s  (map {t['map']:.1f} / svi {t['svi']:.1f}"
        f" / hmc {t['hmc']:.1f})")
    summary = out["summary"]
    row = summary["cosmo/0/D_dt"]
    h0 = TD_H0 * d_dt / row["mean"]
    h0_err = TD_H0 * d_dt * row["std"] / row["mean"] ** 2
    log(f"D_dt posterior: {row['mean']:.0f} +- {row['std']:.0f} Mpc "
        f"(true {d_dt:.0f}; rhat {row['rhat']:.3f})")
    log(f"=> H0 = {h0:.1f} +- {h0_err:.1f} km/s/Mpc (true {TD_H0:.0f}, fixed Om0)")
    for k in ("lens_mass/0/theta_E", "lens_mass/0/e1"):
        log(f"{k}: {summary[k]['mean']:.4f} +- {summary[k]['std']:.4f}")
    res = out["hmc"]
    return TimeDelayResult(
        d_dt_true=d_dt, images=len(sc.images[0]), delays_true=[float(v) for v in sc.delays],
        d_dt=row, h0=h0, h0_err=h0_err, theta_E=summary["lens_mass/0/theta_E"],
        e1=summary["lens_mass/0/e1"], times=t, leapfrogs=int(res.total_leapfrogs),
        max_rhat=summary["_global"]["max_rhat"],
        samples_finite=bool(torch.isfinite(res.samples).all()))


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

DEMOS = dict(composite=(run_composite, COMPOSITE_QUICK), timedelay=(run_timedelay, TD_QUICK),
             comparison=(run_comparison, COMPARISON_QUICK),
             multiplane=(run_multiplane, MULTIPLANE_QUICK))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("demo", choices=sorted(DEMOS))
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--quick", action="store_true",
                    help="the JAX demo's --quick sizes (smaller runs; the gates may not hold)")
    args = ap.parse_args(argv)
    run, quick = DEMOS[args.demo]
    t0 = time.perf_counter()
    res = run(device=args.device, **(quick if args.quick else {}))
    gates = res.gates()
    log(f"gates: {gates}")
    print(json.dumps(dict(demo=args.demo, quick=args.quick, ok=res.ok, gates=gates,
                          seconds=time.perf_counter() - t0, **res.row())), flush=True)
    return 0 if res.ok else 1


if __name__ == "__main__":
    sys.exit(main())
