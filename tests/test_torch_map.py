"""Port simulator, model and MAP phase against the JAX package (CPU).

A small bench-like scene (EPL+Shear, SersicEllipse lens light and source,
20x20 px at supersample 2, a Gaussian PSF): simulate and log_prob at
rtol 1e-4, the optimizer against optax at rtol 1e-6, and 3 MAP steps from a
shared start against 3 JAX ``fit_map`` steps at rtol 1e-3.
"""
import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gigalens_tpu import PhysicalModel as JPhysicalModel
from gigalens_tpu import SimulatorConfig as JSimulatorConfig
from gigalens_tpu.inference.map import fit_map as j_fit_map
from gigalens_tpu.model import ForwardProbModel as JForwardProbModel
from gigalens_tpu.profiles.light.sersic import SersicEllipse as JSersicEllipse
from gigalens_tpu.profiles.mass.epl import EPL as JEPL
from gigalens_tpu.profiles.mass.shear import Shear as JShear
from gigalens_tpu.simulator import LensSimulator as JLensSimulator
from gigalens_tpu_torch import PhysicalModel
from gigalens_tpu_torch.inference import ModellingSequence, best_start, fit_map
from gigalens_tpu_torch.inference import optim
from gigalens_tpu_torch.inference.sequence import phase_simulator
from gigalens_tpu_torch.interop import (
    prior_from_reference, sim_config_from_reference, tree_to_torch,
)
from gigalens_tpu_torch.model import ForwardProbModel
from gigalens_tpu_torch.profiles.light.sersic import SersicEllipse
from gigalens_tpu_torch.profiles.mass.epl import EPL
from gigalens_tpu_torch.profiles.mass.shear import Shear
from gigalens_tpu_torch.simulator import LensSimulator

RTOL = 1e-4  # simulate / log_prob, float32 on both sides
BS = 4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def scene(demo_prior):
    g = np.exp(-((np.arange(5) - 2) ** 2 + (np.arange(5)[:, None] - 2) ** 2) / 2.0)
    psf = (g / g.sum()).astype(np.float32)
    jcfg = JSimulatorConfig(delta_pix=0.13, num_pix=20, supersample=2, kernel=psf,
                            use_fused_render=False)
    jphys = JPhysicalModel([JEPL(18), JShear()], [JSersicEllipse()], [JSersicEllipse()])
    rng = np.random.default_rng(0)
    z_truth = (rng.standard_normal((1, demo_prior.d)) * 0.3).astype(np.float32)
    truth = demo_prior.constrain(jnp.asarray(z_truth))
    truth_img = np.asarray(JLensSimulator(jphys, jcfg, bs=1).simulate(truth))
    bkg, exp_time = 0.2, 100.0
    obs = truth_img + rng.normal(size=truth_img.shape).astype(np.float32) * np.sqrt(
        bkg**2 + np.clip(truth_img, 0, None) / exp_time)
    jprob = JForwardProbModel(demo_prior, obs, background_rms=bkg, exp_time=exp_time)
    tprior = prior_from_reference(demo_prior)
    tprob = ForwardProbModel(tprior, obs, background_rms=bkg, exp_time=exp_time, device="cpu")
    tphys = PhysicalModel([EPL(18), Shear()], [SersicEllipse()], [SersicEllipse()])
    z = (rng.standard_normal((BS, demo_prior.d)) * 0.5).astype(np.float32)
    return dict(jcfg=jcfg, jphys=jphys, jprob=jprob, tprob=tprob, tphys=tphys,
                tcfg=sim_config_from_reference(jcfg), z=z, prior=demo_prior)


@pytest.mark.parametrize("psf_mode", [None, "dft"])
@pytest.mark.parametrize("fused", [False, True])
def test_simulate_matches_jax(scene, psf_mode, fused):
    """Unfused and fused (the kernel's CPU twin) renders, fft and dft PSF."""
    jcfg = dataclasses.replace(scene["jcfg"], psf_mode=psf_mode)
    tcfg = dataclasses.replace(scene["tcfg"], psf_mode=psf_mode, use_fused_render=fused)
    params = scene["prior"].constrain(jnp.asarray(scene["z"]))
    want = np.asarray(JLensSimulator(scene["jphys"], jcfg, bs=BS).simulate(params))
    sim = LensSimulator(scene["tphys"], tcfg, bs=BS, device="cpu")
    assert sim._use_fused == fused
    got = sim.simulate(tree_to_torch(_np_tree(params), device="cpu")).numpy()
    assert got.shape == (BS, 20, 20)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def test_masked_simulate_matches_jax(scene):
    """A pix_region mask: the live pixels are scattered into the image."""
    mask = np.zeros((20, 20), bool)
    mask[3:17, 5:15] = True
    jcfg = dataclasses.replace(scene["jcfg"], pix_region=mask)
    params = scene["prior"].constrain(jnp.asarray(scene["z"]))
    jsim = JLensSimulator(scene["jphys"], jcfg, bs=BS)
    want = np.asarray(jsim.simulate(params))
    sim = LensSimulator(scene["tphys"], sim_config_from_reference(jcfg), bs=BS, device="cpu")
    assert sim.n_live_pix == jsim.n_live_pix == 140
    assert sim.img_x.shape == (560,)
    got = sim.simulate(tree_to_torch(_np_tree(params), device="cpu")).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def test_source_only_fused_matches_unfused(scene):
    """A source-only model rides the fused twin with the zero-Ie dummy lens light."""
    phys = PhysicalModel([EPL(18), Shear()], [], [SersicEllipse()])
    params = tree_to_torch(_np_tree(scene["prior"].constrain(jnp.asarray(scene["z"]))),
                           device="cpu")
    params = {k: v for k, v in params.items() if k != "lens_light"}
    fused = LensSimulator(phys, dataclasses.replace(scene["tcfg"], use_fused_render=True), bs=BS,
                          device="cpu")
    plain = LensSimulator(phys, scene["tcfg"], bs=BS, device="cpu")
    assert fused._use_fused and not plain._use_fused
    want = plain.simulate(params).numpy()
    np.testing.assert_allclose(fused.simulate(params).numpy(), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("fused", [False, True])
def test_log_prob_matches_jax(scene, fused):
    jsim = JLensSimulator(scene["jphys"], scene["jcfg"], bs=BS)
    lp_j, chi_j = scene["jprob"].log_prob(jsim, jnp.asarray(scene["z"]))
    tsim = LensSimulator(scene["tphys"],
                         dataclasses.replace(scene["tcfg"], use_fused_render=fused), bs=BS,
                         device="cpu")
    lp_t, chi_t = scene["tprob"].log_prob(tsim, torch.tensor(scene["z"]))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=RTOL)
    np.testing.assert_allclose(chi_t.numpy(), np.asarray(chi_j), rtol=RTOL)
    assert scene["tprob"].event_size(tsim) == scene["jprob"].event_size(jsim) == 400


def test_optimizer_matches_optax():
    steps = 10
    grads = np.random.default_rng(5).standard_normal((steps, 6, 3)).astype(np.float32)
    jopt = optax.chain(optax.scale_by_adam(), optax.scale_by_schedule(
        optax.polynomial_schedule(-1e-2, -1e-2 / 3, 0.5, steps)))
    topt = optim.chain(optim.scale_by_adam(), optim.scale_by_schedule(
        optim.polynomial_schedule(-1e-2, -1e-2 / 3, 0.5, steps)))
    p0 = np.zeros((6, 3), np.float32)
    js, ts = jopt.init(jnp.asarray(p0)), topt.init(torch.tensor(p0))
    for g in grads:
        ju, js = jopt.update(jnp.asarray(g), js)
        tu, ts = topt.update(torch.tensor(g), ts)
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-6, atol=1e-9)


@pytest.mark.quick
def test_map_steps_match_jax(scene):
    """3 port MAP steps against 3 JAX fit_map steps from the same start."""
    steps = 3

    def sched(lib):
        return lib.chain(lib.scale_by_adam(), lib.scale_by_schedule(
            lib.polynomial_schedule(-1e-2, -1e-2 / 3, 0.5, steps)))

    jsim = JLensSimulator(scene["jphys"], scene["jcfg"], bs=BS)
    zj, hist_j = j_fit_map(scene["jprob"], jsim, sched(optax), start=jnp.asarray(scene["z"]),
                           n_samples=BS, num_steps=steps)
    tsim = LensSimulator(scene["tphys"], scene["tcfg"], bs=BS, device="cpu")
    zt, hist_t = fit_map(scene["tprob"], tsim, sched(optim), start=scene["z"],
                         n_samples=BS, num_steps=steps)
    assert not np.allclose(zt.numpy(), scene["z"])
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(hist_t.numpy(), np.asarray(hist_j), rtol=1e-3)


def test_sequence_map_and_best_start(scene):
    seq = ModellingSequence(scene["tphys"], scene["tprob"], scene["tcfg"], device="cpu")
    opt = optim.chain(optim.scale_by_adam(), optim.scale_by_schedule(
        optim.polynomial_schedule(-1e-2, -1e-2 / 3, 0.5, 2)))
    z = seq.MAP(opt, n_samples=BS, num_steps=2, seed=0)
    assert z.shape == (BS, 22) and torch.isfinite(z).all()
    best = seq.best_map_start(z)
    assert best.shape == (1, 22)
    # a diverged (NaN) start is never selected
    z_nan = z.clone()
    z_nan[0] = float("nan")
    sim = seq._sim(BS)
    assert torch.isfinite(best_start(scene["tprob"], sim, z_nan)).all()
    # Laplace, SVI and HMC are ported; only SMC still raises
    with pytest.raises(NotImplementedError, match="M16"):
        seq.SMC(best)


def test_phase_simulator_memo_and_exact_policy(scene):
    cache = {}
    cfg = dataclasses.replace(scene["tcfg"], psf_mode=None)
    a = phase_simulator(cache, cfg, scene["tphys"], 3, device="cpu")
    assert phase_simulator(cache, cfg, scene["tphys"], 3, device="cpu") is a
    exact = phase_simulator(cache, cfg, scene["tphys"], 3, exact=True, device="cpu")
    assert exact is not a and exact._conv.mode == "fft"
    # rebinding an attribute of the model invalidates the memo
    scene["tphys"].lenses = list(scene["tphys"].lenses)
    assert phase_simulator(cache, cfg, scene["tphys"], 3, device="cpu") is not a


def test_port_never_imports_jax():
    code = (
        "import sys, gigalens_tpu_torch, gigalens_tpu_torch.interop, "
        "gigalens_tpu_torch.inference, gigalens_tpu_torch.simulator, "
        "gigalens_tpu_torch.ops.cuda, gigalens_tpu_torch.profiles.mass, "
        "gigalens_tpu_torch.profiles.light\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'gigalens_tpu'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_unported_inputs_raise(scene):
    """Inputs this slice does not port are refused, not silently mis-handled."""
    lstsq = PhysicalModel([EPL(18), Shear()], [], [SersicEllipse(use_lstsq=True)])
    sim = LensSimulator(lstsq, scene["tcfg"], bs=1, device="cpu")  # single-scene lstsq is ported
    with pytest.raises(NotImplementedError, match="M17"):
        sim.lstsq_simulate({}, np.zeros((2, 20, 20)), np.ones((2, 20, 20)))
    with pytest.raises(NotImplementedError, match="M14"):
        PhysicalModel([EPL(18)], [], [SersicEllipse()], lens_redshifts=[0.5])
    with pytest.raises(NotImplementedError, match="M14"):
        ForwardProbModel(scene["tprob"].prior, np.zeros((20, 20)), centroids_x=[[0.0]],
                         device="cpu")
    with pytest.raises(NotImplementedError, match="direct"):
        LensSimulator(scene["tphys"], dataclasses.replace(scene["tcfg"], use_fft=False), bs=1,
                      device="cpu")
