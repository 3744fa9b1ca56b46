"""Simulator tiers, lstsq_simulate and BackwardProbModel against the JAX
package (CPU).

A 20x20 scene at supersample 2 with a 5x5 Gaussian PSF, BS 4, inputs from
numpy seeds. Tolerances: renders rtol 1e-4 of the max (float32 on both
sides, as tests/test_torch_map.py); the lstsq fit 5e-4 of the max and the
log-likelihood rtol 1e-4 (the float32 normal equations and pseudo-inverse
amplify rounding, the bound of tests/test_fused_builder.py's lstsq check);
its z-gradient 1e-3 of the max, through the pseudo-inverse on both sides.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigalens_tpu import PhysicalModel as JPhysicalModel
from gigalens_tpu import SimulatorConfig as JSimulatorConfig
from gigalens_tpu.model import BackwardProbModel as JBackwardProbModel
from gigalens_tpu.prob import Prior as JPrior
from gigalens_tpu.prob import distributions as gld
from gigalens_tpu.profiles.light.sersic import SersicEllipse as JSersicEllipse
from gigalens_tpu.profiles.light.shapelets import Shapelets as JShapelets
from gigalens_tpu.profiles.mass.epl import EPL as JEPL
from gigalens_tpu.profiles.mass.shear import Shear as JShear
from gigalens_tpu.profiles.mass.sie import SIE as JSIE
from gigalens_tpu.simulator import LensSimulator as JLensSimulator
from gigalens_tpu_torch.inference import ModellingSequence, optim
from gigalens_tpu_torch.interop import (
    phys_model_from_reference, prior_from_reference, sim_config_from_reference, tree_to_torch,
)
from gigalens_tpu_torch.model import BackwardProbModel
from gigalens_tpu_torch.simulator import LensSimulator

BS = 4
RTOL = 1e-4
FIT_TOL = 5e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfg(fused):
    g = np.exp(-((np.arange(5) - 2) ** 2 + (np.arange(5)[:, None] - 2) ** 2) / 2.0)
    return JSimulatorConfig(delta_pix=0.13, num_pix=20, supersample=2,
                            kernel=(g / g.sum()).astype(np.float32), use_fused_render=fused)


LENS = dict(theta_E=gld.LogNormal(jnp.log(1.25), 0.25), e1=gld.Normal(0, 0.1),
            e2=gld.Normal(0, 0.1), center_x=gld.Normal(0, 0.05), center_y=gld.Normal(0, 0.05))
SHEAR = dict(gamma1=gld.Normal(0, 0.05), gamma2=gld.Normal(0, 0.05))
SERSIC = dict(R_sersic=gld.LogNormal(jnp.log(0.5), 0.15), n_sersic=gld.Uniform(1, 4),
              e1=gld.TruncatedNormal(0, 0.1, -0.3, 0.3),
              e2=gld.TruncatedNormal(0, 0.1, -0.3, 0.3),
              center_x=gld.Normal(0, 0.05), center_y=gld.Normal(0, 0.05))
IE = dict(Ie=gld.LogNormal(jnp.log(100.0), 0.3))


def _tier_case(name):
    """(JAX model, JAX prior) of the three repaired dispatch cases."""
    if name == "all_lstsq_sersic_pair":
        return (JPhysicalModel([JEPL(18), JShear()], [JSersicEllipse(use_lstsq=True)],
                               [JSersicEllipse(use_lstsq=True)]),
                JPrior(dict(lens_mass=[dict(LENS, gamma=gld.TruncatedNormal(2, 0.2, 1, 3)),
                                       SHEAR],
                            lens_light=[SERSIC], source_light=[SERSIC])))
    if name == "sie_sersic_pair":
        return (JPhysicalModel([JSIE(), JShear()], [JSersicEllipse()], [JSersicEllipse()]),
                JPrior(dict(lens_mass=[LENS, SHEAR], lens_light=[dict(SERSIC, **IE)],
                            source_light=[dict(SERSIC, **IE)])))
    return (JPhysicalModel([JSIE(), JShear()], [], [JSersicEllipse()]),
            JPrior(dict(lens_mass=[LENS, SHEAR], source_light=[dict(SERSIC, **IE)])))


@pytest.mark.quick
@pytest.mark.parametrize("name", ["all_lstsq_sersic_pair", "sie_sersic_pair", "sie_source_only"])
def test_fused_tier_and_render_match_jax(name):
    """Repairs of the port's dispatch: an all-lstsq Sersic pair goes to the
    builder (not to K1-K3, whose pack needs Ie), and SIE rides K1-K3 as EPL
    at gamma = 2, as in JAX; each renders JAX's image."""
    jphys, jprior = _tier_case(name)
    params = jprior.sample(jax.random.PRNGKey(0), BS)
    jsim = JLensSimulator(jphys, _cfg(True), bs=BS)
    sim = LensSimulator(phys_model_from_reference(jphys), sim_config_from_reference(_cfg(True)),
                        bs=BS, device="cpu")
    assert sim._fused_niter == jsim._fused_niter
    assert (sim._fused_spec is None) == (jsim._fused_spec is None)
    assert sim._use_fused and jsim._use_fused
    tparams = tree_to_torch(_np_tree(params), device="cpu")
    if name == "all_lstsq_sersic_pair":
        assert sim._fused_niter is None and sim._fused_spec.all_lstsq
        want = np.asarray(jsim.lstsq_simulate(params, np.ones((20, 20)), np.ones((20, 20)),
                                              return_stacked=True))
        got = sim.lstsq_simulate(tparams, np.ones((20, 20)), np.ones((20, 20)),
                                 return_stacked=True).numpy()
    else:
        from gigalens_tpu_torch.profiles.mass.epl import EPL

        assert sim._fused_niter == EPL.recommended_niter(q_min=0.43, tol=1e-8)
        want = np.asarray(jsim.simulate(params))
        got = sim.simulate(tparams).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def _lstsq_family():
    jphys = JPhysicalModel([JEPL(18), JShear()], [JSersicEllipse(use_lstsq=True)],
                           [JShapelets(4, use_lstsq=True)])
    jprior = JPrior(dict(
        lens_mass=[dict(LENS, gamma=gld.TruncatedNormal(2, 0.2, 1, 3)), SHEAR],
        lens_light=[SERSIC],
        source_light=[dict(beta=gld.LogNormal(jnp.log(0.3), 0.2),
                           center_x=gld.Normal(0, 0.1), center_y=gld.Normal(0, 0.1))]))
    rng = np.random.default_rng(1)
    z = np.array(jprior.unconstrain(jprior.sample(jax.random.PRNGKey(1), BS)))
    truth = jprior.constrain(jnp.asarray(z[:1]))
    # observed image: the truth's components with seeded amplitudes, plus noise
    stack = np.asarray(JLensSimulator(jphys, _cfg(False), bs=1).lstsq_simulate(
        truth, np.ones((20, 20)), np.ones((20, 20)), return_stacked=True))
    amps = np.concatenate([[300.0], rng.normal(0, 30, 15)])
    obs = (stack[0] @ amps + rng.normal(0, 0.5, (20, 20))).astype(np.float32)
    return jphys, jprior, z, obs


@pytest.mark.parametrize("fused", [False, True])
def test_lstsq_simulate_matches_jax(fused):
    jphys, jprior, z, obs = _lstsq_family()
    err = np.full((20, 20), 0.5, np.float32)
    params = jprior.constrain(jnp.asarray(z))
    jsim = JLensSimulator(jphys, _cfg(fused), bs=BS)
    sim = LensSimulator(phys_model_from_reference(jphys), sim_config_from_reference(_cfg(fused)),
                        bs=BS, device="cpu")
    assert sim.depth == jsim.depth == 16
    assert (sim._fused_spec is not None) and sim._use_fused == fused
    tparams = tree_to_torch(_np_tree(params), device="cpu")
    want = np.asarray(jsim.lstsq_simulate(params, obs, err, return_stacked=True))
    got = sim.lstsq_simulate(tparams, obs, err, return_stacked=True).numpy()
    assert got.shape == (BS, 20, 20, 16)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())
    want = np.asarray(jsim.lstsq_simulate(params, obs, err))
    got = sim.lstsq_simulate(tparams, obs, err).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FIT_TOL * np.abs(want).max())


@pytest.mark.parametrize("fused", [False, True])
def test_backward_log_prob_and_gradient_match_jax(fused):
    jphys, jprior, z, obs = _lstsq_family()
    jprob = JBackwardProbModel(jprior, obs, background_rms=0.5, exp_time=100.0)
    prob = BackwardProbModel(prior_from_reference(jprior), obs, background_rms=0.5,
                             exp_time=100.0, device="cpu")
    np.testing.assert_allclose(prob.err_map.numpy(), np.asarray(jprob.err_map), rtol=2e-7)
    jsim = JLensSimulator(jphys, _cfg(fused), bs=BS)
    sim = LensSimulator(phys_model_from_reference(jphys), sim_config_from_reference(_cfg(fused)),
                        bs=BS, device="cpu")
    lp_j, chi_j = jprob.log_prob(jsim, jnp.asarray(z))
    zt = torch.tensor(z, requires_grad=True)
    lp, chi = prob.log_prob(sim, zt)
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(lp_j), rtol=RTOL)
    np.testing.assert_allclose(chi.detach().numpy(), np.asarray(chi_j), rtol=FIT_TOL)
    # the gradient runs through the pseudo-inverse's derivative on both sides
    g_j = np.asarray(jax.grad(lambda zz: jnp.sum(jprob.log_prob(jsim, zz)[0]))(jnp.asarray(z)))
    (g,) = torch.autograd.grad(lp.sum(), zt)
    assert torch.isfinite(g).all()
    np.testing.assert_allclose(g.numpy(), g_j, rtol=0, atol=1e-3 * np.abs(g_j).max())
    assert prob.event_size(sim) == 400
    with pytest.raises(NotImplementedError):
        prob.stats_positions(sim, {})


def test_backward_map_steps_lower_chi2():
    """Five MAP steps on the lstsq family through ModellingSequence (the
    builder's CPU twins): finite, and min reduced chi2 does not rise."""
    jphys, jprior, z, obs = _lstsq_family()
    prior = prior_from_reference(jprior)
    prob = BackwardProbModel(prior, obs, background_rms=0.5, exp_time=100.0, device="cpu")
    cfg = dataclasses.replace(sim_config_from_reference(_cfg(True)))
    seq = ModellingSequence(phys_model_from_reference(jphys), prob, cfg, device="cpu")
    opt = optim.chain(optim.scale_by_adam(), optim.scale_by_schedule(
        optim.polynomial_schedule(-1e-2, -1e-2 / 3, 0.5, 5)))
    sim = seq._sim(BS)
    # starts away from the truth (z[0] is the truth)
    start = np.array(jprior.unconstrain(jprior.sample(jax.random.PRNGKey(2), BS)))
    with torch.no_grad():
        chi0 = float(prob.log_prob(sim, torch.tensor(start))[1].min())
    zf = seq.MAP(opt, start=start, n_samples=BS, num_steps=5)
    assert zf.shape == (BS, jprior.d) and torch.isfinite(zf).all()
    with torch.no_grad():
        chi1 = float(prob.log_prob(sim, zf)[1].min())
    assert np.isfinite(chi1) and chi1 <= chi0
