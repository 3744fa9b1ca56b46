"""The port's point-source likelihoods against the JAX package (CPU):
``stats_positions`` (with the clamped |det A|), ``stats_time_delays`` with
each source of D_dt (fixed, from redshifts, sampled from a ``cosmo`` group)
and ``stats_fluxes``, values and z-gradients (``torch.autograd`` against
``jax.grad``) for EPL+Shear (the Hessian's gradient is a double backward
through ``_OmegaCS``), SIS+Shear, and a two-plane SIE+SIS model, at rtol
1e-4 (float32 on both sides; gradients of each sample's scale). The JAX
side runs one sample a call (vmapped), since its EPL Hessian sums over a
batch of parameters (ROADMAP F-ref-5, tested here on both sides). Also
``log_prob`` with pixels and positions together, and the device rule of
the new entry points.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigalens_tpu import PhysicalModel as JPhysicalModel
from gigalens_tpu import SimulatorConfig as JSimulatorConfig
from gigalens_tpu.model import ForwardProbModel as JForwardProbModel
from gigalens_tpu.prob import Prior as JPrior
from gigalens_tpu.prob import distributions as jd
from gigalens_tpu.profiles.light.sersic import SersicEllipse as JSersicEllipse
from gigalens_tpu.profiles.mass.epl import EPL as JEPL
from gigalens_tpu.profiles.mass.shear import Shear as JShear
from gigalens_tpu.profiles.mass.sie import SIE as JSIE
from gigalens_tpu.profiles.mass.sie import SIS as JSIS
from gigalens_tpu.simulator import LensSimulator as JLensSimulator
from gigalens_tpu_torch.inference import fit_smc
from gigalens_tpu_torch.interop import (
    phys_model_from_reference, prior_from_reference, sim_config_from_reference,
)
from gigalens_tpu_torch.model import ForwardProbModel
from gigalens_tpu_torch.profiles.mass import EPL
from gigalens_tpu_torch.simulator import LensSimulator

RTOL = 1e-4
IX = np.array([1.05, -0.95, 0.25, -0.35], np.float32)
IY = np.array([0.30, -0.20, 1.10, -1.05], np.float32)
ERR = np.full(4, 0.01, np.float32)
DELAYS = np.array([-5.0, 12.0, 20.0], np.float32)
FLUXES = np.array([4.0, 3.0, 2.0, 1.5], np.float32)


def _lens_prior(kind):
    e = dict(e1=jd.Normal(0, 0.1), e2=jd.Normal(0, 0.1), center_x=jd.Normal(0, 0.05),
             center_y=jd.Normal(0, 0.05))
    shear = dict(gamma1=jd.Normal(0, 0.05), gamma2=jd.Normal(0, 0.05))
    if kind == "epl":
        return [dict(theta_E=jd.LogNormal(np.log(1.1), 0.1),
                     gamma=jd.TruncatedNormal(2, 0.2, 1.5, 2.5), **e), shear]
    if kind == "sis":
        return [dict(theta_E=jd.LogNormal(np.log(1.1), 0.1), center_x=jd.Normal(0, 0.05),
                     center_y=jd.Normal(0, 0.05)), shear]
    return [dict(theta_E=jd.LogNormal(np.log(1.0), 0.1), **e),
            dict(theta_E=jd.LogNormal(np.log(0.4), 0.1), center_x=jd.Normal(0.3, 0.05),
                 center_y=jd.Normal(-0.2, 0.05))]


def _jphys(kind, light=False):
    lenses = {"epl": [JEPL(18), JShear()], "sis": [JSIS(), JShear()],
              "mp": [JSIE(), JSIS()]}[kind]
    ll = [JSersicEllipse()] if light else []
    if kind == "mp":
        return JPhysicalModel(lenses, ll, ll, lens_redshifts=[0.4, 0.9], z_source=2.5)
    return JPhysicalModel(lenses, ll, ll)


def _models(kind, d_dt="fixed", **extra):
    """(jax prob, port prob, jax sim, port sim, jax prior) with positions,
    and delays / fluxes where asked for."""
    tree = dict(lens_mass=_lens_prior(kind))
    kw = dict(centroids_x=[IX], centroids_y=[IY], centroids_errors_x=[ERR],
              centroids_errors_y=[ERR], **extra)
    if "delays" in extra:
        if d_dt == "fixed":
            kw["time_delay_distance"] = 4000.0
        elif d_dt == "redshifts":
            kw.update(z_lens=0.5, z_source=2.0)
        else:
            tree["cosmo"] = [dict(D_dt=jd.LogNormal(np.log(4000.0), 0.3))]
    jprior = JPrior(tree)
    jphys = _jphys(kind)
    jcfg = JSimulatorConfig(delta_pix=0.1, num_pix=8, use_fused_render=False)
    jprob = JForwardProbModel(jprior, **kw)
    prob = ForwardProbModel(prior_from_reference(jprior), device="cpu", **kw)
    sim = LensSimulator(phys_model_from_reference(jphys), sim_config_from_reference(jcfg),
                        bs=5, device="cpu")
    return jprob, prob, JLensSimulator(jphys, jcfg, bs=1), sim, jprior


def _check(jterm, term, jprior, prior, seed=0, bs=5):
    """term(x) -> (log_like (bs,), red_chi2 (bs,)): both values and the
    log-likelihood's z-gradients against JAX's, one sample a JAX call."""
    z = np.asarray(jprior.unconstrain(jprior.sample(jax.random.PRNGKey(seed), bs)))
    zt = torch.tensor(z, requires_grad=True)
    val, chi = term(prior.constrain(zt))
    (grad,) = torch.autograd.grad(val.sum(), zt)

    def one(zz):
        ll, rc = jterm(jprior.constrain(zz[None]))
        return ll[0], rc[0]

    (v, c), g = jax.jit(jax.vmap(jax.value_and_grad(one, has_aux=True)))(jnp.asarray(z))
    np.testing.assert_allclose(val.detach().numpy(), np.asarray(v), rtol=RTOL, atol=1e-3)
    np.testing.assert_allclose(chi.detach().numpy(), np.asarray(c), rtol=RTOL, atol=1e-6)
    scale = np.abs(np.asarray(g)).max(1, keepdims=True) + 1e-6
    np.testing.assert_allclose(grad.numpy() / scale, np.asarray(g) / scale, rtol=RTOL,
                               atol=RTOL)
    assert np.isfinite(np.asarray(g)).all() and np.abs(np.asarray(g)).max() > 0


@pytest.mark.quick
@pytest.mark.parametrize("kind", ["epl", "sis", "mp"])
def test_positions_and_fluxes_match_jax(kind):
    """stats_positions and stats_fluxes: values, reduced chi2 and
    z-gradients."""
    jprob, prob, jsim, sim, jprior = _models(
        kind, image_fluxes=FLUXES, image_flux_errors=0.1 * FLUXES)
    assert prob.n_position == jprob.n_position == 8
    assert prob.event_size(sim) == jprob.event_size(jsim) == 12
    for name in ("stats_positions", "stats_fluxes"):
        _check(lambda x: getattr(jprob, name)(jsim, x),
               lambda x: getattr(prob, name)(sim, x), jprior, prob.prior)


@pytest.mark.parametrize("d_dt", ["fixed", "redshifts", "sampled"])
@pytest.mark.parametrize("kind", ["epl", "sis"])
def test_time_delays_match_jax(kind, d_dt):
    """stats_time_delays (Fermat potentials at the images, the source at the
    ray-traced barycentre) with each source of D_dt."""
    jprob, prob, jsim, sim, jprior = _models(
        kind, d_dt, delays=DELAYS, delay_errors=np.full(3, 0.5, np.float32))
    if d_dt == "sampled":
        assert prob.time_delay_distance is None and jprob.time_delay_distance is None
    else:
        np.testing.assert_allclose(prob.time_delay_distance, jprob.time_delay_distance,
                                   rtol=1e-12)
    _check(lambda x: jprob.stats_time_delays(jsim, x),
           lambda x: prob.stats_time_delays(sim, x), jprior, prob.prior)


def test_log_prob_pixels_and_positions_match_jax(demo_prior):
    """log_prob and log_like of a model with pixels and positions (red-chi2
    the mean of the two terms), against JAX a sample at a time."""
    jphys = JPhysicalModel([JEPL(18), JShear()], [JSersicEllipse()], [JSersicEllipse()])
    g = np.exp(-((np.arange(5) - 2) ** 2 + (np.arange(5)[:, None] - 2) ** 2) / 2.0)
    jcfg = JSimulatorConfig(delta_pix=0.2, num_pix=12, supersample=1,
                            kernel=(g / g.sum()).astype(np.float32), use_fused_render=False)
    obs = np.random.default_rng(0).normal(0, 0.2, (12, 12)).astype(np.float32)
    kw = dict(background_rms=0.2, exp_time=100.0, centroids_x=[IX], centroids_y=[IY],
              centroids_errors_x=[ERR], centroids_errors_y=[ERR])
    jprob = JForwardProbModel(demo_prior, obs, **kw)
    prob = ForwardProbModel(prior_from_reference(demo_prior), obs, device="cpu", **kw)
    assert prob.include_pixels and prob.include_positions
    jsim = JLensSimulator(jphys, jcfg, bs=1)
    sim = LensSimulator(phys_model_from_reference(jphys), sim_config_from_reference(jcfg),
                        bs=4, device="cpu")
    z = (0.3 * np.random.default_rng(2).standard_normal((4, demo_prior.d))).astype(np.float32)
    with torch.no_grad():
        lp, chi = prob.log_prob(sim, torch.tensor(z))
    lp_j, chi_j = jax.jit(jax.vmap(lambda zz: jprob.log_prob(jsim, zz[None])))(jnp.asarray(z))
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_j).ravel(), rtol=RTOL)
    np.testing.assert_allclose(chi.numpy(), np.asarray(chi_j).ravel(), rtol=RTOL)
    ll = prob.log_like(sim, torch.tensor(z))
    ll_j = jax.jit(jax.vmap(lambda zz: jprob.log_like(jsim, zz[None])))(jnp.asarray(z))
    np.testing.assert_allclose(ll.numpy(), np.asarray(ll_j).ravel(), rtol=RTOL)
    pix = prob.stats_pixels(sim, prob.prior.constrain(torch.tensor(z)))[1]
    pos = prob.stats_positions(sim, prob.prior.constrain(torch.tensor(z)))[1]
    np.testing.assert_allclose(chi.numpy(), ((pix + pos) / 2).numpy(), rtol=1e-6)


def test_epl_hessian_is_per_sample_where_jax_sums_the_batch():
    """F-ref-5: JAX's EPL Hessian (its reverse-mode basis over unbroadcast
    coordinates) returns the SUM over a batch of parameters; the port's
    broadcasts the coordinates first and returns each sample's own, equal
    to JAX's at one sample a call."""
    x = np.array([0.5, -0.7, 0.3], np.float32)
    y = np.array([0.2, 0.9, -1.0], np.float32)
    p = dict(theta_E=[[1.0], [1.3]], gamma=[[2.0], [2.2]], e1=[[0.1], [0.05]],
             e2=[[0.0], [-0.1]], center_x=[[0.0], [0.0]], center_y=[[0.0], [0.0]])
    p = {k: np.asarray(v, np.float32) for k, v in p.items()}
    jhess = jax.jit(lambda q: JEPL(18).hessian(jnp.asarray(x), jnp.asarray(y), **q))
    jbatch = jhess(p)
    jrows = [jhess({k: v[i:i + 1] for k, v in p.items()}) for i in range(2)]
    got = EPL(18).hessian(torch.tensor(x), torch.tensor(y),
                          **{k: torch.tensor(v) for k, v in p.items()})
    for k in range(4):
        assert np.asarray(jbatch[k]).shape == (3,)  # the batch is summed away
        np.testing.assert_allclose(np.asarray(jbatch[k]),
                                   np.asarray(jrows[0][k]) + np.asarray(jrows[1][k]),
                                   rtol=1e-5, atol=1e-6)
        assert got[k].shape == (2, 3)
        for i in range(2):
            np.testing.assert_allclose(got[k][i].detach().numpy(), np.asarray(jrows[i][k]),
                                       rtol=1e-5, atol=1e-6)


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    """ForwardProbModel with point-source data and fit_smc without a
    simulator take device=None as the CUDA card and raise naming
    device="cpu" without one."""
    jprob, prob, jsim, sim, jprior = _models("sis")
    kw = dict(centroids_x=[IX], centroids_y=[IY], centroids_errors_x=[ERR],
              centroids_errors_y=[ERR])
    if torch.cuda.is_available():
        assert ForwardProbModel(prob.prior, **kw).centroids_x[0].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ForwardProbModel(prob.prior, **kw)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        fit_smc(prob, None, num_particles=4, max_stage=0)
    assert ForwardProbModel(prob.prior, device="cpu", **kw).centroids_x[0].device.type == "cpu"
