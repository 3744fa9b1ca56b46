"""The port's adaptive-tempering SMC (``inference/smc.py``) against the JAX
package's (CPU).

* One tempering stage from the same 3-D start with JAX's own draws (rebuilt
  here from ``PRNGKey(seed)`` in the JAX sampler's split order and handed
  to the port through its ``Draws`` interface), on the conjugate Gaussian
  target: particles, beta, log-scalings and log-evidence at rtol 1e-5
  (atol 1e-6), float32 on both sides. Systematic resampling indices are
  compared exactly, on weights built so that no point lies within 1e-5 of
  a CDF edge (the two float32 cumsums may differ by a few ulps).
* The particle parts and their gradients on the render at small size
  against ``jax.value_and_grad`` of the JAX likelihoods (rtol 1e-4).
* The conjugate-Gaussian posterior and evidence statistics of
  ``tests/test_inference.py`` at their tolerances; the callable target;
  ``importance_evidence`` against JAX with the same draws (rtol 1e-5) and
  against the analytic evidence (atol 0.02).
* The BackwardProbModel pixels target, the positions-target error and the
  post chain's shape (``tests/test_round2_fixes.py``); the three start forms.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigalens_tpu.inference.smc import _systematic_resample as j_resample
from gigalens_tpu.inference.smc import fit_smc as j_fit_smc
from gigalens_tpu_torch import PhysicalModel
from gigalens_tpu_torch.config import SimulatorConfig
from gigalens_tpu_torch.inference import ModellingSequence, fit_smc, importance_evidence
from gigalens_tpu_torch.inference.smc import (
    Draws, _eval_particles, _part_fns, _systematic_resample,
)
from gigalens_tpu_torch.interop import prior_from_reference
from gigalens_tpu_torch.model import BackwardProbModel, ForwardProbModel
from gigalens_tpu_torch.prob import Prior
from gigalens_tpu_torch.prob.distributions import MultivariateNormalTriL
from gigalens_tpu_torch.profiles.light import SersicEllipse
from gigalens_tpu_torch.profiles.mass import EPL, Shear
from gigalens_tpu_torch.simulator import LensSimulator
from test_inference import _GaussianTargetModel as JGaussianModel

LOG_Z_TRUE = 3 * (0.5 * np.log(0.25 / 1.25) - 0.5 / 1.25)


class _GaussPrior:
    """N(0, 1) in 3 dims, identity bijector: the port's side of the JAX
    tests' duck-typed prior."""

    d = 3

    def log_prob(self, x):
        return -0.5 * torch.sum(x**2, -1)

    def fldj(self, z):
        return torch.zeros(z.shape[:-1])

    def log_prob_z(self, z):
        return -0.5 * torch.sum(z**2, -1)

    def constrain(self, z):
        return z

    def unconstrain(self, x):
        return x

    def sample(self, generator, shape):
        return torch.randn((*shape, 3), generator=generator, device=generator.device)


class GaussianModel:
    """Conjugate Gaussian: prior N(0, 1), likelihood N(1, 0.5^2) a dim,
    posterior N(0.8, 0.2) a dim (the port's twin of
    ``test_inference._GaussianTargetModel``)."""

    prior = _GaussPrior()

    def stats_pixels(self, sim, x):
        ll = torch.sum(-0.5 * ((x - 1.0) / 0.5) ** 2, -1)
        return ll, ll

    def stats_positions(self, sim, x):
        return torch.zeros(x.shape[0]), torch.zeros(x.shape[0])


class JaxDraws(Draws):
    """JAX's draws in its sampler's split order: ``key, k_init =
    split(PRNGKey(seed))``; a stage splits ``key, k_res, k_move`` and draws
    one uniform a ensemble from ``split(k_res, E)``; a move splits ``k_move,
    k_step`` then ``k_mom, k_acc``; the post chain splits the final key into
    one key a step."""

    def __init__(self, seed, post_steps=0):
        self.key, self.k_init = jax.random.split(jax.random.PRNGKey(seed))
        self.post_steps, self.post_keys = post_steps, None

    def start_indices(self, n_start, shape, replace):
        return torch.tensor(np.asarray(
            jax.random.choice(self.k_init, n_start, shape, replace=replace)))

    def resample_uniforms(self, n_ensembles):
        self.key, k_res, self.k_move = jax.random.split(self.key, 3)
        return torch.tensor(np.asarray(jnp.stack(
            [jax.random.uniform(k, ()) for k in jax.random.split(k_res, n_ensembles)])))

    def _move(self, key, shape):
        k_mom, k_acc = jax.random.split(key)
        return (torch.tensor(np.asarray(jax.random.normal(k_mom, shape))),
                torch.tensor(np.asarray(jax.random.uniform(k_acc, shape[:-1], minval=1e-10))))

    def move(self, shape):
        self.k_move, k_step = jax.random.split(self.k_move)
        return self._move(k_step, shape)

    def post_move(self, shape):
        if self.post_keys is None:
            self.post_keys = list(jax.random.split(self.key, self.post_steps))
        return self._move(self.post_keys.pop(0), shape)


def _close(name, got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(torch.as_tensor(got).numpy(), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=name)


@pytest.mark.quick
@pytest.mark.parametrize("precondition", [True, False])
def test_one_stage_matches_jax(precondition):
    """One tempering stage (resample, 8 preconditioned HMC moves, tuning)
    from the same 3-D start with JAX's draws: particles, beta,
    log-scalings and log-evidence at rtol 1e-5; then the same stage plus a
    3-step post chain."""
    P, E, L, seed = 64, 2, 3, 3
    start = np.random.default_rng(0).standard_normal((P, E, 3)).astype(np.float32)
    kw = dict(start=start, num_particles=P, num_ensembles=E, num_leapfrog_steps=L,
              max_stage=1, target="pixels", auxiliar="none",
              precondition_moves=precondition, seed=seed)
    for post in (0, 3):
        want = j_fit_smc(JGaussianModel(), None, post_sampling_steps=post, **kw)
        got = fit_smc(GaussianModel(), None, post_sampling_steps=post, device="cpu",
                      draws=JaxDraws(seed, post), **kw)
        assert got.num_stages == int(want.num_stages) == 1
        assert got.num_moves == 8
        assert not np.allclose(got.particles.numpy(), start)
        for name in ("particles", "final_beta", "log_scalings", "log_evidence",
                     "post_samples"):
            _close(name, getattr(got, name), getattr(want, name))
        assert 0.0 < float(got.final_beta[0]) < 1.0


def test_systematic_resample_indices_match_jax():
    """Indices exactly equal to JAX's, per ensemble, on skewed weights
    whose CDF edges all sit more than 1e-5 from every resampling point."""
    P, E = 50, 3
    rng = np.random.default_rng(4)
    logw = (3.0 * rng.standard_normal((P, E))).astype(np.float32)
    cdf = np.cumsum(np.exp(logw - logw.max(0)) / np.exp(logw - logw.max(0)).sum(0), 0)
    keys, us = [], []
    for e in range(E):
        for s in range(1000):
            k = jax.random.PRNGKey(100 * e + s)
            u = float(jax.random.uniform(k, ()))
            pts = (np.arange(P) + u) / P
            if np.min(np.abs(pts[:, None] - cdf[None, :, e])) > 1e-5:
                keys.append(k)
                us.append(u)
                break
    assert len(keys) == E
    got = _systematic_resample(torch.tensor(us, dtype=torch.float32), torch.tensor(logw))
    assert got.dtype == torch.int64 and got.shape == (P, E)
    for e in range(E):
        want = np.asarray(j_resample(keys[e], jnp.asarray(logw[:, e]), jnp.arange(P)))
        np.testing.assert_array_equal(got[:, e].numpy(), want)
    # a skewed ensemble really resamples (duplicates and drops)
    assert len(set(got[:, 0].tolist())) < P


def _scene(demo_prior):
    from gigalens_tpu import PhysicalModel as JPhysicalModel
    from gigalens_tpu import SimulatorConfig as JSimulatorConfig
    from gigalens_tpu.model import ForwardProbModel as JForwardProbModel
    from gigalens_tpu.profiles.light.sersic import SersicEllipse as JSersicEllipse
    from gigalens_tpu.profiles.mass.epl import EPL as JEPL
    from gigalens_tpu.profiles.mass.shear import Shear as JShear
    from gigalens_tpu.simulator import LensSimulator as JLensSimulator

    g = np.exp(-((np.arange(5) - 2) ** 2 + (np.arange(5)[:, None] - 2) ** 2) / 2.0)
    psf = (g / g.sum()).astype(np.float32)
    obs = np.random.default_rng(0).normal(0, 0.2, (12, 12)).astype(np.float32)
    cx, cy = [np.array([0.9, -0.8, 0.1], np.float32)], [np.array([0.3, -0.4, 1.0], np.float32)]
    ex = [np.full(3, 0.05, np.float32)]
    jphys = JPhysicalModel([JEPL(18), JShear()], [JSersicEllipse()], [JSersicEllipse()])
    jcfg = JSimulatorConfig(delta_pix=0.2, num_pix=12, supersample=1, kernel=psf,
                            use_fused_render=False)
    jprob = JForwardProbModel(demo_prior, obs, background_rms=0.2, exp_time=100.0,
                              centroids_x=cx, centroids_y=cy, centroids_errors_x=ex,
                              centroids_errors_y=ex)
    phys = PhysicalModel([EPL(18), Shear()], [SersicEllipse()], [SersicEllipse()])
    cfg = SimulatorConfig(delta_pix=0.2, num_pix=12, supersample=1, kernel=psf,
                          use_fused_render=False)
    prob = ForwardProbModel(prior_from_reference(demo_prior), obs, background_rms=0.2,
                            exp_time=100.0, centroids_x=cx, centroids_y=cy,
                            centroids_errors_x=ex, centroids_errors_y=ex, device="cpu")
    return jphys, jcfg, jprob, JLensSimulator, phys, cfg, prob


@pytest.mark.parametrize("target,aux", [("pixels", "positions"), ("pixels+positions", "none")])
def test_eval_particles_parts_and_gradients_match_jax(demo_prior, target, aux):
    """like / aux / prior parts and their z-gradients on a 12x12 render
    (EPL+Shear, one position group) against jax.value_and_grad of the JAX
    terms, one sample at a time (rtol 1e-4 of each column's scale)."""
    jphys, jcfg, jprob, JLensSimulator, phys, cfg, prob = _scene(demo_prior)
    P, E = 3, 2
    z = (0.3 * np.random.default_rng(1).standard_normal((P, E, demo_prior.d))).astype(
        np.float32)
    sim = LensSimulator(phys, cfg, bs=P * E, device="cpu")
    target_fn, aux_fn = _part_fns(prob, sim, target, aux)
    part = _eval_particles(prob.prior, target_fn, aux_fn, torch.tensor(z))
    assert (aux == "none") == (not part.aux.any() and not part.g_aux.any())

    jsim = JLensSimulator(jphys, jcfg, bs=1)
    terms = {"pixels": lambda x: jprob.stats_pixels(jsim, x)[0],
             "positions": lambda x: jprob.stats_positions(jsim, x)[0]}
    terms["pixels+positions"] = lambda x: terms["pixels"](x) + terms["positions"](x)
    terms["none"] = lambda x: jnp.zeros(())
    fns = [lambda zz: jnp.sum(terms[target](demo_prior.constrain(zz))),
           lambda zz: jnp.sum(terms[aux](demo_prior.constrain(zz))),
           lambda zz: jnp.sum(demo_prior.log_prob_z(zz))]
    for k, (val, grad) in enumerate([(part.like, part.g_like), (part.aux, part.g_aux),
                                     (part.lp, part.g_lp)]):
        # one sample a JAX call (vmapped): JAX's EPL Hessian sums over a
        # batch of parameters (ROADMAP F-ref-5)
        v, g = jax.jit(jax.vmap(jax.value_and_grad(lambda zz: fns[k](zz[None]))))(
            jnp.asarray(z.reshape(P * E, -1)))
        _close(f"part {k} value", val.reshape(-1), v, rtol=1e-4, atol=1e-4)
        scale = np.abs(np.asarray(g)).max(1, keepdims=True) + 1e-6
        _close(f"part {k} grad", grad.reshape(P * E, -1) / torch.tensor(scale),
               np.asarray(g) / scale, rtol=1e-4, atol=1e-4)


def test_smc_gaussian_posterior():
    """tests/test_inference.py::test_smc_gaussian_posterior on the port."""
    res = fit_smc(GaussianModel(), None, num_particles=400, num_ensembles=2,
                  num_leapfrog_steps=5, post_sampling_steps=50, max_stage=50,
                  target="pixels", auxiliar="none", seed=0, device="cpu")
    assert float(res.final_beta.min()) == 1.0
    s = res.post_samples[-30:].reshape(-1, 3).numpy()
    np.testing.assert_allclose(s.mean(0), [0.8] * 3, atol=0.08)
    np.testing.assert_allclose(s.var(0), [0.2] * 3, atol=0.07)
    lz = res.log_evidence.numpy()
    assert lz.shape == (2,)
    np.testing.assert_allclose(lz, LOG_Z_TRUE, atol=0.2)


def test_smc_callable_target():
    """tests/test_inference.py::test_smc_callable_target on the port."""

    def my_like(x):
        return torch.sum(-0.5 * ((x - 1.0) / 0.5) ** 2, -1)

    res = fit_smc(GaussianModel(), None, num_particles=300, num_ensembles=1,
                  num_leapfrog_steps=5, post_sampling_steps=0, max_stage=50,
                  target=my_like, auxiliar="none", seed=0, device="cpu")
    assert float(res.final_beta.min()) == 1.0
    s = res.particles.reshape(-1, 3).numpy()
    np.testing.assert_allclose(s.mean(0), [0.8] * 3, atol=0.1)
    np.testing.assert_allclose(s.var(0), [0.2] * 3, atol=0.08)
    assert res.post_samples.shape == (0, 300, 3)


def test_three_start_forms():
    """start=None draws from the prior; a 3-D start is taken as it is (and
    a wrong shape raises); an (n, d) start is subsampled, with JAX's picks
    equal to the port's under JAX's draws (with and without replacement)."""
    kw = dict(num_particles=8, num_ensembles=2, num_leapfrog_steps=2,
              post_sampling_steps=0, target="pixels", auxiliar="none")
    res = fit_smc(GaussianModel(), None, max_stage=1, seed=5, device="cpu", **kw)
    assert res.particles.shape == (8, 2, 3) and torch.isfinite(res.particles).all()
    z3 = np.random.default_rng(2).standard_normal((8, 2, 3)).astype(np.float32)
    res = fit_smc(GaussianModel(), None, start=z3, max_stage=0, device="cpu", **kw)
    np.testing.assert_array_equal(res.particles.numpy(), z3)
    with pytest.raises(ValueError, match="3-D start"):
        fit_smc(GaussianModel(), None, start=z3[:4], max_stage=0, device="cpu", **kw)
    for n_start in (5, 40):  # with replacement, without
        starts = np.random.default_rng(n_start).standard_normal((n_start, 3)).astype(
            np.float32)
        want = j_fit_smc(JGaussianModel(), None, start=starts, max_stage=0, seed=7, **kw)
        got = fit_smc(GaussianModel(), None, start=starts, max_stage=0, device="cpu",
                      draws=JaxDraws(7), **kw)
        np.testing.assert_array_equal(got.particles.numpy(), np.asarray(want.particles))
        own = fit_smc(GaussianModel(), None, start=starts, max_stage=0, seed=7,
                      device="cpu", **kw)
        rows = {tuple(r) for r in starts.tolist()}
        assert all(tuple(r) in rows for r in own.particles.reshape(-1, 3).tolist())
        if n_start > 16:  # without replacement: no duplicates
            assert len({tuple(r) for r in own.particles.reshape(-1, 3).tolist()}) == 16


def test_importance_evidence_matches_jax_and_the_conjugate_evidence():
    """tests/test_inference.py::test_importance_evidence_conjugate on the
    port, and the same estimate as JAX's from JAX's draws (rtol 1e-5)."""
    from gigalens_tpu.inference.svi import importance_evidence as j_importance_evidence
    from gigalens_tpu.prob.distributions import MultivariateNormalTriL as JMVN

    class PM:
        prior = _GaussPrior()

        def log_prob(self, sim, z):
            ll = torch.sum(-0.5 * ((z - 1.0) / 0.5) ** 2, -1)
            lp = -0.5 * torch.sum(z**2, -1) - 1.5 * np.log(2 * np.pi)
            return ll + lp, ll

    class JPM:
        prior = JGaussianModel.prior

        def log_prob(self, sim, z):
            ll = jnp.sum(-0.5 * ((z - 1.0) / 0.5) ** 2, -1)
            lp = -0.5 * jnp.sum(z**2, -1) - 1.5 * jnp.log(2 * jnp.pi)
            return ll + lp, ll

    q = MultivariateNormalTriL(torch.full((3,), 0.8), torch.eye(3) * np.sqrt(0.2))
    log_z, n_eff = importance_evidence(PM(), None, q, n_samples=4096, seed=0)
    np.testing.assert_allclose(log_z, LOG_Z_TRUE, atol=0.02)
    assert n_eff > 3000, n_eff
    q_bad = MultivariateNormalTriL(torch.full((3,), -1.5), torch.eye(3) * 1.5)
    log_z_b, n_eff_b = importance_evidence(PM(), None, q_bad, n_samples=4096, seed=0)
    assert n_eff_b < n_eff / 3, (n_eff_b, n_eff)

    jq = JMVN(jnp.full(3, -0.5), jnp.eye(3) * 0.8)
    q = MultivariateNormalTriL(torch.full((3,), -0.5), torch.eye(3) * 0.8)
    keys = list(jax.random.split(jax.random.PRNGKey(3), 3))
    sample = lambda b: np.asarray(jq.sample(keys.pop(0), (b,)))  # noqa: E731
    got = importance_evidence(PM(), None, q, n_samples=1000, batch=400, sample=sample)
    want = j_importance_evidence(JPM(), None, jq, n_samples=1000, seed=3, batch=400)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_backward_model_pixels_target_and_positions_error(demo_prior):
    """tests/test_round2_fixes.py::test_backward_model_smc_pixels_target:
    lstsq amplitudes as the pixels target; a positions target on a model
    without positions raises."""
    import copy

    tree = copy.deepcopy(prior_from_reference(demo_prior).tree)
    for group in (tree["lens_light"][0], tree["source_light"][0]):
        group.pop("Ie")
    prior = Prior(tree)
    phys = PhysicalModel([EPL(18), Shear()], [SersicEllipse(use_lstsq=True)],
                         [SersicEllipse(use_lstsq=True)])
    obs = np.random.default_rng(0).normal(0, 0.1, (10, 10)).astype(np.float32)
    prob = BackwardProbModel(prior, obs, background_rms=0.1, exp_time=100.0, device="cpu")
    sim = LensSimulator(phys, SimulatorConfig(delta_pix=0.1, num_pix=10), bs=8, device="cpu")
    res = fit_smc(prob, sim, num_particles=8, num_ensembles=1, num_leapfrog_steps=2,
                  post_sampling_steps=3, max_stage=2, target="pixels", seed=0)
    assert torch.isfinite(res.particles).all()
    assert res.post_samples.shape == (3, 8, prior.d)
    with pytest.raises((ValueError, NotImplementedError)):
        fit_smc(prob, sim, num_particles=8, max_stage=1, target="positions")


def test_post_chain_shape_and_sequence_smc(demo_prior):
    """tests/test_round2_fixes.py::test_smc_post_chain_segmented_equal_chunks
    (10 post steps with segment_stages=1 -> (10, 8, d)), through
    ModellingSequence.SMC on the exact simulator with the default auxiliary
    degrading to none on a pixels-only model; progress once a stage."""
    phys = PhysicalModel([EPL(18), Shear()], [SersicEllipse()], [SersicEllipse()])
    prior = prior_from_reference(demo_prior)
    cfg = SimulatorConfig(delta_pix=0.1, num_pix=10)
    prob = ForwardProbModel(prior, np.zeros((10, 10), np.float32), background_rms=0.2,
                            exp_time=100.0, device="cpu")
    seq = ModellingSequence(phys, prob, cfg, device="cpu")
    calls = []
    res = seq.SMC(num_particles=8, num_leapfrog_steps=2, post_sampling_steps=10,
                  max_stage=2, segment_stages=1, max_sampling_per_stage=4, seed=0,
                  progress=lambda st, b: calls.append((st, b)))
    assert res.post_samples.shape == (10, 8, prior.d)
    assert torch.isfinite(res.post_samples).all() and torch.isfinite(res.particles).all()
    assert [c[0] for c in calls] == list(range(1, res.num_stages + 1))
    assert 0.0 < float(res.final_beta[0]) and res.num_stages <= 2
    # the sequence's one-rank mesh (sample sharding is ported, M20) runs
    # the unsharded sampler
    assert seq.mesh.size == 1 and seq.mesh.group is None
    again = fit_smc(prob, seq._sim(8, exact=True), num_particles=8, num_leapfrog_steps=2,
                    post_sampling_steps=10, max_stage=2, max_sampling_per_stage=4, seed=0)
    torch.testing.assert_close(again.particles, res.particles, rtol=0, atol=0)
    torch.testing.assert_close(again.post_samples, res.post_samples, rtol=0, atol=0)
