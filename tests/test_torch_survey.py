"""The port's survey mode against the JAX package's (CPU), S = 2 scenes.

On ``tests/test_survey.py``'s catalogue (SIE+Shear, SersicEllipse source,
24x24 px at 0.12"; truths from JAX's prior, noisy observations):

* ``SurveyForwardProbModel``: log-probabilities and reduced chi2 equal to
  the port's single-scene model block by block (rtol 1e-6, as the JAX
  test holds its own) and to JAX's survey model (rtol 1e-5, atol 1e-3 on
  values of ~1e3); scalar, per-scene (S,) and (H, W) / (S, H, W) noise;
  the error-map validation. Positions with 3 and 4 images a scene: SIE at
  K = 3 and EPL at K = 1 equal to JAX's survey model, EPL at K = 3 per
  sample equal to JAX's single-scene model a sample at a time (rtol 5e-4:
  one centroid sits at |det A| 1.3e-3), every row equal to the port's
  single-scene model (rtol 1e-5);
  the EPL survey Hessian against JAX's, which sums each scene's K rows
  (the survey case of F-ref-5).
* Per-scene PSF stacks: ``PSFConv`` fft and dft (pools 1-2) equal to
  single-kernel convs and to JAX's stack (rtol 1e-5 of the max), its
  gradient against float64 per scene, dft's per-scene convs on contiguous
  views of the batch; the simulator likewise (fft, dft at
  supersample 1 and 2); the lstsq components, where JAX's stack convolves
  depth-major rows with the wrong scenes' kernels (F-ref-6: 0.77 of the
  max here) and the port equals per-scene single-scene simulators (1e-5);
  ``SurveyBackwardProbModel`` against JAX where JAX is right and against
  the port's single-scene rows where it is not.
* ``laplace_scale_trils_survey`` against JAX's (relative Frobenius 1e-2,
  measured 5.6e-3: each float32 side differences gradients a step of 1e-3
  apart, and JAX holds its own survey factors to its single-scene ones at
  rtol 2e-2) and the port's single-scene factors (1e-4); ``fit_svi_survey``'s ``init_scales`` forms
  and errors against JAX's, one step against JAX's with JAX's draws
  (rtol 1e-4), the per-scene finite-draw mask (F-ref-1);
  ``importance_evidence_survey`` on the conjugate case (atol 0.03) and
  against JAX's with the same draws (rtol 1e-5).
* The SMC adapter's (P, S) <-> (S, P) permutation on scenes whose data
  differ, one SMC run a scene ensemble on the conjugate case, the MAP-start
  subsampling and scene-major post rows; a short ``SurveySequence.fit``
  that recovers each scene's truth; JAX's ``"direct"`` PSF mode; and
  ``scripts/torch_survey_production.py --cpu-quick``.
"""
import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gigalens_tpu import PhysicalModel as JPhysicalModel
from gigalens_tpu import SimulatorConfig as JSimulatorConfig
from gigalens_tpu.inference.map import laplace_scale_trils_survey as j_laplace_survey
from gigalens_tpu.inference.survey import _SceneEnsembleAdapter as JAdapter
from gigalens_tpu.inference.svi import fit_svi_survey as j_fit_svi_survey
from gigalens_tpu.inference.svi import importance_evidence_survey as j_importance_survey
from gigalens_tpu.model import ForwardProbModel as JForwardProbModel
from gigalens_tpu.model import SurveyBackwardProbModel as JSurveyBackwardProbModel
from gigalens_tpu.model import SurveyForwardProbModel as JSurveyForwardProbModel
from gigalens_tpu.ops.psf import PSFConv as JPSFConv
from gigalens_tpu.prob import Prior as JPrior
from gigalens_tpu.prob import distributions as jd
from gigalens_tpu.profiles.light.sersic import SersicEllipse as JSersicEllipse
from gigalens_tpu.profiles.mass.epl import EPL as JEPL
from gigalens_tpu.profiles.mass.shear import Shear as JShear
from gigalens_tpu.profiles.mass.sie import SIE as JSIE
from gigalens_tpu.simulator import LensSimulator as JLensSimulator
from gigalens_tpu_torch.inference import (
    SurveySequence, fit_smc, fit_svi_survey, importance_evidence_survey,
    laplace_scale_trils_survey, optim,
)
from gigalens_tpu_torch.inference.map import laplace_scale_tril
from gigalens_tpu_torch.inference.survey import _SceneEnsembleAdapter
from gigalens_tpu_torch.interop import (
    phys_model_from_reference, prior_from_reference, sim_config_from_reference,
)
from gigalens_tpu_torch.model import (
    BackwardProbModel, ForwardProbModel, SurveyBackwardProbModel, SurveyForwardProbModel,
)
from gigalens_tpu_torch.ops.psf import PSFConv
from gigalens_tpu_torch.profiles.mass import EPL
from gigalens_tpu_torch.simulator import LensSimulator

ROOT = Path(__file__).resolve().parents[1]
S = 2
BKG, EXP_T = 0.1, 200.0
STATS_RTOL, STATS_ATOL = 1e-5, 1e-3  # port vs JAX, float32 renders on both sides
CONV_REL = 1e-5  # of the output's max
# position stats, port vs JAX: one row's centroid lies where |det A| is
# 1.3e-3, and float32 cancellation in (1 - f_xx)(1 - f_yy) - f_xy f_yx puts
# the two packages 1.6e-4 apart there, the single-scene models too
POS_RTOL = 5e-4


def _gauss_kernel(size, sigma, shift=0):
    r = np.arange(size) - size // 2
    g = np.exp(-((r - shift) ** 2 + (r[:, None]) ** 2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def survey():
    """tests/test_survey.py's two-scene catalogue on both sides."""
    jprior = JPrior(dict(
        lens_mass=[
            dict(theta_E=jd.LogNormal(jnp.log(1.0), 0.15), e1=jd.Normal(0, 0.05),
                 e2=jd.Normal(0, 0.05), center_x=jd.Normal(0, 0.05),
                 center_y=jd.Normal(0, 0.05)),
            dict(gamma1=jd.Normal(0, 0.03), gamma2=jd.Normal(0, 0.03)),
        ],
        source_light=[dict(
            R_sersic=jd.LogNormal(jnp.log(0.3), 0.15), n_sersic=jd.Uniform(1, 3),
            e1=jd.Normal(0, 0.1), e2=jd.Normal(0, 0.1), center_x=jd.Normal(0, 0.1),
            center_y=jd.Normal(0, 0.1), Ie=jd.LogNormal(jnp.log(100.0), 0.3))],
    ))
    jphys = JPhysicalModel([JSIE(), JShear()], [], [JSersicEllipse()])
    jcfg = JSimulatorConfig(delta_pix=0.12, num_pix=24, supersample=1)
    truths = jprior.sample(jax.random.PRNGKey(7), S)
    imgs = np.asarray(JLensSimulator(jphys, jcfg, bs=S).simulate(truths))
    rng = np.random.default_rng(0)
    obs = (imgs + rng.normal(size=imgs.shape) * np.sqrt(BKG**2 + np.clip(imgs, 0, None) / EXP_T)
           ).astype(np.float32)
    return dict(jprior=jprior, prior=prior_from_reference(jprior), jphys=jphys,
                phys=phys_model_from_reference(jphys), jcfg=jcfg,
                cfg=sim_config_from_reference(jcfg), obs=obs)


def _z(sc, key, n):
    return np.asarray(sc["jprior"].unconstrain(sc["jprior"].sample(jax.random.PRNGKey(key), n)))


def _both_log_prob(sc, jmodel, model, z):
    jsim = JLensSimulator(sc["jphys"], sc["jcfg"], bs=z.shape[0])
    sim = LensSimulator(sc["phys"], sc["cfg"], bs=z.shape[0], device="cpu")
    lp_j, chi_j = jmodel.log_prob(jsim, jnp.asarray(z))
    lp, chi = model.log_prob(sim, _t(z))
    return (lp.numpy(), chi.numpy()), (np.asarray(lp_j), np.asarray(chi_j))


@pytest.mark.quick
@pytest.mark.parametrize("noise", ["scalar", "per_scene", "error_map"])
def test_survey_stats_match_single_scene_and_jax(survey, noise):
    """Each scene's rows equal the single-scene model's on that scene
    (scalar, per-scene (S,) noise, a shared (H, W) error map) and JAX's
    survey model."""
    sc, K = survey, 3
    kw = dict(scalar=dict(background_rms=BKG, exp_time=EXP_T),
              per_scene=dict(background_rms=np.array([0.1, 0.3]), exp_time=np.array([200., 50.])),
              error_map=dict(error_map=np.full(sc["obs"].shape[1:], 0.2, np.float32)))[noise]
    model = SurveyForwardProbModel(sc["prior"], sc["obs"], device="cpu", **kw)
    jmodel = JSurveyForwardProbModel(sc["jprior"], sc["obs"], **kw)
    z = _z(sc, 1, S * K)
    (lp, chi), (lp_j, chi_j) = _both_log_prob(sc, jmodel, model, z)
    np.testing.assert_allclose(lp, lp_j, rtol=STATS_RTOL, atol=STATS_ATOL)
    np.testing.assert_allclose(chi, chi_j, rtol=STATS_RTOL)
    sim_k = LensSimulator(sc["phys"], sc["cfg"], bs=K, device="cpu")
    for s in range(S):
        one = {k: (v[s] if noise == "per_scene" else v) for k, v in kw.items()}
        pm = ForwardProbModel(sc["prior"], sc["obs"][s], device="cpu", **one)
        lp1, chi1 = pm.log_prob(sim_k, _t(z[s * K:(s + 1) * K]))
        np.testing.assert_allclose(lp[s * K:(s + 1) * K], lp1.numpy(), rtol=1e-6, atol=1e-4)
        np.testing.assert_allclose(chi[s * K:(s + 1) * K], chi1.numpy(), rtol=1e-6)


def test_survey_error_map_validation(survey):
    """A shared (H, W) map broadcasts to (S, H, W); other shapes raise, as
    in JAX; a batch that is not a multiple of S raises."""
    sc = survey
    em = np.full(sc["obs"].shape[1:], 0.2, np.float32)
    model = SurveyForwardProbModel(sc["prior"], sc["obs"], error_map=em, device="cpu")
    assert tuple(model.error_map.shape) == sc["obs"].shape
    for bad in (em[:10], np.ones((3, *em.shape), np.float32)):
        with pytest.raises(ValueError, match="error_map"):
            JSurveyForwardProbModel(sc["jprior"], sc["obs"], error_map=bad)
        with pytest.raises(ValueError, match="error_map"):
            SurveyForwardProbModel(sc["prior"], sc["obs"], error_map=bad, device="cpu")
    with pytest.raises(ValueError, match=r"\(S, H, W\)"):
        SurveyForwardProbModel(sc["prior"], sc["obs"][0], background_rms=BKG, exp_time=EXP_T,
                               device="cpu")
    sim3 = LensSimulator(sc["phys"], sc["cfg"], bs=3, device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        model.log_prob(sim3, _t(_z(sc, 2, 3)))


CX = [np.array([0.9, -0.8, 0.1], np.float32), np.array([1.0, -0.9, 0.2, -0.3], np.float32)]
CY = [np.array([-0.7, 0.8, 1.0], np.float32), np.array([0.6, -0.8, -1.1, 0.9], np.float32)]
CEX = [np.full(3, 0.05, np.float32), np.full(4, 0.08, np.float32)]
CEY = [np.full(3, 0.06, np.float32), np.full(4, 0.07, np.float32)]


def _epl_setup(sc):
    """The catalogue's prior with an EPL deflector (gamma sampled)."""
    tree = dict(sc["jprior"].tree)
    tree["lens_mass"] = [dict(tree["lens_mass"][0], gamma=jd.TruncatedNormal(2, 0.1, 1.5, 2.5)),
                         tree["lens_mass"][1]]
    jprior = JPrior(tree)
    jphys = JPhysicalModel([JEPL(30), JShear()], [], [JSersicEllipse()])
    return jprior, prior_from_reference(jprior), jphys, phys_model_from_reference(jphys)


@pytest.mark.parametrize("lens,K", [("sie", 3), ("epl", 1), ("epl", 3)])
def test_survey_positions_match_jax(survey, lens, K):
    """Per-scene padded and masked position stats, scenes of 3 and 4
    images: SIE at any K and EPL at K = 1 equal to JAX's survey model, EPL
    at K > 1 equal to JAX's single-scene model a sample at a time (JAX's
    survey EPL rows use a Hessian summed over the scene's K samples,
    F-ref-5); every row equal to the port's single-scene model."""
    sc = survey
    jprior, prior, jphys, phys = ((sc["jprior"], sc["prior"], sc["jphys"], sc["phys"])
                                  if lens == "sie" else _epl_setup(sc))
    kw = dict(background_rms=BKG, exp_time=EXP_T, centroids_x=CX, centroids_y=CY,
              centroids_errors_x=CEX, centroids_errors_y=CEY)
    model = SurveyForwardProbModel(prior, sc["obs"], device="cpu", **kw)
    assert model.include_positions and model.n_position == round(2 * 7 / 2)
    z = np.asarray(jprior.unconstrain(jprior.sample(jax.random.PRNGKey(9), S * K)))
    sim = LensSimulator(phys, sc["cfg"], bs=S * K, device="cpu")
    ll, chi = model.stats_positions(sim, prior.constrain(_t(z)))
    if lens == "sie" or K == 1:
        jmodel = JSurveyForwardProbModel(jprior, sc["obs"], **kw)
        jsim = JLensSimulator(jphys, sc["jcfg"], bs=S * K)
        ll_j, chi_j = jmodel.stats_positions(jsim, jprior.constrain(jnp.asarray(z)))
        np.testing.assert_allclose(ll.numpy(), np.asarray(ll_j), rtol=POS_RTOL, atol=1e-3)
        np.testing.assert_allclose(chi.numpy(), np.asarray(chi_j), rtol=POS_RTOL, atol=1e-5)
    sim_k = LensSimulator(phys, sc["cfg"], bs=K, device="cpu")
    jsim1 = JLensSimulator(jphys, sc["jcfg"], bs=1)
    for s in range(S):
        one = dict(background_rms=BKG, exp_time=EXP_T, centroids_x=[CX[s]], centroids_y=[CY[s]],
                   centroids_errors_x=[CEX[s]], centroids_errors_y=[CEY[s]])
        pm = ForwardProbModel(prior, sc["obs"][s], device="cpu", **one)
        rows = slice(s * K, (s + 1) * K)
        ll1, chi1 = pm.stats_positions(sim_k, prior.constrain(_t(z[rows])))
        np.testing.assert_allclose(ll[rows].numpy(), ll1.numpy(), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(chi[rows].numpy(), chi1.numpy(), rtol=1e-5, atol=1e-6)
        if lens == "epl" and K > 1:
            jpm = JForwardProbModel(jprior, sc["obs"][s], **one)
            ll_j, chi_j = jax.jit(jax.vmap(lambda zz: jpm.stats_positions(
                jsim1, jprior.constrain(zz[None]))))(jnp.asarray(z[rows]))
            np.testing.assert_allclose(ll[rows].numpy(), np.asarray(ll_j).ravel(),
                                       rtol=POS_RTOL, atol=1e-3)
            np.testing.assert_allclose(chi[rows].numpy(), np.asarray(chi_j).ravel(),
                                       rtol=POS_RTOL, atol=1e-5)
    lp, _ = model.log_prob(sim, _t(z))
    assert torch.isfinite(lp).all()


def test_epl_survey_hessian_is_per_sample_where_jax_sums_the_scene():
    """F-ref-5, survey case: JAX's EPL Hessian at (S, 1, n) centroids and
    (S, K, 1) parameters (``SurveyForwardProbModel.stats_positions``)
    differentiates the unbroadcast coordinates, so each scene gets the sum
    of its K rows; the port's rows are per sample, and their sum over K is
    JAX's."""
    rng = np.random.default_rng(4)
    K, n = 3, 4
    params = dict(theta_E=rng.uniform(0.9, 1.4, (S, K, 1)), gamma=rng.uniform(1.8, 2.3, (S, K, 1)),
                  e1=rng.uniform(-0.1, 0.1, (S, K, 1)), e2=rng.uniform(-0.1, 0.1, (S, K, 1)),
                  center_x=np.zeros((S, K, 1)), center_y=np.zeros((S, K, 1)))
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.uniform(-1.5, 1.5, (S, 1, n)).astype(np.float32)
    y = rng.uniform(-1.5, 1.5, (S, 1, n)).astype(np.float32)
    jax_h = JEPL(30).hessian(jnp.asarray(x), jnp.asarray(y),
                             **{k: jnp.asarray(v) for k, v in params.items()})
    port_h = EPL(30).hessian(_t(x), _t(y), **{k: _t(v) for k, v in params.items()})
    for j, p in zip(jax_h, port_h):
        assert tuple(p.shape) == (S, K, n)
        np.testing.assert_allclose(np.asarray(j).reshape(S, n), p.sum(1).numpy(), rtol=1e-4,
                                   atol=1e-5)
    # the rows differ: the sum is not K copies of one row
    assert float((port_h[0] - port_h[0].mean(1, keepdim=True)).abs().max()) > 1e-2


@pytest.mark.parametrize("mode,pool", [("fft", 1), ("dft", 1), ("dft", 2)])
def test_per_scene_psf_conv_matches_single_and_jax(mode, pool):
    """A (S, kh, kw) stack convolves each scene-major block with its own
    kernel: equal to S single-kernel convs and to JAX's stack; the
    gradient of each scene's block against float64 (the fft spectrum of
    (S, 1, fh, fw') under autograd)."""
    H = W = 24
    kernels = np.stack([_gauss_kernel(7, 1.0), _gauss_kernel(7, 2.5, shift=2)])
    K = 5
    x = np.random.default_rng(3).normal(size=(S * K, H, W)).astype(np.float32)
    conv = PSFConv(kernels, (H, W), mode=mode, pool=pool, device="cpu")
    assert conv.n_scenes == S
    xt = _t(x).requires_grad_(True)
    out = conv(xt)
    want = np.asarray(JPSFConv(kernels, (H, W), mode=mode, pool=pool, pallas=False)(
        jnp.asarray(x)))
    assert _rel(out.detach(), want) < CONV_REL
    ct = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    (grad,) = torch.autograd.grad(out, xt, ct)
    for s in range(S):
        rows = slice(s * K, (s + 1) * K)
        one = PSFConv(kernels[s], (H, W), mode=mode, pool=pool, device="cpu")
        assert _rel(out[rows].detach(), one(_t(x[rows]))) < CONV_REL
        x64 = _t(x[rows]).double().requires_grad_(True)
        ref = PSFConv(kernels[s], (H, W), mode="fft", device="cpu")(x64)
        if pool > 1:
            ref = ref.reshape(K, H // pool, pool, W // pool, pool).mean((2, 4))
        (g64,) = torch.autograd.grad(ref, x64, ct[rows].double())
        assert _rel(grad[rows], g64) < CONV_REL


def test_per_scene_psf_batch_validation():
    """A batch that is not a multiple of S raises (scene-major), the
    direct mode refuses a stack, and a stack on a leading scene axis
    leaves other batch axes alone."""
    kernels = np.stack([_gauss_kernel(5, 1.0), _gauss_kernel(5, 2.0)])
    conv = PSFConv(kernels, (16, 16), mode="fft", device="cpu")
    with pytest.raises(ValueError, match="scene-major"):
        conv(torch.zeros((3, 16, 16)))
    with pytest.raises(NotImplementedError):
        PSFConv(kernels, (16, 16), mode="direct", device="cpu")
    x = torch.randn((3, 4, 16, 16), generator=torch.Generator().manual_seed(1))
    out = conv(x, scene_axis=1)  # (depth, S * K, H, W): scene axis 1
    for s in range(S):
        one = PSFConv(kernels[s], (16, 16), mode="fft", device="cpu")
        torch.testing.assert_close(out[:, 2 * s:2 * s + 2], one(x[:, 2 * s:2 * s + 2]))


def test_per_scene_dft_takes_contiguous_views_of_the_batch():
    """dft with a stack: each scene's conv gets its K rows as a contiguous
    view of the caller's batch (no copy a step), in scene order."""
    kernels = np.stack([_gauss_kernel(5, 1.0), _gauss_kernel(5, 2.0)])
    conv = PSFConv(kernels, (16, 16), mode="dft", pool=2, device="cpu")
    seen = []
    conv._scene_convs = [lambda x, c=c: (seen.append(x), c(x))[1] for c in conv._scene_convs]
    x = torch.randn((S * 3, 16, 16), generator=torch.Generator().manual_seed(2))
    conv(x)
    assert len(seen) == S
    for s, v in enumerate(seen):
        assert v.is_contiguous() and v.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()
        assert v.data_ptr() == x[3 * s].data_ptr()


@pytest.mark.parametrize("mode,ss", [("fft", 2), ("dft", 1), ("dft", 2)])
def test_simulator_per_scene_psf_matches_single_and_jax(survey, mode, ss):
    """LensSimulator with a (S, kh, kw) kernel equals per-scene simulators
    with their own kernels (each supersampled on its own) and JAX's."""
    sc = survey
    kernels = np.stack([_gauss_kernel(9, 1.2), _gauss_kernel(9, 3.0, shift=1)])
    jcfg = dataclasses.replace(sc["jcfg"], kernel=kernels, supersample=ss, psf_mode=mode)
    K = 3
    jparams = sc["jprior"].sample(jax.random.PRNGKey(5), S * K)
    params = jax.tree_util.tree_map(_t, jparams)
    sim = LensSimulator(sc["phys"], sim_config_from_reference(jcfg), bs=S * K, device="cpu")
    out = sim.simulate(params)
    want = np.asarray(JLensSimulator(sc["jphys"], jcfg, bs=S * K).simulate(jparams))
    assert _rel(out, want) < CONV_REL
    for s in range(S):
        cfg1 = sim_config_from_reference(dataclasses.replace(jcfg, kernel=kernels[s]))
        sim1 = LensSimulator(sc["phys"], cfg1, bs=K, device="cpu")
        block = jax.tree_util.tree_map(lambda a: a[s * K:(s + 1) * K], params)
        assert _rel(out[s * K:(s + 1) * K], sim1.simulate(block)) < CONV_REL


def _lstsq_scene():
    """Both lights lstsq (depth 2): the components path of F-ref-6."""
    jprior = JPrior(dict(
        lens_mass=[dict(theta_E=jd.LogNormal(jnp.log(1.0), 0.1), e1=jd.Normal(0, 0.05),
                        e2=jd.Normal(0, 0.05), center_x=jd.Normal(0, 0.05),
                        center_y=jd.Normal(0, 0.05))],
        lens_light=[dict(R_sersic=jd.LogNormal(jnp.log(0.8), 0.1), n_sersic=jd.Uniform(2, 4),
                         e1=jd.Normal(0, 0.05), e2=jd.Normal(0, 0.05),
                         center_x=jd.Normal(0, 0.05), center_y=jd.Normal(0, 0.05))],
        source_light=[dict(R_sersic=jd.LogNormal(jnp.log(0.25), 0.1),
                           n_sersic=jd.Uniform(1, 3), e1=jd.Normal(0, 0.1),
                           e2=jd.Normal(0, 0.1), center_x=jd.Normal(0, 0.1),
                           center_y=jd.Normal(0, 0.1))],
    ))
    jphys = JPhysicalModel([JSIE()], [JSersicEllipse(use_lstsq=True)],
                           [JSersicEllipse(use_lstsq=True)])
    return jprior, prior_from_reference(jprior), jphys, phys_model_from_reference(jphys)


@pytest.mark.parametrize("mode", ["fft", "dft"])
def test_lstsq_components_take_each_rows_own_scene_psf(mode):
    """F-ref-6: JAX's ``lstsq_simulate`` sends (depth, S*K, H, W) components
    through its stack flattened depth-major and split as if scene-major, so
    whole component planes meet the wrong scenes' PSFs (0.77 of the max on
    these inputs); the port convolves each row's components with its own
    scene's PSF and equals S single-scene simulators (rel 1e-5)."""
    jprior, prior, jphys, phys = _lstsq_scene()
    kernels = np.stack([_gauss_kernel(7, 1.0), np.roll(np.eye(7, dtype=np.float32)[3:4].T
                                                       @ np.eye(7, dtype=np.float32)[3:4], 2,
                                                       axis=1)])
    jcfg = JSimulatorConfig(delta_pix=0.1, num_pix=20, supersample=1, kernel=kernels,
                            psf_mode=mode, use_fused_render=False)
    K = 3
    jparams = jprior.sample(jax.random.PRNGKey(2), S * K)
    params = jax.tree_util.tree_map(_t, jparams)
    ones = np.ones((20, 20), np.float32)
    sim = LensSimulator(phys, sim_config_from_reference(jcfg), bs=S * K, device="cpu")
    got = sim.lstsq_simulate(params, ones, ones, return_stacked=True).numpy()
    jax_got = np.asarray(JLensSimulator(jphys, jcfg, bs=S * K).lstsq_simulate(
        jparams, ones, ones, return_stacked=True))
    want = []
    for s in range(S):
        cfg1 = sim_config_from_reference(dataclasses.replace(jcfg, kernel=kernels[s]))
        block = jax.tree_util.tree_map(lambda a: a[s * K:(s + 1) * K], params)
        want.append(LensSimulator(phys, cfg1, bs=K, device="cpu").lstsq_simulate(
            block, ones, ones, return_stacked=True).numpy())
    want = np.concatenate(want)
    assert got.shape == want.shape == (S * K, 20, 20, 2)
    assert _rel(got, want) < CONV_REL
    assert _rel(jax_got, want) > 0.5, _rel(jax_got, want)  # measured 0.77


def test_survey_backward_model_matches_jax_and_single_scene():
    """SurveyBackwardProbModel (per-scene noise): against JAX with one
    shared PSF (JAX is right there) and, under a per-scene stack, against
    the port's single-scene BackwardProbModels."""
    jprior, prior, jphys, phys = _lstsq_scene()
    K = 3
    z = np.asarray(jprior.unconstrain(jprior.sample(jax.random.PRNGKey(6), S * K)))
    truth = jprior.sample(jax.random.PRNGKey(1), S)
    jcfg = JSimulatorConfig(delta_pix=0.1, num_pix=20, supersample=1,
                            kernel=_gauss_kernel(5, 1.0), psf_mode="fft",
                            use_fused_render=False)
    ones = np.ones((20, 20), np.float32)
    stack = np.asarray(JLensSimulator(jphys, jcfg, bs=S).lstsq_simulate(
        truth, ones, ones, return_stacked=True))
    obs = (stack @ np.array([300.0, 80.0], np.float32)).astype(np.float32)
    obs += np.random.default_rng(2).normal(0, 0.2, obs.shape).astype(np.float32)
    bkg, exp_t = np.array([0.2, 0.3]), np.array([100.0, 60.0])
    jmodel = JSurveyBackwardProbModel(jprior, obs, bkg, exp_t)
    model = SurveyBackwardProbModel(prior, obs, bkg, exp_t, device="cpu")
    lp_j, chi_j = jmodel.log_prob(JLensSimulator(jphys, jcfg, bs=S * K), jnp.asarray(z))
    sim = LensSimulator(phys, sim_config_from_reference(jcfg), bs=S * K, device="cpu")
    lp, chi = model.log_prob(sim, _t(z))
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_j), rtol=1e-4)
    np.testing.assert_allclose(chi.numpy(), np.asarray(chi_j), rtol=1e-4)

    kernels = np.stack([_gauss_kernel(5, 0.8), _gauss_kernel(5, 2.0, shift=1)])
    cfg = sim_config_from_reference(dataclasses.replace(jcfg, kernel=kernels))
    lp, chi = model.log_prob(LensSimulator(phys, cfg, bs=S * K, device="cpu"), _t(z))
    for s in range(S):
        cfg1 = sim_config_from_reference(dataclasses.replace(jcfg, kernel=kernels[s]))
        pm = BackwardProbModel(prior, obs[s], float(bkg[s]), float(exp_t[s]), device="cpu")
        lp1, chi1 = pm.log_prob(LensSimulator(phys, cfg1, bs=K, device="cpu"),
                                _t(z[s * K:(s + 1) * K]))
        np.testing.assert_allclose(lp[s * K:(s + 1) * K].numpy(), lp1.numpy(), rtol=1e-5)
        np.testing.assert_allclose(chi[s * K:(s + 1) * K].numpy(), chi1.numpy(), rtol=1e-5)


def _frob(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


def test_survey_laplace_matches_jax_and_single_scene(survey):
    """One FD batch of S * 2d rows: each scene's factor against JAX's
    survey factors and the port's single-scene FD factor."""
    sc = survey
    jmodel = JSurveyForwardProbModel(sc["jprior"], sc["obs"], background_rms=BKG, exp_time=EXP_T)
    model = SurveyForwardProbModel(sc["prior"], sc["obs"], background_rms=BKG, exp_time=EXP_T,
                                   device="cpu")
    z = _z(sc, 3, S)
    d = z.shape[1]
    seq = SurveySequence(sc["phys"], model, sc["cfg"], device="cpu")
    got = seq.laplace_scale_trils(z)
    assert isinstance(got, np.ndarray) and got.shape == (S, d, d)
    jcfg = dataclasses.replace(sc["jcfg"], use_fused_render=False, psf_mode="fft")
    want = np.asarray(j_laplace_survey(jmodel, JLensSimulator(sc["jphys"], jcfg, bs=S * 2 * d),
                                       jnp.asarray(z)))
    direct = laplace_scale_trils_survey(
        model, LensSimulator(sc["phys"], sim_config_from_reference(jcfg), bs=S * 2 * d,
                             device="cpu"), z).numpy()
    np.testing.assert_array_equal(got, direct)
    sim1 = LensSimulator(sc["phys"], sim_config_from_reference(jcfg), bs=2 * d, device="cpu")
    for s in range(S):
        assert _frob(got[s], want[s]) < 1e-2, _frob(got[s], want[s])
        pm = ForwardProbModel(sc["prior"], sc["obs"][s], background_rms=BKG, exp_time=EXP_T,
                              device="cpu")
        one = laplace_scale_tril(pm, sim1, z[s], method="fd").numpy()
        assert _frob(got[s], one) < 1e-4, _frob(got[s], one)


def _svi_models(sc):
    jmodel = JSurveyForwardProbModel(sc["jprior"], sc["obs"], background_rms=BKG, exp_time=EXP_T)
    model = SurveyForwardProbModel(sc["prior"], sc["obs"], background_rms=BKG, exp_time=EXP_T,
                                   device="cpu")
    return jmodel, model


def _adam(lr):
    return optim.chain(optim.scale_by_adam(), optim.scale_by_schedule(lambda t: -lr))


N_VI = 4
D_GAUSS = 3


class _GaussSurvey:
    """Scene-major Gaussian log-density in D_GAUSS dims, one mean a scene,
    on either side (``xp``: jnp or torch): what ``fit_svi_survey`` reads of
    a model, with no render."""

    def __init__(self, xp):
        self.xp = xp

    def log_prob(self, sim, z):
        mu = self.xp.concatenate([z[: z.shape[0] // 2] * 0 + 1.0, z[z.shape[0] // 2:] * 0 - 2.0])
        lp = -0.5 * self.xp.sum(((z - mu) / 0.5) ** 2, -1) - 0.5 * self.xp.sum(z**2, -1)
        return lp, lp


class _CPUSim:
    device = torch.device("cpu")


@pytest.mark.parametrize("form", ["scalar", "vector", "per_scene_diag", "shared", "per_scene"])
def test_fit_svi_survey_init_scales_forms_match_jax(form):
    """Every ``init_scales`` form starts each scene's surrogate where JAX's
    does (a zero learning rate keeps the start), with finite (1, S)
    losses."""
    d = D_GAUSS
    rng = np.random.default_rng(5)
    tril = (np.tril(rng.normal(0, 0.01, (S, d, d))) + np.eye(d) * 0.05).astype(np.float32)
    scales = dict(scalar=0.02, vector=np.linspace(0.01, 0.05, d),
                  per_scene_diag=np.stack([np.full(d, 0.03), np.full(d, 0.07)]),
                  shared=tril[0], per_scene=tril)[form]
    starts = rng.normal(size=(S, d)).astype(np.float32)
    jm, jt, _ = j_fit_svi_survey(_GaussSurvey(jnp), None, jnp.asarray(starts), optax.adam(0.0),
                                 n_vi=N_VI, init_scales=scales, num_steps=1, polyak_fraction=0.0)
    m, t, losses = fit_svi_survey(_GaussSurvey(torch), _CPUSim(), starts, _adam(0.0), n_vi=N_VI,
                                  init_scales=scales, num_steps=1, polyak_fraction=0.0)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-6)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-5, atol=1e-9)
    assert tuple(losses.shape) == (1, S) and torch.isfinite(losses).all()


@pytest.mark.parametrize("bad,match", [
    ("two_d", "2-D init_scales"), ("one_d", "1-D init_scales"), ("three_d", "3-D init_scales"),
    ("ambiguous", "ambiguous")])
def test_fit_svi_survey_init_scales_errors_match_jax(bad, match):
    d = D_GAUSS
    n_scenes = d if bad == "ambiguous" else S
    scales = dict(two_d=np.ones((3, d + 1)), one_d=np.ones(d + 1), three_d=np.ones((S, d, d + 1)),
                  ambiguous=np.eye(d, dtype=np.float32))[bad]
    starts = np.zeros((n_scenes, d), np.float32)
    with pytest.raises(ValueError, match=match):
        j_fit_svi_survey(_GaussSurvey(jnp), None, jnp.asarray(starts), optax.adam(0.0),
                         n_vi=N_VI, init_scales=scales, num_steps=1)
    with pytest.raises(ValueError, match=match):
        fit_svi_survey(_GaussSurvey(torch), _CPUSim(), starts, _adam(0.0), n_vi=N_VI,
                       init_scales=scales, num_steps=1)


def _jax_svi_draws(seed, shape):
    """The normals of JAX's first SVI step: ``_run_adam_scan`` splits
    ``PRNGKey(seed)`` into (key, k_seg), ``k_seg`` into one key a step."""
    _, k_seg = jax.random.split(jax.random.PRNGKey(seed))
    return np.asarray(jax.random.normal(jax.random.split(k_seg, 1)[0], shape))


def test_fit_svi_survey_one_step_matches_jax(survey):
    """One Adam step from per-scene Laplace-like factors with JAX's draws:
    means, factors and the (1, S) per-scene losses against JAX's."""
    sc = survey
    jmodel, model = _svi_models(sc)
    d = sc["prior"].d
    starts = _z(sc, 6, S)
    scales = np.stack([np.eye(d) * 0.03, np.eye(d) * 0.06]).astype(np.float32)
    jsim = JLensSimulator(sc["jphys"], sc["jcfg"], bs=S * N_VI)
    sim = LensSimulator(sc["phys"], sc["cfg"], bs=S * N_VI, device="cpu")
    jm, jt, jl = j_fit_svi_survey(jmodel, jsim, jnp.asarray(starts), optax.adam(1e-2),
                                  n_vi=N_VI, init_scales=scales, num_steps=1, seed=4,
                                  polyak_fraction=0.0)
    eps = _jax_svi_draws(4, (S, N_VI, d))
    m, t, losses = fit_svi_survey(model, sim, starts, _adam(1e-2), n_vi=N_VI, init_scales=scales,
                                  num_steps=1, polyak_fraction=0.0,
                                  draws=lambda shape: torch.tensor(eps))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), rtol=1e-4)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-4, atol=1e-6)


class _DuckPrior:
    """N(0, 1) in 2 dims, identity bijector."""

    d = 2

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
        return torch.randn((*shape, 2), generator=generator, device=generator.device)


class _DuckSurvey:
    """Scene-major conjugate Gaussian: scene 0's likelihood N(1, 0.5^2) a
    dim, scene 1's N(-2, 0.5^2); posteriors N(0.8, 0.2) and N(-1.6, 0.2)
    (the port's twin of tests/test_survey.py's duck model). ``nan_row``
    makes one scene-major row's likelihood NaN."""

    n_scenes = 2
    include_pixels = True
    include_positions = False
    prior = _DuckPrior()
    nan_row = None

    def stats_pixels(self, sim, x):
        mu = torch.repeat_interleave(torch.tensor([1.0, -2.0]), x.shape[0] // 2)
        ll = torch.sum(-0.5 * ((x - mu[:, None]) / 0.5) ** 2, -1)
        if self.nan_row is not None:
            ll = torch.where(torch.arange(x.shape[0]) == self.nan_row, torch.nan, ll)
        return ll, ll

    def log_prob(self, sim, z):
        ll, _ = self.stats_pixels(sim, z)
        return ll - 0.5 * torch.sum(z**2, -1) - math.log(2 * math.pi), ll


LZ_TRUE = [2 * (0.5 * np.log(0.2) - 1.0 / 2.5), 2 * (0.5 * np.log(0.2) - 4.0 / 2.5)]


def test_importance_evidence_survey_conjugate_and_jax():
    """Exact per-scene surrogates give each scene's conjugate evidence; the
    same estimate as JAX's from JAX's draws."""
    from test_survey import _DuckSurveyModel

    class JPM(_DuckSurveyModel):
        def log_prob(self, sim, z):
            ll, _ = self.stats_pixels(sim, z)
            return ll - 0.5 * jnp.sum(z**2, -1) - 1.0 * jnp.log(2 * jnp.pi), ll

    means = np.array([[0.8, 0.8], [-1.6, -1.6]], np.float32)
    trils = (np.stack([np.eye(2), np.eye(2)]) * np.sqrt(0.2)).astype(np.float32)
    log_z, n_eff = importance_evidence_survey(_DuckSurvey(), None, means, trils, n_samples=2048,
                                              seed=0, device="cpu")
    np.testing.assert_allclose(log_z, LZ_TRUE, atol=0.03)
    assert log_z.shape == (S,) and (n_eff > 1500).all(), n_eff
    off = means + 0.7
    eps = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (S, 512, 2)))
    got = importance_evidence_survey(_DuckSurvey(), None, off, trils * 1.5, n_samples=512,
                                     device="cpu", draws=lambda shape: torch.tensor(eps))
    want = j_importance_survey(JPM(), None, jnp.asarray(off), jnp.asarray(trils * 1.5),
                               n_samples=512, seed=1)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4)


def test_fit_svi_survey_masks_a_non_finite_draw_in_its_own_scene():
    """F-ref-1 per scene: a NaN likelihood at one draw of scene 0 leaves
    both surrogates finite, and scene 1's step equals its step without
    the NaN (the mask is per scene)."""

    kw = dict(n_vi=N_VI, init_scales=0.5, num_steps=3, polyak_fraction=0.0, seed=2)
    clean = fit_svi_survey(_DuckSurvey(), _CPUSim(), np.zeros((S, 2)), _adam(0.05), **kw)
    bad = _DuckSurvey()
    bad.nan_row = 1
    got = fit_svi_survey(bad, _CPUSim(), np.zeros((S, 2)), _adam(0.05), **kw)
    assert all(torch.isfinite(t).all() for t in got)
    for a, b in zip(got[:2], clean[:2]):
        torch.testing.assert_close(a[1], b[1])
    assert not torch.equal(got[0][0], clean[0][0])


def test_scene_ensemble_adapter_permutation_matches_jax():
    """Particle-major rows (p * S + s) reach the survey model scene-major
    and come back: each particle is scored against its own scene's data
    (the scenes' data differ), as JAX's adapter does; one SMC ensemble a
    scene finds each scene's own posterior and evidence."""
    from test_survey import _DuckSurveyModel

    P = 5
    x = np.random.default_rng(0).normal(size=(P * S, 2)).astype(np.float32)
    ll, _ = _SceneEnsembleAdapter(_DuckSurvey(), P).stats_pixels(None, _t(x))
    ll_j, _ = JAdapter(_DuckSurveyModel(), P).stats_pixels(None, jnp.asarray(x))
    np.testing.assert_allclose(ll.numpy(), np.asarray(ll_j), rtol=1e-6)
    mu = np.tile([1.0, -2.0], P)[:, None]
    np.testing.assert_allclose(ll.numpy(), np.sum(-0.5 * ((x - mu) / 0.5) ** 2, -1), rtol=1e-6)

    res = fit_smc(_SceneEnsembleAdapter(_DuckSurvey(), 400), None, num_particles=400,
                  num_ensembles=S, num_leapfrog_steps=5, post_sampling_steps=0, max_stage=50,
                  target="pixels", auxiliar="none", seed=0, device="cpu")
    assert bool((res.final_beta == 1.0).all())
    parts = res.particles.numpy()
    np.testing.assert_allclose(parts[:, 0].mean(0), [0.8] * 2, atol=0.1)
    np.testing.assert_allclose(parts[:, 1].mean(0), [-1.6] * 2, atol=0.1)
    np.testing.assert_allclose(res.log_evidence.numpy(), LZ_TRUE, atol=0.25)


def test_survey_smc_subsamples_each_scene_and_returns_scene_major_rows(survey):
    """K == P starts a scene (no replacement) are drawn from the scene's
    own rows, and the post chain comes back scene-major."""
    sc = survey
    model = SurveyForwardProbModel(sc["prior"], sc["obs"], background_rms=BKG, exp_time=EXP_T,
                                   device="cpu")
    seq = SurveySequence(sc["phys"], model, sc["cfg"], device="cpu")
    P = 8
    z = np.array(_z(sc, 8, S * P))
    z[P:] += 3.0  # the scenes' start pools lie far apart
    res = seq.SMC(start=z, num_particles=P, num_leapfrog_steps=1, post_sampling_steps=2,
                  max_stage=1, seed=0)
    assert tuple(res.particles.shape) == (P, S, sc["prior"].d)
    assert tuple(res.final_beta.shape) == (S,) and tuple(res.post_samples.shape) == (2, S * P,
                                                                                      sc["prior"].d)
    starts = [{tuple(r) for r in np.round(z[s * P:(s + 1) * P], 4)} for s in range(S)]
    post = res.post_samples[-1].numpy().reshape(S, P, -1)
    parts = res.particles.numpy()
    for s in range(S):
        d_own = np.linalg.norm(post[s].mean(0) - parts[:, s].mean(0))
        d_other = np.linalg.norm(post[s].mean(0) - parts[:, 1 - s].mean(0))
        assert d_own < d_other, (s, d_own, d_other)
        assert np.linalg.norm(parts[:, s].mean(0) - z[s * P:(s + 1) * P].mean(0)) < 1.0
    assert starts[0].isdisjoint(starts[1])
    # sample sharding is ported (M20): a sequence takes a mesh, on its device
    from gigalens_tpu_torch.parallel import Mesh

    assert SurveySequence(sc["phys"], model, sc["cfg"], mesh=Mesh("cpu")).device.type == "cpu"
    with pytest.raises(ValueError, match="mesh"):
        SurveySequence(sc["phys"], model, sc["cfg"], mesh=Mesh("cpu"), device="cuda")
    with pytest.raises(TypeError):
        SurveySequence(sc["phys"], ForwardProbModel(sc["prior"], sc["obs"][0],
                                                    background_rms=BKG, exp_time=EXP_T,
                                                    device="cpu"), sc["cfg"], device="cpu")


def test_survey_sequence_fit_recovers_each_scenes_truth(survey):
    """MAP -> per-scene Laplace -> SVI -> grouped HMC in one call: per-scene
    shapes, and each scene's posterior mean fits its own data at reduced
    chi2 near 1 and not the other scene's."""
    sc = survey
    model = SurveyForwardProbModel(sc["prior"], sc["obs"], background_rms=BKG, exp_time=EXP_T,
                                   device="cpu")
    seq = SurveySequence(sc["phys"], model, sc["cfg"], device="cpu")
    phases = []
    out = seq.fit(n_starts=16, map_steps=150, n_vi=8, vi_steps=60, n_hmc=8, num_burnin_steps=60,
                  num_results=80, map_lr=5e-3, seed=0, progress=lambda ph, st, v: phases.append(ph))
    d = sc["prior"].d
    assert tuple(out["best"].shape) == (S, d) and tuple(out["q_trils"].shape) == (S, d, d)
    assert tuple(out["losses"].shape) == (60, S) and torch.isfinite(out["losses"]).all()
    res = out["hmc"]
    assert tuple(res.samples.shape) == (80, S * 8, d) and tuple(res.step_size.shape) == (S,)
    assert {"map", "svi", "hmc"} <= set(phases) and set(out["times"]) == {"map", "svi", "hmc"}
    assert len(out["summaries"]) == S and all("max_rhat" in s["_global"] for s in out["summaries"])
    per_scene = seq.scene_samples(res)
    assert tuple(per_scene.shape) == (S, 80 * 8, d) and torch.isfinite(per_scene).all()
    means = per_scene.mean(1)
    sim2 = LensSimulator(sc["phys"], sc["cfg"], bs=S, device="cpu")
    with torch.no_grad():
        chi_own = model.log_prob(sim2, means)[1].numpy()
        chi_swap = model.log_prob(sim2, means.flip(0))[1].numpy()
    assert (chi_own < 1.5).all(), chi_own
    assert (chi_swap > 5 * chi_own[::-1]).all(), (chi_own, chi_swap)


@pytest.mark.parametrize("how", ["psf_mode", "use_fft", "auto"])
def test_direct_psf_mode_matches_jax(survey, how):
    """JAX's "direct" mode (``lax.conv``, no pool): picked by psf_mode,
    use_fft=False, or automatically for a supersampled kernel of <= 81
    taps; F.conv2d with the flipped kernel, against JAX's render. An
    asymmetric kernel shows the orientation."""
    sc = survey
    kern = _gauss_kernel(5, 1.0, shift=1)
    extra = dict(psf_mode=dict(psf_mode="direct"), use_fft=dict(use_fft=False), auto={})[how]
    jcfg = dataclasses.replace(sc["jcfg"], kernel=kern, **extra)
    jparams = sc["jprior"].sample(jax.random.PRNGKey(11), 3)
    sim = LensSimulator(sc["phys"], sim_config_from_reference(jcfg), bs=3, device="cpu")
    assert sim._conv.mode == "direct"
    got = sim.simulate(jax.tree_util.tree_map(_t, jparams))
    want = np.asarray(JLensSimulator(sc["jphys"], jcfg, bs=3).simulate(jparams))
    assert _rel(got, want) < CONV_REL
    x = np.random.default_rng(1).normal(size=(4, 24, 24)).astype(np.float32)
    conv = PSFConv(kern, (24, 24), mode="direct", device="cpu")
    ref = JPSFConv(kern, (24, 24), mode="direct")(jnp.asarray(x))
    assert _rel(conv(_t(x)), ref) < CONV_REL
    # the stack never takes it
    cfg = sim_config_from_reference(dataclasses.replace(jcfg, kernel=np.stack([kern, kern])))
    assert LensSimulator(sc["phys"], cfg, bs=2, device="cpu")._conv.mode == "fft"


def test_torch_survey_production_cpu_quick():
    """scripts/torch_survey_production.py at its --cpu-quick sizes: the JSON
    line with bench_survey_production.py's keys, four scenes."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "torch_survey_production.py"), "--cpu-quick"],
        capture_output=True, text=True, timeout=600, check=True)
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["metric"] == "survey_production" and rec["device"] == "cpu"
    assert set(rec) >= {"unit", "value", "per_scene_s", "phase_s", "scenes", "all_gates_pass"}
    assert len(rec["scenes"]) == 4 and set(rec["phase_s"]) == {"map", "svi", "hmc"}
    for row in rec["scenes"]:
        assert math.isfinite(row["posterior_red_chi2"]) and math.isfinite(row["max_rhat"])
