"""Repairs of four small differences between the port and the JAX package:
the attributes the inference routines read off a probabilistic model, the
device rule of the multivariate normals, the message for a per-scene PSF
stack, and the single-plane check of both fused tiers. Values are held to
the JAX side at rtol 1e-5 (float32 on both sides, the same arrays)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigalens_tpu.model import BackwardProbModel as JBackwardProbModel
from gigalens_tpu.model import ForwardProbModel as JForwardProbModel
from gigalens_tpu_torch import PhysicalModel
from gigalens_tpu_torch.bench import bench_prior
from gigalens_tpu_torch.config import SimulatorConfig
from gigalens_tpu_torch.interop import prior_from_reference
from gigalens_tpu_torch.model import BackwardProbModel, ForwardProbModel
from gigalens_tpu_torch.ops.cuda.fused_builder import build_spec
from gigalens_tpu_torch.prob import distributions as tdist
from gigalens_tpu_torch.profiles.light import SersicEllipse, Shapelets
from gigalens_tpu_torch.profiles.mass import EPL, Shear
from gigalens_tpu_torch.simulator import LensSimulator

RTOL = 1e-5


def _models(kind, demo_prior):
    obs = np.random.default_rng(0).random((20, 20)).astype(np.float32)
    jcls, tcls = ((JForwardProbModel, ForwardProbModel) if kind == "forward"
                  else (JBackwardProbModel, BackwardProbModel))
    jprob = jcls(demo_prior, obs, background_rms=0.2, exp_time=100.0)
    tprob = tcls(prior_from_reference(demo_prior), obs, background_rms=0.2, exp_time=100.0,
                 device="cpu")
    return jprob, tprob


@pytest.mark.quick
@pytest.mark.parametrize("kind", ["forward", "backward"])
def test_prob_model_has_what_the_samplers_read(kind, demo_prior):
    """include_pixels / include_positions / n_position, init_centroids and
    log_prior equal the JAX model's on the same z."""
    jprob, tprob = _models(kind, demo_prior)
    for name in ("include_pixels", "include_positions", "n_position"):
        assert getattr(tprob, name) == getattr(jprob, name), name
    assert tprob.init_centroids(4) is None and jprob.init_centroids(4) is None
    z = (np.random.default_rng(1).standard_normal((5, demo_prior.d)) * 0.5).astype(np.float32)
    np.testing.assert_allclose(tprob.log_prior(torch.tensor(z)).numpy(),
                               np.asarray(jprob.log_prior(jnp.asarray(z))), rtol=RTOL)


def test_forward_model_bij_is_the_prior_facade(demo_prior):
    """bij.forward is constrain and bij.inverse unconstrain, leaf by leaf
    against the JAX facade."""
    jprob, tprob = _models("forward", demo_prior)
    z = (np.random.default_rng(2).standard_normal((3, demo_prior.d)) * 0.5).astype(np.float32)
    jx, tx = jprob.bij.forward(jnp.asarray(z)), tprob.bij.forward(torch.tensor(z))
    for group, profiles in jx.items():
        for jp, tp in zip(profiles, tx[group]):
            for name, leaf in jp.items():
                np.testing.assert_allclose(tp[name].numpy(), np.asarray(leaf), rtol=RTOL,
                                           err_msg=f"{group}.{name}")
    back = tprob.bij.inverse(tx)
    np.testing.assert_allclose(back.numpy(), np.asarray(jprob.bij.inverse(jx)), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(back.numpy(), z, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("make", [
    lambda loc, **kw: tdist.MultivariateNormalTriL(loc, np.eye(3, dtype=np.float32), **kw),
    lambda loc, **kw: tdist.MultivariateNormalFullCovariance(loc, np.eye(3, dtype=np.float32), **kw),
    lambda loc, **kw: tdist.MultivariateNormalDiag(loc, np.ones(3, np.float32), **kw),
], ids=["tril", "full_covariance", "diag"])
def test_mvn_device_follows_the_entry_point_rule(make):
    """A non-tensor loc with device=None means the CUDA card (an error that
    names device="cpu" without one), never the CPU; a tensor loc keeps its
    own device; a named device is taken."""
    loc = np.zeros(3, np.float32)
    if torch.cuda.is_available():
        assert make(loc).loc.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make(loc)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make([0.0, 0.0, 0.0])
    assert make(loc, device="cpu").scale_tril.device.type == "cpu"
    assert make(torch.zeros(3)).scale_tril.device.type == "cpu"


def test_psf_stack_names_the_survey_module():
    """A (3, 5, 5) per-scene PSF stack builds (each kernel supersampled on
    its own, no broadcast error in the subgrid resampling) and refuses a
    batch that is not a multiple of its 3 scenes."""
    phys = PhysicalModel([EPL(18), Shear()], [SersicEllipse()], [SersicEllipse()])
    g = np.exp(-((np.arange(5) - 2) ** 2 + (np.arange(5)[:, None] - 2) ** 2) / 2.0)
    stack = np.stack([g / g.sum()] * 3).astype(np.float32)
    cfg = SimulatorConfig(delta_pix=0.1, num_pix=20, supersample=2, kernel=stack)
    sim = LensSimulator(phys, cfg, bs=3, device="cpu")
    assert sim._conv.n_scenes == 3 and sim._conv.kernel.shape == (3, 11, 11)
    params = bench_prior().sample(torch.Generator().manual_seed(0), 4)
    with pytest.raises(ValueError, match="multiple of n_scenes=3"):
        LensSimulator(phys, cfg, bs=4, device="cpu").simulate(params)


@pytest.mark.parametrize("family", ["bench_pattern", "builder"])
def test_multi_plane_model_takes_the_unfused_tier(family):
    """mp_factors on the model (multi-plane ray tracing) keeps it off both
    fused tiers, as in JAX; the same model without it is fused."""
    source = SersicEllipse() if family == "bench_pattern" else Shapelets(3)
    phys = PhysicalModel([EPL(18), Shear()], [SersicEllipse()], [source])
    cfg = SimulatorConfig(delta_pix=0.1, num_pix=20, supersample=1, use_fused_render=True)
    sim = LensSimulator(phys, cfg, bs=2, device="cpu")
    assert sim._use_fused
    assert (sim._fused_niter is not None) == (family == "bench_pattern")
    assert (sim._fused_spec is not None) == (family == "builder")
    multi = PhysicalModel([EPL(18), Shear()], [SersicEllipse()], [source],
                          lens_redshifts=[0.5, 0.5], z_source=2.0)
    assert multi.mp_factors is not None
    assert LensSimulator._detect_fused_pattern(multi) is None
    assert build_spec(multi) is None
    sim = LensSimulator(multi, cfg, bs=2, device="cpu")
    assert not sim._use_fused and sim._fused_niter is None and sim._fused_spec is None
    assert LensSimulator(phys, cfg, bs=2, device="cpu")._use_fused
