"""K3's plain version in its two stages (per-pixel terms of per-sample
quantities, then a per-sample epilogue) against torch autograd in float64
and the JAX package's ``_fused_bwd`` in interpret mode; and the port's
entry points refusing to run on the CPU unless asked.

Sizes follow tests/test_torch_fused_render.py (bs 3, 30x30 at supersample
2, niter 18). Tolerances: 1e-10 of each column's max in float64 (the two
stages are the VJP's own algebra rearranged, so only rounding separates
them); 1e-3 of each column's max against JAX (float32 on both sides, the
existing bound of the fused-render tests).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigalens_tpu.ops.pallas import fused_render as jfr
from gigalens_tpu_torch.interop import tree_to_torch
from gigalens_tpu_torch.ops.cuda import fused_render as fr

NITER = 18


def _col_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max(0) / np.maximum(np.abs(want).max(0), 1e-30)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    bs = 3

    def rnd(lo, hi):
        return rng.uniform(lo, hi, bs).astype(np.float32)

    params = dict(
        lens_mass=[
            dict(theta_E=rnd(1.0, 1.5), gamma=rnd(1.8, 2.2), e1=rnd(0.02, 0.1),
                 e2=rnd(-0.1, -0.02), center_x=rnd(-0.02, 0.02), center_y=rnd(-0.02, 0.02)),
            dict(gamma1=rnd(-0.05, 0.05), gamma2=rnd(-0.05, 0.05)),
        ],
        lens_light=[dict(R_sersic=rnd(0.8, 1.2), n_sersic=rnd(2, 4), e1=rnd(-0.15, -0.05),
                         e2=rnd(0.02, 0.1), center_x=rnd(-0.02, 0.02),
                         center_y=rnd(-0.02, 0.02), Ie=rnd(80, 120))],
        source_light=[dict(R_sersic=rnd(0.2, 0.3), n_sersic=rnd(1, 2), e1=rnd(0.02, 0.1),
                           e2=rnd(-0.1, 0.1), center_x=rnd(0, 0.1), center_y=rnd(-0.1, 0),
                           Ie=rnd(40, 60))],
    )
    xs = ((np.arange(60) - 29.5) * 0.0325).astype(np.float32)
    X, Y = np.meshgrid(xs, xs)
    ct = rng.normal(size=(bs, 3600)).astype(np.float32)
    return dict(p=fr.pack_params(tree_to_torch(params, device="cpu")), x=torch.tensor(X.ravel()),
                y=torch.tensor(Y.ravel()), ct=torch.tensor(ct))


@pytest.mark.quick
@pytest.mark.parametrize("e1_sign", [1.0, -1.0])
def test_two_stage_twin_matches_autograd_f64(setup, e1_sign):
    """Both branches of the half-angle rotation (e1 >= 0 and e1 < 0)."""
    p = setup["p"].double().clone()
    p[:, [2, 10, 17]] = e1_sign * p[:, [2, 10, 17]].abs()
    x, y, ct = setup["x"].double(), setup["y"].double(), setup["ct"].double()
    pg = p.clone().requires_grad_(True)
    (want,) = torch.autograd.grad((fr.fused_render_reference(pg, x, y, NITER) * ct).sum(), pg)
    _, ox, oy = fr.fused_render_fwd_reference(p, x, y, NITER)
    terms = fr.bwd_pixel_terms(p, x, y, ox, oy, ct, NITER)
    assert len(terms) == fr.N_SUMS
    sums = torch.stack([torch.broadcast_to(t, ct.shape).sum(-1) for t in terms], -1)
    got = fr.bwd_epilogue(p, sums)
    assert got.shape == (3, fr.N_PARAMS)
    assert _col_rel(got.numpy(), want.numpy()).max() <= 1e-10
    np.testing.assert_array_equal(
        fr.fused_render_bwd_reference(p, x, y, ox, oy, ct, NITER).numpy(), got.numpy())


def test_two_stage_twin_matches_jax_fused_bwd(setup):
    """float32 against the Pallas backward kernel in interpret mode, fed the
    same residuals (Omega from its own forward kernel)."""
    p_j = jnp.asarray(setup["p"].numpy())
    x_j, y_j = jnp.asarray(setup["x"].numpy()), jnp.asarray(setup["y"].numpy())
    _, res = jfr._fused_fwd(p_j, x_j, y_j, NITER, True)
    want = np.asarray(jfr._fused_bwd(NITER, True, res, jnp.asarray(setup["ct"].numpy()))[0])
    _, ox, oy = fr.fused_render_fwd_reference(setup["p"], setup["x"], setup["y"], NITER)
    got = fr.fused_render_bwd_reference(setup["p"], setup["x"], setup["y"], ox, oy,
                                        setup["ct"], NITER)
    assert _col_rel(got.numpy(), want).max() <= 1e-3


def test_epilogue_is_linear_in_the_sums(setup):
    """The epilogue's map from sums to gradients is linear (what lets the
    kernel reduce the sums before applying it)."""
    p = setup["p"].double()
    rng = np.random.default_rng(2)
    a, b = (torch.tensor(rng.normal(size=(3, fr.N_SUMS))) for _ in range(2))
    lhs = fr.bwd_epilogue(p, 2.0 * a - 3.0 * b)
    rhs = 2.0 * fr.bwd_epilogue(p, a) - 3.0 * fr.bwd_epilogue(p, b)
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), rtol=1e-12, atol=1e-12)


def test_niter_cap_raises_before_launch(setup):
    meta = setup["p"].to("meta")
    xm = setup["x"].to("meta")
    with pytest.raises(ValueError, match="niter"):
        fr.fused_render_bwd(meta, xm, xm, xm, xm, xm, fr.MAX_NITER + 1)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(demo_prior, demo_physmodel,
                                                           small_sim_config):
    """device=None means the CUDA card: without one every entry point
    raises and names device="cpu"; it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None selects it")
    from gigalens_tpu_torch.inference import ModellingSequence
    from gigalens_tpu_torch.inference.sequence import phase_simulator
    from types import SimpleNamespace

    from gigalens_tpu_torch.interop import (mvn_from_reference, phys_model_from_reference,
                                            prior_from_reference, sim_config_from_reference)
    from gigalens_tpu_torch.model import BackwardProbModel, ForwardProbModel
    from gigalens_tpu_torch.simulator import LensSimulator

    prior = prior_from_reference(demo_prior)
    phys = phys_model_from_reference(demo_physmodel)
    cfg = sim_config_from_reference(small_sim_config)
    obs = np.zeros((20, 20), np.float32)
    calls = [
        lambda: LensSimulator(phys, cfg, bs=1),
        lambda: ForwardProbModel(prior, obs, background_rms=0.1, exp_time=100.0),
        lambda: BackwardProbModel(prior, obs, background_rms=0.1, exp_time=100.0),
        lambda: phase_simulator({}, cfg, phys, 1),
        lambda: tree_to_torch({"a": [np.zeros(2)]}),
        lambda: mvn_from_reference(SimpleNamespace(loc=np.zeros(2), scale_tril=np.eye(2))),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    prob = ForwardProbModel(prior, obs, background_rms=0.1, exp_time=100.0, device="cpu")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ModellingSequence(phys, prob, cfg)
    assert ModellingSequence(phys, prob, cfg, device="cpu").device.type == "cpu"
    assert tree_to_torch({"a": [np.zeros(2)]}, device="cpu")["a"][0].device.type == "cpu"
    q = mvn_from_reference(SimpleNamespace(loc=np.zeros(2), scale_tril=np.eye(2)), device="cpu")
    assert q.scale_tril.device.type == "cpu"
