"""The port's Laplace initializer and SVI against the JAX package (CPU).

On the conftest demo scene (EPL(30)+Shear, SersicEllipse lens light and
source, 20x20 px at 0.1"/px) with a noisy observation of a seeded truth:
``_floored_inv_chol`` at rtol 1e-4; ``laplace_scale_tril`` at the same
point within a relative Frobenius bound of 2e-4 (exact, measured 2.4e-5)
and 5e-3 (FD, measured 9e-4: each float32 side differences gradients a
step of 1e-3 apart, so its rounding is amplified ~1e3-fold), and FD
against exact within 1e-2 (measured 8.5e-4); the ELBO value and gradient on
shared eps against the JAX ELBO assembled from the JAX package's own
``FillScaleTriL`` and ``log_prob`` at rtol 1e-4; the SVI plumbing checks
of ``tests/test_inference.py``; and F-ref-1 (a non-finite draw leaves
the parameters finite and adds no gradient).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigalens_tpu.inference.map import _floored_inv_chol as j_floored_inv_chol
from gigalens_tpu.inference.map import laplace_scale_tril as j_laplace_scale_tril
from gigalens_tpu.model import ForwardProbModel as JForwardProbModel
from gigalens_tpu.prob.bijectors import FillScaleTriL as JFillScaleTriL
from gigalens_tpu.simulator import LensSimulator as JLensSimulator
from gigalens_tpu_torch.inference import ModellingSequence, fit_svi, optim
from gigalens_tpu_torch.inference.map import _floored_inv_chol, laplace_scale_tril
from gigalens_tpu_torch.inference.svi import elbo_loss, surrogate_unpacker
from gigalens_tpu_torch.interop import (
    phys_model_from_reference, prior_from_reference, sim_config_from_reference,
)
from gigalens_tpu_torch.model import ForwardProbModel
from gigalens_tpu_torch.simulator import LensSimulator

CHOL_RTOL = 1e-4
# relative Frobenius, port vs JAX, same method
LAPLACE_FROB = {"exact": 2e-4, "fd": 5e-3}
FD_VS_EXACT_FROB = 1e-2
ELBO_RTOL = 1e-4
N_VI = 6


@pytest.fixture(scope="module")
def scene(demo_prior, demo_physmodel, small_sim_config):
    jcfg = dataclasses.replace(small_sim_config, use_fused_render=False, psf_mode="fft")
    rng = np.random.default_rng(0)
    z_truth = (rng.standard_normal((1, demo_prior.d)) * 0.3).astype(np.float32)
    img = np.asarray(JLensSimulator(demo_physmodel, jcfg, bs=1).simulate(
        demo_prior.constrain(jnp.asarray(z_truth))))[0]
    obs = (img + rng.normal(size=img.shape) * np.sqrt(0.04 + np.clip(img, 0, None) / 100)
           ).astype(np.float32)
    jprob = JForwardProbModel(demo_prior, obs, background_rms=0.2, exp_time=100.0)
    tprob = ForwardProbModel(prior_from_reference(demo_prior), obs, background_rms=0.2,
                             exp_time=100.0)
    return dict(jcfg=jcfg, tcfg=sim_config_from_reference(jcfg), jphys=demo_physmodel,
                tphys=phys_model_from_reference(demo_physmodel), jprob=jprob, tprob=tprob,
                z=z_truth, d=demo_prior.d, prior=demo_prior)


def _frob(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


@pytest.mark.quick
def test_floored_inv_chol_matches_jax():
    """An indefinite symmetric matrix with one tiny eigenvalue: |lam| and the
    floor at max|lam| * 1e-6 both act."""
    rng = np.random.default_rng(3)
    d = 6
    q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    lam = np.array([40.0, -3.0, 1.5, 1e-9, -0.2, 7.0])
    h = ((q * lam) @ q.T).astype(np.float32)
    want = np.asarray(j_floored_inv_chol(jnp.asarray(h), d, 1e-6))
    got = _floored_inv_chol(torch.tensor(h), d, 1e-6).numpy()
    assert np.isfinite(got).all() and np.all(np.triu(got, 1) == 0)
    np.testing.assert_allclose(got, want, rtol=CHOL_RTOL, atol=CHOL_RTOL * np.abs(want).max())


@pytest.mark.parametrize("method", ["fd", "exact"])
def test_laplace_scale_tril_matches_jax(scene, method):
    d = scene["d"]
    bs = 2 * d if method == "fd" else 1
    want = np.asarray(j_laplace_scale_tril(
        scene["jprob"], JLensSimulator(scene["jphys"], scene["jcfg"], bs=bs),
        jnp.asarray(scene["z"]), method=method))
    got = laplace_scale_tril(scene["tprob"], LensSimulator(scene["tphys"], scene["tcfg"], bs=bs),
                             scene["z"], method=method).numpy()
    assert got.shape == (d, d) and np.isfinite(got).all()
    assert _frob(got, want) < LAPLACE_FROB[method], _frob(got, want)


def test_sequence_laplace_fd_is_close_to_exact(scene):
    """The sequence pins the unfused render and the FFT conv; FD and exact
    agree closely (the JAX package measured ~5% on its bench scene)."""
    seq = ModellingSequence(scene["tphys"], scene["tprob"], scene["tcfg"])
    fd = seq.laplace_scale_tril(scene["z"], method="fd")
    exact = seq.laplace_scale_tril(scene["z"], method="exact")
    assert isinstance(fd, np.ndarray) and fd.shape == (scene["d"],) * 2
    assert _frob(fd, exact) < FD_VS_EXACT_FROB, _frob(fd, exact)
    with pytest.raises(ValueError, match="method"):
        laplace_scale_tril(scene["tprob"], LensSimulator(scene["tphys"], scene["tcfg"], bs=1),
                           scene["z"], method="bogus")


def _jax_elbo(jprob, jsim, d, eps):
    """The JAX package's ELBO (svi.py's elbo_loss) on given eps, assembled
    from its own FillScaleTriL and log_prob."""
    cov_bij = JFillScaleTriL(d, diag_shift=1e-6)

    def loss(params):
        mean, tril = params[:d], cov_bij.forward(params[d:])
        z = mean + eps @ tril.T
        lp_q = (-0.5 * jnp.sum(eps**2, axis=-1) - jnp.sum(jnp.log(jnp.abs(jnp.diagonal(tril))))
                - 0.5 * d * jnp.log(2 * jnp.pi))
        val = lp_q - jprob.log_prob(jsim, z)[0]
        finite = jnp.isfinite(val)
        return jnp.sum(jnp.where(finite, val, 0.0)) / jnp.maximum(jnp.sum(finite), 1)

    return jax.value_and_grad(loss)


@pytest.mark.parametrize("fused", [False, True])
def test_elbo_value_and_grad_match_jax(scene, fused):
    d = scene["d"]
    rng = np.random.default_rng(4)
    L = np.tril(rng.standard_normal((d, d)) * 0.01, -1) + np.diag(np.full(d, 0.05))
    params = np.concatenate([scene["z"][0], np.asarray(JFillScaleTriL(d).inverse(
        jnp.asarray(L, jnp.float32)))]).astype(np.float32)
    eps = rng.standard_normal((N_VI, d)).astype(np.float32)
    val_j, grad_j = _jax_elbo(scene["jprob"], JLensSimulator(scene["jphys"], scene["jcfg"],
                                                             bs=N_VI), d, jnp.asarray(eps))(
        jnp.asarray(params))
    sim = LensSimulator(scene["tphys"], dataclasses.replace(scene["tcfg"],
                                                            use_fused_render=fused), bs=N_VI)
    p = torch.tensor(params, requires_grad=True)
    mean, tril = surrogate_unpacker(d)(p)
    val = elbo_loss(scene["tprob"], sim, mean, tril, torch.tensor(eps))
    (grad,) = torch.autograd.grad(val, p)
    np.testing.assert_allclose(float(val.detach()), float(val_j), rtol=ELBO_RTOL)
    grad_j = np.asarray(grad_j)
    np.testing.assert_allclose(grad.numpy(), grad_j, rtol=ELBO_RTOL,
                               atol=ELBO_RTOL * np.abs(grad_j).max())


def _adam(lr):
    return optim.chain(optim.scale_by_adam(), optim.scale_by_schedule(lambda count: -lr))


@pytest.fixture(scope="module")
def seq(scene):
    return ModellingSequence(scene["tphys"], scene["tprob"], scene["tcfg"])


def test_svi_zero_lr_keeps_mean(seq, scene):
    q_z, losses = seq.SVI(scene["z"], _adam(0.0), n_vi=4, num_steps=3)
    np.testing.assert_allclose(q_z.mean().numpy(), scene["z"][0], rtol=1e-6)
    assert losses.shape == (3,) and torch.isfinite(losses).all()


def test_svi_nonzero_lr_moves(seq, scene):
    calls = []
    q_z, _ = seq.SVI(scene["z"], _adam(1e-3), n_vi=4, num_steps=3, segment_steps=2,
                     progress=lambda step, value: calls.append((step, value)))
    assert not np.allclose(q_z.mean().numpy(), scene["z"][0])
    assert [c[0] for c in calls] == [2, 3] and all(math.isfinite(c[1]) for c in calls)


def test_mean_field_init_uses_row_norms(seq, scene):
    """A matrix init_scales gives the mean-field surrogate its row norms
    (the marginal stddevs), not |diag(L)|."""
    d = scene["d"]
    L = np.tril(np.full((d, d), 0.02, np.float32), -1) + np.eye(d, dtype=np.float32) * 0.01
    q_z, _ = seq.SVI(scene["z"], _adam(0.0), n_vi=4, num_steps=0, init_scales=L,
                     full_rank=False)
    diag = torch.diagonal(q_z.scale_tril).numpy()
    np.testing.assert_allclose(diag, np.linalg.norm(L, axis=-1) + 1e-6, rtol=1e-5)
    assert np.count_nonzero(q_z.scale_tril.numpy() - np.diag(diag)) == 0


class _CliffModel:
    """A standard-normal posterior with a cliff: log_prob is NaN (and so is
    its gradient) wherever z[0] < -1."""

    class prior:
        d = 3

    def log_prob(self, simulator, z):
        lp = -0.5 * torch.sum(z**2, dim=-1) + 0.0 * torch.sqrt(z[:, 0] + 1.0)
        return lp, lp


class _CpuSim:
    device = torch.device("cpu")


def test_non_finite_draw_leaves_parameters_finite():
    """F-ref-1: a draw over the cliff is masked in the loss and adds no
    gradient, so the step is the step of the finite draws alone."""
    model, sim = _CliffModel(), _CpuSim()
    p = torch.tensor([-0.5, 0.0, 0.2, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], requires_grad=True)
    eps = torch.tensor([[-2.0, 0.1, 0.3], [0.4, -0.2, 0.1], [0.2, 0.5, -0.7]])
    mean, tril = surrogate_unpacker(3)(p)
    loss = elbo_loss(model, sim, mean, tril, eps)
    (grad,) = torch.autograd.grad(loss, p)
    assert torch.isfinite(loss) and torch.isfinite(grad).all()
    p2 = p.detach().clone().requires_grad_(True)
    mean, tril = surrogate_unpacker(3)(p2)
    (want,) = torch.autograd.grad(elbo_loss(model, sim, mean, tril, eps[1:]), p2)
    np.testing.assert_allclose(grad.numpy(), want.numpy(), rtol=1e-6, atol=1e-7)

    # a full fit with a start next to the cliff stays finite
    q_z, losses = fit_svi(model, sim, [-0.5, 0.0, 0.2], _adam(1e-2), n_vi=64,
                          init_scales=0.6, num_steps=5, seed=0)
    assert torch.isfinite(q_z.loc).all() and torch.isfinite(q_z.scale_tril).all()
    assert torch.isfinite(losses).all()
