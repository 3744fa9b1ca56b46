"""F-ref-7 and the dpie arm's MAP starts (config #5,
scripts/bench_cluster_posterior.py) against the JAX package.

F-ref-7 (logged as F-port-9 before it was traced to the reference's own
float32 solve): config #5's sie arm solves 15 shapelet amplitudes a sample by
the normal equations (``simulator._lstsq_coeffs``), whose Gram squares the
components' condition number: about the script's own truth its kept
singular values span 1e6 and more, where a float32 Gram and solve give a
z-gradient 1e3-1e6 times off the float64 one, in either package (JAX's
float32 gradient against its float64 one, measured here), and torch's
derivative of the pseudo-inverse through the SVD adds NaN where two
dropped singular values meet. The port departs from the package there: it solves in float64 with the
JAX package's derivative of ``pinv`` (Golub-Pereyra, ``simulator.pinv``),
so it is held against JAX run in float64 (``jax.enable_x64``), not against
the float32 package:

- ``simulator.pinv`` against ``jax.vjp`` of ``jnp.linalg.pinv(rcond=1e-6)``
  on 15 x 15 Grams with two vanished components, a duplicated one, and
  singular values near the cutoff, in float32 and float64 on both sides:
  float64 to 1e-9 (values) and 1e-7 (gradients) of the largest entry;
  float32 to 2e-3 / 2e-2, the float32 epsilon times the kept part's
  condition number (1e4 for the near-cutoff Gram in float32);
- the sie arm's log_prob and its z-gradient at four points about the
  script's truth (48 px, 20 NIE members) against JAX's in float64: the
  log-density rtol 1e-5, the gradient 2e-4 of each row's largest (the
  port renders and sums ~2,000 nats in float32: measured 2.2e-6 and
  2.6e-5);
- the ELBO and its gradient over the surrogate's parameters, one SVI step
  of that scene with the same 4 draws fed to both, the same bounds.

The dpie arm's starts: ``bench.CL_JAX_STARTS`` is JAX's
own draw (``scripts/cluster_jax_starts.py``), to float32 rounding.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigalens_tpu.prob.bijectors import FillScaleTriL as JFillScaleTriL
from gigalens_tpu.simulator import LensSimulator as JLensSimulator
from gigalens_tpu_torch import bench
from gigalens_tpu_torch.inference.svi import elbo_loss, surrogate_unpacker
from gigalens_tpu_torch.simulator import LensSimulator, pinv

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT / "tests"))

import cluster_jax_starts  # noqa: E402
import test_torch_cluster_arms as arms  # noqa: E402

PINV_TOL = {"float64": (1e-9, 1e-7), "float32": (2e-3, 2e-2)}
LP_RTOL, GRAD_REL = 1e-5, 2e-4
N = 4  # points about the truth, and SVI draws


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gram(case, dtype):
    """A 15 x 15 Gram of the named kind (float64 numpy, then ``dtype``)."""
    rng = np.random.default_rng(11)
    if case in ("vanished", "duplicated"):
        X = rng.standard_normal((200, 15))
        if case == "vanished":
            X[:, [3, 11]] = 0.0  # two components with no pixels
        else:
            X[:, 14] = X[:, 13]  # two components alike
        return (X.T @ X).astype(dtype)
    Q, _ = np.linalg.qr(rng.standard_normal((15, 15)))
    s = np.geomspace(1.0, 1e-3, 15)
    # one kept and one dropped value about the 1e-6 cutoff, kept well above
    # float32's rounding in float32
    s[-2:] = (1e-4, 1e-8) if dtype == np.float32 else (2e-6, 5e-7)
    return ((Q * s) @ Q.T).astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", ["vanished", "duplicated", "near_cutoff"])
def test_pinv_value_and_gradient_match_jax(case, dtype):
    a = _gram(case, getattr(np, dtype))
    g = np.random.default_rng(12).standard_normal(a.shape).astype(a.dtype)
    with jax.enable_x64(dtype == "float64"):
        p_j, vjp = jax.vjp(lambda m: jnp.linalg.pinv(m, rcond=1e-6), jnp.asarray(a))
        (grad_j,) = vjp(jnp.asarray(g))
        p_j, grad_j = np.asarray(p_j), np.asarray(grad_j)
    t = torch.tensor(a, requires_grad=True)
    p = pinv(t, 1e-6)
    (grad,) = torch.autograd.grad(p, t, torch.tensor(g))
    assert p.dtype == t.dtype and torch.isfinite(grad).all()
    vtol, gtol = PINV_TOL[dtype]
    np.testing.assert_allclose(p.detach().numpy(), p_j, rtol=0, atol=vtol * np.abs(p_j).max())
    np.testing.assert_allclose(grad.numpy(), grad_j, rtol=0, atol=gtol * np.abs(grad_j).max())


@pytest.fixture(scope="module")
def sie():
    """The sie arm at the script's truth (48 px, 20 members, lstsq
    source), its JAX twin, and N points about the truth."""
    sc = bench.cluster_scene("sie", source="lstsq", device="cpu", truth=bench.CL_JAX_TRUTH["sie"])
    G = arms.G
    arms.G = 20
    try:
        jphys, jcfg, jprob = arms.jax_arm("sie", sc)
    finally:
        arms.G = G
    truth = dict(sc.truth, source_light=[{k: v for k, v in sc.truth["source_light"][0].items()
                                          if k in ("beta", "center_x", "center_y")}])
    z0 = sc.prior.unconstrain(truth).numpy()
    z = z0 + 0.05 * np.random.default_rng(9).standard_normal((N, z0.shape[-1]))
    return sc, jphys, jcfg, jprob, z.astype(np.float32)


def test_sie_lstsq_log_prob_and_z_gradient_match_jax_in_float64(sie):
    sc, jphys, jcfg, jprob, z = sie
    with jax.enable_x64(True):
        jsim = JLensSimulator(jphys, jcfg, bs=N)
        # the rows are independent: the gradient of their sum is each row's
        (_, lp_j), g_j = jax.jit(jax.value_and_grad(
            lambda zz: (lambda lp: (jnp.sum(lp), lp))(jprob.log_prob(jsim, zz)[0]),
            has_aux=True))(jnp.asarray(z, jnp.float64))
        lp_j, g_j = np.asarray(lp_j), np.asarray(g_j)
    zz = torch.tensor(z, requires_grad=True)
    lp = sc.prob.log_prob(LensSimulator(sc.phys, sc.cfg, bs=N, device="cpu"), zz)[0]
    (g,) = torch.autograd.grad(lp.sum(), zz)
    np.testing.assert_allclose(lp.detach().numpy(), lp_j, rtol=LP_RTOL)
    err = np.abs(g.numpy() - g_j).max(-1) / np.abs(g_j).max(-1)
    assert (err < GRAD_REL).all(), err


def test_sie_lstsq_svi_step_matches_jax_in_float64(sie):
    """The ELBO (svi.py's elbo_loss) and its gradient over [mean,
    FillScaleTriL^-1(L)] with the same draws on both sides."""
    sc, jphys, jcfg, jprob, z = sie
    d = z.shape[-1]
    rng = np.random.default_rng(4)
    L = np.tril(rng.standard_normal((d, d)) * 0.005, -1) + np.diag(np.full(d, 0.02))
    eps = rng.standard_normal((N, d))
    with jax.enable_x64(True):
        cov_bij = JFillScaleTriL(d, diag_shift=1e-6)
        params = np.concatenate([z[0].astype(np.float64),
                                 np.asarray(cov_bij.inverse(jnp.asarray(L)))])
        jsim = JLensSimulator(jphys, jcfg, bs=N)
        e = jnp.asarray(eps)

        def loss(p):
            mean, tril = p[:d], cov_bij.forward(p[d:])
            zz = mean + e @ tril.T
            lp_q = (-0.5 * jnp.sum(e**2, axis=-1) - jnp.sum(jnp.log(jnp.abs(jnp.diagonal(tril))))
                    - 0.5 * d * jnp.log(2 * jnp.pi))
            val = lp_q - jprob.log_prob(jsim, zz)[0]
            finite = jnp.isfinite(val)
            return jnp.sum(jnp.where(finite, val, 0.0)) / jnp.maximum(jnp.sum(finite), 1)

        val_j, grad_j = jax.jit(jax.value_and_grad(loss))(jnp.asarray(params))
        val_j, grad_j = float(val_j), np.asarray(grad_j)
    p = torch.tensor(params.astype(np.float32), requires_grad=True)
    mean, tril = surrogate_unpacker(d)(p)
    val = elbo_loss(sc.prob, LensSimulator(sc.phys, sc.cfg, bs=N, device="cpu"), mean, tril,
                    torch.tensor(eps, dtype=torch.float32))
    (grad,) = torch.autograd.grad(val, p)
    np.testing.assert_allclose(float(val.detach()), val_j, rtol=LP_RTOL)
    np.testing.assert_allclose(grad.numpy(), grad_j, rtol=0,
                               atol=GRAD_REL * np.abs(grad_j).max())


def test_dpie_jax_starts_are_jax_draw():
    """The committed starts are the JAX script's MAP starts: the dpie
    prior's draw at PRNGKey(0), unconstrained."""
    np.testing.assert_allclose(np.load(bench.CL_JAX_STARTS), cluster_jax_starts.jax_starts(),
                               rtol=1e-6, atol=1e-6)
