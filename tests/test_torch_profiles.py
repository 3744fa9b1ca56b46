"""Port profiles (EPL, Shear, SersicEllipse) against the JAX package and the
float64 oracles.

Port vs JAX: float32 on both sides, same inputs from numpy (rtol 1e-5,
atol 1e-5). Port vs oracle: the port in float64 (rtol 1e-9).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles
from gigalens_tpu.profiles.light.sersic import SersicEllipse as JSersicEllipse
from gigalens_tpu.profiles.mass.epl import EPL as JEPL
from gigalens_tpu.profiles.mass.epl import _omega_cs as j_omega_cs
from gigalens_tpu.profiles.mass.shear import Shear as JShear
from gigalens_tpu_torch.profiles.light.sersic import SersicEllipse
from gigalens_tpu_torch.profiles.mass.epl import EPL, omega_cs
from gigalens_tpu_torch.profiles.mass.shear import Shear

RTOL, ATOL = 1e-5, 1e-5  # float32 port vs float32 JAX
RTOL64 = 1e-9  # float64 port vs float64 oracle

EPL_PARAMS = [
    dict(theta_E=1.0, gamma=2.0, e1=0.0, e2=0.0, center_x=0.0, center_y=0.0),
    dict(theta_E=1.2, gamma=2.2, e1=-0.1, e2=0.1, center_x=0.03, center_y=-0.02),
    dict(theta_E=0.9, gamma=1.7, e1=0.2, e2=0.05, center_x=-0.01, center_y=0.04),
]
SERSIC = dict(R_sersic=0.8, n_sersic=2.5, e1=0.1, e2=-0.2, center_x=0.05,
              center_y=-0.02, Ie=5.0)


def _coords(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=n).astype(np.float32), rng.normal(size=n).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _batched_params(seed=1, bs=4):
    """(bs, 1) EPL parameter columns drawn around the bench prior."""
    rng = np.random.default_rng(seed)
    cols = dict(
        theta_E=rng.uniform(1.0, 1.5, bs), gamma=rng.uniform(1.8, 2.2, bs),
        e1=rng.normal(0, 0.1, bs), e2=rng.normal(0, 0.1, bs),
        center_x=rng.normal(0, 0.05, bs), center_y=rng.normal(0, 0.05, bs),
    )
    return {k: v.astype(np.float32)[:, None] for k, v in cols.items()}


@pytest.mark.quick
def test_epl_matches_jax_batched():
    x, y = _coords()
    kw = _batched_params()
    want = JEPL(18).deriv(jnp.asarray(x), jnp.asarray(y),
                          **{k: jnp.asarray(v) for k, v in kw.items()})
    got = EPL(18).deriv(_t(x), _t(y), **{k: _t(v) for k, v in kw.items()})
    for g, w in zip(got, want):
        assert g.shape == (4, 2000)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kw", EPL_PARAMS)
def test_epl_matches_oracle_f64(kw):
    x, y = _coords()
    got = EPL(niter=100).deriv(_t(x, torch.float64), _t(y, torch.float64),
                               **{k: torch.tensor(v, dtype=torch.float64)
                                  for k, v in kw.items()})
    want = oracles.epl_deriv(x.astype(np.float64), y.astype(np.float64),
                             kw["theta_E"], kw["gamma"], kw["e1"], kw["e2"],
                             kw["center_x"], kw["center_y"])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL64, atol=1e-12)


def test_shear_matches_jax_and_oracle():
    x, y = _coords()
    got = Shear().deriv(_t(x), _t(y), gamma1=0.05, gamma2=-0.03)
    want = JShear().deriv(jnp.asarray(x), jnp.asarray(y), gamma1=0.05, gamma2=-0.03)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
    got64 = Shear().deriv(_t(x, torch.float64), _t(y, torch.float64),
                          gamma1=0.05, gamma2=-0.03)
    want64 = oracles.shear_deriv(x.astype(np.float64), y.astype(np.float64), 0.05, -0.03)
    for g, w in zip(got64, want64):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL64, atol=1e-15)


def test_sersic_ellipse_matches_jax_and_oracle():
    x, y = _coords()
    got = SersicEllipse().light(_t(x), _t(y), **{k: torch.tensor(v) for k, v in SERSIC.items()})
    want = JSersicEllipse().light(jnp.asarray(x), jnp.asarray(y), **SERSIC)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    got64 = SersicEllipse().light(
        _t(x, torch.float64), _t(y, torch.float64),
        **{k: torch.tensor(v, dtype=torch.float64) for k, v in SERSIC.items()},
    )
    want64 = oracles.sersic_ellipse_light(
        x.astype(np.float64), y.astype(np.float64), *SERSIC.values()
    )
    np.testing.assert_allclose(got64.numpy(), want64, rtol=RTOL64, atol=1e-12)


def test_omega_cs_vjp_matches_jax():
    """The autograd.Function's O(1)-memory backward against JAX's custom VJP,
    including the f = 0 floor (zero ellipticity)."""
    rng = np.random.default_rng(3)
    bs, n = 3, 500
    th = rng.uniform(-np.pi, np.pi, (bs, n))
    rho = rng.uniform(0.9, 1.1, (bs, n))  # off the unit circle: homogeneity
    ct, st = (rho * np.cos(th)).astype(np.float32), (rho * np.sin(th)).astype(np.float32)
    f = np.array([[0.0], [0.2], [0.4]], np.float32)
    t = rng.uniform(0.8, 1.2, (bs, 1)).astype(np.float32)
    gx, gy = rng.normal(size=(2, bs, n)).astype(np.float32)

    def jf(a, b, c, d):
        ox, oy = j_omega_cs(a, b, c, d, 18)
        return jnp.sum(ox * gx + oy * gy)

    want = jax.grad(jf, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (ct, st, f, t)))
    ins = [torch.tensor(a, requires_grad=True) for a in (ct, st, f, t)]
    ox, oy = omega_cs(*ins, 18)
    got = torch.autograd.grad((ox * _t(gx) + oy * _t(gy)).sum(), ins)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(w)).max())
    assert np.isfinite(got[2].numpy()).all()


def test_epl_gradient_matches_jax():
    """Autograd through EPL.deriv (the series Function inside) against
    jax.grad of the same scalar, per parameter column."""
    x, y = _coords(900, seed=5)
    kw = _batched_params(seed=6, bs=3)
    w = np.random.default_rng(7).normal(size=(2, 3, 900)).astype(np.float32)

    def jl(p):
        ax, ay = JEPL(18).deriv(jnp.asarray(x), jnp.asarray(y), **p)
        return jnp.sum(ax * w[0] + ay * w[1])

    want = jax.grad(jl)({k: jnp.asarray(v) for k, v in kw.items()})
    tp = {k: _t(v).requires_grad_(True) for k, v in kw.items()}
    ax, ay = EPL(18).deriv(_t(x), _t(y), **tp)
    grads = torch.autograd.grad((ax * _t(w[0]) + ay * _t(w[1])).sum(), list(tp.values()))
    for k, g in zip(tp, grads):
        ref = np.asarray(want[k])
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=k)
