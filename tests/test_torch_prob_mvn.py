"""The port's SVI-side prob stack against the JAX package (CPU).

FillScaleTriL (forward, inverse, fldj and its row-major fill order) and
the other new bijectors at rtol 1e-6 (atol 2e-7 where a float32 sum of
O(1) terms can differ in order); the multivariate normals' log_prob
and reparameterized sample (on shared eps) and HalfNormal at rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigalens_tpu.prob import bijectors as jbij
from gigalens_tpu.prob import distributions as jdist
from gigalens_tpu.prob import Prior as JPrior
from gigalens_tpu_torch.interop import mvn_from_reference, prior_from_reference
from gigalens_tpu_torch.prob import bijectors as tbij
from gigalens_tpu_torch.prob import distributions as tdist

BIJ_RTOL = 1e-6
MVN_RTOL = 1e-5
D = 5


def _vec(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.quick
def test_fill_order_is_row_major_and_matches_jax():
    vec = np.arange(1, 7, dtype=np.float32)
    got = tbij.fill_triangular(torch.tensor(vec), 3).numpy()
    np.testing.assert_array_equal(got, [[1, 0, 0], [2, 3, 0], [4, 5, 6]])
    np.testing.assert_array_equal(got, np.asarray(jbij.fill_triangular(jnp.asarray(vec), 3)))
    back = tbij.fill_triangular_inverse(torch.tensor(got)).numpy()
    np.testing.assert_array_equal(back, vec)


@pytest.mark.parametrize("batch", [(), (3,), (2, 4)])
def test_fill_scale_tril_matches_jax(batch):
    rng = np.random.default_rng(0)
    z = _vec(rng, *batch, D * (D + 1) // 2)
    jb, tb = jbij.FillScaleTriL(D), tbij.FillScaleTriL(D)
    want = np.asarray(jb.forward(jnp.asarray(z)))
    got = tb.forward(torch.tensor(z)).numpy()
    np.testing.assert_allclose(got, want, rtol=BIJ_RTOL, atol=1e-7)
    assert np.all(np.triu(got, 1) == 0) and np.all(np.diagonal(got, axis1=-2, axis2=-1) > 0)
    np.testing.assert_allclose(tb.inverse(torch.tensor(got)).numpy(),
                               np.asarray(jb.inverse(jnp.asarray(want))), rtol=BIJ_RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(tb.inverse(torch.tensor(got)).numpy(), z, rtol=1e-5, atol=1e-5)
    # fldj sums d O(1) terms: float32 summation order differs by an ulp
    np.testing.assert_allclose(tb.fldj(torch.tensor(z)).numpy(),
                               np.asarray(jb.forward_log_det_jacobian(jnp.asarray(z))),
                               rtol=BIJ_RTOL, atol=2e-7)


def _bijector_pairs():
    return [
        ("softplus", jbij.Softplus(), tbij.Softplus()),
        ("softplus_shift", jbij.Softplus(0.3), tbij.Softplus(0.3)),
        ("scale", jbij.Scale(-2.5), tbij.Scale(-2.5)),
        ("shift", jbij.Shift(1.5), tbij.Shift(1.5)),
        ("chain", jbij.Chain([jbij.Shift(0.5), jbij.Scale(2.0), jbij.Softplus()]),
         tbij.Chain([tbij.Shift(0.5), tbij.Scale(2.0), tbij.Softplus()])),
    ]


@pytest.mark.parametrize("name,jb,tb", _bijector_pairs(), ids=[p[0] for p in _bijector_pairs()])
def test_elementwise_bijectors_match_jax(name, jb, tb):
    z = np.linspace(-4.0, 4.0, 17, dtype=np.float32)
    x = np.asarray(jb.forward(jnp.asarray(z)))
    np.testing.assert_allclose(tb.forward(torch.tensor(z)).numpy(), x, rtol=BIJ_RTOL)
    np.testing.assert_allclose(tb.inverse(torch.tensor(x)).numpy(),
                               np.asarray(jb.inverse(jnp.asarray(x))), rtol=BIJ_RTOL, atol=1e-6)
    np.testing.assert_allclose(tb.fldj(torch.tensor(z)).numpy(),
                               np.asarray(jb.forward_log_det_jacobian(jnp.asarray(z))),
                               rtol=BIJ_RTOL, atol=1e-7)


def _mvn_params(rng):
    loc = _vec(rng, D)
    a = _vec(rng, D, D)
    tril = np.tril(a, -1) * 0.3 + np.diag(np.exp(_vec(rng, D) * 0.5))
    return loc, tril.astype(np.float32)


def test_mvn_tril_log_prob_and_moments_match_jax():
    rng = np.random.default_rng(1)
    loc, tril = _mvn_params(rng)
    x = _vec(rng, 2, 6, D)
    jq = jdist.MultivariateNormalTriL(loc, tril)
    tq = tdist.MultivariateNormalTriL(loc, tril, device="cpu")
    np.testing.assert_allclose(tq.log_prob(torch.tensor(x)).numpy(),
                               np.asarray(jq.log_prob(jnp.asarray(x))), rtol=MVN_RTOL)
    np.testing.assert_allclose(tq.covariance().numpy(), np.asarray(jq.covariance()),
                               rtol=MVN_RTOL, atol=1e-6)
    np.testing.assert_array_equal(tq.mean().numpy(), np.asarray(jq.mean()))


def test_mvn_sample_on_shared_eps_matches_jax():
    """sample() is loc + eps @ L^T on the generator's normal draws."""
    rng = np.random.default_rng(2)
    loc, tril = _mvn_params(rng)
    tq = tdist.MultivariateNormalTriL(loc, tril, device="cpu")
    got = tq.sample(torch.Generator().manual_seed(7), (9,))
    eps = torch.randn((9, D), generator=torch.Generator().manual_seed(7)).numpy()
    want = np.asarray(jnp.asarray(loc) + jnp.asarray(eps) @ jnp.asarray(tril).T)
    assert got.shape == (9, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=MVN_RTOL, atol=1e-6)
    # the JAX sample follows the same formula on its own eps
    js = np.asarray(jdist.MultivariateNormalTriL(loc, tril).sample(jax.random.PRNGKey(0), (4,)))
    jeps = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (4, D)))
    np.testing.assert_allclose(js, loc + jeps @ tril.T, rtol=MVN_RTOL, atol=1e-6)


def test_mvn_full_covariance_and_diag_match_jax():
    rng = np.random.default_rng(3)
    loc, tril = _mvn_params(rng)
    cov = tril @ tril.T
    x = _vec(rng, 7, D)
    jf, tf = (jdist.MultivariateNormalFullCovariance(loc, cov),
              tdist.MultivariateNormalFullCovariance(loc, cov, device="cpu"))
    np.testing.assert_allclose(tf.scale_tril.numpy(), np.asarray(jf.scale_tril), rtol=MVN_RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(tf.log_prob(torch.tensor(x)).numpy(),
                               np.asarray(jf.log_prob(jnp.asarray(x))), rtol=MVN_RTOL)
    diag = np.exp(_vec(rng, D) * 0.3)
    jd = jdist.MultivariateNormalDiag(loc, diag)
    td = tdist.MultivariateNormalDiag(loc, diag, device="cpu")
    np.testing.assert_allclose(td.log_prob(torch.tensor(x)).numpy(),
                               np.asarray(jd.log_prob(jnp.asarray(x))), rtol=MVN_RTOL)


def test_mvn_from_reference_carries_loc_and_factor():
    rng = np.random.default_rng(4)
    loc, tril = _mvn_params(rng)
    q = mvn_from_reference(jdist.MultivariateNormalTriL(jnp.asarray(loc), jnp.asarray(tril)),
                           device="cpu")
    assert isinstance(q, tdist.MultivariateNormalTriL)
    np.testing.assert_array_equal(q.loc.numpy(), loc)
    np.testing.assert_array_equal(q.scale_tril.numpy(), tril)


def test_half_normal_matches_jax_and_ports_in_a_prior():
    x = np.array([-0.5, 0.0, 0.1, 1.0, 3.0], np.float32)
    jd, td = jdist.HalfNormal(1.7), tdist.HalfNormal(1.7)
    np.testing.assert_allclose(td.log_prob(torch.tensor(x)).numpy(),
                               np.asarray(jd.log_prob(jnp.asarray(x))), rtol=MVN_RTOL)
    s = td.sample(torch.Generator().manual_seed(0), (1000,))
    assert s.shape == (1000,) and bool((s >= 0).all())
    assert abs(float(s.mean()) - 1.7 * np.sqrt(2 / np.pi)) < 0.15
    jp = JPrior(dict(a=[dict(s=jdist.HalfNormal(0.5), m=jdist.Normal(0.0, 1.0))]))
    tp = prior_from_reference(jp)
    z = _vec(np.random.default_rng(5), 6, 2)
    np.testing.assert_allclose(tp.log_prob_z(torch.tensor(z)).numpy(),
                               np.asarray(jp.log_prob_z(jnp.asarray(z))), rtol=MVN_RTOL)
