"""Port prob stack (gigalens_tpu_torch.prob) against the JAX package.

Both sides get the same z / params, made with numpy and converted to each
side's arrays; tolerances are float32 (rtol 1e-5).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigalens_tpu.prob import distributions as jd
from gigalens_tpu_torch.interop import prior_from_reference, tree_to_torch
from gigalens_tpu_torch.prob import distributions as td

RTOL = 1e-5  # float32 on both sides


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np_tree(v) for v in tree]
    return np.asarray(tree)


@pytest.fixture(scope="module")
def priors(demo_prior):
    return demo_prior, prior_from_reference(demo_prior)


@pytest.mark.quick
def test_column_order_and_names(priors):
    jp, tp = priors
    assert tp.d == jp.d == 22
    assert tp.column_names() == jp.column_names()
    # jax.tree_util sorts dict keys (uppercase first): lens_light/Ie leads,
    # and the EPL block starts at center_x
    assert tp.column_names()[0] == "lens_light/0/Ie"
    assert tp.column_names()[7] == "lens_mass/0/center_x"


@pytest.mark.parametrize("scale", [0.5, 2.0])
def test_constrain_fldj_log_prob(priors, scale):
    jp, tp = priors
    z = (np.random.default_rng(1).standard_normal((64, jp.d)) * scale).astype(np.float32)
    xj = jp.constrain(jnp.asarray(z))
    xt = tp.constrain(torch.as_tensor(z))
    for a, b in zip(jp._flatten_like(xj), tp._flatten_like(xt)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(
        tp.fldj(torch.as_tensor(z)).numpy(), np.asarray(jp.fldj(jnp.asarray(z))),
        rtol=RTOL, atol=1e-4,
    )
    # log_prob on the SAME constrained values (the JAX side's, carried over)
    xt_j = tree_to_torch(_np_tree(xj), device="cpu")
    np.testing.assert_allclose(
        tp.log_prob(xt_j).numpy(), np.asarray(jp.log_prob(xj)), rtol=RTOL, atol=1e-4,
    )
    np.testing.assert_allclose(
        tp.log_prob_z(torch.as_tensor(z)).numpy(),
        np.asarray(jp.log_prob_z(jnp.asarray(z))), rtol=RTOL, atol=1e-4,
    )


def test_unconstrain_roundtrip(priors):
    jp, tp = priors
    z = (np.random.default_rng(2).standard_normal((32, jp.d))).astype(np.float32)
    xj = _np_tree(jp.constrain(jnp.asarray(z)))
    zj = np.asarray(jp.unconstrain(xj))
    zt = tp.unconstrain(tree_to_torch(xj, device="cpu")).numpy()
    np.testing.assert_allclose(zt, zj, rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(zt, z, rtol=1e-3, atol=1e-3)


def test_structure_mismatch_raises(priors):
    _, tp = priors
    x = tp.sample(torch.Generator().manual_seed(0), 2)
    x["lens_mass"] = x["lens_mass"][:1]
    with pytest.raises(ValueError):
        tp.unconstrain(x)


def test_prior_sample_support_and_shapes(priors):
    _, tp = priors
    x = tp.sample(torch.Generator().manual_seed(0), 1000)
    assert x["lens_mass"][0]["gamma"].shape == (1000,)
    assert torch.isfinite(tp.log_prob(x)).all()
    z = tp.unconstrain(x)
    assert z.shape == (1000, tp.d) and torch.isfinite(z).all()


def test_truncated_normal_samples_inside_and_ks():
    from scipy import stats

    # a central window, and a far right-tail window (the mirrored branch)
    for loc, scale, low, high in [(0.0, 0.15, -0.5, 0.5), (0.0, 1.0, 3.0, 5.0)]:
        d = td.TruncatedNormal(loc, scale, low, high)
        x = d.sample(torch.Generator().manual_seed(3), 20000).numpy()
        assert x.min() >= low and x.max() <= high
        ref = stats.truncnorm((low - loc) / scale, (high - loc) / scale, loc, scale)
        ks = stats.kstest(x, ref.cdf).statistic
        assert ks < 0.015, ks
        # log_prob against the JAX distribution on the same points
        jdist = jd.TruncatedNormal(loc, scale, low, high)
        pts = np.linspace(low, high, 101).astype(np.float32)
        np.testing.assert_allclose(
            d.log_prob(torch.as_tensor(pts)).numpy(),
            np.asarray(jdist.log_prob(jnp.asarray(pts))), rtol=RTOL, atol=1e-5,
        )


@pytest.mark.parametrize(
    "name,args",
    [("Normal", (0.3, 0.2)), ("LogNormal", (np.log(1.25), 0.25)),
     ("Uniform", (0.5, 4.0)), ("TruncatedNormal", (2.0, 0.25, 1.0, 3.0))],
)
def test_distribution_log_prob_and_bijector(name, args):
    jdist, tdist = getattr(jd, name)(*args), getattr(td, name)(*args)
    z = np.random.default_rng(4).standard_normal(200).astype(np.float32)
    xj = jdist.bijector.forward(jnp.asarray(z))
    xt = tdist.bijector.forward(torch.as_tensor(z))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(
        tdist.bijector.forward_log_det_jacobian(torch.as_tensor(z)).numpy(),
        np.asarray(jdist.bijector.forward_log_det_jacobian(jnp.asarray(z))),
        rtol=RTOL, atol=1e-5,
    )
    xs = np.asarray(xj)
    np.testing.assert_allclose(
        tdist.log_prob(torch.tensor(xs)).numpy(),
        np.asarray(jdist.log_prob(jnp.asarray(xs))), rtol=RTOL, atol=1e-5,
    )
    # outside the support: -inf on both sides
    if name in ("Uniform", "TruncatedNormal"):
        out = torch.as_tensor([args[-1] + 1.0])
        assert tdist.log_prob(out).item() == -np.inf
