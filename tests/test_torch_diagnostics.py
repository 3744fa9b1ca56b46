"""The port's posterior diagnostics and summaries against the JAX package (CPU).

Split R-hat, Geyer ESS and summarize_posterior on seeded chains, rtol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigalens_tpu.utils import diagnostics as jdiag
from gigalens_tpu.utils import summary as jsummary
from gigalens_tpu_torch.interop import prior_from_reference
from gigalens_tpu_torch.utils import (
    effective_sample_size,
    format_summary,
    potential_scale_reduction,
    summarize_posterior,
)

RTOL = 1e-5


def _chains(seed, n=400, m=6, d=4, rho=0.8):
    """AR(1) chains with per-chain offsets (float32)."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, m, d))
    x[0] = rng.standard_normal((m, d))
    for t in range(1, n):
        x[t] = rho * x[t - 1] + np.sqrt(1 - rho**2) * rng.standard_normal((m, d))
    return (x + 0.05 * rng.standard_normal((1, m, d))).astype(np.float32)


@pytest.mark.quick
@pytest.mark.parametrize("split", [True, False])
def test_rhat_matches_jax(split):
    x = _chains(0)
    want = np.asarray(jdiag.potential_scale_reduction(jnp.asarray(x), split=split))
    np.testing.assert_allclose(potential_scale_reduction(x, split=split), want, rtol=RTOL)
    np.testing.assert_allclose(potential_scale_reduction(torch.tensor(x), split=split), want,
                               rtol=RTOL)


@pytest.mark.parametrize("seed,rho", [(1, 0.0), (2, 0.8), (3, 0.97)])
def test_ess_matches_jax(seed, rho):
    x = _chains(seed, rho=rho)
    want = np.asarray(jdiag.effective_sample_size(x))
    np.testing.assert_allclose(effective_sample_size(torch.tensor(x)), want, rtol=RTOL)


def test_rhat_flags_a_stuck_chain():
    x = _chains(4)
    x[:, 0] += 3.0
    assert potential_scale_reduction(x).max() > 1.5


def test_summarize_posterior_matches_jax(demo_prior):
    d = demo_prior.d
    x = _chains(5, n=200, m=4, d=d) * 0.3
    div = np.array([0, 2, 1, 0], np.int32)
    want = jsummary.summarize_posterior(demo_prior, jnp.asarray(x), divergences=div)
    got = summarize_posterior(prior_from_reference(demo_prior), torch.tensor(x),
                              divergences=torch.tensor(div))
    assert list(got) == list(want)
    for name, row in want.items():
        assert set(got[name]) == set(row), name
        for k, v in row.items():
            np.testing.assert_allclose(got[name][k], v, rtol=RTOL, atol=1e-6, err_msg=name + k)
    assert got["_global"]["divergences"] == 3
    # flat (n, d) draws: no chain diagnostics
    flat = summarize_posterior(prior_from_reference(demo_prior), x.reshape(-1, d))
    assert "rhat" not in flat["lens_mass/0/theta_E"] and flat["_global"] == {}
    text = format_summary(got)
    assert text == jsummary.format_summary(got)
    assert "lens_mass/0/theta_E" in text and "max_rhat=" in text
