"""The order-5 Hessian coefficients of the Taylor-series profiles against the
JAX package: tests/test_torch_cluster.py's coefficient parity test for the
two cases it leaves out for their cost, in a file of their own so that the
test workers take them apart from it.

Tolerance (tests/test_torch_cluster.py:404-433's rule): ``precompute_hessian``
in float32 on both sides, each order n against the port's float64
coefficients; the port's error within 4x JAX's own float32 error plus 1e-6
of max |coef_n|. JAX's Taylor-mode program is jitted once a case.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cluster import _coords, _series_pair


@pytest.mark.parametrize("kind", ["mass", "scaling"])
def test_series_hessian_coefficients_order5_match_jax(kind):
    order = 5
    js, ts, consts = _series_pair(kind, order)
    x, y = _coords(300, seed=11)
    j32 = np.asarray(jax.jit(lambda a, b: js.precompute_hessian(order, a, b, **consts))(
        jnp.asarray(x), jnp.asarray(y)))
    p32 = ts.precompute_hessian(order, torch.tensor(x), torch.tensor(y), **consts).numpy()
    p64 = ts.precompute_hessian(order, torch.tensor(x).double(), torch.tensor(y).double(),
                                **consts).numpy()
    assert p32.shape == j32.shape == (order + 1, 3, 300)
    for n in range(order + 1):
        err_j, err_p = (np.abs(c[n] - p64[n]).max() for c in (j32, p32))
        assert err_p <= 4 * err_j + 1e-6 * np.abs(p64[n]).max(), (n, err_p, err_j)
