"""The shapelet stage of K5/K6's two-stage twin (the folded coefficient table
of the summed render, the Gaussian-scaled row of the components render)
against the one-stage ``_shapelet_light`` and the JAX package's
``Shapelets.light``, for n_max 0, 1, 4, 6 and 10, sampled and lstsq.

Tolerances: float64 against the one-stage form 1e-11 of the max |value|
(the two differ only in the order of their products and sums; measured
~1e-15); float32 against JAX 2e-5 of the max (the bound of
tests/test_torch_fused_builder.py; the folded float32 form sits 1e-7 to 5e-7
of the max off float64 for n_max 0 to 10, as the one-stage form does).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigalens_tpu.profiles.light.shapelets import Shapelets as JShapelets
from gigalens_tpu_torch.ops.cuda import fused_builder as fb

BS, NPIX = 3, 500
ORDERS = [0, 1, 4, 6, 10]


def _stage(n_max, lstsq):
    n = (n_max + 1) * (n_max + 2) // 2
    return fb.Stage(fb.SHAPELETS, 0, n_max=n_max, lstsq=lstsq, is_source=True, depth=n)


def _inputs(n_max, lstsq, dtype, seed=0):
    rng = np.random.default_rng(seed + n_max)
    n = (n_max + 1) * (n_max + 2) // 2
    cols = [rng.uniform(0.15, 0.35, BS), rng.uniform(-0.1, 0.1, BS), rng.uniform(-0.1, 0.1, BS)]
    if not lstsq:
        cols += [rng.normal(0.0, 50.0, BS) for _ in range(n)]
    p = torch.tensor(np.stack(cols, -1), dtype=dtype)
    x = torch.tensor(rng.uniform(-1.0, 1.0, NPIX), dtype=dtype)
    y = torch.tensor(rng.uniform(-1.0, 1.0, NPIX), dtype=dtype)
    return p, x, y


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.quick
@pytest.mark.parametrize("lstsq", [False, True], ids=["sampled", "lstsq"])
@pytest.mark.parametrize("n_max", ORDERS)
def test_folded_twin_matches_one_stage_f64(n_max, lstsq):
    st = _stage(n_max, lstsq)
    p, x, y = _inputs(n_max, lstsq, torch.float64)
    k = fb._shapelet_consts2(p, st)
    want = fb._shapelet_light(p, x, y, st)
    # the summed render: the folded table (unit amplitudes for an lstsq stage)
    (total,) = fb._shapelet_fwd_sum2(p, st, k, x, y)
    assert total.shape == (BS, NPIX)
    assert _rel(total, sum(want)) <= 1e-11
    # the components render: one image per component
    if lstsq:
        got = fb._shapelet_fwd2(p, st, k, x, y)
        assert len(got) == len(want) == st.depth
        assert _rel(torch.stack(got), torch.stack(want)) <= 1e-11


@pytest.mark.parametrize("lstsq", [False, True], ids=["sampled", "lstsq"])
@pytest.mark.parametrize("n_max", ORDERS)
def test_folded_twin_matches_jax_shapelets_f32(n_max, lstsq):
    st = _stage(n_max, lstsq)
    p, x, y = _inputs(n_max, lstsq, torch.float32, seed=10)
    jprof = JShapelets(n_max, use_lstsq=lstsq)
    pn = p.numpy()
    amps = {} if lstsq else {name: jnp.asarray(pn[:, 3 + i: 4 + i])
                             for i, name in enumerate(jprof._amp_names)}
    want = np.asarray(jprof.light(jnp.asarray(x.numpy())[None], jnp.asarray(y.numpy())[None],
                                  jnp.asarray(pn[:, 0:1]), jnp.asarray(pn[:, 1:2]),
                                  jnp.asarray(pn[:, 2:3]), **amps))
    k = fb._shapelet_consts2(p, st)
    if lstsq:
        got = torch.stack(fb._shapelet_fwd2(p, st, k, x, y)).numpy()
        # both stack the components first: (depth, bs, npix)
        total = fb._shapelet_fwd_sum2(p, st, k, x, y)[0].numpy()
        np.testing.assert_allclose(total, want.sum(0), rtol=0, atol=2e-5 * np.abs(want.sum(0)).max())
    else:
        got = fb._shapelet_fwd_sum2(p, st, k, x, y)[0].numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize("n_max", ORDERS)
def test_table_layout_matches_the_kernel(n_max):
    """Row j of the shared-memory table holds n_max - j + 1 coefficients
    padded to a float4; the twin's table has one entry per component and the
    wrapper's launch records place the tables one after another."""
    want = sum(-(-(n_max - j + 1) // 4) * 4 for j in range(n_max + 1))
    assert fb.shapelet_table_floats(n_max) == want
    st = _stage(n_max, False)
    p, _, _ = _inputs(n_max, False, torch.float64)
    table = fb._shapelet_consts2(p, st)["table"]
    assert sorted(table) == sorted((i, j) for j in range(n_max + 1) for i in range(n_max - j + 1))
    pf = fb.shapelet_prefactor(n_max).astype(np.float64)
    for k, (n1, n2) in enumerate(fb._pairs(n_max)):
        np.testing.assert_allclose(table[n1, n2][:, 0].numpy(),
                                   p[:, 3 + k].numpy() * pf[n1] * pf[n2], rtol=1e-14)
    # two shapelet stages in one program: the second table starts where the
    # first ends, and only the summed forward pays for them
    spec = fb.FusedSpec(
        [fb.Stage(fb.SHEAR, 0),
         fb.Stage(fb.SHAPELETS, 2, n_max=n_max, is_source=True, depth=st.depth),
         fb.Stage(fb.SHAPELETS, 5 + st.depth, n_max=2, is_source=True, depth=6)],
        [0.0] * (2 + 3 + st.depth + 3 + 6))
    n_sums = fb.sum_offsets(spec)[1]
    base = fb.smem_bytes(spec, n_sums, bwd=False, summed=False)
    assert fb.smem_bytes(spec, n_sums, bwd=False, summed=True) == base + 4 * (
        want + fb.shapelet_table_floats(2))
