"""K1/K2's plain version in its two stages (per-sample constants and series
table, then a pixel stage of pixel-dependent arithmetic only) against the
one-stage form, float64, and the JAX package's forward kernel in interpret
mode.

Sizes: bs 4, 700 pixels (off the kernels' 256-pixel tile grid), niter 8 and
23. Tolerances: 1e-12 relative in float64 (the two stages are the one-stage
algebra rearranged, so only rounding separates them); in float32 Omega is
bitwise the one-stage form's (the series table holds the same expression
per sample that the one-stage form evaluates per pixel, and cos/sin of the
ellipse angle stay quotients) while the image, whose hoisted reciprocals
round differently, stays within 1e-5 relative (measured 2e-6); against JAX
rtol 1e-4 / atol 2e-3 for the image (the bound of
tests/test_torch_fused_render.py) and 2e-6 absolute for Omega (|Omega| ~ 1,
float32 on both sides).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigalens_tpu.ops.pallas import fused_render as jfr
from gigalens_tpu_torch.ops.cuda import fused_render as fr

BS, NPIX = 4, 700


def _params(rng, e1_sign=None, zero_e=False):
    def rnd(lo, hi):
        return rng.uniform(lo, hi, BS)

    cols = [rnd(1.0, 1.5), rnd(1.8, 2.2), rnd(-0.2, 0.2), rnd(-0.2, 0.2), rnd(-0.02, 0.02),
            rnd(-0.02, 0.02), rnd(-0.05, 0.05), rnd(-0.05, 0.05),
            rnd(0.8, 1.2), rnd(2, 4), rnd(-0.15, 0.15), rnd(-0.1, 0.1), rnd(-0.02, 0.02),
            rnd(-0.02, 0.02), rnd(80, 120),
            rnd(0.2, 0.3), rnd(1, 2), rnd(-0.1, 0.1), rnd(-0.1, 0.1), rnd(0, 0.1),
            rnd(-0.1, 0), rnd(40, 60)]
    p = np.stack(cols, -1)
    if e1_sign is not None:
        p[:, [2, 10, 17]] = e1_sign * np.abs(p[:, [2, 10, 17]])
    if zero_e:
        p[:, [2, 3, 10, 11, 17, 18]] = 0.0
    return p


@pytest.fixture(scope="module")
def grid():
    rng = np.random.default_rng(11)
    return rng.uniform(-2.6, 2.6, NPIX), rng.uniform(-2.6, 2.6, NPIX)


@pytest.mark.quick
@pytest.mark.parametrize("niter", [8, 23])
@pytest.mark.parametrize("e1_sign", [1.0, -1.0])
def test_two_stage_forward_matches_one_stage_f64(grid, niter, e1_sign):
    """Both branches of the half-angle rotation, against the differentiable
    one-stage reference and the one-stage K2 form (image and Omega)."""
    p = torch.tensor(_params(np.random.default_rng(0), e1_sign))
    x, y = torch.tensor(grid[0]), torch.tensor(grid[1])
    out, ox, oy = fr.fused_render_fwd_reference(p, x, y, niter)
    assert out.shape == ox.shape == oy.shape == (BS, NPIX) and out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), fr.fused_render_reference(p, x, y, niter).numpy(),
                               rtol=1e-12, atol=0)
    out1, ox1, oy1 = fr.fused_render_fwd_onestage(p, x, y, niter)
    np.testing.assert_allclose(out.numpy(), out1.numpy(), rtol=1e-12, atol=0)
    np.testing.assert_allclose(ox.numpy(), ox1.numpy(), rtol=0, atol=1e-14)
    np.testing.assert_allclose(oy.numpy(), oy1.numpy(), rtol=0, atol=1e-14)


@pytest.mark.parametrize("niter", [8, 23])
def test_omega_keeps_its_bits_in_float32(grid, niter):
    p = torch.tensor(_params(np.random.default_rng(1)), dtype=torch.float32)
    x, y = (torch.tensor(g, dtype=torch.float32) for g in grid)
    out, ox, oy = fr.fused_render_fwd_reference(p, x, y, niter)
    out1, ox1, oy1 = fr.fused_render_fwd_onestage(p, x, y, niter)
    np.testing.assert_array_equal(ox.numpy(), ox1.numpy())
    np.testing.assert_array_equal(oy.numpy(), oy1.numpy())
    np.testing.assert_allclose(out.numpy(), out1.numpy(), rtol=1e-5, atol=0)
    # the series table's forward column is the per-pixel expression itself
    ratio = fr.series_table(p[:, 1:2], p[:, 2:3], p[:, 3:4], niter)[0]
    _, _, q = fr._epl_q(p[:, 2:3], p[:, 3:4])
    f, t = (1.0 - q) / (1.0 + q), p[:, 1:2] - 1.0
    for n in range(1, niter):
        np.testing.assert_array_equal(
            ratio[:, n - 1].numpy(), (-f * (2 * n - (2 - t)) / (2 * n + (2 - t)))[:, 0].numpy())


@pytest.mark.parametrize("niter", [8, 23])
def test_two_stage_forward_matches_jax_kernel(grid, niter):
    """float32 against the Pallas forward kernel (K2's counterpart, which
    also writes Omega) in interpret mode, through the CPU wrappers."""
    p = _params(np.random.default_rng(2)).astype(np.float32)
    x, y = (g.astype(np.float32) for g in grid)
    want, ox_j, oy_j = jfr._render_impl(jnp.asarray(p), jnp.asarray(x), jnp.asarray(y), niter, True)
    out, ox, oy = fr.fused_render_fwd(torch.tensor(p), torch.tensor(x), torch.tensor(y), niter,
                                      save_omega=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-4, atol=2e-3)
    np.testing.assert_allclose(ox.numpy(), np.asarray(ox_j)[:BS, :NPIX], rtol=0, atol=2e-6)
    np.testing.assert_allclose(oy.numpy(), np.asarray(oy_j)[:BS, :NPIX], rtol=0, atol=2e-6)
    # K1's twin is K2's image
    k1 = fr.fused_render_fwd(torch.tensor(p), torch.tensor(x), torch.tensor(y), niter)
    np.testing.assert_array_equal(k1.numpy(), out.numpy())


def test_zero_ellipticity_forward(grid):
    """e1 = e2 = 0 everywhere (the prior mean): f rounds to 0 and the table's
    floor 1e-20 stands in; finite, and the one-stage image to 1e-5."""
    p = torch.tensor(_params(np.random.default_rng(3), zero_e=True), dtype=torch.float32)
    x, y = (torch.tensor(g, dtype=torch.float32) for g in grid)
    out, ox, oy = fr.fused_render_fwd_reference(p, x, y, 23)
    out1, ox1, oy1 = fr.fused_render_fwd_onestage(p, x, y, 23)
    assert torch.isfinite(out).all() and torch.isfinite(ox).all() and torch.isfinite(oy).all()
    np.testing.assert_allclose(out.numpy(), out1.numpy(), rtol=1e-5, atol=0)
    np.testing.assert_allclose(ox.numpy(), ox1.numpy(), rtol=0, atol=1e-19)
    np.testing.assert_allclose(oy.numpy(), oy1.numpy(), rtol=0, atol=1e-19)


def test_niter_beyond_the_table_raises_before_launch():
    meta = torch.empty((2, fr.N_PARAMS), device="meta")
    xm = torch.empty((10,), device="meta")
    for save_omega in (False, True):
        with pytest.raises(ValueError, match="niter"):
            fr.fused_render_fwd(meta, xm, xm, fr.MAX_NITER + 1, save_omega=save_omega)
    with pytest.raises(ValueError, match="niter"):
        fr.fused_render_fwd(meta, xm, xm, 0)


def test_fwd_tiles_keeps_small_grids_wide():
    """Eight tiles a block at the MAP and SVI batches; four at the HMC's 50
    chains, where eight would leave 625 blocks for 132 SMs."""
    assert fr.fwd_tiles(500, 25_600) == fr.FWD_TILES_MAX == 8
    assert fr.fwd_tiles(1000, 25_600) == 8
    assert fr.fwd_tiles(50, 25_600) == 4
    assert fr.fwd_tiles(1, 100) == 1
    for bs, npix in ((50, 25_600), (20, 25_600), (120, 25_600), (500, 6_400), (3, 1_000)):
        tiles = fr.fwd_tiles(bs, npix)
        assert tiles in (1, 2, 4, 8)
        blocks = bs * -(-npix // fr.TILE) // tiles
        assert tiles == 1 or blocks >= fr.MIN_BLOCKS_PER_SM * fr.SMS
