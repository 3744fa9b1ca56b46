"""DFT-conv twin (K4's plain version) and PSFConv against the JAX package.

Sizes follow tests/test_dft_pallas.py (9x9 kernel, 40x40 images, pool 2).
Tolerance: 1e-4 relative to the output's max (float32 on both sides);
host-side factors and subgrid kernels are numpy on both sides and must be
identical. The half-spectrum factor set the port runs is held to the full
set at 1e-12 of the max in float64 (the two are equal in exact arithmetic)
and to JAX's full-spectrum ``_dft_conv`` at 5e-6 of the max in float32
(measured 2e-7 to 4e-7: both sides round 40-50-term sums of O(1) products).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigalens_tpu.ops.pallas.dft_conv import PallasDFTConv
from gigalens_tpu.ops.psf import PSFConv as JPSFConv
from gigalens_tpu.ops.psf import average_pool as j_average_pool
from gigalens_tpu.ops.psf import subgrid_kernel as j_subgrid_kernel
from gigalens_tpu_torch.ops.cuda.dft_conv import DFTConv, dft_conv_reference
from gigalens_tpu_torch.ops.psf import PSFConv, average_pool, dft_factors, subgrid_kernel

REL = 1e-4  # of the output's max


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=REL * np.abs(want).max())


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    kern = rng.random((9, 9)).astype(np.float32)
    kern /= kern.sum()
    jconv = JPSFConv(kern, (40, 40), mode="dft", pool=2, pallas=False)
    pal = PallasDFTConv(
        jconv._fh_re, jconv._fh_im, jconv._fw_re, jconv._fw_im,
        jconv._k_re, jconv._k_im, jconv._ih_re, jconv._ih_im,
        jconv._iw_re, jconv._iw_im, interpret=True,
    )
    x = rng.standard_normal((5, 40, 40)).astype(np.float32)
    ct = rng.standard_normal((5, 20, 20)).astype(np.float32)
    out_j, vjp = jax.vjp(pal, jnp.asarray(x))
    (xbar_j,) = vjp(jnp.asarray(ct))
    return dict(kern=kern, jconv=jconv, conv=PSFConv(kern, (40, 40), mode="dft", pool=2,
                                                     device="cpu"),
                x=x, ct=ct, out_j=np.asarray(out_j), xbar_j=np.asarray(xbar_j))


@pytest.mark.quick
def test_factors_identical_to_jax(setup):
    j, t = setup["jconv"], setup["conv"]
    assert t.fshape == j.fshape
    names = ("_fh_re", "_fh_im", "_fw_re", "_fw_im", "_k_re", "_k_im",
             "_ih_re", "_ih_im", "_iw_re", "_iw_im")
    full = dft_factors(setup["kern"], (40, 40), 2)
    for name, got in zip(names, full):
        np.testing.assert_array_equal(got, getattr(j, name), err_msg=name)
    # the half set the port runs: columns 0 .. fw / 2 of the same numbers,
    # the conjugate half's weight on K
    fw = t.fshape[1]
    hw = fw // 2 + 1
    weight = np.array([1.0] + [2.0] * (hw - 2) + [1.0], np.float32)  # fw = 48 is even
    for name, got, want in zip(names, dft_factors(setup["kern"], (40, 40), 2, half=True), full):
        if name.startswith("_fw"):
            want = want[:hw]
        elif name.startswith("_iw"):
            want = want[:, :hw]
        elif name.startswith("_k"):
            want = want[:, :hw] * weight
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_subgrid_kernel_identical_and_bench_fshape():
    g = np.exp(-((np.arange(25) - 12) ** 2 + (np.arange(25)[:, None] - 12) ** 2) / 8.0)
    psf = (g / g.sum()).astype(np.float32)
    sk = subgrid_kernel(psf, 2, odd=True)
    np.testing.assert_array_equal(sk, j_subgrid_kernel(psf, 2, odd=True))
    assert sk.shape == (51, 51)
    # the bench scene's fallback PSF on 160x160 supersampled images: the
    # DFT spectrum is 216x216 (5-smooth size of 160 + 51 - 1 = 210)
    assert PSFConv(sk, (160, 160), mode="fft", device="cpu").fshape == (216, 216)


def test_dft_forward_matches_pallas_interpret_and_fft(setup):
    out = setup["conv"](torch.tensor(setup["x"]))
    assert out.shape == (5, 20, 20)
    _close(out.numpy(), setup["out_j"])
    jfft = JPSFConv(setup["kern"], (40, 40), mode="fft")
    _close(out.numpy(), j_average_pool(jfft(jnp.asarray(setup["x"])), 2))
    # the twin on the forward factor set directly
    _close(dft_conv_reference(torch.tensor(setup["x"]), setup["conv"]._dft.fwd_mats).numpy(),
           setup["out_j"])


def test_dft_transpose_matches_pallas_vjp(setup):
    x = torch.tensor(setup["x"], requires_grad=True)
    (xbar,) = torch.autograd.grad(setup["conv"](x), x, torch.tensor(setup["ct"]))
    assert xbar.shape == (5, 40, 40)
    _close(xbar.numpy(), setup["xbar_j"])
    # and against JAX's AD of the fft conv + pool
    jfft = JPSFConv(setup["kern"], (40, 40), mode="fft")
    _, vjp = jax.vjp(lambda v: j_average_pool(jfft(v), 2), jnp.asarray(setup["x"]))
    _close(xbar.numpy(), vjp(jnp.asarray(setup["ct"]))[0])


def test_fft_mode_and_average_pool_match_jax(setup):
    jfft = JPSFConv(setup["kern"], (40, 40), mode="fft")
    conv = PSFConv(setup["kern"], (40, 40), mode="fft", device="cpu")
    x = setup["x"]
    out = conv(torch.tensor(x))
    _close(out.numpy(), jfft(jnp.asarray(x)))
    _close(average_pool(out, 2).numpy(), j_average_pool(jfft(jnp.asarray(x)), 2))
    # float64 input uses the unrounded spectrum and stays float64
    assert conv(torch.tensor(x, dtype=torch.float64)).dtype == torch.float64


def test_unported_modes_raise(setup):
    """JAX's "dft_hi" (its dft with HIGHEST-precision TPU matmuls) is the
    port's "dft", which is full float32 already: the same route and the
    same output bit for bit, within REL of JAX's dft_hi; a per-scene stack
    has no direct mode, as in JAX, and an unknown mode raises."""
    hi = PSFConv(setup["kern"], (40, 40), mode="dft_hi", pool=2, device="cpu")
    assert hi.mode == "dft" and hi.pool == 2 and hi.route == setup["conv"].route
    x = torch.tensor(setup["x"])
    out = hi(x)
    assert torch.equal(out, setup["conv"](x))
    jhi = JPSFConv(setup["kern"], (40, 40), mode="dft_hi", pool=2, pallas=False)
    _close(out.numpy(), jhi(jnp.asarray(setup["x"])))
    with pytest.raises(NotImplementedError):
        PSFConv(np.stack([setup["kern"]] * 2), (40, 40), mode="direct", device="cpu")
    with pytest.raises(NotImplementedError):
        PSFConv(setup["kern"], (40, 40), mode="dft_lo", device="cpu")


# (image shape, kernel shape, pool): fw = 45 (odd) for 36-px rows with a 9-px
# kernel, 48 (even) otherwise; the last case is not square
HALF_CASES = [((36, 36), (9, 9), 1), ((36, 36), (9, 9), 2), ((36, 36), (9, 9), 3),
              ((40, 40), (9, 9), 1), ((40, 40), (9, 9), 2), ((42, 42), (7, 7), 3),
              ((40, 36), (7, 9), 2)]


def _case(shape, kshape, pool, seed=0):
    rng = np.random.default_rng(seed)
    kern = rng.random(kshape).astype(np.float32)
    kern /= kern.sum()
    x = rng.standard_normal((3, *shape)).astype(np.float32)
    ct = rng.standard_normal((3, shape[0] // pool, shape[1] // pool)).astype(np.float32)
    return kern, x, ct


def _f64(mats):
    return [m.double() for m in mats]


@pytest.mark.parametrize("shape,kshape,pool", HALF_CASES)
def test_half_spectrum_matches_full_spectrum_and_jax(shape, kshape, pool):
    kern, x, ct = _case(shape, kshape, pool)
    half = DFTConv(*dft_factors(kern, shape, pool, half=True), device="cpu")
    full = DFTConv(*dft_factors(kern, shape, pool), device="cpu")
    hw = half.fwd_mats[2].shape[1]
    assert hw % 4 == 0 and hw - 4 < PSFConv(kern, shape, "fft", device="cpu").fshape[1] // 2 + 1 <= hw
    jconv = JPSFConv(kern, shape, mode="dft", pool=pool, pallas=False)
    out_j, vjp = jax.vjp(jconv, jnp.asarray(x))
    for arg, hm, fm, want_j in ((x, half.fwd_mats, full.fwd_mats, out_j),
                                (ct, half.bwd_mats, full.bwd_mats, vjp(jnp.asarray(ct))[0])):
        a = torch.tensor(arg)
        got64 = dft_conv_reference(a.double(), _f64(hm))
        want64 = dft_conv_reference(a.double(), _f64(fm))
        # the same float32 factors in float64 products: only the order of
        # the sums differs (measured 1e-15 to 2e-14 of the max)
        assert float((got64 - want64).abs().max()) <= 1e-12 * float(want64.abs().max())
        got = dft_conv_reference(a, hm).numpy()
        want_j = np.asarray(want_j)
        np.testing.assert_allclose(got, want_j, rtol=0, atol=5e-6 * np.abs(want_j).max())


@pytest.mark.parametrize("shape,kshape,pool", HALF_CASES)
def test_half_spectrum_transpose_is_the_exact_adjoint(shape, kshape, pool):
    """<conv(x), ct> = <x, conv^T(ct)> in float64 on the half-spectrum sets,
    and through autograd of the port's PSFConv."""
    kern, x, ct = _case(shape, kshape, pool, seed=1)
    conv = PSFConv(kern, shape, mode="dft", pool=pool, device="cpu")
    assert conv.route == "chain"
    x64, ct64 = torch.tensor(x).double(), torch.tensor(ct).double()
    y = dft_conv_reference(x64, _f64(conv._dft.fwd_mats))
    g = dft_conv_reference(ct64, _f64(conv._dft.bwd_mats))
    lhs, rhs = float((y * ct64).sum()), float((x64 * g).sum())
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), abs(rhs), 1.0)
    xr = torch.tensor(x, requires_grad=True)
    (xbar,) = torch.autograd.grad(conv(xr), xr, torch.tensor(ct))
    np.testing.assert_allclose(xbar.numpy(), g.numpy(), rtol=0, atol=1e-5 * float(g.abs().max()))
