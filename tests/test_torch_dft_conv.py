"""DFT-conv twin (K4's plain version) and PSFConv against the JAX package.

Sizes follow tests/test_dft_pallas.py (9x9 kernel, 40x40 images, pool 2).
Tolerance: 1e-4 relative to the output's max (float32 on both sides);
host-side factors and subgrid kernels are numpy on both sides and must be
identical.
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
from gigalens_tpu_torch.ops.cuda.dft_conv import dft_conv_reference
from gigalens_tpu_torch.ops.psf import PSFConv, average_pool, subgrid_kernel

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
    for name in ("_fh_re", "_fh_im", "_fw_re", "_fw_im", "_k_re", "_k_im",
                 "_ih_re", "_ih_im", "_iw_re", "_iw_im"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=name)


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
    with pytest.raises(NotImplementedError):
        PSFConv(setup["kern"], (40, 40), mode="direct", device="cpu")
    with pytest.raises(NotImplementedError):
        PSFConv(np.stack([setup["kern"]] * 2), (40, 40), mode="fft", device="cpu")
