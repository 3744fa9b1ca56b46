"""K4's direct route (a strided sum over the pooled kernel) against the
DFT chain's einsum twin and the JAX package's PSFConv.

Sizes: 40x40 images, 5 samples; odd and even PSFs, pools 1-3. Tolerance:
1e-5 of the output's max (float32 on both sides; the two algorithms sum in
different orders) and 1e-12 in float64 where the two sides are the same
sums in another arrangement.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gigalens_tpu.ops.psf import PSFConv as JPSFConv
from gigalens_tpu_torch.ops.cuda import direct_conv as dcv
from gigalens_tpu_torch.ops.cuda.dft_conv import chain_macs, dft_conv_reference
from gigalens_tpu_torch.ops.psf import PSFConv, subgrid_kernel

REL = 1e-5  # of the output's max


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rel, err


def _kernel(kh, kw, seed=0):
    k = np.random.default_rng(seed).random((kh, kw)).astype(np.float32)
    return k / k.sum()


def _conv(kern, pool):
    return dcv.DirectConv(kern, (40, 40), pool, "cpu")


@pytest.mark.quick
@pytest.mark.parametrize("kh,kw,pool", [(9, 9, 2), (8, 8, 2), (9, 9, 1), (8, 8, 1), (7, 10, 2)])
def test_direct_matches_einsum_twin_and_jax(kh, kw, pool):
    kern = _kernel(kh, kw)
    x = np.random.default_rng(1).standard_normal((5, 40, 40)).astype(np.float32)
    conv = _conv(kern, pool)
    got = dcv.direct_conv_reference(torch.tensor(x), conv.w_ref, pool, conv.oy, conv.ox)
    assert got.shape == (5, 40 // pool, 40 // pool)
    twin = PSFConv(kern, (40, 40), mode="dft", pool=pool, device="cpu")
    assert twin.route == "chain"  # the CPU keeps the einsum twin
    _close(got, dft_conv_reference(torch.tensor(x), twin._dft.fwd_mats))
    jconv = JPSFConv(kern, (40, 40), mode="dft", pool=pool, pallas=False)
    _close(got, jconv(jnp.asarray(x)))
    # the same weights as one PyTorch call (the chip check's library yardstick)
    if kh == kw and kh % 2 == 1:
        lib = F.conv2d(torch.tensor(x)[:, None], conv.w_ref[None, None], stride=pool,
                       padding=conv.oy)[:, 0]
        _close(got, lib)


@pytest.mark.parametrize("kh,kw,pool", [(9, 9, 2), (8, 8, 2), (9, 9, 1), (7, 10, 2), (9, 9, 3)])
def test_transpose_is_the_adjoint_and_the_phases_agree(kh, kw, pool):
    """float64: the scatter transpose equals torch autograd of the forward,
    and the kernel's p^2-phase arrangement of each direction equals the
    plain version."""
    h = 12 * pool
    kern = _kernel(kh, kw, seed=2)
    w64 = torch.tensor(dcv.pooled_kernel(kern, pool))
    oy, ox = dcv.offsets(kh, kw)
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((3, h, h)), requires_grad=True)
    ct = torch.tensor(rng.standard_normal((3, h // pool, h // pool)))
    (want,) = torch.autograd.grad(dcv.direct_conv_reference(x, w64, pool, oy, ox), x, ct)
    got = dcv.direct_conv_transpose_reference(ct, w64, pool, oy, ox, h, h)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)
    n = h // pool
    subs, table = dcv.transpose_phases(w64.numpy(), pool, oy, ox)
    assert subs.shape == (pool * pool, -(-(kh + pool - 1) // pool), -(-(kw + pool - 1) // pool))
    ph = dcv.by_phases_reference(ct, torch.tensor(subs), table, 1, 1, pool, n, n)
    np.testing.assert_allclose(ph.numpy(), want.numpy(), rtol=0, atol=1e-12)
    subs, table = dcv.forward_phases(w64.numpy(), pool, oy, ox)
    fwd = dcv.by_phases_reference(x.detach(), torch.tensor(subs), table, pool * pool, pool, 1,
                                  n, n)
    np.testing.assert_allclose(fwd.numpy(), dcv.direct_conv_reference(x.detach(), w64, pool, oy,
                                                                      ox).numpy(),
                               rtol=0, atol=1e-12)


def test_direct_conv_autograd_and_pooled_kernel():
    """DirectConv on CPU tensors: the plain forward and transpose through
    autograd; the pooled kernel keeps the PSF's flux (sum = 1)."""
    kern = _kernel(9, 9, seed=4)
    conv = _conv(kern, 2)
    assert conv.w_ref.shape == (10, 10)
    assert abs(float(conv.w_ref.double().sum()) - 1.0) < 1e-6
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.standard_normal((2, 40, 40)).astype(np.float32), requires_grad=True)
    ct = torch.tensor(rng.standard_normal((2, 20, 20)).astype(np.float32))
    out = conv(x)
    (g,) = torch.autograd.grad(out, x, ct)
    jconv = JPSFConv(kern, (40, 40), mode="dft", pool=2, pallas=False)
    _close(out.detach(), jconv(jnp.asarray(x.detach().numpy())))
    _close(g, dcv.direct_conv_transpose_reference(ct, conv.w_ref, 2, conv.oy, conv.ox, 40, 40))


def test_k4_route_and_plans():
    """The bench shape (160x160 supersampled, 51-px PSF, pool 2) takes the
    direct route, as does every PSF whose direct sum costs no more than the
    half-spectrum chain's tiles at the two kernels' measured rates (to 79 px
    on 160x160, and 93-103 px where the spectrum has just grown by a tile);
    the rest, and every PSF that does not fit the direct kernel's shared
    memory (above 175 px at pool 2), take the chain. Only the CPU keeps the
    chain's einsum twin whatever the size."""
    g = np.exp(-((np.arange(25) - 12) ** 2 + (np.arange(25)[:, None] - 12) ** 2) / 8.0)
    sk = subgrid_kernel((g / g.sum()).astype(np.float32), 2, odd=True)
    assert sk.shape == (51, 51)

    def routes(sizes, pool=2, side=160):
        return [dcv.k4_route(k, k, pool, side, side) for k in sizes]

    assert routes((25, 51, 61, 71, 75, 79)) == ["direct"] * 6
    assert routes((81, 85, 91)) == ["chain"] * 3
    assert routes((95, 101)) == ["direct"] * 2
    assert routes((107, 121, 151, 175, 177, 183, 201, 261)) == ["chain"] * 8
    # the rule compares work, so the image size enters
    assert routes((101, 121), side=320) == ["direct", "chain"]
    assert routes((9, 25), side=40) == ["direct"] * 2
    assert dcv.direct_macs(160, 160, 51, 51, 2) == 80 * 80 * 52 * 52
    assert chain_macs(160, 160, 51, 51, 2) == chain_macs(160, 160, 51, 51, 2, transpose=True) == 29_578_240
    assert chain_macs(160, 160, 51, 51, 2, tiles=True) == 37_355_520
    conv = PSFConv(sk, (160, 160), mode="dft", pool=2, device="cpu")
    assert conv.route == "chain" and conv._dft is not None and conv._direct is None
    # bench plans: 8 warps; the forward holds its four sub-kernels
    pf, pt = dcv.plan(26, 26, 4, 80), dcv.plan(26, 26, 1, 80)
    assert (pf["warps"], pf["smem"], pt["warps"], pt["smem"]) == (8, 62_272, 8, 50_848)
    for pl in (pf, pt):  # the pitch puts the two half warps apart
        assert (dcv.ROWS_PER_THREAD * pl["ldp"]) % 32 == 16 and pl["ldp"] >= pl["pw"]
    assert dcv.plan(200, 200, 4, 80) is None


def test_non_cpu_tensors_reach_the_kernel_checks():
    """Only CPU tensors take the plain version: a meta tensor must reach the
    wrapper's checks (and without a card, raise), never fall back."""
    conv = _conv(_kernel(9, 9), 2)
    with pytest.raises(ValueError, match="CUDA"):
        conv(torch.empty(1, 40, 40, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        dcv.direct_conv_cuda(torch.empty(1, 20, 20, device="meta"), conv, "transpose")
