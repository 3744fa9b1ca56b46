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
    and the kernel's p^2-phase arrangement of each direction, walked under
    its launch plan, equals the plain version."""
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
    ku, kv = subs.shape[1:]
    pl = dcv.plan(3, n, n, ku, kv, pool, "transpose")
    ph = dcv.by_tiles_reference(ct, torch.tensor(subs), table, pl, 1, 1, pool, n, n)
    np.testing.assert_allclose(ph.numpy(), want.numpy(), rtol=0, atol=1e-12)
    subs, table = dcv.forward_phases(w64.numpy(), pool, oy, ox)
    pl = dcv.plan(3, n, n, ku, kv, pool, "fwd")
    fwd = dcv.by_tiles_reference(x.detach(), torch.tensor(subs), table, pl, pool * pool, pool, 1,
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
    memory (above 143 px at pool 2), take the chain. Only the CPU keeps the
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
    # bench plans: the first version's block (5x5 thread tiles, 16 column
    # lanes, 80 x 80 outputs, 8 warps, one load buffer), now loaded by TMA;
    # a forward load holds both column phases of its raw rows
    pf, pt = (dcv.plan(500, 80, 80, 26, 26, 2, d) for d in ("fwd", "transpose"))
    for pl in (pf, pt):
        assert (pl["rows"], pl["cols"], pl["lx"], pl["rb"], pl["warps"], pl["stages"],
                pl["tma"]) == (5, 5, 16, 16, 8, 1, 1)
        # the pitch keeps every warp's window loads conflict-free
        g = 2 if pl is pf else 1
        assert dcv._bank_cost(pl["ldp"], 5, 5, g, 16, 16, 1, pl["sb"], 8) <= 16
    assert (pf["smem"], pt["smem"], pf["blocks"], pt["blocks"]) == (109_440, 64_512, 500, 2000)
    assert dcv.fits(72, 72, 2) and not dcv.fits(73, 73, 2)  # 143 px fits, 145 does not
    assert dcv.plan(1, 80, 80, 200, 200, 2, "fwd") is None


# The shapes the port launches the direct K4 at (PERF.md section 6): (bs,
# output phase side, sub-kernel side), pool 2
TABLE = {"bench MAP": (500, 80, 26), "bench SVI": (1000, 80, 26),
         "inversion chunk": (1536, 64, 10), "composite MAP": (256, 64, 14),
         "composite SVI": (200, 64, 14), "survey scene": (64, 60, 14),
         "sie lstsq MAP": (1920, 48, 10), "cluster SVI": (256, 48, 10),
         "cluster MAP": (128, 48, 10), "multi-plane MAP": (128, 24, 6)}


def _written(pl, n_out, oh, ow):
    """How many times the plan's blocks write each output of one sample."""
    R, C = pl["rows"], pl["cols"]
    th, tw = R * pl["rb"], C * pl["lx"]
    count = np.zeros((n_out, oh, ow), np.int64)
    for ph in range(n_out):
        for tx in range(pl["tiles_x"]):
            for band in range(pl["bands"]):
                count[ph, band * th:(band + 1) * th, tx * tw:(tx + 1) * tw] += 1
    return count


@pytest.mark.parametrize("name", sorted(TABLE))
def test_plans_at_the_ports_shapes(name):
    """Every plan at the table's shapes covers each output exactly once,
    fits in 227 KB of shared memory, keeps its tiles at least MIN_LIVE live
    and gives at least MIN_BLOCKS (two an SM) blocks where some choice of
    tile that live reaches them."""
    bs, side, ku = TABLE[name]
    for direction, n_out in (("fwd", 1), ("transpose", 4)):
        pl = dcv.plan(bs, side, side, ku, ku, 2, direction)
        assert (pl["rows"], pl["cols"]) in dcv.VARIANTS and pl["tma"] == 1
        assert (_written(pl, n_out, side, side) == 1).all()
        assert pl["smem"] <= 232_448 and pl["warps"] * 32 <= dcv.MAX_THREADS
        assert pl["spb"] * pl["rb"] * pl["lx"] <= pl["warps"] * 32
        assert pl["live"] >= dcv.MIN_LIVE, pl
        reach = max(c["blocks"] for c in dcv.tile_choices(bs, side, side, ku, ku, 2, direction,
                                                         pl["rows"], pl["cols"])
                    if c["live"] >= dcv.MIN_LIVE)
        assert pl["blocks"] >= min(dcv.MIN_BLOCKS, reach), pl
        assert pl["blocks"] == n_out * pl["tiles_x"] * pl["bands"] * -(-bs // pl["spb"])


def _walk_case(h, kern, pool, n, pl_bs, direction, rng, forced=None):
    """(the tile walk under the plan at pl_bs samples, the float64 plain
    version) on n samples, both float64."""
    conv = dcv.DirectConv(kern, (h, h), pool, "cpu")
    w64 = conv.w_ref.double()
    side = h // pool
    if forced:
        pl = dcv.launch_plan(pl_bs, side, side, conv.ku, conv.kv, pool, direction, *forced)
    else:
        pl = conv.plan(pl_bs, direction)
    if direction == "fwd":
        subs, table = dcv.forward_phases(w64.numpy(), pool, conv.oy, conv.ox)
        x = torch.tensor(rng.standard_normal((n, h, h)))
        got = dcv.by_tiles_reference(x, torch.tensor(subs), table, pl, pool * pool, pool, 1,
                                     side, side)
        return x, got, dcv.direct_conv_reference(x, w64, pool, conv.oy, conv.ox)
    subs, table = dcv.transpose_phases(w64.numpy(), pool, conv.oy, conv.ox)
    ct = torch.tensor(rng.standard_normal((n, side, side)))
    got = dcv.by_tiles_reference(ct, torch.tensor(subs), table, pl, 1, 1, pool, side, side)
    return ct, got, dcv.direct_conv_transpose_reference(ct, w64, pool, conv.oy, conv.ox, h, h)


# (image side, PSF (kh, kw), pool, samples, plan batch, forced (rows, cols, rb, spb)):
# outputs of 24-80 px under the table's plans (the batch cut, not the width);
# sub-kernels of 1-3 tap rows and KW % 4 of 1, 2 and 3 under each thread
# tile; pools 1 and 3; packed samples and ragged edges
WALKS = [
    (160, (51, 51), 2, 1, 500, None), (128, (19, 19), 2, 2, 1536, None),
    (120, (27, 27), 2, 2, 64, None), (96, (19, 19), 2, 3, 1920, None),
    (96, (19, 19), 2, 2, 128, None), (48, (11, 11), 2, 3, 128, None),
    (24, (5, 5), 2, 3, 4, (5, 5, 3, 2)), (24, (3, 3), 2, 3, 4, (5, 3, 3, 1)),
    (20, (1, 1), 2, 2, 4, (5, 2, 2, 1)), (20, (8, 8), 2, 2, 4, (2, 2, 3, 1)),
    (22, (13, 13), 2, 3, 4, (2, 2, 4, 1)), (42, (9, 9), 3, 3, 8, None),
    (25, (9, 7), 1, 3, 8, None), (34, (11, 11), 2, 3, 8, None),
]


@pytest.mark.parametrize("h,psf,pool,n,pl_bs,forced", WALKS)
def test_tile_walk_matches_plain_and_jax(h, psf, pool, n, pl_bs, forced):
    """by_tiles_reference (the kernel's blocks, halos, packed samples and
    ragged edges under a plan, its tap order) against the plain tap sums in
    float64 (the same sums in another arrangement: 1e-12) and, forward, the
    JAX package's K4 (its plain DFT path) in float32 at REL."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(h * 31 + psf[0])
    kern = rng.random(psf)
    kern /= kern.sum()
    for direction in ("fwd", "transpose"):
        x, got, want = _walk_case(h, kern, pool, n, pl_bs, direction, rng, forced)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)
        if direction == "fwd":
            jconv = JPSFConv(kern.astype(np.float32), (h, h), mode="dft", pool=pool,
                             pallas=False)
            _close(got, jconv(jnp.asarray(x.numpy().astype(np.float32))))


def test_non_cpu_tensors_reach_the_kernel_checks():
    """Only CPU tensors take the plain version: a meta tensor must reach the
    wrapper's checks (and without a card, raise), never fall back."""
    conv = _conv(_kernel(9, 9), 2)
    with pytest.raises(ValueError, match="CUDA"):
        conv(torch.empty(1, 40, 40, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        dcv.direct_conv_cuda(torch.empty(1, 20, 20, device="meta"), conv, "transpose")


def test_build_fails_on_direct_kernel_spills():
    """chip_smoke's build gate reads ptxas -v: spill bytes in a variant of
    the direct K4 are reported (and fail the run there), spills of other
    kernels and spill-free variants are not."""
    import chip_smoke

    log = """ptxas info    : Compiling entry function '_Z11direct_convILi5ELi5ELi2EEv' for 'sm_90a'
ptxas info    : Function properties for _Z11direct_convILi5ELi5ELi2EEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Function properties for _Z11direct_convILi5ELi3ELi1EEv
    16 bytes stack frame, 12 bytes spill stores, 20 bytes spill loads
ptxas info    : Function properties for _Z8pair_gemmv
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
"""
    assert chip_smoke.direct_spills(log) == {"_Z11direct_convILi5ELi3ELi1EEv": (12, 20)}
    assert chip_smoke.direct_spills(log.replace("12 bytes spill stores, 20", "0 bytes spill stores, 0")) == {}
