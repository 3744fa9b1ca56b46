"""Fused-render twins (K1/K2/K3's plain versions) against the JAX Pallas
kernel in interpret mode.

Sizes follow tests/test_fused_render.py (bs 3, 30x30 at supersample 2,
niter 18). Tolerances: forward rtol 1e-4 / atol 2e-3 (fluxes ~10^2, float32
on both sides); gradients rel <= 1e-3 per parameter column against
``jax.grad`` of the interpret-mode kernel; the hand-derived VJP against
torch autograd in float64, rel <= 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigalens_tpu.ops.pallas._math import half_angle as j_half_angle
from gigalens_tpu.ops.pallas.fused_render import fused_render as j_fused_render
from gigalens_tpu.ops.pallas.fused_render import pack_params as j_pack_params
from gigalens_tpu_torch.interop import tree_to_torch
from gigalens_tpu_torch.ops.cuda import fused_render as fr
from gigalens_tpu_torch.ops.cuda._math import half_angle, half_angle_bwd

NITER = 18


def _col_rel(got, want):
    """max |got - want| / max |want|, per parameter column."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max(0) / np.maximum(np.abs(want).max(0), 1e-30)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    bs = 3

    def rnd(lo, hi):
        return rng.uniform(lo, hi, bs).astype(np.float32)

    params = dict(
        lens_mass=[
            dict(theta_E=rnd(1.0, 1.5), gamma=rnd(1.8, 2.2), e1=rnd(0.02, 0.1),
                 e2=rnd(-0.1, -0.02), center_x=rnd(-0.02, 0.02), center_y=rnd(-0.02, 0.02)),
            dict(gamma1=rnd(-0.05, 0.05), gamma2=rnd(-0.05, 0.05)),
        ],
        lens_light=[
            dict(R_sersic=rnd(0.8, 1.2), n_sersic=rnd(2, 4), e1=rnd(-0.15, -0.05),
                 e2=rnd(0.02, 0.1), center_x=rnd(-0.02, 0.02), center_y=rnd(-0.02, 0.02),
                 Ie=rnd(80, 120)),
        ],
        source_light=[
            dict(R_sersic=rnd(0.2, 0.3), n_sersic=rnd(1, 2), e1=rnd(0.02, 0.1),
                 e2=rnd(-0.1, 0.1), center_x=rnd(0, 0.1), center_y=rnd(-0.1, 0),
                 Ie=rnd(40, 60)),
        ],
    )
    xs = ((np.arange(60) - 29.5) * 0.0325).astype(np.float32)
    X, Y = np.meshgrid(xs, xs)
    x, y = X.ravel(), Y.ravel()
    p_j = j_pack_params(jax.tree_util.tree_map(jnp.asarray, params))

    def loss(p):
        return jnp.sum(jnp.sin(j_fused_render(p, jnp.asarray(x), jnp.asarray(y), NITER, True) / 50.0))

    out_j = np.asarray(j_fused_render(p_j, jnp.asarray(x), jnp.asarray(y), NITER, True))
    grad_j = np.asarray(jax.grad(loss)(p_j))
    p_t = fr.pack_params(tree_to_torch(params, device="cpu"))
    return dict(p_j=np.asarray(p_j), p_t=p_t, x=torch.tensor(x), y=torch.tensor(y),
                out_j=out_j, grad_j=grad_j)


@pytest.mark.quick
def test_pack_params_matches_jax(setup):
    np.testing.assert_array_equal(setup["p_t"].numpy(), setup["p_j"])


def test_forward_reference_matches_jax_kernel(setup):
    got = fr.fused_render_reference(setup["p_t"], setup["x"], setup["y"], NITER)
    assert got.shape == (3, 3600)
    np.testing.assert_allclose(got.numpy(), setup["out_j"], rtol=1e-4, atol=2e-3)
    # the CPU wrapper (K1's twin) and the K2 twin give the same output: the
    # two-stage form, whose hoisted reciprocals (x * (1 / sqrt q) for
    # x / sqrt q, ...) move the one-stage image by a few float32 ulp
    # (measured 1.4e-6 relative)
    k1 = fr.fused_render_fwd(setup["p_t"], setup["x"], setup["y"], NITER)
    k2, ox, oy = fr.fused_render_fwd(setup["p_t"], setup["x"], setup["y"], NITER,
                                     save_omega=True)
    np.testing.assert_array_equal(k1.numpy(), k2.numpy())
    np.testing.assert_allclose(k1.numpy(), got.numpy(), rtol=1e-5, atol=0)
    np.testing.assert_allclose(k1.numpy(), setup["out_j"], rtol=1e-4, atol=2e-3)
    assert ox.shape == oy.shape == (3, 3600)


def test_autograd_gradient_matches_jax_kernel(setup):
    p = setup["p_t"].clone().requires_grad_(True)
    out = fr.fused_render_reference(p, setup["x"], setup["y"], NITER)
    (g,) = torch.autograd.grad(torch.sin(out / 50.0).sum(), p)
    assert _col_rel(g.numpy(), setup["grad_j"]).max() <= 1e-3


def test_hand_vjp_matches_jax_kernel(setup):
    p, x, y = setup["p_t"], setup["x"], setup["y"]
    out, ox, oy = fr.fused_render_fwd_reference(p, x, y, NITER)
    ct = torch.cos(out / 50.0) / 50.0
    g = fr.fused_render_bwd_reference(p, x, y, ox, oy, ct, NITER)
    assert g.shape == (3, 22)
    assert _col_rel(g.numpy(), setup["grad_j"]).max() <= 1e-3
    # through the autograd.Function (the CPU path of fused_render)
    pg = p.clone().requires_grad_(True)
    (g2,) = torch.autograd.grad(
        torch.sin(fr.fused_render(pg, x, y, NITER) / 50.0).sum(), pg)
    np.testing.assert_array_equal(g2.numpy(), g.numpy())


@pytest.mark.parametrize("e1_sign", [1.0, -1.0])
def test_hand_vjp_matches_autograd_f64(setup, e1_sign):
    """The derivation itself, free of float32 noise: rel <= 1e-6 in float64,
    on both branches of the half-angle rotation (e1 >= 0 and e1 < 0)."""
    p = setup["p_t"].double().clone()
    p[:, [2, 10, 17]] = e1_sign * p[:, [2, 10, 17]].abs()
    x, y = setup["x"].double(), setup["y"].double()
    ct = torch.tensor(np.random.default_rng(1).normal(size=(3, 3600)))
    pg = p.clone().requires_grad_(True)
    out = fr.fused_render_reference(pg, x, y, NITER)
    (want,) = torch.autograd.grad((out * ct).sum(), pg)
    _, ox, oy = fr.fused_render_fwd_reference(p, x, y, NITER)
    got = fr.fused_render_bwd_reference(p, x, y, ox, oy, ct, NITER)
    assert _col_rel(got.numpy(), want.numpy()).max() <= 1e-6


def test_zero_ellipticity_gradient_finite(setup):
    """A start at the prior mean (e1 = e2 = 0 everywhere) must give a finite
    gradient: the f >= 1e-20 floor and the half-angle guards."""
    p = setup["p_t"].clone()
    p[:, [2, 3, 10, 11, 17, 18]] = 0.0
    out, ox, oy = fr.fused_render_fwd_reference(p, setup["x"], setup["y"], NITER)
    g = fr.fused_render_bwd_reference(p, setup["x"], setup["y"], ox, oy,
                                      torch.ones_like(out), NITER)
    assert torch.isfinite(g).all()


def test_half_angle_matches_jax_and_its_vjp():
    rng = np.random.default_rng(0)
    e1 = np.concatenate([rng.normal(0, 0.1, 500), [0.0, 1e-13, -0.1, 0.1]]).astype(np.float32)
    e2 = np.concatenate([rng.normal(0, 0.1, 500), [0.0, 0.0, 1e-8, -1e-8]]).astype(np.float32)
    cp_j, sp_j = j_half_angle(jnp.asarray(e1), jnp.asarray(e2))
    cp, sp = half_angle(torch.tensor(e1), torch.tensor(e2))
    np.testing.assert_allclose(cp.numpy(), np.asarray(cp_j), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(sp.numpy(), np.asarray(sp_j), rtol=1e-6, atol=1e-7)
    # hand VJP vs autograd, float64
    a = torch.tensor(e1, dtype=torch.float64, requires_grad=True)
    b = torch.tensor(e2, dtype=torch.float64, requires_grad=True)
    w = torch.tensor(rng.normal(size=(2, e1.size)))
    c, s = half_angle(a, b)
    want = torch.autograd.grad((c * w[0] + s * w[1]).sum(), (a, b))
    got = half_angle_bwd(a.detach(), b.detach(), w[0], w[1])
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-9, atol=1e-12)


def test_non_cpu_tensors_never_take_the_twin(setup):
    """Only CPU tensors take the twin: anything else must reach the kernel
    wrapper's checks (and here, without a card, raise), never fall back."""
    meta = setup["p_t"].to("meta")
    xm, ym = setup["x"].to("meta"), setup["y"].to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        fr.fused_render_fwd(meta, xm, ym, NITER)
    with pytest.raises(ValueError, match="CUDA"):
        fr.fused_render_bwd(meta, xm, ym, xm, xm, xm, NITER)
    from gigalens_tpu_torch.ops.cuda import dft_conv as dc

    mats = [torch.empty(2, 2, device="meta")] * 10
    with pytest.raises(ValueError, match="CUDA"):
        dc.dft_conv_cuda(torch.empty(1, 2, 2, device="meta"), mats, "fwd")


def test_build_raises_without_nvcc(monkeypatch):
    """No nvcc: the build raises (there is no fallback to the twins)."""
    from gigalens_tpu_torch.ops.cuda import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "NVCC_DEFAULT", "/nonexistent/bin/nvcc")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
