"""K7's plain version in its two stages (per-stage constants, pixel terms of
per-sample quantities, then a per-sample epilogue) and K5/K6's two-stage
forward, against float64 torch autograd of the one-stage forward, the
one-stage hand VJP, and the JAX builder's ``jax.grad`` in interpret mode.

Sizes: bs 4, 700 pixels (off the kernels' 256-pixel tile grid; the lstsq and
two-EPL cases 300 to keep the JAX interpret run short). Tolerances: float64,
1e-9 of each column's max |gradient| against autograd and the one-stage hand
VJP (only rounding separates them; measured ~1e-13) and 1e-11 of the max
|value| for the forward; float32 against JAX, the bounds of
tests/test_torch_fused_builder.py (2e-5 / 1e-4 of the reference's max, the
NFW family 5e-4 / 5e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_fused_builder import MODELS, _rand_params

from gigalens_tpu import PhysicalModel as JPhysicalModel
from gigalens_tpu.ops.pallas import fused_builder as jfb
from gigalens_tpu.profiles.light.sersic import SersicEllipse as JSersicEllipse
from gigalens_tpu.profiles.light.shapelets import Shapelets as JShapelets
from gigalens_tpu.profiles.mass.epl import EPL as JEPL
from gigalens_tpu.profiles.mass.shear import Shear as JShear
from gigalens_tpu_torch import PhysicalModel
from gigalens_tpu_torch.interop import phys_model_from_reference, tree_to_torch
from gigalens_tpu_torch.ops.cuda import fused_builder as fb
from gigalens_tpu_torch.ops.cuda import fused_render as fr
from gigalens_tpu_torch.profiles.light import Shapelets
from gigalens_tpu_torch.profiles.mass import EPL, Shear

BS, NPIX = 4, 700
F64 = torch.float64
TOL = {"nfw_ellipse_halo": (5e-4, 5e-3)}
DEFAULT_TOL = (2e-5, 1e-4)


def _models():
    m = {name: make() for name, make in MODELS.items()}
    m["lstsq"] = JPhysicalModel([JEPL(18), JShear()], [JSersicEllipse(use_lstsq=True)],
                                [JShapelets(4, use_lstsq=True)])
    # two EPL stages: two slots, two series tables, two kept Omegas
    m["two_epl"] = JPhysicalModel([JEPL(8), JEPL(23), JShear()], [JSersicEllipse()],
                                  [JShapelets(3)])
    return m


JMODELS = _models()


def _col_rel(got, want):
    err = (got - want).abs().amax(0)
    return float((err / want.abs().amax(0).clamp_min(1e-300)).max())


def _case(name, seed, npix=NPIX, dtype=F64):
    jphys = JMODELS[name]
    spec = fb.build_spec(phys_model_from_reference(jphys))
    rng = np.random.default_rng(seed)
    jparams = _rand_params(jphys, BS, rng)
    params = tree_to_torch(jax.tree_util.tree_map(np.asarray, jparams), device="cpu",
                           dtype=dtype)
    x = torch.tensor(rng.uniform(-2, 2, npix), dtype=dtype)
    y = torch.tensor(rng.uniform(-2, 2, npix), dtype=dtype)
    return jphys, spec, spec.pack(params), x, y, rng


def _autograd(spec, p, x, y, ct, summed):
    p = p.clone().requires_grad_(True)
    out = fb.fused_builder_reference(spec, p, x, y, (), summed)
    return torch.autograd.grad((out * ct).sum(), p)[0]


@pytest.mark.quick
@pytest.mark.parametrize("name", sorted(JMODELS))
def test_two_stage_vjp_matches_autograd_and_one_stage_f64(name):
    _, spec, p, x, y, rng = _case(name, 3)
    modes = [True] + ([False] if spec.all_lstsq else [])
    for summed in modes:
        shape = (BS, NPIX) if summed else (spec.depth, BS, NPIX)
        ct = torch.tensor(rng.normal(size=shape))
        got = fb.tile_backward_reference(spec, p, x, y, (), ct, summed)
        assert got.shape == (BS, spec.n_cols) and got.dtype == F64
        assert _col_rel(got, _autograd(spec, p, x, y, ct, summed)) <= 1e-9
        assert _col_rel(got, fb.tile_backward_onestage(spec, p, x, y, (), ct, summed)) <= 1e-9


@pytest.mark.parametrize("name", sorted(JMODELS))
def test_pixel_terms_and_epilogue_are_the_two_stages(name):
    """The sums have one column per term, in ``sum_offsets`` order; the
    epilogue of their sums is the twin; the epilogue is linear."""
    _, spec, p, x, y, rng = _case(name, 4)
    ct = torch.tensor(rng.normal(size=(BS, NPIX)))
    offs, n_sums = fb.sum_offsets(spec)
    assert [offs[st] for st in spec.mass + spec.light] == sorted(offs.values())
    assert n_sums == sum(fb.stage_sums(st) for st in spec.stages)
    terms = fb.bwd_pixel_terms(spec, p, x, y, (), ct, True)
    assert len(terms) == n_sums
    sums = torch.stack([torch.broadcast_to(t, ct.shape).sum(-1) for t in terms], -1)
    got = fb.builder_bwd_epilogue(spec, p, sums)
    np.testing.assert_array_equal(
        got.numpy(), fb.tile_backward_reference(spec, p, x, y, (), ct, True).numpy())
    a, b = (torch.tensor(rng.normal(size=(BS, n_sums))) for _ in range(2))
    lhs = fb.builder_bwd_epilogue(spec, p, 2.0 * a - 3.0 * b)
    rhs = 2.0 * fb.builder_bwd_epilogue(spec, p, a) - 3.0 * fb.builder_bwd_epilogue(spec, p, b)
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), rtol=1e-10, atol=1e-10 * float(
        rhs.abs().max()))


@pytest.mark.parametrize("name", sorted(JMODELS))
def test_two_stage_forward_matches_one_stage_f64(name):
    _, spec, p, x, y, _ = _case(name, 5)
    for summed in [True] + ([False] if spec.all_lstsq else []):
        got = fb.tile_forward_twostage(spec, p, x, y, (), summed)
        want = fb.fused_builder_reference(spec, p, x, y, (), summed)
        assert got.shape == want.shape
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-11


@pytest.mark.parametrize("name", ["legacy_pattern", "nfw_ellipse_halo", "sis_coresersic",
                                  "two_epl"])
def test_two_stage_gradient_matches_jax_grad(name):
    """float32, the hand-VJP twin against jax.grad of the interpret-mode
    builder kernel, every packed column (constants included)."""
    jphys, spec, p, x, y, rng = _case(name, 1, npix=300, dtype=torch.float32)
    jspec = jfb.build_spec(jphys)
    ct = rng.normal(size=(BS, 300)).astype(np.float32)
    jx, jy = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())
    want = np.asarray(jax.grad(lambda pk: jnp.sum(ct * jfb.fused_render_sum(
        pk, jx, jy, (), jspec, True)))(jnp.asarray(p.numpy())))
    got = fb.fused_builder_bwd(spec, p, x, y, (), torch.tensor(ct), True)
    tol = TOL.get(name, DEFAULT_TOL)[1]
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() <= tol
    out = fb.fused_builder_fwd(spec, p, x, y, (), True)
    out_j = np.asarray(jfb.fused_render_sum(jnp.asarray(p.numpy()), jx, jy, (), jspec, True))
    assert np.abs(out.numpy() - out_j).max() / np.abs(out_j).max() <= TOL.get(
        name, DEFAULT_TOL)[0]


@pytest.mark.parametrize("e1_sign", [1.0, -1.0, 0.0])
def test_half_angle_branches_and_zero_ellipticity(e1_sign):
    """e1 >= 0, e1 < 0 and e1 = e2 = 0 through every elliptical stage."""
    for name in ("legacy_pattern", "nfw_ellipse_halo", "sis_coresersic"):
        _, spec, p, x, y, rng = _case(name, 6)
        for i, c in enumerate(spec.pack_cols):
            if isinstance(c, tuple) and c[2] == "e1":
                p[:, i] = e1_sign * p[:, i].abs()
            if isinstance(c, tuple) and c[2] == "e2" and e1_sign == 0.0:
                p[:, i] = 0.0
        ct = torch.tensor(rng.normal(size=(BS, NPIX)))
        if e1_sign == 0.0:
            g = fb.tile_backward_reference(spec, p.float(), x.float(), y.float(), (), ct.float(),
                                           True)
            assert torch.isfinite(g).all()
        else:
            got = fb.tile_backward_reference(spec, p, x, y, (), ct, True)
            assert _col_rel(got, _autograd(spec, p, x, y, ct, True)) <= 1e-9


def test_programs_beyond_the_kernels_limits_raise_before_launch():
    xm = torch.empty((10,), device="meta")
    # an EPL series deeper than the per-sample table
    deep = fb.build_spec(PhysicalModel([EPL(fr.MAX_NITER + 1), Shear()], [], [Shapelets(2)]))
    pm = torch.empty((2, deep.n_cols), device="meta")
    with pytest.raises(ValueError, match="niter"):
        fb.fused_builder_fwd(deep, pm, xm, xm)
    with pytest.raises(ValueError, match="niter"):
        fb.fused_builder_bwd(deep, pm, xm, xm, (), torch.empty((2, 10), device="meta"))
    # more sums columns than a block's shared memory holds: K7 refuses, K5 fits
    wide = fb.build_spec(PhysicalModel([EPL(18)], [], [Shapelets(10)] * 4))
    _, n_sums = fb.sum_offsets(wide)
    assert fb.smem_bytes(wide, n_sums, bwd=True) > fb.MAX_SMEM >= fb.smem_bytes(wide, n_sums,
                                                                                bwd=False)
    pm = torch.empty((2, wide.n_cols), device="meta")
    with pytest.raises(ValueError, match="shared memory"):
        fb.fused_builder_bwd(wide, pm, xm, xm, (), torch.empty((2, 10), device="meta"))
    with pytest.raises(ValueError, match="CUDA"):  # passes the limits, then needs a card
        fb.fused_builder_fwd(wide, pm, xm, xm)
    # family S's width fits with room to spare
    fam = fb.build_spec(PhysicalModel([EPL(23), Shear()], [], [Shapelets(6)]))
    assert fb.smem_bytes(fam, fb.sum_offsets(fam)[1], bwd=True) < 64 * 1024
