"""Composable fused-render twins (K5/K6/K7's plain versions) against the JAX
builder in interpret mode, on the same packed matrix.

Models and inputs follow tests/test_fused_builder.py (BS 5, NPIX 300, numpy
seeds). Tolerances, of the reference's max |value| (float32 on both sides):
values 2e-5 and gradients 1e-4; the NFW family 5e-4 and 5e-3, since the
JAX tile's polynomial atan2 and its op order differ from native atan2 by
float32 ulps that deflections of several arcsec into a steep Sersic
amplify (the JAX test's own bounds for that family).
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
from gigalens_tpu_torch.profiles.base import MassProfile
from gigalens_tpu_torch.profiles.light import SersicEllipse, Shapelets
from gigalens_tpu_torch.profiles.mass import EPL, Shear

BS, NPIX = 5, 300
TOL = {"nfw_ellipse_halo": (5e-4, 5e-3)}
DEFAULT_TOL = (2e-5, 1e-4)


def _lstsq_model():
    return JPhysicalModel([JEPL(18), JShear()], [JSersicEllipse(use_lstsq=True)],
                          [JShapelets(4, use_lstsq=True)])


def _case(jphys, seed):
    """(JAX spec, port spec, packed matrix as numpy, x, y) for one model."""
    jspec = jfb.build_spec(jphys)
    spec = fb.build_spec(phys_model_from_reference(jphys))
    rng = np.random.default_rng(seed)
    params = _rand_params(jphys, BS, rng)
    x = rng.uniform(-2, 2, NPIX).astype(np.float32)
    y = rng.uniform(-2, 2, NPIX).astype(np.float32)
    packed = np.asarray(jspec.pack(params))
    return jspec, spec, packed, x, y, rng


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.quick
@pytest.mark.parametrize("name", sorted(MODELS) + ["lstsq"])
def test_pack_layout_matches_jax(name):
    jphys = _lstsq_model() if name == "lstsq" else MODELS[name]()
    jspec, spec, packed, _, _, _ = _case(jphys, 0)
    assert spec is not None
    assert spec.pack_cols == jspec.pack_cols
    assert (spec.n_cols, spec.depth, spec.all_lstsq, spec.any_lstsq) == (
        jspec.n_cols, jspec.depth, jspec.all_lstsq, jspec.any_lstsq)
    assert spec.label == jspec.label
    rng = np.random.default_rng(0)
    params = tree_to_torch(jax.tree_util.tree_map(np.asarray, _rand_params(jphys, BS, rng)),
                           device="cpu")
    np.testing.assert_array_equal(spec.pack(params).numpy(), packed)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_sum_twin_matches_jax(name):
    jspec, spec, packed, x, y, _ = _case(MODELS[name](), 0)
    want = np.asarray(jfb.fused_render_sum(jnp.asarray(packed), jnp.asarray(x),
                                           jnp.asarray(y), (), jspec, True))
    got = fb.fused_render_sum(torch.tensor(packed), torch.tensor(x), torch.tensor(y), (), spec)
    assert got.shape == (BS, NPIX)
    assert _max_rel(got.numpy(), want) <= TOL.get(name, DEFAULT_TOL)[0]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_sum_gradient_matches_jax(name):
    """Autograd through the CPU path (the hand-VJP twin) against jax.grad of
    the interpret-mode kernel, every packed column (constants included)."""
    jspec, spec, packed, x, y, rng = _case(MODELS[name](), 1)
    ct = rng.normal(size=(BS, NPIX)).astype(np.float32)
    want = np.asarray(jax.grad(lambda pk: jnp.sum(ct * jfb.fused_render_sum(
        pk, jnp.asarray(x), jnp.asarray(y), (), jspec, True)))(jnp.asarray(packed)))
    p = torch.tensor(packed, requires_grad=True)
    out = fb.fused_render_sum(p, torch.tensor(x), torch.tensor(y), (), spec)
    (got,) = torch.autograd.grad((out * torch.tensor(ct)).sum(), p)
    assert _max_rel(got.numpy(), want) <= TOL.get(name, DEFAULT_TOL)[1]


def test_components_lstsq_matches_jax():
    """K6/K7-components twins on the lstsq family (depth 16), values and
    gradients, against fused_render_components in interpret mode."""
    jspec, spec, packed, x, y, rng = _case(_lstsq_model(), 2)
    assert spec.depth == 16 and spec.all_lstsq
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    want = np.asarray(jfb.fused_render_components(jnp.asarray(packed), jx, jy, (), jspec, True))
    p = torch.tensor(packed, requires_grad=True)
    got = fb.fused_render_components(p, torch.tensor(x), torch.tensor(y), (), spec)
    assert got.shape == (16, BS, NPIX)
    assert _max_rel(got.detach().numpy(), want) <= DEFAULT_TOL[0]
    ct = rng.normal(size=(16, BS, NPIX)).astype(np.float32)
    g_want = np.asarray(jax.grad(lambda pk: jnp.sum(ct * jfb.fused_render_components(
        pk, jx, jy, (), jspec, True)))(jnp.asarray(packed)))
    (g,) = torch.autograd.grad((got * torch.tensor(ct)).sum(), p)
    assert _max_rel(g.numpy(), g_want) <= DEFAULT_TOL[1]
    # the summed render of an lstsq spec is the sum of its components
    total = fb.fused_render_sum(p.detach(), torch.tensor(x), torch.tensor(y), (), spec)
    np.testing.assert_allclose(total.numpy(), got.detach().sum(0).numpy(), rtol=1e-5,
                               atol=1e-5 * np.abs(want).sum(0).max())


def test_series_stage_matches_jax():
    """The Taylor-series stage, with extras from a JAX
    MassSeries(DPIE(), "r_cut", "theta_E", order=3) passed in as numpy
    (MassSeries itself is not ported yet, so the port's spec is built from
    stage records)."""
    from gigalens_tpu.profiles.mass.dpie import DPIE
    from gigalens_tpu.profiles.mass.series import MassSeries

    rng = np.random.default_rng(4)
    x = rng.uniform(-2, 2, NPIX).astype(np.float32)
    y = rng.uniform(-2, 2, NPIX).astype(np.float32)
    series = MassSeries(DPIE(), "r_cut", "theta_E", order=3)
    series.set_constants(dict(r_cut=1.5, r_core=0.08, e1=0.05, e2=-0.03,
                              center_x=0.1, center_y=-0.2, theta_E=1.0))
    series.set_grid(jnp.asarray(x), jnp.asarray(y))
    series.set_deriv()
    jphys = JPhysicalModel([series, JShear()], [], [JSersicEllipse()])
    jspec = jfb.build_spec(jphys)
    extras = jspec.gather_extras(jnp.asarray(x), jnp.asarray(y))
    assert extras[0].shape == (8, NPIX)  # 2 (order + 1) rows, no padding
    params = _rand_params(jphys, BS, rng)
    params["lens_mass"][0] = dict(
        r_cut=jnp.asarray(rng.uniform(1.3, 1.7, BS), jnp.float32),
        theta_E=jnp.asarray(rng.uniform(0.5, 1.5, BS), jnp.float32))
    packed = np.asarray(jspec.pack(params))

    spec = fb.FusedSpec(
        [fb.Stage(fb.SERIES, 0, order=3, extra=0), fb.Stage(fb.SHEAR, 2),
         fb.Stage(fb.SERSIC_E, 4, is_source=True)],
        [c[:3] if isinstance(c, tuple) else c for c in jspec.pack_cols])
    ex = (torch.tensor(np.asarray(extras[0])),)
    want = np.asarray(jfb.fused_render_sum(jnp.asarray(packed), jnp.asarray(x),
                                           jnp.asarray(y), extras, jspec, True))
    p = torch.tensor(packed, requires_grad=True)
    got = fb.fused_render_sum(p, torch.tensor(x), torch.tensor(y), ex, spec)
    assert _max_rel(got.detach().numpy(), want) <= DEFAULT_TOL[0]
    ct = rng.normal(size=(BS, NPIX)).astype(np.float32)
    g_want = np.asarray(jax.grad(lambda pk: jnp.sum(ct * jfb.fused_render_sum(
        pk, jnp.asarray(x), jnp.asarray(y), extras, jspec, True)))(jnp.asarray(packed)))
    (g,) = torch.autograd.grad((got * torch.tensor(ct)).sum(), p)
    assert _max_rel(g.numpy(), g_want) <= DEFAULT_TOL[1]


def test_build_spec_none_where_jax_is():
    class Unported(MassProfile):
        _name = "UNPORTED"
        _params = []

        def deriv(self, x, y):
            return x, y

    # no stage for the profile
    assert fb.build_spec(PhysicalModel([Unported()], [], [SersicEllipse()])) is None
    # mixed lstsq / sampled amplitudes stay unfused, as in JAX
    mixed = [EPL(18)], [SersicEllipse(use_lstsq=True)], [SersicEllipse()]
    assert fb.build_spec(PhysicalModel(*mixed)) is None
    assert jfb.build_spec(JPhysicalModel(
        [JEPL(18)], [JSersicEllipse(use_lstsq=True)], [JSersicEllipse()])) is None
    # no light profile at all
    assert fb.build_spec(PhysicalModel([EPL(18), Shear()], [], [])) is None
    assert jfb.build_spec(JPhysicalModel([JEPL(18), JShear()], [], [])) is None


def test_non_cpu_tensors_and_caps_raise():
    """Only CPU tensors take the twins; anything else reaches the kernel
    wrapper's checks (here, without a card, they raise). A shapelet order
    above the kernels' cap, or a components render of a sampled-amplitude
    spec, raises before any launch."""
    spec = fb.build_spec(PhysicalModel([EPL(18), Shear()], [], [Shapelets(3)]))
    meta = torch.empty((2, spec.n_cols), device="meta")
    xm = torch.empty((10,), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fb.fused_builder_fwd(spec, meta, xm, xm)
    with pytest.raises(ValueError, match="CUDA"):
        fb.fused_builder_bwd(spec, meta, xm, xm, (), torch.empty((2, 10), device="meta"))
    with pytest.raises(ValueError, match="lstsq"):
        fb.fused_builder_fwd(spec, meta, xm, xm, summed=False)
    big = fb.build_spec(PhysicalModel([EPL(18)], [], [Shapelets(fb.SHAPELET_CAP + 1)]))
    with pytest.raises(ValueError, match="cap"):
        fb.fused_builder_fwd(big, torch.empty((2, big.n_cols), device="meta"), xm, xm)
