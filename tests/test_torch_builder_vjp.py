"""The composable render's hand-derived VJPs (K7's twin) against torch
autograd of the forward twin, in float64.

Float64 takes rounding out of the comparison, so what remains is the
derivation itself: every stage's hand VJP must match autograd to rel 1e-6
of each column's max |gradient| (measured ~1e-13). Models follow
tests/test_fused_builder.py (BS 5, NPIX 300, numpy seeds).
"""
import jax
import numpy as np
import pytest
import torch
from test_fused_builder import MODELS, _rand_params

from gigalens_tpu import PhysicalModel as JPhysicalModel
from gigalens_tpu.profiles.light.sersic import SersicEllipse as JSersicEllipse
from gigalens_tpu.profiles.light.shapelets import Shapelets as JShapelets
from gigalens_tpu.profiles.mass.epl import EPL as JEPL
from gigalens_tpu.profiles.mass.shear import Shear as JShear
from gigalens_tpu_torch.interop import phys_model_from_reference, tree_to_torch
from gigalens_tpu_torch.ops.cuda import fused_builder as fb

BS, NPIX = 5, 300
REL = 1e-6
F64 = torch.float64


def _col_rel(got, want):
    """max over columns of max |got - want| / max |want| in that column."""
    err = (got - want).abs().amax(0)
    return float((err / want.abs().amax(0).clamp_min(1e-300)).max())


def _autograd(spec, p, x, y, extras, ct, summed):
    p = p.clone().requires_grad_(True)
    out = fb.fused_builder_reference(spec, p, x, y, extras, summed)
    return torch.autograd.grad((out * ct).sum(), p)[0]


def _model_case(jphys, seed):
    spec = fb.build_spec(phys_model_from_reference(jphys))
    rng = np.random.default_rng(seed)
    params = tree_to_torch(jax.tree_util.tree_map(np.asarray, _rand_params(jphys, BS, rng)),
                           dtype=F64)
    x = torch.tensor(rng.uniform(-2, 2, NPIX))
    y = torch.tensor(rng.uniform(-2, 2, NPIX))
    return spec, spec.pack(params), x, y, rng


@pytest.mark.quick
@pytest.mark.parametrize("name", sorted(MODELS))
def test_summed_vjp_matches_autograd_f64(name):
    spec, p, x, y, rng = _model_case(MODELS[name](), 3)
    ct = torch.tensor(rng.normal(size=(BS, NPIX)))
    want = _autograd(spec, p, x, y, (), ct, True)
    got = fb.tile_backward_reference(spec, p, x, y, (), ct, True)
    assert got.shape == (BS, spec.n_cols) and got.dtype == F64
    assert _col_rel(got, want) <= REL


@pytest.mark.parametrize("e1_sign", [1.0, -1.0])
def test_components_vjp_matches_autograd_f64(e1_sign):
    """The lstsq family (EPL + Shear, SersicEllipse[lstsq] +
    Shapelets(4)[lstsq]), on both branches of the half-angle rotation."""
    jphys = JPhysicalModel([JEPL(18), JShear()], [JSersicEllipse(use_lstsq=True)],
                           [JShapelets(4, use_lstsq=True)])
    spec, p, x, y, rng = _model_case(jphys, 4)
    p[:, [2, 10]] = e1_sign * p[:, [2, 10]].abs()  # EPL and lens-light e1
    ct = torch.tensor(rng.normal(size=(spec.depth, BS, NPIX)))
    want = _autograd(spec, p, x, y, (), ct, False)
    got = fb.tile_backward_reference(spec, p, x, y, (), ct, False)
    assert _col_rel(got, want) <= REL
    # summed mode of the same spec: every component shares the cotangent
    ct1 = ct[0]
    assert _col_rel(fb.tile_backward_reference(spec, p, x, y, (), ct1, True),
                    _autograd(spec, p, x, y, (), ct1, True)) <= REL


def test_series_stage_vjp_matches_autograd_f64():
    """Taylor-series stage on synthetic seeded coefficient grids."""
    rng = np.random.default_rng(5)
    order = 3
    spec = fb.FusedSpec(
        [fb.Stage(fb.SERIES, 0, order=order, extra=0), fb.Stage(fb.SIS, 2),
         fb.Stage(fb.SERSIC, 5, is_source=True)],
        [("lens_mass", 0, "dv"), ("lens_mass", 0, "amp"), ("lens_mass", 1, "theta_E"),
         ("lens_mass", 1, "center_x"), ("lens_mass", 1, "center_y"),
         ("source_light", 0, "R_sersic"), ("source_light", 0, "n_sersic"),
         ("source_light", 0, "center_x"), ("source_light", 0, "center_y"),
         ("source_light", 0, "Ie")])
    cols = [rng.uniform(-0.2, 0.2, BS), rng.uniform(0.5, 1.5, BS), rng.uniform(0.5, 1.0, BS),
            rng.uniform(-0.1, 0.1, BS), rng.uniform(-0.1, 0.1, BS), rng.uniform(0.3, 0.6, BS),
            rng.uniform(1.0, 3.0, BS), rng.uniform(-0.2, 0.2, BS), rng.uniform(-0.2, 0.2, BS),
            rng.uniform(50, 100, BS)]
    p = torch.tensor(np.stack(cols, -1))
    x = torch.tensor(rng.uniform(-2, 2, NPIX))
    y = torch.tensor(rng.uniform(-2, 2, NPIX))
    extras = (torch.tensor(rng.normal(0, 0.3, (2 * (order + 1), NPIX))),)
    ct = torch.tensor(rng.normal(size=(BS, NPIX)))
    want = _autograd(spec, p, x, y, extras, ct, True)
    got = fb.tile_backward_reference(spec, p, x, y, extras, ct, True)
    assert _col_rel(got, want) <= REL


def test_nfw_vjp_at_branch_edges_f64():
    """NFW and NFW_ELLIPSE pixels at x = R/Rs in {0.05, 0.97, 1.0, 1.03}
    (the small-x and branch-point series bands and their edges): finite
    gradients that match autograd."""
    xs = np.array([0.05, 0.97, 1.0, 1.03])
    Rs = 2.0
    x = torch.tensor(np.concatenate([xs * Rs, -xs * Rs / np.sqrt(2)]))
    y = torch.tensor(np.concatenate([np.zeros(4), xs * Rs / np.sqrt(2)]))
    for op, cols in ((fb.NFW, [Rs, 3.0, 0.0, 0.0]), (fb.NFW_E, [Rs, 3.0, 0.0, 0.0, 0.0, 0.0])):
        n = len(cols)
        spec = fb.FusedSpec(
            [fb.Stage(op, 0), fb.Stage(fb.SERSIC, n, is_source=True)],
            [("lens_mass", 0, str(i)) for i in range(n)] + [0.5, 2.0, 0.1, -0.1, 100.0])
        p = torch.tensor([cols + [0.5, 2.0, 0.1, -0.1, 100.0]], dtype=F64)
        ct = torch.ones((1, x.shape[0]), dtype=F64)
        got = fb.tile_backward_reference(spec, p, x, y, (), ct, True)
        assert torch.isfinite(got).all()
        assert _col_rel(got, _autograd(spec, p, x, y, (), ct, True)) <= REL
    # g(x) and its hand derivative against autograd, across both bands
    xg = torch.tensor(np.concatenate([xs, np.linspace(1e-3, 3.0, 301)]), requires_grad=True)
    (dg,) = torch.autograd.grad(fb._nfw_g_tile(xg).sum(), xg)
    g, dg_hand = fb._nfw_g_tile_bwd(xg.detach())
    assert torch.isfinite(dg_hand).all()
    np.testing.assert_allclose(g.numpy(), fb._nfw_g_tile(xg.detach()).numpy(), rtol=1e-14)
    np.testing.assert_allclose(dg_hand.numpy(), dg.numpy(), rtol=1e-9, atol=1e-12)


def test_zero_ellipticity_gradient_finite():
    """A start at zero ellipticity everywhere (the prior mean) gives a
    finite float32 gradient through every elliptical stage."""
    spec, p, x, y, rng = _model_case(MODELS["nfw_ellipse_halo"](), 6)
    spec2, p2, _, _, _ = _model_case(MODELS["sie_sersic_shapelets"](), 6)
    for sp, pp in ((spec, p), (spec2, p2)):
        pp = pp.float()
        for i, c in enumerate(sp.pack_cols):
            if isinstance(c, tuple) and c[2] in ("e1", "e2"):
                pp[:, i] = 0.0
        g = fb.tile_backward_reference(sp, pp, x.float(), y.float(), (),
                                       torch.ones((BS, NPIX)), True)
        assert torch.isfinite(g).all()
