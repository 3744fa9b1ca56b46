"""The profiles this slice ports (Shapelets, CoreSersic, SIS, SIE, NFW,
NFW_ELLIPSE) and ``interop.phys_model_from_reference`` against the JAX
package.

Float32 on both sides, the same inputs from numpy: rtol 1e-5 and atol 1e-5
of the max (1e-4 for NFW, whose arccosh/arccos closed forms round
differently in the two libraries), as tests/test_torch_profiles.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigalens_tpu import PhysicalModel as JPhysicalModel
from gigalens_tpu.profiles.light.sersic import CoreSersic as JCoreSersic
from gigalens_tpu.profiles.light.sersic import Sersic as JSersic
from gigalens_tpu.profiles.light.shapelets import Shapelets as JShapelets
from gigalens_tpu.profiles.mass import nfw as jnfw
from gigalens_tpu.profiles.mass.epl import EPL as JEPL
from gigalens_tpu.profiles.mass.shear import Shear as JShear
from gigalens_tpu.profiles.mass.sie import SIE as JSIE
from gigalens_tpu.profiles.mass.sie import SIS as JSIS
from gigalens_tpu_torch.interop import phys_model_from_reference
from gigalens_tpu_torch.profiles.light import CoreSersic, Sersic, SersicEllipse, Shapelets
from gigalens_tpu_torch.profiles.mass import EPL, NFW, NFW_ELLIPSE, SIE, SIS, Shear
from gigalens_tpu_torch.profiles.mass import nfw

RTOL = 1e-5


def _coords(n=1500, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-2, 2, n).astype(np.float32), rng.uniform(-2, 2, n).astype(np.float32)


def _both(params, bs=3, seed=1):
    """(jax kwargs, torch kwargs) of (bs, 1) columns drawn uniformly."""
    rng = np.random.default_rng(seed)
    cols = {k: rng.uniform(lo, hi, (bs, 1)).astype(np.float32) for k, (lo, hi) in params.items()}
    return ({k: jnp.asarray(v) for k, v in cols.items()},
            {k: torch.tensor(v) for k, v in cols.items()})


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=rtol * np.abs(want).max())


MASS_CASES = {
    "SIS": (JSIS, SIS, dict(theta_E=(0.5, 1.5), center_x=(-0.2, 0.2), center_y=(-0.2, 0.2))),
    "SIE": (JSIE, SIE, dict(theta_E=(0.5, 1.5), e1=(-0.3, 0.3), e2=(-0.3, 0.3),
                            center_x=(-0.2, 0.2), center_y=(-0.2, 0.2))),
    "NFW": (jnfw.NFW, NFW, dict(Rs=(0.5, 3.0), alpha_Rs=(1.0, 4.0), center_x=(-0.2, 0.2),
                                center_y=(-0.2, 0.2))),
    "NFW_ELLIPSE": (jnfw.NFW_ELLIPSE, NFW_ELLIPSE, dict(
        Rs=(0.5, 3.0), alpha_Rs=(1.0, 4.0), e1=(-0.3, 0.3), e2=(-0.3, 0.3),
        center_x=(-0.2, 0.2), center_y=(-0.2, 0.2))),
}


@pytest.mark.quick
@pytest.mark.parametrize("name", sorted(MASS_CASES))
def test_mass_deriv_matches_jax(name):
    jcls, tcls, ranges = MASS_CASES[name]
    x, y = _coords()
    jp, tp = _both(ranges)
    want = jcls().deriv(jnp.asarray(x), jnp.asarray(y), **jp)
    got = tcls().deriv(torch.tensor(x), torch.tensor(y), **tp)
    rtol = 1e-4 if name.startswith("NFW") else RTOL
    for g, w in zip(got, want):
        assert g.shape == (3, 1500)
        _close(g.numpy(), w, rtol)


def test_sie_and_sis_degenerate_points():
    """SIE at exactly zero ellipticity (the 1 - q^2 floor: the SIS limit,
    finite gradient) and SIS with a pixel on its center (zero deflection,
    finite gradient), as in JAX."""
    x = torch.tensor([0.0, 0.3, -0.7])
    y = torch.tensor([0.0, 0.4, 0.1])
    te = torch.tensor(1.2, requires_grad=True)
    e = torch.zeros((), requires_grad=True)
    ax, ay = SIE().deriv(x[1:], y[1:], te, e, e, 0.0, 0.0)
    sx, sy = SIS().deriv(x, y, te, 0.0, 0.0)
    _close(ax.detach().numpy(), sx[1:].detach().numpy(), 1e-5)
    g = torch.autograd.grad((ax + ay).sum() + (sx + sy).sum(), (te, e))
    assert all(torch.isfinite(t) for t in g)
    assert float(sx[0].detach()) == float(sy[0].detach()) == 0.0
    want = JSIS().deriv(jnp.asarray([0.0, 0.3, -0.7]), jnp.asarray([0.0, 0.4, 0.1]), 1.2, 0.0, 0.0)
    _close(sx.detach().numpy(), want[0])


def test_nfw_branch_edges_f64():
    """F-ref-2: the closed forms' inputs stay their own at the series
    window's edges (x = 1 -/+ 0.03 in float64), so g there is the true
    closed form, which the branch-point series matches to its truncation
    error; JAX's strict inequalities put a placeholder there instead."""
    xs = torch.tensor([0.97, 1.03], dtype=torch.float64, requires_grad=True)
    g = nfw._nfw_g(xs)
    t = xs.detach() - 1.0
    series = nfw._horner(t, nfw._G_SERIES)
    np.testing.assert_allclose(g.detach().numpy(), series.numpy(), rtol=1e-6)
    (dg,) = torch.autograd.grad(g.sum(), xs)
    assert torch.isfinite(dg).all()
    # elsewhere the two packages agree in float64
    x64 = np.concatenate([np.linspace(1e-3, 0.96, 50), np.linspace(1.04, 4.0, 50), [1.0]])
    with jax.enable_x64(True):
        want = np.asarray(jnfw._nfw_g(jnp.asarray(x64)))
    np.testing.assert_allclose(nfw._nfw_g(torch.tensor(x64)).numpy(), want, rtol=1e-12)


def test_core_sersic_matches_jax():
    x, y = _coords(seed=2)
    ranges = dict(R_sersic=(0.5, 1.5), n_sersic=(1.0, 4.0), Rb=(0.05, 0.2), alpha=(1.5, 3.0),
                  gamma=(-0.3, 0.3), e1=(-0.2, 0.2), e2=(-0.2, 0.2), center_x=(-0.2, 0.2),
                  center_y=(-0.2, 0.2), Ie=(50.0, 200.0))
    jp, tp = _both(ranges, seed=3)
    want = JCoreSersic().light(jnp.asarray(x), jnp.asarray(y), **jp)
    _close(CoreSersic().light(torch.tensor(x), torch.tensor(y), **tp).numpy(), want)
    jp.pop("Ie"), tp.pop("Ie")
    want = JCoreSersic(use_lstsq=True).light(jnp.asarray(x), jnp.asarray(y), **jp)
    got = CoreSersic(use_lstsq=True).light(torch.tensor(x), torch.tensor(y), **tp)
    assert got.shape == (1, 3, 1500)
    _close(got.numpy(), want)


@pytest.mark.parametrize("use_lstsq", [False, True])
def test_shapelets_match_jax(use_lstsq):
    x, y = _coords(seed=4)
    jsh, sh = JShapelets(4, use_lstsq=use_lstsq), Shapelets(4, use_lstsq=use_lstsq)
    assert sh.params == jsh.params and sh.depth == jsh.depth == 15
    np.testing.assert_array_equal(sh._prefactor, np.asarray(jsh._prefactor))
    ranges = dict(beta=(0.2, 0.5), center_x=(-0.2, 0.2), center_y=(-0.2, 0.2))
    if not use_lstsq:
        ranges.update({a: (-1.0, 1.0) for a in sh._amp_names})
    jp, tp = _both(ranges, seed=5)
    want = jsh.light(jnp.asarray(x), jnp.asarray(y), **jp)
    got = sh.light(torch.tensor(x), torch.tensor(y), **tp)
    assert got.shape == ((15, 3, 1500) if use_lstsq else (3, 1500))
    _close(got.numpy(), want)


def test_shapelets_bookkeeping():
    sh = Shapelets(10)
    assert sh._amp_names[:3] == ["amp00", "amp01", "amp02"] and len(sh._amp_names) == 66
    assert sh._prefactor.dtype == np.float32
    assert list(zip(sh._n1[:6], sh._n2[:6])) == [(0, 0), (1, 0), (0, 1), (2, 0), (1, 1), (0, 2)]
    sh.use_lstsq = True
    assert sh.params == ["beta", "center_x", "center_y"] and sh.use_lstsq
    sh.use_lstsq = False
    assert sh.params[3:] == sh._amp_names
    s = Sersic()
    s.use_lstsq = True
    assert "Ie" not in s.params and s.depth == 1
    s.use_lstsq = False
    assert s.params == JSersic().params
    with pytest.raises(NotImplementedError):
        Shapelets(3, interpolate=True)


def test_phys_model_from_reference():
    """Profiles by class name with their static settings, and constants."""
    jphys = JPhysicalModel(
        [JEPL(23), JSIE(), jnfw.NFW_ELLIPSE(), JShear()],
        [JCoreSersic(use_lstsq=True)],
        [JShapelets(3, use_lstsq=True)],
        lenses_constants=[dict(gamma=2.1), {}, dict(Rs=5.0), {}],
        source_light_constants=[dict(beta=0.3)],
    )
    phys = phys_model_from_reference(jphys)
    assert [type(p) for p in phys.lenses] == [EPL, SIE, NFW_ELLIPSE, Shear]
    assert phys.lenses[0].niter == 23
    assert type(phys.lens_light[0]) is CoreSersic and phys.lens_light[0].use_lstsq
    sh = phys.source_light[0]
    assert type(sh) is Shapelets and sh.n_max == 3 and sh.use_lstsq and sh.depth == 10
    assert float(phys.lenses_constants[0]["gamma"]) == pytest.approx(2.1)
    assert float(phys.lenses_constants[2]["Rs"]) == 5.0
    assert float(phys.source_light_constants[0]["beta"]) == pytest.approx(0.3)
    assert phys.lens_light_constants == [{}]
    assert SersicEllipse().params == ["R_sersic", "n_sersic", "e1", "e2", "center_x",
                                      "center_y", "Ie"]
