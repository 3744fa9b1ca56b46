"""The rest of the single-plane profiles (NIE, TNFW, Hernquist,
HernquistEllipse, Multipole, PointMass, MassSheet, Gaussian, Moffat) and
``interop``'s name table for them, against the JAX package.

Float32 on both sides, the same numpy inputs: each field within rtol 1e-5
plus 1e-5 of its max |value| (1e-4 for the Hernquist pair, whose
arctanh/arctan closed forms round differently in the two libraries; 1e-3
for TNFW, whose closed form just above its small-x switch at X = 0.1
cancels to ~1e-4 relative in float32 on both sides, which the Hessian's
derivative amplifies: measured 4.4e-4 relative there); parameter gradients
of a summed field within 1e-4 of the per-column max.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigalens_tpu import PhysicalModel as JPhysicalModel
from gigalens_tpu.profiles.light import gaussian as jgauss
from gigalens_tpu.profiles.mass import hernquist as jhern
from gigalens_tpu.profiles.mass import multipole as jmult
from gigalens_tpu.profiles.mass import nfw as jnfw
from gigalens_tpu.profiles.mass import point as jpoint
from gigalens_tpu.profiles.mass import sie as jsie
from gigalens_tpu_torch.interop import phys_model_from_reference
from gigalens_tpu_torch.profiles.light import Gaussian, Moffat
from gigalens_tpu_torch.profiles.mass import (
    NIE,
    TNFW,
    Hernquist,
    HernquistEllipse,
    MassSheet,
    Multipole,
    PointMass,
)

RTOL = 1e-5
CENTER = dict(center_x=(-0.2, 0.2), center_y=(-0.2, 0.2))
ELL = dict(e1=(-0.3, 0.3), e2=(-0.3, 0.3))

# name: (JAX class, port class, constructor kwargs, parameter ranges, rtol)
MASS = {
    "NIE": (jsie.NIE, NIE, {}, dict(theta_E=(0.5, 1.5), s_scale=(0.02, 0.3), **ELL, **CENTER),
            RTOL),
    "TNFW": (jnfw.TNFW, TNFW, {}, dict(Rs=(0.5, 3.0), alpha_Rs=(1.0, 4.0), r_trunc=(2.0, 8.0),
                                       **CENTER), 1e-3),
    "Hernquist": (jhern.Hernquist, Hernquist, {}, dict(sigma0=(0.5, 2.0), Rs=(0.3, 2.0),
                                                       **CENTER), 1e-4),
    "HernquistEllipse": (jhern.HernquistEllipse, HernquistEllipse, {},
                         dict(sigma0=(0.5, 2.0), Rs=(0.3, 2.0), **ELL, **CENTER), 1e-4),
    "Multipole3": (jmult.Multipole, Multipole, dict(m=3), dict(a_m=(-0.1, 0.1),
                                                               phi_m=(-1.5, 1.5), **CENTER), RTOL),
    "Multipole4": (jmult.Multipole, Multipole, dict(m=4), dict(a_m=(-0.1, 0.1),
                                                               phi_m=(-1.5, 1.5), **CENTER), RTOL),
    "PointMass": (jpoint.PointMass, PointMass, {}, dict(theta_E=(0.3, 1.5), **CENTER), RTOL),
    "MassSheet": (jpoint.MassSheet, MassSheet, {}, dict(kappa=(-0.1, 0.3), **CENTER), RTOL),
}
LIGHT = {
    "Gaussian": (jgauss.Gaussian, Gaussian, dict(sigma=(0.2, 1.0), **ELL, **CENTER)),
    "Moffat": (jgauss.Moffat, Moffat, dict(rd=(0.2, 1.0), beta=(1.5, 4.0), **ELL, **CENTER)),
}


def _coords(n=1500, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3, 3, n).astype(np.float32)
    y = rng.uniform(-3, 3, n).astype(np.float32)
    # a point on each axis, and one at the origin, inside the parameter boxes
    x[:3], y[:3] = (1.7, 0.0, 0.0), (0.0, -1.3, 0.0)
    return x, y


def _draw(ranges, bs=3, seed=1):
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(lo, hi, (bs, 1)).astype(np.float32) for k, (lo, hi) in ranges.items()}


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=rtol * np.abs(want).max())


HAS_POTENTIAL = ("NIE", "PointMass", "MassSheet")  # the classes JAX gives a potential


def _fields(prof, x, y, p, torch_side):
    """deriv, hessian and (where the JAX class has one) potential."""
    out = {"deriv": prof.deriv(x, y, **p), "hessian": prof.hessian(x, y, **p)}
    if type(prof).__name__ in HAS_POTENTIAL:
        out["potential"] = (prof.potential(x, y, **p),)
    return {k: [np.asarray(v.detach() if torch_side else v) for v in vs]
            for k, vs in out.items()}


@pytest.mark.quick
@pytest.mark.parametrize("name", list(MASS))
def test_mass_fields_match_jax(name):
    jcls, tcls, kw, ranges, rtol = MASS[name]
    x, y = _coords()
    p = _draw(ranges)
    want = _fields(jcls(**kw), jnp.asarray(x), jnp.asarray(y),
                   {k: jnp.asarray(v) for k, v in p.items()}, False)
    got = _fields(tcls(**kw), torch.tensor(x), torch.tensor(y),
                  {k: torch.tensor(v) for k, v in p.items()}, True)
    assert got.keys() == want.keys()
    for field in want:
        for g, w in zip(got[field], want[field]):
            assert np.isfinite(g).all(), (name, field)
            _close(g, w, rtol)


@pytest.mark.parametrize("name", list(MASS))
def test_mass_parameter_gradients_match_jax(name):
    """The gradient of sum(alpha_x + 2 alpha_y) + sum(f_xx - f_xy) in every
    parameter, against jax.grad."""
    jcls, tcls, kw, ranges, rtol = MASS[name]
    x, y = _coords(300, seed=2)
    p = _draw(ranges, seed=3)
    keys = list(p)

    def j_obj(*vals):
        kwp = dict(zip(keys, vals))
        prof = jcls(**kw)
        fx, fy = prof.deriv(jnp.asarray(x), jnp.asarray(y), **kwp)
        h = prof.hessian(jnp.asarray(x), jnp.asarray(y), **kwp)
        return jnp.sum(fx + 2 * fy) + jnp.sum(h[0] - h[1])

    want = jax.grad(j_obj, argnums=tuple(range(len(keys))))(*(jnp.asarray(p[k]) for k in keys))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    prof = tcls(**kw)
    fx, fy = prof.deriv(torch.tensor(x), torch.tensor(y), **tp)
    h = prof.hessian(torch.tensor(x), torch.tensor(y), **tp)
    got = torch.autograd.grad(torch.sum(fx + 2 * fy) + torch.sum(h[0] - h[1]),
                              [tp[k] for k in keys], allow_unused=True)
    for k, g, w in zip(keys, got, want):
        w = np.asarray(w)
        g = np.zeros_like(w) if g is None else g.numpy()
        assert np.isfinite(g).all(), (name, k)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * max(np.abs(w).max(), 1e-6),
                                   err_msg=f"{name}.{k}")


@pytest.mark.parametrize("lstsq", [False, True])
@pytest.mark.parametrize("name", list(LIGHT))
def test_light_matches_jax(name, lstsq):
    jcls, tcls, ranges = LIGHT[name]
    x, y = _coords()
    p = _draw(dict(ranges, **({} if lstsq else {"amp": (0.5, 5.0)})))
    want = jcls(use_lstsq=lstsq).light(jnp.asarray(x), jnp.asarray(y),
                                       **{k: jnp.asarray(v) for k, v in p.items()})
    prof = tcls(use_lstsq=lstsq)
    assert prof.params == jcls(use_lstsq=lstsq).params
    got = prof.light(torch.tensor(x), torch.tensor(y), **{k: torch.tensor(v) for k, v in p.items()})
    assert got.shape == want.shape
    _close(got.numpy(), want, RTOL)


def test_multipole_rejects_m1():
    with pytest.raises(ValueError, match="m = 1"):
        Multipole(m=1)
    with pytest.raises(ValueError, match="m = 1"):
        jmult.Multipole(m=1)


def test_nie_potential_gradient_is_its_deflection():
    """grad(psi) == alpha for the cored NIE (the Keeton core term), by
    torch autograd on the port alone."""
    x, y = _coords(200, seed=5)
    p = {k: torch.tensor(v) for k, v in _draw(MASS["NIE"][3], bs=1, seed=6).items()}
    xt = torch.tensor(x, requires_grad=True)
    yt = torch.tensor(y, requires_grad=True)
    psi = NIE().potential(xt, yt, **p)
    gx, gy = torch.autograd.grad(psi.sum(), (xt, yt))
    fx, fy = NIE().deriv(torch.tensor(x), torch.tensor(y), **p)
    np.testing.assert_allclose(gx.numpy(), fx[0].numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gy.numpy(), fy[0].numpy(), rtol=1e-4, atol=1e-5)


def test_interop_carries_m12_profiles():
    """``phys_model_from_reference`` maps each M12 class by name, with the
    multipole order and the light profiles' lstsq flag."""
    jphys = JPhysicalModel(
        [jsie.NIE(), jnfw.TNFW(), jhern.Hernquist(), jhern.HernquistEllipse(),
         jmult.Multipole(m=3), jpoint.PointMass(), jpoint.MassSheet()],
        [jgauss.Gaussian()], [jgauss.Moffat(use_lstsq=True)])
    phys = phys_model_from_reference(jphys)
    kinds = [NIE, TNFW, Hernquist, HernquistEllipse, Multipole, PointMass, MassSheet]
    assert [type(p) for p in phys.lenses] == kinds
    assert phys.lenses[4].m == 3
    assert type(phys.lens_light[0]) is Gaussian and not phys.lens_light[0].use_lstsq
    assert type(phys.source_light[0]) is Moffat and phys.source_light[0].use_lstsq
    for jp, tp in zip(jphys.lenses + jphys.lens_light + jphys.source_light,
                      phys.lenses + phys.lens_light + phys.source_light):
        assert tp.params == jp.params and tp.name == jp.name
