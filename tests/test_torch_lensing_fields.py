"""The port's lensing fields against the JAX package (CPU): per-profile
Hessians and potentials (rtol 1e-5, atol 1e-6, float32 on both sides; the
gradient of each potential is its deflection, by autograd, at rtol 2e-4 as
in ``tests/test_pointsource.py``), the simulator's field methods, the
multi-plane ``beta`` and its autograd Jacobian (including the asymmetric
case of ``tests/test_multiplane.py``), the cosmology (to 1e-12, float64 on
both sides), ``find_images``, the critical curves, caustics and Einstein
radius, and the subset renders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigalens_tpu import PhysicalModel as JPhysicalModel
from gigalens_tpu import SimulatorConfig as JSimulatorConfig
from gigalens_tpu import cosmology as jcosmo
from gigalens_tpu.profiles import base as jbase
from gigalens_tpu.profiles.light.sersic import SersicEllipse as JSersicEllipse
from gigalens_tpu.profiles.mass import nfw as jnfw
from gigalens_tpu.profiles.mass.epl import EPL as JEPL
from gigalens_tpu.profiles.mass.shear import Shear as JShear
from gigalens_tpu.profiles.mass.sie import SIE as JSIE
from gigalens_tpu.profiles.mass.sie import SIS as JSIS
from gigalens_tpu.simulator import LensSimulator as JLensSimulator
from gigalens_tpu.utils import lensing as jlensing
from gigalens_tpu.utils.images import find_images as j_find_images
from gigalens_tpu_torch import cosmology
from gigalens_tpu_torch.interop import (
    phys_model_from_reference, prior_from_reference, sim_config_from_reference, tree_to_torch,
)
from gigalens_tpu_torch.profiles import base
from gigalens_tpu_torch.profiles.mass import EPL, NFW, NFW_ELLIPSE, SIE, SIS, Shear
from gigalens_tpu_torch.simulator import LensSimulator
from gigalens_tpu_torch.utils import find_images, lensing

RTOL, ATOL = 1e-5, 1e-6

PROFILES = [
    (JEPL(18), EPL(18), dict(theta_E=1.0, gamma=2.2, e1=0.08, e2=-0.06, center_x=0.02,
                             center_y=0.01)),
    (JEPL(18), EPL(18), dict(theta_E=1.2, gamma=2.0, e1=0.1, e2=0.0, center_x=0.0,
                             center_y=0.0)),
    (JSIE(), SIE(), dict(theta_E=1.0, e1=0.08, e2=-0.06, center_x=0.02, center_y=0.01)),
    (JSIS(), SIS(), dict(theta_E=1.1, center_x=0.05, center_y=-0.02)),
    (JShear(), Shear(), dict(gamma1=0.05, gamma2=-0.03)),
    (jnfw.NFW(), NFW(), dict(Rs=1.0, alpha_Rs=0.6, center_x=0.0, center_y=0.0)),
    (jnfw.NFW_ELLIPSE(), NFW_ELLIPSE(), dict(Rs=1.2, alpha_Rs=0.5, e1=0.1, e2=0.05,
                                             center_x=0.1, center_y=0.0)),
]
IDS = ["epl", "epl_gamma2", "sie", "sis", "shear", "nfw", "nfw_ellipse"]


def _coords(n=60, seed=3):
    rng = np.random.default_rng(seed)
    # radii across the NFW branch point (x = R / Rs around 1) and off center
    x = (rng.uniform(0.3, 1.8, n) * rng.choice([-1, 1], n)).astype(np.float32)
    y = (rng.uniform(0.3, 1.8, n) * rng.choice([-1, 1], n)).astype(np.float32)
    return x, y


def _close(name, got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(torch.as_tensor(got).detach().numpy(),
                               np.broadcast_to(np.asarray(want), tuple(got.shape)),
                               rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.quick
@pytest.mark.parametrize("jprof,prof,params", PROFILES, ids=IDS)
def test_profile_hessian_potential_and_derived_fields(jprof, prof, params):
    """hessian (closed form, forward mode or the reverse basis), potential,
    convergence and shear against JAX; grad(potential) == deriv."""
    x, y = _coords()
    jp = {k: jnp.float32(v) for k, v in params.items()}
    tp = {k: torch.tensor(v, dtype=torch.float32) for k, v in params.items()}
    xt, yt = torch.tensor(x), torch.tensor(y)
    for name, a, b in zip(("f_xx", "f_xy", "f_yx", "f_yy"), prof.hessian(xt, yt, **tp),
                          jprof.hessian(jnp.asarray(x), jnp.asarray(y), **jp)):
        _close(name, torch.broadcast_to(a, xt.shape), b, atol=1e-5)
    _close("convergence", torch.broadcast_to(prof.convergence(xt, yt, **tp), xt.shape),
           jprof.convergence(jnp.asarray(x), jnp.asarray(y), **jp), atol=1e-5)
    for a, b in zip(prof.shear(xt, yt, **tp), jprof.shear(jnp.asarray(x), jnp.asarray(y), **jp)):
        _close("shear", torch.broadcast_to(a, xt.shape), b, atol=1e-5)
    if isinstance(prof, NFW_ELLIPSE):
        with pytest.raises(NotImplementedError):
            prof.potential(xt, yt, **tp)
        return
    _close("potential", prof.potential(xt, yt, **tp),
           jprof.potential(jnp.asarray(x), jnp.asarray(y), **jp))
    xg, yg = xt.clone().requires_grad_(True), yt.clone().requires_grad_(True)
    gx, gy = torch.autograd.grad(prof.potential(xg, yg, **tp).sum(), (xg, yg))
    fx, fy = prof.deriv(xt, yt, **tp)
    _close("dpsi/dx", gx, fx, rtol=2e-4, atol=2e-5)
    _close("dpsi/dy", gy, fy, rtol=2e-4, atol=2e-5)


def test_hessian_rotate_and_batched_closed_forms():
    """hessian_rotate against JAX; the forward-mode default and the closed
    forms at a batch of parameters (bs, 1) against JAX, a row at a time."""
    rng = np.random.default_rng(5)
    h = [rng.standard_normal(7).astype(np.float32) for _ in range(3)]
    phi = rng.uniform(-1, 1, 7).astype(np.float32)
    for a, b in zip(base.hessian_rotate(*map(torch.tensor, h), torch.tensor(phi)),
                    jbase.hessian_rotate(*map(jnp.asarray, h), jnp.asarray(phi))):
        _close("hessian_rotate", a, b)
    x, y = _coords(20)
    params = dict(theta_E=[[1.0], [1.3]], e1=[[0.1], [-0.05]], e2=[[0.0], [0.12]],
                  center_x=[[0.0], [0.1]], center_y=[[0.05], [0.0]])
    p = {k: np.asarray(v, np.float32) for k, v in params.items()}
    for jprof, prof in ((JSIE(), SIE()), (JSIS(), SIS())):
        keys = [k for k in p if k in prof.params]
        got = prof.hessian(torch.tensor(x), torch.tensor(y),
                           **{k: torch.tensor(p[k]) for k in keys})
        for i in range(2):
            want = jprof.hessian(jnp.asarray(x), jnp.asarray(y),
                                 **{k: jnp.asarray(p[k][i]) for k in keys})
            for a, b in zip(got, want):
                _close(f"{prof.name} row {i}", a[i], b, atol=1e-5)


def test_cosmology_matches_jax():
    """FlatLambdaCDM distances and the multi-plane factors to 1e-12."""
    for H0, Om0 in ((70.0, 0.3), (67.4, 0.315)):
        a, b = cosmology.FlatLambdaCDM(H0, Om0), jcosmo.FlatLambdaCDM(H0, Om0)
        for z in (0.0, 0.3, 1.0, 2.5):
            np.testing.assert_allclose(a.comoving_distance(z), b.comoving_distance(z),
                                       rtol=1e-12)
        np.testing.assert_allclose(a.angular_diameter_distance(0.5, 2.0),
                                   b.angular_diameter_distance(0.5, 2.0), rtol=1e-12)
        np.testing.assert_allclose(cosmology.multiplane_factors([0.3, 0.3, 0.7], 1.5, a),
                                   jcosmo.multiplane_factors([0.3, 0.3, 0.7], 1.5, b),
                                   rtol=1e-12, atol=0)
    with pytest.raises(ValueError):
        cosmology.multiplane_factors([0.8, 0.3], 1.5)


def _sis(theta_E, cx, cy):
    return dict(theta_E=[theta_E], center_x=[cx], center_y=[cy])


MP_CASES = {
    # tests/test_multiplane.py:86 (two-plane SIS, float64 oracle there)
    "sis_sis": ([JSIS(), JSIS()], [0.4, 0.9], [_sis(1.0, 0.1, -0.05), _sis(0.7, -0.2, 0.15)]),
    # tests/test_multiplane.py:121 (SIE then SIS: asymmetric Jacobian)
    "sie_sis": ([JSIE(), JSIS()], [0.4, 0.9],
                [dict(theta_E=[1.0], e1=[0.08], e2=[-0.05], center_x=[0.0], center_y=[0.0]),
                 _sis(0.6, -0.25, 0.2)]),
    "equal_z": ([JSIS(), JSIS()], [0.5, 0.5], [_sis(0.8, 0.0, 0.0), _sis(0.4, 0.3, -0.2)]),
}


@pytest.mark.parametrize("case", list(MP_CASES))
def test_multi_plane_beta_and_hessian_match_jax(case):
    """beta (the recursion) and the autograd Jacobian against JAX's, with
    the model carried across by phys_model_from_reference; the SIE+SIS
    stack's Jacobian is asymmetric on both sides."""
    lenses, zs, params = MP_CASES[case]
    jphys = JPhysicalModel(lenses, [], [], lens_redshifts=zs, z_source=2.5)
    phys = phys_model_from_reference(jphys)
    assert phys.lens_redshifts == zs and phys.z_source == 2.5
    np.testing.assert_array_equal(phys.mp_factors, np.asarray(jphys.mp_factors))
    jp = [{k: jnp.asarray(v, jnp.float32) for k, v in d.items()} for d in params]
    tp = tree_to_torch(jp, device="cpu")
    x, y = _coords(64, seed=0)
    jsim = JLensSimulator(jphys, JSimulatorConfig(0.1, 8), bs=1)
    sim = LensSimulator(phys, sim_config_from_reference(JSimulatorConfig(0.1, 8)), bs=1,
                        device="cpu")
    for a, b in zip(sim.beta(torch.tensor(x), torch.tensor(y), tp),
                    jsim.beta(jnp.asarray(x), jnp.asarray(y), jp)):
        _close("beta", a, b)
    h = sim.hessian(torch.tensor(x), torch.tensor(y), tp)
    for name, a, b in zip(("f_xx", "f_xy", "f_yx", "f_yy"), h,
                          jsim.hessian(jnp.asarray(x), jnp.asarray(y), jp)):
        _close(name, a, b, atol=1e-5)
    asym = float((h[1] - h[2]).abs().max())
    assert (asym > 1e-3) == (case != "equal_z"), asym
    _close("magnification", sim.magnification(torch.tensor(x), torch.tensor(y), tp),
           jsim.magnification(jnp.asarray(x), jnp.asarray(y), jp), rtol=1e-4, atol=1e-4)
    with pytest.raises(NotImplementedError, match="single-plane"):
        sim.potential(torch.tensor(x), torch.tensor(y), tp)


@pytest.fixture(scope="module")
def quad_lens():
    """An SIE+Shear lens and a source inside its caustic (four images), on
    a 60x60 grid at 0.06" (the setup of tests/test_pointsource.py)."""
    jphys = JPhysicalModel([JSIE(), JShear()], [], [])
    jcfg = JSimulatorConfig(0.06, 60)
    params = [dict(theta_E=[1.1], e1=[0.1], e2=[-0.05], center_x=[0.0], center_y=[0.0]),
              dict(gamma1=[0.03], gamma2=[0.02])]
    jp = [{k: jnp.asarray(v, jnp.float32) for k, v in d.items()} for d in params]
    sim = LensSimulator(phys_model_from_reference(jphys), sim_config_from_reference(jcfg),
                        bs=1, device="cpu")
    return JLensSimulator(jphys, jcfg, bs=1), sim, jp, tree_to_torch(jp, device="cpu")


def test_simulator_fields_match_jax(quad_lens):
    """potential, fermat_potential (own and shared source position),
    magnification, convergence and shear of the single-plane stack."""
    jsim, sim, jp, tp = quad_lens
    x, y = _coords(40, seed=9)
    X, Y = torch.tensor(x), torch.tensor(y)
    J = (jnp.asarray(x), jnp.asarray(y))
    _close("potential", sim.potential(X, Y, tp), jsim.potential(*J, jp))
    _close("fermat", sim.fermat_potential(X, Y, tp), jsim.fermat_potential(*J, jp),
           atol=1e-5)
    b = torch.tensor([[0.05]]), torch.tensor([[-0.02]])
    _close("fermat at a shared source", sim.fermat_potential(X, Y, tp, *b),
           jsim.fermat_potential(*J, jp, jnp.asarray([[0.05]]), jnp.asarray([[-0.02]])),
           atol=1e-5)
    _close("magnification", sim.magnification(X, Y, tp), jsim.magnification(*J, jp),
           rtol=1e-4, atol=1e-4)
    _close("convergence", sim.convergence(X, Y, tp), jsim.convergence(*J, jp))
    for a, c in zip(sim.shear(X, Y, tp), jsim.shear(*J, jp)):
        _close("shear", a, c)


def test_find_images_matches_jax(quad_lens):
    """Four images of a source inside the caustic, at JAX's positions (1e-5
    arcsec) and magnifications (rtol 1e-3, float32 Hessians near a fold),
    brightest first; each maps back to the source."""
    jsim, sim, jp, tp = quad_lens
    got = find_images(sim, tp, 0.04, -0.03)
    want = j_find_images(jsim, jp, 0.04, -0.03)
    assert len(got[0]) == len(want[0]) == 4
    np.testing.assert_allclose(got[0], want[0], atol=1e-5)
    np.testing.assert_allclose(got[1], want[1], atol=1e-5)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-3)
    assert np.all(np.diff(np.abs(got[2])) <= 0)
    with torch.no_grad():
        bx, by = sim.beta(torch.tensor(got[0]), torch.tensor(got[1]), tp)
    np.testing.assert_allclose(bx.numpy()[0], 0.04, atol=1e-4)
    np.testing.assert_allclose(by.numpy()[0], -0.03, atol=1e-4)
    assert len(find_images(sim, tp, 3.0, 3.0)[0]) == 0


def test_critical_curves_caustics_and_einstein_radius_match_jax(quad_lens):
    """The det-A critical curves and tangential caustics (same number of
    polylines; vertices within 1e-4 arcsec), and the effective Einstein
    radius (rtol 1e-5), on a 120-px grid."""
    jsim, sim, jp, tp = quad_lens
    for fn, jfn in ((lensing.critical_curves, jlensing.critical_curves),
                    (lensing.caustics, jlensing.caustics)):
        got, want = fn(sim, tp, n=120), jfn(jsim, jp, n=120)
        assert len(got) == len(want) >= 1
        for a, b in zip(got, want):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, atol=1e-4)
    np.testing.assert_allclose(lensing.einstein_radius(sim, tp, n=120),
                               jlensing.einstein_radius(jsim, jp, n=120), rtol=1e-5)
    lt, lr = lensing.jacobian_eigenvalues(sim, tp, [0.5, 1.0], [0.0, 0.2])
    jt, jr = jlensing.jacobian_eigenvalues(jsim, jp, [0.5, 1.0], [0.0, 0.2])
    np.testing.assert_allclose(lt, np.asarray(jt), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(lr, np.asarray(jr), rtol=1e-5, atol=1e-6)


def test_subset_renders_match_jax(demo_prior):
    """simulate_source / simulate_lens_light / simulate_images against JAX
    (rtol 1e-4), through a view that leaves the simulator as it was; lens
    light plus lensed images is the full render."""
    jphys = JPhysicalModel([JEPL(18), JShear()], [JSersicEllipse()], [JSersicEllipse()])
    jcfg = JSimulatorConfig(delta_pix=0.1, num_pix=20, use_fused_render=False)
    jsim = JLensSimulator(jphys, jcfg, bs=2)
    sim = LensSimulator(phys_model_from_reference(jphys), sim_config_from_reference(jcfg),
                        bs=2, device="cpu")
    jparams = demo_prior.sample(jax.random.PRNGKey(0), 2)
    params = tree_to_torch(jparams, device="cpu")
    pm_before = sim.phys_model
    for name in ("simulate_source", "simulate_lens_light", "simulate_images"):
        got = getattr(sim, name)(params)
        _close(name, got, getattr(jsim, name)(jparams), rtol=1e-4, atol=1e-5)
    assert sim.phys_model is pm_before and len(sim.phys_model.lens_light) == 1
    full = sim.simulate(params)
    _close("images + lens light", sim.simulate_images(params) + sim.simulate_lens_light(params),
           full, rtol=1e-4, atol=1e-5)
    assert prior_from_reference(demo_prior).d == demo_prior.d
