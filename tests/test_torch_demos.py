"""The port's shipped workflows (``gigalens_tpu_torch.demos``) against the
JAX package's demos on the same numpy inputs: ``examples/demo_composite.py``,
``examples/demo_model_comparison.py``, ``examples/demo_timedelay.py`` and
``tests/test_multiplane.py``'s multi-plane configuration.

The JAX demos run at import, so their priors, models and cameras are
rebuilt here from ``gigalens_tpu`` with the demos' numbers. Tolerances:
the truth constants equal JAX's draws in float32 (rtol 1e-7); the
observations at the demos' full widths rtol 1e-4 of the image's max
(two float32 renders); log_prob rtol 1e-4 and its z-gradient 1e-4 of each
sample's largest component at four numpy draws z = 0.3 N(0, 1) (the
composite at 16 px); the time-delay distance 1e-12 (the same float64
host code), the images 1e-5 arcsec and magnifications rtol 1e-3
(tests/test_torch_lensing_fields.py's), the true delays rtol 1e-4; the
multi-plane magnifications rtol 1e-4 (atol 1e-4).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigalens_tpu import PhysicalModel as JPhysicalModel
from gigalens_tpu import SimulatorConfig as JSimulatorConfig
from gigalens_tpu.model import _TD_DAYS as J_TD_DAYS
from gigalens_tpu.model import ForwardProbModel as JForwardProbModel
from gigalens_tpu.prob import Prior as JPrior
from gigalens_tpu.prob import distributions as jd
from gigalens_tpu.profiles.light.sersic import SersicEllipse as JSersicEllipse
from gigalens_tpu.profiles.mass import NFW_ELLIPSE as JNFW_ELLIPSE
from gigalens_tpu.profiles.mass import Hernquist as JHernquist
from gigalens_tpu.profiles.mass import Multipole as JMultipole
from gigalens_tpu.profiles.mass.epl import EPL as JEPL
from gigalens_tpu.profiles.mass.shear import Shear as JShear
from gigalens_tpu.profiles.mass.sie import SIE as JSIE
from gigalens_tpu.profiles.mass.sie import SIS as JSIS
from gigalens_tpu.simulator import LensSimulator as JLensSimulator
from gigalens_tpu.utils.images import find_images as j_find_images
from gigalens_tpu_torch import demos
from gigalens_tpu_torch.model import ForwardProbModel
from gigalens_tpu_torch.simulator import LensSimulator

COMPOSITE_GRAD_PIX = 16
N_DRAWS = 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's side on one thread: its many small CPU operations slow
    down manifold when the test workers' threads contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_composite():
    """examples/demo_composite.py:52-107: (prior, phys)."""
    ln = jnp.log
    prior = JPrior(dict(
        lens_mass=[dict(sigma0=jd.LogNormal(ln(0.6), 0.3), Rs=jd.LogNormal(ln(0.8), 0.2),
                        center_x=jd.Normal(0, 0.05), center_y=jd.Normal(0, 0.05)),
                   dict(Rs=jd.LogNormal(ln(3.0), 0.2), alpha_Rs=jd.LogNormal(ln(0.8), 0.3),
                        e1=jd.Normal(0, 0.1), e2=jd.Normal(0, 0.1), center_x=jd.Normal(0, 0.05),
                        center_y=jd.Normal(0, 0.05)),
                   dict(a_m=jd.Normal(0, 0.02), phi_m=jd.Normal(0, 0.5),
                        center_x=jd.Normal(0, 0.05), center_y=jd.Normal(0, 0.05)),
                   dict(gamma1=jd.Normal(0, 0.05), gamma2=jd.Normal(0, 0.05))],
        lens_light=[dict(R_sersic=jd.LogNormal(ln(0.8), 0.15), n_sersic=jd.Uniform(2, 6),
                         e1=jd.TruncatedNormal(0, 0.1, -0.3, 0.3),
                         e2=jd.TruncatedNormal(0, 0.1, -0.3, 0.3),
                         center_x=jd.Normal(0, 0.05), center_y=jd.Normal(0, 0.05),
                         Ie=jd.LogNormal(ln(400.0), 0.3))],
        source_light=[dict(R_sersic=jd.LogNormal(ln(0.25), 0.15), n_sersic=jd.Uniform(0.5, 4),
                           e1=jd.TruncatedNormal(0, 0.15, -0.5, 0.5),
                           e2=jd.TruncatedNormal(0, 0.15, -0.5, 0.5),
                           center_x=jd.Normal(0, 0.2), center_y=jd.Normal(0, 0.2),
                           Ie=jd.LogNormal(ln(150.0), 0.5))]))
    phys = JPhysicalModel([JHernquist(), JNFW_ELLIPSE(), JMultipole(m=4), JShear()],
                          [JSersicEllipse()], [JSersicEllipse()])
    return prior, phys


def jax_composite_cfg(num_pix):
    return JSimulatorConfig(delta_pix=0.08, num_pix=num_pix, supersample=2,
                            kernel=demos.composite_psf())


def jax_comparison():
    """examples/demo_model_comparison.py:65-98: {arm: (prior, phys)}."""
    ln = jnp.log

    def src():
        return dict(R_sersic=jd.LogNormal(ln(0.25), 0.15), n_sersic=jd.Uniform(0.5, 4),
                    e1=jd.TruncatedNormal(0, 0.15, -0.5, 0.5),
                    e2=jd.TruncatedNormal(0, 0.15, -0.5, 0.5),
                    center_x=jd.Normal(0, 0.25), center_y=jd.Normal(0, 0.25),
                    Ie=jd.LogNormal(ln(150.0), 0.5))

    common = dict(theta_E=jd.LogNormal(ln(1.25), 0.25), e1=jd.Normal(0, 0.1),
                  e2=jd.Normal(0, 0.1), center_x=jd.Normal(0, 0.05),
                  center_y=jd.Normal(0, 0.05))
    shear = dict(gamma1=jd.Normal(0, 0.05), gamma2=jd.Normal(0, 0.05))
    epl = JPrior(dict(lens_mass=[dict(gamma=jd.TruncatedNormal(2, 0.25, 1, 3), **common),
                                 dict(shear)], source_light=[src()]))
    sie = JPrior(dict(lens_mass=[dict(**common), dict(shear)], source_light=[src()]))
    return dict(EPL=(epl, JPhysicalModel([JEPL(JEPL.recommended_niter(0.43, 1e-8)), JShear()],
                                         [], [JSersicEllipse()])),
                SIE=(sie, JPhysicalModel([JSIE(), JShear()], [], [JSersicEllipse()])))


JAX_COMPARISON_CFG = JSimulatorConfig(delta_pix=0.065, num_pix=32, supersample=1)


def jax_multiplane():
    """tests/test_multiplane.py:159-197: (prior, phys, cfg)."""
    kern = np.exp(-((np.arange(5) - 2) ** 2 + (np.arange(5)[:, None] - 2) ** 2) / 2.0)
    cfg = JSimulatorConfig(delta_pix=0.08, num_pix=24, supersample=2,
                           kernel=(kern / kern.sum()).astype(np.float32))
    phys = JPhysicalModel([JSIE(), JShear(), JSIS()], [], [JSersicEllipse()],
                          lens_redshifts=[0.4, 0.4, 0.9], z_source=2.0)
    prior = JPrior(dict(
        lens_mass=[dict(theta_E=jd.LogNormal(np.log(0.8), 0.1), e1=jd.Normal(0, 0.1),
                        e2=jd.Normal(0, 0.1), center_x=jd.Normal(0, 0.05),
                        center_y=jd.Normal(0, 0.05)),
                   dict(gamma1=jd.Normal(0, 0.05), gamma2=jd.Normal(0, 0.05)),
                   dict(theta_E=jd.LogNormal(np.log(0.3), 0.2), center_x=jd.Normal(0.4, 0.05),
                        center_y=jd.Normal(-0.3, 0.05))],
        source_light=[dict(R_sersic=jd.LogNormal(np.log(0.2), 0.2), n_sersic=jd.Uniform(1, 3),
                           e1=jd.TruncatedNormal(0, 0.1, -0.3, 0.3),
                           e2=jd.TruncatedNormal(0, 0.1, -0.3, 0.3),
                           center_x=jd.Normal(0, 0.1), center_y=jd.Normal(0, 0.1),
                           Ie=jd.LogNormal(np.log(5.0), 0.3))]))
    return prior, phys, cfg


def jax_truth(values):
    return jax.tree_util.tree_map(lambda v: jnp.asarray([v], jnp.float32), values)


def jax_observation(phys, cfg, truth, noise):
    """The JAX demo's observation: its render of ``truth`` plus ``noise(img)``."""
    img = np.asarray(jax.jit(JLensSimulator(phys, cfg, bs=1).simulate)(jax_truth(truth)))
    return noise(img)


@pytest.mark.parametrize("leg", ["composite", "comparison", "multiplane"])
def test_truth_constants_are_the_jax_draws(leg):
    """Each truth constant is the JAX demo's prior draw (the comparison's
    with gamma set to 2.4), value for value."""
    if leg == "composite":
        prior, key, want = jax_composite()[0], 3, demos.COMPOSITE_TRUTH
    elif leg == "comparison":
        prior, key, want = jax_comparison()["EPL"][0], 3, demos.COMPARISON_TRUTH
    else:
        prior, key, want = jax_multiplane()[0], 1, demos.MULTIPLANE_TRUTH
    draw = prior.sample(jax.random.PRNGKey(key), 1)
    if leg == "comparison":
        draw["lens_mass"][0]["gamma"] = jnp.full_like(draw["lens_mass"][0]["gamma"], 2.4)
    for group, profiles in draw.items():
        assert len(profiles) == len(want[group])
        for got, ref in zip(profiles, want[group]):
            assert set(got) == set(ref)
            for k, v in got.items():
                np.testing.assert_allclose(np.float32(ref[k]), np.asarray(v, np.float32)[0],
                                           rtol=1e-7, err_msg=f"{group} {k}")


def _demo_noise(seed, bkg, exp_time):
    def noise(img):
        rng = np.random.default_rng(seed)
        return img + rng.normal(size=img.shape).astype(np.float32) * np.sqrt(
            bkg**2 + np.clip(img, 0, None) / exp_time)
    return noise


def _multiplane_noise(img):
    return img + np.random.default_rng(0).normal(size=img.shape).astype(np.float32) * 0.05


@pytest.mark.parametrize("leg", ["composite", "comparison", "multiplane"])
def test_observations_equal_the_jax_demos(leg):
    """The port's observation at the demo's full width against the JAX
    demo's render of the same truth with the same numpy noise."""
    if leg == "composite":
        got = demos.composite_scene(device="cpu").obs
        want = jax_observation(jax_composite()[1], jax_composite_cfg(64),
                               demos.COMPOSITE_TRUTH, _demo_noise(0, 0.2, 100.0))
    elif leg == "comparison":
        got = demos.comparison_scene(device="cpu").obs
        want = jax_observation(jax_comparison()["EPL"][1], JAX_COMPARISON_CFG,
                               demos.COMPARISON_TRUTH, _demo_noise(2, 0.2, 100.0))
    else:
        got = demos.multiplane_scene(device="cpu").obs
        _, phys, cfg = jax_multiplane()
        want = jax_observation(phys, cfg, demos.MULTIPLANE_TRUTH, _multiplane_noise)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def _legs():
    """(port prob model and simulator factory, JAX prob model and config,
    d) of each leg's log-density, on the port's observations."""
    out = {}
    sc = demos.composite_scene(num_pix=COMPOSITE_GRAD_PIX, device="cpu")
    jprior, jphys = jax_composite()
    out["composite"] = (sc, jphys, jax_composite_cfg(COMPOSITE_GRAD_PIX),
                        JForwardProbModel(jprior, sc.obs, background_rms=0.2, exp_time=100.0))
    cs = demos.comparison_scene(device="cpu")
    for name, (jprior, jphys) in jax_comparison().items():
        phys, prior = cs.arms[name]
        prob = ForwardProbModel(prior, cs.obs, background_rms=0.2, exp_time=100.0,
                                device="cpu")
        scene = types.SimpleNamespace(phys=phys, prior=prior, cfg=cs.cfg, prob=prob)
        out[f"comparison_{name}"] = (scene, jphys, JAX_COMPARISON_CFG,
                                     JForwardProbModel(jprior, cs.obs, background_rms=0.2,
                                                       exp_time=100.0))
    sc = demos.multiplane_scene(device="cpu")
    jprior, jphys, jcfg = jax_multiplane()
    out["multiplane"] = (sc, jphys, jcfg, JForwardProbModel(jprior, sc.obs, background_rms=0.05,
                                                            exp_time=1e3))
    return out


@pytest.fixture(scope="module")
def legs():
    return _legs()


@pytest.fixture(scope="module")
def timedelay():
    """The port's time-delay scene and the JAX demo's steps on the same
    truth (demo_timedelay.py:46-123): (scene, JAX images, JAX delays, JAX
    D_dt, JAX prob model, JAX simulator)."""
    from gigalens_tpu.cosmology import FlatLambdaCDM

    sc = demos.timedelay_scene(seed=0, device="cpu")
    cosmo = FlatLambdaCDM(H0=70.0, Om0=0.3)
    dl, ds = cosmo.angular_diameter_distance(0.5), cosmo.angular_diameter_distance(2.0)
    d_dt = 1.5 * dl * ds / cosmo.angular_diameter_distance(0.5, 2.0)
    jphys = JPhysicalModel([JSIE(), JShear()], [], [])
    jsim = JLensSimulator(jphys, JSimulatorConfig(delta_pix=0.06, num_pix=60), bs=1)
    truth = jax_truth(demos.TD_TRUTH)
    ix, iy, mag = (a[:4] for a in j_find_images(jsim, truth, 0.07, -0.05))
    bx, by = jsim.beta(jnp.asarray(ix), jnp.asarray(iy), truth)
    tau = np.asarray(jsim.fermat_potential(jnp.asarray(ix), jnp.asarray(iy), truth,
                                           jnp.mean(bx, -1, keepdims=True),
                                           jnp.mean(by, -1, keepdims=True)))[0]
    delays = J_TD_DAYS * d_dt * (tau[1:] - tau[0])
    data, n = sc.data, 4
    ln = np.log
    jprior = JPrior(dict(
        cosmo=[dict(D_dt=jd.LogNormal(ln(3500.0), 0.5))],
        lens_mass=[dict(theta_E=jd.LogNormal(ln(1.2), 0.05), e1=jd.Normal(0.12, 0.02),
                        e2=jd.Normal(-0.06, 0.02), center_x=jd.Normal(0, 0.01),
                        center_y=jd.Normal(0, 0.01)),
                   dict(gamma1=jd.Normal(0.04, 0.01), gamma2=jd.Normal(0.02, 0.01))]))
    fluxes = 3.0 * np.abs(sc.images[2])
    jprob = JForwardProbModel(
        jprior, centroids_x=[data["x"]], centroids_y=[data["y"]],
        centroids_errors_x=[np.full(n, 0.004, np.float32)],
        centroids_errors_y=[np.full(n, 0.004, np.float32)],
        delays=data["delays"].astype(np.float32), delay_errors=np.full(n - 1, 0.8, np.float32),
        image_fluxes=data["fluxes"].astype(np.float32),
        image_flux_errors=(0.05 * fluxes).astype(np.float32))
    return sc, (ix, iy, mag), delays, d_dt, jprob, jsim


def _log_prob_pair(sc, jphys, jcfg, jprob, bs):
    sim = LensSimulator(sc.phys, sc.cfg, bs=bs, device="cpu")
    jsim = JLensSimulator(jphys, jcfg, bs=bs)
    z = (0.3 * np.random.default_rng(15).normal(size=(bs, sc.prior.d))).astype(np.float32)

    zt = torch.tensor(z, requires_grad=True)
    lp = sc.prob.log_prob(sim, zt)[0]
    (g,) = torch.autograd.grad(lp.sum(), zt)
    def total(v):
        rows = jprob.log_prob(jsim, v)[0]
        return jnp.sum(rows), rows

    (_, jlp), jg = jax.jit(jax.value_and_grad(total, has_aux=True))(jnp.asarray(z))
    return lp.detach().numpy(), g.numpy(), np.asarray(jlp), np.asarray(jg)


@pytest.mark.parametrize("leg", ["composite", "comparison_EPL", "comparison_SIE", "multiplane",
                                 "timedelay"])
def test_log_prob_and_gradient_match_jax(leg, legs, timedelay):
    """log_prob (rtol 1e-4) and its z-gradient (1e-4 of each sample's
    largest component) of each leg's prob model at four numpy draws."""
    if leg == "timedelay":
        sc, _, _, _, jprob, _ = timedelay
        jphys = JPhysicalModel([JSIE(), JShear()], [], [])
        jcfg = JSimulatorConfig(delta_pix=0.06, num_pix=60)
    else:
        sc, jphys, jcfg, jprob = legs[leg]
    lp, g, jlp, jg = _log_prob_pair(sc, jphys, jcfg, jprob, N_DRAWS)
    assert np.all(np.isfinite(lp)) and np.all(np.isfinite(g))
    np.testing.assert_allclose(lp, jlp, rtol=1e-4)
    scale = np.abs(jg).max(axis=1, keepdims=True)
    np.testing.assert_array_less(np.abs(g - jg) / scale, 1e-4)


def test_timedelay_truth_images_and_delays_match_jax(timedelay):
    """The true D_dt, find_images' four images and magnifications and the
    true delays against the JAX demo's."""
    sc, (ix, iy, mag), delays, d_dt, _, _ = timedelay
    np.testing.assert_allclose(sc.d_dt, d_dt, rtol=1e-12)
    assert len(sc.images[0]) == len(ix) == 4
    np.testing.assert_allclose(sc.images[0], ix, atol=1e-5)
    np.testing.assert_allclose(sc.images[1], iy, atol=1e-5)
    np.testing.assert_allclose(sc.images[2], mag, rtol=1e-3)
    np.testing.assert_allclose(sc.delays, delays, rtol=1e-4)


def test_multiplane_magnification_matches_jax_and_differences():
    """The composed-Jacobian magnification at the true source's images
    against JAX's (rtol 1e-4), and the Jacobian against central
    differences of beta (the card's check, demos.fd_jacobian_check)."""
    sc = demos.multiplane_scene(device="cpu")
    sim = LensSimulator(sc.phys, sc.cfg, bs=1, device="cpu")
    src = demos.MULTIPLANE_TRUTH["source_light"][0]
    ix, iy, _ = demos.find_images(sim, sc.truth["lens_mass"], src["center_x"], src["center_y"])
    assert len(ix) >= 3
    x, y = torch.tensor(ix), torch.tensor(iy)
    worst, mag = demos.fd_jacobian_check(sim, x, y, sc.truth["lens_mass"])
    assert worst <= 0.0
    _, jphys, jcfg = jax_multiplane()
    jsim = JLensSimulator(jphys, jcfg, bs=1)
    jmag = jsim.magnification(jnp.asarray(ix), jnp.asarray(iy),
                              jax_truth(demos.MULTIPLANE_TRUTH)["lens_mass"])
    np.testing.assert_allclose(mag.numpy(), np.asarray(jmag), rtol=1e-4, atol=1e-4)


def test_comparison_smc_shapes():
    """Two tempering stages of each arm at 8 particles x 2 ensembles: the
    evidence and the final beta have one entry an ensemble."""
    res = demos.run_comparison(device="cpu", particles=8, ensembles=2, max_stage=2)
    for name in ("EPL", "SIE"):
        _, smc = res.states[name]
        assert smc.log_evidence.shape == (2,) and smc.final_beta.shape == (2,)
        assert smc.num_stages == 2 and torch.isfinite(smc.log_evidence).all()
        assert res.arms[name]["stages"] == 2 and len(res.arms[name]["log_z"]) == 2
    assert set(res.gates()) == {"EPL_beta", "EPL_log_z", "SIE_beta", "SIE_log_z", "decisive"}


@pytest.mark.quick
def test_cli_runs_the_multiplane_leg_and_entry_points_need_the_card(capsys):
    """``python3 -m gigalens_tpu_torch.demos multiplane --device cpu
    --quick`` exits 0 with one JSON line whose gates hold; without a card
    the entry points raise instead of falling back to the CPU."""
    import json

    assert demos.main(["multiplane", "--device", "cpu", "--quick"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["demo"] == "multiplane" and out["ok"] and all(out["gates"].values())
    if not torch.cuda.is_available():
        for build in (demos.composite_scene, demos.comparison_scene, demos.multiplane_scene):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build()


def test_hernquist_is_finite_at_its_centre():
    """F-ref-8: the Hernquist shapes against their float64 closed forms
    outside the x = 1 series window, down to x = 1e-6 (alpha rel 1e-5;
    kappa 2e-4: its (2 + x^2) F - 3 cancels to 1.2e-4 at x = 0.96, in
    the JAX package's form too; that form is 2.6e-2 off at x = 4e-4 and
    inf below ~2.4e-4), and the deflection
    with its parameter gradient finite at 1e-8 to 1e-2 arcsec from the
    centre; the JAX package's float32 deflection is inf there from ~1e-4
    arcsec in (its arctanh form), its gradient NaN."""
    from gigalens_tpu.profiles.mass.hernquist import Hernquist as JHernquistSphere
    from gigalens_tpu_torch.profiles.mass import Hernquist
    from gigalens_tpu_torch.profiles.mass.hernquist import _alpha_shape, _kappa_shape

    x = np.concatenate([np.logspace(-6, np.log10(0.97), 3000),
                        np.logspace(np.log10(1.03), 2, 300)])
    x = x.astype(np.float32).astype(np.float64)
    s = np.sqrt(np.abs(1 - x**2))
    f = np.where(x < 1, np.arctanh(np.minimum(s, 1 - 1e-16)) / s, np.arctan(s) / s)
    alpha, kappa = x * (1 - f) / (x**2 - 1), ((2 + x**2) * f - 3) / (x**2 - 1) ** 2
    xt = torch.tensor(x, dtype=torch.float32)
    np.testing.assert_allclose(_alpha_shape(xt).double().numpy(), alpha, rtol=1e-5)
    np.testing.assert_allclose(_kappa_shape(xt).double().numpy(), kappa, rtol=2e-4)

    r = np.array([1e-8, 1e-6, 1e-5, 1e-4, 2e-4, 1e-3, 1e-2], np.float32)
    params = [torch.tensor([[v]], requires_grad=True) for v in (0.45, 0.8, 0.0, 0.0)]
    fx, fy = Hernquist().deriv(torch.tensor(r), torch.zeros(len(r)), *params)
    grads = torch.autograd.grad(fx.sum() + fy.sum(), params)
    assert torch.isfinite(fx).all() and all(torch.isfinite(g).all() for g in grads)
    jfx = np.asarray(JHernquistSphere().deriv(jnp.asarray(r), jnp.zeros(len(r)), 0.45, 0.8,
                                              0.0, 0.0)[0])
    assert np.isinf(jfx[r <= 1e-4]).all() and np.isfinite(jfx[r >= 2e-4]).all()
    jg = jax.grad(lambda c: JHernquistSphere().deriv(jnp.asarray(r[3:4]), jnp.zeros(1), 0.45,
                                                     0.8, c, 0.0)[0].sum())(0.0)
    assert np.isnan(jg)
