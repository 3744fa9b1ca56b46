"""The port's pixelated-source inversion against the JAX package (CPU).

Two scenes, both fed the same numpy arrays: ``tests/test_inversion.py``'s
tiny one (20 px at supersample 1, a 5x5 PSF in JAX's "direct" mode, an
8x8 source grid) and a supersample-2 one (20 px, 7x7 PSF on the FFT path,
a parametric SersicEllipse lens light, ``lam`` sampled). The JAX side is
jitted. Tolerances: the numpy parts (grid, regularizer, chunk rule)
exactly; the mapping matrix at 1e-5 of its max; the solve's outputs and
``log_prob`` at rtol 1e-4 (float32 on both sides, a 64x64 Cholesky); the
marginal likelihood against a float64 numpy oracle at JAX's own bounds
(rtol 2e-4, atol 0.2); z-gradients at 1e-4 of each column's max; two MAP
steps at rtol 1e-3 (as the MAP parity test).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gigalens_tpu import PhysicalModel as JPhysicalModel
from gigalens_tpu import SimulatorConfig as JSimulatorConfig
from gigalens_tpu.inference import ModellingSequence as JModellingSequence
from gigalens_tpu.inversion import PixelatedSourceProbModel as JPixelated
from gigalens_tpu.inversion import SourceGrid as JSourceGrid
from gigalens_tpu.inversion import _pick_chunk as j_pick_chunk
from gigalens_tpu.inversion import gradient_regularizer as j_gradient_regularizer
from gigalens_tpu.prob import Prior as JPrior
from gigalens_tpu.prob import distributions as jd
from gigalens_tpu.profiles.light.sersic import SersicEllipse as JSersicEllipse
from gigalens_tpu.profiles.mass.shear import Shear as JShear
from gigalens_tpu.profiles.mass.sie import SIE as JSIE
from gigalens_tpu.simulator import LensSimulator as JLensSimulator
from gigalens_tpu_torch.inference import ModellingSequence, optim
from gigalens_tpu_torch.inference.hmc import fit_hmc
from gigalens_tpu_torch.interop import (
    phys_model_from_reference, pixelated_model_from_reference, sim_config_from_reference,
)
from gigalens_tpu_torch.inversion import (
    PixelatedSourceProbModel, SourceGrid, _pick_chunk, gradient_regularizer,
)
from gigalens_tpu_torch.ops.cuda.direct_conv import DirectConv
from gigalens_tpu_torch.prob.distributions import MultivariateNormalTriL
from gigalens_tpu_torch.simulator import LensSimulator

RTOL = 1e-4
BS = 3

LENS = [dict(theta_E=jd.LogNormal(np.log(0.7), 0.1), e1=jd.Normal(0, 0.1),
             e2=jd.Normal(0, 0.1), center_x=jd.Normal(0, 0.05), center_y=jd.Normal(0, 0.05)),
        dict(gamma1=jd.Normal(0, 0.05), gamma2=jd.Normal(0, 0.05))]


def _scene(kind):
    """JAX and port objects of one scene: "tiny" (tests/test_inversion.py's
    _tiny_setup, fixed lam 2) or "ss2" (supersample 2, FFT PSF, a Sersic
    lens light, lam sampled from LogNormal(0, 1))."""
    rng = np.random.default_rng(0)
    if kind == "tiny":
        kern = rng.uniform(0.1, 1.0, (5, 5))
        cfg = dict(supersample=1, psf_mode="direct")
        tree = dict(lens_mass=LENS)
        lens_light, lam = [], 2.0
    else:
        kern = rng.uniform(0.1, 1.0, (7, 7))
        cfg = dict(supersample=2, psf_mode="fft")
        tree = dict(lens_mass=LENS, lens_light=[dict(
            R_sersic=jd.LogNormal(np.log(0.5), 0.1), n_sersic=jd.Uniform(2, 4),
            e1=jd.Normal(0, 0.1), e2=jd.Normal(0, 0.1), center_x=jd.Normal(0, 0.05),
            center_y=jd.Normal(0, 0.05), Ie=jd.LogNormal(np.log(2.0), 0.3))],
            source_pixelated=[dict(lam=jd.LogNormal(0.0, 1.0))])
        lens_light, lam = [JSersicEllipse()], None
    kern = (kern / kern.sum()).astype(np.float32)
    jcfg = JSimulatorConfig(delta_pix=0.1, num_pix=20, kernel=kern, **cfg)
    jprior = JPrior(tree)
    jphys = JPhysicalModel([JSIE(), JShear()], lens_light, [])
    obs = rng.normal(0.0, 1.0, (20, 20)).astype(np.float32)
    grid = JSourceGrid(n_side=8, extent=0.5)
    jmodel = JPixelated(jprior, obs, background_rms=0.3, exp_time=100.0, grid=grid, lam=lam)
    z = np.asarray(jprior.unconstrain(jprior.sample(jax.random.PRNGKey(3), BS)))
    return dict(kind=kind, kern=kern, obs=obs, jcfg=jcfg, jphys=jphys, jmodel=jmodel, z=z,
                lam=lam, tcfg=sim_config_from_reference(jcfg),
                tphys=phys_model_from_reference(jphys),
                tmodel=pixelated_model_from_reference(jmodel, device="cpu"))


@pytest.fixture(scope="module", params=["tiny", "ss2"])
def scene(request):
    return _scene(request.param)


@pytest.fixture(scope="module")
def tiny():
    return _scene("tiny")


def _sims(sc, bs=BS):
    return (JLensSimulator(sc["jphys"], sc["jcfg"], bs=bs),
            LensSimulator(sc["tphys"], sc["tcfg"], bs=bs, device="cpu"))


@pytest.mark.quick
def test_grid_regularizer_and_chunk_rule_equal_jax():
    for n_side, extent, cx, cy in [(2, 0.3, 0.0, 0.0), (8, 0.5, 0.1, -0.2), (24, 0.4, 0, 0),
                                   (31, 1.0, -0.05, 0.3)]:
        g, jg = SourceGrid(n_side, extent, cx, cy), JSourceGrid(n_side, extent, cx, cy)
        assert (g.n_src, g.delta) == (jg.n_src, jg.delta)
        np.testing.assert_array_equal(g.centers_x, jg.centers_x)
        np.testing.assert_array_equal(g.centers_y, jg.centers_y)
    for n_side, ridge in [(2, 0.0), (5, 0.0), (8, 0.5), (24, 0.0), (24, 1e-3)]:
        H, logdet = gradient_regularizer(n_side, ridge)
        jH, jlogdet = j_gradient_regularizer(n_side, ridge)
        assert H.dtype == np.float32 and H.shape == (n_side**2,) * 2
        np.testing.assert_array_equal(H, jH)
        assert logdet == jlogdet
    for n_side in (1, 6, 8, 24, 25, 30):
        for max_cols in (1, 10, 48, 64, 256, 1000):
            assert _pick_chunk(n_side, max_cols) == j_pick_chunk(n_side, max_cols)


@pytest.mark.parametrize("chunk", [None, 2])
def test_mapping_matrix_equals_jax(scene, chunk):
    jmodel, tmodel = scene["jmodel"], scene["tmodel"]
    jmodel.chunk = tmodel.chunk = chunk
    try:
        jsim, tsim = _sims(scene)
        x = jmodel.prior.constrain(jnp.asarray(scene["z"]))
        want = np.asarray(jax.jit(lambda p: jmodel.mapping_matrix(jsim, p))(x["lens_mass"]))
        got = tmodel.mapping_matrix(tsim, tmodel.prior.constrain(torch.tensor(scene["z"]))[
            "lens_mass"])
    finally:
        jmodel.chunk = tmodel.chunk = None
    assert got.shape == want.shape == (BS, 64, 400)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_solve_and_log_prob_equal_jax(scene):
    jmodel, tmodel = scene["jmodel"], scene["tmodel"]
    jsim, tsim = _sims(scene)
    xj = jmodel.prior.constrain(jnp.asarray(scene["z"]))
    want = jax.jit(lambda p: jmodel.solve(jsim, p))(xj)
    got = tmodel.solve(tsim, tmodel.prior.constrain(torch.tensor(scene["z"])))
    assert set(got) == set(want) == {"source", "model_image", "log_marginal", "red_chi2"}
    for k in ("log_marginal", "red_chi2"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL)
    for k in ("source", "model_image"):
        w = np.asarray(want[k])
        assert got[k].shape == w.shape
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=RTOL * np.abs(w).max())
    lp_j, chi_j = jax.jit(lambda zz: jmodel.log_prob(jsim, zz))(jnp.asarray(scene["z"]))
    lp_t, chi_t = tmodel.log_prob(tsim, torch.tensor(scene["z"]))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=RTOL)
    np.testing.assert_allclose(chi_t.numpy(), np.asarray(chi_j), rtol=RTOL)
    np.testing.assert_allclose(tmodel.log_like(tsim, torch.tensor(scene["z"])).numpy(),
                               np.asarray(want["log_marginal"]), rtol=RTOL)


def _conv_same_np(img, kernel):
    """float64 true convolution (flipped kernel), 'SAME' size."""
    kh, kw = kernel.shape
    ph, pw = kh // 2, kw // 2
    pad = np.pad(img, ((ph, ph), (pw, pw)))
    out = np.zeros_like(img, np.float64)
    kf = kernel[::-1, ::-1]
    for i in range(img.shape[0]):
        for j in range(img.shape[1]):
            out[i, j] = np.sum(pad[i: i + kh, j: j + kw] * kf)
    return out


def _oracle_log_marginal(model, sim, obs, kern, grid, lens_params, lam):
    """float64 brute-force marginal likelihood of one sample (the oracle of
    tests/test_inversion.py, on the port's ray-traced positions)."""
    with torch.no_grad():
        bx, by = sim.beta(sim.img_x, sim.img_y, lens_params)
    bx = bx.double().numpy().reshape(-1)
    by = by.double().numpy().reshape(-1)
    cx = np.asarray(grid.centers_x, np.float64)
    cy = np.asarray(grid.centers_y, np.float64)
    n = grid.n_side
    npix = bx.size
    wx = np.maximum(0.0, 1.0 - np.abs(bx[:, None] - cx) / grid.delta)
    wy = np.maximum(0.0, 1.0 - np.abs(by[:, None] - cy) / grid.delta)
    A = (wy[:, :, None] * wx[:, None, :]).reshape(npix, n * n)
    H_img = sim.sim_config.num_pix
    C = np.zeros((n * n, H_img * H_img), np.float64)
    for j in range(n * n):
        img = A[:, j].reshape(H_img, H_img)  # supersample=1
        C[j] = (_conv_same_np(img, np.asarray(kern, np.float64))
                * sim.conversion_factor).reshape(-1)
    err = model.error_map.double().numpy()
    w = (1.0 / err**2).reshape(-1)
    d = np.asarray(obs, np.float64).reshape(-1)
    H_reg, logdet_H = gradient_regularizer(n)
    F = (C * w) @ C.T + lam * np.asarray(H_reg, np.float64)
    b = (C * w) @ d
    s = np.linalg.solve(F, b)
    sign, logdet_F = np.linalg.slogdet(F)
    assert sign > 0
    quad = d @ (w * d) - b @ s
    norm = np.sum(np.log(2 * np.pi * err**2))
    return -0.5 * (quad + logdet_F - n * n * np.log(lam) - logdet_H + norm)


def test_marginal_likelihood_matches_float64_oracle(tiny):
    tmodel = tiny["tmodel"]
    tsim = LensSimulator(tiny["tphys"], tiny["tcfg"], bs=1, device="cpu")
    x = tmodel.prior.constrain(torch.tensor(tiny["z"][:1]))
    got = float(tmodel.stats_pixels(tsim, x)[0][0])
    want = _oracle_log_marginal(tmodel, tsim, tiny["obs"], tiny["kern"], tmodel.grid,
                                x["lens_mass"], tiny["lam"])
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=0.2)


def test_log_prob_gradient_equals_jax(scene):
    """z-gradients (torch.autograd through the checkpointed chunks and the
    hand-written backward of the solve) against jax.grad, per column at
    1e-4 of its max; with lam sampled its column is nonzero."""
    jmodel, tmodel = scene["jmodel"], scene["tmodel"]
    jsim, tsim = _sims(scene)
    want = np.asarray(jax.jit(jax.grad(lambda zz: jnp.sum(jmodel.log_prob(jsim, zz)[0])))(
        jnp.asarray(scene["z"])))
    z = torch.tensor(scene["z"], requires_grad=True)
    (got,) = torch.autograd.grad(tmodel.log_prob(tsim, z)[0].sum(), z)
    assert np.isfinite(got.numpy()).all()
    err = np.abs(got.numpy() - want).max(axis=0) / np.abs(want).max(axis=0)
    assert err.max() <= RTOL, err
    if scene["lam"] is None:
        col = tmodel.prior.column_names().index("source_pixelated/0/lam")
        assert np.all(np.abs(got.numpy()[:, col]) > 0)


def test_non_positive_definite_row_is_nan(scene):
    """A sample whose F is not positive definite (a large negative lam)
    gets NaN in its row, as JAX's Cholesky gives, with no raise; the
    other rows are finite and unchanged; its z-gradient stays in its row."""
    jmodel, tmodel = scene["jmodel"], scene["tmodel"]
    jsim, tsim = _sims(scene)
    lam = np.array([2.0, -1e6, 3.0], np.float32)
    jmodel.lam = tmodel.lam = None
    try:
        xj = jmodel.prior.constrain(jnp.asarray(scene["z"]))
        xj["source_pixelated"] = [dict(lam=jnp.asarray(lam))]
        want = jax.jit(lambda p: jmodel.stats_pixels(jsim, p))(xj)
        x = tmodel.prior.constrain(torch.tensor(scene["z"]))
        x["source_pixelated"] = [dict(lam=torch.tensor(lam))]
        out = tmodel.solve(tsim, x)
        z = torch.tensor(scene["z"], requires_grad=True)
        xg = tmodel.prior.constrain(z)
        xg["source_pixelated"] = [dict(lam=torch.tensor(lam))]
        (g,) = torch.autograd.grad(tmodel.stats_pixels(tsim, xg)[0].sum(), z)
    finally:
        jmodel.lam = tmodel.lam = scene["lam"]
    for k, w in zip(("log_marginal", "red_chi2"), want):
        assert np.isnan(np.asarray(w)[1])
        assert torch.isnan(out[k][1]) and torch.isfinite(out[k][[0, 2]]).all()
        np.testing.assert_allclose(out[k][[0, 2]].numpy(), np.asarray(w)[[0, 2]], rtol=RTOL)
    assert torch.isnan(out["source"][1]).all() and torch.isfinite(out["source"][[0, 2]]).all()
    assert torch.isfinite(g[[0, 2]]).all()


def test_map_steps_equal_jax(tiny):
    """Two ModellingSequence.MAP steps from the same starts on both sides."""
    z0 = np.array(tiny["jmodel"].prior.unconstrain(
        tiny["jmodel"].prior.sample(jax.random.PRNGKey(1), 8)))

    def sched(lib):
        return lib.chain(lib.scale_by_adam(), lib.scale_by_schedule(
            lib.polynomial_schedule(-1e-2, -1e-2 / 3, 0.5, 2)))

    jseq = JModellingSequence(tiny["jphys"], tiny["jmodel"], tiny["jcfg"])
    want = np.asarray(jseq.MAP(sched(optax), start=jnp.asarray(z0), n_samples=8, num_steps=2))
    seq = ModellingSequence(tiny["tphys"], tiny["tmodel"], tiny["tcfg"], device="cpu")
    got = seq.MAP(sched(optim), start=z0, n_samples=8, num_steps=2)
    assert np.max(np.abs(got.numpy() - z0)) > 1e-4
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-5)


def test_hmc_smoke_on_inversion_model(tiny):
    """The HMC driver runs on the marginal posterior (short chain)."""
    d = tiny["tmodel"].prior.d
    sim = LensSimulator(tiny["tphys"], tiny["tcfg"], bs=4, device="cpu")
    q = MultivariateNormalTriL(torch.zeros(d), 0.05 * torch.eye(d))
    res = fit_hmc(tiny["tmodel"], sim, q, n_hmc=4, num_burnin_steps=6, num_results=6,
                  max_leapfrog_steps=3, seed=0)
    assert res.samples.shape == (6, 4, d) and torch.isfinite(res.samples).all()


def test_event_size_and_position_stats_raise(tiny):
    tmodel = tiny["tmodel"]
    tsim = LensSimulator(tiny["tphys"], tiny["tcfg"], bs=1, device="cpu")
    assert tmodel.event_size(tsim) == tsim.n_live_pix == 400
    assert tmodel.include_pixels and not tmodel.include_positions
    assert tmodel.init_centroids(1) is None
    with pytest.raises(NotImplementedError):
        tmodel.stats_positions(tsim, {})
    with pytest.raises(ValueError, match="source_pixelated"):
        PixelatedSourceProbModel(tmodel.prior, tiny["obs"], error_map=np.ones((20, 20)),
                                 grid=tmodel.grid, device="cpu").solve(
            tsim, tmodel.prior.constrain(torch.tensor(tiny["z"][:1])))
    with pytest.raises(ValueError, match="chunk"):
        PixelatedSourceProbModel(tmodel.prior, tiny["obs"], 0.3, 100.0, grid=tmodel.grid,
                                 chunk=3, device="cpu")
    if not torch.cuda.is_available():  # device=None is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PixelatedSourceProbModel(tmodel.prior, tiny["obs"], 0.3, 100.0)


def test_pixelated_model_from_reference():
    """The interop copy: prior columns in JAX's order (sorted keys, the lam
    column included), data, error map, grid, lam, chunk and the
    regularizer with its ridge; a direct construction gives the same."""
    sc = _scene("ss2")
    jm = JPixelated(sc["jmodel"].prior, sc["obs"], background_rms=0.3, exp_time=100.0,
                    grid=JSourceGrid(6, 0.4, 0.05, -0.1), lam=None, reg_ridge=0.25, chunk=3)
    tm = pixelated_model_from_reference(jm, device="cpu")
    assert tm.prior.column_names() == jm.prior.column_names()
    assert tm.prior.column_names()[-1] == "source_pixelated/0/lam"
    assert tm.grid == SourceGrid(6, 0.4, 0.05, -0.1) and tm.chunk == 3 and tm.lam is None
    np.testing.assert_array_equal(tm.observed_image.numpy(), np.asarray(jm.observed_image))
    np.testing.assert_array_equal(tm.error_map.numpy(), np.asarray(jm.error_map))
    np.testing.assert_array_equal(tm.H_reg.numpy(), np.asarray(jm.H_reg))
    assert tm.logdet_H == jm.logdet_H and tm.device == torch.device("cpu")
    direct = PixelatedSourceProbModel(tm.prior, sc["obs"], background_rms=0.3, exp_time=100.0,
                                      grid=tm.grid, reg_ridge=0.25, chunk=3, device="cpu")
    for k in ("observed_image", "error_map", "H_reg"):
        assert torch.equal(getattr(direct, k), getattr(tm, k)), k
    assert direct.logdet_H == tm.logdet_H


def test_checkpoint_runs_the_psf_once_a_chunk(tiny):
    """Under autograd each chunk is checkpointed, and the recompute stops at
    the PSF conv's input (the last tensor the chunk's backward needs: K4's
    autograd function saves nothing), so a forward + gradient runs the
    conv once a chunk, as a forward does. The scene's PSF runs here through
    K4's direct route (its plain versions on the CPU), as on the card."""
    tmodel = tiny["tmodel"]
    tsim = LensSimulator(tiny["tphys"], tiny["tcfg"], bs=2, device="cpu")
    direct, calls = DirectConv(tiny["kern"], (20, 20), 1, "cpu"), []

    class Counted:
        pool = 1

        def __call__(self, img, scene_axis=0):
            calls.append(img.shape[0])
            return direct(img.reshape(-1, 20, 20)).reshape(img.shape)

    z = torch.tensor(tiny["z"][:2], requires_grad=True)
    want = tmodel.log_prob(tsim, z)[0]
    tsim._conv = Counted()
    tmodel.chunk = 2
    try:
        lp = tmodel.log_prob(tsim, z)[0]
        n_fwd = len(calls)
        (g,) = torch.autograd.grad(lp.sum(), z)
    finally:
        tmodel.chunk = None
    np.testing.assert_allclose(lp.detach().numpy(), want.detach().numpy(), rtol=RTOL)
    assert n_fwd == 8 // 2 and len(calls) == n_fwd and torch.isfinite(g).all()
    assert calls == [2 * 8] * n_fwd  # m * n_side basis images a chunk
