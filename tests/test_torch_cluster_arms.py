"""Config #5's two arms (scripts/bench_cluster_posterior.py) through the
port's ``gigalens_tpu_torch.bench.cluster_scene`` / ``run_cluster`` /
``--cluster`` against the JAX package, at a tiny size: 4 members, 16 px at
0.2", supersample 2, the script's 9x9 PSF, Shapelets(4).

The JAX script parses its argv when imported, so the JAX side of each
scene is rebuilt here from ``gigalens_tpu`` with the script's numbers and
the port's observation and traced images (numpy); the dpie series takes
JAX's coefficients on both sides; the lstsq arm is at 24 px (see ``arm``).
Tolerances, at four points about the truth: the pixel log-likelihood and
the lstsq arm's log_prob rtol 1e-5 (atol 1e-3), their z-gradients 1e-4 of
each sample's largest component; the position term, and log_prob with it,
rtol 1e-4 (atol 1e-2), tests/test_torch_cluster.py's scene tolerance, and
gradients 1e-3 of the largest: the centroid chi2 scales the two
libraries' float32 ray-shooting difference (~2e-5" through the halo and
members) by (beta - mean beta) / err^2 (measured: 7e-3 nats, gradients
5.1e-4 of the largest, eager against eager); one static-L8 HMC step body (tests/test_torch_hmc.py's
comparison) on the dpie scene, the same state and JAX's draws on both
sides: positions, log-densities and the acceptance rtol 1e-4 (atol 1e-5),
gradients 1e-4 of each chain's largest component, the leapfrog count
exact (float32 rounding of a ~1e3-nat density and its ~1e4 gradients
grows through eight leapfrogs, so not test_torch_hmc.py's 1e-5).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigalens_tpu import PhysicalModel as JPhysicalModel
from gigalens_tpu import SimulatorConfig as JSimulatorConfig
from gigalens_tpu.model import BackwardProbModel as JBackwardProbModel
from gigalens_tpu.model import ForwardProbModel as JForwardProbModel
from gigalens_tpu.prob import Prior as JPrior
from gigalens_tpu.prob import distributions as jd
from gigalens_tpu.profiles.light.shapelets import Shapelets as JShapelets
from gigalens_tpu.profiles.mass.dpie_subhalo import DPIESubhaloSeries as JDPIESubhaloSeries
from gigalens_tpu.profiles.mass.nfw import NFW_ELLIPSE as JNFW_ELLIPSE
from gigalens_tpu.profiles.mass.scaling import ScalingRelation as JScalingRelation
from gigalens_tpu.profiles.mass.sie import NIE as JNIE
from gigalens_tpu.simulator import LensSimulator as JLensSimulator
from gigalens_tpu_torch import bench
from gigalens_tpu_torch.simulator import LensSimulator

G, PIX, LSTSQ_PIX = 4, 16, 24
ROW_KEYS = {"members", "galaxies", "t_map", "map_red_chi2", "t_svi", "t_hmc", "min_ess",
            "max_rhat", "ess_per_sec", "accept", "divergent_chain_steps", "leapfrogs",
            "posterior_red_chi2", "total_s", "theta_E_star", "gates"}
TINY = dict(galaxies=G, num_pix=PIX, map_n=8, map_steps=3, vi_n=8, vi_steps=3, hmc=4,
            burnin=2, results=3, traj="static", init_l=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's side on one thread: its many small CPU operations slow
    down manifold when the test workers' threads contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_arm(kind, sc):
    """(JAX simulator config, prob model) of ``sc``'s arm, as the script
    builds it, on the port's observation and images."""
    cat = bench.cluster_catalogue(G)
    if kind == "sie":
        members = JScalingRelation(JNIE(), ["theta_E"], lum_star=1.0,
                                   scaling_params_power={"theta_E": 0.5},
                                   galaxy_catalogue=dict(cat, s_scale=np.full(G, 0.05, np.float32)),
                                   chunk_size=G)
        member_prior = dict(theta_E=jd.LogNormal(np.log(0.3), 0.3))
    else:
        members = JDPIESubhaloSeries(lum_star=1.0, galaxy_catalogue=cat, order=3, chunk_size=G)
        member_prior = dict(theta_E=jd.LogNormal(np.log(0.3), 0.3),
                            r_cut=jd.LogNormal(np.log(1.5), 0.2))
    lstsq = sc.source == "lstsq"
    shapelet = JShapelets(n_max=4, use_lstsq=lstsq)
    phys = JPhysicalModel([JNFW_ELLIPSE(), members], [], [shapelet])
    src = dict(beta=jd.LogNormal(np.log(0.4), 0.2), center_x=jd.Normal(0, 0.3),
               center_y=jd.Normal(0, 0.3))
    if not lstsq:
        src.update({a: jd.Normal(0, 5.0) for a in shapelet._amp_names})
    prior = JPrior(dict(lens_mass=[dict(Rs=jd.LogNormal(np.log(10.0), 0.2),
                                        alpha_Rs=jd.LogNormal(np.log(4.0), 0.3),
                                        e1=jd.Normal(0, 0.1), e2=jd.Normal(0, 0.1),
                                        center_x=jd.Normal(0, 0.5), center_y=jd.Normal(0, 0.5)),
                                   member_prior],
                        source_light=[src]))
    cfg = JSimulatorConfig(delta_pix=0.2, num_pix=sc.obs.shape[0], supersample=2,
                           kernel=bench.cluster_psf(), use_fused_render=False)
    if kind == "dpie":
        members.set_constants(dict(r_cut=1.5, r_core=0.08))
        probe = JLensSimulator(phys, cfg, bs=1)
        members.set_grid(probe.img_x, probe.img_y)
        members.set_deriv()
    if lstsq:
        return phys, cfg, JBackwardProbModel(prior, sc.obs, background_rms=0.1, exp_time=500.0)
    x, y, _ = sc.images
    err = np.full(len(x), 0.1, np.float32)
    return phys, cfg, JForwardProbModel(prior, sc.obs, background_rms=0.1, exp_time=500.0,
                                        centroids_x=[x], centroids_y=[y],
                                        centroids_errors_x=[err], centroids_errors_y=[err])


@pytest.fixture(scope="module", params=[("dpie", "sampled"), ("sie", "sampled"),
                                        ("sie", "lstsq")], ids=lambda p: "-".join(p))
def arm(request):
    kind, source = request.param
    # the lstsq arm at 24 px: at 16 px its 15 shapelet components are not
    # resolved (the normal matrix's singular values span 1e7, past the
    # pseudo-inverse's 1e-6 cutoff, whose gradient is then not defined)
    pix = LSTSQ_PIX if source == "lstsq" else PIX
    sc = bench.cluster_scene(kind, galaxies=G, source=source, device="cpu", num_pix=pix)
    jphys, jcfg, jprob = jax_arm(kind, sc)
    if kind == "dpie":
        # JAX's series coefficients on both sides, as interop carries them:
        # the two precomputes differ by float32 rounding past order 1,
        # which the coefficient tests of tests/test_torch_cluster.py and
        # tests/test_torch_series_order5.py hold
        sc.members._deriv_coefs = torch.from_numpy(
            np.array(jphys.lenses[1]._deriv_coefs, np.float32))
        sc.members._device_cache = {}
    # four points about the truth (the lstsq prior drops its amplitudes)
    truth = {k: v for k, v in sc.truth.items()}
    if source == "lstsq":
        truth["source_light"] = [{k: v for k, v in truth["source_light"][0].items()
                                  if k in ("beta", "center_x", "center_y")}]
    z0 = sc.prior.unconstrain(truth).numpy()
    z = z0 + 0.05 * np.random.default_rng(9).standard_normal((4, z0.shape[-1]))
    return sc, jphys, jcfg, jprob, z.astype(np.float32)


def test_scene_follows_the_script(arm):
    """The truth's images: the port traces at least two for every arm at
    this size, and a sampled source's fit carries them as positions; the
    lstsq fit takes none (BackwardProbModel, as the script)."""
    sc, _, _, jprob, z = arm
    assert len(sc.images[0]) >= 2
    assert sc.prob.include_positions == (sc.source == "sampled")
    assert sc.obs.shape[0] == sc.cfg.num_pix and np.isfinite(sc.obs).all()
    assert z.shape == (4, sc.prior.d) and jprob.prior.d == sc.prior.d


def test_log_prob_and_gradient_match_jax(arm):
    """log_prob and each of its likelihood terms, with their z-gradients,
    against JAX's: values eager on both sides, JAX's gradients jitted."""
    sc, jphys, jcfg, jprob, z = arm
    sim = LensSimulator(sc.phys, sc.cfg, bs=z.shape[0], device="cpu")
    jsim = JLensSimulator(jphys, jcfg, bs=z.shape[0])
    terms = ["stats_pixels"] + (["stats_positions"] if sc.prob.include_positions else [])

    def port(fn):
        zt = torch.tensor(z, requires_grad=True)
        v = fn(zt)
        return v.detach().numpy(), torch.autograd.grad(v.sum(), zt)[0].numpy()

    def jax_fns():
        out = [lambda zz: jprob.log_prob(jsim, zz)[0]]
        return out + [lambda zz, t=t: getattr(jprob, t)(jsim, jprob.prior.constrain(zz))[0]
                      for t in terms]

    fns = [lambda zt: sc.prob.log_prob(sim, zt)[0]] + [
        lambda zt, t=t: getattr(sc.prob, t)(sim, sc.prior.constrain(zt))[0] for t in terms]
    grads = jax.jit(lambda zz: [jax.grad(lambda q, f=f: jnp.sum(f(q)))(zz)
                                for f in jax_fns()])(jnp.asarray(z))
    positions = sc.prob.include_positions
    for name, fn, jfn, jg in zip(["log_prob"] + terms, fns, jax_fns(), grads):
        value, grad = port(fn)
        jv, jg = np.asarray(jfn(jnp.asarray(z))), np.asarray(jg)
        loose = positions and name != "stats_pixels"
        np.testing.assert_allclose(value, jv, err_msg=name,
                                   **(dict(rtol=1e-4, atol=1e-2) if loose
                                      else dict(rtol=1e-5, atol=1e-3)))
        scale = np.abs(jg).max(1, keepdims=True)
        assert np.isfinite(grad).all() and (scale > 0).all(), name
        np.testing.assert_allclose(grad / scale, jg / scale, rtol=0, err_msg=name,
                                   atol=1e-3 if loose or sc.source == "lstsq" else 1e-4)


@pytest.mark.parametrize("arm", [("dpie", "sampled")], indirect=True, ids=["dpie-sampled"])
def test_static_l8_hmc_step_matches_jax(arm):
    """One post-adaptation HMC step of 8 leapfrogs (static L) of the port's
    step body against the JAX package's, on the dpie arm's pixel
    log-density (the position term's float32 conditioning is
    test_log_prob_and_gradient_match_jax's), from the same state with JAX's
    draws (tests/test_torch_hmc.py)."""
    from gigalens_tpu_torch.model import ForwardProbModel

    sc, jphys, jcfg, jprob, z = arm
    kw = dict(background_rms=0.1, exp_time=500.0)
    prob = ForwardProbModel(sc.prior, sc.obs, device="cpu", **kw)
    jprob = JForwardProbModel(jprob.prior, sc.obs, **kw)
    from gigalens_tpu.inference.hmc import ChEESState as JChees
    from gigalens_tpu.inference.hmc import DualAveragingState as JDA
    from gigalens_tpu.inference.hmc import _hmc_programs
    from gigalens_tpu_torch.inference.hmc import (
        ChEESState, DualAveragingState, HMCState, _hmc_step_fn, _lp_and_grad,
    )

    n, d = z.shape
    t, L = 30, 8
    kw = dict(num_leapfrog_steps=L, num_adaptation_steps=20, switch_ts=(), do_mass=False,
              target_accept=0.75, max_leapfrog_steps=30, chees_lr=0.025)
    rng = np.random.default_rng(3)
    tril = np.float32(np.eye(d)[None] * 0.02)
    eps = np.float32([0.05])
    da = tuple(np.float32(v) for v in (np.log(eps), np.log(eps), [0.0], np.log(10 * eps), [0.0]))
    ch = tuple(np.float32(v) for v in (np.log([0.4]), [0.0], [0.01]))
    s1, s2 = np.zeros((1, d), np.float32), np.zeros((1, d, d), np.float32)
    cnt, z_ref = np.zeros(1, np.float32), np.float32(rng.normal(size=(1, d)))
    key = jax.random.PRNGKey(5)
    k_mom, k_acc = jax.random.split(key)
    eps_n = np.asarray(jax.random.normal(k_mom, (n, d), jnp.float32))
    u = np.asarray(jax.random.uniform(k_acc, (n,), jnp.float32, minval=1e-10))

    sim = LensSimulator(sc.phys, sc.cfg, bs=n, device="cpu")
    jsim = JLensSimulator(jphys, jcfg, bs=n)

    def log_prob(zz):
        return prob.log_prob(sim, zz)[0]

    def j_log_prob(zz):
        return jprob.log_prob(jsim, zz)[0]

    T = torch.tensor
    zt = T(z)
    lp, grad = _lp_and_grad(log_prob, zt)
    state = HMCState(zt, lp, grad, DualAveragingState(*map(T, da)), ChEESState(*map(T, ch)),
                     T(tril), T(s1), T(s2), T(cnt), T(z_ref), torch.zeros(n, dtype=torch.int32))
    step = _hmc_step_fn(log_prob, n, d, 1, torch.device("cpu"), chees=False, **kw)
    new, acc, n_max = step(state, t, 1.0, T(eps_n), T(u))

    _, run_segment = _hmc_programs(
        j_log_prob, n, d, 0.3, kw.pop("num_leapfrog_steps"), kw.pop("num_adaptation_steps"),
        kw.pop("switch_ts"), kw.pop("do_mass"), False, kw.pop("target_accept"), "mean",
        kw.pop("max_leapfrog_steps"), kw.pop("chees_lr"), None, 1)
    J = jnp.asarray
    jlp, jgrad = jax.value_and_grad(lambda zz: jnp.sum(j_log_prob(zz)))(J(z))
    carry = (J(z), j_log_prob(J(z)), jgrad, JDA(*map(J, da)), JChees(*map(J, ch)),
             jnp.asarray(t), J(tril), J(s1), J(s2), J(cnt), J(z_ref), jnp.zeros(n, jnp.int32),
             jnp.zeros((), jnp.int32))
    carry, (_, acc_j) = run_segment(carry, key[None], jnp.full((1,), 1.0, jnp.float32))
    zj, lpj, gj, *_, nlfj = carry

    np.testing.assert_allclose(new.z.numpy(), np.asarray(zj), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(new.lp.numpy(), np.asarray(lpj), rtol=1e-4, atol=1e-5)
    scale = np.abs(np.asarray(gj)).max(1, keepdims=True)
    np.testing.assert_allclose(new.grad.numpy() / scale, np.asarray(gj) / scale, rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(float(acc.sum()) / n, float(acc_j[0]), rtol=1e-4, atol=1e-5)
    assert n_max == int(nlfj) == L
    assert not torch.equal(new.z, zt)


def test_run_cluster_prints_the_script_keys(capsys):
    """``cluster_main`` (what ``--cluster`` runs) on both arms at a tiny
    depth, then the sie arm's lstsq source through SMC: one JSON line with
    the script's keys, each row with its own, and exit code 0."""
    assert bench.cluster_main(["sie", "dpie"], device="cpu", **TINY) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == "cluster_full_posterior" and out["unit"] == "s"
    assert out["device"] == "cpu" and out["complete"] is True
    assert [r["members"] for r in out["runs"]] == ["sie", "dpie"]
    for r in out["runs"]:
        assert ROW_KEYS <= set(r) and r["galaxies"] == G
        assert set(r["gates"]) == {"chi2_ok", "rhat_ok"}
        assert set(r["theta_E_star"]) == {"true", "mean", "std"}
        assert r["leapfrogs"] > 0 and np.isfinite(r["posterior_red_chi2"])
    assert out["runs"][1]["positions"] >= 2
    assert out["value"] == round(float(np.median([r["total_s"] for r in out["runs"]])), 2)

    smc = dict(TINY, num_pix=8, particles=8, results=2, sampler="smc", source="lstsq")
    assert bench.cluster_main(["sie"], device="cpu", **smc) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["runs"][0]
    assert ROW_KEYS | {"smc_stages", "log_evidence"} <= set(row)
    assert row["t_svi"] == 0.0 and row["positions"] == 0 and row["smc_stages"] >= 1
    assert np.isfinite(row["log_evidence"])


@pytest.mark.quick
def test_cli_flags_and_a_failing_phase(monkeypatch, capsys):
    """``--cluster`` passes the script's flags to ``cluster_main``; a phase
    that raises ends the run with a nonzero exit, its traceback, and a JSON
    line that says what failed."""
    seen = {}
    monkeypatch.setattr(bench, "cluster_main", lambda kinds, **kw: seen.update(kinds=kinds, **kw))
    bench._cli(["--cluster", "both", "--device", "cpu", "--galaxies", "7", "--hmc", "6",
                "--burnin", "5", "--results", "4", "--seed", "2", "--traj", "static",
                "--init-l", "3", "--mass-windows", "2", "--sampler", "smc", "--particles", "9",
                "--source", "lstsq"])
    assert seen == dict(kinds=["sie", "dpie"], device="cpu", galaxies=7, hmc=6, burnin=5,
                        results=4, seed=2, traj="static", init_l=3, mass_windows=2,
                        sampler="smc", particles=9, source="lstsq")
    monkeypatch.undo()

    def fail(self, *a, **k):
        raise RuntimeError("injected MAP failure")

    monkeypatch.setattr(bench.ClusterRun, "phase_map", fail)
    assert bench._cli(["--cluster", "sie", "--device", "cpu", "--galaxies", "2"]) == 1
    cap = capsys.readouterr()
    assert "CLUSTER sie FAILED" in cap.err and "injected MAP failure" in cap.err
    out = json.loads(cap.out.strip().splitlines()[-1])
    assert out["complete"] is False and out["runs"] == []
    assert out["failed"][0]["members"] == "sie"
