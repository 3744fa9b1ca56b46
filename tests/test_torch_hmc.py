"""The port's preconditioned HMC (CPU): statistical checks on Gaussian
targets mirroring ``tests/test_inference.py`` and ``tests/test_survey.py``,
dual averaging against the JAX package's at rtol 1e-6, and a run started
from a JAX surrogate through ``interop.mvn_from_reference``.

Chains are random, so the sampler is held to the same statistical bounds
as the JAX package's own tests (moments, ESS ratios), not draw by draw.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigalens_tpu.inference.hmc import _da_init as j_da_init
from gigalens_tpu.inference.hmc import _da_update as j_da_update
from gigalens_tpu.inference.hmc import sample_hmc as j_sample_hmc
from gigalens_tpu.prob.distributions import MultivariateNormalTriL as JMultivariateNormalTriL
from gigalens_tpu_torch.inference import ModellingSequence, sample_hmc
from gigalens_tpu_torch.inference.hmc import _da_init, _da_update, _halton
from gigalens_tpu_torch.interop import (
    mvn_from_reference, phys_model_from_reference, prior_from_reference,
    sim_config_from_reference,
)
from gigalens_tpu_torch.model import ForwardProbModel
from gigalens_tpu_torch.utils import effective_sample_size

DA_RTOL = 1e-6


def _correlated_gaussian(d, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(d, d)).astype(np.float32)
    cov = A @ A.T + np.eye(d, dtype=np.float32)
    return cov, torch.tensor(np.linalg.inv(cov))


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_hmc_gaussian_moments():
    """HMC reproduces a correlated Gaussian's mean and covariance."""
    d = 4
    cov, prec = _correlated_gaussian(d, 0)
    mean = torch.arange(d, dtype=torch.float32)

    def log_prob(z):
        diff = z - mean
        return -0.5 * torch.sum((diff @ prec) * diff, -1)

    res = sample_hmc(log_prob, torch.zeros((32, d)) + mean, _gen(), step_size=0.3,
                     num_leapfrog_steps=3, num_burnin_steps=300, num_results=1500,
                     momentum_covariance=cov)
    s = res.samples.reshape(-1, d).numpy()
    assert res.samples.shape == (1500, 32, d)
    assert float(res.accept_rate[-200:].mean()) > 0.6
    assert res.total_leapfrogs == 3 * 1800
    np.testing.assert_allclose(s.mean(0), mean.numpy(), atol=0.15)
    np.testing.assert_allclose(np.cov(s.T), cov, atol=0.6, rtol=0.25)


def test_warmup_adaptations_improve_ess():
    """Bad (identity) initial preconditioner: ChEES beats static L=3, and
    windowed mass adaptation beats both by learning the covariance."""
    d = 6
    cov, prec = _correlated_gaussian(d, 0)

    def log_prob(z):
        return -0.5 * torch.sum((z @ prec) * z, -1)

    def run(mode, mass):
        return sample_hmc(log_prob, torch.zeros((32, d)), _gen(), step_size=0.2,
                          num_leapfrog_steps=3, num_burnin_steps=300, num_results=800,
                          trajectory_adaptation=mode, max_leapfrog_steps=30,
                          mass_adaptation=mass)

    def min_ess(res):
        return float(effective_sample_size(res.samples).min())

    ess_static = min_ess(run("none", False))
    res_chees = run("chees", False)
    ess_chees = min_ess(res_chees)
    ess_mass = min_ess(run("none", True))
    assert ess_chees > 1.2 * ess_static, (ess_chees, ess_static)
    assert ess_mass > 2.0 * ess_static, (ess_mass, ess_static)
    t_final, eps = float(res_chees.trajectory_length), float(res_chees.step_size)
    assert t_final > 2.0 * eps * 3 / 2, (t_final, eps)  # grew beyond L~3 scale
    assert res_chees.total_leapfrogs > 3 * 1100
    s = res_chees.samples.reshape(-1, d).numpy()
    np.testing.assert_allclose(np.var(s, 0), np.diag(cov), rtol=0.25)


def test_multi_window_mass_adaptation_moments():
    """mass_adaptation=2 (two warmup windows) keeps correct moments and a
    healthy acceptance."""
    d = 5
    cov, prec = _correlated_gaussian(d, 1)

    def log_prob(z):
        return -0.5 * torch.sum((z @ prec) * z, -1)

    res = sample_hmc(log_prob, torch.zeros((32, d)), _gen(), step_size=0.2,
                     num_leapfrog_steps=3, num_burnin_steps=400, num_results=800,
                     trajectory_adaptation="chees", mass_adaptation=2)
    s = res.samples.reshape(-1, d).numpy()
    assert float(res.accept_rate[-200:].mean()) > 0.5
    np.testing.assert_allclose(np.var(s, 0), np.diag(cov), rtol=0.3)
    np.testing.assert_allclose(s.mean(0), 0.0, atol=0.35)


@pytest.mark.quick
def test_da_update_matches_jax():
    """Dual averaging over 40 steps with a restart at t = 25, per-group
    (G = 2) accept probabilities."""
    acc = np.random.default_rng(2).uniform(0.2, 1.0, (40, 2)).astype(np.float32)
    eps0 = np.array([0.3, 0.05], np.float32)
    js, ts = j_da_init(jnp.asarray(eps0)), _da_init(torch.tensor(eps0))
    for t in range(40):
        if t == 25:
            js = j_da_init(jnp.exp(js.log_eps), t_start=t)
            ts = _da_init(torch.exp(ts.log_eps), t_start=t)
        js = j_da_update(js, jnp.asarray(t), jnp.asarray(acc[t]), target=0.75)
        ts = _da_update(ts, t, torch.tensor(acc[t]), target=0.75)
        for name, a, b in zip(js._fields, ts, js):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=DA_RTOL, atol=1e-7,
                                       err_msg=f"{name} at t={t}")


def test_halton_matches_jax():
    from gigalens_tpu.inference.hmc import _halton as j_halton

    np.testing.assert_array_equal(_halton(50), j_halton(50))


def test_grouped_chains_adapt_their_own_step_size():
    """n_groups=2: two Gaussians 30x apart in scale behind one identity
    preconditioner; each group adapts its own eps and trajectory length and
    recovers its own scale."""
    d, C = 3, 16
    scale = torch.repeat_interleave(torch.tensor([0.1, 3.0]), C)[:, None]

    def log_prob(z):
        return -0.5 * torch.sum((z / scale) ** 2, -1)

    z0 = 0.1 * torch.randn((2 * C, d), generator=_gen(0))
    res = sample_hmc(log_prob, z0, _gen(1), step_size=0.2, num_leapfrog_steps=3,
                     num_burnin_steps=200, num_results=400, trajectory_adaptation="chees",
                     mass_adaptation=False, n_groups=2)
    assert res.step_size.shape == (2,) and res.trajectory_length.shape == (2,)
    assert res.divergences.shape == (2 * C,)
    eps = res.step_size.numpy()
    assert eps[1] > 10 * eps[0], eps
    s = res.samples.numpy()
    np.testing.assert_allclose(s[:, :C].reshape(-1, d).std(0), 0.1, rtol=0.2)
    np.testing.assert_allclose(s[:, C:].reshape(-1, d).std(0), 3.0, rtol=0.2)
    with pytest.raises(ValueError, match="groups"):
        sample_hmc(log_prob, z0[:5], _gen(), n_groups=2)


def test_non_finite_proposal_keeps_trajectory_length_finite():
    """F-ref-3: a proposal that leaves the support (log density NaN) is
    rejected and enters the ChEES estimate with zero weight, so the
    trajectory length stays finite and trajectories keep their length. The
    JAX package, on the same target and settings, ends with a NaN
    trajectory length and one leapfrog per step from then on."""
    d = 2
    kw = dict(step_size=0.5, num_leapfrog_steps=3, num_burnin_steps=200, num_results=100,
              trajectory_adaptation="chees", mass_adaptation=False)

    def log_prob(z):
        # standard normal on z[:, 0] > -2, NaN (with NaN gradient) beyond
        return -0.5 * torch.sum(z**2, -1) + 0.0 * torch.sqrt(z[:, 0] + 2.0)

    res = sample_hmc(log_prob, torch.zeros((16, d)), _gen(0), **kw)
    assert torch.isfinite(res.trajectory_length) and torch.isfinite(res.samples).all()
    assert bool((res.samples[..., 0] > -2.0).all())
    assert res.total_leapfrogs > 2 * 300

    def j_log_prob(z):
        return -0.5 * jnp.sum(z**2, -1) + 0.0 * jnp.sqrt(z[:, 0] + 2.0)

    res_j = j_sample_hmc(j_log_prob, jnp.zeros((16, d)), jax.random.PRNGKey(0), **kw)
    assert np.isnan(float(res_j.trajectory_length))
    assert int(res_j.total_leapfrogs) < res.total_leapfrogs / 2


STEP_KW = dict(num_leapfrog_steps=3, num_adaptation_steps=20, switch_ts=(10,), do_mass=True,
               target_accept=0.75, max_leapfrog_steps=10, chees_lr=0.025)


def _step_inputs(G, t, seed):
    """A mid-run chain state at step ``t`` (per-group step sizes, trajectory
    lengths and preconditioners that differ; moment accumulators of ``t``
    steps) and the JAX draws of one key, as numpy."""
    rng = np.random.default_rng(seed)
    d, C = 3, 4
    n = G * C
    a = rng.normal(size=(G, d, d)) * 0.3
    tril = np.tril(a, -1) + np.eye(d) * rng.uniform(0.6, 1.4, (G, 1, d))
    eps = rng.uniform(0.2, 0.6, G)
    z_ref = rng.normal(size=(G, d))
    zs = z_ref[:, None, None] + rng.normal(size=(G, max(t, 1), C, d))
    zc = zs - z_ref[:, None, None]
    st = dict(
        z=rng.normal(size=(n, d)),
        da=(np.log(eps), np.log(eps) + rng.normal(0, 0.1, G), rng.normal(0, 0.05, G),
            np.log(10 * eps), np.zeros(G)),
        ch=(np.log(rng.uniform(0.5, 2.5, G)), rng.normal(0, 0.1, G), rng.uniform(0.01, 0.1, G)),
        tril=tril, s1=zc.sum((1, 2)), s2=np.einsum("gtcd,gtce->gde", zc, zc),
        cnt=np.full(G, float(max(t, 1) * C)), z_ref=z_ref)
    st = {k: (tuple(np.float32(x) for x in v) if isinstance(v, tuple) else np.float32(v))
          for k, v in st.items()}
    k_mom, k_acc = jax.random.split(jax.random.PRNGKey(seed))
    eps_n = np.asarray(jax.random.normal(k_mom, (n, d), jnp.float32))
    u = np.asarray(jax.random.uniform(k_acc, (n,), jnp.float32, minval=1e-10))
    return st, jax.random.PRNGKey(seed), eps_n, u


@pytest.mark.parametrize("G,t,mode", [
    (1, 0, "chees"),   # the single-fit path, adapting
    (2, 5, "chees"),   # per-group eps/T: the freeze masks; moment accumulation
    (2, 10, "chees"),  # the mass switch: shrinkage, Cholesky, the restarts
    (1, 22, "none"),   # post-adaptation, static L: eps_bar, divergence count
])
def test_one_step_matches_jax(G, t, mode):
    """One step of the port's step body against the JAX package's
    (``_hmc_programs``' step, run as a one-key segment) from the same state
    with the same draws: momentum through L^-T, the |L^T p|^2 / 2 kinetic
    energy, the leapfrog, accept, the ChEES gradient and its Adam step, dual
    averaging, the moment accumulators and the mass switch. One step, since
    float32 rounding differences grow from step to step through dual
    averaging. Tolerance rtol 1e-5 (atol 1e-6); leapfrog and divergence
    counts exact."""
    from gigalens_tpu.inference.hmc import ChEESState as JChees
    from gigalens_tpu.inference.hmc import DualAveragingState as JDA
    from gigalens_tpu.inference.hmc import _hmc_programs
    from gigalens_tpu_torch.inference.hmc import (
        ChEESState, DualAveragingState, HMCState, _hmc_step_fn, _lp_and_grad,
    )

    st, key, eps_n, u = _step_inputs(G, t, seed=10 * G + t)
    n, d = st["z"].shape
    cov, prec = _correlated_gaussian(d, 3)
    prec_j = jnp.asarray(prec.numpy())

    def log_prob(z):
        return -0.5 * torch.sum((z @ prec) * z, -1)

    def j_log_prob(z):
        return -0.5 * jnp.sum((z @ prec_j) * z, -1)

    chees = mode == "chees"
    h = 0.75 if chees else 1.0
    z = torch.tensor(st["z"])
    lp, grad = _lp_and_grad(log_prob, z)
    T = lambda a: torch.tensor(a)  # noqa: E731
    state = HMCState(z, lp, grad, DualAveragingState(*map(T, st["da"])),
                     ChEESState(*map(T, st["ch"])), T(st["tril"]), T(st["s1"]), T(st["s2"]),
                     T(st["cnt"]), T(st["z_ref"]), torch.zeros(n, dtype=torch.int32))
    step = _hmc_step_fn(log_prob, n, d, G, torch.device("cpu"), chees=chees, **STEP_KW)
    new, acc, n_max = step(state, t, h, T(eps_n), T(u))

    kw = dict(STEP_KW)
    _, run_segment = _hmc_programs(
        j_log_prob, n, d, 0.3, kw.pop("num_leapfrog_steps"), kw.pop("num_adaptation_steps"),
        kw.pop("switch_ts"), kw.pop("do_mass"), chees, kw.pop("target_accept"), "mean",
        kw.pop("max_leapfrog_steps"), kw.pop("chees_lr"), None, G)
    J = jnp.asarray
    carry = (J(st["z"]), J(lp.numpy()), J(grad.numpy()), JDA(*map(J, st["da"])),
             JChees(*map(J, st["ch"])), jnp.asarray(t), J(st["tril"]), J(st["s1"]),
             J(st["s2"]), J(st["cnt"]), J(st["z_ref"]), jnp.zeros(n, jnp.int32),
             jnp.zeros((), jnp.int32))
    carry, (_, acc_j) = run_segment(carry, key[None], jnp.full((1,), h, jnp.float32))
    zj, lpj, gj, daj, chj, tj, trilj, s1j, s2j, cntj, zrefj, divj, nlfj = carry

    def close(name, a, b):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6,
                                   err_msg=name)

    for name, a, b in [("z", new.z, zj), ("lp", new.lp, lpj), ("grad", new.grad, gj),
                       ("tril", new.tril, trilj), ("s1", new.s1, s1j), ("s2", new.s2, s2j),
                       ("cnt", new.cnt, cntj), ("z_ref", new.z_ref, zrefj),
                       ("accept", acc.sum() / n, acc_j[0])]:
        close(name, a, b)
    for name, a, b in zip(DualAveragingState._fields, new.da, daj):
        close(f"da.{name}", a, b)
    for name, a, b in zip(ChEESState._fields, new.ch, chj):
        close(f"ch.{name}", a, b)
    assert n_max == int(nlfj) and int(tj) == t + 1
    np.testing.assert_array_equal(new.div.numpy(), np.asarray(divj))


@pytest.fixture(scope="module")
def lens_seq(demo_prior, demo_physmodel, small_sim_config):
    prob = ForwardProbModel(prior_from_reference(demo_prior), np.zeros((20, 20), np.float32),
                            background_rms=0.1, exp_time=100, device="cpu")
    return ModellingSequence(phys_model_from_reference(demo_physmodel), prob,
                             sim_config_from_reference(small_sim_config), device="cpu")


def test_hmc_from_jax_surrogate(lens_seq, demo_prior):
    """A JAX surrogate carried across starts the port's HMC on the demo
    scene: finite samples of the right shape, and the chains move."""
    d = demo_prior.d
    start = demo_prior.unconstrain(demo_prior.sample(jax.random.PRNGKey(1), 1))[0]
    q_j = JMultivariateNormalTriL(start, jnp.eye(d) * 1e-3)
    q = mvn_from_reference(q_j, device="cpu")
    np.testing.assert_array_equal(q.loc.numpy(), np.asarray(start))
    res = lens_seq.HMC(q, n_hmc=8, num_burnin_steps=4, num_results=6, seed=3)
    assert res.samples.shape == (6, 8, d)
    assert torch.isfinite(res.samples).all()
    assert res.accept_rate.shape == (10,) and res.divergences.shape == (8,)
    assert res.total_leapfrogs >= 10
    assert not torch.equal(res.samples[0], res.samples[-1])
