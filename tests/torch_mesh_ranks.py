"""Per-rank scenarios of tests/test_torch_mesh.py and
tests/test_torch_mesh_survey.py (not a test module).

Each scenario builds its scene from the numpy arrays it is given with the
port alone (no JAX: the spawned ranks import torch and the port only), runs
one piece of the pipeline under ``mesh`` (``None``: one rank, in-process)
and returns plain containers of CPU tensors. The test modules run every
scenario once in-process and once in each of two ``gloo`` ranks spawned by
:func:`gigalens_tpu_torch.parallel.spawn_ranks`, and compare.
"""
import math
import os

import numpy as np
import torch

from gigalens_tpu_torch import PhysicalModel, SimulatorConfig
from gigalens_tpu_torch.inference import ModellingSequence, SurveySequence, optim
from gigalens_tpu_torch.model import ForwardProbModel, SurveyForwardProbModel
from gigalens_tpu_torch.parallel import mesh as pmesh
from gigalens_tpu_torch.prob import Prior
from gigalens_tpu_torch.prob import distributions as dist
from gigalens_tpu_torch.prob.distributions import MultivariateNormalTriL
from gigalens_tpu_torch.profiles.light import SersicEllipse
from gigalens_tpu_torch.profiles.mass import EPL, SIE, Shear

BKG, EXP_TIME = 0.2, 100.0


def adam(lr=1e-3):
    """optax.adam(lr)."""
    return optim.chain(optim.scale_by_adam(), optim.scale_by_schedule(lambda t: -lr))


def demo_prior():
    """tests/conftest.py's demo prior (the bench prior)."""
    from gigalens_tpu_torch.bench import bench_prior

    return bench_prior()


def gaussian_psf(n=5, width=2.0):
    g = np.exp(-((np.arange(n) - n // 2) ** 2 + (np.arange(n)[:, None] - n // 2) ** 2) / width)
    return (g / g.sum()).astype(np.float32)


def demo_scene(obs, device="cpu"):
    """(phys, sim_config, prob_model) of tests/test_torch_map.py's scene:
    EPL(18)+Shear, SersicEllipse lens light and source, 20 px at 0.13",
    supersample 2, a 5x5 Gaussian PSF, the unfused render."""
    phys = PhysicalModel([EPL(18), Shear()], [SersicEllipse()], [SersicEllipse()])
    cfg = SimulatorConfig(delta_pix=0.13, num_pix=20, supersample=2, kernel=gaussian_psf(),
                          use_fused_render=False)
    prob = ForwardProbModel(demo_prior(), obs, background_rms=BKG, exp_time=EXP_TIME,
                            device=device)
    return phys, cfg, prob


def survey_prior():
    """tests/test_survey.py's survey prior (SIE + Shear, a Sersic source)."""
    return Prior(dict(
        lens_mass=[dict(theta_E=dist.LogNormal(math.log(1.0), 0.15), e1=dist.Normal(0, 0.05),
                        e2=dist.Normal(0, 0.05), center_x=dist.Normal(0, 0.05),
                        center_y=dist.Normal(0, 0.05)),
                   dict(gamma1=dist.Normal(0, 0.03), gamma2=dist.Normal(0, 0.03))],
        source_light=[dict(R_sersic=dist.LogNormal(math.log(0.3), 0.15),
                           n_sersic=dist.Uniform(1, 3), e1=dist.Normal(0, 0.1),
                           e2=dist.Normal(0, 0.1), center_x=dist.Normal(0, 0.1),
                           center_y=dist.Normal(0, 0.1), Ie=dist.LogNormal(math.log(100.0), 0.3))],
    ))


def survey_scene():
    """(phys, sim_config) of tests/test_survey.py's catalogue: 24 px at
    0.12", supersample 1, no PSF."""
    phys = PhysicalModel([SIE(), Shear()], [], [SersicEllipse()])
    return phys, SimulatorConfig(delta_pix=0.12, num_pix=24, supersample=1)


def inversion_scene(obs, kern):
    """(phys, sim_config, model) of tests/test_inversion.py's tiny scene:
    SIE + Shear, 20 px at 0.1", supersample 1, the 5x5 PSF in the direct
    mode, an 8x8 source grid of extent 0.5", lam fixed at 2."""
    from gigalens_tpu_torch.inversion import PixelatedSourceProbModel, SourceGrid

    prior = Prior(dict(lens_mass=[
        dict(theta_E=dist.LogNormal(math.log(0.7), 0.1), e1=dist.Normal(0, 0.1),
             e2=dist.Normal(0, 0.1), center_x=dist.Normal(0, 0.05),
             center_y=dist.Normal(0, 0.05)),
        dict(gamma1=dist.Normal(0, 0.05), gamma2=dist.Normal(0, 0.05))]))
    phys = PhysicalModel([SIE(), Shear()], [], [])
    cfg = SimulatorConfig(delta_pix=0.1, num_pix=20, kernel=kern, supersample=1,
                          psf_mode="direct")
    model = PixelatedSourceProbModel(prior, obs, background_rms=0.3, exp_time=100.0,
                                     grid=SourceGrid(n_side=8, extent=0.5), lam=2.0,
                                     device="cpu")
    return phys, cfg, model


def _np(x):
    return torch.as_tensor(x).detach().cpu().clone()


def collectives(mesh):
    """The layout and the reductions on rank-dependent inputs."""
    size, rank = (mesh.size, mesh.rank) if mesh is not None else (1, 0)
    x = torch.arange(24 * 3, dtype=torch.float32).reshape(24, 3)
    out = {}
    for groups in (1, 2, 3):
        shard = pmesh.shard_samples(x, mesh, groups)
        out[f"shard{groups}"] = shard
        out[f"gather{groups}"] = pmesh.gather_samples(shard, mesh, groups)
    t = torch.arange(4 * 2, dtype=torch.float32).reshape(4, 2)
    out["gather_dim1"] = pmesh.gather_samples(pmesh.shard_samples(t, mesh, dim=1), mesh, dim=1)
    v = torch.tensor([1.0 + rank, -2.0 * rank, 3.0])
    out["sum"], out["max"] = pmesh.all_sum(mesh, v), pmesh.all_max(mesh, v)
    out["min"] = pmesh.all_min(mesh, v)
    a, b = pmesh.all_sum(mesh, v, 2 * v)
    out["sum_pair"] = torch.stack([a, b])
    rows = pmesh.shard_samples(x, mesh)
    out["sample_mean"] = pmesh.sample_mean(rows, mesh)
    out["sample_max"] = pmesh.sample_max(rows, mesh)
    out["sample_min"] = pmesh.sample_min(rows, mesh)
    out["replicate"] = pmesh.replicate(torch.full((2,), float(rank)), mesh)
    out["size"] = size
    return out


def demo_phases(mesh, obs, start, workdir):
    """log_prob, MAP (prior and given starts), SVI, HMC (ChEES with a mass
    switch, and two seed groups), SMC and a checkpointed ``fit`` rerun on
    the demo scene (``start`` (16, d))."""
    phys, cfg, prob = demo_scene(obs)
    seq = ModellingSequence(phys, prob, cfg, mesh=mesh, device="cpu")
    d = prob.prior.d
    start = torch.as_tensor(start)
    out = {}

    sim = seq._sim(start.shape[0])
    with torch.no_grad():
        lp, chi2 = prob.log_prob(sim, pmesh.shard_samples(start, seq.mesh))
    out["log_prob"] = pmesh.gather_samples(lp, seq.mesh)
    out["chi2"] = pmesh.gather_samples(chi2, seq.mesh)

    out["map"] = seq.MAP(adam(), n_samples=16, num_steps=5, seed=0)
    out["map_start"] = seq.MAP(adam(), start=start, n_samples=16, num_steps=5)
    out["best"] = seq.best_map_start(out["map_start"])

    q, losses = seq.SVI(start[:1], adam(), n_vi=16, num_steps=4, seed=1)
    out["svi"] = dict(losses=losses, mean=q.mean(), scale_tril=q.scale_tril)

    q_z = MultivariateNormalTriL(start[0], torch.eye(d) * 1e-3)
    res = seq.HMC(q_z, n_hmc=16, num_burnin_steps=25, num_results=4, max_leapfrog_steps=6,
                  seed=0)
    out["hmc"] = dict(samples=res.samples, accept=res.accept_rate, eps=res.step_size,
                      div=res.divergences, nlf=res.total_leapfrogs)
    res = seq.HMC(q_z, n_hmc=8, num_burnin_steps=25, num_results=3, init_l=2,
                  trajectory_adaptation="none", seeds=[0, 1])
    out["hmc_grouped"] = dict(samples=res.samples, accept=res.accept_rate, eps=res.step_size)

    res = seq.SMC(num_particles=16, num_ensembles=1, num_leapfrog_steps=2,
                  post_sampling_steps=2, max_stage=2, seed=0, segment_stages=1)
    out["smc"] = dict(particles=res.particles, beta=res.final_beta, log_z=res.log_evidence,
                      post=res.post_samples, scalings=res.log_scalings, stages=res.num_stages)

    ckpt = os.path.join(workdir, "ckpt")
    fit = dict(n_samples=8, map_steps=3, n_vi=8, vi_steps=3, n_hmc=4, num_burnin_steps=3,
               num_results=3, checkpoint_dir=ckpt)
    first = seq.fit(**fit)
    if seq.mesh.rank == 0:
        os.remove(os.path.join(ckpt, "hmc.npz"))  # the rerun loads MAP and SVI, runs HMC
    pmesh.barrier(seq.mesh)
    second = seq.fit(**fit)
    out["fit"] = [dict(z_map=r["z_map"], loc=r["q_z"].loc, tril=r["q_z"].scale_tril,
                       samples=r["hmc"].samples) for r in (first, second)]
    out["fit_files"] = sorted(os.listdir(ckpt))
    return {k: _tree(v) for k, v in out.items()}


def _tree(v):
    if isinstance(v, dict):
        return {k: _tree(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_tree(x) for x in v]
    if isinstance(v, torch.Tensor):
        return _np(v)
    return v


def survey_phases(mesh, obs):
    """tests/test_survey.py:212's pipeline (MAP, SVI, grouped HMC) and a
    short SMC from the MAP starts on the two-scene catalogue ``obs``."""
    phys, cfg = survey_scene()
    model = SurveyForwardProbModel(survey_prior(), obs, background_rms=BKG, exp_time=EXP_TIME,
                                   device="cpu")
    seq = SurveySequence(phys, model, cfg, mesh=mesh, device="cpu")
    z = seq.MAP(adam(), n_starts=8, num_steps=4, seed=0)
    best = seq.best_per_scene(z)
    means, trils, losses = seq.SVI(best, adam(), n_vi=8, num_steps=3, init_scales=1e-2, seed=1)
    r = seq.HMC(means, trils, n_hmc=8, num_burnin_steps=4, num_results=4, seed=2)
    smc = seq.SMC(start=z, num_particles=8, num_leapfrog_steps=1, post_sampling_steps=2,
                  max_stage=2, seed=3)
    return _tree(dict(z=z, best=best, means=means, trils=trils, losses=losses,
                      samples=r.samples, eps=r.step_size,
                      smc=dict(particles=smc.particles, beta=smc.final_beta,
                               post=smc.post_samples)))


def inversion_map(mesh, obs, kern, start):
    """tests/test_inversion.py:240: three MAP steps of the pixelated-source
    model from ``start`` (8, d)."""
    phys, cfg, model = inversion_scene(obs, kern)
    seq = ModellingSequence(phys, model, cfg, mesh=mesh, device="cpu")
    return _np(seq.MAP(adam(), start=torch.as_tensor(start), n_samples=8, num_steps=3))


def bench_main(mesh, cfg):
    """``gigalens_tpu_torch.bench.main`` at ``cfg`` on the CPU (under a
    process group, its phases take the world mesh): its exit code and what
    it printed."""
    import contextlib
    import io

    from gigalens_tpu_torch import bench

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(dict(cfg), device="cpu")
    return dict(rc=rc, stdout=buf.getvalue())


def few_rows_hmc(mesh, obs, start):
    """HMC on the demo scene with 4 chains (2 rows a rank on two ranks) from
    ``start`` (d,): tests/test_sharding.py:79-101's run (3 burn-in steps, 4
    results, seed 0)."""
    phys, cfg, prob = demo_scene(obs)
    seq = ModellingSequence(phys, prob, cfg, mesh=mesh, device="cpu")
    q_z = MultivariateNormalTriL(torch.as_tensor(start), torch.eye(prob.prior.d) * 1e-3)
    res = seq.HMC(q_z, n_hmc=4, num_burnin_steps=3, num_results=4, seed=0)
    return _tree(dict(samples=res.samples, eps=res.step_size, nlf=res.total_leapfrogs))


SCENARIOS = dict(collectives=collectives, demo=demo_phases, survey=survey_phases,
                 inversion=inversion_map, bench=bench_main, few_rows=few_rows_hmc)

# rows of the per-row checks: ROW_GLOBAL rows in one call against k rows a
# call (a scene, for the survey models, of ROW_SCENES scenes)
ROW_GLOBAL, ROW_SCENES = 48, 2
ROW_COUNTS = (1, 2, 4, 12, 24)


def row_models():
    """(name, prob model, phys, sim_config, scenes) of each prob model of
    the per-row checks: the demo scene scored on pixels and four image
    positions (ForwardProbModel), the same with both lights linear
    (BackwardProbModel), and the survey catalogue of two scenes with a
    sampled source (SurveyForwardProbModel) and a linear one
    (SurveyBackwardProbModel), and the pixelated-source model of
    :func:`inversion_scene` with a parametric lens light and a sampled
    lam (PixelatedSourceProbModel); observations drawn with numpy seeded
    7."""
    from gigalens_tpu_torch.model import BackwardProbModel, SurveyBackwardProbModel

    rng = np.random.default_rng(7)
    obs = rng.normal(1.0, 0.3, (20, 20)).astype(np.float32)
    phys, cfg, _ = demo_scene(obs)
    cx, cy = np.array([0.9, -0.8, 0.2, -0.3], np.float32), np.array([0.3, -0.2, 1.0, -0.9],
                                                                     np.float32)
    err = np.full(4, 0.05, np.float32)
    fwd = ForwardProbModel(demo_prior(), obs, background_rms=BKG, exp_time=EXP_TIME,
                           centroids_x=[cx], centroids_y=[cy], centroids_errors_x=[err],
                           centroids_errors_y=[err], device="cpu")
    lin = PhysicalModel([EPL(18), Shear()], [SersicEllipse(use_lstsq=True)],
                        [SersicEllipse(use_lstsq=True)])
    prior = demo_prior()
    lin_prior = Prior(dict(
        lens_mass=prior.tree["lens_mass"],
        lens_light=[{k: v for k, v in prior.tree["lens_light"][0].items() if k != "Ie"}],
        source_light=[{k: v for k, v in prior.tree["source_light"][0].items() if k != "Ie"}]))
    bwd = BackwardProbModel(lin_prior, obs, background_rms=BKG, exp_time=EXP_TIME, device="cpu")
    s_phys, s_cfg = survey_scene()
    s_obs = rng.normal(1.0, 0.3, (ROW_SCENES, 24, 24)).astype(np.float32)
    s_fwd = SurveyForwardProbModel(survey_prior(), s_obs, background_rms=BKG,
                                   exp_time=EXP_TIME, device="cpu")
    s_lin = PhysicalModel([SIE(), Shear()], [], [SersicEllipse(use_lstsq=True)])
    sp = survey_prior()
    s_lin_prior = Prior(dict(
        lens_mass=sp.tree["lens_mass"],
        source_light=[{k: v for k, v in sp.tree["source_light"][0].items() if k != "Ie"}]))
    s_bwd = SurveyBackwardProbModel(s_lin_prior, s_obs, background_rms=BKG, exp_time=EXP_TIME,
                                    device="cpu")
    from gigalens_tpu_torch.inversion import PixelatedSourceProbModel, SourceGrid

    i_phys, i_cfg, i_model = inversion_scene(obs, gaussian_psf())
    inv_prior = Prior(dict(lens_mass=i_model.prior.tree["lens_mass"],
                           lens_light=prior.tree["lens_light"],
                           source_pixelated=[dict(lam=dist.LogNormal(math.log(2.0), 0.3))]))
    inv = PixelatedSourceProbModel(inv_prior, obs, background_rms=0.3, exp_time=100.0,
                                   grid=SourceGrid(n_side=8, extent=0.5), device="cpu")
    inv_phys = PhysicalModel(i_phys.lenses, [SersicEllipse()], [])
    return [("forward", fwd, phys, cfg, 1), ("backward", bwd, lin, cfg, 1),
            ("survey_forward", s_fwd, s_phys, s_cfg, ROW_SCENES),
            ("survey_backward", s_bwd, s_lin, s_cfg, ROW_SCENES),
            ("inversion", inv, inv_phys, i_cfg, 1)]


def row_checks():
    """Each of :func:`row_models`' per-row log_prob and z-gradient at k
    rows (a scene) against the same rows in one call of ROW_GLOBAL rows:
    the k-row call on a simulator that is rank 0 and the last rank of a
    mesh of ROW_GLOBAL / k ranks (a ``Mesh`` with no process group: the
    layout only). Returns {model: {k: (max |log_prob diff|, max |grad
    diff|)}}."""
    from gigalens_tpu_torch.parallel import Mesh
    from gigalens_tpu_torch.simulator import LensSimulator

    out = {}
    for name, prob, phys, cfg, S in row_models():
        z = torch.as_tensor(np.random.default_rng(8).standard_normal(
            (ROW_GLOBAL, prob.prior.d)).astype(np.float32) * 0.3)
        K = ROW_GLOBAL // S

        def call(zz, mesh=None):
            sim = LensSimulator(phys, cfg, bs=zz.shape[0], device="cpu", mesh=mesh)
            zz = zz.clone().requires_grad_(True)
            lp = prob.log_prob(sim, zz)[0]
            (g,) = torch.autograd.grad(lp.sum(), zz)
            return lp.detach(), g

        def rows(t, k, r):
            return t.reshape(S, K, -1)[:, r * k:(r + 1) * k].reshape(S * k, -1).squeeze(-1)

        whole = call(z)
        out[name] = {}
        for k in ROW_COUNTS:
            if k >= K:
                continue
            errs = [0.0, 0.0]
            for r in (0, K // k - 1):
                mesh = Mesh("cpu")
                mesh.rank, mesh.size = r, K // k
                for i, (a, b) in enumerate(zip(call(rows(z, k, r), mesh), whole)):
                    errs[i] = max(errs[i], float((a.reshape(S * k, -1).squeeze(-1)
                                                  - rows(b, k, r)).abs().max()))
            out[name][k] = tuple(errs)
    return out


def run(mesh, jobs):
    """Runs ``jobs``, a list of ``(scenario name, args)``, on one thread
    (in every rank, and in-process, so both sides reduce alike); returns
    their results in order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return [SCENARIOS[name](mesh, *args) for name, args in jobs]
    finally:
        torch.set_num_threads(threads)


def bench_failing_rank(argv):
    """``gigalens_tpu_torch.bench``'s command line under ``torchrun`` with
    the MAP phase raising on rank 1 only: the job must end, nonzero."""
    from gigalens_tpu_torch import bench

    def phase_map(self):
        raise RuntimeError("injected failure")

    if int(os.environ["RANK"]) == 1:
        bench.Pipeline.phase_map = phase_map
    return bench._cli(argv)


if __name__ == "__main__":
    import json
    import sys

    torch.set_num_threads(1)
    if sys.argv[1:] == ["rows"]:
        print(json.dumps(row_checks()))
        sys.exit(0)
    sys.exit(bench_failing_rank(sys.argv[1:]))
