"""End-to-end pipeline benchmark of the port: MAP -> Laplace -> SVI -> HMC wall.

    python3 -m gigalens_tpu_torch.bench

The scene, prior and phase configurations of the JAX package's ``bench.py``:
EPL+Shear lens, SersicEllipse lens light and source, 80x80 px at 0.065"/px,
supersample 2, the 25x25 Gaussian PSF, background_rms 0.2, exp_time 100.
The truth is a prior draw from a ``torch.Generator`` seeded 42 and the
noise is drawn from one seeded 1, both on the device. Phases: multi-start
MAP (500 x 350 steps), FD Laplace + full-rank SVI (n_vi 1000 x 300 steps),
then serial HMC seeds 2, 3, 4 (50 chains, 250 burn-in + 750 results,
ChEES), then the posterior red-chi2 of the last draw.

With ``--smc`` the run adds adaptive-tempering SMC on the same scene
(``scripts/bench_smc.py``'s recipe: 1000 particles x 1 ensemble, 3-leapfrog
preconditioned moves, ESS threshold 0.6, up to 200 stages, 100 post steps,
seed 1, prior start, pixels target) and an ``smc`` block in the JSON line;
the default run's keys and ``value`` are unchanged.

Knobs: ``GIGALENS_BENCH_SCALE`` (tiny | small | full), ``GIGALENS_BENCH_SVI_STEPS``,
``GIGALENS_BENCH_HMC_SEEDS`` (comma-separated), ``GIGALENS_EPL_NITER``,
``GIGALENS_LAPLACE_METHOD`` (fd | exact), ``GIGALENS_BASELINE_S``.

It runs on the CUDA device and fails when there is none; ``--device cpu``
runs it on the CPU instead.

Under ``torchrun --nproc-per-node N -m gigalens_tpu_torch.bench`` every
process drives its own card (``cuda:LOCAL_RANK``) in one ``nccl`` process
group (``gloo`` with ``--device cpu``), and every phase shards its samples
over the group (:mod:`gigalens_tpu_torch.parallel`), as the JAX bench takes
all devices; only rank 0 logs and prints the JSON line, which then also
carries ``ranks``. A phase that fails on any rank prints that rank's
traceback, tagged with its rank, and ends the job with a nonzero exit
(the other ranks would wait in its collectives): no JSON line then.

Prints ONE JSON line with the keys of the JAX bench (``metric``, ``value``,
``phase_s``, ``seeds``, ``min_ess``, ``max_rhat``, ...), without its
``aot``, ``mfu`` and ``peak_*`` blocks. Each phase runs isolated: a failure
is recorded in ``failed_phases`` with ``complete: false`` and the process
exits nonzero. :func:`run_pipeline` is the same pipeline with no isolation.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

CONFIGS = {
    "tiny": dict(num_pix=40, map_n=32, map_steps=30, vi_n=32, vi_steps=30,
                 hmc_n=8, burnin=20, results=30, hmc_seeds=[2]),
    "small": dict(num_pix=80, map_n=100, map_steps=100, vi_n=100, vi_steps=150,
                  hmc_n=16, burnin=50, results=100, hmc_seeds=[2]),
    "full": dict(num_pix=80, map_n=500, map_steps=350, vi_n=1000, vi_steps=300,
                 hmc_n=50, burnin=250, results=750, hmc_seeds=[2, 3, 4]),
}
# the SMC recipe of scripts/bench_smc.py at each scale
SMC_CONFIGS = {
    "tiny": dict(particles=16, ensembles=1, leapfrog_steps=3, ess_threshold_ratio=0.6,
                 post_steps=4, max_stage=3, seed=1),
    "small": dict(particles=200, ensembles=1, leapfrog_steps=3, ess_threshold_ratio=0.6,
                  post_steps=20, max_stage=200, seed=1),
    "full": dict(particles=1000, ensembles=1, leapfrog_steps=3, ess_threshold_ratio=0.6,
                 post_steps=100, max_stage=200, seed=1),
}
DELTA_PIX, SUPERSAMPLE, BKG, EXP_TIME = 0.065, 2, 0.2, 100.0


def _grouped():
    return dist.is_available() and dist.is_initialized()


def _rank():
    return dist.get_rank() if _grouped() else 0


def log(msg):
    if _rank() == 0:
        print(msg, file=sys.stderr, flush=True)


def log_failure(msg):
    """A failure, on every rank, tagged with the rank under a process group."""
    if _grouped():
        msg = f"[rank {dist.get_rank()} of {dist.get_world_size()}] {msg}"
    print(msg, file=sys.stderr, flush=True)


def config_from_env():
    """The configuration ``GIGALENS_BENCH_SCALE`` names, with the step and
    seed overrides applied."""
    scale = os.environ.get("GIGALENS_BENCH_SCALE", "full")
    cfg = dict(CONFIGS[scale], scale=scale)
    if os.environ.get("GIGALENS_BENCH_SVI_STEPS"):
        cfg["vi_steps"] = int(os.environ["GIGALENS_BENCH_SVI_STEPS"])
    if os.environ.get("GIGALENS_BENCH_HMC_SEEDS"):
        cfg["hmc_seeds"] = [int(s) for s in os.environ["GIGALENS_BENCH_HMC_SEEDS"].split(",")]
    return cfg


def bench_prior():
    from gigalens_tpu_torch.prob import Prior
    from gigalens_tpu_torch.prob import distributions as d

    return Prior(dict(
        lens_mass=[
            dict(theta_E=d.LogNormal(math.log(1.25), 0.25),
                 gamma=d.TruncatedNormal(2, 0.25, 1, 3),
                 e1=d.Normal(0, 0.1), e2=d.Normal(0, 0.1),
                 center_x=d.Normal(0, 0.05), center_y=d.Normal(0, 0.05)),
            dict(gamma1=d.Normal(0, 0.05), gamma2=d.Normal(0, 0.05)),
        ],
        lens_light=[
            dict(R_sersic=d.LogNormal(math.log(1.0), 0.15), n_sersic=d.Uniform(2, 6),
                 e1=d.TruncatedNormal(0, 0.1, -0.3, 0.3),
                 e2=d.TruncatedNormal(0, 0.1, -0.3, 0.3),
                 center_x=d.Normal(0, 0.05), center_y=d.Normal(0, 0.05),
                 Ie=d.LogNormal(math.log(500.0), 0.3)),
        ],
        source_light=[
            dict(R_sersic=d.LogNormal(math.log(0.25), 0.15), n_sersic=d.Uniform(0.5, 4),
                 e1=d.TruncatedNormal(0, 0.15, -0.5, 0.5),
                 e2=d.TruncatedNormal(0, 0.15, -0.5, 0.5),
                 center_x=d.Normal(0, 0.25), center_y=d.Normal(0, 0.25),
                 Ie=d.LogNormal(math.log(150.0), 0.5)),
        ],
    ))


def gaussian_psf():
    """The JAX bench's 25x25 Gaussian fallback PSF."""
    g = np.exp(-((np.arange(25) - 12) ** 2 + (np.arange(25)[:, None] - 12) ** 2) / 8.0)
    return (g / g.sum()).astype(np.float32)


def epl_niter():
    """Series depth: ``GIGALENS_EPL_NITER``, else the convergence bound for
    the prior's axis ratios (q >= 0.43 at 4 sigma, tol 1e-8)."""
    from gigalens_tpu_torch.profiles.mass import EPL

    return int(os.environ.get("GIGALENS_EPL_NITER", 0)) or EPL.recommended_niter(
        q_min=0.43, tol=1e-8)


def bench_scene(num_pix=80, niter=None):
    """(phys, sim_config, niter) of the bench scene."""
    from gigalens_tpu_torch import PhysicalModel, SimulatorConfig
    from gigalens_tpu_torch.profiles.light import SersicEllipse
    from gigalens_tpu_torch.profiles.mass import EPL, Shear

    niter = niter or epl_niter()
    phys = PhysicalModel([EPL(niter), Shear()], [SersicEllipse()], [SersicEllipse()])
    cfg = SimulatorConfig(delta_pix=DELTA_PIX, num_pix=num_pix, supersample=SUPERSAMPLE,
                          kernel=gaussian_psf())
    return phys, cfg, niter


def survey_psfs(n_scenes):
    """Distinct per-scene PSFs (``scripts/bench_survey_production.py:61-81``
    with its fallback base, as the reference's ``psf.npy`` is not in the
    repo): a 13x13 Gaussian rotated by k * 90 degrees and smoothed by a
    scene-dependent Gaussian of sigma 0.5 + 0.35 k native pixels."""
    g = np.exp(-((np.arange(13) - 6) ** 2 + (np.arange(13)[:, None] - 6) ** 2) / 5.0)
    base = (g / g.sum()).astype(np.float32)
    out = []
    for s in range(n_scenes):
        k = np.rot90(base, k=s % 4).copy()
        sig = 0.5 + 0.35 * s
        xx = np.arange(-3, 4)
        g1 = np.exp(-(xx**2) / (2 * sig**2))
        g1 /= g1.sum()
        k = np.apply_along_axis(lambda r: np.convolve(r, g1, mode="same"), 0, k)
        k = np.apply_along_axis(lambda r: np.convolve(r, g1, mode="same"), 1, k)
        out.append((k / k.sum()).astype(np.float32))
    return np.stack(out)


def survey_scene(n_scenes, num_pix=60, supersample=SUPERSAMPLE, device="cuda"):
    """``scripts/bench_survey_production.py``'s catalogue: (prior, phys,
    sim_config, observations (S, H, W) numpy). The bench prior and the
    EPL(niter)+Shear, SersicEllipse lens light and source model at 0.065"
    with :func:`survey_psfs`; the truths are S prior draws from a
    ``torch.Generator`` seeded 42 on ``device``, rendered by the port, and
    observed at background_rms 0.2 / exp_time 100 with numpy noise seeded 1."""
    from gigalens_tpu_torch import PhysicalModel, SimulatorConfig
    from gigalens_tpu_torch.profiles.light import SersicEllipse
    from gigalens_tpu_torch.profiles.mass import EPL, Shear
    from gigalens_tpu_torch.simulator import LensSimulator

    prior = bench_prior()
    phys = PhysicalModel([EPL(epl_niter()), Shear()], [SersicEllipse()], [SersicEllipse()])
    cfg = SimulatorConfig(delta_pix=DELTA_PIX, num_pix=num_pix, supersample=supersample,
                          kernel=survey_psfs(n_scenes))
    truths = prior.sample(torch.Generator(device=device).manual_seed(42), n_scenes)
    with torch.no_grad():
        imgs = LensSimulator(phys, cfg, bs=n_scenes, device=device).simulate(truths)
    imgs = imgs.reshape(n_scenes, num_pix, num_pix).cpu().numpy()
    noise = np.random.default_rng(1).normal(size=imgs.shape).astype(np.float32)
    obs = imgs + noise * np.sqrt(BKG**2 + np.clip(imgs, 0, None) / EXP_TIME)
    return prior, phys, cfg, obs.astype(np.float32)


def observe(img, gen, bkg=BKG, exp_time=EXP_TIME):
    """Gaussian + Poisson noise at the bench's background and exposure."""
    return img + torch.randn(img.shape, generator=gen, device=img.device) * torch.sqrt(
        bkg**2 + torch.clamp(img, min=0.0) / exp_time)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _nanmin(x):
    return float(torch.where(torch.isnan(x), torch.inf, x).min())


def new_result(cfg, device_name=None):
    """The JSON line's dict before any phase has run."""
    result = {"metric": "map_svi_hmc_wallclock", "value": None, "unit": "s",
              "vs_baseline": None, "phase_s": {}, "seeds": [], "scale": cfg.get("scale")}
    if device_name is not None:
        result["device"] = device_name
    return result


class Pipeline:
    """The bench pipeline's state and phases, in order: :meth:`phase_map`,
    :meth:`phase_svi`, :meth:`phase_hmc`, :meth:`phase_posterior_chi2`.
    Each fills ``self.result`` (the JSON line's dict) as it completes.

    ``phase_hook(name)``, if given, returns a context manager entered around
    each measured piece: ``map``, ``laplace``, ``svi``, ``hmc`` (once per
    seed), ``posterior_chi2`` and ``smc``.
    """

    def __init__(self, cfg, hmc_seeds=None, device="cuda", phase_hook=None):
        from gigalens_tpu_torch.inference import ModellingSequence
        from gigalens_tpu_torch.model import ForwardProbModel
        from gigalens_tpu_torch.simulator import LensSimulator

        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device (pass device='cpu', or --device cpu, "
                               "to run on the CPU)")
        self.cfg = cfg
        self.hmc_seeds = list(cfg["hmc_seeds"] if hmc_seeds is None else hmc_seeds)
        self.hook = phase_hook or (lambda name: contextlib.nullcontext())
        self.phys, self.sim_config, self.niter = bench_scene(cfg["num_pix"])
        self.prior = bench_prior()
        log(f"device: {self.device}  scale={cfg.get('scale')}  EPL niter={self.niter}")

        self.truth = truth = self.prior.sample(
            torch.Generator(device=self.device).manual_seed(42), 1)
        sim1 = LensSimulator(self.phys, self.sim_config, bs=1, device=self.device)
        with torch.no_grad():
            img = sim1.simulate(truth)
        obs = observe(img, torch.Generator(device=self.device).manual_seed(1))
        self.prob_model = ForwardProbModel(self.prior, obs.cpu().numpy(), background_rms=BKG,
                                           exp_time=EXP_TIME, device=self.device)
        self.seq = ModellingSequence(self.phys, self.prob_model, self.sim_config,
                                     device=self.device)
        self.result = new_result(cfg, torch.cuda.get_device_name(self.device)
                                 if self.device.type == "cuda" else "cpu")
        if self.seq.mesh.group is not None:
            self.result["ranks"] = self.seq.mesh.size

    def _score(self, z):
        """(log_prob, reduced chi2) of ``z`` on the fast simulator."""
        from gigalens_tpu_torch.simulator import LensSimulator

        sim = LensSimulator(self.phys, self.sim_config, bs=z.shape[0], device=self.device)
        with torch.no_grad():
            return self.prob_model.log_prob(sim, z)

    def phase_map(self):
        from gigalens_tpu_torch.inference.sequence import map_optimizer

        cfg = self.cfg
        with self.hook("map"):
            t0 = time.perf_counter()
            z_map = self.seq.MAP(map_optimizer(cfg["map_steps"]), n_samples=cfg["map_n"],
                                 num_steps=cfg["map_steps"], seed=0)
            _sync(self.device)
            self.t_map = time.perf_counter() - t0
        lps, chi2 = self._score(z_map)
        self.z_map, self.lps = z_map, lps
        self.best_chi2 = _nanmin(chi2)
        log(f"MAP: {self.t_map:.1f}s best red-chi2 {self.best_chi2:.3f}")
        self.result["phase_s"]["map"] = round(self.t_map, 2)
        self.result["best_map_red_chi2"] = round(self.best_chi2, 4)

    def phase_svi(self):
        """FD Laplace at the best MAP point, then SVI; the Laplace wall is
        counted inside the SVI phase's, as in the JAX bench."""
        from gigalens_tpu_torch.inference.sequence import svi_optimizer

        cfg = self.cfg
        t0 = time.perf_counter()
        with self.hook("laplace"):
            lps = torch.where(torch.isnan(self.lps), -torch.inf, self.lps)
            best = self.z_map[torch.argmax(lps)][None, :]
            method = os.environ.get("GIGALENS_LAPLACE_METHOD", "fd")
            L0 = self.seq.laplace_scale_tril(best, method=method)
            self.t_laplace = time.perf_counter() - t0
        log(f"laplace init ({method}): {self.t_laplace:.1f}s")
        with self.hook("svi"):
            self.q_z, self.losses = self.seq.SVI(best, svi_optimizer(cfg["vi_steps"]),
                                                 n_vi=cfg["vi_n"],
                                                 num_steps=cfg["vi_steps"], init_scales=L0,
                                                 seed=1)
            _sync(self.device)
            self.t_svi = time.perf_counter() - t0
        self.elbo = (float(self.losses[0]), float(self.losses[-1]))
        log(f"SVI: {self.t_svi:.1f}s elbo {self.elbo[0]:.1f} -> {self.elbo[1]:.1f}")
        self.result["phase_s"]["svi"] = round(self.t_svi, 2)
        self.result["laplace_s"] = round(self.t_laplace, 2)

    def phase_hmc(self):
        """Serial HMC seeds; the headline quality is the last seed's."""
        from gigalens_tpu_torch.utils import effective_sample_size, potential_scale_reduction

        cfg = self.cfg
        rows = []
        for seed in self.hmc_seeds:
            with self.hook("hmc"):
                t0 = time.perf_counter()
                res = self.seq.HMC(self.q_z, n_hmc=cfg["hmc_n"], num_burnin_steps=cfg["burnin"],
                                   num_results=cfg["results"], seed=seed)
                _sync(self.device)
                t_hmc = time.perf_counter() - t0
            ess = effective_sample_size(res.samples)
            rhat = potential_scale_reduction(res.samples)
            accept = float(res.accept_rate[-100:].mean())
            eps, nlf = float(res.step_size), int(res.total_leapfrogs)
            rows.append(dict(seed=seed, t=t_hmc, min_ess=float(ess.min()),
                             ess_per_sec=float(ess.min()) / t_hmc, max_rhat=float(rhat.max()),
                             accept=accept, eps=eps, leapfrogs=nlf))
            log(f"HMC seed {seed}: {t_hmc:.1f}s accept {accept:.2f} eps {eps:.4f} "
                f"min ESS {ess.min():.0f} max rhat {rhat.max():.3f} leapfrogs {nlf} "
                f"({t_hmc / max(nlf, 1) * 1e3:.2f} ms/lf)")
        self.hmc_res, self.seed_rows = res, rows
        self.ess, self.rhat = ess, rhat
        t_med = float(np.median([r["t"] for r in rows]))
        self.result.update({
            "value": round(self.t_map + self.t_svi + t_med, 2),
            "ess_per_sec": round(float(ess.min()) / rows[-1]["t"], 2),
            "ess_per_sec_median": round(float(np.median([r["ess_per_sec"] for r in rows])), 2),
            "seeds": [{k: (round(v, 4) if isinstance(v, float) else v) for k, v in r.items()}
                      for r in rows],
            "hmc_grouped": False,
            "hmc_wall_all_seeds": round(float(np.sum([r["t"] for r in rows])), 2),
            "min_ess": round(float(ess.min()), 1),
            "max_rhat": round(float(rhat.max()), 4),
            "accept_rate": round(rows[-1]["accept"], 3),
        })
        self.result["phase_s"]["hmc"] = round(t_med, 2)

    def phase_posterior_chi2(self):
        """Mean reduced chi2 over the chains' last draw (fast simulator)."""
        with self.hook("posterior_chi2"):
            _, chi2 = self._score(self.hmc_res.samples[-1])
            self.post_chi2 = float(torch.mean(chi2))
        log(f"posterior mean red-chi2 {self.post_chi2:.3f}")
        self.result["posterior_red_chi2"] = round(self.post_chi2, 4)

    def phase_smc(self):
        """Adaptive-tempering SMC from the prior on the exact simulator
        (``SMC_CONFIGS`` of the configuration's scale); fills the
        ``smc`` block: walls (tempering and post chain on the host clock),
        stages, moves, leapfrogs, log-evidence, final beta and the mean
        reduced chi2 of the post chain's last draw (of the particles when
        there is no post chain)."""
        c = SMC_CONFIGS[self.cfg["scale"]]
        with self.hook("smc"):
            t0 = time.perf_counter()
            res = self.seq.SMC(num_particles=c["particles"], num_ensembles=c["ensembles"],
                               num_leapfrog_steps=c["leapfrog_steps"],
                               post_sampling_steps=c["post_steps"],
                               ess_threshold_ratio=c["ess_threshold_ratio"],
                               max_stage=c["max_stage"], seed=c["seed"])
            _sync(self.device)
            wall = time.perf_counter() - t0
        last = (res.post_samples[-1] if c["post_steps"] > 0
                else res.particles.reshape(-1, self.prior.d))
        _, chi2 = self._score(last)
        self.smc_res = res
        leapfrogs = (res.num_moves + c["post_steps"]) * c["leapfrog_steps"]
        block = dict(c, wall_s=round(wall, 3), tempering_s=round(res.tempering_s, 3),
                     post_s=round(wall - res.tempering_s, 3), stages=res.num_stages,
                     moves=res.num_moves, leapfrogs=leapfrogs,
                     ms_per_leapfrog=round(1e3 * wall / max(leapfrogs, 1), 3),
                     log_evidence=[round(float(v), 4) for v in res.log_evidence],
                     final_beta=[float(b) for b in res.final_beta],
                     posterior_red_chi2=round(float(torch.mean(chi2)), 4))
        log(f"SMC: {wall:.1f}s ({res.tempering_s:.1f}s tempering) stages {res.num_stages} "
            f"leapfrogs {leapfrogs} logZ {block['log_evidence']} "
            f"posterior red-chi2 {block['posterior_red_chi2']}")
        self.result["smc"] = block

    def phases(self, smc=False):
        out = [("map", self.phase_map), ("svi", self.phase_svi), ("hmc", self.phase_hmc),
               ("posterior_chi2", self.phase_posterior_chi2)]
        return out + [("smc", self.phase_smc)] if smc else out


def finish(result, failures=()):
    """Marks completeness, fills a partial total and ``vs_baseline``."""
    if failures:
        result["failed_phases"] = list(failures)
    result["complete"] = not failures
    if result["value"] is None and result["phase_s"]:
        # honest partial total: the completed phases' walls
        result["value"] = round(sum(result["phase_s"].values()), 2)
    baseline_s = os.environ.get("GIGALENS_BASELINE_S")
    if baseline_s and result["value"]:
        result["vs_baseline"] = float(baseline_s) / result["value"]
    return result


def run_pipeline(cfg, hmc_seeds=None, device="cuda", phase_hook=None) -> Pipeline:
    """Runs every phase in order with no isolation (a failure raises) and
    returns the :class:`Pipeline`; its ``result`` is the JSON line's dict."""
    pipe = Pipeline(cfg, hmc_seeds, device=device, phase_hook=phase_hook)
    for _, phase in pipe.phases():
        phase()
    finish(pipe.result)
    return pipe


def main(cfg=None, device="cuda", smc=False) -> int:
    """Runs the pipeline (and SMC when ``smc``) with each phase isolated,
    prints the JSON line, and returns 0 only if every phase completed.
    Under a process group a failed phase raises instead, after its
    traceback: the other ranks cannot go on without this one."""
    cfg = cfg or config_from_env()
    failures = []
    result = new_result(cfg)
    try:
        pipe = Pipeline(cfg, device=device)
        result = pipe.result
        for name, phase in pipe.phases(smc):
            try:
                phase()
            except Exception as e:
                log_failure(f"PHASE {name} FAILED:\n{traceback.format_exc(limit=8)}")
                failures.append(dict(phase=name, path="primary",
                                     error=f"{type(e).__name__}: {str(e)[:500]}"))
                break  # every later phase needs this one's output
    except Exception as e:
        log_failure(traceback.format_exc())
        failures.append(dict(phase="setup", path="primary",
                             error=f"{type(e).__name__}: {str(e)[:500]}"))
    if failures and _grouped():
        # the other ranks wait in this phase's collectives for this rank:
        # end it, and with it the job (torchrun stops the other ranks)
        raise RuntimeError(f"rank {dist.get_rank()}: phase {failures[0]['phase']} failed "
                           f"({failures[0]['error']})")
    finish(result, failures)
    if _rank() == 0:
        print(json.dumps(result), flush=True)
    return 0 if result["complete"] else 1


def _cli(argv):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--smc", action="store_true",
                    help="also run SMC and add its block to the JSON line")
    args = ap.parse_args(argv)
    if "RANK" not in os.environ:
        return main(device=args.device, smc=args.smc)
    # under torchrun: one process a device, every phase's samples sharded
    # over the world group (ModellingSequence's default mesh)
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    try:
        return main(device=device, smc=args.smc)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(_cli(sys.argv[1:]))
