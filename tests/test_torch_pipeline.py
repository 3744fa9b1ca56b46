"""The port's one-call pipeline and its bench module (CPU).

``ModellingSequence.fit()`` at the tiny size of
``tests/test_inference.py::test_fit_one_call_pipeline`` (finite samples, the
phase times, a summary, per-phase progress), ``checkpoint_dir`` loading
the JAX package's phase files, and ``gigalens_tpu_torch.bench`` at a micro
configuration: the JSON line carries the JAX bench's keys less
``aot``/``mfu``/``peak_*``, and a failed phase gives ``complete: false``
and a nonzero exit.
"""
import json

import numpy as np
import pytest
import torch

from gigalens_tpu_torch import bench
from gigalens_tpu_torch.inference import ModellingSequence
from gigalens_tpu_torch.interop import (
    phys_model_from_reference, prior_from_reference, sim_config_from_reference,
)
from gigalens_tpu_torch.model import ForwardProbModel

MICRO = dict(num_pix=20, map_n=8, map_steps=5, vi_n=8, vi_steps=5, hmc_n=4, burnin=12,
             results=10, hmc_seeds=[2], scale="micro")
# bench.py's JSON keys on a complete run, less aot, mfu, peak_flops and
# peak_bytes_per_s
KEYS = {"metric", "value", "unit", "vs_baseline", "phase_s", "seeds", "scale", "device",
        "best_map_red_chi2", "laplace_s", "ess_per_sec", "ess_per_sec_median",
        "hmc_grouped", "hmc_wall_all_seeds", "min_ess", "max_rhat", "accept_rate",
        "posterior_red_chi2", "complete"}
SEED_KEYS = {"seed", "t", "min_ess", "ess_per_sec", "max_rhat", "accept", "eps", "leapfrogs"}


@pytest.fixture(scope="module")
def seq(demo_prior, demo_physmodel, small_sim_config):
    pm = ForwardProbModel(prior_from_reference(demo_prior), np.zeros((20, 20), np.float32),
                          background_rms=0.1, exp_time=100, device="cpu")
    return ModellingSequence(phys_model_from_reference(demo_physmodel), pm,
                             sim_config_from_reference(small_sim_config), device="cpu")


@pytest.mark.quick
def test_fit_one_call_pipeline(seq, demo_prior):
    calls = []
    out = seq.fit(n_samples=8, map_steps=10, n_vi=8, vi_steps=10, n_hmc=4,
                  num_burnin_steps=8, num_results=12, seed=0,
                  progress=lambda phase, step, value: calls.append((phase, step)))
    samples = out["hmc"].samples
    assert samples.shape == (12, 4, demo_prior.d) and torch.isfinite(samples).all()
    assert set(out["times"]) == {"map", "svi", "hmc"}
    assert all(t > 0 for t in out["times"].values())
    assert out["best"].shape == (1, demo_prior.d) and out["losses"].shape == (10,)
    assert out["q_z"].scale_tril.shape == (demo_prior.d, demo_prior.d)
    summary = out["summary"]
    assert "lens_mass/0/theta_E" in summary and "max_rhat" in summary["_global"]
    # one report per phase (one segment each), MAP -> SVI -> HMC
    assert calls == [("map", 10), ("svi", 10), ("hmc", 20)]


def test_fit_checkpoint_dir_names_m19(seq, demo_prior, tmp_path):
    """``checkpoint_dir`` (M19, ported): a directory holding all three
    phases, written by the JAX package, is loaded and no phase runs."""
    import jax.numpy as jnp

    from gigalens_tpu.inference.hmc import HMCResult as JHMCResult
    from gigalens_tpu.prob.distributions import MultivariateNormalTriL as JMVN
    from gigalens_tpu.utils import checkpoint as jckpt

    d = demo_prior.d
    rng = np.random.default_rng(5)
    z = rng.normal(0, 0.1, (8, d)).astype(np.float32)
    samples = rng.normal(0, 0.1, (6, 4, d)).astype(np.float32)
    jckpt.save_map(str(tmp_path / "map.npz"), jnp.asarray(z))
    jckpt.save_svi(str(tmp_path / "svi.npz"), JMVN(jnp.zeros(d), 0.1 * jnp.eye(d)),
                   jnp.arange(3.0))
    jckpt.save_hmc(str(tmp_path / "hmc.npz"), JHMCResult(
        jnp.asarray(samples), jnp.ones(7), jnp.float32(0.1), jnp.asarray(samples[-1])))
    calls = []
    out = seq.fit(checkpoint_dir=str(tmp_path), n_samples=8,
                  progress=lambda phase, step, value: calls.append(phase))
    assert calls == []
    np.testing.assert_array_equal(out["z_map"].numpy(), z)
    np.testing.assert_array_equal(out["hmc"].samples.numpy(), samples)
    np.testing.assert_array_equal(out["losses"].numpy(), [0.0, 1.0, 2.0])
    assert out["best"].shape == (1, d) and "max_rhat" in out["summary"]["_global"]


def test_bench_json_line_and_exit_code(capsys):
    assert bench.main(dict(MICRO), device="cpu") == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    r = json.loads(line)
    assert set(r) == KEYS, set(r) ^ KEYS
    assert r["complete"] is True and r["metric"] == "map_svi_hmc_wallclock"
    assert set(r["phase_s"]) == {"map", "svi", "hmc"}
    assert len(r["seeds"]) == 1 and set(r["seeds"][0]) == SEED_KEYS
    assert r["value"] == pytest.approx(sum(r["phase_s"].values()), abs=0.02)
    assert np.isfinite(r["max_rhat"]) and r["device"] == "cpu"


def test_bench_smc_block(capsys):
    """--smc adds an smc block (the tiny SMC recipe on the micro scene)
    and leaves every other key and the value's meaning as they were."""
    assert bench.main(dict(MICRO, scale="tiny"), device="cpu", smc=True) == 0
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(r) == KEYS | {"smc"}, set(r) ^ KEYS
    assert r["value"] == pytest.approx(sum(r["phase_s"].values()), abs=0.02)
    smc = r["smc"]
    tiny = bench.SMC_CONFIGS["tiny"]
    assert {k: smc[k] for k in tiny} == tiny
    assert 1 <= smc["stages"] <= tiny["max_stage"]
    assert smc["leapfrogs"] == (smc["moves"] + tiny["post_steps"]) * tiny["leapfrog_steps"]
    assert smc["moves"] >= smc["stages"]
    assert 0 < smc["tempering_s"] <= smc["wall_s"] and smc["post_s"] >= 0
    assert len(smc["log_evidence"]) == len(smc["final_beta"]) == 1
    assert np.isfinite(smc["log_evidence"][0]) and 0 < smc["final_beta"][0] <= 1
    assert np.isfinite(smc["posterior_red_chi2"])


def test_bench_failed_phase_is_incomplete_and_nonzero(capsys, monkeypatch):
    def boom(self):
        raise RuntimeError("injected")

    monkeypatch.setattr(bench.Pipeline, "phase_svi", boom)
    assert bench.main(dict(MICRO), device="cpu") == 1
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert r["complete"] is False
    assert [f["phase"] for f in r["failed_phases"]] == ["svi"]
    assert "injected" in r["failed_phases"][0]["error"]
    assert r["value"] == r["phase_s"]["map"]  # the completed phases' walls


def test_bench_needs_cuda_unless_the_cpu_is_asked_for(capsys, monkeypatch):
    """No silent CPU fallback: without a CUDA device the default run fails
    in set-up, prints an incomplete line with no value and exits nonzero."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run_pipeline(dict(MICRO))
    assert bench._cli([]) == 1
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert r["complete"] is False and r["value"] is None and "device" not in r
    assert [f["phase"] for f in r["failed_phases"]] == ["setup"]
    assert "no CUDA device" in r["failed_phases"][0]["error"]


def test_bench_config_knobs(monkeypatch):
    monkeypatch.setenv("GIGALENS_BENCH_SCALE", "tiny")
    monkeypatch.setenv("GIGALENS_BENCH_SVI_STEPS", "7")
    monkeypatch.setenv("GIGALENS_BENCH_HMC_SEEDS", "5,6")
    monkeypatch.setenv("GIGALENS_EPL_NITER", "11")
    cfg = bench.config_from_env()
    assert cfg["scale"] == "tiny" and cfg["vi_steps"] == 7 and cfg["hmc_seeds"] == [5, 6]
    assert cfg["map_n"] == bench.CONFIGS["tiny"]["map_n"]
    assert bench.bench_scene(20)[2] == 11
    monkeypatch.delenv("GIGALENS_EPL_NITER")
    assert bench.CONFIGS["full"] == dict(num_pix=80, map_n=500, map_steps=350, vi_n=1000,
                                         vi_steps=300, hmc_n=50, burnin=250, results=750,
                                         hmc_seeds=[2, 3, 4])
