"""The port's phase checkpointing and profiling helpers (CPU).

Checkpoint files cross both ways with the JAX package's
``gigalens_tpu.utils.checkpoint`` (the same ``.npz`` keys): JAX writes and
the port loads its own types, the port writes and JAX loads; the
fallbacks for older files; ``PipelineCheckpointer`` skipping saved
phases; ``ModellingSequence.fit(checkpoint_dir=...)`` interrupted in its
HMC phase and rerun equals an uninterrupted run exactly. Then ``timed``,
``PhaseTimer`` and ``trace`` (a Chrome trace under the test's directory).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gigalens_tpu.inference.hmc import HMCResult as JHMCResult
from gigalens_tpu.inference.smc import SMCResult as JSMCResult
from gigalens_tpu.prob.distributions import MultivariateNormalTriL as JMVN
from gigalens_tpu.utils import checkpoint as jckpt
from gigalens_tpu_torch.inference import ModellingSequence
from gigalens_tpu_torch.inference.hmc import HMCResult
from gigalens_tpu_torch.inference.smc import SMCResult
from gigalens_tpu_torch.interop import (
    phys_model_from_reference, prior_from_reference, sim_config_from_reference,
)
from gigalens_tpu_torch.model import ForwardProbModel
from gigalens_tpu_torch.prob.distributions import MultivariateNormalTriL
from gigalens_tpu_torch.utils import PhaseTimer, PipelineCheckpointer, timed, trace
from gigalens_tpu_torch.utils import checkpoint as ckpt

RNG = np.random.default_rng(11)


def _f32(*shape):
    return RNG.normal(size=shape).astype(np.float32)


ARRAYS = dict(z=_f32(6, 3), hist=_f32(5), loc=_f32(3), tril=np.tril(_f32(3, 3)),
              losses=_f32(4), samples=_f32(5, 2, 3), accept=_f32(7), final=_f32(2, 3),
              particles=_f32(8, 2, 3), scal=_f32(8, 2), post=_f32(4, 16, 3),
              beta=np.ones(2, np.float32), lz=np.array([-3.5, -3.6], np.float32))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy() if isinstance(got, torch.Tensor)
                                  else np.asarray(got), want)


@pytest.mark.quick
def test_jax_files_load_in_the_port(tmp_path):
    a = ARRAYS
    p = {k: str(tmp_path / f"{k}.npz") for k in ("map", "svi", "hmc", "smc")}
    jckpt.save_map(p["map"], jnp.asarray(a["z"]), jnp.asarray(a["hist"]))
    jckpt.save_svi(p["svi"], JMVN(jnp.asarray(a["loc"]), jnp.asarray(a["tril"])),
                   jnp.asarray(a["losses"]))
    jckpt.save_hmc(p["hmc"], JHMCResult(
        jnp.asarray(a["samples"]), jnp.asarray(a["accept"]), jnp.float32(0.1),
        jnp.asarray(a["final"]), jnp.float32(1.5), jnp.asarray([0, 2], jnp.int32)))
    jckpt.save_smc(p["smc"], JSMCResult(
        jnp.asarray(a["particles"]), jnp.asarray(7), jnp.asarray(a["scal"]),
        jnp.asarray(a["post"]), jnp.asarray(a["beta"]), jnp.asarray(a["lz"])))

    z, hist = ckpt.load_map(p["map"], device="cpu")
    _eq(z, a["z"])
    _eq(hist, a["hist"])
    q, losses = ckpt.load_svi(p["svi"], device="cpu")
    assert isinstance(q, MultivariateNormalTriL)
    _eq(q.loc, a["loc"])
    _eq(q.scale_tril, a["tril"])
    _eq(losses, a["losses"])
    h = ckpt.load_hmc(p["hmc"], device="cpu")
    assert isinstance(h, HMCResult) and h.total_leapfrogs == 0
    _eq(h.samples, a["samples"])
    _eq(h.accept_rate, a["accept"])
    _eq(h.final_state, a["final"])
    assert float(h.step_size) == pytest.approx(0.1) and float(h.trajectory_length) == 1.5
    _eq(h.divergences, [0, 2])
    s = ckpt.load_smc(p["smc"], device="cpu")
    assert isinstance(s, SMCResult) and s.num_stages == 7
    _eq(s.particles, a["particles"])
    _eq(s.log_scalings, a["scal"])
    _eq(s.post_samples, a["post"])
    _eq(s.final_beta, a["beta"])
    _eq(s.log_evidence, a["lz"])
    if not torch.cuda.is_available():  # device=None is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ckpt.load_map(p["map"])


def test_port_files_load_in_jax(tmp_path):
    a = ARRAYS
    t = {k: torch.tensor(v) for k, v in a.items()}
    p = {k: str(tmp_path / f"{k}.npz") for k in ("map", "svi", "hmc", "smc")}
    ckpt.save_map(p["map"], t["z"], t["hist"])
    ckpt.save_svi(p["svi"], MultivariateNormalTriL(t["loc"], t["tril"]), t["losses"])
    ckpt.save_hmc(p["hmc"], HMCResult(t["samples"], t["accept"], torch.tensor(0.1), t["final"],
                                      torch.tensor(1.5), torch.tensor([0, 2]), 42))
    ckpt.save_smc(p["smc"], SMCResult(t["particles"], 7, t["scal"], t["post"], t["beta"],
                                      t["lz"], num_moves=9))
    # the JAX package's own keys, nothing more
    for name, keys in (("map", {"z", "chi2_history"}), ("svi", {"loc", "scale_tril", "losses"}),
                       ("hmc", {"samples", "accept_rate", "step_size", "final_state",
                                "trajectory_length", "divergences"}),
                       ("smc", {"particles", "num_stages", "log_scalings", "post_samples",
                                "final_beta", "log_evidence"})):
        with np.load(p[name]) as d:
            assert set(d.files) == keys, name
    z, hist = jckpt.load_map(p["map"])
    _eq(z, a["z"])
    _eq(hist, a["hist"])
    q, losses = jckpt.load_svi(p["svi"])
    _eq(q.loc, a["loc"])
    _eq(q.scale_tril, a["tril"])
    _eq(losses, a["losses"])
    h = jckpt.load_hmc(p["hmc"])
    _eq(h.samples, a["samples"])
    _eq(h.divergences, [0, 2])
    assert float(h.trajectory_length) == 1.5
    s = jckpt.load_smc(p["smc"])
    assert int(s.num_stages) == 7
    _eq(s.particles, a["particles"])
    _eq(s.log_evidence, a["lz"])


def test_old_files_and_checkpointer_skips_saved_phases(tmp_path):
    a = ARRAYS
    # files from before trajectory_length / divergences / log_evidence
    np.savez(tmp_path / "hmc.npz", samples=a["samples"], accept_rate=a["accept"],
             step_size=np.float32(0.1), final_state=a["final"])
    np.savez(tmp_path / "smc.npz", particles=a["particles"], num_stages=np.asarray(3),
             log_scalings=a["scal"], post_samples=a["post"], final_beta=a["beta"])
    cp = PipelineCheckpointer(str(tmp_path), device="cpu")

    def never():
        raise AssertionError("a saved phase ran again")

    h = cp.run_hmc(never)
    assert h.trajectory_length.shape == () and float(h.trajectory_length) == 0.0
    _eq(h.divergences, [0, 0])  # per chain, not 0-d
    s = cp.run_smc(never)
    assert s.num_stages == 3 and s.log_evidence.shape == () and float(s.log_evidence) == 0.0

    calls = []

    def run_map():
        calls.append("map")
        return torch.tensor(a["z"]), None

    z1, h1 = cp.run_map(run_map)
    z2, h2 = cp.run_map(never)
    assert calls == ["map"] and h1 is None and h2.shape == (0,)
    _eq(z2, z1.numpy())
    q = MultivariateNormalTriL(torch.tensor(a["loc"]), torch.tensor(a["tril"]))
    cp.run_svi(lambda: (q, torch.tensor(a["losses"])))
    q2, _ = cp.run_svi(never)
    _eq(q2.covariance(), q.covariance().numpy())
    assert cp.has("map") and cp.has("svi") and not PipelineCheckpointer(
        str(tmp_path / "new"), device="cpu").has("map")


class _Stop(Exception):
    pass


def test_fit_resumed_equals_uninterrupted(demo_prior, demo_physmodel, small_sim_config,
                                          tmp_path):
    """A run stopped in its HMC phase (after MAP and SVI were saved) and
    rerun with the same directory gives the uninterrupted run's results
    exactly, and runs only HMC the second time."""
    pm = ForwardProbModel(prior_from_reference(demo_prior), np.zeros((20, 20), np.float32),
                          background_rms=0.1, exp_time=100, device="cpu")

    def seq():
        return ModellingSequence(phys_model_from_reference(demo_physmodel), pm,
                                 sim_config_from_reference(small_sim_config), device="cpu")

    kw = dict(n_samples=8, map_steps=6, n_vi=8, vi_steps=6, n_hmc=4, num_burnin_steps=6,
              num_results=6, seed=0)
    whole = seq().fit(checkpoint_dir=str(tmp_path / "whole"), **kw)

    def stop_in_hmc(phase, step, value):
        if phase == "hmc":
            raise _Stop

    with pytest.raises(_Stop):
        seq().fit(checkpoint_dir=str(tmp_path / "cut"), progress=stop_in_hmc, **kw)
    assert sorted(p.name for p in (tmp_path / "cut").iterdir()) == ["map.npz", "svi.npz"]
    phases = []
    resumed = seq().fit(checkpoint_dir=str(tmp_path / "cut"),
                        progress=lambda phase, step, value: phases.append(phase), **kw)
    assert set(phases) == {"hmc"}
    assert torch.equal(resumed["z_map"], whole["z_map"])
    assert torch.equal(resumed["q_z"].scale_tril, whole["q_z"].scale_tril)
    assert torch.equal(resumed["losses"], whole["losses"])
    assert torch.equal(resumed["hmc"].samples, whole["hmc"].samples)
    assert torch.isfinite(resumed["hmc"].samples).all()


def test_timed_phase_timer_and_trace(tmp_path):
    calls = []

    def fn(x, scale=1.0):
        calls.append(x)
        return torch.full((3,), x * scale)

    secs, out = timed(fn, 2.0, warmup=2, repeats=3, scale=0.5)
    assert secs >= 0.0 and len(calls) == 5 and torch.equal(out, torch.full((3,), 1.0))
    pt = PhaseTimer()
    with pt.phase("a"):
        pass
    with pt.phase("a"):
        pass
    with pt.phase("b"):
        pass
    assert set(pt.phases) == {"a", "b"} and all(v >= 0 for v in pt.phases.values())
    assert pt.summary().startswith("a=") and "b=" in pt.summary() and "total=" in pt.summary()
    with trace(str(tmp_path / "t")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any("mm" in e.key for e in prof.key_averages())
    with open(tmp_path / "t" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
