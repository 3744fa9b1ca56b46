"""Sample sharding over a mesh (gigalens_tpu_torch.parallel) on the CPU:
two ``gloo`` ranks against one.

A module fixture spawns two ranks once (``spawn_ranks``, a file
rendezvous under the test's temporary directory) that run
tests/torch_mesh_ranks.py's scenarios on tests/test_torch_map.py's demo
scene; the same scenarios run in-process with no process group, and the
tests compare. The tolerances are tests/test_sharding.py's for the same
comparisons (MAP z rtol 1e-4 / atol 1e-5; SVI losses 1e-4 / 1e-2, mean
1e-4 / 1e-5, scale_tril 1e-3 / 1e-5; HMC samples 1e-4 / 1e-4; SMC
final_beta 1e-5 / 1e-6, particles 5e-3 / 5e-3). The two ranks must return
bitwise-equal results: every phase gives the global result on every rank.
The port's two-rank MAP is also held against JAX's MAP on the 8 virtual
devices of tests/conftest.py, from the same numpy start, at
tests/test_torch_map.py's MAP tolerance (rtol 1e-3).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

import torch_mesh_ranks as ranks
from gigalens_tpu import PhysicalModel as JPhysicalModel
from gigalens_tpu import SimulatorConfig as JSimulatorConfig
from gigalens_tpu.inference import ModellingSequence as JModellingSequence
from gigalens_tpu.model import ForwardProbModel as JForwardProbModel
from gigalens_tpu.parallel import default_mesh as j_default_mesh
from gigalens_tpu.profiles.light.sersic import SersicEllipse as JSersicEllipse
from gigalens_tpu.profiles.mass.epl import EPL as JEPL
from gigalens_tpu.profiles.mass.shear import Shear as JShear
from gigalens_tpu_torch.interop import prior_from_reference, sim_config_from_reference
from gigalens_tpu_torch.parallel import Mesh, round_to_multiple, spawn_ranks
from gigalens_tpu_torch.parallel import mesh as pmesh
from gigalens_tpu_torch.simulator import LensSimulator


# tests/test_torch_pipeline.py's micro bench configuration
MICRO = dict(num_pix=20, map_n=8, map_steps=5, vi_n=8, vi_steps=5, hmc_n=4, burnin=12,
             results=10, hmc_seeds=[2], scale="micro")


def close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


def equal_trees(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            equal_trees(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            equal_trees(x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True, msg=path)
    else:
        assert a == b, path


@pytest.fixture(scope="module")
def inputs():
    """The demo scene's observation (a prior draw rendered by the port plus
    numpy noise) and 16 starts in z."""
    rng = np.random.default_rng(0)
    phys, cfg, prob = ranks.demo_scene(np.zeros((20, 20), np.float32))
    prior = prob.prior
    z_truth = torch.tensor(rng.standard_normal((1, prior.d)) * 0.3, dtype=torch.float32)
    with torch.no_grad():
        img = LensSimulator(phys, cfg, bs=1, device="cpu").simulate(prior.constrain(z_truth))
    img = img.numpy().reshape(20, 20)
    obs = img + rng.normal(size=img.shape).astype(np.float32) * np.sqrt(
        ranks.BKG**2 + np.clip(img, 0, None) / ranks.EXP_TIME)
    start = (rng.standard_normal((16, prior.d)) * 0.5).astype(np.float32)
    return obs.astype(np.float32), start


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """(one, two): the scenarios' results in-process and in each of two
    gloo ranks."""
    obs, start = inputs
    work = tmp_path_factory.mktemp("mesh")
    jobs = lambda sub: [("collectives", ()), ("demo", (obs, start, str(work / sub))),  # noqa
                        ("bench", (MICRO,)), ("few_rows", (obs, start[0]))]
    (work / "one").mkdir()
    (work / "two").mkdir()
    two = spawn_ranks(ranks.run, 2, "gloo", "cpu", args=(jobs("two"),), timeout=300,
                      workdir=str(work))
    one = ranks.run(None, jobs("one"))
    return one, two


@pytest.mark.quick
def test_round_to_multiple():
    """tests/test_sharding.py::test_round_to_multiple's cases, and the
    warning when the count changes."""
    with pytest.warns(UserWarning, match="500 -> 496"):
        assert round_to_multiple(500, 8) == 496
    with pytest.warns(UserWarning, match="3 -> 8"):
        assert round_to_multiple(3, 8) == 8
    assert round_to_multiple(16, 8) == 16


def test_pixel_reduce_runs_at_the_global_row_count():
    """A mesh rank's simulator evaluates the prob models' per-row pixel
    reductions at the global row count: its rows at their place among zero
    rows, as rank r of the layout (a ``Mesh`` with no process group), for a
    plain batch, a squeezed batch of one and a scene-major survey batch.
    The reduction here tells row counts apart, so any other placement
    fails; without a mesh it sees the rows it is given."""
    from gigalens_tpu_torch.model import pixel_reduce

    def fn(t):  # a row's sum plus the number of rows the call holds
        return t.sum(dim=(-2, -1)) + 1000.0 * t.shape[-3]

    x = torch.arange(24 * 4, dtype=torch.float32).reshape(24, 2, 2)
    sim = LensSimulator.__new__(LensSimulator)
    sim.mesh, sim.bs = None, 24
    torch.testing.assert_close(pixel_reduce(sim, fn, x), fn(x), rtol=0, atol=0)
    mesh = Mesh("cpu")
    for size, rank in ((4, 0), (4, 3), (24, 5)):
        mesh.rank, mesh.size = rank, size
        n = 24 // size
        sim.mesh, sim.bs = mesh, n
        rows = x[rank * n:(rank + 1) * n]
        got = pixel_reduce(sim, fn, rows.squeeze(0) if n == 1 else rows)
        torch.testing.assert_close(got.reshape(n), fn(x)[rank * n:(rank + 1) * n], rtol=0, atol=0)
        assert got.shape == (() if n == 1 else (n,))
    # survey: 3 scenes of 8 rows, each rank holding 8 / size rows of every scene
    scenes = x.reshape(3, 8, 2, 2)
    for size, rank in ((2, 1), (4, 2)):
        mesh.rank, mesh.size = rank, size
        n = 8 // size
        sim.mesh, sim.bs = mesh, 3 * n
        rows = scenes[:, rank * n:(rank + 1) * n]
        torch.testing.assert_close(pixel_reduce(sim, fn, rows, 3),
                                   fn(scenes)[:, rank * n:(rank + 1) * n], rtol=0, atol=0)


@pytest.fixture(scope="module")
def row_checks():
    """tests/torch_mesh_ranks.py's per-row checks, run once in a process of
    their own whose CPU kernels are ATen's plain ones
    (``ATEN_CPU_CAPABILITY=default``): the vectorized kernels compute an
    element of a batch's tail (past its last full SIMD vector) with other
    code than the rest, so on this CPU a row's transcendentals round by its
    place in the batch. The card computes every element alike; the plain
    kernels leave what the port's own code does with the row count."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, ATEN_CPU_CAPABILITY="default", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(root), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, str(root / "tests" / "torch_mesh_ranks.py"), "rows"],
                          capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("model", ["forward", "backward", "survey_forward", "survey_backward"])
def test_rows_at_any_count_equal_a_48_row_call(row_checks, model):
    """Each prob model's per-row log_prob and z-gradient at k = 1, 2, 4, 12
    and 24 rows (a scene, for the two-scene survey models) on a simulator
    that is rank 0 and the last rank of a mesh of 48 / k ranks, bitwise
    equal to the same rows in one 48-row call: the pixel sums and the lstsq
    solve run at the global row count, so N ranks hold one process's
    numbers at any rows a rank (pixels and four image positions for the
    ForwardProbModel; both lights linear for the BackwardProbModel)."""
    got = row_checks[model]
    want = [1, 2, 4, 12] + ([24] if not model.startswith("survey") else [])
    assert sorted(int(k) for k in got) == want
    for k, (lp, grad) in got.items():
        assert lp == 0.0 and grad == 0.0, (model, k, lp, grad)


def test_hmc_at_two_rows_a_rank_two_ranks_equal_one(runs):
    """tests/test_sharding.py:79-101 at two rows a rank: 4 chains on two
    ranks against one process, rtol / atol 1e-4 (the same leapfrog count
    and step size)."""
    one, two = runs
    got, want = two[0][3], one[3]
    assert got["samples"].shape == want["samples"].shape == (4, 4, 22)
    assert torch.isfinite(got["samples"]).all()
    close(got["samples"], want["samples"], 1e-4, 1e-4)
    close(got["eps"], want["eps"], 1e-4, 1e-6)
    assert got["nlf"] == want["nlf"]
    equal_trees(two[0][3], two[1][3])


def test_local_device_needs_a_card_per_local_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(ValueError, match="LOCAL_RANK 1 needs card 1"):
        pmesh._local_device()
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert pmesh._local_device() == torch.device("cuda", 0)


def test_shard_gather_round_trip(runs):
    """Each rank holds rows [r c, (r + 1) c) of every group; gathering
    restores the global order on both ranks (dim 0 and dim 1); the
    reductions, sample-axis reductions and the broadcast."""
    one, two = runs
    x = torch.arange(24 * 3, dtype=torch.float32).reshape(24, 3)
    for r, res in enumerate(out[0] for out in two):
        assert res["size"] == 2
        for groups in (1, 2, 3):
            want = x.reshape(groups, 2, -1, 3)[:, r].reshape(-1, 3)
            torch.testing.assert_close(res[f"shard{groups}"], want, rtol=0, atol=0)
            torch.testing.assert_close(res[f"gather{groups}"], x, rtol=0, atol=0)
            torch.testing.assert_close(one[0][f"gather{groups}"], x, rtol=0, atol=0)
        torch.testing.assert_close(res["gather_dim1"],
                                   torch.arange(8, dtype=torch.float32).reshape(4, 2))
        torch.testing.assert_close(res["sum"], torch.tensor([3.0, -2.0, 6.0]))
        torch.testing.assert_close(res["sum_pair"], torch.tensor([[3.0, -2.0, 6.0],
                                                                  [6.0, -4.0, 12.0]]))
        torch.testing.assert_close(res["max"], torch.tensor([2.0, 0.0, 3.0]))
        torch.testing.assert_close(res["min"], torch.tensor([1.0, -2.0, 3.0]))
        for k in ("sample_mean", "sample_max", "sample_min"):
            torch.testing.assert_close(res[k], one[0][k], rtol=0, atol=0)
        torch.testing.assert_close(res["replicate"], torch.zeros(2))
    torch.testing.assert_close(one[0]["sample_mean"], x.mean(0))


def test_ranks_return_the_global_result(runs):
    """Both ranks return bitwise-equal results of every phase."""
    _, two = runs
    equal_trees(two[0][1], two[1][1])


def test_log_prob_two_ranks_equal_one(runs):
    one, two = runs
    close(two[0][1]["log_prob"], one[1]["log_prob"], 1e-5, 1e-3)
    close(two[0][1]["chi2"], one[1]["chi2"], 1e-5, 1e-5)


def test_map_two_ranks_equal_one(runs):
    """Prior starts (drawn globally, each rank keeping its rows) and given
    starts, and best_map_start on the gathered log-posteriors."""
    one, two = runs
    for k in ("map", "map_start", "best"):
        close(two[0][1][k], one[1][k], 1e-4, 1e-5, k)
    assert not torch.equal(one[1]["map"], one[1]["map_start"])


def test_map_two_ranks_equal_jax_eight_devices(runs, inputs, demo_prior):
    """The port's two-rank MAP from the numpy start against JAX's MAP on
    the 8-device mesh; the port's scene is the one interop makes from the
    JAX objects."""
    obs, start = inputs
    jcfg = JSimulatorConfig(delta_pix=0.13, num_pix=20, supersample=2,
                            kernel=ranks.gaussian_psf(), use_fused_render=False)
    jphys = JPhysicalModel([JEPL(18), JShear()], [JSersicEllipse()], [JSersicEllipse()])
    jprob = JForwardProbModel(demo_prior, obs, background_rms=ranks.BKG,
                              exp_time=ranks.EXP_TIME)
    _, tcfg, tprob = ranks.demo_scene(obs)
    ref_cfg = sim_config_from_reference(jcfg)
    for f in ("delta_pix", "num_pix", "supersample", "use_fused_render", "psf_mode"):
        assert getattr(ref_cfg, f) == getattr(tcfg, f), f
    np.testing.assert_array_equal(np.asarray(ref_cfg.kernel), np.asarray(tcfg.kernel))
    ref_prior = prior_from_reference(demo_prior)
    x = torch.tensor(start)
    for a, b in zip(ref_prior.log_prob(ref_prior.constrain(x)).tolist(),
                    tprob.prior.log_prob(tprob.prior.constrain(x)).tolist()):
        assert a == b
    mesh8 = j_default_mesh()
    assert mesh8.size == 8
    seq = JModellingSequence(jphys, jprob, jcfg, mesh=mesh8)
    want = seq.MAP(optax.adam(1e-3), start=jax.numpy.asarray(start), n_samples=16, num_steps=5)
    _, two = runs
    close(two[0][1]["map_start"], want, 1e-3, 1e-5)


def test_svi_two_ranks_equal_one(runs):
    one, two = runs
    got, want = two[0][1]["svi"], one[1]["svi"]
    assert torch.isfinite(got["losses"]).all()
    close(got["losses"], want["losses"], 1e-4, 1e-2)
    close(got["mean"], want["mean"], 1e-4, 1e-5)
    close(got["scale_tril"], want["scale_tril"], 1e-3, 1e-5)


def test_hmc_two_ranks_equal_one(runs):
    """ChEES with a mass-window switch (25 burn-in steps: adaptation 20,
    switch at 10), and two seed groups of static-L chains: the samples,
    and the adapted step sizes, acceptance history, divergences and
    leapfrog count."""
    one, two = runs
    for k in ("hmc", "hmc_grouped"):
        got, want = two[0][1][k], one[1][k]
        assert got["samples"].shape == want["samples"].shape
        assert torch.isfinite(got["samples"]).all()
        close(got["samples"], want["samples"], 1e-4, 1e-4, k)
        close(got["eps"], want["eps"], 1e-4, 1e-6, k)
        close(got["accept"], want["accept"], 1e-4, 1e-5, k)
    assert two[0][1]["hmc"]["samples"].shape == (4, 16, 22)
    assert two[0][1]["hmc_grouped"]["eps"].shape == (2,)
    torch.testing.assert_close(two[0][1]["hmc"]["div"], one[1]["hmc"]["div"])
    assert two[0][1]["hmc"]["nlf"] == one[1]["hmc"]["nlf"]


def test_smc_two_ranks_equal_one(runs):
    one, two = runs
    got, want = two[0][1]["smc"], one[1]["smc"]
    assert got["stages"] == want["stages"]
    assert torch.isfinite(got["particles"]).all()
    close(got["beta"], want["beta"], 1e-5, 1e-6)
    close(got["log_z"], want["log_z"], 1e-4, 1e-3)
    for k in ("particles", "post", "scalings"):
        assert got[k].shape == want[k].shape
        close(got[k], want[k], 5e-3, 5e-3, k)


def test_checkpointed_fit_under_a_mesh(runs):
    """fit(checkpoint_dir=...) on two ranks writes each phase once (rank
    0); after rank 0 removes the HMC file, the rerun loads MAP and SVI and
    runs HMC again on both ranks, equal to the first run; both equal the
    one-rank fit."""
    one, two = runs
    for res in (one[1], two[0][1], two[1][1]):
        assert res["fit_files"] == ["hmc.npz", "map.npz", "svi.npz"]
        equal_trees(res["fit"][0], res["fit"][1])
    got, want = two[0][1]["fit"][0], one[1]["fit"][0]
    close(got["z_map"], want["z_map"], 1e-4, 1e-5)
    close(got["loc"], want["loc"], 1e-4, 1e-5)
    close(got["tril"], want["tril"], 1e-3, 1e-5)
    close(got["samples"], want["samples"], 1e-4, 1e-4)


def test_bench_under_two_ranks(runs):
    """gigalens_tpu_torch.bench.main in a two-rank process group (as under
    torchrun): both ranks complete, rank 0 alone prints the JSON line, with
    the one-rank run's keys plus ``ranks``, and its MAP equals the one-rank
    run's (SVI's gradient all-reduce adds in another order, and the
    micro run's 22 HMC steps carry that rounding on: the later phases are
    only checked to be finite)."""
    one, two = runs
    (r0, r1), want = (two[0][2], two[1][2]), one[2]
    assert r0["rc"] == r1["rc"] == want["rc"] == 0
    assert r1["stdout"] == ""
    got, want = json.loads(r0["stdout"]), json.loads(want["stdout"])
    assert set(got) == set(want) | {"ranks"} and got["ranks"] == 2 and "ranks" not in want
    assert got["complete"] is True
    close(got["best_map_red_chi2"], want["best_map_red_chi2"], 1e-4, 1e-4)
    assert all(np.isfinite(got[k]) for k in ("posterior_red_chi2", "max_rhat", "min_ess"))


def test_bench_rank_failure_ends_the_job(tmp_path):
    """Under torchrun (two gloo ranks on the CPU), a phase failing on rank 1
    alone ends the whole job with a nonzero exit well inside the time
    limit, rank 1's traceback printed with its rank, and no JSON line."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, GIGALENS_BENCH_SCALE="tiny", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(root), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         str(root / "tests" / "torch_mesh_ranks.py"), "--device", "cpu"],
        capture_output=True, text=True, timeout=180, cwd=tmp_path, env=env)
    assert proc.returncode != 0
    assert "[rank 1 of 2] PHASE map FAILED" in proc.stderr
    assert "injected failure" in proc.stderr
    assert '"metric"' not in proc.stdout
