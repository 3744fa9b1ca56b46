"""Survey mode and the pixelated-source inversion under a mesh
(gigalens_tpu_torch.parallel) on the CPU: two ``gloo`` ranks against one.

A module fixture spawns two ranks once (``spawn_ranks``, a file
rendezvous under the test's temporary directory) that run
tests/torch_mesh_ranks.py's survey and inversion scenarios; the same
scenarios run in-process with no process group, and the tests compare.
They mirror tests/test_survey.py::test_survey_sharded_matches_single_device
(survey MAP, SVI and grouped HMC on a two-scene catalogue, rtol 1e-4 /
atol 1e-4), with a short survey SMC from the MAP starts (tests/
test_sharding.py's SMC tolerances), and tests/test_inversion.py::
test_sharded_inversion_matches_single_device (three MAP steps of the
pixelated-source model, rtol 1e-4 / atol 1e-5). The scene-major batch is
sharded scene by scene: each rank holds every scene and half of its rows.
"""
import warnings

import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from gigalens_tpu_torch.inference import SurveySequence
from gigalens_tpu_torch.model import SurveyForwardProbModel
from gigalens_tpu_torch.parallel import Mesh, spawn_ranks
from gigalens_tpu_torch.simulator import LensSimulator


def close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.fixture(scope="module")
def inputs():
    """The survey catalogue (two prior draws rendered by the port, numpy
    noise), and the inversion scene's observation, PSF and 8 starts."""
    prior = ranks.survey_prior()
    phys, cfg = ranks.survey_scene()
    truths = prior.sample(torch.Generator().manual_seed(7), 2)
    with torch.no_grad():
        imgs = LensSimulator(phys, cfg, bs=2, device="cpu").simulate(truths).numpy()
    rng = np.random.default_rng(0)
    obs = imgs + rng.normal(size=imgs.shape).astype(np.float32) * np.sqrt(
        ranks.BKG**2 + np.clip(imgs, 0, None) / ranks.EXP_TIME)

    kern = rng.uniform(0.1, 1.0, (5, 5))
    kern = (kern / kern.sum()).astype(np.float32)
    obs_inv = rng.normal(0.0, 1.0, (20, 20)).astype(np.float32)
    inv_prior = ranks.inversion_scene(obs_inv, kern)[2].prior
    start = inv_prior.unconstrain(inv_prior.sample(torch.Generator().manual_seed(2), 8))
    return obs.astype(np.float32), obs_inv, kern, start.numpy()


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    obs, obs_inv, kern, start = inputs
    jobs = [("survey", (obs,)), ("inversion", (obs_inv, kern, start))]
    two = spawn_ranks(ranks.run, 2, "gloo", "cpu", args=(jobs,), timeout=300,
                      workdir=str(tmp_path_factory.mktemp("mesh")))
    return ranks.run(None, jobs), two


@pytest.mark.quick
def test_survey_counts_round_to_the_mesh(inputs):
    """Per-scene counts round to multiples of the mesh size (each scene's
    rows shard evenly), with the rounding warning; a one-rank mesh rounds
    nothing."""
    obs = inputs[0]
    phys, cfg = ranks.survey_scene()
    model = SurveyForwardProbModel(ranks.survey_prior(), obs, background_rms=ranks.BKG,
                                   exp_time=ranks.EXP_TIME, device="cpu")
    one = SurveySequence(phys, model, cfg, mesh=Mesh("cpu"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert one._per_scene(5, "n_starts") == 5
    two = Mesh("cpu")
    two.rank, two.size = 1, 2
    seq = SurveySequence(phys, model, cfg, mesh=two)
    with pytest.warns(UserWarning, match="n_starts 5 -> 4"):
        assert seq._per_scene(5, "n_starts") == 4
    assert seq._sim(2 * 4).bs == 4  # a rank's share of the scene-major batch


def test_survey_two_ranks_equal_one(runs):
    """MAP, per-scene best starts, SVI and grouped HMC (one adaptation group
    a scene), as tests/test_survey.py:212 holds JAX's 8-device mesh to one
    device."""
    one, two = runs
    got, want = two[0][0], one[0]
    assert got["z"].shape == (16, want["z"].shape[1])
    for k in ("z", "best", "means", "samples", "eps"):
        close(got[k], want[k], 1e-4, 1e-4, k)
    close(got["losses"], want["losses"], 1e-4, 1e-2, "losses")
    close(got["trils"], want["trils"], 1e-3, 1e-5, "trils")
    assert got["eps"].shape == (2,) and got["samples"].shape == (4, 16, want["z"].shape[1])


def test_survey_smc_two_ranks_equal_one(runs):
    """Survey SMC from the MAP starts (one ensemble a scene; each rank
    scores its four particles of each scene)."""
    one, two = runs
    got, want = two[0][0]["smc"], one[0]["smc"]
    close(got["beta"], want["beta"], 1e-5, 1e-6, "beta")
    for k in ("particles", "post"):
        assert got[k].shape == want[k].shape
        close(got[k], want[k], 5e-3, 5e-3, k)


def test_inversion_map_two_ranks_equal_one(runs):
    one, two = runs
    assert two[0][1].shape == (8, 7)
    close(two[0][1], one[1], 1e-4, 1e-5)


def test_ranks_return_the_global_result(runs):
    _, two = runs
    for a, b in zip(two[0], two[1]):
        if isinstance(a, dict):
            for k in a:
                va, vb = (a[k], b[k]) if k != "smc" else (a[k]["post"], b[k]["post"])
                torch.testing.assert_close(va, vb, rtol=0, atol=0, msg=k)
        else:
            torch.testing.assert_close(a, b, rtol=0, atol=0)
