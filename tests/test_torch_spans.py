"""The port's profiler spans (``utils.profiling.span``) on the CPU: each
layer's span under ``torch.profiler``, nested as the MAP step calls them;
the aten operations of ``map.step``'s own code; no profiler op entered and
no result changed when no profiler runs.

A family-L scene (EPL + Shear, lstsq Sersic and shapelets through the
composable builder's CPU twins) at 10 px, 3 starts, 3 Adam steps."""
import bisect
import contextlib
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gigalens_tpu_torch import PhysicalModel, SimulatorConfig
from gigalens_tpu_torch.inference import optim
from gigalens_tpu_torch.inference.map import fit_map
from gigalens_tpu_torch.inversion import PixelatedSourceProbModel, SourceGrid
from gigalens_tpu_torch.model import BackwardProbModel, ForwardProbModel
from gigalens_tpu_torch.prob import Prior
from gigalens_tpu_torch.prob import distributions as d
from gigalens_tpu_torch.profiles.light import SersicEllipse, Shapelets
from gigalens_tpu_torch.profiles.mass import EPL, SIE, Shear
from gigalens_tpu_torch.simulator import LensSimulator
from gigalens_tpu_torch.utils import profiling

BS, STEPS, NPIX = 3, 3, 10

# the span each span opens in, as the MAP step of a BackwardProbModel calls them
PARENT = {
    "map.step": None,
    "likelihood.log_prob": "map.step",
    "prior.constrain": "likelihood.log_prob",
    "prior.log_prob": "likelihood.log_prob",
    "prior.fldj": "likelihood.log_prob",
    "simulator.render": "likelihood.log_prob",
    "simulator.psf": "likelihood.log_prob",
    "simulator.lstsq": "likelihood.log_prob",
    "map.backward": "map.step",
    "simulator.render_backward": "map.backward",
    "simulator.lstsq_backward": "map.backward",
    "map.update": "map.step",
}
# map.step's own top-level operations: the loss (-sum / n / event size)
# and the step's minimum reduced chi2 (detach, isnan, where, min)
STEP_OWN_OPS = {"aten::sum", "aten::div", "aten::neg", "aten::detach", "aten::isnan",
                "aten::where", "aten::min"}

LENS = [dict(theta_E=d.LogNormal(np.log(1.2), 0.2), gamma=d.Uniform(1.8, 2.2),
             e1=d.Normal(0, 0.1), e2=d.Normal(0, 0.1), center_x=d.Normal(0, 0.05),
             center_y=d.Normal(0, 0.05)),
        dict(gamma1=d.Normal(0, 0.05), gamma2=d.Normal(0, 0.05))]
SERSIC = dict(R_sersic=d.LogNormal(np.log(1.0), 0.15), n_sersic=d.Uniform(2, 6),
              e1=d.Normal(0, 0.1), e2=d.Normal(0, 0.1), center_x=d.Normal(0, 0.05),
              center_y=d.Normal(0, 0.05))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sim_config(fused=True):
    g = np.exp(-((np.arange(5) - 2) ** 2 + (np.arange(5)[:, None] - 2) ** 2) / 2.0)
    return SimulatorConfig(delta_pix=0.13, num_pix=NPIX, supersample=2,
                           kernel=(g / g.sum()).astype(np.float32), use_fused_render=fused)


def _obs():
    return np.random.default_rng(0).normal(1.0, 1.0, (NPIX, NPIX)).astype(np.float32)


def family_l():
    prior = Prior({"lens_mass": LENS, "lens_light": [SERSIC],
                   "source_light": [dict(beta=d.LogNormal(np.log(0.15), 0.2),
                                         center_x=d.Normal(0, 0.1), center_y=d.Normal(0, 0.1))]})
    phys = PhysicalModel([EPL(10), Shear()], [SersicEllipse(use_lstsq=True)],
                         [Shapelets(2, use_lstsq=True)])
    sim = LensSimulator(phys, _sim_config(), bs=BS, device="cpu")
    return BackwardProbModel(prior, _obs(), 0.2, 100.0, device="cpu"), sim


def forward_scene():
    prior = Prior({"lens_mass": LENS, "source_light": [dict(SERSIC, Ie=d.LogNormal(0.0, 0.3))]})
    phys = PhysicalModel([EPL(10), Shear()], [], [SersicEllipse()])
    sim = LensSimulator(phys, _sim_config(fused=False), bs=BS, device="cpu")
    return ForwardProbModel(prior, _obs(), background_rms=0.2, exp_time=100.0, device="cpu"), sim


def pixelated_scene():
    lens = [dict(theta_E=d.LogNormal(np.log(0.7), 0.1), e1=d.Normal(0, 0.1),
                 e2=d.Normal(0, 0.1), center_x=d.Normal(0, 0.05), center_y=d.Normal(0, 0.05)),
            LENS[1]]
    prior = Prior({"lens_mass": lens})
    cfg = SimulatorConfig(delta_pix=0.1, num_pix=NPIX, supersample=1,
                          kernel=np.full((3, 3), 1 / 9, np.float32))
    sim = LensSimulator(PhysicalModel([SIE(), Shear()], [], []), cfg, bs=BS, device="cpu")
    model = PixelatedSourceProbModel(prior, _obs(), background_rms=0.3, exp_time=100.0,
                                     grid=SourceGrid(n_side=4, extent=0.5), lam=2.0,
                                     device="cpu")
    return model, sim


def _optimizer():
    return optim.chain(optim.scale_by_adam(), optim.scale_by_schedule(
        optim.polynomial_schedule(-1e-2, -1e-3, 0.5, STEPS)))


def _start(prob):
    return prob.prior.unconstrain(prob.prior.sample(torch.Generator().manual_seed(1), BS))


def _fit(prob, sim, z0):
    return fit_map(prob, sim, _optimizer(), start=z0, n_samples=BS, num_steps=STEPS)


def _events(prof):
    """(start, end, name, is a span) of every CPU event of ``prof``."""
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(), e.is_user_annotation())
                  for e in prof.profiler.kineto_results.events())


def _innermost(events, t0, t1, keep):
    """The latest-starting event among ``keep`` (``events`` sorted) that
    holds [t0, t1] and is not that interval itself."""
    for e in reversed(events[:bisect.bisect_right(events, (t0, math.inf))]):
        if keep(e) and e[1] >= t1 and (e[0], e[1]) != (t0, t1):
            return e
    return None


@pytest.fixture(scope="module")
def traced_fit():
    """The family-L fit under a CPU profiler, with the (name, args) of each
    span's record_function."""
    prob, sim = family_l()
    calls = []
    real = profiling.record_function

    def recording(name, args=None):
        calls.append((name, args))
        return real(name, args)

    profiling.record_function = recording
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _fit(prob, sim, _start(prob))
    finally:
        profiling.record_function = real
    return _events(prof), calls


def test_each_layer_span_nests_in_the_map_step(traced_fit):
    events, calls = traced_fit
    spans = [e for e in events if e[3]]
    assert {e[2] for e in spans} == set(PARENT)
    for e in spans:
        parent = _innermost(spans, e[0], e[1], lambda s: True)
        assert (parent and parent[2]) == PARENT[e[2]], e[2]
    counts = {name: sum(s[2] == name for s in spans) for name in PARENT}
    assert counts["map.step"] == STEPS
    assert all(n == STEPS for n in counts.values()), counts
    assert [a for n, a in calls if n == "map.step"] == [str(i) for i in range(STEPS)]
    assert all(a is None for n, a in calls if n != "map.step")


def test_map_step_own_operations_are_the_loss_and_chi2_lines(traced_fit):
    events, _ = traced_fit
    steps = [e for e in events if e[2] == "map.step"]
    inside = [e for e in events if not e[3] and e[2].startswith("aten::")
              and any(s[0] <= e[0] and e[1] <= s[1] for s in steps)]
    assert inside
    own = set()
    for e in inside:
        # the innermost span or host operation around the aten op
        outer = _innermost(events, e[0], e[1],
                           lambda s: s[3] or s[2].startswith(("aten::", "autograd::")))
        if outer[2] == "map.step":
            own.add(e[2])
    assert own and own <= STEP_OWN_OPS, own - STEP_OWN_OPS


@pytest.mark.parametrize("scene", [family_l, forward_scene, pixelated_scene])
def test_every_prob_model_opens_likelihood_prior_and_simulator_spans(scene):
    prob, sim = scene()
    z = _start(prob).requires_grad_(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        lp, _ = prob.log_prob(sim, z)
    spans = [e for e in _events(prof) if e[3]]
    names = [e[2] for e in spans]
    assert names.count("likelihood.log_prob") == 1
    for e in spans:
        if e[2].startswith(("prior.", "simulator.", "inversion.")):
            outer = [s[2] for s in spans if s[0] <= e[0] and e[1] <= s[1] and s is not e]
            assert "likelihood.log_prob" in outer, e[2]
    assert {"prior.constrain", "prior.log_prob", "prior.fldj", "simulator.psf"} <= set(names)
    if scene is pixelated_scene:  # the inversion's ranges keep their names
        assert {"inversion.gram", "inversion.cholesky"} <= set(names)
    else:
        assert "simulator.render" in names
    assert torch.isfinite(lp).all()


def test_without_a_profiler_no_profiler_op_is_entered(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)
    assert isinstance(profiling.span("map.step", "0"), contextlib.nullcontext)
    prob, sim = family_l()
    z, hist = _fit(prob, sim, _start(prob))
    assert torch.isfinite(z).all() and hist.shape == (STEPS,)


def test_fit_map_is_bitwise_the_same_under_a_profiler():
    prob, sim = family_l()
    z0 = _start(prob)
    z_off, hist_off = _fit(prob, sim, z0)
    with profile(activities=[ProfilerActivity.CPU]):
        z_on, hist_on = _fit(prob, sim, z0)
    assert torch.equal(z_on, z_off)
    assert torch.equal(hist_on, hist_off)
