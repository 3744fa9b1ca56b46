"""The check against faults planted in the timed path: a run on the CPU at
a small size (everything after the look for the card) comes out correct,
and not correct with each fault a MAP cell can have planted under the
program's ``fit_map``: a step that returns its state unchanged, half of
the batch left out with the mean taken over the rest, an answer altered
where it is produced, every update 10% too large; and with the control (the reference one step of
precision below the configuration's) in the program's place, where the
small size shows it (the lstsq cell; the inversion's control needs its
timed size, ``test_bench_control.py``)."""
import time

import pytest
import torch

import faults
import harness
from _small import CPU, SMALL, load


def run_small(monkeypatch, workload, seed, fault=None):
    cell = load(workload)
    if fault is not None:
        faults.plant(cell, fault, monkeypatch.setattr)
    result, lines = harness.run(cell, seed, 1.0, False, CPU, time.time(), SMALL[workload])
    assert list(result)[-1] == "check"
    assert all(k in lines[-len(result["check"]) + i] for i, k in enumerate(result["check"]))
    return result


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_sound_runs_are_correct(monkeypatch, workload):
    for seed in (1, 2**31 + 5):
        result = run_small(monkeypatch, workload, seed)
        assert result["correct"], result["check"]
        assert result["failed"] == 0 and result["attempted"] > 0
        assert set(result["metrics"]) == {"evals_per_s", "step_ms_p95", "setup_s"}


@pytest.mark.parametrize("fault", faults.KINDS)
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_each_fault_is_not_correct(monkeypatch, workload, fault):
    result = run_small(monkeypatch, workload, 7, fault)
    assert not result["correct"], result["check"]
    assert result["failed"] >= 1


def test_the_lstsq_control_is_not_correct_at_a_small_size():
    cell = harness.load_cell("epl80_lstsq.map")
    for seed in (11, 12, 13):
        ctx = harness.prepare(cell, seed, CPU, SMALL["epl80_lstsq.map"])
        harness.window(ctx, max_steps=ctx["traffic"]["check_steps"] + 1,
                       prob=harness.ControlModel(ctx, block=4), fits=1)
        numbers, _ = ctx["driver"].check(ctx)
        limits = cell["limits"]
        assert any(numbers[k] > v for k, v in limits.items()), numbers


def test_a_window_closes_between_steps_and_counts_every_finished_one():
    ctx = harness.prepare(harness.load_cell("epl80_lstsq.map"), 4, CPU,
                          SMALL["epl80_lstsq.map"])
    win = harness.window(ctx, max_steps=13)
    # 13 step starts over two fits of 10 steps: every one finished its update
    assert win["steps"] == 13 and win["fits"] == 2
    assert len(win["durations"]) == 13
    assert len(ctx["record"]["z"]) == ctx["traffic"]["check_steps"] + 1
    assert len(ctx["record"]["g"]) == ctx["traffic"]["check_steps"]
    assert torch.equal(ctx["record"]["z"][0], ctx["record"]["z0"])
