"""The control at each cell's own timed size on the card: the reference one
step of precision below the configuration's (TF32 products, the float64
solve in float32), in the program's place under the driver, is not correct
on three seeds. Skips without a CUDA card."""
import pytest
import torch

import harness
from _small import load


@pytest.mark.card
@pytest.mark.parametrize("workload", ["epl80_lstsq.map", "inversion64.map"])
def test_control_is_not_correct_at_the_timed_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    cell = load(workload)
    for seed in (3700000001, 3700000002, 3700000003):
        ctx = harness.prepare(cell, seed, torch.device("cuda"))
        harness.window(ctx, max_steps=ctx["traffic"]["check_steps"] + 1,
                       prob=harness.ControlModel(ctx), fits=1)
        ctx["prob"] = ctx["sim"] = ctx["probe"] = None
        numbers, _ = ctx["driver"].check(ctx)
        limits = cell["limits"]
        assert any(numbers[k] > v for k, v in limits.items()), (seed, numbers)
