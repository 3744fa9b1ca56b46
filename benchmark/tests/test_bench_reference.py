"""Each configuration's plain reference against the program's CPU path at a
small size: the log density, the reduced chi2 and the gradient at prior
draws, the prior's column order and constrained values."""
import pytest
import torch

import harness
from _small import SMALL, small_ctx
from reference.plain import Precision


@pytest.mark.parametrize("workload", sorted(SMALL))
@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_reference_agrees_with_the_program_on_the_cpu(workload, seed):
    ctx = small_ctx(workload, seed)
    z = ctx["ref_prior"].sample_z(harness.generator(seed, "test", ctx["device"]),
                                  ctx["traffic"]["starts"]).float()
    zp = z.clone().requires_grad_(True)
    lp, chi = ctx["prob"].log_prob(ctx["sim"], zp)
    (g,) = torch.autograd.grad(lp.sum(), zp)
    ref = ctx["reference"].Reference(ctx["cfg"], ctx["obs"], Precision("float64"), ctx["device"])
    out = harness.evaluate(ref, z.double(), block=4)
    assert torch.all(torch.abs(lp.double() - out["lp"]) <= 1e-5 * out["scale"])
    assert torch.allclose(chi.double(), out["red_chi2"], rtol=1e-5)
    norm = torch.linalg.vector_norm(out["grad"], dim=1, keepdim=True)
    assert torch.all(torch.abs(g.double() - out["grad"]) <= 1e-3 * norm)


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_prior_columns_match_the_program(workload):
    ctx = small_ctx(workload, 5)
    z = ctx["ref_prior"].sample_z(harness.generator(5, "cols", ctx["device"]), 4)
    mine = ctx["ref_prior"].constrain(z)
    theirs = ctx["prob"].prior.constrain(z.float())
    for group, profs in mine.items():
        for a, b in zip(profs, theirs[group]):
            assert sorted(a) == sorted(b)
            for k in a:
                assert torch.allclose(a[k].float(), b[k], rtol=1e-5, atol=1e-6), (group, k)
    lp_mine = ctx["ref_prior"].log_prob_z(z)
    lp_theirs = ctx["prob"].prior.log_prob_z(z.float())
    assert torch.allclose(lp_mine.float(), lp_theirs, rtol=1e-4, atol=1e-3)
