"""Faults planted in the timed path, for the check's own tests and for
reading the check's numbers under them. :func:`plant` puts one under a
loaded cell: the first three wrap the program's prob model as the driver
sees it, the last the program's optimizer.

* ``unchanged``: every step returns its state unchanged (no gradient
  reaches the parameters, so Adam moves nothing);
* ``half``: half of the batch left out of the loss, the mean taken over the
  rest (the first half's gradient doubled, the second's zero; the values
  as before);
* ``altered``: an answer altered where it is produced (every eighth row's
  log density raised by 1% of its size);
* ``step``: a wrong update, every update of the optimizer scaled by
  ``STEP_FACTOR`` (a step size 10% off; Adam divides out a scaled gradient,
  so this is the smallest optimizer fault the gradient checks cannot see).
"""
import torch

KINDS = ("unchanged", "half", "altered", "step")
STEP_FACTOR = 1.1


class Fault:
    def __init__(self, inner, kind):
        if kind not in KINDS[:3]:
            raise ValueError(f"unknown fault of the prob model {kind!r}")
        self.inner, self.kind = inner, kind

    def event_size(self, simulator):
        return self.inner.event_size(simulator)

    def log_prob(self, simulator, z):
        lp, chi = self.inner.log_prob(simulator, z)
        zero = 0.0 * torch.sum(z, dim=-1)  # keeps z in the graph
        rows = torch.arange(lp.shape[0], device=lp.device)
        if self.kind == "unchanged":
            return lp.detach() + zero, chi
        if self.kind == "half":
            first = rows < lp.shape[0] // 2
            return torch.where(first, 2 * lp - lp.detach(), lp.detach()) + zero, chi
        bump = torch.where(rows % 8 == 0, 0.01 * torch.abs(lp.detach()), torch.zeros_like(lp))
        return lp + bump, chi


def scaled_updates(opt, factor):
    """The program's optimizer ``opt`` with every update times ``factor``."""
    from gigalens_tpu_torch.inference import optim

    def update(g, state, params=None):
        return g * factor, state

    return optim.chain(opt, optim.GradientTransformation(lambda params: {}, update))


def plant(cell, kind, set_attr=setattr):
    """Plants fault ``kind`` under ``cell`` (a ``harness.load_cell``
    result) by replacing, with ``set_attr``, the configuration's builder of
    the program or the driver's builder of the optimizer."""
    if kind not in KINDS:
        raise ValueError(f"unknown fault {kind!r}")
    if kind == "step":
        make = cell["driver"].optimizer
        set_attr(cell["driver"], "optimizer",
                 lambda *a, **k: scaled_updates(make(*a, **k), STEP_FACTOR))
        return
    build = cell["system"].build

    def broken(*args, **kwargs):
        prob, sim = build(*args, **kwargs)
        return Fault(prob, kind), sim

    set_attr(cell["system"], "build", broken)
