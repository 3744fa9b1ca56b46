"""The two optax pieces the MAP API takes, on tensors.

``scale_by_adam``, ``scale_by_schedule``/``polynomial_schedule`` and
``chain`` with optax 0.2.6 semantics, so the bench recipe reads the same in
the port::

    opt = chain(scale_by_adam(), scale_by_schedule(
        polynomial_schedule(-1e-2, -1e-2 / 3, 0.5, num_steps)))

A transformation is an ``(init(params) -> state, update(updates, state,
params) -> (updates, state))`` pair; the caller adds the updates.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def _bias_correction(decay, count):
    """1 - decay**count in float32, exactly as optax's jitted update computes
    it: decay rounds to float32 (1 - 0.999 is then 9.99987e-4, not 1e-3),
    the power is correctly rounded to float32, and the subtraction is in
    float32. The cancellation in 1 - decay**count would turn any other
    rounding into ~1e-5 relative noise in the update."""
    power = np.float32(float(np.float32(decay)) ** count)
    return float(np.float32(1.0) - power)


def scale_by_adam(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0) -> GradientTransformation:
    """Adam's bias-corrected moment rescaling (no learning rate)."""

    def init(params):
        return dict(count=0, mu=torch.zeros_like(params), nu=torch.zeros_like(params))

    def update(g, state, params=None):
        mu = (1 - b1) * g + b1 * state["mu"]
        nu = (1 - b2) * g**2 + b2 * state["nu"]
        count = state["count"] + 1
        mu_hat = mu / _bias_correction(b1, count)
        nu_hat = nu / _bias_correction(b2, count)
        return mu_hat / (torch.sqrt(nu_hat + eps_root) + eps), dict(count=count, mu=mu, nu=nu)

    return GradientTransformation(init, update)


def polynomial_schedule(init_value, end_value, power, transition_steps):
    """``(init - end) * (1 - count / T)^power + end`` with the count clipped
    to [0, T]."""

    def schedule(count):
        count = min(max(count, 0), transition_steps)
        frac = 1 - count / transition_steps
        return (init_value - end_value) * (frac**power) + end_value

    return schedule


def scale_by_schedule(step_size_fn) -> GradientTransformation:
    """Multiplies the updates by ``step_size_fn(count)``."""

    def init(params):
        return dict(count=0)

    def update(g, state, params=None):
        return g * step_size_fn(state["count"]), dict(count=state["count"] + 1)

    return GradientTransformation(init, update)


def chain(*transforms) -> GradientTransformation:
    """Applies ``transforms`` in order."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(g, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            g, s = t.update(g, s, params)
            new_state.append(s)
        return g, tuple(new_state)

    return GradientTransformation(init, update)
