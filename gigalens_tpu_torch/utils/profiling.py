"""Tracing / timing helpers (port of :mod:`gigalens_tpu.utils.profiling`).

``span`` names a stretch of the port's work in a ``torch.profiler`` trace,
and costs a flag check when no profiler runs. ``trace`` wraps ``torch.profiler`` (host and, where there is one, CUDA
activity) and writes a Chrome trace into ``log_dir`` for Perfetto or
``chrome://tracing``; ``timed`` gives device timings that wait for the
card (``torch.cuda.synchronize``) before each clock read, with the warmup
calls excluded; ``PhaseTimer`` collects named phase wall-clocks.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

_NO_SPAN = contextlib.nullcontext()


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def span(name: str, args: str | None = None):
    """``with span("prior.constrain"): ...``: a ``record_function`` range
    while a torch profiler runs, else nothing (torch's profiler ops are
    not entered). Names are ``<layer>.<what>`` from a fixed vocabulary
    (``map.step``, ``map.backward``, ``map.update``, ``likelihood.log_prob``,
    ``prior.constrain`` / ``log_prob`` / ``fldj``, ``simulator.render`` /
    ``psf`` / ``lstsq`` / ``render_backward`` / ``lstsq_backward``; the
    kernels' ``direct_conv_fwd`` / ``direct_conv_transpose`` and the
    inversion's ``inversion.*``): what varies from call to call, such as
    a step's index, goes in ``args``, never in the name."""
    if _autograd_profiler._is_profiler_enabled:
        return record_function(name, args)
    return _NO_SPAN


@contextlib.contextmanager
def trace(log_dir: str):
    """Profiles the enclosed block, ``with trace('traces/map'): run()``,
    and writes ``log_dir/trace.json`` on exit; yields the profiler (its
    ``key_averages()`` has the per-op and per-kernel times)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def timed(fn: Callable, *args, warmup: int = 1, repeats: int = 10, **kwargs):
    """Returns (mean_seconds, last_result) over ``repeats`` calls after
    ``warmup`` calls, the card synchronized before each clock read."""
    result = None
    for _ in range(max(warmup, 0)):
        result = fn(*args, **kwargs)
    _sync()
    t0 = time.perf_counter()
    for _ in range(repeats):
        result = fn(*args, **kwargs)
    _sync()
    return (time.perf_counter() - t0) / repeats, result


class PhaseTimer:
    """Collects named phase wall-clocks; prints a one-line summary."""

    def __init__(self):
        self.phases = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def summary(self) -> str:
        total = sum(self.phases.values())
        parts = " ".join(f"{k}={v:.1f}s" for k, v in self.phases.items())
        return f"{parts} total={total:.1f}s"
