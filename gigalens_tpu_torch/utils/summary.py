"""Named posterior summaries (port of :mod:`gigalens_tpu.utils.summary`).

The :class:`~gigalens_tpu_torch.prob.prior.Prior` knows its column names,
so a fitted chain is summarized in physical-parameter terms: means,
stddevs, quantiles, split-R-hat, ESS and divergence counts, keyed by
``lens_mass/0/theta_E``-style names.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gigalens_tpu_torch.utils.diagnostics import (
    effective_sample_size,
    potential_scale_reduction,
)


def summarize_posterior(
    prior,
    samples,
    quantiles=(0.05, 0.5, 0.95),
    divergences=None,
) -> Dict[str, dict]:
    """Per-parameter posterior summary in *constrained* (physical) space.

    ``samples``: (num_results, n_chains, d) unconstrained draws
    (``HMCResult.samples``) or (n, d) flat draws. R-hat/ESS need the chain
    axis and are reported only for 3-D input. Returns ``{name: {mean, std,
    q05, q50, q95, rhat, ess}}`` plus a ``"_global"`` entry with max R-hat /
    min ESS / total divergences.
    """
    if isinstance(samples, torch.Tensor):
        samples = samples.detach().cpu().numpy()
    samples = np.asarray(samples, np.float32)
    chains = samples.ndim == 3
    d = samples.shape[-1]
    names = prior.column_names()
    assert len(names) == d, f"{len(names)} names vs d={d}"

    # constrain through the prior's bijectors on the host, in float32
    x = prior.constrain(torch.from_numpy(samples.reshape(-1, d)))
    cols = _constrained_matrix(prior, x).numpy()

    if chains:
        rhat = potential_scale_reduction(samples)
        ess = effective_sample_size(samples)
    out: Dict[str, dict] = {}
    qlabels = [f"q{int(round(100 * q)):02d}" for q in quantiles]
    for j, name in enumerate(names):
        c = cols[:, j]
        row = dict(mean=float(c.mean()), std=float(c.std()))
        for ql, q in zip(qlabels, quantiles):
            row[ql] = float(np.quantile(c, q))
        if chains:
            row["rhat"] = float(rhat[j])
            row["ess"] = float(ess[j])
        out[name] = row
    g = {}
    if chains:
        g["max_rhat"] = float(rhat.max())
        g["min_ess"] = float(ess.min())
    if divergences is not None:
        if isinstance(divergences, torch.Tensor):
            divergences = divergences.detach().cpu().numpy()
        g["divergences"] = int(np.asarray(divergences).sum())
    out["_global"] = g
    return out


def _constrained_matrix(prior, x):
    """Flattens a constrained params tree back to the (n, d) column matrix
    in the prior's column order (the packing ``constrain`` reads)."""
    cols = []
    for leaf, v in zip(prior.leaves, prior._flatten_like(x)):
        n = v.shape[0] if v.ndim else 1
        cols.append(v.reshape(n, leaf.event_size))
    return torch.cat(cols, dim=1)


def format_summary(summary: Dict[str, dict], digits: int = 4) -> str:
    """Plain-text table of :func:`summarize_posterior` output."""
    rows = [(k, v) for k, v in summary.items() if k != "_global"]
    keys = list(rows[0][1].keys()) if rows else []
    w = max((len(k) for k, _ in rows), default=4)
    lines = [" " * w + "  " + "  ".join(f"{k:>10}" for k in keys)]
    for name, v in rows:
        lines.append(
            f"{name:<{w}}  " + "  ".join(f"{v[k]:>10.{digits}g}" for k in keys)
        )
    g = summary.get("_global", {})
    if g:
        lines.append("  ".join(f"{k}={v:g}" for k, v in g.items()))
    return "\n".join(lines)
