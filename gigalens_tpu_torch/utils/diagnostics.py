"""Posterior diagnostics: split R-hat and ESS (port of
:mod:`gigalens_tpu.utils.diagnostics`).

Both are host-side post-processing in numpy (float64), on a
``(n_steps, n_chains, d)`` array or tensor (a CUDA tensor is copied to the
host once).
"""
from __future__ import annotations

import numpy as np
import torch


def _host(chains):
    if isinstance(chains, torch.Tensor):
        chains = chains.detach().cpu().numpy()
    return np.asarray(chains, np.float64)


def potential_scale_reduction(chains, split: bool = True):
    """Gelman-Rubin R-hat. ``chains``: (n_steps, n_chains, d) -> (d,).

    ``split=True`` computes split-R-hat (each chain halved), which also
    detects within-chain nonstationarity.
    """
    chains = _host(chains)
    n, m, d = chains.shape
    if split:
        half = n // 2
        chains = np.concatenate([chains[:half], chains[half:2 * half]], axis=1)
        n, m = half, 2 * m

    chain_means = np.mean(chains, axis=0)            # (m, d)
    grand_mean = np.mean(chain_means, axis=0)        # (d,)
    B = n / (m - 1) * np.sum((chain_means - grand_mean) ** 2, axis=0)
    W = np.mean(np.var(chains, axis=0, ddof=1), axis=0)
    var_hat = (n - 1) / n * W + B / n
    return np.sqrt(var_hat / W)


def _autocorrelation(x):
    """Autocorrelation along axis 0 via FFT."""
    n = x.shape[0]
    x = x - np.mean(x, axis=0, keepdims=True)
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(x, n=nfft, axis=0)
    acov = np.fft.irfft(f * np.conj(f), n=nfft, axis=0)[:n]
    return acov / acov[:1]


def effective_sample_size(chains, cross_chain: bool = True):
    """ESS with Geyer's initial monotone positive sequence truncation.

    ``chains``: (n_steps, n_chains, d) -> (d,) total effective samples.
    """
    chains = _host(chains)
    n, m, d = chains.shape
    rho = np.mean(_autocorrelation(chains), axis=1)  # (n, d) chain-averaged

    # Geyer: sum consecutive-pair autocorrelations while positive & decreasing
    n_pairs = n // 2
    pair = rho[0:2 * n_pairs:2] + rho[1:2 * n_pairs:2]  # (n_pairs, d)
    pair = np.minimum(pair, np.minimum.accumulate(pair, axis=0))  # monotone
    pair = np.maximum(pair, 0.0)  # positive
    tau = -1.0 + 2.0 * np.sum(pair, axis=0)
    tau = np.maximum(tau, 1.0 / n)
    return (n * m) / tau
