"""ModellingSequence: the MAP -> SVI -> HMC pipeline facade
(port of :mod:`gigalens_tpu.inference.sequence`).

Only the MAP phase is ported; SVI, HMC, SMC and the Laplace initializer
raise ``NotImplementedError`` naming their ROADMAP item. Each phase builds
its own ``LensSimulator`` with the right batch size, like the reference.
"""
from __future__ import annotations

import dataclasses

import torch

from gigalens_tpu_torch.inference.map import best_start, fit_map
from gigalens_tpu_torch.inference.optim import GradientTransformation
from gigalens_tpu_torch.simulator import LensSimulator


def phase_simulator(cache: dict, sim_config, phys_model, bs: int,
                    exact: bool = False, device="cpu") -> LensSimulator:
    """Memoized phase simulator. ``exact=True`` (the HMC/SMC path) pins the
    auto PSF mode to the FFT: the JAX package measured its DFT-by-matmul
    path (single bf16 pass on the TPU) at ~0.3 nats of likelihood noise,
    fatal to Metropolis acceptance, and keeps the exact path on the FFT.
    Explicit ``sim_config`` choices are always respected.

    A memo hit requires the SAME config/model objects (identity, plus the
    model's attribute version), so rebinding either after a phase call never
    reuses a simulator built from the old configuration."""
    device = torch.device(device)
    key = (bs, exact, str(device), getattr(phys_model, "_version", 0))
    hit = cache.get(key)
    if hit is not None and hit[0] is sim_config and hit[1] is phys_model:
        return hit[2]
    cfg = sim_config
    if exact and cfg.psf_mode is None and cfg.use_fft is None:
        cfg = dataclasses.replace(cfg, psf_mode="fft")
    sim = LensSimulator(phys_model, cfg, bs=bs, device=device)
    cache[key] = (sim_config, phys_model, sim)
    return sim


def _not_ported(what, item):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


class ModellingSequence:
    def __init__(self, phys_model, prob_model, sim_config, device="cpu"):
        self.phys_model = phys_model
        self.prob_model = prob_model
        self.sim_config = sim_config
        self.device = torch.device(device)
        self._sims = {}

    def _sim(self, bs: int, exact: bool = False) -> LensSimulator:
        """See :func:`phase_simulator` for the exact/fast PSF-path policy."""
        return phase_simulator(self._sims, self.sim_config, self.phys_model,
                               bs, exact, self.device)

    def MAP(
        self,
        optimizer: GradientTransformation,
        start=None,
        n_samples: int = 500,
        num_steps: int = 350,
        seed: int = 0,
    ):
        """Multi-start MAP; returns the (n_samples, d) final z."""
        sim = self._sim(n_samples)
        z, _ = fit_map(
            self.prob_model, sim, optimizer, start=start, n_samples=n_samples,
            num_steps=num_steps, seed=seed,
        )
        return z

    def best_map_start(self, z):
        """Highest-posterior MAP sample, shaped (1, d)."""
        return best_start(self.prob_model, self._sim(z.shape[0]), z)

    def laplace_scale_tril(self, z_best, method: str = "fd"):
        _not_ported("laplace_scale_tril", "M8")

    def SVI(self, *args, **kwargs):
        _not_ported("SVI", "M9")

    def HMC(self, *args, **kwargs):
        _not_ported("HMC", "M10")

    def SMC(self, *args, **kwargs):
        _not_ported("SMC", "M16")
