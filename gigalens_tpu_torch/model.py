"""Physical and probabilistic models (port of :mod:`gigalens_tpu.model`).

* :class:`PhysicalModel` bundles mass/light profile lists and fixed constants.
* :class:`ForwardProbModel` scores pixels with the forward-modeled
  Gaussian+Poisson noise map. The position, time-delay and flux
  likelihoods are not ported yet (ROADMAP M14) and raise.
* :class:`BackwardProbModel` scores pixels with the observed-image noise
  map and linear (lstsq) light amplitudes.

Log-densities are computed on the unconstrained matrix ``z`` of shape
``(bs, d)``; ``prior.constrain(z)`` maps it to the physical params tree and
the Jacobian factor is added, as in the JAX package.
"""
from __future__ import annotations

import math
import types
from typing import Dict, List, Optional

import numpy as np
import torch

from gigalens_tpu_torch.prob.prior import Prior
from gigalens_tpu_torch.profiles.base import LightProfile, MassProfile


def resolve_device(device) -> torch.device:
    """The device of a user entry point. ``None`` means the CUDA card and
    raises when there is none; the CPU runs only when asked for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device: pass device="cpu" to run on the CPU')
        device = "cuda"
    return torch.device(device)


class VersionedAttrs:
    """Bumps ``self._version`` on every attribute rebind, so the phase
    simulator memo (``inference/sequence.py``) never reuses a simulator built
    from an object's older attributes. In-place edits are not detected:
    replace attribute values, don't edit them."""

    def __setattr__(self, name, value):
        object.__setattr__(self, name, value)
        object.__setattr__(self, "_version", getattr(self, "_version", 0) + 1)


class PhysicalModel(VersionedAttrs):
    """Deflector + light profile lists with optional fixed constants.

    Constants are per-profile dicts of parameters excluded from inference,
    kept as float32 CPU tensors; the simulator moves them to its device.
    Multi-plane lensing (``lens_redshifts``) is not ported yet.
    """

    def __init__(
        self,
        lenses: List[MassProfile],
        lens_light: List[LightProfile],
        source_light: List[LightProfile],
        lenses_constants: Optional[List[Dict]] = None,
        lens_light_constants: Optional[List[Dict]] = None,
        source_light_constants: Optional[List[Dict]] = None,
        lens_redshifts=None,
    ):
        if lens_redshifts is not None:
            raise NotImplementedError(
                "multi-plane lensing is not ported yet (ROADMAP M14)"
            )
        self.lenses = list(lenses)
        self.lens_light = list(lens_light)
        self.source_light = list(source_light)

        def _conv(consts, profiles):
            if consts is None:
                consts = [dict() for _ in profiles]
            return [
                {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in d.items()}
                for d in consts
            ]

        self.lenses_constants = _conv(lenses_constants, lenses)
        self.lens_light_constants = _conv(lens_light_constants, lens_light)
        self.source_light_constants = _conv(source_light_constants, source_light)


class _SamplerFacade:
    """What the inference routines read off a probabilistic model besides its
    log-density, as in the JAX package: the likelihood terms it includes
    (the SMC selector reads them; pixels only until the position likelihood
    is ported), ``init_centroids``, ``log_prior`` and ``bij``."""

    include_pixels = True
    include_positions = False
    n_position = 0

    def init_centroids(self, bs):
        """API-compatible no-op: batch-leading broadcasting needs no
        per-batch centroid arrays."""
        return None

    def log_prior(self, z):
        """Unconstrained log prior of z (bs, d), Jacobian included."""
        return self.prior.log_prob_z(z)

    @property
    def bij(self):
        """Facade of the reference's bijector: ``bij.forward`` is
        ``prior.constrain``, ``bij.inverse`` on a constrained tree is
        ``prior.unconstrain``."""
        return types.SimpleNamespace(forward=self.prior.constrain,
                                     inverse=self.prior.unconstrain)


class ForwardProbModel(VersionedAttrs, _SamplerFacade):
    """Forward-modeled pixel likelihood.

    ``observed_image`` and the noise settings are stored as float32 tensors
    on ``device`` (``None``: the CUDA card, see :func:`resolve_device`).
    Pass ``error_map`` for a fixed noise map, or ``background_rms`` and
    ``exp_time`` for the model-based Gaussian+Poisson map.
    """

    def __init__(
        self,
        prior: Prior,
        observed_image=None,
        background_rms=None,
        exp_time=None,
        error_map=None,
        centroids_x=None,
        delays=None,
        image_fluxes=None,
        device=None,
    ):
        if centroids_x is not None or delays is not None or image_fluxes is not None:
            raise NotImplementedError(
                "position, time-delay and flux likelihoods are not ported yet "
                "(ROADMAP M14)"
            )
        if observed_image is None:
            raise ValueError("the port's ForwardProbModel scores pixels: "
                             "pass observed_image")
        self.prior = prior
        self.device = resolve_device(device)

        def f32(v):
            return torch.as_tensor(np.asarray(v, np.float32), device=self.device)

        self.observed_image = f32(observed_image)
        self.error_map = None
        self.background_rms = None
        self.exp_time = None
        if error_map is not None:
            self.error_map = f32(error_map)
        else:
            # float32-rounded Python scalars, like the JAX package's jnp.float32
            self.background_rms = float(np.float32(background_rms))
            self.exp_time = float(np.float32(exp_time))

    def event_size(self, simulator) -> int:
        """Number of observed scalars; normalizes the MAP loss."""
        return simulator.n_live_pix

    def stats_pixels(self, simulator, params):
        """(log_like, reduced_chi2) of the pixel data for constrained params."""
        im_sim = simulator.simulate(params)  # (bs, H, W)
        if self.error_map is not None:
            err_map = self.error_map
        else:
            # model-based Poisson term, clipped at zero flux: a pixel below
            # -background_rms^2 * exp_time would make the variance negative
            # and sqrt -> NaN poison the whole posterior
            err_map = torch.sqrt(
                self.background_rms**2 + torch.clamp(im_sim, min=0.0) / self.exp_time
            )
        mask = simulator.img_region
        resid = (im_sim - self.observed_image) / err_map
        chi2 = torch.sum(resid**2 * mask, dim=(-2, -1))
        normalization = torch.sum(
            torch.log(2 * math.pi * err_map**2) * mask, dim=(-2, -1)
        )
        log_like = -0.5 * (chi2 + normalization)
        return log_like, chi2 / simulator.n_live_pix

    def log_prob(self, simulator, z):
        """Unconstrained log posterior and reduced chi2; z shaped (bs, d)."""
        x = self.prior.constrain(z)
        log_like, red_chi2 = self.stats_pixels(simulator, x)
        log_prior = self.prior.log_prob(x) + self.prior.fldj(z)
        return log_like + log_prior, red_chi2

    def log_like(self, simulator, z):
        return self.stats_pixels(simulator, self.prior.constrain(z))[0]


class BackwardProbModel(VersionedAttrs, _SamplerFacade):
    """Likelihood with observed-image noise and lstsq linear amplitudes
    (pixels only: its position likelihood raises, as in JAX)."""

    def __init__(self, prior: Prior, observed_image, background_rms, exp_time, device=None):
        self.prior = prior
        self.device = resolve_device(device)
        obs = torch.as_tensor(np.asarray(observed_image, np.float32), device=self.device)
        err_map = torch.sqrt(float(background_rms) ** 2
                             + torch.clamp(obs, min=0.0) / float(exp_time))
        self.observed_image = obs
        self.err_map = err_map
        self._log_norm = -0.5 * torch.sum(torch.log(2 * math.pi * err_map**2))

    def event_size(self, simulator) -> int:
        """Number of observed scalars; normalizes the MAP loss."""
        return simulator.n_live_pix

    def stats_pixels(self, simulator, params):
        """(log_like, reduced_chi2) of the pixel data for constrained params;
        the linear amplitudes are solved by weighted least squares."""
        im_sim = simulator.lstsq_simulate(params, self.observed_image, self.err_map)
        resid = (im_sim - self.observed_image) / self.err_map
        chi2_pix = resid**2
        log_like = -0.5 * torch.sum(chi2_pix, dim=(-2, -1)) + self._log_norm
        return log_like, torch.mean(chi2_pix, dim=(-2, -1))

    def stats_positions(self, simulator, params):
        raise NotImplementedError(
            "BackwardProbModel has no multiple-image position likelihood; "
            "use ForwardProbModel for position terms (ROADMAP M14)"
        )

    def log_prob(self, simulator, z):
        """Unconstrained log posterior and reduced chi2; z shaped (bs, d)."""
        x = self.prior.constrain(z)
        log_like, red_chi2 = self.stats_pixels(simulator, x)
        log_prior = self.prior.log_prob(x) + self.prior.fldj(z)
        batch = z.shape[:-1]  # bs = 1 squeezes to scalars; match the batch
        return (torch.broadcast_to(log_like + log_prior, batch),
                torch.broadcast_to(red_chi2, batch))

    def log_like(self, simulator, z):
        return self.stats_pixels(simulator, self.prior.constrain(z))[0]
