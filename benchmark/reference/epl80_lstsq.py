"""Plain reference of ``epl80_lstsq``: the lstsq family's log posterior.

Per row of unconstrained parameters ``z``: the prior's constrained values
and Jacobian; the EPL + external shear ray trace of every supersampled
pixel; the elliptical Sersic lens light and the n_max-4 shapelets of the
source at the traced positions, each a unit-amplitude component image;
each component PSF-convolved ('SAME', the PSF resampled onto the
supersampled grid) and mean-pooled to the native pixels, times the pixel
area; the weighted least-squares amplitudes of the components against the
data (the normal equations with a pseudo-inverse at the configuration's
relative cutoff, in the solve's precision); and the Gaussian pixel
likelihood under the observed-image noise map
``sqrt(background_rms^2 + max(data, 0) / exp_time)``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from reference.plain import (Blur, PlainPrior, Precision, epl_deflection, pinv, pixel_grid,
                             sersic_ellipse, shapelet_basis, shear_deflection, subgrid_psf)


def native_psf(cfg):
    """The configuration's Gaussian PSF on its native pixels (float64)."""
    p = cfg["psf"]
    r = np.arange(p["size"]) - (p["size"] - 1) / 2
    k = np.exp(-(r[None, :] ** 2 + r[:, None] ** 2) / p["denominator"])
    return k / k.sum()


class Reference:
    """``log_prob(z)`` of (n, d) rows in ``precision`` on ``device``."""

    def __init__(self, cfg, obs, precision: Precision, device):
        self.cfg, self.precision, self.device = cfg, precision, device
        dt = precision.dtype
        self.prior = PlainPrior(cfg["prior"])
        self.n_pix, self.ss = cfg["num_pix"], cfg["supersample"]
        self.x, self.y = pixel_grid(self.n_pix, cfg["delta_pix"], self.ss, dt, device)
        self.blur = Blur(subgrid_psf(native_psf(cfg), self.ss), self.ss, precision, device)
        self.area = cfg["delta_pix"] ** 2
        self.obs = torch.as_tensor(obs, device=device).to(dt)
        self.err = torch.sqrt(cfg["background_rms"] ** 2
                              + torch.clamp(self.obs, min=0.0) / cfg["exp_time"])
        self.log_norm = -0.5 * torch.sum(torch.log(2 * math.pi * self.err**2))
        self.event_size = self.n_pix * self.n_pix

    def components(self, params):
        """(n, depth, H, W) unit-amplitude component images of ``params``."""
        cfg = self.cfg

        def col(p):
            return {k: v[:, None] for k, v in p.items()}

        lens, light, src = (params[g][0] for g in ("lens_mass", "lens_light", "source_light"))
        ax, ay = epl_deflection(self.x, self.y, col(lens), cfg["lens_mass"][0][1]["niter"])
        sx, sy = shear_deflection(self.x, self.y, col(params["lens_mass"][1]))
        bx, by = self.x - ax - sx, self.y - ay - sy
        comps = [sersic_ellipse(self.x, self.y, col(light))]
        comps += shapelet_basis(bx, by, col(src), cfg["source_light"][0][1]["n_max"])
        n, side = bx.shape[0], self.n_pix * self.ss
        flat = torch.stack([torch.broadcast_to(c, bx.shape) for c in comps], dim=1)
        img = torch.nan_to_num(flat.reshape(n, len(comps), side, side))
        return self.blur(img) * self.area

    def model(self, comps):
        """(n, H, W) model images: the components at their weighted
        least-squares amplitudes."""
        n, depth = comps.shape[:2]
        X = (comps / self.err).reshape(n, depth, -1).mT  # (n, P, depth)
        Y = (self.obs / self.err).reshape(1, -1, 1)
        Xs, Ys = X.to(self.precision.wide), Y.to(self.precision.wide)
        gram = self.precision.matmul(Xs.mT, Xs)
        coeffs = (pinv(gram, self.cfg["lstsq_rtol"]) @ self.precision.matmul(Xs.mT, Ys))
        return torch.einsum("ndhw,nd->nhw", comps, coeffs[..., 0].to(comps.dtype))

    def log_prob(self, z):
        """{"lp": log posterior, "scale", "red_chi2"}, each (n,), of
        unconstrained rows ``z``; the scale is the sum of the log posterior's
        terms' magnitudes, a size for its rounding that no cancellation
        between the terms makes small."""
        z = z.to(self.precision.dtype)
        params = self.prior.constrain(z)
        resid = (self.model(self.components(params)) - self.obs) / self.err
        chi2 = torch.sum(resid**2, dim=(-2, -1))
        log_prior = self.prior.log_prob_z(z)
        scale = 0.5 * chi2 + torch.abs(self.log_norm) + torch.abs(log_prior)
        return {"lp": -0.5 * chi2 + self.log_norm + log_prior, "scale": scale.detach(),
                "red_chi2": chi2.detach() / self.event_size}


def observe(cfg, gen, device):
    """The seed's truth and data: a prior draw of the nonlinear parameters,
    the lens light at ``truth.lens_light_amp`` and the shapelet amplitudes
    ``truth.shapelet_scale`` times standard normals, rendered by this
    reference in float64, then Gaussian noise of the forward-modelled
    variance ``background_rms^2 + max(image, 0) / exp_time``. Returns
    ``{"obs": (H, W) float32, "truth_z": (d,) float64}``."""
    ref = Reference(cfg, torch.zeros((cfg["num_pix"],) * 2), Precision("float64"), device)
    z = ref.prior.sample_z(gen, 1)
    comps = ref.components(ref.prior.constrain(z))[0]
    t = cfg["truth"]
    amps = torch.cat([torch.full((1,), t["lens_light_amp"], dtype=torch.float64, device=device),
                      t["shapelet_scale"] * torch.randn(comps.shape[0] - 1, generator=gen,
                                                        device=device, dtype=torch.float64)])
    img = torch.einsum("dhw,d->hw", comps, amps)
    noise = torch.randn(img.shape, generator=gen, device=device, dtype=torch.float64)
    obs = img + noise * torch.sqrt(cfg["background_rms"] ** 2
                                   + torch.clamp(img, min=0.0) / cfg["exp_time"])
    return {"obs": obs.to(torch.float32), "truth_z": z[0]}
