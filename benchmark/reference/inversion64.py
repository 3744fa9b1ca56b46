"""Plain reference of ``inversion64``: the pixelated source's marginal
log posterior (Warren & Dye 2003; Suyu et al. 2006).

Per row of unconstrained parameters ``z`` (SIE + external shear, and the
regularisation strength ``lam``): the prior's constrained values and
Jacobian; the ray trace of every supersampled pixel; each source pixel's
basis image, the product of the separable bilinear hat weights of its grid
node at the traced positions, PSF-convolved ('SAME', the PSF resampled onto
the supersampled grid), mean-pooled to the native pixels and times the pixel
area: the blurred mapping matrix ``C`` (n_src, n_pix); then, with the noise
weights ``w = 1 / err^2`` of the observed-image noise map and the gradient
regulariser ``H`` (forward differences on the grid, a zero exterior ring),
``F = C diag(w) C^T + lam H``, ``b = C diag(w) d``, ``s = F^{-1} b`` by
Cholesky and

    log_marginal = -(sum w d^2 - b.s + log det F - n_src log lam
                     - log det H + sum log(2 pi err^2)) / 2.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from reference.plain import (Blur, PlainPrior, Precision, pixel_grid, sersic_ellipse,
                             shear_deflection, sie_deflection, subgrid_psf)


def native_psf(cfg):
    p = cfg["psf"]
    r = np.arange(p["size"]) - (p["size"] - 1) / 2
    k = np.exp(-(r[None, :] ** 2 + r[:, None] ** 2) / p["denominator"])
    return k / k.sum()


def regularizer(n):
    """(H, log det H): the Gram of the forward differences along both grid
    axes on the n x n nodes (row-major, y-major), each edge node also
    differenced against a zero exterior."""
    k = n * n
    rows = []
    idx = np.arange(k).reshape(n, n)
    for a, b in ((idx[:, :-1], idx[:, 1:]), (idx[:-1, :], idx[1:, :])):
        for i, j in zip(a.reshape(-1), b.reshape(-1)):
            rows.append((i, j))
    edges = np.concatenate([idx[:, 0], idx[:, -1], idx[0, :], idx[-1, :]])
    G = np.zeros((len(rows) + len(edges), k))
    for r, (i, j) in enumerate(rows):
        G[r, i], G[r, j] = -1.0, 1.0
    for r, i in enumerate(edges):
        G[len(rows) + r, i] = 1.0
    H = G.T @ G
    return H, float(np.linalg.slogdet(H)[1])


class Reference:
    """``log_prob(z)`` of (n, d) rows in ``precision`` on ``device``."""

    def __init__(self, cfg, obs, precision: Precision, device, rows_a_block=4):
        self.cfg, self.precision, self.device = cfg, precision, device
        dt = precision.dtype
        self.prior = PlainPrior(cfg["prior"])
        self.n_pix, self.ss = cfg["num_pix"], cfg["supersample"]
        self.x, self.y = pixel_grid(self.n_pix, cfg["delta_pix"], self.ss, dt, device)
        self.blur = Blur(subgrid_psf(native_psf(cfg), self.ss), self.ss, precision, device)
        self.area = cfg["delta_pix"] ** 2
        g = cfg["source_grid"]
        self.n_side, self.extent = g["n_side"], g["extent"]
        self.nodes = torch.linspace(-self.extent, self.extent, self.n_side, dtype=torch.float64,
                                    device=device).to(dt)
        self.delta = 2 * self.extent / (self.n_side - 1)
        H, self.logdet_H = regularizer(self.n_side)
        self.H = torch.as_tensor(H, dtype=dt, device=device)
        self.obs = torch.as_tensor(obs, device=device).to(dt).reshape(-1)
        err = torch.sqrt(cfg["background_rms"] ** 2
                         + torch.clamp(self.obs, min=0.0) / cfg["exp_time"])
        self.w = 1.0 / err**2
        self.norm = torch.sum(torch.log(2 * math.pi * err**2))
        self.event_size = self.n_pix * self.n_pix
        self.rows_a_block = rows_a_block

    def trace(self, lens):
        def col(p):
            return {k: v[:, None] for k, v in p.items()}

        ax, ay = sie_deflection(self.x, self.y, col(lens[0]))
        sx, sy = shear_deflection(self.x, self.y, col(lens[1]))
        return self.x - ax - sx, self.y - ay - sy

    def mapping(self, bx, by):
        """(n, n_src, n_pix) blurred mapping matrices of traced positions."""
        n, side = bx.shape[0], self.n_pix * self.ss
        wx = torch.clamp(1 - torch.abs(bx[:, None] - self.nodes[:, None]) / self.delta, min=0)
        wy = torch.clamp(1 - torch.abs(by[:, None] - self.nodes[:, None]) / self.delta, min=0)
        basis = (wy[:, :, None] * wx[:, None, :]).reshape(n, self.n_side**2, side, side)
        return (self.blur(basis) * self.area).reshape(n, self.n_side**2, -1)

    def log_marginal(self, C, lam):
        p = self.precision
        Cw = C * self.w
        F = p.matmul(Cw, C.mT) + lam[:, None, None] * self.H
        b = p.matmul(Cw, self.obs[:, None])
        L, info = torch.linalg.cholesky_ex(F)
        s = torch.cholesky_solve(b, L)
        logdet = 2 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), -1)
        quad = torch.sum(self.w * self.obs**2) - torch.sum(b[..., 0] * s[..., 0], -1)
        terms = (quad, logdet, -self.n_side**2 * torch.log(lam), -self.logdet_H + self.norm)
        lm = -0.5 * sum(terms)
        scale = 0.5 * sum(torch.abs(t) for t in terms[:3]) + 0.5 * abs(terms[3])
        resid = self.obs - p.matmul(s.mT, C)[:, 0]
        chi2 = torch.sum(self.w * resid**2, dim=-1)
        nan = torch.full_like(lm, float("nan"))
        ok = info == 0
        return (torch.where(ok, lm, nan), scale.detach(),
                torch.where(ok, chi2, nan).detach() / self.event_size)

    def log_prob(self, z):
        """{"lp": marginal log posterior, "scale", "red_chi2" at the solved
        source}, each (n,), of unconstrained rows ``z``, built
        ``rows_a_block`` rows at a time; the scale is the sum of the log
        posterior's terms' magnitudes, a size for its rounding that no
        cancellation between the terms makes small."""
        out = {"lp": [], "scale": [], "red_chi2": []}
        for i in range(0, z.shape[0], self.rows_a_block):
            zb = z[i:i + self.rows_a_block].to(self.precision.dtype)
            params = self.prior.constrain(zb)
            bx, by = self.trace(params["lens_mass"])
            lam = params["source_pixelated"][0]["lam"]
            lm, scale, red_chi2 = self.log_marginal(self.mapping(bx, by), lam)
            log_prior = self.prior.log_prob_z(zb)
            out["lp"].append(lm + log_prior)
            out["scale"].append(scale + torch.abs(log_prior.detach()))
            out["red_chi2"].append(red_chi2)
        return {k: torch.cat(v) for k, v in out.items()}


def observe(cfg, gen, device):
    """The seed's truth and data: the lens drawn from the prior, an
    elliptical Sersic source drawn from ``truth.source_prior``, rendered by
    this reference in float64 (no lens light), then Gaussian noise of the
    forward-modelled variance ``background_rms^2 + max(image, 0) /
    exp_time``. Returns ``{"obs": (H, W) float32, "truth_z": (d,) float64}``
    (``lam``'s column holds a prior draw: the data has no lam)."""
    f64 = Precision("float64")
    ref = Reference(cfg, torch.zeros((cfg["num_pix"],) * 2), f64, device)
    z = ref.prior.sample_z(gen, 1)
    src_prior = PlainPrior({"source": [cfg["truth"]["source_prior"]]})
    src = src_prior.constrain(src_prior.sample_z(gen, 1))["source"][0]
    bx, by = ref.trace(ref.prior.constrain(z)["lens_mass"])
    amp = src.pop("Ie")
    light = amp[:, None] * sersic_ellipse(bx, by, {k: v[:, None] for k, v in src.items()})
    side = cfg["num_pix"] * cfg["supersample"]
    img = (ref.blur(light.reshape(1, side, side)) * ref.area)[0]
    noise = torch.randn(img.shape, generator=gen, device=device, dtype=torch.float64)
    obs = img + noise * torch.sqrt(cfg["background_rms"] ** 2
                                   + torch.clamp(img, min=0.0) / cfg["exp_time"])
    return {"obs": obs.to(torch.float32), "truth_z": z[0]}
