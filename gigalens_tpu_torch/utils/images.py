"""Lens-equation image finding (port of :mod:`gigalens_tpu.utils.images`).

Solves ``beta(theta) = beta_src`` for all images of a source position,
which builds position-likelihood inputs consistent with the pixel data.
Grid-scan candidates (local minima of the source-plane distance over the
simulator's supersampled grid) are Newton-refined on the lens equation
with the Jacobian ``A = I - hessian``.

The Newton loop runs on the host in float64 (the 2x2 solves, the
positions); ``beta`` and ``hessian`` are evaluated in float32 on the
simulator's device, one call each an iteration for all candidates at once.
Each candidate follows the JAX package's per-candidate loop step for step:
it stops where that loop breaks and is left unchanged after.
"""
from __future__ import annotations

import numpy as np
import torch


def find_images(
    simulator,
    lens_params,
    src_x: float,
    src_y: float,
    search_window: float = 4.0,
    newton_iters: int = 20,
    residual_tol: float = 1e-8,
    dedupe_scale: float = None,
):
    """All image-plane solutions of the lens equation for one source point.

    ``simulator``: a ``LensSimulator`` (its supersampled grid seeds the
    search); ``lens_params``: list of per-profile dicts with length-1
    leaves (one lens model). ``search_window`` (in pixels) bounds how far a
    grid candidate may sit from the source-plane target; ``residual_tol`` is
    the squared source-plane residual accepted as an image; ``dedupe_scale``
    (default: one pixel) merges duplicate convergence basins.

    Returns ``(img_x, img_y, magnifications)`` float32 numpy arrays (sorted
    by |magnification|, brightest first).
    """
    from scipy.ndimage import minimum_filter

    dev = simulator.device
    wcs = simulator.wcs
    delta_pix = float(
        np.sqrt(abs(np.linalg.det(wcs.transform_pix2angle))) * wcs.supersample
    )  # native pixel scale
    dedupe = delta_pix if dedupe_scale is None else float(dedupe_scale)
    lens_params = [
        {k: torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(1)
         for k, v in p.items()}
        for p in lens_params
    ]

    def fields(x, y):
        """beta residuals and the Jacobian entries at float64 (x, y), each
        evaluated at the float32 positions; numpy float64 (n,) arrays."""
        xt = torch.as_tensor(np.asarray(x, np.float32), device=dev)
        yt = torch.as_tensor(np.asarray(y, np.float32), device=dev)
        with torch.no_grad():
            bx, by = simulator.beta(xt, yt, lens_params)
            h = simulator.hessian(xt, yt, lens_params)
        out = [torch.broadcast_to(t, (1, xt.shape[0]))[0] for t in (bx, by, *h)]
        return [t.double().cpu().numpy() for t in out]

    gx = simulator.img_x.cpu().numpy()
    gy = simulator.img_y.cpu().numpy()
    bx, by = fields(gx, gy)[:2]
    d2 = ((bx - src_x) ** 2 + (by - src_y) ** 2).reshape(simulator.h_ss, simulator.w_ss)
    cand = (d2 == minimum_filter(d2, size=5)) & (d2 < (search_window * delta_pix) ** 2)
    rr, cc = np.where(cand)
    x = gx.reshape(simulator.h_ss, simulator.w_ss)[rr, cc].astype(np.float64)
    y = gy.reshape(simulator.h_ss, simulator.w_ss)[rr, cc].astype(np.float64)

    active = np.ones(x.shape, bool)
    for _ in range(newton_iters):
        if not active.any():
            break
        bxi, byi, fxx, fxy, fyx, fyy = fields(x, y)
        res = np.stack([bxi - src_x, byi - src_y], axis=-1)
        a = np.stack([np.stack([1 - fxx, -fxy], -1), np.stack([-fyx, 1 - fyy], -1)], -2)
        det = np.linalg.det(a)
        # a candidate on a critical curve or off to a non-finite residual stops
        active &= ~((np.abs(det) < 1e-8) | ~np.isfinite(res).all(-1))
        if not active.any():
            break
        step = np.linalg.solve(a[active], res[active][..., None])[..., 0]
        x[active] -= step[:, 0]
        y[active] -= step[:, 1]
        active[active] = np.sum(res[active] ** 2, -1) >= 1e-12

    found = []
    if x.size:
        bxi, byi, fxx, fxy, fyx, fyy = fields(x, y)
        res2 = (bxi - src_x) ** 2 + (byi - src_y) ** 2
        for i in range(x.size):
            if res2[i] < residual_tol and all(
                (x[i] - px) ** 2 + (y[i] - py) ** 2 > dedupe**2 for px, py, _ in found
            ):
                det = (1 - fxx[i]) * (1 - fyy[i]) - fxy[i] * fyx[i]
                found.append((x[i], y[i], 1.0 / det if det != 0 else np.inf))

    found.sort(key=lambda t: -abs(t[2]))
    img_x = np.asarray([t[0] for t in found], np.float32)
    img_y = np.asarray([t[1] for t in found], np.float32)
    mags = np.asarray([t[2] for t in found], np.float32)
    return img_x, img_y, mags
