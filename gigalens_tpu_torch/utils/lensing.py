"""Lens-analysis utilities: critical curves, caustics, Einstein radii (port
of :mod:`gigalens_tpu.utils.lensing`).

The fields (det A, kappa and the two Jacobian eigenvalues) are one
evaluation of the simulator's ``hessian`` on a grid, on the simulator's
device; the zero-contour extraction is a host-side marching-squares pass
(copied from the JAX package, numpy only), because contour topology is
data-dependent and outside the hot path.

All functions take a :class:`~gigalens_tpu_torch.simulator.LensSimulator`
(whose ``hessian`` / ``beta`` handle multi-plane stacks) and a
single-sample ``lens_params`` list of per-profile dicts with scalar leaves.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "jacobian_eigenvalues",
    "critical_curves",
    "caustics",
    "einstein_radius",
    "marching_squares",
]


def _scalarize(sim, lens_params: Sequence[Dict]) -> List[Dict]:
    """Leaves as float32 scalars on the simulator's device, so they
    broadcast against (N,) coordinates."""
    return [
        {k: torch.as_tensor(v, dtype=torch.float32, device=sim.device).reshape(())
         for k, v in p.items()}
        for p in lens_params
    ]


def _grid(extent: Tuple[float, float, float, float], n: int):
    x0, x1, y0, y1 = extent
    xs = np.linspace(x0, x1, n, dtype=np.float32)
    ys = np.linspace(y0, y1, n, dtype=np.float32)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    return xs, ys, X, Y


def _default_extent(sim) -> Tuple[float, float, float, float]:
    # the simulator's field of view (native pixels, centered WCS)
    half = 0.5 * sim.sim_config.num_pix * sim.sim_config.delta_pix
    return (-half, half, -half, half)


def _coords(sim, a):
    return torch.as_tensor(a, dtype=torch.float32, device=sim.device)


def _fields(sim, lens_params, x, y):
    """(det A, kappa, lambda_t, lambda_r) at (x, y), as numpy float64."""
    with torch.no_grad():
        f_xx, f_xy, f_yx, f_yy = sim.hessian(x, y, lens_params)
        det_a = (1 - f_xx) * (1 - f_yy) - f_xy * f_yx
        kappa = 0.5 * (f_xx + f_yy)
        # shear from the symmetrized Jacobian (exact for a single plane; for
        # multi-plane the antisymmetric rotation part is left out)
        g1 = 0.5 * (f_xx - f_yy)
        g2 = 0.5 * (f_xy + f_yx)
        gamma = torch.sqrt(g1 * g1 + g2 * g2)
        out = (det_a, kappa, 1.0 - kappa - gamma, 1.0 - kappa + gamma)
    return tuple(torch.broadcast_to(f, x.shape).cpu().numpy().astype(np.float64)
                 for f in out)


def jacobian_eigenvalues(sim, lens_params, x, y):
    """``(lambda_t, lambda_r)``: ``1 - kappa - gamma`` vanishes on the
    tangential critical curve, ``1 - kappa + gamma`` on the radial one;
    ``det A = lambda_t * lambda_r``."""
    _, _, lam_t, lam_r = _fields(sim, _scalarize(sim, lens_params), _coords(sim, x),
                                 _coords(sim, y))
    return lam_t, lam_r


def marching_squares(values: np.ndarray, xs: np.ndarray, ys: np.ndarray,
                     level: float = 0.0) -> List[np.ndarray]:
    """Zero-level contours of ``values[j, i]`` sampled at ``(xs[i], ys[j])``.

    Linear-interpolation marching squares with midpoint disambiguation of
    saddle cells; segments are stitched into polylines. Returns a list of
    ``(k, 2)`` float arrays of (x, y) vertices, closed curves repeating their
    first vertex. Self-contained (no scikit-image in this environment).
    """
    v = np.asarray(values, np.float64) - level
    ny, nx = v.shape
    # Nudge grid nodes sitting exactly on the level: a zero corner is neither
    # strictly inside nor outside, which otherwise produces zero-length
    # segments and 4-way junctions that break stitching (a circle sampled so
    # its radius lands on nodes fragments into many polylines).
    finite = np.isfinite(v)
    scale = np.max(np.abs(v[finite])) if finite.any() else 1.0
    if scale == 0.0:
        return []
    v = np.where(finite & (v == 0.0), 1e-12 * scale, v)

    # Each contour vertex lies on one global grid edge; keying segments by
    # that edge identity makes stitching exact — both adjacent cells reference
    # the same vertex regardless of floating-point interpolation order.
    # Grid-edge keys: ("h", i, j) joins nodes (i,j)-(i+1,j); ("v", i, j)
    # joins (i,j)-(i,j+1).
    verts: Dict[tuple, Tuple[float, float]] = {}
    segments: List[Tuple[tuple, tuple]] = []

    def interp(p0, p1, v0, v1):
        t = v0 / (v0 - v1)
        return (p0[0] + t * (p1[0] - p0[0]), p0[1] + t * (p1[1] - p0[1]))

    for j in range(ny - 1):
        for i in range(nx - 1):
            c = [v[j, i], v[j, i + 1], v[j + 1, i + 1], v[j + 1, i]]
            if not (np.isfinite(c).all()):
                continue
            idx = sum(1 << k for k in range(4) if c[k] > 0)
            if idx in (0, 15):
                continue
            P = [
                (xs[i], ys[j]),
                (xs[i + 1], ys[j]),
                (xs[i + 1], ys[j + 1]),
                (xs[i], ys[j + 1]),
            ]
            # cell edge k connects corner k and corner (k+1)%4; its global
            # grid-edge identity (shared with the neighboring cell):
            EDGE_KEYS = (
                ("h", i, j),
                ("v", i + 1, j),
                ("h", i, j + 1),
                ("v", i, j),
            )
            E = {}
            for k in range(4):
                a, b = k, (k + 1) % 4
                if (c[a] > 0) != (c[b] > 0):
                    ek = EDGE_KEYS[k]
                    if ek not in verts:
                        # canonical corner order (lower/left node first) so
                        # both adjacent cells compute the identical point
                        if k in (0, 2):  # horizontal edges: corner order ok
                            lo, hi = (a, b) if P[a][0] < P[b][0] else (b, a)
                        else:  # vertical edges
                            lo, hi = (a, b) if P[a][1] < P[b][1] else (b, a)
                        verts[ek] = interp(P[lo], P[hi], c[lo], c[hi])
                    E[k] = ek
            if idx in (5, 10):
                # saddle: split by the cell-center sign
                center_pos = (c[0] + c[1] + c[2] + c[3]) / 4.0 > 0
                if (idx == 5) == center_pos:
                    segments += [(E[0], E[1]), (E[2], E[3])]
                else:
                    segments += [(E[0], E[3]), (E[1], E[2])]
            else:
                ks = sorted(E)
                segments.append((E[ks[0]], E[ks[1]]))

    # stitch segments into polylines by shared grid-edge identity
    ends: Dict[tuple, list] = {}
    for s_i, (a, b) in enumerate(segments):
        ends.setdefault(a, []).append(s_i)
        ends.setdefault(b, []).append(s_i)

    used = [False] * len(segments)
    curves = []
    for start in range(len(segments)):
        if used[start]:
            continue
        used[start] = True
        a, b = segments[start]
        line = [a, b]
        # grow forward from both ends
        for grow_end in (True, False):
            while True:
                tip = line[-1] if grow_end else line[0]
                cand = [s for s in ends.get(tip, []) if not used[s]]
                if not cand:
                    break
                s = cand[0]
                used[s] = True
                p, q = segments[s]
                nxt = q if p == tip else p
                if grow_end:
                    line.append(nxt)
                else:
                    line.insert(0, nxt)
        curves.append(np.asarray([verts[ek] for ek in line], np.float64))
    return curves


def critical_curves(sim, lens_params, extent=None, n: int = 400,
                    which: str = "det") -> List[np.ndarray]:
    """Critical curves of the deflector stack in the image plane.

    ``which``: ``"det"`` (zeros of det A), ``"tangential"`` (zeros of
    ``1 - kappa - gamma``) or ``"radial"`` (``1 - kappa + gamma``). Returns
    polylines of (x, y) resolved on an ``n x n`` grid over ``extent = (x0,
    x1, y0, y1)`` (default: the simulator's field of view)."""
    if extent is None:
        extent = _default_extent(sim)
    xs, ys, X, Y = _grid(extent, n)
    det_a, _, lam_t, lam_r = _fields(sim, _scalarize(sim, lens_params),
                                     _coords(sim, X.ravel()), _coords(sim, Y.ravel()))
    field = {"det": det_a, "tangential": lam_t, "radial": lam_r}[which]
    return marching_squares(field.reshape(n, n), xs, ys)


def caustics(sim, lens_params, extent=None, n: int = 400,
             which: str = "tangential") -> List[np.ndarray]:
    """Source-plane caustics: the critical curves ray-shot through the lens."""
    curves = critical_curves(sim, lens_params, extent=extent, n=n, which=which)
    lp = _scalarize(sim, lens_params)
    out = []
    with torch.no_grad():
        for c in curves:
            bx, by = sim.beta(_coords(sim, c[:, 0]), _coords(sim, c[:, 1]), lp)
            out.append(np.stack([bx.cpu().numpy(), by.cpu().numpy()], axis=-1)
                       .astype(np.float64))
    return out


def einstein_radius(sim, lens_params, extent=None, n: int = 400) -> float:
    """Effective Einstein radius: the radius where the mean enclosed
    convergence is 1 (about the convergence-weighted centroid, by the
    running pixel mean of kappa sorted by radius; equals ``theta_E`` for
    circular isothermal profiles). NaN when the mean never crosses 1."""
    if extent is None:
        extent = _default_extent(sim)
    xs, ys, X, Y = _grid(extent, n)
    _, k, _, _ = _fields(sim, _scalarize(sim, lens_params), _coords(sim, X.ravel()),
                         _coords(sim, Y.ravel()))
    # drop non-finite pixels (kappa -> inf on a lens center at a grid node)
    finite = np.isfinite(k)
    if not finite.all():
        k = k[finite]
        Xf, Yf = X.ravel()[finite], Y.ravel()[finite]
    else:
        Xf, Yf = X.ravel(), Y.ravel()
    w = np.clip(k, 0, None)
    if w.sum() <= 0:
        return float("nan")
    cx = float((w * Xf).sum() / w.sum())
    cy = float((w * Yf).sum() / w.sum())
    r = np.hypot(Xf - cx, Yf - cy)
    order = np.argsort(r)
    mean_k = np.cumsum(k[order]) / np.arange(1, k.size + 1)
    r_sorted = r[order]
    # ignore the innermost pixels, where the discrete mean is noisy
    lo = max(8, int(0.0001 * k.size))
    below = np.nonzero(mean_k[lo:] < 1.0)[0]
    if below.size == 0 or below[0] == 0:
        return float("nan")
    i = lo + below[0]
    # linear interpolation in r across the crossing
    m0, m1 = mean_k[i - 1], mean_k[i]
    t = (m0 - 1.0) / (m0 - m1) if m0 != m1 else 0.5
    return float(r_sorted[i - 1] + t * (r_sorted[i] - r_sorted[i - 1]))
