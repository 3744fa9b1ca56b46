"""Camera / simulation configuration and WCS grid math.

A numpy-only copy of :mod:`gigalens_tpu.config` (``SimulatorConfig`` and
``LensWCS``): the grid is centered so the mean RA/DEC over the
(supersampled) grid is 0, and ``transform_pix2angle`` maps (column, row)
pixel indices to angular offsets.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np


@dataclass
class SimulatorConfig:
    """Holds parameters for simulation.

    Attributes:
        delta_pix: pixel scale (angular size of one native pixel).
        num_pix: width of the simulated image in (native) pixels; int or (nx, ny).
        supersample: supersampling factor for rendering.
        kernel: optional PSF kernel sampled at the native pixel scale.
        transform_pix2angle: optional 2x2 affine pixel->angle matrix.
        pix_region: optional boolean mask of live native pixels.
        use_fft: legacy PSF switch — True (FFT), None (auto). False (direct
            convolution) is not ported yet.
        psf_mode: explicit PSF convolution path: "dft" (DFT-by-matmul with
            the supersample pool folded in; the hand-written kernel on CUDA),
            "fft" (``torch.fft``), or None (auto: dft on CUDA, fft
            elsewhere). Overrides use_fft when set.
        use_fused_render: fused deflect+render kernel for the EPL+Shear /
            SersicEllipse model family: True, False, or None (auto: on when
            the simulator's device is CUDA and the model matches the pattern).
    """

    delta_pix: float
    num_pix: Any
    supersample: int = 1
    kernel: Optional[Any] = None
    transform_pix2angle: Optional[Any] = None
    pix_region: Optional[Any] = None
    use_fft: Optional[bool] = None
    psf_mode: Optional[str] = None
    use_fused_render: Optional[bool] = None


class LensWCS:
    """Pixel <-> angle affine transform for a (possibly supersampled) grid."""

    def __init__(self, n, supersample=1, transform_pix2angle=None, pix_scale=1.0):
        if transform_pix2angle is None:
            transform_pix2angle = np.eye(2) * pix_scale
        transform_pix2angle = np.asarray(transform_pix2angle, np.float64)
        self.transform_pix2angle = transform_pix2angle / supersample
        self.transform_angle2pix = np.linalg.inv(self.transform_pix2angle)

        if isinstance(n, (int, np.integer)):
            self.n_x, self.n_y = int(n), int(n)
        else:
            self.n_x, self.n_y = int(n[0]), int(n[1])
        self.supersample = int(supersample)

        # Center the grid: index (low, low) maps to the most-negative corner so
        # that the mean coordinate over the grid is exactly (0, 0).
        low_x = -(self.n_x * self.supersample - 1) / 2.0
        low_y = -(self.n_y * self.supersample - 1) / 2.0
        self.radec_at_xy_0 = self.transform_pix2angle @ np.array([low_x, low_y])

    def pix2angle(self, x, y):
        """(column, row) indices -> (RA, DEC)."""
        xy = np.stack([np.asarray(x, np.float64), np.asarray(y, np.float64)], axis=0)
        radec = np.einsum("ij,j...->i...", self.transform_pix2angle, xy)
        radec = radec + self.radec_at_xy_0.reshape((2,) + (1,) * (radec.ndim - 1))
        return radec[0].astype(np.float32), radec[1].astype(np.float32)

    def angle2pix(self, ra, dec):
        radec = np.stack(
            [np.asarray(ra, np.float64), np.asarray(dec, np.float64)], axis=0
        )
        radec = radec - self.radec_at_xy_0.reshape((2,) + (1,) * (radec.ndim - 1))
        xy = np.einsum("ij,j...->i...", self.transform_angle2pix, radec)
        return xy.astype(np.float32)

    def pixel_grid(self):
        """Full supersampled coordinate grids, each shaped (ny*ss, nx*ss)."""
        x = np.arange(self.n_x * self.supersample)
        y = np.arange(self.n_y * self.supersample)
        X, Y = np.meshgrid(x, y)
        return self.pix2angle(X, Y)
