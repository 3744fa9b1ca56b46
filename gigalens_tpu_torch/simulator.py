"""Batched differentiable lens simulator (port of :mod:`gigalens_tpu.simulator`).

Renders ``(bs, H, W)`` observed-frame images from batch-leading parameter
trees: ray-shoot the supersampled grid through the mass profiles, evaluate
the light profiles in the source plane, PSF-convolve, pool to native pixels.

Parameter convention: ``params`` is a dict with keys ``lens_mass``,
``lens_light``, ``source_light``, each a list of per-profile dicts whose
leaves are shaped ``(bs,)``; leaves broadcast against the ``(npix,)``
coordinates as ``(bs, 1)``.

For the EPL+Shear + SersicEllipse (+ SersicEllipse lens light) family the
whole flat-light render runs as the fused CUDA kernel on a CUDA device
(``ops/cuda/fused_render.py``). Not ported yet: multi-plane ray tracing,
the lensing-field helpers (hessian, magnification, potential), the
composable fused builder, SIE-as-EPL(gamma=2) fusion and ``lstsq_simulate``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

import gigalens_tpu_torch.model as gmodel
from gigalens_tpu_torch.config import LensWCS, SimulatorConfig
from gigalens_tpu_torch.ops.cuda.fused_render import fused_render, pack_params
from gigalens_tpu_torch.ops.psf import PSFConv, average_pool, subgrid_kernel
from gigalens_tpu_torch.profiles.light.sersic import SersicEllipse
from gigalens_tpu_torch.profiles.mass.epl import EPL
from gigalens_tpu_torch.profiles.mass.shear import Shear


def _batched(p: Dict):
    """Appends a broadcast axis to each (bs,)-shaped leaf: (bs,) -> (bs, 1)."""
    return {k: v[..., None] for k, v in p.items()}


class LensSimulator(gmodel.VersionedAttrs):
    """Batched differentiable lens simulator for a fixed camera, batch size
    and device."""

    def __init__(
        self,
        phys_model: "gmodel.PhysicalModel",
        sim_config: SimulatorConfig,
        bs: int,
        device="cpu",
    ):
        if any(p.use_lstsq for p in phys_model.lens_light + phys_model.source_light):
            raise NotImplementedError(
                "linear (lstsq) light amplitudes are not ported yet (ROADMAP M13)"
            )
        self.phys_model = phys_model
        self.sim_config = sim_config
        self.bs = int(bs)
        self.device = torch.device(device)
        self.supersample = int(sim_config.supersample)
        self.wcs = LensWCS(
            n=sim_config.num_pix,
            supersample=sim_config.supersample,
            transform_pix2angle=sim_config.transform_pix2angle,
            pix_scale=sim_config.delta_pix,
        )
        t = (
            np.eye(2) * sim_config.delta_pix
            if sim_config.transform_pix2angle is None
            else np.asarray(sim_config.transform_pix2angle, np.float64)
        )
        # pixel-area Jacobian: surface brightness -> native-pixel flux
        self.conversion_factor = float(np.float32(np.linalg.det(t)))

        nx, ny = self.wcs.n_x, self.wcs.n_y
        ss = self.supersample
        self.h_ss, self.w_ss = nx * ss, ny * ss

        def dev(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

        if sim_config.pix_region is None:
            self.img_region = torch.ones((nx, ny), dtype=torch.float32, device=self.device)
            self._rows = self._cols = None
            X, Y = self.wcs.pixel_grid()  # (h_ss, w_ss) each
            img_x, img_y = X.reshape(-1), Y.reshape(-1)
            self.n_live_pix = int(nx) * int(ny)
        else:
            img_region = np.asarray(sim_config.pix_region).astype(bool)
            self.img_region = dev(img_region.astype(np.float32))
            region = np.repeat(np.repeat(img_region, ss, axis=0), ss, axis=1)
            rows, cols = np.where(region)
            self._rows = dev(rows, torch.long)
            self._cols = dev(cols, torch.long)
            img_x, img_y = self.wcs.pix2angle(cols, rows)
            self.n_live_pix = int(np.count_nonzero(img_region))
        self.img_x = dev(img_x)  # (npix,)
        self.img_y = dev(img_y)

        def consts(cs):
            return [{k: v.to(self.device) for k, v in d.items()} for d in cs]

        self._lenses_constants = consts(phys_model.lenses_constants)
        self._lens_light_constants = consts(phys_model.lens_light_constants)
        self._source_light_constants = consts(phys_model.source_light_constants)

        # ---- PSF ----------------------------------------------------------
        self._conv = None
        if sim_config.kernel is not None:
            kern = subgrid_kernel(np.asarray(sim_config.kernel), ss, odd=True)
            mode = sim_config.psf_mode
            if mode is None and sim_config.use_fft is not None:
                if not sim_config.use_fft:
                    raise NotImplementedError("direct PSF convolution is not ported yet")
                mode = "fft"
            if mode is None:
                # the dense-DFT matmul path on the card, the FFT elsewhere
                # (the JAX package's 'direct' pick for tiny kernels is not
                # ported; the FFT computes the same convolution)
                mode = "dft" if self.device.type == "cuda" else "fft"
            # dft folds the supersample average pool into the inverse transform
            self._conv = PSFConv(
                kern, (self.h_ss, self.w_ss), mode=mode,
                pool=self.supersample if mode == "dft" else 1, device=self.device,
            )

        # ---- fused render -----------------------------------------------------
        self._fused_niter = self._detect_fused_pattern(phys_model)
        use_fused = sim_config.use_fused_render
        if use_fused is None:
            use_fused = self.device.type == "cuda"
        self._use_fused = bool(use_fused) and self._fused_niter is not None

    @staticmethod
    def _detect_fused_pattern(phys_model):
        """The EPL niter if the model is [EPL, Shear] + [SersicEllipse]? +
        [SersicEllipse] with no fixed constants, else None. A source-only
        model (no lens light) feeds the kernel a zero-amplitude dummy lens
        light. (SIE-as-EPL(gamma=2) waits for the SIE port.)"""
        pm = phys_model
        ll_ok = len(pm.lens_light) == 0 or (
            len(pm.lens_light) == 1 and type(pm.lens_light[0]) is SersicEllipse
        )
        ok = (
            len(pm.lenses) == 2
            and type(pm.lenses[0]) is EPL
            and type(pm.lenses[1]) is Shear
            and ll_ok
            and len(pm.source_light) == 1
            and type(pm.source_light[0]) is SersicEllipse
            and all(not c for c in pm.lenses_constants)
            and all(not c for c in pm.lens_light_constants)
            and all(not c for c in pm.source_light_constants)
        )
        return pm.lenses[0].niter if ok else None

    def beta(self, x, y, lens_params: List[Dict]):
        """Ray-shoots image-plane coords to the source plane (single plane)."""
        beta_x, beta_y = x, y
        for lens, p, c in zip(self.phys_model.lenses, lens_params, self._lenses_constants):
            fx, fy = lens.deriv(x, y, **_batched(p), **c)
            beta_x, beta_y = beta_x - fx, beta_y - fy
        return beta_x, beta_y

    @staticmethod
    def _get(params, key, profiles):
        return params.get(key, [{} for _ in profiles])

    def _flat_light(self, params, no_deflection=False):
        """Total surface brightness on the live supersampled pixels: (bs, npix)."""
        npix = self.img_x.shape[0]
        if (
            self._use_fused
            and not no_deflection
            and all(k in params for k in ("lens_mass", "source_light"))
            and (not self.phys_model.lens_light or "lens_light" in params)
        ):
            fp = params
            if not self.phys_model.lens_light:
                # zero-amplitude lens light: Ie = 0 kills the component
                # exactly; the other dummies sit at benign values so the
                # kernel's intermediate math stays finite (R=1, n=4, e=0)
                z = torch.zeros_like(params["lens_mass"][0]["theta_E"].reshape(-1))
                ll = dict(R_sersic=z + 1.0, n_sersic=z + 4.0, e1=z, e2=z,
                          center_x=z, center_y=z, Ie=z)
                fp = {**params, "lens_light": [ll]}
            out = fused_render(pack_params(fp), self.img_x, self.img_y, self._fused_niter)
            return torch.broadcast_to(out, (self.bs, npix))

        x, y = self.img_x, self.img_y
        lens_params = self._get(params, "lens_mass", self.phys_model.lenses)
        beta_x, beta_y = (x, y) if no_deflection else self.beta(x, y, lens_params)
        values = []
        for prof, p, c in zip(
            self.phys_model.lens_light,
            self._get(params, "lens_light", self.phys_model.lens_light),
            self._lens_light_constants,
        ):
            values.append(prof.light(x, y, **_batched(p), **c))
        for prof, p, c in zip(
            self.phys_model.source_light,
            self._get(params, "source_light", self.phys_model.source_light),
            self._source_light_constants,
        ):
            values.append(prof.light(beta_x, beta_y, **_batched(p), **c))
        if not values:
            return torch.zeros((self.bs, npix), dtype=x.dtype, device=self.device)
        return torch.broadcast_to(sum(values), (self.bs, npix))

    def _place(self, flat):
        """(..., npix) flat live-pixel values -> (..., h_ss, w_ss) image."""
        lead = flat.shape[:-1]
        if self._rows is None:
            return flat.reshape(*lead, self.h_ss, self.w_ss)
        img = torch.zeros((*lead, self.h_ss, self.w_ss), dtype=flat.dtype,
                          device=flat.device)
        img[..., self._rows, self._cols] = flat
        return img

    def _postprocess(self, img):
        """nan guard -> PSF -> downsample -> pixel-area scale."""
        img = torch.nan_to_num(img)
        pooled = False
        if self._conv is not None:
            img = self._conv(img)
            pooled = self._conv.pool > 1
        if not pooled:
            img = average_pool(img, self.supersample)
        return img * self.conversion_factor

    def simulate(self, params, no_deflection=False):
        """Renders observed-frame images; returns (bs, H, W) squeezed."""
        flat = self._flat_light(params, no_deflection=no_deflection)
        return torch.squeeze(self._postprocess(self._place(flat)))

