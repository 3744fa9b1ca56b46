"""Batched differentiable lens simulator (port of :mod:`gigalens_tpu.simulator`).

Renders ``(bs, H, W)`` observed-frame images from batch-leading parameter
trees: ray-shoot the supersampled grid through the mass profiles, evaluate
the light profiles in the source plane, PSF-convolve, pool to native pixels.

Parameter convention: ``params`` is a dict with keys ``lens_mass``,
``lens_light``, ``source_light``, each a list of per-profile dicts whose
leaves are shaped ``(bs,)``; leaves broadcast against the ``(npix,)``
coordinates as ``(bs, 1)``.

Two fused tiers render the whole flat light on a CUDA device, as in JAX:
the [EPL|SIE, Shear] + SersicEllipse family runs K1-K3
(``ops/cuda/fused_render.py``), every other composition the builder covers
(shapelets, SIS, CoreSersic, NFW halos, baked constants, lstsq component
stacks) runs K5-K7 (``ops/cuda/fused_builder.py``). Not ported yet:
multi-plane ray tracing, the lensing-field helpers (hessian,
magnification, potential) and scene-batched (survey) lstsq data.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

import gigalens_tpu_torch.model as gmodel
from gigalens_tpu_torch.config import LensWCS, SimulatorConfig
from gigalens_tpu_torch.ops.cuda import fused_builder
from gigalens_tpu_torch.ops.cuda.fused_render import fused_render, pack_params
from gigalens_tpu_torch.ops.psf import PSFConv, average_pool, subgrid_kernel
from gigalens_tpu_torch.profiles.light.sersic import SersicEllipse
from gigalens_tpu_torch.profiles.mass.epl import EPL
from gigalens_tpu_torch.profiles.mass.shear import Shear
from gigalens_tpu_torch.profiles.mass.sie import SIE


def _batched(p: Dict):
    """Appends a broadcast axis to each (bs,)-shaped leaf: (bs,) -> (bs, 1)."""
    return {k: v[..., None] for k, v in p.items()}


class LensSimulator(gmodel.VersionedAttrs):
    """Batched differentiable lens simulator for a fixed camera, batch size
    and device (``None``: the CUDA card; ``"cpu"`` must be asked for)."""

    def __init__(
        self,
        phys_model: "gmodel.PhysicalModel",
        sim_config: SimulatorConfig,
        bs: int,
        device=None,
    ):
        self.phys_model = phys_model
        self.sim_config = sim_config
        self.bs = int(bs)
        self.device = gmodel.resolve_device(device)
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
        # linear (lstsq) component count
        self.depth = sum(p.depth for p in phys_model.lens_light + phys_model.source_light)

        def consts(cs):
            return [{k: v.to(self.device) for k, v in d.items()} for d in cs]

        self._lenses_constants = consts(phys_model.lenses_constants)
        self._lens_light_constants = consts(phys_model.lens_light_constants)
        self._source_light_constants = consts(phys_model.source_light_constants)

        # ---- PSF ----------------------------------------------------------
        self._conv = None
        if sim_config.kernel is not None:
            if np.ndim(sim_config.kernel) != 2:
                raise NotImplementedError(
                    "per-scene PSF stacks (survey mode) are not ported yet (ROADMAP M17)"
                )
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
        # two tiers: the bench kernel (K1-K3) for its exact [EPL|SIE, Shear]
        # + Sersic pattern, and the composable builder (K5-K7) for every
        # other composition it covers
        self._fused_niter = self._detect_fused_pattern(phys_model)
        self._fused_spec = None
        if self._fused_niter is None:
            self._fused_spec = fused_builder.build_spec(phys_model)
        fusable = self._fused_niter is not None or self._fused_spec is not None
        use_fused = sim_config.use_fused_render
        if use_fused is None:
            use_fused = self.device.type == "cuda"
        self._use_fused = bool(use_fused) and fusable

    @staticmethod
    def _detect_fused_pattern(phys_model):
        """The EPL niter if the model is [EPL|SIE, Shear] + [SersicEllipse]?
        + [SersicEllipse] with sampled amplitudes and no fixed constants,
        else None. Two degenerate patterns ride the same kernel:

        * a source-only model (no lens light) feeds the kernel a
          zero-amplitude dummy lens light;
        * an SIE deflector is evaluated as EPL at gamma = 2 (an exact special
          case) with ``EPL.recommended_niter(0.43, 1e-8)`` series terms.
        """
        pm = phys_model
        ll_ok = len(pm.lens_light) == 0 or (
            len(pm.lens_light) == 1
            and type(pm.lens_light[0]) is SersicEllipse
            and not pm.lens_light[0].use_lstsq
        )
        ok = (
            getattr(pm, "mp_factors", None) is None  # single-plane only
            and len(pm.lenses) == 2
            and type(pm.lenses[0]) in (EPL, SIE)
            and type(pm.lenses[1]) is Shear
            and ll_ok
            and len(pm.source_light) == 1
            and type(pm.source_light[0]) is SersicEllipse
            and not pm.source_light[0].use_lstsq
            and all(not c for c in pm.lenses_constants)
            and all(not c for c in pm.lens_light_constants)
            and all(not c for c in pm.source_light_constants)
        )
        if not ok:
            return None
        if type(pm.lenses[0]) is SIE:
            return EPL.recommended_niter(q_min=0.43, tol=1e-8)
        return pm.lenses[0].niter

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

    def _flat_light(self, params, no_deflection=False, stack_components=False):
        """Total surface brightness on the live supersampled pixels.

        Returns (bs, npix), or (depth, bs, npix) when ``stack_components``.
        """
        npix = self.img_x.shape[0]
        pm = self.phys_model
        spec = self._fused_spec
        if (
            self._use_fused
            and spec is not None
            and not no_deflection
            and all(k in params for k, profs in (("lens_mass", pm.lenses),
                                                 ("lens_light", pm.lens_light),
                                                 ("source_light", pm.source_light)) if profs)
            and ((stack_components and spec.all_lstsq)
                 or (not stack_components and not spec.any_lstsq))
        ):
            extras = spec.gather_extras(self.img_x, self.img_y)
            if extras is not None:  # None: a stage's grids aren't ready yet
                packed = spec.pack(params)
                if stack_components:
                    out = fused_builder.fused_render_components(
                        packed, self.img_x, self.img_y, extras, spec)
                    return torch.broadcast_to(out, (spec.depth, self.bs, npix))
                out = fused_builder.fused_render_sum(packed, self.img_x, self.img_y, extras, spec)
                return torch.broadcast_to(out, (self.bs, npix))

        if (
            self._use_fused
            and self._fused_niter is not None
            and not stack_components
            and not no_deflection
            and all(k in params for k in ("lens_mass", "source_light"))
            and (not pm.lens_light or "lens_light" in params)
        ):
            fp = params
            if "gamma" not in params["lens_mass"][0]:
                # SIE deflector: EPL at the constant gamma = 2 (an exact
                # special case; the constant column carries no gradient)
                lm0 = dict(params["lens_mass"][0])
                lm0["gamma"] = torch.full_like(lm0["theta_E"].reshape(-1), 2.0)
                fp = {**params, "lens_mass": [lm0, params["lens_mass"][1]]}
            if not pm.lens_light:
                # zero-amplitude lens light: Ie = 0 kills the component
                # exactly; the other dummies sit at benign values so the
                # kernel's intermediate math stays finite (R=1, n=4, e=0)
                z = torch.zeros_like(fp["lens_mass"][0]["theta_E"].reshape(-1))
                ll = dict(R_sersic=z + 1.0, n_sersic=z + 4.0, e1=z, e2=z,
                          center_x=z, center_y=z, Ie=z)
                fp = {**fp, "lens_light": [ll]}
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
        if stack_components:
            # lstsq mode: each profile contributes (depth_i, bs, npix)
            return torch.cat(
                [torch.broadcast_to(v, (v.shape[0], self.bs, npix)) for v in values])
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

    def lstsq_simulate(self, params, observed_image, err_map, return_stacked=False,
                       return_coeffs=False, no_deflection=False):
        """Renders with linear amplitudes solved by weighted least squares.

        Solves, per sample, ``argmin_a || (sum_k a_k X_k - Y) / err ||^2``
        through the normal equations with a pseudo-inverse (relative cutoff
        1e-6, as the JAX package's ``pinv(rcond=1e-6)``). ``observed_image``
        and ``err_map`` are (H, W); scene-batched (S, H, W) data (survey
        mode) is not ported yet.
        """
        observed_image = torch.as_tensor(observed_image, dtype=torch.float32,
                                         device=self.device)
        err_map = torch.as_tensor(err_map, dtype=torch.float32, device=self.device)
        if observed_image.ndim == 3:
            raise NotImplementedError(
                "scene-batched (survey) lstsq data is not ported yet (ROADMAP M17)")
        stacked = self._flat_light(params, no_deflection=no_deflection,
                                   stack_components=True)  # (depth, bs, npix)
        imgs = self._postprocess(self._place(stacked))  # (depth, bs, H, W)
        ret = imgs.permute(1, 2, 3, 0)  # (bs, H, W, depth)
        if return_stacked:
            return ret
        W = (1.0 / err_map)[..., None]  # (H, W, 1)
        Y = (observed_image * W[..., 0]).reshape(1, -1, 1)
        X = (ret * W).reshape(self.bs, -1, self.depth)
        Xt = X.transpose(-1, -2)
        coeffs = (torch.linalg.pinv(Xt @ X, rtol=1e-6) @ (Xt @ Y))[..., 0]
        if return_coeffs:
            return coeffs
        out = torch.sum(ret * coeffs[:, None, None, :], dim=-1)
        return torch.squeeze(out)

