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
stacks) runs K5-K7 (``ops/cuda/fused_builder.py``). A multi-plane model
takes neither tier and renders unfused.

Survey mode: a (S, kh, kw) PSF stack in the config convolves the batch as
S * K scene-major rows, each scene's rows with its own kernel (including
each lstsq component of a row), and ``lstsq_simulate`` solves each row
against its own scene's (S, H, W) data.

The lensing fields (:meth:`LensSimulator.beta`, ``hessian``, ``potential``,
``fermat_potential``, ``magnification``, ``convergence``, ``shear``) take
coordinates of any shape that broadcast against the ``(bs, 1)`` leaves.
"""
from __future__ import annotations

import copy
from typing import Dict, List

import numpy as np
import torch

import gigalens_tpu_torch.model as gmodel
import gigalens_tpu_torch.parallel.mesh as pmesh
from gigalens_tpu_torch.config import LensWCS, SimulatorConfig
from gigalens_tpu_torch.ops.cuda import fused_builder
from gigalens_tpu_torch.ops.cuda.fused_render import fused_render, pack_params
from gigalens_tpu_torch.ops.psf import PSFConv, average_pool, subgrid_kernel
from gigalens_tpu_torch.profiles.base import _grad_leaf, _needs_graph
from gigalens_tpu_torch.profiles.light.sersic import SersicEllipse
from gigalens_tpu_torch.profiles.mass.epl import EPL
from gigalens_tpu_torch.profiles.mass.shear import Shear
from gigalens_tpu_torch.profiles.mass.sie import SIE


def _batched(p: Dict):
    """Appends a broadcast axis to each (bs,)-shaped leaf: (bs,) -> (bs, 1)."""
    return {k: v[..., None] for k, v in p.items()}


def _lstsq_coeffs(imgs, observed_image, err_map):
    """(n, depth) weighted least-squares amplitudes of the (depth, n, H, W)
    component images against the (H, W) data, or against (S, H, W) data
    with the n rows scene-major: the normal equations with a
    pseudo-inverse (relative cutoff 1e-6, as the JAX package's
    ``pinv(rcond=1e-6)``)."""
    depth, n = imgs.shape[:2]
    ret = imgs.permute(1, 2, 3, 0)  # (n, H, W, depth)
    if observed_image.ndim == 3:  # scene-batched data
        S = observed_image.shape[0]
        Wm = (1.0 / err_map)[:, None, ..., None]  # (S, 1, H, W, 1)
        Y = (observed_image / err_map).reshape(S, 1, -1, 1)
        X = (ret.reshape(S, n // S, *ret.shape[1:]) * Wm).reshape(S, n // S, -1, depth)
    else:
        W = (1.0 / err_map)[..., None]  # (H, W, 1)
        Y = (observed_image * W[..., 0]).reshape(1, -1, 1)
        X = (ret * W).reshape(n, -1, depth)
    Xt = X.transpose(-1, -2)
    return (torch.linalg.pinv(Xt @ X, rtol=1e-6) @ (Xt @ Y))[..., 0].reshape(n, depth)


class LensSimulator(gmodel.VersionedAttrs):
    """Batched differentiable lens simulator for a fixed camera, batch size
    and device (``None``: the CUDA card; ``"cpu"`` must be asked for).

    ``mesh`` (:class:`~gigalens_tpu_torch.parallel.Mesh`): the batch is
    this rank's shard of a global batch of ``bs * mesh.size`` rows, and the
    per-row reductions over pixels (the prob models', the lstsq solve's and
    the unfused render's parameter gradients) run at the global row count,
    so each row rounds as in one process."""

    def __init__(
        self,
        phys_model: "gmodel.PhysicalModel",
        sim_config: SimulatorConfig,
        bs: int,
        device=None,
        mesh=None,
    ):
        self.phys_model = phys_model
        self.sim_config = sim_config
        self.bs = int(bs)
        self.mesh = mesh
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
            kernel = np.asarray(sim_config.kernel)
            if kernel.ndim == 3:
                # per-scene PSF stack (survey mode): each scene's kernel
                # supersampled on its own
                kern = np.stack([subgrid_kernel(k, ss, odd=True) for k in kernel])
            else:
                kern = subgrid_kernel(kernel, ss, odd=True)
            mode = sim_config.psf_mode
            if mode is None and sim_config.use_fft is not None:
                mode = "fft" if sim_config.use_fft else "direct"
            if mode == "direct" and kern.ndim == 3:
                mode = "fft"  # per-scene kernels have no direct path, as in JAX
            if mode is None:
                if kern.ndim == 2 and kern.shape[0] * kern.shape[1] <= 81:
                    mode = "direct"  # tiny kernels: a plain conv, as in JAX
                else:
                    # the dense-DFT matmul path on the card, the FFT elsewhere
                    mode = "dft" if self.device.type == "cuda" else "fft"
            # dft folds the supersample average pool into the inverse transform
            self._conv = PSFConv(
                kern, (self.h_ss, self.w_ss), mode=mode,
                pool=self.supersample if mode in ("dft", "dft_hi") else 1, device=self.device,
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
        """Ray-shoots image-plane coords to the source plane.

        Single plane: subtract every deflector's reduced deflection at the
        image-plane coords. Multi-plane (``phys_model.mp_factors`` set): each
        deflector is evaluated at the ray's position on its own plane,
        displaced by the scaled deflections of every foreground plane
        (``F[k, j] == 0`` between equal redshifts, which co-add)."""
        pm = self.phys_model
        F = getattr(pm, "mp_factors", None)
        if F is None:
            beta_x, beta_y = x, y
            for lens, p, c in zip(pm.lenses, lens_params, self._lenses_constants):
                fx, fy = lens.deriv(x, y, **_batched(p), **c)
                beta_x, beta_y = beta_x - fx, beta_y - fy
            return beta_x, beta_y

        ax, ay = [], []
        for j, (lens, p, c) in enumerate(zip(pm.lenses, lens_params, self._lenses_constants)):
            tx, ty = x, y
            for k in range(j):
                fkj = float(F[k, j])  # baked float32 constants
                if fkj != 0.0:
                    tx = tx - fkj * ax[k]
                    ty = ty - fkj * ay[k]
            fx, fy = lens.deriv(tx, ty, **_batched(p), **c)
            ax.append(fx)
            ay.append(fy)
        beta_x, beta_y = x, y
        for fx, fy in zip(ax, ay):
            beta_x, beta_y = beta_x - fx, beta_y - fy
        return beta_x, beta_y

    def hessian(self, x, y, lens_params: List[Dict]):
        """Effective deflection Jacobian entries (f_xx, f_xy, f_yx, f_yy).

        Single plane: the sum of the profiles' Hessians (symmetric).
        Multi-plane: the composed Jacobian ``d alpha_eff / d theta`` by two
        ``torch.autograd.grad`` calls on :meth:`beta` over coordinates
        broadcast to the output's shape (so rows are exact per sample), with
        ``create_graph=True``; generally asymmetric (f_xy != f_yx)."""
        pm = self.phys_model
        if getattr(pm, "mp_factors", None) is None:
            f_xx = f_xy = f_yx = f_yy = 0.0
            for lens, p, c in zip(pm.lenses, lens_params, self._lenses_constants):
                a, b, c2, d = lens.hessian(x, y, **_batched(p), **c)
                f_xx, f_xy, f_yx, f_yy = f_xx + a, f_xy + b, f_yx + c2, f_yy + d
            return f_xx, f_xy, f_yx, f_yy

        keep_graph = _needs_graph(x, y, *(v for p in lens_params for v in p.values()))
        with torch.enable_grad():
            bx0, _ = self.beta(x, y, lens_params)
            xb, yb = (_grad_leaf(torch.broadcast_to(c, bx0.shape)) for c in (x, y))
            bx, by = self.beta(xb, yb, lens_params)
            ones, zeros = torch.ones_like(bx), torch.zeros_like(bx)
            row_x = torch.autograd.grad((bx, by), (xb, yb), (ones, zeros), create_graph=True)
            row_y = torch.autograd.grad((bx, by), (xb, yb), (zeros, ones), create_graph=True)
        # beta = theta - alpha_eff  =>  J = I - d beta / d theta
        out = (1.0 - row_x[0], -row_x[1], -row_y[0], 1.0 - row_y[1])
        return out if keep_graph else tuple(g.detach() for g in out)

    def potential(self, x, y, lens_params: List[Dict]):
        """Total lensing potential (single plane; every profile must
        implement ``potential``)."""
        if getattr(self.phys_model, "mp_factors", None) is not None:
            raise NotImplementedError("lensing potential / time delays are single-plane only")
        psi = 0.0
        for lens, p, c in zip(self.phys_model.lenses, lens_params, self._lenses_constants):
            psi = psi + lens.potential(x, y, **_batched(p), **c)
        return psi

    def fermat_potential(self, x, y, lens_params: List[Dict], beta_x=None, beta_y=None):
        """Fermat potential ``tau = |theta - beta|^2 / 2 - psi(theta)``
        [arcsec^2]. With ``beta_*`` omitted each point uses its own
        ray-traced source position; time-delay likelihoods pass a shared one."""
        if beta_x is None or beta_y is None:
            beta_x, beta_y = self.beta(x, y, lens_params)
        psi = self.potential(x, y, lens_params)
        return 0.5 * ((x - beta_x) ** 2 + (y - beta_y) ** 2) - psi

    def magnification(self, x, y, lens_params: List[Dict]):
        f_xx, f_xy, f_yx, f_yy = self.hessian(x, y, lens_params)
        det_a = (1 - f_xx) * (1 - f_yy) - f_xy * f_yx
        return 1.0 / det_a  # diverges on critical curves, as in the JAX package

    def convergence(self, x, y, lens_params: List[Dict]):
        f_xx, _, _, f_yy = self.hessian(x, y, lens_params)
        return (f_xx + f_yy) / 2

    def shear(self, x, y, lens_params: List[Dict]):
        f_xx, f_xy, _, f_yy = self.hessian(x, y, lens_params)
        return (f_xx - f_yy) / 2, f_xy

    @staticmethod
    def _get(params, key, profiles):
        """``params[key]`` (empty dicts when absent); a non-dict ``params``
        (a bare list of per-profile dicts) passes through, as in JAX."""
        return params.get(key, [{} for _ in profiles]) if isinstance(params, dict) else params

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

        mesh = self.mesh
        if mesh is not None and mesh.size > 1:
            # the unfused render's parameter gradients are autograd's sums
            # over the supersampled pixels, which the card splits among
            # blocks by the number of rows: render at the global row count
            # (this rank's rows among copies of its first row) and keep them
            view = copy.copy(self)
            view.bs, view.mesh = self.bs * mesh.size, None

            def pad(v):
                if not isinstance(v, torch.Tensor) or v.dim() == 0 or v.shape[0] != self.bs:
                    return v
                return pmesh.pad_rows(v, mesh)

            def pad_group(ps):
                return [{k: pad(v) for k, v in p.items()} for p in ps]

            padded = ({g: pad_group(ps) for g, ps in params.items()}
                      if isinstance(params, dict) else pad_group(params))
            out = view._flat_light(padded, no_deflection, stack_components)
            return pmesh.rank_rows(out, mesh, dim=out.dim() - 2)

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
            # the sample axis is the one before the image axes, also for
            # lstsq components (depth, bs, h, w): a per-scene PSF meets each
            # component of a row with the row's own scene's kernel (F-ref-6)
            img = self._conv(img, scene_axis=-3)
            pooled = self._conv.pool > 1
        if not pooled:
            img = average_pool(img, self.supersample)
        return img * self.conversion_factor

    def simulate(self, params, no_deflection=False):
        """Renders observed-frame images; returns (bs, H, W) squeezed."""
        flat = self._flat_light(params, no_deflection=no_deflection)
        return torch.squeeze(self._postprocess(self._place(flat)))

    def _render_selected(self, params, lens_light: bool, source_light: bool,
                         no_deflection: bool = False):
        """Renders a subset of the light components through a shallow copy
        whose model view lists only those (never by mutating ``self``); the
        copy takes the unfused path, since the fused tiers render every
        component."""
        pm = self.phys_model
        sub = gmodel.PhysicalModel.__new__(gmodel.PhysicalModel)
        sub.lenses = pm.lenses
        sub.mp_factors = getattr(pm, "mp_factors", None)
        sub.lenses_constants = pm.lenses_constants
        sub.lens_light = pm.lens_light if lens_light else []
        sub.lens_light_constants = pm.lens_light_constants if lens_light else []
        sub.source_light = pm.source_light if source_light else []
        sub.source_light_constants = pm.source_light_constants if source_light else []
        view = copy.copy(self)
        view.phys_model = sub
        view._use_fused = False
        view._lens_light_constants = self._lens_light_constants if lens_light else []
        view._source_light_constants = self._source_light_constants if source_light else []
        flat = view._flat_light(params, no_deflection=no_deflection)
        return torch.squeeze(self._postprocess(self._place(flat)))

    def simulate_source(self, params):
        """Unlensed source render (no deflection applied)."""
        return self._render_selected(params, lens_light=False, source_light=True,
                                     no_deflection=True)

    def simulate_lens_light(self, params):
        return self._render_selected(params, lens_light=True, source_light=False)

    def simulate_images(self, params):
        """Lensed source only (no lens light)."""
        return self._render_selected(params, lens_light=False, source_light=True)

    def lstsq_simulate(self, params, observed_image, err_map, return_stacked=False,
                       return_coeffs=False, no_deflection=False):
        """Renders with linear amplitudes solved by weighted least squares.

        Solves, per sample, ``argmin_a || (sum_k a_k X_k - Y) / err ||^2``
        through the normal equations with a pseudo-inverse (relative cutoff
        1e-6, as the JAX package's ``pinv(rcond=1e-6)``). ``observed_image``
        and ``err_map`` are (H, W), or (S, H, W) in survey mode, where each
        scene-major row (``bs = S * K``) is solved against its own scene's
        data.
        """
        observed_image = torch.as_tensor(observed_image, dtype=torch.float32,
                                         device=self.device)
        err_map = torch.as_tensor(err_map, dtype=torch.float32, device=self.device)
        stacked = self._flat_light(params, no_deflection=no_deflection,
                                   stack_components=True)  # (depth, bs, npix)
        imgs = self._postprocess(self._place(stacked))  # (depth, bs, H, W)
        if return_stacked:
            return imgs.permute(1, 2, 3, 0)
        S = observed_image.shape[0] if observed_image.ndim == 3 else 1
        if self.bs % S:
            raise ValueError(f"batch {self.bs} is not a multiple of {S} scenes")
        mesh = self.mesh
        if mesh is None or mesh.size == 1:
            coeffs = _lstsq_coeffs(imgs, observed_image, err_map)
        else:
            # at the global row count, each scene's rows among filler rows for
            # the other ranks': the batched GEMMs and the pseudo-inverse
            # pick their algorithms by the number of rows
            rows = imgs.reshape(imgs.shape[0], S, self.bs // S, *imgs.shape[2:])
            full = pmesh.pad_rows(rows, mesh, dim=2).flatten(1, 2)
            coeffs = _lstsq_coeffs(full, observed_image, err_map)
            coeffs = pmesh.rank_rows(coeffs.reshape(S, -1, self.depth), mesh, dim=1)
        coeffs = coeffs.reshape(self.bs, self.depth)
        ret = imgs.permute(1, 2, 3, 0)  # (bs, H, W, depth)
        if return_coeffs:
            return coeffs
        out = torch.sum(ret * coeffs[:, None, None, :], dim=-1)
        return torch.squeeze(out)
