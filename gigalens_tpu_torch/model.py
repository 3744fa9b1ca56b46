"""Physical and probabilistic models (port of :mod:`gigalens_tpu.model`).

* :class:`PhysicalModel` bundles mass/light profile lists and fixed constants.
* :class:`ForwardProbModel` scores pixels with the forward-modeled
  Gaussian+Poisson noise map, and/or multiple-image positions, with
  optional point-source time delays and image fluxes.
* :class:`BackwardProbModel` scores pixels with the observed-image noise
  map and linear (lstsq) light amplitudes.
* :class:`SurveyForwardProbModel` and :class:`SurveyBackwardProbModel` are
  their survey twins: S observations (S, H, W) scored in one batch of
  S * K scene-major rows, row ``s * K + k`` against scene ``s``.

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

import gigalens_tpu_torch.parallel.mesh as pmesh
from gigalens_tpu_torch.cosmology import FlatLambdaCDM, multiplane_factors
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


def pixel_reduce(simulator, fn, x, scenes=None):
    """``fn(x)`` for a reduction ``fn`` over the pixel axes (-2, -1) of
    ``x`` (``simulator``'s rows, one image each, or ``(scenes, K, H, W)``),
    evaluated at the global row count when ``simulator`` is a mesh rank's
    shard (its ``mesh``; :func:`~gigalens_tpu_torch.parallel.mesh.at_global_rows`):
    the card splits each row's sum among a block's threads by the number
    of rows a call holds, so a shard's rows would round otherwise than one
    process's. Without a mesh it is ``fn(x)``."""
    mesh = getattr(simulator, "mesh", None)
    if mesh is None or mesh.size == 1:
        return fn(x)
    lead, img = x.shape[:-2], x.shape[-2:]
    if scenes is None:
        rows = x.reshape(simulator.bs, *img)  # a squeezed batch of one included
        return pmesh.at_global_rows(fn, rows, mesh).reshape(lead)
    return pmesh.at_global_rows(fn, x, mesh, dim=1)


def _pixel_sum(t):
    return torch.sum(t, dim=(-2, -1))


def _pixel_mean(t):
    return torch.mean(t, dim=(-2, -1))


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

    Multi-plane lensing: pass ``lens_redshifts`` (one per deflector,
    ascending) and ``z_source`` to ray-trace through deflectors at
    different distances (``LensSimulator.beta`` runs the recursion with the
    coefficients of :func:`gigalens_tpu_torch.cosmology.multiplane_factors`;
    profiles keep their source-plane-reduced parameterization). Deflectors
    at equal redshift co-add exactly as in single-plane mode.
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
        z_source: Optional[float] = None,
        cosmology=None,
    ):
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

        if lens_redshifts is not None:
            if z_source is None:
                raise ValueError("lens_redshifts requires z_source")
            if len(lens_redshifts) != len(self.lenses):
                raise ValueError(
                    f"need one redshift per deflector: "
                    f"{len(lens_redshifts)} vs {len(self.lenses)} lenses"
                )
            self.mp_factors = multiplane_factors(
                lens_redshifts, z_source, cosmology).astype(np.float32)
            self.lens_redshifts = [float(z) for z in lens_redshifts]
            self.z_source = float(z_source)
        else:
            self.mp_factors = None


# days per (Mpc * arcsec^2): the Fermat-potential -> time-delay conversion
# Delta_t = _TD_DAYS * D_dt[Mpc] * Delta_tau[arcsec^2]
_MPC_KM = 3.085677581491367e19
_ARCSEC_RAD = math.pi / (180.0 * 3600.0)
_TD_DAYS = _MPC_KM / 299792.458 * _ARCSEC_RAD**2 / 86400.0


def _clamped_det(simulator, cx, cy, lens_params):
    """|det A| of the lens mapping at (cx, cy), clamped to [1e-3, 1e3].

    Formed from the Hessian, never as 1/mu: a candidate lens that puts a
    centroid on its critical curve has det = 0, where 1/det is inf and even
    a clipped |1/det| leaves a 0 * inf NaN in the backward pass; det itself
    is a finite polynomial of the Hessian, so the clamp gives a finite value
    and gradient everywhere. The bounds are far outside any physical
    strong-lensing magnification."""
    f_xx, f_xy, f_yx, f_yy = simulator.hessian(cx, cy, lens_params)
    det_a = (1 - f_xx) * (1 - f_yy) - f_xy * f_yx
    return torch.clamp(torch.abs(det_a), 1e-3, 1e3)


class _SamplerFacade:
    """What the inference routines read off a probabilistic model besides its
    log-density, as in the JAX package: the likelihood terms it includes
    (the SMC selector reads them), ``init_centroids``, ``log_prior`` and
    ``bij``. A model without data for a term leaves these class defaults."""

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
    """Forward-modeled likelihood over pixels and/or multiple-image
    positions, optionally with point-source time delays and image fluxes.

    Data are stored as float32 tensors on ``device`` (``None``: the CUDA
    card, see :func:`resolve_device`). Pixels: pass ``error_map`` for a
    fixed noise map, or ``background_rms`` and ``exp_time`` for the
    model-based Gaussian+Poisson map. Positions: ``centroids_*`` are lists
    of groups, one array of image coordinates (and their errors) a group.
    Delays (relative to the first image) and fluxes attach to exactly one
    centroid group; the time-delay distance is ``time_delay_distance``,
    or computed from ``(z_lens, z_source)`` and the cosmology, or sampled
    from a ``cosmo=[dict(D_dt=...)]`` prior group.
    """

    def __init__(
        self,
        prior: Prior,
        observed_image=None,
        background_rms=None,
        exp_time=None,
        error_map=None,
        centroids_x=None,
        centroids_y=None,
        centroids_errors_x=None,
        centroids_errors_y=None,
        include_pixels=None,
        include_positions=None,
        delays=None,
        delay_errors=None,
        time_delay_distance=None,
        z_lens=None,
        z_source=None,
        cosmology=None,
        image_fluxes=None,
        image_flux_errors=None,
        device=None,
    ):
        self.prior = prior
        self.device = resolve_device(device)
        # auto-detected from the data unless toggled explicitly
        if include_pixels is None:
            include_pixels = observed_image is not None or error_map is not None
        if include_positions is None:
            include_positions = centroids_x is not None
        self.include_pixels = bool(include_pixels)
        self.include_positions = bool(include_positions)
        self.include_delays = delays is not None
        self.include_fluxes = image_fluxes is not None

        def f32(v):
            return torch.as_tensor(np.asarray(v, np.float32), device=self.device)

        self.observed_image = None
        self.error_map = None
        self.background_rms = None
        self.exp_time = None
        if self.include_pixels:
            self.observed_image = f32(observed_image)
            if error_map is not None:
                self.error_map = f32(error_map)
            else:
                # float32-rounded Python scalars, like the JAX package's jnp.float32
                self.background_rms = float(np.float32(background_rms))
                self.exp_time = float(np.float32(exp_time))

        self.n_position = 0
        if self.include_positions:
            self.centroids_x = [f32(c) for c in centroids_x]
            self.centroids_y = [f32(c) for c in centroids_y]
            self.centroids_errors_x = [f32(c) for c in centroids_errors_x]
            self.centroids_errors_y = [f32(c) for c in centroids_errors_y]
            self.n_position = 2 * int(sum(np.size(np.asarray(c)) for c in centroids_x))

        if self.include_delays or self.include_fluxes:
            if centroids_x is None or len(centroids_x) != 1:
                raise ValueError(
                    "time delays / image fluxes attach to the observed image "
                    "positions: pass exactly one centroids group"
                )
            n_img = int(np.size(np.asarray(centroids_x[0])))
        if self.include_delays:
            self.delays = f32(delays).reshape(-1)
            self.delay_errors = f32(delay_errors).reshape(-1)
            if self.delays.shape[0] != n_img - 1:
                raise ValueError(
                    f"delays are relative to the first image: expected "
                    f"{n_img - 1} values for {n_img} images, got "
                    f"{self.delays.shape[0]}"
                )
            # D_dt: the explicit value; else (z_lens, z_source) through the
            # cosmology; else sampled from a cosmo=[dict(D_dt=...)] group
            if time_delay_distance is not None:
                self.time_delay_distance = float(time_delay_distance)
            elif z_lens is not None and z_source is not None:
                cosmo = cosmology if cosmology is not None else FlatLambdaCDM()
                dl = cosmo.angular_diameter_distance(z_lens)
                ds = cosmo.angular_diameter_distance(z_source)
                dls = cosmo.angular_diameter_distance(z_lens, z_source)
                self.time_delay_distance = (1.0 + z_lens) * dl * ds / dls
            elif isinstance(prior.tree, dict) and "cosmo" in prior.tree:
                self.time_delay_distance = None  # sampled
            else:
                raise ValueError(
                    "delays need a time-delay distance: pass "
                    "time_delay_distance, or (z_lens, z_source), or sample "
                    "it via a cosmo=[dict(D_dt=...)] prior group"
                )
        if self.include_fluxes:
            self.image_fluxes = f32(image_fluxes).reshape(-1)
            self.image_flux_errors = f32(image_flux_errors).reshape(-1)
            if self.image_fluxes.shape[0] != n_img:
                raise ValueError(
                    f"expected {n_img} image fluxes, got {self.image_fluxes.shape[0]}"
                )

    def event_size(self, simulator) -> int:
        """Number of observed scalars; normalizes the MAP loss."""
        n = 0
        if self.include_pixels:
            n += simulator.n_live_pix
        if self.include_positions:
            n += self.n_position
        if self.include_delays:
            n += int(self.delays.shape[0])
        if self.include_fluxes:
            n += int(self.image_fluxes.shape[0])
        return n

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
        chi2 = pixel_reduce(simulator, _pixel_sum, resid**2 * mask)
        normalization = torch.log(2 * math.pi * err_map**2) * mask
        if self.error_map is None:  # a map a row
            normalization = pixel_reduce(simulator, _pixel_sum, normalization)
        else:
            normalization = _pixel_sum(normalization)
        log_like = -0.5 * (chi2 + normalization)
        return log_like, chi2 / simulator.n_live_pix

    def stats_positions(self, simulator, params):
        """(log_like, reduced_chi2) of multiple-image positions: the
        centroids are ray-traced to the source plane and their spread about
        the barycentre is penalized with magnification-scaled errors
        ``centroid_err * |det A|`` (the clamped |det A| of
        :func:`_clamped_det`)."""
        lens_params = params["lens_mass"]
        chi2 = 0.0
        log_like = 0.0
        for cx, cy, cex, cey in zip(self.centroids_x, self.centroids_y,
                                    self.centroids_errors_x, self.centroids_errors_y):
            beta_x, beta_y = simulator.beta(cx, cy, lens_params)  # (bs, n_img)
            beta = torch.stack([beta_x, beta_y], dim=-2)  # (bs, 2, n_img)
            barycentre = torch.mean(beta, dim=-1, keepdim=True)
            det_abs = _clamped_det(simulator, cx, cy, lens_params)
            err = torch.stack([cex * det_abs, cey * det_abs], dim=-2)  # (bs, 2, n_img)
            chi2_i = torch.sum(((beta - barycentre) / err) ** 2, dim=(-2, -1))
            norm_i = torch.sum(torch.log(2 * math.pi * err**2), dim=(-2, -1))
            log_like = log_like + (-0.5) * (chi2_i + norm_i)
            chi2 = chi2 + chi2_i
        return log_like, chi2 / self.n_position

    def stats_time_delays(self, simulator, params):
        """(log_like, reduced_chi2) of the relative time delays: Fermat
        potentials at the observed images with the source at the ray-traced
        barycentre, relative to the first image; ``D_dt`` fixed or read per
        sample from ``params["cosmo"][0]["D_dt"]``."""
        cx, cy = self.centroids_x[0], self.centroids_y[0]
        lens_params = params["lens_mass"]
        beta_x, beta_y = simulator.beta(cx, cy, lens_params)  # (bs, n)
        bxm = torch.mean(beta_x, dim=-1, keepdim=True)
        bym = torch.mean(beta_y, dim=-1, keepdim=True)
        tau = simulator.fermat_potential(cx, cy, lens_params, bxm, bym)
        if self.time_delay_distance is not None:
            d_dt = float(np.float32(self.time_delay_distance))
        else:
            d_dt = torch.reshape(params["cosmo"][0]["D_dt"], (-1, 1))
        dt_model = _TD_DAYS * d_dt * (tau[..., 1:] - tau[..., :1])
        resid = (dt_model - self.delays) / self.delay_errors
        chi2 = torch.sum(resid**2, dim=-1)
        norm = torch.sum(torch.log(2 * math.pi * self.delay_errors**2))
        return -0.5 * (chi2 + norm), chi2 / self.delays.shape[0]

    def stats_fluxes(self, simulator, params):
        """(log_like, reduced_chi2) of the point-source image fluxes: model
        flux ``A |mu(theta_i)|`` with the unlensed flux ``A`` solved per
        sample by weighted least squares, |mu| from the clamped |det A|."""
        cx, cy = self.centroids_x[0], self.centroids_y[0]
        mu = 1.0 / _clamped_det(simulator, cx, cy, params["lens_mass"])  # (bs, n)
        w = 1.0 / self.image_flux_errors**2
        amp = torch.sum(w * self.image_fluxes * mu, dim=-1) / torch.clamp(
            torch.sum(w * mu * mu, dim=-1), min=1e-20)
        resid = (amp[..., None] * mu - self.image_fluxes) / self.image_flux_errors
        chi2 = torch.sum(resid**2, dim=-1)
        norm = torch.sum(torch.log(2 * math.pi * self.image_flux_errors**2))
        return -0.5 * (chi2 + norm), chi2 / self.image_fluxes.shape[0]

    def _terms(self):
        return [f for on, f in ((self.include_pixels, self.stats_pixels),
                                (self.include_positions, self.stats_positions),
                                (self.include_delays, self.stats_time_delays),
                                (self.include_fluxes, self.stats_fluxes)) if on]

    def log_prob(self, simulator, z):
        """Unconstrained log posterior and reduced chi2 (the mean over the
        included terms); z shaped (bs, d)."""
        x = self.prior.constrain(z)
        log_like = torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)
        red_chi2 = torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)
        terms = self._terms()
        for stats in terms:
            ll, rc = stats(simulator, x)
            log_like, red_chi2 = log_like + ll, red_chi2 + rc
        red_chi2 = red_chi2 / max(len(terms), 1)
        log_prior = self.prior.log_prob(x) + self.prior.fldj(z)
        return log_like + log_prior, red_chi2

    def log_like(self, simulator, z):
        x = self.prior.constrain(z)
        total = torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)
        for stats in self._terms():
            total = total + stats(simulator, x)[0]
        return total


class SurveyForwardProbModel(ForwardProbModel):
    """Scene-batched pixel (and position) likelihood: one model scoring S
    independent observations of one camera and one model family.

    ``observed_images`` is (S, H, W), and every parameter batch is
    scene-major with ``bs = S * K`` rows: row ``s * K + k`` is scored against
    ``observed_images[s]``. ``background_rms`` / ``exp_time`` are scalars
    shared by the scenes or (S,) arrays; ``error_map`` is one (H, W) map
    shared by the scenes or (S, H, W). The pixel math is
    :class:`ForwardProbModel`'s, so each row equals the single-scene model's.

    Positions: ``centroids_*`` are length-S lists of 1-D arrays, one image
    group a scene. Scenes may have different image counts: each is padded
    to the longest with repeats of its own first image (error 1), masked
    out of every sum, so the padded rays and Hessians stay finite.
    """

    def __init__(
        self,
        prior: Prior,
        observed_images,
        background_rms=None,
        exp_time=None,
        error_map=None,
        centroids_x=None,
        centroids_y=None,
        centroids_errors_x=None,
        centroids_errors_y=None,
        device=None,
    ):
        obs = np.asarray(observed_images, np.float32)
        if obs.ndim != 3:
            raise ValueError(f"observed_images must be (S, H, W); got {obs.shape}")
        super().__init__(prior, include_pixels=False, include_positions=False, device=device)
        S = self.n_scenes = int(obs.shape[0])

        def f32(v):
            return torch.as_tensor(np.asarray(v, np.float32), device=self.device)

        self.include_pixels = True
        self.observed_image = f32(obs)
        if error_map is not None:
            em = np.asarray(error_map, np.float32)
            if em.shape == obs.shape[1:]:
                em = np.broadcast_to(em, obs.shape)  # one map shared by the scenes
            if em.shape != obs.shape:
                raise ValueError(
                    f"error_map shape {em.shape} must be {obs.shape[1:]} (shared) or match "
                    f"observed_images {obs.shape}")
            self.error_map = f32(em)
        else:
            # (1 or S, 1, 1, 1) against the (S, K, H, W) renders
            self.background_rms = f32(background_rms).reshape(-1, 1, 1, 1)
            self.exp_time = f32(exp_time).reshape(-1, 1, 1, 1)

        if centroids_x is not None:
            if len(centroids_x) != S:
                raise ValueError(f"centroids_x must list {S} scenes; got {len(centroids_x)}")
            counts = [int(np.size(np.asarray(c))) for c in centroids_x]
            for s, n in enumerate(counts):
                if n == 0:
                    raise ValueError(
                        f"scene {s} has an empty centroid list; omit the position data "
                        "entirely or drop that scene from the position-constrained catalogue")
            n_max = max(counts)

            def pad(arrs, fill_from_first):
                out = np.zeros((S, n_max), np.float32)
                for s, a in enumerate(arrs):
                    a = np.asarray(a, np.float32).reshape(-1)
                    out[s, : a.size] = a
                    out[s, a.size:] = a[0] if fill_from_first else 1.0
                return f32(out)

            self.pos_x = pad(centroids_x, True)
            self.pos_y = pad(centroids_y, True)
            self.pos_ex = pad(centroids_errors_x, False)
            self.pos_ey = pad(centroids_errors_y, False)
            mask = np.arange(n_max)[None, :] < np.asarray(counts)[:, None]
            self.pos_mask = f32(mask)
            self.include_positions = True
            # the MAP loss's event size is one scalar for every row: the
            # scenes' mean position count, rounded as the JAX package does
            self.n_position = int(round(2 * float(mask.sum()) / S))

    def _scene_rows(self, simulator):
        if simulator.bs % self.n_scenes:
            raise ValueError(
                f"batch {simulator.bs} is not a multiple of n_scenes={self.n_scenes}")
        return simulator.bs // self.n_scenes

    def stats_pixels(self, simulator, params):
        """(log_like, reduced_chi2), each (S * K,), of the pixel data."""
        S, K = self.n_scenes, self._scene_rows(simulator)
        im = simulator.simulate(params).reshape(S, K, *self.observed_image.shape[-2:])
        obs = self.observed_image[:, None]  # (S, 1, H, W)
        if self.error_map is not None:
            err_map = self.error_map[:, None]
        else:
            # clipped like ForwardProbModel.stats_pixels
            err_map = torch.sqrt(self.background_rms**2 + torch.clamp(im, min=0.0) / self.exp_time)
        mask = simulator.img_region
        resid = (im - obs) / err_map
        chi2 = pixel_reduce(simulator, _pixel_sum, resid**2 * mask, S)  # (S, K)
        normalization = torch.log(2 * math.pi * err_map**2) * mask
        if self.error_map is None:  # a map a row
            normalization = pixel_reduce(simulator, _pixel_sum, normalization, S)
        else:
            normalization = _pixel_sum(normalization)
        log_like = -0.5 * (chi2 + normalization)
        return log_like.reshape(S * K), (chi2 / simulator.n_live_pix).reshape(S * K)

    def stats_positions(self, simulator, params):
        """(log_like, reduced_chi2), each (S * K,), of the scenes' image
        positions: :meth:`ForwardProbModel.stats_positions` a scene, with
        the scene's (1, n) centroids against its rows' (K, 1) parameters
        through the simulator's ``beta`` and :func:`_clamped_det` (per
        sample, also for EPL: the survey case of F-ref-5)."""
        if not self.include_positions:
            raise ValueError("no centroids configured on this survey model")
        S, K = self.n_scenes, self._scene_rows(simulator)
        lens_params = [{k: v.reshape(S, K) for k, v in p.items()} for p in params["lens_mass"]]
        x, y = self.pos_x[:, None, :], self.pos_y[:, None, :]  # (S, 1, n)
        beta_x, beta_y = simulator.beta(x, y, lens_params)  # (S, K, n)
        det_abs = _clamped_det(simulator, x, y, lens_params)
        w = self.pos_mask[:, None, None, :]  # (S, 1, 1, n)
        n_img = torch.sum(self.pos_mask, dim=-1)[:, None]  # (S, 1)
        beta = torch.stack([beta_x, beta_y], dim=-2)  # (S, K, 2, n)
        bary = torch.sum(beta * w, dim=-1, keepdim=True) / n_img[..., None, None]
        err = torch.stack([self.pos_ex[:, None, :] * det_abs,
                           self.pos_ey[:, None, :] * det_abs], dim=-2)
        chi2 = torch.sum(((beta - bary) / err) ** 2 * w, dim=(-2, -1))  # (S, K)
        norm = torch.sum(torch.log(2 * math.pi * err**2) * w, dim=(-2, -1))
        log_like = -0.5 * (chi2 + norm)
        return log_like.reshape(S * K), (chi2 / (2.0 * n_img)).reshape(S * K)


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
        log_like = -0.5 * pixel_reduce(simulator, _pixel_sum, chi2_pix) + self._log_norm
        return log_like, pixel_reduce(simulator, _pixel_mean, chi2_pix)

    def stats_positions(self, simulator, params):
        raise NotImplementedError(
            "BackwardProbModel has no multiple-image position likelihood; "
            "use ForwardProbModel(include_positions=True) for position terms"
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


class SurveyBackwardProbModel(BackwardProbModel):
    """Scene-batched lstsq likelihood, the survey twin of
    :class:`BackwardProbModel`: ``observed_images`` is (S, H, W), batches
    are scene-major (``bs = S * K``), and each row's linear amplitudes are
    solved against its own scene's data (``LensSimulator.lstsq_simulate``
    with (S, H, W) data). ``background_rms`` / ``exp_time`` are scalars or
    (S,) arrays."""

    def __init__(self, prior: Prior, observed_images, background_rms, exp_time, device=None):
        obs = np.asarray(observed_images, np.float32)
        if obs.ndim != 3:
            raise ValueError(f"observed_images must be (S, H, W); got {obs.shape}")
        self.prior = prior
        self.device = resolve_device(device)

        def f32(v):
            return torch.as_tensor(np.asarray(v, np.float32), device=self.device)

        obs = f32(obs)
        bkg = f32(background_rms).reshape(-1, 1, 1)
        exp_t = f32(exp_time).reshape(-1, 1, 1)
        self.n_scenes = int(obs.shape[0])
        self.observed_image = obs
        self.err_map = torch.sqrt(bkg**2 + torch.clamp(obs, min=0.0) / exp_t)
        self._log_norm = -0.5 * torch.sum(torch.log(2 * math.pi * self.err_map**2),
                                          dim=(-2, -1))  # (S,)

    def stats_pixels(self, simulator, params):
        """(log_like, reduced_chi2), each (S * K,), with each row's linear
        amplitudes solved against its own scene."""
        S = self.n_scenes
        im = simulator.lstsq_simulate(params, self.observed_image, self.err_map)
        im = im.reshape(S, -1, *self.observed_image.shape[-2:])
        resid = (im - self.observed_image[:, None]) / self.err_map[:, None]
        chi2_pix = resid**2
        log_like = -0.5 * pixel_reduce(simulator, _pixel_sum, chi2_pix, S) + self._log_norm[:, None]
        return log_like.reshape(-1), pixel_reduce(simulator, _pixel_mean, chi2_pix, S).reshape(-1)
