"""Pixelated source reconstruction (semilinear inversion); port of
:mod:`gigalens_tpu.inversion`.

The source is an ``n_side^2``-pixel grid whose amplitudes are solved and
marginalized analytically inside every likelihood evaluation (Warren & Dye
2003; Suyu et al. 2006), so MAP/SVI/HMC/SMC run unchanged on the marginal
posterior over the lens (and ``lam``) parameters.

* Ray-traced supersampled pixels meet the source grid through separable
  bilinear hat weights, two ``(bs, npix, n_side)`` tensors; the mapping
  matrix is their per-pixel outer product, built a chunk of source rows at
  a time.
* Each chunk of source-pixel basis images runs through the simulator's own
  place -> PSF -> pool pipeline (on the card: the direct K4 both ways),
  giving the blurred mapping matrix ``C`` (bs, n_src, n_native_pix). Under
  autograd each chunk is checkpointed (non-reentrant): the backward
  rebuilds the chunk's basis images instead of holding them all.
* ``F = (C w) C^T + lam H`` and ``b = (C w) d`` are batched matmuls and the
  solve and log-determinant a batched Cholesky (``cholesky_ex``: a sample
  whose F is not positive definite gets NaN in its row and does not
  raise), all in float32 with TF32 off in both directions
  (:class:`_Marginal` carries its own backward for that).

Under autograd a chunk's backward needs only its outer product again (the
``nan_to_num`` of the simulator's pipeline keeps its input), and the
non-reentrant checkpoint stops its recompute there: the PSF convolution
runs once a chunk each way.

On a mesh rank (a simulator with a ``mesh``) every per-row reduction runs
as one process runs it: the ray-shooting and the lens light at the global
row count (their parameter gradients are sums over a row's pixels), the
mapping build in the global batch's chunks, and the Gram, Cholesky,
solves and pixel sums on this rank's rows among filler rows for the
others', so N ranks equal one process bit for bit. That costs a rank about
one process's step and most of its memory (``scripts/torch_row_independence.py
--inversion-cost``): the solve's batched GEMMs, triangular inverse and
sums round a row by the rows a call holds (``--inversion-stages``), and
calls of a fixed number of rows, which would spare a rank the other
ranks' rows, slow one process's step by a third.

:class:`SourceGrid`, :func:`gradient_regularizer` and :func:`_pick_chunk`
are numpy, copied from the JAX package as they are.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

import gigalens_tpu_torch.model as gmodel
import gigalens_tpu_torch.parallel.mesh as pmesh
from gigalens_tpu_torch.prob.prior import Prior
from gigalens_tpu_torch.profiles.base import _needs_graph
from gigalens_tpu_torch.simulator import _batched
from gigalens_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class SourceGrid:
    """Regular source-plane grid: ``n_side`` x ``n_side`` pixels spanning
    ``[center - extent, center + extent]`` on each axis."""

    n_side: int = 24
    extent: float = 1.0
    center_x: float = 0.0
    center_y: float = 0.0

    @property
    def n_src(self) -> int:
        return self.n_side * self.n_side

    @property
    def delta(self) -> float:
        return 2.0 * self.extent / (self.n_side - 1)

    @property
    def centers_x(self) -> np.ndarray:
        return self.center_x + np.linspace(
            -self.extent, self.extent, self.n_side
        ).astype(np.float32)

    @property
    def centers_y(self) -> np.ndarray:
        return self.center_y + np.linspace(
            -self.extent, self.extent, self.n_side
        ).astype(np.float32)


def gradient_regularizer(n_side: int, ridge: float = 0.0):
    """Gradient-Gram regularization matrix with zero-Dirichlet boundaries.

    ``H = Gx^T Gx + Gy^T Gy (+ ridge*I)`` where ``G{x,y}`` are
    forward-difference operators on the ``n_side^2`` grid (row-major,
    y-major flat index ``j = iy * n_side + ix``), including differences
    against an implicit zero ring outside the grid: they make ``H``
    positive definite on its own and charge flat pedestals, so the
    reconstruction decays to zero at the grid edge.

    Returns ``(H, logdet_H)`` with ``H`` float32 ``(n_src, n_src)`` and the
    log-determinant computed in float64.
    """
    n = int(n_side)
    k = n * n
    idx = np.arange(k).reshape(n, n)  # [iy, ix]

    def diff_gram(lo, hi):
        """Gram of rows (s[hi] - s[lo]); index -1 means the zero exterior."""
        lo, hi = lo.reshape(-1), hi.reshape(-1)
        g = np.zeros((lo.size, k), np.float64)
        r = np.arange(lo.size)
        m = lo >= 0
        g[r[m], lo[m]] = -1.0
        m = hi >= 0
        g[r[m], hi[m]] = 1.0
        return g.T @ g

    edge = np.full(n, -1)
    H = (
        diff_gram(idx[:, :-1], idx[:, 1:])
        + diff_gram(idx[:-1, :], idx[1:, :])
        + diff_gram(edge, idx[:, 0]) + diff_gram(idx[:, -1], edge)
        + diff_gram(edge, idx[0, :]) + diff_gram(idx[-1, :], edge)
        + ridge * np.eye(k)
    )
    sign, logdet = np.linalg.slogdet(H)
    if sign <= 0:
        raise ValueError(f"regularizer is not positive definite (ridge={ridge})")
    return H.astype(np.float32), float(logdet)


def _pick_chunk(n_side: int, max_cols: int = 256) -> int:
    """Largest divisor of ``n_side`` whose chunk (chunk * n_side source
    columns) stays under ``max_cols`` basis images per step."""
    best = 1
    for c in range(1, n_side + 1):
        if n_side % c == 0 and c * n_side <= max_cols:
            best = c
    return best


# Byte budget of one chunk's placed basis-image block (chunk * n_side, bs,
# h_ss, w_ss), the peak live intermediate of the mapping build; keyed to
# bs, as in the JAX package.
_CHUNK_BYTE_BUDGET = 128 * 2**20


def _at_global_rows(sim, fn, params):
    """``fn(sim, params)``, a tuple of (bs, ...) row-wise outputs of this
    rank's parameter rows ``params`` (a list of per-profile dicts); under a
    mesh evaluated on ``sim.global_view`` and cut back to this rank's rows,
    so that autograd's sums over a row's pixels (the parameters' gradients)
    add at the global row count."""
    mesh = sim.mesh
    if mesh is None or mesh.size == 1:
        return fn(sim, params)
    view, padded = sim.global_view(params)
    return tuple(pmesh.rank_rows(torch.broadcast_to(t, (view.bs, *t.shape[1:])), mesh)
                 for t in fn(view, padded))


@contextlib.contextmanager
def _full_fp32():
    """cuBLAS matmuls in full float32 (no TF32) inside, restored after."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _mT(x):
    return x.transpose(-1, -2)


class _Marginal(torch.autograd.Function):
    """The linear algebra of the inversion, in float32 with TF32 off in
    both directions. Per sample, with ``F = (C w) C^T + lam H`` and ``b =
    (C w) d``: ``s = F^{-1} b``, ``log det F``, ``b . s`` and the model
    ``C^T s``, plus cholesky_ex's ``info`` (nonzero: F not positive
    definite; that sample's outputs are then meaningless).

    The factor's inverse ``L^{-1}`` (one batched triangular solve against
    the identity: a tenth of ``cholesky_inverse``'s time on an H100,
    ``scripts/torch_inversion_linalg.py``) gives the forward's solve and
    the backward's ``F^{-1} = L^{-T} L^{-1}`` as matrix products. The
    backward differentiates C, d and lam (``w`` and ``H`` are constants):
    with ``u = F^{-1} (g_s + C g_model)``, ``grad_F = g_logdet F^{-1} - (u +
    g_bs s) s^T`` and ``grad_b = u + 2 g_bs s``; F is symmetric in C, so
    ``grad_C = (G + G^T) (C w) + grad_b (w d)^T + s g_model^T``. ``C w`` is
    kept from the forward."""

    @staticmethod
    def forward(ctx, C, w, d, lam, H):
        with _full_fp32():
            with span("inversion.gram"):
                Cw = C * w
                F = torch.matmul(Cw, _mT(C)) + lam[:, None, None] * H
                b = torch.matmul(Cw, d[..., None])  # (bs, k, 1)
            with span("inversion.cholesky"):
                L, info = torch.linalg.cholesky_ex(F)
                eye = torch.eye(F.shape[-1], dtype=F.dtype, device=F.device)
                Li = torch.linalg.solve_triangular(L, eye, upper=False)
                s = torch.matmul(_mT(Li), torch.matmul(Li, b))[..., 0]
                logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), -1)
            bs_dot = torch.sum(b[..., 0] * s, -1)
            with span("inversion.gram"):
                model = torch.matmul(s[:, None, :], C)[:, 0]  # C^T s: (bs, n)
        ctx.save_for_backward(C, Cw, w, d, H, Li, s)
        ctx.mark_non_differentiable(info)
        return s, logdet, bs_dot, model, info

    @staticmethod
    def backward(ctx, g_s, g_ld, g_bs, g_model, _):
        C, Cw, w, d, H, Li, s = ctx.saved_tensors
        with _full_fp32():
            with span("inversion.gram_backward"):
                g = g_s + torch.matmul(C, g_model[..., None])[..., 0]
            with span("inversion.cholesky_backward"):
                Finv = torch.matmul(_mT(Li), Li)
                u = torch.matmul(Finv, g[..., None])[..., 0]
                G = g_ld[:, None, None] * Finv - (u + g_bs[:, None] * s)[..., :, None] * s[..., None, :]
            gb = u + 2.0 * g_bs[:, None] * s
            with span("inversion.gram_backward"):
                # the two rank-1 terms as one rank-2 update of the product
                grad_C = torch.matmul(G + _mT(G), Cw).baddbmm_(
                    torch.stack([gb, s], -1),
                    torch.stack([torch.broadcast_to(w * d, g_model.shape), g_model], -2))
                grad_d = grad_lam = None
                if ctx.needs_input_grad[2]:
                    grad_d = torch.matmul(gb[:, None, :], C)[:, 0] * w
                    if grad_d.shape != d.shape:  # d broadcast over the batch
                        grad_d = grad_d.sum(0)
        if ctx.needs_input_grad[3]:
            grad_lam = torch.sum(G * H, dim=(-2, -1))
        return grad_C, None, grad_d, grad_lam, None


class PixelatedSourceProbModel(gmodel.VersionedAttrs, gmodel._SamplerFacade):
    """Marginal likelihood over nonlinear params with a pixelated source.

    A drop-in :class:`~gigalens_tpu_torch.model.ForwardProbModel`
    replacement for the inference routines (``log_prob(simulator, z) ->
    (lp, red_chi2)``): ``prior`` covers the lens mass (and optional
    parametric lens light) parameters, and the physical model must have
    ``source_light=[]`` (the grid is the source). Noise is a fixed error
    map, supplied or built from the observed image as
    ``sqrt(background_rms^2 + max(obs, 0) / exp_time)``.

    ``lam`` is the regularization strength: a float pins it; ``None`` reads
    it from ``params["source_pixelated"][0]["lam"]`` (a prior group such as
    ``source_pixelated=[dict(lam=LogNormal(0., 2.))]``). ``chunk`` source
    rows are built per step of the mapping matrix (``None``: as many as
    ``_CHUNK_BYTE_BUDGET`` allows at the simulator's bs). Data and the
    regularizer live as float32 on ``device`` (``None``: the CUDA card);
    ``logdet_H`` is a float64 host scalar.
    """

    def __init__(
        self,
        prior: Prior,
        observed_image,
        background_rms=None,
        exp_time=None,
        error_map=None,
        grid: Optional[SourceGrid] = None,
        lam: Optional[float] = None,
        reg_ridge: float = 0.0,
        chunk: Optional[int] = None,
        device=None,
    ):
        self.prior = prior
        self.device = gmodel.resolve_device(device)
        self.grid = grid if grid is not None else SourceGrid()
        self.lam = None if lam is None else float(lam)
        self.include_pixels = True
        self.include_positions = False

        obs = np.asarray(observed_image, np.float32)
        if obs.ndim != 2:
            raise ValueError(f"observed_image must be (H, W); got {obs.shape}")
        if error_map is not None:
            err = np.asarray(error_map, np.float32)
        else:
            err = np.sqrt(
                float(background_rms) ** 2 + np.clip(obs, 0, None) / float(exp_time)
            ).astype(np.float32)
        self.observed_image = torch.tensor(obs, device=self.device)
        self.error_map = torch.tensor(err, device=self.device)

        H_reg, self.logdet_H = gradient_regularizer(self.grid.n_side, reg_ridge)
        self.H_reg = torch.as_tensor(H_reg, device=self.device)
        # None = adaptive: chosen per simulator batch size in mapping_matrix
        self.chunk = int(chunk) if chunk else None
        if self.chunk and self.grid.n_side % self.chunk:
            raise ValueError(f"chunk={self.chunk} must divide n_side={self.grid.n_side}")

    def event_size(self, simulator) -> int:
        return simulator.n_live_pix

    def _lam_of(self, params):
        if self.lam is not None:
            return torch.tensor(self.lam, dtype=torch.float32, device=self.device)
        try:
            lam = params["source_pixelated"][0]["lam"]
        except (KeyError, IndexError, TypeError):
            raise ValueError(
                "lam=None requires a source_pixelated=[dict(lam=...)] prior "
                "group (or pass a fixed lam to PixelatedSourceProbModel)"
            )
        return torch.reshape(lam, (-1,))

    def chunk_rows(self, simulator) -> int:
        """Source rows a step of the mapping build: ``chunk``, or the
        largest divisor of n_side whose placed block fits the byte budget
        at the simulator's global bs (at most 256 basis images): a mesh
        rank builds its rows in one process's chunks, so that the
        gradient's sums over a chunk's rows add alike."""
        if self.chunk is not None:
            return self.chunk
        sim = simulator
        bs = sim.bs * (sim.mesh.size if sim.mesh is not None else 1)
        max_cols = max(1, _CHUNK_BYTE_BUDGET // (bs * sim.h_ss * sim.w_ss * 4))
        return _pick_chunk(self.grid.n_side, min(256, int(max_cols)))

    def mapping_matrix(self, simulator, lens_params):
        """Blurred mapping matrix ``C``: (bs, n_src, n_native_pix).

        Row ``C[:, j]`` is source pixel j's basis image: the hat footprint
        of its bilinear support ray-traced into the image plane,
        PSF-convolved and pooled by the simulator's own pipeline, flattened
        over native pixels (masked pixels zeroed)."""
        sim = simulator
        g = self.grid
        npix = sim.img_x.shape[0]
        bx, by = _at_global_rows(sim, lambda s, p: s.beta(s.img_x, s.img_y, p), lens_params)
        bx = torch.broadcast_to(bx, (sim.bs, npix))
        by = torch.broadcast_to(by, (sim.bs, npix))
        inv_d = float(np.float32(1.0 / g.delta))
        cx = torch.as_tensor(g.centers_x, device=bx.device)[:, None, None]
        cy = torch.as_tensor(g.centers_y, device=bx.device)[:, None, None]
        # separable bilinear hat weights, source axis leading: (n_side, bs, npix)
        wx = torch.clamp(1.0 - torch.abs(bx - cx) * inv_d, min=0.0)
        wy = torch.clamp(1.0 - torch.abs(by - cy) * inv_d, min=0.0)

        n = g.n_side
        m = self.chunk_rows(sim)
        masked = sim._rows is not None
        mask_flat = sim.img_region.reshape(-1)

        def body(wyc, wx):
            # (m, n, bs, npix): basis image j = iy * n + ix of chunk rows iy
            A = (wyc[:, None] * wx[None]).reshape(m * n, sim.bs, npix)
            img = sim._postprocess(sim._place(A)).reshape(m * n, sim.bs, -1)
            return img * mask_flat if masked else img

        # chunks over source rows; under autograd each is checkpointed: the
        # backward rebuilds its basis images instead of holding every conv
        # intermediate at once
        remat = _needs_graph(wx, wy)
        chunks = []
        for c in range(n // m):
            wyc = wy[c * m:(c + 1) * m]
            out = checkpoint(body, wyc, wx, use_reentrant=False) if remat else body(wyc, wx)
            chunks.append(out.movedim(0, 1))
        return torch.cat(chunks, dim=1)  # (bs, n_src, n_nat)

    def _lens_light_flat(self, simulator, params):
        """Parametric lens light on native pixels: (bs, n_nat), or None."""
        sim = simulator
        profs = sim.phys_model.lens_light
        if not profs:
            return None

        def light(s, lens_light):
            total = 0.0
            for prof, p, c in zip(profs, lens_light, s._lens_light_constants):
                total = total + prof.light(s.img_x, s.img_y, **_batched(p), **c)
            return (torch.broadcast_to(total, (s.bs, s.img_x.shape[0])),)

        (total,) = _at_global_rows(sim, light, params["lens_light"])
        img = sim._postprocess(sim._place(total))
        return (img * sim.img_region).reshape(sim.bs, -1)

    def solve(self, simulator, params):
        """Full inversion at constrained ``params``.

        Returns a dict: ``source`` (bs, n_side, n_side) MAP source
        amplitudes, ``model_image`` (bs, H, W), ``log_marginal`` (bs,) the
        marginalized pixel log-likelihood, ``red_chi2`` (bs,) at the solved
        source. A sample whose F is not positive definite gets NaN in each
        (as the JAX package's Cholesky gives), the others are unaffected.
        """
        sim = simulator
        g = self.grid
        C = self.mapping_matrix(sim, params["lens_mass"])
        ll = self._lens_light_flat(sim, params)
        lam_b = torch.broadcast_to(torch.reshape(self._lam_of(params), (-1,)), (sim.bs,))
        rows = (C, lam_b) if ll is None else (C, lam_b, ll)
        # the Gram, the Cholesky, the solves and the pixel sums at the global
        # row count: the card picks their algorithms and splits each row's
        # sums by the rows a call holds
        mesh = sim.mesh
        out = self._solve_rows(sim.img_region, *(pmesh.pad_rows(t, mesh) for t in rows))
        s, model, log_marginal, chi2 = (pmesh.rank_rows(t, mesh) for t in out)
        H_img, W_img = self.observed_image.shape
        return dict(
            source=s.reshape(sim.bs, g.n_side, g.n_side),
            model_image=model.reshape(sim.bs, H_img, W_img),
            log_marginal=log_marginal,
            red_chi2=chi2 / sim.n_live_pix,
        )

    def _solve_rows(self, mask, C, lam_b, ll=None):
        """The marginal solve, under the pixel ``mask``, of rows ``C`` (bs,
        n_src, n_nat), ``lam_b`` (bs,) and the lens light ``ll`` (bs, n_nat)
        or None: the source (bs, n_src), the model (bs, n_nat),
        log_marginal and chi2 (bs,)."""
        w = (mask / self.error_map**2).reshape(-1)
        norm = torch.sum(torch.log(2 * math.pi * self.error_map**2) * mask)
        d = (self.observed_image * mask).reshape(-1)
        d_eff = d - ll if ll is not None else d
        s, logdet_F, bs_dot, model, info = _Marginal.apply(C, w, d_eff, lam_b, self.H_reg)
        ok = info == 0
        nan = torch.tensor(float("nan"), dtype=s.dtype, device=s.device)
        # E_min = (d - C^T s)^T W (d - C^T s) + lam s^T H s  at  s = F^{-1} b
        quad = torch.sum(w * d_eff * d_eff, dim=-1) - bs_dot
        k = self.grid.n_src
        log_marginal = -0.5 * (quad + logdet_F - k * torch.log(lam_b) - self.logdet_H + norm)
        log_marginal = torch.where(ok, log_marginal, nan)
        s = torch.where(ok[:, None], s, nan)
        model = torch.where(ok[:, None], model, nan)
        if ll is not None:
            model = model + ll
        resid = d - model
        chi2 = torch.sum(w * resid * resid, dim=-1)
        return s, model, log_marginal, chi2

    def stats_pixels(self, simulator, params):
        out = self.solve(simulator, params)
        return out["log_marginal"], out["red_chi2"]

    def stats_positions(self, simulator, params):
        raise NotImplementedError(
            "PixelatedSourceProbModel has no position likelihood; use "
            "ForwardProbModel for multiple-image position terms"
        )

    def log_prob(self, simulator, z):
        """Unconstrained marginal log posterior and reduced chi2; z (bs, d)."""
        with span("likelihood.log_prob"):
            x = self.prior.constrain(z)
            log_like, red_chi2 = self.stats_pixels(simulator, x)
            log_prior = self.prior.log_prob(x) + self.prior.fldj(z)
            return log_like + log_prior, red_chi2

    def log_like(self, simulator, z):
        return self.stats_pixels(simulator, self.prior.constrain(z))[0]
