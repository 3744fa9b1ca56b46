"""Taylor-series mass profiles: fast cluster-member evaluation (port of
:mod:`gigalens_tpu.profiles.mass.series`).

The coefficients are the derivatives of the ordinary profile in one
parameter. The JAX package takes them in Taylor mode (``jet``); torch has
no jet, so :func:`taylor_derivs` nests ``torch.func.jvp`` with a ones
tangent, which costs 2^order primal passes (a one-time precompute).

At run time the deflection is one matmul: with the coefficients as a
``(order+1, 2*npix)`` matrix and per-sample powers ``(bs, order+1)``,

    alpha = amplitude * (powers @ coefs).

For a scaling relation (:class:`ScalingRelationSeries`) the chain rule in
the global series variable z (galaxy value r_g = z * u_g) gives

    coef_n = sum_g u_amp_g * u_ser_g^n * f^(n)(x; r = z0 * u_g),

so the whole population collapses into order+1 coefficient grids at
precompute time.

The coefficients apply only on the grid they were computed on
(:meth:`MassSeries.set_grid`). :meth:`MassSeries._on_grid` compares a
coordinate tensor's values with the grid once and then remembers the tensor
(by identity and in-place version), so a step on the card reads nothing
back to the host; the padded grid the fused builder's series stage takes is
built once per device after each :meth:`MassSeries.set_deriv`.
"""
from __future__ import annotations

import math
import weakref
from typing import Dict, List, Optional

import torch

from gigalens_tpu_torch.profiles.base import MassProfile, _like
from gigalens_tpu_torch.profiles.mass.scaling import ScalingRelation

S_BLK = 8  # the fused builder's coefficient grids come in rows of whole blocks of 8


def taylor_derivs(f, var0, order: int):
    """[f(var0), f'(var0), ..., f^(order)(var0)] along a ones tangent, by
    ``order`` nested ``torch.func.jvp`` calls: level k differentiates the
    list of derivatives 0..k-1, whose tangents are derivatives 1..k.

    ``f`` maps a tensor to one tensor (stack several outputs first)."""
    var0 = torch.as_tensor(var0)

    def derivs(k):
        if k == 0:
            return lambda v: (f(v),)
        inner = derivs(k - 1)

        def g(v):
            primals, tangents = torch.func.jvp(inner, (v,), (torch.ones_like(v),))
            return (primals[0], *tangents)

        return g

    return list(derivs(order)(var0))


class MassSeries(MassProfile):
    """Taylor expansion of ``profile`` in one parameter, with a linear
    amplitude.

    State API as the JAX package (``set_constants`` / ``set_grid`` /
    ``set_deriv`` / ``set_hessian``), with functional ``precompute_*``
    methods usable directly.
    """

    _name = "SeriesExpansion"

    def __init__(
        self,
        profile: MassProfile,
        series_param: Optional[str] = None,
        amplitude_param: Optional[str] = None,
        order: int = 3,
    ):
        self.profile = profile
        self.series_param = series_param or getattr(self, "_series_param")
        self.amplitude_param = amplitude_param or getattr(self, "_amplitude_param")
        self._name = f"SeriesExpansion-{profile.name}"
        self._params = [self.series_param, self.amplitude_param]
        self.constants = [p for p in profile.params
                          if p not in (self.series_param, self.amplitude_param)]
        self._order = int(order)
        super().__init__()

        self._series_var_0 = None
        self._constants_dict = {}
        self._x = self._y = None
        self._deriv_coefs = None  # (order+1, 2, npix)
        self._hessian_coefs = None  # (order+1, 3, npix): xx, xy, yy
        self._reset_caches()

    def _reset_caches(self):
        self._checked = []  # (weakref, version) of coordinates found equal to the grid
        self._device_cache = {}  # device copies of the coefficients, grid and constants
        self.grid_checks = 0  # value comparisons made (each a host read on the card)

    # ----------------------------------------------------------- state API
    @property
    def order(self):
        return self._order

    @property
    def series_var_0(self):
        return self._series_var_0

    def set_constants(self, params: Dict):
        self._constants_dict = dict(params)
        self._series_var_0 = torch.as_tensor(params[self.series_param], dtype=torch.float32)
        self._device_cache.clear()

    def set_grid(self, x, y):
        self._x, self._y = torch.as_tensor(x), torch.as_tensor(y)
        self._reset_caches()

    def set_deriv(self):
        self._deriv_coefs = self.precompute_deriv(self._order, self._x, self._y,
                                                  **self._constants_dict)
        self._device_cache.clear()

    def set_hessian(self):
        self._hessian_coefs = self.precompute_hessian(self._order, self._x, self._y,
                                                      **self._constants_dict)
        self._device_cache.clear()

    # --------------------------------------------------------- precompute
    def _base_kwargs(self, params: Dict, var, like):
        kw = {k: _like(v, like) for k, v in params.items() if k != self.series_param}
        kw[self.series_param] = var
        kw[self.amplitude_param] = torch.ones((), dtype=like.dtype, device=like.device)
        return kw

    def _var0(self, params, x):
        return torch.as_tensor(params[self.series_param], dtype=torch.float32, device=x.device)

    def precompute_deriv(self, order, x, y, **params):
        """(order+1, 2, ...) stack of d^n(alpha_x, alpha_y)/d series^n."""
        x, y = torch.as_tensor(x), torch.as_tensor(y)

        def f(var):
            fx, fy = self.profile.deriv(x, y, **self._base_kwargs(params, var, x))
            return torch.stack(torch.broadcast_tensors(fx, fy))

        with torch.no_grad():
            return torch.stack(taylor_derivs(f, self._var0(params, x), order))

    def precompute_hessian(self, order, x, y, **params):
        """(order+1, 3, ...) stack of d^n(f_xx, f_xy, f_yy)/d series^n."""
        x, y = torch.as_tensor(x), torch.as_tensor(y)

        def f(var):
            f_xx, f_xy, _, f_yy = self.profile.hessian(x, y, **self._base_kwargs(params, var, x))
            return torch.stack(torch.broadcast_tensors(f_xx, f_xy, f_yy))

        with torch.no_grad():
            return torch.stack(taylor_derivs(f, self._var0(params, x), order))

    # --------------------------------------------------------- evaluation
    def _powers(self, dv):
        """(bs, order+1) scaled powers dv^n / n!."""
        dv = torch.reshape(dv, (-1,))
        return torch.stack([dv**n / float(math.factorial(n)) for n in range(self._order + 1)],
                           dim=-1)

    def _poly_eval(self, coefs, var):
        """powers (bs, k) @ coefs (k, c, npix) -> (c, bs, npix), one matmul."""
        k, c = coefs.shape[0], coefs.shape[1]
        out = self._powers(self.dv(torch.as_tensor(var))) @ coefs.reshape(k, -1)  # (bs, c*npix)
        return torch.movedim(out.reshape(-1, c, *coefs.shape[2:]), 1, 0)

    def dv(self, var):
        """``var - var0``: the run-time shift of the evaluation, and the
        pack-time transform of the fused builder's series column. ``var0``
        is a 0-dim host tensor, which a device tensor takes as a scalar
        (no copy)."""
        return var - self._series_var_0

    def _on_grid(self, x):
        """True when ``x`` is the precomputed grid, so the coefficients apply.

        A different shape is off the grid (the exact fallback, e.g. for
        multiple-image centroids). The same shape with different values is
        a stale-coefficient bug and raises. A tensor found equal is
        remembered by identity and in-place version, so it is compared only
        once (each comparison reads the answer back to the host)."""
        if self._x is None:
            return False
        if x is self._x:
            return True
        if tuple(x.shape) != tuple(self._x.shape):
            return False
        for ref, version in self._checked:
            if ref() is x and x._version == version:
                return True
        self.grid_checks += 1
        if not torch.equal(x.detach(), self._x.to(x.device)):
            raise ValueError(
                "MassSeries: coordinates match the precomputed grid's shape "
                f"{tuple(x.shape)} but not its values; the stored series "
                "coefficients do not apply to this grid. Re-run set_grid/"
                "set_deriv/set_hessian on the new coordinates (or reshape "
                "off-grid points so the shapes differ and the exact fallback "
                "is used).")
        self._checked = [(r, v) for r, v in self._checked if r() is not None]
        self._checked.append((weakref.ref(x), x._version))
        return True

    def _coefs(self, name, device):
        """``_deriv_coefs`` / ``_hessian_coefs`` on ``device``, copied once."""
        key = (name, torch.device(device))
        hit = self._device_cache.get(key)
        if hit is None:
            hit = torch.as_tensor(getattr(self, name), dtype=torch.float32).to(device)
            self._device_cache[key] = hit
        return hit

    def series_grid(self, x):
        """The fused builder's coefficient grid on ``x``'s device: rows
        [0:k] the alpha_x coefficients, [k:2k] alpha_y (k = order+1), padded
        with zero rows to a multiple of 8; None before ``set_deriv`` or off
        the grid. Built once per device after each ``set_deriv``."""
        if self._deriv_coefs is None or not self._on_grid(x):
            return None
        key = ("series_grid", x.device)
        hit = self._device_cache.get(key)
        if hit is None:
            k = self._order + 1
            g = self._coefs("_deriv_coefs", x.device).transpose(0, 1).reshape(2 * k, -1)
            rows = -(-2 * k // S_BLK) * S_BLK
            hit = torch.cat([g, g.new_zeros((rows - 2 * k, g.shape[1]))]).contiguous()
            self._device_cache[key] = hit
        return hit

    def _constant(self, k, like):
        """The constant ``k`` as a tensor on ``like``'s device, made there
        once (a tensor made from a host number is a copy that waits for the
        device's queue)."""
        key = (k, like.device, like.dtype)
        hit = self._device_cache.get(key)
        if hit is None:
            hit = self._device_cache[key] = _like(self._constants_dict[k], like)
        return hit

    def _direct_kwargs(self, kwargs, like):
        """Full parameter set for exact evaluation off the precomputed grid."""
        kw = {k: self._constant(k, like) for k in self._constants_dict
              if k != self.series_param}
        kw.update(kwargs)
        return kw

    def deriv(self, x, y, **kwargs):
        x = torch.as_tensor(x)
        if self._deriv_coefs is None or not self._on_grid(x):
            # off-grid points (e.g. multiple-image centroids): the profile
            # itself, cheap for a handful of points
            return self._direct_deriv(x, y, **kwargs)
        amp = torch.reshape(torch.as_tensor(kwargs[self.amplitude_param]), (-1, 1))
        fx, fy = self._poly_eval(self._coefs("_deriv_coefs", x.device),
                                 kwargs[self.series_param])
        return amp * fx, amp * fy

    def _direct_deriv(self, x, y, **kwargs):
        return self.profile.deriv(x, y, **self._direct_kwargs(kwargs, x))

    def hessian(self, x, y, **kwargs):
        x = torch.as_tensor(x)
        if self._hessian_coefs is None or not self._on_grid(x):
            return self._direct_hessian(x, y, **kwargs)
        amp = torch.reshape(torch.as_tensor(kwargs[self.amplitude_param]), (-1, 1))
        f_xx, f_xy, f_yy = self._poly_eval(self._coefs("_hessian_coefs", x.device),
                                           kwargs[self.series_param])
        return amp * f_xx, amp * f_xy, amp * f_xy, amp * f_yy

    def _direct_hessian(self, x, y, **kwargs):
        return self.profile.hessian(x, y, **self._direct_kwargs(kwargs, x))


class ScalingRelationSeries(MassSeries):
    """Series expansion with a scaling-relation galaxy sum (module
    docstring). At inference the parameters are the global (amplitude,
    series) pair; everything else, the catalogue included, is folded into
    the precomputed coefficients."""

    def __init__(
        self,
        profile: MassProfile,
        series_param: str,
        amplitude_param: str,
        scaling_params: List[str],
        lum_star: float,
        scaling_params_power: Dict[str, float],
        galaxy_catalogue: Dict[str, List],
        order: int = 3,
        chunk_size: Optional[int] = None,
    ):
        super().__init__(profile, series_param, amplitude_param, order=order)
        # the catalogue bookkeeping of ScalingRelation, by composition
        self._rel = ScalingRelation(
            profile,
            scaling_params=scaling_params,
            lum_star=lum_star,
            scaling_params_power=scaling_params_power,
            galaxy_catalogue=galaxy_catalogue,
            chunk_size=chunk_size,
        )
        self.scaling_params = list(scaling_params)
        self.n_galaxy = self._rel.n_galaxy

    def _precompute_scaled(self, order, x, y, component_fn, **params):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        rel = self._rel
        unscaled, consts = rel.tables(x.device)
        var0 = self._var0(params, x)
        n = torch.arange(order + 1, dtype=torch.float32, device=x.device)
        total = None
        for ci in range(rel.n_chunks):
            u_amp = unscaled[self.amplitude_param][ci]  # (chunk,)
            u_ser = unscaled[self.series_param][ci]  # (chunk,)
            galaxy_params = {}
            for k in self.scaling_params:
                if k not in (self.series_param, self.amplitude_param):
                    galaxy_params[k] = _like(params[k], x) * unscaled[k][ci][:, None]
            for k in rel.not_scaling_params:
                galaxy_params[k] = consts[k][ci][:, None]

            def f(var):
                kw = dict(galaxy_params)
                kw[self.series_param] = var
                kw[self.amplitude_param] = torch.ones((), device=x.device)
                return torch.stack(torch.broadcast_tensors(*component_fn(x, y, **kw)))

            with torch.no_grad():
                stack = torch.stack(taylor_derivs(f, var0 * u_ser[:, None], order))
            # chain rule in the global variable and the amplitude weights
            w = u_amp[None, :] * u_ser[None, :] ** n[:, None]  # (order+1, chunk)
            contrib = torch.einsum("kc,kncp->knp", w.to(stack.dtype), stack)
            total = contrib if total is None else total + contrib
        return total  # (order+1, n_comp, npix)

    def _direct_deriv(self, x, y, **kwargs):
        return self._rel.deriv(x, y, **self._scales_for_direct(kwargs, x))

    def _direct_hessian(self, x, y, **kwargs):
        return self._rel.hessian(x, y, **self._scales_for_direct(kwargs, x))

    def _scales_for_direct(self, kwargs, like):
        """The global value of every scaling parameter (constants filled in)."""
        out = {}
        for k in self._rel.scaling_params:
            if k in kwargs:
                out[k] = kwargs[k]
            elif k in self._constants_dict:
                out[k] = self._constant(k, like)
            else:
                raise KeyError(f"missing scaling parameter {k}")
        return out

    def precompute_deriv(self, order, x, y, **params):
        return self._precompute_scaled(order, x, y, self.profile.deriv, **params)

    def precompute_hessian(self, order, x, y, **params):
        def comp(x, y, **kw):
            f_xx, f_xy, _, f_yy = self.profile.hessian(x, y, **kw)
            return f_xx, f_xy, f_yy

        return self._precompute_scaled(order, x, y, comp, **params)
