"""Joint prior over a nested dict/list of distributions.

PyTorch port of :mod:`gigalens_tpu.prob.prior`:

  * ``sample(generator, n)`` -> params tree, each leaf shaped ``(n, *event_shape)``
  * ``log_prob(x)``          -> ``(n,)`` log density in constrained space
  * ``unconstrain(x)``       -> ``(n, d)`` matrix of unconstrained parameters ``z``
  * ``constrain(z)``         -> params tree
  * ``fldj(z)``              -> ``(n,)`` sum of forward log-det-Jacobians
  * ``log_prob_z(z)``        -> constrained-space density + Jacobian factor

Column order is the JAX package's: ``jax.tree_util.tree_flatten`` visits
dict keys in *sorted* order (not insertion order) and lists in order, so the
bench prior's columns run ``lens_light, lens_mass, source_light`` and, inside
each profile, ``center_x, center_y, e1, ...``. :func:`_flatten` reproduces
that walk so both packages read the same ``z``.
"""
from __future__ import annotations

import numpy as np
import torch

from gigalens_tpu_torch.prob.distributions import Distribution


def _flatten(tree, is_leaf):
    """(leaves, structure, paths) in jax.tree_util order (sorted dict keys)."""
    if is_leaf(tree):
        return [tree], None, [()]
    if isinstance(tree, dict):
        keys = sorted(tree)
        children = [tree[k] for k in keys]
        node = ("dict", tuple(keys))
    elif isinstance(tree, (list, tuple)):
        keys = range(len(tree))
        children = list(tree)
        node = (type(tree).__name__, len(tree))
    else:
        raise TypeError(f"unsupported tree node {type(tree).__name__}")
    leaves, structs, paths = [], [], []
    for k, child in zip(keys, children):
        lv, st, ps = _flatten(child, is_leaf)
        leaves += lv
        structs.append(st)
        paths += [(k, *p) for p in ps]
    return leaves, (node, tuple(structs)), paths


def _unflatten(struct, leaves):
    it = iter(leaves)

    def build(st):
        if st is None:
            return next(it)
        (kind, spec), children = st
        vals = [build(c) for c in children]
        if kind == "dict":
            return dict(zip(spec, vals))
        return tuple(vals) if kind == "tuple" else vals

    return build(struct)


def _is_dist(x):
    return isinstance(x, Distribution)


def _is_array(x):
    return isinstance(x, (torch.Tensor, np.ndarray, float, int))


class Prior:
    def __init__(self, tree):
        self.tree = tree
        leaves, struct, paths = _flatten(tree, _is_dist)
        if not all(_is_dist(l) for l in leaves):
            bad = [type(l).__name__ for l in leaves if not _is_dist(l)]
            raise TypeError(f"Prior leaves must be Distributions, got {bad}")
        self.leaves = leaves
        self.struct = struct
        self._paths = paths
        self._event_sizes = [l.event_size for l in leaves]
        self._event_shapes = [l.event_shape for l in leaves]
        self._offsets = np.concatenate([[0], np.cumsum(self._event_sizes)]).astype(int)
        self.n_params = int(self._offsets[-1])

    @property
    def d(self) -> int:
        """Total number of unconstrained dimensions (z columns)."""
        return self.n_params

    def column_names(self):
        """Name per z column, in the JAX package's ``a/0/b`` path format."""
        names = []
        for path, leaf in zip(self._paths, self.leaves):
            base = "/".join(str(p) for p in path)
            if leaf.event_size == 1:
                names.append(base)
            else:
                names.extend(f"{base}[{i}]" for i in range(leaf.event_size))
        return names

    def sample(self, generator: torch.Generator, sample_shape=()):
        """Draws each leaf in column order from ``generator`` (on its device)."""
        if isinstance(sample_shape, int):
            sample_shape = (sample_shape,)
        samples = [l.sample(generator, sample_shape) for l in self.leaves]
        return _unflatten(self.struct, samples)

    def _flatten_like(self, x):
        xl, xstruct, _ = _flatten(x, _is_array)
        # Structure must match, not just leaf count: a tree with the same
        # number of leaves but different nesting would silently misalign
        # z columns against the prior leaves.
        if xstruct != self.struct:
            raise ValueError(
                "params tree structure does not match the prior: "
                f"got {xstruct}, prior expects {self.struct}"
            )
        return xl

    def log_prob(self, x):
        lp = 0.0
        for leaf, xv in zip(self.leaves, self._flatten_like(x)):
            lp = lp + leaf.log_prob(xv)
        return lp

    def unconstrain(self, x):
        """Constrained params tree -> (..., d) unconstrained matrix."""
        cols = []
        for leaf, xv, esh in zip(self.leaves, self._flatten_like(x), self._event_shapes):
            z = leaf.bijector.inverse(xv)
            batch_shape = z.shape[: z.ndim - len(esh)]
            cols.append(z.reshape(*batch_shape, leaf.event_size))
        return torch.cat(cols, dim=-1)

    def _check_width(self, z):
        if z.shape[-1] != self.n_params:
            raise ValueError(
                f"z has {z.shape[-1]} columns, prior has d={self.n_params}"
            )

    def _columns(self, z):
        batch_shape = z.shape[:-1]
        for leaf, esh, lo, hi in zip(
            self.leaves, self._event_shapes, self._offsets[:-1], self._offsets[1:]
        ):
            yield leaf, esh, z[..., lo:hi].reshape(*batch_shape, *esh)

    def constrain(self, z):
        """(..., d) unconstrained matrix -> constrained params tree."""
        self._check_width(z)
        out = [leaf.bijector.forward(zi) for leaf, _, zi in self._columns(z)]
        return _unflatten(self.struct, out)

    def fldj(self, z):
        """Sum of forward log-det-Jacobians over all columns; shape = batch."""
        self._check_width(z)
        total = torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)
        for leaf, esh, zi in self._columns(z):
            ld = leaf.bijector.forward_log_det_jacobian(zi)
            if esh:
                ld = torch.sum(ld, dim=tuple(range(-len(esh), 0)))
            total = total + ld
        return total

    def log_prob_z(self, z):
        """Prior density of unconstrained z (constrained log-prob + Jacobian)."""
        return self.log_prob(self.constrain(z)) + self.fldj(z)
