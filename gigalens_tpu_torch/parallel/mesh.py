"""Sample sharding over ranks (port of :mod:`gigalens_tpu.parallel.mesh`).

The JAX package runs one controller and lets XLA partition every jitted
step over a ``Mesh`` whose axis is the sample axis. The port runs one
process per device under ``torch.distributed``, the SPMD model of
``torchrun``: every rank drives its own device through the phase's host
loop on its shard of the samples, so the host cost a rank pays stays what
one device pays today. State shared by the samples (SVI's surrogate, HMC's
step size, trajectory length and preconditioner, SMC's temperatures) is
replicated: every rank computes it from the same collective results with
the same operations, so every host read comes out the same on every rank
and no rank takes a branch alone (a rank that did would hang the group).

Layout: a batch of ``n`` rows seen as ``G`` groups of ``n / G`` (``G = 1``
for a plain sample axis; the scenes of a survey or HMC's adaptation groups
otherwise) is sharded along the rows of each group: rank ``r`` holds rows
``[r * c, (r + 1) * c)`` of every group, ``c = n / (G * size)``, so its
shard is itself a group-major batch of ``G`` groups. Draws are made for the
global batch from the same seeded generator on every rank and each rank
keeps its rows, so N ranks draw the numbers one rank draws.

Parity with one process: every rank's result equals every other rank's
and one process's bitwise, wherever each per-row operation rounds the same
at a rank's share of the rows as at all of them. Two kinds do not, and run
at the global row count (:func:`at_global_rows`: this rank's rows among
filler rows for the other ranks'): a batched GEMM, whose algorithm the card
picks by the number of rows (HMC's and SMC's per-chain products), and a
per-row sum over an image's pixels, which the card splits among a block's
threads by the number of rows a call holds (the prob models' pixel terms
the lstsq solve and an unfused render's parameter gradients; a phase
simulator built for a rank carries the ``mesh`` it is a shard of).
``scripts/torch_row_independence.py`` measures them all: on the H100 each
row's log-density and gradient then equal one process's at 1, 2, 4 and 25
rows a rank for the bench, survey and cluster (dpie) scenes; the lstsq
model's gradient from 2 rows a rank. The pixelated-source model is not
padded (to rounding). SVI's gradient all-reduce adds in another order (to
rounding).

:class:`Mesh` with ``group=None`` is the one-rank mesh: no process group,
and every collective below returns its input. ``constrain_samples`` has no
counterpart: a rank already holds only its shard.

Collectives take tensors on the rank's device and use ``all_reduce``,
``all_gather`` and ``broadcast`` only, which ``gloo`` and ``nccl`` both
have, for CUDA tensors too (``gloo`` copies them through the host itself).
``nccl`` refuses two ranks on one GPU, so two ranks sharing a card run
under ``gloo``.
"""
from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
import warnings

import torch
import torch.distributed as dist

import gigalens_tpu_torch.model as gmodel


class Mesh:
    """One rank's view of a 1-D mesh of ranks over the sample axis: the
    process ``group`` (``None``: a one-rank mesh with no group), this
    rank's index and the group's size, and the rank's ``device``."""

    def __init__(self, device, group=None):
        self.device = torch.device(device)
        self.group = group
        if group is None:
            self.rank, self.size = 0, 1
        else:
            self.rank = dist.get_rank(group)
            self.size = dist.get_world_size(group)

    def __repr__(self):
        return f"Mesh(device={self.device}, rank={self.rank}, size={self.size})"


def _local_device():
    """The rank's device under ``torchrun``: the CUDA card ``LOCAL_RANK``,
    raising without one like :func:`~gigalens_tpu_torch.model.resolve_device`
    and when there are fewer cards than local ranks (two ranks would share
    a card, which ``nccl`` refuses)."""
    if not torch.cuda.is_available():
        return gmodel.resolve_device(None)
    local = os.environ.get("LOCAL_RANK")
    local = dist.get_rank() if local is None else int(local)
    if local >= torch.cuda.device_count():
        raise ValueError(f"LOCAL_RANK {local} needs card {local}, but this host has "
                         f"{torch.cuda.device_count()} CUDA device(s)")
    return torch.device("cuda", local)


def default_mesh(device=None) -> Mesh:
    """The world group when ``torch.distributed`` is initialized (the
    counterpart of JAX's "all devices"), else a one-rank mesh. ``device``
    defaults to the CUDA card (``cuda:LOCAL_RANK`` under ``torchrun``)."""
    if dist.is_available() and dist.is_initialized():
        device = _local_device() if device is None else torch.device(device)
        return Mesh(device, dist.group.WORLD)
    return Mesh(gmodel.resolve_device(device))


def _distributed(mesh) -> bool:
    return mesh is not None and mesh.group is not None


def _rank_rows(n, mesh, groups):
    if n % (groups * mesh.size):
        raise ValueError(f"{n} rows do not shard into {groups} group(s) over "
                         f"{mesh.size} ranks")
    return n // (groups * mesh.size)


def shard_samples(x, mesh, groups: int = 1, dim: int = 0):
    """This rank's rows of ``x`` along ``dim`` (see the module's layout)."""
    if mesh is None or mesh.size == 1:
        return x
    n = x.shape[dim]
    c = _rank_rows(n, mesh, groups)
    view = x.reshape(*x.shape[:dim], groups, n // groups, *x.shape[dim + 1:])
    out = view.narrow(dim + 1, mesh.rank * c, c)
    return out.reshape(*x.shape[:dim], groups * c, *x.shape[dim + 1:])


def gather_samples(x, mesh, groups: int = 1, dim: int = 0):
    """The inverse of :func:`shard_samples`: every rank's rows of ``x``
    along ``dim``, in global order, on every rank."""
    if not _distributed(mesh):
        return x
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    c = x.shape[dim] // groups
    shape = (*x.shape[:dim], groups, c, *x.shape[dim + 1:])
    out = torch.stack([p.reshape(shape) for p in parts], dim=dim + 1)
    return out.reshape(*x.shape[:dim], groups * c * mesh.size, *x.shape[dim + 1:])


def replicate(x, mesh):
    """Rank 0's ``x`` on every rank (a broadcast)."""
    if not _distributed(mesh):
        return x
    x = x.detach().clone().contiguous()
    dist.broadcast(x, src=dist.get_global_rank(mesh.group, 0), group=mesh.group)
    return x


def _all_reduce(op, mesh, xs):
    if _distributed(mesh):
        flat = torch.cat([x.detach().reshape(-1) for x in xs])
        dist.all_reduce(flat, op=op, group=mesh.group)
        xs = [p.reshape(x.shape) for p, x in zip(torch.split(flat, [x.numel() for x in xs]), xs)]
    return xs[0] if len(xs) == 1 else tuple(xs)


def all_sum(mesh, *xs):
    """Elementwise sums over the ranks of same-dtype tensors ``xs``, in one
    collective; returns one tensor for one input, else a tuple."""
    return _all_reduce(dist.ReduceOp.SUM, mesh, xs)


def all_max(mesh, *xs):
    """Elementwise maxima over the ranks (see :func:`all_sum`)."""
    return _all_reduce(dist.ReduceOp.MAX, mesh, xs)


def all_min(mesh, *xs):
    """Elementwise minima over the ranks (see :func:`all_sum`)."""
    return _all_reduce(dist.ReduceOp.MIN, mesh, xs)


def sample_sum(x, mesh, dim: int = 0):
    """The sum of ``x`` over the global sample axis ``dim``."""
    return all_sum(mesh, torch.sum(x, dim=dim))


def sample_mean(x, mesh, dim: int = 0):
    """The mean of ``x`` over the global sample axis ``dim``."""
    return sample_sum(x, mesh, dim) / (x.shape[dim] * (mesh.size if mesh is not None else 1))


def sample_max(x, mesh, dim: int = 0):
    return all_max(mesh, torch.amax(x, dim=dim))


def sample_min(x, mesh, dim: int = 0):
    return all_min(mesh, torch.amin(x, dim=dim))


def at_global_rows(fn, x, mesh, dim: int = 0):
    """``fn(x)`` for a row-wise ``fn`` (each output row depends on its own
    input row only, along ``dim``), evaluated at the global row count:
    this rank's rows ``x`` at their place among filler rows for the other
    ranks' (:func:`pad_rows`). A batched GEMM picks its algorithm, and with it every row's
    rounding, by the number of rows (seen on the card at 1000 against 500
    particles); at the global count each row rounds as on one rank."""
    if mesh is None or mesh.size == 1:
        return fn(x)
    return rank_rows(fn(pad_rows(x, mesh, dim)), mesh, dim)


def pad_rows(x, mesh, dim: int = 0):
    """This rank's rows ``x`` along ``dim`` at their place among the other
    ranks' rows, filled with copies of its first row (finite wherever its
    own rows are): the global row count's tensor of one group."""
    if mesh is None or mesh.size == 1:
        return x
    n = x.shape[dim]

    def fill(k):
        return x.narrow(dim, 0, 1).expand(*x.shape[:dim], k * n, *x.shape[dim + 1:])

    return torch.cat([fill(mesh.rank), x, fill(mesh.size - 1 - mesh.rank)], dim=dim)


def rank_rows(y, mesh, dim: int = 0):
    """The inverse of :func:`pad_rows`: this rank's rows of ``y``."""
    if mesh is None or mesh.size == 1:
        return y
    n = y.shape[dim] // mesh.size
    return y.narrow(dim, mesh.rank * n, n)


def barrier(mesh) -> None:
    """Returns on every rank once every rank has reached it (a one-element
    ``all_reduce``, so the mesh needs no other collective)."""
    if _distributed(mesh):
        all_sum(mesh, torch.zeros(1, device=mesh.device)).item()


def round_to_multiple(n: int, m: int, what: str = "samples") -> int:
    """Largest multiple of ``m`` <= n (at least ``m``), reference rounding.

    Warns when the count actually changes — result shapes (e.g. SMC particle
    arrays) differ from what the caller asked for, which should not pass
    silently."""
    rounded = max((n // m) * m, m)
    if rounded != n:
        warnings.warn(
            f"rounding {what} {n} -> {rounded} (multiple of the {m}-device "
            "mesh); result shapes follow the rounded count",
            stacklevel=2,
        )
    return rounded


def _rank_main(rank, fn, nprocs, backend, devices, workdir, timeout, args):
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{workdir}/rendezvous",
                            world_size=nprocs, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        out = fn(Mesh(device, dist.group.WORLD), *args)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, nprocs: int, backend: str, device, args=(), timeout: float = 600.0,
                workdir=None):
    """Runs ``fn(mesh, *args)`` in ``nprocs`` spawned processes, ranks of
    one ``backend`` process group on ``device`` (one for every rank, or a
    sequence of one a rank; a rank's ``Mesh``) that meet through a file in
    a fresh directory under ``workdir``. ``fn`` is
    a module-level function; what it returns is saved with ``torch.save``
    (plain containers of tensors and numbers). Returns the ranks' results
    in rank order. A rank that raises or exits nonzero, or ranks not all
    done within ``timeout`` seconds, raise here after every rank is
    stopped; the group's collectives time out after ``timeout`` too."""
    import torch.multiprocessing as mp

    if isinstance(device, (str, torch.device)):
        device = [device] * nprocs
    devices = [str(d) for d in device]
    if len(devices) != nprocs:
        raise ValueError(f"{len(devices)} devices for {nprocs} ranks")
    tmp = tempfile.mkdtemp(prefix="mesh_", dir=workdir)
    try:
        ctx = mp.start_processes(_rank_main, nprocs=nprocs, join=False, start_method="spawn",
                                 args=(fn, nprocs, backend, devices, tmp, timeout, args))
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=min(1.0, max(deadline - time.monotonic(), 0.0))):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{nprocs} {backend} ranks not done in {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), map_location="cpu")
                for r in range(nprocs)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
