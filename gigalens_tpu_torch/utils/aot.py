"""Cache keys for what a process builds and a later one may reuse (port of
:mod:`gigalens_tpu.utils.aot`).

The JAX module has two jobs: reuse, across processes, of what a fresh
process would otherwise rebuild (``jax.export`` artifacts of the traced and
lowered phase programs, and serialized executables), and a cache key
conservative enough that a stale artifact is never used. Eager PyTorch
traces and lowers nothing, so the port keeps the second job whole and the
first only where a measurement on the card calls for it: the one artifact
the port builds and reuses is the library of hand-written CUDA kernels
(``ops/cuda/_build.py``, under ``build/kernels/``), whose name hashes its
sources, its flags and target architecture, the ``nvcc --version`` that
compiled it, ``torch.version.cuda`` and :func:`platform_fingerprint`.

The correctness contract is the JAX module's: an artifact that embeds data
or host-specific code is silently wrong when stale, so the key hashes
conservatively, a structure the fingerprint cannot hash raises (a caller
then builds afresh, never "reuses anyway"), and nothing host-specific is
loaded from a store that outlives the host: the kernel library's key
carries the toolchain and the platform, so a tree carried to a machine
with another ``nvcc`` or CUDA builds its own.

The fingerprints keep the JAX module's names: :func:`package_fingerprint`
(the port's sources), :func:`host_fingerprint`, :func:`array_fingerprint`,
:func:`data_fingerprint` (tensors, numpy arrays and object graphs, closure
cells included) and :func:`phase_desc`. ``AOTProgram``, ``jax.export``,
the ``.jaxexec`` tier, the git-tracked store and ``_guarded_compiled``
have no counterpart: there is no traced program to export.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import pathlib
import platform
import types

import numpy as np
import torch


@functools.lru_cache(maxsize=1)
def package_fingerprint() -> str:
    """Content hash of every source file of the ``gigalens_tpu_torch``
    package: its ``.py`` files and its CUDA sources (``.cu``, ``.cuh``)."""
    root = pathlib.Path(__file__).resolve().parents[1]
    h = hashlib.sha256()
    for p in sorted(q for ext in ("*.py", "*.cu", "*.cuh") for q in root.rglob(ext)):
        h.update(str(p.relative_to(root)).encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def platform_fingerprint() -> str:
    """The host's architecture and operating system: what a shared library
    built here assumes of the machine that loads it."""
    return f"{platform.machine()}|{platform.system()}"


@functools.lru_cache(maxsize=1)
def host_fingerprint() -> str:
    """Fingerprint of everything host-specific that compiled code or a
    cached result may bake in: the CPU's feature flags (``/proc/cpuinfo``),
    :func:`platform_fingerprint`, the torch build and its CUDA version, and
    the CUDA cards' names and compute capabilities when there are any."""
    h = hashlib.sha256()
    try:
        for line in pathlib.Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("flags"):
                h.update(" ".join(sorted(line.split()[2:])).encode())
                break
    except OSError:
        h.update(platform.processor().encode())
    h.update(platform_fingerprint().encode())
    h.update(f"torch={torch.__version__}|cuda={torch.version.cuda}".encode())
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            h.update(f"{torch.cuda.get_device_name(i)}|{torch.cuda.get_device_capability(i)}"
                     .encode())
    return h.hexdigest()[:16]


def _as_numpy(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def array_fingerprint(*arrays) -> str:
    """Stable hash of the contents of numpy arrays and tensors (shape,
    dtype and bytes; a tensor's device does not enter)."""
    h = hashlib.sha256()
    for a in arrays:
        if a is None:
            h.update(b"none")
            continue
        a = _as_numpy(a)
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def _fp_update(h, obj, seen, depth=0):
    """Recursive structural and content hash for :func:`data_fingerprint`."""
    if depth > 32:
        raise ValueError("data_fingerprint: structure too deep")
    if obj is None or isinstance(obj, (bool, int, float, complex, str, bytes)):
        h.update(repr(obj).encode())
        return
    if isinstance(obj, (torch.dtype, torch.device)):
        h.update(f"<{obj}>".encode())
        return
    oid = id(obj)
    if oid in seen:
        h.update(b"<cycle>")
        return
    seen.add(oid)
    if isinstance(obj, (torch.Tensor, np.ndarray, np.generic)):
        a = _as_numpy(obj)
        if a.dtype.hasobject:
            raise ValueError("data_fingerprint: an object array is not content-hashable")
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(np.ascontiguousarray(a).tobytes())
        return
    if isinstance(obj, dict):
        h.update(b"{")
        for k in sorted(obj, key=repr):
            h.update(repr(k).encode())
            _fp_update(h, obj[k], seen, depth + 1)
        h.update(b"}")
        return
    if isinstance(obj, (list, tuple)):
        h.update(b"[")
        for v in obj:
            _fp_update(h, v, seen, depth + 1)
        h.update(b"]")
        return
    if isinstance(obj, types.ModuleType):
        h.update(f"<mod:{obj.__name__}>".encode())
        return
    if isinstance(obj, type):
        h.update(f"<class:{obj.__module__}.{obj.__qualname__}>".encode())
        return
    if isinstance(obj, functools.partial):
        h.update(b"<partial>")
        _fp_update(h, obj.func, seen, depth + 1)
        _fp_update(h, obj.args, seen, depth + 1)
        _fp_update(h, obj.keywords, seen, depth + 1)
        return
    if isinstance(obj, (types.FunctionType, types.MethodType, types.BuiltinFunctionType)) or (
            callable(obj) and not hasattr(obj, "__dict__")):
        # a function's identity, closure cells and defaults: two optimizers
        # built by the same code with other constants must differ (the
        # code itself is the package fingerprint's)
        h.update(b"<fn:")
        h.update(str(getattr(obj, "__module__", "")).encode())
        h.update(getattr(obj, "__qualname__", type(obj).__qualname__).encode())
        if getattr(obj, "__self__", None) is not None:
            _fp_update(h, obj.__self__, seen, depth + 1)
        for cell in getattr(obj, "__closure__", None) or ():
            try:
                contents = cell.cell_contents
            except ValueError:  # an empty cell
                h.update(b"<empty>")
                continue
            _fp_update(h, contents, seen, depth + 1)
        for dv in getattr(obj, "__defaults__", None) or ():
            _fp_update(h, dv, seen, depth + 1)
        h.update(b">")
        return
    if dataclasses.is_dataclass(obj):
        h.update(type(obj).__qualname__.encode())
        for f in dataclasses.fields(obj):
            h.update(f.name.encode())
            _fp_update(h, getattr(obj, f.name), seen, depth + 1)
        return
    if hasattr(obj, "__dict__"):
        # a plain object: its class and instance state; bound callables in
        # the state are skipped (their code is the package fingerprint's)
        h.update(type(obj).__qualname__.encode())
        state = vars(obj)
        for k in sorted(state):
            v = state[k]
            if callable(v) and not isinstance(v, (np.ndarray, torch.Tensor)):
                h.update(f"<callable:{k}>".encode())
                continue
            h.update(k.encode())
            _fp_update(h, v, seen, depth + 1)
        return
    raise ValueError(f"data_fingerprint: cannot hash {type(obj).__qualname__}")


def data_fingerprint(*objs) -> str:
    """Content hash of object graphs for cache keys: tensors and arrays
    (shape, dtype, bytes), scalars, containers, dataclasses, plain objects
    (class name and instance ``__dict__``) and functions (qualified name,
    closure cells, defaults). Raises ``ValueError`` on a structure it
    cannot hash: a caller then builds afresh, never reuses."""
    h = hashlib.sha256()
    seen = set()
    for o in objs:
        _fp_update(h, o, seen)
        h.update(b"\0")
    return h.hexdigest()[:24]


def phase_desc(*objs, mesh=None, extra=""):
    """Fingerprint of everything a phase closes over (prob model,
    simulator, optimizer) plus ``extra`` (step counts, batch sizes), or
    None under a mesh of several ranks or when the objects cannot be
    hashed: a phase that cannot be keyed is never served from a cache."""
    if mesh is not None and getattr(mesh, "size", 1) > 1:
        return None
    try:
        return data_fingerprint(*objs) + "|" + str(extra)
    except (ValueError, TypeError, RuntimeError):
        return None
