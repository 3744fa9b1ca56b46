"""Builds the hand-written CUDA kernels at first use and binds them with ctypes.

``nvcc`` compiles every ``gigalens_tpu_torch/csrc/*.cu`` into an object,
one process per source, all started together, and links the objects into
one shared library with a plain C interface, under ``build/kernels/``
beside the package, named by a hash of the sources and flags (a changed
source is a new library). No PyTorch headers are involved, so a build takes
seconds. A missing ``nvcc`` or a failed compile raises with the compiler's
output: there is no fallback.

Fast math stays off (no ``--use_fast_math``): the kernels' tolerances
assume IEEE ``expf``/``logf``/``sqrtf``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"
FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES = {
    # params, x, y, out, ox, oy, bs, npix, niter, save_omega, tiles, stream
    "gl_fused_render_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # params, x, y, ox, oy, ct, partial, grad, bs, npix, niter, stream
    "gl_fused_render_bwd": [_P] * 8 + [_I] * 3 + [_P],
    # x, out, t1 (re, im), z (re, im), u (re, im), 10 factors,
    # bs, H, W, fh, fw, oh, ow, stream
    "gl_dft_conv": [_P] * 18 + [_I] * 7 + [_P],
    # x (or ct), out, w, phase table, bs, H, W, pool, KH, KW, warps, HH, PW,
    # LDp, smem, stream (H, W: the image's size in both directions)
    "gl_direct_conv_fwd": [_P] * 4 + [_I] * 11 + [_P],
    "gl_direct_conv_transpose": [_P] * 4 + [_I] * 11 + [_P],
    # params, x, y, extras, out, records, n_mass, n_light, prefactors,
    # bs, npix, n_cols, n_sums, summed, stream
    "gl_fused_builder_fwd": [_P] * 6 + [_I, _I, _P] + [_I] * 5 + [_P],
    # params, x, y, extras, ct, partial, grad, records, n_mass, n_light,
    # prefactors, bs, npix, n_cols, n_sums, summed, stream
    "gl_fused_builder_bwd": [_P] * 8 + [_I, _I, _P] + [_I] * 5 + [_P],
}


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [shutil.which("nvcc")]
    if cuda_home:
        cands.append(str(Path(cuda_home) / "bin" / "nvcc"))
    cands.append(NVCC_DEFAULT)
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin and /usr/local/cuda/bin); "
        "the CUDA kernels cannot be built"
    )


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256()
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libgigalens_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> tuple[Path, float, str]:
    """Compiles the kernels unless the library for these sources exists.

    Returns (library path, seconds spent compiling, compiler output).
    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory and spills
    of each kernel).
    """
    extra = ["-Xptxas", "-v"] if verbose else []
    lib = library_path()
    if lib.exists() and not verbose:
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    nvcc = _nvcc()
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in cu]
    t0 = time.perf_counter()
    cmds = [[nvcc, *FLAGS, *extra, "-c", "-o", str(o), str(src)] for src, o in zip(cu, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]  # waits for every compile
    log = "".join(logs)
    for cmd, proc, out in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    for o in objs:
        o.unlink()
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{' '.join(cmd)}\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    return lib, secs, log


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with every signature declared."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.gl_error_string.argtypes = [ctypes.c_int]
    lib.gl_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raises on a nonzero ``cudaGetLastError()`` code from a C entry point."""
    if err != 0:
        msg = load().gl_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def check_arg(t, name: str, shape, device, dtype=torch.float32) -> None:
    """Validates a kernel argument before its pointer is passed: a
    contiguous ``dtype`` tensor of ``shape`` on the CUDA ``device``."""
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    """The current torch stream on ``device``: every kernel launches on it."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
