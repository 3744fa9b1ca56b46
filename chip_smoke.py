#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (gigalens_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py             # everything below
    python3 chip_smoke.py --kernels   # steps 1-4 only, a development aid: its
                                      # kernels line says "partial": true, has no
                                      # launch counts, and no ok line follows

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the hand-written kernels from gigalens_tpu_torch/csrc/ with nvcc
   into build/kernels/ and prints the build time and ptxas resource usage.
3. Checks every kernel of the MAP path against its plain PyTorch twin at the
   main-path shapes (bs=500 samples, 25,600 supersampled pixels, niter=23;
   the PSF conv at (500, 160, 160) and its transpose at (500, 80, 80)), on
   inputs drawn from the bench prior, and times kernel and twin with CUDA
   events. K4 is checked by both routes: the direct strided sum that the
   main path takes and the DFT chain it replaced (same inputs, same run),
   beside one PyTorch call of the same function (F.conv2d and
   F.conv_transpose2d, cuDNN with TF32 off: timed only, the port never
   calls it). K1, K2, K3 and K4-direct must give bitwise-equal results
   twice; K2's Omega is also held to its float32 twin at OMEGA_TWIN_ATOL.
   Each kernel's bound is the larger of its operations over the FP32 peak
   and its bytes over the memory rate (K4's operations are its function's,
   counted from its shapes and the same for both routes, the renders' by
   counting the elementwise operations of their plain one-stage versions
   on the same inputs: the two-stage twins hoist per-sample work, which
   would lower the count the bound is made of).
4. Checks the composable render's kernels the same way: K5 (summed) and K7
   at the shapelet-source family's full width (family S: EPL(23)+Shear,
   SersicEllipse lens light, Shapelets(6) source with sampled amplitudes;
   bs=500, 25,600 pixels, 46 packed columns), K6 and K7's components mode
   at the lstsq family's (family L: SersicEllipse[lstsq] +
   Shapelets(4)[lstsq], 16 components), every stage once at a smaller
   batch (six model families, as tests/test_fused_builder.py, and a
   Taylor-series stage on seeded coefficient grids), and ragged shapes. K7
   is held against float64 autograd of the one-stage forward and against
   its float32 two-stage twin, and must give bitwise-equal results twice.
5. Runs the MAP phase of the bench scene (bench.py: EPL+Shear, SersicEllipse
   lens light and source, 80x80 px at 0.065", supersample 2, the 25x25
   Gaussian fallback PSF) through ModellingSequence: truth from a seeded
   generator rendered by the port, noise at bkg 0.2 / exp_time 100, then
   multi-start Adam (50 steps) from 500 prior draws and best_map_start.
   Then the same for family S (ForwardProbModel, K5/K7 + K4) and family L
   (BackwardProbModel with lstsq_simulate, K6/K7 + K4 over 16 x 500
   images). Each phase zeroes the launch counters just before it and reads
   them just after.
6. Runs the bench pipeline (gigalens_tpu_torch.bench.run_pipeline, the
   full configuration with HMC seed 2): MAP 500 x 350, FD Laplace, SVI
   1000 x 300, HMC 50 chains x (250 + 750) ChEES, under the bench gates
   (best-MAP and posterior red-chi2 <= 1.1, max split-R-hat <= 1.02),
   with K2/K3 and the direct K4 both ways required in MAP and SVI and K2/K3
   without any K4 in HMC; then checks K2/K3 at the SVI (1000 surrogate
   draws) and HMC (the 50 chains' last states) shapes, and the direct K4 at
   the SVI shape, against their float64 twins.
7. Ends with the card line, a JSON line of per-kernel results and the ok
   line.

Every phase raises on failure (nothing is caught), so any failure exits
nonzero before the ok line. Without a CUDA device it exits nonzero at once.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# tolerances of the kernel-vs-twin checks
# K1/K2 surface brightness. Bench-prior draws reach ~1e6 at profile centers
# and steep Sersic sources amplify float32 rounding of the ray-shot
# position: the float32 twin itself is off its float64 self by up to
# ~2e-4 relative at a few of the 12.8M pixels, so rtol is 1e-3, not 1e-4.
FWD_RTOL, FWD_ATOL = 1e-3, 2e-3
OMEGA_ATOL = 1e-4  # K2's angular series (|Omega| ~ 1), against float64
# K2's Omega against its float32 twin: the same arithmetic line for line, so
# only nvcc's contraction of a * b + c into one FMA separates them (measured
# 4.8e-7 on the 500 bench-prior draws, 4 float32 ulp of |Omega| ~ 1)
OMEGA_TWIN_ATOL = 2e-6
# K3, per parameter column, of the column's max |gradient| against float64.
# The float32 twin itself is 1.0e-3 (random cotangent) to 1.4e-3 (smooth
# cotangent) off float64 on these inputs, all from one bench-prior draw
# with a very steep, bright source (gradients ~3e7), so the bound is 2e-3.
GRAD_REL = 2e-3
CONV_REL = 1e-4  # K4, of the output's max |value|
# K5/K6 surface brightness against the float64 twin: the bounds of K1/K2,
# for the same reasons (bench-prior Sersic lens light up to ~1e6 at its
# center, steep sources amplifying the rounding of the ray-shot position).
BUILDER_FWD_RTOL, BUILDER_FWD_ATOL = 1e-3, 2e-3
# K7, per packed column, of the column's max |gradient| against float64
# autograd of the twin: K3's bound, set by the float32 twin's own error.
BUILDER_GRAD_REL = 2e-3
# Coverage families, of the reference's max |value| / per-column max
# |gradient|: 1e-4 for values (moderate uniform draws, no 1e6 centers; the
# float32 twin is off its float64 self by up to ~3e-6 on them) and K3's
# 2e-3 for gradients. The NFW family's deflections of several arcsec into
# a steep Sersic amplify float32 rounding (tests/test_fused_builder.py
# bounds it at 5e-4 / 5e-3 against the unfused render).
COVER_TOL = {"nfw_ellipse_halo": (5e-4, 5e-3)}
COVER_DEFAULT = (1e-4, 2e-3)
COVER_BS = 16

# peak rates of one H100 SXM at 700 W (NVIDIA's data sheet): FP32 outside
# the tensor cores, and HBM3
FP32_PEAK, HBM_RATE = 67e12, 3.35e12

BS, NUM_PIX, SUPERSAMPLE, DELTA_PIX = 500, 80, 2, 0.065
MAP_STEPS = 50
FAMILY_NITER, SHAPELET_NMAX, LSTSQ_NMAX = 23, 6, 4


def bench_prior():
    from gigalens_tpu_torch import bench

    return bench.bench_prior()


def bench_scene():
    """(phys, cfg, niter) of the bench scene (gigalens_tpu_torch/bench.py)."""
    from gigalens_tpu_torch import bench

    return bench.bench_scene(NUM_PIX)


def family_prior(kind):
    """Family S's prior (scripts/bench_fused_families.py:41-66: the bench
    lens and lens light, a shapelet source with Normal(0, 50) amplitudes)
    or family L's (the same without the linear amplitudes)."""
    from gigalens_tpu_torch.prob import Prior
    from gigalens_tpu_torch.prob import distributions as d

    tree = bench_prior().tree
    source = dict(beta=d.LogNormal(math.log(0.2), 0.2), center_x=d.Normal(0, 0.25),
                  center_y=d.Normal(0, 0.25))
    if kind == "S":
        n = (SHAPELET_NMAX + 1) * (SHAPELET_NMAX + 2) // 2
        source.update({f"amp{str(i).zfill(len(str(n)))}": d.Normal(0.0, 50.0) for i in range(n)})
        return Prior(dict(lens_mass=tree["lens_mass"], lens_light=tree["lens_light"],
                          source_light=[source]))
    lens_light = {k: v for k, v in tree["lens_light"][0].items() if k != "Ie"}
    return Prior(dict(lens_mass=tree["lens_mass"], lens_light=[lens_light],
                      source_light=[source]))


def family_model(kind):
    """Family S: [EPL(23), Shear] + [SersicEllipse] + [Shapelets(6)];
    family L: [EPL(23), Shear] + [SersicEllipse[lstsq]] + [Shapelets(4)[lstsq]]
    (scripts/bench_fused_families.py:83-131)."""
    from gigalens_tpu_torch import PhysicalModel
    from gigalens_tpu_torch.profiles.light import SersicEllipse, Shapelets
    from gigalens_tpu_torch.profiles.mass import EPL, Shear

    if kind == "S":
        return PhysicalModel([EPL(FAMILY_NITER), Shear()], [SersicEllipse()],
                             [Shapelets(SHAPELET_NMAX)])
    return PhysicalModel([EPL(FAMILY_NITER), Shear()], [SersicEllipse(use_lstsq=True)],
                         [Shapelets(LSTSQ_NMAX, use_lstsq=True)])


def cuda_ms(fn, reps=10, warmup=2):
    """Mean milliseconds per call from CUDA events around ``reps`` calls.
    The stream first spins for ~10 ms, so the calls queue up behind the spin
    and the events time the device, not the host's enqueue (a wrapper takes
    ~60 us of host time a call, twice K2's time at 50 samples)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # cycles
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(ops, tensors):
    """(bound_ms, bound_by): the larger of ``ops`` FP32 operations over the
    FP32 peak and the bytes of ``tensors`` (each input read once, each
    output written once) over the memory rate."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    t_ops, t_bytes = ops / FP32_PEAK, nbytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def k4_bound(conv, arg, out):
    """K4's bound (either route, either direction): its function's work,
    counted from shapes and not from one algorithm's (the direct kernel's
    padded taps, the chain's DFT products). 2 FP32 operations per
    multiply-add of the direct sum, out pixels x pooled-kernel taps per
    sample; bytes of the input, the pooled kernel and the output."""
    import torch

    kh, kw = conv.kh + conv.pool - 1, conv.kw + conv.pool - 1
    ops = 2 * arg.shape[0] * conv.out_h * conv.out_w * kh * kw
    return bound(ops, [arg, torch.empty((kh, kw)), out])


def count_ops(fn):
    """Operations of one call of a plain version: each elementwise op counts
    its output's elements, each sum or cumsum its input's (an exp or a
    division counts as one; indexing, copies and fills count nothing)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    reductions = (torch.ops.aten.sum, torch.ops.aten.cumsum)

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if torch.Tag.pointwise in func.tags and isinstance(out, torch.Tensor):
                self.n += out.numel()
            elif func.overloadpacket in reductions:
                self.n += args[0].numel()
            return out

    with Count() as c:
        fn()
    return c.n


@contextlib.contextmanager
def no_tf32():
    """cuDNN in full FP32 for the library yardsticks, restored after."""
    import torch

    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def check_close(name, got, want, rtol, atol):
    err = (got.double() - want.double()).abs()
    bound = atol + rtol * want.double().abs()
    worst = float((err - bound).max())
    if not math.isfinite(float(err.max())) or worst > 0:
        raise AssertionError(f"{name}: max |err| {float(err.max()):.3e} exceeds "
                             f"rtol {rtol} / atol {atol}")
    return float(err.max())


def check_rel(name, got, want, rel, dim=None):
    """max |got - want| / max |want| (per column along ``dim`` if given)."""
    err = (got.double() - want.double()).abs()
    scale = want.double().abs()
    if dim is None:
        r = err.max() / scale.max()
    else:
        r = (err.amax(dim) / scale.amax(dim).clamp_min(1e-30)).max()
    r = float(r)
    if not math.isfinite(r) or r > rel:
        raise AssertionError(f"{name}: relative error {r:.3e} exceeds {rel}")
    return r, float(err.max())


def chunked(fn, n, step, *tensors):
    import torch

    return torch.cat([fn(*(t[i:i + step] for t in tensors)) for i in range(0, n, step)])


def kernel_checks():
    import torch

    from gigalens_tpu_torch.ops.cuda import fused_render as fr
    from gigalens_tpu_torch.simulator import LensSimulator

    dev = torch.device("cuda")
    phys, cfg, niter = bench_scene()
    sim = LensSimulator(phys, cfg, bs=BS, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = fr.pack_params(bench_prior().sample(gen, BS)).contiguous()
    x, y = sim.img_x, sim.img_y
    npix = x.shape[0]
    print(f"kernel checks: bs={BS} npix={npix} niter={niter}", flush=True)
    kernels = []

    def f64_fwd(p):
        return fr.fused_render_fwd_reference(p.double(), x.double(), y.double(), niter)

    # K1: forward only
    out_k = fr.fused_render_fwd(params, x, y, niter)
    torch.cuda.synchronize()
    out32, ox32, oy32 = fr.fused_render_fwd_reference(params, x, y, niter)
    out64 = chunked(lambda p: f64_fwd(p)[0], BS, 50, params)
    check_close("K1 vs f32 twin", out_k, out32, FWD_RTOL, FWD_ATOL)
    e1 = check_close("K1 vs f64 twin", out_k, out64, FWD_RTOL, FWD_ATOL)
    if not torch.equal(out_k, fr.fused_render_fwd(params, x, y, niter)):
        raise AssertionError("K1 is not deterministic from run to run")
    ms = cuda_ms(lambda: fr.fused_render_fwd(params, x, y, niter))
    pms = cuda_ms(lambda: fr.fused_render_fwd_reference(params, x, y, niter), reps=3, warmup=1)
    # the bound's operations: the function's own, in its one-stage form
    ops_fwd = count_ops(lambda: fr.fused_render_fwd_onestage(params, x, y, niter))
    b_ms, b_by = bound(ops_fwd, [params, x, y, out_k])
    kernels.append(dict(name="fused_render_fwd<false> (K1)", key="fused_render_fwd",
                        route="cuda", source="gigalens_tpu_torch/csrc/fused_render.cu",
                        replaces="gigalens_tpu/ops/pallas/fused_render.py:265",
                        max_abs_err=e1, ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                        library_ms=None))
    print(f"K1: max|err| vs f64 {e1:.3e}  kernel {ms:.3f} ms  twin {pms:.3f} ms  bound "
          f"{b_ms:.3f} ms ({b_by}, {ops_fwd / (BS * npix):.1f} ops per sample-pixel)",
          flush=True)

    # K2: forward + Omega residuals
    out_k2, ox_k, oy_k = fr.fused_render_fwd(params, x, y, niter, save_omega=True)
    torch.cuda.synchronize()
    ox64, oy64 = (chunked(lambda p, i=i: f64_fwd(p)[i], BS, 50, params) for i in (1, 2))
    e2 = check_close("K2 out vs f64 twin", out_k2, out64, FWD_RTOL, FWD_ATOL)
    check_close("K2 out vs f32 twin", out_k2, out32, FWD_RTOL, FWD_ATOL)
    e_om = max(check_close("K2 ox vs f64 twin", ox_k, ox64, 0.0, OMEGA_ATOL),
               check_close("K2 oy vs f64 twin", oy_k, oy64, 0.0, OMEGA_ATOL))
    e_tw = max(check_close("K2 ox vs f32 twin", ox_k, ox32, 0.0, OMEGA_TWIN_ATOL),
               check_close("K2 oy vs f32 twin", oy_k, oy32, 0.0, OMEGA_TWIN_ATOL))
    if not torch.equal(out_k, out_k2):
        raise AssertionError("K1 and K2 disagree on the image")
    k2_repeatable(params, x, y, niter, (out_k2, ox_k, oy_k), f"bench bs={BS}")
    ms = cuda_ms(lambda: fr.fused_render_fwd(params, x, y, niter, save_omega=True))
    b_ms, b_by = bound(ops_fwd, [params, x, y, out_k2, ox_k, oy_k])
    kernels.append(dict(name="fused_render_fwd<true> (K2)", key="fused_render_fwd_omega",
                        route="cuda", source="gigalens_tpu_torch/csrc/fused_render.cu",
                        replaces="gigalens_tpu/ops/pallas/fused_render.py:246",
                        max_abs_err=max(e2, e_om), ms=ms, plain_ms=pms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=None))
    print(f"K2: max|err| out {e2:.3e} omega {e_om:.3e} (vs f32 twin {e_tw:.3e}), bitwise "
          f"repeatable and equal to K1's image  kernel {ms:.3f} ms  twin {pms:.3f} ms  "
          f"bound {b_ms:.3f} ms ({b_by})", flush=True)
    del out64, ox64, oy64

    # K3: parameter gradient, against torch autograd of the twin in f64
    ct = torch.randn((BS, npix), generator=gen, device=dev)
    kernels.append(k3_check(params, x, y, ox_k, oy_k, ct, niter, f"bench bs={BS}",
                            (ox32, oy32)))
    del ox32, oy32

    # K4: the PSF conv on the K1 images, by the direct route the main path
    # takes and by the DFT chain it replaced (same inputs, same run)
    conv = sim._conv
    if conv is None or conv.mode != "dft" or conv.route != "direct":
        raise AssertionError(f"the CUDA simulator should take the direct dft conv, got {conv}")
    xin = out_k.reshape(BS, NUM_PIX * SUPERSAMPLE, NUM_PIX * SUPERSAMPLE).contiguous()
    ctc = torch.randn((BS, NUM_PIX, NUM_PIX), generator=gen, device=dev)
    print(f"K4: route {conv.route}, pooled kernel {tuple(conv._direct.w_ref.shape)}, "
          f"fshape {conv.fshape}", flush=True)
    rows, lib = direct_checks(conv, xin, ctc, f"bench bs={BS}")
    kernels += rows + chain_checks(conv, xin, ctc, lib)
    ragged_checks(params, x, y, niter, gen)
    return kernels


def k2_repeatable(params, x, y, niter, first, where):
    """K2 has no reduction: a second call must give the same bits."""
    import torch

    from gigalens_tpu_torch.ops.cuda import fused_render as fr

    again = fr.fused_render_fwd(params, x, y, niter, save_omega=True)
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError(f"K2 is not deterministic from run to run ({where})")


def k3_check(params, x, y, ox, oy, ct, niter, where, omega32=None):
    """K3 against float64 torch autograd of the forward twin (and, given the
    twin's own Omega, the float32 hand-VJP twin); bitwise equal over two
    calls; timed against the float32 twin. Returns its kernels row."""
    import torch

    from gigalens_tpu_torch.ops.cuda import fused_render as fr

    bs = params.shape[0]
    g_k = fr.fused_render_bwd(params, x, y, ox, oy, ct, niter)
    torch.cuda.synchronize()

    def grad64(p, c):
        p = p.double().requires_grad_(True)
        out = fr.fused_render_reference(p, x.double(), y.double(), niter)
        return torch.autograd.grad((out * c.double()).sum(), p)[0]

    rel, err = check_rel(f"K3 vs f64 autograd of the twin ({where})", g_k,
                         chunked(grad64, bs, 25, params, ct), GRAD_REL, dim=0)
    ox32, oy32 = omega32 if omega32 is not None else (ox, oy)
    if omega32 is not None:
        g32 = fr.fused_render_bwd_reference(params, x, y, ox32, oy32, ct, niter)
        rel32, _ = check_rel(f"K3 vs f32 hand-VJP twin ({where})", g_k, g32, GRAD_REL, dim=0)
        print(f"K3 ({where}): vs f32 two-stage twin {rel32:.3e}", flush=True)
        del g32
    # the fixed-order reduction and epilogue: bitwise repeatable
    if not torch.equal(g_k, fr.fused_render_bwd(params, x, y, ox, oy, ct, niter)):
        raise AssertionError(f"K3 is not deterministic from run to run ({where})")
    ms = cuda_ms(lambda: fr.fused_render_bwd(params, x, y, ox, oy, ct, niter))
    pms = cuda_ms(lambda: fr.fused_render_bwd_reference(params, x, y, ox32, oy32, ct, niter),
                  reps=3, warmup=1)
    ops = count_ops(lambda: fr.fused_render_bwd_reference(params, x, y, ox32, oy32, ct, niter))
    b_ms, b_by = bound(ops, [params, x, y, ox, oy, ct, g_k])
    print(f"K3 ({where}): col-rel err vs f64 autograd {rel:.3e}, bitwise repeatable  kernel "
          f"{ms:.3f} ms  twin {pms:.3f} ms  bound {b_ms:.3f} ms ({b_by}, "
          f"{ops / (bs * x.shape[0]):.1f} ops per sample-pixel)", flush=True)
    return dict(name=f"fused_render_bwd (K3) at {where}", key="fused_render_bwd", route="cuda",
                source="gigalens_tpu_torch/csrc/fused_render.cu",
                replaces="gigalens_tpu/ops/pallas/fused_render.py:299", max_abs_err=err,
                ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by, library_ms=None)


def direct_checks(conv, xin, ctc, where):
    """K4's direct route both ways: against the float64 plain version (the
    explicit tap sums), bitwise equal over two calls, timed against the
    float32 plain version and against one PyTorch call of the same function
    (F.conv2d / F.conv_transpose2d, cuDNN without TF32; checked against the
    same reference). Returns (rows, {direction: library ms})."""
    import torch
    import torch.nn.functional as F

    from gigalens_tpu_torch.ops.cuda import direct_conv as dcv

    d = conv._direct
    p, bs = d.pool, xin.shape[0]
    w64 = d.w_ref.double()
    rows, lib = [], {}
    for direction, arg in (("fwd", xin), ("transpose", ctc)):
        if direction == "fwd":
            def plain(a, w=d.w_ref):
                return dcv.direct_conv_reference(a, w, p, d.oy, d.ox)

            def library():
                return F.conv2d(arg[:, None], d.w_ref[None, None], stride=p, padding=d.oy)[:, 0]
        else:
            def plain(a, w=d.w_ref):
                return dcv.direct_conv_transpose_reference(a, w, p, d.oy, d.ox, d.h, d.w)

            def library():
                return F.conv_transpose2d(arg[:, None], d.w_ref[None, None], stride=p,
                                          padding=d.oy)[:, 0]
        got = dcv.direct_conv_cuda(arg, d, direction)
        torch.cuda.synchronize()
        ref = chunked(lambda a: plain(a.double(), w64), bs, 100, arg)
        r, e = check_rel(f"K4 direct {direction} vs f64 plain ({where})", got, ref, CONV_REL)
        if not torch.equal(got, dcv.direct_conv_cuda(arg, d, direction)):
            raise AssertionError(f"K4 direct {direction} is not deterministic ({where})")
        with no_tf32():
            r_lib, _ = check_rel(f"library call {direction} vs f64 plain ({where})", library(),
                                 ref, CONV_REL)
            lib[direction] = cuda_ms(library)
        del ref
        ms = cuda_ms(lambda: dcv.direct_conv_cuda(arg, d, direction))
        pms = cuda_ms(lambda: plain(arg), reps=2, warmup=1)
        b_ms, b_by = k4_bound(conv, arg, got)
        rows.append(dict(name=f"direct_conv {direction} (K4 direct) at {where}",
                         key=f"direct_conv_{direction}", route="cuda",
                         source="gigalens_tpu_torch/csrc/direct_conv.cu",
                         replaces="gigalens_tpu/ops/pallas/dft_conv.py:95", max_abs_err=e,
                         ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib[direction]))
        print(f"K4 direct {direction} ({where}): rel err vs f64 {r:.3e} (library call "
              f"{r_lib:.3e}), bitwise repeatable  kernel {ms:.3f} ms  plain {pms:.3f} ms  "
              f"library {lib[direction]:.3f} ms  bound {b_ms:.3f} ms ({b_by})", flush=True)
    return rows, lib


def chain_checks(conv, xin, ctc, lib):
    """K4's DFT chain (csrc/dft_conv.cu), the route for PSFs too large for
    the direct kernel, on the same inputs: against the float64 einsum twin
    and the float64 FFT conv, timed beside the direct route's numbers."""
    import torch

    from gigalens_tpu_torch.ops.cuda import dft_conv as dc
    from gigalens_tpu_torch.ops.psf import PSFConv, average_pool, dft_factors

    dev, bs = xin.device, xin.shape[0]
    chain = dc.DFTConv(*dft_factors(conv.kernel, (conv.h, conv.w), conv.pool), device=dev)
    fft64 = PSFConv(conv.kernel, (conv.h, conv.w), mode="fft", device=dev)
    rows = []
    # one pallas_call serves both directions (the VJP runs it on the
    # transposed factor set), so both rows replace the same site
    for direction, mats, arg in (("fwd", chain.fwd_mats, xin),
                                 ("transpose", chain.bwd_mats, ctc)):
        got = dc.dft_conv_cuda(arg, mats, direction)
        torch.cuda.synchronize()
        m64 = [m.double() for m in mats]
        ref64 = chunked(lambda a: dc.dft_conv_reference(a.double(), m64), bs, 100, arg)
        r_a, e4 = check_rel(f"K4 chain {direction} vs f64 einsum twin", got, ref64, CONV_REL)
        del ref64
        if direction == "fwd":
            fref = chunked(lambda a: average_pool(fft64(a.double()), SUPERSAMPLE), bs, 100, arg)
        else:
            def vjp(a):
                z = torch.zeros((a.shape[0], conv.h, conv.w), dtype=torch.float64,
                                device=dev, requires_grad=True)
                out = average_pool(fft64(z), SUPERSAMPLE)
                return torch.autograd.grad(out, z, a.double())[0]
            fref = chunked(vjp, bs, 100, arg)
        r_b, _ = check_rel(f"K4 chain {direction} vs f64 fft conv", got, fref, CONV_REL)
        del fref
        ms = cuda_ms(lambda: dc.dft_conv_cuda(arg, mats, direction))
        pms = cuda_ms(lambda: dc.dft_conv_reference(arg, mats))
        b_ms, b_by = k4_bound(conv, arg, got)  # the same as the direct route's
        rows.append(dict(name=f"dft_conv {direction} (K4 chain) at bench bs={bs}",
                         key=f"dft_conv_{direction}", route="cuda",
                         source="gigalens_tpu_torch/csrc/dft_conv.cu",
                         replaces="gigalens_tpu/ops/pallas/dft_conv.py:95", max_abs_err=e4,
                         ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib[direction]))
        print(f"K4 chain {direction}: rel err vs f64 twin {r_a:.3e}, vs f64 fft {r_b:.3e}  "
              f"kernel {ms:.3f} ms  twin {pms:.3f} ms  bound {b_ms:.3f} ms ({b_by})",
              flush=True)
    return rows


def ragged_checks(params, x, y, niter, gen):
    """Shapes off the kernels' tile grids: 3 samples x 1000 pixels (a band
    through the image center; not a multiple of the 256-pixel tile) for
    K1-K3; the direct K4 on 3x40x40 with a 13-px PSF, on 2x170x170 with the
    bench PSF's width (85x85 outputs: neither edge a multiple of the 80x80
    block), and at pools 3 and 1 (its other instantiations); the chain on a
    40x40 conv with a 9x9 PSF (no GEMM dimension a multiple of 64)."""
    import numpy as np
    import torch

    from gigalens_tpu_torch.ops.cuda import dft_conv as dc
    from gigalens_tpu_torch.ops.cuda import direct_conv as dcv
    from gigalens_tpu_torch.ops.cuda import fused_render as fr
    from gigalens_tpu_torch.ops.psf import dft_factors

    mid = x.shape[0] // 2
    p, xr, yr = params[:3].contiguous(), x[mid - 500:mid + 500], y[mid - 500:mid + 500]
    p64, x64, y64 = p.double(), xr.double(), yr.double()
    out64, ox64, oy64 = fr.fused_render_fwd_reference(p64, x64, y64, niter)
    check_close("K1 ragged", fr.fused_render_fwd(p, xr, yr, niter), out64, FWD_RTOL, FWD_ATOL)
    out, ox, oy = fr.fused_render_fwd(p, xr, yr, niter, save_omega=True)
    check_close("K2 ragged", out, out64, FWD_RTOL, FWD_ATOL)
    check_close("K2 ragged ox", ox, ox64, 0.0, OMEGA_ATOL)
    check_close("K2 ragged oy", oy, oy64, 0.0, OMEGA_ATOL)
    ct = torch.randn(out.shape, generator=gen, device=out.device)
    pg = p64.clone().requires_grad_(True)
    want = torch.autograd.grad(
        (fr.fused_render_reference(pg, x64, y64, niter) * ct.double()).sum(), pg)[0]
    check_rel("K3 ragged", fr.fused_render_bwd(p, xr, yr, ox, oy, ct, niter), want,
              GRAD_REL, dim=0)

    rng = np.random.default_rng(0)
    dev = out.device
    worst = []
    for n, h, kpx, pool in ((3, 40, 13, 2), (2, 170, 51, 2), (3, 42, 9, 3), (2, 50, 9, 1)):
        kern = rng.random((kpx, kpx))
        d = dcv.DirectConv(kern / kern.sum(), (h, h), pool, dev)
        a = torch.randn((n, h, h), generator=gen, device=dev)
        c = torch.randn((n, h // pool, h // pool), generator=gen, device=dev)
        w64 = d.w_ref.double()
        rf, _ = check_rel(f"K4 direct fwd ragged {n}x{h}x{h} psf {kpx} pool {pool}",
                          dcv.direct_conv_cuda(a, d, "fwd"),
                          dcv.direct_conv_reference(a.double(), w64, pool, d.oy, d.ox), CONV_REL)
        rt, _ = check_rel(f"K4 direct transpose ragged {n}x{h}x{h} psf {kpx} pool {pool}",
                          dcv.direct_conv_cuda(c, d, "transpose"),
                          dcv.direct_conv_transpose_reference(c.double(), w64, pool, d.oy, d.ox,
                                                              h, h), CONV_REL)
        worst.append(f"{n}x{h}x{h}/{kpx}px/pool {pool}: {rf:.1e} / {rt:.1e}")

    kern = rng.random((9, 9)).astype(np.float32)
    factors = dft_factors(kern / kern.sum(), (40, 40), 2)
    chain = dc.DFTConv(*factors, device=dev)
    for direction, mats, shape in (("fwd", chain.fwd_mats, (3, 40, 40)),
                                   ("transpose", chain.bwd_mats, (3, 20, 20))):
        a = torch.randn(shape, generator=gen, device=dev)
        ref = dc.dft_conv_reference(a.double(), [m.double() for m in mats])
        check_rel(f"K4 chain {direction} ragged", dc.dft_conv_cuda(a, mats, direction), ref,
                  CONV_REL)
    print("ragged shapes: K1-K3 on 3 samples x 1000 px match their float64 twins; K4 direct "
          "(rel err fwd / transpose) " + "; ".join(worst) + f"; K4 chain on 40x40, fshape "
          f"{tuple(factors[4].shape)}", flush=True)


def twin(spec, p, x, y, summed, extras=()):
    from gigalens_tpu_torch.ops.cuda import fused_builder as fb

    return fb.fused_builder_reference(spec, p, x, y, extras, summed)


def autograd64(spec, p, x, y, ct, summed, extras=()):
    """float64 torch autograd of the forward twin: <ct, render> -> d params."""
    import torch

    p = p.double().requires_grad_(True)
    ex = tuple(e.double() for e in extras)
    out = twin(spec, p, x.double(), y.double(), summed, ex)
    return torch.autograd.grad((out * ct.double()).sum(), p)[0]


def by_samples(fn, bs, step, summed, p, ct=None):
    """fn over sample chunks of p (and of ct: dim 0 summed, dim 1 stacked)."""
    import torch

    outs = []
    for i in range(0, bs, step):
        args = [p[i:i + step]]
        if ct is not None:
            args.append(ct[i:i + step] if summed else ct[:, i:i + step])
        outs.append(fn(*args))
    return torch.cat(outs, dim=0 if summed or ct is not None else 1)


def builder_checks():
    """K5 and K7 at family S's full width, K6 and K7-components at family
    L's; then every stage once (coverage) and ragged shapes."""
    import torch

    from gigalens_tpu_torch.ops.cuda import fused_builder as fb
    from gigalens_tpu_torch.simulator import LensSimulator

    dev = torch.device("cuda")
    _, cfg, _ = bench_scene()
    gen = torch.Generator(device=dev).manual_seed(2)
    kernels = []
    for kind in ("S", "L"):
        sim = LensSimulator(family_model(kind), cfg, bs=BS, device=dev)
        spec = sim._fused_spec
        if spec is None or sim._fused_niter is not None or not sim._use_fused:
            raise AssertionError(f"family {kind} must take the builder tier")
        summed = kind == "S"
        params = spec.pack(family_prior(kind).sample(gen, BS)).contiguous()
        x, y = sim.img_x, sim.img_y
        npix = x.shape[0]
        print(f"family {kind}: {spec.label}, bs={BS} npix={npix} n_cols={spec.n_cols} "
              f"depth={spec.depth}", flush=True)
        # forward: K5 (summed) or K6 (components)
        out_k = fb.fused_builder_fwd(spec, params, x, y, (), summed)
        torch.cuda.synchronize()
        out64 = by_samples(lambda p: twin(spec, p.double(), x.double(), y.double(), summed),
                           BS, 50, summed, params)
        out32 = by_samples(lambda p: fb.tile_forward_twostage(spec, p, x, y, (), summed), BS, 100,
                           summed, params)
        check_close(f"K{5 if summed else 6} vs f32 twin", out_k, out32, BUILDER_FWD_RTOL,
                    BUILDER_FWD_ATOL)
        e_f = check_close(f"K{5 if summed else 6} vs f64 twin", out_k, out64,
                          BUILDER_FWD_RTOL, BUILDER_FWD_ATOL)
        del out64, out32
        ms = cuda_ms(lambda: fb.fused_builder_fwd(spec, params, x, y, (), summed))
        pms = cuda_ms(lambda: fb.tile_forward_twostage(spec, params, x, y, (), summed), reps=3,
                      warmup=1)
        # the bound's operations: the one-stage form's
        b_ms, b_by = bound(count_ops(lambda: twin(spec, params, x, y, summed)),
                           [params, x, y, out_k])
        name = "fused_builder_fwd summed (K5)" if summed else "fused_builder_fwd components (K6)"
        kernels.append(dict(name=name, phase=kind,
                            key="fused_builder_fwd_sum" if summed else "fused_builder_fwd_components",
                            route="cuda", source="gigalens_tpu_torch/csrc/fused_builder.cu",
                            replaces="gigalens_tpu/ops/pallas/fused_builder.py:612",
                            max_abs_err=e_f, ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                            library_ms=None))
        print(f"{name}: max|err| vs f64 {e_f:.3e}  kernel {ms:.3f} ms  twin {pms:.3f} ms  "
              f"bound {b_ms:.3f} ms ({b_by})", flush=True)

        # backward: K7 against f64 autograd and the f32 hand-VJP twin
        ct = torch.randn(out_k.shape, generator=gen, device=dev)
        g_k = fb.fused_builder_bwd(spec, params, x, y, (), ct, summed)
        torch.cuda.synchronize()
        g64 = by_samples(lambda p, c: autograd64(spec, p, x, y, c, summed), BS, 25, summed,
                         params, ct)
        rel, e_b = check_rel(f"K7 ({kind}) vs f64 autograd of the twin", g_k, g64,
                             BUILDER_GRAD_REL, dim=0)
        g32 = by_samples(lambda p, c: fb.tile_backward_reference(spec, p, x, y, (), c, summed),
                         BS, 50, summed, params, ct)
        rel32, _ = check_rel(f"K7 ({kind}) vs f32 hand-VJP twin", g_k, g32, BUILDER_GRAD_REL,
                             dim=0)
        if not torch.equal(g_k, fb.fused_builder_bwd(spec, params, x, y, (), ct, summed)):
            raise AssertionError(f"K7 ({kind}) is not deterministic from run to run")
        ms = cuda_ms(lambda: fb.fused_builder_bwd(spec, params, x, y, (), ct, summed))
        pms = cuda_ms(lambda: fb.tile_backward_reference(spec, params, x, y, (), ct, summed),
                      reps=3, warmup=1)
        ops = count_ops(lambda: fb.tile_backward_onestage(spec, params, x, y, (), ct, summed))
        b_ms, b_by = bound(ops, [params, x, y, ct, g_k])
        name = "fused_builder_bwd" + (" (K7)" if summed else " components (K7)")
        kernels.append(dict(name=name, phase=kind, key="fused_builder_bwd", route="cuda",
                            source="gigalens_tpu_torch/csrc/fused_builder.cu",
                            replaces="gigalens_tpu/ops/pallas/fused_builder.py:654",
                            max_abs_err=e_b, ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                            library_ms=None))
        print(f"{name}: col-rel err vs f64 autograd {rel:.3e} (vs f32 two-stage twin "
              f"{rel32:.3e}), bitwise repeatable  kernel {ms:.3f} ms  twin {pms:.3f} ms  "
              f"bound {b_ms:.3f} ms ({b_by})", flush=True)
        del g64, g32, ct, out_k
        builder_ragged(spec, params, x, y, summed, gen)
    builder_coverage(dev, gen)
    return kernels


def builder_ragged(spec, params, x, y, summed, gen):
    """3 samples x 1000 pixels through the image center (off the 256-pixel
    tile grid): the kernels against the float64 twin and its autograd."""
    import torch

    from gigalens_tpu_torch.ops.cuda import fused_builder as fb

    mid = x.shape[0] // 2
    p, xr, yr = params[:3].contiguous(), x[mid - 500:mid + 500], y[mid - 500:mid + 500]
    out = fb.fused_builder_fwd(spec, p, xr, yr, (), summed)
    check_close("builder ragged forward", out,
                twin(spec, p.double(), xr.double(), yr.double(), summed),
                BUILDER_FWD_RTOL, BUILDER_FWD_ATOL)
    ct = torch.randn(out.shape, generator=gen, device=out.device)
    check_rel("builder ragged backward", fb.fused_builder_bwd(spec, p, xr, yr, (), ct, summed),
              autograd64(spec, p, xr, yr, ct, summed), BUILDER_GRAD_REL, dim=0)
    print(f"ragged shapes (3 samples x 1000 px, {'K5' if summed else 'K6'} and K7): "
          "match the float64 twin", flush=True)


def coverage_params(phys, bs, rng):
    """Uniform draws per parameter name (tests/test_fused_builder.py ranges)."""
    ranges = dict(theta_E=(0.5, 1.5), R_sersic=(0.5, 1.5), beta=(0.15, 0.35),
                  e1=(-0.2, 0.2), e2=(-0.2, 0.2), gamma1=(-0.2, 0.2), gamma2=(-0.2, 0.2),
                  n_sersic=(1.0, 4.0), Rs=(5.0, 15.0), alpha_Rs=(1.0, 4.0), Rb=(0.05, 0.2),
                  alpha=(1.5, 3.0), Ie=(50.0, 200.0))
    out = {"lens_mass": [], "lens_light": [], "source_light": []}
    for g, profs, consts in (("lens_mass", phys.lenses, phys.lenses_constants),
                             ("lens_light", phys.lens_light, phys.lens_light_constants),
                             ("source_light", phys.source_light, phys.source_light_constants)):
        for prof, cc in zip(profs, consts):
            d = {}
            for name in prof.params:
                if name in cc:
                    continue
                lo, hi = ranges.get(name, (-1.0, 1.0) if name.startswith("amp") else (-0.3, 0.3))
                if name == "gamma" and g == "lens_mass":
                    lo, hi = 1.8, 2.2
                d[name] = rng.uniform(lo, hi, bs)
            out[g].append(d)
    return out


def builder_coverage(dev, gen):
    """Every stage held against its float64 twin once, at a smaller batch."""
    import numpy as np
    import torch

    from gigalens_tpu_torch import PhysicalModel
    from gigalens_tpu_torch.interop import tree_to_torch
    from gigalens_tpu_torch.ops.cuda import fused_builder as fb
    from gigalens_tpu_torch.profiles.light import CoreSersic, Sersic, SersicEllipse, Shapelets
    from gigalens_tpu_torch.profiles.mass import EPL, NFW, NFW_ELLIPSE, SIE, SIS, Shear

    models = {
        "legacy_pattern": PhysicalModel([EPL(18), Shear()], [SersicEllipse()],
                                        [SersicEllipse()]),
        "sie_sersic_shapelets": PhysicalModel([SIE(), Shear()], [Sersic()], [Shapelets(4)]),
        "shapelet_source_only": PhysicalModel([EPL(18), Shear()], [], [Shapelets(5)]),
        "sis_coresersic": PhysicalModel([SIS()], [CoreSersic()], [SersicEllipse()]),
        "baked_constant_gamma": PhysicalModel([EPL(18), Shear()], [SersicEllipse()],
                                              [SersicEllipse()],
                                              lenses_constants=[dict(gamma=2.0), {}]),
        "nfw_ellipse_halo": PhysicalModel([NFW_ELLIPSE(), NFW(), Shear()], [],
                                          [SersicEllipse()]),
    }
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.uniform(-2.6, 2.6, 25_600), dtype=torch.float32, device=dev)
    y = torch.tensor(rng.uniform(-2.6, 2.6, 25_600), dtype=torch.float32, device=dev)
    cases = []
    for name, phys in models.items():
        spec = fb.build_spec(phys)
        params = tree_to_torch(coverage_params(phys, COVER_BS, rng), device=dev)
        cases.append((name, spec, spec.pack(params).contiguous(), ()))
    # Taylor-series stage (its profile, MassSeries, is not ported yet): a
    # spec from stage records and seeded coefficient grids, order 3
    spec = fb.FusedSpec(
        [fb.Stage(fb.SERIES, 0, order=3, extra=0), fb.Stage(fb.SHEAR, 2),
         fb.Stage(fb.SERSIC_E, 4, is_source=True)],
        [("lens_mass", 0, "dv"), ("lens_mass", 0, "amp"), ("lens_mass", 1, "gamma1"),
         ("lens_mass", 1, "gamma2")] + [("source_light", 0, n) for n in SersicEllipse().params])
    cols = [rng.uniform(-0.2, 0.2, COVER_BS), rng.uniform(0.5, 1.5, COVER_BS)] + [
        rng.uniform(lo, hi, COVER_BS) for lo, hi in ((-0.05, 0.05), (-0.05, 0.05), (0.3, 0.6),
                                                     (1.0, 3.0), (-0.2, 0.2), (-0.2, 0.2),
                                                     (-0.2, 0.2), (-0.2, 0.2), (50, 100))]
    grid = torch.tensor(rng.normal(0, 0.3, (8, x.shape[0])), dtype=torch.float32, device=dev)
    cases.append(("series_stage", spec,
                  torch.tensor(np.stack(cols, -1), dtype=torch.float32, device=dev), (grid,)))
    worst = []
    for name, spec, p, ex in cases:
        tol_v, tol_g = COVER_TOL.get(name, COVER_DEFAULT)
        got = fb.fused_builder_fwd(spec, p, x, y, ex, True)
        want = twin(spec, p.double(), x.double(), y.double(), True,
                    tuple(e.double() for e in ex))
        rv, _ = check_rel(f"K5 coverage {name}", got, want, tol_v)
        ct = torch.randn(got.shape, generator=gen, device=dev)
        rg, _ = check_rel(f"K7 coverage {name}", fb.fused_builder_bwd(spec, p, x, y, ex, ct),
                          autograd64(spec, p, x, y, ct, True, ex), tol_g, dim=0)
        worst.append(f"{name} {rv:.1e}/{rg:.1e}")
    print("coverage (every stage, bs=16, 25,600 px; value / gradient rel err vs f64): "
          + ", ".join(worst), flush=True)


def map_phase(label, phys, prob, prior, cfg, steps, check_sim, need):
    """Multi-start MAP (``steps`` Adam steps from BS prior draws) through
    ModellingSequence; launch counters zeroed just before, read just after.
    Returns the counts; raises unless min reduced chi2 is finite and falls
    and every kernel in ``need`` launched."""
    import torch

    from gigalens_tpu_torch.inference import ModellingSequence
    from gigalens_tpu_torch.inference.sequence import map_optimizer
    from gigalens_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    dev = torch.device("cuda")
    seq = ModellingSequence(phys, prob, cfg, device=dev)
    opt = map_optimizer(steps)
    start = prior.unconstrain(prior.sample(torch.Generator(device=dev).manual_seed(0), BS))
    sim = seq._sim(BS)
    check_sim(sim)

    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        chi0 = float(prob.log_prob(sim, start)[1].min())
    t0 = time.perf_counter()
    z = seq.MAP(opt, start=start, n_samples=BS, num_steps=steps, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with torch.no_grad():
        lp, chi = prob.log_prob(sim, z)
    best = seq.best_map_start(z)
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    chi_n = float(torch.where(torch.isnan(chi), torch.inf, chi).min())
    print(f"MAP {label}: {steps} steps at bs={BS}: {1e3 * wall / steps:.3f} ms/step "
          f"(host clock over the whole phase), peak device memory "
          f"{peak / 2**30:.3f} GiB", flush=True)
    print(f"MAP {label}: min reduced chi2 step 0 {chi0:.4f} -> step {steps} {chi_n:.4f}",
          flush=True)
    print(f"MAP {label}: launch counts {json.dumps(counts)}", flush=True)
    if z.shape != (BS, prior.d) or not torch.isfinite(z).all():
        raise AssertionError(f"MAP {label} output not finite / wrong shape {tuple(z.shape)}")
    if best.shape != (1, prior.d) or not torch.isfinite(best).all():
        raise AssertionError(f"MAP {label}: best_map_start output not finite / wrong shape")
    if not (math.isfinite(chi_n) and chi_n < chi0):
        raise AssertionError(f"MAP {label}: min reduced chi2 did not decrease: {chi0} -> {chi_n}")
    missing = [k for k in need if counts[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched in the {label} MAP phase: {missing}")
    return counts


def observe(img, gen, bkg=0.2, exp_time=100.0):
    """Gaussian + Poisson noise at bkg 0.2 / exp_time 100, as bench.py."""
    import torch

    from gigalens_tpu_torch import bench

    obs = bench.observe(img, gen, bkg, exp_time)
    if obs.shape != (NUM_PIX, NUM_PIX) or not torch.isfinite(obs).all():
        raise AssertionError(f"bad observation: shape {tuple(obs.shape)}")
    return obs


def problem(kind):
    """(phys, prob, prior, cfg) of a MAP phase: the bench scene ("bench"),
    family S ("S": ForwardProbModel) or family L ("L": BackwardProbModel).
    The truth is a seeded prior draw rendered by the port, observed with
    bench.py's noise (family L's amplitudes: a bench-like lens light and
    Normal(0, 50) shapelets)."""
    import torch

    from gigalens_tpu_torch.model import BackwardProbModel, ForwardProbModel
    from gigalens_tpu_torch.simulator import LensSimulator

    dev = torch.device("cuda")
    phys, cfg, _ = bench_scene()
    prior = bench_prior()
    if kind != "bench":
        phys, prior = family_model(kind), family_prior(kind)
    gen = torch.Generator(device=dev).manual_seed(42)
    truth = prior.sample(gen, 1)
    sim = LensSimulator(phys, cfg, bs=1, device=dev)
    noise = torch.Generator(device=dev).manual_seed(1)
    if kind != "L":
        obs = observe(sim.simulate(truth), noise)
        return phys, ForwardProbModel(prior, obs.cpu().numpy(), background_rms=0.2,
                                      exp_time=100.0, device=dev), prior, cfg
    ones = torch.ones((NUM_PIX, NUM_PIX), device=dev)
    stack = sim.lstsq_simulate(truth, ones, ones, return_stacked=True)[0]  # (H, W, 16)
    amps = torch.cat([torch.full((1,), 500.0, device=dev),
                      50.0 * torch.randn((stack.shape[-1] - 1,), generator=gen, device=dev)])
    obs = observe(stack @ amps, noise)
    return phys, BackwardProbModel(prior, obs.cpu().numpy(), background_rms=0.2,
                                   exp_time=100.0, device=dev), prior, cfg


def direct_route(sim):
    return sim._conv is not None and sim._conv.mode == "dft" and sim._conv.route == "direct"


def main_path(steps):
    """The bench scene's MAP phase (K1-K3 and the direct K4)."""

    def check(sim):
        if not sim._use_fused or sim._fused_niter is None or not direct_route(sim):
            raise AssertionError("the MAP simulator must take K1-K3 and the direct dft conv")

    need = ("fused_render_fwd", "fused_render_fwd_omega", "fused_render_bwd",
            "direct_conv_fwd", "direct_conv_transpose")
    return map_phase("bench", *problem("bench"), steps, check, need)


def builder_check(sim):
    if not sim._use_fused or sim._fused_spec is None or not direct_route(sim):
        raise AssertionError("the family's simulator must take the builder and the direct "
                             "dft conv")


def family_path(kind, steps):
    """Family S's MAP phase (ForwardProbModel through K5/K7 and the direct
    K4) or family L's (BackwardProbModel and lstsq_simulate through K6/K7
    and the direct K4, 16 components x BS images per conv)."""
    fwd = "fused_builder_fwd_sum" if kind == "S" else "fused_builder_fwd_components"
    need = (fwd, "fused_builder_bwd", "direct_conv_fwd", "direct_conv_transpose")
    return map_phase(f"family {kind}", *problem(kind), steps, builder_check, need)


MAP_SVI_NEED = ("fused_render_fwd_omega", "fused_render_bwd", "direct_conv_fwd",
                "direct_conv_transpose")
HMC_NEED = ("fused_render_fwd_omega", "fused_render_bwd")
HMC_BANNED = ("direct_conv_fwd", "direct_conv_transpose", "dft_conv_fwd", "dft_conv_transpose")
# the bench gates: best-MAP and posterior red-chi2 ~ 1, split-R-hat <= 1.02
CHI2_GATE, RHAT_GATE = 1.1, 1.02


def pipeline_phase():
    """gigalens_tpu_torch.bench.run_pipeline at the full configuration with
    one HMC seed (2): MAP 500 x 350, FD Laplace (bs 44), SVI 1000 x 300,
    HMC 50 chains x (250 + 750) ChEES, posterior red-chi2 of the last draw.
    Launch counters and peak memory are zeroed at each phase boundary.
    Raises unless the bench gates hold and each phase ran its kernels: MAP
    and SVI K2/K3 and the direct dft conv both ways (the phase simulators'
    route must be "direct"), HMC K2/K3 and no dft conv by either route (its
    exact path convolves with torch.fft). Returns the pipeline and
    each phase's record (wall, launch counts, peak memory)."""
    import contextlib

    import torch

    from gigalens_tpu_torch import bench
    from gigalens_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    rec = {}

    @contextlib.contextmanager
    def hook(name):
        torch.cuda.synchronize()
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        rec[name] = dict(wall=time.perf_counter() - t0, counts=launch_counts(),
                         peak=torch.cuda.max_memory_allocated() / 2**30)

    cfg = dict(bench.CONFIGS["full"], scale="full")
    t0 = time.perf_counter()
    pipe = bench.run_pipeline(cfg, hmc_seeds=[2], device="cuda", phase_hook=hook)
    total = time.perf_counter() - t0
    r, res = pipe.result, pipe.hmc_res
    routes = {n: pipe.seq._sim(b)._conv.route for n, b in (("map", cfg["map_n"]),
                                                           ("svi", cfg["vi_n"]))}
    print(f"pipeline: K4 routes {json.dumps(routes)}", flush=True)
    if set(routes.values()) != {"direct"}:
        raise AssertionError(f"MAP and SVI must take the direct K4 route, got {routes}")
    row = r["seeds"][0]
    for name in ("map", "laplace", "svi", "hmc", "posterior_chi2"):
        print(f"pipeline {name}: {rec[name]['wall']:.3f} s, peak device memory "
              f"{rec[name]['peak']:.3f} GiB, launches {json.dumps(rec[name]['counts'])}",
              flush=True)
    print(f"pipeline: MAP {r['phase_s']['map']} s, Laplace {r['laplace_s']} s, SVI (with "
          f"Laplace) {r['phase_s']['svi']} s, HMC {r['phase_s']['hmc']} s; total "
          f"{r['value']} s ({total:.1f} s with set-up and scoring)", flush=True)
    print(f"pipeline: best-MAP red-chi2 {r['best_map_red_chi2']}, SVI ELBO loss "
          f"{pipe.elbo[0]:.2f} -> {pipe.elbo[1]:.2f}", flush=True)
    print(f"pipeline: HMC accept {row['accept']}, eps {row['eps']}, total leapfrogs "
          f"{row['leapfrogs']}, {1e3 * row['t'] / max(row['leapfrogs'], 1):.3f} ms/leapfrog "
          f"at {cfg['hmc_n']} chains, divergences {int(res.divergences.sum())}", flush=True)
    print(f"pipeline: min ESS {r['min_ess']}, max split-R-hat {r['max_rhat']}, posterior "
          f"mean red-chi2 {r['posterior_red_chi2']}", flush=True)
    print(f"pipeline JSON: {json.dumps(r)}", flush=True)

    want = (cfg["results"], cfg["hmc_n"], pipe.prior.d)
    if tuple(res.samples.shape) != want or not torch.isfinite(res.samples).all():
        raise AssertionError(f"HMC samples not finite / wrong shape {tuple(res.samples.shape)}")
    if not r["complete"]:
        raise AssertionError(f"pipeline incomplete: {r.get('failed_phases')}")
    if not r["best_map_red_chi2"] <= CHI2_GATE:
        raise AssertionError(f"best-MAP red-chi2 {r['best_map_red_chi2']} > {CHI2_GATE}")
    if not r["posterior_red_chi2"] <= CHI2_GATE:
        raise AssertionError(f"posterior red-chi2 {r['posterior_red_chi2']} > {CHI2_GATE}")
    if not (r["max_rhat"] <= RHAT_GATE and math.isfinite(r["min_ess"])):
        raise AssertionError(f"max split-R-hat {r['max_rhat']} > {RHAT_GATE} "
                             f"or min ESS {r['min_ess']} not finite")
    for phase, need, banned in (("map", MAP_SVI_NEED, ()), ("svi", MAP_SVI_NEED, ()),
                                ("hmc", HMC_NEED, HMC_BANNED)):
        counts = rec[phase]["counts"]
        missing = [k for k in need if counts[k] <= 0]
        extra = [k for k in banned if counts[k] != 0]
        if missing or extra:
            raise AssertionError(f"pipeline {phase}: kernels never launched {missing}, "
                                 f"launched but off this path {extra}")
    return pipe, rec


def pipeline_kernel_checks(pipe):
    """K2/K3 at the pipeline's SVI shape (n_vi = 1000 draws from the fitted
    surrogate, as the SVI phase draws them) and HMC shape (the 50 chains'
    last states), and the direct K4 both ways at the SVI shape (the K2
    images and a random cotangent), each against its float64 twin with
    kernel_checks' tolerances, and timed against its float32 twin with CUDA
    events."""
    import torch

    from gigalens_tpu_torch.ops.cuda import fused_render as fr

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    kernels = []
    for phase, z in (("svi", pipe.q_z.sample(gen, pipe.cfg["vi_n"])),
                     ("hmc", pipe.hmc_res.samples[-1])):
        sim = pipe.seq._sim(z.shape[0], exact=phase == "hmc")
        params = fr.pack_params(pipe.prior.constrain(z)).contiguous()
        bs, x, y, niter = params.shape[0], sim.img_x, sim.img_y, sim._fused_niter
        where = f"{phase.upper()} bs={bs}"
        out, ox, oy = fr.fused_render_fwd(params, x, y, niter, save_omega=True)
        torch.cuda.synchronize()
        ref = [fr.fused_render_fwd_reference(params[i:i + 50].double(), x.double(),
                                             y.double(), niter) for i in range(0, bs, 50)]
        out64, ox64, oy64 = (torch.cat(t) for t in zip(*ref))
        del ref
        e2 = check_close(f"K2 out vs f64 twin ({where})", out, out64, FWD_RTOL, FWD_ATOL)
        e_om = max(check_close(f"K2 ox vs f64 twin ({where})", ox, ox64, 0.0, OMEGA_ATOL),
                   check_close(f"K2 oy vs f64 twin ({where})", oy, oy64, 0.0, OMEGA_ATOL))
        del out64, ox64, oy64
        k2_repeatable(params, x, y, niter, (out, ox, oy), where)
        ms = cuda_ms(lambda: fr.fused_render_fwd(params, x, y, niter, save_omega=True))
        pms = cuda_ms(lambda: fr.fused_render_fwd_reference(params, x, y, niter), reps=3,
                      warmup=1)
        b_ms, b_by = bound(count_ops(lambda: fr.fused_render_fwd_onestage(params, x, y, niter)),
                           [params, x, y, out, ox, oy])
        kernels.append(dict(name=f"fused_render_fwd<true> (K2) at {where}",
                            key="fused_render_fwd_omega", phase=phase, route="cuda",
                            source="gigalens_tpu_torch/csrc/fused_render.cu",
                            replaces="gigalens_tpu/ops/pallas/fused_render.py:246",
                            max_abs_err=max(e2, e_om), ms=ms, plain_ms=pms, bound_ms=b_ms,
                            bound_by=b_by, library_ms=None))
        print(f"K2 at {where}: max|err| out {e2:.3e} omega {e_om:.3e}  kernel {ms:.3f} ms  "
              f"twin {pms:.3f} ms  bound {b_ms:.3f} ms ({b_by})", flush=True)

        ct = torch.randn(out.shape, generator=gen, device=dev)
        kernels.append(dict(k3_check(params, x, y, ox, oy, ct, niter, where), phase=phase))
        if phase == "hmc":
            continue

        conv = sim._conv
        if conv is None or conv.mode != "dft" or conv.route != "direct":
            raise AssertionError(f"the SVI simulator should take the direct dft conv, got {conv}")
        h, w = conv.h, conv.w
        ctc = torch.randn((bs, h // conv.pool, w // conv.pool), generator=gen, device=dev)
        rows, _ = direct_checks(conv, out.reshape(bs, h, w).contiguous(), ctc, where)
        kernels += [dict(r, phase=phase) for r in rows]
    return kernels


def main(argv=()):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (ROOT / "gigalens_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no gigalens_tpu_torch package beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))

    card = card_line()
    print(f"card: {card}", flush=True)
    from gigalens_tpu_torch.ops.cuda import _build

    path, secs, log = _build.build(verbose=True)
    print(f"build: {path.relative_to(ROOT)} in {secs:.1f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    _build.load()

    kernels = [dict(k, phase="bench") for k in kernel_checks()]
    kernels += builder_checks()
    if "--kernels" in argv:
        # a development aid: no main path ran, so no launch counts and no ok line
        print(card)
        print(json.dumps({"partial": True,
                          "kernels": [{k: v for k, v in kern.items() if k not in ("key", "phase")}
                                      for kern in kernels]}))
        return 0
    counts = {"bench": main_path(MAP_STEPS), "S": family_path("S", MAP_STEPS),
              "L": family_path("L", MAP_STEPS)}
    pipe, rec = pipeline_phase()
    kernels += pipeline_kernel_checks(pipe)
    counts.update(svi=rec["svi"]["counts"], hmc=rec["hmc"]["counts"])
    # launches: each kernel's count in the phase of its row (K1-K4 the bench
    # scene's MAP, K5 and K7 family S's, K6 and K7-components family L's;
    # the rows at the SVI and HMC shapes the pipeline's SVI and HMC phases;
    # the chain K4, off the main path at the bench shape, 0)
    out = [
        {k: v for k, v in dict(kern, launches=counts[kern["phase"]][kern["key"]]).items()
         if k not in ("key", "phase")}
        for kern in kernels
    ]
    print(card)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
