#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (gigalens_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py             # everything below
    python3 chip_smoke.py --kernels   # steps 1-4 only, a development aid: its
                                      # kernels line says "partial": true, has no
                                      # launch counts, and no ok line follows
    python3 chip_smoke.py --inversion # steps 1, 2 and 12 only, the same kind of aid
    python3 chip_smoke.py --mesh      # steps 1, 2 and 13 only, the same kind of aid
    python3 chip_smoke.py --cluster   # steps 1, 2, 10, 10b and 10c only, the same kind of aid
    python3 chip_smoke.py --demos     # steps 1, 2 and 15 only, the same kind of aid

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the hand-written kernels from gigalens_tpu_torch/csrc/ with nvcc
   into build/kernels/ and prints the build time and ptxas resource usage;
   exits nonzero if ptxas reports spill bytes for any variant of the direct
   K4 or for the lstsq pseudo-inverse (direct_spills).
3. Checks every kernel of the MAP path against its plain PyTorch twin at the
   main-path shapes (bs=500 samples, 25,600 supersampled pixels, niter=23;
   the PSF conv at (500, 160, 160) and its transpose at (500, 80, 80)), on
   inputs drawn from the bench prior, and times kernel and twin with CUDA
   events. K4 is checked by both routes: the direct strided sum that the
   main path takes and the half-spectrum DFT chain (same inputs, same
   run), beside one PyTorch call of the same function (F.conv2d and
   F.conv_transpose2d, cuDNN with TF32 off: timed only, the port never
   calls it); the chain is checked again at the shape where PSFConv routes
   to it (the chain MAP phase's PSF, step 5). K1, K2, K3 and both K4 routes
   must give bitwise-equal results twice; K2's Omega is also held to its
   float32 twin at OMEGA_TWIN_ATOL. Each kernel's bound is the larger of
   its operations over the FP32 peak and its bytes over the memory rate
   (K4's operations are those of the cheaper of its two algorithms at the
   row's shape, the direct sum or the half-spectrum chain, counted from
   shapes and the same for both routes; the renders' by counting the
   elementwise operations of their plain one-stage versions on the same
   inputs: the two-stage twins hoist per-sample work, which would lower the
   count the bound is made of).
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
   Then the lstsq solve's pseudo-inverse (csrc/gram_pinv.cu) on the Grams
   of family L at 500 prior starts, against its twin and torch.linalg.pinv,
   bitwise twice and alone, NaN matrices NaN, timed against
   torch.linalg.pinv; and three fit_map steps of family L under
   torch.profiler, which must make no synchronising CUDA call inside a step
   (torch.linalg.pinv in the kernel's place, the control, makes one).
5. Runs the MAP phase of the bench scene (bench.py: EPL+Shear, SersicEllipse
   lens light and source, 80x80 px at 0.065", supersample 2, the 25x25
   Gaussian fallback PSF) through ModellingSequence: truth from a seeded
   generator rendered by the port, noise at bkg 0.2 / exp_time 100, then
   multi-start Adam (50 steps) from 500 prior draws and best_map_start.
   Then the same for family S (ForwardProbModel, K5/K7 + K4) and family L
   (BackwardProbModel with lstsq_simulate, K6/K7 + K4 over 16 x 500
   images), and for the bench scene under a PSF wide enough that PSFConv
   routes to the DFT chain (the same Gaussian on a larger support; 10
   steps; K1-K3 and the chain K4 both ways, its launches counted exactly,
   and one rendered batch held against the float64 FFT convolution). Each
   phase zeroes the launch counters just before it and reads them just
   after.
6. Runs the bench pipeline (gigalens_tpu_torch.bench.run_pipeline, the
   full configuration with HMC seed 2): MAP 500 x 350, FD Laplace, SVI
   1000 x 300, HMC 50 chains x (250 + 750) ChEES, under the bench gates
   (best-MAP and posterior red-chi2 <= 1.1, max split-R-hat <= 1.02),
   with K2/K3 and the direct K4 both ways required in MAP and SVI and K2/K3
   without any K4 in HMC.
7. Runs adaptive-tempering SMC at full width on the same scene and
   observation (Pipeline.phase_smc, scripts/bench_smc.py's recipe: 1000
   particles, 3-leapfrog preconditioned moves, ESS threshold 0.6, 100 post
   steps, at most 200 stages, seed 1, prior start, pixels target) through
   ModellingSequence.SMC on the exact path, gated on beta = 1 inside the
   stage limit, a finite log-evidence, finite (100, 1000, d) post samples,
   the last post draw's red-chi2 <= CHI2_GATE, and K2/K3 with no K4; then
   one stage of moves from the final cloud plain and under torch.profiler
   (host ms a leapfrog, device idle share).
8. Runs the multiple-image positions workflow (examples/demo_cluster.py
   --smc) at a smaller depth: find_images on the scene's truth (>= 2
   images), a pixels + positions ForwardProbModel, 100 MAP steps from 200
   starts, SMC annealing both terms from the MAP subsample (200 particles,
   10 post steps), gated on beta = 1 and both red-chi2 terms <= CHI2_GATE.
9. Checks K2/K3 at the SVI (1000 surrogate draws), HMC (the 50 chains' last
   states) and SMC (the 1000 final particles) shapes, and the direct K4 at
   the SVI shape, against their float64 twins.
10. Runs the cluster scene of config #5, dpie arm
   (gigalens_tpu_torch.bench.cluster_scene, the counterpart of
   scripts/bench_cluster_posterior.py:86-190: NFW_ELLIPSE halo, 20
   luminosity-scaled DPIESubhaloSeries members of order 3 in chunks of 16,
   Shapelets(4) source with sampled amplitudes, 48 px at 0.2", supersample
   2, a 9x9 Gaussian PSF, bkg 0.1, exp_time 500): the series precompute on
   the card, held against the direct member sum; find_images on the truth
   (>= 2 images); MAP 128 x 400 on pixels + positions (K5/K7 and the direct
   K4 counted exactly); SMC as examples/demo_cluster.py runs it (1000
   particles from the MAP starts, 10 leapfrogs, target pixels+positions,
   10 post steps, cut from 100), gated on beta = 1 inside 200 stages, a
   finite logZ and the pixel red-chi2 in [0.85, 1.15], K5/K7 and no K4,
   with one stage profiled; a 50-step lstsq MAP (K6/K7); K5, K6, K7 and the
   direct K4 at the phase's shapes and grids against their twins; and
   scripts/bench_cluster.py's hot loop (direct sum against the series).
10b. Runs config #5's full posterior (gigalens_tpu_torch.bench.ClusterRun,
   the counterpart of the script's run_pipeline) on both arms at full
   width with depths cut: the dpie arm from step 10's MAP starts through
   the FD Laplace, SVI 256 x 100 and static-L8 HMC 50 x (80 + 80) (K5/K7
   and the direct K4 both ways in SVI, K5/K7 and no K4 in HMC); the sie
   arm (ScalingRelation(NIE) members, unfused; Shapelets(4) solved by
   lstsq in a BackwardProbModel, no positions) through MAP 128 x 150 (the
   direct K4 exactly once a step each way, over 15 x 128 component
   images), SVI 256 x 50 and static-L8 HMC 50 x (50 + 50) (no K1-K3 or
   K5-K7 anywhere, no K4 in HMC); each gated on finite samples, an HMC
   acceptance in (0.3, 1) and the last draw's pixel red-chi2 in [0.85,
   1.15] (divergences, split-R-hat and ESS printed); then K5/K7 at the
   dpie SVI's and HMC's batches (256, 50) and the direct K4 at (256, 96,
   96) and (1,920, 96, 96) against their twins.
10c. Runs the repairs of the port's last results that differed from the JAX
   package on config #5's scenes at the JAX script's own truth
   (gigalens_tpu_torch.bench.CL_JAX_TRUTH): the sie arm's MAP at step
   10b's depth (128 x 150), the FD Laplace and its full SVI (256 x 400,
   F-ref-7: the lstsq solve in float64, where the JAX package's float32
   solve climbs, with JAX's derivative of the pseudo-inverse), gated on every loss finite, the last at or below the
   first and 256 surrogate draws with finite log-densities (the direct K4
   both ways); and the dpie arm's MAP (128 x 400) from the JAX script's own
   starts (bench.CL_JAX_STARTS), gated on best pixel
   red-chi2 <= 1.10 (K5/K7 and the direct K4 exactly once a step each).
11. Runs survey mode on scripts/bench_survey_production.py's catalogue at
   full width (gigalens_tpu_torch.bench.survey_scene: 4 scenes, 60 px at
   0.065", supersample 2, one PSF a scene, the bench prior and model)
   through SurveySequence: MAP 64 starts a scene x 700 steps (K2/K3 and
   the direct K4 once a scene each way, counted exactly; every scene's best
   red-chi2 <= CHI2_GATE), the per-scene Laplace, SVI 256 draws a scene x
   400 steps (counted the same way), grouped HMC (48 chains a scene, one
   adaptation group a scene, static L 16, 250 + 1250, torch.fft: K2/K3 and
   no K4;
   each scene's posterior-mean red-chi2 in [0.85, 1.15], max split-R-hat
   <= RHAT_GATE, finite min-ESS), SMC from the MAP starts (256 particles a
   scene, L 3, 10 post steps; beta = 1 for every scene inside 200 stages,
   finite (4,) logZ, scene-major post rows; one stage profiled), a 50-step
   lstsq MAP with both lights linear (K6/K7 exactly 50, the direct K4 4 x
   50 each way) whose components are held against four single-scene
   simulators, and K2/K3 at the MAP shape and the direct K4 at one scene's
   launch against their twins.
12. Runs pixelated-source inversion (gigalens_tpu_torch.inversion) on
   scripts/bench_inversion.py's scene: 64 px at 0.05", supersample 2, the
   9x9 Gaussian PSF (19x19 supersampled: the direct K4), SIE + Shear, a 24 x
   24 source grid (576 basis images a sample), lam sampled, the data of
   examples/demo_inversion.py's truth rendered by the port. log_prob forward
   and forward + gradient at bs 1, 8 and 32 timed with the port's
   utils.profiling.timed, the direct K4 launches a call counted exactly (a
   chunk of source rows a launch each way; the checkpointed chunks'
   recompute stops before the conv), peak memory and one
   torch.profiler pass at bs 32 split into K4 forward / transpose, the Gram
   (cuBLAS), the Cholesky and solves and the rest; log_marginal at bs 8
   against the same evaluation in float64 on the card (K4's plain version);
   the direct K4 both ways at one chunk's launch (1,536 images at bs 32);
   then the demo's joint MAP: stage 1 parametric (32 x 400, K2/K3 and the
   direct K4), stage 2 pixelated (32 x 200, the direct K4 counted exactly)
   through PipelineCheckpointer.run_map and reloaded from its file (no
   launches, the same best log_prob), gated on best red-chi2 <= CHI2_GATE.
13. Runs sample sharding (gigalens_tpu_torch.parallel) on the bench scene
   through ModellingSequence(mesh=...) at the pipeline's widths with short
   step counts (MAP 500 x 50, SVI 1000 x 20, ChEES HMC 50 x (20 + 20), SMC
   1000 particles x 3 stages): in this process, then one nccl rank and two
   gloo ranks on the card side by side, each held to the in-process run at
   tests/test_sharding.py's tolerances (HMC from the in-process surrogate);
   and below the rows where the card's per-row pixel sums round by the
   rows a call holds: MAP 24 starts, HMC 24 chains and SMC 24 particles in
   this process and on two gloo ranks (12 rows a rank), held alike; and
   (e) the pixelated-source model (step 12's scene) and config #5's sie
   arm (lstsq source) at 1 row a rank on two gloo ranks: log_prob, its
   z-gradient and 3 MAP steps, held to this process's 2-row run at
   tests/test_inversion.py:240-257's tolerances (the largest difference
   printed); every rank's launch counters by the pipeline's rules, the
   phase inside MESH_TIMEOUT.
14. Ends with the card line, a JSON line of per-kernel results and the ok
   line.
15. Runs the JAX package's shipped workflows (gigalens_tpu_torch.demos) at
   the demos' widths, each leg with the launch counters zeroed just before
   it and read just after, each raising unless every gate of its result
   holds: (c) examples/demo_model_comparison.py, SMC from the prior, 256
   particles x 2 ensembles, for EPL and SIE (K2/K3, no K4; beta = 1 on
   every ensemble, finite logZ, log Bayes factor above max(5, the ensemble
   spread)); (a) examples/demo_composite.py, Hernquist + NFW_ELLIPSE + m=4
   multipole + Shear rendered unfused, MAP 256 x 250, FD Laplace, SVI 200 x
   300, ChEES HMC 16 x (150 + 400) (the direct K4 exactly once a MAP and
   an SVI step each way, nothing in HMC; acceptance, the posterior
   red-chi2, best-MAP red-chi2 and the three recoveries, split-R-hat
   printed);
   (d) docs/multiplane.md's model in tests/test_multiplane.py's
   configuration, MAP 128 x 300 (the direct K4 exactly once a step each
   way) and the images' composed-Jacobian magnifications against central
   differences; (b) examples/demo_timedelay.py, positions + delays +
   fluxes with a sampled D_dt through ModellingSequence.fit, HMC at the
   demo's --quick depth 16 x (300 + 300) (no launches;
   4 images, D_dt within 2 posterior std of its truth, its split-R-hat);
   then K2/K3 at the comparison's (512, 1,024 px) for each arm and the
   direct K4 both ways at the composite MAP's and SVI's and the multi-plane
   MAP's shapes against their twins; the multi-plane forward fails the run
   if it is slower than F.conv2d timed beside it. Its rows join step 14's
   line. Every direct K4 row, here and in the steps above, carries the
   launch plan it ran (plan_summary: thread and block tile, samples a
   block, blocks, shared bytes, load path) and its share of bound_ms.

Steps 11 and 15 run in processes of their own (spawned) beside steps 6-8
and steps 10, 10b's sampling and 10c, which are host-bound like them. Every
measurement made for the record (the stage profiles of steps 7, 10 and 11,
step 9, steps 10's, 10b's, 11's and 15's kernels rows, the hot loop) waits
until the card is one process's: step 11's until the main process has
sampled step 10b and step 15's process has ended, the main process's until
both have ended. The walls of the sampling phases of steps 6-8, 10, 10b,
10c, 11 and 15 are taken beside the other processes.

Every phase raises on failure (nothing is caught; the processes of steps 11
and 15 are stopped when the main process fails, and their failures raise in
the main process), so any failure exits nonzero before the ok line. Without
a CUDA device it exits nonzero at once.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
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
CHAIN_STEPS = 10  # MAP steps of the chain phase
RENDER_REL = 1e-5  # a rendered batch against the float64 FFT conv, of its max
# the lstsq pseudo-inverse against its twin and torch.linalg.pinv, of each
# matrix's largest entry (tests/test_torch_cluster_faults.py's float64 bound)
GRAM_PINV_REL = 1e-9
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


def k4_bound(conv, arg, out, transpose):
    """K4's bound (either route, either direction): its function's work,
    counted from shapes: 2 FP32 operations per multiply-add of the cheaper
    of its two algorithms at this shape, the direct sum (out pixels x
    pooled-kernel taps a sample; the direct kernel's padded taps do not
    count) or the half-spectrum chain; bytes of the input, the pooled
    kernel and the output."""
    import torch

    from gigalens_tpu_torch.ops.cuda.dft_conv import chain_macs
    from gigalens_tpu_torch.ops.cuda.direct_conv import direct_macs

    kh, kw = conv.kh + conv.pool - 1, conv.kw + conv.pool - 1
    direct = direct_macs(conv.h, conv.w, conv.kh, conv.kw, conv.pool)
    chain = chain_macs(conv.h, conv.w, conv.kh, conv.kw, conv.pool, transpose)
    ops = 2 * arg.shape[0] * min(direct, chain)
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


def direct_spills(log, kernels=("direct_conv", "gram_pinv")):
    """{function: (spill store bytes, spill load bytes)} of every variant of
    the direct K4 (csrc/direct_conv.cu) and of the lstsq pseudo-inverse
    (csrc/gram_pinv.cu) that ptxas -v reports spilling."""
    import re

    spilled, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if (m and fn and any(k in fn for k in kernels)
                and (int(m.group(1)) or int(m.group(2)))):
            spilled[fn] = (int(m.group(1)), int(m.group(2)))
    return spilled


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


def check_launches(label, counts, need=(), banned=(), exact=None):
    """Raises unless every kernel in ``need`` launched, none in ``banned``
    did, and each of ``exact`` launched exactly its count."""
    missing = [k for k in need if counts[k] <= 0]
    extra = [k for k in banned if counts[k] != 0]
    wrong = {k: (counts[k], n) for k, n in (exact or {}).items() if counts[k] != n}
    if missing or extra or wrong:
        raise AssertionError(f"{label}: kernels never launched {missing}, launched but off "
                             f"this path {extra}, counts (got, expected) {wrong}")


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
    kernels += rows + chain_checks(conv, xin, ctc, lib, f"bench bs={BS}", "bench")
    # the chain where PSFConv routes to it: the chain MAP phase's PSF
    from gigalens_tpu_torch.ops.psf import PSFConv, subgrid_kernel

    ss, native = chain_psf()
    wide = PSFConv(subgrid_kernel(native, SUPERSAMPLE, odd=True), (conv.h, conv.w), mode="dft",
                   pool=SUPERSAMPLE, device=dev)
    if wide.route != "chain" or wide.kh != ss:
        raise AssertionError(f"a {wide.kh}-px PSF should take the chain, got {wide.route}")
    kernels += chain_checks(wide, xin, ctc, None, f"{ss}-px PSF bs={BS}", "chain")
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


def plan_summary(pl):
    """The launch plan a direct K4 row ran: thread tile, block tile,
    samples a block, blocks, shared bytes, load path and buffers."""
    return dict(thread_tile=f"{pl['rows']}x{pl['cols']}",
                block_tile=f"{pl['rows'] * pl['rb']}x{pl['cols'] * pl['lx']}",
                samples_a_block=pl["spb"], blocks=pl["blocks"], smem=pl["smem"],
                warps=pl["warps"], loads="tma" if pl["tma"] else "cp.async",
                stages=pl["stages"], live=round(pl["live"], 3))


def direct_checks(conv, xin, ctc, where, beat_library=False):
    """K4's direct route both ways: against the float64 plain version (the
    explicit tap sums), bitwise equal over two calls, timed against the
    float32 plain version and against one PyTorch call of the same function
    (F.conv2d / F.conv_transpose2d, cuDNN without TF32; checked against the
    same reference), each row with the launch plan it ran and its share of
    the bound. ``beat_library``: raise if the forward is slower than the
    library call timed beside it. Returns (rows, {direction: library ms})."""
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
        b_ms, b_by = k4_bound(conv, arg, got, direction == "transpose")
        pl = plan_summary(d.plan(bs, direction))
        rows.append(dict(name=f"direct_conv {direction} (K4 direct) at {where}",
                         key=f"direct_conv_{direction}", route="cuda",
                         source="gigalens_tpu_torch/csrc/direct_conv.cu",
                         replaces="gigalens_tpu/ops/pallas/dft_conv.py:95", max_abs_err=e,
                         ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib[direction], bound_share=b_ms / ms, plan=pl))
        print(f"K4 direct {direction} ({where}): rel err vs f64 {r:.3e} (library call "
              f"{r_lib:.3e}), bitwise repeatable  kernel {ms:.4f} ms  plain {pms:.3f} ms  "
              f"library {lib[direction]:.4f} ms  bound {b_ms:.4f} ms ({b_by}, "
              f"{100 * b_ms / ms:.1f}% of it)  plan {json.dumps(pl)}", flush=True)
        if beat_library and direction == "fwd" and ms > lib[direction]:
            raise AssertionError(f"K4 direct fwd ({where}) {ms:.4f} ms is slower than the "
                                 f"library call's {lib[direction]:.4f} ms")
    return rows, lib


def library_conv_ms(conv, arg, direction):
    """Milliseconds of one PyTorch call of K4's function (F.conv2d /
    F.conv_transpose2d with the pooled kernel, cuDNN without TF32). Timed
    only: direct_checks holds the same call to the float64 reference at the
    bench shape."""
    import torch
    import torch.nn.functional as F

    from gigalens_tpu_torch.ops.cuda import direct_conv as dcv

    w = torch.as_tensor(dcv.pooled_kernel(conv.kernel, conv.pool), dtype=torch.float32,
                        device=arg.device)[None, None]
    oy, _ = dcv.offsets(conv.kh, conv.kw)
    fn = F.conv2d if direction == "fwd" else F.conv_transpose2d
    with no_tf32():
        return cuda_ms(lambda: fn(arg[:, None], w, stride=conv.pool, padding=oy), reps=3,
                       warmup=1)


def chain_checks(conv, xin, ctc, lib, where, phase):
    """K4's DFT chain (csrc/dft_conv.cu) over half of the spectrum for
    ``conv``'s kernel and shape, whichever route ``conv`` itself takes:
    against the float64 einsum twin on the same half-spectrum factors and
    the float64 FFT conv, bitwise equal over two calls, timed beside the
    library call (``lib``: {direction: ms}, timed here where None)."""
    import torch

    from gigalens_tpu_torch.ops.cuda import dft_conv as dc
    from gigalens_tpu_torch.ops.psf import PSFConv, average_pool, dft_factors

    dev, bs = xin.device, xin.shape[0]
    chain = dc.DFTConv(*dft_factors(conv.kernel, (conv.h, conv.w), conv.pool, half=True),
                       device=dev)
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
        r_a, e4 = check_rel(f"K4 chain {direction} vs f64 einsum twin ({where})", got, ref64,
                            CONV_REL)
        del ref64
        if direction == "fwd":
            fref = chunked(lambda a: average_pool(fft64(a.double()), conv.pool), bs, 100, arg)
        else:
            def vjp(a):
                z = torch.zeros((a.shape[0], conv.h, conv.w), dtype=torch.float64,
                                device=dev, requires_grad=True)
                out = average_pool(fft64(z), conv.pool)
                return torch.autograd.grad(out, z, a.double())[0]
            fref = chunked(vjp, bs, 100, arg)
        r_b, _ = check_rel(f"K4 chain {direction} vs f64 fft conv ({where})", got, fref, CONV_REL)
        del fref
        if not torch.equal(got, dc.dft_conv_cuda(arg, mats, direction)):
            raise AssertionError(f"K4 chain {direction} is not deterministic ({where})")
        ms = cuda_ms(lambda: dc.dft_conv_cuda(arg, mats, direction))
        pms = cuda_ms(lambda: dc.dft_conv_reference(arg, mats))
        lib_ms = lib[direction] if lib else library_conv_ms(conv, arg, direction)
        b_ms, b_by = k4_bound(conv, arg, got, direction == "transpose")
        rows.append(dict(name=f"dft_conv {direction} (K4 chain) at {where}",
                         key=f"dft_conv_{direction}", phase=phase, route="cuda",
                         source="gigalens_tpu_torch/csrc/dft_conv.cu",
                         replaces="gigalens_tpu/ops/pallas/dft_conv.py:95", max_abs_err=e4,
                         ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
        print(f"K4 chain {direction} ({where}): rel err vs f64 twin {r_a:.3e}, vs f64 fft "
              f"{r_b:.3e}, bitwise repeatable  kernel {ms:.3f} ms  twin {pms:.3f} ms  library "
              f"{lib_ms:.3f} ms  bound {b_ms:.3f} ms ({b_by})", flush=True)
    return rows


def chain_psf():
    """The chain MAP phase's PSF: the bench's Gaussian (sigma 2 native
    pixels) on a support wide enough that PSFConv routes to the DFT chain.
    Supersampled size: 177 px (the direct kernel's shared-memory limit) if
    the route rule still sends everything below it to the direct kernel,
    else the smallest odd size the rule sends to the chain plus 20, then
    the next size up that the rule sends to the chain and whose native
    kernel, (ss - 1) / 2 pixels wide, has a center pixel. Returns
    (supersampled size, native kernel)."""
    import numpy as np

    from gigalens_tpu_torch.ops.cuda.direct_conv import k4_route

    side = NUM_PIX * SUPERSAMPLE
    first = next(k for k in range(3, 401, 2)
                 if k4_route(k, k, SUPERSAMPLE, side, side) == "chain")
    ss = first if first >= 177 else first + 20
    while ((ss - 1) // 2) % 2 == 0 or k4_route(ss, ss, SUPERSAMPLE, side, side) != "chain":
        ss += 2
    n = (ss - 1) // 2
    c = (n - 1) / 2
    g = np.exp(-((np.arange(n) - c) ** 2 + (np.arange(n)[:, None] - c) ** 2) / 8.0)
    return ss, (g / g.sum()).astype(np.float32)


def ragged_checks(params, x, y, niter, gen):
    """Shapes off the kernels' tile grids: 3 samples x 1000 pixels (a band
    through the image center; not a multiple of the 256-pixel tile) for
    K1-K3; the direct K4 on 3x40x40 with a 13-px PSF, on 2x170x170 with the
    bench PSF's width (85x85 outputs: neither edge a multiple of the 80x80
    block), and at pools 3 and 1 (its other instantiations); the chain on a
    40x40 conv with a 9x9 PSF (no GEMM dimension a multiple of its tiles)
    and on 3x42x38 with an 11x7 PSF at pool 1 (rows of 38 and 42 floats: the
    4-byte copies; a 54 x 23 half spectrum padded to 56 x 24)."""
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
        worst.append(f"{n}x{h}x{h}/{kpx}px/pool {pool}: {rf:.1e} / {rt:.1e} (plans "
                     f"{json.dumps(plan_summary(d.plan(n, 'fwd')))} / "
                     f"{json.dumps(plan_summary(d.plan(n, 'transpose')))})")

    kern = rng.random((9, 9)).astype(np.float32)
    factors = dft_factors(kern / kern.sum(), (40, 40), 2, half=True)
    chain = dc.DFTConv(*factors, device=dev)
    for direction, mats, shape in (("fwd", chain.fwd_mats, (3, 40, 40)),
                                   ("transpose", chain.bwd_mats, (3, 20, 20))):
        a = torch.randn(shape, generator=gen, device=dev)
        ref = dc.dft_conv_reference(a.double(), [m.double() for m in mats])
        check_rel(f"K4 chain {direction} ragged", dc.dft_conv_cuda(a, mats, direction), ref,
                  CONV_REL)
    kern = rng.random((11, 7)).astype(np.float32)
    odd = dc.DFTConv(*dft_factors(kern / kern.sum(), (42, 38), 1, half=True), device=dev)
    for direction, mats in (("fwd", odd.fwd_mats), ("transpose", odd.bwd_mats)):
        a = torch.randn((3, 42, 38), generator=gen, device=dev)
        ref = dc.dft_conv_reference(a.double(), [m.double() for m in mats])
        check_rel(f"K4 chain {direction} ragged, unaligned rows",
                  dc.dft_conv_cuda(a, mats, direction), ref, CONV_REL)
    print("ragged shapes: K1-K3 on 3 samples x 1000 px match their float64 twins; K4 direct "
          "(rel err fwd / transpose) " + "; ".join(worst) + f"; K4 chain on 40x40, half "
          f"spectrum {tuple(factors[4].shape)}, and on 42x38 at pool 1, "
          f"{tuple(odd.fwd_mats[4].shape)} padded", flush=True)


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


def builder_rows(spec, params, x, y, summed, gen, phase, where="", extras=(), fwd_rel=None):
    """K5 (``summed``) or K6, and K7, on ``params`` (bs, n_cols): the
    forward against its float32 and float64 twins (BUILDER_FWD_RTOL /
    BUILDER_FWD_ATOL, or with ``fwd_rel`` that fraction of each sample's
    max |value|), K7 against float64 autograd of the one-stage twin and
    its float32 two-stage twin and bitwise over two calls, each timed
    against its twin, with its bound. Returns the two ``kernels`` rows of
    ``phase``."""
    import torch

    from gigalens_tpu_torch.ops.cuda import fused_builder as fb

    bs = params.shape[0]
    ex64 = tuple(e.double() for e in extras)
    at = f" at {where}" if where else ""
    kernels = []
    # forward: K5 (summed) or K6 (components)
    out_k = fb.fused_builder_fwd(spec, params, x, y, extras, summed)
    torch.cuda.synchronize()
    out64 = by_samples(lambda p: twin(spec, p.double(), x.double(), y.double(), summed, ex64),
                       bs, 50, summed, params)
    out32 = by_samples(lambda p: fb.tile_forward_twostage(spec, p, x, y, extras, summed), bs, 100,
                       summed, params)
    k = "K5" if summed else "K6"

    def per_sample(a, b):
        """max over samples of max |a - b| / max |b| (b the reference)."""
        err = (a.double() - b.double()).abs().reshape(-1, x.shape[0]).amax(1)
        return float((err / b.double().abs().reshape(-1, x.shape[0]).amax(1)).max())

    print(f"{k}{at}: max |err| vs the f64 twin: kernel "
          f"{float((out_k.double() - out64).abs().max()):.3e} ({per_sample(out_k, out64):.2e} "
          f"of a sample's max), f32 twin {float((out32.double() - out64).abs().max()):.3e} "
          f"({per_sample(out32, out64):.2e}); kernel vs f32 twin "
          f"{float((out_k - out32).abs().max()):.3e}", flush=True)
    if fwd_rel is None:
        check_close(f"{k}{at} vs f32 twin", out_k, out32, BUILDER_FWD_RTOL, BUILDER_FWD_ATOL)
        e_f = check_close(f"{k}{at} vs f64 twin", out_k, out64, BUILDER_FWD_RTOL,
                          BUILDER_FWD_ATOL)
    else:
        rows = (-1, x.shape[0])
        check_rel(f"{k}{at} vs f32 twin", out_k.reshape(rows), out32.reshape(rows), fwd_rel,
                  dim=1)
        e_f = check_rel(f"{k}{at} vs f64 twin", out_k.reshape(rows), out64.reshape(rows),
                        fwd_rel, dim=1)[1]
    del out64, out32
    ms = cuda_ms(lambda: fb.fused_builder_fwd(spec, params, x, y, extras, summed))
    pms = cuda_ms(lambda: fb.tile_forward_twostage(spec, params, x, y, extras, summed), reps=3,
                  warmup=1)
    # the bound's operations: the one-stage form's
    b_ms, b_by = bound(count_ops(lambda: twin(spec, params, x, y, summed, extras)),
                       [params, x, y, *extras, out_k])
    name = ("fused_builder_fwd summed (K5)" if summed
            else "fused_builder_fwd components (K6)") + at
    kernels.append(dict(name=name, phase=phase,
                        key="fused_builder_fwd_sum" if summed else "fused_builder_fwd_components",
                        route="cuda", source="gigalens_tpu_torch/csrc/fused_builder.cu",
                        replaces="gigalens_tpu/ops/pallas/fused_builder.py:612",
                        max_abs_err=e_f, ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                        library_ms=None))
    print(f"{name}: max|err| vs f64 {e_f:.3e}  kernel {ms:.3f} ms  twin {pms:.3f} ms  "
          f"bound {b_ms:.3f} ms ({b_by})", flush=True)

    # backward: K7 against f64 autograd and the f32 hand-VJP twin
    ct = torch.randn(out_k.shape, generator=gen, device=out_k.device)
    g_k = fb.fused_builder_bwd(spec, params, x, y, extras, ct, summed)
    torch.cuda.synchronize()
    g64 = by_samples(lambda p, c: autograd64(spec, p, x, y, c, summed, extras), bs, 25, summed,
                     params, ct)
    rel, e_b = check_rel(f"K7{at} ({phase}) vs f64 autograd of the twin", g_k, g64,
                         BUILDER_GRAD_REL, dim=0)
    g32 = by_samples(lambda p, c: fb.tile_backward_reference(spec, p, x, y, extras, c, summed),
                     bs, 50, summed, params, ct)
    rel32, _ = check_rel(f"K7{at} ({phase}) vs f32 hand-VJP twin", g_k, g32, BUILDER_GRAD_REL,
                         dim=0)
    if not torch.equal(g_k, fb.fused_builder_bwd(spec, params, x, y, extras, ct, summed)):
        raise AssertionError(f"K7{at} ({phase}) is not deterministic from run to run")
    ms = cuda_ms(lambda: fb.fused_builder_bwd(spec, params, x, y, extras, ct, summed))
    pms = cuda_ms(lambda: fb.tile_backward_reference(spec, params, x, y, extras, ct, summed),
                  reps=3, warmup=1)
    ops = count_ops(lambda: fb.tile_backward_onestage(spec, params, x, y, extras, ct, summed))
    b_ms, b_by = bound(ops, [params, x, y, *extras, ct, g_k])
    name = "fused_builder_bwd" + (" (K7)" if summed else " components (K7)") + at
    kernels.append(dict(name=name, phase=phase, key="fused_builder_bwd", route="cuda",
                        source="gigalens_tpu_torch/csrc/fused_builder.cu",
                        replaces="gigalens_tpu/ops/pallas/fused_builder.py:654",
                        max_abs_err=e_b, ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                        library_ms=None))
    print(f"{name}: col-rel err vs f64 autograd {rel:.3e} (vs f32 two-stage twin "
          f"{rel32:.3e}), bitwise repeatable  kernel {ms:.3f} ms  twin {pms:.3f} ms  "
          f"bound {b_ms:.3f} ms ({b_by})", flush=True)
    return kernels


def builder_checks():
    """K5 and K7 at family S's full width, K6 and K7-components at family
    L's; then every stage once (coverage) and ragged shapes."""
    import torch

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
        print(f"family {kind}: {spec.label}, bs={BS} npix={x.shape[0]} n_cols={spec.n_cols} "
              f"depth={spec.depth}", flush=True)
        kernels += builder_rows(spec, params, x, y, summed, gen, kind)
        builder_ragged(spec, params, x, y, summed, gen)
    builder_coverage(dev, gen)
    return kernels


def family_l_grams(prob, sim, z):
    """The (BS, 16, 16) float64 Grams that family L's lstsq solve hands the
    pseudo-inverse at the starts ``z``, taken at the call."""
    import torch

    import gigalens_tpu_torch.simulator as gsim

    seen, solve = [], gsim.gram_pinv

    def record(a, rtol):
        seen.append(a.detach().clone())
        return solve(a, rtol)

    gsim.gram_pinv = record
    try:
        with torch.no_grad():
            prob.log_prob(sim, z)
    finally:
        gsim.gram_pinv = solve
    return seen[0]


def step_syncs(prof):
    """``host_syncs_per_step`` (benchmark/metrics/host_syncs_per_step.py, the
    benchmark's reader) of a torch.profiler window: the CUDA calls that wait
    for the card inside its whole ``map.step`` spans, a step."""
    import importlib.util

    from torch.autograd import DeviceType

    spec = importlib.util.spec_from_file_location(
        "host_syncs_per_step", ROOT / "benchmark" / "metrics" / "host_syncs_per_step.py")
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    # host events only: a span's device-side annotation runs on the card's
    # clock, past the host's last call
    host = sorted((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), 0)
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() != DeviceType.CUDA)
    return reader.read({"host_trace": {"host": host}}, None)


def gram_pinv_checks():
    """The lstsq pseudo-inverse (csrc/gram_pinv.cu) on family L's Grams at
    BS prior starts: against its twin and torch.linalg.pinv (GRAM_PINV_REL
    of each matrix's largest entry; matrices with a singular value within
    1e-9 of the cutoff reported apart), bitwise over two calls and alone,
    NaN and inf matrices NaN and the others unchanged, timed against
    torch.linalg.pinv; then fit_map steps of the cell under torch.profiler:
    no synchronising call inside a step, one launch a step and no fallback,
    and torch.linalg.pinv in its place as the control (a wait a step)."""
    import torch

    import gigalens_tpu_torch.simulator as gsim
    from gigalens_tpu_torch.inference.map import fit_map
    from gigalens_tpu_torch.inference.sequence import map_optimizer
    from gigalens_tpu_torch.ops.cuda import gram_pinv as gp
    from gigalens_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from gigalens_tpu_torch.simulator import LensSimulator

    dev = torch.device("cuda")
    phys, prob, prior, cfg = problem("L")
    sim = LensSimulator(phys, cfg, bs=BS, device=dev)
    z = prior.unconstrain(prior.sample(torch.Generator(device=dev).manual_seed(7), BS))
    gram = family_l_grams(prob, sim, z)
    rtol = 1e-6
    p_k = gp.gram_pinv_cuda(gram, rtol)
    torch.cuda.synchronize()
    s = torch.linalg.svdvals(gram)
    near = ((s / s[:, :1] / rtol - 1.0).abs() < 1e-9).any(dim=1)
    errs = {}
    for name, want in (("twin", gp.gram_pinv_reference(gram, rtol)),
                       ("torch.linalg.pinv", torch.linalg.pinv(gram, rtol=rtol))):
        rel = (p_k - want).abs().amax((1, 2)) / want.abs().amax((1, 2)).clamp_min(1e-300)
        errs[name] = float(rel[~near].max())
        if not errs[name] <= GRAM_PINV_REL:
            raise AssertionError(f"gram_pinv vs {name}: {errs[name]:.3e} of a matrix's max "
                                 f"exceeds {GRAM_PINV_REL}")
        if near.any():
            print(f"gram_pinv vs {name}: {int(near.sum())} matrices within 1e-9 of the cutoff, "
                  f"largest error {float(rel[near].max()):.3e} of their max", flush=True)
    if not torch.equal(p_k, gp.gram_pinv_cuda(gram, rtol)):
        raise AssertionError("gram_pinv is not deterministic from run to run")
    if not torch.equal(p_k[:7], gp.gram_pinv_cuda(gram[:7].contiguous(), rtol)):
        raise AssertionError("gram_pinv's matrices depend on the batch they are in")
    bad = gram.clone()
    bad[3, 2, 5], bad[5, 0, 0] = float("nan"), float("inf")
    p_bad = gp.gram_pinv_cuda(bad, rtol)
    rest = torch.ones(BS, dtype=torch.bool, device=dev)
    rest[[3, 5]] = False
    if not (torch.isnan(p_bad[[3, 5]]).all() and torch.equal(p_bad[rest], p_k[rest])):
        raise AssertionError("gram_pinv: a NaN or inf matrix must come out NaN, the others "
                             "unchanged")
    ms = cuda_ms(lambda: gp.gram_pinv_cuda(gram, rtol), reps=20)
    pms = cuda_ms(lambda: gp.gram_pinv_reference(gram, rtol), reps=3, warmup=1)
    lib_ms = cuda_ms(lambda: torch.linalg.pinv(gram, rtol=rtol), reps=20)
    b_ms, b_by = bound(0, [gram, p_k])
    print(f"gram_pinv ({BS}, 16, 16) family L Grams: rel err vs twin {errs['twin']:.3e}, vs "
          f"torch.linalg.pinv {errs['torch.linalg.pinv']:.3e}; bitwise repeatable and alone; "
          f"NaN rows NaN  kernel {ms:.4f} ms  twin {pms:.3f} ms  torch.linalg.pinv (with its "
          f"host read) {lib_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})", flush=True)

    opt = map_optimizer(5)
    fit_map(prob, sim, opt, start=z, num_steps=2)
    syncs = {}
    for route in ("kernel", "torch.linalg.pinv"):
        solve = gsim.gram_pinv
        if route != "kernel":
            gsim.gram_pinv = lambda a, rtol: torch.linalg.pinv(a, rtol=rtol)
        try:
            torch.cuda.synchronize()
            reset_launch_counts()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                fit_map(prob, sim, opt, start=z, num_steps=3)
                torch.cuda.synchronize()
            counts = launch_counts()
        finally:
            gsim.gram_pinv = solve
        syncs[route] = step_syncs(prof)
        print(f"fit_map steps of family L at bs={BS}, pinv by {route}: {syncs[route]} "
              f"synchronising calls a step; gram_pinv launches {counts['gram_pinv']}, "
              f"fallbacks {counts['gram_pinv_fallback']}", flush=True)
        if route == "kernel" and (syncs[route] != 0 or counts["gram_pinv"] != 3
                                  or counts["gram_pinv_fallback"] != 0):
            raise AssertionError(f"a family L MAP step must launch gram_pinv once, fall back "
                                 f"never and wait for the card nowhere: {syncs[route]} "
                                 f"synchronising calls a step, {counts}")
    if (syncs["torch.linalg.pinv"] or 0) < 1:
        raise AssertionError(f"the control (torch.linalg.pinv) shows no wait a step "
                             f"({syncs['torch.linalg.pinv']}): the trace misses the calls")
    return [dict(name="gram_pinv (family L Grams)", phase="L", key="gram_pinv", route="cuda",
                 source="gigalens_tpu_torch/csrc/gram_pinv.cu",
                 replaces="none (jnp.linalg.pinv, gigalens_tpu/simulator.py lstsq_simulate)",
                 max_abs_err=errs["twin"], ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                 library_ms=lib_ms)]


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
    # the Taylor-series stage on seeded coefficient grids, order 3 (the
    # cluster phase runs it on a real profile's grids)
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
    check_launches(f"MAP {label}", counts, need)
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
    the bench scene under the chain phase's wide PSF ("chain"), family S
    ("S": ForwardProbModel) or family L ("L": BackwardProbModel).
    The truth is a seeded prior draw rendered by the port, observed with
    bench.py's noise (family L's amplitudes: a bench-like lens light and
    Normal(0, 50) shapelets)."""
    import torch

    from gigalens_tpu_torch.model import BackwardProbModel, ForwardProbModel
    from gigalens_tpu_torch.simulator import LensSimulator

    dev = torch.device("cuda")
    phys, cfg, _ = bench_scene()
    prior = bench_prior()
    if kind == "chain":
        cfg = dataclasses.replace(cfg, kernel=chain_psf()[1])
    elif kind != "bench":
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


def chain_path(steps):
    """The bench scene's MAP phase under a PSF wide enough for the DFT chain
    (K1-K3 and the chain K4 both ways, no direct K4). Before the phase one
    rendered batch of prior draws is held against the float64 FFT
    convolution of the same PSF; after it the chain's launches must be
    exactly the phase's renders: one forward a step plus three to score
    (step 0, the final log-density, best_map_start) and one transpose a
    step."""
    import torch

    from gigalens_tpu_torch.ops.psf import PSFConv, average_pool

    phys, prob, prior, cfg = problem("chain")
    ss = chain_psf()[0]

    def check(sim):
        conv = sim._conv
        if (not sim._use_fused or sim._fused_niter is None or conv is None
                or conv.mode != "dft" or conv.route != "chain" or conv.kh != ss):
            raise AssertionError(f"the chain phase's simulator must take K1-K3 and the DFT "
                                 f"chain at a {ss}-px PSF, got route "
                                 f"{getattr(conv, 'route', None)}")
        params = prior.sample(torch.Generator(device=sim.device).manual_seed(5), BS)
        with torch.no_grad():
            got = sim.simulate(params)
            flat = torch.nan_to_num(sim._place(sim._flat_light(params)))
            fft64 = PSFConv(conv.kernel, (conv.h, conv.w), mode="fft", device=sim.device)
            want = chunked(lambda a: average_pool(fft64(a.double()), conv.pool), BS, 100,
                           flat) * sim.conversion_factor
        rel, _ = check_rel("chain phase render vs f64 fft conv", got, want, RENDER_REL)
        print(f"MAP chain: PSFConv route {conv.route} at a {ss}-px supersampled PSF (half "
              f"spectrum {tuple(conv._dft.fwd_mats[4].shape)}); rendered batch vs float64 FFT "
              f"conv: rel err {rel:.3e}", flush=True)

    need = ("fused_render_fwd_omega", "fused_render_bwd", "dft_conv_fwd", "dft_conv_transpose")
    counts = map_phase(f"chain ({ss}-px PSF)", phys, prob, prior, cfg, steps, check, need)
    want = dict(dft_conv_fwd=steps + 3, dft_conv_transpose=steps, direct_conv_fwd=0,
                direct_conv_transpose=0)
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"chain phase launches {got}, expected {want}")
    return counts


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
    if kind == "L":
        need += ("gram_pinv",)
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
        check_launches(f"pipeline {phase}", rec[phase]["counts"], need, banned)
    return pipe, rec


# the positions phase (examples/demo_cluster.py --smc at a smaller depth):
# MAP starts x steps, SMC particles and post steps, image-position errors
POS_MAP_N, POS_MAP_STEPS, POS_PARTICLES, POS_POST, POS_ERR = 200, 100, 200, 10, 0.1
PROFILE_SEED = 3


def device_rows(prof):
    """(device us, calls, name) per kernel of a torch.profiler window,
    device-side events only (a CPU op's device time repeats its kernels'),
    largest first."""
    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # a record_function range also shows on the device as an annotation
    # spanning its kernels: not a kernel, never counted
    return sorted(((dev_us(e), e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0
                   and not getattr(e, "is_user_annotation", False)), reverse=True)


def kernel_us_by_range(prof, names):
    """Device us of the kernels inside each named record_function range of
    a torch.profiler window ({name: us}, and "" for the kernels outside
    them): each kernel goes to the range whose device-side annotation span
    contains it."""
    import bisect

    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                   if getattr(e, "is_user_annotation", False) and e.name in names)
    starts = [sp[0] for sp in spans]
    out = dict.fromkeys(list(names) + [""], 0.0)
    for e in events:
        if getattr(e, "is_user_annotation", False):
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        i = bisect.bisect_right(starts, t0) - 1
        inside = i >= 0 and t1 <= spans[i][1]
        out[spans[i][2] if inside else ""] += t1 - t0
    return out


def smc_phase(pipe, rec):
    """Adaptive-tempering SMC at full width on the pipeline's scene
    (Pipeline.phase_smc: scripts/bench_smc.py's recipe, 1000 particles x 1
    ensemble, 3-leapfrog moves, ESS threshold 0.6, 100 post steps, max 200
    stages, seed 1, prior start, pixels target, the default auxiliary
    degrading to none) through ModellingSequence.SMC on the exact
    simulator. Launch counters and peak memory are zeroed just before and
    read just after (the pipeline's phase hook). Raises unless beta reaches
    1 inside max_stage, the log-evidence and the (100, 1000, d) post samples
    are finite, the last post draw's mean red-chi2 is <= CHI2_GATE, and K2/K3
    launched with no K4 by either route. Returns the SMC result and a
    callable that times one stage of moves from the final cloud twice,
    plain and under torch.profiler, for the host ms a leapfrog and the
    device's idle share."""
    import torch

    from gigalens_tpu_torch import bench
    from gigalens_tpu_torch.inference.smc import fit_smc

    c = bench.SMC_CONFIGS["full"]
    pipe.phase_smc()
    res, block, r = pipe.smc_res, pipe.result["smc"], rec["smc"]
    counts = r["counts"]
    print(f"SMC: {c['particles']} particles x {c['ensembles']} ensemble, L {c['leapfrog_steps']}, "
          f"ESS threshold {c['ess_threshold_ratio']}: {block['stages']} stages to beta "
          f"{block['final_beta']}, {block['moves']} tempering moves + {c['post_steps']} post "
          f"steps = {block['leapfrogs']} leapfrogs", flush=True)
    print(f"SMC: wall {block['wall_s']} s (tempering {block['tempering_s']} s, post chain "
          f"{block['post_s']} s), {block['ms_per_leapfrog']} ms/leapfrog on the host clock at "
          f"bs {c['particles'] * c['ensembles']}, peak device memory {r['peak']:.3f} GiB",
          flush=True)
    print(f"SMC: logZ {block['log_evidence']}, posterior red-chi2 (last post draw) "
          f"{block['posterior_red_chi2']}, launches {json.dumps(counts)}", flush=True)
    print(f"SMC JSON: {json.dumps(block)}", flush=True)

    d = pipe.prior.d
    n = c["particles"] * c["ensembles"]
    if not (bool((res.final_beta == 1.0).all()) and res.num_stages < c["max_stage"]):
        raise AssertionError(f"SMC did not reach beta = 1 inside {c['max_stage']} stages: "
                             f"beta {block['final_beta']} after {res.num_stages}")
    if not torch.isfinite(res.log_evidence).all():
        raise AssertionError(f"SMC log-evidence not finite: {block['log_evidence']}")
    if (tuple(res.post_samples.shape) != (c["post_steps"], n, d)
            or not torch.isfinite(res.post_samples).all()):
        raise AssertionError(f"SMC post samples not finite / wrong shape "
                             f"{tuple(res.post_samples.shape)}")
    if not block["posterior_red_chi2"] <= CHI2_GATE:
        raise AssertionError(f"SMC posterior red-chi2 {block['posterior_red_chi2']} > {CHI2_GATE}")
    check_launches("SMC", counts, HMC_NEED, HMC_BANNED)

    # one stage of moves from the final cloud (8 moves of 3 leapfrogs and
    # the first evaluation), plain then profiled
    sim = pipe.seq._sim(n, exact=True)

    def stage():
        out = fit_smc(pipe.prob_model, sim, start=res.particles, num_particles=c["particles"],
                      num_ensembles=c["ensembles"], num_leapfrog_steps=c["leapfrog_steps"],
                      post_sampling_steps=0, ess_threshold_ratio=c["ess_threshold_ratio"],
                      max_stage=1, seed=PROFILE_SEED)
        return out.num_moves * c["leapfrog_steps"] + 1

    def profiled():
        rows, evals_p = profile_stage("SMC", stage)
        groups = {"K2+K3": [0.0, 0], "cuFFT": [0.0, 0], "the rest": [0.0, 0]}
        for us, count, key in rows:
            g = groups["K2+K3" if "fused_render" in key
                       else "cuFFT" if "fft" in key.lower() else "the rest"]
            g[0], g[1] = g[0] + us, g[1] + count
        print("SMC device time a leapfrog by group: " + ", ".join(
            f"{name} {us / 1e3 / evals_p:.3f} ms ({count / evals_p:.0f} launches)"
            for name, (us, count) in groups.items()), flush=True)

    return res, profiled


def profile_stage(label, stage, what="one stage from the final cloud"):
    """Runs ``stage`` (``what``: one SMC stage from a final cloud by
    default; returns its evaluations with gradients) plain, then under
    torch.profiler, and
    prints host ms a leapfrog, device busy ms a leapfrog, the idle share of
    the unprofiled wall (each per evaluation), launches a leapfrog and the
    largest kernels. Returns (device rows, evaluations of the profiled
    run)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evals = stage()
    torch.cuda.synchronize()
    plain = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        evals_p = stage()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e6
    print(f"{label} profile ({what}, {evals} evaluations with "
          f"gradients): {1e3 * plain / evals:.3f} ms/leapfrog unprofiled, "
          f"{1e3 * wall / evals_p:.3f} profiled; device busy {1e3 * busy / evals_p:.3f} "
          f"ms/leapfrog = idle {100 * (1 - busy * evals / (plain * evals_p)):.1f}% of the "
          f"unprofiled wall; {sum(r[1] for r in rows) / evals_p:.0f} launches a leapfrog; by "
          f"kernel (ms/leapfrog, launches/leapfrog, name):", flush=True)
    for us, count, key in rows[:8]:
        print(f"  {us / 1e3 / evals_p:8.3f}  {count / evals_p:6.1f}  {key[:100]}", flush=True)
    if busy <= 0:
        raise AssertionError(f"torch.profiler saw no device time in the {label} moves")
    return rows, evals_p


def positions_phase(pipe):
    """The multiple-image positions workflow (examples/demo_cluster.py
    --smc) at a smaller depth: the images of the scene's true source under
    the true lens from find_images (>= 2 required), a ForwardProbModel with
    pixels and positions, a short multi-start MAP, then SMC annealing both
    terms (target "pixels+positions", auxiliar "none") from the MAP
    subsample. Raises unless beta reaches 1 and the last post draw's mean
    pixel and position red-chi2 are each <= CHI2_GATE."""
    import numpy as np
    import torch

    from gigalens_tpu_torch import bench
    from gigalens_tpu_torch.inference import ModellingSequence
    from gigalens_tpu_torch.inference.sequence import map_optimizer
    from gigalens_tpu_torch.model import ForwardProbModel
    from gigalens_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from gigalens_tpu_torch.simulator import LensSimulator
    from gigalens_tpu_torch.utils import find_images

    dev = torch.device("cuda")
    truth, phys, cfg = pipe.truth, pipe.phys, pipe.sim_config
    src = truth["source_light"][0]
    t0 = time.perf_counter()
    img_x, img_y, mags = find_images(LensSimulator(phys, cfg, bs=1, device=dev),
                                     truth["lens_mass"], float(src["center_x"][0]),
                                     float(src["center_y"][0]))
    t_find = time.perf_counter() - t0
    print(f"positions: find_images {t_find:.2f} s: {len(img_x)} images "
          + ", ".join(f"({x:+.3f}, {y:+.3f}; mu {m:+.2f})"
                      for x, y, m in zip(img_x, img_y, mags)), flush=True)
    if len(img_x) < 2:
        raise AssertionError(f"find_images found {len(img_x)} image(s) of the true source")
    err = np.full(len(img_x), POS_ERR, np.float32)
    prob = ForwardProbModel(pipe.prior, pipe.prob_model.observed_image.cpu().numpy(),
                            background_rms=bench.BKG, exp_time=bench.EXP_TIME,
                            centroids_x=[img_x], centroids_y=[img_y],
                            centroids_errors_x=[err], centroids_errors_y=[err], device=dev)
    seq = ModellingSequence(phys, prob, cfg, device=dev)

    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    z_map = seq.MAP(map_optimizer(POS_MAP_STEPS), n_samples=POS_MAP_N,
                    num_steps=POS_MAP_STEPS, seed=0)
    torch.cuda.synchronize()
    t_map = time.perf_counter() - t0
    res = seq.SMC(start=z_map, num_particles=POS_PARTICLES, num_ensembles=1,
                  num_leapfrog_steps=3, post_sampling_steps=POS_POST, ess_threshold_ratio=0.6,
                  max_stage=200, target="pixels+positions", auxiliar="none", seed=1)
    torch.cuda.synchronize()
    t_smc = time.perf_counter() - t0 - t_map
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30

    last = res.post_samples[-1]
    sim = LensSimulator(phys, cfg, bs=last.shape[0], device=dev)
    with torch.no_grad():
        x = prob.prior.constrain(last)
        chi_pix = float(torch.mean(prob.stats_pixels(sim, x)[1]))
        chi_pos = float(torch.mean(prob.stats_positions(sim, x)[1]))
    leapfrogs = (res.num_moves + POS_POST) * 3
    print(f"positions: MAP {POS_MAP_N} x {POS_MAP_STEPS} in {t_map:.2f} s; SMC {POS_PARTICLES} "
          f"particles from the MAP subsample, target pixels+positions: {t_smc:.2f} s "
          f"(tempering {res.tempering_s:.2f} s), {res.num_stages} stages to beta "
          f"{res.final_beta.tolist()}, {leapfrogs} leapfrogs, "
          f"{1e3 * t_smc / leapfrogs:.3f} ms/leapfrog, peak device memory {peak:.3f} GiB",
          flush=True)
    print(f"positions: posterior red-chi2 (last post draw) pixels {chi_pix:.4f}, positions "
          f"{chi_pos:.4f}; launches {json.dumps(counts)}", flush=True)
    if not bool((res.final_beta == 1.0).all()):
        raise AssertionError(f"positions SMC stopped at beta {res.final_beta.tolist()}")
    if not (chi_pix <= CHI2_GATE and chi_pos <= CHI2_GATE):
        raise AssertionError(f"positions SMC posterior red-chi2 pixels {chi_pix}, positions "
                             f"{chi_pos} (gate {CHI2_GATE})")
    if not torch.isfinite(res.post_samples).all():
        raise AssertionError("positions SMC post samples not finite")


# the cluster phase: the dpie arm of config #5 as
# scripts/bench_cluster_posterior.py:86-190 builds it (bench.cluster_scene),
# MAP then SMC as examples/demo_cluster.py:183-190 runs it (post steps cut
# from 100 to 10)
CL_MAP_N, CL_MAP_STEPS, CL_LSTSQ_STEPS = 128, 400, 50
CL_PARTICLES, CL_LEAPFROG, CL_POST, CL_MAX_STAGE = 1000, 10, 10, 200
CL_CHI2 = (0.85, 1.15)  # the config #5 gate (BASELINE.md:526)
CL_SERIES_BS = 1000
# K5 at the cluster MAP's and SMC's states, of each sample's max |value|:
# the halo deflects by several arcsec into a compact shapelet source (the
# MAP ends at beta down to 0.2"), so the float32 rounding of the ray-shot
# position reaches 5.3e-4 of a sample's max in the float32 twin itself
# (measured on the cluster MAP's final states, where the kernel and the
# float32 twin are both 5.8e-3 absolute off float64)
CLUSTER_FWD_REL = 2e-3
# the series at dv = 0 against the direct member sum, of its max; at r_cut
# draws from the prior, JAX's own tolerance (tests/test_cluster.py:123-150)
SERIES_REL, SERIES_RTOL, SERIES_ATOL = 1e-4, 5e-3, 2e-3
# scripts/bench_cluster.py's defaults: the direct member sum against the series
HOT_G, HOT_SIDE, HOT_BS, HOT_CHUNK, HOT_REPEATS = 200, 160, 64, 32, 10
CL_MAP_NEED = ("fused_builder_fwd_sum", "fused_builder_bwd", "direct_conv_fwd",
               "direct_conv_transpose")
BUILDER_ROUTE_BANNED = ("fused_render_fwd", "fused_render_fwd_omega", "fused_render_bwd")


def series_checks(members, prior, sim, dev):
    """The series deflection on the phase's grid against the direct
    ScalingRelation(DPIE) sum, theta_E from its prior at CL_SERIES_BS
    samples: at dv = 0 (SERIES_REL of the max), and with r_cut uniform in
    log over the prior's central band, +-0.5 sigma (SERIES_RTOL /
    SERIES_ATOL, JAX's own tolerance for the order-3 series). The
    truncation error further out (at +-1 and +-2 sigma, theta_E at its
    median) is printed, not gated: it is the reference's series as well."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(11)
    te = prior.sample(gen, CL_SERIES_BS)["lens_mass"][1]["theta_E"][:, None]
    u = torch.rand((CL_SERIES_BS, 1), generator=gen, device=dev) - 0.5
    x, y = sim.img_x, sim.img_y
    from gigalens_tpu_torch import bench

    consts = bench.CL_CONSTS
    r0, r_core = consts["r_cut"], torch.tensor(consts["r_core"], device=dev)

    def both(theta_E, r_cut):
        with torch.no_grad():
            return (members.deriv(x, y, theta_E=theta_E, r_cut=r_cut),
                    members._rel.deriv(x, y, theta_E=theta_E, r_core=r_core, r_cut=r_cut))

    got, want = both(te, torch.full_like(te, r0))
    e0 = max(check_rel("series at dv = 0 vs the direct member sum", g, w, SERIES_REL)[0]
             for g, w in zip(got, want))
    got, want = both(te, r0 * torch.exp(0.2 * u))
    e1 = max(check_close("series in the +-0.5 sigma band vs the direct member sum", g, w,
                         SERIES_RTOL, SERIES_ATOL) for g, w in zip(got, want))
    sig = torch.tensor([-2.0, -1.0, 1.0, 2.0], device=dev)[:, None]
    got, want = both(torch.full_like(sig, 0.3), r0 * torch.exp(0.2 * sig))
    tails = torch.stack([(g - w).abs().amax(1) for g, w in zip(got, want)]).amax(0).tolist()
    print(f"cluster series ({members.n_galaxy} members, order {bench.CL_ORDER}, {x.shape[0]} px, bs "
          f"{CL_SERIES_BS}) against the direct dPIE sum: rel err at dv = 0 {e0:.3e} (of the "
          f"max), max |err| in the +-0.5 sigma r_cut band {e1:.3e}; truncation at theta_E 0.3, "
          f"r_cut at -2 / -1 / +1 / +2 sigma: " + " / ".join(f"{t:.2e}" for t in tails),
          flush=True)


def cluster_phase():
    """The cluster scene of config #5 (dpie arm) through MAP -> SMC on the
    builder's series stage, then the lstsq MAP. Returns (launch counts by
    phase, a callable that runs cluster_timed on the phase's states and
    returns its kernels rows, (the scene, the MAP's z and wall) for step
    10b)."""
    import torch

    from gigalens_tpu_torch import PhysicalModel
    from gigalens_tpu_torch.inference import ModellingSequence
    from gigalens_tpu_torch.inference.sequence import map_optimizer
    from gigalens_tpu_torch.inference.smc import fit_smc
    from gigalens_tpu_torch.model import BackwardProbModel
    from gigalens_tpu_torch.ops.cuda import fused_builder as fb
    from gigalens_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from gigalens_tpu_torch.profiles.light import Shapelets
    from gigalens_tpu_torch.profiles.mass import NFW_ELLIPSE
    from gigalens_tpu_torch.simulator import LensSimulator

    dev = torch.device("cuda")
    t_phase = time.perf_counter()

    def clock():
        return f"[{time.perf_counter() - t_phase:.1f} s into the phase]"

    from gigalens_tpu_torch import bench

    # 1. the scene: the series precompute at the prior-mean point, on the card
    sc = bench.cluster_scene("dpie", device=dev)
    phys, prior, cfg, members, prob = sc.phys, sc.prior, sc.cfg, sc.members, sc.prob
    probe = LensSimulator(phys, cfg, bs=1, device=dev)
    print(f"cluster: series precompute (set_deriv, {sc.galaxies} members, order "
          f"{bench.CL_ORDER}, {probe.img_x.shape[0]} px) {sc.precompute_s:.3f} s, coefficients "
          f"{tuple(members._deriv_coefs.shape)}", flush=True)
    series_checks(members, prior, probe, dev)
    print(f"cluster: series checked {clock()}", flush=True)

    # 2. truth, observation and the images of the true source
    truth, obs = sc.truth, sc.obs
    img_x, img_y, mags = sc.images
    print(f"cluster: find_images: {len(img_x)} images "
          + ", ".join(f"({a:+.3f}, {b:+.3f}; mu {m:+.2f})" for a, b, m in zip(img_x, img_y, mags))
          + f" {clock()}", flush=True)
    if len(img_x) < 2 or not prob.include_positions:
        raise AssertionError(f"find_images found {len(img_x)} image(s) of the cluster truth")
    seq = ModellingSequence(phys, prob, cfg, device=dev)
    counts = {}

    # 3. MAP on pixels + positions: K5/K7 and the direct K4, counted exactly
    sim_map = seq._sim(CL_MAP_N)
    spec = sim_map._fused_spec
    if not (sim_map._use_fused and spec is not None and fb.SERIES in [st.op for st in spec.stages]
            and direct_route(sim_map)):
        raise AssertionError("the cluster MAP simulator must take the builder tier with a series "
                             "stage and the direct K4")
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    z_map = seq.MAP(map_optimizer(CL_MAP_STEPS), n_samples=CL_MAP_N, num_steps=CL_MAP_STEPS,
                    seed=0)
    torch.cuda.synchronize()
    t_map = time.perf_counter() - t0
    counts["cluster_map"] = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    with torch.no_grad():
        x_map = prior.constrain(z_map)
        chi_pix = prob.stats_pixels(sim_map, x_map)[1]
        chi_pos = prob.stats_positions(sim_map, x_map)[1]
    best = int(torch.argmin(torch.nan_to_num(chi_pix, nan=float("inf"))))
    print(f"cluster MAP: {CL_MAP_N} starts x {CL_MAP_STEPS} steps on pixels + positions in "
          f"{t_map:.2f} s ({1e3 * t_map / CL_MAP_STEPS:.3f} ms/step, host clock), peak device "
          f"memory {peak:.3f} GiB; best pixel red-chi2 {float(chi_pix[best]):.4f} (positions "
          f"{float(chi_pos[best]):.4f}); launches {json.dumps(counts['cluster_map'])} {clock()}",
          flush=True)
    n = CL_MAP_STEPS
    check_launches("cluster MAP", counts["cluster_map"], banned=BUILDER_ROUTE_BANNED + (
        "fused_builder_fwd_components", "dft_conv_fwd", "dft_conv_transpose"),
        exact=dict(fused_builder_fwd_sum=n, fused_builder_bwd=n, direct_conv_fwd=n,
                   direct_conv_transpose=n))
    if not torch.isfinite(z_map).all():
        raise AssertionError("cluster MAP output not finite")

    # 4. SMC on the exact path from the MAP starts
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = seq.SMC(start=z_map, num_particles=CL_PARTICLES, num_ensembles=1,
                  num_leapfrog_steps=CL_LEAPFROG, post_sampling_steps=CL_POST,
                  max_stage=CL_MAX_STAGE, target="pixels+positions", auxiliar="none", seed=1)
    torch.cuda.synchronize()
    t_smc = time.perf_counter() - t0
    counts["cluster_smc"] = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    sim_smc = seq._sim(CL_PARTICLES, exact=True)
    last = res.post_samples[-1].reshape(-1, prior.d)
    with torch.no_grad():
        x_last = prior.constrain(last)
        chi_pix = float(torch.mean(prob.stats_pixels(sim_smc, x_last)[1]))
        chi_pos = float(torch.mean(prob.stats_positions(sim_smc, x_last)[1]))
    leapfrogs = (res.num_moves + CL_POST) * CL_LEAPFROG
    logz = res.log_evidence.tolist()
    te = x_last["lens_mass"][1]["theta_E"]
    print(f"cluster SMC: {CL_PARTICLES} particles from the MAP starts, L {CL_LEAPFROG}, target "
          f"pixels+positions: {res.num_stages} stages to beta {res.final_beta.tolist()}, "
          f"{res.num_moves} moves + {CL_POST} post steps = {leapfrogs} leapfrogs in "
          f"{t_smc:.2f} s (tempering {res.tempering_s:.2f} s), {1e3 * t_smc / leapfrogs:.3f} "
          f"ms/leapfrog on the host clock, peak device memory {peak:.3f} GiB", flush=True)
    print(f"cluster SMC: logZ {logz}, posterior red-chi2 (last post draw) pixels {chi_pix:.4f}, "
          f"positions {chi_pos:.4f}; theta_E* {float(te.mean()):.4f} +- {float(te.std()):.4f} "
          f"(truth {float(truth['lens_mass'][1]['theta_E'][0]):.4f}); launches "
          f"{json.dumps(counts['cluster_smc'])} {clock()}", flush=True)
    if not (bool((res.final_beta == 1.0).all()) and res.num_stages < CL_MAX_STAGE):
        raise AssertionError(f"cluster SMC did not reach beta = 1 inside {CL_MAX_STAGE} stages")
    if not torch.isfinite(res.log_evidence).all() or not torch.isfinite(res.post_samples).all():
        raise AssertionError(f"cluster SMC log-evidence {logz} or post samples not finite")
    if not CL_CHI2[0] <= chi_pix <= CL_CHI2[1]:
        raise AssertionError(f"cluster SMC posterior red-chi2 {chi_pix} outside {CL_CHI2}")
    check_launches("cluster SMC", counts["cluster_smc"],
                   need=("fused_builder_fwd_sum", "fused_builder_bwd"),
                   banned=HMC_BANNED + BUILDER_ROUTE_BANNED)

    def stage():
        # one move: at ~2,800 launches a leapfrog the profiler's tables of a
        # whole stage (8 moves) take minutes to read
        out = fit_smc(prob, sim_smc, start=res.particles, num_particles=CL_PARTICLES,
                      num_ensembles=1, num_leapfrog_steps=CL_LEAPFROG, post_sampling_steps=0,
                      max_sampling_per_stage=1, max_stage=1, target="pixels+positions",
                      auxiliar="none", seed=PROFILE_SEED)
        return out.num_moves * CL_LEAPFROG + 1

    # 5. the lstsq MAP (BackwardProbModel, Shapelets(4)[lstsq]): K6/K7
    phys_l = PhysicalModel([NFW_ELLIPSE(), members], [], [Shapelets(bench.CL_NMAX, use_lstsq=True)])
    prior_l = bench.cluster_prior("dpie", amplitudes=False)
    prob_l = BackwardProbModel(prior_l, obs, background_rms=bench.CL_BKG, exp_time=bench.CL_EXP_TIME,
                               device=dev)
    seq_l = ModellingSequence(phys_l, prob_l, cfg, device=dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    z_l = seq_l.MAP(map_optimizer(CL_LSTSQ_STEPS), n_samples=CL_MAP_N,
                    num_steps=CL_LSTSQ_STEPS, seed=0)
    torch.cuda.synchronize()
    t_l = time.perf_counter() - t0
    counts["cluster_lstsq"] = launch_counts()
    sim_l = seq_l._sim(CL_MAP_N)
    with torch.no_grad():
        chi_l = prob_l.stats_pixels(sim_l, prior_l.constrain(z_l))[1]
    print(f"cluster lstsq MAP: {CL_MAP_N} x {CL_LSTSQ_STEPS} in {t_l:.2f} s "
          f"({1e3 * t_l / CL_LSTSQ_STEPS:.3f} ms/step), {sim_l.depth} components, best pixel "
          f"red-chi2 {float(torch.nan_to_num(chi_l, nan=float('inf')).min()):.4f}; launches "
          f"{json.dumps(counts['cluster_lstsq'])} {clock()}", flush=True)
    n = CL_LSTSQ_STEPS
    check_launches("cluster lstsq MAP", counts["cluster_lstsq"],
                   banned=("fused_builder_fwd_sum",) + BUILDER_ROUTE_BANNED,
                   exact=dict(fused_builder_fwd_components=n, fused_builder_bwd=n))

    print(f"cluster phase: sampled in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts, lambda: cluster_timed(dev, stage, prior, prior_l, (sim_map, z_map),
                                         (sim_smc, res), (sim_l, z_l)), (sc, z_map, t_map)


def cluster_timed(dev, stage, prior, prior_l, map_, smc, lstsq):
    """The cluster phase's measurements, run with the card to this process
    alone: one SMC stage profiled; 6. K5, K6, K7 and the direct K4 at the
    phase's shapes and real grids (``map_``, ``smc``, ``lstsq``: each
    (simulator, states)); the cluster hot loop. Returns kernels rows."""
    import torch

    from gigalens_tpu_torch.ops.cuda import fused_builder as fb

    t_phase = time.perf_counter()

    def clock():
        return f"[{time.perf_counter() - t_phase:.1f} s into the measurements]"

    profile_stage("cluster SMC", stage)
    print(f"cluster: SMC stage profiled {clock()}", flush=True)
    (sim_map, z_map), (sim_smc, res), (sim_l, z_l) = map_, smc, lstsq
    gen = torch.Generator(device=dev).manual_seed(12)
    kernels = []
    for phase, sim, z, pr, summed in (("cluster_map", sim_map, z_map, prior, True),
                                      ("cluster_smc", sim_smc, res.particles.reshape(-1, prior.d),
                                       prior, True),
                                      ("cluster_lstsq", sim_l, z_l, prior_l, False)):
        spec = sim._fused_spec
        params = spec.pack(pr.constrain(z)).contiguous()
        extras = spec.gather_extras(sim.img_x, sim.img_y)
        where = f"cluster {phase.split('_')[1].upper()} bs={params.shape[0]}"
        kernels += builder_rows(spec, params, sim.img_x, sim.img_y, summed, gen, phase, where,
                                extras, fwd_rel=CLUSTER_FWD_REL if summed else None)
        if phase == "cluster_map":
            with torch.no_grad():
                flat = fb.fused_builder_fwd(spec, params, sim.img_x, sim.img_y, extras)
            conv = sim._conv
            xin = flat.reshape(-1, conv.h, conv.w).contiguous()
            ctc = torch.randn((xin.shape[0], conv.h // conv.pool, conv.w // conv.pool),
                              generator=gen, device=dev)
            rows, _ = direct_checks(conv, xin, ctc, where)
            kernels += [dict(r, phase=phase) for r in rows]
    print(f"cluster: kernels checked {clock()}", flush=True)
    cluster_hot_loop(dev)
    print(f"cluster phase: measured in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return kernels


def cluster_hot_loop(dev):
    """scripts/bench_cluster.py's hot loop at its defaults (200 members,
    160 x 160 px over +-30", bs 64, order 3, chunks of 32): the direct
    DPIESubhalo sum against the DPIESubhaloSeries, forward and forward +
    gradient in the scales, ms a call on the host clock around a
    synchronize (HOT_REPEATS calls after two warm-ups)."""
    import numpy as np
    import torch

    from gigalens_tpu_torch.profiles.mass import DPIESubhalo, DPIESubhaloSeries

    rng = np.random.default_rng(0)
    from gigalens_tpu_torch import bench

    cat = bench.cluster_catalogue(HOT_G, 20.0, 0.3)
    side = np.linspace(-30, 30, HOT_SIDE, dtype=np.float32)
    X, Y = np.meshgrid(side, side)
    x = torch.tensor(X.reshape(-1), device=dev)
    y = torch.tensor(Y.reshape(-1), device=dev)
    scales = torch.tensor(np.stack([rng.uniform(0.5, 1.5, HOT_BS), np.full(HOT_BS, 0.08),
                                    np.full(HOT_BS, 1.6)], 1).astype(np.float32), device=dev)
    direct = DPIESubhalo(lum_star=1.0, galaxy_catalogue=cat, chunk_size=HOT_CHUNK)
    series = DPIESubhaloSeries(lum_star=1.0, galaxy_catalogue=cat, order=bench.CL_ORDER,
                               chunk_size=HOT_CHUNK)

    def timed(fn):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOT_REPEATS):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / HOT_REPEATS

    def direct_sum(s):
        return direct.deriv(x, y, theta_E=s[:, 0:1], r_core=s[:, 1:2], r_cut=s[:, 2:3])[0].sum()

    def series_sum(s):
        return series.deriv(x, y, theta_E=s[:, 0:1], r_cut=s[:, 2:3])[0].sum()

    def fwd_grad(fn):
        s = scales.clone().requires_grad_(True)
        return torch.autograd.grad(fn(s), s)[0]

    out = {}
    with torch.no_grad():
        out["direct fwd"] = timed(lambda: direct_sum(scales))
    out["direct fwd+grad"] = timed(lambda: fwd_grad(direct_sum))
    series.set_constants(dict(r_cut=1.6, r_core=0.08))
    series.set_grid(x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    series.set_deriv()
    torch.cuda.synchronize()
    out["series precompute (once)"] = 1e3 * (time.perf_counter() - t0)
    with torch.no_grad():
        out["series fwd"] = timed(lambda: series_sum(scales))
    out["series fwd+grad"] = timed(lambda: fwd_grad(series_sum))
    print(f"cluster hot loop (G {HOT_G}, P {x.shape[0]}, bs {HOT_BS}, order {bench.CL_ORDER}, chunks "
          f"of {HOT_CHUNK}), ms: " + ", ".join(f"{k} {v:.3f}" for k, v in out.items()),
          flush=True)


# step 10b: config #5's full posterior (gigalens_tpu_torch.bench.ClusterRun,
# scripts/bench_cluster_posterior.py's run_pipeline) at full width (48 px, 20
# members, 128 MAP starts, 256 SVI draws, 50 chains) with its depths cut:
# the dpie arm from step 10's MAP starts through the FD Laplace, SVI and
# static-L HMC (chains, burn-in, results), the sie arm (lstsq source) from
# its own MAP through the same
CL_VI_N, CL_INIT_L = 256, 8
CL_DPIE_VI_STEPS, CL_DPIE_HMC = 100, (50, 80, 80)
CL_SIE_MAP_STEPS, CL_SIE_VI_STEPS, CL_SIE_HMC = 150, 50, (50, 50, 50)
CL_ACCEPT = (0.3, 1.0)  # the HMC acceptance (last 100 steps) must fall inside
CL_SVI_NEED = ("fused_builder_fwd_sum", "fused_builder_bwd", "direct_conv_fwd",
               "direct_conv_transpose")
CL_HMC_NEED = ("fused_builder_fwd_sum", "fused_builder_bwd")
BUILDER_BANNED = ("fused_builder_fwd_sum", "fused_builder_fwd_components", "fused_builder_bwd")


def cluster_posterior_phase(sc, z_map, t_map):
    """Step 10b: both arms of config #5 through bench.ClusterRun at full
    width, depths cut. dpie: step 10's MAP (``z_map``, its wall
    ``t_map``), the FD Laplace, SVI CL_VI_N x CL_DPIE_VI_STEPS and static-L
    HMC CL_DPIE_HMC; K5/K7 and the direct K4 both ways in SVI, K5/K7 and
    no K4 in HMC. sie (NIE members unfused, lstsq source, no positions): MAP
    128 x CL_SIE_MAP_STEPS (the direct K4 exactly once a step each way over
    15 x 128 component images), SVI CL_VI_N x CL_SIE_VI_STEPS, static-L HMC
    CL_SIE_HMC; no K1-K3 or K5-K7 anywhere, no K4 in HMC. Gates: finite
    samples, acceptance inside CL_ACCEPT, the last draw's pixel red-chi2
    inside CL_CHI2 (divergences, R-hat and ESS printed). Returns (launch
    counts by phase, a callable that checks K5/K7 and the direct K4 at the
    step's new shapes against their twins and returns the kernels rows)."""
    import torch

    from gigalens_tpu_torch import bench
    from gigalens_tpu_torch.ops.cuda import fused_builder as fb
    from gigalens_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    counts, runs = {}, {}

    def hook_for(kind):
        @contextlib.contextmanager
        def hook(name):
            torch.cuda.synchronize()
            reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            counts[f"cluster_{kind}_{name}"] = launch_counts()
            print(f"cluster {kind} {name}: {time.perf_counter() - t0:.2f} s, peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, launches "
                  f"{json.dumps(counts[f'cluster_{kind}_{name}'])} "
                  f"[{time.perf_counter() - t_phase:.1f} s into step 10b]", flush=True)
        return hook

    run = runs["dpie"] = bench.ClusterRun(sc, device=dev, hook=hook_for("dpie"))
    run.set_map(z_map, t_map)
    for bs, exact in ((CL_VI_N, False), (CL_DPIE_HMC[0], True)):
        sim = run.seq._sim(bs, exact=exact)
        spec = sim._fused_spec
        if not (sim._use_fused and spec is not None
                and fb.SERIES in [st.op for st in spec.stages]
                and (exact or direct_route(sim))):
            raise AssertionError(f"the dpie {'HMC' if exact else 'SVI'} simulator must take the "
                                 "builder tier with a series stage (and the direct K4 for SVI)")
    run.phase_svi(CL_VI_N, CL_DPIE_VI_STEPS)
    run.phase_hmc(*CL_DPIE_HMC, traj="static", init_l=CL_INIT_L, mass_windows=1, seed=3)
    run.phase_report()

    sie = bench.cluster_scene("sie", source="lstsq", device=dev)
    run_s = runs["sie"] = bench.ClusterRun(sie, device=dev, hook=hook_for("sie"))
    sim = run_s.seq._sim(CL_MAP_N)
    if sim._use_fused and (sim._fused_spec is not None or sim._fused_niter is not None):
        raise AssertionError("the sie arm's NIE members must render unfused")
    if not direct_route(sim):
        raise AssertionError("the sie MAP simulator must take the direct K4")
    run_s.phase_map(CL_MAP_N, CL_SIE_MAP_STEPS)
    run_s.phase_svi(CL_VI_N, CL_SIE_VI_STEPS)
    run_s.phase_hmc(*CL_SIE_HMC, traj="static", init_l=CL_INIT_L, mass_windows=1, seed=3)
    run_s.phase_report()

    for kind, r in runs.items():
        row = r.row
        print(f"cluster {kind} JSON: {json.dumps(row)}", flush=True)
        print(f"cluster {kind}: HMC {row['leapfrogs']} leapfrogs in {row['t_hmc']:.2f} s "
              f"({1e3 * row['t_hmc'] / max(row['leapfrogs'], 1):.3f} ms/leapfrog), accept "
              f"{row['accept']:.3f}, divergences {row['divergent_chain_steps']}, max split-R-hat "
              f"{row['max_rhat']:.4f}, min ESS {row['min_ess']:.1f}, posterior pixel red-chi2 "
              f"{row['posterior_red_chi2']:.4f}, theta_E* {row['theta_E_star']}", flush=True)
        if not torch.isfinite(r.samples).all():
            raise AssertionError(f"cluster {kind} HMC samples not finite")
        if not CL_ACCEPT[0] < row["accept"] < CL_ACCEPT[1]:
            raise AssertionError(f"cluster {kind} HMC acceptance {row['accept']} outside "
                                 f"{CL_ACCEPT}")
        if not CL_CHI2[0] <= row["posterior_red_chi2"] <= CL_CHI2[1]:
            raise AssertionError(f"cluster {kind} posterior red-chi2 "
                                 f"{row['posterior_red_chi2']} outside {CL_CHI2}")
    n = CL_SIE_MAP_STEPS
    check_launches("cluster dpie SVI", counts["cluster_dpie_svi"], CL_SVI_NEED,
                   BUILDER_ROUTE_BANNED + ("fused_builder_fwd_components", "dft_conv_fwd",
                                           "dft_conv_transpose"))
    check_launches("cluster dpie HMC", counts["cluster_dpie_hmc"], CL_HMC_NEED,
                   HMC_BANNED + BUILDER_ROUTE_BANNED + ("fused_builder_fwd_components",))
    check_launches("cluster sie MAP", counts["cluster_sie_map"],
                   banned=BUILDER_ROUTE_BANNED + BUILDER_BANNED + ("dft_conv_fwd",
                                                                   "dft_conv_transpose"),
                   exact=dict(direct_conv_fwd=n, direct_conv_transpose=n))
    check_launches("cluster sie SVI", counts["cluster_sie_svi"],
                   ("direct_conv_fwd", "direct_conv_transpose"),
                   BUILDER_ROUTE_BANNED + BUILDER_BANNED)
    check_launches("cluster sie HMC", counts["cluster_sie_hmc"], (),
                   HMC_BANNED + BUILDER_ROUTE_BANNED + BUILDER_BANNED)
    print(f"step 10b: config #5's full posterior, both arms, in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts, lambda: cluster_posterior_kernels(runs)


def cluster_posterior_kernels(runs):
    """Step 10b's kernels at their new shapes, against their twins, with
    the card to this process: K5/K7 at the dpie SVI's batch (CL_VI_N draws
    from its surrogate) and its HMC's (the chains' last states); the direct
    K4 both ways at the dpie SVI's (CL_VI_N, 96, 96) (K5's images) and at
    the sie MAP's (15 x 128, 96, 96) (the component images of its last
    states); first one profiled pass of a few HMC steps of each arm (host
    and device ms a leapfrog, idle share). Returns the kernels rows."""
    import torch

    from gigalens_tpu_torch.ops.cuda import fused_builder as fb

    dev = torch.device("cuda")
    for kind, r in runs.items():
        n_hmc = (CL_DPIE_HMC if kind == "dpie" else CL_SIE_HMC)[0]

        def stage(r=r, n_hmc=n_hmc):
            res = r.seq.HMC(r.q_z, n_hmc=n_hmc, num_burnin_steps=1, num_results=2,
                            trajectory_adaptation="static", init_l=CL_INIT_L, seed=PROFILE_SEED)
            return res.total_leapfrogs + 1

        profile_stage(f"cluster {kind} HMC", stage,
                      f"3 steps of static-L{CL_INIT_L} HMC, {n_hmc} chains from the surrogate")
    gen = torch.Generator(device=dev).manual_seed(14)
    run = runs["dpie"]
    prior = run.scene.prior
    kernels = []
    for phase, z, exact in (("cluster_dpie_svi", run.q_z.sample(gen, CL_VI_N), False),
                            ("cluster_dpie_hmc", run.samples[-1], True)):
        sim = run.seq._sim(z.shape[0], exact=exact)
        spec = sim._fused_spec
        params = spec.pack(prior.constrain(z)).contiguous()
        extras = spec.gather_extras(sim.img_x, sim.img_y)
        where = f"cluster dpie {phase.split('_')[2].upper()} bs={params.shape[0]}"
        kernels += builder_rows(spec, params, sim.img_x, sim.img_y, True, gen, phase, where,
                                extras, fwd_rel=CLUSTER_FWD_REL)
        if not exact:
            with torch.no_grad():
                flat = fb.fused_builder_fwd(spec, params, sim.img_x, sim.img_y, extras)
            conv = sim._conv
            xin = flat.reshape(-1, conv.h, conv.w).contiguous()
            ctc = torch.randn((xin.shape[0], conv.h // conv.pool, conv.w // conv.pool),
                              generator=gen, device=dev)
            rows, _ = direct_checks(conv, xin, ctc, where)
            kernels += [dict(r, phase=phase) for r in rows]
    run = runs["sie"]
    sim = run.seq._sim(CL_MAP_N)
    with torch.no_grad():
        comps = sim._flat_light(run.scene.prior.constrain(run.z_map), stack_components=True)
    conv = sim._conv
    xin = sim._place(comps).reshape(-1, conv.h, conv.w).contiguous()
    ctc = torch.randn((xin.shape[0], conv.h // conv.pool, conv.w // conv.pool), generator=gen,
                      device=dev)
    rows, _ = direct_checks(conv, xin, ctc, f"cluster sie lstsq MAP {xin.shape[0]} images")
    kernels += [dict(r, phase="cluster_sie_map") for r in rows]
    return kernels


# step 10c: the repairs of the port's last results that differed from the
# JAX package, on config #5's scenes at the JAX script's own truth
# (bench.CL_JAX_TRUTH): the sie arm's lstsq SVI
# (F-ref-7) at full width and depth after a MAP at step 10b's depth, and
# the dpie arm's MAP from the script's own 128 starts at full depth
CL_10C_VI_STEPS = 400
CL_10C_MAP_CHI2 = 1.10  # JAX: 1.065 from these starts; the port's own starts: 1.170


def cluster_repairs_phase():
    """Step 10c. sie (lstsq source, no positions) at the JAX truth: MAP
    CL_MAP_N x CL_SIE_MAP_STEPS, the FD Laplace at the best start, SVI
    CL_VI_N x CL_10C_VI_STEPS (the float64 solve and JAX's derivative of
    the pseudo-inverse, F-ref-7), gated on every loss finite, the last at
    or below the first, and CL_VI_N draws of the surrogate with finite
    log-densities; the direct K4 both ways in SVI. dpie at the JAX truth:
    MAP CL_MAP_N x CL_MAP_STEPS from bench.CL_JAX_STARTS
    (the K5/K7 and the direct K4 exactly once a step each), gated on best
    pixel red-chi2 <= CL_10C_MAP_CHI2. Returns the launch counts by
    phase."""
    import torch

    from gigalens_tpu_torch import bench
    from gigalens_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    counts = {}

    @contextlib.contextmanager
    def counted(name):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        counts[name] = launch_counts()
        print(f"step 10c {name}: {time.perf_counter() - t0:.2f} s, launches "
              f"{json.dumps(counts[name])}", flush=True)

    sie = bench.cluster_scene("sie", source="lstsq", device=dev, truth=bench.CL_JAX_TRUTH["sie"])
    run = bench.ClusterRun(sie, device=dev, hook=lambda name: counted(f"cluster_sie_jax_{name}"))
    run.phase_map(CL_MAP_N, CL_SIE_MAP_STEPS)
    run.phase_svi(CL_VI_N, CL_10C_VI_STEPS)
    z = run.q_z.sample(torch.Generator(device=dev).manual_seed(0), CL_VI_N)
    with torch.no_grad():
        lp = sie.prob.log_prob(run._sim(CL_VI_N), z)[0]
    losses = run.losses.cpu()
    n_fin = int(torch.isfinite(lp).sum())
    print(f"step 10c sie lstsq SVI at the JAX truth ({CL_VI_N} x {CL_10C_VI_STEPS}): losses "
          f"every 40 steps {[round(float(v), 2) for v in losses[::40]]}, last "
          f"{float(losses[-1]):.2f}; finite log-densities at {n_fin} of {CL_VI_N} draws",
          flush=True)
    if not torch.isfinite(losses).all():
        raise AssertionError("step 10c: the sie SVI's losses are not all finite")
    if not losses[-1] <= losses[0]:
        raise AssertionError(f"step 10c: the sie SVI's last loss {float(losses[-1])} is above "
                             f"its first {float(losses[0])}")
    if not (torch.isfinite(z).all() and n_fin == CL_VI_N):
        raise AssertionError("step 10c: the sie surrogate's draws are not all finite")
    check_launches("step 10c sie SVI", counts["cluster_sie_jax_svi"],
                   ("direct_conv_fwd", "direct_conv_transpose"),
                   BUILDER_ROUTE_BANNED + BUILDER_BANNED)

    dpie = bench.cluster_scene("dpie", device=dev, truth=bench.CL_JAX_TRUTH["dpie"])
    run = bench.ClusterRun(dpie, device=dev, hook=lambda name: counted(f"cluster_dpie_jax_{name}"))
    run.phase_map(steps=CL_MAP_STEPS, start=bench.cluster_jax_starts(dev))
    chi2 = run.row["map_red_chi2"]
    print(f"step 10c dpie MAP from the JAX script's starts ({CL_MAP_N} x {CL_MAP_STEPS}): best "
          f"pixel red-chi2 {chi2:.4f} in {run.row['t_map']:.2f} s (JAX: 1.065)", flush=True)
    n = CL_MAP_STEPS
    check_launches("step 10c dpie MAP", counts["cluster_dpie_jax_map"],
                   banned=BUILDER_ROUTE_BANNED + ("fused_builder_fwd_components", "dft_conv_fwd",
                                                  "dft_conv_transpose"),
                   exact=dict(fused_builder_fwd_sum=n, fused_builder_bwd=n, direct_conv_fwd=n,
                              direct_conv_transpose=n))
    if not chi2 <= CL_10C_MAP_CHI2:
        raise AssertionError(f"step 10c: the dpie MAP's best red-chi2 {chi2} > "
                             f"{CL_10C_MAP_CHI2}")
    print(f"step 10c: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts


# the survey phase: scripts/bench_survey_production.py's catalogue at full
# width (4 scenes, 60 px at 0.065", supersample 2, a PSF of its own a scene)
# through SurveySequence: MAP, Laplace, SVI, grouped HMC, a short SMC and a
# short lstsq MAP
SV_S, SV_PIX = 4, 60
SV_MAP_N, SV_MAP_STEPS = 64, 700
SV_VI_N, SV_VI_STEPS = 256, 400
# HMC: static L 16 with two mass windows (the script's --traj static). The
# bench recipe (ChEES from L 3, one window, 250 + 750) left scene 1 at max
# split-R-hat 1.055: its source's Ie / R / n banana mixes slowly (step size
# 0.06 against ~0.2 elsewhere), and at L 16 its R-hat reaches the gate only
# after ~1,250 results (1.070 at 375, 1.025 at 750, 1.019 at 1,250), as
# the JAX package's run of this catalogue needed long chains (BASELINE.md:460)
SV_HMC_N, SV_BURNIN, SV_RESULTS = 48, 250, 1250
SV_TRAJ, SV_INIT_L, SV_MASS_WINDOWS = "none", 16, 2
SV_PARTICLES, SV_SMC_L, SV_SMC_POST, SV_SMC_MAX_STAGE = 256, 3, 10, 200
SV_LSTSQ_STEPS = 50
# bench_survey_production.py:186-187: each scene's posterior-mean red-chi2
SV_CHI2 = (0.85, 1.15)


def survey_phase(quiet=None):
    """Survey mode at full width on the card: the catalogue of
    gigalens_tpu_torch.bench.survey_scene through SurveySequence. MAP (64
    starts a scene x 700 steps; K2/K3 and the direct K4 once a scene each
    way, counted exactly; every scene's best red-chi2 <= CHI2_GATE),
    Laplace (one FD batch of S * 2d rows), SVI (256 draws a scene x 400
    steps, counted the same way), grouped HMC (48 chains a scene, n_groups
    S, on torch.fft: K2/K3 and no K4; per scene posterior-mean red-chi2 in
    SV_CHI2, max split-R-hat <= RHAT_GATE, finite min-ESS), SMC from the MAP
    starts (256 particles a scene, L 3, 10 post steps; beta = 1 for every
    scene inside 200 stages, finite (S,) logZ, scene-major post rows; one
    stage profiled), a 50-step lstsq MAP with both lights linear
    (SurveyBackwardProbModel: K6/K7 exactly 50, the direct K4 4 x 50 each
    way) and its components under the per-scene PSFs held against S
    single-scene simulators (F-ref-6); then, after ``quiet()`` returns (the
    card is this process's alone from then on), the SMC stage profile, and
    K2/K3 at the MAP shape and the direct K4 at one scene's launch as
    kernel rows. Returns (kernels rows, launch counts by phase)."""
    import numpy as np
    import torch

    from gigalens_tpu_torch import PhysicalModel, bench
    from gigalens_tpu_torch.inference import SurveySequence
    from gigalens_tpu_torch.inference.sequence import map_optimizer, svi_optimizer
    from gigalens_tpu_torch.inference.smc import fit_smc
    from gigalens_tpu_torch.inference.survey import _SceneEnsembleAdapter
    from gigalens_tpu_torch.model import SurveyBackwardProbModel, SurveyForwardProbModel
    from gigalens_tpu_torch.ops.cuda import direct_conv as dcv
    from gigalens_tpu_torch.ops.cuda import fused_render as fr
    from gigalens_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from gigalens_tpu_torch.prob import Prior
    from gigalens_tpu_torch.profiles.light import SersicEllipse
    from gigalens_tpu_torch.simulator import LensSimulator
    from gigalens_tpu_torch.utils import effective_sample_size, potential_scale_reduction

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    S = SV_S
    prior, phys, cfg, obs = bench.survey_scene(S, SV_PIX, SUPERSAMPLE, dev)
    spm = SurveyForwardProbModel(prior, obs, background_rms=0.2, exp_time=100.0, device=dev)
    seq = SurveySequence(phys, spm, cfg, device=dev)
    d = prior.d
    counts, walls = {}, {}

    @contextlib.contextmanager
    def measured(name):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        counts[f"survey_{name}"] = launch_counts()

    def per_scene_convs(sim, what):
        conv = sim._conv
        if not (sim._use_fused and conv is not None and conv.mode == "dft"
                and conv.route == "direct" and conv.n_scenes == S
                and all(isinstance(c, dcv.DirectConv) for c in conv._scene_convs)):
            raise AssertionError(f"the survey {what} simulator must take the direct K4 once a "
                                 f"scene, got {getattr(conv, 'route', None)}")
        return conv

    def k4_exact(n):
        return dict(direct_conv_fwd=S * n, direct_conv_transpose=S * n, dft_conv_fwd=0,
                    dft_conv_transpose=0)

    # 1. MAP: 64 starts a scene
    conv = per_scene_convs(seq._sim(S * SV_MAP_N), "MAP")
    print(f"survey: {S} scenes, {SV_PIX} px at {bench.DELTA_PIX}\" supersample {SUPERSAMPLE} "
          f"({conv.h * conv.w} px a render), PSFs {tuple(cfg.kernel.shape)} -> supersampled "
          f"{tuple(conv.kernel.shape)}, K4 route {conv.route} for every scene", flush=True)
    with measured("map"):
        z_map = seq.MAP(map_optimizer(SV_MAP_STEPS), n_starts=SV_MAP_N, num_steps=SV_MAP_STEPS,
                        seed=0)
    best = seq.best_per_scene(z_map)
    with torch.no_grad():
        chi_best = spm.log_prob(seq._sim(S), best)[1]
    print(f"survey MAP: {SV_MAP_N} starts x {S} scenes x {SV_MAP_STEPS} steps in "
          f"{walls['map']:.2f} s ({1e3 * walls['map'] / SV_MAP_STEPS:.3f} ms/step, host clock); "
          f"best red-chi2 by scene {[round(float(c), 4) for c in chi_best]}; launches "
          f"{json.dumps(counts['survey_map'])}", flush=True)
    n = SV_MAP_STEPS
    check_launches("survey MAP", counts["survey_map"], exact=dict(
        fused_render_fwd_omega=n, fused_render_bwd=n, **k4_exact(n)))
    if not (torch.isfinite(z_map).all() and bool((chi_best <= CHI2_GATE).all())):
        raise AssertionError(f"survey MAP: best red-chi2 {chi_best.tolist()} > {CHI2_GATE} "
                             "or non-finite output")

    # 2. Laplace, then SVI: 256 draws a scene
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    L0 = seq.laplace_scale_trils(best)
    walls["laplace"] = time.perf_counter() - t0
    per_scene_convs(seq._sim(S * SV_VI_N), "SVI")
    with measured("svi"):
        means, trils, losses = seq.SVI(best, svi_optimizer(SV_VI_STEPS), n_vi=SV_VI_N,
                                       num_steps=SV_VI_STEPS, init_scales=L0, seed=1)
    print(f"survey Laplace: {S} x {2 * d} rows in {walls['laplace']:.2f} s; SVI {SV_VI_N} draws "
          f"x {S} scenes x {SV_VI_STEPS} steps in {walls['svi']:.2f} s "
          f"({1e3 * walls['svi'] / SV_VI_STEPS:.3f} ms/step); ELBO loss by scene "
          f"{[round(float(v), 2) for v in losses[0]]} -> "
          f"{[round(float(v), 2) for v in losses[-1]]}; launches "
          f"{json.dumps(counts['survey_svi'])}", flush=True)
    n = SV_VI_STEPS
    check_launches("survey SVI", counts["survey_svi"], exact=dict(
        fused_render_fwd_omega=n, fused_render_bwd=n, **k4_exact(n)))
    if not (np.isfinite(L0).all() and torch.isfinite(means).all()
            and torch.isfinite(trils).all() and tuple(losses.shape) == (n, S)):
        raise AssertionError("survey Laplace / SVI output not finite or of the wrong shape")

    # 3. grouped HMC on the exact path
    with measured("hmc"):
        res = seq.HMC(means, trils, n_hmc=SV_HMC_N, num_burnin_steps=SV_BURNIN,
                      num_results=SV_RESULTS, trajectory_adaptation=SV_TRAJ,
                      init_l=SV_INIT_L, mass_adaptation=SV_MASS_WINDOWS, seed=2)
    chains = res.samples.reshape(SV_RESULTS, S, SV_HMC_N, d)
    rhat = [float(potential_scale_reduction(chains[:, s]).max()) for s in range(S)]
    ess = [float(effective_sample_size(chains[:, s]).min()) for s in range(S)]
    with torch.no_grad():
        chi_post = spm.log_prob(seq._sim(S), seq.scene_samples(res).mean(1))[1]
    div = res.divergences.reshape(S, SV_HMC_N).sum(1)
    print(f"survey HMC: {SV_HMC_N} chains x {S} scenes, trajectory {SV_TRAJ} (L {SV_INIT_L}), "
          f"{SV_MASS_WINDOWS} mass windows, "
          f"{SV_BURNIN} + {SV_RESULTS} steps: {res.total_leapfrogs} leapfrogs in "
          f"{walls['hmc']:.2f} s = {1e3 * walls['hmc'] / max(res.total_leapfrogs, 1):.3f} "
          f"ms/leapfrog (host clock); step sizes {[round(float(e), 5) for e in res.step_size]}; "
          f"by scene: posterior-mean red-chi2 {[round(float(c), 4) for c in chi_post]}, max "
          f"split-R-hat {[round(r, 4) for r in rhat]}, min ESS {[round(e, 1) for e in ess]}, "
          f"divergences {div.tolist()}; launches {json.dumps(counts['survey_hmc'])}",
          flush=True)
    check_launches("survey HMC", counts["survey_hmc"], HMC_NEED, HMC_BANNED)
    if tuple(res.step_size.shape) != (S,) or not torch.isfinite(res.samples).all():
        raise AssertionError(f"survey HMC: step sizes {tuple(res.step_size.shape)} or samples "
                             "not finite")
    for s in range(S):
        if not (SV_CHI2[0] <= float(chi_post[s]) <= SV_CHI2[1] and rhat[s] <= RHAT_GATE
                and math.isfinite(ess[s])):
            raise AssertionError(f"survey HMC scene {s}: posterior red-chi2 {float(chi_post[s])} "
                                 f"outside {SV_CHI2}, max split-R-hat {rhat[s]} > {RHAT_GATE} "
                                 f"or min ESS {ess[s]} not finite")

    # 4. SMC from the MAP starts, one ensemble a scene
    with measured("smc"):
        sres = seq.SMC(start=z_map, num_particles=SV_PARTICLES, num_leapfrog_steps=SV_SMC_L,
                       post_sampling_steps=SV_SMC_POST, max_stage=SV_SMC_MAX_STAGE, seed=1)
    n_rows = S * SV_PARTICLES
    sim_smc = seq._sim(n_rows, exact=True)
    last = sres.post_samples[-1]
    with torch.no_grad():
        chi_own = spm.log_prob(sim_smc, last)[1].reshape(S, -1).mean(1)
        swapped = last.reshape(S, SV_PARTICLES, d).roll(1, dims=0).reshape(n_rows, d)
        chi_swap = spm.log_prob(sim_smc, swapped)[1].reshape(S, -1).roll(-1, dims=0).mean(1)
    leapfrogs = (sres.num_moves + SV_SMC_POST) * SV_SMC_L
    print(f"survey SMC: {SV_PARTICLES} particles x {S} scenes from the MAP starts, L "
          f"{SV_SMC_L}: {sres.num_stages} stages to beta {sres.final_beta.tolist()}, "
          f"{sres.num_moves} moves + {SV_SMC_POST} post steps = {leapfrogs} leapfrogs in "
          f"{walls['smc']:.2f} s (tempering {sres.tempering_s:.2f} s), "
          f"{1e3 * walls['smc'] / leapfrogs:.3f} ms/leapfrog; logZ {sres.log_evidence.tolist()}; "
          f"last post draw red-chi2 by scene {[round(float(c), 4) for c in chi_own]} (each "
          f"scene's rows against the next scene's data: "
          f"{[round(float(c), 1) for c in chi_swap]}); launches "
          f"{json.dumps(counts['survey_smc'])}", flush=True)
    check_launches("survey SMC", counts["survey_smc"], HMC_NEED, HMC_BANNED)
    if not (bool((sres.final_beta == 1.0).all()) and sres.num_stages < SV_SMC_MAX_STAGE):
        raise AssertionError(f"survey SMC did not reach beta = 1 for every scene inside "
                             f"{SV_SMC_MAX_STAGE} stages")
    if tuple(sres.log_evidence.shape) != (S,) or not torch.isfinite(sres.log_evidence).all():
        raise AssertionError(f"survey SMC logZ {sres.log_evidence.tolist()}")
    if (tuple(sres.post_samples.shape) != (SV_SMC_POST, n_rows, d)
            or not bool((chi_own < chi_swap).all())):
        raise AssertionError("survey SMC post samples are not scene-major (a scene's rows fit "
                             "another scene's data better than their own)")

    def stage():
        out = fit_smc(_SceneEnsembleAdapter(spm, SV_PARTICLES), sim_smc, start=sres.particles,
                      num_particles=SV_PARTICLES, num_ensembles=S,
                      num_leapfrog_steps=SV_SMC_L, post_sampling_steps=0, max_stage=1,
                      seed=PROFILE_SEED)
        return out.num_moves * SV_SMC_L + 1

    # 5. lstsq MAP: both lights linear (depth 2), K6/K7 and the direct K4
    tree = prior.tree
    prior_l = Prior(dict(lens_mass=tree["lens_mass"], **{
        k: [{n: v for n, v in tree[k][0].items() if n != "Ie"}]
        for k in ("lens_light", "source_light")}))
    phys_l = PhysicalModel(phys.lenses, [SersicEllipse(use_lstsq=True)],
                           [SersicEllipse(use_lstsq=True)])
    prob_l = SurveyBackwardProbModel(prior_l, obs, 0.2, 100.0, device=dev)
    seq_l = SurveySequence(phys_l, prob_l, cfg, device=dev)
    sim_l = seq_l._sim(S * SV_MAP_N)
    per_scene_convs(sim_l, "lstsq MAP")
    if sim_l._fused_spec is None or not sim_l._fused_spec.all_lstsq:
        raise AssertionError("the survey lstsq simulator must take the builder's components")
    with measured("lstsq"):
        z_l = seq_l.MAP(map_optimizer(SV_LSTSQ_STEPS), n_starts=SV_MAP_N,
                        num_steps=SV_LSTSQ_STEPS, seed=0)
    with torch.no_grad():
        chi_l = prob_l.log_prob(sim_l, z_l)[1].reshape(S, -1)
    print(f"survey lstsq MAP: {SV_MAP_N} x {S} x {SV_LSTSQ_STEPS} in {walls['lstsq']:.2f} s "
          f"({1e3 * walls['lstsq'] / SV_LSTSQ_STEPS:.3f} ms/step), {sim_l.depth} components, "
          f"best red-chi2 by scene "
          f"{[round(float(c), 4) for c in torch.nan_to_num(chi_l, nan=float('inf')).amin(1)]}; "
          f"launches {json.dumps(counts['survey_lstsq'])}", flush=True)
    n = SV_LSTSQ_STEPS
    check_launches("survey lstsq MAP", counts["survey_lstsq"], banned=("fused_builder_fwd_sum",),
                   exact=dict(fused_builder_fwd_components=n, fused_builder_bwd=n,
                              **k4_exact(n)))
    # F-ref-6 on the card: each row's components meet its own scene's PSF
    params_l = prior_l.constrain(z_l)
    ones = torch.ones((SV_PIX, SV_PIX), device=dev)
    with torch.no_grad():
        got = sim_l.lstsq_simulate(params_l, ones, ones, return_stacked=True)
        want = []
        for s in range(S):
            sim1 = LensSimulator(phys_l, dataclasses.replace(cfg, kernel=cfg.kernel[s]),
                                 bs=SV_MAP_N, device=dev)
            rows_s = slice(s * SV_MAP_N, (s + 1) * SV_MAP_N)
            part = {g: [{k: v[rows_s] for k, v in p.items()} for p in ps]
                    for g, ps in params_l.items()}
            want.append(sim1.lstsq_simulate(part, ones, ones, return_stacked=True))
        want = torch.cat(want)
    rel, _ = check_rel("survey lstsq components vs single-scene simulators", got, want,
                       RENDER_REL)
    print(f"survey lstsq: stacked components {tuple(got.shape)} against {S} single-scene "
          f"simulators: rel err {rel:.3e}", flush=True)

    # the card to this process from here: one SMC stage profiled, then
    # 6. K2/K3 at the MAP shape, the direct K4 at one scene's launch
    if quiet is not None:
        t0 = time.perf_counter()
        quiet()
        walls["quiet_wait"] = time.perf_counter() - t0
    profile_stage("survey SMC", stage)
    gen = torch.Generator(device=dev).manual_seed(13)
    sim_map = seq._sim(S * SV_MAP_N)
    params = fr.pack_params(prior.constrain(z_map)).contiguous()
    where = f"survey MAP bs={params.shape[0]}"
    kernels, out = render_rows(params, sim_map, gen, "survey_map", where)
    h, w = conv.h, conv.w
    xin = out.reshape(S, SV_MAP_N, h, w)[0].contiguous()
    ctc = torch.randn((SV_MAP_N, h // conv.pool, w // conv.pool), generator=gen, device=dev)
    rows, _ = direct_checks(conv, xin, ctc, f"survey one scene's launch bs={SV_MAP_N}")
    kernels += [dict(r, phase="survey_map") for r in rows]
    print(f"survey phase: {time.perf_counter() - t_phase:.1f} s; walls (s) "
          + ", ".join(f"{k} {v:.2f}" for k, v in walls.items()), flush=True)
    return kernels, counts


# the survey phase runs in a second process beside steps 6-10: every phase
# there is host-bound (the card idle 68-92% of their walls), so the two
# share the card's idle time. Each process's measurements (stage profiles,
# kernels rows, the hot loop) wait until the card is its own: the survey's
# until the main process has reached the end of step 10's sampling, the
# main process's until the survey process has ended. The walls of the
# sampling phases are taken beside the other process. The worker's limit:
SURVEY_TIMEOUT = 1000.0


def survey_worker(quiet, out_path):
    """survey_phase() in a spawned process: loads the kernels step 2 built,
    waits on the event ``quiet`` before its measurements, and saves its
    (kernels rows, launch counts) to ``out_path``."""
    sys.path.insert(0, str(ROOT))
    import torch

    from gigalens_tpu_torch.ops.cuda import _build

    _build.load()
    kernels, counts = survey_phase(quiet=quiet.wait)
    torch.save(dict(kernels=kernels, counts=counts), out_path)


class SideProcess:
    """``target(quiet, out_path)`` in a process of its own (start method
    spawn), started on entering; ``check()`` raises once it has failed,
    ``finish()`` lets it measure (sets ``quiet``), joins it within what is
    left of ``timeout`` and returns what it saved to ``out_path``. Leaving
    the block stops it if it still runs, so a failure on either side ends
    both."""

    def __init__(self, target, label, timeout):
        self.target, self.label, self.timeout = target, label, timeout

    def __enter__(self):
        import multiprocessing
        import tempfile

        ctx = multiprocessing.get_context("spawn")
        self.dir = tempfile.TemporaryDirectory(prefix=f"{self.label}_")
        self.out = str(Path(self.dir.name) / "out.pt")
        self.quiet = ctx.Event()
        self.proc = ctx.Process(target=self.target, args=(self.quiet, self.out))
        self.t0 = time.perf_counter()
        self.proc.start()
        print(f"{self.label} phase: started in a process of its own", flush=True)
        return self

    def check(self):
        if self.proc.exitcode not in (None, 0):
            raise AssertionError(f"the {self.label} process failed (exit code "
                                 f"{self.proc.exitcode})")

    def finish(self):
        import torch

        self.check()
        t_wait = time.perf_counter()
        self.quiet.set()
        self.proc.join(max(self.timeout - (time.perf_counter() - self.t0), 0.0))
        if self.proc.exitcode is None:
            raise AssertionError(f"the {self.label} process not done in {self.timeout} s")
        self.check()
        print(f"{self.label} phase: joined {time.perf_counter() - self.t0:.1f} s after its "
              f"start, {time.perf_counter() - t_wait:.1f} s after the main process's sampling",
              flush=True)
        return torch.load(self.out, weights_only=False)  # this script's own file

    def __exit__(self, *exc):
        if self.proc.is_alive():
            self.proc.kill()
        self.proc.join()
        self.dir.cleanup()
        return False


# the inversion phase (scripts/bench_inversion.py's scene, the data and
# joint MAP of examples/demo_inversion.py): 64 px at 0.05", supersample 2,
# the 9x9 Gaussian PSF, a 24 x 24 source grid of extent 0.4"
INV_PIX, INV_DELTA, INV_NSIDE, INV_EXTENT = 64, 0.05, 24, 0.4
INV_BKG, INV_EXP_TIME = 0.1, 1e3
INV_BS, INV_REPEATS = (1, 8, 32), 5
# the joint MAP: starts, stage 1 (parametric) and stage 2 (pixelated) steps
INV_STARTS, INV_STAGE1_STEPS, INV_STAGE2_STEPS = 32, 400, 200
# log_marginal against its float64 twin: the bounds of JAX's float64
# oracle test (tests/test_inversion.py)
INV_LM_RTOL, INV_LM_ATOL = 2e-4, 0.2
INV_TRUTH = dict(
    lens_mass=[dict(theta_E=0.85, e1=0.07, e2=-0.04, center_x=0.01, center_y=-0.02),
               dict(gamma1=0.02, gamma2=-0.01)],
    source_light=[dict(R_sersic=0.15, n_sersic=1.2, e1=0.15, e2=-0.05, center_x=0.06,
                       center_y=-0.04, Ie=10.0)])


def inversion_scene(dev):
    """The inversion scene on ``dev`` (a dict): the config, the lens prior
    groups, the pixelated prior, the observation as numpy, [SIE, Shear]
    with no source (``phys``) and with a SersicEllipse (``phys_param``). The
    truth (examples/demo_inversion.py:60-85: SIE + Shear, a Sersic source)
    is rendered by the port and observed with bkg 0.1 / exp_time 1e3 noise
    from a seeded generator; the pixelated prior is the demo's lens groups
    with lam ~ LogNormal(1, 1) (scripts/bench_inversion.py)."""
    import numpy as np
    import torch

    from gigalens_tpu_torch import PhysicalModel, SimulatorConfig
    from gigalens_tpu_torch.prob import Prior
    from gigalens_tpu_torch.prob import distributions as d
    from gigalens_tpu_torch.profiles.light import SersicEllipse
    from gigalens_tpu_torch.profiles.mass import SIE, Shear
    from gigalens_tpu_torch.simulator import LensSimulator

    k = np.exp(-((np.arange(9) - 4) ** 2 + (np.arange(9)[:, None] - 4) ** 2) / 4.0)
    cfg = SimulatorConfig(delta_pix=INV_DELTA, num_pix=INV_PIX, supersample=2,
                          kernel=(k / k.sum()).astype(np.float32))
    lens_groups = [
        dict(theta_E=d.LogNormal(math.log(0.8), 0.15), e1=d.Normal(0, 0.1),
             e2=d.Normal(0, 0.1), center_x=d.Normal(0, 0.05), center_y=d.Normal(0, 0.05)),
        dict(gamma1=d.Normal(0, 0.05), gamma2=d.Normal(0, 0.05))]
    prior = Prior(dict(lens_mass=lens_groups,
                       source_pixelated=[dict(lam=d.LogNormal(1.0, 1.0))]))
    truth = {g: [{k: torch.tensor([v], device=dev) for k, v in p.items()} for p in ps]
             for g, ps in INV_TRUTH.items()}
    sim = LensSimulator(PhysicalModel([SIE(), Shear()], [], [SersicEllipse()]), cfg, bs=1,
                        device=dev)
    with torch.no_grad():
        img = sim.simulate(truth)
    gen = torch.Generator(device=dev).manual_seed(0)
    noise = torch.randn(img.shape, generator=gen, device=dev)
    obs = img + noise * torch.sqrt(INV_BKG**2 + torch.clamp(img, min=0.0) / INV_EXP_TIME)
    if obs.shape != (INV_PIX, INV_PIX) or not torch.isfinite(obs).all():
        raise AssertionError(f"bad inversion observation: shape {tuple(obs.shape)}")
    return dict(cfg=cfg, lens_groups=lens_groups, prior=prior, obs=obs.cpu().numpy(),
                phys=PhysicalModel([SIE(), Shear()], [], []),
                phys_param=PhysicalModel([SIE(), Shear()], [], [SersicEllipse()]))


def plain64(model, sim):
    """The same evaluation in float64 on the card: copies of ``model`` and
    ``sim`` whose data, coordinates and mask are float64 and whose PSF conv
    is K4's plain version (the explicit tap sums) in float64; the Gram,
    Cholesky and solve then run in float64 through the model's own code."""
    import copy

    from gigalens_tpu_torch.ops.cuda import direct_conv as dcv

    d = sim._conv._direct

    class Plain:
        pool = d.pool

        def __call__(self, img, scene_axis=0):
            x = img.reshape(-1, d.h, d.w).double()
            out = dcv.direct_conv_reference(x, d.w_ref.double(), d.pool, d.oy, d.ox)
            return out.reshape(*img.shape[:-2], d.out_h, d.out_w)

    sim64 = copy.copy(sim)
    sim64._conv = Plain()
    for k in ("img_x", "img_y", "img_region"):
        setattr(sim64, k, getattr(sim, k).double())
    model64 = copy.copy(model)
    for k in ("observed_image", "error_map", "H_reg"):
        setattr(model64, k, getattr(model, k).double())
    return model64, sim64


def inversion_phase():
    """Pixelated-source inversion on the card. Micro: log_prob forward and
    forward + gradient at bs 1, 8 and 32, timed by the port's
    utils.profiling.timed, with the chunk size, the direct K4 launches of
    one call counted exactly (one forward a chunk, and with the gradient
    one transposed a chunk: the checkpoint's recompute stops before the
    conv) and peak memory; one torch.profiler pass at bs 32 for the
    device time by part and the idle share. log_marginal at bs 8 against
    its float64 twin (plain64); the direct K4 at one chunk's launch of the
    bs-32 evaluation, both ways, as kernel rows. Then the joint MAP of
    examples/demo_inversion.py: stage 1 parametric (SersicEllipse source;
    K2/K3 and the direct K4 once a step each way), stage 2 pixelated from
    stage 1's best plus jitter (the direct K4 counted exactly) through
    PipelineCheckpointer.run_map, rerun from its file (no launches, the
    same best log_prob), gated on the best joint red-chi2 <= CHI2_GATE.
    Returns (kernel rows, {"inversion": the bs-32 forward + gradient
    launch counts})."""
    import tempfile

    import torch

    from gigalens_tpu_torch.inference import ModellingSequence, optim
    from gigalens_tpu_torch.inference.map import fit_map
    from gigalens_tpu_torch.inversion import PixelatedSourceProbModel, SourceGrid
    from gigalens_tpu_torch.model import ForwardProbModel
    from gigalens_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from gigalens_tpu_torch.prob import Prior
    from gigalens_tpu_torch.prob import distributions as d
    from gigalens_tpu_torch.simulator import LensSimulator
    from gigalens_tpu_torch.utils import PipelineCheckpointer, timed, trace

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    sc = inversion_scene(dev)
    cfg, prior, phys, obs = sc["cfg"], sc["prior"], sc["phys"], sc["obs"]
    model = PixelatedSourceProbModel(prior, obs, background_rms=INV_BKG, exp_time=INV_EXP_TIME,
                                     grid=SourceGrid(INV_NSIDE, INV_EXTENT), lam=None,
                                     device=dev)
    gen = torch.Generator(device=dev).manual_seed(21)

    def counted(fn):
        torch.cuda.synchronize()
        reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        return launch_counts()

    # 1. micro
    sims, calls, fg32 = {}, {}, None
    for bs in INV_BS:
        sim = sims[bs] = LensSimulator(phys, cfg, bs=bs, device=dev)
        conv = sim._conv
        if not direct_route(sim):
            raise AssertionError(f"the inversion simulator must take the direct K4, got route "
                                 f"{getattr(conv, 'route', None)}")
        z = prior.unconstrain(prior.sample(gen, bs))

        def fwd(sim=sim, z=z):
            with torch.no_grad():
                return model.log_prob(sim, z)[0]

        def fwd_grad(sim=sim, z=z):
            zz = z.detach().requires_grad_(True)
            return torch.autograd.grad(model.log_prob(sim, zz)[0].sum(), zz)[0]

        m = model.chunk_rows(sim)
        chunks = INV_NSIDE // m
        # the gradient's checkpoint recomputes a chunk only up to the conv's
        # input: one forward launch a chunk either way
        for name, fn, exact in (("fwd", fwd, dict(direct_conv_fwd=chunks,
                                                  direct_conv_transpose=0)),
                                ("fwd+grad", fwd_grad, dict(direct_conv_fwd=chunks,
                                                            direct_conv_transpose=chunks))):
            out = fn()
            if not torch.isfinite(out).all():
                raise AssertionError(f"inversion {name} at bs {bs}: non-finite output")
            counts = counted(fn)
            check_launches(f"inversion {name} bs {bs}", counts, banned=(
                "dft_conv_fwd", "dft_conv_transpose", "fused_render_fwd", "fused_render_bwd",
                "fused_render_fwd_omega"), exact=exact)
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            secs, _ = timed(fn, warmup=1, repeats=INV_REPEATS)
            calls[(bs, name)] = secs
            if bs == INV_BS[-1] and name == "fwd+grad":
                fg32 = (fn, counts, m)
            print(f"inversion micro bs={bs} {name}: {1e3 * secs:.3f} ms a call, "
                  f"{1e3 * secs / bs:.3f} ms a sample (timed, {INV_REPEATS} calls after 1); "
                  f"chunk {m} source rows = {m * INV_NSIDE} basis images, {chunks} chunks, "
                  f"{m * INV_NSIDE * bs} images a K4 launch; K4 launches a call "
                  f"{counts['direct_conv_fwd']} forward, {counts['direct_conv_transpose']} "
                  f"transposed; peak device memory {peak / 2**30:.3f} GiB", flush=True)

    # one profiled pass of forward + gradient at bs 32
    fn, counts32, m32 = fg32
    reps = 3
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp) as prof:
            for _ in range(reps):
                fn()
        trace_mb = Path(tmp, "trace.json").stat().st_size / 2**20
    groups = {"K4 forward": ("direct_conv_fwd",), "K4 transpose": ("direct_conv_transpose",),
              "Gram + backward (cuBLAS)": ("inversion.gram", "inversion.gram_backward"),
              "Cholesky, solve + backward": ("inversion.cholesky",
                                             "inversion.cholesky_backward"),
              "everything else": ("",)}
    by_range = kernel_us_by_range(prof, [r for g in groups.values() for r in g if r])
    split = {k: sum(by_range[r] for r in rs) / 1e3 / reps for k, rs in groups.items()}
    busy = sum(split.values())
    rows_busy = sum(r[0] for r in device_rows(prof)) / 1e3 / reps
    wall = 1e3 * calls[(INV_BS[-1], "fwd+grad")]
    print(f"inversion profile (bs={INV_BS[-1]} forward + gradient, {reps} calls; Chrome trace "
          f"{trace_mb:.1f} MiB): device busy {busy:.3f} ms a call (all kernels {rows_busy:.3f}) "
          f"of {wall:.3f} ms unprofiled = idle {100 * (1 - busy / wall):.1f}%; kernel ms a call "
          f"by range: " + ", ".join(f"{k} {v:.3f}" for k, v in split.items()), flush=True)
    for us, count, key in device_rows(prof)[:8]:
        print(f"  {us / 1e3 / reps:8.3f}  {count / reps:6.1f}  {key[:100]}", flush=True)
    if busy <= 0 or min(split["K4 forward"], split["K4 transpose"]) <= 0:
        raise AssertionError("torch.profiler saw no device time in the inversion K4 ranges")

    # 2. log_marginal at bs 8 against its float64 twin
    sim8 = sims[8]
    z8 = prior.unconstrain(prior.sample(gen, 8))
    with torch.no_grad():
        x = prior.constrain(z8)
        got = model.solve(sim8, x)["log_marginal"]
        model64, sim64 = plain64(model, sim8)
        x64 = {g: [{k: v.double() for k, v in p.items()} for p in ps] for g, ps in x.items()}
        want = model64.solve(sim64, x64)["log_marginal"]
    err = check_close("inversion log_marginal vs float64 twin (bs 8)", got, want, INV_LM_RTOL,
                      INV_LM_ATOL)
    print(f"inversion log_marginal (bs 8) vs float64 twin: max |err| {err:.4e} nats of "
          f"|log_marginal| up to {float(want.abs().max()):.2f} (rtol {INV_LM_RTOL}, atol "
          f"{INV_LM_ATOL})", flush=True)

    # the direct K4 at one chunk's launch of the bs-32 evaluation: the
    # chunk's placed basis images and a random cotangent
    sim32 = sims[INV_BS[-1]]
    conv = sim32._conv
    with torch.no_grad():
        bx, by = sim32.beta(sim32.img_x, sim32.img_y, prior.constrain(
            prior.unconstrain(prior.sample(gen, INV_BS[-1])))["lens_mass"])
        cx = torch.as_tensor(model.grid.centers_x, device=dev)
        cy = torch.as_tensor(model.grid.centers_y, device=dev)
        inv_d = 1.0 / model.grid.delta
        wx = torch.clamp(1.0 - torch.abs(bx[..., None] - cx) * inv_d, min=0.0)
        wy = torch.clamp(1.0 - torch.abs(by[..., None] - cy) * inv_d, min=0.0)
        A = (wy[..., :m32, None] * wx[..., None, :]).reshape(INV_BS[-1], -1, m32 * INV_NSIDE)
        xin = A.movedim(-1, 0).reshape(-1, conv.h, conv.w).contiguous()
    ctc = torch.randn((xin.shape[0], conv.out_h, conv.out_w), generator=gen, device=dev)
    where = f"inversion bs={INV_BS[-1]} {tuple(xin.shape)}"
    rows, _ = direct_checks(conv, xin, ctc, where)
    kernels = [dict(r, phase="inversion") for r in rows]
    del A, xin, ctc

    # 3. the joint MAP of examples/demo_inversion.py
    prior1 = Prior(dict(lens_mass=sc["lens_groups"], source_light=[dict(
        R_sersic=d.LogNormal(math.log(0.15), 0.3), n_sersic=d.Uniform(0.5, 4),
        e1=d.TruncatedNormal(0, 0.15, -0.5, 0.5), e2=d.TruncatedNormal(0, 0.15, -0.5, 0.5),
        center_x=d.Normal(0, 0.15), center_y=d.Normal(0, 0.15),
        Ie=d.LogNormal(math.log(10.0), 0.5))]))
    seq1 = ModellingSequence(sc["phys_param"], ForwardProbModel(prior1, obs, background_rms=INV_BKG,
                                                     exp_time=INV_EXP_TIME, device=dev),
                             cfg, device=dev)

    def demo_opt(lr0, lr1, steps):
        return optim.chain(optim.scale_by_adam(), optim.scale_by_schedule(
            optim.polynomial_schedule(-lr0, -lr1, 0.5, steps)))

    n1, n2 = INV_STAGE1_STEPS, INV_STAGE2_STEPS
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    z1 = seq1.MAP(demo_opt(1e-2, 3e-3, n1), n_samples=INV_STARTS, num_steps=n1, seed=0)
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    counts1 = launch_counts()
    check_launches("inversion stage 1 MAP", counts1, exact=dict(
        fused_render_fwd_omega=n1, fused_render_bwd=n1, direct_conv_fwd=n1,
        direct_conv_transpose=n1))
    z1_best = seq1.best_map_start(z1)
    with torch.no_grad():
        chi1 = float(seq1.prob_model.log_prob(seq1._sim(1), z1_best)[1][0])
        theta1 = float(prior1.constrain(z1_best)["lens_mass"][0]["theta_E"][0])
    print(f"inversion stage 1 (parametric Sersic source): {INV_STARTS} starts x {n1} steps in "
          f"{wall1:.2f} s ({1e3 * wall1 / n1:.3f} ms/step, host clock); best red-chi2 "
          f"{chi1:.4f}, theta_E {theta1:.4f} (truth 0.85); launches {json.dumps(counts1)}",
          flush=True)

    # stage 2: every start at stage 1's lens (the lens columns lead both
    # priors) plus jitter, lam from 3.0 plus jitter
    d_lens = z1_best.shape[1] - len(prior1.tree["source_light"][0])
    lam_z0 = float(prior.tree["source_pixelated"][0]["lam"].bijector.inverse(
        torch.tensor(3.0)))
    z0 = torch.cat([z1_best[:, :d_lens] + 0.03 * torch.randn(
        (INV_STARTS, d_lens), generator=gen, device=dev),
        lam_z0 + 0.3 * torch.randn((INV_STARTS, 1), generator=gen, device=dev)], dim=1)
    seq2 = ModellingSequence(phys, model, cfg, device=dev)
    sim2 = seq2._sim(INV_STARTS)
    if not direct_route(sim2) or model.chunk_rows(sim2) != m32:
        raise AssertionError("the stage-2 simulator must take the direct K4 at the micro's chunk")

    def never():
        raise AssertionError("the saved stage-2 MAP ran again")

    with tempfile.TemporaryDirectory() as tmp:
        ck = PipelineCheckpointer(tmp, device=dev)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        z2, hist2 = ck.run_map(lambda: fit_map(model, sim2, demo_opt(3e-3, 1e-3, n2), start=z0,
                                               n_samples=INV_STARTS, num_steps=n2))
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
        counts2 = launch_counts()
        reset_launch_counts()
        z2b, hist2b = ck.run_map(never)
        counts_reload = launch_counts()
    per_call = dict(direct_conv_fwd=counts32["direct_conv_fwd"],
                    direct_conv_transpose=counts32["direct_conv_transpose"])
    check_launches("inversion stage 2 MAP", counts2, banned=("fused_render_fwd_omega",),
                   exact={k: n2 * v for k, v in per_call.items()})
    if any(counts_reload.values()):
        raise AssertionError(f"the stage-2 MAP reload launched kernels: {counts_reload}")
    with torch.no_grad():
        lp, chi = model.log_prob(sim2, z2)
        lpb, _ = model.log_prob(sim2, z2b)
    lp = torch.where(torch.isnan(lp), -torch.inf, lp)
    lpb = torch.where(torch.isnan(lpb), -torch.inf, lpb)
    best = int(torch.argmax(lp))
    if not (torch.equal(z2, z2b) and torch.equal(hist2, hist2b)
            and float(lpb.max()) == float(lp.max())):
        raise AssertionError(f"the reloaded stage-2 MAP differs: best log_prob "
                             f"{float(lp.max())} -> {float(lpb.max())}")
    chi_best = float(chi[best])
    x = prior.constrain(z2[best][None])
    fit = {k: float(v[0]) for k, v in x["lens_mass"][0].items()}
    lam_fit = float(x["source_pixelated"][0]["lam"][0])
    print(f"inversion stage 2 (joint pixelated MAP, lens + lam): {INV_STARTS} starts x {n2} "
          f"steps in {wall2:.2f} s ({1e3 * wall2 / n2:.3f} ms/step, host clock); min red-chi2 "
          f"step 1 {float(hist2[0]):.4f} -> best {chi_best:.4f}; theta_E {fit['theta_E']:.4f} "
          f"(truth 0.85), e1 {fit['e1']:+.4f} (0.07), e2 {fit['e2']:+.4f} (-0.04), lam "
          f"{lam_fit:.3f}; K4 launches {counts2['direct_conv_fwd']} forward, "
          f"{counts2['direct_conv_transpose']} transposed ({n2} x {per_call}); reloaded "
          f"through PipelineCheckpointer: no launches, the same z and best log_prob "
          f"{float(lp.max()):.4f}", flush=True)
    if not chi_best <= CHI2_GATE:
        raise AssertionError(f"inversion joint MAP: best red-chi2 {chi_best} > {CHI2_GATE}")
    print(f"inversion phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return kernels, {"inversion": counts32}


# the mesh phase: the bench scene through ModellingSequence(mesh=...) at the
# pipeline's widths with short step counts (a parity phase, no gate on
# convergence): MAP starts x steps, SVI draws x steps, HMC chains x
# (burn-in + results), SMC particles x stages (3 leapfrogs a move, 2 post
# steps); the whole phase's time limit
MESH_MAP, MESH_VI, MESH_HMC, MESH_SMC = (500, 50), (1000, 20), (50, 20, 20), (1000, 3)
# the few-rows configuration: MAP starts, HMC chains and SMC particles in all
# (12 rows a rank on two ranks; the card's per-row pixel sums round by the
# rows a call holds below 16)
MESH_FEW = 24
MESH_TIMEOUT = 150.0
# tests/test_sharding.py's tolerances: (rtol, atol) per compared result
MESH_TOL = dict(map=(1e-4, 1e-5), best=(1e-4, 1e-5), losses=(1e-4, 1e-2), mean=(1e-4, 1e-5),
                scale_tril=(1e-3, 1e-5), hmc=(1e-4, 1e-4), final_beta=(1e-5, 1e-6),
                particles=(5e-3, 5e-3))
MESH_NEED = dict(map=(MAP_SVI_NEED, ()), svi=(MAP_SVI_NEED, ()), hmc=(HMC_NEED, HMC_BANNED),
                 smc=(HMC_NEED, HMC_BANNED))


def busy_share(prof, wall_s):
    """The share of ``wall_s`` in which this process had a kernel running
    on the card: the union of the kernels' intervals in a
    ``torch.profiler`` window (CUDA activity only) over the wall, read from
    the raw trace events (building the profiler's event tree for some
    10^5 kernels would take longer than the phases)."""
    from torch.autograd import DeviceType

    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA and not e.is_user_annotation())
    busy, end = 0, -math.inf
    for t0, t1 in spans:
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    return busy * 1e-9 / wall_s


def mesh_run(mesh, obs, n_hmc=MESH_HMC[0], q_ref=None, rows=None):
    """One rank's (or, with ``mesh=None``, the in-process) run of the mesh
    phase on the bench scene's observation ``obs``: MAP from prior draws
    and best_map_start, the FD Laplace factor, SVI, ChEES HMC (``n_hmc``
    chains) from the surrogate ``q_ref`` ((loc, scale_tril): the in-process
    run's, since SVI's all-reduce rounds differently from one process and
    each phase is held to one process's from the same inputs; None: its own
    SVI's), SMC from the prior. ``rows``: MAP starts, HMC chains and SMC
    particles all ``rows``, and no Laplace or SVI (HMC from ``q_ref``). Each
    phase runs
    between launch-counter resets under torch.profiler (CUDA activity
    only); returns the global results, and per phase the launch counts, the
    wall (host clock, the card synchronized) and the busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gigalens_tpu_torch import bench
    from gigalens_tpu_torch.inference import ModellingSequence
    from gigalens_tpu_torch.inference.sequence import map_optimizer, svi_optimizer
    from gigalens_tpu_torch.model import ForwardProbModel
    from gigalens_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from gigalens_tpu_torch.prob.distributions import MultivariateNormalTriL

    t_enter = time.time()
    dev = torch.device("cuda", 0) if mesh is None else mesh.device
    phys, cfg, _ = bench.bench_scene(NUM_PIX)
    prob = ForwardProbModel(bench.bench_prior(), obs, background_rms=bench.BKG,
                            exp_time=bench.EXP_TIME, device=dev)
    seq = ModellingSequence(phys, prob, cfg, mesh=mesh, device=dev)
    rec = {}

    @contextlib.contextmanager
    def phase(name):
        torch.cuda.synchronize(dev)
        reset_launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            yield
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
        rec[name] = dict(counts=launch_counts(), wall=wall, busy=busy_share(prof, wall))

    (n, steps), (n_vi, vi_steps), (particles, stages) = MESH_MAP, MESH_VI, MESH_SMC
    if rows is not None:
        n = n_hmc = particles = rows
    with phase("map"):
        z = seq.MAP(map_optimizer(steps), n_samples=n, num_steps=steps, seed=0)
        best = seq.best_map_start(z)
    out = dict(map=z, best=best)
    if rows is None:
        L0 = seq.laplace_scale_tril(best)
        with phase("svi"):
            q, losses = seq.SVI(best, svi_optimizer(vi_steps), n_vi=n_vi, num_steps=vi_steps,
                                init_scales=L0, seed=1)
        out.update(losses=losses, mean=q.mean(), scale_tril=q.scale_tril)
    _, burnin, results = MESH_HMC
    q_hmc = q if q_ref is None else MultivariateNormalTriL(*(t.to(dev) for t in q_ref))
    with phase("hmc"):
        res = seq.HMC(q_hmc, n_hmc=n_hmc, num_burnin_steps=burnin, num_results=results, seed=2)
    with phase("smc"):
        smc = seq.SMC(num_particles=particles, num_leapfrog_steps=3, post_sampling_steps=2,
                      ess_threshold_ratio=0.6, max_stage=stages, seed=1)
    out.update(hmc=res.samples, final_beta=smc.final_beta, particles=smc.particles,
               stages=smc.num_stages, leapfrogs=res.total_leapfrogs)
    return dict(rec=rec, t_enter=t_enter, out={k: v.cpu() if isinstance(v, torch.Tensor) else v
                                               for k, v in out.items()})


# (e): the models below one process's per-row rounding at 1 row a rank:
# the pixelated-source model (the inversion scene) and config #5's sie arm
# (lstsq source, torch-seeded truth): log_prob and its z-gradient at
# prior draws, then MAP steps from them; held to one process at
# tests/test_inversion.py:240-257's tolerances, the largest difference
# printed (0.0: bitwise)
MESH_ROWS_MAP_STEPS = 3
MESH_ROWS_TOL = (1e-4, 1e-5)


def mesh_rows(mesh):
    """(e)'s results on one rank (1 row of 2) or, with ``mesh=None``, in
    this process (2 rows): per model, log_prob, its z-gradient and the MAP
    after MESH_ROWS_MAP_STEPS steps, at the 2 global rows (the ranks'
    gathered)."""
    import torch

    from gigalens_tpu_torch import bench
    from gigalens_tpu_torch.inference import ModellingSequence
    from gigalens_tpu_torch.inference.sequence import map_optimizer
    from gigalens_tpu_torch.inversion import PixelatedSourceProbModel, SourceGrid
    from gigalens_tpu_torch.parallel import mesh as pmesh
    from gigalens_tpu_torch.simulator import LensSimulator

    dev = torch.device("cuda", 0) if mesh is None else mesh.device
    inv = inversion_scene(dev)
    inv_model = PixelatedSourceProbModel(inv["prior"], inv["obs"], background_rms=INV_BKG,
                                         exp_time=INV_EXP_TIME,
                                         grid=SourceGrid(INV_NSIDE, INV_EXTENT), lam=None,
                                         device=dev)
    sie = bench.cluster_scene("sie", source="lstsq", device=dev)
    out = {}
    for name, phys, cfg, model in (("inversion", inv["phys"], inv["cfg"], inv_model),
                                   ("sie_lstsq", sie.phys, sie.cfg, sie.prob)):
        prior = model.prior
        z = prior.unconstrain(prior.sample(torch.Generator(device=dev).manual_seed(3), 2))
        rows = pmesh.shard_samples(z, mesh).clone().requires_grad_(True)
        sim = LensSimulator(phys, cfg, bs=rows.shape[0], device=dev, mesh=mesh)
        lp = model.log_prob(sim, rows)[0]
        (g,) = torch.autograd.grad(lp.sum(), rows)
        seq = ModellingSequence(phys, model, cfg, mesh=mesh, device=dev)
        z_map = seq.MAP(map_optimizer(MESH_ROWS_MAP_STEPS), start=z, n_samples=2,
                        num_steps=MESH_ROWS_MAP_STEPS)
        out[name] = dict(log_prob=pmesh.gather_samples(lp.detach(), mesh).cpu(),
                         grad=pmesh.gather_samples(g, mesh).cpu(), map=z_map.cpu())
    return out


def mesh_rows_report(ref, ranks):
    """(e): every rank's results equal rank 0's bitwise, and rank 0's the
    in-process run's within MESH_ROWS_TOL; returns the largest difference
    by model and result."""
    import torch

    errs = {}
    for model, want in ref.items():
        for k, v in want.items():
            for r, res in enumerate(ranks[1:], 1):
                if not torch.equal(res[model][k], ranks[0][model][k]):
                    raise AssertionError(f"mesh (e) {model}: rank {r}'s {k} is not rank 0's")
            errs[f"{model} {k}"] = check_close(f"mesh (e) {model} {k}", ranks[0][model][k], v,
                                               *MESH_ROWS_TOL)
    print(f"mesh (e) 2 gloo ranks, 1 row a rank: max |err| vs the in-process run "
          f"{json.dumps(errs)}", flush=True)
    return errs


def mesh_observation():
    """The bench scene's observation of the pipeline phase (truth seeded 42,
    noise seeded 1), rendered on cuda:0, as numpy."""
    import torch

    from gigalens_tpu_torch import bench
    from gigalens_tpu_torch.simulator import LensSimulator

    dev = torch.device("cuda", 0)
    phys, cfg, _ = bench.bench_scene(NUM_PIX)
    truth = bench.bench_prior().sample(torch.Generator(device=dev).manual_seed(42), 1)
    with torch.no_grad():
        img = LensSimulator(phys, cfg, bs=1, device=dev).simulate(truth)
    return bench.observe(img, torch.Generator(device=dev).manual_seed(1)).cpu().numpy()


def mesh_report(label, ranks, ref, t_start, card):
    """Checks one configuration's mesh_run results ``ranks`` (one a rank)
    against the in-process ``ref`` at MESH_TOL (SMC stages and HMC
    leapfrogs exactly), every rank's results against rank 0's bitwise and
    every rank's launch counters by MESH_NEED; prints each rank's start-up
    (from ``t_start``, wall clock), walls and busy shares; returns the
    configuration's summary."""
    import torch

    for r, res in enumerate(ranks):
        for name, (need, banned) in MESH_NEED.items():
            if name in res["rec"]:
                check_launches(f"mesh {label} rank {r} {name}", res["rec"][name]["counts"],
                               need, banned)
        if r > 0:
            for k, v in res["out"].items():
                if (not torch.equal(v, ranks[0]["out"][k]) if isinstance(v, torch.Tensor)
                        else v != ranks[0]["out"][k]):
                    raise AssertionError(f"mesh {label}: rank {r}'s {k} is not rank 0's")
    got = ranks[0]["out"]
    errs = {k: check_close(f"mesh {label} {k}", got[k], ref[k], *tol)
            for k, tol in MESH_TOL.items() if k in ref}
    if got["stages"] != ref["stages"] or got["leapfrogs"] != ref["leapfrogs"]:
        raise AssertionError(f"mesh {label}: SMC stages / HMC leapfrogs "
                             f"{got['stages']} / {got['leapfrogs']}, in-process "
                             f"{ref['stages']} / {ref['leapfrogs']}")
    rows = [{name: dict(wall_s=round(p["wall"], 3), busy=round(p["busy"], 4),
                        launches={k: n for k, n in p["counts"].items() if n})
             for name, p in res["rec"].items()} for res in ranks]
    startup = [round(res["t_enter"] - t_start, 1) for res in ranks]
    for r, row in enumerate(rows):
        print(f"mesh {label} rank {r}: started in {startup[r]} s; " + ", ".join(
            f"{name} {p['wall_s']:.3f} s busy {100 * p['busy']:.1f}%"
            for name, p in row.items()) + f" ({card})", flush=True)
    print(f"mesh {label}: max |err| vs the in-process run {json.dumps(errs)}", flush=True)
    return dict(ranks=rows, startup_s=startup, max_abs_err=errs)


def mesh_phase(card):
    """Sample sharding over a mesh (gigalens_tpu_torch.parallel) on the
    card: mesh_run on mesh_observation() -- (a) in this process with
    mesh=None, (b) one nccl rank, (c) two gloo ranks sharing cuda:0 (nccl
    refuses two ranks on one card); (a') in this process and (d) two gloo
    ranks at MESH_FEW rows (12 a rank: MAP, HMC and SMC) -- the ranks
    spawned by parallel.spawn_ranks (start method spawn, a file
    rendezvous) after step 2's build, so they only load the kernels, (b),
    (c) and (d) side by side; (b) and (c) checked against (a), (d) against
    (a') by mesh_report, HMC from (a)'s surrogate. A hang, a rank's failure
    or the phase outlasting MESH_TIMEOUT raises after the ranks are
    stopped. The walls and busy shares printed are five ranks sharing one
    card: not a scaling number."""
    from gigalens_tpu_torch.parallel import spawn_ranks

    t_phase = time.perf_counter()
    obs = mesh_observation()

    def left():
        """Seconds of the phase's limit left for the next spawn."""
        s = MESH_TIMEOUT - (time.perf_counter() - t_phase)
        if s <= 0:
            raise AssertionError(f"mesh phase over its {MESH_TIMEOUT} s")
        return s

    t0 = time.time()
    one = mesh_run(None, obs)
    ref = one["out"]
    summary = {"(a) in-process": mesh_report("(a) in-process", [one], ref, t0, card)}
    q_ref = (ref["mean"], ref["scale_tril"])
    few_label = f"(a') in-process, {MESH_FEW} rows"
    t0 = time.time()
    few = mesh_run(None, obs, MESH_FEW, q_ref, MESH_FEW)
    summary[few_label] = mesh_report(few_label, [few], few["out"], t0, card)
    rows_ref = mesh_rows(None)
    print(f"mesh (a), (a'), (e) in-process: done {time.perf_counter() - t_phase:.1f} s into "
          "the phase", flush=True)
    # (b), (c), (d) and (e) side by side, each spawn_ranks call on a thread of its own
    configs = (("(b) 1 nccl rank", 1, "nccl", (obs, MESH_HMC[0], q_ref), ref),
               ("(c) 2 gloo ranks", 2, "gloo", (obs, MESH_HMC[0], q_ref), ref),
               (f"(d) 2 gloo ranks, {MESH_FEW // 2} rows a rank", 2, "gloo",
                (obs, MESH_FEW, q_ref, MESH_FEW), few["out"]))
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(len(configs) + 1) as pool:
        timeout = left()
        runs = [pool.submit(spawn_ranks, mesh_run, nprocs, backend, "cuda:0", args=args,
                            timeout=timeout)
                for _, nprocs, backend, args, _ in configs]
        rows_run = pool.submit(spawn_ranks, mesh_rows, 2, "gloo", "cuda:0", timeout=timeout)
        ranks = [r.result() for r in runs]
        rows_ranks = rows_run.result()
    for (label, _, _, _, want), rk in zip(configs, ranks):
        summary[label] = mesh_report(label, rk, want, t0, card)
    summary["(e) 2 gloo ranks, 1 row a rank"] = mesh_rows_report(rows_ref, rows_ranks)
    print(f"mesh (b), (c), (d), (e): done {time.perf_counter() - t_phase:.1f} s into the phase",
          flush=True)
    wall = time.perf_counter() - t_phase
    print(f"mesh JSON: {json.dumps(dict(summary, card=card, phase_s=round(wall, 1)))}",
          flush=True)
    if wall > MESH_TIMEOUT:
        raise AssertionError(f"mesh phase took {wall:.1f} s, over {MESH_TIMEOUT} s")
    print(f"mesh phase: {wall:.1f} s; (b) and (c) equal (a), (d) equals (a'), (e) its "
          "in-process run, at the stated tolerances", flush=True)


# step 15: the JAX package's shipped workflows (gigalens_tpu_torch.demos) at
# the demos' widths: (c) model comparison, (a) composite, (d) multi-plane,
# (b) time delay. HMC depths of (a) and (b), (chains, burn-in, results): the
# composite demo's; the time-delay demo's --quick ones (its 32 x (500 + 750)
# took 282 s of HMC alone on the card, step 15 428.5 s, which beside the
# other two processes would end past the main process's sampling)
DEMO_COMPOSITE_HMC = (16, 150, 400)
DEMO_TIMEDELAY_HMC = (16, 300, 300)
DEMO_TIMEOUT = 700.0  # the demos process's limit
FUSED_RENDER_KEYS = ("fused_render_fwd", "fused_render_fwd_omega", "fused_render_bwd")
K4_KEYS = ("direct_conv_fwd", "direct_conv_transpose", "dft_conv_fwd", "dft_conv_transpose")


def demos_phase():
    """Step 15's four legs, each with the launch counters zeroed just
    before it and read just after, each raising unless every gate of its
    ``gigalens_tpu_torch.demos`` result holds: (c) the SMC evidence of EPL
    against SIE (K2/K3 in both arms, no K4); (a) the composite demo (the
    direct K4 exactly once a MAP and an SVI step each way, no fused render;
    no kernel in HMC); (d) the multi-plane MAP (the direct K4 exactly once
    a step each way, no fused render) and its magnifications against
    central differences; (b) the time-delay fit (no launches at all).
    Returns (launch counts by phase, the states step 15's kernels rows
    start from, as CPU tensors)."""
    import os

    import torch

    from gigalens_tpu_torch import demos
    from gigalens_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    counts, walls, states = {}, {}, {}
    print(f"step 15: the shipped workflows; os.cpu_count() {os.cpu_count()}", flush=True)

    def counted(prefix):
        @contextlib.contextmanager
        def hook(name):
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            counts[f"{prefix}_{name}"] = launch_counts()
            print(f"step 15 {prefix} {name}: {time.perf_counter() - t0:.2f} s, launches "
                  f"{json.dumps(counts[f'{prefix}_{name}'])}", flush=True)
        return hook

    def gated(leg, res):
        print(f"step 15 {leg} JSON: {json.dumps(dict(gates=res.gates(), **res.row()))}",
              flush=True)
        failed = [k for k, ok in res.gates().items() if not ok]
        if failed:
            raise AssertionError(f"step 15 {leg}: gates failed {failed}")

    t0 = time.perf_counter()
    res = demos.run_comparison(device=dev, hook=counted("demo_comparison"))
    walls["(c) comparison"] = time.perf_counter() - t0
    gated("(c) comparison", res)
    for name in ("EPL", "SIE"):
        seq, smc = res.states[name]
        sim = seq._sim(smc.particles.shape[0] * smc.particles.shape[1], exact=True)
        if not (sim._use_fused and sim._fused_niter is not None):
            raise AssertionError(f"step 15 (c): the {name} arm must take K1-K3")
        check_launches(f"step 15 (c) {name} SMC", counts[f"demo_comparison_{name}"],
                       HMC_NEED, K4_KEYS + BUILDER_BANNED)
        states[f"comparison_{name}"] = smc.particles.reshape(-1, smc.particles.shape[-1]).cpu()

    t0 = time.perf_counter()
    hmc_n, burnin, results = DEMO_COMPOSITE_HMC
    res = demos.run_composite(device=dev, hook=counted("demo_composite"), hmc_n=hmc_n,
                              burnin=burnin, results=results)
    walls["(a) composite"] = time.perf_counter() - t0
    gated("(a) composite", res)
    seq = res.states["seq"]
    depths = demos.COMPOSITE_DEPTHS
    sim = seq._sim(depths["map_n"])
    if sim._use_fused or not direct_route(sim):
        raise AssertionError("step 15 (a): the composite MAP must render unfused through the "
                             "direct K4")
    for phase, n in (("map", depths["map_steps"]), ("svi", depths["vi_steps"])):
        check_launches(f"step 15 (a) composite {phase}", counts[f"demo_composite_{phase}"],
                       banned=FUSED_RENDER_KEYS + BUILDER_BANNED + ("dft_conv_fwd",
                                                                    "dft_conv_transpose"),
                       exact=dict(direct_conv_fwd=n, direct_conv_transpose=n))
    check_launches("step 15 (a) composite HMC", counts["demo_composite_hmc"],
                   banned=FUSED_RENDER_KEYS + BUILDER_BANNED + K4_KEYS)
    gen = torch.Generator(device=dev).manual_seed(15)
    states["composite_map"] = res.states["z_map"].cpu()
    states["composite_svi"] = res.states["q_z"].sample(gen, depths["vi_n"]).cpu()

    t0 = time.perf_counter()
    res = demos.run_multiplane(device=dev, hook=counted("demo_multiplane"))
    walls["(d) multi-plane"] = time.perf_counter() - t0
    gated("(d) multi-plane", res)
    n = demos.MULTIPLANE_MAP["map_steps"]
    check_launches("step 15 (d) multi-plane MAP", counts["demo_multiplane_map"],
                   banned=FUSED_RENDER_KEYS + BUILDER_BANNED + ("dft_conv_fwd",
                                                                "dft_conv_transpose"),
                   exact=dict(direct_conv_fwd=n, direct_conv_transpose=n))
    states["multiplane_map"] = res.states["z_map"].cpu()

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    hmc_n, burnin, results = DEMO_TIMEDELAY_HMC
    res = demos.run_timedelay(device=dev, n_hmc=hmc_n, burnin=burnin, results=results)
    torch.cuda.synchronize()
    walls["(b) time delay"] = time.perf_counter() - t0
    counts["demo_timedelay"] = launch_counts()
    gated("(b) time delay", res)
    check_launches("step 15 (b) time delay", counts["demo_timedelay"],
                   banned=FUSED_RENDER_KEYS + BUILDER_BANNED + K4_KEYS)
    print(f"step 15: {time.perf_counter() - t_phase:.1f} s; walls (s) "
          + ", ".join(f"{k} {v:.2f}" for k, v in walls.items()), flush=True)
    return counts, states


def demos_worker(quiet, out_path):
    """demos_phase() in a spawned process: loads the kernels step 2 built
    and saves its (launch counts, states) to ``out_path``; it measures
    nothing, so ``quiet`` goes unused."""
    sys.path.insert(0, str(ROOT))
    import torch

    from gigalens_tpu_torch.ops.cuda import _build

    _build.load()
    counts, states = demos_phase()
    torch.save(dict(counts=counts, states=states), out_path)


def demos_kernels(states):
    """Step 15's kernels at its new shapes, against their twins, with the
    card to this process: K2/K3 at the comparison's final clouds (512 rows
    of 1,024 pixels, niter 23) for each arm, the SIE as EPL at gamma = 2
    with a zero lens light; the direct K4 both ways at the composite MAP's
    (256, 128, 128) and SVI's (200, 128, 128) images (the 13-px PSF, pooled)
    and at the multi-plane MAP's (128, 48, 48). Returns the kernels rows."""
    import torch

    from gigalens_tpu_torch import demos
    from gigalens_tpu_torch.simulator import LensSimulator

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(16)
    kernels = []
    sc = demos.comparison_scene(dev)
    for name, (phys, prior) in sc.arms.items():
        z = states[f"comparison_{name}"].to(dev)
        sim = LensSimulator(phys, sc.cfg, bs=z.shape[0], device=dev)
        params = sim.fused_params(prior.constrain(z)).contiguous()
        rows, _ = render_rows(params, sim, gen, f"demo_comparison_{name}",
                              f"comparison {name} SMC bs={z.shape[0]}")
        kernels += rows

    def k4_rows(sc, z, phase, where, beat_library=False):
        sim = LensSimulator(sc.phys, sc.cfg, bs=z.shape[0], device=dev)
        if not direct_route(sim):
            raise AssertionError(f"step 15 {where}: the simulator must take the direct K4")
        conv = sim._conv
        with torch.no_grad():
            flat = sim._flat_light(sc.prior.constrain(z))
        xin = flat.reshape(-1, conv.h, conv.w).contiguous()
        ctc = torch.randn((xin.shape[0], conv.h // conv.pool, conv.w // conv.pool),
                          generator=gen, device=dev)
        rows, _ = direct_checks(conv, xin, ctc, where, beat_library)
        return [dict(r, phase=phase) for r in rows]

    sc = demos.composite_scene(device=dev)
    for phase in ("map", "svi"):
        z = states[f"composite_{phase}"].to(dev)
        kernels += k4_rows(sc, z, f"demo_composite_{phase}",
                           f"composite {phase.upper()} bs={z.shape[0]}")
    z = states["multiplane_map"].to(dev)
    kernels += k4_rows(demos.multiplane_scene(dev), z, "demo_multiplane_map",
                       f"multi-plane MAP bs={z.shape[0]}", beat_library=True)
    return kernels


def render_rows(params, sim, gen, phase, where):
    """K2 and K3 at ``params``' shape on ``sim``'s grid, each against its
    float64 twin with kernel_checks' tolerances and timed against its
    float32 twin with CUDA events. Returns ([K2 row, K3 row], K2's image)."""
    import torch

    from gigalens_tpu_torch.ops.cuda import fused_render as fr

    bs, x, y, niter = params.shape[0], sim.img_x, sim.img_y, sim._fused_niter
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
    row = dict(name=f"fused_render_fwd<true> (K2) at {where}",
               key="fused_render_fwd_omega", phase=phase, route="cuda",
               source="gigalens_tpu_torch/csrc/fused_render.cu",
               replaces="gigalens_tpu/ops/pallas/fused_render.py:246",
               max_abs_err=max(e2, e_om), ms=ms, plain_ms=pms, bound_ms=b_ms,
               bound_by=b_by, library_ms=None)
    print(f"K2 at {where}: max|err| out {e2:.3e} omega {e_om:.3e}  kernel {ms:.3f} ms  "
          f"twin {pms:.3f} ms  bound {b_ms:.3f} ms ({b_by})", flush=True)
    ct = torch.randn(out.shape, generator=gen, device=out.device)
    return [row, dict(k3_check(params, x, y, ox, oy, ct, niter, where), phase=phase)], out


def pipeline_kernel_checks(pipe, smc_res):
    """K2/K3 at the pipeline's SVI shape (n_vi = 1000 draws from the fitted
    surrogate, as the SVI phase draws them), HMC shape (the 50 chains' last
    states) and SMC shape (the 1000 final particles), and the direct K4
    both ways at the SVI shape (the K2 images and a random cotangent), each
    against its float64 twin with kernel_checks' tolerances, and timed
    against its float32 twin with CUDA events."""
    import torch

    from gigalens_tpu_torch.ops.cuda import fused_render as fr

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    kernels = []
    for phase, z in (("svi", pipe.q_z.sample(gen, pipe.cfg["vi_n"])),
                     ("hmc", pipe.hmc_res.samples[-1]),
                     ("smc", smc_res.particles.reshape(-1, pipe.prior.d))):
        sim = pipe.seq._sim(z.shape[0], exact=phase != "svi")
        params = fr.pack_params(pipe.prior.constrain(z)).contiguous()
        bs = params.shape[0]
        where = f"{phase.upper()} bs={bs}"
        rows, out = render_rows(params, sim, gen, phase, where)
        kernels += rows
        if phase != "svi":
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
    spilled = direct_spills(log)
    if spilled:
        print(f"chip_smoke: ptxas spills in the direct K4's variants or gram_pinv: {spilled}",
              file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    _build.load()
    print(f"load: the library's key and its ctypes load in {time.perf_counter() - t0:.3f} s",
          flush=True)

    if "--mesh" in argv:
        # a development aid: the mesh phase alone; no ok line follows
        mesh_phase(card)
        print(card)
        print(json.dumps({"partial": True, "kernels": []}))
        return 0

    if "--cluster" in argv:
        # a development aid: steps 10 and 10b alone; no ok line follows
        counts, timed, state = cluster_phase()
        post_counts, post_kernels = cluster_posterior_phase(*state)
        counts.update(post_counts)
        cluster_repairs_phase()
        print(card)
        print(json.dumps({"partial": True, "kernels": [
            {k: v for k, v in dict(kern, launches=counts[kern["phase"]][kern["key"]]).items()
             if k not in ("key", "phase")} for kern in timed() + post_kernels()]}))
        return 0

    if "--demos" in argv:
        # a development aid: step 15 alone; no ok line follows
        demo_counts, demo_states = demos_phase()
        print(card)
        print(json.dumps({"partial": True, "kernels": [
            {k: v for k, v in dict(kern, launches=demo_counts[kern["phase"]][kern["key"]]).items()
             if k not in ("key", "phase")} for kern in demos_kernels(demo_states)]}))
        return 0

    if "--inversion" in argv:
        # a development aid: the inversion phase alone; no ok line follows
        kernels, counts = inversion_phase()
        print(card)
        print(json.dumps({"partial": True, "kernels": [
            {k: v for k, v in dict(kern, launches=counts[kern["phase"]][kern["key"]]).items()
             if k not in ("key", "phase")} for kern in kernels]}))
        return 0

    # kernel_checks' rows belong to the bench MAP phase unless they say otherwise
    kernels = [dict(dict(phase="bench"), **k) for k in kernel_checks()]
    kernels += builder_checks()
    kernels += gram_pinv_checks()
    if "--kernels" in argv:
        # a development aid: no main path ran, so no launch counts and no ok line
        print(card)
        print(json.dumps({"partial": True,
                          "kernels": [{k: v for k, v in kern.items() if k not in ("key", "phase")}
                                      for kern in kernels]}))
        return 0
    counts = {"bench": main_path(MAP_STEPS), "chain": chain_path(CHAIN_STEPS),
              "S": family_path("S", MAP_STEPS), "L": family_path("L", MAP_STEPS)}
    # steps 6-8 and 10's sampling beside step 11 in a second process; then
    # each side's measurements with the card to itself
    with SideProcess(survey_worker, "survey", SURVEY_TIMEOUT) as survey, \
            SideProcess(demos_worker, "demos", DEMO_TIMEOUT) as demos_side:
        def check_sides():
            survey.check()
            demos_side.check()

        pipe, rec = pipeline_phase()
        check_sides()
        smc_res, smc_profile = smc_phase(pipe, rec)
        positions_phase(pipe)
        check_sides()
        cluster_counts, cluster_timed, cluster_state = cluster_phase()
        check_sides()
        posterior_counts, posterior_kernels = cluster_posterior_phase(*cluster_state)
        check_sides()
        cluster_repairs_phase()
        # the demos process measures nothing: joined first, the survey's
        # measurements then have the card to themselves
        demos_out = demos_side.finish()
        survey_out = survey.finish()
    smc_profile()
    kernels += pipeline_kernel_checks(pipe, smc_res)
    counts.update(svi=rec["svi"]["counts"], hmc=rec["hmc"]["counts"], smc=rec["smc"]["counts"])
    kernels += cluster_timed()
    counts.update(cluster_counts)
    kernels += posterior_kernels()
    counts.update(posterior_counts)
    kernels += survey_out["kernels"]
    counts.update(survey_out["counts"])
    kernels += demos_kernels(demos_out["states"])
    counts.update(demos_out["counts"])
    inversion_kernels, inversion_counts = inversion_phase()
    kernels += inversion_kernels
    counts.update(inversion_counts)
    mesh_phase(card)
    # launches: each kernel's count in the phase of its row (K1-K4 the bench
    # scene's MAP, K5 and K7 family S's, K6 and K7-components family L's;
    # the rows at the SVI, HMC and SMC shapes the pipeline's SVI, HMC and
    # SMC phases; the cluster rows the cluster MAP's, SMC's and lstsq MAP's,
    # step 10b's the dpie SVI's and HMC's and the sie MAP's;
    # the survey rows the survey MAP's (the direct K4: all S scenes' launches);
    # the inversion K4 rows one bs-32 forward + gradient evaluation's;
    # step 15's K2/K3 each comparison arm's SMC, its K4 rows the composite
    # MAP's and SVI's and the multi-plane MAP's;
    # the chain K4 at the wide PSF the chain MAP phase's, and at the bench
    # shape, where PSFConv takes the direct route, 0)
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
