#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (gigalens_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the hand-written kernels from gigalens_tpu_torch/csrc/ with nvcc
   into build/kernels/ and prints the build time and ptxas resource usage.
3. Checks every kernel of the MAP path against its plain PyTorch twin at the
   main-path shapes (bs=500 samples, 25,600 supersampled pixels, niter=23;
   the PSF conv at (500, 160, 160) and its transpose at (500, 80, 80)), on
   inputs drawn from the bench prior, and times kernel and twin with CUDA
   events.
4. Runs the MAP phase of the bench scene (bench.py: EPL+Shear, SersicEllipse
   lens light and source, 80x80 px at 0.065", supersample 2, the 25x25
   Gaussian fallback PSF) through ModellingSequence: truth from a seeded
   generator rendered by the port, noise at bkg 0.2 / exp_time 100, then
   multi-start Adam (50 steps) from 500 prior draws and best_map_start.
   The kernels' launch counters are zeroed just before and read just after.
5. Ends with the card line, a JSON line of per-kernel results and the ok
   line.

Every phase raises on failure (nothing is caught), so any failure exits
nonzero before the ok line. Without a CUDA device it exits nonzero at once.
"""
from __future__ import annotations

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
OMEGA_ATOL = 1e-4  # K2's angular series (|Omega| ~ 1)
# K3, per parameter column, of the column's max |gradient| against float64.
# The float32 twin itself is 1.0e-3 (random cotangent) to 1.4e-3 (smooth
# cotangent) off float64 on these inputs, all from one bench-prior draw
# with a very steep, bright source (gradients ~3e7), so the bound is 2e-3.
GRAD_REL = 2e-3
CONV_REL = 1e-4  # K4, of the output's max |value|

BS, NUM_PIX, SUPERSAMPLE, DELTA_PIX = 500, 80, 2, 0.065
MAP_STEPS = 50


def bench_prior():
    from gigalens_tpu_torch.prob import Prior
    from gigalens_tpu_torch.prob import distributions as d

    return Prior(dict(
        lens_mass=[
            dict(theta_E=d.LogNormal(math.log(1.25), 0.25),
                 gamma=d.TruncatedNormal(2, 0.25, 1, 3),
                 e1=d.Normal(0, 0.1), e2=d.Normal(0, 0.1),
                 center_x=d.Normal(0, 0.05), center_y=d.Normal(0, 0.05)),
            dict(gamma1=d.Normal(0, 0.05), gamma2=d.Normal(0, 0.05)),
        ],
        lens_light=[
            dict(R_sersic=d.LogNormal(math.log(1.0), 0.15), n_sersic=d.Uniform(2, 6),
                 e1=d.TruncatedNormal(0, 0.1, -0.3, 0.3),
                 e2=d.TruncatedNormal(0, 0.1, -0.3, 0.3),
                 center_x=d.Normal(0, 0.05), center_y=d.Normal(0, 0.05),
                 Ie=d.LogNormal(math.log(500.0), 0.3)),
        ],
        source_light=[
            dict(R_sersic=d.LogNormal(math.log(0.25), 0.15), n_sersic=d.Uniform(0.5, 4),
                 e1=d.TruncatedNormal(0, 0.15, -0.5, 0.5),
                 e2=d.TruncatedNormal(0, 0.15, -0.5, 0.5),
                 center_x=d.Normal(0, 0.25), center_y=d.Normal(0, 0.25),
                 Ie=d.LogNormal(math.log(150.0), 0.5)),
        ],
    ))


def bench_scene():
    import numpy as np

    from gigalens_tpu_torch import PhysicalModel, SimulatorConfig
    from gigalens_tpu_torch.profiles.light import SersicEllipse
    from gigalens_tpu_torch.profiles.mass import EPL, Shear

    g = np.exp(-((np.arange(25) - 12) ** 2 + (np.arange(25)[:, None] - 12) ** 2) / 8.0)
    psf = (g / g.sum()).astype(np.float32)
    niter = EPL.recommended_niter(q_min=0.43, tol=1e-8)
    phys = PhysicalModel([EPL(niter), Shear()], [SersicEllipse()], [SersicEllipse()])
    cfg = SimulatorConfig(delta_pix=DELTA_PIX, num_pix=NUM_PIX,
                          supersample=SUPERSAMPLE, kernel=psf)
    return phys, cfg, niter


def cuda_ms(fn, reps=10, warmup=2):
    """Mean milliseconds per call from CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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

    from gigalens_tpu_torch.ops.cuda import dft_conv as dc
    from gigalens_tpu_torch.ops.cuda import fused_render as fr
    from gigalens_tpu_torch.ops.psf import PSFConv, average_pool
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
    ms = cuda_ms(lambda: fr.fused_render_fwd(params, x, y, niter))
    pms = cuda_ms(lambda: fr.fused_render_fwd_reference(params, x, y, niter), reps=3, warmup=1)
    kernels.append(dict(name="fused_render_fwd<false> (K1)", key="fused_render_fwd",
                        route="cuda", source="gigalens_tpu_torch/csrc/fused_render.cu",
                        replaces="gigalens_tpu/ops/pallas/fused_render.py:265",
                        max_abs_err=e1, ms=ms, plain_ms=pms))
    print(f"K1: max|err| vs f64 {e1:.3e}  kernel {ms:.3f} ms  twin {pms:.3f} ms", flush=True)

    # K2: forward + Omega residuals
    out_k2, ox_k, oy_k = fr.fused_render_fwd(params, x, y, niter, save_omega=True)
    torch.cuda.synchronize()
    ox64, oy64 = (chunked(lambda p, i=i: f64_fwd(p)[i], BS, 50, params) for i in (1, 2))
    e2 = check_close("K2 out vs f64 twin", out_k2, out64, FWD_RTOL, FWD_ATOL)
    check_close("K2 out vs f32 twin", out_k2, out32, FWD_RTOL, FWD_ATOL)
    e_om = max(check_close("K2 ox vs f64 twin", ox_k, ox64, 0.0, OMEGA_ATOL),
               check_close("K2 oy vs f64 twin", oy_k, oy64, 0.0, OMEGA_ATOL))
    check_close("K2 ox vs f32 twin", ox_k, ox32, 0.0, OMEGA_ATOL)
    check_close("K2 oy vs f32 twin", oy_k, oy32, 0.0, OMEGA_ATOL)
    ms = cuda_ms(lambda: fr.fused_render_fwd(params, x, y, niter, save_omega=True))
    kernels.append(dict(name="fused_render_fwd<true> (K2)", key="fused_render_fwd_omega",
                        route="cuda", source="gigalens_tpu_torch/csrc/fused_render.cu",
                        replaces="gigalens_tpu/ops/pallas/fused_render.py:246",
                        max_abs_err=max(e2, e_om), ms=ms, plain_ms=pms))
    print(f"K2: max|err| out {e2:.3e} omega {e_om:.3e}  kernel {ms:.3f} ms  "
          f"twin {pms:.3f} ms", flush=True)
    del out64, ox64, oy64

    # K3: parameter gradient, against torch autograd of the twin in f64
    ct = torch.randn((BS, npix), generator=gen, device=dev)
    g_k = fr.fused_render_bwd(params, x, y, ox_k, oy_k, ct, niter)
    torch.cuda.synchronize()

    def grad64(p, c):
        p = p.double().requires_grad_(True)
        out = fr.fused_render_reference(p, x.double(), y.double(), niter)
        return torch.autograd.grad((out * c.double()).sum(), p)[0]

    g64 = chunked(grad64, BS, 25, params, ct)
    rel3, e3 = check_rel("K3 vs f64 autograd of the twin", g_k, g64, GRAD_REL, dim=0)
    g32 = fr.fused_render_bwd_reference(params, x, y, ox32, oy32, ct, niter)
    rel3_32, _ = check_rel("K3 vs f32 hand-VJP twin", g_k, g32, GRAD_REL, dim=0)
    # the two-pass tile reduction has a fixed order: bitwise repeatable
    if not torch.equal(g_k, fr.fused_render_bwd(params, x, y, ox_k, oy_k, ct, niter)):
        raise AssertionError("K3 is not deterministic from run to run")
    ms = cuda_ms(lambda: fr.fused_render_bwd(params, x, y, ox_k, oy_k, ct, niter))
    pms = cuda_ms(lambda: fr.fused_render_bwd_reference(params, x, y, ox32, oy32, ct, niter),
                  reps=3, warmup=1)
    kernels.append(dict(name="fused_render_bwd (K3)", key="fused_render_bwd", route="cuda",
                        source="gigalens_tpu_torch/csrc/fused_render.cu",
                        replaces="gigalens_tpu/ops/pallas/fused_render.py:299",
                        max_abs_err=e3, ms=ms, plain_ms=pms))
    print(f"K3: col-rel err vs f64 autograd {rel3:.3e} (vs f32 twin {rel3_32:.3e})  "
          f"kernel {ms:.3f} ms  twin {pms:.3f} ms", flush=True)
    del g64, ox32, oy32, g32

    # K4: the PSF conv (forward and transpose) on the K1 images
    conv = sim._conv
    if conv is None or conv.mode != "dft":
        raise AssertionError(f"the CUDA simulator should pick the dft conv, got {conv}")
    xin = out_k.reshape(BS, NUM_PIX * SUPERSAMPLE, NUM_PIX * SUPERSAMPLE).contiguous()
    ctc = torch.randn((BS, NUM_PIX, NUM_PIX), generator=gen, device=dev)
    fft64 = PSFConv(conv.kernel, (conv.h, conv.w), mode="fft", device=dev)
    print(f"K4: fshape {conv.fshape}", flush=True)
    # one pallas_call serves both directions (the VJP runs it on the
    # transposed factor set), so both rows replace the same site
    for direction, mats, arg, key in (
        ("fwd", conv._dft.fwd_mats, xin, "dft_conv_fwd"),
        ("transpose", conv._dft.bwd_mats, ctc, "dft_conv_transpose"),
    ):
        got = dc.dft_conv_cuda(arg, mats, direction)
        torch.cuda.synchronize()
        m64 = [m.double() for m in mats]
        ref64 = chunked(lambda a: dc.dft_conv_reference(a.double(), m64), BS, 100, arg)
        r_a, e4 = check_rel(f"K4 {direction} vs f64 einsum twin", got, ref64, CONV_REL)
        if direction == "fwd":
            fref = chunked(lambda a: average_pool(fft64(a.double()), SUPERSAMPLE), BS, 100, arg)
        else:
            def vjp(a):
                z = torch.zeros((a.shape[0], conv.h, conv.w), dtype=torch.float64,
                                device=dev, requires_grad=True)
                out = average_pool(fft64(z), SUPERSAMPLE)
                return torch.autograd.grad(out, z, a.double())[0]
            fref = chunked(vjp, BS, 100, arg)
        r_b, _ = check_rel(f"K4 {direction} vs f64 fft conv", got, fref, CONV_REL)
        ms = cuda_ms(lambda: dc.dft_conv_cuda(arg, mats, direction))
        pms = cuda_ms(lambda: dc.dft_conv_reference(arg, mats))
        kernels.append(dict(name=f"dft_conv {direction} (K4)", key=key, route="cuda",
                            source="gigalens_tpu_torch/csrc/dft_conv.cu",
                            replaces="gigalens_tpu/ops/pallas/dft_conv.py:95",
                            max_abs_err=e4, ms=ms, plain_ms=pms))
        print(f"K4 {direction}: rel err vs f64 twin {r_a:.3e}, vs f64 fft {r_b:.3e}  "
              f"kernel {ms:.3f} ms  twin {pms:.3f} ms", flush=True)
    ragged_checks(params, x, y, niter, gen)
    return kernels


def ragged_checks(params, x, y, niter, gen):
    """Shapes off the kernels' tile grids: 3 samples x 1000 pixels (a band
    through the image center; not a multiple of the 256-pixel tile), and a
    40x40 conv with a 9x9 PSF (no GEMM dimension a multiple of 64)."""
    import numpy as np
    import torch

    from gigalens_tpu_torch.ops.cuda import dft_conv as dc
    from gigalens_tpu_torch.ops.cuda import fused_render as fr
    from gigalens_tpu_torch.ops.psf import PSFConv

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

    kern = np.random.default_rng(0).random((9, 9)).astype(np.float32)
    conv = PSFConv(kern / kern.sum(), (40, 40), mode="dft", pool=2, device=out.device)
    for direction, mats, shape in (("fwd", conv._dft.fwd_mats, (3, 40, 40)),
                                   ("transpose", conv._dft.bwd_mats, (3, 20, 20))):
        a = torch.randn(shape, generator=gen, device=out.device)
        ref = dc.dft_conv_reference(a.double(), [m.double() for m in mats])
        check_rel(f"K4 {direction} ragged", dc.dft_conv_cuda(a, mats, direction), ref,
                  CONV_REL)
    print("ragged shapes (3 samples x 1000 px; 40x40 conv, fshape "
          f"{conv.fshape}): K1-K4 match their float64 twins", flush=True)


def main_path(steps):
    import torch

    from gigalens_tpu_torch.inference import ModellingSequence, optim
    from gigalens_tpu_torch.model import ForwardProbModel
    from gigalens_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from gigalens_tpu_torch.simulator import LensSimulator

    dev = torch.device("cuda")
    phys, cfg, _ = bench_scene()
    prior = bench_prior()
    truth = prior.sample(torch.Generator(device=dev).manual_seed(42), 1)
    truth_img = LensSimulator(phys, cfg, bs=1, device=dev).simulate(truth)
    noise_gen = torch.Generator(device=dev).manual_seed(1)
    bkg, exp_time = 0.2, 100.0
    obs = truth_img + torch.randn(truth_img.shape, generator=noise_gen, device=dev) * torch.sqrt(
        bkg**2 + torch.clamp(truth_img, min=0.0) / exp_time)
    if obs.shape != (NUM_PIX, NUM_PIX) or not torch.isfinite(obs).all():
        raise AssertionError(f"bad observation: shape {tuple(obs.shape)}")
    prob = ForwardProbModel(prior, obs.cpu().numpy(), background_rms=bkg,
                            exp_time=exp_time, device=dev)
    seq = ModellingSequence(phys, prob, cfg, device=dev)
    opt = optim.chain(optim.scale_by_adam(), optim.scale_by_schedule(
        optim.polynomial_schedule(-1e-2, -1e-2 / 3, 0.5, steps)))
    start = prior.unconstrain(prior.sample(torch.Generator(device=dev).manual_seed(0), BS))
    sim = seq._sim(BS)
    if not sim._use_fused or sim._conv.mode != "dft":
        raise AssertionError("the MAP simulator must take the fused kernel and the dft conv")

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
    print(f"MAP: {steps} steps at bs={BS}: {1e3 * wall / steps:.3f} ms/step "
          f"(host clock over the whole phase), peak device memory "
          f"{peak / 2**30:.3f} GiB", flush=True)
    print(f"MAP: min reduced chi2 step 0 {chi0:.4f} -> step {steps} {chi_n:.4f}", flush=True)
    print(f"launch counts over the main path: {json.dumps(counts)}", flush=True)
    if z.shape != (BS, prior.d) or not torch.isfinite(z).all():
        raise AssertionError(f"MAP output not finite / wrong shape {tuple(z.shape)}")
    if best.shape != (1, prior.d) or not torch.isfinite(best).all():
        raise AssertionError("best_map_start output not finite / wrong shape")
    if not (math.isfinite(chi_n) and chi_n < chi0):
        raise AssertionError(f"min reduced chi2 did not decrease: {chi0} -> {chi_n}")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    return counts


def main():
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

    kernels = kernel_checks()
    counts = main_path(MAP_STEPS)
    out = [
        {k: v for k, v in dict(kern, launches=counts[kern["key"]]).items() if k != "key"}
        for kern in kernels
    ]
    print(card)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
