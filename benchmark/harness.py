"""The benchmark's general machinery: a cell from ``BENCHMARK.json`` by name,
its configuration, traffic, driver, reference and per-layer readers found
by name under this folder, set-up, the measured window, the result line.

A cell names a configuration (``configs/<name>.json`` with the program's
builder ``configs/<name>.py`` and the plain reference
``reference/<name>.py`` with its limits ``reference/<name>.limits.json``)
and a traffic mix (``traffic/<name>.json``, parameters only), whose
``driver`` key names the module ``drivers/<driver>.py`` that runs that kind
of work through the program and checks it. A per-layer metric is read by
``metrics/<name>.py``. Adding a cell, a configuration, a traffic mix, a
driver or a metric adds files and entries and edits none.

A driver gives ``evals_a_step(traffic)`` (what one step evaluates),
``drive(ctx, probe, fits)`` (the work, through the program, with ``probe``
in the program's prob model's place, until the probe closes the window;
returns the steps finished and the fits started) and ``check(ctx)`` (the
numbers compared against the reference once the window has closed, and the
rows compared).

Each step's start is a CUDA event recorded where the program asks the prob
model for the step's log density, so the timing adds no synchronisation;
the events are read once the window has closed. The window closes at the
first step that would start after ``--seconds``: every step counted
finished.
"""
from __future__ import annotations

import ast
import bisect
import hashlib
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
BENCH_FILE = ROOT.parent / "BENCHMARK.json"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from reference.plain import Precision  # noqa: E402

# top-level module names that may not be loaded in a run (compared whole:
# the program's own name starts with the JAX package's)
BANNED_MODULES = ("jax", "jaxlib", "flax", "gigalens_tpu")
PROGRAM = "gigalens_tpu_torch"
WARMUP_STEPS = 2  # steps of a fit at the cell's shapes run in set-up
PROFILE_FIRST, PROFILE_STEPS = 6, 10  # the traced stretch: window steps [6, 16)


class WindowClosed(Exception):
    """Raised where the next step would start after the window."""


# ---------------------------------------------------------------------------
# finding things by name
# ---------------------------------------------------------------------------

def load_module(kind, name):
    path = ROOT / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def read_json(kind, name):
    return json.loads((ROOT / kind / f"{name}.json").read_text())


def load_cell(workload, entry=None):
    """Everything a run of ``workload`` needs, found by name; ``entry``, a
    cell's entry as ``BENCHMARK.json``'s ``workloads`` would hold it, stands
    for one the file does not have (the tests' use)."""
    bench = json.loads(BENCH_FILE.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if entry is not None:
        cells[workload] = entry
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    cfg_name = cell["config"]
    traffic = read_json("traffic", cell["traffic"])
    return dict(
        bench=bench, cell=cell, cfg=read_json("configs", cfg_name), traffic=traffic,
        driver=load_module("drivers", traffic["driver"]),
        system=load_module("configs", cfg_name), reference=load_module("reference", cfg_name),
        limits=read_json("reference", f"{cfg_name}.limits"),
        end_to_end=[m for m in bench["end_to_end"]
                    if workload in m.get("workloads", [workload])],
        per_layer=[m for m in bench["per_layer"] if workload in m.get("workloads", [workload])],
    )


def generator(seed, stream, device):
    """A torch.Generator on ``device`` seeded from (``seed``, ``stream``)."""
    h = hashlib.sha256(f"{seed}/{stream}".encode()).digest()
    return torch.Generator(device=device).manual_seed(int.from_bytes(h[:8], "little") >> 1)


# ---------------------------------------------------------------------------
# the window's instruments
# ---------------------------------------------------------------------------

class Clock:
    """Step starts: CUDA events on the card (read after the window), the
    host clock elsewhere."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def durations_s(self):
        """Seconds between consecutive marks (call after a synchronise)."""
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) / 1e3 for a, b in zip(m, m[1:])]
        return [b - a for a, b in zip(m, m[1:])]


class Probe:
    """The program's prob model as the driver's loop sees it, with the
    window's hooks at each step's start (where the loop asks for the log
    density): a clock mark, the window's close, the traced stretch, and the
    check's record of the first fit's first steps."""

    def __init__(self, inner, clock, deadline=None, max_steps=None, record_steps=0,
                 on_step=None):
        self.inner, self.clock = inner, clock
        self.deadline, self.max_steps = deadline, max_steps
        self.record_steps = record_steps
        self.on_step = on_step
        self.steps = 0  # step starts in this window
        self.fit = 0
        self.fit_step = 0
        self.record = {"z": [], "lp": [], "chi": []}
        self.first_step_time = None

    def event_size(self, simulator):
        return self.inner.event_size(simulator)

    def new_fit(self, index):
        self.fit, self.fit_step = index, 0

    def log_prob(self, simulator, z):
        now = time.perf_counter()
        tracing = self.on_step is not None and self.on_step.pending
        if ((self.deadline is not None and now >= self.deadline and not tracing)
                or (self.max_steps is not None and self.steps >= self.max_steps)):
            self.clock.mark()
            raise WindowClosed
        if self.first_step_time is None:
            self.first_step_time = time.time()
        if self.on_step is not None:
            self.on_step(self.steps)
        self.clock.mark()
        keep = self.fit == 0 and self.fit_step <= self.record_steps
        if keep:
            self.record["z"].append(z.detach().clone())
        lp, chi = self.inner.log_prob(simulator, z)
        if keep:
            self.record["lp"].append(lp.detach().clone())
            self.record["chi"].append(chi.detach().clone())
        self.steps += 1
        self.fit_step += 1
        return lp, chi


# ---------------------------------------------------------------------------
# the correctness check
# ---------------------------------------------------------------------------

def evaluate(ref, z, block):
    """The reference ``ref`` at the rows ``z``, ``block`` rows at a time
    (rows are independent): {"lp", "scale", "red_chi2", "grad" (d lp / dz)}."""
    parts = []
    for i in range(0, z.shape[0], block):
        zb = z[i:i + block].detach().requires_grad_(True)
        with torch.enable_grad():
            out = ref.log_prob(zb)
            (out["grad"],) = torch.autograd.grad(torch.sum(out["lp"]), zb)
        parts.append({k: v.detach() for k, v in out.items()})
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


class ControlModel:
    """The reference one step of precision below the configuration's, in the
    program's prob model's place under the driver: its log density and reduced chi2,
    with the gradient taken ``block`` rows at a time (the control's
    readings)."""

    def __init__(self, ctx, block=50):
        self.ref = ctx["reference"].Reference(ctx["cfg"], ctx["obs"], Precision("tf32"),
                                              ctx["device"])
        self.block = block

    def event_size(self, simulator):
        return self.ref.event_size

    def log_prob(self, simulator, z):
        out = evaluate(self.ref, z.detach(), self.block)
        lp, g = out["lp"].to(z.dtype), out["grad"].to(z.dtype)
        # value lp, gradient g, without holding the whole batch's graph
        tied = lp + torch.sum(z * g, dim=-1) - torch.sum(z * g, dim=-1).detach()
        return tied, out["red_chi2"].to(z.dtype)


# ---------------------------------------------------------------------------
# the traced stretch
# ---------------------------------------------------------------------------

def read_trace(prof):
    """Device operations and annotations, and host operations, of a
    torch.profiler window, from its raw events."""
    from torch.autograd import DeviceType

    dev_ops, dev_ann, host = [], [], []
    for e in prof.profiler.kineto_results.events():
        t0 = e.start_ns()
        t1 = t0 + e.duration_ns()
        corr = e.correlation_id() if hasattr(e, "correlation_id") else 0
        if e.device_type() == DeviceType.CUDA:
            (dev_ann if e.is_user_annotation() else dev_ops).append((e.name(), t0, t1, corr))
        else:
            host.append((e.name(), t0, t1, corr))
    dev_ops.sort(key=lambda r: r[1])
    host.sort(key=lambda r: r[1])
    return {"ops": dev_ops, "annotations": dev_ann, "host": host}


def busy_ns(ops):
    busy, end = 0, -math.inf
    for _, t0, t1, _ in ops:
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    return busy


def idle_gaps(trace):
    """{what the host was doing: seconds} over the device's idle gaps: each
    gap goes to the innermost host operation around the launch of the
    operation that ends it."""
    launches = {}
    for name, t0, _, corr in trace["host"]:
        if corr and name.startswith("cuda"):
            launches[corr] = t0
    host = [h for h in trace["host"] if not h[0].startswith("cuda")]
    starts = [h[1] for h in host]
    out, end = {}, None
    for name, t0, t1, corr in trace["ops"]:
        if end is not None and t0 > end:
            what = "unattributed"
            t = launches.get(corr)
            if t is not None:
                i = bisect.bisect_right(starts, t) - 1
                for j in range(i, max(i - 400, -1), -1):
                    if host[j][2] >= t:
                        what = host[j][0]
                        break
            out[what] = out.get(what, 0.0) + (t0 - end) * 1e-9
        end = t1 if end is None else max(end, t1)
    return out


def breakdown(trace, host_trace):
    """The device operations that took most time in ``trace`` and the
    idle gaps of ``host_trace`` by what the host was doing."""
    ops = {}
    for name, t0, t1, _ in trace["ops"]:
        ops[name] = ops.get(name, 0.0) + (t1 - t0) * 1e-9
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle_gaps(host_trace).items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:200], v] for k, v in top],
            "idle_gaps": [[k[:200], v] for k, v in gaps]}


class Tracer:
    """The traced run's two stretches, each started and stopped behind a
    synchronise: window steps [6, 16) under torch.profiler with device
    activity only (the per-layer metrics and the busy and idle time: the
    host's own operations are not recorded, so the profiler slows the host
    little), then steps [18, 21) with host activity too (what the host was
    doing in each idle gap). The window does not close before both are
    read."""

    STRETCHES = ((PROFILE_FIRST, PROFILE_FIRST + PROFILE_STEPS, False),
                 (PROFILE_FIRST + PROFILE_STEPS + 2, PROFILE_FIRST + PROFILE_STEPS + 5, True))

    def __init__(self):
        self.prof, self.t0, self.current = None, None, None
        self.traces, self.windows = [], []

    @staticmethod
    def _profile(host):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
        return profile(activities=acts)

    def prime(self):
        """Loads the profiler's device tracing in set-up, outside the window."""
        for host in (False, True):
            with self._profile(host):
                torch.ones(8, device="cuda").sum().item()

    @property
    def pending(self):
        return len(self.traces) < len(self.STRETCHES)

    def __call__(self, step):
        for first, end, host in self.STRETCHES:
            if step == end and self.current == first:
                self._stop()
            if step == first:
                torch.cuda.synchronize()
                self.prof, self.current = self._profile(host), first
                self.prof.__enter__()
                self.t0 = time.perf_counter()

    def _stop(self):
        torch.cuda.synchronize()
        self.windows.append(time.perf_counter() - self.t0)
        self.prof.__exit__(None, None, None)
        self.traces.append(read_trace(self.prof))
        self.prof = self.current = None


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------

def banned_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED_MODULES))


def reference_imports_program():
    """Reference files whose imports name the program or the JAX package."""
    bad = []
    for path in sorted((ROOT / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names = [node.module]
            if any(n.split(".")[0] in (PROGRAM, *BANNED_MODULES) for n in names):
                bad.append(path.name)
    return sorted(set(bad))


def prepare(cell, seed, device, overrides=None):
    """Set-up's inputs: the configuration and traffic (with ``overrides``,
    {"cfg": {...}, "traffic": {...}}, which only the tests use), the seed's
    data, the program's model and simulator at the batch of the driver's
    step."""
    overrides = overrides or {}
    cfg = {**cell["cfg"], **overrides.get("cfg", {})}
    traffic = {**cell["traffic"], **overrides.get("traffic", {})}
    data = cell["reference"].observe(cfg, generator(seed, "data", device), device)
    prob, sim = cell["system"].build(cfg, data["obs"], cell["driver"].evals_a_step(traffic),
                                     device)
    ref_prior = cell["reference"].Reference(cfg, data["obs"], Precision("float64"),
                                            device).prior
    return dict(cfg=cfg, traffic=traffic, seed=seed, device=device, obs=data["obs"],
                truth_z=data["truth_z"], ref_prior=ref_prior, prob=prob, sim=sim,
                reference=cell["reference"], driver=cell["driver"], record={})


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def window(ctx, seconds=None, max_steps=None, trace=False, prob=None, fits=10**6):
    """One measured window (or, with ``max_steps``, that many step starts):
    returns its readings."""
    device = ctx["device"]
    ctx["record"] = {}
    clock = Clock(device)
    tracer = Tracer() if trace else None
    sync(device)
    t0 = time.perf_counter()
    probe = Probe(prob if prob is not None else ctx["prob"], clock,
                  deadline=None if seconds is None else t0 + seconds, max_steps=max_steps,
                  record_steps=ctx["traffic"]["check_steps"], on_step=tracer)
    ctx["probe"] = probe
    done, fits_started = ctx["driver"].drive(ctx, probe, fits)
    sync(device)
    t1 = time.perf_counter()
    ctx["record"].update(probe.record)
    durations = clock.durations_s()
    return dict(steps=done, fits=fits_started, wall_s=t1 - t0, durations=durations,
                tracer=tracer, first_step_time=probe.first_step_time)


def end_to_end(ctx, win, setup_s):
    n = ctx["driver"].evals_a_step(ctx["traffic"])
    d = win["durations"]
    return {
        "evals_per_s": {"value": win["steps"] * n / win["wall_s"], "unit": "evals/s"},
        "step_ms_p95": {"value": 1e3 * float(np.percentile(d, 95)), "unit": "ms"},
        "setup_s": {"value": setup_s, "unit": "s"},
    }


def per_layer(cell, ctx, win):
    tr = win["tracer"]
    if tr.pending:
        raise RuntimeError("the window ended before the traced stretches")
    d = win["durations"]
    lo, hi = Tracer.STRETCHES[0][0], Tracer.STRETCHES[-1][1]
    plain = [s for i, s in enumerate(d) if not lo - 1 <= i <= hi]
    trace = tr.traces[0]
    first, end, _ = Tracer.STRETCHES[1]
    rctx = dict(trace=trace, steps=PROFILE_STEPS, window_s=tr.windows[0],
                host_trace=tr.traces[1], host_steps=end - first,
                busy_s=busy_ns(trace["ops"]) * 1e-9,
                step_s=statistics.median(plain) if plain else None,
                shapes=cell["system"].shapes(ctx["cfg"], ctx["traffic"]))
    out = {}
    for m in cell["per_layer"]:
        reader = load_module("metrics", m["name"])
        value = reader.read(rctx, lambda name=m["name"]: list_file(name))
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out, rctx


def list_file(name):
    path = ROOT / "metrics" / f"{name}.txt"
    return [ln.strip() for ln in path.read_text().splitlines()
            if ln.strip() and not ln.startswith("#")]


def check_lines(numbers, limits):
    return {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}


def load_library(device):
    """Finds, or in a checkout's first run builds, and loads the program's
    kernel library ahead of its first use, so that set-up can report it."""
    if device.type == "cuda":
        from gigalens_tpu_torch.ops.cuda import _build

        _build.load()


def run(cell, seed, seconds, trace, device, t_start, overrides=None):
    """A whole run after the look for the card: returns the result dict
    (the last line's object) and the lines for standard error.

    ``setup_s`` runs from ``t_start`` (the process's start) to the first
    timed step; its parts are reported beside it: ``imports_s`` (to this
    call), ``library_s`` (the kernel library found and loaded, or built in a
    checkout's first run), ``data_s`` (the seed's data, the program's model
    and simulator), ``warmup_s`` (the cell's shapes warmed up)."""
    marks = [("imports_s", time.time())]
    load_library(device)
    marks.append(("library_s", time.time()))
    ctx = prepare(cell, seed, device, overrides)
    marks.append(("data_s", time.time()))
    warm = dict(ctx, seed=f"{seed}/warmup")
    window(warm, max_steps=WARMUP_STEPS)
    if trace:
        Tracer().prime()
    win = window(ctx, seconds=seconds, trace=trace)
    marks.append(("warmup_s", win["first_step_time"]))
    setup_s = win["first_step_time"] - t_start
    parts, last = {}, t_start
    for name, t in marks:
        parts[name], last = t - last, t
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated()
        kind = torch.cuda.get_device_name(0)
    else:
        peak, kind = 0, "cpu"
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind, "count": 1,
           "memory_peak_bytes": int(peak)}
    result = {"attempted": win["steps"] * ctx["driver"].evals_a_step(ctx["traffic"])}
    if trace:
        metrics, rctx = per_layer(cell, ctx, win)
        dev.update(busy_s=rctx["busy_s"], window_s=rctx["window_s"])
        result["breakdown"] = breakdown(*win["tracer"].traces)
    else:
        metrics = end_to_end(ctx, win, setup_s)
    ctx["prob"] = ctx["sim"] = ctx["probe"] = warm = win["tracer"] = None
    numbers, n_rows = ctx["driver"].check(ctx)
    limits = cell["limits"]
    numbers = {k: v for k, v in numbers.items() if k in limits}
    failed = [k for k, v in numbers.items() if not (math.isfinite(v) and v <= limits[k])]
    result.update(correct=not failed, failed=len(failed), metrics=metrics, device=dev,
                  setup_parts=parts, check=check_lines(numbers, limits))
    lines = [f"window: {win['steps']} steps in {win['wall_s']:.3f} s over {win['fits']} fits; "
             f"{n_rows} rows compared",
             "set-up: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())]
    lines += [f"check {k}: {v:.6g} (limit {limits[k]})" for k, v in numbers.items()]
    return result, lines
