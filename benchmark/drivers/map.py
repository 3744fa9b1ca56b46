"""The ``map`` driver: back-to-back multi-start MAP fits through the program's
``fit_map``, and the check of the first fit against the plain reference.

A traffic mix that names this driver (``"driver": "map"``) gives ``starts``
(rows a step), ``steps`` (a fit's Adam steps), ``lr`` (the step size's
first and last value), ``power`` (the decay's exponent), ``start_from``
(``"prior"``: prior draws; ``"truth"``: the seed's truth, with the
configuration's ``start`` values and per-group jitter), ``check_rows``
(rows the check compares) and ``check_steps`` (steps it follows).

Fit ``i`` draws its starts from the run's seed and ``i``. The optimizer is
the program's Adam under the traffic's power decay, behind an identity stage
that keeps the first fit's first gradients as the optimizer receives them.
"""
from __future__ import annotations

import hashlib
import math

import torch

import harness
from reference.plain import Adam, Precision


def evals_a_step(traffic):
    """Log densities with their gradient that one step evaluates."""
    return traffic["starts"]


def optimizer(traffic, record):
    """The recipe's optimizer (Adam under the traffic's power decay over
    the fit's steps, the program's own) behind an identity stage that keeps
    the first fit's first ``check_steps`` gradients as the optimizer
    receives them."""
    from gigalens_tpu_torch.inference import optim

    def init(params):
        return {"count": 0}

    def update(g, state, params=None):
        if state["count"] < traffic["check_steps"] and record.get("active"):
            record.setdefault("g", []).append(g.detach().clone())
        return g, {"count": state["count"] + 1}

    lr0, lr1 = traffic["lr"]
    return optim.chain(optim.GradientTransformation(init, update), optim.scale_by_adam(),
                       optim.scale_by_schedule(optim.polynomial_schedule(
                           -lr0, -lr1, traffic["power"], traffic["steps"])))


def starts(ctx, fit, n):
    """(n, d) float32 starts of fit ``fit``: prior draws, or the seed's truth
    with the configuration's start values and per-group jitter."""
    ref_prior, traffic, cfg = ctx["ref_prior"], ctx["traffic"], ctx["cfg"]
    gen = harness.generator(ctx["seed"], f"starts/{fit}", ctx["device"])
    if traffic["start_from"] == "prior":
        z = ref_prior.sample_z(gen, n)
    else:
        center = ctx["truth_z"].clone()
        scale = torch.zeros_like(center)
        start = cfg.get("start", {})
        for j, (g, i, name, dist) in enumerate(ref_prior.columns):
            v = start.get("values", {}).get(g, {}).get(name)
            if v is not None:
                center[j] = dist.inverse(torch.tensor(float(v), dtype=torch.float64))
            scale[j] = start.get("jitter", {}).get(g, 0.0)
        eps = torch.randn((n, center.shape[0]), generator=gen, device=ctx["device"],
                          dtype=torch.float64)
        z = center + scale * eps
    return z.to(torch.float32)


def drive(ctx, probe, fits):
    """Back-to-back fits of the traffic through the program's ``fit_map``
    until the probe closes the window; returns (steps finished, fits
    started)."""
    from gigalens_tpu_torch.inference import map as program_map

    traffic = ctx["traffic"]
    n, steps = traffic["starts"], traffic["steps"]
    record = ctx["record"]
    done = 0
    for fit in range(fits):
        probe.new_fit(fit)
        record["active"] = fit == 0
        z0 = starts(ctx, fit, n)
        if fit == 0:
            record["z0"] = z0
        before = probe.steps
        try:
            program_map.fit_map(probe, ctx["sim"], optimizer(traffic, record), start=z0,
                                n_samples=n, num_steps=steps)
        except harness.WindowClosed:
            return done + probe.steps - before, fit + 1
        done += probe.steps - before
    return done, fits


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------

def check_rows(seed, n, k):
    g = torch.Generator().manual_seed(int.from_bytes(
        hashlib.sha256(f"{int(seed)}/rows".encode()).digest()[:8], "little") >> 1)
    return torch.sort(torch.randperm(n, generator=g)[:min(k, n)]).values


def reference_record(ctx, rows, block=64):
    """The reference on the rows of the first fit: at the program's own
    parameters of each of its first ``check_steps`` steps, the log
    densities, their scales, the reduced chi2 and the gradient of the same
    loss as ``fit_map``'s (over the whole batch's count), also in the
    configuration's own precision (``g_f32``, float32 rounding's yardstick);
    and its own Adam's parameters after the steps, from the same starts
    under the same schedule."""
    traffic, cfg = ctx["traffic"], ctx["cfg"]
    ref = ctx["reference"].Reference(cfg, ctx["obs"], Precision("float64"), ctx["device"])
    ref32 = ctx["reference"].Reference(cfg, ctx["obs"], Precision("float32"), ctx["device"])
    norm = traffic["starts"] * ref.event_size
    rec = ctx["record"]
    out = {"lp": [], "scale": [], "red_chi2": [], "g": [], "g_f32": []}
    for k in range(traffic["check_steps"]):
        zk = rec["z"][k][rows]
        at = harness.evaluate(ref, zk.to(ref.precision.dtype), block)
        for key in ("lp", "scale", "red_chi2"):
            out[key].append(at[key])
        out["g"].append(-at["grad"] / norm)
        out["g_f32"].append(-harness.evaluate(ref32, zk.float(), block)["grad"].double() / norm)
    z = rec["z0"][rows].to(ref.precision.dtype)
    adam = Adam(traffic, z)
    for k in range(traffic["check_steps"]):
        g = out["g"][0] if k == 0 else -harness.evaluate(ref, z, block)["grad"] / norm
        z = z + adam.update(g)
    out["zK"] = z
    return out


def program_rows(ctx, rows):
    rec, K = ctx["record"], ctx["traffic"]["check_steps"]
    if len(rec["z"]) <= K or len(rec.get("g", [])) < K:
        raise RuntimeError(f"the first fit recorded {len(rec['z'])} steps, the check needs "
                           f"{K + 1}")
    return {"lp": [rec["lp"][k][rows].double() for k in range(K)],
            "red_chi2": [rec["chi"][k][rows].double() for k in range(K)],
            "g": [rec["g"][k][rows].double() for k in range(K)],
            "zK": rec["z"][K][rows].double()}


def _norm_gaps(a, b, keep=None):
    """Per row |‖a‖ - ‖b‖| / max(‖b‖, median ‖b‖), ``b`` the reference;
    rows outside ``keep`` are left out."""
    na, nb = torch.linalg.vector_norm(a, dim=1), torch.linalg.vector_norm(b, dim=1)
    if keep is not None:
        na, nb = na[keep], nb[keep]
    return torch.abs(na - nb) / torch.clamp(nb, min=float(torch.median(nb)))


NUMBERS = ("loss_gap", "chi2_gap", "grad_gap", "grad_excess", "change_gap")


def grad_excess(gp, gr, g32):
    """The program's gradient error in units of float32 rounding: per
    parameter, the median over rows of |program - reference| over the median
    over rows of |reference in its own float32 - reference|; the median over
    the parameters. The two float32 computations of the same equations err
    alike from seed to seed, so the ratio stays near 1 where each error
    alone varies with the data."""
    e = torch.median(torch.abs(gp - gr), dim=0).values
    e32 = torch.median(torch.abs(g32 - gr), dim=0).values
    return float(torch.median(e / torch.clamp(e32, min=torch.finfo(e32.dtype).tiny)))


def compare(prog, ref, z0):
    """The check's numbers, program against reference on the same rows, over
    the first ``check_steps`` steps at the program's own parameters (each
    the largest over the steps):

    * ``loss_gap``: the largest gap of a row's log density, relative to the
      sum of its terms' magnitudes;
    * ``chi2_gap``: the largest gap of a row's reduced chi2, relative;
    * ``grad_gap``: the largest gap of the norm of a row's gradient as the
      optimizer receives it, relative to the larger of the row's reference
      norm and the median row's;
    * ``grad_excess``: the rows' gradient error in units of float32
      rounding (:func:`grad_excess`);
    * ``change_gap``: the largest gap of the norm of a row's parameter change
      over the steps against the reference's own steps from the same
      starts, relative as ``grad_gap``. Rows whose reference gradient is
      under a thousandth of the median row's move by round-off alone and are
      left out.

    A row finite on one side only reads infinite."""
    fin = torch.isfinite(ref["lp"][0])
    n = int(fin.sum())
    inf = dict.fromkeys(NUMBERS, math.inf)
    out = dict.fromkeys(NUMBERS, 0.0)
    for k in range(len(ref["lp"])):
        for key in ("lp", "red_chi2"):
            if not (torch.equal(torch.isfinite(prog[key][k]), fin)
                    and torch.equal(torch.isfinite(ref[key][k]), fin)):
                return inf, 0
        gp, gr = prog["g"][k][fin], ref["g"][k][fin]
        if not all(bool(torch.isfinite(t).all()) for t in (gp, gr, ref["g_f32"][k][fin])):
            return inf, n
        gaps = dict(
            loss_gap=torch.abs(prog["lp"][k][fin] - ref["lp"][k][fin]) / ref["scale"][k][fin],
            chi2_gap=(torch.abs(prog["red_chi2"][k][fin] - ref["red_chi2"][k][fin])
                      / ref["red_chi2"][k][fin]),
            grad_gap=_norm_gaps(gp, gr))
        for key, g in gaps.items():
            out[key] = max(out[key], float(g.max()) if g.numel() else 0.0)
        out["grad_excess"] = max(out["grad_excess"],
                                 grad_excess(gp, gr, ref["g_f32"][k][fin]))
    ng = torch.linalg.vector_norm(ref["g"][0][fin], dim=1)
    change = _norm_gaps(prog["zK"][fin] - z0[fin], ref["zK"][fin] - z0[fin],
                        ng >= 1e-3 * torch.median(ng))
    out["change_gap"] = float(change.max()) if change.numel() else 0.0
    return out, n


def check(ctx):
    """(numbers, rows compared): the program's record of the first fit
    against the reference on a sample of rows drawn from the seed, the
    reference's products in full float32 or float64 (TF32 off)."""
    rows = check_rows(ctx["seed"], ctx["traffic"]["starts"],
                      ctx["traffic"]["check_rows"]).to(ctx["device"])
    prog = program_rows(ctx, rows)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            ref = reference_record(ctx, rows)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
    return compare(prog, ref, ctx["record"]["z0"][rows].double())
