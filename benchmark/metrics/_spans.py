"""Shared by the per-layer readers of the port's spans (``utils.profiling.span``
ranges): who launched each device operation of the host-traced stretch, and
the device's idle gap before it.

An operation is matched by its correlation id to its launch, a runtime
(``cuda*``) or driver (``cu*``) call on the host. Its owner is the innermost
program span whose host interval holds the launch: of every thread's spans
that do, the one that started last, so that a span which autograd's device
thread opens while ``map.backward`` waits on the calling thread owns what it
launches. Program spans are the names that start with a line of a span
metric's list file (``<layer>_launches.txt``, ``<layer>_idle_ms.txt``); an
operation launched outside all of them has no owner and counts to no layer.
The idle gap that ends at an operation (from the latest end of the
operations before it to its start) is charged to that operation's owner."""
import bisect
from pathlib import Path

import harness

LISTS = ("*_launches.txt", "*_idle_ms.txt")


def program_prefixes():
    here = Path(__file__).resolve().parent
    return sorted({p for pattern in LISTS for f in here.glob(pattern)
                   for p in harness.list_file(f.stem)})


def owners(ctx):
    """[(owner's name or None, idle ns before the operation)] over the
    device operations of the host-traced stretch, in start order; computed
    once a run."""
    if "span_owners" in ctx:
        return ctx["span_owners"]
    trace, prefixes = ctx["host_trace"], tuple(program_prefixes())
    launches = {corr: t0 for name, t0, _, corr in trace["host"]
                if corr and name.startswith("cu")}
    # nested spans that start together: the shorter (inner) one sorts last
    spans = sorted(((t0, -t1, name) for name, t0, t1, _ in trace["host"]
                    if name.startswith(prefixes)))
    starts = [s[0] for s in spans]
    out, end = [], None
    for _, t0, t1, corr in trace["ops"]:
        owner, t = None, launches.get(corr)
        if t is not None:
            for s0, neg_s1, name in reversed(spans[:bisect.bisect_right(starts, t)]):
                if -neg_s1 >= t:
                    owner = name
                    break
        out.append((owner, t0 - end if end is not None and t0 > end else 0))
        end = t1 if end is None else max(end, t1)
    ctx["span_owners"] = out
    return out


def _layer(ctx, prefixes):
    """The operations owned by spans named from ``prefixes``, or None where
    the stretch has no such span (a program without it)."""
    prefixes = tuple(prefixes)
    if not any(name.startswith(prefixes) for name, _, _, _ in ctx["host_trace"]["host"]):
        return None
    return [gap for owner, gap in owners(ctx) if owner is not None and owner.startswith(prefixes)]


def launches(ctx, prefixes):
    """Device operations a step launched inside the layer's spans."""
    mine = _layer(ctx, prefixes)
    return None if mine is None else len(mine) / ctx["host_steps"]


def idle_ms(ctx, prefixes):
    """Device idle ms a step in the gaps that end at the layer's operations."""
    mine = _layer(ctx, prefixes)
    return None if mine is None else sum(mine) * 1e-6 / ctx["host_steps"]
