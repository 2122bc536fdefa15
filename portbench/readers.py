"""Reductions the per-layer metric readers share.  A reader gets the run's
`Context` and returns a number, or None where there is nothing to read."""

import statistics
from dataclasses import dataclass, field
from typing import Optional

from portbench import bounds, program
from portbench.trace import Trace


@dataclass
class Context:
    plan_s: float                  # optimize + compile, in set-up
    dispatch_s: list               # each window query: call -> return
    queries: int                   # queries in the window
    window_s: float                # the window, first call to last sync
    least_s: float                 # least seconds of one query (bounds.py)
    trace: Optional[Trace] = None  # the traced slice
    entry_bytes: dict = field(default_factory=dict)  # entry -> bytes/query
    entry_calls: dict = field(default_factory=dict)  # entry -> calls/query


def median_ms(xs) -> Optional[float]:
    return statistics.median(xs) * 1e3 if xs else None


def roofline(ctx: Context, kernel: str) -> Optional[float]:
    """The kernel's share of its roofline, in %: the least time for the bytes
    its entry points' calls need at the HBM rate, over the device time of
    those calls in the traced slice (the profiler's ranges of the calls,
    as it lays them out on the device).  None where the slice made no such
    call, or where the slice's calls do not match one query's calls times
    the queries traced (the bytes would not be those timed)."""
    t = ctx.trace
    if t is None:
        return None
    entries = [e for e, k in program.ENTRIES.items() if k == kernel]
    calls = sum(ctx.entry_calls.get(e, 0) for e in entries)
    if calls == 0:
        return None
    if any(t.entry_calls.get(e, 0) != ctx.entry_calls.get(e, 0) * t.queries
           for e in entries):
        return None
    seconds = sum(t.entry_s.get(e, 0.0) for e in entries)
    nbytes = sum(ctx.entry_bytes.get(e, 0) for e in entries) * t.queries
    if seconds <= 0 or nbytes <= 0:
        return None
    return 100.0 * bounds.least_seconds(nbytes) / seconds


def kernels_per_query(ctx: Context) -> Optional[float]:
    """Device operations in the traced slice over its queries."""
    t = ctx.trace
    if t is None or t.device_ops == 0:
        return None
    return t.device_ops / t.queries


def device_idle(ctx: Context) -> Optional[float]:
    """The share of the traced slice in which no operation ran on the
    device, in %."""
    t = ctx.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def step_mfu(ctx: Context) -> Optional[float]:
    """The whole query's share of the chip's peak, in %: one query's least
    time (bounds.least_seconds of its needed bytes and float64 operations)
    times the window's queries, over the window."""
    if ctx.window_s <= 0 or ctx.least_s <= 0:
        return None
    return 100.0 * ctx.least_s * ctx.queries / ctx.window_s
