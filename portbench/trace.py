"""The traced slice of a run and what is read from it.

A bounded number of queries runs under `torch.profiler` (host and device
activity), with each kernel entry point of the program inside a range of
its own (`program.Entries("ranges")`) and the whole slice inside
`portbench.slice`.  Nothing is written to disk: the events are reduced
in memory."""

from dataclasses import dataclass, field

import torch

from portbench import program

SLICE = "portbench.slice"


@dataclass
class Trace:
    queries: int             # queries in the traced slice
    window_s: float          # the slice, first call to last synchronise
    busy_s: float            # union of the device's operation intervals
    device_ops: int          # device operations (kernels, copies, sets)
    by_op: dict = field(default_factory=dict)      # device op -> seconds
    entry_s: dict = field(default_factory=dict)    # entry -> its device ranges, s
    entry_calls: dict = field(default_factory=dict)
    gaps: dict = field(default_factory=dict)       # host activity -> idle s


def merged(spans) -> list:
    """(start, end) intervals merged where they overlap, in order."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union(spans) -> float:
    """The length of the union of (start, end) intervals."""
    return sum(e - s for s, e in merged(spans))


def _host_at(cpu, t: float, thread) -> str:
    """The innermost host event on `thread` that covers time `t` (us);
    inside the slice's own range and no other, the host runs Python."""
    best, width = "python", float("inf")
    for e in cpu:
        if e.thread == thread and e.name != SLICE and \
                e.time_range.start <= t < e.time_range.end:
            w = e.time_range.end - e.time_range.start
            if w < width:
                best, width = e.name, w
    return best


def profile(step, queries: int, sync=torch.cuda.synchronize) -> Trace:
    """Run `step()` `queries` times under the profiler, each call followed
    by `sync()`, and reduce the events."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with program.Entries("ranges") as entries:
        with torch_profile(activities=acts) as prof:
            with torch.profiler.record_function(SLICE):
                for _ in range(queries):
                    step()
                    sync()
    events = prof.events()
    # the device's operations; the profiler also lays each range out on
    # the device, from its first operation's start to its last one's end
    on_dev = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev = [e for e in on_dev if not e.name.startswith("portbench.")]
    cpu = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU]
    sl = [e for e in cpu if e.name == SLICE]
    if not sl:
        raise RuntimeError("the profiler recorded no slice range")
    lo, hi = sl[0].time_range.start, sl[0].time_range.end
    spans = [(max(e.time_range.start, lo), min(e.time_range.end, hi))
             for e in dev if e.time_range.end > lo and e.time_range.start < hi]
    by_op: dict = {}
    for e in dev:
        by_op[e.name] = by_op.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) * 1e-6
    entry_s: dict = {}
    for e in on_dev:
        if e.name.startswith(program.RANGE):
            name = e.name[len(program.RANGE):]
            entry_s[name] = entry_s.get(name, 0.0) + (
                e.time_range.end - e.time_range.start) * 1e-6
    # idle gaps inside the slice, named by what the slice's thread was
    # doing when each began
    gaps: dict = {}
    busy = merged(spans)
    edges = [lo] + [x for s in busy for x in s] + [hi]
    idle = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)), reverse=True)
    for width, start in idle[:50]:
        if width <= 0:
            break
        name = _host_at(cpu, start, sl[0].thread)
        gaps[name] = gaps.get(name, 0.0) + width * 1e-6
    return Trace(queries=queries, window_s=(hi - lo) * 1e-6,
                 busy_s=union(spans) * 1e-6, device_ops=len(spans),
                 by_op=by_op, entry_s=entry_s,
                 entry_calls=dict(entries.calls), gaps=gaps)


def top(d: dict, k: int = 10) -> list:
    """The `k` largest entries of {name: seconds}, as [name, seconds]."""
    return [[n, v] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:k]]
