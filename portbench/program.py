"""Everything the benchmark takes from the program under test,
`repro_torch`: the optimizer and the compiled plan, the masked batch it
runs on, and the kernel entry points of `repro_torch.kernels.ops`, which
the traced run wraps to count their bytes and to mark their calls.
Nothing else of the benchmark imports the program."""

import inspect
import threading

import torch

from portbench import bounds

# the data-flow kernels the benchmark's rooflines read: entry point of
# `repro_torch.kernels.ops` -> the kernel (`csrc/*.cu`) it launches
ENTRIES = {"sorted_probe": "sorted_probe", "probe_positions": "sorted_probe",
           "segment_reduce": "segmented_scan",
           "segmented_scan": "segmented_scan",
           "span_compact": "span_compact", "span_segment": "span_segment"}
KERNELS = ("sorted_probe", "segmented_scan", "span_compact", "span_segment")
RANGE = "portbench.ops."   # the profiler range around an entry's call


def build_kernels() -> None:
    """Build (first run in a checkout) or load the data-flow kernels."""
    from repro_torch.kernels import build

    for name in KERNELS:
        build.library(name)


def capacity(n: int) -> int:
    """The slots the program pads a source of `n` rows to."""
    from repro_torch.core.masked import bucket_capacity

    return bucket_capacity(max(n, 1))


def plan(root, device):
    """(compiled plan, the chosen order of operators): the optimizer's best
    plan, compiled with the kernels, on `device`."""
    from repro_torch.core.optimizer import optimize

    best = optimize(root).best
    return best.compile(use_kernels=True, device=device), best.order()


def bind(padded: dict, rows: dict) -> dict:
    """Device-resident masked batches of the padded tables, as the program's
    own binding lays them out: columns padded with zeros to the capacity,
    the first `rows[table]` slots valid (the compiled plan adds each
    source's declared order itself)."""
    from repro_torch.core.masked import MaskedBatch

    out = {}
    for table, cols in padded.items():
        first = next(iter(cols.values()))
        valid = torch.arange(first.shape[0], device=first.device) < rows[table]
        out[table] = MaskedBatch(dict(cols), valid, ())
    return out


def answer(out) -> dict:
    """The valid rows of a query's answer: {column: tensor}."""
    keep = out.valid
    return {c: t[keep] for c, t in out.columns.items()}


def _entry_bytes(name: str, args: dict) -> int:
    """The least bytes of one entry-point call (bounds.py), from its
    arguments; reads the valid counts off the device."""
    if name in ("sorted_probe", "probe_positions"):
        k, q = args["keys_sorted"], args["queries"]
        out = 4 if name == "sorted_probe" else 8
        return bounds.probe_bytes(k.shape[0], q.shape[0], k.element_size(),
                                  out)
    if name == "segment_reduce":
        return bounds.reduce_bytes(args["values"], int(args["num_segments"]),
                                   args.get("valid") is not None)
    if name == "segmented_scan":
        return bounds.scan_bytes(args["values"])
    valid = args["valid"]
    count = int(valid.sum())
    if name == "span_compact":
        return bounds.compact_bytes(list(args["columns"]), valid.shape[0],
                                    int(args["capacity"]), count)
    return bounds.segment_bytes(list(args["keys"]), valid.shape[0], count)


class Entries:
    """Wraps the kernel entry points of `repro_torch.kernels.ops` while it is
    entered.  mode "bytes": each call adds its least bytes to `nbytes` and
    one to `calls`, by entry point.  mode "ranges": each call runs inside a
    profiler range `portbench.ops.<entry>`.  A call made from inside
    another wrapped call is not counted again."""

    def __init__(self, mode: str):
        self.mode = mode
        self.nbytes = {e: 0 for e in ENTRIES}
        self.calls = {e: 0 for e in ENTRIES}
        self._inside = threading.local()

    def __enter__(self):
        from repro_torch.kernels import ops

        self._real = {e: getattr(ops, e) for e in ENTRIES}
        for e, fn in self._real.items():
            setattr(ops, e, self._wrap(e, fn))
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        for e, fn in self._real.items():
            setattr(ops, e, fn)
        return False

    def _wrap(self, name: str, real):
        sig = inspect.signature(real)

        def call(*a, **k):
            if getattr(self._inside, "on", False):
                return real(*a, **k)
            self._inside.on = True
            try:
                self.calls[name] += 1
                if self.mode == "bytes":
                    bound = sig.bind(*a, **k)
                    bound.apply_defaults()
                    self.nbytes[name] += _entry_bytes(name, bound.arguments)
                    return real(*a, **k)
                with torch.profiler.record_function(RANGE + name):
                    return real(*a, **k)
            finally:
                self._inside.on = False
        return call

