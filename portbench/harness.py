"""One run of one cell: set-up, the measured window, the traced slice, the
judgement of the window's answers against the plain reference, and the
result line.

Set-up: the program's kernels built or loaded, the cell's tables made on
the device from the seed, the query's flow optimized and compiled, the
query run `warmup_queries` times.  The window: one query stream in a
closed loop (the next query starts when the last has returned and the
device has synchronised), `CompiledPlan.run_device` on the resident
tables, for `seconds`.  A seeded reservoir keeps `kept_answers` of the
window's answers; once the window has closed, the program is dropped and
the plain reference answers the same query on the same tables."""

import random
import statistics
import sys
import time

import torch

from portbench import bounds, judge, program, trace
from portbench.readers import Context

BANNED = ("jax", "jaxlib", "flax", "repro")
GIB = 2.0 ** 30


def banned_modules() -> list:
    """Loaded modules whose top-level name is one the run may not import."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in BANNED)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def make_tables(query, rows: dict, seed: int, dev):
    """(padded, real): the query's tables from `seed`, each column in a
    zero-padded buffer of the program's capacity for its table; `real`
    holds the views of the real rows, which the reference reads."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    padded: dict = {}

    def new(table, col, n, dtype):
        buf = torch.zeros(program.capacity(n), dtype=dtype, device=dev)
        padded.setdefault(table, {})[col] = buf
        return buf[:n]

    real = query.generate(rows, gen, dev, new)
    return padded, real


class Reservoir:
    """A uniform sample of `k` of a stream's items, drawn from a seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items, self.seen = k, random.Random(seed), [], 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def p95(xs) -> float:
    return statistics.quantiles(xs, n=20, method="inclusive")[-1] \
        if len(xs) > 1 else xs[0]


def run(cell, seed: int, seconds: float, traced: bool, device="cuda",
        rows: dict = None, t_start: float = None, log=sys.stderr) -> dict:
    """One run of `cell`; returns the result line as a dict.  `rows`
    replaces the configuration's table sizes (the harness's own tests run
    small tables on the CPU)."""
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    traffic, query = cell.traffic, cell.query()
    if traffic["loop"] != "closed" or int(traffic["streams"]) != 1:
        raise ValueError(f"{cell.name}: the harness drives one closed-loop "
                         f"query stream, not {traffic['streams']} "
                         f"{traffic['loop']}")
    rows = rows or cell.rows()
    if dev.type == "cuda":
        program.build_kernels()
    padded, tables = make_tables(query, rows, seed, dev)
    flow = cell.flow().build(rows)
    t = time.perf_counter()
    plan, order = program.plan(flow, dev)
    plan_s = time.perf_counter() - t
    print(f"plan: {order}", flush=True)
    masked = program.bind(padded, rows)
    for _ in range(int(traffic["warmup_queries"])):
        plan.run_device(masked)
        _sync(dev)
    setup_s = time.perf_counter() - t_start
    if dev.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    # the measured window
    kept = Reservoir(int(traffic["kept_answers"]), seed)
    lat, disp = [], []
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        out = plan.run_device(masked)
        b = time.perf_counter()
        _sync(dev)
        c = time.perf_counter()
        lat.append(c - a)
        disp.append(b - a)
        kept.offer(out)
        if c - t0 >= seconds:
            break
    window_s = c - t0
    del out
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    tr, entry_bytes, entry_calls = None, {}, {}
    if traced:
        with program.Entries("bytes") as acc:
            plan.run_device(masked)
            _sync(dev)
        entry_bytes, entry_calls = acc.nbytes, acc.calls
        tr = trace.profile(lambda: plan.run_device(masked),
                           int(traffic["trace_queries"]),
                           sync=lambda: _sync(dev))

    # the program's state goes; its answers and the tables stay
    del plan, masked
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    want = query.reference(tables)
    keys = query.KEYS
    readings = [judge.compare(program.answer(o), want, keys)
                for o in kept.items]
    limits = traffic["limits"]
    numbers = judge.worst(readings)
    failed = sum(not judge.passes(r, limits) for r in readings)
    correct = bool(readings) and failed == 0
    answer_rows = int(want[keys[0]].shape[0])
    nbytes, f64_ops = query.least_work(tables, answer_rows)
    least_s = bounds.least_seconds(nbytes, f64_ops)
    n_fact = rows[query.FACT]

    queries = len(lat)
    if traced:
        ctx = Context(plan_s=plan_s, dispatch_s=disp, queries=queries,
                      window_s=window_s, least_s=least_s, trace=tr,
                      entry_bytes=entry_bytes, entry_calls=entry_calls)
        values = {m: cell.reader(m).read(ctx) for m in cell.per_layer}
    else:
        values = {"rows_per_s": n_fact * queries / window_s,
                  "query_ms.p95": p95(lat) * 1e3,
                  "peak_gib": peak / GIB, "setup_s": setup_s}
        # `<quantity>.<suffix>` is the quantity, split so that cells that
        # spread differently get bounds of their own
        values = {m: values.get(m, values.get(m.rsplit(".", 1)[0]))
                  for m in cell.end_to_end}
    metrics = {m: {"value": v, "unit": cell.units[m]}
               for m, v in values.items() if v is not None}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1,
                   "memory_peak_bytes": (max(peak, setup_peak)
                                         if dev.type == "cuda" else 0)}
    result = {"correct": correct, "attempted": queries, "failed": failed,
              "metrics": metrics, "device": device_info}
    if tr is not None:
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": trace.top(tr.by_op),
                               "idle_gaps": trace.top(tr.gaps)}
    print(f"window: {queries} queries in {window_s:.3f} s; query ms median "
          f"{statistics.median(lat) * 1e3:.3f}; answers judged "
          f"{len(readings)}; fact rows {n_fact}; answer rows {answer_rows}; "
          f"least bytes a query {nbytes}", file=log, flush=True)
    result["checks"] = {k: {"value": numbers.get(k), "limit": limits.get(k)}
                        for k in sorted(set(numbers) | set(limits))}
    return result
