"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only probe,flash   # build + those checks only
    python3 chip_smoke.py --only dataflow      # build + flows, timing, profile

Drives the port's main paths through the hand-written CUDA kernels
(`src/repro_torch/csrc/`): the data-flow path — flow build + SCA ->
optimize -> compile(use_kernels=True) -> CompiledPlan.run / run_device — for
the paper's four evaluation flows at serving scale, on the default
megakernel route and on the composed route, every result checked against
the port's eager numpy executor; and token serving — Engine ->
Model.prefill / decode_step — at full width and depth for three models:
qwen3-0.6b with the flash-attention kernel, rwkv6-3b with the rwkv6_scan
kernel and recurrentgemma-2b with the linear_scan kernel.  Phases, one or
more lines each:

  device   the card's name and power limit (nvidia-smi), first line
  build    the seven kernels built from the checkout with nvcc (one nvcc
           per source, in parallel), ptxas lines
  kernels  each kernel against its plain torch version on the card;
           sorted_probe and probe_positions exactly at q15's probe size
           and larger, timed in turns against torch.searchsorted;
           segmented_scan at 8,388,608 rows and segment_reduce with gappy
           ids and a mask as q15 calls it, over one segment spanning every
           tile, at n = 1 and a tile either side, all rows invalid, empty
           ids before, between and after the rows, and float64 sums over
           segments of three tiles or more bit for bit equal over two
           calls; the span kernels bitwise on every slot at 8,388,608 rows
           (span_compact for up to 32 columns); segmented_scan and
           span_compact one device kernel a call, as the profiler counts;
           flash
           attention at the reference test's seven shapes and the served
           shapes (as the prefill lays them out, [B,T,H,D] memory), timed
           against the plain version and SDPA, with a bound; the probe's
           and flash's rows carry the profiler's device time beside the
           CUDA-event time;
           rwkv6_scan and linear_scan at the reference test's shapes, at
           the edges of their tilings (T = 0, 1 and a step either side of
           a chunk or slab, Dk 16 and 128 with Dv 256, a Dv or D off the
           tile) with decays over [1e-6, 1] including 0 and 1 or gates
           near 0 and near 1 (rwkv6_scan's final state bit for bit equal
           over two calls), and at the served shapes, with and without a
           state, timed against the plain version, with a bound and the
           profiler's device time beside the CUDA-event time
  flows    q15 (6M lineitem rows), q7 (1M), clickstream (16M), textmining
           (1M), each through run and through bind_device + run_device on
           the megakernel route (the default) and the composed route
           (use_megakernel=False): all equal to the eager executor, mega
           equal to composed bit for bit; every kernel call on the way held
           against the kernel's plain version on its own inputs; the routes
           and the CUDA launches per kernel and route
  timing   warm run / run_device of q15 on both routes, taken in turns;
           each kernel at the shapes q15 gives it: time, the profiler's
           device time and device kernels a call, plain time, library-call
           time and bound
  profile  torch.profiler over a warm q15 run_device on each route: device
           kernels per step, device busy time, idle share against the
           unprofiled step time, top device ops, repo-kernel time; then
           q15's and q7's device kernels per step on each route with the
           join probe as one launch and, in turns, as the parent tree's
           four (search, cast, maximum, clamp)
  serve    qwen3-0.6b (28 layers, d_model 1024, f32 weights, bf16
           activations, attn_impl="flash") from a seeded generator; 8
           requests of 1024-2048 prompt tokens and 32 greedy new tokens
           through Engine(batch_slots=4, max_seq=2080), every flash call
           held against the plain attention; the prefill's last-token
           logits against the same weights with plain attention; then a
           timed run (tokens/s, prefill ms per chunk, decode ms per step)
           and a profiled decode step (device busy time, idle share)
  serve_rwkv6-3b, serve_recurrentgemma-2b
           the same 8 requests through rwkv6-3b (32 layers, d_model 2560,
           40 heads x 64) and recurrentgemma-2b (26 layers, RG-LRU width
           2560, local window 2048), f32 weights, bf16 activations,
           Model(use_kernel=True): every rwkv6_scan / linear_scan call held
           against the plain recurrence on its inputs, the launches counted
           (one per recurrent layer and prefill), the timed run, the
           kernel's event ms and device us at the first prefill's shape; the
           prefill's last-token logits against use_kernel=False on the same
           weights, within LOGIT_TOL with float32 activations and, with the
           served bf16 activations, no farther from the float32 logits
           than twice the plain path; the profiled decode step as for
           qwen3-0.6b

The line before the last is a JSON object of the kernels' numbers, the last
`{"ok": true, "device": {...}}`.  Any failed phase, a missing CUDA device or
a missing checkout makes the script exit non-zero without that last line.
Long tables go to `chiprun_out/smoke/`.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "smoke")

# H100 SXM published peaks (NVIDIA data sheet) for the roofline bound
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12  # non-tensor-core rate; int64 and f32 work
BF16_TENSOR_OPS_PER_S = 989e12  # dense bf16 tensor-core rate

FLOW_ROWS = {"q15": 6_000_000, "q7": 1_000_000, "clickstream": 16_000_000,
             "textmining": 1_000_000}
FLOW_SOURCE = {"q15": "lineitem", "q7": "lineitem", "clickstream": "clicks",
               "textmining": "docs"}
SCAN_TOL = 1e-9  # relative, float64 add: summation order differs from plain
KERNEL_SOURCES = {
    "sorted_probe": ("src/repro_torch/csrc/sorted_probe.cu",
                     "src/repro/kernels/sorted_probe.py:63"),
    "segmented_scan": ("src/repro_torch/csrc/segmented_scan.cu",
                       "src/repro/kernels/segmented_scan.py:83"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:112"),
    "span_compact": ("src/repro_torch/csrc/span_compact.cu",
                     "src/repro/kernels/megakernel.py:313"),
    "span_segment": ("src/repro_torch/csrc/span_segment.cu",
                     "src/repro/kernels/megakernel.py:313"),
    "rwkv6_scan": ("src/repro_torch/csrc/rwkv6_scan.cu",
                   "src/repro/kernels/rwkv6_scan.py:69"),
    "linear_scan": ("src/repro_torch/csrc/linear_scan.cu",
                    "src/repro/kernels/linear_scan.py:57"),
}
# the data-flow path's kernels
DATA_KERNELS = ("sorted_probe", "segmented_scan", "span_compact",
                "span_segment")
SPAN_KERNELS = ("span_compact", "span_segment")
# (the parent tree's tile_reduce / tile_carries / tile_apply and
# compact_count / compact_scatter stay on the list, so the profile phase
# tallies them when this script measures that tree)
REPO_KERNELS = ("probe_kernel", "segscan_lookback", "compact_lookback",
                "tile_reduce", "tile_carries", "tile_apply",
                "compact_count", "compact_scatter", "block_offsets",
                "segment_count", "segment_write", "flash_bf16", "flash_f32",
                "wkv6_kernel", "linear_scan_kernel")
# the routes the default span budget gives at these sizes
EXPECTED_ROUTES = {"q15": (("mega", 0, 4),), "q7": (("mega", 0, 7),),
                   "clickstream": (("mega", 0, 4),), "textmining": None}
ROUTES = ("mega", "composed")
SPAN_ROWS = 8_388_608  # q15's lineitem capacity at 6M rows

# token serving: qwen3-0.6b at full width and depth
SERVE_ARCH = "qwen3-0.6b"
SERVE_SEED = 0
SERVE_REQUESTS, SERVE_SLOTS, SERVE_NEW = 8, 4, 32
SERVE_PROMPT = (1024, 2048)        # prompt lengths, drawn from the seed
SERVE_MAX_SEQ = 2080               # longest prompt + new tokens fits
# flash kernel vs plain attention, per call: tests/test_kernels.py's limits
ATTN_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# prefill last-token logits, kernel path vs plain attention, same weights:
# both run 28 bf16 layers and round attention outputs differently (the
# kernel feeds P to P.V in bf16), so they agree to bf16 drift, not bits
LOGIT_TOL = 5e-2
# token serving through the recurrent families, same requests and engine
RECURRENT_ARCHS = ("rwkv6-3b", "recurrentgemma-2b")
SCAN_KERNEL = {"rwkv6": "rwkv6_scan", "hybrid": "linear_scan"}
# rwkv6_scan against the sequential plain recurrence on the same inputs:
# float32 outputs to tests/test_kernels.py's 3e-4 (summation order only);
# bf16 outputs are both rounded from float32 sums of another order, one
# bf16 step apart at most, held as ATTN_TOL holds bf16 attention
RWKV_TOL = {torch.bfloat16: 2e-2, torch.float32: 3e-4}
RWKV_STATE_TOL = 3e-4   # the float32 final state: summation order only
LSCAN_TOL = 1e-4        # linear_scan, float32: tests/test_kernels.py's
# (B, H, T, Dk, Dv) and (G, T, D): tests/test_kernels.py:76-79 and :104
RWKV_TEST_SHAPES = [(1, 2, 64, 16, 16), (2, 1, 128, 32, 64),
                    (1, 1, 256, 64, 64)]
LSCAN_TEST_SHAPES = [(2, 64, 8), (1, 500, 16), (3, 256, 128)]
# the edges of the scans' tilings (csrc/rwkv6_scan.cu: 32-column tiles,
# chunks of 16 steps at Dk 32/64, 8 at Dk 128, 32 at Dk 16, outputs flushed
# every 8 steps; csrc/linear_scan.cu: 32-channel tiles, 64-step slabs):
# T = 0, 1 and a step either side of a chunk or slab, Dk 128 with Dv 256
# and Dk 16, Dv not a multiple of the column tile
RWKV_EDGE_SHAPES = [(1, 2, 0, 64, 64), (1, 2, 1, 64, 64),
                    (1, 2, 15, 64, 64), (2, 1, 17, 64, 40),
                    (1, 2, 9, 128, 256), (1, 1, 7, 128, 256),
                    (2, 3, 33, 16, 40), (1, 2, 31, 16, 8),
                    (1, 1, 50, 32, 72)]
LSCAN_EDGE_SHAPES = [(2, 1, 8), (1, 63, 100), (3, 64, 100), (2, 65, 8),
                     (1, 129, 2560)]
# (B, Hq, Hkv, T, S, D), causal, window, dtype: tests/test_kernels.py:55-63
ATTN_TEST_SHAPES = [
    ((1, 4, 2, 128, 128, 64), True, None, torch.float32),
    ((2, 8, 8, 64, 64, 32), True, None, torch.bfloat16),
    ((1, 4, 1, 128, 256, 64), True, None, torch.float32),
    ((1, 2, 2, 96, 96, 64), True, 32, torch.float32),
    ((1, 2, 2, 64, 64, 128), False, None, torch.float32),
    ((1, 4, 2, 1, 128, 64), True, None, torch.float32),
    ((1, 1, 1, 256, 256, 64), True, 128, torch.bfloat16),
]


def say(phase: str, msg: str) -> None:
    print(f"phase {phase}: {msg}", flush=True)


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean device time of `fn()` over `reps` calls, by CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_profile(fn, reps: int = 20) -> tuple:
    """(device time per call of `fn()` in us, device kernels per call):
    the device kernels of `reps` calls under torch.profiler, summed, over
    the calls it recorded.  The profiler now and then drops a share of a
    run's kernels; every call launches the same kernels, so the fewest
    launches of any one kernel name is the number of calls it kept (at
    most `reps`), and a name launched twice a call counts twice.  (None,
    None) when it records nothing.  Beside `cuda_ms` the time tells
    whether the card or the host sets a call's pace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then records nothing
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total, count = 0.0, {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                total += e.time_range.end - e.time_range.start
                count[e.name] = count.get(e.name, 0) + 1
        if count:
            kept = min(min(count.values()), reps)
            return total / kept, sum(round(c / kept) for c in count.values())
    return None, None


def device_us(fn, reps: int = 20):
    """Device time per call of `fn()` in us (`device_profile`)."""
    return device_profile(fn, reps)[0]


def one_kernel(name: str, fn, reps: int = 5) -> float:
    """`fn()`'s device us; raises unless one call makes exactly one device
    kernel, as the profiler counts them."""
    us, kernels = device_profile(fn, reps)
    if kernels != 1:
        raise AssertionError(f"{name}: {kernels} device kernels a call "
                             f"(None: the profiler recorded none), "
                             f"expected 1")
    return us


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_build(res: dict) -> None:
    from repro_torch.kernels import build

    t = time.perf_counter()
    logs = build.build_all()
    res["build_s"] = time.perf_counter() - t
    say("build", f"ok {res['build_s']:.1f}s ({', '.join(logs)}) "
        f"into {build.BUILD_DIR}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say("build", f"{name}: {line.strip()}")


def _probe_kernel_checks(res: dict, dev) -> None:
    """sorted_probe and probe_positions against their plain versions at
    three sizes, with sorted and unsorted queries; times by CUDA events
    and device time by the profiler, beside torch.searchsorted."""
    from repro_torch.kernels import ops, ref

    g = torch.Generator().manual_seed(0)
    rows = []
    # q15's probe (16,384 supplier codes, 32,768 queries), then larger
    for n, m in ((16_384, 32_768), (10_000, 1_000_000),
                 (1_000_000, 1_000_000)):
        keys = torch.sort(torch.randint(0, 4 * n, (n,), generator=g)).values
        keys = keys.to(dev)
        q = torch.randint(-10, 4 * n + 10, (m,), generator=g).to(dev)
        first = torch.tensor(n // 3, dtype=torch.int64, device=dev)
        for qs in ("unsorted", "sorted"):
            qq = torch.sort(q).values if qs == "sorted" else q
            got, want = ops.sorted_probe(keys, qq), ref.sorted_probe(keys, qq)
            pos = ops.probe_positions(keys, qq, first, n - 7)
            pos_want = ref.probe_positions(keys, qq, first, n - 7)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"sorted_probe N={n} M={m} {qs} differs")
            if not torch.equal(pos, pos_want):
                raise AssertionError(f"probe_positions N={n} M={m} {qs} "
                                     f"differs")
            row = {"n": n, "m": m, "queries": qs,
                   **_probe_times(keys, qq, first, n - 7)}
            rows.append(row)
            say("kernels", f"sorted_probe / probe_positions N={n} M={m} {qs} "
                f"queries: exact; {_probe_line(row)}")
    res["probe_checks"] = rows


def _probe_times(keys, q, first, hi) -> dict:
    """Event ms and profiler device us per call of sorted_probe,
    probe_positions, their plain versions and torch.searchsorted, with the
    bound of the search (int32 positions out)."""
    from repro_torch.kernels import ops, ref

    calls = {
        "sorted_probe": lambda: ops.sorted_probe(keys, q),
        "probe_positions": lambda: ops.probe_positions(keys, q, first, hi),
        "plain": lambda: ref.sorted_probe(keys, q),
        "plain_positions": lambda: ref.probe_positions(keys, q, first, hi),
        "searchsorted": lambda: torch.searchsorted(keys, q),
        # the parent tree's probe: the search, a cast, a maximum, a clamp
        "parent_positions": lambda: _old_probe(keys, q, first, hi),
    }
    # at this size each call's host time sets its pace, and a host's pace
    # drifts: time the calls in turns (forwards, then backwards) and take
    # the mean of the two
    out = {f"{name}_ms": 0.0 for name in calls}
    for name in list(calls) + list(calls)[::-1]:
        out[f"{name}_ms"] += cuda_ms(calls[name], 50) / 2
    for name, fn in calls.items():
        out[f"{name}_device_us"] = device_us(fn)
    bound = _bound(*_probe_work(keys, q))
    out.update(bound_ms=bound[0], bound_by=bound[1])
    return out


def _probe_work(keys, q) -> tuple:
    """The search's least bytes (keys and queries read once, int32
    positions written once) and its compares."""
    n, m, isz = keys.shape[0], q.shape[0], keys.element_size()
    return n * isz + m * isz + m * 4, m * max(1, math.ceil(math.log2(n + 1)))


def _us(x) -> str:
    return "not measured" if x is None else f"{x:.2f}"


def _probe_line(r: dict) -> str:
    return (f"ms={r['sorted_probe_ms']:.4f} (device us "
            f"{_us(r['sorted_probe_device_us'])}) probe_positions_ms="
            f"{r['probe_positions_ms']:.4f} (device us "
            f"{_us(r['probe_positions_device_us'])}; the parent's four "
            f"launches {r['parent_positions_ms']:.4f}, device us "
            f"{_us(r['parent_positions_device_us'])}) plain_ms="
            f"{r['plain_ms']:.4f} plain_positions_ms="
            f"{r['plain_positions_ms']:.4f} library_ms="
            f"{r['searchsorted_ms']:.4f} (torch.searchsorted, device us "
            f"{_us(r['searchsorted_device_us'])}) bound_ms="
            f"{r['bound_ms']:.6f} ({r['bound_by']})")


def _scan_agrees(name: str, got, want, op: str) -> str:
    """float64 add within SCAN_TOL (relative), everything else exactly;
    raises otherwise."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype}")
    if got.dtype == torch.float64 and op == "add" and got.numel():
        err = float(((got - want).abs() / want.abs().clamp(min=1)).max())
        ok, how = err <= SCAN_TOL, f"rel err {err:.2e} <= {SCAN_TOL:g}"
    else:
        ok, how = bool(torch.equal(got, want)), "exact"
    if not ok:
        raise AssertionError(f"{name}: {how} fails")
    return how


def _gappy_ids(g, n: int, start_p: float, valid) -> torch.Tensor:
    """Segment ids as `masked._segments_gappy` leaves them: a valid row
    starts a group with probability `start_p` (the first valid row
    always), invalid rows inherit the group before; nondecreasing."""
    start = (torch.rand(n, generator=g) < start_p) & valid
    start[int(torch.argmax(valid.to(torch.int8)))] = bool(valid.any())
    return torch.clamp(torch.cumsum(start.to(torch.int64), 0) - 1, min=0)


def _segmented_kernel_checks(res: dict, dev) -> None:
    """segmented_scan and segment_reduce against their plain versions
    (float64 add within SCAN_TOL, everything else exactly), one device
    kernel a call: the scan at 8,388,608 rows; segment_reduce with gappy
    ids and a mask into as many slots as rows, as q15 calls it; one
    segment over every tile of 8,388,608 rows; n = 1, a tile and a row
    either side, all rows invalid, empty ids before, between and after the
    rows and num_segments far past the last id; float64 sums whose
    segments span three tiles or more, bit for bit equal over two calls."""
    from repro_torch.kernels import ops, ref

    g = torch.Generator().manual_seed(0)
    n = 8_388_608
    flags = torch.rand(n, generator=g) < 0.01
    flags[0] = True
    flags = flags.to(dev)
    rows = []
    for c in (1, 3):
        for dt in (torch.int64, torch.float64):
            if dt == torch.int64:
                v = torch.randint(-10**6, 10**6, (n, c), generator=g)
            else:
                v = torch.rand((n, c), generator=g, dtype=torch.float64)
            v = v.to(dev)
            for op in ("add", "max", "min"):
                name = f"segmented_scan N={n} C={c} {str(dt)[6:]} {op}"
                how = _scan_agrees(name, ops.segmented_scan(v, flags, op),
                                   ref.segmented_scan(v, flags, op), op)
                ms = cuda_ms(lambda: ops.segmented_scan(v, flags, op), 10)
                dev_us = one_kernel(name, lambda: ops.segmented_scan(
                    v, flags, op))
                plain = cuda_ms(lambda: ref.segmented_scan(v, flags, op), 2, 1)
                bound = _bound(2 * n * c * 8 + n, n * c)
                say("kernels", f"{name}: {how}; ms={ms:.4f} (device us "
                    f"{_us(dev_us)}, one device kernel) plain_ms={plain:.3f} "
                    f"bound_ms={bound[0]:.4f} ({bound[1]})")
            del v
    # segment_reduce as q15 calls it: 1,048,576 rows, 3% valid, about 100
    # valid rows a group, as many output slots as rows
    m = 1_048_576
    valid = torch.rand(m, generator=g) < 0.03
    sid = _gappy_ids(g, m, 0.01, valid).to(dev)
    valid = valid.to(dev)
    for dt in (torch.float64, torch.int64):
        v = (torch.rand(m, generator=g, dtype=torch.float64) if dt ==
             torch.float64 else torch.randint(-10**6, 10**6, (m,),
                                              generator=g)).to(dev)
        for op in ("add", "max", "min"):
            name = (f"segment_reduce N={m} {str(dt)[6:]} {op}, gappy ids, 3% "
                    f"valid, {m} slots")
            how = _scan_agrees(name, ops.segment_reduce(v, sid, m, op, valid),
                               ref.segment_reduce(v, sid, m, op, valid), op)
            def call():
                return ops.segment_reduce(v, sid, m, op, valid)

            ms = cuda_ms(call, 20)
            dev_us = one_kernel(name, call)
            rows.append({"case": name, "ms": ms, "device_us": dev_us})
            say("kernels", f"{name}: {how}; ms={ms:.4f} (device us "
                f"{_us(dev_us)}, one device kernel)")
    # one segment over every tile
    v = torch.rand(n, generator=g, dtype=torch.float64).to(dev)
    vi = torch.randint(-10**6, 10**6, (n,), generator=g).to(dev)
    one = torch.zeros(n, dtype=torch.bool, device=dev)
    one[0] = True
    zeros = torch.zeros(n, dtype=torch.int64, device=dev)
    for x in (v, vi):
        for op in ("add", "max", "min"):
            name = f"one segment of N={n} {str(x.dtype)[6:]} {op}"
            _scan_agrees(f"segmented_scan {name}",
                         ops.segmented_scan(x, one, op),
                         ref.segmented_scan(x, one, op), op)
            for nseg in (1, 5):
                _scan_agrees(f"segment_reduce {name} into {nseg} slots",
                             ops.segment_reduce(x, zeros, nseg, op),
                             ref.segment_reduce(x, zeros, nseg, op), op)
            say("kernels", f"segmented_scan and segment_reduce, {name} (no "
                f"reset after row 0): agree with plain")
    del vi, one, zeros
    # float64 sums over segments of 5,000-15,000 rows (three tiles or more)
    # with resets inside tiles: bit for bit equal over two calls
    long_start = torch.zeros(n, dtype=torch.bool)
    long_start[torch.cumsum(torch.randint(5_000, 15_000, (n // 5_000,),
                                          generator=g), 0)
               .clamp(max=n - 1)] = True
    long_start[0] = True
    long_ids = (torch.cumsum(long_start.to(torch.int64), 0) - 1).to(dev)
    long_start = long_start.to(dev)
    nseg = int(long_ids[-1]) + 1
    for name, call, plain in (
            ("segmented_scan", lambda: ops.segmented_scan(v, long_start),
             lambda: ref.segmented_scan(v, long_start)),
            ("segment_reduce", lambda: ops.segment_reduce(v, long_ids, nseg),
             lambda: ref.segment_reduce(v, long_ids, nseg))):
        a, b = call(), call()
        how = _scan_agrees(f"{name} float64 add, segments over 3+ tiles",
                           a, plain(), "add")
        if not _bitwise_equal(a, b):
            raise AssertionError(f"{name} float64 add: two calls differ")
        say("kernels", f"{name} N={n} float64 add, {nseg} segments of "
            f"5,000-15,000 rows: {how}; bit for bit equal over two calls")
    del v, long_start, long_ids
    # small and ragged edges
    for size in (1, 2047, 2048, 2049, 300_007):
        for dt in (torch.int64, torch.float64):
            x = torch.randint(-100, 100, (size,), generator=g).to(dt).to(dev)
            gaps = torch.cumsum(torch.randint(0, 3, (size,), generator=g), 0)
            cases = {
                "leading, interior, trailing empty ids":
                    (gaps + 2, torch.rand(size, generator=g) < 0.8, 8),
                "num_segments far past the last id":
                    (gaps, torch.rand(size, generator=g) < 0.8, 100_000),
                "all rows invalid":
                    (gaps, torch.zeros(size, dtype=torch.bool), 5)}
            for label, (ids, ok_rows, extra) in cases.items():
                ids, ok_rows = ids.to(dev), ok_rows.to(dev)
                slots = int(ids[-1]) + extra
                for op in ("add", "max", "min"):
                    # small integers: float sums are exact in any order
                    got = ops.segment_reduce(x, ids, slots, op, ok_rows)
                    want = ref.segment_reduce(x, ids, slots, op, ok_rows)
                    if not _bitwise_equal(got, want):
                        raise AssertionError(
                            f"segment_reduce N={size} {str(dt)[6:]} {op} "
                            f"{label}: differs from plain")
            f = (torch.rand(size, generator=g) < 0.1).to(dev)
            for op in ("add", "max", "min"):
                if not _bitwise_equal(ops.segmented_scan(x, f, op),
                                      ref.segmented_scan(x, f, op)):
                    raise AssertionError(f"segmented_scan N={size} "
                                         f"{str(dt)[6:]} {op} differs")
        say("kernels", f"segment_reduce N={size} with leading, interior and "
            f"trailing empty ids, num_segments far past the last id, all "
            f"rows invalid; segmented_scan N={size}: bitwise equal to plain")
    res["segment_reduce_checks"] = rows
    torch.cuda.empty_cache()


def phase_kernels(res: dict, dev, only=None) -> None:
    """Every kernel against its plain version, or only the checks named in
    `only` (probe, scan, span, flash, recurrence)."""
    checks = {"probe": _probe_kernel_checks,
              "scan": _segmented_kernel_checks,
              "span": _span_kernel_checks, "flash": _flash_kernel_checks,
              "recurrence": _scan_kernel_checks}
    for name, check in checks.items():
        if only is None or name in only:
            check(res, dev)


def serve_prompts(vocab: int) -> list:
    """The serve phase's prompts, drawn from SERVE_SEED."""
    rng = np.random.default_rng(SERVE_SEED)
    lens = rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1, SERVE_REQUESTS)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _attn_flops(b, hq, t, s, d, causal, window) -> int:
    """Flops of the live (q, k) pairs only: 2·D for q·k and 2·D for p·v."""
    qpos = np.arange(t) + (s - t)
    hi = np.minimum(qpos, s - 1) if causal else np.full(t, s - 1)
    lo = np.maximum(qpos - window + 1, 0) if window is not None else 0
    pairs = int(np.clip(hi - lo + 1, 0, None).sum())
    return 4 * b * hq * d * pairs


def _attn_bound(q, k, v, causal, window) -> tuple:
    b, hq, t, d = q.shape
    bytes_ = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    rate = BF16_TENSOR_OPS_PER_S if q.dtype == torch.bfloat16 \
        else CUDA_CORE_OPS_PER_S
    return _bound(bytes_, _attn_flops(b, hq, t, k.shape[2], d, causal,
                                      window), rate)


def _sdpa(q, k, v, causal, window):
    """The same function in one PyTorch call (the library yardstick; the
    port never calls it).  Its is_causal aligns the mask top-left, so
    anything but causal T == S without a window passes the mask."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref

    gqa = q.shape[1] != k.shape[1]
    t, s = q.shape[2], k.shape[2]
    if causal and window is None and t == s:
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=gqa)
    mask = ref._mask(t, s, causal, window, q.device)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          enable_gqa=gqa)


def _attn_operand(g, b, h, t, d, dev, dt, strided: bool) -> torch.Tensor:
    """A seeded [B,H,T,D] operand: contiguous, or [B,T,H,D] memory viewed
    as [B,H,T,D], as the prefill's projections are."""
    if strided:
        x = torch.randn((b, t, h, d), generator=g).to(dev, dt)
        return x.transpose(1, 2)
    return torch.randn((b, h, t, d), generator=g).to(dev, dt)


def _close(got, want, tol) -> tuple:
    """(ok, max |got - want|) under atol = rtol = tol, as allclose reads it."""
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= tol + tol * want.float().abs()).all())
    return ok, float(diff.max()) if diff.numel() else 0.0


def _flash_kernel_checks(res: dict, dev) -> None:
    """The flash kernel against its plain version and SDPA at the reference
    test's seven shapes and at the two shapes the serve phase gives it."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref

    cfg = get_config(SERVE_ARCH)
    lens = [len(p) for p in serve_prompts(cfg.vocab)]
    served = [((SERVE_SLOTS, cfg.n_heads, cfg.kv_heads, t, t, cfg.head_dim),
               True, None, torch.bfloat16)
              for t in (max(lens[i:i + SERVE_SLOTS])
                        for i in range(0, len(lens), SERVE_SLOTS))]
    g = torch.Generator().manual_seed(3)
    rows = []
    cases = [(c, False) for c in ATTN_TEST_SHAPES] + [
        (ATTN_TEST_SHAPES[0][:3] + (torch.bfloat16,), True)] + [
        (c, True) for c in served]
    for (shape, causal, window, dt), strided in cases:
        b, hq, hkv, t, s, d = shape
        q = _attn_operand(g, b, hq, t, d, dev, dt, strided)
        k = _attn_operand(g, b, hkv, s, d, dev, dt, strided)
        v = _attn_operand(g, b, hkv, s, d, dev, dt, strided)
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        want = ref.attention(q, k, v, causal=causal, window=window)
        lib_out = _sdpa(q, k, v, causal, window)
        torch.cuda.synchronize()
        ok, err = _close(got, want, ATTN_TOL[dt])
        lib_ok, lib_err = _close(lib_out, want, ATTN_TOL[dt])
        name = f"flash_attention {shape} causal={causal} window={window} " \
            f"{str(dt)[6:]}{' [B,T,H,D] views' if strided else ''}"
        if not ok:
            raise AssertionError(f"{name}: max abs err {err:g} over "
                                 f"atol=rtol={ATTN_TOL[dt]:g}")
        if not lib_ok:
            raise AssertionError(f"{name}: SDPA disagrees with the plain "
                                 f"version ({lib_err:g}), not a yardstick")
        big = t * s >= 1 << 20
        flash = lambda: ops.flash_attention(q, k, v, causal=causal,  # noqa: E731
                                            window=window)
        ms = cuda_ms(flash, 10 if big else 50)
        plain = cuda_ms(lambda: ref.attention(q, k, v, causal=causal,
                                              window=window), 3 if big else 20)
        lib = cuda_ms(lambda: _sdpa(q, k, v, causal, window), 10 if big else 50)
        dev_us = device_us(flash, 10)
        lib_us = device_us(lambda: _sdpa(q, k, v, causal, window), 10)
        bound = _attn_bound(q, k, v, causal, window)
        flops = _attn_flops(b, hq, t, s, d, causal, window)
        rows.append({"shape": list(shape), "causal": causal, "window": window,
                     "dtype": str(dt)[6:], "strided": strided,
                     "max_abs_err": err, "ms": ms, "device_us": dev_us,
                     "plain_ms": plain, "library_ms": lib,
                     "library_device_us": lib_us, "tflops": flops / ms * 1e-9,
                     "bound_ms": bound[0], "bound_by": bound[1]})
        say("kernels", f"{name}: max abs err {err:.3g} (atol=rtol="
            f"{ATTN_TOL[dt]:g}); ms={ms:.4f} (device us {_us(dev_us)}, "
            f"{flops / ms * 1e-9:.1f} TFLOP/s) plain_ms={plain:.4f} "
            f"library_ms={lib:.4f} (SDPA, device us {_us(lib_us)}) "
            f"bound_ms={bound[0]:.5f} ({bound[1]})")
        del q, k, v, got, want, lib_out
    res["flash_shapes"] = rows
    torch.cuda.empty_cache()


def _rwkv_bound(r, k, v, w, u, state, return_state) -> tuple:
    """Bytes: r, k, v, w, u and the state read once, the output and the
    state written once; operations: 5·Dk·Dv a step and head (an FMA per
    state element for the output, a multiply and an FMA for the update),
    at the CUDA-core rate (the math is float32)."""
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    bytes_ = sum(x.numel() * x.element_size() for x in (r, k, v, w, u))
    bytes_ += b * h * t * dv * r.element_size()
    bytes_ += (state is not None) * b * h * dk * dv * 4
    bytes_ += bool(return_state) * b * h * dk * dv * 4
    return bytes_, 5 * b * h * t * dk * dv


def _lscan_bound(a, b, h0) -> tuple:
    """Bytes: a, b (and h0) read once, h written once; 2 flops (an FMA) a
    step and channel."""
    bytes_ = 3 * a.numel() * 4 + (0 if h0 is None else h0.numel() * 4)
    return bytes_, 2 * a.numel()


def _rwkv_inputs(g, dev, b, h, t, dk, dv, dt, w_dt, u_dt):
    r, k = (torch.randn((b, h, t, dk), generator=g).to(dev, dt)
            for _ in range(2))
    v = torch.randn((b, h, t, dv), generator=g).to(dev, dt)
    w = (0.3 + 0.695 * torch.rand((b, h, t, dk), generator=g)).to(dev, w_dt)
    u = torch.randn((h, dk), generator=g).to(dev, u_dt)
    return r, k, v, w, u


def _extreme_decays(g, shape, dev, dt) -> torch.Tensor:
    """w log-uniform over [1e-6, 1], with exact 0s and 1s mixed in."""
    w = torch.pow(10.0, -6.0 * torch.rand(shape, generator=g))
    pick = torch.rand(shape, generator=g)
    w[pick < 0.05] = 0.0
    w[pick > 0.95] = 1.0
    return w.to(dev, dt)


def _lscan_gates(g, shape, dev, mode: str) -> torch.Tensor:
    """a for linear_scan near 0 (no memory) or near 1 (long memory)."""
    x = torch.rand(shape, generator=g)
    return (1e-3 * x if mode == "near0" else 1.0 - 1e-4 * x).to(dev)


def _scan_edge_checks(dev, g) -> None:
    """rwkv6_scan and linear_scan at the edges of their tilings, with
    extreme decays / gates; rwkv6_scan's final state bit for bit equal
    between two calls."""
    from repro_torch.kernels import ops, ref

    for b, h, t, dk, dv in RWKV_EDGE_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            r, k, _, _, u = _rwkv_inputs(g, dev, b, h, t, dk, dv, dt,
                                         torch.float32, torch.float32)
            v = torch.randn((b, h, t, dv), generator=g).to(dev, dt)
            w = _extreme_decays(g, (b, h, t, dk), dev, torch.float32)
            st = (torch.randn((b, h, dk, dv), generator=g) * 0.1).to(dev)
            args = (r, k, v, w, u)
            name = f"rwkv6_scan {(b, h, t, dk, dv)} {str(dt)[6:]} r/k/v"
            err = _rwkv_check(name, ops, ref, args, st, True)
            s1 = ops.rwkv6(*args, state=st, return_state=True)[1]
            s2 = ops.rwkv6(*args, state=st, return_state=True)[1]
            if not _bitwise_equal(s1, s2):
                raise AssertionError(f"{name}: two calls' final states "
                                     f"differ")
            say("kernels", f"{name}, w in [1e-6, 1] with 0s and 1s, state "
                f"in and out: max abs err {err:.3g}; final state bit for "
                f"bit equal over two calls")
    for gsz, t, d in LSCAN_EDGE_SHAPES:
        for mode in ("near0", "near1"):
            a = _lscan_gates(g, (gsz, t, d), dev, mode)
            bb = torch.randn((gsz, t, d), generator=g).to(dev)
            for h0 in (None, torch.randn((gsz, d), generator=g).to(dev)):
                ok, err = _close(ops.linear_scan(a, bb, h0=h0),
                                 ref.linear_scan(a, bb, h0=h0), LSCAN_TOL)
                name = (f"linear_scan {(gsz, t, d)} a {mode} "
                        f"h0={h0 is not None}")
                if not ok:
                    raise AssertionError(f"{name}: max abs err {err:g} over "
                                         f"{LSCAN_TOL:g}")
                say("kernels", f"{name}: max abs err {err:.3g}")


def _rwkv_check(name, ops, ref, args, state, return_state) -> float:
    """One rwkv6_scan call against the sequential plain recurrence."""
    got = ops.rwkv6(*args, state=state, return_state=return_state)
    want = ref.rwkv6(*args, state=state, return_state=return_state)
    torch.cuda.synchronize()
    if not return_state:
        got, want = (got,), (want,)
    ok, err = _close(got[0], want[0], RWKV_TOL[args[0].dtype])
    if return_state:
        ok_s, err_s = _close(got[1], want[1], RWKV_STATE_TOL)
        ok, err = ok and ok_s, max(err, err_s)
    if not ok:
        raise AssertionError(f"{name}: max abs err {err:g} over the "
                             f"tolerance (output "
                             f"{RWKV_TOL[args[0].dtype]:g}, state "
                             f"{RWKV_STATE_TOL:g})")
    return err


def _scan_kernel_checks(res: dict, dev) -> None:
    """rwkv6_scan and linear_scan against their plain versions at the
    reference test's shapes (float32, with and without a state or h0) and
    at the shapes the two serve phases give them: rwkv6-3b's 40 heads of 64
    and recurrentgemma-2b's 2560 channels over the prompt chunks' lengths,
    bf16 r/k/v with float32 w/u and a state in and out (prefill), bf16 w/u
    and no state (forward); linear_scan with and without h0."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref

    g = torch.Generator().manual_seed(4)
    for b, h, t, dk, dv in RWKV_TEST_SHAPES:
        args = _rwkv_inputs(g, dev, b, h, t, dk, dv, torch.float32,
                            torch.float32, torch.float32)
        for with_state in (False, True):
            st = (torch.randn((b, h, dk, dv), generator=g) * 0.1).to(dev) \
                if with_state else None
            err = _rwkv_check(f"rwkv6_scan {(b, h, t, dk, dv)}", ops, ref,
                              args, st, with_state)
            say("kernels", f"rwkv6_scan {(b, h, t, dk, dv)} float32 "
                f"state={with_state}: max abs err {err:.3g} (atol=rtol="
                f"{RWKV_TOL[torch.float32]:g})")
    for gsz, t, d in LSCAN_TEST_SHAPES:
        a = (0.2 + 0.79 * torch.rand((gsz, t, d), generator=g)).to(dev)
        bb = torch.randn((gsz, t, d), generator=g).to(dev)
        for h0 in (None, torch.randn((gsz, d), generator=g).to(dev)):
            ok, err = _close(ops.linear_scan(a, bb, h0=h0),
                             ref.linear_scan(a, bb, h0=h0), LSCAN_TOL)
            if not ok:
                raise AssertionError(f"linear_scan {(gsz, t, d)}: max abs "
                                     f"err {err:g} over {LSCAN_TOL:g}")
            say("kernels", f"linear_scan {(gsz, t, d)} h0={h0 is not None}: "
                f"max abs err {err:.3g} (atol=rtol={LSCAN_TOL:g})")
    _scan_edge_checks(dev, g)

    lens = [len(p) for p in serve_prompts(get_config("rwkv6-3b").vocab)]
    chunks = [max(lens[i:i + SERVE_SLOTS])
              for i in range(0, len(lens), SERVE_SLOTS)]
    rows = []
    cfg = get_config("rwkv6-3b")
    h, dk = cfg.rwkv_n_heads, cfg.rwkv_head_dim
    for t in chunks:
        for with_state in (True, False):
            w_dt = torch.float32 if with_state else torch.bfloat16
            args = _rwkv_inputs(g, dev, SERVE_SLOTS, h, t, dk, dk,
                                torch.bfloat16, w_dt, w_dt)
            st = (torch.randn((SERVE_SLOTS, h, dk, dk), generator=g)
                  * 0.1).to(dev) if with_state else None
            name = (f"rwkv6_scan {(SERVE_SLOTS, h, t, dk, dk)} bf16 r/k/v, "
                    f"{str(w_dt)[6:]} w/u, state={with_state}")
            err = _rwkv_check(name, ops, ref, args, st, with_state)
            def kern():
                return ops.rwkv6(*args, state=st, return_state=with_state)

            ms = cuda_ms(kern, 10)
            dev_us = device_us(kern, 10)
            plain = cuda_ms(lambda: ref.rwkv6(*args, state=st,
                                              return_state=with_state), 1, 1)
            bound = _bound(*_rwkv_bound(*args, st, with_state))
            rows.append({"kernel": "rwkv6_scan", "name": name,
                         "max_abs_err": err, "ms": ms, "device_us": dev_us,
                         "plain_ms": plain, "bound_ms": bound[0],
                         "bound_by": bound[1]})
            say("kernels", f"{name}: max abs err {err:.3g}; ms={ms:.4f} "
                f"(device us {_us(dev_us)}) plain_ms={plain:.3f} "
                f"bound_ms={bound[0]:.4f} ({bound[1]})")
            del args, st
    d = get_config("recurrentgemma-2b").rglru_d_state
    for t in chunks:
        a = (0.2 + 0.79 * torch.rand((SERVE_SLOTS, t, d), generator=g)).to(dev)
        bb = torch.randn((SERVE_SLOTS, t, d), generator=g).to(dev)
        for h0 in (torch.randn((SERVE_SLOTS, d), generator=g).to(dev), None):
            name = f"linear_scan {(SERVE_SLOTS, t, d)} h0={h0 is not None}"
            ok, err = _close(ops.linear_scan(a, bb, h0=h0),
                             ref.linear_scan(a, bb, h0=h0), LSCAN_TOL)
            if not ok:
                raise AssertionError(f"{name}: max abs err {err:g} over "
                                     f"{LSCAN_TOL:g}")
            def kern():
                return ops.linear_scan(a, bb, h0=h0)

            ms = cuda_ms(kern, 20)
            dev_us = device_us(kern, 20)
            plain = cuda_ms(lambda: ref.linear_scan(a, bb, h0=h0), 5)
            bound = _bound(*_lscan_bound(a, bb, h0))
            rows.append({"kernel": "linear_scan", "name": name,
                         "max_abs_err": err, "ms": ms, "device_us": dev_us,
                         "plain_ms": plain, "bound_ms": bound[0],
                         "bound_by": bound[1]})
            say("kernels", f"{name}: max abs err {err:.3g}; ms={ms:.4f} "
                f"(device us {_us(dev_us)}) plain_ms={plain:.4f} "
                f"bound_ms={bound[0]:.4f} ({bound[1]})")
        del a, bb
    res["scan_shapes"] = rows
    torch.cuda.empty_cache()


def _flow(name: str):
    from repro_torch.configs import flows

    root, make = flows.FLOWS[name]()
    return root, make(FLOW_ROWS[name], seed=1)


def _bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shape, dtype and bits (floats compared as their bit patterns,
    so NaNs and signed zeros must match too)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float64:
        a, b = a.view(torch.int64), b.view(torch.int64)
    elif a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def _span_outputs(name: str, out) -> list:
    """A span kernel's outputs as one flat list of tensors."""
    if name == "span_compact":
        cols, valid, count = out
        return list(cols) + [valid, count]
    return list(out)


def _rows(batch) -> list:
    """Valid rows as sorted tuples, fields by name, values bit-exact."""
    b = batch.to_numpy().compact()
    fields = sorted(b.fields)
    rows = zip(*[np.asarray(b.columns[f]).tolist() for f in fields])
    return sorted(rows, key=lambda t: tuple(repr(x) for x in t))


class Checker:
    """Wraps every kernel wrapper while a flow runs: each call on the main
    path is held at once against the kernel's plain torch version on the
    same inputs (sorted_probe, integer and max/min results exactly; float64
    add within SCAN_TOL, relative; the span kernels bitwise on every output
    slot).  The plain versions touch no launch count.  Keeps the first call
    of each kernel for the timing phase."""

    NAMES = ("sorted_probe", "probe_positions", "segment_reduce",
             "segmented_scan", "span_compact", "span_segment")
    KERNEL = {"sorted_probe": "sorted_probe",
              "probe_positions": "sorted_probe", "segment_reduce":
              "segmented_scan", "segmented_scan": "segmented_scan",
              "span_compact": "span_compact", "span_segment": "span_segment"}

    def __init__(self):
        self.calls: list = []        # one dict per wrapper call
        self.first: dict = {}        # kernel wrapper -> (args, kwargs)
        self.max_err = {k: 0.0 for k in DATA_KERNELS}
        self.failures: list = []

    def __enter__(self):
        from repro_torch.kernels import ops

        self._real = {n: getattr(ops, n) for n in self.NAMES}
        for n in self.NAMES:
            setattr(ops, n, self._wrap(n))
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        for n, fn in self._real.items():
            setattr(ops, n, fn)
        return False

    def _wrap(self, name: str):
        from repro_torch.kernels import ref

        real, plain = self._real[name], getattr(ref, name)

        def call(*a, **k):
            got = real(*a, **k)
            self.first.setdefault(name, (a, k))
            if name in SPAN_KERNELS:
                self._check_span(name, a, got, plain(*a, **k))
            else:
                self._check(name, a, k, got, plain(*a, **k))
            return got
        return call

    def _record(self, name: str, rec: dict, ok: bool, err: float) -> None:
        kernel = self.KERNEL[name]
        rec.update(ok=ok, max_abs_err=err)
        self.calls.append(rec)
        self.max_err[kernel] = max(self.max_err[kernel], err)
        if not ok:
            self.failures.append(rec)

    def _check_span(self, name, a, got, want) -> None:
        cols, valid = list(a[0]), a[1]
        g, w = _span_outputs(name, got), _span_outputs(name, want)
        ok = len(g) == len(w) and all(_bitwise_equal(x, y)
                                      for x, y in zip(g, w))
        err = 0.0
        if not ok:
            err = max((float((x.double() - y.double()).abs().max())
                       for x, y in zip(g, w)
                       if x.shape == y.shape and x.numel()),
                      default=float("inf"))
        rec = {"wrapper": name, "op": "pack" if name == "span_compact"
               else "segment", "dtype": ",".join(str(c.dtype)[6:]
                                                 for c in cols),
               "shape": [valid.shape[0]], "k": len(cols),
               "count": int(w[-1]), "check": "bitwise" if ok else "differs"}
        if name == "span_compact":
            rec["capacity"] = int(a[2])
        self._record(name, rec, ok, err)

    def _check(self, name, a, k, got, want) -> None:
        v = a[0]
        if name in ("sorted_probe", "probe_positions"):
            op = "probe" if name == "sorted_probe" else "probe+clamp"
        else:  # segment_reduce(v, ids, n, op, valid), segmented_scan(v, f, op)
            i = 3 if name == "segment_reduce" else 2
            op = k.get("op", a[i] if len(a) > i else "add")
        rec = {"wrapper": name, "op": op, "dtype": str(v.dtype)[6:],
               "shape": list(v.shape)}
        if name in ("sorted_probe", "probe_positions"):
            rec["queries"] = int(a[1].shape[0])
        if got.shape != want.shape or got.dtype != want.dtype:
            ok, how = False, f"shape/dtype {tuple(got.shape)} {got.dtype} vs " \
                f"{tuple(want.shape)} {want.dtype}"
            err = float("inf")
        elif got.numel() == 0:
            ok, how, err = True, "exact (empty)", 0.0
        elif want.dtype == torch.float64 and op == "add":
            diff = (got - want).abs()
            err = float(diff.max())
            rel = float((diff / want.abs().clamp(min=1)).max())
            ok, how = rel <= SCAN_TOL, f"rel err {rel:.3g}"
        else:
            ok = bool(torch.equal(got, want))
            how = "exact" if ok else "differs"
            err = 0.0 if ok else float(
                (got.to(torch.float64) - want.to(torch.float64)).abs().max())
        rec["check"] = how
        self._record(name, rec, ok, err)

    def summary(self) -> str:
        parts = []
        for c in self.calls:
            size = f"N={c['shape'][0]}" + (f" M={c['queries']}"
                                           if "queries" in c else "")
            if "k" in c:
                size += f" K={c['k']}" + (f" C={c['capacity']}" if
                                          "capacity" in c else "") \
                    + f" count={c['count']}"
            parts.append(f"{c['wrapper']} {c['op']} {c['dtype']} {size}: "
                         f"{c['check']}")
        return "; ".join(parts)


def phase_flows(res: dict, dev) -> dict:
    """The main path: every flow optimized, compiled with the kernels and
    driven through `run` and through `bind_device` + `run_device`, on the
    default megakernel route and on the composed route; launch counts are
    set to zero just before each route's run and read just after.  Every
    kernel call on the way is checked against its plain version, every
    result against the eager executor, and the two routes' rows against
    each other, bit for bit."""
    from repro_torch.core import executor
    from repro_torch.core.optimizer import optimize
    from repro_torch.kernels import ops

    plans, calls = {}, {}
    total = {r: {k: 0 for k in DATA_KERNELS} for r in ROUTES}
    max_err = {k: 0.0 for k in DATA_KERNELS}
    for name in ("q15", "q7", "clickstream", "textmining"):
        t = time.perf_counter()
        root, b = _flow(name)
        best = optimize(root).best
        cps = {"mega": best.compile(use_kernels=True, device=dev),
               "composed": best.compile(use_kernels=True, device=dev,
                                        use_megakernel=False)}
        t_plan = time.perf_counter() - t
        t = time.perf_counter()
        ref = executor.execute(root, b)
        t_eager = time.perf_counter() - t
        rows = {}
        for route, cp in cps.items():
            with Checker() as chk:
                ops.reset_launches()
                out = cp.run(b)
                out_dev = cp.run_device(cp.bind_device(b))
                torch.cuda.synchronize()
                launches = {k: ops.LAUNCHES[k] for k in DATA_KERNELS}
            if chk.failures:
                raise AssertionError(f"{name} {route}: kernel calls disagree "
                                     f"with their plain versions: "
                                     f"{chk.failures}")
            routes = cp._last_routes
            want = EXPECTED_ROUTES[name] if route == "mega" else None
            if routes != want:
                raise AssertionError(f"{name} {route}: routes {routes}, "
                                     f"expected {want}")
            dev_rb = out_dev.to_record_batch()
            for what, got in (("run", out), ("run_device", dev_rb)):
                if got.capacity == 0 or not got.equivalent(ref):
                    raise AssertionError(
                        f"{name} {route} {what}: {got.capacity} rows, eager "
                        f"{ref.capacity}, not equivalent")
            rows[route] = (_rows(out), _rows(dev_rb))
            for k, v in launches.items():
                total[route][k] += v
                max_err[k] = max(max_err[k], chk.max_err[k])
            calls[f"{name} {route}"] = chk.calls
            say("flows", f"{name} {route} route {routes}: launches "
                f"{launches}; kernel calls ({len(chk.calls)}, each held "
                f"against its plain version): {chk.summary() or 'none'}")
            if name == "q15" and route == "mega":
                res["q15_first_calls"] = chk.first
        if rows["mega"] != rows["composed"]:
            raise AssertionError(f"{name}: the mega route's rows differ from "
                                 f"the composed route's")
        say("flows", f"{name} {FLOW_ROWS[name]} {FLOW_SOURCE[name]} rows -> "
            f"{out.capacity} rows; both routes' run and run_device equal "
            f"eager; mega equals composed bit for bit; plan "
            f"{cp.flow.op_names()[::-1]}; data+optimize {t_plan:.1f}s, "
            f"eager {t_eager:.1f}s")
        if name in ("q15", "q7"):
            plans[name] = (cps, b)
    for k in DATA_KERNELS:
        if total["mega"][k] == 0:
            raise AssertionError(f"kernel {k} was never launched on the "
                                 f"mega route: {total['mega']}")
    for k in SPAN_KERNELS:
        if total["composed"][k]:
            raise AssertionError(f"span kernel {k} launched on the composed "
                                 f"route: {total['composed']}")
    res["launches"] = total["mega"]
    res["launches_by_route"] = total
    res["path_max_abs_err"] = max_err
    res["kernel_calls"] = calls
    say("flows", f"launches over the four flows (run + run_device) by "
        f"route: {total}")
    return plans


def _quartiles(xs) -> tuple:
    q1, q2, q3 = np.percentile(xs, [25, 50, 75])
    return float(q1), float(q2), float(q3)


def phase_timing(res: dict, plans: dict) -> list:
    from repro_torch.core.scans import identity_for
    from repro_torch.kernels import ops, ref

    cps, b = plans["q15"]
    masked = cps["mega"].bind_device(b)
    run_ms = {r: [] for r in ROUTES}
    dev_ms = {r: [] for r in ROUTES}
    for i in range(5):
        for r in (ROUTES if i % 2 == 0 else ROUTES[::-1]):
            t = time.perf_counter()
            cps[r].run(b)
            run_ms[r].append((time.perf_counter() - t) * 1e3)
    for i in range(41):  # in turns: mega, composed, composed, mega, ...
        for r in (ROUTES if i % 2 == 0 else ROUTES[::-1]):
            torch.cuda.synchronize()
            t = time.perf_counter()
            cps[r].run_device(masked)
            torch.cuda.synchronize()
            dev_ms[r].append((time.perf_counter() - t) * 1e3)
    res["q15_timing"] = {}
    for r in ROUTES:
        q1, med, q3 = _quartiles(dev_ms[r])
        res["q15_timing"][r] = {
            "run_ms_median": float(np.median(run_ms[r])),
            "run_device_ms_median": med, "run_device_ms_q1": q1,
            "run_device_ms_q3": q3, "run_device_reps": len(dev_ms[r])}
        st = cps[r].cache_stats()
        say("timing", f"q15 {r} route, warm, in turns: run median of 5 "
            f"{np.median(run_ms[r]):.2f} ms; run_device median of "
            f"{len(dev_ms[r])} {med:.3f} ms (quartiles {q1:.3f} / {q3:.3f}, "
            f"{FLOW_ROWS['q15'] / med * 1e3:.4g} lineitem rows/s); "
            f"executable builds {st.traces}, hits {st.hits}")
    res["q15_run_ms"] = res["q15_timing"]["mega"]["run_ms_median"]
    res["q15_run_device_ms"] = res["q15_timing"]["mega"]["run_device_ms_median"]

    seen = res.pop("q15_first_calls")
    errs = res["path_max_abs_err"]
    kernels = []
    # sorted_probe at the first probe q15 runs (through probe_positions):
    # ms, plain_ms and library_ms of the search alone, as torch.searchsorted
    # computes it; beside them the clamped entry the path calls, and the
    # profiler's device time of each
    (keys, q, first, hi), _ = seen["probe_positions"]
    pt = _probe_times(keys, q, first, hi)
    entry = _entry(
        "sorted_probe", res["launches"], errs["sorted_probe"],
        pt["sorted_probe_ms"], pt["plain_ms"], *_probe_work(keys, q),
        pt["searchsorted_ms"],
        f"N={keys.shape[0]} keys, M={q.shape[0]} queries, {keys.dtype}, "
        f"first_valid {'given' if first is not None else 'none'}")
    entry.update(device_us=pt["sorted_probe_device_us"],
                 library_device_us=pt["searchsorted_device_us"],
                 probe_positions_ms=pt["probe_positions_ms"],
                 probe_positions_device_us=pt["probe_positions_device_us"],
                 plain_positions_ms=pt["plain_positions_ms"],
                 parent_positions_ms=pt["parent_positions_ms"],
                 parent_positions_device_us=pt["parent_positions_device_us"])
    say("timing", f"sorted_probe at q15's first probe: {_probe_line(pt)}")
    kernels.append(entry)
    # segmented_scan through its segment_reduce entry, as q15 calls it
    (v, sid, nseg), kw = seen["segment_reduce"][0][:3], seen["segment_reduce"][1]
    op, valid = kw.get("op", "add"), kw.get("valid")
    nrow = v.shape[0]
    bytes_ = nrow * v.element_size() + nrow * 8 + nrow + nseg * v.element_size()
    # the library call: torch.segment_reduce over segment lengths, invalid
    # rows pre-filled as the kernel's wrapper fills them
    lengths = torch.bincount(sid, minlength=nseg)
    vm = torch.where(valid, v, identity_for(op, v.dtype))
    reduce = {"add": "sum", "max": "max", "min": "min"}[op]
    torch.cuda.synchronize()
    def library():
        return torch.segment_reduce(vm, reduce, lengths=lengths, unsafe=True)

    def kernel():
        return ops.segment_reduce(v, sid, nseg, op=op, valid=valid)

    entry = _entry(
        "segmented_scan", res["launches"], errs["segmented_scan"],
        cuda_ms(kernel, 50),
        cuda_ms(lambda: ref.segment_reduce(v, sid, nseg, op=op, valid=valid), 50),
        bytes_, nrow, cuda_ms(library, 50),
        f"segment_reduce {op}, N={nrow} rows, {nseg} segments, {v.dtype}")
    entry["device_us"], entry["kernels_per_call"] = device_profile(kernel)
    entry["library_device_us"] = device_us(library)
    kernels.append(entry)
    # span_compact at q15's first interior boundary (no single PyTorch call
    # packs with the clamped tail and the count: library_ms is null)
    (cols, cvalid, cap), _ = seen["span_compact"]
    count = int(cvalid.sum())

    def kernel():
        return ops.span_compact(cols, cvalid, cap)

    entry = _entry(
        "span_compact", res["launches"], errs["span_compact"],
        cuda_ms(kernel, 50),
        cuda_ms(lambda: ref.span_compact(cols, cvalid, cap), 20),
        _compact_bytes(cols, cvalid.shape[0], cap, count), cvalid.shape[0],
        None, f"N={cvalid.shape[0]} mask, K={len(cols)} columns "
        f"({', '.join(str(c.dtype)[6:] for c in cols)}), C={cap}, count "
        f"{count}")
    entry["device_us"], entry["kernels_per_call"] = device_profile(kernel)
    kernels.append(entry)
    # span_segment at q15's first in-span Reduce
    (keys, svalid), _ = seen["span_segment"]
    groups = int(ref.span_segment(keys, svalid)[2])

    def kernel():
        return ops.span_segment(keys, svalid)

    entry = _entry(
        "span_segment", res["launches"], errs["span_segment"],
        cuda_ms(kernel, 50),
        cuda_ms(lambda: ref.span_segment(keys, svalid), 20),
        _segment_bytes(keys, svalid.shape[0]),
        svalid.shape[0] * max(len(keys), 1), None,
        f"N={svalid.shape[0]} rows, {len(keys)} key(s) "
        f"({', '.join(str(k.dtype)[6:] for k in keys)}), {groups} groups")
    entry["device_us"], entry["kernels_per_call"] = device_profile(kernel)
    kernels.append(entry)
    for k in kernels:
        lib = "null" if k["library_ms"] is None else f"{k['library_ms']:.4f}"
        say("timing", f"{k['name']} at q15's shape ({k.pop('shape')}): "
            f"ms={k['ms']:.4f} (device us {_us(k['device_us'])}"
            + (f", {k['kernels_per_call']} device kernel(s) a call"
               if "kernels_per_call" in k else "")
            + f") plain_ms={k['plain_ms']:.4f} library_ms={lib} "
            f"bound_ms={k['bound_ms']:.4f} ({k['bound_by']}); launches on "
            f"the mega route {k['launches']}; max_abs_err over the path's "
            f"calls {k['max_abs_err']:g}")
    return kernels


def _compact_bytes(cols, n: int, cap: int, count: int) -> int:
    """span_compact's least traffic: the mask, the rows it packs (and the
    last row, which fills the tail) read once; C slots of every column,
    the output mask and the count written once."""
    row = sum(c.element_size() * (c.numel() // max(n, 1)) for c in cols)
    moved = min(count, cap) + (1 if count < cap else 0)
    return n + moved * row + cap * (row + 1) + 8


def _segment_bytes(keys, n: int) -> int:
    """span_segment's least traffic: the keys (each distinct tensor once)
    and the mask read once, seg (int64) and is_start written once, and the
    count."""
    distinct = {k.data_ptr(): k for k in keys}.values()
    return n + sum(k.element_size() * n for k in distinct) + 8 * n + n + 8


def _span_kernel_checks(res: dict, dev) -> None:
    """The span kernels against their plain versions, bitwise on every
    slot, at q15's lineitem capacity (8,388,608 rows): span_compact for K =
    1, 3, 6, 12, 17 and 32 mixed int64/float64 columns into q15's interior
    capacity with the valid count below it, above it and 0, one device
    kernel a call (the profiler's count); span_segment on one int64 key and on mixed
    int64/float64 keys, packed, gappy and empty, and on 10 keys of which
    only the last two tell slots apart (the kernel's flag pass)."""
    from repro_torch.kernels import ops, ref

    g = torch.Generator().manual_seed(4)
    n, cap = SPAN_ROWS, 1_048_576
    cols = [torch.randint(-2**62, 2**62, (n,), generator=g) if j % 2 == 0
            else torch.randn(n, generator=g, dtype=torch.float64)
            for j in range(32)]
    cols = [c.to(dev) for c in cols]
    u = torch.rand(n, generator=g)
    masks = {"count < C": u < 0.06, "count > C": u < 0.3,
             "count 0": torch.zeros(n, dtype=torch.bool)}
    rows = []
    for k in (1, 3, 6, 12, 17, 32):
        for label, m in masks.items():
            valid = m.to(dev)
            got = ops.span_compact(cols[:k], valid, cap)
            want = ref.span_compact(cols[:k], valid, cap)
            torch.cuda.synchronize()
            g_out, w_out = (_span_outputs("span_compact", got),
                            _span_outputs("span_compact", want))
            if not all(_bitwise_equal(a, b) for a, b in zip(g_out, w_out)):
                raise AssertionError(f"span_compact N={n} K={k} C={cap} "
                                     f"{label}: differs from plain")
            count = int(want[2])
            ms = cuda_ms(lambda: ops.span_compact(cols[:k], valid, cap), 20)
            dev_us = one_kernel(f"span_compact K={k} {label}",
                                lambda: ops.span_compact(cols[:k], valid, cap))
            plain = cuda_ms(lambda: ref.span_compact(cols[:k], valid, cap), 5)
            bound = _bound(_compact_bytes(cols[:k], n, cap, count), n)
            rows.append({"kernel": "span_compact", "k": k, "case": label,
                         "count": count, "ms": ms, "device_us": dev_us,
                         "plain_ms": plain, "bound_ms": bound[0],
                         "bound_by": bound[1]})
            say("kernels", f"span_compact N={n} K={k} (int64/float64) C={cap} "
                f"{label} (count {count}): bitwise equal on every slot; "
                f"ms={ms:.4f} (device us {_us(dev_us)}, one device kernel) "
                f"plain_ms={plain:.4f} bound_ms={bound[0]:.4f} ({bound[1]})")
    a = torch.sort(torch.randint(0, n // 100, (n,), generator=g)).values
    b = torch.tensor([0.0, -0.0, 1.5, 2.5], dtype=torch.float64)[
        torch.randint(0, 4, (n,), generator=g)]
    z = torch.zeros(n, dtype=torch.int64, device=dev)
    keys = {"1 int64 key": [a.to(dev)],
            "int64+float64 keys": [a.to(dev), b.to(dev)],
            "10 keys (8 constant)": [z] * 8 + [a.to(dev), b.to(dev)]}
    packed = torch.arange(n) < (n * 7) // 10
    cases = [("1 int64 key", "packed"), ("int64+float64 keys", "packed"),
             ("int64+float64 keys", "gappy"), ("int64+float64 keys", "count 0"),
             ("10 keys (8 constant)", "packed"),
             ("10 keys (8 constant)", "gappy")]
    seg_masks = {"packed": packed, "gappy": u < 0.5,
                 "count 0": torch.zeros(n, dtype=torch.bool)}
    for kname, mname in cases:
        ks, valid = keys[kname], seg_masks[mname].to(dev)
        got = ops.span_segment(ks, valid)
        want = ref.span_segment(ks, valid)
        torch.cuda.synchronize()
        if not all(_bitwise_equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"span_segment N={n} {kname} {mname}: "
                                 f"differs from plain")
        groups = int(want[2])
        ms = cuda_ms(lambda: ops.span_segment(ks, valid), 20)
        plain = cuda_ms(lambda: ref.span_segment(ks, valid), 5)
        bound = _bound(_segment_bytes(ks, n), n * len(ks))
        rows.append({"kernel": "span_segment", "keys": kname, "case": mname,
                     "groups": groups, "ms": ms, "plain_ms": plain,
                     "bound_ms": bound[0], "bound_by": bound[1]})
        say("kernels", f"span_segment N={n} {kname}, {mname} ({groups} "
            f"groups): bitwise equal on every slot; ms={ms:.4f} "
            f"plain_ms={plain:.4f} bound_ms={bound[0]:.4f} ({bound[1]})")
    res["span_kernel_checks"] = rows
    del cols, keys, z
    torch.cuda.empty_cache()


def _bound(bytes_: float, opers: float,
           ops_per_s: float = CUDA_CORE_OPS_PER_S) -> tuple:
    """(least ms the card could take, "bytes" or "operations"): each input
    read once and each output written once at the HBM rate, against the
    operations at the peak rate for their type (the CUDA-core rate unless
    given)."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = opers / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _entry(name, launches, err, ms, plain_ms, bytes_, opers, library_ms,
           shape, ops_per_s: float = CUDA_CORE_OPS_PER_S) -> dict:
    bound_ms, bound_by = _bound(bytes_, opers, ops_per_s)
    source, replaces = KERNEL_SOURCES[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": int(launches[name]),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "shape": shape}


def _device_busy(prof) -> tuple:
    """(union of device kernel intervals in us, device kernels, {kernel
    name: summed us}) of a finished torch.profiler run."""
    spans, per_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        s, t_end = e.time_range.start, e.time_range.end
        spans.append((s, t_end))
        per_name[e.name] = per_name.get(e.name, 0.0) + (t_end - s)
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, len(spans), per_name


def phase_profile(res: dict, plans: dict) -> None:
    """One profiled warm q15 run_device per route, against that route's
    unprofiled median step from the timing phase."""
    from torch.profiler import ProfilerActivity, profile

    cps, b = plans["q15"]
    masked = cps["mega"].bind_device(b)
    res["q15_profile"] = {}
    os.makedirs(OUT_DIR, exist_ok=True)
    for r in ROUTES:
        cp = cps[r]
        cp.run_device(masked)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            cp.run_device(masked)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t) * 1e6
        busy, n_kernels, per_name = _device_busy(prof)
        if busy <= 0:
            say("profile", f"{r}: the profiler recorded no device kernels: "
                "device busy time and idle share not measured")
            continue
        repo: dict = {}  # repo kernel (short name) -> summed device us
        for k, t in per_name.items():
            short = next((n for n in REPO_KERNELS if n in k), None)
            if short is not None:
                repo[short] = repo.get(short, 0.0) + t
        top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
        plain_us = res["q15_timing"][r]["run_device_ms_median"] * 1e3
        res["q15_profile"][r] = {
            "profiled_wall_us": wall_us, "device_busy_us": busy,
            "idle_share_profiled": 1 - busy / wall_us,
            "unprofiled_median_us": plain_us,
            "idle_share": max(0.0, 1 - busy / plain_us),
            "host_us_per_device_kernel": plain_us / n_kernels,
            "repo_kernel_us": sum(repo.values()), "repo_kernels": repo,
            "device_kernels": n_kernels, "top": top}
        say("profile", f"q15 {r} route run_device: {n_kernels} device "
            f"kernels per step, device busy {busy:.0f} us, repo kernels "
            f"{sum(repo.values()):.0f} us; against the unprofiled median "
            f"run_device {plain_us:.0f} us idle share "
            f"{res['q15_profile'][r]['idle_share']:.3f}, "
            f"{plain_us / n_kernels:.1f} us of wall per device kernel; the "
            f"profiled run's own wall {wall_us:.0f} us (idle share "
            f"{1 - busy / wall_us:.3f}) includes the profiler's overhead")
        for k, t in top:
            say("profile", f"  {r}: {t:10.1f} us  {k[:90]}")
        say("profile", f"  {r}: repo kernels, device us per step: " + ", ".join(
            f"{k} {t:.1f}" for k, t in repo.items()))
        with open(os.path.join(OUT_DIR, f"q15_profile_{r}.txt"), "w") as f:
            f.write(prof.key_averages().table(row_limit=40))
    _probe_launch_counts(res, plans)


def _old_probe(keys, queries, first_valid=None, hi=None):
    """The join probe as the parent tree ran it, launch for launch: the
    int32 search, then a cast, a maximum (ordered right side) and a clamp,
    each a device kernel of its own.  The same positions as
    `ops.probe_positions`."""
    from repro_torch.kernels import ops

    pos = ops.sorted_probe(keys, queries).to(torch.int64)
    if first_valid is not None:
        pos = torch.maximum(pos, first_valid)
    return torch.clamp(pos, 0, keys.shape[0] - 1 if hi is None else hi)


def _probe_launch_counts(res: dict, plans: dict) -> None:
    """Device kernels of one profiled warm run_device of q15 and q7 on each
    route, with the join probe as one launch (this tree) and as the parent
    tree's four (`_old_probe` in its place), taken in turns in one run."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops

    res["probe_kernels_per_step"] = {}
    real = ops.probe_positions
    for flow in ("q15", "q7"):
        cps, b = plans[flow]
        masked = cps["mega"].bind_device(b)
        for r in ROUTES:
            counts = {}
            for variant in ("before", "after", "after", "before") * 4:
                ops.probe_positions = _old_probe if variant == "before" \
                    else real
                try:
                    cps[r].run_device(masked)
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        cps[r].run_device(masked)
                        torch.cuda.synchronize()
                finally:
                    ops.probe_positions = real
                counts.setdefault(variant, []).append(_device_busy(prof)[1])
            # the profiler now and then loses records of a step: a step's
            # count is the one most of its samples give
            mode = {v: max(set(c), key=c.count) for v, c in counts.items()}
            res["probe_kernels_per_step"][f"{flow} {r}"] = {
                "samples": counts, **mode}
            say("profile", f"{flow} {r} route: device kernels per run_device "
                f"step, the probe as one launch (this tree) {mode['after']}, "
                f"as the parent's cast + maximum + clamp {mode['before']} "
                f"(samples in turns: {counts})")



class AttnChecker:
    """Wraps `ops.flash_attention` while the model serves: each call on the
    main path is held at once against the plain attention on the same
    inputs (ATTN_TOL).  The plain version touches no launch count.  Keeps
    the first call's inputs for timing."""

    def __enter__(self):
        from repro_torch.kernels import ops, ref

        self.calls, self.failures, self.first = [], [], None
        self.max_err = 0.0
        self._real = real = ops.flash_attention

        def call(q, k, v, causal=True, window=None, scale=None):
            got = real(q, k, v, causal=causal, window=window, scale=scale)
            want = ref.attention(q, k, v, causal=causal, window=window,
                                 scale=scale)
            ok, err = _close(got, want, ATTN_TOL[q.dtype])
            if self.first is None:
                self.first = (q, k, v, causal, window)
            self.calls.append((tuple(q.shape), tuple(k.shape), err))
            self.max_err = max(self.max_err, err)
            if not ok:
                self.failures.append((tuple(q.shape), err))
            return got

        ops.flash_attention = call
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        ops.flash_attention = self._real
        return False


class StepTimer:
    """Host-clock time of each `prefill` and `decode_step` of a model, each
    call bracketed by `torch.cuda.synchronize()` (the engine waits for every
    step's tokens anyway)."""

    NAMES = ("prefill", "decode_step")

    def __init__(self, model):
        self.model = model
        self.ms = {n: [] for n in self.NAMES}

    def __enter__(self):
        for name in self.NAMES:
            real, out = getattr(self.model, name), self.ms[name]

            def timed(*a, _real=real, _out=out, **k):
                torch.cuda.synchronize()
                t = time.perf_counter()
                r = _real(*a, **k)
                torch.cuda.synchronize()
                _out.append((time.perf_counter() - t) * 1e3)
                return r
            setattr(self.model, name, timed)
        return self

    def __exit__(self, *exc):
        for name in self.NAMES:
            delattr(self.model, name)
        return False


def _chunk_tokens(prompts) -> torch.Tensor:
    """The engine's first chunk, left-padded with token 0 as it pads."""
    chunk = prompts[:SERVE_SLOTS]
    tmax = max(len(p) for p in chunk)
    toks = np.zeros((len(chunk), tmax), np.int64)
    for i, p in enumerate(chunk):
        toks[i, tmax - len(p):] = p
    return torch.from_numpy(toks)


def _check_requests(reqs, cfg) -> None:
    for r in reqs:
        if len(r.out_tokens) != SERVE_NEW or not r.done or not all(
                0 <= x < cfg.padded_vocab for x in r.out_tokens):
            raise AssertionError(f"request of {len(r.prompt)} tokens: bad "
                                 f"output {r.out_tokens}")


def _timed_serve(phase: str, engine, model, requests, checked) -> tuple:
    """A timed run of the requests, no checks: (serve dict, decode ms)."""
    with StepTimer(model) as tm:
        t = time.perf_counter()
        timed = engine.generate(requests())
        wall = time.perf_counter() - t
    n_tok = sum(len(r.out_tokens) for r in timed)
    same = all(a.out_tokens == b.out_tokens for a, b in zip(checked, timed))
    dec = tm.ms["decode_step"]
    serve = {"tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
             "prefill_ms": tm.ms["prefill"],
             "decode_ms_per_step_median": float(np.median(dec)),
             "decode_ms_per_step_mean": float(np.mean(dec)),
             "decode_steps": len(dec), "tokens_equal_checked_run": same,
             "out_tokens_first": timed[0].out_tokens}
    say(phase, f"timed run: {n_tok} tokens in {wall:.3f}s = "
        f"{serve['tokens_per_s']:.1f} tokens/s; prefill ms per chunk "
        f"{[round(x, 2) for x in serve['prefill_ms']]}; decode "
        f"{serve['decode_ms_per_step_median']:.3f} ms per step median "
        f"({SERVE_SLOTS} tokens a step, {len(dec)} steps); greedy tokens "
        f"equal to the checked run's: {same}")
    return serve, dec


def _compare_logits(phase: str, serve: dict, lf, lp, toks, what: str) -> None:
    """Prefill last-token logits of the kernel path against the plain path
    on the same weights, within LOGIT_TOL."""
    diff = (lf - lp).abs()
    logit_err = float(diff.max())
    ok = bool((diff <= LOGIT_TOL + LOGIT_TOL * lp.abs()).all())
    agree = float((lf.argmax(-1) == lp.argmax(-1)).float().mean())
    if not (ok and torch.isfinite(lf).all()):
        raise AssertionError(f"prefill logits: {what} max abs err "
                             f"{logit_err:g} over atol=rtol={LOGIT_TOL:g}")
    serve.update(logit_max_abs_err=logit_err,
                 logit_max_abs=float(lp.abs().max()), argmax_agree=agree)
    say(phase, f"prefill last-token logits [{toks.shape[0]}, 1, "
        f"{lf.shape[-1]}] on the kernel path vs {what}: max abs err "
        f"{logit_err:.4g} (|logit| up to {serve['logit_max_abs']:.3g}; "
        f"atol=rtol={LOGIT_TOL:g}); argmax agrees on {agree:.2f} of rows")


def _profile_decode(phase: str, serve: dict, model, lf, state, dec) -> None:
    """One decode step profiled after two unprofiled ones, against the
    timed run's median step."""
    from torch.profiler import ProfilerActivity, profile

    tok = lf.argmax(-1)
    for _ in range(2):
        out, state = model.decode_step(tok, state)
        tok = out.argmax(-1)
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out, state = model.decode_step(tok, state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    busy, n_kernels, per_name = _device_busy(prof)
    step_us = float(np.median(dec)) * 1e3
    if busy > 0:
        top = sorted(per_name.items(), key=lambda kv: -kv[1])[:6]
        serve["decode_profile"] = {
            "device_busy_us": busy, "device_kernels": n_kernels,
            "idle_share": max(0.0, 1 - busy / step_us),
            "profiled_wall_us": wall_us, "top": top}
        say(phase, f"decode step: device busy {busy:.0f} us in {n_kernels} "
            f"device kernels; against the timed run's median step "
            f"{step_us:.0f} us idle share "
            f"{serve['decode_profile']['idle_share']:.3f} ("
            f"{step_us / n_kernels:.1f} us of wall per device kernel; "
            f"profiled wall {wall_us:.0f} us)")
        for k, v in top:
            say(phase, f"  {v:10.1f} us  {k[:90]}")
    else:
        say(phase, "the profiler recorded no device kernels: decode busy "
            "time and idle share not measured")


def phase_serve(res: dict, dev) -> dict:
    """Token serving, the model plane's main path: qwen3-0.6b at full width
    and depth through Engine -> prefill / decode_step with the flash
    kernel.  Launch counts are set to zero just before the checked run and
    read just after it."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models import make_model
    from repro_torch.serve.engine import Engine, Request

    cfg = get_config(SERVE_ARCH, attn_impl="flash")
    t = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED)
    model = make_model(cfg, dev).init(gen)
    torch.cuda.synchronize()
    say("serve", f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"heads {cfg.n_heads}/{cfg.kv_heads} x {cfg.head_dim}, vocab "
        f"{cfg.vocab} (padded {cfg.padded_vocab}), {model.param_count():,} "
        f"{str(cfg.p_dtype)[6:]} parameters, {str(cfg.act_dtype)[6:]} "
        f"activations, attn_impl={cfg.attn_impl}; init on the card "
        f"{time.perf_counter() - t:.1f}s")
    prompts = serve_prompts(cfg.vocab)

    def requests():
        return [Request(prompt=p, max_new_tokens=SERVE_NEW) for p in prompts]

    engine = Engine(model, batch_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ,
                    seed=SERVE_SEED)
    # the main path, every kernel call checked
    with AttnChecker() as chk:
        ops.reset_launches()
        reqs = engine.generate(requests())
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
    n_chunks = -(-SERVE_REQUESTS // SERVE_SLOTS)
    if chk.failures:
        raise AssertionError(f"flash calls disagree with the plain "
                             f"attention: {chk.failures}")
    if launches["flash_attention"] != n_chunks * cfg.n_layers:
        raise AssertionError(f"flash_attention launched "
                             f"{launches['flash_attention']} times, expected "
                             f"{n_chunks * cfg.n_layers} (one per prefill "
                             f"layer): {launches}")
    _check_requests(reqs, cfg)
    shapes = sorted({c[0] for c in chk.calls})
    say("serve", f"checked run: {SERVE_REQUESTS} requests, prompts "
        f"{[len(p) for p in prompts]}, {SERVE_NEW} new tokens each; "
        f"{len(chk.calls)} flash calls at q shapes {shapes}, each within "
        f"atol=rtol={ATTN_TOL[torch.bfloat16]:g} of the plain attention "
        f"(max abs err {chk.max_err:.4g}); launches {launches}")

    serve, dec = _timed_serve("serve", engine, model, requests, reqs)

    # prefill logits: kernel path against plain attention on the same weights
    plain = make_model(cfg.with_(attn_impl="xla"), dev).load_params(
        model.state_dict())
    toks = _chunk_tokens(prompts).to(dev)
    state = model.init_decode_state(toks.shape[0], SERVE_MAX_SEQ)
    lf, state = model.prefill({"tokens": toks}, state)
    lp, _ = plain.prefill({"tokens": toks},
                          plain.init_decode_state(toks.shape[0], SERVE_MAX_SEQ))
    torch.cuda.synchronize()
    del plain
    _compare_logits("serve", serve, lf, lp, toks, "plain attention")
    _profile_decode("serve", serve, model, lf, state, dec)
    res["serve"] = serve

    # the kernel's numbers at the main path's first call, by CUDA events
    # and by the profiler's device time
    q, k, v, causal, window = chk.first
    b, hq, tq, d = q.shape
    bytes_ = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    opers = _attn_flops(b, hq, tq, k.shape[2], d, causal, window)
    flash = lambda: ops.flash_attention(q, k, v, causal=causal,  # noqa: E731
                                        window=window)
    lib = lambda: _sdpa(q, k, v, causal, window)  # noqa: E731
    entry = _entry(
        "flash_attention", launches, chk.max_err, cuda_ms(flash, 20),
        cuda_ms(lambda: ref.attention(q, k, v, causal=causal, window=window),
                3),
        bytes_, opers, cuda_ms(lib, 20),
        f"q {list(q.shape)}, k/v {list(k.shape)} (strides {q.stride()}, "
        f"{k.stride()}), causal, {str(q.dtype)[6:]}", BF16_TENSOR_OPS_PER_S)
    entry.update(device_us=device_us(flash, 10),
                 library_device_us=device_us(lib, 10),
                 tflops=opers / entry["ms"] * 1e-9)
    say("serve", f"flash_attention at the first prefill's shape "
        f"({entry.pop('shape')}): ms={entry['ms']:.4f} (device us "
        f"{_us(entry['device_us'])}, {entry['tflops']:.1f} TFLOP/s) "
        f"plain_ms={entry['plain_ms']:.4f} library_ms="
        f"{entry['library_ms']:.4f} (SDPA, device us "
        f"{_us(entry['library_device_us'])}) bound_ms="
        f"{entry['bound_ms']:.5f} ({entry['bound_by']}); max_abs_err over "
        f"the path's calls {entry['max_abs_err']:g}")
    return entry


class ScanChecker:
    """Holds every `ops.rwkv6` and `ops.linear_scan` call the models make
    against the plain recurrence on the same inputs (the sequential
    `ref.rwkv6` with the state; `ref.linear_scan` with h0), and keeps the
    first call's inputs for timing."""

    def __enter__(self):
        from repro_torch.kernels import ops, ref

        self.calls, self.failures, self.first = [], [], {}
        self.max_err = {"rwkv6_scan": 0.0, "linear_scan": 0.0}
        self._real = real = {"rwkv6": ops.rwkv6,
                             "linear_scan": ops.linear_scan}

        def note(name, shape, ok, err, inputs):
            self.first.setdefault(name, inputs)
            self.calls.append((name, shape, err))
            self.max_err[name] = max(self.max_err[name], err)
            if not ok:
                self.failures.append((name, shape, err))

        def rwkv6(r, k, v, w, u, state=None, return_state=False):
            got = real["rwkv6"](r, k, v, w, u, state=state,
                                return_state=return_state)
            want = ref.rwkv6(r, k, v, w, u, state=state,
                             return_state=return_state)
            pairs = zip(got, want) if return_state else [(got, want)]
            tols = [RWKV_TOL[r.dtype], RWKV_STATE_TOL]
            checks = [_close(a, b, tol) for (a, b), tol in zip(pairs, tols)]
            note("rwkv6_scan", tuple(r.shape), all(c[0] for c in checks),
                 max(c[1] for c in checks),
                 ((r, k, v, w, u), state, return_state))
            return got

        def linear_scan(a, b, h0=None):
            got = real["linear_scan"](a, b, h0=h0)
            ok, err = _close(got, ref.linear_scan(a, b, h0=h0), LSCAN_TOL)
            note("linear_scan", tuple(a.shape), ok, err, (a, b, h0))
            return got

        ops.rwkv6, ops.linear_scan = rwkv6, linear_scan
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        ops.rwkv6 = self._real["rwkv6"]
        ops.linear_scan = self._real["linear_scan"]
        return False


def phase_serve_recurrent(res: dict, dev, arch: str) -> dict:
    """Token serving through a recurrent family at full width and depth,
    `Model(use_kernel=True)`: rwkv6-3b (rwkv6_scan in every prefill layer)
    or recurrentgemma-2b (linear_scan in every RG-LRU prefill layer).
    Launch counts are set to zero just before the checked run and read just
    after it."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models import make_model
    from repro_torch.models.transformer import layer_kinds
    from repro_torch.serve.engine import Engine, Request

    phase = f"serve_{arch}"
    cfg = get_config(arch)
    kernel = SCAN_KERNEL[cfg.family]
    n_rec = sum(k not in ("attn", "dense") for k in layer_kinds(cfg))
    t = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED)
    model = make_model(cfg, dev, use_kernel=True).init(gen)
    torch.cuda.synchronize()
    if cfg.family == "rwkv6":
        shape = (f"{cfg.rwkv_n_heads} heads x {cfg.rwkv_head_dim}, d_ff "
                 f"{cfg.d_ff}")
    else:
        shape = (f"pattern {cfg.block_pattern}, RG-LRU width "
                 f"{cfg.rglru_d_state}, local window {cfg.local_window}, "
                 f"heads {cfg.n_heads}/{cfg.kv_heads} x {cfg.head_dim}")
    say(phase, f"{cfg.name}: {cfg.n_layers} layers ({n_rec} recurrent), "
        f"d_model {cfg.d_model}, {shape}, vocab {cfg.vocab} (padded "
        f"{cfg.padded_vocab}), {model.param_count():,} "
        f"{str(cfg.p_dtype)[6:]} parameters, {str(cfg.act_dtype)[6:]} "
        f"activations, use_kernel=True; init on the card "
        f"{time.perf_counter() - t:.1f}s")
    prompts = serve_prompts(cfg.vocab)

    def requests():
        return [Request(prompt=p, max_new_tokens=SERVE_NEW) for p in prompts]

    engine = Engine(model, batch_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ,
                    seed=SERVE_SEED)
    # the main path, every kernel call checked
    with ScanChecker() as chk:
        ops.reset_launches()
        reqs = engine.generate(requests())
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
    n_chunks = -(-SERVE_REQUESTS // SERVE_SLOTS)
    if chk.failures:
        raise AssertionError(f"{kernel} calls disagree with the plain "
                             f"recurrence: {chk.failures}")
    if launches[kernel] != n_chunks * n_rec or any(
            n for k, n in launches.items() if k != kernel):
        raise AssertionError(f"{kernel} launched {launches[kernel]} times, "
                             f"expected {n_chunks * n_rec} (one per "
                             f"recurrent prefill layer) and no other "
                             f"kernel: {launches}")
    _check_requests(reqs, cfg)
    shapes = sorted({c[1] for c in chk.calls})
    tol = (f"output atol=rtol={RWKV_TOL[torch.bfloat16]:g}, state "
           f"{RWKV_STATE_TOL:g}" if kernel == "rwkv6_scan"
           else f"atol=rtol={LSCAN_TOL:g}")
    say(phase, f"checked run: {SERVE_REQUESTS} requests, prompts "
        f"{[len(p) for p in prompts]}, {SERVE_NEW} new tokens each; "
        f"{len(chk.calls)} {kernel} calls at shapes {shapes}, each within "
        f"{tol} of the plain recurrence (max abs err "
        f"{chk.max_err[kernel]:.4g}); launches {launches}")

    serve, dec = _timed_serve(phase, engine, model, requests, reqs)

    # prefill logits: kernel path against use_kernel=False on the same
    # weights.  bf16 activations round at every layer, so a one-ulp flip in
    # a recurrence's output (summation order) grows over the depth to the
    # bf16 path's own noise: the two paths are held (1) within LOGIT_TOL
    # with float32 activations, where nothing rounds to bf16, and (2) with
    # the served bf16 activations, the kernel path no farther from the
    # float32 logits than twice the plain path is
    toks = _chunk_tokens(prompts).to(dev)
    b = toks.shape[0]

    def prefill(m, use_kernel):
        m.use_kernel = use_kernel
        out = m.prefill({"tokens": toks}, m.init_decode_state(b, SERVE_MAX_SEQ))
        m.use_kernel = True
        return out

    lf, state = prefill(model, True)
    lp, _ = prefill(model, False)
    m32 = make_model(cfg.with_(dtype="float32"), dev).load_params(
        model.state_dict())
    lf32, _ = prefill(m32, True)
    lp32, _ = prefill(m32, False)
    torch.cuda.synchronize()
    del m32
    _compare_logits(phase, serve, lf32, lp32, toks,
                    "use_kernel=False, both with float32 activations")
    err_k = float((lf - lp32).abs().max())
    err_p = float((lp - lp32).abs().max())
    serve.update(bf16_logit_max_abs_err=float((lf - lp).abs().max()),
                 bf16_argmax_agree=float((lf.argmax(-1) == lp.argmax(-1))
                                         .float().mean()),
                 bf16_kernel_vs_f32=err_k, bf16_plain_vs_f32=err_p)
    say(phase, f"prefill last-token logits with bf16 activations: kernel "
        f"path vs use_kernel=False max abs err "
        f"{serve['bf16_logit_max_abs_err']:.4g} (argmax agrees on "
        f"{serve['bf16_argmax_agree']:.2f} of rows); against the float32 "
        f"activations' plain logits the kernel path is {err_k:.4g} off, "
        f"the plain path {err_p:.4g}")
    if not (torch.isfinite(lf).all() and err_k <= 2 * err_p):
        raise AssertionError(f"bf16 prefill logits: the kernel path is "
                             f"{err_k:g} from the float32 logits, more than "
                             f"twice the plain path's {err_p:g}")
    del lp, lf32, lp32
    _profile_decode(phase, serve, model, lf, state, dec)
    res[phase] = serve

    # the kernel's numbers at the main path's first call
    if kernel == "rwkv6_scan":
        args, st, rs = chk.first[kernel]
        bytes_, opers = _rwkv_bound(*args, st, rs)

        def kern():
            return ops.rwkv6(*args, state=st, return_state=rs)

        ms = cuda_ms(kern, 20)
        plain = cuda_ms(lambda: ref.rwkv6(*args, state=st, return_state=rs),
                        2, 1)
        what = (f"r/k/w {list(args[0].shape)}, v {list(args[2].shape)}, "
                f"{str(args[0].dtype)[6:]} r/k/v, {str(args[3].dtype)[6:]} "
                f"w, state in and out")
    else:
        a, b, h0 = chk.first[kernel]
        bytes_, opers = _lscan_bound(a, b, h0)

        def kern():
            return ops.linear_scan(a, b, h0=h0)

        ms = cuda_ms(kern, 20)
        plain = cuda_ms(lambda: ref.linear_scan(a, b, h0=h0), 5)
        what = (f"a/b {list(a.shape)} float32, "
                f"{'with' if h0 is not None else 'no'} h0")
    entry = _entry(kernel, launches, chk.max_err[kernel], ms, plain, bytes_,
                   opers, None, what)
    entry["device_us"] = device_us(kern, 20)
    say(phase, f"{kernel} at the first prefill's shape ({entry.pop('shape')}):"
        f" ms={entry['ms']:.4f} (device us {_us(entry['device_us'])}) "
        f"plain_ms={entry['plain_ms']:.4f} "
        f"library_ms=null (no single PyTorch call computes the recurrence) "
        f"bound_ms={entry['bound_ms']:.5f} ({entry['bound_by']}); "
        f"max_abs_err over the path's calls {entry['max_abs_err']:g}")
    del chk, model, engine, state, lf
    return entry


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    # `--only probe,flash,...`: the build and the named kernel checks
    # alone, for a short run while a kernel changes; `dataflow` adds the
    # flows, timing and profile phases (no serving); no result line
    only = None
    if len(argv) == 2 and argv[0] == "--only":
        only = set(argv[1].split(","))
    elif argv:
        print(f"usage: chip_smoke.py [--only CHECK,...]; got {argv}",
              file=sys.stderr)
        return 2
    smi = nvidia_smi()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    dev = torch.device("cuda")
    say("device", f"{name} x{torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    res: dict = {"nvidia_smi": smi, "device": name}
    t0 = time.perf_counter()
    phase = "build"
    try:
        phase_build(res)
        phase = "kernels"
        phase_kernels(res, dev, only)
        if only is not None and "dataflow" in only:
            phase = "flows"
            plans = phase_flows(res, dev)
            phase = "timing"
            res["kernels"] = phase_timing(res, plans)
            phase = "profile"
            phase_profile(res, plans)
            del plans
        if only is not None:
            say("done", f"--only {sorted(only)}: {time.perf_counter() - t0:.1f}s")
            os.makedirs(OUT_DIR, exist_ok=True)
            with open(os.path.join(OUT_DIR, "chip_smoke_only.json"), "w") as f:
                json.dump(res, f, indent=1, default=str)
            if "kernels" in res:
                print(json.dumps({"kernels": res["kernels"]}), flush=True)
            return 0
        phase = "flows"
        plans = phase_flows(res, dev)
        phase = "timing"
        kernels = phase_timing(res, plans)
        phase = "profile"
        phase_profile(res, plans)
        del plans
        torch.cuda.empty_cache()
        phase = "serve"
        kernels.append(phase_serve(res, dev))
        for arch in RECURRENT_ARCHS:
            torch.cuda.empty_cache()
            phase = f"serve_{arch}"
            kernels.append(phase_serve_recurrent(res, dev, arch))
    except Exception:
        say(phase, "FAILED\n" + traceback.format_exc())
        return 1
    res["kernels"] = kernels
    res["seconds"] = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(res, f, indent=1, default=str)
    say("done", f"{res['seconds']:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
