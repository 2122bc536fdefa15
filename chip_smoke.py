"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two main paths through the hand-written CUDA kernels
(`src/repro_torch/csrc/`): the data-flow path — flow build + SCA ->
optimize -> compile(use_kernels=True) -> CompiledPlan.run / run_device — for
the paper's four evaluation flows at serving scale, every result checked
against the port's eager numpy executor; and token serving — Engine ->
Model.prefill / decode_step — for qwen3-0.6b at full width and depth with
the flash-attention kernel.  Phases, one or more lines each:

  device   the card's name and power limit (nvidia-smi), first line
  build    the three kernels built from the checkout with nvcc (one nvcc
           per source, in parallel), ptxas lines
  kernels  each kernel against its plain torch version on the card; flash
           attention at the reference test's seven shapes and the served
           shapes, timed against the plain version and SDPA, with a bound
  flows    q15 (6M lineitem rows), q7 (1M), clickstream (16M), textmining
           (1M), each through run and through bind_device + run_device:
           both equal to the eager executor; every kernel call on the way
           held against the kernel's plain version on its own inputs; CUDA
           launches per kernel
  timing   warm run / run_device of q15; each kernel at the shapes q15
           gives it: time, plain time, library-call time and bound
  profile  torch.profiler over a warm q15 run_device: device busy time,
           idle share against the unprofiled step time, top device ops,
           repo-kernel time
  serve    qwen3-0.6b (28 layers, d_model 1024, f32 weights, bf16
           activations, attn_impl="flash") from a seeded generator; 8
           requests of 1024-2048 prompt tokens and 32 greedy new tokens
           through Engine(batch_slots=4, max_seq=2080), every flash call
           held against the plain attention; the prefill's last-token
           logits against the same weights with plain attention; then a
           timed run (tokens/s, prefill ms per chunk, decode ms per step)
           and a profiled decode step (device busy time, idle share)

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
}
DATA_KERNELS = ("sorted_probe", "segmented_scan")  # the data-flow path's
REPO_KERNELS = ("probe_kernel", "tile_reduce", "tile_carries", "tile_apply",
                "flash_bf16", "flash_f32")

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


def phase_kernels(res: dict, dev) -> None:
    from repro_torch.kernels import ops, ref

    g = torch.Generator().manual_seed(0)
    m = 1_000_000
    for n in (10_000, 1_000_000):
        keys = torch.sort(torch.randint(0, 4 * n, (n,), generator=g)).values
        keys = keys.to(dev)
        q = torch.randint(-10, 4 * n + 10, (m,), generator=g).to(dev)
        for qs in ("unsorted", "sorted"):
            qq = torch.sort(q).values if qs == "sorted" else q
            got, want = ops.sorted_probe(keys, qq), ref.sorted_probe(keys, qq)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"sorted_probe N={n} M={m} {qs} differs")
            ms = cuda_ms(lambda: ops.sorted_probe(keys, qq), 20)
            plain = cuda_ms(lambda: ref.sorted_probe(keys, qq), 20)
            lib = cuda_ms(lambda: torch.searchsorted(keys, qq), 20)
            bound = _bound(n * 8 + m * 8 + m * 4,
                           m * max(1, math.ceil(math.log2(n + 1))))
            say("kernels", f"sorted_probe N={n} M={m} {qs} queries: exact; "
                f"ms={ms:.4f} plain_ms={plain:.4f} library_ms={lib:.4f} "
                f"bound_ms={bound[0]:.4f} ({bound[1]})")
    n = 8_388_608
    flags = torch.rand(n, generator=g) < 0.01
    flags[0] = True
    flags = flags.to(dev)
    for c in (1, 3):
        for dt in (torch.int64, torch.float64):
            if dt == torch.int64:
                v = torch.randint(-10**6, 10**6, (n, c), generator=g)
            else:
                v = torch.rand((n, c), generator=g, dtype=torch.float64)
            v = v.to(dev)
            for op in ("add", "max", "min"):
                got = ops.segmented_scan(v, flags, op)
                want = ref.segmented_scan(v, flags, op)
                torch.cuda.synchronize()
                if dt == torch.float64 and op == "add":
                    err = ((got - want).abs() / want.abs().clamp(min=1)).max()
                    ok = float(err) <= SCAN_TOL
                    how = f"rel err {float(err):.2e} <= {SCAN_TOL:g}"
                else:
                    ok, how = bool(torch.equal(got, want)), "exact"
                if not ok:
                    raise AssertionError(
                        f"segmented_scan N={n} C={c} {dt} {op}: {how} fails")
                ms = cuda_ms(lambda: ops.segmented_scan(v, flags, op), 10)
                plain = cuda_ms(lambda: ref.segmented_scan(v, flags, op), 2, 1)
                bound = _bound(2 * n * c * 8 + n, n * c)
                say("kernels", f"segmented_scan N={n} C={c} {str(dt)[6:]} "
                    f"{op}: {how}; ms={ms:.4f} plain_ms={plain:.3f} "
                    f"bound_ms={bound[0]:.4f} ({bound[1]})")
            del v
    torch.cuda.empty_cache()
    _flash_kernel_checks(res, dev)


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


def _attn_close(got, want, dtype) -> tuple:
    """(ok, max |got - want|) under ATTN_TOL as allclose reads it."""
    tol = ATTN_TOL[dtype]
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
    for shape, causal, window, dt in ATTN_TEST_SHAPES + served:
        b, hq, hkv, t, s, d = shape
        q = torch.randn((b, hq, t, d), generator=g).to(dev, dt)
        k = torch.randn((b, hkv, s, d), generator=g).to(dev, dt)
        v = torch.randn((b, hkv, s, d), generator=g).to(dev, dt)
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        want = ref.attention(q, k, v, causal=causal, window=window)
        lib_out = _sdpa(q, k, v, causal, window)
        torch.cuda.synchronize()
        ok, err = _attn_close(got, want, dt)
        lib_ok, lib_err = _attn_close(lib_out, want, dt)
        name = f"flash_attention {shape} causal={causal} window={window} " \
            f"{str(dt)[6:]}"
        if not ok:
            raise AssertionError(f"{name}: max abs err {err:g} over "
                                 f"atol=rtol={ATTN_TOL[dt]:g}")
        if not lib_ok:
            raise AssertionError(f"{name}: SDPA disagrees with the plain "
                                 f"version ({lib_err:g}), not a yardstick")
        big = t * s >= 1 << 20
        ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=causal,
                                                 window=window), 10 if big else 50)
        plain = cuda_ms(lambda: ref.attention(q, k, v, causal=causal,
                                              window=window), 3 if big else 20)
        lib = cuda_ms(lambda: _sdpa(q, k, v, causal, window), 10 if big else 50)
        bound = _attn_bound(q, k, v, causal, window)
        rows.append({"shape": list(shape), "causal": causal, "window": window,
                     "dtype": str(dt)[6:], "max_abs_err": err, "ms": ms,
                     "plain_ms": plain, "library_ms": lib,
                     "bound_ms": bound[0], "bound_by": bound[1]})
        say("kernels", f"{name}: max abs err {err:.3g} (atol=rtol="
            f"{ATTN_TOL[dt]:g}); ms={ms:.4f} plain_ms={plain:.4f} "
            f"library_ms={lib:.4f} (SDPA) bound_ms={bound[0]:.5f} "
            f"({bound[1]})")
        del q, k, v, got, want, lib_out
    res["flash_shapes"] = rows
    torch.cuda.empty_cache()


def _flow(name: str):
    from repro_torch.configs import flows

    root, make = flows.FLOWS[name]()
    return root, make(FLOW_ROWS[name], seed=1)


class Checker:
    """Wraps every kernel wrapper while a flow runs: each call on the main
    path is held at once against the kernel's plain torch version on the
    same inputs (sorted_probe, integer and max/min results exactly; float64
    add within SCAN_TOL, relative).  The plain versions touch no launch
    count.  Keeps the first call of each kernel for the timing phase."""

    NAMES = ("sorted_probe", "segment_reduce", "segmented_scan")

    def __init__(self):
        self.calls: list = []        # one dict per wrapper call
        self.first: dict = {}        # kernel wrapper -> (args, kwargs)
        self.max_err = {"sorted_probe": 0.0, "segmented_scan": 0.0}
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
            self._check(name, a, k, got, plain(*a, **k))
            return got
        return call

    def _check(self, name, a, k, got, want) -> None:
        kernel = "sorted_probe" if name == "sorted_probe" else "segmented_scan"
        v = a[0]
        if name == "sorted_probe":
            op = "probe"
        else:  # segment_reduce(v, ids, n, op, valid), segmented_scan(v, f, op)
            i = 3 if name == "segment_reduce" else 2
            op = k.get("op", a[i] if len(a) > i else "add")
        rec = {"wrapper": name, "op": op, "dtype": str(v.dtype)[6:],
               "shape": list(v.shape)}
        if name == "sorted_probe":
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
        rec.update(ok=ok, check=how, max_abs_err=err)
        self.calls.append(rec)
        self.max_err[kernel] = max(self.max_err[kernel], err)
        if not ok:
            self.failures.append(rec)

    def summary(self) -> str:
        parts = []
        for c in self.calls:
            size = f"N={c['shape'][0]}" + (f" M={c['queries']}"
                                           if "queries" in c else "")
            parts.append(f"{c['wrapper']} {c['op']} {c['dtype']} {size}: "
                         f"{c['check']}")
        return "; ".join(parts)


def phase_flows(res: dict, dev) -> dict:
    """The main path: every flow optimized, compiled with the kernels and
    driven through `run` and through `bind_device` + `run_device`; launch
    counts are set to zero just before and read just after.  Every kernel
    call on the way is checked against its plain version, and both results
    against the eager executor."""
    from repro_torch.core import executor
    from repro_torch.core.optimizer import optimize
    from repro_torch.kernels import ops

    plans, total, calls = {}, {k: 0 for k in DATA_KERNELS}, {}
    max_err = {k: 0.0 for k in DATA_KERNELS}
    for name in ("q15", "q7", "clickstream", "textmining"):
        t = time.perf_counter()
        root, b = _flow(name)
        cp = optimize(root).best.compile(use_kernels=True, device=dev)
        t_plan = time.perf_counter() - t
        with Checker() as chk:
            ops.reset_launches()
            out = cp.run(b)
            out_dev = cp.run_device(cp.bind_device(b))
            torch.cuda.synchronize()
            launches = {k: ops.LAUNCHES[k] for k in DATA_KERNELS}
        if chk.failures:
            raise AssertionError(f"{name}: kernel calls disagree with their "
                                 f"plain versions: {chk.failures}")
        n_calls = len(chk.calls)
        for k, v in launches.items():
            total[k] += v
            max_err[k] = max(max_err[k], chk.max_err[k])
        calls[name] = chk.calls
        t = time.perf_counter()
        ref = executor.execute(root, b)
        t_eager = time.perf_counter() - t
        dev_rb = out_dev.to_record_batch()
        for what, got in (("run", out), ("run_device", dev_rb)):
            if got.capacity == 0 or not got.equivalent(ref):
                raise AssertionError(f"{name} {what}: {got.capacity} rows, "
                                     f"eager {ref.capacity}, not equivalent")
        say("flows", f"{name} {FLOW_ROWS[name]} {FLOW_SOURCE[name]} rows -> "
            f"{out.capacity} rows; run and run_device equal eager; plan "
            f"{cp.flow.op_names()[::-1]}; launches {launches}; data+optimize "
            f"{t_plan:.1f}s, eager {t_eager:.1f}s")
        say("flows", f"{name} kernel calls ({n_calls}, each held against its "
            f"plain version): {chk.summary() or 'none'}")
        if name == "q15":
            res["q15_first_calls"] = chk.first
        plans[name] = (cp, b)
    for k, v in total.items():
        if v == 0:
            raise AssertionError(f"kernel {k} was never launched on the path")
    res["launches"] = total
    res["path_max_abs_err"] = max_err
    res["kernel_calls"] = calls
    say("flows", f"launches over the four flows (run + run_device): {total}")
    return plans


def phase_timing(res: dict, plans: dict) -> list:
    from repro_torch.core.scans import identity_for
    from repro_torch.kernels import ops, ref

    cp, b = plans["q15"]
    masked = cp.bind_device(b)
    run_ms, dev_ms = [], []
    for _ in range(5):
        t = time.perf_counter()
        cp.run(b)
        run_ms.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        t = time.perf_counter()
        cp.run_device(masked)
        torch.cuda.synchronize()
        dev_ms.append((time.perf_counter() - t) * 1e3)
    res["q15_run_ms"] = float(np.median(run_ms))
    res["q15_run_device_ms"] = float(np.median(dev_ms))
    st = cp.cache_stats()
    say("timing", f"q15 warm x5: run median {res['q15_run_ms']:.2f} ms, "
        f"run_device median {res['q15_run_device_ms']:.3f} ms "
        f"({FLOW_ROWS['q15'] / res['q15_run_device_ms'] * 1e3:.4g} lineitem "
        f"rows/s); executable builds {st.traces}, hits {st.hits}")

    seen = res.pop("q15_first_calls")
    errs = res["path_max_abs_err"]
    kernels = []
    # sorted_probe at the first probe q15 runs
    (keys, q), _ = seen["sorted_probe"]
    n, m, isz = keys.shape[0], q.shape[0], keys.element_size()
    bytes_ = n * isz + m * isz + m * 4
    opers = m * max(1, math.ceil(math.log2(n + 1)))
    kernels.append(_entry(
        "sorted_probe", res["launches"], errs["sorted_probe"],
        cuda_ms(lambda: ops.sorted_probe(keys, q), 50),
        cuda_ms(lambda: ref.sorted_probe(keys, q), 50),
        bytes_, opers, cuda_ms(lambda: torch.searchsorted(keys, q), 50),
        f"N={n} keys, M={m} queries, {keys.dtype}"))
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
    lib = cuda_ms(lambda: torch.segment_reduce(vm, reduce, lengths=lengths,
                                               unsafe=True), 50)
    kernels.append(_entry(
        "segmented_scan", res["launches"], errs["segmented_scan"],
        cuda_ms(lambda: ops.segment_reduce(v, sid, nseg, op=op, valid=valid), 50),
        cuda_ms(lambda: ref.segment_reduce(v, sid, nseg, op=op, valid=valid), 50),
        bytes_, nrow, lib,
        f"segment_reduce {op}, N={nrow} rows, {nseg} segments, {v.dtype}"))
    for k in kernels:
        say("timing", f"{k['name']} at q15's shape ({k.pop('shape')}): "
            f"ms={k['ms']:.4f} plain_ms={k['plain_ms']:.4f} "
            f"library_ms={k['library_ms']:.4f} bound_ms={k['bound_ms']:.4f} "
            f"({k['bound_by']}); max_abs_err over the path's calls "
            f"{k['max_abs_err']:g}")
    return kernels


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
    from torch.profiler import ProfilerActivity, profile

    cp, b = plans["q15"]
    masked = cp.bind_device(b)
    cp.run_device(masked)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        cp.run_device(masked)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    busy, n_kernels, per_name = _device_busy(prof)
    if busy <= 0:
        say("profile", "the profiler recorded no device kernels: device "
            "busy time and idle share not measured")
        return
    repo = sum(t for k, t in per_name.items()
               if any(r in k for r in REPO_KERNELS))
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
    plain_us = res["q15_run_device_ms"] * 1e3
    res["q15_profile"] = {
        "profiled_wall_us": wall_us, "device_busy_us": busy,
        "idle_share_profiled": 1 - busy / wall_us,
        "unprofiled_median_us": plain_us,
        "idle_share": max(0.0, 1 - busy / plain_us),
        "host_us_per_device_kernel": plain_us / n_kernels,
        "repo_kernel_us": repo, "device_kernels": n_kernels, "top": top}
    say("profile", f"q15 run_device: device busy {busy:.0f} us in "
        f"{n_kernels} device kernels, repo kernels {repo:.0f} us; against "
        f"the unprofiled median run_device {plain_us:.0f} us idle share "
        f"{res['q15_profile']['idle_share']:.3f}, "
        f"{plain_us / n_kernels:.1f} us of wall per device kernel; the "
        f"profiled run's own wall {wall_us:.0f} us (idle share "
        f"{1 - busy / wall_us:.3f}) includes the profiler's overhead")
    for k, t in top:
        say("profile", f"  {t:10.1f} us  {k[:90]}")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "q15_profile.txt"), "w") as f:
        f.write(prof.key_averages().table(row_limit=40))


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
            ok, err = _attn_close(got, want, q.dtype)
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


def phase_serve(res: dict, dev) -> dict:
    """Token serving, the model plane's main path: qwen3-0.6b at full width
    and depth through Engine -> prefill / decode_step with the flash
    kernel.  Launch counts are set to zero just before the checked run and
    read just after it."""
    from torch.profiler import ProfilerActivity, profile

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
    for r in reqs:
        if len(r.out_tokens) != SERVE_NEW or not r.done or not all(
                0 <= x < cfg.padded_vocab for x in r.out_tokens):
            raise AssertionError(f"request of {len(r.prompt)} tokens: bad "
                                 f"output {r.out_tokens}")
    shapes = sorted({c[0] for c in chk.calls})
    say("serve", f"checked run: {SERVE_REQUESTS} requests, prompts "
        f"{[len(p) for p in prompts]}, {SERVE_NEW} new tokens each; "
        f"{len(chk.calls)} flash calls at q shapes {shapes}, each within "
        f"atol=rtol={ATTN_TOL[torch.bfloat16]:g} of the plain attention "
        f"(max abs err {chk.max_err:.4g}); launches {launches}")

    # timed run, no checks
    with StepTimer(model) as tm:
        t = time.perf_counter()
        timed = engine.generate(requests())
        wall = time.perf_counter() - t
    n_tok = sum(len(r.out_tokens) for r in timed)
    same = all(a.out_tokens == b.out_tokens for a, b in zip(reqs, timed))
    dec = tm.ms["decode_step"]
    serve = {"tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
             "prefill_ms": tm.ms["prefill"],
             "decode_ms_per_step_median": float(np.median(dec)),
             "decode_ms_per_step_mean": float(np.mean(dec)),
             "decode_steps": len(dec), "tokens_equal_checked_run": same,
             "out_tokens_first": timed[0].out_tokens}
    say("serve", f"timed run: {n_tok} tokens in {wall:.3f}s = "
        f"{serve['tokens_per_s']:.1f} tokens/s; prefill ms per chunk "
        f"{[round(x, 2) for x in serve['prefill_ms']]}; decode "
        f"{serve['decode_ms_per_step_median']:.3f} ms per step median "
        f"({SERVE_SLOTS} tokens a step, {len(dec)} steps); greedy tokens "
        f"equal to the checked run's: {same}")

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
    diff = (lf - lp).abs()
    logit_err = float(diff.max())
    ok = bool((diff <= LOGIT_TOL + LOGIT_TOL * lp.abs()).all())
    agree = float((lf.argmax(-1) == lp.argmax(-1)).float().mean())
    if not (ok and torch.isfinite(lf).all()):
        raise AssertionError(f"prefill logits: flash vs plain max abs err "
                             f"{logit_err:g} over atol=rtol={LOGIT_TOL:g}")
    serve.update(logit_max_abs_err=logit_err, logit_max_abs=float(lp.abs().max()),
                 argmax_agree=agree)
    say("serve", f"prefill last-token logits [{toks.shape[0]}, 1, "
        f"{lf.shape[-1]}] on the kernel path vs plain attention: max abs err "
        f"{logit_err:.4g} (|logit| up to {serve['logit_max_abs']:.3g}; "
        f"atol=rtol={LOGIT_TOL:g}); argmax agrees on {agree:.2f} of rows")

    # one decode step profiled after two unprofiled ones
    tok = lf.argmax(-1)
    step_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out, state = model.decode_step(tok, state)
        tok = out.argmax(-1)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
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
        say("serve", f"decode step: device busy {busy:.0f} us in {n_kernels} "
            f"device kernels; against the timed run's median step "
            f"{step_us:.0f} us idle share "
            f"{serve['decode_profile']['idle_share']:.3f} ("
            f"{step_us / n_kernels:.1f} us of wall per device kernel; "
            f"profiled wall {wall_us:.0f} us)")
        for k, v in top:
            say("serve", f"  {v:10.1f} us  {k[:90]}")
    else:
        say("serve", "the profiler recorded no device kernels: decode busy "
            "time and idle share not measured")
    res["serve"] = serve

    # the kernel's numbers at the main path's first call
    q, k, v, causal, window = chk.first
    b, hq, tq, d = q.shape
    bytes_ = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    opers = _attn_flops(b, hq, tq, k.shape[2], d, causal, window)
    entry = _entry(
        "flash_attention", launches, chk.max_err,
        cuda_ms(lambda: ops.flash_attention(q, k, v, causal=causal,
                                            window=window), 20),
        cuda_ms(lambda: ref.attention(q, k, v, causal=causal, window=window),
                3),
        bytes_, opers, cuda_ms(lambda: _sdpa(q, k, v, causal, window), 20),
        f"q {list(q.shape)}, k/v {list(k.shape)}, causal, "
        f"{str(q.dtype)[6:]}", BF16_TENSOR_OPS_PER_S)
    say("serve", f"flash_attention at the first prefill's shape "
        f"({entry.pop('shape')}): ms={entry['ms']:.4f} "
        f"plain_ms={entry['plain_ms']:.4f} library_ms={entry['library_ms']:.4f} "
        f"(SDPA) bound_ms={entry['bound_ms']:.5f} ({entry['bound_by']}); "
        f"max_abs_err over the path's calls {entry['max_abs_err']:g}")
    return entry


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

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
        phase_kernels(res, dev)
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
    sys.exit(main())
