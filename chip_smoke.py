"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only probe,flash   # build + those checks only
    python3 chip_smoke.py --only dataflow      # build + flows, timing, profile
    python3 chip_smoke.py --only adaptive,serving   # build + those phases
    python3 chip_smoke.py --only mesh          # build + the sharded executor
    python3 chip_smoke.py --only flash,serve_moe,serve_mixtral,serve_vlm,serve_encdec
    python3 chip_smoke.py --only train         # build + the train phase
    python3 chip_smoke.py --only train_mesh    # build + the placed train step
    python3 chip_smoke.py --only dryrun        # build + the dry-run's checks

Drives the port's main paths through the hand-written CUDA kernels
(`src/repro_torch/csrc/`): the data-flow path — flow build + SCA ->
optimize -> compile(use_kernels=True) -> CompiledPlan.run / run_device — for
the paper's four evaluation flows at serving scale, on the default
megakernel route and on the composed route, every result checked against
the port's eager numpy executor; adaptive re-planning (observe ->
calibrate -> re-plan, `AdaptiveConfig`), the multi-tenant data-flow
engine (`serve.dataflow.DataflowEngine`) and the sharded executor
(`core.distributed`, 8 shards on the card) on the same kernels; and token
serving — Engine ->
Model.prefill / decode_step — at full width and depth for three models:
qwen3-0.6b with the flash-attention kernel, rwkv6-3b with the rwkv6_scan
kernel and recurrentgemma-2b with the linear_scan kernel; and the moe, vlm
and encdec families with the flash-attention kernel at full width:
qwen2-moe-a2.7b (full depth), mixtral-8x22b (4 of 56 layers),
phi-3-vision-4.2b and whisper-tiny; and training — launch.train's path,
Supervisor -> make_train_step (Model.loss, autograd, AdamW) fed by the
data-flow TokenPipeline — for qwen3-0.6b at full width and depth, on
which no kernel runs (the kernels raise under autograd), plain and placed
on the card's one-rank NCCL mesh (`launch.mesh`, `parallel.sharding`).
Phases, one or more lines each:

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
           (span_compact for up to 32 columns, span_segment for up to 33
           keys); segmented_scan, span_compact and span_segment (up to 32
           keys) one device kernel a call, as the profiler counts;
           flash
           attention at the reference test's seven shapes, at head dim 96
           (both dtypes, causal and windowed) and the served shapes (as
           the prefill lays them out, [B,T,H,D] memory: qwen3-0.6b's two
           chunks, phi-3-vision's first at head dim 96, whisper-tiny's
           encoder and its decoder's prefill and decode cross-attention,
           non-causal over 1,500 frames), timed against the plain version
           and SDPA, with a bound; the probe's
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
           each kernel at the shapes q15 gives it (span_segment at both of
           q15's calls and at clickstream's largest): time, the profiler's
           device time and device kernels a call, plain time, library-call
           time and bound
  profile  torch.profiler over a warm q15 run_device on each route: device
           kernels per step, device busy time, idle share against the
           unprofiled step time, top device ops, repo-kernel time; then
           q15's and q7's device kernels per step on each route with the
           join probe as one launch and, in turns, as the parent tree's
           four (search, cast, maximum, clamp)
  adaptive q15_drift at 6M lineitem rows (hint 1.0, true selectivity
           0.04): eight seeds bound on the card once, served in turn
           through compile(use_kernels=True, adaptive=AdaptiveConfig(
           check_every=2, patience=2)).run_device on the mega route, every
           kernel call against its plain version and every batch against
           eager; exactly one swap and no build after it; launches per
           kernel; warm step medians in turns (unobserved, observed before
           and after the swap, the oracle plan), recovery = oracle /
           post-swap, device kernels and device-to-host copies of one
           profiled observed step; then hint 0.001, whose truncation
           force-swaps and re-runs on unchanged inputs, equal to eager, on
           the mega route
  serving  the launcher's four tenants (q15, click, text with calibrated
           hints; drift at 25x) through DataflowEngine(ServeConfig(
           max_coalesce=16, probe_every=8, use_kernels=True)) with a pump
           thread, 64 requests of 4,096 rows each: every kernel call
           against its plain version, every result against solo eager,
           drift swaps and the others do not, a further round after
           join_swaps builds and evicts nothing, launches per kernel; then
           a timed run on a second engine sharing the warm cache: req/s,
           p50 / p99 latency, coalesced share, truncations, serve_vs_solo
  mesh     the sharded executor on 8 shards of the card
           (optimize(root, Ctx(dop=8)), use_kernels=True, megakernel
           route): q15 (6M lineitem rows), q7 (1M), clickstream (16M) on
           both wires (overlap_slices 1 and 4): execute_distributed and a
           cold and a warm DistributedPlan.run_device equal eager, the
           wires byte-identical, no build on a warm step, every kernel call
           against its plain version, each data-plane kernel launched;
           routes per shard against the local plan's, the wire counters
           beside cost.wire_profile(dop=8), warm step ms of mesh K=1, mesh
           K=4 and the local CompiledPlan in turns, a profiled warm K=4
           step, peak memory; the combiner acceptance at 1,048,576 rows
           (>= 3x fewer wire rows); q15_drift at 6M rows served on the mesh
           through DistributedPlan(stats_store=) with a swap, every batch
           equal to eager
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
  serve_moe, serve_mixtral, serve_vlm, serve_encdec
           qwen2-moe-a2.7b (24 layers, 60 experts top-4 + 4 shared, bf16
           weights), mixtral-8x22b (d_model 6144, 8 experts top-2, window
           4096, bf16 weights, cut to 4 layers), phi-3-vision-4.2b (32
           layers, head dim 96, f32 weights) and whisper-tiny (4 + 4
           layers over 1,500 audio frames, f32 weights), bf16 activations,
           attn_impl="flash", seeded weights drawn in place (peak memory
           right after init); the same 8 requests through the Engine
           (phi-3-vision as text, as the reference's Engine serves it),
           whisper through Model.prefill with seeded audio frames [4,
           1500, 384] and 32 greedy decode steps a chunk: every flash call
           held against the plain attention, the launches counted (one a
           prefill layer; whisper also one an encoder layer and one a
           cross-attention a prefill and decode step), the MoE prefill's
           capacity-dropped (token, k) share; the timed run and peak
           memory; the first chunk's prefill logits against plain
           attention on the same weights (phi-3-vision also with seeded
           img_embeds [4, 144, 3072]) as the recurrent phases hold theirs:
           within LOGIT_TOL with float32 activations, and with bf16 ones
           the kernel path no farther from the float32 logits than twice
           the plain path (the MoE paths all routed as the float32 plain
           path; each routing itself, the share routed alike and the
           jump are reported); the profiled decode step
  train    qwen3-0.6b REDUCED in float32, TF32 off: one train step on the
           card against the same step on the CPU (loss within 1e-5,
           every gradient leaf within 1e-5 + 1e-4, the parameters after
           AdamW within 1e-6); flash_attention, rwkv6_scan and
           linear_scan raise under autograd with no launch; a supervised
           run restarted from two injected failures against an
           uninterrupted one (1e-6), saying whether deterministic
           algorithms were on; then qwen3-0.6b FULL (f32 parameters and
           AdamW moments, bf16 activations, plain attention), batch 8 x
           512 from TokenPipeline, 12 steps under the Supervisor with one
           final checkpoint in a temporary directory (its s and GB):
           every loss and gradient norm finite, the first loss within 1.0
           of ln(vocab), the card's batches equal the CPU's; median step
           ms, tokens/s, peak memory; a step's parts (host, forward,
           backward, AdamW) by CUDA events and under torch.profiler
           (device busy, kernels, idle share, top kernels); 20 steps on
           one batch at lr 1e-3 that must cut the loss by 1.0
  train_mesh
           launch.train's placed path: `launch.train.setup` (qwen3-0.6b
           FULL, batch 8 x 512 from TokenPipeline) on make_host_mesh's
           one-rank NCCL mesh, parameters placed by validated_pspecs,
           batches by batch_pspec, against the plain step on the same
           model's parameters and batches: TRAIN_MESH_STEPS steps of each
           under the Supervisor, the losses (within 1e-5) and the final
           parameters (within 1e-6), saying whether they are bit for bit;
           the placed checkpoint restored by elastic_restore(..., mesh,
           validated_pspecs), bit for bit with every placement kept; both
           steps timed in turns on the final states, profiled (device
           kernels, busy, idle share against the median step)
  dryrun   launch.dryrun under the card's torch: qwen3-0.6b x train_4k,
           qwen2-moe-a2.7b x prefill_32k and rwkv6-3b x long_500k on
           torch's fake process group (16x16, 256 ranks), one CLI process
           each on the CPU with a time limit, each row [ok] (bound,
           useful_ratio, roofline_fraction, fit peak, wall time); while
           they run, the dry-run's count of the train phase's cell
           (qwen3-0.6b FULL, 8 x 512, registry config) on meta tensors
           placed on the card's one-rank NCCL mesh against one real plain
           step on the card: FLOPs equal to FlopCounterMode's, the
           predicted peak within 15% of the step's max_memory_allocated,
           the bound max(t_compute, t_memory) at or below the median of 5
           steps

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
import threading
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
# (earlier trees' tile_reduce / tile_carries / tile_apply, compact_count /
# compact_scatter and segment_count / block_offsets / segment_write stay on
# the list, so the profile phase tallies them when this script measures
# such a tree)
REPO_KERNELS = ("probe_kernel", "segscan_lookback", "compact_lookback",
                "segment_lookback", "key_differs", "tile_reduce",
                "tile_carries", "tile_apply", "compact_count",
                "compact_scatter", "block_offsets", "segment_count",
                "segment_write", "flash_bf16", "flash_f32", "wkv6_kernel",
                "linear_scan_kernel")
# the routes the default span budget gives at these sizes
EXPECTED_ROUTES = {"q15": (("mega", 0, 4),), "q7": (("mega", 0, 7),),
                   "clickstream": (("mega", 0, 4),), "textmining": None}
ROUTES = ("mega", "composed")
SPAN_ROWS = 8_388_608  # q15's lineitem capacity at 6M rows

# adaptive re-planning: q15_drift at q15's size, the filter's hint 25x over
# the data's 4% (benchmarks/bench_adaptive.py's workload), and a truncating
# underestimate
DRIFT_HINT, DRIFT_SEL, DRIFT_SEEDS = 1.0, 0.04, 8
UNDER_HINT = 0.001
ADAPTIVE_ROUNDS = 21   # warm steps of each plan, taken in turns
# multi-tenant serving: the launcher's four tenants and engine config
TENANT_ROWS, TENANT_REQUESTS, COALESCE = 4096, 64, 16

# the sharded executor: 8 shards on the one card, both wires; the combiner
# acceptance at 2^20 rows; q15_drift served on the mesh
MESH_SHARDS, WIRES, MESH_ROUNDS = 8, (1, 4), 11
COMBINER_ROWS = 1_048_576
MESH_DRIFT_SEEDS, MESH_DRIFT_BATCHES = 3, 6

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
# token serving through the moe, vlm and encdec families, same requests,
# bf16 activations and attn_impl="flash": qwen2-moe with bf16 parameters
# to fit (~14.3B of them), mixtral-8x22b (~141B, fits in no dtype) at full
# width cut to 4 of its 56 layers with bf16 parameters; phi-3-vision and
# whisper-tiny at full size, as the registry gives them
FAMILY_PHASES = {
    "serve_moe": ("qwen2-moe-a2.7b", dict(param_dtype="bfloat16")),
    "serve_mixtral": ("mixtral-8x22b", dict(param_dtype="bfloat16",
                                            n_layers=4)),
    "serve_vlm": ("phi-3-vision-4.2b", {}),
    "serve_encdec": ("whisper-tiny", {}),
}
IMG_SEED, AUDIO_SEED = 1, 2   # the seeded image prefix and audio frames
# training: qwen3-0.6b at full width and depth (float32 parameters and
# AdamW state, bf16 activations, plain attention: the registry's config)
# fed by the data-flow TokenPipeline; seq 512 keeps the plain attention's
# float32 scores and probabilities ([8, 16, 512, 512], 134 MB a layer,
# kept for the backward) well inside the card
TRAIN_ARCH = "qwen3-0.6b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 12
MEMO_STEPS = 20                 # steps on one repeated batch
# launch.train's placed path against the plain step: supervised steps of
# each, then warm steps of each taken in turns
TRAIN_MESH_STEPS, TRAIN_MESH_ROUNDS = 4, 5
# the dry-run (launch.dryrun) on the card's torch: three production cells
# on torch's fake process group (16x16), one CLI process each, on the CPU,
# within DRYRUN_TIMEOUT_S; then its count of the train phase's own cell on
# the card's one-rank mesh against a real plain step: FLOPs equal to
# FlopCounterMode's, the predicted peak within DRYRUN_PEAK_TOL of the
# step's, the roofline bound at or below the median of DRYRUN_STEPS steps
DRYRUN_CELLS = (("qwen3-0.6b", "train_4k"), ("qwen2-moe-a2.7b", "prefill_32k"),
                ("rwkv6-3b", "long_500k"))
DRYRUN_TIMEOUT_S = 480
DRYRUN_PEAK_TOL = 0.15
DRYRUN_STEPS = 5
# card against CPU, float32 with TF32 off: loss, every gradient leaf (atol
# + rtol, as tests/test_models.py holds remat against no remat) and the
# parameters after one AdamW step
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, TRAIN_PARAM_TOL = 1e-5, (1e-5, 1e-4), 1e-6
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
# head dim 96 (phi-3-vision), which runs at the padded width 128 in bf16,
# in both dtypes, causal and windowed
ATTN_D96_SHAPES = [
    ((1, 4, 2, 200, 200, 96), True, None, torch.float32),
    ((1, 2, 2, 333, 333, 96), True, 64, torch.float32),
    ((1, 2, 2, 333, 333, 96), True, 64, torch.bfloat16),
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
    test's seven shapes, at head dim 96, at the two shapes the serve phase
    gives it, at phi-3-vision's first prefill (head dim 96) and at
    whisper-tiny's three non-causal shapes (the encoder, the decoder
    prefill's cross-attention, a decode step's cross-attention)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref

    cfg = get_config(SERVE_ARCH)
    lens = [len(p) for p in serve_prompts(cfg.vocab)]
    chunks = [max(lens[i:i + SERVE_SLOTS])
              for i in range(0, len(lens), SERVE_SLOTS)]
    served = [((SERVE_SLOTS, cfg.n_heads, cfg.kv_heads, t, t, cfg.head_dim),
               True, None, torch.bfloat16) for t in chunks]
    vlm = get_config(FAMILY_PHASES["serve_vlm"][0])
    wh = get_config(FAMILY_PHASES["serve_encdec"][0])
    heads = (SERVE_SLOTS, wh.n_heads, wh.kv_heads)
    served += [((SERVE_SLOTS, vlm.n_heads, vlm.kv_heads, chunks[0], chunks[0],
                 vlm.head_dim), True, None, torch.bfloat16)] + [
        (heads + (t, wh.n_audio_frames, wh.head_dim), False, None,
         torch.bfloat16) for t in (wh.n_audio_frames, chunks[0], 1)]
    g = torch.Generator().manual_seed(3)
    rows = []
    cases = [(c, False) for c in ATTN_TEST_SHAPES + ATTN_D96_SHAPES] + [
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
        self.segments: dict = {}     # rows -> span_segment's (args, kwargs)
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
            if name == "span_segment":
                self.segments.setdefault(int(a[1].shape[0]), (a, k))
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
            if route == "mega" and chk.segments:
                res.setdefault("segment_calls", {})[name] = chk.segments
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
    # span_segment at q15's first in-span Reduce (the kernels line's row),
    # then each call of the main path timed alike: both of q15's and
    # clickstream's largest
    calls = res.pop("segment_calls")
    shapes = [("q15", n) for n in sorted(calls["q15"], reverse=True)]
    shapes.append(("clickstream", max(calls["clickstream"])))
    rows = [_segment_times(flow, *calls[flow][n][0]) for flow, n in shapes]
    (keys, svalid), _ = calls["q15"][shapes[0][1]]
    first = rows[0]
    entry = _entry(
        "span_segment", res["launches"], errs["span_segment"], first["ms"],
        first["plain_ms"], _segment_bytes(keys, svalid.shape[0],
                                          first["valid"]),
        svalid.shape[0] * max(len(keys), 1), None,
        f"N={svalid.shape[0]} rows, {first['valid']} valid, {len(keys)} "
        f"key(s) ({', '.join(str(k.dtype)[6:] for k in keys)}), "
        f"{first['groups']} groups")
    entry.update(device_us=first["device_us"],
                 kernels_per_call=first["kernels_per_call"],
                 valid=first["valid"], calls=rows)
    kernels.append(entry)
    for r in rows:
        say("timing", f"span_segment at {r['flow']}'s call (N={r['n']} rows, "
            f"{r['valid']} valid, {r['keys']} key(s), {r['groups']} groups): "
            f"ms={r['ms']:.4f} (device us {_us(r['device_us'])}, "
            f"{r['kernels_per_call']} device kernel(s) a call) plain_ms="
            f"{r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
            f"({r['bound_by']}; {r['bound_all_keys_ms']:.4f} counting every "
            f"slot's key)")
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


def _segment_bytes(keys, n: int, valid: int) -> int:
    """span_segment's least traffic: the mask read once, the keys (each
    distinct tensor once) of the `valid` valid rows only (an invalid slot's
    flag does not depend on its keys), seg (int64) and is_start written
    once, and the count.  With `valid` = n: every slot's key, the looser
    count."""
    distinct = {k.data_ptr(): k for k in keys}.values()
    return n + sum(k.element_size() for k in distinct) * valid + 8 * n + n + 8


def _segment_times(flow: str, keys, valid) -> dict:
    """span_segment on one call's inputs: event ms, the profiler's device us
    and device kernels a call, the plain version's ms, and the bound (keys
    of valid rows only; beside it the bound counting every slot's key)."""
    from repro_torch.kernels import ops, ref

    n, nvalid = valid.shape[0], int(valid.sum())
    groups = int(ref.span_segment(keys, valid)[2])

    def kernel():
        return ops.span_segment(keys, valid)

    us, per_call = device_profile(kernel)
    bound = _bound(_segment_bytes(keys, n, nvalid), n * max(len(keys), 1))
    return {"flow": flow, "n": n, "valid": nvalid, "keys": len(keys),
            "groups": groups, "ms": cuda_ms(kernel, 50),
            "device_us": us, "kernels_per_call": per_call,
            "plain_ms": cuda_ms(lambda: ref.span_segment(keys, valid), 20),
            "bound_ms": bound[0], "bound_by": bound[1],
            "bound_all_keys_ms": _bound(_segment_bytes(keys, n, n),
                                        n * max(len(keys), 1))[0]}


def _span_kernel_checks(res: dict, dev) -> None:
    """The span kernels against their plain versions, bitwise on every
    slot, at q15's lineitem capacity (8,388,608 rows): span_compact for K =
    1, 3, 6, 12, 17 and 32 mixed int64/float64 columns into q15's interior
    capacity with the valid count below it, above it and 0, one device
    kernel a call (the profiler's count); span_segment on one int64 key and on mixed
    int64/float64 keys, packed, gappy and empty, on 10 and 32 keys of which
    only the last two tell slots apart, each one device kernel a call, and
    on 33 keys of which only the last does (past 32 keys the kernel's flag
    pass runs first: a device kernel more for each group of 32)."""
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
            "10 keys (8 constant)": [z] * 8 + [a.to(dev), b.to(dev)],
            "32 keys (30 constant)": [z] * 30 + [a.to(dev), b.to(dev)],
            "33 keys (32 constant)": [z] * 32 + [a.to(dev)]}
    packed = torch.arange(n) < (n * 7) // 10
    cases = [("1 int64 key", "packed"), ("int64+float64 keys", "packed"),
             ("int64+float64 keys", "gappy"), ("int64+float64 keys", "count 0"),
             ("10 keys (8 constant)", "packed"),
             ("10 keys (8 constant)", "gappy"),
             ("32 keys (30 constant)", "packed"),
             ("32 keys (30 constant)", "gappy"),
             ("33 keys (32 constant)", "gappy")]
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
        groups, nvalid = int(want[2]), int(valid.sum())
        ms = cuda_ms(lambda: ops.span_segment(ks, valid), 20)
        call = f"span_segment N={n} {kname} {mname}"
        if len(ks) <= 32:
            dev_us, per_call = one_kernel(
                call, lambda: ops.span_segment(ks, valid)), 1
        else:  # the flag pass: one key_differs launch a group of 32 more
            dev_us, per_call = device_profile(
                lambda: ops.span_segment(ks, valid), 5)
            if per_call != 1 + -(-len(ks) // 32):
                raise AssertionError(f"{call}: {per_call} device kernels a "
                                     f"call, expected {1 + -(-len(ks) // 32)}")
        plain = cuda_ms(lambda: ref.span_segment(ks, valid), 5)
        bound = _bound(_segment_bytes(ks, n, nvalid), n * len(ks))
        rows.append({"kernel": "span_segment", "keys": kname, "case": mname,
                     "valid": nvalid, "groups": groups, "ms": ms,
                     "device_us": dev_us, "kernels_per_call": per_call,
                     "plain_ms": plain, "bound_ms": bound[0],
                     "bound_by": bound[1]})
        say("kernels", f"span_segment N={n} {kname}, {mname} ({nvalid} "
            f"valid, {groups} groups): bitwise equal on every slot; "
            f"ms={ms:.4f} (device us {_us(dev_us)}, {per_call} device "
            f"kernel(s) a call) plain_ms={plain:.4f} bound_ms={bound[0]:.4f} "
            f"({bound[1]})")
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


def _union(spans) -> float:
    """The length of the union of (start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


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
    return _union(spans), len(spans), per_name


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



# ---------------------------------------------------------------------------
# adaptive re-planning and multi-tenant serving
# ---------------------------------------------------------------------------
def _all_equal(phase: str, what: str, outs, refs) -> None:
    """Each served result (a RecordBatch or a device MaskedBatch) equal to
    its eager result: integers exactly, floats within 1e-5."""
    for i, (got, ref) in enumerate(zip(outs, refs)):
        if hasattr(got, "to_record_batch"):
            got = got.to_record_batch()
        if not got.equivalent(ref):
            raise AssertionError(f"{phase}: {what} {i}: {got.capacity} rows, "
                                 f"eager {ref.capacity}, not equivalent")


def _call_shapes(chk) -> dict:
    """The distinct row counts (N) each kernel saw in a checked run."""
    out: dict = {}
    for c in chk.calls:
        out.setdefault(Checker.KERNEL[c["wrapper"]], set()).add(c["shape"][0])
    return {k: sorted(v) for k, v in sorted(out.items())}


def _kernels_launched(phase: str, launches: dict) -> None:
    missing = [k for k in DATA_KERNELS if not launches[k]]
    if missing:
        raise AssertionError(f"{phase}: kernels {missing} never launched on "
                             f"the path: {launches}")


def _d2h_copies(prof) -> int:
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and ("DtoH" in e.name or "Device -> Pageable" in e.name))


def _profiled_step(step, reps: int = 4) -> dict:
    """Device kernels, device-to-host copies, device busy us and the top
    device ops of one warm `step()` under torch.profiler: the profiled
    step with the most records of `reps` (the profiler now and then drops
    records, never adds them)."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    out = {"device_kernels": 0, "d2h_copies": 0, "device_busy_us": 0.0,
           "top": []}
    for _ in range(reps):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        b, n, per_name = _device_busy(prof)
        d2h = _d2h_copies(prof)
        if n - d2h > out["device_kernels"]:
            top = sorted(per_name.items(), key=lambda kv: -kv[1])[:4]
            out.update(device_kernels=n - d2h, device_busy_us=b,
                       top=[(k[:60], round(t, 1)) for k, t in top])
        out["d2h_copies"] = max(out["d2h_copies"], d2h)
    return out


def _host_us(fn, reps: int = 200) -> float:
    """Median host us of `fn()` (host-only work: no device sync inside)."""
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t) * 1e6)
    return float(np.median(ts))


def _in_turns(steps: dict, rounds: int) -> dict:
    """Warm step ms of each named `step()`, host clock around a synchronize,
    taken in turns (the order reversed every other round): {name:
    (q1, median, q3)}."""
    ms = {k: [] for k in steps}
    names = list(steps)
    for i in range(rounds):
        for k in (names if i % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            t = time.perf_counter()
            steps[k]()
            torch.cuda.synchronize()
            ms[k].append((time.perf_counter() - t) * 1e3)
    return {k: _quartiles(v) for k, v in ms.items()}


def phase_adaptive(res: dict, dev) -> None:
    """q15_drift at q15's size (6M lineitem rows, 10,000 suppliers) with the
    filter's hint at 1.0 against a true selectivity of 0.04: eight seeds'
    batches bound on the card once and served in turn through
    `compile(use_kernels=True, adaptive=AdaptiveConfig(check_every=2,
    patience=2))` on `run_device` (mega route), every kernel call held
    against its plain version and every batch against the eager executor;
    exactly one swap, no build after it.  Then the warm steps in turns:
    unobserved, observed before the swap (a handle of the shipped plan
    whose drift check never comes due), observed after it, and the oracle
    plan (`q15_drift(hint_selectivity=0.04)`, no adaptivity); recovery =
    oracle / post-swap; one profiled observed step's device kernels and
    device-to-host copies.  Last, the truncating underestimate (hint
    0.001): the force-swap re-runs the batch on its untouched inputs,
    equals eager and stays on the mega route."""
    from repro_torch.configs import flows
    from repro_torch.core import executor
    from repro_torch.core.optimizer import optimize
    from repro_torch.core.pipeline import AdaptiveConfig, ExecutableCache
    from repro_torch.kernels import ops

    n = FLOW_ROWS["q15"]
    t = time.perf_counter()
    root, make = flows.q15_drift(hint_selectivity=DRIFT_HINT)
    oracle_root, _ = flows.q15_drift(hint_selectivity=DRIFT_SEL)
    batches = [make(n, seed=s, true_sel=DRIFT_SEL)
               for s in range(DRIFT_SEEDS)]
    refs = [executor.execute(root, b) for b in batches]
    t_data = time.perf_counter() - t
    cache = ExecutableCache()
    shipped = optimize(root, include_commutes=False)
    cfg = AdaptiveConfig(check_every=2, patience=2)
    cp = shipped.compile(use_kernels=True, device=dev, cache=cache,
                         adaptive=cfg)
    t = time.perf_counter()
    staged = [cp.bind_device(b) for b in batches]
    torch.cuda.synchronize()
    t_bind = time.perf_counter() - t
    bound_gb = sum(c.numel() * c.element_size() + b.valid.numel()
                   for m in staged for b in m.values()
                   for c in b.columns.values()) / 1e9
    # the served run: in turns over the seeds until the swap, then every
    # seed once more; counts set to zero just before and read just after
    served, swap_at, traces_after = [], None, None
    with Checker() as chk:
        ops.reset_launches()
        i = 0
        while swap_at is None or i < swap_at + DRIFT_SEEDS:
            k = i % DRIFT_SEEDS
            served.append((k, cp.run_device(staged[k]).to_record_batch()))
            if swap_at is None and cp.swaps:
                swap_at = i
            elif swap_at is not None and traces_after is None:
                traces_after = cache.stats().traces  # the new regime built
            i += 1
            if swap_at is None and i >= 8 * DRIFT_SEEDS:
                raise AssertionError("adaptive: drift never swapped the plan")
        torch.cuda.synchronize()
        launches = {k: ops.LAUNCHES[k] for k in DATA_KERNELS}
    if chk.failures:
        raise AssertionError(f"adaptive: kernel calls disagree with their "
                             f"plain versions: {chk.failures}")
    _kernels_launched("adaptive", launches)
    _all_equal("adaptive", "served batch", [o for _, o in served],
               [refs[k] for k, _ in served])
    st = cache.stats()
    if cp.swaps != 1 or st.traces != traces_after:
        raise AssertionError(f"adaptive: {cp.swaps} swaps (expected 1), "
                             f"{st.traces - traces_after} builds after the "
                             f"swap's first batch (expected 0)")
    routes = cp._last_routes
    if not routes or not any(e[0] == "mega" for e in routes):
        raise AssertionError(f"adaptive: post-swap routes {routes}")
    shapes = _call_shapes(chk)
    hint = {m.name: m for m in cp.flow.iter_nodes()}[
        "FilterShipdate"].hints.selectivity
    say("adaptive", f"q15_drift {n} lineitem rows, hint {DRIFT_HINT} vs true "
        f"{DRIFT_SEL}: {DRIFT_SEEDS} seeds bound on the card once "
        f"({bound_gb:.2f} GB, bind {t_bind:.1f}s; data + eager "
        f"{t_data:.1f}s); {len(served)} batches served, swap at batch "
        f"{swap_at} to filter hint {hint:.4g}, {cp.swaps} swap, no build "
        f"after the new regime's first batch; routes {routes}; every batch "
        f"equals eager; launches {launches}; kernel calls ({len(chk.calls)}, "
        f"each held against its plain version) all agree; rows a call "
        f"{shapes}")

    # warm steps in turns
    pre = shipped.compile(use_kernels=True, device=dev, cache=cache,
                          adaptive=AdaptiveConfig(check_every=1 << 30))
    plain = shipped.compile(use_kernels=True, device=dev, cache=cache)
    oracle = optimize(oracle_root, include_commutes=False).compile(
        use_kernels=True, device=dev, cache=cache)
    m0 = staged[0]
    _all_equal("adaptive", "oracle / unobserved / pre-swap step",
               [oracle.run_device(m0), plain.run_device(m0),
                pre.run_device(m0)], [refs[0]] * 3)
    steps = {"unobserved": lambda: plain.run_device(m0),
             "observed_pre_swap": lambda: pre.run_device(m0),
             "observed_post_swap": lambda: cp.run_device(m0),
             "oracle": lambda: oracle.run_device(m0)}
    timing = _in_turns(steps, ADAPTIVE_ROUNDS)
    if cp.swaps != 1 or pre.swaps:
        raise AssertionError(f"adaptive: swaps while timing ({cp.swaps}, "
                             f"{pre.swaps})")
    prof = {k: _profiled_step(steps[k]) for k in
            ("unobserved", "observed_post_swap")}
    med = {k: v[1] for k, v in timing.items()}
    recovery = med["oracle"] / med["observed_post_swap"]
    # the observation's host work, alone: the device-to-host read of the
    # packed vector (the step already waited for) and the fold into a store
    from repro_torch.core.cost import StatsStore
    from repro_torch.core.pipeline import _read_observations

    mp, sig = cp._masked_sig(m0)
    _, packed, caps = cp._executable(sig)(mp)
    torch.cuda.synchronize()
    counts = _read_observations(packed)
    store = StatsStore()
    host = {"read_us": _host_us(lambda: _read_observations(packed)),
            "fold_us": _host_us(lambda: cp.fold_observation(store, counts,
                                                            caps=caps)),
            "device_values": int(packed[0].numel()),
            "vector_length": len(counts)}
    res["adaptive"] = {
        "rows": n, "hint": DRIFT_HINT, "true_sel": DRIFT_SEL,
        "seeds": DRIFT_SEEDS, "bound_gb": bound_gb, "swap_at_batch": swap_at,
        "swaps": cp.swaps, "post_swap_hint": hint, "routes": routes,
        "launches": launches, "kernel_calls": len(chk.calls),
        "shapes": shapes, "step_ms": timing, "rounds": ADAPTIVE_ROUNDS, "recovery": recovery,
        "speedup_vs_pre_swap": med["observed_pre_swap"]
        / med["observed_post_swap"], "profile": prof,
        "observation_host": host}
    for k, (q1, m, q3) in timing.items():
        say("adaptive", f"warm run_device {k}: median of {ADAPTIVE_ROUNDS} "
            f"{m:.3f} ms (quartiles {q1:.3f} / {q3:.3f})")
    say("adaptive", f"recovery (oracle / post-swap) {recovery:.3f}; post-swap "
        f"{res['adaptive']['speedup_vs_pre_swap']:.3f}x the pre-swap "
        f"observed step; profiled steps: {prof}; the observation's host "
        f"work (the step already waited for): read {host['read_us']:.1f} us "
        f"({host['device_values']} device values of a {host['vector_length']}"
        f"-long vector), fold {host['fold_us']:.1f} us")
    obs = prof["observed_post_swap"]["d2h_copies"]
    if obs != prof["unobserved"]["d2h_copies"] + 1:
        raise AssertionError(f"adaptive: an observed step makes {obs} "
                             f"device-to-host copies, the unobserved "
                             f"{prof['unobserved']['d2h_copies']}")

    # the truncating underestimate: force-swap, re-run, same inputs
    under, _ = flows.q15_drift(hint_selectivity=UNDER_HINT)
    ucp = optimize(under, include_commutes=False).compile(
        use_kernels=True, device=dev, cache=cache, adaptive=AdaptiveConfig())
    m1 = staged[1]
    before = {s: [c.clone() for c in b.columns.values()] + [b.valid.clone()]
              for s, b in m1.items()}
    with Checker() as chk:
        out = ucp.run_device(m1)
        torch.cuda.synchronize()
    if chk.failures:
        raise AssertionError(f"adaptive: kernel calls of the re-run disagree "
                             f"with their plain versions: {chk.failures}")
    _all_equal("adaptive", "re-run batch", [out], [refs[1]])
    unchanged = all(torch.equal(x, y) for s, b in m1.items()
                    for x, y in zip(list(b.columns.values()) + [b.valid],
                                    before[s]))
    uroutes = ucp._last_routes
    if ucp.swaps < 1 or not unchanged or not uroutes \
            or not any(e[0] == "mega" for e in uroutes):
        raise AssertionError(f"adaptive: underestimate {ucp.swaps} swaps, "
                             f"inputs unchanged {unchanged}, routes "
                             f"{uroutes}")
    res["adaptive"]["underestimate"] = {"hint": UNDER_HINT,
                                        "swaps": ucp.swaps, "routes": uroutes}
    say("adaptive", f"hint {UNDER_HINT} (a truncating underestimate): "
        f"{ucp.swaps} force-swap(s), the re-run equals eager on inputs bit "
        f"for bit unchanged, routes {uroutes}")
    del staged, before, m0, m1
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the sharded executor: 8 shards on the one card
# ---------------------------------------------------------------------------
def _same_bits(a, b) -> bool:
    """Two global batches with equal validity and column bits."""
    return set(a.columns) == set(b.columns) \
        and _bitwise_equal(a.valid, b.valid) \
        and all(_bitwise_equal(a.columns[f], b.columns[f]) for f in a.columns)


def _wire(stats) -> dict:
    return {"wire_rows": stats.wire_rows, "wire_bytes": stats.wire_bytes,
            "collectives": stats.collectives, "broadcasts": stats.broadcasts,
            "dispatches": stats.dispatches, "slices": stats.slices}


def _mesh_flow(res: dict, name: str, dev, total: dict) -> None:
    """One flow on MESH_SHARDS shards, both wires: the checked runs (every
    kernel call against its plain version, execute_distributed and a cold
    and a warm DistributedPlan.run_device against eager, the wires byte
    for byte, no build on the warm step, the wire counted once a build),
    then the warm steps in turns against the local CompiledPlan and one
    profiled warm K=4 step."""
    from repro_torch.core import distributed as TD
    from repro_torch.core import executor
    from repro_torch.core.cost import seed_source_stats, wire_profile
    from repro_torch.core.optimizer import optimize
    from repro_torch.core.physical import Ctx
    from repro_torch.core.pipeline import ExecutableCache
    from repro_torch.kernels import ops

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    root, b = _flow(name)
    ref = executor.execute(root, b)
    plan = optimize(root, Ctx(dop=MESH_SHARDS), include_commutes=False
                    ).best.plan
    local = optimize(root).best.compile(use_kernels=True, device=dev)
    t_prep = time.perf_counter() - t
    cache = ExecutableCache()
    dps = {k: TD.DistributedPlan(plan, mesh_shards=MESH_SHARDS,
                                 overlap_slices=k, use_kernels=True,
                                 cache=cache, device=dev) for k in WIRES}
    stats = TD.shuffle_stats()
    staged = dps[1].bind(b)
    outs, wires = {}, {}
    with Checker() as chk:
        ops.reset_launches()
        for k, dp in dps.items():
            stats.clear()
            once = TD.execute_distributed(plan, b, mesh_shards=MESH_SHARDS,
                                          overlap_slices=k, use_kernels=True,
                                          device=dev)
            once_wire = _wire(stats)
            stats.clear()
            cold = dp.run_device(staged)
            wires[k] = _wire(stats)
            builds = cache.stats().traces
            outs[k] = dp.run_device(staged)
            torch.cuda.synchronize()
            if cache.stats().traces != builds or _wire(stats) != wires[k] \
                    or once_wire != wires[k]:
                raise AssertionError(
                    f"mesh {name} K={k}: the warm step built "
                    f"{cache.stats().traces - builds} executables; wire "
                    f"one-shot {once_wire}, cold {wires[k]}, after the warm "
                    f"step {_wire(stats)}")
            _all_equal("mesh", f"{name} K={k} execute_distributed / cold / "
                       f"warm run_device", [once, cold, outs[k]], [ref] * 3)
            if not _same_bits(cold, outs[k]):
                raise AssertionError(f"mesh {name} K={k}: the warm step's "
                                     f"bits differ from the cold step's")
        launches = {k: ops.LAUNCHES[k] for k in DATA_KERNELS}
    if chk.failures:
        raise AssertionError(f"mesh {name}: kernel calls disagree with their "
                             f"plain versions: {chk.failures}")
    if not _same_bits(outs[1], outs[4]):
        raise AssertionError(f"mesh {name}: the K=1 and K=4 wires differ")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for k, v in launches.items():
        total[k] += v
    lm = local.bind_device(b)
    local.run_device(lm)
    steps = {"mesh_k1": lambda: dps[1].run_device(staged),
             "mesh_k4": lambda: dps[4].run_device(staged),
             "local": lambda: local.run_device(lm)}
    timing = _in_turns(steps, MESH_ROUNDS)
    prof = _profiled_step(steps["mesh_k4"])
    idle = max(0.0, 1 - prof["device_busy_us"] / (timing["mesh_k4"][1] * 1e3))
    # the model at the flow's declared scale, and priced at the bound rows
    model = {"declared": wire_profile(plan, dop=MESH_SHARDS),
             "bound": wire_profile(plan, dop=MESH_SHARDS,
                                   stats_memo=seed_source_stats(
                                       root, {n: v.capacity
                                              for n, v in b.items()}, {}))}
    res["mesh"]["flows"][name] = {
        "rows": FLOW_ROWS[name], "routes_per_shard": dps[4]._last_routes,
        "routes_local": local._last_routes, "launches": launches,
        "kernel_calls": len(chk.calls), "wire": wires,
        "wire_profile": model, "step_ms": timing, "profile": prof,
        "idle_share": idle, "peak_gb": peak_gb,
        "out_rows": outs[4].to_record_batch().capacity}
    say("mesh", f"{name} {FLOW_ROWS[name]} {FLOW_SOURCE[name]} rows on "
        f"{MESH_SHARDS} shards (data + eager + optimize {t_prep:.1f}s): "
        f"ships {[st.ship for st in dps[4].stages]}; routes per shard "
        f"{dps[4]._last_routes}, the local plan's {local._last_routes}; "
        f"execute_distributed and cold / warm run_device equal eager on "
        f"both wires, K=1 and K=4 byte-identical, no build on a warm step; "
        f"launches {launches}; kernel calls ({len(chk.calls)}, each held "
        f"against its plain version) all agree; peak memory "
        f"{peak_gb:.2f} GB")
    for k in WIRES:
        say("mesh", f"{name} K={k} wire (counted once a build, equal for "
            f"execute_distributed and the cold step): {wires[k]}")
    for scale, edges in model.items():
        say("mesh", f"{name} cost.wire_profile(dop={MESH_SHARDS}) at the "
            f"{scale} rows (valid rows the model prices; the wire ships "
            f"capacity slots): " + "; ".join(
                f"{e['op']} {e['ship']} rows {e['rows']:.0f} bytes "
                f"{e['bytes']:.0f}" for e in edges))
    for k, (q1, m, q3) in timing.items():
        say("mesh", f"{name} warm run_device {k}: median of {MESH_ROUNDS} "
            f"{m:.3f} ms (quartiles {q1:.3f} / {q3:.3f})")
    say("mesh", f"{name} profiled warm K=4 step: {prof['device_kernels']} "
        f"device kernels, busy {prof['device_busy_us']:.0f} us, idle share "
        f"{idle:.3f} against the median; top {prof['top']}")
    del staged, lm, outs
    torch.cuda.empty_cache()


def _combiner_check(res: dict, dev) -> None:
    """tests/test_split_reduce.py's combiner acceptance at COMBINER_ROWS on
    8 shards with the kernels: the split plan ships >= 3x fewer wire rows
    than the unsplit one, integer aggregates equal, both equal eager."""
    from repro_torch.core import distributed as TD
    from repro_torch.core import executor, flow as F
    from repro_torch.core.operators import Hints
    from repro_torch.core.optimizer import optimize
    from repro_torch.core.physical import Ctx
    from repro_torch.core.record import Schema, batch_from_dict

    n = COMBINER_ROWS
    src = F.source("I", Schema.of(k=np.int64, v=np.int64, w=np.float64),
                   num_records=n)

    def agg(g, out):
        out.emit(g.keys().set("s", g.sum("v")).set("avg", g.mean("w")))

    root = F.reduce_(src, ["k"], agg, name="Agg",
                     hints=Hints(distinct_keys=64))
    rng = np.random.default_rng(11)
    b = {"I": batch_from_dict({"k": rng.integers(0, 64, n),
                               "v": rng.integers(-100, 100, n),
                               "w": rng.uniform(0, 1, n)})}
    ref = executor.execute(root, b)
    opt = optimize(root, Ctx(dop=MESH_SHARDS))
    if ".pre" not in opt.best.order():
        raise AssertionError(f"mesh combiner: best plan {opt.best.order()}")
    unsplit = next(rp for rp in opt.ranked if ".pre" not in rp.order())
    stats = TD.shuffle_stats()
    outs, wire = {}, {}
    with Checker() as chk:
        for what, plan in (("split", opt.best.plan),
                           ("unsplit", unsplit.plan)):
            stats.clear()
            outs[what] = TD.execute_distributed(
                plan, b, mesh_shards=MESH_SHARDS, use_kernels=True,
                device=dev)
            wire[what] = stats.wire_rows
            if not outs[what].equivalent(ref, atol=1e-4) \
                    or stats.collectives != 1:
                raise AssertionError(f"mesh combiner {what}: not equal to "
                                     f"eager, or {stats.collectives} sites")
    if chk.failures:
        raise AssertionError(f"mesh combiner: kernel calls disagree with "
                             f"their plain versions: {chk.failures}")
    for f in ("k", "s"):
        if sorted(np.asarray(outs["split"][f]).tolist()) != \
                sorted(np.asarray(outs["unsplit"][f]).tolist()):
            raise AssertionError(f"mesh combiner: {f} differs")
    ratio = wire["unsplit"] / wire["split"]
    if ratio < 3.0:
        raise AssertionError(f"mesh combiner: wire ratio {ratio:.2f} < 3")
    res["mesh"]["combiner"] = {"rows": n, "wire_rows": wire, "ratio": ratio}
    say("mesh", f"combiner, {n} rows, 64 keys, {MESH_SHARDS} shards: wire "
        f"rows split {wire['split']} / unsplit {wire['unsplit']} = "
        f"{ratio:.1f}x (>= 3); integer aggregates equal; both equal eager")


def _mesh_adaptive(res: dict, dev) -> None:
    """q15_drift at 6M lineitem rows (hint 1.0, data 0.04) served on 8
    shards through `DistributedPlan.run_device(stats_store=)`, with the
    reference mesh test's loop: when the drift score passes 0.5 the hints
    are calibrated from the store and a new regime's plan is swapped in.
    Every batch equals eager; at least one swap; then the shipped and the
    swapped plan's warm steps in turns."""
    from repro_torch.configs import flows
    from repro_torch.core import distributed as TD
    from repro_torch.core import executor
    from repro_torch.core.cost import StatsStore, calibrate_hints, drift_score
    from repro_torch.core.optimizer import optimize
    from repro_torch.core.physical import Ctx
    from repro_torch.core.pipeline import ExecutableCache, semantic_key

    n = FLOW_ROWS["q15"]
    root, make = flows.q15_drift(hint_selectivity=DRIFT_HINT)
    batches = [make(n, seed=s, true_sel=DRIFT_SEL)
               for s in range(MESH_DRIFT_SEEDS)]
    refs = [executor.execute(root, b) for b in batches]
    staged = [TD.bind_global(root, b, MESH_SHARDS, dev) for b in batches]
    cache = ExecutableCache()

    def handle(flow):
        return TD.DistributedPlan(
            optimize(flow, Ctx(dop=MESH_SHARDS), include_commutes=False),
            mesh_shards=MESH_SHARDS, use_kernels=True, cache=cache,
            device=dev)

    cur, store, swaps, swap_at = root, StatsStore(), 0, None
    shipped = dp = handle(cur)
    served = []
    with Checker() as chk:
        for t in range(MESH_DRIFT_BATCHES):
            k = t % MESH_DRIFT_SEEDS
            served.append((k, dp.run_device(staged[k], stats_store=store)))
            if drift_score(cur, store) > 0.5:
                cal = calibrate_hints(root, store, prior_weight=0.0)
                if semantic_key(cal) != semantic_key(cur):
                    cur, store = cal, StatsStore()
                    dp = handle(cur)
                    swaps += 1
                    swap_at = t if swap_at is None else swap_at
        torch.cuda.synchronize()
    if chk.failures:
        raise AssertionError(f"mesh adaptive: kernel calls disagree with "
                             f"their plain versions: {chk.failures}")
    _all_equal("mesh", "adaptive batch", [o for _, o in served],
               [refs[k] for k, _ in served])
    if swaps < 1:
        raise AssertionError("mesh adaptive: drift never swapped the plan")
    hint = {m.name: m for m in cur.iter_nodes()}[
        "FilterShipdate"].hints.selectivity
    timing = _in_turns({"shipped": lambda: shipped.run_device(staged[0]),
                        "swapped": lambda: dp.run_device(staged[0])},
                       MESH_ROUNDS)
    res["mesh"]["adaptive"] = {"rows": n, "batches": len(served),
                               "swaps": swaps, "swap_after_batch": swap_at,
                               "post_swap_hint": hint, "step_ms": timing}
    say("mesh", f"q15_drift {n} lineitem rows on {MESH_SHARDS} shards, hint "
        f"{DRIFT_HINT} vs true {DRIFT_SEL}: {len(served)} batches served "
        f"through DistributedPlan(stats_store=), {swaps} swap(s) (after "
        f"batch {swap_at}) to filter hint {hint:.4g}; every batch equals "
        f"eager; kernel calls ({len(chk.calls)}) all agree; warm steps in "
        f"turns, median (quartiles): " + "; ".join(
            f"{k} {m:.3f} ms ({q1:.3f} / {q3:.3f})"
            for k, (q1, m, q3) in timing.items()))
    del staged
    torch.cuda.empty_cache()


def phase_mesh(res: dict, dev) -> None:
    """The sharded executor on MESH_SHARDS shards of the one card:
    q15 (6M lineitem rows), q7 (1M) and clickstream (16M) on both wires
    (`_mesh_flow`), each data-plane kernel launched over the three flows;
    the combiner acceptance; q15_drift served adaptively on the mesh."""
    res["mesh"] = {"shards": MESH_SHARDS, "flows": {}}
    total = {k: 0 for k in DATA_KERNELS}
    for name in ("q15", "q7", "clickstream"):
        _mesh_flow(res, name, dev, total)
    _kernels_launched("mesh", total)
    res["mesh"]["launches"] = total
    say("mesh", f"launches over the three flows' checked runs: {total}")
    _combiner_check(res, dev)
    _mesh_adaptive(res, dev)


def _calibrated(root, make, dev) -> tuple:
    """A stationary tenant's flow with honest hints: a few of its own
    batches observed offline on its own optimized plan and calibrated
    (the registry's hints are production-scale; only the drift tenant
    ships hints its data contradicts)."""
    from repro_torch.core.cost import StatsStore, calibrate_hints
    from repro_torch.core.optimizer import optimize
    from repro_torch.core.pipeline import ExecutableCache

    store = StatsStore()
    cp = optimize(root, include_commutes=False).compile(
        device=dev, cache=ExecutableCache())
    for s in range(6):
        _, counts, caps = cp.run_device_observed(
            cp.bind_device(make(TENANT_ROWS, 9000 + s)))
        cp.fold_observation(store, counts, caps=caps)
    return calibrate_hints(root, store, prior_weight=0.0, quant=4)


def _serving_tenants(dev) -> list:
    """(name, flow, make) per tenant: the launcher's four."""
    from repro_torch.configs import flows

    q15_root, q15_b = flows.q15()
    ck_root, ck_b = flows.clickstream()
    tm_root, tm_b = flows.textmining()
    dr_root, dr_b = flows.q15_drift(hint_selectivity=DRIFT_HINT)
    raw = [("q15", q15_root, lambda n, s: q15_b(n, seed=s)),
           ("click", ck_root, lambda n, s: ck_b(n, seed=s)),
           ("text", tm_root, lambda n, s: tm_b(n, seed=s))]
    out = [(name, _calibrated(fl, mk, dev), mk) for name, fl, mk in raw]
    out.append(("drift", dr_root,
                lambda n, s: dr_b(n, seed=s, true_sel=DRIFT_SEL)))
    return out


def _solo_rate(flow, reqs, dev, min_s: float = 0.5) -> float:
    """A tenant's warm solo rate (bench_serving.py's `solo_req_s`): its own
    optimized plan on its own cache, bind_device -> run_device -> fetch,
    back to back."""
    from repro_torch.core.optimizer import optimize
    from repro_torch.core.pipeline import ExecutableCache

    cp = optimize(flow, include_commutes=False).compile(
        use_kernels=True, device=dev, cache=ExecutableCache())
    cp.run_device(cp.bind_device(reqs[0])).to_record_batch()
    t0 = time.perf_counter()
    served = 0
    while True:
        cp.run_device(cp.bind_device(reqs[served % len(reqs)])
                      ).to_record_batch()
        served += 1
        dt = time.perf_counter() - t0
        if dt >= min_s:
            return served / dt


def _submit_all(eng, tenants, pool, count: int) -> list:
    """`count` requests per tenant, tenant-interleaved as the launcher
    submits them: [(tenant, pool index, request)]."""
    return [(name, i, eng.submit(name, pool[name][i]))
            for i in range(count) for name, _, _ in tenants]


def _delivered(phase: str, reqs, refs) -> list:
    lat = []
    for name, i, r in reqs:
        got = r.result(timeout=300)
        if not got.equivalent(refs[name][i]):
            raise AssertionError(f"{phase}: {name} request {i}: "
                                 f"{got.capacity} rows, eager "
                                 f"{refs[name][i].capacity}, not equivalent")
        lat.append(r.latency)
    return lat


def phase_serving(res: dict, dev) -> None:
    """The launcher's workload on the card: q15, click and text (their
    hints calibrated offline on their own data, as bench_serving.py ships
    stationary tenants) and drift (q15_drift at 25x) through
    `DataflowEngine(ServeConfig(max_coalesce=16, probe_every=8,
    use_kernels=True), device="cuda")`, 64 requests of 4,096 rows per
    tenant from a `start()`ed pump thread.  The checked run holds every
    kernel call against its plain version, every result against its solo
    eager result, the swaps (drift at least one, the others none) and the
    launches; after `join_swaps` a further round, submitted with the pump
    stopped, must add no build and evict nothing.  The timed run is a
    second engine on the same executable cache, unchecked while it runs:
    req/s, p50 / p99 latency, coalesced share, truncations, and
    serve_vs_solo against each tenant's warm solo rate."""
    from repro_torch.core import executor
    from repro_torch.kernels import ops
    from repro_torch.serve.dataflow import DataflowEngine, ServeConfig

    t = time.perf_counter()
    tenants = _serving_tenants(dev)
    pool = {name: [mk(TENANT_ROWS, 1000 * ti + i)
                   for i in range(TENANT_REQUESTS)]
            for ti, (name, _, mk) in enumerate(tenants)}
    flows_by = {name: fl for name, fl, _ in tenants}
    refs = {name: [executor.execute(flows_by[name], b) for b in pool[name]]
            for name in pool}
    t_prep = time.perf_counter() - t
    cfg = ServeConfig(max_coalesce=COALESCE, probe_every=8,
                      use_kernels=True)
    eng = DataflowEngine(cfg, device=dev)
    for name, fl, _ in tenants:
        eng.register(name, fl)
    stationary = [n for n, _, _ in tenants if n != "drift"]
    # record each background pre-trace that completed, and on which thread
    pretraced, pretrace = [], eng._pretrace

    def counted(g, sample):
        pretrace(g, sample)
        pretraced.append(threading.current_thread().name)

    eng._pretrace = counted
    with Checker() as chk:
        ops.reset_launches()
        # warm-up: the stationary tenants' full-width batches build once
        warm = [(n, i, eng.submit(n, pool[n][i]))
                for i in range(COALESCE) for n in stationary]
        eng.drain()
        _delivered("serving", warm, refs)
        eng.start()
        try:
            reqs = _submit_all(eng, tenants, pool, TENANT_REQUESTS)
            _delivered("serving", reqs, refs)
            eng.join_swaps(timeout=120)
        finally:
            eng.stop()
        before = eng.cache.stats()
        further = _submit_all(eng, tenants, pool, COALESCE)
        eng.start()
        try:
            _delivered("serving", further, refs)
        finally:
            eng.stop()
        torch.cuda.synchronize()
        launches = {k: ops.LAUNCHES[k] for k in DATA_KERNELS}
    after = eng.cache.stats()
    if chk.failures:
        raise AssertionError(f"serving: kernel calls disagree with their "
                             f"plain versions: {chk.failures}")
    _kernels_launched("serving", launches)
    swaps = {n: eng.tenant_stats(n)["swaps"] for n, _, _ in tenants}
    if swaps["drift"] < 1 or any(swaps[n] for n in stationary):
        raise AssertionError(f"serving: swaps {swaps} (drift >= 1, the "
                             f"others 0 expected)")
    if (after.traces, after.evictions) != (before.traces, before.evictions):
        raise AssertionError(f"serving: the further round built "
                             f"{after.traces - before.traces} and evicted "
                             f"{after.evictions - before.evictions}")
    checked = eng.stats()
    if checked["swap_errors"] or not pretraced \
            or not all(n.startswith("swap-") for n in pretraced):
        raise AssertionError(f"serving: pre-traces {pretraced}, swap errors "
                             f"{checked['swap_errors']}")
    drift_group = eng.tenant_stats("drift")["group_size"]
    say("serving", f"checked run: 4 tenants x {TENANT_REQUESTS} "
        f"requests of {TENANT_ROWS} rows (+ {COALESCE} warm-up each for "
        f"q15/click/text, + a further round of {COALESCE} each); "
        f"every result equals solo eager; swaps {swaps}; background "
        f"pre-traces completed on {pretraced}; after its swap the drift "
        f"tenant's plan group holds {drift_group} tenant(s); the further "
        f"round built 0, evicted 0; launches {launches}; kernel calls "
        f"({len(chk.calls)}, each held against its plain version) all "
        f"agree, rows a call {_call_shapes(chk)}; engine {checked}; data + "
        f"eager + calibration {t_prep:.1f}s")

    # the timed run: a second engine on the same (warm) executable cache
    eng2 = DataflowEngine(cfg, cache=eng.cache, device=dev)
    for name, fl, _ in tenants:
        eng2.register(name, fl)
    eng2.start()
    try:
        t0 = time.perf_counter()
        reqs = _submit_all(eng2, tenants, pool, TENANT_REQUESTS)
        for _, _, r in reqs:
            r.result(timeout=300)
        wall = time.perf_counter() - t0
        eng2.join_swaps(timeout=120)
    finally:
        eng2.stop()
    lat = np.array(_delivered("serving", reqs, refs)) * 1e3
    st = eng2.stats()
    req_s = len(reqs) / wall
    solo = {n: _solo_rate(flows_by[n], pool[n][:8], dev)
            for n, _, _ in tenants}
    serve_vs_solo = req_s / sum(solo.values())
    swaps2 = {n: eng2.tenant_stats(n)["swaps"] for n, _, _ in tenants}
    res["serving"] = {
        "tenants": [n for n, _, _ in tenants], "rows": TENANT_ROWS,
        "requests_per_tenant": TENANT_REQUESTS,
        "checked": {"swaps": swaps, "launches": launches,
                    "pretraces": pretraced, "drift_group_size": drift_group,
                    "kernel_calls": len(chk.calls),
                    "shapes": _call_shapes(chk),
                    "stats": {k: v for k, v in checked.items()
                              if k != "cache"},
                    "cache": str(checked["cache"])},
        "req_s": req_s, "wall_s": wall,
        "p50_ms": float(np.percentile(lat, 50)),
        "p99_ms": float(np.percentile(lat, 99)),
        "coalesced_share": st["coalesced_requests"] / st["requests_served"],
        "truncations": st["truncations"], "device_batches":
        st["device_batches"], "swaps": swaps2,
        "builds_in_window": st["cache"].traces - after.traces,
        "solo_req_s": solo, "serve_vs_solo": serve_vs_solo}
    r = res["serving"]
    r["profiled"] = _serving_profile(eng.cache, cfg, tenants, pool, dev)
    r["batch_parts_ms"] = _coalesced_parts(eng2, pool)
    say("serving", f"timed run (second engine, warm cache): {len(reqs)} "
        f"requests in {wall:.3f}s = {req_s:.1f} req/s; latency p50 "
        f"{r['p50_ms']:.2f} ms, p99 {r['p99_ms']:.2f} ms; coalesced share "
        f"{r['coalesced_share']:.3f}; {st['device_batches']} device "
        f"batches; truncations {st['truncations']}; swaps {swaps2}; builds "
        f"in the window {r['builds_in_window']}; solo req/s "
        + ", ".join(f"{n} {v:.1f}" for n, v in solo.items())
        + f"; serve_vs_solo {serve_vs_solo:.3f}")
    say("serving", f"profiled run (third engine, warm cache, the profiler "
        f"on): {r['profiled']}")
    say("serving", "one coalesced batch of "
        f"{COALESCE} requests per group, its parts' median ms: "
        f"{r['batch_parts_ms']}")
    if swaps2["drift"] < 1 or any(swaps2[n] for n in stationary):
        raise AssertionError(f"serving: timed run swaps {swaps2}")
    alive = [t.name for t in threading.enumerate()
             if t.name == "dataflow-pump" or t.name.startswith("swap-")]
    if alive:
        raise AssertionError(f"serving: engine threads still running: "
                             f"{alive}")


def _serving_profile(cache, cfg, tenants, pool, dev) -> dict:
    """The timed run's workload once more on a third engine (same warm
    cache) under torch.profiler: device busy time against the window's
    wall clock (the idle share), device kernels and device-to-host copies
    per request.  The profiler slows the host, so the idle share is an
    upper bound of the unprofiled run's."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.dataflow import DataflowEngine

    eng = DataflowEngine(cfg, cache=cache, device=dev)
    for name, fl, _ in tenants:
        eng.register(name, fl)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.start()
        try:
            t0 = time.perf_counter()
            reqs = _submit_all(eng, tenants, pool, TENANT_REQUESTS)
            for _, _, r in reqs:
                r.result(timeout=300)
            eng.join_swaps(timeout=120)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        finally:
            eng.stop()
    busy, n, per_name = _device_busy(prof)
    d2h = _d2h_copies(prof)
    h2d = sum(1 for k in per_name if "HtoD" in k or "Pageable -> Device"
              in k)
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:5]
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1 - busy / wall_us,
            "device_records_per_request": n / len(reqs),
            "d2h_per_request": d2h / len(reqs), "h2d_names": h2d,
            "device_batches": eng.stats()["device_batches"],
            "top": [(k[:50], round(t / 1e3, 2)) for k, t in top]}


def _coalesced_parts(eng, pool) -> dict:
    """Where one coalesced batch's time goes, per plan group of the timed
    engine: tagging and concatenating the requests on the host, binding
    (padding and the host-to-device copy), the observed device step (it
    ends in the one device-to-host read of its counts) and the demux
    (result fetch and split), each a median of 5 warm reps, ms."""
    from repro_torch.serve.dataflow import coalesce_bindings, split_result

    out = {}
    for g in list(eng._groups.values()):
        if g.coalesced is None or not g.members:
            continue
        member = sorted(g.members)[0]
        reqs = pool[member][:COALESCE]
        parts = {"concat": [], "bind": [], "step": [], "demux": []}
        for _ in range(6):
            t = time.perf_counter()
            combined = coalesce_bindings(reqs, g.coalesce_info)
            t1 = time.perf_counter()
            staged = g.coalesced.bind_device(combined)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            o, _, _ = g.coalesced.run_device_observed(staged)
            t3 = time.perf_counter()
            split_result(o.to_record_batch(), len(reqs), g.coalesce_info)
            t4 = time.perf_counter()
            for k, a, b in (("concat", t, t1), ("bind", t1, t2),
                            ("step", t2, t3), ("demux", t3, t4)):
                parts[k].append((b - a) * 1e3)
        out["+".join(sorted(g.members))] = {
            k: round(float(np.median(v[1:])), 3) for k, v in parts.items()}
    return out


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


def _chunk_tokens(chunk) -> torch.Tensor:
    """A chunk of prompts, left-padded with token 0 as the engine pads."""
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
    toks = _chunk_tokens(prompts[:SERVE_SLOTS]).to(dev)
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
    toks = _chunk_tokens(prompts[:SERVE_SLOTS]).to(dev)
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


class MoeRoute:
    """Wraps `moe.route` while a model runs: records each call's routing
    (probabilities, top-k weights, top-k experts) in `calls`, or, given
    the `calls` of another run (`replay`), returns those instead, call by
    call (recording its own in `calls` still).  A bf16 rounding that flips
    one token's k-th expert shifts the queue ranks behind it and with them
    which pairs the capacity drops, a jump no tolerance bounds; replaying
    the plain path's routing on the kernel path leaves the attention
    kernel the only difference between the two."""

    def __init__(self, replay=None):
        self.calls, self._replay = [], replay

    def __enter__(self):
        from repro_torch.models import moe

        self._real = real = moe.route
        replay = iter(self._replay) if self._replay is not None else None

        def call(p, cfg, xf):
            got = real(p, cfg, xf)
            self.calls.append(got)
            return got if replay is None else next(replay)

        moe.route = call
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.route = self._real
        return False


def _logit_checks(phase, serve, model, batch, lf, lp, kernel_route,
                  plain_route) -> None:
    """A family phase's prefill last-token logits, kernel path (`lf`)
    against plain attention (`lp`) on the same weights.  Held as the
    recurrent phases hold theirs, since with bf16 activations two correct
    attentions, each rounding its outputs to bf16 once, drift apart over
    the depth past LOGIT_TOL (phi-3-vision's 32 layers: ~0.08): (1) with
    float32 activations the kernel path (`flash_f32`) within LOGIT_TOL of
    plain attention; (2) with the served bf16 activations the kernel path
    no farther from the float32 logits than twice the plain path.  The
    float32 passes read the weights cast at each use (a float32 copy of
    qwen2-moe's 28.6 GB of bf16 weights would not fit beside them).

    MoE: each path routing itself, a one-ulp bf16 difference flips some
    token's k-th expert, and the queue ranks behind it shift which pairs
    the capacity drops: a jump no tolerance bounds.  The kernel and plain
    paths' own routings (`kernel_route`, `plain_route`, from `MoeRoute`)
    give the share of (token, k) pairs they route alike, and both checks
    run every path on the float32 plain path's routing (replayed)."""
    from repro_torch.models import transformer as T
    from repro_torch.models.model import _tree

    cfg, toks = model.cfg, batch["tokens"]
    moe = cfg.family == "moe"
    if moe:
        same = sum(int((a[2] == b[2]).sum())
                   for a, b in zip(kernel_route, plain_route))
        serve.update(
            free_logit_max_abs_err=float((lf - lp).abs().max()),
            routing_agree=same / sum(c[2].numel() for c in plain_route))
        say(phase, f"prefill last-token logits, each path routing itself: "
            f"max abs err {serve['free_logit_max_abs_err']:.4g}; the two "
            f"paths pick the same expert for {serve['routing_agree']:.4f} "
            f"of the (token, k) pairs over the {cfg.n_layers} layers")
    raw = _tree(model)
    raw["unembed"] = raw["embed" if cfg.tied_embeddings else "unembed"]

    def prefill32(impl, replay=None):
        c32 = cfg.with_(dtype="float32", attn_impl=impl)
        with torch.inference_mode(), MoeRoute(replay) as route:
            out, _ = T.prefill(raw, c32, batch, T.init_decode_state(
                c32, toks.shape[0], SERVE_MAX_SEQ, toks.device))
        return out, route.calls

    def prefill16(plain, replay):
        with MoeRoute(replay):
            if plain:
                return _plain_prefill(model, batch)[0]
            return model.prefill(batch, model.init_decode_state(
                toks.shape[0], SERVE_MAX_SEQ))[0]

    l32, route32 = prefill32("xla")
    lf32, _ = prefill32("flash", route32 if moe else None)
    if moe:
        lf, lp = prefill16(False, route32), prefill16(True, route32)
    torch.cuda.synchronize()
    routed = ", routed alike" if moe else ""
    _compare_logits(phase, serve, lf32, l32, toks,
                    f"plain attention, both with float32 activations{routed}")
    err_k = float((lf - l32).abs().max())
    err_p = float((lp - l32).abs().max())
    serve.update(bf16_logit_max_abs_err=float((lf - lp).abs().max()),
                 bf16_kernel_vs_f32=err_k, bf16_plain_vs_f32=err_p)
    say(phase, f"prefill last-token logits with bf16 activations"
        f"{', both routed as the float32 path' if moe else ''}: kernel vs "
        f"plain max abs err {serve['bf16_logit_max_abs_err']:.4g}; against "
        f"the float32 logits the kernel path is {err_k:.4g} off, the plain "
        f"path {err_p:.4g}")
    if not (torch.isfinite(lf).all() and err_k <= 2 * err_p):
        raise AssertionError(f"bf16 prefill logits: the kernel path is "
                             f"{err_k:g} from the float32 logits, more than "
                             f"twice the plain path's {err_p:g}")


def _encdec_generate(model, prompts, frames) -> list:
    """whisper's serving loop, which the Engine cannot run (it sends tokens
    only): each chunk of SERVE_SLOTS prompts, left-padded as the engine
    pads, through `Model.prefill` with the seeded audio frames, then
    SERVE_NEW greedy `decode_step`s.  Each request's SERVE_NEW + 1 tokens."""
    out = []
    for i in range(0, len(prompts), SERVE_SLOTS):
        toks = _chunk_tokens(prompts[i:i + SERVE_SLOTS]).to(frames.device)
        b = toks.shape[0]
        logits, state = model.prefill(
            {"tokens": toks, "audio_frames": frames[:b]},
            model.init_decode_state(b, SERVE_MAX_SEQ))
        tok = logits[:, -1:].argmax(-1)
        got = [tok]
        for _ in range(SERVE_NEW):
            logits, state = model.decode_step(tok, state)
            tok = logits[:, -1:].argmax(-1)
            got.append(tok)
        out += torch.cat(got, 1).cpu().tolist()
    return out


def _plain_prefill(model, batch: dict):
    """The same prefill with plain attention on the same weights: the
    model's config swapped for attn_impl="xla" for the call (a second model
    would hold a second copy of the weights)."""
    cfg = model.cfg
    model.cfg = cfg.with_(attn_impl="xla")
    try:
        return model.prefill(batch, model.init_decode_state(
            batch["tokens"].shape[0], SERVE_MAX_SEQ))
    finally:
        model.cfg = cfg


def _flash_launches(cfg, prefills: int, decode_steps: int = 0) -> int:
    """flash calls of `prefills` prefills and `decode_steps` decode steps:
    one per layer a prefill (attention_prefill), plus for the encdec one
    per encoder layer and one cross-attention per decoder layer a prefill
    and a decode step (self-attention decode is plain)."""
    if cfg.family == "encdec":
        return (prefills * (cfg.n_enc_layers + 2 * cfg.n_layers)
                + decode_steps * cfg.n_layers)
    return prefills * cfg.n_layers


def phase_serve_family(res: dict, dev, phase: str) -> dict:
    """Token serving through the moe, vlm or encdec family at full width
    (FAMILY_PHASES) with the flash kernel: qwen2-moe-a2.7b and
    mixtral-8x22b (4 layers) through the Engine, phi-3-vision-4.2b through
    the Engine (text only, as the reference's Engine serves it) and one
    `Model.prefill` with a seeded image prefix, whisper-tiny through
    `Model.prefill` with seeded audio frames and greedy decode steps.
    Launch counts are set to zero just before each checked run and read
    just after it.  Returns the flash launches of the phase's runs."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import make_model
    from repro_torch.serve.engine import Engine, Request

    arch, over = FAMILY_PHASES[phase]
    cfg = get_config(arch, attn_impl="flash", **over)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED)
    model = make_model(cfg, dev).init(gen)
    torch.cuda.synchronize()
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    init_peak = torch.cuda.max_memory_allocated() - base
    what = f"{cfg.n_layers} layers"
    if cfg.family == "moe":
        what += (f", {cfg.n_experts} experts top-{cfg.top_k} + "
                 f"{cfg.n_shared_experts} shared (expert ff "
                 f"{cfg.d_expert_ff or cfg.d_ff})")
    elif cfg.family == "encdec":
        what += (f" + {cfg.n_enc_layers} encoder layers over "
                 f"{cfg.n_audio_frames} audio frames")
    say(phase, f"{cfg.name}: {what}, d_model {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.kv_heads} x {cfg.head_dim}, vocab {cfg.vocab} "
        f"(padded {cfg.padded_vocab}), {model.param_count():,} "
        f"{str(cfg.p_dtype)[6:]} parameters ({weights / 1e9:.2f} GB), "
        f"{str(cfg.act_dtype)[6:]} activations, attn_impl={cfg.attn_impl}; "
        f"init on the card {time.perf_counter() - t:.1f}s, peak memory "
        f"right after init {init_peak / 1e9:.2f} GB")
    prompts = serve_prompts(cfg.vocab)
    n_chunks = -(-SERVE_REQUESTS // SERVE_SLOTS)
    serve: dict = {"arch": cfg.name, "n_layers": cfg.n_layers,
                   "param_dtype": str(cfg.p_dtype)[6:],
                   "weights_gb": weights / 1e9,
                   "init_peak_gb": init_peak / 1e9}
    g = torch.Generator(device=dev)
    frames = torch.randn((SERVE_SLOTS, cfg.n_audio_frames, cfg.d_model),
                         generator=g.manual_seed(AUDIO_SEED), device=dev) \
        if cfg.family == "encdec" else None

    def requests():
        return [Request(prompt=p, max_new_tokens=SERVE_NEW) for p in prompts]

    # the main path, every kernel call checked
    engine = None if frames is not None else Engine(
        model, batch_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ,
        seed=SERVE_SEED)
    torch.cuda.reset_peak_memory_stats()
    with AttnChecker() as chk, MoeRoute() as route:
        ops.reset_launches()
        if cfg.family == "encdec":
            out = _encdec_generate(model, prompts, frames)
            want = _flash_launches(cfg, n_chunks, n_chunks * SERVE_NEW)
        else:
            reqs = engine.generate(requests())
            out = [r.out_tokens for r in reqs]
            want = _flash_launches(cfg, n_chunks)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
    if chk.failures:
        raise AssertionError(f"flash calls disagree with the plain "
                             f"attention: {chk.failures}")
    if launches["flash_attention"] != want or any(
            n for k, n in launches.items() if k != "flash_attention"):
        raise AssertionError(f"flash_attention launched "
                             f"{launches['flash_attention']} times, expected "
                             f"{want} and no other kernel: {launches}")
    n_new = SERVE_NEW + (cfg.family == "encdec")
    if any(len(o) != n_new or not all(0 <= x < cfg.padded_vocab for x in o)
           for o in out):
        raise AssertionError(f"bad outputs: {[len(o) for o in out]}")
    shapes = sorted({c[:2] for c in chk.calls})
    say(phase, f"checked run: {SERVE_REQUESTS} requests, prompts "
        f"{[len(p) for p in prompts]}, {n_new} new tokens each "
        f"({'Model.prefill with audio frames + decode_step' if frames is not None else 'Engine'}); "
        f"{len(chk.calls)} flash calls at (q, k) shapes {shapes}, each "
        f"within atol=rtol={ATTN_TOL[torch.bfloat16]:g} of the plain "
        f"attention (max abs err {chk.max_err:.4g}); launches {launches}")
    serve.update(launches=launches["flash_attention"],
                 flash_max_abs_err=chk.max_err)
    if cfg.family == "moe":  # the capacity drops of the prefills' routing
        from repro_torch.models import moe

        dropped = pairs = 0
        busiest = 0.0  # the most a prefill's busiest expert took, / n
        for _, _, topi in route.calls:
            n = topi.shape[0]
            if n > SERVE_SLOTS:
                count = torch.bincount(topi.reshape(-1),
                                       minlength=cfg.n_experts)
                over = count - moe.capacity(cfg, n)
                dropped += int(over.clamp(min=0).sum())
                pairs += topi.numel()
                busiest = max(busiest, int(count.max()) / n)
        serve.update(prefill_drop_share=dropped / pairs,
                     prefill_busiest_expert=busiest)
        say(phase, f"capacity drops at prefill: {dropped:,} of {pairs:,} "
            f"(token, k) pairs ({serve['prefill_drop_share']:.4f}); the "
            f"busiest expert of a layer took up to {busiest:.3f} of a "
            f"chunk's tokens (capacity before its rounding up to 256: "
            f"{cfg.capacity_factor * cfg.top_k / cfg.n_experts:.3f})")
    del route

    # the timed run, no checks
    if cfg.family == "encdec":
        with StepTimer(model) as tm:
            t = time.perf_counter()
            timed = _encdec_generate(model, prompts, frames)
            wall = time.perf_counter() - t
        dec = tm.ms["decode_step"]
        n_tok = sum(len(o) for o in timed)
        serve.update(tokens=n_tok, wall_s=wall, tokens_per_s=n_tok / wall,
                     prefill_ms=tm.ms["prefill"],
                     decode_ms_per_step_median=float(np.median(dec)),
                     decode_ms_per_step_mean=float(np.mean(dec)),
                     decode_steps=len(dec),
                     tokens_equal_checked_run=timed == out)
        say(phase, f"timed run: {n_tok} tokens in {wall:.3f}s = "
            f"{serve['tokens_per_s']:.1f} tokens/s; prefill ms per chunk "
            f"{[round(x, 2) for x in tm.ms['prefill']]}; decode "
            f"{serve['decode_ms_per_step_median']:.3f} ms per step median "
            f"({SERVE_SLOTS} tokens a step, {len(dec)} steps); greedy tokens "
            f"equal to the checked run's: {timed == out}")
    else:
        timed, dec = _timed_serve(phase, engine, model, requests, reqs)
        serve.update(timed)
    serve["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    say(phase, f"peak memory over the checked and timed runs "
        f"{serve['peak_memory_gb']:.2f} GB (weights {weights / 1e9:.2f} GB)")

    # prefill logits: kernel path against plain attention on the same
    # weights, on the first chunk (the vlm with its image prefix as well,
    # the prefix's flash launches counted apart)
    toks = _chunk_tokens(prompts[:SERVE_SLOTS]).to(dev)
    batch = {"tokens": toks}
    if frames is not None:
        batch["audio_frames"] = frames[:toks.shape[0]]
    with AttnChecker(), MoeRoute() as kernel_route:
        lf, state = model.prefill(batch, model.init_decode_state(
            toks.shape[0], SERVE_MAX_SEQ))
    with MoeRoute() as plain_route:
        lp, _ = _plain_prefill(model, batch)
    torch.cuda.synchronize()
    _logit_checks(phase, serve, model, batch, lf, lp, kernel_route.calls,
                  plain_route.calls)
    del kernel_route, plain_route
    if cfg.family == "vlm":
        img = torch.randn((toks.shape[0], cfg.n_img_tokens, cfg.d_model),
                          generator=g.manual_seed(IMG_SEED), device=dev)
        batch = {"tokens": toks, "img_embeds": img}
        with AttnChecker() as chk:
            ops.reset_launches()
            li, _ = model.prefill(batch, model.init_decode_state(
                toks.shape[0], SERVE_MAX_SEQ))
            torch.cuda.synchronize()
            img_launches = dict(ops.LAUNCHES)
        if chk.failures or img_launches["flash_attention"] != cfg.n_layers:
            raise AssertionError(f"image prefill: flash {img_launches}, "
                                 f"failures {chk.failures}")
        lpi, _ = _plain_prefill(model, batch)
        say(phase, f"with img_embeds {list(img.shape)} over the first "
            f"{cfg.n_img_tokens} positions:")
        shown = {}
        _logit_checks(phase, shown, model, batch, li, lpi, [], [])
        serve["img_prefill"] = dict(shown, launches=cfg.n_layers,
                                    flash_max_abs_err=chk.max_err)
        serve["launches"] += cfg.n_layers
        del li, lpi
    del lp
    _profile_decode(phase, serve, model, lf, state, dec)
    res[phase] = serve
    return {"flash_attention": serve["launches"]}


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def _train_card_vs_cpu(train: dict, dev) -> None:
    """One train step of qwen3-0.6b REDUCED in float32 on the card and on
    the CPU, same weights and batch, TF32 off: loss, every gradient leaf
    and the parameters after the AdamW step."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import make_model
    from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                             init_opt_state)
    from repro_torch.train.train_step import loss_and_grads

    cfg = get_config(TRAIN_ARCH, reduced=True)
    cpu = make_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    card = make_model(cfg, dev).load_params(cpu.state_dict())
    batch = TokenPipeline(vocab=cfg.vocab, batch=TRAIN_BATCH, seq=128,
                          device=dev)(0)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = {}
        for name, m, b in (("cpu", cpu, {"tokens": batch["tokens"].cpu()}),
                           ("card", card, batch)):
            params = m.master_params()
            loss, grads = loss_and_grads(m, params, b)
            new, _, _ = adamw_update(AdamWConfig(), params, grads,
                                     init_opt_state(params))
            out[name] = (float(loss), grads, new)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    (lc, gc, pc), (lg, gg, pg) = out["cpu"], out["card"]
    atol, rtol = TRAIN_GRAD_TOL
    grad_excess = max(float(((gg[k].cpu() - gc[k]).abs()
                             - (atol + rtol * gc[k].abs())).max())
                      for k in gc)
    param_err = max(float((pg[k].cpu() - pc[k]).abs().max()) for k in pc)
    train["card_vs_cpu"] = {"loss_cpu": lc, "loss_card": lg,
                            "loss_err": abs(lc - lg),
                            "grad_excess": grad_excess,
                            "param_err": param_err, "leaves": len(gc)}
    say("train", f"card vs CPU ({cfg.name}, float32, TF32 off, batch "
        f"{TRAIN_BATCH} x 128 from TokenPipeline): loss {lg!r} vs {lc!r} "
        f"(|diff| {abs(lc - lg):.3g} <= {TRAIN_LOSS_TOL}); {len(gc)} "
        f"gradient leaves, worst |diff| - ({atol} + {rtol}|cpu|) = "
        f"{grad_excess:.3g} (<= 0); params after AdamW max |diff| "
        f"{param_err:.3g} (<= {TRAIN_PARAM_TOL})")
    if abs(lc - lg) > TRAIN_LOSS_TOL or grad_excess > 0 \
            or param_err > TRAIN_PARAM_TOL:
        raise AssertionError("train step on the card disagrees with the CPU")


def _train_guard(dev) -> None:
    """The three model-plane kernels raise under autograd on CUDA inputs
    that take gradients, and launch nothing."""
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((1, 2, 16, 64), generator=g, device=dev)
    w = torch.rand((1, 2, 8, 16), generator=g, device=dev)
    a = torch.rand((2, 8, 4), generator=g, device=dev)
    calls = {
        "flash_attention": lambda: ops.flash_attention(
            q.clone().requires_grad_(), q, q),
        "rwkv6_scan": lambda: ops.rwkv6(w, w, w, w, w[0, :, 0].clone()
                                        .requires_grad_()),
        "linear_scan": lambda: ops.linear_scan(a, a.clone()
                                               .requires_grad_()),
    }
    ops.reset_launches()
    for name, call in calls.items():
        try:
            call()
        except NotImplementedError as e:
            if name not in str(e):
                raise
        else:
            raise AssertionError(f"{name} ran under autograd")
    torch.cuda.synchronize()
    if any(ops.LAUNCHES.values()):
        raise AssertionError(f"launches under the guard: {ops.LAUNCHES}")
    say("train", "guard: flash_attention, rwkv6_scan and linear_scan raise "
        "NotImplementedError under autograd on CUDA inputs that take "
        "gradients, no launch")


def _timed_supervisor(**kw):
    """A `Supervisor` whose checkpoint saves are timed, into `.saves`."""
    from repro_torch.train.fault import Supervisor

    class Timed(Supervisor):
        def _save(self, state, wait):
            t = time.perf_counter()
            super()._save(state, wait)
            self.saves.append(time.perf_counter() - t)

    sup = Timed(**kw)
    sup.saves = []
    return sup


def _train_restart(train: dict, dev) -> None:
    """qwen3-0.6b REDUCED on the card under the Supervisor: 8 steps
    uninterrupted, and 8 steps with two failures of step 5 (checkpoints
    every 2 steps, so each failure restores step 4 and replays it)."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import make_model
    from repro_torch.train.fault import Supervisor
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import TrainConfig, make_train_step

    cfg = get_config(TRAIN_ARCH, reduced=True)
    model = make_model(cfg, dev).init(
        torch.Generator(device=dev).manual_seed(1))
    pipe = TokenPipeline(vocab=cfg.vocab, batch=TRAIN_BATCH, seq=128,
                         seed=1, device=dev)
    step_fn = make_train_step(model, TrainConfig(opt=AdamWConfig(
        lr=1e-3, warmup_steps=2, total_steps=8)))
    fails = {"n": 2}
    logs = []

    def flaky(params, opt, batch, step):
        if step == 5 and fails["n"]:
            fails["n"] -= 1
            raise RuntimeError("injected step failure")
        return step_fn(params, opt, batch, step)

    root = tempfile.mkdtemp(prefix="chip_smoke_restart_")
    try:
        finals = []
        for name, fn in (("uninterrupted", step_fn), ("restarted", flaky)):
            params = model.master_params()
            state = {"params": params, "opt": init_opt_state(params),
                     "step": 0}
            state, _ = Supervisor(ckpt_dir=os.path.join(root, name),
                                  ckpt_every=2).run(
                state=state, train_step=fn, batch_fn=pipe, num_steps=8,
                log_every=0, log=logs.append)
            finals.append(state)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    a, b = (s["params"] for s in finals)
    err = max(float((a[k] - b[k]).abs().max()) for k in a)
    same = sum(torch.equal(a[k], b[k]) for k in a)
    failed = sum("injected step failure" in x for x in logs)
    det = torch.are_deterministic_algorithms_enabled()
    train["restart"] = {"param_err": err, "bit_equal_leaves": same,
                        "leaves": len(a), "failures": failed,
                        "deterministic_algorithms": det}
    say("train", f"restart ({cfg.name}, 8 steps, checkpoints every 2): "
        f"{failed} injected failures of step 5, each restoring step 4; "
        f"final parameters against the uninterrupted run max |diff| "
        f"{err:.3g} (<= {TRAIN_PARAM_TOL}), {same}/{len(a)} leaves bit "
        f"for bit; deterministic algorithms "
        f"{'on' if det else 'off'} (the embedding backward accumulates by "
        f"atomics when off)")
    if failed != 2 or finals[1]["step"] != 8 or err > TRAIN_PARAM_TOL:
        raise AssertionError("the restarted run does not reproduce the "
                             "uninterrupted one")


def _parts_busy(prof, parts) -> dict:
    """{part: (device busy us, device kernels)} of a profiled step whose
    parts ran inside `record_function(part)` ranges, each ended by a
    synchronize: a kernel belongs to the range its start falls in.  The
    ranges' own device-side annotations (CUDA events named as the part)
    are no kernels and count for nothing."""
    ranges = {e.name: (e.time_range.start, e.time_range.end)
              for e in prof.events() if e.name in parts
              and e.device_type == torch.autograd.DeviceType.CPU}
    spans = {p: [] for p in parts}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or e.name in parts:
            continue
        for p, (lo, hi) in ranges.items():
            if lo <= e.time_range.start <= hi:
                spans[p].append((e.time_range.start, e.time_range.end))
                break
    return {p: (_union(sp), len(sp)) for p, sp in spans.items()}


def _train_parts(model, pipe, params, opt, step: int, mark) -> None:
    """One train step in its four parts — host (the TokenPipeline batch
    and its copy), forward (the loss), backward (the gradients) and AdamW
    — calling `mark(part)` before each and `mark(None)` after the last."""
    from repro_torch.train.optimizer import AdamWConfig, adamw_update

    mark("host")
    batch = pipe(step)
    mark("forward")
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = model.loss(batch, leaves)
    mark("backward")
    gs = torch.autograd.grad(loss, list(leaves.values()))
    mark("adamw")
    adamw_update(AdamWConfig(), params, dict(zip(leaves, gs)), opt)
    mark(None)


def _profile_train_step(train: dict, model, pipe, params, opt, step_ms
                        ) -> None:
    """A train step's parts (`_train_parts`): unprofiled, the card's span
    of each part by CUDA events recorded between them (device time
    including any wait on the host); then under torch.profiler, each part
    in a `record_function` range ended by a synchronize, its device busy
    time, device kernels and wall, the idle share against the timed run's
    median step, and the step's top device kernels."""
    from torch.profiler import ProfilerActivity, profile, record_function

    parts = ("host", "forward", "backward", "adamw")
    events = []

    def event(part):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events.append(e)

    torch.cuda.synchronize()
    t = time.perf_counter()
    _train_parts(model, pipe, params, opt, TRAIN_STEPS, event)
    torch.cuda.synchronize()
    step_wall = (time.perf_counter() - t) * 1e3
    span = {p: events[i].elapsed_time(events[i + 1])
            for i, p in enumerate(parts)}

    wall, running = {}, []

    def ranged(part):
        torch.cuda.synchronize()
        if running:
            name, rf, t0 = running.pop()
            rf.__exit__(None, None, None)
            wall[name] = time.perf_counter() - t0
        if part is not None:
            rf = record_function(part)
            rf.__enter__()
            running.append((part, rf, time.perf_counter()))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _train_parts(model, pipe, params, opt, TRAIN_STEPS, ranged)
    busy = _parts_busy(prof, parts)
    total = sum(b for b, _ in busy.values())
    say("train", f"unprofiled step {step_wall:.1f} ms; the card's span by "
        f"part (CUDA events, ms): " + ", ".join(
            f"{p} {span[p]:.1f}" for p in parts))
    if total <= 0:
        say("train", "the profiler recorded no device kernels: the step's "
            "device busy time and idle share not measured")
        return
    _, _, per_name = _device_busy(prof)
    top = sorted(((k, v) for k, v in per_name.items() if k not in parts),
                 key=lambda kv: -kv[1])[:8]
    train["profile"] = {
        "parts": {p: {"device_busy_us": busy[p][0],
                      "device_kernels": busy[p][1],
                      "wall_ms": wall[p] * 1e3, "event_span_ms": span[p]}
                  for p in parts},
        "device_busy_us": total, "unprofiled_step_ms": step_wall,
        "idle_share": max(0.0, 1 - total / (step_ms * 1e3)),
        "profiled_idle_share": 1 - total / (sum(wall.values()) * 1e6),
        "top": top}
    say("train", f"profiled step: device busy {total / 1e3:.1f} ms in "
        f"{sum(k for _, k in busy.values())} device kernels against the "
        f"timed run's median step {step_ms:.1f} ms, idle share "
        f"{train['profile']['idle_share']:.3f} (against the profiled "
        f"parts' synchronized wall {sum(wall.values()) * 1e3:.1f} ms: "
        f"{train['profile']['profiled_idle_share']:.3f}); by part (device "
        f"busy ms / device kernels / synchronized wall ms): " + ", ".join(
            f"{p} {busy[p][0] / 1e3:.1f} / {busy[p][1]} / "
            f"{wall[p] * 1e3:.1f}" for p in parts))
    for k, v in top:
        say("train", f"  {v / 1e3:9.2f} ms  {k[:90]}")


def _train_full(train: dict, dev) -> None:
    """qwen3-0.6b FULL: TRAIN_STEPS steps at TRAIN_BATCH x TRAIN_SEQ from
    TokenPipeline under the Supervisor (a checkpoint only at the end), the
    profiled step, then MEMO_STEPS steps on one repeated batch."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import make_model
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import TrainConfig, make_train_step

    cfg = get_config(TRAIN_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = make_model(cfg, dev).init(
        torch.Generator(device=dev).manual_seed(SERVE_SEED))
    params = model.master_params()
    opt = init_opt_state(params)
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    n_params = model.param_count()
    t_pipe = time.perf_counter()
    pipe = TokenPipeline(vocab=cfg.vocab, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                         device=dev)
    cpu_pipe = TokenPipeline(vocab=cfg.vocab, batch=TRAIN_BATCH,
                             seq=TRAIN_SEQ, device="cpu",
                             optimized=pipe.optimized)
    t_pipe = time.perf_counter() - t_pipe
    say("train", f"{cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.kv_heads} x "
        f"{cfg.head_dim}, vocab {cfg.vocab}, {n_params:,} "
        f"{str(cfg.p_dtype)[6:]} parameters and AdamW moments, "
        f"{str(cfg.act_dtype)[6:]} activations, attn_impl={cfg.attn_impl}, "
        f"remat={cfg.remat}; init {time.perf_counter() - t:.1f}s, peak "
        f"{init_peak:.2f} GB after init; TokenPipeline plan "
        f"{pipe.optimized.best.order()} ({t_pipe:.2f}s to build two)")

    batches = {}

    def batch_fn(step):
        b = pipe(step)
        batches[step] = b["tokens"]
        return b

    metrics = []
    step_fn = make_train_step(model, TrainConfig())

    def recorded(p, o, b, step):
        out = step_fn(p, o, b, step)
        metrics.append((step, out[2]))
        return out

    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    say("train", f"checkpoint directory {root}: "
        f"{shutil.disk_usage(root).free / 1e9:.1f} GB free")
    try:
        # a deadline of 0 s makes the watchdog note every step's time: the
        # batch, the step and the wait on its loss
        sup = _timed_supervisor(ckpt_dir=root, ckpt_every=TRAIN_STEPS + 1,
                                step_deadline_s=0.0)
        state = {"params": params, "opt": opt, "step": 0}
        del params, opt
        state, wd = sup.run(state=state, train_step=recorded,
                            batch_fn=batch_fn, num_steps=TRAIN_STEPS,
                            log_every=0)
        step_dir = os.path.join(root, f"step_{TRAIN_STEPS}")
        ckpt_gb = sum(os.path.getsize(os.path.join(step_dir, f))
                      for f in os.listdir(step_dir)) / 1e9
    finally:
        shutil.rmtree(root, ignore_errors=True)
    train_peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(m["loss"]) for _, m in metrics]
    gnorms = [float(m["grad_norm"]) for _, m in metrics]
    times = [dt for _, dt in wd.events]
    step_ms = float(np.median(times[2:])) * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    same = all(torch.equal(batches[s].cpu(), cpu_pipe(s)["tokens"])
               for s in range(TRAIN_STEPS))
    train["full"] = {
        "arch": cfg.name, "n_layers": cfg.n_layers, "params": n_params,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": state["step"],
        "losses": losses, "grad_norms": gnorms, "step_s": times,
        "median_step_ms": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
        "init_peak_gb": init_peak, "peak_gb": train_peak,
        "ckpt_s": sup.saves, "ckpt_gb": ckpt_gb,
        "batches_equal_cpu": same}
    say("train", f"{state['step']} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"under the Supervisor: losses {', '.join(f'{x:.4f}' for x in losses)}"
        f"; grad norms {', '.join(f'{x:.3f}' for x in gnorms)}")
    say("train", f"median step over the last {len(times) - 2} "
        f"{step_ms:.1f} ms (steps {', '.join(f'{x * 1e3:.1f}' for x in times)}"
        f" ms), {tokens / step_ms * 1e3:,.0f} tokens/s, peak "
        f"{train_peak:.2f} GB; final checkpoint {ckpt_gb:.2f} GB in "
        f"{sum(sup.saves):.2f}s; the card's batches equal the CPU's for "
        f"the same (seed, step): {same}")
    first = losses[0]
    if not (all(map(math.isfinite, losses + gnorms)) and same
            and abs(first - math.log(cfg.vocab)) < 1.0
            and state["step"] == TRAIN_STEPS and len(sup.saves) == 1):
        raise AssertionError(f"train run: first loss {first} against "
                             f"ln(vocab) {math.log(cfg.vocab):.3f}, "
                             f"batches equal {same}, saves {sup.saves}")

    _profile_train_step(train, model, pipe, state["params"], state["opt"],
                        step_ms)

    # memorization: one batch again and again at a constant lr
    memo_fn = make_train_step(model, TrainConfig(opt=AdamWConfig(
        lr=1e-3, warmup_steps=2, schedule="constant")))
    params = state["params"]
    opt = init_opt_state(params)
    del state
    batch = pipe(1000)
    memo = []
    for s in range(MEMO_STEPS):
        params, opt, m = memo_fn(params, opt, batch, s)
        memo.append(float(m["loss"]))
    train["memorize"] = memo
    say("train", f"memorization, {MEMO_STEPS} steps on one batch at lr 1e-3 "
        f"(constant, 2 warm-up steps): losses "
        f"{', '.join(f'{x:.3f}' for x in memo)}")
    if not (all(map(math.isfinite, memo)) and memo[-1] <= memo[0] - 1.0):
        raise AssertionError(f"memorization: last loss {memo[-1]} not 1.0 "
                             f"below the first {memo[0]}")


def phase_train(res: dict, dev) -> None:
    """Training, the port's train path: card against CPU on the REDUCED
    config, the kernel guard, a restart with injected failures, then
    qwen3-0.6b at full width and depth fed by TokenPipeline."""
    train = res["train"] = {}
    t = time.perf_counter()
    _train_card_vs_cpu(train, dev)
    _train_guard(dev)
    _train_restart(train, dev)
    torch.cuda.empty_cache()
    _train_full(train, dev)
    train["seconds"] = time.perf_counter() - t
    say("train", f"ok {train['seconds']:.1f}s")


def _leaves_agree(a: dict, b: dict) -> tuple:
    """(max |a - b| over the leaves of two flat dicts, DTensors taken
    whole; the leaves equal bit for bit)."""
    from repro_torch.parallel.sharding import full_tensor

    err, same = 0.0, 0
    for k in a:
        x, y = full_tensor(a[k]), full_tensor(b[k])
        err = max(err, float((x.float() - y.float()).abs().max()))
        same += torch.equal(x, y)
    return err, same


def phase_train_mesh(res: dict, dev) -> None:
    """launch.train's placed path against the plain step, qwen3-0.6b FULL
    at TRAIN_BATCH x TRAIN_SEQ from TokenPipeline: `launch.train.setup`
    (the card's one-rank NCCL mesh from `make_host_mesh`, the parameters
    placed by `validated_pspecs`, batches by `batch_pspec`) and the plain
    step on the same model's parameters and the same batches, each for
    TRAIN_MESH_STEPS steps under the Supervisor; the placed checkpoint
    restored by `elastic_restore(..., mesh, validated_pspecs)`; both steps
    timed in turns and profiled."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch import train as ttrain
    from repro_torch.parallel.sharding import mesh_sizes, validated_pspecs
    from repro_torch.train.checkpoint import flatten
    from repro_torch.train.fault import elastic_restore
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import make_train_step

    tm = res["train_mesh"] = {}
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_train_mesh_")
    try:
        run = ttrain.setup(ttrain.parse_args([
            "--arch", TRAIN_ARCH, "--steps", str(TRAIN_MESH_STEPS),
            "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--ckpt-dir", os.path.join(root, "placed")]))
        leaf = next(iter(run.state["params"].values()))
        tm["mesh"] = {"sizes": mesh_sizes(run.mesh),
                      "backend": str(dist.get_backend()),
                      "world_size": dist.get_world_size(),
                      "leaf_type": type(leaf).__name__}
        say("train_mesh", f"{run.model.cfg.name} on mesh {tm['mesh']}; "
            f"{len(run.state['params'])} parameter leaves placed by "
            f"validated_pspecs, e.g. embed.table {tuple(leaf.placements)}")
        if tm["mesh"]["leaf_type"] != "DTensor" \
                or "nccl" not in tm["mesh"]["backend"]:
            raise AssertionError(f"not placed on an NCCL mesh: {tm['mesh']}")
        plain = run.model.master_params()
        paths = {"plain": (make_train_step(run.model, run.tcfg), run.pipe,
                           {"params": plain, "opt": init_opt_state(plain),
                            "step": 0}),
                 "placed": (run.step_fn, run.batch_fn, run.state)}
        del plain, leaf
        run.state = None
        finals = {}
        for name in ("plain", "placed"):
            fn, batch_fn, state = paths.pop(name)
            losses = []

            def recorded(p, o, b, step, fn=fn, losses=losses):
                out = fn(p, o, b, step)
                losses.append(float(out[2]["loss"]))
                return out

            sup = _timed_supervisor(
                ckpt_dir=os.path.join(root, name),
                ckpt_every=TRAIN_MESH_STEPS + 1, step_deadline_s=0.0)
            finals[name], wd = sup.run(
                state=state, train_step=recorded, batch_fn=batch_fn,
                num_steps=TRAIN_MESH_STEPS, log_every=0)
            tm[name] = {"losses": losses, "ckpt_s": sup.saves,
                        "step_s": [dt for _, dt in wd.events]}
            del state
        shutil.rmtree(os.path.join(root, "plain"), ignore_errors=True)
        lp, lq = tm["plain"]["losses"], tm["placed"]["losses"]
        err, same = _leaves_agree(finals["plain"]["params"],
                                  finals["placed"]["params"])
        n = len(finals["plain"]["params"])
        loss_err = max(abs(a - b) for a, b in zip(lp, lq))
        tm["agreement"] = {"param_err": err, "bit_equal_leaves": same,
                           "leaves": n, "loss_err": loss_err,
                           "bit_for_bit": same == n and lp == lq}
        say("train_mesh", f"{TRAIN_MESH_STEPS} supervised steps of "
            f"{TRAIN_BATCH} x {TRAIN_SEQ}: plain losses "
            f"{', '.join(repr(x) for x in lp)}; placed losses "
            f"{', '.join(repr(x) for x in lq)}; parameters after the last "
            f"step max |diff| {err:.3g} (<= {TRAIN_PARAM_TOL}), {same}/{n} "
            f"leaves bit for bit: "
            f"{'bit for bit' if tm['agreement']['bit_for_bit'] else 'NOT bit for bit'}")
        if not (all(map(math.isfinite, lp + lq)) and len(lq) == len(lp)
                == TRAIN_MESH_STEPS and loss_err <= TRAIN_LOSS_TOL
                and err <= TRAIN_PARAM_TOL):
            raise AssertionError("the placed step disagrees with the plain "
                                 "step")

        # the placed checkpoint onto the mesh again
        placed = finals["placed"]
        like = {"params": placed["params"], "opt": placed["opt"]}
        t = time.perf_counter()
        tree, step = elastic_restore(os.path.join(root, "placed"), like,
                                     run.mesh, validated_pspecs)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        saved, got = dict(flatten(like)), dict(flatten(tree))
        # every DTensor leaf comes back laid out as it was saved (the
        # plain step count comes back replicated on the mesh)
        placed_same = all(
            getattr(got[k], "placements", None) == v.placements
            for k, v in saved.items() if hasattr(v, "placements"))
        rerr, rsame = _leaves_agree(saved, got)
        tm["restore"] = {"s": restore_s, "save_s": tm["placed"]["ckpt_s"],
                         "step": step, "bit_equal_leaves": rsame,
                         "leaves": len(saved), "placements_kept": placed_same}
        say("train_mesh", f"checkpoint of the placed state saved in "
            f"{sum(tm['placed']['ckpt_s']):.2f}s, restored by "
            f"elastic_restore(..., mesh, validated_pspecs) in "
            f"{restore_s:.2f}s: step {step}, {rsame}/{len(saved)} leaves "
            f"bit for bit, placements kept: {placed_same}")
        if not (step == TRAIN_MESH_STEPS and rsame == len(saved)
                and placed_same):
            raise AssertionError("the restored checkpoint is not the saved "
                                 "state")
        del tree, got, saved, like

        # both steps timed in turns on the final states, then profiled
        batch = run.pipe(TRAIN_MESH_STEPS)
        pbatch = run.batch_fn(TRAIN_MESH_STEPS)
        pl, pq = finals["plain"], finals["placed"]
        plain_fn = make_train_step(run.model, run.tcfg)
        steps = {
            "plain": lambda: plain_fn(pl["params"], pl["opt"], batch,
                                      TRAIN_MESH_STEPS),
            "placed": lambda: run.step_fn(pq["params"], pq["opt"], pbatch,
                                          TRAIN_MESH_STEPS)}
        turns = _in_turns(steps, TRAIN_MESH_ROUNDS)
        tm["step_ms"] = turns
        for name, fn in steps.items():
            prof = _profiled_step(fn, reps=2)
            prof["idle_share"] = max(
                0.0, 1 - prof["device_busy_us"] / (turns[name][1] * 1e3))
            tm[name]["profile"] = prof
        a, b = tm["plain"]["profile"], tm["placed"]["profile"]
        say("train_mesh", f"{res['nvidia_smi']}: step ms in turns "
            f"({TRAIN_MESH_ROUNDS} rounds, q1 / median / q3) plain "
            f"{' / '.join(f'{x:.1f}' for x in turns['plain'])}, placed "
            f"{' / '.join(f'{x:.1f}' for x in turns['placed'])} "
            f"({turns['placed'][1] / turns['plain'][1]:.2f}x); profiled "
            f"step: plain {a['device_kernels']} device kernels, busy "
            f"{a['device_busy_us'] / 1e3:.1f} ms, idle share "
            f"{a['idle_share']:.3f}; placed {b['device_kernels']} device "
            f"kernels, busy {b['device_busy_us'] / 1e3:.1f} ms, idle share "
            f"{b['idle_share']:.3f}")
        for name in steps:
            for k, v in tm[name]["profile"]["top"]:
                say("train_mesh", f"  {name} {v / 1e3:9.2f} ms  {k}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if dist.is_initialized():
            dist.destroy_process_group()
    tm["seconds"] = time.perf_counter() - t0
    say("train_mesh", f"ok {tm['seconds']:.1f}s")


def _dryrun_processes(out_dir: str) -> list:
    """One `python -m repro_torch.launch.dryrun --mesh single` process per
    DRYRUN_CELLS cell, started at once, on the CPU (no CUDA device
    visible): [(arch, shape, process, JSON path, log file)]."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    procs = []
    for arch, shape in DRYRUN_CELLS:
        out = os.path.join(out_dir, f"dryrun_{arch}_{shape}.json")
        log = open(os.path.join(out_dir, f"dryrun_{arch}_{shape}.log"), "w")
        procs.append((arch, shape, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "single", "--out", out],
            stdout=log, stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL,
            env=env, cwd=ROOT), out, log))
    return procs


def _dryrun_rows(dr: dict, procs: list, t0: float) -> None:
    """Wait for the dry-run processes until DRYRUN_TIMEOUT_S after `t0`;
    each must exit 0 with its cell `[ok]`: a row with a roofline and a fit
    peak.  (The caller kills what still runs.)"""
    deadline = t0 + DRYRUN_TIMEOUT_S
    for arch, shape, p, out, log in procs:
        p.wait(timeout=max(deadline - time.perf_counter(), 1.0))
        if p.returncode != 0:
            raise AssertionError(f"dry-run of {arch} x {shape} exited "
                                 f"{p.returncode}; see {log.name}")
    dr["cells"] = []
    for arch, shape, _, out, _ in procs:
        with open(out) as f:
            row, = json.load(f)
        rl = row.get("roofline")
        mem = row.get("fit_memory", row.get("memory", {}))
        if "error" in row or rl is None or "peak_bytes" not in mem:
            raise AssertionError(f"dry-run cell not ok: {row}")
        dr["cells"].append(row)
        say("dryrun", f"[ok] {arch} x {shape} on {row['mesh']} "
            f"({row['chips']} ranks of torch's fake group): bound "
            f"{rl['bottleneck']}, useful_ratio {rl['useful_ratio']:.4f}, "
            f"roofline_fraction {rl['roofline_fraction']:.5f}, fit peak "
            f"{mem['peak_bytes'] / 2**30:.2f} GiB a rank, probes "
            f"{row.get('probe_depths')}, counted in {row['compile_s']:.1f}s "
            f"+ fit {row.get('fit_compile_s', 0):.1f}s")
    dr["cells_wall_s"] = time.perf_counter() - t0
    say("dryrun", f"the {len(procs)} cells' processes took "
        f"{dr['cells_wall_s']:.1f}s of wall time")


def phase_dryrun(res: dict, dev) -> None:
    """launch.dryrun on the card's torch: DRYRUN_CELLS in processes of their
    own (on the CPU, torch's fake group of 256 ranks), while this process
    counts the train phase's cell — qwen3-0.6b FULL, the registry config,
    TRAIN_BATCH x TRAIN_SEQ — with the dry-run's own functions on meta
    tensors placed on the card's one-rank NCCL mesh, and runs the same
    step for real, plain, on the card: (a) the counted FLOPs equal
    FlopCounterMode's over the real step; (b) the predicted peak is within
    DRYRUN_PEAK_TOL of the step's `max_memory_allocated`; (c) the roofline
    bound max(t_compute, t_memory) is at or below the median step."""
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import make_model
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import TrainConfig, make_train_step

    dr = res["dryrun"] = {}
    t0 = time.perf_counter()
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = _dryrun_processes(OUT_DIR)
    try:
        cfg = get_config(TRAIN_ARCH)
        tokens = TRAIN_BATCH * TRAIN_SEQ
        shape = ShapeSpec("train_phase", "train", TRAIN_SEQ, TRAIN_BATCH)
        mesh = make_host_mesh(("data",), "cuda")
        t = time.perf_counter()
        counted = D._lower_for_kind(make_model(cfg, "meta"), cfg, shape,
                                    mesh).compile()
        count_s = time.perf_counter() - t
        m = D._measure(counted)
        mem = RL.memory_summary(counted)
        rl = RL.analyze(m, RL.model_flops_for(cfg, "train", tokens), 1)
        dr["count"] = {"counts": m, "memory": mem, "roofline": rl.row(),
                       "seconds": count_s, "backend": str(dist.get_backend())}
        say("dryrun", f"counted on the card's one-rank "
            f"{dr['count']['backend']} mesh ({cfg.name} FULL, {TRAIN_BATCH}"
            f" x {TRAIN_SEQ}, meta tensors, {count_s:.1f}s): "
            f"{m['flops']:.6e} FLOPs, {m['hbm']:.6e} bytes, collectives "
            f"{m['coll']}; argument {mem['argument_bytes']:,} B, temp "
            f"{mem['temp_bytes']:,} B, predicted peak "
            f"{mem['peak_bytes']:,} B; t_compute {rl.t_compute * 1e3:.3f} "
            f"ms, t_memory {rl.t_memory * 1e3:.3f} ms")

        model = make_model(cfg, dev).init(
            torch.Generator(device=dev).manual_seed(SERVE_SEED))
        params = model.master_params()
        opt = init_opt_state(params)
        batch = TokenPipeline(vocab=cfg.vocab, batch=TRAIN_BATCH,
                              seq=TRAIN_SEQ, device=dev)(0)
        step = make_train_step(model, TrainConfig())
        step(params, opt, batch, 0)   # warm: cuBLAS handles
        torch.cuda.synchronize()
        with FlopCounterMode(display=False) as fc:
            out = step(params, opt, batch, 0)
            torch.cuda.synchronize()
        del out
        flops = fc.get_total_flops()
        torch.cuda.empty_cache()
        args = RL.local_bytes((params, opt, batch))
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = step(params, opt, batch, 0)
        torch.cuda.synchronize()
        raw_peak = torch.cuda.max_memory_allocated()
        del out
        step_peak = raw_peak - before + args
        times = []
        for _ in range(DRYRUN_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(params, opt, batch, 0)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            del out
        median = float(np.median(times))
        bound_ms = max(rl.t_compute, rl.t_memory) * 1e3
        peak_err = (mem["peak_bytes"] - step_peak) / step_peak
        dr["real"] = {"flops": flops, "max_memory_allocated": raw_peak,
                      "allocated_before": before, "argument_bytes": args,
                      "step_peak": step_peak, "step_ms": times,
                      "median_ms": median}
        dr["checks"] = {"flops_equal": m["flops"] == flops,
                        "peak_rel_err": peak_err,
                        "bound_ms": bound_ms,
                        "bound_over_median": bound_ms / median}
        same = "equal" if flops == m["flops"] else "NOT equal"
        say("dryrun", f"{res['nvidia_smi']}: the real plain step on the "
            f"card, FlopCounterMode {flops:.6e} FLOPs against the count "
            f"{m['flops']:.6e}: {same}")
        say("dryrun", f"max_memory_allocated over the step {raw_peak:,} B "
            f"({before:,} B allocated before it, the step's arguments "
            f"{args:,} B): the step's peak {step_peak:,} B against the "
            f"predicted {mem['peak_bytes']:,} B, {peak_err:+.2%} "
            f"(limit {DRYRUN_PEAK_TOL:.0%})")
        say("dryrun", f"bound max(t_compute, t_memory) {bound_ms:.3f} ms "
            f"({rl.bottleneck}) against the median of {DRYRUN_STEPS} steps "
            f"{median:.1f} ms (steps {', '.join(f'{x:.1f}' for x in times)}"
            f"): ratio {bound_ms / median:.4f}")
        del params, opt, batch, model
        if flops != m["flops"] or abs(peak_err) > DRYRUN_PEAK_TOL \
                or bound_ms > median:
            raise AssertionError(f"dry-run count against the real step: "
                                 f"{dr['checks']}")
        _dryrun_rows(dr, procs, t0)
    finally:
        for _, _, p, _, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        if dist.is_initialized():
            dist.destroy_process_group()
    dr["seconds"] = time.perf_counter() - t0
    say("dryrun", f"ok {dr['seconds']:.1f}s")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    # `--only probe,flash,...`: the build and the named kernel checks
    # alone, for a short run while a kernel changes; `dataflow` adds the
    # flows, timing and profile phases, `adaptive`, `serving`, `mesh`,
    # `train`, `train_mesh`, `dryrun` and the FAMILY_PHASES names (serve_moe,
    # serve_mixtral, serve_vlm, serve_encdec) those phases; no result line
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
        if only is not None and "adaptive" in only:
            phase = "adaptive"
            phase_adaptive(res, dev)
        if only is not None and "serving" in only:
            phase = "serving"
            phase_serving(res, dev)
        if only is not None and "mesh" in only:
            phase = "mesh"
            phase_mesh(res, dev)
        for phase in FAMILY_PHASES:
            if only is not None and phase in only:
                torch.cuda.empty_cache()
                phase_serve_family(res, dev, phase)
        if only is not None and "train" in only:
            phase = "train"
            torch.cuda.empty_cache()
            phase_train(res, dev)
        if only is not None and "train_mesh" in only:
            phase = "train_mesh"
            torch.cuda.empty_cache()
            phase_train_mesh(res, dev)
        if only is not None and "dryrun" in only:
            phase = "dryrun"
            torch.cuda.empty_cache()
            phase_dryrun(res, dev)
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
        phase = "adaptive"
        phase_adaptive(res, dev)
        phase = "serving"
        phase_serving(res, dev)
        torch.cuda.empty_cache()
        phase = "mesh"
        phase_mesh(res, dev)
        for k in kernels:  # the mesh path's own counts beside the main path's
            if k["name"] in res["mesh"]["launches"]:
                k["mesh_launches"] = res["mesh"]["launches"][k["name"]]
        torch.cuda.empty_cache()
        phase = "serve"
        kernels.append(phase_serve(res, dev))
        for arch in RECURRENT_ARCHS:
            torch.cuda.empty_cache()
            phase = f"serve_{arch}"
            kernels.append(phase_serve_recurrent(res, dev, arch))
        flash = next(k for k in kernels if k["name"] == "flash_attention")
        flash["phase_launches"] = {"serve": flash["launches"]}
        for phase in FAMILY_PHASES:  # each path's own count beside serve's
            torch.cuda.empty_cache()
            flash["phase_launches"][phase] = phase_serve_family(
                res, dev, phase)["flash_attention"]
        torch.cuda.empty_cache()
        phase = "train"
        phase_train(res, dev)
        torch.cuda.empty_cache()
        phase = "train_mesh"
        phase_train_mesh(res, dev)
        torch.cuda.empty_cache()
        phase = "dryrun"
        phase_dryrun(res, dev)
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
