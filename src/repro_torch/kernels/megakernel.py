"""Whole-stage megakernel spans: run a chain of pipeline stages as one fused
body that prunes dead columns and packs only what the next stage reads
(DESIGN.md §10).

Port of `repro.kernels.megakernel`.  The composed pipeline
(`pipeline.run_stages`) compacts every stage boundary in full: it gathers
every column the producer emits, and the next Reduce re-walks validity gaps
with a forward fill.  A fused span removes both costs without changing a
single result bit:

* **Dead-column pruning** — before an interior compaction the producer's
  columns are intersected with what the consuming stage can observe: its
  SCA effective read set (`reorder.eff_reads`, which includes its keys)
  plus every field its operators re-emit (`out_schema`, covering KAT
  passthrough and `ir.copy()`-style projections whose reads SCA cannot
  narrow).  Dead columns are never gathered.  Order metadata is truncated
  to the surviving prefix; keys are always live, so no sort elision flips.

* **Contiguity** — an interior compaction leaves valid rows as a prefix, so
  the next Reduce segments with adjacent-slot compares
  (`masked._segments_contiguous`) instead of the gap-tolerant walk —
  bit-identical on a packed batch (the previous valid row IS the adjacent
  slot).

The span body reuses the masked executors verbatim (`pipeline.
execute_stage`, which keeps running `sorted_probe` and `segmented_scan`
under `use_kernels`), compacts interior boundaries to exactly the
capacities the composed path would, and returns the same per-stage
`(valid count, aux)` observation pairs `run_stages` reports.

What one fused span is on Hopper.  The TPU runs a span as a single
grid-free `pallas_call` with every leaf resident in 128 MiB of VMEM.  A
Hopper block has 227 KB of shared memory and cannot run arbitrary UDF
bodies in one hand-written kernel, so on the card a span is several
launches whose intermediates pass through device memory: the stages' own
executors (torch ops for the UDFs, the probe and scan kernels), one
`span_compact` launch per interior boundary that compacts, and one
`span_segment` launch per in-span Reduce whose input was just packed.
What the span saves is the work between them: dead columns are never
gathered; the composed boundary's prefix sum + binary search + clamp + one
gather per column + validity compare (`MaskedBatch.compact`,
`scans.pack_indices`) becomes one pass that also yields the observed
count; and the forward-fill segmentation becomes an adjacent-slot compare
that also yields the group count.  Both kernels launch for CUDA tensors;
CPU tensors run their plain versions (`kernels.ref`).

Fallback (`plan_routes`): Cross, CoGroup, anti and hint-less Match stages,
spans shorter than two stages, multi-consumer interior edges,
non-8-blockable capacities and budget overruns all route "solo" — the
composed path.
"""

from __future__ import annotations

import collections
from typing import Optional, Sequence

import numpy as np

from .. import hw
from ..core import masked as M
from ..core.reorder import eff_reads

# The default span budget.  On the TPU a span's leaves must fit in VMEM; on
# Hopper they live in device memory between a span's launches, so the
# budget bounds device memory instead: a span's planned buffers (inputs
# plus one same-width output per stage, the estimate `plan_routes` sums)
# must fit beside the bound batches and the caching allocator's slack.  A
# quarter of the card's HBM leaves the other three quarters to them.
SPAN_BUDGET_BYTES = int(hw.H100_SXM.hbm_capacity // 4)


# ---------------------------------------------------------------------------
# Fusability predicate + route planning
# ---------------------------------------------------------------------------
def _stage_fusable(st) -> bool:
    if st.kind in ("chain", "reduce"):
        return True
    if st.kind == "match":
        # a hint-less Match executes as a cross product — not fusable; an
        # anti Match has its own executor the span body does not route
        return not st.top.anti \
            and st.top.hints.pk_side in ("left", "right")
    return False  # cross / cogroup / limit: stay composed


def _input_nodes(st) -> tuple:
    if st.kind == "chain":
        return (st.ops[0].child,)
    return tuple(st.top.children)


def _row_bytes(node) -> int:
    sch = node.out_schema
    total = sum(np.dtype(sch.dtype(f)).itemsize for f in sch.fields)
    return max(total, 8) + 1  # +1: the validity mask


def plan_routes(stages: Sequence, src_caps, vmem_bytes: Optional[int] = None,
                require_forward: bool = False) -> Optional[tuple]:
    """Partition a lowered stage list into megakernel spans and solo stages.

    Returns a tuple of `("mega", i, j)` (stages[i:j] fused) and
    `("solo", i)` entries covering the list in order, or None when nothing
    fuses (the composed path).  A span is a maximal run where

    * every stage kind is fusable (`chain` / `reduce` / PK `match`);
    * each interior output is consumed ONLY by the next stage (checked
      against every stage's input refs — shared subtrees stay solo);
    * every resolvable input capacity is 8-blockable (source capacities come
      bucketed from `_bind`; arbitrary user-masked batches may not be);
    * the running resident-bytes estimate (inputs + a same-width output
      bound per stage, from the operator schemas) fits `vmem_bytes`
      (default `SPAN_BUDGET_BYTES`; the name is the reference's, whose
      budget is the TPU's VMEM);
    * with `require_forward` (the sharded per-shard walk), every span
      stage ships all inputs `forward` — collectives stay at solo-stage
      inputs, so every shard runs the same span.

    Deterministic in (stages, src_caps): every shard and every retrace of
    one source signature computes identical routes.
    """
    n = len(stages)
    if n < 2:
        return None
    budget_cap = vmem_bytes if vmem_bytes is not None else SPAN_BUDGET_BYTES
    consumers: collections.Counter = collections.Counter()
    for st in stages:
        for ref in st.inputs:
            if ref[0] == "stage":
                consumers[ref[1]] += 1
    max_src = max(src_caps.values(), default=8)

    def cap_of(ref) -> int:
        if ref[0] == "source":
            return int(src_caps.get(ref[1], max_src))
        return int(max_src)  # out-of-span stage ref: conservative bound

    def admissible(k: int) -> bool:
        st = stages[k]
        if not _stage_fusable(st):
            return False
        if any(cap_of(r) % 8 or cap_of(r) < 8 for r in st.inputs):
            return False
        return not (require_forward
                    and any(s != "forward" for s in (st.ship or ())))

    def resident(k: int) -> int:
        st = stages[k]
        caps = [cap_of(r) for r in st.inputs]
        total = sum(c * _row_bytes(kid)
                    for c, kid in zip(caps, _input_nodes(st)))
        return total + max(caps) * _row_bytes(st.top)

    def extends(k: int) -> bool:
        st = stages[k]
        if not admissible(k):
            return False
        hits = sum(1 for r in st.inputs if r == ("stage", k - 1))
        # prev's output must flow ONLY into this stage (and must be used)
        return hits > 0 and consumers[k - 1] == hits

    entries: list = []
    i = 0
    while i < n:
        j = i
        if admissible(i) and resident(i) <= budget_cap:
            budget = resident(i)
            j = i + 1
            while j < n and extends(j) and budget + resident(j) <= budget_cap:
                budget += resident(j)
                j += 1
        if j - i >= 2:
            entries.append(("mega", i, j))
            i = j
        else:
            entries.append(("solo", i))
            i += 1
    if all(e[0] == "solo" for e in entries):
        return None
    return tuple(entries)


def span_has_aux(span: Sequence) -> tuple:
    """Which span stages emit a KAT/Match side-channel count (static)."""
    return tuple(st.kind != "chain" for st in span)


# ---------------------------------------------------------------------------
# Dead-column pruning (SCA liveness at interior boundaries)
# ---------------------------------------------------------------------------
def _live_fields(consumer, fields) -> tuple:
    """Columns of a producer batch the `consumer` stage can observe: the
    union over its fused operators of the SCA effective read set (which
    includes every operator's keys) and the operator's output fields (KAT
    passthrough projects `dict(sb.columns)` through `out_schema`, and
    `ir.copy()`-style UDFs re-emit fields SCA does not list as reads)."""
    live: set = set()
    for op in consumer.ops:
        live |= eff_reads(op)
        live |= set(op.out_schema.fields)
    return tuple(f for f in fields if f in live)


# ---------------------------------------------------------------------------
# Span execution
# ---------------------------------------------------------------------------
def _span_body(span, ins_per_stage, planned_caps, use_kernels, use_order,
               caps_acc: list, observe: bool):
    from ..core import pipeline as PL
    from . import ops as kops

    prev: Optional[M.MaskedBatch] = None
    prev_packed = False
    obs_out: list = []
    out = None
    for k, (st, raw_ins) in enumerate(zip(span, ins_per_stage)):
        ins = [prev if b is None else b for b in raw_ins]
        obs: Optional[dict] = {} if observe else None
        out = PL.execute_stage(st, ins, use_kernels, use_order, obs,
                               contiguous_in=prev_packed)
        aux = obs.get("groups", -1) if observe else None
        if k == len(span) - 1:
            if observe:
                obs_out.append((out.valid.sum(), aux))
            break
        # interior boundary: prune dead columns, compact to exactly the
        # capacity the composed path would, and record packedness for the
        # consumer's contiguous segmentation
        nxt = span[k + 1]
        live = _live_fields(nxt, out.columns.keys())
        order = M.order_prefix(out.order, live)
        cap = min(out.capacity, planned_caps[k])
        caps_acc.append(cap)
        if cap < out.capacity:
            cols, valid, count = kops.span_compact(
                [out.columns[f] for f in live], out.valid, cap)
            out = M.MaskedBatch(dict(zip(live, cols)), valid, order)
            prev_packed = True
        else:
            # the count is taken only for an observer: on the card it is a
            # launch of its own, which the composed walk makes only then
            count = out.valid.sum() if observe else None
            out = M.MaskedBatch({f: out.columns[f] for f in live}, out.valid,
                                order)
            prev_packed = False
        if observe:
            obs_out.append((count, aux))
        # attach the lowered order assumption on the in-span edge, exactly
        # as run_stages does for solo stages
        orders = nxt.in_orders or ((),) * len(nxt.inputs)
        for t, b in enumerate(ins_per_stage[k + 1]):
            if b is None and use_order and orders[t] and not out.order:
                out = out.with_order(orders[t])
                break
        prev = out
    return out, obs_out


def run_span(span: Sequence, ins_per_stage: Sequence, planned_caps: Sequence,
             use_kernels: bool, use_order: bool, observe: bool = True):
    """Execute a fused span.

    `ins_per_stage[k]` lists stage k's resolved input batches with None
    marking the in-span edge (the previous stage's output, substituted
    internally); `planned_caps[k]` is stage k's planned compaction capacity
    (`masked.planned_capacity`).  Interior boundaries compact inside the
    span (pruned to live columns); the LAST stage's output returns RAW for
    the caller's usual boundary compaction.

    Returns `(raw_out, obs, caps)`: `obs` is the per-stage
    `(pre-compaction valid count, aux)` list matching `run_stages` (device
    scalars; aux is -1 for aux-free stages), `caps` the interior capacities
    applied (host ints).  With `observe=False` the span takes no count
    that only the observation needs and `obs` is empty; the reference
    always observes, inside its one fused call."""
    caps: list = []
    raw, obs = _span_body(span, list(ins_per_stage), planned_caps,
                          use_kernels, use_order, caps, observe)
    return raw, obs, tuple(caps)
