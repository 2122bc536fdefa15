"""Compiled plan pipelines: fused lowering + a plan-executable cache.

Port of `repro.core.pipeline`, its adaptive half included.  The
optimizer's output only pays off if the chosen plan runs fast
*repeatedly*: the serving pattern is many small request batches over a
handful of flow shapes.  This module lowers a plan once into a pipeline of
STAGES (DESIGN.md §5):

* maximal unary Map/filter chains fuse into a single stage — one boundary
  compaction instead of N (boundary compaction is a stable linear prefix-sum
  pack, `MaskedBatch.compact`);
* Reduce / Match / Cross / CoGroup remain explicit stage boundaries (they
  re-shape the batch: sorts, probes, segment reductions), routed through the
  CUDA kernels when `use_kernels` is set;
* every static capacity is drawn from the geometric `bucket_capacity`
  ladder, so the number of distinct shapes stays O(log n);
* stages carry the ORDER properties the physical layer reasons about
  (`Stage.in_orders`/`out_order`, DESIGN.md §8): a stage whose input is
  already sorted on its key skips the per-batch sort entirely;
* runs of fusable stages route through the whole-stage megakernel span
  (`kernels.megakernel`, DESIGN.md §10) by default: dead columns are pruned
  at interior boundaries, which the `span_compact` kernel packs, and a
  Reduce on a just-packed input segments with the `span_segment` kernel.
  `REPRO_MEGAKERNEL=0` (or `use_megakernel=False`) keeps the composed
  per-stage walk.

PyTorch runs eagerly, so an "executable" is the stage walk bound to one
source signature, with every compaction capacity computed once when it is
built: a warm call is a fixed sequence of device launches with no host
sync.  Executables are cached in an `ExecutableCache` keyed on a
commute-invariant SEMANTIC fingerprint of the flow (`semantic_key`) plus
source capacity buckets and runtime orders, the stages' order assumptions,
`use_kernels`, `compact_slack`, `use_order`, `observe` and the megakernel
route:

    res = optimize(flow)
    cp = res.compile(use_kernels=True)     # device="cuda" by default
    out = cp.run(bindings)      # cold: builds the executable
    out = cp.run(bindings2)     # warm: cached executable

Device-resident serving: `run` pays a host round trip per call (bind numpy
→ device → compute → fetch).  `bind_device` stages batches onto the device
once and `run_device` executes masked-in/masked-out with no host transfer.

Adaptive serving (DESIGN.md §9): with an `AdaptiveConfig`, every executed
batch also returns its stage-boundary valid-row counts — packed on the
device into one int64 vector and read with ONE device-to-host copy — into
a per-handle `cost.StatsStore`; a hysteresis-banded drift check
re-optimizes under calibrated posterior hints and hot-swaps the stages
when the workload's observed statistics durably leave the hints' regime.
Calibrated hints are part of `semantic_key`, so a swap is a deliberate
cache miss into a coexisting regime entry, and a batch that overran a
planned compaction capacity is re-executed under the repaired plan before
it is returned.  PyTorch has no buffer donation: no entry point takes a
`donate` argument, and a truncation re-run reuses the bound inputs, which
no executor writes into.

Multi-tenant serving (DESIGN.md §11): `serve.dataflow.DataflowEngine`
builds on this module's primitives — `semantic_key` routes tenants into
plan groups, `bind_device` / `run_device_observed` / `fold_observation`
serve coalesced batches with per-tenant feedback, and one shared
`ExecutableCache` keeps every regime's executables warm across tenants.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import os
import threading
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from . import masked as M
from .cost import StatsStore, calibrate_hints, drift_score, seed_source_stats
from .operators import (CoGroupOp, CrossOp, LimitOp, MapOp, MatchOp, Node,
                        ReduceOp, Source)
from .physical import PhysPlan
from .record import RecordBatch, resolve_device
from .reorder import eff_writes
from .udf import Card, KatEmit


# ---------------------------------------------------------------------------
# Semantic flow fingerprint (the executable-cache identity)
#
# `struct_id`/`commute_id` intern on operator NAMES only — fine inside one
# enumeration run (DESIGN.md §7.3) but unsafe as a process-wide cache key:
# two same-named operators with different UDFs, keys or hints would collide.
# `semantic_key` fingerprints by value instead: UDF code objects (unwrapping
# the `commute` swap wrapper), keys, hints and source cardinalities, with
# binary-operator sides sorted so the key is commute-invariant.  Anything
# whose repr is identity-based (a closure over a lambda, say) degrades to a
# spurious MISS — a rebuild, never a wrong answer.
# ---------------------------------------------------------------------------
def _safe_repr(x) -> str:
    try:
        return repr(x)
    except Exception:  # pragma: no cover - defensive
        return f"<unreprable {type(x).__name__}>"


def _code_fp(code) -> tuple:
    """Recursive code-object fingerprint: bytecode + consts (descending into
    nested code objects, so a changed constant inside a nested lambda or
    comprehension changes the fingerprint) + referenced names."""
    consts = tuple(_code_fp(c) if hasattr(c, "co_code") else _safe_repr(c)
                   for c in code.co_consts)
    return (code.co_code, consts, code.co_names)


def _code_names(code) -> set:
    names = set(code.co_names)
    for c in code.co_consts:
        if hasattr(c, "co_code"):
            names |= _code_names(c)
    return names


def _value_fp(v, seen: set):
    """Fingerprint an environment value (closure cell / global / default).
    Functions recurse into their own code+environment so helper functions
    rebuilt per flow construction still compare equal by value; everything
    else falls back to repr (identity-laden reprs degrade to spurious cache
    misses — a rebuild, never a wrong answer)."""
    if callable(v) and (hasattr(v, "__code__")
                        or hasattr(v, "__wrapped_pair_udf__")):
        return _udf_fingerprint(v, seen)
    if isinstance(v, torch.Tensor):  # repr truncates large tensors too
        v = v.detach().cpu().numpy()
    if isinstance(v, np.ndarray):  # repr truncates large arrays ("...")
        return ("ndarray", v.shape, str(v.dtype),
                hashlib.sha1(np.ascontiguousarray(v).tobytes()).hexdigest())
    return _safe_repr(v)


def _udf_fingerprint(udf, seen: Optional[set] = None) -> tuple:
    if seen is None:
        seen = set()
    while hasattr(udf, "__wrapped_pair_udf__"):  # commute's arg-swap wrapper
        udf = udf.__wrapped_pair_udf__
    code = getattr(udf, "__code__", None)
    if code is None:
        return ("opaque", _safe_repr(udf))
    if id(udf) in seen:  # recursive helper reference
        return ("recursive",)
    seen.add(id(udf))

    def cell_fp(c):
        try:
            return _value_fp(c.cell_contents, seen)
        except ValueError:  # empty cell
            return "<empty-cell>"

    cells = tuple(cell_fp(c) for c in (udf.__closure__ or ()))
    defaults = tuple(_value_fp(d, seen) for d in (udf.__defaults__ or ()))
    gl = getattr(udf, "__globals__", {})
    gvals = tuple(sorted(((n, _value_fp(gl[n], seen))
                          for n in _code_names(code) if n in gl),
                         key=lambda t: t[0]))
    return (_code_fp(code), cells, defaults, gvals)


def _hints_fingerprint(h, pk_sem) -> tuple:
    # pk_side is expressed as the pk child's semantic key (commute swaps the
    # left/right labels but not which child holds the unique key)
    return (h.selectivity, h.distinct_keys, h.cpu_flops_per_record,
            h.join_fanout, h.group_selectivity, pk_sem)


def semantic_key(node: Node, _memo: Optional[dict] = None) -> tuple:
    """Commute-invariant, identity-free fingerprint of a flow's semantics.

    Two flows share a key iff they compute the same result by construction:
    operator names, UDF code fingerprinted by VALUE (bytecode, closures,
    referenced globals — a rebuilt identical flow hits, a same-named
    different UDF never collides), reduce/join keys, source schemas,
    cardinalities and declared sort orders, with binary-operator sides
    sorted so join argument order never splits the key.  HINTS are part of
    the fingerprint — deliberately: calibrated posterior hints define a
    plan's statistics regime, so an adaptive swap (DESIGN.md §9) or a
    drifted tenant's recalibration (§11) lands in a coexisting cache entry
    instead of clobbering the old regime, and drifting back re-hits warm.

    This is the executable-cache identity (with physical details appended —
    see `ExecutableCache`) and the multi-tenant engine's routing key:
    tenants whose flows agree on it queue into one plan group and share its
    warm executables (`serve.dataflow`)."""
    if _memo is None:
        _memo = {}
    hit = _memo.get(id(node))
    if hit is not None:
        return hit
    if isinstance(node, Source):
        # sorted_on is an ORDER assumption: two otherwise-identical flows
        # that differ only in a declared source order elide different sorts
        # and must never share an executable
        out = ("src", node.name, _schema_sig(node.out_schema),
               node.num_records, node.partitioned_on, node.sorted_on)
    elif isinstance(node, MapOp):
        out = ("map", node.name, _udf_fingerprint(node.udf),
               _hints_fingerprint(node.hints, None),
               semantic_key(node.child, _memo))
    elif isinstance(node, ReduceOp):
        # `combiner` changes execution semantics (partial aggregation) and
        # `props.combine` changes the plan space a flow compiles from — two
        # Reduces identical in code but differing ONLY in decomposability
        # (e.g. via manual props) must not share an executable.
        out = ("reduce", node.name, _udf_fingerprint(node.udf), node.key,
               node.combiner, node.props.combine,
               _hints_fingerprint(node.hints, None),
               semantic_key(node.child, _memo))
    elif isinstance(node, LimitOp):
        out = ("limit", node.name, node.k, node.key,
               _hints_fingerprint(node.hints, None),
               semantic_key(node.child, _memo))
    elif isinstance(node, (MatchOp, CrossOp, CoGroupOp)):
        lsem = semantic_key(node.left, _memo)
        rsem = semantic_key(node.right, _memo)
        lk = getattr(node, "left_key", ())
        rk = getattr(node, "right_key", ())
        anti = getattr(node, "anti", False)
        # key=repr: fingerprints mix bytes/str/None, which plain tuple
        # comparison cannot order (repr of nested tuples is deterministic).
        # Anti joins keep the sides ORDERED: argument order is semantic
        # (only left survives), so anti(X,Y) must never alias anti(Y,X).
        sides = ((lsem, lk), (rsem, rk)) if anti \
            else tuple(sorted(((lsem, lk), (rsem, rk)), key=repr))
        pk_sem = {"left": lsem, "right": rsem}.get(node.hints.pk_side)
        out = (type(node).__name__, node.name, _udf_fingerprint(node.udf),
               sides, _hints_fingerprint(node.hints, pk_sem), anti)
    else:
        raise TypeError(type(node).__name__)
    _memo[id(node)] = out
    return out


# ---------------------------------------------------------------------------
# Stage representation
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Stage:
    """One fused execution step of a lowered plan.

    `ops` is bottom-up: for a `chain` stage it is the fused run of MapOps,
    otherwise a single operator.  `inputs` are `("source", name)` or
    `("stage", index)` references into the stage list (a DAG in topological
    order).  `ship`/`input_plans` carry the physical shipping strategy and
    the producing sub-plan per input when lowered from a `PhysPlan`
    (`lower_phys`); logical lowering ships everything `forward`.

    `in_orders`/`out_order` are the runtime order properties (DESIGN.md §8):
    per input, the column prefix the incoming stream is statically known to
    be sorted on (the physical layer's `Props.sort`, restricted to what the
    masked executors actually guarantee), and the order of this stage's
    output.  Executors use them to elide sorts; the executable cache
    fingerprints them so plans with different elisions never share a trace.
    """

    kind: str                   # 'chain'|'reduce'|'match'|'cross'|'cogroup'
    ops: tuple
    inputs: tuple
    ship: tuple = ()
    input_plans: tuple = ()
    in_orders: tuple = ()
    out_order: tuple = ()
    # per input: hash-partition columns chosen by the physical layout (the
    # optimizer may partition a multi-column Reduce on a key SUBSET); empty
    # or None entries fall back to the operator's own key at runtime
    ship_keys: tuple = ()

    @property
    def top(self) -> Node:
        return self.ops[-1]


_KIND = {ReduceOp: "reduce", MatchOp: "match", CrossOp: "cross",
         CoGroupOp: "cogroup", LimitOp: "limit"}

# emission classes whose masked execution yields a single slot-aligned part
_SINGLE_RAT = (Card.ONE, Card.AT_MOST_ONE)
_GROUP_EMITS = (KatEmit.PER_GROUP, KatEmit.PER_GROUP_FILTER)
_RECORD_EMITS = (KatEmit.PASSTHROUGH, KatEmit.PASSTHROUGH_FILTER)


def _chain_out_order(ops: Sequence[Node], in_order: tuple) -> tuple:
    """Order surviving a fused Map chain: each record-wise op preserves the
    prefix it neither drops nor writes — but only when it emits exactly one
    slot-aligned part (multi-emission concatenation interleaves slots)."""
    o = tuple(in_order)
    for op in ops:
        if op.props.card not in _SINGLE_RAT:
            return ()
        o = M.order_prefix(o, op.out_schema.fields, eff_writes(op))
    return o


def _stage_out_order(kind: str, node: Node, in_orders: tuple,
                     ops: tuple = ()) -> tuple:
    """Statically-known sort order of a stage's output, mirroring exactly
    what the masked executors produce (NOT what a Nephele sort-merge local
    strategy would — `_exec_cross` emits pair order, so a hint-less Match
    yields no order even though its cost model prices a sort-merge)."""
    if kind == "chain":
        return _chain_out_order(ops, in_orders[0])
    if kind == "reduce":
        key = tuple(node.key)
        emit = node.props.kat_emit
        base = in_orders[0] if M.order_covers(in_orders[0], key) else key
        if emit in _GROUP_EMITS:
            base = tuple(base)[:len(key)]
        elif emit not in _RECORD_EMITS:
            return ()
        return M.order_prefix(base, node.out_schema.fields, eff_writes(node))
    if kind == "limit":
        # a slot-aligned mask on the input: whatever order arrived survives
        return M.order_prefix(in_orders[0], node.out_schema.fields)
    if kind == "match":
        if node.anti:
            # survivors are left rows in left arrival order (writes nothing)
            return M.order_prefix(in_orders[0], node.out_schema.fields)
        side = {"right": 0, "left": 1}.get(node.hints.pk_side)
        if side is None or node.props.card not in _SINGLE_RAT:
            return ()
        return M.order_prefix(in_orders[side], node.out_schema.fields,
                              eff_writes(node))
    return ()  # cross / cogroup: pair or union-key order, claims nothing


def _use_counts(root, children_of) -> dict:
    """Number of distinct consumers per sub-object id (flows may share
    subtree OBJECTS — the executors memoize on id; fusion must not inline a
    shared subtree into one of its consumers and recompute it elsewhere)."""
    counts: collections.Counter = collections.Counter()
    seen: set = set()
    stack = [root]
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        for c in children_of(n):
            counts[id(c)] += 1
            stack.append(c)
    return counts


def lower(root: Node) -> tuple[Stage, ...]:
    """Lower a logical flow into topologically ordered fused stages.

    Shared subtree objects become shared stages (computed once); a Map
    chain therefore only fuses through nodes with a single consumer.
    Order properties propagate from `Source.sorted_on` through the stages.
    """
    uses = _use_counts(root, lambda n: n.children)
    stages: list[Stage] = []
    memo: dict[int, tuple] = {}
    ref_order: dict[tuple, tuple] = {}

    def order_of(ref: tuple, node: Node) -> tuple:
        if ref[0] == "source":
            return M.order_prefix(node.sorted_on or (),
                                  node.out_schema.fields)
        return ref_order.get(ref, ())

    def emit(kind, ops, inputs, ship, in_orders, input_plans=()):
        out_order = _stage_out_order(kind, ops[-1], in_orders, ops)
        stages.append(Stage(kind=kind, ops=ops, inputs=inputs, ship=ship,
                            input_plans=input_plans, in_orders=in_orders,
                            out_order=out_order))
        ref = ("stage", len(stages) - 1)
        ref_order[ref] = out_order
        return ref

    def visit(node: Node) -> tuple:
        ref = memo.get(id(node))
        if ref is not None:
            return ref
        if isinstance(node, Source):
            ref = ("source", node.name)
        elif isinstance(node, MapOp):
            chain = [node]
            n = node.child
            while isinstance(n, MapOp) and uses[id(n)] == 1:
                chain.append(n)
                n = n.child
            child_ref = visit(n)
            ref = emit("chain", tuple(reversed(chain)), (child_ref,),
                       ("forward",), (order_of(child_ref, n),))
        else:
            refs = tuple(visit(c) for c in node.children)
            in_orders = tuple(order_of(r, c)
                              for r, c in zip(refs, node.children))
            ref = emit(_KIND[type(node)], (node,), refs,
                       ("forward",) * len(refs), in_orders)
        memo[id(node)] = ref
        return ref

    ref = visit(root)
    if ref[0] == "source":  # bare-source flow: identity stage list
        return ()
    return tuple(stages)


def lower_phys(plan: PhysPlan) -> tuple[Stage, ...]:
    """Lower a physical plan: same fusion, plus per-input ship strategies.

    Order properties thread through from the physical plans' `Props`: a
    source contributes `Props.sort` (= `sorted_on`), but an input shipped by
    `partition` or `broadcast` contributes NOTHING — collectives interleave
    rows, so only forwarded streams keep their order (the runtime analogue
    of `physical._preserved`)."""
    uses = _use_counts(plan, lambda p: p.inputs)
    stages: list[Stage] = []
    memo: dict[int, tuple] = {}
    ref_order: dict[tuple, tuple] = {}

    def order_of(ref: tuple, p: PhysPlan) -> tuple:
        if ref[0] == "source":
            return M.order_prefix(p.props.sort, p.node.out_schema.fields)
        return ref_order.get(ref, ())

    def emit(kind, ops, inputs, ship, in_orders, input_plans, ship_keys=()):
        # a shipped (non-forward) input arrives order-free on every worker
        in_orders = tuple(o if s == "forward" else ()
                          for o, s in zip(in_orders, ship))
        out_order = _stage_out_order(kind, ops[-1], in_orders, ops)
        stages.append(Stage(kind=kind, ops=ops, inputs=inputs, ship=ship,
                            input_plans=input_plans, in_orders=in_orders,
                            out_order=out_order, ship_keys=ship_keys))
        ref = ("stage", len(stages) - 1)
        ref_order[ref] = out_order
        return ref

    def visit(p: PhysPlan) -> tuple:
        ref = memo.get(id(p))
        if ref is not None:
            return ref
        node = p.node
        if isinstance(node, Source):
            ref = ("source", node.name)
        elif isinstance(node, MapOp) and p.ship == ("forward",):
            chain = [p]
            cur = p.inputs[0]
            while isinstance(cur.node, MapOp) and cur.ship == ("forward",) \
                    and uses[id(cur)] == 1:
                chain.append(cur)
                cur = cur.inputs[0]
            child_ref = visit(cur)
            ref = emit("chain", tuple(cp.node for cp in reversed(chain)),
                       (child_ref,), ("forward",),
                       (order_of(child_ref, cur),), (cur,))
        else:
            refs = tuple(visit(ip) for ip in p.inputs)
            in_orders = tuple(order_of(r, ip)
                              for r, ip in zip(refs, p.inputs))
            ref = emit(_KIND[type(node)], (node,), refs, p.ship, in_orders,
                       p.inputs, p.ship_keys)
        memo[id(p)] = ref
        return ref

    ref = visit(plan)
    if ref[0] == "source":
        return ()
    return tuple(stages)


def _order_sig(stages: Sequence[Stage]) -> tuple:
    """Fingerprint of every order assumption a lowered stage list bakes into
    its trace (part of the executable-cache key: two lowerings of the same
    flow that elide different sorts must not share an executable; layouts —
    ship strategies and chosen partition columns — join the key the same
    way, so distributed plans with different wire choices never alias)."""
    return tuple((st.kind, st.ship, st.ship_keys, st.in_orders, st.out_order)
                 for st in stages)


class _Interned:
    """Hash-once wrapper for the (large, deeply nested) semantic fingerprint.

    A `semantic_key` tuple embeds bytecode and repr strings for every UDF;
    tuples re-hash recursively on every dict probe, which costs more than the
    whole warm serving step.  Wrapping it caches the hash so a cache lookup
    is O(1); equality still compares the full key (identity fast path for
    the common same-handle case)."""

    __slots__ = ("key", "_hash")

    def __init__(self, key):
        self.key = key
        self._hash = hash(key)

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        if self is other:
            return True
        return isinstance(other, _Interned) and self.key == other.key


# ---------------------------------------------------------------------------
# Stage execution
# ---------------------------------------------------------------------------
def execute_stage(stage: Stage, ins: Sequence[M.MaskedBatch],
                  use_kernels: bool, use_order: bool = True,
                  obs: Optional[dict] = None,
                  contiguous_in: bool = False) -> M.MaskedBatch:
    """Run one stage's computation on masked batches.

    Order elision keys off the input batches' `order` metadata; callers
    attach `stage.in_orders` (for forwarded inputs) before invoking.
    `obs`, when given, receives the stage's KAT/Match side-channel count
    (observed groups / probe hits / survivors) under "groups".
    `contiguous_in` asserts the first input was just prefix-packed (a
    megakernel interior boundary): a Reduce then segments with adjacent
    compares instead of the gap-tolerant walk, bit-identically."""
    if stage.kind == "chain":
        b = ins[0]
        for op in stage.ops:
            b = M._exec_map(op, b)
        return b
    node = stage.top
    if stage.kind == "reduce":
        return M._exec_reduce(node, ins[0], use_kernels, use_order, obs,
                              contiguous=contiguous_in)
    if stage.kind == "limit":
        return M._exec_limit(node, ins[0], use_order)
    if stage.kind == "match":
        lb, rb = ins
        if node.anti:
            # checked before pk_side: commute() refuses anti nodes, and the
            # sides must not swap anyway (only left survives)
            return M._exec_match_anti(node, lb, rb, use_kernels, use_order,
                                      obs)
        if node.hints.pk_side == "right":
            return M._exec_match_pk(node, lb, rb, use_kernels, use_order, obs)
        if node.hints.pk_side == "left":
            from .reorder import commute as _commute

            return M._exec_match_pk(_commute(node), rb, lb, use_kernels,
                                    use_order, obs)
        return M._exec_cross(node, lb, rb, node.left_key, node.right_key)
    if stage.kind == "cross":
        return M._exec_cross(node, *ins)
    if stage.kind == "cogroup":
        return M._exec_cogroup(node, *ins, use_kernels, use_order=use_order,
                               obs=obs)
    raise TypeError(f"unknown stage kind {stage.kind!r}")


def run_stages(stages: Sequence[Stage], bindings: Mapping[str, M.MaskedBatch],
               use_kernels: bool, compact_slack: float,
               stats_memo: dict, scale: float = 1.0,
               use_order: bool = True, observe: Optional[list] = None,
               caps: Optional[list] = None,
               routes: Optional[tuple] = None) -> M.MaskedBatch:
    """Execute a lowered stage list on masked batches.

    Compaction fires once per stage boundary (not per fused operator), to
    the bucketed capacity of the node's cardinality estimate — callers seed
    `stats_memo` with the bound batches' actual sizes
    (`cost.seed_source_stats`) so capacities track the data really flowing.
    Compaction is stable, so stage-boundary repacking PRESERVES the order
    the next stage's elision relies on.

    Observation (DESIGN.md §9): with `observe` a list, each stage appends
    `(valid_rows_before_compaction, kat_aux)` as device scalars (aux is -1
    for a stage without one); `caps` receives the capacity each stage
    compacts to.

    `routes` (from `kernels.megakernel.plan_routes`, DESIGN.md §10) sends
    runs of stages through the fused span executor; None (or a "solo"
    entry) is the composed per-stage walk.  A span appends the SAME
    per-stage observe/caps entries as the composed walk."""
    results: list[Optional[M.MaskedBatch]] = [None] * len(stages)

    def resolve(ref: tuple, o: tuple) -> M.MaskedBatch:
        b = bindings[ref[1]] if ref[0] == "source" else results[ref[1]]
        if use_order and o and not b.order:
            b = b.with_order(o)
        return b

    def boundary(st: Stage, out: M.MaskedBatch, obs: Optional[dict],
                 count=None) -> M.MaskedBatch:
        cap = min(out.capacity,
                  M.planned_capacity(st.top, stats_memo, compact_slack, scale))
        if caps is not None:
            caps.append(cap)
        if observe is not None:
            if obs is not None:  # composed stage: count taken here
                observe.append((out.valid.sum(), obs.get("groups", -1)))
            else:  # span tail: count already taken in the span
                observe.append(count)
        return out.compact(cap) if cap < out.capacity else out

    entries = routes or tuple(("solo", i) for i in range(len(stages)))
    last: Optional[M.MaskedBatch] = None
    for entry in entries:
        if entry[0] == "solo":
            i = entry[1]
            st = stages[i]
            orders = st.in_orders or ((),) * len(st.inputs)
            ins = [resolve(r, o) for r, o in zip(st.inputs, orders)]
            obs: Optional[dict] = {} if observe is not None else None
            out = execute_stage(st, ins, use_kernels, use_order, obs)
            last = results[i] = boundary(st, out, obs)
            continue
        from ..kernels import megakernel as MK

        _, i, j = entry
        span = stages[i:j]
        ins_per = []
        for k, st in enumerate(span):
            orders = st.in_orders or ((),) * len(st.inputs)
            ins_per.append([
                None if (k > 0 and r == ("stage", i + k - 1))
                else resolve(r, o)
                for r, o in zip(st.inputs, orders)])
        planned = [M.planned_capacity(st.top, stats_memo, compact_slack, scale)
                   for st in span]
        raw, span_obs, applied = MK.run_span(span, ins_per, planned,
                                             use_kernels, use_order,
                                             observe=observe is not None)
        if caps is not None:
            caps.extend(applied)
        if observe is not None:
            observe.extend(span_obs[:-1])
        last = results[j - 1] = boundary(
            span[-1], raw, None, count=span_obs[-1] if span_obs else None)
    return last


def stage_key(stage: Stage) -> tuple:
    """A stage's identity in a `StatsStore`: the fused operators' NAMES
    (bottom-up).  Names survive reordering rewrites, so observations made
    under one plan calibrate every equivalent plan of the same flow."""
    return tuple(op.name for op in stage.ops)


def record_batch_obs(store: StatsStore, stages: Sequence[Stage],
                     src_counts: Mapping[str, int],
                     out_counts: Sequence[int], aux: Sequence[int],
                     caps: Optional[Sequence[int]] = None) -> Optional[int]:
    """Fold one executed batch's boundary counts into `store`.

    Input rows per stage are resolved host-side from the producing stage's
    (post-compaction, i.e. truncation-capped) count or the source's valid
    count.  With `caps` given, returns the index of the first TRUNCATING
    stage (observed pre-compaction rows exceeded the planned capacity) —
    stages downstream of it saw truncated inputs, so their counts are NOT
    recorded, and the truncating stage's own count is recorded with
    `snap=True` (it is ground truth the next capacity must clear, not a
    sample).  Returns None when nothing truncated."""
    store.tick()
    for name, c in src_counts.items():
        store.observe_source(name, float(c))
    trunc = None
    if caps is not None:
        for i, (c, cap) in enumerate(zip(out_counts, caps)):
            if int(c) > int(cap):
                trunc = i
                break
    n_rec = len(stages) if trunc is None else trunc + 1
    for i in range(n_rec):
        st = stages[i]
        rows_in = []
        for ref in st.inputs:
            if ref[0] == "source":
                rows_in.append(float(src_counts[ref[1]]))
            else:
                j = ref[1]
                c = out_counts[j]
                if caps is not None:
                    c = min(int(c), int(caps[j]))
                rows_in.append(float(c))
        g: Optional[float] = float(aux[i]) if int(aux[i]) >= 0 else None
        if st.kind == "reduce" and st.top.combiner:
            # a combiner's per-shard groups over-count the global key set
            # (every worker may hold every group); the merge half above it
            # observes the true count
            g = None
        store.observe_stage(stage_key(st), rows_in, float(out_counts[i]),
                            g, snap=(i == trunc))
    return trunc


def _pack_observations(mb: Mapping[str, M.MaskedBatch], obs: Sequence
                       ) -> tuple:
    """One batch's observations as `(device vector, host template, slots)`:
    the layout is `[sources (name-sorted) valid rows, per-stage
    pre-compaction rows, per-stage aux]`.  Device scalars of mixed
    provenance (a mask's `sum`, `span_compact`'s count, a group count) are
    cast to int64 and stacked into ONE device vector, so reading the batch
    costs a single device-to-host copy; the aux of a stage without one is
    the static -1, kept in the host template and never sent to the device.
    `slots[i]` is the template index of the vector's i-th entry."""
    vals = [mb[n].valid.sum() for n in sorted(mb)]
    vals += [o[0] for o in obs] + [o[1] for o in obs]
    template = [-1] * len(vals)
    dev_vals, slots = [], []
    for i, v in enumerate(vals):
        if isinstance(v, torch.Tensor):
            dev_vals.append(v.to(torch.int64).reshape(()))
            slots.append(i)
        else:
            template[i] = int(v)
    # every source's valid count is on the device: the vector is never empty
    return torch.stack(dev_vals), template, slots


def _read_observations(packed: tuple) -> np.ndarray:
    """The packed observation vector on the host: one device-to-host copy
    of the device part, scattered into the static template."""
    vec, template, slots = packed
    out = np.asarray(template, dtype=np.int64)
    out[slots] = vec.cpu().numpy()
    return out


# ---------------------------------------------------------------------------
# Plan-executable cache
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CacheStats:
    """Cumulative `ExecutableCache` counters (`cache.stats()` snapshot).

    `hits`/`misses` count key lookups; `traces` counts executables actually
    built (a miss builds one), `size` is the current entry count,
    `evictions` the LRU drops (an evicted-then-needed entry returns as a
    fresh miss + build)."""

    hits: int
    misses: int
    traces: int
    size: int
    evictions: int = 0


# default capacity of the process-wide executable cache: env-tunable so a
# long-lived serving process can widen (or tighten) the bound without code
# changes
EXEC_CACHE_CAP_ENV = "REPRO_EXEC_CACHE_CAP"
_DEFAULT_CACHE_CAP = 256


def _default_cache_cap() -> int:
    try:
        cap = int(os.environ.get(EXEC_CACHE_CAP_ENV, _DEFAULT_CACHE_CAP))
    except ValueError:
        return _DEFAULT_CACHE_CAP
    return max(cap, 1)


class ExecutableCache:
    """Bounded LRU cache of built pipeline executables.

    Key: `(semantic_key(flow), stage order signature, per-source (name,
    schema signature, capacity bucket, runtime order), use_kernels,
    compact_slack, use_order, observe, megakernel routes)`, with
    `use_megakernel` inside the semantic part.  No dispatch mode joins it: one executable
    serves both devices, because each kernel wrapper dispatches on its
    tensors' device when it runs.  `traces` counts builds, so tests can assert
    that warm calls never rebuild.  Capacity defaults to
    `$REPRO_EXEC_CACHE_CAP` (256): adaptive serving deliberately multiplies
    executables (one per calibration regime), so the cache must be a bound,
    not a leak.  Eviction drops the LRU entry and increments `evictions`.
    All map access is mutex-guarded (the multi-tenant engine builds regime
    swaps on a background thread while its pump serves from the same
    cache): two threads missing on one key may both build — one insert
    wins, the duplicate is wasted work, never corruption."""

    def __init__(self, maxsize: Optional[int] = None):
        self.maxsize = maxsize if maxsize is not None else _default_cache_cap()
        self._data: collections.OrderedDict = collections.OrderedDict()
        self._mu = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.traces = 0
        self.evictions = 0

    def get(self, key):
        with self._mu:
            fn = self._data.get(key)
            if fn is None:
                self.misses += 1
                return None
            self._data.move_to_end(key)
            self.hits += 1
            return fn

    def put(self, key, fn) -> None:
        with self._mu:
            self._data[key] = fn
            self._data.move_to_end(key)
            while len(self._data) > self.maxsize:
                self._data.popitem(last=False)
                self.evictions += 1

    def resize(self, maxsize: int) -> None:
        """Shrink/grow the bound, evicting LRU entries as needed."""
        with self._mu:
            self.maxsize = max(int(maxsize), 1)
            while len(self._data) > self.maxsize:
                self._data.popitem(last=False)
                self.evictions += 1

    def count_trace(self) -> None:
        """Count one executable build (a swap thread builds beside the
        serving thread, so the counter shares the map's lock)."""
        with self._mu:
            self.traces += 1

    def stats(self) -> CacheStats:
        with self._mu:
            return CacheStats(hits=self.hits, misses=self.misses,
                              traces=self.traces, size=len(self._data),
                              evictions=self.evictions)

    def clear(self) -> None:
        with self._mu:
            self._data.clear()
            self.hits = self.misses = self.traces = self.evictions = 0


_CACHE = ExecutableCache()


def executable_cache() -> ExecutableCache:
    """The process-wide plan-executable cache."""
    return _CACHE


# megakernel routing is on by default; `REPRO_MEGAKERNEL=0` is the global
# kill switch (the composed per-stage walk everywhere)
MEGAKERNEL_ENV = "REPRO_MEGAKERNEL"

_MISSING = object()  # routes memo sentinel (None is a valid cached value)


def _megakernel_default() -> bool:
    return os.environ.get(MEGAKERNEL_ENV, "1") != "0"


def _schema_sig(schema) -> tuple:
    return (tuple(schema.fields),
            tuple(str(schema.dtype(f)) for f in schema.fields))


# ---------------------------------------------------------------------------
# Adaptive serving configuration (DESIGN.md §9)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    """Knobs of the observe → calibrate → re-plan loop.

    The drift score (`cost.drift_score`) is hysteresis-banded: a check with
    score >= `drift_high` ARMS the trigger, one <= `drift_low` disarms it,
    and scores inside the band hold the armed count — a re-plan fires only
    after `patience` consecutive armed checks, so noisy-but-stationary
    workloads never thrash.  `prior_weight` defaults to 0 because by the
    time a swap fires, the hysteresis run has already statistically
    confirmed the drift — the posterior should trust the observed EWMAs
    outright (and, quantized on the 2^(1/quant) grid, a workload drifting
    BACK reproduces its earlier regime's hints exactly, re-hitting the warm
    executable).  Set it > 0 to blend conservatively toward the compiler
    hints.  `search=False` skips the optimizer re-run on swap and only
    re-lowers the calibrated flow (capacity recalibration without plan
    re-ordering) — cheaper when re-plan latency matters more than plan
    quality."""

    check_every: int = 4       # drift-check cadence, in served batches
    drift_high: float = 1.0    # |log2(observed/priced)| that arms the trigger
    drift_low: float = 0.5     # score that disarms it (hysteresis band)
    patience: int = 2          # consecutive armed checks before a re-plan
    min_drift_rows: float = 8.0  # ignore stages this small (log-ratio noise)
    prior_weight: float = 0.0  # compiler hint's worth in pseudo-batches
    quant: int = 4             # posterior grid: 2^(1/quant) steps
    search: bool = True        # re-optimize on swap (False: re-lower only)
    replan_max_plans: int = 2000  # enumeration budget of the swap search


# ---------------------------------------------------------------------------
# Compiled plan handle
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CompiledPlan:
    """A lowered flow plus the cache that holds its warm executables.

    `run(bindings)` binds RecordBatches onto `device` (padding each source
    to its capacity bucket), fetches-or-builds the executable for the
    resulting shape signature, executes, and returns a RecordBatch.

    `bind_device(bindings)` / `run_device(masked)` split the host round trip
    out of the serving loop: bind once (or bind fresh batches as they
    arrive), keep every masked batch — inputs AND outputs — on device.

    `use_megakernel` (default on unless `REPRO_MEGAKERNEL=0`) routes the
    fusable stage runs of each source signature through megakernel spans;
    `_last_routes` holds the routes of the latest call.

    With `adaptive` set, every executed batch also returns its stage-boundary
    valid-row counts into `stats`, a per-handle `cost.StatsStore`;
    `run`/`run_device` check a hysteresis-banded drift score every
    `check_every` batches and, on sustained drift, re-optimize under
    `cost.calibrate_hints` posteriors and hot-swap the stages.  Calibrated
    hints are part of `semantic_key`, so a swap is a deliberate cache MISS
    into a new regime entry — the old regime's executable stays warm for a
    workload that drifts back — and a batch whose observed rows overran a
    stage's planned capacity is re-executed under the recalibrated plan
    before anything is returned (truncation is repriced, never served).
    """

    flow: Node
    stages: tuple
    use_kernels: bool = False
    compact_slack: float = 2.0
    use_order: bool = True
    use_megakernel: bool = dataclasses.field(
        default_factory=lambda: _megakernel_default())
    cache: ExecutableCache = dataclasses.field(default_factory=executable_cache)
    device: torch.device = dataclasses.field(
        default_factory=lambda: resolve_device("cuda"))
    adaptive: Optional[AdaptiveConfig] = None
    stats: Optional[StatsStore] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._sources = {n.name: n for n in self.flow.iter_nodes()
                         if isinstance(n, Source)}
        # fused and composed lowerings of one flow never share an
        # executable; the capacity-dependent routes join the key too
        self._sem = _Interned((semantic_key(self.flow),
                               _order_sig(self.stages),
                               self.use_megakernel))
        # route planning costs host time on every dispatch: memoized per
        # source capacity signature.  `_install` re-runs this initializer,
        # so a hot-swap plans the new stage list's routes from scratch —
        # which is what keeps a truncation force-swap on the mega route
        self._routes_memo: dict = {}
        self._last_routes: Optional[tuple] = None
        # static per-source schema signatures, computed once: stringifying
        # dtypes per call costs more than a warm serving step
        self._ssig = {name: _schema_sig(src.out_schema)
                      for name, src in self._sources.items()}
        if not hasattr(self, "_base_flow"):  # re-run by _install on swap
            self._base_flow = self.flow
            if self.stats is None:
                self.stats = StatsStore()
            self.swaps = 0
            self._calls = 0
            self._armed = 0
            self._regime_key = _Interned(semantic_key(self._base_flow))
            self._regime_tick = 0

    # -- binding -------------------------------------------------------------
    def _bind(self, bindings: Mapping[str, RecordBatch]):
        """Pad each source batch to its capacity bucket and copy it onto the
        device."""
        masked: dict[str, M.MaskedBatch] = {}
        sig = []
        for name in sorted(self._sources):
            src = self._sources[name]
            if name not in bindings:
                raise KeyError(f"no binding for source {name!r}")
            b = bindings[name].to_numpy().compact().project(
                list(src.out_schema.fields))
            n = b.capacity
            cap = M.bucket_capacity(max(n, 1))
            cols = {}
            for f in b.fields:
                v = np.asarray(b.columns[f])
                if cap != n:
                    pad = np.zeros((cap - n,) + v.shape[1:], dtype=v.dtype)
                    v = np.concatenate([v, pad])
                cols[f] = torch.from_numpy(np.ascontiguousarray(v)).to(
                    self.device)
            valid = torch.from_numpy(np.arange(cap) < n).to(self.device)
            order = M.order_prefix(src.sorted_on or (), b.fields) \
                if self.use_order else ()
            masked[name] = M.MaskedBatch(cols, valid, order)
            sig.append((name, self._ssig[name], cap, order))
        return masked, tuple(sig)

    def bind_device(self, bindings: Mapping[str, RecordBatch]
                    ) -> dict[str, M.MaskedBatch]:
        """Host batches -> device-resident masked batches, ready for
        `run_device`: each source is padded to its geometric
        `bucket_capacity` (so repeat sizes reuse executables), masked to its
        valid rows, and carries the order prefix `Source.sorted_on` declares
        (which the lowered stages' sort elision relies on)."""
        return self._bind(bindings)[0]

    def _masked_sig(self, masked: Mapping[str, M.MaskedBatch]):
        out: dict[str, M.MaskedBatch] = {}
        sig = []
        for name in sorted(self._sources):
            src = self._sources[name]
            if name not in masked:
                raise KeyError(f"no binding for source {name!r}")
            b = masked[name]
            if b.device != self.device:
                raise ValueError(f"source {name!r} is bound on {b.device}, "
                                 f"the plan runs on {self.device}")
            if self.use_order and src.sorted_on and not b.order:
                b = b.with_order(tuple(src.sorted_on))
            out[name] = b
            sig.append((name, self._ssig[name], b.capacity, b.order))
        return out, tuple(sig)

    # -- executable lookup ---------------------------------------------------
    def _routes(self, src_caps: Mapping[str, int]) -> Optional[tuple]:
        """Megakernel route plan for these source capacities (None when
        nothing fuses); deterministic in (stages, capacities)."""
        if not self.use_megakernel or len(self.stages) < 2:
            return None
        key = tuple(sorted(src_caps.items()))
        hit = self._routes_memo.get(key, _MISSING)
        if hit is _MISSING:
            from ..kernels import megakernel as MK

            hit = MK.plan_routes(self.stages, dict(src_caps))
            self._routes_memo[key] = hit
        return hit

    def _executable(self, source_sig: tuple, observe: Optional[bool] = None):
        """The executable of one source signature.  An observing executable
        returns `(out, packed observations, stage caps)`: the observations
        stay on the device until `_read_observations` copies them out, and
        the caps are the capacities each stage compacted to in THAT call
        (the host-side reference for truncation detection)."""
        if observe is None:
            observe = self.adaptive is not None
        routes = self._routes({s[0]: s[2] for s in source_sig})
        self._last_routes = routes
        key = (self._sem, source_sig, self.use_kernels, self.compact_slack,
               self.use_order, observe, routes)
        fn = self.cache.get(key)
        if fn is None:
            self.cache.count_trace()
            stages, use_kernels = self.stages, self.use_kernels
            slack, use_order = self.compact_slack, self.use_order
            # compaction capacities are static per executable: price them
            # at the scale of the bound source capacities, once
            stats_memo = seed_source_stats(
                self.flow, {s[0]: s[2] for s in source_sig}, {})

            def run(mb, obs, caps):
                if not stages:
                    (only,) = mb.values()
                    return only
                return run_stages(stages, mb, use_kernels, slack, stats_memo,
                                  use_order=use_order, observe=obs,
                                  caps=caps, routes=routes)

            if observe:
                def fn(mb):
                    # fresh lists per call: two threads may share one
                    # executable, and `run_stages` appends to what it gets
                    obs, caps = [], []
                    out = run(mb, obs, caps)
                    return out, _pack_observations(mb, obs), tuple(caps)
            else:
                def fn(mb):
                    return run(mb, None, None)

            self.cache.put(key, fn)
        return fn

    # -- observation plumbing (DESIGN.md §9/§11) -----------------------------
    def fold_observation(self, store: StatsStore, counts,
                         caps: Optional[Sequence[int]] = None
                         ) -> Optional[int]:
        """Fold one packed observation vector (as returned by
        `run_device_observed`) into `store`, resolving the `[sources
        (name-sorted), per-stage out counts, per-stage aux]` layout against
        this handle's current stage list.  With `caps` given (the matching
        stage caps), returns the index of the first stage whose observed
        pre-compaction rows overran its planned capacity — the batch just
        executed is silently missing rows past that stage — or None when
        nothing truncated.  No policy runs here: the caller owns the store,
        any drift decision and any truncation repair."""
        counts = np.asarray(counts)
        names = sorted(self._sources)
        ns, nst = len(names), len(self.stages)
        return record_batch_obs(store, self.stages,
                                dict(zip(names, counts[:ns])),
                                counts[ns:ns + nst],
                                counts[ns + nst:ns + 2 * nst], caps=caps)

    # -- adaptive feedback (DESIGN.md §9) ------------------------------------
    def _observe(self, counts, caps) -> bool:
        """Fold one batch's observation vector into `stats`; returns True
        when a stage truncated — in which case the plan has already been
        force-swapped and the caller must re-execute the batch."""
        if self.fold_observation(self.stats, counts, caps=caps) is None:
            return False
        # the planned capacity was overrun: the batch just produced is
        # silently missing rows.  Re-plan NOW with full confidence in the
        # snapped observation (the truncated stage's pre-compaction count is
        # ground truth) and have the caller re-run the batch.
        self._replan(force=True)
        return True

    def _maybe_replan(self) -> None:
        """The per-batch drift check: cheap, amortized over `check_every`
        calls, hysteresis-banded so noise cannot thrash the plan."""
        cfg = self.adaptive
        self._calls += 1
        if self._calls % cfg.check_every:
            return
        score = drift_score(self.flow, self.stats,
                            min_rows=cfg.min_drift_rows,
                            newer_than=self._regime_tick)
        if score >= cfg.drift_high:
            self._armed += 1
        elif score <= cfg.drift_low:
            self._armed = 0
        if self._armed >= cfg.patience:
            self._replan()
            self._armed = 0

    def _replan(self, force: bool = False) -> bool:
        """Calibrate hints from `stats` and, if that lands in a NEW regime
        (different posterior hints — i.e. a different `semantic_key`),
        re-optimize and hot-swap the lowered stages.  Runs only when drift
        is sustained (or a truncation forced it), never per batch.  Returns
        True when a swap was installed.  The search is the port's
        `optimize`, whose group search keeps every reordering's attribute
        set (ROADMAP.md Queue 3 item 1)."""
        cfg = self.adaptive
        calibrated = calibrate_hints(
            self._base_flow, self.stats,
            prior_weight=0.0 if force else cfg.prior_weight,
            quant=cfg.quant)
        sem = _Interned(semantic_key(calibrated))
        if sem == self._regime_key and not force:
            return False  # same quantized regime: the current plan stands
        new_flow, new_stages = calibrated, None
        if cfg.search:
            from .enumeration import PlanSpaceExceeded
            from .optimizer import optimize

            try:
                res = optimize(calibrated, max_plans=cfg.replan_max_plans,
                               include_commutes=False)
                new_flow = res.best.plan.node
                new_stages = lower_phys(res.best.plan)
            except PlanSpaceExceeded:
                pass  # fall back to re-lowering the calibrated flow
        if new_stages is None:
            new_stages = lower(calibrated)
        self._install(new_flow, new_stages, sem)
        return True

    def _install(self, flow: Node, stages: tuple, regime_key) -> None:
        """Hot-swap the handle onto a new plan.  The executable cache is
        untouched: the next call MISSES into the new regime's entry (or hits
        it, if this regime was served before) while previous regimes' warm
        entries remain reusable."""
        self.flow = flow
        self.stages = stages
        self.__post_init__()  # recompute _sources/_sem/_ssig; state kept
        self._regime_key = regime_key
        self._regime_tick = self.stats.clock
        self.swaps += 1

    def _serve_adaptive(self, masked_bindings: Mapping[str, M.MaskedBatch]
                        ) -> M.MaskedBatch:
        """The observing serve step shared by `run` and `run_device`:
        execute, fold the observation in, and on a capacity overrun re-plan
        and re-execute on the SAME bound inputs (nothing donates them, and
        no executor writes into its inputs).  Each force-swap repairs at
        least the first truncating stage, so attempts are bounded by the
        CURRENT plan's stage count (re-read per attempt: a swap may change
        the fusion grouping)."""
        attempts = 0
        while True:
            masked, sig = self._masked_sig(masked_bindings)
            out, packed, caps = self._executable(sig)(masked)
            if not self._observe(_read_observations(packed), caps):
                self._maybe_replan()
                return out
            attempts += 1
            if attempts > len(self.stages) + 2:
                raise RuntimeError(
                    "adaptive re-planning failed to clear a capacity "
                    f"overrun after {attempts} attempts")

    # -- execution -----------------------------------------------------------
    def run(self, bindings: Mapping[str, RecordBatch]) -> RecordBatch:
        """Execute on fresh host batches; warm-cache calls do not rebuild.

        Under `adaptive`, the batch's boundary counts are recorded and a
        batch that overran a planned capacity is transparently re-executed
        under the recalibrated plan."""
        masked, sig = self._bind(bindings)
        if self.adaptive is None:
            return self._executable(sig)(masked).to_record_batch()
        return self._serve_adaptive(masked).to_record_batch()

    def run_device(self, masked_bindings: Mapping[str, M.MaskedBatch]
                   ) -> M.MaskedBatch:
        """Device-resident serving step: masked batches in, masked batch out,
        no host transfer and no re-binding.  Launches are asynchronous — the
        caller chains further device work (or synchronizes when it must
        read).

        Under `adaptive`, the observation read synchronizes each step (the
        price of feedback: one device-to-host copy of the packed counts)."""
        if self.adaptive is None:
            masked, sig = self._masked_sig(masked_bindings)
            return self._executable(sig)(masked)
        return self._serve_adaptive(masked_bindings)

    def run_device_observed(self, masked_bindings: Mapping[str, M.MaskedBatch]
                            ) -> tuple:
        """Device-resident step that also returns the batch's observations:
        `(out, counts, stage_caps)` where `counts` is the packed int64
        vector of per-source valid rows, per-stage pre-compaction rows and
        per-stage KAT/Match aux counts, and `stage_caps` the capacities the
        stages compacted to — feed both to `fold_observation` for recording
        and truncation detection.

        Unlike `adaptive` serving, NO policy runs: the caller owns the
        `StatsStore`, the drift decision and any truncation repair.  This is
        the hook the multi-tenant dataflow engine (`serve.dataflow`,
        DESIGN.md §11) builds its per-tenant feedback on.  Reading the
        counts synchronizes with the device: one device-to-host copy, the
        per-batch price of observation."""
        masked, sig = self._masked_sig(masked_bindings)
        out, packed, caps = self._executable(sig, observe=True)(masked)
        return out, _read_observations(packed), caps

    def run_masked(self, masked_bindings: Mapping[str, M.MaskedBatch]
                   ) -> M.MaskedBatch:
        """Execute on already-masked batches without the executable cache
        (for embedding a compiled flow in a larger program of one's own)."""
        if not self.stages:
            (only,) = masked_bindings.values()
            return only
        masked, _ = self._masked_sig(masked_bindings)
        caps = {n: b.capacity for n, b in masked.items()}
        stats_memo = seed_source_stats(self.flow, caps, {})
        return run_stages(self.stages, masked, self.use_kernels,
                          self.compact_slack, stats_memo,
                          use_order=self.use_order, routes=self._routes(caps))

    def cache_stats(self) -> CacheStats:
        return self.cache.stats()


def compile_plan(flow_or_plan, use_kernels: bool = False,
                 compact_slack: float = 2.0,
                 cache: Optional[ExecutableCache] = None,
                 use_order: bool = True,
                 adaptive: Optional[AdaptiveConfig] = None,
                 stats: Optional[StatsStore] = None,
                 use_megakernel: Optional[bool] = None,
                 device="cuda") -> CompiledPlan:
    """Lower a logical flow — or a `PhysPlan`, whose shipping strategies and
    physical `Props` then thread into the stages — into a `CompiledPlan`
    that runs on `device` ("cuda" by default; raises when there is no CUDA
    device and `device="cpu"` was not asked for).  Pass an `AdaptiveConfig`
    to serve with observed-cardinality feedback and drift-triggered plan
    swaps (DESIGN.md §9); `stats` optionally shares a `StatsStore` across
    handles.  `use_megakernel` (default on; `REPRO_MEGAKERNEL=0` turns it
    off everywhere) routes fusable stage runs through the whole-stage
    megakernel (DESIGN.md §10)."""
    if isinstance(flow_or_plan, PhysPlan):
        flow, stages = flow_or_plan.node, lower_phys(flow_or_plan)
    else:
        flow, stages = flow_or_plan, lower(flow_or_plan)
    if use_megakernel is None:
        use_megakernel = _megakernel_default()
    return CompiledPlan(flow=flow, stages=stages,
                        use_kernels=use_kernels, compact_slack=compact_slack,
                        use_order=use_order, use_megakernel=use_megakernel,
                        cache=cache or _CACHE, device=resolve_device(device),
                        adaptive=adaptive, stats=stats)
