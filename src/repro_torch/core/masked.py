"""Masked executor — flows on the device with static shapes.

Port of `repro.core.masked`.  Stratosphere streams records of dynamic
cardinality; the compiled executor keeps every shape static instead
(DESIGN.md §3.2): every intermediate data set is a `MaskedBatch` —
fixed-capacity columns + a validity mask.  Filters flip mask bits; grouping
uses sort + segment reductions with a static segment count; PK joins use
sorted-search probes.  `compact()` re-packs valid rows to a smaller static
capacity chosen by the optimizer's cardinality estimate.  Capacities are
Python ints fixed before a stage runs, so no stage reads a count back to
the host: a stage is a fixed sequence of device launches.

Order-aware execution (DESIGN.md §8): every `MaskedBatch` carries static
ORDER metadata (`order`: the column prefix its valid rows are sorted on).
Sources propagate `Source.sorted_on`, record-wise operators preserve
whatever the UDF does not write, and a Reduce emits key-ordered output — so
`_exec_reduce`, the PK-probe side of `_exec_match_pk` and `_exec_cogroup`
skip their sorts whenever the input is already ordered.  Compaction is a
prefix-sum pack (cumsum over the mask → monotone positions → gather),
linear apart from a vectorized binary search, and stable by construction,
so it PRESERVES sort order — the property that lets order survive stage
boundaries.

Hot loops (segment reduction, sorted probe) route through the hand-written
CUDA kernels in `repro_torch.kernels` when `use_kernels=True`; on CPU
tensors the kernels' plain torch versions run instead.  The default torch
path (`use_kernels=False`) is the port of the reference's jnp path.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from . import invoke, scans
from .cost import estimate
from .operators import (CoGroupOp, CrossOp, LimitOp, MapOp, MatchOp, Node,
                        ReduceOp, Source)
from .record import (RecordBatch, as_numpy, as_tensor, resolve_device,
                     torch_dtype)
from .reorder import eff_writes
from .udf import TensorSegmentOps


# ---------------------------------------------------------------------------
# Order metadata (static, host-side)
# ---------------------------------------------------------------------------
def order_prefix(order: Sequence[str], fields, writes=frozenset()) -> tuple:
    """Longest prefix of `order` that survives projection to `fields` and is
    not clobbered by `writes`.  Sortedness is lexicographic, so it only
    survives as a PREFIX: once a column is dropped or rewritten, everything
    after it stops meaning anything."""
    out = []
    for k in order:
        if k not in fields or k in writes:
            break
        out.append(k)
    return tuple(out)


def order_covers(order: Sequence[str], key: Sequence[str]) -> bool:
    """Does `order` guarantee rows with equal `key` are contiguous?  True iff
    some prefix of `order` is a permutation of `key` (column names are unique,
    so that prefix has exactly `len(key)` entries)."""
    return (len(key) > 0 and len(order) >= len(key)
            and set(order[:len(key)]) == set(key))


@dataclasses.dataclass
class MaskedBatch:
    """Fixed-capacity struct-of-tensors + validity mask.

    `order` is static metadata: the subsequence of valid rows is
    lexicographically nondecreasing on this column-name prefix.  `()`
    means no known order.  Validity gaps are allowed — order claims nothing
    about invalid slots.  Columns and mask live on one device."""

    columns: dict
    valid: torch.Tensor  # bool[capacity]
    order: tuple = ()

    @property
    def capacity(self) -> int:
        return int(self.valid.shape[0])

    @property
    def device(self) -> torch.device:
        return self.valid.device

    def with_order(self, order: Sequence[str]) -> "MaskedBatch":
        """Same data, annotated with a (caller-guaranteed) sort order."""
        order = order_prefix(order, self.columns.keys())
        if order == self.order:
            return self
        return MaskedBatch(self.columns, self.valid, order)

    @staticmethod
    def from_record_batch(b: RecordBatch, capacity: Optional[int] = None,
                          order: Sequence[str] = (),
                          device="cpu") -> "MaskedBatch":
        b = b.to_numpy().compact()
        n = b.capacity
        cap = capacity or max(n, 1)
        cols = {}
        for f in b.fields:
            v = np.asarray(b.columns[f])
            pad = np.zeros((cap - n,) + v.shape[1:], dtype=v.dtype)
            cols[f] = torch.from_numpy(np.concatenate([v, pad])).to(device)
        valid = torch.from_numpy(np.arange(cap) < n).to(device)
        return MaskedBatch(cols, valid, order_prefix(order, b.fields))

    def to_record_batch(self) -> RecordBatch:
        cols = {k: as_numpy(v) for k, v in self.columns.items()}
        return RecordBatch(cols, as_numpy(self.valid)).compact()

    def compact(self, capacity: int) -> "MaskedBatch":
        """Re-pack valid rows first and truncate/grow to `capacity`.

        Prefix-sum pack (`scans.pack_indices`): `cumsum(valid)` gives each
        output slot's source row (found by monotone vectorized binary
        search), then one gather per column — no comparator sort.  Stable by
        construction (positions are strictly increasing in source order), so
        it PRESERVES `order`; slots past the valid count hold clamped
        garbage under valid=False."""
        src, count = scans.pack_indices(self.valid, capacity)
        cols = {k: v[src] for k, v in self.columns.items()}
        valid = torch.arange(capacity, device=self.device) < count
        return MaskedBatch(cols, valid, self.order)


def _lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """`np.lexsort` for tensors: the permutation sorting by the LAST key
    first, ties broken by the earlier keys, stable — built from chained
    stable sorts, least significant key first."""
    perm = None
    for k in keys:
        if perm is None:
            perm = torch.sort(k, stable=True).indices
        else:
            perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def _argmax_first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True (0 when there is none), like `jnp.argmax`."""
    return torch.argmax(mask.to(torch.int32))


def _compact_perm(valid: torch.Tensor) -> torch.Tensor:
    """The stable valids-first PERMUTATION of all slots (valid rows in
    original order, then invalid rows in original order) — what
    `argsort(~valid, stable=True)` computes, via two prefix sums instead of a
    comparator sort."""
    n = valid.shape[0]
    cv = scans.cumsum(valid)
    ci = scans.cumsum(~valid)
    j = torch.arange(n, dtype=torch.int64, device=valid.device)
    nv = cv[-1]
    pv = torch.searchsorted(cv, j + 1)
    pi = torch.searchsorted(ci, j + 1 - nv)
    return torch.where(j < nv, pv, pi)


def _concat(batches: Sequence[MaskedBatch]) -> MaskedBatch:
    if len(batches) == 1:
        return batches[0]
    fields = batches[0].columns.keys()
    cols = {f: torch.cat([b.columns[f] for b in batches]) for f in fields}
    # interleaving parts destroys any one part's order
    return MaskedBatch(cols, torch.cat([b.valid for b in batches]))


def _mask(where, device) -> torch.Tensor:
    return as_tensor(where, device).to(torch.bool)


def _project(cols: Mapping, schema, n: int, device) -> dict:
    out = {}
    for f in schema.fields:
        v = as_tensor(cols[f], device)
        if v.ndim == 0:
            v = v.expand(n)
        out[f] = v.to(torch_dtype(schema.dtype(f)))
    return out


# ---------------------------------------------------------------------------
# Grouping machinery (static shapes)
# ---------------------------------------------------------------------------
def _shifted_equal(kv: torch.Tensor) -> torch.Tensor:
    """`kv[i] == kv[i-1]`, False at slot 0."""
    same = torch.zeros(kv.shape[0], dtype=torch.bool, device=kv.device)
    same[1:] = kv[1:] == kv[:-1]
    return same


def _segments_contiguous(cols: Mapping, key: Sequence[str], valid):
    """Segment fields for rows already arranged valids-first and key-sorted
    (the post-`_sort_by_key` layout): adjacent-slot key compares suffice."""
    cap = valid.shape[0]
    same = torch.ones(cap, dtype=torch.bool, device=valid.device)
    for k in key:
        same = same & _shifted_equal(cols[k])
    prev_valid = torch.zeros_like(valid)
    prev_valid[1:] = valid[:-1]
    is_start = valid & (~same | ~prev_valid)
    seg = torch.clamp(scans.cumsum(is_start) - 1, min=0)
    return seg, is_start


def _segments_gappy(cols: Mapping, key: Sequence[str], valid):
    """Segment fields for key-ordered rows with validity GAPS: each valid row
    compares against the previous VALID row's key (a forward fill finds
    it), so interspersed invalid slots neither split nor merge groups.
    Returned `seg` is nondecreasing over ALL slots (invalid slots inherit
    the previous group), as the segment-scan kernels require."""
    cap = valid.shape[0]
    idx = torch.arange(cap, dtype=torch.int64, device=valid.device)
    pvi = scans.fill_forward(idx, valid, -1)
    prev = torch.full_like(pvi, -1)
    prev[1:] = pvi[:-1]
    pidx = torch.clamp(prev, min=0)
    differs = prev < 0
    for k in key:
        kv = cols[k]
        differs = differs | (kv != kv[pidx])
    is_start = valid & differs
    seg = torch.clamp(scans.cumsum(is_start) - 1, min=0)
    return seg, is_start


def _sort_by_key(b: MaskedBatch, key: Sequence[str]):
    """Valid rows first, ordered by composite key.  Returns (sorted batch,
    segment_ids, is_start).  Single-key inputs sort one sentinel code (a
    cheaper single-operand stable sort; the gap-tolerant segmentation makes
    a sentinel collision with a genuine max-value key harmless)."""
    if len(key) == 1:
        kv = b.columns[key[0]]
        big = (torch.finfo(kv.dtype).max if kv.dtype.is_floating_point
               else torch.iinfo(kv.dtype).max)
        code = torch.where(b.valid, kv, big)
        order = torch.sort(code, stable=True).indices
        cols = {f: v[order] for f, v in b.columns.items()}
        valid = b.valid[order]
        seg, is_start = _segments_gappy(cols, key, valid)
        return MaskedBatch(cols, valid, tuple(key)), seg, is_start
    keys = [b.columns[k] for k in key]
    order = _lexsort(list(reversed(keys)) + [~b.valid])
    cols = {f: v[order] for f, v in b.columns.items()}
    valid = b.valid[order]
    seg, is_start = _segments_contiguous(cols, key, valid)
    return MaskedBatch(cols, valid, tuple(key)), seg, is_start


def planned_capacity(node: Node, stats_memo: dict, slack: float,
                     scale: float = 1.0, shards: int = 1) -> int:
    """Bucketed compaction capacity for `node`'s output under the current
    cardinality estimate (`estimate * slack * scale / shards`, floored at 8).
    `shards` doubles as the estimator's degree of parallelism so a combiner's
    per-shard capacity covers the worst case of every group present on every
    worker.  Exposed separately from `compact_to_estimate` so the observing
    pipeline can record the capacity each stage was priced at — the
    reference point for runtime truncation detection (DESIGN.md §9)."""
    est = estimate(node, stats_memo, dop=shards).rows / shards * scale
    # variance guard: actual cardinalities fluctuate ~Poisson around the
    # estimate, so the multiplicative slack alone under-provisions SMALL
    # estimates (std/mean ~ 1/sqrt(est)).  Taking the max of the two terms
    # (rather than stacking them) keeps worst-case-bound estimates like the
    # combiner's `groups * dop` from being inflated past their bound.
    rows = max(est * slack, est + 4.0 * np.sqrt(max(est, 0.0)))
    return int(max(bucket_capacity(rows), 8))


def compact_to_estimate(b: "MaskedBatch", node: Node, stats_memo: dict,
                        slack: float, scale: float = 1.0,
                        shards: int = 1) -> "MaskedBatch":
    """Compact `b` to `planned_capacity` — the single compaction policy
    shared by the per-op masked walk, the compiled pipeline and the
    distributed per-shard body."""
    cap = min(b.capacity, planned_capacity(node, stats_memo, slack, scale,
                                           shards))
    return b.compact(cap) if cap < b.capacity else b


def cardinality_scale(root: Node, bindings: Mapping[str, "MaskedBatch"]) -> float:
    """Upward correction for cost-model row estimates when bound batches
    exceed a Source's declared `num_records`.  Capacities are static, so the
    factor is a host-side constant too; it never scales below 1 — estimates
    generous relative to the actual data are already bounded by
    `min(b.capacity, ...)` at every compaction site."""
    s = 1.0
    for node in root.iter_nodes():
        if isinstance(node, Source) and node.name in bindings:
            s = max(s, bindings[node.name].capacity
                    / max(node.num_records, 1))
    return s


def segment_reduce_backend(use_kernels: bool):
    if not use_kernels:
        return TensorSegmentOps
    from ..kernels import ops as kops

    return kops.KernelSegmentOps


def _probe(rcode: torch.Tensor, lcode: torch.Tensor, first_valid, hi: int,
           use_kernels: bool) -> torch.Tensor:
    """Leftmost insertion positions of `lcode` in the ascending `rcode`,
    raised to `first_valid` (when given) and clamped into [0, hi]: one
    kernel launch under `use_kernels`."""
    if use_kernels:
        from ..kernels import ops as kops

        return kops.probe_positions(rcode, lcode, first_valid, hi)
    pos = torch.searchsorted(rcode, lcode)
    if first_valid is not None:
        pos = torch.maximum(pos, first_valid)
    return torch.clamp(pos, 0, hi)


def _low(dtype: torch.dtype):
    return -float("inf") if dtype.is_floating_point else torch.iinfo(dtype).min


# ---------------------------------------------------------------------------
# Per-operator execution
# ---------------------------------------------------------------------------
def _exec_map(op: MapOp, b: MaskedBatch) -> MaskedBatch:
    col = invoke.run_map_udf(op.udf, dict(b.columns))
    out_order = order_prefix(b.order, op.out_schema.fields, eff_writes(op))
    dev = b.device
    parts = []
    for em in col.emissions:
        if em.builder is None:
            continue
        cols = _project(em.builder.columns(), op.out_schema, b.capacity, dev)
        valid = b.valid
        if em.where is not None:
            valid = valid & _mask(em.where, dev)
        # emissions are slot-aligned with the input, so a where-mask only
        # opens validity gaps — the valid subsequence stays ordered
        parts.append(MaskedBatch(cols, valid, out_order))
    if not parts:
        return MaskedBatch(
            {f: torch.zeros(1, dtype=torch_dtype(op.out_schema.dtype(f)),
                            device=dev)
             for f in op.out_schema.fields},
            torch.zeros(1, dtype=torch.bool, device=dev))
    return _concat(parts)


def _exec_reduce(op: ReduceOp, b: MaskedBatch, use_kernels: bool,
                 use_order: bool = True, obs: Optional[dict] = None,
                 contiguous: bool = False) -> MaskedBatch:
    """`obs`, when given, receives the observed group count under key
    "groups" (the stage-boundary statistic of the adaptive loop, DESIGN.md
    §9); it is the count the group mask needs anyway.

    `contiguous` asserts the caller just PACKED `b` (valid rows form a
    prefix: a megakernel span's interior compaction, DESIGN.md §10).  When
    the order also covers the key, segmentation then compares adjacent
    slots (`_segments_contiguous`, on the card the `span_segment` kernel)
    instead of the gap-tolerant walk.  On a valids-first batch both give
    identical `(seg, is_start)` — the previous valid row IS the adjacent
    slot — so results are bit-identical."""
    key = tuple(op.key)
    ngroups = None
    if use_order and order_covers(b.order, key):
        # input already groups equal keys contiguously: segment directly over
        # the (possibly gappy) slots, no sort, no repack
        sb = b
        if contiguous:
            from ..kernels import ops as kops

            seg, is_start, ngroups = kops.span_segment(
                [b.columns[k] for k in key], b.valid)
        else:
            seg, is_start = _segments_gappy(b.columns, key, b.valid)
        base_order = b.order
    else:
        sb, seg, is_start = _sort_by_key(b, key)
        base_order = key
    nseg = b.capacity  # worst case: every valid row its own group
    dev = b.device
    segcls = segment_reduce_backend(use_kernels)
    segops = segcls(seg, nseg, record_valid=sb.valid, is_start=is_start)
    col = invoke.run_kat_udf(op.udf, dict(sb.columns), segops, op.key)
    if ngroups is None:
        ngroups = is_start.sum()
    if obs is not None:
        obs["groups"] = ngroups
    group_valid = torch.arange(nseg, device=dev) < ngroups
    w = eff_writes(op)

    parts = []
    for em in col.emissions:
        if em.records:
            cols = (em.builder.columns() if em.builder is not None
                    else dict(sb.columns))
            valid = sb.valid
            if em.group_where is not None:
                valid = valid & _mask(em.group_where, dev)[seg]
            parts.append(MaskedBatch(
                _project(cols, op.out_schema, b.capacity, dev), valid,
                order_prefix(base_order, op.out_schema.fields, w)))
        else:
            cols = em.builder.columns()
            valid = group_valid
            if em.where is not None:
                valid = valid & _mask(em.where, dev)
            # one slot per segment; segments were numbered in key order
            parts.append(MaskedBatch(
                _project(cols, op.out_schema, nseg, dev), valid,
                order_prefix(tuple(base_order)[:len(key)],
                             op.out_schema.fields, w)))
    return _concat(parts)


def _match_codes(op: MatchOp, lb: MaskedBatch, rb: MaskedBatch):
    """Collision-free comparable key codes for a Match: one code per row such
    that `lcode[i] == rcode[j]` iff the composite keys are equal, and codes
    sort in key order.  Single-column keys ARE their own code (after dtype
    promotion); composite keys get dense joint ranks from one shared sort
    over both sides."""
    if len(op.left_key) == 1:
        lc = lb.columns[op.left_key[0]]
        rc = rb.columns[op.right_key[0]]
        ct = torch.promote_types(lc.dtype, rc.dtype)
        return lc.to(ct), rc.to(ct)
    nl = lb.capacity
    ks = []
    for a, b_ in zip(op.left_key, op.right_key):
        la, ra = lb.columns[a], rb.columns[b_]
        ct = torch.promote_types(la.dtype, ra.dtype)
        ks.append(torch.cat([la.to(ct), ra.to(ct)]))
    n = ks[0].shape[0]
    order = _lexsort(list(reversed(ks)))
    is_new = torch.zeros(n, dtype=torch.bool, device=lb.device)
    is_new[0] = True
    for k in ks:
        is_new = is_new | ~_shifted_equal(k[order])
    ranks_sorted = scans.cumsum(is_new) - 1
    rank = torch.empty_like(ranks_sorted)
    rank[order] = ranks_sorted
    return rank[:nl], rank[nl:]


def _probe_side(op: MatchOp, rb: MaskedBatch, rcode_raw: torch.Tensor,
                use_order: bool):
    """The probed (right) side as an ascending code array: `(rcode,
    first_valid, perm, rvalid)`.  When the side is already ordered on a
    single-column key its valid codes are nondecreasing in slot order, so
    validity gaps are forward-filled with the previous valid code and no
    per-batch sort runs; a fill slot repeats the code of a valid slot BEFORE
    it, so a left search lands on the valid occurrence — except in the
    leading all-invalid run, whose low fill can equal a genuine minimal key;
    clamping positions to `first_valid` restores the invariant.  Otherwise
    the side is sorted by (code, valid-first): equal-code invalid rows land
    AFTER the valid ones, so a left search still finds the valid row."""
    if use_order and len(op.right_key) == 1 \
            and tuple(rb.order[:1]) == tuple(op.right_key):
        rcode = scans.fill_forward(rcode_raw, rb.valid, _low(rcode_raw.dtype))
        return rcode, _argmax_first(rb.valid), None, rb.valid
    order = _lexsort([~rb.valid, rcode_raw])
    return rcode_raw[order], None, order, rb.valid[order]


def _exec_match_pk(op: MatchOp, lb: MaskedBatch, rb: MaskedBatch,
                   use_kernels: bool, use_order: bool = True,
                   obs: Optional[dict] = None) -> MaskedBatch:
    """Equi-join where the right side is unique on its key (PK side): each
    left row matches at most one right row — sorted-search probe."""
    lcode, rcode_raw = _match_codes(op, lb, rb)
    rcode, first_valid, order, rvalid = _probe_side(op, rb, rcode_raw,
                                                    use_order)
    rcols = rb.columns if order is None \
        else {f: v[order] for f, v in rb.columns.items()}
    pos = _probe(rcode, lcode, first_valid, rb.capacity - 1, use_kernels)
    hit = (rcode[pos] == lcode) & lb.valid & rvalid[pos]
    if obs is not None:  # observed probe hits (join-fanout feedback)
        obs["groups"] = hit.sum()

    gathered = {f: v[pos] for f, v in rcols.items()}
    col = invoke.run_pair_udf(op.udf, dict(lb.columns), gathered)
    out_order = order_prefix(lb.order, op.out_schema.fields, eff_writes(op))
    dev = lb.device
    parts = []
    for em in col.emissions:
        if em.builder is None:
            continue
        valid = hit
        if em.where is not None:
            valid = valid & _mask(em.where, dev)
        # output is slot-aligned with the LEFT input (each left row matches
        # at most one PK row), so the left side's order survives
        parts.append(MaskedBatch(
            _project(em.builder.columns(), op.out_schema, lb.capacity, dev),
            valid, out_order))
    return _concat(parts)


def _exec_match_anti(op: MatchOp, lb: MaskedBatch, rb: MaskedBatch,
                     use_kernels: bool, use_order: bool = True,
                     obs: Optional[dict] = None) -> MaskedBatch:
    """Left anti join: keep exactly the LEFT rows whose key has NO valid
    partner on the right.  No UDF runs; the output is a slot-aligned mask
    over the left input, so the left side's order survives.  The presence
    probe is the `_exec_match_pk` sorted search (duplicates on the right are
    harmless — any valid occurrence of the code marks presence)."""
    lcode, rcode_raw = _match_codes(op, lb, rb)
    rcode, first_valid, _, rvalid = _probe_side(op, rb, rcode_raw, use_order)
    pos = _probe(rcode, lcode, first_valid, rb.capacity - 1, use_kernels)
    present = (rcode[pos] == lcode) & rvalid[pos]
    keep = lb.valid & ~present
    if obs is not None:  # observed survivors (selectivity feedback)
        obs["groups"] = keep.sum()
    return MaskedBatch(dict(lb.columns), keep, lb.order)


def _exec_limit(op: LimitOp, b: MaskedBatch,
                use_order: bool = True) -> MaskedBatch:
    """WITH-TIES top-k: keep every valid row whose key is lexicographically
    <= the k-th smallest valid key.  The result is a slot-aligned mask —
    input order survives — and when the input order already covers the key,
    the threshold row is found with a prefix sum instead of a sort."""
    keys = [b.columns[k] for k in op.key]
    nv = b.valid.sum()
    kth = torch.clamp(torch.clamp(nv, max=op.k) - 1, 0, b.capacity - 1)
    if use_order and order_covers(b.order, op.key):
        # valid rows are already key-sorted in slot order: the k-th smallest
        # key sits at the slot where cumsum(valid) first reaches k
        cum = scans.cumsum(b.valid)
        pos = torch.clamp(torch.searchsorted(cum, (kth + 1).reshape(1))[0],
                          0, b.capacity - 1)
    else:
        perm = _lexsort(list(reversed(keys)) + [~b.valid])
        pos = perm[kth]
    # lexicographic key <= threshold key (empty input: valid is all-False
    # anyway, so the garbage threshold never leaks a row)
    le = keys[-1] <= keys[-1][pos]
    for k in reversed(keys[:-1]):
        t = k[pos]
        le = (k < t) | ((k == t) & le)
    return MaskedBatch(dict(b.columns), b.valid & le, b.order)


def _exec_cross(op, lb: MaskedBatch, rb: MaskedBatch,
                left_key=(), right_key=()) -> MaskedBatch:
    """Full pairwise product (also used for small general equi-joins)."""
    nl, nr = lb.capacity, rb.capacity
    dev = lb.device
    li = torch.arange(nl, device=dev).repeat_interleave(nr)
    ri = torch.arange(nr, device=dev).repeat(nl)
    lcols = {f: v[li] for f, v in lb.columns.items()}
    rcols = {f: v[ri] for f, v in rb.columns.items()}
    valid = lb.valid[li] & rb.valid[ri]
    for lk, rk in zip(left_key, right_key):
        valid = valid & (lcols[lk] == rcols[rk])
    col = invoke.run_pair_udf(op.udf, lcols, rcols)
    parts = []
    for em in col.emissions:
        if em.builder is None:
            continue
        v = valid
        if em.where is not None:
            v = v & _mask(em.where, dev)
        parts.append(MaskedBatch(
            _project(em.builder.columns(), op.out_schema, nl * nr, dev), v))
    return _concat(parts)


def _exec_cogroup(op: CoGroupOp, lb: MaskedBatch, rb: MaskedBatch,
                  use_kernels: bool, use_order: bool = True,
                  obs: Optional[dict] = None) -> MaskedBatch:
    """Align both sides on the union key domain with static shapes."""
    nl, nr = lb.capacity, rb.capacity
    dev = lb.device
    # joint sort of all keys to build dense codes over the union domain
    allkeys = [torch.cat([lb.columns[a], rb.columns[b_]])
               for a, b_ in zip(op.left_key, op.right_key)]
    allvalid = torch.cat([lb.valid, rb.valid])
    order = _lexsort(list(reversed(allkeys)) + [~allvalid])
    sorted_valid = allvalid[order]
    same = torch.ones(nl + nr, dtype=torch.bool, device=dev)
    for k in allkeys:
        same = same & _shifted_equal(k[order])
    prev_valid = torch.zeros_like(sorted_valid)
    prev_valid[1:] = sorted_valid[:-1]
    is_start = sorted_valid & (~same | ~prev_valid)
    seg_sorted = torch.clamp(scans.cumsum(is_start) - 1, min=0)
    seg_all = torch.empty_like(seg_sorted)
    seg_all[order] = seg_sorted  # inverse permutation
    lseg, rseg = seg_all[:nl], seg_all[nl:]
    nseg = nl + nr
    ngroups = is_start.sum()
    if obs is not None:
        obs["groups"] = ngroups
    group_valid = torch.arange(nseg, device=dev) < ngroups

    # Per-side segment-sorted order (first()/group scans need contiguity).
    # A side ordered EXACTLY on its key degenerates its segment sort to the
    # stable valids-first permutation — two prefix sums instead of a sort.
    def side_perm(b_, key, seg):
        if use_order and tuple(b_.order[:len(key)]) == tuple(key):
            return _compact_perm(b_.valid)
        return _lexsort([~b_.valid, seg])

    lord = side_perm(lb, op.left_key, lseg)
    rord = side_perm(rb, op.right_key, rseg)
    lcols = {f: v[lord] for f, v in lb.columns.items()}
    rcols = {f: v[rord] for f, v in rb.columns.items()}
    lseg, rseg = lseg[lord], rseg[rord]
    lvalid, rvalid = lb.valid[lord], rb.valid[rord]

    segcls = segment_reduce_backend(use_kernels)
    lops = segcls(lseg, nseg, record_valid=lvalid)
    rops = segcls(rseg, nseg, record_valid=rvalid)
    col = invoke.run_cogroup_udf(op.udf, lcols, lops, rcols, rops,
                                 op.left_key, op.right_key)
    parts = []
    for em in col.emissions:
        if em.records:
            raise NotImplementedError("CoGroup passthrough in the masked "
                                      "executor")
        valid = group_valid
        if em.where is not None:
            valid = valid & _mask(em.where, dev)
        parts.append(MaskedBatch(
            _project(em.builder.columns(), op.out_schema, nseg, dev), valid))
    return _concat(parts)


# ---------------------------------------------------------------------------
# Flow execution
# ---------------------------------------------------------------------------
def execute_masked(root: Node, bindings: Mapping[str, MaskedBatch],
                   use_kernels: bool = False,
                   compact_slack: float = 2.0,
                   compact: bool = True,
                   use_order: bool = True) -> MaskedBatch:
    """Execute `root` on masked batches (every tensor on one device).

    `compact=True` re-packs intermediates to `estimate(node) * slack`
    capacity (static — derived from the cost model before the stage runs,
    rounded up to a geometric `bucket_capacity` so repeat batches share
    shapes),
    bounding memory exactly the way the paper's optimizer uses cardinality
    hints.  When the bound batches are LARGER than the flow's nominal
    `Source.num_records`, estimates are scaled up proportionally —
    compaction must never drop valid rows just because the request outgrew
    the scale the flow was declared at.

    `use_order=True` honors `Source.sorted_on` at execution time and lets
    key-ordered intermediates skip their sorts (DESIGN.md §8); order
    metadata is still PROPAGATED either way, only elision is gated.
    """
    stats_memo: dict = {}
    memo: dict[int, MaskedBatch] = {}
    scale = cardinality_scale(root, bindings)

    def maybe_compact(node: Node, b: MaskedBatch) -> MaskedBatch:
        if not compact:
            return b
        return compact_to_estimate(b, node, stats_memo, compact_slack, scale)

    def run(node: Node) -> MaskedBatch:
        if id(node) in memo:
            return memo[id(node)]
        if isinstance(node, Source):
            out = bindings[node.name]
            if use_order and node.sorted_on and not out.order:
                out = out.with_order(tuple(node.sorted_on))
        elif isinstance(node, MapOp):
            out = _exec_map(node, run(node.child))
        elif isinstance(node, ReduceOp):
            out = _exec_reduce(node, run(node.child), use_kernels, use_order)
        elif isinstance(node, LimitOp):
            out = _exec_limit(node, run(node.child), use_order)
        elif isinstance(node, MatchOp):
            lb, rb = run(node.left), run(node.right)
            if node.anti:
                out = _exec_match_anti(node, lb, rb, use_kernels, use_order)
            elif node.hints.pk_side == "right":
                out = _exec_match_pk(node, lb, rb, use_kernels, use_order)
            elif node.hints.pk_side == "left":
                from .reorder import commute as _commute

                flipped = _commute(node)
                out = _exec_match_pk(flipped, rb, lb, use_kernels, use_order)
            else:
                out = _exec_cross(node, lb, rb, node.left_key, node.right_key)
        elif isinstance(node, CrossOp):
            out = _exec_cross(node, run(node.left), run(node.right))
        elif isinstance(node, CoGroupOp):
            out = _exec_cogroup(node, run(node.left), run(node.right),
                                use_kernels, use_order)
        else:
            raise TypeError(type(node).__name__)
        out = maybe_compact(node, out)
        memo[id(node)] = out
        return out

    return run(root)


def _round8(x: float) -> int:
    return int(np.ceil(max(x, 1.0) / 8.0) * 8)


def bucket_capacity(x: float) -> int:
    """Geometric capacity bucket: the smallest 8·2^k >= x.

    Every static capacity a run sees (source padding, intermediate
    compaction) is drawn from this ladder, so a flow of n operators with n
    distinct cardinality estimates builds O(log n) distinct shapes instead of
    O(n) — the executable-cache analogue of the paper's spill-buffer size
    classes.
    """
    n8 = _round8(x) // 8
    return 8 * (1 << (n8 - 1).bit_length())


def run_flow_masked(root: Node, bindings: Mapping[str, RecordBatch],
                    capacities: Optional[Mapping[str, int]] = None,
                    use_kernels: bool = False,
                    use_order: bool = True, device="cuda") -> RecordBatch:
    """Convenience: bind numpy batches onto `device`, execute, return a
    RecordBatch (port of `repro.core.masked.run_flow_jit`)."""
    caps = capacities or {}
    device = resolve_device(device)
    masked = {name: MaskedBatch.from_record_batch(b, caps.get(name),
                                                  device=device)
              for name, b in bindings.items()}
    return execute_masked(root, masked, use_kernels=use_kernels,
                          use_order=use_order).to_record_batch()
