"""Eager host executor — numpy semantics, dynamic shapes.

Executes a PACT flow bottom-up against bound source batches.  This is the
reference semantics for the whole system: the masked executor and the CUDA
kernels are tested for multiset-equality (`RecordBatch.equivalent`) against
this path.  Port of `repro.core.executor`: columns stay numpy; UDFs are
handed zero-copy CPU tensor views of them.

Physical choices here are fixed (sort-based grouping, sort-probe join);
the *optimizer* explores logical reorderings and prices physical strategies,
but the eager executor's answer must be invariant under all of them — that is
exactly the paper's safety property.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np

from . import invoke
from .operators import (CoGroupOp, CrossOp, LimitOp, MapOp, MatchOp, Node,
                        ReduceOp, Source)
from .record import RecordBatch, Schema, as_numpy, cpu_tensor
from .udf import DomainSegmentOps

_MAX_PAIRS = 50_000_000  # guard against accidental quadratic blow-ups


# ---------------------------------------------------------------------------
# Key factorization (shared with the join/grouping paths)
# ---------------------------------------------------------------------------
def joint_codes(column_groups: list[list[np.ndarray]]) -> tuple[list[np.ndarray], int]:
    """Dense int codes for composite keys, computed JOINTLY across several
    aligned column groups (e.g. the left and right key columns of a join) so
    equal keys get equal codes on both sides.

    `column_groups[i]` is the list of key columns of group i (all groups have
    the same arity).  Returns per-group code arrays + the domain size.
    """
    arity = len(column_groups[0])
    # 0-d (scalar) key columns count as one record — np.shape()[0] would
    # raise on them, so normalize every column up front
    column_groups = [[np.atleast_1d(np.asarray(c)) for c in g]
                     for g in column_groups]
    lens = [int(g[0].shape[0]) for g in column_groups]
    combined_code: Optional[np.ndarray] = None
    for j in range(arity):
        stacked = np.concatenate([g[j] for g in column_groups])
        _, inv = np.unique(stacked, return_inverse=True)
        k = int(inv.max()) + 1 if inv.size else 1
        combined_code = inv if combined_code is None else combined_code * k + inv
    if combined_code is None:
        combined_code = np.zeros(sum(lens), dtype=np.int64)
    uniq, dense = np.unique(combined_code, return_inverse=True)
    out, ofs = [], 0
    for n in lens:
        out.append(dense[ofs:ofs + n].astype(np.int64))
        ofs += n
    return out, int(len(uniq))


def _tensors(cols: Mapping[str, np.ndarray]) -> dict:
    """Numpy columns as the CPU tensors a UDF sees (zero-copy)."""
    return {f: cpu_tensor(v) for f, v in cols.items()}


def _project_to_schema(cols: Mapping[str, np.ndarray], schema: Schema,
                       n: int) -> dict:
    out = {}
    for f in schema.fields:
        if f not in cols:
            raise KeyError(f"emission missing attribute {f!r} required by schema")
        v = as_numpy(cols[f])
        if v.ndim == 0:
            v = np.broadcast_to(v, (n,)).copy()
        out[f] = v.astype(schema.dtype(f), copy=False)
    return out


def _empty_batch(schema: Schema) -> RecordBatch:
    return RecordBatch({f: np.empty(0, dtype=schema.dtype(f)) for f in schema.fields})


def _emit_batches(emissions, schema: Schema, n_rows_fn) -> RecordBatch:
    """Assemble emission list into one batch projected onto `schema`."""
    parts = []
    for cols, mask in emissions:
        n = n_rows_fn(cols)
        proj = _project_to_schema(cols, schema, n)
        b = RecordBatch(proj) if n else _empty_batch(schema)
        if mask is not None and n:
            b = RecordBatch(proj, as_numpy(mask).astype(bool)).compact()
        parts.append(b)
    if not parts:
        return _empty_batch(schema)
    return RecordBatch.concat_rows(parts)


def _first_len(cols: Mapping[str, np.ndarray]) -> int:
    for v in cols.values():
        a = as_numpy(v)
        if a.ndim > 0:
            return int(a.shape[0])
    return 1


# ---------------------------------------------------------------------------
# Per-operator execution
# ---------------------------------------------------------------------------
def _exec_map(op: MapOp, child: RecordBatch) -> RecordBatch:
    b = child.to_numpy().compact()
    if b.capacity == 0:
        return _empty_batch(op.out_schema)
    col = invoke.run_map_udf(op.udf, _tensors(b.columns))
    ems = [(em.builder.columns(), em.where) for em in col.emissions
           if em.builder is not None]
    return _emit_batches(ems, op.out_schema, lambda c: b.capacity)


def _sorted_by_key(b: RecordBatch, key: tuple) -> tuple[dict, np.ndarray, int]:
    codes_list, num = joint_codes([[b[k] for k in key]])
    codes = codes_list[0]
    order = np.argsort(codes, kind="stable")
    cols = {f: np.asarray(b[f])[order] for f in b.fields}
    return cols, codes[order], num


def _exec_reduce(op: ReduceOp, child: RecordBatch) -> RecordBatch:
    b = child.to_numpy().compact()
    if b.capacity == 0:
        return _empty_batch(op.out_schema)
    cols, sorted_codes, num = _sorted_by_key(b, op.key)
    segops = DomainSegmentOps(sorted_codes, num)
    col = invoke.run_kat_udf(op.udf, _tensors(cols), segops, op.key)

    ems = []
    for em in col.emissions:
        if em.records:  # passthrough: per-record columns, per-group mask
            rec_cols = em.builder.columns() if em.builder is not None else cols
            mask = None
            if em.group_where is not None:
                mask = as_numpy(em.group_where)[sorted_codes]
            ems.append((rec_cols, mask))
        else:  # per-group emission: columns are per-group arrays
            ems.append((em.builder.columns(), em.where))
    return _emit_batches(ems, op.out_schema, _first_len)


def _join_pairs(lb: RecordBatch, rb: RecordBatch, left_key: tuple,
                right_key: tuple) -> tuple[np.ndarray, np.ndarray]:
    """Indices (li, ri) of every equi-join pair — vectorized sort-probe."""
    (lc, rc), _ = joint_codes([[lb[k] for k in left_key],
                               [rb[k] for k in right_key]])
    order_r = np.argsort(rc, kind="stable")
    rc_sorted = rc[order_r]
    lo = np.searchsorted(rc_sorted, lc, side="left")
    hi = np.searchsorted(rc_sorted, lc, side="right")
    counts = hi - lo
    total = int(counts.sum())
    if total > _MAX_PAIRS:
        raise MemoryError(f"join would produce {total} pairs")
    li = np.repeat(np.arange(len(lc)), counts)
    cum = np.cumsum(counts) - counts
    off = np.arange(total) - np.repeat(cum, counts)
    ri = order_r[np.repeat(lo, counts) + off]
    return li, ri


def _exec_pairwise(op, lb: RecordBatch, rb: RecordBatch, li, ri) -> RecordBatch:
    if len(li) == 0:
        return _empty_batch(op.out_schema)
    lcols = {f: np.asarray(lb[f])[li] for f in lb.fields}
    rcols = {f: np.asarray(rb[f])[ri] for f in rb.fields}
    col = invoke.run_pair_udf(op.udf, _tensors(lcols), _tensors(rcols))
    ems = [(em.builder.columns(), em.where) for em in col.emissions
           if em.builder is not None]
    return _emit_batches(ems, op.out_schema, lambda c: len(li))


def _exec_match(op: MatchOp, left: RecordBatch, right: RecordBatch) -> RecordBatch:
    lb, rb = left.to_numpy().compact(), right.to_numpy().compact()
    if op.anti:
        return _exec_match_anti(op, lb, rb)
    if lb.capacity == 0 or rb.capacity == 0:
        return _empty_batch(op.out_schema)
    li, ri = _join_pairs(lb, rb, op.left_key, op.right_key)
    return _exec_pairwise(op, lb, rb, li, ri)


def _exec_match_anti(op: MatchOp, lb: RecordBatch, rb: RecordBatch) -> RecordBatch:
    """Left anti join: left rows with zero key partners on the right.  No UDF
    runs — survivors are the left records verbatim, in input order."""
    if lb.capacity == 0:
        return _empty_batch(op.out_schema)
    (lc, rc), _ = joint_codes([[lb[k] for k in op.left_key],
                               [rb[k] for k in op.right_key]])
    rc_sorted = np.sort(rc)
    lo = np.searchsorted(rc_sorted, lc, side="left")
    hi = np.searchsorted(rc_sorted, lc, side="right")
    keep = (hi - lo) == 0
    cols = {f: np.asarray(lb[f])[keep] for f in lb.fields}
    n = int(keep.sum())
    return RecordBatch(_project_to_schema(cols, op.out_schema, n)) if n \
        else _empty_batch(op.out_schema)


def _exec_limit(op: LimitOp, child: RecordBatch) -> RecordBatch:
    """WITH-TIES top-k by ascending key: every row whose key is
    lexicographically <= the k-th smallest — a multiset function of the
    input, matching the masked executor bit-for-bit."""
    b = child.to_numpy().compact()
    n = b.capacity
    if n == 0:
        return _empty_batch(op.out_schema)
    keys = [np.asarray(b[k]) for k in op.key]
    order = np.lexsort(tuple(reversed(keys)))
    kth = order[min(op.k, n) - 1]
    keep = keys[-1] <= keys[-1][kth]
    for kcol in reversed(keys[:-1]):
        t = kcol[kth]
        keep = (kcol < t) | ((kcol == t) & keep)
    cols = {f: np.asarray(b[f])[keep] for f in b.fields}
    m = int(keep.sum())
    return RecordBatch(_project_to_schema(cols, op.out_schema, m))


def _exec_cross(op: CrossOp, left: RecordBatch, right: RecordBatch) -> RecordBatch:
    lb, rb = left.to_numpy().compact(), right.to_numpy().compact()
    nl, nr = lb.capacity, rb.capacity
    if nl * nr == 0:
        return _empty_batch(op.out_schema)
    if nl * nr > _MAX_PAIRS:
        raise MemoryError(f"cross would produce {nl * nr} pairs")
    li = np.repeat(np.arange(nl), nr)
    ri = np.tile(np.arange(nr), nl)
    return _exec_pairwise(op, lb, rb, li, ri)


def _exec_cogroup(op: CoGroupOp, left: RecordBatch, right: RecordBatch) -> RecordBatch:
    lb, rb = left.to_numpy().compact(), right.to_numpy().compact()
    (lcodes, rcodes), num = joint_codes([[lb[k] for k in op.left_key],
                                         [rb[k] for k in op.right_key]])
    lorder = np.argsort(lcodes, kind="stable")
    rorder = np.argsort(rcodes, kind="stable")
    lcols = {f: np.asarray(lb[f])[lorder] for f in lb.fields}
    rcols = {f: np.asarray(rb[f])[rorder] for f in rb.fields}
    lseg = DomainSegmentOps(lcodes[lorder], num)
    rseg = DomainSegmentOps(rcodes[rorder], num)
    col = invoke.run_cogroup_udf(op.udf, _tensors(lcols), lseg,
                                 _tensors(rcols), rseg,
                                 op.left_key, op.right_key)
    ems = []
    for em in col.emissions:
        if em.records:
            raise NotImplementedError("CoGroup passthrough emission is not supported")
        ems.append((em.builder.columns(), em.where))
    return _emit_batches(ems, op.out_schema, _first_len)


# ---------------------------------------------------------------------------
# Flow execution
# ---------------------------------------------------------------------------
def execute(root: Node, bindings: Mapping[str, RecordBatch]) -> RecordBatch:
    """Execute `root` with `bindings` mapping source names to batches."""
    memo: dict[int, RecordBatch] = {}

    def run(node: Node) -> RecordBatch:
        if id(node) in memo:
            return memo[id(node)]
        if isinstance(node, Source):
            if node.name not in bindings:
                raise KeyError(f"no binding for source {node.name!r}")
            out = bindings[node.name].to_numpy().compact()
            missing = [f for f in node.out_schema.fields if f not in out.fields]
            if missing:
                raise KeyError(f"source {node.name!r} binding missing fields {missing}")
            out = out.project(list(node.out_schema.fields))
        elif isinstance(node, MapOp):
            out = _exec_map(node, run(node.child))
        elif isinstance(node, ReduceOp):
            out = _exec_reduce(node, run(node.child))
        elif isinstance(node, LimitOp):
            out = _exec_limit(node, run(node.child))
        elif isinstance(node, MatchOp):
            out = _exec_match(node, run(node.left), run(node.right))
        elif isinstance(node, CrossOp):
            out = _exec_cross(node, run(node.left), run(node.right))
        elif isinstance(node, CoGroupOp):
            out = _exec_cogroup(node, run(node.left), run(node.right))
        else:
            raise TypeError(f"unknown node type {type(node).__name__}")
        memo[id(node)] = out
        return out

    return run(root)
