"""UDF-facing record API + black-box UDF property model.

UDFs are ordinary Python functions written against a tiny record API, exactly
mirroring the paper's 3-address record API (Sec. 5):

    getField        -> view.get("name")
    OutputRecord(ir) -> ir.copy()            (Implicit Copy)
    OutputRecord()   -> empty()              (Implicit Projection)
    OutputRecord(i1,i2) -> left.concat(right) (binary implicit copy)
    setField        -> builder.set("name", value)
    explicit proj.  -> builder.drop("name")
    emit            -> out.emit(builder[, where=mask])

UDFs are *vectorized*: `get` returns the whole column, and data-dependent
control flow ("if (a < 0) skip") is expressed as the `where=` emission mask.
This keeps them executable eagerly, on the device (masked), and traceable
for the dependence-tracking analyzer — while remaining black boxes to the
optimizer, which only ever sees the derived `UdfProperties`.

Port of `repro.core.udf`.  UDFs see torch tensors on every path: the eager
executor hands them CPU tensors (its segment reductions compute in numpy and
return tensors), the masked executor tensors on the bound device.

Key-at-a-time (Reduce/CoGroup) UDFs receive a `GroupView` with per-group
aggregation methods and may either emit one record per group (`out.emit`) or
pass through the group's records (`out.emit_records`), optionally filtered by
a per-group mask — the clickstream "filter buy sessions" pattern.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from . import scans
from .record import as_numpy, as_tensor, cpu_tensor


# ---------------------------------------------------------------------------
# Emission cardinality classes (drive the KGP condition, Def. 5)
# ---------------------------------------------------------------------------
class Card(enum.Enum):
    ONE = "one"                  # |f(r)| = 1 for every record
    AT_MOST_ONE = "at_most_one"  # |f(r)| <= 1 (a filter)
    MANY = "many"                # anything else


class KatEmit(enum.Enum):
    PER_GROUP = "per_group"            # exactly one record per key group
    PER_GROUP_FILTER = "per_group_filter"  # <=1 record per key group
    PASSTHROUGH = "passthrough"        # all records of group, one-for-one
    PASSTHROUGH_FILTER = "passthrough_filter"  # whole groups kept or dropped
    MANY = "many"


# ---------------------------------------------------------------------------
# Decomposable aggregation (SOFA-style aggregation splitting)
# ---------------------------------------------------------------------------
# Aggregate kinds whose per-group results compose across a partition of the
# group's records: kind(kind(part_1), ..., kind(part_k)) == kind(whole) for
# sum/min/max, count via sum-of-counts, and mean via the sum+count rewrite.
DECOMPOSABLE_AGGS = ("sum", "min", "max", "count", "mean")


@dataclasses.dataclass(frozen=True)
class CombineRecipe:
    """How to split a PER_GROUP Reduce UDF into a local pre-aggregation
    (combiner) plus a final merge.

    `sites` lists the UDF's GroupView aggregate call sites in (deterministic)
    call order — one of `DECOMPOSABLE_AGGS` each.  The combiner re-runs the
    UDF per partition, capturing each site's partial value(s) as extra
    columns (`partial_fields`); the merge re-runs the UDF with every site
    answered by merge-reducing those partials instead of touching records.
    `columns` maps each emitted output column to how it is rebuilt at merge
    time: 'key' (group-constant key attribute), one of the aggregate kinds
    (the column IS site i's untouched result), or 'expr' (an arithmetic
    composition of aggregate results, replayed by re-running the UDF).

    A recipe is only attached to `UdfProperties.combine` after the split has
    been verified against an eager differential run (sca.decompose.verify) —
    analyzers may propose, the eager run disposes.
    """

    sites: tuple = ()        # aggregate kind per call site, in call order
    columns: tuple = ()      # (output_field, 'key'|kind|'expr') pairs

    def partial_fields(self, prefix: str = "_pt") -> tuple:
        """Names of the partial columns the combiner emits, site-ordered.
        `mean` decomposes into two partials (sum + count)."""
        out = []
        for i, kind in enumerate(self.sites):
            if kind == "mean":
                out.append(f"{prefix}{i}s")
                out.append(f"{prefix}{i}c")
            else:
                out.append(f"{prefix}{i}")
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class UdfProperties:
    """The handful of properties the optimizer needs (Defs. 2-5)."""

    reads: frozenset            # R_f over global attribute names
    writes: frozenset           # W_f: modified + newly-created attributes
    adds: frozenset             # newly created attributes (subset of writes)
    drops: frozenset            # explicitly projected-out attributes
    implicit_copy: bool         # copy-constructor vs projection semantics
    card: Card                  # RAT emission cardinality
    filter_fields: frozenset    # attrs the emission mask may depend on
    kat_emit: Optional[KatEmit] = None  # set for Reduce/CoGroup UDFs
    copies: frozenset = frozenset()  # explicit unmodified copies (schema only,
                                     # NOT writes — paper's explicit-copy case)
    source: str = "manual"      # 'manual' | 'bytecode-sca' | 'trace-sca'
    # True when the UDF enumerates its input schema (`view.fields`): its
    # behaviour then depends on the ambient schema, so rewrites that change
    # the input schema are blocked.  The paper's record API accesses fields
    # by static positions, which corresponds to schema_dependent=False;
    # first()/record_builder() are safe built-ins (group-constant/identity
    # extension semantics) and do NOT set this flag.
    schema_dependent: bool = False
    # Set (by the SCA analyzers, after eager verification) when the KAT UDF's
    # emissions are built only from decomposable per-group aggregates, so a
    # Reduce over it may be split into combiner + merge (reorder.split_reduce).
    combine: Optional[CombineRecipe] = None

    def satisfies_kgp(self, key_fields: frozenset) -> bool:
        """Key Group Preservation (Def. 5) w.r.t. `key_fields`.

        RAT: |f(r)|=1 always qualifies; a filter qualifies iff its decision
        depends only on a subset of the key.  KAT: one-for-one passthrough
        qualifies; group-filtered passthrough qualifies iff the filter fields
        are within the key.  Aggregating emission changes group cardinality
        and never qualifies (conservative).
        """
        key_fields = frozenset(key_fields)
        if self.kat_emit is None:
            if self.card is Card.ONE:
                return True
            if self.card is Card.AT_MOST_ONE:
                return self.filter_fields <= key_fields
            return False
        if self.kat_emit is KatEmit.PASSTHROUGH:
            return True
        if self.kat_emit is KatEmit.PASSTHROUGH_FILTER:
            return self.filter_fields <= key_fields
        return False

    def is_superset_of(self, other: "UdfProperties") -> bool:
        """Safety check: conservative estimates must be supersets (Sec. 5)."""
        return (self.reads >= other.reads and self.writes >= other.writes
                and self.adds >= other.adds)


# ---------------------------------------------------------------------------
# Views handed to UDFs
# ---------------------------------------------------------------------------
class InputView:
    """Read-only view of a record batch (one column per attribute)."""

    def __init__(self, columns: Mapping[str, object]):
        self._columns = dict(columns)

    def get(self, name: str):
        if name not in self._columns:
            raise KeyError(f"UDF read of unknown attribute {name!r}")
        return self._columns[name]

    @property
    def fields(self) -> tuple:
        return tuple(self._columns)

    def copy(self) -> "OutputBuilder":
        """Paper's `new OutputRecord($ir)` — Implicit Copy."""
        return OutputBuilder(base=dict(self._columns), implicit_copy=True)

    def concat(self, other: "InputView") -> "OutputBuilder":
        """Paper's `new OutputRecord($i1,$i2)` — binary implicit copy."""
        base = dict(self._columns)
        for k, v in other._columns.items():
            if k in base:
                raise KeyError(f"concat collision on attribute {k!r}")
            base[k] = v
        return OutputBuilder(base=base, implicit_copy=True)


def empty() -> "OutputBuilder":
    """Paper's `new OutputRecord()` — Implicit Projection."""
    return OutputBuilder(base={}, implicit_copy=False)


class OutputBuilder:
    """Mutable output record under construction (vectorized)."""

    def __init__(self, base: dict, implicit_copy: bool, first_fields=()):
        self._cols = dict(base)
        self.implicit_copy = implicit_copy
        self.set_fields: set = set()
        self.dropped: set = set()
        # fields populated by GroupView.first(): identity for key attributes
        self.first_fields: set = set(first_fields)

    def set(self, name: str, value) -> "OutputBuilder":
        self._cols[name] = value
        self.set_fields.add(name)
        self.dropped.discard(name)
        return self

    def drop(self, name: str) -> "OutputBuilder":
        self._cols.pop(name, None)
        self.dropped.add(name)
        self.set_fields.discard(name)
        return self

    def columns(self) -> dict:
        return dict(self._cols)


@dataclasses.dataclass
class Emission:
    builder: OutputBuilder
    where: Optional[object] = None        # per-record mask (RAT) or None
    records: bool = False                 # KAT passthrough emission
    group_where: Optional[object] = None  # per-group mask for passthrough


class Collector:
    """The `out` argument of every UDF."""

    def __init__(self):
        self.emissions: list[Emission] = []

    def emit(self, builder: OutputBuilder, where=None):
        self.emissions.append(Emission(builder, where=where))

    def emit_records(self, builder: Optional[OutputBuilder] = None, where=None):
        """KAT passthrough: emit all records of each group (optionally only
        for groups where the per-group mask holds). `builder`, if given, is a
        per-record builder carrying modified columns."""
        self.emissions.append(Emission(builder, records=True, group_where=where))


# ---------------------------------------------------------------------------
# Group view for key-at-a-time UDFs (Reduce / CoGroup)
# ---------------------------------------------------------------------------
def mean_of(total, count) -> torch.Tensor:
    """Per-group mean from per-group totals and counts: float64 for integer
    totals (the reference's x64 division), empty groups divide by 1."""
    total = torch.as_tensor(total)
    if not total.dtype.is_floating_point:
        total = total.to(torch.float64)
    return total / torch.clamp(torch.as_tensor(count), min=1)


class SegmentOps:
    """Backend for per-segment reductions over a key-sorted batch."""

    def sum(self, values):  # pragma: no cover - interface
        raise NotImplementedError

    def max(self, values):
        raise NotImplementedError

    def min(self, values):
        raise NotImplementedError

    def count(self):
        raise NotImplementedError

    def first(self, values):
        raise NotImplementedError

    def any(self, mask):
        raise NotImplementedError

    def all(self, mask):
        raise NotImplementedError

    def broadcast(self, per_group):
        raise NotImplementedError


class EagerSegmentOps(SegmentOps):
    """numpy reduceat-based segment reductions (host pipeline mode); results
    are handed back to the UDF as CPU tensors."""

    def __init__(self, starts: np.ndarray, n: int, segment_ids: np.ndarray):
        self.starts = starts
        self.n = n
        self.segment_ids = segment_ids

    def _reduceat(self, ufunc, values):
        values = as_numpy(values)
        if len(self.starts) == 0:
            return cpu_tensor(values[:0])
        return cpu_tensor(ufunc.reduceat(values, self.starts))

    def sum(self, values):
        return self._reduceat(np.add, values)

    def max(self, values):
        return self._reduceat(np.maximum, values)

    def min(self, values):
        return self._reduceat(np.minimum, values)

    def count(self):
        return cpu_tensor(np.diff(np.append(self.starts, self.n)))

    def mean(self, values):
        return mean_of(self.sum(values), self.count())

    def first(self, values):
        return cpu_tensor(as_numpy(values)[self.starts])

    def any(self, mask):
        return self.sum(as_numpy(mask).astype(np.int64)) > 0

    def all(self, mask):
        return self.sum(as_numpy(mask).astype(np.int64)) == self.count()

    def broadcast(self, per_group):
        return cpu_tensor(as_numpy(per_group)[self.segment_ids])


class DomainSegmentOps(SegmentOps):
    """Segment reductions over a *fixed key domain* of `num_segments` groups,
    some of which may be empty (CoGroup aligns both inputs on the union key
    domain).  Input arrays are key-sorted; `segment_ids` maps each record to
    its dense domain code."""

    def __init__(self, segment_ids: np.ndarray, num_segments: int):
        self.segment_ids = as_numpy(segment_ids)
        self.num_segments = int(num_segments)

    def sum(self, values):
        v = as_numpy(values)
        out = np.bincount(self.segment_ids, weights=v.astype(np.float64),
                          minlength=self.num_segments)
        if np.issubdtype(v.dtype, np.integer) or v.dtype == bool:
            return cpu_tensor(out.astype(np.int64))
        return cpu_tensor(out.astype(v.dtype))

    def max(self, values):
        v = as_numpy(values)
        fill = (np.finfo(v.dtype).min if np.issubdtype(v.dtype, np.floating)
                else np.iinfo(v.dtype).min)
        out = np.full(self.num_segments, fill, dtype=v.dtype)
        np.maximum.at(out, self.segment_ids, v)
        return cpu_tensor(out)

    def min(self, values):
        v = as_numpy(values)
        fill = (np.finfo(v.dtype).max if np.issubdtype(v.dtype, np.floating)
                else np.iinfo(v.dtype).max)
        out = np.full(self.num_segments, fill, dtype=v.dtype)
        np.minimum.at(out, self.segment_ids, v)
        return cpu_tensor(out)

    def count(self):
        return cpu_tensor(np.bincount(self.segment_ids,
                                   minlength=self.num_segments).astype(np.int64))

    def mean(self, values):
        return mean_of(self.sum(values), self.count())

    def first(self, values):
        v = as_numpy(values)
        out = np.zeros(self.num_segments, dtype=v.dtype)
        # reversed scatter: the first occurrence wins
        out[self.segment_ids[::-1]] = v[::-1]
        return cpu_tensor(out)

    def any(self, mask):
        return self.sum(as_numpy(mask).astype(np.int64)) > 0

    def all(self, mask):
        c = self.count()
        return (self.sum(as_numpy(mask).astype(np.int64)) == c) & (c > 0)

    def broadcast(self, per_group):
        return cpu_tensor(as_numpy(per_group)[self.segment_ids])


class TensorSegmentOps(SegmentOps):
    """Segment reductions with a static segment count, on tensors of any
    device (port of `repro.core.udf.JitSegmentOps`).

    Two regimes:

    * `is_start` given (the masked Reduce path): segment ids are sorted AND
      densely numbered in row order, with `is_start` marking the first VALID
      row of each segment.  Aggregates then run scatter-free: `first` is a
      gather at segment starts, integer sums/counts difference a prefix sum
      (exact), float sums and max/min run a segmented scan gathered at
      segment ends (`repro_torch.core.scans`).  Below `_SCAN_MIN_ROWS` rows
      one scatter replaces the scan, as in the reference.
    * no `is_start` (CoGroup sides, external callers): scatter reductions
      (`index_add_` / `scatter_reduce_`), which tolerate segment ids that
      skip numbers on one side.  `first()` infers starts from id transitions
      — only sound when valid rows are contiguous, which that path
      guarantees.
    """

    def __init__(self, segment_ids, num_segments: int, record_valid=None,
                 is_start=None):
        self.segment_ids = as_tensor(segment_ids)
        self.num_segments = int(num_segments)
        self.record_valid = record_valid
        self.is_start = is_start
        self._pos = None  # lazy (starts, ends, ngroups), shared across calls

    def _tensor(self, values) -> torch.Tensor:
        return as_tensor(values, self.segment_ids.device)

    def _masked(self, values, fill):
        values = self._tensor(values)
        if self.record_valid is None:
            return values
        return torch.where(self.record_valid, values, fill)

    # -- sorted/dense fast path helpers -------------------------------------
    def _starts_ends(self):
        """Row positions of each segment's first and last slot (computed once
        per stage input, reused by every aggregate call site).  Positions for
        segments past the live group count are clamped garbage — their
        aggregates are masked by the executor's `group_valid` prefix."""
        if self._pos is None:
            n = self.is_start.shape[0]
            c = scans.cumsum(self.is_start.to(torch.int64))
            u = torch.searchsorted(
                c, torch.arange(1, self.num_segments + 2, dtype=torch.int64,
                                device=c.device))
            starts = torch.clamp(u[:-1], max=n - 1)
            ends = torch.clamp(u[1:] - 1, 0, n - 1)
            self._pos = (starts, ends, c[-1])
        return self._pos

    def _prefix_diff(self, vm):
        """Per-segment totals by differencing a prefix sum — exact for
        integer values, so counts and integer sums skip the scan."""
        from . import scans

        starts, ends, _ = self._starts_ends()
        cv = scans.cumsum(vm)
        return cv[ends] - (cv[starts] - vm[starts])

    # below this many rows a single scatter beats the segmented scan (the
    # reference's crossover, kept so both regimes are exercised alike)
    _SCAN_MIN_ROWS = 2048

    def _scatter(self, vm, op):
        out = torch.full((self.num_segments,), scans.identity_for(op, vm.dtype),
                         dtype=vm.dtype, device=vm.device)
        if op == "add":
            return out.index_add_(0, self.segment_ids, vm)
        return out.scatter_reduce_(0, self.segment_ids, vm,
                                   reduce="amax" if op == "max" else "amin")

    def _seg_reduce(self, vm, op):
        if vm.shape[0] < self._SCAN_MIN_ROWS:
            return self._scatter(vm, op)
        _, ends, _ = self._starts_ends()
        return scans.segmented_scan(vm, self.is_start, op)[ends]

    # -- aggregates ----------------------------------------------------------
    def sum(self, values):
        vm = self._masked(values, 0)
        if vm.dtype == torch.bool:
            vm = vm.to(torch.int64)
        if self.is_start is not None:
            if vm.dtype.is_floating_point:
                # the scan sums without prefix differencing, so float
                # aggregates see no catastrophic cancellation
                return self._seg_reduce(vm, "add")
            return self._prefix_diff(vm)
        return self._scatter(vm, "add")

    def max(self, values):
        v = self._tensor(values)
        vm = self._masked(v, scans.identity_for("max", v.dtype))
        if self.is_start is not None:
            return self._seg_reduce(vm, "max")
        return self._scatter(vm, "max")

    def min(self, values):
        v = self._tensor(values)
        vm = self._masked(v, scans.identity_for("min", v.dtype))
        if self.is_start is not None:
            return self._seg_reduce(vm, "min")
        return self._scatter(vm, "min")

    def count(self):
        ones = self._masked(torch.ones_like(self.segment_ids,
                                            dtype=torch.int64), 0)
        if self.is_start is not None:
            return self._prefix_diff(ones)
        return self._scatter(ones, "add")

    def mean(self, values):
        return mean_of(self.sum(values), self.count())

    def first(self, values):
        v = self._tensor(values)
        sid = self.segment_ids
        if self.is_start is not None:
            starts, _, ngroups = self._starts_ends()
            k = torch.arange(self.num_segments, device=v.device)
            # zero (not garbage) past the live groups, matching the
            # reference's segment_sum-of-contributions behaviour
            return torch.where(k < ngroups, v[starts],
                               torch.zeros((), dtype=v.dtype, device=v.device))
        is_start = torch.ones_like(sid, dtype=torch.bool)
        is_start[1:] = sid[1:] != sid[:-1]
        if self.record_valid is not None:
            is_start = is_start & self.record_valid
        # one slot past the domain absorbs every non-start row
        rows = torch.where(is_start, sid, self.num_segments)
        out = torch.zeros(self.num_segments + 1, dtype=v.dtype,
                          device=v.device)
        return out.scatter_(0, rows, v)[:self.num_segments]

    def any(self, mask):
        return self.sum(self._tensor(mask).to(torch.int64)) > 0

    def all(self, mask):
        return self.sum(self._tensor(mask).to(torch.int64)) == self.count()

    def broadcast(self, per_group):
        return self._tensor(per_group)[self.segment_ids]


class GroupView:
    """View over all key groups of a KAT operator input, vectorized across
    groups: per-record accessors return full columns (key-sorted), aggregate
    methods return one value per group."""

    def __init__(self, columns: Mapping[str, object], segops: SegmentOps,
                 key_fields: Sequence[str]):
        self._columns = dict(columns)
        self._seg = segops
        self.key_fields = tuple(key_fields)

    # per-record access (key-sorted order)
    def get(self, name: str):
        if name not in self._columns:
            raise KeyError(f"UDF read of unknown attribute {name!r}")
        return self._columns[name]

    @property
    def fields(self) -> tuple:
        return tuple(self._columns)

    # per-group aggregates
    def sum(self, name_or_values):
        return self._seg.sum(self._resolve(name_or_values))

    def max(self, name_or_values):
        return self._seg.max(self._resolve(name_or_values))

    def min(self, name_or_values):
        return self._seg.min(self._resolve(name_or_values))

    def mean(self, name_or_values):
        return self._seg.mean(self._resolve(name_or_values))

    def count(self):
        return self._seg.count()

    def any(self, values):
        return self._seg.any(values)

    def all(self, values):
        return self._seg.all(values)

    def broadcast(self, per_group):
        """Per-group values -> per-record values (gather by segment id)."""
        return self._seg.broadcast(per_group)

    def first(self) -> OutputBuilder:
        """Representative record per group (implicit copy of group firsts).
        NOTE: non-key fields are order-dependent — data sets are unordered
        (Sec. 2.2), so order-insensitive UDFs should prefer `keys()`."""
        return OutputBuilder(
            base={k: self._seg.first(v) for k, v in self._columns.items()},
            implicit_copy=True, first_fields=tuple(self._columns))

    def first_of(self, name: str):
        """Per-group first value of one attribute (sound pass-through for
        attributes known to be group-constant)."""
        return self._seg.first(self._columns[name])

    def keys(self) -> OutputBuilder:
        """Per-group key values only (deterministic: keys are constant within
        a group).  Implicit projection of all non-key fields."""
        return OutputBuilder(
            base={k: self._seg.first(self._columns[k]) for k in self.key_fields},
            implicit_copy=False, first_fields=tuple(self.key_fields))

    def record_builder(self) -> OutputBuilder:
        """Per-record builder for modified passthrough emission."""
        return OutputBuilder(base=dict(self._columns), implicit_copy=True)

    def _resolve(self, name_or_values):
        if isinstance(name_or_values, str):
            return self._columns[name_or_values]
        return name_or_values


UdfFn = Callable  # (views..., Collector) -> None
