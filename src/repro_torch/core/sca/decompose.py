"""Decomposable-aggregation detection + combiner/merge UDF construction.

The paper's abstract promises "limited forms of aggregation push-down"; this
module supplies the per-operator property that enables it (the SCA companion
derives the same property from code alone).  A key-at-a-time Reduce UDF is
*decomposable* when every emitted column is built from the group's records
only through decomposable `GroupView` aggregates — `sum`/`count`/`min`/`max`
(and `mean` via the sum+count rewrite) — plus group-constant key attributes.
Such a Reduce splits into

    pre   (combiner): per data partition, emit keys + one partial column per
                      aggregate call site — runs BEFORE any repartition;
    merge (final):    re-group the partials by the same key and answer each
                      aggregate call site by merge-reducing its partials
                      (sum of sums, min of mins, ..., mean = Σsum/Σcount).

Both halves re-run the ORIGINAL black-box UDF against an instrumented view:
the combiner records each aggregate call's local value, the merge answers
each call from the shipped partials, so arbitrary arithmetic *around* the
aggregates (e.g. `g.max("ts") - g.min("ts")`) replays unchanged.  This is
sound iff per-record values flow into emissions only THROUGH aggregate calls
and no aggregate argument depends on another aggregate's result — which is
exactly what `verify` establishes by differential eager execution over
multiple partitions of the same input (an analyzer may *propose* a recipe;
only the eager run lets it be *attached*, so decomposability is never
claimed and simultaneously contradicted by execution).

Port of `repro.core.sca.decompose`: the eager runs keep numpy columns and
hand the UDF CPU tensors.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np

from .. import invoke
from ..record import as_numpy, cpu_tensor, torch_dtype
from ..udf import (DECOMPOSABLE_AGGS, Collector, CombineRecipe,
                   DomainSegmentOps, GroupView, KatEmit, UdfProperties,
                   mean_of)

PARTIAL_PREFIX = "_pt"

# GroupView methods whose semantics do NOT compose across partitions of a
# group (or compose only under ordering assumptions the engine does not
# make): calling any of them disqualifies the UDF.
_FORBIDDEN = ("any", "all", "broadcast", "first", "record_builder")


def _tensors(cols: Mapping[str, np.ndarray]) -> dict:
    """Eager numpy columns as the CPU tensors a UDF sees."""
    return {f: cpu_tensor(v) for f, v in cols.items()}


# ---------------------------------------------------------------------------
# Instrumented views
# ---------------------------------------------------------------------------
class _ViewBase:
    """Delegating wrapper over a real GroupView."""

    def __init__(self, inner: GroupView):
        self._inner = inner

    @property
    def key_fields(self):
        return self._inner.key_fields

    @property
    def fields(self):
        return self._inner.fields

    def get(self, name: str):
        return self._inner.get(name)

    def keys(self):
        return self._inner.keys()


class _ProbeView(_ViewBase):
    """Records aggregate call sites (kind + returned value identity) and
    flags any non-decomposable method use.  Always returns the REAL local
    value so the UDF completes normally."""

    def __init__(self, inner: GroupView):
        super().__init__(inner)
        self.tape: list = []      # (kind, returned value)
        self.flags: set = set()

    def _site(self, kind: str, value):
        self.tape.append((kind, value))
        return value

    def sum(self, a):
        return self._site("sum", self._inner.sum(a))

    def min(self, a):
        return self._site("min", self._inner.min(a))

    def max(self, a):
        return self._site("max", self._inner.max(a))

    def mean(self, a):
        return self._site("mean", self._inner.mean(a))

    def count(self):
        return self._site("count", self._inner.count())

    def any(self, a):
        self.flags.add("any")
        return self._inner.any(a)

    def all(self, a):
        self.flags.add("all")
        return self._inner.all(a)

    def broadcast(self, per_group):
        self.flags.add("broadcast")
        return self._inner.broadcast(per_group)

    def first(self):
        self.flags.add("first")
        return self._inner.first()

    def record_builder(self):
        self.flags.add("record_builder")
        return self._inner.record_builder()

    def first_of(self, name: str):
        if name not in self._inner.key_fields:
            self.flags.add("first_of")  # non-key firsts are order-dependent
        return self._inner.first_of(name)


class _PreView(_ViewBase):
    """Combiner side: every aggregate call computes its LOCAL value (returned
    so downstream arithmetic proceeds) and appends its partial column(s) to
    the tape in call order."""

    def __init__(self, inner: GroupView):
        super().__init__(inner)
        self.tape: list = []      # (kind, (partial columns...))

    def sum(self, a):
        v = self._inner.sum(a)
        self.tape.append(("sum", (v,)))
        return v

    def min(self, a):
        v = self._inner.min(a)
        self.tape.append(("min", (v,)))
        return v

    def max(self, a):
        v = self._inner.max(a)
        self.tape.append(("max", (v,)))
        return v

    def count(self):
        v = self._inner.count()
        self.tape.append(("count", (v,)))
        return v

    def mean(self, a):
        s = self._inner.sum(a)
        c = self._inner.count()
        self.tape.append(("mean", (s, c)))
        return mean_of(s, c)

    def first_of(self, name: str):
        if name not in self._inner.key_fields:
            raise RuntimeError("non-key first_of() in a split Reduce")
        return self._inner.first_of(name)

    def __getattr__(self, name):
        if name in _FORBIDDEN:
            raise RuntimeError(f"non-decomposable GroupView.{name}() called "
                               "in a split Reduce")
        raise AttributeError(name)


class _MergeView(_ViewBase):
    """Merge side: per-record accessors return dummy columns (their values
    only ever feed aggregate arguments, which the merge ignores — verified);
    aggregate call site i is answered by merge-reducing its partial columns."""

    def __init__(self, inner: GroupView, recipe: CombineRecipe,
                 orig_fields: tuple, orig_dtypes: Mapping[str, object]):
        super().__init__(inner)
        self._recipe = recipe
        self._orig_fields = tuple(orig_fields)
        self._orig_dtypes = dict(orig_dtypes)
        self._pnames = _site_partials(recipe)
        self._site = 0

    @property
    def fields(self):
        return self._orig_fields

    def get(self, name: str):
        if name in self._inner.key_fields:
            return self._inner.get(name)
        if name not in self._orig_dtypes:
            raise KeyError(f"UDF read of unknown attribute {name!r}")
        base = self._inner.get(self._inner.key_fields[0])
        return (base * 0 + 1).to(torch_dtype(self._orig_dtypes[name]))

    def _next(self, kind: str) -> int:
        i = self._site
        if i >= len(self._recipe.sites) or self._recipe.sites[i] != kind:
            raise RuntimeError(
                f"combiner replay diverged from recipe at site {i} "
                f"({kind!r} vs {self._recipe.sites[i:i + 1]!r})")
        self._site = i + 1
        return i

    def sum(self, a):
        return self._inner.sum(self._pnames[self._next("sum")][0])

    def min(self, a):
        return self._inner.min(self._pnames[self._next("min")][0])

    def max(self, a):
        return self._inner.max(self._pnames[self._next("max")][0])

    def count(self):
        return self._inner.sum(self._pnames[self._next("count")][0])

    def mean(self, a):
        names = self._pnames[self._next("mean")]
        s = self._inner.sum(names[0])
        c = self._inner.sum(names[1])
        return mean_of(s, c)

    def first_of(self, name: str):
        if name not in self._inner.key_fields:
            raise RuntimeError("non-key first_of() in a split Reduce")
        return self._inner.first_of(name)

    def __getattr__(self, name):
        if name in _FORBIDDEN:
            raise RuntimeError(f"non-decomposable GroupView.{name}() called "
                               "in a split Reduce")
        raise AttributeError(name)


def _site_partials(recipe: CombineRecipe) -> list:
    """Per-site tuple of partial column names, aligned with recipe.sites."""
    names = list(recipe.partial_fields(PARTIAL_PREFIX))
    out, i = [], 0
    for kind in recipe.sites:
        n = 2 if kind == "mean" else 1
        out.append(tuple(names[i:i + n]))
        i += n
    return out


# ---------------------------------------------------------------------------
# Split UDF construction
# ---------------------------------------------------------------------------
def make_pre_udf(udf, recipe: CombineRecipe):
    """Combiner UDF: run `udf` capturing local partials; emit keys+partials."""
    expected = tuple(recipe.sites)
    pnames = recipe.partial_fields(PARTIAL_PREFIX)

    def pre(g, out):
        view = _PreView(g)
        udf(view, Collector())  # original emissions discarded
        kinds = tuple(k for k, _ in view.tape)
        if kinds != expected:
            raise RuntimeError(
                f"combiner replay diverged from recipe: {kinds} vs {expected}")
        b = g.keys()
        it = iter(pnames)
        for _, vals in view.tape:
            for v in vals:
                b.set(next(it), v)
        out.emit(b)

    pre.__name__ = getattr(udf, "__name__", "udf") + "_pre"
    pre.__combine_pre__ = (udf, recipe)
    return pre


def make_merge_udf(udf, recipe: CombineRecipe, orig_fields: Sequence[str],
                   orig_dtypes: Mapping[str, object]):
    """Merge UDF: run `udf` with aggregate sites answered from partials."""
    fields = tuple(orig_fields)
    dtypes = {f: np.dtype(orig_dtypes[f]) for f in fields}

    def merge(g, out):
        udf(_MergeView(g, recipe, fields, dtypes), out)

    merge.__name__ = getattr(udf, "__name__", "udf") + "_merge"
    merge.__combine_merge__ = (udf, recipe)
    return merge


# ---------------------------------------------------------------------------
# Probe: propose a recipe from one instrumented eager run
# ---------------------------------------------------------------------------
def _dummy_cols(schema, key: Sequence[str], seg_ids: np.ndarray,
                seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    n = len(seg_ids)
    out = {}
    for f in schema.fields:
        dt = np.dtype(schema.dtypes[f])
        if f in key:
            v = seg_ids.astype(dt) * 2 + 1  # distinct value per group
        elif np.issubdtype(dt, np.floating):
            v = rng.uniform(-2.0, 3.0, n).astype(dt)
        else:
            v = rng.integers(-4, 9, n).astype(dt)
        out[f] = v
    return out


def _run_reduce(udf, cols: Mapping[str, np.ndarray], key: Sequence[str]):
    """Minimal eager Reduce: returns (GroupView-style per-group columns, the
    single per-group Emission's builder)."""
    from ..executor import joint_codes

    codes_list, num = joint_codes([[cols[k] for k in key]])
    codes = codes_list[0]
    order = np.argsort(codes, kind="stable")
    sorted_cols = _tensors({f: np.asarray(v)[order] for f, v in cols.items()})
    segops = DomainSegmentOps(codes[order], num)
    col = invoke.run_kat_udf(udf, sorted_cols, segops, key)
    if len(col.emissions) != 1:
        raise RuntimeError("expected exactly one emission")
    em = col.emissions[0]
    if em.records or em.where is not None or em.group_where is not None:
        raise RuntimeError("not a plain per-group emission")
    return num, em.builder


def probe(udf, in_schema, key: Sequence[str]) -> Optional[CombineRecipe]:
    """One instrumented eager run over 3 uneven groups; None if the UDF uses
    any non-decomposable construct or emits per-record data."""
    key = tuple(key)
    seg_ids = np.array([0, 1, 1, 1, 2, 2, 2, 2, 2, 2], dtype=np.int64)
    cols = _dummy_cols(in_schema, key, seg_ids)
    num_groups = int(seg_ids.max()) + 1
    segops = DomainSegmentOps(seg_ids, num_groups)
    view = GroupView(_tensors(cols), segops, key)
    pview = _ProbeView(view)
    sink = Collector()
    try:
        udf(pview, sink)
    except Exception:
        return None
    if pview.flags:
        return None
    if len(sink.emissions) != 1:
        return None
    em = sink.emissions[0]
    if em.records or em.where is not None or em.group_where is not None \
            or em.builder is None:
        return None

    sites = tuple(k for k, _ in pview.tape)
    if any(k not in DECOMPOSABLE_AGGS for k in sites):
        return None
    columns = []
    for f, v in em.builder.columns().items():
        if f in key and f in em.builder.first_fields \
                and f not in em.builder.set_fields:
            columns.append((f, "key"))
            continue
        kind = next((k for k, tv in pview.tape if v is tv), None)
        if kind is not None:
            columns.append((f, kind))
            continue
        if np.ndim(as_numpy(v)) == 0:
            columns.append((f, "expr"))  # record-independent constant
            continue
        if np.shape(as_numpy(v))[0] != num_groups:
            return None  # per-record data leaked into a per-group emission
        columns.append((f, "expr"))
    return CombineRecipe(sites=sites, columns=tuple(columns))


# ---------------------------------------------------------------------------
# Verification: split-vs-unsplit differential eager execution
# ---------------------------------------------------------------------------
def _group_rows(num: int, builder) -> list:
    cols = {f: np.atleast_1d(as_numpy(v)) for f, v in builder.columns().items()}
    cols = {f: np.broadcast_to(v, (num,)) if v.shape[0] != num else v
            for f, v in cols.items()}
    fields = sorted(cols)
    return sorted(zip(*[cols[f] for f in fields]),
                  key=lambda t: tuple(repr(x) for x in t)), fields


def _rows_close(a_rows, b_rows) -> bool:
    if len(a_rows) != len(b_rows):
        return False
    for ra, rb in zip(a_rows, b_rows):
        for x, y in zip(ra, rb):
            xf, yf = np.asarray(x), np.asarray(y)
            if np.issubdtype(xf.dtype, np.floating) \
                    or np.issubdtype(yf.dtype, np.floating):
                if not np.allclose(xf, yf, rtol=1e-5, atol=1e-8):
                    return False
            elif xf != yf:
                return False
    return True


def _partitions(n: int, rng) -> list:
    """Several partitions of range(n) into non-empty shards, including
    order-scrambling and group-splitting ones."""
    idx = np.arange(n)
    parts = [[idx]]                                   # 1 shard (sanity)
    parts.append([idx[: n // 2], idx[n // 2:]])       # contiguous halves
    parts.append([idx[::3], idx[1::3], idx[2::3]])    # strided thirds
    perm = rng.permutation(n)
    parts.append([perm[: n // 3], perm[n // 3:]])     # shuffled uneven split
    return [[s for s in p if len(s)] for p in parts]


def verify(udf, in_schema, key: Sequence[str],
           recipe: CombineRecipe) -> bool:
    """Does pre+merge reproduce the unsplit Reduce on random data for every
    tried partition?  Exact for integer outputs, tight-tolerance for floats
    (partitioning reassociates float sums)."""
    key = tuple(key)
    try:
        pre = make_pre_udf(udf, recipe)
        merge = make_merge_udf(udf, recipe, in_schema.fields, in_schema.dtypes)
        for seed in (1, 2):
            rng = np.random.default_rng(seed)
            n = 12 + seed
            seg_src = rng.integers(0, 4, n)
            cols = _dummy_cols(in_schema, key, seg_src, seed=seed)
            num_ref, ref_builder = _run_reduce(udf, cols, key)
            ref_rows, ref_fields = _group_rows(num_ref, ref_builder)
            for part in _partitions(n, rng):
                shards = []
                for idx in part:
                    scols = {f: np.asarray(v)[idx] for f, v in cols.items()}
                    m, b = _run_reduce(pre, scols, key)
                    shards.append({f: np.atleast_1d(as_numpy(v))
                                   for f, v in b.columns().items()})
                cat = {f: np.concatenate([s[f] for s in shards])
                       for f in shards[0]}
                num_got, got_builder = _run_reduce(merge, cat, key)
                got_rows, got_fields = _group_rows(num_got, got_builder)
                if got_fields != ref_fields or not _rows_close(ref_rows,
                                                               got_rows):
                    return False
    except Exception:
        return False
    return True


def detect(udf, in_schema, key: Sequence[str],
           props: UdfProperties) -> Optional[CombineRecipe]:
    """Verified combine recipe for a Reduce UDF, or None.

    Only plain one-record-per-group UDFs qualify; schema-reflecting UDFs are
    excluded (the merge replay presents the original field list, but a
    rewritten plan may have changed the ambient schema)."""
    if props.kat_emit is not KatEmit.PER_GROUP or props.schema_dependent:
        return None
    try:
        recipe = probe(udf, in_schema, key)
    except Exception:
        return None
    if recipe is None:
        return None
    return recipe if verify(udf, in_schema, key, recipe) else None


def partial_dtypes(udf, recipe: CombineRecipe, in_schema,
                   key: Sequence[str]) -> dict:
    """Dtypes of the combiner's partial columns, from an eager dummy run."""
    pre = make_pre_udf(udf, recipe)
    seg_ids = np.array([0, 0, 1, 1], dtype=np.int64)
    cols = _dummy_cols(in_schema, tuple(key), seg_ids)
    _, builder = _run_reduce(pre, cols, tuple(key))
    keep = set(recipe.partial_fields(PARTIAL_PREFIX))
    return {f: as_numpy(v).dtype for f, v in builder.columns().items()
            if f in keep}
