"""Tracing UDF analysis — opening the black box with PyTorch (port of
`repro.core.sca.jaxpr_sca`).

The UDF runs once on one small CPU tensor per input attribute under
`_DepMode`, a torch function mode that tags every tensor an operation
produces with the set of input attributes it was computed from (every
output of an operation depends on every tensor input — conservative inside
an operation, as the reference's jaxpr walk is).  That is the same
input-dependence walk the reference runs over its jaxpr, and it yields:

* read set  R_f — attributes whose input tensor (transitively) reaches any
  emitted column of a *different* attribute, or any emission mask (Def. 3:
  an identity pass-through of attribute n to attribute n does NOT put n in R).
* write set W_f — emitted columns that are not the identity of the same-named
  input tensor, plus newly-created attributes (Def. 2).
* filter_fields — attributes reaching a `where=` / group-filter mask, giving
  the exact KGP precondition (Def. 5 case 2).

Identity is object identity: an emitted column that IS an input tensor
(`ir.copy()`, `g.get(f)`) passes that attribute through.  Whatever a jaxpr
trace cannot follow fails here too — reading a value back to Python
(`bool`, `int`, `.item()`, `.tolist()`, numpy conversion) or mutating an
input tensor in place — and the caller falls back to the bytecode analyzer.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_leaves

from ..record import torch_dtype
from ..udf import Card, KatEmit, TensorSegmentOps, UdfProperties
from .. import invoke


class Untraceable(RuntimeError):
    """The UDF did something a dependence trace cannot follow."""


# tensor methods that read values back to the host (a jaxpr tracer refuses
# every one of them)
_CONCRETIZING = frozenset((
    "__bool__", "__int__", "__float__", "__index__", "__complex__", "item",
    "tolist", "numpy", "__array__", "__array_wrap__", "__dlpack__"))


class _DepMode(TorchFunctionMode):
    """Records, per live tensor, the input attribute positions it depends on."""

    def __init__(self, inputs: Sequence[torch.Tensor]):
        super().__init__()
        self.deps: dict = {id(t): {i} for i, t in enumerate(inputs)}
        self.inputs = {id(t) for t in inputs}
        self._alive: list = list(inputs)  # ids stay unique while traced

    def deps_of(self, x) -> set:
        return set(self.deps.get(id(x), ()))

    def _tag(self, t: torch.Tensor, d: set) -> None:
        self.deps[id(t)] = self.deps_of(t) | d
        self._alive.append(t)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name in _CONCRETIZING:
            raise Untraceable(f"UDF reads a traced value back ({name})")
        ins: set = set()
        for t in tree_leaves((args, kwargs)):
            if isinstance(t, torch.Tensor):
                ins |= self.deps_of(t)
        inplace = name == "__setitem__" or (
            name.endswith("_") and not name.endswith("__"))
        if inplace and args and isinstance(args[0], torch.Tensor):
            target = args[0]
            if id(target) in self.inputs or (
                    target._base is not None
                    and id(target._base) in self.inputs):
                raise Untraceable(f"UDF mutates an input column ({name})")
        out = func(*args, **kwargs)
        if inplace and args and isinstance(args[0], torch.Tensor):
            self._tag(args[0], ins)
            if args[0]._base is not None:
                self._tag(args[0]._base, ins)
        for t in tree_leaves(out):
            # an input returned unchanged stays that input (identity)
            if isinstance(t, torch.Tensor) and id(t) not in self.inputs:
                self._tag(t, ins)
        return out


class _TraceResult:
    def __init__(self, fields, emissions_meta, out_deps, out_identity):
        self.fields = fields
        self.emissions_meta = emissions_meta  # list of dicts describing emissions
        self.out_deps = out_deps              # per-output set of input field names
        self.out_identity = out_identity      # per-output: field name if identity else None


def _trace(udf_runner, in_fields: Sequence[str], dummy_arrays: Sequence) -> _TraceResult:
    """Run `udf_runner(*tensors) -> Collector` under dependence tracking."""
    mode = _DepMode(dummy_arrays)
    with mode:
        col = udf_runner(*dummy_arrays)
    flat, spec = [], []
    for ei, em in enumerate(col.emissions):
        cols = em.builder.columns() if em.builder is not None else {}
        for f, v in cols.items():
            spec.append(("col", ei, f))
            flat.append(v)
        if em.where is not None:
            spec.append(("where", ei, None))
            flat.append(em.where)
        if em.group_where is not None:
            spec.append(("gwhere", ei, None))
            flat.append(em.group_where)
    emissions = [
        dict(records=em.records,
             has_where=em.where is not None,
             has_gwhere=em.group_where is not None,
             implicit_copy=(em.builder.implicit_copy if em.builder is not None else None),
             set_fields=frozenset(em.builder.set_fields) if em.builder is not None else frozenset(),
             dropped=frozenset(em.builder.dropped) if em.builder is not None else frozenset(),
             first_fields=frozenset(em.builder.first_fields) if em.builder is not None else frozenset(),
             out_fields=tuple(em.builder.columns()) if em.builder is not None else ())
        for em in col.emissions
    ]
    field_of = {id(t): in_fields[i] for i, t in enumerate(dummy_arrays)}
    out_deps, out_identity = [], []
    for v in flat:
        if not isinstance(v, torch.Tensor):  # a Python constant
            out_deps.append(set())
            out_identity.append(None)
            continue
        out_deps.append({in_fields[p] for p in mode.deps_of(v)})
        out_identity.append(field_of.get(id(v)))
    return _TraceResult(list(in_fields), emissions,
                        dict(spec=spec, deps=out_deps, identity=out_identity),
                        None)


def _properties_from_trace(tr: _TraceResult, in_fields: Sequence[str],
                           kat: bool, key_fields: Sequence[str] = (),
                           kat_value_identity_ok: bool = False) -> UdfProperties:
    spec = tr.out_deps["spec"]
    deps = tr.out_deps["deps"]
    identity = tr.out_deps["identity"]
    in_set = frozenset(in_fields)
    key_set = frozenset(key_fields)

    reads: set = set()
    writes: set = set()
    adds: set = set()
    drops: set = set()
    copies: set = set()
    filter_fields: set = set()

    for (tag, ei, f), d, ident in zip(spec, deps, identity):
        if tag in ("where", "gwhere"):
            reads |= d
            filter_fields |= d
            continue
        em = tr.emissions_meta[ei]
        is_passthrough_like = (not kat) or em["records"] or kat_value_identity_ok
        is_key_first = (kat and f in key_set and f in em["first_fields"]
                        and f not in em["set_fields"])
        if f not in in_set:
            adds.add(f)
            writes.add(f)
            reads |= d
        elif ident == f and is_passthrough_like:
            copies.add(f)  # identity pass-through: not read/written (Defs. 2/3)
        elif is_key_first:
            copies.add(f)  # per-group first() of a key attribute is the key itself
        else:
            writes.add(f)
            reads |= {x for x in d if x != f} | ({f} if f in d and ident != f else set())
            if ident is not None and ident != f:
                reads.add(ident)
            # a computed value of field f from field f alone still reads f
            if f in d and ident != f:
                reads.add(f)

    implicit_copy = any(em["implicit_copy"] for em in tr.emissions_meta
                        if em["implicit_copy"] is not None) or \
        any(em["records"] for em in tr.emissions_meta)
    for em in tr.emissions_meta:
        drops |= em["dropped"]

    # Every input field no emission carries is projected away — this covers
    # implicit projection (empty()), AND implicit copies whose base only
    # spans part of the input (e.g. CoGroup UDFs emitting one side's first()).
    if tr.emissions_meta:
        emitted = set()
        for em in tr.emissions_meta:
            if em["records"] and not em["out_fields"]:
                emitted |= in_set  # bare passthrough carries everything
            else:
                emitted |= set(em["out_fields"])
        drops |= in_set - emitted
    writes |= drops  # projecting an attribute away conflicts with readers

    # Cardinality classification
    n_emits = len(tr.emissions_meta)
    rat_card = Card.MANY
    kat_emit: Optional[KatEmit] = None
    if kat:
        recs = [em for em in tr.emissions_meta if em["records"]]
        groups = [em for em in tr.emissions_meta if not em["records"]]
        if n_emits == 1 and recs:
            kat_emit = (KatEmit.PASSTHROUGH_FILTER if recs[0]["has_gwhere"]
                        else KatEmit.PASSTHROUGH)
        elif n_emits == 1 and groups:
            kat_emit = (KatEmit.PER_GROUP_FILTER if groups[0]["has_where"] or groups[0]["has_gwhere"]
                        else KatEmit.PER_GROUP)
        else:
            kat_emit = KatEmit.MANY
        rat_card = Card.MANY
        reads |= key_set  # key attributes always belong to the read set
    else:
        if n_emits == 1:
            rat_card = Card.AT_MOST_ONE if tr.emissions_meta[0]["has_where"] else Card.ONE
        elif n_emits == 0:
            rat_card = Card.AT_MOST_ONE
        else:
            rat_card = Card.MANY

    return UdfProperties(
        reads=frozenset(reads), writes=frozenset(writes), adds=frozenset(adds),
        drops=frozenset(drops), implicit_copy=implicit_copy, card=rat_card,
        filter_fields=frozenset(filter_fields), kat_emit=kat_emit,
        copies=frozenset(copies - writes), source="trace-sca")


# ---------------------------------------------------------------------------
# Entry points per operator kind
# ---------------------------------------------------------------------------
def dummy(dtype, n=4) -> torch.Tensor:
    """A small CPU tensor of numpy `dtype` (the reference's dummy values)."""
    dt = np.dtype(dtype)
    if np.issubdtype(dt, np.floating):
        return torch.linspace(1.0, 2.0, n, dtype=torch_dtype(dt))
    return (torch.arange(n, dtype=torch.int64) % 3).to(torch_dtype(dt))


def analyze_map(udf, in_schema) -> UdfProperties:
    fields = list(in_schema.fields)
    arrays = [dummy(in_schema.dtypes[f]) for f in fields]

    def runner(*arrs):
        return invoke.run_map_udf(udf, dict(zip(fields, arrs)))

    tr = _trace(runner, fields, arrays)
    return _properties_from_trace(tr, fields, kat=False)


def analyze_reduce(udf, in_schema, key: Sequence[str]) -> UdfProperties:
    fields = list(in_schema.fields)
    arrays = [dummy(in_schema.dtypes[f]) for f in fields]
    seg_ids = torch.tensor([0, 0, 1, 1], dtype=torch.int64)

    def runner(*arrs):
        segops = TensorSegmentOps(seg_ids, 2)
        return invoke.run_kat_udf(udf, dict(zip(fields, arrs)), segops, key)

    tr = _trace(runner, fields, arrays)
    props = _properties_from_trace(tr, fields, kat=True, key_fields=key)
    # Decomposability (aggregation splitting): probe the UDF's aggregate call
    # sites and verify the split differentially before recording the recipe.
    from . import decompose

    recipe = decompose.detect(udf, in_schema, key, props)
    if recipe is not None:
        import dataclasses

        props = dataclasses.replace(props, combine=recipe)
    return props


def analyze_pair(udf, left_schema, right_schema,
                 left_key: Sequence[str] = (), right_key: Sequence[str] = ()) -> UdfProperties:
    lf, rf = list(left_schema.fields), list(right_schema.fields)
    arrays = [dummy(left_schema.dtypes[f]) for f in lf] + \
             [dummy(right_schema.dtypes[f]) for f in rf]

    def runner(*arrs):
        lcols = dict(zip(lf, arrs[:len(lf)]))
        rcols = dict(zip(rf, arrs[len(lf):]))
        return invoke.run_pair_udf(udf, lcols, rcols)

    tr = _trace(runner, lf + rf, arrays)
    props = _properties_from_trace(tr, lf + rf, kat=False)
    # Match keys behave like reads of the conceptual f' (Sec. 4.3.1)
    if left_key or right_key:
        import dataclasses

        props = dataclasses.replace(
            props, reads=props.reads | frozenset(left_key) | frozenset(right_key))
    return props


def analyze_cogroup(udf, left_schema, right_schema, left_key, right_key) -> UdfProperties:
    lf, rf = list(left_schema.fields), list(right_schema.fields)
    arrays = [dummy(left_schema.dtypes[f]) for f in lf] + \
             [dummy(right_schema.dtypes[f]) for f in rf]
    seg_ids = torch.tensor([0, 0, 1, 1], dtype=torch.int64)

    def runner(*arrs):
        lcols = dict(zip(lf, arrs[:len(lf)]))
        rcols = dict(zip(rf, arrs[len(lf):]))
        return invoke.run_cogroup_udf(udf, lcols, TensorSegmentOps(seg_ids, 2),
                                      rcols, TensorSegmentOps(seg_ids, 2),
                                      left_key, right_key)

    tr = _trace(runner, lf + rf, arrays)
    return _properties_from_trace(tr, lf + rf, kat=True,
                                  key_fields=tuple(left_key) + tuple(right_key))
