"""User-facing flow construction API.

Builders wire the SCA analyzers into operator construction: a PACT program is
assembled exactly as in the paper — second-order function + black-box UDF —
and the properties needed for reordering are derived automatically (or
supplied as manual annotations via `props=`, the paper's other path).
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence

from .operators import (CoGroupOp, CrossOp, Hints, LimitOp, MapOp, MatchOp,
                        Node, ReduceOp, Source)
from .record import Schema
from .sca import analyze_udf, infer_add_dtypes
from .udf import Card, UdfProperties

_counter = itertools.count()


def _opname(udf, name: Optional[str]) -> str:
    if name is not None:
        return name
    base = getattr(udf, "__name__", "op")
    return f"{base}#{next(_counter)}"


def source(name: str, schema: Schema, num_records: int = 1000,
           partitioned_on: Optional[Sequence[str]] = None,
           sorted_on: Optional[Sequence[str]] = None) -> Source:
    return Source(name=name, out_schema=schema, num_records=num_records,
                  partitioned_on=tuple(partitioned_on) if partitioned_on else None,
                  sorted_on=tuple(sorted_on) if sorted_on else None)


def map_(child: Node, udf, name: Optional[str] = None, mode: str = "auto",
         props: Optional[UdfProperties] = None, hints: Hints = Hints()) -> MapOp:
    props = analyze_udf(udf, "map", [child.out_schema], mode=mode, props=props)
    add_dtypes = infer_add_dtypes(udf, "map", [child.out_schema]) if props.adds else {}
    return MapOp(name=_opname(udf, name), udf=udf, props=props, child=child,
                 hints=hints, add_dtypes=add_dtypes)


def reduce_(child: Node, key: Sequence[str], udf, name: Optional[str] = None,
            mode: str = "auto", props: Optional[UdfProperties] = None,
            hints: Hints = Hints()) -> ReduceOp:
    key = tuple(key)
    props = analyze_udf(udf, "reduce", [child.out_schema], key=key, mode=mode,
                        props=props)
    add_dtypes = infer_add_dtypes(udf, "reduce", [child.out_schema], key=key) \
        if props.adds else {}
    return ReduceOp(name=_opname(udf, name), udf=udf, key=key, props=props,
                    child=child, hints=hints, add_dtypes=add_dtypes)


def _default_join_udf(l, r, out):
    out.emit(l.concat(r))


def limit_(child: Node, k: int, key: Sequence[str],
           name: Optional[str] = None, hints: Hints = Hints()) -> LimitOp:
    """WITH-TIES top-k of `child` by ascending `key` (lexicographic)."""
    return LimitOp(name=name if name is not None else f"limit#{next(_counter)}",
                   k=int(k), key=tuple(key), child=child, hints=hints)


def _anti_props() -> UdfProperties:
    # No UDF runs for an anti join: survivors are left records verbatim.
    # The drop decision depends on the right input's key multiset, i.e. it
    # is not record-local — the sentinel filter field keeps satisfies_kgp
    # False for every key set (same convention as LimitOp's props).
    return UdfProperties(reads=frozenset(), writes=frozenset(),
                         adds=frozenset(), drops=frozenset(),
                         implicit_copy=True, card=Card.AT_MOST_ONE,
                         filter_fields=frozenset(("__anti_global__",)),
                         source="builtin")


def match(left: Node, right: Node, left_key: Sequence[str],
          right_key: Sequence[str], udf=None, name: Optional[str] = None,
          mode: str = "auto", props: Optional[UdfProperties] = None,
          hints: Hints = Hints(), anti: bool = False) -> MatchOp:
    udf = udf or _default_join_udf
    left_key, right_key = tuple(left_key), tuple(right_key)
    if anti:
        props = props or _anti_props()
        add_dtypes = {}
    else:
        props = analyze_udf(udf, "match", [left.out_schema, right.out_schema],
                            left_key=left_key, right_key=right_key, mode=mode,
                            props=props)
        add_dtypes = infer_add_dtypes(
            udf, "match", [left.out_schema, right.out_schema]) \
            if props.adds else {}
    return MatchOp(name=_opname(udf, name), udf=udf, left_key=left_key,
                   right_key=right_key, props=props, left=left, right=right,
                   hints=hints, add_dtypes=add_dtypes, anti=anti)


def cross(left: Node, right: Node, udf=None, name: Optional[str] = None,
          mode: str = "auto", props: Optional[UdfProperties] = None,
          hints: Hints = Hints()) -> CrossOp:
    udf = udf or _default_join_udf
    props = analyze_udf(udf, "cross", [left.out_schema, right.out_schema],
                        mode=mode, props=props)
    add_dtypes = infer_add_dtypes(udf, "cross", [left.out_schema, right.out_schema]) \
        if props.adds else {}
    return CrossOp(name=_opname(udf, name), udf=udf, props=props, left=left,
                   right=right, hints=hints, add_dtypes=add_dtypes)


def cogroup(left: Node, right: Node, left_key: Sequence[str],
            right_key: Sequence[str], udf, name: Optional[str] = None,
            mode: str = "auto", props: Optional[UdfProperties] = None,
            hints: Hints = Hints()) -> CoGroupOp:
    left_key, right_key = tuple(left_key), tuple(right_key)
    props = analyze_udf(udf, "cogroup", [left.out_schema, right.out_schema],
                        left_key=left_key, right_key=right_key, mode=mode,
                        props=props)
    add_dtypes = infer_add_dtypes(udf, "cogroup", [left.out_schema, right.out_schema],
                                  left_key=left_key, right_key=right_key) \
        if props.adds else {}
    return CoGroupOp(name=_opname(udf, name), udf=udf, left_key=left_key,
                     right_key=right_key, props=props, left=left, right=right,
                     hints=hints, add_dtypes=add_dtypes)


def global_record(root: Node) -> frozenset:
    """The paper's global record A: every base + intermediate attribute."""
    attrs: set = set()
    for n in root.iter_nodes():
        attrs |= n.attrs()
    return frozenset(attrs)


def sources_of(root: Node) -> list:
    return [n for n in root.iter_nodes() if isinstance(n, Source)]
