"""Entry point: derive UdfProperties + added-attribute dtypes for an operator
(port of `repro.core.sca.analyze`; UDFs run on CPU tensors)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .. import invoke
from ..record import Schema, as_numpy
from ..udf import EagerSegmentOps, UdfProperties
from . import bytecode as _bc
from . import trace_sca as _tr


def _dummy_cols(schema: Schema, n=4) -> dict:
    return {f: _tr.dummy(schema.dtypes[f], n) for f in schema.fields}


def _dummy_collector(udf, kind: str, in_schemas: Sequence[Schema],
                     key=(), left_key=(), right_key=()):
    if kind == "map":
        return invoke.run_map_udf(udf, _dummy_cols(in_schemas[0]))
    if kind in ("match", "cross"):
        return invoke.run_pair_udf(udf, _dummy_cols(in_schemas[0]),
                                   _dummy_cols(in_schemas[1]))
    if kind == "reduce":
        seg = EagerSegmentOps(np.array([0, 2]), 4, np.array([0, 0, 1, 1]))
        return invoke.run_kat_udf(udf, _dummy_cols(in_schemas[0]), seg, key)
    if kind == "cogroup":
        seg = EagerSegmentOps(np.array([0, 2]), 4, np.array([0, 0, 1, 1]))
        segr = EagerSegmentOps(np.array([0, 2]), 4, np.array([0, 0, 1, 1]))
        return invoke.run_cogroup_udf(udf, _dummy_cols(in_schemas[0]), seg,
                                      _dummy_cols(in_schemas[1]), segr,
                                      left_key, right_key)
    raise ValueError(f"unknown udf kind {kind!r}")


def infer_add_dtypes(udf, kind: str, in_schemas: Sequence[Schema],
                     key=(), left_key=(), right_key=()) -> dict:
    """Dtypes of newly-created attributes, from a tiny eager dummy run."""
    col = _dummy_collector(udf, kind, in_schemas, key, left_key, right_key)
    known = set()
    for s in in_schemas:
        known |= set(s.fields)
    dtypes = {}
    for em in col.emissions:
        if em.builder is None:
            continue
        for f, v in em.builder.columns().items():
            if f not in known:
                dtypes[f] = as_numpy(v).dtype
    return dtypes


def analyze_udf(udf, kind: str, in_schemas: Sequence[Schema],
                key: Sequence[str] = (), left_key: Sequence[str] = (),
                right_key: Sequence[str] = (), mode: str = "auto",
                props: Optional[UdfProperties] = None) -> UdfProperties:
    """Derive operator properties.

    mode: 'manual' (props must be given), 'bytecode', 'trace', or 'auto'
    (tracing with bytecode fallback — mirrors the paper's "annotations or
    SCA").
    """
    if props is not None or mode == "manual":
        if props is None:
            raise ValueError("mode='manual' requires explicit props")
        return props

    if mode in ("trace", "auto"):
        try:
            if kind == "map":
                p = _tr.analyze_map(udf, in_schemas[0])
            elif kind == "reduce":
                p = _tr.analyze_reduce(udf, in_schemas[0], key)
            elif kind in ("match", "cross"):
                p = _tr.analyze_pair(udf, in_schemas[0], in_schemas[1],
                                     left_key, right_key)
            elif kind == "cogroup":
                p = _tr.analyze_cogroup(udf, in_schemas[0], in_schemas[1],
                                        left_key, right_key)
            else:
                raise ValueError(f"unknown udf kind {kind!r}")
            # schema reflection is invisible to tracing; OR-in the cheap
            # bytecode check so schema-changing rewrites stay blocked.  A
            # schema-reflecting UDF must also lose any combine recipe: the
            # merge replay presents the ORIGINAL field list, which a
            # rewritten plan may have changed under it.
            if _bc.is_schema_dependent(udf):
                import dataclasses

                p = dataclasses.replace(p, schema_dependent=True,
                                        combine=None)
            return p
        except Exception:
            if mode == "trace":
                raise

    # bytecode fallback / explicit bytecode mode
    import dataclasses

    in_fields: list = []
    for s in in_schemas:
        in_fields += list(s.fields)
    kat = kind in ("reduce", "cogroup")
    keys = tuple(key) + tuple(left_key) + tuple(right_key)
    props = _bc.analyze(udf, in_fields, kat=kat, key_fields=keys)
    if kind == "reduce" and props.combine is not None:
        # the static claim is only a candidate: re-derive the recipe from the
        # eager probe and keep it only if differential verification passes
        from . import decompose

        props = dataclasses.replace(
            props, combine=decompose.detect(udf, in_schemas[0], key, props))
    if kind == "match":
        # Match keys join the conceptual f' read set (Sec. 4.3.1)
        props = dataclasses.replace(
            props, reads=props.reads | frozenset(left_key) | frozenset(right_key))

    # Refine drops from a tiny eager dummy run (the UDF's single vectorized
    # path reveals which input fields its emissions actually carry); keeps
    # the derived output schema exact even for partial implicit copies.
    try:
        col = _dummy_collector(udf, kind, in_schemas, key, left_key, right_key)
        in_set = frozenset(in_fields)
        emitted: set = set()
        for em in col.emissions:
            if em.records and em.builder is None:
                emitted |= in_set
            elif em.builder is not None:
                emitted |= set(em.builder.columns())
        if col.emissions:
            extra_drops = in_set - emitted
            props = dataclasses.replace(
                props, drops=props.drops | extra_drops,
                writes=props.writes | extra_drops)
    except Exception:
        pass  # keep the purely static (conservative) estimate
    return props
