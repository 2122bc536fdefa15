"""CPython-bytecode UDF analysis — the faithful port of the paper's Sec. 5.

The paper analyses Java 3-address code with Soot, collecting `getField` /
`setField` / constructor / `emit` statements and USE-DEF chains.  CPython
bytecode is an equivalent stack IR; we scan `dis` instructions for the record
API calls:

    view.get("f")        -> read-set candidate
    builder.set("f", v)  -> write (explicit copy `set("f", get("f"))` detected
                            and excluded, as in the paper)
    builder.drop("f")    -> explicit projection
    ir.copy()/concat()/group.first() -> Implicit Copy
    empty()              -> Implicit Projection (safe choice if both appear)
    out.emit(..., where=m) / out.emit_records(...) -> cardinality classes

Safety through conservatism (paper Sec. 5): whenever the analysis cannot
resolve a statement it over-approximates — unresolvable `get` adds *all*
input attributes to the read set; any conditional branch downgrades ONE to
AT_MOST_ONE with filter_fields = the whole read set; any loop forces MANY.
Field names must be static constants (the paper makes the same assumption
for field indices); a dynamic `set` name is rejected because no output
schema could be derived for it.
"""

from __future__ import annotations

import dis
from typing import Optional, Sequence

from ..udf import Card, CombineRecipe, KatEmit, UdfProperties

_READ_METHODS = {"get", "sum", "max", "min", "mean"}
_AGG_METHODS = ("sum", "max", "min", "mean", "count")  # decomposable kinds
# methods whose semantics do not compose across partitions of a group
_NONDECOMPOSABLE_METHODS = {"any", "all", "broadcast", "first", "first_of",
                            "record_builder", "copy", "concat"}
_GROUP_READ_METHODS = {"any", "all", "broadcast", "count"}
_COPY_METHODS = {"copy", "concat", "first", "record_builder"}
_PROJ_METHODS = {"keys"}  # implicit projection to the key fields
_LOOP_OPS = {"FOR_ITER", "JUMP_BACKWARD", "JUMP_BACKWARD_NO_INTERRUPT"}
_BRANCH_OPS = {"POP_JUMP_IF_TRUE", "POP_JUMP_IF_FALSE", "POP_JUMP_IF_NONE",
               "POP_JUMP_IF_NOT_NONE", "JUMP_IF_TRUE_OR_POP", "JUMP_IF_FALSE_OR_POP"}


class _Analysis:
    def __init__(self):
        self.reads: set = set()
        self.writes: set = set()
        self.drops: set = set()
        self.unresolved_get = False
        self.implicit_copy = False
        self.implicit_projection = False
        self.emit_sites: list = []       # (kind, has_where) kind in {'emit','emit_records'}
        self.has_loop = False
        self.has_branch = False
        self.set_names: set = set()
        self.explicit_copies: set = set()
        self.uses_first = False
        self.schema_dependent = False
        self.agg_sites: list = []        # decomposable agg kinds, call order
        self.agg_set_cols: dict = {}     # set-name -> agg kind (adjacency)
        self.nondecomposable = False     # any method outside the agg kinds


def _next_const_str(instrs, i) -> Optional[str]:
    """Static field name: the record-API calling convention pushes the name
    as the FIRST argument, so it must be the LOAD_CONST immediately after the
    method load — anything else is a dynamic (unresolvable) name."""
    if i + 1 < len(instrs):
        ins = instrs[i + 1]
        if ins.opname == "LOAD_CONST" and isinstance(ins.argval, str):
            return ins.argval
    return None


def _scan(code) -> _Analysis:
    a = _Analysis()
    instrs = list(dis.get_instructions(code))
    for i, ins in enumerate(instrs):
        op = ins.opname
        if op in _LOOP_OPS:
            a.has_loop = True
        if op in _BRANCH_OPS:
            a.has_branch = True
        if op in ("LOAD_ATTR", "LOAD_METHOD"):
            meth = ins.argval
            if meth == "fields":
                a.schema_dependent = True
            if meth in _AGG_METHODS:
                a.agg_sites.append(meth)
            if meth in _NONDECOMPOSABLE_METHODS:
                a.nondecomposable = True
            if meth in _READ_METHODS:
                name = _next_const_str(instrs, i)
                if name is None:
                    if meth == "get":
                        a.unresolved_get = True
                    # aggregates may legitimately take array args; those reads
                    # are captured at the producing `get`
                else:
                    a.reads.add(name)
            elif meth in _COPY_METHODS:
                a.implicit_copy = True
                if meth == "first":
                    a.uses_first = True
            elif meth in _PROJ_METHODS:
                a.implicit_projection = True
            elif meth == "set":
                name = _next_const_str(instrs, i)
                if name is None:
                    raise ValueError(
                        "bytecode SCA: dynamic field name in set(); field names "
                        "must be static constants (paper Sec. 5 assumption)")
                a.set_names.add(name)
                # decomposable-agg adjacency: set("f", g.<agg>(...)) — the
                # first method load after the name decides the column's kind
                for j in range(i + 1, min(i + 4, len(instrs))):
                    nj = instrs[j]
                    if nj.opname in ("LOAD_ATTR", "LOAD_METHOD"):
                        if nj.argval in _AGG_METHODS:
                            a.agg_set_cols[name] = nj.argval
                        break
                # explicit-copy pattern: set("f", <view>.get("f")) with the
                # value UNMODIFIED — the get's CALL must feed the 2-arg set
                # CALL directly (any op in between means a modification).
                for j in range(i + 1, min(i + 8, len(instrs))):
                    nj = instrs[j]
                    if nj.opname in ("LOAD_ATTR", "LOAD_METHOD") and nj.argval == "get":
                        inner = _next_const_str(instrs, j)
                        if inner == name and j + 3 < len(instrs):
                            inner_call, outer_call = instrs[j + 2], instrs[j + 3]
                            if (inner_call.opname == "CALL"
                                    and inner_call.arg == 1
                                    and outer_call.opname == "CALL"
                                    and outer_call.arg == 2):
                                a.explicit_copies.add(name)
                        break
                    if nj.opname.startswith("CALL") and nj.arg == 2:
                        break
            elif meth == "drop":
                name = _next_const_str(instrs, i)
                if name is None:
                    raise ValueError("bytecode SCA: dynamic field name in drop()")
                a.drops.add(name)
            elif meth in ("emit", "emit_records"):
                # Scan to the end of the emit *statement* (POP_TOP / RETURN):
                # inner calls like `ir.copy()` may occur before the kwarg
                # names tuple of the outer CALL_KW.
                has_where = False
                for j in range(i + 1, min(i + 64, len(instrs))):
                    nj = instrs[j]
                    if nj.opname == "LOAD_CONST" and isinstance(nj.argval, tuple) \
                            and "where" in nj.argval:
                        has_where = True
                    if nj.opname == "KW_NAMES" and "where" in (nj.argval or ()):
                        has_where = True
                    if nj.opname in ("POP_TOP",) or nj.opname.startswith("RETURN"):
                        break
                a.emit_sites.append((meth, has_where))
        if op == "LOAD_GLOBAL" and ins.argval == "empty":
            a.implicit_projection = True
    return a


def analyze(udf, in_fields: Sequence[str], kat: bool = False,
            key_fields: Sequence[str] = ()) -> UdfProperties:
    """Conservative properties from bytecode alone (no execution)."""
    a = _scan(udf.__code__)
    in_set = frozenset(in_fields)
    key_set = frozenset(key_fields)

    reads = set(a.reads) & in_set if not a.unresolved_get else set(in_set)
    if a.unresolved_get:
        pass  # all input attributes are potentially read
    adds = {f for f in a.set_names if f not in in_set}
    # explicit copies do not modify; key-first is identity when never set
    modified = (a.set_names - a.explicit_copies) | a.drops
    writes = (modified & in_set) | adds | (a.drops & in_set)
    if kat:
        # Any per-group ('emit') site consolidates records: conservatively
        # every non-key input attribute may change value (group-first / agg).
        if any(k == "emit" for k, _ in a.emit_sites):
            writes |= in_set - key_set

    # implicit mode: projection is the safe choice when both appear (Sec. 5)
    implicit_copy = a.implicit_copy and not a.implicit_projection

    # cardinality classification
    n_emits = len(a.emit_sites)
    any_where = any(w for _, w in a.emit_sites)
    kat_emit: Optional[KatEmit] = None
    if kat:
        kinds = {k for k, _ in a.emit_sites}
        if a.has_loop or n_emits != 1:
            kat_emit = KatEmit.MANY
        elif kinds == {"emit_records"}:
            kat_emit = (KatEmit.PASSTHROUGH_FILTER if any_where or a.has_branch
                        else KatEmit.PASSTHROUGH)
        else:
            kat_emit = (KatEmit.PER_GROUP_FILTER if any_where or a.has_branch
                        else KatEmit.PER_GROUP)
        card = Card.MANY
        reads |= key_set
    else:
        if a.has_loop or n_emits > 1:
            card = Card.MANY
        elif any_where or a.has_branch or n_emits == 0:
            card = Card.AT_MOST_ONE
        else:
            card = Card.ONE

    filter_fields = frozenset(reads) if (any_where or a.has_branch) else frozenset()

    # Decomposability CANDIDATE (safety through conservatism): claimed only
    # for straight-line, keys()-projecting, single per-group emissions whose
    # only record access beyond get() goes through decomposable aggregates.
    # `analyze_udf` verifies the candidate differentially before the recipe
    # may enable the split-Reduce rewrite — the static claim alone never does.
    combine = None
    if kat and kat_emit is KatEmit.PER_GROUP and not a.nondecomposable \
            and not a.has_loop and not a.has_branch and not a.schema_dependent \
            and not a.unresolved_get and a.implicit_projection:
        cols = tuple((k, "key") for k in key_fields) + tuple(
            (n, a.agg_set_cols.get(n, "expr")) for n in sorted(a.set_names))
        combine = CombineRecipe(sites=tuple(a.agg_sites), columns=cols)

    return UdfProperties(
        reads=frozenset(reads), writes=frozenset(writes), adds=frozenset(adds),
        drops=frozenset(a.drops), implicit_copy=implicit_copy, card=card,
        filter_fields=filter_fields, kat_emit=kat_emit,
        copies=frozenset(a.explicit_copies & in_set), source="bytecode-sca",
        schema_dependent=a.schema_dependent, combine=combine)


def is_schema_dependent(udf) -> bool:
    """Cheap scan: does the UDF enumerate its input schema (`view.fields`)?"""
    try:
        return _scan(udf.__code__).schema_dependent
    except Exception:  # builtins / C functions: no schema reflection possible
        return False
