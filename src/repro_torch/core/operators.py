"""PACT operator tree nodes (Sec. 2.3).

Five second-order functions — Map, Reduce (KAT), Cross, Match, CoGroup (KAT)
— plus Source.  Nodes are immutable; rewrites build new trees sharing
subtrees.  Every node carries its resolved output schema, so the enumerator
and the conflict checks can reason about which attributes live where
(`attrs(subtree)` in Theorems 3/4 and Lemma 1).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Sequence

import numpy as np

from .record import Schema
from .udf import Card, KatEmit, UdfProperties

_ids = itertools.count()

# ---------------------------------------------------------------------------
# Hash-consed structural identity (DESIGN.md §2)
#
# Every node carries a lazily computed, cached *structural id*: an interned
# integer assigned per distinct (name, child ids) shape.  Two nodes have the
# same id iff their `canonical()` strings are equal, so memo tables in the
# enumerator, the cardinality estimator and the physical optimizer key on an
# O(1) integer instead of rebuilding an O(tree) string per lookup.  The id is
# stored directly in the instance `__dict__` (bypassing the frozen-dataclass
# guard); `dataclasses.replace` and `with_children` build fresh instances, so
# a cached id can never go stale.
# ---------------------------------------------------------------------------
_STRUCT_KEYS: dict = {}
_COMMUTE_KEYS: dict = {}


def intern_struct_key(name: str, child_sids: tuple) -> int:
    """Interned id for the shape `name(children...)` given child ids.

    Exposed so rewrite engines can compute the id of a candidate tree
    *before* allocating it (true hash-consing: no allocation for shapes that
    were already built)."""
    key = (name, child_sids)
    sid = _STRUCT_KEYS.get(key)
    if sid is None:
        sid = len(_STRUCT_KEYS)
        _STRUCT_KEYS[key] = sid
    return sid


def struct_id(node: "Node") -> int:
    """O(1) amortized structural id of `node` (cached on the instance)."""
    sid = node.__dict__.get("_sid")
    if sid is None:
        sid = intern_struct_key(
            node.name, tuple(struct_id(c) for c in node.children))
        node.__dict__["_sid"] = sid
    return sid


def intern_commute_key(name: str, child_cids: tuple,
                       ordered: bool = False) -> int:
    """Interned side-order-insensitive id for `name(children...)` given the
    children's commute ids (sorted here, so caller order is irrelevant).

    `ordered=True` keeps the caller's child order — used for operators whose
    argument order IS semantic (an anti Match preserves only its left side,
    so its two orientations must never share a commute class)."""
    key = (name, child_cids if ordered else tuple(sorted(child_cids)))
    cid = _COMMUTE_KEYS.get(key)
    if cid is None:
        cid = len(_COMMUTE_KEYS)
        _COMMUTE_KEYS[key] = cid
    return cid


def commute_ordered(node: "Node") -> bool:
    """Does `node`'s commute id depend on child order?  True only for ops
    whose semantics are side-asymmetric (anti joins)."""
    return getattr(node, "anti", False)


def commute_id(node: "Node") -> int:
    """Side-order-insensitive structural id (children sorted): two plans that
    differ only in Match/Cross/CoGroup argument order share one id."""
    cid = node.__dict__.get("_cid")
    if cid is None:
        cid = intern_commute_key(
            node.name, tuple(commute_id(c) for c in node.children),
            ordered=commute_ordered(node))
        node.__dict__["_cid"] = cid
    return cid


# caches stored on instances that must not leak into structural clones
_NODE_CACHE_KEYS = ("_sid", "_cid", "_attrs", "_effr", "_effw", "_pres",
                    "_hascomb")


def shallow_clone(node: "Node") -> tuple["Node", dict]:
    """Uninitialized copy of `node` (caches stripped) plus its live field
    dict, for constructing structural variants without re-running
    `__post_init__`.  Mutate the returned dict, not the instance — frozen
    dataclasses block `__setattr__` but share the plain `__dict__`."""
    new = object.__new__(type(node))
    d = new.__dict__
    d.update(node.__dict__)
    for k in _NODE_CACHE_KEYS:
        d.pop(k, None)
    return new, d


def replace_child(parent: "Node", idx: int, child: "Node") -> Optional["Node"]:
    """`parent` with `child` substituted at position `idx`.

    Fast path: when the substitute exposes the same output ATTRIBUTE SET as
    the node it replaces (every enumerator rewrite is attribute-preserving,
    and attribute names are globally unique, so schema field order carries no
    meaning), the parent's resolved schema still applies; we clone the
    instance dict and skip `__post_init__` re-validation entirely.  Otherwise
    falls back to the validating `with_children` (returning None on schema
    conflicts)."""
    old = parent.children[idx]
    if old.out_schema is child.out_schema or old.attrs() == child.attrs():
        new, d = shallow_clone(parent)
        if "child" in d:
            d["child"] = child
        else:
            d["left" if idx == 0 else "right"] = child
        return new
    kids = list(parent.children)
    kids[idx] = child
    try:
        return parent.with_children(*kids)
    except (ValueError, KeyError):
        return None


def combine_binary(parent: "Node", left: "Node",
                   right: "Node") -> Optional["Node"]:
    """`parent` re-rooted over `(left, right)` — the rotation work-horse.

    Fast path for implicit-copy UDFs with no adds/drops (the common join):
    the output schema is just the concatenation of the input schemas, and the
    caller (rotation guard) has already established that the operator only
    references attributes of the new inputs, so validation is skipped.
    Everything else goes through the validating `with_children`."""
    p = parent.props
    if getattr(p, "implicit_copy", False) and not p.adds and not p.drops \
            and not getattr(parent, "anti", False):
        ls, rs = left.out_schema, right.out_schema
        new, d = shallow_clone(parent)
        d["left"] = left
        d["right"] = right
        d["out_schema"] = Schema(ls.fields + rs.fields,
                                 {**ls.dtypes, **rs.dtypes})
        return new
    try:
        return parent.with_children(left, right)
    except (ValueError, KeyError):
        return None


@dataclasses.dataclass(frozen=True)
class Hints:
    """Per-operator cost hints (paper Sec. 7.1: 'Average Number of Records
    Emitted per UDF Call', 'CPU Cost per UDF Call', 'Number of Distinct
    Values per Key-Set', PK/FK knowledge)."""

    selectivity: Optional[float] = None      # emitted/input records (RAT)
    distinct_keys: Optional[int] = None      # KAT ops
    cpu_flops_per_record: float = 32.0
    join_fanout: Optional[float] = None      # avg matches per probe record
    pk_side: Optional[str] = None            # 'left'|'right': unique-key side
    group_selectivity: Optional[float] = None  # KAT group-filter survival rate


class Node:
    """Base class; subclasses are frozen dataclasses."""

    name: str
    out_schema: Schema

    @property
    def children(self) -> tuple:
        return ()

    @property
    def is_unary(self) -> bool:
        return len(self.children) == 1

    @property
    def is_binary(self) -> bool:
        return len(self.children) == 2

    @property
    def is_kat(self) -> bool:
        return isinstance(self, (ReduceOp, CoGroupOp))

    def with_children(self, *children: "Node") -> "Node":
        raise NotImplementedError

    def attrs(self) -> frozenset:
        # cached: the reorder guards and property propagation call this on
        # every node of every candidate rewrite
        a = self.__dict__.get("_attrs")
        if a is None:
            a = frozenset(self.out_schema.fields)
            self.__dict__["_attrs"] = a
        return a

    # -- pretty printing -----------------------------------------------------
    def pretty(self, indent: int = 0) -> str:
        pad = "  " * indent
        line = f"{pad}{type(self).__name__}[{self.name}]"
        if isinstance(self, (ReduceOp, CoGroupOp, MatchOp)):
            line += f" key={getattr(self, 'key', getattr(self, 'left_key', None))}"
        lines = [line]
        for c in self.children:
            lines.append(c.pretty(indent + 1))
        return "\n".join(lines)

    def iter_nodes(self):
        yield self
        for c in self.children:
            yield from c.iter_nodes()

    def op_names(self) -> tuple:
        return tuple(n.name for n in self.iter_nodes())

    def canonical(self) -> str:
        """Structural key for memo tables / plan dedup."""
        if not self.children:
            return self.name
        inner = ",".join(c.canonical() for c in self.children)
        return f"{self.name}({inner})"


@dataclasses.dataclass(frozen=True)
class Source(Node):
    name: str
    out_schema: Schema
    num_records: int = 1000
    partitioned_on: Optional[tuple] = None
    sorted_on: Optional[tuple] = None

    def with_children(self, *children: Node) -> "Source":
        assert not children
        return self


def _check_fields(name: str, need: Sequence[str], have: frozenset, what: str):
    missing = [f for f in need if f not in have]
    if missing:
        raise ValueError(f"operator {name!r}: {what} fields {missing} not in input schema")


def _rat_out_schema(name: str, props: UdfProperties, in_schema: Schema,
                    add_dtypes: dict) -> Schema:
    if props.implicit_copy:
        fields = [f for f in in_schema.fields if f not in props.drops]
    else:
        carried = (props.writes | props.copies) - props.adds - props.drops
        fields = [f for f in in_schema.fields if f in carried]
    dtypes = {f: in_schema.dtypes[f] for f in fields}
    for f in sorted(props.adds):
        if f in dtypes:
            raise ValueError(f"operator {name!r} adds existing attribute {f!r}")
        fields.append(f)
        dtypes[f] = np.dtype(add_dtypes.get(f, np.float32))
    return Schema(tuple(fields), dtypes)


@dataclasses.dataclass(frozen=True)
class MapOp(Node):
    name: str
    udf: object
    props: UdfProperties
    child: Node
    hints: Hints = dataclasses.field(default_factory=Hints)
    add_dtypes: dict = dataclasses.field(default_factory=dict)
    out_schema: Schema = None

    def __post_init__(self):
        _check_fields(self.name, sorted(self.props.reads | (self.props.writes - self.props.adds)),
                      self.child.attrs(), "read/write")
        object.__setattr__(self, "out_schema",
                           _rat_out_schema(self.name, self.props,
                                           self.child.out_schema, self.add_dtypes))

    @property
    def children(self):
        return (self.child,)

    def with_children(self, *children: Node) -> "MapOp":
        (c,) = children
        return dataclasses.replace(self, child=c)


@dataclasses.dataclass(frozen=True)
class ReduceOp(Node):
    name: str
    udf: object
    key: tuple
    props: UdfProperties
    child: Node
    hints: Hints = dataclasses.field(default_factory=Hints)
    add_dtypes: dict = dataclasses.field(default_factory=dict)
    # True for the local pre-aggregation half of a split Reduce: its output
    # is a sound PARTIAL aggregate on ANY partition of its input, so the
    # physical layer may run it per worker with no repartition (the merge
    # half above re-establishes the global grouping).
    combiner: bool = False
    out_schema: Schema = None

    def __post_init__(self):
        _check_fields(self.name, self.key, self.child.attrs(), "key")
        _check_fields(self.name, sorted(self.props.reads | (self.props.writes - self.props.adds)),
                      self.child.attrs() | frozenset(self.key), "read/write")
        object.__setattr__(self, "out_schema",
                           _rat_out_schema(self.name, self.props,
                                           self.child.out_schema, self.add_dtypes))

    @property
    def children(self):
        return (self.child,)

    def with_children(self, *children: Node) -> "ReduceOp":
        (c,) = children
        return dataclasses.replace(self, child=c)


_LIMIT_PROPS_CACHE: dict = {}


def _limit_props(key: tuple) -> UdfProperties:
    """Synthesized properties of a WITH-TIES top-k: reads its sort key,
    writes nothing, emits each input record at most once.  The survival
    decision is GLOBAL (it depends on the whole input multiset, not the
    record alone), so `filter_fields` carries a sentinel attribute that can
    never be covered by a key — `satisfies_kgp` must stay False for every
    key set even though the cardinality looks like a filter's."""
    p = _LIMIT_PROPS_CACHE.get(key)
    if p is None:
        p = UdfProperties(reads=frozenset(key), writes=frozenset(),
                          adds=frozenset(), drops=frozenset(),
                          implicit_copy=True, card=Card.AT_MOST_ONE,
                          filter_fields=frozenset(("__limit_global__",)),
                          source="builtin")
        _LIMIT_PROPS_CACHE[key] = p
    return p


@dataclasses.dataclass(frozen=True)
class LimitOp(Node):
    """WITH-TIES top-k by `key` (ascending, lexicographic): emit every record
    whose key ranks <= k-th smallest among the input — a deterministic
    multiset function of the input multiset, independent of physical order,
    so it commutes freely with plan rewrites below it."""

    name: str
    k: int
    key: tuple
    child: Node
    hints: Hints = dataclasses.field(default_factory=Hints)
    props: UdfProperties = None
    out_schema: Schema = None

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"limit {self.name!r}: k must be >= 1")
        _check_fields(self.name, self.key, self.child.attrs(), "key")
        object.__setattr__(self, "out_schema", self.child.out_schema)
        if self.props is None:
            object.__setattr__(self, "props", _limit_props(self.key))

    @property
    def children(self):
        return (self.child,)

    def with_children(self, *children: Node) -> "LimitOp":
        (c,) = children
        return dataclasses.replace(self, child=c, out_schema=None)


def _binary_out_schema(name: str, props: UdfProperties, left: Schema, right: Schema,
                       add_dtypes: dict) -> Schema:
    joint = left.union(right)
    return _rat_out_schema(name, props, joint, add_dtypes)


@dataclasses.dataclass(frozen=True)
class MatchOp(Node):
    name: str
    udf: object
    left_key: tuple
    right_key: tuple
    props: UdfProperties
    left: Node
    right: Node
    hints: Hints = dataclasses.field(default_factory=Hints)
    add_dtypes: dict = dataclasses.field(default_factory=dict)
    # Anti-join mode: emit exactly the LEFT records that have NO key partner
    # on the right.  The UDF is never invoked (there is no pair to pass it);
    # the output schema is the left input's schema, and argument order is
    # semantic — commute/rotate rewrites are rejected by their guards and the
    # commute id keeps child order (see `intern_commute_key(ordered=True)`).
    anti: bool = False
    out_schema: Schema = None

    def __post_init__(self):
        _check_fields(self.name, self.left_key, self.left.attrs(), "left key")
        _check_fields(self.name, self.right_key, self.right.attrs(), "right key")
        if len(self.left_key) != len(self.right_key):
            raise ValueError(f"match {self.name!r}: key arity mismatch")
        if self.anti:
            out = self.left.out_schema
        else:
            out = _binary_out_schema(self.name, self.props,
                                     self.left.out_schema,
                                     self.right.out_schema, self.add_dtypes)
        object.__setattr__(self, "out_schema", out)

    @property
    def children(self):
        return (self.left, self.right)

    def with_children(self, *children: Node) -> "MatchOp":
        l, r = children
        return dataclasses.replace(self, left=l, right=r)

    def key_attrs(self) -> frozenset:
        return frozenset(self.left_key) | frozenset(self.right_key)


@dataclasses.dataclass(frozen=True)
class CrossOp(Node):
    name: str
    udf: object
    props: UdfProperties
    left: Node
    right: Node
    hints: Hints = dataclasses.field(default_factory=Hints)
    add_dtypes: dict = dataclasses.field(default_factory=dict)
    out_schema: Schema = None

    def __post_init__(self):
        object.__setattr__(self, "out_schema",
                           _binary_out_schema(self.name, self.props,
                                              self.left.out_schema, self.right.out_schema,
                                              self.add_dtypes))

    @property
    def children(self):
        return (self.left, self.right)

    def with_children(self, *children: Node) -> "CrossOp":
        l, r = children
        return dataclasses.replace(self, left=l, right=r)

    def key_attrs(self) -> frozenset:
        return frozenset()


@dataclasses.dataclass(frozen=True)
class CoGroupOp(Node):
    name: str
    udf: object
    left_key: tuple
    right_key: tuple
    props: UdfProperties
    left: Node
    right: Node
    hints: Hints = dataclasses.field(default_factory=Hints)
    add_dtypes: dict = dataclasses.field(default_factory=dict)
    out_schema: Schema = None

    def __post_init__(self):
        _check_fields(self.name, self.left_key, self.left.attrs(), "left key")
        _check_fields(self.name, self.right_key, self.right.attrs(), "right key")
        object.__setattr__(self, "out_schema",
                           _binary_out_schema(self.name, self.props,
                                              self.left.out_schema, self.right.out_schema,
                                              self.add_dtypes))

    @property
    def children(self):
        return (self.left, self.right)

    def with_children(self, *children: Node) -> "CoGroupOp":
        l, r = children
        return dataclasses.replace(self, left=l, right=r)

    def key_attrs(self) -> frozenset:
        return frozenset(self.left_key) | frozenset(self.right_key)


def flow_valid(node: Node) -> bool:
    """Defense-in-depth: every operator's reads/writes/keys must be resolvable
    against its (possibly rewritten) input schemas."""
    try:
        rebuild(node)
        return True
    except (ValueError, KeyError):
        return False


def rebuild(node: Node) -> Node:
    """Re-run schema propagation bottom-up (validates a rewritten tree)."""
    if not node.children:
        return node
    return node.with_children(*[rebuild(c) for c in node.children])
