"""Reordering conditions (paper Sec. 4) + local rewrite rules.

The optimizer never looks inside a UDF: every decision below is made from the
`UdfProperties` (read/write sets, emission cardinality, KGP) plus the
operator's keys and schemas.

Effective sets
--------------
We widen the SCA-estimated sets with schema-level facts so conflicts remain
conservative regardless of how the properties were obtained:

* reads of a KAT operator / Match include its key attributes (the paper's
  conceptual ``f'`` transformation, Sec. 4.3.1);
* attributes present in the input schema but absent from the output were
  projected away — projecting conflicts with any reader, so they join the
  write set;
* newly-created attributes (schema diff) join the write set (Def. 2 case 1).

Rewrite rules (each returns a rewritten tree or None):

* ``swap_unary``            Map/Reduce over Map/Reduce            (Thm 1, 2)
* ``push_unary_into_binary``  unary over Match/Cross/CoGroup → into one side
                              (Thm 3, 4 + Lemma-1 machinery + tagged union)
* ``pull_unary_from_binary``  inverse of the above
* ``rotate``                binary-binary associativity           (Lemma 1)
* ``commute``               Match/Cross/CoGroup argument swap

Every rewrite is finally validated by re-running schema propagation
(`rebuild`) — defense-in-depth mirroring the paper's safety property.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .operators import (CoGroupOp, CrossOp, LimitOp, MapOp, MatchOp, Node,
                        ReduceOp, Source, combine_binary, rebuild,
                        replace_child, shallow_clone)
from .udf import Card, KatEmit, UdfProperties


# ---------------------------------------------------------------------------
# Effective read/write sets
# ---------------------------------------------------------------------------
def node_keys(node: Node) -> frozenset:
    if isinstance(node, (ReduceOp, LimitOp)):
        return frozenset(node.key)
    if isinstance(node, (MatchOp, CoGroupOp)):
        return frozenset(node.left_key) | frozenset(node.right_key)
    return frozenset()


def input_attrs(node: Node) -> frozenset:
    s: set = set()
    for c in node.children:
        s |= c.attrs()
    return frozenset(s)


def eff_reads(node: Node) -> frozenset:
    r = node.__dict__.get("_effr")
    if r is None:
        r = node.props.reads | node_keys(node)
        node.__dict__["_effr"] = r
    return r


def eff_writes(node: Node) -> frozenset:
    w = node.__dict__.get("_effw")
    if w is None:
        inp, out = input_attrs(node), node.attrs()
        w = node.props.writes | (inp - out) | (out - inp)
        node.__dict__["_effw"] = w
    return w


def roc(a: Node, b: Node) -> bool:
    """Read-Only Conflict condition (Def. 4) on effective sets."""
    ra, wa = eff_reads(a), eff_writes(a)
    rb, wb = eff_reads(b), eff_writes(b)
    return not (ra & wb) and not (wa & rb) and not (wa & wb)


def kgp(node: Node, key: frozenset) -> bool:
    """Key Group Preservation (Def. 5) of `node` w.r.t. attribute set `key`.

    RAT cases delegate to the UDF properties (|f(r)|=1, or a filter whose
    decision fields lie within `key`).  A KAT *passthrough* operator emits
    or drops whole own-key groups: Def. 5 case 2 holds for any `key` that
    refines its own grouping (own_key ⊆ key ⇒ every key-group lies inside
    one own-group and is kept or dropped atomically).
    """
    key = frozenset(key)
    p = node.props
    if p.kat_emit is KatEmit.PASSTHROUGH:
        return True
    if p.kat_emit is KatEmit.PASSTHROUGH_FILTER:
        own = node_keys(node)
        return own <= key
    return p.satisfies_kgp(key)


def _is_unary_op(n: Node) -> bool:
    return isinstance(n, (MapOp, ReduceOp))


def _is_binary_op(n: Node) -> bool:
    return isinstance(n, (MatchOp, CrossOp, CoGroupOp))


def _valid(tree: Optional[Node], like: Optional[Node] = None) -> Optional[Node]:
    """Require the rewritten subtree to expose the SAME attribute set as the
    original (`like`) — a projecting operator moved across a binary op would
    otherwise silently change the plan's output schema (e.g. a keys()-Reduce
    pulled above a join).

    Schema propagation itself needs no re-run here: every rewrite assembles
    its result exclusively through `with_children` / `dataclasses.replace`,
    and each node construction already re-resolves and validates that node's
    schema against its (new) children — so all *changed* levels are checked
    at build time, and unchanged subtrees were valid by induction.  Rewrites
    wrap construction in try/except and hand None to `_valid` on conflict."""
    if tree is None:
        return None
    if like is not None and tree.attrs() != like.attrs():
        return None
    return tree


# ---------------------------------------------------------------------------
# Unary-unary swap (Theorems 1 & 2 + Reduce-Reduce)
# ---------------------------------------------------------------------------
def _changes_schema(op: Node) -> bool:
    return input_attrs(op) != op.attrs()


def unary_reorderable(r: Node, s: Node) -> bool:
    """Can unary `r` (currently above) and unary `s` (below) be exchanged?"""
    if not (_is_unary_op(r) and _is_unary_op(s)):
        return False
    if not roc(r, s):
        return False
    # A schema-reflecting UDF must keep its exact input schema (DESIGN.md §3):
    # swapping past a schema-changing neighbour would alter its behaviour.
    if r.props.schema_dependent and _changes_schema(s):
        return False
    if s.props.schema_dependent and _changes_schema(r):
        return False
    # Theorem 2 / Reduce-Reduce: every KAT operator's key groups must be
    # preserved by the other operator.
    if isinstance(r, ReduceOp) and not kgp(s, frozenset(r.key)):
        return False
    if isinstance(s, ReduceOp) and not kgp(r, frozenset(s.key)):
        return False
    return True


def swap_unary(r: Node, s: Node) -> Optional[Node]:
    """`r(s(X))` → `s(r(X))` when Theorem 1/2 conditions hold."""
    if not unary_reorderable(r, s):
        return None
    x = s.children[0]
    # replace_child skips schema re-resolution when the substituted child
    # exposes identical fields (the common case for write-only neighbours)
    inner = replace_child(r, 0, x)
    if inner is None:
        return None
    t = replace_child(s, 0, inner)
    if t is None:
        return None
    return _valid(t, like=r)


# ---------------------------------------------------------------------------
# Unary ↔ binary (Theorems 3 & 4, tagged-union rules, invariant grouping)
# ---------------------------------------------------------------------------
def _side_key(b: Node, side: int) -> frozenset:
    if isinstance(b, (MatchOp, CoGroupOp)):
        return frozenset(b.left_key if side == 0 else b.right_key)
    return frozenset()


def _push_conditions(u: Node, b: Node, side: int) -> bool:
    """Shared guards for moving unary `u` between 'above b' and 'side of b'."""
    if not (_is_unary_op(u) and _is_binary_op(b)):
        return False
    if u.props.schema_dependent:
        return False  # moving across a binary op always changes the schema
    other = b.children[1 - side]
    this = b.children[side]
    refs_u = eff_reads(u) | eff_writes(u)
    # Theorem 3 / Lemma 1: u must not touch the other side's attributes.
    if refs_u & other.attrs():
        return False
    # u must also be expressible against this side alone.
    if not (eff_reads(u) <= this.attrs() and
            (eff_writes(u) - u.props.adds) <= this.attrs()):
        return False
    # ROC with the binary operator's conceptual f' (keys are reads).
    if not roc(u, b):
        return False

    if getattr(b, "anti", False):
        # Anti join: only its LEFT input survives, so a unary moves below the
        # preserved side only — below the right (probe) side it would alter
        # which keys exist rather than which records survive.
        if side != 0:
            return False
        if isinstance(u, MapOp):
            # RAT over the preserved side: the per-record UDF commutes with
            # the per-record "no partner" predicate (ROC already excludes key
            # writes, since the anti's keys are effective reads).
            return True
        if isinstance(u, ReduceOp):
            # Invariant grouping without the PK requirement: when the Reduce
            # key refines the anti key, each group carries ONE key value, so
            # the anti keeps or drops whole groups — and unlike a join, the
            # anti never duplicates records, so no uniqueness is needed on
            # the other side.
            return frozenset(b.left_key) <= frozenset(u.key)
        return False

    if isinstance(u, MapOp):
        if isinstance(b, CoGroupOp):
            # CoGroup ≡ Reduce over tagged union: Theorem 2 would push the
            # Map into BOTH branches of the union.  A single-side push is
            # sound only for strict one-to-one maps (|f(r)| = 1): a filter
            # dropping whole groups on this side is NOT equivalent, because
            # the other side still creates those groups on the union key
            # domain (group-filter semantics differ above vs below); record
            # duplication likewise changes per-group aggregates.  Key writes
            # are already excluded by ROC (the CoGroup reads its keys).
            return u.props.card is Card.ONE and kgp(u, _side_key(b, side))
        if isinstance(b, (MatchOp, CrossOp)):
            return True  # RAT: Theorem 1 + Theorem 3 suffice
        return False

    if isinstance(u, ReduceOp):
        rkey = frozenset(u.key)
        if isinstance(b, MatchOp):
            # Invariant grouping (Sec. 4.3.2): Reduce key must contain the
            # match key of its side, and the other side must be the PK side of
            # a PK-FK join so key groups survive the join intact.
            mkey = frozenset(b.left_key if side == 0 else b.right_key)
            pk = b.hints.pk_side
            pk_other = (pk == ("right" if side == 0 else "left"))
            return mkey <= rkey and pk_other
        if isinstance(b, CrossOp):
            # Theorem 4: the whole other input must be functionally constant
            # per group — only safe when the Reduce key covers all of this
            # side's join-relevant attrs AND the other side is a single record.
            return isinstance(other, Source) and other.num_records == 1
        return False
    return False


def _extend_reduce(u: ReduceOp, extra: frozenset,
                   child: Node) -> ReduceOp:
    """Non-intrusive UDF extension (paper Sec. 4.3.2 invariant grouping):
    wrap the Reduce UDF so per-group emissions additionally pass through the
    `extra` attributes as group-firsts, re-rooted over `child` (whose schema
    must supply `extra`).  Sound ONLY when every attribute in `extra` is
    group-constant — the caller guarantees this via the PK-join guard.  The
    wrapper records the original so a later push-down unwraps."""
    orig_udf, orig_props = u.udf, u.props
    extra = frozenset(extra)

    def extended(g, out):
        from .udf import Collector

        proxy = Collector()
        orig_udf(g, proxy)
        for em in proxy.emissions:
            if not em.records and em.builder is not None:
                for f in extra:
                    if f not in em.builder.columns():
                        em.builder.set(f, g.first_of(f))
                    em.builder.set_fields.discard(f)  # pass-through, not write
            out.emissions.append(em)

    extended.__name__ = getattr(orig_udf, "__name__", "udf") + "_ext"
    extended.__reduce_extension__ = (orig_udf, orig_props, extra)
    # The pass-through READS `extra` (group-firsts), unlike a true identity
    # copy: without this, a later swap could lift the extended Reduce above
    # the very operator that creates one of these fields (attrs match again
    # at the root, so `_valid` alone cannot catch it) and crash at runtime.
    props = dataclasses.replace(
        orig_props,
        reads=orig_props.reads | extra,
        writes=orig_props.writes - extra,
        drops=orig_props.drops - extra,
        copies=orig_props.copies | extra)
    return dataclasses.replace(u, udf=extended, props=props, child=child,
                               out_schema=None)


def _strip_reduce_extension(u: ReduceOp, other_attrs: frozenset):
    """Inverse of `_extend_reduce` when pushing back below the join."""
    ext = getattr(u.udf, "__reduce_extension__", None)
    if ext is None:
        return u
    orig_udf, orig_props, extra = ext
    if not (extra <= other_attrs):
        return u
    return dataclasses.replace(u, udf=orig_udf, props=orig_props,
                               out_schema=None)


def push_unary_into_binary(u: Node, b: Node, side: int) -> Optional[Node]:
    """`u(b(L, R))` → `b(u(L), R)` (side=0) or `b(L, u(R))` (side=1)."""
    original = u
    if isinstance(u, ReduceOp):
        u = _strip_reduce_extension(u, b.children[1 - side].attrs())
    if not _push_conditions(u, b, side):
        return None
    kids = list(b.children)
    try:
        kids[side] = u.with_children(kids[side])
        return _valid(b.with_children(*kids), like=original)
    except (ValueError, KeyError):
        return None


def pull_unary_from_binary(b: Node, side: int) -> Optional[Node]:
    """`b(..., u(X), ...)` → `u(b(..., X, ...))` — inverse rewrite.

    A projecting Reduce (e.g. keys()-style aggregation) pulled above a
    PK-join is extended with group-constant pass-through of the other
    side's attributes so the plan's output schema is preserved."""
    u = b.children[side]
    if not _is_unary_op(u):
        return None
    x = u.children[0]
    kids = list(b.children)
    kids[side] = x
    try:
        new_b = b.with_children(*kids)
    except (ValueError, KeyError):
        return None
    if not _push_conditions(u, new_b, side):
        return None
    if isinstance(u, ReduceOp):
        missing = b.attrs() - u.attrs() - u.props.adds
        other_attrs = new_b.children[1 - side].attrs()
        extra = missing & other_attrs
        if extra and u.props.kat_emit is not None \
                and u.props.kat_emit.name.startswith("PER_GROUP"):
            try:
                return _valid(_extend_reduce(u, extra, new_b), like=b)
            except (ValueError, KeyError):
                return None
    try:
        return _valid(u.with_children(new_b), like=b)
    except (ValueError, KeyError):
        return None


# ---------------------------------------------------------------------------
# Decomposable-aggregation splitting (combiner + merge) and eager push-down
# ---------------------------------------------------------------------------
def _combiner_node(name: str, orig_udf, recipe, key: tuple, reads: frozenset,
                   child: Node, hints, source: str) -> Optional[ReduceOp]:
    """A combiner ReduceOp for `orig_udf`/`recipe` over `child`'s schema, or
    None when the UDF's reads / keys / partial names don't fit that schema."""
    from .sca import decompose as D

    key_set = frozenset(key)
    attrs = child.attrs()
    if not key_set <= attrs or not frozenset(reads) <= attrs | key_set:
        return None
    partials = recipe.partial_fields(D.PARTIAL_PREFIX)
    if set(partials) & attrs:
        return None  # partial-column name collision with a live attribute
    try:
        pdt = D.partial_dtypes(orig_udf, recipe, child.out_schema, key)
    except Exception:
        return None
    props = UdfProperties(
        reads=frozenset(reads) | key_set,
        writes=frozenset(partials) | (attrs - key_set),
        adds=frozenset(partials),
        drops=attrs - key_set,
        implicit_copy=False, card=Card.MANY, filter_fields=frozenset(),
        kat_emit=KatEmit.PER_GROUP, copies=key_set, source=source)
    try:
        return ReduceOp(name=name, udf=D.make_pre_udf(orig_udf, recipe),
                        key=key, props=props, child=child, hints=hints,
                        add_dtypes=pdt, combiner=True)
    except (ValueError, KeyError):
        return None


def split_reduce(r: Node) -> Optional[Node]:
    """`reduce(X)` → `merge(pre(X))` for a decomposable Reduce.

    Sound for ANY executor as a purely logical rewrite: run globally, `pre`
    emits one partial per group and `merge` re-aggregates singletons (sum of
    one sum, min of one min, ...).  The payoff is physical: a combiner may
    run per worker BEFORE the repartition, so only `min(rows, groups·p)`
    narrow partial records cross the shuffle instead of the full input."""
    if not isinstance(r, ReduceOp) or r.combiner \
            or getattr(r.udf, "__combine_merge__", None) is not None:
        return None
    recipe = r.props.combine
    if recipe is None or r.props.schema_dependent:
        return None
    from .sca import decompose as D

    pre = _combiner_node(r.name + ".pre", r.udf, recipe, r.key,
                         r.props.reads, r.child, r.hints, r.props.source)
    if pre is None:
        return None
    key_set = frozenset(r.key)
    out_fields = r.out_schema.fields
    merge_in = frozenset(pre.out_schema.fields)
    madds = frozenset(out_fields) - merge_in
    merge_props = UdfProperties(
        reads=merge_in | key_set,
        writes=madds | (merge_in - frozenset(out_fields)),
        adds=madds,
        drops=merge_in - frozenset(out_fields),
        implicit_copy=False, card=Card.MANY, filter_fields=frozenset(),
        kat_emit=KatEmit.PER_GROUP, copies=key_set & frozenset(out_fields),
        source=r.props.source)
    merge_udf = D.make_merge_udf(r.udf, recipe, r.child.out_schema.fields,
                                 r.child.out_schema.dtypes)
    merge_udf.__combine_split__ = (r.name, r.udf, r.props, r.hints,
                                   r.add_dtypes)
    try:
        merge = ReduceOp(
            name=r.name + ".merge", udf=merge_udf, key=r.key,
            props=merge_props, child=pre, hints=r.hints,
            add_dtypes={f: r.out_schema.dtypes[f] for f in madds})
    except (ValueError, KeyError):
        return None
    # the split must reproduce the original output schema exactly
    if tuple(merge.out_schema.fields) != tuple(out_fields) or any(
            merge.out_schema.dtypes[f] != r.out_schema.dtypes[f]
            for f in out_fields):
        return None
    return merge


def unsplit_reduce(m: Node) -> Optional[Node]:
    """`merge(pre(X))` → `reduce(X)` — inverse of `split_reduce`."""
    if not isinstance(m, ReduceOp):
        return None
    info = getattr(m.udf, "__combine_split__", None)
    if info is None:
        return None
    pre = m.child
    if not (isinstance(pre, ReduceOp) and pre.combiner
            and pre.key == m.key):
        return None
    name, udf, props, hints, add_dtypes = info
    try:
        return _valid(ReduceOp(name=name, udf=udf, key=m.key, props=props,
                               child=pre.child, hints=hints,
                               add_dtypes=add_dtypes), like=m)
    except (ValueError, KeyError):
        return None


def push_combiner_into_binary(m: Node, side: int) -> Optional[Node]:
    """Eager aggregation (Sec. 4.3.2 extended): `merge(pre(b(L, R)))` →
    `merge(b(pre(L), R))` when `b` is a PK-FK Match whose `side` carries the
    FK and the combiner only references that side.

    Safety: the combiner's key contains the match key of its side, so every
    key group joins with exactly the one PK record (or is dropped whole) —
    group membership and any group-constant join filter commute with the
    partial aggregation, and the merge above projects the PK side's
    attributes away again (its output schema is invariant)."""
    if not isinstance(m, ReduceOp) \
            or getattr(m.udf, "__combine_split__", None) is None:
        return None
    pre = m.child
    if not (isinstance(pre, ReduceOp) and pre.combiner):
        return None
    b = pre.child
    if not isinstance(b, MatchOp):
        return None
    orig_udf, recipe = pre.udf.__combine_pre__
    pre2 = _combiner_node(pre.name, orig_udf, recipe, pre.key,
                          pre.props.reads - frozenset(pre.key),
                          b.children[side], pre.hints, pre.props.source)
    if pre2 is None or not _push_conditions(pre2, b, side):
        return None
    kids = list(b.children)
    kids[side] = pre2
    try:
        return _valid(m.with_children(b.with_children(*kids)), like=m)
    except (ValueError, KeyError):
        return None


def pull_combiner_from_binary(m: Node, side: int) -> Optional[Node]:
    """`merge(b(pre(L), R))` → `merge(pre(b(L, R)))` — inverse push."""
    if not isinstance(m, ReduceOp) \
            or getattr(m.udf, "__combine_split__", None) is None:
        return None
    b = m.child
    if not isinstance(b, MatchOp):
        return None
    pre = b.children[side]
    if not (isinstance(pre, ReduceOp) and pre.combiner and pre.key == m.key):
        return None
    kids = list(b.children)
    kids[side] = pre.child
    try:
        new_b = b.with_children(*kids)
    except (ValueError, KeyError):
        return None
    if not _push_conditions(pre, new_b, side):
        return None
    orig_udf, recipe = pre.udf.__combine_pre__
    pre2 = _combiner_node(pre.name, orig_udf, recipe, pre.key,
                          pre.props.reads - frozenset(pre.key),
                          new_b, pre.hints, pre.props.source)
    if pre2 is None:
        return None
    try:
        return _valid(m.with_children(pre2), like=m)
    except (ValueError, KeyError):
        return None


# ---------------------------------------------------------------------------
# Binary-binary rotation (Lemma 1 generalized) and commutation
# ---------------------------------------------------------------------------
def _swap_args_udf(udf):
    def swapped(r, l, out):  # noqa: E741
        return udf(l, r, out)

    swapped.__name__ = getattr(udf, "__name__", "udf") + "_commuted"
    swapped.__wrapped_pair_udf__ = udf
    return swapped


def commute(b: Node) -> Optional[Node]:
    """Swap the two inputs of a Match/Cross/CoGroup (schema is name-based)."""
    if not _is_binary_op(b):
        return None
    if getattr(b, "anti", False):
        return None  # side order is semantic: only the left input survives
    # manual clone: argument order is schema-irrelevant (name-based attrs),
    # so the resolved out_schema carries over and no re-validation is needed
    new, d = shallow_clone(b)
    d["left"], d["right"] = b.right, b.left
    d["udf"] = _swap_args_udf(b.udf)
    if not isinstance(b, CrossOp):
        d["left_key"], d["right_key"] = b.right_key, b.left_key
        if b.hints.pk_side in ("left", "right"):
            d["hints"] = dataclasses.replace(
                b.hints,
                pk_side="right" if b.hints.pk_side == "left" else "left")
    return _valid(new)


def rotate_guard(parent: Node, side: int, conjugate: bool = False) -> bool:
    """Lemma-1 admissibility of `rotate(parent, side, conjugate)`, without
    building the rotated tree (the hash-consing rewrite engine checks edges
    whose result shape is already interned).

    `conjugate=True` guards the rotation of the COMMUTED child — the child's
    other grandchild splits off — evaluated directly on `parent` since
    commutation changes no effective set."""
    if not isinstance(parent, (MatchOp, CrossOp)):
        return False
    child = parent.children[side]
    if not isinstance(child, (MatchOp, CrossOp)):
        return False
    if getattr(parent, "anti", False) or getattr(child, "anti", False):
        return False  # anti joins are not associative with other joins
    if parent.props.schema_dependent or child.props.schema_dependent:
        return False  # rotations change both operators' input schemas
    if not roc(parent, child):
        return False
    if side == 0:
        # p(a(X,Y),Z) -> a(X, p(Y,Z)): X leaves p's subtree, Z enters a's.
        x = child.children[1 if conjugate else 0]
        z = parent.children[1]
    else:
        # p(X, a(Y,Z)) -> a(p(X,Y), Z): Z leaves p's subtree, X enters a's.
        z = child.children[0 if conjugate else 1]
        x = parent.children[0]
    if (eff_reads(parent) | eff_writes(parent)) & \
            (x.attrs() if side == 0 else z.attrs()):
        return False
    if (eff_reads(child) | eff_writes(child)) & \
            (z.attrs() if side == 0 else x.attrs()):
        return False
    return True


def rotate(parent: Node, side: int, conjugate: bool = False) -> Optional[Node]:
    """Associativity: `p(a(X, Y), Z)` → `a(X, p(Y, Z))` (side=0 child) and the
    mirrored `p(X, a(Y, Z))` → `a(p(X, Y), Z)` (side=1 child).
    `conjugate=True` commutes the child first, so the other grandchild splits
    off (`p(a(X, Y), Z)` → `a(Y, p(X, Z))` up to argument order).

    Guards are Lemma 1 evaluated on effective sets: each operator must only
    reference attributes still below it after the rotation, and the two
    conceptual UDFs must satisfy ROC.  Only RAT binaries (Match/Cross) rotate;
    CoGroup consolidates records, so rotations around it are unsafe without
    per-group cardinality knowledge (conservative, as the paper's Sec. 4.3.2).
    """
    if not rotate_guard(parent, side, conjugate):
        return None
    child = parent.children[side]
    if conjugate:
        child = commute(child)
        if child is None:
            return None
    if side == 0:
        x, y = child.children
        inner = combine_binary(parent, y, parent.children[1])
        out = combine_binary(child, x, inner) if inner is not None else None
    else:
        y, z = child.children
        inner = combine_binary(parent, parent.children[0], y)
        out = combine_binary(child, inner, z) if inner is not None else None
    return _valid(out, like=parent)


# ---------------------------------------------------------------------------
# Limit pushdown (WITH-TIES top-k through 1:1 key-preserving stages)
# ---------------------------------------------------------------------------
def limit_map_commutes(lim: Node, m: Node) -> bool:
    """Can a WITH-TIES `LimitOp` and a `MapOp` be exchanged (either way)?

    The limit is a deterministic multiset function of (key multiset, k), so
    it commutes with any stage whose record mapping is a bijection (|f(r)|=1)
    that leaves the key VALUES untouched.  `eff_writes` covers both mutation
    and projection of the key, so a map that drops or rewrites the key — or
    created it in the first place — blocks the move.  This is the general
    form of the order-cover guard: a propagated sort order covering the
    limit's key survives only stages that never write those columns, so
    "out-order covers the key and the map is 1:1" implies this condition
    (the converse enables pushdown below maps over unsorted inputs too)."""
    if not (isinstance(lim, LimitOp) and isinstance(m, MapOp)):
        return False
    if m.props.card is not Card.ONE:
        return False
    return not (eff_writes(m) & frozenset(lim.key))


def push_limit(lim: Node) -> Optional[Node]:
    """`limit(map(X))` → `map(limit(X))` — the pushdown direction: downstream
    of the limit, the map now touches at most k-ish records."""
    if not isinstance(lim, LimitOp):
        return None
    m = lim.children[0]
    if not limit_map_commutes(lim, m):
        return None
    inner = replace_child(lim, 0, m.children[0])
    if inner is None:
        return None
    return _valid(replace_child(m, 0, inner), like=lim)


def pull_limit(m: Node) -> Optional[Node]:
    """`map(limit(X))` → `limit(map(X))` — inverse, for closure symmetry."""
    if not isinstance(m, MapOp):
        return None
    lim = m.children[0]
    if not (isinstance(lim, LimitOp) and limit_map_commutes(lim, m)):
        return None
    inner = replace_child(m, 0, lim.children[0])
    if inner is None:
        return None
    return _valid(replace_child(lim, 0, inner), like=m)


# ---------------------------------------------------------------------------
# reorderable() — the predicate used by Algorithm 1 (unary chains)
# ---------------------------------------------------------------------------
def reorderable(r: Node, s: Node) -> bool:
    """Paper's Boolean reorderable(r, s) for two neighbouring unary ops."""
    return unary_reorderable(r, s)


# ---------------------------------------------------------------------------
# Declarative rule registry (DESIGN.md §13)
#
# Every rewrite is a `Rule(name, pattern, guard, apply)` over hash-consed
# nodes:
#
# * `pattern(node)` yields context tuples — one per structural position the
#   rule could fire at (sides, conjugate flags).  Pure shape matching, no
#   property checks.
# * `guard(node, ctx)` decides admissibility from operator properties alone.
#   For hint-accelerated rules (see enumeration._CID_HINTS) the guard is
#   EXACT up to the attrs-preservation check; elsewhere it may be a cheap
#   necessary filter with `apply` holding the full conditions.
# * `apply(node, ctx)` builds the rewritten tree or returns None.
#
# `local_rewrites` and the memoized RewriteEngine both walk this registry, so
# a new operator plugs into enumeration, search, and the differential harness
# by registering rules here.  `in_engine=False` marks rules the commute-class
# engine must skip (it explores side-order-insensitive classes, so commute is
# an orbit materialization, not a class edge).
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Rule:
    name: str
    pattern: object   # Node -> Iterable[tuple]
    guard: object     # (Node, ctx) -> bool
    apply: object     # (Node, ctx) -> Optional[Node]
    needs_split: bool = False   # only explored when split_reduces is on
    in_engine: bool = True      # walked by RewriteEngine._local_into


def _pat_swap_unary(node):
    if _is_unary_op(node) and _is_unary_op(node.children[0]):
        yield ()


def _pat_push_unary(node):
    if _is_unary_op(node) and _is_binary_op(node.children[0]):
        yield (0,)
        yield (1,)


def _pat_reduce_root(node):
    if isinstance(node, ReduceOp):
        yield ()


def _pat_reduce_sides(node):
    if isinstance(node, ReduceOp):
        yield (0,)
        yield (1,)


def _pat_pull_unary(node):
    if _is_binary_op(node):
        for side in (0, 1):
            if _is_unary_op(node.children[side]):
                yield (side,)


def _pat_rotate(node):
    if isinstance(node, (MatchOp, CrossOp)):
        for side in (0, 1):
            if isinstance(node.children[side], (MatchOp, CrossOp)):
                yield (side, False)
                yield (side, True)


def _pat_commute(node):
    if _is_binary_op(node):
        yield ()


def _pat_push_limit(node):
    if isinstance(node, LimitOp) and isinstance(node.children[0], MapOp):
        yield ()


def _pat_pull_limit(node):
    if isinstance(node, MapOp) and isinstance(node.children[0], LimitOp):
        yield ()


def _grd_push_unary(node, ctx):
    u = node
    if isinstance(u, ReduceOp):
        u = _strip_reduce_extension(u, node.children[0].children[1 - ctx[0]].attrs())
    return _push_conditions(u, node.children[0], ctx[0])


def _grd_split(node, ctx):
    return (not node.combiner
            and getattr(node.udf, "__combine_merge__", None) is None
            and node.props.combine is not None
            and not node.props.schema_dependent)


def _grd_unsplit(node, ctx):
    info = getattr(node.udf, "__combine_split__", None)
    pre = node.children[0]
    return (info is not None and isinstance(pre, ReduceOp) and pre.combiner
            and pre.key == node.key)


def _grd_push_combiner(node, ctx):
    if getattr(node.udf, "__combine_split__", None) is None:
        return False
    pre = node.children[0]
    return (isinstance(pre, ReduceOp) and pre.combiner
            and isinstance(pre.children[0], MatchOp))


def _grd_pull_combiner(node, ctx):
    if getattr(node.udf, "__combine_split__", None) is None:
        return False
    b = node.children[0]
    if not isinstance(b, MatchOp):
        return False
    pre = b.children[ctx[0]]
    return isinstance(pre, ReduceOp) and pre.combiner and pre.key == node.key


RULES: list[Rule] = [
    Rule("swap-unary", _pat_swap_unary,
         lambda n, c: unary_reorderable(n, n.children[0]),
         lambda n, c: swap_unary(n, n.children[0])),
    Rule("push-unary", _pat_push_unary, _grd_push_unary,
         lambda n, c: push_unary_into_binary(n, n.children[0], c[0])),
    Rule("split-reduce", _pat_reduce_root, _grd_split,
         lambda n, c: split_reduce(n), needs_split=True),
    Rule("unsplit-reduce", _pat_reduce_root, _grd_unsplit,
         lambda n, c: unsplit_reduce(n), needs_split=True),
    Rule("push-combiner", _pat_reduce_sides, _grd_push_combiner,
         lambda n, c: push_combiner_into_binary(n, c[0]), needs_split=True),
    Rule("pull-combiner", _pat_reduce_sides, _grd_pull_combiner,
         lambda n, c: pull_combiner_from_binary(n, c[0]), needs_split=True),
    Rule("pull-unary", _pat_pull_unary,
         lambda n, c: not (getattr(n, "anti", False) and c[0] == 1),
         lambda n, c: pull_unary_from_binary(n, c[0])),
    Rule("rotate", _pat_rotate,
         lambda n, c: rotate_guard(n, c[0], conjugate=c[1]),
         lambda n, c: rotate(n, c[0], conjugate=c[1])),
    Rule("commute", _pat_commute,
         lambda n, c: not getattr(n, "anti", False),
         lambda n, c: commute(n), in_engine=False),
    Rule("push-limit", _pat_push_limit,
         lambda n, c: limit_map_commutes(n, n.children[0]),
         lambda n, c: push_limit(n)),
    Rule("pull-limit", _pat_pull_limit,
         lambda n, c: limit_map_commutes(n.children[0], n),
         lambda n, c: pull_limit(n)),
]

RULES_BY_NAME: dict[str, Rule] = {r.name: r for r in RULES}


def register_rule(rule: Rule, before: Optional[str] = None) -> None:
    """Add a rewrite rule to the registry (idempotent on name collision is an
    error — rules are identities, not handlers)."""
    if rule.name in RULES_BY_NAME:
        raise ValueError(f"rewrite rule {rule.name!r} already registered")
    idx = len(RULES)
    if before is not None:
        idx = next(i for i, r in enumerate(RULES) if r.name == before)
    RULES.insert(idx, rule)
    RULES_BY_NAME[rule.name] = rule


# ---------------------------------------------------------------------------
# All single-step rewrites of a tree (used by the closure enumerator)
# ---------------------------------------------------------------------------
def local_rewrites(node: Node, split_reduces: bool = True) -> list[Node]:
    """Every tree reachable from `node` by ONE valid rewrite at the root —
    a pure walk of the rule registry."""
    out: list[Node] = []
    for rule in RULES:
        if rule.needs_split and not split_reduces:
            continue
        for ctx in rule.pattern(node):
            if not rule.guard(node, ctx):
                continue
            t = rule.apply(node, ctx)
            if t is not None:
                out.append(t)
    return out
