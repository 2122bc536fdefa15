"""Plan enumeration (paper Sec. 6).

Two enumerators are provided:

* `enum_alternatives_alg1` — a faithful implementation of the paper's
  Algorithm 1 for unary-operator flows: recursive descent, exchange of
  neighbouring operators via `reorderable(r, s)`, candidate roots visited
  once, memo table keyed on the flow's operator multiset + source.

* `enumerate_plans` — the production enumerator for tree-shaped flows with
  binary operators: a memoized fix-point closure over all valid single-step
  rewrites (unary swaps, pushes into/out of binary operators, rotations,
  commutations).  On purely unary flows it returns exactly the Algorithm-1
  space (tested); on trees it realizes the paper's "easily extended to
  non-unary operators" claim, including bushy join orders.

Both return logical plans only; the physical optimizer prices each.

Performance (DESIGN.md §2): trees are hash-consed.  Every node carries an
interned structural id (`operators.struct_id`), so plan dedup is an integer
set membership test, and the single-step rewrite list of every distinct
subtree is computed exactly once per enumeration (`RewriteEngine`).  Rewritten
trees are interned by id, so a subtree shared by thousands of enumerated
plans is rewritten and allocated once, not once per enclosing plan.
"""

from __future__ import annotations

from typing import Iterable, Optional

from .operators import (MapOp, Node, ReduceOp, Source, commute_id,
                        commute_ordered, intern_commute_key, replace_child,
                        struct_id)
from .reorder import RULES, commute, reorderable


class PlanSpaceExceeded(RuntimeError):
    """The rewrite closure grew past `max_plans`.

    Carries the configured limit and the number of distinct plans discovered
    before bailing out, so callers can report partial progress or retry with
    a larger budget."""

    def __init__(self, limit: int, count: int):
        super().__init__(f"plan space exceeds {limit} "
                         f"({count} plans discovered)")
        self.limit = limit
        self.count = count


# ---------------------------------------------------------------------------
# Algorithm 1 (unary flows) — faithful port of the paper's pseudocode
# ---------------------------------------------------------------------------
def _mtab_key(flow: Node) -> tuple:
    """Memo key: the *set* of operators plus the source — Algorithm 1 memoizes
    sub-flows regardless of their current order (all orders of the same ops
    over the same input enumerate the same alternatives)."""
    names = tuple(sorted(n.name for n in flow.iter_nodes()))
    return names


def enum_alternatives_alg1(flow: Node,
                           mtab: Optional[dict] = None) -> list[Node]:
    """Paper Algorithm 1 (lines 1-29) for single-input operator flows."""
    if mtab is None:
        mtab = {}
    key = _mtab_key(flow)
    if key in mtab:  # line 4-6
        return mtab[key]

    r = flow  # getRoot: the tree root IS the last operator          (line 7)
    if isinstance(r, Source):  # line 8-9
        alts = [r]
        mtab[key] = alts
        return alts
    if not isinstance(r, (MapOp, ReduceOp)):
        raise ValueError("Algorithm 1 handles unary flows only; "
                         "use enumerate_plans for trees")

    cand: set = set()  # line 16
    d_minus_r = r.children[0]  # rmRoot                               (line 17)
    alts_minus_r = enum_alternatives_alg1(d_minus_r, mtab)  # line 18
    alts: list[Node] = []
    seen: set = set()

    def add(tree: Node):
        s = struct_id(tree)
        if s not in seen:
            seen.add(s)
            alts.append(tree)

    for a_minus_r in alts_minus_r:  # line 19
        s = a_minus_r  # getRoot(A_-r)                                (line 20)
        add(r.with_children(a_minus_r))  # addRoot                    (line 21)
        if isinstance(s, Source):
            continue
        if s.name not in cand and reorderable(r, s):  # line 22
            cand.add(s.name)  # line 23
            # setRoot(A_-r, r): replace s with r                      (line 24)
            d_minus_s = r.with_children(s.children[0])
            for a_minus_s in enum_alternatives_alg1(d_minus_s, mtab):  # 25-26
                alt = s.with_children(a_minus_s)  # line 27
                # the closure's `reorder._valid` check, which the paper's
                # pseudocode (and the reference) leaves out: a reordering
                # must keep the flow's attribute set
                if alt.attrs() == flow.attrs():
                    add(alt)

    mtab[key] = alts  # line 28
    return alts


# ---------------------------------------------------------------------------
# Closure enumerator (trees with binary operators)
# ---------------------------------------------------------------------------
def _hint_unary_swap(node: Node, ctx: tuple) -> int:
    """Commute id of the result of exchanging `node` with its unary child —
    computable from interned child ids without building the tree."""
    child = node.children[0]
    x_cid = commute_id(child.children[0])
    return intern_commute_key(
        child.name, (intern_commute_key(node.name, (x_cid,)),))


def _hint_rotate(node: Node, ctx: tuple) -> int:
    """Commute id of the (conjugate) rotation result.  The plain rotation
    splits off the child's first grandchild when the child sits left
    (p(a(X,Y),Z) -> a(X, p(Y,Z))) and its second when it sits right
    (p(X, a(Y,Z)) -> a(p(X,Y), Z)); the conjugate splits off the other."""
    side, conjugate = ctx
    child = node.children[side]
    other_cid = commute_id(node.children[1 - side])
    g1, g2 = (commute_id(g) for g in child.children)
    out_cid, in_cid = (g1, g2) if side == 0 else (g2, g1)
    if conjugate:
        out_cid, in_cid = in_cid, out_cid
    return intern_commute_key(child.name, (out_cid, intern_commute_key(
        node.name, (in_cid, other_cid))))


# Per-rule result-id precomputation (DESIGN.md §2 hash-consing fast path).
# Only rules whose guard is EXACT (sufficient for admissibility, modulo the
# attrs-preservation check) may appear here: on an intern hit the engine
# accepts the cached representative without running `apply`.
_CID_HINTS = {
    "swap-unary": _hint_unary_swap,
    "push-limit": _hint_unary_swap,
    "pull-limit": _hint_unary_swap,
    "rotate": _hint_rotate,
}


class RewriteEngine:
    """Single-step rewrite lists over COMMUTE CLASSES, memoized per class.

    Commutation is unconditionally valid on every binary operator, so the
    rewrite graph is closed under it: reachability of a plan is equivalent to
    reachability of its side-order-insensitive class (`commute_id`).  The
    engine therefore explores one representative per class and never walks
    the 2^(#binary ops) orientation orbit — rotations, whose applicability
    does depend on orientation, are *conjugate-completed*: from a class
    {{X,Y},Z} both regroupings {{X,Z},Y} (plain rotation) and {{Y,Z},X}
    (rotation of the commuted child) are generated, which covers every
    rotation any orbit member could perform.  Unary swaps and binary
    pushes/pulls are orientation-insensitive (both sides are tried).

    `rewrites(node)` returns `(trees, cids)` — one representative per class
    reachable from `node`'s class by a single non-commute rewrite.  Results
    are interned per class id and the result id is computed from child ids
    BEFORE building a tree, so a shape seen earlier in the run costs one
    dict probe instead of a node construction + schema resolution.  The
    engine is scoped to one enumeration run: equal ids imply interchangeable
    subtrees only among trees reachable from a single flow.

    `orbit(tree)` re-materializes the orientation variants of one class
    (cheap clones, deduplicated by structural id) for callers that need
    commuted plans as distinct objects (`include_commutes=True`).

    `split_reduces=True` (the default) additionally explores decomposable-
    aggregation splits: `reduce → merge∘pre`, their inverses, and the eager
    push of a combiner below a PK-FK Match."""

    def __init__(self, split_reduces: bool = True):
        self._memo: dict[int, tuple[list[Node], list[int]]] = {}
        self._reps: dict[int, Node] = {}
        self._variants: dict[int, list[Node]] = {}
        self._split = split_reduces

    def intern(self, node: Node) -> Node:
        return self._reps.setdefault(commute_id(node), node)

    def _local_into(self, node: Node, trees: list, cids: list) -> None:
        """Registry walk: every in-engine rule's (pattern, guard, apply) runs
        uniformly; rules with a cid hint resolve against the intern table
        BEFORE building a tree (see `_CID_HINTS`)."""
        reps = self._reps
        emitted: set = set()
        for rule in RULES:
            if not rule.in_engine or (rule.needs_split and not self._split):
                continue
            hint_fn = _CID_HINTS.get(rule.name)
            for ctx in rule.pattern(node):
                if not rule.guard(node, ctx):
                    continue
                if hint_fn is not None:
                    hint = hint_fn(node, ctx)
                    if hint in emitted:
                        continue  # e.g. self-conjugate rotation
                    rep = reps.get(hint)
                    if rep is not None:
                        # same attrs-preservation check as _valid(like=node)
                        if rep.attrs() == node.attrs():
                            trees.append(rep)
                            cids.append(hint)
                            emitted.add(hint)
                        continue
                tree = rule.apply(node, ctx)
                if tree is not None:
                    c = commute_id(tree)
                    trees.append(reps.setdefault(c, tree))
                    cids.append(c)
                    emitted.add(c)

    def rewrites(self, node: Node) -> tuple[list[Node], list[int]]:
        cid = commute_id(node)
        hit = self._memo.get(cid)
        if hit is not None:
            return hit
        reps = self._reps
        trees: list[Node] = []
        cids: list[int] = []
        self._local_into(node, trees, cids)
        children = node.children
        if children:
            child_cids = tuple(commute_id(c) for c in children)
            ordered = commute_ordered(node)
            for i, child in enumerate(children):
                sub_trees, sub_cids = self.rewrites(child)
                for sub, sub_cid in zip(sub_trees, sub_cids):
                    # id of the substituted tree is known before building it
                    new_cid = intern_commute_key(
                        node.name,
                        child_cids[:i] + (sub_cid,) + child_cids[i + 1:],
                        ordered=ordered)
                    rep = reps.get(new_cid)
                    if rep is None:
                        rep = replace_child(node, i, sub)
                        if rep is None:  # schema conflict after substitution
                            continue
                        reps[new_cid] = rep
                    trees.append(rep)
                    cids.append(new_cid)
        out = (trees, cids)
        self._memo[cid] = out
        return out

    # -- orientation orbit ---------------------------------------------------
    def _subtree_variants(self, node: Node) -> list[Node]:
        sid = struct_id(node)
        hit = self._variants.get(sid)
        if hit is not None:
            return hit
        if not node.children:
            out = [node]
        elif node.is_unary:
            out = []
            for v in self._subtree_variants(node.children[0]):
                t = node if v is node.children[0] else replace_child(node, 0, v)
                if t is not None:
                    out.append(t)
        else:
            seen: set = set()
            out = []
            lefts = self._subtree_variants(node.children[0])
            rights = self._subtree_variants(node.children[1])
            for lv in lefts:
                for rv in rights:
                    if lv is node.children[0] and rv is node.children[1]:
                        base: Optional[Node] = node
                    else:
                        base = replace_child(node, 0, lv)
                        if base is not None:
                            base = replace_child(base, 1, rv)
                    for t in (base, commute(base) if base is not None
                              else None):
                        if t is None:
                            continue
                        s = struct_id(t)
                        if s not in seen:
                            seen.add(s)
                            out.append(t)
        self._variants[sid] = out
        return out

    def orbit(self, tree: Node) -> list[Node]:
        """All orientation variants of `tree`'s commute class, the class
        representative first, deduplicated by structural id."""
        tid = struct_id(tree)
        return [tree] + [v for v in self._subtree_variants(tree)
                         if struct_id(v) != tid]


def closure(flow: Node, max_plans: int = 20000,
            engine: Optional[RewriteEngine] = None,
            include_commutes: bool = True,
            split_reduces: bool = True) -> Iterable[Node]:
    """Lazily yield every flow reachable from `flow` by valid rewrites, in
    discovery order (depth-first over the class graph, `flow`'s class first;
    with `include_commutes=True` each class's orientation orbit is emitted
    when the class is discovered).

    The interleaved optimizer consumes this generator directly so costing
    overlaps enumeration.  Raises `PlanSpaceExceeded` when more than
    `max_plans` plans are yielded."""
    engine = engine or RewriteEngine(split_reduces=split_reduces)
    root = engine.intern(flow)
    seen = {commute_id(root)}
    count = 0

    def emit(rep: Node):
        nonlocal count
        members = engine.orbit(rep) if include_commutes else [rep]
        for m in members:
            if count >= max_plans:
                raise PlanSpaceExceeded(max_plans, count)
            count += 1
            yield m

    yield from emit(root)
    work = [root]
    while work:
        cur = work.pop()
        trees, cids = engine.rewrites(cur)
        for t, c in zip(trees, cids):
            if c not in seen:
                seen.add(c)
                yield from emit(t)
                work.append(t)


def enumerate_plans(flow: Node, max_plans: int = 20000,
                    include_commutes: bool = True,
                    engine: Optional[RewriteEngine] = None,
                    split_reduces: bool = True) -> list[Node]:
    """All data flows reachable from `flow` by valid pairwise reorderings.

    `include_commutes=False` collapses Match/Cross argument order to one
    representative per side-order-insensitive class, matching the paper's
    notion of distinct operator orders.  (The search itself always runs
    class-wise; commuted variants are materialized only on request.)
    `split_reduces=False` restricts the space to pure reorderings (no
    combiner/merge splits of decomposable Reduces).
    """
    return list(closure(flow, max_plans=max_plans, engine=engine,
                        include_commutes=include_commutes,
                        split_reduces=split_reduces))


def count_plans(flow: Node, **kw) -> int:
    return len(enumerate_plans(flow, **kw))
