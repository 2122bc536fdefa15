"""End-to-end data-flow optimizer (paper Sec. 6-7 pipeline).

    optimize(flow) =
        SCA properties (already attached at flow construction)
        -> interleaved search: each flow discovered by the rewrite closure is
           priced IMMEDIATELY through the shared Volcano memo, and flows whose
           admissible lower bound (`physical.cost_lower_bound`) already
           exceeds the best cost seen so far are skipped (branch-and-bound)
        -> rank priced flows by estimated cost, return the best

Enumeration and costing share hash-consed subtrees (`operators.struct_id`),
so the (often heavily overlapping) enumerated flows are priced with shared
work — the integration of enumeration and costing sketched in the paper's
Sec. 6, plus the Cascades-style bound pruning from the Volcano line of work.

Pruning only skips flows that provably cannot beat the incumbent, so `best`
is identical (same flow order, same cost) to exhaustively pricing every
enumerated flow — `optimize_two_phase` keeps the original enumerate-then-cost
pipeline precisely so tests and benchmarks can verify that equivalence.
Benchmarks that need the full cost spectrum (the paper's Figs. 5-7 rank
plots) pass `prune=False`.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

from .cost import estimate
from .enumeration import RewriteEngine, _mtab_key, closure, enumerate_plans
from .operators import MapOp, Node, ReduceOp, Source, commute_id
from .physical import (Ctx, PhysPlan, _expand, _prune, best_physical,
                       cost_lower_bound, default_mesh_shards, dop_ladder)
from .reorder import reorderable


@dataclasses.dataclass(frozen=True)
class RankedPlan:
    flow: Node
    plan: PhysPlan
    cost: float

    def order(self) -> str:
        return "->".join(reversed(self.flow.op_names()))

    def compile(self, use_kernels: bool = False, compact_slack: float = 2.0,
                cache=None, use_order: bool = True, adaptive=None,
                stats=None, use_megakernel: Optional[bool] = None,
                device="cuda"):
        """Lower this plan into a ready-to-run `pipeline.CompiledPlan` on
        `device`.

        Lowers the PHYSICAL plan, so the shipping strategies and order
        properties (`Props.sort`) the costing relied on thread into the
        stages — presorted inputs actually elide their sorts at runtime.
        `adaptive`/`stats` enable observed-cardinality feedback serving
        (`pipeline.AdaptiveConfig`, DESIGN.md §9)."""
        from .pipeline import compile_plan

        return compile_plan(self.plan, use_kernels=use_kernels,
                            compact_slack=compact_slack, cache=cache,
                            use_order=use_order, adaptive=adaptive,
                            stats=stats, use_megakernel=use_megakernel,
                            device=device)


@dataclasses.dataclass(frozen=True)
class OptResult:
    best: RankedPlan
    ranked: tuple            # all PRICED plans, ascending cost
    enumeration_s: float
    costing_s: float
    num_enumerated: int = 0  # flows discovered by the closure
    num_pruned: int = 0      # flows skipped by the lower-bound test

    @property
    def num_plans(self) -> int:
        """Size of the explored plan space.  With branch-and-bound pruning
        `ranked` holds only the flows that were actually priced; the space
        the search covered is `num_enumerated`."""
        return self.num_enumerated or len(self.ranked)

    def compile(self, use_kernels: bool = False, compact_slack: float = 2.0,
                cache=None, use_order: bool = True, adaptive=None,
                stats=None, use_megakernel: Optional[bool] = None,
                device="cuda"):
        """Compile the best plan: `optimize(flow).compile().run(bindings)`.

        Repeated optimize+compile of equal-shaped flows returns handles that
        share one warm executable through the plan-executable cache."""
        return self.best.compile(use_kernels=use_kernels,
                                 compact_slack=compact_slack, cache=cache,
                                 use_order=use_order, adaptive=adaptive,
                                 stats=stats, use_megakernel=use_megakernel,
                                 device=device)

    def pick_rank_intervals(self, k: int = 10) -> list[RankedPlan]:
        """K plans at regular rank intervals (the paper's Figs. 5-7 method)."""
        n = len(self.ranked)
        if n <= k:
            return list(self.ranked)
        idx = [round(i * (n - 1) / (k - 1)) for i in range(k)]
        return [self.ranked[i] for i in idx]

    def summary(self) -> str:
        lines = [f"{len(self.ranked)} plans priced "
                 f"({self.num_enumerated} enumerated, "
                 f"{self.num_pruned} pruned by bound) in "
                 f"{(self.enumeration_s + self.costing_s) * 1e3:.1f} ms "
                 f"(enum {self.enumeration_s * 1e3:.1f} / "
                 f"cost {self.costing_s * 1e3:.1f})"]
        best, worst = self.ranked[0], self.ranked[-1]
        lines.append(f"best : {best.cost:.3e}s  {best.order()}")
        lines.append(f"worst: {worst.cost:.3e}s  {worst.order()}  "
                     f"({worst.cost / max(best.cost, 1e-30):.1f}x)")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Group-level memoized search for unary flows (DESIGN.md §4.2)
#
# On purely unary flows the rewrite closure equals the paper's Algorithm-1
# space (tested), and Algorithm 1's memo insight — all orders of the same
# operator multiset over the same source share one alternative set — lets the
# search run over GROUPS (operator subsets, O(2^n) of them) instead of
# materialized orderings (O(n!)).  Costing is interleaved per group: each
# group keeps, per (output-stats, physical-props) key, the cheapest physical
# sub-plan over any reachable ordering.  Keying by output stats keeps the
# search exact under the order-SENSITIVE cardinality estimator: two orderings
# only share a memo slot when every enclosing operator would be priced
# identically on top of them.
# ---------------------------------------------------------------------------
def _is_unary_flow(flow: Node) -> bool:
    n = flow
    while not isinstance(n, Source):
        if not isinstance(n, (MapOp, ReduceOp)):
            return False
        n = n.children[0]
    return True


def _has_splittable_reduce(flow: Node) -> bool:
    """Does the closure explore combiner/merge splits for this flow?  The
    group-lattice fast path only covers reorderings, so such flows must go
    through the closure to keep `optimize == optimize_two_phase`."""
    return any(isinstance(n, ReduceOp)
               and (n.combiner or n.props.combine is not None
                    or getattr(n.udf, "__combine_split__", None) is not None)
               for n in flow.iter_nodes())


class _UnaryGroupSearch:
    """Interleaved Algorithm-1 exploration + Volcano costing over op groups."""

    def __init__(self, ctx: Ctx, stats_memo: dict):
        self.ctx = ctx
        self.stats_memo = stats_memo
        self._roots: dict = {}
        self._cands: dict = {}
        self._counts: dict = {}

    # -- logical exploration (Algorithm 1's candidate-root recursion) -------
    def roots(self, flow: Node) -> list:
        """[(root operator instance, representative flow of group-minus-root)]
        — every operator that can top some reachable ordering of flow's
        group.  Mirrors Algorithm 1 lines 19-27: the original root always
        qualifies; a root s of the sub-group additionally qualifies when
        `reorderable(r, s)` (the checks only read group-invariant inputs:
        UDF properties, keys, and the sub-group's attribute set) and the
        reordered group keeps flow's attribute set — the closure's
        `reorder._valid` check, without which a projecting Reduce moved
        above a field-adding Map loses that Map's fields.  The reference's
        group search lacks this check (ROADMAP.md, Queue 3 item 1)."""
        key = _mtab_key(flow)
        hit = self._roots.get(key)
        if hit is not None:
            return hit
        out: list = []
        if not isinstance(flow, Source):
            r = flow
            sub = flow.children[0]
            out.append((r, sub))
            names = {r.name}
            for s, s_sub in self.roots(sub):
                if s.name in names or not reorderable(r, s):
                    continue
                try:
                    alt_sub = r.with_children(s_sub)  # Alg. 1 line 24
                    if s.with_children(alt_sub).attrs() != flow.attrs():
                        continue
                except (ValueError, KeyError):
                    continue
                names.add(s.name)
                out.append((s, alt_sub))
        self._roots[key] = out
        return out

    def count(self, flow: Node) -> int:
        """Number of distinct reachable orderings (== len(enumerate_plans))."""
        key = _mtab_key(flow)
        hit = self._counts.get(key)
        if hit is None:
            if isinstance(flow, Source):
                hit = 1
            else:
                hit = sum(self.count(sub) for _, sub in self.roots(flow))
            self._counts[key] = hit
        return hit

    # -- interleaved costing ------------------------------------------------
    def _stats_key(self, node: Node) -> tuple:
        # same dop as _expand so the (struct_id, dop)-keyed memo is shared
        st = estimate(node, self.stats_memo, self.ctx.dop)
        return (st.rows, st.width, st.distinct)

    def cands(self, flow: Node) -> dict:
        """{stats_key: {Props: (PhysPlan, flow_tree)}} — cheapest physical
        sub-plan per (output stats, properties) over every reachable ordering
        of flow's group.  Dropping a costlier same-key entry is exact: any
        enclosing operator's cost depends on the sub-plan only through its
        stats, properties and cost."""
        key = _mtab_key(flow)
        hit = self._cands.get(key)
        if hit is not None:
            return hit
        out: dict = {}
        if isinstance(flow, Source):
            plans = _prune(_expand(flow, self.ctx, self.stats_memo, []))
            out[self._stats_key(flow)] = {
                p: (plan, flow) for p, plan in plans.items()}
        else:
            for s, s_sub in self.roots(flow):
                for pmap in self.cands(s_sub).values():
                    for iprops, (iplan, itree) in pmap.items():
                        try:
                            n = s.with_children(itree)
                        except (ValueError, KeyError):
                            continue
                        bucket = out.setdefault(self._stats_key(n), {})
                        for p in _expand(n, self.ctx, self.stats_memo,
                                         [{iprops: iplan}]):
                            cur = bucket.get(p.props)
                            if cur is None or p.total_cost.total \
                                    < cur[0].total_cost.total:
                                bucket[p.props] = (p, n)
        self._cands[key] = out
        return out

    def ranked(self, flow: Node) -> list[RankedPlan]:
        """Root-group entries as RankedPlans (cost-ascending, stable)."""
        out = []
        for pmap in self.cands(flow).values():
            for plan, tree in pmap.values():
                out.append(RankedPlan(flow=tree, plan=plan,
                                      cost=plan.total_cost.total))
        out.sort(key=lambda r: r.cost)
        return out


# number of orderings above which a unary flow is searched group-wise rather
# than through the materializing closure (which must touch every ordering)
GROUP_SEARCH_THRESHOLD = 2000
# fully-commuting flows make the group lattice itself exponential (2^n);
# past this many operators fall back to the closure + its max_plans guard
GROUP_SEARCH_MAX_OPS = 16


def optimize(flow: Node, ctx: Optional[Ctx] = None, max_plans: int = 20000,
             include_commutes: bool = True, prune: bool = True) -> OptResult:
    """Interleaved enumeration + costing with branch-and-bound.

    `prune=False` prices every enumerated flow (full ranked spectrum, as the
    paper's rank-interval figures need); the best plan is the same either
    way.  `include_commutes=False` prices one representative per
    side-order-insensitive plan class, exactly as the two-phase pipeline
    deduplicated before pricing.

    Purely unary flows whose reachable space exceeds GROUP_SEARCH_THRESHOLD
    orderings are searched group-wise (`_UnaryGroupSearch`): the memoized
    lattice of operator subsets is priced instead of each ordering, so e.g.
    a fully-commuting 9-map chain (9! = 362880 orderings) costs ~2^9 group
    expansions.  `max_plans` caps MATERIALIZED plans (the closure paths and
    `enumerate_plans` raise `PlanSpaceExceeded` past it); the group search
    never materializes orderings, so the cap does not apply there."""
    ctx = ctx or Ctx()
    if prune and _is_unary_flow(flow) and not _has_splittable_reduce(flow):
        n_ops = sum(1 for _ in flow.iter_nodes()) - 1
        # n_ops! bounds the ordering count, so small flows skip the lattice
        # construction that exact counting requires
        if n_ops <= GROUP_SEARCH_MAX_OPS \
                and math.factorial(n_ops) > GROUP_SEARCH_THRESHOLD:
            t0 = time.perf_counter()
            search = _UnaryGroupSearch(ctx, {})
            total = search.count(flow)
            if total > GROUP_SEARCH_THRESHOLD:
                t1 = time.perf_counter()
                ranked = search.ranked(flow)
                t2 = time.perf_counter()
                return OptResult(best=ranked[0], ranked=tuple(ranked),
                                 enumeration_s=t1 - t0, costing_s=t2 - t1,
                                 num_enumerated=total,
                                 num_pruned=total - len(ranked))
    engine = RewriteEngine()
    memo: dict = {}
    stats_memo: dict = {}
    bound_memo: dict = {}
    ranked: list[RankedPlan] = []
    upper = float("inf")
    num_enumerated = 0
    num_pruned = 0
    costing_s = 0.0

    t0 = time.perf_counter()
    for f in closure(flow, max_plans=max_plans, engine=engine,
                     include_commutes=include_commutes):
        num_enumerated += 1
        tc = time.perf_counter()
        if prune and ranked:
            lb = cost_lower_bound(f, ctx, stats_memo, bound_memo)
            # conservative margin: the bound and the plan cost sum the same
            # terms in different association orders, so a mathematically
            # equal pair can differ by 1 ULP either way — requiring the
            # bound to strictly clear the incumbent keeps a tied-or-better
            # plan from ever being pruned (the same-best-plan contract)
            if lb >= upper * (1.0 + 1e-12):
                num_pruned += 1
                costing_s += time.perf_counter() - tc
                continue
        plan = best_physical(f, ctx, memo, stats_memo)
        cost = plan.total_cost.total
        ranked.append(RankedPlan(flow=f, plan=plan, cost=cost))
        if cost < upper:
            upper = cost
        costing_s += time.perf_counter() - tc
    total_s = time.perf_counter() - t0

    ranked.sort(key=lambda r: r.cost)  # stable: discovery order breaks ties
    return OptResult(best=ranked[0], ranked=tuple(ranked),
                     enumeration_s=total_s - costing_s, costing_s=costing_s,
                     num_enumerated=num_enumerated, num_pruned=num_pruned)


@dataclasses.dataclass(frozen=True)
class LayoutResult:
    """Outcome of the sharding-aware layout sweep (`optimize_layout`).

    `result` is the full `OptResult` at the winning degree of parallelism
    `dop`; `per_dop` records `(dop, best_cost)` for every ladder rung, so
    benches and tests can see WHY a layout won (latency-bound small batches
    collapse to dop=1; bandwidth/compute-bound deployments spread to the
    full mesh)."""

    result: OptResult
    dop: int
    per_dop: tuple

    @property
    def best(self) -> RankedPlan:
        return self.result.best


def optimize_layout(flow: Node, mesh_shards: Optional[int] = None,
                    ctx: Optional[Ctx] = None, max_plans: int = 20000,
                    include_commutes: bool = True,
                    prune: bool = True) -> LayoutResult:
    """Sharding-aware optimization: sweep dop over `dop_ladder(mesh)`.

    Every rung reruns the full interleaved search under a context whose
    `dop` changes the net terms (shuffle shares, collective launch latency),
    the per-worker mem/cpu division, AND the combiner output estimates
    (`min(rows, groups*dop)`) — so the shard layout is chosen by the same
    §7.1 cost model as every other physical property, not taken as an
    input.  `mesh_shards` defaults to `REPRO_MESH_SHARDS` (8)."""
    base = ctx or Ctx()
    mesh = mesh_shards if mesh_shards is not None else default_mesh_shards()
    per: list[tuple[int, float]] = []
    best: Optional[tuple[int, OptResult]] = None
    for d in dop_ladder(mesh):
        res = optimize(flow, dataclasses.replace(base, dop=d),
                       max_plans=max_plans,
                       include_commutes=include_commutes, prune=prune)
        per.append((d, res.best.cost))
        if best is None or res.best.cost < best[1].best.cost:
            best = (d, res)
    assert best is not None
    return LayoutResult(result=best[1], dop=best[0], per_dop=tuple(per))


def optimize_two_phase(flow: Node, ctx: Optional[Ctx] = None,
                       max_plans: int = 20000,
                       include_commutes: bool = True) -> OptResult:
    """The original enumerate-everything-then-cost-everything pipeline.

    Kept as the reference implementation: `optimize` must return the same
    best plan (same flow order, same total cost) on every flow — see
    tests/test_optimizer.py and bench_enumeration's speedup column."""
    ctx = ctx or Ctx()
    t0 = time.perf_counter()
    flows = enumerate_plans(flow, max_plans=max_plans,
                            include_commutes=include_commutes)
    t1 = time.perf_counter()
    memo: dict = {}
    stats_memo: dict = {}
    ranked = []
    for f in flows:
        plan = best_physical(f, ctx, memo, stats_memo)
        ranked.append(RankedPlan(flow=f, plan=plan,
                                 cost=plan.total_cost.total))
    t2 = time.perf_counter()
    ranked.sort(key=lambda r: r.cost)
    return OptResult(best=ranked[0], ranked=tuple(ranked),
                     enumeration_s=t1 - t0, costing_s=t2 - t1,
                     num_enumerated=len(flows), num_pruned=0)
