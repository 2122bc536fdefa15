"""Cardinality / size estimation (paper Sec. 7.1 compiler hints).

Mirrors Stratosphere's estimator: per-operator hints ("Average Number of
Records Emitted per UDF Call", "Number of Distinct Values per Key-Set",
PK/FK knowledge, CPU cost per call) drive recursive cardinality estimates.
Where a hint is missing, defaults are derived from the SCA-detected emission
cardinality class — the black-box analogue of textbook selectivity defaults.

Adaptive statistics feedback (DESIGN.md §9): the paper's hints are static
compiler guesses, but the fused runtime computes every stage's valid-row
count for free (the compaction prefix sum).  `StatsStore` accumulates those
observations per flow; `calibrate_hints` converts them into posterior hints
(confidence-weighted in log space, quantized onto a geometric grid so one
calibration REGIME maps to one executable-cache identity); `drift_score`
compares observed against priced per-stage rows so the serving handle can
re-optimize only under sustained drift.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Sequence

from .operators import (CoGroupOp, CrossOp, Hints, LimitOp, MapOp, MatchOp,
                        Node, ReduceOp, Source, struct_id)
from .udf import Card, KatEmit

# Selectivity defaults by detected cardinality class
DEFAULT_FILTER_SELECTIVITY = 0.5
DEFAULT_GROUPING_FACTOR = 0.1       # distinct keys / rows when no hint
DEFAULT_GROUP_FILTER_SELECTIVITY = 0.5


@dataclasses.dataclass(frozen=True)
class Stats:
    rows: float                 # estimated record count
    width: int                  # bytes per record (from the output schema)
    distinct: Optional[float] = None   # distinct key-groups (KAT outputs)

    @property
    def bytes(self) -> float:
        return self.rows * self.width


def _map_selectivity(op: MapOp) -> float:
    if op.hints.selectivity is not None:
        return op.hints.selectivity
    if op.props.card is Card.ONE:
        return 1.0
    if op.props.card is Card.AT_MOST_ONE:
        return DEFAULT_FILTER_SELECTIVITY
    return 1.0


def has_combiner(node: Node) -> bool:
    """Does this subtree contain a combiner Reduce?  Cached per instance
    (same idiom as `Node.attrs`): decides whether an estimate depends on
    `dop`, keeping the hot dop-independent memo keyed on the bare int id."""
    h = node.__dict__.get("_hascomb")
    if h is None:
        h = (isinstance(node, ReduceOp) and node.combiner) \
            or any(has_combiner(c) for c in node.children)
        node.__dict__["_hascomb"] = h
    return h


def estimate(node: Node, memo: Optional[dict] = None, dop: int = 1) -> Stats:
    """Recursive cardinality/size estimate for `node`'s output.

    `dop` (degree of parallelism) only affects COMBINER Reduces: a combiner
    runs per worker without co-locating keys first, so every worker may hold
    (up to) every group — its global output is `min(rows, groups * dop)`
    partial records, which is exactly what crosses the downstream shuffle.
    Combiner-free subtrees (the common case) memoize on the plain
    `struct_id`; only subtrees containing a combiner pay a per-dop key.
    """
    if memo is None:
        memo = {}
    key = (struct_id(node), dop) if has_combiner(node) else struct_id(node)
    if key in memo:
        return memo[key]

    width = node.out_schema.width_bytes()

    if isinstance(node, Source):
        st = Stats(rows=float(node.num_records), width=width)
    elif isinstance(node, MapOp):
        cin = estimate(node.child, memo, dop)
        st = Stats(rows=cin.rows * _map_selectivity(node), width=width,
                   distinct=cin.distinct)
    elif isinstance(node, ReduceOp):
        cin = estimate(node.child, memo, dop)
        groups = float(node.hints.distinct_keys) if node.hints.distinct_keys \
            else max(1.0, cin.rows * DEFAULT_GROUPING_FACTOR)
        groups = min(groups, cin.rows) if cin.rows else groups
        ke = node.props.kat_emit
        if node.combiner:
            rows = min(cin.rows, groups * max(dop, 1))
        elif ke in (KatEmit.PASSTHROUGH, None):
            rows = cin.rows
        elif ke is KatEmit.PASSTHROUGH_FILTER:
            gsel = node.hints.group_selectivity
            rows = cin.rows * (gsel if gsel is not None
                               else DEFAULT_GROUP_FILTER_SELECTIVITY)
        elif ke is KatEmit.PER_GROUP_FILTER:
            gsel = node.hints.group_selectivity
            rows = groups * (gsel if gsel is not None
                             else DEFAULT_GROUP_FILTER_SELECTIVITY)
        else:  # PER_GROUP, MANY
            rows = groups
        st = Stats(rows=rows, width=width, distinct=groups)
    elif isinstance(node, LimitOp):
        cin = estimate(node.child, memo, dop)
        rows = min(cin.rows, float(node.k)) if cin.rows else cin.rows
        distinct = min(cin.distinct, rows) if cin.distinct is not None else None
        st = Stats(rows=rows, width=width, distinct=distinct)
    elif isinstance(node, MatchOp) and node.anti:
        ls = estimate(node.left, memo, dop)
        estimate(node.right, memo, dop)  # priced for its own compute, not rows
        sel = node.hints.selectivity if node.hints.selectivity is not None \
            else DEFAULT_FILTER_SELECTIVITY
        st = Stats(rows=ls.rows * sel, width=width, distinct=ls.distinct)
    elif isinstance(node, MatchOp):
        ls, rs = estimate(node.left, memo, dop), estimate(node.right, memo, dop)
        # the UDF-level selectivity is applied exactly once, via the shared
        # `_map_selectivity_like` factor below — the PK branches must not
        # fold it in a second time (that squared the hint, and the runtime's
        # seeded compaction buffers then truncated real rows)
        if node.hints.join_fanout is not None:
            rows = ls.rows * node.hints.join_fanout
        elif node.hints.pk_side == "right":
            rows = ls.rows
        elif node.hints.pk_side == "left":
            rows = rs.rows
        else:
            # |L||R| / max(d_L, d_R) with defaulted distinct counts
            dl = ls.distinct or max(1.0, ls.rows * DEFAULT_GROUPING_FACTOR)
            dr = rs.distinct or max(1.0, rs.rows * DEFAULT_GROUPING_FACTOR)
            rows = ls.rows * rs.rows / max(dl, dr, 1.0)
        rows *= _map_selectivity_like(node)
        st = Stats(rows=rows, width=width)
    elif isinstance(node, CrossOp):
        ls, rs = estimate(node.left, memo, dop), estimate(node.right, memo, dop)
        st = Stats(rows=ls.rows * rs.rows * _map_selectivity_like(node),
                   width=width)
    elif isinstance(node, CoGroupOp):
        ls, rs = estimate(node.left, memo, dop), estimate(node.right, memo, dop)
        groups = float(node.hints.distinct_keys) if node.hints.distinct_keys \
            else max(1.0, max(ls.rows, rs.rows) * DEFAULT_GROUPING_FACTOR)
        st = Stats(rows=groups, width=width, distinct=groups)
    else:
        raise TypeError(type(node).__name__)

    memo[key] = st
    return st


def seed_source_stats(root: Node, rows_by_name, memo: dict) -> dict:
    """Override Source cardinalities in `memo` with ACTUAL bound batch sizes.

    The declared `Source.num_records` describes deployment scale; a serving
    batch is typically orders of magnitude smaller.  Seeding the memo before
    downstream `estimate` calls re-prices every selectivity and grouping
    hint at the batch's real scale, so compaction capacities track the data
    actually flowing — the runtime analogue of the paper's compiler-hint
    re-estimation.  Seeded rows are CAPACITIES (>= the valid count), so the
    correction is conservative; hints wrong by more than the compaction
    slack could truncate exactly as they could at declared scale."""
    for node in root.iter_nodes():
        if isinstance(node, Source) and node.name in rows_by_name:
            memo[struct_id(node)] = Stats(
                rows=float(max(rows_by_name[node.name], 1)),
                width=node.out_schema.width_bytes())
    return memo


def _map_selectivity_like(node) -> float:
    """UDF-level selectivity of a binary RAT operator's first-order fn."""
    if node.hints.selectivity is not None:
        return node.hints.selectivity
    if node.props.card is Card.AT_MOST_ONE:
        return DEFAULT_FILTER_SELECTIVITY
    return 1.0


def sort_flops(rows: float) -> float:
    """Comparison-sort work estimate for local sort strategies."""
    r = max(rows, 2.0)
    return 16.0 * r * math.log2(r)


# ---------------------------------------------------------------------------
# Adaptive statistics feedback (DESIGN.md §9)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class StageObs:
    """Accumulated observations of one fused stage's boundary cardinalities.

    Cumulative sums back confidence weighting (how much evidence exists);
    the EWMAs are what calibration and drift scoring read, so a shifted
    workload re-converges within ~1/alpha batches instead of being anchored
    to the all-time mean.  `groups` carries the KAT/Match side-channel
    (observed group count / PK-probe hits); None until first observed."""

    rows_in: tuple = ()
    rows_out: float = 0.0
    groups: Optional[float] = None
    batches: int = 0
    ewma_in: tuple = ()
    ewma_out: float = 0.0
    ewma_groups: Optional[float] = None
    last_tick: int = 0


def _ewma(old: float, new: float, alpha: float, first: bool) -> float:
    return float(new) if first else (1.0 - alpha) * old + alpha * float(new)


class StatsStore:
    """Per-flow accumulator of observed stage-boundary cardinalities.

    Stage keys are tuples of operator NAMES (the ops fused into the stage,
    bottom-up) — names survive reordering rewrites, so observations made
    under one plan still calibrate the hints of every equivalent plan.
    `tick()` stamps one served batch; recency filters (`newer_than`) let the
    drift check judge only observations made under the current plan.
    """

    def __init__(self, alpha: float = 0.25):
        self.alpha = alpha
        self._stages: dict[tuple, StageObs] = {}
        self._sources: dict[str, StageObs] = {}
        self._tick = 0

    # -- recording -----------------------------------------------------------
    def tick(self) -> int:
        """Advance the batch clock (call once per observed batch)."""
        self._tick += 1
        return self._tick

    @property
    def clock(self) -> int:
        return self._tick

    def observe_source(self, name: str, rows: float) -> None:
        o = self._sources.setdefault(name, StageObs())
        first = o.batches == 0
        o.rows_out += float(rows)
        o.batches += 1
        o.ewma_out = _ewma(o.ewma_out, rows, self.alpha, first)
        o.last_tick = self._tick

    def observe_stage(self, names: tuple, rows_in: Sequence[float],
                      rows_out: float, groups: Optional[float] = None,
                      snap: bool = False) -> None:
        """Record one batch's boundary counts for the stage `names`.

        `snap=True` overwrites the EWMAs instead of blending — used when a
        count is KNOWN to supersede history (a truncation was detected, so
        the pre-compaction count is the ground truth the next capacity must
        clear, not a noisy sample to average in)."""
        o = self._stages.setdefault(tuple(names), StageObs())
        first = o.batches == 0 or snap
        rows_in = tuple(float(r) for r in rows_in)
        if len(o.rows_in) != len(rows_in):
            o.rows_in = (0.0,) * len(rows_in)
            o.ewma_in = rows_in
        o.rows_in = tuple(a + b for a, b in zip(o.rows_in, rows_in))
        o.rows_out += float(rows_out)
        o.batches += 1
        o.ewma_in = tuple(_ewma(a, b, self.alpha, first)
                          for a, b in zip(o.ewma_in, rows_in))
        o.ewma_out = _ewma(o.ewma_out, rows_out, self.alpha, first)
        if groups is not None:
            o.groups = (o.groups or 0.0) + float(groups)
            o.ewma_groups = _ewma(o.ewma_groups or 0.0, groups, self.alpha,
                                  first or o.ewma_groups is None)
        o.last_tick = self._tick

    # -- reading ---------------------------------------------------------
    def stages(self):
        return self._stages.items()

    def stage(self, names: tuple) -> Optional[StageObs]:
        return self._stages.get(tuple(names))

    def source_rows(self) -> dict:
        """{source name: EWMA of observed valid rows per batch}."""
        return {n: o.ewma_out for n, o in self._sources.items()}

    def __len__(self) -> int:
        return len(self._stages)

    def clear(self) -> None:
        self._stages.clear()
        self._sources.clear()
        self._tick = 0

    def clone(self) -> "StatsStore":
        """Independent deep copy (same alpha, same observations).  Used to
        seed a new tenant's store from an existing regime's pooled history
        without aliasing the donors."""
        s = StatsStore(alpha=self.alpha)
        s.merge(self)
        return s

    # -- cross-shard / cross-worker combination --------------------------
    def merge(self, other: "StatsStore") -> None:
        """Fold another store's observations in (sums add; EWMAs combine
        weighted by batch counts, so a shard that saw more batches carries
        proportionally more weight).  Used to aggregate per-worker stores;
        `execute_distributed` itself psums counts across shards so a single
        global observation lands here per executed batch."""

        def fold(mine: dict, theirs: dict):
            for k, o in theirs.items():
                m = mine.get(k)
                if m is None:
                    mine[k] = dataclasses.replace(o)
                    continue
                tb = m.batches + o.batches
                if len(m.rows_in) != len(o.rows_in):
                    pad = max(len(m.rows_in), len(o.rows_in))
                    m.rows_in += (0.0,) * (pad - len(m.rows_in))
                    m.ewma_in += (0.0,) * (pad - len(m.ewma_in))
                    o = dataclasses.replace(
                        o, rows_in=o.rows_in + (0.0,) * (pad - len(o.rows_in)),
                        ewma_in=o.ewma_in + (0.0,) * (pad - len(o.ewma_in)))
                wm, wo = m.batches / tb, o.batches / tb
                m.ewma_in = tuple(a * wm + b * wo
                                  for a, b in zip(m.ewma_in, o.ewma_in))
                m.ewma_out = m.ewma_out * wm + o.ewma_out * wo
                if o.ewma_groups is not None:
                    m.ewma_groups = (o.ewma_groups if m.ewma_groups is None
                                     else m.ewma_groups * wm + o.ewma_groups * wo)
                    m.groups = (m.groups or 0.0) + (o.groups or 0.0)
                m.rows_in = tuple(a + b for a, b in zip(m.rows_in, o.rows_in))
                m.rows_out += o.rows_out
                m.batches = tb
                m.last_tick = max(m.last_tick, o.last_tick)

        fold(self._stages, other._stages)
        fold(self._sources, other._sources)
        self._tick = max(self._tick, other._tick)


def pool_stores(stores: Sequence[StatsStore],
                alpha: float = 0.25) -> StatsStore:
    """Batch-weighted pool of per-tenant `StatsStore`s — the multi-tenant
    serving engine's merge policy (DESIGN.md §11).

    Each tenant observes only its OWN requests (solo probes), so per-tenant
    stores stay uncontaminated and one tenant's drift can never shift
    another tenant's posterior.  The pool is read in exactly one place:
    repairing a SHARED coalesced plan whose capacities all co-batched
    tenants overran together — there the right statistics are the mixture
    the shared batch actually carries, which is the batch-weighted merge
    (`StatsStore.merge`) of the members' individual histories.  Drift
    scoring and per-tenant calibration must keep reading the individual
    stores; pooling them would let a heavy drifting tenant drag every
    co-tenant's regime with it (the thrash §11 is designed out of)."""
    pooled = StatsStore(alpha=alpha)
    for s in stores:
        pooled.merge(s)
    return pooled


def _quantize_log2(x: float, quant: int) -> float:
    """Snap `x` onto the geometric grid 2^(k/quant).  Posterior hints live on
    this grid, so noisy-but-stationary observations keep mapping to the SAME
    hints — the calibration REGIME is discrete, the semantic cache key is
    stable, and a re-plan is only triggered by a real distribution move."""
    if x <= 0.0:
        return x
    return float(2.0 ** (round(math.log2(x) * quant) / quant))


def _blend(prior: Optional[float], observed: float, batches: int,
           prior_weight: float) -> float:
    """Confidence-weighted geometric interpolation between the compiler hint
    and the observation: `prior_weight` is the hint's worth in pseudo-batches
    (0 trusts observations outright — the right setting once a swap trigger
    has already statistically confirmed the drift)."""
    observed = max(observed, 1e-9)
    if prior is None or prior <= 0.0 or prior_weight <= 0.0:
        return observed
    w = batches / (batches + prior_weight)
    return math.exp(w * math.log(observed) + (1.0 - w) * math.log(prior))


def _stage_expected(nodes: Sequence[Node], rows_in: Sequence[float],
                    dop: int = 1) -> float:
    """Output rows one fused stage should produce at the OBSERVED input rows,
    under the nodes' current hints — `estimate`'s per-node cases applied
    locally, so upstream estimation error cancels out of the comparison."""
    top = nodes[-1]
    in0 = max(rows_in[0], 0.0) if rows_in else 0.0
    in1 = max(rows_in[1], 0.0) if len(rows_in) > 1 else 0.0
    if isinstance(top, MapOp):
        out = in0
        for n in nodes:
            out *= _map_selectivity(n)
        return out
    h = top.hints
    if isinstance(top, ReduceOp):
        groups = float(h.distinct_keys) if h.distinct_keys \
            else max(1.0, in0 * DEFAULT_GROUPING_FACTOR)
        groups = min(groups, in0) if in0 else groups
        if top.combiner:
            return min(in0, groups * max(dop, 1))
        ke = top.props.kat_emit
        gsel = h.group_selectivity if h.group_selectivity is not None \
            else DEFAULT_GROUP_FILTER_SELECTIVITY
        if ke in (KatEmit.PASSTHROUGH, None):
            return in0
        if ke is KatEmit.PASSTHROUGH_FILTER:
            return in0 * gsel
        if ke is KatEmit.PER_GROUP_FILTER:
            return groups * gsel
        return groups
    if isinstance(top, LimitOp):
        return min(in0, float(top.k)) if in0 else in0
    if isinstance(top, MatchOp) and top.anti:
        sel = h.selectivity if h.selectivity is not None \
            else DEFAULT_FILTER_SELECTIVITY
        return in0 * sel
    if isinstance(top, MatchOp):
        if h.join_fanout is not None:
            rows = in0 * h.join_fanout
        elif h.pk_side == "right":
            rows = in0
        elif h.pk_side == "left":
            rows = in1
        else:
            dl = max(1.0, in0 * DEFAULT_GROUPING_FACTOR)
            dr = max(1.0, in1 * DEFAULT_GROUPING_FACTOR)
            rows = in0 * in1 / max(dl, dr, 1.0)
        return rows * _map_selectivity_like(top)
    if isinstance(top, CrossOp):
        return in0 * in1 * _map_selectivity_like(top)
    if isinstance(top, CoGroupOp):
        return float(h.distinct_keys) if h.distinct_keys \
            else max(1.0, max(in0, in1) * DEFAULT_GROUPING_FACTOR)
    raise TypeError(type(top).__name__)


def _lookup(by_name: Mapping[str, Node], nm: str) -> Optional[Node]:
    """Resolve a stage-key operator name against a flow, falling back from a
    split Reduce's halves (`X.pre`/`X.merge`, `reorder.split_reduce` naming)
    to the unsplit `X` — observations made under a split plan must still
    calibrate the base flow the next search starts from."""
    n = by_name.get(nm)
    if n is None and nm.endswith((".pre", ".merge")):
        n = by_name.get(nm.rsplit(".", 1)[0])
    return n


def drift_score(root: Node, store: StatsStore, min_rows: float = 8.0,
                newer_than: int = 0) -> float:
    """Cheap drift statistic: the worst per-stage |log2(observed / priced)|
    over recently observed stages, pricing each stage LOCALLY at its observed
    input rows under `root`'s current hints.  Right after a calibration swap
    the posterior hints reproduce the EWMAs, so the score collapses toward 0;
    a stationary workload with honest hints never leaves the hysteresis band.
    Stages where both sides are below `min_rows` are skipped — tiny absolute
    counts make log-ratios pure noise."""
    by_name = {n.name: n for n in root.iter_nodes()}
    score = 0.0
    for names, obs in store.stages():
        if obs.batches == 0 or obs.last_tick <= newer_than:
            continue
        nodes = [by_name.get(nm) for nm in names]
        if any(n is None for n in nodes):
            continue  # stale key from a differently fused previous plan
        exp = _stage_expected(nodes, obs.ewma_in)
        if max(obs.ewma_out, exp) < min_rows:
            continue
        score = max(score, abs(math.log2(max(obs.ewma_out, 0.5)
                                         / max(exp, 0.5))))
    return score


def calibrate_hints(root: Node, store: StatsStore, prior_weight: float = 4.0,
                    quant: int = 4, newer_than: int = 0) -> Node:
    """Rebuild `root` with posterior hints derived from `store`.

    Per observed stage, the observed/prior ratio is absorbed into the hint
    the estimator actually reads for that operator kind: Map chains split the
    log-correction evenly over their fused ops' selectivities (only the
    product is observable — and only the product prices stage boundaries);
    Reduce/CoGroup get posterior `distinct_keys` (and `group_selectivity`
    for group filters) from the observed group counts; Match/Cross fold the
    whole observed fanout into `join_fanout`/`selectivity`.  Posteriors are
    confidence-blended against the prior (`prior_weight` pseudo-batches) and
    quantized onto the 2^(1/quant) grid, so the returned flow's
    `semantic_key` identifies the calibration REGIME: unchanged statistics
    reproduce the identical flow, and a genuinely shifted workload lands on
    a new, cache-coexisting identity.  Unobserved operators keep their
    hints; the tree is rebuilt bottom-up sharing unchanged subtrees.
    """
    by_name = {n.name: n for n in root.iter_nodes()}
    posterior: dict[str, Hints] = {}

    def q(x: float) -> float:
        return _quantize_log2(x, quant)

    # oldest-first, so when two stage keys resolve to one operator (a stale
    # fusion grouping plus the current one, or a split Reduce's halves next
    # to the unsplit base), the FRESHEST observation writes the posterior
    for names, obs in sorted(store.stages(),
                             key=lambda kv: kv[1].last_tick):
        if obs.batches == 0 or obs.last_tick <= newer_than:
            continue
        nodes = [_lookup(by_name, nm) for nm in names]
        if any(n is None for n in nodes):
            continue
        top = nodes[-1]
        rout = max(obs.ewma_out, 0.25)  # zero survivors: tiny, not log(0)
        in0 = max(obs.ewma_in[0], 1.0) if obs.ewma_in else 1.0
        in1 = max(obs.ewma_in[1], 1.0) if len(obs.ewma_in) > 1 else 1.0
        if isinstance(top, MapOp):
            prior_prod = 1.0
            for n in nodes:
                prior_prod *= max(_map_selectivity(n), 1e-9)
            corr = (math.log(rout / in0) - math.log(prior_prod)) / len(nodes)
            for n in nodes:
                seen = _map_selectivity(n) * math.exp(corr)
                posterior[n.name] = dataclasses.replace(
                    n.hints, selectivity=q(_blend(
                        _map_selectivity(n), seen, obs.batches, prior_weight)))
        elif isinstance(top, ReduceOp):
            h, new = top.hints, {}
            # a combiner's output rows ARE its observed per-worker group
            # count (min(rows, groups·dop) realized), so they calibrate
            # distinct_keys directly; its recorded `groups` side-channel is
            # deliberately absent (per-shard counts over-count globally)
            g_obs = rout if top.combiner else obs.ewma_groups
            if g_obs is not None:
                prior_g = float(h.distinct_keys) if h.distinct_keys \
                    else in0 * DEFAULT_GROUPING_FACTOR
                # the declared hint speaks for deployment scale; compare at
                # the serving-batch scale the observation was made at
                prior_g = min(max(prior_g, 1.0), in0)
                g = _blend(prior_g, max(g_obs, 1.0), obs.batches,
                           prior_weight)
                new["distinct_keys"] = max(1, round(q(g)))
            ke = top.props.kat_emit
            groups_obs = max(obs.ewma_groups or 1.0, 1.0)
            if ke is KatEmit.PASSTHROUGH_FILTER:
                prior_gs = h.group_selectivity \
                    if h.group_selectivity is not None \
                    else DEFAULT_GROUP_FILTER_SELECTIVITY
                new["group_selectivity"] = min(1.0, q(_blend(
                    prior_gs, rout / in0, obs.batches, prior_weight)))
            elif ke is KatEmit.PER_GROUP_FILTER \
                    and obs.ewma_groups is not None:
                prior_gs = h.group_selectivity \
                    if h.group_selectivity is not None \
                    else DEFAULT_GROUP_FILTER_SELECTIVITY
                new["group_selectivity"] = min(1.0, q(_blend(
                    prior_gs, rout / groups_obs, obs.batches, prior_weight)))
            if new:
                posterior[top.name] = dataclasses.replace(h, **new)
        elif isinstance(top, MatchOp) and top.anti:
            # an anti join is a global filter on the left side: the observed
            # survivor fraction IS its selectivity (join_fanout untouched —
            # the anti estimator never reads it)
            prior_s = top.hints.selectivity \
                if top.hints.selectivity is not None \
                else DEFAULT_FILTER_SELECTIVITY
            s = min(1.0, q(_blend(prior_s, rout / in0, obs.batches,
                                  prior_weight)))
            posterior[top.name] = dataclasses.replace(
                top.hints, selectivity=s)
        elif isinstance(top, MatchOp):
            # fold the complete observed fanout (UDF selectivity included)
            # into join_fanout; selectivity pinned to 1.0 so the estimator
            # does not apply a second factor on top
            prior_f = _stage_expected([top], (in0, in1)) / in0
            f = q(_blend(prior_f, rout / in0, obs.batches, prior_weight))
            posterior[top.name] = dataclasses.replace(
                top.hints, join_fanout=f, selectivity=1.0)
        elif isinstance(top, CrossOp):
            prior_s = _map_selectivity_like(top)
            s = q(_blend(prior_s, rout / max(in0 * in1, 1.0), obs.batches,
                         prior_weight))
            posterior[top.name] = dataclasses.replace(
                top.hints, selectivity=s)
        elif isinstance(top, CoGroupOp):
            prior_g = float(top.hints.distinct_keys) \
                if top.hints.distinct_keys \
                else max(1.0, max(in0, in1) * DEFAULT_GROUPING_FACTOR)
            g = _blend(min(prior_g, in0 + in1), rout, obs.batches,
                       prior_weight)
            posterior[top.name] = dataclasses.replace(
                top.hints, distinct_keys=max(1, round(q(g))))

    if not posterior:
        return root

    def rebuild(n: Node) -> Node:
        kids = [rebuild(c) for c in n.children]
        changed = any(k is not c for k, c in zip(kids, n.children))
        h = posterior.get(n.name) if not isinstance(n, Source) else None
        if not changed and h is None:
            return n
        out = n.with_children(*kids) if changed else n
        if h is not None and h != out.hints:
            out = dataclasses.replace(out, hints=h)
        return out

    return rebuild(root)


def wire_profile(plan, dop: int = 1,
                 stats_memo: Optional[dict] = None) -> list[dict]:
    """Predicted collective traffic of a physical plan, one entry per
    non-forward shipped edge: the §7.1-estimated global rows/bytes that the
    comms cost model priced against `hw` link bandwidth.

    Duck-typed over `physical.PhysPlan` (`.node` / `.inputs` / `.ship`) to
    keep this module physical-agnostic.  `bytes` is valid-row traffic; the
    runtime ships fixed-capacity buffers (capacity x workers slots), so
    observed `distributed.shuffle_stats().wire_bytes` exceeds the model by
    the slack/bucketing factor — the bench reports both sides of that ratio
    (benchmarks/bench_distributed.py)."""
    if stats_memo is None:
        stats_memo = {}
    edges: list[dict] = []
    seen: set[int] = set()

    def visit(p) -> None:
        if id(p) in seen:
            return
        seen.add(id(p))
        for ip, how in zip(p.inputs, p.ship or ()):
            visit(ip)
            if how == "forward":
                continue
            st = estimate(ip.node, stats_memo, dop)
            scale = float(dop) if how == "broadcast" else 1.0
            edges.append({"op": p.node.name, "input": ip.node.name,
                          "ship": how, "rows": st.rows,
                          "bytes": st.bytes * scale})

    visit(plan)
    return edges
