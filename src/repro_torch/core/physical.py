"""Physical optimization: shipping + local strategies with interesting
properties (paper Secs. 2.1, 6, 7.1 — the Stratosphere/Nephele cost layer).

For every logical plan the physical optimizer chooses, per operator:

* a shipping strategy per input — `forward` (no communication), `partition`
  (hash repartition = `all_to_all` on the mesh data axis), or `broadcast`
  (replicate = `all_gather`);
* a local strategy — `sort` / `reuse-sort` for KAT grouping and sort-merge
  joins, `probe` for broadcast joins (sorted-probe: TPU-idiomatic stand-in
  for Nephele's hybrid-hash, see DESIGN.md §3).

Interesting properties (partitioning co-location classes + sort order)
propagate bottom-up in a Volcano-style dynamic program: `candidates()`
returns the Pareto set {property → cheapest sub-plan}, so a more expensive
sub-plan survives only if it offers a property some consumer might exploit —
exactly the integration sketched in the paper's Sec. 6 closing paragraphs.

Cost model: wall-clock seconds per term on the TARGET fabric
(`repro_torch.hw.CHIP`, TPU v5e by default, as in the reference):

    net: shuffled/broadcast bytes over per-chip ICI link bandwidth, plus a
         per-collective launch latency (`ChipSpec.ici_latency_s`, scaled by
         log2(p) hops) — small batches pay the collective's fixed cost, so
         `dop` itself becomes a costed layout decision (DESIGN.md §12)
    mem: input+output bytes over per-chip HBM bandwidth
    cpu: UDF flops + sort/probe flops over the VPU's scalar throughput

The paper's disk-I/O term becomes the HBM term (DESIGN.md §3.4).

Layout as a plan property: besides choosing partition vs. broadcast per
input, a multi-column Reduce may hash-partition on any single key column
(same wire cost, strictly more reusable co-location class), and
`optimizer.optimize_layout` sweeps `dop` over `dop_ladder(mesh)` so the
degree of parallelism is picked by the same cost model.  The chosen
partition columns travel on `PhysPlan.ship_keys` into `pipeline.lower_phys`
and the distributed runtime.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
from typing import Optional

from .. import hw
from .cost import Stats, estimate, sort_flops
from .operators import (CoGroupOp, CrossOp, LimitOp, MapOp, MatchOp, Node,
                        ReduceOp, Source, struct_id)
from .reorder import eff_writes

UDF_VECTOR_FLOPS = 4e12  # VPU-class throughput for record-wise UDF work

# mesh width the layout search prices against when the caller gives none
MESH_SHARDS_ENV = "REPRO_MESH_SHARDS"
DEFAULT_MESH_SHARDS = 8


def default_mesh_shards(available: Optional[int] = None) -> int:
    """Mesh width for layout decisions: REPRO_MESH_SHARDS, clipped to the
    device count when one is known."""
    try:
        n = int(os.environ.get(MESH_SHARDS_ENV, str(DEFAULT_MESH_SHARDS)))
    except ValueError:
        n = DEFAULT_MESH_SHARDS
    n = max(n, 1)
    if available is not None:
        n = min(n, max(available, 1))
    return n


def dop_ladder(mesh: int) -> tuple[int, ...]:
    """Candidate degrees of parallelism: powers of two up to `mesh`, plus
    `mesh` itself — the sweep `optimizer.optimize_layout` prices."""
    mesh = max(int(mesh), 1)
    out = []
    d = 1
    while d < mesh:
        out.append(d)
        d *= 2
    out.append(mesh)
    return tuple(out)


# ---------------------------------------------------------------------------
# Physical data properties & cost vectors
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Props:
    """Partitioning co-location classes + sort order of a physical stream."""

    partitions: frozenset = frozenset()   # frozenset[frozenset[str]]
    sort: tuple = ()

    def partitioned_on(self, key: frozenset) -> bool:
        """Is every key-group co-located? True iff some co-location class is
        a subset of `key` (equal key ⇒ equal class ⇒ same worker)."""
        return any(g <= key for g in self.partitions if g)

    def sorted_on(self, key: frozenset) -> bool:
        return len(key) > 0 and set(self.sort[:len(key)]) == set(key)

    def dominates(self, other: "Props") -> bool:
        sort_ok = other.sort == self.sort[:len(other.sort)]
        return other.partitions <= self.partitions and sort_ok


@dataclasses.dataclass(frozen=True)
class CostVec:
    net: float = 0.0
    mem: float = 0.0
    cpu: float = 0.0

    @property
    def total(self) -> float:
        return self.net + self.mem + self.cpu

    def __add__(self, o: "CostVec") -> "CostVec":
        return CostVec(self.net + o.net, self.mem + o.mem, self.cpu + o.cpu)


@dataclasses.dataclass(frozen=True)
class Ctx:
    """Parallel execution context (degree of parallelism + fabric).

    `megakernel` prices the fused whole-stage lowering (DESIGN.md §10):
    key-based operators fed by a forwarded Map chain gain a `megakernel`
    local-strategy candidate whose HBM term elides the input re-read — the
    chain's output never round-trips to HBM but stays VMEM-resident into
    the aggregate/probe — gated on the per-worker working set fitting VMEM.
    Off by default so existing plan goldens are unchanged; the compiled
    pipeline's route planner (kernels.megakernel.plan_routes) makes the
    actual fusion decision per bound capacity either way."""

    dop: int = 32
    chip: hw.ChipSpec = hw.CHIP
    megakernel: bool = False

    @property
    def link_bw(self) -> float:
        return self.chip.ici_link_bandwidth

    @property
    def hbm_bw(self) -> float:
        return self.chip.hbm_bandwidth


@dataclasses.dataclass(frozen=True)
class PhysPlan:
    node: Node
    inputs: tuple = ()
    ship: tuple = ()            # per input: 'forward'|'partition'|'broadcast'
    local: str = "scan"
    props: Props = Props()
    node_cost: CostVec = CostVec()
    # per input: the hash-partition columns when ship is 'partition' (None
    # otherwise / empty when defaulted).  A multi-column Reduce may partition
    # on a key SUBSET for a more reusable co-location class; the runtime must
    # then hash exactly these columns or downstream 'forward' ships break.
    ship_keys: tuple = ()

    @property
    def total_cost(self) -> CostVec:
        # cached: plans are immutable and the pruning sweep + branch-and-bound
        # query this O(plans) times, so the naive O(tree) recursion per call
        # dominated optimizer time
        c = self.__dict__.get("_tc")
        if c is None:
            c = self.node_cost
            for i in self.inputs:
                c = c + i.total_cost
            self.__dict__["_tc"] = c
        return c

    def pretty(self, indent: int = 0) -> str:
        pad = "  " * indent
        ship = "" if not self.ship else f" ship={list(self.ship)}"
        line = (f"{pad}{type(self.node).__name__}[{self.node.name}]"
                f"{ship} local={self.local} "
                f"cost(net={self.node_cost.net:.2e},mem={self.node_cost.mem:.2e},"
                f"cpu={self.node_cost.cpu:.2e})")
        return "\n".join([line] + [i.pretty(indent + 1) for i in self.inputs])


# ---------------------------------------------------------------------------
# Cost primitives
# ---------------------------------------------------------------------------
def _t_latency(ctx: Ctx) -> float:
    """Fixed launch cost of one collective: log2(p) hop latencies.  Zero at
    dop=1 (no collective fires), so small-batch layouts can beat wide ones —
    the term that makes `dop` a real costed decision rather than an input."""
    p = ctx.dop
    if p <= 1:
        return 0.0
    return ctx.chip.ici_latency_s * math.log2(p)


def _t_shuffle(bytes_total: float, ctx: Ctx) -> float:
    """all_to_all hash repartition: each worker sends its (p-1)/p share."""
    p = ctx.dop
    if p <= 1:
        return 0.0
    return (bytes_total / p) * (p - 1) / p / ctx.link_bw + _t_latency(ctx)


def _t_broadcast(bytes_total: float, ctx: Ctx) -> float:
    """all_gather replicate: each worker receives the (p-1)/p remainder."""
    p = ctx.dop
    if p <= 1:
        return 0.0
    return bytes_total * (p - 1) / p / ctx.link_bw + _t_latency(ctx)


def _t_mem(bytes_in: float, bytes_out: float, ctx: Ctx) -> float:
    return (bytes_in + bytes_out) / (ctx.dop * ctx.hbm_bw)


def _t_cpu(flops: float, ctx: Ctx) -> float:
    return flops / (ctx.dop * UDF_VECTOR_FLOPS)


def _preserved(props: Props, node: Node) -> Props:
    """Input properties that survive a record-wise operator (writes destroy)."""
    cache = node.__dict__.setdefault("_pres", {})
    hit = cache.get(props)
    if hit is not None:
        return hit
    w = eff_writes(node)
    attrs = node.attrs()
    parts = frozenset(g for g in props.partitions
                      if not (g & w) and g <= attrs)
    sort = []
    for a in props.sort:
        if a in w or a not in attrs:
            break
        sort.append(a)
    out = Props(partitions=parts, sort=tuple(sort))
    cache[props] = out
    return out


# ---------------------------------------------------------------------------
# Candidate generation per operator
# ---------------------------------------------------------------------------
def _prune(cands: list[PhysPlan]) -> dict[Props, PhysPlan]:
    """Pareto set {props -> cheapest plan}, minus dominated entries.

    Sorted dominance sweep (DESIGN.md §3.3): after deduping per property
    vector, entries are processed in ascending cost order, so an entry can
    only be dominated by one already kept — dominance (`Props.dominates`) is
    transitive, so checking against kept entries alone is exhaustive.  This
    replaces the previous O(n²) all-pairs scan; n is small per operator but
    the scan ran once per memo group, on every group of every enumerated
    flow.  Entries with exactly equal cost are swept as one batch since the
    cheaper-or-EQUAL rule lets them eliminate each other."""
    by_prop: dict[Props, PhysPlan] = {}
    for c in cands:
        cur = by_prop.get(c.props)
        if cur is None or c.total_cost.total < cur.total_cost.total:
            by_prop[c.props] = c
    if len(by_prop) <= 1:
        return by_prop

    items = sorted(by_prop.items(), key=lambda kv: kv[1].total_cost.total)
    out: dict[Props, PhysPlan] = {}
    i, n = 0, len(items)
    while i < n:
        # batch of equal-cost entries (ties may dominate each other; mutual
        # dominance is impossible after the per-props dedup above)
        j = i + 1
        cost_i = items[i][1].total_cost.total
        while j < n and items[j][1].total_cost.total == cost_i:
            j += 1
        batch = items[i:j]
        for p, plan in batch:
            if any(q.dominates(p) for q in out):
                continue
            if len(batch) > 1 and any(
                    q.dominates(p) for q, _ in batch if q != p):
                continue
            out[p] = plan
        i = j
    return out


def candidates(node: Node, ctx: Ctx, memo: Optional[dict] = None,
               stats_memo: Optional[dict] = None) -> dict[Props, PhysPlan]:
    if memo is None:
        memo = {}
    if stats_memo is None:
        stats_memo = {}
    key = struct_id(node)
    hit = memo.get(key)
    if hit is not None:
        return hit
    child_cands = [candidates(c, ctx, memo, stats_memo)
                   for c in node.children]
    pruned = _prune(_expand(node, ctx, stats_memo, child_cands))
    memo[key] = pruned
    return pruned


def _expand(node: Node, ctx: Ctx, stats_memo: dict,
            child_cands: list) -> list[PhysPlan]:
    """Physical alternatives for `node` given its children's candidate maps
    ({Props -> PhysPlan}, one per child), unpruned.

    Split out of `candidates` so group-level searches (the interleaved
    optimizer's unary fast path) can price an operator over an explicit
    sub-plan set instead of the per-subtree memo."""
    st = estimate(node, stats_memo, ctx.dop)
    out: list[PhysPlan] = []

    if isinstance(node, Source):
        parts = frozenset({frozenset(node.partitioned_on)}) \
            if node.partitioned_on else frozenset()
        props = Props(partitions=parts, sort=node.sorted_on or ())
        out.append(PhysPlan(node=node, props=props,
                            node_cost=CostVec(mem=_t_mem(st.bytes, 0, ctx))))

    elif isinstance(node, MapOp):
        cin = estimate(node.child, stats_memo, ctx.dop)
        for iprops, iplan in child_cands[0].items():
            cost = CostVec(
                mem=_t_mem(cin.bytes, st.bytes, ctx),
                cpu=_t_cpu(cin.rows * node.hints.cpu_flops_per_record, ctx))
            out.append(PhysPlan(node=node, inputs=(iplan,), ship=("forward",),
                                local="scan", props=_preserved(iprops, node),
                                node_cost=cost))

    elif isinstance(node, ReduceOp) and node.combiner:
        # Combiner (pre-aggregation) half of a split Reduce: sound on ANY
        # partition of its input, so the only strategy is per-worker local
        # aggregation with forward shipping — the merge above pays for the
        # (now much smaller) repartition.  Input partitionings within the
        # key survive: equal keys stay on one worker, so equal merge keys do.
        cin = estimate(node.child, stats_memo, ctx.dop)
        kset = frozenset(node.key)
        for iprops, iplan in child_cands[0].items():
            presorted = iprops.sorted_on(kset)
            cpu = cin.rows * node.hints.cpu_flops_per_record
            if not presorted:
                cpu += sort_flops(cin.rows / ctx.dop) * ctx.dop
            comb_sort = []
            for k in node.key:
                if k not in node.attrs():  # prefix semantics, as above
                    break
                comb_sort.append(k)
            props = Props(partitions=frozenset(g for g in iprops.partitions
                                               if g <= kset),
                          sort=tuple(comb_sort))
            cost = CostVec(mem=_t_mem(cin.bytes, st.bytes, ctx),
                           cpu=_t_cpu(cpu, ctx))
            out.append(PhysPlan(node=node, inputs=(iplan,), ship=("forward",),
                                local="reuse-sort" if presorted else "sort",
                                props=props, node_cost=cost))

    elif isinstance(node, ReduceOp):
        cin = estimate(node.child, stats_memo, ctx.dop)
        kset = frozenset(node.key)
        for iprops, iplan in child_cands[0].items():
            options = []
            if iprops.partitioned_on(kset):
                options.append(("forward", 0.0, iprops.partitions, None))
            shuffle_net = _t_shuffle(cin.bytes, ctx)
            options.append(("partition", shuffle_net, frozenset({kset}),
                            tuple(node.key)))
            # partition-key choice (DESIGN.md §12): hashing any SINGLE key
            # column still co-locates every full-key group (equal key ⇒
            # equal column), costs the same wire bytes, and leaves a
            # strictly more reusable co-location class {k} that downstream
            # consumers keyed on supersets of {k} can forward into
            if len(node.key) > 1:
                for k in node.key:
                    if k in node.attrs():
                        options.append(("partition", shuffle_net,
                                        frozenset({frozenset({k})}), (k,)))
            for ship, net, parts, pkeys in options:
                presorted = ship == "forward" and iprops.sorted_on(kset)
                local = "reuse-sort" if presorted else "sort"
                cpu = cin.rows * node.hints.cpu_flops_per_record
                if not presorted:
                    cpu += sort_flops(cin.rows / ctx.dop) * ctx.dop
                cost = CostVec(net=net,
                               mem=_t_mem(cin.bytes, st.bytes, ctx),
                               cpu=_t_cpu(cpu, ctx))
                out_sort = []
                for k in node.key:
                    # sort order survives only as a PREFIX: dropping a key
                    # column breaks lexicographic order of everything after
                    if k not in node.attrs():
                        break
                    out_sort.append(k)
                props = Props(partitions=frozenset(g for g in parts
                                                   if g <= node.attrs()),
                              sort=tuple(out_sort))
                out.append(PhysPlan(node=node, inputs=(iplan,), ship=(ship,),
                                    local=local, props=props, node_cost=cost,
                                    ship_keys=(pkeys,)))
                # fused whole-stage lowering: a forwarded Map chain feeding
                # the aggregate keeps its output VMEM-resident, eliding the
                # input re-read from the HBM term (DESIGN.md §10) — only
                # admissible when the per-worker working set fits VMEM
                if (ship == "forward" and ctx.megakernel
                        and isinstance(node.child, MapOp)
                        and (cin.bytes + st.bytes) / ctx.dop
                        <= ctx.chip.vmem_bytes):
                    mcost = CostVec(net=net,
                                    mem=_t_mem(0.0, st.bytes, ctx),
                                    cpu=_t_cpu(cpu, ctx))
                    out.append(PhysPlan(node=node, inputs=(iplan,),
                                        ship=(ship,), local="megakernel",
                                        props=props, node_cost=mcost,
                                        ship_keys=(pkeys,)))

    elif isinstance(node, LimitOp):
        # WITH-TIES top-k is a GLOBAL decision: at dop=1 it forwards and
        # preserves every input property (it writes nothing); at dop>1 the
        # only sound strategy broadcasts the input so every shard computes
        # the identical threshold, then keeps its owned slots — partitioning
        # and sort do not survive the replicate (DESIGN.md §13).
        cin = estimate(node.child, stats_memo, ctx.dop)
        kset = frozenset(node.key)
        if ctx.dop <= 1:
            for iprops, iplan in child_cands[0].items():
                covered = iprops.sorted_on(kset)
                cpu = 0.0 if covered else sort_flops(cin.rows)
                cost = CostVec(mem=_t_mem(cin.bytes, st.bytes, ctx),
                               cpu=_t_cpu(cpu, ctx))
                out.append(PhysPlan(
                    node=node, inputs=(iplan,), ship=("forward",),
                    local="reuse-sort" if covered else "sort",
                    props=_preserved(iprops, node), node_cost=cost))
        else:
            cheap = min(child_cands[0].values(),
                        key=lambda p: p.total_cost.total)
            cost = CostVec(net=_t_broadcast(cin.bytes, ctx),
                           mem=_t_mem(cin.bytes * ctx.dop, st.bytes, ctx),
                           cpu=_t_cpu(sort_flops(cin.rows) * ctx.dop, ctx))
            out.append(PhysPlan(node=node, inputs=(cheap,),
                                ship=("broadcast",), local="sort",
                                props=Props(), node_cost=cost))

    elif isinstance(node, (MatchOp, CrossOp)):
        ls = estimate(node.left, stats_memo, ctx.dop)
        rs = estimate(node.right, stats_memo, ctx.dop)
        lcands, rcands = child_cands
        is_match = isinstance(node, MatchOp)
        lk = frozenset(node.left_key) if is_match else frozenset()
        rk = frozenset(node.right_key) if is_match else frozenset()
        pair_cpu = st.rows * node.hints.cpu_flops_per_record

        if is_match:
            # (A) repartition/forward both sides, sort-merge locally
            for (lp, lplan), (rp, rplan) in itertools.product(
                    lcands.items(), rcands.items()):
                lship = "forward" if lp.partitioned_on(lk) else "partition"
                rship = "forward" if rp.partitioned_on(rk) else "partition"
                net = (0.0 if lship == "forward" else _t_shuffle(ls.bytes, ctx)) \
                    + (0.0 if rship == "forward" else _t_shuffle(rs.bytes, ctx))
                cpu = pair_cpu
                lsorted = lship == "forward" and lp.sorted_on(lk)
                rsorted = rship == "forward" and rp.sorted_on(rk)
                if not lsorted:
                    cpu += sort_flops(ls.rows / ctx.dop) * ctx.dop
                if not rsorted:
                    cpu += sort_flops(rs.rows / ctx.dop) * ctx.dop
                local = "reuse-sort" if (lsorted and rsorted) else "sort-merge"
                if node.anti:
                    # anti is a filter on the left stream: survivors keep the
                    # left side's arrival order (slot-aligned mask), and only
                    # left-key co-location survives (output has no right rows)
                    props = Props(
                        partitions=frozenset(g for g in (lk,)
                                             if g <= node.attrs()),
                        sort=lp.sort if lship == "forward" else ())
                else:
                    out_sort = []
                    for k in node.left_key:
                        if k not in node.attrs():
                            break
                        out_sort.append(k)
                    props = Props(partitions=frozenset(g for g in (lk, rk)
                                                       if g <= node.attrs()),
                                  sort=tuple(out_sort))
                cost = CostVec(net=net,
                               mem=_t_mem(ls.bytes + rs.bytes, st.bytes, ctx),
                               cpu=_t_cpu(cpu, ctx))
                out.append(PhysPlan(
                    node=node, inputs=(lplan, rplan), ship=(lship, rship),
                    local=local, props=props, node_cost=cost,
                    ship_keys=(
                        tuple(node.left_key) if lship == "partition" else None,
                        tuple(node.right_key) if rship == "partition"
                        else None)))
        # (B)/(C) broadcast one side, probe in the other side's order —
        # preserves the forwarded side's partitioning & sort (the Q15
        # physical flip in the paper's Sec. 7.3).  A broadcast destroys the
        # replicated side's properties, so only its CHEAPEST sub-plan can
        # survive pruning — pairing every forwarded candidate with it yields
        # the same Pareto set as the full product, minus dominated clones.
        cheap_l = min(lcands.values(), key=lambda p: p.total_cost.total)
        cheap_r = min(rcands.values(), key=lambda p: p.total_cost.total)
        for bc_side in (0, 1):
            # anti: only broadcast-RIGHT is sound — a replicated LEFT row
            # would be judged against each shard's partial right multiset
            # (and kept once per shard that lacks its partner)
            if bc_side == 0 and is_match and node.anti:
                continue
            bst, fst = (rs, ls) if bc_side == 1 else (ls, rs)
            net = _t_broadcast(bst.bytes, ctx)
            probe_rows = fst.rows / ctx.dop
            cpu = pair_cpu + sort_flops(bst.rows) * ctx.dop
            if is_match:
                cpu += probe_rows * max(1.0, math.log2(max(bst.rows, 2.0))) \
                    * ctx.dop
            cost = CostVec(net=net,
                           mem=_t_mem(ls.bytes + rs.bytes * ctx.dop
                                      if bc_side == 1 else
                                      rs.bytes + ls.bytes * ctx.dop,
                                      st.bytes, ctx),
                           cpu=_t_cpu(cpu, ctx))
            ship = ("forward", "broadcast") if bc_side == 1 \
                else ("broadcast", "forward")
            fwd_cands = lcands if bc_side == 1 else rcands
            fwd_node = node.left if bc_side == 1 else node.right
            # fused probe: forwarded Map-chain output stays VMEM-resident
            # into the broadcast probe, eliding its HBM re-read (§10); the
            # replicated side is fully resident per worker, so it charges
            # against VMEM undivided
            mega = (ctx.megakernel and is_match
                    and isinstance(fwd_node, MapOp)
                    and (fst.bytes + st.bytes) / ctx.dop + bst.bytes
                    <= ctx.chip.vmem_bytes)
            mcost = CostVec(net=net,
                            mem=_t_mem(bst.bytes * ctx.dop, st.bytes, ctx),
                            cpu=_t_cpu(cpu, ctx))
            for fprops, fplan in fwd_cands.items():
                inputs = (fplan, cheap_r) if bc_side == 1 else (cheap_l, fplan)
                out.append(PhysPlan(
                    node=node, inputs=inputs, ship=ship, local="probe",
                    props=_preserved(fprops, node), node_cost=cost,
                    ship_keys=(None, None)))
                if mega:
                    out.append(PhysPlan(
                        node=node, inputs=inputs, ship=ship,
                        local="megakernel", props=_preserved(fprops, node),
                        node_cost=mcost, ship_keys=(None, None)))

    elif isinstance(node, CoGroupOp):
        ls = estimate(node.left, stats_memo, ctx.dop)
        rs = estimate(node.right, stats_memo, ctx.dop)
        lk, rk = frozenset(node.left_key), frozenset(node.right_key)
        for (lp, lplan), (rp, rplan) in itertools.product(
                child_cands[0].items(), child_cands[1].items()):
            lship = "forward" if lp.partitioned_on(lk) else "partition"
            rship = "forward" if rp.partitioned_on(rk) else "partition"
            net = (0.0 if lship == "forward" else _t_shuffle(ls.bytes, ctx)) \
                + (0.0 if rship == "forward" else _t_shuffle(rs.bytes, ctx))
            cpu = (ls.rows + rs.rows) * node.hints.cpu_flops_per_record \
                + sort_flops((ls.rows + rs.rows) / ctx.dop) * ctx.dop
            props = Props(partitions=frozenset({g for g in (lk, rk)
                                                if g <= node.attrs()}))
            cost = CostVec(net=net,
                           mem=_t_mem(ls.bytes + rs.bytes, st.bytes, ctx),
                           cpu=_t_cpu(cpu, ctx))
            out.append(PhysPlan(
                node=node, inputs=(lplan, rplan), ship=(lship, rship),
                local="sort", props=props, node_cost=cost,
                ship_keys=(
                    tuple(node.left_key) if lship == "partition" else None,
                    tuple(node.right_key) if rship == "partition" else None)))
    else:
        raise TypeError(type(node).__name__)

    return out


def best_physical(flow: Node, ctx: Optional[Ctx] = None,
                  memo: Optional[dict] = None,
                  stats_memo: Optional[dict] = None) -> PhysPlan:
    """Cheapest physical plan for one logical flow."""
    ctx = ctx or Ctx()
    cands = candidates(flow, ctx, memo, stats_memo)
    return min(cands.values(), key=lambda p: p.total_cost.total)


# ---------------------------------------------------------------------------
# Admissible lower bound for branch-and-bound (DESIGN.md §4)
# ---------------------------------------------------------------------------
def _can_partition(node: Node, memo: dict) -> bool:
    """Could ANY physical plan of `node` deliver a partitioned stream?
    Partitioning is produced by partitioned Sources and by the repartition
    variants of KAT / Match operators, and at best survives everything else.
    False means every physical plan of every consumer that needs co-located
    keys must pay a repartition of this subtree's output."""
    key = struct_id(node)
    hit = memo.get(key)
    if hit is None:
        if isinstance(node, Source):
            hit = node.partitioned_on is not None
        elif isinstance(node, (ReduceOp, MatchOp, CoGroupOp)):
            hit = True
        else:
            hit = any(_can_partition(c, memo) for c in node.children)
        memo[key] = hit
    return hit


def cost_lower_bound(node: Node, ctx: Ctx, stats_memo: dict,
                     bound_memo: dict) -> float:
    """Admissible lower bound on `best_physical(node).total_cost.total`.

    Sums, per operator, only cost terms that EVERY physical alternative pays:
    the HBM traffic of reading inputs and writing output, the UDF flops, and
    — when no subtree below can possibly produce a partitioning — the
    cheapest unavoidable network step for key-based operators.  Sort and
    probe work, and any shuffle that interesting properties might elide, are
    excluded, so bound <= true cost and branch-and-bound pruning on it never
    discards the optimum.  Memoized per structural id: across enumerated
    flows, shared subtrees are bounded once."""
    key = struct_id(node)
    hit = bound_memo.get(key)
    if hit is not None:
        return hit

    st = estimate(node, stats_memo, ctx.dop)
    if isinstance(node, Source):
        lb = _t_mem(st.bytes, 0, ctx)
    elif isinstance(node, MapOp):
        cin = estimate(node.child, stats_memo, ctx.dop)
        lb = cost_lower_bound(node.child, ctx, stats_memo, bound_memo) \
            + _t_mem(cin.bytes, st.bytes, ctx) \
            + _t_cpu(cin.rows * node.hints.cpu_flops_per_record, ctx)
    elif isinstance(node, ReduceOp):
        cin = estimate(node.child, stats_memo, ctx.dop)
        # a combiner ships nothing in EVERY physical alternative, so charging
        # it any network term would make the bound inadmissible
        net = 0.0 if node.combiner or _can_partition(
            node.child, bound_memo.setdefault("_parts", {})) \
            else _t_shuffle(cin.bytes, ctx)
        lb = cost_lower_bound(node.child, ctx, stats_memo, bound_memo) \
            + net + _t_mem(cin.bytes, st.bytes, ctx) \
            + _t_cpu(cin.rows * node.hints.cpu_flops_per_record, ctx)
    elif isinstance(node, LimitOp):
        cin = estimate(node.child, stats_memo, ctx.dop)
        # at dop>1 every physical alternative broadcasts (global threshold);
        # sort work is excluded — an order-covered plan never pays it
        net = _t_broadcast(cin.bytes, ctx) if ctx.dop > 1 else 0.0
        lb = cost_lower_bound(node.child, ctx, stats_memo, bound_memo) \
            + net + _t_mem(cin.bytes, st.bytes, ctx)
    elif isinstance(node, (MatchOp, CrossOp, CoGroupOp)):
        ls = estimate(node.children[0], stats_memo, ctx.dop)
        rs = estimate(node.children[1], stats_memo, ctx.dop)
        parts = bound_memo.setdefault("_parts", {})
        net = 0.0
        if isinstance(node, CrossOp):
            # Cross has broadcast-only strategies: one side always replicates
            net = _t_broadcast(min(ls.bytes, rs.bytes), ctx)
        else:
            # every sort-merge strategy must repartition each side that
            # cannot possibly arrive co-located; Match may instead broadcast
            # one side (CoGroup may not, but min() stays admissible)
            shuffle_net = \
                (0.0 if _can_partition(node.children[0], parts)
                 else _t_shuffle(ls.bytes, ctx)) \
                + (0.0 if _can_partition(node.children[1], parts)
                   else _t_shuffle(rs.bytes, ctx))
            net = min(shuffle_net,
                      _t_broadcast(min(ls.bytes, rs.bytes), ctx))
        if isinstance(node, CoGroupOp):
            cpu = (ls.rows + rs.rows) * node.hints.cpu_flops_per_record
        else:
            cpu = st.rows * node.hints.cpu_flops_per_record
        lb = cost_lower_bound(node.children[0], ctx, stats_memo, bound_memo) \
            + cost_lower_bound(node.children[1], ctx, stats_memo, bound_memo) \
            + net + _t_mem(ls.bytes + rs.bytes, st.bytes, ctx) \
            + _t_cpu(cpu, ctx)
    else:
        raise TypeError(type(node).__name__)

    bound_memo[key] = lb
    return lb
