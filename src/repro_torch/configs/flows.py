"""The paper's own "configs": the four evaluation data flows (Sec. 7.2),
parameterized by scale so benchmarks, tests and examples share one builder.

Each builder returns (flow_root, make_bindings(n, seed) -> dict[str, batch]).
Cardinality hints mirror the paper's compiler-hint mechanism (Sec. 7.1);
selectivities are chosen so the optimizer faces the paper's trade-offs.

Physical-property declarations (`Source.sorted_on`) mirror the paper's
interesting-properties mechanism: the serving tier maintains its extracts in
key order (PK tables in PK order, fact extracts clustered on the hot
grouping key), declares that order, and the optimizer AND the order-aware
runtime (DESIGN.md §8) exploit it — the eager reference executor ignores it
and re-sorts, which is exactly the gap the paper's reordering line measures.
The binding generators emit genuinely sorted data for every declared order,
so all executors stay comparable on identical inputs.

Port of `repro.configs.flows`: the same flows, hints and numpy binding
generators (so one seed gives both packages identical data); the UDFs are
written against the torch tensors the port hands them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import flow as F
from ..core.operators import Hints
from ..core.record import Schema, batch_from_dict


# ---------------------------------------------------------------------------
# TPC-H Q7 (simplified, Fig. 2): 4-relation join + local predicate + group-agg
# ---------------------------------------------------------------------------
def q7(scale: int = 1_000_000):
    li = F.source("lineitem", Schema.of(
        l_orderkey=np.int64, l_suppkey=np.int64, l_year=np.int64,
        l_volume=np.float64, l_ship=np.int64), num_records=scale)
    su = F.source("supplier", Schema.of(
        s_suppkey=np.int64, s_nationkey=np.int64), num_records=scale // 600)
    orders = F.source("orders", Schema.of(
        o_orderkey=np.int64, o_custkey=np.int64), num_records=scale // 4)
    cu = F.source("customer", Schema.of(
        c_custkey=np.int64, c_nationkey=np.int64), num_records=scale // 40)

    def ship_filter(ir, out):
        out.emit(ir.copy(), where=(ir.get("l_ship") >= 8766)
                 & (ir.get("l_ship") < 9496))

    def nation_pair(ir, out):
        sn, cn = ir.get("s_nationkey"), ir.get("c_nationkey")
        out.emit(ir.copy(), where=((sn == 1) & (cn == 2)) | ((sn == 2) & (cn == 1)))

    def agg_volume(g, out):
        out.emit(g.keys().set("revenue", g.sum("l_volume")))

    f1 = F.map_(li, ship_filter, name="FilterShipdate",
                hints=Hints(selectivity=0.3))
    j1 = F.match(f1, su, ["l_suppkey"], ["s_suppkey"], name="JoinSupplier",
                 hints=Hints(pk_side="right"))
    j2 = F.match(j1, orders, ["l_orderkey"], ["o_orderkey"], name="JoinOrders",
                 hints=Hints(pk_side="right"))
    j3 = F.match(j2, cu, ["o_custkey"], ["c_custkey"], name="JoinCustomer",
                 hints=Hints(pk_side="right"))
    f2 = F.map_(j3, nation_pair, name="FilterNationPair",
                hints=Hints(selectivity=0.0032))
    root = F.reduce_(f2, ["s_nationkey", "c_nationkey", "l_year"], agg_volume,
                     name="AggRevenue", hints=Hints(distinct_keys=14))

    def bindings(n=20_000, seed=0):
        rng = np.random.default_rng(seed)
        n_su, n_o, n_c = max(n // 600, 4), max(n // 4, 8), max(n // 40, 4)
        return {
            "lineitem": batch_from_dict({
                "l_orderkey": rng.integers(0, n_o, n),
                "l_suppkey": rng.integers(0, n_su, n),
                "l_year": rng.integers(1992, 1999, n),
                "l_volume": rng.uniform(1, 1000, n).round(2),
                "l_ship": rng.integers(8000, 10000, n)}),
            "supplier": batch_from_dict({
                "s_suppkey": np.arange(n_su),
                "s_nationkey": rng.integers(0, 25, n_su)}),
            "orders": batch_from_dict({
                "o_orderkey": np.arange(n_o),
                "o_custkey": rng.integers(0, n_c, n_o)}),
            "customer": batch_from_dict({
                "c_custkey": np.arange(n_c),
                "c_nationkey": rng.integers(0, 25, n_c)}),
        }

    return root, bindings


# ---------------------------------------------------------------------------
# TPC-H Q15 (Fig. 3): local predicate + group-agg + PK-FK join
# ---------------------------------------------------------------------------
def q15(scale: int = 6_000_000):
    # the lineitem extract is clustered on the revenue grouping key and the
    # supplier table is stored in PK order — declared so grouping and the
    # PK probe can reuse the order instead of re-sorting per batch
    li = F.source("lineitem", Schema.of(
        l_suppkey=np.int64, l_ext=np.float64, l_disc=np.float64,
        l_ship=np.int64), num_records=scale, sorted_on=("l_suppkey",))
    su = F.source("supplier", Schema.of(
        s_key=np.int64, s_name=np.int64, s_addr=np.int64),
        num_records=scale // 600, sorted_on=("s_key",))

    def ship_filter(ir, out):
        out.emit(ir.copy(), where=(ir.get("l_ship") >= 9100)
                 & (ir.get("l_ship") < 9190))

    def total_rev(g, out):
        out.emit(g.keys().set(
            "total_rev", g.sum(g.get("l_ext") * (1.0 - g.get("l_disc")))))

    f = F.map_(li, ship_filter, name="FilterShipdate",
               hints=Hints(selectivity=0.04))
    r = F.reduce_(f, ["l_suppkey"], total_rev, name="AggRevenue",
                  hints=Hints(distinct_keys=scale // 600))
    root = F.match(r, su, ["l_suppkey"], ["s_key"], name="JoinSupplier",
                   hints=Hints(pk_side="right"))

    def bindings(n=20_000, seed=0):
        rng = np.random.default_rng(seed)
        n_su = max(n // 600, 4)
        suppkey = np.sort(rng.integers(0, n_su, n))  # clustered extract
        return {
            "lineitem": batch_from_dict({
                "l_suppkey": suppkey,
                "l_ext": rng.uniform(1, 1000, n).round(2),
                "l_disc": rng.uniform(0, 0.1, n).round(3),
                # ship dates span the full 2250-day horizon so the 90-day
                # window filter actually has the declared 0.04 selectivity
                # (hints size the runtime's compaction buffers — a hint off
                # by more than the slack would truncate)
                "l_ship": rng.integers(8000, 10250, n)}),
            "supplier": batch_from_dict({
                "s_key": np.arange(n_su),
                "s_name": rng.integers(0, 10_000, n_su),
                "s_addr": rng.integers(0, 10_000, n_su)}),
        }

    return root, bindings


# ---------------------------------------------------------------------------
# Q15 with a controllable hint/data gap: the adaptive-feedback workload
# ---------------------------------------------------------------------------
def q15_drift(hint_selectivity: float = 1.0, scale: int = 6_000_000):
    """The q15 shape with the ship-date filter's hint DECOUPLED from the
    data: the flow declares `hint_selectivity` (default 1.0 — "the filter
    keeps everything") while the binding generator produces whatever true
    selectivity the caller asks for per batch (default 0.04, i.e. a 25x
    overestimate).  This is the adaptive-statistics benchmark workload
    (benchmarks/bench_adaptive.py, DESIGN.md §9): the shipped plan is
    CORRECT under the wrong hint — capacities are oversized, never too
    small — but every downstream stage pays sorts and probes over 25x more
    slots than the data needs, until observed-cardinality calibration swaps
    in a rightly-sized plan.  `true_sel` moving across batches exercises
    drift; the oracle plan for a workload is `q15_drift(hint_selectivity=
    true_sel)` compiled directly."""
    li = F.source("lineitem", Schema.of(
        l_suppkey=np.int64, l_ext=np.float64, l_disc=np.float64,
        l_ship=np.int64), num_records=scale, sorted_on=("l_suppkey",))
    su = F.source("supplier", Schema.of(
        s_key=np.int64, s_name=np.int64, s_addr=np.int64),
        num_records=scale // 600, sorted_on=("s_key",))

    def ship_filter(ir, out):
        out.emit(ir.copy(), where=(ir.get("l_ship") >= 9100)
                 & (ir.get("l_ship") < 9190))

    def total_rev(g, out):
        out.emit(g.keys().set(
            "total_rev", g.sum(g.get("l_ext") * (1.0 - g.get("l_disc")))))

    f = F.map_(li, ship_filter, name="FilterShipdate",
               hints=Hints(selectivity=hint_selectivity))
    r = F.reduce_(f, ["l_suppkey"], total_rev, name="AggRevenue",
                  hints=Hints(distinct_keys=scale // 600))
    root = F.match(r, su, ["l_suppkey"], ["s_key"], name="JoinSupplier",
                   hints=Hints(pk_side="right"))

    def bindings(n=20_000, seed=0, true_sel=0.04):
        rng = np.random.default_rng(seed)
        n_su = max(n // 600, 4)
        # place exactly ~true_sel of the ship dates inside the filter's
        # [9100, 9190) window, the rest uniformly outside it
        in_win = rng.random(n) < true_sel
        outside = rng.integers(8000, 10250 - 90, n)
        outside = np.where(outside >= 9100, outside + 90, outside)
        ship = np.where(in_win, rng.integers(9100, 9190, n), outside)
        return {
            "lineitem": batch_from_dict({
                "l_suppkey": np.sort(rng.integers(0, n_su, n)),
                "l_ext": rng.uniform(1, 1000, n).round(2),
                "l_disc": rng.uniform(0, 0.1, n).round(3),
                "l_ship": ship}),
            "supplier": batch_from_dict({
                "s_key": np.arange(n_su),
                "s_name": rng.integers(0, 10_000, n_su),
                "s_addr": rng.integers(0, 10_000, n_su)}),
        }

    return root, bindings


# ---------------------------------------------------------------------------
# Clickstream sessionization (Fig. 4): two non-relational Reduces + 2 joins
# ---------------------------------------------------------------------------
def clickstream(scale: int = 400_000_000):
    # the sessionized click store is clustered by session (the log compactor
    # groups events per session); logins and users are PK-ordered extracts
    clicks = F.source("clicks", Schema.of(
        session_id=np.int64, action=np.int64, ts=np.int64, ip=np.int64),
        num_records=scale, sorted_on=("session_id",))
    logins = F.source("logins", Schema.of(
        l_session=np.int64, user_id=np.int64), num_records=scale // 16,
        sorted_on=("l_session",))
    users = F.source("users", Schema.of(
        u_id=np.int64, u_details=np.int64), num_records=scale // 700,
        sorted_on=("u_id",))

    def filter_buy(g, out):
        out.emit_records(where=g.any(g.get("action") == 1))

    def condense(g, out):
        out.emit(g.keys().set("n_clicks", g.count())
                 .set("dur", g.max("ts") - g.min("ts")))

    r1 = F.reduce_(clicks, ["session_id"], filter_buy,
                   name="FilterBuySessions",
                   hints=Hints(group_selectivity=0.4,
                               distinct_keys=scale // 8))
    r2 = F.reduce_(r1, ["session_id"], condense, name="CondenseSessions",
                   hints=Hints(distinct_keys=scale // 20))
    m1 = F.match(r2, logins, ["session_id"], ["l_session"],
                 name="FilterLoggedIn",
                 hints=Hints(pk_side="right", selectivity=0.125))
    root = F.match(m1, users, ["user_id"], ["u_id"], name="AppendUserInfo",
                   hints=Hints(pk_side="right"))

    def bindings(n=20_000, seed=0):
        rng = np.random.default_rng(seed)
        ns = max(n // 8, 16)
        nu = max(n // 700, 8)
        return {
            "clicks": batch_from_dict({
                "session_id": np.sort(rng.integers(0, ns, n)),
                "action": (rng.random(n) < 0.15).astype(np.int64),
                "ts": rng.integers(0, 100_000, n),
                "ip": rng.integers(0, 2**31, n)}),
            "logins": batch_from_dict({
                "l_session": np.sort(
                    rng.choice(ns, size=ns // 8, replace=False)
                    .astype(np.int64)),
                "user_id": rng.integers(0, nu, ns // 8)}),
            "users": batch_from_dict({
                "u_id": np.arange(nu),
                "u_details": rng.integers(0, 2**20, nu)}),
        }

    return root, bindings


# ---------------------------------------------------------------------------
# Biomedical text mining (Sec. 7.2): Map pipeline with dependency structure
# ---------------------------------------------------------------------------
def textmining(scale: int = 1_000_000):
    """Preprocess -> 4 independent annotate-and-filter extractors (gene,
    drug, mutation, disease) -> relation extractor reading all annotations.
    The 4 extractors commute freely (4! = 24 orders, matching the paper's
    Table 1); preprocess and relate are pinned by read/write conflicts."""
    docs = F.source("docs", Schema.of(
        doc_id=np.int64, text_h=np.int64, length=np.int64),
        num_records=scale)

    def _burn(v, rounds):
        # stand-in for the NLP component's per-record compute: `rounds`
        # vectorized hash iterations (cost hints mirror the real work)
        h = v
        for _ in range(rounds):
            h = (h * 31 + 7) % 1000003
        return h

    def preprocess(ir, out):  # tokenization/POS: adds pos_h, expensive
        out.emit(ir.copy().set(
            "pos_h", _burn(ir.get("text_h") * 31 + ir.get("length"), 40)))

    def mk_extractor(name, modulus, sel, cost):
        rounds = int(cost / 100)

        def extractor(ir, out):
            hit = (_burn(ir.get("pos_h"), rounds) % modulus) == 0
            out.emit(ir.copy().set(name, hit.to(torch.int64) * ir.get("doc_id")),
                     where=hit)

        extractor.__name__ = f"extract_{name}"
        return extractor, Hints(selectivity=sel, cpu_flops_per_record=cost)

    def relate(ir, out):  # needs all four annotations
        rel = _burn(ir.get("gene_m") + ir.get("drug_m")
                    + ir.get("mut_m") + ir.get("dis_m"), 70)
        out.emit(ir.copy().set("relation", rel), where=rel % 3 == 0)

    x = F.map_(docs, preprocess, name="Preprocess",
               hints=Hints(selectivity=1.0, cpu_flops_per_record=4000.0))
    for nm, modulus, sel, cost in [("gene_m", 3, 0.33, 2500.0),
                                   ("drug_m", 5, 0.2, 900.0),
                                   ("mut_m", 2, 0.5, 5200.0),
                                   ("dis_m", 7, 0.14, 1300.0)]:
        udf, hints = mk_extractor(nm, modulus, sel, cost)
        x = F.map_(x, udf, name=f"Extract[{nm}]", hints=hints)
    root = F.map_(x, relate, name="ExtractRelations",
                  hints=Hints(selectivity=0.33, cpu_flops_per_record=7000.0))

    def bindings(n=20_000, seed=0):
        rng = np.random.default_rng(seed)
        return {"docs": batch_from_dict({
            "doc_id": np.arange(n),
            "text_h": rng.integers(0, 2**40, n),
            "length": rng.integers(50, 5000, n)})}

    return root, bindings


FLOWS = {"q7": q7, "q15": q15, "clickstream": clickstream,
         "textmining": textmining}


# ---------------------------------------------------------------------------
# Synthetic plan-space shapes (logical only — enumeration/costing stress
# flows for benchmarks and optimizer tests; no bindings)
# ---------------------------------------------------------------------------
def map_chain(n_ops: int):
    """Fully-commuting Map chain: n! reorderings, the enumerator worst case."""
    sch = Schema.of(**{f"f{i}": np.int64 for i in range(n_ops)})
    node = F.source("I", sch)
    for i in range(n_ops):
        def udf(ir, out, i=i):
            out.emit(ir.copy().set(f"f{i}", ir.get(f"f{i}") + 1))

        udf.__name__ = f"op{i}"
        node = F.map_(node, udf, name=f"op{i}")
    return node


def star_join(n_rel: int):
    """Fact table PK-joined to n_rel - 1 dimensions: the joins commute
    freely, so the space covers every dimension order (and bushy shapes
    where key locality admits them)."""
    n_dims = n_rel - 1
    fact_fields = {f"k{i}": np.int64 for i in range(n_dims)}
    fact_fields["meas"] = np.float64
    node = F.source("fact", Schema.of(**fact_fields),
                    num_records=10_000_000)
    for i in range(n_dims):
        dim = F.source(f"dim{i}", Schema.of(**{f"dk{i}": np.int64,
                                               f"dv{i}": np.int64}),
                       num_records=1000 * (i + 1))
        node = F.match(node, dim, [f"k{i}"], [f"dk{i}"], name=f"J{i}",
                       hints=Hints(pk_side="right"))
    return node


def chain_join(n_rel: int):
    """R0 - R1 - ... - R(n-1) chain join: every bushy shape (Catalan(n-1)
    parenthesizations) is reachable through rotations."""
    rels = []
    for i in range(n_rel):
        fields = {f"a{i}": np.int64}
        if i > 0:
            fields[f"b{i}"] = np.int64
        if i < n_rel - 1:
            fields[f"c{i}"] = np.int64
        rels.append(F.source(f"R{i}", Schema.of(**fields),
                             num_records=10_000 * (i + 1)))
    node = rels[0]
    for i in range(1, n_rel):
        node = F.match(node, rels[i], [f"c{i - 1}"], [f"b{i}"], name=f"J{i}",
                       hints=Hints(join_fanout=1.0))
    return node
