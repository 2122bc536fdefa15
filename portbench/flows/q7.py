"""TPC-H Q7 (Volume Shipping), simplified as in the paper's Fig. 2: a
ship-date filter, three PK joins (supplier, orders, customer), a
nation-pair filter and revenue grouped by (supplier nation, customer
nation, year).

A frozen copy of the flow `repro_torch.configs.flows.q7` builds (UDFs,
schemas and hints as they stood when the benchmark was defined), so that
an edit of the program's own flow file cannot change the traffic.
"""

import numpy as np

from repro_torch.core import flow as F
from repro_torch.core.operators import Hints
from repro_torch.core.record import Schema


def build(rows: dict):
    """The flow at `rows["lineitem"]` fact rows (its hints scale with it)."""
    scale = rows["lineitem"]
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
    return F.reduce_(f2, ["s_nationkey", "c_nationkey", "l_year"], agg_volume,
                     name="AggRevenue", hints=Hints(distinct_keys=14))
