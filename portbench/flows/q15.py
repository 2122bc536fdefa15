"""TPC-H Q15 (Top Supplier), simplified as in the paper's Fig. 3: a
ship-date filter, revenue grouped by supplier, a PK join with supplier.

A frozen copy of the flow `repro_torch.configs.flows.q15` builds (UDFs,
schemas, hints and declared orders as they stood when the benchmark was
defined), written against the program's flow API, so that an edit of the
program's own flow file cannot change the benchmark's traffic.
"""

import numpy as np

from repro_torch.core import flow as F
from repro_torch.core.operators import Hints
from repro_torch.core.record import Schema


def build(rows: dict):
    """The flow at `rows["lineitem"]` fact rows (its hints scale with it)."""
    scale = rows["lineitem"]
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
    return F.match(r, su, ["l_suppkey"], ["s_key"], name="JoinSupplier",
                   hints=Hints(pk_side="right"))
