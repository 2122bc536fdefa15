"""TPC-H Q7 (Volume Shipping), simplified as in the paper's Fig. 2, in plain
PyTorch: the tables' generator, the query's plain reference and the work
the query needs.  Imports nothing of the program.

The generator is a torch copy of the numpy binding generator of the flow
(`flows/q7.py`): the same distributions; the flow declares no order.
"""

import torch

from portbench.plain import pk_lookup

FACT = "lineitem"
KEYS = ("s_nationkey", "c_nationkey", "l_year")
SHIP_LO, SHIP_HI = 8766, 9496
I64, F64 = torch.int64, torch.float64


def generate(rows: dict, gen: torch.Generator, device, new) -> dict:
    """Tables of `rows[table]` rows from `gen`: {table: {column: tensor}}.
    `new(table, column, n, dtype)` gives the tensor each column is written
    into."""
    n, n_su = rows["lineitem"], rows["supplier"]
    n_o, n_c = rows["orders"], rows["customer"]

    def ints(table, col, count, lo, hi):
        out = new(table, col, count, I64)
        return torch.randint(lo, hi, (count,), generator=gen, device=device,
                             out=out)

    def keys(table, col, count):
        out = new(table, col, count, I64)
        return torch.arange(count, device=device, out=out)

    volume = new("lineitem", "l_volume", n, F64)
    torch.rand(n, generator=gen, device=device, dtype=F64, out=volume)
    li = {"l_orderkey": ints("lineitem", "l_orderkey", n, 0, n_o),
          "l_suppkey": ints("lineitem", "l_suppkey", n, 0, n_su),
          "l_year": ints("lineitem", "l_year", n, 1992, 1999),
          "l_volume": volume.mul_(999.0).add_(1.0).round_(decimals=2),
          "l_ship": ints("lineitem", "l_ship", n, 8000, 10000)}
    return {
        "lineitem": li,
        "supplier": {"s_suppkey": keys("supplier", "s_suppkey", n_su),
                     "s_nationkey": ints("supplier", "s_nationkey", n_su,
                                         0, 25)},
        "orders": {"o_orderkey": keys("orders", "o_orderkey", n_o),
                   "o_custkey": ints("orders", "o_custkey", n_o, 0, n_c)},
        "customer": {"c_custkey": keys("customer", "c_custkey", n_c),
                     "c_nationkey": ints("customer", "c_nationkey", n_c,
                                         0, 25)},
    }



def reference(tables: dict, dtype=F64) -> dict:
    """The written query's answer as plain PyTorch, one row per (supplier
    nation, customer nation, year) pair that shipped: {column: tensor}.
    `dtype` is the type the revenue is summed in."""
    li = tables["lineitem"]
    m = (li["l_ship"] >= SHIP_LO) & (li["l_ship"] < SHIP_HI)
    supp, order = li["l_suppkey"][m], li["l_orderkey"][m]
    year, vol = li["l_year"][m], li["l_volume"][m]
    su, od, cu = tables["supplier"], tables["orders"], tables["customer"]
    hit, row = pk_lookup(su["s_suppkey"], supp)
    sn = su["s_nationkey"][row]
    hit_o, row_o = pk_lookup(od["o_orderkey"], order)
    cust = od["o_custkey"][row_o]
    hit_c, row_c = pk_lookup(cu["c_custkey"], cust)
    cn = cu["c_nationkey"][row_c]
    keep = hit & hit_o & hit_c & (((sn == 1) & (cn == 2))
                                  | ((sn == 2) & (cn == 1)))
    key = torch.stack([sn[keep], cn[keep], year[keep]], dim=1)
    groups, inv = torch.unique(key, dim=0, return_inverse=True)
    rev = torch.zeros(groups.shape[0], dtype=dtype, device=key.device)
    rev.index_add_(0, inv, vol[keep].to(dtype))
    return {"s_nationkey": groups[:, 0], "c_nationkey": groups[:, 1],
            "l_year": groups[:, 2], "revenue": rev}


def least_work(tables: dict, answer_rows: int) -> tuple:
    """(bytes, float64 operations) the query needs: l_ship of every row
    read once, the four other lineitem columns of the rows in the window,
    the supplier, orders and customer tables once, the answer (4 columns)
    written once; an add a row in the window."""
    li = tables["lineitem"]
    n = li["l_ship"].shape[0]
    kept = int(((li["l_ship"] >= SHIP_LO) & (li["l_ship"] < SHIP_HI)).sum())
    dims = sum(16 * tables[t][c].shape[0] for t, c in
               (("supplier", "s_suppkey"), ("orders", "o_orderkey"),
                ("customer", "c_custkey")))
    return 8 * n + 32 * kept + dims + 32 * answer_rows, kept


def control(tables: dict) -> dict:
    """The control: the reference in the program's place, in float32, the
    precision next below the float64 the configuration states."""
    return reference(tables, dtype=torch.float32)
