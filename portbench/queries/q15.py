"""TPC-H Q15 (Top Supplier), simplified as in the paper's Fig. 3, in plain
PyTorch: the tables' generator, the query's plain reference and the work
the query needs.  Imports nothing of the program.

The generator is a torch copy of the numpy binding generator of the flow
(`flows/q15.py`): the same distributions, the lineitem extract clustered
on l_suppkey and supplier in key order, as the flow declares.
"""

import torch

from portbench.plain import pk_lookup

FACT = "lineitem"
KEYS = ("l_suppkey",)
SHIP_LO, SHIP_HI = 9100, 9190
I64, F64 = torch.int64, torch.float64


def generate(rows: dict, gen: torch.Generator, device, new) -> dict:
    """Tables of `rows[table]` rows from `gen`: {table: {column: tensor}}.
    `new(table, column, n, dtype)` gives the tensor each column is written
    into."""
    n, n_su = rows["lineitem"], rows["supplier"]

    def ints(table, col, count, lo, hi):
        out = new(table, col, count, I64)
        return torch.randint(lo, hi, (count,), generator=gen, device=device,
                             out=out)

    def uniform(table, col, count, lo, hi, decimals):
        out = new(table, col, count, F64)
        torch.rand(count, generator=gen, device=device, dtype=F64, out=out)
        return out.mul_(hi - lo).add_(lo).round_(decimals=decimals)

    # a sorted uniform draw: each supplier's count of rows, in key order
    draw = torch.randint(0, n_su, (n,), generator=gen, device=device)
    counts = torch.bincount(draw, minlength=n_su)
    del draw
    suppkey = new("lineitem", "l_suppkey", n, I64)
    suppkey.copy_(torch.repeat_interleave(
        torch.arange(n_su, device=device), counts, output_size=n))
    li = {"l_suppkey": suppkey,
          "l_ext": uniform("lineitem", "l_ext", n, 1.0, 1000.0, 2),
          "l_disc": uniform("lineitem", "l_disc", n, 0.0, 0.1, 3),
          # ship dates span the whole 2,250-day horizon, so the 90-day
          # window keeps the declared 4%
          "l_ship": ints("lineitem", "l_ship", n, 8000, 10250)}
    s_key = new("supplier", "s_key", n_su, I64)
    torch.arange(n_su, device=device, out=s_key)
    su = {"s_key": s_key,
          "s_name": ints("supplier", "s_name", n_su, 0, 10_000),
          "s_addr": ints("supplier", "s_addr", n_su, 0, 10_000)}
    return {"lineitem": li, "supplier": su}


def _shipped(li):
    return (li["l_ship"] >= SHIP_LO) & (li["l_ship"] < SHIP_HI)



def reference(tables: dict, dtype=F64) -> dict:
    """The written query's answer as plain PyTorch, one row per supplier
    that shipped in the window: {column: tensor}.  `dtype` is the type the
    revenue is computed and summed in."""
    li, su = tables["lineitem"], tables["supplier"]
    m = _shipped(li)
    key = li["l_suppkey"][m]
    rev = li["l_ext"][m].to(dtype) * (1.0 - li["l_disc"][m].to(dtype))
    groups, inv = torch.unique(key, return_inverse=True)
    total = torch.zeros(groups.shape[0], dtype=dtype, device=key.device)
    total.index_add_(0, inv, rev)
    hit, row = pk_lookup(su["s_key"], groups)
    row = row[hit]
    return {"l_suppkey": groups[hit], "total_rev": total[hit],
            "s_key": su["s_key"][row], "s_name": su["s_name"][row],
            "s_addr": su["s_addr"][row]}


def least_work(tables: dict, answer_rows: int) -> tuple:
    """(bytes, float64 operations) the query needs: l_ship of every row
    read once, the three other lineitem columns of the rows in the window,
    the supplier table once, the answer (5 columns) written once; a
    multiply, a subtract and an add a row in the window."""
    li, su = tables["lineitem"], tables["supplier"]
    n = li["l_ship"].shape[0]
    kept = int(_shipped(li).sum())
    nbytes = (8 * n + 24 * kept + 24 * su["s_key"].shape[0]
              + 40 * answer_rows)
    return nbytes, 3 * kept


def control(tables: dict) -> dict:
    """The control: the reference in the program's place, in float32, the
    precision next below the float64 the configuration states."""
    return reference(tables, dtype=torch.float32)
