"""At small sizes each generator gives its flow what the flow declares
(order, key ranges, distinct keys) and the statistics of the program's own
numpy binding generator (`repro_torch.configs.flows`) that it copies."""

import numpy as np
import pytest
import torch

from portbench import harness, spec
from portbench.tests.util import SMALL

CPU = torch.device("cpu")


def _tables(name, seed=3):
    cell = spec.cell(name)
    rows = SMALL[name]
    _, t = harness.make_tables(cell.query(), rows, seed, CPU)
    return rows, t


def _np_bindings(flow, n, seed=3):
    from repro_torch.configs import flows

    _, make = flows.FLOWS[flow]()
    return {k: {c: np.asarray(v) for c, v in b.to_numpy().columns.items()}
            for k, b in make(n, seed=seed).items()}


def _sorted(x):
    return bool((x[1:] >= x[:-1]).all())


@pytest.mark.parametrize("seed", [1, 2**31 + 5])
def test_generation_repeats_per_seed(seed):
    _, a = _tables("tpch-sf30.q15", seed)
    _, b = _tables("tpch-sf30.q15", seed)
    _, c = _tables("tpch-sf30.q15", seed + 1)
    for col in a["lineitem"]:
        assert torch.equal(a["lineitem"][col], b["lineitem"][col])
    assert not torch.equal(a["lineitem"]["l_ext"], c["lineitem"]["l_ext"])


def test_q15_tables_meet_the_flow():
    rows, t = _tables("tpch-sf30.q15")
    li, su = t["lineitem"], t["supplier"]
    ref = _np_bindings("q15", rows["lineitem"])
    assert _sorted(li["l_suppkey"])                       # declared order
    assert torch.equal(su["s_key"], torch.arange(rows["supplier"]))
    assert li["l_suppkey"].unique().numel() == rows["supplier"]
    ship = li["l_ship"]
    sel = float(((ship >= 9100) & (ship < 9190)).double().mean())
    ref_ship = ref["lineitem"]["l_ship"]
    ref_sel = float(((ref_ship >= 9100) & (ref_ship < 9190)).mean())
    assert abs(sel - 0.04) < 0.005 and abs(ref_sel - 0.04) < 0.005
    for col, lo, hi in (("l_ext", 1, 1000), ("l_disc", 0, 0.1)):
        x = li[col]
        assert lo <= float(x.min()) and float(x.max()) <= hi
        assert abs(float(x.mean()) - ref["lineitem"][col].mean()) < 0.01 * hi
        assert torch.equal(x, x.round(decimals=2 if col == "l_ext" else 3))


def test_q7_tables_meet_the_flow():
    rows, t = _tables("tpch-sf30.q7")
    li = t["lineitem"]
    ref = _np_bindings("q7", rows["lineitem"])["lineitem"]
    for table, key in (("supplier", "s_suppkey"), ("orders", "o_orderkey"),
                       ("customer", "c_custkey")):
        assert torch.equal(t[table][key], torch.arange(rows[table]))
    assert int(li["l_orderkey"].max()) < rows["orders"]
    assert int(li["l_suppkey"].max()) < rows["supplier"]
    sel = float(((li["l_ship"] >= 8766) & (li["l_ship"] < 9496))
                .double().mean())
    ref_sel = float(((ref["l_ship"] >= 8766) & (ref["l_ship"] < 9496)).mean())
    assert abs(sel - ref_sel) < 0.01 and abs(sel - 0.365) < 0.01
    assert set(li["l_year"].unique().tolist()) == set(range(1992, 1999))
    nations = t["supplier"]["s_nationkey"]
    assert 0 <= int(nations.min()) and int(nations.max()) < 25


def test_sessions_tables_meet_the_flow():
    rows, t = _tables("clickstream-paper.sessions")
    c, lg, us = t["clicks"], t["logins"], t["users"]
    ref = _np_bindings("clickstream", rows["clicks"])
    assert _sorted(c["session_id"]) and _sorted(lg["l_session"])
    assert lg["l_session"].unique().numel() == rows["logins"]
    assert torch.equal(us["u_id"], torch.arange(rows["users"]))
    assert int(c["session_id"].max()) < rows["sessions"]
    buy = float(c["action"].double().mean())
    assert abs(buy - ref["clicks"]["action"].mean()) < 0.01
    assert abs(buy - 0.15) < 0.01
    # the sessions with a buy: the share the flow's group filter keeps
    has = torch.zeros(rows["sessions"], dtype=torch.bool)
    has[c["session_id"][c["action"] == 1]] = True
    seen = torch.zeros(rows["sessions"], dtype=torch.bool)
    seen[c["session_id"]] = True
    ref_sid, ref_act = ref["clicks"]["session_id"], ref["clicks"]["action"]
    ref_share = len(np.unique(ref_sid[ref_act == 1])) / len(np.unique(ref_sid))
    assert abs(float(has.sum()) / float(seen.sum()) - ref_share) < 0.02
