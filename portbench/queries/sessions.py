"""The paper's clickstream sessionization (Sec. 7.2, Fig. 4) in plain
PyTorch: the tables' generator, the query's plain reference and the work
the query needs.  Imports nothing of the program.

The generator is a torch copy of the numpy binding generator of the flow
(`flows/sessions.py`): the same distributions, clicks clustered by
session, logins and users in key order, as the flow declares.
"""

import torch

from portbench.plain import pk_lookup

FACT = "clicks"
KEYS = ("session_id",)
I64 = torch.int64


def generate(rows: dict, gen: torch.Generator, device, new) -> dict:
    """Tables of `rows[table]` rows from `gen`: {table: {column: tensor}}.
    `new(table, column, n, dtype)` gives the tensor each column is written
    into.  `rows["sessions"]` is the number of session ids drawn from."""
    n, ns = rows["clicks"], rows["sessions"]
    nl, nu = rows["logins"], rows["users"]

    def ints(table, col, count, lo, hi):
        out = new(table, col, count, I64)
        return torch.randint(lo, hi, (count,), generator=gen, device=device,
                             out=out)

    # a sorted uniform draw of session ids: each session's count of clicks
    draw = torch.randint(0, ns, (n,), generator=gen, device=device)
    counts = torch.bincount(draw, minlength=ns)
    del draw
    sid = new("clicks", "session_id", n, I64)
    sid.copy_(torch.repeat_interleave(torch.arange(ns, device=device),
                                      counts, output_size=n))
    del counts
    action = new("clicks", "action", n, I64)
    action.copy_(torch.rand(n, generator=gen, device=device) < 0.15)
    clicks = {"session_id": sid, "action": action,
              "ts": ints("clicks", "ts", n, 0, 100_000),
              "ip": ints("clicks", "ip", n, 0, 2**31)}
    # logins: a sorted draw of distinct sessions, without replacement
    l_session = new("logins", "l_session", nl, I64)
    l_session.copy_(torch.sort(torch.randperm(
        ns, generator=gen, device=device)[:nl]).values)
    logins = {"l_session": l_session,
              "user_id": ints("logins", "user_id", nl, 0, nu)}
    u_id = new("users", "u_id", nu, I64)
    torch.arange(nu, device=device, out=u_id)
    users = {"u_id": u_id,
             "u_details": ints("users", "u_details", nu, 0, 2**20)}
    return {"clicks": clicks, "logins": logins, "users": users}



def reference(tables: dict, buy_filter_first: bool = True) -> dict:
    """The written flow's answer as plain PyTorch, one row per session with
    a buy and a login: {column: tensor}.  Session ids are non-negative
    integers, so per-session state is indexed by the id.

    `buy_filter_first=False` is the control: it pushes the buy filter below
    the session Reduce (keeps only the buy clicks, then condenses), the
    reordering the paper's analysis forbids because the Reduce is not
    relational."""
    c = tables["clicks"]
    sid, ts = c["session_id"], c["ts"]
    buy = c["action"] == 1
    size = int(sid.max()) + 1 if sid.numel() else 0
    if buy_filter_first:
        has_buy = torch.zeros(size, dtype=torch.bool, device=sid.device)
        has_buy[sid[buy]] = True
        keep = has_buy[sid]
    else:
        keep = buy
    sid, ts = sid[keep], ts[keep]
    n_clicks = torch.bincount(sid, minlength=size)
    big = torch.iinfo(I64)
    t_max = torch.full((size,), big.min, dtype=I64, device=sid.device)
    t_min = torch.full((size,), big.max, dtype=I64, device=sid.device)
    t_max.scatter_reduce_(0, sid, ts, "amax")
    t_min.scatter_reduce_(0, sid, ts, "amin")
    sessions = torch.nonzero(n_clicks).flatten()
    lg, us = tables["logins"], tables["users"]
    hit, row = pk_lookup(lg["l_session"], sessions)
    sessions, row = sessions[hit], row[hit]
    user = lg["user_id"][row]
    hit_u, row_u = pk_lookup(us["u_id"], user)
    sessions, row, user, row_u = (sessions[hit_u], row[hit_u], user[hit_u],
                                  row_u[hit_u])
    return {"session_id": sessions, "n_clicks": n_clicks[sessions],
            "dur": t_max[sessions] - t_min[sessions],
            "l_session": lg["l_session"][row], "user_id": user,
            "u_id": us["u_id"][row_u], "u_details": us["u_details"][row_u]}


def least_work(tables: dict, answer_rows: int) -> tuple:
    """(bytes, float64 operations) the query needs: session_id of every
    click read once, action and ts of the clicks of logged-in sessions, the
    logins and users tables once, the answer (7 columns) written once; no
    floating-point work."""
    c, lg = tables["clicks"], tables["logins"]
    n = c["session_id"].shape[0]
    logged = int(torch.isin(c["session_id"], lg["l_session"]).sum())
    dims = 16 * (lg["l_session"].shape[0] + tables["users"]["u_id"].shape[0])
    return 8 * n + 16 * logged + dims + 56 * answer_rows, 0


def control(tables: dict) -> dict:
    """The control: the reference in the program's place with the buy
    filter pushed below the session Reduce, which breaks the guarantee the
    configuration states (the reordered plan answers as the written flow
    does).  Every value of this data fits in 32 bits, so a narrower
    integer type would answer alike and is no control."""
    return reference(tables, buy_filter_first=False)
