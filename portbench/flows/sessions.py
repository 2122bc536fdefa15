"""The paper's clickstream sessionization (Hueske et al., PVLDB 5(11),
2012, Sec. 7.2, Fig. 4): two non-relational Reduces over sessions
(keep the sessions with a buy; condense each to its click count and
duration), then two PK joins (logins, users).

A frozen copy of the flow `repro_torch.configs.flows.clickstream` builds
(UDFs, schemas, hints and declared orders as they stood when the
benchmark was defined), so that an edit of the program's own flow file
cannot change the traffic.
"""

import numpy as np

from repro_torch.core import flow as F
from repro_torch.core.operators import Hints
from repro_torch.core.record import Schema


def build(rows: dict):
    """The flow at `rows["clicks"]` fact rows (its hints scale with it)."""
    scale = rows["clicks"]
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
    return F.match(m1, users, ["user_id"], ["u_id"], name="AppendUserInfo",
                   hints=Hints(pk_side="right"))
