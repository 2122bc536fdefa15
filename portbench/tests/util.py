"""Small sizes at which the harness's tests run each cell on the CPU."""

SMALL = {
    "tpch-sf30.q15": {"lineitem": 60_000, "supplier": 100},
    "tpch-sf10.q15": {"lineitem": 30_000, "supplier": 50},
    "tpch-sf30.q7": {"lineitem": 60_000, "orders": 15_000,
                     "customer": 1_500, "supplier": 100},
    "clickstream-paper.sessions": {"clicks": 160_000, "sessions": 20_000,
                                   "logins": 2_500, "users": 228},
}
