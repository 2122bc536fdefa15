"""The multi-tenant engine (DESIGN.md §11) against the reference's, on
identical numpy-seeded requests: the coalescing transform, mux/demux round
trips, semantic-key routing, per-tenant drift isolation, the solo fallback,
truncation repair and cross-tenant subplan sharing (DESIGN.md §13).

Both engines run the same requests in the same order with synchronous
swaps, so they compare on structure — plan groups, share groups, swaps,
traces, coalesced / solo / shared counters — and every delivered result
equals the port's eager executor on the request alone (integers exactly,
floats within `RecordBatch.equivalent`'s atol).  Semantic keys are not
compared across packages: they fingerprint UDF code objects, which differ
between the packages' flow modules."""

from __future__ import annotations

import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from flowgen import canonical_rows
from test_torch_sca import (JAX, TORCH, assert_same_rows, bind, columns_of)

from repro.core import executor as jexecutor
from repro.core.cost import StatsStore as JStatsStore
from repro.core.cost import pool_stores as jpool
from repro.serve import dataflow as jdataflow
from repro_torch.core import executor as texecutor
from repro_torch.core.cost import StatsStore, pool_stores
from repro_torch.kernels import ops
from repro_torch.serve import dataflow as tdataflow

JD = types.SimpleNamespace(**vars(JAX), D=jdataflow, kw={})
TD = types.SimpleNamespace(**vars(TORCH), D=tdataflow, kw={"device": "cpu"})
N = 512  # rows per request


def _cfg(p, **over):
    """Deterministic single-threaded engine config: synchronous swaps,
    frequent probes, hair-trigger hysteresis (the reference tests')."""
    base = dict(max_coalesce=4, probe_every=4, patience=2,
                min_drift_rows=8.0, async_swap=False)
    base.update(over)
    return p.D.ServeConfig(**base)


def _engine(p, **over):
    return p.D.DataflowEngine(_cfg(p, **over), **p.kw)


def _data(d):
    """numpy columns of a package's bindings (the common currency)."""
    return {s: {f: np.asarray(v) for f, v in b.columns.items()}
            for s, b in d.items()}


def _structure(eng) -> dict:
    st = eng.stats()
    out = {k: st[k] for k in ("requests_served", "device_batches",
                              "coalesced_requests", "solo_requests",
                              "shared_requests", "shared_prefix_batches",
                              "truncations", "groups", "share_groups",
                              "repairs", "pending")}
    c = st["cache"]
    out["cache"] = (c.hits, c.misses, c.traces, c.size, c.evictions)
    out["tenants"] = {t: eng.tenant_stats(t) for t in sorted(eng._tenants)}
    return out


def _assert_eager(reqs, root_of):
    """Every delivered result equals the port's eager executor on its
    request alone."""
    for tenant, d, req in reqs:
        assert req.error is None, req.error
        assert_same_rows(columns_of(req.result(10)), columns_of(
            texecutor.execute(root_of(tenant), bind(TORCH, d))))


def _serve_both(build, rounds):
    """Run the same workload through both engines.  `build(p)` registers
    tenants and returns `{tenant: root}`; `rounds` is a list of lists of
    `(tenant, numpy data)`, each list submitted then drained.  Returns the
    port's `(engine, [(tenant, data, request)])` and both structures."""
    out = {}
    for p in (TD, JD):
        eng, roots = build(p)
        served = []
        for rnd in rounds:
            served += [(t, d, eng.submit(t, bind(p, d))) for t, d in rnd]
            eng.drain()
        out[p is TD] = (eng, roots, served, _structure(eng))
    (eng, roots, served, tstruct), jstruct = out[True], out[False][3]
    return eng, roots, served, tstruct, jstruct


# ---------------------------------------------------------------------------
# The coalescing transform
# ---------------------------------------------------------------------------
def test_coalesce_flow_structure_matches_reference():
    troot, _ = TORCH.flows.q15()
    jroot, _ = JAX.flows.q15()
    tcf, jcf = tdataflow.coalesce_flow(troot, 4), jdataflow.coalesce_flow(
        jroot, 4)
    assert tcf.root.canonical() == jcf.root.canonical()
    assert (tcf.source_tags, tcf.out_tag, tcf.tags, tcf.width) == \
        (jcf.source_tags, jcf.out_tag, jcf.tags, jcf.width)
    assert tcf.out_tag in tcf.root.out_schema
    originals = {s.name: s for s in TORCH.F.sources_of(troot)}
    for s in TORCH.F.sources_of(tcf.root):
        assert s.num_records == originals[s.name].num_records * 4
        assert s.sorted_on[0] == tcf.source_tags[s.name]
    for tn, jn in zip(sorted(tcf.root.iter_nodes(), key=lambda n: n.name),
                      sorted(jcf.root.iter_nodes(), key=lambda n: n.name)):
        assert tn.name == jn.name
        assert tuple(tn.out_schema.fields) == tuple(jn.out_schema.fields)


@pytest.mark.parametrize("p", [TD, JD], ids=["torch", "jax"])
def test_coalesce_flow_rejects_cross_limit_and_tag_collisions(p):
    sch = p.Schema(("k", "v"), {"k": np.dtype(np.int64),
                                "v": np.dtype(np.float32)})
    sa, sb = p.F.source("a", sch), p.F.source("b", sch.rename(
        {"k": "j", "v": "w"}))
    assert p.D.coalesce_flow(p.F.cross(sa, sb), 4) is None
    clash = p.F.source("c", p.Schema(("__req", "v"),
                                     {"__req": np.dtype(np.int64),
                                      "v": np.dtype(np.float32)}))
    assert p.D.coalesce_flow(clash, 4) is None
    lim = p.F.limit_(p.F.map_(p.F.source("s", SCH, num_records=64), _inc),
                     k=5, key=("a",))
    assert p.D.coalesce_flow(lim, 4) is None
    anti = p.F.match(p.F.source("s", SCH, num_records=64),
                     p.F.source("r", p.Schema.of(k=np.int64), num_records=8),
                     ["a"], ["k"], anti=True, name="anti")
    cf = p.D.coalesce_flow(anti, 4)
    assert cf is not None
    assert any(getattr(n, "anti", False) for n in cf.root.iter_nodes())


@pytest.mark.parametrize("name", ["q15", "q7", "clickstream", "textmining"])
def test_coalesce_roundtrip_is_bit_identical_to_solo_eager(name):
    """mux -> eager-execute the coalesced flow -> demux == per-request
    eager, bit for bit, in the port; and the demuxed rows equal the
    reference's round trip on the same requests."""
    troot, _ = TORCH.flows.FLOWS[name]()
    jroot, mk = JAX.flows.FLOWS[name]()
    reqs = [_data(mk(N, seed=s)) for s in range(3)]
    tcf = tdataflow.coalesce_flow(troot, 3)
    jcf = jdataflow.coalesce_flow(jroot, 3)
    tparts = tdataflow.split_result(texecutor.execute(
        tcf.root, tdataflow.coalesce_bindings(
            [bind(TORCH, d) for d in reqs], tcf)), 3, tcf)
    jparts = jdataflow.split_result(jexecutor.execute(
        jcf.root, jdataflow.coalesce_bindings(
            [bind(JAX, d) for d in reqs], jcf)), 3, jcf)
    for tp, jp, d in zip(tparts, jparts, reqs):
        ref = texecutor.execute(troot, bind(TORCH, d))
        assert set(tp.fields) == set(ref.fields)  # tags stripped
        assert canonical_rows(tp) == canonical_rows(ref)
        assert_same_rows(columns_of(tp), columns_of(jp))


# ---------------------------------------------------------------------------
# Routing and the serve paths
# ---------------------------------------------------------------------------
def test_same_flow_tenants_share_one_plan_group():
    _, mk = JAX.flows.q15()
    rounds = [[(t, _data(mk(N, seed=10 * i + ti)))
               for ti, t in enumerate("ab")] for i in range(3)]

    def build(p):
        eng = _engine(p)
        ra, _ = p.flows.q15()
        rb, _ = p.flows.q15()  # built independently: one semantic key
        eng.register("a", ra)
        eng.register("b", rb)
        return eng, {"a": ra, "b": rb}

    eng, roots, served, ts, js = _serve_both(build, rounds)
    assert ts == js
    assert ts["groups"] == 1 and ts["tenants"]["a"]["group_size"] == 2
    assert ts["coalesced_requests"] > 0 and ts["solo_requests"] > 0
    _assert_eager(served, roots.get)


def _cross(p):
    sch = p.Schema(("k", "v"), {"k": np.dtype(np.int64),
                                "v": np.dtype(np.float32)})
    return p.F.cross(p.F.source("a", sch), p.F.source(
        "b", sch.rename({"k": "j", "v": "w"})))


def test_non_coalescable_flow_serves_solo():
    def mk(seed):
        rng = np.random.default_rng(seed)
        return {"a": {"k": rng.integers(0, 8, 16).astype(np.int64),
                      "v": rng.random(16).astype(np.float32)},
                "b": {"j": rng.integers(0, 8, 8).astype(np.int64),
                      "w": rng.random(8).astype(np.float32)}}

    def build(p):
        eng = _engine(p)
        root = _cross(p)
        eng.register("t", root)
        return eng, {"t": root}

    eng, roots, served, ts, js = _serve_both(
        build, [[("t", mk(s)) for s in range(4)]])
    assert ts == js
    assert ts["coalesced_requests"] == 0 and ts["solo_requests"] == 4
    _assert_eager(served, roots.get)


def test_request_result_timeout():
    eng = _engine(TD)
    root, mk = TORCH.flows.q15()
    eng.register("t", root)
    req = eng.submit("t", mk(N, seed=0))
    with pytest.raises(TimeoutError):
        req.result(timeout=0.01)  # nobody pumped
    eng.drain()
    assert req.done and req.latency > 0


def test_engine_defaults_to_the_card():
    """Every entry point runs on the card unless told otherwise: without a
    CUDA device the default engine refuses to start."""
    import torch

    if torch.cuda.is_available():
        assert tdataflow.DataflowEngine().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdataflow.DataflowEngine()
    assert tdataflow.ServeConfig().use_kernels is False


# ---------------------------------------------------------------------------
# Tenant isolation under adversarial drift
# ---------------------------------------------------------------------------
def _drift_rounds(mk, first, last):
    return [[("a", _data(mk(N, seed=100 + 17 * i + k, true_sel=0.04)))
             for k in range(4)]
            + [("b", _data(mk(N, seed=900 + 17 * i + k, true_sel=1.0)))
               for k in range(4)]
            for i in range(first, last)]


def test_drifting_tenant_swaps_without_touching_co_tenant():
    """A and B register the same flow; A's data contradicts the declared
    selectivity ~25x.  A swaps onto its own regime exactly as in the
    reference; B keeps its group and zero swaps; after A settles, mixed
    serving adds no trace and evicts nothing."""
    _, mk = JAX.flows.q15_drift(hint_selectivity=1.0)
    out = {}
    for p in (TD, JD):
        root, _ = p.flows.q15_drift(hint_selectivity=1.0)
        eng = _engine(p, use_kernels=p is TD)
        eng.register("a", root)
        eng.register("b", root)
        served = []
        for rnd in _drift_rounds(mk, 0, 6):
            served += [(t, d, eng.submit(t, bind(p, d))) for t, d in rnd]
            eng.drain()
        swaps = eng.tenant_stats("a")["swaps"]
        snap = eng.cache.stats().traces
        for rnd in _drift_rounds(mk, 6, 13):
            served += [(t, d, eng.submit(t, bind(p, d))) for t, d in rnd]
            eng.drain()
        out[p is TD] = (_structure(eng), swaps, snap, root, served)
    ts, swaps, snap, root, served = out[True]
    assert (ts, swaps, snap) == out[False][:3]
    assert swaps >= 1, "drifting tenant never swapped"
    assert ts["tenants"]["b"]["swaps"] == 0
    assert ts["tenants"]["a"]["group_size"] == 1
    assert ts["tenants"]["b"]["group_size"] == 1 and ts["groups"] >= 2
    assert ts["cache"][2] == snap and ts["cache"][4] == 0
    _assert_eager(served, lambda t: root)


def test_truncation_falls_back_and_repairs():
    """A 50x underestimate overruns capacities: the coalesced batch is
    discarded, its requests re-serve solo and force-recalibrate the tenant,
    with the reference's counts, and every result equals eager."""
    _, mk = JAX.flows.q15_drift(hint_selectivity=0.02)
    rounds = [[("t", _data(mk(N, seed=31 * i + k, true_sel=1.0)))
               for k in range(4)] for i in range(3)]

    def build(p):
        root, _ = p.flows.q15_drift(hint_selectivity=0.02)
        eng = _engine(p)
        eng.register("t", root)
        return eng, {"t": root}

    eng, roots, served, ts, js = _serve_both(build, rounds)
    assert ts == js
    assert ts["truncations"] >= 1 and ts["tenants"]["t"]["swaps"] >= 1
    _assert_eager(served, roots.get)


@pytest.mark.parametrize("mega", ["1", "0"], ids=["mega", "composed"])
def test_launcher_workload_matches_reference(monkeypatch, mega):
    """The launcher's four tenants (q15, click, text, drift at 25x) with
    the launcher's config, synchronous swaps: the same groups, swaps,
    traces and counters as the reference, on either route, and every
    result equal to eager."""
    monkeypatch.setenv("REPRO_MEGAKERNEL", mega)
    rows, n_req = 300, 8
    names = ("q15", "clickstream", "textmining")
    mks = {n: JAX.flows.FLOWS[n]()[1] for n in names}
    _, dmk = JAX.flows.q15_drift(hint_selectivity=1.0)
    rounds = [[(n, _data(mks[n](rows, seed=1000 * ti + i)))
               for ti, n in enumerate(names)]
              + [("drift", _data(dmk(rows, seed=3000 + i, true_sel=0.04)))]
              for i in range(n_req)]

    def build(p):
        eng = p.D.DataflowEngine(p.D.ServeConfig(
            max_coalesce=16, probe_every=8, async_swap=False), **p.kw)
        roots = {n: p.flows.FLOWS[n]()[0] for n in names}
        roots["drift"] = p.flows.q15_drift(hint_selectivity=1.0)[0]
        for n, r in roots.items():
            eng.register(n, r)
        return eng, roots

    eng, roots, served, ts, js = _serve_both(build, rounds)
    assert ts == js
    assert ts["tenants"]["drift"]["swaps"] >= 1
    _assert_eager(served, roots.get)


# ---------------------------------------------------------------------------
# The background swap: its own thread, its own stream, failures surfaced
# ---------------------------------------------------------------------------
def test_async_swap_publishes_and_serves_warm():
    """With `async_swap` the drifter's regime is built and pre-traced on a
    background thread; after `join_swaps` its requests add no trace, and
    every result equals eager."""
    root, mk = TORCH.flows.q15_drift(hint_selectivity=1.0)
    eng = tdataflow.DataflowEngine(_cfg(TD, async_swap=True), device="cpu")
    eng.register("a", root)
    served = []
    for i in range(8):
        served += [("a", d, eng.submit("a", bind(TORCH, d)))
                   for d in (_data(mk(N, seed=50 + 4 * i + k, true_sel=0.04))
                             for k in range(4))]
        eng.drain()
    eng.join_swaps(timeout=60)
    assert eng.tenant_stats("a")["swaps"] >= 1
    traces = eng.cache.stats().traces
    for i in range(2):
        served += [("a", d, eng.submit("a", bind(TORCH, d)))
                   for d in (_data(mk(N, seed=500 + 4 * i + k, true_sel=0.04))
                             for k in range(4))]
        eng.drain()
    assert eng.cache.stats().traces == traces
    assert eng.stats()["swap_errors"] == 0
    _assert_eager(served, lambda t: root)


def test_failed_swap_is_raised_not_swallowed(monkeypatch):
    """A pre-trace failure on the swap thread leaves the tenant in its
    regime and is raised by `join_swaps` (the reference swallows it)."""
    root, mk = TORCH.flows.q15_drift(hint_selectivity=1.0)
    eng = tdataflow.DataflowEngine(_cfg(TD, async_swap=True), device="cpu")
    eng.register("a", root)

    def boom(g, sample):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(eng, "_pretrace", boom)
    for i in range(8):
        for k in range(4):
            eng.submit("a", mk(N, seed=70 + 4 * i + k, true_sel=0.04))
        eng.drain()
        th = eng._tenants["a"].pending  # let each swap attempt finish
        if th is not None:
            th.join(60)
    with pytest.raises(RuntimeError, match="swap failed") as info:
        eng.join_swaps(timeout=60)
    assert "kernel launch failed" in str(info.value.__cause__)
    assert eng.tenant_stats("a")["swaps"] == 0
    assert eng.stats()["swap_errors"] >= 1


def test_start_stop_serves_from_a_pump_thread():
    root, mk = TORCH.flows.q15()
    eng = tdataflow.DataflowEngine(_cfg(TD), device="cpu")
    eng.register("t", root)
    eng.start()
    try:
        reqs = [(d, eng.submit("t", d)) for d in
                (mk(N, seed=s) for s in range(6))]
        for d, r in reqs:
            assert r.result(timeout=60).equivalent(
                texecutor.execute(root, d))
    finally:
        eng.stop()
    assert eng._thread is None and eng.stats()["requests_served"] == 6


def test_launch_counts_survive_concurrent_threads():
    """The launch counters are read-modify-writes from the pump and a swap
    thread at once: under a short switch interval no update is lost."""
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ops.reset_launches()
        threads = [threading.Thread(
            target=lambda: [ops._count("span_compact") for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert ops.LAUNCHES["span_compact"] == 16 * 2000
    finally:
        sys.setswitchinterval(before)
        ops.reset_launches()


def test_udf_default_dtype_survives_concurrent_threads():
    """UDFs run with float64 as torch's process-wide default dtype; with
    the pump and a swap thread running UDFs at once, every UDF still sees
    float64 and the default is float32 again once all have returned."""
    from repro_torch.core.invoke import run_map_udf

    seen = []

    def udf(ir, out):
        seen.append(torch.get_default_dtype())
        time.sleep(0)  # give the other threads the interpreter mid-UDF
        out.emit(ir.copy().set("h", ir.get("v") * 0.5))

    def work():
        for _ in range(300):
            c = run_map_udf(udf, {"v": torch.arange(8)})
            seen.append(c.emissions[0].builder._cols["h"].dtype)

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(before)
    assert len(seen) == 2 * 12 * 300
    assert set(seen) == {torch.float64}
    assert torch.get_default_dtype() == torch.float32


# ---------------------------------------------------------------------------
# Per-tenant store policy
# ---------------------------------------------------------------------------
def test_pool_stores_batch_weighted_and_clone_independent():
    got = []
    for S, pool in ((StatsStore, pool_stores), (JStatsStore, jpool)):
        a, b = S(alpha=0.5), S(alpha=0.5)
        for _ in range(3):
            a.tick()
            a.observe_stage(("F",), (100.0,), 10.0)
        b.tick()
        b.observe_stage(("F",), (100.0,), 90.0)
        pooled = pool([a, b])
        c = a.clone()
        c.tick()
        c.observe_stage(("F",), (100.0,), 500.0)
        o = pooled.stage(("F",))
        got.append((o.batches, o.ewma_out, o.rows_out,
                    a.stage(("F",)).batches))
    assert got[0] == got[1]
    assert got[0][0] == 4 and got[0][1] == pytest.approx(0.75 * 10 + 0.25 * 90)


# ---------------------------------------------------------------------------
# Cross-tenant common-subplan sharing (DESIGN.md §13)
# ---------------------------------------------------------------------------
def _keep(r, out):
    out.emit(r.copy(), where=r.get("c") < 80)


def _inc(r, out):
    out.emit(r.copy().set("c", r.get("c") + 1))


def _agg_b(g, out):
    out.emit(g.keys().set("s", g.sum("b")))


def _agg_c(g, out):
    out.emit(g.keys().set("s", g.sum("c")))


SCH = TORCH.Schema.of(a=np.int64, b=np.int64, c=np.int64)


def _sflow(p, which: int, n: int = 128):
    """Shared prefix (keep -> inc over source `s`), per-tenant suffix."""
    sch = p.Schema.of(a=np.int64, b=np.int64, c=np.int64)
    pre = p.F.map_(p.F.map_(p.F.source("s", sch, num_records=n), _keep,
                            name="keep", hints=p.Hints(selectivity=0.8)),
                   _inc, name="inc")
    if which == 0:
        return p.F.reduce_(pre, ["a"], _agg_b, name="aggb",
                           hints=p.Hints(distinct_keys=10))
    return p.F.reduce_(pre, ["b"], _agg_c, name="aggc",
                       hints=p.Hints(distinct_keys=6))


def _sdata(seed: int, n: int = 128, c_hi: int = 100) -> dict:
    rng = np.random.default_rng(seed)
    return {"s": {"a": rng.integers(0, 10, n).astype(np.int64),
                  "b": rng.integers(0, 6, n).astype(np.int64),
                  "c": rng.integers(0, c_hi, n).astype(np.int64)}}


def test_shared_prefix_detection_matches_reference():
    for which in (0, 1):
        tsp = tdataflow.shared_prefix(_sflow(TD, which))
        jsp = jdataflow.shared_prefix(_sflow(JD, which))
        assert tsp.source == jsp.source == "s"
        assert tsp.prefix.canonical() == jsp.prefix.canonical()
        assert tsp.suffix.canonical() == jsp.suffix.canonical()
        assert set(tsp.prefix.op_names()) == {"s", "keep", "inc"}
        assert tsp.suffix.children[0].out_schema == tsp.prefix.out_schema
    assert tdataflow.shared_prefix(TD.F.map_(TD.F.source("s", SCH),
                                             _keep)) is None
    red = TD.F.reduce_(TD.F.source("s", SCH), ["a"], _agg_b,
                       hints=TD.Hints(distinct_keys=10))

    def inc_s(r, out):
        out.emit(r.copy().set("s", r.get("s") + 1))

    assert tdataflow.shared_prefix(TD.F.map_(red, inc_s)) is None


def test_shared_prefix_key_is_commute_invariant_and_regime_sensitive():
    from repro_torch.core.pipeline import semantic_key

    k0 = semantic_key(tdataflow.shared_prefix(_sflow(TD, 0)).prefix)
    k1 = semantic_key(tdataflow.shared_prefix(_sflow(TD, 1)).prefix)
    assert k0 == k1
    other = TD.F.reduce_(
        TD.F.map_(TD.F.map_(TD.F.source("s", SCH, num_records=128), _keep,
                            name="keep", hints=TD.Hints(selectivity=0.1)),
                  _inc, name="inc"),
        ["a"], _agg_b, name="aggb", hints=TD.Hints(distinct_keys=10))
    assert semantic_key(tdataflow.shared_prefix(other).prefix) != k0


def _share_engines(rounds, flows=(0, 1), **kw):
    """Both packages' sharing engines over the same rounds; each round
    submits one request per tenant against ONE bindings object (the
    pairing fingerprint is the source batch's identity)."""
    kw = {"async_swap": False, "probe_every": 1000, "share_subplans": True,
          **kw}
    out = {}
    for p in (TD, JD):
        eng = p.D.DataflowEngine(p.D.ServeConfig(**kw), **p.kw)
        for t, which in zip(("ta", "tb"), flows):
            eng.register(t, _sflow(p, which), seed_stats=False)
        served = []
        for rnd in rounds:
            shared = {d_id: bind(p, d) for d_id, d in rnd["data"].items()}
            for t, d_id in rnd["reqs"]:
                served.append((t, rnd["data"][d_id],
                               eng.submit(t, shared[d_id])))
            eng.drain()
        out[p is TD] = (eng, served, _structure(eng))
    return out[True], out[False][2]


def _sroots(flows=(0, 1)):
    roots = {t: _sflow(TD, w) for t, w in zip(("ta", "tb"), flows)}
    return roots.get


def test_shared_serving_parity_and_counters():
    rounds = [{"data": {0: _sdata(7)}, "reqs": [("ta", 0), ("tb", 0)]}] * 4
    (eng, served, ts), js = _share_engines(rounds)
    assert ts == js
    assert ts["shared_prefix_batches"] == 3 and ts["shared_requests"] == 6
    assert ts["share_groups"] == 1
    _assert_eager(served, _sroots())


def test_sharing_requires_identical_source_batch():
    rounds = [{"data": {0: _sdata(1), 1: _sdata(2)},
               "reqs": [("ta", 0), ("tb", 1)]}] * 3
    (eng, served, ts), js = _share_engines(rounds)
    assert ts == js and ts["shared_prefix_batches"] == 0
    _assert_eager(served, _sroots())


def test_sharing_requires_distinct_plan_groups():
    rounds = [{"data": {0: _sdata(3)}, "reqs": [("ta", 0), ("tb", 0)]}] * 3
    (eng, served, ts), js = _share_engines(rounds, flows=(0, 0))
    assert ts == js
    assert ts["shared_prefix_batches"] == 0 and ts["coalesced_requests"] >= 4
    _assert_eager(served, _sroots((0, 0)))


def test_shared_stage_observed_once_and_tenant_stores_disjoint():
    rounds = [{"data": {0: _sdata(11)}, "reqs": [("ta", 0), ("tb", 0)]}] * 5
    (eng, served, ts), js = _share_engines(rounds)
    assert ts == js
    ta, tb = eng._tenants["ta"], eng._tenants["tb"]
    sg = eng._prefixes[ta.prefix_key]
    assert sg.store.clock == ts["shared_prefix_batches"] == 4
    assert ta.store.clock == tb.store.clock == 5
    for t in (ta, tb):
        pre = [k for k in t.store._stages if set(k) & {"keep", "inc"}]
        assert pre and all(t.store._stages[k].batches == 1 for k in pre)

    def has(store, op):
        return any(any(op in name for name in k) for k in store._stages)

    assert has(ta.store, "aggb") and not has(ta.store, "aggc")
    assert has(tb.store, "aggc") and not has(tb.store, "aggb")


def test_drifting_sharer_leaves_group_and_peer_stays_warm():
    rounds = [{"data": {0: _sdata(22, c_hi=400), 1: _sdata(21)},
               "reqs": [("ta", 0), ("tb", 1)]}] * 15
    (eng, served, ts), js = _share_engines(
        rounds, probe_every=2, drift_high=0.4, drift_low=0.2, patience=1,
        min_drift_rows=0.0)
    assert ts == js
    ta, tb = eng._tenants["ta"], eng._tenants["tb"]
    assert ta.swaps >= 1 and tb.swaps == 0
    assert ta.prefix_key != tb.prefix_key
    assert eng._prefixes[tb.prefix_key].members == {"tb"}
    _assert_eager(served, _sroots())


def test_share_subplans_kill_switch(monkeypatch):
    rounds = [{"data": {0: _sdata(5)}, "reqs": [("ta", 0), ("tb", 0)]}] * 3
    (eng, served, ts), js = _share_engines(rounds, share_subplans=False)
    assert ts == js
    assert ts["share_groups"] == 0 and ts["shared_requests"] == 0
    monkeypatch.setenv("REPRO_SUBPLAN_SHARING", "0")
    assert tdataflow.ServeConfig().share_subplans is False
    monkeypatch.setenv("REPRO_SUBPLAN_SHARING", "1")
    assert tdataflow.ServeConfig().share_subplans is True
