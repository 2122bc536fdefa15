"""The adaptive half of the compiled pipeline (DESIGN.md §9) against the
reference's, on identical numpy-seeded inputs: `StatsStore` accumulation
and merge, `calibrate_hints` posteriors, `drift_score`, swap counts,
calibration-regime cache semantics, truncation repair on both routes, the
observation vector and its capacities, and what only the port must show
(the force-swap keeps the mega route; a re-run leaves its bound inputs
untouched; a swap's re-optimization keeps the attribute set of ROADMAP.md
Queue 3 item 1's flow).

The reference's `test_run_device_adaptive_rejects_donation` has no twin:
the port takes no `donate` anywhere (PyTorch has no buffer donation);
`test_adaptive_rerun_leaves_bound_inputs_unchanged` holds what donation's
refusal protected."""

from __future__ import annotations

import math
import types

import numpy as np
import pytest
import torch

from test_torch_sca import (JAX, TORCH, assert_same_rows, bind, columns_of)

from repro.core import cost as jcost
from repro.core import executor as jexecutor
from repro.core import pipeline as jpipeline
from repro.core.optimizer import optimize as joptimize
from repro.core.record import batch_from_dict as jbatch
from repro_torch.core import cost as tcost
from repro_torch.core import executor as texecutor
from repro_torch.core import pipeline as tpipeline
from repro_torch.core.optimizer import optimize as toptimize
from repro_torch.core.record import batch_from_dict as tbatch

JP = types.SimpleNamespace(**vars(JAX), cost=jcost, P=jpipeline,
                           executor=jexecutor, batch=jbatch, kw={})
TP = types.SimpleNamespace(**vars(TORCH), cost=tcost, P=tpipeline,
                           executor=texecutor, batch=tbatch,
                           kw={"device": "cpu"})
PKGS = pytest.mark.parametrize("p", [TP, JP], ids=["torch", "jax"])


def _compile(p, root, **kw):
    return p.P.compile_plan(root, cache=p.P.ExecutableCache(), **p.kw, **kw)


def _hint(flow, name, attr="selectivity"):
    return getattr({n.name: n for n in flow.iter_nodes()}[name].hints, attr)


# ---------------------------------------------------------------------------
# StatsStore, calibrate_hints and drift_score: the same numbers
# ---------------------------------------------------------------------------
def _store_ewma(p):
    s = p.cost.StatsStore(alpha=0.5)
    s.tick()
    s.observe_stage(("F",), (100.0,), 40.0, groups=4.0)
    first = s.stage(("F",))
    first = (first.batches, first.rows_out, first.ewma_out, first.ewma_in)
    s.tick()
    s.observe_stage(("F",), (100.0,), 80.0, groups=8.0)
    o = s.stage(("F",))
    return first, (o.batches, o.rows_out, o.ewma_out, o.ewma_groups,
                   o.last_tick)


def _store_snap(p):
    s = p.cost.StatsStore(alpha=0.25)
    for out in (10.0, 10.0, 10.0):
        s.tick()
        s.observe_stage(("F",), (100.0,), out)
    s.tick()
    s.observe_stage(("F",), (100.0,), 500.0, snap=True)
    return s.stage(("F",)).ewma_out


def _store_merge(p):
    a, b = p.cost.StatsStore(), p.cost.StatsStore()
    for _ in range(3):
        a.tick()
        a.observe_stage(("R",), (90.0,), 30.0, groups=3.0)
        a.observe_source("S", 90.0)
    b.tick()
    b.observe_stage(("R",), (30.0,), 60.0, groups=6.0)
    b.observe_source("S", 30.0)
    a.merge(b)
    o = a.stage(("R",))
    return (o.batches, o.rows_out, o.rows_in, o.ewma_out, o.ewma_groups,
            a.source_rows()["S"])


def _pool(p):
    a, b = p.cost.StatsStore(alpha=0.5), p.cost.StatsStore(alpha=0.5)
    for _ in range(3):
        a.tick()
        a.observe_stage(("F",), (100.0,), 10.0)
    b.tick()
    b.observe_stage(("F",), (100.0,), 90.0)
    pooled = p.cost.pool_stores([a, b])
    c = a.clone()
    c.tick()
    c.observe_stage(("F",), (100.0,), 500.0)
    o = pooled.stage(("F",))
    return o.batches, o.ewma_out, o.rows_out, a.stage(("F",)).batches


@pytest.mark.parametrize("scenario", [_store_ewma, _store_snap, _store_merge,
                                      _pool],
                         ids=["ewma", "snap", "merge", "pool"])
def test_store_matches_reference(scenario):
    assert scenario(TP) == scenario(JP)


def _filter_flow(p, sel_hint, n=1024):
    src = p.F.source("I", p.Schema.of(v=np.int64, w=np.int64),
                     num_records=n)

    def keep(ir, out):
        out.emit(ir.copy(), where=ir.get("v") >= 0)

    return p.F.map_(src, keep, name="Keep",
                    hints=p.Hints(selectivity=sel_hint))


def _observe_keep(p, outs, rows_in=1000.0):
    s = p.cost.StatsStore()
    for out in outs:
        s.tick()
        s.observe_stage(("Keep",), (rows_in,), out)
    return s


def test_calibrate_full_confidence_is_quantized_observation():
    got = []
    for p in (TP, JP):
        root = _filter_flow(p, 1.0)
        cal = p.cost.calibrate_hints(root, _observe_keep(p, [40.0]),
                                     prior_weight=0.0, quant=4)
        assert root.hints.selectivity == 1.0  # rebuilt, not mutated
        got.append(cal.hints.selectivity)
    assert got[0] == got[1] == pytest.approx(
        2.0 ** (round(math.log2(0.04) * 4) / 4))


def test_calibrate_confidence_weighting_monotone():
    posts = {}
    for p in (TP, JP):
        posts[p is TP] = [
            p.cost.calibrate_hints(_filter_flow(p, 1.0),
                                   _observe_keep(p, [40.0] * k),
                                   prior_weight=4.0, quant=64
                                   ).hints.selectivity
            for k in (1, 8, 64, 256)]
    assert posts[True] == posts[False]
    assert all(a > b for a, b in zip(posts[True], posts[True][1:]))
    assert posts[True][-1] == pytest.approx(0.04, rel=0.15)


def _chain(p):
    src = p.F.source("I", p.Schema.of(v=np.int64), num_records=1024)

    def k1(ir, out):
        out.emit(ir.copy(), where=ir.get("v") % 2 == 0)

    def k2(ir, out):
        out.emit(ir.copy(), where=ir.get("v") % 3 == 0)

    return p.F.map_(p.F.map_(src, k1, name="A",
                             hints=p.Hints(selectivity=1.0)),
                    k2, name="B", hints=p.Hints(selectivity=1.0))


def test_calibrate_distributes_chain_correction():
    got = []
    for p in (TP, JP):
        s = p.cost.StatsStore()
        s.tick()
        s.observe_stage(("A", "B"), (1024.0,), 64.0)  # product 1/16
        cal = p.cost.calibrate_hints(_chain(p), s, prior_weight=0.0, quant=64)
        got.append((cal.child.hints.selectivity, cal.hints.selectivity))
    assert got[0] == got[1]
    assert got[0][0] == pytest.approx(0.25, rel=0.05)
    assert got[0][0] * got[0][1] == pytest.approx(1 / 16, rel=0.05)


def test_calibrate_reduce_and_match_posteriors():
    got = []
    for p in (TP, JP):
        root, _ = p.flows.q15()
        s = p.cost.StatsStore()
        for _ in range(8):
            s.tick()
            s.observe_stage(("FilterShipdate",), (1000.0,), 40.0)
            s.observe_stage(("AggRevenue",), (40.0,), 4.0, groups=4.0)
            s.observe_stage(("JoinSupplier",), (4.0, 16.0), 4.0, groups=4.0)
        cal = p.cost.calibrate_hints(root, s, prior_weight=0.0, quant=4)
        got.append((_hint(cal, "AggRevenue", "distinct_keys"),
                    _hint(cal, "JoinSupplier", "join_fanout"),
                    _hint(cal, "JoinSupplier"), _hint(cal, "FilterShipdate")))
    assert got[0] == got[1]
    assert got[0][:3] == (4, pytest.approx(1.0), 1.0)


def test_calibrate_quantization_defines_stable_regimes():
    """Noisy-but-stationary observations land on ONE posterior, the same in
    both packages; the port's key is stable across trials."""
    rng = np.random.default_rng(0)
    keys, posts = set(), set()
    for _ in range(6):
        outs = [40.0 * float(rng.uniform(0.95, 1.05)) for _ in range(8)]
        for p in (TP, JP):
            cal = p.cost.calibrate_hints(_filter_flow(p, 1.0),
                                         _observe_keep(p, outs),
                                         prior_weight=0.0, quant=4)
            posts.add(cal.hints.selectivity)
            if p is TP:
                keys.add(hash(p.P.semantic_key(cal)))
    assert len(keys) == 1 and len(posts) == 1


@PKGS
def test_calibrate_unobserved_flow_is_identity(p):
    root = _filter_flow(p, 0.5)
    assert p.cost.calibrate_hints(root, p.cost.StatsStore()) is root


def test_drift_score_matches_reference():
    got = []
    for p in (TP, JP):
        root = _filter_flow(p, 0.5)
        s = p.cost.StatsStore()
        for _ in range(4):
            s.tick()
            s.observe_source("I", 1000.0)
            s.observe_stage(("Keep",), (1000.0,), 500.0)
        before = p.cost.drift_score(root, s)
        s.tick()
        s.observe_stage(("Keep",), (1000.0,), 20.0, snap=True)
        got.append((before, p.cost.drift_score(root, s)))
    assert got[0] == pytest.approx(got[1])
    assert got[0][0] == pytest.approx(0.0) and got[0][1] > 4.0


def test_semantic_key_differs_across_calibration_regimes():
    root = _filter_flow(TP, 1.0)
    s = _observe_keep(TP, [40.0])
    cal = tcost.calibrate_hints(root, s, prior_weight=0.0)
    assert tpipeline.semantic_key(cal) != tpipeline.semantic_key(root)
    cal2 = tcost.calibrate_hints(root, s, prior_weight=0.0)
    assert tpipeline.semantic_key(cal2) == tpipeline.semantic_key(cal)


# ---------------------------------------------------------------------------
# Serving: swap counts, hysteresis and cache regimes, batch for batch
# ---------------------------------------------------------------------------
def _serving_flow(p, n=1024):
    src = p.F.source("I", p.Schema.of(v=np.int64, w=np.int64),
                     num_records=n)

    def keep(ir, out):
        out.emit(ir.copy(), where=ir.get("v") < n // 2)

    return p.F.map_(src, keep, name="Keep", hints=p.Hints(selectivity=0.5))


def _phase(p, n, pass_frac):
    """A batch where EXACTLY n*pass_frac rows pass `v < n//2`."""
    k = int(n * pass_frac)
    v = np.concatenate([np.zeros(k, np.int64), np.full(n - k, n, np.int64)])
    return {"I": p.batch({"v": v, "w": np.arange(n)})}


def _serve_phases(p, phases, n=1024, stats_alpha=None, **cfg):
    """Serve `(pass_frac, batches)` phases through one adaptive handle;
    returns (swaps after each phase, final cache stats, final Keep hint)."""
    stats = p.cost.StatsStore(alpha=stats_alpha) if stats_alpha else None
    cp = _compile(p, _serving_flow(p, n), stats=stats,
                  adaptive=p.P.AdaptiveConfig(**cfg))
    swaps = []
    for frac, k in phases:
        for _ in range(k):
            out = cp.run(_phase(p, n, frac))
            assert out.capacity == int(n * frac)
        swaps.append(cp.swaps)
    st = cp.cache.stats()
    return swaps, (st.traces, st.hits, st.size), _hint(cp.flow, "Keep")


def test_stationary_serving_never_swaps_or_retraces():
    rng = np.random.default_rng(1)
    fracs = [float(rng.uniform(0.45, 0.55)) for _ in range(12)]
    got = [_serve_phases(p, [(f, 1) for f in fracs], check_every=1,
                         patience=1) for p in (TP, JP)]
    assert got[0] == got[1]
    swaps, (traces, hits, _), _ = got[0]
    assert swaps[-1] == 0 and traces == 1 and hits == 11


def test_hysteresis_band_holds_through_patience():
    phases = [(0.5, 4), (0.02, 1), (0.5, 6)]
    got = [_serve_phases(p, phases, check_every=1, patience=3)
           for p in (TP, JP)]
    assert got[0] == got[1] and got[0][0][-1] == 0


def test_drift_swaps_once_then_stabilizes():
    phases = [(0.5, 4), (1 / 32, 10)]
    got = [_serve_phases(p, phases, stats_alpha=1.0, check_every=1,
                         patience=2) for p in (TP, JP)]
    assert got[0] == got[1]
    assert got[0][0] == [0, 1]
    assert got[0][2] == pytest.approx(1 / 32)


def test_swap_is_a_cache_miss_and_regimes_coexist():
    """Regimes A and B coexist as two cache entries; drifting back to A
    re-hits its warm executable — in both packages alike."""
    phases = [(0.5, 4), (1 / 32, 6), (0.5, 6)]
    got = [_serve_phases(p, phases, stats_alpha=1.0, check_every=1,
                         patience=2) for p in (TP, JP)]
    assert got[0] == got[1]
    swaps, (traces, _, size), hint = got[0]
    assert swaps == [0, 1, 2] and traces == 2 and size == 2
    assert hint == 0.5


# ---------------------------------------------------------------------------
# q15_drift: the adaptive workload, batch for batch against the reference
# ---------------------------------------------------------------------------
def test_q15_drift_flow_matches_reference():
    from test_torch_sca import props_of, schema_of

    for hint in (1.0, 0.04):
        troot, tmk = TORCH.flows.q15_drift(hint_selectivity=hint)
        jroot, jmk = JAX.flows.q15_drift(hint_selectivity=hint)
        assert troot.canonical() == jroot.canonical()
        tn = {n.name: n for n in troot.iter_nodes()}
        for j in jroot.iter_nodes():
            assert schema_of(tn[j.name].out_schema) == \
                schema_of(j.out_schema)
            if hasattr(j, "props"):
                assert vars(tn[j.name].hints) == vars(j.hints)
                assert props_of(tn[j.name].props) == props_of(j.props)
    tb, jb = tmk(600, seed=3, true_sel=0.3), jmk(600, seed=3, true_sel=0.3)
    for s in jb:
        for f, v in jb[s].columns.items():
            np.testing.assert_array_equal(tb[s].columns[f], v)


ROUTES = pytest.mark.parametrize("mega", [True, False],
                                 ids=["mega", "composed"])


@ROUTES
def test_q15_drift_swaps_as_the_reference_does(mega):
    """The 25x overestimate: both packages swap at the same batch and
    settle on the same hints, and every batch the port serves — before,
    across and after the swap — equals its eager executor."""
    n, seeds = 4000, range(4)
    jroot, jmk = JAX.flows.q15_drift(hint_selectivity=1.0)
    troot, _ = TORCH.flows.q15_drift(hint_selectivity=1.0)
    data = [{s: b.columns for s, b in jmk(n, seed=k, true_sel=0.04).items()}
            for k in seeds]
    eager = [columns_of(texecutor.execute(troot, bind(TORCH, d)))
             for d in data]
    cfg = dict(check_every=2, patience=2)
    jcp = jpipeline.compile_plan(
        joptimize(jroot, include_commutes=False).best.plan,
        cache=jpipeline.ExecutableCache(),
        adaptive=jpipeline.AdaptiveConfig(**cfg), use_megakernel=mega)
    tcp = toptimize(troot, include_commutes=False).compile(
        cache=tpipeline.ExecutableCache(), device="cpu",
        adaptive=tpipeline.AdaptiveConfig(**cfg), use_megakernel=mega,
        use_kernels=True)
    tswaps, jswaps = [], []
    for i in range(10):
        d = data[i % len(data)]
        if i % 2:  # the device-resident entry point, every other batch
            got = tcp.run_device(tcp.bind_device(bind(TORCH, d)))
        else:
            got = tcp.run(bind(TORCH, d))
        assert_same_rows(columns_of(got.to_record_batch() if i % 2 else got),
                         eager[i % len(data)])
        jcp.run(bind(JAX, d))
        tswaps.append(tcp.swaps)
        jswaps.append(jcp.swaps)
    assert tswaps == jswaps and tswaps[-1] == 1
    assert _hint(tcp.flow, "FilterShipdate") == \
        _hint(jcp.flow, "FilterShipdate") < 0.1
    assert [st.kind for st in tcp.stages] == [st.kind for st in jcp.stages]
    if mega:
        assert tcp._last_routes == jcp._last_routes
        assert any(e[0] == "mega" for e in tcp._last_routes)


@ROUTES
def test_observation_vector_and_caps_match_reference(mega):
    """`run_device_observed`: the packed counts (sources, per-stage rows,
    per-stage aux) and the stage capacities equal the reference's; the
    device part is one int64 vector, read with one copy."""
    n = 3000
    jroot, jmk = JAX.flows.q15_drift(hint_selectivity=1.0)
    troot, _ = TORCH.flows.q15_drift(hint_selectivity=1.0)
    d = {s: b.columns for s, b in jmk(n, seed=5, true_sel=0.04).items()}
    jcp = jpipeline.compile_plan(jroot, cache=jpipeline.ExecutableCache(),
                                 use_megakernel=mega)
    tcp = _compile(TP, troot, use_megakernel=mega, use_kernels=True)
    _, jc, jcaps = jcp.run_device_observed(jcp.bind_device(bind(JAX, d)))
    masked = tcp.bind_device(bind(TORCH, d))
    out, tc, tcaps = tcp.run_device_observed(masked)
    assert tc.dtype == np.int64
    assert tc.tolist() == np.asarray(jc).tolist()
    assert list(tcaps) == list(jcaps)
    assert len(tc) == 2 + 2 * len(tcp.stages)
    # the executable's own packed form: one device vector for the scalars
    # the device computed, the static -1 aux of chain stages on the host
    m, sig = tcp._masked_sig(masked)
    _, (vec, template, slots), _ = tcp._executable(sig, observe=True)(m)
    assert isinstance(vec, torch.Tensor) and vec.dtype == torch.int64
    assert vec.dim() == 1 and len(slots) == vec.numel() <= len(template)
    # folding gives the reference's store
    ts, js = tcost.StatsStore(), jcost.StatsStore()
    assert tcp.fold_observation(ts, tc, caps=tcaps) is None
    assert jcp.fold_observation(js, jc, caps=jcaps) is None
    assert [(k, o.ewma_out, o.ewma_groups) for k, o in ts.stages()] == \
        [(k, o.ewma_out, o.ewma_groups) for k, o in js.stages()]
    assert_same_rows(columns_of(out.to_record_batch()),
                     columns_of(texecutor.execute(troot, bind(TORCH, d))))


def test_observed_and_plain_executables_are_distinct_entries():
    root, mk = TORCH.flows.q15_drift(hint_selectivity=1.0)
    cp = _compile(TP, root)
    masked = cp.bind_device(mk(2000, seed=1))
    cp.run_device(masked)
    cp.run_device_observed(masked)
    cp.run_device_observed(masked)
    cp.run_device(masked)
    st = cp.cache.stats()
    assert (st.traces, st.hits, st.size) == (2, 2, 2)


# ---------------------------------------------------------------------------
# Truncation repair: an underestimated hint never ships missing rows
# ---------------------------------------------------------------------------
def _underestimated(p, reduce: bool):
    src = p.F.source("I", p.Schema.of(k=np.int64, v=np.int64),
                     num_records=2048)

    def keep(ir, out):
        out.emit(ir.copy(), where=ir.get("v") >= 0)  # keeps ~90%

    def agg(g, out):
        out.emit(g.keys().set("s", g.sum("v")))

    node = p.F.map_(src, keep, name="Keep",
                    hints=p.Hints(selectivity=0.005))
    if reduce:
        node = p.F.reduce_(node, ["k"], agg, name="Agg",
                           hints=p.Hints(distinct_keys=64))
    return node


def _trunc_data(n=2048):
    rng = np.random.default_rng(7)
    return {"I": {"k": rng.integers(0, 64, n), "v": rng.integers(-1, 10, n)}}


@pytest.mark.parametrize("reduce", [False, True], ids=["map", "map+reduce"])
@ROUTES
def test_underestimated_hint_repaired_not_truncated(reduce, mega):
    d = _trunc_data()
    got = {}
    for p in (TP, JP):
        root = _underestimated(p, reduce)
        ref = p.executor.execute(root, bind(p, d))
        cp = _compile(p, root, adaptive=p.P.AdaptiveConfig(),
                      use_megakernel=mega)
        out = cp.run(bind(p, d))
        assert out.equivalent(ref, atol=0)
        # the plain handle really would have truncated
        plain = _compile(p, root, use_megakernel=mega)
        assert plain.run(bind(p, d)).capacity < ref.capacity
        got[p is TP] = (cp.swaps, _hint(cp.flow, "Keep"))
    assert got[True] == got[False] and got[True][0] >= 1


def test_truncation_force_swap_keeps_megakernel_route():
    """An overrun INSIDE the fused span is repaired by a re-plan that stays
    on the mega route, as the reference's does."""
    d = _trunc_data()
    routes = []
    for p in (TP, JP):
        root = _underestimated(p, reduce=True)
        cp = _compile(p, root, adaptive=p.P.AdaptiveConfig(),
                      use_megakernel=True)
        assert any(e[0] == "mega" for e in cp._routes({"I": 2048}))
        out = cp.run(bind(p, d))
        assert out.equivalent(p.executor.execute(root, bind(p, d)), atol=0)
        assert cp.swaps >= 1 and cp.use_megakernel
        assert any(e[0] == "mega" for e in cp._last_routes)
        routes.append(cp._last_routes)
    assert routes[0] == routes[1]


def test_adaptive_rerun_leaves_bound_inputs_unchanged():
    """A force-swapped `run_device` re-runs the batch on the inputs it was
    given (no donation): they are bit for bit what was bound, before and
    after, and a second step on them gives the same rows."""
    root = _underestimated(TP, reduce=True)
    cp = _compile(TP, root, adaptive=tpipeline.AdaptiveConfig(),
                  use_kernels=True)
    staged = cp.bind_device(bind(TORCH, _trunc_data()))
    before = {s: ({f: c.clone() for f, c in b.columns.items()},
                  b.valid.clone()) for s, b in staged.items()}
    out = cp.run_device(staged)
    assert cp.swaps >= 1
    for s, b in staged.items():
        cols, valid = before[s]
        assert torch.equal(b.valid, valid)
        for f, c in b.columns.items():
            assert torch.equal(c, cols[f]), (s, f)
    eager = columns_of(texecutor.execute(root, bind(TORCH, _trunc_data())))
    assert_same_rows(columns_of(out.to_record_batch()), eager, atol=0)
    assert_same_rows(columns_of(cp.run_device(staged).to_record_batch()),
                     eager, atol=0)


# ---------------------------------------------------------------------------
# The swap's re-optimization keeps the attribute set (Queue 3 item 1)
# ---------------------------------------------------------------------------
def _first_b(g, out):
    out.emit(g.keys().set("fB", g.first_of("B")))


def _add_x(i):
    def udf(ir, out):
        a = ir.get("A")
        out.emit(ir.copy().set(f"X{i}", a * 2), where=a % 3 == 0)
    return udf


def test_swap_reoptimization_keeps_the_attribute_set():
    """ROADMAP.md Queue 3 item 1's flow (a projecting Reduce under six
    filtering Maps, seven operators: the group search's path) served
    adaptively with its Maps' hints 3x off: the swap re-optimizes through
    the port's group search, and every batch — across the swap — equals
    the eager executor, the X columns included."""
    node = TORCH.F.source("I", TORCH.Schema.of(A=np.int64, B=np.int64,
                                               C=np.int64, D=np.int64),
                          num_records=600)
    node = TORCH.F.reduce_(node, ["A"], _first_b, name="red",
                           hints=TORCH.Hints(distinct_keys=20))
    for i in range(6):
        node = TORCH.F.map_(node, _add_x(i), name=f"add_X{i}",
                            hints=TORCH.Hints(selectivity=1.0))
    cp = _compile(TP, node, adaptive=tpipeline.AdaptiveConfig(
        check_every=1, patience=2), use_kernels=True)
    rng = np.random.default_rng(7)
    for k in range(6):
        d = {"I": {f: rng.integers(0, 20, 600) for f in "ABCD"}}
        eager = columns_of(texecutor.execute(node, bind(TORCH, d)))
        assert set(eager) == {"A", "fB"} | {f"X{i}" for i in range(6)}
        assert_same_rows(columns_of(cp.run(bind(TORCH, d))), eager, atol=0)
    assert cp.swaps == 1
    assert {n.name for n in cp.flow.iter_nodes()} == \
        {n.name for n in node.iter_nodes()}


# ---------------------------------------------------------------------------
# Distributed observation: counts summed over the shards feed the same store
# ---------------------------------------------------------------------------
def _store_rows(store) -> tuple:
    return (store.source_rows(),
            {k: (o.rows_in, o.rows_out, o.groups) for k, o in store.stages()})


@pytest.fixture(scope="module")
def q15_observed():
    """q15 at 1,200 rows and the store the reference's one-device
    `execute_distributed` fills from it."""
    from repro.core.distributed import execute_distributed as jexecute
    from repro.core.physical import Ctx as JCtx

    jroot, make = JAX.flows.q15()
    jb = make(1200, seed=3)
    want = jcost.StatsStore()
    jexecute(joptimize(jroot, JCtx(dop=1), include_commutes=False).best.plan,
             jb, stats_store=want)
    return {n: b.columns for n, b in jb.items()}, want


@pytest.mark.parametrize("shards", [None, 8])
def test_distributed_observation_aggregates_global_counts(q15_observed,
                                                          shards):
    """The reference's test of the same name, on the default mesh (one
    shard) and on 8 shards: the store holds the GLOBAL counts, the same
    as the reference's one-device run records."""
    from repro_torch.core.distributed import execute_distributed
    from repro_torch.core.physical import Ctx

    data, want = q15_observed
    troot = TORCH.flows.q15()[0]
    tb = bind(TORCH, data)
    res = toptimize(troot, Ctx(dop=shards or 1), include_commutes=False)
    store = tcost.StatsStore()
    out = execute_distributed(res.best.plan, tb, stats_store=store,
                              mesh_shards=shards, device="cpu")
    assert out.equivalent(texecutor.execute(troot, tb), atol=1e-4)
    src = store.source_rows()
    assert src["lineitem"] == pytest.approx(1200.0)
    assert any(k[-1].startswith("AggRevenue") for k, _ in store.stages())
    (filt,) = [o for k, o in store.stages() if k[-1] == "FilterShipdate"]
    assert filt.ewma_out / filt.ewma_in[0] == pytest.approx(0.04, rel=0.5)
    if shards is None:
        assert _store_rows(store) == _store_rows(want)
    else:  # the split plan's stages differ; sources and the filter agree
        (jfilt,) = [o for k, o in want.stages() if k[-1] == "FilterShipdate"]
        assert src == want.source_rows()
        assert (filt.rows_in, filt.rows_out) == (jfilt.rows_in,
                                                  jfilt.rows_out)


# ---------------------------------------------------------------------------
# The cache's bound
# ---------------------------------------------------------------------------
def test_cache_resize_evicts_lru():
    c = tpipeline.ExecutableCache(maxsize=4)
    for k in "abcd":
        c.put(k, k)
    c.get("a")
    c.resize(2)
    st = c.stats()
    assert (st.size, st.evictions, c.maxsize) == (2, 2, 2)
    assert c.get("a") == "a" and c.get("d") == "d" and c.get("b") is None
    c.resize(0)  # floored at one entry
    assert c.maxsize == 1 and c.stats().size == 1


def test_adaptive_config_defaults_match_reference():
    import dataclasses

    assert dataclasses.asdict(tpipeline.AdaptiveConfig()) == \
        dataclasses.asdict(jpipeline.AdaptiveConfig())
