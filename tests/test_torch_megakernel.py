"""The port's megakernel route (DESIGN.md §10) against the reference's
`repro.kernels.megakernel` and against its own composed walk, on the CPU.

Mirrors `tests/test_megakernel.py`: the fused span must be invisible
semantically — bit-identical rows to the composed per-stage walk on the
paper's flows and on the seeded corpus, with and without adversarial cost
hints — and its contract's edges are pinned: route planning equal to the
reference's at equal budgets (the four flows at test and chip sizes and
every fallback rule), the kill switch, cache-key separation and the
observation lists.  The port's mega result is also held against the
reference's mega result on identical numpy-seeded inputs (integers exact,
floats within `RecordBatch.equivalent`'s atol: the port sums floats in
another order).  The last tests hold the plain versions of the span's two
kernels against `MaskedBatch.compact` and `masked._segments_contiguous` on
every slot.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_sca import (JAX, PAPER_FLOWS, TORCH, assert_same_rows, bind,
                            columns_of, corpus_flow)

from repro.core import masked as JM
from repro.core import pipeline as JP
from repro.core.cost import seed_source_stats as jseed
from repro.core.optimizer import optimize as joptimize
from repro.kernels import megakernel as JMK
from repro_torch import interop
from repro_torch.core import executor as TE
from repro_torch.core import masked as M
from repro_torch.core import pipeline as TP
from repro_torch.core.cost import seed_source_stats
from repro_torch.core.operators import Source
from repro_torch.core.optimizer import optimize as toptimize
from repro_torch.kernels import megakernel as MK
from repro_torch.kernels import ops, ref

REF_BUDGET = 128 * 1024**2  # the reference's default: the TPU's VMEM
BUDGETS = (REF_BUDGET, MK.SPAN_BUDGET_BYTES)
# source capacities of chip_smoke.py's sizes (q15 6M lineitem rows, q7 1M,
# clickstream 16M), from the flows' data generators, bucketed as `_bind`
# buckets them
_bc = M.bucket_capacity
CHIP_CAPS = {
    "q15": {"lineitem": _bc(6_000_000), "supplier": _bc(10_000)},
    "q7": {"lineitem": _bc(1_000_000), "supplier": _bc(1_666),
           "orders": _bc(250_000), "customer": _bc(25_000)},
    "clickstream": {"clicks": _bc(16_000_000), "logins": _bc(250_000),
                    "users": _bc(22_857)},
    "textmining": {"docs": _bc(1_000_000)},
}
CHIP_ROUTES = {"q15": (("mega", 0, 4),), "q7": (("mega", 0, 7),),
               "clickstream": (("mega", 0, 4),), "textmining": None}


@pytest.fixture(autouse=True)
def _default_route(monkeypatch):
    monkeypatch.delenv(TP.MEGAKERNEL_ENV, raising=False)


def _mega(routes) -> list:
    return [e for e in (routes or ()) if e[0] == "mega"]


def _rows(result) -> list:
    """Valid rows as sorted tuples, fields by name, values bit-exact."""
    cols = interop.columns(result)
    fields = sorted(cols)
    rows = list(zip(*[np.asarray(cols[f]).tolist() for f in fields]))
    return sorted(rows, key=lambda t: tuple(repr(x) for x in t))


def _compile(root, mega, **kw):
    return TP.compile_plan(root, use_megakernel=mega, device="cpu",
                           cache=TP.ExecutableCache(), **kw)


def _stages(pkg, name, best: bool):
    root = pkg.flows.FLOWS[name]()[0]
    P = TP if pkg is TORCH else JP
    opt = toptimize if pkg is TORCH else joptimize
    return P.lower_phys(opt(root).best.plan) if best else P.lower(root)


# ---------------------------------------------------------------------------
# Route planning against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("best", [False, True])
@pytest.mark.parametrize("name", PAPER_FLOWS)
def test_routes_match_reference_at_test_sizes(name, best):
    _, make = JAX.flows.FLOWS[name]()
    caps = {s: _bc(b.capacity) for s, b in make(2048, seed=1).items()}
    got = MK.plan_routes(_stages(TORCH, name, best), caps,
                         vmem_bytes=REF_BUDGET)
    want = JMK.plan_routes(_stages(JAX, name, best), caps,
                           vmem_bytes=REF_BUDGET)
    assert got == want
    assert bool(_mega(got)) == (name != "textmining")


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("name", PAPER_FLOWS)
def test_routes_match_reference_at_chip_sizes(name, budget):
    caps = CHIP_CAPS[name]
    got = MK.plan_routes(_stages(TORCH, name, True), caps, vmem_bytes=budget)
    want = JMK.plan_routes(_stages(JAX, name, True), caps, vmem_bytes=budget)
    assert got == want
    # the TPU's VMEM budget fuses nothing at these sizes; the card's does
    assert got == (None if budget == REF_BUDGET else CHIP_ROUTES[name])
    if budget != REF_BUDGET:
        assert MK.plan_routes(_stages(TORCH, name, True), caps) == got


def test_default_budget_is_a_quarter_of_the_cards_memory():
    from repro_torch import hw

    assert MK.SPAN_BUDGET_BYTES == 20 * 10**9 \
        == hw.H100_SXM.hbm_capacity // 4
    assert hw.CHIP is hw.TPU_V5E  # the optimizer's plans stay the reference's


# -- the reference's fallback cases, built in both packages -----------------
def _keep_all(ir, out):
    out.emit(ir.copy(), where=ir.get("v") >= -10**9)


def _agg(g, out):
    out.emit(g.keys().set("s", g.sum("v")))


def _cg(gl, gr, out):
    out.emit(gl.keys().set("s", gl.sum("v") + gr.sum("w")))


def _src(pkg, name, rows=64, **fields):
    return pkg.F.source(name, pkg.Schema.of(**fields), num_records=rows)


def _keep_then_reduce(pkg):
    src = _src(pkg, "S", k=np.int64, v=np.int64)
    return pkg.F.reduce_(pkg.F.map_(src, _keep_all, name="Keep"), ["k"], _agg,
                         hints=pkg.Hints(distinct_keys=4))


def _fallback_flow(pkg, case):
    F = pkg.F
    if case == "single_stage":
        return F.map_(_src(pkg, "S", k=np.int64, v=np.int64), _keep_all,
                      name="Keep")
    if case == "cross":
        left = F.map_(_src(pkg, "L", k=np.int64, v=np.int64), _keep_all,
                      name="Keep")
        return F.cross(left, _src(pkg, "R", rows=1, a=np.int64, b=np.int64))
    lsrc = _src(pkg, "L", k=np.int64, v=np.int64)
    left = F.map_(lsrc, _keep_all, name="Keep")
    rsrc = _src(pkg, "R", k2=np.int64, w=np.int64)
    if case == "non_pk_match":
        return F.match(left, rsrc, ["k"], ["k2"])
    if case == "anti_match":
        return F.match(left, rsrc, ["k"], ["k2"], anti=True,
                       hints=pkg.Hints(pk_side="right"))
    if case == "cogroup":
        return F.cogroup(left, rsrc, ["k"], ["k2"], _cg)
    return _keep_then_reduce(pkg)


@pytest.mark.parametrize("case,caps,budget,fuses", [
    ("single_stage", {"S": 256}, REF_BUDGET, False),
    ("cross", {"L": 256, "R": 8}, REF_BUDGET, False),
    ("non_pk_match", {"L": 256, "R": 64}, REF_BUDGET, False),
    ("anti_match", {"L": 256, "R": 64}, REF_BUDGET, False),
    ("cogroup", {"L": 256, "R": 64}, REF_BUDGET, False),
    ("blockable", {"S": 64}, REF_BUDGET, True),
    ("not_8_blockable", {"S": 12}, REF_BUDGET, False),
    ("below_the_floor", {"S": 4}, REF_BUDGET, False),
    ("within_budget", {"S": 1024}, REF_BUDGET, True),
    ("over_budget", {"S": 1024}, 64, False),
])
def test_fallback_routes_match_reference(case, caps, budget, fuses):
    ts = TP.lower(_fallback_flow(TORCH, case))
    js = JP.lower(_fallback_flow(JAX, case))
    got = MK.plan_routes(ts, caps, vmem_bytes=budget)
    assert got == JMK.plan_routes(js, caps, vmem_bytes=budget)
    assert bool(_mega(got)) == fuses
    for st in ts:
        if st.kind in ("cross", "cogroup") or (st.kind == "match" and (
                st.top.anti or st.top.hints.pk_side is None)):
            assert not MK._stage_fusable(st)


def test_shared_subtree_stays_solo():
    """An interior output consumed by TWO stages cannot be fused through
    (pinned on a hand-extended stage list, as the reference's test does)."""
    ts = TP.lower(_keep_then_reduce(TORCH))
    js = JP.lower(_keep_then_reduce(JAX))
    assert _mega(MK.plan_routes(ts, {"S": 256}))
    t_extra = dataclasses.replace(ts[-1], inputs=(("stage", 0),))
    j_extra = dataclasses.replace(js[-1], inputs=(("stage", 0),))
    got = MK.plan_routes(ts + (t_extra,), {"S": 256})
    assert got == JMK.plan_routes(js + (j_extra,), {"S": 256},
                                  vmem_bytes=MK.SPAN_BUDGET_BYTES)
    for e in _mega(got):
        assert not (e[1] <= 0 < e[2] - 1)


def test_span_has_aux_marks_non_chain_stages():
    stages = _stages(TORCH, "q15", True)
    assert MK.span_has_aux(stages) == JMK.span_has_aux(
        _stages(JAX, "q15", True))
    assert MK.span_has_aux(stages) == tuple(st.kind != "chain"
                                            for st in stages)


# ---------------------------------------------------------------------------
# Bit-identity: mega vs composed
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", PAPER_FLOWS)
def test_paper_flows_mega_equals_composed(name):
    root, make = TORCH.flows.FLOWS[name]()
    b = make(2048, seed=11)
    on = toptimize(root).best.compile(use_kernels=True, device="cpu",
                                      cache=TP.ExecutableCache())
    off = toptimize(root).best.compile(use_kernels=True, device="cpu",
                                       use_megakernel=False,
                                       cache=TP.ExecutableCache())
    assert on.use_megakernel and not off.use_megakernel
    got = on.run(b)
    assert _rows(got) == _rows(off.run(b))
    assert _rows(on.run_device(on.bind_device(b))) == _rows(got)
    assert got.equivalent(TE.execute(root, b))
    assert bool(_mega(on._last_routes)) == (name != "textmining")
    assert off._last_routes is None


def _adversarial(root, seed: int, factor: float = 100.0):
    """The port's copy of `flowgen.adversarial_hints`: every cost hint
    scaled by up to `factor` in a seeded direction, `pk_side` kept."""
    rng = np.random.default_rng(seed)

    def jitter():
        return float(factor ** rng.uniform(-1.0, 1.0))

    def perturb(h):
        new = {"cpu_flops_per_record": h.cpu_flops_per_record * jitter()}
        if h.selectivity is not None:
            new["selectivity"] = h.selectivity * jitter()
        if h.distinct_keys is not None:
            new["distinct_keys"] = max(1, round(h.distinct_keys * jitter()))
        if h.join_fanout is not None:
            new["join_fanout"] = h.join_fanout * jitter()
        if h.group_selectivity is not None:
            new["group_selectivity"] = h.group_selectivity * jitter()
        return dataclasses.replace(h, **new)

    def rebuild(n):
        kids = [rebuild(c) for c in n.children]
        if isinstance(n, Source):
            return n
        out = n.with_children(*kids)
        return dataclasses.replace(out, hints=perturb(out.hints))

    return rebuild(root)


@pytest.mark.parametrize("seed", range(8))
def test_corpus_mega_equals_composed_and_eager(seed):
    """The seeded corpus (the port's counterpart of `tests/flowgen.py`):
    mega on and off, plain and adversarial hints, bit-identical to the
    eager executor."""
    root, data = corpus_flow(TORCH, seed)
    d = data(seed + 1)
    for variant in (root, _adversarial(root, seed)):
        want = _rows(TE.execute(variant, bind(TORCH, d)))
        for mega in (True, False):
            cp = _compile(variant, mega)
            assert _rows(cp.run(bind(TORCH, d))) == want, (
                f"seed={seed} mega={mega}\n" + variant.pretty())


# ---------------------------------------------------------------------------
# The port's mega route against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", PAPER_FLOWS)
def test_mega_matches_reference_mega(name):
    troot, _ = TORCH.flows.FLOWS[name]()
    jroot, make = JAX.flows.FLOWS[name]()
    jb = make(3000, seed=4)
    d = {s: b.columns for s, b in jb.items()}
    cp = toptimize(troot).best.compile(use_kernels=True, device="cpu",
                                       cache=TP.ExecutableCache())
    jcp = JP.compile_plan(joptimize(jroot).best.plan, use_kernels=False,
                          use_megakernel=True, cache=JP.ExecutableCache())
    got = cp.run(interop.bindings(d))
    want = jcp.run(jb)
    assert cp._last_routes == jcp._last_routes
    assert_same_rows(interop.columns(got), columns_of(want))


def _observed(cp, masked, routes):
    caps = {n: b.capacity for n, b in masked.items()}
    stats = seed_source_stats(cp.flow, caps, {})
    obs, applied = [], []
    out = TP.run_stages(cp.stages, masked, cp.use_kernels, cp.compact_slack,
                        stats, observe=obs, caps=applied, routes=routes)
    return out, [(int(c), int(a)) for c, a in obs], applied


@pytest.mark.parametrize("name", ["q15", "q7", "clickstream"])
def test_observe_and_caps_agree_between_routes_and_with_reference(name):
    troot, _ = TORCH.flows.FLOWS[name]()
    jroot, make = JAX.flows.FLOWS[name]()
    jb = make(2048, seed=9)
    d = {s: b.columns for s, b in jb.items()}
    cp = TP.compile_plan(troot, device="cpu", cache=TP.ExecutableCache())
    masked = cp.bind_device(interop.bindings(d))
    routes = cp._routes({n: b.capacity for n, b in masked.items()})
    assert _mega(routes)
    out_m, obs_m, caps_m = _observed(cp, masked, routes)
    out_c, obs_c, caps_c = _observed(cp, masked, None)
    assert caps_m == caps_c
    assert obs_m == obs_c and len(obs_m) == len(cp.stages)
    assert _rows(out_m) == _rows(out_c)
    # the reference's walk observes the same counts at the same capacities
    jcp = JP.compile_plan(jroot, cache=JP.ExecutableCache())
    jm = jcp.bind_device(jb)
    jstats = jseed(jroot, {n: b.capacity for n, b in jm.items()}, {})
    jobs, jcaps = [], []
    JP.run_stages(jcp.stages, jm, False, jcp.compact_slack, jstats,
                  observe=jobs, caps=jcaps,
                  routes=jcp._routes({n: b.capacity for n, b in jm.items()}))
    assert caps_m == jcaps
    assert obs_m == [(int(c), int(a)) for c, a in jobs]


def test_interior_compaction_capacity_is_route_agnostic():
    root, make = TORCH.flows.FLOWS["clickstream"]()
    cp = TP.compile_plan(root, device="cpu", cache=TP.ExecutableCache())
    masked = cp.bind_device(make(1024, seed=5))
    caps = {n: b.capacity for n, b in masked.items()}
    stats = seed_source_stats(root, caps, {})
    planned = [M.planned_capacity(st.top, stats, cp.compact_slack)
               for st in cp.stages]
    routes = cp._routes(caps)
    assert _mega(routes)
    got: list = []
    TP.run_stages(cp.stages, masked, cp.use_kernels, cp.compact_slack, stats,
                  caps=got, routes=routes)
    assert [min(c, p) for c, p in zip(got, planned)] == got


# ---------------------------------------------------------------------------
# A live set wider than 8 columns (the span kernels' earlier launch width)
# ---------------------------------------------------------------------------
WIDE = 12


def _wide_filter(ir, out):
    out.emit(ir.copy(), where=ir.get("c1") % 5 == 0)


def wide_flow(pkg):
    """Filter, then PK match, over a 12-column table: the match re-emits
    its whole left input, so all 12 columns are live at the span's interior
    boundary."""
    fields = {"k": np.int64}
    fields.update({f"c{j}": np.int64 if j % 2 else np.float64
                   for j in range(1, WIDE)})
    left = pkg.F.map_(_src(pkg, "L", rows=4096, **fields), _wide_filter,
                      name="Keep", hints=pkg.Hints(selectivity=0.2))
    right = _src(pkg, "R", k2=np.int64, w=np.int64)
    return pkg.F.match(left, right, ["k"], ["k2"],
                       hints=pkg.Hints(pk_side="right"))


def wide_data(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    n = 4096
    left = {"k": rng.integers(0, 80, n)}
    for j in range(1, WIDE):
        left[f"c{j}"] = (rng.integers(-10**9, 10**9, n) if j % 2
                         else rng.normal(size=n))
    return {"L": left, "R": {"k2": rng.permutation(64),
                             "w": rng.integers(0, 1000, 64)}}


def test_wide_live_set_fuses_and_packs_every_column(monkeypatch):
    widths = []
    real = ops.span_compact

    def spy(columns, valid, capacity):
        columns = list(columns)
        widths.append(len(columns))
        return real(columns, valid, capacity)

    monkeypatch.setattr(ops, "span_compact", spy)
    root, d = wide_flow(TORCH), wide_data(12)
    cp = TP.compile_plan(root, device="cpu", cache=TP.ExecutableCache())
    got = cp.run(bind(TORCH, d))
    assert cp._last_routes == (("mega", 0, 2),)
    assert widths == [WIDE]  # one boundary, every column live
    assert _rows(got) == _rows(_compile(root, False).run(bind(TORCH, d)))
    assert got.equivalent(TE.execute(root, bind(TORCH, d)))
    # the reference fuses it the same way and gives the same rows
    jcp = JP.compile_plan(wide_flow(JAX), use_kernels=False,
                          use_megakernel=True, cache=JP.ExecutableCache())
    want = jcp.run(bind(JAX, d))
    assert jcp._last_routes == cp._last_routes
    assert_same_rows(interop.columns(got), columns_of(want))


@pytest.mark.parametrize("name", ["q15", "q7", "clickstream"])
def test_unobserved_span_takes_no_observation(monkeypatch, name):
    """Without an observer a span passes no `obs` to its stages and takes
    no count of its own, as the composed walk does not: on the card each
    such count would be a launch."""
    seen = []
    real = TP.execute_stage

    def spy(st, ins, use_kernels, use_order, obs=None, contiguous_in=False):
        seen.append(obs)
        return real(st, ins, use_kernels, use_order, obs,
                    contiguous_in=contiguous_in)

    monkeypatch.setattr(TP, "execute_stage", spy)
    root, make = TORCH.flows.FLOWS[name]()
    cp = TP.compile_plan(root, device="cpu", cache=TP.ExecutableCache())
    masked = cp.bind_device(make(1024, seed=2))
    caps = {n: b.capacity for n, b in masked.items()}
    routes = cp._routes(caps)
    assert _mega(routes)
    cp.run_device(masked)
    assert len(seen) == len(cp.stages) and all(o is None for o in seen)
    _, i, j = _mega(routes)[0]
    span = cp.stages[i:j]
    stats = seed_source_stats(cp.flow, caps, {})
    planned = [M.planned_capacity(st.top, stats, cp.compact_slack)
               for st in span]
    ins = [[None if k > 0 and r == ("stage", i + k - 1) else masked[r[1]]
            for r in st.inputs] for k, st in enumerate(span)]
    _, obs, _ = MK.run_span(span, ins, planned, True, True, observe=False)
    assert obs == []
    _, obs, _ = MK.run_span(span, ins, planned, True, True)
    assert len(obs) == len(span)


# ---------------------------------------------------------------------------
# Kill switch and cache keys
# ---------------------------------------------------------------------------
def test_env_kill_switch(monkeypatch):
    monkeypatch.setenv(TP.MEGAKERNEL_ENV, "0")
    root, make = TORCH.flows.q15()
    cp = TP.compile_plan(root, device="cpu", cache=TP.ExecutableCache())
    assert not cp.use_megakernel
    assert not toptimize(root).compile(device="cpu").use_megakernel
    cp.run(make(1024, seed=0))
    assert cp._last_routes is None
    # an explicit request still fuses
    on = _compile(root, True)
    on.run(make(1024, seed=0))
    assert _mega(on._last_routes)


def test_fused_and_composed_never_share_an_executable():
    root, make = TORCH.flows.q15()
    cache = TP.ExecutableCache()
    b = make(1024, seed=3)
    on = TP.compile_plan(root, device="cpu", cache=cache,
                         use_megakernel=True)
    off = TP.compile_plan(root, device="cpu", cache=cache,
                          use_megakernel=False)
    on.run(b)
    off.run(b)
    s = cache.stats()
    assert s.misses == 2 and s.traces == 2
    on.run(b)
    off.run(b)
    assert cache.stats().traces == 2 and cache.stats().hits == 2
    keys = list(cache._data)
    # the routes close each key; no dispatch mode splits them, since each
    # kernel wrapper dispatches on its tensors' device when it runs
    assert {k[-1] for k in keys} == {on._last_routes, None}


# ---------------------------------------------------------------------------
# The span kernels' plain versions on every slot
# ---------------------------------------------------------------------------
def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def _mask(rng, n, kind):
    if kind == "none":
        return np.zeros(n, bool)
    if kind == "all":
        return np.ones(n, bool)
    if kind == "packed":
        v = np.zeros(n, bool)
        v[:rng.integers(0, n + 1)] = True
        return v
    return rng.random(n) < {"sparse": 0.05, "dense": 0.9}[kind]


@pytest.mark.parametrize("k", [0, 1, 3, 6])
@pytest.mark.parametrize("seed", range(3))
def test_span_compact_plain_equals_compact_on_every_slot(seed, k):
    rng = np.random.default_rng(seed * 10 + k)
    for n in (1, 7, 257, 5000):
        for kind in ("none", "all", "packed", "sparse", "dense"):
            valid = torch.from_numpy(_mask(rng, n, kind))
            count = int(valid.sum())
            cols = {}
            for j in range(k):
                if j % 3 == 0:
                    cols[f"c{j}"] = torch.from_numpy(
                        rng.integers(-10**12, 10**12, n))
                elif j % 3 == 1:
                    cols[f"c{j}"] = torch.from_numpy(rng.normal(size=n))
                else:
                    cols[f"c{j}"] = torch.from_numpy(rng.random((n, 2)) < .5)
            # below, at and above the count, and past the input size
            for cap in sorted({1, max(count // 2, 1), max(count, 1),
                               count + 3, n, n + 9}):
                want = M.MaskedBatch(cols, valid).compact(cap)
                got_cols, got_valid, got_count = ref.span_compact(
                    list(cols.values()), valid, cap)
                assert int(got_count) == count
                assert torch.equal(got_valid, want.valid)
                for f, g in zip(cols, got_cols):
                    assert torch.equal(_bits(g), _bits(want.columns[f])), \
                        (n, kind, cap, f)
                # the wrapper takes the plain version for CPU tensors
                w_cols, w_valid, w_count = ops.span_compact(
                    list(cols.values()), valid, cap)
                assert torch.equal(w_valid, got_valid)
                assert int(w_count) == count
                assert all(torch.equal(_bits(a), _bits(b))
                           for a, b in zip(w_cols, got_cols))


@pytest.mark.parametrize("seed", range(4))
def test_span_segment_plain_equals_segments_contiguous(seed):
    rng = np.random.default_rng(100 + seed)
    for n in (1, 2, 33, 4097):
        for kind in ("none", "all", "packed", "sparse", "dense"):
            valid = torch.from_numpy(_mask(rng, n, kind))
            a = np.sort(rng.integers(0, max(n // 8, 2), n))
            # float keys with signed zeros and NaNs: IEEE compares
            b = rng.choice([0.0, -0.0, 1.5, np.nan], size=n)
            c = rng.integers(0, 2, n)
            for keys in (["a"], ["a", "b"], ["b", "c"], ["a", "b", "c"]):
                cols = {"a": torch.from_numpy(a), "b": torch.from_numpy(b),
                        "c": torch.from_numpy(c)}
                want_seg, want_start = M._segments_contiguous(cols, keys,
                                                              valid)
                seg, start, count = ref.span_segment(
                    [cols[f] for f in keys], valid)
                assert torch.equal(seg, want_seg) and torch.equal(
                    start, want_start), (n, kind, keys)
                assert int(count) == int(want_start.sum())
                w = ops.span_segment([cols[f] for f in keys], valid)
                assert torch.equal(w[0], seg) and torch.equal(w[1], start)


@pytest.mark.parametrize("mask", ["none", "all", "packed", "sparse",
                                  "dense"])
@pytest.mark.parametrize("keys", [("a",), ("b",), ("a", "b"),
                                  ("a", "b", "c")])
def test_span_segment_matches_reference_segments_contiguous(keys, mask):
    """The port's segmentation (plain version and wrapper on CPU tensors)
    against the JAX package's `_segments_contiguous` on the same seeded
    keys and masks: int64 and float64 keys (signed zeros and NaNs compare
    as IEEE values in both), `seg` by value (the reference's is int32),
    `is_start` exactly, and the group count."""
    import jax.numpy as jnp

    rng = np.random.default_rng(200 + len(keys))
    for n in (1, 2, 33, 4097):
        valid = _mask(rng, n, mask)
        cols = {"a": np.sort(rng.integers(0, max(n // 8, 2), n)),
                "b": rng.choice([0.0, -0.0, 1.5, np.nan], size=n),
                "c": rng.integers(-3, 3, n)}
        want_seg, want_start = JM._segments_contiguous(
            {f: jnp.asarray(cols[f]) for f in keys}, keys, jnp.asarray(valid))
        want_seg, want_start = np.asarray(want_seg), np.asarray(want_start)
        tkeys = [torch.from_numpy(cols[f]) for f in keys]
        tvalid = torch.from_numpy(valid)
        for seg, start, count in (ref.span_segment(tkeys, tvalid),
                                  ops.span_segment(tkeys, tvalid)):
            assert np.array_equal(seg.numpy(), want_seg), (n, keys, mask)
            assert np.array_equal(start.numpy(), want_start), (n, keys, mask)
            assert int(count) == int(want_start.sum())


def test_contiguous_segmentation_equals_gappy_on_a_packed_batch():
    """`_exec_reduce(contiguous=True)` (span_segment) and the gap-tolerant
    walk agree on a packed, key-ordered batch — the fused span's premise."""
    rng = np.random.default_rng(3)
    root, _ = TORCH.flows.FLOWS["q15"]()
    red = next(n for n in root.iter_nodes() if type(n).__name__ == "ReduceOp")
    key = red.key[0]
    n = 4096
    cols = {f: torch.from_numpy(rng.integers(0, 50, n)) if f == key
            else torch.from_numpy(rng.random(n))
            for f in red.child.out_schema.fields}
    cols[key] = torch.sort(cols[key]).values
    valid = torch.arange(n) < 3000
    b = M.MaskedBatch(cols, valid, (key,))
    obs_a, obs_b = {}, {}
    packed = M._exec_reduce(red, b, True, True, obs_a, contiguous=True)
    gappy = M._exec_reduce(red, b, True, True, obs_b)
    assert int(obs_a["groups"]) == int(obs_b["groups"]) > 0
    assert torch.equal(packed.valid, gappy.valid)
    for f in packed.columns:
        assert torch.equal(_bits(packed.columns[f]), _bits(gappy.columns[f]))
