"""The port on the card: each CUDA kernel against its plain torch version,
the data-flow main path with the kernels against the eager executor, the
sharded executor on 8 shards against the port on the CPU, the served
models' kernel paths against their plain paths, and the train step placed
on the card's one-rank NCCL mesh against the plain step.

Marked `cuda`; every test skips without a CUDA device (the kernels have no
CPU mode).  Imports no JAX, so it runs on a machine that has only the port:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs import flows, get_config
from repro_torch.core import executor
from repro_torch.core.optimizer import optimize
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import make_model
from repro_torch.serve.engine import Engine, Request

OPS = ("add", "max", "min")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int64, torch.float64])
def test_cuda_sorted_probe_matches_plain(cuda, dtype):
    g = torch.Generator().manual_seed(0)
    for n, m in [(0, 7), (1, 1), (10_000, 100_003), (1_000_000, 65_536)]:
        keys = torch.sort(torch.randint(-10**6, 10**6, (n,), generator=g)
                          .to(dtype)).values.to(cuda)
        q = torch.randint(-10**6, 10**6, (m,), generator=g).to(dtype).to(cuda)
        got = tops.sorted_probe(keys, q)
        assert torch.equal(got, tref.sorted_probe(keys, q))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int64, torch.float64])
@pytest.mark.parametrize("with_first", [False, True])
def test_cuda_probe_positions_matches_plain(cuda, dtype, with_first):
    # one launch gives the join probe's clamped int64 positions; M is not a
    # multiple of the kernel's 256-query block
    g = torch.Generator().manual_seed(2)
    for n, m in [(1, 1), (16_384, 32_768), (10_000, 100_003),
                 (1_000_000, 65_537), (40_000, 1_000)]:
        keys = torch.sort(torch.randint(-10**6, 10**6, (n,), generator=g)
                          .to(dtype)).values.to(cuda)
        q = torch.randint(-2 * 10**6, 2 * 10**6, (m,), generator=g)
        q = q.to(dtype).to(cuda)
        first = torch.tensor(n // 3, device=cuda) if with_first else None
        for hi in (n - 1, n // 2):
            tops.reset_launches()
            got = tops.probe_positions(keys, q, first, hi)
            assert tops.LAUNCHES["sorted_probe"] == 1
            assert got.dtype == torch.int64
            assert torch.equal(got, tref.probe_positions(keys, q, first, hi))


@pytest.mark.cuda
def test_cuda_probe_positions_refuses_what_the_kernel_does_not_take(cuda):
    keys = torch.arange(8, device=cuda)
    with pytest.raises(TypeError):
        tops.probe_positions(keys, keys, torch.tensor(1, dtype=torch.int32,
                                                      device=cuda))
    with pytest.raises(TypeError):
        tops.probe_positions(keys, keys.double())
    with pytest.raises(ValueError):
        tops.probe_positions(keys[None], keys)
    with pytest.raises(ValueError):  # first_valid on another device
        tops.probe_positions(keys, keys, torch.tensor(1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int64, torch.float64])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_cuda_segmented_scan_matches_plain(cuda, dtype, c):
    g = torch.Generator().manual_seed(1)
    for n, op in [(1, "add"), (2049, "max"), (300_007, "min"),
                  (300_007, "add")]:
        v = torch.randint(-1000, 1000, (n, c), generator=g).to(dtype).to(cuda)
        f = (torch.rand(n, generator=g) < 0.01).to(cuda)
        # small integers: float sums are exact in any order
        assert torch.equal(tops.segmented_scan(v, f, op),
                           tref.segmented_scan(v, f, op))
        sid = torch.cumsum(f.to(torch.int64), 0)
        valid = (torch.rand(n, generator=g) < 0.9).to(cuda)
        nseg = int(sid[-1]) + 3
        assert torch.equal(tops.segment_reduce(v, sid, nseg, op, valid),
                           tref.segment_reduce(v, sid, nseg, op, valid))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int64, torch.float64])
@pytest.mark.parametrize("op", OPS)
def test_cuda_segment_reduce_edges(cuda, dtype, op):
    """One launch segments the rows by id, masks the invalid ones and
    fills every empty id: ids missing before, between and after the rows,
    num_segments far past the last id, every row invalid, one segment over
    every tile; n = 1 and a tile (2,048 rows) either side."""
    g = torch.Generator().manual_seed(3)
    for n in (1, 2047, 2048, 2049, 100_003):
        x = torch.randint(-100, 100, (n,), generator=g).to(dtype).to(cuda)
        ids = torch.cumsum(torch.randint(0, 3, (n,), generator=g), 0)
        cases = [(ids + 3, 0.8, 10), (ids, 0.8, 50_000), (ids, 0.0, 4),
                 (torch.zeros(n, dtype=torch.int64), 0.9, 3)]
        for sid, p_valid, extra in cases:
            sid = sid.to(cuda)
            valid = (torch.rand(n, generator=g) < p_valid).to(cuda)
            nseg = int(sid[-1]) + extra
            for mask in (valid, None):
                tops.reset_launches()
                got = tops.segment_reduce(x, sid, nseg, op, mask)
                assert tops.LAUNCHES["segmented_scan"] == 1
                # small integers: float sums are exact in any order
                want = tref.segment_reduce(x, sid, nseg, op, mask)
                assert torch.equal(_bits(got), _bits(want)), (n, extra)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["segmented_scan", "segment_reduce"])
@pytest.mark.parametrize("seg_rows", [7_001, None])
def test_cuda_float_add_is_deterministic(cuda, entry, seg_rows):
    """float64 sums over segments of 7,001 rows (three tiles or more, with
    tiles that hold no reset) and over one segment of every row: bit for
    bit equal over two calls, within 1e-9 relative of the plain version."""
    g = torch.Generator().manual_seed(6)
    n = 1_000_003
    x = torch.rand(n, generator=g, dtype=torch.float64).to(cuda)
    start = torch.zeros(n, dtype=torch.bool)
    start[torch.arange(0, n, seg_rows or n)] = True
    sid = (torch.cumsum(start.to(torch.int64), 0) - 1).to(cuda)
    start = start.to(cuda)
    if entry == "segmented_scan":
        a, b = tops.segmented_scan(x, start), tops.segmented_scan(x, start)
        want = tref.segmented_scan(x, start)
    else:
        nseg = int(sid[-1]) + 1
        a, b = (tops.segment_reduce(x, sid, nseg),
                tops.segment_reduce(x, sid, nseg))
        want = tref.segment_reduce(x, sid, nseg)
    assert torch.equal(_bits(a), _bits(b))
    assert float(((a - want).abs() / want.abs().clamp(min=1)).max()) <= 1e-9


@pytest.mark.cuda
def test_cuda_data_kernels_make_one_device_kernel_a_call(cuda):
    """segment_reduce, segmented_scan, span_compact (32 columns) and
    span_segment (1 and 32 keys) each run as one device kernel a call, as
    the profiler counts them."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator().manual_seed(7)
    n = 100_000
    x = torch.rand(n, generator=g, dtype=torch.float64).to(cuda)
    valid = (torch.rand(n, generator=g) < 0.3).to(cuda)
    sid = torch.sort(torch.randint(0, 1000, (n,), generator=g)).values
    sid = sid.to(cuda)
    cols = [torch.randint(-10**9, 10**9, (n,), generator=g).to(cuda)
            for _ in range(32)]
    calls = {"segment_reduce": lambda: tops.segment_reduce(x, sid, n, "add",
                                                           valid),
             "segmented_scan": lambda: tops.segmented_scan(x, valid, "max"),
             "span_compact": lambda: tops.span_compact(cols, valid, n // 2),
             "span_segment": lambda: tops.span_segment([sid], valid),
             "span_segment 32 keys": lambda: tops.span_segment(
                 cols[:31] + [sid], valid)}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        counts = []
        for _ in range(3):  # the profiler now and then records nothing
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            counts.append(sum(e.device_type == torch.autograd.DeviceType.CUDA
                              for e in prof.events()))
        assert max(counts) == 1, (name, counts)


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    flags = torch.ones(8, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="at most 4 columns"):
        tops.segmented_scan(torch.zeros((8, 5), dtype=torch.int64,
                                        device=cuda), flags)
    with pytest.raises(TypeError):
        tops.segmented_scan(torch.zeros(8, dtype=torch.int32, device=cuda),
                            flags)
    with pytest.raises(TypeError):
        tops.sorted_probe(torch.arange(8, device=cuda),
                          torch.arange(8, device=cuda, dtype=torch.float64))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["q15", "clickstream", "q7"])
def test_cuda_main_path_matches_eager(cuda, name):
    root, make = flows.FLOWS[name]()
    b = make(50_000, seed=2)
    cp = optimize(root).best.compile(use_kernels=True, device=cuda)
    tops.reset_launches()
    out = cp.run(b)
    assert sum(tops.LAUNCHES.values()) > 0
    ref = executor.execute(root, b)
    assert out.equivalent(ref)
    assert cp.run_device(cp.bind_device(b)).to_record_batch().equivalent(ref)


def _mesh_step(name, n, k, dev, cache=None):
    """One 8-shard `DistributedPlan` step of `name` at `n` rows with the
    kernels, in `cache` (a fresh one by default): (global output batch,
    launches, eager rows)."""
    from repro_torch.core.distributed import DistributedPlan
    from repro_torch.core.physical import Ctx
    from repro_torch.core.pipeline import ExecutableCache

    root, make = flows.FLOWS[name]()
    b = make(n, seed=2)
    plan = optimize(root, Ctx(dop=8), include_commutes=False).best.plan
    dp = DistributedPlan(plan, mesh_shards=8, overlap_slices=k,
                         use_kernels=True,
                         cache=ExecutableCache() if cache is None else cache,
                         device=dev)
    staged = dp.bind(b)
    tops.reset_launches()
    out = dp.run_device(staged)
    launches = dict(tops.LAUNCHES)
    return out, launches, executor.execute(root, b)


def _host_bits(t: torch.Tensor) -> np.ndarray:
    t = t.cpu()
    if t.dtype == torch.float64:
        t = t.view(torch.int64)
    return t.numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 4])
def test_cuda_mesh_matches_cpu_port_slot_by_slot(cuda, k):
    """q15 on 8 shards on the card (spans, repartitions and the join probe
    through the kernels) equals the port on the CPU slot by slot:
    validity and integers exactly, float sums within 1e-9 relative (the
    scan kernel's summation order).  Both handles share one executable
    cache, and each runs on its own device."""
    from repro_torch.core.pipeline import ExecutableCache

    cache = ExecutableCache()
    got, launches, ref = _mesh_step("q15", 48_000, k, cuda, cache)
    want, _, _ = _mesh_step("q15", 48_000, k, "cpu", cache)
    assert got.device.type == "cuda" and want.device.type == "cpu"
    assert cache.stats().traces == 2
    for kname in ("sorted_probe", "segmented_scan", "span_compact",
                  "span_segment"):
        assert launches[kname] > 0, launches
    assert torch.equal(got.valid.cpu(), want.valid)
    v = want.valid
    for f, w in want.columns.items():
        g = got.columns[f].cpu()
        if w.dtype.is_floating_point:
            np.testing.assert_allclose(g[v].numpy(), w[v].numpy(),
                                       rtol=1e-9, err_msg=f)
        else:
            assert torch.equal(g[v], w[v]), f
    assert got.to_record_batch().equivalent(ref)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["q15", "clickstream"])
def test_cuda_mesh_wires_are_byte_identical(cuda, name):
    """The serial and the sliced wire give byte-identical global batches on
    the card (clickstream broadcasts, q15 repartitions), equal to eager."""
    one, _, ref = _mesh_step(name, 48_000, 1, cuda)
    four, _, _ = _mesh_step(name, 48_000, 4, cuda)
    assert torch.equal(one.valid, four.valid)
    for f in one.columns:
        assert np.array_equal(_host_bits(one.columns[f]),
                              _host_bits(four.columns[f]))
    assert four.to_record_batch().equivalent(ref)


@pytest.mark.cuda
def test_cuda_adaptive_swap_matches_eager(cuda):
    """q15_drift's 25x overestimate served adaptively on the card: one
    swap, still on the mega route, every batch equal to eager; and the
    truncating underestimate force-swaps, re-runs and equals eager."""
    from repro_torch.core.pipeline import AdaptiveConfig, ExecutableCache

    root, make = flows.q15_drift(hint_selectivity=1.0)
    batches = [make(60_000, seed=s, true_sel=0.04) for s in range(3)]
    refs = [executor.execute(root, b) for b in batches]
    staged = [None] * len(batches)
    cp = optimize(root, include_commutes=False).compile(
        use_kernels=True, device=cuda, cache=ExecutableCache(),
        adaptive=AdaptiveConfig(check_every=2, patience=2))
    tops.reset_launches()
    for i in range(10):
        k = i % len(batches)
        if staged[k] is None:
            staged[k] = cp.bind_device(batches[k])
        assert cp.run_device(staged[k]).to_record_batch().equivalent(refs[k])
    assert cp.swaps == 1
    assert any(e[0] == "mega" for e in cp._last_routes)
    assert tops.LAUNCHES["span_compact"] and tops.LAUNCHES["sorted_probe"]
    under, make = flows.q15_drift(hint_selectivity=0.001)
    b = make(60_000, seed=9, true_sel=0.04)
    cp = optimize(under, include_commutes=False).compile(
        use_kernels=True, device=cuda, cache=ExecutableCache(),
        adaptive=AdaptiveConfig())
    assert cp.run(b).equivalent(executor.execute(under, b))
    assert cp.swaps >= 1 and any(e[0] == "mega" for e in cp._last_routes)


@pytest.mark.cuda
def test_cuda_engine_async_swap_matches_eager(cuda):
    """The multi-tenant engine on the card with background swaps and a pump
    thread: the drifter swaps (its pre-trace on the engine's own stream),
    its co-tenant does not, and every result equals eager."""
    from repro_torch.serve.dataflow import DataflowEngine, ServeConfig

    q15, qmk = flows.q15()
    drift, dmk = flows.q15_drift(hint_selectivity=1.0)
    eng = DataflowEngine(ServeConfig(max_coalesce=8, probe_every=4,
                                     use_kernels=True, async_swap=True),
                         device=cuda)
    eng.register("q15", q15)
    eng.register("drift", drift)
    eng.start()
    try:
        reqs = []
        for i in range(48):
            d = dmk(4096, seed=100 + i, true_sel=0.04)
            q = qmk(4096, seed=500 + i)
            reqs += [(drift, d, eng.submit("drift", d)),
                     (q15, q, eng.submit("q15", q))]
        for root, b, r in reqs:
            assert r.result(timeout=120).equivalent(executor.execute(root, b))
        eng.join_swaps(timeout=120)
    finally:
        eng.stop()
    assert eng.tenant_stats("drift")["swaps"] >= 1
    assert eng.tenant_stats("q15")["swaps"] == 0
    assert eng.stats()["swap_errors"] == 0


def _rows(batch) -> list:
    """Valid rows as sorted tuples, fields by name, values bit-exact."""
    b = batch.to_numpy().compact()
    fields = sorted(b.fields)
    rows = zip(*[b.columns[f].tolist() for f in fields])
    return sorted(rows, key=lambda t: tuple(repr(x) for x in t))


def _bits(t):
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def _masks(g, n):
    packed = torch.zeros(n, dtype=torch.bool)
    packed[:n // 3] = True
    return {"none": torch.zeros(n, dtype=torch.bool),
            "all": torch.ones(n, dtype=torch.bool), "packed": packed,
            "sparse": torch.rand(n, generator=g) < 0.05,
            "dense": torch.rand(n, generator=g) < 0.9}


@pytest.mark.cuda
@pytest.mark.parametrize("k", [0, 1, 3, 6, 8, 9, 12, 17, 32, 33])
def test_cuda_span_compact_matches_plain(cuda, k):
    g = torch.Generator().manual_seed(k)
    for n in (1, 4095, 4097, 300_007):
        makers = [lambda: torch.randint(-10**12, 10**12, (n,), generator=g),
                  lambda: torch.randn(n, generator=g, dtype=torch.float64),
                  lambda: torch.rand((n, 3), generator=g) < 0.5,
                  lambda: torch.randint(-9, 9, (n,), generator=g,
                                        dtype=torch.int32)]
        cols = [makers[j % 4]().to(cuda) for j in range(k)]
        for kind, valid in _masks(g, n).items():
            valid = valid.to(cuda)
            count = int(valid.sum())
            for cap in sorted({1, max(count // 2, 1), max(count, 1),
                               count + 3, n + 9}):
                tops.reset_launches()
                got = tops.span_compact(cols, valid, cap)
                torch.cuda.synchronize()
                assert tops.LAUNCHES["span_compact"] == 1
                want = tref.span_compact(cols, valid, cap)
                assert int(got[2]) == int(want[2]) == count
                assert torch.equal(got[1], want[1]), (n, kind, cap)
                for a, b in zip(got[0], want[0]):
                    assert torch.equal(_bits(a), _bits(b)), (n, kind, cap)


@pytest.mark.cuda
def test_cuda_span_segment_matches_plain(cuda):
    g = torch.Generator().manual_seed(5)
    tile = 4096  # csrc/span_segment.cu kTile
    for n in (1, tile - 1, tile, tile + 1, 300_007):
        a = torch.sort(torch.randint(0, max(n // 16, 2), (n,),
                                     generator=g)).values
        pick = torch.randint(0, 4, (n,), generator=g)
        b = torch.tensor([0.0, -0.0, 1.5, float("nan")],
                         dtype=torch.float64)[pick]
        c = torch.randint(0, 2, (n,), generator=g, dtype=torch.int32)
        d = torch.rand(n, generator=g) < 0.5
        z = torch.zeros(n, dtype=torch.int64)
        cols = {f: t.to(cuda) for f, t in zip("abcdz", (a, b, c, d, z))}
        masks = _masks(g, n)
        # valid rows only after an all-invalid first tile
        masks["late"] = (torch.arange(n) >= tile + 5) & (
            torch.rand(n, generator=g) < 0.9)
        # up to 32 keys in one launch; past 32 the kernel folds them into a
        # flag a slot first: "z" keys make only the last key tell slots
        # apart, past the first group of 32
        for kind, valid in masks.items():
            valid = valid.to(cuda)
            for keys in ("a", "ab", "bc", "abcd", "abcdabcda",
                         "zzzzzzzzab", "zzzzzzzzzzzzzzzzzc", "abcd" * 8,
                         "z" * 31 + "a", "z" * 32 + "c"):
                ks = [cols[f] for f in keys]
                tops.reset_launches()
                got = tops.span_segment(ks, valid)
                want = tref.span_segment(ks, valid)
                torch.cuda.synchronize()
                assert tops.LAUNCHES["span_segment"] == 1
                assert torch.equal(got[0], want[0]), (n, kind, keys)
                assert torch.equal(got[1], want[1]), (n, kind, keys)
                assert int(got[2]) == int(want[2])


@pytest.mark.cuda
def test_cuda_span_segment_scratch_grows_and_shrinks(cuda):
    """Calls in a row on one stream with n growing (the cached scratch is
    replaced) and shrinking (stale status words of earlier epochs lie past
    the tiles in use): each bit for bit equal to the plain version."""
    g = torch.Generator().manual_seed(6)
    for n in (1000, 600_000, 5000, 600_001, 17, 600_000):
        a = torch.sort(torch.randint(0, max(n // 10, 2), (n,),
                                     generator=g)).values.to(cuda)
        valid = (torch.rand(n, generator=g) < 0.7).to(cuda)
        got = tops.span_segment([a], valid)
        want = tref.span_segment([a], valid)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert int(got[2]) == int(want[2]), n


@pytest.mark.cuda
def test_cuda_span_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    valid = torch.ones(8, dtype=torch.bool, device=cuda)
    col = torch.zeros(8, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError, match="bool mask"):
        tops.span_compact([col], valid.to(torch.uint8), 4)
    with pytest.raises(ValueError, match="rows"):
        tops.span_compact([col[:4]], valid, 4)
    with pytest.raises(TypeError):
        tops.span_segment([col.to(torch.float16)], valid)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["q15", "clickstream", "q7"])
def test_cuda_mega_route_matches_composed(cuda, name):
    root, make = flows.FLOWS[name]()
    b = make(50_000, seed=4)
    res = optimize(root)
    on = res.best.compile(use_kernels=True, device=cuda, use_megakernel=True)
    off = res.best.compile(use_kernels=True, device=cuda,
                           use_megakernel=False)
    tops.reset_launches()
    got = on.run(b)
    torch.cuda.synchronize()
    assert on._last_routes is not None
    for k in ("span_compact", "span_segment", "sorted_probe"):
        assert tops.LAUNCHES[k] > 0, (k, tops.LAUNCHES)
    assert _rows(got) == _rows(off.run(b))  # bit for bit
    assert got.equivalent(executor.execute(root, b))


def _wide_filter(ir, out):
    out.emit(ir.copy(), where=ir.get("c1") % 5 == 0)


@pytest.mark.cuda
def test_cuda_mega_route_packs_a_wide_live_set(cuda):
    """Filter, then PK match, over a 12-column table: all 12 columns are
    live at the span's boundary, and one span_compact launch moves them."""
    from repro_torch.core import flow as F
    from repro_torch.core.operators import Hints
    from repro_torch.core.record import RecordBatch, Schema

    n, width = 200_000, 12
    fields = {"k": np.int64}
    fields.update({f"c{j}": np.int64 if j % 2 else np.float64
                   for j in range(1, width)})
    left = F.map_(F.source("L", Schema.of(**fields), num_records=n),
                  _wide_filter, name="Keep", hints=Hints(selectivity=0.2))
    right = F.source("R", Schema.of(k2=np.int64, w=np.int64),
                     num_records=1000)
    root = F.match(left, right, ["k"], ["k2"], hints=Hints(pk_side="right"))
    g = torch.Generator().manual_seed(12)
    cols = {"k": torch.randint(0, 1200, (n,), generator=g)}
    for j in range(1, width):
        cols[f"c{j}"] = (torch.randint(-10**9, 10**9, (n,), generator=g)
                         if j % 2 else torch.randn(n, generator=g,
                                                   dtype=torch.float64))
    b = {"L": RecordBatch({f: v.numpy() for f, v in cols.items()}),
         "R": RecordBatch({"k2": torch.randperm(1000, generator=g).numpy(),
                           "w": torch.randint(0, 99, (1000,),
                                              generator=g).numpy()})}
    on = optimize(root).best.compile(use_kernels=True, device=cuda)
    off = optimize(root).best.compile(use_kernels=True, device=cuda,
                                      use_megakernel=False)
    tops.reset_launches()
    got = on.run(b)
    torch.cuda.synchronize()
    assert on._last_routes == (("mega", 0, 2),)
    assert tops.LAUNCHES["span_compact"] == 1
    assert _rows(got) == _rows(off.run(b))  # bit for bit
    assert got.equivalent(executor.execute(root, b))


# (B, Hq, Hkv, T, S, D), causal, window: the reference kernel test's seven
# shapes (tests/test_kernels.py), then ragged tiles, T > S and other heads
ATTN_SHAPES = [
    ((1, 4, 2, 128, 128, 64), True, None),
    ((2, 8, 8, 64, 64, 32), True, None),
    ((1, 4, 1, 128, 256, 64), True, None),
    ((1, 2, 2, 96, 96, 64), True, 32),
    ((1, 2, 2, 64, 64, 128), False, None),
    ((1, 4, 2, 1, 128, 64), True, None),
    ((1, 1, 1, 256, 256, 64), True, 128),
    ((2, 16, 8, 1031, 1031, 128), True, None),   # prime T: ragged tiles
    ((1, 4, 2, 77, 200, 32), False, 50),
    ((1, 2, 1, 150, 40, 64), True, None),        # T > S: masked rows
    ((1, 4, 2, 200, 200, 96), True, None),       # head dim 96 (phi-3)
    ((2, 4, 4, 333, 333, 96), True, 64),
]
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,causal,window", ATTN_SHAPES)
def test_cuda_flash_attention_matches_plain(cuda, dtype, shape, causal,
                                            window):
    b, hq, hkv, t, s, d = shape
    g = torch.Generator().manual_seed(t * 7 + s)
    q = torch.randn((b, hq, t, d), generator=g).to(cuda, dtype)
    k = torch.randn((b, hkv, s, d), generator=g).to(cuda, dtype)
    v = torch.randn((b, hkv, s, d), generator=g).to(cuda, dtype)
    tops.reset_launches()
    got = tops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["flash_attention"] == 1
    want = tref.attention(q, k, v, causal=causal, window=window)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# (B, Hq, Hkv, T, S, D), causal, window, [B,T,H,D] views: every head dim,
# GQA ratios 1, 2 and 8, T != S and T = 1, windows 1, 32 and >= S, T and S
# not multiples of 64 or 128
FLASH_EDGES = [
    ((2, 4, 4, 200, 200, 32), True, None, True),
    ((1, 8, 4, 333, 333, 64), True, 32, True),
    ((1, 16, 2, 129, 129, 128), True, None, True),   # ratio 8
    ((2, 8, 1, 1, 300, 128), True, None, False),     # one decode row
    ((1, 4, 2, 100, 260, 128), True, 1, True),       # window 1, T < S
    ((1, 4, 2, 257, 190, 64), True, None, False),    # T > S: masked rows
    ((1, 2, 2, 190, 190, 128), True, 190, True),     # window >= S
    ((3, 6, 3, 65, 127, 32), False, 40, True),
    ((1, 4, 4, 1000, 1000, 128), False, None, True),
    ((2, 32, 32, 300, 300, 96), True, None, True),   # phi-3-vision's heads
    # whisper-tiny: the encoder over 1,500 frames, the decoder prefill's
    # and a decode step's cross-attention, all non-causal
    ((4, 6, 6, 1500, 1500, 64), False, None, True),
    ((4, 6, 6, 300, 1500, 64), False, None, True),
    ((4, 6, 6, 1, 1500, 64), False, None, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,window,strided", FLASH_EDGES)
def test_cuda_flash_attention_edges(cuda, shape, causal, window, strided):
    b, hq, hkv, t, s, d = shape
    g = torch.Generator().manual_seed(t + 3 * s + d)

    def operand(h, n):
        if strided:  # the prefill's layout
            x = torch.randn((b, n, h, d), generator=g)
            return x.to(cuda, torch.bfloat16).transpose(1, 2)
        return torch.randn((b, h, n, d), generator=g).to(cuda, torch.bfloat16)

    q, k, v = operand(hq, t), operand(hkv, s), operand(hkv, s)
    tops.reset_launches()
    got = tops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["flash_attention"] == 1
    assert got.shape == q.shape
    want = tref.attention(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_what_it_does_not_take(cuda):
    q = torch.zeros((1, 2, 8, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        tops.flash_attention(q[..., :48].contiguous(), q[..., :48].contiguous(),
                             q[..., :48].contiguous())
    with pytest.raises(TypeError):
        tops.flash_attention(q, q.float(), q)
    # row-strided views are taken; a strided head dim or a misaligned row
    # is not
    wide = torch.zeros((1, 2, 8, 72), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous head dim"):
        tops.flash_attention(torch.zeros((1, 2, 64, 64), device=cuda,
                                         dtype=torch.bfloat16).transpose(2, 3),
                             q, q)
    with pytest.raises(ValueError, match="aligned"):
        tops.flash_attention(wide[..., 4:68], q, q)
    with pytest.raises(ValueError, match="GQA"):
        tops.flash_attention(q, q[:, :1].repeat(1, 3, 1, 1),
                             q[:, :1].repeat(1, 3, 1, 1))


@pytest.mark.cuda
def test_cuda_engine_flash_matches_plain_attention(cuda):
    # bf16 activations: the kernel and the plain version round differently,
    # so compare prefill logits within a bound, not greedy tokens
    cfg = get_config("qwen3-0.6b", reduced=True, dtype="bfloat16")
    gen = torch.Generator(device=cuda).manual_seed(0)
    flash = make_model(cfg.with_(attn_impl="flash"), cuda).init(gen)
    plain = make_model(cfg, cuda).load_params(flash.state_dict())
    rng = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (4, 100), generator=rng).to(cuda)
    tops.reset_launches()
    lf, _ = flash.prefill({"tokens": toks}, flash.init_decode_state(4, 128))
    assert tops.LAUNCHES["flash_attention"] == cfg.n_layers
    lp, _ = plain.prefill({"tokens": toks}, plain.init_decode_state(4, 128))
    torch.testing.assert_close(lf, lp, rtol=5e-2, atol=5e-2)
    reqs = [Request(prompt=toks[i, : 20 + 30 * i].cpu().numpy(),
                    max_new_tokens=5) for i in range(3)]
    Engine(flash, batch_slots=2, max_seq=128).generate(reqs)
    assert all(len(r.out_tokens) == 5 for r in reqs)


@pytest.mark.cuda
@pytest.mark.parametrize("tied", [False, True])
def test_cuda_moe_block_matches_cpu(cuda, tied):
    # the routing, the capacity drop and the float32 combine on the card
    # against the same block on the CPU; tied: every token picks experts 0
    # and 1, 600 pairs each against a capacity of 512, so both drop the
    # same 88 tokens' pairs
    from repro_torch.models import moe
    from repro_torch.models.config import ModelConfig

    cfg = ModelConfig(name="m", family="moe", n_layers=1, d_model=64,
                      n_heads=4, d_ff=128, vocab=256, n_experts=4, top_k=2,
                      n_shared_experts=1, d_expert_ff=32, dtype="float32")
    g = torch.Generator().manual_seed(11)
    p = moe.init_moe(g, cfg, "cpu")
    if tied:
        p["router"].zero_()
    x = torch.randn((2, 300, 64), generator=g)
    want, want_aux = moe.moe_block(p, cfg, x)
    got, got_aux = moe.moe_block(
        {k: ({kk: vv.to(cuda) for kk, vv in v.items()}
             if isinstance(v, dict) else v.to(cuda)) for k, v in p.items()},
        cfg, x.to(cuda))
    # float32 products on both (TF32 off for matmuls by default): the sums
    # differ in order only
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got_aux.cpu(), want_aux, rtol=1e-5,
                               atol=1e-7)


# (B, H, T, Dk, Dv): the reference kernel test's three shapes
# (tests/test_kernels.py), a ragged T with Dk != Dv, and rwkv6-3b's heads
RWKV_SHAPES = [(1, 2, 64, 16, 16), (2, 1, 128, 32, 64), (1, 1, 256, 64, 64),
               (2, 3, 37, 32, 48), (4, 40, 300, 64, 64)]
# float32 inputs: summation order only (tests/test_kernels.py's 3e-4);
# bf16 r/k/v: the output is rounded to bf16 by both
RWKV_TOL = {torch.float32: 3e-4, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", RWKV_SHAPES)
@pytest.mark.parametrize("with_state", [False, True])
def test_cuda_rwkv6_scan_matches_plain(cuda, dtype, shape, with_state):
    b, h, t, dk, dv = shape
    g = torch.Generator().manual_seed(t + dk)
    r, k = (torch.randn((b, h, t, dk), generator=g).to(cuda, dtype)
            for _ in range(2))
    v = torch.randn((b, h, t, dv), generator=g).to(cuda, dtype)
    # w and u in float32 with a state (the prefill path), in r's dtype
    # without (the forward path)
    wu = torch.float32 if with_state else dtype
    w = (0.3 + 0.695 * torch.rand((b, h, t, dk), generator=g)).to(cuda, wu)
    u = torch.randn((h, dk), generator=g).to(cuda, wu)
    s0 = ((torch.randn((b, h, dk, dv), generator=g) * 0.1).to(cuda)
          if with_state else None)
    tops.reset_launches()
    got, gs = tops.rwkv6(r, k, v, w, u, state=s0, return_state=True)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["rwkv6_scan"] == 1 and got.dtype == dtype
    want, ws = tref.rwkv6(r, k, v, w, u, state=s0, return_state=True)
    tol = RWKV_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(gs, ws, rtol=3e-4, atol=3e-4)
    torch.testing.assert_close(tops.rwkv6(r, k, v, w, u, state=s0).float(),
                               got.float(), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("g_t_d", [(2, 64, 8), (1, 500, 16), (3, 256, 128),
                                   (4, 1031, 2560)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_cuda_linear_scan_matches_plain(cuda, g_t_d, with_h0):
    gsz, t, d = g_t_d
    g = torch.Generator().manual_seed(t)
    a = (0.2 + 0.79 * torch.rand((gsz, t, d), generator=g)).to(cuda)
    b = torch.randn((gsz, t, d), generator=g).to(cuda)
    h0 = torch.randn((gsz, d), generator=g).to(cuda) if with_h0 else None
    tops.reset_launches()
    got = tops.linear_scan(a, b, h0=h0)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["linear_scan"] == 1
    # tests/test_kernels.py's 1e-4: an FMA a step against a log-depth scan
    torch.testing.assert_close(got, tref.linear_scan(a, b, h0=h0),
                               rtol=1e-4, atol=1e-4)


# the edges of the scans' tilings: rwkv6_scan's 32-column tiles, chunks of
# 16 steps at Dk 32/64 (8 at Dk 128, 32 at Dk 16) and 8-step output
# flushes; linear_scan's 32-channel tiles and 64-step slabs
RWKV_EDGES = [(1, 2, 0, 64, 64), (1, 2, 1, 64, 64), (1, 2, 7, 64, 64),
              (1, 2, 9, 64, 64), (1, 2, 15, 64, 64), (1, 2, 16, 64, 64),
              (2, 1, 17, 64, 40), (1, 2, 9, 128, 256), (1, 1, 70, 128, 256),
              (2, 3, 31, 16, 40), (1, 2, 33, 16, 8), (1, 1, 50, 32, 72)]
LSCAN_EDGES = [(2, 1, 8), (1, 63, 100), (3, 64, 100), (2, 65, 8),
               (1, 129, 2560)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", RWKV_EDGES)
def test_cuda_rwkv6_scan_edges(cuda, dtype, shape):
    # decays over [1e-6, 1] with exact 0s and 1s, a state in and out; the
    # final state bit for bit equal between two calls
    b, h, t, dk, dv = shape
    g = torch.Generator().manual_seed(7 * t + dv)
    r, k = (torch.randn((b, h, t, dk), generator=g).to(cuda, dtype)
            for _ in range(2))
    v = torch.randn((b, h, t, dv), generator=g).to(cuda, dtype)
    w = torch.pow(10.0, -6.0 * torch.rand((b, h, t, dk), generator=g))
    pick = torch.rand((b, h, t, dk), generator=g)
    w[pick < 0.05] = 0.0
    w[pick > 0.95] = 1.0
    w = w.to(cuda)
    u = torch.randn((h, dk), generator=g).to(cuda)
    s0 = (torch.randn((b, h, dk, dv), generator=g) * 0.1).to(cuda)
    tops.reset_launches()
    got, gs = tops.rwkv6(r, k, v, w, u, state=s0, return_state=True)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["rwkv6_scan"] == 1 and got.shape == (b, h, t, dv)
    want, ws = tref.rwkv6(r, k, v, w, u, state=s0, return_state=True)
    tol = RWKV_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(gs, ws, rtol=3e-4, atol=3e-4)
    _, gs2 = tops.rwkv6(r, k, v, w, u, state=s0, return_state=True)
    assert torch.equal(gs.view(torch.int32), gs2.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("g_t_d", LSCAN_EDGES)
@pytest.mark.parametrize("gate", ["near0", "near1"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_cuda_linear_scan_edges(cuda, g_t_d, gate, with_h0):
    # a near 0 (no memory) and near 1 (long memory)
    gsz, t, d = g_t_d
    g = torch.Generator().manual_seed(t + d)
    x = torch.rand((gsz, t, d), generator=g)
    a = (1e-3 * x if gate == "near0" else 1.0 - 1e-4 * x).to(cuda)
    b = torch.randn((gsz, t, d), generator=g).to(cuda)
    h0 = torch.randn((gsz, d), generator=g).to(cuda) if with_h0 else None
    tops.reset_launches()
    got = tops.linear_scan(a, b, h0=h0)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["linear_scan"] == 1
    torch.testing.assert_close(got, tref.linear_scan(a, b, h0=h0),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_recurrence_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((1, 2, 8, 16), device=cuda)
    u = torch.zeros((2, 16), device=cuda)
    with pytest.raises(ValueError, match="Dk in"):
        tops.rwkv6(x[..., :12].contiguous(), x[..., :12].contiguous(),
                   x, x[..., :12].contiguous(), u[:, :12].contiguous())
    with pytest.raises(ValueError, match="multiple of 8"):
        tops.rwkv6(x, x, x[..., :12].contiguous(), x, u)
    with pytest.raises(TypeError):
        tops.rwkv6(x.half(), x, x, x, u)
    with pytest.raises(TypeError, match="one dtype"):
        tops.rwkv6(x, x.bfloat16(), x, x, u)
    with pytest.raises(ValueError, match="aligned"):
        off = torch.zeros(257, device=cuda)[1:].view(1, 2, 8, 16)
        tops.rwkv6(off, x, x, x, u)
    with pytest.raises(ValueError, match="contiguous"):
        tops.rwkv6(x.transpose(2, 3).contiguous().transpose(2, 3), x, x, x, u)
    with pytest.raises(ValueError, match="state"):
        tops.rwkv6(x, x, x, x, u, state=torch.zeros((1, 2, 16, 16),
                                                    device=cuda).double())
    with pytest.raises(ValueError, match="mixed"):
        tops.rwkv6(x, x, x, x, u.cpu())
    a = torch.zeros((2, 8, 4), device=cuda)
    with pytest.raises(TypeError):
        tops.linear_scan(a.double(), a.double())
    with pytest.raises(ValueError, match="h0"):
        tops.linear_scan(a, a, h0=torch.zeros((2, 5), device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        tops.linear_scan(a.transpose(0, 1), a.transpose(0, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-2b"])
def test_cuda_recurrent_prefill_kernel_matches_plain(cuda, arch):
    # bf16 activations over float32 parameters, as at full width: the
    # kernel path against use_kernel=False on the same weights
    cfg = get_config(arch, reduced=True, dtype="bfloat16")
    gen = torch.Generator(device=cuda).manual_seed(0)
    kern = make_model(cfg, cuda, use_kernel=True).init(gen)
    rng = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (4, 16), generator=rng).to(cuda)
    tops.reset_launches()
    lk, sk = kern.prefill({"tokens": toks}, kern.init_decode_state(4, 32))
    torch.cuda.synchronize()
    n_rec = sum(k != "attn" for k in
                (cfg.block_pattern * cfg.n_layers)[:cfg.n_layers]) \
        if cfg.family == "hybrid" else cfg.n_layers
    name = "rwkv6_scan" if cfg.family == "rwkv6" else "linear_scan"
    assert tops.LAUNCHES[name] == n_rec
    kern.use_kernel = False
    lp, sp = kern.prefill({"tokens": toks}, kern.init_decode_state(4, 32))
    torch.testing.assert_close(lk, lp, rtol=5e-2, atol=5e-2)
    reqs = [Request(prompt=toks[i, : 5 + 3 * i].cpu().numpy(),
                    max_new_tokens=4) for i in range(3)]
    kern.use_kernel = True
    Engine(kern, batch_slots=2, max_seq=32).generate(reqs)
    assert all(len(r.out_tokens) == 4 for r in reqs)


# ---------------------------------------------------------------------------
# Training: the kernels have no backward, the plain path trains on the card
# ---------------------------------------------------------------------------
def _guarded_call(name, cuda):
    """A call of kernel `name` on CUDA inputs that take gradients."""
    g = torch.Generator(device=cuda).manual_seed(0)
    if name == "flash_attention":
        q = torch.randn((1, 2, 16, 64), generator=g, device=cuda)
        return lambda: tops.flash_attention(q.requires_grad_(), q, q)
    if name == "rwkv6_scan":
        r = torch.randn((1, 2, 8, 16), generator=g, device=cuda)
        w = torch.rand((1, 2, 8, 16), generator=g, device=cuda)
        u = torch.randn((2, 16), generator=g, device=cuda).requires_grad_()
        return lambda: tops.rwkv6(r, r, r, w, u)
    a = torch.rand((2, 8, 4), generator=g, device=cuda)
    b = torch.randn((2, 8, 4), generator=g, device=cuda).requires_grad_()
    return lambda: tops.linear_scan(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flash_attention", "rwkv6_scan",
                                  "linear_scan"])
def test_cuda_kernels_raise_under_autograd(cuda, name):
    call = _guarded_call(name, cuda)
    tops.reset_launches()
    with pytest.raises(NotImplementedError, match=name):
        call()
    assert tops.LAUNCHES[name] == 0
    with torch.no_grad():  # no graph: the kernel runs
        call()
    torch.cuda.synchronize()
    assert tops.LAUNCHES[name] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch, over, use_kernel, name", [
    ("qwen3-0.6b", dict(attn_impl="flash"), False, "flash_attention"),
    ("rwkv6-3b", {}, True, "rwkv6_scan"),
    ("recurrentgemma-2b", {}, True, "linear_scan")])
def test_cuda_train_step_on_a_kernel_path_raises(cuda, arch, over,
                                                 use_kernel, name):
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import TrainConfig, make_train_step

    cfg = get_config(arch, reduced=True, **over)
    model = make_model(cfg, cuda, use_kernel=use_kernel).init(
        torch.Generator(device=cuda).manual_seed(0))
    params = model.master_params()
    step = make_train_step(model, TrainConfig())
    toks = torch.randint(0, cfg.vocab, (2, 32), device=cuda,
                         dtype=torch.int32)
    with pytest.raises(NotImplementedError, match=name):
        step(params, init_opt_state(params), {"tokens": toks}, 0)


@pytest.mark.cuda
def test_cuda_train_step_matches_cpu(cuda):
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import TrainConfig, make_train_step

    cfg = get_config("qwen3-0.6b", reduced=True)
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu = make_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
        card = make_model(cfg, cuda).load_params(cpu.state_dict())
        pipe = TokenPipeline(vocab=cfg.vocab, batch=4, seq=64, device=cuda)
        batch = pipe(3)
        assert torch.equal(batch["tokens"].cpu(), torch.from_numpy(
            pipe.host_tokens(3)))
        out = {}
        for name, m, b in (("cpu", cpu, {"tokens": batch["tokens"].cpu()}),
                           ("card", card, batch)):
            params = m.master_params()
            out[name] = make_train_step(m, TrainConfig())(
                params, init_opt_state(params), b, 0)
        (pc, oc, mc), (pg, og, mg) = out["cpu"], out["card"]
        assert abs(float(mc["loss"]) - float(mg["loss"])) <= 1e-5
        for k in pc:
            torch.testing.assert_close(og["mu"][k].cpu(), oc["mu"][k],
                                       atol=1e-6, rtol=1e-4)
            torch.testing.assert_close(pg[k].cpu(), pc[k], atol=1e-6,
                                       rtol=0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-moe-a2.7b", "rwkv6-3b",
                                  "recurrentgemma-2b", "whisper-tiny",
                                  "phi-3-vision-4.2b"])
def test_cuda_placed_train_step_matches_plain(cuda, arch):
    """`launch.train`'s placed path on the card's one-rank NCCL mesh: the
    parameters placed by `validated_pspecs`, the batch by `batch_pspec`;
    two steps of the REDUCED model equal the plain step's bit for bit, and
    every leaf keeps its placement."""
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import (full_tensor, place_batch,
                                               place_params)
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import TrainConfig, make_train_step

    mesh = make_host_mesh(("data",), "cuda")
    cfg = get_config(arch, reduced=True)
    model = make_model(cfg, cuda).init(
        torch.Generator(device=cuda).manual_seed(0))
    step = make_train_step(model, TrainConfig())
    pipe = TokenPipeline(vocab=cfg.vocab, batch=4, seq=64, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    extra = {}
    if cfg.family == "vlm":
        extra["img_embeds"] = torch.randn(
            (4, cfg.n_img_tokens, cfg.d_model), generator=g, device=cuda)
    if cfg.family == "encdec":
        extra["audio_frames"] = torch.randn(
            (4, cfg.n_audio_frames, cfg.d_model), generator=g, device=cuda)
    plain = model.master_params()
    placed = place_params(plain, mesh)
    po, qo = init_opt_state(plain), init_opt_state(placed)
    for s in range(2):
        batch = dict(pipe(s), **extra)
        plain, po, mp = step(plain, po, batch, s)
        placed, qo, mq = step(placed, qo, place_batch(batch, mesh), s)
        assert torch.equal(mp["loss"], mq["loss"]), (
            s, float(mp["loss"]), float(mq["loss"]))
    for k, v in placed.items():
        assert str(v.device_mesh.device_type) == "cuda"
        assert v.placements == place_params({k: plain[k]}, mesh)[k].placements
    bad = {k: float((full_tensor(v) - plain[k]).abs().max())
           for k, v in placed.items() if not torch.equal(full_tensor(v),
                                                         plain[k])}
    assert not bad, bad
