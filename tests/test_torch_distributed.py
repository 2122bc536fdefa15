"""The sharded executor (`repro_torch.core.distributed`) against the
reference's `repro.core.distributed`, on identical numpy-seeded inputs.

The reference runs its per-shard walk under `shard_map` on a mesh of
devices.  Here it runs in this process: `_ref_mesh` maps the reference's
own `_exec_stages` (with its `_repartition` / `_broadcast` collectives)
over `p` virtual shards with `jax.vmap(body, axis_name="data")` — every
collective it uses (`all_to_all`, tiled `all_gather`, `psum`,
`axis_index`) has a named-axis batching rule — on `bind_global`'s batches
reshaped to `[p, per]`, with `use_kernels=False`.  On this tree that
gives the same bytes and the same `shuffle_stats` as the reference's
`execute_distributed` on a forced 8-device host mesh.  The port's global
output (the shards' batches concatenated shard-major) is held against it
slot by slot: validity and integer columns exactly, float columns within
`RecordBatch.equivalent`'s tolerance (rtol and atol 1e-5; on these inputs
the port reproduces the summation order, so they agree bit for bit).
The wire counters and the per-stage observation counts must be equal.

Cases: flowgen seeds 0-3 (the reference's mesh test's corpus, the port's
flows built by a copy of `tests/flowgen.py` bound to the port's API), q15
at 1,200 rows and q7 at 2,000 rows, on both wires (K = 1 and 4), at p = 8
and, for q15 and seed 0, at p = 1, 2 and 4.  No test starts a subprocess,
a process group or a socket; reference results are cached per module."""

from __future__ import annotations

import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flowgen
from test_torch_sca import JAX, TORCH, bind

from repro.core import distributed as DX
from repro.core import pipeline as JP
from repro.core.masked import run_flow_jit
from repro.core.optimizer import optimize as joptimize
from repro.core.physical import Ctx as JCtx
from repro.kernels import megakernel as JMK
from repro_torch.core import distributed as TD
from repro_torch.core import executor as TE
from repro_torch.core import flow as TF
from repro_torch.core import pipeline as TP
from repro_torch.core.cost import StatsStore, calibrate_hints, drift_score
from repro_torch.core.masked import run_flow_masked
from repro_torch.core.operators import Hints as THints
from repro_torch.core.operators import Source as TSource
from repro_torch.core.optimizer import optimize as toptimize
from repro_torch.core.physical import MESH_SHARDS_ENV
from repro_torch.core.physical import Ctx as TCtx
from repro_torch.core.record import Schema as TSchema
from repro_torch.core.record import batch_from_dict as tbatch
from repro_torch.kernels import megakernel as TMK

CPU = {"device": "cpu"}
FLOWGEN = ("seed0", "seed1", "seed2", "seed3")
ROWS = {"q15": 1200, "q7": 2000}


def _port_flowgen():
    """`tests/flowgen.py` loaded a second time with the port's flow API in
    its globals: `random_flow(seed)` then builds the same flow, with the
    same UDF closures, in the port."""
    spec = importlib.util.spec_from_file_location("flowgen_torch",
                                                  flowgen.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.F, mod.Hints, mod.Schema, mod.Source = TF, THints, TSchema, TSource
    mod.batch_from_dict, mod.executor = tbatch, TE
    return mod


FLOWGEN_T = _port_flowgen()


def _case(pkg, name: str):
    """(root, bindings) of a parity case built in `pkg`; the data comes
    from the reference's generators and is bound as identical copies."""
    if name in FLOWGEN:
        s = int(name[4:])
        root, _ = (flowgen if pkg is JAX else FLOWGEN_T).random_flow(s)
        _, make = flowgen.random_flow(s)
        data = make(s)
    else:
        root = pkg.flows.FLOWS[name]()[0]
        data = JAX.flows.FLOWS[name]()[1](ROWS[name], seed=3)
    return root, bind(pkg, {n: b.columns for n, b in data.items()})


def _plan(pkg, root, dop: int = 8):
    opt = joptimize if pkg is JAX else toptimize
    ctx = (JCtx if pkg is JAX else TCtx)(dop=dop)
    return opt(root, ctx, include_commutes=False).best.plan


def _stats(s) -> tuple:
    return (s.wire_rows, s.wire_bytes, s.collectives, s.broadcasts,
            s.dispatches, s.slices)


def _ref_mesh(plan, bindings, p: int, k: int) -> dict:
    """The reference's per-shard walk over `p` virtual shards in process
    (`jax.vmap` over the `data` axis): the global output's validity and
    columns on every slot, the wire counters and the observation vector
    (sources name-sorted, per-stage rows, per-stage aux)."""
    g = DX.bind_global(plan.node, bindings, p)
    names = sorted(g)
    stages = JP.lower_phys(plan)

    def body(*shards):
        obs: list = []
        out = DX._exec_stages(stages, dict(zip(names, shards)), "data", p,
                              False, {}, 4.0, plan.node, True, obs, True, k)
        src = [jax.lax.psum(jnp.sum(s.valid.astype(jnp.int32)), "data")
               for s in shards]
        return out, src, [o[0] for o in obs], [o[1] for o in obs]

    args = [jax.tree.map(lambda a: a.reshape((p, -1) + a.shape[1:]), g[n])
            for n in names]
    stats = DX.shuffle_stats()
    stats.clear()
    out, src, outs, auxs = jax.jit(jax.vmap(body, axis_name="data"))(*args)
    flat = jax.tree.map(lambda a: np.asarray(a).reshape(
        (-1,) + a.shape[2:]), out)
    return {"valid": flat.valid, "cols": dict(flat.columns),
            "stats": _stats(stats),
            "counts": np.array([int(np.asarray(x).reshape(-1)[0])
                                for x in [*src, *outs, *auxs]])}


@pytest.fixture(scope="module")
def reference():
    memo: dict = {}

    def get(name: str, p: int = 8, k: int = 1) -> dict:
        if (name, p, k) not in memo:
            root, b = _case(JAX, name)
            memo[name, p, k] = _ref_mesh(_plan(JAX, root), b, p, k)
        return memo[name, p, k]
    return get


def _port_mesh(name: str, p: int = 8, k: int = 1) -> dict:
    """The port's observed `DistributedPlan` step on the same case, plus
    its unobserved step's output and `execute_distributed`'s rows."""
    root, b = _case(TORCH, name)
    plan = _plan(TORCH, root)
    dp = TD.DistributedPlan(plan, mesh_shards=p, overlap_slices=k,
                            cache=TP.ExecutableCache(), **CPU)
    staged = dp.bind(b)
    stats = TD.shuffle_stats()
    stats.clear()
    out, counts = dp._executable(staged, True)(staged, dp.mesh)
    wire = _stats(stats)
    plain = dp.run_device(staged)
    once = TD.execute_distributed(plan, b, overlap_slices=k, mesh_shards=p,
                                  **CPU)
    return {"valid": out.valid.numpy(),
            "cols": {f: v.numpy() for f, v in out.columns.items()},
            "stats": wire, "counts": counts, "plain": plain, "once": once,
            "routes": dp._last_routes, "plan": plan, "root": root, "b": b}


def _assert_slots(got: dict, want: dict) -> None:
    """Validity on every slot exactly; columns on the valid slots, integers
    exactly and floats within `RecordBatch.equivalent`'s tolerance."""
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert set(got["cols"]) == set(want["cols"])
    v = want["valid"]
    for f, w in want["cols"].items():
        a, b = got["cols"][f][v], w[v]
        assert a.dtype == b.dtype, f
        if b.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


# ---------------------------------------------------------------------------
# The partition hash: the reference's uint64 hash, bit for bit
# ---------------------------------------------------------------------------
EDGE_KEYS = np.array([0, -1, 1, 2**63 - 1, -(2**63), 7, -7, 2**40 + 3,
                      -(2**33)], dtype=np.int64)


def _key_columns(kind: str, n: int = 4096) -> tuple:
    rng = np.random.default_rng(17)
    big = np.concatenate([EDGE_KEYS, rng.integers(-(2**63), 2**63 - 1,
                                                  n, dtype=np.int64)])
    if kind == "int64":
        return {"a": big}, ("a",)
    if kind == "two_keys":
        return {"a": big, "b": rng.permutation(big)}, ("a", "b")
    if kind == "int32":
        return {"a": big.astype(np.int32)}, ("a",)
    if kind == "bool_uint8":
        return {"a": big % 2 == 0, "b": (big % 251).astype(np.uint8)}, \
            ("b", "a")
    raise ValueError(kind)


@pytest.mark.parametrize("p", [3, 7, 8])
@pytest.mark.parametrize("kind", ["int64", "two_keys", "int32",
                                  "bool_uint8"])
def test_key_hash_matches_reference(kind, p):
    cols, keys = _key_columns(kind)
    n = len(cols[keys[0]])
    want = DX._key_hash_np(cols, keys, n)
    tcols = {f: torch.from_numpy(v) for f, v in cols.items()}
    got = TD._key_hash(tcols, keys).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, want)
    tgt = TD._target(tcols, keys, p).numpy()
    np.testing.assert_array_equal(tgt, (want % np.uint64(p)).astype(np.int64))
    assert tgt.min() >= 0 and tgt.max() < p


# ---------------------------------------------------------------------------
# Lane packing: bit-exact roundtrip for every column dtype, the reference's
# lanes bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,vals", [
    (np.int64, [-(2**63), 2**63 - 1, 0, -1, 7]),
    (np.uint64, [0, 2**64 - 1, 1, 2**63, 42]),
    (np.float64, [0.0, -0.0, np.nan, np.inf, 1e-300]),
    (np.float32, [0.0, -0.0, np.nan, -np.inf, 1e-30]),
    (np.int32, [-(2**31), 2**31 - 1, 0, -1, 5]),
    (np.int8, [-128, 127, 0, -1, 3]),
    (np.uint16, [0, 65535, 1, 256, 9]),
    (np.bool_, [True, False, True, True, False]),
])
def test_lane_pack_roundtrip_bit_exact(dtype, vals):
    a = np.array(vals, dtype=dtype)
    if dtype is np.float64:  # a NaN with a payload must survive too
        a[2] = np.array([0x7FF8DEADBEEF0001], np.int64).view(np.float64)[0]
    packed, meta = TD._pack_payload({"c": torch.from_numpy(a.copy())})
    assert packed.dtype == torch.int64 and packed.shape == (1, len(a))
    want, _ = DX._pack_payload({"c": jnp.asarray(a)})
    np.testing.assert_array_equal(packed.numpy().view(np.uint64),
                                  np.asarray(want))
    (got,) = TD._unpack_payload(packed, meta).values()
    b = got.numpy()
    assert b.dtype == a.dtype
    assert (a.view(np.uint8) == b.view(np.uint8)).all()


def test_lane_pack_multi_column_layout():
    cols = {"a": torch.arange(8, dtype=torch.int64),
            "b": torch.arange(8, dtype=torch.float32),
            "c": torch.ones(8, dtype=torch.bool)}
    packed, meta = TD._pack_payload(cols)
    assert packed.shape == (3, 8)  # one lane per column
    out = TD._unpack_payload(packed, meta)
    assert list(out) == ["a", "b", "c"]
    for f in cols:
        assert torch.equal(out[f], cols[f]) and out[f].dtype == cols[f].dtype


def test_slice_count_divides_capacity():
    assert TD._slice_count(1024, 4) == 4
    assert TD._slice_count(1024, 1) == 1
    assert TD._slice_count(8, 16) == 8
    assert TD._slice_count(12, 8) == 6
    assert TD._slice_count(7, 4) == 1
    for cap in (1, 7, 8, 12, 96, 1000):
        for k in (1, 2, 3, 4, 8, 16):
            assert TD._slice_count(cap, k) == DX._slice_count(cap, k)


def _mixed_shards(p: int, cap: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(p):
        cols = {"k": torch.from_numpy(rng.integers(-3, 4, cap)),
                "f": torch.from_numpy(rng.standard_normal(cap)),
                "h": torch.from_numpy(rng.integers(-9, 9, cap)
                                      .astype(np.int16)),
                "b": torch.from_numpy(rng.random(cap) < 0.5)}
        out.append(TD.M.MaskedBatch(cols, torch.from_numpy(
            rng.random(cap) < 0.7)))
    return out


@pytest.mark.parametrize("p", [2, 8])
def test_both_wires_are_bit_identical_and_route_by_hash(p):
    """`_repartition` and `_broadcast` on the serial and the sliced wire
    give the same bits; every received row lands on the shard its key
    hashes to, and the shards' valid rows are exactly the senders'."""
    mesh = TD.ShardMesh(p, ["cpu"])
    bs = _mixed_shards(p, 64, seed=p)
    sent = sum(int(b.valid.sum()) for b in bs)
    for ship in ("partition", "broadcast"):
        wires = []
        for k in (1, 4):
            if ship == "partition":
                wires.append(TD._repartition(bs, ("k",), mesh, k, False))
            else:
                wires.append(TD._broadcast(bs, mesh, k, False))
        for s1, s4 in zip(*wires):
            assert torch.equal(s1.valid, s4.valid)
            for f in s1.columns:
                a, b = s1.columns[f], s4.columns[f]
                assert a.dtype == b.dtype and a.shape == (p * 64,)
                if a.dtype == torch.float64:
                    a, b = a.view(torch.int64), b.view(torch.int64)
                assert torch.equal(a, b), (ship, f)
        got = sum(int(s.valid.sum()) for s in wires[0])
        assert got == (sent if ship == "partition" else p * sent)
        if ship == "partition":
            for d, s in enumerate(wires[0]):
                tgt = TD._target(s.columns, ("k",), p)
                assert bool((tgt[s.valid] == d).all())


# ---------------------------------------------------------------------------
# Wire accounting, knobs, the mesh
# ---------------------------------------------------------------------------
def test_shuffle_stats_accounting():
    st = TD.shuffle_stats()
    st.clear()
    b = TD.M.MaskedBatch({f"c{i}": torch.arange(64) for i in range(3)},
                         torch.ones(64, dtype=torch.bool))
    TD._account(b, p=4, k=1, broadcast=False)
    TD._account(b, p=4, k=4, broadcast=True)
    assert st.collectives == 1 and st.broadcasts == 1 and st.sites == 2
    assert st.wire_rows == 2 * 64 * 4
    assert st.wire_bytes == 2 * 64 * 4 * (3 * 8 + 1)
    assert st.dispatches == (3 + 1) + 4
    assert st.slices == 1 + 4
    assert st.overlap_fraction() == pytest.approx(1 - 2 / 5)
    st.clear()
    assert st.sites == 0 and st.wire_bytes == 0
    assert st.overlap_fraction() == 0.0


def test_overlap_env_knobs(monkeypatch):
    for env in (TD.OVERLAP_ENV, TD.OVERLAP_SLICES_ENV):
        monkeypatch.delenv(env, raising=False)
    assert TD.overlap_slices_default() == TD.DEFAULT_OVERLAP_SLICES == 4
    monkeypatch.setenv(TD.OVERLAP_SLICES_ENV, "6")
    assert TD.overlap_slices_default() == 6
    monkeypatch.setenv(TD.OVERLAP_ENV, "0")   # kill switch wins
    assert TD.overlap_slices_default() == 1
    monkeypatch.delenv(TD.OVERLAP_ENV)
    monkeypatch.setenv(TD.OVERLAP_SLICES_ENV, "0")
    assert TD.overlap_slices_default() == 1
    monkeypatch.setenv(TD.OVERLAP_SLICES_ENV, "x")
    assert TD.overlap_slices_default() == TD.DEFAULT_OVERLAP_SLICES


def test_mesh_width_defaults_and_virtual_shards(monkeypatch):
    """The default width is every device of `device`, narrowed by
    REPRO_MESH_SHARDS; an explicit `mesh_shards` is not clipped to the
    device count (the reference clips it)."""
    monkeypatch.delenv(MESH_SHARDS_ENV, raising=False)
    assert TD._default_mesh(None, None, "cpu").p == 1
    monkeypatch.setenv(MESH_SHARDS_ENV, "8")
    assert TD._default_mesh(None, None, "cpu").p == 1
    m = TD._default_mesh(None, 8, "cpu")
    assert m.p == 8 and {m.device_of(i) for i in range(8)} == {
        torch.device("cpu")}
    mesh = TD.ShardMesh(3, ["cpu"])
    assert TD._default_mesh(mesh, 8, "cpu") is mesh
    with pytest.raises(ValueError):
        TD.ShardMesh(0, ["cpu"])


def test_entry_points_need_a_card_unless_given_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    root, b = _case(TORCH, "q15")
    plan = _plan(TORCH, root)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TD.execute_distributed(plan, b)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TD.DistributedPlan(plan, mesh_shards=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TD.bind_global(root, b, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TD.ShardMesh(8)


def test_bind_global_matches_reference_with_a_partitioned_source():
    """At p = 8: contiguous blocks for an ordinary source, pre-hashed
    shard blocks (with the per-shard capacity raised to the fullest
    block) for a `partitioned_on` one; every slot as the reference
    binds it."""
    rng = np.random.default_rng(4)
    n = 1001
    data = {"P": {"k": rng.integers(0, 3, n), "v": rng.standard_normal(n)},
            "Q": {"q": rng.integers(-5, 5, n), "w": rng.integers(0, 9, n)}}

    def flow(pkg):
        s = pkg.Schema.of(k=np.int64, v=np.float64)
        part = pkg.F.source("P", s, num_records=n, partitioned_on=["k"])
        other = pkg.F.source("Q", pkg.Schema.of(q=np.int64, w=np.int64),
                             num_records=n)
        return pkg.F.cross(part, other, name="X")

    want = DX.bind_global(flow(JAX), bind(JAX, data), 8)
    got = TD.bind_global(flow(TORCH), bind(TORCH, data), 8, device="cpu")
    assert set(got) == set(want) == {"P", "Q"}
    for name in want:
        w, g = want[name], got[name]
        assert g.capacity == w.capacity and g.capacity % 8 == 0
        np.testing.assert_array_equal(g.valid.numpy(), np.asarray(w.valid))
        for f in w.columns:
            np.testing.assert_array_equal(g.columns[f].numpy(),
                                          np.asarray(w.columns[f]))
    # the partitioned source's blocks are its rows' hash targets
    per = got["P"].capacity // 8
    tgt = TD._target(got["P"].columns, ("k",), 8)
    shard = torch.arange(got["P"].capacity) // per
    assert bool((tgt[got["P"].valid] == shard[got["P"].valid]).all())
    assert per > int(np.ceil(n / 8))  # 3 keys on 8 shards: one block is full


# ---------------------------------------------------------------------------
# Route planning with collectives kept at solo-stage inputs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["q15", "q7", "clickstream", "textmining"])
@pytest.mark.parametrize("dop", [1, 8])
def test_plan_routes_require_forward_matches_reference(name, dop):
    stages = {}
    for pkg, P in ((JAX, JP), (TORCH, TP)):
        root = pkg.flows.FLOWS[name]()[0]
        stages[P] = P.lower_phys(_plan(pkg, root, dop))
    assert [(st.kind, st.ship, st.ship_keys) for st in stages[TP]] \
        == [(st.kind, st.ship, st.ship_keys) for st in stages[JP]]
    _, make = JAX.flows.FLOWS[name]()
    for rows in (2048, 1 << 20):
        caps = {s: max(8, rows // 8) for s in make(64, seed=1)}
        for budget in (128 * 2**20, TMK.SPAN_BUDGET_BYTES):
            for rf in (False, True):
                got = TMK.plan_routes(stages[TP], caps, vmem_bytes=budget,
                                      require_forward=rf)
                want = JMK.plan_routes(stages[JP], caps, vmem_bytes=budget,
                                       require_forward=rf)
                assert got == want, (rows, budget, rf)
            # the default is the route every earlier caller computed
            assert TMK.plan_routes(stages[TP], caps, vmem_bytes=budget) \
                == TMK.plan_routes(stages[TP], caps, vmem_bytes=budget,
                                   require_forward=False)
            spans = [e for e in (TMK.plan_routes(
                stages[TP], caps, vmem_bytes=budget,
                require_forward=True) or ()) if e[0] == "mega"]
            for _, i, j in spans:
                assert all(s == "forward" for st in stages[TP][i:j]
                           for s in st.ship)


# ---------------------------------------------------------------------------
# The reference's mesh at 8 shards in process, slot by slot
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("name", [*FLOWGEN, "q15", "q7"])
def test_mesh_matches_reference_slot_by_slot(reference, name, k):
    want = reference(name, 8, k)
    got = _port_mesh(name, 8, k)
    _assert_slots(got, want)
    assert got["stats"] == want["stats"]
    np.testing.assert_array_equal(got["counts"], want["counts"])
    # the unobserved executable and the one-shot entry agree with it
    plain = got["plain"]
    np.testing.assert_array_equal(plain.valid.numpy(), want["valid"])
    rows = {f: v[want["valid"]] for f, v in want["cols"].items()}
    once = got["once"]
    for f, v in rows.items():
        np.testing.assert_allclose(np.asarray(once[f]), v, rtol=1e-5,
                                   atol=1e-5, err_msg=f)
    # and the eager executor, where the reference's mesh test holds it
    assert once.equivalent(TE.execute(got["root"], got["b"]), atol=1e-4)


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("name", ["q15", "seed0"])
def test_mesh_matches_reference_at_other_widths(reference, name, p):
    want = reference(name, p, 4)
    got = _port_mesh(name, p, 4)
    _assert_slots(got, want)
    assert got["stats"] == want["stats"]
    np.testing.assert_array_equal(got["counts"], want["counts"])


def test_both_wires_are_byte_identical(reference):
    """K = 1 and K = 4 give byte-identical global batches in the port, as
    in the reference."""
    for name in ("q15", "q7", "seed0"):
        a, b = _port_mesh(name, 8, 1), _port_mesh(name, 8, 4)
        np.testing.assert_array_equal(a["valid"], b["valid"])
        for f in a["cols"]:
            assert a["cols"][f].tobytes() == b["cols"][f].tobytes(), f
        r = reference(name, 8, 1)
        np.testing.assert_array_equal(r["valid"], reference(name, 8, 4)
                                      ["valid"])


def test_mesh_spans_match_reference():
    """q15 at 4,800 rows on 8 shards: every shard's lineitem block is
    8-blockable, so the filter and the combiner fuse into a span on every
    shard while the repartition stays at the merge's solo input; the
    global output equals the reference's slot by slot."""
    data = JAX.flows.FLOWS["q15"]()[1](4800, seed=5)
    data = {n: b.columns for n, b in data.items()}
    jroot, troot = JAX.flows.q15()[0], TORCH.flows.q15()[0]
    want = _ref_mesh(_plan(JAX, jroot), bind(JAX, data), 8, 4)
    dp = TD.DistributedPlan(_plan(TORCH, troot), mesh_shards=8,
                            overlap_slices=4, cache=TP.ExecutableCache(),
                            **CPU)
    out = dp.run_device(dp.bind(bind(TORCH, data)))
    assert dp._last_routes == (("mega", 0, 2), ("solo", 2), ("solo", 3))
    _assert_slots({"valid": out.valid.numpy(),
                   "cols": {f: v.numpy() for f, v in out.columns.items()}},
                  want)
    assert out.to_record_batch().equivalent(
        TE.execute(troot, bind(TORCH, data)), atol=1e-4)


def test_handles_sharing_a_cache_keep_their_own_mesh():
    """Two handles of one plan sharing one executable cache: equal meshes
    share the build (and each handle reads its own routes); a mesh on
    other devices gets its own build, and a batch bound on another device
    or at a capacity the shards do not divide is refused, not moved."""
    data = JAX.flows.FLOWS["q15"]()[1](4800, seed=5)
    data = {n: b.columns for n, b in data.items()}
    troot = TORCH.flows.q15()[0]
    plan, cache = _plan(TORCH, troot), TP.ExecutableCache()

    def handle(mesh):
        return TD.DistributedPlan(plan, mesh=mesh, overlap_slices=4,
                                  cache=cache)

    a = handle(TD.ShardMesh(8, ("cpu",)))
    b = handle(TD.ShardMesh(8, ("cpu",)))
    staged = a.bind(bind(TORCH, data))
    out_a = a.run_device(staged)
    assert b._last_routes is None
    out_b = b.run_device(staged)
    assert cache.stats().traces == 1 and cache.stats().hits == 1
    assert b._last_routes == a._last_routes == (
        ("mega", 0, 2), ("solo", 2), ("solo", 3))
    assert torch.equal(out_a.valid, out_b.valid)

    meta = handle(TD.ShardMesh(8, ("meta",)))
    assert meta._executable(
        {n: type(v)({f: c.to("meta") for f, c in v.columns.items()},
                    v.valid.to("meta")) for n, v in staged.items()},
        False) \
        is not a._executable(staged, False)
    assert cache.stats().traces == 2
    with pytest.raises(ValueError, match="bound on cpu"):
        meta.run_device(staged)
    odd = {n: type(v)({f: c[:-1] for f, c in v.columns.items()},
                      v.valid[:-1]) for n, v in staged.items()}
    with pytest.raises(ValueError, match="not divisible"):
        a.run_device(odd)
    with pytest.raises(KeyError, match="no binding"):
        a.run_device({})


# ---------------------------------------------------------------------------
# Truncations both packages share (ROADMAP.md Queue 3): pinned, not repaired
# ---------------------------------------------------------------------------
def _hot_key_flow(pkg, n: int):
    src = pkg.F.source("I", pkg.Schema.of(k=np.int64, v=np.int64),
                       num_records=n)

    def keep(g, out):
        out.emit_records(where=g.any(g.get("v") > 0))

    return pkg.F.reduce_(src, ["k"], keep, name="KeepHot",
                         hints=pkg.Hints(distinct_keys=64))


@pytest.mark.parametrize("k", [1, 4])
def test_skewed_shard_truncates_as_in_the_reference(k):
    """One hot key sends every row to one shard, past the per-shard
    capacity `compact_to_estimate(..., shards=8)` plans (estimate / 8 x
    slack): both packages drop the same rows."""
    n = 4096
    rng = np.random.default_rng(8)
    data = {"I": {"k": np.zeros(n, np.int64),
                  "v": rng.integers(-3, 9, n)}}
    jroot, troot = _hot_key_flow(JAX, n), _hot_key_flow(TORCH, n)
    want = _ref_mesh(_plan(JAX, jroot), bind(JAX, data), 8, k)
    dp = TD.DistributedPlan(_plan(TORCH, troot), mesh_shards=8,
                            overlap_slices=k, cache=TP.ExecutableCache(),
                            **CPU)
    out = dp.run_device(dp.bind(bind(TORCH, data)))
    np.testing.assert_array_equal(out.valid.numpy(), want["valid"])
    eager = TE.execute(troot, bind(TORCH, data))
    assert eager.capacity == n
    assert int(out.valid.sum()) == int(want["valid"].sum()) < n


def test_stacked_reduces_truncate_as_in_the_reference():
    """`tests/test_property_reorder.py::test_masked_executor_matches_eager_
    on_random_flows`'s saved example: three stacked Reduces on (A, B) over
    32 rows (seed 0).  Eager keeps 21 groups; both masked executors
    compact the third Reduce's input to the estimate's floor of 8."""
    fields = ("A", "B", "C", "D")
    rng = np.random.default_rng(0)
    data = {"I": {f: rng.integers(0, 6, 32) for f in fields}}

    def red(g, out):
        out.emit(g.keys().set("sum_A", g.sum("A")).set("max_A", g.max("A")))

    def build(pkg):
        node = pkg.F.source("I", pkg.Schema.of(**{f: np.int64
                                                  for f in fields}))
        for i in range(3):
            node = pkg.F.reduce_(node, ["A", "B"], red, name=f"red_A#{i}")
        return node

    want = run_flow_jit(build(JAX), bind(JAX, data))
    got = run_flow_masked(build(TORCH), bind(TORCH, data), **CPU)
    eager = TE.execute(build(TORCH), bind(TORCH, data))
    assert eager.capacity == 21
    assert got.capacity == want.to_numpy().compact().capacity == 8
    assert got.equivalent(want.to_numpy().compact(), atol=0)


# ---------------------------------------------------------------------------
# Twins of the reference's mesh tests
# ---------------------------------------------------------------------------
def _agg(g, out):
    out.emit(g.keys().set("s", g.sum("v")))


@pytest.mark.parametrize("p", [1, 8])
def test_distributed_plan_serves_and_caches(p):
    """`test_distributed_plan_single_device_serves_and_caches`, and the
    same on 8 virtual shards: warm serving never rebuilds, the observing
    executable builds once, and the wire is counted once per build."""
    n = 512
    src = TF.source("I", TSchema.of(k=np.int64, v=np.int64), num_records=n)
    root = TF.reduce_(src, ["k"], _agg, name="Agg",
                      hints=THints(distinct_keys=16))
    rng = np.random.default_rng(5)
    b = {"I": tbatch({"k": rng.integers(0, 16, n),
                      "v": rng.integers(-50, 50, n)})}
    ref = TE.execute(root, b)
    dp = TD.compile_distributed(toptimize(root, TCtx(dop=p)),
                                mesh_shards=p, cache=TP.ExecutableCache(),
                                **CPU)
    stats = TD.shuffle_stats()
    stats.clear()
    assert dp.run(b).equivalent(ref, atol=0)
    cold = _stats(stats)
    assert (cold[0] > 0) == (p > 1)
    warm0 = dp.cache_stats()
    for _ in range(3):
        assert dp.run(b).equivalent(ref, atol=0)
    warm1 = dp.cache_stats()
    assert warm1.traces == warm0.traces
    assert warm1.hits == warm0.hits + 3
    assert _stats(stats) == cold          # a warm step counts no wire
    store = StatsStore()
    dp.run(b, stats_store=store)
    assert store.source_rows()["I"] == pytest.approx(float(n))
    t2 = dp.cache_stats().traces
    assert t2 == warm1.traces + 1
    dp.run(b, stats_store=store)
    assert dp.cache_stats().traces == t2


def test_distributed_plan_rejects_non_plan():
    with pytest.raises(TypeError, match="PhysPlan"):
        TD.DistributedPlan(object(), **CPU)


@pytest.fixture(scope="module")
def paper_data():
    out = {}
    for name in ("q15", "clickstream"):
        root, make = TORCH.flows.FLOWS[name]()
        b = make(6000, seed=7)
        out[name] = (root, b, TE.execute(root, b))
    return out


@pytest.mark.parametrize("shards", [None, 8])
@pytest.mark.parametrize("name", ["q15", "clickstream"])
def test_distributed_equivalent(paper_data, name, shards):
    """`tests/test_executors.py::test_distributed_equivalent`: the two
    cheapest plans on the default mesh (one CPU shard) and on 8 shards."""
    root, b, ref = paper_data[name]
    res = toptimize(root, TCtx(dop=shards or 1), include_commutes=False)
    for rp in res.ranked[:2]:
        got = TD.execute_distributed(rp.plan, b, mesh_shards=shards, **CPU)
        assert got.equivalent(ref, atol=1e-4), rp.order()


def _combiner_flow(pkg):
    src = pkg.F.source("I", pkg.Schema.of(k=np.int64, v=np.int64,
                                          w=np.float64), num_records=8192)

    def agg(g, out):
        out.emit(g.keys().set("s", g.sum("v")).set("avg", g.mean("w")))

    return pkg.F.reduce_(src, ["k"], agg, name="Agg",
                         hints=pkg.Hints(distinct_keys=64))


def test_distributed_combiner_reduces_shuffle_rows():
    """`tests/test_split_reduce.py::test_distributed_combiner_reduces_
    shuffle_rows` on 8 shards: the split plan ships >= 3x fewer rows than
    the unsplit one, with bit-identical integer aggregates; both plans'
    wire rows equal the reference's."""
    rng = np.random.default_rng(11)
    data = {"I": {"k": rng.integers(0, 64, 8192),
                  "v": rng.integers(-100, 100, 8192),
                  "w": rng.uniform(0, 1, 8192)}}
    b = bind(TORCH, data)
    root = _combiner_flow(TORCH)
    ref = TE.execute(root, b)
    res = toptimize(root, TCtx(dop=8))
    assert ".pre" in res.best.order(), res.best.order()
    unsplit = next(rp for rp in res.ranked if ".pre" not in rp.order())
    stats = TD.shuffle_stats()
    outs, wire = {}, {}
    for what, plan in (("split", res.best.plan), ("unsplit", unsplit.plan)):
        stats.clear()
        outs[what] = TD.execute_distributed(plan, b, mesh_shards=8, **CPU)
        assert outs[what].equivalent(ref, atol=1e-4)
        wire[what] = stats.wire_rows
        assert stats.collectives == 1
    for f in ("k", "s"):
        assert sorted(np.asarray(outs["split"][f]).tolist()) \
            == sorted(np.asarray(outs["unsplit"][f]).tolist()), f
    assert wire["unsplit"] / wire["split"] >= 3.0, wire
    jres = joptimize(_combiner_flow(JAX), JCtx(dop=8))
    junsplit = next(rp for rp in jres.ranked if ".pre" not in rp.order())
    jb = bind(JAX, data)
    assert _ref_mesh(jres.best.plan, jb, 8, 4)["stats"][0] == wire["split"]
    assert _ref_mesh(junsplit.plan, jb, 8, 4)["stats"][0] == wire["unsplit"]


def test_sliced_observations_equal_the_serial_ones():
    """`_MESH_SCRIPT`'s observation check: a store fed by the sliced wire
    holds exactly the counts the serial wire records."""
    root, b = _case(TORCH, "seed2")
    plan = _plan(TORCH, root)
    stores = {}
    for k in (1, 4):
        stores[k] = StatsStore()
        TD.execute_distributed(plan, b, overlap_slices=k, mesh_shards=8,
                               stats_store=stores[k], **CPU)
    assert stores[1].source_rows() == stores[4].source_rows()
    s1, s4 = dict(stores[1].stages()), dict(stores[4].stages())
    assert set(s1) == set(s4) and s1
    for key in s1:
        assert (s1[key].rows_in, s1[key].rows_out, s1[key].groups) \
            == (s4[key].rows_in, s4[key].rows_out, s4[key].groups), key


def test_adaptive_drift_swaps_on_the_mesh():
    """`_MESH_SCRIPT`'s adaptive check on 8 shards: drift crushes the
    filter's selectivity, the calibrated plan is swapped in, every batch
    equals eager, and a warm step after it builds nothing."""
    n = 4096
    s = TSchema.of(k=np.int64, v=np.int64, w=np.int64)
    src = TF.source("I", s, num_records=n)

    def keep(ir, out):
        out.emit(ir.copy(), where=ir.get("w") > 0)

    filt = TF.map_(src, keep, name="Keep", hints=THints(selectivity=0.9))
    root = TF.reduce_(filt, ["k"], _agg, name="Agg",
                      hints=THints(distinct_keys=64))

    def mk(seed, drift=0.0):
        rng = np.random.default_rng(seed)
        lo = -1 if drift == 0.0 else -19
        return {"I": tbatch({"k": rng.integers(0, 64, n),
                             "v": rng.integers(-100, 100, n),
                             "w": rng.integers(lo, 2, n)})}

    cache = TP.ExecutableCache()
    cur = root

    def handle(flow):
        return TD.DistributedPlan(
            toptimize(flow, TCtx(dop=8), include_commutes=False),
            mesh_shards=8, cache=cache, **CPU)

    dp, store, swaps = handle(cur), StatsStore(), 0
    for t in range(8):
        b = mk(100 + t, drift=0.0 if t < 3 else 0.9)
        store.tick()
        assert dp.run(b, stats_store=store).equivalent(
            TE.execute(root, b), atol=0), t
        if drift_score(cur, store) > 0.5:
            cal = calibrate_hints(root, store, prior_weight=0.0)
            if TP.semantic_key(cal) != TP.semantic_key(cur):
                cur = cal
                dp, store = handle(cur), StatsStore()
                swaps += 1
    assert swaps >= 1
    b = mk(999)
    dp.run(b)
    st0 = dp.cache_stats()
    dp.run(b)
    st1 = dp.cache_stats()
    assert st1.traces == st0.traces and st1.hits == st0.hits + 1


def test_observation_store_matches_reference_counts(reference):
    """The port's store, fed by `execute_distributed(stats_store=)` on 8
    shards, holds the counts the reference's psums give (q15: the
    filter's global selectivity, the Reduce's groups)."""
    want = reference("q15", 8, 4)["counts"]
    root, b = _case(TORCH, "q15")
    plan = _plan(TORCH, root)
    store = StatsStore()
    TD.execute_distributed(plan, b, mesh_shards=8, stats_store=store, **CPU)
    stages = TP.lower_phys(plan)
    names = sorted(n.name for n in root.iter_nodes()
                   if isinstance(n, TSource))
    assert store.source_rows() == {n: float(c)
                                   for n, c in zip(names, want)}
    ns = len(names)
    for i, st in enumerate(stages):
        o = store.stage(TP.stage_key(st))
        assert o.rows_out == float(want[ns + i])
    assert store.source_rows()["lineitem"] == pytest.approx(1200.0)
