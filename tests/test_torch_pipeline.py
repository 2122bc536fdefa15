"""The whole slice — optimize -> compile(use_kernels=True) -> run /
run_device — against the reference's compiled path (`use_kernels=False`,
the exact one) on identical numpy-seeded inputs, plus the executable
cache's warm-path and device contracts."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_sca import (JAX, PAPER_FLOWS, TORCH, assert_same_rows, bind,
                            columns_of, corpus_flow)

from repro.core.optimizer import optimize as joptimize
from repro.core.pipeline import ExecutableCache as JCache
from repro_torch import interop
from repro_torch.core import executor as TE
from repro_torch.core.optimizer import optimize as toptimize
from repro_torch.core.pipeline import ExecutableCache, compile_plan


@pytest.mark.parametrize("rows", [1000, 4000])
@pytest.mark.parametrize("name", PAPER_FLOWS)
def test_slice_matches_reference(name, rows):
    troot, _ = TORCH.flows.FLOWS[name]()
    jroot, make = JAX.flows.FLOWS[name]()
    jb = make(rows, seed=rows + 1)
    d = {s: b.columns for s, b in jb.items()}
    cp = toptimize(troot).best.compile(use_kernels=True, device="cpu",
                                       cache=ExecutableCache())
    got = cp.run(interop.bindings(d))
    ref = joptimize(jroot).best.compile(use_kernels=False,
                                        cache=JCache()).run(jb)
    assert_same_rows(interop.columns(got), columns_of(ref))
    # the device-resident path gives the same rows
    dev_out = cp.run_device(cp.bind_device(interop.bindings(d)))
    assert_same_rows(interop.columns(dev_out), columns_of(ref))


@pytest.mark.parametrize("seed", range(4))
def test_corpus_compiled_matches_eager(seed):
    troot, data = corpus_flow(TORCH, seed)
    d = data(seed + 31)
    for use_kernels in (False, True):
        cp = compile_plan(troot, use_kernels=use_kernels, device="cpu",
                          cache=ExecutableCache())
        assert_same_rows(columns_of(cp.run(bind(TORCH, d))),
                         columns_of(TE.execute(troot, bind(TORCH, d))))


def test_warm_calls_never_rebuild():
    root, make = TORCH.flows.q15()
    cache = ExecutableCache()
    cp = toptimize(root).best.compile(use_kernels=True, device="cpu",
                                      cache=cache)
    cp.run(make(3000, seed=1))
    assert cache.stats().traces == 1
    masked = cp.bind_device(make(3000, seed=2))
    for seed in range(3, 6):
        cp.run(make(3000, seed=seed))
        cp.run_device(masked)
    st = cache.stats()
    assert st.traces == 1 and st.misses == 1 and st.hits == 6
    # an identical flow rebuilt from scratch shares the warm executable
    root2, _ = TORCH.flows.q15()
    cp2 = toptimize(root2).best.compile(use_kernels=True, device="cpu",
                                        cache=cache)
    cp2.run(make(3000, seed=9))
    assert cache.stats().traces == 1
    # a new capacity bucket is a new executable
    cp.run(make(9000, seed=1))
    assert cache.stats().traces == 2


def test_cache_is_a_bounded_lru():
    c = ExecutableCache(maxsize=2)
    for k in "abc":
        c.put(k, k)
    assert c.get("a") is None and c.get("c") == "c"
    assert c.stats().evictions == 1


def test_compile_defaults_to_the_megakernel_route(monkeypatch):
    from repro.core.pipeline import MEGAKERNEL_ENV
    from repro.core.pipeline import compile_plan as jcompile_plan

    monkeypatch.delenv(MEGAKERNEL_ENV, raising=False)
    for name in PAPER_FLOWS:
        troot, _ = TORCH.flows.FLOWS[name]()
        jroot, make = JAX.flows.FLOWS[name]()
        jb = make(1500, seed=2)
        d = {s: b.columns for s, b in jb.items()}
        cp = compile_plan(troot, device="cpu", cache=ExecutableCache())
        jcp = jcompile_plan(jroot, cache=JCache())
        assert cp.use_megakernel and jcp.use_megakernel
        assert toptimize(troot).compile(device="cpu").use_megakernel
        cp.run(interop.bindings(d))
        jcp.run(jb)
        assert cp._last_routes == jcp._last_routes


def test_entry_points_run_on_cuda_unless_told_otherwise():
    root, make = TORCH.flows.q15()
    res = toptimize(root)
    if torch.cuda.is_available():
        assert res.compile().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        res.compile()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compile_plan(root)
    assert res.compile(device="cpu").device.type == "cpu"


def test_run_device_refuses_batches_on_another_device():
    root, make = TORCH.flows.q15()
    cp = compile_plan(root, device="cpu", cache=ExecutableCache())
    masked = cp.bind_device(make(500, seed=0))
    masked = {k: type(v)({f: c.to("meta") for f, c in v.columns.items()},
                         v.valid.to("meta"), v.order)
              for k, v in masked.items()}
    with pytest.raises(ValueError, match="bound on"):
        cp.run_device(masked)


def test_bound_columns_are_int64_and_float64():
    root, make = TORCH.flows.q15()
    cp = compile_plan(root, device="cpu", cache=ExecutableCache())
    masked = cp.bind_device(make(500, seed=0))
    li = masked["lineitem"]
    assert li.columns["l_suppkey"].dtype == torch.int64
    assert li.columns["l_ext"].dtype == torch.float64
    assert li.capacity == 512 and int(li.valid.sum()) == 500
    assert li.order == ("l_suppkey",)
    out = cp.run_device(masked)
    assert out.columns["total_rev"].dtype == torch.float64
    assert np.all(np.isfinite(interop.columns(out)["total_rev"]))


def _tenths(ir, out):
    out.emit(ir.copy().set("y", ir.get("x") * 0.1))


def _mean_and_max(g, out):
    out.emit(g.keys().set("m", g.mean("x")).set("hi", g.max("y")))


def test_udfs_compute_in_float64_and_leave_the_default_dtype_alone():
    # the reference runs UDFs under 64-bit JAX; the port gives a UDF float64
    # arithmetic only while it runs.  Values near 1e9 tell float64 from
    # float32 by far more than any rounding of the sums.
    assert torch.get_default_dtype() == torch.float32
    rng = np.random.default_rng(5)
    n = 3000
    d = {"I": {"k": np.sort(rng.integers(0, 40, n)),
               "x": rng.integers(10**9, 2 * 10**9, n)}}
    roots = {}
    for name, pkg in (("torch", TORCH), ("jax", JAX)):
        src = pkg.F.source("I", pkg.Schema.of(k=np.int64, x=np.int64),
                           num_records=n, sorted_on=("k",))
        m = pkg.F.map_(src, _tenths, name="tenths")
        roots[name] = pkg.F.reduce_(m, ["k"], _mean_and_max, name="agg",
                                    hints=pkg.Hints(distinct_keys=40))
    assert str(roots["torch"].out_schema.dtype("m")) == "float64"
    assert str(roots["torch"].out_schema.dtype("hi")) == "float64"
    cp = compile_plan(roots["torch"], use_kernels=True, device="cpu",
                      cache=ExecutableCache())
    got = columns_of(cp.run(bind(TORCH, d)))
    ref = columns_of(joptimize(roots["jax"]).best.compile(
        use_kernels=False, cache=JCache()).run(bind(JAX, d)))
    assert_same_rows(got, ref, atol=0)
    assert_same_rows(columns_of(TE.execute(roots["torch"], bind(TORCH, d))),
                     ref, atol=0)
    assert torch.get_default_dtype() == torch.float32
