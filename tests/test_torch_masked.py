"""The port's masked executors against the reference's, operator by
operator and flow by flow, with order elision on and off.

Inputs carry validity gaps and, under `use_order`, a declared sort order
that the valid rows honour — the case the elided paths (forward fills, no
re-sort) exist for.  Both packages run on identical numpy data; results
must agree row for row (integers exactly, floats within 1e-5), and the
static order metadata of each output must be the same.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_sca import (JAX, PAPER_FLOWS, TORCH, assert_same_rows, bind,
                            columns_of, corpus_flow)

from repro.core import masked as JM
from repro_torch.core import masked as TM

N = 64


def _ops(pkg):
    """One operator of each executor kind over sources L(k, x), R(rk, y)."""
    F, S, H = pkg.F, pkg.Schema, pkg.Hints
    L = F.source("L", S.of(k=np.int64, x=np.float64, c=np.int64),
                 num_records=N, sorted_on=("k",))
    R = F.source("R", S.of(rk=np.int64, y=np.int64), num_records=N // 4,
                 sorted_on=("rk",))

    def keep(ir, out):
        out.emit(ir.copy().set("c", ir.get("c") * 2 + 1),
                 where=ir.get("x") > 0.3)

    def agg(g, out):
        out.emit(g.keys().set("s", g.sum("x")).set("m", g.max("c"))
                 .set("n", g.count()))

    def keep_groups(g, out):
        out.emit_records(where=g.any(g.get("c") > 5))

    def cg(gl, gr, out):
        out.emit(gl.keys().set("t", gl.sum("c") + gr.sum("y"))
                 .set("d", gl.count() - gr.count()))

    return {
        "map": F.map_(L, keep, name="keep"),
        "reduce": F.reduce_(L, ["k"], agg, name="agg",
                            hints=H(distinct_keys=8)),
        "reduce_passthrough": F.reduce_(L, ["k"], keep_groups, name="kg",
                                        hints=H(distinct_keys=8)),
        "match_pk": F.match(L, R, ["k"], ["rk"], name="pk",
                            hints=H(pk_side="right")),
        "match_anti": F.match(L, R, ["k"], ["rk"], anti=True, name="anti"),
        "limit": F.limit_(L, k=7, key=["k", "c"], name="lim"),
        "cross": F.cross(F.limit_(L, k=3, key=["k"], name="l3"), R,
                         name="x"),
        "cogroup": F.cogroup(L, R, ["k"], ["rk"], cg, name="cg"),
    }


def _data(seed: int):
    rng = np.random.default_rng(seed)
    L = {"k": np.sort(rng.integers(0, 12, N)),
         "x": rng.uniform(0, 1, N).round(3),
         "c": rng.integers(-4, 9, N)}
    nr = N // 4
    R = {"rk": np.sort(rng.choice(16, nr, replace=False)).astype(np.int64),
         "y": rng.integers(0, 50, nr)}
    lvalid = rng.random(N) < 0.75
    rvalid = rng.random(nr) < 0.8
    return {"L": (L, lvalid), "R": (R, rvalid)}


def _masked(pkg_masked, to_array, data, use_order):
    out = {}
    for name, (cols, valid) in data.items():
        order = (next(iter(cols)),) if use_order else ()
        out[name] = pkg_masked.MaskedBatch(
            {f: to_array(v) for f, v in cols.items()}, to_array(valid), order)
    return out


def _run(pkg, M, to_array, node, data, use_order, use_kernels=False):
    b = _masked(M, to_array, data, use_order)
    kind = type(node).__name__
    if kind == "MapOp":
        return M._exec_map(node, b["L"])
    if kind == "ReduceOp":
        return M._exec_reduce(node, b["L"], use_kernels, use_order)
    if kind == "LimitOp":
        return M._exec_limit(node, b["L"], use_order)
    if kind == "MatchOp" and node.anti:
        return M._exec_match_anti(node, b["L"], b["R"], use_kernels, use_order)
    if kind == "MatchOp":
        return M._exec_match_pk(node, b["L"], b["R"], use_kernels, use_order)
    if kind == "CoGroupOp":
        return M._exec_cogroup(node, b["L"], b["R"], use_kernels, use_order)
    # cross over a limited left side
    left = M._exec_limit(node.left, b["L"], use_order)
    return M._exec_cross(node, left, b["R"])


KINDS = ("map", "reduce", "reduce_passthrough", "match_pk", "match_anti",
         "limit", "cross", "cogroup")


@pytest.mark.parametrize("use_order", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_executor_matches_reference(kind, use_order):
    tnode, jnode = _ops(TORCH)[kind], _ops(JAX)[kind]
    for seed in range(2):
        data = _data(seed)
        ref = _run(JAX, JM, jnp.asarray, jnode, data, use_order)
        for use_kernels in (False, True):
            got = _run(TORCH, TM, lambda a: torch.from_numpy(np.array(a)),
                       tnode, data, use_order, use_kernels)
            assert got.order == ref.order
            assert got.capacity == ref.capacity
            assert_same_rows(columns_of(got.to_record_batch()),
                             columns_of(ref.to_record_batch()))


@pytest.mark.parametrize("seed", range(8))
def test_corpus_masked_matches_reference(seed):
    troot, data = corpus_flow(TORCH, seed)
    jroot, _ = corpus_flow(JAX, seed)
    d = data(seed + 7)
    for use_order in (True, False):
        ref = JM.run_flow_jit(jroot, bind(JAX, d), use_order=use_order)
        for use_kernels in (False, True):
            got = TM.run_flow_masked(troot, bind(TORCH, d),
                                     use_kernels=use_kernels,
                                     use_order=use_order, device="cpu")
            assert_same_rows(columns_of(got), columns_of(ref))


@pytest.mark.parametrize("name", PAPER_FLOWS)
def test_paper_flow_masked_matches_reference(name):
    troot, _ = TORCH.flows.FLOWS[name]()
    jroot, make = JAX.flows.FLOWS[name]()
    d = {s: b.columns for s, b in make(2000, seed=9).items()}
    for use_order in (True, False):
        ref = JM.run_flow_jit(jroot, bind(JAX, d), use_order=use_order)
        got = TM.run_flow_masked(troot, bind(TORCH, d), use_kernels=True,
                                 use_order=use_order, device="cpu")
        assert_same_rows(columns_of(got), columns_of(ref))


def test_compact_keeps_order_and_rows():
    rng = np.random.default_rng(0)
    k = np.sort(rng.integers(0, 9, 40))
    valid = rng.random(40) < 0.5
    b = TM.MaskedBatch({"k": torch.from_numpy(k)}, torch.from_numpy(valid),
                       ("k",))
    jb = JM.MaskedBatch({"k": jnp.asarray(k)}, jnp.asarray(valid), ("k",))
    for cap in (8, 16, 40):
        c, jc = b.compact(cap), jb.compact(cap)
        assert c.order == ("k",)
        np.testing.assert_array_equal(c.valid.numpy(), np.asarray(jc.valid))
        np.testing.assert_array_equal(c.columns["k"].numpy()[c.valid.numpy()],
                                      np.asarray(jc.columns["k"])[
                                          np.asarray(jc.valid)])


def test_bucket_capacity_matches_reference():
    for x in (0, 1, 7, 8, 9, 100, 1000, 123457):
        assert TM.bucket_capacity(x) == JM.bucket_capacity(x)
