"""The port's planner and eager reference executor against the reference's:
the same flows optimize to `canonical()`-identical best plans at equal cost,
and the eager executors agree row for row on identical inputs."""

from __future__ import annotations

import numpy as np
import pytest

from test_torch_sca import (JAX, PAPER_FLOWS, TORCH, assert_same_rows, bind,
                            columns_of, corpus_flow)

from repro.core import executor as JE
from repro.core.optimizer import optimize as joptimize
from repro_torch import hw, interop
from repro_torch.core import executor as TE
from repro_torch.core.optimizer import optimize as toptimize
from repro_torch.core.physical import Ctx

SYNTHETIC = {"map_chain": 4, "star_join": 4, "chain_join": 4}


def _build(pkg, name):
    if name in SYNTHETIC:
        return getattr(pkg.flows, name)(SYNTHETIC[name])
    return pkg.flows.FLOWS[name]()[0]


@pytest.mark.parametrize("name", PAPER_FLOWS + tuple(SYNTHETIC))
def test_best_plan_matches_reference(name):
    t = toptimize(_build(TORCH, name))
    j = joptimize(_build(JAX, name))
    assert t.best.flow.canonical() == j.best.flow.canonical()
    assert t.best.cost == pytest.approx(j.best.cost, rel=1e-12)
    assert [p.flow.canonical() for p in t.ranked] == \
        [p.flow.canonical() for p in j.ranked]


@pytest.mark.parametrize("name", PAPER_FLOWS)
def test_h100_spec_prices_every_flow(name):
    # plans under the H100 spec may differ from the TPU-priced ones (they
    # are recorded in ROADMAP.md); they must still be valid and priced
    res = toptimize(_build(TORCH, name), Ctx(chip=hw.H100_SXM))
    assert res.best.cost > 0
    assert res.best.flow.attrs() == _build(TORCH, name).attrs()


@pytest.mark.parametrize("seed", range(10))
def test_corpus_eager_matches_reference(seed):
    troot, data = corpus_flow(TORCH, seed)
    jroot, _ = corpus_flow(JAX, seed)
    d = data(seed + 100)
    got = TE.execute(troot, bind(TORCH, d))
    ref = JE.execute(jroot, bind(JAX, d))
    assert_same_rows(columns_of(got), columns_of(ref))


@pytest.mark.parametrize("name", PAPER_FLOWS)
def test_paper_flow_eager_matches_reference(name):
    troot, _ = TORCH.flows.FLOWS[name]()
    jroot, make = JAX.flows.FLOWS[name]()
    d = {s: b.columns for s, b in make(3000, seed=5).items()}
    got = TE.execute(troot, interop.bindings(d))
    ref = JE.execute(jroot, bind(JAX, d))
    assert_same_rows(interop.columns(got), columns_of(ref))


def test_joint_codes_match_reference():
    rng = np.random.default_rng(0)
    groups = [[rng.integers(0, 5, 40), rng.integers(-3, 3, 40)],
              [rng.integers(0, 5, 25), rng.integers(-3, 3, 25)]]
    (tc, tn) = TE.joint_codes(groups)
    (jc, jn) = JE.joint_codes(groups)
    assert tn == jn
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(a, b)


def test_interop_round_trip():
    d = {"S": {"a": np.arange(5, dtype=np.int64),
               "b": np.linspace(0.0, 1.0, 5)}}
    b = interop.bindings(d)
    d["S"]["a"][0] = 99  # bound copies do not alias the caller's arrays
    out = interop.columns(b["S"])
    np.testing.assert_array_equal(out["a"], np.arange(5))
    np.testing.assert_array_equal(out["b"], np.linspace(0.0, 1.0, 5))


# ---------------------------------------------------------------------------
# Long unary flows: the group search keeps the attribute set
# ---------------------------------------------------------------------------
def _first_b(g, out):
    out.emit(g.keys().set("fB", g.first_of("B")))


def _add_x(i):
    def udf(ir, out):
        a = ir.get("A")
        out.emit(ir.copy().set(f"X{i}", a * 2), where=a % 3 == 0)
    return udf


def _projecting_reduce_under_maps(pkg):
    """Source I(A, B, C, D) -> a Reduce on A that projects to (A, fB) with
    the non-decomposable `first_of` -> six Maps each adding X<i>: 7
    operators, so `optimize` takes the group search, and no splittable
    Reduce sends it to the closure instead."""
    node = pkg.F.source("I", pkg.Schema.of(A=np.int64, B=np.int64,
                                           C=np.int64, D=np.int64),
                        num_records=600)
    node = pkg.F.reduce_(node, ["A"], _first_b, name="red",
                         hints=pkg.Hints(distinct_keys=20))
    for i in range(6):
        node = pkg.F.map_(node, _add_x(i), name=f"add_X{i}")
    return node


def test_group_search_keeps_the_attribute_set():
    from repro_torch.core.enumeration import (enum_alternatives_alg1,
                                              enumerate_plans)

    troot = _projecting_reduce_under_maps(TORCH)
    jroot = _projecting_reduce_under_maps(JAX)
    rng = np.random.default_rng(7)
    d = {"I": {f: rng.integers(0, 20, 600) for f in "ABCD"}}
    res = toptimize(troot)
    closure = enumerate_plans(troot, split_reduces=False)
    assert res.num_plans == len(closure) == 720
    assert len(enum_alternatives_alg1(troot)) == 720
    eager = columns_of(TE.execute(troot, bind(TORCH, d)))
    assert set(eager) == {"A", "fB"} | {f"X{i}" for i in range(6)}
    assert_same_rows(columns_of(TE.execute(res.best.flow, bind(TORCH, d))),
                     eager, atol=0)
    # the reference's closure search (prune=False) picks the same plan;
    # its group search (prune=True) still takes the faulty path, so the
    # two packages differ there on purpose
    ref = joptimize(jroot, prune=False)
    assert res.best.flow.canonical() == ref.best.flow.canonical()
