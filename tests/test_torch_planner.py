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
