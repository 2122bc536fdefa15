"""`correct` comes out false for the control and for each fault a cell can
have; the sound run comes out true.  The runs skip the harness's look for
a card and drive the rest of a run on the CPU at small sizes."""

import contextlib

import pytest
import torch

from portbench import harness, judge, spec
from portbench.tests.util import SMALL

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_is_not_correct(name):
    cell = spec.cell(name)
    query = cell.query()
    limits = cell.traffic["limits"]
    for seed in (1, 2, 3):
        _, tables = harness.make_tables(query, SMALL[name], seed, CPU)
        want = query.reference(tables)
        assert judge.passes(judge.compare(query.reference(tables), want,
                                          query.KEYS), limits)
        numbers = judge.compare(query.control(tables), want, query.KEYS)
        assert not judge.passes(numbers, limits), numbers


@contextlib.contextmanager
def broken(kind: str, fact: str):
    """`CompiledPlan.run_device` broken underneath the timed path: it returns
    its fact table unchanged ("unchanged"), runs with the second half of
    the fact table's rows left out ("half"), or alters one value of its
    answer where it is produced ("altered")."""
    from repro_torch.core.pipeline import CompiledPlan

    real = CompiledPlan.run_device

    def run_device(self, masked):
        if kind == "unchanged":
            return masked[fact]
        if kind == "half":
            b = masked[fact]
            valid = b.valid.clone()
            valid[int(valid.sum()) // 2:] = False
            return real(self, {**masked, fact: type(b)(b.columns, valid,
                                                        b.order)})
        out = real(self, masked)
        cols = dict(out.columns)
        name = sorted(cols)[-1]
        cols[name] = cols[name].clone()
        cols[name][int(torch.nonzero(out.valid)[0])] += 1
        return type(out)(cols, out.valid, out.order)

    CompiledPlan.run_device = run_device
    try:
        yield
    finally:
        CompiledPlan.run_device = real


def _run(name, seed=5, traced=False):
    return harness.run(spec.cell(name), seed, 0.05, traced, device="cpu",
                       rows=SMALL[name])


@pytest.mark.parametrize("name", sorted(SMALL))
def test_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == set(spec.cell(name).end_to_end)


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_broken_timed_path_is_not_correct(name, kind):
    fact = spec.cell(name).query().FACT
    with broken(kind, fact):
        r = _run(name)
    assert not r["correct"] and r["failed"] > 0, r["checks"]


@pytest.mark.parametrize("name, host", [
    ("tpch-sf30.q15", {"plan_ms", "dispatch_ms", "step_mfu"}),
    ("tpch-sf10.q15", {"plan_ms", "step_mfu.sf10"})])
def test_traced_run_reads_the_cells_per_layer_metrics_it_can(name, host):
    r = _run(name, traced=True)
    assert r["correct"]
    # the CPU has no device trace: the readers of the trace return nothing
    assert set(r["metrics"]) == host
    assert r["device"]["busy_s"] == 0.0 and "breakdown" in r
