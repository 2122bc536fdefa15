"""At small sizes on the CPU each plain reference gives the program's own
answer, and the comparison finds what it is built to find."""

import pytest
import torch

from portbench import harness, judge, program, spec
from portbench.tests.util import SMALL

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", sorted(SMALL))
def test_reference_gives_the_programs_answer(name):
    cell = spec.cell(name)
    rows, query = SMALL[name], cell.query()
    padded, tables = harness.make_tables(query, rows, 11, CPU)
    plan, _ = program.plan(cell.flow().build(rows), CPU)
    got = program.answer(plan.run_device(program.bind(padded, rows)))
    want = query.reference(tables)
    numbers = judge.compare(got, want, query.KEYS)
    assert want[query.KEYS[0]].numel() > 0
    assert judge.passes(numbers, cell.traffic["limits"]), numbers


def _answer():
    return {"k": torch.tensor([3, 1, 2]), "v": torch.tensor([30, 10, 20]),
            "x": torch.tensor([0.5, 100.0, 2.0], dtype=torch.float64)}


def test_compare_matches_rows_by_key():
    a = _answer()
    b = {c: t[[1, 2, 0]] for c, t in a.items()}
    assert judge.compare(a, b, ("k",)) == {
        "columns_off": 0, "rows_off": 0, "int_off": 0, "rel_err": 0.0}


def test_compare_counts_what_differs():
    a, b = _answer(), _answer()
    b["v"] = torch.tensor([30, 10, 21])
    b["x"] = torch.tensor([0.5, 100.0 * (1 + 1e-6), 2.0], dtype=torch.float64)
    got = judge.compare(a, b, ("k",))
    assert got["int_off"] == 1 and abs(got["rel_err"] - 1e-6) < 1e-9
    short = {c: t[:2] for c, t in a.items()}
    assert judge.compare(short, a, ("k",))["rows_off"] == 1
    assert judge.compare({**a, "y": a["v"]}, a, ("k",))["columns_off"] == 1
    worst = judge.worst([got, judge.compare(short, a, ("k",))])
    assert worst["rows_off"] == 1 and worst["int_off"] is None
    assert not judge.passes(worst, {"columns_off": 0, "rows_off": 0,
                                    "int_off": 0, "rel_err": 1e-3})
