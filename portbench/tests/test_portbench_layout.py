"""The harness finds a configuration, a traffic mix, a query and a
per-layer metric dropped into its folders by their names alone, and its
command refuses to run without a card."""

import json
import pathlib
import shutil
import subprocess
import sys

import torch

from portbench import harness, spec
from portbench.readers import Context

HOME = pathlib.Path(__file__).resolve().parents[1]
ROOT = HOME.parent


def test_dropped_files_are_found_by_name(tmp_path):
    home = tmp_path / "portbench"
    for d in ("configs", "traffic", "queries", "flows", "metrics"):
        shutil.copytree(HOME / d, home / d)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    # a new configuration, traffic mix and per-layer metric, as files
    (home / "configs" / "tpch-tiny.json").write_text(json.dumps(
        {"tables": {"lineitem": 6000, "orders": 1500, "customer": 150,
                    "supplier": 10}}))
    traffic = json.loads((home / "traffic" / "q15.json").read_text())
    traffic["warmup_queries"] = 1
    (home / "traffic" / "q15-short.json").write_text(json.dumps(traffic))
    (home / "metrics" / "answers_per_s.py").write_text(
        "def read(ctx):\n    return ctx.queries / ctx.window_s\n")
    bench["workloads"].append({"name": "tpch-tiny.q15", "config": "tpch-tiny",
                               "traffic": "q15-short", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "answers_per_s", "unit": "1/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "whole query", "moves": "rows_per_s",
                               "workloads": ["tpch-tiny.q15"]})
    cell = spec.cell("tpch-tiny.q15", bench=bench, home=home)
    assert cell.rows()["lineitem"] == 6000
    assert cell.traffic["warmup_queries"] == 1
    assert "answers_per_s" in cell.per_layer
    assert "roofline.span_compact" not in cell.per_layer
    ctx = Context(plan_s=0.1, dispatch_s=[0.001], queries=10, window_s=2.0,
                  least_s=0.001)
    assert cell.reader("answers_per_s").read(ctx) == 5.0
    r = harness.run(cell, 9, 0.05, True, device=torch.device("cpu"))
    assert r["correct"] and "answers_per_s" in r["metrics"]


def test_every_named_file_exists():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.cell(w["name"], bench=bench)
        cell.query(), cell.flow()
        for m in cell.per_layer:
            assert callable(cell.reader(m).read)
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        return  # the run would measure: nothing to check here
    r = subprocess.run([sys.executable, str(HOME / "run.py"), "--workload",
                        "tpch-sf30.q15", "--seed", "3000000001",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"metrics"' not in r.stdout and r.stdout.strip() == ""
