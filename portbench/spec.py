"""Finds a cell's files by the names in BENCHMARK.json, so that a later
change adds a configuration, a traffic mix, a query or a per-layer metric
by adding files:

    portbench/configs/<config>.json     sizes, source, cuts, guarantees
    portbench/traffic/<traffic>.json    the mix: query, loop, limits
    portbench/queries/<query>.py        generator, plain reference, work
    portbench/flows/<query>.py          the query's flow (program API)
    portbench/metrics/<metric>.py       a per-layer reader: read(ctx)
"""

import importlib.util
import json
import pathlib
import re
from dataclasses import dataclass, field

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = pathlib.Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list          # names of the cell's end-to-end metrics
    per_layer: list           # names of the cell's per-layer metrics
    units: dict = field(default_factory=dict)   # metric -> unit
    home: pathlib.Path = HERE

    def rows(self) -> dict:
        return dict(self.config["tables"])

    def query(self):
        return load(self.home / "queries" / f"{self.traffic['query']}.py")

    def flow(self):
        return load(self.home / "flows" / f"{self.traffic['query']}.py")

    def reader(self, metric: str):
        return load(self.home / "metrics" / f"{metric}.py")


def load(path: pathlib.Path):
    """The module in `path`, loaded under a name made from its path."""
    name = "portbench_" + re.sub(r"\W", "_", str(path.relative_to(
        path.parents[1])))
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict = None, home: pathlib.Path = HERE) -> Cell:
    """The cell `name` of `bench` (BENCHMARK.json at the checkout's root by
    default), with its configuration and traffic files read from `home`."""
    if bench is None:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in the benchmark")
    w = found[0]
    config = json.loads((home / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((home / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    metrics = bench["end_to_end"] + bench["per_layer"]
    e2e = [m["name"] for m in bench["end_to_end"] if _applies(m, name)]
    # a per-layer metric without `workloads` is read in every cell that
    # reports the end-to-end metric it moves
    per_layer = [m["name"] for m in bench["per_layer"]
                 if _applies(m, name) and ("workloads" in m
                                           or m["moves"] in e2e)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=per_layer,
                units={m["name"]: m["unit"] for m in metrics}, home=home)
