"""The port's UDF analysis against the reference's, plus the shared harness
of the `test_torch_*` files.

`corpus_flow(pkg, seed)` builds one seeded random flow (Map modify / filter
/ add, decomposable and passthrough Reduces, PK and general Matches, anti
joins, Limits, Cross, CoGroup) in EITHER package from the same seed: the
generator is handed the package's `flow`/`Hints`/`Schema` API, and its UDFs
use only the record API and operators, so the very same closures run on jax
tracers, numpy-backed views and torch tensors.  Operator names are fixed by
the generator, so plans of the two packages compare by `canonical()`.
`corpus_data(seed)` gives numpy columns for that flow's sources; both
packages bind identical copies.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
import types

import numpy as np
import pytest

from repro.configs import flows as JFLOWS
from repro.core import flow as JF
from repro.core.operators import Hints as JHints
from repro.core.record import RecordBatch as JRecordBatch
from repro.core.record import Schema as JSchema
from repro_torch.configs import flows as TFLOWS
from repro_torch.core import flow as TF
from repro_torch.core.operators import Hints as THints
from repro_torch.core.record import RecordBatch as TRecordBatch
from repro_torch.core.record import Schema as TSchema

JAX = types.SimpleNamespace(F=JF, Hints=JHints, Schema=JSchema,
                            RecordBatch=JRecordBatch, flows=JFLOWS)
TORCH = types.SimpleNamespace(F=TF, Hints=THints, Schema=TSchema,
                              RecordBatch=TRecordBatch, flows=TFLOWS)

KEY_DOMAIN = 6
PAPER_FLOWS = ("q7", "q15", "clickstream", "textmining")


# ---------------------------------------------------------------------------
# Seeded corpus, buildable in either package
# ---------------------------------------------------------------------------
class _Corpus:
    def __init__(self, pkg, seed: int, max_ops: int = 5):
        self.pkg = pkg
        self.rng = np.random.default_rng(seed)
        self.max_ops = max_ops
        self.fresh = 0
        self.sources: list = []  # (name, fields, unique_key, rows)

    def _name(self, prefix: str) -> str:
        self.fresh += 1
        return f"{prefix}{self.fresh}"

    def _source(self, n_fields: int, rows: int, unique_key: bool):
        name = self._name("S")
        fields = [self._name("k")] + [self._name("f")
                                      for _ in range(n_fields - 1)]
        self.sources.append((name, fields, unique_key, rows))
        schema = self.pkg.Schema.of(**{f: np.int64 for f in fields})
        return self.pkg.F.source(name, schema, num_records=rows * 25)

    def _pick(self, live, lo=1, hi=3):
        k = min(len(live), int(self.rng.integers(lo, hi)))
        return [live[i] for i in self.rng.choice(len(live), size=k,
                                                 replace=False)]

    def _map(self, schema):
        live = list(schema.fields)
        kind = self.rng.random()
        reads = self._pick(live)
        if kind < 0.4:
            target = live[self.rng.integers(len(live))]
            mult, off = int(self.rng.integers(1, 4)), int(self.rng.integers(-3, 4))

            def udf(ir, out):
                val = ir.get(reads[0]) * 0
                for r in reads:
                    val = val + ir.get(r)
                out.emit(ir.copy().set(target, val * mult + off))
        elif kind < 0.75:
            mod = int(self.rng.integers(2, 4))
            keep = int(self.rng.integers(0, mod))

            def udf(ir, out):
                val = ir.get(reads[0]) * 0
                for r in reads:
                    val = val + ir.get(r)
                out.emit(ir.copy(), where=(val % mod) == keep)
        else:
            new = self._name("g")

            def udf(ir, out):
                val = ir.get(reads[0]) * 0
                for r in reads:
                    val = val + ir.get(r)
                out.emit(ir.copy().set(new, val * 2 + 1))
        return udf

    def _reduce(self, schema):
        live = list(schema.fields)
        a = live[self.rng.integers(len(live))]
        b = live[self.rng.integers(len(live))]
        o1, o2, o3 = self._name("a"), self._name("a"), self._name("a")
        kind = int(self.rng.integers(0, 4))
        if kind == 0:
            def udf(g, out):
                out.emit(g.keys().set(o1, g.sum(a)).set(o2, g.max(b))
                         .set(o3, g.count()))
        elif kind == 1:
            def udf(g, out):
                out.emit(g.keys().set(o1, g.sum(g.get(a) * 2 + g.get(b)))
                         .set(o2, g.min(b)))
        elif kind == 2:
            def udf(g, out):
                out.emit(g.keys().set(o1, g.max(a) - g.min(a))
                         .set(o2, g.mean(b)))
        else:
            thr = int(self.rng.integers(-2, 3))

            def udf(g, out):
                out.emit_records(where=g.any(g.get(a) > thr))
        return udf

    def _cogroup(self, lschema, rschema):
        a = list(lschema.fields)[self.rng.integers(len(lschema.fields))]
        b = list(rschema.fields)[self.rng.integers(len(rschema.fields))]
        o1, o2 = self._name("a"), self._name("a")

        def udf(gl, gr, out):
            out.emit(gl.keys().set(o1, gl.sum(a) + gr.sum(b))
                     .set(o2, gl.count() - gr.count()))
        return udf

    def build(self):
        F, Hints = self.pkg.F, self.pkg.Hints
        node = self._source(int(self.rng.integers(2, 4)),
                            rows=int(self.rng.integers(24, 40)),
                            unique_key=False)
        for _ in range(int(self.rng.integers(2, self.max_ops + 1))):
            schema = node.out_schema
            choice = self.rng.random()
            if choice < 0.42:
                node = F.map_(node, self._map(schema), name=self._name("m"))
            elif choice < 0.50:
                key = self._pick(list(schema.fields))
                node = F.limit_(node, k=int(self.rng.integers(2, 12)),
                                key=key, name=self._name("lim"))
            elif choice < 0.66:
                key = [schema.fields[self.rng.integers(len(schema.fields))]]
                node = F.reduce_(node, key, self._reduce(schema),
                                 name=self._name("r"),
                                 hints=Hints(distinct_keys=KEY_DOMAIN))
            elif choice < 0.80:
                right = self._source(2, rows=KEY_DOMAIN, unique_key=True)
                lk = schema.fields[self.rng.integers(len(schema.fields))]
                hints = Hints(pk_side="right") if self.rng.random() < 0.7 \
                    else Hints()
                node = F.match(node, right, [lk], [right.out_schema.fields[0]],
                               name=self._name("j"), hints=hints)
            elif choice < 0.88:
                right = self._source(
                    2, rows=int(self.rng.integers(2, KEY_DOMAIN + 2)),
                    unique_key=self.rng.random() < 0.5)
                lk = schema.fields[self.rng.integers(len(schema.fields))]
                node = F.match(node, right, [lk], [right.out_schema.fields[0]],
                               anti=True, name=self._name("anti"))
            elif choice < 0.94:
                right = self._source(2, rows=1, unique_key=False)
                node = F.cross(node, right, name=self._name("x"))
            else:
                right = self._source(2, rows=int(self.rng.integers(8, 16)),
                                     unique_key=False)
                node = F.cogroup(node, right, [schema.fields[0]],
                                 [right.out_schema.fields[0]],
                                 self._cogroup(schema, right.out_schema),
                                 name=self._name("cg"))
        return node

    def data(self, seed: int) -> dict:
        rng = np.random.default_rng(seed)
        out = {}
        for name, fields, unique_key, rows in self.sources:
            cols = {}
            for i, f in enumerate(fields):
                if i == 0 and unique_key:
                    cols[f] = np.arange(KEY_DOMAIN, dtype=np.int64)
                elif i == 0:
                    cols[f] = rng.integers(0, KEY_DOMAIN, rows)
                else:
                    cols[f] = rng.integers(-5, 9, KEY_DOMAIN if unique_key
                                           else rows)
            out[name] = cols
        return out


def corpus_flow(pkg, seed: int, max_ops: int = 5):
    """(root, data(seed) -> {source: {field: ndarray}}) built in `pkg`."""
    g = _Corpus(pkg, seed, max_ops)
    return g.build(), g.data


def bind(pkg, data: dict) -> dict:
    """Identical copies of numpy columns as `pkg` bindings."""
    return {s: pkg.RecordBatch({f: np.array(v, copy=True)
                                for f, v in cols.items()})
            for s, cols in data.items()}


# ---------------------------------------------------------------------------
# Comparison helpers
# ---------------------------------------------------------------------------
def props_of(p) -> dict:
    """UdfProperties as plain values (enums by value, recipe as tuples);
    `source` names the analyzer and is left out."""
    out = {}
    for f in dataclasses.fields(p):
        v = getattr(p, f.name)
        if f.name == "source":
            continue
        if f.name == "combine" and v is not None:
            v = (v.sites, v.columns)
        out[f.name] = getattr(v, "value", v)
    return out


def schema_of(s) -> tuple:
    return tuple(s.fields), {f: str(s.dtype(f)) for f in s.fields}


def assert_same_rows(got: dict, ref: dict, atol: float = 1e-5) -> None:
    """Equal row multisets: integer and bool columns exactly, float columns
    within `atol` (`RecordBatch.equivalent`'s tolerance)."""
    assert set(got) == set(ref), (sorted(got), sorted(ref))
    fields = sorted(ref, key=lambda f: (np.asarray(ref[f]).dtype.kind == "f", f))
    n = {len(np.asarray(v)) for v in ref.values()} | \
        {len(np.asarray(v)) for v in got.values()}
    assert len(n) <= 1, n
    if not fields or n == {0}:
        return

    def rows(cols):
        m = np.stack([np.asarray(cols[f], dtype=np.float64) for f in fields], 1)
        return np.lexsort(m.T[::-1])

    og, orf = rows(got), rows(ref)
    for f in fields:
        a, b = np.asarray(got[f])[og], np.asarray(ref[f])[orf]
        if b.dtype.kind == "f" or a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


def columns_of(batch) -> dict:
    b = batch.to_numpy().compact()
    return {f: np.asarray(v) for f, v in b.columns.items()}


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------
def test_port_imports_no_jax():
    # ... and leaves torch's default dtype as it found it
    code = ("import sys, torch; import repro_torch, repro_torch.interop, "
            "repro_torch.configs.flows, repro_torch.core.pipeline, "
            "repro_torch.kernels.ops, repro_torch.kernels.megakernel, "
            "repro_torch.models.model, "
            "repro_torch.serve.engine, repro_torch.serve.dataflow, "
            "repro_torch.launch.serve; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); "
            "assert torch.get_default_dtype() == torch.float32; "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("name", PAPER_FLOWS)
def test_flow_udf_properties_match_reference(name):
    troot, _ = TFLOWS.FLOWS[name]()
    jroot, _ = JFLOWS.FLOWS[name]()
    tn = {n.name: n for n in troot.iter_nodes()}
    jn = {n.name: n for n in jroot.iter_nodes()}
    assert set(tn) == set(jn)
    for k, j in jn.items():
        assert schema_of(tn[k].out_schema) == schema_of(j.out_schema), k
        if hasattr(j, "props"):
            assert props_of(tn[k].props) == props_of(j.props), k
            assert (tn[k].props.source == "trace-sca") == \
                (j.props.source == "jaxpr-sca"), k


@pytest.mark.parametrize("seed", range(12))
def test_corpus_udf_properties_match_reference(seed):
    troot, _ = corpus_flow(TORCH, seed)
    jroot, _ = corpus_flow(JAX, seed)
    assert troot.canonical() == jroot.canonical()
    tn = {n.name: n for n in troot.iter_nodes()}
    for j in jroot.iter_nodes():
        assert schema_of(tn[j.name].out_schema) == schema_of(j.out_schema)
        if hasattr(j, "props"):
            assert props_of(tn[j.name].props) == props_of(j.props), j.name


def _branchy(ir, out):
    # Python control flow on data: untraceable, so both packages fall back
    # to the bytecode analyzer
    if ir.get("a").sum() > 0:
        out.emit(ir.copy().set("b", ir.get("a") + 1))
    else:
        out.emit(ir.copy())


def test_untraceable_udf_falls_back_to_bytecode_in_both():
    props = []
    for pkg in (TORCH, JAX):
        src = pkg.F.source("I", pkg.Schema.of(a=np.int64, b=np.int64))
        op = pkg.F.map_(src, _branchy, name="branchy")
        assert op.props.source == "bytecode-sca"
        props.append(props_of(op.props))
    assert props[0] == props[1]
