"""The dry-run's inputs, layouts, probes and tables
(`repro_torch.configs.input_specs`, `launch.dryrun`, `launch.roofline`,
`launch.report`) against the reference's on the same inputs.

The reference's `launch/dryrun.py` forces 512 host devices when it is
imported, so its layouts and probe arithmetic come from a subprocess
(REF_SCRIPT) that sets XLA_FLAGS before JAX starts; this process never
imports it.  The port's layouts are computed on `{axis: size}` mappings,
with no process group.  The reference stacks a decode state's layers on a
leading axis and the port keeps a list of per-layer states (each "pos" a
Python int), so a stacked leaf is compared per layer with its stack dim
dropped.  Every comparison is exact.
"""

from __future__ import annotations

import json
import math
import sys
import textwrap

import jax
import pytest
import torch

from repro import hw as JH
from repro.configs import get_config as jget
from repro.configs import input_specs as jinput_specs
from repro.launch import report as JR
from repro.launch import roofline as JRL
from repro_torch import hw
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, input_specs
from repro_torch.launch import dryrun as D
from repro_torch.launch import report as R
from repro_torch.launch import roofline as RL
from repro_torch.parallel import sharding as S
from test_torch_sharding import SRC, run_procs

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
# the m1 / m2 counts `_extrapolate` is held to the reference on
EXTRAPOLATE_CASES = [
    ({"flops": 10.0, "hbm": 4.0, "coll": {"all-gather": 6.0}},
     {"flops": 18.0, "hbm": 7.0, "coll": {"all-gather": 9.0,
                                           "all-reduce": 2.0}}, 2, 4, 28),
    ({"flops": 1.5e15, "hbm": 3.25e12, "coll": {}},
     {"flops": 2.75e15, "hbm": 5.5e12, "coll": {"reduce-scatter": 1e9}},
     3, 5, 26),
    ({"flops": 9.0, "hbm": 9.0, "coll": {"all-to-all": 9.0}},
     {"flops": 5.0, "hbm": 1.0, "coll": {"all-to-all": 1.0}}, 2, 4, 40),
]

REF_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, %r)
    import jax
    from repro.configs import ARCH_IDS, SHAPES, get_config, input_specs
    from repro.launch import dryrun as D
    from repro.launch.mesh import make_production_mesh

    def keys(kp):
        return [getattr(k, "key", getattr(k, "idx", None)) for k in kp]

    def spec(s):
        return [list(e) if isinstance(e, tuple) else e for e in s.spec]

    cases = json.loads(sys.argv[1])
    out = {"layouts": {}, "probes": {}, "extrapolate": []}
    for multi, name in ((False, "16x16"), (True, "2x16x16")):
        mesh = make_production_mesh(multi_pod=multi)
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            for shape_name, shape in SHAPES.items():
                specs = input_specs(cfg, shape)
                rec = {}
                for k, tree in specs.items():
                    sh = (D.decode_state_shardings(tree, shape.batch, mesh)
                          if k == "state" else D._batch_sharding(mesh, tree))
                    flat = jax.tree_util.tree_flatten_with_path(sh)[0]
                    rec[k] = [[keys(kp), spec(s)] for kp, s in flat]
                out["layouts"][f"{name}/{arch}/{shape_name}"] = rec
    for arch in ARCH_IDS:
        out["probes"][arch] = D._probe_depths(
            get_config(arch, **D.ROOFLINE_OVERRIDES))
    for m1, m2, l1, l2, full in cases:
        out["extrapolate"].append(D._extrapolate(m1, m2, l1, l2, full))
    print(json.dumps(out))
""") % SRC


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's layouts, probe depths and extrapolations, from a
    process that forces 512 host devices."""
    out, = run_procs([[sys.executable, "-c", REF_SCRIPT,
                       json.dumps(EXTRAPOLATE_CASES)]],
                     str(tmp_path_factory.mktemp("ref_dryrun")),
                     timeout=240)
    return json.loads(out)


# ---------------------------------------------------------------------------
# The reference's stacked decode state, per layer in the port's names
# ---------------------------------------------------------------------------
def _port_paths(cfg, keys) -> list:
    """[(the port's dotted path, whether the reference's leaf is stacked
    on a leading layer axis)] of a reference state leaf at `keys`."""
    if cfg.family == "hybrid":
        width = len(cfg.block_pattern)
        if keys[0] == "super":
            return [(f"{s * width + keys[1]}.{keys[2]}", True)
                    for s in range(cfg.n_layers // width)]
        return [(f"{cfg.n_layers // width * width + keys[1]}.{keys[2]}",
                 False)]
    if cfg.family == "encdec":
        if keys[0] == "enc":
            return [("enc", False)]
        return [(f"self.{i}.{keys[1]}", True) for i in range(cfg.n_layers)]
    return [(f"{i}.{keys[0]}", True) for i in range(cfg.n_layers)]


def _ref_state(cfg, jstate) -> dict:
    """{the port's dotted path: (shape, dtype name)} of the reference's
    state, stacked leaves unstacked."""
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(jstate)[0]:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in kp]
        for path, stacked in _port_paths(cfg, keys):
            shape = tuple(leaf.shape[1:] if stacked else leaf.shape)
            out[path] = (shape, str(leaf.dtype))
    return out


def _leaves(tree) -> dict:
    """{dotted path: leaf} of a tree of dicts and lists."""
    out = {}
    S._map(lambda p, x: out.__setitem__(p, x), tree)
    return out


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch, shape_name):
    """Every input of every cell: the reference's shapes and dtypes, on
    the meta device (no memory)."""
    shape = SHAPES[shape_name]
    got = input_specs(get_config(arch), shape)
    want = jinput_specs(jget(arch), shape)
    assert set(got) == set(want)
    for key in ("batch", "token"):
        if key not in want:
            continue
        g = _leaves(got[key]) if isinstance(got[key], dict) \
            else {"": got[key]}
        w = {k: v for k, v in (_leaves(want[key]).items()
                               if isinstance(want[key], dict)
                               else [("", want[key])])}
        assert set(g) == set(w)
        for k, t in g.items():
            assert t.device.type == "meta"
            assert (tuple(t.shape), _dtype(t)) == (
                tuple(w[k].shape), str(w[k].dtype)), (key, k)
    if "state" in want:
        cfg = jget(arch)
        ref_state = _ref_state(cfg, want["state"])
        port_state = _leaves(got["state"])
        assert set(port_state) == set(ref_state)
        for path, leaf in port_state.items():
            if isinstance(leaf, int):   # a cache's "pos"
                assert leaf == 0 and ref_state[path] == ((), "int32"), path
                continue
            assert leaf.device.type == "meta"
            assert (tuple(leaf.shape), _dtype(leaf)) == ref_state[path], path


def _ref_specs(cfg, rec) -> dict:
    """{the port's path: spec} of the reference's layout of one input,
    stacked leaves' specs without their stack dim."""
    out = {}
    for keys, spec in rec:
        spec = tuple(tuple(e) if isinstance(e, list) else e for e in spec)
        if not keys:
            out[""] = spec
            continue
        if keys == ["tokens"] or keys[0] in ("tokens", "img_embeds",
                                             "audio_frames"):
            out[keys[0]] = spec
            continue
        for path, stacked in _port_paths(cfg, keys):
            out[path] = spec[1:] if stacked else spec
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_layouts_match_reference(ref, arch, mesh):
    """`_batch_sharding` of every batch and token input and
    `decode_state_shardings` of every decode state (decode_32k,
    long_500k) on 16x16 and 2x16x16: the reference's specs as DTensor
    placements, leaf for leaf."""
    sizes = MESHES[mesh]
    cfg = get_config(arch)
    for shape_name, shape in SHAPES.items():
        specs = input_specs(cfg, shape)
        rec = ref["layouts"][f"{mesh}/{arch}/{shape_name}"]
        assert set(rec) == set(specs)
        for key, tree in specs.items():
            want = _ref_specs(cfg, rec[key])
            if key == "state":
                got = D.decode_state_shardings(tree, shape.batch, sizes)
            else:
                got = D._batch_sharding(sizes, tree)
            got = _leaves(got) if isinstance(got, dict | list) \
                else {"": got}
            leaves = _leaves(tree) if isinstance(tree, dict | list) \
                else {"": tree}
            for path, leaf in leaves.items():
                if isinstance(leaf, int):   # "pos": no tensor, no layout
                    assert got[path] is None
                    continue
                spec = want[path] + (None,) * (leaf.ndim - len(want[path]))
                assert got[path].placements == S.placements(spec, sizes), \
                    (shape_name, key, path, spec)


def test_probe_depths_match_reference(ref):
    for arch in ARCH_IDS:
        got = D._probe_depths(get_config(arch, **D.ROOFLINE_OVERRIDES))
        want = ref["probes"][arch]
        assert got == (tuple(want) if want is not None else None), arch


@pytest.mark.parametrize("case", range(len(EXTRAPOLATE_CASES)))
def test_extrapolate_matches_reference(ref, case):
    got = D._extrapolate(*EXTRAPOLATE_CASES[case])
    assert got == ref["extrapolate"][case]


def test_model_flops_match_reference():
    for arch in ARCH_IDS:
        for shape in SHAPES.values():
            for tokens in (shape.batch, shape.batch * shape.seq):
                assert RL.model_flops_for(get_config(arch), shape.kind,
                                          tokens) == \
                    JRL.model_flops_for(jget(arch), shape.kind, tokens)


@pytest.mark.parametrize("counts", [
    dict(flops=2.05e14, hbm=1.8e13, coll={"all-gather": 8.3e11,
                                          "all-reduce": 1.9e11}),
    dict(flops=3.1e9, hbm=7.7e11, coll={}),
    dict(flops=1.0e12, hbm=1.0e9, coll={"reduce-scatter": 5.0e11}),
])
def test_roofline_row_matches_reference(counts):
    """`Roofline.row()` on the same counts, with the reference's chip
    passed to both, equals the reference's; `analyze` builds the same
    row from a counts dict, and the port's default chip is the card's."""
    for chip_args in ({"chip": JH.TPU_V5E}, {}):
        want = JRL.Roofline(
            flops=counts["flops"], hbm_bytes=counts["hbm"],
            coll_bytes=float(sum(counts["coll"].values())),
            coll_by_kind=counts["coll"], model_flops=3.7e15, chips=256,
            **chip_args).row()
        port_chip = hw.TPU_V5E if chip_args else hw.CHIP
        rl = RL.analyze(counts, 3.7e15, 256)
        rl.chip = port_chip
        assert rl.row() == want
    assert RL.Roofline(1.0, 1.0, 0.0, {}, 1.0, 1).chip is hw.H100_SXM
    assert hw.CHIP is hw.TPU_V5E


def _rows():
    """Dry-run rows as `launch.dryrun` writes them: ok, skipped and failed
    single-pod cells, multi-pod rows with a failure a fix file repairs."""
    rl = dict(t_compute_s=0.0207, t_memory_s=0.0536, t_collective_s=0.00242,
              bottleneck="memory", useful_ratio=0.0715,
              roofline_fraction=0.00276)
    single = [
        {"arch": "qwen3-0.6b", "shape": "train_4k", "compile_s": 17.7,
         "roofline": rl, "fit_microbatches": 2,
         "fit_memory": {"peak_bytes": 9 * 2**30}},
        {"arch": "qwen3-0.6b", "shape": "decode_32k", "compile_s": 1.2,
         "roofline": dict(rl, bottleneck="collective"),
         "memory": {"peak_bytes": 2**29}},
        {"arch": "qwen3-0.6b", "shape": "long_500k", "mesh": "-",
         "skipped": "full attention at 500k (DESIGN.md §5)"},
        {"arch": "rwkv6-3b", "shape": "prefill_32k", "error": "boom"},
        {"arch": "rwkv6-3b", "shape": "train_4k", "compile_s": 3.0,
         "roofline": dict(rl, t_compute_s=1.25)},
    ]
    multi = [
        {"arch": "qwen3-0.6b", "shape": "train_4k", "memory": {}},
        {"arch": "qwen3-0.6b", "shape": "decode_32k", "error": "x"},
        {"arch": "rwkv6-3b", "shape": "prefill_32k", "error": "x"},
    ]
    fix = [{"arch": "qwen3-0.6b", "shape": "decode_32k", "memory": {}}]
    recheck = [{"arch": "rwkv6-3b", "shape": "train_4k",
                "fit2_peak_gib": 3.5}]
    return {"dryrun_singlepod.json": single, "dryrun_multipod.json": multi,
            "dryrun_multipod_fix1.json": fix, "fit_recheck.json": recheck}


def _write(root, rows):
    root.mkdir(parents=True, exist_ok=True)
    for name, r in rows.items():
        (root / name).write_text(json.dumps(r))


def test_report_tables_match_reference(tmp_path, monkeypatch):
    """Both tables from the same result files, peaks under 16 GiB (where
    the two packages' flags agree): the reference's text exactly."""
    _write(tmp_path / "results", _rows())
    monkeypatch.setattr(JR, "REPO", str(tmp_path))
    assert R.dryrun_table(str(tmp_path / "results")) == JR.dryrun_table()
    assert R.roofline_table(str(tmp_path / "results")) == \
        JR.roofline_table()
    md = tmp_path / "E.md"
    md.write_text("# x\n<!-- DRYRUN_TABLE -->\nold\n## y\n"
                  "<!-- ROOFLINE_TABLE -->\nold\n")
    R.main([str(tmp_path / "results"), "--md", str(md)])
    text = md.read_text()
    assert JR.dryrun_table() in text and JR.roofline_table() in text
    assert "old" not in text


def test_report_flags_peaks_past_the_cards_memory(tmp_path, monkeypatch):
    """The one deliberate difference: a fit peak is flagged past the
    card's 80 GB, where the reference flags 16 GiB."""
    rows = _rows()
    single = rows["dryrun_singlepod.json"]
    single[0]["fit_memory"]["peak_bytes"] = 20 * 2**30      # v5e: over
    single[1]["memory"]["peak_bytes"] = 90 * 10**9           # both: over
    _write(tmp_path / "results", rows)
    monkeypatch.setattr(JR, "REPO", str(tmp_path))
    got = R.dryrun_table(str(tmp_path / "results")).splitlines()
    want = JR.dryrun_table().splitlines()
    assert "20.00 |" in got[2] and "20.00 ⚠" in want[2]
    assert "83.82 ⚠" in got[3] and "83.82 ⚠" in want[3]
    assert got[:2] + got[4:] == want[:2] + want[4:]
    assert hw.H100_SXM.hbm_capacity == 80 * 1000**3
    assert math.isclose(80 * 1000**3 / 2**30, 74.5058, rel_tol=1e-5)
