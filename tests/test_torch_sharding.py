"""The port's sharding rules and device mesh (`repro_torch.parallel.sharding`,
`repro_torch.launch.mesh`) against the reference's `repro.parallel.sharding`.

Specs are compared as the reference's `PartitionSpec`s, padded with None
to the leaf's dims.  The reference stacks layer leaves on a leading axis
and the port keeps them per layer (named as `interop.model_params` names
them), so a stacked leaf's first dim is dropped before the comparison.
The reference is handed a duck-typed mesh (`axis_names`, `devices.shape`)
and the port a `{axis: size}` mapping, so no 256 devices are needed.
Layouts on real `DeviceMesh`es come from torch's fake process group
(shapes and slices only: its collectives return no data); values come
from gloo ranks on a `FileStore`.  Every test that starts processes gives
them a time limit and kills them all when one fails or the limit passes.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import textwrap
import time
import types
from typing import Mapping

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P
from jax.tree_util import DictKey, SequenceKey

from repro.configs import get_config as jget
from repro.models import make_model as jmake
from repro.models import layers as JL
from repro.models import moe as JMOE
from repro.models import transformer as JT
from repro.parallel import sharding as JS
from repro_torch import interop
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shapes_for
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import make_model
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TT
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import sharding as S

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "8": {"data": 8}, "4": {"data": 4}, "1": {"data": 1}}
FAMILY_ARCHS = ("qwen3-0.6b", "qwen2-moe-a2.7b", "rwkv6-3b",
                "recurrentgemma-2b", "whisper-tiny", "phi-3-vision-4.2b")
# the small dense model the reference's own elastic test places
SMALL = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, d_ff=128, vocab=512, dtype="float32")


def _jmesh(sizes: Mapping):
    return types.SimpleNamespace(
        axis_names=tuple(sizes),
        devices=np.empty(tuple(sizes.values()), dtype=object))


def _norm(spec, ndim: int) -> tuple:
    """A reference spec as a tuple of `ndim` entries."""
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def _ref_leaves(tree, specs, cfg) -> dict:
    """{the port's dotted path: (shape, spec)} of a reference tree of
    leaves and its spec tree: stacked leaves unstacked into per-layer
    names (`interop.model_params`' naming) with the stack dim dropped from
    both."""
    out = {}
    stacks = {"layers": cfg.n_layers, "enc_layers": cfg.n_enc_layers,
              "dec_layers": cfg.n_layers}

    def walk(prefix, t, sp, stacked):
        for k, v in t.items():
            if isinstance(v, Mapping):
                walk(f"{prefix}{k}.", v, sp[k], stacked)
            else:
                out[prefix + k] = _leaf(v, sp[k], stacked)

    for k, v in tree.items():
        if k in stacks:
            for i in range(stacks[k]):
                walk(f"{k}.{i}.", v, specs[k], True)
        elif k == "super":
            width = len(cfg.block_pattern)
            for j, kind in enumerate(v):
                for s in range(cfg.n_layers // width):
                    walk(f"layers.{s * width + j}.", kind, specs[k][j], True)
        elif k == "tail":
            first = cfg.n_layers - len(v)
            for i, sub in enumerate(v):
                walk(f"layers.{first + i}.", sub, specs[k][i], False)
        elif isinstance(v, Mapping):
            walk(f"{k}.", v, specs[k], False)
        else:
            out[k] = _leaf(v, specs[k], False)
    return out


def _leaf(v, spec, stacked: bool) -> tuple:
    """(shape, spec) of a reference leaf, without the stack dim where it
    is stacked; the spec "raises" where the rule search raised."""
    shape = tuple(v.shape)
    if spec != "raises":
        spec = _norm(spec, len(shape))[stacked:]
    return shape[stacked:], spec


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """(the reference's full-size parameter shapes, the port's full-size
    leaves on the meta device)."""
    jshapes = jmake(jget(arch)).param_shapes()
    port = dict(make_model(get_config(arch), "meta").state_dict())
    return jshapes, port


def _ref_specs(jshapes, mesh):
    """The reference's validated specs, "raises" where its rule search
    raises."""
    def fix(path, leaf):
        try:
            return _one_validated(path, leaf, mesh)
        except ValueError:
            return "raises"
    return jax.tree_util.tree_map_with_path(fix, jshapes)


def _one_validated(path, leaf, mesh):
    """The reference's `validated_pspecs` of one leaf at its own path."""
    tree = leaf
    for part in reversed(path):
        tree = ({part.key: tree} if isinstance(part, DictKey)
                else [tree] * (part.idx + 1))
    got = JS.validated_pspecs(tree, mesh)
    for part in path:
        got = got[part.key] if isinstance(part, DictKey) else got[part.idx]
    return got


def _port_spec(name, shape, sizes):
    try:
        S.param_pspec(name, shape)
    except ValueError:
        return "raises"
    return S.validated_pspec(name, shape, sizes)


# ---------------------------------------------------------------------------
# The rules
# ---------------------------------------------------------------------------
def test_rule_tables_equal_the_references():
    assert S.LOGICAL_RULES == JS.LOGICAL_RULES
    assert S.PARAM_RULES == JS.PARAM_RULES
    assert S._AXIS_MAP == JS._AXIS_MAP


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_validated_pspecs_match_reference_on_every_leaf(arch):
    """Every leaf of the full-size model, on the five meshes: the port's
    per-layer leaf gets the reference's stacked leaf's spec without its
    stack dim, and raises where the reference raises."""
    jshapes, port = _shapes(arch)
    cfg = get_config(arch)
    for mname, sizes in MESHES.items():
        want = _ref_leaves(jshapes, _ref_specs(jshapes, _jmesh(sizes)), cfg)
        got = S.validated_pspecs(port, sizes)
        assert set(got) == set(want), mname
        for k, (shape, spec) in want.items():
            assert tuple(port[k].shape) == shape, k
            assert _port_spec(k, tuple(port[k].shape), sizes) == spec, \
                (mname, k)
            assert got[k] == spec, (mname, k)
        # the tree form agrees with the leaf form
        assert S.params_pspecs(port) == {
            k: S.param_pspec(k, tuple(v.shape)) for k, v in port.items()}


@pytest.mark.parametrize("name, shape", [
    ("layers.3.attn.wq", (1024, 2048)),
    ("layers.3.moe.we_gate", (64, 32)),          # rule cut from the left
    ("layers.3.moe.we_down", (60, 1408, 2048)),
    ("layers.0.attn.wq", (16,)),
    ("layers.1.attn.wq", (3, 64, 32)),           # padded with None
    ("embed.table", (151936, 1024)),
    ("enc_pos", (1500, 384)),
    ("mu.layers.2.rwkv.decay_lora_a", (2560, 64)),
    ("layers.0.ln1.scale", (4_000_000,)),        # no rule, at the limit
    ("layers.0.ln1.scale", (4_000_001,)),        # no rule, past it: raises
    ("foo.bar", (2001, 2000)),
    ("count", ()),
    ("wq", ()),                                  # a rule on a 0-d leaf
])
def test_param_pspec_edge_cases_match_reference(name, shape):
    path = tuple(SequenceKey(int(p)) if p.isdigit() else DictKey(p)
                 for p in name.split("."))
    leaf = jax.ShapeDtypeStruct(shape, np.float32)
    try:
        want = tuple(JS.param_pspec(path, leaf))
    except ValueError:
        want = "raises"
    try:
        got = S.param_pspec(name, shape)
    except ValueError:
        got = "raises"
    if want != "raises":
        want = _norm(want, len(shape))
    assert got == want
    for sizes in MESHES.values():
        if want == "raises":
            with pytest.raises(ValueError):
                S.validated_pspec(name, shape, sizes)
        else:
            assert S.validated_pspec(name, shape, sizes) == tuple(
                _one_validated(path, leaf, _jmesh(sizes))) + (None,) * (
                len(shape) - len(tuple(_one_validated(
                    path, leaf, _jmesh(sizes)))))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_pspec_and_placements(mesh):
    sizes = MESHES[mesh]
    assert S.batch_pspec(sizes) == tuple(JS.batch_pspec(_jmesh(sizes)))
    pl = S.placements(S.batch_pspec(sizes) + (None,), sizes)
    from torch.distributed.tensor import Replicate, Shard
    # the batch dim is split over every data-parallel axis, major first
    assert pl == tuple(Shard(0) if a in ("pod", "data") else Replicate()
                       for a in sizes)


def test_placements_refuse_what_dtensor_cannot_lay_out():
    sizes = MESHES["2x16x16"]
    with pytest.raises(ValueError, match="order"):
        S.placements((("data", "pod"), None), sizes)
    with pytest.raises(ValueError, match="twice"):
        S.placements(("model", "model"), sizes)


# ---------------------------------------------------------------------------
# The hints
# ---------------------------------------------------------------------------
def _site_shapes(cfg, b: int, t: int) -> set:
    """(logical axes, shape) of every hint of the forward pass at batch b,
    sequence t (the nine sites: embed, q, k, attention out, swiglu, the
    logits, and the MoE buffer, hidden and expert outputs)."""
    d, dh = cfg.d_model, cfg.head_dim
    bt = ("batch", None, None)
    out = {(bt, (b, t, d)), (("batch", None, "vocab"),
                             (b, t, cfg.padded_vocab))}
    seqs = {"encdec": (t, cfg.n_audio_frames),
            "rwkv6": ()}.get(cfg.family, (t,))
    for s in seqs:
        out |= {(("batch", "heads", None, None), (b, cfg.n_heads, s, dh)),
                (("batch", "kv_heads", None, None),
                 (b, cfg.kv_heads, s, dh)),
                (bt, (b, s, d))}
    if cfg.family in ("dense", "vlm", "hybrid") and cfg.mlp_type == "swiglu":
        out.add((("batch", None, "mlp"), (b, t, cfg.d_ff)))
    if cfg.family == "moe":
        n, e = b * t, cfg.n_experts
        cap, fe = TMOE.capacity(cfg, n), cfg.d_expert_ff or cfg.d_ff
        out |= {((None, "batch", None), (e, cap, d)),
                ((None, "batch", "mlp"), (e, cap, fe))}
        if cfg.n_shared_experts:
            out.add((("batch", None, "mlp"), (n, fe * cfg.n_shared_experts)))
    return out


def _recorded(monkeypatch, modules, run) -> set:
    seen = set()

    def record(x, axes):
        seen.add((tuple(axes), tuple(int(n) for n in x.shape)))
        return x

    for m in modules:
        monkeypatch.setattr(m, "logical_constraint", record)
    run()
    monkeypatch.undo()
    return seen


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_hint_sites_match_reference(arch, monkeypatch):
    """The forward pass of the REDUCED model gives the same hints — axes
    and shapes — in both packages, and they are the nine sites
    `_site_shapes` names."""
    b, t = 2, 16
    jcfg, cfg = jget(arch, reduced=True), get_config(arch, reduced=True)
    jm = jmake(jcfg)
    jp = jm.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)
    extra = {}
    if cfg.family == "vlm":
        extra["img_embeds"] = rng.normal(
            size=(b, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        extra["audio_frames"] = rng.normal(
            size=(b, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    want = _recorded(monkeypatch, (JL, JMOE, JT), lambda: JT.forward(
        jp, jcfg, toks, **extra))
    model = make_model(cfg, "cpu").load_params(interop.model_params(
        jax.tree.map(np.asarray, jp), cfg))
    with torch.no_grad():
        got = _recorded(monkeypatch, (TL, TMOE, TT), lambda: TT.forward(
            model.params(), cfg, torch.from_numpy(toks),
            **{k: torch.from_numpy(v) for k, v in extra.items()}))
    assert got == want
    assert got == _site_shapes(cfg, b, t)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_resolve_matches_reference_at_hint_sites(arch):
    """`_resolve` at the nine sites for every assigned shape of every
    arch at full size, on the five meshes."""
    cfg = get_config(arch)
    n = 0
    for shape_name in shapes_for(cfg):
        spec = SHAPES[shape_name]
        t = 1 if spec.kind == "decode" else spec.seq
        for axes, shape in _site_shapes(cfg, spec.batch, t):
            for sizes in MESHES.values():
                want = tuple(JS._resolve(axes, _jmesh(sizes), shape))
                assert S._resolve(axes, sizes, shape) == want, (axes, shape)
                n += 1
    assert n


def test_logical_constraint_returns_a_plain_tensor_unchanged():
    x = torch.ones((4, 3, 8))
    assert S.logical_constraint(x, ("batch", None, "vocab")) is x
    p = torch.nn.Parameter(x)
    assert S.logical_constraint(p, ("batch", None, None)) is p


def test_logical_constraint_redistributes_a_dtensor():
    """On the process's one-rank gloo mesh: a hint that resolves to an
    axis redistributes; one that resolves to none returns the DTensor."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = make_host_mesh(("data",), "cpu")
    x = distribute_tensor(torch.arange(24.0).reshape(2, 3, 4), mesh,
                          [Replicate()], src_data_rank=None)
    y = S.logical_constraint(x, ("batch", None, "vocab"))
    assert y.placements == (Shard(0),)
    assert torch.equal(y.full_tensor(), x.full_tensor())
    assert S.logical_constraint(x, (None, "heads", "vocab")) is x
    with pytest.raises(ValueError, match="256 ranks"):
        make_production_mesh(device_type="cpu")


# ---------------------------------------------------------------------------
# Processes
# ---------------------------------------------------------------------------
RANK_PRELUDE = textwrap.dedent("""
    import datetime, os, sys
    sys.path.insert(0, %r)
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    RANK, WORLD, STORE = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    ARGS = sys.argv[4:]
    dist.init_process_group("gloo", store=dist.FileStore(STORE, WORLD),
                            rank=RANK, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
""") % SRC


def run_procs(argvs, out_dir, timeout: float) -> list:
    """Run each argv as a process (stdout and stderr to files under
    `out_dir`); -> their stdouts.  Every process is killed when one fails
    or `timeout` seconds pass, and the test fails."""
    os.makedirs(out_dir, exist_ok=True)
    files, procs = [], []
    try:
        for i, argv in enumerate(argvs):
            out = open(os.path.join(out_dir, f"p{i}.out"), "w+")
            err = open(os.path.join(out_dir, f"p{i}.err"), "w+")
            files += [out, err]
            procs.append((subprocess.Popen(argv, stdout=out, stderr=err,
                                           stdin=subprocess.DEVNULL,
                                           text=True), out, err))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p, _, _ in procs):
            bad = [(p, e) for p, _, e in procs
                   if p.returncode not in (None, 0)]
            if bad or time.monotonic() > deadline:
                for p, _, _ in procs:
                    p.kill()
                if bad:
                    bad[0][1].seek(0)
                    raise AssertionError(bad[0][1].read()[-4000:])
                raise AssertionError(f"processes past {timeout}s")
            time.sleep(0.05)
        outs = []
        for p, out, err in procs:
            out.seek(0)
            err.seek(0)
            assert p.returncode == 0, err.read()[-4000:]
            outs.append(out.read())
        return outs
    finally:
        for p, _, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()


def run_ranks(script: str, world: int, tmp_path, *args,
              timeout: float = 240) -> list:
    """`script` (after RANK_PRELUDE: RANK, WORLD, ARGS and a gloo group
    on a FileStore under tmp_path) as `world` ranks; -> their stdouts."""
    tag = f"ranks_{world}_{len(os.listdir(tmp_path))}"
    store = os.path.join(tmp_path, f"{tag}.store")
    code = RANK_PRELUDE + textwrap.dedent(script) \
        + "\ndist.destroy_process_group()\n"
    return run_procs([[sys.executable, "-c", code, str(r), str(world), store,
                       *map(str, args)] for r in range(world)],
                     os.path.join(tmp_path, tag), timeout)


FAKE_SCRIPT = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, %r)
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import make_model
    from repro_torch.parallel import sharding as S

    sites = json.loads(sys.argv[1])
    out = {}
    for world, multi, ranks in ((256, False, (0, 137)),
                                (512, True, (0, 389))):
        for rank in ranks:
            dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                    world_size=world)
            mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
            key = f"{world}/{rank}"
            out[key] = {"coord": mesh.get_coordinate()}
            for arch in ARCH_IDS:
                sd = make_model(get_config(arch), "meta").state_dict()
                sh = S.params_sharding(sd, mesh)
                out[key][arch] = {k: list(S.shard(v, sh[k]).to_local().shape)
                                  for k, v in sd.items()}
            hints = []
            for axes, shape in sites:
                x = distribute_tensor(torch.empty(shape, device="meta"), mesh,
                                      [Replicate()] * mesh.ndim,
                                      src_data_rank=None)
                y = S.logical_constraint(x, tuple(axes))
                hints.append(list(y.to_local().shape))
            out[key]["hints"] = hints
            dist.destroy_process_group()
    print(json.dumps(out))
""") % SRC


def test_fake_process_group_layouts_match_reference_shards(tmp_path):
    """On torch's fake process group at 16x16 and 2x16x16, for two ranks
    each, every leaf's local shape under `params_sharding` and the local
    shape of a hint at every site (qwen3-0.6b's and qwen2-moe's train
    shape) equal the reference's per-device shard shape."""
    sites = sorted(_site_shapes(get_config("qwen3-0.6b"), 256, 4096)
                   | _site_shapes(get_config("qwen2-moe-a2.7b"), 32, 4096),
                   key=repr)
    out, = run_procs([[sys.executable, "-c", FAKE_SCRIPT,
                       json.dumps(sites)]], str(tmp_path / "fake"),
                     timeout=240)
    got = json.loads(out)
    for key, res in got.items():
        world = int(key.split("/")[0])
        sizes = MESHES["16x16" if world == 256 else "2x16x16"]
        amesh = AbstractMesh(tuple(sizes.values()), tuple(sizes))
        assert len(res["coord"]) == len(sizes)
        for arch in ARCH_IDS:
            jshapes, _ = _shapes(arch)
            want = _ref_leaves(jshapes, JS.validated_pspecs(
                jshapes, _jmesh(sizes)), get_config(arch))
            assert set(res[arch]) == set(want), (key, arch)
            for k, (shape, spec) in want.items():
                assert tuple(res[arch][k]) == NamedSharding(
                    amesh, P(*spec)).shard_shape(shape), (key, arch, k)
        for (axes, shape), local in zip(sites, res["hints"]):
            spec = JS._resolve(tuple(axes), _jmesh(sizes), tuple(shape))
            assert tuple(local) == NamedSharding(amesh, spec).shard_shape(
                tuple(shape)), (key, axes, shape)


REF_SHARDS = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, %r)
    import jax, numpy as np
    from jax.sharding import NamedSharding
    from repro.launch.mesh import make_host_mesh
    from repro.models import ModelConfig, make_model
    from repro.parallel.sharding import validated_pspecs

    m = make_model(ModelConfig(**%r))
    mesh = make_host_mesh(("data",))
    params = m.init(jax.random.key(0))
    specs = validated_pspecs(jax.eval_shape(lambda: params), mesh)
    placed = jax.tree.map(lambda x, s: jax.device_put(
        x, NamedSharding(mesh, s)), params, specs)
    pos = {d: i for i, d in enumerate(mesh.devices.flat)}
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]:
        name = "/".join(p.key for p in path)
        out[name + "|full"] = np.asarray(leaf)
        for sh in leaf.addressable_shards:
            out[f"{name}|{pos[sh.device]}"] = np.asarray(sh.data)
    np.savez(%r, **out)
""")

PLACE_SCRIPT = """
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import place_params

    data = torch.load(ARGS[0])
    mesh = make_host_mesh(("data",), "cpu")
    assert list(mesh.get_coordinate()) == [RANK], mesh.get_coordinate()
    placed = place_params(data["full"], mesh)
    want = data["shards"][RANK]
    assert set(placed) == set(want)
    for k, v in placed.items():
        assert torch.equal(v.to_local(), want[k]), k
        assert torch.equal(v.full_tensor(), data["full"][k]), k
    print("OK", len(placed))
"""


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def test_gloo_shards_equal_reference_shards(tmp_path):
    """8 gloo ranks place a small dense model's weights (the reference's,
    carried across by `interop.model_params`) by `validated_pspecs` on
    `make_host_mesh(("data",))`: each rank's local slice of every leaf
    equals the reference's shard on the device at the same mesh position
    (the reference in a process with 8 forced host devices)."""
    npz = str(tmp_path / "ref_shards.npz")
    run_procs([[sys.executable, "-c", REF_SHARDS % (SRC, SMALL, npz)]],
              str(tmp_path / "ref"), timeout=240)
    z = np.load(npz)
    by_part: dict = {}
    for key in z.files:
        name, part = key.split("|")
        by_part.setdefault(part, {})[name] = z[key]
    cfg = ModelConfig(**SMALL)
    data = {"full": interop.model_params(_nest(by_part["full"]), cfg),
            "shards": [interop.model_params(_nest(by_part[str(r)]), cfg)
                       for r in range(8)]}
    # a data-sharded leaf splits 8 ways
    assert data["shards"][3]["layers.1.attn.wq"].shape == (8, 64)
    path = str(tmp_path / "weights.pt")
    torch.save(data, path)
    outs = run_ranks(PLACE_SCRIPT, 8, tmp_path, path)
    assert all(o.startswith("OK ") for o in outs), outs
