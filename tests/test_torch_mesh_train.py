"""Training on the mesh: `launch.train`'s placed path (`parallel.sharding`
+ `launch.mesh` on gloo) against the plain step, the elastic restore
across meshes, and the Supervisor on placed state.

Stated tolerances: one rank gives the plain step's bits (deterministic
algorithms on); four ranks split the batch and reduce the gradients in
another order, so the loss within 1e-5 and the parameters within 1e-6.
The one-rank mesh is this process's own (one gloo rank on an in-process
store, as `make_host_mesh` makes it); more ranks run as processes on a
`FileStore`, each with a time limit, all killed when one fails.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate

from repro_torch.configs import get_config
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import make_model
from repro_torch.parallel.sharding import (full_tensor, place_batch,
                                           place_params, validated_pspecs)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault import Supervisor, elastic_restore
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.train_step import TrainConfig, make_train_step
from test_torch_sharding import FAMILY_ARCHS, SMALL, SRC, run_ranks


@pytest.fixture
def deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


@pytest.fixture
def mesh():
    return make_host_mesh(("data",), "cpu")


def _batch(vocab, step, b=4, t=32):
    rng = np.random.default_rng(step)
    return {"tokens": torch.from_numpy(
        rng.integers(0, vocab, (b, t)).astype(np.int32))}


def test_placed_step_on_one_rank_gives_the_plain_bits(mesh, deterministic):
    """Two steps of the reduced qwen3-0.6b: placed by `validated_pspecs`
    on the one-rank mesh and plain, the same losses and parameters bit
    for bit, every leaf keeping its placement."""
    cfg = get_config("qwen3-0.6b", reduced=True)
    model = make_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    step = make_train_step(model, TrainConfig())
    plain = model.master_params()
    placed = place_params(plain, mesh)
    layout = {k: v.placements for k, v in placed.items()}
    po, qo = init_opt_state(plain), init_opt_state(placed)
    for s in range(2):
        b = _batch(cfg.vocab, s)
        plain, po, mp = step(plain, po, b, s)
        placed, qo, mq = step(placed, qo, place_batch(b, mesh), s)
        assert torch.equal(mp["loss"], mq["loss"])
        assert type(mq["loss"]) is torch.Tensor
    for k, v in placed.items():
        assert v.placements == layout[k], k
        assert qo["mu"][k].placements == layout[k], k
        assert torch.equal(v.full_tensor(), plain[k]), k
        assert torch.equal(qo["nu"][k].full_tensor(), po["nu"][k]), k


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_placed_step_on_one_rank_gives_the_plain_bits_in_bf16(arch, mesh,
                                                              deterministic):
    """Each family's REDUCED model with bf16 activations: one placed step
    on the one-rank mesh and one plain step, the same loss and parameters
    bit for bit (the GQA heads' gradients summed in float32 on both
    paths; the card's bf16 train step is held so)."""
    cfg = get_config(arch, reduced=True).with_(dtype="bfloat16")
    model = make_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    step = make_train_step(model, TrainConfig())
    plain = model.master_params()
    b = _batch(cfg.vocab, 0)
    rng = np.random.default_rng(1)
    if cfg.family == "vlm":
        b["img_embeds"] = torch.from_numpy(rng.normal(
            size=(4, cfg.n_img_tokens, cfg.d_model)).astype(np.float32))
    if cfg.family == "encdec":
        b["audio_frames"] = torch.from_numpy(rng.normal(
            size=(4, cfg.n_audio_frames, cfg.d_model)).astype(np.float32))
    p1, _, m1 = step(plain, init_opt_state(plain), b, 0)
    placed = place_params(plain, mesh)
    p2, _, m2 = step(placed, init_opt_state(placed), place_batch(b, mesh), 0)
    assert torch.equal(m1["loss"], m2["loss"])
    bad = [k for k in p1 if not torch.equal(p1[k], full_tensor(p2[k]))]
    assert not bad, bad


FOUR_RANKS = """
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import make_model
    from repro_torch.parallel.sharding import place_batch, place_params
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import TrainConfig, make_train_step

    mesh = make_host_mesh(("data",), "cpu")
    cfg = get_config("qwen3-0.6b", reduced=True)
    model = make_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    step = make_train_step(model, TrainConfig())
    plain = model.master_params()
    placed = place_params(plain, mesh)
    po, qo = init_opt_state(plain), init_opt_state(placed)
    for s in range(2):
        rng = np.random.default_rng(s)
        b = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab, (8, 32)).astype(np.int32))}
        plain, po, mp = step(plain, po, b, s)
        placed, qo, mq = step(placed, qo, place_batch(b, mesh), s)
        assert abs(float(mp["loss"]) - float(mq["loss"])) <= 1e-5
    err = max(float((placed[k].full_tensor() - plain[k]).abs().max())
              for k in plain)
    assert err <= 1e-6, err
    wq = placed["layers.0.attn.wq"]
    assert wq.to_local().shape[0] * WORLD == wq.shape[0]
    print("OK", err)
"""


def test_placed_step_on_four_ranks_matches_plain(tmp_path):
    """Four gloo ranks split the batch and shard the parameters: two
    steps of the reduced qwen3-0.6b (dense) within loss 1e-5 and
    parameters 1e-6 of the plain step."""
    outs = run_ranks(FOUR_RANKS, 4, tmp_path)
    assert all(o.startswith("OK ") for o in outs), outs


ELASTIC = """
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import make_model
    from repro_torch.models.config import ModelConfig
    from repro_torch.parallel.sharding import place_params, validated_pspecs
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.fault import elastic_restore

    cfg = ModelConfig(**%r)
    mesh = make_host_mesh(("data",), "cpu")

    def params(seed):
        return make_model(cfg, "cpu").init(
            torch.Generator().manual_seed(seed)).master_params()

    d, mode = ARGS
    if mode == "save":
        ckpt.save_checkpoint(d, 7, {"params": place_params(params(0), mesh)},
                             wait=True)
        assert ckpt.latest_step(d) == 7  # on disk on every rank
    else:
        like = {"params": place_params(params(1), mesh)}
        tree, step = elastic_restore(d, like, mesh, validated_pspecs)
        assert step == 7
        want = params(0)
        for k, v in tree["params"].items():
            assert v.placements == like["params"][k].placements, k
            assert torch.equal(v.full_tensor(), want[k]), k
        wq = tree["params"]["layers.0.attn.wq"]
        assert tuple(wq.to_local().shape) == (wq.shape[0] // WORLD,
                                              wq.shape[1])
    print("OK", mode)
""" % (SMALL,)


def test_elastic_reshard_across_meshes(tmp_path):
    """A checkpoint saved from 8 gloo ranks restores onto 4: the restored
    leaves equal the saved ones, and each rank holds 1/4 of a leaf
    sharded on `data`."""
    d = str(tmp_path / "elastic")
    for world, mode in ((8, "save"), (4, "load")):
        outs = run_ranks(ELASTIC, world, tmp_path, d, mode)
        assert outs == [f"OK {mode}\n"] * world
    # one manifest, written once, in the reference's format
    assert sorted(os.listdir(d)) == ["LATEST", "step_7"]


def test_supervisor_restore_keeps_the_placement(mesh, tmp_path,
                                               deterministic):
    """A failed step restores the last checkpoint onto the mesh, laid out
    as the state was, and the run ends where an uninterrupted one does."""
    cfg = get_config("qwen3-0.6b", reduced=True)
    model = make_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    step_fn = make_train_step(model, TrainConfig())

    def run(d, fn):
        params = place_params(model.master_params(), mesh)
        state = {"params": params, "opt": init_opt_state(params), "step": 0}
        return Supervisor(ckpt_dir=d, ckpt_every=2).run(
            state=state, train_step=fn,
            batch_fn=lambda s: place_batch(_batch(cfg.vocab, s), mesh),
            num_steps=5, log_every=0, log=lambda *a: None)[0]

    fails = {"n": 1}

    def flaky(p, o, b, s):
        if s == 3 and fails["n"]:
            fails["n"] -= 1
            raise RuntimeError("injected")
        return step_fn(p, o, b, s)

    ref = run(str(tmp_path / "a"), step_fn)
    got = run(str(tmp_path / "b"), flaky)
    assert fails["n"] == 0 and got["step"] == 5
    for k, v in ref["params"].items():
        assert got["params"][k].placements == v.placements, k
        assert torch.equal(got["params"][k].full_tensor(), v.full_tensor())
    assert type(got["opt"]["count"]) is torch.Tensor
    assert int(got["opt"]["count"]) == 5


def test_elastic_restore_onto_the_one_rank_mesh_steps_on(mesh, tmp_path,
                                                        deterministic):
    """`elastic_restore(..., mesh, validated_pspecs)` places every leaf,
    the step count too (replicated, as the reference places it), and a
    step from the restored state equals a step from the saved one."""
    cfg = get_config("qwen3-0.6b", reduced=True)
    model = make_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    step = make_train_step(model, TrainConfig())
    params = place_params(model.master_params(), mesh)
    params, opt, _ = step(params, init_opt_state(params),
                          place_batch(_batch(cfg.vocab, 0), mesh), 0)
    d = str(tmp_path / "ck")
    ckpt.save_checkpoint(d, 1, {"params": params, "opt": opt})
    tree, at = elastic_restore(d, {"params": params, "opt": opt}, mesh,
                               validated_pspecs)
    assert at == 1 and tree["opt"]["count"].placements == (Replicate(),)
    b = place_batch(_batch(cfg.vocab, 1), mesh)
    want = step(params, opt, b, 1)
    got = step(tree["params"], tree["opt"], b, 1)
    for (pa, a), (pb, x) in zip(ckpt.flatten(want[:2]),
                                ckpt.flatten(got[:2])):
        assert pa == pb and torch.equal(full_tensor(a), full_tensor(x)), pa


def test_launcher_trains_on_the_mesh(tmp_path, capsys):
    """`launch.train` with `--device cpu` places the parameters on the
    process's one-rank gloo mesh by `validated_pspecs` and trains them
    there under the Supervisor; a second run resumes from its
    checkpoint onto the mesh."""
    d = str(tmp_path / "launch")
    argv = ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--ckpt-dir", d]
    state = ttrain.main(argv + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "on cpu, mesh {'data': 1}" in out
    assert "[train] finished at step 3" in out
    mesh = make_host_mesh(("data",), "cpu")
    specs = validated_pspecs(state["params"], mesh)
    for k, v in state["params"].items():
        assert v.device_mesh == mesh, k
        assert v.placements == place_params(
            {k: v.full_tensor()}, mesh)[k].placements, (k, specs[k])
    state = ttrain.main(argv + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "[supervisor] restored step 3" in out and state["step"] == 4
    assert all(hasattr(v, "placements") for v in state["params"].values())


IMPORTS = textwrap.dedent("""
    import sys
    sys.path.insert(0, %r)
    import torch
    import torch.distributed as dist
    import repro_torch.launch.mesh, repro_torch.launch.train
    from repro_torch.configs import get_config
    from repro_torch.models import make_model
    assert not dist.is_initialized()
    cfg = get_config("qwen3-0.6b", reduced=True)
    model = make_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    toks = torch.zeros((1, 8), dtype=torch.int32)
    model.logits({"tokens": toks})
    model.loss({"tokens": toks}, model.master_params())
    assert not dist.is_initialized()
    assert "torch.distributed.tensor" not in sys.modules
    print("OK")
""") % SRC


def test_importing_the_mesh_touches_no_group_nor_dtensor(tmp_path):
    """Importing the mesh and the launcher makes no process group, and
    the plain model path (logits, loss) never loads DTensor."""
    r = subprocess.run([sys.executable, "-c", IMPORTS], capture_output=True,
                       text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip() == "OK"


DRYRUN_IMPORTS = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, %r)
    import torch.distributed as dist
    import repro_torch.launch.dryrun, repro_torch.launch.report
    import repro_torch.launch.roofline
    assert not dist.is_initialized()
    assert "XLA_FLAGS" not in os.environ
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax",
                                                               "repro"))
    assert not bad, bad
    print("OK")
""") % SRC

DRYRUN_ON_GLOO = textwrap.dedent("""
    import sys
    sys.path.insert(0, %r)
    import torch.distributed as dist
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.mesh import make_host_mesh
    make_host_mesh(("data",), "cpu")
    try:
        lower_cell("qwen3-0.6b", "train_4k")
    except RuntimeError as e:
        assert "fake process group" in str(e), e
        assert str(dist.get_backend()) == "gloo"
        print("REFUSED")
""") % SRC


def test_importing_the_dryrun_touches_no_group_nor_jax(tmp_path):
    """Importing the dry-run, roofline and report launchers makes no
    process group, sets no XLA_FLAGS and loads neither JAX nor the
    reference package."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    r = subprocess.run([sys.executable, "-c", DRYRUN_IMPORTS],
                       capture_output=True, text=True, timeout=240, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip() == "OK"


def test_the_dryrun_refuses_a_gloo_default_group(tmp_path):
    """`lower_cell` runs on torch's fake process group only: on a process
    whose default group is gloo it raises and leaves that group as it
    was."""
    r = subprocess.run([sys.executable, "-c", DRYRUN_ON_GLOO],
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip() == "REFUSED"


def test_a_cuda_mesh_never_becomes_a_cpu_mesh():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the cuda mesh is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_host_mesh(("data",), "cuda")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        make_host_mesh(("data",), "tpu")
