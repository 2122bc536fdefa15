"""The port's training path against the reference: `Model.loss` and its
gradients for every family, AdamW, microbatching, remat, gradient
compression, checkpoints, the Supervisor and the launcher.

Both packages get the same weights (the reference's initial ones, through
`interop.model_params`) and the same numpy-seeded batches, and the
reference's gradient tree is mapped through `interop.model_params` the
same way.  Stated tolerances, float32 throughout: the loss within 1e-5,
every gradient leaf within atol 1e-5 + rtol 1e-4 (as
`tests/test_models.py` holds remat against no remat), the AdamW moments
within the gradient tolerance and the parameters within 1e-6.  The
reference's int8 quantization is matched bit for bit on its own noise.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import textwrap
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as jget
from repro.models import make_model as jmake
from repro.train import checkpoint as jckpt
from repro.train import compression as jcomp
from repro.train import optimizer as jopt
from repro_torch import interop
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import invoke
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import make_model
from repro_torch.models import moe as TMOE
from repro_torch.parallel.sharding import (full_tensor, place_batch,
                                           place_params, validated_pspecs)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import compression as comp
from repro_torch.train import optimizer as topt
from repro_torch.train.fault import (StragglerWatchdog, Supervisor,
                                     elastic_restore)
from repro_torch.train.train_step import (TrainConfig, loss_and_grads,
                                          make_eval_step, make_train_step)

LOSS_TOL = 1e-5
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
PARAM_TOL = dict(atol=1e-6, rtol=0)
FAMILY_ARCHS = ("qwen3-0.6b", "qwen2-moe-a2.7b", "rwkv6-3b",
                "recurrentgemma-2b", "whisper-tiny", "phi-3-vision-4.2b")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _np_batch(cfg, b, t, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["img_embeds"] = rng.normal(
            size=(b, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["audio_frames"] = rng.normal(
            size=(b, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return batch


def _tb(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _ref(arch):
    """The reference's REDUCED model, its initial params as numpy and its
    jitted loss-and-gradient (made once a test process: compiling it is
    most of a test's time)."""
    jm = jmake(jget(arch, reduced=True))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    return jm, jp, jax.jit(jax.value_and_grad(jm.loss))


def _pair(arch):
    """(reference model, its params as numpy, the port's model on the same
    weights)."""
    jm, jp, _ = _ref(arch)
    cfg = get_config(arch, reduced=True)
    model = make_model(cfg, "cpu").load_params(interop.model_params(jp, cfg))
    return jm, jp, model


def _ref_loss_grads(arch, batch, params=None):
    """The reference's loss and gradients (at `params`, a reference tree,
    or its initial ones), the gradients as the port's flat dict."""
    jm, jp, value_and_grad = _ref(arch)
    loss, g = value_and_grad(
        jax.tree.map(jnp.asarray, jp) if params is None else params,
        _jb(batch))
    return float(loss), interop.model_params(jax.tree.map(np.asarray, g),
                                             jm.cfg)


@pytest.fixture
def deterministic():
    """torch's deterministic algorithms on for one test: the embedding's
    backward (`table[tokens]`) otherwise accumulates in a varying order on
    the CPU too, a last-bit difference between two runs of one step."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def _close_trees(got, want, **tol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **tol)


# ---------------------------------------------------------------------------
# Loss and gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_and_grads_match_reference(arch, monkeypatch):
    jm, jp, model = _pair(arch)
    batch = _np_batch(model.cfg, 2, 32, seed=1)
    routes = []
    if model.cfg.family == "moe":  # note each layer's routing inputs
        route = TMOE.route

        def noting(p, cfg, xf):
            out = route(p, cfg, xf)
            routes.append((xf.detach().numpy(), p["router"].detach().numpy(),
                           out[2].numpy()))
            return out

        monkeypatch.setattr(TMOE, "route", noting)
    loss, grads = loss_and_grads(model, model.master_params(), _tb(batch))
    want_loss, want = _ref_loss_grads(arch, batch)
    if model.cfg.family == "moe":
        # both packages route alike: on each layer's input the reference's
        # top-k picks the port's experts, with a margin between the k-th
        # and the next probability far above the tolerance
        assert len(routes) == model.cfg.n_layers
        k = model.cfg.top_k
        for xf, router, topi in routes:
            probs = jax.nn.softmax(jnp.asarray(xf) @ jnp.asarray(router))
            np.testing.assert_array_equal(
                np.asarray(jax.lax.top_k(probs, k)[1]), topi)
            srt = np.sort(np.asarray(probs), axis=-1)[:, ::-1]
            assert (srt[:, k - 1] - srt[:, k]).min() > 1e-6
    assert abs(float(loss) - want_loss) <= LOSS_TOL
    assert abs(want_loss - np.log(model.cfg.vocab)) < 1.0
    _close_trees(grads, want, **GRAD_TOL)
    # no leaf is cut off that the reference reaches (a zero-initialised
    # LoRA half leaves its partner at zero in both)
    for k, g in grads.items():
        assert bool(g.any()) == bool(want[k].any()), k
    assert sum(bool(g.any()) for g in grads.values()) > len(grads) // 2


def test_loss_mask_matches_reference():
    jm, jp, model = _pair("qwen3-0.6b")
    batch = _np_batch(model.cfg, 2, 32, seed=2)
    batch["loss_mask"] = (np.random.default_rng(3).random((2, 32))
                          > 0.4).astype(np.int32)
    loss, grads = loss_and_grads(model, model.master_params(), _tb(batch))
    want_loss, want = _ref_loss_grads("qwen3-0.6b", batch)
    assert abs(float(loss) - want_loss) <= LOSS_TOL
    _close_trees(grads, want, **GRAD_TOL)


def test_loss_without_params_reads_the_module_and_eval_step():
    jm, jp, model = _pair("qwen3-0.6b")
    batch = _tb(_np_batch(model.cfg, 2, 16, seed=4))
    with torch.no_grad():
        a = model.loss(batch)
    b = make_eval_step(model)(model.master_params(), batch)
    assert torch.equal(a, b)
    assert abs(float(a) - float(jm.loss(jax.tree.map(jnp.asarray, jp),
                                        _jb({k: v.numpy() for k, v in
                                             batch.items()})))) <= LOSS_TOL
    # the serving cache is not what the loss reads: a cached cast tree
    # stays as it was
    cast = model.params()
    model.loss(batch, model.master_params())
    assert model.params() is cast


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-moe-a2.7b", "rwkv6-3b",
                                  "recurrentgemma-2b", "whisper-tiny"])
def test_remat_gives_the_gradients_of_none(arch, remat):
    _, jp, model = _pair(arch)
    batch = _tb(_np_batch(model.cfg, 2, 32, seed=5))
    loss0, g0 = loss_and_grads(model, model.master_params(), batch)
    rm = make_model(model.cfg.with_(remat=remat), "cpu").load_params(
        model.state_dict())
    loss1, g1 = loss_and_grads(rm, rm.master_params(), batch)
    assert abs(float(loss0) - float(loss1)) <= LOSS_TOL
    _close_trees(g1, g0, **GRAD_TOL)


def test_dots_remat_keeps_projections_and_recomputes_the_rest():
    """"dots" saves the matmuls without batch dims: its backward runs no
    projection again, "full" runs every one again."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n[func] = self.n.get(func, 0) + 1
            return func(*args, **(kwargs or {}))

    _, _, model = _pair("qwen3-0.6b")
    batch = _tb(_np_batch(model.cfg, 2, 16, seed=6))
    mm = torch.ops.aten.mm.default
    counts = {}
    for remat in ("none", "full", "dots"):
        m = make_model(model.cfg.with_(remat=remat), "cpu").load_params(
            model.state_dict())
        leaves = {k: v.detach().requires_grad_()
                  for k, v in m.master_params().items()}
        loss = m.loss(batch, leaves)
        with Count() as c:
            torch.autograd.grad(loss, list(leaves.values()))
        counts[remat] = c.n.get(mm, 0)
    # "full" runs a layer's projections again up to the last one the
    # backward needs (w_down's output is not: the recompute stops before
    # it), "dots" none
    assert counts["full"] == counts["none"] + 6 * model.cfg.n_layers
    assert counts["dots"] == counts["none"]


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_schedule_matches_reference(schedule):
    for warm in (0, 10):
        cfg = dict(lr=1e-3, warmup_steps=warm, total_steps=100,
                   schedule=schedule)
        tc, jc = topt.AdamWConfig(**cfg), jopt.AdamWConfig(**cfg)
        got = [float(topt.lr_at(tc, s)) for s in range(0, 110)]
        want = [float(jopt.lr_at(jc, s)) for s in range(0, 110)]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        assert topt.lr_at(tc, torch.tensor(5, dtype=torch.int32)).dtype \
            == torch.float32
    tc = topt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    assert float(topt.lr_at(tc, 0)) == 0.0
    assert float(topt.lr_at(tc, 100)) == pytest.approx(1e-4, rel=1e-3)


def test_decay_mask_matches_reference_on_every_arch():
    assert ARCH_IDS == J_ARCH_IDS
    for arch in ARCH_IDS:
        jm = jmake(jget(arch, reduced=True))
        flags = jax.tree_util.tree_map_with_path(
            lambda p, s: np.full(s.shape, jopt._decay_mask(p)),
            jm.param_shapes())
        cfg = get_config(arch, reduced=True)
        want = interop.model_params(flags, cfg)
        assert set(want) == set(make_model(cfg, "meta").state_dict())
        for k, v in want.items():
            assert v.numpy().all() == topt.decays(k) \
                and v.numpy().any() == topt.decays(k), (arch, k)
    assert not topt.decays("layers.3.tm.bonus_u")
    assert not topt.decays("dec_layers.1.mlp.b_up")
    assert topt.decays("layers.3.attn.wq")


@pytest.mark.parametrize("arch", ["rwkv6-3b", "whisper-tiny"])
def test_adamw_steps_match_reference(arch):
    jm, jp, model = _pair(arch)
    value_and_grad = _ref(arch)[2]
    cfg = dict(lr=1e-3, warmup_steps=1, weight_decay=0.1, grad_clip=1.0)
    tc, jc = topt.AdamWConfig(**cfg), jopt.AdamWConfig(**cfg)
    params = model.master_params()
    jparams = jax.tree.map(jnp.asarray, jp)
    state, jstate = topt.init_opt_state(params), jopt.init_opt_state(jparams)
    for s in range(2):  # a second step on the moments the first made
        _, jg = value_and_grad(
            jparams, _jb(_np_batch(model.cfg, 2, 32, seed=10 + s)))
        grads = interop.model_params(jax.tree.map(np.asarray, jg), model.cfg)
        before = {k: v.clone() for k, v in params.items()}
        params2, state, m = topt.adamw_update(tc, params, grads, state)
        jparams, jstate, jm_ = jopt.adamw_update(jc, jparams, jg, jstate)
        # pure: the inputs are left as they were
        assert all(torch.equal(before[k], params[k]) for k in params)
        params = params2
        assert int(state["count"]) == int(jstate["count"]) == s + 1
        assert state["count"].dtype == torch.int32
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm_["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm_["lr"]),
                                   rtol=1e-6)
        for name in ("mu", "nu"):
            _close_trees(state[name], interop.model_params(
                jax.tree.map(np.asarray, jstate[name]), model.cfg),
                **GRAD_TOL)
        _close_trees(params, interop.model_params(
            jax.tree.map(np.asarray, jparams), model.cfg), **PARAM_TOL)


def test_train_step_matches_reference():
    from repro.train.train_step import TrainConfig as JTrainConfig
    from repro.train.train_step import make_train_step as jmake_step

    jm, jp, model = _pair("qwen3-0.6b")
    opt = dict(lr=1e-3, warmup_steps=2)
    step = make_train_step(model, TrainConfig(opt=topt.AdamWConfig(**opt)))
    jstep = jax.jit(jmake_step(jm, JTrainConfig(opt=jopt.AdamWConfig(**opt))))
    params = model.master_params()
    state = topt.init_opt_state(params)
    jparams = jax.tree.map(jnp.asarray, jp)
    jstate = jopt.init_opt_state(jparams)
    for s in range(3):
        batch = _np_batch(model.cfg, 4, 33, seed=20 + s)
        params, state, m = step(params, state, _tb(batch), s)
        jparams, jstate, jm_ = jstep(jparams, jstate, _jb(batch), s)
        assert abs(float(m["loss"]) - float(jm_["loss"])) <= LOSS_TOL
    # three steps on each package's own gradients: Adam's update is about
    # lr * sign(g), so an element whose gradient sits at the noise floor
    # of the two float32 backward passes may move either way, by at most
    # 2·lr a step; every other element agrees within 1e-6
    want = interop.model_params(jax.tree.map(np.asarray, jparams), model.cfg)
    off = total = 0
    for k, v in want.items():
        d = (params[k] - v).abs()
        assert float(d.max()) <= 2 * 1e-3 * 3, k
        off += int((d > PARAM_TOL["atol"]).sum())
        total += d.numel()
    assert off <= total * 1e-4, (off, total)


# ---------------------------------------------------------------------------
# Microbatching
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["loop", "unroll"])
def test_microbatch_equals_full_batch(impl):
    _, _, model = _pair("qwen3-0.6b")
    params = model.master_params()
    opt = topt.init_opt_state(params)
    b = _tb(_np_batch(model.cfg, 8, 33, seed=0))
    t1 = make_train_step(model, TrainConfig())
    t4 = make_train_step(model, TrainConfig(microbatches=4,
                                            microbatch_impl=impl))
    p1, o1, m1 = t1(params, opt, b, 0)
    p4, o4, m4 = t4(params, opt, b, 0)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-5
    _close_trees(o4["mu"], o1["mu"], **GRAD_TOL)
    _close_trees(p4, p1, **PARAM_TOL)
    # and the 4 microbatches' mean gradient is the reference's
    grads = [_ref_loss_grads("qwen3-0.6b", {
        "tokens": b["tokens"][i * 2:(i + 1) * 2].numpy()})[1]
        for i in range(4)]
    mean = {k: sum(g[k] for g in grads) / 4 for k in grads[0]}
    # mu after one step is (1 - b1) times the clipped gradient
    scale = min(1.0, 1.0 / float(m4["grad_norm"]))
    _close_trees({k: v / (0.1 * scale) for k, v in o4["mu"].items()}, mean,
                 **GRAD_TOL)


def test_microbatch_impl_is_checked():
    _, _, model = _pair("qwen3-0.6b")
    with pytest.raises(ValueError, match="microbatch_impl"):
        make_train_step(model, TrainConfig(microbatch_impl="scan"))


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------
def test_quantize_int8_bit_for_bit_on_reference_noise():
    rng = np.random.default_rng(0)
    for shape, mul in (((256, 64), 3.0), ((7,), 1e-3), ((3, 5, 2), 1e4)):
        x = (rng.normal(size=shape) * mul).astype(np.float32)
        key = jax.random.key(int(mul))
        jq, js = jcomp.quantize_int8(jnp.asarray(x), key)
        noise = jax.random.uniform(key, shape, jnp.float32, -0.5, 0.5)
        q, s = comp.quantize_int8(torch.from_numpy(x), None,
                                  noise=torch.from_numpy(np.array(noise)))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
        np.testing.assert_array_equal(
            comp.dequantize_int8(q, s).numpy(),
            np.asarray(jcomp.dequantize_int8(jq, js)))


def test_quantize_int8_own_noise_within_a_step_and_unbiased():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(256, 64)).astype(np.float32)) * 3
    g = torch.Generator().manual_seed(0)
    q, s = comp.quantize_int8(x, g)
    assert float((comp.dequantize_int8(q, s) - x).abs().max()) \
        <= float(s) * 1.01
    outs = [comp.dequantize_int8(*comp.quantize_int8(
        x, torch.Generator().manual_seed(i))) for i in range(20)]
    assert float((sum(outs) / len(outs) - x).abs().mean()) < float(s) * 0.3
    # the same generator state gives the same bits
    q2, _ = comp.quantize_int8(x, torch.Generator().manual_seed(0))
    assert torch.equal(q, q2)


def test_compressed_psum_matches_reference_under_vmap():
    rng = np.random.default_rng(1)
    n = 4
    trees = [{"w": (rng.normal(size=(16, 8)) * (i + 1)).astype(np.float32),
              "b": rng.normal(size=(8,)).astype(np.float32)}
             for i in range(n)]
    key = jax.random.key(7)
    stacked = {k: jnp.stack([t[k] for t in trees]) for k in trees[0]}
    want = jax.vmap(lambda t: jcomp.compressed_psum(t, key, "pod"),
                    axis_name="pod")(stacked)
    # the reference's per-leaf keys, in its (sorted) leaf order
    keys = jax.random.split(key, 2)
    noise = {name: torch.from_numpy(np.array(jax.random.uniform(
        k, trees[0][name].shape, jnp.float32, -0.5, 0.5)))
        for name, k in zip(sorted(trees[0]), keys)}
    got = comp.compressed_psum(
        [{k: torch.from_numpy(v) for k, v in t.items()} for t in trees],
        None, noise=noise)
    for k in trees[0]:
        for i in range(n):  # every participant receives the same tree
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k][i]))
    # with its own noise: within one (largest) step of the reference's
    # function on exact values, sum(x_i / s_i) * s_max / n.  The sum is
    # dequantized with the largest scale, so with unequal scales it is not
    # the mean (a reference fault the port copies, ROADMAP Queue 3)
    own = comp.compressed_psum(
        [{k: torch.from_numpy(v) for k, v in t.items()} for t in trees],
        torch.Generator().manual_seed(0))
    for k in trees[0]:
        scales = [np.float32(max(np.abs(t[k]).max(), 1e-12) / 127)
                  for t in trees]
        smax = max(scales)
        exact = sum(t[k] / s for t, s in zip(trees, scales)) * smax / n
        assert np.abs(own[k].numpy() - exact).max() <= smax * 1.01
        mean = sum(t[k] for t in trees) / n
        assert np.abs(own[k].numpy() - mean).max() > 10 * smax


def test_compressed_train_step_is_seeded_by_step():
    _, _, model = _pair("qwen3-0.6b")
    params = model.master_params()
    opt = topt.init_opt_state(params)
    b = _tb(_np_batch(model.cfg, 2, 17, seed=0))
    # no clipping, so mu after one step is 0.1 x the gradient as sent
    opt_cfg = topt.AdamWConfig(grad_clip=0.0)
    step = make_train_step(model, TrainConfig(opt=opt_cfg,
                                              compress_grads=True, seed=3))
    plain = make_train_step(model, TrainConfig(opt=opt_cfg))
    p1, o1, m1 = step(params, opt, b, 5)
    p2, o2, _ = step(params, opt, b, 5)
    p3, o3, _ = step(params, opt, b, 6)
    _, o0, _ = plain(params, opt, b, 5)
    assert all(torch.equal(o1["mu"][k], o2["mu"][k]) for k in params)
    assert any(not torch.equal(o1["mu"][k], o3["mu"][k]) for k in params)
    for k in params:  # the lossy channel: within one step of the exact one
        step_k = o0["mu"][k].abs().max() / 127
        assert float((o1["mu"][k] - o0["mu"][k]).abs().max()) \
            <= float(step_k) * 1.01 + 1e-12


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------
def _state(model):
    params = model.master_params()
    return {"params": params, "opt": topt.init_opt_state(params)}


def test_checkpoint_roundtrip_and_gc(tmp_path):
    _, _, model = _pair("qwen3-0.6b")
    tree = _state(model)
    d = str(tmp_path / "ck")
    for step in (5, 10, 15, 20):
        ckpt.save_checkpoint(d, step, tree, wait=True)
    assert ckpt.latest_step(d) == 20
    ckpt.keep_last(d, 2)
    steps = sorted(int(x.split("_")[1]) for x in os.listdir(d)
                   if x.startswith("step_"))
    assert steps == [15, 20]
    got, step = ckpt.restore_checkpoint(d, tree)
    assert step == 20
    for (pa, a), (pb, b) in zip(ckpt.flatten(got), ckpt.flatten(tree)):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b)
    mesh = make_host_mesh(("data",), "cpu")
    got, step = elastic_restore(d, tree, mesh, validated_pspecs)
    assert step == 20 and torch.equal(got["opt"]["count"].full_tensor(),
                                      tree["opt"]["count"])
    for (pa, a), (pb, b) in zip(ckpt.flatten(got), ckpt.flatten(tree)):
        assert pa == pb and a.device_mesh == mesh
        assert torch.equal(a.full_tensor(), b)
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "none"), tree)


def test_checkpoint_faults_raise(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.int32)}}
    ckpt.save_checkpoint(d, 1, tree)
    with pytest.raises(KeyError):
        ckpt.restore_checkpoint(d, dict(tree, z=torch.zeros(1)))
    with pytest.raises(ValueError):
        ckpt.restore_checkpoint(d, dict(tree, a=torch.zeros(3, 2)))
    manifest = json.load(open(os.path.join(d, "step_1", "manifest.json")))
    leaf = next(m for m in manifest["leaves"] if m["path"] == "b/c")
    np.save(os.path.join(d, "step_1", leaf["file"]),
            np.array([1, 1, 2, 1], np.int32))
    with pytest.raises(IOError, match="b/c"):
        ckpt.restore_checkpoint(d, tree)
    got, _ = ckpt.restore_checkpoint(d, tree, verify=False)
    assert got["b"]["c"].tolist() == [1, 1, 2, 1]


def test_checkpoint_bf16_leaf_roundtrips(tmp_path):
    d = str(tmp_path / "ck")
    x = torch.randn(5, 7, generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    ckpt.save_checkpoint(d, 3, {"w": x, "s": torch.tensor(2.5)})
    manifest = json.load(open(os.path.join(d, "step_3", "manifest.json")))
    assert {m["path"]: m["dtype"] for m in manifest["leaves"]} == {
        "s": "float32", "w": "bfloat16"}
    got, _ = ckpt.restore_checkpoint(d, {"w": torch.zeros(5, 7,
                                                          dtype=torch.bfloat16),
                                         "s": torch.zeros(())})
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), x.view(torch.int16))


def test_checkpoint_format_is_the_references(tmp_path):
    """A flat tree of numpy arrays: both packages write the same manifest,
    and what the reference wrote restores through the port."""
    rng = np.random.default_rng(0)
    tree = {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "count": np.asarray(7, np.int32),
            "a_ids": rng.integers(0, 9, 5).astype(np.int64)}
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    jckpt.save_checkpoint(jd, 9, tree, wait=True)
    ckpt.save_checkpoint(td, 9, {k: torch.from_numpy(v)
                                 for k, v in tree.items()})
    read = [json.load(open(os.path.join(x, "step_9", "manifest.json")))
            for x in (jd, td)]
    assert read[0] == read[1]
    like = {k: torch.zeros(v.shape, dtype=torch.from_numpy(v).dtype)
            for k, v in tree.items()}
    got, step = ckpt.restore_checkpoint(jd, like)
    assert step == 9
    for k, v in tree.items():
        np.testing.assert_array_equal(got[k].numpy(), v)


def test_reads_wait_for_the_pending_async_save(tmp_path):
    """A restore right after an async save reads the step being written,
    whole, not the one before it or a directory being replaced."""
    d = str(tmp_path / "ck")
    big = {f"w{i}": torch.full((1 << 20,), float(i)) for i in range(16)}
    ckpt.save_checkpoint(d, 2, big)
    for step in (4, 4, 6):  # step 4 twice: the writer replaces step_4
        ckpt.save_checkpoint(d, step, {k: v + step for k, v in big.items()},
                             wait=False)
        got, at = ckpt.restore_checkpoint(d, big)
        assert at == step == ckpt.latest_step(d)
        assert all(float(got[k][0]) == float(v[0]) + step
                   for k, v in big.items())


def test_async_save_copies_before_returning(tmp_path):
    """The caller may write into a leaf right after an async save returns:
    the checkpoint holds the values at the call."""
    d = str(tmp_path / "ck")
    x = torch.zeros(1 << 16, dtype=torch.float32)
    t = ckpt.save_checkpoint(d, 1, {"x": x}, wait=False)
    x.fill_(1.0)
    t.join(timeout=60)
    assert not t.is_alive()
    got, _ = ckpt.restore_checkpoint(d, {"x": x})
    assert float(got["x"].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# Supervisor
# ---------------------------------------------------------------------------
def _batches(vocab):
    def batch(step, b=8, t=33):
        rng = np.random.default_rng(step)
        return {"tokens": torch.from_numpy(
            rng.integers(0, vocab, (b, t)).astype(np.int32))}
    return batch


def test_supervisor_restart_and_retry(tmp_path, deterministic):
    _, _, model = _pair("qwen3-0.6b")
    step_fn = make_train_step(model, TrainConfig())
    batch = _batches(32)
    d = str(tmp_path / "sup")
    sup = Supervisor(ckpt_dir=d, ckpt_every=5)
    state = dict(_state(model), step=0)
    state, _ = sup.run(state=state, train_step=step_fn, batch_fn=batch,
                       num_steps=8, log_every=0, log=lambda *a: None)
    assert state["step"] == 8 and ckpt.latest_step(d) == 8

    fails = {"n": 2}
    logs = []

    def flaky(params, opt, b, step):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise RuntimeError("simulated node failure")
        return step_fn(params, opt, b, step)

    state2 = dict(_state(model), step=0)
    state2, _ = sup.run(state=state2, train_step=flaky, batch_fn=batch,
                        num_steps=12, log_every=0, log=logs.append)
    assert state2["step"] == 12  # resumed from ckpt and completed
    assert logs[0] == "[supervisor] restored step 8"
    assert sum("simulated node failure" in x for x in logs) == 2

    # the restart replays the stream: equal to 12 uninterrupted steps
    ref = dict(_state(model), step=0)
    ref, _ = Supervisor(ckpt_dir=str(tmp_path / "ref"), ckpt_every=100).run(
        state=ref, train_step=step_fn, batch_fn=batch, num_steps=12,
        log_every=0, log=lambda *a: None)
    for k in ref["params"]:
        assert torch.equal(ref["params"][k], state2["params"][k]), k

    # a failure right after an async checkpoint: the retry restores the
    # step being written (the card's steps outrun the writer)
    fails["n"] = 2

    def after_ckpt(params, opt, b, step):
        if step == 5 and fails["n"] > 0:
            fails["n"] -= 1
            raise RuntimeError("simulated node failure")
        return step_fn(params, opt, b, step)

    state3, _ = Supervisor(ckpt_dir=str(tmp_path / "every2"),
                           ckpt_every=2).run(
        state=dict(_state(model), step=0), train_step=after_ckpt,
        batch_fn=batch, num_steps=12, log_every=0, log=lambda *a: None)
    for k in ref["params"]:
        assert torch.equal(ref["params"][k], state3["params"][k]), k

    # more failures than retries raise
    fails["n"] = 5
    with pytest.raises(RuntimeError, match="simulated"):
        Supervisor(ckpt_dir=str(tmp_path / "x"), max_retries=3).run(
            state=dict(_state(model), step=0), train_step=flaky,
            batch_fn=batch, num_steps=2, log_every=0, log=lambda *a: None)


def test_straggler_watchdog():
    events = []
    wd = StragglerWatchdog(deadline_s=0.5,
                           on_straggler=lambda s, d: events.append(s))
    wd.observe(1, 0.1)
    wd.observe(2, 1.2)
    assert events == [2] and wd.events == [(2, 1.2)]


SIGTERM_SCRIPT = textwrap.dedent("""
    import os, signal, sys
    sys.path.insert(0, %r)
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import make_model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.fault import Supervisor
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import TrainConfig, make_train_step

    cfg = get_config("qwen3-0.6b", reduced=True)
    model = make_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    step_fn = make_train_step(model, TrainConfig())

    def preempting(params, opt, batch, step):
        if step == 3:  # the scheduler preempts while the step runs
            os.kill(os.getpid(), signal.SIGTERM)
        return step_fn(params, opt, batch, step)

    def batch(step):
        g = torch.Generator().manual_seed(step)
        return {"tokens": torch.randint(0, cfg.vocab, (2, 16), generator=g,
                                        dtype=torch.int32)}

    d = %r
    params = model.master_params()
    state = {"params": params, "opt": init_opt_state(params), "step": 0}
    state, _ = Supervisor(ckpt_dir=d, ckpt_every=100).run(
        state=state, train_step=preempting, batch_fn=batch, num_steps=10,
        log_every=0)
    assert state["step"] == 4, state["step"]
    assert ckpt.latest_step(d) == 4
    tree, step = ckpt.restore_checkpoint(d, {"params": state["params"],
                                             "opt": state["opt"]})
    assert step == 4 and int(tree["opt"]["count"]) == 4
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL
    print("OK")
""")


def test_sigterm_drains_a_final_save(tmp_path):
    d = str(tmp_path / "pre")
    r = subprocess.run([sys.executable, "-c", SIGTERM_SCRIPT % (SRC, d)],
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "OK" in r.stdout
    assert "preempted at step 4; final checkpoint written" in r.stdout


# ---------------------------------------------------------------------------
# The default dtype (ROADMAP Queue 3 item 5)
# ---------------------------------------------------------------------------
def _x64_step(tmp_path, model, batch, mesh=None):
    """A compressed, microbatched train step, a checkpoint save and its
    restore (placed on `mesh` by `validated_pspecs` where one is given);
    returns everything they made, whole."""
    params = model.master_params()
    if mesh is not None:
        params, batch = place_params(params, mesh), place_batch(batch, mesh)
    opt = topt.init_opt_state(params)
    step = make_train_step(model, TrainConfig(
        microbatches=2, compress_grads=True,
        opt=topt.AdamWConfig(lr=1e-3, warmup_steps=1)))
    p, o, m = step(params, opt, batch, 0)
    d = str(tmp_path / f"x64_{len(os.listdir(tmp_path))}")
    ckpt.save_checkpoint(d, 1, {"params": p, "opt": o})
    tree, _ = ckpt.restore_checkpoint(d, {"params": p, "opt": o})
    return [full_tensor(x)
            for _, x in ckpt.flatten({"p": p, "o": o, "m": m, "r": tree})]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_train_path_ignores_a_udf_holding_float64_default(tmp_path, arch,
                                                         deterministic):
    """A UDF held open in another thread keeps torch's default dtype at
    float64 for the whole process (`core.invoke._x64`); a train step run
    meanwhile, plain and placed on the one-rank mesh, gives the bits the
    plain step gives without it, and nothing float64."""
    _, _, model = _pair(arch)
    batch = _tb(_np_batch(model.cfg, 4, 32, seed=0))
    mesh = make_host_mesh(("data",), "cpu")
    want = _x64_step(tmp_path, model, batch)

    inside, release = threading.Event(), threading.Event()

    def udf(ir, out):
        inside.set()
        release.wait(timeout=120)

    th = threading.Thread(target=invoke.run_map_udf,
                          args=(udf, {"x": torch.zeros(1,
                                                       dtype=torch.int64)}))
    th.start()
    try:
        assert inside.wait(timeout=60)
        assert torch.get_default_dtype() == torch.float64
        got = _x64_step(tmp_path, model, batch)
        placed = _x64_step(tmp_path, model, batch, mesh)
    finally:
        release.set()
        th.join(timeout=60)
    assert not th.is_alive()
    assert torch.get_default_dtype() == torch.float32
    assert len(got) == len(want) == len(placed)
    for a, b, c in zip(got, want, placed):
        assert a.dtype == b.dtype == c.dtype and a.dtype != torch.float64
        assert torch.equal(a, b) and torch.equal(c, b)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------
def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    d = str(tmp_path / "launch")
    state = ttrain.main(["--arch", "qwen3-0.6b", "--reduced", "--device",
                         "cpu", "--steps", "3", "--batch", "2", "--seq",
                         "16", "--ckpt-dir", d])
    out = capsys.readouterr().out
    assert state["step"] == 3 and ckpt.latest_step(d) == 3
    assert "pipeline plan: domains->DomainWeight->docs->QualityFilter" in out
    assert "[step 0] loss=" in out
    assert "[train] finished at step 3" in out


def test_launcher_runs_on_cuda_unless_told_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--reduced", "--steps", "1", "--ckpt-dir",
                     str(tmp_path / "c")])
