"""The port's encdec (whisper) and vlm (phi-3-vision) families against the
reference, the Engine's greedy tokens for the vlm and moe families, and the
launcher for the moe and vlm archs.

Layers get the same numpy-seeded parameters and inputs in both packages;
models get the reference's initial weights through
`interop.model_params`.  Stated tolerances: float32 layers 1e-5 (bf16
LayerNorm 1e-2, one bf16 step); logits atol 2e-3 / rtol 1e-3 (as
`tests/test_torch_models.py` holds them); greedy tokens exactly.  On the
CPU the port's flash path runs the kernel's plain version and the
reference's runs its Pallas kernel in interpret mode.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import layers as JL
from repro.models import make_model as jmake
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JConfig
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import Request as JRequest
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as TL
from repro_torch.models import make_model
from repro_torch.models import transformer as TT
from repro_torch.models.config import ModelConfig
from repro_torch.serve.engine import Engine, Request

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-3, atol=2e-3)
CPU = torch.device("cpu")
WHISPER, PHI = "whisper-tiny", "phi-3-vision-4.2b"


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _pair(arch, impl="xla", seed=0):
    """The reference model, its weights, and the port's model on them."""
    jcfg = jget(arch, reduced=True, attn_impl=impl)
    tcfg = get_config(arch, reduced=True, attn_impl=impl)
    jm = jmake(jcfg)
    params = jm.init(jax.random.key(seed))
    tm = make_model(tcfg, CPU).load_params(
        interop.model_params(jax.tree.map(np.asarray, params), tcfg))
    return jm, params, tm


def _inputs(cfg, b, t, rng, img=True):
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)}
    if cfg.family == "vlm" and img:
        batch["img_embeds"] = rng.normal(
            size=(b, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["audio_frames"] = rng.normal(
            size=(b, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: _t(v) for k, v in batch.items()})


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dt):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 7, 48)) * 3 + 1).astype(np.float32)
    p = {"scale": (1 + rng.normal(size=48) / 4).astype(np.float32),
         "bias": rng.normal(size=48).astype(np.float32)}
    tol = LAYER_TOL if dt == "float32" else dict(rtol=1e-2, atol=1e-2)
    jdt, tdt = (jnp.float32, torch.float32) if dt == "float32" \
        else (jnp.bfloat16, torch.bfloat16)
    want = JL.layernorm(jax.tree.map(jnp.asarray, p), jnp.asarray(x, jdt))
    got = TL.layernorm(jax.tree.map(_t, p), _t(x).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    init = TL.init_layernorm(48, torch.float32, CPU)
    assert torch.equal(init["scale"], torch.ones(48))
    assert torch.equal(init["bias"], torch.zeros(48))


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_cross_attention_matches_reference(impl):
    # decoder queries (T = 5) over encoder keys and values (S = 16) through
    # kv_override: non-causal, no rope
    kw = dict(n_layers=1, d_model=64, n_heads=4, d_ff=128, vocab=256,
              dtype="float32", attn_impl=impl)
    jcfg = JConfig(name="x", family="encdec", **kw)
    tcfg = ModelConfig(name="x", family="encdec", **kw)
    rng = np.random.default_rng(3)
    p = {n: (rng.normal(size=(64, 64)) / 8).astype(np.float32)
         for n in ("wq", "wk", "wv", "wo")}
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    enc = rng.normal(size=(2, 16, 64)).astype(np.float32)
    jp, tp = jax.tree.map(jnp.asarray, p), jax.tree.map(_t, p)
    jkv = JT._cross_kv(jp, jcfg, jnp.asarray(enc))
    tkv = TT._cross_kv(tp, tcfg, _t(enc))
    for a, b in zip(tkv, jkv):
        assert a.shape == (2, 4, 16, 16)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **LAYER_TOL)
    want = JL.attention_block(jp, jcfg, jnp.asarray(x), jnp.arange(5),
                              causal=False, use_rope=False, kv_override=jkv)
    got = TL.attention_block(tp, tcfg, _t(x), torch.arange(5), causal=False,
                             use_rope=False, kv_override=tkv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def test_encode_matches_reference():
    jm, params, tm = _pair(WHISPER)
    rng = np.random.default_rng(4)
    frames = rng.normal(size=(2, tm.cfg.n_audio_frames, tm.cfg.d_model))
    want = JT.encode(params, jm.cfg, jnp.asarray(frames, jnp.float32))
    got = TT.encode(tm.params(), tm.cfg, _t(frames).float())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", [WHISPER, PHI])
def test_model_params_cover_the_state_dict(arch):
    jm, params, tm = _pair(arch)
    sd = interop.model_params(jax.tree.map(np.asarray, params), tm.cfg)
    assert set(sd) == set(tm.state_dict())
    assert tm.param_count() == sum(int(np.prod(a.shape))
                                   for a in jax.tree.leaves(params))
    if arch == PHI:
        np.testing.assert_array_equal(sd["img_proj"].numpy(),
                                      np.asarray(params["img_proj"]))
    else:
        assert "dec_layers.1.cross_attn.wk" in sd and "unembed.table" not in sd
        np.testing.assert_array_equal(
            sd["enc_layers.1.ln2.bias"].numpy(),
            np.asarray(params["enc_layers"]["ln2"]["bias"][1]))
        np.testing.assert_array_equal(sd["dec_pos"].numpy(),
                                      np.asarray(params["dec_pos"]))


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("arch,img", [(WHISPER, False), (PHI, True),
                                      (PHI, False)])
def test_model_matches_reference(arch, img, impl):
    # forward, prefill and four decode steps on the reference's weights;
    # the vlm with and without its image prefix
    jm, params, tm = _pair(arch, impl, seed=1)
    b, t = 2, 24
    jb, tb = _inputs(tm.cfg, b, t, np.random.default_rng(5), img)
    jlogits = jax.jit(jm.logits)
    jl, _ = jlogits(params, jb)
    tl, aux = tm.logits(tb)
    assert tl.shape == (b, t, tm.cfg.padded_vocab) and float(aux) == 0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)

    js, ts = jm.init_decode_state(b, t + 8), tm.init_decode_state(b, t + 8)
    jl, js = jax.jit(jm.prefill)(params, jb, js)
    tl, ts = tm.prefill(tb, ts)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    if arch == WHISPER:
        np.testing.assert_allclose(ts["enc"].numpy(), np.asarray(js["enc"]),
                                   **LAYER_TOL)
    jdecode = jax.jit(jm.decode_step)
    for _ in range(4):
        tok = np.argmax(np.asarray(jl)[:, -1], -1)[:, None].astype(np.int32)
        jl, js = jdecode(params, jnp.asarray(tok), js)
        tl, ts = tm.decode_step(_t(tok), ts)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    caches = ts["self"] if arch == WHISPER else ts
    assert all(c["pos"] == t + 4 for c in caches)


def test_encdec_prefill_needs_audio_frames():
    # the Engine sends tokens only: both packages fail whisper's prefill,
    # the reference with a KeyError, the port naming the missing input
    jm, params, tm = _pair(WHISPER)
    toks = np.zeros((1, 4), np.int32)
    with pytest.raises(KeyError, match="audio_frames"):
        jm.prefill(params, {"tokens": jnp.asarray(toks)},
                   jm.init_decode_state(1, 8))
    with pytest.raises(ValueError, match="audio_frames"):
        tm.prefill({"tokens": _t(toks)}, tm.init_decode_state(1, 8))
    with pytest.raises(ValueError, match="audio_frames"):
        Engine(tm, batch_slots=1, max_seq=8).generate(
            [Request(prompt=toks[0], max_new_tokens=2)])


def _requests(cls, vocab, seed, n=5):
    rng = np.random.default_rng(seed)
    return [cls(prompt=rng.integers(0, vocab, rng.integers(3, 16))
                .astype(np.int32), max_new_tokens=int(rng.integers(2, 7)))
            for _ in range(n)]


@pytest.mark.parametrize("arch", [PHI, "qwen2-moe-a2.7b"])
def test_engine_greedy_tokens_match_reference(arch):
    # 5 requests over 2 slots, ragged prompts (left-padded with token 0,
    # which takes MoE capacity like any token) and ragged max_new_tokens;
    # the vlm is served as text alone, as the reference's Engine serves it
    jm, params, tm = _pair(arch, seed=2)
    jr = JEngine(jm, params, batch_slots=2, max_seq=32).generate(
        _requests(JRequest, tm.cfg.vocab, 6))
    tr = Engine(tm, batch_slots=2, max_seq=32).generate(
        _requests(Request, tm.cfg.vocab, 6))
    for a, b in zip(tr, jr):
        assert a.out_tokens == b.out_tokens and a.done and b.done
        assert len(a.out_tokens) == a.max_new_tokens


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mixtral-8x22b", PHI])
def test_launcher_serves_on_cpu(arch, capsys):
    tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                 "--requests", "3", "--max-new", "3"])
    out = capsys.readouterr().out
    family = get_config(arch).family
    assert f"({family}, xla attention): 3 requests, 9 tokens" in out
