"""The port's model plane (dense family) against the reference.

Layers get the same numpy-seeded parameters and inputs in both packages;
models get the reference's initial weights through `interop.model_params`.
Stated tolerances: float32 layers 1e-5; logits atol 2e-3 / rtol 1e-3 (as
`tests/test_models.py` holds flash against xla); greedy tokens exactly.
On the CPU the port's flash path runs the kernel's plain version and the
reference's runs its Pallas kernel in interpret mode.
"""

from __future__ import annotations

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as jget
from repro.models import layers as JL
from repro.models import make_model as jmake
from repro.models.config import ModelConfig as JConfig
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import Request as JRequest
from repro_torch import interop
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as TL
from repro_torch.models import make_model
from repro_torch.models import transformer as TT
from repro_torch.models.config import ModelConfig
from repro_torch.serve.engine import Engine, Request

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-3, atol=2e-3)
CPU = torch.device("cpu")

BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab=256, dtype="float32")
LAYER_CFGS = {
    "plain": dict(),
    "qwen_style": dict(qkv_bias=True, qk_norm=True),
    "swa": dict(window=8),
}


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _cfgs(extra):
    kw = {**BASE, **extra}
    return (JConfig(name="t", family="dense", **kw),
            ModelConfig(name="t", family="dense", **kw))


def _attn_params(cfg, rng):
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    p = {"wq": rng.normal(size=(d, hq * dh)) / 8,
         "wk": rng.normal(size=(d, hkv * dh)) / 8,
         "wv": rng.normal(size=(d, hkv * dh)) / 8,
         "wo": rng.normal(size=(hq * dh, d)) / 8}
    if cfg.qkv_bias:
        for n, w in (("bq", hq), ("bk", hkv), ("bv", hkv)):
            p[n] = rng.normal(size=(w * dh,)) / 4
    if cfg.qk_norm:
        p["q_norm"] = {"scale": 1 + rng.normal(size=(dh,)) / 4}
        p["k_norm"] = {"scale": 1 + rng.normal(size=(dh,)) / 4}
    return jax.tree.map(lambda a: np.asarray(a, np.float32), p)


def _both(tree):
    return jax.tree.map(jnp.asarray, tree), jax.tree.map(_t, tree)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
def test_registry_matches_reference():
    assert ARCH_IDS == J_ARCH_IDS
    for arch in ARCH_IDS:
        for reduced in (False, True):
            t, j = get_config(arch, reduced), jget(arch, reduced)
            assert dataclasses.asdict(t) == dataclasses.asdict(j), arch
            assert (t.padded_vocab, t.kv_heads, t.head_dim,
                    t.param_count()) == (j.padded_vocab, j.kv_heads,
                                         j.head_dim, j.param_count())
            assert str(t.act_dtype)[6:] == str(j.act_dtype)
            assert str(t.p_dtype)[6:] == str(j.p_dtype)
    cfg = get_config("qwen3-0.6b", attn_impl="flash")
    assert (cfg.n_layers, cfg.d_model, cfg.padded_vocab, cfg.attn_impl) == \
        (28, 1024, 151936, "flash")
    assert cfg.with_(d_model=8).d_model == 8


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rmsnorm_and_rope_match_reference(dt):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, 10, 32)).astype(np.float32)
    scale = (1 + rng.normal(size=(32,)) / 4).astype(np.float32)
    pos = np.arange(5, 15)
    tol = LAYER_TOL if dt == "float32" else dict(rtol=1e-2, atol=1e-2)
    jx = jnp.asarray(x, jnp.bfloat16 if dt == "bfloat16" else jnp.float32)
    tx = _t(x).to(torch.bfloat16 if dt == "bfloat16" else torch.float32)
    got = TL.rmsnorm({"scale": _t(scale)}, tx, 1e-6)
    want = JL.rmsnorm({"scale": jnp.asarray(scale)}, jx, 1e-6)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    got = TL.rope(tx, _t(pos), 1e6)
    want = JL.rope(jx, jnp.asarray(pos), 1e6)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("name", list(LAYER_CFGS))
@pytest.mark.parametrize("impl", ["xla", "blocked", "flash"])
def test_attention_prefill_and_decode_match_reference(name, impl):
    jcfg, tcfg = _cfgs({**LAYER_CFGS[name], "attn_impl": impl})
    rng = np.random.default_rng(1)
    jp, tp = _both(_attn_params(tcfg, rng))
    # the windowed cache is a ring of `window` slots that decode wraps
    b, t = 2, 8
    seq = t + 12 if tcfg.window is None else tcfg.window
    x = rng.normal(size=(b, t, tcfg.d_model)).astype(np.float32)
    pos = np.arange(t)
    jc = JL.init_kv_cache(jcfg, b, seq, window=jcfg.window)
    tc = TL.init_kv_cache(tcfg, b, seq, CPU, window=tcfg.window)
    jo, jc = JL.attention_prefill(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                                  jc, window=jcfg.window)
    to, tc = TL.attention_prefill(tp, tcfg, _t(x), _t(pos), tc,
                                  window=tcfg.window)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **LAYER_TOL)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               **LAYER_TOL)
    assert tc["pos"] == int(jc["pos"]) == t
    # past the ring buffer's end on the windowed config
    for _ in range(12):
        xt = rng.normal(size=(b, 1, tcfg.d_model)).astype(np.float32)
        jo, jc = JL.attention_decode(jp, jcfg, jnp.asarray(xt), jc,
                                     window=jcfg.window)
        to, tc = TL.attention_decode(tp, tcfg, _t(xt), tc, window=tcfg.window)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **LAYER_TOL)
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]),
                               **LAYER_TOL)
    assert tc["pos"] == int(jc["pos"])


def test_decode_with_bf16_cache_matches_reference():
    # the cache stays bf16; the port contracts float32 copies of it, the
    # reference contracts it in place with float32 accumulation
    jcfg, tcfg = _cfgs({"dtype": "bfloat16", "qk_norm": True})
    rng = np.random.default_rng(2)
    jp, tp = _both(_attn_params(tcfg, rng))
    jc = JL.init_kv_cache(jcfg, 2, 24)
    tc = TL.init_kv_cache(tcfg, 2, 24, CPU)
    for _ in range(6):
        x = rng.normal(size=(2, 1, tcfg.d_model)).astype(np.float32)
        jo, jc = JL.attention_decode(jp, jcfg, jnp.asarray(x, jnp.bfloat16),
                                     jc)
        to, tc = TL.attention_decode(tp, tcfg, _t(x).to(torch.bfloat16), tc)
        assert to.dtype == torch.bfloat16 and tc["k"].dtype == torch.bfloat16
        np.testing.assert_allclose(to.float().numpy(),
                                   np.asarray(jo, np.float32),
                                   rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("mlp", ["swiglu", "gelu"])
def test_mlps_match_reference(mlp):
    rng = np.random.default_rng(3)
    d, f = 32, 64
    if mlp == "swiglu":
        p = {"w_gate": rng.normal(size=(d, f)) / 6,
             "w_up": rng.normal(size=(d, f)) / 6,
             "w_down": rng.normal(size=(f, d)) / 8}
    else:
        p = {"w_up": rng.normal(size=(d, f)) / 6, "b_up": rng.normal(size=f),
             "w_down": rng.normal(size=(f, d)) / 8, "b_down": rng.normal(size=d)}
    p = jax.tree.map(lambda a: np.asarray(a, np.float32), p)
    jp, tp = _both(p)
    x = rng.normal(size=(2, 5, d)).astype(np.float32)
    jfn, tfn = ((JL.swiglu, TL.swiglu) if mlp == "swiglu"
                else (JL.gelu_mlp, TL.gelu_mlp))
    np.testing.assert_allclose(tfn(tp, _t(x)).numpy(),
                               np.asarray(jfn(jp, jnp.asarray(x))),
                               **LAYER_TOL)


# ---------------------------------------------------------------------------
# the model: qwen3-0.6b reduced, reference weights
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def qwen_params():
    cfg = jget("qwen3-0.6b", reduced=True)
    params = jmake(cfg).init(jax.random.key(0))
    return params, jax.tree.map(np.asarray, params)


def _pair(impl, qwen_params):
    params, np_params = qwen_params
    jcfg = jget("qwen3-0.6b", reduced=True, attn_impl=impl)
    tcfg = get_config("qwen3-0.6b", reduced=True, attn_impl=impl)
    tm = make_model(tcfg, CPU).load_params(
        interop.model_params(np_params, tcfg))
    return jmake(jcfg), params, tm


def test_model_params_cover_the_state_dict(qwen_params):
    cfg = get_config("qwen3-0.6b", reduced=True)
    sd = interop.model_params(qwen_params[1], cfg)
    m = make_model(cfg, CPU)
    assert set(sd) == set(m.state_dict())
    assert "layers.1.attn.q_norm.scale" in sd and "unembed.table" not in sd
    np.testing.assert_array_equal(
        sd["layers.1.mlp.w_up"].numpy(),
        qwen_params[1]["layers"]["mlp"]["w_up"][1])
    assert m.param_count() == sum(v.numel() for v in sd.values())


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_model_forward_prefill_decode_match_reference(impl, qwen_params):
    jm, params, tm = _pair(impl, qwen_params)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, tm.cfg.vocab, (2, 40)).astype(np.int32)
    jl, _ = jm.logits(params, {"tokens": jnp.asarray(toks)})
    tl, aux = tm.logits({"tokens": _t(toks).long()})
    assert tl.shape == (2, 40, tm.cfg.padded_vocab) and float(aux) == 0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)

    js = jm.init_decode_state(2, 64)
    ts = tm.init_decode_state(2, 64)
    jl, js = jm.prefill(params, {"tokens": jnp.asarray(toks)}, js)
    tl, ts = tm.prefill({"tokens": _t(toks).long()}, ts)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    for _ in range(4):
        tok = np.argmax(np.asarray(jl)[:, -1], -1)[:, None].astype(np.int32)
        jl, js = jm.decode_step(params, jnp.asarray(tok), js)
        tl, ts = tm.decode_step(_t(tok).long(), ts)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert all(c["pos"] == 44 for c in ts)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2.5-14b",
                                  "granite-20b"])
def test_other_dense_archs_match_reference(arch):
    # untied unembedding (qwen2.5, granite), qkv bias (qwen2.5), MQA and
    # the tanh-gelu MLP (granite)
    jcfg, tcfg = jget(arch, reduced=True), get_config(arch, reduced=True)
    jm = jmake(jcfg)
    params = jm.init(jax.random.key(1))
    tm = make_model(tcfg, CPU).load_params(
        interop.model_params(jax.tree.map(np.asarray, params), tcfg))
    toks = np.random.default_rng(9).integers(0, tcfg.vocab, (2, 24))
    jl, _ = jm.logits(params, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, _ = tm.logits({"tokens": _t(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    js, ts = jm.init_decode_state(2, 32), tm.init_decode_state(2, 32)
    jl, js = jm.prefill(params, {"tokens": jnp.asarray(toks, jnp.int32)}, js)
    tl, ts = tm.prefill({"tokens": _t(toks)}, ts)
    tok = np.argmax(np.asarray(jl)[:, -1], -1)[:, None]
    jl, _ = jm.decode_step(params, jnp.asarray(tok, jnp.int32), js)
    tl, _ = tm.decode_step(_t(tok), ts)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


def _requests(cls, vocab, seed, n=5):
    rng = np.random.default_rng(seed)
    return [cls(prompt=rng.integers(0, vocab, rng.integers(3, 20))
                .astype(np.int32), max_new_tokens=int(rng.integers(2, 7)))
            for _ in range(n)]


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_engine_greedy_tokens_match_reference(impl, qwen_params):
    jm, params, tm = _pair(impl, qwen_params)
    # 5 requests over 2 slots: two full chunks and a partial one, ragged
    # prompts (left-padded) and ragged max_new_tokens
    jr = JEngine(jm, params, batch_slots=2, max_seq=32).generate(
        _requests(JRequest, tm.cfg.vocab, 6))
    tr = Engine(tm, batch_slots=2, max_seq=32).generate(
        _requests(Request, tm.cfg.vocab, 6))
    for a, b in zip(tr, jr):
        assert a.out_tokens == b.out_tokens and a.done and b.done
        assert len(a.out_tokens) == a.max_new_tokens


def test_engine_temperature_sampling_is_seeded(qwen_params):
    _, _, tm = _pair("xla", qwen_params)

    def run(seed):
        reqs = _requests(Request, tm.cfg.vocab, 7, n=3)
        for r in reqs:
            r.temperature = 1.0
        return [r.out_tokens for r in
                Engine(tm, batch_slots=2, max_seq=32, seed=seed).generate(reqs)]

    a = run(0)
    assert a == run(0)
    assert all(0 <= t < tm.cfg.padded_vocab for toks in a for t in toks)


def test_eos_stops_a_request(qwen_params):
    _, _, tm = _pair("xla", qwen_params)
    first = Engine(tm, batch_slots=2, max_seq=32).generate(
        _requests(Request, tm.cfg.vocab, 8, n=2))
    reqs = _requests(Request, tm.cfg.vocab, 8, n=2)
    reqs[0].max_new_tokens = reqs[1].max_new_tokens = 6
    # as in the reference, only decoded tokens are checked against eos
    reqs[0].eos_id = first[0].out_tokens[1]
    Engine(tm, batch_slots=2, max_seq=32).generate(reqs)
    assert reqs[0].out_tokens == first[0].out_tokens[:2]
    assert reqs[1].out_tokens[:len(first[1].out_tokens)] == first[1].out_tokens


# ---------------------------------------------------------------------------
# entry points and initialisation
# ---------------------------------------------------------------------------
def test_entry_points_default_to_the_card():
    from repro_torch.models.model import Model

    assert inspect.signature(make_model).parameters["device"].default == "cuda"
    assert inspect.signature(Model).parameters["device"].default == "cuda"


def _paths(tree, prefix=""):
    """{dotted path: tensor} of a parameter tree (dicts and layer lists)."""
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_paths(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_draws_what_init_params_draws(arch):
    # every registered arch builds on the CPU, and `Model.init` draws each
    # leaf straight into its parameter: bit for bit the tree that
    # `transformer.init_params` draws from the same seed (the weights the
    # model drew before it filled leaf by leaf), in both parameter dtypes
    for pdt in ("float32", "bfloat16"):
        cfg = get_config(arch, reduced=True, param_dtype=pdt)
        sd = make_model(cfg, CPU).init(
            torch.Generator().manual_seed(7)).state_dict()
        want = _paths(TT.init_params(torch.Generator().manual_seed(7), cfg,
                                     CPU))
        assert set(sd) == set(want)
        for k, v in want.items():
            assert sd[k].dtype == v.dtype and torch.equal(sd[k], v), k


def test_launcher_serves_on_cpu(capsys):
    tserve.main(["--reduced", "--device", "cpu", "--requests", "3",
                 "--max-new", "3"])
    out = capsys.readouterr().out
    assert "3 requests, 9 tokens" in out and "xla attention" in out
    # --dataflow: the four data-flow tenants through the multi-tenant engine
    tserve.main(["--dataflow", "--device", "cpu", "--requests", "4",
                 "--rows", "300"])
    out = capsys.readouterr().out
    assert "16 requests x 300 rows over 4 tenants on cpu" in out
    for tenant in ("q15", "click", "text", "drift"):
        assert f"  {tenant}: {{'requests': 4," in out
    assert "'requests_served': 16" in out and "'swap_errors': 0" in out
