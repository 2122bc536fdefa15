"""The port's rwkv6 and hybrid (RG-LRU) model families against the
reference.

Inputs and layer parameters are drawn with numpy from fixed seeds and given
to both packages; models get the reference's initial weights through
`interop.model_params`.  On the CPU the port's kernel wrappers run their
plain versions and the reference's `ops` run its Pallas kernels in
interpret mode, as `tests/test_kernels.py` runs them.

Stated tolerances:
- recurrences, float32: the sequential scans 3e-4 (`tests/test_kernels.py`
  holds the Pallas kernels to its oracle there); the chunked forms 2e-3
  (the reference's own chunked-vs-sequential test: exp(±cumulative log
  decay) magnifies rounding);
- float32 layers 1e-5, as `tests/test_torch_models.py`;
- bf16 activations over float32 parameters 2e-2 (one to two bf16 rounding
  steps, taken at other places by the two frameworks); the RG-LRU's float32
  state h there 1e-3: it is float32 math over bf16-valued inputs that both
  round alike, and rounding its float32 parameters to bf16 moves it by
  ~4e-3;
- logits atol 2e-3 / rtol 1e-3, as `tests/test_torch_models.py`;
- greedy tokens exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import make_model as jmake
from repro.models import rglru as JRG
from repro.models import rwkv6 as JRW
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JConfig
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import Request as JRequest
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.models import make_model
from repro_torch.models import rglru as TRG
from repro_torch.models import rwkv6 as TRW
from repro_torch.models import transformer as TT
from repro_torch.models.config import ModelConfig
from repro_torch.serve.engine import Engine, Request

SCAN_TOL = dict(rtol=3e-4, atol=3e-4)
CHUNK_TOL = dict(rtol=2e-3, atol=2e-3)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
LOGIT_TOL = dict(rtol=1e-3, atol=2e-3)
CPU = torch.device("cpu")

# tests/test_models.py's rwkv and hybrid configs (the hybrid's two layers
# are all tail), a hybrid with a super-block and a tail, and the registry's
# reduced configs
BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab=256, dtype="float32")
MODEL_CFGS = {
    "rwkv": dict(name="rwkv", family="rwkv6", rwkv_head_dim=16,
                 rwkv_mix_lora=8, rwkv_decay_lora=8, **BASE),
    "hybrid": dict(name="hyb", family="hybrid",
                   block_pattern=("rglru", "rglru", "attn"), local_window=8,
                   rglru_d_state=64, **{**BASE, "n_kv_heads": 1}),
    "hybrid5": dict(name="hyb5", family="hybrid",
                    block_pattern=("rglru", "rglru", "attn"), local_window=8,
                    rglru_d_state=64,
                    **{**BASE, "n_kv_heads": 1, "n_layers": 5}),
}
ARCHS = ("rwkv6-3b", "recurrentgemma-2b")


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _cfgs(name):
    kw = MODEL_CFGS[name]
    return JConfig(**kw), ModelConfig(**kw)


def _both(tree):
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    return jax.tree.map(jnp.asarray, tree), jax.tree.map(_t, tree)


def _rwkv_inputs(rng, b, h, t, dk, dv, w_lo=0.3):
    return dict(r=rng.normal(size=(b, h, t, dk)),
                k=rng.normal(size=(b, h, t, dk)),
                v=rng.normal(size=(b, h, t, dv)),
                w=rng.uniform(w_lo, 0.995, size=(b, h, t, dk)),
                u=rng.normal(size=(h, dk)))


# ---------------------------------------------------------------------------
# plain recurrences against the reference's oracles and Pallas kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,h,t,dk,dv", [
    (1, 2, 64, 16, 16), (2, 1, 128, 32, 64), (1, 1, 256, 64, 64),
    (2, 3, 37, 32, 48),
])
@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_plain_matches_reference(b, h, t, dk, dv, with_state):
    rng = np.random.default_rng(10 + t)
    x = {k: v.astype(np.float32) for k, v in
         _rwkv_inputs(rng, b, h, t, dk, dv).items()}
    s0 = (rng.normal(size=(b, h, dk, dv)) * 0.1).astype(np.float32) \
        if with_state else None
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    tx = {k: _t(v) for k, v in x.items()}
    want, ws = jref.rwkv6(**jx, state=None if s0 is None else jnp.asarray(s0),
                          return_state=True)
    got, gs = tref.rwkv6(**tx, state=None if s0 is None else _t(s0),
                         return_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN_TOL)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **SCAN_TOL)
    # the wrapper on CPU tensors is the plain version
    go, gso = tops.rwkv6(**tx, state=None if s0 is None else _t(s0),
                         return_state=True)
    assert torch.equal(go, got) and torch.equal(gso, gs)
    if not with_state:
        # the reference's Pallas kernel (no state), in interpret mode
        np.testing.assert_allclose(got.numpy(), np.asarray(jops.rwkv6(**jx)),
                                   **SCAN_TOL)
        assert torch.equal(tops.rwkv6(**tx), got)


def test_rwkv6_plain_keeps_bf16_inputs_and_output_dtype():
    rng = np.random.default_rng(3)
    x = _rwkv_inputs(rng, 2, 2, 20, 16, 16)
    jx = {k: jnp.asarray(v, jnp.bfloat16) for k, v in x.items()}
    tx = {k: _t(v.astype(np.float32)).to(torch.bfloat16) for k, v in x.items()}
    want = jref.rwkv6(**jx)
    got = tref.rwkv6(**tx)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_chunked_matches_reference(with_state):
    # tests/test_kernels.py::test_rwkv6_chunked_matches_scan's shapes
    rng = np.random.default_rng(4)
    b, h, t, dk, dv = 2, 3, 128, 32, 48
    x = {k: v.astype(np.float32) for k, v in
         _rwkv_inputs(rng, b, h, t, dk, dv, w_lo=0.5).items()}
    s0 = (rng.normal(size=(b, h, dk, dv)) * 0.1).astype(np.float32) \
        if with_state else None
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    tx = {k: _t(v) for k, v in x.items()}
    want, ws = jref.rwkv6_chunked(
        **jx, chunk=32, state=None if s0 is None else jnp.asarray(s0),
        return_state=True)
    got, gs = tref.rwkv6_chunked(**tx, chunk=32,
                                 state=None if s0 is None else _t(s0),
                                 return_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CHUNK_TOL)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **CHUNK_TOL)
    seq, ss = tref.rwkv6(**tx, state=None if s0 is None else _t(s0),
                         return_state=True)
    np.testing.assert_allclose(got.numpy(), seq.numpy(), **CHUNK_TOL)
    np.testing.assert_allclose(gs.numpy(), ss.numpy(), **CHUNK_TOL)
    with pytest.raises(ValueError, match="T % chunk"):
        tref.rwkv6_chunked(**{k: v[:, :, :100] if v.ndim == 4 else v
                              for k, v in tx.items()}, chunk=32)


@pytest.mark.parametrize("g,t,d", [(2, 64, 8), (1, 500, 16), (3, 256, 128),
                                   (2, 1, 4)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_linear_scan_plain_matches_reference(g, t, d, with_h0):
    rng = np.random.default_rng(20 + t)
    a = rng.uniform(0.2, 0.99, size=(g, t, d)).astype(np.float32)
    b = rng.normal(size=(g, t, d)).astype(np.float32)
    h0 = rng.normal(size=(g, d)).astype(np.float32) if with_h0 else None
    jh0 = None if h0 is None else jnp.asarray(h0)
    th0 = None if h0 is None else _t(h0)
    want = jref.linear_scan(jnp.asarray(a), jnp.asarray(b), h0=jh0)
    got = tref.linear_scan(_t(a), _t(b), h0=th0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN_TOL)
    assert torch.equal(tops.linear_scan(_t(a), _t(b), h0=th0), got)
    # the chunked form (a loop over 128-step chunks when T allows)
    want_c = jref.linear_scan_chunked(jnp.asarray(a), jnp.asarray(b), h0=jh0)
    got_c = tref.linear_scan_chunked(_t(a), _t(b), h0=th0)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), **SCAN_TOL)
    np.testing.assert_allclose(got_c.numpy(), got.numpy(), **SCAN_TOL)
    if not with_h0:
        # the reference's Pallas kernel, in interpret mode
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jops.linear_scan(jnp.asarray(a),
                                                     jnp.asarray(b))),
            **SCAN_TOL)
    # the sequential recurrence, written out
    h = np.zeros((g, d), np.float64) if h0 is None else h0.astype(np.float64)
    seq = []
    for i in range(t):
        h = a[:, i] * h + b[:, i]
        seq.append(h)
    np.testing.assert_allclose(got.numpy(), np.stack(seq, 1), **SCAN_TOL)


def test_linear_scan_takes_leading_axes():
    rng = np.random.default_rng(5)
    a = rng.uniform(0.2, 0.99, size=(2, 3, 256, 8)).astype(np.float32)
    b = rng.normal(size=(2, 3, 256, 8)).astype(np.float32)
    h0 = rng.normal(size=(2, 3, 8)).astype(np.float32)
    want = jref.linear_scan_chunked(jnp.asarray(a), jnp.asarray(b),
                                    h0=jnp.asarray(h0), chunk=64)
    got = tref.linear_scan_chunked(_t(a), _t(b), h0=_t(h0), chunk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN_TOL)


# ---------------------------------------------------------------------------
# layers on shared parameters
# ---------------------------------------------------------------------------
def _time_mix_params(cfg, rng):
    d, h, dh = cfg.d_model, cfg.rwkv_n_heads, cfg.rwkv_head_dim
    lo, ld = cfg.rwkv_mix_lora, cfg.rwkv_decay_lora
    return {"mix_base": rng.uniform(0, 1, size=(5, d)),
            "mix_lora_a": rng.normal(size=(5, d, lo)) * 0.1,
            "mix_lora_b": rng.normal(size=(5, lo, d)) * 0.1,
            "w_r": rng.normal(size=(d, d)) / 8,
            "w_kk": rng.normal(size=(d, d)) / 8,
            "w_vv": rng.normal(size=(d, d)) / 8,
            "w_g": rng.normal(size=(d, d)) / 8,
            "w_o": rng.normal(size=(d, d)) / 8,
            "decay_base": np.tile(np.linspace(-6.0, -0.5, dh), h)
            + rng.normal(size=d) * 0.01,
            "decay_lora_a": rng.normal(size=(d, ld)) * 0.1,
            "decay_lora_b": rng.normal(size=(ld, d)) * 0.1,
            "bonus_u": rng.normal(size=(h, dh)) * 0.3,
            "ln_x": {"scale": 1 + rng.normal(size=d) / 4}}


def _channel_mix_params(cfg, rng):
    d, f = cfg.d_model, cfg.d_ff
    return {"mix_k": rng.uniform(0, 1, size=d),
            "mix_r": rng.uniform(0, 1, size=d),
            "w_ck": rng.normal(size=(d, f)) / 8,
            "w_cv": rng.normal(size=(f, d)) / 12,
            "w_cr": rng.normal(size=(d, d)) / 8}


def _rglru_params(cfg, rng):
    d, ds = cfg.d_model, cfg.rglru_d_state
    return {"w_x": rng.normal(size=(d, ds)) / 8,
            "w_gate_rec": rng.normal(size=(d, ds)) / 8,
            "conv_w": rng.normal(size=(cfg.conv_width, ds)) * 0.3,
            "conv_b": rng.normal(size=ds) * 0.1,
            "w_a": rng.normal(size=(ds, ds)) / 8,
            "w_i": rng.normal(size=(ds, ds)) / 8,
            "lam": np.linspace(2.0, 5.0, ds) + rng.normal(size=ds) * 0.01,
            "w_out": rng.normal(size=(ds, d)) / 8}


def _cast(tree, tcfg):
    """A layer tree as the port's model reads it (`cast_params`)."""
    full = {"embed": {"table": torch.zeros((1, tcfg.d_model))},
            "final_norm": {"scale": torch.ones(tcfg.d_model)},
            "layers": [tree]}
    return TT.cast_params(full, tcfg.with_(tied_embeddings=True))["layers"][0]


ACTS = {"float32": (jnp.float32, torch.float32, LAYER_TOL),
        "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}
H_TOL = {"float32": LAYER_TOL, "bfloat16": dict(rtol=1e-3, atol=1e-3)}


@pytest.mark.parametrize("act", list(ACTS))
@pytest.mark.parametrize("t", [5, 64])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_time_mix_matches_reference(act, t, use_kernel):
    jdt, tdt, tol = ACTS[act]
    jcfg, tcfg = _cfgs("rwkv")
    jcfg, tcfg = jcfg.with_(dtype=act), tcfg.with_(dtype=act)
    rng = np.random.default_rng(6)
    jp, tp = _both(_time_mix_params(tcfg, rng))
    tp = _cast({"tm": tp}, tcfg)["tm"]
    b, d, h, dh = 2, tcfg.d_model, tcfg.rwkv_n_heads, tcfg.rwkv_head_dim
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    shift = rng.normal(size=(b, d)).astype(np.float32)
    wkv = (rng.normal(size=(b, h, dh, dh)) * 0.1).astype(np.float32)
    jx, tx = jnp.asarray(x, jdt), _t(x).to(tdt)
    # no state (the forward path), then a carried state (prefill / decode)
    jo, js, jw = JRW.time_mix(jp, jcfg, jx, use_kernel=use_kernel)
    to, ts, tw = TRW.time_mix(tp, tcfg, tx, use_kernel=use_kernel)
    assert to.dtype == tdt
    np.testing.assert_allclose(_np(to), _np(jo), **tol)
    np.testing.assert_array_equal(_np(ts), _np(js))
    if use_kernel:  # the forward kernel path returns no state
        assert jw is None and tw is None
    else:
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **tol)
    jo, js, jw = JRW.time_mix(jp, jcfg, jx, jnp.asarray(shift, jdt),
                              jnp.asarray(wkv), use_kernel=use_kernel)
    to, ts, tw = TRW.time_mix(tp, tcfg, tx, _t(shift).to(tdt), _t(wkv),
                              use_kernel=use_kernel)
    assert tw.dtype == torch.float32
    np.testing.assert_allclose(_np(to), _np(jo), **tol)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **tol)


@pytest.mark.parametrize("act", list(ACTS))
def test_channel_mix_matches_reference(act):
    jdt, tdt, tol = ACTS[act]
    jcfg, tcfg = _cfgs("rwkv")
    rng = np.random.default_rng(7)
    jp, tp = _both(_channel_mix_params(tcfg, rng))
    tp = _cast({"cm": tp}, tcfg.with_(dtype=act))["cm"]
    x = rng.normal(size=(2, 9, tcfg.d_model)).astype(np.float32)
    shift = rng.normal(size=(2, tcfg.d_model)).astype(np.float32)
    for js_, ts_ in ((None, None), (jnp.asarray(shift, jdt),
                                    _t(shift).to(tdt))):
        jo, js = JRW.channel_mix(jp, jcfg, jnp.asarray(x, jdt), js_)
        to, ts = TRW.channel_mix(tp, tcfg, _t(x).to(tdt), ts_)
        assert to.dtype == tdt
        np.testing.assert_allclose(_np(to), _np(jo), **tol)
        np.testing.assert_array_equal(_np(ts), _np(js))


@pytest.mark.parametrize("act", list(ACTS))
def test_conv1d_matches_reference(act):
    jdt, tdt, tol = ACTS[act]
    rng = np.random.default_rng(8)
    w = rng.normal(size=(4, 16)).astype(np.float32)
    bias = rng.normal(size=16).astype(np.float32)
    x = rng.normal(size=(2, 7, 16)).astype(np.float32)
    st = rng.normal(size=(2, 3, 16)).astype(np.float32)
    for jst, tst in ((None, None), (jnp.asarray(st, jdt), _t(st).to(tdt))):
        jo, js = JRG._conv1d(jnp.asarray(w), jnp.asarray(bias),
                             jnp.asarray(x, jdt), jst)
        to, ts = TRG._conv1d(_t(w), _t(bias), _t(x).to(tdt), tst)
        assert to.dtype == tdt and ts.shape == (2, 3, 16)
        np.testing.assert_allclose(_np(to), _np(jo), **tol)
        np.testing.assert_array_equal(_np(ts), _np(js))


@pytest.mark.parametrize("act", list(ACTS))
@pytest.mark.parametrize("t", [6, 256])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_rglru_block_matches_reference(act, t, use_kernel):
    jdt, tdt, tol = ACTS[act]
    jcfg, tcfg = _cfgs("hybrid")
    jcfg, tcfg = jcfg.with_(dtype=act), tcfg.with_(dtype=act)
    rng = np.random.default_rng(9)
    jp, tp = _both(_rglru_params(tcfg, rng))
    tp = _cast({"rec": tp}, tcfg)["rec"]
    b, d, ds = 2, tcfg.d_model, tcfg.rglru_d_state
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    conv = rng.normal(size=(b, 3, ds)).astype(np.float32)
    h0 = rng.normal(size=(b, ds)).astype(np.float32)
    jo, _ = JRG.rglru_block(jp, jcfg, jnp.asarray(x, jdt),
                            use_kernel=use_kernel)
    to, _ = TRG.rglru_block(tp, tcfg, _t(x).to(tdt), use_kernel=use_kernel)
    assert to.dtype == tdt
    np.testing.assert_allclose(_np(to), _np(jo), **tol)
    jst = {"conv": jnp.asarray(conv, jdt), "h": jnp.asarray(h0)}
    tst = {"conv": _t(conv).to(tdt), "h": _t(h0)}
    jo, js = JRG.rglru_block(jp, jcfg, jnp.asarray(x, jdt), jst,
                             use_kernel=use_kernel)
    to, ts = TRG.rglru_block(tp, tcfg, _t(x).to(tdt), tst,
                             use_kernel=use_kernel)
    np.testing.assert_allclose(_np(to), _np(jo), **tol)
    np.testing.assert_allclose(ts["h"].numpy(), np.asarray(js["h"]),
                               **H_TOL[act])
    np.testing.assert_array_equal(_np(ts["conv"]), _np(js["conv"]))


def test_cast_params_keeps_what_the_reference_reads_in_float32():
    # at full width the parameters are float32 and the activations bf16:
    # the rwkv6 time-mix and RG-LRU leaves the reference reads in float32
    # must not round to bf16, the matmul weights are cast once
    for arch in ARCHS:
        cfg = get_config(arch, reduced=True, dtype="bfloat16")
        m = make_model(cfg, CPU).init(torch.Generator().manual_seed(0))
        tree = m.params()
        raw = {k: m_.tree() for k, m_ in m.named_children() if k != "layers"}
        raw["layers"] = [lm.tree() for lm in m.layers]
        kept, cast = set(), set()

        def walk(c, r_, path=""):
            for k, v in c.items():
                if isinstance(v, dict):
                    walk(v, r_[k], f"{path}{k}.")
                elif v.dtype == torch.float32:
                    assert torch.equal(v, r_[k])
                    kept.add(k)
                else:
                    assert v.dtype == torch.bfloat16, path + k
                    cast.add(k)

        for c, r_ in zip(tree["layers"], raw["layers"]):
            walk(c, r_)
        want = ({"mix_base", "mix_lora_a", "mix_lora_b", "decay_base",
                 "decay_lora_a", "decay_lora_b", "bonus_u", "scale"}
                if cfg.family == "rwkv6" else
                {"conv_w", "conv_b", "w_a", "w_i", "lam", "scale"})
        assert kept == want, arch
        assert "w_r" in cast or "w_x" in cast


# ---------------------------------------------------------------------------
# models: forward / prefill / decode_step on the reference's weights
# ---------------------------------------------------------------------------
def _model_cfgs(name):
    if name in ARCHS:
        return jget(name, reduced=True), get_config(name, reduced=True)
    return _cfgs(name)


@pytest.fixture(scope="module")
def weights():
    cache = {}

    def get(name):
        if name not in cache:
            jcfg, tcfg = _model_cfgs(name)
            params = jmake(jcfg).init(jax.random.key(11))
            cache[name] = (params, interop.model_params(
                jax.tree.map(np.asarray, params), tcfg))
        return cache[name]
    return get


def test_model_params_cover_the_state_dict(weights):
    for name in ("rwkv", "hybrid5", *ARCHS):
        jcfg, tcfg = _model_cfgs(name)
        params, sd = weights(name)
        m = make_model(tcfg, CPU)
        assert set(sd) == set(m.state_dict()), name
        assert m.param_count() == sum(
            int(np.prod(x.shape)) for x in jax.tree.leaves(params))
    # hybrid: super-block s, kind j -> layer 3s + j; the tail after them
    params, sd = weights("hybrid5")
    np.testing.assert_array_equal(sd["layers.2.attn.wq"].numpy(),
                                  np.asarray(params["super"][2]["attn"]["wq"][0]))
    np.testing.assert_array_equal(sd["layers.1.rec.lam"].numpy(),
                                  np.asarray(params["super"][1]["rec"]["lam"][0]))
    np.testing.assert_array_equal(sd["layers.4.rec.w_a"].numpy(),
                                  np.asarray(params["tail"][1]["rec"]["w_a"]))
    assert "layers.3.attn.wq" not in sd and "layers.3.rec.w_x" in sd
    params, sd = weights("rwkv6-3b")
    np.testing.assert_array_equal(
        sd["layers.1.tm.bonus_u"].numpy(),
        np.asarray(params["layers"]["tm"]["bonus_u"][1]))


def _states_close(ts, js, cfg):
    """The port's per-layer state list against the reference's tree."""
    if cfg.family == "rwkv6":
        for i, s in enumerate(ts):
            np.testing.assert_allclose(s["wkv"].numpy(),
                                       np.asarray(js["wkv"][i]), **LOGIT_TOL)
        return
    width = len(cfg.block_pattern)
    n_super = cfg.n_layers // width
    for i, s in enumerate(ts):
        j = (js["super"][i % width] if i < n_super * width
             else js["tail"][i - n_super * width])
        pick = (lambda a: a[i // width]) if i < n_super * width \
            else (lambda a: a)
        if "h" in s:
            np.testing.assert_allclose(s["h"].numpy(), np.asarray(pick(j["h"])),
                                       **LOGIT_TOL)
        else:
            np.testing.assert_allclose(s["k"].numpy(), np.asarray(pick(j["k"])),
                                       **LOGIT_TOL)
            assert s["pos"] == int(pick(j["pos"]))


@pytest.mark.parametrize("name", ["rwkv", "hybrid", "hybrid5", *ARCHS])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_prefill_decode_match_reference(name, use_kernel, weights):
    jcfg, tcfg = _model_cfgs(name)
    params, sd = weights(name)
    tm = make_model(tcfg, CPU, use_kernel=use_kernel).load_params(sd)
    rng = np.random.default_rng(12)
    # T = 32: the rwkv6 chunked path without use_kernel; a multiple of the
    # local window (8 or 16), as the ring-buffer prefill needs
    b, t = 2, 32
    toks = rng.integers(0, tcfg.vocab, (b, t + 4)).astype(np.int32)
    jl, _ = JT.forward(params, jcfg, jnp.asarray(toks),
                       use_kernel=use_kernel)
    tl, aux = tm.logits({"tokens": _t(toks).long()})
    assert tl.shape == (b, t + 4, tcfg.padded_vocab) and float(aux) == 0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)

    js = JT.init_decode_state(jcfg, b, t + 8)
    ts = tm.init_decode_state(b, t + 8)
    jl, js = JT.prefill(params, jcfg, {"tokens": jnp.asarray(toks[:, :t])},
                        js, use_kernel=use_kernel)
    tl, ts = tm.prefill({"tokens": _t(toks[:, :t]).long()}, ts)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _states_close(ts, js, tcfg)
    for i in range(4):
        tok = toks[:, t + i:t + i + 1]
        jl, js = JT.decode_step(params, jcfg, jnp.asarray(tok), js)
        tl, ts = tm.decode_step(_t(tok).long(), ts)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    _states_close(ts, js, tcfg)


@pytest.mark.parametrize("name", ["rwkv", "hybrid5"])
def test_prefill_then_decode_matches_forward(name, weights):
    # decode == teacher forcing, as tests/test_models.py holds the reference
    _, tcfg = _model_cfgs(name)
    tm = make_model(tcfg, CPU, use_kernel=True).load_params(weights(name)[1])
    toks = np.random.default_rng(13).integers(0, tcfg.vocab, (2, 20))
    full, _ = tm.logits({"tokens": _t(toks)})
    st = tm.init_decode_state(2, 24)
    lg, st = tm.prefill({"tokens": _t(toks[:, :16])}, st)
    np.testing.assert_allclose(lg[:, -1].numpy(), full[:, 15].numpy(),
                               **LOGIT_TOL)
    for i in range(16, 20):
        lg, st = tm.decode_step(_t(toks[:, i:i + 1]), st)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, i].numpy(),
                                   **LOGIT_TOL)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def _requests(cls, vocab, seed, n=5):
    # prompts of at most 15 tokens: the reduced recurrentgemma's ring
    # buffer holds 16, and prefill fills it in one pass (t <= 16)
    rng = np.random.default_rng(seed)
    return [cls(prompt=rng.integers(0, vocab, rng.integers(3, 16))
                .astype(np.int32), max_new_tokens=int(rng.integers(2, 7)))
            for _ in range(n)]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_engine_greedy_tokens_match_reference(arch, use_kernel, weights):
    params, sd = weights(arch)
    jcfg, tcfg = _model_cfgs(arch)
    tm = make_model(tcfg, CPU, use_kernel=use_kernel).load_params(sd)
    # 5 requests over 2 slots: two full chunks and a partial one, ragged
    # prompts (left-padded) and ragged max_new_tokens
    jr = JEngine(jmake(jcfg), params, batch_slots=2, max_seq=32).generate(
        _requests(JRequest, tcfg.vocab, 14))
    tr = Engine(tm, batch_slots=2, max_seq=32).generate(
        _requests(Request, tcfg.vocab, 14))
    for a, b in zip(tr, jr):
        assert a.out_tokens == b.out_tokens and a.done and b.done
        assert len(a.out_tokens) == a.max_new_tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_recurrent_archs_on_cpu(arch, capsys):
    tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                 "--requests", "3", "--max-new", "3"])
    out = capsys.readouterr().out
    cfg = get_config(arch, reduced=True)
    assert f"{cfg.name} on cpu ({cfg.family}" in out
    assert "3 requests, 9 tokens" in out


def test_model_defaults_keep_the_reference_switch_off():
    import inspect

    from repro_torch.models.model import Model

    for fn in (Model, make_model):
        params = inspect.signature(fn).parameters
        assert params["device"].default == "cuda"
        assert params["use_kernel"].default is False
    for fn in (TT.forward, TT.prefill):
        assert inspect.signature(fn).parameters["use_kernel"].default is False
