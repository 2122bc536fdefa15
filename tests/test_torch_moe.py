"""The port's MoE family against the reference: `moe_block`, and the moe
models' forward / prefill / decode.

The block gets the same numpy-seeded parameters and inputs in both
packages; models get the reference's initial weights through
`interop.model_params`.  Stated tolerances: float32 block outputs 1e-5
(the products and the k-way combine sum in another order); the aux loss
1e-6; logits atol 2e-3 / rtol 1e-3 (as `tests/test_models.py` holds decode
against teacher forcing).  Routing must pick and drop the same (token, k)
pairs: the tied-router cases make every token's probabilities equal, so
top-k order and the capacity drop rest on the tie rule and the stable
slot ranking alone.  On the CPU the port's flash path runs the kernel's
plain version and the reference's runs its Pallas kernel in interpret
mode.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import make_model as jmake
from repro.models import moe as JMOE
from repro.models.config import ModelConfig as JConfig
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models import make_model
from repro_torch.models import moe as TMOE
from repro_torch.models.config import ModelConfig

BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-3, atol=2e-3)
CPU = torch.device("cpu")

MOE_BASE = dict(n_layers=1, d_model=32, n_heads=4, d_ff=64, vocab=256,
                dtype="float32")
# name: (config, (B, T), tied router)
BLOCKS = {
    "top2": (dict(n_experts=4, top_k=2), (2, 24), False),
    "shared": (dict(n_experts=8, top_k=2, n_shared_experts=2, d_expert_ff=16),
               (2, 24), False),
    "tied": (dict(n_experts=4, top_k=2), (2, 24), True),
    # every token picks experts 0 and 1: 600 pairs each against a capacity
    # of 512, so the last 88 tokens of the flat order are dropped by both
    "overflow": (dict(n_experts=4, top_k=2), (2, 300), True),
}


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _moe_params(cfg, rng, tied):
    d, e = cfg.d_model, cfg.n_experts
    fe = cfg.d_expert_ff or cfg.d_ff
    p = {"router": (np.zeros((d, e)) if tied
                    else rng.normal(size=(d, e)) / 2),
         "we_gate": rng.normal(size=(e, d, fe)) / 6,
         "we_up": rng.normal(size=(e, d, fe)) / 6,
         "we_down": rng.normal(size=(e, fe, d)) / 6}
    if cfg.n_shared_experts:
        fs = fe * cfg.n_shared_experts
        p["shared"] = {"w_gate": rng.normal(size=(d, fs)) / 6,
                       "w_up": rng.normal(size=(d, fs)) / 6,
                       "w_down": rng.normal(size=(fs, d)) / 6}
    return jax.tree.map(lambda a: np.asarray(a, np.float32), p)


@pytest.mark.parametrize("name", list(BLOCKS))
def test_moe_block_matches_reference(name):
    kw, (b, t), tied = BLOCKS[name]
    jcfg = JConfig(name="m", family="moe", **MOE_BASE, **kw)
    tcfg = ModelConfig(name="m", family="moe", **MOE_BASE, **kw)
    rng = np.random.default_rng(len(name))
    p = _moe_params(tcfg, rng, tied)
    x = rng.normal(size=(b, t, tcfg.d_model)).astype(np.float32)
    jo, jaux = JMOE.moe_block(jax.tree.map(jnp.asarray, p), jcfg,
                              jnp.asarray(x))
    to, taux = TMOE.moe_block(jax.tree.map(_t, p), tcfg, _t(x))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **BLOCK_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6,
                               atol=1e-9)
    cap = TMOE.capacity(tcfg, b * t)
    _, topw, topi = TMOE.route(jax.tree.map(_t, p), tcfg,
                               _t(x).reshape(b * t, -1))
    if tied:
        # ties go to the lower expert id, as jax.lax.top_k breaks them
        assert (topi == torch.tensor([0, 1])).all()
        assert torch.equal(topw, torch.full_like(topw, 0.5))
        rows = to.reshape(b * t, -1).abs().amax(-1)
        assert (rows[:cap] > 0).all()
        if b * t > cap:  # the dropped tokens: no expert output, no shared
            assert cap == 512 and (rows[cap:] == 0).all()
    else:
        assert torch.equal(topi, _t(jax.lax.top_k(
            jax.nn.softmax(jnp.asarray(x).reshape(b * t, -1)
                           @ jnp.asarray(p["router"])), tcfg.top_k)[1])
            .long())


def test_capacity_matches_reference_rounding():
    cfg = get_config("qwen2-moe-a2.7b")
    # prefill of 4 prompts of 2,048 tokens, and a 4-token decode step
    assert TMOE.capacity(cfg, 4 * 2048) == 768
    assert TMOE.capacity(cfg, 4) == 256
    mix = get_config("mixtral-8x22b")
    assert TMOE.capacity(mix, 4 * 2048) == 2560


# ---------------------------------------------------------------------------
# models: the reduced registry configs and tests/test_models.py's moe pair
# ---------------------------------------------------------------------------
MODEL_BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                  vocab=256, dtype="float32")
MODELS = {
    "qwen2-moe-a2.7b": None,
    "mixtral-8x22b": None,
    "moe": dict(n_experts=4, top_k=2, capacity_factor=2.0),
    "moe_shared": dict(n_experts=8, top_k=2, n_shared_experts=2,
                       d_expert_ff=32, capacity_factor=4.0),
}


def _configs(name, impl):
    kw = MODELS[name]
    if kw is None:
        return (jget(name, reduced=True, attn_impl=impl),
                get_config(name, reduced=True, attn_impl=impl))
    return (JConfig(name=name, family="moe", attn_impl=impl, **MODEL_BASE,
                    **kw),
            ModelConfig(name=name, family="moe", attn_impl=impl,
                        **MODEL_BASE, **kw))


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("name", list(MODELS))
def test_moe_model_matches_reference(name, impl):
    # forward (with the aux summed over layers), prefill and four decode
    # steps against the reference on its weights, and decode against the
    # port's own teacher-forced logits (tests/test_models.py's check)
    jcfg, tcfg = _configs(name, impl)
    jm = jmake(jcfg)
    params = jm.init(jax.random.key(1))
    tm = make_model(tcfg, CPU).load_params(
        interop.model_params(jax.tree.map(np.asarray, params), tcfg))
    b, t = 2, 32   # t a multiple of mixtral's reduced window of 16
    toks = np.random.default_rng(1).integers(0, tcfg.vocab, (b, t + 4))
    jlogits, jprefill, jdecode = (jax.jit(jm.logits), jax.jit(jm.prefill),
                                  jax.jit(jm.decode_step))
    jl, jaux = jlogits(params, {"tokens": jnp.asarray(toks, jnp.int32)})
    full, taux = tm.logits({"tokens": _t(toks)})
    np.testing.assert_allclose(full.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert float(taux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)

    js, ts = jm.init_decode_state(b, t + 8), tm.init_decode_state(b, t + 8)
    pre = {"tokens": toks[:, :t]}
    jl, js = jprefill(params, {"tokens": jnp.asarray(pre["tokens"],
                                                     jnp.int32)}, js)
    tl, ts = tm.prefill({"tokens": _t(pre["tokens"])}, ts)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(tl[:, -1].numpy(), full[:, t - 1].numpy(),
                               **LOGIT_TOL)
    for i in range(4):
        tok = toks[:, t + i][:, None]
        jl, js = jdecode(params, jnp.asarray(tok, jnp.int32), js)
        tl, ts = tm.decode_step(_t(tok), ts)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        np.testing.assert_allclose(tl[:, 0].numpy(), full[:, t + i].numpy(),
                                   **LOGIT_TOL)
