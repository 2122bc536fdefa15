"""The port's attention (plain versions and the CPU side of the kernel
wrapper) against the reference's.

The same numpy-seeded q, k, v go to `repro.kernels.ref.attention`, to
`repro.kernels.ops.flash_attention` (the Pallas kernel in interpret mode on
the CPU) and to the port's `ref.attention`, `ref.blocked_attention` and
`ops.flash_attention`, which on CPU tensors runs the plain version.
Tolerances are the reference kernel test's (`tests/test_kernels.py`):
2e-5 in float32, 2e-2 in bf16.  The CUDA kernel itself is held against the
plain version on the card in `test_torch_cuda.py`.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# (B, Hq, Hkv, T, S, D), causal, window, dtype, tol: tests/test_kernels.py
SHAPES = [
    ((1, 4, 2, 128, 128, 64), True, None, "float32", 2e-5),
    ((2, 8, 8, 64, 64, 32), True, None, "bfloat16", 2e-2),
    ((1, 4, 1, 128, 256, 64), True, None, "float32", 2e-5),   # GQA prefill
    ((1, 2, 2, 96, 96, 64), True, 32, "float32", 2e-5),        # window
    ((1, 2, 2, 64, 64, 128), False, None, "float32", 2e-5),
    ((1, 4, 2, 1, 128, 64), True, None, "float32", 2e-5),      # decode q
    ((1, 1, 1, 256, 256, 64), True, 128, "bfloat16", 2e-2),
]
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _qkv(shape, dt, seed):
    b, hq, hkv, t, s, d = shape
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(size=(b, hq, t, d)), rng.normal(size=(b, hkv, s, d)),
              rng.normal(size=(b, hkv, s, d)))
    # both frameworks round float32 -> bf16 to nearest even: the same bits
    tq = tuple(torch.from_numpy(a.astype(np.float32)).to(_TDT[dt])
               for a in arrays)
    jq = tuple(jnp.asarray(a.astype(np.float32), _JDT[dt]) for a in arrays)
    return tq, jq


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32))


@pytest.mark.parametrize("shape,causal,window,dt,tol", SHAPES)
def test_plain_attention_matches_reference(shape, causal, window, dt, tol):
    (q, k, v), (jq, jk, jv) = _qkv(shape, dt, 0)
    want = _np(jref.attention(jq, jk, jv, causal=causal, window=window))
    pallas = _np(jops.flash_attention(jq, jk, jv, causal=causal,
                                      window=window))
    got = tref.attention(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(got), pallas, rtol=tol, atol=tol)


@pytest.mark.parametrize("shape,causal,window,dt,tol", SHAPES)
def test_blocked_attention_matches_reference(shape, causal, window, dt, tol):
    (q, k, v), (jq, jk, jv) = _qkv(shape, dt, 1)
    want = _np(jref.blocked_attention(jq, jk, jv, causal=causal,
                                      window=window))
    got = tref.blocked_attention(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol)
    # several tiles with a ragged last one against the one-shot version
    tiled = tref.blocked_attention(q, k, v, causal=causal, window=window,
                                   block=48)
    np.testing.assert_allclose(
        _np(tiled), _np(tref.attention(q, k, v, causal=causal, window=window)),
        rtol=tol, atol=tol)


@pytest.mark.parametrize("shape,causal,window,dt,tol", SHAPES)
def test_flash_wrapper_on_cpu_runs_the_plain_version(shape, causal, window,
                                                     dt, tol):
    (q, k, v), _ = _qkv(shape, dt, 2)
    tops.reset_launches()
    got = tops.flash_attention(q, k, v, causal=causal, window=window)
    assert torch.equal(got, tref.attention(q, k, v, causal=causal,
                                           window=window))
    assert tops.LAUNCHES["flash_attention"] == 0


@pytest.mark.parametrize("shape,causal,window,dt,tol", SHAPES)
def test_flash_wrapper_on_cpu_takes_bthd_views(shape, causal, window, dt,
                                               tol):
    # the prefill hands the kernel its projections as [B,T,H,D] memory
    # viewed as [B,H,T,D]: the same values, strided rows
    (q, k, v), (jq, jk, jv) = _qkv(shape, dt, 5)
    views = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
    if shape[1] > 1 and shape[3] > 1:
        assert not views[0].is_contiguous()
    got = tops.flash_attention(*views, causal=causal, window=window)
    want = _np(jref.attention(jq, jk, jv, causal=causal, window=window))
    assert got.shape == q.shape and got.dtype == q.dtype
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 3),
                                           (False, 2)])
def test_fully_masked_rows_are_zero(causal, window):
    # T > S puts the first q rows before the kv timeline: with causal no
    # key is live for them, and the reference's isnan rule makes them 0
    (q, k, v), (jq, jk, jv) = _qkv((1, 2, 1, 12, 5, 32), "float32", 3)
    got = tref.attention(q, k, v, causal=causal, window=window)
    want = _np(jref.attention(jq, jk, jv, causal=causal, window=window))
    np.testing.assert_allclose(_np(got), want, rtol=2e-5, atol=2e-5)
    blocked = tref.blocked_attention(q, k, v, causal=causal, window=window,
                                     block=2)
    np.testing.assert_allclose(_np(blocked), want, rtol=2e-5, atol=2e-5)
    if causal:
        assert not got[:, :, :7].any()


def test_scale_is_passed_through():
    (q, k, v), (jq, jk, jv) = _qkv((1, 2, 2, 16, 16, 64), "float32", 4)
    want = _np(jref.attention(jq, jk, jv, causal=True, scale=0.3))
    np.testing.assert_allclose(
        _np(tops.flash_attention(q, k, v, causal=True, scale=0.3)), want,
        rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        _np(tref.blocked_attention(q, k, v, causal=True, scale=0.3)), want,
        rtol=2e-5, atol=2e-5)
