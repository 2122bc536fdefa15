"""The port's scans and data-plane kernels against the reference's.

On the CPU the kernel wrappers run their plain torch versions, which are
held against `repro.kernels.ref` and against `repro.kernels.ops` in Pallas
interpret mode.  The reference kernel wrappers cast values to float32
(`repro/kernels/ops.py:51,78`), so inputs here are small integers, exactly
representable in float32.  The CUDA kernels themselves are held against
their plain versions in `test_torch_cuda.py`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scans as jscans
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import scans as tscans
from repro_torch.core.udf import TensorSegmentOps
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

OPS = ("add", "max", "min")


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


# ---------------------------------------------------------------------------
# scans
# ---------------------------------------------------------------------------
_jscan = jax.jit(jscans.segmented_scan, static_argnums=2)
_jpack = jax.jit(jscans.pack_indices, static_argnums=1)


@pytest.mark.parametrize("n", [200, 1024])
@pytest.mark.parametrize("dtype", [np.int64, np.float64])
def test_scans_match_reference(n, dtype):
    # 200 takes the reference's flat scans, 1024 its blocked two-level ones
    rng = np.random.default_rng(n)
    v = rng.integers(-50, 50, n).astype(dtype)
    flags = rng.random(n) < 0.05
    np.testing.assert_array_equal(
        tscans.cumsum(_t(v)).numpy(), np.asarray(jax.jit(jscans.cumsum)(v)))
    for op in OPS:
        got = tscans.segmented_scan(_t(v), _t(flags), op).numpy()
        ref = np.asarray(_jscan(jnp.asarray(v), jnp.asarray(flags), op))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9)
    valid = rng.random(n) < 0.6
    for cap in (8, n // 2, n):
        src, count = tscans.pack_indices(_t(valid), cap)
        jsrc, jcount = _jpack(jnp.asarray(valid), cap)
        assert int(count) == int(jcount)
        np.testing.assert_array_equal(src.numpy(), np.asarray(jsrc))


@pytest.mark.parametrize("seed", range(4))
def test_fill_forward_is_the_gap_cummax(seed):
    # the executor's gap fills: a nondecreasing valid subsequence, a fill no
    # larger than any valid value — exactly cummax(where(valid, v, fill))
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 300))
    v = np.sort(rng.integers(-20, 20, n))
    valid = rng.random(n) < rng.random()
    fill = np.iinfo(np.int64).min
    want = np.maximum.accumulate(np.where(valid, v, fill))
    got = tscans.fill_forward(_t(v), _t(valid), fill).numpy()
    np.testing.assert_array_equal(got, want)
    idx = np.arange(n)
    np.testing.assert_array_equal(
        tscans.fill_forward(_t(idx), _t(valid), -1).numpy(),
        np.maximum.accumulate(np.where(valid, idx, -1)))


# ---------------------------------------------------------------------------
# plain kernel versions vs the reference oracles and interpret-mode kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("n,c", [(1, 1), (512, 1), (1024, 3)])
def test_plain_segmented_scan_matches_reference(op, n, c):
    rng = np.random.default_rng(n + c)
    v = rng.integers(-100, 100, (n, c)).astype(np.float64)
    flags = rng.random(n) < 0.1
    got = tref.segmented_scan(_t(v), _t(flags), op).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jref.segmented_scan(jnp.asarray(v), jnp.asarray(flags),
                                            op)))
    if n == 1024:  # one shape through the interpret-mode Pallas kernel
        kern = jops.segmented_scan(jnp.asarray(v, jnp.float32),
                                   jnp.asarray(flags), op=op)
        np.testing.assert_array_equal(got, np.asarray(kern, np.float64))
    # the CPU path of the port's wrapper is the plain version
    np.testing.assert_array_equal(tops.segmented_scan(_t(v), _t(flags), op),
                                  got)
    np.testing.assert_array_equal(
        tops.segmented_scan(_t(v[:, 0]), _t(flags), op).numpy(), got[:, 0])


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", [np.int64, np.float64])
def test_plain_segment_reduce_matches_reference(op, dtype):
    rng = np.random.default_rng(3)
    n, nseg = 600, 64
    sid = np.sort(rng.integers(0, nseg - 4, n))
    v = rng.integers(-100, 100, n).astype(dtype)
    valid = rng.random(n) < 0.8
    got = tref.segment_reduce(_t(v), _t(sid), nseg, op, valid=_t(valid))
    ref = jref.segment_reduce(jnp.asarray(v), jnp.asarray(sid), nseg, op,
                              valid=jnp.asarray(valid))
    assert got.numpy().dtype == np.asarray(ref).dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the reference kernel path (float32) agrees on live segments
    kern = jops.segment_reduce(jnp.asarray(v), jnp.asarray(sid), nseg, op,
                               valid=jnp.asarray(valid))
    live = np.isin(np.arange(nseg), sid[valid])
    np.testing.assert_array_equal(got.numpy()[live],
                                  np.asarray(kern)[live].astype(dtype))
    np.testing.assert_array_equal(
        tops.segment_reduce(_t(v), _t(sid), nseg, op, valid=_t(valid)).numpy(),
        got.numpy())


@pytest.mark.parametrize("n,m", [(0, 5), (1, 1), (37, 200), (3000, 2048)])
def test_plain_sorted_probe_matches_reference(n, m):
    rng = np.random.default_rng(n + m)
    keys = np.sort(rng.integers(-500, 500, n))
    q = rng.integers(-600, 600, m)
    got = tref.sorted_probe(_t(keys), _t(q))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jref.sorted_probe(jnp.asarray(keys),
                                                  jnp.asarray(q))))
    if n:
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jops.sorted_probe(jnp.asarray(keys),
                                                      jnp.asarray(q))))
    np.testing.assert_array_equal(tops.sorted_probe(_t(keys), _t(q)).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("dtype", ["int64", "float64"])
@pytest.mark.parametrize("first_valid,cut", [(None, 0), (0, 0), (37, 0),
                                             (37, 25), (None, 25)])
def test_plain_probe_positions_match_reference(dtype, first_valid, cut):
    # the join probe's positions: the Pallas probe (interpret mode), then
    # numpy's maximum and clip, exactly; duplicate keys, queries past both
    # ends, and a ceiling below the last key when `cut` is given
    rng = np.random.default_rng(19 + (first_valid or 0) + cut)
    n, m = 300, 517
    keys = np.sort(rng.integers(-50, 50, n)).astype(dtype)
    q = rng.integers(-80, 80, m).astype(dtype)
    if dtype == "float64":
        q[::3] += 0.5
    hi = n - 1 - cut
    want = np.asarray(jops.sorted_probe(jnp.asarray(keys), jnp.asarray(q)))
    want = want.astype(np.int64)
    if first_valid is not None:
        want = np.maximum(want, first_valid)
    want = np.clip(want, 0, hi)
    fv = None if first_valid is None else torch.tensor(first_valid)
    got = tref.probe_positions(_t(keys), _t(q), fv, hi)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    tops.reset_launches()
    np.testing.assert_array_equal(
        tops.probe_positions(_t(keys), _t(q), fv, hi).numpy(), want)
    assert tops.LAUNCHES["sorted_probe"] == 0
    if cut == 0:  # hi defaults to len(keys) - 1
        np.testing.assert_array_equal(
            tref.probe_positions(_t(keys), _t(q), fv).numpy(), want)


def test_kernel_segment_ops_match_tensor_segment_ops():
    # the use_kernels backend and the plain backend give the same aggregates
    rng = np.random.default_rng(11)
    n = 300
    sid = _t(np.sort(rng.integers(0, 40, n)))
    valid = _t(rng.random(n) < 0.7)
    x = _t(rng.integers(-9, 9, n))
    y = _t(rng.uniform(-1, 1, n))
    k = tops.KernelSegmentOps(sid, n, record_valid=valid)
    p = TensorSegmentOps(sid, n, record_valid=valid)
    live = torch.zeros(n, dtype=torch.bool)
    live[sid[valid]] = True
    for a, b in [(k.sum(x), p.sum(x)), (k.max(x), p.max(x)),
                 (k.min(x), p.min(x)), (k.count(), p.count()),
                 (k.any(x > 3), p.any(x > 3)), (k.first(x), p.first(x))]:
        assert a.dtype == b.dtype
        assert torch.equal(a[live], b[live])
    assert torch.allclose(k.sum(y)[live], p.sum(y)[live], rtol=0, atol=1e-12)


def test_wrappers_refuse_other_devices():
    meta = torch.empty(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        tops.sorted_probe(meta, meta)
    with pytest.raises(ValueError):
        tops.segmented_scan(meta, torch.empty(4, dtype=torch.bool,
                                              device="meta"))
    cpu = torch.arange(4)
    with pytest.raises(ValueError):
        tops.sorted_probe(cpu, meta)
    with pytest.raises(ValueError):
        tops.probe_positions(cpu, cpu, meta[0])
