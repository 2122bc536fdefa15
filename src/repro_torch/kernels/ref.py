"""Plain PyTorch versions of the hand-written kernels (port of the matching
functions of `repro.kernels.ref`).

Each function computes exactly what its CUDA kernel computes, with ordinary
torch ops.  The CPU path of `kernels.ops` runs these, the tests hold them
against the reference's oracles, and `chip_smoke.py` holds each kernel
against them on the card.  Nothing on the card's main path calls them.
"""

from __future__ import annotations

import torch

from ..core import scans
from ..core.scans import identity_for, scan_identity

_COMBINE = {"add": torch.add, "max": torch.maximum, "min": torch.minimum}


# ---------------------------------------------------------------------------
# segmented_scan — segmented inclusive scan over sorted segments
# ---------------------------------------------------------------------------
def segmented_scan(values: torch.Tensor, flags: torch.Tensor,
                   op: str = "add") -> torch.Tensor:
    """Inclusive scan of `values` [N] or [N, C] restarting wherever `flags`
    [N] is True: `core.scans.segmented_scan`, with the classic segmented
    combine of the reference oracle."""
    if op not in _COMBINE:
        raise ValueError(op)
    return scans.segmented_scan(values, flags, op)


def segment_reduce(values: torch.Tensor, segment_ids: torch.Tensor,
                   num_segments: int, op: str = "add",
                   valid=None) -> torch.Tensor:
    """Per-segment reduction of key-sorted rows; values [N] or [N, C].
    Invalid rows contribute `identity_for` (0 or the dtype's finite
    min/max, as `repro.kernels.ref` masks them); empty segments hold
    `scan_identity`, as `jax.ops.segment_*` leaves them."""
    if op not in _COMBINE:
        raise ValueError(op)
    v = values if values.ndim > 1 else values[:, None]
    if valid is not None:
        v = torch.where(valid[:, None], v, identity_for(op, v.dtype))
    out = torch.full((num_segments, v.shape[1]), scan_identity(op, v.dtype),
                     dtype=v.dtype, device=v.device)
    idx = segment_ids.to(torch.int64)[:, None].expand(-1, v.shape[1])
    if op == "add":
        out.scatter_add_(0, idx, v)
    else:
        out.scatter_reduce_(0, idx, v, reduce="amax" if op == "max" else "amin")
    return out if values.ndim > 1 else out[:, 0]


# ---------------------------------------------------------------------------
# sorted_probe — vectorized searchsorted (left)
# ---------------------------------------------------------------------------
def sorted_probe(keys_sorted: torch.Tensor, queries: torch.Tensor
                 ) -> torch.Tensor:
    return torch.searchsorted(keys_sorted, queries, side="left").to(torch.int32)


# ---------------------------------------------------------------------------
# flash_attention — causal/windowed GQA attention
# ---------------------------------------------------------------------------
def _mask(t: int, s: int, causal: bool, window, device) -> torch.Tensor:
    """[t, s] live (q, k) pairs; the q timeline sits at the tail of the kv
    timeline (q row i is position i + s - t)."""
    qpos = torch.arange(t, device=device)[:, None] + (s - t)
    kpos = torch.arange(s, device=device)[None, :]
    mask = torch.ones((t, s), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window=None, scale=None) -> torch.Tensor:
    """q [B,Hq,T,D], k/v [B,Hkv,S,D] (Hq % Hkv == 0).  float32 math; rows
    with no live key are 0."""
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    group = hq // hkv
    qf = q.float() * (scale if scale is not None else d ** -0.5)
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    logits = torch.einsum("bhtd,bhsd->bhts", qf, kf)
    mask = _mask(t, s, causal, window, q.device)
    logits = logits.masked_fill(~mask, float("-inf"))
    w = torch.softmax(logits, dim=-1)
    w = torch.where(torch.isnan(w), 0.0, w)  # fully-masked rows
    return torch.einsum("bhts,bhsd->bhtd", w, vf).to(q.dtype)


def blocked_attention(q, k, v, causal: bool = True, window=None,
                      scale=None, block: int = 512) -> torch.Tensor:
    """Flash-style attention in plain torch: a loop over KV tiles with an
    online-softmax carry, never the [T, S] logits matrix.  Masked logits
    hold -1e30, as in the reference."""
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    group = hq // hkv
    qf = q.float() * (scale if scale is not None else d ** -0.5)
    q_pos = torch.arange(t, device=q.device) + (s - t)
    f32 = dict(dtype=torch.float32, device=q.device)
    m_run = torch.full((b, hq, t, 1), -1e30, **f32)
    l_run = torch.zeros((b, hq, t, 1), **f32)
    acc = torch.zeros((b, hq, t, v.shape[-1]), **f32)
    for lo in range(0, s, block):
        kt = k[:, :, lo:lo + block].float().repeat_interleave(group, dim=1)
        vt = v[:, :, lo:lo + block].float().repeat_interleave(group, dim=1)
        k_pos = torch.arange(lo, lo + kt.shape[2], device=q.device)
        mask = torch.ones((t, kt.shape[2]), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        logits = torch.einsum("bhtd,bhsd->bhts", qf, kt)
        logits = logits.masked_fill(~mask, -1e30)
        m_new = torch.maximum(m_run, logits.amax(-1, keepdim=True))
        p = torch.exp(logits - m_new).masked_fill(~mask, 0.0)
        alpha = torch.exp(m_run - m_new)
        l_run = l_run * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhts,bhsd->bhtd", p, vt)
        m_run = m_new
    return (acc / l_run.clamp(min=1e-30)).to(q.dtype)


# ---------------------------------------------------------------------------
# span_compact / span_segment — the megakernel span's boundary work
# ---------------------------------------------------------------------------
def span_compact(columns, valid: torch.Tensor, capacity: int):
    """Stable valids-first pack of `columns` (each [N, ...]) and the mask
    [N] into `capacity` slots: `(columns', valid', count)`.  Valid row r
    (0-based rank among valid rows) lands in slot r when r < capacity;
    every slot at or past `count` holds the LAST input row, as the clamp of
    `scans.pack_indices` leaves it; `count` is the pre-compaction number of
    valid rows (int64, 0-d).  Computed with a rank scatter, independently
    of `MaskedBatch.compact`'s search, which it equals on every slot."""
    n = valid.shape[0]
    dev = valid.device
    rank = torch.cumsum(valid.to(torch.int64), 0) - 1
    count = rank[-1] + 1
    # each output slot's source row; ranks past capacity go to a dump slot
    dst = torch.where(valid & (rank < capacity), rank, capacity)
    src = torch.full((capacity + 1,), n - 1, dtype=torch.int64, device=dev)
    src.scatter_(0, dst, torch.arange(n, dtype=torch.int64, device=dev))
    src = src[:capacity]
    out_valid = torch.arange(capacity, device=dev) < count
    return [c[src] for c in columns], out_valid, count


def span_segment(keys, valid: torch.Tensor):
    """Segments of a packed, key-ordered batch: `(seg, is_start, count)`.
    A valid slot starts a segment when it is slot 0, its predecessor is
    invalid, or any key differs from the predecessor's (`!=`, so float keys
    compare as IEEE values); `seg = max(cumsum(is_start) - 1, 0)` (int64)
    and `count` the number of starts — `masked._segments_contiguous` plus
    the group count, in the kernel's formulation."""
    differs = torch.ones_like(valid)
    differs[1:] = False
    for k in keys:
        differs[1:] |= k[1:] != k[:-1]
    prev_valid = torch.zeros_like(valid)
    prev_valid[1:] = valid[:-1]
    is_start = valid & (differs | ~prev_valid)
    seg = torch.clamp(scans.cumsum(is_start) - 1, min=0)
    return seg, is_start, is_start.sum()
