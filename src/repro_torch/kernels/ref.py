"""Plain PyTorch versions of the hand-written kernels (port of the matching
functions of `repro.kernels.ref`).

Each function computes exactly what its CUDA kernel computes, with ordinary
torch ops.  The CPU path of `kernels.ops` runs these, the tests hold them
against the reference's oracles, and `chip_smoke.py` holds each kernel
against them on the card.  Where the reference's models call its oracles
(plain attention, the recurrences' one-token decode step and their paths
without `use_kernel`), the port's models call these too, as the reference
does; every other call on the card goes to a kernel.  `rwkv6_chunked` and
`linear_scan_chunked` have no kernel: they are the reference's chunked
forms, which the models take without `use_kernel`.
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


def probe_positions(keys_sorted: torch.Tensor, queries: torch.Tensor,
                    first_valid=None, hi=None) -> torch.Tensor:
    """The join probe's int64 positions: clamp(maximum(searchsorted(keys,
    queries, side='left'), first_valid), 0, hi), `hi` defaulting to
    len(keys) - 1 (`core.masked`'s PK and anti probes)."""
    pos = torch.searchsorted(keys_sorted, queries, side="left")
    if first_valid is not None:
        pos = torch.maximum(pos, first_valid)
    return torch.clamp(pos, 0, keys_sorted.shape[0] - 1 if hi is None
                       else hi)


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


# ---------------------------------------------------------------------------
# rwkv6 — the WKV6 recurrence (data-dependent decay linear attention)
# ---------------------------------------------------------------------------
def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
          u: torch.Tensor, state=None, return_state: bool = False):
    """r, k, w [B,H,T,Dk], v [B,H,T,Dv], u [H,Dk]; per step

        out_t = r_t @ (S + u^T ⊙ (k_t^T v_t));  S = diag(w_t) S + k_t^T v_t

    with S [B,H,Dk,Dv] float32 (zeros unless `state` is given).  float32
    math, the output in r's dtype; `(out, S)` with `return_state`."""
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    S = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=r.device)
         if state is None else state.float())
    outs = []
    for i in range(t):
        kv = kf[:, :, i, :, None] * vf[:, :, i, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, :, i], S + uf * kv))
        S = wf[:, :, i, :, None] * S + kv
    out = (torch.stack(outs, dim=2) if outs
           else torch.zeros((b, h, 0, dv), device=r.device)).to(r.dtype)
    return (out, S) if return_state else out


def _affine_scan(a: torch.Tensor, b: torch.Tensor, dim: int):
    """Inclusive scan of the affine monoid (a1, b1) ⊕ (a2, b2) = (a1·a2,
    a2·b1 + b2) along `dim` (Hillis–Steele doubling, log2(n) steps, as an
    associative scan).  `a` broadcasts against `b` (a may lack b's
    trailing axes)."""
    n = b.shape[dim]
    extra = b.ndim - a.ndim
    step = 1
    while step < n:
        a_prev = a.narrow(dim, 0, n - step)
        b_prev = b.narrow(dim, 0, n - step)
        a_cur = a.narrow(dim, step, n - step)
        b_cur = b.narrow(dim, step, n - step)
        a_exp = a_cur.reshape(a_cur.shape + (1,) * extra)
        a = torch.cat([a.narrow(dim, 0, step), a_prev * a_cur], dim)
        b = torch.cat([b.narrow(dim, 0, step), a_exp * b_prev + b_cur], dim)
        step *= 2
    return a, b


def rwkv6_chunked(r, k, v, w, u, chunk: int = 32, state=None,
                  return_state: bool = False):
    """`rwkv6` as dense per-chunk products (GLA style), the reference's
    `ref.rwkv6_chunked`: with L = cumsum(log w) inside a chunk,
    r~_t = r_t·exp(L_{t-1}) and k~_j = k_j·exp(-L_j),

      intra-chunk:  ((r~ @ k~^T) ⊙ strict-causal) @ v  +  (r·u·k) v
      inter-chunk:  r~ @ S_chunk_start
      state:        S <- diag(A_C) S + (k~ ⊙ A_C)^T @ v

    and the chunk-start states from an associative scan over chunks.
    T % chunk == 0."""
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    if t % chunk:
        raise ValueError(f"rwkv6_chunked needs T % chunk == 0, got T={t}, "
                         f"chunk={chunk}")
    nc, c = t // chunk, chunk
    rf, kf, vf, wf = (x.float().reshape(b, h, nc, c, -1)
                      for x in (r, k, v, w))
    uf = u.float()

    logw = torch.log(torch.clamp(wf, min=1e-38))
    lc = torch.cumsum(logw, dim=3)                    # inclusive
    lx = lc - logw                                    # exclusive
    r_t = rf * torch.exp(lx)
    k_t = kf * torch.exp(-lc)
    a_c = torch.exp(lc[:, :, :, -1:, :])              # [b,h,nc,1,dk]

    decay = a_c[:, :, :, 0, :]                        # [b,h,nc,dk]
    p = torch.einsum("bhnck,bhncv->bhnkv", k_t * a_c, vf)
    s0 = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=r.device)
          if state is None else state.float())
    ca, cs = _affine_scan(decay, p, dim=2)
    s_incl = ca[..., None] * s0[:, :, None] + cs      # after chunk n
    s_start = torch.cat([s0[:, :, None], s_incl[:, :, :-1]], dim=2)

    inter = torch.einsum("bhnck,bhnkv->bhncv", r_t, s_start)
    scores = torch.einsum("bhnck,bhnjk->bhncj", r_t, k_t)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                      diagonal=-1)
    intra = torch.einsum("bhncj,bhnjv->bhncv",
                         torch.where(mask, scores, 0.0), vf)
    diag = torch.sum(rf * uf[None, :, None, None, :] * kf, dim=-1,
                     keepdim=True) * vf
    out = (inter + intra + diag).reshape(b, h, t, dv).to(r.dtype)
    return (out, s_incl[:, :, -1]) if return_state else out


# ---------------------------------------------------------------------------
# linear_scan — the diagonal recurrence h_t = a_t * h_{t-1} + b_t (RG-LRU)
# ---------------------------------------------------------------------------
def linear_scan(a: torch.Tensor, b: torch.Tensor, h0=None) -> torch.Tensor:
    """a, b [..., T, D] -> h [..., T, D] in a's dtype (float32 math), as an
    associative scan over T.  `h0` [..., D] is folded into the first step
    as b_0 + a_0·h0."""
    af, bf = a.float(), b.float()
    if h0 is not None:
        bf = bf.clone()
        bf[..., 0, :] += af[..., 0, :] * h0.float()
    _, h = _affine_scan(af, bf, dim=-2 % af.ndim)
    return h.to(a.dtype)


def linear_scan_chunked(a: torch.Tensor, b: torch.Tensor, h0=None,
                        chunk: int = 128) -> torch.Tensor:
    """`linear_scan` as a loop over chunks of `chunk` steps, each an
    associative scan with the carry folded in after it (the reference's
    `ref.linear_scan_chunked`, without its checkpointing: the port only
    serves).  Falls back to `linear_scan` when T % chunk or T <= chunk."""
    t, d = a.shape[-2], a.shape[-1]
    if t % chunk or t <= chunk:
        return linear_scan(a, b, h0=h0)
    lead = a.shape[:-2]
    af = a.float().reshape(lead + (t // chunk, chunk, d))
    bf = b.float().reshape(lead + (t // chunk, chunk, d))
    h = (torch.zeros(lead + (d,), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    outs = []
    for i in range(t // chunk):
        ca, cb = _affine_scan(af[..., i, :, :], bf[..., i, :, :],
                              dim=len(lead))
        out = cb + ca * h[..., None, :]
        outs.append(out)
        h = out[..., -1, :]
    return torch.cat(outs, dim=-2).reshape(lead + (t, d)).to(a.dtype)
