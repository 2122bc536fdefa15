"""Prefix-scan primitives for the masked executor's hot path.

Port of `repro.core.scans`.  The reference blocks its scans two-level
because XLA lowers a flat `cumsum`/`cummax` to an O(n·w) reduce-window; in
PyTorch `torch.cumsum` is already a linear device scan, so `cumsum` is that
call.  The executor's cumulative maxima are all forward fills of a
nondecreasing valid subsequence (`fill_forward`), which a prefix sum, a
binary search and two gathers compute without `torch.cummax` and the argmax
index tensor it materialises.

`segmented_scan` keeps the reference's semantics exactly (a flag-stopped
inclusive scan): for `add` it sums each segment from its start, never by
differencing a global prefix sum, so float aggregates see no catastrophic
cancellation.  Its arithmetic is the same log-depth shift-and-combine as
the reference (`_seg_scan_flat`), applied over the whole array; it is also
the plain version of the segmented-scan kernel (`kernels.ref`).
"""

from __future__ import annotations

import torch

_OPS = {
    "add": torch.add,
    "max": torch.maximum,
    "min": torch.minimum,
}


def identity_for(op: str, dtype: torch.dtype):
    """The op identity as a Python scalar."""
    if op == "add":
        return 0
    info = torch.finfo(dtype) if dtype.is_floating_point else torch.iinfo(dtype)
    return info.min if op == "max" else info.max


def pack_indices(valid: torch.Tensor, capacity: int):
    """Gather indices of the stable valids-first prefix pack.

    Returns `(src, count)`: `src[i]` is the source slot of output slot `i`
    under the pack that moves valid rows to the front in original order
    (slots past `count` hold a clamped repeat of the last row and must be
    masked by the caller).  A prefix sum over the mask plus one monotone
    vectorized binary search — no comparator sort, no host sync."""
    cv = cumsum(valid.to(torch.int64))
    src = torch.searchsorted(
        cv, torch.arange(1, capacity + 1, dtype=torch.int64, device=cv.device))
    return torch.clamp(src, max=valid.shape[0] - 1), cv[-1]


def cumsum(v: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum in the input's dtype (bool counts as int64)."""
    if v.dtype == torch.bool:
        v = v.to(torch.int64)
    return torch.cumsum(v, 0, dtype=v.dtype)


def fill_forward(v: torch.Tensor, valid: torch.Tensor, fill) -> torch.Tensor:
    """`torch.cummax(where(valid, v, fill))` for a `v` whose VALID subsequence is
    nondecreasing and a `fill` no larger than any valid value — the shape of
    every gap fill in the masked executor (previous-valid-row positions, the
    PK side's key codes under order elision).

    Each slot takes the value of the last valid slot at or before it (the
    fill before the first one), which is exactly what the cumulative max
    gives under those preconditions.  That slot is the `c[i]`-th valid row,
    `c = cumsum(valid)`, found by one monotone binary search, so the fill is
    a prefix sum, a search and two gathers, with no `torch.cummax`."""
    n = valid.shape[0]
    c = torch.cumsum(valid.to(torch.int64), 0)
    # slot of the k-th valid row (k = 1..n): one monotone binary search
    kth = torch.searchsorted(
        c, torch.arange(1, n + 1, dtype=torch.int64, device=c.device))
    src = kth[torch.clamp(c - 1, min=0)].clamp(max=n - 1)
    return torch.where(c > 0, v[src], fill)


def scan_identity(op: str, dtype: torch.dtype):
    """The exact identity of `op` (0, -inf/+inf for floats, the integer
    bounds for integers): what a scan seeds an open segment with, and what
    `segment_reduce` leaves in an empty segment."""
    if op == "add":
        return 0
    if dtype.is_floating_point:
        return -float("inf") if op == "max" else float("inf")
    info = torch.iinfo(dtype)
    return info.min if op == "max" else info.max


def segmented_scan(v: torch.Tensor, flags: torch.Tensor, op: str
                   ) -> torch.Tensor:
    """Inclusive segmented scan of `v` [N] or [N, C]: `out[i]` combines `v`
    over the run of rows since the last `flags`-marked position (inclusive).
    `flags[i]` marks a RESET at `i` (a segment start); the caller pre-fills
    rows that must not contribute (invalid rows) with the op identity.

    Log-depth Hillis–Steele shift-and-combine (the reference's
    `_seg_scan_flat`), the plain counterpart of the segmented-scan kernel."""
    fn = _OPS[op]
    n = v.shape[0]
    ident = scan_identity(op, v.dtype)
    f = flags.to(torch.bool)
    if v.ndim > 1:
        f = f[:, None]
    s = 1
    while s < n:
        pv = torch.cat([torch.full((s,) + v.shape[1:], ident, dtype=v.dtype,
                                   device=v.device), v[:-s]])
        pf = torch.cat([torch.ones((s,) + f.shape[1:], dtype=torch.bool,
                                   device=f.device), f[:-s]])
        v = torch.where(f, v, fn(v, pv))
        f = f | pf
        s <<= 1
    return v
