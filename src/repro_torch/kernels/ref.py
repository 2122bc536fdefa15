"""Plain PyTorch versions of the data-plane kernels (port of the matching
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
