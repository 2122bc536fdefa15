"""Gradient compression for a slow all-reduce (multi-pod).

Port of `repro.train.compression`: int8 stochastic-rounded quantization
with a per-tensor scale, cutting the bytes a gradient all-reduce moves 4x
against float32.  Trees are flat `{name: tensor}` dicts.

The noise is drawn from a `torch.Generator` (on the tensors' device), so
its bits are not the reference's `jax.random.uniform` draws; `noise=`
takes given draws in [-0.5, 0.5) instead, which makes `quantize_int8` bit
for bit the reference's on the reference's noise.

`compressed_psum` is the single-controller form of the reference's
shard_map collective, as `core.distributed` holds its shards in one
process: it takes the participants' trees as a list and returns the one
tree every participant would receive.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import torch


def _noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Uniform draws in [-0.5, 0.5), float32."""
    return torch.rand(shape, generator=generator, dtype=torch.float32,
                      device=device) - 0.5


def quantize_int8(x: torch.Tensor, generator: Optional[torch.Generator],
                  noise: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stochastic-rounding int8 quantization with per-tensor scale:
    (int8 values, float32 0-d scale)."""
    xf = x.to(torch.float32)
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
    y = xf / scale
    if noise is None:
        noise = _noise(y.shape, generator, y.device)
    q = torch.clamp(torch.round(y + noise), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def compress_roundtrip(tree: Mapping[str, torch.Tensor],
                       generator: torch.Generator) -> dict:
    """Quantize+dequantize every leaf (the lossy channel without the
    collective, as a train step with `compress_grads` applies it)."""
    out = {}
    for k, leaf in tree.items():
        q, s = quantize_int8(leaf, generator)
        out[k] = dequantize_int8(q, s, leaf.dtype)
    return out


def compressed_psum(trees: Sequence[Mapping[str, torch.Tensor]],
                    generator: Optional[torch.Generator],
                    noise: Optional[Mapping[str, torch.Tensor]] = None
                    ) -> dict:
    """int8-compressed mean over participants: each quantizes, the int
    values are summed exactly in int32, and the result is dequantized with
    the largest participating scale and divided by their number.  Every
    participant draws the same noise for a leaf, as the reference's
    participants share its key; `noise` gives those draws by leaf name."""
    n = len(trees)
    out = {}
    for k, leaf in trees[0].items():
        nz = noise[k] if noise is not None else _noise(
            leaf.shape, generator, leaf.device)
        qs = [quantize_int8(t[k], None, nz) for t in trees]
        total = torch.stack([q.to(torch.int32) for q, _ in qs]).sum(
            0, dtype=torch.int32)
        smax = torch.stack([s for _, s in qs]).max()
        out[k] = (total.to(torch.float32) * smax / n).to(leaf.dtype)
    return out
