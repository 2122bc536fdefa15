"""Assigned input shapes (one set, shared by all 10 LM-family archs).

Port of `repro.configs.shapes`, pure data copied as it is.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# long_500k requires sub-quadratic attention / bounded state:
#   rwkv6 (constant state), recurrentgemma (RG-LRU + 2048 local window),
#   mixtral (4096 sliding window -> bounded KV).
# Pure full-attention archs skip it (noted in DESIGN.md §5).
LONG_OK_FAMILIES = ("rwkv6", "hybrid")


def long_ok(cfg) -> bool:
    return cfg.family in LONG_OK_FAMILIES or (cfg.window is not None)


def shapes_for(cfg) -> list[str]:
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if long_ok(cfg):
        out.append("long_500k")
    return out
