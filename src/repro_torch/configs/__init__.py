"""Configurations: the paper's evaluation data flows (`flows.py`) and the
model plane's architecture registry (port of `repro.configs`).

The ten architecture files and the assigned input shapes (`shapes.py`) are
pure data, copied as they are.  `input_specs` gives the dry-run's inputs
as meta tensors (shapes and dtypes, no memory), as the reference's gives
`ShapeDtypeStruct`s.
"""

from __future__ import annotations

import torch

from ..models.config import ModelConfig
from . import (granite_20b, llama3_2_1b, mixtral_8x22b, phi_3_vision_4_2b,
               qwen2_5_14b, qwen2_moe_a2_7b, qwen3_0_6b, recurrentgemma_2b,
               rwkv6_3b, whisper_tiny)
from .shapes import SHAPES, ShapeSpec, long_ok, shapes_for  # noqa: F401

_MODULES = {
    "qwen2.5-14b": qwen2_5_14b,
    "llama3.2-1b": llama3_2_1b,
    "granite-20b": granite_20b,
    "qwen3-0.6b": qwen3_0_6b,
    "rwkv6-3b": rwkv6_3b,
    "mixtral-8x22b": mixtral_8x22b,
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b,
    "recurrentgemma-2b": recurrentgemma_2b,
    "whisper-tiny": whisper_tiny,
    "phi-3-vision-4.2b": phi_3_vision_4_2b,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str, reduced: bool = False, **overrides) -> ModelConfig:
    mod = _MODULES[arch]
    cfg = mod.REDUCED if reduced else mod.FULL
    return cfg.with_(**overrides) if overrides else cfg


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Meta-tensor stand-ins for every model input of a dry-run cell: the
    reference's shapes and dtypes.  A decode cell's state is the model's
    own (`init_decode_state` on meta): per-layer caches, each "pos" a
    Python int, where the reference stacks the layers."""
    b, t = shape.batch, shape.seq

    def meta(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        batch = {"tokens": meta((b, t), torch.int32)}
        if cfg.family == "vlm":
            batch["img_embeds"] = meta((b, cfg.n_img_tokens, cfg.d_model),
                                       torch.float32)
        if cfg.family == "encdec":
            batch["audio_frames"] = meta((b, cfg.n_audio_frames,
                                          cfg.d_model), torch.float32)
        return {"batch": batch}
    if shape.kind == "decode":
        from ..models import make_model

        state = make_model(cfg, "meta").init_decode_state(b, t)
        return {"token": meta((b, 1), torch.int32), "state": state}
    raise ValueError(shape.kind)
