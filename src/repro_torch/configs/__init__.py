"""Configurations: the paper's evaluation data flows (`flows.py`) and the
model plane's architecture registry (port of `repro.configs`).

The ten architecture files and the assigned input shapes (`shapes.py`) are
pure data, copied as they are.  The reference's `input_specs` builds dry-run
stand-ins for XLA and stays behind.
"""

from __future__ import annotations

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
