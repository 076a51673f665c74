"""Config registry, copied from ``repro/configs/__init__.py``:
``get_config(arch_id)`` for every assigned architecture, with ``*-smoke``
resolving to the reduced variant.  The per-architecture files beside it are
copies of the reference's (data only).
"""
from __future__ import annotations

from .base import (LM_SHAPES, ModelConfig, ShapeConfig, get_shape,
                   shape_applicable, smoke_variant)
from .whisper_base import CONFIG as whisper_base
from .qwen3_14b import CONFIG as qwen3_14b
from .deepseek_coder_33b import CONFIG as deepseek_coder_33b
from .qwen2_5_32b import CONFIG as qwen2_5_32b
from .internlm2_20b import CONFIG as internlm2_20b
from .deepseek_moe_16b import CONFIG as deepseek_moe_16b
from .dbrx_132b import CONFIG as dbrx_132b
from .llava_next_mistral_7b import CONFIG as llava_next_mistral_7b
from .recurrentgemma_9b import CONFIG as recurrentgemma_9b
from .xlstm_1_3b import CONFIG as xlstm_1_3b

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [
        whisper_base, qwen3_14b, deepseek_coder_33b, qwen2_5_32b,
        internlm2_20b, deepseek_moe_16b, dbrx_132b, llava_next_mistral_7b,
        recurrentgemma_9b, xlstm_1_3b,
    ]
}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return smoke_variant(get_config(name[: -len("-smoke")]))
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}") from None


__all__ = ["ARCHS", "LM_SHAPES", "ModelConfig", "ShapeConfig", "get_config",
           "get_shape", "shape_applicable", "smoke_variant"]
