"""Architecture registry of the port: ``get_config(arch_id)``.

Ported so far: ALBERT-large (the shared dense stack), the dense
decoders Qwen3-1.7B, ChatGLM3-6B and Qwen1.5-110B (RoPE, QKV bias,
QK-norm, unshared layers), the MoE decoders DeepSeek-V2-Lite-16B (MLA,
shared experts) and DBRX-132B, Gemma3-27B (local and global attention),
RecurrentGemma-9B (RG-LRU and local attention), Whisper-small (the
encoder and cross attention), Llama-3.2-Vision-11B (the projector and
gated cross attention) and Mamba2-2.7B (the SSM): every architecture of
the JAX package.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES,
    InputShape,
    LayerSpec,
    ModelConfig,
    reduce_config,
    shape_applicable,
)

_ARCH_MODULES = {
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "qwen1.5-110b": "qwen1_5_110b",
    "qwen3-1.7b": "qwen3_1_7b",
    "chatglm3-6b": "chatglm3_6b",
    "albert-large": "albert_large",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "dbrx-132b": "dbrx_132b",
    "gemma3-27b": "gemma3_27b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "whisper-small": "whisper_small",
    "mamba2-2.7b": "mamba2_2_7b",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; ported: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    cfg: ModelConfig = mod.CONFIG
    cfg.validate()
    return cfg


def list_archs():
    return list(_ARCH_MODULES)
