"""Config registry: one module per assigned architecture (+ the paper's own
serving/embedding configs).  ``get_config(arch_id)`` resolves the exact
assignment ids (e.g. "phi3.5-moe-42b-a6.6b")."""
from __future__ import annotations

from repro_torch.models.config import INPUT_SHAPES, InputShape, ModelConfig  # noqa: F401


def _load(modname: str):
    import importlib
    return importlib.import_module(f"repro_torch.configs.{modname}").get_config


_REGISTRY = {
    "stablelm-3b": "stablelm_3b",
    "mamba2-2.7b": "mamba2_2p7b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "qwen2.5-14b": "qwen2_5_14b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b_a6_6b",
    "qwen3-8b": "qwen3_8b",
    "whisper-small": "whisper_small",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "internlm2-1.8b": "internlm2_1p8b",
    "paligemma-3b": "paligemma_3b",
    "memori-agent": "memori_agent",
    "memori-embedder": "memori_embedder",
}

ASSIGNED_ARCHS = tuple(k for k in _REGISTRY if not k.startswith("memori-"))


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return _load(_REGISTRY[arch_id])()


def list_archs():
    return sorted(_REGISTRY)
