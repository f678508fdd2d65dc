"""Architecture configs the port runs (own copies of ``repro.configs``).

Each module exposes ``CONFIG``; ``get_config(name)`` resolves by arch id.
The port carries every arch of the JAX package: the dense and moe
transformers (the Llama-2 family, TinyLlama, CodeQwen1.5, Qwen2.5, Llama-3,
Mixtral and Qwen3-MoE), the recurrent archs (Zamba2-1.2B, hybrid; xLSTM-125M,
ssm), Whisper-base (encdec) and InternVL2-26B (vlm).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig  # noqa: F401

ARCH_IDS = (
    "mixtral_8x7b",
    "qwen3_moe_235b_a22b",
    "whisper_base",
    "internvl2_26b",
    "zamba2_1p2b",
    "qwen2p5_32b",
    "codeqwen1p5_7b",
    "tinyllama_1p1b",
    "llama3_405b",
    "xlstm_125m",
    "llama2_7b",
    "llama2_350m",
    "llama2_60m",
)

_ALIASES = {
    "mixtral-8x7b": "mixtral_8x7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "whisper-base": "whisper_base",
    "internvl2-26b": "internvl2_26b",
    "zamba2-1.2b": "zamba2_1p2b",
    "qwen2.5-32b": "qwen2p5_32b",
    "codeqwen1.5-7b": "codeqwen1p5_7b",
    "tinyllama-1.1b": "tinyllama_1p1b",
    "llama3-405b": "llama3_405b",
    "xlstm-125m": "xlstm_125m",
    "llama2-7b": "llama2_7b",
    "llama2-350m": "llama2_350m",
    "llama2-60m": "llama2_60m",
}


def get_config(name: str) -> ModelConfig:
    mod_name = _ALIASES.get(name, name.replace("-", "_").replace(".", "p"))
    if mod_name not in ARCH_IDS:
        raise ValueError(f"unknown arch {name!r}; the port has "
                         f"{list(_ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG
