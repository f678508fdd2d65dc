"""Architecture configs the port runs (own copies of ``repro.configs``).

Each module exposes ``CONFIG``; ``get_config(name)`` resolves by arch id.
The port carries the dense Llama-2 family and TinyLlama; the other archs of
the JAX package arrive with ROADMAP Queue 1's breadth items.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig  # noqa: F401

ARCH_IDS = ("tinyllama_1p1b", "llama2_7b", "llama2_350m", "llama2_60m")

_ALIASES = {
    "tinyllama-1.1b": "tinyllama_1p1b",
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
