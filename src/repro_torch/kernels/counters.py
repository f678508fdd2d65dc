"""Launch counters of the port's kernels.

Each wrapper adds one to its count where it launches its CUDA kernel, and
nowhere else: the plain (CPU) path leaves the count alone.  A run sets the
counts to 0, drives the main path and reads them, which shows that the
path really went through the kernels.
"""
from __future__ import annotations

from typing import Dict

COUNTS: Dict[str, int] = {
    "fused_quant_matmul": 0,
    "block_quantize": 0,
    "block_matmul": 0,
    "packed_block_matmul": 0,
    "flash_attention_paged": 0,
    "flash_attention_packed": 0,
    "flash_attention": 0,
}


def bump(name: str) -> None:
    COUNTS[name] += 1


def reset() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def snapshot() -> Dict[str, int]:
    return dict(COUNTS)
