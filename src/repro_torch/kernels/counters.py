"""Launch counters of the port's kernels.

Each wrapper adds one to its count where it launches its CUDA kernel, and
nowhere else: the plain (CPU) path leaves the count alone.  A run sets the
counts to 0, drives the main path and reads them, which shows that the
path really went through the kernels.

Under a CUDA graph (``serve/graphs.py``) a launch is recorded once, at
capture, and runs at every replay.  The capture's bumps are no launches:
the graph takes them back and keeps them as its delta, and each replay
adds that delta with ``add``.  So a count is always the number of kernel
launches that ran, eager or replayed.
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


def add(delta: Dict[str, int]) -> None:
    """Count the launches of one graph replay: ``delta`` is {kernel: the
    launches its capture recorded}."""
    for k, n in delta.items():
        COUNTS[k] += n


def reset() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def snapshot() -> Dict[str, int]:
    return dict(COUNTS)
