"""Quantize-once packed NVFP4 weight preparation for serving (PyTorch).

Counterpart of ``repro.serve.packing``: every GEMM weight becomes a
``PackedQuantizedTensor`` (uint8 nibble codes + float8 block scales + pow2
tensor scale, ~0.5625 B/param) once, at engine build; the forward consumes
it through the K4 kernel.  Each per-layer weight gets its own tensor scale,
which is what the reference's ``batch_dims`` packing of the stacked layer
axis gives.  Norms, embeddings and smooth factors stay as they are.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core.quantize import (BlockQuantSpec, PackedQuantizedTensor,
                                       pack_quantize)
from repro_torch.models.config import ModelConfig

WEIGHT_KEYS = frozenset({
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "w_in", "w_out",
    "in_proj", "out_proj",
    "w_q", "w_k", "w_v", "w_gates", "w_ff_gate", "w_ff_up", "w_ff_down",
})
HEAD_KEYS = frozenset({"lm_head"})


def _packable(name: str, leaf, spec: BlockQuantSpec,
              quantize_lm_head: bool) -> bool:
    if name in HEAD_KEYS:
        if not quantize_lm_head:
            return False
    elif name not in WEIGHT_KEYS:
        return False
    if not isinstance(leaf, torch.Tensor) or leaf.ndim < 2:
        return False
    if not leaf.is_floating_point():
        return False
    return leaf.shape[-2] % spec.block == 0 and leaf.shape[-1] % 2 == 0


def _map(tree, fn, name=""):
    if isinstance(tree, dict):
        return {k: _map(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn, name) for v in tree)
    return fn(name, tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def pack_model_params(cfg: ModelConfig, params: Any,
                      spec: Optional[BlockQuantSpec]) -> Any:
    """Pack every GEMM weight of ``params`` with ``spec`` (fwd_w); with
    ``spec=None`` the tree is returned unchanged."""
    if spec is None:
        return params

    def pack(name, leaf):
        if not _packable(name, leaf, spec, cfg.quantize_lm_head):
            return leaf
        return pack_quantize(leaf, spec, axis=-2, batch_dims=leaf.ndim - 2)

    return _map(params, pack)


def weight_store_bytes(params: Any) -> int:
    """Total stored bytes (packed leaves at their packed size): the
    decode-path weight traffic of one full pass."""
    total = 0
    for leaf in _leaves(params):
        if isinstance(leaf, PackedQuantizedTensor):
            total += leaf.nbytes()
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
    return total
