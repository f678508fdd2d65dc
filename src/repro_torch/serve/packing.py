"""Quantize-once packed NVFP4 weight preparation for serving (PyTorch).

Counterpart of ``repro.serve.packing``: every GEMM weight becomes a
``PackedQuantizedTensor`` (uint8 nibble codes + float8 block scales + pow2
tensor scale, ~0.5625 B/param) once, at engine build; the forward consumes
it through the K4 kernel.  Each per-layer weight gets its own tensor scale,
which is what the reference's ``batch_dims`` packing of the stacked layer
axis gives (a moe layer's stacked (E, d, f) experts get one per expert).
Norms, embeddings, routers and smooth factors stay as they are, and so do
the recurrent families' conv weights, SSM parameters (``A_log``, ``D``,
``dt_bias``), gate biases and high-precision gate projections (``w_if``,
``r_gates``).

``init_packed_params`` builds the packed tree of a random init one layer at
a time: the same tree as packing the whole bf16 init, within the memory of a
card that could not hold that bf16 tree (qwen2.5-32b, Mixtral-8x7B); the
recurrent families' inits pack each layer, the shared block and the lm_head
as they are drawn in the same way.

Under a serving mesh (``mesh=``) both return THIS rank's shards
(``distributed/sharding.place_serve_params``): each weight is packed whole
-- its tensor scale is the weight's, as on one device -- and then sliced, so
the streaming packer holds one bf16 layer and this rank's packed slices,
never the whole packed model.  The few small high-precision weights that
every rank multiplies whole (``ENGINE_WHOLE``: zamba2's ``conv_w``,
xLSTM's ``w_if`` and ``r_gates``) are kept whole, so a decode step does
not gather them (the models gather one that comes as a shard).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core.quantize import (BlockQuantSpec, PackedQuantizedTensor,
                                       pack_quantize)
from repro_torch.distributed import sharding
from repro_torch.models import registry
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


def _pack_leaf(leaf: torch.Tensor, spec: BlockQuantSpec
               ) -> PackedQuantizedTensor:
    """``pack_quantize(leaf, axis=-2, batch_dims=leaf.ndim - 2)`` one
    leading slice at a time (a moe layer's experts): the same codes, block
    scales and per-slice tensor scales, with one slice's f32 temporaries
    alive at a time instead of the whole stack's (~4 GB more a process for
    one Mixtral-8x7B expert leaf)."""
    if leaf.ndim <= 2:
        return pack_quantize(leaf, spec, axis=-2)
    lead = tuple(leaf.shape[:-2])
    parts = [pack_quantize(x, spec, axis=-2)
             for x in leaf.reshape((-1,) + tuple(leaf.shape[-2:]))]

    def stack(field):
        t = torch.stack([getattr(q, field) for q in parts])
        return t.reshape(lead + tuple(t.shape[1:]))

    return PackedQuantizedTensor(stack("packed"), stack("scales"),
                                 stack("tscale"), parts[0].axis,
                                 parts[0].block, parts[0].dtype)


def _pack(cfg: ModelConfig, params: Any, spec: Optional[BlockQuantSpec]):
    if spec is None:
        return params

    def pack(name, leaf):
        if not _packable(name, leaf, spec, cfg.quantize_lm_head):
            return leaf
        return _pack_leaf(leaf, spec)

    return _map(params, pack)


def pack_model_params(cfg: ModelConfig, params: Any,
                      spec: Optional[BlockQuantSpec], mesh=None) -> Any:
    """Pack every GEMM weight of ``params`` with ``spec`` (fwd_w); with
    ``spec=None`` the tree is left unpacked.  ``mesh``: return this rank's
    shards of the tree (already-placed trees, such as
    ``init_packed_params(mesh=)`` gives, are taken as they are)."""
    if mesh is not None and mesh.size > 1:
        registry.check_mesh(cfg, mesh)
        if sharding.is_placed(params, cfg, mesh):
            return params
        return _placed(cfg, params, spec, mesh)
    return _pack(cfg, params, spec)


ENGINE_WHOLE = ("conv_w", "w_if", "r_gates")


def _placed(cfg: ModelConfig, tree: Any, spec, mesh) -> Any:
    """This rank's shards of ``tree`` packed (``place_serve_params``), the
    ENGINE_WHOLE leaves kept whole: small high-precision weights that every
    rank multiplies whole, which a decode step would otherwise gather
    again at every layer."""
    whole = {}
    sharding.map_paths(tree, lambda path, x: whole.update({path: x})
                       if path.rsplit("/", 1)[-1] in ENGINE_WHOLE else None)
    return sharding.map_paths(
        sharding.place_serve_params(_pack(cfg, tree, spec), mesh),
        lambda path, x: whole.get(path, x))


def init_packed_params(cfg: ModelConfig, gen: torch.Generator,
                       spec: Optional[BlockQuantSpec], device=None,
                       mesh=None) -> Any:
    """``pack_model_params(cfg, registry.init_params(cfg, generator=gen),
    spec, mesh)``, bit for bit (the same draws from ``gen`` in the same
    order), with each layer and the lm_head packed (and, under ``mesh``,
    cut to this rank's shards) as soon as it is drawn, so the bf16 tree
    never exists whole: peak memory is the packed tree, the bf16 embedding
    and one bf16 layer."""
    if mesh is not None and mesh.size > 1:
        registry.check_mesh(cfg, mesh)
        return registry.init_params(
            cfg, generator=gen, device=device,
            finish=lambda tree: _placed(cfg, tree, spec, mesh))
    return registry.init_params(
        cfg, generator=gen, device=device,
        finish=lambda tree: _pack(cfg, tree, spec))


def weight_store_bytes(params: Any) -> int:
    """Total stored bytes (packed leaves at their packed size): the
    decode-path weight traffic of one full pass (of this rank's shards,
    under a mesh)."""
    total = 0
    for leaf in _leaves(params):
        if isinstance(leaf, PackedQuantizedTensor):
            total += leaf.nbytes()
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
    return total


def weight_wire_bytes(params: Any) -> int:
    """Bytes an FSDP-style all-gather of the whole tree moves: packed leaves
    as their wire format (codes + block scales, ~4.5 bits a parameter,
    ``PackedQuantizedTensor.wire_nbytes``; the replicated tensor scale
    never travels), other leaves as stored."""
    total = 0
    for leaf in _leaves(params):
        if isinstance(leaf, PackedQuantizedTensor):
            total += leaf.wire_nbytes()
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
    return total
