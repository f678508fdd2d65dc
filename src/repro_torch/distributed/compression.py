"""Low-precision wire formats of the mesh's collectives.

Counterpart of ``repro.distributed.compression``.

**The gradient half** (the training mesh): ``pod_mean_grads`` averages the
gradients over the "pod" axis, the only inter-pod traffic of a step; with a
``CompressionConfig`` each pod first quantizes its gradient shard with SR
(``compressed_psum_mean``: block-scaled low-precision codes, so the mean
stays unbiased) and the pods sum the fake-quantized values in f32, as the
reference's ``psum`` does (a wire format that moves the codes is work for
a later slice).  The quantize-dequantize runs through K2
(``kernels/nvfp4_quant.block_quantize``) on the card.

  * Each leaf's tensor scale comes from its global |max| (all-reduced MAX
    over the in-pod axes that shard it); blocks of ``spec.block`` run
    along the flattened leaf, as the reference's ``ravel()``: a shard is
    blocked that way only where its last dim is a whole number of blocks
    (else ``ValueError`` naming the leaf), a replicated leaf is padded to a
    whole block as ``_leaf_compress_psum`` pads it.
  * Declared divergence: the SR bits are ``counter_bits`` of a seed of
    (step, leaf index, pod index) at the leaf's global flat indices, in
    place of the reference's ``fold_in`` threefry keys.
  * Declared divergence of semantics: under GSPMD the reference hands
    every pod the already-global gradient; here each pod holds the mean
    of its own tokens (the per-pod local means of the reference's
    docstring), computed with the global tensor scales.  Both are unbiased
    estimates of the same mean.

**The serving half**: a packed NVFP4 weight already stores its wire format
-- uint8 nibble codes (4 bits a parameter) and f8 block scales (8 bits per
16) -- so the FSDP-style gather of a sharded serving weight moves ~4.5 bits
a parameter instead of 16 for a bf16 gather; the per-slice pow2 tensor
scale is replicated and never travels.  ``allgather_packed`` is that
gather over one mesh axis.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional

import torch

from repro_torch.core.formats import M32, counter_at
from repro_torch.core.quantize import (BlockQuantSpec, PackedQuantizedTensor,
                                       _tensor_scale)
from repro_torch.distributed import specs as pspecs

# E4M3 codes + E4M3 block scales (two-level), SR: the inter-pod gradient
# all-reduce's format; the NVFP4 variant for bandwidth-starved links
GRAD_FP8 = BlockQuantSpec(data_fmt="e4m3", scale_fmt="e4m3", block=32,
                          two_level=True, stochastic=True)
GRAD_FP4 = BlockQuantSpec(data_fmt="e2m1", scale_fmt="e4m3", block=16,
                          two_level=True, stochastic=True)


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    enabled: bool = True
    spec: BlockQuantSpec = GRAD_FP8
    # quantize the result again after the reduction, so every pod holds
    # bit-identical gradients (read by neither package's pod_mean_grads:
    # the f32 all-reduce already gives every pod the same bits)
    requantize_result: bool = False


def leaf_seed(seed: int, leaf: int, pod: int) -> int:
    """The SR seed of one gradient leaf on one pod: a mix of the step's
    seed, the leaf's index in tree order and the pod's index."""
    s = (int(seed) * 0x9E3779B1) & M32
    s ^= ((leaf + 1) * 0x632BE5AB) & M32
    s = (s * 0x85EBCA6B) & M32
    return s ^ (((pod + 1) * 0x7FB5D329) & M32)


def _fake_quant_rows(x2: torch.Tensor, spec: BlockQuantSpec,
                     ts: torch.Tensor, counter) -> torch.Tensor:
    """codes x block scale x tensor scale of an f32 (R, C) tensor blocked
    along C: K2 on the card, its plain version on the CPU."""
    from repro_torch.kernels.nvfp4_quant import block_quantize
    codes, scales = block_quantize(x2, spec, tscale=ts, counter=counter)
    R, C = x2.shape
    q = codes.view(R, C // spec.block, spec.block)
    return q.mul_(scales.unsqueeze(-1)).mul_(ts).view(R, C)


def _leaf_compress_psum(g: torch.Tensor, path: str, leaf: int, seed: int,
                        mesh, axis: str, spec: BlockQuantSpec,
                        npods: int) -> torch.Tensor:
    """One leaf: quantize this rank's shard (global tensor scale, the
    leaf's global flat indices for the SR bits), sum over ``axis`` in f32,
    divide by ``npods``."""
    from repro_torch.distributed import sharding
    lspec = sharding.placed_spec(path, g.ndim, mesh)
    shard_axes = tuple(a for a in sharding.spec_axes(lspec) if a != axis)
    g32 = g.to(torch.float32)
    B = spec.block
    seed32 = leaf_seed(seed, leaf, mesh.axis_index(axis))
    if shard_axes:
        if g.shape[-1] % B:
            raise ValueError(
                f"{path}: a shard {tuple(g.shape)} is blocked along the "
                f"flattened leaf only where its last dim is a whole number "
                f"of blocks of {B}")
        full, off = sharding.shard_offsets(lspec, g.shape, mesh)
        C = g.shape[-1]
        # one (rows, C) block per index of the dims before the last two (a
        # moe layer's stacked experts): each block's rows are a
        # progression of the whole leaf's flat indices
        parts = []
        for idx in itertools.product(*(range(k) for k in g.shape[:-2])):
            pos = tuple(o + i for o, i in zip(off, idx)) + tuple(off[-2:])
            first = sum(o * math.prod(full[d + 1:])
                        for d, o in enumerate(pos))
            parts.append((g32[idx].reshape(-1, C), first))
    else:
        flat = g32.reshape(-1)
        pad = (-flat.numel()) % B
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        x2 = flat[None]
    amax = torch.amax(torch.abs(g32)).reshape(1)
    mesh.all_reduce(amax, shard_axes, op="max")
    ts = _tensor_scale(amax, spec).reshape(1)
    if shard_axes:
        q = torch.cat([_fake_quant_rows(
            x2.contiguous(), spec, ts, (counter_at(seed32, first), full[-1],
                                        1) if spec.stochastic else None)
            for x2, first in parts])
    else:
        q = _fake_quant_rows(x2.contiguous(), spec, ts, (
            seed32, x2.shape[1], 1) if spec.stochastic else None)
    q = mesh.all_reduce(q, axis)
    out = (q / npods).reshape(-1)[:g.numel()] if not shard_axes \
        else q / npods
    return out.reshape(g.shape).to(g.dtype)


def compressed_psum_mean(grads, seed: int, mesh, axis: str,
                         spec: BlockQuantSpec, npods: int):
    """Compressed mean over ``axis`` of a gradient tree of this rank's
    shards (the port's tree layout): each leaf quantized with SR by
    ``_leaf_compress_psum`` under its own seed (``leaf_seed``), summed,
    divided by ``npods``.  ``seed``: the step's uint32 seed."""
    from repro_torch.distributed.sharding import _walk
    index = itertools.count()
    return _walk(grads, lambda path, g: _leaf_compress_psum(
        g, path, next(index), seed, mesh, axis, spec, npods)
        if isinstance(g, torch.Tensor) else g)


def pod_mean_grads(grads, seed: int, mesh, cfg: Optional[CompressionConfig]):
    """The mean of the pods' gradients over the "pod" axis: the identity
    without a "pod" axis or at one pod, the exact f32 mean where ``cfg``
    is None or disabled, else ``compressed_psum_mean`` with ``cfg.spec``.
    ``grads``: this rank's shards of its pod's mean gradient; ``seed``:
    the step's uint32 seed."""
    npods = mesh.axis_size("pod")
    if npods == 1:
        return grads
    if cfg is None or not cfg.enabled:
        from repro_torch.optim.adamw import tree_map
        return tree_map(lambda g: (mesh.all_reduce(
            g.to(torch.float32, copy=True), "pod") / npods).to(g.dtype),
            grads)
    return compressed_psum_mean(grads, seed, mesh, "pod", cfg.spec, npods)


def _nbits(fmt) -> int:
    return int(fmt.signed) + fmt.exp_bits + fmt.man_bits


def compression_ratio(spec: BlockQuantSpec, src_bits: int = 16) -> float:
    """Wire bytes ratio vs uncompressed (bf16) gradients."""
    return src_bits / (_nbits(spec.data) + _nbits(spec.scale) / spec.block)


def packed_wire_bits_per_param(block: int = 16) -> float:
    """Bits a parameter an all-gather of packed NVFP4 weights moves (4.5)."""
    return pspecs.packed_wire_bits_per_param(block)


def packed_gather_ratio(block: int = 16, src_bits: int = 16) -> float:
    """bf16-gather bytes / packed-gather bytes (~3.56x for NVFP4)."""
    return src_bits / packed_wire_bits_per_param(block)


def allgather_packed(pt: PackedQuantizedTensor, mesh, axis: str,
                     dim: int = 0) -> PackedQuantizedTensor:
    """All-gather this rank's shard of a packed weight along logical ``dim``
    over mesh ``axis``: the FSDP-style weight gather of sharded serving.

    Only the wire format travels: the uint8 nibble codes, and the block
    scales viewed as uint8 (gloo has no float8; the bytes are the same);
    never the tensor scale.  Along the nibble-packed last axis the bytes
    are gathered as they lie, which needs an even number of columns a
    shard (two columns a byte, none split between ranks); the reference's
    ``allgather_packed`` refuses that axis, which its GSPMD gathers."""
    if not isinstance(pt, PackedQuantizedTensor):
        raise TypeError(f"allgather_packed takes a PackedQuantizedTensor, "
                        f"got {type(pt).__name__}")
    dim = dim % pt.ndim
    packed = mesh.all_gather(pt.packed, axis, dim=dim)
    if pt.scales.element_size() == 1:
        scales = mesh.all_gather(pt.scales.view(torch.uint8), axis,
                                 dim=dim).view(pt.scales.dtype)
    else:
        scales = mesh.all_gather(pt.scales, axis, dim=dim)
    return dataclasses.replace(pt, packed=packed, scales=scales)
