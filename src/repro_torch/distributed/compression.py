"""Low-precision wire formats of the mesh's collectives: the serving half.

Counterpart of ``repro.distributed.compression``.  A packed NVFP4 weight
already stores its wire format -- uint8 nibble codes (4 bits a parameter)
and f8 block scales (8 bits per 16) -- so the FSDP-style gather of a
sharded serving weight moves ~4.5 bits a parameter instead of 16 for a
bf16 gather; the per-slice pow2 tensor scale is replicated and never
travels.  ``allgather_packed`` is that gather over one mesh axis.

The gradient half (``compressed_psum_mean``, ``pod_mean_grads``) belongs
to the training mesh; here are only its data: the gradient specs
``GRAD_FP8`` / ``GRAD_FP4``, ``CompressionConfig`` and
``compression_ratio``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.quantize import BlockQuantSpec, PackedQuantizedTensor
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
    # bit-identical gradients
    requantize_result: bool = False


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
