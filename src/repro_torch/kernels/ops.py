"""The public wrappers of the kernels: the port's ``repro/kernels/ops.py``.

The same four names and arguments as the JAX package, less its
``interpret`` switch and its TPU tile sizes (``tm``, ``tn``, ``tk``): the
operands' device selects the kernel (CUDA tensors) or its plain PyTorch
version (CPU tensors), and each kernel picks its own tiles.

  block_quantize       -> K2 ``nvfp4_quant.block_quantize``
  block_matmul         -> K3 ``fp4_matmul.block_matmul``
  fused_quant_matmul   -> K1 ``fp4_matmul.fused_quant_matmul``
  packed_block_matmul  -> K4 ``fp4_matmul.packed_matmul`` (a (K, N)
                          ``PackedQuantizedTensor`` blocked along K)
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quantize import BlockQuantSpec
from repro_torch.kernels import nvfp4_quant as _q
from repro_torch.kernels.fp4_matmul import block_matmul  # noqa: F401
from repro_torch.kernels.fp4_matmul import fused_quant_matmul  # noqa: F401
from repro_torch.kernels.fp4_matmul import \
    packed_matmul as packed_block_matmul  # noqa: F401


def block_quantize(x: torch.Tensor, spec: BlockQuantSpec, *,
                   rbits: Optional[torch.Tensor] = None):
    """Standalone fused block-quantization kernel; returns (codes, scales)
    with the tensor scale computed (``nvfp4_quant.block_quantize`` also
    takes a given one)."""
    return _q.block_quantize(x, spec, rbits=rbits)
