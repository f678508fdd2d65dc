"""Hand-written Hopper kernels (``csrc/``) and their plain PyTorch versions.

  K1 ``fp4_matmul.fused_quant_matmul``       every training GEMM (fwd, dX, dW)
  K2 ``nvfp4_quant.block_quantize``          standalone quantizer (``ops``)
  K3 ``fp4_matmul.block_matmul``             pre-quantized GEMM (``ops``)
  K4 ``fp4_matmul.packed_block_matmul``      every serving weight GEMM + lm_head
  K5 ``flash_attn.flash_attention_paged``    paged attention, continuous batching
  K6 ``flash_attn.flash_attention_packed``   decode attention, packed cache
  K7 ``flash_attn.flash_attention``          prefill attention

K1 and K3 share the tensor-core GEMM core ``csrc/fp4_gemm.cuh``.
``ops`` holds the public wrappers of the JAX package's ``kernels/ops.py``
and ``ref`` its oracles.  Kernels are built with nvcc at first use
(``_build.py``); importing this package builds nothing.
"""
