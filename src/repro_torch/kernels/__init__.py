"""Hand-written Hopper kernels (``csrc/``) and their plain PyTorch versions.

  K1 ``fp4_matmul.fused_quant_matmul``       every training GEMM (fwd, dX, dW)
  K4 ``fp4_matmul.packed_block_matmul``      every serving weight GEMM + lm_head
  K5 ``flash_attn.flash_attention_paged``    paged attention, continuous batching
  K6 ``flash_attn.flash_attention_packed``   decode attention, packed cache
  K7 ``flash_attn.flash_attention``          prefill attention

Kernels are built with nvcc at first use (``_build.py``); importing this
package builds nothing.
"""
