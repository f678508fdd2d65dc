"""PyTorch/CUDA port of the FP4-FQT system, beside the JAX package ``repro``.

Slice 1 is the lockstep serving path: packed NVFP4 weights, the nvfp4 /
fp8 / bf16 KV caches, ``serve.Engine.generate``.  Its kernels (``kernels/``)
are hand-written CUDA for Hopper; every entry point runs on ``cuda`` unless
the caller passes ``device="cpu"``.  Nothing here imports jax or ``repro``.
"""
