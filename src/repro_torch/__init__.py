"""PyTorch/CUDA port of the FP4-FQT system, beside the JAX package ``repro``.

It serves (the lockstep ``serve.Engine.generate`` from packed NVFP4
weights with nvfp4 / fp8 / bf16 KV caches) and trains (``train.Trainer``
under the paper's FQT scheme: NVFP4 at all six GEMM points, AdamW, the
sqrt(3) monitor and the QAF switch).  Its kernels (``kernels/``) are
hand-written CUDA for Hopper; every entry point runs on ``cuda`` unless the
caller passes ``device="cpu"``.  Nothing here imports jax or ``repro``.
"""
