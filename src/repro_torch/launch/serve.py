"""Serving launcher (PyTorch): lockstep batched generation, FP4 forward.

  python -m repro_torch.launch.serve --arch llama2-7b --batch 4 \\
      --prompt-len 64 --max-new 32

Initializes random parameters from a seeded ``torch.Generator``, builds the
lockstep Engine (weights packed to NVFP4 once) and runs synthetic prompts
through prefill + decode, reporting tokens/s.  Runs on the GPU unless
``--device cpu`` is given.  The continuous-batching flags of the JAX
launcher arrive with the ContinuousEngine slice (ROADMAP Queue 1).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import fqt
from repro_torch.models import registry
from repro_torch.serve import Engine, ServeConfig
from repro_torch.serve.packing import weight_store_bytes


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--kv-cache-format", default=None,
                    choices=("bf16", "nvfp4", "fp8"),
                    help="KV cache storage (nvfp4: 0.5625 bytes/elem; "
                         "bf16: unquantized escape hatch).  Default: nvfp4, "
                         "or bf16 when --bf16 is set")
    ap.add_argument("--bf16", action="store_true",
                    help="serve in bf16 instead of FP4 forward (also "
                         "defaults the KV cache to bf16)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the torch.Generator for weight init")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    params = registry.init_params(cfg, seed=args.seed, device=dev)
    kv_fmt = args.kv_cache_format or ("bf16" if args.bf16 else "nvfp4")
    scfg = ServeConfig(batch_size=args.batch, max_len=args.max_len,
                       temperature=args.temperature, kv_cache_format=kv_fmt,
                       seed=args.seed)
    qcfg = fqt.bf16_config() if args.bf16 else None
    eng = Engine(cfg, params, scfg, qcfg=qcfg, device=dev)
    del params
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, args.prompt_len)
               for _ in range(args.batch)]
    t0 = time.perf_counter()
    out = eng.generate(prompts, max_new=args.max_new)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    ntok = sum(len(o) for o in out)
    print(f"{ntok} tokens in {dt:.2f}s  ({ntok / dt:.1f} tok/s, incl. "
          f"kernel build on first use); weight store "
          f"{weight_store_bytes(eng.params)} bytes on {dev}")
    for i, o in enumerate(out[:4]):
        print(f"seq {i}: {o[:16].tolist()} ...")
    return out


if __name__ == "__main__":
    main()
