"""Serving launcher (PyTorch): batched generation, FP4 forward.

  python -m repro_torch.launch.serve --arch llama2-7b --batch 4 \\
      --prompt-len 64 --max-new 32

  # continuous batching: 8 queued requests over 4 slots, 16-token pages,
  # the shared-prefix cache (CPU: the kernels' plain versions)
  python -m repro_torch.launch.serve --smoke --queue 8 --prefix-cache \\
      --device cpu

Initializes random parameters from a seeded ``torch.Generator`` (or
restores a params checkpoint over them with ``--ckpt-dir``), builds the
engine (weights packed to NVFP4 once) and runs synthetic prompts through
prefill + decode, reporting tokens/s.  With ``--queue`` (implied by
``--prefix-cache``, ``--prefill-chunk``, ``--spec-decode`` and ``--trace``)
the ContinuousEngine serves a staggered arrival trace through the
scheduler and the paged KV cache; without it the lockstep Engine serves
one static batch.  Runs on the GPU unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.core import fqt
from repro_torch.models import registry
from repro_torch.serve import ContinuousEngine, Engine, Request, ServeConfig
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
    ap.add_argument("--queue", type=int, default=0,
                    help="serve N queued requests through the continuous-"
                         "batching engine (staggered synthetic arrivals); "
                         "0 = lockstep batch")
    ap.add_argument("--max-slots", type=int, default=None,
                    help="continuous engine decode slots (default: --batch)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (paged cache pool)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill: admit prompts N tokens per "
                         "scheduler tick, interleaved with decode (implies "
                         "--queue)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="exact shared-prefix cache: admissions sharing "
                         "cached full-page prompt prefixes prefill only the "
                         "suffix (implies --queue)")
    ap.add_argument("--prefix-cache-pages", type=int, default=None,
                    help="cap on cached prefix pages (LRU-evicted)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="with --queue: give every synthetic request the "
                         "same N-token system prompt")
    ap.add_argument("--spec-decode", action="store_true",
                    help="speculative decoding: the first --draft-layers "
                         "layers of the same packed weights draft, one "
                         "verify pass accepts the longest greedy-agreeing "
                         "prefix + 1 (greedy; implies --queue)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="with --spec-decode: verify block size")
    ap.add_argument("--draft-layers", type=int, default=None,
                    help="with --spec-decode: self-draft depth in layers "
                         "(default: n_layers // 2)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record a Chrome-trace-event JSON of the serve run "
                         "(simulated tick clock) and write it to PATH "
                         "(implies --queue)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore the latest params checkpoint in this "
                         "directory over the seeded init")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the torch.Generator for weight init "
                         "(ignored with --ckpt-dir when a checkpoint is "
                         "restored)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    params = registry.init_params(cfg, seed=args.seed, device=dev)
    if args.ckpt_dir:
        step, restored = ckpt.restore_latest(args.ckpt_dir, params)
        if restored is not None:
            params = restored
            print(f"restored step-{step} checkpoint")
    kv_fmt = args.kv_cache_format or ("bf16" if args.bf16 else "nvfp4")
    scfg = ServeConfig(batch_size=args.batch, max_len=args.max_len,
                       temperature=args.temperature, kv_cache_format=kv_fmt,
                       seed=args.seed, page_size=args.page_size,
                       max_slots=args.max_slots,
                       prefix_cache=args.prefix_cache,
                       prefix_cache_pages=args.prefix_cache_pages,
                       prefill_chunk=args.prefill_chunk,
                       spec_k=args.spec_k if args.spec_decode else None,
                       draft_layers=(args.draft_layers
                                     if args.spec_decode else None))
    qcfg = fqt.bf16_config() if args.bf16 else None
    rng = np.random.default_rng(0)
    if (args.prefix_cache or args.prefill_chunk or args.spec_decode
            or args.trace) and not args.queue:
        args.queue = 8          # continuous-engine knobs imply --queue
    if args.queue:
        return _serve_queue(args, cfg, params, scfg, qcfg, dev, rng)
    eng = Engine(cfg, params, scfg, qcfg=qcfg, device=dev)
    del params
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


def _serve_queue(args, cfg, params, scfg, qcfg, dev, rng):
    """Continuous batching: staggered arrivals through the scheduler."""
    tracer = None
    if args.trace:
        from repro_torch.obs import Tracer
        tracer = Tracer(clock="tick", process="serve")
    eng = ContinuousEngine(cfg, params, scfg, qcfg=qcfg, device=dev,
                           tracer=tracer)
    del params
    shared = rng.integers(0, cfg.vocab_size, args.shared_prefix)
    reqs = [Request(rid=i,
                    prompt=np.concatenate(
                        [shared, rng.integers(0, cfg.vocab_size,
                                              args.prompt_len)]),
                    max_new=args.max_new, arrival=i // 2)
            for i in range(args.queue)]
    t0 = time.perf_counter()
    res = eng.run(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    ntok = sum(len(o) for o in res.values())
    st = eng.scheduler.stats
    print(f"{ntok} tokens / {st['completed']} requests in {dt:.2f}s "
          f"({ntok / dt:.1f} tok/s, incl. kernel build on first use; slot "
          f"util {eng.scheduler.slot_utilization:.2f}) on {dev}")
    print(f"paging: {st['private_pages']} private + {st['shared_pages']} "
          f"shared + {st['demand_pages']} on-demand pages; "
          f"{st['preemptions']} preemptions")
    ms = eng.metrics.summary()
    print(f"latency (simulated ticks): TTFT p50 "
          f"{ms['ttft_ticks']['p50']:.0f} / p95 "
          f"{ms['ttft_ticks']['p95']:.0f}, TPOT p50 "
          f"{ms['tpot_ticks']['p50']:.2f}, goodput {ms['goodput']:.2f}"
          + (f"; {len(eng.scheduler.prefill_log)} prefill chunks "
             f"(<= {args.prefill_chunk} tok/slot/tick)"
             if args.prefill_chunk else ""))
    if eng.scheduler.prefix_cache is not None:
        print(f"prefix cache: hit rate {eng.scheduler.prefix_hit_rate:.2f}, "
              f"{st['prefix_tokens_skipped']} prefill tokens skipped, "
              f"{st['prefilled_tokens']} prefilled")
    if args.spec_decode and "spec_accepted_per_tick_slot" in ms:
        acc, rate = (ms["spec_accepted_per_tick_slot"],
                     ms["spec_acceptance_rate"])
        print(f"speculative (k={args.spec_k}, draft "
              f"{eng.draft_layers}/{cfg.n_layers} layers): "
              f"{acc['mean']:.2f} accepted tokens/tick/slot "
              f"(p50 {acc['p50']:.0f}, p95 {acc['p95']:.0f}), "
              f"acceptance rate {rate['mean']:.2f} over {acc['n']} verify "
              f"samples")
    if tracer is not None:
        tracer.export(args.trace)
        print(f"trace: {tracer.n_events} events ({tracer.spans_opened} "
              f"spans, {len(tracer.open_spans())} unclosed) -> "
              f"{args.trace} (open in Perfetto: ui.perfetto.dev)")
    for rid in sorted(res)[:4]:
        print(f"req {rid}: {res[rid][:16].tolist()} ...")
    return res


if __name__ == "__main__":
    main()
