"""Serving launcher (PyTorch): batched generation, FP4 forward.

  python -m repro_torch.launch.serve --arch llama2-7b --batch 4 \\
      --prompt-len 64 --max-new 32

  # the recurrent families (lockstep only: their prefill is one decode
  # step per prompt token)
  python -m repro_torch.launch.serve --arch zamba2-1.2b --batch 4
  python -m repro_torch.launch.serve --arch xlstm-125m --smoke --device cpu

  # the stub frontends: random frames for whisper's encoder, random patch
  # embeddings before InternVL2's prompt (with --queue, whisper's
  # ContinuousEngine gets random frames a request; the reference's
  # launcher passes none)
  python -m repro_torch.launch.serve --arch whisper-base --batch 4
  python -m repro_torch.launch.serve --arch internvl2-26b --batch 4

  # continuous batching: 8 queued requests over 4 slots, 16-token pages,
  # the shared-prefix cache (CPU: the kernels' plain versions)
  python -m repro_torch.launch.serve --smoke --queue 8 --prefix-cache \\
      --device cpu

  # a serving mesh: Megatron TP over 2 ranks (one process each, spawned
  # here, or joined from torchrun's RANK/WORLD_SIZE); on ONE card the ranks
  # share it through gloo, on the CPU gloo is the default
  python -m repro_torch.launch.serve --arch llama2-7b --mesh tp=2 \\
      --dist-backend gloo --queue 8
  python -m repro_torch.launch.serve --smoke --mesh dp=2,tp=2 --device cpu
  # the moe and vlm families too: the experts split as the rule table
  # splits any stacked weight, routing replicated on every rank
  python -m repro_torch.launch.serve --arch mixtral-8x7b --mesh tp=2 \
      --dist-backend gloo --layers 4
  python -m repro_torch.launch.serve --arch internvl2-26b --mesh tp=2 \
      --dist-backend gloo --layers 4
  # and the encdec, hybrid and ssm families (every rank gets whisper's
  # frames; the recurrent families on the lockstep Engine, as on one rank)
  python -m repro_torch.launch.serve --arch whisper-base --mesh tp=2 \
      --dist-backend gloo --queue 8
  python -m repro_torch.launch.serve --arch zamba2-1.2b --mesh tp=2 \
      --dist-backend gloo --layers 12

Initializes random parameters from a seeded ``torch.Generator``, packed to
NVFP4 layer by layer as they are drawn (``packing.init_packed_params``), or
restores a params checkpoint over a bf16 init with ``--ckpt-dir``; builds
the engine (weights packed to NVFP4 once) and runs synthetic prompts through
prefill + decode, reporting tokens/s.  With ``--queue`` (implied by
``--prefix-cache``, ``--prefill-chunk``, ``--spec-decode`` and ``--trace``)
the ContinuousEngine serves a staggered arrival trace through the
scheduler and the paged KV cache; without it the lockstep Engine serves
one static batch.  Runs on the GPU unless ``--device cpu`` is given.

With ``--mesh`` every rank packs only its shards of each layer as it is
drawn, serves the same requests on them (the programs eagerly: a mesh's
collectives are not captured in CUDA graphs), and rank 0 prints;
``--report DIR`` has every rank write ``DIR/rank<r>.json`` (its streams,
launch counts, collectives, timings and memory) and rank 0 the prompts'
last-token logits (B, V) of the run's sharded prefill
(``DIR/prefill_logits.npy``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import socket
import time
from pathlib import Path

import numpy as np
import torch

import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.core import fqt
from repro_torch.core.quantize import PackedQuantizedTensor
from repro_torch.distributed import mesh as dmesh
from repro_torch.distributed import specs as pspecs
from repro_torch.distributed.compression import (packed_gather_ratio,
                                                 packed_wire_bits_per_param)
from repro_torch.kernels import counters
from repro_torch.models import registry
from repro_torch.serve import ContinuousEngine, Engine, Request, ServeConfig
from repro_torch.serve import packing


def main(argv=None):
    """Serve as the arguments say.  A ``--mesh`` of more than one rank
    starts one process per rank first (``distributed.mesh.spawn``), or
    joins the world torchrun set up (RANK / WORLD_SIZE in the
    environment); the rank-0 result is returned where this process is
    rank 0."""
    args = _parser().parse_args(argv)
    need = math.prod(pspecs.parse_mesh_spec(args.mesh).values())
    if need == 1 or dist.is_initialized():
        return _serve(args)
    dev = resolve_device(args.device)
    backend = args.dist_backend or ("nccl" if dev.type == "cuda" else "gloo")
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://")
        try:
            return _serve(args)
        finally:
            dist.destroy_process_group()
    if dev.type == "cuda":
        # build the kernels once, before the ranks would race on the build
        from repro_torch.kernels import _build
        _build.build_all()
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    dmesh.spawn(_rank_main, need, backend=backend, device=dev,
                init_method=f"tcp://127.0.0.1:{port}", args=(argv,))
    return None


def _rank_main(rank: int, argv) -> None:
    _serve(_parser().parse_args(argv))


def _parser() -> argparse.ArgumentParser:
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
    ap.add_argument("--mesh", default=None,
                    help="serving mesh spec, e.g. 'tp=2', 'fsdp=2' or "
                         "'dp=2,tp=2': one process per rank, each holding "
                         "its shards of the packed weights and the KV heads "
                         "it attends with (tp -> 'model': heads / hidden / "
                         "vocab; dp/fsdp -> 'data', gathered before use); "
                         "default: the 1-rank mesh, the same code path")
    ap.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                    help="collectives' backend (default nccl on cuda, where "
                         "each rank owns a card; gloo on the cpu, and for "
                         "ranks sharing one card)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model's depth to N layers (full width)")
    ap.add_argument("--report", default=None, metavar="DIR",
                    help="every rank writes DIR/rank<r>.json; rank 0 also "
                         "DIR/prefill_logits.npy")
    return ap


def _serve(args):
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    qcfg = fqt.bf16_config() if args.bf16 else None
    mesh = dmesh.make_serve_mesh(args.mesh, device=dev,
                                 backend=args.dist_backend)
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    if args.mesh:
        say(f"serving mesh: {dict(zip(mesh.axis_names, mesh.shape))} over "
            f"{mesh.size} of {mesh.size} ranks ({mesh.backend or 'one rank'}"
            f"); packed weight collectives move "
            f"{packed_wire_bits_per_param():.2f} bits/param "
            f"({packed_gather_ratio():.2f}x less than bf16)")
    if args.ckpt_dir or args.bf16:
        params = registry.init_params(cfg, seed=args.seed, device=dev)
    else:
        # the serving default packs to NVFP4 (qaf_config's fwd_w): pack the
        # random init layer by layer (this rank's shards of it under a
        # mesh), so a model whose bf16 tree would not fit on the card is
        # built all the same
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed)
        params = packing.init_packed_params(cfg, gen, fqt.qaf_config().fwd_w,
                                            device=dev, mesh=mesh)
    if dev.type == "cuda":
        # the packer's temporaries back to the card: ranks may share it
        torch.cuda.empty_cache()
    if args.ckpt_dir:
        step, restored = ckpt.restore_latest(args.ckpt_dir, params)
        if restored is not None:
            params = restored
            say(f"restored step-{step} checkpoint")
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
                                     if args.spec_decode else None),
                       mesh=args.mesh)
    # a mesh's collectives are not captured: its programs run eagerly
    graphs = mesh.size == 1
    rng = np.random.default_rng(0)
    if (args.prefix_cache or args.prefill_chunk or args.spec_decode
            or args.trace) and not args.queue:
        args.queue = 8          # continuous-engine knobs imply --queue
    if args.queue:
        return _serve_queue(args, cfg, params, scfg, qcfg, dev, rng, mesh,
                            graphs, say)
    eng = Engine(cfg, params, scfg, qcfg=qcfg, device=dev, mesh=mesh,
                 cuda_graphs=graphs)
    eng.keep_prefill_logits = bool(args.report)
    del params
    prompts = [rng.integers(0, cfg.vocab_size, args.prompt_len)
               for _ in range(args.batch)]
    extras = {}
    if cfg.family == "encdec":
        extras["frames"] = torch.from_numpy(rng.standard_normal(
            (args.batch, cfg.enc_seq, cfg.d_model))).to(torch.bfloat16)
    if cfg.family == "vlm":
        extras["prefix_embeds"] = torch.from_numpy(rng.standard_normal(
            (args.batch, cfg.vision_tokens, cfg.d_model))).to(torch.bfloat16)
    counters.reset()
    t0 = time.perf_counter()
    out = eng.generate(prompts, max_new=args.max_new, extras=extras)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    ntok = sum(len(o) for o in out)
    say(f"{ntok} tokens in {dt:.2f}s  ({ntok / dt:.1f} tok/s, incl. "
        f"kernel build on first use); weight store "
        f"{packing.weight_store_bytes(eng.params)} bytes on {dev}")
    for i, o in enumerate(out[:4]):
        say(f"seq {i}: {o[:16].tolist()} ...")
    if args.report:
        _report(args, eng, prompts, {i: o for i, o in enumerate(out)}, dt,
                eng.steps, extras=extras)
    return out


def _serve_queue(args, cfg, params, scfg, qcfg, dev, rng, mesh, graphs,
                 say):
    """Continuous batching: staggered arrivals through the scheduler."""
    tracer = None
    if args.trace:
        from repro_torch.obs import Tracer
        tracer = Tracer(clock="tick", process="serve")
    eng = ContinuousEngine(cfg, params, scfg, qcfg=qcfg, device=dev,
                           tracer=tracer, mesh=mesh, cuda_graphs=graphs)
    del params
    shared = rng.integers(0, cfg.vocab_size, args.shared_prefix)
    reqs = [Request(rid=i,
                    prompt=np.concatenate(
                        [shared, rng.integers(0, cfg.vocab_size,
                                              args.prompt_len)]),
                    max_new=args.max_new, arrival=i // 2)
            for i in range(args.queue)]
    # whisper: every request its own random frames (as the lockstep path's
    # rows), so a slot that read another's encoder output would change its
    # stream
    extras = {r.rid: {"frames": torch.from_numpy(rng.standard_normal(
        (1, cfg.enc_seq, cfg.d_model))).to(torch.bfloat16)}
        for r in reqs} if cfg.family == "encdec" else None
    counters.reset()
    t0 = time.perf_counter()
    res = eng.run(reqs, extras=extras)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    ntok = sum(len(o) for o in res.values())
    st = eng.scheduler.stats
    say(f"{ntok} tokens / {st['completed']} requests in {dt:.2f}s "
        f"({ntok / dt:.1f} tok/s, incl. kernel build on first use; slot "
        f"util {eng.scheduler.slot_utilization:.2f}) on {dev}")
    say(f"paging: {st['private_pages']} private + {st['shared_pages']} "
        f"shared + {st['demand_pages']} on-demand pages; "
        f"{st['preemptions']} preemptions")
    ms = eng.metrics.summary()
    say(f"latency (simulated ticks): TTFT p50 "
        f"{ms['ttft_ticks']['p50']:.0f} / p95 "
        f"{ms['ttft_ticks']['p95']:.0f}, TPOT p50 "
        f"{ms['tpot_ticks']['p50']:.2f}, goodput {ms['goodput']:.2f}"
        + (f"; {len(eng.scheduler.prefill_log)} prefill chunks "
           f"(<= {args.prefill_chunk} tok/slot/tick)"
           if args.prefill_chunk else ""))
    if eng.scheduler.prefix_cache is not None:
        say(f"prefix cache: hit rate {eng.scheduler.prefix_hit_rate:.2f}, "
            f"{st['prefix_tokens_skipped']} prefill tokens skipped, "
            f"{st['prefilled_tokens']} prefilled")
    if args.spec_decode and "spec_accepted_per_tick_slot" in ms:
        acc, rate = (ms["spec_accepted_per_tick_slot"],
                     ms["spec_acceptance_rate"])
        say(f"speculative (k={args.spec_k}, draft "
            f"{eng.draft_layers}/{cfg.n_layers} layers): "
            f"{acc['mean']:.2f} accepted tokens/tick/slot "
            f"(p50 {acc['p50']:.0f}, p95 {acc['p95']:.0f}), "
            f"acceptance rate {rate['mean']:.2f} over {acc['n']} verify "
            f"samples")
    if tracer is not None and mesh.rank == 0:
        tracer.export(args.trace)
        say(f"trace: {tracer.n_events} events ({tracer.spans_opened} "
            f"spans, {len(tracer.open_spans())} unclosed) -> "
            f"{args.trace} (open in Perfetto: ui.perfetto.dev)")
    for rid in sorted(res)[:4]:
        say(f"req {rid}: {res[rid][:16].tolist()} ...")
    if args.report:
        _report(args, eng, [r.prompt for r in reqs[:args.batch]], res, dt,
                st["decode_steps"], ticks=ms["ticks"], extras=extras and {
                    "frames": torch.cat([extras[r.rid]["frames"]
                                         for r in reqs[:args.batch]])})
    return res


def _report(args, eng, prompts, streams, seconds, steps, ticks=None,
            extras=None):
    """``--report``: this rank's streams and greedy margins, launch counts
    and program calls of the run, its collectives (calls, bytes sent, host
    seconds), the run's seconds, the weight bytes it stores and their wire
    bytes a GEMM parameter, and peak memory; and the prompts' last-token
    logits (B, V), which rank 0 saves: the lockstep ``Engine``'s own
    prefill of the run (after its ``extras``), or for the
    ``ContinuousEngine`` one sharded prefill of ``prompts`` on a fresh
    lockstep cache, left-padded as ``Engine`` pads, whose seconds are
    reported."""
    out = Path(args.report)
    out.mkdir(parents=True, exist_ok=True)
    dev, mesh, cfg = eng.device, eng.mesh, eng.cfg
    launches = counters.snapshot()
    coll = json.loads(json.dumps(mesh.stats))     # the run's, not the prefill's
    calls = {n: p.calls for n, p in eng.programs.items()}
    margins = eng.margins if isinstance(eng.margins, dict) else dict(
        enumerate(eng.margins))
    packed = [lf for lf in packing._leaves(eng.params)
              if isinstance(lf, PackedQuantizedTensor)]
    gemm_params = sum(math.prod(lf.shape) for lf in packed)
    logits, prefill_s = getattr(eng, "prefill_logits", None), None
    if logits is None:
        toks = np.zeros((len(prompts), max(len(p) for p in prompts)),
                        np.int64)
        for i, p in enumerate(prompts):
            toks[i, toks.shape[1] - len(p):] = p
        carry = registry.make_decode_state(
            cfg, len(prompts), eng.scfg.max_len,
            kv_cache_format=eng.scfg.kv_cache_format, device=dev, mesh=mesh)
        with torch.no_grad():
            t0 = time.perf_counter()
            logits, _ = registry.prefill(
                eng.params, cfg, eng.qcfg, torch.from_numpy(toks).to(dev),
                carry, extras={k: v.to(dev)
                               for k, v in (extras or {}).items()},
                mesh=mesh)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            prefill_s = time.perf_counter() - t0
    if mesh.rank == 0:
        np.save(out / "prefill_logits.npy",
                logits[:len(prompts)].to(torch.float32).cpu().numpy())
    rec = {
        "rank": mesh.rank, "mesh": dict(zip(mesh.axis_names, mesh.shape)),
        "backend": mesh.backend,
        "streams": {str(k): np.asarray(v).tolist()
                    for k, v in streams.items()},
        "margins": {str(k): np.asarray(v, np.float64).tolist()
                    for k, v in margins.items()},
        "launches": launches, "calls": calls, "seconds": seconds,
        "steps": steps,
        "ticks": ticks, "tokens": int(sum(len(v) for v in streams.values())),
        "collectives": coll, "prefill_s": prefill_s,
        "weight_store_bytes": packing.weight_store_bytes(eng.params),
        "weight_wire_bytes": packing.weight_wire_bytes(eng.params),
        "gemm_params": gemm_params,
        "gemm_wire_bytes": sum(lf.wire_nbytes() for lf in packed),
        "peak_allocated": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None),
    }
    (out / f"rank{mesh.rank}.json").write_text(json.dumps(rec))


if __name__ == "__main__":
    main()
