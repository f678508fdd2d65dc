#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU: serve and
train.

    python3 chip_smoke.py                    # every phase, one CUDA card
    python3 chip_smoke.py --phases env,kernels

Phases, each printing JSON lines; any failure exits non-zero:

  env      torch/CUDA versions, the card's name and power limit, and the
           build of every ``csrc/*.cu`` kernel from the checkout (nvcc).
  kernels  each hand-written kernel against its plain PyTorch version on the
           same card tensors, at the main path's shapes: f32 outputs at
           rtol = atol = 1e-5, bf16 outputs to one bf16 ulp (+ 1e-5).
  serve    the lockstep Engine serving llama2-7b at full width from packed
           NVFP4 weights (random, seeded) with an nvfp4 KV cache: batch 4,
           prompt 64, 32 new tokens, greedy.  The launch counts are zeroed
           just before and read just after; every kernel of the path must
           have run the expected number of times.  Outputs are checked for
           range and finiteness, and the same Engine at smoke size on the
           card is held to the plain versions on the CPU.
  train    one llama2-60m smoke train step (nvfp4_paper_config) on the
           card held to the same step on the CPU's plain versions (loss,
           per-leaf grads, parameter updates), the SR streams held bit for
           bit; then llama2-7b at full width, depth cut to 4 layers, batch
           4 x seq 1024, remat, AdamW: 1 warm + 3 timed steps with finite
           metrics and K1's launches per step as the FQT dispatch rules
           derive them, peak memory and one profiled step's idle share.
  times    median CUDA-event time of each kernel at the main paths' shapes
           (L2 flushed before every launch, as a step finds its operands
           cold), beside its bound, its plain version and one PyTorch call
           computing the same function (a yardstick the port never calls).

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
repository beside it, the script fails before printing either.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PHASES = ("env", "kernels", "serve", "train", "times")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
BF16_OPS_PER_S = 989e12            # H100 SXM dense bf16 tensor-core peak
SEED = 0

# (M, K, N) of K4 on the main path: M = 4 decode rows, M = 256 prefill rows
# (batch 4 x prompt 64); llama2-7b's wq/wk/wv/wo, w_gate/w_up, w_down and
# lm_head, with their launches per forward pass.
K4_WEIGHTS = ((4096, 4096, 4 * 32), (4096, 11008, 2 * 32), (11008, 4096, 32),
              (4096, 32000, 1))
K4_SHAPES = tuple((m, k, n) for m in (4, 256) for k, n, _ in K4_WEIGHTS)
K6_CASES = (  # (B, H, KVH, D, Sk, kv_len): llama2-7b, then tinyllama (G = 8)
    (4, 32, 32, 128, 256, 65), (4, 32, 32, 128, 256, 80),
    (4, 32, 32, 128, 256, 96), (4, 32, 4, 64, 256, 96))
K7_CASES = (  # (B, S, H, KVH, D, dtype name)
    (4, 64, 32, 32, 128, "float32"), (4, 64, 32, 32, 128, "bfloat16"),
    (4, 64, 32, 4, 64, "bfloat16"))
# K1 on llama2-7b's training GEMMs at M = 4096 tokens (batch 4 x seq 1024):
# (label, M, K, N, spec, SR on A, SR on B, input scale of A, of B) -- the
# forward z = x @ W (RtN both), the backward dX = g @ W^T (SR on g) and the
# update dW = x^T @ g (SR both), with g at a gradient's small magnitude.
K1_CASES = (
    ("fwd", 4096, 4096, 11008, "nvfp4", False, False, 1.0, 0.02),
    ("dX", 4096, 11008, 4096, "nvfp4", True, False, 1e-4, 0.02),
    ("dW", 4096, 4096, 11008, "nvfp4", True, True, 1.0, 1e-4),
    ("lm_head dX", 4096, 32000, 4096, "nvfp4", True, False, 1e-4, 0.02),
    ("fwd mxfp4", 4096, 4096, 4096, "mxfp4", False, False, 1.0, 0.02),
    ("dW mxfp4", 4096, 4096, 4096, "mxfp4", True, True, 1.0, 1e-4),
    ("ragged smoke", 200, 48, 72, "nvfp4", True, True, 1.0, 0.1),
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def gen(device, seed):
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


# ---- comparisons ------------------------------------------------------------------


def bf16_ulp(x):
    """Spacing of bf16 at |x| (normal range)."""
    import torch
    _, e = torch.frexp(x.abs().float().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def compare(got, want) -> dict:
    """f32: rtol = atol = 1e-5; bf16: within one bf16 ulp (+ 1e-5)."""
    import torch
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError("kernel output is not finite")
    err = (g - w).abs()
    if got.dtype == torch.float32:
        ok = bool((err <= 1e-5 + 1e-5 * w.abs()).all())
        rule = "rtol=atol=1e-5"
    else:
        # one bf16 ulp of the larger value, plus the f32 atol: near zero
        # the f32 sums' cancellation error alone exceeds a bf16 ulp
        tol = bf16_ulp(torch.maximum(g.abs(), w.abs())) + 1e-5
        ok = bool((err <= tol).all())
        rule = "1 bf16 ulp + 1e-5"
    return {"ok": ok, "max_abs_err": float(err.max()), "rule": rule}


# ---- inputs at the main path's shapes -----------------------------------------------


def k4_inputs(M, K, N, dev, seed=SEED):
    import torch
    from repro_torch.core.quantize import NVFP4, pack_quantize
    g = gen(dev, seed)
    a = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((K, N), generator=g, device=dev) * K ** -0.5
         ).to(torch.bfloat16)
    return a, pack_quantize(w, NVFP4, axis=-2)


def k6_inputs(B, H, KVH, D, Sk, kv_len, q_dtype, dev, fmt="nvfp4",
              seed=SEED):
    import torch
    from repro_torch.core.quantize import kv_quant_rows
    g = gen(dev, seed)
    q = torch.randn((B, 1, H, D), generator=g, device=dev).to(q_dtype)
    kv = torch.randn((2, B, Sk, KVH, D), generator=g, device=dev
                     ).to(torch.bfloat16)
    kc, ks = kv_quant_rows(kv[0], fmt)
    vc, vs = kv_quant_rows(kv[1], fmt)
    pos = torch.tensor([kv_len - 1, kv_len], dtype=torch.int32, device=dev)
    return q, kc, ks, vc, vs, pos


def k7_inputs(B, S, H, KVH, D, dtype, dev, seed=SEED):
    import torch
    g = gen(dev, seed)
    return tuple(torch.randn(s, generator=g, device=dev).to(dtype) for s in
                 ((B, S, H, D), (B, S, KVH, D), (B, S, KVH, D)))


def k1_inputs(M, K, N, fmt, sr_a, sr_b, scale_a, scale_b, dev, seed=SEED):
    """bf16 operands and, for SR operands, counter bits of their shapes."""
    import torch
    from repro_torch.core.formats import counter_bits
    from repro_torch.core.quantize import MXFP4, NVFP4
    g = gen(dev, seed)
    a = (torch.randn((M, K), generator=g, device=dev) * scale_a
         ).to(torch.bfloat16)
    b = (torch.randn((K, N), generator=g, device=dev) * scale_b
         ).to(torch.bfloat16)
    base = NVFP4 if fmt == "nvfp4" else MXFP4
    spec_a, spec_b = base.with_rounding(sr_a), base.with_rounding(sr_b)
    ra = counter_bits(seed + 1, (M, K), device=dev) if sr_a else None
    rb = counter_bits(seed + 2, (K, N), device=dev) if sr_b else None
    return a, b, spec_a, spec_b, ra, rb


# ---- phases ------------------------------------------------------------------------


def phase_env(dev) -> dict:
    import torch
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    out_dir = ROOT / "chiprun_out" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    ptxas = _build.ptxas_report()
    (out_dir / "ptxas.txt").write_text("\n".join(
        f"===== {k} =====\n{v}" for k, v in ptxas.items()))
    spills = {k: [ln.strip() for ln in v.splitlines()
                  if "spill" in ln and "0 bytes spill" not in ln]
              for k, v in ptxas.items()}
    info = {"phase": "env", "python": sys.version.split()[0],
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "card": card_line(), "kind": torch.cuda.get_device_name(dev),
            "count": torch.cuda.device_count(),
            "libraries": sorted(libs), "build_s": round(build_s, 3),
            "nvcc_seconds": round(_build.build_seconds, 3),
            "spilling_kernels": {k: v for k, v in spills.items() if v}}
    emit(info)
    return info


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version on the same card tensors."""
    import torch
    from repro_torch.core.quantize import NVFP4
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.kernels import fp4_matmul as fm
    worst = {fm.FUSED_NAME: 0.0, fm.NAME: 0.0, fa.PACKED_NAME: 0.0,
             fa.DENSE_NAME: 0.0}
    failures = []

    def check(name, case, got, want):
        r = compare(got, want)
        worst[name] = max(worst[name], r["max_abs_err"])
        emit({"phase": "kernels", "kernel": name, "case": case, **r})
        if not r["ok"]:
            failures.append((name, case))

    for label, M, K, N, fmt, sr_a, sr_b, sc_a, sc_b in K1_CASES:
        a, b, spec_a, spec_b, ra, rb = k1_inputs(M, K, N, fmt, sr_a, sr_b,
                                                 sc_a, sc_b, dev)
        for out_dtype in (torch.float32, torch.bfloat16):
            got = fm.fused_quant_matmul(a, b, spec_a, spec_b, a_rbits=ra,
                                        b_rbits=rb, out_dtype=out_dtype)
            want = fm.fused_quant_matmul_plain(a, b, spec_a, spec_b,
                                               a_rbits=ra, b_rbits=rb,
                                               out_dtype=out_dtype)
            torch.cuda.synchronize(dev)
            check(fm.FUSED_NAME, f"{label} M={M} K={K} N={N} {fmt} "
                  f"sr={int(sr_a)}{int(sr_b)} {str(out_dtype)[6:]}",
                  got, want)
        del a, b, ra, rb, got, want

    for M, K, N in K4_SHAPES:
        a, w = k4_inputs(M, K, N, dev)
        for out_dtype in (torch.float32, torch.bfloat16):
            got = fm.packed_matmul(a, w, NVFP4, out_dtype=out_dtype)
            want = fm.packed_block_matmul_plain(
                a, w.packed, w.scales, w.tscale, NVFP4, block_b=w.block,
                out_dtype=out_dtype)
            torch.cuda.synchronize(dev)
            check(fm.NAME, f"M={M} K={K} N={N} {str(out_dtype)[6:]}",
                  got, want)
    for B, H, KVH, D, Sk, kv_len in K6_CASES:
        for fmt in ("nvfp4", "fp8"):
            for q_dtype in (torch.float32, torch.bfloat16):
                q, kc, ks, vc, vs, pos = k6_inputs(B, H, KVH, D, Sk, kv_len,
                                                   q_dtype, dev, fmt)
                got = fa.flash_attention_packed(q, kc, ks, vc, vs, pos,
                                                fmt=fmt)
                want = fa.flash_attention_packed_plain(q, kc, ks, vc, vs,
                                                       pos, fmt=fmt)
                torch.cuda.synchronize(dev)
                check(fa.PACKED_NAME,
                      f"B={B} H={H} KVH={KVH} D={D} Sk={Sk} kv_len={kv_len} "
                      f"{fmt} q {str(q_dtype)[6:]}", got, want)
    for B, S, H, KVH, D, dt in K7_CASES:
        q, k, v = k7_inputs(B, S, H, KVH, D, getattr(torch, dt), dev)
        got = fa.flash_attention(q, k, v, causal=True)
        want = fa.flash_attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize(dev)
        check(fa.DENSE_NAME, f"B={B} S={S} H={H} KVH={KVH} D={D} {dt}",
              got, want)
    if failures:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{failures}")
    return worst


def _first_divergence_ok(got, want, margins, tol=0.02):
    """Token streams agree, or first differ at a step whose reference greedy
    margin is below ``tol`` (a near-tie that summation order may flip)."""
    for t, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return bool(margins[t] < tol), t
    return len(got) == len(want), None


def phase_serve(dev, batch=4, prompt_len=64, max_new=32, max_len=256):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import counters
    from repro_torch.models import registry
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.serve.packing import weight_store_bytes

    # (a) the same Engine at smoke size: card (kernels) vs CPU (plain)
    small = get_config("llama2-7b").smoke()
    p_cpu = registry.init_params(small, seed=SEED, device="cpu")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, small.vocab_size, 16) for _ in range(batch)]
    scfg = ServeConfig(batch_size=batch, max_len=64, kv_cache_format="nvfp4")
    ref = Engine(small, p_cpu, scfg, device="cpu")
    out_ref = ref.generate(prompts, max_new=16)
    eng_s = Engine(small, p_cpu, scfg, device=dev)
    out_card = eng_s.generate(prompts, max_new=16)
    small_checks = [_first_divergence_ok(a.tolist(), b.tolist(), m)
                    for a, b, m in zip(out_card, out_ref, ref.margins)]
    agree = float(np.mean([np.mean(a == b) for a, b in
                           zip(out_card, out_ref)]))
    emit({"phase": "serve", "check": "smoke-size card vs CPU plain",
          "arch": small.name, "streams_ok": [c[0] for c in small_checks],
          "first_divergence": [c[1] for c in small_checks],
          "token_agreement": agree})
    if not all(c[0] for c in small_checks):
        raise AssertionError("card and CPU streams differ at a decisive step")

    # (b) llama2-7b at full width
    cfg = get_config("llama2-7b")
    t0 = time.perf_counter()
    params = registry.init_params(cfg, seed=SEED, device=dev)
    eng = Engine(cfg, params, ServeConfig(batch_size=batch, max_len=max_len,
                                          kv_cache_format="nvfp4"),
                 device=dev)
    del params
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, prompt_len)
               for _ in range(batch)]
    eng.generate(prompts, max_new=2)                 # warm-up, not counted
    torch.cuda.synchronize(dev)
    counters.reset()
    t0 = time.perf_counter()
    out = eng.generate(prompts, max_new=max_new)
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    launches = counters.snapshot()
    steps = eng.steps
    gemms = 7 * cfg.n_layers + 1          # q k v o gate up down, + lm_head
    want = {"fused_quant_matmul": 0,
            "packed_block_matmul": gemms * (1 + steps),
            "flash_attention": cfg.n_layers,
            "flash_attention_packed": cfg.n_layers * steps}
    ntok = sum(len(o) for o in out)
    margins = np.asarray(eng.margins)
    info = {"phase": "serve", "arch": cfg.name, "batch": batch,
            "prompt_len": prompt_len, "max_new": max_new,
            "kv_cache_format": "nvfp4", "decode_steps": steps,
            "tokens": ntok, "seconds": dt, "tokens_per_s": ntok / dt,
            "setup_s": setup_s,
            "weight_store_bytes": weight_store_bytes(eng.params),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
            "first_tokens": [o[:8].tolist() for o in out],
            "launches": launches, "expected_launches": want}
    emit(info)
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if len(out) != batch or any(len(o) != steps for o in out):
        raise AssertionError("wrong output shape")
    if any(((o < 0) | (o >= cfg.vocab_size)).any() for o in out):
        raise AssertionError("token id outside the vocabulary")
    if not np.isfinite(margins).all():
        raise AssertionError("non-finite logits")
    info["breakdown"] = serve_breakdown(eng, prompts, dev)
    return info


def serve_breakdown(eng, prompts, dev, steps=8) -> dict:
    """Prefill and decode-step times (CUDA events), and device time by
    kernel from torch.profiler over one short generate."""
    import numpy as np
    import torch
    from repro_torch.models import registry
    cfg, scfg = eng.cfg, eng.scfg
    toks = torch.from_numpy(np.stack(prompts)).to(dev)
    carry = registry.make_decode_state(cfg, scfg.batch_size, scfg.max_len,
                                       kv_cache_format=scfg.kv_cache_format,
                                       device=dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2 + steps)]
    with torch.no_grad():
        ev[0].record()
        logits, carry = registry.prefill(eng.params, cfg, eng.qcfg, toks,
                                         carry)
        ev[1].record()
        nxt = torch.argmax(logits, dim=-1)[:, None]
        for i in range(steps):
            logits, carry = registry.decode_step(eng.params, cfg, eng.qcfg,
                                                 nxt, carry)
            nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
            ev[2 + i].record()
    torch.cuda.synchronize(dev)
    decode_ms = [ev[1 + i].elapsed_time(ev[2 + i]) for i in range(steps)]
    out = {"prefill_ms": ev[0].elapsed_time(ev[1]),
           "decode_step_ms": statistics.median(decode_ms)}
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(prompts, max_new=steps)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    out.update({"profiled_generate_new_tokens": steps,
                "profiled_wall_ms": wall_ms,
                **device_time(prof, wall_ms, top=12)})
    emit({"phase": "serve", "breakdown": out})
    return out


def device_time(prof, wall_ms, top=15) -> dict:
    """Device busy time of a torch.profiler run: the union of the intervals
    of its device-side events (kernels, copies, sets; CUPTI's "Command
    Buffer Full" overhead marker is no device work), and the time by name.
    Host-side ranges (aten ops, autograd Functions) are left out: their
    "device time" repeats that of the kernels they launched."""
    from torch.autograd import DeviceType
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or \
                e.name.startswith("Command Buffer"):
            continue
        t0, t1 = e.time_range.start, e.time_range.end      # microseconds
        spans.append((t0, t1))
        by_name[e.name] = by_name.get(e.name, 0.0) + (t1 - t0) / 1e3
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    busy_ms = busy / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_busy_ms": busy_ms,
            "device_idle_share": (1 - busy_ms / wall_ms) if spans else None,
            "device_ms_by_kernel": {k: round(v, 4) for k, v in ranked}}


# ---- training -----------------------------------------------------------------------

# Card vs CPU tolerances of one smoke train step, as tests/test_torch_train.py
# holds the port to the JAX reference: the loss to rtol 1e-5; per-leaf grads
# and the parameter update (new - old) to a relative L2 error of 3e-2, since
# an f32 sum that rounds differently flips an FP4 code downstream now and
# then (the GEMM-weight grads themselves match where the inputs match).
TRAIN_LOSS_RTOL = 1e-5
TRAIN_REL_L2 = 3e-2


def rel_l2(got, want) -> float:
    import torch
    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    return float(torch.linalg.vector_norm(g - w)
                 / torch.clamp(torch.linalg.vector_norm(w), min=1e-30))


def k1_step_gemms(cfg, qcfg, tokens, remat=True) -> dict:
    """{(role, M, K, N, SR on A, SR on B): K1 launches} of one train step,
    from the FQT dispatch rules: for each weight GEMM (K, N) with M tokens
    the forward (again in the remat recompute of a layer), dX = g @ W^T and
    dW = x^T @ g each run K1 when fqt._use_k1 says so."""
    from repro_torch.core import fqt
    from repro_torch.core.fqt import _if_divisible as div
    from repro_torch.core.fqt import _use_k1

    def upd(spec):
        return None if spec is None or tokens % spec.block else spec

    def sr(*specs):
        return tuple(bool(sp.stochastic) for sp in specs)

    out = {}

    def add(key, n):
        out[key] = out.get(key, 0) + n

    def gemm(K, N, qc, times, fwd_times):
        a, w = div(qc.fwd_a, K), div(qc.fwd_w, K)
        if _use_k1(a, w, K):
            add(("fwd", tokens, K, N) + sr(a, w), fwd_times)
        g, wt = div(qc.bwd_g, N), div(qc.bwd_w, N)
        if _use_k1(g, wt, N):
            add(("dX", tokens, N, K) + sr(g, wt), times)
        ua, ug = upd(qc.upd_a), upd(qc.upd_g)
        if _use_k1(ua, ug, tokens):
            add(("dW", K, tokens, N) + sr(ua, ug), times)

    d, f = cfg.d_model, cfg.d_ff
    qd, kv = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    L = cfg.n_layers
    for K, N in ((d, qd), (d, kv), (d, kv), (qd, d), (d, f), (d, f), (f, d)):
        gemm(K, N, qcfg, L, L * (2 if remat else 1))
    head = qcfg if cfg.quantize_lm_head else fqt.QuantConfig()
    gemm(d, cfg.padded_vocab, head, 1, 1)
    return out


def phase_train(dev, batch=4, seq=1024, n_layers=4, steps=3) -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import fqt
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import counters
    from repro_torch.models import registry
    from repro_torch.optim import schedule
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.train import step as step_mod

    qcfg = fqt.nvfp4_paper_config()

    # (a) one smoke train step on the card against the same step on the CPU
    small = get_config("llama2-60m").smoke()
    tcfg_s = step_mod.TrainConfig(
        sched=schedule.ScheduleConfig(warmup_steps=0, total_steps=10))
    toks = SyntheticLM(DataConfig(small.vocab_size, 128, 4)).batch(0)
    results = {}
    p_cpu = registry.init_params(small, seed=SEED, device="cpu")
    for d in ("cpu", dev):
        params = tree_map(lambda t: t.to(d), p_cpu)
        state = step_mod.state_from_params(params, tcfg_s)
        b = {"tokens": torch.from_numpy(toks["tokens"]).to(d)}
        loss, _, grads = step_mod.loss_and_grads(
            params, small, qcfg, b, seed=step_mod.step_seed(0), remat=True)
        state, metrics = step_mod.make_train_step(small, qcfg, tcfg_s)(
            state, b)
        results[str(d)] = (loss, tree_leaves(grads),
                           tree_leaves(state.params), metrics)
    (l_c, g_c, p_c, _), (l_g, g_g, p_g, m_g) = results["cpu"], \
        results[str(dev)]
    old = tree_leaves(p_cpu)
    grad_err = max(rel_l2(a, b) for a, b in zip(g_g, g_c))
    upd_err = max(rel_l2(a.cpu().float() - o.float(), b.float() - o.float())
                  for a, b, o in zip(p_g, p_c, old))
    loss_err = abs(float(l_g) - float(l_c)) / abs(float(l_c))
    ok_a = (loss_err <= TRAIN_LOSS_RTOL and grad_err <= TRAIN_REL_L2
            and upd_err <= TRAIN_REL_L2)
    emit({"phase": "train", "check": "smoke step card vs CPU plain",
          "arch": small.name, "batch": 4, "seq": 128,
          "loss_cpu": float(l_c), "loss_card": float(l_g),
          "loss_rel_err": loss_err, "max_grad_rel_l2": grad_err,
          "max_update_rel_l2": upd_err, "grad_norm_card":
          float(m_g["grad_norm"]), "ok": ok_a})
    if not ok_a:
        raise AssertionError("card and CPU train steps disagree")
    del results, p_cpu
    from repro_torch.core.formats import counter_bits
    for seed, shape in ((0xFFFFFFFF, (4096, 4096)), (12345, (7, 13))):
        if not torch.equal(counter_bits(seed, shape, device=dev).cpu(),
                           counter_bits(seed, shape)):
            raise AssertionError(f"counter_bits{shape} differs on the card")

    # (b) llama2-7b at full width, depth cut to n_layers
    full = get_config("llama2-7b")
    cfg = dataclasses.replace(full, n_layers=n_layers)
    emit({"phase": "train", "arch": full.name, "cut": {
        "n_layers": [full.n_layers, n_layers]}, "batch": batch, "seq": seq,
        "tokens_per_step": batch * seq, "quant": "nvfp4_paper_config",
        "remat": True})
    tcfg = step_mod.TrainConfig(remat=True)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = step_mod.init_state(cfg, tcfg, seed=SEED, device=dev)
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    data = SyntheticLM(DataConfig(cfg.vocab_size, seq, batch))
    train_step = step_mod.make_train_step(cfg, qcfg, tcfg)
    per_step = sum(k1_step_gemms(cfg, qcfg, batch * seq).values())
    history = []
    counters.reset()
    for i in range(1 + steps):                      # 1 warm + timed steps
        b = {"tokens": torch.from_numpy(data.batch(i)["tokens"]).to(dev)}
        before = counters.snapshot()["fused_quant_matmul"]
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, metrics = train_step(state, b)
        host = {k: float(v) for k, v in metrics.items()}
        torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        host.update(step=i, ms=dt * 1e3, k1_launches=counters.snapshot()[
            "fused_quant_matmul"] - before)
        history.append(host)
        emit({"phase": "train", "step": host})
    launches = counters.snapshot()
    timed = [h["ms"] for h in history[1:]]
    step_ms = statistics.median(timed)
    info = {"phase": "train", "arch": full.name, "n_layers": n_layers,
            "step_ms_median": step_ms, "step_ms": timed,
            "tokens_per_s": batch * seq / (step_ms / 1e3),
            "setup_s": setup_s,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
            "k1_launches_per_step_expected": per_step,
            "launches": launches}
    emit(info)
    for h in history:
        if h["k1_launches"] != per_step:
            raise AssertionError(f"step {h['step']}: {h['k1_launches']} K1 "
                                 f"launches, expected {per_step}")
        if not all(math.isfinite(h[k]) for k in ("loss", "grad_norm", "gnr")):
            raise AssertionError(f"non-finite metrics at step {h['step']}")
    if launches["fused_quant_matmul"] != (1 + steps) * per_step or any(
            v for k, v in launches.items() if k != "fused_quant_matmul"):
        raise AssertionError(f"launch counts {launches}")
    info["breakdown"] = train_breakdown(train_step, state, data, 1 + steps,
                                        dev)
    return info


def train_breakdown(train_step, state, data, step, dev) -> dict:
    """Device time by kernel and the device idle share of one profiled
    train step (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    b = {"tokens": torch.from_numpy(data.batch(step)["tokens"]).to(dev)}
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = train_step(state, b)
        float(metrics["loss"])
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = {"profiled_step_wall_ms": wall_ms,
           **device_time(prof, wall_ms, top=20)}
    emit({"phase": "train", "breakdown": out})
    return out


def time_ms(fn, flush, reps=20, warm=3) -> float:
    """Median of per-launch CUDA-event times, L2 flushed before each."""
    import torch
    for _ in range(warm):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def bound_ms(nbytes, ops) -> tuple:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def phase_times(dev) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.core.quantize import NVFP4, kv_dequant
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.kernels import fp4_matmul as fm
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)  # 256 MB
    rows = {}

    def record(name, case, kernel, plain, library, nbytes, ops, reps=20,
               **extra):
        b, by = bound_ms(nbytes, ops)
        r = {"ms": time_ms(kernel, flush, reps),
             "plain_ms": time_ms(plain, flush, reps),
             "library_ms": time_ms(library, flush, reps) if library else None,
             "bound_ms": b, "bound_by": by, **extra}
        emit({"phase": "times", "kernel": name, "case": case, **r})
        rows[(name, case)] = r
        return r

    with torch.no_grad():
        for M, K, N in K4_SHAPES:
            a, w = k4_inputs(M, K, N, dev)
            wd = w.dequant()                        # bf16 (K, N), yardstick
            nbytes = M * K * 2 + K * N // 2 + K // 16 * N + 4 + M * N * 2
            record(fm.NAME, (M, K, N),
                   lambda: fm.packed_matmul(a, w, out_dtype=torch.bfloat16),
                   lambda: fm.packed_block_matmul_plain(
                       a, w.packed, w.scales, w.tscale, NVFP4,
                       out_dtype=torch.bfloat16),
                   lambda: torch.matmul(a, wd), nbytes, 2 * M * N * K)
            del a, w, wd
        for B, H, KVH, D, Sk, kv_len in K6_CASES:
            q, kc, ks, vc, vs, pos = k6_inputs(B, H, KVH, D, Sk, kv_len,
                                               torch.bfloat16, dev)
            kd = kv_dequant(kc[:, :kv_len], ks[:, :kv_len], "nvfp4")
            vd = kv_dequant(vc[:, :kv_len], vs[:, :kv_len], "nvfp4")
            G = H // KVH
            qt = q.transpose(1, 2)
            kt = kd.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
            vt = vd.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
            # rows up to kv_len are read: codes + scales, K and V
            nbytes = (2 * B * H * D * 2 + 8
                      + 2 * B * kv_len * KVH * (D // 2 + D // 16))
            record(fa.PACKED_NAME, (B, H, KVH, D, Sk, kv_len),
                   lambda: fa.flash_attention_packed(q, kc, ks, vc, vs, pos),
                   lambda: fa.flash_attention_packed_plain(q, kc, ks, vc, vs,
                                                           pos),
                   lambda: F.scaled_dot_product_attention(qt, kt, vt),
                   nbytes, 4 * B * H * kv_len * D)
        for B, S, H, KVH, D, dt in K7_CASES:
            q, k, v = k7_inputs(B, S, H, KVH, D, getattr(torch, dt), dev)
            G = H // KVH
            qt = q.transpose(1, 2)
            kt = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
            vt = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
            nbytes = B * S * (2 * H + 2 * KVH) * D * q.element_size()
            record(fa.DENSE_NAME, (B, S, H, KVH, D, dt),
                   lambda: fa.flash_attention(q, k, v, causal=True),
                   lambda: fa.flash_attention_plain(q, k, v, causal=True),
                   lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                          is_causal=True),
                   nbytes, 4 * B * H * D * S * (S + 1) // 2)
        # K1 at every GEMM of the llama2-7b train step (M = 4096 tokens)
        from repro_torch.configs import get_config
        from repro_torch.core import fqt
        cfg = dataclasses.replace(get_config("llama2-7b"), n_layers=4)
        gemms = k1_step_gemms(cfg, fqt.nvfp4_paper_config(), 4 * 1024)
        scales = {"fwd": (1.0, 0.02), "dX": (1e-4, 0.02), "dW": (1.0, 1e-4)}
        step_ms = 0.0
        for (role, M, K, N, sr_a, sr_b), n in gemms.items():
            a, b, spec_a, spec_b, ra, rb = k1_inputs(
                M, K, N, "nvfp4", sr_a, sr_b, *scales[role], dev)
            nbytes = (2 * (M * K + K * N + M * N) + 4 * M * K * sr_a
                      + 4 * K * N * sr_b)
            r = record(fm.FUSED_NAME, (role, M, K, N),
                       lambda: fm.fused_quant_matmul(
                           a, b, spec_a, spec_b, a_rbits=ra, b_rbits=rb,
                           out_dtype=torch.bfloat16),
                       lambda: fm.fused_quant_matmul_plain(
                           a, b, spec_a, spec_b, a_rbits=ra, b_rbits=rb,
                           out_dtype=torch.bfloat16),
                       lambda: torch.matmul(a, b), nbytes, 2 * M * N * K,
                       reps=5, launches_per_step=n)
            step_ms += n * r["ms"]
            del a, b, ra, rb
        emit({"phase": "times", "kernel": fm.FUSED_NAME,
              "train_step_k1_ms": step_ms})
    return rows


# the representative case of each kernel in the summary line: the launch the
# main path makes most often (K4: decode, wq/wk/wv/wo; K6: decode at the
# middle of the run; K7: prefill, f32 operands as attention_core passes them)
SUMMARY = {
    "fused_quant_matmul": (("fwd", 4096, 4096, 4096), "cuda",
                           "src/repro_torch/kernels/csrc/fused_quant_matmul.cu",
                           "src/repro/kernels/fp4_matmul.py:208"),
    "packed_block_matmul": ((4, 4096, 4096), "cuda",
                            "src/repro_torch/kernels/csrc/fp4_matmul.cu",
                            "src/repro/kernels/fp4_matmul.py:309"),
    "flash_attention_packed": ((4, 32, 32, 128, 256, 80), "cuda",
                               "src/repro_torch/kernels/csrc/flash_attn.cu",
                               "src/repro/kernels/flash_attn.py:255"),
    "flash_attention": ((4, 64, 32, 32, 128, "float32"), "cuda",
                        "src/repro_torch/kernels/csrc/flash_attn.cu",
                        "src/repro/kernels/flash_attn.py:454"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES}")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    for p in phases:
        t0 = time.perf_counter()
        results[p] = {"env": phase_env, "kernels": phase_kernels,
                      "serve": phase_serve, "train": phase_train,
                      "times": phase_times}[p](dev)
        emit({"phase": p, "done": True,
              "seconds": round(time.perf_counter() - t0, 3)})
    print(card_line(), flush=True)
    if {"kernels", "serve", "train", "times"} <= set(phases):
        # each kernel's launches on the main path that runs it
        launches = dict(results["serve"]["launches"])
        launches["fused_quant_matmul"] = \
            results["train"]["launches"]["fused_quant_matmul"]
        line = []
        for name, (case, route, src, replaces) in SUMMARY.items():
            row = results["times"][(name, case)]
            line.append({"name": name, "route": route, "source": src,
                         "replaces": replaces, "launches": launches[name],
                         "max_abs_err": results["kernels"][name],
                         "ms": row["ms"], "plain_ms": row["plain_ms"],
                         "bound_ms": row["bound_ms"],
                         "bound_by": row["bound_by"],
                         "library_ms": row["library_ms"],
                         "case": list(case)})
        emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
