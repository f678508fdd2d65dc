#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

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
  times    median CUDA-event time of each kernel at the phase-2 shapes (L2
           flushed before every launch, as a decode step finds its weights
           cold), beside its bound, its plain version and one PyTorch call
           computing the same function (a yardstick the port never calls).

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
repository beside it, the script fails before printing either.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PHASES = ("env", "kernels", "serve", "times")
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
    worst = {fm.NAME: 0.0, fa.PACKED_NAME: 0.0, fa.DENSE_NAME: 0.0}
    failures = []

    def check(name, case, got, want):
        r = compare(got, want)
        worst[name] = max(worst[name], r["max_abs_err"])
        emit({"phase": "kernels", "kernel": name, "case": case, **r})
        if not r["ok"]:
            failures.append((name, case))

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
    want = {"packed_block_matmul": gemms * (1 + steps),
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
    by_name = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0)) or 0
        if t > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + t / 1e3
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    out.update({"profiled_generate_new_tokens": steps,
                "profiled_wall_ms": wall_ms, "device_busy_ms": busy,
                "device_idle_share": (1 - busy / wall_ms) if busy else None,
                "device_ms_by_kernel": {k: round(v, 4) for k, v in top}})
    emit({"phase": "serve", "breakdown": out})
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

    def record(name, case, kernel, plain, library, nbytes, ops):
        b, by = bound_ms(nbytes, ops)
        r = {"ms": time_ms(kernel, flush), "plain_ms": time_ms(plain, flush),
             "library_ms": time_ms(library, flush) if library else None,
             "bound_ms": b, "bound_by": by}
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
    return rows


# the representative case of each kernel in the summary line: the launch the
# main path makes most often (K4: decode, wq/wk/wv/wo; K6: decode at the
# middle of the run; K7: prefill, f32 operands as attention_core passes them)
SUMMARY = {
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
                      "serve": phase_serve, "times": phase_times}[p](dev)
        emit({"phase": p, "done": True,
              "seconds": round(time.perf_counter() - t0, 3)})
    print(card_line(), flush=True)
    if {"kernels", "serve", "times"} <= set(phases):
        launches = results["serve"]["launches"]
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
