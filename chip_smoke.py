#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU: serve
(lockstep and continuous batching), train, and the pipeline from training
through checkpoint/restart and the packed export to serving.

    python3 chip_smoke.py                    # every phase, one CUDA card
    python3 chip_smoke.py --phases env,kernels

Phases, each printing JSON lines; any failure exits non-zero:

  env      torch/CUDA versions, the card's name and power limit, the
           build of every ``csrc/*.cu`` kernel from the checkout (nvcc), and
           the count of HGMMA (wgmma) instructions in the SASS of K1's, K3's
           and K4's libraries and of HMMA (mma.sync) in K7's (cuobjdump),
           none of which may be 0.
  kernels  each hand-written kernel against its plain PyTorch version on the
           same card tensors, at the main path's shapes: f32 outputs at
           rtol = atol = 1e-5, bf16 outputs to one bf16 ulp (+ 1e-5), the
           K2 quantizer's codes and scales bit for bit.  K1, K3 and K4 sum
           their exact products in another order than the plain version's
           f32 matmul (K1, K3 and K4's "core" route on the tensor-core core,
           csrc/fp4_gemm.cuh; K4's "gemv" route split over K; K4's "f32"
           route in f32 tiles), so they are held to the forward-error bound
           of f32 summation of exact products in any order, truncation
           allowed:
               |out - plain| <= (K/16 + 16) * 2^-23 * (|A'| @ |B'|)
                                * tsA * tsB + 1e-5
           elementwise, A' and B' the dequantized operands (code x block
           scale), plus one bf16 ulp for bf16 outputs.  K1 in counter mode
           (SR bits hashed in the kernel) must equal K1 given the same bits
           as tensors bit for bit, and a spec pair that is not bf16-exact
           (E3M4 data) takes K1's f32 route and the f32 rule above.  K4 runs
           every main-path shape through the route ``k4_route`` picks, plus
           4096^2 at M = K4_GEMV_MAX_M and one row more (each route meets
           the crossover), and E3M4 data above it (the "f32" route).  K6 runs
           K6_CASES and K6_EDGE (kv_len 1, one full 128-key tile, a window,
           a long cache of 16 tiles in one split); K7 runs K7_CASES and K7_EDGE
           (window, non-causal, ragged Sq != Sk, head dims 32 and 96); K5
           its 30 cases.  K2 runs on the route ``k2_route`` picks ("vec":
           16-byte lanes; "scalar": one thread a block), bit for bit:
           K2_SPECS x K2_SHAPES x f32/bf16 x a given or computed tensor
           scale, SR bits as a tensor; counter mode (bits hashed in the
           kernel) for both SR specs at strides (K, 1) and (1, M); and
           K2_EDGE (one row, ragged rows, K = 4112, views off 16-byte
           alignment, which take "scalar"), SR in counter mode and as bits.
  serve    the lockstep Engine serving llama2-7b at full width from packed
           NVFP4 weights (random, seeded) with an nvfp4 KV cache: batch 4,
           prompt 64, 32 new tokens, greedy.  The main path replays its two
           programs as CUDA graphs (serve/graphs.py; two warm-up generates
           capture them); the same prompts then run through an eager
           engine (``cuda_graphs=False``), and both streams must be equal
           token for token.  The launch counts are zeroed just before and
           read just after each side's run (a replay counts the launches
           its capture recorded); every kernel of the path must have run
           the expected number of times on both sides.  Outputs are checked
           for range and finiteness, and the same graphed Engine at smoke
           size on the card, over two generates, is held to the plain
           versions on the CPU.  The breakdowns report the replayed
           prefill and decode-step ms (CUDA events), the idle share of a
           profiled graphed generate, and, on the eager side, device ms by
           kernel group (K4-K7) per decode step and for one prefill
           (profiler); captures and their seconds and peak memory
           (allocated and reserved) on both sides.
  serve_continuous
           the ContinuousEngine: (a) at smoke size on the card held to the
           same engine on the CPU's plain versions (prefix cache + chunked
           prefill, and speculative verify-k); (b) llama2-7b at full width
           and depth from random packed NVFP4 weights over a paged nvfp4
           KV pool, as two runs of 16 requests (2 arriving per tick, 32
           new tokens each, greedy, no EOS): run A with the shared-prefix
           cache and 64-token chunked prefill, run B with cold prefills
           (K7) and speculative verify-k (k = 4, 16-layer draft).  Each run
           goes through an engine whose five programs replay as CUDA graphs
           (the main path) and through an eager one; the streams must be
           equal token for token.  On both sides the launch counts are
           zeroed just before the run and must equal the counts derived
           from the engine's program calls, which in turn must agree with
           the scheduler's own records, and the five ``*_compiles`` must
           equal those of the CPU engine (smoke size) on the same trace.
           The smoke-size check runs each engine twice (the second run on
           the carry reset in place, or on its warm prefix cache) and
           holds the compile counts too.
  train    one llama2-60m smoke train step (nvfp4_paper_config) on the
           card held to the same step on the CPU's plain versions (loss,
           per-leaf grads, parameter updates), the SR streams held bit for
           bit; then llama2-7b at full width, depth cut to 4 layers, batch
           4 x seq 1024, remat, AdamW: 1 warm + 3 timed steps with finite
           metrics, K1's launches per step as the FQT dispatch rules
           derive them and K2's as one per sigma_q probe leaf (the probe's
           quantizer runs K2 in counter mode), no other kernel, peak
           memory and one profiled step's idle share and device ms of K1
           and of K2; then, on one more step's gradients, every probe leaf
           through K2 held to K2's plain version bit for bit, and sigma_q
           from both equal.
  pipeline the paper's train -> restart -> export -> serve pipeline through
           ``train.Trainer`` at llama2-7b's full width, depth cut to 2
           layers (a checkpoint of the state is ~9.3 GB), batch 4 x seq
           1024, nvfp4_paper_config, remat, sigma_q probe: 6 uninterrupted
           steps; then 3 steps checkpointed (``checkpoint/ckpt.py``, the
           reference's format, in a temporary directory under build/) and a
           fresh Trainer with a step-clock tracer resuming from it to step
           6.  The two final states must be equal bit for bit (params,
           master, m, v), and so must loss and grad norm of the resumed
           steps; every step launches K1 as k1_step_gemms derives and K2
           once per probe leaf; the trace has one gnr gauge and one ratio
           gauge per reference leaf per logged step and validates.  The
           exported packed artifact (``serve_packed``) must equal the
           packing of the final parameters bit for bit; served through a
           graphed ``Engine(pack_weights=False)`` (batch 4, prompt 64, 16
           new tokens, greedy, nvfp4 KV cache) it must give the stream and
           greedy margins, bit for bit, of an Engine built from the final
           parameters, with K4, K6 and K7 launched as expected on both.
           Reports free disk, seconds and bytes of every save, restore and
           export, the artifact's bytes per GEMM parameter, the
           telemetry's host ms per logged step and peak memory.
  ops      the kernel-level public API (``kernels/ops.py``) as a user calls
           it: the unfused FQT GEMM at each forward GEMM shape of the
           train phase's llama2-7b (M = 4096 tokens; (K, N) = (4096, 4096),
           (4096, 11008), (11008, 4096), lm_head (4096, 32000)) under
           nvfp4_paper_config's RtN forward specs, and once with SR on both
           operands: K2 block_quantize(A) and block_quantize(B^T), K3
           block_matmul, and K1 fused_quant_matmul on the same raw
           operands.  The launch counts (zeroed just before) must be 2 K2
           + 1 K3 + 1 K1 per GEMM; K2 must equal its plain version bit for
           bit, K3 its plain version under the tensor-core rule of phase
           kernels, and the chain K2 -> K2 -> K3 must equal K1 within 1e-5
           of max |out|.
  times    median CUDA-event time of each kernel at the main paths' shapes
           (L2 flushed before every launch, as a step finds its operands
           cold), beside its bound, its plain version and one PyTorch call
           computing the same function (a yardstick the port never calls);
           K1 at every train GEMM with its SR operands in counter mode, as
           the train step runs it; K4 at every main-path shape with its
           route, and both routes at M 1-64 (the crossover); K5 at run A's
           decode, the verify and the chunk shapes; K6 at every K6_CASES row
           with the split plan it takes; K7 at every K7_CASES and K7_MAIN
           row; K2 at 4096^2 f32 (computed and given tensor scale), bf16,
           and at the sigma_q probe's largest leaf in counter mode; and the
           device time of each launch inside one call of K1, K2 (its absmax
           pre-pass and quantizer), K3, K4 (each route), K5, K6 and K7, each
           taken in a fresh child process (a profiler late in a long
           process drops device events).

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

PHASES = ("env", "kernels", "serve", "serve_continuous", "train",
          "pipeline", "ops", "times")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
BF16_OPS_PER_S = 989e12            # H100 SXM dense bf16 tensor-core peak
SEED = 0

# (M, K, N) of K4 on the main path: M = 4 decode rows, M = 256 prefill rows
# (batch 4 x prompt 64); llama2-7b's wq/wk/wv/wo, w_gate/w_up, w_down and
# lm_head, with their launches per forward pass.
K4_WEIGHTS = ((4096, 4096, 4 * 32), (4096, 11008, 2 * 32), (11008, 4096, 32),
              (4096, 32000, 1))
K4_SHAPES = tuple((m, k, n) for m in (4, 256) for k, n, _ in K4_WEIGHTS)
# K4 on the continuous path: M = 1 (lm_head of a prefill program's last
# prompt token), M = 8 (8-slot decode and the draft's steps), M = 32 (verify,
# 8 slots x k = 4), M = 64 (suffix and chunk prefill, prefill_chunk 64) and
# M = 192 (run B's cold-prefill pad); prefills apply no lm_head to the pad.
K4_CONT_SHAPES = ((1, 4096, 32000),) + tuple(
    (m, k, n) for m in (8, 32) for k, n, _ in K4_WEIGHTS) + tuple(
    (m, k, n) for m in (64, 192) for k, n, _ in K4_WEIGHTS[:3])
K6_CASES = (  # (B, H, KVH, D, Sk, kv_len): llama2-7b, then tinyllama (G = 8)
    (4, 32, 32, 128, 256, 65), (4, 32, 32, 128, 256, 80),
    (4, 32, 32, 128, 256, 96), (4, 32, 4, 64, 256, 96))
# K6 at its edges, decode rows (q_offset = kv_len - 1): (B, H, KVH, D, Sk,
# kv_len, window) -- one cached token, exactly one 128-key tile, a window,
# and a 2048-token cache (16 tiles in k6_plan's one split; with a window
# that starts inside the fifth tile)
K6_EDGE = (
    (4, 32, 32, 128, 256, 1, None), (4, 32, 32, 128, 256, 128, None),
    (4, 32, 32, 128, 256, 80, 24), (4, 32, 32, 128, 2048, 1500, None),
    (4, 32, 32, 128, 2048, 1500, 600))
# K5 at the continuous path's shapes: (label, B, Sq, H, KVH, D, page, pages,
# per-slot lengths, q_offsets ("last": length - Sq), window).  The decode,
# verify and window cases give one slot length 0 (an empty slot); the page
# tables are shuffled and point every page past a slot's length at the trash
# page, as the engine's do.
K5_LENS = (0, 1, 17, 100, 256, 333, 497, 512)
K5_CASES = (
    ("decode", 8, 1, 32, 32, 128, 16, 32, K5_LENS, "last", None),
    ("verify", 8, 4, 32, 32, 128, 16, 32, (0, 4, 20, 100, 256, 333, 497,
                                           512), "last", None),
    ("suffix", 1, 64, 32, 32, 128, 16, 32, (150,), (128,), None),
    ("decode GQA", 8, 1, 32, 4, 64, 16, 32, K5_LENS, "last", None),
    ("window", 8, 1, 32, 32, 128, 16, 8, (0, 5, 100, 128, 129, 200, 255,
                                          300), "last", 100),
)
K7_CASES = (  # (B, S, H, KVH, D, dtype name)
    (4, 64, 32, 32, 128, "float32"), (4, 64, 32, 32, 128, "bfloat16"),
    (4, 64, 32, 4, 64, "bfloat16"),
    (1, 192, 32, 32, 128, "float32"))      # run B's cold prefill-into-slot
# K7 on the main path's operands: f32 tensors holding bf16 values, as
# layers._attn_prefill passes them (K7's TF32-exact route): the lockstep
# prefill and run B's cold prefill-into-slot
BF16_VALUED = "float32 bf16-valued"
K7_MAIN = ((4, 64, 32, 32, 128, BF16_VALUED), (1, 192, 32, 32, 128,
                                               BF16_VALUED))
# K7 at its edges: (B, Sq, Sk, H, KVH, D, dtype name, causal, window)
K7_EDGE = tuple(
    (4, 64, 64, 32, 32, 128, dt, causal, window) for dt in ("float32",
                                                             "bfloat16")
    for causal, window in ((True, 40), (False, None))) + (
    (2, 50, 77, 8, 2, 32, "float32", True, None),
    (2, 77, 50, 8, 2, 96, "bfloat16", True, 30),   # every row sees a key
    (1, 100, 100, 4, 4, 96, "float32", False, 30))
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
# The unfused GEMM of phase ops at llama2-7b's forward GEMMs, M = 4096
# tokens: (K, N) of wq/wk/wv/wo, w_gate/w_up, w_down and the lm_head.
OPS_M = 4096
OPS_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000))
# K2's specs in phase kernels (tests/test_kernels.py:27-33): (name,
# BlockQuantSpec fields)
K2_SPECS = (
    ("nvfp4", dict(scale_fmt="e4m3", block=16, two_level=True)),
    ("mxfp4", dict(scale_fmt="e8m0", block=32, two_level=False)),
    ("nvfp4 sr", dict(scale_fmt="e4m3", block=16, two_level=True,
                      stochastic=True)),
    ("mxfp4 sr", dict(scale_fmt="e8m0", block=32, two_level=False,
                      stochastic=True)),
    ("e3m4 b8", dict(scale_fmt="e3m4", block=8, two_level=False)))
K2_SHAPES = ((4096, 4096), (4095, 4096))
# K2 at its edges, each under every K2_SPECS spec whose block divides K, in
# f32 and bf16: (label, M, K, storage offset in elements).  One row of one
# block; a ragged 3 x 48; 7 x 96 (MXFP4's 32-value blocks: 8 f32 lanes);
# K = 4112 (257 blocks of 16); views 1 and 3 elements into their storage,
# not 16-byte aligned, so k2_route sends them to the "scalar" kernel.
# "e3m4 b8" in bf16 is one 16-byte lane a block.
K2_EDGE = (("one row", 1, 16, 0), ("3 rows", 3, 48, 0), ("7 rows", 7, 96, 0),
           ("K 4112", 33, 4112, 0), ("offset 1", 64, 256, 1),
           ("offset 3", 64, 256, 3))


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


def compare_bits(got, want) -> dict:
    """Quantizer outputs: the same bit patterns (so -0.0 and 0.0 differ)."""
    import torch
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    ok = torch.equal(got.view(ints[got.dtype]), want.view(ints[want.dtype]))
    return {"ok": ok,
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "rule": "bit for bit"}


def compare_tc(got, want, ad, bd, ts) -> dict:
    """K1, K3 and K4 against their plain versions, which sum the same exact
    products in another order: the forward-error bound of f32 summation of exact products in any order,
    truncation allowed, |got - want| <= (K/16 + 16) * 2^-23 * (|A'| @ |B'|)
    * ts + 1e-5 elementwise (A' (M, K), B' (K, N) the dequantized operands,
    ts = tsA * tsB), plus one bf16 ulp for bf16 outputs."""
    import torch
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError("kernel output is not finite")
    K = ad.shape[1]
    tol = ((K / 16 + 16) * 2.0 ** -23
           * torch.matmul(ad.abs(), bd.abs()) * ts + 1e-5)
    rule = "(K/16+16) 2^-23 |A'|@|B'| ts + 1e-5"
    if got.dtype == torch.bfloat16:
        tol = tol + bf16_ulp(torch.maximum(g.abs(), w.abs()))
        rule += " + 1 bf16 ulp"
    err = (g - w).abs()
    return {"ok": bool((err <= tol).all()), "max_abs_err": float(err.max()),
            "max_err_over_tol": float((err / tol).max()), "rule": rule}


def k1_operands(a, b, spec_a, spec_b, ra, rb):
    """K1's dequantized operands A' (M, K) and B' (K, N) in f32 and tsA *
    tsB, as its plain version computes them."""
    from repro_torch.kernels import fp4_matmul as fm
    ad, tsa = fm._quantized_operand(a, spec_a, ra, along_rows=False)
    bd, tsb = fm._quantized_operand(b, spec_b, rb, along_rows=True)
    return ad, bd, tsa * tsb


def k3_operands(ac, asc, bc, bsc, ts, block=16):
    """K3's dequantized operands A' (M, K) and B' (K, N) in f32, and ts."""
    ad = ac.float() * asc.repeat_interleave(block, dim=1)
    bd = bc.float() * bsc.repeat_interleave(block, dim=0)
    return ad, bd, ts


def k4_operands(a, w, spec_a):
    """K4's dequantized operands Q(A) (M, K) and B' (K, N) in f32, and tsA *
    tsB, as its plain version computes them."""
    import torch
    from repro_torch.kernels import common as kc
    from repro_torch.kernels import fp4_matmul as fm
    ad, tsa = fm._quantized_operand(a, spec_a, None, along_rows=False)
    K, N = a.shape[1], 2 * w.packed.shape[1]
    bsc = kc.decode_e4m3_byte_k(w.scales.view(torch.uint8))
    bd = (kc.unpack_e2m1_k(w.packed).reshape(K // w.block, w.block, N)
          * bsc.unsqueeze(1)).reshape(K, N)
    return ad, bd, tsa * w.tscale.float().reshape(())


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
    """A decode row (q_offset = kv_len - 1) over a random cache."""
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


def k5_inputs(B, Sq, H, KVH, D, psz, n_pages, lengths, q_offsets, window,
              fmt, q_dtype, dev, seed=SEED):
    """q, the K/V page pools, a shuffled page table (pages past a linear
    slot's length -> the trash page), kv_len (clamped to the slot buffer)
    and q_offsets, all on ``dev``."""
    import torch
    from repro_torch.core.quantize import kv_quant_rows
    from repro_torch.models.layers import TRASH_PAGE
    g = gen(dev, seed)
    P = 1 + B * n_pages
    q = torch.randn((B, Sq, H, D), generator=g, device=dev).to(q_dtype)
    kv = torch.randn((2, P, psz, KVH, D), generator=g, device=dev
                     ).to(torch.bfloat16)
    if fmt == "bf16":
        ones = torch.ones((P, psz, KVH, 1), dtype=torch.bfloat16, device=dev)
        pools = (kv[0].contiguous(), ones, kv[1].contiguous(), ones.clone())
    else:
        pools = kv_quant_rows(kv[0], fmt) + kv_quant_rows(kv[1], fmt)
    perm = torch.randperm(P - 1, generator=gen("cpu", seed)) + 1
    table = perm.reshape(B, n_pages).to(torch.int32)
    buf = psz * n_pages
    for b, n in enumerate(lengths):
        if window is None:
            table[b, -(-min(n, buf) // psz):] = TRASH_PAGE
    kv_len = torch.tensor([min(n, buf) for n in lengths], dtype=torch.int32)
    if q_offsets == "last":
        q_offsets = [max(n - Sq, 0) for n in lengths]
    q_off = torch.tensor(q_offsets, dtype=torch.int32)
    return (q,) + tuple(pools) + (table.to(dev), kv_len.to(dev),
                                  q_off.to(dev))


def k7_inputs(B, S, H, KVH, D, dt, dev, seed=SEED, Sk=None):
    """q, k, v of dtype name ``dt``: "float32", "bfloat16" or BF16_VALUED
    (f32 tensors holding bf16 values)."""
    import torch
    g = gen(dev, seed)
    Sk = S if Sk is None else Sk
    cast = ((lambda x: x.to(torch.bfloat16).float()) if dt == BF16_VALUED
            else (lambda x: x.to(getattr(torch, dt))))
    return tuple(cast(torch.randn(s, generator=g, device=dev)) for s in
                 ((B, S, H, D), (B, Sk, KVH, D), (B, Sk, KVH, D)))


def k3_inputs(M, K, N, dtype, dev, seed=SEED):
    """Pre-quantized operands of K3 (codes in ``dtype``, from K2's plain
    version) and tsA * tsB, all on ``dev``."""
    import torch
    from repro_torch.core.quantize import NVFP4
    from repro_torch.kernels.nvfp4_quant import block_quantize_plain
    from repro_torch.kernels.ref import tensor_scale_ref
    g = gen(dev, seed)
    a = torch.randn((M, K), generator=g, device=dev).to(dtype)
    bt = (torch.randn((N, K), generator=g, device=dev) * 0.02).to(dtype)
    ac, asc = block_quantize_plain(a, NVFP4)
    bct, bsct = block_quantize_plain(bt, NVFP4)
    ts = tensor_scale_ref(a, NVFP4) * tensor_scale_ref(bt, NVFP4)
    return ac, asc, bct.T.contiguous(), bsct.T.contiguous(), ts


def k1_inputs(M, K, N, fmt, sr_a, sr_b, scale_a, scale_b, dev, seed=SEED,
              a_transposed=False):
    """bf16 operands and, for SR operands, counter bits of their shapes as
    tensors and as K1's counters (seed, row_stride, col_stride).  With
    a_transposed, A's bits are those of its (K, M) transpose, as the update
    GEMM's x^T takes them."""
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
    ra = rb = ca = cb = None
    if sr_a and a_transposed:
        ra = counter_bits(seed + 1, (K, M), device=dev).T.contiguous()
        ca = (seed + 1, 1, M)
    elif sr_a:
        ra, ca = counter_bits(seed + 1, (M, K), device=dev), (seed + 1, K, 1)
    if sr_b:
        rb, cb = counter_bits(seed + 2, (K, N), device=dev), (seed + 2, N, 1)
    return a, b, spec_a, spec_b, ra, rb, ca, cb


# ---- phases ------------------------------------------------------------------------


def cuobjdump() -> str:
    """The toolkit's cuobjdump, or the copy Triton's package carries."""
    import importlib.util
    import shutil
    found = shutil.which("cuobjdump")
    if found:
        return found
    cands = [Path("/usr/local/cuda/bin/cuobjdump")]
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.submodule_search_locations:
        cands += [Path(p) / "backends" / "nvidia" / "bin" / "cuobjdump"
                  for p in spec.submodule_search_locations]
    for c in cands:
        if c.exists():
            return str(c)
    raise RuntimeError("cuobjdump not found")


def sass_count(lib: Path, op="HGMMA") -> int:
    """``op`` instructions (HGMMA: wgmma; HMMA: mma.sync) in the SASS of a
    built library."""
    r = subprocess.run([cuobjdump(), "-sass", str(lib)], capture_output=True,
                       text=True, timeout=300, check=True)
    return sum(f"{op}." in ln for ln in r.stdout.splitlines())


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
    hgmma = {stem: sass_count(_build.library_path(stem))
             for stem in ("fused_quant_matmul", "block_matmul", "fp4_matmul")}
    hmma = {"flash_attn": sass_count(_build.library_path("flash_attn"),
                                     "HMMA")}
    info = {"phase": "env", "python": sys.version.split()[0],
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "card": card_line(), "kind": torch.cuda.get_device_name(dev),
            "count": torch.cuda.device_count(),
            "libraries": sorted(libs), "build_s": round(build_s, 3),
            "nvcc_seconds": round(_build.build_seconds, 3),
            "spilling_kernels": {k: v for k, v in spills.items() if v},
            "hgmma_instructions": hgmma, "hmma_instructions": hmma}
    emit(info)
    if not all(hgmma.values()):
        raise AssertionError(f"no HGMMA in the SASS of {hgmma}")
    if not all(hmma.values()):
        raise AssertionError(f"no HMMA in the SASS of {hmma}")
    return info


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version on the same card tensors."""
    import torch
    from repro_torch.core.formats import counter_bits
    from repro_torch.core.quantize import NVFP4, BlockQuantSpec
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.kernels import fp4_matmul as fm
    from repro_torch.kernels import nvfp4_quant as nq
    worst = {fm.FUSED_NAME: 0.0, nq.NAME: 0.0, fm.BLOCK_NAME: 0.0,
             fm.NAME: 0.0, fa.PAGED_NAME: 0.0, fa.PACKED_NAME: 0.0,
             fa.DENSE_NAME: 0.0}
    failures = []

    def check(name, case, got, want, rule=compare):
        r = rule(got, want)
        worst[name] = max(worst[name], r["max_abs_err"])
        emit({"phase": "kernels", "kernel": name, "case": case, **r})
        if not r["ok"]:
            failures.append((name, case))

    for label, M, K, N, fmt, sr_a, sr_b, sc_a, sc_b in K1_CASES:
        a, b, spec_a, spec_b, ra, rb, ca, cb = k1_inputs(
            M, K, N, fmt, sr_a, sr_b, sc_a, sc_b, dev,
            a_transposed=label.startswith("dW"))
        route = fm.k1_route(spec_a, spec_b)
        if route != "core":
            failures.append((fm.FUSED_NAME, f"{label}: route {route}"))
        operands = k1_operands(a, b, spec_a, spec_b, ra, rb)
        for out_dtype in (torch.float32, torch.bfloat16):
            got = fm.fused_quant_matmul(a, b, spec_a, spec_b, a_rbits=ra,
                                        b_rbits=rb, out_dtype=out_dtype)
            want = fm.fused_quant_matmul_plain(a, b, spec_a, spec_b,
                                               a_rbits=ra, b_rbits=rb,
                                               out_dtype=out_dtype)
            torch.cuda.synchronize(dev)
            case = (f"{label} M={M} K={K} N={N} {fmt} sr={int(sr_a)}"
                    f"{int(sr_b)} {str(out_dtype)[6:]} route {route}")
            check(fm.FUSED_NAME, case,
                  got, want, lambda g, w: compare_tc(g, w, *operands))
            if sr_a or sr_b:
                # the same bits hashed in the kernel (counter mode)
                hashed = fm.fused_quant_matmul(
                    a, b, spec_a, spec_b, out_dtype=out_dtype, a_counter=ca,
                    b_counter=cb)
                torch.cuda.synchronize(dev)
                check(fm.FUSED_NAME, case + " counter mode vs bits", hashed,
                      got, compare_bits)
        del a, b, ra, rb, got, want, operands
    # K1's f32 route: E3M4 data under E4M3 scales is not bf16-exact (4 + 3
    # mantissa bits); SR on both operands in counter mode
    e3m4 = BlockQuantSpec(data_fmt="e3m4", scale_fmt="e4m3", block=16,
                          two_level=True, stochastic=True)
    M, K, N = 512, 256, 384
    g = gen(dev, SEED)
    a, b = (torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
            for s in ((M, K), (K, N)))
    route = fm.k1_route(e3m4, e3m4)
    if route != "f32":
        failures.append((fm.FUSED_NAME, f"e3m4: route {route}"))
    for out_dtype in (torch.float32, torch.bfloat16):
        kw = dict(out_dtype=out_dtype, a_counter=(SEED + 5, K, 1),
                  b_counter=(SEED + 6, N, 1))
        got = fm.fused_quant_matmul(a, b, e3m4, e3m4, **kw)
        want = fm.fused_quant_matmul_plain(a, b, e3m4, e3m4, **kw)
        torch.cuda.synchronize(dev)
        check(fm.FUSED_NAME, f"e3m4/e4m3 M={M} K={K} N={N} sr=11 counter "
              f"{str(out_dtype)[6:]} route {route}", got, want)

    # K2, bit for bit, on the route k2_route picks
    k2_routes = set()

    def k2_check(case, x, spec, rbits=None, tscale=None, counter=None):
        aligned = all(t is None or t.data_ptr() % nq.LANE_BYTES == 0
                      for t in (x, rbits))
        route = nq.k2_route(spec.block, x.dtype, aligned)
        k2_routes.add(route)
        kw = dict(rbits=rbits, tscale=tscale, counter=counter)
        got = nq.block_quantize(x, spec, **kw)
        want = nq.block_quantize_plain(x, spec, **kw)
        torch.cuda.synchronize(dev)
        case = (f"{case} {str(x.dtype)[6:]} tscale="
                f"{'given' if tscale is not None else 'computed'}"
                f"{' counter ' + str(counter[1:]) if counter else ''}"
                f" route {route}")
        check(nq.NAME, case + " codes", got[0], want[0], compare_bits)
        check(nq.NAME, case + " scales", got[1], want[1], compare_bits)

    given = torch.full((), 0.25, device=dev)
    # every spec x f32/bf16 x a given or computed tensor scale, SR bits as
    # a tensor
    for M, K in K2_SHAPES:
        for name, fields in K2_SPECS:
            spec = BlockQuantSpec(**fields)
            rb = counter_bits(SEED + 3, (M, K), device=dev) \
                if spec.stochastic else None
            for dtype in (torch.float32, torch.bfloat16):
                x = (torch.randn((M, K), generator=gen(dev, SEED), device=dev)
                     * 3).to(dtype)
                for ts in (None, given):
                    k2_check(f"M={M} K={K} {name}", x, spec, rbits=rb,
                             tscale=ts)
    # counter mode (SR bits hashed in the kernel) for both SR specs: the
    # tensor's own stream (K, 1) and its transpose's (1, M)
    M, K = K2_SHAPES[0]
    for name, fields in K2_SPECS:
        spec = BlockQuantSpec(**fields)
        if not spec.stochastic:
            continue
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn((M, K), generator=gen(dev, SEED + 1), device=dev)
                 * 3).to(dtype)
            for strides in ((K, 1), (1, M)):
                k2_check(f"M={M} K={K} {name}", x, spec,
                         counter=(SEED + 4,) + strides)
    # the edges, on both routes; SR in counter mode and with the same bits
    # as a tensor
    for label, M, K, offset in K2_EDGE:
        for name, fields in K2_SPECS:
            spec = BlockQuantSpec(**fields)
            if K % spec.block:
                continue
            ctr = (SEED + 5, K, 1) if spec.stochastic else None
            for dtype in (torch.float32, torch.bfloat16):
                buf = (torch.randn(M * K + offset, generator=gen(dev, SEED + M),
                                   device=dev) * 3).to(dtype)
                x = buf[offset:].view(M, K)
                for ts in (None, given):
                    k2_check(f"{label} M={M} K={K} {name}", x, spec,
                             tscale=ts, counter=ctr)
                if ctr:
                    k2_check(f"{label} M={M} K={K} {name} bits", x, spec,
                             rbits=nq.counter_rbits((M, K), ctr, dev))
    if k2_routes != {"vec", "scalar"}:
        failures.append((nq.NAME, f"routes met {sorted(k2_routes)}"))
    # K3: bf16 and f32 codes at the unfused GEMM's shapes
    for K, N in OPS_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            args = k3_inputs(OPS_M, K, N, dtype, dev)
            got = fm.block_matmul(*args)
            want = fm.block_matmul_plain(*args)
            torch.cuda.synchronize(dev)
            operands = k3_operands(*args)
            check(fm.BLOCK_NAME, f"M={OPS_M} K={K} N={N} codes "
                  f"{str(dtype)[6:]}", got, want,
                  lambda g, w: compare_tc(g, w, *operands))
            del args, got, want, operands

    # K4 through the route k4_route picks, and both sides of the crossover
    routes = set()
    for M, K, N in K4_SHAPES + K4_CONT_SHAPES + (
            (fm.K4_GEMV_MAX_M, 4096, 4096), (fm.K4_GEMV_MAX_M + 1, 4096, 4096)):
        a, w = k4_inputs(M, K, N, dev)
        route = fm.k4_route(M, NVFP4)
        routes.add(route)
        operands = k4_operands(a, w, NVFP4)
        for out_dtype in (torch.float32, torch.bfloat16):
            got = fm.packed_matmul(a, w, NVFP4, out_dtype=out_dtype)
            want = fm.packed_block_matmul_plain(
                a, w.packed, w.scales, w.tscale, NVFP4, block_b=w.block,
                out_dtype=out_dtype)
            torch.cuda.synchronize(dev)
            check(fm.NAME, f"M={M} K={K} N={N} {str(out_dtype)[6:]} route "
                  f"{route}", got, want,
                  lambda g, w: compare_tc(g, w, *operands))
        del a, w, got, want, operands
    # K4's f32 route: E3M4 data under E4M3 scales (not bf16-exact) above the
    # GEMV rows
    e3m4_a = BlockQuantSpec(data_fmt="e3m4", scale_fmt="e4m3", block=16,
                            two_level=True)
    M, K, N = 64, 4096, 4096
    route = fm.k4_route(M, e3m4_a)
    routes.add(route)
    a, w = k4_inputs(M, K, N, dev)
    operands = k4_operands(a, w, e3m4_a)
    for out_dtype in (torch.float32, torch.bfloat16):
        got = fm.packed_matmul(a, w, e3m4_a, out_dtype=out_dtype)
        want = fm.packed_block_matmul_plain(a, w.packed, w.scales, w.tscale,
                                            e3m4_a, out_dtype=out_dtype)
        torch.cuda.synchronize(dev)
        check(fm.NAME, f"e3m4 A M={M} K={K} N={N} {str(out_dtype)[6:]} "
              f"route {route}", got, want,
              lambda g, w: compare_tc(g, w, *operands))
    del a, w, got, want, operands
    if routes != set(fm.K4_ROUTES):
        failures.append((fm.NAME, f"routes met {sorted(routes)}"))
    for B, H, KVH, D, Sk, kv_len, window in tuple(
            c + (None,) for c in K6_CASES) + K6_EDGE:
        plan = fa.k6_plan(1, H, KVH, D, Sk)
        for fmt in ("nvfp4", "fp8"):
            for q_dtype in (torch.float32, torch.bfloat16):
                q, kc, ks, vc, vs, pos = k6_inputs(B, H, KVH, D, Sk, kv_len,
                                                   q_dtype, dev, fmt)
                got = fa.flash_attention_packed(q, kc, ks, vc, vs, pos,
                                                fmt=fmt, window=window)
                want = fa.flash_attention_packed_plain(q, kc, ks, vc, vs,
                                                       pos, fmt=fmt,
                                                       window=window)
                torch.cuda.synchronize(dev)
                check(fa.PACKED_NAME,
                      f"B={B} H={H} KVH={KVH} D={D} Sk={Sk} kv_len={kv_len} "
                      f"window={window} {fmt} q {str(q_dtype)[6:]} plan "
                      f"{plan}", got, want)
    for label, B, Sq, H, KVH, D, psz, npg, lens, qo, window in K5_CASES:
        for fmt in ("nvfp4", "fp8", "bf16"):
            for q_dtype in (torch.float32, torch.bfloat16):
                args = k5_inputs(B, Sq, H, KVH, D, psz, npg, lens, qo,
                                 window, fmt, q_dtype, dev)
                got = fa.flash_attention_paged(*args, fmt=fmt, window=window)
                want = fa.flash_attention_paged_plain(*args, fmt=fmt,
                                                      window=window)
                torch.cuda.synchronize(dev)
                check(fa.PAGED_NAME,
                      f"{label} B={B} Sq={Sq} H={H} KVH={KVH} D={D} "
                      f"pages={npg}x{psz} {fmt} q {str(q_dtype)[6:]}",
                      got, want)
                del args, got, want
    for B, Sq, Sk, H, KVH, D, dt, causal, window in tuple(
            (B, S, S, H, KVH, D, dt, True, None)
            for B, S, H, KVH, D, dt in K7_CASES + K7_MAIN) + K7_EDGE:
        q, k, v = k7_inputs(B, Sq, H, KVH, D, dt, dev, Sk=Sk)
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window)
        torch.cuda.synchronize(dev)
        check(fa.DENSE_NAME, f"B={B} Sq={Sq} Sk={Sk} H={H} KVH={KVH} D={D} "
              f"{dt} causal={causal} window={window}", got, want)
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


def program_captures(eng) -> dict:
    """{program: {"signatures", "captures", "capture_s"}} of an engine's
    serving programs (serve/graphs.py)."""
    return {n: {"signatures": p.cache_size, "captures": p.captures,
                "capture_s": p.capture_s} for n, p in eng.programs.items()}


def start_mark(dev) -> dict:
    """Device memory when a measured run starts (the peaks are reset here):
    the other engines alive in the process hold some of it."""
    import torch
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    return {"start_mem_bytes": torch.cuda.memory_allocated(dev),
            "start_reserved_bytes": torch.cuda.memory_reserved(dev)}


def memory_mark(dev) -> dict:
    """Peak device memory since the last reset: allocated (what the caching
    allocator handed out) and reserved (what it holds, graph pools
    included: a replay's intermediates live there without being
    allocated)."""
    import torch
    return {"peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
            "peak_reserved_bytes": torch.cuda.max_memory_reserved(dev)}


def phase_serve(dev, batch=4, prompt_len=64, max_new=32, max_len=256):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import counters
    from repro_torch.models import registry
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.serve.packing import weight_store_bytes

    # (a) the same Engine at smoke size: card (kernels, CUDA graphs) vs CPU
    # (plain); two generates, so the second replays the captured prefill
    # and both replay the decode step
    small = get_config("llama2-7b").smoke()
    p_cpu = registry.init_params(small, seed=SEED, device="cpu")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, small.vocab_size, 16) for _ in range(batch)]
    scfg = ServeConfig(batch_size=batch, max_len=64, kv_cache_format="nvfp4")
    ref = Engine(small, p_cpu, scfg, device="cpu")
    out_ref = ref.generate(prompts, max_new=16)
    eng_s = Engine(small, p_cpu, scfg, device=dev)
    for rep in range(2):
        out_card = eng_s.generate(prompts, max_new=16)
        small_checks = [_first_divergence_ok(a.tolist(), b.tolist(), m)
                        for a, b, m in zip(out_card, out_ref, ref.margins)]
        agree = float(np.mean([np.mean(a == b) for a, b in
                               zip(out_card, out_ref)]))
        emit({"phase": "serve", "check": "smoke-size card (graphs) vs CPU "
              "plain", "generate": rep, "arch": small.name,
              "streams_ok": [c[0] for c in small_checks],
              "first_divergence": [c[1] for c in small_checks],
              "token_agreement": agree,
              "programs": program_captures(eng_s)})
        if not all(c[0] for c in small_checks):
            raise AssertionError("card and CPU streams differ at a decisive "
                                 "step")

    # (b) llama2-7b at full width: the graphed engine (the main path) and
    # the same prompts through an eager one
    cfg = get_config("llama2-7b")
    t0 = time.perf_counter()
    params = registry.init_params(cfg, seed=SEED, device=dev)
    scfg = ServeConfig(batch_size=batch, max_len=max_len,
                       kv_cache_format="nvfp4")
    engines = {"graphs": Engine(cfg, params, scfg, device=dev),
               "eager": Engine(cfg, params, scfg, device=dev,
                               cuda_graphs=False)}
    del params
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, prompt_len)
               for _ in range(batch)]
    # warm-up, not counted: the graphed engine's first generate runs each
    # program eagerly once and captures the decode step, its second
    # captures the prefill; after that every call replays
    for side, eng in engines.items():
        for _ in range(2 if side == "graphs" else 1):
            eng.generate(prompts, max_new=2)
    torch.cuda.synchronize(dev)
    sides, outs = {}, {}
    for side, eng in engines.items():
        start = start_mark(dev)
        counters.reset()
        t0 = time.perf_counter()
        out = eng.generate(prompts, max_new=max_new)
        torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        launches = counters.snapshot()
        steps = eng.steps
        want = lockstep_launches(cfg, steps)
        ntok = sum(len(o) for o in out)
        margins = np.asarray(eng.margins)
        info = {"phase": "serve", "side": side, "arch": cfg.name,
                "batch": batch, "prompt_len": prompt_len,
                "max_new": max_new, "kv_cache_format": "nvfp4",
                "decode_steps": steps, "tokens": ntok, "seconds": dt,
                "tokens_per_s": ntok / dt, "setup_s": setup_s,
                "weight_store_bytes": weight_store_bytes(eng.params),
                **start, **memory_mark(dev),
                "first_tokens": [o[:8].tolist() for o in out],
                "programs": program_captures(eng),
                "launches": launches, "expected_launches": want}
        emit(info)
        if launches != want:
            raise AssertionError(f"{side}: launch counts {launches} != "
                                 f"{want}")
        if len(out) != batch or any(len(o) != steps for o in out):
            raise AssertionError("wrong output shape")
        if any(((o < 0) | (o >= cfg.vocab_size)).any() for o in out):
            raise AssertionError("token id outside the vocabulary")
        if not np.isfinite(margins).all():
            raise AssertionError("non-finite logits")
        sides[side], outs[side] = info, (out, margins)
    same = all(np.array_equal(a, b) for a, b in zip(outs["graphs"][0],
                                                    outs["eager"][0]))
    margin_diff = float(np.max(np.abs(outs["graphs"][1] - outs["eager"][1])))
    emit({"phase": "serve", "check": "graphs vs eager at full width",
          "streams_equal": same, "max_abs_margin_diff": margin_diff})
    if not same:
        raise AssertionError("graphed and eager streams differ")
    info = dict(sides["graphs"])
    info["eager"] = sides["eager"]
    info["streams_equal"], info["max_abs_margin_diff"] = same, margin_diff
    info["graph_breakdown"] = graph_breakdown(engines["graphs"], prompts,
                                              dev)
    info["breakdown"] = serve_breakdown(engines["eager"], prompts, dev)
    return info


def graph_breakdown(eng, prompts, dev, steps=8) -> dict:
    """The graphed engine's programs replayed on their own: prefill and
    decode-step times (CUDA events around each replay), and one profiled
    generate's device time by kernel and idle share."""
    import numpy as np
    import torch
    from repro_torch.models import registry
    toks = torch.from_numpy(np.stack(prompts).astype(np.int64)).to(dev)
    registry.reset_decode_state(eng._carry)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2 + steps)]
    prefill, decode = eng.programs["prefill"], eng.programs["decode"]
    captures = (prefill.captures, decode.captures)
    ev[0].record()
    logits = prefill(toks)
    ev[1].record()
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    done = torch.zeros((toks.shape[0],), dtype=torch.bool, device=dev)
    for i in range(steps):
        _, done, nxt, _ = decode(nxt, done)
        ev[2 + i].record()
    torch.cuda.synchronize(dev)
    if (prefill.captures, decode.captures) != captures:
        raise AssertionError("a replay of a seen signature captured anew")
    decode_ms = [ev[1 + i].elapsed_time(ev[2 + i]) for i in range(steps)]
    out = {"prefill_ms": ev[0].elapsed_time(ev[1]),
           "decode_step_ms": statistics.median(decode_ms)}
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(prompts, max_new=steps)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    out.update({"profiled_generate_new_tokens": steps,
                "profiled_wall_ms": wall_ms,
                **device_time(prof, wall_ms, top=12, groups=SERVE_GROUPS)})
    emit({"phase": "serve", "graph_breakdown": out})
    return out


# device kernels of K4 (its quantizer, GEMV, pre-pass, f32 tiles and the
# GEMM core), of K5 and K6 (the split and combine kernels they share, told
# apart by their row-policy template argument) and of K7, summed in the
# serve profiles
SERVE_GROUPS = {"k4_device_ms": ("fp4::", "k4_", "packed_gemm_kernel",
                                 "fp4gemm::"),
                "k5_device_ms": ("PagedRows",),
                "k6_device_ms": ("PackedRows",),
                "k7_device_ms": ("flash_mma_kernel",)}


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
    # device time by kernel of one prefill (a fresh carry)
    carry2 = registry.make_decode_state(cfg, scfg.batch_size, scfg.max_len,
                                        kv_cache_format=scfg.kv_cache_format,
                                        device=dev)
    torch.cuda.synchronize(dev)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        registry.prefill(eng.params, cfg, eng.qcfg, toks, carry2)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    out["prefill_profiled"] = {"wall_ms": wall_ms,
                               **device_time(prof, wall_ms, top=8,
                                             groups=SERVE_GROUPS)}
    del carry2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(prompts, max_new=steps)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    out.update({"profiled_generate_new_tokens": steps,
                "profiled_wall_ms": wall_ms,
                **device_time(prof, wall_ms, top=12, groups=SERVE_GROUPS)})
    # device time by kernel of the decode steps alone (the carry of the
    # timed run above, past its prefill)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, carry = registry.decode_step(eng.params, cfg, eng.qcfg,
                                                 nxt, carry)
            nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    dec = device_time(prof, wall_ms, top=8, groups=SERVE_GROUPS)
    out["decode_steps_profiled"] = {
        "steps": steps, "wall_ms": wall_ms, **dec,
        **{f"{k}_per_step": v / steps for k, v in dec.items()
           if k in SERVE_GROUPS}}
    emit({"phase": "serve", "breakdown": out})
    return out


# ---- continuous batching --------------------------------------------------------

PROGRAMS = ("_prefill", "_prefill_suffix", "_prefill_chunk", "_decode",
            "_verify")


class ProgramLog:
    """Counts and times (CUDA events, read after the run: no extra host
    sync) the engine's five device programs by wrapping its methods.  For
    each (method, first call, calls) in ``profile``, torch.profiler records
    that many consecutive calls of the method into ``breakdown[method]``."""

    def __init__(self, eng):
        import torch
        self.calls = {n: 0 for n in PROGRAMS}
        self.events = {n: [] for n in PROGRAMS}
        self.profile = ()                 # ((method, first call, calls), ..)
        self.breakdown = {}
        for name in PROGRAMS:
            setattr(eng, name, self._wrap(name, getattr(eng, name), torch))

    def _wrap(self, name, fn, torch):
        def run(*a, **kw):
            i = self.calls[name]
            self.calls[name] += 1
            prof = next((p for p in self.profile if p[0] == name), None)
            if prof and i == prof[1]:
                self._start(torch)
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = fn(*a, **kw)
            e.record()
            self.events[name].append((s, e))
            if prof and i == prof[1] + prof[2] - 1:
                self._stop(torch, prof)
            return out
        return run

    def _start(self, torch):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def _stop(self, torch, prof):
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - self._t0) * 1e3
        self._prof.__exit__(None, None, None)
        name, first, n = prof
        self.breakdown[name] = {
            "profiled": f"{name} calls {first}..{first + n - 1}",
            "profiled_wall_ms": wall_ms,
            **device_time(self._prof, wall_ms, top=10, groups=SERVE_GROUPS)}

    def ms(self) -> dict:
        """{program: (median ms per call, total ms)} from the CUDA events."""
        import torch
        torch.cuda.synchronize()
        out = {}
        for n, ev in self.events.items():
            if ev:
                t = [s.elapsed_time(e) for s, e in ev]
                out[n] = (statistics.median(t), sum(t))
        return out


def expected_launches(cfg, calls, draft_layers=0, spec_k=0) -> dict:
    """Each kernel's launches from the engine's program calls: every GEMM of
    every program is K4 (7 per layer, + lm_head where a program samples);
    K5 reads the paged cache in decode, verify (and the draft's k - 1
    decode steps), suffix and chunk prefill; K7 is cold prefill-into-slot
    attention."""
    L = cfg.n_layers
    head = calls["_prefill"] + calls["_prefill_suffix"] + calls["_decode"] \
        + calls["_verify"]
    draft_steps = (spec_k - 1) * calls["_verify"]
    return {"fused_quant_matmul": 0, "block_quantize": 0, "block_matmul": 0,
            "packed_block_matmul": 7 * L * (head + calls["_prefill_chunk"])
            + head + (7 * draft_layers + 1) * draft_steps,
            "flash_attention_paged": L * (calls["_decode"] + calls["_verify"]
                                          + calls["_prefill_suffix"]
                                          + calls["_prefill_chunk"])
            + draft_layers * draft_steps,
            "flash_attention_packed": 0,
            "flash_attention": L * calls["_prefill"]}


def continuous_requests(vocab, n=16, shared=128, lens=(64, 192), max_new=32,
                        seed=SEED):
    """n requests, two arriving per tick: one shared ``shared``-token prefix
    (0 for none) and a private part of lens[0]..lens[1] tokens."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, vocab, shared)
    return [Request(rid=i, prompt=np.concatenate(
        [pre, rng.integers(0, vocab, int(rng.integers(lens[0],
                                                      lens[1] + 1)))]
    ).astype(np.int32), max_new=max_new, arrival=i // 2) for i in range(n)]


COMPILES = ("prefill_compiles", "prefill_suffix_compiles", "chunk_compiles",
            "decode_compiles", "verify_compiles")


def compiles(eng) -> dict:
    """A ContinuousEngine's compile counts (distinct signatures a program)."""
    return {c: getattr(eng, c) for c in COMPILES}


def phase_serve_continuous(dev) -> dict:
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import counters
    from repro_torch.models import registry
    from repro_torch.serve import ContinuousEngine, ServeConfig

    # (a) the same ContinuousEngine at smoke size: card (kernels, CUDA
    # graphs) vs CPU, two runs on each engine (the second on the carry the
    # first left, reset in place, or with its warm prefix cache)
    small = get_config("llama2-7b").smoke()
    p_cpu = registry.init_params(small, seed=SEED, device="cpu")
    for label, extra, shared in (
            ("prefix cache + chunked prefill",
             dict(prefix_cache=True, prefill_chunk=16), 32),
            ("speculative verify-k", dict(spec_k=4), 0)):
        scfg = ServeConfig(max_slots=4, max_len=128, page_size=16,
                           decode_chunk=4, eos_id=-1, **extra)
        reqs = continuous_requests(small.vocab_size, n=6, shared=shared,
                                   lens=(8, 40), max_new=12)
        ref = ContinuousEngine(small, p_cpu, scfg, device="cpu")
        eng = ContinuousEngine(small, p_cpu, scfg, device=dev)
        for rep in range(2):
            want = ref.run(reqs)
            card = eng.run(reqs)
            checks = {r: _first_divergence_ok(card[r].tolist(),
                                              want[r].tolist(),
                                              ref.margins[r]) for r in want}
            emit({"phase": "serve_continuous", "check": "smoke-size card "
                  "(graphs) vs CPU plain", "case": label, "run": rep,
                  "arch": small.name,
                  "streams_ok": [c[0] for c in checks.values()],
                  "first_divergence": [c[1] for c in checks.values()],
                  "compiles_card": compiles(eng), "compiles_cpu": compiles(ref),
                  "programs": program_captures(eng)})
            if sorted(card) != sorted(want) or \
                    not all(c[0] for c in checks.values()):
                raise AssertionError(f"{label}: card and CPU streams differ "
                                     f"at a decisive step")
            if compiles(eng) != compiles(ref):
                raise AssertionError(f"{label}: compile counts differ")

    # (b) llama2-7b at full width and depth: runs A and B through graphed
    # engines (the main path) and the same traces through eager ones
    cfg = get_config("llama2-7b")
    t0 = time.perf_counter()
    params = registry.init_params(cfg, seed=SEED, device=dev)
    base = dict(max_slots=8, max_len=512, page_size=16,
                kv_cache_format="nvfp4", decode_chunk=8, eos_id=-1)
    configs = {"A": ServeConfig(**base, prefix_cache=True, prefill_chunk=64),
               "B": ServeConfig(**base, spec_k=4)}
    engines = {(name, side): ContinuousEngine(
        cfg, params, sc, device=dev, cuda_graphs=side == "graphs")
        for name, sc in configs.items() for side in ("graphs", "eager")}
    del params
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t0
    runs = {"A": continuous_requests(cfg.vocab_size),
            "B": continuous_requests(cfg.vocab_size, shared=0)}
    out = {"setup_s": setup_s, "launches": {k: 0 for k in counters.COUNTS}}
    for name in ("A", "B"):
        reqs = runs[name]
        # the compile counts of the CPU engine on the same trace (smoke
        # size: the token ids taken modulo its vocabulary; lengths,
        # arrivals and so every signature are the trace's own)
        t0 = time.perf_counter()
        cpu = ContinuousEngine(small, p_cpu, configs[name], device="cpu")
        cpu.run([dataclasses.replace(r, prompt=r.prompt % small.vocab_size)
                 for r in reqs])
        cpu_compiles, cpu_s = compiles(cpu), time.perf_counter() - t0
        streams = {}
        for side in ("graphs", "eager"):
            eng = engines.pop((name, side))
            info, res, margins = continuous_run(eng, name, side, reqs, cfg,
                                                dev)
            info["cpu_compiles"], info["cpu_compiles_s"] = cpu_compiles, cpu_s
            emit(info)
            if info["compiles"] != cpu_compiles:
                raise AssertionError(f"run {name} {side}: compile counts "
                                     f"{info['compiles']} != the CPU "
                                     f"engine's {cpu_compiles}")
            streams[side] = (res, margins)
            if side == "graphs":
                out[name] = info
                for k, v in info["launches"].items():
                    out["launches"][k] += v
            else:
                out[name]["eager"] = info
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        (res_g, mg_g), (res_e, mg_e) = streams["graphs"], streams["eager"]
        same = sorted(res_g) == sorted(res_e) and all(
            np.array_equal(res_g[r], res_e[r]) for r in res_g)
        margin_diff = max(float(np.max(np.abs(mg_g[r] - mg_e[r])))
                          for r in res_g)
        emit({"phase": "serve_continuous", "run": name,
              "check": "graphs vs eager at full width",
              "streams_equal": same, "max_abs_margin_diff": margin_diff})
        out[name]["streams_equal"] = same
        out[name]["max_abs_margin_diff"] = margin_diff
        if not same:
            raise AssertionError(f"run {name}: graphed and eager streams "
                                 f"differ")
    return out


def continuous_run(eng, name, side, reqs, cfg, dev):
    """One timed run of a trace with its checks, then a shorter profiled
    run for the idle share.  Returns (the run's record, its streams, its
    greedy margins)."""
    import numpy as np
    import torch
    from repro_torch.kernels import counters
    log = ProgramLog(eng)
    start = start_mark(dev)
    counters.reset()
    t0 = time.perf_counter()
    res = eng.run(reqs)
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    launches = counters.snapshot()
    mem = memory_mark(dev)
    calls = dict(log.calls)
    sched, st = eng.scheduler, eng.scheduler.stats
    want = expected_launches(cfg, calls, eng.draft_layers,
                             eng.scfg.spec_k or 0)
    # the program calls as the scheduler's records count them: every
    # admission's last prefill chunk (or its whole prompt) is one suffix
    # (A) or cold (B) prefill, the other logged chunks are chunk calls,
    # and each tick adds its decode steps (A) or its one verify (B)
    sched_calls = ({"_prefill_chunk": len(sched.prefill_log)
                    - st["admitted"], "_prefill_suffix": st["admitted"],
                    "_decode": st["decode_steps"]} if name == "A" else
                   {"_prefill": st["admitted"],
                    "_verify": st["decode_steps"]})
    summary = eng.metrics.summary()
    ntok = sum(len(v) for v in res.values())
    run_margins = dict(eng.margins)
    margins = np.concatenate([eng.margins[r] for r in res])
    toks = np.concatenate([res[r] for r in res])
    prog_ms = log.ms()
    info = {"phase": "serve_continuous", "run": name, "side": side,
            "arch": cfg.name,
            "config": {k: getattr(eng.scfg, k) for k in (
                "max_slots", "max_len", "page_size", "kv_cache_format",
                "decode_chunk", "prefix_cache", "prefill_chunk",
                "spec_k")}, "draft_layers": eng.draft_layers,
            "requests": len(reqs), "completed": st["completed"],
            "tokens": ntok, "seconds": dt, "tokens_per_s": ntok / dt,
            "ticks": summary["ticks"],
            "wall_ms_per_tick": dt * 1e3 / summary["ticks"],
            "program_calls": calls,
            "program_ms_median": {k: v[0] for k, v in prog_ms.items()},
            "program_ms_total": {k: v[1] for k, v in prog_ms.items()},
            "ttft_ticks": summary["ttft_ticks"],
            "tpot_ticks": summary["tpot_ticks"],
            "prefix_hit_rate": sched.prefix_hit_rate,
            "prefix_tokens_skipped": st["prefix_tokens_skipped"],
            "preemptions": st["preemptions"],
            "spec_accepted_per_tick_slot":
                summary.get("spec_accepted_per_tick_slot"),
            **start, **mem,
            "kv_pool_bytes": sum(c.nbytes() for c in eng._carry),
            "compiles": compiles(eng), "programs": program_captures(eng),
            "launches": launches, "expected_launches": want,
            "scheduler_calls": sched_calls,
            "first_tokens": [res[r][:8].tolist() for r in sorted(res)[:4]]}
    # the device idle share, from a second, shorter run (8 other requests)
    # in which the profiler records 8 consecutive decode calls (a tick of
    # run A) or one verify call (a tick of run B) once every request has
    # arrived, and in run B also its third cold prefill (K7): the
    # profiler's cost stays out of the numbers above
    prog, first, n = ("_decode", 8, 8) if name == "A" else ("_verify", 4, 1)
    log.profile = ((prog, calls[prog] + first, n),) + (
        (("_prefill", calls["_prefill"] + 2, 1),) if name == "B" else ())
    eng.run(continuous_requests(cfg.vocab_size, n=8,
                                shared=128 if name == "A" else 0,
                                max_new=16, seed=SEED + 1))
    missing = [p[0] for p in log.profile if p[0] not in log.breakdown]
    if missing:
        raise AssertionError(f"run {name} {side}: the profiled run made too "
                             f"few {missing} calls")
    info["breakdown"] = log.breakdown[prog]
    if name == "B":
        info["prefill_breakdown"] = log.breakdown["_prefill"]
    if launches != want:
        raise AssertionError(f"run {name} {side}: launch counts {launches} "
                             f"!= {want}")
    if any(calls[k] != v for k, v in sched_calls.items()):
        raise AssertionError(f"run {name} {side}: program calls {calls} "
                             f"disagree with the scheduler {sched_calls}")
    if sorted(res) != [r.rid for r in reqs] or \
            any(len(v) != 32 for v in res.values()):
        raise AssertionError(f"run {name} {side}: wrong outputs")
    if ((toks < 0) | (toks >= cfg.vocab_size)).any():
        raise AssertionError("token id outside the vocabulary")
    if not np.isfinite(margins).all():
        raise AssertionError("non-finite logits")
    return info, res, run_margins


def device_time(prof, wall_ms, top=15, groups=None) -> dict:
    """Device busy time of a torch.profiler run: the union of the intervals
    of its device-side events (kernels, copies, sets; CUPTI's "Command
    Buffer Full" overhead marker is no device work), the time by name, and
    the summed time of each of ``groups`` ({label: name substrings, or a
    predicate on the name}).
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
        name = e.name if len(e.name) <= 100 else e.name[:97] + "..."
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0) / 1e3
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    busy_ms = busy / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    out = {"device_busy_ms": busy_ms,
           "device_idle_share": (1 - busy_ms / wall_ms) if spans else None,
           "device_ms_by_kernel": {k: round(v, 4) for k, v in ranked}}
    for label, subs in (groups or {}).items():
        match = subs if callable(subs) else (
            lambda k, subs=subs: any(sub in k for sub in subs))
        out[label] = sum(v for k, v in by_name.items() if match(k))
    return out


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
    # K2 once per sigma_q probe leaf (core/quantize.py's CUDA route)
    probe_spec = probe_spec_of(tcfg)
    leaves = len(probe_leaf_ids(state.params, probe_spec))
    history = []
    counters.reset()
    for i in range(1 + steps):                      # 1 warm + timed steps
        b = {"tokens": torch.from_numpy(data.batch(i)["tokens"]).to(dev)}
        before = counters.snapshot()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, metrics = train_step(state, b)
        host = {k: float(v) for k, v in metrics.items()}
        torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        after = counters.snapshot()
        host.update(step=i, ms=dt * 1e3, k1_launches=after[
            "fused_quant_matmul"] - before["fused_quant_matmul"],
            k2_launches=after["block_quantize"] - before["block_quantize"])
        history.append(host)
        emit({"phase": "train", "step": host})
    launches = counters.snapshot()
    timed = [h["ms"] for h in history[1:]]
    step_ms = statistics.median(timed)
    want = {k: 0 for k in counters.COUNTS}
    want.update(fused_quant_matmul=(1 + steps) * per_step,
                block_quantize=(1 + steps) * leaves)
    info = {"phase": "train", "arch": full.name, "n_layers": n_layers,
            "step_ms_median": step_ms, "step_ms": timed,
            "tokens_per_s": batch * seq / (step_ms / 1e3),
            "setup_s": setup_s,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
            "k1_launches_per_step_expected": per_step,
            "probe_leaves": leaves, "launches": launches,
            "expected_launches": want}
    emit(info)
    for h in history:
        if h["k1_launches"] != per_step or h["k2_launches"] != leaves:
            raise AssertionError(
                f"step {h['step']}: {h['k1_launches']} K1 and "
                f"{h['k2_launches']} K2 launches, expected {per_step} and "
                f"{leaves}")
        if not all(math.isfinite(h[k]) for k in ("loss", "grad_norm", "gnr")):
            raise AssertionError(f"non-finite metrics at step {h['step']}")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    info["breakdown"] = train_breakdown(train_step, state, data, 1 + steps,
                                        dev)
    b = {"tokens": torch.from_numpy(data.batch(2 + steps)["tokens"]).to(dev)}
    info["probe"] = probe_check(state.params, cfg, qcfg, b, 2 + steps,
                                probe_spec)
    return info


def probe_spec_of(tcfg):
    """The sigma_q probe's spec (train/step.py: NVFP4-SR unless given)."""
    from repro_torch.core.quantize import NVFP4
    return tcfg.sigma_spec or NVFP4.with_rounding(True)


def probe_leaf_ids(tree, spec) -> list:
    """Indices of the sigma_q probe's leaves, by its own rule
    (train/step.py:_estimate_sigma_q): the reference's leaves, per-layer
    ones stacked, of >= 2 dims with a last axis that is a multiple of the
    block."""
    from repro_torch.train import step as step_mod
    return [i for i, (group, stacked) in enumerate(
        step_mod._reference_leaves(tree))
        if group[0].ndim + int(stacked) >= 2
        and group[0].shape[-1] % spec.block == 0]


def probe_check(params, cfg, qcfg, batch, step, spec) -> dict:
    """The sigma_q probe at full width on one step's gradients: every
    leaf through core/quantize.py's K2 route against K2's plain version on
    the card, given the same counter (probe seed, K, 1) and tensor scale,
    codes and scales bit for bit; sigma_q from both, and from the probe
    itself, equal."""
    import torch
    from repro_torch.core import quantize as cq
    from repro_torch.kernels import nvfp4_quant as nq
    from repro_torch.train import step as step_mod
    _, _, grads = step_mod.loss_and_grads(
        params, cfg, qcfg, batch, seed=step_mod.step_seed(step), remat=True)
    sums, den, rows, bad = {}, 0.0, [], []
    with torch.no_grad():
        groups = step_mod._reference_leaves(grads)
        for i in probe_leaf_ids(grads, spec):
            group, stacked = groups[i]
            g32 = (torch.stack(group) if stacked else group[0]).to(
                torch.float32)
            seed, K = step_mod.probe_seed(step, i), g32.shape[-1]
            got = cq.block_quantize(g32, spec, axis=-1, seed=seed)
            ts = cq._tensor_scale(torch.amax(torch.abs(g32)), spec)
            codes, scales = nq.block_quantize_plain(
                g32.reshape(-1, K), spec, tscale=ts, counter=(seed, K, 1))
            want = cq.QuantizedTensor(
                codes.reshape(g32.shape),
                scales.reshape(got.scales.shape).to(g32.dtype), ts,
                got.axis, got.block)
            r = {"leaf": i, "shape": list(g32.shape),
                 "codes": compare_bits(got.codes, want.codes)["ok"],
                 "scales": compare_bits(got.scales, want.scales)["ok"],
                 "tscale": bool(torch.equal(got.tscale, want.tscale))}
            rows.append(r)
            if not (r["codes"] and r["scales"] and r["tscale"]):
                bad.append(i)
            for name, q in (("k2", got), ("plain", want)):
                sq = torch.sum(torch.square(q.dequant() - g32))
                sums[name] = sq if name not in sums else sums[name] + sq
            den += float(g32.numel())
            del g32, got, want, codes, scales
        sigma = {k: float(torch.sqrt(v / max(den, 1.0) + 1e-30))
                 for k, v in sums.items()}
        sigma["probe"] = float(step_mod._estimate_sigma_q(grads, step, spec))
    ok = not bad and sigma["k2"] == sigma["plain"] == sigma["probe"]
    out = {"phase": "train", "check": "sigma_q probe: K2 route vs plain, "
           "bit for bit", "step": step, "leaves": rows, "values": den,
           "sigma_q": sigma, "ok": ok}
    emit(out)
    if not ok:
        raise AssertionError(f"probe check failed: leaves {bad}, {sigma}")
    return out


# ---- train -> restart -> export -> serve -------------------------------------------


def same_bits(a, b) -> bool:
    """Two leaves (tensors or ints) hold the same bits."""
    import torch
    if not isinstance(a, torch.Tensor):
        return a == b
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        view = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}[a.element_size()]
        a, b = a.view(view), b.view(view)
    return bool(torch.equal(a, b))


def differing_leaves(a, b) -> list:
    """Names of the reference leaves of two port trees whose bits differ."""
    from repro_torch.checkpoint import ckpt
    la, lb = ckpt.reference_leaves(a), ckpt.reference_leaves(b)
    if [n for n, _, _ in la] != [n for n, _, _ in lb]:
        return ["<structure>"]
    return [n for (n, pa, _), (_, pb, _) in zip(la, lb)
            if not all(same_bits(x, y) for x, y in zip(pa, pb))]


def lockstep_launches(cfg, steps) -> dict:
    """Each kernel's launches of one lockstep generate of ``steps`` decode
    steps: K4 for every GEMM (7 a layer + lm_head) of the prefill and of each
    step, K7 once a layer in the prefill, K6 once a layer a step."""
    gemms = 7 * cfg.n_layers + 1
    return {"fused_quant_matmul": 0, "block_quantize": 0, "block_matmul": 0,
            "packed_block_matmul": gemms * (1 + steps),
            "flash_attention_paged": 0,
            "flash_attention": cfg.n_layers,
            "flash_attention_packed": cfg.n_layers * steps}


def dir_bytes(path) -> int:
    return sum(p.stat().st_size for p in Path(path).rglob("*")
               if p.is_file())


class CkptLog:
    """``checkpoint.ckpt.save`` and ``restore`` timed while the phase runs:
    each call's op (save, export: a save under serve_packed, restore),
    step, seconds and bytes on disk; a save of a step that exists writes
    nothing (``skipped``)."""

    def __init__(self):
        from repro_torch.checkpoint import ckpt
        self.ckpt, self.rows = ckpt, []
        self._save, self._restore = ckpt.save, ckpt.restore

    def __enter__(self):
        def save(d, step, tree, **kw):
            final = Path(d) / f"step_{step:08d}"
            skipped = final.is_dir()
            t0 = time.perf_counter()
            path = self._save(d, step, tree, **kw)
            self.rows.append({
                "op": "export" if Path(d).name == "serve_packed" else "save",
                "step": step, "seconds": time.perf_counter() - t0,
                "bytes": dir_bytes(path), "skipped": skipped})
            return path

        def restore(d, step, like):
            t0 = time.perf_counter()
            out = self._restore(d, step, like)
            self.rows.append({"op": "restore", "step": step,
                              "seconds": time.perf_counter() - t0,
                              "bytes": dir_bytes(Path(d)
                                                 / f"step_{step:08d}")})
            return out
        self.ckpt.save, self.ckpt.restore = save, restore
        return self

    def __exit__(self, *exc):
        self.ckpt.save, self.ckpt.restore = self._save, self._restore


def count_steps(trainer) -> list:
    """Wrap ``trainer.data.batch``: the launch counts snapshotted before
    each step's batch (append one more after the run) give each step's
    launches as their differences."""
    from repro_torch.kernels import counters
    marks, batch = [], trainer.data.batch

    def counted(step, *a, **kw):
        marks.append(counters.snapshot())
        return batch(step, *a, **kw)
    trainer.data.batch = counted
    return marks


def step_launches(marks) -> list:
    return [{k: b[k] - a[k] for k in a} for a, b in zip(marks, marks[1:])]


def time_telemetry(trainer) -> list:
    """Host ms of each ``_emit_telemetry`` call (one per logged step)."""
    ms, emit_ = [], trainer._emit_telemetry

    def timed(*a, **kw):
        t0 = time.perf_counter()
        emit_(*a, **kw)
        ms.append((time.perf_counter() - t0) * 1e3)
    trainer._emit_telemetry = timed
    return ms


def phase_pipeline(dev, batch=4, seq=1024, n_layers=2, steps=6, split=3,
                   log_every=2, prompt_len=64, max_new=16) -> dict:
    """The paper's pipeline through ``Trainer``: train, checkpoint, restart,
    export the packed artifact, serve it."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.core import fqt, qaf
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import counters
    from repro_torch.obs import Tracer, validate_events
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.serve.packing import pack_model_params
    from repro_torch.train import TrainConfig, Trainer, TrainerConfig

    full = get_config("llama2-7b")
    cfg = dataclasses.replace(full, n_layers=n_layers)
    qcfg, tcfg = fqt.nvfp4_paper_config(), TrainConfig(remat=True)
    data = DataConfig(cfg.vocab_size, seq, batch)
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="pipeline_", dir=ROOT / "build"))
    ck = str(work / "ckpt")
    emit({"phase": "pipeline", "arch": full.name, "cut": {
        "n_layers": [full.n_layers, n_layers]}, "batch": batch, "seq": seq,
        "steps": steps, "split_at": split, "quant": "nvfp4_paper_config",
        "remat": True, "free_disk_bytes": shutil.disk_usage(work).free})
    per_step = sum(k1_step_gemms(cfg, qcfg, batch * seq).values())
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t_phase = time.perf_counter()
    try:
        with CkptLog() as log:
            # step 1: the uninterrupted run
            straight = Trainer(cfg, qcfg, tcfg,
                               TrainerConfig(total_steps=steps), data,
                               device=dev)
            marks = count_steps(straight)
            counters.reset()
            state_a = straight.run()
            marks.append(counters.snapshot())
            per = step_launches(marks)
            # step 2: the split run, the second half a fresh Trainer with a
            # tracer on the same directory
            rc = dict(ckpt_every=split, ckpt_dir=ck, keep_ckpts=1,
                      log_every=log_every)
            first = Trainer(cfg, qcfg, tcfg, TrainerConfig(
                total_steps=split, **rc), data, device=dev)
            marks = count_steps(first)
            first.run()
            marks.append(counters.snapshot())
            per += step_launches(marks)
            trc = Tracer(clock="step", process="train")
            second = Trainer(cfg, qcfg, tcfg, TrainerConfig(
                total_steps=steps, **rc), data, device=dev, tracer=trc)
            marks, tele_ms = count_steps(second), time_telemetry(second)
            state_b = second.run()
            marks.append(counters.snapshot())
            per += step_launches(marks)
        leaves = len(probe_leaf_ids(state_b.params, probe_spec_of(tcfg)))
        want_step = {k: 0 for k in counters.COUNTS}
        want_step.update(fused_quant_matmul=per_step, block_quantize=leaves)
        bad_steps = [i for i, c in enumerate(per) if c != want_step]
        differ = differing_leaves(state_a, state_b)
        hist_a = {h["step"]: h for h in straight.history}
        metrics_equal = all(
            (h["loss"], h["grad_norm"]) == (hist_a[h["step"]]["loss"],
                                            hist_a[h["step"]]["grad_norm"])
            for h in second.history)
        events = trc.trace_events()
        logged = [s for s in range(split, steps) if s % log_every == 0]
        gnr_ts = [e["ts"] for e in events if e["name"] == "gnr"]
        n_ref = len(ckpt.reference_leaves(state_b.params))
        n_ratio = sum(e["name"].startswith("ratio") for e in events)
        problems = validate_events(events)
        del state_a
        # the exported artifact against the final parameters' own packing
        spec = qaf.qaf_quant_config(qcfg).fwd_w
        want_art = pack_model_params(cfg, state_b.params, spec)
        with CkptLog() as rlog:
            art_step, artifact = ckpt.restore_latest(
                str(work / "ckpt" / "serve_packed"), want_art)
        art_differ = differing_leaves(artifact, want_art)
        del want_art
        gemm_params = tscales = art_bytes = 0
        for name, parts, _ in ckpt.reference_leaves(artifact):
            n = sum(p.numel() * p.element_size() for p in parts)
            if name.endswith(".packed"):
                gemm_params += 2 * sum(p.numel() for p in parts)
            if name.endswith(".tscale"):
                tscales += sum(p.numel() for p in parts)
            if name.endswith((".packed", ".scales", ".tscale")):
                art_bytes += n
        rows = log.rows + rlog.rows
        io = {"rows": rows, "checkpoint_dir_bytes": dir_bytes(work)}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    train_s = time.perf_counter() - t_phase
    info = {"phase": "pipeline", "arch": full.name, "n_layers": n_layers,
            "k1_launches_per_step": [c["fused_quant_matmul"] for c in per],
            "k2_launches_per_step": [c["block_quantize"] for c in per],
            "expected_per_step": want_step,
            "bad_steps": bad_steps, "events": second.events,
            "differing_leaves": differ, "metrics_equal": metrics_equal,
            "logged_steps": logged, "gnr_ts": gnr_ts,
            "ratio_gauges": n_ratio, "reference_leaves": n_ref,
            "trace_problems": problems, "trace_events": len(events),
            "telemetry_host_ms": tele_ms, "artifact_step": art_step,
            "artifact_differing_leaves": art_differ,
            "artifact_bytes_per_gemm_param": art_bytes / gemm_params,
            "artifact_bound_per_gemm_param": 0.5625 + 4 * tscales
            / gemm_params, "io": io, "train_seconds": train_s,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)}
    emit(info)
    if bad_steps:
        raise AssertionError(f"steps {bad_steps}: launches "
                             f"{[per[i] for i in bad_steps]} != {want_step}")
    if differ or not metrics_equal:
        raise AssertionError(f"restarted run differs from the uninterrupted "
                             f"one: leaves {differ}, metrics equal "
                             f"{metrics_equal}")
    if second.events[0] != {"kind": "restore", "step": split}:
        raise AssertionError(f"first event {second.events[0]}")
    if gnr_ts != logged or n_ratio != n_ref * len(logged) or problems:
        raise AssertionError(f"trace: gnr at {gnr_ts} (logged {logged}), "
                             f"{n_ratio} ratio gauges, {problems}")
    if art_step != steps or art_differ:
        raise AssertionError(f"artifact step {art_step}, leaves {art_differ}")
    if not info["artifact_bytes_per_gemm_param"] <= \
            info["artifact_bound_per_gemm_param"]:
        raise AssertionError("artifact larger than packed NVFP4")

    # serve the artifact (graphed, pack_weights=False) and the final
    # parameters (packed at build) on the same prompts
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, prompt_len)
               for _ in range(batch)]
    scfg = ServeConfig(batch_size=batch, max_len=prompt_len + max_new + 16,
                       kv_cache_format="nvfp4")
    engines = {"artifact": Engine(cfg, artifact, scfg, pack_weights=False,
                                  device=dev),
               "final_params": Engine(cfg, state_b.params, scfg, device=dev)}
    del artifact, state_b
    sides = {}
    for side, eng in engines.items():
        for _ in range(2):           # eager, then capture; later calls replay
            eng.generate(prompts, max_new=2)
        counters.reset()
        out = eng.generate(prompts, max_new=max_new)
        torch.cuda.synchronize(dev)
        launches = counters.snapshot()
        want = lockstep_launches(cfg, eng.steps)
        margins = np.asarray(eng.margins, np.float32)
        sides[side] = {"launches": launches, "expected_launches": want,
                       "programs": program_captures(eng),
                       "first_tokens": [o[:8].tolist() for o in out]}
        if launches != want:
            raise AssertionError(f"{side}: launch counts {launches} != {want}")
        if len(out) != batch or any(len(o) != eng.steps for o in out) \
                or not np.isfinite(margins).all():
            raise AssertionError(f"{side}: wrong or non-finite output")
        sides[side]["out"], sides[side]["margins"] = out, margins
    a, b = sides["artifact"], sides["final_params"]
    same = all(np.array_equal(x, y) for x, y in zip(a.pop("out"),
                                                    b.pop("out")))
    margins_equal = bool(np.array_equal(a.pop("margins"),
                                        b.pop("margins")))
    serve = {"phase": "pipeline", "check": "artifact (pack_weights=False, "
             "graphs) vs final params (packed at build)", "batch": batch,
             "prompt_len": prompt_len, "max_new": max_new, "sides": sides,
             "streams_equal": same, "margins_equal": margins_equal}
    emit(serve)
    if not (same and margins_equal):
        raise AssertionError("the artifact serves another stream")
    info["serve"] = serve
    return info


def phase_ops(dev) -> dict:
    """The unfused FQT GEMM through ``kernels/ops.py`` at llama2-7b's forward
    GEMM shapes, held to the plain versions and to K1."""
    import torch
    from repro_torch.core import fqt
    from repro_torch.core.formats import counter_bits
    from repro_torch.kernels import counters, ops, ref
    from repro_torch.kernels.fp4_matmul import block_matmul_plain
    from repro_torch.kernels.nvfp4_quant import block_quantize_plain

    qcfg = fqt.nvfp4_paper_config()
    cases = [(K, N, False) for K, N in OPS_SHAPES] + [OPS_SHAPES[0] + (True,)]

    def inputs(K, N, sr):
        """bf16 x (M, K) and W (K, N) of a forward GEMM, the paper's forward
        specs (SR on both operands for sr), and SR bits of their shapes."""
        g = gen(dev, SEED + K + N)
        a = torch.randn((OPS_M, K), generator=g, device=dev).to(torch.bfloat16)
        b = (torch.randn((K, N), generator=g, device=dev) * 0.02
             ).to(torch.bfloat16)
        sa, sb = qcfg.fwd_a.with_rounding(sr), qcfg.fwd_w.with_rounding(sr)
        ra = counter_bits(SEED + 1, (OPS_M, K), device=dev) if sr else None
        rb = counter_bits(SEED + 2, (K, N), device=dev) if sr else None
        return a, b, sa, sb, ra, rb

    def gemms(a, b, sa, sb, ra, rb):
        """What a user of the API runs: K2 on A and on B^T (B's blocks run
        along K), B's codes and scales transposed into K3's layout, K3;
        then K1 on the same raw operands.  Events around K2 (both
        operands), K3 and K1; the transposes lie outside them."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        bt = b.T.contiguous()
        rbt = None if rb is None else rb.T.contiguous()
        ev[0].record()
        ac, asc = ops.block_quantize(a, sa, rbits=ra)
        bct, bsct = ops.block_quantize(bt, sb, rbits=rbt)
        ev[1].record()
        bc, bsc = bct.T.contiguous(), bsct.T.contiguous()
        ts = ref.tensor_scale_ref(a, sa) * ref.tensor_scale_ref(b, sb)
        ev[2].record()
        out = ops.block_matmul(ac, asc, bc, bsc, ts, block=sa.block)
        ev[3].record()
        fused = ops.fused_quant_matmul(a, b, sa, sb, a_rbits=ra, b_rbits=rb)
        ev[4].record()
        return (ac, asc), (bct, bsct), out, fused, ev

    # warm-up at a small shape (first launches load the modules), not counted
    gemms(*inputs(256, 128, True))
    torch.cuda.synchronize(dev)

    runs = []
    counters.reset()
    for K, N, sr in cases:
        args = inputs(K, N, sr)
        runs.append((K, N, sr, args) + gemms(*args))
    torch.cuda.synchronize(dev)
    launches = counters.snapshot()
    n = len(cases)
    want = {k: 0 for k in counters.COUNTS}
    want.update(block_quantize=2 * n, block_matmul=n, fused_quant_matmul=n)
    emit({"phase": "ops", "gemms": n, "launches": launches,
          "expected_launches": want})
    if launches != want:
        raise AssertionError(f"ops: launch counts {launches} != {want}")

    failures = []
    for K, N, sr, (a, b, sa, sb, ra, rb), qa, qb, out, fused, ev in runs:
        case = f"M={OPS_M} K={K} N={N} {'sr' if sr else 'rtn'}"
        checks = {}
        want_a = block_quantize_plain(a, sa, rbits=ra)
        want_b = block_quantize_plain(
            b.T.contiguous(), sb, rbits=None if rb is None else rb.T)
        for what, got, want_q in (("A codes", qa[0], want_a[0]),
                                  ("A scales", qa[1], want_a[1]),
                                  ("B^T codes", qb[0], want_b[0]),
                                  ("B^T scales", qb[1], want_b[1])):
            checks["K2 " + what] = compare_bits(got, want_q)
        ts = ref.tensor_scale_ref(a, sa) * ref.tensor_scale_ref(b, sb)
        k3_args = (qa[0], qa[1], qb[0].T, qb[1].T, ts)
        checks["K3"] = compare_tc(out, block_matmul_plain(*k3_args),
                                  *k3_operands(*k3_args, block=sa.block))
        # the chain against K1: rtol = atol = 1e-5 relative to max |out|
        err = (out - fused).abs()
        peak = float(fused.abs().max())
        checks["chain vs K1"] = {
            "ok": bool((err <= 1e-5 * (fused.abs() + peak)).all())
            and bool(torch.isfinite(out).all()),
            "max_abs_err": float(err.max()), "max_abs_out": peak,
            "rule": "rtol = atol = 1e-5 of max |out|"}
        emit({"phase": "ops", "case": case,
              "k2_both_ms": ev[0].elapsed_time(ev[1]),
              "k3_ms": ev[2].elapsed_time(ev[3]),
              "k1_ms": ev[3].elapsed_time(ev[4]), "checks": checks})
        failures += [(case, k) for k, v in checks.items() if not v["ok"]]
    runs.clear()
    if failures:
        raise AssertionError(f"ops: checks failed: {failures}")
    return {"launches": launches}


# K2's kernels (csrc/block_quantize.cu): the "vec" route's absmax pre-pass
# and quantizer, the "scalar" route's quantizer
K2_KERNELS = ("absmax_vec_kernel", "block_quantize_vec_kernel",
              "block_quantize_scalar_kernel")


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
    # K1's kernels: absmax, the operand quantizer and the GEMM (of
    # fp4_common.cuh and fp4_gemm.cuh); K2's (the sigma_q probe), whose
    # names may also hold "fp4::" in their argument types, apart
    def k2(name):
        return any(k in name for k in K2_KERNELS)

    def k1(name):
        return not k2(name) and ("fp4::" in name or "fp4gemm::" in name)
    out = {"profiled_step_wall_ms": wall_ms,
           **device_time(prof, wall_ms, top=20,
                         groups={"k1_device_ms": k1, "k2_device_ms": k2})}
    emit({"phase": "train", "breakdown": out})
    return out


def time_ms(fn, flush, reps=20, warm=3) -> float:
    """Median of per-launch CUDA-event times, L2 flushed before each.  The
    card then spins ~0.1 ms more (``torch.cuda._sleep``), so the host's
    enqueue of the call (its ``host_us``, up to ~0.1 ms for the serving
    kernels' wrappers late in a long process) ends before the start event
    and the time is the card's, not the host's."""
    import torch
    for _ in range(warm):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        flush.zero_()
        torch.cuda._sleep(200_000)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def host_us(fn, n=50) -> float:
    """Host time of one call (us): n calls enqueued back to back, read
    before the device is waited for; the launch queue stays unfilled."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def launch_breakdown(fn, flush, event_ms, last="fp4gemm::gemm_kernel",
                     tries=3) -> dict:
    """[name, device ms] of each device-side event of one call of fn, in
    launch order (torch.profiler), after a warm call.  The L2 flush (a
    fill) runs first inside the profiled window and marks where fn's events
    begin (a cold profiler may drop the first device event it sees).  A
    profiler session late in a long process has been seen to drop device
    events and to misscale their durations, so a record is consistent only
    when it ends with the call's final launch, ``last``, and its launches
    sum to within 25% of ``event_ms``, the CUDA-event time of the same
    call; up to ``tries`` sessions are recorded."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            flush.fill_(1)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and not e.name.startswith("Command Buffer")),
                     key=lambda e: e.time_range.start)
        fills = [i for i, e in enumerate(evs) if "FillFunctor" in e.name]
        launches = [[e.name[:60],
                     (e.time_range.end - e.time_range.start) / 1e3]
                    for e in evs[fills[-1] + 1 if fills else 0:]]
        total = sum(ms for _, ms in launches)
        consistent = (bool(launches) and last in launches[-1][0]
                      and abs(total - event_ms) <= 0.25 * event_ms)
        if consistent:
            break
    return {"consistent": consistent, "sum_ms": total, "event_ms": event_ms,
            "launches": launches}


def bound_ms(nbytes, ops) -> tuple:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def k5_time_inputs(label, dev):
    """K5 at one shape of K5_CASES (nvfp4 pool, bf16 q) for phase times:
    the kernel's arguments, the bytes and operations the call needs (q and
    out, the K/V rows below each slot's kv_len and causal frontier, the page
    table's read rows, the two int32 vectors; 4 D flops per query row and
    valid key and head) and SDPA's yardstick call over the same rows
    dequantized to bf16, gathered per slot and masked."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.quantize import kv_dequant
    (_, B, Sq, H, KVH, D, psz, npg, lens, qo, window), = (
        c for c in K5_CASES if c[0] == label)
    args = k5_inputs(B, Sq, H, KVH, D, psz, npg, lens, qo, window, "nvfp4",
                     torch.bfloat16, dev)
    q, kc, ks, vc, vs, pt, kl, qoff = args
    kv_len, q_off = kl.tolist(), qoff.tolist()
    kend = [min(n, o + Sq) for n, o in zip(kv_len, q_off)]
    valid = sum(min(n, o + r + 1) for n, o in zip(kv_len, q_off)
                for r in range(Sq))
    nbytes = (2 * B * Sq * H * D * 2 + 2 * sum(kend) * KVH * (D // 2 + D // 16)
              + sum(-(-e // psz) for e in kend) * 4 + 2 * B * 4)
    ops = 4 * valid * H * D
    L = max(max(kend), 1)
    rows = torch.arange(L, device=dev)
    phys = pt.long()[:, (rows // psz).clamp(max=npg - 1)] * psz + rows % psz
    G = H // KVH

    def dense(codes, scales):
        d = kv_dequant(codes.reshape(-1, KVH, D // 2)[phys],
                       scales.reshape(-1, KVH, D // 16)[phys], "nvfp4")
        return d.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    kt, vt = dense(kc, ks), dense(vc, vs)
    qpos = qoff[:, None] + torch.arange(Sq, device=dev)
    mask = ((rows[None, None, :] < kl[:, None, None])
            & (rows[None, None, :] <= qpos[:, :, None]))[:, None]
    qt = q.transpose(1, 2)
    return (args, window, nbytes, ops,
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   attn_mask=mask))


# the per-launch breakdowns of phase times, each taken in a fresh child
# process: {case: (kernel, the call's last launch)}
BREAKDOWNS = {
    "fwd 4096^3": ("fused_quant_matmul", "fp4gemm::gemm_kernel"),
    "lm_head dX": ("fused_quant_matmul", "fp4gemm::gemm_kernel"),
    "4096^3 f32 codes": ("block_matmul", "fp4gemm::gemm_kernel"),
    "gemv M=4 4096^2": ("packed_block_matmul", "k4_gemv_kernel"),
    "core M=256 4096^2": ("packed_block_matmul", "fp4gemm::gemm_kernel"),
    "decode": ("flash_attention_paged", "kv_combine_kernel"),
    "suffix": ("flash_attention_paged", "kv_combine_kernel"),
    "k6 decode": ("flash_attention_packed", "kv_split_kernel"),
    "k7 prefill": ("flash_attention", "flash_mma_kernel"),
    "k2 4096^2 f32": ("block_quantize", "block_quantize_vec_kernel"),
}


def breakdown_call(case, dev):
    """The call whose launches BREAKDOWNS[case] records."""
    import torch
    from repro_torch.core.quantize import NVFP4
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.kernels import fp4_matmul as fm
    from repro_torch.kernels import nvfp4_quant as nq
    bf16 = torch.bfloat16
    if case in ("fwd 4096^3", "lm_head dX"):
        # K1's forward at 4096^3; the lm_head's dX, SR on its (4096, 32000)
        # A in counter mode
        M, K, N, sr, sc = ((4096, 4096, 4096, False, (1.0, 0.02))
                           if case == "fwd 4096^3" else
                           (4096, 32000, 4096, True, (1e-4, 0.02)))
        a, b, sa, sb, _, _, ca, _ = k1_inputs(M, K, N, "nvfp4", sr, False,
                                              *sc, dev)
        return lambda: fm.fused_quant_matmul(a, b, sa, sb, a_counter=ca,
                                             out_dtype=bf16)
    if case == "4096^3 f32 codes":
        args = k3_inputs(4096, 4096, 4096, torch.float32, dev)
        return lambda: fm.block_matmul(*args)
    if case.startswith(("gemv", "core")):
        M = int(case.split()[1][2:])
        a, w = k4_inputs(M, 4096, 4096, dev)
        return lambda: fm.packed_matmul(a, w, NVFP4, out_dtype=bf16)
    if case == "k6 decode":                # the lockstep decode, kv_len 80
        args = k6_inputs(4, 32, 32, 128, 256, 80, bf16, dev)
        return lambda: fa.flash_attention_packed(*args)
    if case == "k7 prefill":               # the lockstep prefill
        q, k, v = k7_inputs(4, 64, 32, 32, 128, BF16_VALUED, dev)
        return lambda: fa.flash_attention(q, k, v, causal=True)
    if case == "k2 4096^2 f32":   # the absmax pre-pass, then the quantizer
        x = torch.randn((4096, 4096), generator=gen(dev, SEED), device=dev) * 3
        return lambda: nq.block_quantize(x, NVFP4)
    args, window, _, _, _ = k5_time_inputs(case, dev)
    return lambda: fa.flash_attention_paged(*args, window=window)


def breakdown_child(case) -> None:
    """Child process of phase times: print one JSON line, the per-launch
    breakdown of BREAKDOWNS[case] beside the call's CUDA-event time."""
    import torch
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    with torch.no_grad():
        fn = breakdown_call(case, dev)
        out = launch_breakdown(fn, flush, time_ms(fn, flush, reps=10),
                               last=BREAKDOWNS[case][1])
    print(json.dumps(out), flush=True)


def breakdown_in_child(case, children=2) -> dict:
    """BREAKDOWNS[case] from a fresh child process; a second child where
    the first one's profiler recorded no consistent session (it has come
    back with no device event at all)."""
    for _ in range(children):
        r = subprocess.run([sys.executable, "-c", "import chip_smoke; "
                            f"chip_smoke.breakdown_child({case!r})"],
                           cwd=ROOT, capture_output=True, text=True,
                           timeout=600)
        if r.returncode != 0:
            raise AssertionError(f"breakdown {case!r} failed:\n"
                                 f"{r.stderr[-3000:]}")
        out = json.loads(r.stdout.strip().splitlines()[-1])
        if out["consistent"]:
            break
    return out


# M of K4's route times: decode (1-8) to chunk prefill (64)
K4_CROSS_M = (1, 4, 8, 16, 32, 64)


def phase_times(dev) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.core.quantize import NVFP4, _tensor_scale, kv_dequant
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.kernels import fp4_matmul as fm
    from repro_torch.kernels import nvfp4_quant as nq
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)  # 256 MB
    rows = {}

    def record(name, case, kernel, plain, library, nbytes, ops, reps=20,
               **extra):
        b, by = bound_ms(nbytes, ops)
        r = {"ms": time_ms(kernel, flush, reps),
             "host_us": host_us(kernel),
             "plain_ms": time_ms(plain, flush, reps),
             "library_ms": time_ms(library, flush, reps) if library else None,
             "bound_ms": b, "bound_by": by, **extra}
        emit({"phase": "times", "kernel": name, "case": case, **r})
        rows[(name, case)] = r
        return r

    with torch.no_grad():
        for M, K, N in K4_SHAPES + K4_CONT_SHAPES:
            a, w = k4_inputs(M, K, N, dev)
            wd = w.dequant()                        # bf16 (K, N), yardstick
            nbytes = M * K * 2 + K * N // 2 + K // 16 * N + 4 + M * N * 2
            record(fm.NAME, (M, K, N),
                   lambda: fm.packed_matmul(a, w, out_dtype=torch.bfloat16),
                   lambda: fm.packed_block_matmul_plain(
                       a, w.packed, w.scales, w.tscale, NVFP4,
                       out_dtype=torch.bfloat16),
                   lambda: torch.matmul(a, wd), nbytes, 2 * M * N * K,
                   route=fm.k4_route(M, NVFP4))
            del a, w, wd
        # both of K4's routes at M 1-64 on each weight: the crossover
        cross = {}
        for K, N, _ in K4_WEIGHTS:
            for M in K4_CROSS_M:
                a, w = k4_inputs(M, K, N, dev)
                cross[f"{M} {K} {N}"] = {route: time_ms(
                    lambda: fm._k4_launch(a, w.packed, w.scales, w.tscale,
                                          NVFP4, w.block, None,
                                          torch.bfloat16, route), flush)
                    for route in ("gemv", "core")}
                del a, w
        emit({"phase": "times", "kernel": fm.NAME, "route_ms": cross,
              "gemv_max_m": fm.K4_GEMV_MAX_M})
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
                   nbytes, 4 * B * H * kv_len * D,
                   plan=fa.k6_plan(1, H, KVH, D, Sk))
        # K5 at run A's decode shape: 8 slots of 256 cached tokens, nvfp4
        B, H, D, psz, npg, kv_len = 8, 32, 128, 16, 32, 256
        q, kc, ks, vc, vs, pt, kl, qo = k5_inputs(
            B, 1, H, H, D, psz, npg, (kv_len,) * B, "last", None, "nvfp4",
            torch.bfloat16, dev)
        read = pt[:, :kv_len // psz].long()       # the pages that are read
        kd = kv_dequant(kc[read].reshape(B, kv_len, H, D // 2),
                        ks[read].reshape(B, kv_len, H, D // 16), "nvfp4")
        vd = kv_dequant(vc[read].reshape(B, kv_len, H, D // 2),
                        vs[read].reshape(B, kv_len, H, D // 16), "nvfp4")
        kt, vt = kd.transpose(1, 2).contiguous(), vd.transpose(1, 2
                                                               ).contiguous()
        qt = q.transpose(1, 2)
        # q and out in bf16, the K/V rows below kv_len (codes + scales), the
        # page table's read rows and the two int32 vectors
        nbytes = (2 * B * H * D * 2 + 2 * B * kv_len * H * (D // 2 + D // 16)
                  + B * (kv_len // psz) * 4 + 2 * B * 4)
        record(fa.PAGED_NAME, (B, H, H, D, kv_len, "nvfp4"),
               lambda: fa.flash_attention_paged(q, kc, ks, vc, vs, pt, kl,
                                                qo),
               lambda: fa.flash_attention_paged_plain(q, kc, ks, vc, vs, pt,
                                                      kl, qo),
               lambda: F.scaled_dot_product_attention(qt, kt, vt),
               nbytes, 4 * B * H * kv_len * D,
               plan=fa.k5_plan(B, 1, H, H, D, psz, npg))
        del q, kc, ks, vc, vs, kd, vd, kt, vt
        # K5 at the verify (Sq 4) and the chunk (Sq 64) shapes of K5_CASES
        for label in ("verify", "suffix"):
            args, window, nbytes, ops, sdpa = k5_time_inputs(label, dev)
            B, Sq, H, _ = args[0].shape
            _, psz, KVH, _ = args[1].shape
            record(fa.PAGED_NAME, (label, B, Sq, H, KVH, "nvfp4"),
                   lambda: fa.flash_attention_paged(*args, window=window),
                   lambda: fa.flash_attention_paged_plain(*args,
                                                          window=window),
                   sdpa, nbytes, ops,
                   plan=fa.k5_plan(B, Sq, H, KVH, args[0].shape[3], psz,
                                   args[5].shape[1]))
            del args, sdpa
        for B, S, H, KVH, D, dt in K7_CASES + K7_MAIN:
            q, k, v = k7_inputs(B, S, H, KVH, D, dt, dev)
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
            # SR operands in counter mode, as core/fqt.py passes them
            a, b, spec_a, spec_b, ra, rb, ca, cb = k1_inputs(
                M, K, N, "nvfp4", sr_a, sr_b, *scales[role], dev,
                a_transposed=role == "dW")
            nbytes = 2 * (M * K + K * N + M * N)
            r = record(fm.FUSED_NAME, (role, M, K, N),
                       lambda: fm.fused_quant_matmul(
                           a, b, spec_a, spec_b, a_counter=ca, b_counter=cb,
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
        # K2 at (4096, 4096) f32, the forward spec (NVFP4 RtN, computed
        # tensor scale): x read once, f32 codes and scales written.  Its
        # f32 operations (~10 a value, 0.0025 ms at 67 TFLOP/s) lie far
        # below the bytes; no single PyTorch call computes it.  Then the
        # tensor scale given (no absmax pre-pass), bf16, and the sigma_q
        # probe's largest leaf: the stacked MLP gradients (4 x 11008, 4096)
        # f32, NVFP4-SR in counter mode, the scale given as core/quantize.py
        # gives it, and RtN at that shape beside it.
        M = K = 4096
        x = torch.randn((M, K), generator=gen(dev, SEED), device=dev) * 3
        xb = x.to(torch.bfloat16)
        ts = torch.full((), 0.25, device=dev)
        Mp, sr = 4 * 11008, NVFP4.with_rounding(True)
        xp = torch.randn((Mp, K), generator=gen(dev, SEED), device=dev) * 1e-4
        tsp = _tensor_scale(torch.amax(torch.abs(xp)), sr)
        ctr = (SEED + 7, K, 1)
        for case, args, kw, reps in (
                ((M, K, "float32"), (x, NVFP4), {}, 20),
                ((M, K, "float32", "given tscale"), (x, NVFP4),
                 dict(tscale=ts), 20),
                ((M, K, "bfloat16"), (xb, NVFP4), {}, 20),
                ((Mp, K, "float32", "nvfp4 sr counter"), (xp, sr),
                 dict(tscale=tsp, counter=ctr), 5),
                ((Mp, K, "float32", "nvfp4 rtn"), (xp, NVFP4),
                 dict(tscale=tsp), 5)):
            t = args[0]
            record(nq.NAME, case,
                   lambda: nq.block_quantize(*args, **kw),
                   lambda: nq.block_quantize_plain(*args, **kw), None,
                   2 * t.numel() * t.element_size() + 4 * t.numel() // 16,
                   0, reps=reps,
                   route=nq.k2_route(16, t.dtype, t.data_ptr() % 16 == 0))
        del x, xb, xp
        # K3 at 4096^3 on f32 codes; the yardstick is torch.matmul on the
        # bf16-dequantized operands
        ac, asc, bc, bsc, ts = k3_inputs(M, K, K, torch.float32, dev)
        ad = (ac * asc.repeat_interleave(16, dim=1)).to(torch.bfloat16)
        bd = (bc * bsc.repeat_interleave(16, dim=0)).to(torch.bfloat16)
        record(fm.BLOCK_NAME, (M, K, K),
               lambda: fm.block_matmul(ac, asc, bc, bsc, ts),
               lambda: fm.block_matmul_plain(ac, asc, bc, bsc, ts),
               lambda: torch.matmul(ad, bd),
               4 * (2 * M * K + M * K) + 4 * 2 * M * K // 16 + 4,
               2 * M * K * K, reps=5)
        del ac, asc, bc, bsc, ad, bd
    torch.cuda.empty_cache()
    # what one call spends in each of its launches, each call in a fresh
    # process
    for case, (kernel, _) in BREAKDOWNS.items():
        emit({"phase": "times", "kernel": kernel, "case": case,
              "launch_breakdown": breakdown_in_child(case)})
    return rows


# the representative case of each kernel in the summary line: the launch the
# main path makes most often (K3: the unfused GEMM's square shape; K2: that
# shape on f32, the case every PR has timed; K4: decode, wq/wk/wv/wo; K5:
# run A's decode;
# K6: decode at the middle of the run; K7: prefill, f32 operands holding
# bf16 values as _attn_prefill passes them)
SUMMARY = {
    "fused_quant_matmul": (("fwd", 4096, 4096, 4096), "cuda",
                           "src/repro_torch/kernels/csrc/fused_quant_matmul.cu",
                           "src/repro/kernels/fp4_matmul.py:208"),
    "block_quantize": ((4096, 4096, "float32"), "cuda",
                       "src/repro_torch/kernels/csrc/block_quantize.cu",
                       "src/repro/kernels/nvfp4_quant.py:101"),
    "block_matmul": ((4096, 4096, 4096), "cuda",
                     "src/repro_torch/kernels/csrc/block_matmul.cu",
                     "src/repro/kernels/fp4_matmul.py:71"),
    "packed_block_matmul": ((4, 4096, 4096), "cuda",
                            "src/repro_torch/kernels/csrc/fp4_matmul.cu",
                            "src/repro/kernels/fp4_matmul.py:309"),
    "flash_attention_paged": ((8, 32, 32, 128, 256, "nvfp4"), "cuda",
                              "src/repro_torch/kernels/csrc/"
                              "flash_attn_paged.cu",
                              "src/repro/kernels/flash_attn.py:417"),
    "flash_attention_packed": ((4, 32, 32, 128, 256, 80), "cuda",
                               "src/repro_torch/kernels/csrc/"
                               "flash_attn_paged.cu",
                               "src/repro/kernels/flash_attn.py:255"),
    "flash_attention": ((4, 64, 32, 32, 128, BF16_VALUED), "cuda",
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
                      "serve": phase_serve,
                      "serve_continuous": phase_serve_continuous,
                      "train": phase_train, "pipeline": phase_pipeline,
                      "ops": phase_ops,
                      "times": phase_times}[p](dev)
        emit({"phase": p, "done": True,
              "seconds": round(time.perf_counter() - t0, 3)})
    print(card_line(), flush=True)
    if set(PHASES) - {"env"} <= set(phases):
        # each kernel's launches on the main path that runs it: K4, K6, K7
        # in the lockstep serve, K5 over runs A and B of the continuous
        # engine, K1 and K2 (the sigma_q probe) in training, K3 in the
        # unfused GEMMs of ops
        launches = dict(results["serve"]["launches"])
        launches["flash_attention_paged"] = \
            results["serve_continuous"]["launches"]["flash_attention_paged"]
        for name in ("fused_quant_matmul", "block_quantize"):
            launches[name] = results["train"]["launches"][name]
        launches["block_matmul"] = results["ops"]["launches"]["block_matmul"]
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
