#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU: serve
(lockstep and continuous batching), train, the pipeline from training
through checkpoint/restart and the packed export to serving, the dense
and moe archs at full width, the recurrent families at full width and
depth, the encdec and vlm families at full width, and the serving and
training meshes (every family) on gloo ranks sharing the card.

    python3 chip_smoke.py                    # every phase but times_full
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
           a long cache of 16 tiles in one split) and K6_ROLL (the rolling
           rule of a sliding-window buffer of 64 and of 4096 rows, below,
           at and past the buffer, GQA); K7 runs K7_CASES and K7_EDGE
           (window, non-causal, ragged Sq != Sk, head dims 32 and 96) and
           K7_ENCDEC (whisper's encoder, Sq = Sk = 1500, and its
           cross-attention, Sk 1500); K5
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
           prefill, and speculative verify-k); (b) llama2-7b at full
           width, depth cut 32 -> CONT_LAYERS = 8 (16 since phase train_mesh
           joined the script, 8 since phase mesh_families, to keep it
           inside its time limit), from
           random packed NVFP4 weights over a paged nvfp4 KV pool, as two
           runs of 16 requests (2 arriving per tick, 32 new tokens each,
           greedy, no EOS): run A with the shared-prefix cache and
           64-token chunked prefill, run B with cold prefills (K7) and
           speculative verify-k (k = 4, 8-layer draft).  Each run
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
  archs    the dense and moe archs at full width, weights from the streaming
           packer (``packing.init_packed_params``, one layer at a time;
           its seconds, bytes and peak memory printed), nvfp4 KV, greedy.
           Each arch's smoke config first runs through the graphed engines
           on the card against the CPU's plain versions (lockstep for
           codeqwen1.5-7b, qwen2.5-32b, Mixtral with a prompt past its
           window, Qwen3-MoE; continuous for the moe pair; the CPU side in
           a child process started once the kernels are built), streams
           equal.  Run a: codeqwen1.5-7b at full depth, lockstep batch 4 x
           prompt 64, 32 new, then ContinuousEngine on run A's traffic.
           Run b: qwen2.5-32b at full width, depth cut 64 -> 8 layers,
           batch 4 x 64, 16 new.  Run c: Mixtral-8x7B at full width, depth
           cut 32 -> 4 layers (both cuts keep the whole script inside its
           time limit: halved again since phase mesh_families joined),
           batch 4 x 64, 32 new; one
           request of 4160 prompt tokens and 64 new over its rolling
           4096-row buffer (K7 with the window, K6 with the rolling rule);
           8 requests through ContinuousEngine.  Run d: Qwen3-MoE at full
           width, depth cut to 4 layers, ContinuousEngine with the prefix
           cache, 64-token chunks and verify-k 4 (2-layer draft).  Each
           lockstep run goes through a graphed Engine (the main path) and
           an eager one, streams equal, launches as ``lockstep_launches``
           derives them (K4 ``layer_gemms`` a layer: each expert's three
           on its capacity rows) on both; each continuous run is checked
           as in serve_continuous.  Prefill and decode-step ms, tokens/s,
           idle share and peak memory per run.  Run e: Mixtral at full
           width, depth cut to 2 layers, through ``Trainer`` (batch 1 x
           seq 1024, nvfp4_paper_config, remat, 3 steps): K1 launches per
           step as ``k1_step_gemms`` derives them (the experts' GEMMs on
           their capacity rows), K2 once per sigma_q probe leaf, loss and
           nll finite and loss > nll (the router's aux term).
  recurrent
           the hybrid (zamba2-1.2b: Mamba2 layers and one shared attention
           + SwiGLU block after every 6, MHA, D 64) and ssm (xlstm-125m:
           blocks, every 4th sLSTM) families at full width, depth cut 38 ->
           19 and 12 -> 6 (RECURRENT_LAYERS, since phase mesh_families
           joined the script), weights from the streaming packer, nvfp4 KV,
           greedy,
           no EOS.  Their smoke configs first run through a graphed Engine
           on the card against the CPU's plain versions (two generates),
           streams equal.  Each family serves batch 4 x prompt 64, 32 new,
           through a graphed Engine (the main path; the prefill program is
           one decode step per prompt token, captured as one graph) and an
           eager one: streams equal, launches as ``recurrent_launches``
           derives them on both sides (K4 at every weight GEMM and the
           lm_head, K6 at each application of zamba2's shared block, every
           step of prefill and decode), prefill and decode-step ms, the
           prefill's capture seconds, tokens/s and a profiled generate's
           idle share.  Then each trains through ``Trainer`` at that depth
           (zamba2 batch 4 x seq 1024, xlstm 4 x 256; nvfp4_paper_config,
           remat, AdamW, the sigma_q probe; 3 steps): K1 launches per step
           as ``k1_step_gemms`` derives them (``recurrent_gemms``), K2 once
           per probe leaf, finite metrics, step ms, tokens/s and peak
           memory; zamba2's trained params and xlstm's TrainState are saved
           and restored (``checkpoint/ckpt.py``, under build/) with 0
           differing leaves.
  encdec_vlm
           the encdec (whisper-base: 6 + 6 layers, d 512, 1500 encoder
           frames, GELU MLPs, cross-attention, the tied head) and vlm
           (internvl2-26b: 48 layers, d 6144, GQA 48/8, d_ff 16384, vocab
           92672, a 256-row patch prefix) families at full width, weights
           from the streaming packer, nvfp4 KV, greedy, no EOS, random
           seeded frames / prefix.  Run a: whisper at full depth, lockstep
           batch 4 x prompt 32, 32 new, max_len 128, graphed and eager:
           streams equal, launches as ``encdec_launches`` derives them (K4
           at every GEMM, K7 for the encoder and every cross-attention, K6
           for the decoder's reads, K1 for the tied head), prefill and
           decode-step ms, tokens/s, idle share, peak memory.  Run b:
           whisper through ContinuousEngine (4 slots, 16-token pages, nvfp4
           pool; 8 requests two a tick, prompts 16-48, 32 new, each with its
           own frames), graphed and eager: ``continuous_run``'s checks (K5
           for the decoder's reads), each request's stream equal to its
           solo graphed lockstep run or first apart at a near-tie, compile
           counts equal to the smoke-size CPU engine's on the same trace.
           Run c: internvl2-26b at 24 of 48 layers (VLM_SERVE_LAYERS, since
           phase mesh_families joined), lockstep batch 4 x (256
           prefix + 64 prompt tokens), 32 new, max_len 384, as run a.  Run
           d: whisper through ``Trainer`` at full depth (batch 4 x 256,
           nvfp4_paper_config, remat, 3 steps; K1 from ``k1_step_gemms``
           with the encoder's 4 x 1500 rows, K2 per probe leaf), its
           TrainState saved and restored bit for bit; internvl2-26b at
           full width, depth cut to 2 layers, a cold and a measured train
           step on 1 x 512 tokens after a 256-row prefix.  Run e: both smoke configs on the
           card against the CPU's plain versions (a CPU child): logits, the
           lockstep streams with extras, whisper's continuous streams and
           compile counts.
  mesh     the serving mesh (``distributed/``, ``tp_fp4_matmul``): the
           launcher ``python -m repro_torch.launch.serve --mesh SPEC
           --dist-backend gloo --report DIR`` as child processes, whose
           ranks (one process each) share the one card through gloo, its
           collectives staged through the host (NCCL refuses two ranks on
           one device), their programs eager.  Run b: ContinuousEngine at
           tp=2 on run A's traffic cut to 4 requests (128-token shared
           prefix + 64, prefix cache, 64-token chunks, 32 new); run c: the
           lockstep Engine at tp=2, batch 4 x 64, 32 new; both llama2-7b at
           full width, depth cut 32 -> MESH_LAYERS = 2 (4 since phase
           mesh_families joined, 2 since phase mesh_encdec_recurrent),
           weights packed layer by layer into each rank's shards, all six
           runs started together.  Run d: dp=2,tp=2 (4 ranks), depth cut
           32 -> MESH_LAYERS,
           lockstep, 16 new, every weight gathered over "data" in its
           packed wire format before its GEMMs.  Each run is served again
           by one process (no mesh, graphed).  Checks: every rank's streams
           equal; each rank's K4/K5/K6/K7 launches as its program calls
           derive them (``mesh_expected``); the streams against the
           one-process run (common prefix; a first parting only at a
           one-process greedy margin below MESH_MARGIN); the prompts'
           prefill logits within MESH_LOGITS_RTOL (relative L2).  Reports
           tokens/s, ms a decode call, each rank's collectives (calls,
           bytes, host ms) and peak memory, and run d's wire bytes a GEMM
           parameter -- gloo ranks sharing one card: not a TP speed.  Phase
           kernels holds K4's ``a_amax`` and ``plan_n`` at the tp=2 shard
           shapes (``k4_tp_checks``).
  train_mesh
           the training mesh (``Trainer(mesh=)``, ``distributed/``,
           ``fqt._ShardedFP4Matmul``): llama2-7b at full width, depth cut
           32 -> TM_LAYERS = 1 (2 until phase mesh_encdec_recurrent
           joined), a global batch of 2 x 512, nvfp4_paper_config, remat,
           the sigma_q probe, 3 steps from one seeded state on gloo ranks
           sharing the card (spawned from this process after the kernels
           are built, in two waves started together), each run against
           one process
           (``Trainer`` without a mesh).  Run b: tp=2, checkpointed after
           step 2; c: fsdp=2, then dp=2,tp=2 (4 ranks); d: (pod, data,
           model) = (2, 1, 1) with the GRAD_FP8 compressed pod mean; e:
           run b's checkpoint restored in this process (its leaves equal
           to the ranks' shards bit for bit, by digests) and step 3 taken
           there; f: ``pipeline_apply`` over (pipe, data) = (2, 1), the
           dense block as layer_fn, 4 layers, 4 microbatches, forward and
           backward against the sequential application.  Every rank's
           metrics equal, K1 and K2 launches a step as derived
           (``k1_step_gemms``, ``tm_probe_launches``, the compressor's one
           a leaf), losses, updates, grad_norm and sigma_q within the TM_*
           rules (scaled, where the run splits a contraction over "model"
           or compresses, by the SR envelope of two one-process runs with
           re-drawn SR streams: ``tm_envelope``, ``tm_loss_bound``), run
           b's rank 0 (the checkpoint writer) peaking within
           one logical leaf of rank 1, the pipeline within PIPE_FWD_RTOL /
           PIPE_RTOL; reports step ms,
           collectives a step (FSDP gather and reduce-scatter bytes) and
           peak memory a rank -- gloo ranks sharing one card: not a DP/TP
           speed.  Phase kernels holds K1 with ``a_amax`` / ``b_amax`` at
           the tp=2 shard shapes (``k1_tp_checks``) and K2 at GRAD_FP8 and
           on the probe's shards (``k2_mesh_checks``).
  mesh_families
           the moe and vlm families on a mesh (``models/moe.py``'s routes,
           the batched expert collectives), gloo ranks sharing the card,
           each run against one process on the same seeded weights
           (MF_SERVE, MF_TRAIN; every run at one layer since phase
           mesh_encdec_recurrent joined): a, Mixtral-8x7B at 1 of 32
           layers, the lockstep Engine at tp=2 (``launch.serve --mesh``),
           batch 4 x 64, 32 new; b, Qwen3-MoE at 1 of 94 layers,
           ContinuousEngine at tp=2 (8 slots, prefix cache, 64-token
           chunks); c, InternVL2-26B at 1 of 48 layers, lockstep tp=2,
           batch 4 x (256 prefix + 64), 16 new -- held as phase mesh holds
           its runs, plus the moe layers' collectives a layer and program
           call (2, for E 8 as for E 128); d, Mixtral at 1 layer through
           ``Trainer`` at tp=2, 1 x
           1024, 3 steps, against one process and its SR envelope (two
           runs with re-drawn SR streams), as phase train_mesh; e,
           Qwen3-MoE at 1 layer, fsdp=2 (the "local" route), 2 x 512, one step: step-0
           loss and every rank's routing against one process; d and e
           hold grad_norm and sigma_q at every step as train_mesh does
           (e, with no re-drawn run, within TM_NORM_RTOL).  Launches
           as derived on every rank, peak memory a rank beside one
           process's, collectives a step -- gloo ranks sharing one card:
           not a DP/TP speed.  Phase kernels holds K4 and K1 at the
           experts' shard shapes (``k4_tp_checks``, ``k1_tp_checks``).
  mesh_encdec_recurrent
           the encdec, hybrid and ssm families on a mesh (``models/
           whisper.py``, ``mamba2.py``, ``xlstm.py`` on this rank's heads,
           the gathers of their concatenated projections), gloo ranks
           sharing the card, each run against one process on the same
           seeded weights (ER_SERVE, ER_TRAIN): a, whisper-base at full
           depth, the lockstep Engine at tp=2 (``launch.serve --mesh``),
           batch 4 x 32 with random frames, 16 new; b, whisper-base,
           ContinuousEngine at tp=2 (4 slots, 8 requests two a tick,
           random frames each, 16 new); c, zamba2-1.2b at 12 of 38 layers (two shared-attention
           groups), lockstep 4 x 64, 32 new; d, xlstm-125m at full depth,
           lockstep 4 x 64, 32 new -- held as phase mesh holds its runs;
           e-g, ``Trainer`` at tp=2
           on one spawned rank pair, family after family (whisper-base at
           full depth, 4 x 256; zamba2-1.2b at 6 layers, 2 x 512;
           xlstm-125m at 4 layers, its sLSTM the fourth, 2 x 256; 3 steps
           each), while this process runs each one-process run and its
           two runs with re-drawn SR streams, all runs started together:
           train_mesh's rules (the later losses and each leaf's update
           within the SR envelope), and each leaf's step-0 gradient
           within its envelope but for the leaves that both redraws move
           by their norm (noise: whisper's key biases).  Launches as
           derived on every rank (``er_expected``, ``k1_step_gemms``,
           ``er_probe_launches``), collectives a decode step and a train
           step, peak memory a rank beside one process's -- gloo ranks
           sharing one card: not a TP speed.  Phase kernels holds K4 and
           K1 at the three families' shard shapes (``k4_tp_checks``,
           ``k1_tp_checks``).
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
  times    median CUDA-event time of each kernel at its case in the
           kernels line (SUMMARY; L2 flushed before every launch, as a step
           finds its operands cold), beside its bound, its plain version
           and one PyTorch call computing the same function (a yardstick
           the port never calls).
  times_full (not run by default: ``--phases times_full``) the same at
           every other main-path shape: K1 at every train GEMM with its SR
           operands in counter mode, as the train step runs it, and at the
           recurrent families' new shapes (zamba2's N = 8384 in_proj and
           its K = 8384 dX, xlstm's N = 50432 lm_head, whisper's tied head
           and encoder w_in, internvl2's head); K4 at every main-path shape
           with its route, and both routes at M 1-64 (the crossover); K5 at
           run A's decode, the verify and the chunk shapes; K6 at every
           K6_CASES row with the split plan it takes and on run c's rolling
           caches (K6_ROLL_TIMES); K7 at every K7_CASES, K7_MAIN and
           K7_ENCDEC row; GELU (whisper's MLP) in the reference's order and
           as torch's tanh GELU; K2 at 4096^2 f32 (computed and given
           tensor scale), bf16, and at the sigma_q probe's largest leaf in
           counter mode; and the device time of each launch inside one call
           of K1, K2 (its absmax pre-pass and quantizer), K3, K4 (each
           route), K5, K6 and K7, each taken in a fresh child process (a
           profiler late in a long process drops device events).

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
repository beside it, the script fails before printing either.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
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
          "pipeline", "archs", "recurrent", "encdec_vlm", "mesh",
          "train_mesh", "mesh_families", "mesh_encdec_recurrent", "ops",
          "times", "times_full")
DEFAULT_PHASES = PHASES[:-1]       # times_full only when asked for
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
# K4 on the recurrent families' decode steps (M = 4): zamba2-1.2b's in_proj
# (N = 8384, 65.5 x 128), out_proj, the shared block's wq/wk/wv/wo,
# w_gate/w_up, w_down, lm_head; xlstm-125m's w_up / w_gates, w_q/w_k/w_v,
# w_down / w_ff_down, w_ff_gate / w_ff_up, and its lm_head (N = 50432)
K4_RECURRENT = ((4, 2048, 8384), (4, 4096, 2048), (4, 2048, 2048),
                (4, 2048, 8192), (4, 8192, 2048), (4, 2048, 32000),
                (4, 768, 3072), (4, 1536, 1536), (4, 1536, 768),
                (4, 768, 1536), (4, 768, 50432))
# K4 on the encdec and vlm paths: whisper-base's decode GEMV (M 4: 512^2,
# 512 -> 2048, 2048 -> 512) and its encoder and per-step cross-attention
# K/V on the core (M = 4 x 1500 frames), internvl2-26b's decode GEMV (wq/wo,
# wk/wv, w_gate/w_up, w_down, lm_head) and its prefill on the core (M = 4 x
# (256 vision tokens + 64 prompt tokens))
K4_ENCDEC = ((4, 512, 512), (4, 512, 2048), (4, 2048, 512),
             (6000, 512, 512), (6000, 512, 2048), (6000, 2048, 512),
             (4, 6144, 6144), (4, 6144, 1024), (4, 6144, 16384),
             (4, 16384, 6144), (4, 6144, 92672),
             (1280, 6144, 6144), (1280, 6144, 1024), (1280, 6144, 16384),
             (1280, 16384, 6144))
# K4's tensor-parallel forms at llama2-7b's tp=2 shard shapes (phase
# kernels): column shards (K, N / 2) of wq/wk/wv, w_gate/w_up and the lm_head
# with the full N's GEMV plan (plan_n), row shards (K / 2, N) of wo and
# w_down with the global |A| max (a_amax); at M 4 (GEMV), 256 (core) and,
# E3M4 A, 64 (the f32 route).  Then the experts' (phase mesh_families) and
# the encdec, hybrid and ssm families' (phase mesh_encdec_recurrent):
# zamba2's in_proj (N 4192 of 8384), its shared block's wq/wk/wv and
# w_gate/w_up and rows wo / w_down, out_proj (row K 2048 of 4096); xLSTM's
# w_up / w_gates (N 1536 of 3072), w_q/w_k/w_v (N 768), w_ff_gate/w_ff_up
# (N 768 of 1536), rows w_down and w_ff_down (K 768 of 1536); whisper's
# wq/wk/wv (N 256), w_in (N 1024 of 2048), rows wo (K 256) and w_out (K
# 1024 of 2048)
K4_TP_COL = ((4096, 2048), (4096, 5504), (4096, 16000),
             (4096, 7168), (4096, 768),         # Mixtral's, Qwen3's experts
             (2048, 4192), (2048, 1024), (2048, 4096),           # zamba2
             (768, 1536), (1536, 768), (768, 768),               # xLSTM
             (512, 256), (512, 1024))                            # whisper
K4_TP_ROW = ((2048, 4096), (5504, 4096), (7168, 4096), (768, 4096),
             (1024, 2048), (4096, 2048), (2048, 2048),           # zamba2
             (768, 768),                                         # xLSTM
             (256, 512), (1024, 512))                            # whisper
K4_TP_M = (4, 256)
K6_CASES = (  # (B, H, KVH, D, Sk, kv_len): llama2-7b, then tinyllama (G = 8),
    # then zamba2-1.2b's shared block (MHA, D 64), whisper-base's decoder
    # (MHA 8 heads, D 64, 128 rows) and internvl2-26b's (GQA 48/8, D 128, 384
    # rows, mid-decode after its 320-row prefill)
    (4, 32, 32, 128, 256, 65), (4, 32, 32, 128, 256, 80),
    (4, 32, 32, 128, 256, 96), (4, 32, 4, 64, 256, 96),
    (4, 32, 32, 64, 256, 80), (4, 8, 8, 64, 128, 48),
    (4, 48, 8, 128, 384, 336))
# K6 at its edges, decode rows (q_offset = kv_len - 1): (B, H, KVH, D, Sk,
# kv_len, window) -- one cached token, exactly one 128-key tile, a window,
# and a 2048-token cache (16 tiles in k6_plan's one split; with a window
# that starts inside the fifth tile)
K6_EDGE = (
    (4, 32, 32, 128, 256, 1, None), (4, 32, 32, 128, 256, 128, None),
    (4, 32, 32, 128, 256, 80, 24), (4, 32, 32, 128, 2048, 1500, None),
    (4, 32, 32, 128, 2048, 1500, 600))
# K6 over a ROLLING (sliding-window) lockstep cache, decode rows: (B, H, KVH,
# D, buffer, tokens written) with the window = the buffer, as Mixtral's
# min(max_len, 4096): tokens below, at and past the buffer (rows
# overwritten), on a 64-row buffer and on the 4096-row buffer of run c's long
# request (GQA, G = 4)
K6_ROLL = tuple((4, 32, 8, 128, 64, n) for n in (40, 64, 65, 200)) + tuple(
    (1, 32, 8, 128, 4096, n) for n in (3000, 4096, 4161, 4223, 9000))
# K6 timed on run c's rolling caches: (B, H, KVH, D, buffer, tokens written)
K6_ROLL_TIMES = ((4, 32, 8, 128, 256, 80), (1, 32, 8, 128, 4096, 4192))
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
    ("decode whisper", 4, 1, 8, 8, 64, 16, 8, (0, 17, 48, 80), "last", None),
)
K7_CASES = (  # (B, S, H, KVH, D, dtype name)
    (4, 64, 32, 32, 128, "float32"), (4, 64, 32, 32, 128, "bfloat16"),
    (4, 64, 32, 4, 64, "bfloat16"),
    (1, 192, 32, 32, 128, "float32"))      # run B's cold prefill-into-slot
# K7 on the main path's operands: f32 tensors holding bf16 values, as
# layers._attn_prefill passes them (K7's TF32-exact route): the lockstep
# prefill, run B's cold prefill-into-slot, internvl2-26b's prefill (256
# vision + 64 prompt rows, GQA 48/8: a head group of 6) and whisper-base's
# decoder self-attention prefill (MHA 8, D 64)
BF16_VALUED = "float32 bf16-valued"
K7_MAIN = ((4, 64, 32, 32, 128, BF16_VALUED),
           (1, 192, 32, 32, 128, BF16_VALUED),
           (4, 320, 48, 8, 128, BF16_VALUED),
           (4, 32, 8, 8, 64, BF16_VALUED))
# K7 at its edges: (B, Sq, Sk, H, KVH, D, dtype name, causal, window)
K7_EDGE = tuple(
    (4, 64, 64, 32, 32, 128, dt, causal, window) for dt in ("float32",
                                                             "bfloat16")
    for causal, window in ((True, 40), (False, None))) + (
    (2, 50, 77, 8, 2, 32, "float32", True, None),
    (2, 77, 50, 8, 2, 96, "bfloat16", True, 30),   # every row sees a key
    (1, 100, 100, 4, 4, 96, "float32", False, 30))
# K7 on whisper-base's serving paths, f32 holding bf16 values, non-causal
# (B, Sq, Sk, H, KVH, D): the encoder (1500 frames), cross-attention of a
# decode step and of a 32-token prefill
K7_ENCDEC = ((4, 1500, 1500, 8, 8, 64), (4, 1, 1500, 8, 8, 64),
             (4, 32, 1500, 8, 8, 64))
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
    # the recurrent families' training: zamba2-1.2b's in_proj (N = 8384)
    # and its dX contracting over K = 8384 (batch 4 x 1024 tokens), and
    # xlstm-125m's lm_head (N = 50432; 4 x 256 tokens)
    ("fwd zamba2 in_proj", 4096, 2048, 8384, "nvfp4", False, False, 1.0,
     0.02),
    ("dX zamba2 in_proj", 4096, 8384, 2048, "nvfp4", True, False, 1e-4,
     0.02),
    ("dW zamba2 in_proj", 2048, 4096, 8384, "nvfp4", True, True, 1.0, 1e-4),
    ("fwd xlstm lm_head", 1024, 768, 50432, "nvfp4", False, False, 1.0,
     0.02),
    ("dX xlstm lm_head", 1024, 50432, 768, "nvfp4", True, False, 1e-4,
     0.02),
    # whisper-base's tied head on a decode step: embed.T (512, 51968), both
    # operands RtN (the serving qaf_config)
    ("fwd whisper head", 4, 512, 51968, "nvfp4", False, False, 1.0, 0.02),
    # whisper-base's training: the encoder's w_in over 4 x 1500 frames
    # (forward, dX, and dW contracting over K = 6000 rows), and
    # internvl2-26b's head (N = 92672) on 512 tokens and its dX
    ("fwd whisper enc w_in", 6000, 512, 2048, "nvfp4", False, False, 1.0,
     0.02),
    ("dX whisper enc w_in", 6000, 2048, 512, "nvfp4", True, False, 1e-4,
     0.02),
    ("dW whisper enc w_in", 512, 6000, 2048, "nvfp4", True, True, 1.0,
     1e-4),
    ("fwd internvl2 head", 512, 6144, 92672, "nvfp4", False, False, 1.0,
     0.02),
    ("dX internvl2 head", 512, 92672, 6144, "nvfp4", True, False, 1e-4,
     0.02),
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


def k4_operands(a, w, spec_a, amax=None):
    """K4's dequantized operands Q(A) (M, K) and B' (K, N) in f32, and tsA *
    tsB, as its plain version computes them (A's tensor scale from
    ``amax`` where given)."""
    import torch
    from repro_torch.kernels import common as kc
    from repro_torch.kernels import fp4_matmul as fm
    ad, tsa = fm._quantized_operand(a, spec_a, None, along_rows=False,
                                    amax=amax)
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
              seed=SEED, written=None):
    """A decode row (q_offset = kv_len - 1) over a random cache; with
    ``written`` the row of a rolling buffer of Sk rows that holds ``written``
    tokens (q_offset = written - 1, kv_len = min(written, Sk))."""
    import torch
    from repro_torch.core.quantize import kv_quant_rows
    g = gen(dev, seed)
    q = torch.randn((B, 1, H, D), generator=g, device=dev).to(q_dtype)
    kv = torch.randn((2, B, Sk, KVH, D), generator=g, device=dev
                     ).to(torch.bfloat16)
    kc, ks = kv_quant_rows(kv[0], fmt)
    vc, vs = kv_quant_rows(kv[1], fmt)
    pos = [kv_len - 1, kv_len] if written is None else [written - 1,
                                                         min(written, Sk)]
    pos = torch.tensor(pos, dtype=torch.int32, device=dev)
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
    for M, K, N in K4_SHAPES + K4_CONT_SHAPES + K4_RECURRENT + K4_ENCDEC + (
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
    worst["k4_tp"] = k4_tp_checks(dev, check, e3m4_a)
    worst["k1_tp"] = k1_tp_checks(dev, check)
    worst["k2_mesh"] = k2_mesh_checks(dev, check)
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
    for B, H, KVH, D, Sk, n in K6_ROLL:
        for fmt in ("nvfp4", "fp8"):
            for q_dtype in (torch.float32, torch.bfloat16):
                q, kc, ks, vc, vs, pos = k6_inputs(B, H, KVH, D, Sk, None,
                                                   q_dtype, dev, fmt,
                                                   written=n)
                got = fa.flash_attention_packed(q, kc, ks, vc, vs, pos,
                                                fmt=fmt, window=Sk,
                                                rolling=True)
                want = fa.flash_attention_packed_plain(
                    q, kc, ks, vc, vs, pos, fmt=fmt, window=Sk, rolling=True)
                torch.cuda.synchronize(dev)
                check(fa.PACKED_NAME,
                      f"rolling B={B} H={H} KVH={KVH} D={D} buffer={Sk} "
                      f"written={n} {fmt} q {str(q_dtype)[6:]}", got, want)
                del q, kc, ks, vc, vs, got, want
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
            for B, S, H, KVH, D, dt in K7_CASES + K7_MAIN) + K7_EDGE + tuple(
            (B, Sq, Sk, H, KVH, D, BF16_VALUED, False, None)
            for B, Sq, Sk, H, KVH, D in K7_ENCDEC):
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


def k4_tp_checks(dev, check, e3m4_a) -> dict:
    """K4's tensor-parallel forms (``fp4_matmul.tp_fp4_matmul``) at the
    tp=2 shard shapes of llama2-7b and of one expert of Mixtral-8x7B and
    of Qwen3-MoE (phase mesh_families), the shards cut by
    ``sharding.place_serve_params`` for each of the 2 ranks, in every
    route: a column shard with ``plan_n`` (the full N's GEMV plan) against
    its plain version under the tensor-core rule AND bit for bit against
    the 1-device K4's columns; a row shard with the global |A| max
    (``a_amax``) against its plain version given the same max, and the
    pair's f32 partials summed against the 1-device K4 under the same
    forward-error rule (over the full K).  Returns the cases' count and
    worst errors for the kernels line."""
    import torch
    from repro_torch.core.quantize import NVFP4
    from repro_torch.distributed import sharding
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.kernels import fp4_matmul as fm
    out = {"cases": 0, "column_bitwise": 0, "routes": set(),
           "a_amax_max_abs_err": 0.0, "row_pair_max_abs_err": 0.0}
    ranks = [Mesh((2,), ("model",), device=dev, rank=r) for r in range(2)]

    def shard(name, w, r):
        return sharding.place_serve_params({name: w}, ranks[r])[name]

    for spec_a, Ms in ((NVFP4, K4_TP_M), (e3m4_a, (64,))):
        for M in Ms:
            route = fm.k4_route(M, spec_a)
            out["routes"].add(route)
            for K, Nl in K4_TP_COL:
                a, w = k4_inputs(M, K, 2 * Nl, dev)
                for out_dtype in (torch.float32, torch.bfloat16):
                    one = fm.packed_matmul(a, w, spec_a, out_dtype=out_dtype)
                    for r in range(2):
                        wr = shard("w_up", w, r)
                        got = fm.packed_matmul(a, wr, spec_a,
                                               out_dtype=out_dtype,
                                               plan_n=2 * Nl)
                        want = fm.packed_block_matmul_plain(
                            a, wr.packed, wr.scales, wr.tscale, spec_a,
                            out_dtype=out_dtype)
                        torch.cuda.synchronize(dev)
                        case = (f"tp=2 column rank {r} M={M} K={K} N={Nl} "
                                f"of {2 * Nl} plan_n {str(out_dtype)[6:]} "
                                f"route {route}")
                        ops = k4_operands(a, wr, spec_a)
                        check(fm.NAME, case, got, want,
                              lambda g, w_, o=ops: compare_tc(g, w_, *o))
                        check(fm.NAME, case + " vs 1-device columns", got,
                              one[:, r * Nl:(r + 1) * Nl].contiguous(),
                              compare_bits)
                        out["cases"] += 2
                        out["column_bitwise"] += 1
                del a, w, one, got, want
            for Kl, N in K4_TP_ROW:
                a, w = k4_inputs(M, 2 * Kl, N, dev)
                amax = torch.amax(torch.abs(a.float())).reshape(1)
                one = fm.packed_matmul(a, w, spec_a, out_dtype=torch.float32)
                parts = []
                for r in range(2):
                    ar = a[:, r * Kl:(r + 1) * Kl].contiguous()
                    wr = shard("w_down", w, r)
                    got = fm.packed_matmul(ar, wr, spec_a,
                                           out_dtype=torch.float32,
                                           a_amax=amax)
                    want = fm.packed_block_matmul_plain(
                        ar, wr.packed, wr.scales, wr.tscale, spec_a,
                        a_amax=amax)
                    torch.cuda.synchronize(dev)
                    ops = k4_operands(ar, wr, spec_a, amax)
                    case = (f"tp=2 row rank {r} M={M} K={Kl} of {2 * Kl} "
                            f"N={N} a_amax route {route}")
                    check(fm.NAME, case, got, want,
                          lambda g, w_, o=ops: compare_tc(g, w_, *o))
                    out["a_amax_max_abs_err"] = max(
                        out["a_amax_max_abs_err"],
                        float((got - want).abs().max()))
                    parts.append(got)
                    out["cases"] += 1
                pair = parts[0] + parts[1]
                ops = k4_operands(a, w, spec_a)
                check(fm.NAME, f"tp=2 row pair summed vs 1-device M={M} "
                      f"K={2 * Kl} N={N} route {route}", pair, one,
                      lambda g, w_, o=ops: compare_tc(g, w_, *o))
                out["row_pair_max_abs_err"] = max(
                    out["row_pair_max_abs_err"],
                    float((pair - one).abs().max()))
                out["cases"] += 1
                del a, w, one, parts, pair, got, want, ops
    out["routes"] = sorted(out["routes"])
    return out


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


def graph_breakdown(eng, prompts, dev, steps=8, phase="serve",
                    extras=None) -> dict:
    """The graphed engine's programs replayed on their own: prefill and
    decode-step times (CUDA events around each replay), and one profiled
    generate's device time by kernel and idle share.  ``extras``: the
    generate's (frames, prefix_embeds), the prefill's operands."""
    import numpy as np
    import torch
    from repro_torch.models import registry
    extras = extras or {}
    toks = torch.from_numpy(np.stack(prompts).astype(np.int64)).to(dev)
    ops = [None if extras.get(k) is None else extras[k].to(dev)
           for k in ("frames", "prefix_embeds")]
    registry.reset_decode_state(eng._carry)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2 + steps)]
    prefill, decode = eng.programs["prefill"], eng.programs["decode"]
    captures = (prefill.captures, decode.captures)
    ev[0].record()
    logits = prefill(toks, *ops)
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
        eng.generate(prompts, max_new=steps, extras=extras)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    out.update({"profiled_generate_new_tokens": steps,
                "profiled_wall_ms": wall_ms,
                **device_time(prof, wall_ms, top=12, groups=SERVE_GROUPS)})
    emit({"phase": phase, "graph_breakdown": out})
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
    every program is K4 (``layer_gemms`` per layer, + lm_head where a
    program samples);
    K5 reads the paged cache in decode, verify (and the draft's k - 1
    decode steps), suffix and chunk prefill; K7 is cold prefill-into-slot
    attention.  encdec (whisper): ``encdec_launches`` of each prefill-into-
    slot and decode step."""
    if cfg.family == "encdec":
        return encdec_launches(cfg, calls["_prefill"], calls["_decode"],
                               "flash_attention_paged")
    L, g = cfg.n_layers, layer_gemms(cfg)
    head = calls["_prefill"] + calls["_prefill_suffix"] + calls["_decode"] \
        + calls["_verify"]
    draft_steps = (spec_k - 1) * calls["_verify"]
    return {"fused_quant_matmul": 0, "block_quantize": 0, "block_matmul": 0,
            "packed_block_matmul": g * L * (head + calls["_prefill_chunk"])
            + head + (g * draft_layers + 1) * draft_steps,
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


# CPU-only references run in child processes beside the card's work (the
# smoke checks' plain-version sides and the continuous runs' compile
# counts): the same code and seeds as in this process, on other cores;
# ``main`` starts every selected phase's children once the kernels are
# built
_CPU_CHILDREN = {}


class CpuChild:
    """``chip_smoke.<func>(*args)`` in a fresh process that sees no card,
    started now; ``result()`` waits for it and returns the JSON it
    prints."""

    def __init__(self, func: str, *args):
        import os
        self.func = func
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", "import json, chip_smoke; print(json."
             f"dumps(chip_smoke.{func}(*{args!r})))"], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def result(self):
        out, err = self.proc.communicate(timeout=900)
        if self.proc.returncode != 0:
            raise AssertionError(f"CPU child {self.func} failed:\n"
                                 f"{err[-3000:]}")
        return json.loads(out.strip().splitlines()[-1])


def cpu_child(func: str, *args) -> CpuChild:
    """The child computing ``func(*args)``, started on first request."""
    key = (func,) + args
    if key not in _CPU_CHILDREN:
        _CPU_CHILDREN[key] = CpuChild(func, *args)
    return _CPU_CHILDREN[key]


def stop_cpu_children() -> None:
    for child in _CPU_CHILDREN.values():
        if child.proc.poll() is None:
            child.proc.kill()
        child.proc.wait()


# serve_continuous's llama2-7b depth: cut 32 -> 16 since phase train_mesh
# joined the script, -> 8 since phase mesh_families did (the draft of run B
# is then 4 layers)
CONT_LAYERS = 8


def continuous_configs() -> dict:
    """Runs A and B's ServeConfigs (llama2-7b's continuous engine)."""
    from repro_torch.serve import ServeConfig
    base = dict(max_slots=8, max_len=512, page_size=16,
                kv_cache_format="nvfp4", decode_chunk=8, eos_id=-1)
    return {"A": ServeConfig(**base, prefix_cache=True, prefill_chunk=64),
            "B": ServeConfig(**base, spec_k=4)}


def continuous_traces(vocab) -> dict:
    return {"A": continuous_requests(vocab),
            "B": continuous_requests(vocab, shared=0)}


def cpu_compile_counts() -> dict:
    """(CPU child) Runs A and B's traces through the smoke-size CPU
    ContinuousEngine (the token ids taken modulo its vocabulary; lengths,
    arrivals and so every signature are the trace's own): each run's
    compile counts and seconds."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.serve import ContinuousEngine
    torch.set_num_threads(2)
    small = get_config("llama2-7b").smoke()
    p_cpu = registry.init_params(small, seed=SEED, device="cpu")
    configs = continuous_configs()
    out = {}
    for name, reqs in continuous_traces(
            get_config("llama2-7b").vocab_size).items():
        t0 = time.perf_counter()
        cpu = ContinuousEngine(small, p_cpu, configs[name], device="cpu")
        cpu.run([dataclasses.replace(r, prompt=r.prompt % small.vocab_size)
                 for r in reqs])
        out[name] = {"compiles": compiles(cpu),
                     "seconds": time.perf_counter() - t0}
    return out


def phase_serve_continuous(dev) -> dict:
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import counters
    from repro_torch.models import registry
    from repro_torch.serve import ContinuousEngine, ServeConfig

    # the CPU references of this phase's compile counts and of phase
    # archs' smoke checks, computed beside the card's work
    cpu_child("cpu_compile_counts")
    cpu_child("archs_smoke_reference")
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

    # (b) llama2-7b at full width, depth CONT_LAYERS: runs A and B through
    # graphed engines (the main path) and the same traces through eager ones
    cfg = dataclasses.replace(get_config("llama2-7b"), n_layers=CONT_LAYERS)
    t0 = time.perf_counter()
    params = registry.init_params(cfg, seed=SEED, device=dev)
    configs = continuous_configs()
    engines = {(name, side): ContinuousEngine(
        cfg, params, sc, device=dev, cuda_graphs=side == "graphs")
        for name, sc in configs.items() for side in ("graphs", "eager")}
    del params
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t0
    runs = continuous_traces(cfg.vocab_size)
    out = {"setup_s": setup_s, "launches": {k: 0 for k in counters.COUNTS}}
    for name in ("A", "B"):
        reqs = runs[name]
        # the compile counts of the smoke-size CPU engine on the same trace
        cpu = cpu_child("cpu_compile_counts").result()[name]
        cpu_compiles, cpu_s = cpu["compiles"], cpu["seconds"]
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


def continuous_run(eng, name, side, reqs, cfg, dev,
                   phase="serve_continuous", extras=None, profile_reqs=None):
    """One timed run of a trace with its checks, then a shorter profiled
    run for the idle share (``profile_reqs``, default 8 requests of
    ``continuous_requests``).  ``extras``: per-rid extras of both runs
    (whisper's frames).  Returns (the run's record, its streams, its
    greedy margins)."""
    import numpy as np
    import torch
    from repro_torch.kernels import counters
    log = ProgramLog(eng)
    start = start_mark(dev)
    counters.reset()
    t0 = time.perf_counter()
    res = eng.run(reqs, extras=extras)
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    launches = counters.snapshot()
    mem = memory_mark(dev)
    calls = dict(log.calls)
    sched, st = eng.scheduler, eng.scheduler.stats
    want = expected_launches(cfg, calls, eng.draft_layers,
                             eng.scfg.spec_k or 0)
    # the program calls as the scheduler's records count them: with the
    # prefix cache or chunked prefill every admission's last prefill chunk
    # (or its whole prompt) is one suffix prefill and the other logged
    # chunks are chunk calls, else each admission is one cold prefill; each
    # tick adds its decode steps, or its one verify under speculation
    scfg = eng.scfg
    warm = scfg.prefix_cache or scfg.prefill_chunk is not None
    sched_calls = ({"_prefill_chunk": len(sched.prefill_log)
                    - st["admitted"], "_prefill_suffix": st["admitted"]}
                   if warm else {"_prefill": st["admitted"]})
    sched_calls["_verify" if eng.spec else "_decode"] = st["decode_steps"]
    summary = eng.metrics.summary()
    ntok = sum(len(v) for v in res.values())
    run_margins = dict(eng.margins)
    margins = np.concatenate([eng.margins[r] for r in res])
    toks = np.concatenate([res[r] for r in res])
    prog_ms = log.ms()
    info = {"phase": phase, "run": name, "side": side,
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
            "kv_pool_bytes": sum(c.nbytes() for c in eng._caches()),
            "compiles": compiles(eng), "programs": program_captures(eng),
            "launches": launches, "expected_launches": want,
            "scheduler_calls": sched_calls,
            "first_tokens": [res[r][:8].tolist() for r in sorted(res)[:4]]}
    # the device idle share, from a second, shorter run (8 other requests)
    # in which the profiler records 8 consecutive decode calls (a tick
    # without speculation) or one verify call (a tick with it) once every
    # request has arrived, and, where admissions prefill cold, the third
    # cold prefill (K7): the profiler's cost stays out of the numbers above
    prog, first, n = ("_verify", 4, 1) if eng.spec else ("_decode", 8, 8)
    log.profile = ((prog, calls[prog] + first, n),) + (
        () if warm else (("_prefill", calls["_prefill"] + 2, 1),))
    eng.run(profile_reqs or continuous_requests(
        cfg.vocab_size, n=8, shared=128 if scfg.prefix_cache else 0,
        max_new=16, seed=SEED + 1), extras=extras)
    missing = [p[0] for p in log.profile if p[0] not in log.breakdown]
    if missing:
        raise AssertionError(f"run {name} {side}: the profiled run made too "
                             f"few {missing} calls")
    info["breakdown"] = log.breakdown[prog]
    if not warm:
        info["prefill_breakdown"] = log.breakdown["_prefill"]
    if launches != want:
        raise AssertionError(f"run {name} {side}: launch counts {launches} "
                             f"!= {want}")
    if any(calls[k] != v for k, v in sched_calls.items()):
        raise AssertionError(f"run {name} {side}: program calls {calls} "
                             f"disagree with the scheduler {sched_calls}")
    if sorted(res) != [r.rid for r in reqs] or \
            any(len(res[r.rid]) != r.max_new for r in reqs):
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


def k1_step_gemms(cfg, qcfg, tokens, remat=True, head_tokens=None,
                  enc_tokens=None) -> dict:
    """{(role, M, K, N, SR on A, SR on B): K1 launches} of one train step,
    from the FQT dispatch rules: for each weight GEMM (K, N) with M tokens
    the forward (again in the remat recompute of a layer), dX = g @ W^T and
    dW = x^T @ g each run K1 when fqt._use_k1 says so.  ``head_tokens``:
    the head's rows where they differ (vlm: the prefix rows are dropped
    before it); ``enc_tokens``: whisper's encoder rows (batch x enc_seq),
    which its cross-attention's wk and wv also take."""
    from repro_torch.core import fqt
    from repro_torch.core.fqt import _if_divisible as div
    from repro_torch.core.fqt import _use_k1

    def upd(spec, M):
        return None if spec is None or M % spec.block else spec

    def sr(*specs):
        return tuple(bool(sp.stochastic) for sp in specs)

    out = {}

    def add(key, n):
        out[key] = out.get(key, 0) + n

    def gemm(K, N, qc, times, fwd_times, M=tokens):
        a, w = div(qc.fwd_a, K), div(qc.fwd_w, K)
        if _use_k1(a, w, K):
            add(("fwd", M, K, N) + sr(a, w), fwd_times)
        g, wt = div(qc.bwd_g, N), div(qc.bwd_w, N)
        if _use_k1(g, wt, N):
            add(("dX", M, N, K) + sr(g, wt), times)
        ua, ug = upd(qc.upd_a, M), upd(qc.upd_g, M)
        if _use_k1(ua, ug, M):
            add(("dW", K, M, N) + sr(ua, ug), times)

    d, f = cfg.d_model, cfg.d_ff
    qd, kv = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    L, fwd = cfg.n_layers, 2 if remat else 1
    head = qcfg if cfg.quantize_lm_head else fqt.QuantConfig()
    if cfg.family == "encdec":
        E, Me = cfg.enc_layers, enc_tokens
        for K, N in ((d, qd), (d, kv), (d, kv), (qd, d), (d, f), (f, d)):
            gemm(K, N, qcfg, E, E * fwd, Me)
        for K, N, M in ((d, qd, tokens), (d, kv, tokens), (d, kv, tokens),
                        (qd, d, tokens), (d, qd, tokens), (d, kv, Me),
                        (d, kv, Me), (qd, d, tokens), (d, f, tokens),
                        (f, d, tokens)):
            gemm(K, N, qcfg, L, L * fwd, M)
        gemm(d, cfg.padded_vocab, head, 1, 1)
        return out
    if cfg.family in ("hybrid", "ssm"):
        for K, N, n, rematted in recurrent_gemms(cfg):
            gemm(K, N, qcfg, n, n * (fwd if rematted else 1))
        gemm(d, cfg.padded_vocab, head, 1, 1)
        return out
    for K, N in ((d, qd), (d, kv), (d, kv), (qd, d)):
        gemm(K, N, qcfg, L, L * fwd)
    if cfg.n_experts:
        # each expert's GEMMs run on its capacity rows of every group
        from repro_torch.models.moe import _capacity
        G = cfg.moe_groups if (cfg.moe_groups
                               and tokens % cfg.moe_groups == 0) else 1
        M, E = G * _capacity(tokens // G, cfg), cfg.n_experts
        for K, N in ((d, f), (d, f), (f, d)):
            gemm(K, N, qcfg, L * E, L * E * fwd, M)
    else:
        for K, N in ((d, f), (d, f), (f, d)):
            gemm(K, N, qcfg, L, L * fwd)
    gemm(d, cfg.padded_vocab, head, 1, 1, head_tokens or tokens)
    return out


def recurrent_gemms(cfg) -> list:
    """(K, N, GEMMs a forward pass, rematerialised) of the hybrid and ssm
    families' weight GEMMs, the lm_head aside.  zamba2: each Mamba layer's
    in_proj and out_proj (under remat), the shared block's seven at each of
    its applications (not rematerialised, as in the reference); xLSTM: an
    mLSTM block's w_up, w_q, w_k, w_v, w_down and an sLSTM block's w_gates,
    w_ff_gate, w_ff_up, w_ff_down (w_if and r_gates are ``dense_hp``: no
    GEMM kernel)."""
    d, L = cfg.d_model, cfg.n_layers
    if cfg.family == "hybrid":
        from repro_torch.models import mamba2
        di, H, P, N = mamba2.mamba_dims(cfg)
        A, f = mamba2.n_attn(cfg), cfg.d_ff
        qd, kv = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
        return [(d, 2 * di + 2 * N + H, L, True), (di, d, L, True)] + [
            (K, N, A, False) for K, N in ((d, qd), (d, kv), (d, kv), (qd, d),
                                          (d, f), (d, f), (f, d))]
    from repro_torch.models import xlstm
    di = xlstm._dims(cfg)[0]
    f = int(cfg.proj_factor * d)
    Ls = sum(xlstm.is_slstm(cfg, i) for i in range(L))
    Lm = L - Ls
    return [(K, N, Lm, True) for K, N in ((d, 2 * di), (di, di), (di, di),
                                          (di, di), (di, d))] + [
        (K, N, Ls, True) for K, N in ((d, 4 * d), (d, f), (d, f), (f, d))]


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


def layer_gemms(cfg) -> int:
    """Weight GEMMs of one layer's forward: wq, wk, wv, wo and the MLP's
    three, or each expert's three (a moe layer runs every expert on its
    capacity rows, empty or not)."""
    return 4 + 3 * (cfg.n_experts or 1)


def lockstep_launches(cfg, steps) -> dict:
    """Each kernel's launches of one lockstep generate of ``steps`` decode
    steps: K4 for every GEMM (``layer_gemms`` a layer + lm_head) of the
    prefill and of each step, K7 once a layer in the prefill, K6 once a
    layer a step."""
    gemms = layer_gemms(cfg) * cfg.n_layers + 1
    return {"fused_quant_matmul": 0, "block_quantize": 0, "block_matmul": 0,
            "packed_block_matmul": gemms * (1 + steps),
            "flash_attention_paged": 0,
            "flash_attention": cfg.n_layers,
            "flash_attention_packed": cfg.n_layers * steps}


def recurrent_launches(cfg, prompt_len, steps) -> dict:
    """Each kernel's launches of one lockstep generate of a recurrent
    family: its prefill is one decode step per prompt token, so every one
    of the ``prompt_len + steps`` steps launches K4 for each weight GEMM
    (``recurrent_gemms``' forward count) and the lm_head, and K6 once for
    each application of zamba2's shared block; no K7."""
    from repro_torch.models import mamba2
    gemms = sum(n for _, _, n, _ in recurrent_gemms(cfg)) + 1
    n_attn = mamba2.n_attn(cfg) if cfg.family == "hybrid" else 0
    calls = prompt_len + steps
    return {"fused_quant_matmul": 0, "block_quantize": 0, "block_matmul": 0,
            "packed_block_matmul": gemms * calls,
            "flash_attention_paged": 0, "flash_attention": 0,
            "flash_attention_packed": n_attn * calls}


def encdec_launches(cfg, prefills, steps,
                    decode_attn="flash_attention_packed") -> dict:
    """Each kernel's launches of whisper's serving programs: a prefill
    (lockstep, or one slot's) runs the encoder (K4 at wq, wk, wv, wo,
    w_in, w_out and K7 a layer) and the decoder (K4 at its ten GEMMs --
    self-attention, cross-attention, MLP -- and K7 for the self- and the
    cross-attention a layer); a decode step the decoder's ten K4, its
    self-attention read (K6 in lockstep, ``decode_attn``: K5 over the paged
    pool) and K7 for the cross-attention a layer.  Each program's tied head
    is K1 (``embed`` is no packed leaf)."""
    E, L = cfg.enc_layers, cfg.n_layers
    out = {"fused_quant_matmul": prefills + steps, "block_quantize": 0,
           "block_matmul": 0,
           "packed_block_matmul": (6 * E + 10 * L) * prefills
           + 10 * L * steps,
           "flash_attention_paged": 0, "flash_attention_packed": 0,
           "flash_attention": (E + 2 * L) * prefills + L * steps}
    out[decode_attn] = L * steps
    return out


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

        def restore(d, step, like, **kw):
            t0 = time.perf_counter()
            out = self._restore(d, step, like, **kw)
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


# ---- archs: the dense and moe families at full width ------------------------

# the smoke configs held card (graphs) vs CPU in phase archs, and the lockstep
# prompt length of each (Mixtral's past its 64-token window: the buffer rolls)
ARCH_SMOKE = ("codeqwen1.5-7b", "qwen2.5-32b", "mixtral-8x7b",
              "qwen3-moe-235b-a22b")
QWEN3_LAYERS = 4          # qwen3-moe-235b-a22b: depth cut 94 -> 4 (run d)
MOE_TRAIN_LAYERS = 2      # Mixtral training: depth cut 32 -> 2 (run e)
# serving depth cuts that keep the whole script inside its time limit since
# phase recurrent joined it (16 and 8), halved again since phase
# mesh_families joined: qwen2.5-32b 64 -> 8 layers (run b), Mixtral 32 -> 4
# (runs c, c long, c continuous); the rest of the archs at full depth
QWEN25_LAYERS = 8
MIXTRAL_LAYERS = 4


def packed_init(cfg, dev, phase="archs") -> tuple:
    """The serving tree of a random init, built by the streaming packer
    (``packing.init_packed_params``: one layer at a time), with its
    seconds, bytes and the peak device memory of the build."""
    import gc
    import torch
    from repro_torch.core import fqt
    from repro_torch.serve import packing
    gc.collect()
    torch.cuda.empty_cache()
    start = start_mark(dev)
    t0 = time.perf_counter()
    params = packing.init_packed_params(cfg, gen(dev, SEED),
                                        fqt.qaf_config().fwd_w, device=dev)
    torch.cuda.synchronize(dev)
    info = {"init_s": time.perf_counter() - t0,
            "weight_store_bytes": packing.weight_store_bytes(params),
            **start, "init_peak_mem_bytes":
                torch.cuda.max_memory_allocated(dev)}
    emit({"phase": phase, "arch": cfg.name, "n_layers": cfg.n_layers,
          "packed_init": info})
    return params, info


def archs_smoke_case(arch):
    """(smoke config, prompts, lockstep ServeConfig, continuous ServeConfig
    or None, requests, continuous fields) of one arch's smoke check."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.serve import ServeConfig
    small = get_config(arch).smoke()
    rng = np.random.default_rng(SEED)
    plen = 80 if small.sliding_window else 16
    prompts = [rng.integers(0, small.vocab_size, plen) for _ in range(4)]
    scfg = ServeConfig(batch_size=4, max_len=128, kv_cache_format="nvfp4",
                       eos_id=-1)
    if not small.n_experts:
        return small, prompts, scfg, None, None, None
    extra = (dict(prefix_cache=True, prefill_chunk=16, spec_k=4,
                  draft_layers=1) if small.sliding_window is None else {})
    cs = ServeConfig(max_slots=4, max_len=128, page_size=16, decode_chunk=4,
                     eos_id=-1, **extra)
    reqs = continuous_requests(small.vocab_size, n=6,
                               shared=32 if extra else 0,
                               lens=(8, 40) if extra else (30, 60),
                               max_new=12)
    return small, prompts, scfg, cs, reqs, extra


def archs_smoke_reference() -> dict:
    """(CPU child) The plain versions' side of ``archs_smoke`` for every
    ARCH_SMOKE arch: the lockstep streams and margins; for the moe pair,
    each of two continuous runs' streams, margins and compile counts."""
    import numpy as np
    import torch
    from repro_torch.models import registry
    from repro_torch.serve import ContinuousEngine, Engine
    torch.set_num_threads(2)
    out = {}
    for arch in ARCH_SMOKE:
        small, prompts, scfg, cs, reqs, _ = archs_smoke_case(arch)
        p_cpu = registry.init_params(small, seed=SEED, device="cpu")
        ref = Engine(small, p_cpu, scfg, device="cpu")
        r = {"lockstep": [o.tolist() for o in ref.generate(prompts,
                                                             max_new=16)],
             "margins": np.asarray(ref.margins).tolist(), "continuous": []}
        if cs is not None:
            ref = ContinuousEngine(small, p_cpu, cs, device="cpu")
            for _ in range(2):
                want = ref.run(reqs)
                r["continuous"].append({
                    "streams": {str(k): v.tolist() for k, v in want.items()},
                    "margins": {str(k): np.asarray(ref.margins[k]).tolist()
                                for k in want},
                    "compiles": compiles(ref)})
        out[arch] = r
    return out


def archs_smoke(dev) -> list:
    """Each arch's smoke config through the graphed engines on the card and
    the same engines on the CPU's plain versions (``archs_smoke_reference``,
    in a CPU child): lockstep (two generates) for every arch, continuous
    batching for the moe pair (Mixtral's window rolling, Qwen3 with the
    prefix cache, chunked prefill and verify-k); streams equal (or first
    apart at a near-tie) and compile counts equal."""
    from repro_torch.models import registry
    from repro_torch.serve import ContinuousEngine, Engine
    refs = cpu_child("archs_smoke_reference").result()
    rows = []
    for arch in ARCH_SMOKE:
        small, prompts, scfg, cs, reqs, extra = archs_smoke_case(arch)
        want = refs[arch]
        p_cpu = registry.init_params(small, seed=SEED, device="cpu")
        eng = Engine(small, p_cpu, scfg, device=dev)
        for rep in range(2):
            out = eng.generate(prompts, max_new=16)
            checks = [_first_divergence_ok(a.tolist(), b, m)
                      for a, b, m in zip(out, want["lockstep"],
                                         want["margins"])]
            row = {"phase": "archs", "check": "smoke-size lockstep card "
                   "(graphs) vs CPU plain", "arch": arch, "generate": rep,
                   "prompt_len": len(prompts[0]),
                   "streams_ok": [c[0] for c in checks],
                   "first_divergence": [c[1] for c in checks]}
            emit(row)
            rows.append(row)
            if not all(c[0] for c in checks):
                raise AssertionError(f"{arch}: card and CPU streams differ "
                                     f"at a decisive step")
        if cs is None:
            continue
        eng = ContinuousEngine(small, p_cpu, cs, device=dev)
        for rep, ref in enumerate(want["continuous"]):
            card = {str(k): v for k, v in eng.run(reqs).items()}
            checks = {r: _first_divergence_ok(card[r].tolist(),
                                              ref["streams"][r],
                                              ref["margins"][r])
                      for r in ref["streams"]}
            row = {"phase": "archs", "check": "smoke-size continuous card "
                   "(graphs) vs CPU plain", "arch": arch, "run": rep,
                   "config": extra,
                   "streams_ok": [c[0] for c in checks.values()],
                   "first_divergence": [c[1] for c in checks.values()],
                   "compiles_card": compiles(eng),
                   "compiles_cpu": ref["compiles"]}
            emit(row)
            rows.append(row)
            if sorted(card) != sorted(ref["streams"]) or \
                    not all(c[0] for c in checks.values()):
                raise AssertionError(f"{arch}: continuous card and CPU "
                                     f"streams differ at a decisive step")
            if compiles(eng) != ref["compiles"]:
                raise AssertionError(f"{arch}: compile counts differ")
    return rows


def archs_lockstep(label, cfg, params, dev, batch, prompt_len, max_new,
                   max_len, phase="archs", extras=None) -> dict:
    """One lockstep run through a graphed Engine (the main path) and the
    same prompts through an eager one: streams equal, launches as
    ``lockstep_launches`` (``recurrent_launches`` for the recurrent
    families, ``encdec_launches`` for whisper) derives them on both sides,
    tokens in the vocabulary and finite margins; then the graphed engine's
    prefill and decode-step times and a profiled generate's idle share.
    ``extras``: the generate's (whisper's frames, InternVL2's prefix)."""
    import gc
    import numpy as np
    import torch
    from repro_torch.kernels import counters
    from repro_torch.serve import Engine, ServeConfig
    scfg = ServeConfig(batch_size=batch, max_len=max_len,
                       kv_cache_format="nvfp4", eos_id=-1)
    engines = {"graphs": Engine(cfg, params, scfg, device=dev),
               "eager": Engine(cfg, params, scfg, device=dev,
                               cuda_graphs=False)}
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, prompt_len)
               for _ in range(batch)]
    for side, eng in engines.items():       # warm-up: run, capture, replay
        for _ in range(2 if side == "graphs" else 1):
            eng.generate(prompts, max_new=2, extras=extras)
    torch.cuda.synchronize(dev)
    sides, outs = {}, {}
    for side, eng in engines.items():
        start = start_mark(dev)
        counters.reset()
        t0 = time.perf_counter()
        out = eng.generate(prompts, max_new=max_new, extras=extras)
        torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        launches = counters.snapshot()
        recurrent = cfg.family in ("hybrid", "ssm")
        want = (recurrent_launches(cfg, prompt_len, eng.steps) if recurrent
                else encdec_launches(cfg, 1, eng.steps)
                if cfg.family == "encdec"
                else lockstep_launches(cfg, eng.steps))
        margins = np.asarray(eng.margins)
        ntok = sum(len(o) for o in out)
        caches = (eng._carry[1] if isinstance(eng._carry, tuple) else
                  [] if recurrent else eng._carry)
        info = {"phase": phase, "run": label, "side": side,
                "arch": cfg.name, "n_layers": cfg.n_layers, "batch": batch,
                "prompt_len": prompt_len, "max_new": max_new,
                "max_len": max_len,
                "kv_buffer": caches[0].buf if caches else None,
                "rolling": cfg.sliding_window is not None
                and prompt_len + max_new > caches[0].buf,
                "decode_steps": eng.steps, "tokens": ntok, "seconds": dt,
                "tokens_per_s": ntok / dt, **start, **memory_mark(dev),
                "first_tokens": [o[:8].tolist() for o in out],
                "programs": program_captures(eng), "launches": launches,
                "expected_launches": want}
        emit(info)
        if launches != want:
            raise AssertionError(f"{label} {side}: launch counts {launches} "
                                 f"!= {want}")
        if len(out) != batch or any(len(o) != max_new for o in out):
            raise AssertionError(f"{label} {side}: wrong output shape")
        if any(((o < 0) | (o >= cfg.vocab_size)).any() for o in out):
            raise AssertionError("token id outside the vocabulary")
        if not np.isfinite(margins).all():
            raise AssertionError("non-finite logits")
        sides[side], outs[side] = info, (out, margins)
    same = all(np.array_equal(a, b) for a, b in zip(outs["graphs"][0],
                                                    outs["eager"][0]))
    margin_diff = float(np.max(np.abs(outs["graphs"][1] - outs["eager"][1])))
    emit({"phase": phase, "run": label, "check": "graphs vs eager",
          "streams_equal": same, "max_abs_margin_diff": margin_diff})
    if not same:
        raise AssertionError(f"{label}: graphed and eager streams differ")
    del engines["eager"]
    gc.collect()
    torch.cuda.empty_cache()
    info = dict(sides["graphs"])
    info["eager"] = sides["eager"]
    info["streams_equal"], info["max_abs_margin_diff"] = same, margin_diff
    info["graph_breakdown"] = graph_breakdown(engines["graphs"], prompts, dev,
                                              phase=phase, extras=extras)
    return info


def archs_continuous(label, cfg, params, dev, reqs, **fields) -> dict:
    """One continuous-batching run through a graphed ContinuousEngine:
    ``continuous_run``'s checks (launches from the program calls, program
    calls from the scheduler, outputs) and its profiled tick."""
    import gc
    import torch
    from repro_torch.serve import ContinuousEngine, ServeConfig
    scfg = ServeConfig(max_slots=8, max_len=512, page_size=16,
                       kv_cache_format="nvfp4", decode_chunk=8, eos_id=-1,
                       **fields)
    eng = ContinuousEngine(cfg, params, scfg, device=dev)
    info, _, _ = continuous_run(eng, label, "graphs", reqs, cfg, dev,
                                phase="archs")
    info["n_layers"] = cfg.n_layers
    emit(info)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return info


def archs_train(dev, seq=1024, steps=3) -> dict:
    """Mixtral at full width, depth cut to MOE_TRAIN_LAYERS, through
    ``Trainer``: batch 1 x seq, nvfp4_paper_config, remat, the sigma_q
    probe.  Every step launches K1 as ``k1_step_gemms`` derives it (the
    experts' GEMMs on their capacity rows) and K2 once per probe leaf;
    loss and nll finite with loss > nll (the router's aux term)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import fqt, qaf
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import counters
    from repro_torch.train import TrainConfig, Trainer, TrainerConfig
    full = get_config("mixtral-8x7b")
    cfg = dataclasses.replace(full, n_layers=MOE_TRAIN_LAYERS)
    qcfg, tcfg = fqt.nvfp4_paper_config(), TrainConfig(remat=True)
    per_step = sum(k1_step_gemms(cfg, qcfg, seq).values())
    trainer = Trainer(cfg, qcfg, tcfg, TrainerConfig(
        total_steps=steps, log_every=1, qaf=qaf.QAFConfig(enabled=False)),
        DataConfig(cfg.vocab_size, seq, 1), device=dev)
    marks = count_steps(trainer)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    counters.reset()
    t0 = time.perf_counter()
    state = trainer.run()
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    marks.append(counters.snapshot())
    per = step_launches(marks)
    leaves = len(probe_leaf_ids(state.params, probe_spec_of(tcfg)))
    hist = trainer.history
    timed = [h["dt"] * 1e3 for h in hist[1:]]
    info = {"phase": "archs", "run": "e", "arch": full.name, "cut": {
        "n_layers": [full.n_layers, MOE_TRAIN_LAYERS]}, "batch": 1,
            "seq": seq, "steps": steps, "quant": "nvfp4_paper_config",
            "remat": True, "seconds": wall,
            "step_ms": [h["dt"] * 1e3 for h in hist],
            "step_ms_median": statistics.median(timed),
            "tokens_per_s": seq / (statistics.median(timed) / 1e3),
            "loss": [h["loss"] for h in hist], "nll": [h["nll"] for h in hist],
            "grad_norm": [h["grad_norm"] for h in hist],
            "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
            "k1_launches_per_step_expected": per_step,
            "probe_leaves": leaves, "launches_per_step": per}
    emit(info)
    for i, (h, n) in enumerate(zip(hist, per)):
        if n["fused_quant_matmul"] != per_step or \
                n["block_quantize"] != leaves:
            raise AssertionError(f"step {i}: launches {n}, expected "
                                 f"{per_step} K1 and {leaves} K2")
        if not all(math.isfinite(h[k]) for k in ("loss", "nll",
                                                 "grad_norm")):
            raise AssertionError(f"non-finite metrics at step {i}")
        if not h["loss"] > h["nll"]:
            raise AssertionError(f"step {i}: loss {h['loss']} <= nll "
                                 f"{h['nll']}: no aux term")
    info["card_loss"] = card_loss_check(state.params, cfg, qcfg, seq, dev)
    emit({"phase": "archs", "run": "e", "card_loss": info["card_loss"]})
    del state, trainer
    return info


def card_loss_check(params, cfg, qcfg, seq, dev) -> dict:
    """The card's loss (``refnum.torch_nll``, torch's log_softmax backward)
    against the reference's order (``refnum.MeanNLL``, held to JAX bit for
    bit on the CPU) on one batch's logits on the card: the same value, and
    logit gradients at most one ulp of the logits' dtype (bf16) apart."""
    import torch
    from repro_torch.models import refnum, registry
    toks = torch.randint(0, cfg.vocab_size, (1, seq + 1), device=dev,
                         generator=gen(dev, SEED))
    with torch.no_grad():
        logits, _ = registry.forward(params, cfg, qcfg,
                                     {"tokens": toks[:, :-1]}, seed=5)
    out = []
    for nll in (refnum.MeanNLL.apply, refnum.torch_nll):
        x = logits.detach().clone().requires_grad_(True)
        loss = nll(x, toks[:, 1:])
        loss.backward()
        out.append((loss.detach(), x.grad))
    (want, gw), (got, gg) = out
    itype = {2: torch.int16, 4: torch.int32}[gg.element_size()]
    bits = [torch.where(g == 0, 0, g.view(itype).long()) for g in (gg, gw)]
    ulps = (bits[0] - bits[1]).abs()
    info = {"loss": float(got), "loss_reference_order": float(want),
            "max_ulps": int(ulps.max()),
            "differing": int((ulps > 0).sum()), "logits": ulps.numel(),
            "dtype": str(logits.dtype)}
    if not torch.equal(got, want) or info["max_ulps"] > 1:
        raise AssertionError(f"card loss vs reference order: {info}")
    return info


def phase_archs(dev) -> dict:
    """The dense and moe archs at full width on one card: runs a-e (b and
    c at QWEN25_LAYERS and MIXTRAL_LAYERS)."""
    import gc
    import torch
    from repro_torch.configs import get_config
    out = {"smoke": archs_smoke(dev), "launches": {}}

    def add(info):
        for k, v in info["launches"].items():
            out["launches"][k] = out["launches"].get(k, 0) + v

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # a: codeqwen1.5-7b, full depth: lockstep, then run A's traffic
    cfg = get_config("codeqwen1.5-7b")
    params, build = packed_init(cfg, dev)
    out["a"] = {"build": build, "lockstep": archs_lockstep(
        "a", cfg, params, dev, 4, 64, 32, 256)}
    out["a"]["continuous"] = archs_continuous(
        "a continuous", cfg, params, dev, continuous_requests(cfg.vocab_size),
        prefix_cache=True, prefill_chunk=64)
    add(out["a"]["lockstep"])
    add(out["a"]["continuous"])
    del params
    free()
    # b: qwen2.5-32b at full width, depth cut to QWEN25_LAYERS
    full = get_config("qwen2.5-32b")
    cfg = dataclasses.replace(full, n_layers=QWEN25_LAYERS)
    params, build = packed_init(cfg, dev)
    out["b"] = {"build": build, "cut": {"n_layers": [full.n_layers,
                                                     QWEN25_LAYERS]},
                "lockstep": archs_lockstep("b", cfg, params, dev, 4, 64, 16,
                                           256)}
    add(out["b"]["lockstep"])
    del params
    free()
    # c: mixtral-8x7b at full width, depth cut to MIXTRAL_LAYERS: batch 4;
    # one request past the window (the 4096-row buffer rolls in the prefill
    # and every step); 8 requests over the paged pool (no prefix cache or
    # spec: the window refuses both)
    full = get_config("mixtral-8x7b")
    cfg = dataclasses.replace(full, n_layers=MIXTRAL_LAYERS)
    params, build = packed_init(cfg, dev)
    out["c"] = {"build": build, "cut": {"n_layers": [full.n_layers,
                                                     MIXTRAL_LAYERS]},
                "lockstep": archs_lockstep("c", cfg, params, dev, 4, 64, 32,
                                           256)}
    out["c"]["long"] = archs_lockstep("c long", cfg, params, dev, 1, 4160,
                                      64, 4352)
    out["c"]["continuous"] = archs_continuous(
        "c continuous", cfg, params, dev,
        continuous_requests(cfg.vocab_size, n=8, shared=0))
    for k in ("lockstep", "long", "continuous"):
        add(out["c"][k])
    del params
    free()
    # d: qwen3-moe-235b-a22b, depth cut to QWEN3_LAYERS: prefix cache,
    # 64-token chunks, verify-k 4 with a 2-layer self-draft
    full = get_config("qwen3-moe-235b-a22b")
    cfg = dataclasses.replace(full, n_layers=QWEN3_LAYERS)
    params, build = packed_init(cfg, dev)
    out["d"] = {"build": build, "cut": {"n_layers": [full.n_layers,
                                                     QWEN3_LAYERS]},
                "continuous": archs_continuous(
                    "d continuous", cfg, params, dev,
                    continuous_requests(cfg.vocab_size), prefix_cache=True,
                    prefill_chunk=64, spec_k=4, draft_layers=2)}
    add(out["d"]["continuous"])
    del params
    free()
    # e: Mixtral training, depth cut to MOE_TRAIN_LAYERS
    out["e"] = archs_train(dev)
    for step in out["e"]["launches_per_step"]:
        add({"launches": step})
    emit({"phase": "archs", "launches_main_path": out["launches"]})
    return out


RECURRENT_ARCHS = ("zamba2-1.2b", "xlstm-125m")
# training at full depth and width: (batch, seq) of each family.  xLSTM's
# sLSTM blocks run a Python loop over the tokens (forward, remat recompute
# and backward), so its sequence sets its step time
RECURRENT_TRAIN = {"zamba2-1.2b": (4, 1024), "xlstm-125m": (4, 256)}
# depth cut since phase mesh_families joined the script, to keep it inside
# its time limit (full width; every block kind stays: zamba2's shared block
# after every 6 Mamba2 layers, xLSTM's sLSTM every 4th block)
RECURRENT_LAYERS = {"zamba2-1.2b": 19, "xlstm-125m": 6}


def recurrent_cfg(arch):
    """``arch``'s config, a recurrent arch's depth cut to RECURRENT_LAYERS."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if arch in RECURRENT_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=RECURRENT_LAYERS[arch])
    return cfg


def recurrent_smoke(dev) -> list:
    """Each recurrent arch's smoke config through a graphed Engine on the
    card (two generates: the second replays both programs) and the same
    Engine on the CPU's plain versions: streams equal, or first apart at a
    near-tie."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.serve import Engine, ServeConfig
    rows = []
    for arch in RECURRENT_ARCHS:
        small = get_config(arch).smoke()
        p_cpu = registry.init_params(small, seed=SEED, device="cpu")
        rng = np.random.default_rng(SEED)
        prompts = [rng.integers(0, small.vocab_size, 16) for _ in range(4)]
        scfg = ServeConfig(batch_size=4, max_len=64, kv_cache_format="nvfp4",
                           eos_id=-1)
        ref = Engine(small, p_cpu, scfg, device="cpu")
        out_ref = ref.generate(prompts, max_new=16)
        eng = Engine(small, p_cpu, scfg, device=dev)
        for rep in range(2):
            out = eng.generate(prompts, max_new=16)
            checks = [_first_divergence_ok(a.tolist(), b.tolist(), m)
                      for a, b, m in zip(out, out_ref, ref.margins)]
            row = {"phase": "recurrent", "check": "smoke-size lockstep card "
                   "(graphs) vs CPU plain", "arch": arch, "generate": rep,
                   "streams_ok": [c[0] for c in checks],
                   "first_divergence": [c[1] for c in checks],
                   "max_abs_margin_diff": float(np.max(np.abs(
                       np.asarray(eng.margins) - np.asarray(ref.margins))))}
            emit(row)
            rows.append(row)
            if not all(c[0] for c in checks):
                raise AssertionError(f"{arch}: card and CPU streams differ "
                                     f"at a decisive step")
    return rows


def trainer_run(dev, arch, steps=3, phase="recurrent",
                    shape=None) -> dict:
    """One arch at full width and depth through ``Trainer``:
    nvfp4_paper_config, remat, AdamW, the sigma_q probe; (batch, seq) from
    ``shape`` or RECURRENT_TRAIN.  Every step launches K1 as
    ``k1_step_gemms`` derives it and K2 once per probe leaf; loss, nll and
    grad norm finite.  Returns the info and the final state."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import fqt, qaf
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import counters
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import TrainConfig, Trainer, TrainerConfig
    cfg = recurrent_cfg(arch)
    batch, seq = shape or RECURRENT_TRAIN[arch]
    qcfg, tcfg = fqt.nvfp4_paper_config(), TrainConfig(remat=True)
    per_step = sum(k1_step_gemms(cfg, qcfg, batch * seq,
                                 enc_tokens=batch * cfg.enc_seq).values())
    trainer = Trainer(cfg, qcfg, tcfg, TrainerConfig(
        total_steps=steps, log_every=1, qaf=qaf.QAFConfig(enabled=False)),
        DataConfig(cfg.vocab_size, seq, batch), device=dev)
    marks = count_steps(trainer)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    counters.reset()
    t0 = time.perf_counter()
    state = trainer.run()
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    marks.append(counters.snapshot())
    per = step_launches(marks)
    leaves = len(probe_leaf_ids(state.params, probe_spec_of(tcfg)))
    hist = trainer.history
    timed = [h["dt"] * 1e3 for h in hist[1:]]
    info = {"phase": phase, "run": "train", "arch": arch,
            "n_layers": cfg.n_layers, "n_params": sum(
                p.numel() for p in tree_leaves(state.params)),
            "batch": batch, "seq": seq, "steps": steps,
            "quant": "nvfp4_paper_config", "remat": True, "seconds": wall,
            "step_ms": [h["dt"] * 1e3 for h in hist],
            "step_ms_median": statistics.median(timed),
            "tokens_per_s": batch * seq / (statistics.median(timed) / 1e3),
            "loss": [h["loss"] for h in hist], "nll": [h["nll"] for h in hist],
            "grad_norm": [h["grad_norm"] for h in hist],
            "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
            "k1_launches_per_step_expected": per_step,
            "probe_leaves": leaves, "launches_per_step": per}
    emit(info)
    for i, (h, n) in enumerate(zip(hist, per)):
        if n["fused_quant_matmul"] != per_step or \
                n["block_quantize"] != leaves:
            raise AssertionError(f"{arch} step {i}: launches {n}, expected "
                                 f"{per_step} K1 and {leaves} K2")
        if not all(math.isfinite(h[k]) for k in ("loss", "nll",
                                                 "grad_norm")):
            raise AssertionError(f"{arch}: non-finite metrics at step {i}")
    return info, state


def ckpt_roundtrip(dev, label, tree, phase="recurrent") -> dict:
    """``checkpoint.ckpt`` save and restore of one tree under build/: seconds,
    bytes, and the reference leaves whose bits differ (must be none)."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import ckpt
    (ROOT / "build").mkdir(exist_ok=True)
    d = tempfile.mkdtemp(prefix=f"{phase}_ckpt_", dir=ROOT / "build")
    try:
        t0 = time.perf_counter()
        path = ckpt.save(d, 3, tree)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = ckpt.restore(d, 3, tree)
        restore_s = time.perf_counter() - t0
        info = {"phase": phase, "check": "checkpoint save/restore",
                "tree": label, "leaves": len(ckpt.reference_leaves(tree)),
                "bytes": dir_bytes(path), "save_s": save_s,
                "restore_s": restore_s,
                "differing_leaves": differing_leaves(back, tree)}
        emit(info)
        del back
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if info["differing_leaves"]:
        raise AssertionError(f"{label}: restored leaves differ: "
                             f"{info['differing_leaves']}")
    return info


def phase_recurrent(dev) -> dict:
    """The hybrid (zamba2-1.2b) and ssm (xlstm-125m) families at full width
    and depth: smoke configs card vs CPU; each served in lockstep from
    packed weights (graphed and eager); each trained through ``Trainer``;
    a checkpoint of each family's tree saved and restored."""
    import gc
    import torch
    from repro_torch.configs import get_config
    out = {"smoke": recurrent_smoke(dev), "launches": {}}

    def add(launches):
        for k, v in launches.items():
            out["launches"][k] = out["launches"].get(k, 0) + v

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    for arch in RECURRENT_ARCHS:
        cfg = recurrent_cfg(arch)
        params, build = packed_init(cfg, dev, phase="recurrent")
        out[arch] = {"build": build, "lockstep": archs_lockstep(
            arch, cfg, params, dev, 4, 64, 32, 256, phase="recurrent")}
        add(out[arch]["lockstep"]["launches"])
        del params
        free()
    for arch in RECURRENT_ARCHS:
        info, state = trainer_run(dev, arch)
        for step in info["launches_per_step"]:
            add(step)
        # zamba2: its bf16 parameters (the whole TrainState is ~17 GB);
        # xLSTM: the whole TrainState (params, f32 master, m, v)
        tree = state.params if arch.startswith("zamba2") else state
        info["ckpt"] = ckpt_roundtrip(dev, f"{arch} "
                                      + ("params" if tree is state.params
                                         else "TrainState"), tree)
        out[arch]["train"] = info
        del state, tree
        free()
    emit({"phase": "recurrent", "launches_main_path": out["launches"]})
    return out


ENCDEC_ARCHS = ("whisper-base", "internvl2-26b")
# run c's depth: cut 48 -> 24 since phase mesh_families joined the script
VLM_SERVE_LAYERS = 24
# whisper's continuous engine (run b): 4 slots over a 128-token slot buffer
ENCDEC_CONT = dict(max_slots=4, max_len=128, page_size=16,
                   kv_cache_format="nvfp4", decode_chunk=8, eos_id=-1)
VLM_TRAIN_LAYERS = 2      # internvl2-26b training: depth cut 48 -> 2 (run d)
ENCDEC_REQUESTS = 8       # run b's trace


def encdec_extras(cfg, batch, dev, seed=SEED) -> dict:
    """The stub frontends' random inputs, bf16 from a seeded generator on
    ``dev``: whisper's frames (batch, enc_seq, d), InternVL2's prefix
    (batch, vision_tokens, d)."""
    import torch
    if cfg.family == "encdec":
        key, rows = "frames", cfg.enc_seq
    else:
        key, rows = "prefix_embeds", cfg.vision_tokens
    return {key: torch.randn((batch, rows, cfg.d_model), generator=gen(
        dev, seed), device=dev).to(torch.bfloat16)}


def encdec_smoke_case(arch) -> tuple:
    """(smoke config, prompts, extras on the CPU, lockstep ServeConfig) of
    one arch's smoke check; whisper's continuous check adds (requests,
    per-rid frames)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.serve import ServeConfig
    small = get_config(arch).smoke()
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, small.vocab_size, 16) for _ in range(4)]
    scfg = ServeConfig(batch_size=4, max_len=128, kv_cache_format="nvfp4",
                       eos_id=-1)
    reqs = continuous_requests(small.vocab_size, n=6, shared=0, lens=(8, 40),
                               max_new=12)
    frames = {r.rid: encdec_extras(small, 1, "cpu", SEED + 1 + r.rid)[
        "frames"] for r in reqs} if small.family == "encdec" else None
    return (small, prompts, encdec_extras(small, 4, "cpu"), scfg, reqs,
            frames)


def encdec_smoke_reference() -> dict:
    """(CPU child) The plain versions' side of ``encdec_smoke``: each
    arch's forward logits (qaf_config, with its extras), lockstep streams
    and margins; whisper's continuous streams, margins and compile counts
    over two runs on one engine."""
    import numpy as np
    import torch
    from repro_torch.core import fqt
    from repro_torch.models import registry
    from repro_torch.serve import ContinuousEngine, Engine
    torch.set_num_threads(2)
    out = {}
    for arch in ENCDEC_ARCHS:
        small, prompts, extras, scfg, reqs, frames = encdec_smoke_case(arch)
        p_cpu = registry.init_params(small, seed=SEED, device="cpu")
        toks = torch.from_numpy(np.stack(prompts)).long()
        with torch.no_grad():
            logits, _ = registry.forward(p_cpu, small, fqt.qaf_config(),
                                         dict(extras, tokens=toks))
        ref = Engine(small, p_cpu, scfg, device="cpu")
        r = {"logits": logits.float().numpy().tolist(),
             "lockstep": [o.tolist() for o in ref.generate(
                 prompts, max_new=16, extras=extras)],
             "margins": np.asarray(ref.margins).tolist(), "continuous": []}
        if frames is not None:
            eng = ContinuousEngine(small, p_cpu, encdec_cont_scfg(), device="cpu")
            for _ in range(2):
                got = eng.run(reqs, extras={k: {"frames": v}
                                            for k, v in frames.items()})
                r["continuous"].append({
                    "streams": {str(k): v.tolist() for k, v in got.items()},
                    "margins": {str(k): np.asarray(eng.margins[k]).tolist()
                                for k in got},
                    "compiles": compiles(eng)})
        out[arch] = r
    return out


def encdec_cont_scfg():
    """Whisper's continuous ServeConfig (``ENCDEC_CONT``)."""
    from repro_torch.serve import ServeConfig
    return ServeConfig(**ENCDEC_CONT)


def encdec_cpu_compiles(n_req) -> dict:
    """(CPU child) Run b's trace (token ids modulo the smoke vocabulary,
    the same lengths and arrivals, smoke-size frames for every request)
    through the smoke-size whisper ContinuousEngine: its compile counts."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.serve import ContinuousEngine
    torch.set_num_threads(2)
    small = get_config("whisper-base").smoke()
    reqs = encdec_run_b_requests(get_config("whisper-base").vocab_size,
                                 n_req)
    eng = ContinuousEngine(small, registry.init_params(
        small, seed=SEED, device="cpu"), encdec_cont_scfg(), device="cpu")
    frames = encdec_extras(small, 1, "cpu")["frames"]
    eng.run([dataclasses.replace(r, prompt=r.prompt % small.vocab_size)
             for r in reqs], extras={r.rid: {"frames": frames}
                                     for r in reqs})
    return compiles(eng)


def encdec_run_b_requests(vocab, n):
    """Run b's trace: n requests, two a tick, 16-48 prompt tokens, 32 new."""
    return continuous_requests(vocab, n=n, shared=0, lens=(16, 48),
                               max_new=32, seed=SEED + 2)


def encdec_smoke(dev) -> list:
    """Both families' smoke configs on the card against the CPU's plain
    versions (``encdec_smoke_reference`` in a CPU child): forward logits
    within ``TRAIN_REL_L2`` (relative L2), graphed lockstep streams over
    two generates with their extras, and whisper's graphed ContinuousEngine
    over two runs (per-request frames), streams equal or first apart at a
    near-tie and compile counts equal."""
    import numpy as np
    import torch
    from repro_torch.core import fqt
    from repro_torch.models import registry
    from repro_torch.optim.adamw import tree_map
    from repro_torch.serve import ContinuousEngine, Engine
    refs = cpu_child("encdec_smoke_reference").result()
    rows = []
    for arch in ENCDEC_ARCHS:
        small, prompts, extras, scfg, reqs, frames = encdec_smoke_case(arch)
        want = refs[arch]
        p_cpu = registry.init_params(small, seed=SEED, device="cpu")
        ex_dev = {k: v.to(dev) for k, v in extras.items()}
        toks = torch.from_numpy(np.stack(prompts)).long().to(dev)
        with torch.no_grad():
            logits, _ = registry.forward(tree_map(lambda t: t.to(dev), p_cpu),
                                         small, fqt.qaf_config(),
                                         dict(ex_dev, tokens=toks))
        rel = rel_l2(logits, torch.tensor(want["logits"]))
        row = {"phase": "encdec_vlm", "check": "smoke-size logits card vs "
               "CPU plain", "arch": arch, "rel_l2": rel}
        emit(row)
        rows.append(row)
        if not rel <= TRAIN_REL_L2:
            raise AssertionError(f"{arch}: smoke logits card vs CPU {rel}")
        eng = Engine(small, p_cpu, scfg, device=dev)
        for rep in range(2):
            out = eng.generate(prompts, max_new=16, extras=ex_dev)
            checks = [_first_divergence_ok(a.tolist(), b, m)
                      for a, b, m in zip(out, want["lockstep"],
                                         want["margins"])]
            row = {"phase": "encdec_vlm", "check": "smoke-size lockstep card "
                   "(graphs) vs CPU plain", "arch": arch, "generate": rep,
                   "streams_ok": [c[0] for c in checks],
                   "first_divergence": [c[1] for c in checks],
                   "programs": program_captures(eng)}
            emit(row)
            rows.append(row)
            if not all(c[0] for c in checks):
                raise AssertionError(f"{arch}: card and CPU streams differ "
                                     f"at a decisive step")
        if frames is None:
            continue
        eng = ContinuousEngine(small, p_cpu, encdec_cont_scfg(), device=dev)
        for rep, ref in enumerate(want["continuous"]):
            card = {str(k): v for k, v in eng.run(reqs, extras={
                k: {"frames": v.to(dev)} for k, v in frames.items()}).items()}
            checks = {r: _first_divergence_ok(card[r].tolist(),
                                              ref["streams"][r],
                                              ref["margins"][r])
                      for r in ref["streams"]}
            row = {"phase": "encdec_vlm", "check": "smoke-size continuous "
                   "card (graphs) vs CPU plain", "arch": arch, "run": rep,
                   "streams_ok": [c[0] for c in checks.values()],
                   "first_divergence": [c[1] for c in checks.values()],
                   "compiles_card": compiles(eng),
                   "compiles_cpu": ref["compiles"]}
            emit(row)
            rows.append(row)
            if sorted(card) != sorted(ref["streams"]) or \
                    not all(c[0] for c in checks.values()):
                raise AssertionError(f"{arch}: continuous card and CPU "
                                     f"streams differ at a decisive step")
            if compiles(eng) != ref["compiles"]:
                raise AssertionError(f"{arch}: compile counts differ")
    return rows


def encdec_continuous(cfg, params, dev, n_req) -> dict:
    """Run b: whisper's ContinuousEngine (4 slots, 16-token pages, nvfp4
    pool), ``n_req`` requests two a tick, each with its own frames,
    through a graphed engine (the main path) and an eager one:
    ``continuous_run``'s checks (launches from the program calls, calls
    from the scheduler), graphed = eager, each request's stream equal to
    its solo graphed lockstep run (or first apart at a near-tie), and the
    compile counts equal to the smoke-size CPU engine's on the same
    trace."""
    import gc
    import numpy as np
    import torch
    from repro_torch.serve import ContinuousEngine, Engine, ServeConfig
    cpu = cpu_child("encdec_cpu_compiles", n_req)
    reqs = encdec_run_b_requests(cfg.vocab_size, n_req)
    frames = {r.rid: encdec_extras(cfg, 1, dev, SEED + 10 + r.rid)["frames"]
              for r in reqs}
    extras = {k: {"frames": v} for k, v in frames.items()}
    sides, streams = {}, {}
    for side in ("graphs", "eager"):
        eng = ContinuousEngine(cfg, params, encdec_cont_scfg(), device=dev,
                               cuda_graphs=side == "graphs")
        info, res, margins = continuous_run(
            eng, "b", side, reqs, cfg, dev, phase="encdec_vlm",
            extras=extras, profile_reqs=continuous_requests(
                cfg.vocab_size, n=8, shared=0, lens=(16, 48), max_new=16,
                seed=SEED + 3))
        emit(info)
        sides[side], streams[side] = info, (res, margins)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    same = all(np.array_equal(streams["graphs"][0][r],
                              streams["eager"][0][r])
               for r in streams["graphs"][0])
    solo = Engine(cfg, params, ServeConfig(batch_size=1, max_len=128,
                                           kv_cache_format="nvfp4",
                                           eos_id=-1), device=dev)
    res, margins = streams["graphs"]
    checks = {}
    for r in reqs:
        want = solo.generate([r.prompt], max_new=r.max_new,
                             extras={"frames": frames[r.rid]})[0]
        checks[r.rid] = _first_divergence_ok(res[r.rid].tolist(),
                                             want.tolist(), margins[r.rid])
    want_compiles = cpu.result()
    info = dict(sides["graphs"])
    info.update(eager=sides["eager"], streams_equal=same,
                solo_streams_ok=[c[0] for c in checks.values()],
                solo_first_divergence=[c[1] for c in checks.values()],
                compiles_cpu=want_compiles)
    emit({"phase": "encdec_vlm", "run": "b", "check": "graphs vs eager, "
          "solo lockstep, compile counts", "streams_equal": same,
          "solo_streams_ok": info["solo_streams_ok"],
          "solo_first_divergence": info["solo_first_divergence"],
          "compiles_card": sides["graphs"]["compiles"],
          "compiles_cpu": want_compiles})
    if not same:
        raise AssertionError("run b: graphed and eager streams differ")
    if not all(c[0] for c in checks.values()):
        raise AssertionError("run b: continuous and solo lockstep streams "
                             "differ at a decisive step")
    for side in sides.values():
        if side["compiles"] != want_compiles:
            raise AssertionError(f"run b: compile counts {side['compiles']} "
                                 f"!= the CPU engine's {want_compiles}")
    return info


def vlm_train(dev, seq=512) -> dict:
    """Run d (internvl2-26b): two ``train_step``s at full width, depth cut
    to VLM_TRAIN_LAYERS, batch 1 x seq (+1) after a random 256-row
    ``prefix_embeds`` (nvfp4_paper_config, remat, the sigma_q probe); the
    first (cold) is timed apart, the second is the step measured: K1 as
    ``k1_step_gemms`` derives it (the layers on prefix + seq rows, the head
    on seq), K2 once per probe leaf, finite metrics."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import fqt
    from repro_torch.kernels import counters
    from repro_torch.train import step as step_mod
    full = get_config("internvl2-26b")
    cfg = dataclasses.replace(full, n_layers=VLM_TRAIN_LAYERS)
    qcfg, tcfg = fqt.nvfp4_paper_config(), step_mod.TrainConfig(remat=True)
    P = cfg.vision_tokens
    per_step = sum(k1_step_gemms(cfg, qcfg, P + seq,
                                 head_tokens=seq).values())
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    state = step_mod.init_state(cfg, tcfg, seed=SEED, device=dev)
    train_step = step_mod.make_train_step(cfg, qcfg, tcfg)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, seq + 1),
                                     generator=gen(dev, SEED), device=dev),
             **encdec_extras(cfg, 1, dev)}
    t0 = time.perf_counter()
    state, _ = train_step(state, batch)     # cold: first calls, allocator
    torch.cuda.synchronize(dev)
    cold_ms = (time.perf_counter() - t0) * 1e3
    counters.reset()
    t0 = time.perf_counter()
    state, metrics = train_step(state, batch)
    m = {k: float(v) for k, v in metrics.items() if k in (
        "loss", "nll", "grad_norm", "sigma_q")}
    torch.cuda.synchronize(dev)
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = counters.snapshot()
    leaves = len(probe_leaf_ids(state.params, probe_spec_of(tcfg)))
    info = {"phase": "encdec_vlm", "run": "d vlm train", "arch": full.name,
            "cut": {"n_layers": [full.n_layers, VLM_TRAIN_LAYERS]},
            "batch": 1, "seq": seq, "prefix_rows": P,
            "quant": "nvfp4_paper_config", "remat": True,
            "step_ms": step_ms, "first_step_ms": cold_ms, **m,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
            "k1_launches_expected": per_step, "probe_leaves": leaves,
            "launches": launches}
    emit(info)
    del state
    if launches["fused_quant_matmul"] != per_step or \
            launches["block_quantize"] != leaves:
        raise AssertionError(f"vlm train step: launches {launches}, "
                             f"expected {per_step} K1 and {leaves} K2")
    if not all(math.isfinite(v) for v in m.values()):
        raise AssertionError(f"vlm train step: non-finite metrics {m}")
    return info


def phase_encdec_vlm(dev) -> dict:
    """The encdec (whisper-base) and vlm (internvl2-26b) families at full
    width: smoke configs card vs CPU (run e); whisper lockstep at full
    depth (run a) and through ContinuousEngine (run b); internvl2 lockstep
    at full depth (run c); whisper trained through ``Trainer`` with a
    checkpoint of its TrainState, and internvl2 two train steps (the
    second measured) at VLM_TRAIN_LAYERS (run d)."""
    import gc
    import torch
    from repro_torch.configs import get_config
    # the CPU sides (run e's plain versions, run b's compile counts) run in
    # child processes beside the card's work
    cpu_child("encdec_smoke_reference")
    cpu_child("encdec_cpu_compiles", ENCDEC_REQUESTS)
    out = {"launches": {}}

    def add(launches):
        for k, v in launches.items():
            out["launches"][k] = out["launches"].get(k, 0) + v

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # a, b: whisper-base, full width and depth
    cfg = get_config("whisper-base")
    params, build = packed_init(cfg, dev, phase="encdec_vlm")
    out["a"] = {"build": build, "lockstep": archs_lockstep(
        "a", cfg, params, dev, 4, 32, 32, 128, phase="encdec_vlm",
        extras=encdec_extras(cfg, 4, dev))}
    add(out["a"]["lockstep"]["launches"])
    out["b"] = encdec_continuous(cfg, params, dev, ENCDEC_REQUESTS)
    add(out["b"]["launches"])
    del params
    free()
    # c: internvl2-26b, full width, depth cut to VLM_SERVE_LAYERS: 256
    # vision tokens + 64
    cfg = dataclasses.replace(get_config("internvl2-26b"),
                              n_layers=VLM_SERVE_LAYERS)
    params, build = packed_init(cfg, dev, phase="encdec_vlm")
    out["c"] = {"build": build, "lockstep": archs_lockstep(
        "c", cfg, params, dev, 4, 64, 32, 384, phase="encdec_vlm",
        extras=encdec_extras(cfg, 4, dev))}
    add(out["c"]["lockstep"]["launches"])
    del params
    free()
    # d: training
    info, state = trainer_run(dev, "whisper-base", phase="encdec_vlm",
                                  shape=(4, 256))
    for step in info["launches_per_step"]:
        add(step)
    info["ckpt"] = ckpt_roundtrip(dev, "whisper-base TrainState", state,
                                  phase="encdec_vlm")
    out["d"] = {"whisper": info}
    del state
    free()
    out["d"]["internvl2"] = vlm_train(dev)
    add(out["d"]["internvl2"]["launches"])
    free()
    out["e"] = encdec_smoke(dev)
    emit({"phase": "encdec_vlm", "launches_main_path": out["launches"]})
    return out


# phase mesh: the serving mesh through ``launch/serve.py --mesh``, gloo ranks
# sharing the one card (NCCL refuses two ranks on one device).  Runs: label
# -> (mesh spec, the launcher's arguments).  b: ContinuousEngine at tp=2 on
# run A's traffic cut to 4 requests (shared 128-token prefix, prefix cache,
# 64-token chunks, 32 new); c: the lockstep Engine at tp=2 (serve's batch 4
# x 64, 32 new); both llama2-7b at full width, depth cut 32 -> MESH_LAYERS
# = 2 (4 since phase mesh_families joined the script, 2 since phase
# mesh_encdec_recurrent, to keep it inside its time limit: the layers all
# repeat, on gloo eager).  d: dp=2,tp=2 (4 ranks), depth cut 32 ->
# MESH_LAYERS, lockstep, 16 new: every GEMM weight gathered over "data"
# (allgather_packed) before use.  Each run is also served by one process
# (no --mesh, its programs graphed), the comparison.
MESH_LAYERS = 2
MESH_RUNS = {
    "b": ("tp=2", ["--queue", "4", "--max-slots", "4", "--batch", "4",
                   "--shared-prefix", "128", "--prompt-len", "64",
                   "--prefix-cache", "--prefill-chunk", "64", "--max-new",
                   "32", "--max-len", "512", "--layers", str(MESH_LAYERS)]),
    "c": ("tp=2", ["--batch", "4", "--prompt-len", "64", "--max-new", "32",
                   "--max-len", "256", "--layers", str(MESH_LAYERS)]),
    "d": ("dp=2,tp=2", ["--batch", "4", "--prompt-len", "64", "--max-new",
                        "16", "--max-len", "256", "--layers",
                        str(MESH_LAYERS)]),
}
# The rules the mesh runs are held to against the one-process runs, written
# in PERF.md before the first card run: a stream may first part from the
# one-process stream only at a step whose one-process greedy margin is
# below MESH_MARGIN (after a parting nothing more is compared), and the
# prompts' last-token prefill logits agree within MESH_LOGITS_RTOL
# (relative L2).  The mesh's row-parallel GEMMs add their f32 partials in
# another order, which can flip a bf16 rounding and, through the next FP4
# activation quantization, a code.
MESH_MARGIN = 0.05
MESH_LOGITS_RTOL = 1e-2
# the runs started together: all of them at once since the cut to 2 layers
# (their build peaks, whole bf16 layers packed in every process, were two
# waves' worth at 4 layers)
MESH_WAVES = ((("b", "mesh"), ("c", "mesh"), ("d", "mesh"), ("b", "one"),
               ("c", "one"), ("d", "one")),)


def card_used_mib() -> int:
    """Device memory in use on the card, every process's (nvidia-smi)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return int(out.split()[0])


def _launcher(arch, mesh, args, out: Path) -> subprocess.Popen:
    """``python -m repro_torch.launch.serve`` as a child (its own ranks,
    spawned by the launcher), reporting into ``out``."""
    import os
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
           "--seed", str(SEED), "--report", str(out), *args]
    if mesh:
        cmd += ["--mesh", mesh, "--dist-backend", "gloo"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _reports(out: Path, n: int) -> list:
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(n)]


def mesh_expected(cfg, rep) -> dict:
    """Each kernel's launches on one rank from its programs' calls: every
    rank runs every layer on its shards, so a rank launches what one
    process launches (``expected_launches``, ``lockstep_launches``)."""
    calls = rep["calls"]
    if "decode" in calls and "prefill_suffix" in calls:
        return expected_launches(cfg, {f"_{k}": v for k, v in calls.items()})
    return lockstep_launches(cfg, calls["decode"])


def mesh_compare(mesh_rep, one_rep) -> dict:
    """Streams of the mesh run (rank 0) against the one-process run:
    common prefix per stream, and at a first parting the one-process
    greedy margin there, held to MESH_MARGIN."""
    rows, ok = {}, True
    for k, want in one_rep["streams"].items():
        got = mesh_rep["streams"][k]
        t = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                 None)
        if t is None and len(got) != len(want):
            t = min(len(got), len(want))
        margin = None if t is None else one_rep["margins"][k][t]
        ok &= t is None or (margin is not None and margin < MESH_MARGIN)
        rows[k] = {"common_prefix": len(want) if t is None else t,
                   "of": len(want), "parting_margin": margin}
    return {"streams_ok": bool(ok), "streams": rows}


def phase_mesh(dev) -> dict:
    """The serving mesh on gloo ranks sharing the card; see the docstring
    at the top and MESH_RUNS."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    _build.build_all()              # built once: the ranks load it
    gc.collect()
    torch.cuda.empty_cache()        # the earlier phases' cached blocks
    root = ROOT / "build" / "mesh_phase"
    if root.exists():
        import shutil
        shutil.rmtree(root)
    emit({"phase": "mesh", "parent_allocated_bytes":
          torch.cuda.memory_allocated(dev), "parent_reserved_bytes":
          torch.cuda.memory_reserved(dev), "card_used_mib": card_used_mib()})
    t0 = time.perf_counter()
    logs = {}
    # two waves, so the children's build peaks (each packs whole layers
    # before cutting its shard) stay within the card
    for wave in MESH_WAVES:
        procs = {}
        for label, side in wave:
            mesh, args = MESH_RUNS[label]
            procs[(label, side)] = _launcher(
                "llama2-7b", mesh if side == "mesh" else None, args,
                root / f"{label}_{side}")
        for key, proc in procs.items():
            try:
                logs[key], _ = proc.communicate(timeout=900)
            except subprocess.TimeoutExpired:
                proc.kill()
                logs[key], _ = proc.communicate()
                raise AssertionError(f"mesh run {key} timed out:\n"
                                     f"{logs[key][-3000:]}")
            if proc.returncode != 0:
                raise AssertionError(f"mesh run {key} failed:\n"
                                     f"{logs[key][-3000:]}")
    wall = time.perf_counter() - t0
    full = get_config("llama2-7b")
    failures, launches, out = [], {}, {}
    label_gloo = "gloo, ranks sharing one card: not a TP speed"
    for label, (mesh, args) in MESH_RUNS.items():
        n = 4 if mesh == "dp=2,tp=2" else 2
        cfg = dataclasses.replace(full, n_layers=int(args[args.index(
            "--layers") + 1])) if "--layers" in args else full
        reps = _reports(root / f"{label}_mesh", n)
        one = _reports(root / f"{label}_one", 1)[0]
        if "serving mesh: " not in logs[(label, "mesh")]:
            failures.append((label, "no serving-mesh line"))
        for rep in reps:
            if rep["streams"] != reps[0]["streams"]:
                failures.append((label, f"rank {rep['rank']} streams"))
            want = mesh_expected(cfg, rep)
            if rep["launches"] != want:
                failures.append((label, f"rank {rep['rank']} launches "
                                 f"{rep['launches']} != {want}"))
            for k, v in rep["launches"].items():
                launches[k] = launches.get(k, 0) + v
        if one["launches"] != mesh_expected(cfg, one):
            failures.append((label, "one-process launches"))
        cmp = mesh_compare(reps[0], one)
        if not cmp["streams_ok"]:
            failures.append((label, "stream parted at a decisive step"))
        lg = np.load(root / f"{label}_mesh" / "prefill_logits.npy")
        lw = np.load(root / f"{label}_one" / "prefill_logits.npy")
        rel = float(np.linalg.norm(lg - lw) / np.linalg.norm(lw))
        if not (np.isfinite(lg).all() and rel <= MESH_LOGITS_RTOL):
            failures.append((label, f"prefill logits rel L2 {rel}"))
        r0 = reps[0]
        steps = max(1, r0["calls"]["decode"])
        row = {
            "phase": "mesh", "run": label, "mesh": mesh, "ranks": n,
            "layers": cfg.n_layers, "backend": r0["backend"],
            "label": label_gloo, **cmp,
            "prefill_logits_rel_l2": rel,
            "logits_rms": float(np.sqrt(np.mean(lw.astype(np.float64) ** 2))),
            "tokens": r0["tokens"], "seconds": r0["seconds"],
            "tokens_per_s": r0["tokens"] / r0["seconds"],
            "one_process_tokens_per_s": one["tokens"] / one["seconds"],
            "decode_calls": r0["calls"]["decode"],
            # a lockstep run's seconds include its prefill (one program
            # call of steps + 1): the report reads the run's own prefill
            # logits and times no second prefill
            "ms_per_decode_call": r0["seconds"] * 1e3 / steps,
            "sharded_prefill_ms": (None if r0["prefill_s"] is None
                                   else r0["prefill_s"] * 1e3),
            "collectives": [rep["collectives"] for rep in reps],
            "collective_ms_per_decode_call": [
                rep["collectives"]["seconds"] * 1e3 / steps for rep in reps],
            "peak_allocated_bytes": [rep["peak_allocated"] for rep in reps],
            "one_process_peak_allocated": one["peak_allocated"],
            "weight_store_bytes": [rep["weight_store_bytes"] for rep in reps],
            "gemm_wire_bytes_per_param": r0["gemm_wire_bytes"]
            / r0["gemm_params"],
            "launches_rank0": r0["launches"]}
        emit(row)
        out[label] = row
    emit({"phase": "mesh", "wall_s": wall, "card": card_line()})
    if failures:
        raise AssertionError(f"mesh phase: {failures}")
    return {"launches": launches, "runs": out}


# ---- phase train_mesh: the training mesh on gloo ranks sharing the card ------
#
# llama2-7b at full width, depth cut 32 -> TM_LAYERS = 1 (its training state
# is ~108 GB at 32 layers; the ranks share one 80 GB card; 2 layers until
# phase mesh_encdec_recurrent joined the script), a global batch of 2 x 512
# tokens (a cut of the train phase's 4 x 1024: gloo stages every activation
# all-reduce through the host), nvfp4_paper_config, remat, the sigma_q probe,
# 3 steps from one seeded initial state, each run against one process
# (``Trainer`` without a mesh, in this process while the ranks run).  Wave A
# (2 ranks): b, tp=2, checkpointed after step 2 (run e restores it in this
# process and takes step 3); c, fsdp=2; d, (pod, data, model) = (2, 1, 1)
# with the GRAD_FP8 compressed pod mean; f, ``pipeline_apply`` over (pipe,
# data) = (2, 1) with the dense block as layer_fn, 4 layers, 4 microbatches
# of 1 x 512.  Wave B (4 ranks): c, dp=2,tp=2, started with wave A (one
# after the other until the cut to one layer).
TM_LAYERS = 1
TM_BATCH, TM_SEQ, TM_STEPS, TM_SPLIT = 2, 512, 3, 2
TM_RUNS = {
    "b": ((2,), ("model",), False),
    "c_fsdp": ((2,), ("data",), False),
    "d_pod": ((2, 1, 1), ("pod", "data", "model"), True),
    "c_dptp": ((2, 2), ("data", "model"), False),
}
TM_WAVES = {2: ("b", "c_fsdp", "d_pod"), 4: ("c_dptp",)}
TM_PIPE_LAYERS, TM_PIPE_MB, TM_PIPE_SEQ = 4, 4, 512
# The rules, written in PERF.md before the card runs that test them: the
# step-0 loss of every mesh run within TM_LOSS0_RTOL of one process
# (bit-equality reported), the later losses within TM_LOSS_RTOL; each
# leaf's update after the 3 steps, as a relative L2 from one process's,
# within TM_UPDATE_REL_L2 where no contraction is split over "model" and
# nothing is compressed, else within max(TM_UPDATE_REL_L2, the SR
# envelope) (b, dp=2,tp=2: the ranks' f32 partial products are
# all-reduced, which moves last bits that FP4 re-quantization amplifies;
# d: the pods' means carry the compressor's SR noise; such a run is one
# more draw of the SR noise): the SR envelope (``tm_envelope``) is the
# largest relative L2 between any two of one process and two one-process
# runs whose every SR stream is re-drawn (step seeds XOR TM_REDRAWS), under
# 1 for every leaf, so a run that applied no update fails; the later
# losses of those runs within max(TM_LOSS_RTOL (TM_COMP_LOSS_RTOL
# compressed), the same envelope of the losses, ``tm_loss_bound``), not 1
# x one redraw's distance: a second pure redraw lies up to 1.68 x the
# first's distance from one process, leaf by leaf (PERF.md).  In every run
# grad_norm and sigma_q at every step within max(TM_NOISE_X x their SR
# spread, TM_NORM_RTOL) relative of one process's (a gradient counted
# twice, or summed and not averaged, moves its norm by 41-100%); run b's
# rank 0, which writes the checkpoint, peaking within the largest logical
# leaf of the other rank's peak; the pipeline's output within relative L2
# PIPE_FWD_RTOL of the sequential application (each microbatch through the
# layers in order on one rank) and its gradients within PIPE_RTOL.
TM_LOSS0_RTOL = 1e-5
TM_LOSS_RTOL = 1e-3
TM_UPDATE_REL_L2 = 3e-2
TM_COMP_LOSS_RTOL = 1e-2
TM_REDRAW = 0x5A5A5A5A
# the two re-drawn one-process runs whose distances from one process and
# from each other bound a mesh run (``tm_envelope``, ``tm_loss_bound``)
TM_REDRAWS = (TM_REDRAW, 0xC3C3C3C3)
TM_NOISE_X = 2.0
TM_NORM_RTOL = 1e-2
PIPE_FWD_RTOL = 1e-6
PIPE_RTOL = 1e-2
TM_LABEL = "gloo ranks sharing one card: not a DP/TP speed"


def tm_setup():
    """(cfg, qcfg, TrainConfig, DataConfig) of the phase's runs."""
    from repro_torch.configs import get_config
    from repro_torch.core import fqt
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train import TrainConfig
    cfg = dataclasses.replace(get_config("llama2-7b"), n_layers=TM_LAYERS)
    return (cfg, fqt.nvfp4_paper_config(), TrainConfig(remat=True),
            DataConfig(cfg.vocab_size, TM_SEQ, TM_BATCH))


def tm_probe_launches(cfg, shape, names) -> int:
    """K2 launches of one step's sigma_q probe on a rank of the mesh, from
    the rule table: one per reference leaf of 2+ dims (the per-layer
    leaves stacked) whose last dim takes whole blocks, and L (L x E for a
    moe layer's stacked experts) for a stacked leaf whose layers are split
    on another dim than the last (its rows are then no progression of the
    whole leaf's: ``train/step._probe_parts``)."""
    import torch
    from repro_torch.distributed import sharding
    from repro_torch.distributed.mesh import Mesh
    mesh = Mesh(shape, names, device=torch.device("cpu"))
    d, f, V = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    qd = cfg.n_heads * cfg.hd
    kv = cfg.n_kv_heads * cfg.hd
    E = cfg.n_experts
    lead = (E,) if E else ()
    stacked = {"wq": (d, qd), "wk": (d, kv), "wv": (d, kv), "wo": (qd, d),
               "w_gate": lead + (d, f), "w_up": lead + (d, f),
               "w_down": lead + (f, d), "ln1": (d,), "ln2": (d,)}
    if cfg.act == "smooth_swiglu":
        stacked["smooth"] = lead + (f,)
    if cfg.use_qk_norm:
        stacked.update(q_norm=(cfg.hd,), k_norm=(cfg.hd,))
    if E:
        stacked["router"] = (d, E)
    n = 2                                # embed, lm_head (2-D, unstacked)
    for name, shp in stacked.items():
        if shp[-1] % 16:                 # a ragged last axis: skipped
            continue
        spec = sharding.placed_spec(name, len(shp), mesh)
        # a layer split on another dim than its last: one call a layer and
        # index of its leading dims (a moe layer's experts)
        n += cfg.n_layers * math.prod(shp[:-2]) if any(
            ax is not None for ax in spec[:len(shp) - 1]) else 1
    return n


def tm_leaf_count(cfg) -> int:
    """The port's parameter leaves (the compressor's K2 launches a step)."""
    per = 9 + int(cfg.act == "smooth_swiglu")
    return 3 + per * cfg.n_layers


def digest(t) -> list:
    """Two int64 sums of a tensor's bytes read as int32 words (one of them
    weighted by position): equal digests for equal bits, computed on the
    card."""
    import torch
    b = t.detach().contiguous().reshape(-1).view(torch.uint8)
    pad = (-b.numel()) % 4
    if pad:
        b = torch.cat([b, b.new_zeros(pad)])
    w = b.view(torch.int32).to(torch.int64)
    pos = torch.arange(w.numel(), device=w.device) % 1021 + 1
    return [int(w.sum()), int((w * pos).sum())]


def state_digests(state) -> dict:
    from repro_torch.distributed import sharding
    out = {}

    def one(path, x):
        if hasattr(x, "dtype"):
            out[path] = digest(x)
        return x
    sharding.map_paths(state, one)
    return out


def tm_trainer(cfg, qcfg, tcfg, data, steps, mesh=None, ckpt_dir=None,
               compression=False, seed=SEED):
    from repro_torch.distributed import compression as comp
    from repro_torch.train import Trainer, TrainerConfig
    if compression:
        tcfg = dataclasses.replace(tcfg, compression=comp.CompressionConfig(
            spec=comp.GRAD_FP8))
    rc = TrainerConfig(total_steps=steps, seed=seed, export_packed=False)
    if ckpt_dir:
        rc = dataclasses.replace(rc, ckpt_dir=ckpt_dir, ckpt_every=TM_SPLIT,
                                 keep_ckpts=1)
    return Trainer(cfg, qcfg, tcfg, rc, data, mesh=mesh,
                   device=None if mesh is not None else "cuda")


def tm_history(trainers) -> list:
    keys = ("loss", "nll", "grad_norm", "sigma_q", "gnr", "lr")
    return [{k: h[k] for k in keys} for tr in trainers for h in tr.history]


def tm_redrawn(cfg, qcfg, tcfg, data, redraw=TM_REDRAW):
    """The one-process run again with every SR stream re-drawn (each step's
    seed XOR ``redraw``, the probe's with it): (history, final flat
    params).  Its distance from the one-process run is the SR noise that
    the rules scale by."""
    from repro_torch.train import step as step_mod
    seed_of = step_mod.step_seed
    step_mod.step_seed = lambda s: seed_of(s) ^ redraw
    try:
        tr = tm_trainer(cfg, qcfg, tcfg, data, TM_STEPS)
        state = tr.run()
    finally:
        step_mod.step_seed = seed_of
    return tm_history([tr]), _flat_params(state.params)


def tm_update_rel_l2(init, want_final, got_final) -> dict:
    """Each leaf's update (final - initial) of ``got_final`` against
    ``want_final``'s, as a relative L2 (whole tensors on one process;
    ``init`` None: the tensors themselves, as gradients), computed on the
    card where there is one."""
    dev = _compare_device()
    out = {}
    for path, w in want_final.items():
        i0 = 0.0 if init is None else init[path].to(dev).float()
        want = w.to(dev).float() - i0
        out[path] = float(torch_norm(got_final[path].to(dev).float() - i0
                                     - want)
                          / max(float(torch_norm(want)), 1e-30))
    return out


def _compare_device():
    import torch
    return torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")


def tm_envelope(init, finals) -> dict:
    """Each leaf's SR noise envelope: the largest relative L2 between the
    updates of any two of ``finals`` (one process's final flat params,
    then its re-drawn runs'; ``init`` None: gradients themselves)."""
    pairs = [tm_update_rel_l2(init, finals[i], finals[j])
             for i in range(len(finals)) for j in range(i + 1, len(finals))]
    return {p: max(d[p] for d in pairs) for p in pairs[0]}


def tm_loss_bound(i, one, redrawn, rtol) -> float:
    """The bound on a mesh run's step-``i`` loss distance from one
    process's (histories ``one`` and ``redrawn``, a list): max(``rtol`` x
    |loss|, the largest distance between any two of one process's and the
    re-drawn runs' step-``i`` losses)."""
    losses = [one[i]["loss"]] + [r[i]["loss"] for r in redrawn]
    return max(rtol * abs(one[i]["loss"]),
               max(abs(a - b) for a in losses for b in losses))


def torch_norm(t):
    import torch
    return torch.linalg.vector_norm(t.reshape(-1).double())


def tm_run(rank, label, root: Path) -> None:
    """One run of the phase on this rank; writes its report (and its final
    parameter shards) under ``root``."""
    import torch
    from repro_torch.distributed.mesh import make_mesh
    from repro_torch.kernels import counters
    shape, names, compressed = TM_RUNS[label]
    cfg, qcfg, tcfg, data = tm_setup()
    dev = torch.device("cuda", 0)
    mesh = make_mesh(shape, names, device=dev, backend="gloo")
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    counters.reset()
    mesh.reset_stats()
    t0 = time.perf_counter()
    per, trainers, rep = [], [], {"rank": rank, "label": label}
    if label == "b":
        first = tm_trainer(cfg, qcfg, tcfg, data, TM_SPLIT, mesh,
                           ckpt_dir=str(root / "ckpt"))
        marks = count_steps(first)
        state = first.run()
        marks.append(counters.snapshot())
        per += step_launches(marks)
        rep["digests"] = state_digests(state)
        counters.reset()
        second = tm_trainer(cfg, qcfg, tcfg, data, TM_STEPS, mesh)
        marks = count_steps(second)
        state = second.run(state)
        marks.append(counters.snapshot())
        per += step_launches(marks)
        trainers = [first, second]
    else:
        tr = tm_trainer(cfg, qcfg, tcfg, data, TM_STEPS, mesh,
                        compression=compressed)
        marks = count_steps(tr)
        state = tr.run()
        marks.append(counters.snapshot())
        per += step_launches(marks)
        trainers = [tr]
    torch.cuda.synchronize(dev)
    rep.update(seconds=time.perf_counter() - t0, launches=per,
               history=tm_history(trainers),
               events=[e for tr in trainers for e in tr.events],
               stats=mesh.stats, coords=dict(mesh.coords),
               peak_allocated=torch.cuda.max_memory_allocated(dev))
    torch.save({k: v.cpu() for k, v in _flat_params(state.params).items()},
               root / f"{label}_rank{rank}.pt")
    del state
    (root / f"{label}_rank{rank}.json").write_text(json.dumps(rep))


def _flat_params(tree, prefix="") -> dict:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat_params(v, f"{prefix}/{k}" if prefix else k))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_flat_params(v, f"{prefix}/{i}"))
    else:
        out[prefix] = tree
    return out


def tm_pipeline(rank, root: Path) -> None:
    """Run f: ``pipeline_apply`` over (pipe, data) = (2, 1) with the dense
    block of llama2-7b (full width) as layer_fn, against the sequential
    application of the same layers on this rank; forward and backward of
    sum(out^2)."""
    import torch
    from repro_torch.distributed import pipeline as pp
    from repro_torch.kernels import counters
    from repro_torch.models import registry, transformer
    cfg, qcfg, _, _ = tm_setup()
    cfg = dataclasses.replace(cfg, n_layers=TM_PIPE_LAYERS)
    dev = torch.device("cuda", 0)
    mesh = pp.make_pipeline_mesh(2, device=dev, backend="gloo")
    layers = registry.init_params(cfg, seed=SEED + 7, device=dev)["layers"]

    def stack(ls):
        if isinstance(ls[0], dict):
            return {k: stack([lp[k] for lp in ls]) for k in ls[0]}
        return torch.stack(ls).requires_grad_(True)

    params = stack(layers)
    del layers
    leaves = list(_flat_params(params).items())
    x = (torch.randn((TM_PIPE_MB, TM_PIPE_SEQ, cfg.d_model),
                     generator=gen(dev, SEED + 8), device=dev)
         ).to(torch.bfloat16)

    def fn(p, h):
        return transformer._layer_apply(cfg, p, h, 0x5EED, cache=None,
                                        qcfg=qcfg)[0]

    s, per = mesh.axis_index("pipe"), TM_PIPE_LAYERS // 2
    torch.cuda.synchronize(dev)
    counters.reset()
    t0 = time.perf_counter()
    xg = x.clone().requires_grad_(True)
    out = pp.pipeline_apply(fn, params, xg, mesh, pp.PipelineConfig(
        n_stages=2, n_microbatches=TM_PIPE_MB))
    torch.sum(out.float() ** 2).backward()
    mesh.wait_sends()
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    launches = counters.snapshot()
    grads = {k: v.grad[s * per:(s + 1) * per].clone() for k, v in leaves}
    dx = xg.grad
    for _, v in leaves:
        v.grad = None
    # the sequential application: each microbatch through the 4 layers
    xs = x.clone().requires_grad_(True)
    outs = []
    for mb in xs.chunk(TM_PIPE_MB):
        h = mb
        for i in range(TM_PIPE_LAYERS):
            h = fn({k: _index_params(params, k, i) for k in params}, h)
        outs.append(h)
    seq = torch.cat(outs)
    torch.sum(seq.float() ** 2).backward()
    torch.cuda.synchronize(dev)
    rep = {"rank": rank, "stage": s, "seconds": seconds,
           "launches": launches, "stats": mesh.stats,
           "out_rel_l2": rel_l2(out, seq),
           "out_bitwise": bool(torch.equal(out, seq)),
           "grad_rel_l2": {k: rel_l2(grads[k], v.grad[s * per:(s + 1) * per])
                           for k, v in leaves},
           "dx_rel_l2": rel_l2(dx, xs.grad) if s == 0 else None,
           "peak_allocated": torch.cuda.max_memory_allocated(dev)}
    (root / f"pipe_rank{rank}.json").write_text(json.dumps(rep))


def _index_params(params, k, i):
    v = params[k]
    if isinstance(v, dict):
        return {kk: vv[i] for kk, vv in v.items()}
    return v[i]


def train_mesh_child(rank, world, root) -> None:
    """The ranks of one wave: each of the wave's runs in turn, then (2
    ranks) the pipeline."""
    import gc
    import torch
    root = Path(root)
    for label in TM_WAVES[world]:
        tm_run(rank, label, root)
        gc.collect()
        torch.cuda.empty_cache()
    if world == 2:
        tm_pipeline(rank, root)


def tm_start(world, root: Path):
    """Start a wave's ranks (spawned, gloo over a file rendezvous; the
    kernels built already), not waiting for them."""
    import torch.multiprocessing as mp
    from repro_torch.distributed.mesh import _rank_main
    return mp.start_processes(
        _rank_main, args=(train_mesh_child, world, "gloo", "cuda:0",
                          f"file://{root}/rendezvous{world}",
                          (world, str(root))),
        nprocs=world, join=False, start_method="spawn")


def tm_join(ctx, timeout=600) -> None:
    t0 = time.perf_counter()
    while not ctx.join(timeout=5):
        if time.perf_counter() - t0 > timeout:
            for p in ctx.processes:
                p.kill()
            raise AssertionError("train_mesh ranks timed out")


def tm_reports(root: Path, label: str, n: int) -> list:
    return [json.loads((root / f"{label}_rank{r}.json").read_text())
            for r in range(n)]


def tm_norm_check(label, got, want, redrawn, failures) -> dict:
    """grad_norm and sigma_q at every step of history ``got`` against one
    process's ``want``: within max(TM_NOISE_X x their SR spread (the
    distance of the ``redrawn`` history, where there is one),
    TM_NORM_RTOL) relative; a miss is appended to ``failures``.  Returns
    {key: [[relative deviation, relative limit] per step]}."""
    out = {}
    for k in ("grad_norm", "sigma_q"):
        out[k] = []
        for i, (g, w) in enumerate(zip(got, want)):
            dev_i, lim = abs(g[k] - w[k]), TM_NORM_RTOL * abs(w[k])
            if redrawn is not None:
                lim = max(TM_NOISE_X * abs(redrawn[i][k] - w[k]), lim)
            out[k].append([dev_i / abs(w[k]), lim / abs(w[k])])
            if not dev_i <= lim:
                failures.append((label, f"step-{i} {k} {g[k]} vs {w[k]} "
                                 f"(limit {lim})"))
    return out


def tm_compare_updates(label, shape, names, init, one_final, root,
                       kind=None) -> dict:
    """Each leaf's update (final - initial) of the mesh run against one
    process's, as a relative L2 over the whole leaf from every rank's
    shard (a replicated leaf counted once).  ``kind``: the ranks' files
    are ``{label}_{kind}_rank{r}.pt`` (``er_train_child``), and ``init``
    None compares the tensors themselves (gradients)."""
    import torch
    from repro_torch.distributed import sharding
    from repro_torch.distributed.mesh import Mesh
    n = math.prod(shape)
    dev = _compare_device()
    num, den = {}, {}
    for r in range(n):
        m = Mesh(shape, names, device=torch.device("cpu"), rank=r)
        mine = torch.load(root / (f"{label}_rank{r}.pt" if kind is None
                                  else f"{label}_{kind}_rank{r}.pt"))
        for path, got in mine.items():
            spec = sharding.placed_spec(path.rsplit("/", 1)[-1], got.ndim, m)
            if not sharding.is_owner(spec, m):
                continue
            i0 = (torch.zeros((), device=dev) if init is None else
                  sharding.local_shard(init[path], spec, m).to(dev).float())
            want = sharding.local_shard(one_final[path], spec, m).to(
                dev).float() - i0
            upd = got.to(dev).float() - i0
            num[path] = num.get(path, 0.0) + float(((upd - want) ** 2).sum())
            den[path] = den.get(path, 0.0) + float((want ** 2).sum())
    return {p: math.sqrt(num[p]) / max(math.sqrt(den[p]), 1e-30)
            for p in num}


def phase_train_mesh(dev) -> dict:
    """The training mesh on gloo ranks sharing the card; see the docstring
    at the top and TM_RUNS."""
    import gc
    import shutil
    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.distributed import sharding
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.kernels import _build, counters
    from repro_torch.models import registry
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train import step as step_mod
    _build.build_all()              # built once: the ranks load it
    gc.collect()
    torch.cuda.empty_cache()
    root = ROOT / "build" / "train_mesh_phase"
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    cfg, qcfg, tcfg, data = tm_setup()
    emit({"phase": "train_mesh", "arch": "llama2-7b", "cut": {
        "n_layers": [32, TM_LAYERS], "batch": [4, TM_BATCH],
        "seq": [1024, TM_SEQ]}, "steps": TM_STEPS, "label": TM_LABEL,
        "card": card_line(), "free_disk_bytes":
        shutil.disk_usage(root).free})
    t_phase = time.perf_counter()
    failures, out = [], {}
    k1_step = sum(k1_step_gemms(cfg, qcfg, TM_BATCH * TM_SEQ).values())
    # both waves at once since the cut to one layer (its four ranks' states
    # fit beside the two's; run e still waits for wave A's checkpoint)
    wave_a = tm_start(2, root)
    wave_b = tm_start(4, root)
    # one process: the reference of runs b-d, the like of run e
    torch.cuda.reset_peak_memory_stats(dev)
    counters.reset()
    t0 = time.perf_counter()
    one = tm_trainer(cfg, qcfg, tcfg, data, TM_STEPS)
    marks = count_steps(one)
    one_state = one.run()
    marks.append(counters.snapshot())
    torch.cuda.synchronize(dev)
    one_s = time.perf_counter() - t0
    one_hist = tm_history([one])
    want1 = {k: 0 for k in counters.COUNTS}
    want1.update(fused_quant_matmul=k1_step, block_quantize=tm_probe_launches(
        cfg, (1,), ("model",)))
    if any(c != want1 for c in step_launches(marks)):
        failures.append(("one process", "launches"))
    init = {k: v for k, v in _flat_params(registry.init_params(
        cfg, seed=SEED, device=dev)).items()}
    one_final = _flat_params(one_state.params)
    emit({"phase": "train_mesh", "run": "one", "seconds": one_s,
          "history": one_hist, "peak_allocated":
          torch.cuda.max_memory_allocated(dev)})
    # the SR noise: one process again with every SR stream re-drawn, twice
    t0 = time.perf_counter()
    reds = [tm_redrawn(cfg, qcfg, tcfg, data, redraw=x) for x in TM_REDRAWS]
    red_hists = [h for h, _ in reds]
    red_hist = red_hists[0]
    spread = tm_envelope(init, [one_final] + [f for _, f in reds])
    del reds
    emit({"phase": "train_mesh", "run": "one_redrawn",
          "seconds": time.perf_counter() - t0, "histories": red_hists,
          "sr_envelope": spread})
    leaf_bytes = 4 * max(v.numel() for v in init.values())   # f32 master
    tm_join(wave_a)
    # run e: run b's step-2 checkpoint restored in this process, step 3
    t0 = time.perf_counter()
    step, restored = ckpt.restore_latest(str(root / "ckpt"), one_state)
    del one_state
    restore_s = time.perf_counter() - t0
    reps_b = tm_reports(root, "b", 2)
    same = step == TM_SPLIT
    for r, rep in enumerate(reps_b):
        m = Mesh((2,), ("model",), device=dev, rank=r)
        placed = sharding.place_train_state(restored, m)
        same &= state_digests(placed) == rep["digests"]
        del placed
    e_tr = Trainer(cfg, qcfg, tcfg, TrainerConfig(total_steps=TM_STEPS,
                                                  export_packed=False),
                   data, device=dev)
    e_tr.run(restored)
    del restored
    e_loss = e_tr.history[0]["loss"]
    b_loss = reps_b[0]["history"][TM_SPLIT]["loss"]
    e_row = {"phase": "train_mesh", "run": "e", "restored_step": step,
             "restored_equals_gathered": bool(same), "restore_s": restore_s,
             "step3_loss": e_loss, "tp2_step3_loss": b_loss,
             "bit_equal": e_loss == b_loss}
    emit(e_row)
    if not same:
        failures.append(("e", "restored leaves differ from the gathered"))
    if abs(e_loss - b_loss) > TM_LOSS_RTOL * abs(b_loss):
        failures.append(("e", f"step-3 loss {e_loss} vs {b_loss}"))
    tm_join(wave_b)
    wall = time.perf_counter() - t_phase
    launches = {}
    for label, (shape, names, compressed) in TM_RUNS.items():
        n = math.prod(shape)
        reps = tm_reports(root, label, n)
        want = dict(want1)
        want["block_quantize"] = tm_probe_launches(cfg, shape, names) + (
            tm_leaf_count(cfg) if compressed else 0)
        for rep in reps:
            if rep["history"] != reps[0]["history"]:
                failures.append((label, f"rank {rep['rank']} metrics"))
            if any(c != want for c in rep["launches"]):
                failures.append((label, f"rank {rep['rank']} launches "
                                 f"{rep['launches']} != {want}"))
            for c in rep["launches"]:
                for k, v in c.items():
                    launches[k] = launches.get(k, 0) + v
        h, o = reps[0]["history"], one_hist
        loss0_equal = h[0]["loss"] == o[0]["loss"]
        rtol = TM_COMP_LOSS_RTOL if compressed else TM_LOSS_RTOL
        split = "model" in names and shape[names.index("model")] > 1
        if abs(h[0]["loss"] - o[0]["loss"]) > TM_LOSS0_RTOL * abs(o[0]["loss"]):
            failures.append((label, "step-0 loss"))
        for i in range(1, TM_STEPS):
            lim = (tm_loss_bound(i, o, red_hists, rtol) if split or compressed
                   else rtol * abs(o[i]["loss"]))
            if abs(h[i]["loss"] - o[i]["loss"]) > lim:
                failures.append((label, f"step-{i} loss (limit {lim})"))
        upd = tm_compare_updates(label, shape, names, init, one_final, root)
        worst = max(upd.values())
        bound = {p: max(TM_UPDATE_REL_L2, spread[p]) if split or compressed
                 else TM_UPDATE_REL_L2 for p in upd}
        over = {p: (v, bound[p]) for p, v in upd.items() if v > bound[p]}
        if over:
            failures.append((label, f"update rel L2 over its bound {over}"))
        norm_dev = tm_norm_check(label, h, o, red_hist, failures)
        peaks = [r["peak_allocated"] for r in reps]
        if label == "b" and peaks[0] > max(peaks[1:]) + leaf_bytes:
            failures.append((label, f"rank 0 peak {peaks[0]} over the "
                             f"others' {max(peaks[1:])} + {leaf_bytes}"))
        ops = reps[0]["stats"]["ops"]
        per_step = {k: {"calls": v["calls"] / TM_STEPS,
                        "bytes": v["bytes"] / TM_STEPS,
                        "host_ms": v["seconds"] * 1e3 / TM_STEPS}
                    for k, v in ops.items()}
        row = {"phase": "train_mesh", "run": label,
               "mesh": dict(zip(names, shape)), "ranks": n,
               "compression": "GRAD_FP8" if compressed else None,
               "label": TM_LABEL, "loss0_bit_equal": loss0_equal,
               "losses": [x["loss"] for x in h],
               "one_process_losses": [x["loss"] for x in o],
               "max_loss_rel": max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                                   for a, b in zip(h, o)),
               "worst_update_rel_l2": worst,
               "worst_update_leaf": max(upd, key=upd.get),
               "worst_update_over_bound": max(upd[p] / bound[p]
                                              for p in upd),
               "sr_envelope_of_worst_leaf": spread[max(upd, key=upd.get)],
               "redrawn_losses": [[x["loss"] for x in r] for r in red_hists],
               "grad_norm": [x["grad_norm"] for x in h],
               "one_process_grad_norm": [x["grad_norm"] for x in o],
               "redrawn_grad_norm": [x["grad_norm"] for x in red_hist],
               "sigma_q": [x["sigma_q"] for x in h],
               "one_process_sigma_q": [x["sigma_q"] for x in o],
               "redrawn_sigma_q": [x["sigma_q"] for x in red_hist],
               "norm_rel_dev_and_limit": norm_dev,
               "seconds": reps[0]["seconds"],
               "ms_per_step": reps[0]["seconds"] * 1e3 / TM_STEPS,
               "one_process_ms_per_step": one_s * 1e3 / TM_STEPS,
               "launches_per_step": want,
               "collectives_per_step": per_step,
               "fsdp_gather_bytes_per_step": per_step.get(
                   "fsdp_gather", {}).get("bytes", 0),
               "reduce_scatter_bytes_per_step": per_step.get(
                   "reduce_scatter", {}).get("bytes", 0),
               "peak_allocated_bytes": peaks}
        emit(row)
        out[label] = row
    pipes = [json.loads((root / f"pipe_rank{r}.json").read_text())
             for r in range(2)]
    per_mb = sum(v for k, v in k1_step_gemms(
        dataclasses.replace(cfg, n_layers=TM_PIPE_LAYERS // 2), qcfg,
        TM_PIPE_SEQ, remat=False).items() if cfg.padded_vocab not in k[2:4])
    for p in pipes:
        if p["out_rel_l2"] > PIPE_FWD_RTOL or max(
                p["grad_rel_l2"].values()) > PIPE_RTOL or (
                p["dx_rel_l2"] is not None and p["dx_rel_l2"] > PIPE_RTOL):
            failures.append(("f", f"stage {p['stage']} off the sequential"))
        if p["launches"]["fused_quant_matmul"] != per_mb * TM_PIPE_MB:
            failures.append(("f", f"stage {p['stage']} K1 launches "
                             f"{p['launches']['fused_quant_matmul']}"))
        launches["fused_quant_matmul"] = launches.get(
            "fused_quant_matmul", 0) + p["launches"]["fused_quant_matmul"]
    emit({"phase": "train_mesh", "run": "f", "label": TM_LABEL,
          "layers": TM_PIPE_LAYERS, "microbatches": TM_PIPE_MB,
          "stages": [{k: p[k] for k in ("stage", "seconds", "out_rel_l2",
                                        "out_bitwise", "dx_rel_l2",
                                        "peak_allocated")}
                     | {"max_grad_rel_l2": max(p["grad_rel_l2"].values()),
                        "transfers": {k: p["stats"]["ops"].get(k, {}).get(
                            "calls", 0) for k in ("send", "recv")}}
                     for p in pipes]})
    emit({"phase": "train_mesh", "wall_s": wall, "card": card_line()})
    shutil.rmtree(root, ignore_errors=True)
    if failures:
        raise AssertionError(f"train_mesh phase: {failures}")
    return {"launches": launches, "runs": out, "e": e_row}


# ---- phase mesh_families: the moe and vlm families on gloo ranks ------------
#
# Full width, cut depth, each run against one process on the same seeded
# weights.  Serving (``launch.serve`` children, ranks sharing the card,
# programs eager; the one-process runs graphed): a, Mixtral-8x7B at 1 of 32
# layers, lockstep tp=2, batch 4 x 64, 32 new, nvfp4 KV; b, Qwen3-MoE at 1
# of 94 layers, ContinuousEngine tp=2, 8 slots, a 128-token shared prefix,
# prefix cache, 64-token chunks; c, InternVL2-26B at 1 of 48 layers,
# lockstep tp=2, batch 4 x (256 prefix + 64), 16 new.  Training (``Trainer``
# on spawned ranks, then one process in this one: the memory does not hold
# both): d, Mixtral at 1 layer, 1 x 1024, 3 steps at tp=2 (plus one
# process with re-drawn SR streams, for the spread rule); e, Qwen3-MoE at 1
# layer, 2 x 512, one step at fsdp=2 (the "local" route: 8 of 16 groups and
# 64 capacity rows an expert a rank).  Every run at one layer since phase
# mesh_encdec_recurrent joined the script: a, b, c, d at 4, 2, 4, 2
# before.
MF_SERVE = {
    "a": ("mixtral-8x7b", "tp=2", ["--batch", "4", "--prompt-len", "64",
                                   "--max-new", "32", "--max-len", "256",
                                   "--layers", "1"]),
    "b": ("qwen3-moe-235b-a22b", "tp=2", [
        "--queue", "8", "--max-slots", "8", "--batch", "4",
        "--shared-prefix", "128", "--prompt-len", "64", "--prefix-cache",
        "--prefill-chunk", "64", "--max-new", "32", "--max-len", "512",
        "--layers", "1"]),
    "c": ("internvl2-26b", "tp=2", ["--batch", "4", "--prompt-len", "64",
                                    "--max-new", "16", "--max-len", "384",
                                    "--layers", "1"]),
}
# the serving runs started together: the packers' build peaks (a whole
# bf16 layer and its packing temporaries in every process: ~13 GB a
# process for a Qwen3-MoE layer of 128 experts) do not fit the card at once
MF_SERVE_WAVES = (("a", "c"), ("b",))
# label: (arch, mesh shape, axes, layers, (batch, seq), steps)
MF_TRAIN = {"d": ("mixtral-8x7b", (2,), ("model",), 1, (1, 1024), 3),
            "e": ("qwen3-moe-235b-a22b", (2,), ("data",), 1, (2, 512), 1)}
# The rules, written in PERF.md before the first card run: a-c as phase
# mesh's (MESH_MARGIN, MESH_LOGITS_RTOL); d as train_mesh's for a run that
# splits a contraction over "model" (TM_LOSS0_RTOL, the later losses and
# each leaf's update within the SR envelope); e: the step-0
# loss within TM_LOSS0_RTOL and every rank's routing (expert ids, slots,
# sorted tokens, kept entries of each of its groups; G and C) equal to one
# process's; the moe layer's collectives a program call the same for E 8
# and E 128 (two: ``moe_amax``, ``moe_partials``).  Added after the first
# runs: d and e hold grad_norm and sigma_q at every step within
# max(TM_NOISE_X x their SR spread, TM_NORM_RTOL) of one process's
# (``tm_norm_check``; e has no re-drawn run: TM_NORM_RTOL), so a gradient
# counted twice or not at all on either dispatch route fails on the card.
MF_MOE_COLLECTIVES = 2


def routing_digests(log, n_layers) -> list:
    """The forward's routing records (``moe.recording``; a remat recompute
    records them again: dropped) as {route, G, C, first, groups: a sha1
    of each group's expert ids, slots, sorted tokens and kept entries}."""
    import hashlib
    out = []
    for r in log[:n_layers]:
        groups = []
        for g in r["groups"]:
            h = hashlib.sha1()
            for t in g:
                h.update(t.detach().contiguous().cpu().numpy().tobytes())
            groups.append(h.hexdigest())
        out.append({"route": r["route"], "G": r["G"], "C": r["C"],
                    "first": r["first"], "groups": groups})
    return out


def routing_equal(got, want) -> bool:
    """A rank's routing digests against one process's: per layer G, C and
    each of its groups' digest at the group's place among the G."""
    return len(got) == len(want) and all(
        (g["G"], g["C"]) == (w["G"], w["C"])
        and g["groups"] == w["groups"][g["first"]:g["first"]
                                      + len(g["groups"])]
        for g, w in zip(got, want))


def mf_setup(label):
    """(cfg, qcfg, TrainConfig, DataConfig) of training run ``label``."""
    from repro_torch.configs import get_config
    from repro_torch.core import fqt
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train import TrainConfig
    arch, _, _, layers, (batch, seq), _ = MF_TRAIN[label]
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    # e's one layer needs no remat: its recompute would gather every
    # expert's FSDP shard a third time over gloo
    return (cfg, fqt.nvfp4_paper_config(), TrainConfig(remat=label != "e"),
            DataConfig(cfg.vocab_size, seq, batch))


def mf_train(label, mesh=None, redraw=0) -> tuple:
    """Run ``label`` through ``Trainer`` (on ``mesh``, or one process;
    ``redraw``: every SR stream re-drawn, each step's seed XOR it,
    ``tm_redrawn``'s rule): (report, final flat params)."""
    import torch
    from repro_torch.kernels import counters
    from repro_torch.models import moe
    from repro_torch.train import step as step_mod
    cfg, qcfg, tcfg, data = mf_setup(label)
    steps = MF_TRAIN[label][5]
    dev = torch.device("cuda", 0)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    seed_of = step_mod.step_seed
    if redraw:
        step_mod.step_seed = lambda s: seed_of(s) ^ redraw
    try:
        tr = tm_trainer(cfg, qcfg, tcfg, data, steps, mesh)
        marks = count_steps(tr)
        if mesh is not None:
            mesh.reset_stats()
        counters.reset()
        t0 = time.perf_counter()
        with moe.recording() as log:
            state = tr.run()
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        marks.append(counters.snapshot())
    finally:
        step_mod.step_seed = seed_of
    rep = {"label": label, "seconds": seconds,
           "launches": step_launches(marks), "history": tm_history([tr]),
           "aux": [h["aux"] for h in tr.history],
           "routing": routing_digests(log, cfg.n_layers),
           "peak_allocated": torch.cuda.max_memory_allocated(dev)}
    if mesh is not None:
        rep.update(rank=mesh.rank, coords=dict(mesh.coords),
                   stats=mesh.stats)
    final = _flat_params(state.params)
    del state, tr
    return rep, final


def mf_train_child(rank, root, label) -> None:
    """A rank of training run ``label``: its report and final parameter
    shards under ``root``."""
    import torch
    from repro_torch.distributed.mesh import make_mesh
    _, shape, names, _, _, _ = MF_TRAIN[label]
    mesh = make_mesh(shape, names, device=torch.device("cuda", 0),
                     backend="gloo")
    rep, final = mf_train(label, mesh)
    torch.save({k: v.cpu() for k, v in final.items()},
               Path(root) / f"{label}_rank{rank}.pt")
    (Path(root) / f"{label}_rank{rank}.json").write_text(json.dumps(rep))


def mf_start(root: Path, label):
    """Start run ``label``'s ranks (spawned, gloo over a file rendezvous;
    the kernels built already), not waiting for them."""
    import os
    import torch.multiprocessing as mp
    from repro_torch.distributed.mesh import _rank_main
    n = math.prod(MF_TRAIN[label][1])
    # two ranks' training states fill most of the card: let the ranks'
    # allocators grow their segments in place instead of fragmenting
    key, old = "PYTORCH_CUDA_ALLOC_CONF", os.environ.get(
        "PYTORCH_CUDA_ALLOC_CONF")
    os.environ[key] = "expandable_segments:True"
    try:
        return mp.start_processes(
            _rank_main, args=(mf_train_child, n, "gloo", "cuda:0",
                              f"file://{root}/rendezvous_{label}",
                              (str(root), label)),
            nprocs=n, join=False, start_method="spawn")
    finally:
        if old is None:
            del os.environ[key]
        else:
            os.environ[key] = old


def mf_moe_collectives(rep):
    """The moe layers' batched collectives a layer and program call of a
    serving run's rank (``Mesh.stats``: "moe_amax" + "moe_partials" over
    the calls of every program that runs the layers); None without
    them."""
    ops = rep["collectives"]["ops"]
    if "moe_amax" not in ops:
        return None
    calls = sum(rep["calls"].values())
    return (ops["moe_amax"]["calls"] + ops["moe_partials"]["calls"]) / (
        calls * rep["layers"])


def phase_mesh_families(dev) -> dict:
    """The moe and vlm families on gloo ranks sharing the card; see the
    docstring at the top, MF_SERVE and MF_TRAIN."""
    import gc
    import shutil
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, counters
    from repro_torch.models import registry
    _build.build_all()              # built once: the ranks load it
    gc.collect()
    torch.cuda.empty_cache()
    root = ROOT / "build" / "mesh_families_phase"
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    emit({"phase": "mesh_families", "card": card_line(), "label": TM_LABEL,
          "card_used_mib": card_used_mib()})
    t_phase = time.perf_counter()
    failures, launches, out = [], {}, {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    # serving, runs a-c in MF_SERVE_WAVES: every mesh run beside its
    # one-process run
    logs = {}
    for wave in MF_SERVE_WAVES:
        procs = {}
        for label in wave:
            arch, mesh, args = MF_SERVE[label]
            for side in ("mesh", "one"):
                procs[(label, side)] = _launcher(
                    arch, mesh if side == "mesh" else None, args,
                    root / f"{label}_{side}")
        for key, proc in procs.items():
            try:
                logs[key], _ = proc.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                proc.kill()
                logs[key], _ = proc.communicate()
                raise AssertionError(f"mesh_families run {key} timed out:"
                                     f"\n{logs[key][-3000:]}")
            if proc.returncode != 0:
                raise AssertionError(f"mesh_families run {key} failed:\n"
                                     f"{logs[key][-3000:]}")
    serve_s = time.perf_counter() - t_phase
    moe_coll = {}
    for label, (arch, mesh, args) in MF_SERVE.items():
        layers = int(args[args.index("--layers") + 1])
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        reps = _reports(root / f"{label}_mesh", 2)
        one = _reports(root / f"{label}_one", 1)[0]
        for rep in reps:
            rep["layers"] = layers
            if rep["streams"] != reps[0]["streams"]:
                failures.append((label, f"rank {rep['rank']} streams"))
            want = mesh_expected(cfg, rep)
            if rep["launches"] != want:
                failures.append((label, f"rank {rep['rank']} launches "
                                 f"{rep['launches']} != {want}"))
            add(rep["launches"])
        if one["launches"] != mesh_expected(cfg, one):
            failures.append((label, "one-process launches"))
        cmp = mesh_compare(reps[0], one)
        if not cmp["streams_ok"]:
            failures.append((label, "stream parted at a decisive step"))
        lg = np.load(root / f"{label}_mesh" / "prefill_logits.npy")
        lw = np.load(root / f"{label}_one" / "prefill_logits.npy")
        rel = float(np.linalg.norm(lg - lw) / np.linalg.norm(lw))
        if not (np.isfinite(lg).all() and rel <= MESH_LOGITS_RTOL):
            failures.append((label, f"prefill logits rel L2 {rel}"))
        per_layer = [mf_moe_collectives(rep) for rep in reps]
        if cfg.n_experts:
            moe_coll[label] = per_layer[0]
            if any(c != MF_MOE_COLLECTIVES for c in per_layer):
                failures.append((label, f"moe collectives a layer and "
                                 f"call {per_layer}"))
        r0 = reps[0]
        steps = max(1, r0["calls"].get("decode", r0["calls"].get(
            "_decode", 1)))
        row = {"phase": "mesh_families", "run": label, "arch": arch,
               "mesh": mesh, "ranks": 2, "layers": layers,
               "cut": {"n_layers": [get_config(arch).n_layers, layers]},
               "label": TM_LABEL, **cmp, "prefill_logits_rel_l2": rel,
               "tokens": r0["tokens"], "seconds": r0["seconds"],
               "tokens_per_s": r0["tokens"] / r0["seconds"],
               "one_process_tokens_per_s": one["tokens"] / one["seconds"],
               "program_calls": r0["calls"],
               "collectives": [rep["collectives"] for rep in reps],
               "collectives_per_decode_call": r0["collectives"]["calls"]
               / steps,
               "moe_collectives_per_layer_and_call": per_layer,
               "peak_allocated_bytes": [rep["peak_allocated"]
                                        for rep in reps],
               "one_process_peak_allocated": one["peak_allocated"],
               "weight_store_bytes": [rep["weight_store_bytes"]
                                      for rep in reps],
               "launches_rank0": r0["launches"]}
        emit(row)
        out[label] = row
    if len(set(moe_coll.values())) != 1:
        failures.append(("a/b", f"moe collectives differ with E: "
                         f"{moe_coll}"))

    # training, runs d and e: the ranks, then one process (and d's
    # re-drawn one) in this process
    train_s = {}
    for label in MF_TRAIN:
        t0 = time.perf_counter()
        ctx = mf_start(root, label)
        tm_join(ctx, timeout=900)
        train_s[label] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    for label, (arch, shape, names, layers, (batch, seq),
                steps) in MF_TRAIN.items():
        cfg, qcfg, tcfg, _ = mf_setup(label)
        reps = tm_reports(root, label, 2)
        one, one_final = mf_train(label)
        spread, red, reds = None, None, []
        if label == "d":
            reds = [mf_train(label, redraw=x) for x in TM_REDRAWS]
            red = reds[0][0]
        init = _flat_params(registry.init_params(cfg, seed=SEED,
                                                 device=dev))
        if label == "d":
            spread = tm_envelope(init, [one_final] + [f for _, f in reds])
            reds = [r["history"] for r, _ in reds]
        gc.collect()
        torch.cuda.empty_cache()
        want = {k: 0 for k in counters.COUNTS}
        want.update(fused_quant_matmul=sum(k1_step_gemms(
            cfg, qcfg, batch * seq, remat=tcfg.remat).values()),
            block_quantize=tm_probe_launches(cfg, shape, names))
        want1 = dict(want, block_quantize=tm_probe_launches(cfg, (1,),
                                                            ("model",)))
        if any(c != want1 for c in one["launches"]):
            failures.append((label, f"one-process launches "
                             f"{one['launches']} != {want1}"))
        for rep in reps:
            if rep["history"] != reps[0]["history"]:
                failures.append((label, f"rank {rep['rank']} metrics"))
            if any(c != want for c in rep["launches"]):
                failures.append((label, f"rank {rep['rank']} launches "
                                 f"{rep['launches']} != {want}"))
            for c in rep["launches"]:
                add(c)
            if not routing_equal(rep["routing"], one["routing"]):
                failures.append((label, f"rank {rep['rank']} routing"))
        h, o = reps[0]["history"], one["history"]
        if abs(h[0]["loss"] - o[0]["loss"]) > TM_LOSS0_RTOL * abs(
                o[0]["loss"]):
            failures.append((label, "step-0 loss"))
        for i in range(1, steps):
            lim = tm_loss_bound(i, o, reds, TM_LOSS_RTOL)
            if abs(h[i]["loss"] - o[i]["loss"]) > lim:
                failures.append((label, f"step-{i} loss (limit {lim})"))
        norm_dev = tm_norm_check(label, h, o, red and red["history"],
                                 failures)
        upd = tm_compare_updates(label, shape, names, init, one_final, root)
        del init, one_final
        row = {"phase": "mesh_families", "run": label, "arch": arch,
               "mesh": dict(zip(names, shape)), "ranks": 2,
               "cut": {"n_layers": [get_config(arch).n_layers, layers],
                       "batch": batch, "seq": seq}, "steps": steps,
               "label": TM_LABEL,
               "routes": [r["route"] for r in reps[0]["routing"]],
               "G_C": [(r["G"], r["C"]) for r in reps[0]["routing"]],
               "rank_first_groups": [[r["first"] for r in rep["routing"]]
                                     for rep in reps],
               "routing_equal": [routing_equal(rep["routing"],
                                               one["routing"])
                                 for rep in reps],
               "loss0_bit_equal": h[0]["loss"] == o[0]["loss"],
               "losses": [x["loss"] for x in h],
               "one_process_losses": [x["loss"] for x in o],
               "aux": reps[0]["aux"], "one_process_aux": one["aux"],
               "grad_norm": [x["grad_norm"] for x in h],
               "one_process_grad_norm": [x["grad_norm"] for x in o],
               "sigma_q": [x["sigma_q"] for x in h],
               "one_process_sigma_q": [x["sigma_q"] for x in o],
               "norm_rel_dev_and_limit": norm_dev,
               "worst_update_rel_l2": max(upd.values()),
               "worst_update_leaf": max(upd, key=upd.get),
               "update_rel_l2": upd,
               "seconds": [rep["seconds"] for rep in reps],
               "rank_wall_s": train_s[label],
               "one_process_seconds": one["seconds"],
               "launches_per_step": want,
               "collectives_per_step": {
                   k: {"calls": v["calls"] / steps,
                       "bytes": v["bytes"] / steps,
                       "host_ms": v["seconds"] * 1e3 / steps}
                   for k, v in reps[0]["stats"]["ops"].items()},
               "peak_allocated_bytes": [rep["peak_allocated"]
                                        for rep in reps],
               "one_process_peak_allocated": one["peak_allocated"]}
        if spread is not None:
            bound = {p: max(TM_UPDATE_REL_L2, spread[p]) for p in upd}
            over = {p: (v, bound[p]) for p, v in upd.items()
                    if v > bound[p]}
            if over:
                failures.append((label, f"update rel L2 over its bound "
                                 f"{over}"))
            row.update(redrawn_losses=[[x["loss"] for x in r]
                                       for r in reds],
                       redrawn_grad_norm=[x["grad_norm"]
                                          for x in red["history"]],
                       redrawn_sigma_q=[x["sigma_q"]
                                        for x in red["history"]],
                       sr_envelope_of_worst_leaf=spread[max(upd,
                                                            key=upd.get)],
                       worst_update_over_bound=max(upd[p] / bound[p]
                                                   for p in upd))
        row["update_rel_l2"] = {p: upd[p] for p in sorted(
            upd, key=upd.get, reverse=True)[:8]}
        emit(row)
        out[label] = row
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "mesh_families", "wall_s": time.perf_counter() - t_phase,
          "serve_wall_s": serve_s, "train_rank_wall_s": train_s,
          "card": card_line()})
    shutil.rmtree(root, ignore_errors=True)
    if failures:
        raise AssertionError(f"mesh_families phase: {failures}")
    return {"launches": launches, "runs": out}


# ---- phase mesh_encdec_recurrent: the encdec, hybrid and ssm families on a
# mesh, gloo ranks sharing the card --------------------------------------------
#
# Serving (``launch.serve --mesh tp=2``, each run beside its one-process run;
# the eight launchers start together: these models are small): a,
# whisper-base at full depth (6 + 6 layers), the lockstep Engine, batch 4 x
# 32 with random frames, 16 new; b, whisper-base, ContinuousEngine (4 slots,
# 16-token pages, 8 requests two a tick, 32-token prompts, 16 new, random
# frames a request); c, zamba2-1.2b at 12 of 38
# layers (two shared-attention groups), lockstep 4 x 64, 32 new; d,
# xlstm-125m at full depth (12 blocks, sLSTM at 3, 7, 11), lockstep 4 x 64,
# 32 new.  Training (``Trainer`` at tp=2 on one spawned rank pair, family
# after family, while this process runs each family's one-process run and
# its two runs with re-drawn SR streams on the same card, all of it beside
# the serving runs): e, whisper-base at
# full depth, 4 x 256 (zero frames: the encoder's 4 x 1500 rows); f,
# zamba2-1.2b at 6 layers (one shared-attention group), 2 x 512; g,
# xlstm-125m at 4 layers (its sLSTM the fourth), 2 x 256; ER_STEPS steps
# each.  Depth is the only cut.  The rules, written in PERF.md before the
# card runs that test them: a-d as phase mesh's (MESH_MARGIN,
# MESH_LOGITS_RTOL); e-g: train_mesh's rules for a run that splits a
# contraction over "model" (the step-0 loss within TM_LOSS0_RTOL; the
# later losses and each leaf's update within the SR envelope of two
# re-drawn runs, ``tm_loss_bound``, ``tm_envelope``; grad_norm and sigma_q
# as ``tm_norm_check``), and each leaf's step-0 gradient (the same
# weights and batch: one backward's rounding, not three steps' growth)
# within max(TM_UPDATE_REL_L2, its envelope) but for the noise leaves,
# which both redraws move by at least ER_NOISE_SPREAD of their norm
# (whisper's key biases, whose gradient is 0 in exact arithmetic:
# reported, held by no rule); every rank's launches as derived
# (``er_expected``, ``k1_step_gemms``, ``er_probe_launches``).
ER_SERVE = {
    "a": ("whisper-base", ["--batch", "4", "--prompt-len", "32",
                           "--max-new", "16", "--max-len", "128"]),
    "b": ("whisper-base", ["--queue", "8", "--max-slots", "4", "--batch",
                           "4", "--prompt-len", "32", "--max-new", "16",
                           "--max-len", "128"]),
    "c": ("zamba2-1.2b", ["--batch", "4", "--prompt-len", "64", "--max-new",
                          "32", "--max-len", "256", "--layers", "12"]),
    "d": ("xlstm-125m", ["--batch", "4", "--prompt-len", "64", "--max-new",
                         "32", "--max-len", "256"]),
}
# label: (arch, layers (None: full depth), (batch, seq))
ER_TRAIN = {"e": ("whisper-base", None, (4, 256)),
            "f": ("zamba2-1.2b", 6, (2, 512)),
            "g": ("xlstm-125m", 4, (2, 256))}
ER_STEPS = 3
# a leaf whose step-0 gradient moves under re-drawn SR streams by at least
# its own norm (relative L2) is noise: no rule holds its direction
ER_NOISE_SPREAD = 1.0


def er_cfg(arch, layers=None):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def er_expected(cfg, rep, prompt_len) -> dict:
    """Each kernel's launches on one rank of a serving run, from its
    program calls: every rank runs every layer on its shards, so a rank
    launches what one process launches -- ``expected_launches`` for the
    ContinuousEngine, ``encdec_launches`` for whisper's lockstep run,
    ``recurrent_launches`` (a decode step per prompt token) for zamba2's
    and xLSTM's."""
    calls = rep["calls"]
    if "prefill_suffix" in calls:
        return expected_launches(cfg, {f"_{k}": v for k, v in calls.items()})
    if cfg.family == "encdec":
        return encdec_launches(cfg, calls["prefill"], calls["decode"])
    return recurrent_launches(cfg, prompt_len * calls["prefill"],
                              calls["decode"])


def er_probe_launches(cfg, shape, names) -> int:
    """K2 launches of one step's sigma_q probe on a rank of the mesh: the
    probe's rule (``train/step._estimate_sigma_q_mesh``: the reference's
    leaves of 2+ dims whose last dim takes whole blocks, one call a leaf,
    or a layer where a stacked leaf splits another dim than its last,
    ``_probe_parts``) over the rank's placed parameter tree, built on the
    meta device."""
    import torch
    from repro_torch.checkpoint.ckpt import reference_leaves
    from repro_torch.distributed import sharding
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.models import registry
    from repro_torch.train import step as step_mod
    meta = torch.device("meta")
    mesh = Mesh(shape, names, device=meta)
    params = sharding.place_train_params(registry.init_params(
        cfg, generator=torch.Generator(), device=meta), mesh)
    spec = probe_spec_of(step_mod.TrainConfig())
    n = 0
    for name, group, stacked in reference_leaves(params):
        part = group[0]
        pspec = sharding.placed_spec(step_mod._leaf_key(name), part.ndim,
                                     mesh)
        full = sharding.shard_offsets(pspec, part.shape, mesh)[0]
        if part.ndim + int(stacked) < 2 or full[-1] % spec.block:
            continue
        n += len(step_mod._probe_parts(group, stacked, pspec, mesh))
    return n


def er_setup(label, seed=SEED):
    """(cfg, qcfg, TrainConfig, DataConfig) of training run ``label``, its
    data stream that of ``seed`` (seed 0: the default stream)."""
    from repro_torch.core import fqt
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train import TrainConfig
    arch, layers, (batch, seq) = ER_TRAIN[label]
    cfg = er_cfg(arch, layers)
    return (cfg, fqt.nvfp4_paper_config(), TrainConfig(remat=True),
            DataConfig(cfg.vocab_size, seq, batch,
                       seed=DataConfig.seed + seed))


def er_train(label, mesh=None, redraw=0, seed=SEED, masters=False) -> tuple:
    """Run ``label`` through ``Trainer`` (on ``mesh``, or one process) from
    the weights and data of ``seed``; ``redraw``: every SR stream re-drawn
    (each step's seed XOR ``redraw``, ``tm_redrawn``'s rule).  Returns
    (report, trees): flat dicts of CPU tensors (this rank's shards on a
    mesh) -- "params" the final parameters, "grad0" the step-0 gradients
    (``loss_and_grads``' first, on the initial weights: the step's LR is
    0, so they enter only AdamW's moments) and, with ``masters``, "master"
    AdamW's final f32 master weights."""
    import torch
    from repro_torch.kernels import counters
    from repro_torch.train import step as step_mod
    cfg, qcfg, tcfg, data = er_setup(label, seed)
    dev = torch.device("cuda", 0)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    seed_of, grads_of, grad0 = step_mod.step_seed, step_mod.loss_and_grads, {}

    def first(*a, **kw):
        out = grads_of(*a, **kw)
        if not grad0:
            grad0.update({k: v.clone() for k, v in _flat_params(
                out[2]).items()})
        return out
    if redraw:
        step_mod.step_seed = lambda s: seed_of(s) ^ redraw
    step_mod.loss_and_grads = first
    try:
        tr = tm_trainer(cfg, qcfg, tcfg, data, ER_STEPS, mesh, seed=seed)
        marks = count_steps(tr)
        if mesh is not None:
            mesh.reset_stats()
        counters.reset()
        t0 = time.perf_counter()
        state = tr.run()
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        marks.append(counters.snapshot())
    finally:
        step_mod.step_seed, step_mod.loss_and_grads = seed_of, grads_of
    rep = {"label": label, "seconds": seconds,
           "step_ms": [h["dt"] * 1e3 for h in tr.history],
           "launches": step_launches(marks), "history": tm_history([tr]),
           "peak_allocated": torch.cuda.max_memory_allocated(dev)}
    if mesh is not None:
        rep.update(rank=mesh.rank, coords=dict(mesh.coords),
                   stats=mesh.stats)
    trees = {"params": _flat_params(state.params), "grad0": grad0}
    if masters:
        trees["master"] = _flat_params(state.opt.master)
    trees = {k: {p: v.cpu() for p, v in t.items()} for k, t in trees.items()}
    del state, tr, grad0
    return rep, trees


def er_train_child(rank, root, seed, masters) -> None:
    """A rank of the training runs e-g, one after the other on one tp=2
    mesh: each run's report and trees (``er_train``) under ``root``."""
    import gc
    import torch
    from repro_torch.distributed.mesh import make_mesh
    mesh = make_mesh((2,), ("model",), device=torch.device("cuda", 0),
                     backend="gloo")
    for label in ER_TRAIN:
        rep, trees = er_train(label, mesh, seed=seed, masters=masters)
        for kind, tree in trees.items():
            torch.save(tree, Path(root) / f"{label}_{kind}_rank{rank}.pt")
        (Path(root) / f"{label}_rank{rank}.json").write_text(json.dumps(rep))
        del trees
        gc.collect()
        torch.cuda.empty_cache()


def er_start(root: Path, seed, masters):
    """Start the training ranks (spawned, gloo over a file rendezvous; the
    kernels built already), not waiting for them."""
    import torch.multiprocessing as mp
    from repro_torch.distributed.mesh import _rank_main
    return mp.start_processes(
        _rank_main, args=(er_train_child, 2, "gloo", "cuda:0",
                          f"file://{root}/rendezvous_er",
                          (str(root), seed, masters)),
        nprocs=2, join=False, start_method="spawn")


def er_one_process(label, dev, seed, probe) -> dict:
    """Run ``label``'s one-process runs in this process: "one", "red" and
    "red2" (every SR stream re-drawn, TM_REDRAWS) and, for ``probe``,
    "repeat" (the one-process run again), each (report, trees), with its
    f32 masters for ``probe``; plus "init", the initial parameters (flat,
    on the CPU)."""
    import gc
    import torch
    from repro_torch.models import registry
    runs = {"one": er_train(label, seed=seed, masters=bool(probe))}
    for key, x in zip(("red", "red2"), TM_REDRAWS):
        runs[key] = er_train(label, redraw=x, seed=seed, masters=bool(probe))
    if probe:
        runs["repeat"] = er_train(label, seed=seed, masters=True)
    runs["init"] = {k: v.cpu() for k, v in _flat_params(registry.init_params(
        er_setup(label)[0], seed=seed, device=dev)).items()}
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def er_probe(label, runs, root) -> dict:
    """``--er-probe``: every leaf's relative L2 of the final parameters'
    and the f32 masters' updates and of the step-0 gradients, each
    [mesh, repeat, red, red2] against the one-process run and red2
    against red, and each run's losses."""
    init = runs["init"]
    one = runs["one"][1]
    out = {"losses": {k: [h["loss"] for h in runs[k][0]["history"]]
                      for k in ("one", "red", "repeat", "red2")}}
    for kind in ("params", "master", "grad0"):
        i0 = None if kind == "grad0" else init
        cols = [tm_compare_updates(label, (2,), ("model",), i0, one[kind],
                                   root, kind=kind)]
        cols += [tm_update_rel_l2(i0, one[kind], runs[k][1][kind])
                 for k in ("repeat", "red", "red2")]
        cols.append(tm_update_rel_l2(i0, runs["red"][1][kind],
                                     runs["red2"][1][kind]))
        out[kind] = {p: [c[p] for c in cols] for p in cols[0]}
    return out


def er_hold(label, runs, root, seed, failures, add, probe=None) -> dict:
    """Training run ``label``'s ranks (their reports and trees under
    ``root``) against its one-process ``runs`` (``er_one_process``): each
    miss appended to ``failures``, each rank's launches passed to
    ``add``; ``probe`` a dict to fill with ``er_probe``'s tables.  Returns
    the run's row."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import counters
    arch, layers, (batch, seq) = ER_TRAIN[label]
    cfg, qcfg, tcfg, _ = er_setup(label)
    (one, one_t), init = runs["one"], runs["init"]
    reds = [runs["red"], runs["red2"]]
    reps = tm_reports(root, label, 2)
    want = {k: 0 for k in counters.COUNTS}
    want.update(fused_quant_matmul=sum(k1_step_gemms(
        cfg, qcfg, batch * seq, remat=tcfg.remat,
        enc_tokens=batch * cfg.enc_seq).values()),
        block_quantize=er_probe_launches(cfg, (2,), ("model",)))
    want1 = dict(want, block_quantize=er_probe_launches(cfg, (1,),
                                                        ("model",)))
    for r in [one] + [r for r, _ in reds]:
        if any(c != want1 for c in r["launches"]):
            failures.append((label, f"one-process launches "
                             f"{r['launches']} != {want1}"))
    for rep in reps:
        if rep["history"] != reps[0]["history"]:
            failures.append((label, f"rank {rep['rank']} metrics"))
        if any(c != want for c in rep["launches"]):
            failures.append((label, f"rank {rep['rank']} launches "
                             f"{rep['launches']} != {want}"))
        for c in rep["launches"]:
            add(c)
    h, o = reps[0]["history"], one["history"]
    rhs = [r["history"] for r, _ in reds]
    if abs(h[0]["loss"] - o[0]["loss"]) > TM_LOSS0_RTOL * abs(
            o[0]["loss"]):
        failures.append((label, "step-0 loss"))
    for i in range(1, ER_STEPS):
        lim = tm_loss_bound(i, o, rhs, TM_LOSS_RTOL)
        if abs(h[i]["loss"] - o[i]["loss"]) > lim:
            failures.append((label, f"step-{i} loss (limit {lim})"))
    norm_dev = tm_norm_check(label, h, o, rhs[0], failures)
    # the step-0 gradients (the same weights and batch): a leaf that
    # both re-drawn runs move by at least its own norm is noise (whisper's
    # key biases: 0 in exact arithmetic), its direction held by no rule
    g1 = [t["grad0"] for _, t in reds]
    away = [tm_update_rel_l2(None, one_t["grad0"], g) for g in g1]
    noise = sorted(p for p in away[0]
                   if min(a[p] for a in away) >= ER_NOISE_SPREAD)
    genv = tm_update_rel_l2(None, g1[0], g1[1])
    genv = {p: max(v, *(a[p] for a in away)) for p, v in genv.items()}
    grad0 = tm_compare_updates(label, (2,), ("model",), None,
                               one_t["grad0"], root, kind="grad0")
    gbound = {p: max(TM_UPDATE_REL_L2, genv[p]) for p in grad0
              if p not in noise}
    over = {p: (grad0[p], b) for p, b in gbound.items() if grad0[p] > b}
    if over:
        failures.append((label, f"step-0 gradient over its bound {over}"))
    spread = tm_envelope(init, [one_t["params"]]
                         + [t["params"] for _, t in reds])
    upd = tm_compare_updates(label, (2,), ("model",), init,
                             one_t["params"], root, kind="params")
    bound = {p: max(TM_UPDATE_REL_L2, spread[p]) for p in upd
             if p not in noise}
    over = {p: (upd[p], b) for p, b in bound.items() if upd[p] > b}
    if over:
        failures.append((label, f"update rel L2 over its bound {over}"))
    if probe is not None:
        probe[label] = er_probe(label, runs, root)
    del runs, one_t, reds, g1
    worst = max(bound, key=lambda p: upd[p] / bound[p])
    gworst = max(gbound, key=lambda p: grad0[p] / gbound[p])
    row = {"phase": "mesh_encdec_recurrent", "run": label, "arch": arch,
           "mesh": {"model": 2}, "ranks": 2,
           "cut": {"n_layers": [get_config(arch).n_layers,
                                cfg.n_layers],
                   "batch": batch, "seq": seq}, "steps": ER_STEPS,
           "seed": seed, "label": TM_LABEL,
           "loss0_bit_equal": h[0]["loss"] == o[0]["loss"],
           "losses": [x["loss"] for x in h],
           "one_process_losses": [x["loss"] for x in o],
           "redrawn_losses": [[x["loss"] for x in r] for r in rhs],
           "grad_norm": [x["grad_norm"] for x in h],
           "one_process_grad_norm": [x["grad_norm"] for x in o],
           "sigma_q": [x["sigma_q"] for x in h],
           "one_process_sigma_q": [x["sigma_q"] for x in o],
           "norm_rel_dev_and_limit": norm_dev,
           "noise_leaves": {p: [a[p] for a in away] for p in noise},
           "grad0_worst_over_bound": [gworst, grad0[gworst],
                                      gbound[gworst]],
           "grad0_max_rel_l2": max(grad0[p] for p in gbound),
           "update_worst_over_bound": [worst, upd[worst], bound[worst]],
           "update_over_0.9_envelope": {
               p: [upd[p], spread[p]] for p in upd
               if upd[p] > 0.9 * spread[p] and p not in noise},
           "update_rel_l2": {p: upd[p] for p in sorted(
               upd, key=upd.get, reverse=True)[:8]},
           "step_ms": [rep["step_ms"] for rep in reps],
           "one_process_step_ms": one["step_ms"],
           "launches_per_step": want,
           "collectives_per_step": {
               k: {"calls": v["calls"] / ER_STEPS,
                   "bytes": v["bytes"] / ER_STEPS,
                   "host_ms": v["seconds"] * 1e3 / ER_STEPS}
               for k, v in reps[0]["stats"]["ops"].items()},
           "peak_allocated_bytes": [rep["peak_allocated"]
                                    for rep in reps],
           "one_process_peak_allocated": one["peak_allocated"]}
    return row


def phase_mesh_encdec_recurrent(dev, seed=SEED, probe=None) -> dict:
    """The encdec, hybrid and ssm families on gloo ranks sharing the card;
    see the docstring at the top, ER_SERVE and ER_TRAIN.  ``seed``: the
    training runs' weights and data (``--er-seed``); ``probe``: a file
    for ``er_probe``'s tables (``--er-probe``)."""
    import gc
    import shutil
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    _build.build_all()              # built once: the ranks load it
    gc.collect()
    torch.cuda.empty_cache()
    root = ROOT / "build" / "mesh_encdec_recurrent_phase"
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    emit({"phase": "mesh_encdec_recurrent", "card": card_line(),
          "label": TM_LABEL, "card_used_mib": card_used_mib(),
          "train_seed": seed})
    t_phase = time.perf_counter()
    failures, launches, out = [], {}, {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    # every run at once: the serving runs a-d (each mesh run beside its
    # one-process run), the training ranks (e-g one after the other) and,
    # in this process, each training run's one-process runs: the card
    # idles under gloo's host-staged collectives
    procs, logs = {}, {}
    for label, (arch, args) in ER_SERVE.items():
        for side in ("mesh", "one"):
            procs[(label, side)] = _launcher(
                arch, "tp=2" if side == "mesh" else None, args,
                root / f"{label}_{side}")
    ctx = er_start(root, seed, bool(probe))
    ones = {label: er_one_process(label, dev, seed, probe)
            for label in ER_TRAIN}
    probes = {} if probe else None
    for key, proc in procs.items():
        try:
            logs[key], _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            logs[key], _ = proc.communicate()
            raise AssertionError(f"mesh_encdec_recurrent run {key} timed "
                                 f"out:\n{logs[key][-3000:]}")
        if proc.returncode != 0:
            raise AssertionError(f"mesh_encdec_recurrent run {key} failed:"
                                 f"\n{logs[key][-3000:]}")
    serve_s = time.perf_counter() - t_phase
    for label, (arch, args) in ER_SERVE.items():
        layers = (int(args[args.index("--layers") + 1])
                  if "--layers" in args else None)
        cfg = er_cfg(arch, layers)
        plen = int(args[args.index("--prompt-len") + 1])
        reps = _reports(root / f"{label}_mesh", 2)
        one = _reports(root / f"{label}_one", 1)[0]
        for rep in reps:
            if rep["streams"] != reps[0]["streams"]:
                failures.append((label, f"rank {rep['rank']} streams"))
            want = er_expected(cfg, rep, plen)
            if rep["launches"] != want:
                failures.append((label, f"rank {rep['rank']} launches "
                                 f"{rep['launches']} != {want}"))
            add(rep["launches"])
        if one["launches"] != er_expected(cfg, one, plen):
            failures.append((label, "one-process launches"))
        cmp = mesh_compare(reps[0], one)
        if not cmp["streams_ok"]:
            failures.append((label, "stream parted at a decisive step"))
        lg = np.load(root / f"{label}_mesh" / "prefill_logits.npy")
        lw = np.load(root / f"{label}_one" / "prefill_logits.npy")
        rel = float(np.linalg.norm(lg - lw) / np.linalg.norm(lw))
        if not (np.isfinite(lg).all() and rel <= MESH_LOGITS_RTOL):
            failures.append((label, f"prefill logits rel L2 {rel}"))
        r0 = reps[0]
        steps = max(1, r0["calls"]["decode"])
        row = {"phase": "mesh_encdec_recurrent", "run": label, "arch": arch,
               "mesh": "tp=2", "ranks": 2, "layers": cfg.n_layers,
               "cut": {"n_layers": [get_config(arch).n_layers,
                                    cfg.n_layers]},
               "label": TM_LABEL, **cmp, "prefill_logits_rel_l2": rel,
               "tokens": r0["tokens"], "seconds": r0["seconds"],
               "tokens_per_s": r0["tokens"] / r0["seconds"],
               "one_process_tokens_per_s": one["tokens"] / one["seconds"],
               "program_calls": r0["calls"],
               "collectives": [rep["collectives"] for rep in reps],
               "collectives_per_decode_call": r0["collectives"]["calls"]
               / (steps + r0["calls"].get("prefill", 0) * (
                   plen if cfg.family in ("hybrid", "ssm") else 1)),
               "peak_allocated_bytes": [rep["peak_allocated"]
                                        for rep in reps],
               "one_process_peak_allocated": one["peak_allocated"],
               "weight_store_bytes": [rep["weight_store_bytes"]
                                      for rep in reps],
               "launches_rank0": r0["launches"]}
        emit(row)
        out[label] = row

    # training, runs e-g: the ranks' reports
    tm_join(ctx, timeout=900)
    train_s = time.perf_counter() - t_phase
    for label in ER_TRAIN:
        out[label] = er_hold(label, ones.pop(label), root, seed, failures,
                             add, probe=probes)
        emit(out[label])
    emit({"phase": "mesh_encdec_recurrent",
          "wall_s": time.perf_counter() - t_phase, "serve_wall_s": serve_s,
          "train_wall_s": train_s, "launches_main_path": launches,
          "card": card_line()})
    shutil.rmtree(root, ignore_errors=True)
    if probe:
        Path(probe).parent.mkdir(parents=True, exist_ok=True)
        Path(probe).write_text(json.dumps(probes))
    if failures:
        raise AssertionError(f"mesh_encdec_recurrent phase: {failures}")
    return {"launches": launches, "runs": out}


# (name, K, N, M, row-parallel): K1's shard shapes (k1_tp_checks)
K1_TP_CASES = (
    ("wq", 4096, 4096, 1024, False), ("w_gate", 4096, 11008, 1024, False),
    ("wo", 4096, 4096, 1024, True), ("w_down", 11008, 4096, 1024, True),
    # a Mixtral expert's at its 320 capacity rows
    ("expert w_gate", 4096, 14336, 320, False),
    ("expert w_down", 14336, 4096, 320, True),
    ("whisper w_in", 512, 2048, 6000, False),
    ("whisper w_out", 2048, 512, 6000, True),
    ("whisper head", 512, 51968, 1024, False),
    ("zamba2 in_proj", 2048, 8384, 1024, False),
    ("zamba2 out_proj", 4096, 2048, 1024, True),
    ("zamba2 shared wq", 2048, 2048, 1024, False),
    ("zamba2 shared w_down", 8192, 2048, 1024, True),
    ("xlstm w_up", 768, 3072, 512, False),
    ("xlstm w_q", 1536, 1536, 512, False),
    ("xlstm w_down", 1536, 768, 512, True))


def k1_tp_checks(dev, check) -> dict:
    """K1 with given global maxima (``a_amax`` / ``b_amax``) at llama2-7b's
    tp=2 shard shapes of the train_mesh phase (M = 1024 tokens), at a
    Mixtral expert's of phase mesh_families (M = 320 capacity rows) and at
    the encdec, hybrid and ssm families' of phase mesh_encdec_recurrent
    (whisper's w_in and w_out at its encoder's 4 x 1500 rows and its tied
    head, N 25984 of 51968, at 4 x 256; zamba2's in_proj and out_proj and
    its shared block's wq and w_down at 2 x 512; xLSTM's w_up, w_q and
    w_down at 2 x 256): for each column weight (N split) and row weight
    (K split),
    every rank's forward, dX and dW as ``core/fqt._ShardedFP4Matmul``
    launches them (the global maxima, the counters offset into the whole
    operand's bits: ``formats.counter_at``) against the plain version
    given the same (the tensor-core rule), and against the 1-device K1: a
    GEMM whose contraction is whole on the rank (column forward and dW,
    row dX and dW) bit for bit against the 1-device output's block, a pair
    of partial products (column dX, row forward) summed in f32, as
    ``fqt._shard_gemm``'s all-reduce sums them, within the same rule over
    the full contraction; and the f32 route (E3M4 data) with given maxima
    against its plain version."""
    import torch
    from repro_torch.core import formats, fqt
    from repro_torch.core.quantize import BlockQuantSpec
    from repro_torch.kernels import fp4_matmul as fm
    qc = fqt.nvfp4_paper_config()
    seed = 0x9E3779B1
    out = {"cases": 0, "bitwise": 0, "pair_max_abs_err": 0.0,
           "amax_max_abs_err": 0.0}

    def site(s):
        return fqt._site_seed32(seed, s)

    def ctr(spec, s, off, rs, cs):
        return ((formats.counter_at(site(s), off), rs, cs)
                if spec.stochastic else None)

    def amax(t):
        return torch.amax(torch.abs(t.float())).reshape(1)

    def k1(a, b, sa, sb, ca, cb, aa, ab, dt):
        got = fm.fused_quant_matmul(a.contiguous(), b.contiguous(), sa, sb,
                                    out_dtype=dt, a_counter=ca, b_counter=cb,
                                    a_amax=aa, b_amax=ab)
        want = fm.fused_quant_matmul_plain(
            a.contiguous(), b.contiguous(), sa, sb, out_dtype=dt,
            a_counter=ca, b_counter=cb, a_amax=aa, b_amax=ab)
        return got, want

    for name, K, N, M, row in K1_TP_CASES:
        g_ = gen(dev, SEED + K + N)
        x = (torch.randn((M, K), generator=g_, device=dev) * 2
             ).to(torch.bfloat16)
        w = (torch.randn((K, N), generator=g_, device=dev) * K ** -0.5
             ).to(torch.bfloat16)
        gr = (torch.randn((M, N), generator=g_, device=dev) * 1e-3
              ).to(torch.bfloat16)
        calls = (  # (a, b, specs, sites, a strides, GEMM's global K)
            ("fwd", x, w, qc.fwd_a, qc.fwd_w, (0, 1)),
            ("dX", gr, w.T, qc.bwd_g, qc.bwd_w, (2, 3)),
            ("dW", x.T, gr, qc.upd_a, qc.upd_g, (4, 5)))
        one = {}
        for role, a, b, sa, sb, (s1, s2) in calls:
            rs_a = (1, K) if role == "dW" else (a.shape[1], 1)
            ca = ctr(sa, s1, 0, *rs_a)
            cb = ctr(sb, s2, 0, b.shape[1], 1)
            for dt in (torch.bfloat16, torch.float32):
                one[role, dt] = fm.fused_quant_matmul(
                    a.contiguous(), b.contiguous(), sa, sb, out_dtype=dt,
                    a_counter=ca, b_counter=cb)
        parts = {}
        for r in range(2):
            if row:
                k0, Kl = r * (K // 2), K // 2
                ks = slice(k0, k0 + Kl)
                shard = (
                    ("fwd", x[:, ks], w[ks], qc.fwd_a, qc.fwd_w, (0, 1),
                     (k0, K, 1), (k0 * N, N, 1), amax(x), amax(w), "pair"),
                    ("dX", gr, w.T[:, ks], qc.bwd_g, qc.bwd_w, (2, 3),
                     (0, N, 1), (k0, K, 1), None, amax(w), (slice(None), ks)),
                    ("dW", x.T[ks], gr, qc.upd_a, qc.upd_g, (4, 5),
                     (k0, 1, K), (0, N, 1), amax(x), None, (ks, slice(None))))
            else:
                n0, Nl = r * (N // 2), N // 2
                ns = slice(n0, n0 + Nl)
                shard = (
                    ("fwd", x, w[:, ns], qc.fwd_a, qc.fwd_w, (0, 1),
                     (0, K, 1), (n0, N, 1), None, amax(w),
                     (slice(None), ns)),
                    ("dX", gr[:, ns], w.T[ns], qc.bwd_g, qc.bwd_w, (2, 3),
                     (n0, N, 1), (n0 * K, K, 1), amax(gr), amax(w), "pair"),
                    ("dW", x.T, gr[:, ns], qc.upd_a, qc.upd_g, (4, 5),
                     (0, 1, K), (n0, N, 1), None, amax(gr),
                     (slice(None), ns)))
            for (role, a, b, sa, sb, (s1, s2), (oa, ra, qa), (ob, rb, qb),
                 aa, ab, where) in shard:
                ca, cb = ctr(sa, s1, oa, ra, qa), ctr(sb, s2, ob, rb, qb)
                dt = torch.float32 if where == "pair" else torch.bfloat16
                got, want = k1(a, b, sa, sb, ca, cb, aa, ab, dt)
                torch.cuda.synchronize(dev)
                rb_ = (None if cb is None else
                       fm.counter_rbits(b.shape, cb, dev))
                ra_ = (None if ca is None else
                       fm.counter_rbits(a.shape, ca, dev))
                ad, tsa = fm._quantized_operand(a, sa, ra_, along_rows=False,
                                                amax=aa)
                bd, tsb = fm._quantized_operand(b, sb, rb_, along_rows=True,
                                                amax=ab)
                case = (f"tp=2 {name} rank {r} {role} M={a.shape[0]} "
                        f"K={a.shape[1]} N={b.shape[1]} a_amax="
                        f"{aa is not None} b_amax={ab is not None} "
                        f"{str(dt)[6:]}")
                check(fm.FUSED_NAME, case, got, want,
                      lambda g, w_, o=(ad, bd, tsa * tsb):
                      compare_tc(g, w_, *o))
                out["amax_max_abs_err"] = max(out["amax_max_abs_err"], float(
                    (got.float() - want.float()).abs().max()))
                out["cases"] += 1
                if where == "pair":
                    parts.setdefault(role, []).append(got)
                else:
                    check(fm.FUSED_NAME, case + " vs 1-device block", got,
                          one[role, dt][where].contiguous(), compare_bits)
                    out["bitwise"] += 1
                del got, want, ad, bd
        for role, (p0, p1) in parts.items():
            a, b, sa, sb, (s1, s2) = next(
                (c[1], c[2], c[3], c[4], c[5]) for c in calls
                if c[0] == role)
            rs_a = (a.shape[1], 1)
            ra_ = (None if not sa.stochastic else fm.counter_rbits(
                a.shape, ctr(sa, s1, 0, *rs_a), dev))
            rb_ = (None if not sb.stochastic else fm.counter_rbits(
                b.shape, ctr(sb, s2, 0, b.shape[1], 1), dev))
            ops = k1_operands(a.contiguous(), b.contiguous(), sa, sb, ra_,
                              rb_)
            pair = p0 + p1
            check(fm.FUSED_NAME, f"tp=2 {name} {role} pair summed vs "
                  f"1-device", pair, one[role, torch.float32],
                  lambda g, w_, o=ops: compare_tc(g, w_, *o))
            out["pair_max_abs_err"] = max(out["pair_max_abs_err"], float(
                (pair - one[role, torch.float32]).abs().max()))
            out["cases"] += 1
            del ops, pair
        del x, w, gr, one, parts
    # the f32 route with given maxima
    e3m4 = BlockQuantSpec(data_fmt="e3m4", scale_fmt="e4m3", block=16,
                          two_level=True, stochastic=True)
    g_ = gen(dev, SEED + 11)
    a = torch.randn((512, 256), generator=g_, device=dev).to(torch.bfloat16)
    b = torch.randn((256, 384), generator=g_, device=dev).to(torch.bfloat16)
    aa, ab = amax(a) * 2, amax(b) * 4       # a larger global max
    got, want = k1(a, b, e3m4, e3m4, (SEED, 256, 1), (SEED + 1, 384, 1), aa,
                   ab, torch.float32)
    torch.cuda.synchronize(dev)
    check(fm.FUSED_NAME, "e3m4 f32 route a_amax b_amax", got, want)
    out["cases"] += 1
    return out


def k2_mesh_checks(dev, check) -> dict:
    """K2 on the training mesh's new call shapes, bit for bit: at
    ``GRAD_FP8`` (E4M3 codes and block-32 scales, SR in counter mode, a
    given tensor scale) on a column shard of a (4096, 4096) gradient and on
    a replicated leaf flattened to one row, each against its plain
    version; and the sigma_q probe's shards against the 1-device probe's
    K2 call: a row-split stacked leaf (2, 4096, 4096) one call per layer
    part, a column-split one on its stacked rows, each with the leaf's
    tensor scale and its offset counter, equal to the 1-device call's
    block."""
    import torch
    from repro_torch.core import formats
    from repro_torch.core.quantize import NVFP4, _tensor_scale
    from repro_torch.distributed.compression import GRAD_FP8
    from repro_torch.kernels import nvfp4_quant as nq
    out = {"cases": 0}
    g_ = gen(dev, SEED + 21)
    full = torch.randn((4096, 4096), generator=g_, device=dev) * 1e-3
    ts = _tensor_scale(torch.amax(torch.abs(full)), GRAD_FP8).reshape(1)
    for label, x, c in (
            ("column shard (4096, 2048) of (4096, 4096)",
             full[:, 2048:].contiguous(),
             (formats.counter_at(SEED, 2048), 4096, 1)),
            ("replicated leaf (1, 4096)", full[:1].contiguous(),
             (SEED + 1, 4096, 1))):
        kw = dict(tscale=ts, counter=c)
        got = nq.block_quantize(x, GRAD_FP8, **kw)
        want = nq.block_quantize_plain(x, GRAD_FP8, **kw)
        torch.cuda.synchronize(dev)
        check(nq.NAME, f"GRAD_FP8 {label} codes", got[0], want[0],
              compare_bits)
        check(nq.NAME, f"GRAD_FP8 {label} scales", got[1], want[1],
              compare_bits)
        out["cases"] += 2
    spec = NVFP4.with_rounding(stochastic=True)
    L, K, N = 2, 4096, 4096
    stacked = torch.randn((L, K, N), generator=g_, device=dev) * 1e-3
    ts = _tensor_scale(torch.amax(torch.abs(stacked)), spec).reshape(1)
    codes, scales = nq.block_quantize(stacked.reshape(-1, N), spec,
                                      tscale=ts, counter=(SEED + 2, N, 1))
    codes, scales = codes.view(L, K, N), scales.view(L, K, N // 16)
    for r in range(2):
        for l in range(L):         # row split: one call per layer part
            rows = slice(r * K // 2, (r + 1) * K // 2)
            off = l * K * N + r * (K // 2) * N
            got = nq.block_quantize(stacked[l, rows].contiguous(), spec,
                                    tscale=ts, counter=(formats.counter_at(
                                        SEED + 2, off), N, 1))
            torch.cuda.synchronize(dev)
            case = f"probe row shard rank {r} layer {l}"
            check(nq.NAME, case + " codes vs 1-device", got[0],
                  codes[l, rows].contiguous(), compare_bits)
            check(nq.NAME, case + " scales vs 1-device", got[1],
                  scales[l, rows].contiguous(), compare_bits)
            out["cases"] += 2
        cols = slice(r * N // 2, (r + 1) * N // 2)
        got = nq.block_quantize(stacked[:, :, cols].reshape(-1, N // 2)
                                .contiguous(), spec, tscale=ts,
                                counter=(formats.counter_at(
                                    SEED + 2, r * N // 2), N, 1))
        torch.cuda.synchronize(dev)
        case = f"probe column shard rank {r} (stacked rows)"
        check(nq.NAME, case + " codes vs 1-device", got[0],
              codes[:, :, cols].reshape(-1, N // 2).contiguous(),
              compare_bits)
        check(nq.NAME, case + " scales vs 1-device", got[1],
              scales[:, :, r * N // 32:(r + 1) * N // 32].reshape(
                  -1, N // 32).contiguous(), compare_bits)
        out["cases"] += 2
    return out


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


def breakdown_child(case, lock=None) -> None:
    """Child process of phase times: print one JSON line, the per-launch
    breakdown of BREAKDOWNS[case] beside the call's CUDA-event time.
    ``lock``: a file whose exclusive lock the child takes after its
    imports and CUDA context, so children started together measure one at
    a time (released at exit)."""
    import torch
    dev = torch.device("cuda", 0)
    torch.cuda.init()
    if lock is not None:
        import fcntl
        held = open(lock, "a")
        fcntl.flock(held, fcntl.LOCK_EX)
    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    with torch.no_grad():
        fn = breakdown_call(case, dev)
        out = launch_breakdown(fn, flush, time_ms(fn, flush, reps=10),
                               last=BREAKDOWNS[case][1])
    print(json.dumps(out), flush=True)


def start_breakdown_child(case, lock: Path):
    """A fresh child process measuring BREAKDOWNS[case] once it holds
    ``lock`` (``breakdown_child``)."""
    return subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; chip_smoke."
         f"breakdown_child({case!r}, {str(lock)!r})"], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def breakdown_in_child(case, lock: Path, first=None, children=2) -> dict:
    """BREAKDOWNS[case] from a fresh child process (``first``, started
    already, or a new one); a second child where the first one's profiler
    recorded no consistent session (it has come back with no device event
    at all)."""
    for _ in range(children):
        proc = first if first is not None else start_breakdown_child(case,
                                                                     lock)
        first = None
        try:
            stdout, stderr = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise AssertionError(f"breakdown {case!r} timed out")
        if proc.returncode != 0:
            raise AssertionError(f"breakdown {case!r} failed:\n"
                                 f"{stderr[-3000:]}")
        out = json.loads(stdout.strip().splitlines()[-1])
        if out["consistent"]:
            break
    return out


# M of K4's route times: decode (1-8) to chunk prefill (64)
K4_CROSS_M = (1, 4, 8, 16, 32, 64)


def phase_times(dev, full=False) -> dict:
    """Phase times (SUMMARY's cases), or times_full (``full``: every case,
    K4's crossover, GELU and the per-launch breakdowns)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.quantize import NVFP4, _tensor_scale, kv_dequant
    from repro_torch.kernels import flash_attn as fa
    from repro_torch.kernels import fp4_matmul as fm
    from repro_torch.kernels import nvfp4_quant as nq
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)  # 256 MB
    rows = {}
    summary = {(n, c[0]) for n, c in SUMMARY.items()}

    def record(name, case, kernel, plain, library, nbytes, ops, reps=20,
               **extra):
        if not full and (name, case) not in summary:
            return None
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
        for M, K, N in K4_SHAPES + K4_CONT_SHAPES + K4_RECURRENT + K4_ENCDEC:
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
        for K, N, _ in (K4_WEIGHTS if full else ()):
            for M in K4_CROSS_M:
                a, w = k4_inputs(M, K, N, dev)
                cross[f"{M} {K} {N}"] = {route: time_ms(
                    lambda: fm._k4_launch(a, w.packed, w.scales, w.tscale,
                                          NVFP4, w.block, None,
                                          torch.bfloat16, route), flush)
                    for route in ("gemv", "core")}
                del a, w
        if full:
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
        # K6 on run c's rolling caches (Mixtral, GQA): batch 4 over a
        # 256-row buffer, and the long request's 4096-row buffer mid-decode
        for B, H, KVH, D, Sk, n in K6_ROLL_TIMES:
            q, kc, ks, vc, vs, pos = k6_inputs(B, H, KVH, D, Sk, None,
                                               torch.bfloat16, dev,
                                               written=n)
            kv_len = min(n, Sk)
            kd = kv_dequant(kc[:, :kv_len], ks[:, :kv_len], "nvfp4")
            vd = kv_dequant(vc[:, :kv_len], vs[:, :kv_len], "nvfp4")
            G = H // KVH
            qt = q.transpose(1, 2)
            kt = kd.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
            vt = vd.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
            nbytes = (2 * B * H * D * 2 + 8
                      + 2 * B * kv_len * KVH * (D // 2 + D // 16))
            record(fa.PACKED_NAME, ("rolling", B, H, KVH, D, Sk, n),
                   lambda: fa.flash_attention_packed(
                       q, kc, ks, vc, vs, pos, window=Sk, rolling=True),
                   lambda: fa.flash_attention_packed_plain(
                       q, kc, ks, vc, vs, pos, window=Sk, rolling=True),
                   lambda: F.scaled_dot_product_attention(qt, kt, vt),
                   nbytes, 4 * B * H * kv_len * D,
                   plan=fa.k6_plan(1, H, KVH, D, Sk))
            del q, kc, ks, vc, vs, kd, vd, qt, kt, vt
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
        # K7 non-causal on whisper's encoder and cross-attention shapes
        for B, Sq, Sk, H, KVH, D in K7_ENCDEC:
            q, k, v = k7_inputs(B, Sq, H, KVH, D, BF16_VALUED, dev, Sk=Sk)
            qt = q.transpose(1, 2)
            kt, vt = k.transpose(1, 2), v.transpose(1, 2)
            nbytes = 4 * (2 * B * Sq * H + 2 * B * Sk * KVH) * D
            record(fa.DENSE_NAME, (B, Sq, Sk, H, KVH, D, BF16_VALUED,
                                   "non-causal"),
                   lambda: fa.flash_attention(q, k, v, causal=False),
                   lambda: fa.flash_attention_plain(q, k, v, causal=False),
                   lambda: F.scaled_dot_product_attention(qt, kt, vt),
                   nbytes, 4 * B * H * D * Sq * Sk)
            del q, k, v, qt, kt, vt
        # whisper's MLP GELU, f32 at d_ff 2048 (not a kernel): the
        # reference's order (refnum.Gelu, elementwise ops through f64) that
        # every device runs, against torch's tanh GELU, forward on a decode
        # step's 4 rows and the encoder's 4 x 1500, and forward + backward
        # on the encoder's rows (training)
        if full:
            from repro_torch.models import refnum
            gelus = {"reference order": refnum.Gelu.apply,
                     "torch tanh": lambda t: F.gelu(t, approximate="tanh")}
            gelu_ms = {}
            for n in (4, 6000):
                x = torch.randn((n, 2048), generator=gen(dev, SEED),
                                device=dev)
                gelu_ms[f"fwd {n}x2048"] = {
                    name: time_ms(lambda: fn(x), flush)
                    for name, fn in gelus.items()}
            with torch.enable_grad():
                xg = x.clone().requires_grad_()
                gelu_ms["fwd+bwd 6000x2048"] = {
                    name: time_ms(lambda: torch.autograd.grad(
                        fn(xg), xg, torch.ones_like(xg)), flush)
                    for name, fn in gelus.items()}
            emit({"phase": "times", "op": "gelu", "ms": gelu_ms})
            del x, xg
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
            if r is not None:
                step_ms += n * r["ms"]
            del a, b, ra, rb
        if full:
            emit({"phase": "times", "kernel": fm.FUSED_NAME,
                  "train_step_k1_ms": step_ms})
        # K1 at the later slices' shapes (K1_CASES): zamba2's in_proj (N =
        # 8384) and its dX (K = 8384), xlstm's lm_head, whisper's tied head
        # at a decode step and its encoder's w_in in training, and
        # internvl2's head in training
        for label, M, K, N, _, sr_a, sr_b, sc_a, sc_b in K1_CASES:
            if not any(arch in label for arch in ("zamba2", "xlstm",
                                                  "whisper", "internvl2")):
                continue
            a, b, spec_a, spec_b, ra, rb, ca, cb = k1_inputs(
                M, K, N, "nvfp4", sr_a, sr_b, sc_a, sc_b, dev,
                a_transposed=label.startswith("dW"))
            extra = {}
            if label.endswith("whisper head"):
                # the tied head's operand is embed.T, which _k1_gemm
                # copies contiguous at every call: that copy's time
                table = b.T.contiguous()
                extra["b_copy_ms"] = time_ms(lambda: table.T.contiguous(),
                                             flush)
            record(fm.FUSED_NAME, (label, M, K, N),
                   lambda: fm.fused_quant_matmul(
                       a, b, spec_a, spec_b, a_counter=ca, b_counter=cb,
                       out_dtype=torch.bfloat16),
                   lambda: fm.fused_quant_matmul_plain(
                       a, b, spec_a, spec_b, a_rbits=ra, b_rbits=rb,
                       out_dtype=torch.bfloat16),
                   lambda: torch.matmul(a, b), 2 * (M * K + K * N + M * N),
                   2 * M * N * K, reps=5, **extra)
            del a, b, ra, rb
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
    if not full:
        return rows
    # what one call spends in each of its launches, each call in a fresh
    # process; the children start together and measure one at a time
    lock = ROOT / "build" / "breakdown.lock"
    lock.parent.mkdir(parents=True, exist_ok=True)
    procs = {case: start_breakdown_child(case, lock) for case in BREAKDOWNS}
    try:
        for case, (kernel, _) in BREAKDOWNS.items():
            emit({"phase": "times", "kernel": kernel, "case": case,
                  "launch_breakdown": breakdown_in_child(
                      case, lock, first=procs.pop(case))})
    finally:
        for proc in procs.values():
            proc.kill()
            proc.communicate()
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
    ap.add_argument("--phases", default=",".join(DEFAULT_PHASES),
                    help=f"comma-separated subset of {PHASES}")
    ap.add_argument("--er-seed", type=int, default=SEED,
                    help="weights and data of phase mesh_encdec_recurrent's "
                         "training runs e-g")
    ap.add_argument("--er-probe", default=None, metavar="FILE",
                    help="phase mesh_encdec_recurrent also runs each "
                         "training run's one-process run again and a "
                         "second re-drawn run, and writes every leaf's "
                         "distances (parameters, f32 masters, step-0 "
                         "gradients) to FILE as JSON")
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
    # the CPU children the selected phases read (each computes on the CPU
    # what its phase holds the card to), started once the kernels are
    # built so that their minutes overlap the card's phases before theirs
    children = {"serve_continuous": [("cpu_compile_counts",)],
                "archs": [("archs_smoke_reference",)],
                "encdec_vlm": [("encdec_smoke_reference",),
                               ("encdec_cpu_compiles", ENCDEC_REQUESTS)]}
    try:
        for i, p in enumerate(phases):
            if p != "env" and "env" not in phases[i:]:
                for q in phases[i:]:
                    for child in children.get(q, ()):
                        cpu_child(*child)
            t0 = time.perf_counter()
            results[p] = {"env": phase_env, "kernels": phase_kernels,
                          "serve": phase_serve,
                          "serve_continuous": phase_serve_continuous,
                          "train": phase_train, "pipeline": phase_pipeline,
                          "archs": phase_archs,
                          "recurrent": phase_recurrent,
                          "encdec_vlm": phase_encdec_vlm,
                          "mesh": phase_mesh,
                          "train_mesh": phase_train_mesh,
                          "mesh_families": phase_mesh_families,
                          "mesh_encdec_recurrent": functools.partial(
                              phase_mesh_encdec_recurrent,
                              seed=args.er_seed, probe=args.er_probe),
                          "ops": phase_ops,
                          "times": phase_times,
                          "times_full": functools.partial(
                              phase_times, full=True)}[p](dev)
            emit({"phase": p, "done": True,
                  "seconds": round(time.perf_counter() - t0, 3)})
    finally:
        stop_cpu_children()
    print(card_line(), flush=True)
    if set(DEFAULT_PHASES) - {"env"} <= set(phases):
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
        # and each kernel's launches on the archs' paths (runs a-e), the
        # recurrent families' (serve and train) and the encdec and vlm
        # families' (runs a-d)
        for ph in ("archs", "recurrent", "encdec_vlm", "mesh", "train_mesh",
                   "mesh_families", "mesh_encdec_recurrent"):
            for name, n in results[ph]["launches"].items():
                launches[name] = launches.get(name, 0) + n
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
            if name == "packed_block_matmul":
                # the tensor-parallel forms held in phase kernels
                line[-1]["tp"] = results["kernels"]["k4_tp"]
            if name == "fused_quant_matmul":
                # the training mesh's shards (a_amax / b_amax)
                line[-1]["tp"] = results["kernels"]["k1_tp"]
            if name == "block_quantize":
                line[-1]["mesh"] = results["kernels"]["k2_mesh"]
        emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
