"""Serving engines (PyTorch): FP4 forward, prefill + decode.

Counterparts of ``repro.serve.engine.Engine`` and ``.ContinuousEngine``.
Every weight GEMM runs NVFP4 RtN on the activation against weights packed
once at engine build (the K4 kernel).

  * ``Engine`` -- LOCKSTEP batches: prompts are left-padded with token 0
    (the pads attended unmasked, as in the reference), prefill attention
    is K7 and decode attention over the nvfp4/fp8 cache K6.  Two programs,
    ``_prefill`` and ``_decode`` (the reference's ``_decode_impl``: done/
    EOS bookkeeping, the decode step and the greedy pick on the device);
    the host syncs once per ``decode_chunk`` steps.
  * ``ContinuousEngine`` -- continuous batching over a PAGED block-
    quantized KV cache.  The request lifecycle (queue, slots, demand
    paging, preemption, the shared-prefix cache, abort/timeout) is the
    host-side ``serve/scheduler.py``; the device runs five programs:
    prefill-into-slot (attention K7), suffix prefill and chunked prefill
    (K5 through the paged cache), batched decode with a write mask (K5),
    and speculative verify-k with exact rollback (K5).  The page table has
    a numpy mirror on the host; a tick uploads it in one copy from pinned
    memory before the programs that read it, and reads back once, at the
    end of the tick.

Each program is a ``serve.graphs.Program``: on the card one CUDA graph per
static signature (``cuda_graphs=False`` runs them eagerly), on the CPU the
eager body.  The engines keep one KV carry at fixed addresses and reset it
in place; slot, lengths and offsets reach the programs as int32 device
scalars.  ``ContinuousEngine`` reports each program's compile count
(distinct signatures) as the reference does, and with a tracer emits its
``jit_compile`` instants and ``jit_compiles`` counter.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import fqt
from repro_torch.core.quantize import PackedQuantizedTensor
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import TRASH_PAGE
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serve import packing
from repro_torch.serve.graphs import Program
from repro_torch.serve.metrics import MetricsRecorder
from repro_torch.serve.scheduler import Request, Scheduler


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch_size: int = 8
    max_len: int = 2048
    temperature: float = 0.0      # 0 => greedy
    top_k: int = 0                # 0 => no top-k filtering
    eos_id: int = 2
    seed: int = 0
    # "nvfp4" (0.5625 B/elem), "fp8" (1.125 B/elem) or "bf16"
    kv_cache_format: str = "nvfp4"
    decode_chunk: int = 8         # decode steps per host sync (per tick)
    # ---- continuous batching (ContinuousEngine) -------------------------
    page_size: int = 16           # tokens per KV page
    max_slots: Optional[int] = None    # decode slots (default: batch_size)
    total_pages: Optional[int] = None  # page-pool size (None: one full
                                       # reservation per slot + trash page)
    prefill_len: Optional[int] = None  # static prefill pad (None: derived
                                       # from the submitted trace)
    prefill_chunk: Optional[int] = None    # chunked prefill width
    prefix_cache: bool = False             # exact shared-prefix cache
    prefix_cache_pages: Optional[int] = None   # cap on cached pages (LRU)
    spec_k: Optional[int] = None        # speculative verify block (None: off)
    draft_layers: Optional[int] = None  # draft depth (default n_layers // 2)
    mesh: Optional[str] = None          # serving mesh: not ported

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "mesh-native serving is not ported (ROADMAP Queue 1: "
                "distributed/sharding.py); the port serves on one device")


def _sample(logits: torch.Tensor, scfg: ServeConfig,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """logits (B, V) -> (B,) int32.  Greedy is argmax; temperature sampling
    draws from ``gen`` (torch's stream, not ``jax.random``'s categorical:
    a declared divergence)."""
    if scfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.to(torch.float32) / scfg.temperature
    if scfg.top_k > 0:
        kth = torch.topk(logits, scfg.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, -1e30),
                             logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


def _greedy_margin(logits: torch.Tensor) -> torch.Tensor:
    """Top1 - top2 logit gap per row: how decisive the greedy pick is."""
    top2 = torch.topk(logits.to(torch.float32), 2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def _head(lg: torch.Tensor, scfg: ServeConfig):
    """A program's last step on (B, V) logits: the greedy pick (or, under
    temperature sampling, the logits, which the host draws from after the
    program) and the greedy margin."""
    pick = (lg if scfg.temperature > 0
            else torch.argmax(lg, dim=-1).to(torch.int32))
    return pick, _greedy_margin(lg)


class Engine:
    """Single-model LOCKSTEP serving engine (dense family).

    ``cuda_graphs`` (default True): on the card each program replays as
    one CUDA graph per signature; False runs them eagerly (the comparison
    path).  The CPU always runs them eagerly."""

    def __init__(self, cfg: ModelConfig, params, scfg: ServeConfig,
                 qcfg: Optional[fqt.QuantConfig] = None,
                 pack_weights: bool = True, device=None,
                 cuda_graphs: bool = True):
        self.device = resolve_device(device)
        self.cfg, self.scfg = cfg, scfg
        self.qcfg, self.params = _packed(cfg, params, qcfg, pack_weights,
                                         self.device)
        self.margins: List[np.ndarray] = []   # per-step greedy margins
        self.steps = 0                        # decode steps of the last run
        self._carry = None                    # one carry, reset per run
        graphs = cuda_graphs and self.device.type == "cuda"
        self.programs = {"prefill": Program("prefill", self._prefill_impl,
                                            graphs),
                         "decode": Program("decode", self._decode_impl,
                                           graphs)}

    # ---- the two programs ----------------------------------------------------

    def _prefill_impl(self, tokens):
        """Fill the (empty) carry from the left-padded prompts: last-token
        logits (B, V)."""
        logits, _ = registry.prefill(self.params, self.cfg, self.qcfg,
                                     tokens, self._carry)
        return logits

    def _decode_impl(self, tokens, done):
        """One lockstep decode step with on-device done/EOS bookkeeping
        (the reference's ``_decode_impl``): emit = the masked output token,
        done accumulates the EOS mask; then the greedy pick (or, under
        temperature, the logits the host samples from) and its margin."""
        eos = self.scfg.eos_id
        emit = torch.where(done, eos, tokens)
        done = done | (tokens == eos)
        logits, _ = registry.decode_step(self.params, self.cfg, self.qcfg,
                                         emit[:, None].to(torch.int64),
                                         self._carry)
        return (emit, done) + _head(logits[:, -1], self.scfg)

    @torch.no_grad()
    def generate(self, prompts: List[np.ndarray],
                 max_new: int = 32) -> List[np.ndarray]:
        """Greedy/temperature generation for a batch of token prompts."""
        scfg, cfg, dev = self.scfg, self.cfg, self.device
        B = len(prompts)
        if B > scfg.batch_size:
            raise ValueError(f"{B} prompts > batch_size {scfg.batch_size}")
        plen = max(len(p) for p in prompts)
        toks = np.zeros((scfg.batch_size, plen), np.int64)
        for i, p in enumerate(prompts):
            toks[i, plen - len(p):] = p       # left-pad with token 0
        toks = torch.from_numpy(toks).to(dev)

        if self._carry is None:
            self._carry = registry.make_decode_state(
                cfg, scfg.batch_size, scfg.max_len,
                kv_cache_format=scfg.kv_cache_format, device=dev)
        else:
            registry.reset_decode_state(self._carry)
        last_logits = self.programs["prefill"](toks)
        gen = None
        if scfg.temperature > 0:
            gen = torch.Generator(device=dev)
            gen.manual_seed(scfg.seed)
        margins = [_greedy_margin(last_logits)]
        nxt = _sample(last_logits, scfg, gen)
        done = torch.zeros((scfg.batch_size,), dtype=torch.bool, device=dev)
        emitted = []                          # device tensors; no per-step sync
        sync = max(1, scfg.decode_chunk)
        decode = self.programs["decode"]
        for t in range(max_new):
            # the outputs are the graph's buffers: keep copies of what stays
            emit, done, nxt, margin = decode(nxt, done)
            if gen is not None:
                nxt = _sample(nxt, scfg, gen)
            margins.append(margin.clone())
            emitted.append(emit.clone())
            # transfer the done mask once per decode_chunk, not per token
            if (t + 1) % sync == 0 and bool(done.all()):
                break
        self.steps = len(emitted)
        # margins[t] belongs to the logits that picked emitted token t
        self.margins = list(torch.stack(margins[:len(emitted)], dim=1
                                        ).cpu().numpy()[:B])
        if not emitted:
            return [np.zeros((0,), np.int32) for _ in range(B)]
        out = torch.stack(emitted, dim=1).cpu().numpy()   # one transfer
        seen = np.cumsum(out == scfg.eos_id, axis=1) > 0
        alldone = seen.all(axis=0)
        if alldone.any():
            out = out[:, : int(np.argmax(alldone)) + 1]
        return [out[i] for i in range(B)]


def _stream_seed(seed: int, rid: int, step: int) -> int:
    """Seed of request ``rid``'s sampling draw at ``step``: keyed by request
    id, not slot, so slot reuse never replays another request's stream and
    a preempted request replays its own (the reference's ``fold_in(rid,
    step)`` keys; torch's stream differs, a declared divergence)."""
    return (int(seed) * 0x9E3779B1 + int(rid) * 0x85EBCA6B
            + int(step) * 0xC2B2AE35) & 0x7FFFFFFFFFFFFFFF


def _h2d(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host array -> device tensor without stalling the stream: a copy from
    pinned memory, enqueued (the caching host allocator keeps the pinned
    block alive until the copy has run)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


def _fetch(*tensors: torch.Tensor) -> List[np.ndarray]:
    """The tick's ONE device-to-host transfer: int32 and float32 tensors
    packed bit for bit into one int32 vector, copied once, split again."""
    flat = [t.reshape(-1).contiguous() for t in tensors]
    bits = torch.cat([f.view(torch.int32) if f.dtype == torch.float32
                      else f.to(torch.int32) for f in flat])
    host = bits.cpu().numpy()
    out, i = [], 0
    for t, f in zip(tensors, flat):
        a = host[i:i + f.numel()]
        i += f.numel()
        if t.dtype == torch.float32:
            a = a.view(np.float32)
        out.append(a.reshape(tuple(t.shape)))
    return out


class ContinuousEngine:
    """Continuous batching over a paged, block-quantized KV cache (dense
    family).

    Requests arrive on a (deterministic, tick-indexed) trace, wait in the
    scheduler's FIFO queue, and are admitted whenever a slot AND enough
    free pages exist; slots free on EOS/max_new and are reused.  The five
    device programs are the methods ``_prefill``, ``_prefill_suffix``,
    ``_prefill_chunk``, ``_decode`` and ``_verify``.  Greedy streams are
    held to the JAX engine's; temperature sampling draws from a
    ``torch.Generator`` seeded per (seed, rid, step)."""

    def __init__(self, cfg: ModelConfig, params, scfg: ServeConfig,
                 qcfg: Optional[fqt.QuantConfig] = None,
                 pack_weights: bool = True, device=None, tracer=None,
                 cuda_graphs: bool = True):
        if cfg.family == "moe" or cfg.n_experts:
            raise NotImplementedError(
                "continuous batching of the moe family arrives with its "
                "slice (ROADMAP Queue 1: models/moe.py)")
        if cfg.family == "encdec":
            raise NotImplementedError(
                "continuous batching of the encdec (whisper) family arrives "
                "with its slice (ROADMAP Queue 1: models/whisper.py)")
        if cfg.family != "dense":
            raise NotImplementedError(
                f"continuous batching serves the dense family; "
                f"{cfg.family!r} stays on the lockstep Engine")
        self.device = resolve_device(device)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.cfg, self.scfg = cfg, scfg
        self.qcfg, self.params = _packed(cfg, params, qcfg, pack_weights,
                                         self.device)

        self.n_slots = scfg.max_slots or scfg.batch_size
        psz = scfg.page_size
        buf = (scfg.max_len if cfg.sliding_window is None
               else min(scfg.max_len, cfg.sliding_window))
        self.slot_buf = -(-buf // psz) * psz   # logical tokens per slot
        self.n_pages_slot = self.slot_buf // psz
        if scfg.prefix_cache and cfg.sliding_window is not None:
            raise NotImplementedError(
                "prefix_cache needs prompt-pure K/V and a linear cache: "
                "dense families without a sliding window")
        if scfg.prefill_chunk is not None:
            if cfg.sliding_window is not None:
                raise NotImplementedError(
                    "prefill_chunk needs a linear cache (no sliding "
                    "window): chunks attend THROUGH the quantized paged "
                    "cache")
            if not 1 <= scfg.prefill_chunk <= self.slot_buf:
                raise ValueError(
                    f"prefill_chunk {scfg.prefill_chunk} out of range "
                    f"[1, {self.slot_buf}]")
        self.spec = scfg.spec_k is not None
        self.draft_layers = 0
        if scfg.draft_layers is not None and not self.spec:
            raise ValueError("draft_layers requires spec_k (speculative "
                             "decoding off)")
        if self.spec:
            if cfg.sliding_window is not None:
                raise NotImplementedError(
                    "speculative decoding needs a linear cache; SWA "
                    "rolling buffers cannot roll back exactly")
            if scfg.temperature > 0.0:
                raise NotImplementedError(
                    "speculative verify is greedy-only (temperature 0): "
                    "the acceptance rule is exact argmax agreement")
            if scfg.spec_k < 2:
                raise ValueError(f"spec_k must be >= 2, got {scfg.spec_k}")
            dl = (scfg.draft_layers if scfg.draft_layers is not None
                  else max(1, cfg.n_layers // 2))
            if not 1 <= dl <= cfg.n_layers:
                raise ValueError(
                    f"draft_layers {dl} out of range [1, {cfg.n_layers}]")
            self.draft_layers = dl
            self._draft_cfg = dataclasses.replace(cfg, n_layers=dl)
        self._gen = None
        if scfg.temperature > 0:
            self._gen = torch.Generator(device=self.device)
        self.scheduler: Optional[Scheduler] = None
        self._carry = None                  # allocated once, reset in place
        self._pt_host: Optional[np.ndarray] = None   # host page-table mirror
        self._pt_dirty = False
        self.margins: Dict[int, np.ndarray] = {}
        graphs = cuda_graphs and self.device.type == "cuda"
        self.programs = {name: Program(name, body, graphs) for name, body in (
            ("prefill", self._prefill_impl),
            ("prefill_suffix", self._prefill_suffix_impl),
            ("prefill_chunk", self._prefill_chunk_impl),
            ("decode", self._decode_impl),
            ("verify", self._verify_impl))}

    # ---- compile introspection (the reference's jit cache sizes) -------------

    @property
    def prefill_compiles(self) -> int:
        return self.programs["prefill"].cache_size

    @property
    def prefill_suffix_compiles(self) -> int:
        return self.programs["prefill_suffix"].cache_size

    @property
    def chunk_compiles(self) -> int:
        return self.programs["prefill_chunk"].cache_size

    @property
    def decode_compiles(self) -> int:
        return self.programs["decode"].cache_size

    @property
    def verify_compiles(self) -> int:
        return self.programs["verify"].cache_size

    # ---- the five device programs --------------------------------------------
    # ``*_impl`` are the program bodies (operands: tensors or None; slot,
    # plen, pfx and off are int32 device scalars).  The methods without the
    # suffix call the program and return tensors the caller owns; under
    # temperature sampling they draw from the program's logits on the host
    # side of the graph.

    def _draw(self, out: torch.Tensor, rids, steps) -> torch.Tensor:
        """(B,) int32 picks owned by the caller: the program's greedy picks,
        or per-request draws from its (B, V) logits with the seeded
        generator (rids/steps: host ints per row)."""
        if self.scfg.temperature <= 0.0:
            return out.clone()
        picks = []
        for i in range(out.shape[0]):
            self._gen.manual_seed(_stream_seed(self.scfg.seed, rids[i],
                                               steps[i]))
            picks.append(_sample(out[i:i + 1], self.scfg, self._gen))
        return torch.cat(picks)

    def _prefill_impl(self, tokens, plen, slot):
        logits, _ = registry.prefill_slot(self.params, self.cfg, self.qcfg,
                                          tokens, self._carry, slot, plen)
        return _head(logits, self.scfg)

    def _prefill(self, tokens, plen, slot, rid: int):
        """Prefill one slot from a right-padded (1, prefill_len) prompt and
        pick that request's first token (device scalars)."""
        pick, margin = self.programs["prefill"](tokens, plen, slot)
        return self._draw(pick, [rid], [0])[0], margin[0].clone()

    def _prefill_suffix_impl(self, tokens, plen, pfx, slot):
        logits, _ = registry.prefill_suffix(self.params, self.cfg,
                                            self.qcfg, tokens, self._carry,
                                            slot, plen, pfx)
        return _head(logits, self.scfg)

    def _prefill_suffix(self, tokens, plen, pfx, slot, rid: int):
        """Warm-prefix (or final-chunk) prefill: the slot's page row
        already holds [0, pfx); write + attend only the SUFFIX."""
        pick, margin = self.programs["prefill_suffix"](tokens, plen, pfx,
                                                       slot)
        return self._draw(pick, [rid], [0])[0], margin[0].clone()

    def _prefill_chunk_impl(self, tokens, slot, off):
        registry.prefill_chunk(self.params, self.cfg, self.qcfg, tokens,
                               self._carry, slot, off)

    def _prefill_chunk(self, tokens, slot, off) -> None:
        """Chunked prefill, intermediate chunk: write one FULL
        (1, prefill_chunk) slice of a prompt at [off, off + C)."""
        self.programs["prefill_chunk"](tokens, slot, off)

    def _decode_impl(self, tokens, mask):
        logits, _ = registry.decode_step(self.params, self.cfg, self.qcfg,
                                         tokens[:, None].to(torch.int64),
                                         self._carry, write_mask=mask)
        return _head(logits[:, -1], self.scfg)

    def _decode(self, tokens, mask, rids, steps):
        """One token for every slot; ``mask`` ((n_slots,) bool or None):
        slots not decoding this tick write to the trash page with frozen
        lengths."""
        pick, margin = self.programs["decode"](tokens, mask)
        return self._draw(pick, rids, steps), margin.clone()

    def _verify(self, tokens, mask):
        """Speculative verify-k (``_verify_impl``): returns (picks (B, k),
        margins (B, k), n_emit (B,), next token (B,)), owned by the
        caller."""
        return tuple(t.clone() for t in self.programs["verify"](tokens,
                                                                mask))

    def _verify_impl(self, tokens, mask):
        """Speculative verify-k: the layer-truncated self-draft proposes
        k-1 greedy tokens per slot (on the shared pools, its own lengths),
        ONE teacher-forced pass of the block through the full model
        verifies it, the longest matching prefix plus one corrected token
        is accepted (n_emit in 1..k), and ``truncate_to`` rolls every
        layer's lengths back over the rejected rows."""
        k = self.scfg.spec_k
        dparams, dcarry = registry.draft_view(self.params, self._carry,
                                              self.draft_layers)
        blk, tok = [tokens], tokens
        for _ in range(k - 1):
            lg, _ = registry.decode_step(dparams, self._draft_cfg, self.qcfg,
                                         tok[:, None].to(torch.int64),
                                         dcarry, write_mask=mask)
            tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)
            blk.append(tok)
        blk = torch.stack(blk, dim=1)                          # (B, k)
        lg, _ = registry.verify_k(self.params, self.cfg, self.qcfg,
                                  blk.to(torch.int64), self._carry,
                                  write_mask=mask)
        g = torch.argmax(lg, dim=-1).to(torch.int32)           # (B, k)
        margin = _greedy_margin(lg)
        match = (g[:, :k - 1] == blk[:, 1:]).to(torch.int32)
        n_emit = torch.sum(torch.cumprod(match, dim=1), dim=1).to(
            torch.int32) + 1
        wrote = (torch.ones_like(n_emit) if mask is None
                 else mask.to(torch.int32))
        n_emit = n_emit * wrote               # masked slots emit nothing
        delta = n_emit - k * wrote
        for c in self._carry:
            c.truncate_to(None, c.lengths + delta)
        nxt = torch.gather(g, 1, torch.clamp(n_emit - 1, min=0)[:, None]
                           .to(torch.int64))[:, 0]
        return g, margin, n_emit, nxt

    # ---- host-side plumbing ------------------------------------------------

    def _set_page_row(self, slot: int, row: np.ndarray) -> None:
        """Point one slot's page-table row at new pages (host mirror; the
        device table is written by ``_flush_pages``)."""
        self._pt_host[slot] = row
        self._pt_dirty = True

    def _flush_pages(self) -> None:
        """Upload the host page-table mirror in ONE copy, if it changed."""
        if self._pt_dirty:
            table = self._carry[0].page_table       # shared by every layer
            table.copy_(_h2d(self._pt_host, self.device))
            self._pt_dirty = False

    def _derive_prefill_len(self, requests: List[Request]) -> int:
        if self.scfg.prefill_len is not None:
            pad = self.scfg.prefill_len
        else:
            pad = max((len(r.prompt) for r in requests), default=1)
        pad = min(-(-pad // self.scfg.page_size) * self.scfg.page_size,
                  self.slot_buf)
        long = [r.rid for r in requests if len(r.prompt) > pad]
        if long:
            raise ValueError(
                f"requests {long}: prompt exceeds the static prefill "
                f"length {pad} (slot capacity {self.slot_buf})")
        return pad

    def _padded(self, toks: np.ndarray, width: int) -> torch.Tensor:
        padded = np.zeros((1, width), np.int64)
        padded[0, :len(toks)] = toks
        return _h2d(padded, self.device)

    # ---- serving loop ------------------------------------------------------

    @torch.no_grad()
    def run(self, requests: List[Request],
            forced: Optional[Dict[int, np.ndarray]] = None
            ) -> Dict[int, np.ndarray]:
        """Serve a request trace to completion; returns {rid: tokens}.

        ``forced``: per-rid teacher-forcing streams -- the engine FEEDS the
        forced tokens but records its own picks (and greedy margins,
        ``self.margins``).  Aborted/timed-out requests never appear in the
        result; their partial streams live in ``self.scheduler.cancelled``.
        Lifecycle timestamps (simulated ticks) land in ``self.metrics``.
        With ``scfg.prefix_cache`` on, the scheduler (page pool + radix
        cache) AND the device caches persist across run() calls."""
        scfg, dev = self.scfg, self.device
        forced = forced or {}
        chunked = scfg.prefill_chunk is not None
        if self.spec and forced:
            raise NotImplementedError(
                "teacher-forced streams are incompatible with speculative "
                "decoding (the verify block IS the fed stream)")
        sched = self.scheduler if scfg.prefix_cache else None
        if sched is None:
            sched = Scheduler(self.n_slots, scfg.max_len, scfg.page_size,
                              total_pages=scfg.total_pages,
                              slot_pages=self.n_pages_slot,
                              prefix_cache=scfg.prefix_cache,
                              prefix_cache_pages=scfg.prefix_cache_pages,
                              prefill_chunk=scfg.prefill_chunk,
                              tracer=self.tracer)
            if self._carry is None:
                self._carry = registry.make_decode_state(
                    self.cfg, self.n_slots, scfg.max_len,
                    kv_cache_format=scfg.kv_cache_format,
                    page_size=scfg.page_size, total_pages=sched.total_pages,
                    device=dev)
            else:           # the programs hold its addresses: reset in place
                registry.reset_decode_state(self._carry)
            self._pt_host = np.full((self.n_slots, self.n_pages_slot),
                                    TRASH_PAGE, np.int32)
            self._pt_dirty = False
        else:
            sched.results = {}      # warm prefix pages persist
            sched.cancelled = {}
        self.scheduler = sched
        for r in requests:
            sched.submit(r)
        met = MetricsRecorder(tracer=self.tracer)
        self.metrics = met
        for r in requests:
            met.submitted(r.rid, r.arrival, deadline=r.deadline)
        if chunked:
            prefill_pad = scfg.prefill_chunk
            long = [r.rid for r in requests
                    if len(r.prompt) > self.slot_buf]
            if long:
                raise ValueError(f"requests {long}: prompt exceeds the "
                                 f"slot capacity {self.slot_buf}")
        else:
            prefill_pad = self._derive_prefill_len(requests)
        sched.resume_pad = None if chunked else prefill_pad

        tokens = torch.zeros((self.n_slots,), dtype=torch.int32, device=dev)
        steps = [1] * self.n_slots          # per-slot sampling step (host)
        margins: Dict[int, list] = {}
        trash_row = np.full((self.n_pages_slot,), TRASH_PAGE, np.int32)
        slot_rid: List[Optional[int]] = [None] * self.n_slots
        slot_fed: Dict[int, int] = {}       # slot -> host index into forced
        pending: Dict[int, tuple] = {}      # slot -> (tok, margin) DEVICE
                                            # scalars, read with the tick's
                                            # one transfer
        # compile observation (host side, with a live tracer only): a
        # program whose signature count grew in a tick emits one
        # jit_compile instant at the tick's end, as the reference does
        trc = self.tracer
        compiled = {n: p.cache_size for n, p in self.programs.items()}

        def scalars(*vals):
            """Host ints -> int32 device scalars (one pinned copy): the
            programs' dynamic operands."""
            t = _h2d(np.asarray(vals, np.int32), dev)
            return [t[i] for i in range(len(vals))]

        def first_token(slot, req, tok):
            steps[slot] = 1
            if req.rid in forced:
                slot_fed[slot] = 0
                tokens[slot] = int(forced[req.rid][0])
            else:
                tokens[slot] = tok

        tick = 0
        while sched.has_work():
            trc.set_time(tick)
            trc.begin("engine", "tick")
            # -- lifecycle: aborts/timeouts due NOW fire before any work
            for slot, rid, stage, reason in sched.expire(tick):
                met.cancelled(rid, tick, stage, reason)
                if slot is not None:        # was on-device: park its row
                    self._set_page_row(slot, trash_row)
                    margins.pop(rid, None)
                    slot_rid[slot] = None
                    pending.pop(slot, None)
                    slot_fed.pop(slot, None)

            # -- admissions (host): pages + slot, then one prefill program
            # per admission, strictly in placed order (a later admission
            # may share pages an earlier one writes).  Chunked mode defers
            # every prompt write to prefill_work below.
            admitted = sched.admit(tick)
            for slot, req, row, _ in admitted:
                self._set_page_row(slot, row)
                slot_rid[slot] = req.rid
                met.admitted(req.rid, tick)
            self._flush_pages()
            for slot, req, row, pfx in admitted:
                if chunked:
                    continue
                sfx = self._padded(np.asarray(req.prompt[pfx:]), prefill_pad)
                plen_d, pfx_d, slot_d = scalars(len(req.prompt), pfx, slot)
                if sched.prefix_cache is not None:
                    # prefix-cache mode: EVERY admission (cold: pfx == 0)
                    # runs the quantize-then-attend suffix program, so warm
                    # admissions equal cold starts bit for bit
                    tok, margin = self._prefill_suffix(
                        sfx, plen_d, pfx_d, slot_d, req.rid)
                else:
                    tok, margin = self._prefill(sfx, plen_d, slot_d,
                                                req.rid)
                pending[slot] = (tok, margin)
                first_token(slot, req, tok)

            # -- chunked prefill: at most ONE chunk per mid-prefill slot
            for slot, req, start, clen, last in sched.prefill_work(tick):
                if not last:
                    chunk = _h2d(np.asarray(req.prompt[start:start + clen],
                                            np.int64)[None], dev)
                    self._prefill_chunk(chunk, *scalars(slot, start))
                    continue
                sfx = self._padded(np.asarray(req.prompt[start:]),
                                   prefill_pad)
                tok, margin = self._prefill_suffix(
                    sfx, *scalars(len(req.prompt), start, slot), req.rid)
                pending[slot] = (tok, margin)
                first_token(slot, req, tok)

            # -- decode tick: no host transfer inside the loop
            active = sched.decoding_slots()
            if self.spec:
                T = 1 if active else 0
                growth, preempted = sched.ensure_capacity(
                    scfg.spec_k if active else 0, advance=False)
            else:
                T = sched.tick_steps(scfg.decode_chunk,
                                     {s: 1 for s in pending})
                growth, preempted = sched.ensure_capacity(T)
            for slot, row in growth:
                self._set_page_row(slot, row)
            for slot in preempted:
                self._set_page_row(slot, trash_row)
                margins.pop(slot_rid[slot], None)
                slot_rid[slot] = None
                pending.pop(slot, None)
                slot_fed.pop(slot, None)
            self._flush_pages()
            active = [s for s in active if s not in preempted]
            amask = None
            if chunked:
                host_mask = np.zeros((self.n_slots,), bool)
                host_mask[active] = True
                amask = _h2d(host_mask, dev)
            first_slots = sorted(pending)
            firsts = [torch.stack([pending[s][i] for s in first_slots])
                      for i in (0, 1)] if first_slots else []
            pending.clear()
            ne = np.zeros((self.n_slots,), np.int32)
            if self.spec and active:
                g, margin, ne_d, nxt = self._verify(tokens, amask)
                tokens = nxt
                em_s, mg_s, ne, *fh = _fetch(g, margin, ne_d, *firsts)
                em, mg = em_s.T, mg_s.T           # commit reads [:, slot]
            elif self.spec:
                em = np.zeros((0, self.n_slots), np.int32)
                mg = np.zeros((0, self.n_slots), np.float32)
                fh = _fetch(*firsts) if firsts else []
            else:
                picks, margs = [], []
                rids = [-1 if r is None else r for r in slot_rid]
                for _ in range(T):
                    nxt, margin = self._decode(tokens, amask, rids, steps)
                    steps = [s + 1 for s in steps]
                    picks.append(nxt)
                    margs.append(margin)
                    # the next step's input; a copy where teacher forcing
                    # overwrites entries, so the recorded picks stay
                    tokens = nxt.clone() if slot_fed else nxt
                    for slot, idx in slot_fed.items():  # teacher forcing
                        stream = forced[slot_rid[slot]]
                        nxt_idx = min(idx + 1, len(stream) - 1)
                        tokens[slot] = int(stream[nxt_idx])
                        slot_fed[slot] = nxt_idx
                if picks:
                    em, mg, *fh = _fetch(torch.stack(picks),
                                         torch.stack(margs), *firsts)
                else:
                    em = np.zeros((0, self.n_slots), np.int32)
                    mg = np.zeros((0, self.n_slots), np.float32)
                    fh = _fetch(*firsts) if firsts else []
            firsts = ({} if not first_slots else
                      dict(zip(first_slots, zip(fh[0], fh[1]))))
            emitted_counts = []
            for slot in active:
                rid = slot_rid[slot]
                toks, ms = [], margins.setdefault(rid, [])
                if slot in firsts:
                    met.first_token(rid, tick)
                    toks.append(int(firsts[slot][0]))
                    ms.append(float(firsts[slot][1]))
                if self.spec:
                    n = int(ne[slot])
                    sched.advance_written(slot, n)
                    emitted_counts.append(n)
                    toks += [int(t) for t in em[:n, slot]]
                    ms += [float(m) for m in mg[:n, slot]]
                else:
                    toks += [int(t) for t in em[:, slot]]
                    ms += [float(m) for m in mg[:, slot]]
                sched.commit(slot, toks, scfg.eos_id)
                if sched.slots[slot] is None:           # freed: park pages
                    self._set_page_row(slot, trash_row)
                    slot_rid[slot] = None
                    slot_fed.pop(slot, None)
                    met.finished(rid, tick, len(sched.results[rid]))
            if self.spec:
                met.spec_tick(emitted_counts, scfg.spec_k)
            sched.count_tick(T, n_active=len(active))
            met.tick(queue_depth=len(sched.queue), n_active=len(active))
            if trc.enabled:
                for name, prog in self.programs.items():
                    n = prog.cache_size
                    if n != compiled[name]:
                        trc.instant("engine", "jit_compile", program=name,
                                    cache_size=n)
                        trc.counter("jit_compiles", n - compiled[name])
                        compiled[name] = n
            trc.end("engine", "tick")
            tick += 1

        self.margins = {rid: np.asarray(ms, np.float32)
                        for rid, ms in margins.items()}
        met.set_counters(sched.stats)
        return dict(sched.results)

    def generate(self, prompts: List[np.ndarray],
                 max_new: int = 32) -> List[np.ndarray]:
        """Lockstep-``Engine``-style convenience: all prompts arrive at
        tick 0; returns outputs in prompt order (stops after EOS)."""
        reqs = [Request(rid=i, prompt=np.asarray(p, np.int32),
                        max_new=max_new) for i, p in enumerate(prompts)]
        res = self.run(reqs)
        return [res[i] for i in range(len(prompts))]


def _packed(cfg: ModelConfig, params, qcfg: Optional[fqt.QuantConfig],
            pack_weights: bool, dev: torch.device):
    """(qcfg, params on ``dev``): the serving default is the paper's FP4
    forward (``qaf_config``); GEMM weights are packed to NVFP4 once."""
    qcfg = qcfg if qcfg is not None else fqt.qaf_config()
    spec = qcfg.fwd_w if (pack_weights and qcfg.fwd_w is not None) else None
    return qcfg, packing.pack_model_params(cfg, _to_device(params, dev),
                                           spec)


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, dev) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, PackedQuantizedTensor):      # an exported artifact
        return dataclasses.replace(tree, packed=tree.packed.to(dev),
                                   scales=tree.scales.to(dev),
                                   tscale=tree.tscale.to(dev))
    return tree
