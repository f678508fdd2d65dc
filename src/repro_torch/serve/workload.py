"""Seeded multi-tenant workload generator for the serving traffic harness.

Production serving systems are judged on TTFT/TPOT/goodput under
realistic multi-tenant load, not on one FIFO trace.  This module builds
such load DETERMINISTICALLY: every arrival tick, prompt token, abort and
deadline derives from a single integer seed through counter-based
``numpy`` PCG64 streams — the same ``WorkloadConfig`` always produces the
same trace byte-for-byte, on any machine, with no wall-clock anywhere
(the simulated clock is the scheduler tick).

Per tenant (``TenantSpec``):

  * a Poisson arrival process (``rate`` mean arrivals per tick), plus an
    optional deterministic BURST overlay (``burst_every``/``burst_size``)
    modelling batch jobs behind an interactive tenant;
  * a prompt-length mixture (``prompt_lens``/``prompt_probs``) and a
    shared SYSTEM PROMPT (``system_prompt_len`` tokens, identical for
    every request of the tenant) — the prefix-cache workload shape;
  * SLO/lifecycle knobs: ``deadline_slack`` (soft deadline, goodput
    only), ``abort_prob``/``abort_after`` (hard client aborts) and
    ``timeout`` (hard cancel relative to arrival) — all mapped onto
    ``scheduler.Request`` fields.

Each tenant draws from its OWN child stream (``SeedSequence([seed, t])``)
so adding a tenant never perturbs another tenant's trace.  Request ids
are assigned sequentially in (arrival, tenant, intra-tick) order — the
admission order of a FIFO replay.

Host-side and numpy-only, like ``serve/metrics.py``.  Counterpart of
``repro.serve.workload``, kept as the port's own copy with only its
imports changed (``trace_fingerprint`` matches it byte for byte).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's traffic model.  All times are scheduler ticks."""
    name: str
    rate: float = 0.5                    # mean Poisson arrivals per tick
    prompt_lens: Tuple[int, ...] = (8, 16)       # mixture support (tokens
                                                 # EXCLUDING system prompt)
    prompt_probs: Optional[Tuple[float, ...]] = None   # None = uniform
    system_prompt_len: int = 0           # shared prefix, same tokens for
                                         # every request of this tenant
    max_new: int = 16
    deadline_slack: Optional[int] = None  # deadline = arrival + slack
    abort_prob: float = 0.0              # chance a request hard-aborts
    abort_after: int = 4                 # abort_at = arrival + abort_after
    timeout: Optional[int] = None        # hard cancel, relative to arrival
    burst_every: Optional[int] = None    # every k ticks, extra arrivals
    burst_size: int = 0

    def __post_init__(self):
        if self.rate < 0:
            raise ValueError(f"tenant {self.name}: rate must be >= 0")
        if not self.prompt_lens:
            raise ValueError(f"tenant {self.name}: empty prompt_lens")
        if self.prompt_probs is not None and \
                len(self.prompt_probs) != len(self.prompt_lens):
            raise ValueError(
                f"tenant {self.name}: prompt_probs length "
                f"{len(self.prompt_probs)} != prompt_lens length "
                f"{len(self.prompt_lens)}")
        if not (0.0 <= self.abort_prob <= 1.0):
            raise ValueError(f"tenant {self.name}: abort_prob must be a "
                             f"probability")


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    """A full multi-tenant trace: ``tenants`` over ``ticks`` simulated
    ticks, every random draw derived from ``seed``."""
    tenants: Tuple[TenantSpec, ...]
    ticks: int = 32
    seed: int = 0
    vocab: int = 256                     # token id range for synthetic
                                         # prompts (kept below real vocabs)

    def __post_init__(self):
        if not self.tenants:
            raise ValueError("workload needs at least one tenant")
        if self.ticks < 1:
            raise ValueError("workload needs >= 1 tick")


@dataclasses.dataclass(frozen=True)
class WorkloadEvent:
    """One generated request, engine-agnostic (plain numpy).  Field names
    mirror ``scheduler.Request`` so ``as_requests`` is a 1:1 mapping."""
    rid: int
    tenant: str
    prompt: np.ndarray
    max_new: int
    arrival: int
    deadline: Optional[int] = None
    abort_at: Optional[int] = None
    timeout: Optional[int] = None


def _tenant_stream(seed: int, tenant_idx: int) -> np.random.Generator:
    """Counter-based child stream: tenant ``tenant_idx`` of workload
    ``seed``.  Independent of tenant iteration order and of every other
    tenant's draw count."""
    return np.random.Generator(
        np.random.PCG64(np.random.SeedSequence([seed, tenant_idx])))


def generate_workload(wcfg: WorkloadConfig) -> List[WorkloadEvent]:
    """The full trace for ``wcfg``, sorted by (arrival, tenant index,
    intra-tick order) with sequential rids in that order."""
    raw: List[Tuple[int, int, int, WorkloadEvent]] = []
    for ti, spec in enumerate(wcfg.tenants):
        g = _tenant_stream(wcfg.seed, ti)
        system = g.integers(0, wcfg.vocab,
                            size=spec.system_prompt_len).astype(np.int32)
        probs = spec.prompt_probs
        lens = np.asarray(spec.prompt_lens)
        for t in range(wcfg.ticks):
            n = int(g.poisson(spec.rate))
            if spec.burst_every and t % spec.burst_every == 0:
                n += spec.burst_size
            for k in range(n):
                plen = int(g.choice(lens, p=probs))
                body = g.integers(0, wcfg.vocab, size=plen).astype(np.int32)
                abort_at = None
                if spec.abort_prob > 0 and g.random() < spec.abort_prob:
                    abort_at = t + spec.abort_after
                ev = WorkloadEvent(
                    rid=-1, tenant=spec.name,
                    prompt=np.concatenate([system, body]),
                    max_new=spec.max_new, arrival=t,
                    deadline=(t + spec.deadline_slack
                              if spec.deadline_slack is not None else None),
                    abort_at=abort_at, timeout=spec.timeout)
                raw.append((t, ti, k, ev))
    raw.sort(key=lambda r: r[:3])
    return [dataclasses.replace(ev, rid=i)
            for i, (_, _, _, ev) in enumerate(raw)]


def as_requests(events: List[WorkloadEvent]) -> list:
    """Map a trace onto ``scheduler.Request`` objects (imported lazily:
    the generator itself stays importable without the serve engine)."""
    from repro_torch.serve.scheduler import Request
    return [Request(rid=e.rid, prompt=e.prompt, max_new=e.max_new,
                    arrival=e.arrival, deadline=e.deadline,
                    abort_at=e.abort_at, timeout=e.timeout)
            for e in events]


def trace_fingerprint(events: List[WorkloadEvent]) -> bytes:
    """Byte-exact digest of a trace — two generator runs agree iff their
    fingerprints agree (the determinism check in ``check_env --traffic``
    and tests/test_workload.py)."""
    parts = []
    for e in events:
        head = (f"{e.rid}|{e.tenant}|{e.max_new}|{e.arrival}|{e.deadline}"
                f"|{e.abort_at}|{e.timeout}|").encode()
        parts.append(head + np.asarray(e.prompt, np.int32).tobytes())
    return b"\x00".join(parts)
