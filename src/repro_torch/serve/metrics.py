"""Simulated-clock serving metrics: TTFT/TPOT/goodput in scheduler TICKS.

Every timestamp in this module is a scheduler tick index — there is no
wall clock anywhere, so recorded trajectories are deterministic and
byte-comparable across runs/machines (the same discipline as the rest of
the serve layer).  ``ContinuousEngine.run`` drives a ``MetricsRecorder``
through the request lifecycle:

    submitted  -> request entered the trace (arrival tick, optional
                  deadline)
    admitted   -> first placed into a device slot
    first_token-> the request's FIRST token reached the host (commit);
                  preemption replays the identical stream, so the first
                  emission is the one the client saw — re-admissions
                  never move it
    finished   -> all tokens committed (EOS or max_new)
    cancelled  -> hard abort/timeout (stage: queued/prefill/decode)

Definitions (all in ticks):

    TTFT     = first_token_tick - arrival        (time to first token)
    TPOT     = (finish_tick - first_token_tick) / max(1, n_tokens - 1)
               (mean time per output token after the first)
    goodput  = completions at-or-before their deadline / submitted
               (requests without a deadline count as on-time when done)

Percentiles are NEAREST-RANK (no interpolation): deterministic, and a
reported p99 is always a latency some request actually experienced.

Host-side and numpy-only, like the scheduler.  Counterpart of
``repro.serve.metrics``, kept as the port's own copy with only its
imports changed.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.obs.trace import Counters, NULL_TRACER

PERCENTILES = (50, 95, 99)


def percentile(values: Sequence[float], p: float) -> float:
    """Nearest-rank percentile: the ceil(p/100 * n)-th smallest value.
    Returns NaN on an empty sample (JSON-safe via ``summary``)."""
    v = sorted(float(x) for x in values)
    if not v:
        return float("nan")
    if not (0 < p <= 100):
        raise ValueError(f"percentile p must be in (0, 100], got {p}")
    idx = int(np.ceil(p / 100.0 * len(v))) - 1
    return v[max(0, min(idx, len(v) - 1))]


def percentile_summary(values: Sequence[float],
                       pcts: Sequence[int] = PERCENTILES) -> Dict[str, float]:
    """{p50: ..., p95: ..., p99: ..., mean, max, n} for one metric."""
    out = {f"p{p}": percentile(values, p) for p in pcts}
    out["mean"] = float(np.mean(values)) if len(values) else float("nan")
    out["max"] = float(max(values)) if len(values) else float("nan")
    out["n"] = len(values)
    return out


class MetricsRecorder:
    """Per-request lifecycle timestamps + per-tick gauges, summarized to
    percentile dictionaries.  One recorder per ``run()`` trace.

    Counter state lives on the obs-layer ``Counters`` substrate
    (obs/trace.py) — the same primitive a ``Tracer`` accumulates into —
    and when a tracer is attached every lifecycle event is mirrored into
    the trace: lifecycle counters, first-token instants, queue/active
    gauges per tick.  ``summary()`` shapes are unchanged (``Counters`` is
    mapping-like, so ``dict(self.counters)`` still snapshots it)."""

    def __init__(self, tracer=None):
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.requests: Dict[int, dict] = {}
        self.queue_depth: List[int] = []       # gauge, one entry per tick
        self.active_depth: List[int] = []      # decoding slots per tick
        self.counters = Counters()             # scheduler stats snapshot
        self.lifecycle = Counters()            # own event tallies
        # speculative decoding (one sample per SLOT per verify tick):
        # tokens the verify emitted for that slot (accepted prefix + the
        # corrected token, 1..k) and its acceptance rate (accepted
        # drafts / (k-1) proposed)
        self.spec_accepted: List[int] = []
        self.spec_rate: List[float] = []

    # ---- lifecycle events ----------------------------------------------

    def submitted(self, rid: int, arrival: int,
                  deadline: Optional[int] = None) -> None:
        self.requests[rid] = {"arrival": int(arrival),
                              "deadline": deadline,
                              "admitted": None, "first": None,
                              "done": None, "ntokens": 0,
                              "cancelled": None}
        self.lifecycle.inc("submitted")
        self.tracer.counter("met_submitted", ts=int(arrival))

    def admitted(self, rid: int, tick: int) -> None:
        r = self.requests[rid]
        if r["admitted"] is None:       # re-admission after preemption
            r["admitted"] = int(tick)   # keeps the FIRST placement tick
            self.lifecycle.inc("admitted")

    def first_token(self, rid: int, tick: int) -> None:
        r = self.requests[rid]
        if r["first"] is None:          # preemption replays the identical
            r["first"] = int(tick)      # stream; the first emission stands
            self.lifecycle.inc("first_tokens")
            self.tracer.instant(f"req:{rid}", "first_token", ts=int(tick),
                                ttft=int(tick) - r["arrival"])

    def finished(self, rid: int, tick: int, ntokens: int) -> None:
        r = self.requests[rid]
        r["done"] = int(tick)
        r["ntokens"] = int(ntokens)
        self.lifecycle.inc("finished")
        self.tracer.counter("met_finished", ts=int(tick))

    def cancelled(self, rid: int, tick: int, stage: str,
                  reason: str) -> None:
        self.requests[rid]["cancelled"] = {"tick": int(tick),
                                           "stage": stage,
                                           "reason": reason}
        self.lifecycle.inc("cancelled")
        self.tracer.counter("met_cancelled", ts=int(tick))

    # ---- per-tick gauges / counters ------------------------------------

    def tick(self, queue_depth: int, n_active: int) -> None:
        self.queue_depth.append(int(queue_depth))
        self.active_depth.append(int(n_active))
        self.tracer.gauge("queue_depth", int(queue_depth))
        self.tracer.gauge("active_slots", int(n_active))

    def spec_tick(self, emitted: Sequence[int], k: int) -> None:
        """One speculative verify tick: ``emitted`` holds the per-slot
        token counts the verify emitted (accepted prefix + corrected
        token — 1..k each) for the slots that decoded this tick.  The
        accepted-tokens/tick/slot trajectory is ``emitted`` itself; the
        acceptance rate divides the accepted DRAFTS (emitted - 1) by the
        k-1 proposed."""
        for n in emitted:
            self.spec_accepted.append(int(n))
            self.spec_rate.append((int(n) - 1) / max(1, k - 1))
        if emitted:
            self.tracer.counter("spec_emitted_tokens",
                                sum(int(n) for n in emitted))

    def set_counters(self, stats: Dict[str, int]) -> None:
        self.counters = Counters({k: int(v) for k, v in stats.items()})

    # ---- summaries -----------------------------------------------------

    def ttfts(self) -> List[int]:
        return [r["first"] - r["arrival"] for r in self.requests.values()
                if r["first"] is not None]

    def tpots(self) -> List[float]:
        return [(r["done"] - r["first"]) / max(1, r["ntokens"] - 1)
                for r in self.requests.values()
                if r["done"] is not None and r["first"] is not None]

    def goodput(self) -> float:
        if not self.requests:
            return 0.0
        good = sum(1 for r in self.requests.values()
                   if r["done"] is not None
                   and (r["deadline"] is None
                        or r["done"] <= r["deadline"]))
        return good / len(self.requests)

    def summary(self) -> dict:
        done = [r for r in self.requests.values() if r["done"] is not None]
        canc = [r for r in self.requests.values()
                if r["cancelled"] is not None]
        out = {
            "ticks": len(self.queue_depth),
            "submitted": len(self.requests),
            "completed": len(done),
            "cancelled": len(canc),
            "goodput": self.goodput(),
            "ttft_ticks": percentile_summary(self.ttfts()),
            "tpot_ticks": percentile_summary(self.tpots()),
            "queue_depth": percentile_summary(self.queue_depth),
            "active_slots": percentile_summary(self.active_depth),
            "counters": dict(self.counters),
        }
        if self.spec_accepted:
            out["spec_accepted_per_tick_slot"] = percentile_summary(
                self.spec_accepted)
            out["spec_acceptance_rate"] = percentile_summary(self.spec_rate)
        return out
