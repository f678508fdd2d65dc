"""Request-level scheduler for continuous batching (host-side, pure Python).

Counterpart of ``repro.serve.scheduler``, kept as the port's own copy with
only its imports changed.

The serving stack splits into two layers:

  * THIS module — everything request-shaped and dynamic: the admission
    queue, the shared refcounted page pool, per-slot sequence state
    (request id, prompt length, tokens generated, per-request sampling
    stream), slot free/reuse on EOS/max_new, demand-driven page growth
    with deterministic preemption, and the exact shared-prefix cache
    (serve/prefix_cache.py).  Nothing here touches a device; decisions
    are made once per scheduler TICK, not per token.
  * ``serve/engine.ContinuousEngine`` — five device programs
    (prefill-into-slot, suffix prefill for warm prefixes, chunked
    prefill, batched decode over all slots, and the speculative
    verify-k) whose dynamic state (page table, per-slot lengths) lives in
    device tensors.

Paging is DEMAND-DRIVEN (vLLM-style): admission allocates only the
pages covering the prompt — ``ceil(plen / page_size)`` minus whatever a
prefix-cache hit shares — and each decode tick grows every active slot
just far enough for that tick's writes (``Scheduler.ensure_capacity``).
On pool exhaustion the scheduler first evicts LRU refcount-0 prefix-
cache pages, then PREEMPTS the youngest active slot (its private pages
return to the pool, its request requeues at the head of the FIFO —
deterministic, and with per-request sampling streams the re-run
regenerates the identical token stream).  With the prefix cache on,
preemption is PARTIAL-SUFFIX: the victim's full written pages are
adopted by the prefix cache and the request requeues with its effective
prompt (original + generated so far), so re-admission recomputes at
most one partial page instead of the whole stream.  Physical page 0 is the TRASH
page (layers.TRASH_PAGE): freed slots' table rows point at it, which
lets the static decode program keep writing for inactive slots without
corrupting reallocated pages.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.models.layers import TRASH_PAGE
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serve.prefix_cache import PrefixCache


@dataclasses.dataclass
class Request:
    """One generation request.  Every time field is a scheduler TICK
    index, so traces are deterministic (no wall-clock anywhere).

      * ``deadline``: soft completion SLO (absolute tick) — goodput
        metrics count completions at or before it; nothing is cancelled;
      * ``abort_at``: hard client abort — the request is cancelled at
        this tick whatever stage it is in (queued, mid-chunked-prefill,
        decoding, preempted-and-requeued);
      * ``timeout``: hard cancel ``timeout`` ticks after ``arrival`` if
        not finished by then.
    """
    rid: int
    prompt: np.ndarray
    max_new: int = 32
    arrival: int = 0
    deadline: Optional[int] = None
    abort_at: Optional[int] = None
    timeout: Optional[int] = None


@dataclasses.dataclass
class SlotState:
    """Device-slot bookkeeping for one admitted request."""
    rid: int
    plen: int
    max_new: int
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    written: int = 0        # cache rows written so far (prefill + decode)
    prefill_pos: int = 0    # prompt rows already in the cache (chunked
                            # prefill; == plen once prefill is complete)

    @property
    def prefilling(self) -> bool:
        return self.prefill_pos < self.plen

    @property
    def remaining(self) -> int:
        return self.max_new - len(self.tokens)


class PagePool:
    """Refcounted allocator over the physical page pool (page 0 = trash).

    ``alloc`` hands out pages at refcount 1; ``ref`` adds a holder (a
    slot sharing a cached prefix page, or the prefix cache adopting a
    slot's page); ``free`` drops one reference per page and returns the
    page to the free list only when nobody holds it.  Double-frees and
    out-of-range ids raise — silent acceptance masks page-table
    corruption (a freed page reused by another slot while a stale row
    still points at it).
    """

    def __init__(self, total_pages: int):
        if total_pages < 2:
            raise ValueError("page pool needs >= 2 pages (1 is the trash "
                             "page)")
        self.total_pages = total_pages
        self._free = list(range(total_pages - 1, 0, -1))   # LIFO; skip trash
        self._refs: Dict[int, int] = {}                    # page -> holders

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return len(self._refs)

    def _check(self, page: int) -> None:
        if page == TRASH_PAGE:
            raise ValueError("cannot free/ref the trash page")
        if not (0 < page < self.total_pages):
            raise ValueError(f"page {page} out of range "
                             f"(pool has {self.total_pages} pages)")

    def refcount(self, page: int) -> int:
        self._check(page)
        return self._refs.get(page, 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def ref(self, page: int) -> None:
        self._check(page)
        if page not in self._refs:
            raise ValueError(f"page {page} is not allocated (cannot add a "
                             f"reference to a free page)")
        self._refs[page] += 1

    def free(self, pages: List[int]) -> None:
        for p in pages:
            self._check(p)
            if p not in self._refs:
                raise ValueError(f"double free of page {p} (not allocated)")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._free.append(p)


class Scheduler:
    """Admission queue + slot/page lifecycle for the continuous engine.

    The engine drives it tick by tick:
      1. ``submit`` requests (any time; ``arrival`` gates admission);
      2. ``admit(tick)`` -> [(slot, Request, page_row, pfx)] newly placed
         requests; ``pfx`` is the shared-prefix token count (0 = cold) —
         the engine prefills only the suffix;
      3. ``ensure_capacity(T)`` grows page rows for the tick's decode
         writes (may evict cached pages / preempt the youngest slot);
      4. decode for ``tick_steps()`` steps, then feed the emitted tokens
         back via ``commit(slot, toks)``;
      5. finished slots are released (pages back to the pool — shared
         pages stay alive while the prefix cache or other slots hold
         them) and show up as results.
    """

    def __init__(self, n_slots: int, max_len: int, page_size: int,
                 total_pages: Optional[int] = None,
                 slot_pages: Optional[int] = None,
                 prefix_cache: bool = False,
                 prefix_cache_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 tracer=None):
        # host-side telemetry (obs/trace.py) — NULL_TRACER when untraced.
        # One span per request (submit -> done/cancelled), instants for
        # admit/preempt/prefill chunks, counters for page movements.
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.n_slots = n_slots
        self.max_len = max_len
        self.page_size = page_size
        # chunked prefill: a prompt enters the cache ``prefill_chunk``
        # tokens per TICK (``prefill_work``) instead of all at once at
        # admission, so one long prompt never stalls a decode tick by
        # more than one chunk.  None = prefill everything at admission.
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, "
                             f"got {prefill_chunk}")
        self.prefill_chunk = prefill_chunk
        # page-table row width: SWA caches roll within min(max_len, window)
        # logical tokens, so the engine passes its (smaller) row width in
        self.n_pages_slot = slot_pages or -(-max_len // page_size)
        if total_pages is None:
            total_pages = 1 + n_slots * self.n_pages_slot
        if total_pages - 1 < self.n_pages_slot:
            raise ValueError(
                f"page pool ({total_pages}) cannot hold even one full "
                f"slot reservation ({self.n_pages_slot} pages)")
        self.pool = PagePool(total_pages)
        self.total_pages = total_pages
        self.prefix_cache: Optional[PrefixCache] = (
            PrefixCache(self.pool, page_size, prefix_cache_pages,
                        tracer=self.tracer)
            if prefix_cache else None)
        self.queue: deque = deque()
        self.slots: List[Optional[SlotState]] = [None] * n_slots
        self._held: Dict[int, List[int]] = {}      # slot -> referenced pages
        self._rows: Dict[int, np.ndarray] = {}     # slot -> page-table row
        self._npages: Dict[int, int] = {}          # slot -> allocated pages
        self._reqs: Dict[int, Request] = {}        # slot -> live Request
        self._adm_seq: Dict[int, int] = {}         # slot -> admission seq
        self._seq = 0
        # chunked mode: prefix-cache insertion is DEFERRED until a slot's
        # final chunk is issued (its pages hold nothing shareable before)
        self._pending_insert: Dict[int, np.ndarray] = {}
        # partial-suffix preemption: rid -> (original prompt, tokens
        # generated before preemption).  The requeued request carries the
        # EFFECTIVE prompt (original + generated) so re-admission shares
        # the retained full pages and prefills only the tail; the saved
        # tokens are restored into the new SlotState so the result stream
        # is the full generation.  Entries are dropped on re-admission,
        # cancel, or fallback-to-recompute.
        self._resume: Dict[int, Tuple[np.ndarray, List[int]]] = {}
        # engine-set cap on the re-admission suffix (its static prefill
        # pad).  A resumed request whose retained pages were LRU-evicted
        # under pool pressure may face a suffix longer than the pad —
        # admit() then falls back to recomputing the original request.
        # None = no cap (chunked prefill streams any suffix).
        self.resume_pad: Optional[int] = None
        self.results: Dict[int, np.ndarray] = {}
        # rid -> {"reason", "stage", "tokens"} for aborted/timed-out
        # requests (they never appear in ``results``)
        self.cancelled: Dict[int, dict] = {}
        # (tick, slot, rid, chunk_tokens) per issued prefill chunk — the
        # per-tick-per-slot chunk-bound evidence the tests assert on
        self.prefill_log: List[Tuple[int, int, int, int]] = []
        # counters for the throughput bench / tests
        self.stats = {"admitted": 0, "completed": 0, "decode_steps": 0,
                      "slot_steps": 0, "active_slot_steps": 0,
                      "prefilled_tokens": 0, "prefix_tokens_skipped": 0,
                      "shared_pages": 0, "private_pages": 0,
                      "demand_pages": 0, "preemptions": 0, "cancelled": 0}

    # ---- submission / admission -----------------------------------------

    def submit(self, req: Request) -> None:
        if len(req.prompt) + req.max_new > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt {len(req.prompt)} + max_new "
                f"{req.max_new} exceeds max_len {self.max_len}")
        if req.max_new < 1:
            raise ValueError(f"request {req.rid}: max_new must be >= 1")
        self.queue.append(req)
        # the request span opens at queue entry (ts = arrival tick) and
        # closes exactly once, in commit() or _record_cancel() — preemption
        # requeues WITHOUT reopening, so span balance mirrors lifecycle
        # conservation (submitted == completed + cancelled at drain)
        self.tracer.begin(f"req:{req.rid}", "request", ts=req.arrival,
                          plen=len(req.prompt), max_new=req.max_new)

    def _alloc_or_evict(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` pages; on exhaustion, evict LRU prefix-cache
        pages first (pool pressure beats cache warmth), then retry."""
        pages = self.pool.alloc(n)
        if pages is None and self.prefix_cache is not None:
            self.prefix_cache.evict(n - self.pool.free_pages)
            pages = self.pool.alloc(n)
        return pages

    def _admission_plan(self, req: Request
                        ) -> Tuple[int, int, List[int], int]:
        """Prompt length, pages needed, shared prefix pages, and shared
        token count for admitting ``req`` (no allocation, no refs)."""
        plen = len(req.prompt)
        prompt_pages = min(max(1, -(-plen // self.page_size)),
                           self.n_pages_slot)
        shared: List[int] = []
        if self.prefix_cache is not None and plen > 1:
            shared = self.prefix_cache.match(req.prompt)
            shared = shared[:(plen - 1) // self.page_size]
        return plen, prompt_pages, shared, len(shared) * self.page_size

    def admit(self, tick: int) -> List[Tuple[int, Request, np.ndarray, int]]:
        """Place queued requests (arrival <= tick) into free slots while
        the pool can cover their prompts.  FIFO head-of-line: the queue is
        not reordered around a request that doesn't fit yet.

        With the prefix cache on, the longest cached full-page prefix of
        the prompt is SHARED: the slot's page-table row points at the
        cached physical pages (one pool reference each) and only the
        suffix needs private pages + prefill.  The match is capped at
        ``plen - 1`` tokens so the suffix is never empty (the engine
        still needs the last prompt token's logits to sample from); the
        partial tail page is always recomputed into a private page.
        """
        self.tracer.set_time(tick)
        placed = []
        for slot in range(self.n_slots):
            if not self.queue or self.slots[slot] is not None:
                continue
            req = self.queue[0]
            if req.arrival > tick:
                break
            resume = self._resume.get(req.rid)
            # demand-driven: only the PROMPT's pages at admission; decode
            # pages come from ensure_capacity tick by tick
            plen, prompt_pages, shared, pfx = self._admission_plan(req)
            if (resume is not None and self.resume_pad is not None
                    and plen - pfx > self.resume_pad):
                # pool pressure evicted the retained pages since the
                # preemption: the unshared suffix no longer fits the
                # engine's static prefill pad — fall back to a full
                # recompute of the ORIGINAL request (per-request greedy
                # streams regenerate the identical tokens)
                self._resume.pop(req.rid)
                req = dataclasses.replace(req, prompt=resume[0])
                self.queue[0] = req
                resume = None
                plen, prompt_pages, shared, pfx = self._admission_plan(req)
            # pin the matched pages BEFORE allocating: at refcount 1 the
            # eviction inside _alloc_or_evict could reclaim them and hand
            # them straight back as this request's private pages (one
            # physical page aliased as both prefix and suffix)
            for p in shared:
                self.pool.ref(p)
            priv = self._alloc_or_evict(prompt_pages - len(shared))
            if priv is None:
                # waiting is safe, not livelock: the pin cannot starve the
                # pool on its own (every non-pinned cache node is
                # evictable and usable pages >= n_pages_slot >=
                # prompt_pages), so failure means other ACTIVE slots hold
                # the pages — and they always finish
                self.pool.free(shared)          # unpin; retry next tick
                break
            self.queue.popleft()
            st = SlotState(req.rid, plen, req.max_new, written=plen,
                           prefill_pos=plen if self.prefill_chunk is None
                           else pfx)
            if resume is not None:
                # partial-suffix re-admission: the effective prompt ends
                # with the retained generation — restore it so commit()
                # budgets (max_new) and results cover the FULL stream.
                # The _resume entry stays (its [0] is the ORIGINAL prompt,
                # needed if this slot is preempted again); it is dropped
                # on completion or cancellation.
                st.tokens = list(resume[1])
            self.slots[slot] = st
            self._reqs[slot] = req
            self._adm_seq[slot] = self._seq
            self._seq += 1
            self._held[slot] = list(shared) + priv
            self._npages[slot] = prompt_pages
            row = np.full((self.n_pages_slot,), TRASH_PAGE, np.int32)
            row[:len(shared)] = shared
            row[len(shared):prompt_pages] = priv
            self._rows[slot] = row
            if self.prefix_cache is not None:
                self.prefix_cache.count(len(shared))
                if self.prefill_chunk is None:
                    # register this prompt's full pages for future
                    # admissions (contents land during this admission's
                    # prefill, before any later prefill could read them —
                    # admissions are prefilled in ``placed`` order)
                    self.prefix_cache.insert(req.prompt, row)
                else:
                    # chunked: pages fill over several ticks — insertion
                    # is deferred to the final chunk (``prefill_work``)
                    # so a later admission can never share unwritten pages
                    self._pending_insert[slot] = req.prompt
            self.stats["admitted"] += 1
            self.stats["prefilled_tokens"] += plen - pfx
            self.stats["prefix_tokens_skipped"] += pfx
            self.stats["shared_pages"] += len(shared)
            self.stats["private_pages"] += len(priv)
            trc = self.tracer
            trc.instant(f"req:{req.rid}", "admit", slot=slot, pfx=pfx)
            trc.counter("sched_admitted")
            if shared:
                trc.counter("pages_shared", len(shared))
            if priv:
                trc.counter("pages_private", len(priv))
            placed.append((slot, req, row.copy(), pfx))
        return placed

    # ---- chunked prefill --------------------------------------------------

    def prefill_work(self, tick: int
                     ) -> List[Tuple[int, Request, int, int, bool]]:
        """One prefill chunk per mid-prefill slot for this tick (chunked
        mode only).  Returns [(slot, request, start, clen, last)]: the
        engine writes prompt[start : start + clen] into the slot's pages
        (positions [start, start + clen)); ``last`` marks the final chunk
        (short, samples the first token via the suffix program).  At most
        ``prefill_chunk`` prompt tokens enter the cache per slot per tick
        — ``prefill_log`` records (tick, slot, rid, clen) as evidence."""
        if self.prefill_chunk is None:
            return []
        self.tracer.set_time(tick)
        out = []
        for slot in range(self.n_slots):
            st = self.slots[slot]
            if st is None or not st.prefilling:
                continue
            start = st.prefill_pos
            last = start + self.prefill_chunk >= st.plen
            clen = (st.plen - start) if last else self.prefill_chunk
            st.prefill_pos = start + clen
            if last and slot in self._pending_insert:
                # the slot's pages are fully written once the engine runs
                # this chunk (before any future admission could match)
                self.prefix_cache.insert(self._pending_insert.pop(slot),
                                         self._rows[slot])
            self.prefill_log.append((tick, slot, st.rid, clen))
            self.tracer.instant(f"req:{st.rid}", "prefill_chunk", slot=slot,
                                start=start, clen=clen, last=last)
            out.append((slot, self._reqs[slot], start, clen, last))
        return out

    # ---- demand-driven page growth / preemption --------------------------

    def _youngest_active(self) -> Optional[int]:
        live = [s for s, st in enumerate(self.slots) if st is not None]
        if not live:
            return None
        return max(live, key=lambda s: self._adm_seq[s])

    def _release_slot(self, slot: int) -> Request:
        """Return every page the slot holds to the pool and clear its
        state (complete/preempt/cancel all funnel through here — ONE
        place owns the page/slot conservation invariant)."""
        req = self._reqs.pop(slot)
        held = self._held.pop(slot)
        self.pool.free(held)
        self.tracer.counter("pages_released", len(held))
        self.slots[slot] = None
        self._rows.pop(slot)
        self._npages.pop(slot)
        self._adm_seq.pop(slot)
        self._pending_insert.pop(slot, None)
        return req

    def _preempt(self, slot: int) -> None:
        """Release ``slot`` and requeue its request at the FIFO head.

        With the prefix cache on, preemption is PARTIAL-SUFFIX: the
        slot's already-computed FULL pages (exactly the first ``written``
        rows — spec-mode rollback via ``PagedKVCache.truncate_to`` keeps
        device lengths == written) are adopted by the prefix cache
        before release, and the request requeues with the EFFECTIVE
        prompt (original + ALL committed tokens, length written + 1) so
        re-admission shares those pages and prefills only the tail.
        The resumed stream is bit-identical to an uninterrupted run:
        suffix prefill is quantize-then-attend through the same pages,
        and the continuation logits come from the same cache state.

        Without the prefix cache (or for a mid-prefill victim) this is
        recompute-style preemption: generated tokens are discarded and
        per-request greedy/sampling streams regenerate the identical
        stream on re-admission."""
        st = self.slots[slot]
        keep = (self.prefix_cache is not None and not st.prefilling
                and st.written >= self.page_size)
        # the ORIGINAL prompt: a once-resumed slot's live Request already
        # carries an effective prompt, so orig + st.tokens (tokens since
        # the FIRST admission) is the invariant reconstruction — its
        # length equals ``written + 1`` at every preemption depth (the
        # last committed token's row is always one tick from landing)
        rid = self._reqs[slot].rid
        orig = (self._resume[rid][0] if rid in self._resume
                else self._reqs[slot].prompt)
        if keep:
            # the effective prompt is orig + ALL committed tokens — the
            # LAST committed token's cache row is not written yet (it is
            # the next tick's input), so the page-cache insert is capped
            # at ``written`` rows while the requeued prompt keeps the
            # full stream (suffix prefill rewrites that one row and
            # samples the continuation, bit-identically)
            seq = np.concatenate([np.asarray(orig, np.int32),
                                  np.asarray(st.tokens, np.int32)])
            # adopt the full written pages BEFORE release: insert refs
            # them, so _release_slot's free leaves them alive in the tree
            self.prefix_cache.insert(seq[:st.written], self._rows[slot])
        req = self._release_slot(slot)
        if keep:
            self._resume[rid] = (orig, list(st.tokens))
            req = dataclasses.replace(req, prompt=seq)
        self.queue.appendleft(req)
        self.stats["preemptions"] += 1
        # the request span stays OPEN across preemption (it is still live,
        # just requeued); the instant marks the eviction point
        self.tracer.instant(f"req:{rid}", "preempt", slot=slot, keep=keep)
        self.tracer.counter("sched_preempted")

    def ensure_capacity(self, steps: int, advance: bool = True
                        ) -> Tuple[List[Tuple[int, np.ndarray]], List[int]]:
        """Grow every active slot's page row to cover this tick's
        ``steps`` decode writes.  Returns (growth, preempted): ``growth``
        is [(slot, new_row)] page-table updates for the engine; pool
        exhaustion evicts prefix-cache pages first, then preempts the
        youngest active slot until the survivors fit (the oldest slot is
        never preempted, so the trace always progresses).

        ``advance=False`` (speculative mode): grow rows for the
        worst-case ``steps`` (= k) candidate writes but do NOT bump
        ``written`` — the engine reports each slot's ACCEPTED length
        after the verify via ``advance_written``, so the high-water mark
        tracks only rows that survive the rollback."""
        growth: List[Tuple[int, np.ndarray]] = []
        preempted: List[int] = []
        if steps > 0:
            for slot in range(self.n_slots):
                while self.slots[slot] is not None:
                    st = self.slots[slot]
                    if st.prefilling:
                        # mid-chunked-prefill: no decode write this tick
                        # (masked in the decode program); prompt pages
                        # were fully allocated at admission
                        break
                    last = st.written + steps - 1       # last pos written
                    want = min(last // self.page_size + 1, self.n_pages_slot)
                    n_new = want - self._npages[slot]
                    if n_new <= 0:
                        break
                    pages = self._alloc_or_evict(n_new)
                    if pages is not None:
                        row = self._rows[slot]
                        row[self._npages[slot]:want] = pages
                        self._held[slot].extend(pages)
                        self._npages[slot] = want
                        self.stats["demand_pages"] += n_new
                        self.tracer.counter("pages_demand", n_new)
                        growth.append((slot, row.copy()))
                        break
                    victim = self._youngest_active()
                    if victim is None or victim == slot == \
                            self._oldest_active():
                        raise RuntimeError(
                            "page pool too small for a single request "
                            "(ensure_capacity cannot free more pages)")
                    self._preempt(victim)
                    preempted.append(victim)
                    if victim == slot:
                        break
        if advance:
            for st in self.slots:
                if st is not None and not st.prefilling:
                    st.written += max(0, steps)
        return growth, preempted

    def advance_written(self, slot: int, n: int) -> None:
        """Speculative-mode bookkeeping: advance a slot's ``written``
        high-water mark by its ACCEPTED length for the tick (the engine
        rolled back the rejected candidate rows via ``truncate_to``, so
        device lengths == written stays the invariant).  Call before
        ``commit`` — commit may release the slot."""
        st = self.slots[slot]
        if st is not None and not st.prefilling:
            st.written += max(0, n)

    def _oldest_active(self) -> Optional[int]:
        live = [s for s, st in enumerate(self.slots) if st is not None]
        if not live:
            return None
        return min(live, key=lambda s: self._adm_seq[s])

    # ---- decode bookkeeping ----------------------------------------------

    def active_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    def decoding_slots(self) -> List[int]:
        """Active slots that are past prefill — the slots that emit (and
        commit) tokens this tick.  Mid-chunked-prefill slots are active
        (they hold pages) but not decoding."""
        return [i for i, s in enumerate(self.slots)
                if s is not None and not s.prefilling]

    def tick_steps(self, chunk: int,
                   pending: Optional[Dict[int, int]] = None) -> int:
        """Decode steps this tick: bounded by the tightest remaining
        budget so no active slot ever writes past its logical capacity.
        ``pending``: per-slot tokens already emitted but not yet committed
        (the engine's prefill-sampled first tokens) — they count against
        the budget.  Mid-chunked-prefill slots emit nothing and do not
        constrain the tick."""
        pending = pending or {}
        rem = [s.remaining - pending.get(i, 0)
               for i, s in enumerate(self.slots)
               if s is not None and not s.prefilling]
        return min([chunk] + rem) if rem else 0

    def commit(self, slot: int, toks: np.ndarray, eos_id: int) -> None:
        """Feed one tick's emitted tokens for ``slot``; finishes the slot
        on EOS or exhausted budget (page references return to the pool —
        pages shared with the prefix cache or other slots stay alive)."""
        st = self.slots[slot]
        for t in toks:
            if st.done:
                break
            st.tokens.append(int(t))
            if int(t) == eos_id or len(st.tokens) >= st.max_new:
                st.done = True
        if st.done:
            self.results[st.rid] = np.asarray(st.tokens, np.int32)
            self._release_slot(slot)
            self._resume.pop(st.rid, None)
            self.stats["completed"] += 1
            self.tracer.end(f"req:{st.rid}", "request",
                            ntokens=len(st.tokens))
            self.tracer.counter("sched_completed")

    # ---- request lifecycle: abort / timeout ------------------------------

    @staticmethod
    def _due(req: Request, tick: int) -> Optional[str]:
        """Hard-cancel reason for ``req`` at ``tick``, or None.  Checked
        at the START of a tick, before admission or any prefill/decode
        work is issued for it."""
        if req.abort_at is not None and tick >= req.abort_at:
            return "abort"
        if req.timeout is not None and tick >= req.arrival + req.timeout:
            return "timeout"
        return None

    def _record_cancel(self, req: Request, reason: str, stage: str,
                       tokens: List[int]) -> None:
        self.cancelled[req.rid] = {"reason": reason, "stage": stage,
                                   "tokens": np.asarray(tokens, np.int32)}
        self.stats["cancelled"] += 1
        # every cancel path (client abort / timeout, queued or placed)
        # funnels through here — the single span-closing point for
        # requests that never complete
        self.tracer.end(f"req:{req.rid}", "request", reason=reason,
                        stage=stage)
        self.tracer.counter("sched_cancelled")

    def cancel(self, rid: int, reason: str = "abort") -> bool:
        """Cancel request ``rid`` wherever it lives — queued (including
        preempted-and-requeued), mid-chunked-prefill, or decoding.  Slot
        pages funnel through ``_release_slot`` so conservation holds at
        every stage.  Returns False if the rid is unknown/finished."""
        for i, req in enumerate(self.queue):
            if req.rid == rid:
                del self.queue[i]
                resume = self._resume.pop(rid, None)
                self._record_cancel(req, reason, "queued",
                                    [] if resume is None else resume[1])
                return True
        for slot, st in enumerate(self.slots):
            if st is not None and st.rid == rid:
                stage = "prefill" if st.prefilling else "decode"
                req = self._release_slot(slot)
                self._resume.pop(rid, None)
                self._record_cancel(req, reason, stage, st.tokens)
                return True
        return False

    def expire(self, tick: int) -> List[Tuple[Optional[int], int, str, str]]:
        """Run all due aborts/timeouts for ``tick`` (call at tick start,
        before ``admit``).  Returns [(slot_or_None, rid, stage, reason)] —
        the engine uses the freed slots to reset its host-side state."""
        self.tracer.set_time(tick)
        out: List[Tuple[Optional[int], int, str, str]] = []
        for req in [r for r in self.queue
                    if self._due(r, tick) is not None]:
            reason = self._due(req, tick)
            self.queue.remove(req)
            resume = self._resume.pop(req.rid, None)
            self._record_cancel(req, reason, "queued",
                                [] if resume is None else resume[1])
            out.append((None, req.rid, "queued", reason))
        for slot in range(self.n_slots):
            st = self.slots[slot]
            if st is None:
                continue
            reason = self._due(self._reqs[slot], tick)
            if reason is None:
                continue
            stage = "prefill" if st.prefilling else "decode"
            req = self._release_slot(slot)
            self._resume.pop(req.rid, None)
            self._record_cancel(req, reason, stage, st.tokens)
            out.append((slot, req.rid, stage, reason))
        return out

    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def count_tick(self, steps: int, n_active: Optional[int] = None) -> None:
        """``n_active``: slots that were active DURING the tick (the caller
        snapshots it before commits free finished slots)."""
        if n_active is None:
            n_active = len(self.active_slots())
        self.stats["decode_steps"] += steps
        self.stats["slot_steps"] += steps * self.n_slots
        self.stats["active_slot_steps"] += steps * n_active

    @property
    def slot_utilization(self) -> float:
        """Active-slot decode steps / total slot-steps spent."""
        tot = self.stats["slot_steps"]
        return self.stats["active_slot_steps"] / tot if tot else 0.0

    @property
    def prefix_hit_rate(self) -> float:
        """Admissions that reused at least one cached prefix page."""
        adm = self.stats["admitted"]
        pc = self.prefix_cache
        return (pc.stats["hits"] / adm) if (pc and adm) else 0.0
