"""Exact shared-prefix cache over the paged NVFP4 KV pool.

Serving heavy multi-user traffic means most requests share long prompt
prefixes — system prompts, few-shot templates, chat history.  Because
cache rows are quantized at write time with deterministic RtN (the
paper's forward rounding) and K/V at position ``i`` depend causally only
on tokens ``<= i``, identical prefix tokens produce **bit-identical
quantized pages** — so prefix reuse is *exact* storage sharing, not an
approximation: a warm slot's decode reads the very same packed rows a
cold slot would have written.

Structure: a hash-block RADIX TREE keyed on full-page token chunks.
Each node covers exactly ``page_size`` tokens and maps that chunk (in
its prefix context — the path from the root) to one physical page of the
shared pool (``scheduler.PagePool``).  The tree holds one refcount on
every cached page; slots that share a page hold additional refcounts.
A page whose refcount has dropped back to the tree's own reference is
*evictable*; eviction is LRU over evictable leaves (leaf-first, so an
ancestor is never removed under a live descendant and every cached
prefix remains reachable from the root).

Nothing here touches a device: matching/insertion/eviction are
host-side scheduler-tick decisions, like the rest of
``serve/scheduler.py``.  Counterpart of ``repro.serve.prefix_cache``,
kept as the port's own copy with only its imports changed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs.trace import NULL_TRACER


@dataclasses.dataclass
class _Node:
    """One full page of tokens in its prefix context."""
    chunk: Tuple[int, ...]                 # the page_size tokens it covers
    page: int                              # physical page in the pool
    parent: Optional["_Node"]
    children: Dict[Tuple[int, ...], "_Node"] = dataclasses.field(
        default_factory=dict)
    last_used: int = 0                     # LRU clock at last match/insert


class PrefixCache:
    """Radix tree mapping full-page prompt prefixes to physical pages.

    ``pool`` is the shared ``scheduler.PagePool``; the cache owns one
    reference per cached page (taken at ``insert``, released at
    eviction).  ``max_pages`` bounds the number of cached pages —
    inserts beyond it evict least-recently-used evictable nodes first
    (``None``: bounded only by pool pressure via ``evict``).
    """

    def __init__(self, pool, page_size: int,
                 max_pages: Optional[int] = None, tracer=None):
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        if max_pages is not None and max_pages < 1:
            raise ValueError("max_pages must be >= 1 (or None)")
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.pool = pool
        self.page_size = page_size
        self.max_pages = max_pages
        self._root: Dict[Tuple[int, ...], _Node] = {}
        self._n_nodes = 0
        self._clock = 0
        self.stats = {"hits": 0, "misses": 0, "hit_pages": 0,
                      "inserted": 0, "evicted": 0}

    # ---- introspection ---------------------------------------------------

    @property
    def cached_pages(self) -> int:
        return self._n_nodes

    def _iter_nodes(self):
        stack = list(self._root.values())
        while stack:
            nd = stack.pop()
            yield nd
            stack.extend(nd.children.values())

    # ---- lookup ----------------------------------------------------------

    def match(self, tokens) -> List[int]:
        """Longest cached full-page prefix of ``tokens`` -> physical pages.

        Touches the matched path (LRU) but takes NO pool references and
        records NO hit/miss stats — the caller (scheduler admission) refs
        the pages it actually uses and calls ``count`` once per PLACED
        request (a blocked request may re-match every tick, and the
        plen-1 cap can drop a match to zero shared pages).
        """
        toks = np.asarray(tokens).tolist()
        self._clock += 1
        pages: List[int] = []
        level = self._root
        for i in range(len(toks) // self.page_size):
            chunk = tuple(toks[i * self.page_size:(i + 1) * self.page_size])
            nd = level.get(chunk)
            if nd is None:
                break
            nd.last_used = self._clock
            pages.append(nd.page)
            level = nd.children
        return pages

    def count(self, shared_pages: int) -> None:
        """Record one admission outcome: a hit iff it actually shared
        pages (after the scheduler's plen-1 cap)."""
        if shared_pages:
            self.stats["hits"] += 1
            self.stats["hit_pages"] += shared_pages
            self.tracer.counter("prefix_hits")
            self.tracer.counter("prefix_hit_pages", shared_pages)
        else:
            self.stats["misses"] += 1
            self.tracer.counter("prefix_misses")

    # ---- insertion -------------------------------------------------------

    def insert(self, tokens, pages) -> int:
        """Register every full-page chunk of ``tokens``; ``pages[i]`` is the
        physical page holding chunk ``i`` (a slot's page-table row).

        Chunks already cached are only touched (their existing page wins —
        contents are bit-identical by the RtN determinism argument); new
        chunks take one pool reference on the slot's page, so the page
        outlives the slot and becomes evictable once no slot shares it.
        Returns the number of newly cached pages.
        """
        toks = np.asarray(tokens).tolist()
        self._clock += 1
        added = 0
        level, parent = self._root, None
        for i in range(len(toks) // self.page_size):
            chunk = tuple(toks[i * self.page_size:(i + 1) * self.page_size])
            nd = level.get(chunk)
            if nd is None:
                page = int(pages[i])
                self.pool.ref(page)
                nd = _Node(chunk, page, parent, last_used=self._clock)
                level[chunk] = nd
                self._n_nodes += 1
                self.stats["inserted"] += 1
                added += 1
            else:
                nd.last_used = self._clock
            level, parent = nd.children, nd
        if added:
            self.tracer.counter("prefix_inserted_pages", added)
        if self.max_pages is not None and self._n_nodes > self.max_pages:
            self.evict(self._n_nodes - self.max_pages)
        return added

    # ---- eviction --------------------------------------------------------

    def _evictable(self, nd: _Node) -> bool:
        # leaf-first: never drop an ancestor under a live descendant;
        # refcount 1 == only the cache itself still holds the page
        return not nd.children and self.pool.refcount(nd.page) == 1

    def evict(self, n: int) -> int:
        """Release up to ``n`` pages back to the pool, LRU-first over
        evictable (refcount-only-ours, childless) nodes.  Returns the
        number actually freed — fewer when live slots pin the rest.

        One tree walk seeds a heap of evictable leaves; removing a leaf
        pushes its parent once it becomes childless and unpinned, so a
        whole cold chain drains in one call without re-walking."""
        import heapq
        if n <= 0:
            return 0
        heap = [(nd.last_used, nd.page, nd) for nd in self._iter_nodes()
                if self._evictable(nd)]
        heapq.heapify(heap)
        freed = 0
        while freed < n and heap:
            _, _, victim = heapq.heappop(heap)
            level = (victim.parent.children if victim.parent is not None
                     else self._root)
            del level[victim.chunk]
            self._n_nodes -= 1
            self.pool.free([victim.page])
            self.stats["evicted"] += 1
            freed += 1
            parent = victim.parent
            if parent is not None and self._evictable(parent):
                heapq.heappush(heap, (parent.last_used, parent.page, parent))
        if freed:
            self.tracer.counter("pages_evicted", freed)
            self.tracer.instant("prefix_cache", "lru_evict", n=freed)
        return freed
