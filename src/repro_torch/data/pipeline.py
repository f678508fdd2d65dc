"""Deterministic, restart-safe synthetic token pipeline (own copy of
``repro.data.pipeline``, numpy only: its batches are the reference's bit for
bit).

Every batch is a pure function of (dataset_seed, step), so a job restarted
from a step-N checkpoint consumes exactly the tokens it would have seen — the
fault-tolerance contract the trainer relies on (no data-loader state to
checkpoint).  Hosts slice their shard by (host_id, num_hosts); the same
mechanism shards across the `data`/`pod` mesh axes at scale.

The generator is a Zipf-ish Markov stream rather than iid-uniform so that
language-model losses have structure to learn (quantization ablations need a
descending loss curve, not a flat one).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    # synthetic stream structure
    zipf_a: float = 1.2
    markov_mix: float = 0.7     # prob of following the Markov chain


class SyntheticLM:
    """Markov-chain token stream with Zipf marginals (numpy, host-side)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V = cfg.vocab_size
        ranks = np.arange(1, V + 1, dtype=np.float64)
        self.marginal = ranks ** (-cfg.zipf_a)
        self.marginal /= self.marginal.sum()
        # sparse deterministic successor table: each token has 4 successors
        self.succ = rng.integers(0, V, size=(V, 4))

    def batch(self, step: int, *, host_id: int = 0,
              num_hosts: int = 1) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        if cfg.global_batch % num_hosts:
            raise ValueError("global_batch must divide across hosts")
        local = cfg.global_batch // num_hosts
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 64 + host_id)
        B, S = local, cfg.seq_len + 1           # +1 for the shifted target
        toks = np.empty((B, S), np.int64)
        toks[:, 0] = rng.choice(cfg.vocab_size, size=B, p=self.marginal)
        follow = rng.random((B, S)) < cfg.markov_mix
        chain_pick = rng.integers(0, 4, size=(B, S))
        fresh = rng.choice(cfg.vocab_size, size=(B, S), p=self.marginal)
        for t in range(1, S):
            chained = self.succ[toks[:, t - 1], chain_pick[:, t]]
            toks[:, t] = np.where(follow[:, t], chained, fresh[:, t])
        return {"tokens": toks.astype(np.int32)}

    def iter_batches(self, start_step: int = 0, *, host_id: int = 0,
                     num_hosts: int = 1) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step, host_id=host_id, num_hosts=num_hosts)
            step += 1


def make_eval_batches(cfg: DataConfig, n: int = 8):
    """Held-out batches: negative step ids never seen in training."""
    ds = SyntheticLM(cfg)
    return [ds.batch(-(i + 1)) for i in range(n)]
