"""Deterministic synthetic LM data pipeline (``repro.data.pipeline``, the
port's own copy: numpy only, so both packages give the same tokens for
every (seed, step, host_id, num_hosts)).

Real frameworks stream tokenized shards per host; offline we synthesize a
reproducible stream with the same interface:

- ``TokenStream(cfg, seed)`` yields fixed-shape batches, deterministic in
  (seed, step) — restart-safe: resuming at step k reproduces batch k without
  replaying the stream (the paper's provenance concern, applied to data).
- per-host sharding: each host materializes only its slice of the global
  batch (``host_slice``), each host feeds its own slice of the global batch.

The synthetic distribution is a order-0 Zipf mixture with a repeated-ngram
process so the loss curve has learnable structure (tests assert loss drops).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    ngram_repeat_p: float = 0.5   # probability of copying an earlier window


class TokenStream:
    def __init__(self, cfg: DataConfig, host_id: int = 0, num_hosts: int = 1):
        assert cfg.global_batch % num_hosts == 0
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.local_batch = cfg.global_batch // num_hosts
        # Zipf-ish unigram distribution over a capped alphabet (cheap to draw)
        v = min(cfg.vocab_size, 32768)
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._probs = p / p.sum()
        self._v = v

    def batch_at(self, step: int) -> np.ndarray:
        """(local_batch, seq_len+1) int32, deterministic in (seed, step, host)."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, self.host_id]))
        b, s = self.local_batch, cfg.seq_len + 1
        toks = rng.choice(self._v, size=(b, s), p=self._probs).astype(np.int32)
        # inject copyable structure: repeat an earlier window later in the seq
        for i in range(b):
            if rng.random() < cfg.ngram_repeat_p and s >= 16:
                w = int(rng.integers(4, min(32, s // 2)))
                src = int(rng.integers(0, s - 2 * w))
                dst = int(rng.integers(src + w, s - w))
                toks[i, dst:dst + w] = toks[i, src:src + w]
        return toks

    def __iter__(self) -> Iterator[np.ndarray]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
