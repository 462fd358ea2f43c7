"""Deterministic sharded data pipeline (a copy of ``repro.data.pipeline``,
which uses numpy only: the batches are bit-identical for the same seed,
step and host).

Synthetic-corpus token stream with the properties a real pipeline needs
for 1000-node training:

  * **host-sharded**: each data-parallel host computes only its slice of
    the global batch, indexed by (step, host_id) — no coordinator;
  * **deterministic & resumable**: batch contents are a pure function of
    (seed, step), so restoring a checkpoint at step k replays the exact
    stream with no state file beyond the step counter;
  * **prefetchable**: ``iterate`` yields ahead-of-time on a background
    thread (double-buffering compute against host data generation).

A file-backed tokenized corpus (memory-mapped .npy shards) is supported
through ``CorpusSource``; the synthetic source is the default for the
examples and benchmarks (no data download in this environment).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0


class SyntheticSource:
    """Zipf-ish token stream — pure function of (seed, step, host)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = 1.0 / ranks
        self.p = p / p.sum()

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        per_host = cfg.global_batch // cfg.n_hosts
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4096 + cfg.host_id)
        toks = rng.choice(cfg.vocab, size=(per_host, cfg.seq_len + 1),
                          p=self.p).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class CorpusSource:
    """Memory-mapped token shards; host h reads rows ≡ h (mod n_hosts)."""

    def __init__(self, cfg: DataConfig, paths):
        self.cfg = cfg
        self.shards = [np.load(p, mmap_mode="r") for p in paths]
        self.rows = sum(s.shape[0] for s in self.shards)

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        per_host = cfg.global_batch // cfg.n_hosts
        base = (step * cfg.global_batch + cfg.host_id * per_host) % self.rows
        rows = []
        for i in range(per_host):
            r = (base + i) % self.rows
            for s in self.shards:
                if r < s.shape[0]:
                    rows.append(np.asarray(s[r, : cfg.seq_len + 1]))
                    break
                r -= s.shape[0]
        toks = np.stack(rows).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def iterate(source, start_step: int = 0, prefetch: int = 2) -> Iterator[dict]:
    """Background-thread prefetching iterator (overlap host data gen)."""
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        step = start_step
        while not stop.is_set():
            try:
                q.put((step, source.batch(step)), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()
