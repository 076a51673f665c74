"""Deterministic sharded synthetic data pipeline with background prefetch,
copied from ``repro/data/pipeline.py`` (numpy only; the port imports nothing
of ``repro``, so it keeps this copy, and ``tests/test_torch_train.py`` holds
its batches equal to the reference's).

Each host process reads only its shard of the global batch; a
double-buffering prefetch thread keeps the next batch ready while the step
runs — the host-side half of compute/IO overlap.  The token stream is a
fixed-seed PRNG "corpus" with a repeating n-gram structure so small models
measurably learn (loss decreases) in the examples.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class SyntheticLM:
    """Deterministic pseudo-corpus: a Markov-ish token stream where token
    t+1 = (a * t + noise) % vocab with segment structure — learnable but
    non-trivial."""

    def __init__(self, vocab_size: int, seed: int = 0):
        self.vocab = vocab_size
        self.seed = seed

    def batch(self, step: int, batch_size: int, seq_len: int,
              shard: int = 0, n_shards: int = 1) -> dict:
        """Global batch ``step``; returns this shard's slice (host-disjoint,
        deterministic in (step, shard))."""
        assert batch_size % n_shards == 0
        local = batch_size // n_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))
        start = rng.integers(0, self.vocab, (local, 1))
        mult = rng.integers(2, 8, (local, 1))
        noise = rng.integers(0, 5, (local, seq_len))
        idx = np.arange(seq_len)[None, :]
        toks = (start + mult * idx + noise) % self.vocab
        return {"tokens": toks.astype(np.int32)}


class Prefetcher:
    """Background double-buffering over a batch-producing callable."""

    def __init__(self, make_batch, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._make = make_batch
        self._stop = threading.Event()
        self._step = 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            batch = self._make(self._step)
            self._step += 1
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
