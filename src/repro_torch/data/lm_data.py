"""Synthetic LM token pipeline: deterministic, shardable, prefetching
(port of ``repro.data.lm_data``, copied: pure numpy, so one seed gives
the reference's batches bit for bit).

Generates Zipf-distributed token streams with enough n-gram structure
for the CE loss to visibly decrease during the example training runs.
Host-side (numpy), double-buffered; batches come out as numpy, and the
caller moves them to its device.
"""
from __future__ import annotations

import threading
import queue
from typing import Dict, Iterator

import numpy as np


class TokenStream:
    def __init__(self, vocab: int, batch: int, seq_len: int, seed: int = 0,
                 zipf_a: float = 1.2):
        self.vocab, self.batch, self.seq = vocab, batch, seq_len
        self.rng = np.random.default_rng(seed)
        self.zipf_a = zipf_a
        # tiny bigram tendency: each token biases the next
        self._next_bias = self.rng.integers(0, vocab, size=min(vocab, 65536))

    def _sample(self, shape):
        z = self.rng.zipf(self.zipf_a, size=shape).astype(np.int64)
        return (z - 1) % self.vocab

    def next_batch(self, step: int) -> Dict[str, np.ndarray]:
        toks = self._sample((self.batch, self.seq + 1))
        # inject bigram structure on half the positions
        mask = self.rng.random((self.batch, self.seq)) < 0.5
        nb = self._next_bias[toks[:, :-1] % len(self._next_bias)]
        toks[:, 1:] = np.where(mask, nb, toks[:, 1:])
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.next_batch(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch (depth-N) around any batch iterator."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            for item in it:
                if self._stop.is_set():
                    return
                self.q.put(item)

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
