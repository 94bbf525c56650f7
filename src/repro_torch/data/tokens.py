"""Synthetic token pipeline with background prefetch: the port's copy of
``repro.data.tokens`` (numpy only), yielding the same batches for a seed.

Sequences are drawn from a seeded order-2 Markov chain over the vocab with
a low-entropy transition table, so an LM has real structure to learn (the
loss drops well below uniform) without any external corpus. Generation
runs on a worker thread with a bounded queue: the host-side prefetch that
keeps device steps from waiting on data. ``close()`` stops the thread;
call it in a ``finally``.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

__all__ = ["TokenStream", "markov_batch"]


def _transition_rows(vocab: int, branch: int, seed: int):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(vocab, branch))


def markov_batch(rng, nexts, batch: int, seq: int):
    """(batch, seq + 1) int32 tokens: a random start, then each token one
    of ``branch`` successors of the previous, drawn from ``rng``."""
    vocab, branch = nexts.shape
    out = np.empty((batch, seq + 1), np.int32)
    out[:, 0] = rng.integers(0, vocab, batch)
    for t in range(seq):
        choice = rng.integers(0, branch, batch)
        out[:, t + 1] = nexts[out[:, t], choice]
    return out


class TokenStream:
    """Iterator of {"tokens", "labels"} (batch, seq) int32 batches (labels
    the tokens shifted by one), generated ahead by a worker thread."""

    def __init__(self, vocab: int, batch: int, seq: int, *, branch: int = 4,
                 seed: int = 0, prefetch: int = 4):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self._nexts = _transition_rows(vocab, branch, seed)
        self._rng = np.random.default_rng(seed + 1)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            seqs = markov_batch(self._rng, self._nexts, self.batch, self.seq)
            batch = {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        """Stop the worker, drain the queue and join the thread."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
