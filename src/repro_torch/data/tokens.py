"""LM token stream: a deterministic synthetic batch in (seed, step),
sharded placement, and a background prefetch thread.

The distribution is a Zipfian unigram mix with short-range repetition
structure, so small models have learnable signal. The stream is numpy
only and deterministic in (seed, step), so a restarted or replacement
process regenerates identical data; ``sharded_batch`` places it on a
mesh with each process copying only its own block, as the reference's
``jax.make_array_from_callback``; ``Prefetcher`` keeps ``depth``
batches in flight ahead of the consumer on a host thread.
"""
from __future__ import annotations

import queue
import threading
from typing import Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig


def synth_tokens(cfg: ArchConfig, batch: int, seq: int, seed: int,
                 step: int) -> np.ndarray:
    """Deterministic (seed, step) -> (batch, seq) int32 batch."""
    rng = np.random.default_rng(np.uint64(seed) * 1000003 + np.uint64(step))
    v = cfg.vocab_size
    # Zipf over a clipped vocab + copy structure (periodic re-emission)
    base = rng.zipf(1.3, size=(batch, seq)).astype(np.int64)
    tok = np.minimum(base, v - 1)
    # inject repetition: with p=.3, token t = token t-k for k in [1,8]
    rep = rng.random((batch, seq)) < 0.3
    lag = rng.integers(1, 9, (batch, seq))
    idx = np.maximum(np.arange(seq)[None, :] - lag, 0)
    tok = np.where(rep, np.take_along_axis(tok, idx, 1), tok)
    return tok.astype(np.int32)


def lm_batch(cfg: ArchConfig, batch: int, seq: int, seed: int, step: int
             ) -> Tuple[np.ndarray, np.ndarray]:
    """(tokens, labels): labels are next-token shifted."""
    stream = synth_tokens(cfg, batch, seq + 1, seed, step)
    return stream[:, :-1], stream[:, 1:]


def sharded_batch(arrays, shardings):
    """Host arrays (a dict of numpy arrays) as DTensors on the mesh of
    ``shardings`` (the same keys, e.g. ``shardings.batch_shardings``):
    each rank takes its own block of each."""
    from repro_torch.dist.shardings import from_host
    return {k: from_host(a, shardings[k]) for k, a in arrays.items()}


class Prefetcher:
    """Background-thread pipeline: compute ``depth`` batches ahead of the
    consumer (``make_batch(step)`` for step 0, 1, ...)."""

    def __init__(self, make_batch, depth: int = 2):
        self._make = make_batch
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = 0
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        while not self._stop.is_set():
            item = self._make(self._step)
            self._step += 1
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
