"""LM token stream: a deterministic synthetic batch in (seed, step).

The distribution is a Zipfian unigram mix with short-range repetition
structure, so small models have learnable signal. numpy only; the
reference's sharded placement and prefetch thread wait for the training
slice (ROADMAP Queue 1).
"""
from __future__ import annotations

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
