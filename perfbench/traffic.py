"""The one general generator of traffic, read from a mix's parameters.

Sizes are stratified: a pool of ``pool`` requests takes the lengths at
the quantiles (i + 1/2) / pool of the mix's distribution, shuffled by
the seed, and clients cycle through it, so every seed serves the same
set of sizes in another order.
Token ids are uniform over the vocabulary, drawn from the seed and the
request's index. Training batches are drawn on the device from the seed
and the step.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

import numpy as np
import torch


def _seed_words(seed: int, *extra: int) -> List[int]:
    return [int(seed) % (1 << 64), *extra]


def lognormal_sigma(median: float, mean: float) -> float:
    """The log-scale spread of a log-normal with this median and mean:
    mean = median * exp(sigma^2 / 2)."""
    return math.sqrt(2.0 * math.log(mean / median))


def quantile_lengths(dist: Dict, n: int) -> np.ndarray:
    """The lengths at the quantiles (i + 1/2) / n of ``dist``, clipped to
    the whole numbers min..max: ``{"dist": "uniform" | "loguniform",
    "min": a, "max": b}``, or ``{"dist": "lognormal", "median": m,
    "mean": u, "min": a, "max": b}`` (the heavy tail of a published
    trace's median and mean, rounded to the nearest whole number)."""
    lo, hi = int(dist["min"]), int(dist["max"])
    u = (np.arange(n) + 0.5) / n
    if dist["dist"] == "uniform":
        x = lo + np.floor(u * (hi - lo + 1))
    elif dist["dist"] == "loguniform":
        x = np.floor(np.exp(math.log(lo) + u * (math.log(hi + 1)
                                                 - math.log(lo))))
    elif dist["dist"] == "lognormal":
        sigma = lognormal_sigma(float(dist["median"]), float(dist["mean"]))
        z = np.array([statistics.NormalDist().inv_cdf(q) for q in u])
        x = np.rint(float(dist["median"]) * np.exp(sigma * z))
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return np.clip(x, lo, hi).astype(np.int64)


class RequestPool:
    """The mix's requests in the order clients take them, cycling through
    a pool of ``pool`` requests: request j has ``prompt_len[j]`` prompt
    tokens and ``output_len[j]`` tokens to generate. A pool that a run
    goes through several times gives every seed nearly the same work in
    a window. The first request of each of the ``clients`` is cut to a
    share of its length drawn from the seed (the residual life of a
    request already running), so the closed loop starts with its
    completions spread as in its steady state."""

    def __init__(self, mix: Dict, seed: int, vocab: int):
        self.seed, self.vocab = int(seed), int(vocab)
        n = int(mix["pool"])
        rng = np.random.default_rng(_seed_words(seed, 1))
        self.prompt_len = rng.permutation(
            quantile_lengths(mix["prompt_tokens"], n))
        self.output_len = rng.permutation(
            quantile_lengths(mix["output_tokens"], n))
        clients = int(mix["clients"])
        full = self.output_len[np.arange(clients) % n]
        self.first_cut = np.maximum(
            1, np.ceil(rng.random(clients) * full)).astype(np.int64)
        self.taken = 0

    def __len__(self) -> int:
        return len(self.prompt_len)

    def prompt(self, j: int) -> np.ndarray:
        rng = np.random.default_rng(_seed_words(self.seed, 2, j))
        return rng.integers(0, self.vocab, int(self.prompt_len[j]),
                            dtype=np.int64).astype(np.int32)

    def take(self) -> Tuple[int, int]:
        """The next request: its index in the pool and its output
        length."""
        i = self.taken
        self.taken += 1
        j = i % len(self)
        n = self.first_cut[i] if i < len(self.first_cut) else \
            self.output_len[j]
        return j, int(n)


def train_batch(mix: Dict, seed: int, step: int, vocab: int, device
                ) -> Dict[str, torch.Tensor]:
    """Step ``step``'s rows: (batch, seq + 1) ids uniform over the
    vocabulary, drawn on the device from the seed and the step; tokens
    and their next-token labels."""
    b, s = int(mix["batch"]), int(mix["seq"])
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1000003 + int(step)) % (1 << 63))
    ids = torch.randint(0, vocab, (b, s + 1), generator=gen, device=device,
                        dtype=torch.int64).to(torch.int32)
    return {"tokens": ids[:, :-1].contiguous(),
            "labels": ids[:, 1:].contiguous()}


def train_feed(mix: Dict, seed: int, vocab: int, device):
    """The window's feed from step 1 on."""
    step = 1
    while True:
        yield train_batch(mix, seed, step, vocab, device)
        step += 1
