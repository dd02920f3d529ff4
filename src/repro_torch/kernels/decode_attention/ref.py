"""Plain torch version of the decode_attention kernel: the twin of the
reference's ``decode_attention`` (``src/repro/models/layers.py``), the
LM decode step's attention over its ring KV cache.

``decode_logits`` gives the masked float32 scores (B, KV, G, 1, W) of the
one query token: q . k in the operands' type (on the CPU a bfloat16
product in float32, rounded once, as XLA's CPU backend computes it),
then in float32 scaled by 1/sqrt(dh), with -1e30 at the slots that are
empty (-1), ahead of the row's position or, with ``window`` > 0, out of
its window. ``decode_attention_ref`` takes ``jax.nn.softmax`` of them
(exp(x - max) / sum, in float32), rounds P to q's type and sums P.V in
it. KV is never repeated (the grouped-GQA form). Given float64 operands
it computes in float64: the exact value rounded versions are held to.
"""
from __future__ import annotations

import math

import torch

from ..common import NEG, einsum, softmax

Tensor = torch.Tensor


def decode_logits(q: Tensor, k_cache: Tensor, cache_positions: Tensor,
                  positions: Tensor, window: int) -> Tensor:
    """Masked float32 scores (B, KV, G, 1, W) of the one query token
    (float64 for float64 operands)."""
    b, _, h, dh = q.shape
    kvh = k_cache.shape[2]
    q5 = q.reshape(b, 1, kvh, h // kvh, dh)
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    scale = torch.full((), 1.0 / math.sqrt(dh), dtype=acc, device=q.device)
    logits = einsum("bqkgd,bwkd->bkgqw", q5, k_cache).to(acc) * scale
    valid = (cache_positions >= 0) & \
        (cache_positions <= positions[:, None])              # (B, W)
    if window > 0:
        valid &= cache_positions > (positions[:, None] - window)
    return logits.masked_fill(~valid[:, None, None, None, :], NEG)


def decode_attention_ref(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                         cache_positions: Tensor, positions: Tensor,
                         window: int = 0) -> Tensor:
    """q (B, 1, H, dh); caches (B, W, KV, dh); cache_positions (B, W);
    positions (B,) -> (B, 1, H, dh) in q's type."""
    b, _, h, dh = q.shape
    logits = decode_logits(q, k_cache, cache_positions, positions, window)
    probs = softmax(logits).to(q.dtype)
    out = einsum("bkgqw,bwkd->bqkgd", probs, v_cache)
    return out.reshape(b, 1, h, dh)
