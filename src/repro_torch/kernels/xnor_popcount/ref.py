"""Plain torch versions for the xnor_popcount kernel, and the packing.

``pack_bipolar`` packs as the reference does (bit set <=> ``x > 0``, so
0 and NaN pack as -1). ``xnor_popcount_ref`` repeats the kernel's
arithmetic on packed words; ``xnor_matmul_ref`` is the reference's float
oracle, which differs from the kernel on inputs that are not +-1
(a 0 counts as 0 there and as -1 in the kernel).
"""
from __future__ import annotations

import torch

from ..common import words_to_int32

WORD_BITS = 32
_CHUNK_ELEMS = 1 << 24     # int64 temporaries of the plain popcount


def pack_bipolar(x: torch.Tensor) -> torch.Tensor:
    """(B, n) values -> (B, ceil(n/32)) int32 packed words: feature f in
    bit f % 32 of word f // 32, set where ``x > 0``; pad bits are 0."""
    b, n = x.shape
    n_words = -(-n // WORD_BITS)
    bits = (x > 0).to(torch.int64)
    pad = n_words * WORD_BITS - n
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    lanes = bits.reshape(b, n_words, WORD_BITS)
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=x.device)
    # disjoint bits: an int64 sum is their OR
    return words_to_int32((lanes << shifts).sum(dim=2))


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 values in [0, 2^32)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def xnor_popcount_ref(x_packed: torch.Tensor, w_packed: torch.Tensor,
                      n_features: int) -> torch.Tensor:
    """x_packed (B, W), w_packed (N, W) int32 words -> (B, N) int32
    ``n_features - 2 * sum popcount(x ^ w)``."""
    b, w = x_packed.shape
    n = w_packed.shape[0]
    xu = x_packed.to(torch.int64) & 0xFFFFFFFF
    wu = w_packed.to(torch.int64) & 0xFFFFFFFF
    out = torch.empty((b, n), dtype=torch.int32, device=x_packed.device)
    rows = max(1, _CHUNK_ELEMS // max(1, n * w))
    for i in range(0, b, rows):
        mism = _popcount32(xu[i:i + rows, None, :] ^ wu[None]).sum(dim=2)
        out[i:i + rows] = (n_features - 2 * mism).to(torch.int32)
    return out


def xnor_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Float oracle: bipolar dot products, x (B, n) and w (N, n) of +-1
    values -> (B, N) int32 (exact for n < 2^24)."""
    return (x.to(torch.float32) @ w.to(torch.float32).T).to(torch.int32)
