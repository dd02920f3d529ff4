"""Wrapper of the flash_attention kernel (``csrc/flash_attention.cu``).

Takes the reference wrapper's multi-head layout, q (B, Sq, H, dh) and
k, v (B, Sk, KV, dh) with grouped-query heads (H % KV == 0): the kernel
maps each query head to its KV head itself and masks ragged Sq / Sk
itself, so nothing is repeated, transposed or padded. Takes q, k and v
of one type, float32 or bfloat16, and returns that type. Checks types,
shapes and devices, allocates the output and launches on torch's
current stream for CUDA tensors, or runs the plain version
(``ref.attention_ref``) for CPU tensors; counts its launches in
``.launches``.
"""
from __future__ import annotations

import math

import torch

from .. import build
from ..common import check_tensor, require_cuda, stream_of
from .ref import attention_ref

MAX_DH = 128
ROWS_PER_BLOCK = 16          # query rows per thread block of the kernel
MAX_GRID = (1 << 31) - 1
DTYPES = (torch.float32, torch.bfloat16)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Attention forward: q (B, Sq, H, dh); k, v (B, Sk, KV, dh) ->
    (B, Sq, H, dh) in the operands' type (float32 or bfloat16, one for
    all three), causal and / or within a sliding window of ``window``
    keys (0: no window)."""
    dev = q.device
    if q.dtype not in DTYPES:
        raise ValueError(f"q: expected one of {DTYPES}, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_tensor(name, t, dev, 4, q.dtype)
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if (k.shape[0] != b or k.shape[3] != dh or v.shape != k.shape
            or kv == 0 or h % kv):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} are not (B, Sq, H, dh) and "
                         "(B, Sk, KV, dh) with H % KV == 0")
    if sk == 0:
        raise ValueError("attention over zero keys")
    if not 1 <= dh <= MAX_DH:
        raise ValueError(f"the kernel takes 1 <= dh <= {MAX_DH}, got {dh}")
    if dev.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    require_cuda(dev, "flash_attention")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if -(-sq // ROWS_PER_BLOCK) * b * h > MAX_GRID:
        raise ValueError(f"{b * h} (batch, head) pairs of {sq} rows exceed "
                         "the grid")
    err = build.library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, kv,
        sq, sk, dh, 1.0 / math.sqrt(dh), int(causal), int(window),
        int(q.dtype == torch.bfloat16), stream_of(dev))
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
