"""Wrapper of the flash_attention kernel (``csrc/flash_attention.cu``).

Takes the reference wrapper's multi-head layout, q (B, Sq, H, dh) and
k, v (B, Sk, KV, dh) with grouped-query heads (H % KV == 0): the kernel
maps each query head to its KV head itself and masks ragged Sq / Sk
itself, so nothing is repeated, transposed or padded. Checks float32
types, shapes and devices, allocates the output and launches on torch's
current stream for CUDA tensors, or runs the plain version
(``ref.attention_ref``) for CPU tensors; counts its launches in
``.launches``.
"""
from __future__ import annotations

import math

import torch

from .. import build
from ..common import check_float32, require_cuda, stream_of
from .ref import attention_ref

MAX_DH = 128
MAX_GRID_Y = 65_535


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Attention forward: q (B, Sq, H, dh); k, v (B, Sk, KV, dh) ->
    (B, Sq, H, dh) float32, causal and / or within a sliding window of
    ``window`` keys (0: no window)."""
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_float32(name, t, dev, 4)
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
    if b * h > MAX_GRID_Y:
        raise ValueError(f"{b * h} (batch, head) pairs exceed the grid")
    err = build.library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, kv,
        sq, sk, dh, 1.0 / math.sqrt(dh), int(causal), int(window),
        stream_of(dev))
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
