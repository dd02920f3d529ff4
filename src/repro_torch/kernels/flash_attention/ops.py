"""Wrappers of the flash_attention kernels (``csrc/flash_attention.cu``).

Take the reference wrapper's multi-head layout, q (B, Sq, H, dh) and
k, v (B, Sk, KV, dh) with grouped-query heads (H % KV == 0): the kernels
map each query head to its KV head themselves and mask ragged Sq / Sk
themselves, so nothing is repeated, transposed or padded. Take q, k and
v of one type, float32 or bfloat16, and return that type. Check types,
shapes and devices, allocate the outputs and launch on torch's current
stream for CUDA tensors, or run the plain versions (``ref.py``) for CPU
tensors.

  flash_attention          — the forward; on CUDA tensors that need a
                             gradient (grad mode on), through
                             ``FlashAttention``, a ``torch.autograd``
                             Function whose backward is the backward
                             kernel. Counts forward launches in
                             ``.launches``.
  flash_attention_forward  — the forward returning (out, lse), the
                             per-row log-sum-exp the backward reads.
  flash_attention_backward — dq, dk, dv from q, k, v, out, dout and lse;
                             counts its launches in ``.launches`` and
                             each branch's in ``.branches`` ("wgmma":
                             bf16 at dh 64 or 128 with 16-byte aligned
                             operands; "mma": the rest).

A failed build or launch raises; nothing falls back to a plain version.
"""
from __future__ import annotations

import collections
import ctypes
import math
from typing import Optional, Tuple

import torch

from .. import build
from ..common import check_tensor, require_cuda, stream_of
from .ref import attention_backward_ref, attention_lse_ref, attention_ref

MAX_DH = 128
ROWS_PER_BLOCK = 16          # query rows per thread block of the forward
BWD_ROWS_PER_BLOCK = 64      # keys (dK, dV) or rows (dQ) a backward block
BWD_BRANCHES = ("mma", "wgmma")
MAX_GRID = (1 << 31) - 1
DTYPES = (torch.float32, torch.bfloat16)

Tensor = torch.Tensor


def _check(q: Tensor, k: Tensor, v: Tensor) -> None:
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


def _launch_forward(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                    window: int, with_lse: bool
                    ) -> Tuple[Tensor, Optional[Tensor]]:
    dev = q.device
    require_cuda(dev, "flash_attention")
    b, sq, h, dh = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=dev)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    if -(-sq // ROWS_PER_BLOCK) * b * h > MAX_GRID:
        raise ValueError(f"{b * h} (batch, head) pairs of {sq} rows exceed "
                         "the grid")
    err = build.library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, h, k.shape[2], sq,
        k.shape[1], dh, 1.0 / math.sqrt(dh), int(causal), int(window),
        int(q.dtype == torch.bfloat16), stream_of(dev))
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out, lse


class FlashAttention(torch.autograd.Function):
    """The forward kernel with its log-sum-exp kept, and the backward
    kernel as its gradient (CUDA tensors only)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = _launch_forward(q, k, v, causal, window, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, dout.contiguous(), lse, causal=ctx.causal,
            window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: Tensor, k: Tensor, v: Tensor, causal: bool = True,
                    window: int = 0) -> Tensor:
    """Attention forward: q (B, Sq, H, dh); k, v (B, Sk, KV, dh) ->
    (B, Sq, H, dh) in the operands' type (float32 or bfloat16, one for
    all three), causal and / or within a sliding window of ``window``
    keys (0: no window). Differentiable: on the card through
    ``FlashAttention`` when grad mode is on and an operand requires a
    gradient, on the CPU through the plain version's autograd."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, int(window))
    return _launch_forward(q, k, v, causal, window, with_lse=False)[0]


flash_attention.launches = 0


def flash_attention_forward(q: Tensor, k: Tensor, v: Tensor,
                            causal: bool = True, window: int = 0
                            ) -> Tuple[Tensor, Tensor]:
    """The forward and each row's log-sum-exp of the scaled, masked
    scores, float32 (B, H, Sq); +inf for a row whose every key is
    masked. No autograd."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return (attention_ref(q, k, v, causal=causal, window=window),
                attention_lse_ref(q, k, causal=causal, window=window))
    with torch.no_grad():
        return _launch_forward(q, k, v, causal, window, with_lse=True)


def flash_attention_backward(q: Tensor, k: Tensor, v: Tensor, out: Tensor,
                             dout: Tensor, lse: Tensor, causal: bool = True,
                             window: int = 0
                             ) -> Tuple[Tensor, Tensor, Tensor]:
    """(dq, dk, dv) of ``flash_attention(q, k, v)`` for the output
    gradient ``dout`` (shaped and typed as ``out``), from the forward's
    ``out`` and ``lse`` (``flash_attention_forward``). dk and dv sum
    over each KV head's query heads. On CPU tensors, the plain version's
    autograd (``out`` and ``lse`` unused)."""
    _check(q, k, v)
    b, sq, h, dh = q.shape
    dev = q.device
    check_tensor("out", out, dev, 4, q.dtype)
    check_tensor("dout", dout, dev, 4, q.dtype)
    check_tensor("lse", lse, dev, 3, torch.float32)
    if out.shape != q.shape or dout.shape != q.shape or \
            lse.shape != (b, h, sq):
        raise ValueError(f"out {tuple(out.shape)}, dout {tuple(dout.shape)} "
                         f"and lse {tuple(lse.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if dev.type == "cpu":
        return attention_backward_ref(q, k, v, dout, causal=causal,
                                      window=window)
    require_cuda(dev, "flash_attention_backward")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    sk, kv = k.shape[1], k.shape[2]
    lib = build.library()
    branch = ctypes.c_int(0)
    work_bytes = lib.flash_attention_backward_workspace(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), b, h, kv, sq, sk, dh, int(q.dtype == torch.bfloat16),
        ctypes.byref(branch))
    if work_bytes < 0:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}: no "
                         "backward launch")
    if max(_backward_grid(b, sq, sk, h, kv, dh)) > MAX_GRID:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} exceed "
                         "the grid")
    work = torch.empty(work_bytes, dtype=torch.uint8, device=dev)
    err = lib.flash_attention_backward_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), work.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, h, kv, sq, sk, dh,
        1.0 / math.sqrt(dh), int(causal), int(window),
        int(q.dtype == torch.bfloat16), stream_of(dev))
    build.check(err, "flash_attention_backward")
    flash_attention_backward.launches += 1
    flash_attention_backward.branches[BWD_BRANCHES[branch.value]] += 1
    return dq, dk, dv


def _backward_grid(b: int, sq: int, sk: int, h: int, kv: int, dh: int):
    """Blocks of each backward launch, of both branches: the wgmma
    kernel's (64-key block, b, KV head, head slice) items (at most one
    a query head), its row pass (8 rows a block) and last pass (1,024
    elements a block); the mma.sync kernels' key and row blocks."""
    rows_padded = -(-sq // 64) * 64
    return (-(-sk // 64) * b * h, -(-b * h * rows_padded // 8),
            -(-(b * sq * h + b * sk * kv) * dh // 1024),
            -(-sq // BWD_ROWS_PER_BLOCK) * b * h,
            -(-sk // BWD_ROWS_PER_BLOCK) * b * kv, -(-b * sq * h // 8))


flash_attention_backward.launches = 0
flash_attention_backward.branches = collections.Counter()
