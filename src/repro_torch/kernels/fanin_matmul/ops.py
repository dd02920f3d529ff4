"""Wrapper of the fanin_matmul kernel (``csrc/fanin_matmul.cu``).

Checks float32 / int32 types, shapes and devices, allocates the output
and launches the kernel on torch's current stream for CUDA tensors, or
runs the plain version (``ref.py``) for CPU tensors; counts its launches
in ``.launches``. Fanin indices must lie in ``[0, n_in)``: the kernel
reads ``x[b, idx[j, k]]`` unchecked. The kernel stages a block's indices
and weights in 48 KB of shared memory, so it takes K <= ``MAX_K``.
"""
from __future__ import annotations

import torch

from .. import build
from ..common import check_float32, check_int32, require_cuda, stream_of
from .ref import fanin_matmul_ref

TILE_B = 64            # batch rows per block (csrc/fanin_matmul.cu)
MAX_GRID_Y = 65_535
MAX_K = 191            # 32 neurons x (K | 1) x 8 bytes staged <= 48 KB


def fanin_matmul(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """FCP-sparse linear: x (B, n_in), idx / w (N, K), bias (N,) ->
    (B, N) float32. ``idx`` is cast to int32."""
    dev = x.device
    idx = idx.to(device=dev, dtype=torch.int32).contiguous()
    check_float32("x", x, dev, 2)
    check_int32("idx", idx, dev, 2)
    check_float32("w", w, dev, 2)
    check_float32("bias", bias, dev, 1)
    b, n_in = x.shape
    n, k = idx.shape
    if w.shape != (n, k) or bias.shape != (n,):
        raise ValueError(f"w {tuple(w.shape)} and bias {tuple(bias.shape)} "
                         f"do not match idx {tuple(idx.shape)}")
    if dev.type == "cpu":
        return fanin_matmul_ref(x, idx, w, bias)
    require_cuda(dev, "fanin_matmul")
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    check_float32("out", out, dev, 2)
    if b == 0 or n == 0:
        return out
    if -(-b // TILE_B) > MAX_GRID_Y:
        raise ValueError(f"batch of {b} rows exceeds the kernel's grid")
    if k > MAX_K:
        raise ValueError(f"fanin K={k} exceeds the kernel's {MAX_K}")
    err = build.library().fanin_matmul_launch(
        x.data_ptr(), idx.data_ptr(), w.data_ptr(), bias.data_ptr(),
        out.data_ptr(), b, n_in, n, k, stream_of(dev))
    build.check(err, "fanin_matmul")
    fanin_matmul.launches += 1
    return out


fanin_matmul.launches = 0
