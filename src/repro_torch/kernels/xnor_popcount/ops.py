"""Wrappers of the xnor_popcount kernel (``csrc/xnor_popcount.cu``).

``xnor_matmul_packed`` takes packed int32 words, checks them, allocates
the output and launches the kernel on torch's current stream for CUDA
tensors, or runs the plain version (``ref.py``) for CPU tensors; it
counts its launches in ``.launches``. ``xnor_matmul`` is the reference's
public entry: it packs +-1 operands with ``pack_bipolar`` first.

The kernel runs the products on the binary tensor cores in 32 x 16
output tiles, one block each over a one-dimensional grid, so B and N
have no limit beyond int32 indexing.
"""
from __future__ import annotations

import torch

from .. import build
from ..common import check_int32, require_cuda, stream_of
from .ref import WORD_BITS, pack_bipolar, xnor_popcount_ref


def loads_vectorized(x_packed: torch.Tensor, w_packed: torch.Tensor) -> bool:
    """Whether the kernel loads the operands as 16-byte vectors (rows of
    a multiple of 4 words at 16-byte aligned addresses) or word by
    word."""
    return (x_packed.shape[1] % 4 == 0 and x_packed.data_ptr() % 16 == 0
            and w_packed.data_ptr() % 16 == 0)


def xnor_matmul_packed(x_packed: torch.Tensor, w_packed: torch.Tensor,
                       n_features: int) -> torch.Tensor:
    """x_packed (B, W), w_packed (N, W) int32 words of ``n_features``
    bipolar entries (pad bits 0 in both) -> (B, N) int32 dot products."""
    dev = x_packed.device
    check_int32("x_packed", x_packed, dev, 2)
    check_int32("w_packed", w_packed, dev, 2)
    b, w = x_packed.shape
    n = w_packed.shape[0]
    if w_packed.shape[1] != w:
        raise ValueError(f"x_packed has {w} words per row, w_packed "
                         f"{w_packed.shape[1]}")
    if not 0 <= n_features <= WORD_BITS * w:
        raise ValueError(f"{n_features} features do not fit {w} words")
    if dev.type == "cpu":
        return xnor_popcount_ref(x_packed, w_packed, n_features)
    require_cuda(dev, "xnor_popcount")
    out = torch.empty((b, n), dtype=torch.int32, device=dev)
    check_int32("out", out, dev, 2)
    if b == 0 or n == 0:
        return out
    build.launch("xnor_popcount",
        x_packed.data_ptr(), w_packed.data_ptr(), out.data_ptr(), b, n, w,
        n_features, stream_of(dev))
    xnor_matmul_packed.launches += 1
    return out


xnor_matmul_packed.launches = 0


def xnor_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Bipolar matmul: x (B, n) @ w (N, n)^T -> (B, N) int32, through
    the packed kernel (entries > 0 count as +1, all others as -1)."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} are "
                         "not (B, n) and (N, n)")
    if w.device != x.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    return xnor_matmul_packed(pack_bipolar(x), pack_bipolar(w), x.shape[1])
