"""Plain torch versions for the fanin_matmul kernel."""
from __future__ import annotations

import torch


def fanin_matmul_ref(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """y[b, j] = sum_k x[b, idx[j, k]] * w[j, k] + bias[j] for x
    (B, n_in), idx and w (N, K), bias (N,), in the rounding of the
    reference kernel: each product in the promoted type of x and w
    (``torch.promote_types``, which agrees with JAX's for float32,
    bfloat16 and float16), the sum in float32 from k = 0 up, then the
    bias in float32, then a cast to x's type.

    Indices follow the reference kernel's gather: one in ``[-n_in, 0)``
    reads column ``idx + n_in``; any other outside ``[0, n_in)`` gathers
    a NaN, so its output is NaN whatever its weight."""
    n_in = x.shape[1]
    cols = idx.long()
    cols = torch.where(cols < 0, cols + n_in, cols)
    cols = torch.where((cols >= 0) & (cols < n_in), cols, n_in)
    # the NaN column that every out-of-range index reads
    xp = torch.cat([x, x.new_full((x.shape[0], 1), float("nan"))], dim=1)
    acc = torch.zeros((x.shape[0], idx.shape[0]), dtype=torch.float32,
                      device=x.device)
    for k in range(idx.shape[1]):
        acc = acc + (xp[:, cols[:, k]] * w[:, k]).float()
    return (acc + bias.float()).to(x.dtype)


def dense_equivalent(x: torch.Tensor, w_dense: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """Dense oracle given the masked dense weight (N, n_in)."""
    return x @ w_dense.T + bias[None, :]
