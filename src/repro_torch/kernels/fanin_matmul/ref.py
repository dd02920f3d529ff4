"""Plain torch versions for the fanin_matmul kernel."""
from __future__ import annotations

import torch


def fanin_matmul_ref(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """y[b, j] = sum_k x[b, idx[j, k]] * w[j, k] + bias[j] for x
    (B, n_in), idx and w (N, K), bias (N,): the terms are added in the
    kernel's order, k = 0 first and the bias last, each product
    rounded before it is added."""
    cols = idx.long()
    acc = torch.zeros((x.shape[0], idx.shape[0]), dtype=x.dtype,
                      device=x.device)
    for k in range(idx.shape[1]):
        acc = acc + x[:, cols[:, k]] * w[:, k]
    return acc + bias


def dense_equivalent(x: torch.Tensor, w_dense: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """Dense oracle given the masked dense weight (N, n_in)."""
    return x @ w_dense.T + bias[None, :]
