"""Fanin-constrained pruning (FCP) — the parts the compile path needs.

Caps the number of distinct inputs feeding each neuron at ``fanin`` so
that truth-table enumeration over (n_levels)^fanin combinations stays
feasible. Masks are row-structured: ``mask[j]`` selects at most
``fanin`` columns of weight row ``j``. The pruning schedules (gradual,
ADMM) come with training.
"""
from __future__ import annotations

import numpy as np
import torch


def topk_row_mask(w: torch.Tensor, fanin: int) -> torch.Tensor:
    """Boolean mask keeping the ``fanin`` largest-|w| entries of each row.

    w: (out, in). Ties break towards the lower column index through the
    reference's index epsilon (``repro/core/fcp.py``), computed in the
    same float32 order.
    """
    _, in_dim = w.shape
    k = min(fanin, in_dim)
    mag = torch.abs(w)
    tie = (torch.arange(in_dim, dtype=w.dtype, device=w.device)
           * torch.tensor(1e-12, dtype=w.dtype, device=w.device))
    score = mag - tie
    thresh = torch.topk(score, k, dim=1).values[:, -1:]
    return score >= thresh


def fanin_indices(mask, fanin: int):
    """Dense (out, fanin) column-index matrix from a row mask.

    Rows with fewer than ``fanin`` survivors are padded by repeating the
    first surviving index (weight 0 there keeps semantics exact).
    Returns numpy ``(idx int32, valid bool)``.
    """
    m = np.asarray(mask)
    out_dim = m.shape[0]
    idx = np.zeros((out_dim, fanin), dtype=np.int32)
    valid = np.zeros((out_dim, fanin), dtype=bool)
    for j in range(out_dim):
        cols = np.nonzero(m[j])[0]
        if len(cols) == 0:
            cols = np.array([0])
        take = cols[:fanin]
        idx[j, : len(take)] = take
        valid[j, : len(take)] = True
        if len(take) < fanin:
            idx[j, len(take):] = take[0] if len(take) else 0
    return idx, valid
