"""Fanin-constrained pruning (FCP) — NullaNet Tiny §FCP, in torch.

Caps the number of distinct inputs feeding each neuron at ``fanin`` so
that truth-table enumeration over (n_levels)^fanin combinations stays
feasible. Masks are row-structured: ``mask[j]`` selects at most
``fanin`` columns of weight row ``j``.

Two schedules, as in the reference (``repro/core/fcp.py``):
  * gradual pruning (Zhu & Gupta 2018): the fanin budget shrinks along
    a cubic schedule; at each update the per-row top-k |w| survive;
  * ADMM: an auxiliary Z projected onto the fanin-K set, a dual U, and
    the penalty rho/2 ||W - Z + U||^2 added to the loss.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

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


def project_fanin(w: torch.Tensor, fanin: int) -> torch.Tensor:
    """Euclidean projection of w onto {matrices with row fanin <= K}."""
    return torch.where(topk_row_mask(w, fanin), w, 0.0)


@dataclasses.dataclass(frozen=True)
class GradualFCP:
    """Cubic fanin schedule: the budget goes in_dim -> target over steps
    [begin, end], updated every ``freq`` steps (by the caller)."""

    target_fanin: int
    begin_step: int = 0
    end_step: int = 1000
    freq: int = 50

    def fanin_at(self, step: int, in_dim: int) -> int:
        """The fanin budget at ``step``. Computed in numpy float32 in the
        reference's order (its ``integer_pow`` is ``f * (f * f)``) and
        rounded half to even, so every step's budget is the
        reference's."""
        f32 = np.float32
        b, e = float(self.begin_step), float(self.end_step)
        frac = np.clip((f32(step) - f32(b)) / f32(max(e - b, 1.0)),
                       f32(0.0), f32(1.0))
        f = f32(1.0) - frac
        excess = f32(in_dim - self.target_fanin) * (f * (f * f))
        return int(np.round(f32(self.target_fanin) + excess))

    def update_mask(self, w: torch.Tensor, step: int) -> torch.Tensor:
        """The top-|w| mask for the current schedule point."""
        return topk_row_mask(w, self.fanin_at(step, w.shape[1]))


@dataclasses.dataclass(frozen=True)
class AdmmFCP:
    """ADMM fanin pruning. State per weight: (Z, U). Every dual step
    Z <- project_fanin(W + U, K); U <- U + W - Z; the loss gains
    rho/2 ||W - Z + U||^2 (``penalty``); ``finalize`` hard-projects W."""

    target_fanin: int
    rho: float = 1e-3
    dual_freq: int = 100

    def init_state(self, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        w = w.detach()
        return project_fanin(w, self.target_fanin), torch.zeros_like(w)

    def dual_update(self, w: torch.Tensor, z: torch.Tensor, u: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        w = w.detach()
        z_new = project_fanin(w + u, self.target_fanin)
        return z_new, u + w - z_new

    def penalty(self, w: torch.Tensor, z: torch.Tensor,
                u: torch.Tensor) -> torch.Tensor:
        d = w - z + u
        return 0.5 * self.rho * torch.sum(d * d)

    def finalize(self, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mask = topk_row_mask(w, self.target_fanin)
        return torch.where(mask, w, 0.0), mask


def row_fanins(mask_or_w) -> torch.Tensor:
    """Number of non-zero inputs per output neuron (int32)."""
    return torch.sum(torch.as_tensor(mask_or_w) != 0, dim=1).to(torch.int32)


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
