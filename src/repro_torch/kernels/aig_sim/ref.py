"""Plain torch version of the aig_sim walk: the same linear node walk
as the kernel and the reference's ``lax.scan`` oracle, one row store per
AND node."""
from __future__ import annotations

import torch


def aig_sim_ref(pi_words: torch.Tensor, f0: torch.Tensor, f1: torch.Tensor,
                n_pis: int) -> torch.Tensor:
    """pi_words (n_pis, W) int32; f0 / f1 (n_ands,) int32 literals.
    Returns the (1 + n_pis + n_ands, W) int32 value plane."""
    n_ands = f0.shape[0]
    vals = torch.zeros((1 + n_pis + n_ands, pi_words.shape[1]),
                       dtype=torch.int32, device=pi_words.device)
    vals[1: n_pis + 1] = pi_words
    for i, (l0, l1) in enumerate(zip(f0.tolist(), f1.tolist())):
        v0 = vals[l0 >> 1] ^ -(l0 & 1)
        v1 = vals[l1 >> 1] ^ -(l1 & 1)
        vals[1 + n_pis + i] = v0 & v1
    return vals
