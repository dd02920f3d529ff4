"""Plain torch version of the lut_layer kernel (runs on any device)."""
from __future__ import annotations

import torch


def lut_layer_ref(codes: torch.Tensor, idx: torch.Tensor,
                  tables: torch.Tensor, n_levels: int) -> torch.Tensor:
    """codes (B, N_in); idx (N, K); tables (N, R) -> (B, N) int32 with
    out[b, j] = tables[j, sum_k codes[b, idx[j, k]] * n_levels^k]."""
    codes = codes.to(torch.int32)
    tables = tables.to(torch.int32)
    k = idx.shape[1]
    gathered = codes[:, idx.long()]                           # (B, N, K)
    weights = torch.tensor([n_levels ** i for i in range(k)],
                           dtype=torch.int32, device=codes.device)
    rows = (gathered * weights).sum(dim=-1, dtype=torch.int32)  # (B, N)
    return torch.gather(tables, 1, rows.T.long()).T.contiguous()
