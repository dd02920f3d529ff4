"""Plain torch versions for the flash_attention kernel.

``flash_attention_ref`` is the reference's dense oracle over the
flattened ``(BH, S, dh)`` layout; ``attention_ref`` runs it on the
kernel's ``(B, S, H, dh)`` layout, each query head reading its KV head
``h // (H // KV)``. A row whose every key is masked gets the mean of v
(the softmax of all-equal -1e30 scores).

Both take float32 or bfloat16 operands and round where the reference
kernel rounds: scores in float32 from the operands, the softmax in
float32, P rounded to v's type before P.V, which sums in float32, and
the output returned in q's type.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (BH, Sq, dh); k, v (BH, Sk, dh) -> (BH, Sq, dh) in q's type."""
    sq, sk = q.shape[1], k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    qpos = torch.arange(sq, device=q.device)
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    s = torch.where(mask[None], s, torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Sq, H, dh); k, v (B, Sk, KV, dh) with H % KV == 0 ->
    (B, Sq, H, dh)."""
    b, sq, h, dh = q.shape

    def heads(t):                    # (B, S, n, dh) -> (B*H, S, dh)
        t = t.transpose(1, 2).repeat_interleave(h // t.shape[2], dim=1)
        return t.reshape(b * h, t.shape[2], dh)

    out = flash_attention_ref(heads(q), heads(k), heads(v),
                              causal=causal, window=window)
    return out.reshape(b, h, sq, dh).transpose(1, 2).contiguous()
