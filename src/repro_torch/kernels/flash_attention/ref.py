"""Plain torch versions for the flash_attention kernels.

``flash_attention_ref`` is the reference's dense oracle over the
flattened ``(BH, S, dh)`` layout; ``attention_ref`` runs it on the
kernel's ``(B, S, H, dh)`` layout, each query head reading its KV head
``h // (H // KV)``. A row whose every key is masked gets the mean of v
(the softmax of all-equal -1e30 scores). ``attention_lse_ref`` is the
forward's per-row log-sum-exp and ``attention_backward_ref`` the
backward: autograd through ``attention_ref``.

Both take float32 or bfloat16 operands and round where the reference
kernel rounds: scores in float32 from the operands, the softmax in
float32, P rounded to v's type before P.V, which sums in float32, and
the output returned in q's type. Given float64 operands they compute
in float64 throughout: the exact value that rounded versions are held
to.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _mask(sq: int, sk: int, causal: bool, window: int, device
          ) -> torch.Tensor:
    qpos = torch.arange(sq, device=device)
    kpos = torch.arange(sk, device=device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (BH, Sq, dh); k, v (BH, Sk, dh) -> (BH, Sq, dh) in q's type."""
    sq, sk = q.shape[1], k.shape[1]
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqd,bkd->bqk", q.to(acc), k.to(acc)) * scale
    mask = _mask(sq, sk, causal, window, q.device)
    s = torch.where(mask[None], s, torch.tensor(NEG_INF, device=q.device,
                                                dtype=acc))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).to(acc), v.to(acc))
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


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, causal: bool = True,
                      window: int = 0) -> torch.Tensor:
    """Each row's log-sum-exp of the scaled scores over its unmasked
    keys, float32 (B, H, Sq); +inf for a row whose every key is
    masked."""
    b, sq, h, dh = q.shape
    kh = k.transpose(1, 2).repeat_interleave(h // k.shape[2], dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.transpose(1, 2).float(),
                     kh.float()) / math.sqrt(dh)
    mask = _mask(sq, k.shape[1], causal, window, q.device)
    lse = torch.logsumexp(s.masked_fill(~mask, -math.inf), dim=-1)
    return torch.where(mask.any(-1), lse, math.inf)


def attention_backward_ref(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, dout: torch.Tensor,
                           causal: bool = True, window: int = 0):
    """(dq, dk, dv) of ``attention_ref(q, k, v)`` for the output gradient
    ``dout``, by autograd."""
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = attention_ref(qq, kk, vv, causal=causal, window=window)
        return torch.autograd.grad(out, (qq, kk, vv), dout)
