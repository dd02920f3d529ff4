"""Error-feedback gradient compression, as the reference's
``repro/dist/compress.py``.

Both schemes keep the EF identity  compressed + residual == grad +
residual_prev  exactly (float tolerance), which is what makes biased
compressors converge (Karimireddy et al., "Error Feedback Fixes
SignSGD"):

  topk_compress — keep only the largest ``frac`` of entries per leaf;
      the rest accumulates in the residual until it matters.
  sign_compress — 1-bit sign with a per-leaf mean-|.| scale (signSGD
      with majority-vote-compatible magnitudes).

Gradients, residuals and results are lists of tensors in the order of
the parameters (``models.lm.leaves``); the state is a NamedTuple of
such a list, so it rides inside ``TrainState`` and its checkpoints.
Nothing is changed in place. On placed (DTensor) gradients both keep
what they keep on the unsharded ones: top-k's cut is taken over the
whole leaf, sign's scale is the whole leaf's mean.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch

from repro_torch.dist.shardings import full

Tensor = torch.Tensor


class EFState(NamedTuple):
    residual: List[Tensor]


def init_ef(params: Sequence[Tensor]) -> EFState:
    """Zero residuals shaped (and placed) like the grads (float32
    accumulation)."""
    return EFState([torch.zeros_like(p, dtype=torch.float32)
                    for p in params])


def _accumulate(grads: Sequence[Tensor], ef: EFState) -> List[Tensor]:
    return [g.float() + r for g, r in zip(grads, ef.residual)]


def topk_compress(grads: Sequence[Tensor], ef: EFState, frac: float
                  ) -> Tuple[List[Tensor], EFState]:
    """Keep the top ``frac`` entries (by magnitude) of grad+residual per
    leaf, ties at the cut included; everything below the cut accumulates
    in the new residual."""
    acc = _accumulate(grads, ef)
    sparse = []
    for a in acc:
        mag = a.abs()
        k = max(1, int(frac * mag.numel()))
        # a placed leaf's cut is the whole leaf's (every rank gathers
        # it), so each shard keeps what the unsharded top-k keeps
        thresh = torch.topk(full(mag).reshape(-1), k).values[-1]
        sparse.append(torch.where(mag >= thresh, a, torch.zeros_like(a)))
    return sparse, EFState([a - s for a, s in zip(acc, sparse)])


def sign_compress(grads: Sequence[Tensor], ef: EFState
                  ) -> Tuple[List[Tensor], EFState]:
    """1-bit-per-entry quantization: sign(acc) * mean(|acc|) per leaf."""
    acc = _accumulate(grads, ef)
    q = [torch.sign(a) * torch.mean(torch.abs(a)) for a in acc]
    return q, EFState([a - s for a, s in zip(acc, q)])
