"""AdamW and SGD with momentum, written out as the reference's
(``repro/train/optim.py``) rather than wrapped from ``torch.optim``.

The rule differs from ``torch.optim.AdamW``: the gradients are first
scaled by their global norm (``grad_clip``, with ``+1e-9``), the decay
is added to the update and only for parameters with ``ndim >= 2``, and
eps is added after the bias corrections:

    p <- p - lr * (mhat / (sqrt(vhat) + eps) + wd * p)

``update`` changes the parameters and the moments in place, leaf by
leaf (one leaf's temporaries at a time; on placed leaves, shard by
shard, with the clip's norm the unsharded one), and returns the new state,
which holds the step count and the moments, in the parameters' order.
With ``mixed_precision`` the state also holds a float32 ``master`` copy
that the rule steps, and the live parameters become its bf16 cast
(``cast_params``), as the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.dist.shardings import is_placed

Tensor = torch.Tensor
LR = Union[float, Callable[[int], object]]


def global_norm(tensors: Sequence[Tensor]) -> Tensor:
    """sqrt of the sum of squares of every element, summed tensor by
    tensor in the given order (float32). A placed (DTensor) tensor's sum
    is over all its shards, so the norm is the unsharded one on every
    rank."""
    acc = torch.zeros((), dtype=torch.float32, device=tensors[0].device)
    for t in tensors:
        sq = torch.sum(torch.square(t.float()))
        acc = acc + (sq.full_tensor() if is_placed(sq) else sq)
    return torch.sqrt(acc)


def _clip_scale(grads: Sequence[Tensor], grad_clip: float) -> Tensor:
    """min(1, grad_clip / (global norm + 1e-9)), float32."""
    gnorm = global_norm(grads)
    # divide tensor by tensor: ``scalar / tensor`` rounds differently
    return torch.clamp(torch.full_like(gnorm, grad_clip) / (gnorm + 1e-9),
                       max=1.0)


def _lr(lr: LR, step: int):
    return lr(step) if callable(lr) else lr


class AdamWState(NamedTuple):
    step: int
    mu: List[Tensor]
    nu: List[Tensor]
    master: Optional[List[Tensor]] = None   # float32 copy (mixed precision)


def _set_bf16(p: Tensor, value: Tensor) -> None:
    """p <- value rounded to bf16, in place (p becomes bf16 if it was
    not; a placed p by ``swap_tensors``, since ``.data =`` would leave
    its local shard in the old type)."""
    if p.dtype == torch.bfloat16:
        p.copy_(value)
    elif is_placed(p):
        new = value.detach().to(torch.bfloat16)
        if isinstance(p, torch.nn.Parameter):
            new = torch.nn.Parameter(new, requires_grad=p.requires_grad)
        torch.utils.swap_tensors(p, new)
    else:
        p.data = value.to(torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class AdamW:
    """AdamW; with ``mixed_precision`` the live parameters are bf16 and
    the float32 master copy lives in the optimizer state."""

    lr: LR = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    mixed_precision: bool = False

    def init(self, params: Sequence[Tensor]) -> AdamWState:
        def z(p):   # placed like p
            return torch.zeros_like(p, dtype=torch.float32)
        master = ([p.detach().float().clone() for p in params]
                  if self.mixed_precision else None)
        return AdamWState(0, [z(p) for p in params], [z(p) for p in params],
                          master)

    @torch.no_grad()
    def cast_params(self, params: Sequence[Tensor]) -> Sequence[Tensor]:
        """The live parameters cast to bf16 in place under
        ``mixed_precision``; unchanged otherwise."""
        if self.mixed_precision:
            for p in params:
                _set_bf16(p, p.detach())
        return params

    def _lr(self, step: int):
        return _lr(self.lr, step)

    @torch.no_grad()
    def update(self, grads: Sequence[Tensor], state: AdamWState,
               params: Sequence[Tensor],
               ndims: Optional[Sequence[int]] = None) -> AdamWState:
        """One step in place. ``ndims``: each leaf's dimensions as the
        decay rule counts them (default ``p.ndim``; the LM's per-layer
        leaves count the reference's stacked layer axis, see
        ``models.lm.reference_ndims``)."""
        step = state.step + 1
        if ndims is None:
            ndims = [p.ndim for p in params]
        scale = (_clip_scale(grads, self.grad_clip) if self.grad_clip > 0
                 else None)
        b1, b2 = self.b1, self.b2
        # the bias corrections in float32, as the reference's b ** t
        t = np.float32(step)
        bc1 = float(np.float32(1) - np.float32(b1) ** t)
        bc2 = float(np.float32(1) - np.float32(b2) ** t)
        lr = self._lr(step)
        src = state.master if state.master is not None else params
        for p, m, v, g, nd in zip(src, state.mu, state.nu, grads, ndims):
            g = g.float()
            if scale is not None:
                g = g * scale
            m.mul_(b1).add_(g * (1 - b1))            # b1 m + (1 - b1) g
            v.mul_(b2).add_((g * g) * (1 - b2))      # b2 v + (1 - b2) g^2
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.weight_decay > 0 and nd >= 2:
                u = u + self.weight_decay * p
            p.sub_(lr * u)
        if state.master is not None:
            for p, w in zip(params, state.master):
                _set_bf16(p, w)
        return AdamWState(step, state.mu, state.nu, state.master)


class SGDState(NamedTuple):
    step: int
    momentum: List[Tensor]


@dataclasses.dataclass(frozen=True)
class SGD:
    lr: LR = 1e-2
    momentum: float = 0.9
    grad_clip: float = 0.0

    def init(self, params: Sequence[Tensor]) -> SGDState:
        return SGDState(0, [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(self, grads: Sequence[Tensor], state: SGDState,
               params: Sequence[Tensor]) -> SGDState:
        step = state.step + 1
        grads = list(grads)
        if self.grad_clip > 0:
            scale = _clip_scale(grads, self.grad_clip)
            grads = [g * scale for g in grads]
        mom = [self.momentum * m + g for m, g in zip(state.momentum, grads)]
        lr = _lr(self.lr, step)
        for p, m in zip(params, mom):
            p.sub_(lr * m)
        return SGDState(step, mom)
