"""AdamW and SGD with momentum, written out as the reference's
(``repro/train/optim.py``) rather than wrapped from ``torch.optim``.

The rule differs from ``torch.optim.AdamW``: the gradients are first
scaled by their global norm (``grad_clip``, with ``+1e-9``), the decay
is added to the update and only for parameters with ``ndim >= 2``, and
eps is added after the bias corrections:

    p <- p - lr * (mhat / (sqrt(vhat) + eps) + wd * p)

``update`` changes the parameters in place and returns the new state,
which holds the step count and the moments, in the parameters' order.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Sequence, Union

import numpy as np
import torch

Tensor = torch.Tensor
LR = Union[float, Callable[[int], object]]


def global_norm(tensors: Sequence[Tensor]) -> Tensor:
    """sqrt of the sum of squares of every element, summed tensor by
    tensor in the given order (float32)."""
    acc = torch.zeros((), dtype=torch.float32, device=tensors[0].device)
    for t in tensors:
        acc = acc + torch.sum(torch.square(t.float()))
    return torch.sqrt(acc)


def _clip(grads: List[Tensor], grad_clip: float) -> List[Tensor]:
    gnorm = global_norm(grads)
    # divide tensor by tensor: ``scalar / tensor`` rounds differently
    scale = torch.clamp(torch.full_like(gnorm, grad_clip) / (gnorm + 1e-9),
                        max=1.0)
    return [g * scale for g in grads]


def _lr(lr: LR, step: int):
    return lr(step) if callable(lr) else lr


class AdamWState(NamedTuple):
    step: int
    mu: List[Tensor]
    nu: List[Tensor]


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: LR = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0

    def init(self, params: Sequence[Tensor]) -> AdamWState:
        return AdamWState(0,
                          [torch.zeros_like(p, dtype=torch.float32)
                           for p in params],
                          [torch.zeros_like(p, dtype=torch.float32)
                           for p in params])

    @torch.no_grad()
    def update(self, grads: Sequence[Tensor], state: AdamWState,
               params: Sequence[Tensor]) -> AdamWState:
        step = state.step + 1
        grads = [g.float() for g in grads]
        if self.grad_clip > 0:
            grads = _clip(grads, self.grad_clip)
        b1, b2 = self.b1, self.b2
        mu = [b1 * m + (1 - b1) * g for m, g in zip(state.mu, grads)]
        nu = [b2 * v + (1 - b2) * (g * g) for v, g in zip(state.nu, grads)]
        # the bias corrections in float32, as the reference's b ** t
        t = np.float32(step)
        bc1 = float(np.float32(1) - np.float32(b1) ** t)
        bc2 = float(np.float32(1) - np.float32(b2) ** t)
        lr = _lr(self.lr, step)
        for p, m, v in zip(params, mu, nu):
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.weight_decay > 0 and p.ndim >= 2:
                u = u + self.weight_decay * p
            p.sub_(lr * u)
        return AdamWState(step, mu, nu)


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
            grads = _clip(grads, self.grad_clip)
        mom = [self.momentum * m + g for m, g in zip(state.momentum, grads)]
        lr = _lr(self.lr, step)
        for p, m in zip(params, mom):
            p.sub_(lr * m)
        return SGDState(step, mom)
