"""Learning-rate schedules (warmup + cosine decay, constant), as
callables of the step returning a float32 scalar tensor, computed in
the reference's float32 order (``repro/train/schedules.py``)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def sched(step) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return sched


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)
