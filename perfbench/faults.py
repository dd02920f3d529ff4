"""Faults planted under the timed path, for the tests and the
calibration that show ``correct`` comes out false: each patches a
module attribute of the port that the timed path looks up at call time,
and restores it on exit. The benchmark's own runs never plant one."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def state_unchanged():
    """A training step that returns its state unchanged: AdamW's update
    moves no parameter and no moment."""
    from repro_torch.train import optim
    orig = optim.AdamW.update
    optim.AdamW.update = lambda self, grads, state, params, ndims=None: state
    try:
        yield
    finally:
        optim.AdamW.update = orig


@contextlib.contextmanager
def half_batch():
    """A training step over the first half of the batch's rows only, its
    loss and gradients the mean over them."""
    from repro_torch.train import loop
    orig = loop.loss_and_grads

    def half(cfg, params, batch, grad_accum=1):
        rows = next(iter(batch.values())).shape[0] // 2
        return orig(cfg, params, {k: v[:rows] for k, v in batch.items()},
                    grad_accum)
    loop.loss_and_grads = half
    try:
        yield
    finally:
        loop.loss_and_grads = orig


@contextlib.contextmanager
def token_altered(every: int = 7):
    """Every ``every``-th decode step serves, in slot 0, the token after
    the one the logits put first."""
    from repro_torch.models import lm
    orig = lm.decode_step
    calls = [0]

    def decode_step(cfg, params, cache, tokens, positions):
        logits, cache = orig(cfg, params, cache, tokens, positions)
        calls[0] += 1
        if calls[0] % every == 0:
            top = int(torch.argmax(logits[0]))
            logits = logits.clone()
            logits[0, (top + 1) % logits.shape[-1]] = logits[0, top] + 1
        return logits, cache
    lm.decode_step = decode_step
    try:
        yield
    finally:
        lm.decode_step = orig
