"""LM training: the train step factory and the fault-tolerant Trainer,
as the reference's ``repro/train/loop.py`` on one device.

``make_train_step(cfg, optimizer, ...)`` returns ``train_step(state,
batch) -> (state, metrics)``: the loss and every leaf's gradient by
autograd (``loss_and_grads``), optional error-feedback compression, and
the optimizer's update. The reference's step is functional; the port's
updates the parameters and moments in place, but only after the loss
and every gradient are computed, so a step that fails in its forward or
backward leaves the state as it was and ``retry_step`` may run it
again. Leaves are ``models.lm.leaves(params)``: the reference's order,
FCP masks included (the reference differentiates and steps them too).

The ``Trainer`` resumes from the latest committed checkpoint, saves
asynchronously every ``ckpt_every`` steps, saves synchronously on any
exception before re-raising, and flags stragglers with
``StepWatchdog``. On the card the step time ends in a synchronize (the
reference blocks on the loss).

The program tracer (``obs.trace.program_tracer()``) gets, per
microbatch, ``train.forward`` around the loss and ``train.backward``
around the gradients, then ``train.optimizer`` around the global norm
and the optimizer's update, each with a device interval.

Placed (DTensor) parameters train the same way under
``dist.shardings.use_mesh``: each leaf's gradient comes back with its
parameter's placements, the optimizer steps each shard in place, and
the metrics are whole (replicated) values.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import compress as C
from repro_torch.dist.fault import StepWatchdog, retry_step
from repro_torch.dist.shardings import full, is_placed
from repro_torch.models import lm
from repro_torch.obs.trace import program_tracer
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optim import AdamW, AdamWState, global_norm

Tensor = torch.Tensor


class TrainState(NamedTuple):
    params: lm.Params
    opt: AdamWState
    ef: Optional[C.EFState]  # gradient-compression error feedback


def _loss(cfg: ArchConfig, params: lm.Params, batch: Dict[str, Tensor]
          ) -> Tensor:
    kw = {}
    if "enc_embeds" in batch:
        kw["enc_embeds"] = batch["enc_embeds"]
    if "frames" in batch:
        hidden, _, _ = lm.forward(cfg, params, frames=batch["frames"], **kw)
    else:
        hidden, _, _ = lm.forward(cfg, params, tokens=batch["tokens"], **kw)
    return lm.lm_loss(cfg, params, hidden, batch["labels"])


def _grads(loss: Tensor, leaves: List[Tensor]) -> List[Tensor]:
    """d loss / d leaf for every leaf (zeros for a leaf it does not
    read); a placed leaf's gradient redistributed to its placements."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else
            g.redistribute(p.device_mesh, p.placements) if is_placed(g)
            else g for p, g in zip(leaves, grads)]


def loss_and_grads(cfg: ArchConfig, params: lm.Params,
                   batch: Dict[str, Tensor], grad_accum: int = 1
                   ) -> Tuple[Tensor, List[Tensor]]:
    """The batch's loss and the gradient of every leaf of ``params``
    (``lm.leaves`` order). ``grad_accum`` > 1 splits the batch's leading
    axis into that many microbatches run one after another; their losses
    and float32 gradients are summed, then scaled by 1/N, as the
    reference's ``lax.scan`` does."""
    lm.require_trainable(params)
    leaves = lm.leaves(params)
    dev = leaves[0].device
    tr = program_tracer()
    with torch.enable_grad():
        for t in leaves:
            t.requires_grad_(True)
        if grad_accum <= 1:
            with tr.span("train.forward", device=dev):
                loss = _loss(cfg, params, batch)
            with tr.span("train.backward", device=dev):
                grads = _grads(loss, leaves)
            return loss.detach(), grads
        n = grad_accum
        micro = {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        g_sum = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        for i in range(n):
            with tr.span("train.forward", device=dev):
                loss = _loss(cfg, params, {k: v[i] for k, v in micro.items()})
            with tr.span("train.backward", device=dev):
                grads = _grads(loss, leaves)
            for acc, g in zip(g_sum, grads):
                acc.add_(g)
            loss_sum = loss_sum + loss.detach()
        inv = torch.full((), 1.0 / n, dtype=torch.float32, device=dev)
        return loss_sum * inv, [g * inv for g in g_sum]


def make_train_step(cfg: ArchConfig, optimizer: AdamW,
                    compress: str = "none", compress_frac: float = 0.01,
                    grad_accum: int = 1):
    """Returns train_step(state, batch) -> (state, metrics): metrics
    ``loss``, ``grad_norm`` (of the gradients the optimizer is given,
    after compression; float32 tensors) and ``step``."""
    if compress not in ("none", "topk", "sign"):
        raise ValueError(f"compress: none, topk or sign, got {compress!r}")

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        loss, grads = loss_and_grads(cfg, state.params, batch, grad_accum)
        ef = state.ef
        if compress == "topk":
            grads, ef = C.topk_compress(grads, ef, compress_frac)
        elif compress == "sign":
            grads, ef = C.sign_compress(grads, ef)
        leaves = lm.leaves(state.params)
        with program_tracer().span("train.optimizer",
                                   device=leaves[0].device):
            gnorm = global_norm(grads)
            opt = optimizer.update(grads, state.opt, leaves,
                                   lm.reference_ndims(state.params))
        metrics = {"loss": full(loss), "grad_norm": full(gnorm),
                   "step": opt.step}
        return TrainState(state.params, opt, ef), metrics

    return train_step


def init_state(cfg: ArchConfig, optimizer: AdamW,
               generator: Optional[torch.Generator] = None,
               compress: str = "none",
               params: Optional[lm.Params] = None) -> TrainState:
    """Seeded float32 parameters (``lm.init_params`` on the generator's
    device), or the given ``params``, with a fresh optimizer state and,
    when compressing, zero residuals."""
    if params is None:
        if generator is None:
            raise ValueError("init_state needs a generator or params")
        params = lm.init_params(cfg, generator)
    lm.require_trainable(params)
    leaves = lm.leaves(params)
    ef = C.init_ef(leaves) if compress != "none" else None
    return TrainState(params, optimizer.init(leaves), ef)


def _wait(t: Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


@dataclasses.dataclass
class Trainer:
    """Fault-tolerant orchestration around a train step.

    * resumes from the latest committed checkpoint on construction,
      copied into ``state``'s tensors;
    * async-checkpoints every ``ckpt_every`` steps;
    * emergency (synchronous) checkpoint on any exception escape;
    * StepWatchdog flags stragglers; flagged steps past
      ``max_straggler_events`` trigger a checkpoint so a scheduler could
      migrate the job;
    * each step is retried twice on an exception (``retry_step``).
    """

    train_step: Any
    state: TrainState
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    keep: int = 3
    max_straggler_events: int = 10

    def __post_init__(self):
        self.watchdog = StepWatchdog()
        self.step = 0
        self._ckpt = (ckpt.AsyncCheckpointer(self.ckpt_dir, self.keep)
                      if self.ckpt_dir else None)
        if self.ckpt_dir:
            restored = ckpt.restore_latest(self.ckpt_dir, self.state)
            if restored is not None:
                self.state = ckpt.load_into(self.state, restored)
                self.step = int(self.state.opt.step)

    def run(self, batch_iter, n_steps: int, log_every: int = 10,
            log_fn=print) -> Dict[str, float]:
        last = {}
        safe_step = retry_step(self.train_step, max_retries=2)
        try:
            for _ in range(n_steps):
                batch = next(batch_iter)
                t0 = time.perf_counter()
                self.state, metrics = safe_step(self.state, batch)
                _wait(metrics["loss"])
                dt = time.perf_counter() - t0
                self.step += 1
                straggler = self.watchdog.record(dt)
                if straggler and (self.watchdog.straggler_events
                                  >= self.max_straggler_events):
                    self._save()
                if self.step % log_every == 0:
                    last = {k: float(v) for k, v in metrics.items()}
                    log_fn(f"step {self.step}: loss={last['loss']:.4f} "
                           f"gnorm={last['grad_norm']:.3f} {dt*1e3:.0f}ms")
                if self._ckpt and self.step % self.ckpt_every == 0:
                    self._save()
        except BaseException:
            if self._ckpt:  # emergency checkpoint, then re-raise
                self._ckpt.wait()
                ckpt.save(self.ckpt_dir, self.step, self.state,
                          extra={"emergency": True})
            raise
        if self._ckpt:
            self._save()
            self._ckpt.wait()
        return last

    def _save(self):
        if self._ckpt:
            self._ckpt.save(self.step, self.state,
                            extra={"mean_step_s": self.watchdog.mean_step})
