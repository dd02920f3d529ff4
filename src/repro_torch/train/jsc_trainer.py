"""QAT + FCP training of the JSC MLPs (the paper's training module),
following the reference (``repro/train/jsc_trainer.py``) step for step:
quantization-aware training with per-layer activation selection, fanin-
constrained pruning on the gradual (Zhu–Gupta) or ADMM schedule, hard
projection to the fanin budget, and a fine-tune of ``steps // 5`` steps
that keeps the optimizer state.

Training runs on the card by default (``device=None``). The reference
draws its init from ``jax.random``, whose streams torch cannot
reproduce, so ``train_jsc`` takes an optional initial model (``init``;
``repro_torch.weights.params_from_jax`` carries the reference's) and
otherwise draws one from ``torch.Generator().manual_seed(seed)``; the
float reference's init likewise comes from an explicit generator (seed
+ 7) unless given. Batches are the reference's numpy draws
(``data.jsc.batches``).
"""
from __future__ import annotations

import copy
import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.fcp import AdmmFCP, GradualFCP
from repro_torch.data import jsc as jsc_data
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import mlp as mlpm
from repro_torch.train.optim import AdamW

# the reference's parameter pytree order, per layer (its sorted dict keys)
_PARAM_ORDER = ("alpha", "b", "bn_beta", "bn_gamma", "w")


@dataclasses.dataclass
class JSCTrainResult:
    model: mlpm.MLP               # weights, final masks, BN statistics
    train_acc: float
    test_acc: float
    float_test_acc: float         # unquantized, unpruned reference
    steps: int                    # QAT steps, fine-tune included
    seconds: Dict[str, float]     # "qat" and "float" loops, synchronized

    @property
    def masks(self) -> List[torch.Tensor]:
        return [layer.mask for layer in self.model.layers]


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def evaluate(cfg: mlpm.MLPConfig, model: mlpm.MLP, x, y) -> float:
    """Eval-mode accuracy of the argmax over the first ``n_classes``
    scores."""
    dev = _device_of(model)
    scores = mlpm.mlp_forward(cfg, model, torch.as_tensor(x, device=dev))
    pred = torch.argmax(scores[:, : cfg.n_classes], dim=-1)
    return float(torch.mean((pred == torch.as_tensor(y, device=dev))
                            .float()))


class TrainStep:
    """One QAT step: the train-mode loss (plus the ADMM penalty when
    ``zs`` / ``us`` are given), its gradients, one optimizer update of
    the parameters in place; the BN statistics move in the forward."""

    def __init__(self, cfg: mlpm.MLPConfig, model: mlpm.MLP, opt: AdamW):
        self.cfg, self.model, self.opt = cfg, model, opt
        # the reference's pytree order, which the clipping norm sums in
        self.params = [getattr(layer, n) for layer in model.layers
                       for n in _PARAM_ORDER if hasattr(layer, n)]
        self.state = opt.init(self.params)
        self.admm = [AdmmFCP(f, rho=5e-3, dual_freq=50) for f in cfg.fanins]
        self.dev = _device_of(model)

    def loss_and_grads(self, xb: np.ndarray, yb: np.ndarray,
                       zs: Optional[Sequence[torch.Tensor]] = None,
                       us: Optional[Sequence[torch.Tensor]] = None):
        """The loss of one batch and its gradients in ``self.params``'
        order; the BN statistics move, the parameters do not."""
        x = torch.from_numpy(xb).to(self.dev)
        y = torch.from_numpy(yb).to(self.dev)
        loss = mlpm.mlp_loss(self.cfg, self.model, x, y)
        if zs is not None:
            for i, layer in enumerate(self.model.layers):
                loss = loss + self.admm[i].penalty(layer.w, zs[i], us[i])
        return loss.detach(), torch.autograd.grad(loss, self.params)

    def __call__(self, xb: np.ndarray, yb: np.ndarray,
                 zs: Optional[Sequence[torch.Tensor]] = None,
                 us: Optional[Sequence[torch.Tensor]] = None
                 ) -> torch.Tensor:
        loss, grads = self.loss_and_grads(xb, yb, zs, us)
        self.state = self.opt.update(grads, self.state, self.params)
        return loss


def train_jsc(cfg: mlpm.MLPConfig, steps: int = 1500, batch: int = 256,
              lr: float = 2e-3, seed: int = 0, fcp: str = "gradual",
              fcp_begin_frac: float = 0.25, fcp_end_frac: float = 0.7,
              n_train: int = 20000, n_test: int = 5000, data=None,
              init: Optional[mlpm.MLP] = None,
              device: DeviceLike = None) -> JSCTrainResult:
    """Train ``cfg`` with QAT + FCP; see the module's note. ``init`` is
    copied, not changed."""
    dev = resolve_device(device)
    if data is None:
        (xtr, ytr), (xte, yte) = jsc_data.train_test(n_train, n_test, seed)
    else:
        (xtr, ytr), (xte, yte) = data
    if init is None:
        model = mlpm.init_mlp(cfg, torch.Generator().manual_seed(seed))
    else:
        model = copy.deepcopy(init)
    model = model.to(dev)
    step = TrainStep(cfg, model, AdamW(lr=lr, weight_decay=1e-4,
                                       grad_clip=1.0))

    sched = GradualFCP(target_fanin=0,  # per-layer target set in update
                       begin_step=int(steps * fcp_begin_frac),
                       end_step=int(steps * fcp_end_frac), freq=25)
    admm = step.admm if fcp == "admm" else None
    zs = us = None
    if admm:
        zs, us = map(list, zip(*(a.init_state(layer.w) for a, layer
                                 in zip(admm, model.layers))))

    _sync(dev)
    t0 = time.perf_counter()
    it = jsc_data.batches(xtr, ytr, batch, seed)
    for t in range(steps):
        step(*next(it), zs, us)
        if fcp == "gradual" and t >= sched.begin_step and t % sched.freq == 0:
            model.set_masks(mlpm.update_masks_gradual(cfg, model, t, sched))
        if admm and t % 50 == 49:
            for i, layer in enumerate(model.layers):
                zs[i], us[i] = admm[i].dual_update(layer.w, zs[i], us[i])

    # hard projection to the fanin budget + short fine-tune
    with torch.no_grad():
        model.set_masks(mlpm.final_masks(cfg, model))
        for layer in model.layers:
            layer.w.copy_(torch.where(layer.mask, layer.w, 0.0))
    for _ in range(steps // 5):
        step(*next(it))
    _sync(dev)
    qat_s = time.perf_counter() - t0

    train_acc = evaluate(cfg, model, xtr[:5000], ytr[:5000])
    test_acc = evaluate(cfg, model, xte, yte)

    # float reference (no quant/prune): same topology, quick train
    t0 = time.perf_counter()
    float_acc = _float_reference(cfg, xtr, ytr, xte, yte, seed, dev)
    float_s = time.perf_counter() - t0
    return JSCTrainResult(model, train_acc, test_acc, float_acc,
                          steps + steps // 5,
                          {"qat": qat_s, "float": float_s})


def _float_init(cfg: mlpm.MLPConfig, seed: int) -> List[List[torch.Tensor]]:
    """The float reference's [w, b] per layer: w ~ N(0, 1/d_in) from
    ``torch.Generator().manual_seed(seed + 7)``, b = 0."""
    g = torch.Generator().manual_seed(seed + 7)
    sizes = (cfg.n_inputs,) + tuple(cfg.features)
    return [[torch.randn(d_out, d_in, generator=g) / math.sqrt(d_in),
             torch.zeros(d_out)] for d_in, d_out in zip(sizes[:-1],
                                                         sizes[1:])]


def _leaf(a, dev: torch.device) -> torch.Tensor:
    """A float32 copy of ``a`` (tensor or array) on ``dev`` that takes
    gradients."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.array(a, np.float32))
    return t.to(dev, torch.float32).clone().requires_grad_()


def _float_reference(cfg: mlpm.MLPConfig, xtr, ytr, xte, yte, seed: int,
                     device: DeviceLike = None, init=None) -> float:
    """Test accuracy of the float ReLU MLP of the same widths after 800
    AdamW(lr=2e-3) steps of 256 rows; ``init`` gives its [w, b] per
    layer (default ``_float_init``)."""
    dev = resolve_device(device)
    ws = [[_leaf(a, dev) for a in wb]
          for wb in (_float_init(cfg, seed) if init is None else init)]
    params = [p for wb in ws for p in wb]

    def fwd(x):
        h = x
        for i, (w, b) in enumerate(ws):
            h = h @ w.T + b
            if i < len(ws) - 1:
                h = torch.relu(h)
        return h[:, : cfg.n_classes]

    opt = AdamW(lr=2e-3)
    state = opt.init(params)
    it = jsc_data.batches(xtr, ytr, 256, seed)
    for _ in range(800):
        xb, yb = next(it)
        x = torch.from_numpy(xb).to(dev)
        y = torch.from_numpy(yb).to(dev).long()
        lp = torch.log_softmax(fwd(x), dim=-1)
        loss = -torch.mean(torch.gather(lp, 1, y[:, None]))
        state = opt.update(torch.autograd.grad(loss, params), state, params)
    with torch.no_grad():
        pred = torch.argmax(fwd(torch.as_tensor(xte, device=dev)), dim=-1)
        return float(torch.mean((pred == torch.as_tensor(yte, device=dev))
                                .float()))
