"""Quantized, fanin-prunable MLP — the paper's evaluation model family.

JSC-S/M/L (LogicNets architectures) are instances of this model:
linear -> batch-norm -> quantized activation per layer, compiled to
fixed-function logic via ``repro_torch.core``.

``MLP`` is an ``nn.Module`` holding, per layer, the weights ``w``, bias
``b``, learnable quantizer range ``alpha`` and BN affine ``bn_gamma`` /
``bn_beta`` as parameters, and the FCP mask and BN running statistics
as buffers. Like the reference, the functions take the configuration
beside the module (``mlp_forward(cfg, model, x)``). The train-mode
forward takes batch statistics (population variance, as ``jnp.var``)
and updates the BN running statistics in place, as a torch BatchNorm
does, where the reference returns them; ``mlp_loss`` is the
reference's temperature-sharpened cross entropy.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.core import quant as Q
from repro_torch.core.fcp import GradualFCP, topk_row_mask
from repro_torch.core.quant import ActQuantSpec

BN_MOMENTUM = 0.1



@dataclasses.dataclass(frozen=True)
class MLPConfig:
    name: str
    n_inputs: int
    features: Tuple[int, ...]        # hidden + output widths
    fanins: Tuple[int, ...]          # per-layer fanin budget (post-FCP)
    act_bits: Tuple[int, ...]        # per-layer *output* activation bits
    in_bits: int = 1                 # input quantization bits
    n_classes: int = 5
    alpha: float = 2.0               # quantizer range
    bn: bool = True

    @property
    def n_layers(self) -> int:
        return len(self.features)

    def in_spec(self) -> ActQuantSpec:
        # JSC features are standardised (both signs) -> signed branch
        return Q.select_activation(False, self.in_bits)

    def layer_specs(self) -> List[ActQuantSpec]:
        """Per-layer output activation specs (paper's selection rule)."""
        return [Q.select_activation(False, b) for b in self.act_bits]


class MLPLayer(nn.Module):
    """linear (+ BN) + quantized activation; masked by the FCP mask."""

    def __init__(self, d_in: int, d_out: int, alpha: float, bn: bool):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(d_out, d_in))
        self.b = nn.Parameter(torch.zeros(d_out))
        self.alpha = nn.Parameter(torch.tensor(float(alpha)))
        self.bn = bn
        if bn:
            self.bn_gamma = nn.Parameter(torch.ones(d_out))
            self.bn_beta = nn.Parameter(torch.zeros(d_out))
            self.register_buffer("bn_mean", torch.zeros(d_out))
            self.register_buffer("bn_var", torch.ones(d_out))
        self.register_buffer("mask", torch.ones(d_out, d_in, dtype=torch.bool))


class MLP(nn.Module):
    """The layers of one quantized MLP (see ``init_mlp``)."""

    def __init__(self, n_inputs: int, features: Sequence[int],
                 alpha: float = 2.0, bn: bool = True):
        super().__init__()
        dims = [n_inputs, *features]
        self.layers = nn.ModuleList(
            MLPLayer(d_in, d_out, alpha, bn)
            for d_in, d_out in zip(dims[:-1], dims[1:]))

    @classmethod
    def for_config(cls, cfg: MLPConfig) -> "MLP":
        return cls(cfg.n_inputs, cfg.features, cfg.alpha, cfg.bn)

    @torch.no_grad()
    def set_masks(self, masks: Sequence[torch.Tensor]) -> None:
        for layer, m in zip(self.layers, masks):
            layer.mask.copy_(torch.as_tensor(m, dtype=torch.bool))


@torch.no_grad()
def init_mlp(cfg: MLPConfig, generator: Optional[torch.Generator] = None,
             device=None) -> MLP:
    """Seeded init: w ~ N(0, 1/d_in), b = 0, alpha = cfg.alpha, BN at
    identity (gamma 1, beta 0, mean 0, var 1), masks all ones. The
    generator's stream differs from ``jax.random``'s, so a seed gives
    other weights than the reference's."""
    model = MLP.for_config(cfg)
    for layer in model.layers:
        d_out, d_in = layer.w.shape
        layer.w.copy_(torch.randn(d_out, d_in, generator=generator)
                      * (1.0 / math.sqrt(d_in)))
    return model.to(device) if device is not None else model


def layer_alpha(cfg: MLPConfig, layer: MLPLayer) -> torch.Tensor:
    """Learnable positive quantizer range (float32)."""
    return torch.abs(layer.alpha) + 1e-3


def mlp_forward(cfg: MLPConfig, model: MLP, x: torch.Tensor,
                train: bool = False) -> torch.Tensor:
    """Quantized forward: the decoded real values of the last layer
    (pre-argmax).

    Eval mode (the default) runs without autograd and normalises with
    the BN running statistics. Train mode keeps the graph, normalises
    with the batch's mean and population variance, and moves the
    running statistics towards them by ``BN_MOMENTUM``, in place."""
    if not train:
        with torch.no_grad():
            return _forward(cfg, model, x, False)
    return _forward(cfg, model, x, True)


def _forward(cfg: MLPConfig, model: MLP, x: torch.Tensor,
             train: bool) -> torch.Tensor:
    specs = cfg.layer_specs()
    h = Q.apply_act_quant(cfg.in_spec(), x, cfg.alpha)
    for i, layer in enumerate(model.layers):
        w = torch.where(layer.mask, layer.w, 0.0)
        y = h @ w.T + layer.b
        if cfg.bn:
            if train:
                mu = torch.mean(y, dim=0)
                var = torch.var(y, dim=0, correction=0)
                with torch.no_grad():
                    layer.bn_mean.copy_((1 - BN_MOMENTUM) * layer.bn_mean
                                        + BN_MOMENTUM * mu)
                    layer.bn_var.copy_((1 - BN_MOMENTUM) * layer.bn_var
                                       + BN_MOMENTUM * var)
            else:
                mu, var = layer.bn_mean, layer.bn_var
            y = (y - mu) * torch.rsqrt(var + 1e-5)
            y = y * layer.bn_gamma + layer.bn_beta
        h = Q.apply_act_quant(specs[i], y, layer_alpha(cfg, layer))
    return h


def mlp_loss(cfg: MLPConfig, model: MLP, x: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``log_softmax(logits / 0.25)``
    (the temperature sharpens the quantized scores), over the train-mode
    forward."""
    scores = mlp_forward(cfg, model, x, train=True)
    logp = torch.log_softmax(scores[:, : cfg.n_classes] / 0.25, dim=-1)
    return -torch.mean(torch.gather(logp, 1, labels.long()[:, None]))


@torch.no_grad()
def update_masks_gradual(cfg: MLPConfig, model: MLP, step: int,
                         schedule: GradualFCP) -> List[torch.Tensor]:
    """FCP masks at ``step`` of the gradual schedule, each layer with its
    own target fanin."""
    return [dataclasses.replace(schedule, target_fanin=cfg.fanins[i])
            .update_mask(layer.w, step)
            for i, layer in enumerate(model.layers)]


@torch.no_grad()
def final_masks(cfg: MLPConfig, model: MLP) -> List[torch.Tensor]:
    """The fanin-``cfg.fanins[i]`` top-|w| mask of every layer."""
    return [topk_row_mask(layer.w, cfg.fanins[i])
            for i, layer in enumerate(model.layers)]


@torch.no_grad()
def to_logic(cfg: MLPConfig, model: MLP):
    """Compile the MLP to a ``LogicNetwork`` (tables built on the host)."""
    from repro_torch.core.logic_infer import compile_mlp_to_logic

    layers = []
    for layer in model.layers:
        d = {"w": layer.w.cpu(), "b": layer.b.cpu()}
        if cfg.bn:
            d.update({"bn_gamma": layer.bn_gamma.cpu(),
                      "bn_beta": layer.bn_beta.cpu(),
                      "bn_mean": layer.bn_mean.cpu(),
                      "bn_var": layer.bn_var.cpu()})
        layers.append(d)
    return compile_mlp_to_logic(
        {"layers": layers},
        specs=cfg.layer_specs(),
        alphas=[float(layer_alpha(cfg, layer))
                for layer in model.layers],
        masks=[layer.mask.cpu().numpy() for layer in model.layers],
        fanins=list(cfg.fanins),
        in_spec=cfg.in_spec(),
        in_alpha=cfg.alpha,
    )
