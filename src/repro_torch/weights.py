"""Weights in and out of the port's ``MLP``.

``params_from_jax`` takes the reference package's pytrees
(``{"layers": [{"w", "b", "alpha", "bn_gamma", "bn_beta"}, ...]}``, the
masks list and ``{"mean": [...], "var": [...]}``) as numpy arrays or
anything ``np.asarray`` accepts, and returns the port's module; nothing
of JAX is imported. ``params_to_jax`` is its inverse: the module as
numpy arrays in the reference's layout, which ``jnp.asarray`` (or
``jax.tree.map(jnp.asarray, ...)``) turns into the reference's
pytrees. ``save_params_npz`` / ``load_params_npz`` keep a
model in one ``.npz`` with a flat layout:

    layers.{i}.{w,b,alpha,bn_gamma,bn_beta}   parameters
    masks.{i}                                 FCP masks (bool)
    bn.mean.{i}, bn.var.{i}                   BN running statistics

``lm_params_from_jax`` does for the LM stack what ``params_from_jax``
does for the MLP: the reference's ``lm.init_params`` pytree as the port's
``repro_torch.models.lm.Params``.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.mlp import MLP

_PARAMS = ("w", "b", "alpha", "bn_gamma", "bn_beta")


@torch.no_grad()
def params_from_jax(params: dict, masks: Sequence,
                    bn_state: Optional[dict] = None) -> MLP:
    """The reference's (params, masks, bn_state) as the port's module."""
    layers = params["layers"]
    ws = [np.asarray(lp["w"], np.float32) for lp in layers]
    bn = "bn_gamma" in layers[0]
    if bn and bn_state is None:
        raise ValueError("the parameters carry BN affines but no bn_state "
                         "was given")
    model = MLP(ws[0].shape[1], [w.shape[0] for w in ws], bn=bn)
    for i, (layer, lp) in enumerate(zip(model.layers, layers)):
        if "alpha" not in lp:
            raise ValueError(f"layer {i} has no learnable 'alpha'")
        for name in _PARAMS:
            if name in lp:
                getattr(layer, name).copy_(
                    torch.as_tensor(np.array(lp[name], np.float32)))
        layer.mask.copy_(torch.as_tensor(np.array(masks[i], bool)))
        if bn:
            layer.bn_mean.copy_(torch.as_tensor(
                np.array(bn_state["mean"][i], np.float32)))
            layer.bn_var.copy_(torch.as_tensor(
                np.array(bn_state["var"][i], np.float32)))
    return model


@torch.no_grad()
def params_to_jax(model: MLP) -> Tuple[dict, List[np.ndarray], Optional[dict]]:
    """The port's module as the reference's ``(params, masks, bn_state)``
    of numpy arrays (``bn_state`` is None without BN)."""
    layers, masks = [], []
    for layer in model.layers:
        layers.append({name: getattr(layer, name).detach().cpu().numpy()
                       for name in _PARAMS if hasattr(layer, name)})
        masks.append(layer.mask.cpu().numpy())
    bn_state = None
    if model.layers[0].bn:
        bn_state = {"mean": [l.bn_mean.cpu().numpy() for l in model.layers],
                    "var": [l.bn_var.cpu().numpy() for l in model.layers]}
    return {"layers": layers}, masks, bn_state


def save_params_npz(path, model: MLP) -> None:
    """Write the model in the flat ``.npz`` layout."""
    out: Dict[str, np.ndarray] = {}
    for i, layer in enumerate(model.layers):
        for name in _PARAMS:
            if hasattr(layer, name):
                out[f"layers.{i}.{name}"] = \
                    getattr(layer, name).detach().cpu().numpy()
        out[f"masks.{i}"] = layer.mask.cpu().numpy()
        if layer.bn:
            out[f"bn.mean.{i}"] = layer.bn_mean.cpu().numpy()
            out[f"bn.var.{i}"] = layer.bn_var.cpu().numpy()
    np.savez(path, **out)


def load_params_npz(path) -> MLP:
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    n_layers = 1 + max(int(m.group(1)) for k in arrays
                       if (m := re.match(r"layers\.(\d+)\.w$", k)))
    layers = [{name: arrays[f"layers.{i}.{name}"] for name in _PARAMS
               if f"layers.{i}.{name}" in arrays} for i in range(n_layers)]
    masks = [arrays[f"masks.{i}"] for i in range(n_layers)]
    bn_state = None
    if "bn.mean.0" in arrays:
        bn_state = {"mean": [arrays[f"bn.mean.{i}"] for i in range(n_layers)],
                    "var": [arrays[f"bn.var.{i}"] for i in range(n_layers)]}
    return params_from_jax({"layers": layers}, masks, bn_state)


def lm_params_from_jax(cfg: ArchConfig, params: dict):
    """The reference's LM parameters (``repro.models.lm.init_params``'s
    pytree as numpy arrays, or anything ``np.asarray`` accepts) as the
    port's ``Params`` on the CPU: ``embed``, ``final_norm``, ``lm_head``,
    ``enc_norm``, and the leaves under ``layers`` (``ln1``, ``ln2``,
    ``attn.*``, ``mlp.*``, ``moe.*``, ``mamba.*``, ``ln_attn_out``,
    ``ln_mamba_out``, ``ln_cross``, ``cross.*``) and ``enc_layers``,
    stacked on a leading axis ``n_layers`` and ``n_enc_layers`` deep,
    which become ``Params.layers`` and ``Params.enc_layers``. Values are
    copied as float32."""
    from repro_torch.models.lm import Params, _require_supported
    _require_supported(cfg)

    def leaf(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))

    def layer(tree, i):
        return {k: layer(v, i) if isinstance(v, dict)
                else leaf(np.asarray(v)[i]) for k, v in tree.items()}

    stacks = {"layers": cfg.n_layers}
    if cfg.is_encdec:
        stacks["enc_layers"] = cfg.n_enc_layers
    tree = {k: leaf(v) for k, v in params.items() if k not in stacks}
    for key, depth in stacks.items():
        n = {np.asarray(v).shape[0] for v in _leaves(params[key])}
        if n != {depth}:
            raise ValueError(f"{key} stacked {sorted(n)} deep, expected "
                             f"{depth}")
        tree[key] = [layer(params[key], i) for i in range(depth)]
    return Params(tree)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v
