"""Weights in and out of the port's ``MLP``.

``params_from_jax`` takes the reference package's pytrees
(``{"layers": [{"w", "b", "alpha", "bn_gamma", "bn_beta"}, ...]}``, the
masks list and ``{"mean": [...], "var": [...]}``) as numpy arrays or
anything ``np.asarray`` accepts, and returns the port's module; nothing
of JAX is imported. ``save_params_npz`` / ``load_params_npz`` keep a
model in one ``.npz`` with a flat layout:

    layers.{i}.{w,b,alpha,bn_gamma,bn_beta}   parameters
    masks.{i}                                 FCP masks (bool)
    bn.mean.{i}, bn.var.{i}                   BN running statistics
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Sequence

import numpy as np
import torch

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
