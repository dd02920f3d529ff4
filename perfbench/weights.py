"""Seeded weights of a dense decoder, one leaf at a time.

Each leaf is drawn by a ``torch.Generator`` of its own on the device,
seeded from ``--seed`` and the leaf's name, in one call. So the harness
makes the port's weights and the reference makes any leaf again, block
by block, with the same values and without reading the port's. Names
are the port's parameter tree flattened with ``::`` (``layers::0::attn::wq``,
as ``repro_torch.models.lm.named_leaves`` writes them). Matrices are
N(0, 1 / fan-in), the embedding N(0, 0.02^2), norm scales ones: the
port's own initialisation. This module imports nothing of the port.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import torch

from perfbench import work


def leaf_seed(seed: int, name: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def leaf_specs(arch) -> List[Tuple[str, Tuple[int, ...], float | None]]:
    """(name, shape, scale) of every leaf; scale None for a norm scale
    (ones)."""
    k = work.dims(arch)
    d, h, kv, dh, f, vp = k["d"], k["h"], k["kv"], k["dh"], k["f"], k["vp"]
    out = [("embed", (vp, d), 0.02), ("final_norm", (d,), None)]
    for i in range(k["L"]):
        p = f"layers::{i}::"
        out += [(p + "attn::wk", (d, kv * dh), 1 / math.sqrt(d)),
                (p + "attn::wo", (h * dh, d), 1 / math.sqrt(h * dh)),
                (p + "attn::wq", (d, h * dh), 1 / math.sqrt(d)),
                (p + "attn::wv", (d, kv * dh), 1 / math.sqrt(d)),
                (p + "ln1", (d,), None), (p + "ln2", (d,), None),
                (p + "mlp::w1", (d, f), 1 / math.sqrt(d)),
                (p + "mlp::w2", (f, d), 1 / math.sqrt(f))]
        if k["mats"] == 3:
            out.append((p + "mlp::w3", (d, f), 1 / math.sqrt(d)))
    out.append(("lm_head", (d, vp), 1 / math.sqrt(d)))
    return out


def make_leaf(seed: int, name: str, shape, scale, dtype: torch.dtype,
              device) -> torch.Tensor:
    """One leaf: ones (float32) for a norm scale, else a seeded normal
    drawn in ``dtype`` and scaled in it."""
    if scale is None:
        return torch.ones(shape, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, name))
    t = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return t.mul_(scale)


def make_all(arch, seed: int, dtype: torch.dtype, device
             ) -> Dict[str, torch.Tensor]:
    return {name: make_leaf(seed, name, shape, scale, dtype, device)
            for name, shape, scale in leaf_specs(arch)}


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """``::``-joined names -> the nested tree, ``layers`` a list."""
    tree: dict = {"layers": []}
    for name, t in flat.items():
        parts = name.split("::")
        node = tree
        if parts[0] == "layers":
            i = int(parts[1])
            while len(tree["layers"]) <= i:
                tree["layers"].append({})
            node, parts = tree["layers"][i], parts[2:]
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = t
    return tree
