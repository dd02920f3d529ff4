"""Truth-table extraction — NullaNet Tiny's core conversion step.

For each neuron j with fanin set S_j (|S_j| = K) and b-bit quantized
inputs, enumerate all (2^b)^K input combinations, push them through
(folded-BN) MAC + output activation quantizer, and record the output
*level codes*. MAC + BN + activation collapse into one lookup table —
the "fixed-function combinational logic" of the paper title.

Extraction runs on the host (CPU): the pre-activations are float64
numpy, the output quantizer float32 torch, in the reference's order, so
tables never depend on the device that later serves them.

Tables are stored code-indexed: index = sum_k code_k * n_levels^k
(little-endian in fanin position k). For binary activations this is the
classic bit-packed truth-table index.
"""
from __future__ import annotations

import dataclasses
import numpy as np
import torch

from .quant import ActQuantSpec, apply_act_quant, encode_levels


@dataclasses.dataclass
class NeuronTable:
    """Truth table of one neuron: fanin indices + output code per row."""

    fanin_idx: np.ndarray      # (K,) int32 — columns of the input vector
    table: np.ndarray          # (n_levels_in ** K,) int8/int16 output codes
    n_levels_in: int
    n_levels_out: int

    @property
    def fanin(self) -> int:
        return int(self.fanin_idx.shape[0])


@dataclasses.dataclass
class LayerTables:
    """All neuron tables of one layer (homogeneous fanin K)."""

    fanin_idx: np.ndarray      # (N, K)
    tables: np.ndarray         # (N, n_levels_in ** K)
    in_spec: ActQuantSpec
    out_spec: ActQuantSpec
    in_alpha: float
    out_alpha: float

    @property
    def n_neurons(self) -> int:
        return int(self.tables.shape[0])

    @property
    def fanin(self) -> int:
        return int(self.fanin_idx.shape[1])

    def neuron(self, j: int) -> NeuronTable:
        return NeuronTable(
            fanin_idx=self.fanin_idx[j],
            table=self.tables[j],
            n_levels_in=self.in_spec.n_levels,
            n_levels_out=self.out_spec.n_levels,
        )


def enumerate_codes(n_levels: int, fanin: int) -> np.ndarray:
    """All (n_levels^K, K) input code combinations, little-endian."""
    n_rows = n_levels ** fanin
    if n_rows > (1 << 24):
        raise ValueError(
            f"enumeration of {n_levels}^{fanin} = {n_rows} rows is infeasible; "
            "tighten the fanin constraint (this is exactly why the paper "
            "applies FCP before conversion)")
    rows = np.arange(n_rows, dtype=np.int64)
    combos = np.empty((n_rows, fanin), dtype=np.int32)
    for k in range(fanin):
        combos[:, k] = (rows // (n_levels ** k)) % n_levels
    return combos


def _host_f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to(device="cpu", dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32))


def extract_layer_tables(
    w,
    b,
    mask,
    in_spec: ActQuantSpec,
    out_spec: ActQuantSpec,
    in_alpha: float,
    out_alpha: float,
    fanin: int,
    gamma=None,
    beta=None,
    bn_mean=None,
    bn_var=None,
) -> LayerTables:
    """Convert one fanin-pruned quantized linear(+BN)+act layer to tables.

    w: (out, in) weights (already trained & masked), b: (out,) bias;
    tensors or arrays, copied to the host as float32. The enumeration
    is fully vectorised: one (n_levels^K, K) combo matrix is shared by
    all neurons; per-neuron weights are gathered via fanin_idx.
    """
    from .fcp import fanin_indices
    from .quant import fold_bn

    mask_np = np.array(mask.cpu() if isinstance(mask, torch.Tensor)
                         else mask, bool)
    w = torch.where(torch.as_tensor(mask_np), _host_f32(w), 0.0)
    b = _host_f32(b)
    if gamma is not None:
        w, b = fold_bn(w, b, _host_f32(gamma), _host_f32(beta),
                       _host_f32(bn_mean), _host_f32(bn_var))

    idx_np, _valid = fanin_indices(mask_np, fanin)          # (N, K)
    n_levels_in = in_spec.n_levels
    combos = enumerate_codes(n_levels_in, fanin)            # (R, K) codes
    in_levels = in_spec.levels(in_alpha)                    # (n_levels_in,)
    combo_vals = in_levels[combos]                          # (R, K) values

    w_np = w.numpy().astype(np.float64)
    b_np = b.numpy().astype(np.float64)
    n = w_np.shape[0]

    # gather per-neuron fanin weights: (N, K)
    wk = np.take_along_axis(w_np, idx_np, axis=1)
    # Padded duplicate indices would double-count a weight; zero all but the
    # first occurrence of each column within a row.
    for j in range(n):
        seen = {}
        for k in range(idx_np.shape[1]):
            c = int(idx_np[j, k])
            if c in seen:
                wk[j, k] = 0.0
            else:
                seen[c] = k

    # pre-activations for every neuron and combo: (N, R)
    pre = wk @ combo_vals.T + b_np[:, None]

    # output activation quantizer -> codes (float32, as the reference)
    pre_t = torch.from_numpy(pre).to(torch.float32)
    q = apply_act_quant(out_spec, pre_t,
                        torch.tensor(out_alpha, dtype=torch.float32))
    tables = encode_levels(out_spec, q, out_alpha).numpy()
    dt = np.int8 if out_spec.n_levels <= 127 else np.int16
    return LayerTables(
        fanin_idx=idx_np.astype(np.int32),
        tables=tables.astype(dt),
        in_spec=in_spec,
        out_spec=out_spec,
        in_alpha=float(in_alpha),
        out_alpha=float(out_alpha),
    )


def table_index(codes: torch.Tensor, n_levels: int) -> torch.Tensor:
    """Pack per-fanin codes (..., K) into int32 table row indices (...,)."""
    k = codes.shape[-1]
    weights = torch.tensor([n_levels ** i for i in range(k)],
                           dtype=torch.int32, device=codes.device)
    return (codes.to(torch.int32) * weights).sum(dim=-1, dtype=torch.int32)


def onset_of(table: np.ndarray, out_bit: int) -> np.ndarray:
    """Boolean on-set bitmap of one output bit of a (possibly multi-bit)
    truth table. Multi-bit outputs become ``code_bits`` separate Boolean
    functions (the paper minimizes each independently)."""
    return ((table.astype(np.int64) >> out_bit) & 1).astype(bool)
