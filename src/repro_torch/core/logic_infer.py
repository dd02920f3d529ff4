"""Execution of a compiled logic network in torch.

A ``LogicNetwork`` is a sequence of ``LayerTables``; inference is a
chain of bit-pack + table-gather operations, one per layer. Both a
plain torch path (the oracle, ``use_kernel=False``) and the lut_layer
kernel (``repro_torch.kernels.lut_layer``; the plain version on the
CPU) are provided.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .quant import ActQuantSpec, apply_act_quant, encode_levels
from .truthtable import LayerTables, table_index


@dataclasses.dataclass
class LogicNetwork:
    """Fixed-function network: input quantizer + per-layer truth tables."""

    layers: List[LayerTables]
    in_spec: ActQuantSpec
    in_alpha: float
    n_inputs: int
    n_outputs: int
    # per-device int32 copies of (fanin_idx, tables), made on first use
    _tensors: Dict[torch.device, List[Tuple[torch.Tensor, torch.Tensor]]] = \
        dataclasses.field(default_factory=dict, repr=False, compare=False)

    def layer_tensors(self, device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """(fanin_idx, tables) of every layer as int32 tensors on
        ``device`` (copied once per device)."""
        device = torch.device(device)
        if device not in self._tensors:
            self._tensors[device] = [
                (torch.as_tensor(lt.fanin_idx, dtype=torch.int32,
                                 device=device),
                 torch.as_tensor(lt.tables.astype(np.int32), device=device))
                for lt in self.layers]
        return self._tensors[device]

    def quantize_inputs(self, x: torch.Tensor) -> torch.Tensor:
        """Real inputs -> int32 level codes, on x's device."""
        q = apply_act_quant(self.in_spec, x, self.in_alpha)
        return encode_levels(self.in_spec, q, self.in_alpha)

    def apply_codes(self, codes: torch.Tensor,
                    use_kernel: bool = False) -> torch.Tensor:
        """codes: (batch, n_inputs) int32 -> output codes (batch, n_out)."""
        for lt, (idx, tables) in zip(self.layers,
                                     self.layer_tensors(codes.device)):
            codes = logic_layer_apply(lt, codes, use_kernel=use_kernel,
                                      idx=idx, tables=tables)
        return codes

    def out_levels(self, device=None) -> torch.Tensor:
        """Decoded values of the last layer's codes (float32)."""
        last = self.layers[-1]
        return torch.as_tensor(last.out_spec.levels(last.out_alpha),
                               device=device)

    def __call__(self, x: torch.Tensor,
                 use_kernel: bool = False) -> torch.Tensor:
        """Real inputs -> decoded real outputs of the last layer."""
        codes = self.quantize_inputs(x)
        out_codes = self.apply_codes(codes, use_kernel=use_kernel)
        return self.out_levels(x.device)[out_codes.long()]


def logic_layer_apply(lt: LayerTables, codes: torch.Tensor,
                      use_kernel: bool = False, idx=None,
                      tables=None) -> torch.Tensor:
    """Apply one truth-table layer: (batch, n_in) codes -> (batch, N).

    ``use_kernel`` runs the lut_layer kernel (its plain version for CPU
    tensors); otherwise the plain gather path. ``idx`` / ``tables`` may
    pass the layer's tensors already on ``codes.device``."""
    dev = codes.device
    if idx is None:
        idx = torch.as_tensor(lt.fanin_idx, dtype=torch.int32, device=dev)
    if tables is None:
        tables = torch.as_tensor(lt.tables.astype(np.int32), device=dev)
    if use_kernel:
        from repro_torch.kernels.lut_layer import lut_layer
        return lut_layer(codes, idx, tables, lt.in_spec.n_levels)
    gathered = codes[:, idx.long()]                       # (batch, N, K)
    rows = table_index(gathered, lt.in_spec.n_levels)     # (batch, N)
    return torch.gather(tables, 1, rows.T.long()).T


def argmax_labels(net: LogicNetwork, out_codes: torch.Tensor,
                  classes: int) -> torch.Tensor:
    """Last-layer codes -> argmax over their decoded values (first index
    on ties, as ``jnp.argmax``)."""
    vals = net.out_levels(out_codes.device)[out_codes.long()]
    return torch.argmax(vals[..., :classes], dim=-1)


def classify(net: LogicNetwork, x: torch.Tensor, classes: int,
             use_kernel: bool = False) -> torch.Tensor:
    """Argmax over the decoded last-layer values (first index on ties,
    as ``jnp.argmax``)."""
    codes = net.apply_codes(net.quantize_inputs(x), use_kernel=use_kernel)
    return argmax_labels(net, codes, classes)


# ---------------------------------------------------------------------------
# Conversion driver: trained QAT+FCP MLP -> LogicNetwork
# ---------------------------------------------------------------------------

def compile_mlp_to_logic(params: dict, specs: Sequence[ActQuantSpec],
                         alphas: Sequence[float], masks: Sequence[np.ndarray],
                         fanins: Sequence[int], in_spec: ActQuantSpec,
                         in_alpha: float) -> LogicNetwork:
    """Compile a quantized MLP to logic (tables built on the host).

    params: {'layers': [{'w','b', optional bn stats}...]} of tensors or
    arrays. specs/alphas: *output* activation spec per layer.
    """
    from .truthtable import extract_layer_tables

    layer_tables: List[LayerTables] = []
    prev_spec, prev_alpha = in_spec, in_alpha
    for i, lp in enumerate(params["layers"]):
        lt = extract_layer_tables(
            w=lp["w"], b=lp["b"], mask=masks[i],
            in_spec=prev_spec, out_spec=specs[i],
            in_alpha=prev_alpha, out_alpha=float(alphas[i]),
            fanin=fanins[i],
            gamma=lp.get("bn_gamma"), beta=lp.get("bn_beta"),
            bn_mean=lp.get("bn_mean"), bn_var=lp.get("bn_var"),
        )
        layer_tables.append(lt)
        prev_spec, prev_alpha = specs[i], float(alphas[i])
    n_in = params["layers"][0]["w"].shape[1]
    n_out = params["layers"][-1]["w"].shape[0]
    return LogicNetwork(layer_tables, in_spec, float(in_alpha), n_in, n_out)


# ---------------------------------------------------------------------------
# Hardware report for a LogicNetwork (espresso + lutmap pipeline, host)
# ---------------------------------------------------------------------------

def hardware_report(net: LogicNetwork, minimize_logic: bool = True):
    """Two-level minimization + LUT mapping over every neuron.

    Returns (MapReport, per-layer list). ``minimize_logic=False`` gives the
    LogicNets-style baseline cost (raw table mapping, no espresso).
    """
    from .espresso import minimize
    from .lutmap import (MapReport, logicnets_lut_cost, map_cover,
                         map_layer, map_network)
    from .truthtable import onset_of

    per_layer = []
    for lt in net.layers:
        out_bits = lt.out_spec.code_bits
        in_bits = lt.in_spec.code_bits
        fanin_bits = lt.fanin * in_bits
        neuron_reports = []
        for j in range(lt.n_neurons):
            table = np.asarray(lt.tables[j])
            if minimize_logic:
                # one Boolean function per output bit, on bit-level rows
                rep = MapReport(0, 0, 0)
                for ob in range(out_bits):
                    onset, dc = _bitexpand(onset_of(table, ob), lt, in_bits)
                    rep = rep + map_cover(minimize(onset, dc))
                neuron_reports.append(rep)
            else:
                neuron_reports.append(logicnets_lut_cost(fanin_bits, out_bits))
        per_layer.append(
            map_layer(neuron_reports, out_bits * lt.n_neurons))
    return map_network(per_layer), per_layer


def _bitexpand(onset_codes: np.ndarray, lt: LayerTables, in_bits: int):
    """Re-index an onset from code-radix rows to bit-packed rows.

    Table rows are indexed in radix n_levels per fanin; Boolean
    minimization wants radix-2 per *bit*. When n_levels is a power of two
    the mappings coincide (empty DC set); otherwise bit rows containing
    an unused code become DON'T CARES — they can never occur at runtime,
    and handing them to ESPRESSO is precisely how the paper shrinks the
    two-level covers. Returns (onset, dc)."""
    n_levels = lt.in_spec.n_levels
    k = lt.fanin
    n_bit_rows = 1 << (k * in_bits)
    if n_levels == (1 << in_bits):
        return onset_codes, None  # already aligned, fully specified
    out = np.zeros(n_bit_rows, bool)
    reachable = np.zeros(n_bit_rows, bool)
    codes = np.arange(len(onset_codes))
    digits = np.empty((len(codes), k), np.int64)
    for i in range(k):
        digits[:, i] = (codes // (n_levels ** i)) % n_levels
    bit_rows = np.zeros(len(codes), np.int64)
    for i in range(k):
        bit_rows |= digits[:, i] << (i * in_bits)
    out[bit_rows] = onset_codes
    reachable[bit_rows] = True
    return out, ~reachable
