"""Wrapper of the lut_layer kernel (``csrc/lut_layer.cu``).

Casts codes, fanin indices and tables to contiguous int32 (the
reference stores tables as int8/int16), checks shapes and devices, and
launches the kernel on torch's current stream for CUDA tensors or runs
the plain version (``ref.py``) for CPU tensors. Codes must lie in
``[0, n_levels)``: the kernel reads ``tables[j, row]`` unchecked.
"""
from __future__ import annotations

import torch

from .. import build
from ..common import check_int32, require_cuda, stream_of
from .ref import lut_layer_ref

TILE_B = 64            # batch rows per block (csrc/lut_layer.cu)
MAX_GRID_Y = 65_535


def lut_layer(codes: torch.Tensor, idx: torch.Tensor, tables: torch.Tensor,
              n_levels: int) -> torch.Tensor:
    """Truth-table layer: (B, N_in) codes -> (B, N) int32 output codes."""
    dev = codes.device
    codes = codes.to(torch.int32).contiguous()
    idx = idx.to(device=dev, dtype=torch.int32).contiguous()
    tables = tables.to(device=dev, dtype=torch.int32).contiguous()
    for name, t in (("codes", codes), ("idx", idx), ("tables", tables)):
        check_int32(name, t, dev, 2)
    b, n_in = codes.shape
    n, k = idx.shape
    if tables.shape[0] != n or tables.shape[1] != n_levels ** k:
        raise ValueError(f"tables {tuple(tables.shape)} do not match {n} "
                         f"neurons of fanin {k} over {n_levels} levels")
    if dev.type == "cpu":
        return lut_layer_ref(codes, idx, tables, n_levels)
    require_cuda(dev, "lut_layer")
    out = torch.empty((b, n), dtype=torch.int32, device=dev)
    check_int32("out", out, dev, 2)
    if b == 0 or n == 0:
        return out
    if -(-b // TILE_B) > MAX_GRID_Y:
        raise ValueError(f"batch of {b} rows exceeds the kernel's grid")
    err = build.library().lut_layer_launch(
        codes.data_ptr(), idx.data_ptr(), tables.data_ptr(), out.data_ptr(),
        b, n_in, n, k, tables.shape[1], n_levels, stream_of(dev))
    build.check(err, "lut_layer")
    lut_layer.launches += 1
    return out


lut_layer.launches = 0
