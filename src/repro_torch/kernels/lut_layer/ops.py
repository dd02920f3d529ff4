"""Wrapper of the lut_layer kernel (``csrc/lut_layer.cu``).

Casts codes, fanin indices and tables to contiguous int32 (the
reference stores tables as int8/int16), checks shapes and devices, and
launches the kernel on torch's current stream for CUDA tensors or runs
the plain version (``ref.py``) for CPU tensors. Codes must lie in
``[0, n_levels)``: the kernel reads ``tables[j, row]`` unchecked.
``plan_layer`` sizes the kernel's blocks.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from .. import build
from ..common import check_int32, require_cuda, stream_of
from ..spec import DEFAULT_SMEM_BUDGET
from .ref import lut_layer_ref

THREADS = 256              # threads per block, one output each
MAX_TILE_N = 32            # neurons per block: one warp's stores coalesce
# the tables one block stages: 32 KB is eight 16-byte copies per thread,
# all in flight at once; larger tables are split over more neuron tiles
TABLE_TILE_BYTES = 32 * 1024


def _align4(words: int) -> int:
    return (words + 3) & ~3


def layer_smem_bytes(n_tile: int, b_tile: int, n_in: int, k: int,
                     r: int) -> int:
    """Shared memory of one block of the kernel's shared-memory branch:
    ``n_tile`` fanin rows and tables, ``b_tile`` rows of codes, each part
    16-byte aligned."""
    return 4 * (_align4(n_tile * k) + _align4(n_tile * r) + b_tile * n_in)


@functools.lru_cache(maxsize=256)
def plan_layer(b: int, n_in: int, n: int, k: int,
               r: int) -> Tuple[int, int, bool]:
    """(neurons per block, batch rows per block, staged in shared
    memory?) for ``b`` rows of ``n_in`` codes through ``n`` neurons of
    fanin ``k`` and ``r``-entry tables.

    A block takes up to ``MAX_TILE_N`` neurons, fewer when their tables
    pass ``TABLE_TILE_BYTES``, and as many batch rows as give its
    ``THREADS`` threads one output each; both shrink until the block's
    tables and codes fit the 227 KB shared-memory budget. Where not even
    one neuron's table and one row of codes fit, the kernel reads device
    memory, in blocks of up to ``THREADS`` outputs."""
    budget = DEFAULT_SMEM_BUDGET
    if layer_smem_bytes(1, 1, n_in, k, r) > budget:
        n_tile = min(n, THREADS)
        return n_tile, min(b, max(1, THREADS // n_tile)), False
    n_tile = max(1, min(n, MAX_TILE_N, TABLE_TILE_BYTES // (4 * r)))
    while layer_smem_bytes(n_tile, 1, n_in, k, r) > budget:
        n_tile -= 1
    spare = budget - layer_smem_bytes(n_tile, 0, n_in, k, r)
    b_tile = max(1, min(b, THREADS // n_tile, spare // (4 * max(1, n_in))))
    return n_tile, b_tile, True


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
    r = tables.shape[1]
    n_tile, b_tile, in_smem = plan_layer(b, n_in, n, k, r)
    build.launch("lut_layer",
        codes.data_ptr(), idx.data_ptr(), tables.data_ptr(), out.data_ptr(),
        b, n_in, n, k, r, n_levels, n_tile, b_tile, int(in_smem),
        stream_of(dev))
    lut_layer.launches += 1
    return out


lut_layer.launches = 0
