"""Wrappers of the lut_eval kernels (``csrc/lut_eval.cu``).

``lut_eval`` walks the level-stacked ``DevicePlan``; ``lut_eval_streamed``
walks the level-major ``TilePlan``. Each takes int32 tensors (uint32
words as int32 views, as the reference does), checks them, allocates
the plane and launches the kernel on torch's current stream for CUDA
tensors, or runs the plain version (``ref.py``) for CPU tensors. Each
counts its kernel launches in ``.launches``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import build
from ..common import check_int32, require_cuda, stream_of
from ..spec import DEFAULT_SPEC, KernelSpec
from .ref import lut_eval_ref, lut_eval_streamed_ref

MAX_K = 6     # the kernels unroll the fold for k = 1..6


def plan_block(n_rows: int, w: int,
               spec: KernelSpec = DEFAULT_SPEC) -> Tuple[int, bool]:
    """(word tile, plane in shared memory?) for an ``n_rows``-row plane
    of ``w`` words: the spec's word tile, narrowed until the block's
    slice of the plane fits the shared-memory budget; if not even one
    column fits, the plane stays in device memory."""
    bw = spec.tile.clamp_block_w(w)
    fit = spec.tile.smem_budget_bytes // (4 * max(1, n_rows))
    if fit >= 1:
        return min(bw, fit), True
    return bw, False


def level_starts(level_of_tile: np.ndarray) -> np.ndarray:
    """(n_levels + 1,) int32 first tile of each level (and the end) of
    a level-major ``TilePlan``."""
    n_levels = int(level_of_tile.max()) + 1 if level_of_tile.size else 0
    counts = np.bincount(level_of_tile, minlength=n_levels)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def _check_k(k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"lut_eval kernels take 1 <= k <= {MAX_K}, got {k}")


def lut_eval(pi_words: torch.Tensor, leaf_idx: torch.Tensor,
             tt_bits: torch.Tensor, out_wires: torch.Tensor, n_wires: int,
             spec: Optional[KernelSpec] = None) -> torch.Tensor:
    """Evaluate a level-stacked plan; returns the (n_wires + 1, W) int32
    wire plane (row ``n_wires`` is the pad slots' dump row).

    pi_words (n_pis, W); leaf_idx (n_levels, Lw, k); tt_bits
    (n_levels, Lw, 2^k); out_wires (n_levels, Lw); all int32 and
    contiguous on one device. Leaves must be wires of earlier levels
    (as ``compile_device_plan`` builds them)."""
    dev = pi_words.device
    check_int32("pi_words", pi_words, dev, 2)
    check_int32("leaf_idx", leaf_idx, dev, 3)
    check_int32("tt_bits", tt_bits, dev, 3)
    check_int32("out_wires", out_wires, dev, 2)
    n_levels, lw, k = leaf_idx.shape
    if (tt_bits.shape != (n_levels, lw, 1 << k)
            or out_wires.shape != (n_levels, lw)):
        raise ValueError(f"plan shapes disagree: leaf_idx {tuple(leaf_idx.shape)}"
                         f", tt_bits {tuple(tt_bits.shape)}, out_wires "
                         f"{tuple(out_wires.shape)}")
    n_pis, w = pi_words.shape
    if n_pis >= n_wires + 1:
        raise ValueError(f"{n_pis} inputs do not fit a {n_wires}-wire plane")
    if dev.type == "cpu":
        return lut_eval_ref(pi_words, leaf_idx, tt_bits, out_wires, n_wires)
    require_cuda(dev, "lut_eval")
    if n_levels:
        _check_k(k)
    out = torch.empty((n_wires + 1, w), dtype=torch.int32, device=dev)
    check_int32("plane", out, dev, 2)
    if w == 0:
        return out
    bw, use_smem = plan_block(n_wires + 1, w, spec or DEFAULT_SPEC)
    err = build.library().lut_eval_launch(
        pi_words.data_ptr(), leaf_idx.data_ptr(), tt_bits.data_ptr(),
        out_wires.data_ptr(), out.data_ptr(), n_pis, n_wires + 1, n_levels,
        lw, k if n_levels else 1, w, bw, int(use_smem), stream_of(dev))
    build.check(err, "lut_eval")
    lut_eval.launches += 1
    return out


lut_eval.launches = 0


def lut_eval_streamed(pi_words: torch.Tensor, tt_tiles: torch.Tensor,
                      leaf_tiles: torch.Tensor, out_base: torch.Tensor,
                      level_start: torch.Tensor, n_rows: int,
                      spec: Optional[KernelSpec] = None) -> torch.Tensor:
    """Evaluate a level-major tile plan; returns the renumbered
    (n_rows, W) int32 plane (``TilePlan.out_idx`` / ``row_of_wire``
    pull wires out of it).

    pi_words (n_pis, W); tt_tiles (n_tiles, T, 2^k); leaf_tiles
    (n_tiles, T, k); out_base (n_tiles,); level_start (n_levels + 1,)
    (``level_starts(tplan.level_of_tile)``); all int32 and contiguous
    on one device. The tile geometry T is the plan's;
    ``spec.tile.block_w`` sets the word tile."""
    dev = pi_words.device
    check_int32("pi_words", pi_words, dev, 2)
    check_int32("tt_tiles", tt_tiles, dev, 3)
    check_int32("leaf_tiles", leaf_tiles, dev, 3)
    check_int32("out_base", out_base, dev, 1)
    check_int32("level_start", level_start, dev, 1)
    n_tiles, T, k = leaf_tiles.shape
    if (tt_tiles.shape != (n_tiles, T, 1 << k)
            or out_base.shape != (n_tiles,) or level_start.numel() < 1):
        raise ValueError(f"plan shapes disagree: tt_tiles {tuple(tt_tiles.shape)}"
                         f", leaf_tiles {tuple(leaf_tiles.shape)}, out_base "
                         f"{tuple(out_base.shape)}, level_start "
                         f"{tuple(level_start.shape)}")
    n_pis, w = pi_words.shape
    if n_pis >= n_rows:
        raise ValueError(f"{n_pis} inputs do not fit a {n_rows}-row plane")
    if dev.type == "cpu":
        return lut_eval_streamed_ref(pi_words, tt_tiles, leaf_tiles,
                                     out_base, level_start, n_rows)
    require_cuda(dev, "lut_eval_streamed")
    if n_tiles:
        _check_k(k)
    out = torch.empty((n_rows, w), dtype=torch.int32, device=dev)
    check_int32("plane", out, dev, 2)
    if w == 0:
        return out
    bw, use_smem = plan_block(n_rows, w, spec or DEFAULT_SPEC)
    err = build.library().lut_eval_streamed_launch(
        pi_words.data_ptr(), tt_tiles.data_ptr(), leaf_tiles.data_ptr(),
        out_base.data_ptr(), level_start.data_ptr(), out.data_ptr(), n_pis,
        n_rows, level_start.numel() - 1, T, k if n_tiles else 1, w, bw,
        int(use_smem), stream_of(dev))
    build.check(err, "lut_eval_streamed")
    lut_eval_streamed.launches += 1
    return out


lut_eval_streamed.launches = 0
