"""Wrappers of the lut_eval kernels (``csrc/lut_eval.cu``).

``lut_eval`` walks the level-stacked ``DevicePlan``; ``lut_eval_streamed``
walks the level-major ``TilePlan``. Each takes int32 tensors (uint32
words as int32 views, as the reference does), checks them, allocates
the plane and launches the kernel on torch's current stream for CUDA
tensors, or runs the plain version (``ref.py``) for CPU tensors. Each
counts its kernel launches in ``.launches``.
"""
from __future__ import annotations

import functools
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


def _align4(words: int) -> int:
    return (words + 3) & ~3


def tt_stride(k: int) -> int:
    """Words between two slots' INIT rows in the streamed walk's shared
    memory (2^k plus a 16-byte pad that spreads neighbouring rows over
    the banks)."""
    return 4 if k == 1 else (1 << k) + 4


def streamed_smem_bytes(n_levels: int, n_tiles: int, T: int, k: int,
                        chunk: int, n_rows: int, bw: int,
                        use_smem: bool) -> int:
    """Shared memory of one block of the streamed walk (the kernel's
    ``StreamLayout``): level_start and out_base, the plan area (the
    whole plan when ``chunk >= n_tiles``, else two regions of ``chunk``
    tiles; INIT rows ``tt_stride(k)`` words apart) and, if ``use_smem``,
    the block's ``n_rows x bw`` plane; each part 16-byte aligned."""
    regions, tiles = (1, n_tiles) if chunk >= n_tiles else (2, chunk)
    words = (_align4(n_levels + 1 + n_tiles)
             + regions * tiles * T * tt_stride(k)
             + _align4(regions * tiles * T * k)
             + (n_rows * bw if use_smem else 0))
    return 4 * words


@functools.lru_cache(maxsize=256)
def plan_streamed(n_rows: int, w: int, n_levels: int, n_tiles: int, T: int,
                  k: int, spec: KernelSpec = DEFAULT_SPEC
                  ) -> Tuple[int, bool, int]:
    """(word tile, plane in shared memory?, chunk) of the streamed walk.

    The whole plan is staged in shared memory (``chunk = n_tiles``) when
    it fits beside at least one column of the plane; the word tile is
    then narrowed to what is left. Otherwise the plan streams through two
    regions that take at most half the budget (``chunk`` tiles each) and
    the plane gets the rest. If not one column of the plane fits beside
    the plan, the plane stays in device memory and the plan takes what
    fits of the budget."""
    budget = spec.tile.smem_budget_bytes
    bw0 = spec.tile.clamp_block_w(w)
    col = 4 * n_rows                     # one word column of the plane

    def size(chunk):                     # the plan area and the meta
        return streamed_smem_bytes(n_levels, n_tiles, T, k, chunk, 0, 0,
                                   False)

    def largest_chunk(limit):
        """The most tiles two regions can hold within ``limit`` bytes
        (at least 1)."""
        per_tile = 8 * T * (tt_stride(k) + k)
        chunk = max(1, min(n_tiles, (limit - size(0)) // per_tile))
        while chunk > 1 and size(chunk) > limit:
            chunk -= 1
        while chunk < n_tiles and size(chunk + 1) <= limit:
            chunk += 1
        return chunk

    staged = max(1, n_tiles)
    if size(staged) + col <= budget:
        return min(bw0, (budget - size(staged)) // col), True, staged
    chunk = largest_chunk(budget // 2)
    if size(chunk) + col <= budget:
        return min(bw0, (budget - size(chunk)) // col), True, chunk
    if size(staged) <= budget:
        return bw0, False, staged
    chunk = largest_chunk(budget)
    if size(chunk) > budget:
        raise ValueError(f"a tile of {T} slots at k={k} does not fit "
                         f"{budget} bytes of shared memory")
    return bw0, False, chunk


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
    if tt_bits.data_ptr() % min(16, 4 << k):
        raise ValueError("tt_bits: the kernel reads each slot's INIT masks "
                         f"as {min(16, 4 << k)}-byte vectors; its data is "
                         "not aligned to that")
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
    ``spec.tile.block_w`` bounds the word tile (``plan_streamed``)."""
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
    n_levels = level_start.numel() - 1
    kk = k if n_tiles else 1
    bw, use_smem, chunk = plan_streamed(n_rows, w, n_levels, n_tiles, T, kk,
                                        spec or DEFAULT_SPEC)
    err = build.library().lut_eval_streamed_launch(
        pi_words.data_ptr(), tt_tiles.data_ptr(), leaf_tiles.data_ptr(),
        out_base.data_ptr(), level_start.data_ptr(), out.data_ptr(), n_pis,
        n_rows, n_levels, n_tiles, T, kk, w, bw, int(use_smem), chunk,
        stream_of(dev))
    build.check(err, "lut_eval_streamed")
    lut_eval_streamed.launches += 1
    return out


lut_eval_streamed.launches = 0
