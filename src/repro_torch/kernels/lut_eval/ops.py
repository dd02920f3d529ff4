"""Wrappers of the lut_eval kernels (``csrc/lut_eval.cu``).

``lut_eval`` walks the level-stacked ``DevicePlan``; ``lut_eval_streamed``
walks the level-major ``TilePlan``. Each takes int32 tensors (uint32
words as int32 views, as the reference does), checks them, allocates
the plane and launches the kernel on torch's current stream for CUDA
tensors, or runs the plain version (``ref.py``) for CPU tensors. Each
counts its kernel launches in ``.launches`` and keeps the launch it
chose last (word tile, plane in shared memory?, chunk) in
``.last_plan``.
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

MAX_K = 6            # the kernels unroll the fold for k = 1..6
MAX_BLOCK_W = 512    # word columns a block's 256 compute threads cover


def plan_block(n_rows: int, w: int,
               spec: KernelSpec = DEFAULT_SPEC) -> Tuple[int, bool]:
    """(word tile, plane in shared memory?) for an ``n_rows``-row plane
    of ``w`` words: the spec's word tile, narrowed until the block's
    slice of the plane fits the shared-memory budget; if not even one
    column fits, the plane stays in device memory."""
    bw = min(MAX_BLOCK_W, spec.tile.clamp_block_w(w))
    fit = spec.tile.smem_budget_bytes // (4 * max(1, n_rows))
    if fit >= 1:
        return min(bw, fit), True
    return bw, False


def _align4(words: int) -> int:
    return (words + 3) & ~3


def tt_stride(k: int) -> int:
    """Words between two slots' INIT rows in the walks' shared memory
    (2^k plus a 16-byte pad that spreads neighbouring rows over the
    banks)."""
    return 4 if k == 1 else (1 << k) + 4


def walk_smem_bytes(meta_words: int, n_slots: int, k: int, chunk: int,
                    slot_rows: bool, n_rows: int, bw: int,
                    use_smem: bool) -> int:
    """Shared memory of one block of either walk (the kernel's
    ``WalkLayout``): the plan layout's meta, the plan area (the whole
    plan when ``chunk >= n_slots``, else two regions of ``chunk`` slots;
    INIT rows ``tt_stride(k)`` words apart, leaf rows, and each slot's
    output row when ``slot_rows``) and, if ``use_smem``, the block's
    ``n_rows x bw`` plane; each part 16-byte aligned."""
    slots = n_slots if chunk >= n_slots else 2 * chunk
    words = (_align4(meta_words) + slots * tt_stride(k) + _align4(slots * k)
             + (_align4(slots) if slot_rows else 0)
             + (n_rows * bw if use_smem else 0))
    return 4 * words


def streamed_smem_bytes(n_levels: int, n_tiles: int, T: int, k: int,
                        chunk: int, n_rows: int, bw: int,
                        use_smem: bool) -> int:
    """``walk_smem_bytes`` of the streamed walk: level_start and
    out_base as meta, ``chunk`` counted in tiles of T slots."""
    return walk_smem_bytes(n_levels + 1 + n_tiles, n_tiles * T, k,
                           chunk * T, False, n_rows, bw, use_smem)


def stacked_smem_bytes(n_levels: int, lw: int, k: int, chunk: int,
                       n_rows: int, bw: int, use_smem: bool) -> int:
    """``walk_smem_bytes`` of the monolithic walk over a level-stacked
    plan of ``n_levels`` levels of ``lw`` slots: no meta, each slot's
    output row staged beside its leaves."""
    return walk_smem_bytes(0, n_levels * lw, k, chunk, True, n_rows, bw,
                           use_smem)


def _largest_chunk(size, top: int, limit: int) -> int:
    """The most plan units (at least 1, at most ``top``) whose plan area,
    ``size(chunk)`` bytes, fits ``limit``."""
    per_unit = max(1, size(2) - size(1))
    chunk = max(1, min(top, (limit - size(0)) // per_unit))
    while chunk > 1 and size(chunk) > limit:
        chunk -= 1
    while chunk < top and size(chunk + 1) <= limit:
        chunk += 1
    return chunk


def _plan_walk(n_rows: int, w: int, n_units: int, top: int, size,
               spec: KernelSpec, unit: str) -> Tuple[int, bool, int]:
    """(word tile, plane in shared memory?, chunk) of a walk over a plan
    of ``n_units`` units (tiles or slots) whose meta and plan area take
    ``size(chunk)`` bytes, a chunk of at most ``top`` units.

    The whole plan is staged in shared memory (``chunk = n_units``) when
    it fits beside at least one column of the plane; the word tile is
    then narrowed to what is left (``plan_block``). Otherwise the plan
    streams through two regions that take at most half the budget and
    the plane gets the rest. If not one column of the plane fits beside
    the plan, the plane stays in device memory and the plan takes what
    fits of the budget."""
    budget = spec.tile.smem_budget_bytes
    staged = max(1, n_units)
    for chunk in (staged, _largest_chunk(size, min(staged, top),
                                         budget // 2)):
        bw, smem = plan_block(n_rows, w, spec.with_tile(
            smem_budget_bytes=budget - size(chunk)))
        if smem:
            return bw, True, chunk
    bw = min(MAX_BLOCK_W, spec.tile.clamp_block_w(w))
    if size(staged) <= budget:
        return bw, False, staged
    chunk = _largest_chunk(size, min(staged, top), budget)
    if size(chunk) > budget:
        raise ValueError(f"{unit} does not fit {budget} bytes of shared "
                         "memory")
    return bw, False, chunk


@functools.lru_cache(maxsize=256)
def plan_streamed(n_rows: int, w: int, n_levels: int, n_tiles: int, T: int,
                  k: int, spec: KernelSpec = DEFAULT_SPEC
                  ) -> Tuple[int, bool, int]:
    """(word tile, plane in shared memory?, chunk in tiles) of the
    streamed walk (``_plan_walk`` over the plan's tiles)."""
    return _plan_walk(
        n_rows, w, n_tiles, n_tiles,
        lambda c: streamed_smem_bytes(n_levels, n_tiles, T, k, c, 0, 0,
                                      False),
        spec, f"a tile of {T} slots at k={k}")


@functools.lru_cache(maxsize=256)
def plan_stacked(n_rows: int, w: int, n_levels: int, lw: int, k: int,
                 spec: KernelSpec = DEFAULT_SPEC) -> Tuple[int, bool, int]:
    """(word tile, plane in shared memory?, chunk in slots) of the
    monolithic walk over ``n_levels`` levels of ``lw`` slots
    (``_plan_walk`` over its slots): staged whole when it fits beside the
    plane, else streamed level by level, a chunk being at most one
    level."""
    return _plan_walk(
        n_rows, w, n_levels * lw, max(1, lw),
        lambda c: stacked_smem_bytes(n_levels, lw, k, c, 0, 0, False),
        spec, f"a slot at k={k}")


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
    and pad slots must write the dump row with zero masks (as
    ``compile_device_plan`` builds them); ``plan_stacked`` sizes the
    launch. The masks may sit at any 4-byte address: the kernel copies
    them to shared memory as 16-byte copies where aligned, else word by
    word."""
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
    kk = k if n_levels else 1
    bw, use_smem, chunk = plan_stacked(n_wires + 1, w, n_levels, lw, kk,
                                       spec or DEFAULT_SPEC)
    build.launch("lut_eval",
        pi_words.data_ptr(), leaf_idx.data_ptr(), tt_bits.data_ptr(),
        out_wires.data_ptr(), out.data_ptr(), n_pis, n_wires + 1, n_levels,
        lw, kk, w, bw, int(use_smem), chunk, stream_of(dev))
    lut_eval.launches += 1
    lut_eval.last_plan = (bw, use_smem, chunk)
    return out


lut_eval.launches = 0
lut_eval.last_plan = None       # (word tile, plane in shared memory?, chunk)


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
    build.launch("lut_eval_streamed",
        pi_words.data_ptr(), tt_tiles.data_ptr(), leaf_tiles.data_ptr(),
        out_base.data_ptr(), level_start.data_ptr(), out.data_ptr(), n_pis,
        n_rows, n_levels, n_tiles, T, kk, w, bw, int(use_smem), chunk,
        stream_of(dev))
    lut_eval_streamed.launches += 1
    lut_eval_streamed.last_plan = (bw, use_smem, chunk)
    return out


lut_eval_streamed.launches = 0
lut_eval_streamed.last_plan = None
