"""Plain torch versions of the lut_eval kernels.

They repeat the kernels' arithmetic level by level with torch ops, so
they run on any device: the CPU path of the wrappers in ``ops.py``, and
the yardstick the CUDA kernels are held against on the card. Both walk
levels in order, and within a level fold every slot at once; a
levelized plan (every leaf on an earlier level) makes that equal to
the reference's slot-by-slot scan. ``lut_eval_gather_ref`` is the
per-sample path on unpacked bits, the baseline the bitplane fold is
benchmarked against.
"""
from __future__ import annotations

import torch


def tile_fold(tt: torch.Tensor, ins: torch.Tensor) -> torch.Tensor:
    """Shannon-cofactor fold: tt (S, 2^k) INIT masks, ins (S, k, W)
    leaf planes -> (S, W). Leaf k-1 selects first, as in the reference
    ``lut_eval.py::_tile_fold``."""
    w = ins.shape[-1]
    state = tt[:, :, None].expand(-1, -1, w)
    size = tt.shape[1]
    for j in range(ins.shape[1] - 1, -1, -1):
        half = size // 2
        sel = ins[:, j:j + 1, :]
        state = (state[:, :half] & ~sel) | (state[:, half:size] & sel)
        size = half
    return state[:, 0, :]


def _plane(pi_words: torch.Tensor, n_rows: int) -> torch.Tensor:
    plane = torch.zeros((n_rows, pi_words.shape[1]), dtype=torch.int32,
                        device=pi_words.device)
    plane[1: pi_words.shape[0] + 1] = pi_words
    return plane


def lut_eval_ref(pi_words: torch.Tensor, leaf_idx: torch.Tensor,
                 tt_bits: torch.Tensor, out_wires: torch.Tensor,
                 n_wires: int) -> torch.Tensor:
    """Monolithic walk over a level-stacked ``DevicePlan``.

    pi_words (n_pis, W); leaf_idx (n_levels, Lw, k); tt_bits
    (n_levels, Lw, 2^k); out_wires (n_levels, Lw); all int32. Returns
    the (n_wires + 1, W) int32 plane; pad slots write 0 to the dump
    row ``n_wires``."""
    plane = _plane(pi_words, n_wires + 1)
    for lvl in range(leaf_idx.shape[0]):
        plane[out_wires[lvl].long()] = tile_fold(
            tt_bits[lvl], plane[leaf_idx[lvl].long()])
    return plane


def lut_eval_streamed_ref(pi_words: torch.Tensor, tt_tiles: torch.Tensor,
                          leaf_tiles: torch.Tensor, out_base: torch.Tensor,
                          level_start: torch.Tensor,
                          n_rows: int) -> torch.Tensor:
    """Streamed walk over a level-major ``TilePlan``.

    pi_words (n_pis, W); tt_tiles (n_tiles, T, 2^k); leaf_tiles
    (n_tiles, T, k); out_base (n_tiles,); level_start (n_levels + 1,)
    first tile of each level; all int32. Returns the (n_rows, W) int32
    plane: tile t writes rows out_base[t] .. out_base[t] + T - 1."""
    plane = _plane(pi_words, n_rows)
    _, T, n_tt = tt_tiles.shape
    k = leaf_tiles.shape[2]
    slot = torch.arange(T, device=pi_words.device)
    starts = level_start.tolist()
    for a, b in zip(starts[:-1], starts[1:]):
        rows = (out_base[a:b, None].long() + slot).reshape(-1)
        leaves = leaf_tiles[a:b].reshape(-1, k).long()
        plane[rows] = tile_fold(tt_tiles[a:b].reshape(-1, n_tt),
                                plane[leaves])
    return plane


def lut_eval_gather_ref(pi_bits: torch.Tensor, leaf_idx: torch.Tensor,
                        tt01: torch.Tensor, out_wires: torch.Tensor,
                        n_pis: int, n_wires: int) -> torch.Tensor:
    """Per-sample gather evaluation on unpacked bits.

    pi_bits (n_pis, B) int32 {0, 1}; leaf_idx (n_levels, Lw, k);
    tt01 (n_levels, Lw, 2^k) int32 {0, 1} truth-table bits; out_wires
    (n_levels, Lw). Per level every slot builds its select index from
    its gathered leaf bits and looks its output bit up in its table.
    Returns the (n_wires + 1, B) int32 bit plane."""
    k = leaf_idx.shape[-1]
    bits = torch.zeros((n_wires + 1, pi_bits.shape[1]), dtype=torch.int32,
                       device=pi_bits.device)
    bits[1: n_pis + 1] = pi_bits
    for lvl in range(leaf_idx.shape[0]):
        leaves = leaf_idx[lvl].long()
        sel = bits[leaves[:, 0]]
        for j in range(1, k):
            sel = sel | (bits[leaves[:, j]] << j)
        bits[out_wires[lvl].long()] = torch.gather(tt01[lvl], 1, sel.long())
    return bits
