"""Bit-parallel AIG simulation on the card.

Two routes, as in the reference package:

  * ``aig_sim_walk`` — the wrapper of the walk kernel
    (``csrc/aig_sim.cu``, the reference's ``aig_sim_pallas``; sweeps
    over all nodes at once until the plane stops changing, finished in
    node order after ``max_sweeps``, in blocks of a few word columns
    sized by ``plan_walk``): int32 tensors in, the whole value plane
    out, the plain version (``ref.py``) for CPU tensors; it counts its
    launches in ``.launches``.
  * ``aig_sim`` — the public route: an AND gate is a k=2 LUT whose
    4-entry INIT masks ``tt[a + 2b] = (a ^ c0) & (b ^ c1)`` encode both
    edge complements, so the AIG is levelized and tiled into a
    ``TilePlan`` (``compile_aig_tile_plan``) and runs through the
    streamed ``lut_eval`` kernel; the plane is pulled back into node
    order. The plan is pure netlist structure and is cached by a SHA-1
    of the literals, with its tensors per device, so repeated
    simulation of one AIG pays the levelize + tile cost once.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ...device import DeviceLike, resolve_device
from .. import build
from ..common import check_int32, require_cuda, stream_of
from ..spec import DEFAULT_SPEC, KernelSpec
from .ref import aig_sim_ref

_PLAN_CACHE: Dict[str, "_CachedPlan"] = {}
_PLAN_CACHE_MAX = 64
MIN_BLOCKS = 128           # blocks a launch aims for (132 SMs)
WORD_TILES = (4, 2, 1)     # word columns per block the kernel takes
MAX_THREADS = 1024


def block_threads(n_ands: int) -> int:
    """Threads of a block of the walk: one per AND node, in whole warps,
    at most ``MAX_THREADS``."""
    return min(MAX_THREADS, max(32, -(-n_ands // 32) * 32))


def walk_smem_bytes(n_pis: int, n_ands: int, tw: int) -> int:
    """Dynamic shared memory of one block of the walk with its planes in
    shared memory: two planes of the block's ``tw`` columns, and the
    literals of the nodes past the block's first ``block_threads``
    (each thread keeps its first node's in registers)."""
    staged = max(0, n_ands - block_threads(n_ands))
    return 4 * (2 * (1 + n_pis + n_ands) * tw + 2 * staged)


def max_sweeps(n_ands: int) -> int:
    """Sweeps a block of the walk runs before it finishes by walking the
    nodes in order, one thread, in place (the kernel's rule): a sweep
    costs about as much as 16 nodes of that walk, so an AIG whose values
    keep changing down a long chain takes about twice the ordered walk
    at most."""
    return 16 + n_ands // 16


def plan_walk(n_pis: int, n_ands: int, w: int) -> Tuple[int, bool]:
    """(word columns per block, planes in shared memory?) of the walk on
    a ``w``-word plane.

    The word tile is the widest of 4 / 2 / 1 that still gives
    ``MIN_BLOCKS`` blocks (1 when W is too narrow for that). The two
    planes the sweeps alternate between stay in shared memory, with the
    literals, at the widest tile up to that one where they fit the
    budget; otherwise they are the output and a scratch plane in device
    memory, at the first tile."""
    budget = DEFAULT_SPEC.tile.smem_budget_bytes
    tw = next(t for t in WORD_TILES if t == 1 or -(-w // t) >= MIN_BLOCKS)
    for t in WORD_TILES[WORD_TILES.index(tw):]:
        if walk_smem_bytes(n_pis, n_ands, t) <= budget:
            return t, True
    return tw, False


def aig_sim_walk(pi_words: torch.Tensor, f0: torch.Tensor,
                 f1: torch.Tensor) -> torch.Tensor:
    """pi_words (n_pis, W) int32 packed samples; f0 / f1 (n_ands,) int32
    fanin literals, each naming an earlier node (a literal of the node
    itself or a later one reads 0, as in the reference; past the plane
    unchecked). Returns the (1 + n_pis + n_ands, W) int32 value plane:
    row 0 const-0, rows 1..n_pis the inputs, then the AND nodes;
    ``plan_walk`` sizes the launch."""
    dev = pi_words.device
    check_int32("pi_words", pi_words, dev, 2)
    check_int32("f0", f0, dev, 1)
    check_int32("f1", f1, dev, 1)
    n_pis, w = pi_words.shape
    n_ands = f0.shape[0]
    if f1.shape[0] != n_ands:
        raise ValueError(f"f0 has {n_ands} literals, f1 {f1.shape[0]}")
    if dev.type == "cpu":
        return aig_sim_ref(pi_words, f0, f1, n_pis)
    require_cuda(dev, "aig_sim")
    out = torch.empty((1 + n_pis + n_ands, w), dtype=torch.int32,
                      device=dev)
    check_int32("plane", out, dev, 2)
    if w == 0:
        return out
    tw, smem_plane = plan_walk(n_pis, n_ands, w)
    scratch = None if smem_plane else torch.empty_like(out)
    build.launch("aig_sim",
        pi_words.data_ptr(), f0.data_ptr(), f1.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), n_pis, n_ands, w,
        tw, stream_of(dev))
    aig_sim_walk.launches += 1
    return out


aig_sim_walk.launches = 0


def compile_aig_tile_plan(f0: np.ndarray, f1: np.ndarray, n_pis: int,
                          tile_rows: int = 32):
    """Levelize an AIG and tile it as k=2 LUT slots for the streamed
    kernel. Returns a ``repro_torch.synth.executor.TilePlan`` whose
    ``row_of_wire`` maps node ids to streamed plane rows."""
    from repro_torch.synth.executor import (_LevelArrays, _Plan,
                                            compile_tile_plan)

    f0 = np.asarray(f0, np.int64)
    f1 = np.asarray(f1, np.int64)
    n_ands = f0.shape[0]
    v0, c0 = f0 >> 1, (f0 & 1)
    v1, c1 = f1 >> 1, (f1 & 1)
    # levelize: nodes are topologically ordered, fanins point earlier
    lvl = np.zeros(1 + n_pis + n_ands, np.int32)
    for i in range(n_ands):
        lvl[1 + n_pis + i] = max(lvl[v0[i]], lvl[v1[i]]) + 1
    node_lvl = lvl[1 + n_pis:]
    # 4-entry INIT masks: index r = a + 2b over the two fanin values
    r = np.arange(4)
    onset = (((r & 1)[None] ^ c0[:, None])
             & (((r >> 1) & 1)[None] ^ c1[:, None]))
    tt_all = (onset * np.uint32(0xFFFFFFFF)).astype(np.uint32)
    leaves_all = np.stack([v0, v1], axis=1).astype(np.int32)
    levels = []
    for level in range(1, (int(node_lvl.max()) if n_ands else 0) + 1):
        idx = np.nonzero(node_lvl == level)[0]
        levels.append(_LevelArrays(leaves_all[idx], tt_all[idx],
                                   (1 + n_pis + idx).astype(np.int32)))
    plan = _Plan(levels, np.zeros((0,), np.int32), np.zeros((0,), bool))
    return compile_tile_plan(plan, n_pis, 2, tile_rows)


class _CachedPlan:
    """A tile plan and its kernel tensors, made once per device."""

    def __init__(self, tplan):
        from ..lut_eval import level_starts
        self.tplan = tplan
        self._arrays = (tplan.tt_tiles.view(np.int32), tplan.leaf_tiles,
                        tplan.out_base, level_starts(tplan.level_of_tile))
        self._tensors: Dict[torch.device, tuple] = {}

    def tensors(self, device: torch.device):
        """(tt_tiles, leaf_tiles, out_base, level_start) int32 and
        row_of_wire int64, on ``device``."""
        hit = self._tensors.get(device)
        if hit is None:
            hit = self._tensors[device] = tuple(
                torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                device=device) for a in self._arrays) + (
                torch.as_tensor(self.tplan.row_of_wire.astype(np.int64),
                                device=device),)
        return hit


def _cached_plan(f0: np.ndarray, f1: np.ndarray, n_pis: int,
                 tile_rows: int) -> _CachedPlan:
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(f0, np.int32).tobytes())
    h.update(np.ascontiguousarray(f1, np.int32).tobytes())
    h.update(f"{n_pis},{tile_rows}".encode())
    key = h.hexdigest()
    hit = _PLAN_CACHE.get(key)
    if hit is None:
        if len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:
            _PLAN_CACHE.clear()
        hit = _PLAN_CACHE[key] = _CachedPlan(
            compile_aig_tile_plan(f0, f1, n_pis, tile_rows))
    return hit


def aig_sim(pi_words: np.ndarray, f0: np.ndarray, f1: np.ndarray,
            n_pis: int, device: DeviceLike = None,
            spec: Optional[KernelSpec] = None) -> np.ndarray:
    """Simulate an AIG on packed words; returns the (n_nodes, W) uint32
    value plane (the layout of ``repro_torch.synth.simulate``).

    pi_words (n_pis, W) uint32; f0 / f1 (n_ands,) int32 fanin literals.
    Runs on the card unless ``device="cpu"``, where the streamed
    kernel's plain version runs."""
    from ..lut_eval import lut_eval_streamed

    dev = resolve_device(device)
    spec = DEFAULT_SPEC if spec is None else spec
    pi_words = np.ascontiguousarray(pi_words, np.uint32)
    n_ands = int(np.asarray(f0).shape[0])
    w = pi_words.shape[1]
    if n_ands == 0 or n_pis == 0 or w == 0:
        vals = np.zeros((1 + n_pis + n_ands, w), np.uint32)
        vals[1: n_pis + 1] = pi_words
        return vals
    cached = _cached_plan(f0, f1, n_pis, spec.tile.tile_rows)
    tt, leaves, out_base, level_start, row_of_wire = cached.tensors(dev)
    words = torch.as_tensor(pi_words.view(np.int32), device=dev)
    plane = lut_eval_streamed(words, tt, leaves, out_base, level_start,
                              n_rows=cached.tplan.n_rows, spec=spec)
    return plane[row_of_wire].cpu().numpy().view(np.uint32)
