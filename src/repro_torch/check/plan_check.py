"""Pass 3 — static validation of ``DevicePlan`` tensors before launch.

``compile_device_plan`` output is what the ``lut_eval`` CUDA walks
trust blindly: wire indices become unchecked shared- or device-memory
loads and stores, INIT masks become the Shannon fold, and the dump-row
convention turns padded slots into silent no-ops. A malformed plan
therefore fails *on the card* (a read or write of memory the plane
does not own, or a silently corrupted wire plane), so every contract
is checked here on the host first:

  * shape/dtype contracts of all six tensors;
  * leaf indices in [0, n_wires) — a leaf must never read the dump row;
  * every real wire written exactly once, only by its own level, and
    read only by strictly later levels (levelization);
  * no-op (padded) slots fully inert: const-wire leaves, all-zero INIT,
    dump-row output;
  * INIT masks restricted to the {0, 0xFFFFFFFF} bitplane encoding;
  * output gather indices/complements in range;
  * the walks' shared memory at the serving batch's word count: the
    launch ``plan_stacked`` (monolithic walk) and, with ``tiles``
    attached, ``plan_streamed`` (streamed walk) choose within the
    budget, exactly as the wrappers choose it. The only error is what
    a wrapper itself refuses (a plan unit that does not fit the
    budget); the branch each walk takes (plane in shared or device
    memory, the plan staged whole or streamed in chunks) goes in
    ``info``. A plane too large for shared memory is no error: the walk
    then keeps it in device memory.

Results are cached by a content hash of the plan so the serving hot
path (which validates on every ``--check`` preflight) pays the cost
once per distinct netlist version.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Optional

import numpy as np

from repro_torch.kernels.lut_eval.ops import (plan_stacked, plan_streamed,
                                              stacked_smem_bytes,
                                              streamed_smem_bytes)
from repro_torch.kernels.spec import DEFAULT_BLOCK_W, DEFAULT_SPEC
from repro_torch.synth.executor import DevicePlan

from .report import CheckReport

PASS = "plan"

# the shared memory one thread block may use (227 KB of an H100 SM's 256)
DEFAULT_SMEM_BUDGET = DEFAULT_SPEC.tile.smem_budget_bytes
# packed words of a serving batch: LogicEngine's 256 rows, 32 a word
SERVE_WORDS = 8

_FULL = np.uint32(0xFFFFFFFF)

_CACHE: Dict[str, CheckReport] = {}


def plan_fingerprint(dplan: DevicePlan) -> str:
    """Content hash over every tensor and scalar the kernel consumes."""
    h = hashlib.sha1()
    for arr in (dplan.leaf_idx, dplan.tt_bits, dplan.out_wires,
                dplan.out_idx, dplan.out_neg):
        a = np.ascontiguousarray(arr)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    h.update(f"{dplan.n_pis},{dplan.n_wires},{dplan.k}".encode())
    return h.hexdigest()


def _walk_spec(smem_budget_bytes: int, block_w: int):
    return DEFAULT_SPEC.with_tile(smem_budget_bytes=smem_budget_bytes,
                                  block_w=block_w)


def _branch(launch, n_units: int, smem_bytes: int) -> Dict[str, object]:
    bw, use_smem, chunk = launch
    return {"block_w": bw, "plane": "shared" if use_smem else "device",
            "chunk": chunk,
            "plan": "staged" if chunk >= max(1, n_units) else "streamed",
            "smem_bytes": smem_bytes}


def estimate_smem_bytes(dplan: DevicePlan, n_words: int = SERVE_WORDS,
                        block_w: int = DEFAULT_BLOCK_W,
                        smem_budget_bytes: int = DEFAULT_SMEM_BUDGET
                        ) -> Dict[str, object]:
    """The monolithic walk's launch over ``dplan`` at ``n_words`` packed
    words: ``plan_stacked``'s word tile, plane placement and chunk (as
    ``lut_eval`` computes them) and the block's shared memory
    (``stacked_smem_bytes``). Raises ``ValueError`` where the wrapper
    would (one slot does not fit the budget)."""
    n_levels, lw, k = dplan.leaf_idx.shape
    kk = k if n_levels else 1
    n_rows = dplan.n_wires + 1
    launch = plan_stacked(n_rows, n_words, n_levels, lw, kk,
                          _walk_spec(smem_budget_bytes, block_w))
    bw, use_smem, chunk = launch
    return _branch(launch, n_levels * lw, stacked_smem_bytes(
        n_levels, lw, kk, chunk, n_rows, bw, use_smem))


def estimate_tile_smem_bytes(tplan, n_words: int = SERVE_WORDS,
                             block_w: int = DEFAULT_BLOCK_W,
                             smem_budget_bytes: int = DEFAULT_SMEM_BUDGET
                             ) -> Dict[str, object]:
    """The streamed walk's launch over a ``TilePlan`` at ``n_words``
    packed words (``plan_streamed``, as ``lut_eval_streamed`` computes
    it) and the block's shared memory (``streamed_smem_bytes``). Raises
    ``ValueError`` where the wrapper would (one tile of ``tile_rows``
    slots does not fit the budget)."""
    n_tiles, T = tplan.n_tiles, tplan.tile_rows
    kk = tplan.k if n_tiles else 1
    n_levels = tplan.n_levels
    launch = plan_streamed(tplan.n_rows, n_words, n_levels, n_tiles, T, kk,
                           _walk_spec(smem_budget_bytes, block_w))
    bw, use_smem, chunk = launch
    return _branch(launch, n_tiles, streamed_smem_bytes(
        n_levels, n_tiles, T, kk, chunk, tplan.n_rows, bw, use_smem))


def validate_device_plan(dplan: DevicePlan,
                         smem_budget_bytes: Optional[int]
                         = DEFAULT_SMEM_BUDGET,
                         block_w: int = DEFAULT_BLOCK_W,
                         use_cache: bool = True,
                         name: str = "device-plan") -> CheckReport:
    """Static checks on a compiled ``DevicePlan``; cached by plan hash.
    The shared-memory footprint is reckoned at the serving batch's
    ``SERVE_WORDS`` packed words, ``block_w`` words a block at most,
    against ``smem_budget_bytes`` (``None``: not reckoned)."""
    tp = getattr(dplan, "tiles", None)
    key = None
    if use_cache:
        tile_key = (tp.tile_rows, tp.gather_cap) if tp is not None else None
        key = (plan_fingerprint(dplan), smem_budget_bytes, block_w,
               tile_key)
        hit = _CACHE.get(key)
        if hit is not None:
            return hit
    rep = _validate(dplan, smem_budget_bytes, block_w, name)
    if use_cache:
        _CACHE[key] = rep
    return rep


def _validate(dplan: DevicePlan, smem_budget_bytes: Optional[int],
              block_w: int, name: str) -> CheckReport:
    rep = CheckReport(name)
    li, tt, ow = dplan.leaf_idx, dplan.tt_bits, dplan.out_wires
    oi, on = dplan.out_idx, dplan.out_neg
    nw, k, n_pis = dplan.n_wires, dplan.k, dplan.n_pis

    # ---- dtype / shape contracts ----
    rep.checked += 1
    for aname, arr, dt in (("leaf_idx", li, np.int32),
                           ("tt_bits", tt, np.uint32),
                           ("out_wires", ow, np.int32),
                           ("out_idx", oi, np.int32)):
        if arr.dtype != dt:
            rep.error(PASS, "dtype",
                      f"{aname} dtype {arr.dtype} != {np.dtype(dt)}",
                      where=aname)
    if on.dtype != np.bool_:
        rep.error(PASS, "dtype", f"out_neg dtype {on.dtype} != bool",
                  where="out_neg")
    if li.ndim != 3:
        rep.error(PASS, "shape", f"leaf_idx rank {li.ndim} != 3",
                  where="leaf_idx")
        return rep
    n_levels, lw, kk = li.shape
    rep.checked += 1
    if kk != k:
        rep.error(PASS, "shape",
                  f"leaf_idx last dim {kk} != k={k}", where="leaf_idx")
    if tt.shape != (n_levels, lw, 1 << k):
        rep.error(PASS, "shape",
                  f"tt_bits shape {tt.shape} != "
                  f"{(n_levels, lw, 1 << k)} (INIT width 2^k)",
                  where="tt_bits")
        return rep
    if ow.shape != (n_levels, lw):
        rep.error(PASS, "shape",
                  f"out_wires shape {ow.shape} != {(n_levels, lw)}",
                  where="out_wires")
        return rep
    if oi.shape != on.shape or oi.ndim != 1:
        rep.error(PASS, "shape",
                  f"out_idx {oi.shape} / out_neg {on.shape} must be "
                  f"equal rank-1 shapes")
        return rep
    n_luts = nw - 1 - n_pis
    rep.checked += 1
    if n_luts < 0:
        rep.error(PASS, "wire-count",
                  f"n_wires {nw} < 1 + n_pis {n_pis}")
        return rep

    # ---- INIT masks: bitplane {0, ~0} encoding only ----
    rep.checked += 1
    bad_tt = (tt != 0) & (tt != _FULL)
    if bad_tt.any():
        lvl, s, r = (int(x[0]) for x in np.nonzero(bad_tt))
        rep.error(PASS, "tt-encoding",
                  f"tt_bits[{lvl},{s},{r}] = {tt[lvl, s, r]:#x} is "
                  f"neither 0 nor 0xFFFFFFFF (bitplane mask encoding)",
                  where=f"level {lvl} slot {s}")

    # ---- leaf reads: in range, never the dump row, only earlier levels
    rep.checked += 1
    if li.size and (li.min() < 0 or li.max() >= nw):
        lvl, s, j = (int(x[0]) for x in
                     np.nonzero((li < 0) | (li >= nw)))
        rep.error(PASS, "leaf-range",
                  f"leaf_idx[{lvl},{s},{j}] = {li[lvl, s, j]} outside "
                  f"[0, {nw}) — reading the dump row or beyond",
                  where=f"level {lvl} slot {s}")

    # ---- output wires: pad slots use the dump row; real slots cover
    # every LUT wire exactly once at a consistent level ----
    pad = ow == nw
    rep.checked += 1
    if ow.size and ((ow < n_pis + 1) | (ow > nw)).any():
        lvl, s = (int(x[0]) for x in
                  np.nonzero((ow < n_pis + 1) | (ow > nw)))
        rep.error(PASS, "out-range",
                  f"out_wires[{lvl},{s}] = {ow[lvl, s]} outside the LUT "
                  f"wire range [{n_pis + 1}, {nw}]",
                  where=f"level {lvl} slot {s}")
        return rep
    real = ow[~pad]
    rep.checked += 1
    if real.size != n_luts or (real.size and
                               not np.array_equal(
                                   np.sort(real),
                                   np.arange(n_pis + 1, nw))):
        counts = np.bincount(real - (n_pis + 1), minlength=max(n_luts, 0)) \
            if real.size else np.zeros(max(n_luts, 0), np.int64)
        dup = np.nonzero(counts > 1)[0]
        missing = np.nonzero(counts == 0)[0]
        detail = []
        if dup.size:
            detail.append(f"wire {dup[0] + n_pis + 1} written "
                          f"{counts[dup[0]]}x")
        if missing.size:
            detail.append(f"wire {missing[0] + n_pis + 1} never written")
        rep.error(PASS, "wire-cover",
                  f"real slots write {real.size} wires but the plan "
                  f"declares {n_luts} LUTs"
                  + (f" ({'; '.join(detail)})" if detail else ""))

    # level of each wire (PIs/const = level 0; LUT wires = writing level+1)
    wire_level = np.zeros(nw + 1, np.int64)
    for lvl in range(n_levels):
        w = ow[lvl][~pad[lvl]]
        wire_level[w] = lvl + 1
    rep.checked += 1
    for lvl in range(n_levels):
        leaves = li[lvl][~pad[lvl]]          # (slots, k)
        if leaves.size and (wire_level[leaves] > lvl).any():
            s, j = (int(x[0]) for x in
                    np.nonzero(wire_level[leaves] > lvl))
            rep.error(PASS, "level-order",
                      f"level {lvl} reads wire {leaves[s, j]} which is "
                      f"written at level {wire_level[leaves[s, j]] - 1} "
                      f"(same level or later)",
                      where=f"level {lvl}")
            break

    # ---- no-op slot consistency ----
    rep.checked += 1
    for lvl in range(n_levels):
        p = pad[lvl]
        if not p.any():
            continue
        if li[lvl][p].any():
            s = int(np.nonzero(p)[0][np.nonzero(li[lvl][p].any(axis=1))
                                     [0][0]])
            rep.error(PASS, "pad-slot",
                      f"padded slot ({lvl},{s}) reads wire "
                      f"{int(li[lvl, s].max())} instead of the constant "
                      f"wire", where=f"level {lvl} slot {s}")
            break
        if tt[lvl][p].any():
            s = int(np.nonzero(p)[0][np.nonzero(tt[lvl][p].any(axis=1))
                                     [0][0]])
            rep.error(PASS, "pad-slot",
                      f"padded slot ({lvl},{s}) has nonzero INIT masks "
                      f"— it would write garbage to the dump row",
                      where=f"level {lvl} slot {s}")
            break

    # ---- output gather ----
    rep.checked += 1
    if oi.size and ((oi < 0) | (oi >= nw)).any():
        i = int(np.nonzero((oi < 0) | (oi >= nw))[0][0])
        rep.error(PASS, "out-idx",
                  f"out_idx[{i}] = {oi[i]} outside [0, {nw})",
                  where=f"output {i}")

    # ---- tile schedule consistency (streamed kernel) ----
    tp = getattr(dplan, "tiles", None)
    if tp is not None:
        rep.checked += 1
        staged = tp.gather_rows[
            np.arange(tp.n_tiles)[:, None, None], tp.leaf_loc]
        if not np.array_equal(staged, tp.leaf_tiles):
            t, s, j = (int(x[0]) for x in
                       np.nonzero(staged != tp.leaf_tiles))
            rep.error(PASS, "tile-gather",
                      f"gather_rows[{t}][leaf_loc[{t},{s},{j}]] = "
                      f"{staged[t, s, j]} != leaf_tiles[{t},{s},{j}] = "
                      f"{tp.leaf_tiles[t, s, j]} — the staged-DMA remap "
                      f"disagrees with the direct leaf rows",
                      where=f"tile {t} slot {s}")
        rep.checked += 1
        bad = tp.leaf_tiles >= tp.out_base[:, None, None]
        if bad.any():
            t, s, j = (int(x[0]) for x in np.nonzero(bad))
            rep.error(PASS, "tile-order",
                      f"tile {t} (band starts at row {tp.out_base[t]}) "
                      f"reads row {tp.leaf_tiles[t, s, j]} from its own "
                      f"or a later band — streamed tile order would "
                      f"read unwritten rows", where=f"tile {t} slot {s}")

    # ---- shared-memory footprint ----
    # Each walk stages what fits of its plan and plane in one block's
    # shared memory and leaves the rest in device memory; the wrapper
    # refuses only a plan unit (one slot, or one tile) that does not fit.
    rep.info["n_levels"] = n_levels
    rep.info["level_width"] = lw
    rep.checked += 1
    if smem_budget_bytes is None:
        return rep
    walks = [("lut_eval", lambda: estimate_smem_bytes(
        dplan, SERVE_WORDS, block_w, smem_budget_bytes))]
    if tp is not None:
        rep.info["tile_rows"] = tp.tile_rows
        rep.info["n_tiles"] = tp.n_tiles
        walks.append(("lut_eval_streamed", lambda: estimate_tile_smem_bytes(
            tp, SERVE_WORDS, block_w, smem_budget_bytes)))
    for walk, estimate in walks:
        try:
            branch = estimate()
        except ValueError as e:
            rep.error(PASS, "smem-budget",
                      f"{walk} refuses the plan at {SERVE_WORDS} words: {e} "
                      f"(budget {smem_budget_bytes} bytes)", where=walk)
            continue
        rep.info[walk] = branch
        rep.info["smem_bytes"] = branch["smem_bytes"]
    return rep
