"""Mapped-netlist execution on packed bitplanes.

The mapped 6-LUT network is the serving representation: instead of one
table gather per neuron (``repro_torch.core.logic_infer``), inference
packs 32 samples per 32-bit lane and evaluates each LUT *level* as
bitwise ops — a Shannon-cofactor fold of every LUT's 64-entry INIT
vector over its six input planes.

Execution engines are pluggable: ``BitplaneNetwork(engine=...)`` looks
the name up in the ``repro_torch.synth.executors`` registry. Built-ins
(reference name in brackets):

  * ``engine="numpy"``         — the host fold below (``execute_packed``);
  * ``engine="cuda"``          [``"pallas"``] — ``compile_device_plan``
    stacks the levelized netlist into plan tensors on the device and
    the monolithic ``lut_eval`` kernel walks every level in one launch;
  * ``engine="cuda-streamed"`` [``"pallas-streamed"``] —
    ``compile_tile_plan`` renumbers the wire plane level-major and the
    streamed ``lut_eval_streamed`` kernel walks its tiles.

``execute_packed_cuda`` / ``execute_packed_streamed`` [reference
``execute_packed_pallas`` / ``execute_packed_streamed``] run the host
fold's words-in, words-out contract through each walk.

All engines are bit-identical on every reachable input. ``emit_verilog``
writes the mapped netlist as structural Verilog. The device
engines quantize, pack, evaluate, complement, decode and take the
per-request argmax on the engine's device, so only the labels come
back to the host. On ``device="cpu"`` the device engines run the
kernels' plain torch versions.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.common import words_to_int32
from repro_torch.kernels.spec import DEFAULT_SPEC, DEFAULT_TILE_ROWS

from .aig import lit_compl, lit_var, tt_expand
from .lutmap import MappedNetwork
from .simulate import WORD_BITS, pack_bits, unpack_bits

# wire numbering for execution:
#   wire 0            = constant 0
#   wires 1..n_pis    = primary inputs
#   wires n_pis+1+i   = output of LUT i
_CONST_WIRE = 0



@dataclasses.dataclass
class _LevelArrays:
    leaf_idx: np.ndarray     # (L, k) int32 wire indices (const-padded)
    tt_bits: np.ndarray      # (L, 2^k) uint32 0 / 0xFFFFFFFF masks
    out_wires: np.ndarray    # (L,) int32 wire index written


@dataclasses.dataclass
class _Plan:
    """Precompiled execution plan — everything per-call execution needs
    that does not depend on the batch (built once, reused per batch)."""
    levels: List[_LevelArrays]
    out_idx: np.ndarray      # (n_outputs,) int32 wire index per output
    out_neg: np.ndarray      # (n_outputs,) bool complement flags


def _wire_of(mapped: MappedNetwork, node: int, lut_pos: dict) -> int:
    if node == 0:
        return _CONST_WIRE
    if node <= mapped.n_pis:
        return node
    return mapped.n_pis + 1 + lut_pos[node]


def _compile_plan(mapped: MappedNetwork) -> _Plan:
    k = mapped.k
    lut_pos = {l.root: i for i, l in enumerate(mapped.luts)}
    lvl = mapped.levels()
    by_level: dict = {}
    for i, l in enumerate(mapped.luts):
        by_level.setdefault(lvl[l.root], []).append(i)
    levels: List[_LevelArrays] = []
    for level in sorted(by_level):
        idxs = by_level[level]
        leaf_idx = np.zeros((len(idxs), k), np.int32)
        tt_bits = np.zeros((len(idxs), 1 << k), np.uint32)
        out_wires = np.zeros((len(idxs),), np.int32)
        for row, i in enumerate(idxs):
            l = mapped.luts[i]
            m = len(l.leaves)
            for j, x in enumerate(l.leaves):
                leaf_idx[row, j] = _wire_of(mapped, x, lut_pos)
            tt = tt_expand(l.tt, m, k)     # pad slots read the const wire
            for r in range(1 << k):
                if (tt >> r) & 1:
                    tt_bits[row, r] = 0xFFFFFFFF
            out_wires[row] = mapped.n_pis + 1 + i
        levels.append(_LevelArrays(leaf_idx, tt_bits, out_wires))
    out_idx = np.array([_wire_of(mapped, lit_var(o), lut_pos)
                        for o in mapped.outputs], np.int32)
    out_neg = np.array([bool(lit_compl(o)) for o in mapped.outputs], bool)
    return _Plan(levels, out_idx, out_neg)


def execute_packed(mapped: MappedNetwork, pi_words: np.ndarray,
                   plan: Optional[_Plan] = None) -> np.ndarray:
    """pi_words: (n_pis, W) uint32 -> output words (n_outputs, W)."""
    pi_words = np.asarray(pi_words, np.uint32)
    assert pi_words.shape[0] == mapped.n_pis
    w = pi_words.shape[1]
    if plan is None:
        plan = _compile_plan(mapped)
    wires = np.zeros((mapped.n_pis + 1 + mapped.n_luts, w), np.uint32)
    wires[1: mapped.n_pis + 1] = pi_words
    for la in plan.levels:
        ins = wires[la.leaf_idx]                       # (L, k, W)
        state = np.broadcast_to(
            la.tt_bits[:, :, None], la.tt_bits.shape + (w,)).copy()
        half = state.shape[1] // 2
        for j in range(la.leaf_idx.shape[1] - 1, -1, -1):
            sel = ins[:, j:j + 1, :]                   # (L, 1, W)
            state = (state[:, :half] & ~sel) | (state[:, half:] & sel)
            half //= 2
        wires[la.out_wires] = state[:, 0, :]
    out = wires[plan.out_idx]
    out[plan.out_neg] = ~out[plan.out_neg]
    return out


# ---------------------------------------------------------------------------
# Tile plan: level-major renumbering + slot tiling for the streamed kernel
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TilePlan:
    """The mapped netlist as a streamed tile schedule.

    Wires are renumbered *level-major*: row 0 stays the constant-0
    plane, rows 1..n_pis the primary inputs, then each LUT level
    occupies one contiguous band of rows, padded up to a multiple of
    ``tile_rows`` so every tile writes exactly one contiguous band of
    ``tile_rows`` rows (``out_base[t]`` is its first row). Pad slots
    read the constant row with all-zero INIT masks and therefore write
    0 to their own (never-read) pad row — no per-slot validity branch
    and no dump row.

    ``leaf_tiles`` holds plane-row leaf indices, which is all the CUDA
    kernel reads; ``gather_rows``/``leaf_loc`` are the reference TPU
    kernel's staged-DMA remap, kept only so the plan tensors stay
    identical to the reference's: ``gather_rows[t]`` lists the tile's unique
    leaf rows (padded by re-reading row 0) and
    ``leaf_loc[t, s, j]`` is slot ``s``'s position of leaf ``j`` inside
    that staged buffer. ``row_of_wire`` maps the original executor wire
    numbering (const/PIs/LUT outputs) to renumbered plane rows, so
    callers can pull any original wire out of the streamed plane.
    """

    tt_tiles: np.ndarray     # (n_tiles, T, 2^k) uint32 INIT masks
    leaf_tiles: np.ndarray   # (n_tiles, T, k) int32 plane-row leaves
    leaf_loc: np.ndarray     # (n_tiles, T, k) int32 staged-buffer index
    gather_rows: np.ndarray  # (n_tiles, G) int32 unique rows staged/tile
    out_base: np.ndarray     # (n_tiles,) int32 first row of tile's band
    level_of_tile: np.ndarray  # (n_tiles,) int32 source netlist level
    out_idx: np.ndarray      # (n_outputs,) int32 renumbered output rows
    out_neg: np.ndarray      # (n_outputs,) bool complement flags
    row_of_wire: np.ndarray  # (n_wires,) int32 original wire -> plane row
    n_pis: int
    n_rows: int              # renumbered plane height (incl. pad rows)
    tile_rows: int           # T — LUT slots folded per kernel step
    gather_cap: int          # G — staged leaf rows per tile (DMA mode)
    k: int

    @property
    def n_tiles(self) -> int:
        return self.tt_tiles.shape[0]

    @property
    def n_levels(self) -> int:
        return int(self.level_of_tile.max()) + 1 if self.n_tiles else 0

    def tiles_of_level(self, level: int) -> np.ndarray:
        """Tile indices belonging to one netlist level, in walk order."""
        return np.nonzero(self.level_of_tile == level)[0]


def compile_tile_plan(plan: _Plan, n_pis: int, k: int,
                      tile_rows: int = DEFAULT_TILE_ROWS) -> TilePlan:
    """Tile the levelized plan for the streamed kernel.

    Each level's slots are cut into tiles of ``tile_rows``; the level's
    output band is padded to a whole number of tiles so band stores
    stay contiguous. Levelization makes tile order a topological order,
    which is what lets the kernel walk tiles level by level with one
    barrier between levels.
    """
    T = max(1, int(tile_rows))
    n_luts = sum(la.out_wires.shape[0] for la in plan.levels)
    n_wires = 1 + n_pis + n_luts
    row_of_wire = np.zeros((n_wires,), np.int32)
    row_of_wire[: n_pis + 1] = np.arange(n_pis + 1, dtype=np.int32)
    base = 1 + n_pis
    bands = []                       # (first_row, n_real_slots, n_tiles)
    for la in plan.levels:
        n_real = la.out_wires.shape[0]
        nt = -(-n_real // T)
        row_of_wire[la.out_wires] = base + np.arange(n_real,
                                                     dtype=np.int32)
        bands.append((base, n_real, nt))
        base += nt * T
    n_rows = base
    n_tiles = sum(b[2] for b in bands)
    tt_tiles = np.zeros((n_tiles, T, 1 << k), np.uint32)
    leaf_tiles = np.zeros((n_tiles, T, k), np.int32)
    leaf_loc = np.zeros((n_tiles, T, k), np.int32)
    out_base = np.zeros((n_tiles,), np.int32)
    level_of_tile = np.zeros((n_tiles,), np.int32)
    uniq: List[np.ndarray] = []
    ti = 0
    for lvl, ((b, n_real, nt), la) in enumerate(zip(bands, plan.levels)):
        for t in range(nt):
            lo, hi = t * T, min((t + 1) * T, n_real)
            n = hi - lo
            tt_tiles[ti, :n] = la.tt_bits[lo:hi]
            leaf_tiles[ti, :n] = row_of_wire[la.leaf_idx[lo:hi]]
            # pad slots keep row-0 leaves + zero INIT (write 0)
            rows, inv = np.unique(leaf_tiles[ti].reshape(-1),
                                  return_inverse=True)
            leaf_loc[ti] = inv.reshape(T, k).astype(np.int32)
            uniq.append(rows.astype(np.int32))
            out_base[ti] = b + lo
            level_of_tile[ti] = lvl
            ti += 1
    gather_cap = max((r.shape[0] for r in uniq), default=1)
    gather_rows = np.zeros((n_tiles, gather_cap), np.int32)
    for ti, rows in enumerate(uniq):
        gather_rows[ti, :rows.shape[0]] = rows   # pad: re-stage row 0
    out_idx = row_of_wire[plan.out_idx].astype(np.int32)
    return TilePlan(tt_tiles, leaf_tiles, leaf_loc, gather_rows, out_base,
                    level_of_tile, out_idx, plan.out_neg.copy(),
                    row_of_wire, n_pis, n_rows, T, gather_cap, k)


# ---------------------------------------------------------------------------
# Device plan: level-stacked, width-padded tensors for the lut_eval kernel
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DevicePlan:
    """The mapped netlist as dense plan tensors for on-device execution.

    Levels are padded with no-op slots to the widest level so the
    tensors stack rectangularly: a padded slot reads the constant-0
    wire (all leaves 0, INIT masks 0) and writes the dump row
    ``n_wires`` — one past the last real wire — so the kernel's slot
    walk needs no per-slot validity branch.

    ``tiles`` (attached by ``compile_device_plan(..., tile_rows=...)``)
    is the same netlist as a streamed tile schedule (``TilePlan``) for
    the tiled kernel; it is derived data.
    """

    leaf_idx: np.ndarray     # (n_levels, Lw, k) int32 wire indices
    tt_bits: np.ndarray      # (n_levels, Lw, 2^k) uint32 INIT masks
    out_wires: np.ndarray    # (n_levels, Lw) int32 wire written
    out_idx: np.ndarray      # (n_outputs,) int32 wire index per output
    out_neg: np.ndarray      # (n_outputs,) bool complement flags
    n_pis: int
    n_wires: int             # 1 + n_pis + n_luts (dump row index)
    k: int
    tiles: Optional[TilePlan] = None

    @property
    def n_levels(self) -> int:
        return self.leaf_idx.shape[0]

    @property
    def level_width(self) -> int:
        return self.leaf_idx.shape[1]


def compile_device_plan(mapped: MappedNetwork,
                        plan: Optional[_Plan] = None,
                        verify=False,
                        tile_rows: Optional[int] = None) -> DevicePlan:
    """Stack the per-level arrays of ``_compile_plan`` into uniform-width
    tensors ready to ship to the device.

    ``tile_rows`` additionally attaches the streamed tile schedule
    (``DevicePlan.tiles``) with that slot-tile size. ``verify=True``
    runs ``repro_torch.check``'s plan validator plus a mapped<->plan
    miter on the result and raises ``CheckFailure`` with the first
    counterexample on any disagreement (``verify="formal"``: SAT proofs
    for wide cones). Both are host code: nothing is launched."""
    if plan is None:
        plan = _compile_plan(mapped)
    k = mapped.k
    n_wires = 1 + mapped.n_pis + mapped.n_luts
    n_levels = len(plan.levels)
    lw = max((la.out_wires.shape[0] for la in plan.levels), default=0)
    leaf_idx = np.full((n_levels, lw, k), _CONST_WIRE, np.int32)
    tt_bits = np.zeros((n_levels, lw, 1 << k), np.uint32)
    out_wires = np.full((n_levels, lw), n_wires, np.int32)   # dump row
    for i, la in enumerate(plan.levels):
        n = la.out_wires.shape[0]
        leaf_idx[i, :n] = la.leaf_idx
        tt_bits[i, :n] = la.tt_bits
        out_wires[i, :n] = la.out_wires
    dplan = DevicePlan(leaf_idx, tt_bits, out_wires,
                       plan.out_idx.copy(), plan.out_neg.copy(),
                       mapped.n_pis, n_wires, k)
    if tile_rows is not None:
        dplan.tiles = compile_tile_plan(plan, mapped.n_pis, k, tile_rows)
    if verify:
        from repro_torch.check.pipeline import verify_plan
        verify_plan(mapped, dplan, formal=(verify == "formal"))
    return dplan


# ---------------------------------------------------------------------------
# execute_packed through each walk (reference: execute_packed_pallas /
# execute_packed_streamed)
# ---------------------------------------------------------------------------

def _int32_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a contiguous int32 tensor on ``device`` (uint32
    words as their int32 view)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(a.astype(np.int32), device=device)


def _outputs(plane: torch.Tensor, out_idx: np.ndarray,
             out_neg: np.ndarray) -> np.ndarray:
    """Gather the output rows of a walk's int32 plane and complement the
    negated ones -> (n_outputs, W) uint32 words on the host."""
    out = plane[torch.as_tensor(out_idx, dtype=torch.long,
                                device=plane.device)]
    out = out.cpu().numpy().view(np.uint32)
    out[out_neg] = ~out[out_neg]
    return out


def execute_packed_cuda(mapped: MappedNetwork, pi_words: np.ndarray,
                        dplan: Optional[DevicePlan] = None,
                        device=None) -> np.ndarray:
    """``execute_packed`` through the monolithic ``lut_eval`` walk:
    pi_words (n_pis, W) uint32 -> output words (n_outputs, W) uint32.

    ``dplan`` defaults to ``compile_device_plan(mapped)``; ``device``
    (``resolve_device``: the card unless ``"cpu"``, where the walk's
    plain version runs) is where the walk runs."""
    from repro_torch.kernels.lut_eval import lut_eval

    dev = resolve_device(device)
    pi_words = np.asarray(pi_words, np.uint32)
    assert pi_words.shape[0] == mapped.n_pis
    if dplan is None:
        dplan = compile_device_plan(mapped)
    plane = lut_eval(_int32_tensor(pi_words, dev),
                     _int32_tensor(dplan.leaf_idx, dev),
                     _int32_tensor(dplan.tt_bits, dev),
                     _int32_tensor(dplan.out_wires, dev),
                     n_wires=dplan.n_wires)
    return _outputs(plane, dplan.out_idx, dplan.out_neg)


def execute_packed_streamed(mapped: MappedNetwork, pi_words: np.ndarray,
                            tplan: Optional[TilePlan] = None,
                            tile_rows: int = DEFAULT_TILE_ROWS,
                            device=None) -> np.ndarray:
    """``execute_packed`` through the streamed ``lut_eval_streamed``
    walk: pi_words (n_pis, W) uint32 -> output words (n_outputs, W)
    uint32.

    ``tplan`` defaults to the tile plan of ``tile_rows`` slots a tile;
    the walk takes its geometry from the plan (no autotune lookup).
    ``device`` as for ``execute_packed_cuda``."""
    from repro_torch.kernels.lut_eval import level_starts, lut_eval_streamed

    dev = resolve_device(device)
    pi_words = np.asarray(pi_words, np.uint32)
    assert pi_words.shape[0] == mapped.n_pis
    if tplan is None:
        tplan = compile_tile_plan(_compile_plan(mapped), mapped.n_pis,
                                  mapped.k, tile_rows)
    plane = lut_eval_streamed(_int32_tensor(pi_words, dev),
                              _int32_tensor(tplan.tt_tiles, dev),
                              _int32_tensor(tplan.leaf_tiles, dev),
                              _int32_tensor(tplan.out_base, dev),
                              _int32_tensor(level_starts(tplan.level_of_tile),
                                            dev),
                              n_rows=tplan.n_rows)
    return _outputs(plane, tplan.out_idx, tplan.out_neg)


# ---------------------------------------------------------------------------
# Executors (the engine implementations behind repro_torch.synth.executors)
# ---------------------------------------------------------------------------

class _NumpyExecutor:
    """Host-fold engine: ``execute_packed`` level by level, then the
    bitplane decode."""

    name = "numpy"

    def __init__(self, bitnet: "BitplaneNetwork", spec=None):
        self._b = bitnet

    def pack_codes(self, codes) -> np.ndarray:
        """(B, n_inputs) codes -> (n_pi_wires, ceil(B/32)) uint32 words
        (wire i*in_bits+j = bit j of code i)."""
        b = self._b
        if isinstance(codes, torch.Tensor):
            codes = codes.cpu().numpy()
        codes = np.asarray(codes, np.int64)
        planes = np.empty((codes.shape[1] * b.in_bits, codes.shape[0]),
                          np.uint8)
        for j in range(b.in_bits):
            planes[j::b.in_bits] = ((codes >> j) & 1).T
        return pack_bits(planes)

    def apply_codes(self, codes: np.ndarray) -> np.ndarray:
        codes = np.asarray(codes, np.int64)
        out_words = execute_packed(self._b.mapped, self.pack_codes(codes),
                                   plan=self._b._plan)
        return self._decode(out_words, codes.shape[0])

    def _decode(self, out_words: np.ndarray, batch: int) -> np.ndarray:
        b = self._b
        out_bits = unpack_bits(out_words, batch)       # (n_out_wires, B)
        n_out = out_bits.shape[0] // b.out_bits
        out_codes = np.zeros((batch, n_out), np.int64)
        for j in range(b.out_bits):
            out_codes |= out_bits[j::b.out_bits].T.astype(np.int64) << j
        return out_codes

    def classify_codes(self, codes: np.ndarray,
                       n_classes: int) -> np.ndarray:
        vals = self._b.out_levels[self.apply_codes(codes)]
        return np.argmax(vals[..., :n_classes], axis=-1).astype(np.int32)

    def classify_packed(self, pi_words: np.ndarray, n_rows: int,
                        n_classes: int) -> np.ndarray:
        b = self._b
        out_words = execute_packed(b.mapped, np.asarray(pi_words, np.uint32),
                                   plan=b._plan)
        vals = b.out_levels[self._decode(out_words, n_rows)]
        return np.argmax(vals[..., :n_classes], axis=-1).astype(np.int32)


class _TorchExecutor:
    """Shared machinery of the device engines.

    Everything between the input codes and the labels runs on the
    engine's device: bitplane pack (32 samples per int32 lane), the
    netlist kernel (subclass ``plane``), the output complement, code
    decode, the ``out_levels`` gather and the per-request argmax.
    ``pack_codes``, ``eval_words`` and ``labels`` are those stages one
    by one.
    """

    name = "device"

    def __init__(self, bitnet: "BitplaneNetwork", spec=None):
        self.spec = DEFAULT_SPEC if spec is None else spec
        self.device = bitnet.device
        self.in_bits = bitnet.in_bits
        self.out_bits = bitnet.out_bits
        dev = self.device
        self._levels = torch.as_tensor(bitnet.out_levels, device=dev)
        self._in_shifts = torch.arange(self.in_bits, dtype=torch.int32,
                                       device=dev)
        self._lane_shifts = torch.arange(WORD_BITS, dtype=torch.int64,
                                         device=dev)
        self._bit_shifts = torch.arange(WORD_BITS, dtype=torch.int32,
                                        device=dev)
        self._out_weights = torch.arange(self.out_bits, dtype=torch.int32,
                                         device=dev)[None, :, None]

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        """A plan array as a contiguous int32 tensor on the device
        (uint32 INIT masks as their int32 view)."""
        return _int32_tensor(a, self.device)

    # ---- device building blocks -----------------------------------------

    def plane(self, words: torch.Tensor, plain: bool = False
              ) -> torch.Tensor:
        """(n_pis, W) int32 -> the netlist kernel's whole wire plane;
        ``plain`` runs the kernel's plain torch version on the same
        tensors instead."""
        raise NotImplementedError

    def eval_words(self, words: torch.Tensor) -> torch.Tensor:
        """(n_pis, W) int32 -> complemented output words (n_outputs, W)."""
        return self.plane(words)[self._out_idx] ^ self._neg[:, None]

    def pack_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """(B, n_inputs) int codes -> (n_pi_wires, ceil(B/32)) int32
        packed bitplanes (wire i*in_bits+b = bit b of code i)."""
        codes = torch.as_tensor(codes, device=self.device)
        b, n_in = codes.shape
        bits = (codes[:, :, None].to(torch.int32) >> self._in_shifts) & 1
        planes = bits.reshape(b, n_in * self.in_bits).T
        pad = (-b) % WORD_BITS
        if pad:
            planes = torch.nn.functional.pad(planes, (0, pad))
        lanes = planes.reshape(planes.shape[0], -1, WORD_BITS)
        # disjoint bits: an int64 sum is their OR; fold to the int32 view
        return words_to_int32(
            (lanes.to(torch.int64) << self._lane_shifts).sum(dim=2))

    def _decode(self, out_words: torch.Tensor, b: int) -> torch.Tensor:
        """(n_out_wires, W) int32 words -> (b, n_out) int32 codes."""
        bits = (out_words[:, :, None] >> self._bit_shifts) & 1
        bits = bits.reshape(out_words.shape[0], -1)[:, :b]
        n_out = out_words.shape[0] // self.out_bits
        grouped = bits.reshape(n_out, self.out_bits, b)
        return (grouped << self._out_weights).sum(dim=1,
                                                  dtype=torch.int32).T

    def labels(self, out_words: torch.Tensor, b: int,
                n_classes: int) -> torch.Tensor:
        vals = self._levels[self._decode(out_words, b).long()]
        return torch.argmax(vals[..., :n_classes], dim=-1).to(torch.int32)

    # ---- host-facing API -------------------------------------------------

    def apply_codes(self, codes) -> np.ndarray:
        codes = torch.as_tensor(np.asarray(codes), device=self.device)
        out = self._decode(self.eval_words(self.pack_codes(codes)),
                           codes.shape[0])
        return out.cpu().numpy().astype(np.int64)

    def classify_codes(self, codes, n_classes: int) -> np.ndarray:
        codes = torch.as_tensor(np.asarray(codes), device=self.device)
        out = self.eval_words(self.pack_codes(codes))
        return self.labels(out, codes.shape[0], n_classes).cpu().numpy()

    def classify_words(self, words: torch.Tensor, n_rows: int,
                       n_classes: int) -> np.ndarray:
        """Packed PI words on the device -> (n_rows,) int32 labels; only
        the labels come back to the host."""
        out = self.eval_words(words)
        return self.labels(out, n_rows, n_classes).cpu().numpy()

    def classify_packed(self, pi_words, n_rows: int,
                        n_classes: int) -> np.ndarray:
        """``pi_words``: a device tensor from ``pack_codes`` or a host
        (n_pi_wires, W) uint32 array."""
        if not isinstance(pi_words, torch.Tensor):
            pi_words = self._tensor(np.asarray(pi_words, np.uint32))
        return self.classify_words(pi_words, n_rows, n_classes)


class _CudaExecutor(_TorchExecutor):
    """The monolithic pipeline over a ``DevicePlan``: one ``lut_eval``
    launch walks every level (reference engine ``"pallas"``)."""

    name = "cuda"

    def __init__(self, bitnet: "BitplaneNetwork", spec=None):
        super().__init__(bitnet, spec=spec)
        dp = compile_device_plan(bitnet.mapped, bitnet._plan)
        self.dp = dp
        self._leaf = self._tensor(dp.leaf_idx)
        self._tt = self._tensor(dp.tt_bits)
        self._ow = self._tensor(dp.out_wires)
        self._out_idx = self._tensor(dp.out_idx).long()
        self._neg = self._tensor(np.where(dp.out_neg, -1, 0))

    def plane(self, words: torch.Tensor, plain: bool = False
              ) -> torch.Tensor:
        from repro_torch.kernels.lut_eval import lut_eval, lut_eval_ref
        args = (words, self._leaf, self._tt, self._ow)
        if plain:
            return lut_eval_ref(*args, n_wires=self.dp.n_wires)
        return lut_eval(*args, n_wires=self.dp.n_wires, spec=self.spec)


class _CudaStreamedExecutor(_TorchExecutor):
    """The streamed pipeline over a ``TilePlan``: one
    ``lut_eval_streamed`` launch walks every tile, level by level
    (reference engine ``"pallas-streamed"``).

    Tile geometry comes from, in priority order: an explicit ``spec``,
    the persisted autotune cache (keyed by the plan's sha1 fingerprint
    and the device's name, see ``repro_torch.kernels.lut_eval.autotune``),
    or the spec defaults.
    """

    name = "cuda-streamed"

    def __init__(self, bitnet: "BitplaneNetwork", spec=None):
        super().__init__(bitnet, spec=spec)
        from repro_torch.kernels.lut_eval import level_starts
        from repro_torch.kernels.lut_eval.autotune import tuned_spec
        dp = compile_device_plan(bitnet.mapped, bitnet._plan)
        self.spec = tuned_spec(dp, self.device, spec)
        tp = compile_tile_plan(bitnet._plan, dp.n_pis, dp.k,
                               self.spec.tile.tile_rows)
        dp.tiles = tp
        self.dp = dp
        self.tp = tp
        self._tt_tiles = self._tensor(tp.tt_tiles)
        self._leaf_tiles = self._tensor(tp.leaf_tiles)
        self._out_base = self._tensor(tp.out_base)
        self._level_start = self._tensor(level_starts(tp.level_of_tile))
        self._out_idx = self._tensor(tp.out_idx).long()
        self._neg = self._tensor(np.where(tp.out_neg, -1, 0))

    def plane(self, words: torch.Tensor, plain: bool = False
              ) -> torch.Tensor:
        from repro_torch.kernels.lut_eval import (lut_eval_streamed,
                                                  lut_eval_streamed_ref)
        args = (words, self._tt_tiles, self._leaf_tiles, self._out_base,
                self._level_start)
        if plain:
            return lut_eval_streamed_ref(*args, n_rows=self.tp.n_rows)
        return lut_eval_streamed(*args, n_rows=self.tp.n_rows,
                                 spec=self.spec)


# ---------------------------------------------------------------------------
# Whole-network bitplane inference (LogicNetwork-compatible front end)
# ---------------------------------------------------------------------------

class BitplaneNetwork:
    """A compiled ``LogicNetwork`` executed through the mapped netlist.

    ``from_logic_network`` runs the full synthesis pipeline
    (SOP -> AIG -> balance/rewrite -> k-LUT map); ``__call__`` matches
    ``LogicNetwork.__call__`` bit-exactly on every reachable input.

    ``engine`` names an executor in the ``repro_torch.synth.executors``
    registry (built-ins ``"numpy"``, ``"cuda"``, ``"cuda-streamed"``;
    ``None`` picks ``"cuda-streamed"`` on a CUDA device and ``"numpy"``
    elsewhere); unknown names raise ``UnknownEngineError`` listing the registered
    engines. ``device`` is where the input quantizer and the device
    engines run (default ``"cuda"``; ``"cpu"`` runs the kernels' plain
    versions).
    """

    def __init__(self, net, mapped: MappedNetwork,
                 engine: Optional[str] = None, device=None, spec=None):
        from .executors import default_engine, get as _get_engine
        self.device = resolve_device(device)
        if engine is None:
            engine = default_engine(self.device)
        self._factory = _get_engine(engine)    # typed error on bad name
        self.net = net
        self.mapped = mapped
        self.engine = engine
        self.spec = spec
        # lazy import: this module loads during repro_torch.serve's init
        # (via aggregate), while repro_torch.obs pulls
        # repro_torch.serve.metrics; a module-level import here would
        # close an import cycle
        from repro_torch.obs.trace import NULL_TRACER
        self.tracer = NULL_TRACER
        self._plan = _compile_plan(mapped)
        self._exec = None
        self.in_bits = net.in_spec.code_bits
        last = net.layers[-1]
        self.out_bits = last.out_spec.code_bits
        self.out_levels = np.asarray(last.out_spec.levels(last.out_alpha))

    @classmethod
    def from_logic_network(cls, net, effort: int = 1, k: int = 6,
                           engine: Optional[str] = None, device=None,
                           spec=None, verify=False) -> "BitplaneNetwork":
        """``verify=True`` miters every synthesis stage
        (``synthesize(verify=...)``) and runs ``repro_torch.check``'s
        serving preflight on the result; ``CheckFailure`` on any error."""
        from . import synthesize        # lazy: package init imports us
        from .from_sop import network_to_aig
        bn = cls(net, synthesize(network_to_aig(net), effort=effort, k=k,
                                 verify=verify),
                 engine=engine, device=device, spec=spec)
        if verify:
            from repro_torch.check.pipeline import preflight
            from repro_torch.check.report import require_ok
            require_ok(preflight(bn))
        return bn

    @property
    def executor(self):
        """This network's engine instance (built lazily on first use)."""
        if self._exec is None:
            self._exec = self._factory(self, spec=self.spec)
        return self._exec

    def quantize(self, x) -> torch.Tensor:
        """Real inputs (array or tensor) -> int32 input codes on
        ``self.device``."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        return self.net.quantize_inputs(x)

    def pack_inputs(self, x):
        """Real inputs -> the engine's packed PI words (a device tensor,
        or uint32 numpy words for the numpy engine)."""
        return self.executor.pack_codes(self.quantize(x))

    def apply_codes(self, codes: np.ndarray) -> np.ndarray:
        """(B, n_inputs) input codes -> (B, n_out_neurons) output codes."""
        return self.executor.apply_codes(np.asarray(codes, np.int64))

    def __call__(self, x) -> np.ndarray:
        """Real inputs -> decoded real outputs (LogicNetwork contract)."""
        codes = self.quantize(x).cpu().numpy()
        return self.out_levels[self.apply_codes(codes)]

    def classify(self, x, n_classes: int) -> np.ndarray:
        codes = self.quantize(x).cpu().numpy()
        return self.executor.classify_codes(codes, n_classes)

    def classify_packed(self, pi_words, n_rows: int,
                        n_classes: int) -> np.ndarray:
        """Packed PI bitplanes -> per-lane argmax labels, (n_rows,) int32.

        The serve-aggregation entry point: on device engines the words
        go straight to the kernel and only the argmax labels return; on
        numpy it is the host fold + decode."""
        with self.tracer.span("lut_eval", cat="kernel", args={
                "rows": n_rows, "engine": self.engine,
                "n_levels": len(self._plan.levels)}):
            return self.executor.classify_packed(pi_words, n_rows,
                                                 n_classes)


# ---------------------------------------------------------------------------
# Verilog emission of the mapped netlist
# ---------------------------------------------------------------------------

def emit_verilog(mapped: MappedNetwork, name: str = "mapped_logic") -> str:
    """Structural Verilog: one INIT-vector-indexed assign per LUT (the
    textual form of a LUT6 instance, synthesizable and simulable). The
    text is the reference package's for the same netlist, its header
    line included."""
    k = mapped.k
    lut_pos = {l.root: i for i, l in enumerate(mapped.luts)}

    def wname(node: int) -> str:
        w = _wire_of(mapped, node, lut_pos)
        if w == _CONST_WIRE:
            return "1'b0"
        if w <= mapped.n_pis:
            return f"x[{w - 1}]"
        return f"n{w}"

    lines = [
        f"// {name}: {mapped.n_luts} LUT{k}s, depth {mapped.depth}",
        f"// generated by repro.synth (AIG -> rewrite -> {k}-LUT map)",
        f"module {name} (",
        f"  input  wire [{mapped.n_pis - 1}:0] x,",
        f"  output wire [{len(mapped.outputs) - 1}:0] y",
        ");",
    ]
    for i, l in enumerate(mapped.luts):
        m = len(l.leaves)
        tt = tt_expand(l.tt, m, k)
        init = f"{1 << k}'h{tt:0{(1 << k) // 4}x}"
        ins = [wname(x) for x in l.leaves]
        ins += ["1'b0"] * (k - m)            # pad unused select inputs
        sel = ", ".join(reversed(ins))       # MSB first in concatenation
        w = mapped.n_pis + 1 + i
        lines.append(f"  wire n{w};")
        lines.append(f"  wire [{(1 << k) - 1}:0] n{w}_init = {init};  // LUT{k}")
        lines.append(f"  assign n{w} = n{w}_init[{{{sel}}}];")
    for i, o in enumerate(mapped.outputs):
        inv = "~" if lit_compl(o) else ""
        src = wname(lit_var(o))
        if src == "1'b0" and inv:
            lines.append(f"  assign y[{i}] = 1'b1;")
        else:
            lines.append(f"  assign y[{i}] = {inv}{src};")
    lines.append("endmodule")
    return "\n".join(lines)
