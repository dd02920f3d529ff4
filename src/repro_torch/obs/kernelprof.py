"""Per-level ``lut_eval`` profiling -> a measured device-latency table.

The mapper optimizes structural LUT count/depth, and the scheduler's
flush margin + ``least_slack`` dispatch run on a cold-start EWMA of
whole-batch execution time. Neither knows what a netlist *level*
actually costs on the device. This module measures it through the
port's two ``lut_eval`` walks (``kernels/lut_eval``):

  * ``measure_level_grid`` — synthetic single-level plans swept over
    ``(level_width, fanin)`` at fixed ``k``: random leaves into a
    wire plane sized like a real netlist's, timed through the
    monolithic ``lut_eval`` walk the ``cuda`` engine launches. The grid
    is netlist-independent, so it can be measured once per device and
    reused (the nnabla-nas layer-wise offline-estimation shape).
  * ``profile_plan`` — the real ``DevicePlan``'s levels, timed by
    running level prefixes 1..n and differencing: level i's row is the
    *incremental* device cost of adding it, which captures gather
    locality the synthetic grid cannot.
  * ``profile_tile_plan`` — the streamed walk (``lut_eval_streamed``,
    the ``cuda-streamed`` engine) over a ``TilePlan``, timed by tile
    prefixes the same way: each row is one tile's incremental cost,
    the granularity the streamed engine schedules.

``build_latency_table`` fits them into a ``LatencyTable`` whose
``estimate_level_us``/``estimate_plan_us`` interpolate (linear in
width, nearest in fanin) and whose ``save`` artifact is what
``least_slack`` dispatch (``ReplicaSet(exec_seed_us=...)``), the
scheduler's flush margin (``SchedConfig.exec_estimate_us``) and future
hardware-aware mapping search consume.

On a card each time is CUDA events around back-to-back launches, after
a first call that may build the kernel library. On the CPU it is wall
time through the kernels' plain torch versions, **not** device
microseconds: the artifact's ``meta`` records the backend (``cuda`` /
``cpu``), the device's name and the card's power limit, so consumers
can refuse to mix calibrations from different devices.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, device_info, resolve_device

DEFAULT_WIDTHS = (4, 16, 64)
DEFAULT_FANINS = (2, 4, 6)


class LatencyTableError(ValueError):
    """Typed error for latency-table estimation failures."""


class EmptyLatencyTable(LatencyTableError):
    """Estimation was asked of a table holding no measurements."""


def _time_us(fn, device: torch.device, iters: int = 3) -> float:
    """µs per call of ``fn()``, first call excluded (it may build the
    kernel library). On a card: CUDA events around ``iters``
    back-to-back launches, read after a synchronize; on the CPU: wall
    time."""
    iters = max(1, int(iters))
    if device.type == "cuda":
        fn()
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) * 1e3 / iters
    from repro_torch.serve.clock import SystemClock
    clk = SystemClock()
    fn()
    t0 = clk.now_us()
    for _ in range(iters):
        fn()
    return (clk.now_us() - t0) / iters


def _int32(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A plan array as a contiguous int32 tensor (uint32 INIT masks as
    their int32 view)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(a.astype(np.int32), device=device).contiguous()


def _random_words(rng, n_pis: int, w_words: int,
                  device: torch.device) -> torch.Tensor:
    words = rng.integers(0, 1 << 31, (max(n_pis, 1), w_words),
                         dtype=np.int64)
    return torch.as_tensor(words.astype(np.int32), device=device)


def single_level_plan(width: int, fanin: int, k: int = 6,
                      w_words: int = 128,
                      seed: int = 0) -> Dict[str, object]:
    """One synthetic level of ``width`` LUTs with ``fanin`` live leaves
    each, in the ``DevicePlan`` layout ``lut_eval`` walks, and its input
    words: a one-level stack (``leaf_idx`` (1, width, k), ``tt_bits``
    (1, width, 2^k) uint32, ``out_wires`` (1, width)) and ``words``
    (n_pis, w_words) int32, drawn from one ``default_rng(seed)`` stream
    in the reference's order. The plane holds as many PI rows as LUTs
    (wires 1..n_pis); leaves past ``fanin`` read the constant wire 0;
    LUT i writes wire ``n_pis + 1 + i``. The level has no pad slot, so
    nothing writes the dump row ``n_wires``."""
    rng = np.random.default_rng(seed)
    n_pis = max(int(width), fanin, 1)
    leaf = np.zeros((width, k), np.int32)
    leaf[:, :fanin] = rng.integers(1, n_pis + 1, (width, fanin))
    tt = (rng.integers(0, 2, (width, 1 << k)).astype(np.uint32)
          * np.uint32(0xFFFFFFFF))
    ow = (np.arange(width, dtype=np.int32) + n_pis + 1)
    words = rng.integers(0, 1 << 31, (n_pis, w_words), dtype=np.int64)
    return {"leaf_idx": leaf[None], "tt_bits": tt[None],
            "out_wires": ow[None], "words": words.astype(np.int32),
            "n_pis": n_pis, "n_wires": 1 + n_pis + width}


def time_single_level(width: int, fanin: int, k: int = 6,
                      w_words: int = 128, iters: int = 3,
                      device: DeviceLike = None, seed: int = 0) -> float:
    """µs for one synthetic level (``single_level_plan``) through the
    monolithic ``lut_eval`` walk."""
    from repro_torch.kernels.lut_eval import lut_eval

    dev = resolve_device(device)
    plan = single_level_plan(width, fanin, k=k, w_words=w_words, seed=seed)
    words, leaf, tt, ow = (_int32(plan[n], dev) for n in
                           ("words", "leaf_idx", "tt_bits", "out_wires"))
    return _time_us(lambda: lut_eval(words, leaf, tt, ow,
                                     n_wires=plan["n_wires"]),
                    dev, iters=iters)


def measure_level_grid(widths: Sequence[int] = DEFAULT_WIDTHS,
                       fanins: Sequence[int] = DEFAULT_FANINS,
                       k: int = 6, w_words: int = 128, iters: int = 3,
                       device: DeviceLike = None,
                       seed: int = 0) -> List[Dict]:
    """Synthetic ``(level_width, fanin)`` sweep -> measurement rows."""
    rows = []
    for width in widths:
        for fanin in fanins:
            if fanin > k:
                continue
            us = time_single_level(width, fanin, k=k, w_words=w_words,
                                   iters=iters, device=device, seed=seed)
            rows.append({"source": "grid", "level_width": int(width),
                         "k": int(k), "fanin": int(fanin),
                         "device_us": float(us), "w_words": int(w_words)})
    return rows


def plan_level_fanins(dplan) -> List[float]:
    """Mean live (non-const-leaf) fanin per level of a ``DevicePlan``.

    Padded no-op slots (all leaves const, INIT masks all-zero) are
    excluded from the mean; a level that is pure padding reports 0.
    """
    out = []
    for lvl in range(dplan.n_levels):
        live = dplan.tt_bits[lvl].any(axis=1)        # real (non-pad) slots
        if not live.any():
            out.append(0.0)
            continue
        fan = (dplan.leaf_idx[lvl][live] != 0).sum(axis=1)
        out.append(float(fan.mean()))
    return out


def profile_plan(dplan, w_words: int = 128, iters: int = 3,
                 device: DeviceLike = None, seed: int = 0) -> List[Dict]:
    """Measured incremental µs per level of a real plan.

    Times the monolithic ``lut_eval`` walk on level prefixes
    1..n_levels and differences consecutive timings; clamps at >= 0
    (timer noise can invert neighbouring prefixes on near-empty
    levels).
    """
    from repro_torch.kernels.lut_eval import lut_eval

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    lw, k = dplan.level_width, dplan.k
    words = _random_words(rng, dplan.n_pis, w_words, dev)
    leaf = _int32(dplan.leaf_idx, dev)
    tt = _int32(dplan.tt_bits, dev)
    ow = _int32(dplan.out_wires, dev)
    fanins = plan_level_fanins(dplan)

    prefix_us = []
    for lvl in range(dplan.n_levels):
        n = lvl + 1

        def fn(n=n):
            return lut_eval(words, leaf[:n], tt[:n], ow[:n],
                            n_wires=dplan.n_wires)

        prefix_us.append(_time_us(fn, dev, iters=iters))
    rows = []
    for lvl, us in enumerate(prefix_us):
        inc = us - (prefix_us[lvl - 1] if lvl else 0.0)
        rows.append({"source": "plan", "level": lvl,
                     "level_width": int(lw), "k": int(k),
                     "fanin": round(fanins[lvl], 2),
                     "device_us": float(max(inc, 0.0)),
                     "prefix_us": float(us), "w_words": int(w_words)})
    return rows


def tile_plan_fanins(tplan) -> List[float]:
    """Mean live (non-const-leaf) fanin per tile of a ``TilePlan``;
    pad slots (all-zero INIT) are excluded, pure-pad tiles report 0."""
    out = []
    for t in range(tplan.n_tiles):
        live = tplan.tt_tiles[t].any(axis=1)
        if not live.any():
            out.append(0.0)
            continue
        fan = (tplan.leaf_tiles[t][live] != 0).sum(axis=1)
        out.append(float(fan.mean()))
    return out


def profile_tile_plan(tplan, w_words: int = 128, iters: int = 3,
                      device: DeviceLike = None,
                      seed: int = 0) -> List[Dict]:
    """Measured incremental µs per *tile* of a streamed plan.

    Times the streamed walk (``lut_eval_streamed``) on tile prefixes
    1..n_tiles and differences consecutive timings (clamped >= 0), so
    each row is what one tile step costs end to end. A prefix that ends
    inside a level walks that level's first tiles only: its
    ``level_start`` is recomputed from the prefix's own
    ``level_of_tile``.
    """
    from repro_torch.kernels.lut_eval import level_starts, lut_eval_streamed

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    words = _random_words(rng, tplan.n_pis, w_words, dev)
    tt = _int32(tplan.tt_tiles, dev)
    leaf = _int32(tplan.leaf_tiles, dev)
    ob = _int32(tplan.out_base, dev)
    fanins = tile_plan_fanins(tplan)

    prefix_us = []
    for n in range(1, tplan.n_tiles + 1):
        starts = _int32(level_starts(tplan.level_of_tile[:n]), dev)

        def fn(n=n, starts=starts):
            return lut_eval_streamed(words, tt[:n], leaf[:n], ob[:n],
                                     starts, n_rows=tplan.n_rows)

        prefix_us.append(_time_us(fn, dev, iters=iters))
    rows = []
    for t, us in enumerate(prefix_us):
        inc = us - (prefix_us[t - 1] if t else 0.0)
        rows.append({"source": "tile", "level": int(tplan.level_of_tile[t]),
                     "tile": t, "level_width": int(tplan.tile_rows),
                     "k": int(tplan.k), "fanin": round(fanins[t], 2),
                     "device_us": float(max(inc, 0.0)),
                     "prefix_us": float(us), "w_words": int(w_words)})
    return rows


@dataclasses.dataclass
class LatencyTable:
    """Measured ``(level_width, k, fanin) -> device µs`` lookup.

    Estimation is nearest-fanin (which clamps out-of-sweep fanins to
    the nearest calibrated one), then linear interpolation in
    ``level_width``. Queries **outside the calibrated width sweep are
    clamped, never slope-extrapolated**: below the grid the smallest
    measurement applies (``np.interp``'s edge clamp); above it the
    largest measurement scales proportionally per LUT
    (``us[-1] * width / ws[-1]``) — per-level work is linear in width
    for a fixed word tile, and a two-point slope can go negative or
    explode on a noisy sweep, which once fed the flush margin a
    nonsense estimate.

    ``scale`` is an online correction factor: calibration happens on an
    idle device, serving happens on a busy one, and
    ``repro_torch.obs.online.OnlineProfiler`` blends the live measured/
    predicted ratio into it so scheduler flush margins track the
    machine as it actually is.
    """

    rows: List[Dict]
    meta: Dict = dataclasses.field(default_factory=dict)
    scale: float = 1.0              # online measured/predicted blend

    SCALE_MIN = 0.1
    SCALE_MAX = 10.0

    def _grid_rows(self, k: int) -> List[Dict]:
        if not self.rows:
            raise EmptyLatencyTable(
                "latency table holds no measurements — run "
                "build_latency_table (or load a saved artifact) before "
                "estimating")
        rows = [r for r in self.rows
                if r["k"] == k and r["source"] == "grid"]
        return rows or [r for r in self.rows if r["k"] == k]

    def estimate_level_us(self, level_width: int, fanin: float,
                          k: int = 6) -> float:
        rows = self._grid_rows(k)
        if not rows:
            raise LatencyTableError(
                f"no measurements for k={k} "
                f"(calibrated: {sorted({r['k'] for r in self.rows})})")
        if not np.isfinite(level_width) or not np.isfinite(fanin):
            raise LatencyTableError(
                f"non-finite query (level_width={level_width}, "
                f"fanin={fanin})")
        level_width = max(float(level_width), 0.0)
        fans = sorted({r["fanin"] for r in rows})
        near_fan = min(fans, key=lambda f: abs(f - fanin))
        pts = sorted((r["level_width"], r["device_us"]) for r in rows
                     if r["fanin"] == near_fan)
        ws = [p[0] for p in pts]
        us = [p[1] for p in pts]
        if level_width > ws[-1]:        # past grid: per-LUT scaling of
            est = us[-1] * level_width / max(ws[-1], 1)     # the last point
        elif len(pts) == 1:
            est = us[0] * level_width / max(ws[0], 1)
        else:                           # in-grid interp; below-grid clamps
            est = float(np.interp(level_width, ws, us))     # to us[0]
        return max(est, 0.0) * self.scale

    def estimate_plan_us(self, dplan) -> float:
        """Calibrated whole-netlist estimate: sum of per-level
        estimates at each level's width and mean live fanin."""
        total = 0.0
        for fanin in plan_level_fanins(dplan):
            total += self.estimate_level_us(dplan.level_width, fanin,
                                            k=dplan.k)
        return total

    def blend_scale(self, factor: float, alpha: float = 0.2) -> float:
        """EWMA-blend a live measured/predicted ratio into ``scale``.

        ``factor`` outside ``[SCALE_MIN, SCALE_MAX]`` is clamped before
        blending (one absurd sample — a GC pause mid-measurement — must
        not poison every later estimate); non-finite factors are
        ignored. Returns the updated scale."""
        if not np.isfinite(factor) or factor <= 0:
            return self.scale
        factor = min(max(float(factor), self.SCALE_MIN), self.SCALE_MAX)
        self.scale = min(max((1.0 - alpha) * self.scale + alpha * factor,
                             self.SCALE_MIN), self.SCALE_MAX)
        return self.scale

    # -- artifact ----------------------------------------------------------
    def to_dict(self) -> Dict:
        return {"kind": "lut_level_latency_table", "meta": self.meta,
                "scale": self.scale, "rows": self.rows}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)
        return path

    @classmethod
    def load(cls, path: str) -> "LatencyTable":
        with open(path) as f:
            doc = json.load(f)
        if doc.get("kind") != "lut_level_latency_table":
            raise ValueError(f"{path} is not a lut-level latency table")
        return cls(rows=doc["rows"], meta=doc.get("meta", {}),
                   scale=float(doc.get("scale", 1.0)))


def build_latency_table(dplan=None, widths: Sequence[int] = DEFAULT_WIDTHS,
                        fanins: Sequence[int] = DEFAULT_FANINS, k: int = 6,
                        w_words: int = 128, iters: int = 3,
                        device: DeviceLike = None,
                        seed: int = 0) -> LatencyTable:
    """Grid sweep (+ real-plan per-level rows when ``dplan`` given, and
    per-tile rows of the streamed walk when it carries ``tiles``) -> a
    saveable ``LatencyTable`` stamped with the measurement context."""
    dev = resolve_device(device)
    if dplan is not None:
        k = dplan.k
    rows = measure_level_grid(widths, fanins, k=k, w_words=w_words,
                              iters=iters, device=dev, seed=seed)
    if dplan is not None:
        rows += profile_plan(dplan, w_words=w_words, iters=iters,
                             device=dev, seed=seed)
        if getattr(dplan, "tiles", None) is not None:
            rows += profile_tile_plan(dplan.tiles, w_words=w_words,
                                      iters=iters, device=dev, seed=seed)
    meta = dict(device_info(dev), w_words=int(w_words), iters=int(iters),
                k=int(k))
    return LatencyTable(rows=rows, meta=meta)
