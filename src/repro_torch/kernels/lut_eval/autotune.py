"""Persisted tile-size autotuning for the streamed lut_eval walk.

The streamed walk has two geometry knobs — ``tile_rows`` (LUT slots a
tile of the ``TilePlan``; sets how the plan is cut into tiles and how
many slots one step folds) and ``block_w`` (packed words a thread
block). The best point depends on the netlist shape (level widths,
fanin mix) and on the card, so the sweep is run once per netlist and
the winner persisted, keyed by the plan's sha1 fingerprint
(``repro_torch.check.plan_check.plan_fingerprint``, the same hash the
reference package gives the same plan) plus the card's name
(``torch.cuda.get_device_name``), or ``cpu`` — a tuned H100 never
poisons another card's entry or the CPU's, and vice versa.

The cache file defaults to ``~/.cache/repro_torch/lut_eval_tiles.json``
(override with ``REPRO_AUTOTUNE_CACHE``; set it to an empty string to
disable persistence). ``_CudaStreamedExecutor`` consults
``cached_tile`` when it is built without a spec, so serving picks up a
tuned shape for free; the sweep itself (``autotune_streamed``) only
runs when explicitly invoked, because it times every candidate.
"""
from __future__ import annotations

import functools
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..spec import DEFAULT_SPEC, KernelSpec

# (tile_rows, block_w) sweep grid. tile_rows takes the reference's
# 16/32/64/128: it trades the number of tiles (plan units staged per
# step) against pad slots in each level's last tile. block_w counts
# packed words a block here (the reference's 128/256 are the TPU's lane
# tiles): the serving batch is 8 words (256 rows), so any block_w of 8
# or more runs it in one block and only a narrower one spreads it over
# more blocks; 4 splits it over two SMs, and 128 against the default 32
# sets how a large batch is cut into blocks.
DEFAULT_CANDIDATES: Tuple[Tuple[int, int], ...] = (
    (16, 32), (32, 32), (64, 32), (128, 32),
    (32, 4), (32, 128),
)

_ENV = "REPRO_AUTOTUNE_CACHE"


def cache_path() -> Optional[str]:
    """Cache file path, or ``None`` when persistence is disabled."""
    p = os.environ.get(_ENV)
    if p is not None:
        return p or None
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "lut_eval_tiles.json")


def _load(path: str) -> Dict[str, dict]:
    try:
        with open(path) as f:
            data = json.load(f)
        return data if isinstance(data, dict) else {}
    except (OSError, ValueError):
        return {}


def _store(path: str, data: Dict[str, dict]) -> None:
    """Atomic write: unique temp file in the target directory, then
    ``os.replace``.  A pid-suffixed temp name is NOT enough — two
    threads of one process (or a recycled pid) would interleave writes
    into the same temp file; ``mkstemp`` gives each writer its own."""
    try:
        d = os.path.dirname(path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path),
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(data, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
    except OSError:
        pass                       # cache is advisory, never fatal


def device_name(device) -> str:
    """The cache's name for a device: the card's name, or ``cpu``."""
    device = torch.device(device)
    if device.type == "cpu":
        return "cpu"
    return torch.cuda.get_device_name(device)


def _key(fingerprint: str, device: str) -> str:
    return f"{fingerprint}:{device}"


def lookup(fingerprint: str, device: str) -> Optional[Tuple[int, int]]:
    """Persisted (tile_rows, block_w) for a plan fingerprint on the
    device named ``device`` (``device_name``), if any."""
    path = cache_path()
    if path is None:
        return None
    ent = _load(path).get(_key(fingerprint, device))
    if not ent:
        return None
    try:
        return int(ent["tile_rows"]), int(ent["block_w"])
    except (KeyError, TypeError, ValueError):
        return None


def record(fingerprint: str, device: str, tile_rows: int, block_w: int,
           us: float) -> None:
    """Persist a tuned shape (last write wins)."""
    path = cache_path()
    if path is None:
        return
    data = _load(path)
    data[_key(fingerprint, device)] = {
        "tile_rows": int(tile_rows), "block_w": int(block_w),
        "us": float(us), "stamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }
    _store(path, data)


def cached_tile(dplan, device) -> Optional[Tuple[int, int]]:
    """Tuned (tile_rows, block_w) for a ``DevicePlan`` on ``device``, if
    persisted."""
    from repro_torch.check.plan_check import plan_fingerprint  # lazy: cycle
    return lookup(plan_fingerprint(dplan), device_name(device))


def tuned_spec(dplan, device, spec: Optional[KernelSpec] = None
               ) -> KernelSpec:
    """The streamed walk's launch spec over ``dplan`` on ``device``:
    ``spec`` when given, else the cached tuned geometry, else the
    default."""
    if spec is not None:
        return spec
    tuned = cached_tile(dplan, device)
    if tuned is None:
        return DEFAULT_SPEC
    return DEFAULT_SPEC.with_tile(tile_rows=tuned[0], block_w=tuned[1])


@functools.lru_cache(maxsize=8)
def _cycles_per_ms(index: int) -> float:
    """Clock cycles ``torch.cuda._sleep`` spins a millisecond on a card."""
    torch.cuda.synchronize(index)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 1 << 22
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / max(start.elapsed_time(end), 1e-3)


def _time_us(fn, device, iters: int = 50) -> float:
    """Time of one ``fn()`` in µs after a warm-up. On the card, by CUDA
    events around ``iters`` calls queued behind a spin of twice their
    host issue time, so the events see the device work back to back
    rather than the host's issue rate; on the CPU, by the host clock."""
    device = torch.device(device)
    fn()
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    issue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * issue_ms
                          * _cycles_per_ms(device.index or 0)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / iters


def autotune_streamed(bitnet, pi_words,
                      candidates: Sequence[Tuple[int, int]]
                      = DEFAULT_CANDIDATES,
                      iters: int = 50, persist: bool = True,
                      timings: Optional[List[Tuple[int, int, float]]] = None
                      ) -> Tuple[int, int, float]:
    """Sweep (tile_rows, block_w) over a real batch and persist the
    winner; returns (tile_rows, block_w, us).

    ``bitnet``: a ``BitplaneNetwork`` (its device is where the sweep
    runs); ``pi_words``: (n_pi_wires, W) uint32 packed bitplanes (or
    their int32 tensor) shaped like the serving batch (the tuned shape
    is only as good as the batch it was measured on). Each candidate's
    ``_CudaStreamedExecutor.eval_words`` is timed by ``_time_us``; with
    ``timings`` given, each candidate's (tile_rows, block_w, us) is
    appended to it.
    """
    import numpy as np

    from repro_torch.check.plan_check import plan_fingerprint  # lazy: cycle
    from repro_torch.synth.executor import (_CudaStreamedExecutor,
                                            compile_device_plan)

    dev = bitnet.device
    if isinstance(pi_words, torch.Tensor):
        words = pi_words.to(device=dev, dtype=torch.int32).contiguous()
    else:
        words = torch.from_numpy(np.ascontiguousarray(
            pi_words, np.uint32).view(np.int32).copy()).to(dev)
    best: Optional[Tuple[int, int, float]] = None
    for tile_rows, block_w in candidates:
        ex = _CudaStreamedExecutor(
            bitnet, spec=DEFAULT_SPEC.with_tile(tile_rows=tile_rows,
                                                block_w=block_w))
        us = _time_us(lambda: ex.eval_words(words), dev, iters=iters)
        if timings is not None:
            timings.append((tile_rows, block_w, us))
        if best is None or us < best[2]:
            best = (tile_rows, block_w, us)
    if best is None:
        raise ValueError("autotune_streamed needs at least one candidate")
    if persist:
        dp = compile_device_plan(bitnet.mapped, bitnet._plan)
        record(plan_fingerprint(dp), device_name(dev), *best)
    return best
