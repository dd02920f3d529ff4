"""Timing a call on the card: wall µs by the host clock, and device µs by
CUDA events around calls queued behind a device spin.

Back-to-back calls of a small kernel's wrapper on the card time the
host's issue rate: the device finishes each launch before the host has
issued the next, so CUDA events around them measure the host.
``device_us`` first times the issue of ``iters`` calls, then queues a
``torch.cuda._sleep`` of twice that long and records the events around
the same calls issued behind it: by the time the spin ends, every call
is queued, and the events see the device work back to back. A call
that waits for the device itself (a copy to the host, or torch's copy
of a host value to the card, which synchronizes the stream) lets the
spin run out; ``device_us`` says whether that happened. The
autotune sweep (``kernels/lut_eval/autotune.py``) and the latency
benchmark (``bench/latency.py``) time through it.
"""
from __future__ import annotations

import functools
import time

import torch


@functools.lru_cache(maxsize=8)
def cycles_per_ms(index: int) -> float:
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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def wall_us(fn, device, iters: int = 50) -> float:
    """Host wall µs of one ``fn()``: ``perf_counter`` around ``iters``
    back-to-back calls ended by a synchronize, after a warm-up call (the
    reference's ``benchmarks/latency.py::_time_call``)."""
    device = torch.device(device)
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / iters * 1e6


def device_us(fn, device, iters: int = 50):
    """(µs of one ``fn()``, queued) after two warm-up calls. On the card
    the time is CUDA events around ``iters`` calls queued behind a spin
    of twice their host issue time, so the events see the device work
    back to back rather than the host's issue rate; ``queued`` is
    ``True`` when the spin was still running once the host had issued
    every call and ``False`` when it had ended (a call that waits for
    the device lets the spin run out, and the events then time the host
    as well). On the CPU the time is the host clock's and ``queued`` is
    ``None``."""
    device = torch.device(device)
    fn()
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e6, None
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    issue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * issue_ms * cycles_per_ms(device.index or 0)))
    start.record()
    for _ in range(iters):
        fn()
    queued = not start.query()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / iters, queued
