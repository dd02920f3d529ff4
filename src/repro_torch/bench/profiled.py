"""The device time of a call on the card, from ``torch.profiler``.

``device_time(fn, match, n)`` first profiles one call of ``fn`` to
count the launches it makes, then profiles ``n`` back-to-back calls, up
to three sessions, until one sees ``n`` times as many: only such a
session gives the µs a call and the split by kernel. A session that saw
fewer gives the µs a launch of those it saw. Each session starts with a
short ``torch.cuda._sleep`` (its ``spin_kernel`` is not counted), as a
session on a busy process has been seen to miss its first kernel.
``chip_smoke.py`` and ``bench/flash_backward.py`` time through it.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class DeviceTime:
    call_us: float | None       # µs a call, from a session that saw all
    launch_us: float | None     # µs a launch, of the launches seen
    launches: int               # launches a call (the first session's)
    seen: int                   # launches seen by the session used
    kernels: dict               # {symbol (80 chars): µs a call}, with call_us


def device_time(fn, match: str | None = None, n: int = 10) -> DeviceTime:
    """The profiler's device time of ``fn`` over ``n`` calls, counting
    the kernels whose symbol holds ``match`` (None: every device event
    of the call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def session(calls):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "spin_kernel" not in e.key
                and (match is None or match in e.key)]

    def total(events):
        return sum(getattr(e, "self_device_time_total", 0.0) for e in events)

    fn()
    torch.cuda.synchronize()
    per_call = sum(e.count for e in session(1))
    best = None
    for _ in range(3):
        mine = session(n)
        seen = sum(e.count for e in mine)
        if per_call and seen == per_call * n:
            us = total(mine)
            return DeviceTime(us / n, us / seen, per_call, seen,
                              {e.key[:80]: getattr(e, "self_device_time_total",
                                                   0.0) / n for e in mine})
        if seen and (best is None or seen > best[1]):
            best = (total(mine), seen)
    if best is None:
        return DeviceTime(None, None, per_call, 0, {})
    return DeviceTime(None, best[0] / best[1], per_call, best[1], {})
