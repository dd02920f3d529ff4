"""Fault-tolerance hooks for training (``repro_torch.train.loop``), as
the reference's ``repro/dist/fault.py``: plain Python, no tensors.

  Heartbeat    — each host periodically writes a liveness file to shared
                 storage; any host can list the peers that stopped
                 beating (the controller's restart signal).
  StepWatchdog — online mean/variance of step wall time; a step beyond
                 mean + k*sigma flags a straggler. Outliers are excluded
                 from the running stats so one hiccup does not widen the
                 detection band.
  retry_step   — wrap the train step with bounded retries +
                 exponential backoff for transient failures (preempted
                 collective, flaky interconnect).
"""
from __future__ import annotations

import json
import math
import os
import time
from typing import Callable, List


class Heartbeat:
    """File-based liveness on a shared directory (one file per host)."""

    def __init__(self, hb_dir: str, host_id: int):
        self.dir = hb_dir
        self.host_id = int(host_id)
        os.makedirs(hb_dir, exist_ok=True)

    def _path(self, host_id: int) -> str:
        return os.path.join(self.dir, f"host_{host_id}.json")

    def beat(self, step: int) -> None:
        """Atomically publish (host, step, now)."""
        tmp = self._path(self.host_id) + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"host": self.host_id, "step": int(step),
                       "time": time.time()}, f)
        os.replace(tmp, self._path(self.host_id))

    def hosts(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("host_") and name.endswith(".json"):
                try:
                    out.append(int(name[5:-5]))
                except ValueError:
                    continue  # stray/foreign file in the shared dir
        return sorted(out)

    def stale_hosts(self, timeout_s: float) -> List[int]:
        """Hosts whose last beat is older than ``timeout_s``."""
        now = time.time()
        stale = []
        for h in self.hosts():
            try:
                with open(self._path(h)) as f:
                    info = json.load(f)
            except (OSError, ValueError):
                stale.append(h)  # unreadable == presumed dead
                continue
            if now - float(info.get("time", 0.0)) > timeout_s:
                stale.append(h)
        return stale


class StepWatchdog:
    """Flag steps slower than mean + k*sigma (Welford online stats)."""

    def __init__(self, min_steps: int = 10, k_sigma: float = 3.0):
        self.min_steps = min_steps
        self.k_sigma = k_sigma
        self.n = 0
        self.mean_step = 0.0
        self._m2 = 0.0
        self.straggler_events = 0

    @property
    def std(self) -> float:
        if self.n < 2:
            return 0.0
        return math.sqrt(self._m2 / (self.n - 1))

    def record(self, dt: float) -> bool:
        """Record one step time; True if it is a straggler step."""
        flagged = False
        if self.n >= self.min_steps:
            # relative sigma floor: a zero-variance warmup (coarse timer,
            # fully deterministic steps) must not flag every later step
            floor = max(self.std, 0.05 * abs(self.mean_step), 1e-9)
            limit = self.mean_step + self.k_sigma * floor
            if dt > limit:
                self.straggler_events += 1
                flagged = True
                # winsorize the outlier into the stats: a single spike
                # barely moves the band, but a sustained regime change
                # (longer seqs, new curriculum) walks the mean up until
                # the watchdog stops flagging the new normal
                dt = limit
        self.n += 1
        delta = dt - self.mean_step
        self.mean_step += delta / self.n
        self._m2 += delta * (dt - self.mean_step)
        return flagged


def retry_step(fn: Callable, max_retries: int = 3,
               backoff_s: float = 0.5) -> Callable:
    """Retry ``fn`` on exception, exponential backoff between attempts."""

    def wrapped(*args, **kwargs):
        attempts = 1 + max(0, int(max_retries))  # retries AFTER attempt 1
        for attempt in range(attempts):
            try:
                return fn(*args, **kwargs)
            except Exception:
                if attempt == attempts - 1:
                    raise
                if backoff_s > 0:
                    time.sleep(backoff_s * (2 ** attempt))

    return wrapped
