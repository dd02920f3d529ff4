"""N-replica dispatch: round-robin / least-loaded / least-slack over
engine replicas.

A ``ReplicaSet`` is itself a scheduler executor — it picks a healthy
replica per batch, retries the batch on the next replica when one
raises (failover), and only surfaces an error once every replica is
down. It accepts the scheduler's ``deadline_us`` (the tightest absolute
SLO deadline in the batch): the ``least_slack`` policy routes to the
replica with the smallest expected completion time (in-flight load x
smoothed per-replica execution time — the choice that preserves the
most slack), and on failover the remaining budget is re-stamped — if
the deadline passed while a replica was failing, the retry is abandoned
with a typed ``RequestRejected(DEADLINE_EXCEEDED)`` instead of burning
another replica on a result nobody can use.

Replicas are data-parallel copies of the serving function. In the port
each one is its own ``LogicEngine`` on one resolved device: on a card,
independent engines (own synthesized netlist, own plan tensors) that
the scheduler's one dispatch thread drives in turn. The reference's
mesh placement (``mesh_placed``, a no-op without a mesh) waits for the
port of ``repro.dist``.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.obs.trace import NULL_TRACER

from .clock import SystemClock
from .sched import RejectReason, RequestRejected


class AllReplicasDown(RuntimeError):
    pass


@dataclasses.dataclass
class Replica:
    fn: Callable[[np.ndarray], np.ndarray]
    rid: int
    healthy: bool = True
    inflight: int = 0
    served: int = 0
    failures: int = 0
    ewma_us: float = 0.0            # smoothed per-batch execution time
    ewma_seeded: bool = False       # calibrated seed in ewma_us (keep it)


class ReplicaSet:
    """Dispatch policy over replica callables (``policy``: ``"rr"`` |
    ``"least_loaded"`` | ``"least_slack"``)."""

    # the round-robin cursor is shared by every dispatching thread
    _GUARDED_BY = {"_rr": "_lock"}

    def __init__(self, fns: Sequence[Callable], policy: str = "rr",
                 clock=None, n_features: Optional[int] = None,
                 exec_seed_us: Optional[float] = None):
        if policy not in ("rr", "least_loaded", "least_slack"):
            raise ValueError(f"unknown dispatch policy {policy!r}")
        assert len(fns) >= 1
        self.replicas = [Replica(fn=f, rid=i) for i, f in enumerate(fns)]
        if exec_seed_us is not None:
            # calibrated per-batch execution estimate (kernelprof
            # LatencyTable) — least_slack starts informed instead of
            # treating every replica as free until its first batch
            for r in self.replicas:
                r.ewma_us = float(exec_seed_us)
                r.ewma_seeded = True
        self.policy = policy
        self.clock = clock or SystemClock()
        self.tracer = NULL_TRACER
        if n_features is None:      # propagate the width admission check
            n_features = next(
                (getattr(f, "n_features") for f in fns
                 if getattr(f, "n_features", None) is not None), None)
        self.n_features = n_features
        self._rr = 0
        self._lock = threading.Lock()

    def _pick(self) -> Optional[Replica]:
        with self._lock:
            healthy = [r for r in self.replicas if r.healthy]
            if not healthy:
                return None
            if self.policy == "least_loaded":
                r = min(healthy, key=lambda r: (r.inflight, r.rid))
            elif self.policy == "least_slack":
                # expected completion = queued-behind work x smoothed
                # exec time; the replica minimizing it eats the least of
                # the batch's remaining deadline budget
                r = min(healthy, key=lambda r: ((r.inflight + 1) * r.ewma_us,
                                                r.inflight, r.rid))
            else:
                r = healthy[self._rr % len(healthy)]
                self._rr += 1
            r.inflight += 1
            return r

    def reseed_exec_estimate(self, us: float) -> None:
        """Re-seed every replica's execution-time EWMA with a fresher
        calibration (the online profiler's blended live estimate);
        per-replica measurements keep blending in on top."""
        with self._lock:
            for r in self.replicas:
                r.ewma_us = float(us)
                r.ewma_seeded = True

    def mark_down(self, rid: int) -> None:
        with self._lock:
            self.replicas[rid].healthy = False

    def mark_up(self, rid: int) -> None:
        with self._lock:
            self.replicas[rid].healthy = True

    def __call__(self, x: np.ndarray,
                 deadline_us: Optional[float] = None) -> np.ndarray:
        """Run one batch with failover: a raising replica is marked down
        and the batch retried elsewhere — unless ``deadline_us`` (the
        batch's tightest absolute deadline) has already passed, in which
        case the retry is shed with a typed reject."""
        last_exc: Optional[BaseException] = None
        for attempt in range(len(self.replicas)):
            if (attempt > 0 and deadline_us is not None
                    and math.isfinite(deadline_us)
                    and self.clock.now_us() > deadline_us):
                # failover budget re-stamp: the failed attempt consumed
                # the whole budget — reject instead of serving late
                raise RequestRejected(
                    RejectReason.DEADLINE_EXCEEDED,
                    f"budget exhausted during failover (attempt "
                    f"{attempt + 1})") from last_exc
            r = self._pick()
            if r is None:
                break
            t0 = self.clock.now_us()
            try:
                with self.tracer.span("replica_dispatch", cat="dispatch",
                                      args={"rid": r.rid,
                                            "attempt": attempt,
                                            "policy": self.policy}):
                    out = r.fn(x)
                dt = self.clock.now_us() - t0
                with self._lock:
                    r.inflight -= 1
                    r.served += 1
                    # first real measurement replaces a cold 0.0 but
                    # only blends into a calibrated kernelprof seed
                    r.ewma_us = (dt if r.served == 1 and not r.ewma_seeded
                                 else 0.8 * r.ewma_us + 0.2 * dt)
                return out
            except Exception as e:
                last_exc = e
                with self._lock:
                    r.inflight -= 1
                    r.failures += 1
                    r.healthy = False
                self.tracer.instant("replica_failover", cat="dispatch",
                                    args={"rid": r.rid,
                                          "error": type(e).__name__})
        raise AllReplicasDown(
            f"no healthy replica left (of {len(self.replicas)})"
        ) from last_exc

    def set_tracer(self, tracer) -> None:
        """Adopt ``tracer``; replica callables that themselves support
        ``set_tracer`` (e.g. aggregators) are wired through too, so
        device spans nest inside ``replica_dispatch``."""
        self.tracer = tracer
        for r in self.replicas:
            if hasattr(r.fn, "set_tracer"):
                r.fn.set_tracer(tracer)

    def stats(self) -> List[dict]:
        with self._lock:
            return [{"rid": r.rid, "healthy": r.healthy, "served": r.served,
                     "failures": r.failures, "inflight": r.inflight,
                     "ewma_us": r.ewma_us, "ewma_seeded": r.ewma_seeded}
                    for r in self.replicas]

    def publish(self, registry, name: str = "replicas") -> None:
        """Expose per-replica dispatch stats through a
        ``repro_torch.obs.MetricsRegistry`` snapshot provider."""
        registry.register(
            name, lambda: {"policy": self.policy, "replicas": self.stats()})


# ---------------------------------------------------------------------------
# logic-engine replicas
# ---------------------------------------------------------------------------

def build_logic_replicas(net, n_classes: int, n_replicas: int = 1,
                         backend: str = "gather", max_batch: int = 256,
                         policy: str = "rr", engine: Optional[str] = None,
                         exec_seed_us: Optional[float] = None,
                         device=None) -> ReplicaSet:
    """Data-parallel ``LogicEngine`` replicas behind one dispatch point.

    Each replica owns its own engine (own synthesized netlist and plan
    tensors) on ``device`` (``resolve_device``: the card unless the CPU
    is asked for). ``engine`` selects the bitplane backend's netlist
    executor (``LogicEngine``'s default when None). ``exec_seed_us``
    seeds every replica's execution-time EWMA with a calibrated
    kernelprof estimate.
    """
    from repro_torch.device import resolve_device
    from repro_torch.serving.engine import LogicEngine

    dev = resolve_device(device)
    fns = [LogicEngine(net, n_classes, max_batch=max_batch,
                       backend=backend, engine=engine,
                       device=dev).scheduler_executor()
           for _ in range(n_replicas)]
    return ReplicaSet(fns, policy=policy, n_features=net.n_inputs,
                      exec_seed_us=exec_seed_us)
