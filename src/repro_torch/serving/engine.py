"""Batched serving engine for compiled logic networks (the paper's
inference product): micro-batched classification with a latency
deadline, behind the ``repro_torch.serve`` scheduler.

The reference package's ``LMEngine`` (continuous-batching LM decode) is
still to port.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.logic_infer import (LogicNetwork, argmax_labels,
                                          classify)
from repro_torch.device import DeviceLike, resolve_device

BACKENDS = ("gather", "lut_layer", "bitplane")


@dataclasses.dataclass
class LogicEngine:
    """Micro-batching frontend over a compiled LogicNetwork.

    ``backend`` selects the inference representation (reference name in
    brackets):
      * ``"gather"``                   — per-neuron truth-table gathers
        in plain torch (the oracle);
      * ``"lut_layer"`` [``"pallas"``] — the same tables through the
        lut_layer kernel;
      * ``"bitplane"``                 — the mapped 6-LUT netlist run as
        packed bitplane ops (32 samples per 32-bit lane).
    Argmax outputs are identical across backends.

    For the bitplane backend, ``engine`` names a netlist executor in the
    ``repro_torch.synth.executors`` registry: ``"numpy"`` (host fold),
    ``"cuda"`` (monolithic ``lut_eval`` kernel) or ``"cuda-streamed"``
    (streamed ``lut_eval_streamed`` kernel). Left unset it is
    ``"cuda-streamed"`` on a CUDA device and ``"numpy"`` on the CPU.

    ``device`` defaults to ``"cuda"`` and raises without a card;
    ``device="cpu"`` runs every kernel's plain torch version.
    """

    net: LogicNetwork
    n_classes: int
    max_batch: int = 256
    max_wait_ms: float = 0.2
    backend: str = "gather"
    engine: Optional[str] = None        # bitplane netlist executor
    synth_effort: int = 1
    device: DeviceLike = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.backend == "bitplane":
            from repro_torch.serve.aggregate import BitplaneAggregator
            from repro_torch.synth import compile_logic_network
            self.bitnet = compile_logic_network(
                self.net, effort=self.synth_effort, engine=self.engine,
                device=self.device)
            self.engine = self.bitnet.engine
            # padded aggregator: one batch shape for every flush size
            self._agg = BitplaneAggregator(self.bitnet, self.n_classes,
                                           pad_rows=self.max_batch)
            return
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown LogicEngine backend {self.backend!r} "
                             f"(expected one of {BACKENDS})")
        # first call at the serving batch size (builds the kernels)
        self._dense(np.zeros((self.max_batch, self.net.n_inputs),
                             np.float32))

    @property
    def aggregator(self):
        """The bitplane backend's ``BitplaneAggregator`` (the scheduler
        executor it hands out, with the ``on_device_us`` hook and the
        occupancy ``publish``); ``None`` for the dense backends."""
        return self._agg if self.backend == "bitplane" else None

    def _pad(self, x: np.ndarray) -> np.ndarray:
        """Zero rows up to ``max_batch``: one batch shape for every flush."""
        pad = self.max_batch - x.shape[0]
        if pad:
            x = np.concatenate([x, np.zeros((pad, x.shape[1]), x.dtype)])
        return x

    def _dense(self, x: np.ndarray) -> np.ndarray:
        """gather / lut_layer: (max_batch, F) -> (max_batch,) int32."""
        xt = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        labels = classify(self.net, xt, self.n_classes,
                          use_kernel=self.backend == "lut_layer")
        return labels.to(torch.int32).cpu().numpy()

    def exec_batch(self, x: np.ndarray) -> np.ndarray:
        """One evaluation: (B <= max_batch, F) -> (B,) int32 argmax.

        The dense backends pad to ``max_batch`` rows; the bitplane
        aggregator pads the same way (``pad_rows``)."""
        x = np.asarray(x)
        n = x.shape[0]
        if n > self.max_batch:
            raise ValueError(f"batch of {n} rows exceeds max_batch "
                             f"{self.max_batch}")
        if self.backend == "bitplane":
            return np.asarray(self._agg(x))
        return self._dense(self._pad(x))[:n]

    def stages(self, x: np.ndarray) -> Dict[str, Callable[[], Any]]:
        """One ``exec_batch`` of ``x`` split into its stages, for
        profiling: stage name -> zero-argument callable, in order.

        Each callable reruns its stage on what the stage before it
        produced for ``x`` (computed once here); the last one returns
        ``exec_batch(x)``'s labels. The bitplane backend needs a device
        engine (``"cuda"``, ``"cuda-streamed"``): the numpy engine folds
        on the host in one step."""
        x = np.asarray(x)
        n = x.shape[0]
        if self.backend == "bitplane":
            ex = self.bitnet.executor
            if not hasattr(ex, "eval_words"):
                raise ValueError(f"engine {self.engine!r} has no device "
                                 f"stages")
            words = self._agg.pack_requests(x)
            out = ex.eval_words(words)
            return {"quantize+pack": lambda: self._agg.pack_requests(x),
                    "netlist kernel": lambda: ex.eval_words(words),
                    "decode+argmax+copy": lambda: ex.labels(
                        out, n, self.n_classes).cpu().numpy()}
        net, use_kernel = self.net, self.backend == "lut_layer"
        xp = self._pad(x)

        def quantize():
            return net.quantize_inputs(torch.as_tensor(
                xp, dtype=torch.float32, device=self.device))

        def decode():
            labels = argmax_labels(net, out, self.n_classes)[:n]
            return labels.to(torch.int32).cpu().numpy()

        codes = quantize()
        out = net.apply_codes(codes, use_kernel=use_kernel)
        return {"host->device+quantize": quantize,
                "tables": lambda: net.apply_codes(codes,
                                                  use_kernel=use_kernel),
                "decode+argmax+copy": decode}

    def classify(self, x: np.ndarray) -> np.ndarray:
        """Synchronous batched classification."""
        n = x.shape[0]
        out = np.empty((n,), np.int32)
        for i in range(0, n, self.max_batch):
            xb = x[i: i + self.max_batch]
            out[i: i + xb.shape[0]] = self.exec_batch(xb)
        return out

    def scheduler_executor(self) -> Callable[[np.ndarray], np.ndarray]:
        """Executor callable for ``repro_torch.serve`` schedulers.

        The bitplane backend aggregates the batch's requests into 32-bit
        lanes and evaluates the mapped netlist once per pack; the dense
        backends run one padded evaluation. All return identical
        argmaxes. The executor advertises ``n_features`` so the
        scheduler rejects wrong-width payloads at admission.
        """
        if self.backend == "bitplane":
            return self._agg            # BitplaneAggregator: has n_features

        def ex(x: np.ndarray) -> np.ndarray:
            return self.exec_batch(x)

        ex.n_features = self.net.n_inputs
        return ex

    def serve_queue(self, requests: List[np.ndarray], clock=None,
                    deadline_us: Optional[float] = None,
                    lane_slo_us: Optional[Tuple[float, ...]] = None,
                    tracer=None
                    ) -> Tuple[List[np.ndarray], Dict[str, float]]:
        """Micro-batched serving of a request list; returns per-request
        results + latency stats (p50/p95/p99/mean, µs).

        All requests are admitted up front and drained through the
        micro-batch scheduler, so the reported latencies are true
        enqueue→complete times. ``deadline_us`` gives every request
        that latency budget; ``lane_slo_us`` installs the per-lane SLO
        table instead. Requests past their budget at flush time are shed
        (a ``None`` in the results list).
        """
        from repro_torch.serve import (MicroBatchScheduler, RequestRejected,
                                       SchedConfig)

        cfg = SchedConfig(max_batch=self.max_batch,
                          max_wait_us=self.max_wait_ms * 1e3,
                          max_queue=max(2 * len(requests), 1),
                          n_priorities=1, lane_slo_us=lane_slo_us)
        sched = MicroBatchScheduler(self.scheduler_executor(), cfg,
                                    clock=clock, tracer=tracer)
        futs: List[Any] = []
        for r in requests:
            r = np.asarray(r)
            if r.ndim > 1 and r.shape[0] > self.max_batch:
                futs.append([sched.submit(r[i: i + self.max_batch],
                                          deadline_us=deadline_us)
                             for i in range(0, r.shape[0], self.max_batch)])
            else:
                futs.append(sched.submit(r, deadline_us=deadline_us))
        sched.drain()

        def _res(f):
            try:
                return np.asarray(f.result())
            except RequestRejected:
                return None                 # shed past its deadline

        results = []
        for f in futs:
            if isinstance(f, list):
                parts = [_res(p) for p in f]
                results.append(None if any(p is None for p in parts)
                               else np.concatenate(parts))
            else:
                results.append(_res(f))
        snap = sched.metrics.snapshot()
        stats = {k: snap[k] for k in
                 ("p50_us", "p95_us", "p99_us", "mean_us", "qps",
                  "mean_batch_occupancy", "n_batches",
                  "deadline_miss_rate", "shed")}
        return results, stats
