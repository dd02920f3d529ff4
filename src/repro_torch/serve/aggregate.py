"""Bitplane request aggregation: concurrent requests fill uint32 lanes.

``repro_torch.synth``'s executor packs 32 *samples* per word and
evaluates the whole mapped 6-LUT netlist once per pack. Here the lanes
are filled with 32 concurrent *requests* instead: the scheduler's batch
(row-concatenated request payloads) is quantized to input codes, each
code bit scattered into its wire's bitplane with request r in bit r%32
of word r//32, and one netlist evaluation over the precompiled plan
serves the entire pack — the paper's bit-level parallelism turned
into a request-throughput mechanism. Per-request argmaxes are sliced
back out of the output planes, bit-identical to ``classify`` on the
gather and lut_layer paths.

The netlist executor is whatever engine the ``BitplaneNetwork`` was
built with (``repro_torch.synth.executors`` registry): under the device
engines (``"cuda"``, ``"cuda-streamed"``) the batch is quantized and
packed on the card, the packed words go straight to the kernel and only
the argmax labels come back to the host. The numpy engine keeps the
host fold (``execute_packed``) + decode. Aggregation itself is
engine-agnostic; ``pack_inputs`` and ``classify_packed`` dispatch.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.obs.trace import NULL_TRACER
from repro_torch.synth.executor import BitplaneNetwork
from repro_torch.synth.simulate import WORD_BITS


class BitplaneAggregator:
    """Scheduler executor: one netlist evaluation per request pack.

    Satisfies the ``MicroBatchScheduler`` executor contract
    ``(B, n_features) -> (B,)``; every 32 rows of the batch share one
    uint32 lane-word through the whole netlist.

    Not thread-safe by design — the scheduler serializes executor calls
    on one dispatch thread, so the ``n_*`` counters need no lock and
    carry no ``_GUARDED_BY`` annotation. Wrap in ``ReplicaSet`` for
    concurrent dispatch.
    """

    def __init__(self, bitnet: BitplaneNetwork, n_classes: int,
                 pad_rows: Optional[int] = None):
        self.bitnet = bitnet
        self.n_classes = n_classes
        self.lanes_per_word = WORD_BITS
        self.pad_rows = pad_rows
        self.tracer = NULL_TRACER
        # online-profiling hook: called with (measured device µs, rows)
        # after each netlist evaluation when set
        self.on_device_us: Optional[callable] = None
        self.n_features = bitnet.net.n_inputs   # admission width check
        self.n_evals = 0            # lane-words carrying >= 1 real request
        self.n_rows = 0             # request rows served
        self.n_pad_rows = 0         # shape-stability padding rows added
        self.n_partial_packs = 0    # flushes whose last lane-word is partial
        if pad_rows:                # warm the single quantizer shape
            self(np.zeros((1, bitnet.net.n_inputs), np.float32))
            self.n_evals = self.n_rows = 0
            self.n_pad_rows = self.n_partial_packs = 0

    def pack_requests(self, x: np.ndarray):
        """(B, n_features) real inputs -> (n_pi_wires, ceil(B/32)) words
        (a tensor on the engine's device, or uint32 numpy words for the
        numpy engine).

        With ``pad_rows`` set, short batches are zero-padded to that row
        count first, so every flush quantizes and packs one batch shape.
        """
        bn = self.bitnet
        if self.pad_rows and x.shape[0] < self.pad_rows:
            x = np.concatenate(
                [x, np.zeros((self.pad_rows - x.shape[0], x.shape[1]),
                             x.dtype)])
        return bn.pack_inputs(x)

    def __call__(self, x: np.ndarray,
                 deadline_us: Optional[float] = None) -> np.ndarray:
        """Evaluate one request pack. ``deadline_us`` (the tightest
        absolute SLO deadline in the batch, forwarded by the scheduler)
        is what triggers partial-pack flushes upstream: the scheduler
        dispatches before the lane-word is full whenever that deadline
        cannot absorb further fill-wait, and ``n_partial_packs`` counts
        how often the pack went out with idle lanes as a result."""
        x = np.asarray(x)
        true_rows = x.shape[0]
        with self.tracer.span("aggregate_pack", cat="pack", args={
                "rows": true_rows,
                "lane_words": -(-true_rows // self.lanes_per_word)}):
            pi_words = self.pack_requests(x)
        # engine dispatch happens inside classify_packed: the device
        # engines run the kernel on the packed words and return only the
        # per-request argmax; numpy is the host fold + decode.
        if self.on_device_us is not None:
            # timed with wall perf_counter, not the tracer clock: the
            # profiler wants real device µs even under a FakeClock
            import time
            t0 = time.perf_counter()
            with self.tracer.span("device_exec", cat="exec", args={
                    "rows": true_rows, "engine": self.bitnet.engine}):
                labels = self.bitnet.classify_packed(pi_words, true_rows,
                                                     self.n_classes)
            self.on_device_us((time.perf_counter() - t0) * 1e6, true_rows)
        else:
            with self.tracer.span("device_exec", cat="exec", args={
                    "rows": true_rows, "engine": self.bitnet.engine}):
                labels = self.bitnet.classify_packed(pi_words, true_rows,
                                                     self.n_classes)
        # occupancy is accounted against *real* request rows: lane-words
        # that exist only because of pad_rows shape-stability padding
        # are tracked separately, not counted as served capacity.
        self.n_evals += -(-true_rows // self.lanes_per_word)
        self.n_rows += true_rows
        if self.pad_rows and true_rows < self.pad_rows:
            self.n_pad_rows += self.pad_rows - true_rows
        if true_rows % self.lanes_per_word:
            self.n_partial_packs += 1
        return labels

    def set_tracer(self, tracer) -> None:
        """Adopt ``tracer`` (propagated to the underlying network so
        device spans nest inside ``device_exec``); the scheduler calls
        this automatically when constructed with one."""
        self.tracer = tracer
        self.bitnet.tracer = tracer

    def stats(self) -> dict:
        occ = self.mean_lane_occupancy
        return {"n_evals": self.n_evals, "n_rows": self.n_rows,
                "n_pad_rows": self.n_pad_rows,
                "n_partial_packs": self.n_partial_packs,
                "engine": self.bitnet.engine,
                "mean_lane_occupancy": occ}

    def publish(self, registry, name: str = "aggregate") -> None:
        """Expose the occupancy counters through a metrics registry's
        snapshot provider (``registry.register(name, fn)``)."""
        registry.register(name, self.stats)

    @property
    def mean_lane_occupancy(self) -> Optional[float]:
        """Fraction of uint32 lanes (in lane-words carrying at least one
        real request) filled by a real request; shape-stability pad rows
        are excluded (see ``n_pad_rows``)."""
        if self.n_evals == 0:
            return None
        return self.n_rows / (self.n_evals * self.lanes_per_word)
