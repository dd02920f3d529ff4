"""Batched serving engines.

Two request kinds, as in the reference:
  * LogicEngine — ultra-low-latency classification through the compiled
    fixed-function logic network (the paper's product): micro-batched
    with a latency deadline, behind the ``repro_torch.serve`` scheduler;
  * LMEngine    — autoregressive decode with a shared KV cache pool:
    continuous batching over slots (admit on free slot, retire on EOS /
    max tokens), prefill attention through the flash kernel on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

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


# ---------------------------------------------------------------------------
# LM serving (continuous batching decode)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LMRequest:
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int = 16
    eos_id: int = -1            # -1 = never
    out_tokens: Optional[List[int]] = None


_LM_CACHE_LEAVES = ("k", "v", "positions", "ssm", "conv", "enc_out")


class LMEngine:
    """Continuous-batching decode over a fixed slot pool.

    Slots admit requests as they free up; one ``decode_step`` advances
    every slot each tick (inactive slots carry their last token, their
    outputs are discarded): the decode batch is static and occupancy
    varies. Each admission runs ``prefill`` on its prompt alone and
    splices its cache into the admitted slot of the pool, in place. As
    in the reference, admission passes no ``enc_embeds``, so an
    encoder-decoder model fails there (``ValueError``); its served path
    is ``lm.prefill(..., enc_embeds=)`` and ``lm.decode_step``.
    Greedy decoding; the argmax runs over the padded vocabulary, as in
    the reference.

    Admission sits behind the ``repro_torch.serve`` bounded priority
    queue: ``submit`` enqueues with a priority lane and raises a typed
    ``RequestRejected`` when ``max_pending`` is hit (backpressure), and
    freed slots always admit the highest-priority waiter first.

    ``params`` (``repro_torch.models.lm.Params``) move to ``device``
    (default ``"cuda"``, which raises without a card), and their weight
    matrices are cast to the compute type in place
    (``lm.cast_weights_``); the module stays a valid input to ``lm``'s
    functions with the same results. Everything runs under
    ``torch.inference_mode()``.

    The process-wide program tracer (``obs.trace.program_tracer()``)
    gets ``engine.prefill {S}`` around each admission's prefill and
    ``engine.decode {active, ctx, slots}`` around each decode step, both
    with device intervals. Every future is stamped from the engine's
    clock at enqueue, admission (``t_admit_us``), first token
    (``t_first_token_us``) and completion; after each admission the
    tracer gets an ``engine.first_token`` instant whose args are the
    differences ``queue_wait_us`` (admission - enqueue) and
    ``first_token_us`` (first token - enqueue).
    """

    def __init__(self, cfg, params, n_slots: int = 4, max_seq: int = 512,
                 max_pending: Optional[int] = None, n_priorities: int = 2,
                 clock=None, device: DeviceLike = None):
        from repro_torch.models import lm
        from repro_torch.serve.clock import SystemClock
        from repro_torch.serve.sched import BoundedPriorityQueue

        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = lm.cast_weights_(cfg, params.to(self.device))
        self.clock = clock or SystemClock()
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.cache = lm.init_cache(cfg, n_slots, max_seq, device=self.device)
        self.positions = np.zeros((n_slots,), np.int32)
        self.active: List[Optional[LMRequest]] = [None] * n_slots
        self.last_tok = np.zeros((n_slots, 1), np.int32)
        self.admission = BoundedPriorityQueue(
            max_pending if max_pending is not None else (1 << 30),
            n_priorities)

    def submit(self, req: LMRequest, priority: int = 0,
               deadline_us: Optional[float] = None):
        """Admit into the priority queue (typed reject when full).

        ``deadline_us`` is a queueing budget (µs from enqueue): a
        request still waiting for a decode slot past its budget is shed
        with a typed ``RequestRejected(DEADLINE_EXCEEDED)`` on its
        future instead of being admitted late.

        Returns the request's ``ServeFuture``: resolved with the
        finished ``LMRequest`` by ``run``, with enqueue→complete
        latency on ``fut.latency_us``.
        """
        import math

        from repro_torch.serve.sched import ServeFuture, ServeRequest

        fut = ServeFuture()
        fut.t_enqueue_us = self.clock.now_us()
        self.admission.push(ServeRequest(
            x=req, rows=1, priority=priority,
            t_enqueue_us=fut.t_enqueue_us, future=fut,
            deadline_us=(fut.t_enqueue_us + deadline_us
                         if deadline_us is not None else math.inf)))
        return fut

    @staticmethod
    def _splice_slot(cache: Dict[str, torch.Tensor],
                     single: Dict[str, torch.Tensor], slot: int) -> None:
        """Write ONE admitted slot of the pooled cache in place: the
        slot's rows of every leaf, O(layers x window) writes."""
        for key, pool in cache.items():
            s = single[key]
            if key in ("k", "v"):            # (L, B, W, KV, dh)
                w = min(s.shape[2], pool.shape[2])
                pool[:, slot].zero_()
                pool[:, slot, :w] = s[:, 0, :w]
            elif key == "positions":          # (B, W)
                w = min(s.shape[1], pool.shape[1])
                pool[slot].fill_(-1)
                pool[slot, :w] = s[0, :w]
            elif key in ("ssm", "conv"):      # (L, B, ...)
                pool[:, slot] = s[:, 0]
            else:                             # enc_out (B, F, D)
                pool[slot] = s[0]

    def _admit(self, req: LMRequest, slot: int):
        from repro_torch.models import lm
        from repro_torch.obs.trace import NULL_SPAN, program_tracer

        tr = program_tracer()
        s = len(req.prompt)
        toks = torch.as_tensor(np.asarray(req.prompt, np.int32)[None, :],
                               device=self.device)
        with (tr.span("engine.prefill", args={"S": s}, device=self.device)
              if tr.enabled else NULL_SPAN):
            logits, cache1 = lm.prefill(self.cfg, self.params, toks,
                                        max_seq=self.max_seq)
        for key in cache1:
            if key not in _LM_CACHE_LEAVES:
                raise KeyError(f"unknown cache leaf {key}")
        # splice only the admitted slot (ring slot layouts agree because
        # prefill sizes its ring for the pool's max_seq)
        self._splice_slot(self.cache, cache1, slot)
        req.out_tokens = []
        self.active[slot] = req
        self.positions[slot] = s
        self.last_tok[slot, 0] = int(torch.argmax(logits[0]))
        req.out_tokens.append(int(self.last_tok[slot, 0]))

    def _decode_args(self) -> Dict[str, int]:
        """The decode step's work: active slots, their summed context
        (each slot's position + 1) and the pool's slots."""
        ctx = [int(self.positions[i]) + 1 for i in range(self.n_slots)
               if self.active[i] is not None]
        return {"active": len(ctx), "ctx": sum(ctx), "slots": self.n_slots}

    def run(self, requests: Sequence[LMRequest] = ()) -> List[LMRequest]:
        """Decode until the admission queue and all slots are empty.

        ``requests`` are submitted at priority 0 before the loop;
        callers using ``submit`` directly can pass nothing.
        """
        from repro_torch.models import lm
        from repro_torch.obs.trace import NULL_SPAN, program_tracer
        from repro_torch.serve.sched import RejectReason, RequestRejected

        for r in requests:
            self.submit(r)
        done: List[LMRequest] = []
        sreqs: List[Optional[Any]] = [None] * self.n_slots
        tr = program_tracer()
        with torch.inference_mode():
            while len(self.admission) or any(a is not None
                                             for a in self.active):
                # shed waiters whose queueing budget expired before a
                # slot freed up
                now_us = self.clock.now_us()
                for expired in self.admission.shed_expired(now_us):
                    expired.future.t_done_us = now_us
                    expired.future.set_exception(RequestRejected(
                        RejectReason.DEADLINE_EXCEEDED,
                        f"expired {now_us - expired.deadline_us:.0f} µs "
                        f"before a decode slot freed"))
                # admit, highest priority lane first
                for i in range(self.n_slots):
                    if self.active[i] is None and len(self.admission):
                        (sreq,) = self.admission.pop_batch(1)
                        sreqs[i] = sreq
                        fut = sreq.future
                        fut.t_admit_us = self.clock.now_us()
                        self._admit(sreq.x, i)
                        fut.t_first_token_us = self.clock.now_us()
                        if tr.enabled:
                            tr.instant("engine.first_token", args={
                                "queue_wait_us": (fut.t_admit_us
                                                  - fut.t_enqueue_us),
                                "first_token_us": (fut.t_first_token_us
                                                   - fut.t_enqueue_us)})
                # decode tick
                with (tr.span("engine.decode", args=self._decode_args(),
                              device=self.device)
                      if tr.enabled else NULL_SPAN):
                    logits, self.cache = lm.decode_step(
                        self.cfg, self.params, self.cache,
                        torch.as_tensor(self.last_tok, device=self.device),
                        torch.as_tensor(self.positions, device=self.device))
                nxt = logits.argmax(-1).cpu().numpy()
                for i in range(self.n_slots):
                    req = self.active[i]
                    if req is None:
                        continue
                    tok = int(nxt[i])
                    req.out_tokens.append(tok)
                    self.positions[i] += 1
                    self.last_tok[i, 0] = tok
                    if (tok == req.eos_id
                            or len(req.out_tokens) >= req.max_new_tokens
                            or self.positions[i] >= self.max_seq - 1):
                        done.append(req)
                        self.active[i] = None
                        if sreqs[i] is not None:
                            sreqs[i].future.t_done_us = self.clock.now_us()
                            sreqs[i].future.set_result(req)
                            sreqs[i] = None
        return done
