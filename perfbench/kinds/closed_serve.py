"""Served cells: a closed loop of clients around the port's ``LMEngine``.

Each of ``clients`` clients sends its next request (``traffic.RequestPool``,
greedy, no EOS) as soon as its last one completes. ``LMEngine.run``
takes no arrivals while it runs, so the loop rides on the engine's
injectable clock: the engine reads it at the top of every tick and at
every completion, and the harness's clock, guarded against re-entry,
then finds the futures that have completed and submits those clients'
next requests before the tick admits. An outer loop around ``run()``
restarts the engine if its queue and slots ever empty. The engine
behaviour this depends on is listed in PERF.md.

Set-up makes the weights from the seed in the served type, builds the
engine, prefills one request of every prompt length in the mix's pool,
then runs the loop for ``prewarm_s``. The window follows for
``seconds``: tokens generated in it (those of requests still running
read at its close), and the 95th percentile of send-to-completion time
(``fut.latency_us``) over every request completed in it. At the close
the clock stops the engine. Traced, ``trace_ticks`` decode ticks a third
of the way in are profiled, with ``lm.prefill`` and ``lm.decode_step``
(looked up by the engine at call time) wrapped in ``perfbench:`` spans
that carry each call's work. After the window the engine is freed and
the reference reads, for a sample of the completed requests drawn from
the seed, the longest among them and no two served in one slot, every
served token's gap below its best logit.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import checks, harness, traffic, weights
from perfbench.reference import dense_decoder as ref


class WindowClosed(Exception):
    """Raised by the clock at the window's close to stop the engine."""


class ClosedLoop:
    """The clients, the engine's clock and the window's bookkeeping."""

    def __init__(self, r: harness.Run, pool: traffic.RequestPool):
        self.r, self.pool = r, pool
        self.engine = None
        self.inflight: Dict[int, tuple] = {}      # client -> (req, fut)
        self.done: List[dict] = []
        self.done_tokens = 0
        self.phase = "warmup"         # warmup, prewarm, window, closed
        self.t_prewarm_end = self.t_start = self.t_end = None
        self.tokens_at_start = self.tokens_at_end = None
        self.busy = False
        self.tracer = None                        # called each clock read
        self.slot_of: Dict[int, int] = {}         # id(req) -> its slot
        self.ticks = 0                            # decode steps so far
        self.ticks_at_start = self.ticks_at_end = None

    # the engine's clock -------------------------------------------------
    def now_us(self) -> float:
        now = time.perf_counter()
        if not self.busy and self.phase != "warmup":
            self.busy = True
            try:
                self._tick(now)
            finally:
                self.busy = False
        return now * 1e6

    def _tick(self, now: float) -> None:
        for c, (req, fut) in list(self.inflight.items()):
            if fut.done():
                del self.inflight[c]
                self._complete(req, fut)
                if self.phase != "closed":
                    self.submit(c)
        if self.phase == "prewarm" and now >= self.t_prewarm_end:
            self.phase = "window"
            if self.r.device.type == "cuda":
                torch.cuda.synchronize(self.r.device)
            self.r.phase("prewarm")
            self.t_start = self.r.window_opens()
            self.tokens_at_start = self.tokens()
            self.ticks_at_start = self.ticks
        elif self.phase == "window" and now >= self.t_start + self.r.seconds:
            self.t_end = now
            self.tokens_at_end = self.tokens()
            self.ticks_at_end = self.ticks
            self.phase = "closed"
            raise WindowClosed
        if self.tracer is not None:
            self.tracer(now)

    # clients --------------------------------------------------------------
    def submit(self, client: int) -> None:
        from repro_torch.serving.engine import LMRequest
        j, n = self.pool.take()
        req = LMRequest(self.pool.prompt(j), max_new_tokens=n, eos_id=-1)
        self.inflight[client] = (req, self.engine.submit(req))

    def _complete(self, req, fut) -> None:
        try:
            fut.result(0)
            ok = True
        except Exception:   # a rejected or failed request counts as missing
            ok = False
        n = len(req.out_tokens or ())
        self.done_tokens += n
        self.done.append({"ok": ok, "t_done": fut.t_done_us * 1e-6,
                          "latency_s": fut.latency_us * 1e-6,
                          "slot": self.slot_of.pop(id(req), None),
                          "prompt": req.prompt, "out": list(req.out_tokens or ())})

    def tokens(self) -> int:
        return self.done_tokens + sum(len(req.out_tokens or ())
                                      for req, _ in self.inflight.values())

    # the loop -------------------------------------------------------------
    def serve(self) -> None:
        """Prewarm, then the window; returns at its close."""
        self.phase = "prewarm"
        self.t_prewarm_end = time.perf_counter() + float(
            self.r.traffic["prewarm_s"])
        for c in range(int(self.r.traffic["clients"])):
            self.submit(c)
        while True:
            try:
                self.engine.run()
            except WindowClosed:
                return
            self.now_us()       # the queue and slots emptied: resubmit

    def watch(self):
        """Count the engine's decode steps and note the slot each request
        is admitted to: ``lm.decode_step`` (looked up by the engine at
        call time) and the engine's ``_admit``, each wrapped in a plain
        call. Returns what undoes it."""
        from repro_torch.models import lm
        eng, orig_step, loop = self.engine, lm.decode_step, self
        orig_admit = eng._admit

        def decode_step(*a, **kw):
            loop.ticks += 1
            return orig_step(*a, **kw)

        def admit(req, slot):
            loop.slot_of[id(req)] = slot
            return orig_admit(req, slot)

        lm.decode_step, eng._admit = decode_step, admit

        def undo():
            lm.decode_step = orig_step
            del eng._admit
        return undo

    def in_window(self) -> List[dict]:
        return [d for d in self.done
                if self.t_start <= d["t_done"] <= self.t_end]


def build_engine(r: harness.Run, loop: ClosedLoop):
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import lm
    from repro_torch.serving.engine import LMEngine
    arch, mix = r.config["arch"], r.traffic
    dtype = getattr(torch, arch.get("compute_dtype", "bfloat16"))
    params = lm.Params(weights.nest(weights.make_all(arch, r.seed, dtype,
                                                     r.device)))
    return LMEngine(ArchConfig(**arch), params, n_slots=int(mix["slots"]),
                    max_seq=int(mix["max_seq"]), clock=loop,
                    device=r.device)


def warm_up(loop: ClosedLoop) -> None:
    """One request of every prompt length in the pool, one new token
    each, so that the window loads no kernel the prefills pick by length
    for the first time."""
    from repro_torch.serving.engine import LMRequest
    lengths = sorted({int(n) for n in loop.pool.prompt_len})
    rng = np.random.default_rng(0)
    loop.engine.run([LMRequest(rng.integers(0, loop.pool.vocab, n).astype(
        np.int32), max_new_tokens=1, eos_id=-1) for n in lengths])


class Tracer:
    """Profiles ``trace_ticks`` decode ticks a third of the way into the
    window, with the engine's model calls wrapped in spans."""

    def __init__(self, loop: ClosedLoop):
        from repro_torch.models import lm
        self.loop, self.lm = loop, lm
        self.prof = self.result = None
        self.ticks = 0
        self.orig = (lm.prefill, lm.decode_step)
        eng = loop.engine

        def prefill(cfg, params, tokens=None, *a, **kw):
            with torch.profiler.record_function(harness.span_name(
                    "prefill", S=int(tokens.shape[1]))):
                return self.orig[0](cfg, params, tokens, *a, **kw)

        def decode_step(cfg, params, cache, tokens, positions):
            ctx = [int(eng.positions[i]) + 1 for i in range(eng.n_slots)
                   if eng.active[i] is not None]
            self.ticks += 1
            with torch.profiler.record_function(harness.span_name(
                    "decode", active=len(ctx), ctx=sum(ctx),
                    slots=eng.n_slots)):
                return self.orig[1](cfg, params, cache, tokens, positions)

        lm.prefill, lm.decode_step = prefill, decode_step

    def restore(self) -> None:
        self.lm.prefill, self.lm.decode_step = self.orig

    def __call__(self, now: float) -> None:
        from repro_torch.kernels import launch_counts
        loop = self.loop
        if loop.phase != "window" or self.result is not None:
            return
        if self.prof is None:
            if now >= loop.t_start + loop.r.seconds / 3:
                self.prof = harness.profiler(loop.r.device)
                self.counts0 = launch_counts()
                self.ticks0 = self.ticks
                self.prof.start()
                self.tp0 = time.perf_counter()
        elif (self.ticks - self.ticks0 >= int(loop.r.traffic["trace_ticks"])
              or now >= loop.t_start + loop.r.seconds - 0.5):
            self.stop()

    def stop(self) -> None:
        from repro_torch.kernels import launch_counts
        if self.prof is not None and self.result is None:
            wall = time.perf_counter() - self.tp0
            self.prof.stop()
            counts = {k: v - self.counts0[k]
                      for k, v in launch_counts().items()}
            self.result = (self.prof, wall, counts, self.ticks - self.ticks0)


def sample(done: List[dict], mix: Dict, seed: int) -> List[dict]:
    """The longest completed request (prompt and output), then others
    drawn from the seed, one a slot, until ``check_served_tokens``
    served tokens in at least ``check_slots`` slots (0 if not given), or
    until every slot has one: a fault in one slot is met by the sample
    in as many slots as the budget reaches."""
    ok = [d for d in done if d["ok"] and d["out"]]
    if not ok:
        return []
    order = np.random.default_rng([int(seed) % (1 << 64), 3]).permutation(
        len(ok))
    longest = max(range(len(ok)),
                  key=lambda i: len(ok[i]["prompt"]) + len(ok[i]["out"]))
    picked, slots, served = [], set(), 0
    budget, least = int(mix["check_served_tokens"]), int(mix.get(
        "check_slots", 0))
    for i in [longest, *[int(i) for i in order if i != longest]]:
        slot = ok[i]["slot"]
        if slot is not None and slot in slots:
            continue
        slots.add(slot)
        picked.append(ok[i])
        served += len(ok[i]["out"])
        if served >= budget and len(slots) >= least:
            break
    return picked


def reference_gaps(r: harness.Run, picked: List[dict],
                   products: str = "float32", against: str | None = None
                   ) -> np.ndarray:
    """Each served token's gap below the reference's best logit at its
    position (``against`` None). With ``against`` set, the gap under the
    ``against`` reference of the token the ``products`` reference puts
    first at each of those positions: the control's reading."""
    arch = r.config["arch"]
    dtype = getattr(torch, arch.get("compute_dtype", "bfloat16"))
    specs = {n: (shape, scale) for n, shape, scale in weights.leaf_specs(arch)}

    def leaf(n):
        return weights.make_leaf(r.seed, n, *specs[n], dtype, r.device)

    ref.tf32_off()
    seqs, rows, served = [], [], []
    for d in picked:
        p, out = len(d["prompt"]), np.asarray(d["out"], np.int64)
        seqs.append(np.concatenate([d["prompt"].astype(np.int64), out])[:-1])
        rows.append(np.arange(p - 1, p - 1 + len(out)))
        served.append(out)
    logits = ref.logits_at(arch, leaf, seqs, rows, ref.Products(products),
                           r.device)
    if against is None:
        return np.concatenate([checks.served_gaps(lg, s)
                               for lg, s in zip(logits, served)])
    first = [lg.argmax(-1).cpu().numpy() for lg in logits]
    del logits
    base = ref.logits_at(arch, leaf, seqs, rows, ref.Products(against),
                         r.device)
    return np.concatenate([checks.served_gaps(lg, f)
                           for lg, f in zip(base, first)])


def measure(r: harness.Run) -> harness.Outcome:
    """Set-up, the window and its numbers; the outcome's ``picked`` are
    the sampled completed requests, its checks still empty. The engine
    is freed on return."""
    arch, mix = r.config["arch"], r.traffic
    pool = traffic.RequestPool(mix, r.seed, arch["vocab_size"])
    loop = ClosedLoop(r, pool)
    harness.load_kernels(r)
    loop.engine = build_engine(r, loop)
    r.phase("weights and engine")
    unwatch = loop.watch()
    tracer = None
    try:
        warm_up(loop)
        r.phase("warm-up")
        if r.trace:
            harness.warm_profiler(r.device)
            tracer = loop.tracer = Tracer(loop)
        loop.serve()
    finally:
        if tracer is not None:
            tracer.stop()
            tracer.restore()
        unwatch()
    peak = (torch.cuda.max_memory_allocated(r.device)
            if r.device.type == "cuda" else 0)
    window = loop.t_end - loop.t_start
    done = loop.in_window()
    lat = [d["latency_s"] * 1e3 for d in done if d["ok"]]
    tokens = loop.tokens_at_end - loop.tokens_at_start
    ticks = loop.ticks_at_end - loop.ticks_at_start
    r.log(f"{len(done)} requests completed in {window:.3f} s, {tokens} "
          f"tokens, {len(loop.inflight)} in flight at the close; {ticks} "
          f"decode ticks, {1e3 * window / max(ticks, 1):.3f} ms a tick; "
          f"peak {peak} bytes")
    out = harness.Outcome(
        values={"output_tokens_per_s": tokens / window,
                "request_p95_ms": (float(np.percentile(lat, 95)) if lat
                                   else float("nan")),
                "setup_s": r.setup_s},
        checks=[], attempted=len(done) + len(loop.inflight),
        failed=sum(not d["ok"] for d in done), memory_peak_bytes=peak)
    out.picked = sample(done, mix, r.seed)
    if tracer is not None and tracer.result is not None:
        prof, wall, counts, traced = tracer.result
        out.slice = harness.read_profile(prof, wall, counts, arch, mix,
                                         r.device_kind)
        r.log(f"traced slice: {traced} decode ticks, "
              f"{1e3 * out.slice.window_s / max(traced, 1):.3f} ms a tick "
              f"by the trace ({1e3 * wall / max(traced, 1):.3f} by the "
              f"host's clock)")
    loop.engine = loop.tracer = tracer = None
    free(r.device)
    return out


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run(r: harness.Run) -> harness.Outcome:
    out = measure(r)
    t_ref = time.perf_counter()
    gaps = reference_gaps(r, out.picked) if out.picked else np.zeros(0)
    r.log(f"reference over {len(out.picked)} requests, {len(gaps)} served "
          f"tokens: {time.perf_counter() - t_ref:.1f} s")
    out.checks = checks.serve_checks(gaps, r.limits)
    return out
