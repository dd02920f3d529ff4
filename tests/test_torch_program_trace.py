"""The program tracer (``repro_torch.obs.trace.program_tracer()``) and
the spans of the LM engine, the decode step and the trainer: off, they
record nothing and open no profiler range; under a profiler they share
its clock; the engine's admission stamps are ordered and its
``engine.first_token`` args are their differences; a train step's
phases come in order inside the step; every ``ctypes`` launch goes
through ``kernels.build.launch``. The CUDA cases run on the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_program_trace.py
"""
import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import SMOKES, get_arch
from repro_torch.data.tokens import lm_batch
from repro_torch.models import lm
from repro_torch.obs import export
from repro_torch.obs.trace import (NULL_SPAN, ProfilerClock, ProgramTracer,
                                   program_tracer)
from repro_torch.serve.clock import FakeClock
from repro_torch.serving.engine import LMEngine, LMRequest
from repro_torch.train.loop import Trainer, init_state, make_train_step
from repro_torch.train.optim import AdamW

ENGINE_SPANS = {"engine.prefill", "engine.decode", "engine.first_token",
                "lm.decode_attention"}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def program():
    """The process-wide tracer, emptied and enabled; off again after."""
    tr = program_tracer()
    tr.clear()
    tr.enabled = True
    yield tr
    tr.enabled = False
    tr.clear()


class TickingClock(FakeClock):
    """A fake clock that moves 1 µs at every read."""

    def now_us(self) -> float:
        self.advance_us(1.0)
        return super().now_us()


class Forbidden:
    """Stands in for ``torch.cuda`` / ``record_function``: any use fails."""

    def __getattr__(self, name):
        raise AssertionError(f"used {name} with the tracer off")

    def __call__(self, *a, **kw):
        raise AssertionError("opened a profiler range with the tracer off")


def engine(device="cpu", clock=None, n_slots=2):
    cfg = SMOKES["glm4-9b"]
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    return cfg, LMEngine(cfg, params, n_slots=n_slots, max_seq=32,
                         clock=clock or FakeClock(), device=device)


def requests(cfg, n=3, new=3):
    rng = np.random.default_rng(0)
    return [LMRequest(rng.integers(0, cfg.vocab_size, 6, dtype=np.int32),
                      max_new_tokens=new) for _ in range(n)]


def one_train_step(cfg, trainer=True):
    opt = AdamW(lr=1e-3)
    step = make_train_step(cfg, opt)
    state = init_state(cfg, opt, torch.Generator().manual_seed(0))
    toks, labels = lm_batch(cfg, 2, 16, 0, 0)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    if trainer:
        Trainer(step, state).run(iter([batch]), 1, log_fn=lambda *_: None)
    else:
        step(state, batch)


# ---------------------------------------------------------------------------
# (a) off: nothing recorded, no range, no CUDA event
# ---------------------------------------------------------------------------

def test_tracer_off_records_nothing_and_opens_no_range(monkeypatch):
    tr = program_tracer()
    assert not tr.enabled
    monkeypatch.setattr(tr, "_record_function", Forbidden())
    monkeypatch.setattr(tr, "_cuda", Forbidden())
    before = tr.n_recorded
    cfg, eng = engine()
    done = eng.run(requests(cfg))
    assert len(done) == 3
    one_train_step(get_arch("phi4-mini-3.8b", smoke=True), trainer=True)
    assert tr.n_recorded == before
    assert tr.span("engine.decode", device=torch.device("cpu")) is NULL_SPAN


def test_tracer_on_only_while_enabled_or_profiling():
    tr = ProgramTracer()
    assert not tr.enabled
    with profile(activities=[ProfilerActivity.CPU]):
        assert tr.enabled
    assert not tr.enabled
    tr.enabled = True
    assert tr.enabled
    tr.enabled = False
    assert not tr.enabled and tr.n_recorded == 0


# ---------------------------------------------------------------------------
# (b) the profiler's clock
# ---------------------------------------------------------------------------

def offsets_us(ring, prof_events):
    """Each ring span's start and end less its profiler range's, in µs,
    ranges matched by name in order."""
    ranges = {}
    for p in prof_events:
        ranges.setdefault(p.name(), []).append(p)
    seen, out = {}, []
    for e in ring:
        i = seen[e.name] = seen.get(e.name, -1) + 1
        p = ranges[e.name][i]
        out.append(e.ts_us - p.start_ns() * 1e-3)
        out.append(e.ts_us + e.dur_us
                   - (p.start_ns() + p.duration_ns()) * 1e-3)
    return out


def test_ring_span_lies_on_the_profilers_clock():
    """The ring's interval encloses the profiler's range of the same
    span, by the range's own cost: within 100 µs at each end (the
    median over five spans after a first one, which pays the session's
    first range; each within 1 ms), where the host's other clock
    (``perf_counter``) lies decades away."""
    tr = ProgramTracer(enabled=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("probe.warm"):
            torch.ones(4).sum()
        for i in range(5):
            with tr.span("probe.span", args={"i": i}):
                torch.ones(64, 64).matmul(torch.ones(64, 64))
    ring = [e for e in tr.events() if e.name == "probe.span"]
    assert [e.args["i"] for e in ring] == list(range(5))
    off = offsets_us(ring, [p for p in prof.profiler.kineto_results.events()
                            if p.name() == "probe.span"])
    starts, ends = off[0::2], off[1::2]
    assert all(s <= 0 <= e for s, e in zip(starts, ends)), off
    assert abs(float(np.median(starts))) <= 100, off
    assert abs(float(np.median(ends))) <= 100, off
    assert max(abs(x) for x in off) <= 1000, off


def test_a_profiler_session_alone_fills_the_ring_and_adds_no_range():
    """Not enabled, the tracer records under a profiler but leaves the
    profile without the program's names."""
    tr = ProgramTracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("probe.quiet", device=torch.device("cpu")):
            torch.ones(64, 64).sum()
    assert [e.name for e in tr.events()] == ["probe.quiet"]
    assert not [p for p in prof.profiler.kineto_results.events()
                if p.name() == "probe.quiet"]


class FakeLibrary:
    """Stands in for the kernel library: ``probe_launch`` returns
    ``err`` and notes its arguments."""

    def __init__(self, err=0):
        self.err = err
        self.calls = []

    def probe_launch(self, *args):
        self.calls.append(args)
        return self.err

    def repro_cuda_error_string(self, err):
        return b"probe error"


def test_kernel_launch_opens_a_host_op_only_while_profiling(monkeypatch):
    """``build.launch`` calls ``<kernel>_launch`` inside the profiler op
    ``repro_torch::<kernel>`` (the scope of an operator, which ties the
    launch's kernels to it) while a profiler records, and inside
    nothing otherwise."""
    from repro_torch.kernels import build
    lib = FakeLibrary()
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "_profiler_op", Forbidden())
    build.launch("probe", 1, 2)
    assert lib.calls == [(1, 2)]
    monkeypatch.undo()
    monkeypatch.setattr(build, "library", lambda: lib)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        build.launch("probe", 3)
        torch.ones(2).sum()
    assert lib.calls == [(1, 2), (3,)]
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "repro_torch::probe"]
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.name().startswith("aten::")]
    assert ev.scope() == 0 and ev.correlation_id() > 0
    assert ops and all(e.scope() == ev.scope() for e in ops)


def test_kernel_launch_without_torchs_private_op_opens_none(monkeypatch):
    """Where torch lacks the private op class, launches run bare under a
    profiler instead of raising."""
    from repro_torch.kernels import build
    lib = FakeLibrary()
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.delattr(torch._C._profiler, "_RecordFunctionFast")
    assert build._profiler_op() is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        build.launch("probe", 5)
    assert lib.calls == [(5,)]
    assert not [e for e in prof.profiler.kineto_results.events()
                if e.name() == "repro_torch::probe"]


def test_kernel_launch_raises_the_entry_points_error(monkeypatch):
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "library", lambda: FakeLibrary(err=700))
    with pytest.raises(build.KernelLaunchError, match="probe: CUDA error "
                       "700 \\(probe error\\)"):
        build.launch("probe")


def test_every_kernel_entry_point_is_called_through_launch():
    """No wrapper calls a ``*_launch`` entry point of the library itself:
    each goes through ``build.launch`` by its kernel's name, and every
    entry point has a wrapper that launches it."""
    from repro_torch.kernels import build
    entries = {n[:-len("_launch")] for n in build.SIGNATURES
               if n.endswith("_launch")}
    root = Path(build.__file__).parent
    launched = set()
    for path in sorted(root.rglob("*.py")):
        if path.name == "build.py":
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Attribute):
                assert not node.attr.endswith("_launch"), (path, node.attr)
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "launch"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "build"):
                launched.add(node.args[0].value)
    assert launched == entries


def test_profiler_clock_is_unix_time_in_us():
    import time
    before = time.time_ns() * 1e-3
    now = ProfilerClock().now_us()
    assert before <= now <= time.time_ns() * 1e-3


def test_device_interval_is_none_on_the_cpu_and_exports():
    tr = ProgramTracer(enabled=True)
    with tr.span("x.dev", args={"k": 2}, device=torch.device("cpu")):
        pass
    with tr.span("x.host"):
        pass
    ev = {e.name: e for e in tr.events()}
    assert ev["x.dev"].args == {"k": 2, "device_ms": None}
    assert ev["x.host"].args is None
    doc = json.loads(json.dumps(export.to_chrome_trace(tr)))
    names = [r["name"] for r in doc["traceEvents"]]
    assert "x.dev" in names and "x.host" in names
    assert export.to_jsonl(tr).count("\n") == 2


# ---------------------------------------------------------------------------
# (c) the engine's stamps
# ---------------------------------------------------------------------------

def test_engine_stamps_ordered_and_first_token_args_their_differences(
        program):
    tr = program
    cfg, eng = engine(clock=TickingClock(), n_slots=2)
    futs = [eng.submit(r) for r in requests(cfg, n=4)]
    eng.run()
    for f in futs:
        assert f.done()
        assert (f.t_enqueue_us <= f.t_admit_us <= f.t_first_token_us
                <= f.t_done_us)
    # a request admitted after another finished waited for its slot
    assert futs[2].t_admit_us - futs[2].t_enqueue_us > \
        futs[0].t_admit_us - futs[0].t_enqueue_us
    firsts = [e for e in tr.events() if e.name == "engine.first_token"]
    assert len(firsts) == 4
    by_wait = sorted(futs, key=lambda f: f.t_admit_us)
    for e, f in zip(firsts, by_wait):
        assert e.ph == "i"
        assert e.args == {"queue_wait_us": f.t_admit_us - f.t_enqueue_us,
                          "first_token_us": f.t_first_token_us
                          - f.t_enqueue_us}


def test_engine_spans_nest_and_carry_the_decode_work(program):
    cfg, eng = engine(n_slots=2)
    eng.run(requests(cfg, n=2, new=3))
    ev = program.events()
    assert {e.name for e in ev} == ENGINE_SPANS
    decode = [e for e in ev if e.name == "engine.decode"]
    # both prompts of 6 tokens: contexts 7 + 7, then 8 + 8
    assert [(d.args["active"], d.args["ctx"], d.args["slots"])
            for d in decode] == [(2, 14, 2), (2, 16, 2)]
    assert all(d.args["device_ms"] is None for d in decode)
    attn = [e for e in ev if e.name == "lm.decode_attention"]
    assert [e.args["layer"] for e in attn] == list(range(cfg.n_layers)) * 2
    for e in attn:
        assert any(d.ts_us <= e.ts_us and e.ts_us + e.dur_us
                   <= d.ts_us + d.dur_us for d in decode)
    prefills = [e for e in ev if e.name == "engine.prefill"]
    firsts = [e for e in ev if e.name == "engine.first_token"]
    assert [p.args for p in prefills] == [{"S": 6, "device_ms": None}] * 2
    # each admission's prefill ends before its first token, and the
    # second admission's prefill starts after the first one's token
    assert [e.name for e in ev if e.name in ("engine.prefill",
                                             "engine.first_token")] == [
        "engine.prefill", "engine.first_token"] * 2
    for p, f in zip(prefills, firsts):
        assert p.ts_us + p.dur_us <= f.ts_us
    assert firsts[-1].ts_us <= decode[0].ts_us


# ---------------------------------------------------------------------------
# (d) the train step's phases
# ---------------------------------------------------------------------------

def test_train_phases_nest_in_the_step(program):
    """One traced step records forward, backward and optimizer once
    each, in that order, all inside the step's call on the tracer's
    clock."""
    t0 = ProfilerClock().now_us()
    one_train_step(get_arch("phi4-mini-3.8b", smoke=True), trainer=True)
    t1 = ProfilerClock().now_us()
    ev = program.events()
    order = ["train.forward", "train.backward", "train.optimizer"]
    assert [e.name for e in ev] == order
    for a, b in zip(ev, ev[1:]):
        assert a.ts_us + a.dur_us <= b.ts_us
    for e in ev:
        assert t0 <= e.ts_us and e.ts_us + e.dur_us <= t1
        assert e.args == {"device_ms": None}


def test_train_phases_once_a_microbatch(program):
    cfg = get_arch("phi4-mini-3.8b", smoke=True)
    opt = AdamW(lr=1e-3)
    state = init_state(cfg, opt, torch.Generator().manual_seed(0))
    toks, labels = lm_batch(cfg, 4, 16, 0, 0)
    make_train_step(cfg, opt, grad_accum=2)(
        state, {"tokens": torch.from_numpy(toks),
                "labels": torch.from_numpy(labels)})
    names = [e.name for e in program.events()]
    assert names.count("train.forward") == names.count("train.backward") == 2
    assert names.count("train.optimizer") == 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (device intervals are CUDA events)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_decode_span_on_the_profilers_clock(cuda_device):
    """A CUDA-traced ``engine.decode`` ring span lies within 100 µs of
    the profiler's ``engine.decode`` range, and its device interval
    holds the decode kernels' time."""
    cfg, eng = engine(device=cuda_device, n_slots=2)
    eng.run(requests(cfg, n=2, new=2))            # warm
    tr = program_tracer()
    tr.clear()
    tr.enabled = True
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.run(requests(cfg, n=2, new=4))
        torch.cuda.synchronize()
        evs = tr.events()
    finally:
        tr.enabled = False
        tr.clear()
    ring = [e for e in evs if e.name == "engine.decode"]
    attn = [e for e in evs if e.name == "lm.decode_attention"]
    ranges = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "engine.decode"
              and e.device_type() != torch.autograd.DeviceType.CUDA]
    assert len(ring) == len(ranges) == 3
    off = offsets_us(ring, sorted(ranges, key=lambda p: p.start_ns()))
    assert all(s <= 0 <= e for s, e in zip(off[0::2], off[1::2])), off
    assert abs(float(np.median(off))) <= 100, off
    assert max(abs(x) for x in off) <= 1000, off
    assert all(e.args["device_ms"] > 0 for e in ring)
    assert len(attn) == 3 * cfg.n_layers
    assert all(0 < a.args["device_ms"] for a in attn)
    assert sum(a.args["device_ms"] for a in attn) < sum(
        e.args["device_ms"] for e in ring)


@pytest.mark.gpu
def test_cuda_flash_kernels_tied_to_their_launch_op(cuda_device):
    """Under a CUDA profiler each flash kernel of a prefill links to the
    host op of its launch, not to no op."""
    cfg = SMOKES["glm4-9b"]
    params = lm.cast_weights_(cfg, lm.init_params(
        cfg, torch.Generator().manual_seed(0)).to(cuda_device))
    toks = torch.zeros((1, 16), dtype=torch.int32, device=cuda_device)
    with torch.inference_mode():
        lm.prefill(cfg, params, toks, max_seq=32)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            lm.prefill(cfg, params, toks, max_seq=32)
            torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    launch_ops = {e.correlation_id() for e in events
                  if e.name() == "repro_torch::flash_attention"}
    flash = [e for e in events if "flash" in e.name()
             and e.device_type() == torch.autograd.DeviceType.CUDA]
    assert len(launch_ops) == cfg.n_layers
    assert flash and all(e.linked_correlation_id() in launch_ops
                         for e in flash)
