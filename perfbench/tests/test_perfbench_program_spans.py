"""The readers of the program's own spans (``perfbench/program.py`` and
the five metrics on it), on a synthetic slice and synthetic ring events
with hand-computed values; each returns None without its spans; and a
traced serving run at smoke size on the CPU finds the engine's
first-token instants in its slice."""
import math

import pytest

from perfbench import harness, program
from perfbench.tests import smoke
from repro_torch.obs.trace import TraceEvent

US = 1000          # ns in a µs
T0 = 1_700_000_000_000_000      # µs: a Unix time, as the ring stamps


def ev(name, t_us, dur_us=0.0, **args):
    """A ring event ``t_us`` µs after T0."""
    return TraceEvent("i" if name.endswith("first_token") else "X", name,
                      "program", T0 + t_us, dur_us, 1, None, args or None)


def span(kind, t0_us, t1_us):
    return harness.Span(kind, {}, (T0 + t0_us) * US, (T0 + t1_us) * US)


def op(t0_us, t1_us):
    return harness.DeviceOp("k", (T0 + t0_us) * US, (T0 + t1_us) * US, None)


def make_slice(spans, ops=()):
    return harness.Slice(wall_s=1.0, ops=list(ops), spans=spans, counts={},
                         arch={}, traffic={}, gaps=[])


def read(name, s, evs):
    return harness.metric_reader(name)(s, evs)


SERVE_SLICE = make_slice(
    [span("decode", 100, 190), span("prefill", 300, 380),
     span("decode", 500, 590)],
    [op(100, 200), op(250, 400), op(450, 600)])

SERVE_EVENTS = [
    ev("engine.decode", 0, 60, device_ms=9.0),            # before the slice
    ev("engine.decode", 95, 100, device_ms=2.0),         # encloses 100-190
    ev("lm.decode_attention", 120, 10, device_ms=0.5),
    ev("lm.decode_attention", 140, 10, device_ms=0.25),
    ev("engine.other", 290, 120),                       # not the model's
    ev("engine.prefill", 295, 90, device_ms=1.5),        # encloses 300-380
    ev("engine.first_token", 420, queue_wait_us=1000.0,
       first_token_us=5000.0),
    ev("engine.first_token", 430, queue_wait_us=0.0,
       first_token_us=3000.0),
    ev("engine.first_token", 440, queue_wait_us=500.0,
       first_token_us=4000.0),
    ev("engine.decode", 480, 120, device_ms=3.0),        # encloses 500-590
    ev("lm.decode_attention", 520, 10, device_ms=0.75),
    ev("lm.decode_attention", 540, 10, device_ms=0.5),
    ev("engine.first_token", 700, queue_wait_us=9e6,     # after the slice
       first_token_us=9e6),
]


def test_in_slice_keeps_enclosing_spans_and_drops_the_rest():
    names = [(e.name, e.ts_us - T0) for e in
             program.in_slice(SERVE_SLICE, SERVE_EVENTS)]
    assert ("engine.decode", 0) not in names
    assert ("engine.first_token", 700) not in names
    assert ("engine.decode", 95) in names and ("engine.decode", 480) in names
    assert ("engine.prefill", 295) in names
    assert len(names) == len(SERVE_EVENTS) - 2


def test_decode_attention_share_by_hand():
    # (0.5 + 0.25 + 0.75 + 0.5) / (2 + 3)
    assert read("decode_attention_share", SERVE_SLICE, SERVE_EVENTS) == \
        pytest.approx(40.0)


def test_engine_host_idle_share_splits_a_gap_at_a_decode_boundary():
    # ops busy 100-200, 250-400, 450-600; window 100-600 (500 µs).
    # gap 200-250: engine.decode 95-195 ends before it: all 50 µs count;
    # gap 400-450: engine.prefill 295-385 ends before it, engine.other
    # 290-410 is not the model's and engine.decode 480-600 starts after
    # it: all 50 µs count. Move that decode to start at 430: the gap
    # splits at its boundary, and only 400-430 counts.
    assert read("engine_host_idle_share", SERVE_SLICE, SERVE_EVENTS) == \
        pytest.approx(100.0 * 100 / 500)
    moved = [e._replace(ts_us=T0 + 430, dur_us=170)
             if e.name == "engine.decode" and e.ts_us == T0 + 480 else e
             for e in SERVE_EVENTS]
    assert read("engine_host_idle_share", SERVE_SLICE, moved) == \
        pytest.approx(100.0 * (50 + 30) / 500)


def test_engine_host_idle_share_gap_inside_one_decode_is_the_models():
    s = make_slice([span("decode", 0, 100)], [op(10, 40), op(60, 90)])
    evs = [ev("engine.decode", 5, 90, device_ms=1.0)]
    assert read("engine_host_idle_share", s, evs) == 0.0
    evs = [ev("engine.decode", 5, 45, device_ms=1.0)]       # ends at 50
    assert read("engine_host_idle_share", s, evs) == pytest.approx(
        100.0 * 10 / 80)


def test_first_token_p50_and_admission_wait_mean_by_hand():
    assert read("first_token_p50_ms", SERVE_SLICE, SERVE_EVENTS) == \
        pytest.approx(4.0)
    assert read("admission_wait_mean_ms", SERVE_SLICE, SERVE_EVENTS) == \
        pytest.approx(0.5)


def test_train_optimizer_share_by_hand():
    s = make_slice([span("train_step", 0, 1000), span("train_step", 1000,
                                                      2000)])
    evs = []
    for k in (0, 1000):
        evs += [ev("train.forward", k + 10, 300, device_ms=100.0),
                ev("train.backward", k + 320, 400, device_ms=250.0),
                ev("train.optimizer", k + 730, 200, device_ms=50.0)]
    assert read("train_optimizer_share", s, evs) == pytest.approx(12.5)


SERVE_METRICS = ["decode_attention_share", "engine_host_idle_share",
                 "first_token_p50_ms", "admission_wait_mean_ms"]


@pytest.mark.parametrize("name", SERVE_METRICS + ["train_optimizer_share"])
def test_reader_is_none_without_its_spans(name):
    assert read(name, SERVE_SLICE, []) is None
    assert read(name, make_slice([]), SERVE_EVENTS) is None


@pytest.mark.parametrize("name", ["decode_attention_share",
                                  "train_optimizer_share"])
def test_reader_is_none_without_device_intervals(name):
    cpu = [e._replace(args={**e.args, "device_ms": None})
           if e.args and "device_ms" in e.args else e for e in SERVE_EVENTS]
    s = make_slice([span("train_step", 0, 1000)])
    evs = [ev("train.forward", 10, 300, device_ms=None),
           ev("train.backward", 320, 400, device_ms=None),
           ev("train.optimizer", 730, 200, device_ms=None)]
    assert read(name, SERVE_SLICE, cpu) is None
    assert read(name, s, evs) is None


def test_a_program_without_the_tracer_gives_no_events(monkeypatch):
    import repro_torch.obs.trace as trace
    monkeypatch.delattr(trace, "program_tracer")
    assert program.events() == []
    for name in SERVE_METRICS:
        assert harness.metric_reader(name)(SERVE_SLICE) is None


def test_traced_smoke_serving_run_reads_first_token_metrics(few_threads):
    from repro_torch.obs.trace import program_tracer
    cell = "nemotron_4_340b.decode_heavy"
    r = smoke.make_run(cell, smoke.NEMOTRON_SMOKE, smoke.serve_mix(),
                       seconds=1.0, trace=True)
    program_tracer().clear()
    out = harness.kind_module("closed_serve").run(r)
    assert out.slice is not None
    first = harness.metric_reader("first_token_p50_ms")(out.slice)
    wait = harness.metric_reader("admission_wait_mean_ms")(out.slice)
    if first is None:       # no admission fell in the 5 traced ticks
        assert wait is None
    else:
        assert math.isfinite(first) and first > 0
        assert math.isfinite(wait) and 0 <= wait <= first
    evs = program.in_slice(out.slice)
    assert len(program.named(evs, "engine.decode")) == len(
        out.slice.spans_of("decode"))
    # on the CPU no span has a device interval
    assert harness.metric_reader("decode_attention_share")(out.slice) is None
    program_tracer().clear()
