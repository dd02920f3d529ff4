"""repro_torch.obs.{analyze,window,slo} against the reference: trace
analytics (per-phase attribution, reconciliation, diffs, the CLI),
streaming windowed metrics and the SLO burn-rate monitor with its
scheduler degradation hook.

Scenarios run the same way in both packages under a ``FakeClock``;
reports, series and alerts are compared within 1e-9 (numbers) and
exactly (everything else). A threaded, traced bitplane run on the CPU
(the kernels' plain versions) is analyzed by both packages' analyzers
and must give the same report."""
import dataclasses
import json
import math

import numpy as np
import pytest

import repro.obs as R
import repro.serve as RS
import repro_torch.obs as P
import repro_torch.serve as PS
from repro.check.tracecheck import check_trace, synthetic_trace_events
from repro.obs import analyze as ref_an
from repro_torch.obs import analyze as an

PKGS = {"ref": (R, RS), "port": (P, PS)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # JSC-S training and synthesis here are many tiny ops, slowest
    # with a thread pool (and beside other test workers)
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-9


def assert_close(a, b, path="$"):
    """Nested structures equal, numbers within ``TOL`` (relative to the
    larger magnitude, absolute below 1)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            assert_close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        if a is None or b is None:
            assert a is b, path
        elif math.isnan(a) or math.isinf(a):
            assert (math.isnan(a) and math.isnan(b)) or a == b, path
        else:
            assert abs(a - b) <= TOL * max(1.0, abs(a), abs(b)), \
                (path, a, b)
    else:
        assert a == b, (path, a, b)


def _ev(pkg, ph, name, ts, dur=0.0, tid=1, sid=None, args=None,
        cat="request"):
    return PKGS[pkg][0].TraceEvent(ph, name, cat, ts, dur, tid, sid, args)


def _traced_run(pkg, exec_us=100.0, n=8, gap_us=10.0, lanes=None):
    """FakeClock scheduler run: n requests in size-4 batches, every
    timestamp deterministic, so phase sums reconcile exactly."""
    obs, serve = PKGS[pkg]
    clk = serve.FakeClock()
    tracer = obs.SpanTracer(clock=clk, capacity=8192)

    def ex(x):
        clk.advance_us(exec_us)
        return x.sum(axis=-1)

    cfg = serve.SchedConfig(max_batch=4, max_wait_us=500.0)
    if lanes:
        cfg = serve.SchedConfig(max_batch=4, max_wait_us=500.0,
                                n_priorities=2, lane_slo_us=lanes)
    s = serve.MicroBatchScheduler(ex, cfg, clock=clk, tracer=tracer)
    for i in range(n):
        try:
            s.submit(np.full((1, 3), i, np.float32),
                     priority=i % 2 if lanes else 0)
        except serve.RequestRejected:
            pass
        clk.advance_us(gap_us)
        s.poll()
    s.poll(force=True)
    s.drain()
    return tracer.events()


def _truncated(pkg):
    e = lambda *a, **k: _ev(pkg, *a, **k)  # noqa: E731
    return [
        e("e", "queue_wait", 50.0, sid=1,
          args={"flush_reason": "size", "wait_us": 50.0}),
        e("X", "batch_form", 50.0, dur=0.0, cat="batch",
          args={"flush_reason": "size", "rows": 1, "n_requests": 1}),
        e("X", "exec", 50.0, dur=100.0, cat="exec"),
        e("e", "request", 150.0, sid=1,
          args={"outcome": "ok", "latency_us": 150.0}),
        e("e", "request", 160.0, sid=2, args={"outcome": "shed"}),
    ]


def _broken(pkg):
    """A request claiming far more latency than its phases hold."""
    e = lambda *a, **k: _ev(pkg, *a, **k)  # noqa: E731
    return [
        e("b", "request", 0.0, sid=1, args={"lane": 0, "rows": 1}),
        e("b", "queue_wait", 0.0, sid=1),
        e("e", "queue_wait", 10.0, sid=1,
          args={"flush_reason": "size", "wait_us": 10.0}),
        e("X", "batch_form", 10.0, dur=0.0, cat="batch",
          args={"flush_reason": "size", "rows": 1, "n_requests": 1}),
        e("X", "exec", 10.0, dur=100.0, cat="exec"),
        e("e", "request", 1000.0, sid=1,
          args={"outcome": "ok", "latency_us": 1000.0}),
    ]


EVENT_SETS = {
    "stream": lambda pkg: _traced_run(pkg),
    "slow_gaps": lambda pkg: _traced_run(pkg, exec_us=37.5, n=13,
                                         gap_us=91.0),
    "lanes_shed": lambda pkg: _traced_run(pkg, exec_us=300.0, n=12,
                                          lanes=(250.0, 5000.0)),
    "lifecycle_edges": lambda pkg: synthetic_trace_events()[0],
    "truncated": _truncated,
    "broken": _broken,
    "empty": lambda pkg: [],
}


@pytest.mark.parametrize("name", list(EVENT_SETS))
def test_analyze_events_match_reference(name):
    ref = ref_an.analyze_events(EVENT_SETS[name]("ref"))
    port = an.analyze_events(EVENT_SETS[name]("port"))
    assert_close(port.to_dict(), ref.to_dict())
    assert_close(port.reconciliation(), ref.reconciliation())
    assert an.format_report(port) == ref_an.format_report(ref)
    assert [dataclasses.astuple(r) for r in port.requests] == \
        [dataclasses.astuple(r) for r in ref.requests]
    assert [(r.phases_us(), r.recon_error()) for r in port.requests] == \
        [(r.phases_us(), r.recon_error()) for r in ref.requests]
    if name == "stream":
        rec = port.reconciliation()
        assert rec["ok"] and rec["n_checked"] == 8
        assert rec["max_rel_err"] == 0.0
    if name == "broken":
        assert not port.reconciliation()["ok"]


@pytest.mark.parametrize("exec_us", [300.0, 100.0, 50.0])
def test_diff_reports_match_reference(exec_us):
    def reports(mod, pkg):
        return (mod.analyze_events(_traced_run(pkg, exec_us=exec_us)),
                mod.analyze_events(_traced_run(pkg, exec_us=100.0)))
    port = an.diff_reports(*reports(an, "port"))
    ref = ref_an.diff_reports(*reports(ref_an, "ref"))
    assert_close(port, ref)
    assert an.format_diff(port) == ref_an.format_diff(ref)
    if exec_us == 300.0:
        assert port["attribution"] == "dispatch"
        assert port["phases"]["dispatch"]["delta_us"] == \
            pytest.approx(200.0)


def test_analyze_cli_matches_reference(tmp_path, capsys):
    """The port's CLI on a port trace prints what the reference's CLI
    prints on the same file, as text, as JSON and as a diff."""
    new, old = str(tmp_path / "new.json"), str(tmp_path / "old.json")
    P.write_chrome_trace(new, _traced_run("port", exec_us=300.0))
    P.write_chrome_trace(old, _traced_run("port"))
    for argv in (["--trace", new], ["--trace", new, "--json"],
                 ["--trace", new, "--diff", old],
                 ["--trace", new, "--diff", old, "--json"]):
        assert an.main(argv) == 0
        got = capsys.readouterr().out
        assert ref_an.main(argv) == 0
        want = capsys.readouterr().out
        if "--json" in argv:
            assert_close(json.loads(got), json.loads(want))
        else:
            assert got == want
    assert an.analyze_trace(new).reconciliation()["ok"]


@pytest.fixture(scope="module")
def bitplane_trace(tmp_path_factory):
    """A threaded scheduler over two bitplane replicas of a small logic
    network on the CPU (streamed walk's plain version), traced end to
    end: aggregate_pack, device_exec and lut_eval spans nest inside
    replica_dispatch inside exec."""
    import torch

    from repro_torch.configs.jsc import JSC_DEMO
    from repro_torch.models.mlp import final_masks, init_mlp, to_logic

    model = init_mlp(JSC_DEMO, torch.Generator().manual_seed(0))
    model.set_masks(final_masks(JSC_DEMO, model))
    net = to_logic(JSC_DEMO, model)
    rs = PS.build_logic_replicas(net, 5, n_replicas=2, backend="bitplane",
                                 max_batch=64, policy="least_loaded",
                                 engine="cuda-streamed", device="cpu")
    tracer = P.SpanTracer()
    s = PS.MicroBatchScheduler(rs, PS.SchedConfig(max_batch=64,
                                                  max_wait_us=300.0),
                               tracer=tracer)
    x = np.random.default_rng(0).normal(size=(200, 16)).astype(np.float32)
    s.start()
    futs = [s.submit(x[i]) for i in range(200)]
    s.stop(drain=True)
    got = np.array([int(f.result(timeout=30)) for f in futs])
    path = str(tmp_path_factory.mktemp("trace") / "t.json")
    P.write_chrome_trace(path, tracer)
    return path, got, rs, net, x


def test_threaded_bitplane_trace_analyzes_like_the_reference(
        bitplane_trace):
    path, got, rs, net, x = bitplane_trace
    from repro_torch.serving.engine import LogicEngine
    want = LogicEngine(net, 5, backend="gather", device="cpu").classify(x)
    np.testing.assert_array_equal(got, want)
    assert sum(r["served"] for r in rs.stats()) > 0
    # structure only: a threaded trace's phase reconciliation depends on
    # where the interpreter switches threads (gated on the card)
    rep = check_trace(P.load_trace_events(path))
    assert rep.ok, rep.format()
    port, ref = an.analyze_trace(path), ref_an.analyze_trace(path)
    assert_close(port.to_dict(), ref.to_dict())
    d = port.to_dict()
    assert d["reconciliation"]["n_checked"] == 200 and d["n_requests"] == 200
    assert d["outcomes"] == {"ok": 200}
    assert {"pack", "device_exec", "dispatch"} <= set(d["phases_us"])
    assert d["kernel_us_total"] > 0


# ---------------------------------------------------------------------------
# Windowed metrics
# ---------------------------------------------------------------------------

def _ring(pkg):
    ring = PKGS[pkg][0].BucketRing(window_us=1000.0, n_windows=4)
    out = []
    for ts, lat, ok in [(100.0, 50.0, True), (1100.0, 70.0, False),
                        (1150.0, 20.0, None), (2500.0, 5.0, True)]:
        if ok is None:
            ring.add_shed(ts)
        else:
            ring.add_done(ts, lat, ok=ok)
        out.append(ring.series())
    out.append(ring.merged(1500.0, 2000.0).record(0.0, 2000.0))
    ring.add_done(100_000.0, 1.0, ok=True)         # evicts the old ones
    out.append(ring.series())
    out.append(ring.series(now_us=104_000.0))
    return out


def test_bucket_ring_matches_reference():
    assert_close(_ring("port"), _ring("ref"))


def _windowed(pkg):
    obs, serve = PKGS[pkg]
    clk = serve.FakeClock()
    wm = obs.WindowedMetrics(window_us=1000.0)

    def ex(x):
        clk.advance_us(200.0)
        return x.sum(axis=-1)

    s = serve.MicroBatchScheduler(
        ex, serve.SchedConfig(max_batch=2, n_priorities=2,
                              lane_slo_us=(700.0, 5000.0)), clock=clk)
    s.metrics.add_sink(wm)
    for i in range(14):
        s.submit(np.full((1, 3), i, np.float32), priority=i % 2)
        if i % 3:
            s.poll()
        clk.advance_us(350.0 + 40.0 * i)
    s.drain()
    reg = obs.MetricsRegistry()
    wm.publish(reg, "windows")
    return wm.series(), wm.sliding(10_000.0), reg.snapshot()["windows"]


def test_windowed_metrics_as_scheduler_sink_match_reference():
    port, ref = _windowed("port"), _windowed("ref")
    assert_close(port, ref)
    series = port[0]
    assert sum(r["n"] for lane in series["lanes"].values()
               for r in lane) > 0
    assert sum(b["n_batches"] for b in series["batches"]) > 0


# ---------------------------------------------------------------------------
# SLO burn rate
# ---------------------------------------------------------------------------

def _monitor(pkg, **kw):
    kw.setdefault("slo_target", 0.9)
    kw.setdefault("long_window_us", 8_000.0)
    kw.setdefault("short_window_us", 1_000.0)
    kw.setdefault("threshold", 2.0)
    kw.setdefault("clear_threshold", 1.0)
    kw.setdefault("min_events", 10)
    return PKGS[pkg][0].BurnRateMonitor(**kw)


def _burn(pkg):
    mon = _monitor(pkg)
    seen = []
    mon.on_alert(seen.append)
    t, out = 0.0, []
    for i in range(60):
        miss = i < 25 or 40 <= i < 48
        mon.record_done(lane=i % 2, latency_us=500.0, now_us=t,
                        ok=not miss, deadline_us=t - 1.0 if miss else t)
        if i % 7 == 0:
            mon.record_shed(lane=1, now_us=t)
        mon.record_done(lane=0, latency_us=1.0, now_us=t, ok=True,
                        deadline_us=None)
        t += 80.0 if i != 30 else 4_000.0
        out.append([dataclasses.asdict(a) for a in mon.check(t)])
        out.append(mon.alerting_lanes())
    out.append([dataclasses.asdict(a) for a in mon.history()])
    out.append([dataclasses.asdict(a) for a in seen])
    out.append(mon.stats(t))
    out.append([str(a) for a in mon.history()])
    return out


def test_burn_rate_alerts_match_reference():
    port, ref = _burn("port"), _burn("ref")
    assert_close(port, ref)
    kinds = [a["kind"] for a in port[-4]]
    assert "fire" in kinds and "clear" in kinds


@pytest.mark.parametrize("kw", [{"slo_target": 1.5},
                                {"long_window_us": 10.0,
                                 "short_window_us": 10.0},
                                {"threshold": 2.0, "clear_threshold": 3.0}])
def test_burn_rate_monitor_validation_matches_reference(kw):
    for pkg in PKGS:
        with pytest.raises(ValueError):
            PKGS[pkg][0].BurnRateMonitor(**kw)
    with pytest.raises(ValueError):
        _monitor("port").check()         # no now_us and no clock bound


def _degrade(pkg):
    obs, serve = PKGS[pkg]
    clk = serve.FakeClock()
    mon = _monitor(pkg)
    fired = []
    mon.on_alert(fired.append)
    s = serve.MicroBatchScheduler(
        lambda x: x.sum(axis=-1),
        serve.SchedConfig(max_batch=4, n_priorities=2,
                          lane_slo_us=(500.0, 5_000.0)),
        clock=clk, slo_monitor=mon)
    out = [s._degrade_lane]
    for _ in range(20):
        clk.advance_us(20.0)
        s.metrics.record_done(600.0, clk.now_us(), lane=0,
                              deadline_us=clk.now_us() - 1.0)
    for step in range(6):
        for lane in (1, 0):
            try:
                s.submit(np.ones((1, 3), np.float32), priority=lane)
                out.append(("ok", lane))
            except serve.RequestRejected as e:
                out.append((str(e.reason), lane))
        clk.advance_us(700.0)
        s.poll()
    s.drain()
    out.append([dataclasses.asdict(a) for a in fired])
    out.append(s.metrics.snapshot())
    out.append(mon.stats(clk.now_us()))
    return out


def test_scheduler_degradation_matches_reference():
    port, ref = _degrade("port"), _degrade("ref")
    assert_close(port, ref)
    assert port[0] == 1                  # the loosest lane sheds first
    assert any(o[0] != "ok" for o in port[1:13] if isinstance(o, tuple))


def test_scheduler_degradation_sheds_loosest_lane():
    """The port's shed path names its reason: while lane 0 burns its
    budget, lane 1 is refused with ``RejectReason.DEGRADED``, counted
    under "degraded", and admitted again once the burn stops (the
    reference's ``tests/test_obs_analyze.py`` scenario)."""
    clk = PS.FakeClock()
    mon = _monitor("port")
    fired = []
    mon.on_alert(fired.append)
    s = PS.MicroBatchScheduler(
        lambda x: x.sum(axis=-1),
        PS.SchedConfig(max_batch=4, n_priorities=2,
                       lane_slo_us=(500.0, 5_000.0)),
        clock=clk, slo_monitor=mon)
    assert s._degrade_lane == 1          # largest SLO budget loses first
    for _ in range(20):
        clk.advance_us(20.0)
        s.metrics.record_done(600.0, clk.now_us(), lane=0,
                              deadline_us=clk.now_us() - 1.0)
    with pytest.raises(PS.RequestRejected) as ei:
        s.submit(np.ones((1, 3), np.float32), priority=1)
    assert ei.value.reason == PS.RejectReason.DEGRADED
    assert fired and fired[0].kind == "fire" and fired[0].lane == 0
    assert s.metrics.snapshot()["rejected_by_reason"]["degraded"] == 1
    s.submit(np.ones((1, 3), np.float32), priority=0)
    clk.advance_us(3_000.0)
    f = s.submit(np.ones((1, 3), np.float32), priority=1)
    assert mon.alerting_lanes() == []
    s.poll(force=True)
    f.result(0)
