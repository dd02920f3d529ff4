"""repro_torch.obs against repro.obs: the span tracer, the exporters,
the metrics registry and its Prometheus rendering and pull endpoint,
the latency table and per-level profiling of kernelprof (the walks'
plain versions on the CPU), and the online profiler.

Each scenario is driven identically in both packages under a
``FakeClock``, on the test's own thread, so every timestamp is
deterministic; events are compared exactly, thread ids aside. The
port's Chrome trace is held to the reference's trace validation pass
(``repro.check.tracecheck.check_trace_file``)."""
import dataclasses
import json
import math
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import repro.obs as R
import repro.serve as RS
import repro_torch.obs as P
import repro_torch.serve as PS
from repro.check.tracecheck import check_trace_file
from repro.kernels.lut_eval.ref import lut_eval_ref as ref_lut_eval_ref
from repro.obs import kernelprof as ref_kp
from repro.synth import compile_device_plan as ref_compile_device_plan
from repro.synth.lutmap import MappedLUT as RefMappedLUT
from repro.synth.lutmap import MappedNetwork as RefMappedNetwork
from repro_torch.obs import kernelprof as kp

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


def _key(events):
    """Events without their thread ids."""
    return [(e.ph, e.name, e.cat, e.ts_us, e.dur_us, e.scope_id, e.args)
            for e in events]


# ---------------------------------------------------------------------------
# Scheduled scenarios, driven the same way in both packages
# ---------------------------------------------------------------------------

def _sched(pkg, cfg=None, executor=None, capacity=4096):
    obs, serve = PKGS[pkg]
    clk = serve.FakeClock()
    tracer = obs.SpanTracer(clock=clk, capacity=capacity)
    if executor is None:
        def executor(x):
            clk.advance_us(100.0)
            return x.sum(axis=-1)
    s = serve.MicroBatchScheduler(
        executor, cfg or serve.SchedConfig(max_batch=4, max_wait_us=200.0),
        clock=clk, tracer=tracer)
    return clk, tracer, s


def _size_flush(pkg):
    clk, tracer, s = _sched(pkg)
    futs = [s.submit(np.full((1, 3), i, np.float32)) for i in range(4)]
    s.poll()
    return tracer, s, [f.result(0) for f in futs]


def _max_wait(pkg):
    clk, tracer, s = _sched(pkg)
    f = s.submit(np.ones((2, 3), np.float32))
    s.poll()
    clk.advance_us(200.0)
    s.poll()
    return tracer, s, [f.result(0)]


def _shed_and_reject(pkg):
    serve = PKGS[pkg][1]
    clk, tracer, s = _sched(pkg, serve.SchedConfig(
        max_batch=4, n_priorities=1, lane_slo_us=(100.0,)))
    f = s.submit(np.ones((1, 3), np.float32))
    clk.advance_us(500.0)
    s.drain()
    out = []
    for fn in (lambda: f.result(0),
               lambda: s.submit(np.ones((99, 3), np.float32))):
        with pytest.raises(serve.RequestRejected) as e:
            fn()
        out.append(str(e.value.reason))
    return tracer, s, out


def _shutdown(pkg):
    serve = PKGS[pkg][1]
    clk, tracer, s = _sched(pkg)
    f = s.submit(np.ones((1, 3), np.float32))
    s.stop(drain=False)
    with pytest.raises(serve.RequestRejected):
        f.result(0)
    return tracer, s, []


def _stream(pkg, exec_us=100.0, n=8, gap_us=10.0):
    """n requests in size-4 batches, a poll after every submit."""
    serve = PKGS[pkg][1]
    clk = None

    def ex(x):
        clk.advance_us(exec_us)
        return x.sum(axis=-1)

    clk, tracer, s = _sched(pkg, serve.SchedConfig(max_batch=4,
                                                   max_wait_us=500.0),
                            executor=ex)
    futs = []
    for i in range(n):
        futs.append(s.submit(np.full((1, 3), i, np.float32)))
        clk.advance_us(gap_us)
        s.poll()
    s.poll(force=True)
    return tracer, s, [f.result(0) for f in futs]


def _replicas(pkg):
    """A ReplicaSet as the executor: the first replica crashes once,
    the batch fails over, later batches go to the healthy one."""
    serve = PKGS[pkg][1]
    clk = serve.FakeClock()

    def crash(x):
        clk.advance_us(10.0)
        raise RuntimeError("replica crash")

    def ok(x):
        clk.advance_us(50.0)
        return x.sum(axis=-1)

    rs = serve.ReplicaSet([crash, ok], policy="rr", clock=clk)
    tracer = PKGS[pkg][0].SpanTracer(clock=clk)
    s = serve.MicroBatchScheduler(rs, serve.SchedConfig(max_batch=2),
                                  clock=clk, tracer=tracer)
    futs = [s.submit(np.full((1, 2), i, np.float32)) for i in range(6)]
    s.drain()
    return tracer, s, [f.result(0) for f in futs] + [rs.stats()]


SCENARIOS = {"size_flush": _size_flush, "max_wait": _max_wait,
             "shed_and_reject": _shed_and_reject, "shutdown": _shutdown,
             "stream": _stream, "replicas": _replicas}


def _both(name):
    return {pkg: SCENARIOS[name](pkg) for pkg in PKGS}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scheduled_span_events_match_reference(name):
    runs = _both(name)
    (rt, rs, rout), (pt, ps, pout) = runs["ref"], runs["port"]
    assert len(pt.events()) > 0
    assert _key(pt.events()) == _key(rt.events())
    assert (pt.n_recorded, pt.n_dropped) == (rt.n_recorded, rt.n_dropped)
    np.testing.assert_equal(pout, rout)
    assert ps.metrics.snapshot() == rs.metrics.snapshot()


@pytest.mark.parametrize("enabled", [True, False])
def test_ring_buffer_and_disabled_tracer_match_reference(enabled):
    got = {}
    for pkg, (obs, serve) in PKGS.items():
        t = obs.SpanTracer(clock=serve.FakeClock(), capacity=4,
                           enabled=enabled)
        for i in range(10):
            t.instant(f"ev{i}", args={"i": i})
        rid = t.new_id()
        t.abegin_nested("request", "queue_wait", rid, ts_us=3.0)
        got[pkg] = (_key(t.events()), t.n_recorded, t.n_dropped, rid)
        t.clear()
        assert t.events() == [] and t.n_recorded == 0
    assert got["port"] == got["ref"]
    assert P.FLUSH_REASONS == R.FLUSH_REASONS
    assert P.TraceEvent._fields == R.TraceEvent._fields
    assert P.NULL_TRACER.events() == [] and not P.NULL_TRACER.enabled


# ---------------------------------------------------------------------------
# Export
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["stream", "shed_and_reject", "replicas"])
def test_chrome_trace_and_jsonl_match_reference(name, tmp_path):
    runs = _both(name)
    rt, pt = runs["ref"][0], runs["port"][0]
    other = {"k": 1}
    assert P.to_chrome_trace(pt, process_name="serve", other_data=other) \
        == R.to_chrome_trace(rt, process_name="serve", other_data=other)
    assert P.to_jsonl(pt) == R.to_jsonl(rt)
    # the port's files load back through either package
    for fmt, write in (("json", P.write_chrome_trace),
                       ("jsonl", P.write_jsonl)):
        path = str(tmp_path / f"t.{fmt}")
        write(path, pt)
        for load in (P.load_trace_events, R.load_trace_events):
            back = load(path)
            assert [(e.ph, e.name, e.cat, e.ts_us, e.dur_us, e.scope_id)
                    for e in back] == \
                [k[:6] for k in _key(pt.events())]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_port_chrome_trace_passes_reference_tracecheck(name, tmp_path):
    tracer, s, _ = SCENARIOS[name]("port")
    reg = P.MetricsRegistry()
    s.metrics.publish(reg, "serve")
    path = str(tmp_path / "t.json")
    P.write_chrome_trace(path, tracer, other_data=reg.snapshot())
    rep = check_trace_file(path)
    assert rep.ok, rep.format()
    assert rep.checked > 0
    with open(path) as f:
        doc = json.load(f)
    assert doc["traceEvents"][0]["args"]["name"] == "repro_torch.serve"
    assert doc["otherData"]["serve"] == s.metrics.snapshot()


# ---------------------------------------------------------------------------
# Registry, Prometheus text, pull endpoint
# ---------------------------------------------------------------------------

def _registry(pkg):
    """Instruments of every kind, the scheduler's metrics, a replica
    set and a window published the same way in each package."""
    obs, serve = PKGS[pkg]
    tracer, s, _ = _replicas(pkg)
    reg = obs.MetricsRegistry()
    reg.counter("sched.completed").inc(3)
    assert reg.counter("sched.completed") is reg.counter("sched.completed")
    reg.gauge("queue depth").set(7.0)
    reg.gauge("live", fn=lambda: 42.0)
    h = reg.histogram("lat")
    for v in (10.0, 20.0, 30.0, 1e5):
        h.record(v)
    reg.register("flags", lambda: {"policy": "rr", "n": 2, "up": True,
                                   "nan": float("nan"), "none": None})
    s.metrics.publish(reg, "serve")
    s.executor.publish(reg, "replicas")
    wm = obs.WindowedMetrics(window_us=100.0)
    s.metrics.add_sink(wm)
    f = s.submit(np.ones((1, 2), np.float32))
    s.drain()
    f.result(0)
    wm.publish(reg, "windows")
    return reg


def test_registry_snapshot_and_prometheus_text_match_reference():
    ref, port = _registry("ref").snapshot(), _registry("port").snapshot()
    assert json.dumps(port, sort_keys=True, default=str) == \
        json.dumps(ref, sort_keys=True, default=str)
    text = P.to_prometheus_text(port)
    assert text == R.to_prometheus_text(ref)
    assert "repro_sched_completed_total 3" in text
    assert "repro_flags_up 1" in text and "repro_flags_policy" not in text
    assert P.to_prometheus_text({}) == ""


def test_metrics_server_serves_the_registry():
    reg = _registry("port")
    want_text = R.to_prometheus_text(_registry("ref").snapshot())
    srv = P.MetricsServer(reg, port=0)
    try:
        assert srv.url.startswith("http://127.0.0.1:")
        with urllib.request.urlopen(srv.url, timeout=5) as r:
            assert r.status == 200
            assert "version=0.0.4" in r.headers["Content-Type"]
            assert r.read().decode() == want_text
        with urllib.request.urlopen(srv.url + ".json", timeout=5) as r:
            doc = json.loads(r.read())
        assert doc["counters"]["sched.completed"] == 3
        assert doc["replicas"]["policy"] == "rr"
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(srv.url.rsplit("/", 1)[0] + "/nope",
                                   timeout=5)
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# kernelprof: the latency table
# ---------------------------------------------------------------------------

def _grid_rows():
    rng = np.random.default_rng(3)
    return [{"source": "grid", "level_width": w, "k": 6, "fanin": f,
             "device_us": float(rng.uniform(1.0, 9.0) * w),
             "w_words": 128}
            for w in (4, 16, 64) for f in (2, 4, 6)] + \
        [{"source": "plan", "level": 0, "level_width": 62, "k": 6,
          "fanin": 3.0, "device_us": 5.0, "w_words": 128},
         {"source": "tile", "level": 0, "tile": 0, "level_width": 32,
          "k": 4, "fanin": 2.0, "device_us": 2.0, "w_words": 128}]


def test_latency_table_estimates_and_blend_match_reference(tmp_path):
    rows = _grid_rows()
    rt, pt = (ref_kp.LatencyTable(rows=[dict(r) for r in rows]),
              kp.LatencyTable(rows=[dict(r) for r in rows]))
    queries = [(w, f, k) for w in (0, 1, 3.5, 4, 10, 16, 40, 64, 100, 1e4)
               for f in (0.0, 1.5, 2, 3.0, 4.7, 6, 9) for k in (6, 4)]
    factors = [2.0, 0.5, 1e9, float("nan"), -1.0, 0.0, 3.3, 1e-9, 1.1]
    for factor in [None] + factors:
        if factor is not None:
            assert pt.blend_scale(factor, alpha=0.3) == \
                rt.blend_scale(factor, alpha=0.3)
        for w, f, k in queries:
            assert pt.estimate_level_us(w, f, k=k) == \
                rt.estimate_level_us(w, f, k=k), (w, f, k, factor)
    for bad in ((float("nan"), 2), (4, float("inf"))):
        for t in (pt, rt):
            with pytest.raises(ValueError):
                t.estimate_level_us(*bad)
    with pytest.raises(kp.LatencyTableError):
        pt.estimate_level_us(4, 2, k=5)
    with pytest.raises(kp.EmptyLatencyTable):
        kp.LatencyTable(rows=[]).estimate_level_us(4, 2)
    assert issubclass(kp.EmptyLatencyTable, kp.LatencyTableError)
    assert issubclass(kp.LatencyTableError, ValueError)
    path = str(tmp_path / "t.json")
    pt.save(path)
    for load in (kp.LatencyTable.load, ref_kp.LatencyTable.load):
        back = load(path)
        assert (back.rows, back.scale) == (pt.rows, pt.scale)
    assert pt.to_dict()["kind"] == rt.to_dict()["kind"]


# ---------------------------------------------------------------------------
# kernelprof: plans of the served JSC-S netlist and the synthetic level
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jsc_plans():
    """The port's mapped JSC-S netlist (seeded, projected to its fanins)
    and the same netlist as the reference's ``MappedNetwork``, each
    compiled to its package's device plan with a 32-slot tile plan."""
    from repro_torch.configs.jsc import JSC_S
    from repro_torch.models.mlp import final_masks, init_mlp, to_logic
    from repro_torch.synth import compile_device_plan
    from repro_torch.synth.executor import BitplaneNetwork

    model = init_mlp(JSC_S, torch.Generator().manual_seed(0))
    model.set_masks(final_masks(JSC_S, model))
    mapped = BitplaneNetwork.from_logic_network(
        to_logic(JSC_S, model), engine="numpy", device="cpu").mapped
    ref_mapped = RefMappedNetwork(
        mapped.n_pis, mapped.k,
        [RefMappedLUT(l.root, tuple(l.leaves), l.tt) for l in mapped.luts],
        list(mapped.outputs))
    return (compile_device_plan(mapped, tile_rows=32),
            ref_compile_device_plan(ref_mapped, tile_rows=32))


def test_plan_fanins_match_reference_on_jsc_s(jsc_plans):
    dp, rdp = jsc_plans
    assert dp.n_levels > 1 and dp.tiles.n_tiles >= dp.n_levels
    assert kp.plan_level_fanins(dp) == ref_kp.plan_level_fanins(rdp)
    assert kp.tile_plan_fanins(dp.tiles) == \
        ref_kp.tile_plan_fanins(rdp.tiles)


def _ref_single_level(width, fanin, k, w_words, seed):
    """The synthetic level exactly as the reference's
    ``time_single_level`` draws it (flat slots, reference wiring)."""
    rng = np.random.default_rng(seed)
    n_pis = max(int(width), fanin, 1)
    leaf = np.zeros((width, k), np.int32)
    leaf[:, :fanin] = rng.integers(1, n_pis + 1, (width, fanin))
    tt = (rng.integers(0, 2, (width, 1 << k)).astype(np.uint32)
          * np.uint32(0xFFFFFFFF))
    ow = (np.arange(width, dtype=np.int32) + n_pis + 1)
    words = rng.integers(0, 1 << 31, (n_pis, w_words), dtype=np.int64)
    return words.astype(np.int32), leaf, tt, ow, n_pis, 1 + n_pis + width


@pytest.mark.parametrize("width,fanin,k", [(4, 2, 6), (16, 4, 6),
                                           (64, 6, 6), (5, 3, 3)])
def test_single_level_plan_matches_reference_and_its_oracle(width, fanin,
                                                            k):
    from repro_torch.kernels.lut_eval import lut_eval
    plan = kp.single_level_plan(width, fanin, k=k, w_words=9, seed=7)
    words, leaf, tt, ow, n_pis, n_wires = _ref_single_level(
        width, fanin, k, 9, 7)
    np.testing.assert_array_equal(plan["words"], words)
    np.testing.assert_array_equal(plan["leaf_idx"][0], leaf)
    np.testing.assert_array_equal(plan["tt_bits"][0], tt)
    np.testing.assert_array_equal(plan["out_wires"][0], ow)
    assert (plan["n_pis"], plan["n_wires"]) == (n_pis, n_wires)
    got = lut_eval(*(kp._int32(plan[n], torch.device("cpu")) for n in
                     ("words", "leaf_idx", "tt_bits", "out_wires")),
                   n_wires=n_wires)
    want = ref_lut_eval_ref(words, leaf, tt.view(np.int32), ow,
                            n_pis=n_pis, n_wires=n_wires)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_profile_plan_prefixes_on_cpu(jsc_plans):
    """profile_plan's level prefixes are plans the walk takes, each
    plane equal to the reference oracle's on the same prefix; its rows
    carry the reference's keys, finite and non-negative."""
    from repro_torch.kernels.lut_eval import lut_eval
    dp, rdp = jsc_plans
    cpu = torch.device("cpu")
    words = kp._random_words(np.random.default_rng(0), dp.n_pis, 4, cpu)
    for n in (1, dp.n_levels // 2 + 1, dp.n_levels):
        got = lut_eval(words, kp._int32(dp.leaf_idx[:n], cpu),
                       kp._int32(dp.tt_bits[:n], cpu),
                       kp._int32(dp.out_wires[:n], cpu), n_wires=dp.n_wires)
        want = ref_lut_eval_ref(
            words.numpy(), rdp.leaf_idx[:n].reshape(-1, rdp.k),
            np.ascontiguousarray(rdp.tt_bits[:n].reshape(
                -1, 1 << rdp.k)).view(np.int32),
            rdp.out_wires[:n].reshape(-1), n_pis=rdp.n_pis,
            n_wires=rdp.n_wires)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rows = kp.profile_plan(dp, w_words=4, iters=1, device="cpu")
    assert [r["level"] for r in rows] == list(range(dp.n_levels))
    assert {tuple(sorted(r)) for r in rows} == {
        ("device_us", "fanin", "k", "level", "level_width", "prefix_us",
         "source", "w_words")}
    assert all(r["source"] == "plan" and math.isfinite(r["device_us"])
               and r["device_us"] >= 0 for r in rows)
    assert [r["fanin"] for r in rows] == \
        [round(f, 2) for f in ref_kp.plan_level_fanins(rdp)]


def test_profile_tile_plan_prefixes_end_inside_levels(jsc_plans):
    """A tile prefix that ends inside a level walks only its own tiles:
    ``level_start`` comes from the prefix's ``level_of_tile``, so each
    prefix plane equals the whole walk's on the rows its tiles write
    and is zero past them."""
    from repro_torch.kernels.lut_eval import level_starts, lut_eval_streamed
    tp = jsc_plans[0].tiles
    cpu = torch.device("cpu")
    words = kp._random_words(np.random.default_rng(1), tp.n_pis, 4, cpu)
    tt, leaf, ob = (kp._int32(a, cpu) for a in
                    (tp.tt_tiles, tp.leaf_tiles, tp.out_base))
    full = lut_eval_streamed(words, tt, leaf, ob,
                             kp._int32(level_starts(tp.level_of_tile), cpu),
                             n_rows=tp.n_rows)
    inside = [n for n in range(1, tp.n_tiles)
              if tp.level_of_tile[n - 1] == tp.level_of_tile[n]]
    assert inside, "no level of the served plan spans two tiles"
    for n in inside + [tp.n_tiles]:
        got = lut_eval_streamed(
            words, tt[:n], leaf[:n], ob[:n],
            kp._int32(level_starts(tp.level_of_tile[:n]), cpu),
            n_rows=tp.n_rows)
        written = np.zeros(tp.n_rows, bool)
        written[: tp.n_pis + 1] = True
        for t in range(n):
            written[tp.out_base[t]: tp.out_base[t] + tp.tile_rows] = True
        np.testing.assert_array_equal(got[written].numpy(),
                                      full[written].numpy())
        assert not got[~written].any()
    rows = kp.profile_tile_plan(tp, w_words=4, iters=1, device="cpu")
    assert [r["tile"] for r in rows] == list(range(tp.n_tiles))
    assert [r["level"] for r in rows] == tp.level_of_tile.tolist()
    assert all(r["source"] == "tile" and r["device_us"] >= 0 for r in rows)


def test_build_latency_table_on_cpu_names_the_cpu(jsc_plans, tmp_path):
    dp = jsc_plans[0]
    table = kp.build_latency_table(dp, widths=(4, 16), fanins=(2, 6),
                                   w_words=4, iters=1, device="cpu")
    by_source = {}
    for r in table.rows:
        by_source.setdefault(r["source"], []).append(r)
    assert len(by_source["grid"]) == 4
    assert len(by_source["plan"]) == dp.n_levels
    assert len(by_source["tile"]) == dp.tiles.n_tiles
    assert all(math.isfinite(r["device_us"]) and r["device_us"] >= 0
               for r in table.rows)
    assert table.meta == {"backend": "cpu", "device": "cpu",
                          "power_limit": None, "w_words": 4, "iters": 1,
                          "k": dp.k}
    assert table.estimate_plan_us(dp) > 0
    # the saved artifact is one the reference loads
    back = ref_kp.LatencyTable.load(table.save(str(tmp_path / "t.json")))
    assert back.rows == table.rows and back.meta["backend"] == "cpu"


def test_kernelprof_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from repro_torch.device import NoCudaDeviceError
    with pytest.raises(NoCudaDeviceError):
        kp.measure_level_grid(widths=(4,), fanins=(2,), w_words=1)


# ---------------------------------------------------------------------------
# Online profiler
# ---------------------------------------------------------------------------

class _FakeSched:
    def __init__(self):
        self.pushed = []

    def update_exec_estimate(self, us):
        self.pushed.append(us)


def _online(pkg):
    obs, serve = PKGS[pkg]
    table = obs.LatencyTable(rows=_grid_rows(), meta={}, scale=1.25)
    sched = _FakeSched()
    rs = serve.ReplicaSet([lambda x: x], clock=serve.FakeClock(),
                          exec_seed_us=100.0)
    prof = obs.OnlineProfiler(table, predicted_us=120.0, sample_every=3,
                              alpha=0.4, min_rows=8).attach(
        scheduler=sched, replicas=rs)
    trail = []
    for i, (us, rows) in enumerate([(200.0, 32), (90.0, 2), (-1.0, 32),
                                    (150.0, 64), (1e7, 32), (80.0, 0)]
                                   * 5):
        prof.observe(us, rows=rows)
        trail.append((prof.stats(), table.scale))
    reg = obs.MetricsRegistry()
    prof.publish(reg)
    return trail, sched.pushed, rs.stats(), reg.snapshot()


def test_online_profiler_matches_reference():
    ref, port = _online("ref"), _online("port")
    assert port == ref
    assert port[0][-1][0]["n_sampled"] > 0
    with pytest.raises(ValueError):
        P.OnlineProfiler(kp.LatencyTable(rows=_grid_rows()),
                         predicted_us=0.0)


def test_obs_exports_the_reference_names():
    assert sorted(P.__all__) == sorted(R.__all__)
    for name in P.__all__:
        assert hasattr(P, name), name
    assert dataclasses.is_dataclass(P.LatencyTable)
