"""repro_torch.bench.loadgen against the reference's
benchmarks/loadgen.py: the arrival process, the busy-server replay and
the record rows exactly; each load generator's results and snapshot
keys on the same executor; and tiny ``run(device="cpu")`` calls, one
through every backend family, traced, one with two replicas a backend,
whose labels equal ``classify`` in every section and whose record has
the reference record's keys. Also the launcher's ``--sched`` / ``--loadgen`` /
``--trace`` / ``--metrics-port`` flags on the CPU."""
import json
import math
import os

import numpy as np
import pytest

from benchmarks import loadgen as ref_lg
from repro.check.tracecheck import check_trace
from repro_torch.bench import loadgen as lg
from repro_torch.bench.meta import bench_meta
from repro_torch.obs import MetricsRegistry, analyze_trace
from repro_torch.obs import load_trace_events as P_load

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # JSC-S training and synthesis here are many tiny ops, slowest
    # with a thread pool (and beside other test workers)
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_record():
    with open(os.path.join(ROOT, "BENCH_serve.json")) as f:
        return json.load(f)["results"]


@pytest.mark.parametrize("n,qps,seed", [(1, 10.0, 0), (500, 2e4, 3),
                                        (64, 123.4, 9)])
def test_arrivals_and_busy_server_replay_match_reference(n, qps, seed):
    arr = lg.poisson_arrivals_us(n, qps, seed)
    np.testing.assert_array_equal(arr, ref_lg.poisson_arrivals_us(n, qps,
                                                                  seed))
    call = np.random.default_rng(seed).exponential(1e6 / qps, n)
    assert lg.replay_busy_server(arr, call) == \
        ref_lg.replay_busy_server(arr, call)


def test_backend_names_map_to_the_port():
    assert lg.parse_backend("bitplane-streamed") == ("bitplane",
                                                     "cuda-streamed")
    assert lg.parse_backend("bitplane-cuda") == ("bitplane", "cuda")
    assert lg.parse_backend("bitplane", "numpy") == ("bitplane", "numpy")
    assert lg.parse_backend("bitplane") == ("bitplane", None)
    assert lg.parse_backend("lut_layer") == ("lut_layer", None)
    assert lg.parse_backend("gather") == ("gather", None)
    assert ref_lg.parse_backend("bitplane-pallas") == ("bitplane", "pallas")
    assert len(lg.BACKENDS) == len(ref_lg.BACKENDS)


def _sum_executor(x):
    return np.round(x.sum(axis=-1)).astype(np.int32)


@pytest.mark.parametrize("mode", ["open", "slo", "closed"])
def test_load_generators_match_reference(mode):
    """The same executor and requests through each package's load
    generator: the same results and the same snapshot keys; the rows
    the record keeps hold the same keys."""
    xs = np.random.default_rng(0).integers(0, 4, (96, 3)).astype(np.float32)
    want = _sum_executor(xs)
    got = {}
    for name, mod in (("port", lg), ("ref", ref_lg)):
        if mode == "open":
            res, snap = mod.run_open_loop(_sum_executor, xs, 5e4, seed=1,
                                          max_batch=16)
            rows = mod._snap_row(snap)
        elif mode == "slo":
            res, lanes, snap = mod.run_slo_lanes(
                _sum_executor, xs, 5e4, (1e6, 1e7), seed=1, max_batch=16)
            rows = {k: mod._lane_row(v, 1e6)
                    for k, v in snap["lanes"].items()}
            np.testing.assert_array_equal(lanes, np.where(
                np.arange(96) % 4 == 0, 0, 1))
        else:
            res, snap = mod.run_closed_loop(_sum_executor, xs,
                                            concurrency=8, max_batch=16)
            rows = mod._snap_row(snap)
        np.testing.assert_array_equal(res, want)
        got[name] = (sorted(snap), json.loads(json.dumps(
            rows, default=str), object_hook=sorted))
    assert got["port"][0] == got["ref"][0]
    assert got["port"][1] == got["ref"][1]


def test_tracer_overhead_record_matches_reference():
    xs = np.ones((40, 3), np.float32)
    port = lg.measure_tracer_overhead(_sum_executor, xs, max_batch=8,
                                      trials=2, concurrency=4)
    ref = ref_lg.measure_tracer_overhead(_sum_executor, xs, max_batch=8,
                                         trials=2, concurrency=4)
    assert sorted(port) == sorted(ref)
    assert port["trials"] == 2 and port["trace_events"] > 0
    assert all(p >= 0 for p in port["overhead_pct_pairs"])


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """JSC-S trained 5 steps on the CPU, 48 requests through gather,
    lut_layer and the streamed bitplane walk, open and closed loop and
    the SLO lanes, traced, behind a registry."""
    d = tmp_path_factory.mktemp("loadgen")
    trace = str(d / "t.json")
    reg = MetricsRegistry()
    before = os.path.getmtime(os.path.join(ROOT, "BENCH_serve.json"))
    out = lg.run(fast=True, backends=("gather", "lut_layer",
                                      "bitplane-streamed"),
                 n_requests=48, steps=5, loadgen="both", n_replicas=1,
                 trace=trace, registry=reg, device="cpu")
    assert os.path.getmtime(os.path.join(ROOT, "BENCH_serve.json")) == \
        before
    assert not os.path.exists(os.path.join(ROOT, lg.OUT_NAME))
    return out, trace, reg


def test_tiny_run_serves_like_classify_everywhere(tiny_run):
    out = tiny_run[0]
    assert out["argmax_identical_across_backends"]
    for b, rec in out["backends"].items():
        assert rec["open_loop"]["identical_to_classify"], b
        assert rec["closed_loop"]["identical_to_classify"], b
        assert rec["slo_lanes"]["identical_on_served"], b
        assert rec["open_loop"]["completed"] == 48, b
    assert out["backends"]["bitplane-streamed"]["engine"] == "cuda-streamed"


def test_tiny_run_has_the_reference_record_keys(tiny_run):
    out = tiny_run[0]
    ref = _ref_record()
    assert sorted(out) == sorted(ref)
    for sec in ("baseline_sequential", "tracer_overhead", "trace"):
        assert sorted(out[sec]) == sorted(ref[sec]), sec
    gather_ref = ref["backends"]["gather"]
    for b, rec in out["backends"].items():
        for sec in ("open_loop", "slo_lanes"):
            assert sorted(rec[sec]) == sorted(gather_ref[sec]), (b, sec)
        for lane, row in rec["slo_lanes"]["lanes"].items():
            assert sorted(row) == sorted(
                gather_ref["slo_lanes"]["lanes"]["0"]), (b, lane)
        # closed_loop is open_loop's row less the sequential ratio
        assert sorted(rec["closed_loop"]) == sorted(
            set(gather_ref["open_loop"]) - {"throughput_x_sequential"})
    assert sorted(out["backends"]["bitplane-streamed"]) == [
        "closed_loop", "engine", "online_profile", "open_loop",
        "slo_lanes"]


def test_tiny_run_trace_passes_reference_structure_check(tiny_run):
    """The reference's structural trace pass (spans well formed, every
    request closed, valid flush reasons). Phase reconciliation of a
    threaded trace depends on where the interpreter switches threads,
    so it is gated on the card (``chip_smoke.py``) and under a
    ``FakeClock`` here, not on this CPU."""
    out, trace, _ = tiny_run
    assert out["trace"]["dropped"] == 0 and out["trace"]["events"] > 0
    rep = check_trace(P_load(trace))
    assert rep.ok, rep.format()
    assert analyze_trace(trace).reconciliation()["n_checked"] > 0
    with open(trace) as f:
        other = json.load(f)["otherData"]
    for b in out["backends"]:
        for sec in ("windows", "open_loop", "slo_lanes", "closed_loop"):
            assert f"{b}.{sec}" in other, (b, sec)
    assert "bitplane-streamed.online_profile" in other


def test_tiny_run_latency_table_names_the_cpu(tiny_run):
    out = tiny_run[0]
    with open(out["trace"]["lut_table"]) as f:
        doc = json.load(f)
    assert doc["meta"]["backend"] == "cpu" and doc["meta"]["device"] == "cpu"
    sources = {r["source"] for r in doc["rows"]}
    assert sources == {"grid", "plan", "tile"}
    assert all(math.isfinite(r["device_us"]) and r["device_us"] >= 0
               for r in doc["rows"])
    assert out["trace"]["exec_estimate_us"]["bitplane-streamed"] > 0


def test_run_with_two_replicas_serves_like_classify():
    """The replica branch of ``run``: two engines a backend behind
    ``least_slack``, their dispatch stats published."""
    reg = MetricsRegistry()
    out = lg.run(fast=True, backends=("gather", "lut_layer"),
                 n_requests=40, steps=3, loadgen="both", n_replicas=2,
                 registry=reg, device="cpu")
    snap = reg.snapshot()
    for b, rec in out["backends"].items():
        assert rec["open_loop"]["identical_to_classify"], b
        assert rec["closed_loop"]["identical_to_classify"], b
        assert rec["slo_lanes"]["identical_on_served"], b
        reps = snap[f"{b}.replicas"]
        assert reps["policy"] == "least_slack"
        assert len(reps["replicas"]) == 2
        assert sum(r["served"] for r in reps["replicas"]) > 0
    assert "trace" not in out


def test_bench_meta_names_versions_and_device():
    meta = bench_meta(seed=3, device="cpu")
    assert meta["seed"] == 3 and meta["backend"] == "cpu"
    assert meta["torch_version"] and meta["python"]
    assert not any(k.startswith("jax") for k in meta)


def test_launcher_sched_replicas_trace_and_metrics_on_cpu(tmp_path,
                                                          capsys):
    from repro_torch.launch.serve import main
    from repro_torch.obs.analyze import main as analyze_main
    trace = str(tmp_path / "t.json")
    stats = main(["--mode", "logic", "--device", "cpu", "--train-steps",
                  "5", "--requests", "2", "--backend", "lut_layer",
                  "--sched", "--replicas", "2", "--slo-us",
                  "200000,2000000", "--trace", trace,
                  "--metrics-port", "0"])
    text = capsys.readouterr().out
    assert "metrics endpoint: http://127.0.0.1:" in text
    assert "sched x2: 128 requests" in text
    assert stats["completed"] + stats["shed"] == 128
    assert stats["launches"]["lut_layer"] == 0          # the CPU
    assert check_trace(P_load(trace)).ok
    with open(trace) as f:
        other = json.load(f)["otherData"]
    assert other["replicas"]["policy"] == "least_slack"
    # exit 0 when the report reconciles, 1 when it does not
    assert analyze_main(["--trace", trace]) in (0, 1)
    assert "reconciliation:" in capsys.readouterr().out


def test_launcher_loadgen_on_cpu(tmp_path, capsys):
    from repro_torch.launch.serve import main
    rec = main(["--mode", "logic", "--device", "cpu", "--train-steps", "3",
                "--requests", "24", "--loadgen", "closed"])
    assert rec["closed_loop"]["identical_to_classify"]
    assert "closed_loop:" in capsys.readouterr().out
