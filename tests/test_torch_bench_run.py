"""The port's benchmark runner and its tooling on the CPU:
``repro_torch.bench.run`` (the twin of ``benchmarks/run.py``),
``repro_torch.bench.check_regression`` and ``repro_torch.bench.history``.

The regression-gate tests twin the reference's ``tests/test_check.py``
ones (``_run_regression`` runs the module as a script, as the
reference's runs ``benchmarks/check_regression.py``); the ledger and
tracer-overhead tests twin ``tests/test_obs_analyze.py``'s, each
checked against the reference module on the same documents."""
import json
import os
import subprocess
import sys

import pytest
import torch

from benchmarks import check_regression as ref_regress
from benchmarks import history as ref_history
from repro_torch.bench import check_regression, history, run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# check_regression (twins of tests/test_check.py)
# ---------------------------------------------------------------------------

def _run_regression(args, cwd=None):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.bench.check_regression"] + args,
        capture_output=True, text=True, cwd=cwd or ROOT, env=env)


def test_check_regression_unparsable_baseline_is_actionable(tmp_path):
    # the reference's fresh file is the committed BENCH_kernels.json at
    # the repo root; the port commits no record, so one is written here
    fresh = tmp_path / "fresh"
    fresh.mkdir()
    (fresh / "BENCH_kernels_torch.json").write_text(json.dumps(
        {"section": "kernels", "results": {"x_us": 100.0}}))
    (tmp_path / "BENCH_kernels_torch.json").write_text("{nope")
    p = _run_regression(["--files", "BENCH_kernels_torch.json",
                         "--fresh-dir", str(fresh),
                         "--baseline-dir", str(tmp_path)])
    assert p.returncode == 2
    assert "not valid JSON" in p.stdout
    assert "Traceback" not in p.stdout + p.stderr


def test_check_regression_unparsable_fresh_is_actionable(tmp_path):
    (tmp_path / "BENCH_kernels_torch.json").write_text("{nope")
    p = _run_regression(["--files", "BENCH_kernels_torch.json",
                         "--fresh-dir", str(tmp_path)])
    assert p.returncode == 2
    assert "not valid JSON" in p.stdout
    assert "Traceback" not in p.stdout + p.stderr


def test_check_regression_missing_baseline_skips(tmp_path):
    doc = {"section": "kernels", "results": {"x_us": 1.0}}
    (tmp_path / "BENCH_new_thing.json").write_text(json.dumps(doc))
    p = _run_regression(["--files", "BENCH_new_thing.json",
                         "--fresh-dir", str(tmp_path)])
    assert p.returncode == 0
    assert "no baseline" in p.stdout


def test_check_regression_defaults_to_the_port_records():
    assert check_regression.DEFAULT_FILES == ("BENCH_kernels_torch.json",
                                              "BENCH_serve_torch.json")
    assert check_regression.REPO_ROOT == ROOT


# ---------------------------------------------------------------------------
# history (twins of tests/test_obs_analyze.py)
# ---------------------------------------------------------------------------

def _bench_doc(sha, p95, overhead):
    return {"section": "serve",
            "meta": {"git_sha": sha,
                     "timestamp_utc": f"2026-08-08T00:00:0{sha[-1]}Z"},
            "results": {"baseline_sequential": {"p95_us": p95,
                                                "qps": 1000.0},
                        "tracer_overhead": {"overhead_pct": overhead}}}


def test_history_ledger_idempotent_append_and_report(tmp_path):
    path = str(tmp_path / "ledger.jsonl")
    assert history.append_entry(_bench_doc("a0", 100.0, 1.0),
                                path=path) is not None
    # same provenance again: skipped, the ledger stays single-entry
    assert history.append_entry(_bench_doc("a0", 100.0, 1.0),
                                path=path) is None
    assert history.append_entry(_bench_doc("b1", 150.0, 1.2),
                                path=path) is not None
    entries = history.load_history(path)
    assert len(entries) == 2
    series = history.trajectory(entries, section="serve")
    p95 = series["serve/sequential/p95_us"]
    assert p95["n"] == 2 and p95["first"] == 100.0 and p95["last"] == 150.0
    assert p95["change_pct"] == pytest.approx(50.0)   # lower-better: worse
    qps = series["serve/sequential/qps"]
    assert qps["change_pct"] == 0.0                   # flat
    text = history.format_report(series)
    assert "serve/sequential/p95_us" in text and "drifting" in text
    assert series == ref_history.trajectory(entries, section="serve")
    assert text == ref_history.format_report(series)
    # corrupt trailing line (killed job) must not poison the ledger
    with open(path, "a") as f:
        f.write("{truncated")
    assert len(history.load_history(path)) == 2
    assert history.trajectory([], section="serve") == {}
    assert "empty" in history.format_report({})


def test_history_cli(tmp_path, capsys):
    bench = tmp_path / "BENCH_serve_torch.json"
    bench.write_text(json.dumps(_bench_doc("c2", 120.0, 0.5)))
    ledger = str(tmp_path / "ledger.jsonl")
    assert history.main(["--ledger", ledger, "append", str(bench)]) == 0
    capsys.readouterr()
    assert history.main(["--ledger", ledger, "report", "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["serve/tracer/overhead_pct"]["n"] == 1
    assert history.main(["--ledger", ledger, "report"]) == 0
    assert "serve/tracer/overhead_pct" in capsys.readouterr().out
    assert history.main(["--ledger", ledger, "append",
                         str(tmp_path / "missing.json")]) == 0
    assert history.main(["--ledger", ledger, "append", str(bench)]) == 0
    assert "skipped" in capsys.readouterr().out


def test_history_ledger_defaults_under_build():
    assert history.DEFAULT_LEDGER == os.path.join(
        ROOT, "build", "bench", "history_torch.jsonl")


def test_check_regression_tracer_overhead_floored():
    base = check_regression.extract_metrics(_bench_doc("a0", 100.0, 0.3))
    noisy = check_regression.extract_metrics(_bench_doc("b1", 100.0, 1.2))
    bad = check_regression.extract_metrics(_bench_doc("c2", 100.0, 40.0))
    assert base["serve/tracer/overhead_pct"] == (0.3, "lower")
    assert base == ref_regress.extract_metrics(_bench_doc("a0", 100.0, 0.3))
    # sub-floor wobble (0.3% -> 1.2%) compares as equal…
    regs, checked, _, _ = check_regression.compare(
        base, noisy, tolerance=0.25, min_us=50.0)
    assert not regs and any(n == "serve/tracer/overhead_pct"
                            for n, *_ in checked)
    # …while a real overhead explosion (0.3% -> 40%) still fails
    regs, _, _, _ = check_regression.compare(base, bad, tolerance=0.25,
                                             min_us=50.0)
    assert any(n == "serve/tracer/overhead_pct" for n, *_ in regs)
    assert (check_regression.compare(base, bad, 0.25, 50.0)
            == ref_regress.compare(base, bad, 0.25, 50.0))


# ---------------------------------------------------------------------------
# run: the benchmark runner
# ---------------------------------------------------------------------------

def test_run_latency_writes_the_reference_layout(tmp_path, capsys):
    ledger = str(tmp_path / "history.jsonl")
    res = run.main(["--fast", "--only", "latency", "--device", "cpu",
                    "--out-dir", str(tmp_path), "--history", ledger])
    assert set(res) == {"latency"}
    assert res["latency"]["train"]["steps"] == 200     # the reference's
    out = capsys.readouterr().out
    assert "name,us_per_call,derived" in out
    assert "latency/logic," in out and "[bench] history: latency" in out
    path = run.bench_path(str(tmp_path), "latency")
    assert os.path.basename(path) == "BENCH_latency_torch.json"
    doc = json.loads(open(path).read())
    assert set(doc) == {"section", "meta", "rows", "results"}
    assert doc["section"] == "latency"
    assert doc["meta"]["backend"] == "cpu" and doc["meta"]["git_sha"]
    assert [r["name"] for r in doc["rows"]] == ["latency/logic"]
    assert doc["results"]["backend"] == "cpu"
    metrics = check_regression.extract_metrics(doc)
    assert metrics == ref_regress.extract_metrics(doc)
    for key in ("logic_us", "logic_pallas_us", "dense_float_us", "xnor_us",
                "bitplane_streamed_us", "logic_vs_dense_x", "batch"):
        assert f"latency/{key}" in metrics
    # device µs are not measured on the CPU, so never read as metrics
    assert not any("device" in name for name in metrics)
    # the gate reads the file against itself; the ledger skips a rerun
    assert check_regression.main(
        ["--files", "BENCH_latency_torch.json", "--fresh-dir",
         str(tmp_path), "--baseline-dir", str(tmp_path)]) == 0
    assert "metrics checked" in capsys.readouterr().out
    assert len(history.load_history(ledger)) == 1
    assert history.append_file(path, path=ledger) is None


def _fake_sections(monkeypatch):
    """Every section's twin replaced by a stub that records its call."""
    from repro_torch.bench import (ablations, kernels_bench, latency,
                                   loadgen, roofline, table1_jsc)
    calls = {}
    r1 = {"accuracy": 0.5, "synth": {"equivalent": True},
          "nullanet": {"luts": 9, "backend": "synth", "depth": 2,
                       "fmax_mhz": 700.0},
          "nullanet_model": {"luts": 9}, "lut_reduction_x": 11.9,
          "latency_reduction_x": 2.0}
    lat = {"logic_us": 100.0, "dense_float_us": 20.0,
           "logic_vs_dense_x": 0.2}
    sr = {"p95_us": 90.0, "qps": 1000.0, "p50_us": 50.0, "p99_us": 99.0,
          "mean_batch_occupancy": 0.1, "identical_to_classify": True}
    serve = {"baseline_sequential": {"p95_us": 80.0, "qps": 900.0,
                                     "p50_us": 40.0,
                                     "service_p95_us": 70.0},
             "backends": {"gather": {"engine": None, "closed_loop": sr}}}

    def stub(name, value):
        def f(**kw):
            calls[name] = kw
            return value
        return f

    monkeypatch.setattr(table1_jsc, "run", stub("table1", {"jsc-s": r1}))
    monkeypatch.setattr(latency, "run", stub("latency", lat))
    monkeypatch.setattr(ablations, "run", stub(
        "ablation", {"activation_selection": {}, "fcp_schedule": {}}))
    monkeypatch.setattr(kernels_bench, "run", stub(
        "kernels", {"xnor_pallas_us": 3.0}))
    monkeypatch.setattr(loadgen, "run", stub("serve", serve))
    roof = {"arch": "glm4-9b", "shape": "train_4k", "mesh": "single",
            "t_compute_s": 2.0, "t_memory_s": 1.0, "t_collective_s": 0.5,
            "dominant": "compute", "roofline_fraction": 0.25}
    monkeypatch.setattr(roofline, "run", stub("roofline", [roof]))
    return calls


@pytest.mark.parametrize("fast", [True, False])
def test_run_dispatches_every_section_at_the_reference_steps(
        tmp_path, monkeypatch, capsys, fast):
    calls = _fake_sections(monkeypatch)
    res = run.main((["--fast"] if fast else [])
                   + ["--device", "cpu", "--out-dir", str(tmp_path)])
    assert set(res) == set(calls) == set(run.SECTIONS)
    assert calls["table1"]["steps"] == (300 if fast else 1200)
    assert calls["latency"]["steps"] == (200 if fast else 600)
    assert calls["serve"]["fast"] is fast
    assert not calls["serve"]["write_json"]
    # the roofline reads the dry runs' records and takes no device
    assert calls.pop("roofline") == {}
    assert all(str(kw["device"]) == "cpu" for kw in calls.values())
    out = capsys.readouterr().out
    assert "kernels/xnor_pallas_us,3.0,cpu" in out
    assert "roofline/glm4-9b/train_4k,2000000.0,dom=compute;roofline=25.0%" \
        in out
    assert "serve/gather/closed_loop,90.0," in out
    for section in run.SECTIONS:
        doc = json.loads(open(run.bench_path(str(tmp_path), section)).read())
        assert doc["section"] == section and doc["rows"]
        assert doc["results"] == res[section]
    assert not os.path.exists(os.path.join(str(tmp_path), "history.jsonl"))


def test_run_refuses_an_unknown_section(tmp_path):
    with pytest.raises(SystemExit):
        run.main(["--only", "no_such_section", "--device", "cpu",
                  "--out-dir", str(tmp_path)])
