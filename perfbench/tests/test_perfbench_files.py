"""Every configuration, mix, limit and metric of BENCHMARK.json is found
by its name, and the file keeps to the benchmark's contract."""
import re

import pytest

from perfbench import harness

SPEC = harness.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_command_and_paths():
    assert SPEC["command"] == ["python3", "perfbench/run.py"]
    assert SPEC["paths"] == ["perfbench"]
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_files_load_by_name(cell):
    config = harness.load_config(SPEC, cell["config"])
    mix = harness.load_traffic(cell["traffic"])
    limits = harness.load_limits(cell["name"])
    assert config["arch"]["n_layers"] >= 1
    assert (harness.HERE / "kinds" / f"{mix['kind']}.py").exists()
    assert hasattr(harness.kind_module(mix["kind"]), "run")
    assert limits and all(v > 0 for v in limits.values())
    assert cell["chips"] == 1


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_each_cell_reports_setup_another_metric_and_a_layer(cell):
    e2e = {m["name"] for m in harness.cell_metrics(SPEC, cell["name"],
                                                   "end_to_end")}
    layers = harness.cell_metrics(SPEC, cell["name"], "per_layer")
    assert "setup_s" in e2e and len(e2e) >= 2 and layers
    for m in layers:
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.metric_reader(metric["name"]))


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_reductions_listed(config):
    body = harness.load_config(SPEC, config["name"])
    assert body["name"] == config["name"]
    assert sorted(body["reduced"]) == sorted(config["reduced"])
    for key in config["reduced"]:
        assert key in body["published"] and key in body["arch"]
        assert body["published"][key] != body["arch"][key]
    assert config["file"].startswith("perfbench/")


def test_names_units_and_bounds():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [c["name"] for c in SPEC["workloads"] + SPEC["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for c in SPEC["workloads"]:
        assert len(c["why"]) <= 200
