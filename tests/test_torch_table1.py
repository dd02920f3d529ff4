"""The Table 1 twin (``repro_torch.bench.table1_jsc``) and the example
twins (``repro_torch.examples``) on the CPU, at a few training steps:
the reference's record keys, JSON written only when asked, the mapped
netlist equivalent to the tables, and each example run to its end."""
import json

import pytest
import torch

from repro_torch.bench import table1_jsc

# the record keys of the reference's benchmarks/table1_jsc.py::run_one
RECORD_KEYS = {
    "arch", "accuracy", "float_accuracy", "logicnets_accuracy", "nullanet",
    "nullanet_model", "synth", "logicnets_baseline", "lut_reduction_x",
    "fmax_increase_x", "latency_reduction_x", "minimize_seconds",
    "synth_seconds"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_table1_record_keeps_the_reference_keys(capsys):
    r = table1_jsc.run_one("jsc-s", steps=10, device="cpu")
    assert set(r) == RECORD_KEYS
    assert set(r["nullanet"]) == {"luts", "depth", "ffs", "fmax_mhz",
                                  "latency_ns", "backend"}
    assert set(r["synth"]) == {"equivalent", "luts", "depth", "n_samples",
                               "compile_seconds", "exec_us_per_call",
                               "sat_sweep"}
    assert set(r["synth"]["sat_sweep"]) == {"dup_lut_outputs",
                                            "luts_after_sweep",
                                            "sweep_seconds"}
    assert r["synth"]["equivalent"] and r["nullanet"]["backend"] == "synth"
    assert r["logicnets_baseline"]["luts"] > r["nullanet"]["luts"] > 0
    assert r["synth"]["sat_sweep"]["luts_after_sweep"] == \
        r["synth"]["luts"] - r["synth"]["sat_sweep"]["dup_lut_outputs"]
    out = capsys.readouterr().out
    assert "[table1] jsc-s: LogicNets baseline trained and mapped" in out


def test_table1_writes_json_only_when_asked(tmp_path, monkeypatch):
    calls = []

    def fake_run_one(name, steps, device):
        calls.append((name, steps, str(device)))
        return {"arch": name, "accuracy": 0.5, "logicnets_accuracy": 0.5,
                "float_accuracy": 0.5,
                "nullanet": {"luts": 1, "depth": 1, "fmax_mhz": 1.0},
                "nullanet_model": {"luts": 1},
                "logicnets_baseline": {"luts": 2}, "lut_reduction_x": 2.0,
                "fmax_increase_x": 1.0, "latency_reduction_x": 1.0,
                "synth": {"equivalent": True}}

    monkeypatch.setattr(table1_jsc, "run_one", fake_run_one)
    monkeypatch.chdir(tmp_path)
    res = table1_jsc.main(["--device", "cpu", "--steps", "3", "--arch",
                           "jsc-s", "jsc-m"])
    assert list(res) == ["jsc-s", "jsc-m"] and list(tmp_path.iterdir()) == []
    assert calls == [("jsc-s", 3, "cpu"), ("jsc-m", 3, "cpu")]
    out = tmp_path / "t1.json"
    table1_jsc.main(["--device", "cpu", "--arch", "jsc-l", "--out",
                     str(out)])
    assert json.loads(out.read_text()) == {"jsc-l": fake_run_one(
        "jsc-l", 1200, "cpu")}


def test_quickstart_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    import tempfile

    from repro_torch.examples import quickstart
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "bit-exact: OK" in out and out.rstrip().endswith("done.")
    text = (tmp_path / "nullanet_tiny.v").read_text()
    assert text.startswith("// nullanet_tiny: fixed-function")
    assert "module nullanet_tiny (" in text


def test_serve_logic_runs_on_the_cpu(capsys):
    from repro_torch.examples import serve_logic
    serve_logic.main(["--device", "cpu"])
    lines = [l for l in capsys.readouterr().out.splitlines()
             if "12 requests x128" in l]
    assert [l.split("]")[0].strip("[ ") for l in lines] == ["gather",
                                                           "lut_layer"]
    accs = {l.split("acc=")[1].split()[0] for l in lines}
    assert len(accs) == 1                 # both backends, the same labels
