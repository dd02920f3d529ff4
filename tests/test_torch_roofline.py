"""The port's roofline and report (``repro_torch.bench.roofline``,
``repro_torch.bench.report``) and ``repro_torch.bench.run``'s roofline
section against the reference's ``benchmarks/roofline.py``.

The model arithmetic (``model_flops``, ``kv_cache_bytes``,
``analytic_memory_bytes``) ports as it is, so it is held equal on the
same records. The roofline's terms differ only by the rates: a TPU
v5e's in the reference, an H100 SXM's in the port, so each term is the
reference's times the rate ratio, within 1e-12 relative (float
rounding of the ratio).
"""
import json
import os

import pytest

from benchmarks import roofline as ref_roofline
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro_torch.bench import report, roofline, run
from repro_torch.bench.meta import REPO_ROOT
from repro_torch.configs import ARCHS, SHAPES

REL = 1e-12


def record(arch, shape, mesh="single", n_devices=256, flops=1.5e15,
           nbytes=3.0e14, coll=None):
    """A dry-run record with the keys the roofline reads."""
    coll = coll or {"all-gather": 4e11, "all-reduce": 2e11,
                    "reduce-scatter": 6e10, "all-to-all": 5e9,
                    "collective-permute": 1e9}
    return {"arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
            "n_devices": n_devices,
            "extrapolated": {"flops_per_device": flops,
                             "bytes_accessed_per_device": nbytes,
                             "collective_bytes": coll,
                             "collective_total_bytes": sum(coll.values()),
                             "fit_points": None}}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_model_arithmetic_matches_reference(arch):
    for shape in SHAPES:
        rec = record(arch, shape)
        assert roofline.model_flops(rec) == ref_roofline.model_flops(rec)
        assert roofline.analytic_memory_bytes(rec) == \
            ref_roofline.analytic_memory_bytes(rec)
        assert roofline.kv_cache_bytes(ARCHS[arch], SHAPES[shape]) == \
            ref_roofline.kv_cache_bytes(REF_ARCHS[arch], REF_SHAPES[shape])


def test_roofline_terms_are_the_references_at_h100_rates():
    rec = record("glm4-9b", "train_4k")
    got = roofline.roofline_row(rec)
    want = ref_roofline.roofline_row(rec)
    ratios = {"t_compute_s": ref_roofline.PEAK_FLOPS / roofline.PEAK_FLOPS,
              "t_memory_s": ref_roofline.HBM_BW / roofline.HBM_BW,
              "t_memory_raw_s": ref_roofline.HBM_BW / roofline.HBM_BW,
              "t_collective_s": ref_roofline.ICI_BW / roofline.NET_BW}
    for key, ratio in ratios.items():
        assert got[key] == pytest.approx(want[key] * ratio, rel=REL), key
    for key in ("model_flops_total", "hlo_flops_total", "useful_flops_ratio",
                "collective_bytes_per_dev", "arch", "shape", "mesh"):
        assert got[key] == want[key], key
    assert set(got) == set(want)
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.NET_BW) == (
        989e12, 3.35e12, 50e9)


def test_rows_skip_records_that_are_not_ok(tmp_path):
    recs = [record("glm4-9b", "train_4k"),
            record("hymba-1.5b", "decode_32k", mesh="multi", n_devices=512),
            {"arch": "glm4-9b", "shape": "long_500k", "mesh": "single",
             "status": "skipped", "reason": "full attention"}]
    for i, rec in enumerate(recs):
        (tmp_path / f"{i}.json").write_text(json.dumps(rec))
    rows = roofline.load_rows(str(tmp_path))
    assert [(r["arch"], r["mesh"]) for r in rows] == [
        ("glm4-9b", "single"), ("hymba-1.5b", "multi")]
    want = ref_roofline.load_rows(str(tmp_path))
    assert [(r["arch"], r["mesh"]) for r in want] == [
        (r["arch"], r["mesh"]) for r in rows]
    table = roofline.format_table(rows, "single")
    assert "glm4-9b" in table and "hymba-1.5b" not in table


def test_report_renders_both_tables(tmp_path):
    rec = record("glm4-9b", "train_4k")
    rec.update({"build_s": 2.5, "step_s": 30.0,
                "flops_per_device": 1.5e15,
                "collectives": {"total_bytes": 6.7e11},
                "argument_size_in_bytes": 2 ** 30,
                "temp_size_in_bytes": 2 ** 31})
    (tmp_path / "glm4-9b_train_4k_single.json").write_text(json.dumps(rec))
    summary = report.dryrun_summary(str(tmp_path))
    assert "| glm4-9b | train_4k | single | 32.50 |" in summary
    assert "| 1.00 | 2.0 |" in summary
    assert "1 cells counted OK; 0 skipped" in summary
    tables = report.markdown_tables(str(tmp_path))
    assert "| glm4-9b | train_4k |" in tables
    assert "0 cells counted OK" in tables


def test_run_roofline_section_needs_no_card_and_writes_only_when_asked(
        tmp_path, monkeypatch, capsys):
    """``bench.run --only roofline`` reads the dry-run records with no
    device given: a row per single-mesh cell, and no BENCH file at the
    repo root; with ``--out-dir`` it writes the section's record."""
    recs = tmp_path / "dryrun"
    recs.mkdir()
    (recs / "a.json").write_text(json.dumps(record("glm4-9b", "train_4k")))
    (recs / "b.json").write_text(json.dumps(
        record("glm4-9b", "train_4k", mesh="multi", n_devices=512)))
    monkeypatch.setattr(roofline, "DRYRUN_DIR", str(recs))
    root_file = run.bench_path(REPO_ROOT, "roofline")
    existed = os.path.exists(root_file)
    res = run.main(["--only", "roofline"])
    out = capsys.readouterr().out
    rows = [line for line in out.splitlines()
            if line.startswith("roofline/")]
    assert rows == [rows[0]] and rows[0].startswith(
        "roofline/glm4-9b/train_4k,")
    assert len(res["roofline"]) == 2
    assert os.path.exists(root_file) == existed
    run.main(["--only", "roofline", "--out-dir", str(tmp_path / "out")])
    doc = json.loads(open(run.bench_path(str(tmp_path / "out"),
                                         "roofline")).read())
    assert doc["section"] == "roofline" and len(doc["rows"]) == 1
