"""The port's kernel bench (``repro_torch.bench.kernels_bench``) against
the reference's ``benchmarks/kernels_bench.py``: at reduced shapes on
the CPU it returns every row the reference's ``run()`` returns, and its
command line writes JSON only when asked."""
import ast
import json
import math
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.bench import kernels_bench as kb
from repro_torch.device import NoCudaDeviceError

REF_BENCH = (pathlib.Path(__file__).resolve().parent.parent / "benchmarks"
             / "kernels_bench.py")
SMALL = kb.Sizes(lut_layer=(32, 16, 16, 3, 3), aig=(5, 2, 4),
                 lut_eval=(6, 2, 4), xnor=(9, 100, 7), fanin=(8, 64, 40, 4),
                 flash=(1, 40, 4, 2, 8))


def _reference_keys():
    """Every ``out["..."] = ...`` key of the reference's ``run()``."""
    tree = ast.parse(REF_BENCH.read_text())
    run = next(n for n in tree.body
               if isinstance(n, ast.FunctionDef) and n.name == "run")
    keys = set()
    for node in ast.walk(run):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if (isinstance(tgt, ast.Subscript)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "out"):
                    keys.add(ast.literal_eval(tgt.slice))
    return keys


@pytest.fixture(scope="module")
def small_rows():
    return kb.run(device="cpu", sizes=SMALL)


def test_run_returns_every_reference_row(small_rows):
    ref = _reference_keys()
    assert len(ref) == 18
    assert ref <= set(small_rows), sorted(ref - set(small_rows))
    assert set(small_rows) - ref == {"aig_sim_walk_us"}
    assert all(math.isfinite(v) and v > 0 for v in small_rows.values())


def test_inputs_follow_the_reference_draws():
    """The xnor operands at the reference's shapes are the reference's:
    the same default_rng(0) stream, drawn in the same order."""
    rng = np.random.default_rng(0)
    sizes = kb.Sizes(lut_layer=(4, 3, 2, 2, 2), aig=(3, 1, 2),
                     lut_eval=(3, 1, 2), xnor=(3, 40, 2), fanin=(2, 5, 3, 2),
                     flash=(1, 3, 2, 1, 4))
    inp = kb.make_inputs(torch.device("cpu"), sizes)
    rng.integers(0, 2, (4, 3)), rng.integers(0, 3, (2, 2))
    rng.integers(0, 2, (2, 4))
    rng.random(8) < 0.5
    rng.integers(0, 1 << 31, (3, 2))
    rng.random(8) < 0.5
    rng.integers(0, 1 << 32, (3, 2), dtype=np.uint32)
    x = rng.choice([-1.0, 1.0], (3, 40)).astype(np.float32)
    np.testing.assert_array_equal(inp.xnor.x.numpy(), x)


def test_cli_writes_json_only_with_out(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(kb, "FULL", SMALL)      # the reference's shapes
    assert kb.main(["--device", "cpu"]) == 0
    assert not list(tmp_path.iterdir())
    assert "[kernels] xnor_pallas_us:" in capsys.readouterr().out
    out = tmp_path / "BENCH_kernels_torch.json"
    assert kb.main(["--device", "cpu", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["section"] == "kernels" and doc["meta"]["device"] == "cpu"
    assert doc["meta"]["sizes"]["xnor"] == list(SMALL.xnor)
    names = {r["name"] for r in doc["rows"]}
    assert {f"kernels/{k}" for k in _reference_keys()} <= names


def test_bench_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(NoCudaDeviceError):
        kb.run(sizes=SMALL)
