"""No run imports JAX or the JAX package, and the reference imports
nothing of the port. Checked in fresh processes: the test workers may
already hold JAX for the JAX package's own tests. Top-level names
(before the first dot) are compared whole: ``repro_torch`` begins with
``repro``."""
import ast
import json
import subprocess
import sys

from perfbench import harness

ROOT = harness.ROOT

RUN_BOTH_KINDS = """
import json, sys
sys.path[:0] = [{root!r}, {root!r} + "/src"]
import torch
torch.set_num_threads(1)
import perfbench.run
from perfbench import harness
from perfbench.tests import smoke
spec = harness.benchmark_spec()
for m in spec["per_layer"]:
    harness.metric_reader(m["name"])
r = smoke.make_run("glm4_9b.train_4k", smoke.GLM4_SMOKE, smoke.train_mix(),
                   seconds=0.2)
harness.kind_module("train").run(r)
r = smoke.make_run("nemotron_4_340b.decode_heavy", smoke.NEMOTRON_SMOKE,
                   smoke.serve_mix(), seconds=0.3)
harness.kind_module("closed_serve").run(r)
print(json.dumps(sorted(sys.modules)))
"""

REFERENCE_ONLY = """
import json, sys
sys.path[:0] = [{root!r}]
import perfbench.reference.dense_decoder, perfbench.checks, perfbench.weights
print(json.dumps(sorted(sys.modules)))
"""


def loaded(code: str):
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-4000:]
    return {m.split(".")[0] for m in json.loads(out.stdout.splitlines()[-1])}


def test_a_run_loads_no_jax_nor_the_jax_package():
    tops = loaded(RUN_BOTH_KINDS)
    assert "repro_torch" in tops
    assert not tops & set(harness.FORBIDDEN_TOP), tops & set(
        harness.FORBIDDEN_TOP)


def test_the_reference_loads_nothing_of_the_port():
    tops = loaded(REFERENCE_ONLY)
    assert not tops & {"repro_torch", *harness.FORBIDDEN_TOP}


def test_the_reference_names_nothing_of_the_port():
    for path in (harness.HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in {"repro_torch", "jax",
                                               "repro"}, (path, n)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert "repro_torch_fake" not in harness.forbidden_modules()
