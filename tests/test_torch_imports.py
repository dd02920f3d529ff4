"""The port stands alone: importing every repro_torch module leaves JAX
(and the reference package) out of ``sys.modules``, no port source
imports either, and entry points refuse to run without a card unless
the CPU is asked for."""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
PORT = SRC / "repro_torch"
ROOT = SRC.parent

_WALK = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
"""


def test_every_module_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _WALK], cwd=ROOT,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 30, out.stdout
    assert bad == "[]", out.stdout


@pytest.mark.parametrize("module", ["repro_torch.train.jsc_trainer",
                                    "repro_torch.core.lutmap",
                                    "repro_torch.bench.ablations",
                                    "repro_torch.obs",
                                    "repro_torch.serve",
                                    "repro_torch.bench.loadgen",
                                    "repro_torch.launch.serve",
                                    "repro_torch.check",
                                    "repro_torch.check.sat",
                                    "repro_torch.check.__main__",
                                    "repro_torch.kernels.lut_eval.autotune",
                                    "repro_torch.core.netlist",
                                    "repro_torch.bench.table1_jsc",
                                    "repro_torch.examples.quickstart",
                                    "repro_torch.examples.serve_logic",
                                    "repro_torch.bench.latency",
                                    "repro_torch.bench.run",
                                    "repro_torch.bench.check_regression",
                                    "repro_torch.bench.history"])
def test_training_modules_import_without_jax(module):
    """Each module of the training, serving-at-scale, verification and
    benchmark slices, alone in a fresh interpreter, leaves JAX and the
    reference package out of ``sys.modules``."""
    code = (f"import importlib, sys; importlib.import_module({module!r}); "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_never_import_jax_or_repro(path):
    src = path.read_text()
    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|repro)(\.|\s|$)",
                     re.MULTILINE)
    assert not pat.findall(src), path


def test_entry_points_default_to_cuda():
    """Without a card, an entry point called without ``device=`` raises
    instead of quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from repro_torch.core.logic_infer import LogicNetwork
    from repro_torch.core.quant import ActQuantSpec
    from repro_torch.device import NoCudaDeviceError, resolve_device
    from repro_torch.launch.serve import main
    from repro_torch.serving.engine import LogicEngine
    from repro_torch.configs.jsc import JSC_DEMO
    from repro_torch.train.jsc_trainer import train_jsc
    with pytest.raises(NoCudaDeviceError):
        resolve_device()
    with pytest.raises(NoCudaDeviceError):
        train_jsc(JSC_DEMO, steps=1)
    net = LogicNetwork([], ActQuantSpec("signed", 2), 1.0, 4, 0)
    with pytest.raises(NoCudaDeviceError):
        LogicEngine(net, 5)
    with pytest.raises(NoCudaDeviceError):
        main(["--mode", "logic", "--requests", "1"])
    with pytest.raises(NoCudaDeviceError):   # the launcher's train path
        main(["--mode", "logic", "--train-steps", "2", "--requests", "1"])
    with pytest.raises(NoCudaDeviceError):   # the scheduled path
        main(["--mode", "logic", "--params", "unused.npz", "--sched",
              "--replicas", "2", "--slo-us", "2000,20000"])
    with pytest.raises(NoCudaDeviceError):   # the launcher's --check
        main(["--mode", "logic", "--backend", "bitplane", "--check"])
    from repro_torch.bench.table1_jsc import run as table1
    from repro_torch.check.__main__ import main as check_main
    from repro_torch.examples import quickstart, serve_logic
    from repro_torch.bench import latency, run
    from repro_torch.synth import (execute_packed_cuda,
                                   execute_packed_streamed)
    from repro_torch.synth.simulate import random_words
    mapped = _tiny_mapped()
    words = random_words(mapped.n_pis, 2, seed=0)
    for entry in (lambda: check_main(["--fast"]),
                  lambda: check_main(["--static"]),
                  lambda: table1(steps=1, archs=("jsc-s",)),
                  lambda: quickstart.main([]),
                  lambda: serve_logic.main([]),
                  lambda: latency.run(steps=1, batch=16),
                  lambda: latency.main(["--steps", "1"]),
                  lambda: run.main(["--only", "latency"]),
                  lambda: execute_packed_cuda(mapped, words),
                  lambda: execute_packed_streamed(mapped, words)):
        with pytest.raises(NoCudaDeviceError):
            entry()
    assert resolve_device("cpu") == torch.device("cpu")


def _tiny_mapped():
    from repro_torch import synth
    aig = synth.AIG(3)
    aig.outputs = [aig.and2(synth.lit(1), synth.lit(2) ^ 1)]
    return synth.synthesize(aig)
