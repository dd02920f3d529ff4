"""Build the CUDA sources of ``repro_torch/csrc`` at first use.

Every ``csrc/*.cu`` file has a plain C interface (no PyTorch headers;
``csrc/*.cuh`` holds device helpers they share), so ``nvcc`` compiles
each in seconds. All sources are compiled at once,
one ``nvcc`` process each, then linked into one shared library that is
loaded with ``ctypes``. The library lands in
``<repo>/build/repro_torch_kernels/<hash>/``, keyed by a hash of the
sources and flags, so an edit to a kernel rebuilds and an unchanged
checkout reuses what it built before. Each C entry point returns a
``cudaError_t``; ``check`` turns a non-zero one into an exception.
Every wrapper calls its kernel's entry point through ``launch``, which
checks the error and, while a ``torch.profiler`` session records, runs
the call inside a profiler op of its own: a ``ctypes`` call has no host
op, and without one the profile ties the kernel to none.

Wrappers call ``library()`` only when they are handed a CUDA tensor:
importing this module compiles nothing.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argument types (pointers and the stream as c_void_p)
SIGNATURES = {
    "lut_eval_launch": [_P] * 5 + [_I] * 9 + [_P],
    "lut_eval_streamed_launch": [_P] * 6 + [_I] * 10 + [_P],
    "lut_layer_launch": [_P] * 4 + [_I] * 9 + [_P],
    "aig_sim_launch": [_P] * 5 + [_I] * 4 + [_P],
    "xnor_popcount_launch": [_P] * 3 + [_I] * 4 + [_P],
    "fanin_matmul_launch": [_P] * 5 + [_I] * 11 + [_P],
    "flash_attention_launch": [_P] * 5 + [_I] * 6 + [_F] + [_I] * 3 + [_P],
    "flash_attention_backward_launch": [_P] * 10 + [_I] * 6 + [_F]
    + [_I] * 3 + [_P],
    "flash_attention_backward_workspace": [_P] * 5 + [_I] * 7 + [_P],
    "flash_attention_forward_branch": [_P] * 3 + [_I] * 7,
    "decode_attention_launch": [_P] * 8 + [_I] * 7 + [_F] + [_I] + [_P],
}
# entry points that return something other than a cudaError_t
RESTYPES = {"flash_attention_backward_workspace": ctypes.c_longlong}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


class KernelLaunchError(RuntimeError):
    """A kernel's C entry point returned a CUDA error."""


def sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelBuildError(
        "nvcc not found on PATH or under /usr/local/cuda/bin: the "
        "repro_torch CUDA kernels cannot be built on this machine")


def build() -> Path:
    """Compile every ``csrc/*.cu`` (in parallel) and link them into one
    shared library; returns its path. A no-op when the library for the
    current sources exists. The compiler output, ``-Xptxas=-v``
    register and shared-memory lines included, is kept in
    ``build.log`` beside the library."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        cus = [p for p in sources() if p.suffix == ".cu"]
        objs = [tmp / (p.stem + ".o") for p in cus]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(cus, objs)]
        logs = []
        for src, proc in zip(cus, procs):
            out, _ = proc.communicate()
            logs.append(f"== {src.name} (exit {proc.returncode})\n{out}")
        (out_dir / "build.log").write_text("\n".join(logs))
        failed = [src.name for src, p in zip(cus, procs) if p.returncode]
        if failed:
            raise KernelBuildError(
                f"nvcc failed on {failed}:\n" + "\n".join(logs))
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp / LIB_NAME),
             *map(str, objs)], capture_output=True, text=True)
        if link.returncode:
            raise KernelBuildError(f"nvcc link failed:\n{link.stdout}"
                                   f"{link.stderr}")
        os.replace(tmp / LIB_NAME, lib)      # atomic: readers never see half
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def build_log() -> str:
    """The compiler output of the current sources' build ('' if none)."""
    log = BUILD_ROOT / source_hash() / "build.log"
    return log.read_text() if log.exists() else ""


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in the process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = RESTYPES.get(name, ctypes.c_int)
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, kernel: str) -> None:
    """Raise ``KernelLaunchError`` for a non-zero ``cudaError_t``."""
    if err:
        msg = library().repro_cuda_error_string(err).decode()
        raise KernelLaunchError(f"{kernel}: CUDA error {err} ({msg})")


OP_PREFIX = "repro_torch::"      # a launch's profiler op: OP_PREFIX + kernel


def _profiler_op():
    """torch's operator-scoped profiler op (a private class; ``None``
    where this torch lacks it, and launches then open no op)."""
    import torch
    return getattr(getattr(torch._C, "_profiler", None),
                   "_RecordFunctionFast", None)


def launch(kernel: str, *args) -> None:
    """Call the entry point ``<kernel>_launch`` with ``args`` and check
    its error. While a ``torch.profiler`` session records, the call runs
    inside the profiler op ``repro_torch::<kernel>``, so the kernels it
    launches are linked to that op in the profile."""
    fn = getattr(library(), kernel + "_launch")
    from torch.autograd import profiler
    op = _profiler_op() if profiler._is_profiler_enabled else None
    if op is None:
        err = fn(*args)
    else:
        with op(OP_PREFIX + kernel):
            err = fn(*args)
    check(err, kernel)

