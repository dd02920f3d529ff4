"""Probe of the tensor-core instructions the xnor_popcount kernel can use
on this card.

    python -m repro_torch.bench.mma_probe

For each of the binary products ``mma.sync.aligned.m16n8k256 ... b1.b1
.s32.and.popc`` and ``.xor.popc``, and the int8 product ``m16n8k32 ...
s8.s8.s32`` beside them, it compiles a small source with nvcc for
sm_90a and reports whether ``ptxas`` took it. For each one it took, it
checks one instruction's result against numpy on random operands loaded
in the fragment layout that ``csrc/xnor_popcount.cu`` assumes, and times
a loop of independent instructions over the whole card (CUDA events) as
operations per second (two per multiply-accumulate, a binary one
counting as one multiply-accumulate). The sources are built under
``build/mma_probe/`` beside the kernel library; nothing is imported or
built when the module is imported.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import numpy as np

from ..kernels import build

PROBE_ROOT = build.BUILD_ROOT.parent / "mma_probe"

# op -> (PTX of the instruction, K of one instruction)
OPS = {
    "b1.and.popc": ("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32."
                    "and.popc", 256),
    "b1.xor.popc": ("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32."
                    "xor.popc", 256),
    "s8": ("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32", 32),
}

# The two instructions share their operand registers: A (16 x K) in four
# 32-bit registers, B (K x 8) in two, C and D (16 x 8 int32) in four.
# Lane l = 4 * g + t holds A rows g and g + 8, words t and 4 + t of each
# row's 256 bits; B column (w row) g, words t and 4 + t; D rows g and
# g + 8, columns 2t and 2t + 1.
SOURCE = r"""
#include <cuda_runtime.h>

__device__ __forceinline__ void mma(int (&d)[4], const unsigned (&a)[4],
                                    const unsigned (&b)[2]) {
  asm volatile("@OP@ {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
               "{%0,%1,%2,%3};\n"
               : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
                 "r"(b[1]));
}

// x (16, 8) and w (8, 8) words; out (16, 8) int32: one instruction.
__global__ void layout_kernel(const unsigned* x, const unsigned* w,
                              int* out) {
  const int g = threadIdx.x >> 2, t = threadIdx.x & 3;
  const unsigned a[4] = {x[g * 8 + t], x[(g + 8) * 8 + t],
                         x[g * 8 + 4 + t], x[(g + 8) * 8 + 4 + t]};
  const unsigned b[2] = {w[g * 8 + t], w[g * 8 + 4 + t]};
  int d[4] = {0, 0, 0, 0};
  mma(d, a, b);
  out[g * 8 + 2 * t] = d[0];
  out[g * 8 + 2 * t + 1] = d[1];
  out[(g + 8) * 8 + 2 * t] = d[2];
  out[(g + 8) * 8 + 2 * t + 1] = d[3];
}

// iters x 4 independent instructions per warp.
__global__ void rate_kernel(int iters, int* sink) {
  const unsigned v = threadIdx.x * 2654435761u + blockIdx.x;
  const unsigned a[4] = {v, v * 3u, ~v, v ^ 0x5a5a5a5au};
  const unsigned b[2] = {v * 7u, ~v * 5u};
  int d0[4] = {0, 0, 0, 0}, d1[4] = {0, 0, 0, 0};
  int d2[4] = {0, 0, 0, 0}, d3[4] = {0, 0, 0, 0};
  for (int i = 0; i < iters; ++i) {
    mma(d0, a, b);
    mma(d1, a, b);
    mma(d2, a, b);
    mma(d3, a, b);
  }
  int s = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) s += d0[j] + d1[j] + d2[j] + d3[j];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int probe_layout(const void* x, const void* w, void* out,
                            void* stream) {
  layout_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(x), static_cast<const unsigned*>(w),
      static_cast<int*>(out));
  return cudaGetLastError();
}

extern "C" int probe_rate(int blocks, int threads, int iters, void* sink,
                          void* stream) {
  rate_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      iters, static_cast<int*>(sink));
  return cudaGetLastError();
}
"""


def _compile(nvcc: str, ops) -> dict:
    """op -> (library path or None, compiler output), all compiled at
    once."""
    procs = {}
    for op in ops:
        out = PROBE_ROOT / op
        out.mkdir(parents=True, exist_ok=True)
        src = out / "probe.cu"
        src.write_text(SOURCE.replace("@OP@", OPS[op][0]))
        procs[op] = (out / "libprobe.so", subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-shared", "-o",
             str(out / "libprobe.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    res = {}
    for op, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        res[op] = (lib if proc.returncode == 0 else None, log)
    return res


def _expected(op: str, x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """(16, 8) int32 result of one instruction on x (16, 8), w (8, 8)
    words: popcount of AND / XOR, or the int8 dot product."""
    if op == "s8":
        xs = x.view(np.int8).astype(np.int64)
        ws = w.view(np.int8).astype(np.int64)
        return (xs @ ws.T).astype(np.int32)
    both = (x[:, None, :] & w[None]) if op == "b1.and.popc" else (
        x[:, None, :] ^ w[None])
    return np.unpackbits(both.view(np.uint8), axis=-1).reshape(
        16, 8, -1).sum(-1).astype(np.int32)


def run(ops=tuple(OPS), iters: int = 4096, seed: int = 0) -> dict:
    """op -> {"accepted", "message", and where accepted "layout_ok",
    "tops"} on CUDA device 0."""
    import torch
    from ..device import resolve_device
    dev = resolve_device(None)
    results = {}
    for op, (lib_path, log) in _compile(build.nvcc_path(), ops).items():
        msg = next((ln.strip() for ln in log.splitlines()
                    if "error" in ln.lower()), "")
        results[op] = {"accepted": lib_path is not None, "message": msg}
        if lib_path is None:
            continue
        lib = ctypes.CDLL(str(lib_path))
        lib.probe_layout.argtypes = [ctypes.c_void_p] * 4
        lib.probe_rate.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        stream = torch.cuda.current_stream(dev).cuda_stream
        rng = np.random.default_rng(seed)
        x = rng.integers(0, 1 << 32, (16, 8), dtype=np.uint32)
        w = rng.integers(0, 1 << 32, (8, 8), dtype=np.uint32)
        xt, wt = (torch.from_numpy(a.view(np.int32)).to(dev) for a in (x, w))
        out = torch.zeros((16, 8), dtype=torch.int32, device=dev)
        err = lib.probe_layout(xt.data_ptr(), wt.data_ptr(), out.data_ptr(),
                               stream)
        torch.cuda.synchronize()
        results[op]["layout_ok"] = bool(
            err == 0 and np.array_equal(out.cpu().numpy(),
                                        _expected(op, x, w)))
        blocks, threads = 4 * torch.cuda.get_device_properties(
            dev).multi_processor_count, 256
        sink = torch.empty(blocks * threads, dtype=torch.int32, device=dev)
        lib.probe_rate(blocks, threads, 16, sink.data_ptr(), stream)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        err = lib.probe_rate(blocks, threads, iters, sink.data_ptr(), stream)
        end.record()
        end.synchronize()
        k = OPS[op][1]
        n_mma = blocks * (threads // 32) * iters * 4
        results[op]["tops"] = (2 * 16 * 8 * k * n_mma
                               / (start.elapsed_time(end) * 1e-3) / 1e12
                               if err == 0 else None)
    return results


def main() -> int:
    print(json.dumps(run(), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
