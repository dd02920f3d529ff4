// Asynchronous global -> shared copies (cp.async, sm_80 and later) and
// the dynamic shared-memory opt-in, shared by the lut_eval, lut_layer,
// fanin_matmul (the opt-in) and mma.sync (mma_sync.cuh: the zero-fill
// copy and the counted wait) kernels.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace repro {

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

// N (4, 8 or 16) bytes from src to dst; with valid false nothing is read
// and dst is filled with zeros.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const int n = valid ? N : 0;                  // 0: zero-fill
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(N), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until this thread's copies have landed, all but the last N groups.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Wait until this thread's copies have landed, all but the last group.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Wait until all of this thread's copies have landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// n contiguous words from src to dst, by threads id, id + step, ...:
// 16-byte copies where both ends are 16-byte aligned (the last n % 4
// words as 4-byte copies), else 4-byte copies throughout.
__device__ __forceinline__ void copy_words(void* dst, const void* src, int n,
                                           int id, int step) {
  auto* d = static_cast<unsigned*>(dst);
  auto* s = static_cast<const unsigned*>(src);
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(s) | __cvta_generic_to_shared(d)) & 15) ==
      0) {
    done = n & ~3;
    for (int i = 4 * id; i < done; i += 4 * step) cp_async16(d + i, s + i);
  }
  for (int i = done + id; i < n; i += step) cp_async4(d + i, s + i);
}

// Let `kernel` take `smem_bytes` of dynamic shared memory (above 48 KB
// only after an opt-in); `opted` remembers the largest opt-in so far.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem_bytes, size_t& opted) {
  if (smem_bytes <= 48 * 1024 || smem_bytes <= opted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes));
  if (err == cudaSuccess) opted = smem_bytes;
  return err;
}

}  // namespace repro
