// Fanin-K gather-matmul of an FCP-sparse linear layer, for sm_90a.
//
// Replaces the TPU kernel
//   src/repro/kernels/fanin_matmul/fanin_matmul.py::fanin_matmul_pallas.
//
// What it computes. After fanin-constrained pruning each of N neurons
// reads exactly K of the n_in inputs:
//   y[b, j] = sum_{k=0..K-1} x[b, idx[j, k]] * w[j, k] + bias[j]
// in float32, the terms added in that order (k = 0 first, the bias
// last), each product rounded before it is added (no fused
// multiply-add), as the reference kernel's loop and the plain version
// compute it.
//
// What bounds it on this card. K multiply-adds per output against K
// gathered x values: far below the float32 rate, so it is bound by
// bytes, mostly x (4 MB at the bench shape, 256 x 4096), which the
// gathers read in 32-byte sectors from L2.
//
// What the design does about it. A block owns 32 neurons
// (threadIdx.x) and 64 batch rows (8 row groups on threadIdx.y). Its
// neurons' fanin indices and weights are staged once in shared memory
// (rows padded to an odd stride so the 32 neurons' reads hit distinct
// banks) and reused by all 64 rows; the bias stays in a register.
// x rows are read from device memory: a 64-row tile of 4096 inputs is
// 1 MB, which does not fit. Neighbouring threads take neighbouring
// neurons, so the output stores coalesce. The staged indices and
// weights must fit 48 KB: K <= 191 (the wrapper refuses more).

#include <cuda_runtime.h>

namespace {

constexpr int kTileN = 32;   // neurons per block (threadIdx.x)
constexpr int kRowsY = 8;    // threadIdx.y
constexpr int kTileB = 64;   // batch rows per block
constexpr size_t kStaticSmem = 48 * 1024;

__global__ void __launch_bounds__(kTileN * kRowsY)
fanin_matmul_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                    const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int B, int n_in, int N, int K, int Kp) {
  extern __shared__ int smem[];
  int* s_idx = smem;                                        // (kTileN, Kp)
  float* s_w = reinterpret_cast<float*>(smem + kTileN * Kp);  // (kTileN, Kp)
  const int j0 = blockIdx.x * kTileN;
  const int b0 = blockIdx.y * kTileB;
  const int nj = min(kTileN, N - j0);
  const int tid = threadIdx.y * kTileN + threadIdx.x;

  for (int i = tid; i < nj * K; i += kTileN * kRowsY) {
    const int r = i / K, c = i - r * K;
    s_idx[r * Kp + c] = idx[size_t(j0) * K + i];
    s_w[r * Kp + c] = w[size_t(j0) * K + i];
  }
  __syncthreads();

  const int jl = threadIdx.x;
  if (jl >= nj) return;
  const int j = j0 + jl;
  const int* my_idx = s_idx + jl * Kp;
  const float* my_w = s_w + jl * Kp;
  const float bj = bias[j];
  const int b1 = min(B, b0 + kTileB);
  for (int b = b0 + threadIdx.y; b < b1; b += kRowsY) {
    const float* xb = x + size_t(b) * n_in;
    float acc = 0.0f;
#pragma unroll 8
    for (int k = 0; k < K; ++k)          // unrolled: the gathers overlap
      acc = __fadd_rn(acc, __fmul_rn(__ldg(xb + my_idx[k]), my_w[k]));
    out[size_t(b) * N + j] = __fadd_rn(acc, bj);
  }
}

}  // namespace

extern "C" {

// x (B, n_in) f32; idx (N, K) int32 in [0, n_in); w (N, K) f32;
// bias (N,) f32; out (B, N) f32. All contiguous, on the device of
// `stream`; K <= 191. Returns a cudaError_t.
int fanin_matmul_launch(const void* x, const void* idx, const void* w,
                        const void* bias, void* out, int B, int n_in, int N,
                        int K, void* stream) {
  const int Kp = K | 1;                         // odd stride: no conflicts
  const size_t smem = size_t(kTileN) * Kp * (sizeof(int) + sizeof(float));
  if (smem > kStaticSmem) return cudaErrorInvalidValue;
  const dim3 grid((N + kTileN - 1) / kTileN, (B + kTileB - 1) / kTileB);
  const dim3 block(kTileN, kRowsY);
  fanin_matmul_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(idx),
      static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<float*>(out), B, n_in, N, K, Kp);
  return cudaGetLastError();
}

}  // extern "C"
