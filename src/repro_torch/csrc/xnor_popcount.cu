// Bit-packed bipolar (+1/-1) matrix product by XNOR and popcount, for
// sm_90a.
//
// Replaces the TPU kernel
//   src/repro/kernels/xnor_popcount/xnor_popcount.py::xnor_matmul_pallas.
//
// What it computes. x (B, W) and w (N, W) hold bipolar vectors of
// n_features entries packed 32 per word (bit set <=> +1; the pad bits
// of the last word are 0 in both operands). For each pair,
//   out[b, n] = n_features - 2 * sum_c popcount(x[b, c] ^ w[n, c])
// as int32: the number of agreeing entries minus the disagreeing ones.
//
// What bounds it on this card. Per output and word it is one XOR, one
// popcount and one add over two loaded words. At the bench shape
// (256 x 128 words by 256 x 128 words) the operands and the output are
// 512 KB together, and the 25 M integer operations take longer than
// moving those bytes: the integer pipes bound it once the operands sit
// in shared memory.
//
// What the design does about it. A block owns a 32 x 32 output tile
// (32 neurons on threadIdx.x, 8 row groups on threadIdx.y, 4 rows per
// thread). It walks W in steps of 32 words, staging the step's x and w
// words of its tile in shared memory (rows padded to 33 words, so the
// column reads of w do not conflict; every thread of a warp reads the
// same x word, a broadcast). Each thread keeps four int32 sums in
// registers and writes n_features - 2 * sum at the end. Ragged B, N
// and W are handled by bounds checks at the loads (out-of-range words
// load as 0 in both operands, which adds no mismatch) and stores; no
// operand is padded or copied.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;     // rows of x, rows of w and words per step
constexpr int kRowsY = 8;     // threadIdx.y
constexpr int kPerThread = kTile / kRowsY;

__global__ void __launch_bounds__(kTile * kRowsY)
xnor_popcount_kernel(const unsigned* __restrict__ x,
                     const unsigned* __restrict__ w, int* __restrict__ out,
                     int B, int N, int W, int n_features) {
  __shared__ unsigned sx[kTile][kTile + 1];
  __shared__ unsigned sw[kTile][kTile + 1];
  const int n0 = blockIdx.x * kTile;
  const int b0 = blockIdx.y * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  int acc[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) acc[r] = 0;

  for (int c0 = 0; c0 < W; c0 += kTile) {
    const int c = c0 + tx;
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const int i = ty + r * kRowsY;
      const int b = b0 + i, n = n0 + i;
      sx[i][tx] = (b < B && c < W) ? x[size_t(b) * W + c] : 0u;
      sw[i][tx] = (n < N && c < W) ? w[size_t(n) * W + c] : 0u;
    }
    __syncthreads();
#pragma unroll 8
    for (int cc = 0; cc < kTile; ++cc) {
      const unsigned wv = sw[tx][cc];
#pragma unroll
      for (int r = 0; r < kPerThread; ++r)
        acc[r] += __popc(sx[ty + r * kRowsY][cc] ^ wv);
    }
    __syncthreads();
  }

  const int n = n0 + tx;
  if (n >= N) return;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int b = b0 + ty + r * kRowsY;
    if (b < B) out[size_t(b) * N + n] = n_features - 2 * acc[r];
  }
}

}  // namespace

extern "C" {

// x (B, W), w (N, W) packed words as int32; out (B, N) int32. All
// contiguous, on the device of `stream`. Returns a cudaError_t.
int xnor_popcount_launch(const void* x, const void* w, void* out, int B,
                         int N, int W, int n_features, void* stream) {
  const dim3 grid((N + kTile - 1) / kTile, (B + kTile - 1) / kTile);
  const dim3 block(kTile, kRowsY);
  xnor_popcount_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(x), static_cast<const unsigned*>(w),
      static_cast<int*>(out), B, N, W, n_features);
  return cudaGetLastError();
}

}  // extern "C"
