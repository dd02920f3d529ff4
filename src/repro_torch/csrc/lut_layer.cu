// Truth-table layer for sm_90a.
//
// Replaces the TPU kernel
//   src/repro/kernels/lut_layer/lut_layer.py::lut_layer_pallas.
//
// What it computes. For a batch of input codes (B, N_in) and N neurons
// of fanin K, each with a table of R = L^K output codes:
//   row[b, j] = sum_k codes[b, idx[j, k]] * L^k      (int32, wrapping)
//   out[b, j] = tables[j, row[b, j]]
//
// What bounds it on this card. Each output is K gathered codes, K
// multiply-adds and one table read: far below the operation rate, so
// it is bound by bytes, and at serving sizes (B = 256, N = 5..64,
// R = 27) by latency: the launch and one round trip to device memory.
//
// What the design does about it. A block owns a tile of n_tile neurons
// and b_tile batch rows (the wrapper sizes both from the 227 KB
// budget, kernels/lut_layer/ops.py::plan_layer) and computes its
// n_tile x b_tile outputs with one thread each. Its threads first copy
// the tile's fanin rows, tables and rows of codes into shared memory
// together, with 16-byte cp.async copies where aligned, then wait once
// at one barrier: one device-memory round trip per block, every load of
// a thread in flight before any is used. After the barrier every gather
// reads shared memory. Neighbouring threads take neighbouring neurons,
// so the output stores coalesce. Where not even one neuron's table and
// one row of codes fit the budget, the block reads codes, fanin rows
// and tables from device memory instead (kSmem = false).
//  * K is a template parameter for K = 1..6, so a thread's K code
//    loads are issued together; K = 0 is the instance for any other
//    fanin, with a loop of run-time length.

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

using repro::allow_smem;
using repro::copy_words;
using repro::cp_async_wait_all;

constexpr int kThreads = 256;

__host__ __device__ inline int align4(int words) { return (words + 3) & ~3; }

// Shared memory of the kSmem branch, in 32-bit words: the fanin rows
// (n_tile x k), the tables (n_tile x R), the codes (b_tile x n_in),
// each part 16-byte aligned (ops.py::layer_smem_bytes).
__host__ __device__ inline int smem_words(int n_tile, int b_tile, int n_in,
                                          int k, int R) {
  return align4(n_tile * k) + align4(n_tile * R) + b_tile * n_in;
}

// row[j] of one output: sum_k codes[idx[k]] * L^k in wrapping unsigned
// arithmetic, from a row of codes `cb` and a fanin row `ji`.
template <int K>
__device__ __forceinline__ unsigned table_row(const int* cb, const int* ji,
                                              int k, unsigned L) {
  unsigned row = 0, w = 1;
  if constexpr (K > 0) {
    unsigned c[K];
#pragma unroll
    for (int i = 0; i < K; ++i) c[i] = static_cast<unsigned>(cb[ji[i]]);
#pragma unroll
    for (int i = 0; i < K; ++i) {
      row += c[i] * w;
      w *= L;
    }
  } else {
    for (int i = 0; i < k; ++i) {
      row += static_cast<unsigned>(cb[ji[i]]) * w;
      w *= L;
    }
  }
  return row;
}

// Block blockIdx.x owns neuron tile blockIdx.x % n_ntiles and batch tile
// blockIdx.x / n_ntiles.
template <int K, bool kSmem>
__global__ void __launch_bounds__(kThreads)
lut_layer_kernel(const int* __restrict__ codes, const int* __restrict__ idx,
                 const int* __restrict__ tables, int* __restrict__ out,
                 int B, int n_in, int N, int k_any, int R, int L, int n_tile,
                 int b_tile, int n_ntiles) {
  extern __shared__ __align__(16) int smem[];
  const int k = K > 0 ? K : k_any;
  const int j0 = (blockIdx.x % n_ntiles) * n_tile;
  const int b0 = (blockIdx.x / n_ntiles) * b_tile;
  const int nj = min(n_tile, N - j0), nb = min(b_tile, B - b0);
  const int* t_idx = idx + j0 * k;
  const int* t_tab = tables + j0 * R;
  const int* t_codes = codes + b0 * n_in;
  if constexpr (kSmem) {
    int* s_idx = smem;
    int* s_tab = s_idx + align4(n_tile * k);
    int* s_codes = s_tab + align4(n_tile * R);
    copy_words(s_idx, t_idx, nj * k, threadIdx.x, kThreads);
    copy_words(s_tab, t_tab, nj * R, threadIdx.x, kThreads);
    copy_words(s_codes, t_codes, nb * n_in, threadIdx.x, kThreads);
    cp_async_wait_all();
    __syncthreads();
    t_idx = s_idx;
    t_tab = s_tab;
    t_codes = s_codes;
  }
  for (int o = threadIdx.x; o < nb * nj; o += kThreads) {
    const int bl = o / nj, jl = o - bl * nj;
    const unsigned row = table_row<K>(t_codes + bl * n_in, t_idx + jl * k,
                                      k, static_cast<unsigned>(L));
    out[(b0 + bl) * N + j0 + jl] = t_tab[jl * R + static_cast<int>(row)];
  }
}

template <int K, bool kSmem>
cudaError_t launch(const int* codes, const int* idx, const int* tables,
                   int* out, int B, int n_in, int N, int k, int R, int L,
                   int n_tile, int b_tile, cudaStream_t stream) {
  static size_t opted = 0;
  const size_t smem =
      kSmem ? size_t(smem_words(n_tile, b_tile, n_in, k, R)) * sizeof(int)
            : 0;
  const cudaError_t err = allow_smem(lut_layer_kernel<K, kSmem>, smem, opted);
  if (err != cudaSuccess) return err;
  const int n_ntiles = (N + n_tile - 1) / n_tile;
  const long long grid =
      static_cast<long long>(n_ntiles) * ((B + b_tile - 1) / b_tile);
  if (grid > 0x7fffffff) return cudaErrorInvalidConfiguration;
  lut_layer_kernel<K, kSmem>
      <<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
          codes, idx, tables, out, B, n_in, N, k, R, L, n_tile, b_tile,
          n_ntiles);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch(const int* codes, const int* idx, const int* tables,
                   int* out, int B, int n_in, int N, int k, int R, int L,
                   int n_tile, int b_tile, int use_smem,
                   cudaStream_t stream) {
  return use_smem ? launch<K, true>(codes, idx, tables, out, B, n_in, N, k,
                                    R, L, n_tile, b_tile, stream)
                  : launch<K, false>(codes, idx, tables, out, B, n_in, N, k,
                                     R, L, n_tile, b_tile, stream);
}

}  // namespace

extern "C" {

// codes (B, n_in); idx (N, K); tables (N, R); out (B, N). All int32,
// contiguous, on the device of `stream`. Blocks of n_tile neurons and
// b_tile batch rows, staged in shared memory when use_smem. Returns a
// cudaError_t.
int lut_layer_launch(const void* codes, const void* idx, const void* tables,
                     void* out, int B, int n_in, int N, int K, int R, int L,
                     int n_tile, int b_tile, int use_smem, void* stream) {
  auto* c = static_cast<const int*>(codes);
  auto* i = static_cast<const int*>(idx);
  auto* t = static_cast<const int*>(tables);
  auto* y = static_cast<int*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (n_tile < 1 || b_tile < 1) return cudaErrorInvalidValue;
  switch (K) {
    case 1: return launch<1>(c, i, t, y, B, n_in, N, K, R, L, n_tile, b_tile, use_smem, s);
    case 2: return launch<2>(c, i, t, y, B, n_in, N, K, R, L, n_tile, b_tile, use_smem, s);
    case 3: return launch<3>(c, i, t, y, B, n_in, N, K, R, L, n_tile, b_tile, use_smem, s);
    case 4: return launch<4>(c, i, t, y, B, n_in, N, K, R, L, n_tile, b_tile, use_smem, s);
    case 5: return launch<5>(c, i, t, y, B, n_in, N, K, R, L, n_tile, b_tile, use_smem, s);
    case 6: return launch<6>(c, i, t, y, B, n_in, N, K, R, L, n_tile, b_tile, use_smem, s);
    default: return launch<0>(c, i, t, y, B, n_in, N, K, R, L, n_tile, b_tile, use_smem, s);
  }
}

}  // extern "C"
