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
// it is bound by bytes, and at serving sizes (B = 256, N = 32..64,
// R = 27) by launch latency.
//
// What the design does about it. One thread per (b, j). A block owns a
// tile of 32 neurons and 64 batch rows: its 32 tables and fanin index
// rows are staged once in shared memory and read by all 64 rows, so
// device memory sees each table once per batch tile. Neighbouring
// threads take neighbouring neurons, so the output stores coalesce.
// When 32 tables do not fit in 48 KB (R > 376) the tables are read
// from device memory instead (use_smem = 0, chosen by the launcher).

#include <cuda_runtime.h>

namespace {

constexpr int kTileN = 32;   // neurons per block (threadIdx.x)
constexpr int kRowsY = 8;    // threadIdx.y
constexpr int kTileB = 64;   // batch rows per block
constexpr size_t kStaticSmem = 48 * 1024;

__global__ void __launch_bounds__(kTileN * kRowsY)
lut_layer_kernel(const int* __restrict__ codes, const int* __restrict__ idx,
                 const int* __restrict__ tables, int* __restrict__ out,
                 int B, int n_in, int N, int K, int R, int L, int use_smem) {
  extern __shared__ int smem[];
  int* s_idx = smem;                       // (kTileN, K)
  int* s_tab = smem + kTileN * K;          // (kTileN, R) when use_smem
  const int j0 = blockIdx.x * kTileN;
  const int b0 = blockIdx.y * kTileB;
  const int nj = min(kTileN, N - j0);
  const int tid = threadIdx.y * kTileN + threadIdx.x;
  const int n_threads = kTileN * kRowsY;

  for (int i = tid; i < nj * K; i += n_threads) s_idx[i] = idx[j0 * K + i];
  if (use_smem)
    for (int i = tid; i < nj * R; i += n_threads)
      s_tab[i] = tables[size_t(j0) * R + i];
  __syncthreads();

  const int jl = threadIdx.x;
  if (jl >= nj) return;
  const int j = j0 + jl;
  const int* tab = use_smem ? s_tab + jl * R : tables + size_t(j) * R;
  const int* my_idx = s_idx + jl * K;
  const int b1 = min(B, b0 + kTileB);
  for (int b = b0 + threadIdx.y; b < b1; b += kRowsY) {
    const int* cb = codes + size_t(b) * n_in;
    unsigned row = 0, w = 1;               // unsigned: wraps like int32
    for (int k = 0; k < K; ++k) {
      row += static_cast<unsigned>(cb[my_idx[k]]) * w;
      w *= static_cast<unsigned>(L);
    }
    out[size_t(b) * N + j] = tab[static_cast<int>(row)];
  }
}

}  // namespace

extern "C" {

// codes (B, n_in); idx (N, K); tables (N, R); out (B, N). All int32,
// contiguous, on the device of `stream`. Returns a cudaError_t.
int lut_layer_launch(const void* codes, const void* idx, const void* tables,
                     void* out, int B, int n_in, int N, int K, int R, int L,
                     void* stream) {
  const size_t idx_bytes = size_t(kTileN) * K * sizeof(int);
  const size_t tab_bytes = size_t(kTileN) * R * sizeof(int);
  const int use_smem = idx_bytes + tab_bytes <= kStaticSmem;
  const size_t smem = idx_bytes + (use_smem ? tab_bytes : 0);
  if (smem > kStaticSmem) return cudaErrorInvalidValue;
  const dim3 grid((N + kTileN - 1) / kTileN, (B + kTileB - 1) / kTileB);
  const dim3 block(kTileN, kRowsY);
  lut_layer_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(codes), static_cast<const int*>(idx),
      static_cast<const int*>(tables), static_cast<int*>(out), B, n_in, N, K,
      R, L, use_smem);
  return cudaGetLastError();
}

}  // extern "C"
