// Bit-parallel AIG simulation, one AND node per step, for sm_90a.
//
// Replaces the TPU kernel
//   src/repro/kernels/aig_sim/aig_sim.py::aig_sim_pallas.
//
// What it computes. The value plane has one row of W packed 32-bit
// words per AIG node: row 0 is the constant 0, rows 1..n_pis echo the
// input words, and AND node i (row 1 + n_pis + i) is
//   (v[l0 >> 1] ^ -(l0 & 1)) & (v[l1 >> 1] ^ -(l1 & 1))
// for its fanin literals l0 = f0[i], l1 = f1[i] (literal = 2 * node +
// complement). Fanins point at earlier rows, so the nodes are a linear
// program walked in order; word columns never interact.
//
// What bounds it on this card. Three integer operations and two row
// reads per node and word, so by bytes the least work is reading the
// inputs and literals and writing the plane once (about a megabyte at
// the bench shape). But the walk is a chain of dependent shared-memory
// loads: its time is n_ands times the load latency, per column.
//
// What the design does about it. One thread per packed word column
// walks every node in order; columns are independent, so the walk
// needs no barrier. The block's slice of the plane stays in shared
// memory when (1 + n_pis + n_ands) * block_w * 4 bytes fits the 227 KB
// budget (row-major, neighbouring threads on neighbouring banks), and
// is copied out with coalesced row stores at the end; otherwise each
// thread walks its column of the output plane in device memory. The
// literals are staged in shared memory in chunks of 2048 (every thread
// reads the same literal: a broadcast). The complement is computed in
// unsigned arithmetic. Any W is taken through the grid (the reference
// asserts W % block_w == 0). Literals are not checked: each must name
// an earlier row.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 2048;                    // literals staged per step
constexpr size_t kSmemBudget = 232448;          // 227 KB per block
constexpr size_t kLitBytes = 2 * kChunk * sizeof(unsigned);

__global__ void aig_sim_kernel(const unsigned* __restrict__ pi,
                               const unsigned* __restrict__ f0,
                               const unsigned* __restrict__ f1,
                               unsigned* __restrict__ out, int n_pis,
                               int n_ands, int W, int use_smem) {
  extern __shared__ unsigned smem[];
  unsigned* s_f0 = smem;
  unsigned* s_f1 = smem + kChunk;
  const int bw = blockDim.x;
  const int col = blockIdx.x * bw + threadIdx.x;
  const bool live = col < W;
  const int n_rows = 1 + n_pis + n_ands;
  // this thread's column of the plane: in shared memory or in `out`
  unsigned* v = use_smem ? smem + 2 * kChunk + threadIdx.x
                         : out + (live ? col : 0);
  const size_t stride = use_smem ? size_t(bw) : size_t(W);

  if (live) {
    v[0] = 0u;
    for (int i = 0; i < n_pis; ++i)
      v[size_t(1 + i) * stride] = pi[size_t(i) * W + col];
  }
  for (int c0 = 0; c0 < n_ands; c0 += kChunk) {
    const int nc = min(kChunk, n_ands - c0);
    __syncthreads();                 // the previous chunk is consumed
    for (int i = threadIdx.x; i < nc; i += bw) {
      s_f0[i] = f0[c0 + i];
      s_f1[i] = f1[c0 + i];
    }
    __syncthreads();
    if (!live) continue;
    unsigned* dst = v + size_t(1 + n_pis + c0) * stride;
    for (int i = 0; i < nc; ++i) {
      const unsigned l0 = s_f0[i], l1 = s_f1[i];
      const unsigned v0 = v[size_t(l0 >> 1) * stride] ^ (0u - (l0 & 1u));
      const unsigned v1 = v[size_t(l1 >> 1) * stride] ^ (0u - (l1 & 1u));
      dst[size_t(i) * stride] = v0 & v1;
    }
  }
  if (use_smem && live)
    for (int r = 0; r < n_rows; ++r)
      out[size_t(r) * W + col] = v[size_t(r) * stride];
}

}  // namespace

extern "C" {

// pi (n_pis, W) words; f0, f1 (n_ands,) literals; out (1 + n_pis +
// n_ands, W). All int32, contiguous, on the device of `stream`.
// Returns a cudaError_t.
int aig_sim_launch(const void* pi, const void* f0, const void* f1, void* out,
                   int n_pis, int n_ands, int W, void* stream) {
  if (W <= 0) return cudaSuccess;
  const size_t n_rows = size_t(1) + n_pis + n_ands;
  const int w_pad = (W + 31) / 32 * 32;
  int bw = 0;                 // the widest word tile whose plane fits
  for (int cand = 128; cand >= 32; cand /= 2)
    if (cand <= w_pad && kLitBytes + n_rows * cand * 4 <= kSmemBudget) {
      bw = cand;
      break;
    }
  const int use_smem = bw != 0;
  if (!use_smem) bw = w_pad < 128 ? w_pad : 128;
  const size_t smem = kLitBytes + (use_smem ? n_rows * bw * 4 : 0);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        aig_sim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int grid = (W + bw - 1) / bw;
  aig_sim_kernel<<<grid, bw, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(pi), static_cast<const unsigned*>(f0),
      static_cast<const unsigned*>(f1), static_cast<unsigned*>(out), n_pis,
      n_ands, W, use_smem);
  return cudaGetLastError();
}

}  // extern "C"
