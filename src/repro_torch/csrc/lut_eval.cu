// Mapped k-LUT netlist evaluation on packed bitplanes, for sm_90a.
//
// Replaces two TPU kernels of the reference package:
//   * src/repro/kernels/lut_eval/lut_eval.py::lut_eval_pallas
//     (monolithic walk over the level-stacked DevicePlan);
//   * src/repro/kernels/lut_eval/lut_eval.py::lut_eval_streamed_pallas
//     (tiled walk over the level-major TilePlan).
//
// What it computes. The wire plane holds one row of W packed 32-bit
// words per wire: row 0 is the constant 0, rows 1..n_pis the primary
// inputs, the other rows LUT outputs. A LUT slot gathers its k leaf
// rows and folds its 2^k INIT masks over them in k select steps,
// leaf k-1 first:  state[m] = (state[m] & ~sel_j) | (state[m+half] & sel_j)
// (the order of lut_eval.py::_tile_fold). Slots of one level only read
// rows of earlier levels, and word columns never interact.
//
// What bounds it on this card. Per slot and word the fold is 3*(2^k-1)
// integer operations on 2^k+k loaded words, so at serving sizes (a few
// hundred slots, W = 8 words for 256 requests) the work is tens of
// nanoseconds at the memory rate: launch latency bounds it. Larger W
// makes it bound by reading the INIT masks (2^k words per slot).
//
// What the design does about it. One launch evaluates the whole
// netlist: one thread block per tile of word columns walks the levels
// in order with a block barrier between levels, so there is one launch
// per batch instead of one per level. Threads of a level span
// (slot, word) with neighbouring threads on neighbouring words. The
// wire plane stays in shared memory when n_rows * block_w * 4 bytes
// fits the block's budget (the wrapper decides, use_smem), else the
// block works on its columns of the output plane in device memory. The
// TPU kernels' SMEM scalar prefetch, double-buffered plan DMA and the
// "dma" gather staging are not carried over: a thread reads its leaf
// rows straight from shared or device memory.
//
// Every row of the returned plane is written by the kernel (row 0, the
// inputs, every LUT output row; the monolithic plan's dump row is
// zeroed and pad slots write 0 there), so the wrapper may allocate the
// output uninitialised.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Shannon-cofactor fold of one slot over one word, leaf K-1 first.
template <int K>
__device__ __forceinline__ unsigned fold(const int* __restrict__ tt,
                                         const unsigned (&sel)[K]) {
  unsigned st[1 << K];
#pragma unroll
  for (int m = 0; m < (1 << K); ++m) st[m] = static_cast<unsigned>(tt[m]);
#pragma unroll
  for (int j = K - 1; j >= 0; --j) {
    const int half = 1 << j;
#pragma unroll
    for (int m = 0; m < half; ++m)
      st[m] = (st[m] & ~sel[j]) | (st[m + half] & sel[j]);
  }
  return st[0];
}

// Rows 0 (constant 0) and 1..n_pis (inputs) of this block's columns.
__device__ __forceinline__ void load_inputs(const int* __restrict__ pi,
                                            unsigned* plane, int stride,
                                            int n_pis, int W, int c0,
                                            int cols) {
  for (int i = threadIdx.x; i < (n_pis + 1) * cols; i += blockDim.x) {
    const int r = i / cols, c = i % cols;
    plane[r * stride + c] =
        r == 0 ? 0u : static_cast<unsigned>(pi[(r - 1) * W + c0 + c]);
  }
}

// Copy the shared-memory plane out to this block's columns.
__device__ __forceinline__ void store_plane(const unsigned* plane, int bw,
                                            int* __restrict__ out,
                                            int n_rows, int W, int c0,
                                            int cols) {
  for (int i = threadIdx.x; i < n_rows * cols; i += blockDim.x) {
    const int r = i / cols, c = i % cols;
    out[r * W + c0 + c] = static_cast<int>(plane[r * bw + c]);
  }
}

// Monolithic walk: slot s of level l is slot l*lw + s of the stacked
// plan; pad slots write the dump row n_rows-1.
template <int K>
__global__ void __launch_bounds__(kThreads)
lut_eval_kernel(const int* __restrict__ pi, const int* __restrict__ leaf,
                const int* __restrict__ tt, const int* __restrict__ ow,
                int* __restrict__ out, int n_pis, int n_rows, int n_levels,
                int lw, int W, int bw, int use_smem) {
  extern __shared__ unsigned smem[];
  const int c0 = blockIdx.x * bw;
  const int cols = min(bw, W - c0);
  unsigned* plane = use_smem ? smem : reinterpret_cast<unsigned*>(out) + c0;
  const int stride = use_smem ? bw : W;

  load_inputs(pi, plane, stride, n_pis, W, c0, cols);
  for (int c = threadIdx.x; c < cols; c += blockDim.x)
    plane[(n_rows - 1) * stride + c] = 0u;            // dump row
  __syncthreads();

  for (int l = 0; l < n_levels; ++l) {
    for (int i = threadIdx.x; i < lw * cols; i += blockDim.x) {
      const int s = l * lw + i / cols, c = i % cols;
      unsigned sel[K];
#pragma unroll
      for (int j = 0; j < K; ++j) sel[j] = plane[leaf[s * K + j] * stride + c];
      plane[ow[s] * stride + c] = fold<K>(tt + s * (1 << K), sel);
    }
    __syncthreads();
  }
  if (use_smem) store_plane(plane, bw, out, n_rows, W, c0, cols);
}

// Streamed walk: the slots of level l are tiles level_start[l] ..
// level_start[l+1]-1, T slots each; slot s of tile t writes row
// out_base[t] + s.
template <int K>
__global__ void __launch_bounds__(kThreads)
lut_eval_streamed_kernel(const int* __restrict__ pi,
                         const int* __restrict__ tt_tiles,
                         const int* __restrict__ leaf_tiles,
                         const int* __restrict__ out_base,
                         const int* __restrict__ level_start,
                         int* __restrict__ out, int n_pis, int n_rows,
                         int n_levels, int T, int W, int bw, int use_smem) {
  extern __shared__ unsigned smem[];
  const int c0 = blockIdx.x * bw;
  const int cols = min(bw, W - c0);
  unsigned* plane = use_smem ? smem : reinterpret_cast<unsigned*>(out) + c0;
  const int stride = use_smem ? bw : W;

  load_inputs(pi, plane, stride, n_pis, W, c0, cols);
  __syncthreads();

  for (int l = 0; l < n_levels; ++l) {
    const int first = level_start[l] * T;
    const int n_slots = level_start[l + 1] * T - first;
    for (int i = threadIdx.x; i < n_slots * cols; i += blockDim.x) {
      const int g = first + i / cols, c = i % cols;
      unsigned sel[K];
#pragma unroll
      for (int j = 0; j < K; ++j)
        sel[j] = plane[leaf_tiles[g * K + j] * stride + c];
      const int row = out_base[g / T] + g % T;
      plane[row * stride + c] = fold<K>(tt_tiles + g * (1 << K), sel);
    }
    __syncthreads();
  }
  if (use_smem) store_plane(plane, bw, out, n_rows, W, c0, cols);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem_bytes) {
  if (smem_bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes));
}

template <int K>
cudaError_t launch_mono(const int* pi, const int* leaf, const int* tt,
                        const int* ow, int* out, int n_pis, int n_rows,
                        int n_levels, int lw, int W, int bw, int use_smem,
                        cudaStream_t stream) {
  const size_t smem = use_smem ? size_t(n_rows) * bw * sizeof(unsigned) : 0;
  cudaError_t err = prepare(lut_eval_kernel<K>, smem);
  if (err != cudaSuccess) return err;
  const int grid = (W + bw - 1) / bw;
  lut_eval_kernel<K><<<grid, kThreads, smem, stream>>>(
      pi, leaf, tt, ow, out, n_pis, n_rows, n_levels, lw, W, bw, use_smem);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_streamed(const int* pi, const int* tt_tiles,
                            const int* leaf_tiles, const int* out_base,
                            const int* level_start, int* out, int n_pis,
                            int n_rows, int n_levels, int T, int W, int bw,
                            int use_smem, cudaStream_t stream) {
  const size_t smem = use_smem ? size_t(n_rows) * bw * sizeof(unsigned) : 0;
  cudaError_t err = prepare(lut_eval_streamed_kernel<K>, smem);
  if (err != cudaSuccess) return err;
  const int grid = (W + bw - 1) / bw;
  lut_eval_streamed_kernel<K><<<grid, kThreads, smem, stream>>>(
      pi, tt_tiles, leaf_tiles, out_base, level_start, out, n_pis, n_rows,
      n_levels, T, W, bw, use_smem);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// pi (n_pis, W); leaf (n_levels*lw, k); tt (n_levels*lw, 2^k);
// ow (n_levels*lw,); out (n_rows, W) with n_rows = n_wires + 1.
// All int32, contiguous, on the device of `stream`. Returns a
// cudaError_t (0 on success).
int lut_eval_launch(const void* pi, const void* leaf, const void* tt,
                    const void* ow, void* out, int n_pis, int n_rows,
                    int n_levels, int lw, int k, int W, int bw, int use_smem,
                    void* stream) {
  auto* p = static_cast<const int*>(pi);
  auto* l = static_cast<const int*>(leaf);
  auto* t = static_cast<const int*>(tt);
  auto* o = static_cast<const int*>(ow);
  auto* y = static_cast<int*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch_mono<1>(p, l, t, o, y, n_pis, n_rows, n_levels, lw, W, bw, use_smem, s);
    case 2: return launch_mono<2>(p, l, t, o, y, n_pis, n_rows, n_levels, lw, W, bw, use_smem, s);
    case 3: return launch_mono<3>(p, l, t, o, y, n_pis, n_rows, n_levels, lw, W, bw, use_smem, s);
    case 4: return launch_mono<4>(p, l, t, o, y, n_pis, n_rows, n_levels, lw, W, bw, use_smem, s);
    case 5: return launch_mono<5>(p, l, t, o, y, n_pis, n_rows, n_levels, lw, W, bw, use_smem, s);
    case 6: return launch_mono<6>(p, l, t, o, y, n_pis, n_rows, n_levels, lw, W, bw, use_smem, s);
    default: return cudaErrorInvalidValue;
  }
}

// pi (n_pis, W); tt_tiles (n_tiles, T, 2^k); leaf_tiles (n_tiles, T, k);
// out_base (n_tiles,); level_start (n_levels+1,) first tile of each
// level; out (n_rows, W). All int32 as above.
int lut_eval_streamed_launch(const void* pi, const void* tt_tiles,
                             const void* leaf_tiles, const void* out_base,
                             const void* level_start, void* out, int n_pis,
                             int n_rows, int n_levels, int T, int k, int W,
                             int bw, int use_smem, void* stream) {
  auto* p = static_cast<const int*>(pi);
  auto* t = static_cast<const int*>(tt_tiles);
  auto* l = static_cast<const int*>(leaf_tiles);
  auto* b = static_cast<const int*>(out_base);
  auto* ls = static_cast<const int*>(level_start);
  auto* y = static_cast<int*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch_streamed<1>(p, t, l, b, ls, y, n_pis, n_rows, n_levels, T, W, bw, use_smem, s);
    case 2: return launch_streamed<2>(p, t, l, b, ls, y, n_pis, n_rows, n_levels, T, W, bw, use_smem, s);
    case 3: return launch_streamed<3>(p, t, l, b, ls, y, n_pis, n_rows, n_levels, T, W, bw, use_smem, s);
    case 4: return launch_streamed<4>(p, t, l, b, ls, y, n_pis, n_rows, n_levels, T, W, bw, use_smem, s);
    case 5: return launch_streamed<5>(p, t, l, b, ls, y, n_pis, n_rows, n_levels, T, W, bw, use_smem, s);
    case 6: return launch_streamed<6>(p, t, l, b, ls, y, n_pis, n_rows, n_levels, T, W, bw, use_smem, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
