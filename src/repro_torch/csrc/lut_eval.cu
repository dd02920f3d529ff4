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
// What bounds it on this card. Per slot and word the fold is 2^k - 1
// three-input selects (one LOP3 each) on 2^k + k loaded words, so at
// serving sizes (a few hundred slots, W = 8 words for 256 requests) the
// work is nanoseconds at the memory rate: latency bounds it, the levels
// walked one after the other, each a chain of loads and a barrier.
// Larger W makes it bound by reading the INIT masks (2^k words per
// slot and word).
//
// What the design does about it. One launch evaluates the whole
// netlist: one thread block per tile of word columns walks the levels
// in order with a block barrier between levels. Threads of a level span
// (slot, word) with neighbouring threads on neighbouring words. The
// wire plane stays in shared memory when its rows for the block's
// columns fit beside the plan (the wrapper decides), else the block
// works on its columns of the output plane in device memory.
//  * The fold stays in registers: each select step is its own template
//    instance with a compile-time trip count (fold_from), so no state
//    array is indexed at run time (ptxas: 0 bytes of stack, k = 1..6).
//  * The streamed walk reads its plan from shared memory only. A group
//    of copy threads copies it there with 16-byte cp.async copies ahead
//    of the compute threads: chunk 0 (with level_start and out_base)
//    before the first barrier, later chunks while earlier ones are
//    evaluated, one barrier per chunk. When the plan fits beside the
//    plane it is staged whole (every tile at its own place, a chunk is a
//    level, copied two levels ahead, so a level's copy has two levels'
//    time to land); otherwise it streams in chunks of at most `chunk`
//    tiles of one level through two regions that take turns.
//    INIT rows are padded so a quarter-warp reads several slots' masks
//    as 128-bit loads in one pass, and a compute thread folds one slot
//    over two word columns, so each mask is read once for both.
//  * The compute threads write the constant and input rows, to the
//    plane and the output, while the first chunk is copied (the early
//    stores also warm the output's address translation), and with the
//    plane in shared memory each LUT row is stored to the output as it
//    is computed: no copy-out at the end.
//  * One block walks the netlist at small W: levels need a barrier, and
//    a barrier across blocks (a cluster barrier over distributed shared
//    memory) is a later step.
// The monolithic walk shares fold<K> and reads its level-stacked plan
// from device memory; it is not otherwise redesigned. The TPU kernels'
// SMEM scalar prefetch and "dma" gather staging are not carried over:
// a thread reads its leaf rows straight from shared or device memory.
//
// Every row of the returned plane is written by the kernel (row 0, the
// inputs, every LUT output row; the monolithic plan's dump row is
// zeroed and pad slots write 0 there), so the wrapper may allocate the
// output uninitialised.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;            // the monolithic walk's block
constexpr int kCompute = 256;            // the streamed walk's compute
constexpr int kCopy = 128;               // ... and copy threads
constexpr int kStreamThreads = kCompute + kCopy;

// One Shannon select step of the fold, then the next: st[m] takes
// st[m + half] where leaf J's bit is 1. Trip counts are compile-time at
// every step, so st[] stays in registers (ptxas: no stack frame).
template <int J, int N>
__device__ __forceinline__ void fold_from(unsigned (&st)[N],
                                          const unsigned* sel) {
  constexpr int kHalf = 1 << J;
#pragma unroll
  for (int m = 0; m < kHalf; ++m)
    st[m] = (st[m] & ~sel[J]) | (st[m + kHalf] & sel[J]);
  if constexpr (J > 0) fold_from<J - 1>(st, sel);
}

// Shannon-cofactor fold of one slot over one word, leaf K-1 first (the
// order of lut_eval.py::_tile_fold); st holds the slot's 2^K INIT masks.
template <int K>
__device__ __forceinline__ unsigned fold(unsigned (&st)[1 << K],
                                         const unsigned (&sel)[K]) {
  fold_from<K - 1>(st, sel);
  return st[0];
}

// A slot's 2^K INIT masks as 128-bit loads (64-bit for K = 1); `p` is
// 16-byte aligned (8-byte for K = 1), in shared or device memory.
template <int K>
__device__ __forceinline__ void load_init(unsigned (&st)[1 << K],
                                          const unsigned* p) {
  if constexpr (K == 1) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    st[0] = x.x;
    st[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < (1 << K) / 4; ++i) {
      const uint4 x = reinterpret_cast<const uint4*>(p)[i];
      st[4 * i] = x.x;
      st[4 * i + 1] = x.y;
      st[4 * i + 2] = x.z;
      st[4 * i + 3] = x.w;
    }
  }
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
// plan; pad slots write the dump row n_rows-1. It shares fold<K> with
// the streamed walk and reads its plan from device memory.
template <int K>
__global__ void __launch_bounds__(kThreads)
lut_eval_kernel(const int* __restrict__ pi, const int* __restrict__ leaf,
                const int* __restrict__ tt, const int* __restrict__ ow,
                int* __restrict__ out, int n_pis, int n_rows, int n_levels,
                int lw, int W, int bw, int use_smem) {
  extern __shared__ __align__(16) unsigned smem[];
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
      unsigned sel[K], st[1 << K];
#pragma unroll
      for (int j = 0; j < K; ++j) sel[j] = plane[leaf[s * K + j] * stride + c];
      load_init<K>(st, reinterpret_cast<const unsigned*>(tt) + s * (1 << K));
      plane[ow[s] * stride + c] = fold<K>(st, sel);
    }
    __syncthreads();
  }
  if (use_smem) store_plane(plane, bw, out, n_rows, W, c0, cols);
}

// ---- the streamed walk -----------------------------------------------------

constexpr int kCols = 2;                 // word columns per thread

__host__ __device__ inline int align4(int words) { return (words + 3) & ~3; }

// Words between two slots' INIT rows in shared memory: 2^k plus 4, so
// the rows of neighbouring slots start 16 bytes apart in the banks and
// a quarter-warp reading several slots' masks as 128-bit loads does so
// in one pass.
__host__ __device__ constexpr int tt_stride(int k) {
  return k == 1 ? 4 : (1 << k) + 4;
}

// Shared memory of the streamed walk, in 32-bit words:
//   meta   level_start (n_levels + 1), out_base (n_tiles);
//   tt     regions x chunk tiles x T slots x tt_stride(k) INIT masks;
//   leaf   regions x chunk tiles x T x k leaf rows;
//   plane  n_rows x bw (when the plane lives in shared memory).
// chunk >= n_tiles stages the whole plan in one region; otherwise two
// regions of `chunk` tiles take turns. Each part starts 16-byte aligned.
// The wrapper (kernels/lut_eval/ops.py::streamed_smem_bytes) computes
// the same sizes.
struct StreamLayout {
  int staged, region_tiles, tt, leaf, plane, words;
  __host__ __device__ StreamLayout(int n_levels, int n_tiles, int T, int k,
                                   int chunk, int n_rows, int bw,
                                   int use_smem) {
    staged = chunk >= n_tiles;
    region_tiles = staged ? n_tiles : chunk;
    const int regions = staged ? 1 : 2;
    tt = align4(n_levels + 1 + n_tiles);
    leaf = tt + regions * region_tiles * T * tt_stride(k);
    plane = leaf + align4(regions * region_tiles * T * k);
    words = plane + (use_smem ? n_rows * bw : 0);
  }
};

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until this thread's copies have landed, all but the last group.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Wait until all of this thread's copies have landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// n_rows rows of `row` words, packed at src, to rows `stride` words
// apart at dst, by the copy threads (number `id` of kCopy): 16-byte
// copies where both sides allow, else 4-byte.
__device__ __forceinline__ void copy_rows(unsigned* dst, int stride,
                                          const int* src, int n_rows,
                                          int row, int id) {
  if (row % 4 == 0 && (n_rows == 1 || stride % 4 == 0) &&
      ((reinterpret_cast<uintptr_t>(src) | __cvta_generic_to_shared(dst)) &
       15) == 0) {
    const int segs = row / 4;
    for (int i = id; i < n_rows * segs; i += kCopy) {
      const int r = i / segs, s = 4 * (i - r * segs);
      cp_async16(dst + r * stride + s, src + r * row + s);
    }
  } else {
    for (int i = id; i < n_rows * row; i += kCopy) {
      const int r = i / row, s = i - r * row;
      cp_async4(dst + r * stride + s, src + r * row + s);
    }
  }
}

// Tiles [a, b) of the plan into the tt and leaf areas from slot `slot0`,
// by the copy threads (issued, not awaited).
template <int K>
__device__ __forceinline__ void stage_tiles(unsigned* s_tt, unsigned* s_leaf,
                                            const int* tt_tiles,
                                            const int* leaf_tiles, int a,
                                            int b, int slot0, int T,
                                            int id) {
  copy_rows(s_tt + slot0 * tt_stride(K), tt_stride(K),
            tt_tiles + a * (T << K), (b - a) * T, 1 << K, id);
  copy_rows(s_leaf + slot0 * K, 0, leaf_tiles + a * T * K, 1,
            (b - a) * T * K, id);
}

// One slot over kCols word columns: the first select step (leaf K-1)
// goes straight from the INIT masks in shared memory, four at a time as
// 128-bit loads, and leaves half the state per column; fold_from does
// the rest in registers.
template <int K>
__device__ __forceinline__ void eval_slot(const unsigned* tt,
                                          const unsigned (&sel)[kCols][K],
                                          unsigned (&res)[kCols]) {
  constexpr int kHalf = 1 << (K - 1);
  unsigned st[kCols][kHalf];
  if constexpr (kHalf >= 4) {
#pragma unroll
    for (int m = 0; m < kHalf; m += 4) {
      const uint4 lo = *reinterpret_cast<const uint4*>(tt + m);
      const uint4 hi = *reinterpret_cast<const uint4*>(tt + m + kHalf);
      const unsigned a[4] = {lo.x, lo.y, lo.z, lo.w};
      const unsigned b[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int c = 0; c < kCols; ++c)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          st[c][m + u] = (a[u] & ~sel[c][K - 1]) | (b[u] & sel[c][K - 1]);
    }
  } else {
#pragma unroll
    for (int m = 0; m < kHalf; ++m) {
      const unsigned a = tt[m], b = tt[m + kHalf];
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        st[c][m] = (a & ~sel[c][K - 1]) | (b & sel[c][K - 1]);
    }
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    if constexpr (K >= 2) fold_from<K - 2>(st[c], sel[c]);
    res[c] = st[c][0];
  }
}

// Streamed walk: the slots of level l are tiles level_start[l] ..
// level_start[l+1]-1, T slots each; slot s of tile t writes row
// out_base[t] + s. The plan is read from shared memory only, in chunks:
// a whole level when the plan is staged (every tile at its own place;
// the copy threads run two levels ahead), else at most `chunk` tiles of
// one level in two regions that take turns (one chunk ahead). kCompute
// threads evaluate chunk i while kCopy threads copy; one barrier per
// chunk. A compute thread evaluates one slot over up to kCols
// neighbouring word columns. The compute threads store the constant and
// input rows of the output first; with the plane in shared memory
// (kSmemPlane) each LUT row is also stored to the output as it is
// computed.
template <int K, bool kSmemPlane>
__global__ void __launch_bounds__(kStreamThreads)
lut_eval_streamed_kernel(const int* __restrict__ pi,
                         const int* __restrict__ tt_tiles,
                         const int* __restrict__ leaf_tiles,
                         const int* __restrict__ out_base,
                         const int* __restrict__ level_start,
                         int* __restrict__ out, int n_pis, int n_rows,
                         int n_levels, int n_tiles, int T, int W, int bw,
                         int chunk) {
  extern __shared__ __align__(16) unsigned smem[];
  const StreamLayout lay(n_levels, n_tiles, T, K, chunk, n_rows, bw,
                         kSmemPlane);
  int* s_ls = reinterpret_cast<int*>(smem);            // level_start
  int* s_ob = s_ls + n_levels + 1;                     // out_base
  unsigned* s_tt = smem + lay.tt;
  unsigned* s_leaf = smem + lay.leaf;
  const int c0 = blockIdx.x * bw;
  const int cols = min(bw, W - c0);
  unsigned* gplane = reinterpret_cast<unsigned*>(out) + c0;
  unsigned* plane = kSmemPlane ? smem + lay.plane : gplane;
  const int stride = kSmemPlane ? bw : W;
  const bool copier = threadIdx.x >= kCompute;
  const int id = threadIdx.x - kCompute;               // copy thread id
  const int span = lay.staged ? n_tiles : chunk;       // tiles per chunk

  // the end of the chunk that starts at tile `from` of a level ending at
  // tile `lev_end`
  auto chunk_end = [&](int from, int lev_end) {
    return min(lev_end, from + span);
  };
  const int ls1 = copier && n_levels > 0 ? __ldg(level_start + 1) : 0;
  const int ls2 = copier && n_levels > 1 ? __ldg(level_start + 2) : 0;

  // level_start, out_base and the first chunk(s) first
  if (copier) {
    for (int i = id; i <= n_levels; i += kCopy)
      cp_async4(s_ls + i, level_start + i);
    for (int i = id; i < n_tiles; i += kCopy)
      cp_async4(s_ob + i, out_base + i);
    if (lay.staged) {     // levels 0 and 1, one copy group each
      if (n_levels > 0)
        stage_tiles<K>(s_tt, s_leaf, tt_tiles, leaf_tiles, 0, ls1, 0, T, id);
      cp_async_commit();
      if (n_levels > 1)
        stage_tiles<K>(s_tt, s_leaf, tt_tiles, leaf_tiles, ls1, ls2,
                       ls1 * T, T, id);
      cp_async_commit();
      cp_async_wait_prior();
    } else {
      if (n_levels > 0)
        stage_tiles<K>(s_tt, s_leaf, tt_tiles, leaf_tiles, 0,
                       chunk_end(0, ls1), 0, T, id);
      cp_async_wait_all();
    }
  } else {
    // the constant and input rows, in the plane and the output; the
    // first stores to the output also warm its address translation
    // before the first level stores there
    for (int i = threadIdx.x; i < (n_pis + 1) * cols; i += kCompute) {
      const int r = i / cols, c = i - r * cols;
      const unsigned x =
          r == 0 ? 0u : static_cast<unsigned>(pi[(r - 1) * W + c0 + c]);
      gplane[r * W + c] = x;
      if (kSmemPlane) plane[r * stride + c] = x;
    }
  }
  __syncthreads();

  // a compute thread's column group g and first slot q0 of a chunk:
  // groups of kCols columns rounded up to a power of two (2^gs), so the
  // mapping is shifts; tile and slot of a chunk's slot q likewise when T
  // is a power of two
  const int gs = 32 - __clz(max(0, (cols + kCols - 1) / kCols - 1));
  const int g = threadIdx.x & ((1 << gs) - 1), cg = g * kCols;
  const int q0 = threadIdx.x >> gs, q_step = kCompute >> gs;
  const int ts = (T & (T - 1)) == 0 ? __ffs(T) - 1 : -1;
  int l = 0, a = 0, b = n_levels > 0 ? chunk_end(0, s_ls[1]) : 0;
  for (int r = 0; l < n_levels; r ^= 1) {
    // the next chunk: the rest of this level, else the next level
    const int nl = b == s_ls[l + 1] ? l + 1 : l, na = b;
    if (copier) {
      if (lay.staged) {   // level l+1 is in flight; level l+2 follows
        if (l + 2 < n_levels)
          stage_tiles<K>(s_tt, s_leaf, tt_tiles, leaf_tiles, s_ls[l + 2],
                         s_ls[l + 3], s_ls[l + 2] * T, T, id);
        cp_async_commit();
        cp_async_wait_prior();
      } else if (nl < n_levels) {
        stage_tiles<K>(s_tt, s_leaf, tt_tiles, leaf_tiles, na,
                       chunk_end(na, s_ls[nl + 1]), (r ^ 1) * chunk * T, T,
                       id);
        cp_async_wait_all();
      }
    } else {
      // slot 0 of the chunk's first tile, in the plan area
      const int base = lay.staged ? a * T : r * chunk * T;
      const int n = cg < cols ? (b - a) * T : 0;
      for (int q = q0; q < n; q += q_step) {
        const int pos = base + q;               // slot of the plan area
        unsigned sel[kCols][K], res[kCols];
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const unsigned* row = plane + s_leaf[pos * K + j] * stride + cg;
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            sel[c][j] = cg + c < cols ? row[c] : 0u;
        }
        eval_slot<K>(s_tt + pos * tt_stride(K), sel, res);
        const int t = ts >= 0 ? q >> ts : q / T;
        const int orow = s_ob[a + t] + q - t * T;
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          if (cg + c < cols) {
            plane[orow * stride + cg + c] = res[c];
            if (kSmemPlane) gplane[orow * W + cg + c] = res[c];
          }
      }
    }
    __syncthreads();      // chunk i's rows and chunk i+1's plan in place
    l = nl;
    a = na;
    if (l < n_levels) b = chunk_end(a, s_ls[l + 1]);
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem_bytes, size_t& opted) {
  if (smem_bytes <= 48 * 1024 || smem_bytes <= opted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes));
  if (err == cudaSuccess) opted = smem_bytes;
  return err;
}

template <int K>
cudaError_t launch_mono(const int* pi, const int* leaf, const int* tt,
                        const int* ow, int* out, int n_pis, int n_rows,
                        int n_levels, int lw, int W, int bw, int use_smem,
                        cudaStream_t stream) {
  static size_t opted = 0;
  const size_t smem = use_smem ? size_t(n_rows) * bw * sizeof(unsigned) : 0;
  cudaError_t err = prepare(lut_eval_kernel<K>, smem, opted);
  if (err != cudaSuccess) return err;
  const int grid = (W + bw - 1) / bw;
  lut_eval_kernel<K><<<grid, kThreads, smem, stream>>>(
      pi, leaf, tt, ow, out, n_pis, n_rows, n_levels, lw, W, bw, use_smem);
  return cudaGetLastError();
}

template <int K, bool kSmemPlane>
cudaError_t launch_streamed(const int* pi, const int* tt_tiles,
                            const int* leaf_tiles, const int* out_base,
                            const int* level_start, int* out, int n_pis,
                            int n_rows, int n_levels, int n_tiles, int T,
                            int W, int bw, int chunk, cudaStream_t stream) {
  static size_t opted = 0;
  if (chunk < 1) return cudaErrorInvalidValue;
  const StreamLayout lay(n_levels, n_tiles, T, K, chunk, n_rows, bw,
                         kSmemPlane);
  const size_t smem = size_t(lay.words) * sizeof(unsigned);
  cudaError_t err =
      prepare(lut_eval_streamed_kernel<K, kSmemPlane>, smem, opted);
  if (err != cudaSuccess) return err;
  const int grid = (W + bw - 1) / bw;
  lut_eval_streamed_kernel<K, kSmemPlane>
      <<<grid, kStreamThreads, smem, stream>>>(
          pi, tt_tiles, leaf_tiles, out_base, level_start, out, n_pis,
          n_rows, n_levels, n_tiles, T, W, bw, chunk);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_streamed(const int* pi, const int* tt_tiles,
                            const int* leaf_tiles, const int* out_base,
                            const int* level_start, int* out, int n_pis,
                            int n_rows, int n_levels, int n_tiles, int T,
                            int W, int bw, int use_smem, int chunk,
                            cudaStream_t stream) {
  return use_smem
             ? launch_streamed<K, true>(pi, tt_tiles, leaf_tiles, out_base,
                                        level_start, out, n_pis, n_rows,
                                        n_levels, n_tiles, T, W, bw, chunk,
                                        stream)
             : launch_streamed<K, false>(pi, tt_tiles, leaf_tiles, out_base,
                                         level_start, out, n_pis, n_rows,
                                         n_levels, n_tiles, T, W, bw, chunk,
                                         stream);
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
// level; out (n_rows, W). All int32 as above. `chunk` >= n_tiles stages
// the whole plan in shared memory; a smaller one streams it in chunks
// of at most that many tiles.
int lut_eval_streamed_launch(const void* pi, const void* tt_tiles,
                             const void* leaf_tiles, const void* out_base,
                             const void* level_start, void* out, int n_pis,
                             int n_rows, int n_levels, int n_tiles, int T,
                             int k, int W, int bw, int use_smem, int chunk,
                             void* stream) {
  auto* p = static_cast<const int*>(pi);
  auto* t = static_cast<const int*>(tt_tiles);
  auto* l = static_cast<const int*>(leaf_tiles);
  auto* b = static_cast<const int*>(out_base);
  auto* ls = static_cast<const int*>(level_start);
  auto* y = static_cast<int*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch_streamed<1>(p, t, l, b, ls, y, n_pis, n_rows, n_levels, n_tiles, T, W, bw, use_smem, chunk, s);
    case 2: return launch_streamed<2>(p, t, l, b, ls, y, n_pis, n_rows, n_levels, n_tiles, T, W, bw, use_smem, chunk, s);
    case 3: return launch_streamed<3>(p, t, l, b, ls, y, n_pis, n_rows, n_levels, n_tiles, T, W, bw, use_smem, chunk, s);
    case 4: return launch_streamed<4>(p, t, l, b, ls, y, n_pis, n_rows, n_levels, n_tiles, T, W, bw, use_smem, chunk, s);
    case 5: return launch_streamed<5>(p, t, l, b, ls, y, n_pis, n_rows, n_levels, n_tiles, T, W, bw, use_smem, chunk, s);
    case 6: return launch_streamed<6>(p, t, l, b, ls, y, n_pis, n_rows, n_levels, n_tiles, T, W, bw, use_smem, chunk, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
