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
// What the design does about it. Both walks are one kernel body
// (`walk`) over two plan layouts that differ only in where a level's
// slots start and which row a slot writes (TiledSlots, StackedSlots).
// One launch evaluates the whole netlist: one thread block per tile of
// word columns walks the levels in order with a block barrier between
// levels. The wire plane stays in shared memory when its rows for the
// block's columns fit beside the plan (the wrapper decides), else the
// block works on its columns of the output plane in device memory.
//  * The fold stays in registers: each select step is its own template
//    instance with a compile-time trip count (fold_from), so no state
//    array is indexed at run time (ptxas: 0 bytes of stack, k = 1..6).
//  * The plan is read from shared memory only. A group of copy threads
//    copies it there with 16-byte cp.async copies ahead of the compute
//    threads: chunk 0 (with the layout's meta) before the first
//    barrier, later chunks while earlier ones are evaluated, one barrier
//    per chunk. When the plan fits beside the plane it is staged whole
//    (every slot at its own place, a chunk is a level, copied two levels
//    ahead, so a level's copy has two levels' time to land); otherwise
//    it streams in chunks of at most `chunk` slots of one level through
//    two regions that take turns. INIT rows are padded so a
//    quarter-warp reads several slots' masks as 128-bit loads in one
//    pass, and a compute thread folds one slot over two word columns,
//    so each mask is read once for both.
//  * The compute threads write the constant and input rows (and the
//    stacked plan's dump row), to the plane and the output, while the
//    first chunk is copied (the early stores also warm the output's
//    address translation), and with the plane in shared memory each LUT
//    row is stored to the output as it is computed: no copy-out.
//  * A pad slot of the stacked plan (it writes the dump row) is skipped:
//    the dump row was written 0 at the start, and no slot reads it. A
//    staged stacked plan's output rows are copied first, so from level 2
//    on the copy threads skip the pad slots' masks too.
//  * One block walks the netlist at small W: levels need a barrier, and
//    a barrier across blocks (a cluster barrier over distributed shared
//    memory) is a later step.
// The TPU kernels' SMEM scalar prefetch and "dma" gather staging are
// not carried over: a thread reads its leaf rows straight from the
// plane in shared or device memory.
//
// Every row of the returned plane is written by the kernel (row 0, the
// inputs, every LUT output row, the stacked plan's dump row), so the
// wrapper may allocate the output uninitialised.

#include <cuda_runtime.h>

#include <cstdint>

#include "cp_async.cuh"

namespace {

using repro::allow_smem;
using repro::copy_words;
using repro::cp_async16;
using repro::cp_async4;
using repro::cp_async_commit;
using repro::cp_async_wait_all;
using repro::cp_async_wait_prior;

// A block is kCompute compute threads and kCopy copy threads, one block
// per SM (__launch_bounds__(kThreads, 1): without the 1, ptxas may cap
// the registers for two blocks and spill).
constexpr int kCompute = 256;
constexpr int kCopy = 256;
constexpr int kThreads = kCompute + kCopy;
constexpr int kCols = 2;                 // word columns per thread

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

__host__ __device__ inline int align4(int words) { return (words + 3) & ~3; }

// Words between two slots' INIT rows in shared memory: 2^k plus 4, so
// the rows of neighbouring slots start 16 bytes apart in the banks and
// a quarter-warp reading several slots' masks as 128-bit loads does so
// in one pass.
__host__ __device__ constexpr int tt_stride(int k) {
  return k == 1 ? 4 : (1 << k) + 4;
}

// Shared memory of a walk, in 32-bit words:
//   meta   the plan layout's own (TiledSlots: level_start, out_base);
//   tt     regions x region_slots x tt_stride(k) INIT masks;
//   leaf   regions x region_slots x k leaf rows;
//   rows   regions x region_slots output rows (StackedSlots only);
//   plane  n_rows x bw (when the plane lives in shared memory).
// chunk >= n_slots stages the whole plan in one region; otherwise two
// regions of `chunk` slots take turns. Each part starts 16-byte aligned.
// The wrapper (kernels/lut_eval/ops.py::walk_smem_bytes) computes the
// same sizes.
struct WalkLayout {
  int staged, region_slots, tt, leaf, rows, plane, words;
  __host__ __device__ WalkLayout(int meta, int n_slots, int k, int chunk,
                                 bool slot_rows, int n_rows, int bw,
                                 bool smem_plane) {
    staged = chunk >= n_slots;
    region_slots = staged ? n_slots : chunk;
    const int slots = (staged ? 1 : 2) * region_slots;
    tt = align4(meta);
    leaf = tt + slots * tt_stride(k);
    rows = leaf + align4(slots * k);
    plane = rows + (slot_rows ? align4(slots) : 0);
    words = plane + (smem_plane ? n_rows * bw : 0);
  }
};

// The two plan layouts. In both, slot s (counted over all levels) keeps
// its 2^k INIT masks at tt + s * 2^k and its k leaf rows at leaf + s * k.

// The streamed walk's level-major TilePlan: level l is tiles
// level_start[l] .. level_start[l+1]-1 of T slots each, and slot s
// writes row out_base[s / T] + s % T. The meta area holds level_start
// and out_base, staged whole.
struct TiledSlots {
  static constexpr bool kSlotRows = false;   // rows come from out_base
  static constexpr bool kDumpRow = false;
  const int* level_start;
  const int* out_base;
  int n_levels, n_tiles, T;
  int ts;                                    // log2 T, or -1

  __host__ __device__ int meta_words() const {
    return n_levels + 1 + n_tiles;
  }
  // the first slot of level l, from device memory (before the meta
  // area has landed) and from the meta area
  __device__ int first_slot_global(int l) const {
    return __ldg(level_start + l) * T;
  }
  __device__ int first_slot(const int* meta, int l) const {
    return meta[l] * T;
  }
  __device__ void stage_meta(int* meta, int id) const {
    copy_words(meta, level_start, n_levels + 1, id, kCopy);
    copy_words(meta + n_levels + 1, out_base, n_tiles, id, kCopy);
  }
  __device__ void stage_rows(unsigned*, int, int, int) const {}
  __device__ int out_row(const int* meta, const int*, int s, int) const {
    const int t = ts >= 0 ? s >> ts : s / T;
    return meta[n_levels + 1 + t] + s - t * T;
  }
};

// The monolithic walk's level-stacked DevicePlan: level l is slots
// l*lw .. (l+1)*lw - 1, and slot s writes row ow[s], staged beside its
// leaves; a pad slot writes the dump row n_rows - 1.
struct StackedSlots {
  static constexpr bool kSlotRows = true;
  static constexpr bool kDumpRow = true;
  const int* ow;
  int lw;

  __host__ __device__ int meta_words() const { return 0; }
  __device__ int first_slot_global(int l) const { return l * lw; }
  __device__ int first_slot(const int*, int l) const { return l * lw; }
  __device__ void stage_meta(int*, int) const {}
  __device__ void stage_rows(unsigned* dst, int a, int b, int id) const {
    copy_words(dst, ow + a, b - a, id, kCopy);
  }
  __device__ int out_row(const int*, const int* s_rows, int, int pos) const {
    return s_rows[pos];
  }
};

// n_rows rows of `row` words, packed at src, to rows `stride` words
// apart at dst, by the copy threads (number `id` of kCopy): 16-byte
// copies where both sides allow, else 4-byte. Row r is skipped where
// out_rows (if given) names the dump row for it.
__device__ __forceinline__ void copy_rows(unsigned* dst, int stride,
                                          const int* src, int n_rows,
                                          int row, int id,
                                          const int* out_rows, int dump) {
  auto skip = [&](int r) { return out_rows && out_rows[r] == dump; };
  if (row % 4 == 0 && stride % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(src) | __cvta_generic_to_shared(dst)) &
       15) == 0) {
    const int segs = row / 4;
    for (int i = id; i < n_rows * segs; i += kCopy) {
      const int r = i / segs, s = 4 * (i - r * segs);
      if (!skip(r)) cp_async16(dst + r * stride + s, src + r * row + s);
    }
  } else {
    for (int i = id; i < n_rows * row; i += kCopy) {
      const int r = i / row, s = i - r * row;
      if (!skip(r)) cp_async4(dst + r * stride + s, src + r * row + s);
    }
  }
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

// The walk over either layout. A chunk is a whole level when the plan
// is staged (every slot at its own place; the copy threads run two
// levels ahead), else at most `chunk` slots of one level in two regions
// that take turns (one chunk ahead). kCompute threads evaluate chunk i
// while kCopy threads copy; one barrier per chunk. A compute thread
// evaluates one slot over up to kCols neighbouring word columns. The
// compute threads store the constant and input rows (and the dump row)
// of the output first; with the plane in shared memory (kSmemPlane)
// each LUT row is also stored to the output as it is computed.
template <int K, bool kSmemPlane, class Slots>
__device__ __forceinline__ void walk(const Slots& plan,
                                     const int* __restrict__ pi,
                                     const int* __restrict__ tt,
                                     const int* __restrict__ leaf,
                                     int* __restrict__ out, int n_pis,
                                     int n_rows, int n_levels, int n_slots,
                                     int W, int bw, int chunk) {
  extern __shared__ __align__(16) unsigned smem[];
  const WalkLayout lay(plan.meta_words(), n_slots, K, chunk,
                       Slots::kSlotRows, n_rows, bw, kSmemPlane);
  const int* meta = reinterpret_cast<const int*>(smem);
  const unsigned* s_tt = smem + lay.tt;
  const int* s_leaf = reinterpret_cast<const int*>(smem + lay.leaf);
  const int* s_rows = reinterpret_cast<const int*>(smem + lay.rows);
  const int c0 = blockIdx.x * bw;
  const int cols = min(bw, W - c0);
  unsigned* gplane = reinterpret_cast<unsigned*>(out) + c0;
  unsigned* plane = kSmemPlane ? smem + lay.plane : gplane;
  const int stride = kSmemPlane ? bw : W;
  const bool copier = threadIdx.x >= kCompute;
  const int id = threadIdx.x - kCompute;               // copy thread id
  const int span = lay.staged ? n_slots : chunk;       // slots per chunk

  // the end of the chunk that starts at slot `from` of a level ending
  // at slot `lev_end`
  auto chunk_end = [&](int from, int lev_end) {
    return min(lev_end, from + span);
  };
  // slots [a, b) of the plan into the plan area from position p0, by
  // the copy threads (issued, not awaited). A staged stacked plan has
  // every slot's output row in place from the first barrier on
  // (`rows_in_place`), so the masks of its pad slots copied after it
  // (level 2 on) are skipped.
  auto stage = [&](int a, int b, int p0, bool rows_in_place) {
    copy_rows(smem + lay.tt + p0 * tt_stride(K), tt_stride(K),
              tt + a * (1 << K), b - a, 1 << K, id,
              rows_in_place ? s_rows + p0 : nullptr, n_rows - 1);
    copy_words(smem + lay.leaf + p0 * K, leaf + a * K, (b - a) * K, id,
               kCopy);
    if (!lay.staged) plan.stage_rows(smem + lay.rows + p0, a, b, id);
  };
  const int s1 = copier && n_levels > 0 ? plan.first_slot_global(1) : 0;
  const int s2 = copier && n_levels > 1 ? plan.first_slot_global(2) : 0;

  // the meta area (and a staged plan's output rows) and the first
  // chunk(s) first
  if (copier) {
    plan.stage_meta(reinterpret_cast<int*>(smem), id);
    if (lay.staged) {     // levels 0 and 1, one copy group each
      plan.stage_rows(smem + lay.rows, 0, n_slots, id);
      if (n_levels > 0) stage(0, s1, 0, false);
      cp_async_commit();
      if (n_levels > 1) stage(s1, s2, s1, false);
      cp_async_commit();
      cp_async_wait_prior();
    } else {
      if (n_levels > 0) stage(0, chunk_end(0, s1), 0, false);
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
    if (Slots::kDumpRow)
      for (int c = threadIdx.x; c < cols; c += kCompute)
        gplane[(n_rows - 1) * W + c] = 0u;
  }
  __syncthreads();

  // a compute thread's column group g and first slot q0 of a chunk:
  // groups of kCols columns rounded up to a power of two (2^gs), so the
  // mapping is shifts (bw <= 2 * kCompute, so q_step >= 1)
  const int gs = 32 - __clz(max(0, (cols + kCols - 1) / kCols - 1));
  const int g = threadIdx.x & ((1 << gs) - 1), cg = g * kCols;
  const int q0 = threadIdx.x >> gs, q_step = kCompute >> gs;
  int l = 0, a = 0;
  int b = n_levels > 0 ? chunk_end(0, plan.first_slot(meta, 1)) : 0;
  for (int r = 0; l < n_levels; r ^= 1) {
    // the next chunk: the rest of this level, else the next level
    const int nl = b == plan.first_slot(meta, l + 1) ? l + 1 : l, na = b;
    if (copier) {
      if (lay.staged) {   // level l+1 is in flight; level l+2 follows
        if (l + 2 < n_levels) {
          const int s = plan.first_slot(meta, l + 2);
          stage(s, plan.first_slot(meta, l + 3), s, Slots::kSlotRows);
        }
        cp_async_commit();
        cp_async_wait_prior();
      } else if (nl < n_levels) {
        stage(na, chunk_end(na, plan.first_slot(meta, nl + 1)),
              (r ^ 1) * chunk, false);
        cp_async_wait_all();
      }
    } else {
      // the plan-area position of the chunk's first slot
      const int base = lay.staged ? a : r * chunk;
      const int n = cg < cols ? b - a : 0;
      for (int q = q0; q < n; q += q_step) {
        const int pos = base + q;
        const int orow = plan.out_row(meta, s_rows, a + q, pos);
        if (Slots::kDumpRow && orow == n_rows - 1) continue;   // pad slot
        unsigned sel[kCols][K], res[kCols];
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const unsigned* row = plane + s_leaf[pos * K + j] * stride + cg;
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            sel[c][j] = cg + c < cols ? row[c] : 0u;
        }
        eval_slot<K>(s_tt + pos * tt_stride(K), sel, res);
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
    if (l < n_levels) b = chunk_end(a, plan.first_slot(meta, l + 1));
  }
}

// Monolithic walk over the level-stacked plan: slot s of level l is
// slot l*lw + s of leaf, tt and ow.
template <int K, bool kSmemPlane>
__global__ void __launch_bounds__(kThreads, 1)
lut_eval_kernel(const int* __restrict__ pi, const int* __restrict__ leaf,
                const int* __restrict__ tt, const int* __restrict__ ow,
                int* __restrict__ out, int n_pis, int n_rows, int n_levels,
                int lw, int W, int bw, int chunk) {
  walk<K, kSmemPlane>(StackedSlots{ow, lw}, pi, tt, leaf, out, n_pis, n_rows,
                      n_levels, n_levels * lw, W, bw, chunk);
}

// Streamed walk over the level-major tile plan; `chunk` counts tiles.
template <int K, bool kSmemPlane>
__global__ void __launch_bounds__(kThreads, 1)
lut_eval_streamed_kernel(const int* __restrict__ pi,
                         const int* __restrict__ tt_tiles,
                         const int* __restrict__ leaf_tiles,
                         const int* __restrict__ out_base,
                         const int* __restrict__ level_start,
                         int* __restrict__ out, int n_pis, int n_rows,
                         int n_levels, int n_tiles, int T, int W, int bw,
                         int chunk) {
  const TiledSlots plan{level_start, out_base, n_levels, n_tiles, T,
                        (T & (T - 1)) == 0 ? __ffs(T) - 1 : -1};
  walk<K, kSmemPlane>(plan, pi, tt_tiles, leaf_tiles, out, n_pis, n_rows,
                      n_levels, n_tiles * T, W, bw, chunk * T);
}

template <int K, bool kSmemPlane>
cudaError_t launch_mono(const int* pi, const int* leaf, const int* tt,
                        const int* ow, int* out, int n_pis, int n_rows,
                        int n_levels, int lw, int W, int bw, int chunk,
                        cudaStream_t stream) {
  static size_t opted = 0;
  if (chunk < 1) return cudaErrorInvalidValue;
  const WalkLayout lay(0, n_levels * lw, K, chunk, true, n_rows, bw,
                       kSmemPlane);
  const size_t smem = size_t(lay.words) * sizeof(unsigned);
  const cudaError_t err =
      allow_smem(lut_eval_kernel<K, kSmemPlane>, smem, opted);
  if (err != cudaSuccess) return err;
  const int grid = (W + bw - 1) / bw;
  lut_eval_kernel<K, kSmemPlane><<<grid, kThreads, smem, stream>>>(
      pi, leaf, tt, ow, out, n_pis, n_rows, n_levels, lw, W, bw, chunk);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_mono(const int* pi, const int* leaf, const int* tt,
                        const int* ow, int* out, int n_pis, int n_rows,
                        int n_levels, int lw, int W, int bw, int use_smem,
                        int chunk, cudaStream_t stream) {
  return use_smem ? launch_mono<K, true>(pi, leaf, tt, ow, out, n_pis,
                                         n_rows, n_levels, lw, W, bw, chunk,
                                         stream)
                  : launch_mono<K, false>(pi, leaf, tt, ow, out, n_pis,
                                          n_rows, n_levels, lw, W, bw, chunk,
                                          stream);
}

template <int K, bool kSmemPlane>
cudaError_t launch_streamed(const int* pi, const int* tt_tiles,
                            const int* leaf_tiles, const int* out_base,
                            const int* level_start, int* out, int n_pis,
                            int n_rows, int n_levels, int n_tiles, int T,
                            int W, int bw, int chunk, cudaStream_t stream) {
  static size_t opted = 0;
  if (chunk < 1) return cudaErrorInvalidValue;
  const WalkLayout lay(n_levels + 1 + n_tiles, n_tiles * T, K, chunk * T,
                       false, n_rows, bw, kSmemPlane);
  const size_t smem = size_t(lay.words) * sizeof(unsigned);
  const cudaError_t err =
      allow_smem(lut_eval_streamed_kernel<K, kSmemPlane>, smem, opted);
  if (err != cudaSuccess) return err;
  const int grid = (W + bw - 1) / bw;
  lut_eval_streamed_kernel<K, kSmemPlane>
      <<<grid, kThreads, smem, stream>>>(
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
// All int32, contiguous, on the device of `stream`. `chunk` >=
// n_levels*lw stages the whole plan in shared memory; a smaller one
// streams it in chunks of at most that many slots. Returns a
// cudaError_t (0 on success).
int lut_eval_launch(const void* pi, const void* leaf, const void* tt,
                    const void* ow, void* out, int n_pis, int n_rows,
                    int n_levels, int lw, int k, int W, int bw, int use_smem,
                    int chunk, void* stream) {
  auto* p = static_cast<const int*>(pi);
  auto* l = static_cast<const int*>(leaf);
  auto* t = static_cast<const int*>(tt);
  auto* o = static_cast<const int*>(ow);
  auto* y = static_cast<int*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch_mono<1>(p, l, t, o, y, n_pis, n_rows, n_levels, lw, W, bw, use_smem, chunk, s);
    case 2: return launch_mono<2>(p, l, t, o, y, n_pis, n_rows, n_levels, lw, W, bw, use_smem, chunk, s);
    case 3: return launch_mono<3>(p, l, t, o, y, n_pis, n_rows, n_levels, lw, W, bw, use_smem, chunk, s);
    case 4: return launch_mono<4>(p, l, t, o, y, n_pis, n_rows, n_levels, lw, W, bw, use_smem, chunk, s);
    case 5: return launch_mono<5>(p, l, t, o, y, n_pis, n_rows, n_levels, lw, W, bw, use_smem, chunk, s);
    case 6: return launch_mono<6>(p, l, t, o, y, n_pis, n_rows, n_levels, lw, W, bw, use_smem, chunk, s);
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
