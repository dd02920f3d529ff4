// Bit-parallel AIG simulation by sweeps over all AND nodes at once, for
// sm_90a.
//
// Replaces the TPU kernel
//   src/repro/kernels/aig_sim/aig_sim.py::aig_sim_pallas.
//
// What it computes. The value plane has one row of W packed 32-bit
// words per AIG node: row 0 is the constant 0, rows 1..n_pis echo the
// input words, and AND node i (row 1 + n_pis + i) is
//   (v[l0 >> 1] ^ -(l0 & 1)) & (v[l1 >> 1] ^ -(l1 & 1))
// for its fanin literals l0 = f0[i], l1 = f1[i] (literal = 2 * node +
// complement). The reference walks the nodes in order, so a literal
// that names the node itself or a later row reads that row while it is
// still 0; word columns never interact.
//
// What bounds it on this card. By bytes, reading the inputs and the
// literals and writing the plane once: about 0.2 us at the bench shape
// (601 ANDs, W = 256). By operations, three per node and word:
// nothing. What sets its time is the chain of dependent loads and
// stores from the inputs to the deepest node. A walk in node order makes
// that chain as long as the node count (the first form: one thread per
// word column, 601 steps of about 70 ns); the AIG's depth is far less
// (11 at the bench shape).
//
// What the design does about it.
//  * Sweeps. A block of up to 1024 threads takes a tile of TW word
//    columns (1, 2 or 4: the wrapper picks the widest that still gives
//    128 blocks, so W = 256 is 128 blocks of 2 words). In each sweep
//    every thread recomputes its nodes t, t + T, ... from the plane of
//    the sweep before, over all TW words at once (one 4-, 8- or 16-byte
//    row access), into a second plane; one barrier ends the sweep, and
//    the two planes change roles. After sweep k every node of depth at
//    most k holds its value, so depth + 1 sweeps compute the plane; the
//    block stops after the first sweep that changes no row (all nodes
//    then satisfy their equations at once, and the AND graph has no
//    cycle, so that is the one solution): at most depth + 2 sweeps,
//    fewer where values settle before their deepest input does (an AND
//    chain with random side inputs settles long before its end). A
//    sweep is the same work for every thread, with no per-node
//    readiness test. Both planes start as the inputs and zeros.
//  * A cap on the sweeps. An AIG whose values keep changing down a long
//    chain (node i = NOT node i - 1) needs as many sweeps as its depth,
//    each a pass over every node: at 2,500 ANDs some 2 ms (the variant
//    below that ran exactly depth sweeps), 4.5x the first form's walk
//    in node order. So after max_sweeps(n_ands) = 16 + n_ands / 16
//    sweeps (53 at the bench shape, which needs 13) one thread of the
//    block walks the nodes in order in one plane, in place, as the
//    reference does: every row it reads is an input or a node it has
//    just rewritten, whatever the plane held before. A sweep costs
//    about as much as 16 nodes of that walk (0.3-0.8 us against 50-100
//    ns a node), so the sweeps spent before it are about as long as the
//    walk itself, and such an AIG takes about twice the walk in node
//    order at most.
//  * Designs this replaced (on an H100 at 700 W, by
//    chip_smoke.py --kernel-times): a ready flag per node, polled by the
//    readers, 7.0-7.7 us at the bench shape and 1.0-1.6 ms on a strict
//    chain of 2,500 ANDs; one barrier round per level with a stamp per
//    node, tested before each evaluation, 8.3-8.8 us and 1.15-1.35 ms.
//    In both, every node's test was a divergent branch around dependent
//    shared-memory loads, and a level cost several times a barrier.
//    Sweeps that skip a node once both fanins are final (a stamp per
//    node; exactly depth sweeps) ran 6.9 us and 2.0 ms: the stamp reads
//    cost more than the skipped rows, and the chain could no longer
//    stop early.
//  * Forward literals read 0, as in the reference: a fanin row at or
//    past the node's own row is not read, its value is 0 and then the
//    complement applies, so such a row is no edge of the graph. Literals
//    past the plane fall under the same rule.
//  * The planes. With both planes in shared memory (the block's 2 x
//    n_rows x TW words and the literals fit the 227 KB budget), each
//    thread keeps its first node's literals in registers and the rest
//    are staged there too; the plane is copied out after the last sweep
//    (which changed nothing, so either plane holds it; after the walk
//    in node order, the first), row by row. No
//    sweep stores to device memory: a barrier waits for the block's
//    device-memory stores, so a sweep that stored each changed row
//    took the store's round trip (9.1 against 6.9 us at the bench
//    shape). A row store is TW * 4 bytes of a 32-byte sector, the
//    neighbouring blocks' stores filling the rest.
//    Otherwise the two planes are the output and a scratch plane of the
//    same shape in device memory that the wrapper allocates; the last
//    sweep changed nothing, so both hold the result (after the walk in
//    node order, the output does).
// Every row of the returned plane is written by the kernel, so the
// wrapper may allocate it uninitialised.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;

// Dynamic shared memory of a block, in bytes: with the planes in shared
// memory, two of n_rows x TW words, then the literals (2 words a node)
// of the nodes past the first `threads`. The wrapper
// (kernels/aig_sim/ops.py::walk_smem_bytes) computes the same size.
__host__ __device__ inline size_t smem_bytes(int n_pis, int n_ands, int tw,
                                             int threads) {
  const size_t rows = size_t(1) + n_pis + n_ands;
  const size_t staged = n_ands > threads ? size_t(n_ands - threads) : 0;
  return 4 * (2 * rows * tw + 2 * staged);
}

// Sweeps a block runs before it finishes the walk in node order (the
// wrapper, kernels/aig_sim/ops.py::max_sweeps, states the same rule).
__host__ __device__ inline int max_sweeps(int n_ands) {
  return 16 + n_ands / 16;
}

// Threads of a block: one per node, in whole warps, at most kMaxThreads.
__host__ __device__ inline int block_threads(int n_ands) {
  return n_ands >= kMaxThreads ? kMaxThreads
                               : (n_ands + 31) / 32 * 32 + 32 * (n_ands == 0);
}

// TW words of a plane row: one vector access (`kVec`: in shared memory,
// or a whole aligned row of the output), else word by word (`cols` of
// them valid).
template <int TW, bool kVec>
__device__ __forceinline__ void load_row(const unsigned* p, int cols,
                                         unsigned (&v)[TW]) {
  if constexpr (kVec && TW == 4) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (kVec && TW == 2) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
#pragma unroll
    for (int c = 0; c < TW; ++c) v[c] = c < cols ? p[c] : 0u;
  }
}

template <int TW, bool kVec>
__device__ __forceinline__ void store_row(unsigned* p, int cols,
                                          const unsigned (&v)[TW]) {
  if constexpr (kVec && TW == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
  } else if constexpr (kVec && TW == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(v[0], v[1]);
  } else {
#pragma unroll
    for (int c = 0; c < TW; ++c)
      if (c < cols) p[c] = v[c];
  }
}

// The node at plane row `row`, literals a and b, from the plane `rd`
// into the plane `wr` (rows `stride` words apart); `val` holds the
// node's row in `rd` and takes the new one. Returns whether it changed.
template <int TW, bool kSmem>
__device__ __forceinline__ bool sweep_node(unsigned a, unsigned b, int row,
                                           const unsigned* rd, unsigned* wr,
                                           int stride, int cols,
                                           unsigned (&val)[TW]) {
  unsigned va[TW], vb[TW];
  const unsigned sa = a >> 1, sb = b >> 1;
  const unsigned ia = 0u - (a & 1u), ib = 0u - (b & 1u);
  // a row at or past the node's own reads 0 (and is not loaded)
  if (sa < static_cast<unsigned>(row)) {
    load_row<TW, kSmem>(rd + size_t(sa) * stride, cols, va);
  } else {
#pragma unroll
    for (int c = 0; c < TW; ++c) va[c] = 0u;
  }
  if (sb < static_cast<unsigned>(row)) {
    load_row<TW, kSmem>(rd + size_t(sb) * stride, cols, vb);
  } else {
#pragma unroll
    for (int c = 0; c < TW; ++c) vb[c] = 0u;
  }
  bool changed = false;
#pragma unroll
  for (int c = 0; c < TW; ++c) {
    va[c] = (va[c] ^ ia) & (vb[c] ^ ib);
    changed |= va[c] != val[c];
    val[c] = va[c];
  }
  store_row<TW, kSmem>(wr + size_t(row) * stride, cols, va);
  return changed;
}

template <int TW, bool kSmemPlane>
__global__ void __launch_bounds__(kMaxThreads)
aig_sim_kernel(const unsigned* __restrict__ pi,
               const unsigned* __restrict__ f0,
               const unsigned* __restrict__ f1, unsigned* out,
               unsigned* scratch, int n_pis, int n_ands, int W) {
  extern __shared__ __align__(16) unsigned smem[];
  const int first = 1 + n_pis;                  // the first AND row
  const int n_rows = first + n_ands;
  const int T = blockDim.x;
  const int c0 = blockIdx.x * TW;
  const int cols = min(TW, W - c0);
  // the two planes: this block's columns, rows `stride` words apart
  const int stride = kSmemPlane ? TW : W;
  unsigned* const p0 = kSmemPlane ? smem : out + c0;
  unsigned* const p1 =
      kSmemPlane ? smem + size_t(n_rows) * TW : scratch + c0;
  unsigned* const gout = out + c0;
  // the literals of nodes T and up (each thread keeps its first node's
  // in registers): in shared memory, or read from device memory
  unsigned* s_lit = smem + 2 * size_t(n_rows) * TW - T;  // (kSmemPlane)
  const unsigned* lf0 = kSmemPlane ? s_lit : f0;
  const unsigned* lf1 = kSmemPlane ? s_lit + (n_ands - T) : f1;

  // every load first: the first node's literals, the input words
  const int i0 = threadIdx.x;
  const unsigned a0 = i0 < n_ands ? __ldg(f0 + i0) : 0u;
  const unsigned b0 = i0 < n_ands ? __ldg(f1 + i0) : 0u;
  if (kSmemPlane)
    for (int i = T + i0; i < n_ands; i += T) {
      s_lit[i] = __ldg(f0 + i);
      s_lit[n_ands - T + i] = __ldg(f1 + i);
    }
  // both planes: the constant and input rows, AND rows 0
  for (int j = i0; j < n_rows * TW; j += T) {
    const int r = j / TW, c = j - r * TW;
    if (c >= cols) {
      if (kSmemPlane) p0[j] = p1[j] = 0u;
      continue;
    }
    const unsigned v =
        r >= 1 && r < first ? __ldg(pi + size_t(r - 1) * W + c0 + c) : 0u;
    p0[size_t(r) * stride + c] = v;
    p1[size_t(r) * stride + c] = v;
  }
  __syncthreads();

  // sweep s reads plane s % 2 and writes the other; a thread keeps its
  // first node's row in registers, and reads its other nodes' old rows
  bool odd = false, changed, more;
  int sweeps = 0;
  unsigned v0[TW] = {};
  do {
    const unsigned* rd = odd ? p1 : p0;
    unsigned* wr = odd ? p0 : p1;
    changed = false;
    if (i0 < n_ands)
      changed |= sweep_node<TW, kSmemPlane>(a0, b0, first + i0, rd, wr,
                                            stride, cols, v0);
    for (int i = i0 + T; i < n_ands; i += T) {
      unsigned v[TW];
      load_row<TW, kSmemPlane>(rd + size_t(first + i) * stride, cols, v);
      changed |= sweep_node<TW, kSmemPlane>(lf0[i], lf1[i], first + i, rd,
                                            wr, stride, cols, v);
    }
    odd = !odd;
    more = __syncthreads_or(changed);
  } while (more && ++sweeps < max_sweeps(n_ands));

  if (more) {
    // still changing at the cap: walk the nodes in order in p0, whose
    // constant and input rows are set and whose AND rows are rewritten
    // before any later node reads them
    if (i0 == 0) {
      unsigned a = n_ands > 0 ? __ldg(f0) : 0u;
      unsigned b = n_ands > 0 ? __ldg(f1) : 0u;
      for (int i = 0; i < n_ands; ++i) {
        const unsigned an = i + 1 < n_ands ? __ldg(f0 + i + 1) : 0u;
        const unsigned bn = i + 1 < n_ands ? __ldg(f1 + i + 1) : 0u;
        unsigned v[TW] = {};
        sweep_node<TW, kSmemPlane>(a, b, first + i, p0, p0, stride, cols, v);
        a = an;
        b = bn;
      }
    }
    __syncthreads();
  }

  if (!kSmemPlane) return;
  // the plane to the output (p0: the last sweep changed nothing, or the
  // walk in node order ran there): a row per store where the block's columns
  // are whole and aligned, else word by word
  if (cols == TW && W % TW == 0) {
    for (int r = i0; r < n_rows; r += T) {
      unsigned v[TW];
      load_row<TW, true>(p0 + size_t(r) * TW, TW, v);
      store_row<TW, true>(gout + size_t(r) * W, TW, v);
    }
  } else {
    for (int j = i0; j < n_rows * TW; j += T) {
      const int r = j / TW, c = j - r * TW;
      if (c < cols) gout[size_t(r) * W + c] = p0[j];
    }
  }
}

template <int TW, bool kSmemPlane>
cudaError_t launch(const unsigned* pi, const unsigned* f0, const unsigned* f1,
                   unsigned* out, unsigned* scratch, int n_pis, int n_ands,
                   int W, cudaStream_t stream) {
  static size_t opted = 0;
  const int threads = block_threads(n_ands);
  const size_t smem = kSmemPlane ? smem_bytes(n_pis, n_ands, TW, threads) : 0;
  if (smem > 48 * 1024 && smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        aig_sim_kernel<TW, kSmemPlane>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted = smem;
  }
  const int grid = (W + TW - 1) / TW;
  aig_sim_kernel<TW, kSmemPlane><<<grid, threads, smem, stream>>>(
      pi, f0, f1, out, scratch, n_pis, n_ands, W);
  return cudaGetLastError();
}

template <int TW>
cudaError_t launch(const unsigned* pi, const unsigned* f0, const unsigned* f1,
                   unsigned* out, unsigned* scratch, int n_pis, int n_ands,
                   int W, cudaStream_t stream) {
  if (scratch)
    return launch<TW, false>(pi, f0, f1, out, scratch, n_pis, n_ands, W,
                             stream);
  return launch<TW, true>(pi, f0, f1, out, nullptr, n_pis, n_ands, W,
                          stream);
}

}  // namespace

extern "C" {

// pi (n_pis, W) words; f0, f1 (n_ands,) literals; out (1 + n_pis +
// n_ands, W). All int32, contiguous, on the device of `stream`. `tw`
// (1, 2 or 4) word columns per block; `scratch` null for the planes in
// shared memory, else a second plane of out's shape in device memory.
// Returns a cudaError_t.
int aig_sim_launch(const void* pi, const void* f0, const void* f1, void* out,
                   void* scratch, int n_pis, int n_ands, int W, int tw,
                   void* stream) {
  if (W <= 0) return cudaSuccess;
  auto* p = static_cast<const unsigned*>(pi);
  auto* a = static_cast<const unsigned*>(f0);
  auto* b = static_cast<const unsigned*>(f1);
  auto* y = static_cast<unsigned*>(out);
  auto* sc = static_cast<unsigned*>(scratch);
  auto s = static_cast<cudaStream_t>(stream);
  switch (tw) {
    case 1: return launch<1>(p, a, b, y, sc, n_pis, n_ands, W, s);
    case 2: return launch<2>(p, a, b, y, sc, n_pis, n_ands, W, s);
    case 4: return launch<4>(p, a, b, y, sc, n_pis, n_ands, W, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
