// Flash-attention forward (online softmax) and backward on the tensor
// cores, for sm_90a, in float32 or bfloat16.
//
// The forward replaces the TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas
// and the GQA plumbing of its wrapper (flash_attention/ops.py). The
// backward (below the forward) has no TPU kernel: the reference trains
// through src/repro/models/layers.py::full_attention, differentiated by
// XLA. The forward can write each row's log-sum-exp for it.
//
// What it computes. q (B, Sq, H, dh), k and v (B, Sk, KV, dh), with
// H a multiple of KV; query head h reads KV head h / (H / KV). For each
// query row i and key j, s = (q_i . k_j) * scale with scale =
// 1/sqrt(dh), set to NEG_INF = -1e30 where masked (causal: j > i;
// window w > 0: j <= i - w); out_i = sum_j softmax(s)_j v_j, kept as a
// running max m, running sum l and accumulator in float32 and divided
// by max(l, 1e-30) at the end, as the reference kernel does. Query and
// key positions both start at 0. A row whose every key is masked gets
// the mean of v over all Sk keys (the dense softmax over all -1e30
// scores, as the reference's oracle and full_attention give). bfloat16
// operands round where the reference kernel rounds: scores in float32
// from the bf16 operands, P rounded to bf16 before P.V (summed in
// float32), the output in bf16.
//
// What bounds it on this card. At the bench shape (q 1024 x 4 heads,
// k and v 1024 x 2 heads, dh 64, causal) it reads and writes 3 MB and
// does 0.54 GFLOP: 0.9 us of bytes, 1.1 us of bf16 tensor-core work
// (989 TFLOP/s) or 3.3 us of float32 work done as three TF32 passes
// (495 TFLOP/s). At that size neither bounds it: every block reads its
// rows' whole key range from L2 into shared memory, so the copies
// (17 MB in bf16 at the bench shape, 34 MB in float32, with the design
// below) and the latency of each step set the time. Only 256 tiles of
// 16 query rows exist, against 132 SMs.
//
// What the design does about it.
//  * Tensor cores through mma.sync. A warp owns 16 query rows of one
//    head and a slice of their keys. Q.K^T and P.V are m16n8 products:
//    bf16 as m16n8k16 with float32 sums; float32 as m16n8k8 TF32 in
//    three passes (each operand split into hi + lo TF32 parts, summed
//    as hi.hi + hi.lo + lo.hi; one TF32 pass errs by ~5e-4 on a 64-term
//    score, above the 2e-4 tolerance). S and P never leave registers:
//    the Q.K^T accumulator fragment is reused as the A fragment of P.V
//    (for TF32 by taking the 8 keys of an n-block in the order
//    0,2,4,6,1,3,5,7, the order V's rows are read in too). Row max and
//    row sum reduce over the four threads of a quad with shuffles.
//  * A block owns 16 rows of two query heads that read the same KV head
//    (grouped-query attention; one head where the group is odd), so
//    each K / V step copied to shared memory serves both.
//  * The key range is split across 4 slices of the block: it is cut into
//    steps of 32 keys (16 in float32 at dh above 64) and slice s takes
//    steps s, s + 4, ...
//    The slices' (m, l, acc) merge through shared memory at the end. So
//    the bench shape runs 128 blocks of 8 warps, one to an SM.
//  * Each slice streams its steps of K and V through a ring of three in
//    shared memory with cp.async: steps j+1 and j+2 load while step j
//    is computed, and only the slice's own warps wait for them (a named
//    barrier, no block barrier inside the loop). Rows are padded so
//    every fragment read is free of bank conflicts; dh is zero-padded to
//    the template width (16, 32, 64, 128) in shared memory only, and
//    keys past the block's range are zero-filled.
//  * Heaviest first: with a causal mask the grid is ordered from the
//    last row tile (the most keys) to the first.
//  * wgmma is not used: it needs 64-row tiles per warpgroup, which
//    would cut the bench shape to 32 blocks. At this size the work is
//    a few microseconds at the mma.sync rate; the copies and the latency
//    of each step set the time, not the peak rate.
// Ragged Sq and Sk are masked in the kernel, nothing is padded in device
// memory. exp2f with log2(e) folded into the scale, no fast math.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>
#include <initializer_list>

#include "wgmma.cuh"

namespace {

constexpr int kSlices = 4;                  // key slices per block
constexpr int kMaxHeads = 2;                // query heads per block
constexpr int kMaxThreads = 32 * kSlices * kMaxHeads;
constexpr int kRows = 16;                   // query rows per block
constexpr int kStages = 3;                  // K / V steps in a slice's ring
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A slice's K / V step in shared memory: kKeys keys (32; 16 in float32
// at dh above 64, where three stages of 32 would not fit), each row DHP
// elements plus a pad that keeps rows 16-byte aligned and the fragment
// reads free of bank conflicts.
template <typename T, int DHP>
struct Tile {
  static constexpr int kKeys = sizeof(T) == 2 || DHP <= 64 ? 32 : 16;
  static constexpr int kPad = 16 / sizeof(T);
  static constexpr int kStride = DHP + kPad;            // elements per row
  static constexpr int kStep = kKeys * kStride;         // one K or V step
  static constexpr int kSliceElems = kStages * 2 * kStep;   // a ring
  static constexpr int kBytes = kSlices * kSliceElems * sizeof(T);
  // the merge area (m, l, acc and weights of every warp) reuses them
  static constexpr int kWarps = kSlices * kMaxHeads;
  static constexpr int kMergeBytes =
      (3 * kWarps * kRows + kWarps * kRows * (DHP + 1)) * 4;
  static constexpr int kSmem = kBytes > kMergeBytes ? kBytes : kMergeBytes;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const int n = valid ? N : 0;                  // 0: zero-fill
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "n"(N), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [r0, r0 + ROWS) of one head (row r at base + r * row_elems) into
// a shared tile of stride Tile::kStride, copied by n threads (thread
// `id` of them); rows at or past `hi` and columns past dh are zero. The
// copy width is 1 << cw_shift bytes (16, 8 or 4 by cp.async; 2, a bf16
// row of odd dh, by plain loads), chosen by the launcher to divide
// every row's start.
template <typename T, int DHP, int ROWS>
__device__ __forceinline__ void load_rows(T* dst, const T* base, int r0,
                                          int hi, int row_elems, int dh,
                                          int cw_shift, int id, int n) {
  using TL = Tile<T, DHP>;
  constexpr int kRowBytes = DHP * sizeof(T);
  const int cw = 1 << cw_shift;
  const int seg_shift = __ffs(kRowBytes) - 1 - cw_shift;  // log2 segs
  const int dh_bytes = dh * static_cast<int>(sizeof(T));
  for (int e = id; e < (ROWS << seg_shift); e += n) {
    const int j = e >> seg_shift;
    const int off = (e - (j << seg_shift)) << cw_shift;
    const bool valid = r0 + j < hi && off < dh_bytes;
    char* d = reinterpret_cast<char*>(dst + j * TL::kStride) + off;
    const char* s =
        valid ? reinterpret_cast<const char*>(base + size_t(r0 + j) *
                                                         row_elems) + off
              : reinterpret_cast<const char*>(base);
    switch (cw) {
      case 16: cp_async<16>(d, s, valid); break;
      case 8: cp_async<8>(d, s, valid); break;
      case 4: cp_async<4>(d, s, valid); break;
      default:
        *reinterpret_cast<uint16_t*>(d) =
            valid ? *reinterpret_cast<const uint16_t*>(s) : uint16_t(0);
    }
  }
}

// Keys [k0, k0 + kKeys) of one KV head into a slice's shared step.
template <typename T, int DHP>
__device__ __forceinline__ void load_step(T* dst, const T* base, int k0,
                                          int hi, int row_elems, int dh,
                                          int cw_shift, int id, int n) {
  load_rows<T, DHP, Tile<T, DHP>::kKeys>(dst, base, k0, hi, row_elems, dh,
                                         cw_shift, id, n);
}

// ---- TF32 (float32 in three passes) ------------------------------------

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void split4(const float (&a)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) split(a[r], hi[r], lo[r]);
}

// hi.hi + hi.lo + lo.hi of an A fragment (split once by the caller) and
// a B fragment; the small terms go to `e`
__device__ __forceinline__ void mma_3xtf32(float (&s)[4], float (&e)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0,
                                           float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(s, ah, bh0, bh1);
  mma_tf32(e, ah, bl0, bl1);
  mma_tf32(e, al, bh0, bh1);
}

// ---- bf16 ------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// 2^x by one MUFU.EX2 (flushes a result below 2^-126 to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits16(const __nv_bfloat16* p, bool in) {
  return in ? *reinterpret_cast<const uint16_t*>(p) : 0u;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// ---- the kernel ------------------------------------------------------------

// Per-type pieces: the Q fragments (loaded once), Q.K^T of one warp's
// step of kKeys keys, and P.V of them. S of a step is kNB = kKeys / 8
// accumulator fragments: n-block nb holds keys 8nb + 2t and 8nb + 2t + 1
// in rows g and g + 8.
template <typename T, int DHP> struct Mma;

template <int DHP>
struct Mma<float, DHP> {
  static constexpr int kSteps = DHP / 8;         // k-steps of Q.K^T
  static constexpr int kNB = Tile<float, DHP>::kKeys / 8;
  static constexpr int kStride = Tile<float, DHP>::kStride;
  using QFrag = float[kSteps][4];

  // a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4) of each 16 x 8 step
  static __device__ __forceinline__ void load_q(QFrag& qf, const float* q,
                                                int row0, int Sq, int ld,
                                                int dh, int g, int t) {
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = row0 + g + (r & 1) * 8, d = s * 8 + t + (r >> 1) * 4;
        qf[s][r] = (i < Sq && d < dh) ? q[size_t(i) * ld + d] : 0.0f;
      }
  }

  static __device__ __forceinline__ void scores(float (&sc)[kNB][4],
                                                const QFrag& qf,
                                                const float* kt, int g,
                                                int t) {
    float e[kNB][4];
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) sc[nb][r] = e[nb][r] = 0.0f;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      uint32_t qh[4], ql[4];
      split4(qf[s], qh, ql);
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
        const float* kr = kt + (nb * 8 + g) * kStride + s * 8 + t;
        mma_3xtf32(sc[nb], e[nb], qh, ql, kr[0], kr[4]);
      }
    }
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) sc[nb][r] += e[nb][r];
  }

  // scores() with the A fragments read from 16 rows of a shared tile
  // (stride kStride) instead of registers: the backward's products
  static __device__ __forceinline__ void scores_s(float (&sc)[kNB][4],
                                                  const float* a,
                                                  const float* bt, int g,
                                                  int t) {
    float e[kNB][4];
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) sc[nb][r] = e[nb][r] = 0.0f;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const float* ar = a + g * kStride + s * 8 + t;
      const float af[4] = {ar[0], ar[8 * kStride], ar[4], ar[8 * kStride + 4]};
      uint32_t ah[4], al[4];
      split4(af, ah, al);
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
        const float* kr = bt + (nb * 8 + g) * kStride + s * 8 + t;
        mma_3xtf32(sc[nb], e[nb], ah, al, kr[0], kr[4]);
      }
    }
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) sc[nb][r] += e[nb][r];
  }

  // acc (16 x DHP) += P V. The A fragment of key block nb is the
  // accumulator of n-block nb with its keys 2t, 2t+1 taken as columns
  // t, t+4; V's rows are read in that order.
  static __device__ __forceinline__ void pv(float (&acc)[DHP / 8][4],
                                            const float (&p)[kNB][4],
                                            const float* vt, int g, int t) {
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      const float a[4] = {p[nb][0], p[nb][2], p[nb][1], p[nb][3]};
      uint32_t ah[4], al[4];
      split4(a, ah, al);
      const float* vr = vt + (nb * 8 + 2 * t) * kStride + g;
#pragma unroll
      for (int dn = 0; dn < DHP / 8; ++dn)
        mma_3xtf32(acc[dn], acc[dn], ah, al, vr[dn * 8],
                   vr[kStride + dn * 8]);
    }
  }
};

template <int DHP>
struct Mma<__nv_bfloat16, DHP> {
  static constexpr int kSteps = DHP / 16;
  static constexpr int kNB = Tile<__nv_bfloat16, DHP>::kKeys / 8;
  static constexpr int kStride = Tile<__nv_bfloat16, DHP>::kStride;
  using QFrag = uint32_t[kSteps][4];

  // a0 (g, 2t..2t+1), a1 (g+8, ..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
  static __device__ __forceinline__ void load_q(QFrag& qf,
                                                const __nv_bfloat16* q,
                                                int row0, int Sq, int ld,
                                                int dh, int g, int t) {
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = row0 + g + (r & 1) * 8;
        const int d = s * 16 + 2 * t + (r >> 1) * 8;
        const __nv_bfloat16* p = q + size_t(i < Sq ? i : 0) * ld + d;
        qf[s][r] = bits16(p, i < Sq && d < dh) |
                   bits16(p + 1, i < Sq && d + 1 < dh) << 16;
      }
  }

  static __device__ __forceinline__ void scores(float (&sc)[kNB][4],
                                                const QFrag& qf,
                                                const __nv_bfloat16* kt,
                                                int g, int t) {
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) sc[nb][r] = 0.0f;
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
        const __nv_bfloat16* kr =
            kt + (nb * 8 + g) * kStride + s * 16 + 2 * t;
        mma_bf16(sc[nb], qf[s], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
  }

  // scores() with the A fragments read from 16 rows of a shared tile
  static __device__ __forceinline__ void scores_s(float (&sc)[kNB][4],
                                                  const __nv_bfloat16* a,
                                                  const __nv_bfloat16* bt,
                                                  int g, int t) {
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) sc[nb][r] = 0.0f;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const __nv_bfloat16* ar = a + g * kStride + s * 16 + 2 * t;
      const uint32_t af[4] = {
          *reinterpret_cast<const uint32_t*>(ar),
          *reinterpret_cast<const uint32_t*>(ar + 8 * kStride),
          *reinterpret_cast<const uint32_t*>(ar + 8),
          *reinterpret_cast<const uint32_t*>(ar + 8 * kStride + 8)};
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
        const __nv_bfloat16* kr =
            bt + (nb * 8 + g) * kStride + s * 16 + 2 * t;
        mma_bf16(sc[nb], af, *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }
  }

  // P rounded to bf16: the accumulators of n-blocks 2kb and 2kb + 1 are
  // the A fragment of k16 step kb as they lie. V's B fragments come by
  // ldmatrix.trans, two dh n-blocks per x4 load.
  static __device__ __forceinline__ void pv(float (&acc)[DHP / 8][4],
                                            const float (&p)[kNB][4],
                                            const __nv_bfloat16* vt, int g,
                                            int t) {
    const int lane = threadIdx.x & 31, mi = lane >> 3;
#pragma unroll
    for (int kb = 0; kb < kNB / 2; ++kb) {
      const uint32_t a[4] = {pack_bf16(p[2 * kb][0], p[2 * kb][1]),
                             pack_bf16(p[2 * kb][2], p[2 * kb][3]),
                             pack_bf16(p[2 * kb + 1][0], p[2 * kb + 1][1]),
                             pack_bf16(p[2 * kb + 1][2], p[2 * kb + 1][3])};
      const __nv_bfloat16* row =
          vt + (kb * 16 + (lane & 7) + (mi & 1) * 8) * kStride + (mi >> 1) * 8;
#pragma unroll
      for (int dn = 0; dn < DHP / 8; dn += 2) {
        uint32_t b0, b1, b2, b3;
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
            "[%4];\n"
            : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
            : "r"(smem_addr(row + dn * 8)));
        mma_bf16(acc[dn], a, b0, b1);
        mma_bf16(acc[dn + 1], a, b2, b3);
      }
    }
  }
};

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// A block owns 16 query rows of HB query heads that read one KV head
// (HB = 2 when the heads per KV head are even, else 1) and splits their
// key range into kSlices slices. Warp w serves slice w / HB for head
// w % HB; the HB warps of a slice share its ring of K / V steps.
template <typename T, int DHP>
__global__ void __launch_bounds__(kMaxThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int B, int H, int KV, int Sq,
                       int Sk, int dh, float scale, int causal, int window,
                       int cw_shift, int HB) {
  using M = Mma<T, DHP>;
  using TL = Tile<T, DHP>;
  constexpr int kNB = M::kNB;
  extern __shared__ __align__(16) unsigned char smem[];

  // heaviest first: under a causal mask the last row tiles see the
  // most keys, so the grid walks row tiles from the last
  const int n_rt = (Sq + kRows - 1) / kRows;
  const int groups = B * (H / HB);               // (batch, head group)s
  const int bg = blockIdx.x % groups;
  int rt = blockIdx.x / groups;
  if (causal) rt = n_rt - 1 - rt;
  const int b = bg / (H / HB);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slice = warp / HB;
  const int h = (bg - b * (H / HB)) * HB + warp % HB;
  const int kvh = h / (H / KV);
  const int q0 = rt * kRows;
  const int g = lane >> 2, t = lane & 3;
  const int n_warps = kSlices * HB;
  // this slice's ring of kStages (K, V) steps, and its threads
  T* s_kv = reinterpret_cast<T*>(smem) + slice * TL::kSliceElems;
  const int sid = threadIdx.x - slice * 32 * HB, sn = 32 * HB;

  // the block's key range (the union of its rows' unmasked keys), cut
  // into steps of kKeys; slice s takes steps s, s + 4, s + 8, ...
  const int q_last = min(Sq, q0 + kRows) - 1;
  const int hi = causal ? min(Sk, q_last + 1) : Sk;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int n_steps = hi > lo ? (hi - lo + TL::kKeys - 1) / TL::kKeys : 0;
  const int n_mine = n_steps > slice
                         ? (n_steps - slice + kSlices - 1) / kSlices : 0;
  const int row_elems = KV * dh;                 // elements per key
  const T* kbase = k + size_t(b) * Sk * row_elems + size_t(kvh) * dh;
  const T* vbase = v + size_t(b) * Sk * row_elems + size_t(kvh) * dh;
  auto key0 = [&](int j) { return lo + (slice + j * kSlices) * TL::kKeys; };
  auto fetch = [&](int j) {
    T* dst = s_kv + (j % kStages) * 2 * TL::kStep;
    load_step<T, DHP>(dst, kbase, key0(j), hi, row_elems, dh, cw_shift, sid,
                      sn);
    load_step<T, DHP>(dst + TL::kStep, vbase, key0(j), hi, row_elems, dh,
                      cw_shift, sid, sn);
  };
  // Q's fragments and a touch of this block's output rows go out first,
  // so their address translation and latency overlap the first copies
  typename M::QFrag qf;
  M::load_q(qf, q + (size_t(b) * Sq * H + h) * dh, q0, Sq, H * dh, dh, g, t);
  T* orow0 = out + (size_t(b) * Sq + min(q0 + lane % kRows, Sq - 1)) * H * dh +
             size_t(h) * dh;
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(orow0));
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_mine) fetch(j);
    cp_async_commit();
  }
  const int i0 = q0 + g, i1 = q0 + g + 8;        // this thread's rows
  const float c = scale * kLog2e;                // scores in log2 units
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float acc[DHP / 8][4];
#pragma unroll
  for (int dn = 0; dn < DHP / 8; ++dn)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[dn][r] = 0.0f;

  for (int j = 0; j < n_mine; ++j) {
    cp_async_wait<kStages - 2>();                // my copies of step j
    bar_sync(1 + slice, sn);                     // ... and the slice's
    if (j + kStages - 1 < n_mine) fetch(j + kStages - 1);
    cp_async_commit();

    const T* kt = s_kv + (j % kStages) * 2 * TL::kStep;
    const int kw = key0(j);
    float p[kNB][4];
    M::scores(p, qf, kt, g, t);

    // a step whose every key is unmasked for all 16 rows skips the mask
    const bool full = kw + TL::kKeys <= Sk &&
                      (!causal || kw + TL::kKeys - 1 <= q0) &&
                      (window <= 0 || kw > q0 + kRows - 1 - window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = r < 2 ? i0 : i1;
        const int key = kw + nb * 8 + 2 * t + (r & 1);
        const bool keep = full || (key < Sk && (!causal || key <= i) &&
                                   (window <= 0 || key > i - window));
        p[nb][r] = keep ? p[nb][r] * c : kNegInf;
        mx[r >> 1] = fmaxf(mx[r >> 1], p[nb][r]);
      }
    float corr[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      const float m_new = fmaxf(m[hr], mx[hr]);
      corr[hr] = exp2f(m[hr] - m_new);
      m[hr] = m_new;
      l[hr] *= corr[hr];
    }
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        p[nb][r] = exp2f(p[nb][r] - m[r >> 1]);
        l[r >> 1] += p[nb][r];                   // this thread's columns
      }
#pragma unroll
    for (int dn = 0; dn < DHP / 8; ++dn)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[dn][r] *= corr[r >> 1];
    M::pv(acc, p, kt + TL::kStep, g, t);
  }
  cp_async_wait<0>();

  // merge the slices' (m, l, acc) of each head through shared memory
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
  }
  __syncthreads();                               // steps no longer read
  float* s_m = reinterpret_cast<float*>(smem);   // [warp][kRows]
  float* s_l = s_m + n_warps * kRows;            // [warp][kRows]
  float* s_acc = s_l + n_warps * kRows;          // [warp][kRows][DHP+1]
  constexpr int kAccStride = DHP + 1;
  if (t == 0) {
    s_m[warp * kRows + g] = m[0];
    s_m[warp * kRows + g + 8] = m[1];
    s_l[warp * kRows + g] = l[0];
    s_l[warp * kRows + g + 8] = l[1];
  }
  float* wacc = s_acc + warp * kRows * kAccStride;
#pragma unroll
  for (int dn = 0; dn < DHP / 8; ++dn)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      wacc[(g + (r >> 1) * 8) * kAccStride + dn * 8 + 2 * t + (r & 1)] =
          acc[dn][r];
  __syncthreads();

  // each (head, row)'s weight of slice s: 2^(m_s - max m) / sum; a row
  // whose every key is masked takes the mean of v instead (weight 0)
  float* s_f = s_acc + n_warps * kRows * kAccStride;   // [warp][kRows]
  for (int e = threadIdx.x; e < HB * kRows; e += blockDim.x) {
    const int hb = e / kRows, r = e % kRows, i = q0 + r;
    const int row_lo = window > 0 ? max(0, i - window + 1) : 0;
    const int row_hi = causal ? min(Sk, i + 1) : Sk;
    float mm = kNegInf, sum = 0.0f;
#pragma unroll
    for (int s = 0; s < kSlices; ++s)
      mm = fmaxf(mm, s_m[(s * HB + hb) * kRows + r]);
#pragma unroll
    for (int s = 0; s < kSlices; ++s) {
      const int w = s * HB + hb;
      s_f[w * kRows + r] = exp2f(s_m[w * kRows + r] - mm);
      sum += s_f[w * kRows + r] * s_l[w * kRows + r];
    }
    const float inv = row_lo < row_hi ? 1.0f / fmaxf(sum, 1e-30f) : 0.0f;
#pragma unroll
    for (int s = 0; s < kSlices; ++s) s_f[(s * HB + hb) * kRows + r] *= inv;
    // the row's log-sum-exp of scale * q.k for the backward: +inf where
    // every key is masked (its P is 0 there)
    if (lse != nullptr && i < Sq)
      lse[(size_t(b) * H + h - warp % HB + hb) * Sq + i] =
          row_lo < row_hi ? (mm + log2f(fmaxf(sum, 1e-30f))) * kLn2
                          : __int_as_float(0x7f800000);
  }
  __syncthreads();

  for (int e = threadIdx.x; e < HB * kRows * DHP; e += blockDim.x) {
    const int hb = e / (kRows * DHP);
    const int r = (e / DHP) % kRows, d = e % DHP;
    const int i = q0 + r;
    if (i >= Sq || d >= dh) continue;
    const int hh = h - warp % HB + hb;           // the head of this output
    float o = 0.0f;
#pragma unroll
    for (int s = 0; s < kSlices; ++s) {
      const int w = s * HB + hb;
      o += s_f[w * kRows + r] * s_acc[(w * kRows + r) * kAccStride + d];
    }
    const int row_lo = window > 0 ? max(0, i - window + 1) : 0;
    const int row_hi = causal ? min(Sk, i + 1) : Sk;
    if (row_lo >= row_hi) {              // every key masked: mean of v
      for (int j = 0; j < Sk; ++j)
        o += to_float(vbase[size_t(j) * row_elems + d]);
      o /= static_cast<float>(Sk);
    }
    store(out + (size_t(b) * Sq + i) * H * dh + size_t(hh) * dh + d, o);
  }
}

template <typename T, int DHP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int H, int KV, int Sq, int Sk, int dh,
                   float scale, int causal, int window, int cw_shift,
                   cudaStream_t stream) {
  constexpr int smem = Tile<T, DHP>::kSmem;
  static bool ready = false;            // the opt-in above 48 KB, once
  if (!ready && smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, DHP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  ready = true;
  const int HB = (H / KV) % 2 == 0 ? 2 : 1;      // heads sharing K / V
  const long long blocks =
      (long long)((Sq + kRows - 1) / kRows) * B * (H / HB);
  flash_attention_kernel<T, DHP><<<static_cast<unsigned>(blocks),
                                   32 * kSlices * HB, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, B, H, KV, Sq, Sk,
      dh, scale, causal, window, cw_shift, HB);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     float* lse, int B, int H, int KV, int Sq, int Sk, int dh,
                     float scale, int causal, int window, int cw_shift,
                     cudaStream_t s) {
  if (dh <= 16) return launch<T, 16>(q, k, v, out, lse, B, H, KV, Sq, Sk, dh, scale, causal, window, cw_shift, s);
  if (dh <= 32) return launch<T, 32>(q, k, v, out, lse, B, H, KV, Sq, Sk, dh, scale, causal, window, cw_shift, s);
  if (dh <= 64) return launch<T, 64>(q, k, v, out, lse, B, H, KV, Sq, Sk, dh, scale, causal, window, cw_shift, s);
  if (dh <= 128) return launch<T, 128>(q, k, v, out, lse, B, H, KV, Sq, Sk, dh, scale, causal, window, cw_shift, s);
  return cudaErrorInvalidValue;
}

// ---- backward ---------------------------------------------------------------
//
// dQ, dK and dV of the forward above from q, k, v, out, dout and the
// forward's per-row log-sum-exp. Two branches, chosen by the entry point:
// the wgmma branch for bf16 at dh 64 or 128 with 16-byte aligned operands
// (the training path's case), the mma.sync kernels for the rest (float32,
// other dh, misaligned operands).
//
// What bounds it on this card. A kept (query row, key) pair costs 10 dh
// operations: S = Q K^T, dP = dout V^T, dV += P^T dout, dK += dS^T Q and
// dQ += dS K, 2 dh each. At glm4-9b's training shape (B 4, S 1,024, H 32,
// KV 2, dh 128, causal) that is 8.6e10 operations, 87 us at the bf16
// tensor-core rate (989 TFLOP/s), against 43 us for its bytes (q, k, v,
// out and dout read, dq, dk and dv written once): the tensor cores bound
// it, and only wgmma reaches their full rate.
//
// The wgmma branch, three launches on one stream:
//  1. flash_bwd_prep_kernel: D = sum_d dout * out and lse * log2(e) per
//     row, 64 rows of a (b, head) in 512 contiguous bytes for the main
//     kernel's bulk copy; it zeroes the float32 dQ accumulator;
//  2. flash_bwd_wgmma_kernel, as the points below say;
//  3. flash_bwd_finish_kernel: dq from the accumulator, dk and dv from the
//     partials, in bf16.
// Its design:
//  * Parallel over query heads. A block owns 64 keys of one (b, KV head)
//    and HB = 2 query heads of its group (1 where the group is odd), one
//    warpgroup a head, side by side: no warpgroup walks more than its own
//    head's row steps of 64 (16 at glm4's shape, where the mma.sync
//    kernel's heaviest block walked 512 for the 16 heads in series), and
//    glm4's shape has 1,024 blocks.
//  * The grid walks (b, KV head, head pair) units in chunks of about one
//    wave, each chunk's key blocks heaviest first (under a causal mask the
//    first key block sees every row): the blocks in flight share a few
//    heads' Q, dout and dQ tiles in L2 and each chunk ends on light ones.
//  * The group's sum in float32, in a fixed order: a block's warpgroups
//    add their dK and dV through shared memory (warpgroup 0 + 1) into one
//    float32 partial for its head pair, and the finish pass sums the G /
//    HB partials in order 0, 1, ...: two launches give dk and dv bit for
//    bit. The partials cost 2 x (G / HB) x B x Sk x KV x dh x 4 bytes,
//    written once and read once (67 MB at glm4's shape).
//  * S and dP once per kept pair: dQ = dS K comes from the dS that feeds
//    dK, a 64-column chunk at a time, staged in shared memory as float32
//    and added to the float32 accumulator in device memory by one TMA
//    bulk reduction (cp.reduce.async.bulk .add.f32), not by per-thread
//    atomics. The key blocks' reductions land in any order, so dq may
//    differ from run to run in its last bits (within the tests' bf16
//    tolerance).
//  * wgmma (m64n64k16, bf16 operands, float32 sums) for every product,
//    on 64-row warpgroup tiles: S^T = K Q^T and dP^T = V dout^T with both
//    operands in shared memory; dV += P^T dout and dK += dS^T Q with P^T
//    and dS^T as the register A operand (the S^T accumulator's layout is
//    mma.sync's A fragment's), dout and Q read MN-major from the tiles
//    that fed S^T; dQ += dS K with dS^T written to shared memory as dS's
//    MN-major A operand and K read MN-major. P and dS round to bf16 as the
//    A operand, where the mma.sync kernels round them.
//  * Asynchronous copies: K and V arrive once by TMA; each warpgroup's Q
//    and dout steps and its rows' lse2 and D (one 512-byte bulk copy a
//    step, not a load per element) arrive by TMA into a ring of two
//    stages with an mbarrier each, step j + 1 issued by the warpgroup's
//    thread 0 as step j starts. Tiles are 64 rows of 128 bytes in TMA's
//    128-byte swizzle, which the wgmma descriptors read as they lie. No
//    block-wide barrier in the loop: each warpgroup syncs its own 128
//    threads (named barriers) twice a step (its stage and dS^T tile are
//    free; dS^T is written) and twice a dQ chunk (the staging tile is
//    free; it is written).
//  * Kept from the mma.sync kernels: D as a row pass, dV's share from
//    fully masked rows (added in the finish pass), ragged Sq and Sk (TMA
//    reads rows past the end as zero and the mask drops them), the scale
//    on dK and dQ.
//
// The mma.sync kernels (float32 as three TF32 passes, dh up to 128 in
// templates of 16 to 128, any alignment), three launches with float32
// sums and no atomics (every output element is written by one thread,
// in a fixed order):
//  1. D = sum_d dout * out per (b, query row, head), a warp a row;
//  2. dK, dV: a block of kBwdWarps warps owns kBwdRows keys of one
//     (b, KV head), a warp 16 of them, K and V staged once in shared
//     memory. It walks every query head of the KV head's group and every
//     step of the query rows its keys can see (causal: rows >= its first
//     key; window: rows < its last key + window), Q and dout steps
//     double-buffered by cp.async. Per step a warp recomputes S^T = K Q^T
//     and dP^T = V dout^T on the tensor cores (the forward's Mma with the
//     A operand from shared memory), P^T = exp(scale S^T - lse) and
//     dS^T = P^T (dP^T - D), then dV += P^T dout and dK += dS^T Q, the
//     accumulators as the A operand of the forward's P.V (P and dS rounded
//     to bf16 there for bf16 operands, three TF32 passes for float32);
//  3. dQ: a block owns kBwdRows query rows of one head, a warp 16, Q and
//     dout staged once; it walks its rows' key range in steps (K and V
//     double-buffered): S = Q K^T, dP = dout V^T, dS as above, dQ += dS K.
//     (S and dP twice a kept pair: these kernels serve small and float32
//     shapes, off the bf16 training path.)
// dK and dQ are scaled by 1/sqrt(dh) when they are stored. A query row
// whose every key is masked (a window with i >= Sk + window - 1) took
// the mean of v forward: it gives dQ = 0, nothing to dK, and
// round(1/Sk) * dout to every key's dV, as the plain version's autograd
// does. Ragged Sq, Sk and dh are masked or zero-filled as in the forward.

constexpr int kBwdWarps = 4;
constexpr int kBwdRows = 16 * kBwdWarps;     // keys (dK, dV) or rows (dQ)
constexpr int kBwdThreads = 32 * kBwdWarps;

template <typename T, int DHP>
struct Bwd {
  using TL = Tile<T, DHP>;
  // two staged tiles of kBwdRows rows and a double-buffered pair of steps
  static constexpr int kSmem =
      (2 * kBwdRows * TL::kStride + 2 * 2 * TL::kStep) * sizeof(T);
};

__device__ __forceinline__ float round_as(float x, float) { return x; }
__device__ __forceinline__ float round_as(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__global__ void flash_bwd_dot_kernel(const T* __restrict__ out,
                                     const T* __restrict__ dout,
                                     float* __restrict__ D, int rows, int H,
                                     int Sq, int dh) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* o = out + size_t(row) * dh;
  const T* g = dout + size_t(row) * dh;
  float s = 0.0f;
  for (int d = lane; d < dh; d += 32) s += to_float(o[d]) * to_float(g[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {                               // row = (b * Sq + i) * H + h
    const int h = row % H, bi = row / H;
    D[(size_t(bi / Sq) * H + h) * Sq + bi % Sq] = s;
  }
}

template <typename T, int DHP>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ D, T* __restrict__ dk,
                      T* __restrict__ dv, int B, int H, int KV, int Sq,
                      int Sk, int dh, float scale, int causal, int window,
                      int cw_shift) {
  using M = Mma<T, DHP>;
  using TL = Tile<T, DHP>;
  constexpr int kNB = M::kNB, kS = TL::kStride, kStepRows = TL::kKeys;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_k = reinterpret_cast<T*>(smem);           // the block's keys
  T* s_v = s_k + kBwdRows * kS;
  T* s_ring = s_v + kBwdRows * kS;               // 2 x (Q step, dout step)

  // key blocks outermost: under a causal mask the first see the most rows
  const int kb = blockIdx.x / (B * KV), bkv = blockIdx.x % (B * KV);
  const int b = bkv / KV, kvh = bkv % KV, G = H / KV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = kb * kBwdRows;
  const int kv_elems = KV * dh, q_elems = H * dh;
  const size_t kv_off = size_t(b) * Sk * kv_elems + size_t(kvh) * dh;
  load_rows<T, DHP, kBwdRows>(s_k, k + kv_off, k0, Sk, kv_elems, dh, cw_shift,
                              tid, kBwdThreads);
  load_rows<T, DHP, kBwdRows>(s_v, v + kv_off, k0, Sk, kv_elems, dh, cw_shift,
                              tid, kBwdThreads);
  cp_async_commit();

  // the query rows these keys can see, in steps, for each head of the group
  const int k_last = min(Sk, k0 + kBwdRows) - 1;
  const int i_lo = causal ? k0 : 0;
  const int i_hi = window > 0 ? min(Sq, k_last + window) : Sq;
  const int n_q = i_hi > i_lo ? (i_hi - i_lo + kStepRows - 1) / kStepRows : 0;
  const int n = G * n_q;
  auto fetch = [&](int j) {
    const int hh = kvh * G + j / n_q;
    const size_t off = size_t(b) * Sq * q_elems + size_t(hh) * dh;
    T* dst = s_ring + (j & 1) * 2 * TL::kStep;
    const int i0 = i_lo + (j % n_q) * kStepRows;
    load_rows<T, DHP, kStepRows>(dst, q + off, i0, Sq, q_elems, dh, cw_shift,
                                 tid, kBwdThreads);
    load_rows<T, DHP, kStepRows>(dst + TL::kStep, dout + off, i0, Sq,
                                 q_elems, dh, cw_shift, tid, kBwdThreads);
  };
  if (n > 0) fetch(0);
  cp_async_commit();

  float acc_k[DHP / 8][4], acc_v[DHP / 8][4];
#pragma unroll
  for (int dn = 0; dn < DHP / 8; ++dn)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc_k[dn][r] = acc_v[dn][r] = 0.0f;
  const float c = scale * kLog2e;
  const int j0 = k0 + warp * 16 + g, j1 = j0 + 8;   // this thread's keys
  const T* a_k = s_k + warp * 16 * kS;
  const T* a_v = s_v + warp * 16 * kS;

  for (int j = 0; j < n; ++j) {
    if (j + 1 < n) fetch(j + 1);
    cp_async_commit();
    cp_async_wait<1>();                          // step j (and K, V) landed
    __syncthreads();
    const T* qt = s_ring + (j & 1) * 2 * TL::kStep;
    const T* dot = qt + TL::kStep;
    const int hh = kvh * G + j / n_q;
    const int i0 = i_lo + (j % n_q) * kStepRows;
    const float* lse_h = lse + (size_t(b) * H + hh) * Sq;
    const float* d_h = D + (size_t(b) * H + hh) * Sq;
    float p[kNB][4], dp[kNB][4];
    M::scores_s(p, a_k, qt, g, t);               // S^T: keys x rows
    M::scores_s(dp, a_v, dot, g, t);             // dP^T
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + nb * 8 + 2 * t + (r & 1);
        const int key = r < 2 ? j0 : j1;
        const bool keep = i < Sq && key < Sk && (!causal || key <= i) &&
                          (window <= 0 || key > i - window);
        float pr = 0.0f, ds = 0.0f;
        if (keep) {
          pr = exp2f(p[nb][r] * c - lse_h[i] * kLog2e);
          ds = pr * (dp[nb][r] - d_h[i]);
        }
        p[nb][r] = pr;
        dp[nb][r] = ds;
      }
    M::pv(acc_v, p, dot, g, t);                  // dV += P^T dout
    M::pv(acc_k, dp, qt, g, t);                  // dK += dS^T Q
    __syncthreads();                             // the step may be refilled
  }
  cp_async_wait<0>();

  // rows whose every key is masked give round(1/Sk) * dout to every dV
  const int i_dead = window > 0 ? Sk + window - 1 : Sq;
  const float p0 = round_as(1.0f / static_cast<float>(Sk), T());
#pragma unroll
  for (int dn = 0; dn < DHP / 8; ++dn)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int key = r < 2 ? j0 : j1;
      const int d = dn * 8 + 2 * t + (r & 1);
      if (key >= Sk || d >= dh) continue;
      float vv = acc_v[dn][r];
      if (i_dead < Sq) {
        float sum = 0.0f;
        for (int hh = kvh * G; hh < kvh * G + G; ++hh)
          for (int i = i_dead; i < Sq; ++i)
            sum += to_float(dout[(size_t(b) * Sq + i) * q_elems +
                                 size_t(hh) * dh + d]);
        vv += p0 * sum;
      }
      const size_t o = (size_t(b) * Sk + key) * kv_elems + size_t(kvh) * dh + d;
      store(dk + o, acc_k[dn][r] * scale);
      store(dv + o, vv);
    }
}

template <typename T, int DHP>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ D, T* __restrict__ dq, int B,
                    int H, int KV, int Sq, int Sk, int dh, float scale,
                    int causal, int window, int cw_shift) {
  using M = Mma<T, DHP>;
  using TL = Tile<T, DHP>;
  constexpr int kNB = M::kNB, kS = TL::kStride, kStepKeys = TL::kKeys;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_q = reinterpret_cast<T*>(smem);           // the block's rows
  T* s_do = s_q + kBwdRows * kS;
  T* s_ring = s_do + kBwdRows * kS;              // 2 x (K step, V step)

  // heaviest first: under a causal mask the last row blocks see most keys
  const int n_qb = (Sq + kBwdRows - 1) / kBwdRows;
  const int bh = blockIdx.x % (B * H);
  int qb = blockIdx.x / (B * H);
  if (causal) qb = n_qb - 1 - qb;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qb * kBwdRows;
  const int kv_elems = KV * dh, q_elems = H * dh;
  const size_t q_off = size_t(b) * Sq * q_elems + size_t(h) * dh;
  const size_t kv_off = size_t(b) * Sk * kv_elems + size_t(kvh) * dh;
  load_rows<T, DHP, kBwdRows>(s_q, q + q_off, q0, Sq, q_elems, dh, cw_shift,
                              tid, kBwdThreads);
  load_rows<T, DHP, kBwdRows>(s_do, dout + q_off, q0, Sq, q_elems, dh,
                              cw_shift, tid, kBwdThreads);
  cp_async_commit();

  const int q_last = min(Sq, q0 + kBwdRows) - 1;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(Sk, q_last + 1) : Sk;
  const int n = hi > lo ? (hi - lo + kStepKeys - 1) / kStepKeys : 0;
  auto fetch = [&](int j) {
    T* dst = s_ring + (j & 1) * 2 * TL::kStep;
    const int key0 = lo + j * kStepKeys;
    load_rows<T, DHP, kStepKeys>(dst, k + kv_off, key0, Sk, kv_elems, dh,
                                 cw_shift, tid, kBwdThreads);
    load_rows<T, DHP, kStepKeys>(dst + TL::kStep, v + kv_off, key0, Sk,
                                 kv_elems, dh, cw_shift, tid, kBwdThreads);
  };
  if (n > 0) fetch(0);
  cp_async_commit();

  float acc[DHP / 8][4];
#pragma unroll
  for (int dn = 0; dn < DHP / 8; ++dn)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[dn][r] = 0.0f;
  const float c = scale * kLog2e;
  const int i0 = q0 + warp * 16 + g, i1 = i0 + 8;   // this thread's rows
  const float* lse_h = lse + (size_t(b) * H + h) * Sq;
  const float* d_h = D + (size_t(b) * H + h) * Sq;
  float l2[2], dd[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int i = hr ? i1 : i0;
    l2[hr] = i < Sq ? lse_h[i] * kLog2e : 0.0f;
    dd[hr] = i < Sq ? d_h[i] : 0.0f;
  }
  const T* a_q = s_q + warp * 16 * kS;
  const T* a_do = s_do + warp * 16 * kS;

  for (int j = 0; j < n; ++j) {
    if (j + 1 < n) fetch(j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* kt = s_ring + (j & 1) * 2 * TL::kStep;
    const T* vt = kt + TL::kStep;
    const int kw = lo + j * kStepKeys;
    float p[kNB][4], dp[kNB][4];
    M::scores_s(p, a_q, kt, g, t);               // S
    M::scores_s(dp, a_do, vt, g, t);             // dP
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = r < 2 ? i0 : i1;
        const int key = kw + nb * 8 + 2 * t + (r & 1);
        const bool keep = i < Sq && key < Sk && (!causal || key <= i) &&
                          (window <= 0 || key > i - window);
        dp[nb][r] = keep ? exp2f(p[nb][r] * c - l2[r >> 1]) *
                               (dp[nb][r] - dd[r >> 1])
                         : 0.0f;
      }
    M::pv(acc, dp, kt, g, t);                    // dQ += dS K
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int dn = 0; dn < DHP / 8; ++dn)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = r < 2 ? i0 : i1;
      const int d = dn * 8 + 2 * t + (r & 1);
      if (i < Sq && d < dh)
        store(dq + (size_t(b) * Sq + i) * q_elems + size_t(h) * dh + d,
              acc[dn][r] * scale);
    }
}

// ---- the backward's wgmma branch (bf16, dh 64 or 128) -----------------

constexpr int kWgTile = 64 * 64 * 2;         // bytes: 64 rows of 64 bf16
constexpr int kWgStages = 2;                 // Q / dout steps in a ring

constexpr int kWgAcc = 64 * 64 * 4;          // bytes: a float32 dQ chunk

// Shared memory of a block, byte offsets, every tile 1024-aligned: the
// block's K and V (NC tiles of 64 columns each), then per warpgroup a
// ring of kWgStages steps (Q, dout, then lse * log2(e) and D of the
// step's 64 rows, 512 bytes in a 1024 slot), its dS^T tile and the
// float32 dQ chunk the TMA unit adds to device memory; the mbarriers
// last.
template <int NC>
struct WgSmem {
  static constexpr int kK = 0;
  static constexpr int kV = NC * kWgTile;
  static constexpr int kHeads = 2 * NC * kWgTile;
  static constexpr int kStage = 2 * NC * kWgTile + 1024;
  static constexpr int kLd = 2 * NC * kWgTile;          // within a stage
  static constexpr int kDs = kWgStages * kStage;        // within a head
  static constexpr int kAcc = kDs + kWgTile;
  static constexpr int kHead = kAcc + kWgAcc;
  static constexpr int kBars = kHeads + 2 * kHead;
  static constexpr int kBytes = kBars + 64 + 1024;      // + 1024 to align
};

// D = sum_d dout * out of every (b, head, row), a warp a row, into the
// staged layout [b][head][row block][lse2 | D][64] with lse2 = lse *
// log2(e); rows past Sq get lse2 = +inf and D = 0 (their P is 0). The
// warp also zeroes dh floats of the dQ accumulator (as many as a row).
template <int NC>
__global__ void flash_bwd_prep_kernel(const __nv_bfloat16* __restrict__ out,
                                      const __nv_bfloat16* __restrict__ dout,
                                      const float* __restrict__ lse,
                                      float* __restrict__ ld,
                                      float* __restrict__ dq_acc, int B,
                                      int H, int Sq, int n_rb) {
  constexpr int dh = NC * 64;
  const int slot = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int rows = n_rb * 64;
  if (slot >= B * H * rows) return;
  const int bh = slot / rows, i = slot - bh * rows;
  const int b = bh / H, h = bh - b * H;
  float d = 0.0f, l2 = __int_as_float(0x7f800000);
  // NC float4 of zeros and NC bf16 pairs of each operand a lane
#pragma unroll
  for (int x = 0; x < NC; ++x)
    reinterpret_cast<float4*>(dq_acc + size_t(slot) * dh)[lane + 32 * x] =
        make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < Sq) {
    const size_t row = (size_t(b) * Sq + i) * H + h;
    const __nv_bfloat162* o =
        reinterpret_cast<const __nv_bfloat162*>(out + row * dh);
    const __nv_bfloat162* g =
        reinterpret_cast<const __nv_bfloat162*>(dout + row * dh);
#pragma unroll
    for (int x = 0; x < NC; ++x) {
      const float2 a = __bfloat1622float2(o[lane + 32 * x]);
      const float2 c = __bfloat1622float2(g[lane + 32 * x]);
      d += a.x * c.x + a.y * c.y;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      d += __shfl_xor_sync(0xffffffffu, d, off);
    l2 = lse[size_t(bh) * Sq + i] * kLog2e;
  }
  if (lane == 0) {
    float* blk = ld + (size_t(bh) * n_rb + i / 64) * 128;
    blk[i % 64] = l2;
    blk[64 + i % 64] = d;
  }
}

// One block: 64 keys of one (b, KV head) and HB query heads of its
// group (HB = 2 when the group is even), one warpgroup a head, each
// walking its head's row steps of 64. A step: S^T = K Q^T and dP^T =
// V dout^T (wgmma, both operands in shared memory), P^T = exp2(scale
// log2(e) S^T - lse2) and dS^T = P^T (dP^T - D) in registers, then
// dV += P^T dout and dK += dS^T Q (wgmma, P^T and dS^T as the register
// A operand, rounded to bf16) and dQ = dS K (dS^T through shared
// memory), one 64-column chunk at a time staged in shared memory and
// added to the float32 dQ accumulator by one TMA bulk reduction. The
// warpgroups' dK and dV meet in shared memory (warpgroup 0 + 1) and go
// out as the block's float32 partial, one per (head slice, b, KV head).
template <int NC>
__global__ void __launch_bounds__(256, 1)
flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ ld,
                       float* __restrict__ dq_acc, float* __restrict__ part,
                       int B, int H, int KV, int Sq, int Sk, float scale,
                       int causal, int window, int HB, int chunk) {
  using namespace hopper;
  using L = WgSmem<NC>;
  constexpr int dh = NC * 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int G = H / KV, n_hs = G / HB;
  // The grid walks (b, KV head, head slice) units in chunks of `chunk`,
  // and each chunk's key blocks from the first (under a causal mask the
  // heaviest) to the last: the blocks in flight share a few heads' Q,
  // dout and dQ tiles in L2, and each chunk ends on its lightest blocks.
  const int n_kb = (Sk + 63) / 64;
  const int units = B * KV * n_hs;
  const int first = (blockIdx.x / (chunk * n_kb)) * chunk;
  const int width = min(chunk, units - first);
  const int within = blockIdx.x - first * n_kb;
  const int kb = within / width;
  int rem = first + within % width;
  const int hs = rem % n_hs;
  rem /= n_hs;
  const int kvh = rem % KV, b = rem / KV;
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int w = t >> 5, lane = t & 31, g = lane >> 2, c = lane & 3;
  const int h = kvh * G + hs * HB + wg;
  const int k0 = kb * 64;
  const int n_rb = (Sq + 63) / 64;

  unsigned char* s_k = smem + L::kK;
  unsigned char* s_v = smem + L::kV;
  unsigned char* mine = smem + L::kHeads + wg * L::kHead;
  unsigned char* s_ds = mine + L::kDs;
  float* s_acc = reinterpret_cast<float*>(mine + L::kAcc);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = bars + 1 + 2 * wg;            // this head's ring

  // the query rows these keys can see, in steps of 64
  const int k_last = min(Sk, k0 + 64) - 1;
  const int i_lo = causal ? k0 : 0;
  const int i_hi = window > 0 ? min(Sq, k_last + window) : Sq;
  const int n = i_hi > i_lo ? (i_hi - i_lo + 63) / 64 : 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + 2 * HB; ++i) mbar_init(bars + i, 1);
    mbar_init_fence();
  }
  __syncthreads();
  auto fetch = [&](int j) {                      // thread 0 of the head
    uint64_t* bar = full + (j & 1);
    unsigned char* st = mine + (j & 1) * L::kStage;
    const int i0 = i_lo + j * 64;
    mbar_expect_tx(bar, 2 * NC * kWgTile + 512);
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      tma_load_4d(st + cc * kWgTile, &tq, bar, cc * 64, h, i0, b);
      tma_load_4d(st + (NC + cc) * kWgTile, &tdo, bar, cc * 64, h, i0, b);
    }
    bulk_load(st + L::kLd, ld + ((size_t(b) * H + h) * n_rb + i0 / 64) * 128,
              512, bar);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(bars, 2 * NC * kWgTile);
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      tma_load_4d(s_k + cc * kWgTile, &tk, bars, cc * 64, kvh, k0, b);
      tma_load_4d(s_v + cc * kWgTile, &tv, bars, cc * 64, kvh, k0, b);
    }
  }
  if (t == 0 && n > 0) fetch(0);

  float dk[NC][32], dv[NC][32];
#pragma unroll
  for (int cc = 0; cc < NC; ++cc)
#pragma unroll
    for (int r = 0; r < 32; ++r) dk[cc][r] = dv[cc][r] = 0.0f;
  const float cs = scale * kLog2e;
  const int kl = 16 * w + g;            // this thread's keys: kl, kl + 8
  mbar_wait(bars, 0);

  for (int j = 0; j < n; ++j) {
    // every warp of the head is done with step j - 1: its stage and the
    // dS^T tile may be written again
    named_barrier(1 + wg, 128);
    if (t == 0 && j + 1 < n) fetch(j + 1);
    unsigned char* st = mine + (j & 1) * L::kStage;
    mbar_wait(full + (j & 1), (j >> 1) & 1);
    const unsigned char* s_q = st;
    const unsigned char* s_do = st + NC * kWgTile;
    const float* s_ld = reinterpret_cast<const float*>(st + L::kLd);
    const int i0 = i_lo + j * 64;

    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<0, 0>(sc, desc128(s_k + cc * kWgTile + kk * 32, 0, 1024),
                       desc128(s_q + cc * kWgTile + kk * 32, 0, 1024),
                       cc | kk);
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<0, 0>(dp, desc128(s_v + cc * kWgTile + kk * 32, 0, 1024),
                       desc128(s_do + cc * kWgTile + kk * 32, 0, 1024),
                       cc | kk);
    wgmma_commit();
    wgmma_wait<0>();

    // element 4 nb + r: key kl + 8 (r >> 1), row i0 + 8 nb + 2c + (r & 1)
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const float2 l2 = *reinterpret_cast<const float2*>(s_ld + 8 * nb + 2 * c);
      const float2 dd =
          *reinterpret_cast<const float2*>(s_ld + 64 + 8 * nb + 2 * c);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int key = k0 + kl + 8 * (r >> 1);
        const int i = i0 + 8 * nb + 2 * c + (r & 1);
        const bool keep = i < Sq && key < Sk && (!causal || key <= i) &&
                          (window <= 0 || key > i - window);
        float pr = 0.0f, ds = 0.0f;
        if (keep) {
          pr = ex2(sc[4 * nb + r] * cs - (r & 1 ? l2.y : l2.x));
          ds = pr * (dp[4 * nb + r] - (r & 1 ? dd.y : dd.x));
        }
        sc[4 * nb + r] = pr;
        dp[4 * nb + r] = ds;
      }
    }
    // P^T and dS^T as A fragments, k16 step kk = rows 16 kk .. 16 kk + 15
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pa[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
        da[kk][e] = pack_bf16(dp[8 * kk + 2 * e], dp[8 * kk + 2 * e + 1]);
      }
    // dS^T to shared memory as [key][row]: dS's MN-major A operand
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kl + 8 * (e & 1), row = 16 * kk + 8 * (e >> 1) + 2 * c;
        *reinterpret_cast<uint32_t*>(s_ds +
                                     swizzle128(key * 128 + row * 2)) =
            da[kk][e];
      }
    fence_proxy_async();
    named_barrier(1 + wg, 128);

    wgmma_fence();
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<1>(dv[cc], pa[kk],
                    desc128(s_do + cc * kWgTile + kk * 2048, kWgTile, 1024),
                    1);
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<1>(dk[cc], da[kk],
                    desc128(s_q + cc * kWgTile + kk * 2048, kWgTile, 1024),
                    1);
    wgmma_commit();
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      float dq[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<1, 1>(dq, desc128(s_ds + kk * 2048, kWgTile, 1024),
                       desc128(s_k + cc * kWgTile + kk * 2048, kWgTile, 1024),
                       kk);
      wgmma_commit();
      wgmma_wait<0>();
      // the chunk to shared memory as 64 rows of 64 floats, the 16-byte
      // column group q of row r at q ^ (r % 16) (the accumulator's tile
      // layout: two rows' stores share no bank more than a warp's 256
      // bytes need), once the last reduction has read it
      if (t == 0) bulk_wait<1>();
      named_barrier(1 + wg, 128);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = kl + 8 * hr, col = 8 * nb + 2 * c;
          *reinterpret_cast<float2*>(
              s_acc + row * 64 + (((col >> 2) ^ (row & 15)) << 2) + (col & 3)) =
              make_float2(dq[4 * nb + 2 * hr], dq[4 * nb + 2 * hr + 1]);
        }
      fence_proxy_async();
      named_barrier(1 + wg, 128);
      if (t == 0)
        bulk_reduce_add(
            dq_acc + (((size_t(b) * H + h) * n_rb + i0 / 64) * NC + cc) * 4096,
            s_acc, kWgAcc);
    }
  }
  if (t == 0) bulk_wait<0>();

  // the heads' sum in a fixed order: warpgroup 1's dK, dV through
  // shared memory (its own area, its ring drained) into warpgroup 0's
  if (HB == 2) {
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem + L::kHeads + L::kHead);
    if (wg == 1) {
#pragma unroll
      for (int cc = 0; cc < NC; ++cc)
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          red[((2 * cc) * 32 + r) * 128 + t] = dk[cc][r];
          red[((2 * cc + 1) * 32 + r) * 128 + t] = dv[cc][r];
        }
    }
    __syncthreads();
    if (wg == 1) return;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        dk[cc][r] += red[((2 * cc) * 32 + r) * 128 + t];
        dv[cc][r] += red[((2 * cc + 1) * 32 + r) * 128 + t];
      }
  }
  // the partial: part[dK | dV][head slice][b][kvh][key][dh], float32
  const int sk_pad = ((Sk + 63) / 64) * 64;
  const size_t slab = size_t(n_hs) * B * KV * sk_pad * dh;
  float* pk = part + (((size_t(hs) * B + b) * KV + kvh) * sk_pad + k0) * dh;
#pragma unroll
  for (int cc = 0; cc < NC; ++cc)
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const size_t o = size_t(kl + 8 * hr) * dh + cc * 64 + 8 * nb + 2 * c;
        *reinterpret_cast<float2*>(pk + o) =
            make_float2(dk[cc][4 * nb + 2 * hr], dk[cc][4 * nb + 2 * hr + 1]);
        *reinterpret_cast<float2*>(pk + slab + o) =
            make_float2(dv[cc][4 * nb + 2 * hr], dv[cc][4 * nb + 2 * hr + 1]);
      }
}

// The last pass, four elements a thread: dq = bf16(scale * dQ
// accumulator) for blocks below n_dq (the accumulator in tiles of 64
// rows x 64 columns, [b][head][row block][column block], the 16-byte
// group q of row r at q ^ (r % 16)), then dk = bf16(scale * sum of the
// head slices' partials) and dv = bf16(sum + round(1/Sk) * the dout of
// rows whose every key is masked), the slices summed in order 0, 1, ...
template <int NC>
__global__ void flash_bwd_finish_kernel(
    const float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dq,
    const float* __restrict__ part, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, const __nv_bfloat16* __restrict__ dout,
    int B, int H, int KV, int Sq, int Sk, int n_hs, float scale, int window,
    int n_dq) {
  constexpr int dh = NC * 64;
  const int tid = threadIdx.x;
  if (static_cast<int>(blockIdx.x) < n_dq) {
    const int e = (blockIdx.x * blockDim.x + tid) * 4;
    if (e >= B * Sq * H * dh) return;
    const int d = e % dh, r = e / dh;            // r = (b * Sq + i) * H + h
    const int h = r % H, bi = r / H, i = bi % Sq, b = bi / Sq;
    const int row = i % 64, q = (d % 64) / 4;
    const float4 a = *reinterpret_cast<const float4*>(
        dq_acc + ((size_t(b * H + h) * ((Sq + 63) / 64) + i / 64) * NC +
                  d / 64) * 4096 + row * 64 + (q ^ (row & 15)) * 4);
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(dq + e);
    o[0] = __floats2bfloat162_rn(a.x * scale, a.y * scale);
    o[1] = __floats2bfloat162_rn(a.z * scale, a.w * scale);
    return;
  }
  const int e = ((blockIdx.x - n_dq) * blockDim.x + tid) * 4;
  if (e >= B * Sk * KV * dh) return;
  const int d = e % dh, r = e / dh;       // r = (b * Sk + key) * KV + kvh
  const int kvh = r % KV, bk = r / KV, key = bk % Sk, b = bk / Sk;
  const int sk_pad = ((Sk + 63) / 64) * 64;
  const size_t stride = size_t(B) * KV * sk_pad * dh;   // one head slice
  const size_t slab = stride * n_hs;
  const float* p = part + (size_t(b * KV + kvh) * sk_pad + key) * dh + d;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int s = 0; s < n_hs; ++s) {
    const float4 a = *reinterpret_cast<const float4*>(p + s * stride);
    const float4 v = *reinterpret_cast<const float4*>(p + slab + s * stride);
    sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
    sv.x += v.x; sv.y += v.y; sv.z += v.z; sv.w += v.w;
  }
  const int i_dead = window > 0 ? Sk + window - 1 : Sq;
  if (i_dead < Sq) {
    const float p0 = round_as(1.0f / static_cast<float>(Sk), __nv_bfloat16());
    const int G = H / KV;
    float dead[4] = {0.f, 0.f, 0.f, 0.f};
    for (int hh = kvh * G; hh < kvh * G + G; ++hh)
      for (int i = i_dead; i < Sq; ++i)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          dead[x] += __bfloat162float(
              dout[(size_t(b) * Sq + i) * H * dh + size_t(hh) * dh + d + x]);
    sv.x += p0 * dead[0]; sv.y += p0 * dead[1];
    sv.z += p0 * dead[2]; sv.w += p0 * dead[3];
  }
  __nv_bfloat162* ok = reinterpret_cast<__nv_bfloat162*>(dk + e);
  __nv_bfloat162* ov = reinterpret_cast<__nv_bfloat162*>(dv + e);
  ok[0] = __floats2bfloat162_rn(sk.x * scale, sk.y * scale);
  ok[1] = __floats2bfloat162_rn(sk.z * scale, sk.w * scale);
  ov[0] = __floats2bfloat162_rn(sv.x, sv.y);
  ov[1] = __floats2bfloat162_rn(sv.z, sv.w);
}

// cuTensorMapEncodeTiled from the driver, found once at run time (the
// library links only the runtime)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// (B, rows, heads, dh) bf16 as a 4-d map with boxes of 64 columns x 64
// rows of one head, 128-byte swizzled; rows past the end read as zero
bool row_map(CUtensorMap* m, const void* base, int B, int rows, int heads,
             int dh) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(dh), cuuint64_t(heads),
                              cuuint64_t(rows), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(dh) * 2,
                                 cuuint64_t(heads) * dh * 2,
                                 cuuint64_t(rows) * heads * dh * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The wgmma branch takes bf16 at dh 64 or 128 with 16-byte aligned
// operands (TMA's rule) and fewer than 2^31 elements of q (its rows
// padded to 64) and of k (its passes index with 32 bits); everything
// else takes the mma.sync kernels.
bool wgmma_branch(std::initializer_list<const void*> ptrs, int B, int H,
                  int KV, int Sq, int Sk, int dh, int bf16) {
  if (!bf16 || (dh != 64 && dh != 128)) return false;
  if ((long long)B * H * ((Sq + 63) / 64 * 64) * dh >= (1ll << 31) ||
      (long long)B * KV * Sk * dh >= (1ll << 31))
    return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) & 15) return false;
  return true;
}

// workspace layout of the wgmma branch, in floats, each part 64-aligned
struct WgWork {
  size_t ld, dq, part, total;
  WgWork(int B, int H, int KV, int Sq, int Sk, int dh) {
    auto up = [](size_t x) { return (x + 63) & ~size_t(63); };
    const int G = H / KV, HB = G % 2 == 0 ? 2 : 1;
    const size_t n_rb = (Sq + 63) / 64, sk_pad = ((Sk + 63) / 64) * 64;
    ld = 0;
    dq = up(size_t(B) * H * n_rb * 128);
    part = dq + up(size_t(B) * H * n_rb * 64 * dh);
    total = part + up(2 * size_t(G / HB) * B * KV * sk_pad * dh);
  }
};

template <int NC>
cudaError_t launch_bwd_wgmma(const void* q, const void* k, const void* v,
                             const void* out, const void* dout,
                             const float* lse, float* work, void* dq,
                             void* dk, void* dv, int B, int H, int KV,
                             int Sq, int Sk, float scale, int causal,
                             int window, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  constexpr int dh = NC * 64;
  constexpr int smem = WgSmem<NC>::kBytes;
  static bool ready = false;            // the opt-in above 48 KB, once
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_wgmma_kernel<NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  CUtensorMap tq, tk, tv, tdo;
  if (!row_map(&tq, q, B, Sq, H, dh) || !row_map(&tk, k, B, Sk, KV, dh) ||
      !row_map(&tv, v, B, Sk, KV, dh) || !row_map(&tdo, dout, B, Sq, H, dh))
    return cudaErrorInvalidValue;
  const WgWork ws(B, H, KV, Sq, Sk, dh);
  float* ld = work + ws.ld;
  float* dq_acc = work + ws.dq;
  float* part = work + ws.part;
  const int n_rb = (Sq + 63) / 64;
  const int slots = B * H * n_rb * 64;
  flash_bwd_prep_kernel<NC><<<(slots + 7) / 8, 256, 0, stream>>>(
      static_cast<const bf*>(out), static_cast<const bf*>(dout), lse, ld,
      dq_acc, B, H, Sq, n_rb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int G = H / KV, HB = G % 2 == 0 ? 2 : 1;
  const int n_kb = (Sk + 63) / 64;
  const long long blocks = (long long)n_kb * B * KV * (G / HB);
  // about one wave of blocks a chunk of units (one block an SM)
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return cudaGetLastError();
  const int chunk = max(1, sms / n_kb);
  flash_bwd_wgmma_kernel<NC><<<static_cast<unsigned>(blocks), 128 * HB,
                               smem, stream>>>(
      tq, tk, tv, tdo, ld, dq_acc, part, B, H, KV, Sq, Sk, scale, causal,
      window, HB, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_dq = (B * Sq * H * dh / 4 + 255) / 256;
  const int n_kv = (B * Sk * KV * dh / 4 + 255) / 256;
  flash_bwd_finish_kernel<NC><<<n_dq + n_kv, 256, 0, stream>>>(
      dq_acc, static_cast<bf*>(dq), part, static_cast<bf*>(dk),
      static_cast<bf*>(dv), static_cast<const bf*>(dout), B, H, KV, Sq, Sk,
      G / HB, scale, window, n_dq);
  return cudaGetLastError();
}

template <typename T, int DHP>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* out, const void* dout, const float* lse,
                       float* D, void* dq, void* dk, void* dv, int B, int H,
                       int KV, int Sq, int Sk, int dh, float scale,
                       int causal, int window, int cw_shift,
                       cudaStream_t stream) {
  constexpr int smem = Bwd<T, DHP>::kSmem;
  static bool ready = false;            // the opt-in above 48 KB, once
  if (!ready && smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<T, DHP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DHP>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
    if (err != cudaSuccess) return err;
  }
  ready = true;
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const T* oo = static_cast<const T*>(out);
  const T* gg = static_cast<const T*>(dout);
  const int rows = B * Sq * H;
  flash_bwd_dot_kernel<T><<<(rows + 7) / 8, 256, 0, stream>>>(oo, gg, D, rows,
                                                              H, Sq, dh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long kv_blocks =
      (long long)((Sk + kBwdRows - 1) / kBwdRows) * B * KV;
  flash_bwd_dkdv_kernel<T, DHP><<<static_cast<unsigned>(kv_blocks),
                                  kBwdThreads, smem, stream>>>(
      qq, kk, vv, gg, lse, D, static_cast<T*>(dk), static_cast<T*>(dv), B, H,
      KV, Sq, Sk, dh, scale, causal, window, cw_shift);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long q_blocks =
      (long long)((Sq + kBwdRows - 1) / kBwdRows) * B * H;
  flash_bwd_dq_kernel<T, DHP><<<static_cast<unsigned>(q_blocks), kBwdThreads,
                                smem, stream>>>(
      qq, kk, vv, gg, lse, D, static_cast<T*>(dq), B, H, KV, Sq, Sk, dh,
      scale, causal, window, cw_shift);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bwd(const void* q, const void* k, const void* v,
                         const void* out, const void* dout, const float* lse,
                         float* D, void* dq, void* dk, void* dv, int B, int H,
                         int KV, int Sq, int Sk, int dh, float scale,
                         int causal, int window, int cw_shift,
                         cudaStream_t s) {
  if (dh <= 16) return launch_bwd<T, 16>(q, k, v, out, dout, lse, D, dq, dk, dv, B, H, KV, Sq, Sk, dh, scale, causal, window, cw_shift, s);
  if (dh <= 32) return launch_bwd<T, 32>(q, k, v, out, dout, lse, D, dq, dk, dv, B, H, KV, Sq, Sk, dh, scale, causal, window, cw_shift, s);
  if (dh <= 64) return launch_bwd<T, 64>(q, k, v, out, dout, lse, D, dq, dk, dv, B, H, KV, Sq, Sk, dh, scale, causal, window, cw_shift, s);
  if (dh <= 128) return launch_bwd<T, 128>(q, k, v, out, dout, lse, D, dq, dk, dv, B, H, KV, Sq, Sk, dh, scale, causal, window, cw_shift, s);
  return cudaErrorInvalidValue;
}

// the widest copy (log2 bytes: 4 down to 1) that divides every row's start
int copy_shift(std::initializer_list<const void*> ptrs, int dh, int elem) {
  uintptr_t align = static_cast<uintptr_t>(dh * elem);
  for (const void* p : ptrs) align |= reinterpret_cast<uintptr_t>(p);
  int cw_shift = 4;
  while (cw_shift > 1 && (align & ((uintptr_t(1) << cw_shift) - 1)))
    --cw_shift;
  return cw_shift;
}

}  // namespace

extern "C" {

// q (B, Sq, H, dh), k and v (B, Sk, KV, dh), out (B, Sq, H, dh); all
// float32 (bf16 = 0) or all bfloat16 (bf16 = 1), contiguous, on the
// device of `stream`; 1 <= dh <= 128, H % KV == 0, Sk >= 1. lse: null,
// or float32 (B, H, Sq) to receive each row's log-sum-exp of the scaled
// scores (+inf for a row whose every key is masked). Returns a
// cudaError_t.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, void* lse, int B, int H, int KV, int Sq,
                           int Sk, int dh, float scale, int causal,
                           int window, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (KV <= 0 || H % KV || Sk <= 0) return cudaErrorInvalidValue;
  const int cw_shift = copy_shift({k, v}, dh, bf16 ? 2 : 4);
  float* l = static_cast<float*>(lse);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, out, l, B, H, KV, Sq, Sk, dh,
                                   scale, causal, window, cw_shift, s);
  return dispatch<float>(q, k, v, out, l, B, H, KV, Sq, Sk, dh, scale, causal,
                         window, cw_shift, s);
}

// The backward's workspace in bytes, and its branch (1: wgmma, 0: the
// mma.sync kernels) in *branch, for these operands.
long long flash_attention_backward_workspace(const void* q, const void* k,
                                             const void* v, const void* out,
                                             const void* dout, int B, int H,
                                             int KV, int Sq, int Sk, int dh,
                                             int bf16, int* branch) {
  if (KV <= 0 || H % KV || Sk <= 0) return -1;
  const bool wg =
      wgmma_branch({q, k, v, out, dout}, B, H, KV, Sq, Sk, dh, bf16);
  *branch = wg ? 1 : 0;
  if (wg) return static_cast<long long>(WgWork(B, H, KV, Sq, Sk, dh).total) * 4;
  return (long long)B * H * Sq * 4;              // D
}

// The backward: q, k, v, out and dout as the forward's (dout shaped and
// typed as out), lse the forward's (B, H, Sq) float32, work a device
// buffer of flash_attention_backward_workspace bytes (256-byte aligned);
// writes dq (as q), dk and dv (as k). Same limits as the forward.
// Returns a cudaError_t.
int flash_attention_backward_launch(const void* q, const void* k,
                                    const void* v, const void* out,
                                    const void* dout, const void* lse,
                                    void* work, void* dq, void* dk, void* dv,
                                    int B, int H, int KV, int Sq, int Sk,
                                    int dh, float scale, int causal,
                                    int window, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (KV <= 0 || H % KV || Sk <= 0) return cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  float* w = static_cast<float*>(work);
  if (wgmma_branch({q, k, v, out, dout}, B, H, KV, Sq, Sk, dh, bf16)) {
    if (dh == 64)
      return launch_bwd_wgmma<1>(q, k, v, out, dout, l, w, dq, dk, dv, B, H,
                                 KV, Sq, Sk, scale, causal, window, s);
    return launch_bwd_wgmma<2>(q, k, v, out, dout, l, w, dq, dk, dv, B, H,
                               KV, Sq, Sk, scale, causal, window, s);
  }
  const int cw_shift = copy_shift({q, k, v, dout}, dh, bf16 ? 2 : 4);
  if (bf16)
    return dispatch_bwd<__nv_bfloat16>(q, k, v, out, dout, l, w, dq, dk, dv,
                                       B, H, KV, Sq, Sk, dh, scale, causal,
                                       window, cw_shift, s);
  return dispatch_bwd<float>(q, k, v, out, dout, l, w, dq, dk, dv, B, H, KV,
                             Sq, Sk, dh, scale, causal, window, cw_shift, s);
}

}  // extern "C"
