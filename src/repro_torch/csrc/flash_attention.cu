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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

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
// forward's per-row log-sum-exp, in three launches on one stream, with
// float32 sums and no atomics (every output element is written by one
// thread, in a fixed order):
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

// The backward: q, k, v, out and dout as the forward's (dout shaped and
// typed as out), lse the forward's (B, H, Sq) float32, D a float32
// (B, H, Sq) workspace; writes dq (as q), dk and dv (as k). Same limits
// as the forward. Returns a cudaError_t.
int flash_attention_backward_launch(const void* q, const void* k,
                                    const void* v, const void* out,
                                    const void* dout, const void* lse,
                                    void* D, void* dq, void* dk, void* dv,
                                    int B, int H, int KV, int Sq, int Sk,
                                    int dh, float scale, int causal,
                                    int window, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (KV <= 0 || H % KV || Sk <= 0) return cudaErrorInvalidValue;
  const int cw_shift = copy_shift({q, k, v, dout}, dh, bf16 ? 2 : 4);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(D);
  if (bf16)
    return dispatch_bwd<__nv_bfloat16>(q, k, v, out, dout, l, d, dq, dk, dv,
                                       B, H, KV, Sq, Sk, dh, scale, causal,
                                       window, cw_shift, s);
  return dispatch_bwd<float>(q, k, v, out, dout, l, d, dq, dk, dv, B, H, KV,
                             Sq, Sk, dh, scale, causal, window, cw_shift, s);
}

}  // extern "C"
