// Bit-packed bipolar (+1/-1) matrix product by XNOR and popcount on the
// binary tensor cores, for sm_90a.
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
// What bounds it on this card. At the bench shape (256 x 128 words by
// 256 x 128 words) the operands and the output are 512 KB, 0.16 us at
// the memory rate, and the 268 M bit products take 0.05 us on the
// binary tensor cores (about 9.9 POPS, two operations a product, by
// bench/mma_probe.py on an H100 at 700 W). So neither bounds it: it is
// latency, one round trip to L2 or device memory for the operands and
// one through shared memory for the sum, in a grid that must fill 132
// SMs. (The int32 popcount pipe that the first form used issues a
// popcount at a fraction of the integer rate: 25 M popcounts held it
// at 7 us in 64 blocks.)
//
// What the design does about it.
//  * The products run on mma.sync.aligned.m16n8k256 with .and.popc
//    (b1 x b1 -> s32, exact): sum_c popcount(x & w). The XOR count is
//    popcount(x) + popcount(w) - 2 * popcount(x & w), word by word, so
//    the kernel adds each row's popcount, taken from the same registers
//    with __popc. Every word of both rows counts, pad bits included, as
//    in the plain version. (.xor.popc is also accepted on sm_90a but
//    runs about 7x slower, by the same probe.)
//  * A block owns a 32 x 16 output tile (two m16 by two n8 fragments),
//    so 256 x 256 is 128 blocks; the grid is one-dimensional over the
//    tiles, so B and N have no grid limit. Its 8 warps split W in slabs
//    of 16 words (warp w takes slabs w, w + 8, ...). A lane loads its
//    fragments straight from device memory as 16-byte loads, all of a
//    slab's at once: rows g and g + 8 of each m16 tile and row g of
//    each n8 tile (g = lane / 4), words 4t .. 4t + 3 of the slab (t =
//    lane % 4). Word 4t + 2i goes in the fragment's k-chunk t and word
//    4t + 2i + 1 in chunk 4 + t of the slab's i-th mma, in A and B
//    alike, so the products pair the same words; the sum over k does
//    not depend on which chunk holds which word.
//  * The warps' partial mismatch counts meet in shared memory (16 KB),
//    and 256 threads sum them and store the tile.
//  * Ragged B, N and W: rows past B or N and words past W load as 0 in
//    both operands (no count), and are not stored. Operands whose rows
//    are not 16-byte aligned (W % 4 != 0) load word by word.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                 // the W split inside a block
constexpr int kThreads = 32 * kWarps;
constexpr int kMT = 2, kNT = 2;           // m16 x n8 fragments a warp
constexpr int kTileM = 16 * kMT, kTileN = 8 * kNT;
constexpr int kSlab = 16;                 // words per warp step: 2 mma

// D (16 x 8) += popcount(A & B) over 256 bits: A rows g, g+8 and B
// column g, k-chunks t and 4 + t (a0..a3, b0..b1 as in the PTX ISA).
__device__ __forceinline__ void mma_and_popc(int (&d)[4], unsigned a0,
                                             unsigned a1, unsigned a2,
                                             unsigned a3, unsigned b0,
                                             unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Words c .. c + 3 of row `row` of a (rows, W) operand, 0 past either
// edge; one 16-byte load when rows are 16-byte aligned.
__device__ __forceinline__ uint4 load4(const unsigned* __restrict__ p,
                                       int row, int rows, int c, int W,
                                       bool vec) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (row >= rows) return v;
  const unsigned* r = p + size_t(row) * W;
  if (vec) {
    if (c < W) v = __ldg(reinterpret_cast<const uint4*>(r + c));
  } else {
    if (c < W) v.x = __ldg(r + c);
    if (c + 1 < W) v.y = __ldg(r + c + 1);
    if (c + 2 < W) v.z = __ldg(r + c + 2);
    if (c + 3 < W) v.w = __ldg(r + c + 3);
  }
  return v;
}

__device__ __forceinline__ int popc4(uint4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

__global__ void __launch_bounds__(kThreads)
xnor_popcount_kernel(const unsigned* __restrict__ x,
                     const unsigned* __restrict__ w, int* __restrict__ out,
                     int B, int N, int W, int n_features, int tiles_n,
                     int vec) {
  __shared__ int red[kWarps][kTileM * kTileN];
  const int tile = blockIdx.x;
  const int m0 = (tile / tiles_n) * kTileM;
  const int n0 = (tile % tiles_n) * kTileN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  int acc[kMT][kNT][4] = {};         // [m16 tile][n8 tile][fragment]
  int px[kMT][2] = {};               // popcount of x rows g, g + 8
  int pw[kNT] = {};                  // popcount of w row g
  for (int s = warp * kSlab; s < W; s += kWarps * kSlab) {
    const int c = s + 4 * t;
    uint4 a[kMT][2], b[kNT];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        a[mt][h] = load4(x, m0 + mt * 16 + h * 8 + g, B, c, W, vec);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
      b[nt] = load4(w, n0 + nt * 8 + g, N, c, W, vec);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      px[mt][0] += popc4(a[mt][0]);
      px[mt][1] += popc4(a[mt][1]);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        mma_and_popc(acc[mt][nt], a[mt][0].x, a[mt][1].x, a[mt][0].y,
                     a[mt][1].y, b[nt].x, b[nt].y);
        mma_and_popc(acc[mt][nt], a[mt][0].z, a[mt][1].z, a[mt][0].w,
                     a[mt][1].w, b[nt].z, b[nt].w);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) pw[nt] += popc4(b[nt]);
  }

  // whole-slice row popcounts: the four lanes of a group hold parts
  // of the same rows
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      px[mt][0] += __shfl_xor_sync(0xffffffffu, px[mt][0], o);
      px[mt][1] += __shfl_xor_sync(0xffffffffu, px[mt][1], o);
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
      pw[nt] += __shfl_xor_sync(0xffffffffu, pw[nt], o);
  }
  // this warp's mismatch counts: lane (g, t) holds rows g, g + 8 and
  // columns 2t, 2t + 1 of each fragment; column j's w popcount is in
  // group j
  int* mine = red[warp];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int pwc = __shfl_sync(0xffffffffu, pw[nt], (2 * t + cc) * 4);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          mine[(mt * 16 + h * 8 + g) * kTileN + nt * 8 + 2 * t + cc] =
              px[mt][h] + pwc - 2 * acc[mt][nt][2 * h + cc];
    }
  __syncthreads();

  for (int i = threadIdx.x; i < kTileM * kTileN; i += kThreads) {
    const int m = m0 + i / kTileN, n = n0 + i % kTileN;
    int mism = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) mism += red[k][i];
    if (m < B && n < N) out[size_t(m) * N + n] = n_features - 2 * mism;
  }
}

}  // namespace

extern "C" {

// x (B, W), w (N, W) packed words as int32; out (B, N) int32. All
// contiguous, on the device of `stream`. Returns a cudaError_t.
int xnor_popcount_launch(const void* x, const void* w, void* out, int B,
                         int N, int W, int n_features, void* stream) {
  const int tiles_n = (N + kTileN - 1) / kTileN;
  const long long tiles =
      static_cast<long long>((B + kTileM - 1) / kTileM) * tiles_n;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int vec = W % 4 == 0 &&
                  ((reinterpret_cast<size_t>(x) |
                    reinterpret_cast<size_t>(w)) & 15) == 0;
  xnor_popcount_kernel<<<static_cast<unsigned>(tiles), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(x), static_cast<const unsigned*>(w),
      static_cast<int*>(out), B, N, W, n_features, tiles_n, vec);
  return cudaGetLastError();
}

}  // extern "C"
