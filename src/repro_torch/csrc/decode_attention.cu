// Single-token attention over the serving ring KV cache (split-KV
// "flash-decoding"), for sm_90a, in bfloat16 or float32.
//
// It replaces no TPU kernel: the reference's decode attention
// (src/repro/models/layers.py::decode_attention) is plain jnp. The
// port's plain torch version laid the whole (B, W, KV, dh) ring out
// again for its batched einsums, for K and for V, every decode step, at
// W = max_seq whatever the slots' lengths, and then scored, masked and
// normalised all W slots of every row.
//
// What it computes. q (B, 1, H, dh); the layer's ring caches k and v
// (B, W, KV, dh), read where they lie; cache_positions (B, W), the
// absolute position each ring slot holds (-1: empty); positions (B,),
// each row's current position, both int32. Query head h reads KV head
// h / G (G = H / KV). Slot j of row b is valid when 0 <= c <= p and,
// with a window w > 0, c > p - w (c = cache_positions[b, j], p =
// positions[b]): the plain version's mask. s = (q . k_j) / sqrt(dh) in float32 over the
// valid slots; out = sum_j softmax(s)_j v_j with the softmax in float32,
// P rounded to bf16 before P.V in bf16, the sums in float32, the output
// rounded once to q's type. A row with no valid slot gets the mean of v
// over all W slots (the plain version's softmax of W equal -1e30
// scores).
//
// What bounds it on this card: bytes. At nemotron-4-340b's served decode
// (B 64 slots, W 4,096, KV 8, G 12, dh 192) a valid position costs 2 x 8
// x 192 x 2 = 6,144 B of K and V a layer; at about 1,400 positions a
// slot that is 550 MB a layer, 164 us at 3.35 TB/s, against 4 dh G = 9,216
// operations a position a KV head (12 a byte), far under the ~295 a byte
// at which the tensor cores would bound it.
//
// What the design does about it.
//  * Only valid slots are read. A block first reads its row's W
//    positions (W / 32 coalesced warp loads, 16 KB at W 4,096, from L2
//    after the first block of the row) into a bitmap of valid slots in
//    shared memory, by warp ballots, and lists the tiles of 64 slots (32
//    in float32) that hold a valid one. Tiles without
//    one are not visited; inside a visited tile the rows of invalid
//    slots are zero-filled by cp.async without reading device memory.
//    So the bytes follow each slot's length, not W, also where the ring
//    wraps (a window) or holds empty slots, with no host sync.
//  * Each K / V tile is fetched once for the whole query group. A block
//    serves one (row, KV head) pair, up to 16 of its G query heads (G >
//    16 takes more blocks), and one split of the row's listed tiles. The
//    heads are the 16 rows of mma.sync m16n8 tiles (G 12 leaves 4 empty,
//    which costs nothing here: wgmma's 64-row minimum would leave most of
//    a tile empty for one token). Four warps share each tile, each on its
//    own 16 keys (8 in float32) with its own running max, sum and 16 x
//    dh accumulator: S = Q K^T and O += P V with bf16 m16n8k16 (Q and K
//    by ldmatrix, V by ldmatrix.trans, P from the S accumulator as it
//    lies), float32 as m16n8k8 TF32 in three passes (hi.hi + hi.lo +
//    lo.hi, float32's accuracy), as the flash kernel does. A warp whose
//    16 slots of a tile are all invalid skips its products.
//  * Loads stay in flight: tiles of K and V stream through a ring of
//    2-3 stages in shared memory by cp.async (16-byte copies where the
//    rows allow), tile i + stages - 1 loading while tile i is computed;
//    about 110 KB a block at dh 192, two blocks to an SM.
//  * The ring is split across blocks (flash-decoding): split s of S
//    takes the listed tiles of ranks [s n / S, (s + 1) n / S), so a
//    row's work is cut evenly whatever its length. The wrapper picks S
//    from the shapes alone (pairs of row and KV head against the SMs, and
//    W), so the grid never depends on the data. With S = 1 the block
//    writes the output; otherwise it writes float32 partials (max, sum,
//    unnormalised output), and a merge kernel combines a row's S
//    partials in split order and rounds once. The wrapper allocates
//    them; the kernels allocate nothing and never synchronise.
// exp2 with log2(e) folded into the scale, no fast math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "mma_sync.cuh"

namespace {

using namespace mma_sync;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;             // query heads a block (mma rows)
constexpr int kMaxW = 1 << 16;        // ring slots (the bitmap's size)
constexpr int kMaxSplits = 64;
constexpr int kScanUnroll = 8;        // position loads in flight a warp
constexpr float kNeg = -1e30f;        // the plain version's mask value
constexpr float kLog2e = 1.4426950408889634f;

// A block's shared memory: the ring of K / V tiles (reused by the merge
// of the warps' partials at the end), Q's 16 rows, the bitmap of valid
// slots and the list of visited tiles. Rows are padded by 16 bytes so
// every fragment read is free of bank conflicts.
template <typename T, int DHP>
struct Geom {
  static constexpr int kSize = static_cast<int>(sizeof(T));
  static constexpr int kWarpKeys = kSize == 2 ? 16 : 8;
  static constexpr int kTileKeys = kWarps * kWarpKeys;   // 64 / 32
  static constexpr int kTileWords = kTileKeys / 32;      // bitmap words
  static constexpr int kStride = DHP + 16 / kSize;       // elements a row
  static constexpr int kTileElems = kTileKeys * kStride; // a K or V tile
  static constexpr int kStageBytes = 2 * kTileElems * kSize;
  static constexpr int kStages = 3 * kStageBytes <= 110 * 1024 ? 3 : 2;
  static constexpr int kMergeStride = DHP + 4;           // floats a row
  static constexpr int kMergeBytes = kWarps * kRows * kMergeStride * 4;
  static constexpr int kRingBytes = kStages * kStageBytes > kMergeBytes
                                        ? kStages * kStageBytes
                                        : kMergeBytes;
  static constexpr int kQBytes = kRows * kStride * kSize;
};

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ bool slot_valid(int c, int p, int window) {
  return c >= 0 && c <= p && (window <= 0 || c > p - window);
}

// One warp's products over its keys of a tile. S of the warp is kNB
// accumulator fragments of 8 keys: fragment nb holds keys 8 nb + 2t and
// 8 nb + 2t + 1 (t = lane % 4) of query rows g and g + 8 (g = lane / 4).
template <typename T, int DHP> struct Ops;

template <int DHP>
struct Ops<__nv_bfloat16, DHP> {
  using T = __nv_bfloat16;
  static constexpr int kNB = 2;
  static constexpr int kStride = Geom<T, DHP>::kStride;

  // S = Q K^T over the warp's 16 keys (kt: its first key's row)
  static __device__ __forceinline__ void scores(float (&sc)[kNB][4],
                                                const T* qs, const T* kt,
                                                int lane) {
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) sc[nb][r] = 0.0f;
    // A: rows lane % 16, columns 8 (lane / 16) of each k16 step; B:
    // keys (lane % 8) + 8 (lane / 16), columns 8 ((lane / 8) % 2)
    const T* qa = qs + (lane & 15) * kStride + (lane >> 4) * 8;
    const T* kb =
        kt + ((lane & 7) + (lane >> 4) * 8) * kStride + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int s = 0; s < DHP / 16; ++s) {
      uint32_t a[4], b[4];
      ldsm_x4(a, qa + s * 16);
      ldsm_x4(b, kb + s * 16);
      mma_bf16(sc[0], a, b[0], b[1]);
      mma_bf16(sc[1], a, b[2], b[3]);
    }
  }

  // acc (16 x DHP) += P V, P rounded to bf16: the two S fragments are the
  // A fragment of one k16 step as they lie; V's B fragments come by
  // ldmatrix.trans, two dh n-blocks an x4 load.
  static __device__ __forceinline__ void pv(float (&acc)[DHP / 8][4],
                                            const float (&p)[kNB][4],
                                            const T* vt, int lane) {
    const uint32_t a[4] = {pack_bf16(p[0][0], p[0][1]),
                           pack_bf16(p[0][2], p[0][3]),
                           pack_bf16(p[1][0], p[1][1]),
                           pack_bf16(p[1][2], p[1][3])};
    const int mi = lane >> 3;
    const T* row = vt + ((lane & 7) + (mi & 1) * 8) * kStride + (mi >> 1) * 8;
#pragma unroll
    for (int dn = 0; dn < DHP / 8; dn += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, row + dn * 8);
      mma_bf16(acc[dn], a, b[0], b[1]);
      mma_bf16(acc[dn + 1], a, b[2], b[3]);
    }
  }
};

template <int DHP>
struct Ops<float, DHP> {
  static constexpr int kNB = 1;
  static constexpr int kStride = Geom<float, DHP>::kStride;

  // S over the warp's 8 keys: A (g, t), (g+8, t), (g, t+4), (g+8, t+4)
  // of each k8 step from Q's rows, B (key g, t) and (key g, t+4)
  static __device__ __forceinline__ void scores(float (&sc)[kNB][4],
                                                const float* qs,
                                                const float* kt, int lane) {
    const int g = lane >> 2, t = lane & 3;
    float e[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 4; ++r) sc[0][r] = 0.0f;
#pragma unroll
    for (int s = 0; s < DHP / 8; ++s) {
      const float* qa = qs + g * kStride + s * 8 + t;
      const float af[4] = {qa[0], qa[8 * kStride], qa[4], qa[8 * kStride + 4]};
      uint32_t ah[4], al[4];
      split4(af, ah, al);
      const float* kr = kt + g * kStride + s * 8 + t;
      mma_3xtf32(sc[0], e, ah, al, kr[0], kr[4]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) sc[0][r] += e[r];
  }

  // acc += P V: the accumulator's keys 2t, 2t + 1 taken as the A
  // fragment's columns t, t + 4, and V's rows read in that order
  static __device__ __forceinline__ void pv(float (&acc)[DHP / 8][4],
                                            const float (&p)[kNB][4],
                                            const float* vt, int lane) {
    const int g = lane >> 2, t = lane & 3;
    const float a[4] = {p[0][0], p[0][2], p[0][1], p[0][3]};
    uint32_t ah[4], al[4];
    split4(a, ah, al);
    const float* vr = vt + 2 * t * kStride + g;
#pragma unroll
    for (int dn = 0; dn < DHP / 8; ++dn)
      mma_3xtf32(acc[dn], acc[dn], ah, al, vr[dn * 8], vr[kStride + dn * 8]);
  }
};

// Rows of one K or V tile (kTileKeys slots from key0 of one KV head; a
// slot's row at src + key * row_elems) into a shared tile: a row whose
// slot is invalid (its bit clear, as every bit past W is) and the
// columns past dh are zero-filled without reading device memory. CW is
// the copy width in bytes (16, 8, 4 by cp.async; 2, a bf16 row of odd
// dh, by plain loads), chosen by the launcher to divide every row.
template <typename T, int DHP, int CW>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          size_t row_elems,
                                          const unsigned* bits, int key0,
                                          int dh, int tid) {
  using Gm = Geom<T, DHP>;
  constexpr int kSegs = DHP * Gm::kSize / CW;
  const int dh_bytes = dh * Gm::kSize;
  for (int e = tid; e < Gm::kTileKeys * kSegs; e += kThreads) {
    const int j = e / kSegs, off = (e - j * kSegs) * CW;
    const int key = key0 + j;
    const bool valid = ((bits[key >> 5] >> (key & 31)) & 1u) && off < dh_bytes;
    char* d = reinterpret_cast<char*>(dst + j * Gm::kStride) + off;
    const char* s =
        valid ? reinterpret_cast<const char*>(src + size_t(key) * row_elems) +
                    off
              : reinterpret_cast<const char*>(src);
    if constexpr (CW >= 4)
      cp_async<CW>(d, s, valid);
    else
      *reinterpret_cast<uint16_t*>(d) =
          valid ? *reinterpret_cast<const uint16_t*>(s) : uint16_t(0);
  }
}

// Block (split, KV head x head chunk, row b). Warp w takes keys [w kWarpKeys,
// (w + 1) kWarpKeys) of every tile of the block's split.
template <typename T, int DHP>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ cpos,
                        const int* __restrict__ pos, T* __restrict__ out,
                        float* __restrict__ part_o,
                        float* __restrict__ part_ml, int W, int H, int KV,
                        int dh, int splits, int window, float scale_log2,
                        int cw) {
  using Gm = Geom<T, DHP>;
  using Op = Ops<T, DHP>;
  constexpr int kNB = Op::kNB;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_active;
  __shared__ float s_m[kWarps][kRows], s_l[kWarps][kRows];
  T* ring = reinterpret_cast<T*>(smem);
  T* qs = reinterpret_cast<T*>(smem + Gm::kRingBytes);
  const int n_tiles = (W + Gm::kTileKeys - 1) / Gm::kTileKeys;
  const int n_words = n_tiles * Gm::kTileWords;
  unsigned* bits =
      reinterpret_cast<unsigned*>(smem + Gm::kRingBytes + Gm::kQBytes);
  int* list = reinterpret_cast<int*>(bits + n_words);

  const int G = H / KV, chunks = (G + kRows - 1) / kRows;
  const int split = blockIdx.x, kvh = blockIdx.y / chunks, b = blockIdx.z;
  const int h0 = kvh * G + (blockIdx.y - kvh * chunks) * kRows;
  const int rows = min(kRows, (kvh + 1) * G - h0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int p = pos[b];

  // Q's rows of the block's heads, zero past `rows` and dh
  const T* qb = q + (size_t(b) * H + h0) * dh;
  for (int e = tid; e < kRows * DHP; e += kThreads) {
    const int r = e / DHP, d = e - r * DHP;
    qs[r * Gm::kStride + d] =
        (r < rows && d < dh) ? qb[size_t(r) * dh + d] : from_float<T>(0.0f);
  }

  // the bitmap of valid slots: word i holds slots [32 i, 32 i + 32)
  const size_t crow = size_t(b) * W;
  for (int w0 = warp; w0 < n_words; w0 += kWarps * kScanUnroll) {
    int c[kScanUnroll];
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) {
      const int slot = (w0 + u * kWarps) * 32 + lane;
      c[u] = slot < W ? cpos[crow + slot] : -1;
    }
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) {
      const int word = w0 + u * kWarps;
      const unsigned ballot =
          __ballot_sync(0xffffffffu, slot_valid(c[u], p, window));
      if (lane == 0 && word < n_words) bits[word] = ballot;
    }
  }
  __syncthreads();
  // the tiles holding a valid slot, in ring order
  if (warp == 0) {
    int count = 0;
    for (int t0 = 0; t0 < n_tiles; t0 += 32) {
      const int t = t0 + lane;
      bool any = false;
      if (t < n_tiles) {
#pragma unroll
        for (int i = 0; i < Gm::kTileWords; ++i)
          any |= bits[t * Gm::kTileWords + i] != 0u;
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, any);
      if (any) list[count + __popc(ballot & ((1u << lane) - 1u))] = t;
      count += __popc(ballot);
    }
    if (lane == 0) s_active = count;
  }
  __syncthreads();
  // no valid slot: every slot of the ring, at equal scores
  const bool none = s_active == 0;
  if (none) {
    for (int i = tid; i < n_words; i += kThreads) {
      const int left = W - 32 * i;
      bits[i] = left >= 32 ? 0xffffffffu : left > 0 ? (1u << left) - 1u : 0u;
    }
    for (int i = tid; i < n_tiles; i += kThreads) list[i] = i;
    __syncthreads();
  }
  const int n_active = none ? n_tiles : s_active;
  const int r0 = static_cast<int>(static_cast<long long>(split) * n_active /
                                  splits);
  const int n_mine =
      static_cast<int>(static_cast<long long>(split + 1) * n_active / splits) -
      r0;

  const size_t row_elems = size_t(KV) * dh;
  const T* kb = k + (size_t(b) * W * KV + kvh) * dh;
  const T* vb = v + (size_t(b) * W * KV + kvh) * dh;
  auto load = [&](int i) {
    const int key0 = list[r0 + i] * Gm::kTileKeys;
    T* dst = ring + (i % Gm::kStages) * 2 * Gm::kTileElems;
    T* dst_v = dst + Gm::kTileElems;
    switch (cw) {
      case 16:
        load_tile<T, DHP, 16>(dst, kb, row_elems, bits, key0, dh, tid);
        load_tile<T, DHP, 16>(dst_v, vb, row_elems, bits, key0, dh, tid);
        break;
      case 8:
        load_tile<T, DHP, 8>(dst, kb, row_elems, bits, key0, dh, tid);
        load_tile<T, DHP, 8>(dst_v, vb, row_elems, bits, key0, dh, tid);
        break;
      case 4:
        load_tile<T, DHP, 4>(dst, kb, row_elems, bits, key0, dh, tid);
        load_tile<T, DHP, 4>(dst_v, vb, row_elems, bits, key0, dh, tid);
        break;
      default:
        load_tile<T, DHP, 2>(dst, kb, row_elems, bits, key0, dh, tid);
        load_tile<T, DHP, 2>(dst_v, vb, row_elems, bits, key0, dh, tid);
    }
  };

  const int g = lane >> 2, t = lane & 3;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float acc[DHP / 8][4];
#pragma unroll
  for (int dn = 0; dn < DHP / 8; ++dn)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[dn][r] = 0.0f;

#pragma unroll
  for (int s = 0; s < Gm::kStages - 1; ++s) {
    if (s < n_mine) load(s);
    cp_async_commit();
  }
  for (int i = 0; i < n_mine; ++i) {
    cp_async_wait<Gm::kStages - 2>();  // tile i landed (this thread's part)
    __syncthreads();  // every part, and every warp done with tile i - 1
    if (i + Gm::kStages - 1 < n_mine) load(i + Gm::kStages - 1);
    cp_async_commit();
    const int key0 = list[r0 + i] * Gm::kTileKeys + warp * Gm::kWarpKeys;
    const unsigned wb = (bits[key0 >> 5] >> (key0 & 31)) &
                        ((1u << Gm::kWarpKeys) - 1u);
    if (wb == 0u) continue;  // none of the warp's slots is valid
    const T* kt = ring + (i % Gm::kStages) * 2 * Gm::kTileElems +
                  warp * Gm::kWarpKeys * Gm::kStride;
    float sc[kNB][4];
    Op::scores(sc, qs, kt, lane);
    // scaled scores; an invalid slot takes no weight at all, and with no
    // valid slot in the row every slot the same score
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int key = nb * 8 + 2 * t + (r & 1);
        const float x = !((wb >> key) & 1u) ? -INFINITY
                        : none              ? kNeg
                                            : sc[nb][r] * scale_log2;
        sc[nb][r] = x;
        mx[r >> 1] = fmaxf(mx[r >> 1], x);
      }
    float f[2];
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      mx[i2] = fmaxf(mx[i2], __shfl_xor_sync(0xffffffffu, mx[i2], 1));
      mx[i2] = fmaxf(mx[i2], __shfl_xor_sync(0xffffffffu, mx[i2], 2));
      const float mn = fmaxf(m[i2], mx[i2]);
      f[i2] = ex2(m[i2] - mn);  // 0 while m is -inf
      m[i2] = mn;
      l[i2] *= f[i2];
    }
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float e = ex2(sc[nb][r] - m[r >> 1]);
        sc[nb][r] = e;
        l[r >> 1] += e;
      }
#pragma unroll
    for (int dn = 0; dn < DHP / 8; ++dn) {
      acc[dn][0] *= f[0];
      acc[dn][1] *= f[0];
      acc[dn][2] *= f[1];
      acc[dn][3] *= f[1];
    }
    Op::pv(acc, sc, kt + Gm::kTileElems, lane);
  }
  cp_async_wait<0>();

  // merge the warps' (max, sum, output) of each head, in warp order
#pragma unroll
  for (int i2 = 0; i2 < 2; ++i2) {
    l[i2] += __shfl_xor_sync(0xffffffffu, l[i2], 1);
    l[i2] += __shfl_xor_sync(0xffffffffu, l[i2], 2);
  }
  if (t == 0) {
    s_m[warp][g] = m[0];
    s_m[warp][g + 8] = m[1];
    s_l[warp][g] = l[0];
    s_l[warp][g + 8] = l[1];
  }
  __syncthreads();  // also: every warp is done with the ring
  float f[2];
#pragma unroll
  for (int i2 = 0; i2 < 2; ++i2) {
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, s_m[w][g + 8 * i2]);
    f[i2] = m[i2] == -INFINITY ? 0.0f : ex2(m[i2] - mm);
  }
  float* mrg = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int dn = 0; dn < DHP / 8; ++dn)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      mrg[(warp * kRows + g + (r >> 1) * 8) * Gm::kMergeStride + dn * 8 +
          2 * t + (r & 1)] = acc[dn][r] * f[r >> 1];
  __syncthreads();
  for (int e = tid; e < kRows * DHP; e += kThreads) {
    const int row = e / DHP, d = e - row * DHP;
    if (row >= rows || d >= dh) continue;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, s_m[w][row]);
    float sum = 0.0f, o = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = s_m[w][row];
      sum += mw == -INFINITY ? 0.0f : s_l[w][row] * ex2(mw - mm);
      o += mrg[(w * kRows + row) * Gm::kMergeStride + d];
    }
    const size_t bh = size_t(b) * H + h0 + row;
    if (splits == 1) {
      out[bh * dh + d] = from_float<T>(o / sum);
    } else {
      part_o[(bh * splits + split) * dh + d] = o;
      if (d == 0) {
        part_ml[(bh * splits + split) * 2] = mm;
        part_ml[(bh * splits + split) * 2 + 1] = sum;
      }
    }
  }
}

// One block a (row, query head): its splits' partials, combined in split
// order (an empty split, max -inf, weighs nothing), rounded once.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_merge_kernel(const float* __restrict__ part_o,
                              const float* __restrict__ part_ml,
                              T* __restrict__ out, int splits, int dh) {
  __shared__ float s_w[kMaxSplits];
  __shared__ float s_sum;
  const size_t bh = blockIdx.x;
  const float* ml = part_ml + bh * splits * 2;
  if (threadIdx.x == 0) {
    float mm = -INFINITY;
    for (int s = 0; s < splits; ++s) mm = fmaxf(mm, ml[2 * s]);
    float sum = 0.0f;
    for (int s = 0; s < splits; ++s) {
      const float w = ml[2 * s] == -INFINITY ? 0.0f : ex2(ml[2 * s] - mm);
      s_w[s] = w;
      sum += ml[2 * s + 1] * w;
    }
    s_sum = sum;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < dh; d += kThreads) {
    float o = 0.0f;
    for (int s = 0; s < splits; ++s)
      o += part_o[(bh * splits + s) * dh + d] * s_w[s];
    out[bh * dh + d] = from_float<T>(o / s_sum);
  }
}

struct Args {
  const void *q, *k, *v;
  const int *cpos, *pos;
  void *out, *part_o, *part_ml;
  int B, W, H, KV, dh, splits, window;
  float scale;
  int cw;
};

template <typename T, int DHP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using Gm = Geom<T, DHP>;
  const auto kernel = &decode_attention_kernel<T, DHP>;
  const int n_tiles = (a.W + Gm::kTileKeys - 1) / Gm::kTileKeys;
  const size_t smem = size_t(Gm::kRingBytes) + Gm::kQBytes +
                      size_t(n_tiles) * (Gm::kTileWords + 1) * 4;
  static bool carved = false;  // per instance
  static size_t opted = 0;     // the largest opt-in so far, per instance
  if (!carved) {
    // all of the SM's unified memory as shared: two blocks at dh 192
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (err != cudaSuccess) return err;
    carved = true;
  }
  const cudaError_t opt = repro::allow_smem(kernel, smem, opted);
  if (opt != cudaSuccess) return opt;
  const int chunks = (a.H / a.KV + kRows - 1) / kRows;
  const dim3 grid(a.splits, a.KV * chunks, a.B);
  decode_attention_kernel<T, DHP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.cpos, a.pos, static_cast<T*>(a.out),
      static_cast<float*>(a.part_o), static_cast<float*>(a.part_ml), a.W,
      a.H, a.KV, a.dh, a.splits, a.window, a.scale * kLog2e, a.cw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  decode_attention_merge_kernel<T><<<a.B * a.H, kThreads, 0, stream>>>(
      static_cast<const float*>(a.part_o),
      static_cast<const float*>(a.part_ml), static_cast<T*>(a.out),
      a.splits, a.dh);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_width(const Args& a, cudaStream_t stream) {
  if (a.dh <= 16) return launch<T, 16>(a, stream);
  if (a.dh <= 32) return launch<T, 32>(a, stream);
  if (a.dh <= 64) return launch<T, 64>(a, stream);
  if (a.dh <= 128) return launch<T, 128>(a, stream);
  if (a.dh <= 192) return launch<T, 192>(a, stream);
  return launch<T, 256>(a, stream);
}

// the widest copy (16, 8, 4 or 2 bytes) that divides a row of dh
// elements and both caches' starts
int copy_width(const void* k, const void* v, int row_bytes) {
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v);
  for (int cw = 16; cw > 2; cw >>= 1)
    if (row_bytes % cw == 0 && addr % cw == 0) return cw;
  return 2;
}

}  // namespace

// q (B, 1, H, dh), k and v (B, W, KV, dh) and out (B, 1, H, dh), all
// contiguous, bf16 (bf16 = 1) or float32; cpos (B, W) and pos (B,) int32;
// part_o (B, H, splits, dh) and part_ml
// (B, H, splits, 2) float32 scratch, unused when splits is 1. scale is
// 1 / sqrt(dh). Launches on `stream` and returns the launch's error.
extern "C" cudaError_t decode_attention_launch(
    const void* q, const void* k, const void* v, const int* cpos,
    const int* pos, void* out, void* part_o, void* part_ml, int B, int W,
    int H, int KV, int dh, int splits, int window, float scale, int bf16,
    cudaStream_t stream) {
  if (B < 1 || B > 65535 || W < 1 || W > kMaxW || KV < 1 || H % KV != 0 ||
      dh < 1 || dh > 256 || splits < 1 || splits > kMaxSplits ||
      static_cast<long long>(KV) * ((H / KV + kRows - 1) / kRows) > 65535 ||
      (splits > 1 && (part_o == nullptr || part_ml == nullptr)))
    return cudaErrorInvalidValue;
  const int size = bf16 ? 2 : 4;
  const Args a{q,  k,  v,      cpos,   pos,   out,
               part_o, part_ml, B, W, H, KV, dh, splits, window, scale,
               copy_width(k, v, dh * size)};
  return bf16 ? by_width<__nv_bfloat16>(a, stream) : by_width<float>(a, stream);
}
