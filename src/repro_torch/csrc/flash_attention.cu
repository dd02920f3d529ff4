// Flash-attention forward (online softmax) in float32, for sm_90a.
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas
// and the GQA plumbing of its wrapper (flash_attention/ops.py).
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
// scores, as the reference's oracle and full_attention give).
//
// What bounds it on this card. At the bench shape (q 1024 x 4 heads,
// k and v 1024 x 2 heads, dh 64, causal) it reads and writes 3 MB and
// does 0.54 GFLOP, which take longer than the bytes at the float32
// rate: operations bound it. This kernel does them on the CUDA cores
// in float32 (no tensor cores), one expf per score.
//
// What the design does about it. A block owns 32 query rows of one
// (batch, head); four neighbouring threads share a row, each holding a
// quarter of its q and of its accumulator in registers (dims
// g, g + 4, g + 8, ...). K and V tiles of the block's key range are
// staged in shared memory and read by every row (the four threads of a
// row read four neighbouring words; the rows of a warp read the same
// ones, a broadcast). Each score is the four partial dot products
// summed by two warp shuffles; keys go four at a time, so four dot
// products and their shuffles are in flight together, and the softmax
// state is rescaled once per four keys, only when the running max
// rises. The block's key range
// is cut to the causal and window limits of its rows; GQA maps the
// query head to its KV head in the index arithmetic, so nothing is
// repeated or padded in memory. expf, not __expf, and no fast math.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;                 // query rows per block
constexpr int kGroup = 4;                 // threads per query row
constexpr int kThreads = kRows * kGroup;
constexpr int kStep = 4;                  // keys per inner step
constexpr float kNegInf = -1e30f;

template <int DHP>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int H, int KV, int Sq, int Sk, int dh, float scale,
                       int causal, int window) {
  constexpr int kDpt = DHP / kGroup;                 // dims per thread
  constexpr int kBk = DHP >= 128 ? 32 : 64;          // keys per tile
  static_assert(kBk * DHP % kThreads == 0 && kBk % kStep == 0,
                "a tile is whole loads per thread and whole steps");
  __shared__ float s_k[kBk * DHP];
  __shared__ float s_v[kBk * DHP];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * kRows;
  const int g = threadIdx.x % kGroup;
  const int i = q0 + threadIdx.x / kGroup;           // this thread's row
  const bool active = i < Sq;

  float qr[kDpt], acc[kDpt];
  const float* qrow = q + (size_t(b) * Sq + (active ? i : 0)) * H * dh +
                      size_t(h) * dh;
#pragma unroll
  for (int t = 0; t < kDpt; ++t) {
    const int d = t * kGroup + g;
    qr[t] = (active && d < dh) ? qrow[d] : 0.0f;
    acc[t] = 0.0f;
  }
  float m = kNegInf, l = 0.0f;

  // the block's key range: the union of its rows' unmasked keys
  const int q_last = min(Sq, q0 + kRows) - 1;
  const int hi = causal ? min(Sk, q_last + 1) : Sk;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const size_t kv_row = size_t(KV) * dh;             // floats per key
  const float* kbase = k + size_t(b) * Sk * kv_row + size_t(kvh) * dh;
  const float* vbase = v + size_t(b) * Sk * kv_row + size_t(kvh) * dh;

  for (int k0 = lo; k0 < hi; k0 += kBk) {
    const int nk = min(kBk, hi - k0);
    __syncthreads();                                 // previous tile read
    // unrolled, so every load of the tile is in flight before the
    // first store waits for one
#pragma unroll
    for (int r = 0; r < kBk * DHP / kThreads; ++r) {
      const int e = threadIdx.x + r * kThreads;
      const int j = e / DHP, d = e - j * DHP;
      const bool in = j < nk && d < dh;
      s_k[e] = in ? kbase[size_t(k0 + j) * kv_row + d] : 0.0f;
      s_v[e] = in ? vbase[size_t(k0 + j) * kv_row + d] : 0.0f;
    }
    __syncthreads();
    // four keys per step: four independent dot products and shuffles,
    // one max update; keys past nk are masked (their tile rows are 0)
    for (int j0 = 0; j0 < nk; j0 += kStep) {
      float sc[kStep];
#pragma unroll
      for (int u = 0; u < kStep; ++u) {
        const float* kj = s_k + (j0 + u) * DHP + g;
        float part = 0.0f;
#pragma unroll
        for (int t = 0; t < kDpt; ++t)
          part = fmaf(qr[t], kj[t * kGroup], part);
        sc[u] = part;
      }
#pragma unroll
      for (int u = 0; u < kStep; ++u)
        sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], 1);
#pragma unroll
      for (int u = 0; u < kStep; ++u)
        sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], 2);
      float m_new = m;
#pragma unroll
      for (int u = 0; u < kStep; ++u) {
        const int kpos = k0 + j0 + u;
        const bool keep = j0 + u < nk && (!causal || kpos <= i) &&
                          (window <= 0 || kpos > i - window);
        sc[u] = keep ? sc[u] * scale : kNegInf;
        m_new = fmaxf(m_new, sc[u]);
      }
      if (m_new > m) {
        const float corr = expf(m - m_new);
        l *= corr;
#pragma unroll
        for (int t = 0; t < kDpt; ++t) acc[t] *= corr;
        m = m_new;
      }
#pragma unroll
      for (int u = 0; u < kStep; ++u) {
        const float p = expf(sc[u] - m);
        l += p;
        const float* vj = s_v + (j0 + u) * DHP + g;
#pragma unroll
        for (int t = 0; t < kDpt; ++t) acc[t] = fmaf(p, vj[t * kGroup], acc[t]);
      }
    }
  }
  if (!active) return;

  const int row_lo = window > 0 ? max(0, i - window + 1) : 0;
  const int row_hi = causal ? min(Sk, i + 1) : Sk;
  float* orow = out + (size_t(b) * Sq + i) * H * dh + size_t(h) * dh;
  if (row_lo >= row_hi) {              // every key masked: mean of v
#pragma unroll
    for (int t = 0; t < kDpt; ++t) acc[t] = 0.0f;
    for (int j = 0; j < Sk; ++j)
#pragma unroll
      for (int t = 0; t < kDpt; ++t) {
        const int d = t * kGroup + g;
        if (d < dh) acc[t] += vbase[size_t(j) * kv_row + d];
      }
    l = static_cast<float>(Sk);
  }
  const float inv_l = 1.0f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int t = 0; t < kDpt; ++t) {
    const int d = t * kGroup + g;
    if (d < dh) orow[d] = acc[t] * inv_l;
  }
}

template <int DHP>
cudaError_t launch(const float* q, const float* k, const float* v, float* out,
                   int B, int H, int KV, int Sq, int Sk, int dh, float scale,
                   int causal, int window, cudaStream_t stream) {
  const dim3 grid((Sq + kRows - 1) / kRows, B * H);
  flash_attention_kernel<DHP><<<grid, kThreads, 0, stream>>>(
      q, k, v, out, H, KV, Sq, Sk, dh, scale, causal, window);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, Sq, H, dh), k and v (B, Sk, KV, dh), out (B, Sq, H, dh); all
// float32, contiguous, on the device of `stream`; 1 <= dh <= 128,
// H % KV == 0. Returns a cudaError_t.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int H, int KV, int Sq, int Sk,
                           int dh, float scale, int causal, int window,
                           void* stream) {
  auto* qq = static_cast<const float*>(q);
  auto* kk = static_cast<const float*>(k);
  auto* vv = static_cast<const float*>(v);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (KV <= 0 || H % KV) return cudaErrorInvalidValue;
  if (dh <= 8) return launch<8>(qq, kk, vv, o, B, H, KV, Sq, Sk, dh, scale, causal, window, s);
  if (dh <= 16) return launch<16>(qq, kk, vv, o, B, H, KV, Sq, Sk, dh, scale, causal, window, s);
  if (dh <= 32) return launch<32>(qq, kk, vv, o, B, H, KV, Sq, Sk, dh, scale, causal, window, s);
  if (dh <= 64) return launch<64>(qq, kk, vv, o, B, H, KV, Sq, Sk, dh, scale, causal, window, s);
  if (dh <= 128) return launch<128>(qq, kk, vv, o, B, H, KV, Sq, Sk, dh, scale, causal, window, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
