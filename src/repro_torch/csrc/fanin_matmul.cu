// Fanin-K gather-matmul of an FCP-sparse linear layer, for sm_90a.
//
// Replaces the TPU kernel
//   src/repro/kernels/fanin_matmul/fanin_matmul.py::fanin_matmul_pallas.
//
// What it computes. After fanin-constrained pruning each of N neurons
// reads exactly K of the n_in inputs:
//   y[b, j] = sum_{k=0..K-1} x[b, idx[j, k]] * w[j, k] + bias[j]
// for x, w and bias each float32, bfloat16 or float16, in the reference
// kernel's rounding: each product rounded to the promoted type of x and
// w (JAX's and torch's promotion agree here: x's type where w has it,
// else float32), the sum in float32 from k = 0 up (no fused
// multiply-add), then the bias, then one rounding to x's type; the
// plain version computes the same, bit for bit. Mixed types reach two
// more instances a type of x (bf16, f16): w in float32 (W = float), its
// products exact in float32. The wrapper casts a w of another type than
// x's to float32 and a bias of another type to float32 before the
// launch: bf16 and f16 values are float32 values, so the casts round
// nothing, the float32 product of the cast values is the reference's
// promoted product (float32 whenever the two types differ), and the
// bias is added to the float32 sum as the reference adds it. An index
// in [-n_in, 0) reads column
// idx + n_in; any other outside [0, n_in) gathers a NaN, as the
// reference's gather does: a compare on each index, no host check.
//
// What bounds it on this card. K multiply-adds per output against K
// gathered x values: far below the float32 rate, so it is bound by
// bytes, and by the bytes that cross from L2 to the SMs more than by
// those read from device memory (x, 4 MB at the bench shape, 256 x
// 4096 float32, stays in L2 between calls). Gathered one 4-byte value
// at a time from L2, each value moves a 32-byte sector: some 67 MB for
// those 4 MB when the lanes of a warp are neurons of one row.
//
// What the design does about it. A block owns R whole rows of x and a
// span of neurons (at the bench shape 2 rows and all 1,024 neurons, so
// x crosses to the SMs once). Thread 0 copies the rows into shared
// memory, as they lie in x, with one bulk copy (the copy engine,
// completion on an mbarrier; ragged ends not 16-byte aligned by plain
// loads). Meanwhile each of the 1,024 threads loads its neuron's first
// eight indices and weights (16-byte loads where the rows of idx and w
// allow); then it gathers from the staged rows, eight terms at a time
// with the next eight in flight, so K is not limited. Neighbouring
// threads take neighbouring neurons, so the output stores coalesce. A
// neuron's rows sit in one thread; its lanes' random columns meet about
// 3-4 to a bank. The other layout, a warp's lanes on rows of one neuron
// at an odd row stride, is free of conflicts but needs 32 rows a block:
// 512 KB at n_in 4096.
//
// What is left: the rows' copy and the terms' loads (the span's 64 KB
// of indices and weights into every block) overlap, each alone some
// 2-3 us above the launch floor (chip_smoke.py times both); in bf16,
// with two thirds of the bytes, the kernel takes as long, so it waits
// on the loads' latency more than on bytes. More rows a block, or fewer
// neurons, would leave SMs idle or read x more than once. Tried and
// slower at the bench shape: 256 or 512 threads (the loads' latency
// shows), the rows copied by every thread's cp.async or a bulk copy a
// row, blocks starting at different neurons, and the indices and
// weights in tiles multicast over a cluster of blocks (the gathers wait
// for a whole tile, and clusters of 1,024-thread blocks do not all fit
// the card at once); no faster: the rows' bulk copy in pieces of 1 to
// 16 KB.
//
// Rows wider than the 227 KB budget (58,104 float32 columns) cannot be
// staged: the same body then reads x from device memory (`kStaged`
// false), the sums in the same order.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "cp_async.cuh"     // repro::allow_smem

namespace {

// Threads a block, one neuron each at a time: 1,024 with the rows
// staged (enough loads in flight to hide their latency, at most 64
// registers a thread); 512 with the rows in device memory, whose
// 64-bit gather addresses take more registers.
template <bool kStaged>
constexpr int kThreads = kStaged ? 1024 : 512;
constexpr int kChunk = 8;       // fanin terms held in registers at once
constexpr int kBarBytes = 16;   // the rows' mbarrier, at the start

// The input type's conversions and product, in float. Two bfloat16 or
// float16 values multiply exactly in float32, so rounding that product
// once gives the input type's own product.
template <typename T> struct Num;
template <> struct Num<float> {
  static __device__ __forceinline__ float in(float v) { return v; }
  static __device__ __forceinline__ float out(float v) { return v; }
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
};
template <> struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float in(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 out(float v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float mul(float a, float b) {
    return __bfloat162float(__float2bfloat16_rn(__fmul_rn(a, b)));
  }
  static __device__ __forceinline__ float bits(unsigned v) {
    return __uint_as_float(v << 16);
  }
};
template <> struct Num<__half> {
  static __device__ __forceinline__ float in(__half v) {
    return __half2float(v);
  }
  static __device__ __forceinline__ __half out(float v) {
    return __float2half_rn(v);
  }
  static __device__ __forceinline__ float mul(float a, float b) {
    return __half2float(__float2half_rn(__fmul_rn(a, b)));
  }
  static __device__ __forceinline__ float bits(unsigned v) {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(v)));
  }
};

// The product of an x value (type T) and a w value (type W) in their
// promoted type: T's own where W is T, float32 where w is float32.
template <typename T, typename W> struct Prod {
  static __device__ __forceinline__ float mul(float a, float b) {
    return Num<T>::mul(a, b);
  }
};
template <typename T> struct Prod<T, float> {
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
};

__device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ---- mbarrier and the bulk copy -----------------------------------------

__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile(
      "mbarrier.init.shared::cta.b64 [%0], 1;\n"
      "fence.mbarrier_init.release.cluster;\n" ::"r"(bar)
      : "memory");
}

// One arrival, and `bytes` more to come from the bulk copies.
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar), "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16) from src to shared memory at dst, both
// 16-byte aligned, by the copy engine; the mbarrier at bar is told.
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ---- rows of x ------------------------------------------------------------

// `bytes` at src split into a ragged head up to the first 16-byte
// boundary, a 16-byte aligned middle [head, body) and a ragged tail.
struct Split {
  size_t head, body;
};
__device__ __forceinline__ Split split16(const void* src, size_t bytes) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const size_t head = min(((s + 15) & ~uintptr_t(15)) - s, bytes);
  return {head, head + ((bytes - head) & ~size_t(15))};
}

// Copy the block's rows, `bytes` from src, to shared memory at dst +
// (src mod 16), as they lie in x: the middle by one bulk copy that
// thread 0 issues, the head and tail (under 16 bytes each, 2-byte
// granular) by plain loads. Returns the staged copy of src, valid once
// the mbarrier has seen the middle and after a barrier.
template <typename T>
__device__ __forceinline__ const T* stage_rows(unsigned char* dst,
                                               const T* src, size_t bytes,
                                               Split p, unsigned bar) {
  unsigned char* d = dst + (reinterpret_cast<uintptr_t>(src) & 15);
  const auto* from = reinterpret_cast<const unsigned char*>(src);
  if (threadIdx.x == 0 && p.body > p.head)
    bulk_copy(smem_addr(d + p.head), from + p.head,
              unsigned(p.body - p.head), bar);
  for (size_t o = 2 * threadIdx.x; o < p.head; o += 2 * kThreads<true>)
    *reinterpret_cast<unsigned short*>(d + o) =
        *reinterpret_cast<const unsigned short*>(from + o);
  for (size_t o = p.body + 2 * threadIdx.x; o < bytes;
       o += 2 * kThreads<true>)
    *reinterpret_cast<unsigned short*>(d + o) =
        *reinterpret_cast<const unsigned short*>(from + o);
  return reinterpret_cast<const T*>(d);
}

// ---- a neuron's fanin terms -----------------------------------------------

// Eight fanin terms of one neuron: columns (-1: out of range, a NaN)
// and weights in float.
struct Chunk {
  int col[kChunk];
  float w[kChunk];
};

// The eight weights at p (16-byte aligned) as floats.
__device__ __forceinline__ void load8(float* out, const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
  out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
}
template <typename T>
__device__ __forceinline__ void load8(float* out, const T* p) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned u[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {               // little-endian halves
    out[2 * c] = Num<T>::bits(u[c] & 0xffffu);
    out[2 * c + 1] = Num<T>::bits(u[c] >> 16);
  }
}

// Terms k0 .. k0 + 7 of the neuron whose terms start at ip / wp. `vec`:
// the rows of idx and w start 16-byte aligned (K a multiple of 4 for
// float32 w, of 8 for 2-byte w), so a full chunk comes in 16-byte
// loads: a warp's lanes read 32 rows of 32 bytes, and a 4-byte load
// costs an L1 wavefront for each line the warp touches.
template <typename W>
__device__ __forceinline__ void load_chunk(Chunk& ch, const int* ip,
                                           const W* wp, int k0, int K,
                                           int n_in, bool vec) {
  int i8[kChunk];
  if (vec && k0 + kChunk <= K) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(ip + k0));
    const int4 b = __ldg(reinterpret_cast<const int4*>(ip + k0) + 1);
    i8[0] = a.x, i8[1] = a.y, i8[2] = a.z, i8[3] = a.w;
    i8[4] = b.x, i8[5] = b.y, i8[6] = b.z, i8[7] = b.w;
    load8(ch.w, wp + k0);
  } else {
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const bool in_k = k0 + c < K;
      i8[c] = in_k ? __ldg(ip + k0 + c) : 0;
      ch.w[c] = in_k ? Num<W>::in(__ldg(wp + k0 + c)) : 0.0f;
    }
  }
#pragma unroll
  for (int c = 0; c < kChunk; ++c) {
    const int i = i8[c] + (i8[c] < 0 ? n_in : 0);
    ch.col[c] = unsigned(i) < unsigned(n_in) ? i : -1;
  }
}

// One block: rows b0 .. b0 + R - 1 of x (staged in shared memory, or
// in device memory) and the neurons of span blockIdx.y, thread t the
// span's neurons t, t + kThreads, ..., each sum in k order, then the
// bias (of type T, or float32 where bias_f32); a thread's next eight
// terms are in flight while it gathers for the current ones.
template <typename T, typename W, int R, bool kStaged>
__global__ void __launch_bounds__(kThreads<kStaged>)
fanin_matmul_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                    const W* __restrict__ w, const void* __restrict__ bias,
                    int bias_f32, T* __restrict__ out, int B, int n_in,
                    int N, int K, int span) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b0 = blockIdx.x * R;
  const int nr = min(R, B - b0);
  const int s1 = min(N, (blockIdx.y + 1) * span);
  const T* xb = x + size_t(b0) * n_in;    // row r at xb + r * n_in
  const unsigned bar = smem_addr(smem);
  if (kStaged) {             // [mbarrier][the rows, at x's address mod 16]
    if (threadIdx.x == 0) mbar_init(bar);
    __syncthreads();
    const size_t bytes = size_t(nr) * n_in * sizeof(T);
    const Split p = split16(xb, bytes);
    // the bulk bytes, announced before they are copied
    if (threadIdx.x == 0) mbar_expect(bar, unsigned(p.body - p.head));
    xb = stage_rows(smem + kBarBytes, xb, bytes, p, bar);
  }
  const bool vec =
      K % (16 / sizeof(W)) == 0 &&
      ((reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(w)) &
       15) == 0;
  const float qnan = __int_as_float(0x7fffffff);
  int j = blockIdx.y * span + threadIdx.x, k0 = 0;
  Chunk cur;                 // its load overlaps the copy of the rows
  if (j < s1)
    load_chunk(cur, idx + size_t(j) * K, w + size_t(j) * K, 0, K, n_in, vec);
  if (kStaged) {
    mbar_wait(bar, 0);
    __syncthreads();         // the rows' ragged ends
  }
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0f;
  while (j < s1) {
    int jn = j, kn = k0 + kChunk;
    if (kn >= K) jn += kThreads<kStaged>, kn = 0;
    Chunk next;
    if (jn < s1)
      load_chunk(next, idx + size_t(jn) * K, w + size_t(jn) * K, kn, K, n_in,
                 vec);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= nr) break;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        if (k0 + c >= K) break;
        const float v =
            cur.col[c] >= 0 ? Num<T>::in(xb[r * n_in + cur.col[c]]) : qnan;
        acc[r] = __fadd_rn(acc[r], Prod<T, W>::mul(v, cur.w[c]));
      }
    }
    if (kn == 0) {                           // neuron j is summed
      const float bj =
          bias_f32 ? static_cast<const float*>(bias)[j]
                   : Num<T>::in(static_cast<const T*>(bias)[j]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < nr)
          out[size_t(b0 + r) * N + j] = Num<T>::out(__fadd_rn(acc[r], bj));
        acc[r] = 0.0f;
      }
    }
    j = jn, k0 = kn, cur = next;
  }
}

template <typename T, typename W, int R, bool kStaged>
int launch(const void* x, const void* idx, const void* w, const void* bias,
           int bias_f32, void* out, int B, int n_in, int N, int K, int span,
           size_t smem, cudaStream_t stream) {
  static size_t opted = 0;
  const cudaError_t err =
      repro::allow_smem(fanin_matmul_kernel<T, W, R, kStaged>, smem, opted);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + R - 1) / R, (N + span - 1) / span);
  fanin_matmul_kernel<T, W, R, kStaged>
      <<<grid, kThreads<kStaged>, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(idx),
      static_cast<const W*>(w), bias, bias_f32, static_cast<T*>(out), B,
      n_in, N, K, span);
  return cudaGetLastError();
}

template <typename T, typename W, int R>
int launch_rows(bool staged, const void* x, const void* idx, const void* w,
                const void* bias, int bias_f32, void* out, int B, int n_in,
                int N, int K, int span, size_t smem, cudaStream_t stream) {
  return staged ? launch<T, W, R, true>(x, idx, w, bias, bias_f32, out, B,
                                        n_in, N, K, span, smem, stream)
                : launch<T, W, R, false>(x, idx, w, bias, bias_f32, out, B,
                                         n_in, N, K, span, 0, stream);
}

template <typename T, typename W>
int launch_type(int rows, bool staged, const void* x, const void* idx,
                const void* w, const void* bias, int bias_f32, void* out,
                int B, int n_in, int N, int K, int span, size_t smem,
                cudaStream_t stream) {
  switch (rows) {
    case 1: return launch_rows<T, W, 1>(staged, x, idx, w, bias, bias_f32,
                                        out, B, n_in, N, K, span, smem,
                                        stream);
    case 2: return launch_rows<T, W, 2>(staged, x, idx, w, bias, bias_f32,
                                        out, B, n_in, N, K, span, smem,
                                        stream);
    default: return cudaErrorInvalidValue;
  }
}

// x's type T with w of T's type, or (w_f32) in float32
template <typename T>
int launch_w(int w_f32, int rows, bool staged, const void* x,
             const void* idx, const void* w, const void* bias, int bias_f32,
             void* out, int B, int n_in, int N, int K, int span, size_t smem,
             cudaStream_t stream) {
  return w_f32 ? launch_type<T, float>(rows, staged, x, idx, w, bias,
                                       bias_f32, out, B, n_in, N, K, span,
                                       smem, stream)
               : launch_type<T, T>(rows, staged, x, idx, w, bias, bias_f32,
                                   out, B, n_in, N, K, span, smem, stream);
}

}  // namespace

extern "C" {

// x (B, n_in); idx (N, K) int32; w (N, K); bias (N,); out (B, N); x and
// out of one type: dtype 0 float32, 1 bfloat16, 2 float16; w of x's type
// or (w_f32) float32, bias of x's type or (bias_f32) float32. All
// contiguous, on the device of `stream`. rows (1 or 2) batch rows and
// span neurons a block; staged: the rows in `smem` bytes of shared
// memory (16 for the mbarrier, then the rows' bytes rounded up to 16,
// + 16), else read from device memory. Returns a cudaError_t.
int fanin_matmul_launch(const void* x, const void* idx, const void* w,
                        const void* bias, void* out, int B, int n_in, int N,
                        int K, int dtype, int w_f32, int bias_f32, int rows,
                        int staged, int span, int smem, void* stream) {
  if (span <= 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_type<float, float>(rows, staged, x, idx, w, bias,
                                             0, out, B, n_in, N, K, span,
                                             smem, s);
    case 1: return launch_w<__nv_bfloat16>(w_f32, rows, staged, x, idx, w,
                                           bias, bias_f32, out, B, n_in, N,
                                           K, span, smem, s);
    case 2: return launch_w<__half>(w_f32, rows, staged, x, idx, w, bias,
                                    bias_f32, out, B, n_in, N, K, span, smem,
                                    s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
