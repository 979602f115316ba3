// Fused dequantize + weighted accumulate of the K buffered uploads.
//
// Replaces the TPU kernel repro/kernels/buffer_agg.py::buffer_aggregate
// (_buffer_agg_kernel -> _weighted_dequant_sum).
//
// In:  packed uint8 (K, rows, 128*bits/8), norms f32 (K, rows), w f32 (K,).
// Out: f32 (rows, 128) = sum_k w_k * dequant(packed_k, norms_k).
//
// The sum runs over ascending k from zero, each step one fused multiply-add
// acc = fma(sign*mag, (w_k*n_k) * fl32(1/s), acc): that is what XLA:CPU
// compiles the reference's fori_loop into, reproduced on purpose. With K = 1
// XLA folds the loop's 0 + p to p, keeping a zero product's sign; so does
// this kernel.
//
// Bound: bytes. It reads K*(bits/8) B per element plus K*4 B per row and
// writes 4 B per element (K = 10, d = 1e8, qsgd4: 0.93 GB, 0.278 ms at
// 3.35 TB/s); at the CNN's 624 rows a launch is latency-bound.
//
// Design, against that bound (the decode machinery is code_vec.cuh's):
// * A thread owns one code vector (16 bytes, or one word for messages too
//   small to fill the card) and reads it in every message: K loads plus its
//   K norms, all issued before the first FMA. K is a template parameter up
//   to 16 (loads and FMA chains fully unrolled); a larger K goes in stages
//   of 8 loads in flight.
// * The funnel-shift decode takes four int32 and two f32 instructions per
//   code and message, the integer half about 0.24 ms at K = 10, d = 1e8
//   (132 SMs x 64 int32 lanes x 1.98 GHz): close to the byte bound.
// * Outputs leave as float4 stores through the warp's swizzled shared tile.
#include "code_vec.cuh"

namespace {

using codevec::kThreads;
using codevec::kWarps;
using codevec::load_words;
using codevec::signed_mag;
using codevec::store_warp;
using codevec::Vec;

constexpr int kMaxUnrolled = 16;       // largest K with its own kernel
constexpr int kStage = 8;              // loads in flight per stage above it

// Messages k0..k0+N-1 into acc: N loads and N scales first, then per code
// the FMA chain over the N messages in ascending order. `code` points at
// this thread's words in message k0, `norm` at its row's norm.
template <int BITS, int WORDS, int N, bool kFold>
__device__ __forceinline__ void accumulate(
    const uint32_t* __restrict__ code, const float* __restrict__ norm,
    const float* __restrict__ w, long long msg_words, long long rows,
    float rcp, float acc[Vec<BITS, WORDS>::kCodes]) {
  uint32_t q[N][WORDS];
  float scale[N];
#pragma unroll
  for (int j = 0; j < N; ++j) load_words<WORDS>(code + j * msg_words, q[j]);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    scale[j] = __fmul_rn(__fmul_rn(__ldg(w + j), __ldg(norm + j * rows)), rcp);
  }
#pragma unroll
  for (int c = 0; c < Vec<BITS, WORDS>::kCodes; ++c) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float sm = signed_mag<BITS>(q[j], c);
      acc[c] = kFold ? __fmul_rn(sm, scale[j]) : __fmaf_rn(sm, scale[j], acc[c]);
    }
  }
}

// KN = K for K <= kMaxUnrolled; KN = 0 for any larger K (stages of kStage,
// then the remainder one message at a time).
template <int BITS, int WORDS, int KN>
__global__ void __launch_bounds__(kThreads)
    buffer_aggregate_kernel(const uint32_t* __restrict__ packed,
                            const float* __restrict__ norms,
                            const float* __restrict__ weights,
                            float4* __restrict__ out, int k_count,
                            long long rows) {
  using V = Vec<BITS, WORDS>;
  __shared__ float4 tiles[kWarps][32 * V::kPass];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long threads = rows * V::kPerRow;
  const long long msg_words = rows * BITS * 4;  // 32-bit words per message
  const long long t0 = ((long long)blockIdx.x * kWarps + warp) * 32;
  // lanes past the end recompute the last thread's codes and store
  // nothing, so the whole warp reaches the passes through shared memory
  const long long t = min(t0 + lane, threads - 1);
  const long long row = t / V::kPerRow;
  const uint32_t* code = packed + t * WORDS;
  const float rcp = __frcp_rn(qsgd::levels(BITS));
  float acc[V::kCodes];
#pragma unroll
  for (int c = 0; c < V::kCodes; ++c) acc[c] = 0.0f;
  if constexpr (KN > 0) {
    accumulate<BITS, WORDS, KN, KN == 1>(code, norms + row, weights,
                                         msg_words, rows, rcp, acc);
  } else {
    int k = 0;
    for (; k + kStage <= k_count; k += kStage) {
      accumulate<BITS, WORDS, kStage, false>(code + k * msg_words,
                                             norms + k * rows + row,
                                             weights + k, msg_words, rows,
                                             rcp, acc);
    }
    for (; k < k_count; ++k) {
      accumulate<BITS, WORDS, 1, false>(code + k * msg_words,
                                        norms + k * rows + row, weights + k,
                                        msg_words, rows, rcp, acc);
    }
  }
  store_warp<BITS, WORDS>(acc, tiles[warp], out, t0, threads, lane);
}

// The kernel for k_count: KN = k_count up to kMaxUnrolled, else KN = 0.
template <int BITS, int WORDS, int KN>
void launch(const uint32_t* packed, const float* norms, const float* weights,
            float4* out, int k_count, long long rows, cudaStream_t stream) {
  if constexpr (KN <= kMaxUnrolled) {
    if (k_count != KN) {
      launch<BITS, WORDS, KN + 1>(packed, norms, weights, out, k_count, rows,
                                  stream);
      return;
    }
  }
  constexpr int kKernelK = KN <= kMaxUnrolled ? KN : 0;
  const long long threads = rows * Vec<BITS, WORDS>::kPerRow;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  buffer_aggregate_kernel<BITS, WORDS, kKernelK>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(packed, norms, weights, out,
                                                  k_count, rows);
}

template <int BITS>
void launch_bits(const uint32_t* packed, const float* norms,
                 const float* weights, float4* out, int k_count,
                 long long rows, int sms, cudaStream_t stream) {
  if (codevec::use_wide<BITS>(rows, sms)) {
    launch<BITS, 4, 1>(packed, norms, weights, out, k_count, rows, stream);
  } else {
    launch<BITS, 1, 1>(packed, norms, weights, out, k_count, rows, stream);
  }
}

}  // namespace

extern "C" int buffer_aggregate(const void* packed, const void* norms,
                                const void* weights, void* out, int k_count,
                                long long rows, int bits, void* stream) {
  int sms = 0;
  const cudaError_t err = qsgd::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const auto p = (const uint32_t*)packed;
  const auto n = (const float*)norms;
  const auto w = (const float*)weights;
  const auto o = (float4*)out;
  const auto s = (cudaStream_t)stream;
  switch (bits) {
    case 2: launch_bits<2>(p, n, w, o, k_count, rows, sms, s); break;
    case 4: launch_bits<4>(p, n, w, o, k_count, rows, sms, s); break;
    case 8: launch_bits<8>(p, n, w, o, k_count, rows, sms, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
