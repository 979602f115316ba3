// qsgd unpack + dequantize of one message.
//
// Replaces the TPU kernel repro/kernels/qsgd.py::qsgd_unpack_dequantize
// (_unpack_dequantize_kernel -> _unpack_dequantize_block).
//
// In:  packed uint8 (rows, 128*bits/8), norms f32 (rows,).
// Out: f32 (rows, 128) = (sign*mag) * (norm * fl32(1/s)) — the reference's
//      division by s as XLA compiles it under jit, reproduced on purpose;
//      with eager != 0, (sign*mag) * (norm / s) with a true division, the
//      reference's decode run op by op (its non-fused flush chain); with an
//      accumulator acc (f32, n values), fma(sign*mag, norm * fl32(1/s),
//      acc[e]) (0 past n): the decode fused into the add that consumes it,
//      as XLA:CPU compiles the reference round's hidden-state apply
//      x-hat + q (repro/distributed/steps.py:194); with an accumulator and
//      a weight w (one f32 on the card), fma((sign*mag) * (norm *
//      fl32(1/s)), w, acc[e]): the decoded value rounded, then its weighted
//      add fused, as XLA:CPU compiles the round's buf + w_k * dec
//      (repro/distributed/steps.py:170).
//
// Bound: bytes. It reads bits/8 B per element plus 4 B per row and writes
// 4 B per element (d = 1e8, qsgd4: 0.45 GB, 0.135 ms at 3.35 TB/s); at the
// CNN's 624 rows a launch is latency-bound.
//
// Design: buffer_aggregate.cu's decode at K = 1 with a unit weight, on
// code_vec.cuh. A thread owns one 16-byte code vector (a quarter row at 4
// bits), or one word when the message is too small to fill the card, loads
// its row's norm once and computes scale = norm * fl32(1/s) once, decodes
// with the funnel shift and writes sign*mag * scale as float4 stores through
// the warp's swizzled shared tile: each warp-wide store covers whole
// 128-byte lines. The accumulating variants read a thread's acc values (its
// outputs' positions, contiguous) one by one; the weighted one loads its
// weight once per thread.
#include "code_vec.cuh"

namespace {

using codevec::kThreads;
using codevec::kWarps;
using codevec::Vec;

// The scale and the output of one decode: plain sign*mag * scale, eager
// (scale by a true division), apply fma(sign*mag, scale, acc), weighted
// fma(sign*mag * scale, w, acc).
enum Mode { kPlain, kEager, kApply, kWeighted };

template <int BITS, int WORDS, int MODE>
__global__ void __launch_bounds__(kThreads)
    unpack_dequantize_kernel(const uint32_t* __restrict__ packed,
                             const float* __restrict__ norms,
                             const float* __restrict__ acc, long long n,
                             const float* __restrict__ weight,
                             float4* __restrict__ out, long long rows) {
  using V = Vec<BITS, WORDS>;
  __shared__ float4 tiles[kWarps][32 * V::kPass];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long threads = rows * V::kPerRow;
  const long long t0 = ((long long)blockIdx.x * kWarps + warp) * 32;
  // lanes past the end recompute the last thread's codes and store
  // nothing, so the whole warp reaches the passes through shared memory
  const long long t = min(t0 + lane, threads - 1);
  uint32_t q[WORDS];
  codevec::load_words<WORDS>(packed + t * WORDS, q);
  const float norm = __ldg(norms + t / V::kPerRow);
  const float scale =
      MODE == kEager ? __fdiv_rn(norm, (float)qsgd::levels(BITS))
                     : __fmul_rn(norm, __frcp_rn(qsgd::levels(BITS)));
  const float w = MODE == kWeighted ? __ldg(weight) : 0.0f;
  float val[V::kCodes];
#pragma unroll
  for (int c = 0; c < V::kCodes; ++c) {
    const float sm = codevec::signed_mag<BITS>(q, c);
    const long long e = t * V::kCodes + c;
    if constexpr (MODE == kApply) {
      val[c] = __fmaf_rn(sm, scale, e < n ? __ldg(acc + e) : 0.0f);
    } else if constexpr (MODE == kWeighted) {
      val[c] = __fmaf_rn(__fmul_rn(sm, scale), w,
                         e < n ? __ldg(acc + e) : 0.0f);
    } else {
      val[c] = __fmul_rn(sm, scale);
    }
  }
  codevec::store_warp<BITS, WORDS>(val, tiles[warp], out, t0, threads, lane);
}

struct Args {
  const uint32_t* packed;
  const float* norms;
  const float* acc;     // null: no accumulator
  long long n;          // acc's length
  const float* weight;  // null: no weight (needs acc)
  float4* out;
  long long rows;
};

template <int BITS, int WORDS, int MODE>
void launch(const Args& a, cudaStream_t stream) {
  const long long threads = a.rows * Vec<BITS, WORDS>::kPerRow;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  unpack_dequantize_kernel<BITS, WORDS, MODE>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(
          a.packed, a.norms, a.acc, a.n, a.weight, a.out, a.rows);
}

template <int BITS, int MODE>
void launch_width(const Args& a, int sms, cudaStream_t stream) {
  if (codevec::use_wide<BITS>(a.rows, sms)) {
    launch<BITS, 4, MODE>(a, stream);
  } else {
    launch<BITS, 1, MODE>(a, stream);
  }
}

template <int BITS>
void launch_bits(const Args& a, int sms, int eager, cudaStream_t stream) {
  if (a.weight != nullptr) {
    launch_width<BITS, kWeighted>(a, sms, stream);
  } else if (a.acc != nullptr) {
    launch_width<BITS, kApply>(a, sms, stream);
  } else if (eager) {
    launch_width<BITS, kEager>(a, sms, stream);
  } else {
    launch_width<BITS, kPlain>(a, sms, stream);
  }
}

}  // namespace

// `acc` may be null (no accumulator; `n` unused). An accumulator takes the
// jitted scale (eager 0). `weight` (one f32 on the device) may be null; a
// weight needs an accumulator.
extern "C" int qsgd_unpack_dequantize(const void* packed, const void* norms,
                                      void* out, long long rows, int bits,
                                      int eager, const void* acc, long long n,
                                      const void* weight, void* stream) {
  if (acc != nullptr && (eager || n < 0 || n > rows * qsgd::kLanes)) {
    return (int)cudaErrorInvalidValue;
  }
  if (weight != nullptr && acc == nullptr) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = qsgd::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const Args a{(const uint32_t*)packed, (const float*)norms,
               (const float*)acc, n, (const float*)weight, (float4*)out,
               rows};
  const auto s = (cudaStream_t)stream;
  switch (bits) {
    case 2: launch_bits<2>(a, sms, eager, s); break;
    case 4: launch_bits<4>(a, sms, eager, s); break;
    case 8: launch_bits<8>(a, sms, eager, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
