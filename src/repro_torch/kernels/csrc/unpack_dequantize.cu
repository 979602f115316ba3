// qsgd unpack + dequantize of one message.
//
// Replaces the TPU kernel repro/kernels/qsgd.py::qsgd_unpack_dequantize
// (_unpack_dequantize_kernel -> _unpack_dequantize_block).
//
// In:  packed uint8 (rows, 128*bits/8), norms f32 (rows,).
// Out: f32 (rows, 128) = (sign*mag) * (norm * fl32(1/s)) — the reference's
//      division by s as XLA compiles it under jit, reproduced on purpose;
//      with eager != 0, (sign*mag) * (norm / s) with a true division, the
//      reference's decode run op by op (its non-fused flush chain).
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
// 128-byte lines.
#include "code_vec.cuh"

namespace {

using codevec::kThreads;
using codevec::kWarps;
using codevec::Vec;

template <int BITS, int WORDS, bool EAGER>
__global__ void __launch_bounds__(kThreads)
    unpack_dequantize_kernel(const uint32_t* __restrict__ packed,
                             const float* __restrict__ norms,
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
      EAGER ? __fdiv_rn(norm, (float)qsgd::levels(BITS))
            : __fmul_rn(norm, __frcp_rn(qsgd::levels(BITS)));
  float val[V::kCodes];
#pragma unroll
  for (int c = 0; c < V::kCodes; ++c) {
    val[c] = __fmul_rn(codevec::signed_mag<BITS>(q, c), scale);
  }
  codevec::store_warp<BITS, WORDS>(val, tiles[warp], out, t0, threads, lane);
}

template <int BITS, int WORDS, bool EAGER>
void launch(const uint32_t* packed, const float* norms, float4* out,
            long long rows, cudaStream_t stream) {
  const long long threads = rows * Vec<BITS, WORDS>::kPerRow;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  unpack_dequantize_kernel<BITS, WORDS, EAGER>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(packed, norms, out, rows);
}

template <int BITS, bool EAGER>
void launch_eager(const uint32_t* packed, const float* norms, float4* out,
                  long long rows, int sms, cudaStream_t stream) {
  if (codevec::use_wide<BITS>(rows, sms)) {
    launch<BITS, 4, EAGER>(packed, norms, out, rows, stream);
  } else {
    launch<BITS, 1, EAGER>(packed, norms, out, rows, stream);
  }
}

template <int BITS>
void launch_bits(const uint32_t* packed, const float* norms, float4* out,
                 long long rows, int sms, int eager, cudaStream_t stream) {
  if (eager) {
    launch_eager<BITS, true>(packed, norms, out, rows, sms, stream);
  } else {
    launch_eager<BITS, false>(packed, norms, out, rows, sms, stream);
  }
}

}  // namespace

extern "C" int qsgd_unpack_dequantize(const void* packed, const void* norms,
                                      void* out, long long rows, int bits,
                                      int eager, void* stream) {
  int sms = 0;
  const cudaError_t err = qsgd::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const auto p = (const uint32_t*)packed;
  const auto n = (const float*)norms;
  const auto o = (float4*)out;
  const auto s = (cudaStream_t)stream;
  switch (bits) {
    case 2: launch_bits<2>(p, n, o, rows, sms, eager, s); break;
    case 4: launch_bits<4>(p, n, o, rows, sms, eager, s); break;
    case 8: launch_bits<8>(p, n, o, rows, sms, eager, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
