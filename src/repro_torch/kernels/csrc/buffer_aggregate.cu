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
// Mapping: one thread per output element, looping over k, so each code
// byte and norm is read once per element group and the f32 result written
// once — the minimum traffic of the flush's first stage.
//
// Bound: reads K*(bits/8) B per element plus K*4 B per row, writes 4 B per
// element; memory-bound for large messages (K = 10, d = 1e8, qsgd4: about
// 0.9 GB), latency-bound at the CNN's 624 rows.
#include "qsgd_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void buffer_aggregate_kernel(const uint8_t* __restrict__ packed,
                                        const float* __restrict__ norms,
                                        const float* __restrict__ weights,
                                        float* __restrict__ out, int k_count,
                                        long long rows, int bits) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= rows * qsgd::kLanes) return;
  const long long row = i / qsgd::kLanes;
  const int lane = (int)(i % qsgd::kLanes);
  const int in_lanes = qsgd::kLanes * bits / 8;
  const float rcp = __frcp_rn(qsgd::levels(bits));
  float acc = 0.0f;
  for (int k = 0; k < k_count; ++k) {
    const uint8_t* p_row = packed + ((long long)k * rows + row) * in_lanes;
    const float sm = qsgd::signed_magnitude(p_row, lane, bits);
    const float scale =
        __fmul_rn(__fmul_rn(weights[k], norms[(long long)k * rows + row]), rcp);
    acc = (k_count == 1) ? __fmul_rn(sm, scale) : __fmaf_rn(sm, scale, acc);
  }
  out[i] = acc;
}

}  // namespace

extern "C" int buffer_aggregate(const void* packed, const void* norms,
                                const void* weights, void* out, int k_count,
                                long long rows, int bits, void* stream) {
  const long long blocks = (rows * qsgd::kLanes + kThreads - 1) / kThreads;
  buffer_aggregate_kernel<<<(unsigned)blocks, kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (const float*)norms, (const float*)weights,
      (float*)out, k_count, rows, bits);
  return (int)cudaGetLastError();
}
