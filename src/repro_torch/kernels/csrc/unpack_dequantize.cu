// qsgd unpack + dequantize of one message.
//
// Replaces the TPU kernel repro/kernels/qsgd.py::qsgd_unpack_dequantize
// (_unpack_dequantize_kernel -> _unpack_dequantize_block).
//
// In:  packed uint8 (rows, 128*bits/8), norms f32 (rows,).
// Out: f32 (rows, 128) = (sign*mag) * (norm * fl32(1/s)) — the reference's
//      division by s as XLA compiles it under jit, reproduced on purpose.
//
// Mapping: one thread per output element, neighbouring threads on
// neighbouring lanes, so the f32 stores coalesce; the grid's ragged tail is
// masked by element.
//
// Bound: reads bits/8 B and writes 4 B per element; memory-bound for large
// messages (d = 1e8: about 0.45 GB), latency-bound at the CNN's 624 rows.
#include "qsgd_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void unpack_dequantize_kernel(const uint8_t* __restrict__ packed,
                                         const float* __restrict__ norms,
                                         float* __restrict__ out,
                                         long long rows, int bits) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= rows * qsgd::kLanes) return;
  const long long row = i / qsgd::kLanes;
  const int lane = (int)(i % qsgd::kLanes);
  const int in_lanes = qsgd::kLanes * bits / 8;
  const float rcp = __frcp_rn(qsgd::levels(bits));
  const float sm = qsgd::signed_magnitude(packed + row * in_lanes, lane, bits);
  out[i] = __fmul_rn(sm, __fmul_rn(norms[row], rcp));
}

}  // namespace

extern "C" int qsgd_unpack_dequantize(const void* packed, const void* norms,
                                      void* out, long long rows, int bits,
                                      void* stream) {
  const long long blocks = (rows * qsgd::kLanes + kThreads - 1) / kThreads;
  unpack_dequantize_kernel<<<(unsigned)blocks, kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (const float*)norms, (float*)out, rows, bits);
  return (int)cudaGetLastError();
}
