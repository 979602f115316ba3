// qsgd quantize + pack of one message with caller-given uniforms.
//
// Replaces the TPU kernel repro/kernels/qsgd.py::qsgd_quantize_pack
// (_quantize_pack_kernel -> _quantize_pack_block).
//
// In:  x f32 (rows, 128), u f32 (rows, 128) uniforms in [0, 1).
// Out: packed uint8 (rows, 128*bits/8), norms f32 (rows,); bits in {2,4,8}.
//
// Mapping: one warp per 128-lane row, four lanes per thread (one float4
// load of x; a thread's four codes fill bits/2 whole bytes, so no two
// threads share a byte); eight rows per block, the ragged last block masked
// by row. The norm's squares go
// through shared memory so four threads can sum them in the reference's
// order (qsgd_common.cuh).
//
// Bound: it reads 8 B and writes bits/8 B per element plus 4 B per row, so
// it is memory-bound at 3.35 TB/s on an H100 for large messages (d = 1e8:
// about 0.85 GB, 0.25 ms at the bound). At the CNN's 624 rows it moves about
// 0.68 MB and a launch is latency-bound; nothing in the design hides that.
#include "qsgd_common.cuh"

namespace {

struct GivenUniforms {
  const float* u_row;
  __device__ __forceinline__ float operator()(int lane) const {
    return u_row[lane];
  }
};

__global__ void quantize_pack_kernel(const float* __restrict__ x,
                                     const float* __restrict__ u,
                                     uint8_t* __restrict__ packed,
                                     float* __restrict__ norms,
                                     long long rows, int bits) {
  __shared__ float sq[qsgd::kWarpsPerBlock][qsgd::kLanes];
  const int warp = threadIdx.x / 32;
  const int t = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * qsgd::kWarpsPerBlock + warp;
  if (row >= rows) return;  // whole warp leaves together
  const int out_lanes = qsgd::kLanes * bits / 8;
  float v[4];
  qsgd::load_lanes(x + row * qsgd::kLanes, t, v);
  qsgd::quantize_pack_row(v, packed + row * out_lanes, norms + row, sq[warp],
                          t, bits, GivenUniforms{u + row * qsgd::kLanes});
}

}  // namespace

extern "C" int qsgd_quantize_pack(const void* x, const void* u, void* packed,
                                  void* norms, long long rows, int bits,
                                  void* stream) {
  const long long blocks =
      (rows + qsgd::kWarpsPerBlock - 1) / qsgd::kWarpsPerBlock;
  quantize_pack_kernel<<<(unsigned)blocks, qsgd::kWarpsPerBlock * 32, 0,
                         (cudaStream_t)stream>>>(
      (const float*)x, (const float*)u, (uint8_t*)packed, (float*)norms,
      rows, bits);
  return (int)cudaGetLastError();
}
