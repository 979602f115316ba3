// qsgd quantize + pack of one flat message with the threefry dither drawn
// inside the kernel: the b=1 upload in one launch.
//
// Replaces the TPU kernel repro/kernels/qsgd.py::qsgd_quantize_pack together
// with the XLA fusion that feeds it jax.random.uniform(key, (rows, 128))
// (repro/kernels/ops.py::qsgd_quantize).
//
// In:  x f32 (n,), key words (k0, k1) by value, the row offset row0;
//      rows = ceil(n / 128).
// Out: packed uint8 (rows, 128*bits/8), norms f32 (rows,); bits in {2,4,8}.
// Computes exactly quantize_pack(pad(x), uniform(key, (rows, 128)), bits):
// the lanes past n read as zeros (zero codes, whatever their dither), and
// the uniform of flat element i = (row0 + row)*128 + lane is threefry.cuh's
// law, for (row0 + rows)*128 < 2^32 (the wrapper checks against the whole
// message's rows). With row0 > 0, x is rows [row0, row0 + rows) of a longer
// message, and its codes are exactly those rows of the whole message's: the
// row-chunked streaming encode (ops.qsgd_quantize_chunk). The uniforms never
// touch memory.
//
// Mapping: the given-uniforms kernel's (quantize_pack.cu): one warp per row,
// four lanes per thread loaded as one float4 (scalar loads only in the
// ragged last row), eight rows per block; each thread runs four
// independent ciphers, one per lane.
//
// Bound: max of bytes and integer issue. Bytes: 4 B of x per element plus
// rows*(16*bits + 4) out (d = 1e8, qsgd4: 0.45 GB, 0.135 ms at 3.35 TB/s).
// Integer work: the cipher and the uniform mapping are counted from this
// kernel's SASS as its int32 instructions minus those of the given-uniforms
// kernel, over the 4 elements of a thread (chip_smoke.py counts them with
// cuobjdump -sass at each run): (459 - 192) / 4 = 66.75 per element with
// CUDA 12.8, against 20 rounds of add, funnel-shift rotate and xor plus 10
// key-injection adds: 47.0 on the int32 ALU and 19.75 IMADs, which issue on
// the FMA pipe (64 lanes per SM each). Bound = n * 47.0 / (132 SMs x 64
// lanes x 1.98 GHz max SM clock) = 0.281 ms at d = 1e8, twice the byte
// bound: the kernel is bound by integer issue, not by memory.
#include "qsgd_common.cuh"
#include "threefry.cuh"

namespace {

struct ThreefryUniforms {
  uint32_t k0, k1, base;  // base = row * 128, the flat index of lane 0
  __device__ __forceinline__ float operator()(int lane) const {
    return threefry::uniform(k0, k1, base + (uint32_t)lane);
  }
};

__global__ void quantize_pack_threefry_kernel(const float* __restrict__ x,
                                              long long n,
                                              uint8_t* __restrict__ packed,
                                              float* __restrict__ norms,
                                              long long rows, int bits,
                                              uint32_t k0, uint32_t k1,
                                              long long row0) {
  __shared__ float sq[qsgd::kWarpsPerBlock][qsgd::kLanes];
  const int warp = threadIdx.x / 32;
  const int t = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * qsgd::kWarpsPerBlock + warp;
  if (row >= rows) return;  // whole warp leaves together
  const long long first = row * qsgd::kLanes + 4 * t;
  float v[4];
  if (first + 4 <= n) {
    qsgd::load_lanes(x + row * qsgd::kLanes, t, v);
  } else {  // the ragged last row: zero padding
    for (int i = 0; i < 4; ++i) v[i] = first + i < n ? x[first + i] : 0.0f;
  }
  const int out_lanes = qsgd::kLanes * bits / 8;
  qsgd::quantize_pack_row(
      v, packed + row * out_lanes, norms + row, sq[warp], t, bits,
      ThreefryUniforms{k0, k1,
                       (uint32_t)(row0 + row) * (uint32_t)qsgd::kLanes});
}

}  // namespace

extern "C" int qsgd_quantize_pack_threefry(const void* x, long long n,
                                           void* packed, void* norms, int bits,
                                           unsigned int k0, unsigned int k1,
                                           long long row0, void* stream) {
  const long long rows = (n + qsgd::kLanes - 1) / qsgd::kLanes;
  const long long blocks =
      (rows + qsgd::kWarpsPerBlock - 1) / qsgd::kWarpsPerBlock;
  quantize_pack_threefry_kernel<<<(unsigned)blocks,
                                  qsgd::kWarpsPerBlock * 32, 0,
                                  (cudaStream_t)stream>>>(
      (const float*)x, n, (uint8_t*)packed, (float*)norms, rows, bits, k0, k1,
      row0);
  return (int)cudaGetLastError();
}
