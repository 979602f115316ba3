// Batched qsgd quantize + pack with an in-kernel counter-hash dither.
//
// Replaces the TPU kernel repro/kernels/qsgd.py::qsgd_quantize_pack_batch
// (_quantize_pack_batch_kernel, _hash_uniform).
//
// In:  x f32 (B, rows, 128), seeds uint32 (B, 2).
// Out: packed uint8 (B, rows, 128*bits/8), norms f32 (B, rows).
//
// The dither of element (row, lane) of message b is two murmur3 fmix32
// rounds of (seeds[b], element index row*128 + lane), top 24
// bits times 2^-24, in native uint32 arithmetic: the same law as the
// reference, so a message's codes depend neither on the batch nor on the
// tiling. The row body is the single-message kernel's (qsgd_common.cuh):
// one warp per (message, row), eight per block.
//
// Bound: reads 4 B and writes bits/8 B per element (half the single-message
// kernel's reads: no uniforms come in); memory-bound for large messages,
// latency-bound at the CNN's one 624-row broadcast per flush.
#include "qsgd_common.cuh"

namespace {

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

struct HashUniforms {
  uint32_t seed0, seed1, row_base;  // row_base = row * 128
  __device__ __forceinline__ float operator()(int lane) const {
    uint32_t h = fmix32((row_base + (uint32_t)lane) * 0x9E3779B9u + seed0);
    h = fmix32(h ^ seed1);
    return __fmul_rn((float)(h >> 8), 5.9604644775390625e-08f);  // 2^-24
  }
};

__global__ void quantize_pack_batch_kernel(const float* __restrict__ x,
                                           const uint32_t* __restrict__ seeds,
                                           uint8_t* __restrict__ packed,
                                           float* __restrict__ norms,
                                           long long batch, long long rows,
                                           int bits) {
  __shared__ float sq[qsgd::kWarpsPerBlock][qsgd::kLanes];
  const int warp = threadIdx.x / 32;
  const int t = threadIdx.x % 32;
  const long long g = (long long)blockIdx.x * qsgd::kWarpsPerBlock + warp;
  if (g >= batch * rows) return;  // whole warp leaves together
  const long long b = g / rows;
  const long long row = g % rows;
  const int out_lanes = qsgd::kLanes * bits / 8;
  const HashUniforms dither{
      seeds[2 * b], seeds[2 * b + 1], (uint32_t)row * (uint32_t)qsgd::kLanes};
  float v[4];
  qsgd::load_lanes(x + g * qsgd::kLanes, t, v);
  qsgd::quantize_pack_row(v, packed + g * out_lanes, norms + g, sq[warp], t,
                          bits, dither);
}

}  // namespace

extern "C" int qsgd_quantize_pack_batch(const void* x, const void* seeds,
                                        void* packed, void* norms,
                                        long long batch, long long rows,
                                        int bits, void* stream) {
  const long long warps = batch * rows;
  const long long blocks =
      (warps + qsgd::kWarpsPerBlock - 1) / qsgd::kWarpsPerBlock;
  quantize_pack_batch_kernel<<<(unsigned)blocks, qsgd::kWarpsPerBlock * 32,
                               0, (cudaStream_t)stream>>>(
      (const float*)x, (const uint32_t*)seeds, (uint8_t*)packed,
      (float*)norms, batch, rows, bits);
  return (int)cudaGetLastError();
}
