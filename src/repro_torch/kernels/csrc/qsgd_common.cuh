// Shared device code of the qsgd wire kernels (sm_90a, built with
// -fmad=false and no fast math).
//
// Rounding is reproduced on purpose, operation by operation, from what the
// JAX reference computes on XLA:CPU (see repro_torch/kernels/ref.py):
//   * bucket norm: four partials, partial w adds x[32w+j]^2 for j = 0..31 in
//     order, multiply and add rounded separately; then ((p0+p1)+p2)+p3 and
//     an IEEE square root;
//   * inv = s / max(norm, 1e-30) as an IEEE division;
//   * dequantize: (sign*mag) * (norm * fl32(1/s));
//   * aggregate: acc = fma(sign*mag, (w_k*n_k) * fl32(1/s), acc).
// Every product and sum is an explicit _rn intrinsic so that no compiler
// setting can contract or reorder it.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace qsgd {

constexpr int kLanes = 128;          // one bucket norm per 128-element row
constexpr int kWarpsPerBlock = 8;    // rows per block of the row kernels
constexpr unsigned kFullMask = 0xffffffffu;

// The current device's SM count (the runtime caches it).
inline cudaError_t sm_count(int* sms) {
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

__device__ __forceinline__ float levels(int bits) {
  return (float)((1 << (bits - 1)) - 1);
}

// Norm of the 128-lane row whose lanes 4t..4t+3 this thread holds in v[].
// `sq` is this warp's 128-float slice of shared memory.
__device__ __forceinline__ float bucket_norm(const float v[4], float* sq,
                                             int t) {
  for (int i = 0; i < 4; ++i) sq[4 * t + i] = __fmul_rn(v[i], v[i]);
  __syncwarp();
  float partial = 0.0f;
  if (t < 4) {
    for (int j = 0; j < 32; ++j) partial = __fadd_rn(partial, sq[32 * t + j]);
  }
  const float p0 = __shfl_sync(kFullMask, partial, 0);
  const float p1 = __shfl_sync(kFullMask, partial, 1);
  const float p2 = __shfl_sync(kFullMask, partial, 2);
  const float p3 = __shfl_sync(kFullMask, partial, 3);
  __syncwarp();  // sq may be rewritten by the warp's next row
  return __fsqrt_rn(__fadd_rn(__fadd_rn(__fadd_rn(p0, p1), p2), p3));
}

// n-bit code of one element: sign bit (MSB) | stochastically rounded level.
__device__ __forceinline__ uint32_t encode(float x, float inv, float u,
                                           int bits, float s) {
  const float level = __fmul_rn(fabsf(x), inv);
  const float low = floorf(level);
  float xi = __fadd_rn(low, (u < __fsub_rn(level, low)) ? 1.0f : 0.0f);
  xi = fminf(xi, s);
  return ((x < 0.0f ? 1u : 0u) << (bits - 1)) | (uint32_t)xi;
}

// Lanes 4t..4t+3 of a 128-lane row as one 16-byte load; the row must be
// 16-byte aligned (the wrappers check the base pointer, rows are 512 B).
__device__ __forceinline__ void load_lanes(const float* __restrict__ x_row,
                                           int t, float v[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(x_row) + t);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// Quantize and pack one row whose lanes 4t..4t+3 thread t holds in v[], so
// a thread's four codes are exactly bits/2 whole output bytes (the codes
// pack little-endian, 8/bits per byte): byte offset t*bits/2 of the row.
// `dither(lane)` is the uniform of that lane.
template <typename Dither>
__device__ __forceinline__ void quantize_pack_row(
    const float v[4], uint8_t* __restrict__ out_row,
    float* __restrict__ norm_out, float* sq, int t, int bits,
    Dither dither) {
  const float norm = bucket_norm(v, sq, t);
  const float s = levels(bits);
  const float inv =
      norm > 0.0f ? __fdiv_rn(s, fmaxf(norm, 1e-30f)) : 0.0f;
  uint32_t word = 0;
  for (int i = 0; i < 4; ++i) {
    word |= encode(v[i], inv, dither(4 * t + i), bits, s) << (i * bits);
  }
  const int nbytes = bits / 2;
  for (int j = 0; j < nbytes; ++j) {
    out_row[t * nbytes + j] = (uint8_t)((word >> (8 * j)) & 0xffu);
  }
  if (t == 0) *norm_out = norm;
}

}  // namespace qsgd
