// Threefry-2x32 (20 rounds) and the uniform draw of jax.random, on the card.
//
// The law is the one repro_torch/common/prng.py pins against jax 0.9 with
// jax_threefry_partitionable=True: element i of uniform(key, shape) is
//   (w0, w1) = threefry2x32(key, (0, i)),  b = w0 ^ w1,
//   u = bitcast_f32((b >> 9) | 0x3F800000) - 1.0f,
// one independent cipher call per element, for i < 2^32 (the counter's low
// word; callers check the range). Rotations go through __funnelshift_l, a
// single SHF each.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace threefry {

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void rounds4(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = __funnelshift_l(x1, x1, R0) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, R1) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, R2) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, R3) ^ x0;
}

// (x0, x1) <- threefry2x32((k0, k1), (x0, x1)): five groups of four rounds,
// key injection after each group from the schedule (k0, k1, k0^k1^C240).
__device__ __forceinline__ void cipher(uint32_t k0, uint32_t k1, uint32_t& x0,
                                       uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  rounds4<13, 15, 26, 6>(x0, x1);
  x0 += k1; x1 += k2 + 1u;
  rounds4<17, 29, 16, 24>(x0, x1);
  x0 += k2; x1 += k0 + 2u;
  rounds4<13, 15, 26, 6>(x0, x1);
  x0 += k0; x1 += k1 + 3u;
  rounds4<17, 29, 16, 24>(x0, x1);
  x0 += k1; x1 += k2 + 4u;
  rounds4<13, 15, 26, 6>(x0, x1);
  x0 += k2; x1 += k0 + 5u;
}

// Element i of jax.random.uniform((k0, k1), shape, float32), in [0, 1).
__device__ __forceinline__ float uniform(uint32_t k0, uint32_t k1,
                                         uint32_t i) {
  uint32_t x0 = 0u, x1 = i;
  cipher(k0, k1, x0, x1);
  const uint32_t b = x0 ^ x1;
  return __fsub_rn(__uint_as_float((b >> 9) | 0x3F800000u), 1.0f);
}

}  // namespace threefry
