// XLA:CPU's f32 exp and log, one spelling for every kernel that takes them
// (silu.cu, logsumexp.cu; sm_90a, built with -fmad=false and without
// -ftz).
//
// The plain version is kernels/xla_math.py (exp, log, ftz): every
// operation here is the one it runs, as an _rn intrinsic (__fmaf_rn where
// XLA contracts a product into an add). XLA:CPU runs with flush-to-zero
// and denormals-are-zero on; ftz spells that flush exactly where the plain
// version applies it.
#pragma once

#include <cfloat>
#include <cuda_runtime.h>

namespace xla {

// A subnormal value becomes a zero of its sign; every other value is kept.
__device__ __forceinline__ float ftz(float v) {
  return fabsf(v) < FLT_MIN ? copysignf(0.0f, v) : v;
}

// NaN passes both clamps, as torch.clamp passes it.
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

// XLA:CPU's f32 exp (xla_math.exp): Cephes' expf with XLA's clamps, the
// result flushed; the constants are its f32 values (-87.8, 88.8,
// log2(e), ln 2 in two parts, Cephes' polynomial), in hex.
__device__ __forceinline__ float exp(float x) {
  x = clamp(x, -0x1.5f3334p+6f, 0x1.633334p+6f);
  float n = floorf(__fmaf_rn(x, 0x1.715476p+0f, 0.5f));
  n = clamp(n, -127.0f, 127.0f);
  float a = __fmaf_rn(n, -0x1.63p-1f, x);
  a = __fmaf_rn(n, 0x1.bd0106p-13f, a);
  float z = __fmaf_rn(a, 0x1.a0d2cep-13f, 0x1.6e879cp-10f);
  z = __fmaf_rn(z, a, 0x1.111210p-7f);
  z = __fmaf_rn(z, a, 0x1.555382p-5f);
  z = __fmaf_rn(z, a, 0x1.555554p-3f);
  z = __fmaf_rn(z, a, 0x1.0p-1f);
  z = __fadd_rn(__fmaf_rn(z, __fmul_rn(a, a), a), 1.0f);
  const float pow2 = __int_as_float((static_cast<int>(n) + 127) << 23);
  return ftz(__fmul_rn(z, pow2));
}

// XLA:CPU's f32 log of a positive normal value (xla_math.log): Cephes'
// logf, the mantissa in [sqrt(1/2), sqrt(2)) minus one, the degree-8
// polynomial as three interleaved Horner chains joined over x**3, the
// last product contracted with the exponent term; constants in hex.
__device__ __forceinline__ float log_normal(float x) {
  const int b = __float_as_int(x);
  int e = ((b >> 23) & 0xFF) - 126;
  float m = __int_as_float((b & 0x7FFFFF) | (126 << 23));  // [0.5, 1)
  const bool small = m < 0x1.6a09e6p-1f;
  m = __fadd_rn(__fsub_rn(m, 1.0f), small ? m : 0.0f);
  const float ef = static_cast<float>(e - (small ? 1 : 0));
  const float x2 = __fmul_rn(m, m);
  const float x3 = __fmul_rn(x2, m);
  float y = __fmaf_rn(m, 0x1.204376p-4f, -0x1.d7a37p-4f);
  float y1 = __fmaf_rn(m, -0x1.fcba9ep-4f, 0x1.23d37ep-3f);
  float y2 = __fmaf_rn(m, 0x1.999d58p-3f, -0x1.fffff8p-3f);
  y = __fmaf_rn(y, m, 0x1.de4a34p-4f);
  y1 = __fmaf_rn(y1, m, -0x1.555ca0p-3f);
  y2 = __fmaf_rn(y2, m, 0x1.555554p-2f);
  y = __fmaf_rn(y, x3, y1);
  y = __fmaf_rn(y, x3, y2);
  y = __fmaf_rn(y, x3, __fmul_rn(ef, -0x1.bd0106p-13f));
  m = __fsub_rn(m, __fmul_rn(x2, 0.5f));
  m = __fadd_rn(m, y);
  return __fadd_rn(m, __fmul_rn(ef, 0x1.63p-1f));
}

// The loss's log (kernels/logsumexp.py ``plain_log``): log_normal on positive
// normal values; at 0, the infinities, nan (and, never reached by a sum
// of flushed exps, a subnormal or a negative value) the correctly rounded
// logf, as the plain version takes torch.log there: -inf, inf, nan.
__device__ __forceinline__ float log(float v) {
  return v >= FLT_MIN && v <= FLT_MAX ? log_normal(v) : logf(v);
}

}  // namespace xla
