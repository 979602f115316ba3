// silu and its gradient by the reference's law, one launch each way.
//
// No Pallas counterpart: the reference's silu is jax.nn.silu inside its
// jitted model, which XLA:CPU compiles (logistic expanded) as
//   s  = 1 / (1 + exp(-x))                      (add_divide fusion)
//   y  = x * s
//   gx = fma(g, s, (g * x) * (s * (1 - s)))      (the vjp, first product
//                                                 fused into the add)
// with its own f32 exp (xla_math.cuh) under flush-to-zero and
// denormals-are-zero: a subnormal operand reads as a zero of its sign and
// a subnormal result becomes one. The plain version is kernels/xla_math.py
// (silu_fwd, silu_bwd); every operation here is the one it runs, as an _rn
// intrinsic (__fmaf_rn where XLA contracts a product into an add), built
// with -fmad=false and without -ftz, so the flush is spelled (xla::ftz)
// exactly where the plain version applies it. 1 / d is __frcp_rn(d), the
// correctly rounded reciprocal, the same bits as the IEEE division
// __fdiv_rn(1, d) without its general slow path.
//
// Forward:  x (n,) -> y (n,), f32.
// Backward: g, x (n,) -> gx (n,), f32; s is recomputed from x, the same
// bits as the forward's, so nothing but x is kept between the two.
//
// Bound: bytes. Forward reads 4 and writes 4 B a value, backward reads 8
// and writes 4; about 40 operations a value forward and 48 backward, under
// the card's f32 rate, but their issue time is most of the byte time, so
// the two have to overlap.
//
// Design: each block takes a tile of 4 x 256 vectors of 4 floats; every
// thread issues its four 16-byte streaming loads (eight backward) before
// any arithmetic, so 16 KB (32 KB) a block are in flight while the
// previous tiles compute, then stores with streaming stores (the data is
// touched once). Where a pointer is off the 16-byte grid the same kernel
// runs on single floats; the n % 4 values past the last vector go to the
// first block's first threads. Indices are 64-bit.
#include <cstdint>

#include "xla_math.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // loads a thread has in flight, a tensor

// s = 1 / (1 + exp(-x)) of a flushed x, flushed.
__device__ __forceinline__ float logistic(float x) {
  const float d = __fadd_rn(xla::exp(-x), 1.0f);
  return xla::ftz(__frcp_rn(d));
}

__device__ __forceinline__ float fwd(float xin) {
  const float x = xla::ftz(xin);
  return xla::ftz(__fmul_rn(x, logistic(x)));
}

__device__ __forceinline__ float bwd(float gin, float xin) {
  const float g = xla::ftz(gin);
  const float x = xla::ftz(xin);
  const float s = logistic(x);
  const float u = xla::ftz(__fmul_rn(xla::ftz(__fmul_rn(g, x)),
                                     __fmul_rn(s, __fsub_rn(1.0f, s))));
  return xla::ftz(__fmaf_rn(g, s, u));
}

__device__ __forceinline__ float4 fwd(float4 x) {
  return make_float4(fwd(x.x), fwd(x.y), fwd(x.z), fwd(x.w));
}

__device__ __forceinline__ float4 bwd(float4 g, float4 x) {
  return make_float4(bwd(g.x, x.x), bwd(g.y, x.y), bwd(g.z, x.z),
                     bwd(g.w, x.w));
}

__device__ __forceinline__ float4 ld(const float4* p) { return __ldcs(p); }
__device__ __forceinline__ float ld(const float* p) { return __ldcs(p); }
__device__ __forceinline__ void st(float4* p, float4 v) { __stcs(p, v); }
__device__ __forceinline__ void st(float* p, float v) { __stcs(p, v); }

// V = float4 or float; nv counts V's; `tail` floats follow them (V =
// float4 only), handled by block 0.
template <class V>
__global__ void __launch_bounds__(kThreads)
    silu_fwd_kernel(const float* __restrict__ x, float* __restrict__ y,
                    long long nv, int tail) {
  const V* xv = reinterpret_cast<const V*>(x);
  V* yv = reinterpret_cast<V*>(y);
  const long long tile = static_cast<long long>(kThreads) * kUnroll;
  for (long long t0 = blockIdx.x * tile; t0 < nv;
       t0 += static_cast<long long>(gridDim.x) * tile) {
    V v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = t0 + k * kThreads + threadIdx.x;
      if (i < nv) v[k] = ld(xv + i);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = t0 + k * kThreads + threadIdx.x;
      if (i < nv) st(yv + i, fwd(v[k]));
    }
  }
  if (blockIdx.x == 0 && static_cast<int>(threadIdx.x) < tail) {
    const long long e = 4 * nv + threadIdx.x;
    y[e] = fwd(x[e]);
  }
}

template <class V>
__global__ void __launch_bounds__(kThreads)
    silu_bwd_kernel(const float* __restrict__ g, const float* __restrict__ x,
                    float* __restrict__ gx, long long nv, int tail) {
  const V* gv = reinterpret_cast<const V*>(g);
  const V* xv = reinterpret_cast<const V*>(x);
  V* ov = reinterpret_cast<V*>(gx);
  const long long tile = static_cast<long long>(kThreads) * kUnroll;
  for (long long t0 = blockIdx.x * tile; t0 < nv;
       t0 += static_cast<long long>(gridDim.x) * tile) {
    V a[kUnroll], b[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = t0 + k * kThreads + threadIdx.x;
      if (i < nv) {
        a[k] = ld(gv + i);
        b[k] = ld(xv + i);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = t0 + k * kThreads + threadIdx.x;
      if (i < nv) st(ov + i, bwd(a[k], b[k]));
    }
  }
  if (blockIdx.x == 0 && static_cast<int>(threadIdx.x) < tail) {
    const long long e = 4 * nv + threadIdx.x;
    gx[e] = bwd(g[e], x[e]);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Blocks for nv V's: one a tile, at most 2^20 (the kernels stride past).
unsigned blocks_for(long long nv) {
  const long long tile = static_cast<long long>(kThreads) * kUnroll;
  const long long b = (nv + tile - 1) / tile;
  return static_cast<unsigned>(b < 1 ? 1 : (b < (1 << 20) ? b : (1 << 20)));
}

}  // namespace

// mode == 0: a = x, out = y (b unused).
// mode == 1: a = g, b = x, out = gx.
extern "C" int silu(const float* a, const float* b, float* out, long long n,
                    int mode, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (mode != 0 && mode != 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = aligned16(a) && aligned16(out) &&
                   (mode == 0 || aligned16(b));
  const long long nv = vec ? n / 4 : n;
  const int tail = vec ? static_cast<int>(n % 4) : 0;
  const unsigned blocks = blocks_for(nv);
  if (mode == 0) {
    if (vec) {
      silu_fwd_kernel<float4><<<blocks, kThreads, 0, stream>>>(a, out, nv,
                                                               tail);
    } else {
      silu_fwd_kernel<float><<<blocks, kThreads, 0, stream>>>(a, out, nv, 0);
    }
  } else {
    if (vec) {
      silu_bwd_kernel<float4><<<blocks, kThreads, 0, stream>>>(a, b, out, nv,
                                                               tail);
    } else {
      silu_bwd_kernel<float><<<blocks, kThreads, 0, stream>>>(a, b, out, nv,
                                                              0);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
