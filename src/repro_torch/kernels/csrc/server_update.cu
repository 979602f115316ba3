// The QAFeL round's server update in one pass over d, in place.
//
// No Pallas counterpart: the reference computes this in XLA inside its
// jitted round (repro/distributed/steps.py:172-181, server_apply_flat and
// the broadcast diff), which XLA:CPU compiles as
//   delta_bar = buf * fl32(1/K)
//   m_new     = fma(m, beta, delta_bar)     (no momentum: delta_bar)
//   x_new     = m_new + x                   (server lr 1; else fma(m_new, lr, x))
//   diff      = x_new - x_hat
// and rounds x_new and m_new to the state's dtype where its layout.unflatten
// ends the round. Every operation here is that one, as an _rn intrinsic
// (built with -fmad=false).
//
// In:  buf f32 (n,), the clients' weighted sum; m, x, x_hat (n,) in the
//      state's dtype T (float or bf16).
// Out: buf <- diff (f32), m <- T(m_new), x <- T(x_new), rounded to nearest
//      even; x_hat is read only.
//
// Bound: bytes. Per element it reads buf and m, x, x_hat and writes buf, m
// and x: 4 + 3*sizeof(T) + 4 + 2*sizeof(T) = 18 B at bf16, 28 B at f32
// (gemma2-2b at d = 2.61e9: 47.06 GB, 14.0 ms at 3.35 TB/s). Seven flops an
// element are far under the card's rate.
//
// Design: a grid-stride loop over vectors of 8 elements, every load and
// store 16 bytes (bf16: one vector of each state buffer, two of buf); the
// tail past the last whole vector runs one element a thread. Each element
// is read and written by one thread, so the update is safely in place. The
// wrapper checks 16-byte alignment of the four buffers.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "qsgd_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kVec = 8;  // elements per vector

struct Params {
  float inv_k, beta, lr;
  bool has_beta, lr_one;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void round_to(float v, float* out) { *out = v; }
__device__ __forceinline__ void round_to(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

// 8 values of T at p (16-byte aligned) as floats, and back.
template <typename T>
__device__ __forceinline__ void load8(const T* p, float v[kVec]) {
  constexpr int kWords = sizeof(T) * kVec / 16;
  uint4 raw[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) raw[i] = reinterpret_cast<const uint4*>(p)[i];
  const T* e = reinterpret_cast<const T*>(raw);
#pragma unroll
  for (int i = 0; i < kVec; ++i) v[i] = to_f32(e[i]);
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float v[kVec]) {
  constexpr int kWords = sizeof(T) * kVec / 16;
  uint4 raw[kWords];
  T* e = reinterpret_cast<T*>(raw);
#pragma unroll
  for (int i = 0; i < kVec; ++i) round_to(v[i], e + i);
#pragma unroll
  for (int i = 0; i < kWords; ++i) reinterpret_cast<uint4*>(p)[i] = raw[i];
}

// One element: buf, m, x in; diff, m_new, x_new out (the header's law).
__device__ __forceinline__ void update(float& b, float& m, float& x, float xh,
                                       const Params& p) {
  const float delta_bar = __fmul_rn(b, p.inv_k);
  const float m_new = p.has_beta ? __fmaf_rn(m, p.beta, delta_bar) : delta_bar;
  const float x_new = p.lr_one ? __fadd_rn(m_new, x) : __fmaf_rn(m_new, p.lr, x);
  b = __fsub_rn(x_new, xh);
  m = m_new;
  x = x_new;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    server_update_kernel(float* buf, T* m, T* x, const T* __restrict__ xhat,
                         long long n, Params p) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long vecs = n / kVec;
  for (long long v = first; v < vecs; v += stride) {
    const long long e = v * kVec;
    float b[kVec], mv[kVec], xv[kVec], hv[kVec];
    load8(buf + e, b);
    load8(m + e, mv);
    load8(x + e, xv);
    load8(xhat + e, hv);
#pragma unroll
    for (int i = 0; i < kVec; ++i) update(b[i], mv[i], xv[i], hv[i], p);
    store8(buf + e, b);
    store8(m + e, mv);
    store8(x + e, xv);
  }
  for (long long e = vecs * kVec + first; e < n; e += stride) {
    float b = buf[e], mv = to_f32(m[e]), xv = to_f32(x[e]);
    update(b, mv, xv, to_f32(xhat[e]), p);
    buf[e] = b;
    round_to(mv, m + e);
    round_to(xv, x + e);
  }
}

template <typename T>
void launch(void* buf, void* m, void* x, const void* xhat, long long n,
            const Params& p, int sms, cudaStream_t stream) {
  const long long vecs = n / kVec + 1;
  const long long wanted = (vecs + kThreads - 1) / kThreads;
  const long long cap = (long long)kBlocksPerSm * sms;
  server_update_kernel<T><<<(unsigned)(wanted < cap ? wanted : cap), kThreads,
                            0, stream>>>((float*)buf, (T*)m, (T*)x,
                                         (const T*)xhat, n, p);
}

}  // namespace

// dtype: 0 for f32 state buffers, 1 for bf16. has_beta 0: no momentum
// (m_new = delta_bar); lr_one 1: server lr 1 (x_new = m_new + x).
extern "C" int server_update(void* buf, void* m, void* x, const void* xhat,
                             long long n, int dtype, float inv_k, float beta,
                             int has_beta, float lr, int lr_one,
                             void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  int sms = 0;
  const cudaError_t err = qsgd::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const Params p{inv_k, beta, lr, has_beta != 0, lr_one != 0};
  const auto s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: launch<float>(buf, m, x, xhat, n, p, sms, s); break;
    case 1: launch<__nv_bfloat16>(buf, m, x, xhat, n, p, sms, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
