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
//
// Taps (a separate instantiation; the kernel above is unchanged without
// them): the level-1 window sums of XLA:CPU's sum law (tap_reduce.cuh) of
// the round's three taps on the server side, delta_bar^2, (x_new - x)^2
// (x_new the f32 value before rounding, as the reference squares it) and
// diff^2, each square rounded, into three rows of `windows` floats. Window
// w holds elements [32 w - front, 32 w - front + 32), front = half the
// padding of n to whole windows, so windows split across threads and the
// sums are in order from +0: a block takes tiles of 2,048 elements aligned
// to windows (64 windows), each thread updates 8 elements and writes their
// squares to a padded shared tile, and one thread sums each window in
// order. The 8 elements go as one vector when they lie in [0, n) on a
// 16-byte boundary (front a multiple of 8, as at every gemma2 size, where
// front is 0), else one at a time. Extra bytes: 12 per 32 elements.
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

// The tap rows and the window law of the taps instantiation.
struct Taps {
  float* out;          // 3 rows of `windows` floats
  long long windows;   // ceil(n / 32)
  long long front;     // zeros in front of window 0
};

constexpr int kTile = kThreads * kVec;         // elements per tile
constexpr int kTileWindows = kTile / 32;       // windows per tile
constexpr int kTapSums = 3;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    server_update_taps_kernel(float* buf, T* m, T* x,
                              const T* __restrict__ xhat, long long n,
                              Params p, Taps taps) {
  __shared__ float sq[kTapSums][kTileWindows][33];
  const long long tiles = (taps.windows + kTileWindows - 1) / kTileWindows;
  const bool vec_ok = taps.front % kVec == 0;
  const int local = threadIdx.x * kVec;  // the thread's first tile element
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long e = tile * kTile - taps.front + local;
    float b[kVec], mv[kVec], xv[kVec], hv[kVec];
    float sd[kVec], su[kVec], sf[kVec];
    if (vec_ok && e >= 0 && e + kVec <= n) {
      load8(buf + e, b);
      load8(m + e, mv);
      load8(x + e, xv);
      load8(xhat + e, hv);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float x_old = xv[i];
        sd[i] = __fmul_rn(b[i], p.inv_k);
        update(b[i], mv[i], xv[i], hv[i], p);
        const float upd = __fsub_rn(xv[i], x_old);
        sd[i] = __fmul_rn(sd[i], sd[i]);
        su[i] = __fmul_rn(upd, upd);
        sf[i] = __fmul_rn(b[i], b[i]);
      }
      store8(buf + e, b);
      store8(m + e, mv);
      store8(x + e, xv);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const long long ei = e + i;
        sd[i] = su[i] = sf[i] = 0.0f;
        if (ei < 0 || ei >= n) continue;
        float bv = buf[ei], mi = to_f32(m[ei]), xi = to_f32(x[ei]);
        const float x_old = xi, db = __fmul_rn(bv, p.inv_k);
        update(bv, mi, xi, to_f32(xhat[ei]), p);
        const float upd = __fsub_rn(xi, x_old);
        sd[i] = __fmul_rn(db, db);
        su[i] = __fmul_rn(upd, upd);
        sf[i] = __fmul_rn(bv, bv);
        buf[ei] = bv;
        round_to(mi, m + ei);
        round_to(xi, x + ei);
      }
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int l = local + i;
      sq[0][l / 32][l % 32] = sd[i];
      sq[1][l / 32][l % 32] = su[i];
      sq[2][l / 32][l % 32] = sf[i];
    }
    __syncthreads();
    if (threadIdx.x < kTapSums * kTileWindows) {
      const int s = threadIdx.x / kTileWindows, w = threadIdx.x % kTileWindows;
      const long long win = tile * kTileWindows + w;
      float acc = 0.0f;
#pragma unroll 8
      for (int i = 0; i < 32; ++i) acc = __fadd_rn(acc, sq[s][w][i]);
      if (win < taps.windows) taps.out[s * taps.windows + win] = acc;
    }
    __syncthreads();  // the tile is rewritten by the next iteration
  }
}

template <typename T>
void launch(void* buf, void* m, void* x, const void* xhat, long long n,
            const Params& p, const Taps& taps, int sms,
            cudaStream_t stream) {
  const long long cap = (long long)kBlocksPerSm * sms;
  if (taps.out != nullptr) {
    const long long tiles = (taps.windows + kTileWindows - 1) / kTileWindows;
    server_update_taps_kernel<T>
        <<<(unsigned)(tiles < cap ? tiles : cap), kThreads, 0, stream>>>(
            (float*)buf, (T*)m, (T*)x, (const T*)xhat, n, p, taps);
    return;
  }
  const long long vecs = n / kVec + 1;
  const long long wanted = (vecs + kThreads - 1) / kThreads;
  server_update_kernel<T><<<(unsigned)(wanted < cap ? wanted : cap), kThreads,
                            0, stream>>>((float*)buf, (T*)m, (T*)x,
                                         (const T*)xhat, n, p);
}

}  // namespace

// dtype: 0 for f32 state buffers, 1 for bf16. has_beta 0: no momentum
// (m_new = delta_bar); lr_one 1: server lr 1 (x_new = m_new + x). taps:
// null, or 3 rows of `windows` = ceil(n / 32) floats for the tap sums, the
// windows starting `front` zeros before element 0.
extern "C" int server_update(void* buf, void* m, void* x, const void* xhat,
                             long long n, int dtype, float inv_k, float beta,
                             int has_beta, float lr, int lr_one, void* taps,
                             long long windows, long long front,
                             void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (taps != nullptr && (windows != (n + 31) / 32 || front < 0 ||
                          front >= 32)) {
    return (int)cudaErrorInvalidValue;
  }
  int sms = 0;
  const cudaError_t err = qsgd::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const Params p{inv_k, beta, lr, has_beta != 0, lr_one != 0};
  const Taps t{(float*)taps, windows, front};
  const auto s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: launch<float>(buf, m, x, xhat, n, p, t, sms, s); break;
    case 1: launch<__nv_bfloat16>(buf, m, x, xhat, n, p, t, sms, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
