// The cross-entropy's logsumexp by the reference's law: two launches
// forward (the row maximum, then the exps, their sum, the log and + m in
// one pass) and one backward (sm_90a, built with -fmad=false and without
// -ftz).
//
// No Pallas counterpart: the reference's loss takes jax.nn.logsumexp over
// the vocabulary inside its jitted model (repro/models/transformer.py:267),
// which XLA:CPU compiles as
//   m     = max(a), 0 where it is not finite
//   total = sum(exp(a - m))          (law 7: windows of 32, recursively)
//   lse   = log(total) + m
//   da    = (g / total) * exp(a - m) (the vjp; two roundings, no FMA)
// with its own f32 exp and log (xla_math.cuh) under flush-to-zero (each
// subnormal operand and result a zero of its sign, spelled xla::ftz). The
// plain version is kernels/logsumexp.py (``plain_forward``, ``plain_log``,
// ``plain_backward``): xla_math.exp, ref.xla_sum and xla_math.log in
// elementwise torch ops, some 410-520 launches a loss chunk on the card.
//
// Modes of the one entry point, one launch each:
//   4 row max:  a (rows, n) -> up to kMaxParts partial maxima a row, in
//               scratch (nan-propagating, exact in any order).
//   0 forward:  a, the partial maxima -> m (0 where not finite), total,
//               lse.
//   1 sum only: a, m (rows,) the group's maxima -> m fixed in place, total
//               (a vocabulary shard: the ranks' totals are summed before
//               the log).
//   2 log only: total, m (rows,) -> lse = log(total) + m.
//   3 backward: g (rows, one value every g_stride floats), a, m, total
//               -> da (rows, n).
// The loss's forward is modes 4 and 0, its backward mode 3.
//
// Bound: bytes. The forward reads 4 B a value twice (the maximum, then
// the sum; a - m and its exp never reach device memory), the backward
// reads 4 and writes 4; some 27 operations a value each way are far under
// the card's f32 rate.
//
// Design. Row max: each block takes a slice of one row, every thread
// four 16-byte streaming loads in flight (one float a load where the row
// is off the 16-byte grid), a warp-shuffle max, one partial a block; no
// atomics, so nothing needs clearing. Forward: tap_reduce.cuh's plan
// (the tap kernels' law-7 engine: cp.async staging of 1,024-value spans,
// one level-0 window a lane, the short-row and long-row units, the
// per-row completion counter) with a source that first folds the row's
// partial maxima (a warp shuffle) and maps each staged value x to exp(x -
// m) and 0 outside the row; the block that completes a row runs the
// levels above and, in thread 0, the log and + m. Backward: each block
// takes a tile of one row, four 16-byte streaming loads a thread in
// flight before any arithmetic, g / total once a row, streaming stores.
#include <cstdint>

#include "tap_reduce.cuh"
#include "xla_math.cuh"

namespace {

constexpr int kMaxParts = 64;  // partial maxima a row, at most
constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // loads a thread has in flight

// 0 for an infinity or a nan (|v| <= FLT_MAX fails for both)
__device__ __forceinline__ float finite_or_zero(float v) {
  return fabsf(v) <= FLT_MAX ? v : 0.0f;
}

// max that keeps a nan from either side (torch.amax's and XLA's max)
__device__ __forceinline__ float nan_max(float acc, float v) {
  return (v > acc || v != v) ? v : acc;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// Rows of a: each staged value x becomes xla exp(x - m), the subtraction
// rounded once; values outside [0, n) are the law's padding zeros. The
// sums are exps, never negative, as the header's plan needs. m is the
// row's partial maxima folded (forward) or m_in (sum only), 0 where it is
// not finite.
struct ExpRows {
  static constexpr int kSums = 1;
  static constexpr int kVectors = 1;
  static constexpr int kExtraWords = 0;
  const float* a;
  long long n;
  const float* part;  // kMaxParts partial maxima a row, or null
  int parts;          // partials a row that hold values
  const float* m_in;  // the maxima when part is null
  float* m_out;       // the fixed maxima (the finishing block)
  float* total;
  float* lse;         // null in the sum-only mode
  __device__ __forceinline__ const float* vector(long long row, int) const {
    return a + row * n;
  }
  __device__ __forceinline__ void stage_extra(float*, long long, long long,
                                              int) const {}
  // the row's maximum, in every lane of the warp (called warp-wide)
  __device__ __forceinline__ float row_max(long long row, int lane) const {
    if (part == nullptr) return m_in[row];
    float v = -INFINITY;
    for (int j = lane; j < parts; j += 32) {
      v = nan_max(v, part[row * kMaxParts + j]);
    }
    return warp_max(v);
  }
  __device__ __forceinline__ void lane_sums(const float* st, long long row,
                                            long long base, int lane,
                                            float acc[kSums]) const {
    const float sub = finite_or_zero(row_max(row, lane));
    const float* w = st + lane * taps::kRowFloats;
    const long long e0 = base + taps::kWindow * lane;
    float s = acc[0];
    if (e0 >= 0 && e0 + taps::kWindow <= n) {
#pragma unroll
      for (int q = 0; q < taps::kWindow / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(w + 4 * q);
        s = __fadd_rn(s, xla::exp(__fsub_rn(v.x, sub)));
        s = __fadd_rn(s, xla::exp(__fsub_rn(v.y, sub)));
        s = __fadd_rn(s, xla::exp(__fsub_rn(v.z, sub)));
        s = __fadd_rn(s, xla::exp(__fsub_rn(v.w, sub)));
      }
    } else {
      for (int k = 0; k < taps::kWindow; ++k) {
        const long long e = e0 + k;
        if (e >= 0 && e < n) {
          s = __fadd_rn(s, xla::exp(__fsub_rn(w[k], sub)));
        }
      }
    }
    acc[0] = s;
  }
  // thread 0 of the block that completed the row
  __device__ __forceinline__ void finish(long long row,
                                         const float* tot) const {
    float mx = -INFINITY;
    if (part == nullptr) {
      mx = m_in[row];
    } else {
      for (int j = 0; j < parts; ++j) {
        mx = nan_max(mx, part[row * kMaxParts + j]);
      }
    }
    const float mf = finite_or_zero(mx);
    m_out[row] = mf;
    total[row] = tot[0];
    if (lse != nullptr) {
      lse[row] = xla::ftz(__fadd_rn(xla::log(tot[0]), mf));
    }
  }
};

__global__ void __launch_bounds__(taps::kThreads)
    lse_forward_kernel(ExpRows src, taps::Plan plan, float* scratch,
                       unsigned* counters) {
  taps::run(src, plan, scratch, counters);
}

__global__ void lse_log_kernel(const float* total, const float* m,
                               float* lse, long long rows) {
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (r < rows) lse[r] = xla::ftz(__fadd_rn(xla::log(total[r]), m[r]));
}

__device__ __forceinline__ float4 ld(const float4* p) { return __ldcs(p); }
__device__ __forceinline__ float ld(const float* p) { return __ldcs(p); }
__device__ __forceinline__ void st(float4* p, float4 v) { __stcs(p, v); }
__device__ __forceinline__ void st(float* p, float v) { __stcs(p, v); }

__device__ __forceinline__ float nan_max(float acc, float4 v) {
  return nan_max(nan_max(nan_max(nan_max(acc, v.x), v.y), v.z), v.w);
}

// V = float4 (every row on the 16-byte grid) or float; `cols` counts V's.
// Block (x, y) folds the slices x, x + gridDim.x, ... of rows y, y +
// gridDim.y, ... into part[row * kMaxParts + x].
template <class V>
__global__ void __launch_bounds__(kThreads)
    row_max_kernel(const float* __restrict__ a, float* __restrict__ part,
                   long long rows, long long cols) {
  __shared__ float warps[kThreads / 32];
  const long long tile = static_cast<long long>(kThreads) * kUnroll;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const V* ar = reinterpret_cast<const V*>(a) + r * cols;
    float mx = -INFINITY;
    for (long long t0 = blockIdx.x * tile; t0 < cols;
         t0 += static_cast<long long>(gridDim.x) * tile) {
      V v[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const long long i = t0 + k * kThreads + threadIdx.x;
        if (i < cols) v[k] = ld(ar + i);
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const long long i = t0 + k * kThreads + threadIdx.x;
        if (i < cols) mx = nan_max(mx, v[k]);
      }
    }
    mx = warp_max(mx);
    if (threadIdx.x % 32 == 0) warps[threadIdx.x / 32] = mx;
    __syncthreads();
    if (threadIdx.x < 32) {
      mx = warp_max(threadIdx.x < kThreads / 32 ? warps[threadIdx.x]
                                                : -INFINITY);
      if (threadIdx.x == 0) part[r * kMaxParts + blockIdx.x] = mx;
    }
    __syncthreads();
  }
}

__device__ __forceinline__ float grad(float scale, float a, float sub) {
  return xla::ftz(__fmul_rn(scale, xla::exp(__fsub_rn(a, sub))));
}
__device__ __forceinline__ float4 grad(float scale, float4 a, float sub) {
  return make_float4(grad(scale, a.x, sub), grad(scale, a.y, sub),
                     grad(scale, a.z, sub), grad(scale, a.w, sub));
}

// V as row_max_kernel's.
template <class V>
__global__ void __launch_bounds__(kThreads)
    lse_backward_kernel(const float* __restrict__ g, long long g_stride,
                        const float* __restrict__ a,
                        const float* __restrict__ m,
                        const float* __restrict__ total,
                        float* __restrict__ out, long long rows,
                        long long cols) {
  const long long tile = static_cast<long long>(kThreads) * kUnroll;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const float scale =
        xla::ftz(__fdiv_rn(xla::ftz(g[r * g_stride]), total[r]));
    const float sub = m[r];
    const V* ar = reinterpret_cast<const V*>(a) + r * cols;
    V* outr = reinterpret_cast<V*>(out) + r * cols;
    for (long long t0 = blockIdx.x * tile; t0 < cols;
         t0 += static_cast<long long>(gridDim.x) * tile) {
      V v[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const long long i = t0 + k * kThreads + threadIdx.x;
        if (i < cols) v[k] = ld(ar + i);
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const long long i = t0 + k * kThreads + threadIdx.x;
        if (i < cols) st(outr + i, grad(scale, v[k], sub));
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Slices of a row for the row max (at most kMaxParts) and tiles of a row
// for the backward, over `cols` V's.
long long slices(long long cols, long long most) {
  const long long tile = static_cast<long long>(kThreads) * kUnroll;
  const long long t = (cols + tile - 1) / tile;
  return t < 1 ? 1 : (t < most ? t : most);
}

}  // namespace

// a: (rows, n) f32 rows; m, total, lse: (rows,) f32; g: one f32 a row,
// g_stride floats apart; out: (rows, n). `scratch` holds kMaxParts floats a
// row (the partial maxima), then taps::scratch_slots(ceil(n / 1024))
// floats a row; `counters` one unsigned a row that is 0 between launches
// (modes 0 and 1). In mode 0 m is written; in mode 1 it is read and
// fixed in place.
extern "C" int logsumexp(int mode, const float* a, const float* g,
                         long long g_stride, float* m, float* total,
                         float* lse, float* out, long long rows, long long n,
                         float* scratch, unsigned* counters,
                         cudaStream_t stream) {
  if (rows <= 0) return 0;
  if (mode == 2) {
    const long long blocks = (rows + kThreads - 1) / kThreads;
    lse_log_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        total, m, lse, rows);
    return static_cast<int>(cudaGetLastError());
  }
  if (n <= 0 || mode < 0 || mode > 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = n % 4 == 0 && aligned16(a) &&
                   (mode != 3 || aligned16(out));
  const long long cols = vec ? n / 4 : n;
  const unsigned gy = static_cast<unsigned>(rows < 65535 ? rows : 65535);
  if (mode == 0 || mode == 1) {
    const ExpRows src{a, n, mode == 0 ? scratch : nullptr,
                      static_cast<int>(slices(cols, kMaxParts)), m, m, total,
                      mode == 0 ? lse : nullptr};
    return taps::launch(lse_forward_kernel, src, taps::plan_of(n, rows),
                        scratch + rows * kMaxParts, counters, stream);
  }
  if (mode == 4) {
    const dim3 grid(static_cast<unsigned>(slices(cols, kMaxParts)), gy);
    if (vec) {
      row_max_kernel<float4><<<grid, kThreads, 0, stream>>>(a, scratch, rows,
                                                            cols);
    } else {
      row_max_kernel<float><<<grid, kThreads, 0, stream>>>(a, scratch, rows,
                                                           cols);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid(static_cast<unsigned>(slices(cols, 65535)), gy);
  if (vec) {
    lse_backward_kernel<float4><<<grid, kThreads, 0, stream>>>(
        g, g_stride, a, m, total, out, rows, cols);
  } else {
    lse_backward_kernel<float><<<grid, kThreads, 0, stream>>>(
        g, g_stride, a, m, total, out, rows, cols);
  }
  return static_cast<int>(cudaGetLastError());
}
