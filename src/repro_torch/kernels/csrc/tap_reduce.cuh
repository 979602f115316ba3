// Sums of squares in XLA:CPU's order, shared by the metric-tap kernels
// (flush_taps.cu, upload_taps.cu, round_taps.cu; sm_90a, built with
// -fmad=false).
//
// The law is the reference's own: XLA:CPU compiles an f32 jnp.sum of n
// values to reduce-windows of 32 (repro_torch/kernels/ref.py ``xla_sum``
// spells it with elementwise adds for the CPU):
//   * level 0 cuts the n values into ceil(n/32) windows of 32, with
//     floor(pad/2) zeros in front and the rest of the padding behind; each
//     window is summed in order from +0;
//   * each further level takes windows of 32 of the previous level's sums,
//     with that level's own padding split the same way;
//   * when 32 or fewer sums are left they are summed in order.
// The values are squares, never negative, so zeros at the top level
// change no sum: the top level is summed as one window with its values
// first (front_pad 0 there).
//
// The work is mapped onto the card so that every lane of every warp sums
// a level-0 window of its own. A warp takes a span of 1,024 values (one
// level-1 window) of each staged vector at a time: the span is copied to
// shared memory, 36 floats a row of 32 values, with 16-byte cp.async.cg
// (coalesced, through L2 only) where the span lies inside [0, n) and
// starts on 16 bytes, else with 4-byte cp.async (zero-filled outside
// [0, n), any alignment); lane l reads its window (row l) 16 bytes at a
// time, and the 4 floats of padding a row keep the 8 lanes of each such
// read on distinct banks. While the warp sums one span, the copies of its
// next span are in flight (two stages a warp). Lane l sums its window in
// order; the 32 window sums go through shared memory to lanes 0..S-1, each
// of which adds one sum's 32 in order: the level-1 sum.
//
// Two plans, picked by the launcher from the row length and the number of
// rows (the law and so the result depend on n alone):
//   * short rows: a unit is kWarps consecutive level-1 windows, one a
//     warp; each level-1 sum goes to the row's scratch;
//   * long rows: a unit is one level-2 window (32 level-1 windows, 32,768
//     values, level 2's padding added to the offset): each warp sums 8 of
//     its spans, the block adds the 32 level-1 sums in order and writes the
//     level-2 sum, so the tail starts from ceil(n / 32,768) sums a row.
// The grid is persistent (at most the blocks the card holds at once),
// each block taking units blockIdx.x, + gridDim.x, ...; a warp's staging
// runs on across units. A block counts the units of a row it has done
// when it leaves the row (a per-row counter, counted with atomicAdd after
// a __threadfence: once a launch for a single row), and the block whose
// count completes the row runs the levels above the units' sums for it: each level's windows spread
// over the block's threads one (window, sum) each, reading through L2;
// the top level (32 or fewer sums) is read into shared memory and summed
// in order by lanes 0..S-1; the counter goes back to 0 for the next
// launch. Launches that share counters must run on one stream.
//
// The law is recursive: past level 0 it is the same law applied to the
// level-0 sums. So a kernel that writes the level-0 (32-value window) sums
// of a vector (server_update.cu and unpack_dequantize.cu with taps) leaves
// the rest to round_taps.cu, which runs this file's plan over those sums
// with the identity in place of the square.
//
// Every product, difference and sum is an explicit _rn intrinsic.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace taps {

constexpr int kWindow = 32;                 // XLA:CPU's reduce window
constexpr int kWarps = 4;                   // warps a block
constexpr int kThreads = 32 * kWarps;       // threads a block
constexpr long long kSpan = 1024;           // values a level-1 window
constexpr int kRowFloats = kWindow + 4;     // a staged row of 32, padded
constexpr int kSpanFloats = 32 * kRowFloats;  // one staged span of a vector
constexpr int kLongSpans = 32 / kWarps;     // spans a warp takes of a unit
constexpr int kStages = 2;                  // spans of a warp in flight
// long rows from this many level-1 windows in all, and 64 a row
constexpr long long kLongMinSpans = 8192;

__host__ __device__ inline long long cdiv(long long a, long long b) {
  return (a + b - 1) / b;
}

// Zeros in front of a level of m values: half the padding to whole
// windows, rounded down; 0 at the top level (m <= 32).
__host__ __device__ inline long long front_pad(long long m) {
  return m <= kWindow ? 0 : (cdiv(m, kWindow) * kWindow - m) / 2;
}

// Scratch floats a row needs per sum: its level-1 sums and every level
// above them (a geometric series below 2 * l1 + 32); the long plan uses
// less of it.
__host__ __device__ inline long long scratch_slots(long long l1) {
  return 2 * l1 + kWindow;
}

// Where the work of a launch over `rows` rows of n values goes.
struct Plan {
  long long n;       // values a row
  long long rows;
  long long l1;      // level-1 windows a row, ceil(n / 1024)
  long long l1_off;  // level-1 window j covers values from j*1024 - l1_off:
                     // front_pad(n) + 32 * front_pad(ceil(n / 32))
  long long l2_pad;  // long plan: zeros in front of level 1's sums
  long long units;   // units a row
  long long sums;    // sums a row the units write (the tail's first level)
  int spans;         // spans a warp takes of a unit: 1 or kLongSpans
};

__host__ inline Plan plan_of(long long n, long long rows) {
  Plan p;
  p.n = n;
  p.rows = rows;
  const long long l0 = cdiv(n, kWindow);
  p.l1 = cdiv(l0, kWindow);
  p.l1_off = front_pad(n) + kWindow * front_pad(l0);
  const bool long_rows = p.l1 >= 2 * kWindow && rows * p.l1 >= kLongMinSpans;
  if (long_rows) {
    p.l2_pad = front_pad(p.l1);
    p.units = cdiv(p.l1, kWindow);
    p.sums = p.units;
    p.spans = kLongSpans;
  } else {
    p.l2_pad = 0;
    p.units = cdiv(p.l1, kWarps);
    p.sums = p.l1;
    p.spans = 1;
  }
  return p;
}

// 16-byte asynchronous copy global -> shared through L2 only (both
// addresses 16-byte aligned).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

// 4-byte asynchronous copy global -> shared; with `valid` false nothing is
// read and the word is set to 0.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage values [base, base + 1024) of x (n values) into a span buffer:
// value base + 32 r + k at dst[36 r + k], 0 outside [0, n).
__device__ __forceinline__ void stage_span(float* dst, const float* x,
                                           long long n, long long base,
                                           int lane) {
  if (base >= 0 && base + kSpan <= n &&
      reinterpret_cast<uintptr_t>(x + base) % 16 == 0) {
#pragma unroll
    for (int i = 0; i < kWindow / 4; ++i) {
      const int q = lane + 32 * i;  // the span's q-th 4 values
      cp_async16(dst + (q / 8) * kRowFloats + 4 * (q % 8), x + base + 4 * q);
    }
  } else {
#pragma unroll 8
    for (int c = 0; c < kWindow; ++c) {
      const long long e = base + c * kWindow + lane;
      const bool ok = e >= 0 && e < n;
      cp_async4(dst + c * kRowFloats + lane, ok ? x + e : x, ok);
    }
  }
}

// Floats of one stage (P's vectors and its extra words, to 16 bytes), and
// the bytes of dynamic shared memory a block of source P takes: kStages
// stages a warp, each warp's window sums, and the long plan's level-1
// sums of two units.
template <class P>
__host__ __device__ constexpr int stage_floats() {
  return (P::kVectors * kSpanFloats + P::kExtraWords + 3) / 4 * 4;
}

template <class P>
__host__ __device__ constexpr int smem_bytes() {
  return 4 * (kWarps * kStages * stage_floats<P>() +
              kWarps * P::kSums * kRowFloats + 2 * kWindow * P::kSums);
}

// The levels above the units' sums of one row, in the block that finished
// it: `part` holds the row's m sums (x S, sum s of j at j * S + s) and
// takes each further level after the last; the last level of 32 or fewer
// sums goes to top[] (shared) instead, or, when m is 32 or fewer, the
// units' sums are read there. Ends with the row's S totals in tot[]
// (shared).
template <int S>
__device__ __forceinline__ void row_tail(float* part, long long m,
                                         float* top, float* tot) {
  if (m <= kWindow) {
    for (int i = threadIdx.x; i < m * S; i += kThreads) {
      top[i] = __ldcg(part + i);
    }
  }
  long long in = 0, out = m;
  while (m > kWindow) {
    const long long windows = cdiv(m, kWindow), pad = front_pad(m);
    float* dst = windows <= kWindow ? top : part + out * S;
    for (long long task = threadIdx.x; task < windows * S;
         task += kThreads) {
      const long long w = task / S;
      const int s = (int)(task % S);
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < kWindow; ++i) {
        const long long idx = w * kWindow + i - pad;
        acc = __fadd_rn(acc, idx >= 0 && idx < m
                                 ? __ldcg(part + (in + idx) * S + s)
                                 : 0.0f);
      }
      dst[w * S + s] = acc;
    }
    __threadfence_block();
    __syncthreads();
    in = out;
    out += windows;
    m = windows;
  }
  __syncthreads();
  if (threadIdx.x < S) {
    float t = 0.0f;
    for (int j = 0; j < m; ++j) t = __fadd_rn(t, top[j * S + threadIdx.x]);
    tot[threadIdx.x] = t;
  }
  __syncthreads();
}

// The kernel body for a source P, which provides:
//   kSums, kVectors, kExtraWords;
//   const float* vector(long long row, int v): the row's staged vectors;
//   void stage_extra(float* extra, long long row, long long base, int lane):
//     cp.async of its own words of the span (may do nothing);
//   void lane_sums(const float* stage, long long row, long long base,
//                  int lane, float acc[kSums]): lane's level-0 window sums
//     of the span from the staged vectors (vector v at stage + v *
//     kSpanFloats, the extra words after them), values outside [0, n) 0;
//   void finish(long long row, const float* tot): thread 0, the totals.
// `partials` holds scratch_slots(plan.l1) * kSums floats a row,
// `counters` one unsigned a row that is 0 between launches.
template <class P>
__device__ __forceinline__ void run(const P& src, const Plan& plan,
                                    float* partials, unsigned* counters) {
  constexpr int S = P::kSums;
  constexpr int kStage = stage_floats<P>();
  extern __shared__ float4 smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  __shared__ float top[kWindow * S];
  __shared__ float tot[S];
  __shared__ unsigned last;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* stages = smem + warp * kStages * kStage;
  float* wsum = smem + kWarps * kStages * kStage + warp * S * kRowFloats;
  float* l1s = smem + kWarps * kStages * kStage + kWarps * S * kRowFloats;
  const bool long_rows = plan.spans > 1;
  const long long total = plan.rows * plan.units;

  // the level-1 window of span t of unit g for this warp
  auto window_of = [&](long long g, int t, long long& row) {
    row = g / plan.units;
    const long long u = g % plan.units;
    return long_rows ? u * kWindow - plan.l2_pad + warp * kLongSpans + t
                     : u * kWarps + warp;
  };
  // the warp's spans in order: units blockIdx.x, + gridDim.x, ..., each
  // unit's plan.spans
  auto advance = [&](long long& g, int& t) {
    if (++t == plan.spans) {
      t = 0;
      g += gridDim.x;
    }
  };
  // stage the span (g, t) into ring slot `slot` (nothing past the end); one
  // commit group either way
  auto stage = [&](long long g, int t, int slot) {
    if (g < total) {
      long long row;
      const long long j = window_of(g, t, row);
      if (j >= 0 && j < plan.l1) {
        const long long base = j * kSpan - plan.l1_off;
        float* dst = stages + slot * kStage;
#pragma unroll
        for (int v = 0; v < P::kVectors; ++v) {
          stage_span(dst + v * kSpanFloats, src.vector(row, v), plan.n, base,
                     lane);
        }
        src.stage_extra(dst + P::kVectors * kSpanFloats, row, base, lane);
      }
    }
    cp_async_commit();
  };

  long long g = blockIdx.x, ga = g;
  int t = 0, ta = 0, slot = 0, par = 0;
  for (int i = 0; i < kStages - 1; ++i) {  // the first spans in flight
    stage(ga, ta, i);
    advance(ga, ta);
  }
  long long pending = 0;  // units of the current row done since the count
  while (g < total) {
    stage(ga, ta, (slot + kStages - 1) % kStages);
    advance(ga, ta);
    cp_async_wait<kStages - 1>();
    __syncwarp();
    long long row;
    const long long j = window_of(g, t, row);
    const bool live = j >= 0 && j < plan.l1;
    float acc[S];
#pragma unroll
    for (int s = 0; s < S; ++s) acc[s] = 0.0f;
    if (live) {
      src.lane_sums(stages + slot * kStage, row, j * kSpan - plan.l1_off,
                    lane, acc);
    }
#pragma unroll
    for (int s = 0; s < S; ++s) wsum[s * kRowFloats + lane] = acc[s];
    __syncwarp();
    if (lane < S) {
      float l1 = 0.0f;
#pragma unroll 8
      for (int i = 0; i < kWindow; ++i) {
        l1 = __fadd_rn(l1, wsum[lane * kRowFloats + i]);
      }
      if (long_rows) {
        l1s[(par * kWindow + warp * kLongSpans + t) * S + lane] = l1;
      } else if (live) {
        partials[(row * scratch_slots(plan.l1) + j) * S + lane] = l1;
      }
    }
    __syncwarp();  // the stage and the window sums are reused
    slot = (slot + 1) % kStages;
    if (t == plan.spans - 1) {  // the unit is done
      if (long_rows) {
        __syncthreads();
        if (warp == 0 && lane < S) {
          float l2 = 0.0f;
#pragma unroll 8
          for (int i = 0; i < kWindow; ++i) {
            l2 = __fadd_rn(l2, l1s[(par * kWindow + i) * S + lane]);
          }
          partials[(row * scratch_slots(plan.l1) + g % plan.units) * S +
                   lane] = l2;
        }
        par ^= 1;
      }
      // count the row's units done when the block leaves the row: its
      // sums visible first; the block that completes the row runs its tail
      ++pending;
      const long long gn = g + gridDim.x;
      if (gn >= total || gn / plan.units != row) {
        __threadfence();
        __syncthreads();
        if (threadIdx.x == 0) {
          last = (long long)atomicAdd(counters + row, (unsigned)pending) +
                     pending ==
                 plan.units;
        }
        __syncthreads();
        pending = 0;
        if (last) {
          row_tail<S>(partials + row * scratch_slots(plan.l1) * S, plan.sums,
                      top, tot);
          if (threadIdx.x == 0) {
            src.finish(row, tot);
            counters[row] = 0u;
          }
        }
      }
    }
    advance(g, t);
  }
}

template <class P>
using Kernel = void (*)(P, Plan, float*, unsigned*);

// Launch `kernel` (a __global__ that calls run<P>) over `plan` on a
// persistent grid: at most the blocks the card holds at once at P's
// shared memory (asked of the occupancy API once per device).
template <class P>
inline int launch(Kernel<P> kernel, const P& src, const Plan& plan,
                  float* partials, unsigned* counters, cudaStream_t stream) {
  constexpr int smem = smem_bytes<P>();
  static int cached_device = -1, resident = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device != cached_device) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int per_sm = 0, sms = 0;
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, smem);
    }
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    }
    if (err != cudaSuccess) return (int)err;
    if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
    resident = per_sm * sms;
    cached_device = device;
  }
  const long long total = plan.rows * plan.units;
  const unsigned grid =
      (unsigned)(total < resident ? total : (long long)resident);
  kernel<<<grid, kThreads, smem, stream>>>(src, plan, partials, counters);
  return (int)cudaGetLastError();
}

// The flush's tap vector (obs/taps.py FLUSH_TAP_NAMES) from the five sums'
// totals (delta^2, upd^2, diff^2, err^2, q^2) and the K weights, in thread
// 0: correctly rounded roots, ||err|| / max(||diff||, 1e-30), the weights'
// sum in order of k and their minimum (zeros when k is 0).
__device__ inline void tap_vector(const float tot[5], const float* weights,
                                  int k, float* out) {
  float r[5];
#pragma unroll
  for (int s = 0; s < 5; ++s) r[s] = __fsqrt_rn(tot[s]);
  out[0] = r[0];
  out[1] = r[1];
  out[2] = r[2];
  out[3] = __fdiv_rn(r[3], fmaxf(r[2], 1e-30f));
  out[4] = r[4];
  float wsum = 0.0f, wmin = 0.0f;
  if (k > 0) {
    wsum = wmin = weights[0];
    for (int j = 1; j < k; ++j) {
      wsum = __fadd_rn(wsum, weights[j]);
      wmin = fminf(wmin, weights[j]);
    }
  }
  out[5] = wsum;
  out[6] = wmin;
}

}  // namespace taps
