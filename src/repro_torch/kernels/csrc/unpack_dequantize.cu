// qsgd unpack + dequantize of one message.
//
// Replaces the TPU kernel repro/kernels/qsgd.py::qsgd_unpack_dequantize
// (_unpack_dequantize_kernel -> _unpack_dequantize_block).
//
// In:  packed uint8 (rows, 128*bits/8), norms f32 (rows,).
// Out: f32 (rows, 128) = (sign*mag) * (norm * fl32(1/s)) — the reference's
//      division by s as XLA compiles it under jit, reproduced on purpose;
//      with eager != 0, (sign*mag) * (norm / s) with a true division, the
//      reference's decode run op by op (its non-fused flush chain).
// Accumulating modes, written over an accumulator acc of n values in
// place (nothing past n is written):
//      apply: acc[e] = fma(sign*mag, norm * fl32(1/s), acc[e]), the decode
//      fused into the add that consumes it, as XLA:CPU compiles the
//      reference round's hidden-state apply x-hat + q
//      (repro/distributed/steps.py:194); acc is f32 or bf16 (the result
//      rounded to nearest even): x-hat of an f32 or a bf16 state;
//      weighted, with a weight w (one f32 on the card): acc[e] =
//      fma((sign*mag) * (norm * fl32(1/s)), w, acc[e]), the decoded value
//      rounded, then its weighted add fused, as XLA:CPU compiles the
//      round's buf + w_k * dec (repro/distributed/steps.py:170); acc f32.
//
// Taps, with apply (a separate kernel; the kernels above are unchanged
// without them): the round's two broadcast taps as level-1 window sums of
// XLA:CPU's sum law (tap_reduce.cuh), reading the diff the broadcast
// encoded (f32, n values): err^2 with err = fma(-(sign*mag), scale, diff),
// the decode's last product fused into the subtraction as XLA:CPU compiles
// the reference round's diff - q, and q^2 with q = (sign*mag) * scale
// rounded (the materialized decode, not the fused apply's), each square
// rounded, into two rows of `windows` floats. A thread owns one window of
// 32 elements ([32 w - front, 32 w - front + 32)), applies its elements
// and sums the squares in order from +0. At 4 bits with front 0 (every
// gemma2 size) a window is one 16-byte code vector, and a warp's 32
// windows (1,024 elements) pass their acc and diff values through shared
// memory: the warp loads and stores them 16 bytes a lane, coalesced, and
// a thread reads its window's 32 values from a tile padded to 33 floats a
// row (no bank conflicts); otherwise each element's code word, norm, acc
// and diff are read one at a time. Extra bytes: 4 per element (diff) and
// 8 per 32 elements.
//
// Bound: bytes. It reads bits/8 B per element plus 4 B per row and writes
// 4 B per element (d = 1e8, qsgd4: 0.45 GB, 0.135 ms at 3.35 TB/s); at the
// CNN's 624 rows a launch is latency-bound. An accumulating mode also
// reads acc.
//
// Design: buffer_aggregate.cu's decode at K = 1 with a unit weight, on
// code_vec.cuh. A thread owns one 16-byte code vector (a quarter row at 4
// bits), or one word when the message is too small to fill the card, loads
// its row's norm once and computes scale = norm * fl32(1/s) once, decodes
// with the funnel shift and writes sign*mag * scale as float4 stores through
// the warp's swizzled shared tile: each warp-wide store covers whole
// 128-byte lines. The accumulating modes have a kernel of their own: a
// thread decodes its code vector, reads its acc values 16 bytes at a time
// (one at a time at the ragged end) and writes its results back to the same
// places, so no thread writes what another reads.
#include <cuda_bf16.h>

#include "code_vec.cuh"

namespace {

using codevec::kThreads;
using codevec::kWarps;
using codevec::Vec;

// The scale and the output of one decode: plain sign*mag * scale, eager
// (scale by a true division); in place, apply fma(sign*mag, scale, acc),
// weighted fma(sign*mag * scale, w, acc).
enum Mode { kPlain, kEager, kApply, kWeighted };

template <int BITS, int WORDS, int MODE>
__global__ void __launch_bounds__(kThreads)
    unpack_dequantize_kernel(const uint32_t* __restrict__ packed,
                             const float* __restrict__ norms,
                             float4* __restrict__ out, long long rows) {
  using V = Vec<BITS, WORDS>;
  __shared__ float4 tiles[kWarps][32 * V::kPass];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long threads = rows * V::kPerRow;
  const long long t0 = ((long long)blockIdx.x * kWarps + warp) * 32;
  // lanes past the end recompute the last thread's codes and store
  // nothing, so the whole warp reaches the passes through shared memory
  const long long t = min(t0 + lane, threads - 1);
  uint32_t q[WORDS];
  codevec::load_words<WORDS>(packed + t * WORDS, q);
  const float norm = __ldg(norms + t / V::kPerRow);
  const float scale =
      MODE == kEager ? __fdiv_rn(norm, (float)qsgd::levels(BITS))
                     : __fmul_rn(norm, __frcp_rn(qsgd::levels(BITS)));
  float val[V::kCodes];
#pragma unroll
  for (int c = 0; c < V::kCodes; ++c) {
    val[c] = __fmul_rn(codevec::signed_mag<BITS>(q, c), scale);
  }
  codevec::store_warp<BITS, WORDS>(val, tiles[warp], out, t0, threads, lane);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void round_to(float v, float* out) { *out = v; }
__device__ __forceinline__ void round_to(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

// The accumulating modes, written over acc (n values of T): a thread decodes
// one 16-byte code vector and updates its kCodes contiguous acc values, 8 at
// a time through 16-byte loads and stores when they all lie before n.
template <int BITS, int MODE, typename T>
__global__ void __launch_bounds__(kThreads)
    unpack_dequantize_acc_kernel(const uint32_t* __restrict__ packed,
                                 const float* __restrict__ norms, T* acc,
                                 long long n,
                                 const float* __restrict__ weight,
                                 long long rows) {
  using V = Vec<BITS, 4>;
  constexpr int kGroup = 8;                   // values per pass
  constexpr int kWords = sizeof(T) * kGroup / 16;  // 16-byte words per pass
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= rows * V::kPerRow) return;
  const long long e0 = t * V::kCodes;
  if (e0 >= n) return;  // the zero padding of the last row
  uint32_t q[4];
  codevec::load_words<4>(packed + t * 4, q);
  const float norm = __ldg(norms + t / V::kPerRow);
  const float scale = __fmul_rn(norm, __frcp_rn(qsgd::levels(BITS)));
  const float w = MODE == kWeighted ? __ldg(weight) : 0.0f;
  const bool whole = e0 + V::kCodes <= n;
#pragma unroll
  for (int g = 0; g < V::kCodes / kGroup; ++g) {
    T* a = acc + e0 + kGroup * g;
    uint4 raw[kWords] = {};
    T* vals = reinterpret_cast<T*>(raw);
    if (whole) {
#pragma unroll
      for (int i = 0; i < kWords; ++i) raw[i] = reinterpret_cast<uint4*>(a)[i];
    } else {
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        if (e0 + kGroup * g + i < n) vals[i] = a[i];
      }
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const float sm = codevec::signed_mag<BITS>(q, kGroup * g + i);
      const float old = to_f32(vals[i]);
      round_to(MODE == kApply ? __fmaf_rn(sm, scale, old)
                              : __fmaf_rn(__fmul_rn(sm, scale), w, old),
               vals + i);
    }
    if (whole) {
#pragma unroll
      for (int i = 0; i < kWords; ++i) reinterpret_cast<uint4*>(a)[i] = raw[i];
    } else {
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        if (e0 + kGroup * g + i < n) a[i] = vals[i];
      }
    }
  }
}

// The tap rows and the window law of the taps kernel.
struct Taps {
  const float* diff;   // n values
  float* out;          // 2 rows of `windows` floats: err^2, q^2 sums
  long long windows;   // ceil(n / 32)
  long long front;     // zeros in front of window 0
};

// One element of the taps kernel: the apply over acc, and the squares.
__device__ __forceinline__ float apply_tap(float sm, float scale, float old,
                                          float diff, float& s_err,
                                          float& s_q) {
  const float q = __fmul_rn(sm, scale);
  const float err = __fmaf_rn(-sm, scale, diff);
  s_err = __fadd_rn(s_err, __fmul_rn(err, err));
  s_q = __fadd_rn(s_q, __fmul_rn(q, q));
  return __fmaf_rn(sm, scale, old);
}

// The apply (acc[e] = fma(sign*mag, scale, acc[e])) with the taps, one
// window per thread, each element's code word, norm, acc and diff read
// one at a time (any bit width and front padding).
template <int BITS, typename T>
__global__ void __launch_bounds__(kThreads)
    unpack_dequantize_taps_kernel(const uint32_t* __restrict__ packed,
                                  const float* __restrict__ norms, T* acc,
                                  long long n, Taps taps) {
  const long long w = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (w >= taps.windows) return;
  const float rcp = __frcp_rn(qsgd::levels(BITS));
  const long long e0 = w * 32 - taps.front;
  float s_err = 0.0f, s_q = 0.0f;
  for (int i = 0; i < 32; ++i) {
    const long long e = e0 + i;
    if (e < 0 || e >= n) continue;  // zeros of the padding add nothing
    const long long row = e / qsgd::kLanes;
    const int lane = (int)(e % qsgd::kLanes);
    const uint32_t word = __ldg(packed + row * 4 * BITS + lane * BITS / 32);
    const float sm = codevec::signed_mag<BITS>(&word, lane % (32 / BITS));
    const float scale = __fmul_rn(__ldg(norms + row), rcp);
    round_to(apply_tap(sm, scale, to_f32(acc[e]), __ldg(taps.diff + e),
                       s_err, s_q),
             acc + e);
  }
  taps.out[w] = s_err;
  taps.out[taps.windows + w] = s_q;
}

// The taps kernel at 4 bits with front 0: window w is code vector w, and
// each warp stages its 32 windows' acc and diff values in shared memory.
constexpr int kSpan = 32 * 32;       // elements of a warp's 32 windows
constexpr int kRow = 33;             // padded floats per window in a tile

template <typename T>
__global__ void __launch_bounds__(kThreads)
    unpack_dequantize_taps_staged_kernel(const uint32_t* __restrict__ packed,
                                         const float* __restrict__ norms,
                                         T* acc, long long n, Taps taps) {
  __shared__ float tile_acc[kWarps][32 * kRow];
  __shared__ float tile_diff[kWarps][32 * kRow];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long w0 = ((long long)blockIdx.x * kWarps + warp) * 32;
  if (w0 >= taps.windows) return;  // whole warps only
  const long long e_base = w0 * 32;
  float* sa = tile_acc[warp];
  float* sd = tile_diff[warp];
  // element j of the span sits at j + j / 32 of a tile
  constexpr int kPerLoad = 16 / sizeof(T);  // acc values per 16 bytes
  if (e_base + kSpan <= n) {
#pragma unroll
    for (int i = 0; i < kSpan / 4 / 32; ++i) {
      const int j = 4 * (i * 32 + lane);
      const float4 d = __ldg(reinterpret_cast<const float4*>(
          taps.diff + e_base + j));
      const int r = j + j / 32;
      sd[r] = d.x;
      sd[r + 1] = d.y;
      sd[r + 2] = d.z;
      sd[r + 3] = d.w;
    }
#pragma unroll
    for (int i = 0; i < kSpan / kPerLoad / 32; ++i) {
      const int j = kPerLoad * (i * 32 + lane);
      const uint4 raw = *reinterpret_cast<const uint4*>(acc + e_base + j);
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int c = 0; c < kPerLoad; ++c) sa[j + c + (j + c) / 32] = to_f32(v[c]);
    }
  } else {
    for (int j = lane; j < kSpan; j += 32) {
      const long long e = e_base + j;
      sd[j + j / 32] = e < n ? __ldg(taps.diff + e) : 0.0f;
      sa[j + j / 32] = e < n ? to_f32(acc[e]) : 0.0f;
    }
  }
  __syncwarp();
  const long long w = w0 + lane;
  if (w < taps.windows) {
    uint32_t q[4];
    codevec::load_words<4>(packed + w * 4, q);
    const float scale =
        __fmul_rn(__ldg(norms + w / 4), __frcp_rn(qsgd::levels(4)));
    float s_err = 0.0f, s_q = 0.0f;
    float* ra = sa + lane * kRow;
    const float* rd = sd + lane * kRow;
#pragma unroll 8
    for (int i = 0; i < 32; ++i) {
      const float sm = codevec::signed_mag<4>(q, i);
      float e_sq = 0.0f, q_sq = 0.0f;
      const float v = apply_tap(sm, scale, ra[i], rd[i], e_sq, q_sq);
      if (w * 32 + i < n) {  // padding past n adds +0
        ra[i] = v;
        s_err = __fadd_rn(s_err, e_sq);
        s_q = __fadd_rn(s_q, q_sq);
      }
    }
    taps.out[w] = s_err;
    taps.out[taps.windows + w] = s_q;
  }
  __syncwarp();
  if (e_base + kSpan <= n) {
#pragma unroll
    for (int i = 0; i < kSpan / kPerLoad / 32; ++i) {
      const int j = kPerLoad * (i * 32 + lane);
      uint4 raw;
      T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int c = 0; c < kPerLoad; ++c) round_to(sa[j + c + (j + c) / 32], v + c);
      *reinterpret_cast<uint4*>(acc + e_base + j) = raw;
    }
  } else {
    for (int j = lane; j < kSpan; j += 32) {
      if (e_base + j < n) round_to(sa[j + j / 32], acc + e_base + j);
    }
  }
}

template <int BITS, typename T>
void launch_taps(const uint32_t* packed, const float* norms, void* acc,
                 long long n, const Taps& taps, cudaStream_t stream) {
  const long long blocks = (taps.windows + kThreads - 1) / kThreads;
  if (BITS == 4 && taps.front == 0) {
    unpack_dequantize_taps_staged_kernel<T>
        <<<(unsigned)blocks, kThreads, 0, stream>>>(packed, norms, (T*)acc,
                                                    n, taps);
  } else {
    unpack_dequantize_taps_kernel<BITS, T>
        <<<(unsigned)blocks, kThreads, 0, stream>>>(packed, norms, (T*)acc,
                                                    n, taps);
  }
}

struct Args {
  const uint32_t* packed;
  const float* norms;
  void* out;            // the output, or the accumulator
  long long n;          // the accumulator's length
  const float* weight;  // null: no weight
  long long rows;
};

template <int BITS, int MODE, typename T>
void launch_acc(const Args& a, cudaStream_t stream) {
  const long long threads = a.rows * Vec<BITS, 4>::kPerRow;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  unpack_dequantize_acc_kernel<BITS, MODE, T>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(
          a.packed, a.norms, (T*)a.out, a.n, a.weight, a.rows);
}

template <int BITS, int WORDS, int MODE>
void launch(const Args& a, cudaStream_t stream) {
  const long long threads = a.rows * Vec<BITS, WORDS>::kPerRow;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  unpack_dequantize_kernel<BITS, WORDS, MODE>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(a.packed, a.norms,
                                                  (float4*)a.out, a.rows);
}

template <int BITS, int MODE>
void launch_width(const Args& a, int sms, cudaStream_t stream) {
  if (codevec::use_wide<BITS>(a.rows, sms)) {
    launch<BITS, 4, MODE>(a, stream);
  } else {
    launch<BITS, 1, MODE>(a, stream);
  }
}

enum Acc { kNone = 0, kF32 = 1, kBf16 = 2 };

template <int BITS>
void launch_bits(const Args& a, int sms, int eager, int acc,
                 const Taps& taps, cudaStream_t stream) {
  if (taps.out != nullptr) {
    if (acc == kBf16) {
      launch_taps<BITS, __nv_bfloat16>(a.packed, a.norms, a.out, a.n, taps,
                                       stream);
    } else {
      launch_taps<BITS, float>(a.packed, a.norms, a.out, a.n, taps, stream);
    }
  } else if (acc == kNone) {
    if (eager) {
      launch_width<BITS, kEager>(a, sms, stream);
    } else {
      launch_width<BITS, kPlain>(a, sms, stream);
    }
  } else if (a.weight != nullptr) {
    launch_acc<BITS, kWeighted, float>(a, stream);
  } else if (acc == kBf16) {
    launch_acc<BITS, kApply, __nv_bfloat16>(a, stream);
  } else {
    launch_acc<BITS, kApply, float>(a, stream);
  }
}

}  // namespace

// acc 0: `out` is a fresh f32 (rows, 128) output (`n`, `weight` unused).
// acc 1 (f32) or 2 (bf16, no weight): `out` is an accumulator of n <=
// rows*128 values, updated in place with the jitted scale (eager 0);
// `weight` (one f32 on the device, f32 only) may be null. taps (the apply,
// no weight): null, or 2 rows of `windows` = ceil(n / 32) floats for the
// tap sums over `tap_diff` (n f32 values), the windows starting `front`
// zeros before element 0.
extern "C" int qsgd_unpack_dequantize(const void* packed, const void* norms,
                                      void* out, long long rows, int bits,
                                      int eager, long long n,
                                      const void* weight, int acc,
                                      const void* tap_diff, void* taps,
                                      long long windows, long long front,
                                      void* stream) {
  if (acc < kNone || acc > kBf16) return (int)cudaErrorInvalidValue;
  if (acc != kNone && (eager || n < 0 || n > rows * qsgd::kLanes)) {
    return (int)cudaErrorInvalidValue;
  }
  if (weight != nullptr && acc != kF32) return (int)cudaErrorInvalidValue;
  if (taps != nullptr &&
      (acc == kNone || weight != nullptr || tap_diff == nullptr || n <= 0 ||
       windows != (n + 31) / 32 || front < 0 || front >= 32)) {
    return (int)cudaErrorInvalidValue;
  }
  int sms = 0;
  const cudaError_t err = qsgd::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const Args a{(const uint32_t*)packed, (const float*)norms, out, n,
               (const float*)weight, rows};
  const Taps t{(const float*)tap_diff, (float*)taps, windows, front};
  const auto s = (cudaStream_t)stream;
  switch (bits) {
    case 2: launch_bits<2>(a, sms, eager, acc, t, s); break;
    case 4: launch_bits<4>(a, sms, eager, acc, t, s); break;
    case 8: launch_bits<8>(a, sms, eager, acc, t, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
