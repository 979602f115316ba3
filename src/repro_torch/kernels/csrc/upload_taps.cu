// The uploads' metric taps: two scalars per message of a client step's
// (b, d) delta stack, in one launch.
//
// No TPU kernel: the JAX reference computes these taps in XLA inside its
// fused cohort step (repro/obs/taps.py::cohort_tap_rows, with the wire bits
// decoded by decode_qsgd_stack). The port takes them in a kernel of its own
// that sums each message in XLA:CPU's order (tap_reduce.cuh), which
// depends on d alone: a member's tap does not depend on the cohort it was
// batched with, and the card equals the CPU and the reference bit for bit.
//
// In:  deltas f32 (b, d); for qsgd uploads their packed codes uint8
//      (b, rows, 16*bits) and norms f32 (b, rows), rows = ceil(d/128);
//      bits 0 for identity uploads, whose wire is the delta itself.
// Out: f32 (b, 2): per message i, [||delta_i||,
//      ||delta_i - qdq(delta_i)|| / max(||delta_i||, 1e-30)] — 0 for
//      identity, and 0, not NaN, for a zero delta.
//
// qdq is the receiver's decode, the law of unpack_dequantize.cu (K3):
// (sign*mag) * (norm * fl32(1/s)); the decoded values never reach memory.
// As XLA:CPU compiles the reference's tap, the error is one fused
// multiply-add, delta - (sign*mag) * scale rounded once.
//
// Bound: bytes. It reads the deltas once, the codes and the norms once:
// B = 32 over the CNN's 624 rows, qsgd4 11,577,600 B (3.46 us at
// 3.35 TB/s); B = 8 at d = 1e8, 3.625 GB (1.08 ms) — what K2 reads. The
// earlier design (tap_reduce.cuh's two passes of 16 windows a warp, and a
// 64-bit division, a byte load, a norm load and a reciprocal a value) ran
// at 46% of it at d = 1e8.
//
// Design: tap_reduce.cuh's plan, the deltas staged a span of 1,024 values
// at a time with cp.async, the span's code words and norms beside them. The codes of a message are one little-endian bit stream (value e
// at bits [e*bits, e*bits + bits)), so lane l's 32 values are bits+1
// 32-bit words from word floor(e0*bits/32), shifted by a funnel shift
// whose amount is the same for the whole warp; its window touches at
// most two wire rows, so it takes two scales (norm * fl32(1/s), 1/s once a
// launch) and picks one by the index where the second row starts. Every
// lane sums one window of 32 of the two squares in order.
#include "qsgd_common.cuh"
#include "tap_reduce.cuh"

namespace {

// A message's deltas staged a span, its code words and norms beside them,
// and the two squares a value: delta^2 and, for qsgd uploads, (delta -
// qdq(delta))^2 (0 outside [0, d)).
template <int BITS>  // 0: identity uploads, no codes
struct UploadSource {
  static constexpr int kSums = 2;
  static constexpr int kVectors = 1;
  // a span's code words, one more for the shift; one pad word every 32 so
  // that lane l's words (from l * BITS) fall on distinct banks
  static constexpr int kCodeWords = BITS ? 32 * BITS + 1 : 0;
  static constexpr int kCodeSlots = BITS ? kCodeWords + kCodeWords / 32 + 1
                                         : 0;
  static constexpr int kNormSlots = BITS ? 9 : 0;  // wire rows a span meets
  static constexpr int kExtraWords = kCodeSlots + kNormSlots;
  const float* deltas;     // (b, d)
  const uint32_t* codes;   // (b, wire_rows, 4 * BITS) words
  const float* norms;      // (b, wire_rows)
  long long d, wire_rows;
  float inv_levels;        // fl32(1 / s)
  float* out;              // (b, 2)

  __device__ __forceinline__ const float* vector(long long row, int) const {
    return deltas + row * d;
  }

  __device__ __forceinline__ void stage_extra(float* extra, long long row,
                                              long long base,
                                              int lane) const {
    if constexpr (BITS > 0) {
      const long long words = wire_rows * 4 * BITS;
      const uint32_t* w = codes + row * words;
      const long long w0 = (base * BITS) >> 5;
      for (int i = lane; i < kCodeWords; i += 32) {
        const long long wi = w0 + i;
        const bool ok = wi >= 0 && wi < words;
        taps::cp_async4(extra + i + i / 32, ok ? w + wi : w, ok);
      }
      const float* nm = norms + row * wire_rows;
      if (lane < kNormSlots) {
        const long long r = (base >> 7) + lane;
        const bool ok = r >= 0 && r < wire_rows;
        taps::cp_async4(extra + kCodeSlots + lane, ok ? nm + r : nm, ok);
      }
    }
  }

  // Lane l's window of the span: value e0 + i, e0 = base + 32 l. Masked:
  // the window reaches outside [0, d), whose values count 0.
  template <bool kMasked>
  __device__ __forceinline__ void window(const float* xs,
                                         const uint32_t* aw, float sa,
                                         float sb, long long kb, long long lo,
                                         long long hi,
                                         float acc[kSums]) const {
    constexpr uint32_t kMask = (1u << BITS) - 1u;
    constexpr uint32_t kMagMask = (1u << (BITS - 1)) - 1u;
#pragma unroll
    for (int q = 0; q < taps::kWindow / 4; ++q) {
      const float4 v4 = *reinterpret_cast<const float4*>(xs + 4 * q);
      const float* v = &v4.x;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = 4 * q + c;
        const uint32_t code =
            (aw[i * BITS / 32] >> (i * BITS % 32)) & kMask;
        const float mag = (float)(code & kMagMask);
        float sm = (code >> (BITS - 1)) ? -mag : mag;
        if (kMasked) sm = i >= lo && i < hi ? sm : 0.0f;
        const float err = __fmaf_rn(-sm, i >= kb ? sb : sa, v[c]);
        acc[0] = __fadd_rn(acc[0], __fmul_rn(v[c], v[c]));
        acc[1] = __fadd_rn(acc[1], __fmul_rn(err, err));
      }
    }
  }

  __device__ __forceinline__ void lane_sums(const float* st, long long,
                                            long long base, int lane,
                                            float acc[kSums]) const {
    const float* xs = st + lane * taps::kRowFloats;
    if constexpr (BITS == 0) {
#pragma unroll
      for (int q = 0; q < taps::kWindow / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(xs + 4 * q);
        acc[0] = __fadd_rn(acc[0], __fmul_rn(v.x, v.x));
        acc[0] = __fadd_rn(acc[0], __fmul_rn(v.y, v.y));
        acc[0] = __fadd_rn(acc[0], __fmul_rn(v.z, v.z));
        acc[0] = __fadd_rn(acc[0], __fmul_rn(v.w, v.w));
      }
    } else {
      const uint32_t* cw =
          reinterpret_cast<const uint32_t*>(st + taps::kSpanFloats);
      const float* nm = st + taps::kSpanFloats + kCodeSlots;
      const long long e0 = base + taps::kWindow * lane;
      const int shift = (int)((base * BITS) & 31);
      uint32_t wv[BITS + 1];
#pragma unroll
      for (int i = 0; i <= BITS; ++i) {
        const int idx = lane * BITS + i;
        wv[i] = cw[idx + idx / 32];
      }
      uint32_t aw[BITS];
#pragma unroll
      for (int i = 0; i < BITS; ++i) {
        aw[i] = __funnelshift_r(wv[i], wv[i + 1], shift);
      }
      const long long r0 = base >> 7, rb = (e0 + taps::kWindow - 1) >> 7;
      const float sa = __fmul_rn(nm[(e0 >> 7) - r0], inv_levels);
      const float sb = __fmul_rn(nm[rb - r0], inv_levels);
      const long long kb = rb * qsgd::kLanes - e0;  // first value of row rb
      const long long lo = -e0, hi = d - e0;        // values inside [0, d)
      if (lo <= 0 && hi >= taps::kWindow) {
        window<false>(xs, aw, sa, sb, kb, lo, hi, acc);
      } else {
        window<true>(xs, aw, sa, sb, kb, lo, hi, acc);
      }
    }
  }

  __device__ __forceinline__ void finish(long long row,
                                         const float* tot) const {
    const float dn = __fsqrt_rn(tot[0]);
    out[2 * row] = dn;
    out[2 * row + 1] = __fdiv_rn(__fsqrt_rn(tot[1]), fmaxf(dn, 1e-30f));
  }
};

template <int BITS>
__global__ void __launch_bounds__(taps::kThreads)
    upload_taps_kernel(UploadSource<BITS> src, taps::Plan plan,
                       float* partials, unsigned* counters) {
  taps::run(src, plan, partials, counters);
}

template <int BITS>
int launch(const void* deltas, const void* packed, const void* norms,
           long long b, long long d, void* partials, void* counters,
           void* out, cudaStream_t stream) {
  const long long wire_rows = taps::cdiv(d, qsgd::kLanes);
  const float inv =
      BITS ? 1.0f / (float)((1 << (BITS > 0 ? BITS - 1 : 0)) - 1) : 0.0f;
  const UploadSource<BITS> src{(const float*)deltas, (const uint32_t*)packed,
                               (const float*)norms, d, wire_rows, inv,
                               (float*)out};
  return taps::launch(upload_taps_kernel<BITS>, src, taps::plan_of(d, b),
                      (float*)partials, (unsigned*)counters, stream);
}

}  // namespace

// bits 0 (identity; packed and norms may be null), 2, 4 or 8; packed
// 4-byte aligned. `partials` holds b * taps::scratch_slots(ceil(d / 1024))
// * 2 floats; `counters` holds b unsigned that are 0 between launches.
extern "C" int upload_taps(const void* deltas, const void* packed,
                           const void* norms, long long b, long long d,
                           int bits, void* partials, void* counters,
                           void* out, void* stream) {
  if (b <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (bits != 0 && (packed == nullptr || norms == nullptr ||
                    (uintptr_t)packed % 4 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const auto s = (cudaStream_t)stream;
  switch (bits) {
    case 0: return launch<0>(deltas, packed, norms, b, d, partials, counters,
                             out, s);
    case 2: return launch<2>(deltas, packed, norms, b, d, partials, counters,
                             out, s);
    case 4: return launch<4>(deltas, packed, norms, b, d, partials, counters,
                             out, s);
    case 8: return launch<8>(deltas, packed, norms, b, d, partials, counters,
                             out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
