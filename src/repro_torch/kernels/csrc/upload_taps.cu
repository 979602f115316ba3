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
// 3.35 TB/s); B = 8 at d = 1e8, 3.625 GB (1.08 ms) — what K2 reads.
//
// Design: tap_reduce.cuh's law: a warp reads its level-1 window of 1,024
// values of a message coalesced (decoding each value's code from its byte
// and its row's norm), stages the two squares through shared memory so that
// a lane sums one window of 32 in order, and adds the 32 window sums in
// order; a block of 4 warps writes 4 level-1 sums of one message, and the
// message's last block runs the levels above them.
#include "qsgd_common.cuh"
#include "tap_reduce.cuh"

namespace {

using taps::kThreads;
constexpr int kSums = 2;

// The two squares of value e of one message: delta^2 and, for qsgd
// uploads, (delta - qdq(delta))^2; 0 outside [0, d).
template <int BITS>  // 0: identity uploads, no codes
struct UploadSquares {
  const float* x;        // the message's deltas
  const uint8_t* codes;  // its packed rows (BITS > 0)
  const float* norms;    // its row norms (BITS > 0)
  long long d;
  __device__ __forceinline__ void operator()(long long e,
                                             float v[kSums]) const {
    const bool in = e >= 0 && e < d;
    const float xv = in ? __ldg(x + e) : 0.0f;
    v[0] = __fmul_rn(xv, xv);
    v[1] = 0.0f;
    if constexpr (BITS > 0) {
      const long long r = in ? e / qsgd::kLanes : 0;
      const int lane = in ? (int)(e % qsgd::kLanes) : 0;
      const uint32_t byte =
          in ? __ldg(codes + r * (16 * BITS) + lane * BITS / 8) : 0u;
      const float nm = in ? __ldg(norms + r) : 0.0f;
      const uint32_t code = (byte >> (lane * BITS % 8)) & ((1u << BITS) - 1u);
      const float mag = (float)(code & ((1u << (BITS - 1)) - 1u));
      const float sm = (code >> (BITS - 1)) ? -mag : mag;
      const float scale = __fmul_rn(nm, __frcp_rn(qsgd::levels(BITS)));
      const float err = __fmaf_rn(-sm, scale, xv);
      v[1] = __fmul_rn(err, err);
    }
  }
};

template <int BITS>
__global__ void __launch_bounds__(kThreads)
    upload_taps_kernel(const float* __restrict__ deltas,
                       const uint8_t* __restrict__ packed,
                       const float* __restrict__ norms, long long d,
                       taps::Law law, float* partials, unsigned* counters,
                       float* __restrict__ out) {
  const long long row = blockIdx.x / law.blocks;
  const long long blk = blockIdx.x % law.blocks;
  const long long wire_rows = (d + qsgd::kLanes - 1) / qsgd::kLanes;
  const UploadSquares<BITS> squares{
      deltas + row * d,
      BITS > 0 ? packed + row * wire_rows * (16 * BITS) : nullptr,
      BITS > 0 ? norms + row * wire_rows : nullptr, d};
  float* row_partials =
      partials + row * taps::scratch_slots(law.l1) * kSums;
  taps::level1_sums<kSums>(squares, law, blk * taps::kWarps, row_partials);
  if (!taps::block_done(counters + row, law.blocks)) return;
  float tot[kSums];
  taps::row_totals<kSums>(row_partials, law.l1, counters + row, tot);
  if (threadIdx.x != 0) return;
  const float dn = __fsqrt_rn(tot[0]);
  out[2 * row] = dn;
  out[2 * row + 1] = __fdiv_rn(__fsqrt_rn(tot[1]), fmaxf(dn, 1e-30f));
}

template <int BITS>
void launch(const float* deltas, const uint8_t* packed, const float* norms,
            long long b, long long d, const taps::Law& law, float* partials,
            unsigned* counters, float* out, cudaStream_t stream) {
  upload_taps_kernel<BITS>
      <<<(unsigned)(b * law.blocks), kThreads, 0, stream>>>(
          deltas, packed, norms, d, law, partials, counters, out);
}

}  // namespace

// bits 0 (identity; packed and norms may be null), 2, 4 or 8. `partials`
// holds b * taps::scratch_slots(ceil(d / 1024)) * 2 floats; `counters`
// holds b unsigned that are 0 between launches.
extern "C" int upload_taps(const void* deltas, const void* packed,
                           const void* norms, long long b, long long d,
                           int bits, void* partials, void* counters,
                           void* out, void* stream) {
  if (b <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const taps::Law law = taps::law_of(d);
  if (b * law.blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (bits != 0 && (packed == nullptr || norms == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const auto x = (const float*)deltas;
  const auto p = (const uint8_t*)packed;
  const auto nm = (const float*)norms;
  const auto pt = (float*)partials;
  const auto ct = (unsigned*)counters;
  const auto o = (float*)out;
  const auto s = (cudaStream_t)stream;
  switch (bits) {
    case 0: launch<0>(x, p, nm, b, d, law, pt, ct, o, s); break;
    case 2: launch<2>(x, p, nm, b, d, law, pt, ct, o, s); break;
    case 4: launch<4>(x, p, nm, b, d, law, pt, ct, o, s); break;
    case 8: launch<8>(x, p, nm, b, d, law, pt, ct, o, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
