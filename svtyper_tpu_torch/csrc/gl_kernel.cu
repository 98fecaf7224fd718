// Fused genotype-likelihood stage for Hopper (sm_90a), one thread per
// variant.
//
// Replaces svtyper_tpu/ops/pallas_gl.py::genotype_batch_pallas, the
// Pallas TPU kernel of the float32 device step. From the [N,5] evidence
// counts it computes QR/QA, log10 C(n,k), the lc-free per-genotype
// scores, best and second genotype (ties to the lowest index), SQ by
// log-sum-exp, GQ (capped at 200, truncated), the null test, AB and the
// truncated DP/RO/AO/RS/AS/ASC/RP/AP, and stores the engine's packed
// row directly: [N,24] float32, the 14 INT_FIELDS as floats, then
// gl0-2, sq, ab, c0-4. That drops the pad-to-512, transpose and concat
// that the TPU engine wraps around the Pallas call.
//
// What bounds it: at the engine's N=1024 it is one tiny launch, so
// launch latency and the 96-byte row store per variant dominate; the
// arithmetic (three lgammaf, three expf, one log10f) is negligible.
// A later step fuses it with classify_compact into one launch.
//
// Integer fields must be bit-identical to the plain PyTorch twin
// (ops/gl_kernel.py::genotype_rows_plain): GT and GQ come from
// s = k*lp + (n-k)*lq followed by trunc, and a fused multiply-add would
// change the last ulp of s and can flip GQ. The score arithmetic uses
// __fmul_rn/__fadd_rn, which never contract, and the file is built with
// -fmad=false (ops/_build.py), so every other product and sum is also
// rounded on its own, as PyTorch's eager ops do. No fast-math.

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kRow = 24;
constexpr float kLn10 = 2.302585092994046f;
constexpr float kMaxGq = 200.0f;
constexpr float kLog10Tiny = -323.6f;

// log10 p and log10 (1-p) per genotype, rows (non-dup, dup): the
// float64 tables of ops/gl.py rounded once to float32 by the caller
struct Tables {
  float lp[2][3];
  float lq[2][3];
};

__device__ __forceinline__ float as_int_field(float x) {
  // the reference stores int32(x) back as a float: trunc toward zero
  return static_cast<float>(__float2int_rz(x));
}

__global__ void gl_rows_kernel(const float* __restrict__ counts,
                               const uint8_t* __restrict__ is_dup,
                               const uint8_t* __restrict__ force_null,
                               float* __restrict__ rows, int n_rows,
                               float split_weight, float disc_weight,
                               Tables t) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows) return;
  const float* c = counts + static_cast<size_t>(i) * 5;
  const float rs = c[0], as_ = c[1], ac = c[2], rp = c[3], ap = c[4];
  const int d = is_dup[i] != 0 ? 1 : 0;

  const float alt_split = as_ + ac;
  const float total = rs + as_ + ac + rp + ap;
  const float qr = truncf(split_weight * rs) + truncf(disc_weight * rp);
  const float qa = truncf(split_weight * alt_split) + truncf(disc_weight * ap);
  const float n = qr + qa;
  const float k = qa;

  const float k2 = (2.0f * k > n) ? n - k : k;
  const bool lc_valid = (k2 > 0.0f) && (k >= 0.0f) && (n >= k);
  float lc = 0.0f;
  if (lc_valid) {
    const float safe_n = fmaxf(n, 0.0f);
    const float safe_k = fminf(fmaxf(k, 0.0f), safe_n);
    lc = (lgammaf(safe_n + 1.0f) - lgammaf(safe_k + 1.0f) -
          lgammaf(safe_n - safe_k + 1.0f)) / kLn10;
  }

  const float nk = n - k;
  float s[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    s[g] = __fadd_rn(__fmul_rn(k, t.lp[d][g]), __fmul_rn(nk, t.lq[d][g]));
  }

  // best / second with ties → lowest index
  const int best01 = s[1] > s[0] ? 1 : 0;
  const float sb01 = fmaxf(s[0], s[1]);
  const int best = s[2] > sb01 ? 2 : best01;
  const float s_best = fmaxf(sb01, s[2]);
  const float s_second = best == 0   ? fmaxf(s[1], s[2])
                         : best == 1 ? fmaxf(s[0], s[2])
                                     : fmaxf(s[0], s[1]);

  const float m = s_best;
  const float ssum = expf((s[0] - m) * kLn10) + expf((s[1] - m) * kLn10) +
                     expf((s[2] - m) * kLn10);
  const float log_gt_sum = m + log10f(ssum);
  const bool underflow = (m + lc) < kLog10Tiny;

  const float sq = fabsf(-10.0f * (s[0] - log_gt_sum));
  const float gq = truncf(fminf(-10.0f * (s_second - s_best), kMaxGq));
  const bool null = force_null[i] != 0 || total <= 0.0f || underflow;
  // AB denominator in the reference's order (((rs+rp)+alt_split)+ap)
  const float denom = rs + rp + alt_split + ap;
  const bool ab_valid = denom > 0.0f;
  const float ab = ab_valid ? (alt_split + ap) / denom : 0.0f;

  float* r = rows + static_cast<size_t>(i) * kRow;
  r[0] = null ? 1.0f : 0.0f;
  r[1] = null ? -1.0f : static_cast<float>(best);
  r[2] = as_int_field(gq);
  r[3] = as_int_field(qr);
  r[4] = as_int_field(qa);
  r[5] = as_int_field(rs + rp + as_ + ac + ap);  // DP, reference order
  r[6] = as_int_field(rs + rp);
  r[7] = as_int_field(alt_split + ap);
  r[8] = as_int_field(rs);
  r[9] = as_int_field(as_);
  r[10] = as_int_field(ac);
  r[11] = as_int_field(rp);
  r[12] = as_int_field(ap);
  r[13] = ab_valid ? 1.0f : 0.0f;
  r[14] = lc + s[0];
  r[15] = lc + s[1];
  r[16] = lc + s[2];
  r[17] = sq;
  r[18] = ab;
  r[19] = rs;
  r[20] = as_;
  r[21] = ac;
  r[22] = rp;
  r[23] = ap;
}

}  // namespace

// counts [n,5] f32, is_dup/force_null [n] u8, rows [n,24] f32 (all
// contiguous, on the device); tables: 12 host floats (lp[2][3] then
// lq[2][3]). Launches on `stream` and returns cudaGetLastError().
extern "C" int svt_gl_rows(const void* counts, const void* is_dup,
                           const void* force_null, void* rows, int n_rows,
                           float split_weight, float disc_weight,
                           const void* tables, void* stream) {
  if (n_rows <= 0) return 0;
  Tables t;
  std::memcpy(&t, tables, sizeof(Tables));
  constexpr int kThreads = 256;
  const int blocks = (n_rows + kThreads - 1) / kThreads;
  gl_rows_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(counts), static_cast<const uint8_t*>(is_dup),
      static_cast<const uint8_t*>(force_null), static_cast<float*>(rows),
      n_rows, split_weight, disc_weight, t);
  return static_cast<int>(cudaGetLastError());
}
