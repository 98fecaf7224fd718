// Fused genotype-likelihood stage for Hopper (sm_90a): one 32-variant
// tile per block, one variant per thread, inputs and outputs staged
// through shared memory so that every global access is coalesced.
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
// What bounds it. It moves 118 bytes per variant (20 in, two flag
// bytes, 96 out), so at 3.35 TB/s its bound is 0.036 us at the engine's
// N = 1024 and 2.3 us at N = 65536; its arithmetic (three lgammaf,
// three expf, one log10f and one divide per variant) is negligible
// against that. At N <= 4096 launch latency and the per-variant chain
// of dependent operations decide its time, so the design spreads the
// work and keeps every access to device memory coalesced:
//
// - a block owns kTile = 32 consecutive variants, one warp, so N = 1024
//   runs on 32 SMs (and N = 4096 on all 128 of 132) instead of the 4
//   that 256-thread blocks filled; the per-variant chains of different
//   SMs run side by side;
// - the block reads its [32,5] counts tile (640 bytes, a 16-byte
//   multiple at a 16-byte offset) as 40 float4 loads, neighbouring
//   threads on neighbouring addresses, into shared memory; a thread then
//   reads its own row there (stride 5 floats: no bank conflicts). The
//   ragged last tile takes masked scalar loads. The flag bytes load
//   coalesced, one per thread;
// - each thread writes its 24 results to a [32,24] row tile in shared
//   memory (6 float4s), and the block stores the tile (3 KB) as 192
//   float4 stores, neighbouring threads on neighbouring addresses: 6
//   store instructions per thread, each warp-wide store one contiguous
//   512 bytes, where one thread per row stored 24 scattered words (32
//   rows 96 bytes apart per warp-wide store: eight times the L2
//   transactions). The wrapper (ops/gl_kernel.py) refuses pointers that
//   are not 16-byte aligned.
//
// There is no matrix product, so tensor cores (wgmma) have no place
// here, and a tile of 640 bytes in and 3 KB out is too small for TMA
// tensor maps or bulk copies to pay for their barriers.
//
// Integer fields must be bit-identical to the plain PyTorch twin
// (ops/gl_kernel.py::genotype_rows_plain): GT and GQ come from
// s = k*lp + (n-k)*lq followed by trunc, and a fused multiply-add would
// change the last ulp of s and can flip GQ. The score arithmetic uses
// __fmul_rn/__fadd_rn, which never contract, and the file is built with
// -fmad=false (ops/_build.py), so every other product and sum is also
// rounded on its own, as PyTorch's eager ops do. No fast-math
// intrinsics: lgammaf, expf, log10f and the divide are the IEEE ones.

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kRow = 24;
constexpr int kIn = 5;
constexpr int kTile = 32;                    // variants per block = threads
constexpr int kTileIn4 = kTile * kIn / 4;    // float4s of a full counts tile
constexpr int kRow4 = kRow / 4;              // float4s per output row
constexpr int kTileOut4 = kTile * kRow4;     // float4s of a full row tile
static_assert(kTile % 4 == 0, "a counts tile must be a 16-byte multiple");

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

// One variant's GL stage → its 24 row values, in the reference's order
// of operations.
__device__ __forceinline__ void gl_row(const float* c, bool dup,
                                       bool force_null, float split_weight,
                                       float disc_weight, const Tables& t,
                                       float* r) {
  const float rs = c[0], as_ = c[1], ac = c[2], rp = c[3], ap = c[4];

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
    const float lp = dup ? t.lp[1][g] : t.lp[0][g];
    const float lq = dup ? t.lq[1][g] : t.lq[0][g];
    s[g] = __fadd_rn(__fmul_rn(k, lp), __fmul_rn(nk, lq));
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
  const bool null = force_null || total <= 0.0f || underflow;
  // AB denominator in the reference's order (((rs+rp)+alt_split)+ap)
  const float denom = rs + rp + alt_split + ap;
  const bool ab_valid = denom > 0.0f;
  const float ab = ab_valid ? (alt_split + ap) / denom : 0.0f;

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

__global__ void __launch_bounds__(kTile)
    gl_rows_kernel(const float* __restrict__ counts,
                   const uint8_t* __restrict__ is_dup,
                   const uint8_t* __restrict__ force_null,
                   float* __restrict__ rows, int n_rows, float split_weight,
                   float disc_weight, Tables t) {
  __shared__ float4 s_in[kTileIn4];
  __shared__ float4 s_out[kTileOut4];
  const int tid = threadIdx.x;
  const size_t first = static_cast<size_t>(blockIdx.x) * kTile;
  // rows of this tile: kTile, or fewer in the last one
  const int m = min(kTile, n_rows - static_cast<int>(first));

  const float* src = counts + first * kIn;
  if (m == kTile) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int j = tid; j < kTileIn4; j += kTile) s_in[j] = src4[j];
  } else {
    float* s_in_f = reinterpret_cast<float*>(s_in);
    for (int j = tid; j < m * kIn; j += kTile) s_in_f[j] = src[j];
  }
  bool dup = false, fnull = false;
  if (tid < m) {
    dup = is_dup[first + tid] != 0;
    fnull = force_null[first + tid] != 0;
  }
  __syncthreads();

  if (tid < m) {
    float r[kRow];
    gl_row(reinterpret_cast<const float*>(s_in) + tid * kIn, dup, fnull,
           split_weight, disc_weight, t, r);
#pragma unroll
    for (int q = 0; q < kRow4; ++q) {
      s_out[tid * kRow4 + q] =
          make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
    }
  }
  __syncthreads();

  // a row is 6 whole float4s, so the ragged tile stores m * 6 of them
  float4* dst = reinterpret_cast<float4*>(rows + first * kRow);
  for (int j = tid; j < m * kRow4; j += kTile) dst[j] = s_out[j];
}

}  // namespace

// counts [n,5] f32, is_dup/force_null [n] u8, rows [n,24] f32 (all
// contiguous, on the device; counts and rows 16-byte aligned); tables:
// 12 host floats (lp[2][3] then lq[2][3]). Launches on `stream` and
// returns cudaGetLastError().
extern "C" int svt_gl_rows(const void* counts, const void* is_dup,
                           const void* force_null, void* rows, int n_rows,
                           float split_weight, float disc_weight,
                           const void* tables, void* stream) {
  if (n_rows <= 0) return 0;
  Tables t;
  std::memcpy(&t, tables, sizeof(Tables));
  const int blocks = (n_rows + kTile - 1) / kTile;
  gl_rows_kernel<<<blocks, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(counts), static_cast<const uint8_t*>(is_dup),
      static_cast<const uint8_t*>(force_null), static_cast<float*>(rows),
      n_rows, split_weight, disc_weight, t);
  return static_cast<int>(cudaGetLastError());
}

// Makes `device` this library's current card and loads the module of
// gl_rows_kernel there without a launch (CUDA loads a module lazily, at
// its kernel's first launch otherwise); the first call on a card also
// creates its primary context. The engine calls it from a warm-up thread
// (gt/engine.py::warm_devices) through ctypes, which drops the
// interpreter lock for the call. Returns the first error, 0 on success.
extern "C" int svt_warm(int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  return static_cast<int>(cudaFuncGetAttributes(&attr, gl_rows_kernel));
}
