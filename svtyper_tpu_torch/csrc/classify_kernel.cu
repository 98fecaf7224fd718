// Evidence classification of the compact wire for Hopper (sm_90a): one
// thread per variant segment, reading the shard's uint8 wire in place.
//
// Replaces what XLA compiles inside jit(step_wire) of
// svtyper_tpu/gt/engine.py from svtyper_tpu/evidence/device.py::
// classify_compact (its segment sums at :73-74 and :118-119); there is
// no Pallas original. It computes exactly the plain PyTorch function
// svtyper_tpu_torch/evidence/device.py::classify_compact, in the same
// float32 order of operations:
//
// - per read row: prob_mapq of mapq and sa_mapq by table lookup, the
//   R_* flag tests, l_pm/r_pm, (l_pm*lhit + r_pm*rhit)*0.5;
// - per pair row: p_pair, refw*p_pair*0.5, the two insert-density
//   lookups with their bounds and LIB_INVALID tests, denom, p_conc,
//   del_move, alt_span in the plain order and ref_span - del_move;
// - per variant: the five sums, each added in row order from 0.0f,
//   as torch.segment_reduce adds them on both devices. DP/RO/AO/QR/QA
//   are truncations of these sums, so the order is the one of the plain
//   version and never a tree or atomics.
//
// Every product, sum and quotient is an __f*_rn intrinsic, which never
// contracts, and the file is built with -fmad=false (ops/_build.py).
// The prob_mapq table is the plain version's own float32 table, passed
// in device memory, never recomputed with powf.
//
// The wire (gt/engine.py::pack_wire) holds seven matrices back to back:
// cr_u16 [1,R] (read → variant, ascending, padding rows at n_var),
// cr_u8 [3,R] (mapq, sa_mapq, flags), cp_u16 [1,F], cp_i32 [1,F]
// (ospan), cp_u8 [4,F] (a_mapq, b_mapq, lib, flags), v_i32 [9,V]
// (vlen is row 8), v_u8 [6,V] (is_del is row 2). The wrapper
// (ops/classify_kernel.py) passes the byte offset of each and checks
// their alignment. Thread v finds its first and last rows by binary
// search over the sorted variant columns, so no searchsorted launch is
// needed, and skips the padding rows of the trash segment at n_var.
//
// What bounds it. It must read what it uses of the wire once (5 B a read
// row, 10 B a pair row, 5 B a variant: vlen and is_del), each distinct
// density entry the pairs look up and the 1 KiB table once, and write
// 20 B a variant: ~2.1 MB for a 1,024-variant chunk of a 30x sample
// (~50 reads and ~175 pairs a variant), under 1 us at 3.35 TB/s
// (chip_smoke.py's classify_bound). Its arithmetic (a dozen or two
// operations a row) is far below the float32 rate. What decides its
// time is the walk of the longest segment: one thread adds its rows one
// after the other, each row a global load and a density lookup that
// depends on it, after four binary searches of dependent loads. On one
// H100 (700 W) it takes ~0.13 ms for a 30x chunk whose longest segment
// is 317 pairs, at N = 1,024 as at 4,096 (chip_smoke.py phase 17). A
// warp per segment with coalesced loads and an in-order sum of the
// lanes' values is the next step; tensor cores, TMA and shared-memory
// tiles have no place in a gather this small.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTable = 256;

// cr_u8 / cp_u8 flag bits (evidence/extract.py)
constexpr unsigned kRCovHit = 1, kRClipHit = 2, kRLHit = 4, kRRHit = 8,
                   kRPrimFirst = 16;
constexpr unsigned kPAlt = 1, kPAltRec = 2;
constexpr unsigned kLibInvalid = 255;
// rows of v_i32 / v_u8 (extract.VARS_I32, extract.VARS_BOOL)
constexpr int kVlenRow = 8;
constexpr int kIsDelRow = 2;

constexpr float kPriorConc = 0.95f;
constexpr float kPriorDisc = 0.05f;

struct Wire {
  const uint16_t* r_var;
  const uint8_t* r_mapq;
  const uint8_t* r_sa_mapq;
  const uint8_t* r_flags;
  const uint16_t* p_var;
  const int32_t* p_ospan;
  const uint8_t* p_a_mapq;
  const uint8_t* p_b_mapq;
  const uint8_t* p_lib;
  const uint8_t* p_flags;
  const int32_t* v_vlen;
  const uint8_t* v_is_del;
  int n_reads;
  int n_pairs;
};

// first index i in [0, n) with a[i] >= v (torch.searchsorted, left)
__device__ __forceinline__ int lower_bound(const uint16_t* __restrict__ a,
                                           int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (static_cast<int>(a[mid]) < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
    classify_compact_kernel(Wire w, const float* __restrict__ dens,
                            int n_lib, int width,
                            const float* __restrict__ prob_mapq, int n_var,
                            float* __restrict__ counts) {
  __shared__ float s_pm[kTable];
  for (int j = threadIdx.x; j < kTable; j += kThreads) s_pm[j] = prob_mapq[j];
  __syncthreads();
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= n_var) return;

  // ---- reads (SPEC.md §4.1 coverage, §4.2 splits and clips)
  float ref_seq = 0.0f, alt_seq = 0.0f, alt_clip = 0.0f;
  const int r_end = lower_bound(w.r_var, w.n_reads, v + 1);
  for (int i = lower_bound(w.r_var, w.n_reads, v); i < r_end; ++i) {
    const unsigned rf = w.r_flags[i];
    const float pm = s_pm[w.r_mapq[i]];
    const float spm = s_pm[w.r_sa_mapq[i]];
    const bool prim_first = (rf & kRPrimFirst) != 0;
    const float l_pm = prim_first ? pm : spm;
    const float r_pm = prim_first ? spm : pm;
    const float lhit = (rf & kRLHit) != 0 ? 1.0f : 0.0f;
    const float rhit = (rf & kRRHit) != 0 ? 1.0f : 0.0f;
    const float ref_seq_c = (rf & kRCovHit) != 0 ? pm : 0.0f;
    const float alt_seq_c = __fmul_rn(
        __fadd_rn(__fmul_rn(l_pm, lhit), __fmul_rn(r_pm, rhit)), 0.5f);
    const float alt_clip_c = (rf & kRClipHit) != 0 ? pm : 0.0f;
    ref_seq = __fadd_rn(ref_seq, ref_seq_c);
    alt_seq = __fadd_rn(alt_seq, alt_seq_c);
    alt_clip = __fadd_rn(alt_clip, alt_clip_c);
  }

  // ---- pairs (SPEC.md §4.3)
  const int vlen = w.v_vlen[v];
  const bool is_del = w.v_is_del[v] != 0;
  float ref_span = 0.0f, alt_span = 0.0f;
  const int p_end = lower_bound(w.p_var, w.n_pairs, v + 1);
  for (int i = lower_bound(w.p_var, w.n_pairs, v); i < p_end; ++i) {
    const unsigned pf = w.p_flags[i];
    const float p_pair =
        __fmul_rn(s_pm[w.p_a_mapq[i]], s_pm[w.p_b_mapq[i]]);
    const bool alt = (pf & kPAlt) != 0;
    const bool alt_rec = (pf & kPAltRec) != 0;
    const float refw = static_cast<float>(pf >> 2);
    float ref_span_c = __fmul_rn(__fmul_rn(refw, p_pair), 0.5f);

    const unsigned lu8 = w.p_lib[i];
    const int lib = lu8 == kLibInvalid ? -1 : static_cast<int>(lu8);
    const int lib_safe = min(max(lib, 0), n_lib - 1);
    const float* row = dens + static_cast<size_t>(lib_safe) * width;
    const int ospan = w.p_ospan[i];
    // int32 wrap, as the plain version's int32 subtract
    const int disc = static_cast<int>(static_cast<uint32_t>(ospan) -
                                      static_cast<uint32_t>(vlen));
    const float d_conc =
        (ospan >= 0 && ospan < width && lib >= 0) ? row[ospan] : 0.0f;
    const float d_disc =
        (disc >= 0 && disc < width && lib >= 0) ? row[disc] : 0.0f;
    const float denom = __fadd_rn(__fmul_rn(kPriorConc, d_conc),
                                  __fmul_rn(kPriorDisc, d_disc));
    const bool has_denom = denom > 0.0f;
    const float p_conc =
        has_denom ? __fdiv_rn(__fmul_rn(kPriorConc, d_conc), denom) : 0.0f;
    const float del_move = (is_del && alt && has_denom)
                               ? __fmul_rn(__fsub_rn(1.0f, p_conc), p_pair)
                               : 0.0f;
    const float alt_span_c =
        __fadd_rn(__fadd_rn(del_move, (alt && !is_del) ? p_pair : 0.0f),
                  alt_rec ? p_pair : 0.0f);
    ref_span_c = __fsub_rn(ref_span_c, del_move);
    ref_span = __fadd_rn(ref_span, ref_span_c);
    alt_span = __fadd_rn(alt_span, alt_span_c);
  }

  float* out = counts + static_cast<size_t>(v) * 5;
  out[0] = ref_seq;
  out[1] = alt_seq;
  out[2] = alt_clip;
  out[3] = ref_span;
  out[4] = alt_span;
}

}  // namespace

// wire: the shard's uint8 wire on the device; offsets: 7 host int64,
// the byte offset of each matrix in COMPACT_KEYS order (cr_u16, cr_u8,
// cp_u16, cp_i32, cp_u8, v_i32, v_u8), each aligned to its element;
// n_reads R, n_pairs F and v_cols V the matrices' widths; dens
// [n_lib, width] f32 and prob_mapq [256] f32 on the device; counts
// [n_var, 5] f32 out, n_var <= V. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int svt_classify_compact(const void* wire, const void* offsets,
                                    int n_reads, int n_pairs, int v_cols,
                                    int n_var, const void* dens, int n_lib,
                                    int width, const void* prob_mapq,
                                    void* counts, void* stream) {
  if (n_var <= 0) return 0;
  const uint8_t* base = static_cast<const uint8_t*>(wire);
  const int64_t* off = static_cast<const int64_t*>(offsets);
  Wire w;
  w.r_var = reinterpret_cast<const uint16_t*>(base + off[0]);
  w.r_mapq = base + off[1];
  w.r_sa_mapq = base + off[1] + n_reads;
  w.r_flags = base + off[1] + 2 * static_cast<int64_t>(n_reads);
  w.p_var = reinterpret_cast<const uint16_t*>(base + off[2]);
  w.p_ospan = reinterpret_cast<const int32_t*>(base + off[3]);
  w.p_a_mapq = base + off[4];
  w.p_b_mapq = base + off[4] + n_pairs;
  w.p_lib = base + off[4] + 2 * static_cast<int64_t>(n_pairs);
  w.p_flags = base + off[4] + 3 * static_cast<int64_t>(n_pairs);
  w.v_vlen = reinterpret_cast<const int32_t*>(base + off[5]) +
             static_cast<int64_t>(kVlenRow) * v_cols;
  w.v_is_del = base + off[6] + static_cast<int64_t>(kIsDelRow) * v_cols;
  w.n_reads = n_reads;
  w.n_pairs = n_pairs;
  const int blocks = (n_var + kThreads - 1) / kThreads;
  classify_compact_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      w, static_cast<const float*>(dens), n_lib, width,
      static_cast<const float*>(prob_mapq), n_var,
      static_cast<float*>(counts));
  return static_cast<int>(cudaGetLastError());
}
