// Evidence classification of the compact wire for Hopper (sm_90a): a
// warp per variant segment of each table, reading the shard's uint8
// wire in place.
//
// Replaces what XLA compiles inside jit(step_wire)
// (svtyper_tpu/gt/engine.py:298) from svtyper_tpu/evidence/device.py:27
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
// in device memory and staged in shared memory by each block.
//
// The wire (gt/engine.py::pack_wire) holds seven matrices back to back:
// cr_u16 [1,R] (read -> variant, ascending, padding rows at n_var),
// cr_u8 [3,R] (mapq, sa_mapq, flags), cp_u16 [1,F], cp_i32 [1,F]
// (ospan), cp_u8 [4,F] (a_mapq, b_mapq, lib, flags), v_i32 [9,V]
// (vlen is row 8), v_u8 [6,V] (is_del is row 2). The wrapper
// (ops/classify_kernel.py) passes the byte offset of each and checks
// their alignment.
//
// What bounds it. It must read what it uses of the wire once (5 B a read
// row, 10 B a pair row, 5 B a variant: vlen and is_del), each distinct
// density entry the pairs look up and the 1 KiB table once, and write
// 20 B a variant: ~2.1 MB for a 1,024-variant chunk of a 30x sample
// (~50 reads and ~175 pairs a variant), under 1 us at 3.35 TB/s
// (tools/classify_bench.py::bound). Its arithmetic, a dozen or two
// operations a row, is far below the float32 rate. The first version
// (one thread per variant) walked each segment's rows one after the
// other, so the longest segment (317 pairs) set its time at ~0.13 ms.
//
// The design spreads the rows over lanes and SMs and keeps the order of
// the sums:
//
// - a warp per (variant, table): warp 2v walks variant v's read rows,
//   warp 2v+1 its pair rows; 4 warps a block, so a 1,024-variant chunk
//   runs 512 blocks over the 132 SMs;
// - the warp finds the segment's first row by a 32-ary search (each
//   round the lanes probe 32 evenly spaced rows and a ballot keeps the
//   stretch ~32x narrower), equal to torch.searchsorted(side="left"),
//   and finds the end during the walk: the walk stops at the first tile
//   whose rows are not all variant v, so it never adds a padding row of
//   the trash segment at n_var;
// - tiles of 32 rows: lane l loads row start + 32t + l of each column it
//   uses, so neighbouring lanes read neighbouring bytes, and computes
//   that row's contribution with the per-row operations above; the two
//   density lookups of a pair tile are independent across lanes; tile
//   t + 1 is loaded before tile t is summed;
// - the sum (RowSums): each lane stores its row's contribution to each
//   column in the warp's shared memory, then lane k adds column k's
//   values for lanes 0 .. valid-1, in lane order, so the rows' order:
//   one chain of adds a tile and column, the columns side by side on
//   their lanes. The sums start at 0.0f and carry from tile to tile, and
//   only the segment's rows are added, never a padding zero.
//
// Tensor cores (wgmma), TMA and clusters have no place here: there is no
// product to feed, and each warp gathers a few hundred bytes a tile from
// rows it finds only at run time, too little and too ragged for a TMA
// tile; the loads are already coalesced 32-row tiles, and cp.async
// would only stage what one load a lane already brings.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTable = 256;
constexpr unsigned kFull = 0xffffffffu;
// a row past the table's end: a variant no segment has
constexpr unsigned kNoVariant = 0x10000u;

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

// first index i in [0, n) with a[i] >= v, or n (torch.searchsorted,
// side left), the same in every lane. The answer stays in [lo, hi]; a
// round probes rows lo + (l+1)*step - 1 and keeps the stretch between the
// last probe below v and the first at or above it.
__device__ __forceinline__ int warp_lower_bound(
    const uint16_t* __restrict__ a, int n, int v, int lane) {
  int lo = 0, hi = n;
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) >> 5;
    const int q = lo + (lane + 1) * step - 1;
    const unsigned ge = __ballot_sync(
        kFull, q >= hi || static_cast<int>(__ldg(a + q)) >= v);
    if (ge == 0) return hi;
    const int b = __ffs(ge) - 1;
    hi = min(lo + (b + 1) * step - 1, hi);
    lo += b * step;
  }
  const int q = lo + lane;
  const unsigned ge =
      __ballot_sync(kFull, q >= hi || static_cast<int>(__ldg(a + q)) >= v);
  return ge == 0 ? hi : lo + __ffs(ge) - 1;
}

// The running sums of a segment's kCols columns, each added in row order
// from 0.0f. add() takes one tile: lane l's contribution to column k in
// c[k], lanes 0 .. valid-1 the segment's rows (a prefix of the tile).
// The tile goes through the warp's shared memory, column k at
// tile[k * kStride ...], and lane k adds column k's valid rows in order:
// a store a column, eight 16-byte loads and one chain of adds a tile.
constexpr int kStride = 36;  // floats: lanes 0-2 read disjoint banks

template <int kCols>
struct RowSums {
  float s = 0.0f;  // lane k: column k's sum

  __device__ __forceinline__ void add(const float (&c)[kCols], int valid,
                                      int lane, float* tile) {
#pragma unroll
    for (int k = 0; k < kCols; ++k) tile[k * kStride + lane] = c[k];
    __syncwarp();
    if (lane < kCols) {
      const float4* col =
          reinterpret_cast<const float4*>(tile + lane * kStride);
      float4 x[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) x[q] = col[q];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (4 * q < valid) s = __fadd_rn(s, x[q].x);
        if (4 * q + 1 < valid) s = __fadd_rn(s, x[q].y);
        if (4 * q + 2 < valid) s = __fadd_rn(s, x[q].z);
        if (4 * q + 3 < valid) s = __fadd_rn(s, x[q].w);
      }
    }
    __syncwarp();  // the loads are done before the next tile's stores
  }

  __device__ __forceinline__ void store(float* out, int lane) const {
    if (lane < kCols) out[lane] = s;
  }
};

struct ReadRow {
  unsigned var, mapq, sa_mapq, flags;
};

__device__ __forceinline__ ReadRow load_read(const Wire& w, int i) {
  ReadRow r = {kNoVariant, 0, 0, 0};
  if (i < w.n_reads) {
    r.var = __ldg(w.r_var + i);
    r.mapq = __ldg(w.r_mapq + i);
    r.sa_mapq = __ldg(w.r_sa_mapq + i);
    r.flags = __ldg(w.r_flags + i);
  }
  return r;
}

struct PairRow {
  unsigned var, a_mapq, b_mapq, lib, flags;
  int ospan;
};

__device__ __forceinline__ PairRow load_pair(const Wire& w, int i) {
  PairRow p = {kNoVariant, 0, 0, 0, 0, 0};
  if (i < w.n_pairs) {
    p.var = __ldg(w.p_var + i);
    p.ospan = __ldg(w.p_ospan + i);
    p.a_mapq = __ldg(w.p_a_mapq + i);
    p.b_mapq = __ldg(w.p_b_mapq + i);
    p.lib = __ldg(w.p_lib + i);
    p.flags = __ldg(w.p_flags + i);
  }
  return p;
}

// ---- reads (SPEC.md §4.1 coverage, §4.2 splits and clips) → out[0..2]
__device__ __forceinline__ void classify_reads(const Wire& w,
                                               const float* s_pm, int v,
                                               int lane, float* tile,
                                               float* out) {
  int i = warp_lower_bound(w.r_var, w.n_reads, v, lane) + lane;
  ReadRow cur = load_read(w, i);
  RowSums<3> sums;
  while (true) {
    const int valid = __popc(__ballot_sync(kFull, cur.var == unsigned(v)));
    if (valid == 0) break;
    const ReadRow next = load_read(w, valid == 32 ? i + 32 : w.n_reads);
    const unsigned rf = cur.flags;
    const float pm = s_pm[cur.mapq];
    const float spm = s_pm[cur.sa_mapq];
    const bool prim_first = (rf & kRPrimFirst) != 0;
    const float l_pm = prim_first ? pm : spm;
    const float r_pm = prim_first ? spm : pm;
    const float lhit = (rf & kRLHit) != 0 ? 1.0f : 0.0f;
    const float rhit = (rf & kRRHit) != 0 ? 1.0f : 0.0f;
    const float ref_seq_c = (rf & kRCovHit) != 0 ? pm : 0.0f;
    const float alt_seq_c = __fmul_rn(
        __fadd_rn(__fmul_rn(l_pm, lhit), __fmul_rn(r_pm, rhit)), 0.5f);
    const float alt_clip_c = (rf & kRClipHit) != 0 ? pm : 0.0f;
    const float c[3] = {ref_seq_c, alt_seq_c, alt_clip_c};
    sums.add(c, valid, lane, tile);
    if (valid < 32) break;
    cur = next;
    i += 32;
  }
  sums.store(out, lane);
}

// ---- pairs (SPEC.md §4.3) → out[3..4]
__device__ __forceinline__ void classify_pairs(const Wire& w,
                                               const float* __restrict__ dens,
                                               int n_lib, int width,
                                               const float* s_pm, int v,
                                               int lane, float* tile,
                                               float* out) {
  const int vlen = __ldg(w.v_vlen + v);
  const bool is_del = __ldg(w.v_is_del + v) != 0;
  int i = warp_lower_bound(w.p_var, w.n_pairs, v, lane) + lane;
  PairRow cur = load_pair(w, i);
  RowSums<2> sums;
  while (true) {
    const int valid = __popc(__ballot_sync(kFull, cur.var == unsigned(v)));
    if (valid == 0) break;
    const PairRow next = load_pair(w, valid == 32 ? i + 32 : w.n_pairs);
    const unsigned pf = cur.flags;
    const float p_pair = __fmul_rn(s_pm[cur.a_mapq], s_pm[cur.b_mapq]);
    const bool alt = (pf & kPAlt) != 0;
    const bool alt_rec = (pf & kPAltRec) != 0;
    const float refw = static_cast<float>(pf >> 2);
    float ref_span_c = __fmul_rn(__fmul_rn(refw, p_pair), 0.5f);

    const int lib = cur.lib == kLibInvalid ? -1 : static_cast<int>(cur.lib);
    const int lib_safe = min(max(lib, 0), n_lib - 1);
    const float* row = dens + static_cast<size_t>(lib_safe) * width;
    const int ospan = cur.ospan;
    // int32 wrap, as the plain version's int32 subtract
    const int disc = static_cast<int>(static_cast<uint32_t>(ospan) -
                                      static_cast<uint32_t>(vlen));
    const float d_conc =
        (ospan >= 0 && ospan < width && lib >= 0) ? __ldg(row + ospan) : 0.0f;
    const float d_disc =
        (disc >= 0 && disc < width && lib >= 0) ? __ldg(row + disc) : 0.0f;
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
    const float c[2] = {ref_span_c, alt_span_c};
    sums.add(c, valid, lane, tile);
    if (valid < 32) break;
    cur = next;
    i += 32;
  }
  sums.store(out + 3, lane);
}

__global__ void __launch_bounds__(kThreads)
    classify_compact_kernel(Wire w, const float* __restrict__ dens,
                            int n_lib, int width,
                            const float* __restrict__ prob_mapq, int n_var,
                            float* __restrict__ counts) {
  __shared__ float s_pm[kTable];
  __shared__ __align__(16) float s_tile[kWarps][3 * kStride];
  for (int j = threadIdx.x; j < kTable; j += kThreads) s_pm[j] = prob_mapq[j];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  float* tile = s_tile[threadIdx.x >> 5];
  const int v = warp >> 1;
  if (v >= n_var) return;
  float* out = counts + static_cast<size_t>(v) * 5;
  if ((warp & 1) == 0) {
    classify_reads(w, s_pm, v, lane, tile, out);
  } else {
    classify_pairs(w, dens, n_lib, width, s_pm, v, lane, tile, out);
  }
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
  const int64_t warps = 2 * static_cast<int64_t>(n_var);
  const int blocks = static_cast<int>((warps + kWarps - 1) / kWarps);
  classify_compact_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      w, static_cast<const float*>(dens), n_lib, width,
      static_cast<const float*>(prob_mapq), n_var,
      static_cast<float*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// Makes `device` this library's current card and loads the module of
// classify_compact_kernel there without a launch, as svt_warm of
// gl_kernel.cu does for its kernel. Returns the first error, 0 on
// success.
extern "C" int svt_warm(int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  return static_cast<int>(
      cudaFuncGetAttributes(&attr, classify_compact_kernel));
}
