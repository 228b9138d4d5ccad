// Resident flash-decode for Hopper (sm_90a): one query token per batch row
// against a long KV cache, over only the q-head rows one device hosts.
//
// Five extern "C" entry points; each replaces one Pallas TPU kernel of the
// JAX package's src/repro/kernels/decode_attention.py:
//   decode_attention_resident_launch            <- decode_attention_resident
//     K/V (B, KvE, T, dh) in q's dtype;
//   decode_attention_int8_resident_launch       <- decode_attention_int8_resident
//     K/V (B, KvE, T, dh) int8, scales (B, KvE, T) f32;
//   decode_attention_paged_resident_launch      <- decode_attention_paged_resident
//     K/V pages (n_pages, KvE, P, dh) in q's dtype, page_map (B, np) i32;
//   decode_attention_int8_paged_resident_launch <- decode_attention_int8_paged_resident
//     K/V pages int8, scale pages (n_pages, KvE, P) f32;
//   decode_attention_ring_resident_launch       <- decode_attention_ring_resident
//     a sliding-window ring K/V (B, KvE, W, dh) in q's dtype, slot_pos (W,)
//     i32 (see the ring section below: its own split-window kernel).
// The first four compute one function in one split body, as the
// reference's one Pallas body (`_kernel` / `_kernel_int8`) serves its four
// Pallas kernels, which differ in how K/V blocks are addressed and
// dequantized.  For every (b, r)
//   out[b, r] = softmax(q[b, rows[r]] . K[b, kv_rows[r], :len]^T / sqrt(dh))
//               . V[b, kv_rows[r], :len],      len = clamp(lengths[b], 0, cap)
// with cap = T (linear) or np * P (paged), f32 accumulation, an online
// softmax (m, l, acc) and the reference's l >= 1e-30 clamp, so a row with
// len == 0 returns zeros.  Paged position t reads page page_map[b, t / P] at
// offset t % P; int8 element (t, d) is q8 * scale[t] (the scale is applied
// to the dot product for K and to the softmax weight for V, which is the
// same sum, regrouped).  Output (B, R, dh) in q's dtype, in `rows` order.
// A `rows` or `kv_rows` entry out of range writes NaN for that entry; a
// page id outside [0, n_pages) that batch row b reads writes NaN for every
// entry of row b; neither is dereferenced.
//
// The linear entry point and the ring also serve a cache whose sequence is
// sharded over several devices (the long-decode path): given an `lse`
// (B, R) float32 output they write each (b, r)'s log-sum-exp of its scores
//   lse[b, r] = log sum_t exp(q . K[t] / sqrt(dh))     (natural log)
// over the positions that count, or -1e30 (weight 0 in a merge, never NaN)
// where none does, and `out_f32` writes the output in float32 instead of
// q's dtype, so that the devices' partial outputs merge before one
// rounding.  A null `lse` and out_f32 == 0 give the output as before, bit
// for bit: the LSE is read off the merge's (m, l) and changes nothing else.
//
// Bound: memory.  The least work is reading each valid K/V row once,
//   sum_b len_b * KvE * 2 (k and v) * (dh * itemsize [+ 4 for an int8 scale])
// bytes at 3.35 TB/s (H100 SXM); the arithmetic is ~4 flop per K/V element
// per q row (G q rows share a KV row: G = 4 for llama3-8b, 16 for glm4),
// far below the card's ridge point.  Paging reads the same bytes as the
// linear cache; int8 reads (dh + 4) / (2 dh) of bf16's.
//
// The split body (decode_split_mma_kernel or decode_split_kernel, then
// split_merge_kernel) reads each valid K/V row from device memory once per
// call, at any G up to 16, for all four linear and paged entry points:
// - One block of 4 warps per (sequence split, KV head, b).  The block finds
//   the entries of `kv_rows` that name its KV head (any subset, any order)
//   and scores each K/V tile against up to kSplitRows = 16 of them per
//   pass, so one staged tile serves all 16 q heads of a glm4 group.  More
//   than 16 rows on one KV head take more passes.
// - K/V tiles (and int8 scales) go to shared memory once through cp.async,
//   16-byte pieces of values and 4-byte scales, into 3 stages.
// - Scores: bf16 q over bf16 K/V (the dense, glm4 and paged paths) on the
//   tensor cores (decode_split_mma_kernel: the pass's rows are one m16 tile
//   of mma.sync; see its section); f32 q, and int8 K/V (the int8 and
//   int8-paged paths), on the CUDA cores (decode_split_kernel: the ring's
//   lane layout, the block's subgroups in 1, 2 or 4 teams of 4 rows, every
//   team scoring every slot).  Both keep f32 sums and an online softmax in
//   log2 units.
// - Head widths 16, 32, 64, 80 (zamba2's shared attention) and 128.  At
//   dh 80 the tensor-core body loads 8 slots of K or V as two ldmatrix.x4
//   (64 columns) and one .x2 (the last 16); the CUDA-core body gives a slot
//   16 lanes of 8 elements, as at dh 128, the top 6 holding zeros: 10
//   lanes would break the xor reductions over a slot's lanes, and 5
//   elements a lane would need 10-byte loads.  The ring kernel shares that
//   lane layout.
// - Validity is a length prefix: the wrapper picks `split` from the cache
//   extent (about 4 blocks an SM; it never reads `lengths`), a split that
//   starts at or past the row's length exits at once, and the merge reads
//   only the ceil(len / split) splits that cover the row.  Slots past the
//   length are zero-filled, never read.
// - Paged: a split stages its page ids into shared memory once (a tile may
//   cross pages; any P), and each thread finds the page and offset of its
//   first row of a tile by one division and steps to its next rows.  A bad
//   id makes the split write its partials with l = NaN and read no K/V; the
//   merge tests that flag explicitly (fmaxf would drop a NaN m) and writes
//   NaN for the row.  With np * P == T a paged cache gives the linear
//   cache's result bit for bit: addressing is the only difference.
//
// K, V and scales are read through their strides, so the caller passes the
// model's (B, T, KvE, dh) cache or (n_pages, P, KvE, dh) page store (and its
// (..., KvE) scales) as transposed views with no copy.  Values need 16-byte
// aligned bases and strides; scales need 4 bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// How a K/V source is laid out: element (b, kv_row, t, d) lives at a row
// base (batch row b's head row for a linear cache; the head row of page 0
// for a paged one) plus the offset of position t from it.  Strides are in
// elements, `*_sb` along the batch or page axis.  The pointers themselves
// are kernel parameters, so they keep their __restrict__.
template <typename E, bool PAGED, bool QUANT>
struct KVSource {
  using Elem = E;
  static constexpr bool kPaged = PAGED;
  static constexpr bool kQuant = QUANT;
  int64_t k_sb, k_sh, k_st, v_sb, v_sh, v_st;
  int64_t ks_sb, ks_sh, ks_st, vs_sb, vs_sh, vs_st;  // QUANT: scales
  int T_len;                // linear: positions; paged: the page size P
  int n_pages, n_logical;   // PAGED: pool size, np

  __device__ __forceinline__ int cap() const {
    return PAGED ? n_logical * T_len : T_len;
  }
  __device__ __forceinline__ int64_t row(int64_t sb, int64_t sh, int b,
                                         int kv_row) const {
    return kv_row * sh + (PAGED ? 0 : b * sb);
  }
  // Page-table entry `pg` of batch row b (PAGED).
  __device__ __forceinline__ int page(const int32_t* page_map, int b,
                                      int pg) const {
    return page_map[(int64_t)b * n_logical + pg];
  }
  // Where position t lies from the row bases: the page id `blk` (PAGED:
  // from the split's ids `pages`, logical page first_pg first; linear: 0)
  // and the position `off` in the page (linear: t).
  __device__ __forceinline__ void locate(const int32_t* pages, int first_pg,
                                         int t, int64_t& blk,
                                         int& off) const {
    if (PAGED) {
      const int lp = t / T_len;
      off = t - lp * T_len;
      blk = pages[lp - first_pg];
    } else {
      blk = 0;
      off = t;
    }
  }
};

struct Common {
  const void* q;
  const void* lengths;
  const void* rows;
  const void* kv_rows;
  void* out;
  int B, H, KvE, R, dh;
  int64_t q_sb, q_sh;
  cudaStream_t stream;
  float* lse = nullptr;   // (B, R) log-sum-exp, or none
  bool out_f32 = false;   // the output in float32 instead of q's dtype
};

// The K/V buffers a source reads: values, (int8) scales, (paged) page map.
struct Buffers {
  const void* k;
  const void* v;
  const void* ks;
  const void* vs;
  const void* page_map;
};

}  // namespace

// ------------------------------------------------------------------ the ring
// decode_attention_ring_resident_launch replaces the Pallas TPU kernel
// `decode_attention_ring_resident`.  For every (b, r), over the `extent`
// slots of a ring buffer that is never rotated (softmax does not depend on
// slot order) — the whole ring of W slots, or one device's contiguous
// share of a ring whose slots are sharded (extent < W; validity still
// reads the whole window W):
//   out[b, r] = softmax_t(q[b, rows[r]] . K[b, kv_rows[r], t] / sqrt(dh))
//               . V[b, kv_rows[r], t]
// over the slots t that count: validity is not a prefix (the ring wraps
// once the query position passes W), so slot t counts iff
//   lengths[b] - W <= slot_pos[t] < lengths[b]     (lengths = query pos + 1)
// and weighs 0 where it does not.  A row with no valid slot returns zeros
// through the l >= 1e-30 clamp; an out-of-range `rows` or `kv_rows` entry
// writes NaN and is never dereferenced.  Output (B, R, dh) in q's dtype.
//
// Bound: bytes.  The least work reads each valid slot's K and V row once,
// plus slot_pos, at 3.35 TB/s; ~4 flop per K/V element per q row, about
// 8 flop per byte at G = 4, far below the card's ridge.  So the design is
// about bytes in flight and each byte read once:
// - One block per (window split, KV head, b), 4 warps.  The block finds its
//   rows by scanning kv_rows (R <= H entries; any subset, in any order, with
//   partial groups), takes up to kRingRows of them per pass (one pass at
//   G <= 4), and scores each K/V tile of its split against all of them, so
//   a K/V row is read from device memory once, not once per q head.
// - The window is split so the grid holds about 4 blocks per SM (the
//   wrapper picks `split`, a multiple of 128 slots): at B 4, KvE 8, W 4096
//   that is 16 splits, 512 blocks.  A split with no valid slot reads no K/V.
// - K/V tiles go to shared memory through cp.async in 16-byte pieces, into
//   a ring of kRingStages stages, so two tiles load while one is scored.
// - Scores stay on the CUDA cores: a subgroup of dh / 8 lanes owns a slot,
//   each lane 8 contiguous head-dim elements (one 16-byte shared load per
//   K or V row at bf16), so a score needs log2(dh / 8) shuffles and every
//   lane is busy at dh 16 to 128 (dh 80: 16 lanes, the top 6 idle).  Each subgroup keeps its own (m, l, acc) in
//   log2 units (the scale and log2(e) are folded into q).
// - Each split writes its (m, l, acc[dh]) per row in float32 to scratch
//   the wrapper allocates; `split_merge_kernel` merges the splits per
//   (b, r).
//   A split with no valid slot merges as empty (m = -1e30, l = 0).
// Measured on an H100 (PERF.md): about half the bytes bound, held back by
// latency rather than bandwidth; a fourth stage (3 blocks an SM), a cap
// of 96 or 80 registers (spills) and 4 slots a subgroup per tile with a
// transposed shuffle reduction all ran slower than this layout.
namespace {

constexpr int kRingWarps = 4;
constexpr int kRingThreads = kRingWarps * 32;
constexpr int kRingRows = 4;     // q rows scored per pass over a split
constexpr int kRingStages = 3;
constexpr int kRingEPL = 8;      // head-dim elements per lane
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct RingShape {
  static constexpr int LANES = DH / kRingEPL;      // lanes holding a slot
  // lanes per slot: LANES rounded up to a power of two, so the xor
  // shuffles reduce exactly one slot's lanes (2..16; at dh 80 the top 6 of
  // 16 hold zeros: 5 elements a lane would need 10-byte loads)
  static constexpr int LPS = LANES <= 2   ? 2
                             : LANES <= 4 ? 4
                             : LANES <= 8 ? 8
                                          : 16;
  static_assert(DH % kRingEPL == 0 && LANES <= 16, "head width");
  static constexpr int SPW = 32 / LPS;             // slots a warp scores
  static constexpr int NSG = kRingWarps * SPW;     // slot subgroups
  static constexpr int U = 2;                      // slots per subgroup step
  static constexpr int TS = NSG * U > 32 ? NSG * U : 32;  // slots per tile
  static constexpr int STEPS = TS / (NSG * U);
};

template <typename E, int DH>
constexpr int ring_smem_bytes() {
  using S = RingShape<DH>;
  constexpr int pipe = kRingStages * S::TS *
                       (2 * DH * static_cast<int>(sizeof(E)) + 4);
  constexpr int merge = S::NSG * kRingRows * (DH + 2) * 4;
  return pipe > merge ? pipe : merge;
}

__device__ __forceinline__ bool in_window(int pos, int length, int W) {
  return pos < length && pos >= length - W;
}

// 16 (`full`) or 0 bytes, then zeros, global -> shared without registers
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr),
               "l"(src), "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Eight contiguous elements from 16-byte aligned shared memory, as float.
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* two = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(two[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const int8_t* p, float (&x)[8]) {
  const int2 raw = *reinterpret_cast<const int2*>(p);  // 8-byte aligned
  const char4 a = *reinterpret_cast<const char4*>(&raw.x);
  const char4 b = *reinterpret_cast<const char4*>(&raw.y);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// Slots t0 .. t0 + TS - 1 of the block's K/V head row and their slot_pos
// entries into stage `st`; slots at or past t_end are zero-filled (and
// never counted).
template <typename E, int DH>
__device__ __forceinline__ void ring_stage(E* ks, E* vs, int32_t* ps,
                                           const E* kb, const E* vb,
                                           const int32_t* slot_pos,
                                           int64_t k_st, int64_t v_st, int t0,
                                           int t_end, int tid) {
  constexpr int TS = RingShape<DH>::TS;
  constexpr int VE = 16 / static_cast<int>(sizeof(E));  // elements a copy
  constexpr int CH = DH / VE;                            // copies a row
#pragma unroll
  for (int e = tid; e < TS * CH; e += kRingThreads) {
    const int c = e / CH, d = (e % CH) * VE, t = t0 + c;
    const bool in = t < t_end;
    cp_async16(ks + c * DH + d, in ? kb + t * k_st + d : kb, in);
    cp_async16(vs + c * DH + d, in ? vb + t * v_st + d : vb, in);
  }
  for (int c = tid; c < TS; c += kRingThreads) {
    const bool in = t0 + c < t_end;
    cp_async4(ps + c, in ? slot_pos + t0 + c : slot_pos, in);
  }
}

template <typename E, int DH>
__global__ void __launch_bounds__(kRingThreads, 4)
ring_split_kernel(const E* __restrict__ q, const E* __restrict__ k,
                  const E* __restrict__ v,
                  const int32_t* __restrict__ slot_pos,
                  const int32_t* __restrict__ lengths,
                  const int32_t* __restrict__ rows,
                  const int32_t* __restrict__ kv_rows,
                  float* __restrict__ part_ml, float* __restrict__ part_acc,
                  int H, int R, int extent, int W, int split, int64_t q_sb,
                  int64_t q_sh,
                  int64_t k_sb, int64_t k_sh, int64_t k_st, int64_t v_sb,
                  int64_t v_sh, int64_t v_st, float sl2) {
  using S = RingShape<DH>;
  constexpr int TS = S::TS, LPS = S::LPS, NSG = S::NSG, U = S::U;
  extern __shared__ __align__(16) unsigned char smem[];
  E* ks = reinterpret_cast<E*>(smem);                   // [stage][TS][DH]
  E* vs = ks + kRingStages * TS * DH;                   // [stage][TS][DH]
  int32_t* ps = reinterpret_cast<int32_t*>(vs + kRingStages * TS * DH);
  // the subgroups' results, over the stages once the tiles are scored
  float* sm_m = reinterpret_cast<float*>(smem);         // [NSG][kRingRows]
  float* sm_l = sm_m + NSG * kRingRows;
  float* sm_acc = sm_l + NSG * kRingRows;               // [NSG][rows][DH]
  __shared__ int sel[kRingRows], sel_row[kRingRows];    // this pass's r
  __shared__ int n_sel, next_r;

  const int split_id = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int NS = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const int li = lane % LPS;                            // lane in subgroup
  const bool holds = li < S::LANES;  // dh 80: lanes 10..15 hold zeros
  const int sg = (tid >> 5) * S::SPW + lane / LPS;      // subgroup
  const int t_begin = split_id * split;
  const int t_end = min(extent, t_begin + split);
  const int length = lengths[b];
  const E* kb = k + b * k_sb + kvh * k_sh;
  const E* vb = v + b * v_sb + kvh * v_sh;
  // Warp 0 picks the next (up to) kRingRows entries r >= `from` whose KV
  // row is this block's and whose q row is in range, 32 entries a load.
  auto pick_rows = [&](int from) {
    int n = 0, r0 = from;
    for (; r0 < R && n < kRingRows; r0 += 32) {
      const int r = r0 + lane;
      const int row = r < R ? rows[r] : -1;
      const bool hit = r < R && kv_rows[r] == kvh && row >= 0 && row < H;
      const unsigned hits = __ballot_sync(0xffffffffu, hit);
      const int at = n + __popc(hits & ((1u << lane) - 1));
      if (hit && at < kRingRows) {
        sel[at] = r;
        sel_row[at] = row;
        if (at == kRingRows - 1) next_r = r + 1;  // the rest: a later pass
      }
      n += __popc(hits);
    }
    if (lane == 0) {
      n_sel = min(n, kRingRows);
      if (n <= kRingRows) next_r = min(r0, R);  // every hit so far taken
    }
  };
  if (tid < 32) pick_rows(0);
  // block-uniform: does any slot of the split count?
  bool any = false;
  for (int t = t_begin + tid; t < t_end; t += kRingThreads)
    any |= in_window(slot_pos[t], length, W);
  const bool live = __syncthreads_or(any);
  const int n_tiles = live ? (t_end - t_begin + TS - 1) / TS : 0;

  while (true) {  // one pass per kRingRows of this KV head's rows
    const int ng = n_sel;
    if (ng == 0) break;

#pragma unroll
    for (int st = 0; st < kRingStages - 1; ++st) {
      if (st < n_tiles)
        ring_stage<E, DH>(ks + st * TS * DH, vs + st * TS * DH, ps + st * TS,
                          kb, vb, slot_pos, k_st, v_st, t_begin + st * TS,
                          t_end, tid);
      cp_async_commit();
    }
    // q (scaled into log2 units) while the first tiles load
    float qr[kRingRows][kRingEPL], acc[kRingRows][kRingEPL];
    float m[kRingRows], l[kRingRows];
#pragma unroll
    for (int g = 0; g < kRingRows; ++g) {
      const E* qp = q + b * q_sb + (g < ng ? sel_row[g] : 0) * q_sh;
#pragma unroll
      for (int e = 0; e < kRingEPL; ++e) {
        qr[g][e] = g < ng && holds ? to_f32(qp[li * kRingEPL + e]) * sl2
                                   : 0.f;
        acc[g][e] = 0.f;
      }
      m[g] = kNegInf;
      l[g] = 0.f;
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int ahead = j + kRingStages - 1;
      if (ahead < n_tiles) {
        const int st = ahead % kRingStages;
        ring_stage<E, DH>(ks + st * TS * DH, vs + st * TS * DH, ps + st * TS,
                          kb, vb, slot_pos, k_st, v_st, t_begin + ahead * TS,
                          t_end, tid);
      }
      cp_async_commit();
      cp_async_wait<kRingStages - 1>();
      __syncthreads();
      const int st = j % kRingStages;
      const E* kt = ks + st * TS * DH;
      const E* vt = vs + st * TS * DH;
      const int32_t* pt = ps + st * TS;
      const int t0 = t_begin + j * TS;
#pragma unroll
      for (int it = 0; it < S::STEPS; ++it) {
        const int c0 = (it * NSG + sg) * U;
        float kr[U][kRingEPL], vr[U][kRingEPL], s[U][kRingRows];
        bool ok[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = c0 + u;
          ok[u] = t0 + c < t_end && in_window(pt[c], length, W);
          if (holds) {
            load8(kt + c * DH + li * kRingEPL, kr[u]);
            load8(vt + c * DH + li * kRingEPL, vr[u]);
          } else {
#pragma unroll
            for (int e = 0; e < kRingEPL; ++e) kr[u][e] = vr[u][e] = 0.f;
          }
#pragma unroll
          for (int g = 0; g < kRingRows; ++g) {
            float dot = 0.f;
#pragma unroll
            for (int e = 0; e < kRingEPL; ++e)
              dot = fmaf(qr[g][e], kr[u][e], dot);
            s[u][g] = dot;
          }
        }
#pragma unroll
        for (int off = LPS / 2; off > 0; off >>= 1) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
#pragma unroll
            for (int g = 0; g < kRingRows; ++g)
              s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);
          }
        }
#pragma unroll
        for (int g = 0; g < kRingRows; ++g) {
          float m_new = m[g];
#pragma unroll
          for (int u = 0; u < U; ++u)
            m_new = fmaxf(m_new, ok[u] ? s[u][g] : kNegInf);
          const float alpha = exp2f(m[g] - m_new);
          l[g] *= alpha;
#pragma unroll
          for (int e = 0; e < kRingEPL; ++e) acc[g][e] *= alpha;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            // a slot outside the window weighs 0 (also while m_new is still
            // -1e30) and its V row, which may hold anything, is not read
            const float p = ok[u] ? exp2f(s[u][g] - m_new) : 0.f;
            l[g] += p;
#pragma unroll
            for (int e = 0; e < kRingEPL; ++e)
              acc[g][e] = fmaf(p, ok[u] ? vr[u][e] : 0.f, acc[g][e]);
          }
          m[g] = m_new;
        }
      }
      __syncthreads();  // the stage is free for the load after next
    }
    cp_async_wait<0>();
    __syncthreads();

    // merge the subgroups' (m, l, acc) for each row: one partial per split
    if (li == 0) {
#pragma unroll
      for (int g = 0; g < kRingRows; ++g) {
        sm_m[sg * kRingRows + g] = m[g];
        sm_l[sg * kRingRows + g] = l[g];
      }
    }
    if (holds) {
#pragma unroll
      for (int g = 0; g < kRingRows; ++g) {
#pragma unroll
        for (int e = 0; e < kRingEPL; ++e)
          sm_acc[(sg * kRingRows + g) * DH + li * kRingEPL + e] = acc[g][e];
      }
    }
    __syncthreads();
    for (int e = tid; e < ng * DH; e += kRingThreads) {
      const int g = e / DH, d = e % DH;
      float m_all = kNegInf;
      for (int w = 0; w < NSG; ++w)
        m_all = fmaxf(m_all, sm_m[w * kRingRows + g]);
      float l_all = 0.f, a = 0.f;
      for (int w = 0; w < NSG; ++w) {
        const float c = exp2f(sm_m[w * kRingRows + g] - m_all);
        l_all = fmaf(sm_l[w * kRingRows + g], c, l_all);
        a = fmaf(sm_acc[(w * kRingRows + g) * DH + d], c, a);
      }
      const int64_t at = ((int64_t)b * R + sel[g]) * NS + split_id;
      part_acc[at * DH + d] = a;
      if (d == 0) {
        part_ml[2 * at] = m_all;
        part_ml[2 * at + 1] = l_all;
      }
    }
    __syncthreads();  // sel and the merge buffers are free
    if (tid < 32) pick_rows(next_r);
    __syncthreads();
  }
}

// Merges the splits' partials of each (r, b): one block of DH threads.
// The splits' (m, l) are read once, side by side, into shared memory.  The
// ring (PREFIX false) merges all NS splits.  The split body (PREFIX true)
// merges the ceil(len / split) splits that cover [0, len), len =
// clamp(lengths[b], 0, cap), and writes NaN if any of them carries the
// flag of a bad page id (l = NaN), tested explicitly: fmaxf drops a NaN.
// The output is OT (q's dtype, or float32); a non-null `lse` (B, R) takes
// the row's log-sum-exp in natural-log units, (m + log2 l) ln 2, the
// partials being in log2 units, or -1e30 where no position counted (l 0).
template <typename OT, int DH, bool PREFIX>
__global__ void __launch_bounds__(DH)
split_merge_kernel(const float* __restrict__ part_ml,
                   const float* __restrict__ part_acc,
                   const int32_t* __restrict__ rows,
                   const int32_t* __restrict__ kv_rows,
                   const int32_t* __restrict__ lengths, OT* __restrict__ out,
                   float* __restrict__ lse, int H, int KvE, int R, int NS,
                   int cap, int split) {
  extern __shared__ float ml[];  // [n][2]
  const int r = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  OT* o = out + ((int64_t)b * R + r) * DH;
  float* lo = lse != nullptr && d == 0 ? lse + (int64_t)b * R + r : nullptr;
  const int row = rows[r], kv_row = kv_rows[r];
  if (row < 0 || row >= H || kv_row < 0 || kv_row >= KvE) {
    store(o + d, nanf(""));
    if (lo) *lo = nanf("");
    return;
  }
  const int n =
      PREFIX ? (min(max(lengths[b], 0), cap) + split - 1) / split : NS;
  const int64_t at = ((int64_t)b * R + r) * NS;
  for (int i = d; i < 2 * n; i += DH) ml[i] = part_ml[2 * at + i];
  __syncthreads();
  if (PREFIX) {
    bool bad = false;
    for (int s = 0; s < n; ++s) bad |= isnan(ml[2 * s + 1]);
    if (bad) {
      store(o + d, nanf(""));
      if (lo) *lo = nanf("");
      return;
    }
  }
  float m_all = kNegInf;
  for (int s = 0; s < n; ++s) m_all = fmaxf(m_all, ml[2 * s]);
  float l_all = 0.f, a = 0.f;
#pragma unroll 8
  for (int s = 0; s < n; ++s) {
    const float c = exp2f(ml[2 * s] - m_all);
    l_all = fmaf(ml[2 * s + 1], c, l_all);
    a = fmaf(part_acc[(at + s) * DH + d], c, a);
  }
  store(o + d, a / fmaxf(l_all, 1e-30f));
  if (lo) *lo = l_all > 0.f ? (m_all + log2f(l_all)) * kLn2 : kNegInf;
}

// The merge of `NS` splits into `out` in OT, and the LSE where asked.
template <typename OT, int DH, bool PREFIX>
cudaError_t launch_merge(const float* part_ml, const float* part_acc,
                         const int32_t* rows, const int32_t* kv_rows,
                         const int32_t* lengths, void* out, float* lse,
                         int B, int H, int KvE, int R, int NS, int cap,
                         int split, cudaStream_t stream) {
  split_merge_kernel<OT, DH, PREFIX><<<dim3(R, B), DH,
                                       2 * NS * sizeof(float), stream>>>(
      part_ml, part_acc, rows, kv_rows, lengths, static_cast<OT*>(out), lse,
      H, KvE, R, NS, cap, split);
  return cudaGetLastError();
}

template <typename QT, int DH>
int launch_ring(const void* q, const void* k, const void* v,
                const void* lengths, const void* slot_pos, const void* rows,
                const void* kv_rows, void* out, float* part_ml,
                float* part_acc, float* lse, bool out_f32, int B, int H,
                int KvE, int extent, int W, int R, int split, int64_t q_sb,
                int64_t q_sh, int64_t k_sb, int64_t k_sh, int64_t k_st,
                int64_t v_sb, int64_t v_sh, int64_t v_st,
                cudaStream_t stream) {
  constexpr int bytes = ring_smem_bytes<QT, DH>();
  // above 48 KB a block's shared memory must be asked for, once
  static const cudaError_t set = cudaFuncSetAttribute(
      ring_split_kernel<QT, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int NS = (extent + split - 1) / split;
  const float sl2 = kLog2e / sqrtf(static_cast<float>(DH));
  const auto* rows32 = static_cast<const int32_t*>(rows);
  const auto* kv_rows32 = static_cast<const int32_t*>(kv_rows);
  if (NS > 0) {   // a device holding no slot of the ring merges nothing
    ring_split_kernel<QT, DH><<<dim3(NS, KvE, B), kRingThreads, bytes,
                                stream>>>(
        static_cast<const QT*>(q), static_cast<const QT*>(k),
        static_cast<const QT*>(v), static_cast<const int32_t*>(slot_pos),
        static_cast<const int32_t*>(lengths), rows32, kv_rows32, part_ml,
        part_acc, H, R, extent, W, split, q_sb, q_sh, k_sb, k_sh, k_st, v_sb,
        v_sh, v_st, sl2);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(
      out_f32 ? launch_merge<float, DH, false>(
                    part_ml, part_acc, rows32, kv_rows32, nullptr, out, lse,
                    B, H, KvE, R, NS, 0, 0, stream)
              : launch_merge<QT, DH, false>(
                    part_ml, part_acc, rows32, kv_rows32, nullptr, out, lse,
                    B, H, KvE, R, NS, 0, 0, stream));
}

}  // namespace

// ------------------------------------------------------- the split body
// The linear, int8, paged and int8-paged entry points: see the head of the
// file.  Measured on an H100: PERF.md.
namespace {

constexpr int kSplitRows = 4 * kRingRows;  // q rows scored per pass
constexpr int kSplitStages = 3;            // the CUDA-core body's stages

// (device code reads it too, so it is __host__ __device__)
template <typename E, bool QUANT, int DH>
__host__ __device__ constexpr int split_smem_bytes() {  // pipe or merge
  using S = RingShape<DH>;
  constexpr int pipe = kSplitStages * S::TS *
                       (2 * DH * static_cast<int>(sizeof(E)) + (QUANT ? 8 : 0));
  constexpr int merge = S::NSG * kRingRows * (DH + 2) * 4;
  return pipe > merge ? pipe : merge;
}

// Warp 0 picks the next (up to) N entries r >= `from` whose KV row is `kvh`
// and whose q row is in range, 32 entries a ballot.
template <int N>
__device__ __forceinline__ void pick_rows(const int32_t* rows,
                                          const int32_t* kv_rows, int R,
                                          int H, int kvh, int from, int lane,
                                          int* sel, int* sel_row, int& n_sel,
                                          int& next_r) {
  int n = 0, r0 = from;
  for (; r0 < R && n < N; r0 += 32) {
    const int r = r0 + lane;
    const int row = r < R ? rows[r] : -1;
    const bool hit = r < R && kv_rows[r] == kvh && row >= 0 && row < H;
    const unsigned hits = __ballot_sync(0xffffffffu, hit);
    const int at = n + __popc(hits & ((1u << lane) - 1));
    if (hit && at < N) {
      sel[at] = r;
      sel_row[at] = row;
      if (at == N - 1) next_r = r + 1;  // the rest: a later pass
    }
    n += __popc(hits);
  }
  if (lane == 0) {
    n_sel = min(n, N);
    if (n <= N) next_r = min(r0, R);  // every hit so far taken
  }
}

// PAGED: the page ids of logical pages first_pg .. (t_end - 1) / P of
// batch row b into `pages`, read once.  Returns, to every thread, whether
// any is outside [0, n_pages); a barrier for the block either way.
template <typename Src>
__device__ __forceinline__ bool stage_pages(const Src& src,
                                            const int32_t* page_map, int b,
                                            int first_pg, int t_end,
                                            int32_t* pages) {
  int bad = 0;
  if (Src::kPaged) {
    const int n_pg = (t_end - 1) / src.T_len - first_pg + 1;
    for (int i = threadIdx.x; i < n_pg; i += blockDim.x) {
      const int p = src.page(page_map, b, first_pg + i);
      bad |= p < 0 || p >= src.n_pages;
      pages[i] = p;
    }
  }
  return __syncthreads_or(bad);
}

// Positions t0 .. t0 + TS - 1 of the block's K/V head row (and, QUANT,
// their scales) into one stage, rows ROW elements apart; positions at or
// past t_end are zero-filled and never read.  `pages` holds the split's
// page ids from logical page first_pg (PAGED).  Each thread copies one
// 16-byte piece of rows c0, c0 + RS, ...: it finds the page and offset of
// its first row by one division and steps to the next ones.  The loop is
// unrolled for paged sources only: unrolled, a linear source keeps one
// 64-bit row offset per row and tensor live across the tile loop, and the
// bodies spilled at dh 128; not unrolled, paged ran 3 % slower (PERF.md).
template <typename Src, int DH, int TS, int ROW>
__device__ __forceinline__ void split_stage(
    typename Src::Elem* kt, typename Src::Elem* vt, float* kst, float* vst,
    const typename Src::Elem* kb, const typename Src::Elem* vb,
    const float* ksb, const float* vsb, const int32_t* pages, int first_pg,
    const Src& src, int t0, int t_end, int tid) {
  using E = typename Src::Elem;
  constexpr int VE = 16 / static_cast<int>(sizeof(E));  // elements a copy
  constexpr int CH = DH / VE;                            // copies a row
  constexpr int RS = kRingThreads / CH;                  // rows a round
  // threads past RS whole rows of copiers (dh 80: CH 5, 10 or 20) copy
  // nothing
  const bool copier = tid < RS * CH;
  const int c0 = tid / CH, d = (tid % CH) * VE;
  int lp = 0, off = 0;  // PAGED: the logical page and offset of row c
  if (Src::kPaged) {
    lp = (t0 + c0) / src.T_len;
    off = t0 + c0 - lp * src.T_len;
  }
#pragma unroll (Src::kPaged ? TS : 1)
  for (int i = 0; i < (TS + RS - 1) / RS; ++i) {
    const int c = c0 + i * RS;
    if (c >= TS || !copier) break;  // RS > TS: this thread has no row
    if (Src::kPaged && i > 0) {
      off += RS;
      while (off >= src.T_len) {
        off -= src.T_len;
        ++lp;
      }
    }
    const bool in = t0 + c < t_end;
    const int64_t blk = Src::kPaged && in ? pages[lp - first_pg] : 0;
    const int o = !in ? 0 : Src::kPaged ? off : t0 + c;
    cp_async16(kt + c * ROW + d, kb + blk * src.k_sb + o * src.k_st + d, in);
    cp_async16(vt + c * ROW + d, vb + blk * src.v_sb + o * src.v_st + d, in);
  }
  if (Src::kQuant) {
    for (int c = tid; c < TS; c += kRingThreads) {
      const int t = t0 + c;
      const bool in = t < t_end;
      int64_t blk = 0;
      int o = 0;
      if (in) src.locate(pages, first_pg, t, blk, o);
      cp_async4(kst + c, ksb + blk * src.ks_sb + o * src.ks_st, in);
      cp_async4(vst + c, vsb + blk * src.vs_sb + o * src.vs_st, in);
    }
  }
}

// The CUDA-core split body: f32 q, and int8 K/V.  A cap of 4 blocks an SM
// (128 registers) spilled and ran slower than 3 (PERF.md).
template <typename QT, typename Src, int DH>
__global__ void __launch_bounds__(kRingThreads, 3)
decode_split_kernel(const QT* __restrict__ q,
                    const typename Src::Elem* __restrict__ k,
                    const typename Src::Elem* __restrict__ v,
                    const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int32_t* __restrict__ page_map, const Src src,
                    const int32_t* __restrict__ lengths,
                    const int32_t* __restrict__ rows,
                    const int32_t* __restrict__ kv_rows,
                    float* __restrict__ part_ml, float* __restrict__ part_acc,
                    int H, int R, int split, int64_t q_sb, int64_t q_sh,
                    float sl2) {
  using E = typename Src::Elem;
  using S = RingShape<DH>;
  constexpr int TS = S::TS, LPS = S::LPS, NSG = S::NSG, U = S::U;
  extern __shared__ __align__(16) unsigned char smem[];
  E* k_tile = reinterpret_cast<E*>(smem);               // [stage][TS][DH]
  E* v_tile = k_tile + kSplitStages * TS * DH;          // [stage][TS][DH]
  float* ks_tile =                                      // QUANT: [stage][TS]
      reinterpret_cast<float*>(v_tile + kSplitStages * TS * DH);
  float* vs_tile = ks_tile + kSplitStages * TS;
  // the subgroups' results, over the stages once the tiles are scored
  float* sm_m = reinterpret_cast<float*>(smem);         // [NSG][kRingRows]
  float* sm_l = sm_m + NSG * kRingRows;
  float* sm_acc = sm_l + NSG * kRingRows;               // [NSG][rows][DH]
  // PAGED: the split's page ids, past both
  int32_t* pages = reinterpret_cast<int32_t*>(
      smem + split_smem_bytes<E, Src::kQuant, DH>());
  __shared__ int sel[kSplitRows], sel_row[kSplitRows];  // this pass's r
  __shared__ int n_sel, next_r;

  const int split_id = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int len = min(max(lengths[b], 0), src.cap());
  const int t_begin = split_id * split;
  if (t_begin >= len) return;  // block-uniform: reads and writes nothing
  const int t_end = min(len, t_begin + split);
  const int NS = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const int li = lane % LPS;                            // lane in subgroup
  const bool holds = li < S::LANES;  // dh 80: lanes 10..15 hold zeros
  const int sg = (tid >> 5) * S::SPW + lane / LPS;      // subgroup
  const E* kb = k + src.row(src.k_sb, src.k_sh, b, kvh);
  const E* vb = v + src.row(src.v_sb, src.v_sh, b, kvh);
  // the int8 scales' rows (unused for fp sources)
  const float* ksb = ks + (Src::kQuant ? src.row(src.ks_sb, src.ks_sh, b,
                                                 kvh) : 0);
  const float* vsb = vs + (Src::kQuant ? src.row(src.vs_sb, src.vs_sh, b,
                                                 kvh) : 0);
  if (tid < 32)
    pick_rows<kSplitRows>(rows, kv_rows, R, H, kvh, 0, lane, sel, sel_row,
                          n_sel, next_r);
  const int first_pg = Src::kPaged ? t_begin / src.T_len : 0;
  // block-uniform; the barrier also publishes the rows and page ids
  const bool flagged = stage_pages(src, page_map, b, first_pg, t_end, pages);
  const int n_tiles = flagged ? 0 : (t_end - t_begin + TS - 1) / TS;

  while (true) {  // one pass per kSplitRows of this KV head's rows
    const int ng = n_sel;
    if (ng == 0) break;
    // teams of kRingRows rows; each team's NSG / teams subgroups share
    // every tile's slots
    const int teams = ng <= kRingRows ? 1 : ng <= 2 * kRingRows ? 2 : 4;
    const int team = sg % teams, tsg = sg / teams, nsgt = NSG / teams;

#pragma unroll
    for (int st = 0; st < kSplitStages - 1; ++st) {
      if (st < n_tiles)
        split_stage<Src, DH, TS, DH>(
            k_tile + st * TS * DH, v_tile + st * TS * DH, ks_tile + st * TS,
            vs_tile + st * TS, kb, vb, ksb, vsb, pages, first_pg, src,
            t_begin + st * TS, t_end, tid);
      cp_async_commit();
    }
    // q (scaled into log2 units) while the first tiles load
    float qr[kRingRows][kRingEPL], acc[kRingRows][kRingEPL];
    float m[kRingRows], l[kRingRows];
#pragma unroll
    for (int g = 0; g < kRingRows; ++g) {
      const int i = team * kRingRows + g;
      const QT* qp = q + b * q_sb + (i < ng ? sel_row[i] : 0) * q_sh;
#pragma unroll
      for (int e = 0; e < kRingEPL; ++e) {
        qr[g][e] = i < ng && holds ? to_f32(qp[li * kRingEPL + e]) * sl2
                                   : 0.f;
        acc[g][e] = 0.f;
      }
      m[g] = kNegInf;
      l[g] = 0.f;
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int ahead = j + kSplitStages - 1;
      if (ahead < n_tiles) {
        const int st = ahead % kSplitStages;
        split_stage<Src, DH, TS, DH>(
            k_tile + st * TS * DH, v_tile + st * TS * DH, ks_tile + st * TS,
            vs_tile + st * TS, kb, vb, ksb, vsb, pages, first_pg, src,
            t_begin + ahead * TS, t_end, tid);
      }
      cp_async_commit();
      cp_async_wait<kSplitStages - 1>();
      __syncthreads();
      const int st = j % kSplitStages;
      const E* kt = k_tile + st * TS * DH;
      const E* vt = v_tile + st * TS * DH;
      const float* kst = ks_tile + st * TS;
      const float* vst = vs_tile + st * TS;
      const int t0 = t_begin + j * TS;
      for (int c0 = tsg * U; c0 < TS; c0 += nsgt * U) {
        float kr[U][kRingEPL], vr[U][kRingEPL], s[U][kRingRows];
        float ksc[U], vsc[U];
        bool ok[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = c0 + u;
          ok[u] = t0 + c < t_end;
          if (holds) {
            load8(kt + c * DH + li * kRingEPL, kr[u]);
            load8(vt + c * DH + li * kRingEPL, vr[u]);
          } else {
#pragma unroll
            for (int e = 0; e < kRingEPL; ++e) kr[u][e] = vr[u][e] = 0.f;
          }
          if (Src::kQuant) {
            ksc[u] = kst[c];
            vsc[u] = vst[c];
          }
#pragma unroll
          for (int g = 0; g < kRingRows; ++g) {
            float dot = 0.f;
#pragma unroll
            for (int e = 0; e < kRingEPL; ++e)
              dot = fmaf(qr[g][e], kr[u][e], dot);
            s[u][g] = dot;
          }
        }
#pragma unroll
        for (int off = LPS / 2; off > 0; off >>= 1) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
#pragma unroll
            for (int g = 0; g < kRingRows; ++g)
              s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);
          }
        }
#pragma unroll
        for (int g = 0; g < kRingRows; ++g) {
          float m_new = m[g];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (Src::kQuant) s[u][g] *= ksc[u];  // K's scale
            m_new = fmaxf(m_new, ok[u] ? s[u][g] : kNegInf);
          }
          const float alpha = exp2f(m[g] - m_new);
          l[g] *= alpha;
#pragma unroll
          for (int e = 0; e < kRingEPL; ++e) acc[g][e] *= alpha;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            // past the length: weight 0, also while m_new is still -1e30
            const float p = ok[u] ? exp2f(s[u][g] - m_new) : 0.f;
            const float pv = Src::kQuant ? p * vsc[u] : p;  // V's scale
            l[g] += p;
#pragma unroll
            for (int e = 0; e < kRingEPL; ++e)
              acc[g][e] = fmaf(pv, vr[u][e], acc[g][e]);
          }
          m[g] = m_new;
        }
      }
      __syncthreads();  // the stage is free for the load after next
    }
    cp_async_wait<0>();
    __syncthreads();

    // merge each team's subgroups per row: one partial per (row, split)
    if (li == 0) {
#pragma unroll
      for (int g = 0; g < kRingRows; ++g) {
        sm_m[sg * kRingRows + g] = m[g];
        sm_l[sg * kRingRows + g] = l[g];
      }
    }
    if (holds) {
#pragma unroll
      for (int g = 0; g < kRingRows; ++g) {
#pragma unroll
        for (int e = 0; e < kRingEPL; ++e)
          sm_acc[(sg * kRingRows + g) * DH + li * kRingEPL + e] = acc[g][e];
      }
    }
    __syncthreads();
    for (int e = tid; e < ng * DH; e += kRingThreads) {
      const int i = e / DH, d = e % DH;
      const int tm = i / kRingRows, g = i % kRingRows;  // team, its row
      float m_all = kNegInf;
      for (int w = tm; w < NSG; w += teams)
        m_all = fmaxf(m_all, sm_m[w * kRingRows + g]);
      float l_all = 0.f, a = 0.f;
      for (int w = tm; w < NSG; w += teams) {
        const float c = exp2f(sm_m[w * kRingRows + g] - m_all);
        l_all = fmaf(sm_l[w * kRingRows + g], c, l_all);
        a = fmaf(sm_acc[(w * kRingRows + g) * DH + d], c, a);
      }
      const int64_t at = ((int64_t)b * R + sel[i]) * NS + split_id;
      part_acc[at * DH + d] = a;
      if (d == 0) {
        part_ml[2 * at] = m_all;
        // the flag of a bad page id, which the merge tests
        part_ml[2 * at + 1] = flagged ? nanf("") : l_all;
      }
    }
    __syncthreads();  // sel and the merge buffers are free
    if (tid < 32)
      pick_rows<kSplitRows>(rows, kv_rows, R, H, kvh, next_r, lane, sel,
                            sel_row, n_sel, next_r);
    __syncthreads();
  }
}

// ------------------------------------------- the split body on tensor cores
// bf16 q over bf16 K/V (the dense, glm4 and paged paths) run the same
// split, rows and merge on the tensor cores: every pass's up to 16 q rows
// are one m16 tile, so QK^T is mma.sync m16n8k16 (q in registers, K by
// ldmatrix) and PV is m16n8k8 (the scores' accumulator layout is the A
// operand; V by ldmatrix.trans).  Each of the 4 warps takes 8 slots of
// every 32-slot tile and keeps its own (m, l, O[16][DH]) in f32; rows of
// the tile sit kMmaPad elements apart so ldmatrix reads no bank twice.  At
// G 16 this is ~70 warp instructions per 8 slots of a tile for all 16
// rows, against ~13 per (slot, row) on the CUDA cores.  A warp rescales O
// only when some row's running max grows.  A cap of 4 blocks an SM (128
// registers) spilled and ran slower than 3 (PERF.md).
constexpr int kMmaTile = 32;  // slots a tile; 8 per warp
constexpr int kMmaPad = 8;    // bf16 elements past each staged row
constexpr int kMmaStages = 3;

template <int DH>
__host__ __device__ constexpr int mma_smem_bytes() {  // pipe or merge
  constexpr int pipe = kMmaStages * kMmaTile * (DH + kMmaPad) * 2 * 2;
  constexpr int merge = kRingWarps * kSplitRows * (DH + 2) * 4;
  return pipe > merge ? pipe : merge;
}

// N 8x8 b16 matrices from shared memory (N = 2 or 4): lane i gives the
// address of row i % 8 of matrix i / 8.
template <int N, bool TRANS>
__device__ __forceinline__ void ldsm(uint32_t (&r)[N], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  if constexpr (N == 4 && !TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
  if constexpr (N == 4 && TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
  if constexpr (N == 2 && !TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(a));
  if constexpr (N == 2 && TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
        : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_1688(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 two = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&two);
}

__device__ __forceinline__ uint32_t pack_bf16(const __nv_bfloat16* p) {
  __nv_bfloat162 two;
  two.x = p[0];
  two.y = p[1];
  return *reinterpret_cast<const uint32_t*>(&two);
}

template <typename Src, int DH>
__global__ void __launch_bounds__(kRingThreads, 3)
decode_split_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const int32_t* __restrict__ page_map, const Src src,
                        const int32_t* __restrict__ lengths,
                        const int32_t* __restrict__ rows,
                        const int32_t* __restrict__ kv_rows,
                        float* __restrict__ part_ml,
                        float* __restrict__ part_acc, int H, int R,
                        int split, int64_t q_sb, int64_t q_sh, float sl2) {
  using E = __nv_bfloat16;
  constexpr int TS = kMmaTile, ROW = DH + kMmaPad;
  constexpr int N4 = DH / 32;            // ldmatrix.x4 loads of 32 columns
  constexpr bool TAIL = DH % 32 != 0;    // and an .x2 of the last 16 (16, 80)
  constexpr int NT = DH / 8;             // PV n-tiles of 8 head-dim columns
  static_assert(DH % 16 == 0, "head width");
  extern __shared__ __align__(16) unsigned char smem[];
  E* k_tile = reinterpret_cast<E*>(smem);               // [stage][TS][ROW]
  E* v_tile = k_tile + kMmaStages * TS * ROW;           // [stage][TS][ROW]
  // the warps' results, over the stages once the tiles are scored
  float* sm_m = reinterpret_cast<float*>(smem);         // [warp][16]
  float* sm_l = sm_m + kRingWarps * kSplitRows;
  float* sm_acc = sm_l + kRingWarps * kSplitRows;       // [warp][16][DH]
  int32_t* pages = reinterpret_cast<int32_t*>(smem + mma_smem_bytes<DH>());
  __shared__ int sel[kSplitRows], sel_row[kSplitRows];  // this pass's r
  __shared__ int n_sel, next_r;

  const int split_id = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int len = min(max(lengths[b], 0), src.cap());
  const int t_begin = split_id * split;
  if (t_begin >= len) return;  // block-uniform: reads and writes nothing
  const int t_end = min(len, t_begin + split);
  const int NS = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;  // the mma fragments' row, column
  const E* kb = k + src.row(src.k_sb, src.k_sh, b, kvh);
  const E* vb = v + src.row(src.v_sb, src.v_sh, b, kvh);
  if (tid < 32)
    pick_rows<kSplitRows>(rows, kv_rows, R, H, kvh, 0, lane, sel, sel_row,
                          n_sel, next_r);
  const int first_pg = Src::kPaged ? t_begin / src.T_len : 0;
  // block-uniform; the barrier also publishes the rows and page ids
  const bool flagged = stage_pages(src, page_map, b, first_pg, t_end, pages);
  const int n_tiles = flagged ? 0 : (t_end - t_begin + TS - 1) / TS;

  while (true) {  // one pass per kSplitRows of this KV head's rows
    const int ng = n_sel;
    if (ng == 0) break;
#pragma unroll
    for (int st = 0; st < kMmaStages - 1; ++st) {
      if (st < n_tiles)
        split_stage<Src, DH, TS, ROW>(
            k_tile + st * TS * ROW, v_tile + st * TS * ROW, nullptr, nullptr,
            kb, vb, nullptr, nullptr, pages, first_pg, src,
            t_begin + st * TS, t_end, tid);
      cp_async_commit();
    }
    // q rows g and g + 8 of the pass as A fragments (zero past ng)
    uint32_t qa[DH / 16][4];
    {
      const E* q0 = q + b * q_sb + (g < ng ? sel_row[g] : 0) * q_sh;
      const E* q1 = q + b * q_sb + (g + 8 < ng ? sel_row[g + 8] : 0) * q_sh;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const int d = 16 * kk + 2 * tq;
        qa[kk][0] = g < ng ? pack_bf16(q0 + d) : 0u;
        qa[kk][1] = g + 8 < ng ? pack_bf16(q1 + d) : 0u;
        qa[kk][2] = g < ng ? pack_bf16(q0 + d + 8) : 0u;
        qa[kk][3] = g + 8 < ng ? pack_bf16(q1 + d + 8) : 0u;
      }
    }
    // rows g (index 0) and g + 8 (index 1): running max in log2 units,
    // this thread's part of the sum, and O's columns 8 n + 2 tq, + 1
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float o[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

    for (int j = 0; j < n_tiles; ++j) {
      const int ahead = j + kMmaStages - 1;
      if (ahead < n_tiles) {
        const int st = ahead % kMmaStages;
        split_stage<Src, DH, TS, ROW>(
            k_tile + st * TS * ROW, v_tile + st * TS * ROW, nullptr, nullptr,
            kb, vb, nullptr, nullptr, pages, first_pg, src,
            t_begin + ahead * TS, t_end, tid);
      }
      cp_async_commit();
      cp_async_wait<kMmaStages - 1>();
      __syncthreads();
      const int st = j % kMmaStages;
      // this warp's 8 slots of the tile; lane i addresses row i % 8 of
      // matrix i / 8: columns x4 + 32 c of an x4 load, x2 + 32 N4 of the
      // tail's x2 load
      const int row = (st * TS + warp * 8 + (lane & 7)) * ROW;
      const int x4 = 8 * ((lane >> 3) & 3), x2 = 8 * ((lane >> 3) & 1);
      const E* kt = k_tile + row;
      const E* vt = v_tile + row;
      float s[4] = {0.f, 0.f, 0.f, 0.f};   // S[g | g + 8][slot 2 tq | + 1]
#pragma unroll
      for (int c = 0; c < N4; ++c) {
        uint32_t kf[4];
        ldsm<4, false>(kf, kt + 32 * c + x4);
        mma_16816(s, qa[2 * c], kf[0], kf[1]);
        mma_16816(s, qa[2 * c + 1], kf[2], kf[3]);
      }
      if constexpr (TAIL) {
        uint32_t kf[2];
        ldsm<2, false>(kf, kt + 32 * N4 + x2);
        mma_16816(s, qa[2 * N4], kf[0], kf[1]);
      }
      const int slot = t_begin + j * TS + warp * 8 + 2 * tq;
      const bool ok0 = slot < t_end, ok1 = slot + 1 < t_end;
      s[0] = ok0 ? s[0] * sl2 : kNegInf;
      s[1] = ok1 ? s[1] * sl2 : kNegInf;
      s[2] = ok0 ? s[2] * sl2 : kNegInf;
      s[3] = ok1 ? s[3] * sl2 : kNegInf;
      float mx[2] = {fmaxf(s[0], s[1]), fmaxf(s[2], s[3])};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      // warp-uniform: rescale only when some row's max grows
      if (__any_sync(0xffffffffu, mx[0] > m[0] || mx[1] > m[1])) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(m[r], mx[r]);
          const float alpha = exp2f(m[r] - m_new);
          l[r] *= alpha;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            o[n][2 * r] *= alpha;
            o[n][2 * r + 1] *= alpha;
          }
          m[r] = m_new;
        }
      }
      // past the length: weight 0, also while m is still -1e30
      const float p0 = ok0 ? exp2f(s[0] - m[0]) : 0.f;
      const float p1 = ok1 ? exp2f(s[1] - m[0]) : 0.f;
      const float p2 = ok0 ? exp2f(s[2] - m[1]) : 0.f;
      const float p3 = ok1 ? exp2f(s[3] - m[1]) : 0.f;
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      const uint32_t pa0 = pack_bf16(p0, p1), pa1 = pack_bf16(p2, p3);
#pragma unroll
      for (int c = 0; c < N4; ++c) {
        uint32_t vf[4];
        ldsm<4, true>(vf, vt + 32 * c + x4);
#pragma unroll
        for (int h = 0; h < 4; ++h) mma_1688(o[4 * c + h], pa0, pa1, vf[h]);
      }
      if constexpr (TAIL) {
        uint32_t vf[2];
        ldsm<2, true>(vf, vt + 32 * N4 + x2);
        mma_1688(o[4 * N4], pa0, pa1, vf[0]);
        mma_1688(o[4 * N4 + 1], pa0, pa1, vf[1]);
      }
      __syncthreads();  // the stage is free for the load after next
    }
    cp_async_wait<0>();
    __syncthreads();

    // merge the warps' (m, l, O) per row: one partial per (row, split)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int at = warp * kSplitRows + g + 8 * r;
      if (tq == 0) {
        sm_m[at] = m[r];
        sm_l[at] = l[r];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        sm_acc[at * DH + 8 * n + 2 * tq] = o[n][2 * r];
        sm_acc[at * DH + 8 * n + 2 * tq + 1] = o[n][2 * r + 1];
      }
    }
    __syncthreads();
    for (int e = tid; e < ng * DH; e += kRingThreads) {
      const int i = e / DH, d = e % DH;
      float m_all = kNegInf;
#pragma unroll
      for (int w = 0; w < kRingWarps; ++w)
        m_all = fmaxf(m_all, sm_m[w * kSplitRows + i]);
      float l_all = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < kRingWarps; ++w) {
        const float c = exp2f(sm_m[w * kSplitRows + i] - m_all);
        l_all = fmaf(sm_l[w * kSplitRows + i], c, l_all);
        a = fmaf(sm_acc[(w * kSplitRows + i) * DH + d], c, a);
      }
      const int64_t at = ((int64_t)b * R + sel[i]) * NS + split_id;
      part_acc[at * DH + d] = a;
      if (d == 0) {
        part_ml[2 * at] = m_all;
        // the flag of a bad page id, which the merge tests
        part_ml[2 * at + 1] = flagged ? nanf("") : l_all;
      }
    }
    __syncthreads();  // sel and the merge buffers are free
    if (tid < 32)
      pick_rows<kSplitRows>(rows, kv_rows, R, H, kvh, next_r, lane, sel,
                            sel_row, n_sel, next_r);
    __syncthreads();
  }
}

// The split body's scratch: part_ml (B, R, NS, 2) and part_acc
// (B, R, NS, dh) float32, NS = ceil(cap / split).
struct Split {
  float* part_ml;
  float* part_acc;
  int split;
};

// Launches `kernel` with `bytes` of dynamic shared memory, asking for
// them first where a launch has not asked for as many (above 48 KB, static
// shared memory included, a block must ask).
template <typename Kernel, typename... Args>
cudaError_t launch_with_smem(Kernel kernel, int& allowed, int bytes,
                             dim3 grid, cudaStream_t stream, Args... args) {
  if (bytes > allowed) {
    const cudaError_t set = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (set != cudaSuccess) return set;
    allowed = bytes;
  }
  kernel<<<grid, kRingThreads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

template <typename QT, typename Src, int DH>
int launch_split_dh(const Common& c, const Buffers& buf, const Src& src,
                    const Split& sp) {
  using E = typename Src::Elem;
  // bf16 q over bf16 K/V: the tensor-core body; f32 and int8: CUDA cores
  constexpr bool kMma = std::is_same<QT, __nv_bfloat16>::value &&
                        std::is_same<E, __nv_bfloat16>::value;
  const int cap = Src::kPaged ? src.n_logical * src.T_len : src.T_len;
  const int NS = (cap + sp.split - 1) / sp.split;
  // a split of `split` positions spans at most (split - 1) / P + 2 pages
  const int bytes =
      (kMma ? mma_smem_bytes<DH>() : split_smem_bytes<E, Src::kQuant, DH>()) +
      (Src::kPaged ? 4 * ((sp.split - 1) / src.T_len + 2) : 0);
  static int allowed = 0;
  const float sl2 = kLog2e / sqrtf(static_cast<float>(DH));
  const dim3 grid(NS, c.KvE, c.B);
  const auto* lengths = static_cast<const int32_t*>(c.lengths);
  const auto* rows = static_cast<const int32_t*>(c.rows);
  const auto* kv_rows = static_cast<const int32_t*>(c.kv_rows);
  const auto* page_map = static_cast<const int32_t*>(buf.page_map);
  cudaError_t err = cudaSuccess;
  if (NS > 0) {
    if constexpr (kMma)
      err = launch_with_smem(
          decode_split_mma_kernel<Src, DH>, allowed, bytes, grid, c.stream,
          static_cast<const E*>(c.q), static_cast<const E*>(buf.k),
          static_cast<const E*>(buf.v), page_map, src, lengths, rows,
          kv_rows, sp.part_ml, sp.part_acc, c.H, c.R, sp.split, c.q_sb,
          c.q_sh, sl2);
    else
      err = launch_with_smem(
          decode_split_kernel<QT, Src, DH>, allowed, bytes, grid, c.stream,
          static_cast<const QT*>(c.q), static_cast<const E*>(buf.k),
          static_cast<const E*>(buf.v), static_cast<const float*>(buf.ks),
          static_cast<const float*>(buf.vs), page_map, src, lengths, rows,
          kv_rows, sp.part_ml, sp.part_acc, c.H, c.R, sp.split, c.q_sb,
          c.q_sh, sl2);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      c.out_f32 ? launch_merge<float, DH, true>(
                      sp.part_ml, sp.part_acc, rows, kv_rows, lengths, c.out,
                      c.lse, c.B, c.H, c.KvE, c.R, NS, cap, sp.split,
                      c.stream)
                : launch_merge<QT, DH, true>(
                      sp.part_ml, sp.part_acc, rows, kv_rows, lengths, c.out,
                      c.lse, c.B, c.H, c.KvE, c.R, NS, cap, sp.split,
                      c.stream));
}

template <typename QT, typename Src>
int launch_split(const Common& c, const Buffers& buf, const Src& src,
                 const Split& sp) {
  if (sp.split <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (c.dh) {
    case 16: return launch_split_dh<QT, Src, 16>(c, buf, src, sp);
    case 32: return launch_split_dh<QT, Src, 32>(c, buf, src, sp);
    case 64: return launch_split_dh<QT, Src, 64>(c, buf, src, sp);
    case 80: return launch_split_dh<QT, Src, 80>(c, buf, src, sp);
    case 128: return launch_split_dh<QT, Src, 128>(c, buf, src, sp);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
struct Tag {
  using type = T;
};

// Builds the K/V source for q's dtype and hands it to `go(Tag<QT>, src)`,
// which launches the split body.
template <bool PAGED, bool QUANT, typename Go>
int run_source(int dtype, int T_len, int n_pages, int n_logical,
               int64_t k_sb, int64_t k_sh, int64_t k_st, int64_t v_sb,
               int64_t v_sh, int64_t v_st, int64_t ks_sb, int64_t ks_sh,
               int64_t ks_st, int64_t vs_sb, int64_t vs_sh, int64_t vs_st,
               Go go) {
  if (T_len <= 0 && PAGED) return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_SOURCE(QT)                                                    \
  {                                                                         \
    using E = typename std::conditional<QUANT, int8_t, QT>::type;           \
    const KVSource<E, PAGED, QUANT> src{k_sb,  k_sh,  k_st,  v_sb,  v_sh,   \
                                        v_st,  ks_sb, ks_sh, ks_st, vs_sb,  \
                                        vs_sh, vs_st, T_len, n_pages,       \
                                        n_logical};                         \
    return go(Tag<QT>{}, src);                                              \
  }
  if (dtype == 0) REPRO_SOURCE(float)
  if (dtype == 1) REPRO_SOURCE(__nv_bfloat16)
#undef REPRO_SOURCE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry points bound with ctypes.  Pointers are device pointers;
// strides are in elements; dtype is q's (and the output's): 0 = float32,
// 1 = bfloat16.  Each launches on `stream`, does not synchronise, and
// returns cudaGetLastError() after the launch (0 = success).  The four
// split-body entry points take part_ml (B, R, NS, 2) and part_acc (B, R,
// NS, dh) float32 scratch for NS = ceil(cap / split) splits of `split` > 0
// positions, and 16-byte aligned value bases and strides.

// K/V (B, KvE, T, dh) in q's dtype; lse (B, R) float32 or null; out_f32:
// the output in float32 (else q's dtype).
extern "C" int decode_attention_resident_launch(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* rows, const void* kv_rows, void* out, void* part_ml,
    void* part_acc, void* lse, int B, int H, int KvE, int T_len, int R,
    int split, int out_f32, int dh, int dtype, int64_t q_sb, int64_t q_sh,
    int64_t k_sb, int64_t k_sh, int64_t k_st, int64_t v_sb, int64_t v_sh,
    int64_t v_st, void* stream) {
  const Common c{q, lengths, rows, kv_rows, out, B, H, KvE, R, dh,
                 q_sb, q_sh, static_cast<cudaStream_t>(stream),
                 static_cast<float*>(lse), out_f32 != 0};
  const Buffers buf{k, v, nullptr, nullptr, nullptr};
  const Split sp{static_cast<float*>(part_ml), static_cast<float*>(part_acc),
                 split};
  return run_source<false, false>(
      dtype, T_len, 0, 0, k_sb, k_sh, k_st, v_sb, v_sh, v_st, 0, 0, 0, 0, 0,
      0, [&](auto tag, const auto& src) {
        return launch_split<typename decltype(tag)::type>(c, buf, src, sp);
      });
}

// K/V (B, KvE, T, dh) int8; scales (B, KvE, T) float32.
extern "C" int decode_attention_int8_resident_launch(
    const void* q, const void* k, const void* ks, const void* v,
    const void* vs, const void* lengths, const void* rows,
    const void* kv_rows, void* out, void* part_ml, void* part_acc, int B,
    int H, int KvE, int T_len, int R, int split, int dh, int dtype,
    int64_t q_sb, int64_t q_sh, int64_t k_sb, int64_t k_sh, int64_t k_st,
    int64_t v_sb, int64_t v_sh, int64_t v_st, int64_t ks_sb, int64_t ks_sh,
    int64_t ks_st, int64_t vs_sb, int64_t vs_sh, int64_t vs_st,
    void* stream) {
  const Common c{q, lengths, rows, kv_rows, out, B, H, KvE, R, dh,
                 q_sb, q_sh, static_cast<cudaStream_t>(stream)};
  const Buffers buf{k, v, ks, vs, nullptr};
  const Split sp{static_cast<float*>(part_ml), static_cast<float*>(part_acc),
                 split};
  return run_source<false, true>(
      dtype, T_len, 0, 0, k_sb, k_sh, k_st, v_sb, v_sh, v_st, ks_sb, ks_sh,
      ks_st, vs_sb, vs_sh, vs_st, [&](auto tag, const auto& src) {
        return launch_split<typename decltype(tag)::type>(c, buf, src, sp);
      });
}

// K/V pages (n_pages, KvE, P, dh) in q's dtype; page_map (B, np) int32.
extern "C" int decode_attention_paged_resident_launch(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* page_map, const void* rows, const void* kv_rows, void* out,
    void* part_ml, void* part_acc, int B, int H, int KvE, int P, int n_pages,
    int n_logical, int R, int split, int dh, int dtype, int64_t q_sb,
    int64_t q_sh, int64_t k_sp, int64_t k_sh, int64_t k_st, int64_t v_sp,
    int64_t v_sh, int64_t v_st, void* stream) {
  const Common c{q, lengths, rows, kv_rows, out, B, H, KvE, R, dh,
                 q_sb, q_sh, static_cast<cudaStream_t>(stream)};
  const Buffers buf{k, v, nullptr, nullptr, page_map};
  const Split sp{static_cast<float*>(part_ml), static_cast<float*>(part_acc),
                 split};
  return run_source<true, false>(
      dtype, P, n_pages, n_logical, k_sp, k_sh, k_st, v_sp, v_sh, v_st, 0, 0,
      0, 0, 0, 0, [&](auto tag, const auto& src) {
        return launch_split<typename decltype(tag)::type>(c, buf, src, sp);
      });
}

// K/V pages (n_pages, KvE, P, dh) int8; scale pages (n_pages, KvE, P)
// float32; page_map (B, np) int32.
extern "C" int decode_attention_int8_paged_resident_launch(
    const void* q, const void* k, const void* ks, const void* v,
    const void* vs, const void* lengths, const void* page_map,
    const void* rows, const void* kv_rows, void* out, void* part_ml,
    void* part_acc, int B, int H, int KvE, int P, int n_pages,
    int n_logical, int R, int split, int dh, int dtype, int64_t q_sb,
    int64_t q_sh, int64_t k_sp, int64_t k_sh, int64_t k_st, int64_t v_sp,
    int64_t v_sh, int64_t v_st, int64_t ks_sp, int64_t ks_sh, int64_t ks_st,
    int64_t vs_sp, int64_t vs_sh, int64_t vs_st, void* stream) {
  const Common c{q, lengths, rows, kv_rows, out, B, H, KvE, R, dh,
                 q_sb, q_sh, static_cast<cudaStream_t>(stream)};
  const Buffers buf{k, v, ks, vs, page_map};
  const Split sp{static_cast<float*>(part_ml), static_cast<float*>(part_acc),
                 split};
  return run_source<true, true>(
      dtype, P, n_pages, n_logical, k_sp, k_sh, k_st, v_sp, v_sh, v_st,
      ks_sp, ks_sh, ks_st, vs_sp, vs_sh, vs_st,
      [&](auto tag, const auto& src) {
        return launch_split<typename decltype(tag)::type>(c, buf, src, sp);
      });
}

// A sliding-window ring K/V (B, KvE, extent, dh) in q's dtype, 16-byte
// aligned bases and strides: the whole ring (extent == window) or a
// device's share of its slots (0 <= extent <= window); slot_pos (extent,)
// int32, the absolute position each slot holds; lengths (B,) = query
// position + 1; slot t counts iff lengths[b] - window <= slot_pos[t] <
// lengths[b].  part_ml (B, R, NS, 2) and part_acc (B, R, NS, dh) float32
// are scratch for the NS = ceil(extent / split) splits; split is a
// positive multiple of 128.  lse and out_f32 as for the resident entry.
extern "C" int decode_attention_ring_resident_launch(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* slot_pos, const void* rows, const void* kv_rows, void* out,
    void* part_ml, void* part_acc, void* lse, int B, int H, int KvE,
    int extent, int window, int R, int split, int out_f32, int dh,
    int dtype, int64_t q_sb, int64_t q_sh, int64_t k_sb, int64_t k_sh,
    int64_t k_st, int64_t v_sb, int64_t v_sh, int64_t v_st, void* stream) {
  if (window <= 0 || extent < 0 || extent > window || split <= 0 ||
      split % 128)
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_RING(QT, DH)                                                  \
  return launch_ring<QT, DH>(                                               \
      q, k, v, lengths, slot_pos, rows, kv_rows, out,                       \
      static_cast<float*>(part_ml), static_cast<float*>(part_acc),          \
      static_cast<float*>(lse), out_f32 != 0, B, H, KvE, extent, window, R, \
      split, q_sb, q_sh, k_sb, k_sh, k_st, v_sb, v_sh, v_st,                \
      static_cast<cudaStream_t>(stream))
#define REPRO_RING_DH(QT)            \
  switch (dh) {                      \
    case 16: REPRO_RING(QT, 16);     \
    case 32: REPRO_RING(QT, 32);     \
    case 64: REPRO_RING(QT, 64);     \
    case 80: REPRO_RING(QT, 80);     \
    case 128: REPRO_RING(QT, 128);   \
  }
  if (dtype == 0) REPRO_RING_DH(float)
  if (dtype == 1) REPRO_RING_DH(__nv_bfloat16)
#undef REPRO_RING_DH
#undef REPRO_RING
  return static_cast<int>(cudaErrorInvalidValue);
}
