// Resident flash-decode for Hopper (sm_90a): one query token per batch row
// against a long KV cache, over only the q-head rows one device hosts.
//
// Two designs, five extern "C" entry points; each entry point replaces one
// Pallas TPU kernel of the JAX package's src/repro/kernels/decode_attention.py:
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
// The first four share one flash body, as the reference's one Pallas body
// (`_kernel` / `_kernel_int8`) serves its four Pallas kernels, which differ
// in how K/V blocks are addressed and dequantized.  Same function for each:
// for every (b, r)
//   out[b, r] = softmax(q[b, rows[r]] . K[b, kv_rows[r], :len]^T / sqrt(dh))
//               . V[b, kv_rows[r], :len],      len = clamp(lengths[b], 0, cap)
// with cap = T (linear) or np * P (paged), f32 accumulation, an online
// softmax (m, l, acc) and the reference's l >= 1e-30 clamp, so a row with
// len == 0 returns zeros.  Paged position t reads page page_map[b, t / P] at
// offset t % P; int8 element (t, d) is q8 * scale[t] (the scale is applied
// to the dot product for K and to the softmax weight for V, which is the
// same sum, regrouped).  Output (B, R, dh) in q's dtype, in `rows` order.
//
// Bound: memory.  The least work is reading each valid K/V row once,
//   sum_b len_b * KvE * 2 (k and v) * (dh * itemsize [+ 4 for an int8 scale])
// bytes at 3.35 TB/s (H100 SXM); the arithmetic is ~4 flop per K/V element,
// far below the card's ridge point.  Paging reads the same bytes as the
// linear cache; int8 reads (dh + 4) / (2 dh) of bf16's.
//
// Design (simple first): one thread block per (r, b) with kWarps warps.  The
// TPU's sequential kv grid axis becomes a loop inside the block: warp w walks
// positions w*kUnroll, w*kUnroll + kWarps*kUnroll, ..., kUnroll positions at a
// time so their loads are in flight together, and keeps its own (m, l, acc)
// with acc spread over the lanes (dh/32 floats per lane, dh < 32 leaves lanes
// idle).  One merge in shared memory at the end.  Blocks of consecutive r
// share a KV head under a group-consistent layout and run side by side, so
// the G re-reads of a KV row mostly hit L2.  Still, this design re-reads each
// KV row once per q-head of its group (G = 4 for llama3-8b) and does no
// split over the sequence; split-K, TMA and shared KV loads per group are
// later work.  The page size P is any positive integer: each position looks
// up its own page, so P need not be a multiple of kUnroll.
//
// K, V and scales are read through their strides, so the caller passes the
// model's (B, T, KvE, dh) cache or (n_pages, P, KvE, dh) page store (and its
// (..., KvE) scales) as transposed views with no copy.  A gather map or a
// read page id out of range writes NaN and is never dereferenced.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;
constexpr float kNegInf = -1e30f;

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
  // Block-uniform: every page a row of length `len` reads lies in the pool.
  __device__ __forceinline__ bool pages_ok(const int32_t* page_map, int b,
                                           int len) const {
    if (!PAGED) return true;
    int bad = 0;
    const int live = (len + T_len - 1) / T_len;
    for (int i = threadIdx.x; i < live; i += blockDim.x) {
      const int p = page(page_map, b, i);
      bad |= p < 0 || p >= n_pages;
    }
    return !__syncthreads_or(bad);
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
  // Offsets from the row bases of logical page `pg`, offset `off` (linear:
  // page 0, offset t): K, V and (QUANT) their scales.  Paged position t is
  // page page_map[b, t / P], offset t % P.
  __device__ __forceinline__ void offsets(const int32_t* page_map, int b,
                                          int pg, int off, int64_t& ko,
                                          int64_t& vo, int64_t& kso,
                                          int64_t& vso) const {
    const int64_t blk = PAGED ? page(page_map, b, pg) : 0;
    ko = blk * k_sb + off * k_st;
    vo = blk * v_sb + off * v_st;
    if (QUANT) {
      kso = blk * ks_sb + off * ks_st;
      vso = blk * vs_sb + off * vs_st;
    }
  }
};

// The second bound is the blocks an SM must hold at once; ptxas caps the
// registers to fit (65536 / (256 threads * blocks)).  At 4 the linear fp
// source fits in 64 registers (87 left free) and runs faster.  Under a
// minimum of 3 or 4 the int8 and paged fp sources ran slower, and int8-paged
// within 5 %, so theirs is 1 (no cap).
template <typename QT, typename Src, int DH>
__global__ void __launch_bounds__(kWarps * 32,
                                  Src::kPaged || Src::kQuant ? 1 : 4)
decode_attention_kernel(const QT* __restrict__ q,
                        const typename Src::Elem* __restrict__ k,
                        const typename Src::Elem* __restrict__ v,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs,
                        const int32_t* __restrict__ page_map, const Src src,
                        const int32_t* __restrict__ lengths,
                        const int32_t* __restrict__ rows,
                        const int32_t* __restrict__ kv_rows,
                        QT* __restrict__ out, int H, int KvE, int R,
                        int64_t q_sb, int64_t q_sh, float scale) {
  constexpr int EPL = (DH + 31) / 32;  // head-dim elements per lane
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][DH];

  const int r = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = rows[r];
  const int kv_row = kv_rows[r];
  QT* o = out + ((int64_t)b * R + r) * DH;
  const int len = min(max(lengths[b], 0), src.cap());
  // both tests are uniform over the block, so its threads leave together
  if (row < 0 || row >= H || kv_row < 0 || kv_row >= KvE ||
      !src.pages_ok(page_map, b, len)) {
    // a gather map or page id out of range: surface it as NaN, never read
    // out of bounds
    for (int d = threadIdx.x; d < DH; d += blockDim.x) store(o + d, nanf(""));
    return;
  }

  const QT* qp = q + b * q_sb + row * q_sh;
  const auto* kp = k + src.row(src.k_sb, src.k_sh, b, kv_row);
  const auto* vp = v + src.row(src.v_sb, src.v_sh, b, kv_row);
  // the int8 scales' rows (unused, and compiled away, for fp sources)
  const float* ksp = ks + (Src::kQuant ? src.row(src.ks_sb, src.ks_sh, b,
                                                 kv_row) : 0);
  const float* vsp = vs + (Src::kQuant ? src.row(src.vs_sb, src.vs_sh, b,
                                                 kv_row) : 0);
  float qr[EPL];
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    const int d = i * 32 + lane;
    qr[i] = d < DH ? to_f32(qp[d]) * scale : 0.f;
  }

  float m = kNegInf, l = 0.f;
  float acc[EPL];
#pragma unroll
  for (int i = 0; i < EPL; ++i) acc[i] = 0.f;

  for (int t0 = warp * kUnroll; t0 < len; t0 += kWarps * kUnroll) {
    // ksc/vsc: the int8 scales of each position (fp sources leave them
    // unused, and the compiler drops them)
    float kr[kUnroll][EPL], vr[kUnroll][EPL], s[kUnroll], ksc[kUnroll],
        vsc[kUnroll];
    // Where the positions lie.  Linear: offset t, computed for every
    // position with no branch, so it stays affine in t0 and the compiler
    // strength-reduces it across steps.  Paged: one division per step (one
    // more only where the step crosses a page), and each position below
    // the length reads its own page id.  (Both were chosen on the card:
    // one page-id read per step, or a branch in the linear offsets, ran
    // slower.)
    const int pg0 = Src::kPaged ? t0 / src.T_len : 0;
    const int off0 = t0 - pg0 * src.T_len;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      const bool ok = t < len;
      int pg = pg0, off = off0 + u;
      if (Src::kPaged && off >= src.T_len) {
        pg += off / src.T_len;
        off %= src.T_len;
      }
      int64_t ko = 0, vo = 0, kso = 0, vso = 0;
      if (!Src::kPaged || ok)
        src.offsets(page_map, b, pg, off, ko, vo, kso, vso);
      if (Src::kQuant) {
        ksc[u] = ok ? ksp[kso] : 0.f;
        vsc[u] = ok ? vsp[vso] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < EPL; ++i) {
        const int d = i * 32 + lane;
        const bool in = ok && d < DH;
        kr[u][i] = in ? to_f32(kp[ko + d]) : 0.f;
        vr[u][i] = in ? to_f32(vp[vo + d]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float acc_s = 0.f;
#pragma unroll
      for (int i = 0; i < EPL; ++i) acc_s += qr[i] * kr[u][i];
      s[u] = acc_s;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
    }
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (Src::kQuant) s[u] *= ksc[u];
      if (t0 + u >= len) s[u] = kNegInf;
      m_new = fmaxf(m_new, s[u]);
    }
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float p = expf(s[u] - m_new);
      const float pv = Src::kQuant ? p * vsc[u] : p;
      l += p;
#pragma unroll
      for (int i = 0; i < EPL; ++i) acc[i] += pv * vr[u][i];
    }
    m = m_new;
  }

  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    const int d = i * 32 + lane;
    if (d < DH) sm_acc[warp][d] = acc[i];
  }
  __syncthreads();
  float m_all = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, sm_m[w]);
  for (int d = threadIdx.x; d < DH; d += blockDim.x) {
    float l_all = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w] - m_all);
      l_all += sm_l[w] * c;
      a += sm_acc[w][d] * c;
    }
    store(o + d, a / fmaxf(l_all, 1e-30f));
  }
}

struct Common {
  const void* q;
  const void* lengths;
  const void* rows;
  const void* kv_rows;
  void* out;
  int B, H, KvE, R, dh;
  int64_t q_sb, q_sh;
  cudaStream_t stream;
};

// The K/V buffers a source reads: values, (int8) scales, (paged) page map.
struct Buffers {
  const void* k;
  const void* v;
  const void* ks;
  const void* vs;
  const void* page_map;
};

template <typename QT, typename Src>
int launch(const Common& c, const Buffers& buf, const Src& src) {
  using E = typename Src::Elem;
  const dim3 grid(c.R, c.B);
  const float scale = 1.0f / sqrtf(static_cast<float>(c.dh));
#define REPRO_LAUNCH(DH)                                                     \
  decode_attention_kernel<QT, Src, DH><<<grid, kWarps * 32, 0, c.stream>>>( \
      static_cast<const QT*>(c.q), static_cast<const E*>(buf.k),            \
      static_cast<const E*>(buf.v), static_cast<const float*>(buf.ks),      \
      static_cast<const float*>(buf.vs),                                    \
      static_cast<const int32_t*>(buf.page_map), src,                       \
      static_cast<const int32_t*>(c.lengths),                               \
      static_cast<const int32_t*>(c.rows),                                  \
      static_cast<const int32_t*>(c.kv_rows), static_cast<QT*>(c.out), c.H, \
      c.KvE, c.R, c.q_sb, c.q_sh, scale)
  switch (c.dh) {
    case 16: REPRO_LAUNCH(16); break;
    case 32: REPRO_LAUNCH(32); break;
    case 64: REPRO_LAUNCH(64); break;
    case 128: REPRO_LAUNCH(128); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

template <bool PAGED, bool QUANT>
int run_source(int dtype, const Common& c, const Buffers& buf, int T_len,
               int n_pages, int n_logical, int64_t k_sb, int64_t k_sh,
               int64_t k_st, int64_t v_sb, int64_t v_sh, int64_t v_st,
               int64_t ks_sb, int64_t ks_sh, int64_t ks_st, int64_t vs_sb,
               int64_t vs_sh, int64_t vs_st) {
  if (PAGED && T_len <= 0) return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_SOURCE(QT)                                                    \
  {                                                                         \
    using E = typename std::conditional<QUANT, int8_t, QT>::type;           \
    const KVSource<E, PAGED, QUANT> src{k_sb,  k_sh,  k_st,  v_sb,  v_sh,   \
                                        v_st,  ks_sb, ks_sh, ks_st, vs_sb,  \
                                        vs_sh, vs_st, T_len, n_pages,       \
                                        n_logical};                         \
    return launch<QT>(c, buf, src);                                         \
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
// returns cudaGetLastError() after the launch (0 = success).

// K/V (B, KvE, T, dh) in q's dtype.
extern "C" int decode_attention_resident_launch(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* rows, const void* kv_rows, void* out, int B, int H, int KvE,
    int T_len, int R, int dh, int dtype, int64_t q_sb, int64_t q_sh,
    int64_t k_sb, int64_t k_sh, int64_t k_st, int64_t v_sb, int64_t v_sh,
    int64_t v_st, void* stream) {
  const Common c{q, lengths, rows, kv_rows, out, B, H, KvE, R, dh,
                 q_sb, q_sh, static_cast<cudaStream_t>(stream)};
  return run_source<false, false>(dtype, c, {k, v, nullptr, nullptr, nullptr},
                                  T_len, 0, 0, k_sb, k_sh, k_st, v_sb, v_sh,
                                  v_st, 0, 0, 0, 0, 0, 0);
}

// K/V (B, KvE, T, dh) int8; scales (B, KvE, T) float32.
extern "C" int decode_attention_int8_resident_launch(
    const void* q, const void* k, const void* ks, const void* v,
    const void* vs, const void* lengths, const void* rows,
    const void* kv_rows, void* out, int B, int H, int KvE, int T_len, int R,
    int dh, int dtype, int64_t q_sb, int64_t q_sh, int64_t k_sb,
    int64_t k_sh, int64_t k_st, int64_t v_sb, int64_t v_sh, int64_t v_st,
    int64_t ks_sb, int64_t ks_sh, int64_t ks_st, int64_t vs_sb,
    int64_t vs_sh, int64_t vs_st, void* stream) {
  const Common c{q, lengths, rows, kv_rows, out, B, H, KvE, R, dh,
                 q_sb, q_sh, static_cast<cudaStream_t>(stream)};
  return run_source<false, true>(dtype, c, {k, v, ks, vs, nullptr}, T_len, 0,
                                 0, k_sb, k_sh, k_st, v_sb, v_sh, v_st, ks_sb,
                                 ks_sh, ks_st, vs_sb, vs_sh, vs_st);
}

// K/V pages (n_pages, KvE, P, dh) in q's dtype; page_map (B, np) int32.
extern "C" int decode_attention_paged_resident_launch(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* page_map, const void* rows, const void* kv_rows, void* out,
    int B, int H, int KvE, int P, int n_pages, int n_logical, int R, int dh,
    int dtype, int64_t q_sb, int64_t q_sh, int64_t k_sp, int64_t k_sh,
    int64_t k_st, int64_t v_sp, int64_t v_sh, int64_t v_st, void* stream) {
  const Common c{q, lengths, rows, kv_rows, out, B, H, KvE, R, dh,
                 q_sb, q_sh, static_cast<cudaStream_t>(stream)};
  return run_source<true, false>(dtype, c, {k, v, nullptr, nullptr, page_map},
                                 P, n_pages, n_logical, k_sp, k_sh, k_st,
                                 v_sp, v_sh, v_st, 0, 0, 0, 0, 0, 0);
}

// K/V pages (n_pages, KvE, P, dh) int8; scale pages (n_pages, KvE, P)
// float32; page_map (B, np) int32.
extern "C" int decode_attention_int8_paged_resident_launch(
    const void* q, const void* k, const void* ks, const void* v,
    const void* vs, const void* lengths, const void* page_map,
    const void* rows, const void* kv_rows, void* out, int B, int H, int KvE,
    int P, int n_pages, int n_logical, int R, int dh, int dtype,
    int64_t q_sb, int64_t q_sh, int64_t k_sp, int64_t k_sh, int64_t k_st,
    int64_t v_sp, int64_t v_sh, int64_t v_st, int64_t ks_sp, int64_t ks_sh,
    int64_t ks_st, int64_t vs_sp, int64_t vs_sh, int64_t vs_st,
    void* stream) {
  const Common c{q, lengths, rows, kv_rows, out, B, H, KvE, R, dh,
                 q_sb, q_sh, static_cast<cudaStream_t>(stream)};
  return run_source<true, true>(dtype, c, {k, v, ks, vs, page_map}, P, n_pages,
                                n_logical, k_sp, k_sh, k_st, v_sp, v_sh, v_st,
                                ks_sp, ks_sh, ks_st, vs_sp, vs_sh, vs_st);
}

// ------------------------------------------------------------------ the ring
// decode_attention_ring_resident_launch replaces the Pallas TPU kernel
// `decode_attention_ring_resident`.  For every (b, r), over the W slots of a
// ring that is never rotated (softmax does not depend on slot order):
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
//   lane is busy at every dh.  Each subgroup keeps its own (m, l, acc) in
//   log2 units (the scale and log2(e) are folded into q).
// - Each split writes its (m, l, acc[dh]) per row in float32 to scratch
//   the wrapper allocates; `ring_merge_kernel` merges the splits per (b, r).
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
  static constexpr int LPS = DH / kRingEPL;        // lanes per slot, 2..16
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
                  int H, int R, int W, int split, int64_t q_sb, int64_t q_sh,
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
  const int sg = (tid >> 5) * S::SPW + lane / LPS;      // subgroup
  const int t_begin = split_id * split;
  const int t_end = min(W, t_begin + split);
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
        qr[g][e] = g < ng ? to_f32(qp[li * kRingEPL + e]) * sl2 : 0.f;
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
          load8(kt + c * DH + li * kRingEPL, kr[u]);
          load8(vt + c * DH + li * kRingEPL, vr[u]);
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
#pragma unroll
    for (int g = 0; g < kRingRows; ++g) {
#pragma unroll
      for (int e = 0; e < kRingEPL; ++e)
        sm_acc[(sg * kRingRows + g) * DH + li * kRingEPL + e] = acc[g][e];
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
// The splits' (m, l) are read once, side by side, into shared memory.
template <typename QT, int DH>
__global__ void __launch_bounds__(DH)
ring_merge_kernel(const float* __restrict__ part_ml,
                  const float* __restrict__ part_acc,
                  const int32_t* __restrict__ rows,
                  const int32_t* __restrict__ kv_rows, QT* __restrict__ out,
                  int H, int KvE, int R, int NS) {
  extern __shared__ float ml[];  // [NS][2]
  const int r = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  QT* o = out + ((int64_t)b * R + r) * DH;
  const int row = rows[r], kv_row = kv_rows[r];
  if (row < 0 || row >= H || kv_row < 0 || kv_row >= KvE) {
    store(o + d, nanf(""));
    return;
  }
  const int64_t at = ((int64_t)b * R + r) * NS;
  for (int i = d; i < 2 * NS; i += DH) ml[i] = part_ml[2 * at + i];
  __syncthreads();
  float m_all = kNegInf;
  for (int s = 0; s < NS; ++s) m_all = fmaxf(m_all, ml[2 * s]);
  float l_all = 0.f, a = 0.f;
#pragma unroll 8
  for (int s = 0; s < NS; ++s) {
    const float c = exp2f(ml[2 * s] - m_all);
    l_all = fmaf(ml[2 * s + 1], c, l_all);
    a = fmaf(part_acc[(at + s) * DH + d], c, a);
  }
  store(o + d, a / fmaxf(l_all, 1e-30f));
}

template <typename QT, int DH>
int launch_ring(const void* q, const void* k, const void* v,
                const void* lengths, const void* slot_pos, const void* rows,
                const void* kv_rows, void* out, float* part_ml,
                float* part_acc, int B, int H, int KvE, int W, int R,
                int split, int64_t q_sb, int64_t q_sh, int64_t k_sb,
                int64_t k_sh, int64_t k_st, int64_t v_sb, int64_t v_sh,
                int64_t v_st, cudaStream_t stream) {
  constexpr int bytes = ring_smem_bytes<QT, DH>();
  // above 48 KB a block's shared memory must be asked for, once
  static const cudaError_t set = cudaFuncSetAttribute(
      ring_split_kernel<QT, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int NS = (W + split - 1) / split;
  const float sl2 = kLog2e / sqrtf(static_cast<float>(DH));
  ring_split_kernel<QT, DH><<<dim3(NS, KvE, B), kRingThreads, bytes,
                              stream>>>(
      static_cast<const QT*>(q), static_cast<const QT*>(k),
      static_cast<const QT*>(v), static_cast<const int32_t*>(slot_pos),
      static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(kv_rows),
      part_ml, part_acc, H, R, W, split, q_sb, q_sh, k_sb, k_sh, k_st, v_sb,
      v_sh, v_st, sl2);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ring_merge_kernel<QT, DH><<<dim3(R, B), DH, 2 * NS * sizeof(float),
                              stream>>>(
      part_ml, part_acc, static_cast<const int32_t*>(rows),
      static_cast<const int32_t*>(kv_rows), static_cast<QT*>(out), H, KvE, R,
      NS);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A sliding-window ring K/V (B, KvE, W, dh) in q's dtype, 16-byte aligned
// bases and strides; slot_pos (W,) int32, the absolute position each slot
// holds; lengths (B,) = query position + 1.  part_ml (B, R, NS, 2) and
// part_acc (B, R, NS, dh) float32 are scratch for the NS = ceil(W / split)
// splits; split is a positive multiple of 128.
extern "C" int decode_attention_ring_resident_launch(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* slot_pos, const void* rows, const void* kv_rows, void* out,
    void* part_ml, void* part_acc, int B, int H, int KvE, int window, int R,
    int split, int dh, int dtype, int64_t q_sb, int64_t q_sh, int64_t k_sb,
    int64_t k_sh, int64_t k_st, int64_t v_sb, int64_t v_sh, int64_t v_st,
    void* stream) {
  if (window <= 0 || split <= 0 || split % 128)
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_RING(QT, DH)                                                  \
  return launch_ring<QT, DH>(                                               \
      q, k, v, lengths, slot_pos, rows, kv_rows, out,                       \
      static_cast<float*>(part_ml), static_cast<float*>(part_acc), B, H,    \
      KvE, window, R, split, q_sb, q_sh, k_sb, k_sh, k_st, v_sb, v_sh, v_st, \
      static_cast<cudaStream_t>(stream))
#define REPRO_RING_DH(QT)            \
  switch (dh) {                      \
    case 16: REPRO_RING(QT, 16);     \
    case 32: REPRO_RING(QT, 32);     \
    case 64: REPRO_RING(QT, 64);     \
    case 128: REPRO_RING(QT, 128);   \
  }
  if (dtype == 0) REPRO_RING_DH(float)
  if (dtype == 1) REPRO_RING_DH(__nv_bfloat16)
#undef REPRO_RING_DH
#undef REPRO_RING
  return static_cast<int>(cudaErrorInvalidValue);
}
