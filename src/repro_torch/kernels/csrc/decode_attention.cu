// Resident flash-decode for Hopper (sm_90a): one query token per batch row
// against a long KV cache, over only the q-head rows one device hosts.
//
// One flash body serves five K/V sources, as the reference's Pallas bodies
// (`_kernel` / `_kernel_int8` / `_kernel_ring`) serve its five Pallas
// kernels, which differ in how K/V blocks are addressed, dequantized and
// masked.  Each source has its own extern "C" entry point; each replaces one
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
//     i32 the absolute position each ring slot holds (empty: -2^30).
// The ring source reads every one of its W slots: validity is not a prefix
// (the ring wraps once the query position passes W), so slot t counts iff
//   lengths[b] - W <= slot_pos[t] < lengths[b]     (lengths = query pos + 1)
// and its softmax weight is set to 0 where it does not: a warp that sees no
// valid slot keeps m = -1e30, l = 0 and merges as empty, and a row with no
// valid slot returns zeros through the l >= 1e-30 clamp.  The buffer is never
// rotated: softmax does not depend on the order of the slots.
// The linear and paged sources compute, for every (b, r)
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
// linear cache; int8 reads (dh + 4) / (2 dh) of bf16's.  The ring source
// reads its W slots (len_b replaced by the valid slots of row b).
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
// are kernel parameters, so they keep their __restrict__.  A RING source is
// a linear one whose T_len = W slots are all read, each valid by its
// slot_pos entry (see `ring_valid`).
template <typename E, bool PAGED, bool QUANT, bool RING = false>
struct KVSource {
  using Elem = E;
  static constexpr bool kPaged = PAGED;
  static constexpr bool kQuant = QUANT;
  static constexpr bool kRing = RING;
  int64_t k_sb, k_sh, k_st, v_sb, v_sh, v_st;
  int64_t ks_sb, ks_sh, ks_st, vs_sb, vs_sh, vs_st;  // QUANT: scales
  int T_len;                // linear: positions; paged: the page size P;
                            // ring: the window W
  int n_pages, n_logical;   // PAGED: pool size, np

  __device__ __forceinline__ int cap() const {
    return PAGED ? n_logical * T_len : T_len;
  }
  // The positions the flash loop walks for a row whose `lengths` entry is
  // `length`: the valid prefix of a linear or paged cache, every slot of a
  // ring.
  __device__ __forceinline__ int extent(int length) const {
    return RING ? T_len : min(max(length, 0), cap());
  }
  // RING: slot t holds absolute position `pos`; it counts for the query at
  // position length - 1 iff it lies in that query's window.
  __device__ __forceinline__ bool ring_valid(int pos, int length) const {
    return pos < length && pos >= length - T_len;
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
  // `page_map` carries the page table of a paged source and slot_pos of a
  // ring source (unused by the others)
  const int length = lengths[b];
  const int len = src.extent(length);
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
    bool valid[kUnroll];  // RING: the slot lies in the row's window
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
      bool ok = t < len;
      if (Src::kRing) ok = ok && src.ring_valid(page_map[t], length);
      valid[u] = ok;
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
      if (Src::kRing ? !valid[u] : t0 + u >= len) s[u] = kNegInf;
      m_new = fmaxf(m_new, s[u]);
    }
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // a ring slot outside the window weighs 0 even while m_new is still
      // -1e30 (where expf(s - m_new) would be 1)
      const float p = Src::kRing && !valid[u] ? 0.f : expf(s[u] - m_new);
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

template <bool PAGED, bool QUANT, bool RING = false>
int run_source(int dtype, const Common& c, const Buffers& buf, int T_len,
               int n_pages, int n_logical, int64_t k_sb, int64_t k_sh,
               int64_t k_st, int64_t v_sb, int64_t v_sh, int64_t v_st,
               int64_t ks_sb, int64_t ks_sh, int64_t ks_st, int64_t vs_sb,
               int64_t vs_sh, int64_t vs_st) {
  if ((PAGED || RING) && T_len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_SOURCE(QT)                                                    \
  {                                                                         \
    using E = typename std::conditional<QUANT, int8_t, QT>::type;           \
    const KVSource<E, PAGED, QUANT, RING> src{                              \
        k_sb,  k_sh,  k_st,  v_sb,  v_sh,  v_st,  ks_sb,   ks_sh,           \
        ks_st, vs_sb, vs_sh, vs_st, T_len, n_pages, n_logical};             \
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

// A sliding-window ring K/V (B, KvE, W, dh) in q's dtype; slot_pos (W,)
// int32, the absolute position each slot holds; lengths (B,) = query
// position + 1.
extern "C" int decode_attention_ring_resident_launch(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* slot_pos, const void* rows, const void* kv_rows, void* out,
    int B, int H, int KvE, int window, int R, int dh, int dtype, int64_t q_sb,
    int64_t q_sh, int64_t k_sb, int64_t k_sh, int64_t k_st, int64_t v_sb,
    int64_t v_sh, int64_t v_st, void* stream) {
  const Common c{q, lengths, rows, kv_rows, out, B, H, KvE, R, dh,
                 q_sb, q_sh, static_cast<cudaStream_t>(stream)};
  return run_source<false, false, true>(
      dtype, c, {k, v, nullptr, nullptr, slot_pos}, window, 0, 0, k_sb, k_sh,
      k_st, v_sb, v_sh, v_st, 0, 0, 0, 0, 0, 0);
}
