// Flash attention for Hopper (sm_90a): causal, sliding-window or
// non-causal GQA prefill attention with an online softmax.
//
// Replaces the Pallas TPU kernel `flash_attention` of the JAX package's
// src/repro/kernels/flash_attention.py.  For every (b, h) and query row i,
// over the keys j the mask admits, in float32:
//   o_i = sum_j softmax_j(q_i . k_j / sqrt(dh)) v_j
// where head h reads KV group h / (H / KvE).  `causal` admits j <= i, with
// rows and columns aligned at the top left (row i is position i, column j
// position j, also when Sq != Skv), and `window` > 0 further keeps only
// j > i - window; without `causal` every column is admitted and the window
// is ignored.  The running (m, l, acc) are float32, masked scores sit at
// -1e30 with their probability set to 0, and the finalize step clamps
// l >= 1e-30 (a row that admits no key returns zeros).  o has q's dtype.
//
// Bound on this card: operations.  At the main paths' shapes (bf16, dh 128,
// 4 * H * dh flops per admitted (i, j) pair) the glm4 prefill of 8192
// tokens (B 1, H 32) does 5.5e11 flops, 0.56 ms at 989 TFLOP/s, against
// 68 MB of q, k, v and o, 0.02 ms at 3.35 TB/s; llama's 512-token bucket
// and mixtral's 4 x 4096-token windowed wave are operations-bound too.
// So the bf16 path runs on the tensor cores.
//
// Design (simple first).  The Pallas grid (B, H, nq, nk), whose sequential
// kv axis carries (m, l, acc) in VMEM scratch, becomes one thread block per
// (64-row q tile, h, b) whose loop walks the kv tiles; tiles wholly above
// the diagonal or wholly before the window are not visited, as the Pallas
// `run` predicate skips them, and the heaviest (last) q tiles are scheduled
// first.  Any Sq and Skv are taken: the ragged edges are masked here.
// - bfloat16 (`flash_mma_kernel`): 4 warps, each owning 16 q rows whose
//   fragments stay in registers.  K and V tiles of 64 rows go to shared
//   memory through cp.async into two stages, so the next tile loads while
//   this one computes.  S = Q K^T and O += P V run as mma.sync m16n8k16
//   (bf16 in, float32 accumulate) on fragments read with ldmatrix
//   (transposed for V); P is rounded to bf16 in registers; the scale is
//   folded into exp2.  Only tiles that cross the warp's diagonal, window
//   edge or Skv are masked.
// - float32 (`flash_simt_kernel`): no tensor-core path keeps float32
//   exact, so 256 threads, four per q row, each holding a quarter of the
//   row's q and acc, sum the scores on the CUDA cores from K/V tiles of 32
//   rows in shared memory.
// q, k, v and o are addressed through their (b, head, position) strides
// with a unit stride on dh, so the model passes transposed views of its
// (B, S, H, dh) activations and caches and nothing is copied.  K/V tiles
// read once per KV group rather than once per q head, 128-row q tiles and
// wgmma/TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBQ = 64;  // q rows per block

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, G, Sq, Skv, causal, window;
  float scale;
  int64_t q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st;
  int64_t o_sb, o_sh, o_st;
};

// Whether query row `row` attends key column `col`.
__device__ __forceinline__ bool attends(const Args& a, int row, int col) {
  if (col >= a.Skv) return false;
  if (!a.causal) return true;
  return col <= row && (a.window <= 0 || col > row - a.window);
}

// The keys [lo, hi) the q tile starting at q0 needs: causal, none past its
// last row; under a window, none at or before q0 - window.  lo is rounded
// down to a tile of BK keys.
template <int BK>
__device__ __forceinline__ void kv_range(const Args& a, int q0, int* lo,
                                         int* hi) {
  int l = 0, h = a.Skv;
  if (a.causal) {
    h = min(a.Skv, min(q0 + kBQ, a.Sq));
    if (a.window > 0) l = max(0, q0 - a.window + 1);
  }
  *lo = l / BK * BK;
  *hi = h;
}

// ------------------------------------------------------------ float32 path
template <int DH>
__global__ void __launch_bounds__(256) flash_simt_kernel(const Args a) {
  constexpr int BK = 32, NT = 256, DP = DH / 4;
  __shared__ float ks[BK][DH];
  __shared__ float vs[BK][DH];

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / a.G;
  const int tid = threadIdx.x, part = tid & 3;
  const int row = q0 + (tid >> 2);
  const float* q =
      static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* k =
      static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const float* v =
      static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  // this thread's quarter of the row: channels part + 4 i
  float qr[DP], acc[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    qr[i] = row < a.Sq ? q[row * a.q_st + part + 4 * i] * a.scale : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  int lo, hi;
  kv_range<BK>(a, q0, &lo, &hi);
  for (int k0 = lo; k0 < hi; k0 += BK) {
    __syncthreads();
    for (int e = tid; e < BK * DH; e += NT) {
      const int c = e / DH, d = e % DH, kr = k0 + c;
      const bool in = kr < a.Skv;
      ks[c][d] = in ? k[kr * a.k_st + d] : 0.f;
      vs[c][d] = in ? v[kr * a.v_st + d] : 0.f;
    }
    __syncthreads();
    float s[BK];
    float mt = kNegInf;
#pragma unroll
    for (int c = 0; c < BK; ++c) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) dot = fmaf(qr[i], ks[c][part + 4 * i], dot);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      s[c] = attends(a, row, k0 + c) ? dot : kNegInf;
      mt = fmaxf(mt, s[c]);
    }
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    float ls = 0.f;
#pragma unroll
    for (int c = 0; c < BK; ++c) {
      s[c] = attends(a, row, k0 + c) ? expf(s[c] - m_new) : 0.f;
      ls += s[c];
    }
    l = alpha * l + ls;
#pragma unroll
    for (int i = 0; i < DP; ++i) acc[i] *= alpha;
#pragma unroll
    for (int c = 0; c < BK; ++c) {
#pragma unroll
      for (int i = 0; i < DP; ++i)
        acc[i] = fmaf(s[c], vs[c][part + 4 * i], acc[i]);
    }
    m = m_new;
  }
  if (row < a.Sq) {
    float* o = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh +
               row * a.o_st;
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DP; ++i) o[part + 4 * i] = acc[i] * inv;
  }
}

// ----------------------------------------------------------- bfloat16 path
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 two = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&two);
}

__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// d += a (16 x 16, row-major) . b (16 x 8, column-major), float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory, lanes 8 i .. 8 i + 7
// giving the rows of matrix i; `.trans` transposes each on the way.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1,
                                            const void* row) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// 16 bytes global -> shared without passing through registers; `full`
// false writes zeros (the source is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows k0 .. k0 + BK - 1 of one (b, KV group) K or V into shared memory,
// zeros past Skv, asynchronously in 16-byte pieces: the base and the
// strides are multiples of 8 values (the wrapper refuses other K/V).
template <int DH, int BK, int NT>
__device__ __forceinline__ void stage(bf16 (*dst)[DH + 8], const bf16* src,
                                      int64_t st, int k0, int Skv, int tid) {
  constexpr int CH = DH / 8;
#pragma unroll
  for (int e = tid; e < BK * CH; e += NT) {
    const int c = e / CH, d = (e % CH) * 8;
    const bool in = k0 + c < Skv;
    cp_async16(&dst[c][d], in ? src + (k0 + c) * st + d : src, in);
  }
}

// One K/V tile against the warp's 16 q rows (ra = row g, rb = row g + 8 of
// them): S = Q K^T, the online softmax update, O += P V.  m_a/m_b are the
// running maxima of the raw scores (the scale is folded into exp2); l_a/l_b
// this thread's partial sums over its columns.  MASK applies the causal,
// window and ragged-edge masks; tiles wholly inside them skip it.
template <int DH, int BK, bool MASK>
__device__ __forceinline__ void mma_tile(
    const Args& a, const bf16 (*ks)[DH + 8], const bf16 (*vs)[DH + 8],
    const uint32_t (&qf)[DH / 16][4], float (&o)[DH / 8][4], float& m_a,
    float& m_b, float& l_a, float& l_b, int k0, int ra, int rb, int lane,
    float sl2) {
  constexpr int NJ = BK / 8, NKK = DH / 16, ND = DH / 8;
  const int g = lane >> 2, t4 = lane & 3;
  float s[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    if constexpr (NKK % 2 == 0) {
#pragma unroll
      for (int kk = 0; kk < NKK; kk += 2) {
        uint32_t b[4];  // B fragments of dh steps kk and kk + 1
        ldmatrix_x4(b, &ks[8 * j + (lane & 7)][kk * 16 + 8 * (lane >> 3)]);
        mma_bf16(s[j], qf[kk], b[0], b[1]);
        mma_bf16(s[j], qf[kk + 1], b[2], b[3]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < NKK; ++kk) {
        uint32_t b0, b1;
        ldmatrix_x2(b0, b1,
                    &ks[8 * j + (lane & 7)][kk * 16 + 8 * ((lane >> 3) & 1)]);
        mma_bf16(s[j], qf[kk], b0, b1);
      }
    }
  }
  if (MASK) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + 8 * j + 2 * t4 + e;
        if (!attends(a, ra, col)) s[j][e] = kNegInf;
        if (!attends(a, rb, col)) s[j][2 + e] = kNegInf;
      }
    }
  }
  float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
    mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
  }
  const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
  const float al_a = exp2f((m_a - mn_a) * sl2);
  const float al_b = exp2f((m_b - mn_b) * sl2);
  const float off_a = mn_a * sl2, off_b = mn_b * sl2;
  float ls_a = 0.f, ls_b = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      // a masked score is 0 (its key may not exist): never exp(0)
      s[j][e] = (!MASK || s[j][e] > kNegInf)
                    ? exp2f(fmaf(s[j][e], sl2, -off_a)) : 0.f;
      s[j][2 + e] = (!MASK || s[j][2 + e] > kNegInf)
                        ? exp2f(fmaf(s[j][2 + e], sl2, -off_b)) : 0.f;
      ls_a += s[j][e];
      ls_b += s[j][2 + e];
    }
  }
  l_a = al_a * l_a + ls_a;
  l_b = al_b * l_b + ls_b;
  m_a = mn_a;
  m_b = mn_b;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    o[nd][0] *= al_a;
    o[nd][1] *= al_a;
    o[nd][2] *= al_b;
    o[nd][3] *= al_b;
  }
  // O += P V, P as bf16 A fragments straight from the score registers;
  // V's B fragments for two dh tiles per transposed ldmatrix
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int nd = 0; nd < ND; nd += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, &vs[kk * 16 + (lane & 15)][nd * 8 + 8 * (lane >> 4)]);
      mma_bf16(o[nd], pa, b[0], b[1]);
      mma_bf16(o[nd + 1], pa, b[2], b[3]);
    }
  }
}

template <int DH>
constexpr int mma_smem_bytes() {
  return 2 * 2 * 64 * (DH + 8) * static_cast<int>(sizeof(bf16));
}

// Three blocks per SM: at dh 128 that caps the registers at 168 (a few
// bytes spill), which timed faster on the card than two blocks at 173.
template <int DH>
__global__ void __launch_bounds__(128, 3) flash_mma_kernel(const Args a) {
  constexpr int BK = 64, NT = 128, NKK = DH / 16, ND = DH / 8;
  // two stages of K and V tiles: the next tile loads while this one
  // computes
  extern __shared__ __align__(16) unsigned char smem[];
  using Tile = bf16[BK][DH + 8];
  Tile* kst = reinterpret_cast<Tile*>(smem);
  Tile* vst = kst + 2;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / a.G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r_lo = q0 + warp * 16, r_hi = r_lo + 15;  // the warp's rows
  const int ra = r_lo + g, rb = ra + 8;               // this thread's two
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  int lo, hi;
  kv_range<BK>(a, q0, &lo, &hi);
  if (lo < hi) {
    stage<DH, BK, NT>(kst[0], k, a.k_st, lo, a.Skv, tid);
    stage<DH, BK, NT>(vst[0], v, a.v_st, lo, a.Skv, tid);
  }
  cp_async_commit();

  // A fragments of the warp's 16 q rows, over all of dh
  const bf16 zero = __float2bfloat16(0.f);
  auto q_at = [&](int r, int d) { return r < a.Sq ? q[r * a.q_st + d] : zero; };
  uint32_t qf[NKK][4];
#pragma unroll
  for (int kk = 0; kk < NKK; ++kk) {
    const int d = kk * 16 + 2 * t4;
    qf[kk][0] = pack_raw(q_at(ra, d), q_at(ra, d + 1));
    qf[kk][1] = pack_raw(q_at(rb, d), q_at(rb, d + 1));
    qf[kk][2] = pack_raw(q_at(ra, d + 8), q_at(ra, d + 9));
    qf[kk][3] = pack_raw(q_at(rb, d + 8), q_at(rb, d + 9));
  }
  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  const float sl2 = a.scale * kLog2e;

  for (int k0 = lo, t = 0; k0 < hi; k0 += BK, ++t) {
    const int buf = t & 1;
    if (k0 + BK < hi) {  // the next tile, into the other stage
      stage<DH, BK, NT>(kst[buf ^ 1], k, a.k_st, k0 + BK, a.Skv, tid);
      stage<DH, BK, NT>(vst[buf ^ 1], v, a.v_st, k0 + BK, a.Skv, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // unmasked when every (row, column) of the warp's rows x the tile is
    // admitted: inside Skv, and (causal) at or below every row's diagonal
    // and inside every row's window
    const bool inside =
        k0 + BK <= a.Skv &&
        (!a.causal || (k0 + BK - 1 <= r_lo &&
                       (a.window <= 0 || k0 > r_hi - a.window)));
    if (inside)
      mma_tile<DH, BK, false>(a, kst[buf], vst[buf], qf, o, m_a, m_b, l_a,
                              l_b, k0, ra, rb, lane, sl2);
    else
      mma_tile<DH, BK, true>(a, kst[buf], vst[buf], qf, o, m_a, m_b, l_a,
                             l_b, k0, ra, rb, lane, sl2);
    __syncthreads();  // the stage is free for the load after next
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float ia = 1.f / fmaxf(l_a, 1e-30f), ib = 1.f / fmaxf(l_b, 1e-30f);
  bf16* out = static_cast<bf16*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int d = nd * 8 + 2 * t4;
    if (ra < a.Sq) {
      out[ra * a.o_st + d] = __float2bfloat16(o[nd][0] * ia);
      out[ra * a.o_st + d + 1] = __float2bfloat16(o[nd][1] * ia);
    }
    if (rb < a.Sq) {
      out[rb * a.o_st + d] = __float2bfloat16(o[nd][2] * ib);
      out[rb * a.o_st + d + 1] = __float2bfloat16(o[nd][3] * ib);
    }
  }
}

template <int DH>
int launch_mma(const Args& a, dim3 grid, cudaStream_t s) {
  constexpr int bytes = mma_smem_bytes<DH>();
  // above 48 KB a block's shared memory must be asked for, once
  static const cudaError_t set = cudaFuncSetAttribute(
      flash_mma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (set != cudaSuccess) return static_cast<int>(set);
  flash_mma_kernel<DH><<<grid, 128, bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_simt(const Args& a, dim3 grid, cudaStream_t s) {
  flash_simt_kernel<DH><<<grid, 256, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point bound with ctypes.  Pointers are device pointers;
// strides are in elements, with a unit stride on dh.  q: (B, H, Sq, dh);
// k, v: (B, KvE, Skv, dh) with H % KvE == 0; o: (B, H, Sq, dh); all of
// dtype 0 = float32 or 1 = bfloat16, dh in {16, 32, 64, 128}; k/v bases
// 16-byte aligned and their strides multiples of 8 values.  Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() after
// the launch (0 = success).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KvE, int Sq, int Skv, int dh, int dtype, int causal, int window,
    int64_t q_sb, int64_t q_sh, int64_t q_st, int64_t k_sb,
    int64_t k_sh, int64_t k_st, int64_t v_sb, int64_t v_sh, int64_t v_st,
    int64_t o_sb, int64_t o_sh, int64_t o_st, void* stream) {
  if (B <= 0 || H <= 0 || KvE <= 0 || H % KvE || Sq <= 0 || Skv < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,    k,    v,    o,    H,    H / KvE, Sq,
               Skv,  causal, window,
               1.f / sqrtf(static_cast<float>(dh)),
               q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st,
               o_sb, o_sh, o_st};
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (dh) {
      case 16: return launch_mma<16>(a, grid, s);
      case 32: return launch_mma<32>(a, grid, s);
      case 64: return launch_mma<64>(a, grid, s);
      case 128: return launch_mma<128>(a, grid, s);
    }
  } else if (dtype == 0) {
    switch (dh) {
      case 16: return launch_simt<16>(a, grid, s);
      case 32: return launch_simt<32>(a, grid, s);
      case 64: return launch_simt<64>(a, grid, s);
      case 128: return launch_simt<128>(a, grid, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
