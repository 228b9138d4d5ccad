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
// 68 MB of q, k, v and o, 0.02 ms at 3.35 TB/s; mixtral's 4 x 4096-token
// windowed wave is operations-bound too (llama's 512-token bucket, at
// 0.003 ms, is bytes-bound).  So the bf16 path runs on the tensor cores.
//
// Design.  The Pallas grid (B, H, nq, nk), whose sequential kv axis
// carries (m, l, acc) in VMEM scratch, becomes one thread block per (q tile,
// h, b) whose loop walks the kv tiles; tiles wholly above the diagonal or
// wholly before the window are not visited, as the Pallas `run` predicate
// skips them, and the heaviest (last) q tiles are scheduled first.  Any Sq
// and Skv are taken: the ragged edges are masked here.  Only tiles that
// cross a row's diagonal, window edge or Skv are masked.  The scale is
// folded into exp2, and P is rounded to bf16 in registers.  A static
// dispatch by dtype picks one of two bodies:
// - bfloat16 (every main path; `flash_wgmma_kernel`): a block owns 128 q
//   rows as two consumer warpgroups of 64 and a producer warpgroup.  One
//   producer thread keeps TMA loads of 128-row K and V tiles in flight
//   through two shared-memory stages (swizzled in panels of 128-byte rows
//   at dh 64 and 128, of the whole head, 32 or 64 bytes, at dh 16 and 32,
//   and in five panels of 32-byte rows at dh 80, whose 160-byte rows are
//   no multiple of a 64- or 128-byte swizzle; `mbarrier`s for full and
//   empty stages) and `setmaxnreg` hands the
//   producer's registers to the consumers.  S = Q K^T runs as wgmma
//   m64n128k16 from shared memory (Q and K K-major); the online softmax
//   stays in registers; O += P V runs as wgmma with P as the register A
//   operand and V as the transposed (MN-major) shared B operand; each
//   warpgroup runs S, softmax and P V in turn, and the two warpgroups fill
//   each other's gaps on the tensor cores (issuing tile t's S beside tile
//   t - 1's P V inside a warpgroup timed no faster on the card).  The TMA
//   maps are built on the host from the views' strides, so the transposed,
//   uncopied (B, S, H, dh) activations and caches are read as they are; q,
//   k and v need 16-byte aligned bases and strides in multiples of 8 values
//   (the wrapper refuses others).  Rows and keys past Sq and Skv load as
//   zeros.
// - float32 (`flash_simt_kernel`): no tensor-core path keeps float32
//   exact, so 256 threads, four per q row, each holding a quarter of the
//   row's q and acc, sum the scores on the CUDA cores from K/V tiles of 32
//   rows in shared memory.
// q, k, v and o are addressed through their (b, head, position) strides
// with a unit stride on dh.  A launch or a tensor-map failure returns its
// error; no body stands in for another.
#include <cuda.h>
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
template <int BK, int BQ = kBQ>
__device__ __forceinline__ void kv_range(const Args& a, int q0, int* lo,
                                         int* hi) {
  int l = 0, h = a.Skv;
  if (a.causal) {
    h = min(a.Skv, min(q0 + BQ, a.Sq));
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

// ------------------------------------------------- bfloat16 path: wgmma
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 two = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&two);
}

constexpr int kWgBQ = 128;      // q rows per block: two warpgroups of 64
constexpr int kWgBK = 128;      // K/V rows per tile
constexpr int kWgStages = 2;    // K/V tiles in flight
constexpr int kWgThreads = 384; // warpgroups 0, 1 consume; 2 produces

// Bytes of a swizzled shared-memory row of one panel: 64 values (128-byte
// swizzle) at dh 64 and 128, the whole head at dh 16 and 32 (32- and
// 64-byte swizzle), 16 values (32-byte swizzle) at dh 80: five panels, each
// one k-step of Q K^T and 16 columns of P V, so one descriptor layout (and
// the same strides as dh 128's two panels) serves every panel.
__host__ __device__ constexpr int panel_bytes(int dh) {
  return dh % 64 == 0 ? 128 : dh == 32 ? 64 : 32;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-d tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// A wgmma shared-memory descriptor of an operand at `addr` swizzled in
// rows of PB bytes (128, 64 or 32: layout types 1, 2, 3): `lbo` and `sbo`
// in bytes (the leading and stride byte offsets).
template <int PB>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  constexpr uint64_t kind = PB == 128 ? 1 : PB == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (kind << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// Registers a wgmma reads or writes asynchronously stay where they are
// until its wait: the compiler may neither move nor reuse them before.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}


// d (64 x 128, f32) = A . B, A and B from shared memory, both K-major;
// scale_d 0 ignores d's old value
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128, f32) += A . B, A (bf16) from registers, B from shared
// memory MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d (64 x 80, f32) += A . B, as wgmma_rs_n128 (dh 80: B is five panels of
// 16 columns, LBO apart)
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39},"
      " {%40, %41, %42, %43}, %44, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d (64 x 64, f32) += A . B, A (bf16) from registers, B from shared
// memory MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d (64 x 32, f32) += A . B, as wgmma_rs_n64
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d (64 x 16, f32) += A . B, as wgmma_rs_n64
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, 1, 1, 1, "
      "1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile(
      "wgmma.commit_group.sync.aligned;\n"
      "wgmma.wait_group.sync.aligned 0;\n" ::
          : "memory");
}

// One K/V tile (kWgBK rows) against the warpgroup's 64 q rows (ra = row g,
// rb = row g + 8 of the thread's warp): S = Q K^T on wgmma from shared
// memory, the online softmax in registers, O += P V on wgmma with P from
// registers and V read transposed.  m_a/m_b are the running maxima of the
// raw scores (the scale is folded into exp2); l_a/l_b this thread's partial
// sums over its columns.  MASK applies the causal, window and ragged-edge
// masks; tiles wholly inside them skip it.
//
// Shared-memory operands are swizzled panels of PB-byte rows (PB / 2
// values: panel_bytes), as TMA writes them: Q and K are K-major (a wgmma
// k-step of 16 values is 32 bytes into the row, panel kk / (PB / 32)),
// 8-row groups 8 PB bytes apart; V is MN-major (a k-step of 16 K/V rows
// is 16 PB bytes on, the next PB / 2 dh values the next panel, kWgBK rows
// on).
template <int DH, bool MASK>
__device__ __forceinline__ void wg_tile(const Args& a, uint32_t qs,
                                        uint32_t ks, uint32_t vs,
                                        float (&o)[DH / 2], float& m_a,
                                        float& m_b, float& l_a, float& l_b,
                                        int k0, int ra, int rb, int lane,
                                        float sl2) {
  constexpr int NJ = kWgBK / 8;
  constexpr int PB = panel_bytes(DH), SPP = PB / 32;  // k-steps a panel
  const int t4 = lane & 3;
  float s[kWgBK / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t at = (kk % SPP) * 32;
    wgmma_ss_n128(
        s, desc<PB>(qs + (kk / SPP) * kWgBQ * PB + at, 16, 8 * PB),
        desc<PB>(ks + (kk / SPP) * kWgBK * PB + at, 16, 8 * PB), kk > 0);
  }
  wgmma_commit_wait();
  keep(s);
  if (MASK) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + 8 * j + 2 * t4 + e;
        if (!attends(a, ra, col)) s[4 * j + e] = kNegInf;
        if (!attends(a, rb, col)) s[4 * j + 2 + e] = kNegInf;
      }
    }
  }
  float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
    mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
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
      float& pa = s[4 * j + e];
      float& pb = s[4 * j + 2 + e];
      pa = (!MASK || pa > kNegInf) ? exp2f(fmaf(pa, sl2, -off_a)) : 0.f;
      pb = (!MASK || pb > kNegInf) ? exp2f(fmaf(pb, sl2, -off_b)) : 0.f;
      ls_a += pa;
      ls_b += pb;
    }
  }
  l_a = al_a * l_a + ls_a;
  l_b = al_b * l_b + ls_b;
  m_a = mn_a;
  m_b = mn_b;
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd) {
    o[4 * nd] *= al_a;
    o[4 * nd + 1] *= al_a;
    o[4 * nd + 2] *= al_b;
    o[4 * nd + 3] *= al_b;
  }
  // P as bf16 A fragments: k-step kk covers the columns of n8 blocks 2 kk
  // and 2 kk + 1, laid out as mma.sync's m16n8k16 A fragment per warp
  uint32_t p[kWgBK / 16][4];
#pragma unroll
  for (int kk = 0; kk < kWgBK / 16; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kWgBK / 16; ++kk) {
    const uint64_t dv = desc<PB>(vs + kk * 16 * PB, kWgBK * PB, 8 * PB);
    if constexpr (DH == 128)
      wgmma_rs_n128(o, p[kk], dv);
    else if constexpr (DH == 80)
      wgmma_rs_n80(o, p[kk], dv);
    else if constexpr (DH == 64)
      wgmma_rs_n64(o, p[kk], dv);
    else if constexpr (DH == 32)
      wgmma_rs_n32(o, p[kk], dv);
    else
      wgmma_rs_n16(o, p[kk], dv);
  }
  wgmma_commit_wait();
  keep(o);
  keep(p);
}

template <int DH>
constexpr int wg_smem_bytes() {
  // Q, then kWgStages K tiles, then kWgStages V tiles; 1024 bytes of slack
  // to align the base to the swizzle's 1024-byte period
  return (kWgBQ + 2 * kWgStages * kWgBK) * DH * 2 + 1024;
}

// One block per (128-row q tile, h, b), heaviest tiles first.  Warpgroup 2
// is the producer: one thread keeps TMA loads of the block's K/V tiles in
// flight through kWgStages stages (`full` barriers count the bytes in,
// `empty` barriers the 8 consumer warps done with a stage) and gives most
// of its registers to warpgroups 0 and 1, which own 64 q rows each.
template <int DH>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, const Args a) {
  constexpr int PB = panel_bytes(DH), PV = PB / 2;
  constexpr int NP = DH / PV;  // panels of a row
  constexpr int Q_BYTES = kWgBQ * DH * 2, TILE = kWgBK * DH * 2;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kWgStages];
  const uint32_t q_full = smem_u32(bars);
  const uint32_t full = q_full + 8, empty = full + 8 * kWgStages;
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t k_s = q_s + Q_BYTES, v_s = k_s + kWgStages * TILE;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kWgBQ;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / a.G;
  const int tid = threadIdx.x;
  int lo, hi;
  kv_range<kWgBK, kWgBQ>(a, q0, &lo, &hi);
  const int n_tiles = lo < hi ? (hi - lo + kWgBK - 1) / kWgBK : 0;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kWgStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {  // the producer: its paths never rejoin the consumers'
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 256) {
      mbar_expect_tx(q_full, Q_BYTES);
      for (int pn = 0; pn < NP; ++pn)
        tma_load(q_s + pn * kWgBQ * PB, &qmap, PV * pn, q0, h, b, q_full);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kWgStages, k0 = lo + t * kWgBK;
        mbar_wait(empty + 8 * st, ((t / kWgStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, 2 * TILE);
        for (int pn = 0; pn < NP; ++pn) {
          tma_load(k_s + st * TILE + pn * kWgBK * PB, &kmap, PV * pn, k0,
                   kvh, b, full + 8 * st);
          tma_load(v_s + st * TILE + pn * kWgBK * PB, &vmap, PV * pn, k0,
                   kvh, b, full + 8 * st);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int w_lo = q0 + 64 * wg, w_hi = w_lo + 63;  // the warpgroup's rows
    const int ra = w_lo + 16 * warp + g, rb = ra + 8;  // this thread's two
    const uint32_t qs = q_s + wg * 64 * PB;            // its 64 rows of Q
    float o[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
    float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
    const float sl2 = a.scale * kLog2e;
    mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kWgStages, k0 = lo + t * kWgBK;
      mbar_wait(full + 8 * st, (t / kWgStages) & 1);
      // no (row, column) of the warpgroup's rows x the tile is admitted
      const bool dead =
          a.causal && (k0 > w_hi || (a.window > 0 &&
                                     k0 + kWgBK - 1 <= w_lo - a.window));
      // every one is: inside Skv, at or below every row's diagonal and
      // inside every row's window
      const bool inside =
          k0 + kWgBK <= a.Skv &&
          (!a.causal || (k0 + kWgBK - 1 <= w_lo &&
                         (a.window <= 0 || k0 > w_hi - a.window)));
      const uint32_t ks = k_s + st * TILE, vs = v_s + st * TILE;
      if (!dead && inside)
        wg_tile<DH, false>(a, qs, ks, vs, o, m_a, m_b, l_a, l_b, k0, ra, rb,
                           lane, sl2);
      else if (!dead)
        wg_tile<DH, true>(a, qs, ks, vs, o, m_a, m_b, l_a, l_b, k0, ra, rb,
                          lane, sl2);
      if (lane == 0) mbar_arrive(empty + 8 * st);  // the stage is free
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    const float ia = 1.f / fmaxf(l_a, 1e-30f), ib = 1.f / fmaxf(l_b, 1e-30f);
    bf16* out = static_cast<bf16*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      const int d = nd * 8 + 2 * t4;
      if (ra < a.Sq)
        *reinterpret_cast<__nv_bfloat162*>(out + ra * a.o_st + d) =
            __floats2bfloat162_rn(o[4 * nd] * ia, o[4 * nd + 1] * ia);
      if (rb < a.Sq)
        *reinterpret_cast<__nv_bfloat162*>(out + rb * a.o_st + d) =
            __floats2bfloat162_rn(o[4 * nd + 2] * ib, o[4 * nd + 3] * ib);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, fetched through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A TMA map of a (n_b, n_h, S, DH) bf16 tensor addressed through its
// element strides (a unit one on DH), read in boxes of one panel's values
// (panel_bytes / 2) by `rows` positions, swizzled in rows of panel_bytes;
// positions past S read as zeros.
bool tensor_map(CUtensorMap* map, const void* base, int DH, int S, int n_h,
                int n_b, int64_t st, int64_t sh, int64_t sb, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  // a size-1 axis is never stepped along: any valid stride will do
  auto bytes = [](int64_t s, int n) {
    return static_cast<cuuint64_t>(n == 1 ? 16 : s * 2);
  };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(DH),
                              static_cast<cuuint64_t>(S > 1 ? S : 1),
                              static_cast<cuuint64_t>(n_h),
                              static_cast<cuuint64_t>(n_b)};
  const cuuint64_t strides[3] = {bytes(st, S), bytes(sh, n_h),
                                 bytes(sb, n_b)};
  const int pv = panel_bytes(DH) / 2;
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(pv),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = pv == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : pv == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
int launch_wgmma(const Args& a, int B, int KvE, cudaStream_t s) {
  CUtensorMap qm, km, vm;
  if (!tensor_map(&qm, a.q, DH, a.Sq, a.H, B, a.q_st, a.q_sh, a.q_sb,
                  kWgBQ) ||
      !tensor_map(&km, a.k, DH, a.Skv, KvE, B, a.k_st, a.k_sh, a.k_sb,
                  kWgBK) ||
      !tensor_map(&vm, a.v, DH, a.Skv, KvE, B, a.v_st, a.v_sh, a.v_sb,
                  kWgBK))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = wg_smem_bytes<DH>();
  static const cudaError_t set = cudaFuncSetAttribute(
      flash_wgmma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((a.Sq + kWgBQ - 1) / kWgBQ, a.H, B);
  flash_wgmma_kernel<DH><<<grid, kWgThreads, bytes, s>>>(qm, km, vm, a);
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
// dtype 0 = float32 or 1 = bfloat16, dh in {16, 32, 64, 80, 128}; q/k/v bases
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
      case 16: return launch_wgmma<16>(a, B, KvE, s);
      case 32: return launch_wgmma<32>(a, B, KvE, s);
      case 64: return launch_wgmma<64>(a, B, KvE, s);
      case 80: return launch_wgmma<80>(a, B, KvE, s);
      case 128: return launch_wgmma<128>(a, B, KvE, s);
    }
  } else if (dtype == 0) {
    switch (dh) {
      case 16: return launch_simt<16>(a, grid, s);
      case 32: return launch_simt<32>(a, grid, s);
      case 64: return launch_simt<64>(a, grid, s);
      case 80: return launch_simt<80>(a, grid, s);
      case 128: return launch_simt<128>(a, grid, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
