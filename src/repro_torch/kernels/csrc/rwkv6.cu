// WKV6 recurrence for Hopper (sm_90a): the time-mix hot spot of RWKV-6.
//
// Replaces the Pallas TPU kernel `rwkv6_chunked` of the JAX package's
// src/repro/kernels/rwkv6_kernel.py.  For every (b, h), with the state
// S[i, j] indexed [key channel i, value channel j], in float32:
//   y_t = r_t . S + (sum_i r_t[i] u[i] k_t[i]) v_t
//   S  <- diag(w_t) S + k_t^T v_t
// over t = 0 .. S_len - 1, from the given starting state; y and the final
// state are written in float32.  Two bodies compute it, picked by S_len.
//
// Bound (H100 SXM, 3.35 TB/s, 495 TFLOP/s TF32 on the tensor cores, 67
// TFLOP/s f32 on the CUDA cores).  Decode (one step): memory — each (dh, dh)
// float32 state is read and written once, 2 * 4 * dh^2 bytes per (b, h),
// against ~5 dh^2 flops.  Prefill (S_len steps): memory as well once the
// products are on the tensor cores — r/k/v/w read and y written once are
// ~14 dh bytes per (b, h, t) at bf16 r/k/v, while the chunked form's three
// products are ~4 dh^2 + 2 C dh flops per (b, h, t), which three TF32 passes
// run at a third of 495 TFLOP/s (at the rwkv6 path's B 8, H 64, S 1024,
// dh 64: ~0.145 ms of bytes against ~0.06 ms of products).  What holds the
// chunked body back on the card is instruction issue: ~1,700 instructions
// a warp and chunk, four warps a sub-partition (one block of each of the
// four an SM holds), so its ~0.375 ms there (NVIDIA H100 80GB HBM3,
// 700.00 W; PERF.md) is ~2.6x the bytes bound.
//
// rwkv6_step_kernel (S_len < kChunk: decode).  The TPU kernel's sequential
// chunk grid axis and its VMEM state scratch become one thread block per
// (b, h) whose loop walks the sequence: dh threads, thread j keeping column
// S[:, j] in registers.  Per step, thread j computes y_j = sum_i r_i S_ij +
// bonus v_j, then S_ij <- w_i S_ij + k_i v_j, reading the step's r, k, w rows
// from shared memory.  Each step is a chain of dh dependent FMAs, which is
// why a long sequence does not run here.
//
// rwkv6_chunk_kernel (S_len >= kChunk: prefill) runs the chunked,
// parallel-in-time form.  For each chunk of C = kChunk steps, from the
// carried state S0, with l_t = max(log2 w_t, kLog2Floor) per channel and
// L_t = l_0 + ... + l_t (L_-1 = 0):
//   y_t  = (r_t * 2^L_{t-1}) . S0                             (inter-chunk)
//        + sum_{s<t} A_ts v_s                                  (intra-chunk)
//        + (sum_i r_t[i] u[i] k_t[i]) v_t                      (bonus)
//   A_ts = sum_i r_t[i] k_s[i] 2^(L_{t-1}[i] - L_s[i])
//   S_C  = diag(2^L_{C-1}) S0 + (k_s * 2^(L_{C-1} - L_s))^T V.
// Every exponent is <= 0 (w <= 1), so nothing overflows, and each decay
// between two steps is formed over the steps between them, never as a
// quotient 2^L_t / 2^L_s: on the rwkv6 path a chunk's L falls below -128
// (log2) and w is sometimes exactly 0, so the factored form overflows or
// meets -inf - -inf.  L_{t-1} is a prefix sum and L_{C-1} - L_s a suffix
// sum of the l, both compensated (TwoSum: hi + lo, float32 accuracy
// relative to the sum itself); A's decay 2^(L_{t-1} - L_s) is the running
// product of the step decays 2^l_tau, s < tau < t.  The floor makes w = 0
// finite: kLog2Floor = -40 replaces a decay below 2^-40 (9.1e-13) by
// 2^-40, which changes y by at most 2^-40 times |r| |S| (1e-10 at |S| ~
// 100), far inside the 1e-4 the kernel is held to; without it a w of 0
// gives log2 w = -inf and the suffix sums -inf - -inf = NaN.
//
// Design: one block of dh / 16 warps per (b, h) walks the chunks, four
// barriers a chunk.
// - r, k, v, w chunks go to shared memory through cp.async (16-byte pieces
//   of the transposed (B, S, H, dh) views), one chunk ahead of use into two
//   buffers; a ragged last chunk is padded with r = k = v = 0, l = 0.
// - Channel pass: two lanes a channel share its log2 w and form the sums
//   above (one the prefix, writing r * 2^L_{t-1}, the other the suffix,
//   writing k * 2^(L_{C-1} - L_s) and the state's decay 2^L_{C-1}).
// - A on the CUDA cores: a thread a (key step pair, 4 channels) sums its
//   part of 17 entries (key steps sp and C - 1 - sp) into shared memory,
//   and a short pass adds the dh / 4 parts of each entry.
// - The state lives in registers, spread over the block: warp w holds
//   value channels 16w .. 16w + 15 of S^T as mma.sync accumulator tiles.  The
//   inter-chunk product (C x dh)(dh x dh) reads them as its B operand
//   directly (the k index permuted so the accumulator layout is the operand
//   layout), interleaved with the A sums so that the tensor and CUDA cores
//   work at once; the intra-chunk product adds A V, and the state update
//   S^T <- S^T diag(decay) + V^T K~ accumulates into them.  All three run
//   on the tensor cores as mma.sync m16n8k8 TF32 with each operand split in
//   two (x = hi + lo, both TF32) and three passes, lo*hi + hi*lo + hi*hi,
//   which keeps float32 accuracy (one TF32 pass keeps ~3 digits and fails
//   the 1e-4); a bf16 v is exact in TF32, so products with V need two.
// Unlike the Pallas kernel, any S_len >= 1 is taken.  r, k, v, w and y are
// addressed through their (b, h, t) strides with a unit channel stride, so
// the model passes transposed views of its (B, S, H, dh) activations and
// nothing is copied; the chunked body needs 16-byte aligned bases and
// strides for r, k, v and w (the wrapper checks).  Each block owns its
// state and reads it whole before writing, so the final state may be
// written over the starting one.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kChunk = 16;           // C: steps per chunk (both bodies)
constexpr float kLog2Floor = -40.f;  // the floor of log2 w (see the header)
constexpr float kFloorW = 0x1p-40f;  // 2^kLog2Floor

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const void* u;
  const float* s0;
  float* y;
  float* sT;
  int H, S_len;
  int64_t r_sb, r_sh, r_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st;
  int64_t w_sb, w_sh, w_st, y_sb, y_sh, y_st, u_sh;
  int64_t s0_sb, s0_sh, sT_sb, sT_sh;
};

// ----------------------------------------------------- the per-step body
template <typename T, typename U, int DH>
__global__ void __launch_bounds__(DH) rwkv6_step_kernel(const Args a) {
  __shared__ __align__(16) float r_s[2][kChunk][DH];
  __shared__ __align__(16) float k_s[2][kChunk][DH];
  __shared__ __align__(16) float w_s[2][kChunk][DH];
  __shared__ __align__(16) float v_s[2][kChunk][DH];
  __shared__ __align__(16) float ruk_s[2][kChunk][DH];  // r_t[j] u[j] k_t[j]

  const int b = blockIdx.x / a.H;
  const int h = blockIdx.x % a.H;
  const int j = threadIdx.x;
  const T* r = static_cast<const T*>(a.r) + b * a.r_sb + h * a.r_sh + j;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh + j;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh + j;
  const float* w = a.w + b * a.w_sb + h * a.w_sh + j;
  float* y = a.y + b * a.y_sb + h * a.y_sh + j;
  const float u_j = to_f32(static_cast<const U*>(a.u)[h * a.u_sh + j]);

  float S[DH];                             // column j of the state
  const float* s0 = a.s0 + b * a.s0_sb + h * a.s0_sh + j;
#pragma unroll
  for (int i = 0; i < DH; ++i) S[i] = s0[i * DH];

  // the next chunk's channel-j values, held in registers while the
  // current chunk computes
  float pr[kChunk], pk[kChunk], pv[kChunk], pw[kChunk];
  auto load = [&](int t0) {
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int t = t0 + c;
      const bool in = t < a.S_len;
      pr[c] = in ? to_f32(r[t * a.r_st]) : 0.f;
      pk[c] = in ? to_f32(k[t * a.k_st]) : 0.f;
      pv[c] = in ? to_f32(v[t * a.v_st]) : 0.f;
      pw[c] = in ? w[t * a.w_st] : 0.f;
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      r_s[buf][c][j] = pr[c];
      k_s[buf][c][j] = pk[c];
      v_s[buf][c][j] = pv[c];
      w_s[buf][c][j] = pw[c];
      ruk_s[buf][c][j] = pr[c] * u_j * pk[c];
    }
  };

  const int n_chunks = (a.S_len + kChunk - 1) / kChunk;
  load(0);
  stage(0);
  __syncthreads();
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int buf = ch & 1;
    const int t0 = ch * kChunk;
    const bool more = ch + 1 < n_chunks;
    if (more) load(t0 + kChunk);
    const int n = min(kChunk, a.S_len - t0);
    for (int c = 0; c < n; ++c) {
      const float* rr = r_s[buf][c];
      const float* kk = k_s[buf][c];
      const float* ww = w_s[buf][c];
      const float* ruk = ruk_s[buf][c];
      float acc = 0.f, bonus = 0.f;
#pragma unroll
      for (int i = 0; i < DH; ++i) {
        acc = fmaf(rr[i], S[i], acc);
        bonus += ruk[i];
      }
      const float v_j = v_s[buf][c][j];
      y[(t0 + c) * a.y_st] = fmaf(bonus, v_j, acc);
#pragma unroll
      for (int i = 0; i < DH; ++i) S[i] = fmaf(ww[i], S[i], kk[i] * v_j);
    }
    if (more) stage(buf ^ 1);
    __syncthreads();
  }

  float* sT = a.sT + b * a.sT_sb + h * a.sT_sh + j;
#pragma unroll
  for (int i = 0; i < DH; ++i) sT[i * DH] = S[i];
}

// ------------------------------------------------------ the chunked body
// 16 (`full`) or 0 bytes, then zeros, global -> shared without registers
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 2^x for x <= 0 (MUFU; a result below 2^-126 flushes to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// (hi, lo) += l with the rounding error of hi + l kept in lo (TwoSum)
__device__ __forceinline__ void two_sum_add(float& hi, float& lo, float l) {
  const float s = hi + l, bb = s - hi;
  lo += (hi - (s - bb)) + (l - bb);
  hi = s;
}

// x = hi + lo: hi is x truncated to TF32 (its low 13 bits cleared), lo =
// x - hi (exact in f32, below 2^-10 |x|); the tensor cores read a TF32
// operand's top 19 bits, so lo enters truncated and the pair is within
// 2^-20 |x| of x.  Two instructions (cvt.rna.tf32 takes four).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An mma.sync operand split for the three-pass product.  `exact` stores a
// value that is exact in TF32 (a bf16 v) as it is: its lo is zero, unset
template <int N>
struct Frag {
  uint32_t hi[N], lo[N];
  template <bool exact = false>
  __device__ __forceinline__ void set(int e, float x) {
    if (exact)
      hi[e] = __float_as_uint(x);
    else
      split_tf32(x, hi[e], lo[e]);
  }
};

// d += a b in float32 accuracy: lo*hi + hi*lo + hi*hi, the small terms
// first; a pass with an exact operand's lo (zero) is skipped
template <bool exact_a, bool exact_b>
__device__ __forceinline__ void mma3(float (&d)[4], const Frag<4>& a,
                                     const Frag<2>& b) {
  if (!exact_a) mma_tf32(d, a.lo, b.hi);
  if (!exact_b) mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

template <typename T, int DH>
struct ChunkShared {
  // staged inputs, two buffers; r/k/v rows padded by 32 bytes, w rows by
  // 16, so the v fragment loads (8 columns x 4 rows) hit distinct banks
  T r[2][kChunk][DH + 32 / sizeof(T)];
  T k[2][kChunk][DH + 32 / sizeof(T)];
  T v[2][kChunk][DH + 32 / sizeof(T)];
  float w[2][kChunk][DH + 4];
  // the chunk, float32: rows read by the A sums padded by 4 floats,
  // rows of mma operands by 8 (fragment loads of 8 rows x 4 columns hit
  // 32 banks)
  float rf[kChunk][DH + 4];      // r_t
  float kf[kChunk][DH + 4];      // k_t
  float dw[kChunk][DH + 4];      // 2^l_t = max(w_t, 2^-40), the step decay
  float rd[kChunk][DH + 8];      // r_t * 2^L_{t-1}
  float kd[kChunk][DH + 8];      // k_s * 2^(L_{C-1} - L_s)
  // A's entries (t, s), s <= t, at t (t + 1) / 2 + s: each lane's part
  // of the sum over its 4 channels, then the sums
  float part[kChunk * (kChunk + 1) / 2][DH / 4];
  float a[kChunk][kChunk + 4];   // A: strictly lower, bonus on the diagonal
  float decay[DH];               // 2^L_{C-1}
  float u[DH];
  short a_off[kChunk * (kChunk + 1) / 2];  // entry e's offset (t, s) in a
};

template <typename T, typename U, int DH>
__global__ void __launch_bounds__(2 * DH, 4) rwkv6_chunk_kernel(const Args a) {
  using Sh = ChunkShared<T, DH>;
  constexpr int NT = 2 * DH;   // threads: dh / 16 warps
  constexpr int NB = DH / 8;   // 8-wide tiles across dh
  constexpr int VT = 16 / sizeof(T);
  constexpr bool kExactV = !std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  Sh& sh = *reinterpret_cast<Sh*>(smem);

  const int b = blockIdx.x / a.H;
  const int h = blockIdx.x % a.H;
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;  // the mma fragments' row, column
  const int j0 = 16 * (tid >> 5);         // this warp's value channels
  const T* r = static_cast<const T*>(a.r) + b * a.r_sb + h * a.r_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* w = a.w + b * a.w_sb + h * a.w_sh;
  float* y = a.y + b * a.y_sb + h * a.y_sh;

  for (int e = tid; e < kChunk * (kChunk + 4); e += NT)
    (&sh.a[0][0])[e] = 0.f;  // the upper triangle stays zero
  if (tid < DH)
    sh.u[tid] = to_f32(static_cast<const U*>(a.u)[h * a.u_sh + tid]);

  // S^T as accumulator tiles: st[n] holds S[i][j] for j = j0 + g (+ 8 in
  // [2], [3]) and i = 8n + 2q (+ 1 in [1], [3])
  float st[NB][4];
  {
    const float* s0 = a.s0 + b * a.s0_sb + h * a.s0_sh + j0 + g;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const float* p = s0 + (8 * n + 2 * q) * DH;
      st[n][0] = p[0];
      st[n][1] = p[DH];
      st[n][2] = p[8];
      st[n][3] = p[DH + 8];
    }
  }

  // a chunk's 16-byte pieces: PT a row of r, k and v, PW of w; each thread
  // takes pieces tid, tid + NT, ... (trip counts known at compile time)
  auto stage = [&](int ch, int buf) {
    const int t0 = ch * kChunk;
    constexpr int PT = DH / VT, PW = DH / 4;
#pragma unroll
    for (int x = 0; x < (kChunk * PT + NT - 1) / NT; ++x) {
      const int e = tid + x * NT;
      if (kChunk * PT % NT && e >= kChunk * PT) break;
      const int c = e / PT, d = (e % PT) * VT;
      const bool in = t0 + c < a.S_len;
      const int64_t t = in ? t0 + c : 0;
      cp_async16(&sh.r[buf][c][d], r + t * a.r_st + d, in);
      cp_async16(&sh.k[buf][c][d], k + t * a.k_st + d, in);
      cp_async16(&sh.v[buf][c][d], v + t * a.v_st + d, in);
    }
#pragma unroll
    for (int x = 0; x < (kChunk * PW + NT - 1) / NT; ++x) {
      const int e = tid + x * NT;
      if (kChunk * PW % NT && e >= kChunk * PW) break;
      const int c = e / PW, d = (e % PW) * 4;
      const bool in = t0 + c < a.S_len;
      const int64_t t = in ? t0 + c : 0;
      cp_async16(&sh.w[buf][c][d], w + t * a.w_st + d, in);
    }
  };

  // the entries of A, e = t (t + 1) / 2 + s for s <= t, as offsets in a
  constexpr int kEntries = kChunk * (kChunk + 1) / 2;
  for (int t = 0; t < kChunk; ++t)
    if (tid <= t) sh.a_off[t * (t + 1) / 2 + tid] = t * (kChunk + 4) + tid;

  const int n_chunks = (a.S_len + kChunk - 1) / kChunk;
  stage(0, 0);
  cp_async_commit();
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int buf = ch & 1, t0 = ch * kChunk;
    const int n = min(kChunk, a.S_len - t0);
    cp_async_wait_all();
    __syncthreads();  // chunk ch staged; the last chunk's reads are done
    if (ch + 1 < n_chunks) {  // into the buffer the last chunk read
      stage(ch + 1, buf ^ 1);
      cp_async_commit();
    }

    // per channel i, two lanes (roles 0 and 1): each takes log2 w of
    // every other step and they swap them, and each writes the step decays
    // 2^l_t = max(w_t, 2^-40) of its steps.  Role 0 walks the chunk forward
    // with the prefix sum L_{c-1} of the steps before c and writes r and
    // r * 2^L_{c-1}; role 1 walks it backward with the suffix sum
    // L_{C-1} - L_c of the steps after c and writes k, k * 2^(L_{C-1} - L_c)
    // and the state's decay 2^L_{C-1}.  Both sums are compensated (TwoSum:
    // hi + lo) and are formed before the step's own l is added.
    {
      const int i = tid >> 1, role = tid & 1;
      float l[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; c += 2) {
        const int cm = c + role;
        const float wv = sh.w[buf][cm][i];
        float lm = cm < n ? __log2f(wv) : 0.f;
        lm = lm < kLog2Floor ? kLog2Floor : lm;  // (a NaN stays NaN)
        sh.dw[cm][i] = cm < n ? (wv < kFloorW ? kFloorW : wv) : 1.f;
        const float other = __shfl_xor_sync(0xffffffffu, lm, 1);
        l[c] = role ? other : lm;
        l[c + 1] = role ? lm : other;
      }
      const T* xs = role ? &sh.k[buf][kChunk - 1][i] : &sh.r[buf][0][i];
      float* xf = role ? &sh.kf[kChunk - 1][i] : &sh.rf[0][i];
      float* xd = role ? &sh.kd[kChunk - 1][i] : &sh.rd[0][i];
      // rows forward or backward; formed anew each chunk (an empty asm the
      // compiler cannot see through), or it keeps the lane's 32 row
      // addresses in registers for the whole sequence
      int dir = role ? -1 : 1;
      asm volatile("" : "+r"(dir));
      float hi = 0.f, lo = 0.f;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float xv = to_f32(xs[dir * c * (DH + 32 / sizeof(T))]);
        xf[dir * c * (DH + 4)] = xv;
        xd[dir * c * (DH + 8)] = xv * ex2(hi + lo);
        two_sum_add(hi, lo, role ? l[kChunk - 1 - c] : l[c]);
      }
      if (role) sh.decay[i] = ex2(hi + lo);
    }
    __syncthreads();  // the chunk's f32 rows are written

    // A's parts on the CUDA cores, interleaved with the inter-chunk product
    // on the tensor cores (one k step of it every other entry), so that
    // both units work at once.
    // A: thread (sp, cg) owns channels 4cg .. 4cg + 3 of key steps s = sp
    // and s = C - 1 - sp (17 entries of A either way): the bonus r_s u k_s
    // at (s, s), then t = s + 1 .. C - 1 with ke = k_s * 2^(L_{t-1} - L_s),
    // the pairwise decay formed as the running product of the step decays
    // 2^l between s and t (never a quotient: no overflow, and a w of 0
    // gives 2^-40).  Each writes its part; a second pass adds the dh / 4
    // parts of each entry.
    // Inter-chunk: y = (r * 2^L_{t-1}) S0, the k index i permuted so that
    // the state's accumulator tiles are the B operand: k-slot q <-> i =
    // 8kk + 2q, k-slot q + 4 <-> i = 8kk + 2q + 1.
    float acc[2][4] = {};
    auto inter = [&](int kk) {
      Frag<4> fa;
      const float2 r0 =
          *reinterpret_cast<const float2*>(&sh.rd[g][8 * kk + 2 * q]);
      const float2 r1 =
          *reinterpret_cast<const float2*>(&sh.rd[g + 8][8 * kk + 2 * q]);
      fa.set(0, r0.x);
      fa.set(1, r1.x);
      fa.set(2, r0.y);
      fa.set(3, r1.y);
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        Frag<2> fb;
        fb.set(0, st[kk][2 * nn]);
        fb.set(1, st[kk][2 * nn + 1]);
        mma3<false, false>(acc[nn], fa, fb);
      }
    };
    {
      constexpr int G = DH / 4;
      const int cg = tid % G, sp = tid / G;
      const float4 uu = *reinterpret_cast<const float4*>(&sh.u[4 * cg]);
#pragma unroll
      for (int x = 0; x < 2; ++x) {  // the bonus entries (s, s)
        const int s = x ? kChunk - 1 - sp : sp;
        const float4 rs = *reinterpret_cast<const float4*>(&sh.rf[s][4 * cg]);
        const float4 ks = *reinterpret_cast<const float4*>(&sh.kf[s][4 * cg]);
        float part = rs.x * uu.x * ks.x;
        part = fmaf(rs.y * uu.y, ks.y, part);
        part = fmaf(rs.z * uu.z, ks.z, part);
        part = fmaf(rs.w * uu.w, ks.w, part);
        sh.part[s * (s + 3) / 2][cg] = part;
      }
      // the pairs s < t, C - 1 a thread: key step sp, t = sp + 1 .. C - 1,
      // then key step C - 1 - sp, t = C - sp .. C - 1; entry e(t, s) =
      // t (t + 1) / 2 + s, and e(t + 1, s) = e(t, s) + t + 1
      int t = sp + 1, e = t * (t + 1) / 2 + sp;
      float4 ke = *reinterpret_cast<const float4*>(&sh.kf[sp][4 * cg]);
#pragma unroll
      for (int m = 0; m < kChunk - 1; ++m) {
        if (m == kChunk - 1 - sp) {  // the second key step
          t = kChunk - sp;
          e = t * (t + 1) / 2 + t - 1;
          ke = *reinterpret_cast<const float4*>(&sh.kf[t - 1][4 * cg]);
        }
        const float4 x = *reinterpret_cast<const float4*>(&sh.rf[t][4 * cg]);
        float part = x.x * ke.x;
        part = fmaf(x.y, ke.y, part);
        part = fmaf(x.z, ke.z, part);
        part = fmaf(x.w, ke.w, part);
        sh.part[e][cg] = part;
        const float4 d = *reinterpret_cast<const float4*>(&sh.dw[t][4 * cg]);
        ke.x *= d.x;
        ke.y *= d.y;
        ke.z *= d.z;
        ke.w *= d.w;
        e += ++t;
        if (!(m & 1) && m / 2 < NB) inter(m / 2);
      }
    }
    __syncthreads();  // the parts of A are written
#pragma unroll
    for (int x = 0; x < (kEntries + NT - 1) / NT; ++x) {
      const int e = tid + x * NT;
      if (kEntries % NT && e >= kEntries) break;
      const float4* pe = reinterpret_cast<const float4*>(sh.part[e]);
      float4 acc4 = pe[0];
#pragma unroll
      for (int m = 1; m < DH / 16; ++m) {
        const float4 pm = pe[m];
        acc4.x += pm.x;
        acc4.y += pm.y;
        acc4.z += pm.z;
        acc4.w += pm.w;
      }
      (&sh.a[0][0])[sh.a_off[e]] = (acc4.x + acc4.y) + (acc4.z + acc4.w);
    }
    __syncthreads();  // A is written

    // intra-chunk and bonus: y += A V, V read from the staged chunk
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      Frag<4> fa;
      fa.set(0, sh.a[g][8 * kk + q]);
      fa.set(1, sh.a[g + 8][8 * kk + q]);
      fa.set(2, sh.a[g][8 * kk + q + 4]);
      fa.set(3, sh.a[g + 8][8 * kk + q + 4]);
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        Frag<2> fb;
        fb.template set<kExactV>(
            0, to_f32(sh.v[buf][8 * kk + q][j0 + 8 * nn + g]));
        fb.template set<kExactV>(
            1, to_f32(sh.v[buf][8 * kk + q + 4][j0 + 8 * nn + g]));
        mma3<false, kExactV>(acc[nn], fa, fb);
      }
    }
#pragma unroll
    for (int nn = 0; nn < 2; ++nn) {
      float* yo = y + j0 + 8 * nn + 2 * q;
      if (g < n)
        *reinterpret_cast<float2*>(yo + (t0 + g) * a.y_st) =
            make_float2(acc[nn][0], acc[nn][1]);
      if (g + 8 < n)
        *reinterpret_cast<float2*>(yo + (t0 + g + 8) * a.y_st) =
            make_float2(acc[nn][2], acc[nn][3]);
    }

    // the state: S^T <- S^T diag(decay) + V^T K~
#pragma unroll
    for (int nn = 0; nn < NB; ++nn) {
      const float2 d =
          *reinterpret_cast<const float2*>(&sh.decay[8 * nn + 2 * q]);
      st[nn][0] *= d.x;
      st[nn][1] *= d.y;
      st[nn][2] *= d.x;
      st[nn][3] *= d.y;
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const T* v0 = sh.v[buf][8 * kk + q];
      const T* v4 = sh.v[buf][8 * kk + q + 4];
      Frag<4> fa;
      fa.template set<kExactV>(0, to_f32(v0[j0 + g]));
      fa.template set<kExactV>(1, to_f32(v0[j0 + g + 8]));
      fa.template set<kExactV>(2, to_f32(v4[j0 + g]));
      fa.template set<kExactV>(3, to_f32(v4[j0 + g + 8]));
#pragma unroll
      for (int nn = 0; nn < NB; ++nn) {
        Frag<2> fb;
        fb.set(0, sh.kd[8 * kk + q][8 * nn + g]);
        fb.set(1, sh.kd[8 * kk + q + 4][8 * nn + g]);
        mma3<kExactV, false>(st[nn], fa, fb);
      }
    }
  }

  float* sT = a.sT + b * a.sT_sb + h * a.sT_sh + j0 + g;
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    float* p = sT + (8 * n + 2 * q) * DH;
    p[0] = st[n][0];
    p[DH] = st[n][1];
    p[8] = st[n][2];
    p[DH + 8] = st[n][3];
  }
}

template <typename T, typename U, int DH>
int launch_chunked(const Args& a, int B, cudaStream_t stream) {
  constexpr int bytes = sizeof(ChunkShared<T, DH>);
  // above 48 KB a block's shared memory must be asked for, once
  static const cudaError_t set = cudaFuncSetAttribute(
      rwkv6_chunk_kernel<T, U, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (set != cudaSuccess) return static_cast<int>(set);
  rwkv6_chunk_kernel<T, U, DH><<<B * a.H, 2 * DH, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename U, int DH>
int launch(const Args& a, int B, cudaStream_t stream) {
  if (a.S_len >= kChunk) return launch_chunked<T, U, DH>(a, B, stream);
  rwkv6_step_kernel<T, U, DH><<<B * a.H, DH, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename U>
int launch_dh(const Args& a, int B, int dh, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<T, U, 16>(a, B, stream);
    case 32: return launch<T, U, 32>(a, B, stream);
    case 64: return launch<T, U, 64>(a, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_u(const Args& a, int B, int dh, int u_dtype, cudaStream_t s) {
  if (u_dtype == 0) return launch_dh<T, float>(a, B, dh, s);
  if (u_dtype == 1) return launch_dh<T, __nv_bfloat16>(a, B, dh, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point bound with ctypes.  Pointers are device pointers;
// strides are in elements, with a unit stride on the channel axis of
// r/k/v/w/y/u and dense (dh, dh) state matrices.  r, k, v: (B, H, S, dh) of
// dtype 0 = float32 or 1 = bfloat16; w: (B, H, S, dh) float32; u: (H, dh) of
// u_dtype; s0, sT: (B, H, dh, dh) float32 (sT may equal s0); y: (B, H, S, dh)
// float32.  For S >= 16 (the chunked body) r, k, v and w need 16-byte
// aligned bases and (b, h, t) strides, and y an 8-byte aligned base and an
// even t stride.  Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int rwkv6_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* s0, void* y, void* sT, int B, int H,
    int S_len, int dh, int dtype, int u_dtype, int64_t r_sb, int64_t r_sh,
    int64_t r_st, int64_t k_sb, int64_t k_sh, int64_t k_st, int64_t v_sb,
    int64_t v_sh, int64_t v_st, int64_t w_sb, int64_t w_sh, int64_t w_st,
    int64_t y_sb, int64_t y_sh, int64_t y_st, int64_t u_sh, int64_t s0_sb,
    int64_t s0_sh, int64_t sT_sb, int64_t sT_sh, void* stream) {
  const Args a{r,     k,     v,     static_cast<const float*>(w),
               u,     static_cast<const float*>(s0),
               static_cast<float*>(y),              static_cast<float*>(sT),
               H,     S_len, r_sb,  r_sh,  r_st,  k_sb,  k_sh,  k_st,
               v_sb,  v_sh,  v_st,  w_sb,  w_sh,  w_st,  y_sb,  y_sh,
               y_st,  u_sh,  s0_sb, s0_sh, sT_sb, sT_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_u<float>(a, B, dh, u_dtype, s);
  if (dtype == 1) return launch_u<__nv_bfloat16>(a, B, dh, u_dtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
