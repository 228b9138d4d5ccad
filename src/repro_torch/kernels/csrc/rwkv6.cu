// WKV6 recurrence for Hopper (sm_90a): the time-mix hot spot of RWKV-6.
//
// Replaces the Pallas TPU kernel `rwkv6_chunked` of the JAX package's
// src/repro/kernels/rwkv6_kernel.py.  For every (b, h), with the state
// S[i, j] indexed [key channel i, value channel j], in float32:
//   y_t = r_t . S + (sum_i r_t[i] u[i] k_t[i]) v_t
//   S  <- diag(w_t) S + k_t^T v_t
// over t = 0 .. S_len - 1, from the given starting state; y and the final
// state are written in float32.
//
// Bound: at decode (one step) memory — each (dh, dh) float32 state is read
// and written once, 2 * 4 * dh^2 bytes per (b, h), against ~5 dh^2 flops;
// at prefill (S_len steps) the ~5 dh^2 float32 flops per (b, h, t) (outside
// the tensor cores) and the bytes of r/k/v/w/y are of one order.  The steps
// are sequential, so a (b, h) is a chain of S_len dependent updates.
//
// Design (simple first).  The TPU kernel's sequential chunk grid axis and
// its VMEM state scratch become one thread block per (b, h) whose loop walks
// the sequence: dh threads, thread j keeping column S[:, j] in registers for
// the whole sequence (each block owns its state, so the final state may be
// written over the starting one).  r, k, v and w are staged in shared memory
// kChunk steps at a time, double-buffered: the loads of chunk c + 1 start
// into registers before chunk c is computed, so their latency hides behind
// it, and one __syncthreads per chunk suffices.  At staging, thread j
// also stores r_t[j] u[j] k_t[j], so the bonus is one sum over shared memory
// per step.  Per step, thread j reads the step's r, k, w rows from shared
// memory (broadcast) and computes y_j = sum_i r_i S_ij + bonus v_j, then
// S_ij <- w_i S_ij + k_i v_j.  Unlike the Pallas kernel, any S_len >= 1 is
// taken (the last chunk is ragged).  r, k, v, w and y are addressed through
// their (b, h, t) strides with a unit channel stride, so the model passes
// transposed views of its (B, S, H, dh) activations and nothing is copied.
// Chunked (parallel-in-time) forms, tensor cores and several heads per block
// are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;

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

template <typename T, typename U, int DH>
__global__ void __launch_bounds__(DH) rwkv6_kernel(const Args a) {
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

template <typename T, typename U>
int launch_dh(const Args& a, int B, int dh, cudaStream_t stream) {
  const dim3 grid(B * a.H);
  switch (dh) {
    case 16: rwkv6_kernel<T, U, 16><<<grid, 16, 0, stream>>>(a); break;
    case 32: rwkv6_kernel<T, U, 32><<<grid, 32, 0, stream>>>(a); break;
    case 64: rwkv6_kernel<T, U, 64><<<grid, 64, 0, stream>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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
// float32.  Launches on `stream`, does not synchronise, and returns
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
