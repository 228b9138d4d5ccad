// Resident flash-decode for Hopper (sm_90a): one query token per batch row
// against a long KV cache, over only the q-head rows one device hosts.
//
// Replaces the Pallas TPU kernel `decode_attention_resident` in the JAX
// package's src/repro/kernels/decode_attention.py (body `_kernel` via
// `_kernel_resident`).  Same function: for each (b, r)
//   out[b, r] = softmax(q[b, rows[r]] . k[b, kv_rows[r], :len]^T / sqrt(dh))
//               . v[b, kv_rows[r], :len],      len = clamp(lengths[b], 0, T)
// with f32 accumulation, an online softmax (m, l, acc) and the reference's
// l >= 1e-30 clamp, so a row with len == 0 returns zeros.  Output (B, R, dh)
// in q's dtype, in `rows` order.
//
// Bound: memory.  The least work is reading each valid K/V row once,
//   sum_b min(len_b, T) * KvE * dh * 2 (k and v) * itemsize bytes
// at 3.35 TB/s (H100 SXM); the arithmetic is ~4 flop per K/V element,
// far below the card's ridge point.
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
// later work.
//
// K and V are read through their strides, so the caller passes the model's
// (B, T, KvE, dh) cache as a (B, KvE, T, dh) view with no copy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_resident_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ rows, const int32_t* __restrict__ kv_rows,
    T* __restrict__ out, int H, int KvE, int T_len, int R, int64_t q_sb,
    int64_t q_sh, int64_t k_sb, int64_t k_sh, int64_t k_st, int64_t v_sb,
    int64_t v_sh, int64_t v_st, float scale) {
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
  T* o = out + ((int64_t)b * R + r) * DH;
  if (row < 0 || row >= H || kv_row < 0 || kv_row >= KvE) {
    // a gather map out of range: surface it as NaN, never read out of bounds
    for (int d = threadIdx.x; d < DH; d += blockDim.x) store(o + d, nanf(""));
    return;
  }
  const int len = min(max(lengths[b], 0), T_len);

  const T* qp = q + b * q_sb + row * q_sh;
  const T* kp = k + b * k_sb + kv_row * k_sh;
  const T* vp = v + b * v_sb + kv_row * v_sh;
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
    float kr[kUnroll][EPL], vr[kUnroll][EPL], s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      const bool ok = t < len;
#pragma unroll
      for (int i = 0; i < EPL; ++i) {
        const int d = i * 32 + lane;
        const bool in = ok && d < DH;
        kr[u][i] = in ? to_f32(kp[(int64_t)t * k_st + d]) : 0.f;
        vr[u][i] = in ? to_f32(vp[(int64_t)t * v_st + d]) : 0.f;
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
      l += p;
#pragma unroll
      for (int i = 0; i < EPL; ++i) acc[i] += p * vr[u][i];
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

template <typename T, int DH>
void launch(const void* q, const void* k, const void* v, const void* lengths,
            const void* rows, const void* kv_rows, void* out, int B, int H,
            int KvE, int T_len, int R, int64_t q_sb, int64_t q_sh,
            int64_t k_sb, int64_t k_sh, int64_t k_st, int64_t v_sb,
            int64_t v_sh, int64_t v_st, cudaStream_t stream) {
  const dim3 grid(R, B);
  decode_attention_resident_kernel<T, DH><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(kv_rows),
      static_cast<T*>(out), H, KvE, T_len, R, q_sb, q_sh, k_sb, k_sh, k_st,
      v_sb, v_sh, v_st, 1.0f / sqrtf(static_cast<float>(DH)));
}

template <typename T>
int dispatch_dh(int dh, const void* q, const void* k, const void* v,
                const void* lengths, const void* rows, const void* kv_rows,
                void* out, int B, int H, int KvE, int T_len, int R,
                int64_t q_sb, int64_t q_sh, int64_t k_sb, int64_t k_sh,
                int64_t k_st, int64_t v_sb, int64_t v_sh, int64_t v_st,
                cudaStream_t stream) {
#define REPRO_LAUNCH(DH)                                                     \
  launch<T, DH>(q, k, v, lengths, rows, kv_rows, out, B, H, KvE, T_len, R,  \
                q_sb, q_sh, k_sb, k_sh, k_st, v_sb, v_sh, v_st, stream)
  switch (dh) {
    case 16: REPRO_LAUNCH(16); break;
    case 32: REPRO_LAUNCH(32); break;
    case 64: REPRO_LAUNCH(64); break;
    case 128: REPRO_LAUNCH(128); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point bound with ctypes.  Pointers are device pointers;
// strides are in elements; dtype 0 = float32, 1 = bfloat16.  Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() after the
// launch (0 = success).
extern "C" int decode_attention_resident_launch(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* rows, const void* kv_rows, void* out, int B, int H, int KvE,
    int T_len, int R, int dh, int dtype, int64_t q_sb, int64_t q_sh,
    int64_t k_sb, int64_t k_sh, int64_t k_st, int64_t v_sb, int64_t v_sh,
    int64_t v_st, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dh<float>(dh, q, k, v, lengths, rows, kv_rows, out, B, H,
                              KvE, T_len, R, q_sb, q_sh, k_sb, k_sh, k_st,
                              v_sb, v_sh, v_st, s);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(dh, q, k, v, lengths, rows, kv_rows,
                                      out, B, H, KvE, T_len, R, q_sb, q_sh,
                                      k_sb, k_sh, k_st, v_sb, v_sh, v_st, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
