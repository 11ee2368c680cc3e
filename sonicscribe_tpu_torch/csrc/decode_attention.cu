// Single-query GQA decode attention over a padded per-slot KV cache.
//
// Replaces the TPU kernel sonicscribe_tpu/ops/decode_attention.py
// (`_kernel`, entry `flash_decode_attention`): ctx[s] = softmax(q[s] k^T /
// sqrt(hd)) v over the cache positions 0..lens[s] of slot s (history plus
// the token just written at lens[s]); a slot whose write was dropped
// (lens[s] >= M) sees all M positions, like the masked path
// (models/glm_asr.py:_masked_decode_attention).
//
// What bounds it on an H100: bytes. Each (slot, KV head) reads its
// (lens+1) x hd keys and values once and does ~4 flops per byte read
// (g = 4 query heads share each K/V row), far below the card's
// ~20 f32 flops/byte ridge. The design reads only the occupied positions
// (the loop stops at lens[s], so cost follows occupancy, not capacity),
// reads each K/V row once for all g query heads of its group, and keeps
// scores, probabilities and the context accumulator in shared memory and
// registers. One block per (slot, KV head): at batch 1 only nkv = 4
// blocks run, so the card is far from its memory rate; splitting the
// positions over more blocks (split-KV) is later work.
//
// Layout: q [S, nh, hd] (row stride q_stride_s), k/v a strided view of the
// layer's cache [S, M, nkv, hd] (last dim contiguous, element strides
// given), lens [S] int32, out [S, nh*hd] float32. Math in float32 with an
// online softmax (running max and denominator per query head).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;      // KV positions per pass
constexpr int kMaxG = 8;       // query heads per KV head
constexpr int kMaxHd = 256;
constexpr int kDimsPerThread = kMaxHd / kThreads;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ lens,
                        float* __restrict__ out, int M, int nkv, int g, int hd,
                        long long q_stride_s, long long kv_stride_s,
                        long long kv_stride_m, long long kv_stride_h, float scale) {
  const int s = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  __shared__ float q_s[kMaxG][kMaxHd];  // this group's queries, pre-scaled
  __shared__ float p_s[kMaxG][kTile];   // scores, then probabilities
  __shared__ float m_s[kMaxG], d_s[kMaxG], corr_s[kMaxG];

  const int n_valid = min(max(lens[s], 0), M - 1) + 1;
  const T* qg = q + s * q_stride_s + (long long)h * g * hd;
  for (int i = tid; i < g * hd; i += kThreads) q_s[i / hd][i % hd] = to_f32(qg[i]) * scale;
  if (tid < g) {
    m_s[tid] = kNegInf;
    d_s[tid] = 0.f;
  }
  const T* kb = k + s * kv_stride_s + h * kv_stride_h;
  const T* vb = v + s * kv_stride_s + h * kv_stride_h;

  float acc[kMaxG][kDimsPerThread];
#pragma unroll
  for (int j = 0; j < kMaxG; ++j)
#pragma unroll
    for (int e = 0; e < kDimsPerThread; ++e) acc[j][e] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < n_valid; t0 += kTile) {
    const int nt = min(kTile, n_valid - t0);

    // scores: one warp per position, lanes across hd, all g heads at once
    for (int pi = warp; pi < nt; pi += kWarps) {
      const T* kp = kb + (t0 + pi) * kv_stride_m;
      float part[kMaxG];
#pragma unroll
      for (int j = 0; j < kMaxG; ++j) part[j] = 0.f;
      for (int d = lane; d < hd; d += 32) {
        const float kv = to_f32(kp[d]);
#pragma unroll
        for (int j = 0; j < kMaxG; ++j)
          if (j < g) part[j] += q_s[j][d] * kv;
      }
#pragma unroll
      for (int j = 0; j < kMaxG; ++j) {
        if (j < g) {
          const float sc = warp_sum(part[j]);
          if (lane == 0) p_s[j][pi] = sc;
        }
      }
    }
    __syncthreads();

    // online softmax update: one warp per query head
    for (int j = warp; j < g; j += kWarps) {
      float mx = kNegInf;
      for (int pi = lane; pi < nt; pi += 32) mx = fmaxf(mx, p_s[j][pi]);
      mx = warp_max(mx);
      const float m_new = fmaxf(m_s[j], mx);
      float sum = 0.f;
      for (int pi = lane; pi < nt; pi += 32) {
        const float e = expf(p_s[j][pi] - m_new);
        p_s[j][pi] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_s[j] - m_new);
        corr_s[j] = c;
        d_s[j] = d_s[j] * c + sum;
        m_s[j] = m_new;
      }
    }
    __syncthreads();

    // context: one thread per output dim, all g heads
#pragma unroll
    for (int e = 0; e < kDimsPerThread; ++e) {
      const int d = tid + e * kThreads;
      if (d < hd) {
#pragma unroll
        for (int j = 0; j < kMaxG; ++j)
          if (j < g) acc[j][e] *= corr_s[j];
        for (int pi = 0; pi < nt; ++pi) {
          const float vv = to_f32(vb[(t0 + pi) * kv_stride_m + d]);
#pragma unroll
          for (int j = 0; j < kMaxG; ++j)
            if (j < g) acc[j][e] += p_s[j][pi] * vv;
        }
      }
    }
    __syncthreads();  // p_s and corr_s are rewritten by the next pass
  }

  float* o = out + (long long)s * (nkv * g * hd) + (long long)h * g * hd;
#pragma unroll
  for (int e = 0; e < kDimsPerThread; ++e) {
    const int d = tid + e * kThreads;
    if (d < hd) {
#pragma unroll
      for (int j = 0; j < kMaxG; ++j)
        if (j < g) o[j * hd + d] = acc[j][e] / fmaxf(d_s[j], 1e-30f);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lens, void* out,
           int S, int M, int nkv, int g, int hd, long long q_stride_s,
           long long kv_stride_s, long long kv_stride_m, long long kv_stride_h,
           float scale, void* stream) {
  if (g < 1 || g > kMaxG || hd < 1 || hd > kMaxHd || M < 1) return (int)cudaErrorInvalidValue;
  dim3 grid(S, nkv);
  decode_attention_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)lens, (float*)out, M, nkv, g, hd,
      q_stride_s, kv_stride_s, kv_stride_m, kv_stride_h, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k and v share it). Returns the
// cudaError_t of the launch (0 on success).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* lens, void* out, int dtype, int S, int M,
                                int nkv, int g, int hd, long long q_stride_s,
                                long long kv_stride_s, long long kv_stride_m,
                                long long kv_stride_h, float scale, void* stream) {
  if (dtype == 0)
    return launch<float>(q, k, v, lens, out, S, M, nkv, g, hd, q_stride_s, kv_stride_s,
                         kv_stride_m, kv_stride_h, scale, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, lens, out, S, M, nkv, g, hd, q_stride_s,
                                 kv_stride_s, kv_stride_m, kv_stride_h, scale, stream);
  return (int)cudaErrorInvalidValue;
}
