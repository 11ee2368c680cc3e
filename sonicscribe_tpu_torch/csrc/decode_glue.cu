// The per-layer elementwise glue of the decoder's decode family
// (models/glm_asr.py: decode_step, decode_step_dual, verify_step), fused
// into three kernels:
// - add_rms_norm: the residual add, then RMSNorm of the sum;
// - qkv_rope_kv_write: the QKV bias, the partial NeoX RoPE of q and k, and
//   the write of each row's k and v into the layer's cache at its position;
// - silu_mul: SiLU of the gate times the up half of the gate_up product.
//
// They replace no Pallas kernel: in the JAX package XLA fuses this glue
// into the products around it. Run one PyTorch op at a time it was ~60
// launches a layer (RMSNorm 9, RoPE ~11 each for q and k, the K/V write 6),
// at ~2 us each more than half of a decode step on an H100, while the bytes
// it moves are ~0.3 MB a layer at 33 rows. What bounds these kernels is
// launch and latency, not bytes or operations, so each is one launch whose
// blocks each finish one row (or one head of one row) in a single pass.
//
// Every step keeps the op order and the roundings of the PyTorch ops it
// replaces, with no FMA contraction (__fmul_rn / __fadd_rn), so that the
// results equal theirs bit for bit; the RMSNorm's float32 sum of squares is
// the only value taken in another order than PyTorch's reduction.

#include "common.cuh"

namespace {

constexpr int kNormThreads = 256;
constexpr int kSiluThreads = 256;

// v rounded to T and back: what storing a float into a T tensor keeps
template <typename T>
__device__ __forceinline__ float rounded(float v);
template <>
__device__ __forceinline__ float rounded<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float rounded<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// h_out = T(h + delta) (skipped where delta is null: h_out is h), then
// hn = T(x * rsqrt(mean(x^2) + eps) * scale) on that row x in float32:
// models/glm_asr.py's `h + delta` and `_rms_norm`. One block per row; the
// row's sums sit in shared memory between the two passes.
template <typename T>
__global__ void __launch_bounds__(kNormThreads)
    add_rms_norm_kernel(const T* __restrict__ h, const T* __restrict__ delta,
                        const T* __restrict__ scale, T* __restrict__ h_out, T* __restrict__ hn,
                        int D, float eps, float inv_d) {
  extern __shared__ float row[];
  __shared__ float warp_sums[kNormThreads / 32];
  const long long base = static_cast<long long>(blockIdx.x) * D;
  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += kNormThreads) {
    float x = to_f32(h[base + i]);
    if (delta != nullptr) {
      x = rounded<T>(__fadd_rn(x, to_f32(delta[base + i])));
      store(h_out + base + i, x);
    }
    row[i] = x;
    ss = __fadd_rn(ss, __fmul_rn(x, x));
  }
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < kNormThreads / 32; ++w) total += warp_sums[w];  // fixed order
  const float r = rsqrtf(__fadd_rn(__fmul_rn(total, inv_d), eps));
  for (int i = threadIdx.x; i < D; i += kNormThreads)
    store(hn + base + i, __fmul_rn(__fmul_rn(row[i], r), to_f32(scale[i])));
}

// qkv row r (= b * W1 + j) holds [q heads | k heads | v heads] of hd dims.
// Block (r, head), one thread per dim: t = T(qkv + bias); q and k take the
// NeoX rotation of their first 2 * half dims in float32 from the row's
// cos / sin [half] (out1 = x1 c - x2 s, out2 = x2 c + x1 s, rounded once);
// q goes to q_out [R, nh, hd], k and v to the caches at (b, pos[b] + j),
// through their strides, and nowhere where that position is >= M (JAX's
// mode="drop").
template <typename T>
__global__ void qkv_rope_kv_write_kernel(const T* __restrict__ qkv, const T* __restrict__ bias,
                                         const float* __restrict__ cos_t,
                                         const float* __restrict__ sin_t, T* __restrict__ q_out,
                                         T* __restrict__ k_cache, T* __restrict__ v_cache,
                                         const int* __restrict__ pos, int W1, int M, int nh,
                                         int nkv, int hd, int half, long long kv_stride_b,
                                         long long kv_stride_m, long long kv_stride_h) {
  const int r = blockIdx.x, head = blockIdx.y, d = threadIdx.x;
  const int n = (nh + 2 * nkv) * hd;
  const T* x = qkv + static_cast<long long>(r) * n;
  const int e = head * hd + d;
  const auto biased = [&](int i) {
    const float v = to_f32(x[i]);
    return bias == nullptr ? v : rounded<T>(__fadd_rn(v, to_f32(bias[i])));
  };
  float t = biased(e);
  if (head < nh + nkv && d < 2 * half) {
    const bool first = d < half;
    const int i = first ? d : d - half;
    const float u = biased(first ? e + half : e - half);
    const float c = cos_t[static_cast<long long>(r) * half + i];
    const float s = sin_t[static_cast<long long>(r) * half + i];
    t = first ? __fsub_rn(__fmul_rn(t, c), __fmul_rn(u, s))
              : __fadd_rn(__fmul_rn(t, c), __fmul_rn(u, s));
  }
  if (head < nh) {
    store(q_out + static_cast<long long>(r) * nh * hd + e, t);
    return;
  }
  const int b = r / W1;
  const long long p = static_cast<long long>(pos[b]) + (r - b * W1);
  if (p >= M) return;
  const bool is_k = head < nh + nkv;
  T* dst = (is_k ? k_cache : v_cache) + b * kv_stride_b + p * kv_stride_m +
           static_cast<long long>(is_k ? head - nh : head - nh - nkv) * kv_stride_h + d;
  store(dst, t);
}

// act [R, F] = T(T(silu(gate)) * up) of gate_up [R, 2F] = [gate | up]:
// F.silu(gate) * up, silu as PyTorch's CUDA kernel computes it, x / (1 +
// exp(-x)) in float32.
template <typename T>
__global__ void __launch_bounds__(kSiluThreads)
    silu_mul_kernel(const T* __restrict__ gate_up, T* __restrict__ act, long long total, int F) {
  for (long long idx = static_cast<long long>(blockIdx.x) * kSiluThreads + threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * kSiluThreads) {
    const long long r = idx / F;
    const int f = static_cast<int>(idx - r * F);
    const float g = to_f32(gate_up[r * 2 * F + f]);
    const float u = to_f32(gate_up[r * 2 * F + F + f]);
    const float s = rounded<T>(__fdiv_rn(g, __fadd_rn(1.f, expf(-g))));
    store(act + idx, __fmul_rn(s, u));
  }
}

template <typename T>
int launch_add_rms_norm(const void* h, const void* delta, const void* scale, void* h_out, void* hn,
                        int R, int D, float eps, cudaStream_t st) {
  add_rms_norm_kernel<T><<<R, kNormThreads, D * sizeof(float), st>>>(
      static_cast<const T*>(h), static_cast<const T*>(delta), static_cast<const T*>(scale),
      static_cast<T*>(h_out), static_cast<T*>(hn), D, eps, 1.f / static_cast<float>(D));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_qkv_rope(const void* qkv, const void* bias, const void* cos_t, const void* sin_t,
                    void* q_out, void* k_cache, void* v_cache, const void* pos, int R, int W1,
                    int M, int nh, int nkv, int hd, int half, long long kv_stride_b,
                    long long kv_stride_m, long long kv_stride_h, cudaStream_t st) {
  qkv_rope_kv_write_kernel<T><<<dim3(R, nh + 2 * nkv), hd, 0, st>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(bias), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<T*>(q_out), static_cast<T*>(k_cache),
      static_cast<T*>(v_cache), static_cast<const int*>(pos), W1, M, nh, nkv, hd, half,
      kv_stride_b, kv_stride_m, kv_stride_h);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_silu_mul(const void* gate_up, void* act, int R, int F, int n_sms, cudaStream_t st) {
  const long long total = static_cast<long long>(R) * F;
  const long long want = (total + kSiluThreads - 1) / kSiluThreads;
  const int blocks = static_cast<int>(want < 8LL * n_sms ? want : 8LL * n_sms);
  silu_mul_kernel<T><<<blocks, kSiluThreads, 0, st>>>(static_cast<const T*>(gate_up),
                                                      static_cast<T*>(act), total, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype 0 float32, 1 bf16. Every function returns the cudaError_t of its
// launch (0 on success).

// h, delta (nullable: then h_out is unused), h_out, hn: contiguous [R, D];
// scale [D]; D * 4 bytes of shared memory, at most 48 KB.
extern "C" int add_rms_norm(const void* h, const void* delta, const void* scale, void* h_out,
                            void* hn, int dtype, int R, int D, float eps, void* stream) {
  if (R < 1 || D < 1 || D > 12288) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_add_rms_norm<float>(h, delta, scale, h_out, hn, R, D, eps, st);
  if (dtype == 1)
    return launch_add_rms_norm<__nv_bfloat16>(h, delta, scale, h_out, hn, R, D, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// qkv contiguous [R, (nh + 2 nkv) hd] with R = B * W1; bias (nullable)
// [(nh + 2 nkv) hd]; cos / sin float32 contiguous [R, half]; q_out
// contiguous [R, nh, hd]; k / v caches [B, M, nkv, hd] with the given
// strides and a unit last stride; pos int32 [B]; hd <= 1024.
extern "C" int qkv_rope_kv_write(const void* qkv, const void* bias, const void* cos_t,
                                 const void* sin_t, void* q_out, void* k_cache, void* v_cache,
                                 const void* pos, int dtype, int R, int W1, int M, int nh,
                                 int nkv, int hd, int half, long long kv_stride_b,
                                 long long kv_stride_m, long long kv_stride_h, void* stream) {
  if (R < 1 || W1 < 1 || R % W1 || nh < 1 || nkv < 1 || hd < 1 || hd > 1024 || half < 0 ||
      2 * half > hd)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_qkv_rope<float>(qkv, bias, cos_t, sin_t, q_out, k_cache, v_cache, pos, R, W1,
                                  M, nh, nkv, hd, half, kv_stride_b, kv_stride_m, kv_stride_h, st);
  if (dtype == 1)
    return launch_qkv_rope<__nv_bfloat16>(qkv, bias, cos_t, sin_t, q_out, k_cache, v_cache, pos,
                                          R, W1, M, nh, nkv, hd, half, kv_stride_b, kv_stride_m,
                                          kv_stride_h, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// gate_up contiguous [R, 2F]; act contiguous [R, F].
extern "C" int silu_mul(const void* gate_up, void* act, int dtype, int R, int F, int n_sms,
                        void* stream) {
  if (R < 1 || F < 1 || n_sms < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_silu_mul<float>(gate_up, act, R, F, n_sms, st);
  if (dtype == 1) return launch_silu_mul<__nv_bfloat16>(gate_up, act, R, F, n_sms, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
