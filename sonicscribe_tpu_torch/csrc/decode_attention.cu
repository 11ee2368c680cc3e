// Single-query GQA decode attention over a padded per-slot KV cache,
// split over the cache positions (flash-decoding).
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
// (g query heads share each K/V row), far below the card's ridge. At
// decode sizes (one slot, a few hundred positions: ~1.4 MB) the time is
// set by how many bytes are in flight at once, not by the memory rate: one
// block per (slot, KV head) keeps only nkv = 4 blocks busy on 132 SMs and
// walks its positions one tile after another. The design:
// - split-KV: the grid is (split, KV head, slot); each block owns `chunk`
//   consecutive positions (ops/decode_attention.py:split_shape picks it so
//   that S * nkv * splits fills the card) and returns at once where its
//   chunk starts past lens[s], so cost still follows occupancy;
// - wide loads: a group of 16 lanes reads one K row and one V row in
//   16-byte vectors (8 bf16 or 2 x 4 float32 per lane at hd = 128), the 8
//   groups of a block take 8 positions side by side, and each lane issues
//   the loads of all its positions before it uses any of them; q . k is
//   reduced with shuffles inside the 16 lanes; the g query heads of the
//   group share each K/V row read;
// - each group keeps an online softmax (running max, denominator and
//   unnormalised context per query head) in registers; the two groups of a
//   warp combine by shuffle and the four warps through shared memory, in a
//   fixed order, and the block writes its split's (max, denominator,
//   context) to float32 scratch;
// - a second kernel, one block per (slot, KV head), rescales and adds the
//   splits in order 0, 1, 2, ... and normalises: no float atomics, so two
//   launches on the same inputs give the same bits. Splits that start past
//   lens[s] wrote nothing and are not read.
// Other shapes (hd other than 128, or K/V rows not 16-byte aligned) take
// the same kernel with scalar loads and up to 16 dims per lane (hd <= 256).
//
// Layout: q [S, nh, hd] (row stride q_stride_s), k/v a strided view of the
// layer's cache [S, M, nkv, hd] (last dim contiguous, element strides
// given), lens [S] int32, out [S, nh*hd] float32, scratch float32:
// context [S, nkv, splits, g, hd] then (max, denominator) [S, nkv, splits,
// g, 2]. Math in float32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 16;                // lanes per K/V row
constexpr int kGroups = kThreads / kLanes;  // positions side by side
constexpr int kMaxG = 8;                  // query heads per KV head
constexpr int kMaxHd = 256;
constexpr int kMaxSplits = 128;
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

// Sum over the 16 lanes of a half warp (every lane gets it).
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The EPL elements of one K/V row that lane l16 owns (dims l16*EPL ..),
// as float; zeros where `valid` is false or past hd.
template <typename T, int EPL, bool VEC>
__device__ __forceinline__ void load_row(const T* row, int l16, int hd, bool valid,
                                         float (&f)[EPL]) {
  if constexpr (VEC) {  // hd == kLanes * EPL, 16-byte aligned rows
    if (!valid) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) f[e] = 0.f;
      return;
    }
    const uint4* p = reinterpret_cast<const uint4*>(row + l16 * EPL);
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int i = 0; i < EPL / 4; ++i) {
        const uint4 w = __ldg(p + i);
        f[4 * i + 0] = __uint_as_float(w.x);
        f[4 * i + 1] = __uint_as_float(w.y);
        f[4 * i + 2] = __uint_as_float(w.z);
        f[4 * i + 3] = __uint_as_float(w.w);
      }
    } else {
#pragma unroll
      for (int i = 0; i < EPL / 8; ++i) {
        const uint4 w = __ldg(p + i);
        const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // bf16 -> float is a 16-bit shift
          f[8 * i + 2 * j] = __uint_as_float(words[j] << 16);
          f[8 * i + 2 * j + 1] = __uint_as_float(words[j] & 0xffff0000u);
        }
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int d = l16 * EPL + e;
      f[e] = (valid && d < hd) ? to_f32(row[d]) : 0.f;
    }
  }
}

// One block: split `blockIdx.x` of KV head `blockIdx.y` of slot
// `blockIdx.z`. G >= g query heads (registers sized for G), EPL dims per
// lane, VEC 16-byte loads, PPG positions per group per pass.
template <typename T, int G, int EPL, bool VEC, int PPG>
__global__ void __launch_bounds__(kThreads)
decode_attention_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const int* __restrict__ lens,
                              float* __restrict__ part, int M, int nkv, int g, int hd,
                              long long q_stride_s, long long kv_stride_s,
                              long long kv_stride_m, long long kv_stride_h, float scale,
                              int chunk, int splits) {
  constexpr int W = kLanes * EPL;  // dims per row, padded
  const int sp = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = tid / kLanes, l16 = tid % kLanes;

  __shared__ __align__(16) float q_s[G][W];  // this group's queries, pre-scaled
  __shared__ __align__(16) float red_acc[kWarps][G][W];
  __shared__ float red_m[kWarps][G], red_l[kWarps][G];

  // lens[s] and q are read together (one memory round trip), and the first
  // pass's K/V loads are in flight before the barrier that publishes q_s
  const int len_s = lens[s];
  const T* qg = q + s * q_stride_s + (long long)h * g * hd;
  for (int i = tid; i < G * W; i += kThreads) {
    const int j = i / W, d = i % W;
    q_s[j][d] = (j < g && d < hd) ? to_f32(qg[j * hd + d]) * scale : 0.f;
  }
  const int n_valid = min(max(len_s, 0), M - 1) + 1;
  const int start = sp * chunk;
  if (start >= n_valid) return;  // the whole block: nothing of this split is seen
  const int n = min(chunk, n_valid - start);

  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[j][e] = 0.f;
  }
  const T* kb = k + s * kv_stride_s + h * kv_stride_h;
  const T* vb = v + s * kv_stride_s + h * kv_stride_h;

  // every lane runs every pass (the shuffles need the whole warp); positions
  // past n load nothing and weigh 0
  const int n_pass = (n + kGroups * PPG - 1) / (kGroups * PPG);
  for (int pass = 0; pass < n_pass; ++pass) {
    float kf[PPG][EPL], vf[PPG][EPL];
    bool ok[PPG];
#pragma unroll
    for (int i = 0; i < PPG; ++i) {
      const int t = (pass * PPG + i) * kGroups + grp;  // position within the chunk
      ok[i] = t < n;
      const long long off = (long long)(start + (ok[i] ? t : 0)) * kv_stride_m;
      load_row<T, EPL, VEC>(kb + off, l16, hd, ok[i], kf[i]);
      load_row<T, EPL, VEC>(vb + off, l16, hd, ok[i], vf[i]);
    }
    if (pass == 0) __syncthreads();  // q_s is written
    float sc[PPG][G];
#pragma unroll
    for (int i = 0; i < PPG; ++i) {
#pragma unroll
      for (int j = 0; j < G; ++j) {
        float part_sum = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) part_sum = fmaf(q_s[j][l16 * EPL + e], kf[i][e], part_sum);
        sc[i][j] = group_sum(part_sum);
      }
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      float m_new = m[j];
#pragma unroll
      for (int i = 0; i < PPG; ++i)
        if (ok[i]) m_new = fmaxf(m_new, sc[i][j]);
      const float c = expf(m[j] - m_new);
      l[j] *= c;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[j][e] *= c;
#pragma unroll
      for (int i = 0; i < PPG; ++i) {
        const float p = ok[i] ? expf(sc[i][j] - m_new) : 0.f;
        l[j] += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[j][e] = fmaf(p, vf[i][e], acc[j][e]);
      }
      m[j] = m_new;
    }
  }

  // the two groups of a warp: lanes 0-15 take lanes 16-31's part
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m[j], kLanes);
    const float l_o = __shfl_xor_sync(0xffffffffu, l[j], kLanes);
    const float m_new = fmaxf(m[j], m_o);
    const float a = expf(m[j] - m_new), b = expf(m_o - m_new);
    l[j] = l[j] * a + l_o * b;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const float acc_o = __shfl_xor_sync(0xffffffffu, acc[j][e], kLanes);
      acc[j][e] = acc[j][e] * a + acc_o * b;
    }
    m[j] = m_new;
  }
  if (lane < kLanes) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) red_acc[warp][j][l16 * EPL + e] = acc[j][e];
      if (l16 == 0) {
        red_m[warp][j] = m[j];
        red_l[warp][j] = l[j];
      }
    }
  }
  __syncthreads();

  // the four warps, in order; one (head, dim) per thread
  const long long row0 = ((long long)s * nkv + h) * splits + sp;  // this split's row
  float* ctx = part + row0 * g * hd;
  float* ml = part + (long long)gridDim.z * nkv * splits * g * hd + row0 * g * 2;
  for (int i = tid; i < g * hd; i += kThreads) {
    const int j = i / hd, d = i % hd;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_m[w][j]);
    float den = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(red_m[w][j] - mx);
      den = fmaf(red_l[w][j], e, den);
      a = fmaf(red_acc[w][j][d], e, a);
    }
    ctx[i] = a;
    if (d == 0) {
      ml[2 * j] = mx;
      ml[2 * j + 1] = den;
    }
  }
}

// One block per (KV head, slot): the splits that saw positions, rescaled
// to their common max and added in order, over the total denominator.
__global__ void __launch_bounds__(kThreads)
decode_attention_merge_kernel(const float* __restrict__ part, const int* __restrict__ lens,
                              float* __restrict__ out, int M, int nkv, int g, int hd,
                              int chunk, int splits) {
  const int h = blockIdx.x, s = blockIdx.y, S = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_valid = min(max(lens[s], 0), M - 1) + 1;
  const int n_split = (n_valid + chunk - 1) / chunk;
  __shared__ float coef[kMaxSplits][kMaxG];

  const long long row0 = ((long long)s * nkv + h) * splits;
  const float* ctx = part + row0 * g * hd;
  const float* ml = part + (long long)S * nkv * splits * g * hd + row0 * g * 2;
  for (int j = warp; j < g; j += kWarps) {
    float mx = kNegInf;
    for (int sp = lane; sp < n_split; sp += 32) mx = fmaxf(mx, ml[(sp * g + j) * 2]);
    mx = warp_max(mx);
    float den = 0.f;
    for (int sp = lane; sp < n_split; sp += 32)
      den = fmaf(ml[(sp * g + j) * 2 + 1], expf(ml[(sp * g + j) * 2] - mx), den);
    const float inv = 1.f / fmaxf(warp_sum(den), 1e-30f);
    for (int sp = lane; sp < n_split; sp += 32)
      coef[sp][j] = expf(ml[(sp * g + j) * 2] - mx) * inv;
  }
  __syncthreads();
  float* o = out + (long long)s * nkv * g * hd + (long long)h * g * hd;
  for (int i = tid; i < g * hd; i += kThreads) {
    const int j = i / hd;
    float a = 0.f;
    for (int sp = 0; sp < n_split; ++sp) a = fmaf(coef[sp][j], ctx[(long long)sp * g * hd + i], a);
    o[i] = a;
  }
}

template <typename T, int G, int EPL, bool VEC, int PPG>
void launch_split(const void* q, const void* k, const void* v, const int* lens, float* part,
                  int S, int M, int nkv, int g, int hd, long long q_stride_s,
                  long long kv_stride_s, long long kv_stride_m, long long kv_stride_h,
                  float scale, int chunk, int splits, cudaStream_t stream) {
  const dim3 grid(splits, nkv, S);
  decode_attention_split_kernel<T, G, EPL, VEC, PPG><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lens, part,
      M, nkv, g, hd, q_stride_s, kv_stride_s, kv_stride_m, kv_stride_h, scale, chunk, splits);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lens, void* out,
           void* scratch, int S, int M, int nkv, int g, int hd, long long q_stride_s,
           long long kv_stride_s, long long kv_stride_m, long long kv_stride_h, float scale,
           int chunk, int splits, cudaStream_t stream) {
  if (g < 1 || g > kMaxG || hd < 1 || hd > kMaxHd || M < 1 || S < 1 || S > 65535 ||
      nkv < 1 || nkv > 65535 || chunk < 1 || splits < 1 || splits > kMaxSplits ||
      (long long)chunk * splits < M) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* ln = static_cast<const int*>(lens);
  float* part = static_cast<float*>(scratch);
  const long long esz = sizeof(T);
  const bool vec = hd == kLanes * 8 && (reinterpret_cast<uintptr_t>(k) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(v) % 16 == 0) && (kv_stride_s * esz) % 16 == 0 &&
                   (kv_stride_m * esz) % 16 == 0 && (kv_stride_h * esz) % 16 == 0;
  const bool small_g = g <= 4;
  if (vec && small_g) {
    launch_split<T, 4, 8, true, 4>(q, k, v, ln, part, S, M, nkv, g, hd, q_stride_s, kv_stride_s,
                                   kv_stride_m, kv_stride_h, scale, chunk, splits, stream);
  } else if (vec) {
    launch_split<T, 8, 8, true, 4>(q, k, v, ln, part, S, M, nkv, g, hd, q_stride_s, kv_stride_s,
                                   kv_stride_m, kv_stride_h, scale, chunk, splits, stream);
  } else if (small_g) {
    launch_split<T, 4, 16, false, 1>(q, k, v, ln, part, S, M, nkv, g, hd, q_stride_s,
                                     kv_stride_s, kv_stride_m, kv_stride_h, scale, chunk, splits,
                                     stream);
  } else {
    launch_split<T, 8, 16, false, 1>(q, k, v, ln, part, S, M, nkv, g, hd, q_stride_s,
                                     kv_stride_s, kv_stride_m, kv_stride_h, scale, chunk, splits,
                                     stream);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_attention_merge_kernel<<<dim3(nkv, S), kThreads, 0, stream>>>(
      part, ln, static_cast<float*>(out), M, nkv, g, hd, chunk, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k and v share it). The positions
// are cut into `splits` chunks of `chunk` (chunk * splits >= M, splits <=
// 128); scratch holds S * nkv * splits * g * (hd + 2) float32. Returns the
// cudaError_t of the launches (0 on success).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* lens, void* out, void* scratch, int dtype, int S,
                                int M, int nkv, int g, int hd, long long q_stride_s,
                                long long kv_stride_s, long long kv_stride_m,
                                long long kv_stride_h, float scale, int chunk, int splits,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, lens, out, scratch, S, M, nkv, g, hd, q_stride_s, kv_stride_s,
                         kv_stride_m, kv_stride_h, scale, chunk, splits, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, lens, out, scratch, S, M, nkv, g, hd, q_stride_s,
                                 kv_stride_s, kv_stride_m, kv_stride_h, scale, chunk, splits, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
