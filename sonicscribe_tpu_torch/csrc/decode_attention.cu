// GQA attention of decode and of speculative verification over a padded
// per-slot KV cache, split over the cache positions (flash-decoding).
//
// decode_attention replaces the TPU kernel sonicscribe_tpu/ops/
// decode_attention.py (`_kernel`, entry `flash_decode_attention`):
// ctx[s] = softmax(q[s] k^T / sqrt(hd)) v over the cache positions
// 0..lens[s] of slot s (history plus the token just written at lens[s]); a
// slot whose write was dropped (lens[s] >= M) sees all M positions, like the
// masked path (models/glm_asr.py:_masked_decode_attention).
//
// verify_attention is the attention of the JAX package's verify step
// (models/glm_asr.py:verify_step, computed there by XLA): W1 query
// positions per slot, query j of slot s over positions 0..min(lens[s] + j,
// M - 1) (its own K/V, written at lens[s] + j, and every earlier input).
//
// What bounds both on an H100: bytes. Each (slot, KV head) reads its
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
// Verification adds a query axis to the same two kernels. One K/V row now
// serves W1 x g query rows (36 at nano), more than a block holds in
// registers (kMaxG = 8), so the split block first copies its chunk of K
// and V into shared memory (16-byte loads, once; ops/decode_attention.py:
// verify_split_shape caps the chunk to fit kMaxStageBytes), then walks the
// W1 query positions, each a tile of its g query heads run as decode runs
// one slot, over the positions that query sees; a query whose positions
// end before the split skips it. Each (slot, query) row has its own
// scratch rows and merge block. Where the chunk does not fit the stage,
// the block reads global memory as decode does. W1 = 1 takes the decode
// kernels, whose W1 is 1 at compile time (MULTI false): bit for bit, and
// without the query loop's cost.
// Other shapes (hd other than 128, or K/V rows not 16-byte aligned) take
// the same kernels with scalar loads and up to 16 dims per lane (hd <=
// 256), unstaged.
//
// Layout: q [S, W1, nh, hd] (strides q_stride_s, q_stride_w; each [nh, hd]
// contiguous; decode: W1 = 1), k/v a strided view of the layer's cache
// [S, M, nkv, hd] (last dim contiguous, element strides given), lens [S]
// int32, out [S, W1, nh*hd] float32, scratch float32: context [S, W1, nkv,
// splits, g, hd] then (max, denominator) [S, W1, nkv, splits, g, 2]. Math
// in float32.

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
constexpr int kMaxStageBytes = 80 * 1024;  // K and V of a staged chunk (STAGE_BYTES)
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

// A 16-byte load: through the read-only cache from global memory, plain
// from shared memory.
template <bool SHARED>
__device__ __forceinline__ uint4 load16(const uint4* p) {
  if constexpr (SHARED) {
    return *p;
  } else {
    return __ldg(p);
  }
}

// The EPL elements of one K/V row that lane l16 owns (dims l16*EPL ..),
// as float; zeros where `valid` is false or past hd. SHARED: the row lies
// in shared memory.
template <typename T, int EPL, bool VEC, bool SHARED>
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
        const uint4 w = load16<SHARED>(p + i);
        f[4 * i + 0] = __uint_as_float(w.x);
        f[4 * i + 1] = __uint_as_float(w.y);
        f[4 * i + 2] = __uint_as_float(w.z);
        f[4 * i + 3] = __uint_as_float(w.w);
      }
    } else {
#pragma unroll
      for (int i = 0; i < EPL / 8; ++i) {
        const uint4 w = load16<SHARED>(p + i);
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

// One query tile's g query heads [g, hd] from qg into q_s, pre-scaled,
// zeros past g and hd. Every thread of the block calls it; the barrier
// that publishes q_s is attend_tile's first.
template <typename T, int G, int EPL>
__device__ __forceinline__ void load_query(const T* __restrict__ qg, int g, int hd, float scale,
                                           float (*q_s)[kLanes * EPL]) {
  constexpr int W = kLanes * EPL;
  for (int i = threadIdx.x; i < G * W; i += kThreads) {
    const int j = i / W, d = i % W;
    q_s[j][d] = (j < g && d < hd) ? to_f32(qg[j * hd + d]) * scale : 0.f;
  }
}

// One query tile, loaded into q_s by load_query, against `n` (>= 1)
// consecutive positions of one split: kb and vb the K and V rows of the
// split's first position, `row_stride` elements apart (in global memory,
// or the staged chunk in shared memory); the split's unnormalised context
// to ctx [g, hd], its (max, denominator) to ml [g, 2]. G >= g query heads
// (registers sized for G), EPL dims per lane, VEC 16-byte loads, PPG
// positions per group per pass. Every thread of the block calls it.
template <typename T, int G, int EPL, bool VEC, int PPG, bool SHARED>
__device__ __forceinline__ void attend_tile(const float (*q_s)[kLanes * EPL], const T* kb,
                                            const T* vb, long long row_stride, int n, int g,
                                            int hd, float* __restrict__ ctx,
                                            float* __restrict__ ml) {
  constexpr int W = kLanes * EPL;  // dims per row, padded
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = tid / kLanes, l16 = tid % kLanes;

  __shared__ __align__(16) float red_acc[kWarps][G][W];
  __shared__ float red_m[kWarps][G], red_l[kWarps][G];

  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[j][e] = 0.f;
  }

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
      const long long off = (long long)(ok[i] ? t : 0) * row_stride;
      load_row<T, EPL, VEC, SHARED>(kb + off, l16, hd, ok[i], kf[i]);
      load_row<T, EPL, VEC, SHARED>(vb + off, l16, hd, ok[i], vf[i]);
    }
    // the first pass's K/V loads are in flight before the barrier that
    // publishes q_s
    if (pass == 0) __syncthreads();
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

// One block: split `blockIdx.x` of KV head `blockIdx.y` of slot
// `blockIdx.z`, for each of the slot's W1 query positions in turn. MULTI:
// W1 = w1 may pass 1 (verification); without it W1 is 1 at compile time,
// the decode kernel. STAGED (VEC and MULTI only): the split's K/V rows are
// first copied to dynamic shared memory, K then V, each row hd values.
template <typename T, int G, int EPL, bool VEC, int PPG, bool STAGED, bool MULTI>
__global__ void __launch_bounds__(kThreads)
decode_attention_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ lens,
                       float* __restrict__ part, int M, int w1, int nkv, int g, int hd,
                       long long q_stride_s, long long q_stride_w, long long kv_stride_s,
                       long long kv_stride_m, long long kv_stride_h, float scale, int chunk,
                       int splits) {
  static_assert(MULTI || !STAGED, "decode reads global memory");
  constexpr int W = kLanes * EPL;
  const int W1 = MULTI ? w1 : 1;
  __shared__ __align__(16) float q_s[G][W];  // the current query's heads, pre-scaled
  const int sp = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  // lens[s] and query 0 are read together (one memory round trip), before
  // the early return
  const int len_s = max(lens[s], 0);
  const T* qs = q + s * q_stride_s + (long long)h * g * hd;
  load_query<T, G, EPL>(qs, g, hd, scale, q_s);
  const int start = sp * chunk;
  // query j sees min(len_s + j, M - 1) + 1 positions, the last query the most
  const int n_last = min(len_s + W1 - 1, M - 1) + 1;
  if (start >= n_last) return;  // the whole block: no query sees this split
  const T* kb = k + s * kv_stride_s + h * kv_stride_h + start * kv_stride_m;
  const T* vb = v + s * kv_stride_s + h * kv_stride_h + start * kv_stride_m;
  long long row_stride = kv_stride_m;
  if constexpr (STAGED) {
    static_assert(VEC, "the stage copies 16-byte rows");
    constexpr int U = kLanes * EPL * (int)sizeof(T) / 16;  // 16-byte words per row
    extern __shared__ uint4 stage[];
    uint4* ks = stage;
    uint4* vs = stage + (long long)chunk * U;
    const int rows = min(chunk, n_last - start);
    for (int i = threadIdx.x; i < rows * U; i += kThreads) {
      const int r = i / U, c = i % U;
      ks[i] = __ldg(reinterpret_cast<const uint4*>(kb + r * kv_stride_m) + c);
      vs[i] = __ldg(reinterpret_cast<const uint4*>(vb + r * kv_stride_m) + c);
    }
    __syncthreads();
    kb = reinterpret_cast<const T*>(ks);
    vb = reinterpret_cast<const T*>(vs);
    row_stride = kLanes * EPL;
  }
  // (slot, query) rows of the scratch
  float* ml_base = part + (long long)gridDim.z * W1 * nkv * splits * g * hd;
  for (int j = 0; j < W1; ++j) {
    const int n_valid = min(len_s + j, M - 1) + 1;
    if (start >= n_valid) continue;  // the whole block: query j sees nothing of the split
    // query 0 is loaded; a later query overwrites q_s once the previous
    // tile's reads of it are behind attend_tile's barriers
    if (j > 0) load_query<T, G, EPL>(qs + j * q_stride_w, g, hd, scale, q_s);
    const long long row = ((long long)(s * W1 + j) * nkv + h) * splits + sp;
    attend_tile<T, G, EPL, VEC, PPG, STAGED>(q_s, kb, vb, row_stride,
                                             min(chunk, n_valid - start), g, hd,
                                             part + row * g * hd, ml_base + row * g * 2);
  }
}

// One block per (KV head, slot x query row): the splits that saw
// positions, rescaled to their common max and added in order, over the
// total denominator. MULTI as in the split kernel.
template <bool MULTI>
__global__ void __launch_bounds__(kThreads)
decode_attention_merge_kernel(const float* __restrict__ part, const int* __restrict__ lens,
                       float* __restrict__ out, int M, int w1, int nkv, int g, int hd,
                       int chunk, int splits) {
  const int W1 = MULTI ? w1 : 1;
  const int h = blockIdx.x, r = blockIdx.y, R = gridDim.y;  // r = slot * W1 + query
  const int s = r / W1, jq = r - s * W1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_valid = min(max(lens[s], 0) + jq, M - 1) + 1;
  const int n_split = (n_valid + chunk - 1) / chunk;
  __shared__ float coef[kMaxSplits][kMaxG];

  const long long row0 = ((long long)r * nkv + h) * splits;
  const float* ctx = part + row0 * g * hd;
  const float* ml = part + (long long)R * nkv * splits * g * hd + row0 * g * 2;
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
  float* o = out + (long long)r * nkv * g * hd + (long long)h * g * hd;
  for (int i = tid; i < g * hd; i += kThreads) {
    const int j = i / hd;
    float a = 0.f;
    for (int sp = 0; sp < n_split; ++sp) a = fmaf(coef[sp][j], ctx[(long long)sp * g * hd + i], a);
    o[i] = a;
  }
}

template <typename T, int G, int EPL, bool VEC, int PPG, bool STAGED, bool MULTI>
cudaError_t launch_split(const void* q, const void* k, const void* v, const int* lens,
                         float* part, int S, int W1, int M, int nkv, int g, int hd,
                         long long q_stride_s, long long q_stride_w, long long kv_stride_s,
                         long long kv_stride_m, long long kv_stride_h, float scale, int chunk,
                         int splits, cudaStream_t stream) {
  const dim3 grid(splits, nkv, S);
  size_t smem = 0;
  if constexpr (STAGED) {
    // above 48 KB a block's dynamic shared memory needs the attribute, set
    // once per kernel
    static bool attribute_set = false;
    if (!attribute_set) {
      const cudaError_t err = cudaFuncSetAttribute(
          decode_attention_split_kernel<T, G, EPL, VEC, PPG, STAGED, MULTI>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxStageBytes);
      if (err != cudaSuccess) return err;
      attribute_set = true;
    }
    smem = 2 * (size_t)chunk * hd * sizeof(T);
  }
  decode_attention_split_kernel<T, G, EPL, VEC, PPG, STAGED, MULTI>
      <<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lens, part,
      M, W1, nkv, g, hd, q_stride_s, q_stride_w, kv_stride_s, kv_stride_m, kv_stride_h, scale,
      chunk, splits);
  return cudaSuccess;
}

#define SPLIT_ARGS                                                                             \
  q, k, v, lens, part, S, W1, M, nkv, g, hd, q_stride_s, q_stride_w, kv_stride_s, kv_stride_m, \
      kv_stride_h, scale, chunk, splits, stream

// The split kernel's variant for the shapes: 4 or 8 query heads in
// registers, 16-byte or scalar loads, staged (MULTI only) or not.
template <typename T, bool MULTI>
cudaError_t launch_splits(bool staged, bool vec, bool small_g, const void* q, const void* k,
                          const void* v, const int* lens, float* part, int S, int W1, int M,
                          int nkv, int g, int hd, long long q_stride_s, long long q_stride_w,
                          long long kv_stride_s, long long kv_stride_m, long long kv_stride_h,
                          float scale, int chunk, int splits, cudaStream_t stream) {
  if constexpr (MULTI) {
    if (staged && small_g) return launch_split<T, 4, 8, true, 4, true, true>(SPLIT_ARGS);
    if (staged) return launch_split<T, 8, 8, true, 4, true, true>(SPLIT_ARGS);
  }
  if (vec && small_g) return launch_split<T, 4, 8, true, 4, false, MULTI>(SPLIT_ARGS);
  if (vec) return launch_split<T, 8, 8, true, 4, false, MULTI>(SPLIT_ARGS);
  if (small_g) return launch_split<T, 4, 16, false, 1, false, MULTI>(SPLIT_ARGS);
  return launch_split<T, 8, 16, false, 1, false, MULTI>(SPLIT_ARGS);
}

#undef SPLIT_ARGS

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lens, void* out,
           void* scratch, int S, int W1, int M, int nkv, int g, int hd, long long q_stride_s,
           long long q_stride_w, long long kv_stride_s, long long kv_stride_m,
           long long kv_stride_h, float scale, int chunk, int splits, cudaStream_t stream) {
  if (g < 1 || g > kMaxG || hd < 1 || hd > kMaxHd || M < 1 || S < 1 || S > 65535 || W1 < 1 ||
      (long long)S * W1 > 65535 || nkv < 1 || nkv > 65535 || chunk < 1 || splits < 1 ||
      splits > kMaxSplits || (long long)chunk * splits < M) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* ln = static_cast<const int*>(lens);
  float* part = static_cast<float*>(scratch);
  const long long esz = sizeof(T);
  const bool vec = hd == kLanes * 8 && (reinterpret_cast<uintptr_t>(k) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(v) % 16 == 0) && (kv_stride_s * esz) % 16 == 0 &&
                   (kv_stride_m * esz) % 16 == 0 && (kv_stride_h * esz) % 16 == 0;
  const bool small_g = g <= 4;
  const bool staged = W1 > 1 && vec && 2LL * chunk * hd * esz <= kMaxStageBytes;
#define SPLITS_ARGS                                                                      \
  staged, vec, small_g, q, k, v, ln, part, S, W1, M, nkv, g, hd, q_stride_s, q_stride_w, \
      kv_stride_s, kv_stride_m, kv_stride_h, scale, chunk, splits, stream
  cudaError_t err = W1 > 1 ? launch_splits<T, true>(SPLITS_ARGS)
                           : launch_splits<T, false>(SPLITS_ARGS);
#undef SPLITS_ARGS
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 merge_grid(nkv, S * W1);
  if (W1 > 1) {
    decode_attention_merge_kernel<true><<<merge_grid, kThreads, 0, stream>>>(
        part, ln, static_cast<float*>(out), M, W1, nkv, g, hd, chunk, splits);
  } else {
    decode_attention_merge_kernel<false><<<merge_grid, kThreads, 0, stream>>>(
        part, ln, static_cast<float*>(out), M, W1, nkv, g, hd, chunk, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k and v share it); q [S, W1, nh,
// hd], W1 = 1 for decode. The positions are cut into `splits` chunks of
// `chunk` (chunk * splits >= M, splits <= 128); scratch holds S * W1 * nkv
// * splits * g * (hd + 2) float32. A chunk whose K and V fit
// kMaxStageBytes is staged in shared memory when W1 > 1. Returns the
// cudaError_t of the launches (0 on success).
extern "C" int attention(const void* q, const void* k, const void* v, const void* lens,
                         void* out, void* scratch, int dtype, int S, int W1, int M, int nkv,
                         int g, int hd, long long q_stride_s, long long q_stride_w,
                         long long kv_stride_s, long long kv_stride_m, long long kv_stride_h,
                         float scale, int chunk, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, lens, out, scratch, S, W1, M, nkv, g, hd, q_stride_s,
                         q_stride_w, kv_stride_s, kv_stride_m, kv_stride_h, scale, chunk,
                         splits, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, lens, out, scratch, S, W1, M, nkv, g, hd, q_stride_s,
                                 q_stride_w, kv_stride_s, kv_stride_m, kv_stride_h, scale, chunk,
                                 splits, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
