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
// Verification adds a query axis. W1 = 1 takes the decode kernels, whose
// W1 is 1 at compile time (MULTI false): bit for bit, and without the query
// loop's cost. Above, one K/V row serves W1 x g query rows (36 at nano):
// - bf16 (verify_attention_mma): the block of (split, KV head, slot) owns
//   all W1 x g rows, packed r = j * g + h' and padded to whole m16 tiles,
//   one warp per tile (at most kMmaRows = 64: W1 <= 16 at g = 4). S = Q K^T
//   and O += P V run on the tensor cores (mma.sync m16n8k16, bf16 in,
//   float32 sums): Q fragments sit in registers for the whole split,
//   unscaled (1/sqrt(hd) is applied to the float32 scores); K and V come
//   through a ring of kStages tiles of kTile positions (16-byte cp.async,
//   zeros past the last query's positions; XOR-swizzled 16-byte columns,
//   so ldmatrix on 256-byte rows is free of bank conflicts); each row keeps
//   an online softmax on its accumulator fragments (quad shuffles), masked
//   in registers (row (j, h') keeps t <= min(lens[s] + j, M - 1); padding
//   rows keep nothing and write nothing). P enters the second product as
//   three bf16 parts (hi = bf16(p), mid = bf16(p - hi), lo = bf16(p - hi -
//   mid): one part alone is ~6e-3 off at M = 803, three ~2e-8), all three
//   A fragments made straight from the first product's C fragments; each
//   dim tile's products over a ring tile start from zero and are added to
//   the float32 context on the CUDA cores (the tensor cores' own
//   accumulation truncates; carried over a whole split it would drift).
//   The bound is bytes; the tensor cores leave the arithmetic free.
// - float32 (tiny on the card): the decode kernel with a query loop, each
//   query a tile of its g heads over the positions it sees, reading global
//   memory as decode does; a query whose positions end before the split
//   skips it.
// Each (slot, query) row has its own scratch rows and merge block.
// Other shapes (hd other than 128, or K/V rows not 16-byte aligned) take
// the CUDA-core kernels with scalar loads and up to 16 dims per lane (hd <=
// 256); bf16 verification takes only what the tensor-core kernel takes.
//
// Layout: q [S, W1, nh, hd] (strides q_stride_s, q_stride_w; each [nh, hd]
// contiguous; decode: W1 = 1), k/v a strided view of the layer's cache
// [S, M, nkv, hd] (last dim contiguous, element strides given), lens [S]
// int32, out [S, W1, nh*hd] float32, scratch float32: context [S, W1, nkv,
// splits, g, hd] then (max, denominator) [S, W1, nkv, splits, g, 2]. Math
// in float32.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 16;                // lanes per K/V row
constexpr int kGroups = kThreads / kLanes;  // positions side by side
constexpr int kMaxG = 8;                  // query heads per KV head
constexpr int kMaxHd = 256;
constexpr int kMaxSplits = 128;
constexpr float kNegInf = -1e30f;

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
// split's first position, `row_stride` elements apart; the split's
// unnormalised context to ctx [g, hd], its (max, denominator) to ml [g,
// 2]. G >= g query heads
// (registers sized for G), EPL dims per lane, VEC 16-byte loads, PPG
// positions per group per pass. Every thread of the block calls it.
template <typename T, int G, int EPL, bool VEC, int PPG>
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
      load_row<T, EPL, VEC>(kb + off, l16, hd, ok[i], kf[i]);
      load_row<T, EPL, VEC>(vb + off, l16, hd, ok[i], vf[i]);
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
// W1 = w1 may pass 1 (float32 verification); without it W1 is 1 at
// compile time, the decode kernel.
template <typename T, int G, int EPL, bool VEC, int PPG, bool MULTI>
__global__ void __launch_bounds__(kThreads)
decode_attention_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ lens,
                       float* __restrict__ part, int M, int w1, int nkv, int g, int hd,
                       long long q_stride_s, long long q_stride_w, long long kv_stride_s,
                       long long kv_stride_m, long long kv_stride_h, float scale, int chunk,
                       int splits) {
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
  // (slot, query) rows of the scratch
  float* ml_base = part + (long long)gridDim.z * W1 * nkv * splits * g * hd;
  for (int j = 0; j < W1; ++j) {
    const int n_valid = min(len_s + j, M - 1) + 1;
    if (start >= n_valid) continue;  // the whole block: query j sees nothing of the split
    // query 0 is loaded; a later query overwrites q_s once the previous
    // tile's reads of it are behind attend_tile's barriers
    if (j > 0) load_query<T, G, EPL>(qs + j * q_stride_w, g, hd, scale, q_s);
    const long long row = ((long long)(s * W1 + j) * nkv + h) * splits + sp;
    attend_tile<T, G, EPL, VEC, PPG>(q_s, kb, vb, kv_stride_m, min(chunk, n_valid - start), g,
                                     hd, part + row * g * hd, ml_base + row * g * 2);
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

// ------------------------------------------- verification, bf16 tensor cores

constexpr int kMmaHd = 128;                  // head dim (MMA_HD)
constexpr int kMmaRows = kWarps * 16;        // W1 * g query rows a block holds (MMA_MAX_ROWS)
constexpr int kTile = 32;                    // positions per ring tile
constexpr int kStages = 3;                   // ring tiles in flight
constexpr int kRowBytes = kMmaHd * 2;        // one K or V row, bf16
constexpr int kCols = kRowBytes / 16;        // its 16-byte columns
constexpr int kTileBytes = kTile * kRowBytes;
constexpr int kMmaSmem = kStages * 2 * kTileBytes;  // 48 KiB: K and V of each stage

// Byte offset of 16-byte column c of row r in a ring tile: columns XORed
// with r % 8, so the 8 rows an ldmatrix reads hit 8 distinct bank groups.
__device__ __forceinline__ int swizzle(int r, int c) { return r * kRowBytes + ((c ^ (r & 7)) << 4); }

__device__ __forceinline__ unsigned pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (unsigned)__bfloat16_as_ushort(lo) | ((unsigned)__bfloat16_as_ushort(hi) << 16);
}

// p as three bf16 parts whose sum is p to ~2^-24 of p: hi, then what hi
// missed, then what both missed.
__device__ __forceinline__ void split3(float p, __nv_bfloat16 (&b)[3]) {
  b[0] = __float2bfloat16_rn(p);
  const float r = p - __bfloat162float(b[0]);
  b[1] = __float2bfloat16_rn(r);
  b[2] = __float2bfloat16_rn(r - __bfloat162float(b[1]));
}

// One block: split `blockIdx.x` of KV head `blockIdx.y` of slot
// `blockIdx.z`, all W1 x g query rows at once (warp w: rows 16w ..
// 16w + 15). Scratch as the CUDA-core kernel's.
__global__ void __launch_bounds__(kThreads)
verify_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v, const int* __restrict__ lens,
                            float* __restrict__ part, int M, int W1, int nkv, int g,
                            long long q_stride_s, long long q_stride_w, long long kv_stride_s,
                            long long kv_stride_m, long long kv_stride_h, float scale, int chunk,
                            int splits) {
  extern __shared__ __align__(128) unsigned char ring[];
  const int sp = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, quad = lane & 3;
  const int len_s = max(lens[s], 0);
  const int start = sp * chunk;
  const int n_last = min(len_s + W1 - 1, M - 1) + 1;  // positions the last query sees
  if (start >= n_last) return;  // no query sees this split
  const int n_pos = min(chunk, n_last - start);
  const int n_tiles = (n_pos + kTile - 1) / kTile;
  const __nv_bfloat16* kb = k + s * kv_stride_s + h * kv_stride_h + start * kv_stride_m;
  const __nv_bfloat16* vb = v + s * kv_stride_s + h * kv_stride_h + start * kv_stride_m;

  // ring tile `it` into stage it % kStages: each thread 4 rows of one
  // 16-byte column of K and of V; zeros past the split's last seen position
  auto load_tile = [&](int it) {
    unsigned char* ks = ring + (it % kStages) * 2 * kTileBytes;
    const int c = tid % kCols;
#pragma unroll
    for (int i = 0; i < kTile * kCols / kThreads; ++i) {
      const int r = tid / kCols + i * (kThreads / kCols);
      const int t = it * kTile + r;
      const long long off = (long long)(t < n_pos ? t : 0) * kv_stride_m + c * 8;
      cp_async16(ks + swizzle(r, c), kb + off, t < n_pos);
      cp_async16(ks + kTileBytes + swizzle(r, c), vb + off, t < n_pos);
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load_tile(st);
    cp_async_commit();
  }

  // this thread's two rows (r[0] = 16 warp + lane / 4, r[1] 8 below) and
  // the positions each sees (0 for a padding row); their Q fragments,
  // loaded while the ring fills
  const int R = W1 * g;
  const bool busy = warp * 16 < R;  // the warp holds real rows
  int r[2], n[2];
  unsigned qa[kMmaHd / 16][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    r[i] = warp * 16 + (lane >> 2) + 8 * i;
    const int j = r[i] / g;
    n[i] = r[i] < R ? min(len_s + j, M - 1) + 1 : 0;
    const unsigned* qrow = reinterpret_cast<const unsigned*>(
        q + s * q_stride_s + j * q_stride_w + ((long long)h * g + r[i] - j * g) * kMmaHd);
#pragma unroll
    for (int kk = 0; kk < kMmaHd / 16; ++kk) {
      qa[kk][i] = r[i] < R ? __ldg(qrow + kk * 8 + quad) : 0u;
      qa[kk][i + 2] = r[i] < R ? __ldg(qrow + kk * 8 + 4 + quad) : 0u;
    }
  }
  // tiles that end within every row's positions need no mask
  const int n_min = __reduce_min_sync(0xffffffffu, min(n[0], n[1]));

  float o[kMmaHd / 8][4] = {};  // unnormalised context, C fragments by 8-dim tile
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this thread's columns only
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();  // tile it has landed (this thread's copies) ...
    __syncthreads();               // ... everyone's, and stage it - 1 is free
    if (it + kStages - 1 < n_tiles) load_tile(it + kStages - 1);
    cp_async_commit();
    if (!busy) continue;
    const unsigned char* ks = ring + (it % kStages) * 2 * kTileBytes;
    const unsigned char* vs = ks + kTileBytes;
    const int mi = lane >> 3;  // the 8x8 matrix whose row address this lane gives

    // scores: 4 position tiles of 8, sums over the 8 k-steps of hd
    float sc[kTile / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < kMmaHd / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kTile / 16; ++np) {
        unsigned b[4];
        ldmatrix_x4(b, ks + swizzle(np * 16 + (mi >> 1) * 8 + (lane & 7), kk * 2 + (mi & 1)));
        mma_bf16(sc[2 * np], qa[kk], b[0], b[1]);
        mma_bf16(sc[2 * np + 1], qa[kk], b[2], b[3]);
      }
    }

    // online softmax: c[e] = (row, position) of C fragment element e
    const int t0 = start + it * kTile + quad * 2;
    const bool masked = start + (it + 1) * kTile > n_min;  // warp-uniform
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = !masked || t0 + nt * 8 + (e & 1) < n[e >> 1];
        sc[nt][e] = ok ? sc[nt][e] * scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
      }
    }
    float c[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      c[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= c[i];
    }
    // P as A fragments of the 2 k-steps of 16 positions, in three parts
    unsigned pa[3][kTile / 16][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // the row pair (e = 2i, 2i + 1)
        __nv_bfloat16 b0[3], b1[3];
        const bool ok0 = !masked || t0 + nt * 8 < n[i];
        const bool ok1 = !masked || t0 + nt * 8 + 1 < n[i];
        const float p0 = ok0 ? expf(sc[nt][2 * i] - m[i]) : 0.f;
        const float p1 = ok1 ? expf(sc[nt][2 * i + 1] - m[i]) : 0.f;
        l[i] += p0 + p1;
        split3(p0, b0);
        split3(p1, b1);
#pragma unroll
        for (int part = 0; part < 3; ++part)
          pa[part][nt >> 1][(nt & 1) * 2 + i] = pack_bf16(b0[part], b1[part]);
      }
    }
    // context: per pair of 8-dim tiles, the tile's products from zero,
    // smallest part first, then added to o on the CUDA cores
#pragma unroll
    for (int dp = 0; dp < kMmaHd / 16; ++dp) {
      float acc[2][4] = {};
#pragma unroll
      for (int ks16 = 0; ks16 < kTile / 16; ++ks16) {
        unsigned b[4];
        ldmatrix_x4_trans(b, vs + swizzle(ks16 * 16 + (mi & 1) * 8 + (lane & 7), dp * 2 + (mi >> 1)));
#pragma unroll
        for (int part = 2; part >= 0; --part) {
          mma_bf16(acc[0], pa[part][ks16], b[0], b[1]);
          mma_bf16(acc[1], pa[part][ks16], b[2], b[3]);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[2 * dp][e] = fmaf(o[2 * dp][e], c[e >> 1], acc[0][e]);
        o[2 * dp + 1][e] = fmaf(o[2 * dp + 1][e], c[e >> 1], acc[1][e]);
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
  if (!busy) return;

  // each row's denominator over its quad; rows whose query sees positions
  // of this split write (max, denominator, context) to its scratch rows
  float* ml_base = part + (long long)gridDim.z * W1 * nkv * splits * g * kMmaHd;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (start >= n[i]) continue;  // a padding row, or a query that sees nothing here
    const int j = r[i] / g;
    const long long row = (((long long)(s * W1 + j) * nkv + h) * splits + sp) * g + r[i] - j * g;
    float* ctx = part + row * kMmaHd + quad * 2;
#pragma unroll
    for (int dn = 0; dn < kMmaHd / 8; ++dn)
      *reinterpret_cast<float2*>(ctx + dn * 8) = make_float2(o[dn][2 * i], o[dn][2 * i + 1]);
    if (quad == 0) {
      ml_base[row * 2] = m[i];
      ml_base[row * 2 + 1] = l[i];
    }
  }
}

// ------------------------------------------------------------------ launches

template <typename T, int G, int EPL, bool VEC, int PPG, bool MULTI>
cudaError_t launch_split(const void* q, const void* k, const void* v, const int* lens,
                         float* part, int S, int W1, int M, int nkv, int g, int hd,
                         long long q_stride_s, long long q_stride_w, long long kv_stride_s,
                         long long kv_stride_m, long long kv_stride_h, float scale, int chunk,
                         int splits, cudaStream_t stream) {
  const dim3 grid(splits, nkv, S);
  decode_attention_split_kernel<T, G, EPL, VEC, PPG, MULTI><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lens, part,
      M, W1, nkv, g, hd, q_stride_s, q_stride_w, kv_stride_s, kv_stride_m, kv_stride_h, scale,
      chunk, splits);
  return cudaSuccess;
}

#define SPLIT_ARGS                                                                             \
  q, k, v, lens, part, S, W1, M, nkv, g, hd, q_stride_s, q_stride_w, kv_stride_s, kv_stride_m, \
      kv_stride_h, scale, chunk, splits, stream

// The split kernel's variant for the shapes: 4 or 8 query heads in
// registers, 16-byte or scalar loads.
template <typename T, bool MULTI>
cudaError_t launch_splits(bool vec, bool small_g, const void* q, const void* k, const void* v,
                          const int* lens, float* part, int S, int W1, int M, int nkv, int g,
                          int hd, long long q_stride_s, long long q_stride_w,
                          long long kv_stride_s, long long kv_stride_m, long long kv_stride_h,
                          float scale, int chunk, int splits, cudaStream_t stream) {
  if (vec && small_g) return launch_split<T, 4, 8, true, 4, MULTI>(SPLIT_ARGS);
  if (vec) return launch_split<T, 8, 8, true, 4, MULTI>(SPLIT_ARGS);
  if (small_g) return launch_split<T, 4, 16, false, 1, MULTI>(SPLIT_ARGS);
  return launch_split<T, 8, 16, false, 1, MULTI>(SPLIT_ARGS);
}

#undef SPLIT_ARGS

bool valid_shape(int S, int W1, int M, int nkv, int g, int hd, int chunk, int splits) {
  return g >= 1 && g <= kMaxG && hd >= 1 && hd <= kMaxHd && M >= 1 && S >= 1 && S <= 65535 &&
         W1 >= 1 && (long long)S * W1 <= 65535 && nkv >= 1 && nkv <= 65535 && chunk >= 1 &&
         splits >= 1 && splits <= kMaxSplits && (long long)chunk * splits >= M;
}

// The merge of a launch's splits (MULTI: W1 query rows a slot).
cudaError_t launch_merge(const float* part, const int* lens, void* out, int S, int W1, int M,
                         int nkv, int g, int hd, int chunk, int splits, cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 merge_grid(nkv, S * W1);
  if (W1 > 1) {
    decode_attention_merge_kernel<true><<<merge_grid, kThreads, 0, stream>>>(
        part, lens, static_cast<float*>(out), M, W1, nkv, g, hd, chunk, splits);
  } else {
    decode_attention_merge_kernel<false><<<merge_grid, kThreads, 0, stream>>>(
        part, lens, static_cast<float*>(out), M, W1, nkv, g, hd, chunk, splits);
  }
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lens, void* out,
           void* scratch, int S, int W1, int M, int nkv, int g, int hd, long long q_stride_s,
           long long q_stride_w, long long kv_stride_s, long long kv_stride_m,
           long long kv_stride_h, float scale, int chunk, int splits, cudaStream_t stream) {
  // bf16 verification is verify_attention_mma's
  if (!valid_shape(S, W1, M, nkv, g, hd, chunk, splits) ||
      (W1 > 1 && !std::is_same<T, float>::value)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* ln = static_cast<const int*>(lens);
  float* part = static_cast<float*>(scratch);
  const long long esz = sizeof(T);
  const bool vec = hd == kLanes * 8 && (reinterpret_cast<uintptr_t>(k) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(v) % 16 == 0) && (kv_stride_s * esz) % 16 == 0 &&
                   (kv_stride_m * esz) % 16 == 0 && (kv_stride_h * esz) % 16 == 0;
  const bool small_g = g <= 4;
#define SPLITS_ARGS                                                                             \
  vec, small_g, q, k, v, ln, part, S, W1, M, nkv, g, hd, q_stride_s, q_stride_w, kv_stride_s, \
      kv_stride_m, kv_stride_h, scale, chunk, splits, stream
  cudaError_t err;
  if constexpr (std::is_same<T, float>::value) {
    err = W1 > 1 ? launch_splits<T, true>(SPLITS_ARGS) : launch_splits<T, false>(SPLITS_ARGS);
  } else {
    err = launch_splits<T, false>(SPLITS_ARGS);
  }
#undef SPLITS_ARGS
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_merge(part, ln, out, S, W1, M, nkv, g, hd, chunk, splits, stream));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k and v share it); q [S, W1, nh,
// hd], W1 = 1 for decode, W1 > 1 float32 only. The positions are cut into
// `splits` chunks of `chunk` (chunk * splits >= M, splits <= 128); scratch
// holds S * W1 * nkv * splits * g * (hd + 2) float32. Returns the
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

// bf16 verification on the tensor cores: arguments as attention's, q, k
// and v bf16, hd = 128, W1 * g <= 64, chunk a multiple of 32; K/V rows and
// strides 16-byte aligned, q and its slot and query strides 4-byte
// aligned. Returns the cudaError_t of the launches (0 on success).
extern "C" int verify_attention_mma(const void* q, const void* k, const void* v, const void* lens,
                                    void* out, void* scratch, int S, int W1, int M, int nkv,
                                    int g, int hd, long long q_stride_s, long long q_stride_w,
                                    long long kv_stride_s, long long kv_stride_m,
                                    long long kv_stride_h, float scale, int chunk, int splits,
                                    void* stream) {
  const auto aligned = [](const void* p, int n) { return reinterpret_cast<uintptr_t>(p) % n == 0; };
  if (!valid_shape(S, W1, M, nkv, g, hd, chunk, splits) || hd != kMmaHd || W1 < 2 ||
      W1 * g > kMmaRows || chunk % kTile != 0 || !aligned(k, 16) || !aligned(v, 16) ||
      kv_stride_s % 8 || kv_stride_m % 8 || kv_stride_h % 8 || !aligned(q, 4) ||
      q_stride_s % 2 || q_stride_w % 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      verify_attention_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMmaSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int* ln = static_cast<const int*>(lens);
  float* part = static_cast<float*>(scratch);
  verify_attention_mma_kernel<<<dim3(splits, nkv, S), kThreads, kMmaSmem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), ln, part, M, W1, nkv, g, q_stride_s, q_stride_w,
      kv_stride_s, kv_stride_m, kv_stride_h, scale, chunk, splits);
  return static_cast<int>(launch_merge(part, ln, out, S, W1, M, nkv, g, hd, chunk, splits, st));
}
