// Int8-weight matrix products of the int8 serving modes.
//
// Replaces the TPU kernels sonicscribe_tpu/ops/int8_pallas.py `_kernel`
// (entry `int8_matmul`) and `_stacked_kernel` (entry `int8_matmul_stacked`),
// and is the counterpart of ops/quant.py `matmul_w8a8`, which the JAX
// package leaves to XLA:
//
//   W8A16: out[b, n] = (sum_k x[b, k] * q[k, n] in float32) * scale[n]
//   W8A8:  out[b, n] = float32(sum_k xq[b, k] * q[k, n] in int32)
//                      * sx[b] * scale[n]
//
// cast to x's type (float32 or bfloat16). q is one layer of a stack
// [L, K, N] in the JAX package's [K, N] layout (N contiguous); the layer
// is read by offset from the whole stack, so no slice is ever copied.
//
// What bounds it on an H100: at decode (B of 1 to 8 rows) bytes. The
// weight is K*N bytes and each byte feeds 2*B operations, far below the
// card's ridge, and a decode projection moves 4-23 MB, a few microseconds
// at the memory rate, so latency and launches cost as much as the bytes.
// W8A16 at decode rows (the stacked entry, and the flat one below its
// tensor-core threshold) runs cluster_splitk.cuh's one-launch design: a
// CTA per 128 columns and K slice has all its weight pieces in flight at
// once, and the K slices of a column tile form one thread-block cluster
// that adds its sums in rank 0's shared memory, in rank order
// (deterministic), and stores. `Int8Rows` below is its weight policy:
// bf16 * int8 is exact in float32, so only the summation order differs
// from the plain version.
//
// W8A8 quantises x itself (act_quant.cuh: the JAX recipe bit for bit, an
// IEEE division for sx), so a call launches only this file's kernels. A
// caller may give each row's max|x| (`row_amax`, [B] float32): a
// tensor-parallel rank whose x is its share of each row's K passes the
// max over every rank's share, so that its xq is the matching slice of
// the whole row's; the scale is then made from that value alone. The
// int32 sums are exact, so both of its designs give the plain version's
// bits. Two designs (the wrapper picks by B, ops/int8_matmul.py
// w8a8_uses_mma):
// - decode rows: the same one-launch cluster split-K kernel, with
//   `W8A8Rows` as its policy. A k-lane takes 4 consecutive rows of q
//   (four 16-byte loads, regrouped with __byte_perm into one word of 4 k
//   per column) against one word of 4 quantised k of each x row: one
//   __dp4a per column and row does 4 k. The CTA's weight loads are issued
//   first; under their latency it takes its rows' max|x| over the whole K
//   from L2 (a cluster shares no scale: each CTA needs max over all K),
//   and quantises x's slice into shared memory, 1 byte per k. No global
//   scratch and no second kernel: rank 0 adds the int32 slots in rank
//   order and applies float32(sum) * sx * scale;
// - from W8A8_MMA_MIN_ROWS rows, the s8 tensor cores (s8_mma.cuh, shared
//   with W4A8): a quantise kernel (a block per row, xq in the fragments' k
//   order, one plane), then mma.sync m16n8k32 s8 x s8 over 64 x 128 tiles
//   with q streaming in, as stored, through a 4-stage cp.async ring; q's
//   bytes are the B fragment as they are (`S8Plane`), and a split-K pass
//   where the tiles leave SMs idle.
//
// At prefill and in the encoder (bf16 x, B of hundreds to 1536 rows) the
// flat W8A16 product is bound by operations: 2*B*K*N of them on K*N weight
// bytes, ~800 per byte at B = 419, past the card's ridge, so it belongs on
// the tensor cores. `w8a16_mma_kernel` (entry int8_matmul_w8a16_mma) runs
// it there with mma.sync.m16n8k16 bf16 x bf16 -> float32:
// - a block owns 64 rows x 128 columns (qkv at B = 419: 7 x 24 = 168
//   blocks), K in steps of 128; 4 warps side by side along N, each 64 x 32
//   (4 x 4 mma tiles), so no two warps dequantise the same weights;
// - the x tile (bf16) and the q tile (int8, as stored) of each step come
//   into shared memory by cp.async, 3 steps in flight (105 KB of dynamic
//   shared memory, 2 blocks per SM), one barrier per step. On the H100
//   this copy path, not the tensor cores, sets the time (TMA and wgmma
//   are later work);
// - the layout trap: q is [K, N] with N contiguous, but mma's B operand
//   wants pairs of consecutive k per column. ldmatrix.trans over the int8
//   tile, read as 16-bit pairs of columns, hands each lane the bytes of k
//   and k+1 for two neighbouring columns; two __byte_perm split them into
//   the k pairs of an even and an odd column, so each warp's 32 columns
//   are 4 mma n-tiles (even and odd columns of two 16-column halves) and
//   the epilogue writes 4 neighbouring columns per lane;
// - int8 -> bf16 is exact (an int8 has at most 8 significant bits), in
//   registers: each byte goes into the low byte of the float 2^23 + 128 +
//   w (__byte_perm), one subtraction gives w, and the bf16 is the float's
//   high half (a second __byte_perm packs two). So every product is exact
//   and only the float32 summation order differs from the plain version;
//   the per-column scale and one cast come after.
// Shared rows are padded by 16 bytes so that each ldmatrix hits 8
// different banks. Ragged B and ragged K steps are zero-filled (cp.async
// with a source size of 0); ragged N is masked at 16-column steps.
//
// Layout: x [B, K] (float32 / bfloat16, contiguous), q [L, K, N] int8 and
// scale [L, 1, N] float32 (contiguous), out [B, N] in x's type; for W8A8's
// mma design xq [B, K rounded up to 64] int8 and sx [B] float32 scratch,
// and partial [splits, B, N] int32 when splits > 1. N must be a multiple
// of 16 (128 for W8A8's mma design); W8A8 needs K % 4 == 0 and 16-byte
// aligned x; the W8A16 mma entry needs bf16 x with K % 8 == 0 and 16-byte
// aligned x and scale (16-byte copies and loads). The wrapper
// (ops/int8_matmul.py) checks and picks the design and the launch shape;
// each entry returns the cudaError of its launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "act_quant.cuh"
#include "cluster_splitk.cuh"
#include "common.cuh"
#include "s8_mma.cuh"

namespace {

using splitk::kColsPerThread;
using splitk::kThreads;
using splitk::kWarps;

// 16 int8 of one 16-byte load -> float
__device__ __forceinline__ void unpack(const uint4 w, float (&f)[kColsPerThread]) {
  const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[4 * i + j] = static_cast<float>(static_cast<int8_t>((words[i] >> (8 * j)) & 0xff));
    }
  }
}

// the W8A16 weight policy of cluster_splitk.cuh: one x value per row
struct Int8Rows : splitk::FloatX<1, Int8Rows> {
  template <int BT>
  __device__ __forceinline__ static void accumulate(float (&acc)[BT][kColsPerThread], const uint4 w,
                                             const float (&xv)[1][BT]) {
    float wf[kColsPerThread];
    unpack(w, wf);
#pragma unroll
    for (int b = 0; b < BT; ++b) {
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) acc[b][j] = fmaf(xv[0][b], wf[j], acc[b][j]);
    }
  }
};

// rows k..k+3 of 16 columns -> per column one word of its 4 consecutive k
__device__ __forceinline__ void regroup(const uint4* r, int (&c)[kColsPerThread]) {
  const unsigned a[4] = {r[0].x, r[0].y, r[0].z, r[0].w};
  const unsigned b[4] = {r[1].x, r[1].y, r[1].z, r[1].w};
  const unsigned cc[4] = {r[2].x, r[2].y, r[2].z, r[2].w};
  const unsigned d[4] = {r[3].x, r[3].y, r[3].z, r[3].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned ab_lo = __byte_perm(a[i], b[i], 0x5140);   // a0 b0 a1 b1
    const unsigned ab_hi = __byte_perm(a[i], b[i], 0x7362);   // a2 b2 a3 b3
    const unsigned cd_lo = __byte_perm(cc[i], d[i], 0x5140);
    const unsigned cd_hi = __byte_perm(cc[i], d[i], 0x7362);
    c[4 * i + 0] = static_cast<int>(__byte_perm(ab_lo, cd_lo, 0x5410));  // a0 b0 c0 d0
    c[4 * i + 1] = static_cast<int>(__byte_perm(ab_lo, cd_lo, 0x7632));  // a1 b1 c1 d1
    c[4 * i + 2] = static_cast<int>(__byte_perm(ab_hi, cd_hi, 0x5410));
    c[4 * i + 3] = static_cast<int>(__byte_perm(ab_hi, cd_hi, 0x7632));
  }
}

// The W8A8 weight policy of cluster_splitk.cuh: x quantised per row into
// words of 4 consecutive k, 4 rows of q per k-lane step, int32 sums. The
// rows' scales need max|x| over the whole K, which no CTA's slice holds:
// every CTA reads its rows over the whole K (4-11 KB of bf16 a row at
// nano, from L2, under the weight loads' latency). Sharing the slices'
// maxima through the cluster instead (one more cluster barrier) measured
// slower at 1-2 rows on the H100 (PERF.md). Where the caller gives
// `row_amax` (a tensor-parallel rank, whose x is its K / tp share of each
// row: the max over every rank's share), that pass is skipped and row b's
// scale is made from row_amax[b] alone.
struct W8A8Rows {
  using Acc = int;
  static constexpr int kHalves = 1, kRows = 4, kXBytes = 1;
  // act: sx [8], its rounded reciprocal [8], the warps' maxima [kWarps][8]
  static constexpr int kActFloats = 16 + 8 * kWarps;

  template <typename T, int BT>
  __device__ __forceinline__ static void stage(const T* __restrict__ x, unsigned char* smem,
                                               float* act, int B, int r0, int K, int k_begin,
                                               int rows, int k_per_cta,
                                               splitk::cg::cluster_group&,
                                               const float* __restrict__ row_amax) {
    float *sxs = act, *rsxs = act + 8, *wmax = act + 16;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    if (row_amax == nullptr) {  // each row's max|x| over the whole K
      float m[BT];
#pragma unroll
      for (int b = 0; b < BT; ++b) m[b] = 0.f;
      constexpr int E = 16 / sizeof(T);
      if (K % E == 0) {  // rows 16-byte aligned: 16-byte loads
        for (int v = tid; v < K / E; v += kThreads) {
#pragma unroll
          for (int b = 0; b < BT; ++b) {
            if (r0 + b < B) m[b] = fmaxf(m[b], absmax16(x + (long long)(r0 + b) * K + (long long)v * E));
          }
        }
      } else {
        for (int v = tid; v < K / 4; v += kThreads) {
#pragma unroll
          for (int b = 0; b < BT; ++b) {
            if (r0 + b < B) m[b] = fmaxf(m[b], absmax4(x + (long long)(r0 + b) * K + 4 * v));
          }
        }
      }
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        const float w = warp_max(m[b]);
        if (lane == 0) wmax[warp * 8 + b] = w;
      }
      __syncthreads();
    }
    if (tid < BT) {
      float mx = 0.f;
      if (row_amax != nullptr) {  // given: the whole row's, from the caller
        if (r0 + tid < B) mx = row_amax[r0 + tid];
      } else {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wmax[w * 8 + tid]);
      }
      sxs[tid] = act_scale(mx);
      rsxs[tid] = __frcp_rn(sxs[tid]);
    }
    __syncthreads();
    // the slice quantised, [BT][k_per_cta / 4] words of 4 k, zeros past B
    // and the slice (K % 4 == 0: a word lies wholly inside or outside)
    int* xw = reinterpret_cast<int*>(smem);
    for (int i = tid; i < BT * (k_per_cta / 4); i += kThreads) {
      const int b = i / (k_per_cta / 4), k = 4 * (i % (k_per_cta / 4));
      int w = 0;
      if (r0 + b < B && k < rows) {
        float v[4];
        load4(x + (long long)(r0 + b) * K + k_begin + k, v);
        w = quant4(v, sxs[b], rsxs[b]);
      }
      xw[i] = w;
    }
  }

  template <int BT>
  __device__ __forceinline__ static void step(int (&acc)[BT][kColsPerThread], const uint4* w,
                                              const unsigned char* smem, int k_per_cta, int r) {
    int wc[kColsPerThread];
    regroup(w, wc);
    const int* xw = reinterpret_cast<const int*>(smem) + r / 4;
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      const int xv = xw[b * (k_per_cta / 4)];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) acc[b][j] = __dp4a(wc[j], xv, acc[b][j]);
    }
  }

  __device__ __forceinline__ static float finish(int v, int b, const float* act) {
    return __int2float_rn(v) * act[b];
  }
};

static_assert(s8mma::max_k_per_split(1) == 3008, "ops/int8_matmul.py W8A8_MMA_MAX_K_PER_SPLIT");

// the W8A8 fragment policy of s8_mma.cuh: q's bytes are s8 as stored
struct S8Plane {
  static constexpr int kPlanes = 1, kOffset = 0;
  __device__ __forceinline__ static void planes(unsigned w, unsigned (&p)[1]) { p[0] = w; }
  __device__ __forceinline__ static void mma(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                             unsigned b1) {
    s8mma::mma_s8s8(d, a, b0, b1);
  }
};

// W8A8's s8 tensor-core design: quantise (a block per row), product, and
// the split-K pass
template <typename T>
__global__ void __launch_bounds__(s8mma::kThreads)
w8a8_quant_kernel(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx,
                  int K, int Kp, const float* __restrict__ row_amax) {
  s8mma::quantize_row<T, 1>(x, xq, sx, K, Kp, row_amax);
}

template <typename T>
__global__ void __launch_bounds__(s8mma::kThreads)
w8a8_mma_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                const int8_t* __restrict__ q, const float* __restrict__ scale,
                T* __restrict__ out, int* __restrict__ partial, int B, int K, int Kp, int N,
                int k_per_split) {
  s8mma::product<T, S8Plane>(xq, sx, q, scale, out, partial, B, K, Kp, N, k_per_split);
}

template <typename T>
__global__ void w8a8_reduce(const int* __restrict__ partial, const float* __restrict__ sx,
                            const float* __restrict__ scale, T* __restrict__ out, int splits,
                            int B, int N) {
  s8mma::reduce_splits<T>(partial, sx, scale, out, splits, B, N);
}

template <typename T>
int launch_w8a8_mma(const void* x, const int8_t* q, const float* scale, void* out, int* partial,
                    int8_t* xq, float* sx, int B, int K, int N, int splits, int k_per_split,
                    const float* row_amax, cudaStream_t stream) {
  const int Kp = (K + s8mma::kBK - 1) / s8mma::kBK * s8mma::kBK;
  w8a8_quant_kernel<T><<<B, s8mma::kThreads, 0, stream>>>(static_cast<const T*>(x), xq, sx, K,
                                                          Kp, row_amax);
  const int smem = s8mma::smem_bytes(1, k_per_split);
  const cudaError_t e = cudaFuncSetAttribute(
      w8a8_mma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(N / s8mma::kBN, (B + s8mma::kBM - 1) / s8mma::kBM, splits);
  w8a8_mma_kernel<T><<<grid, s8mma::kThreads, smem, stream>>>(
      xq, sx, q, scale, static_cast<T*>(out), splits > 1 ? partial : nullptr, B, K, Kp, N,
      k_per_split);
  if (splits > 1) {
    const long long total = (long long)B * N;
    w8a8_reduce<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        partial, sx, scale, static_cast<T*>(out), splits, B, N);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- mma

constexpr int kMmaWarps = 4;             // side by side along N
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaTm = 4, kMmaTn = 4;    // mma tiles (16 x 8) per warp: 64 x 32
constexpr int kMmaBM = kMmaTm * 16;      // 64 rows per block
constexpr int kMmaBN = kMmaWarps * kMmaTn * 8;  // 128 columns per block
constexpr int kMmaBK = 128;              // k per step
constexpr int kStages = 3;               // steps in flight
constexpr int kXRow = kMmaBK + 8;        // bf16 per x row of a stage (+16 bytes)
constexpr int kQRow = kMmaBN + 16;       // int8 per q row of a stage (+16 bytes)
constexpr int kXStage = kMmaBM * kXRow * 2, kQStage = kMmaBK * kQRow;  // bytes
constexpr int kMmaSmem = kStages * (kXStage + kQStage);               // 107,520

// One register of ldmatrix.trans over int8 data: bytes q(k, c), q(k, c+1),
// q(k+1, c), q(k+1, c+1). -> the bf16 pair (k, k+1) of column c (`even`)
// and of column c+1 (`odd`), exact: w + 128 into the low byte of 2^23,
// minus 2^23 + 128, and the bf16 is the high half of that float.
__device__ __forceinline__ void int8_pairs_to_bf16(unsigned r, unsigned& even, unsigned& odd) {
  const unsigned u = r ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j)) - 8388736.f;
  even = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[2]), 0x7632);
  odd = __byte_perm(__float_as_uint(f[1]), __float_as_uint(f[3]), 0x7632);
}

__global__ void __launch_bounds__(kMmaThreads)
w8a16_mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int B, int K,
                 int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);          // [kStages][BM][kXRow]
  int8_t* q8 = reinterpret_cast<int8_t*>(smem + kStages * kXStage);     // [kStages][BK][kQRow]
  const int tid = threadIdx.x, lane = tid & 31, wn = (tid >> 5) * kMmaTn * 8;
  const int n0 = blockIdx.x * kMmaBN, r0 = blockIdx.y * kMmaBM;
  const int n_k = (K + kMmaBK - 1) / kMmaBK;

  // step `it` into stage it % kStages, in 16-byte pieces (8 bf16 of x, 16
  // int8 of q); one commit group per step, empty past the last step, so
  // that the group count stays uniform
  auto load_step = [&](int it) {
    if (it < n_k) {
      const int k0 = it * kMmaBK, st = it % kStages;
      for (int i = tid; i < kMmaBM * (kMmaBK / 8); i += kMmaThreads) {
        const int r = i / (kMmaBK / 8), kx = (i % (kMmaBK / 8)) * 8;
        const bool ok = r0 + r < B && k0 + kx < K;
        cp_async16(xs + (st * kMmaBM + r) * kXRow + kx,
                   ok ? x + (long long)(r0 + r) * K + k0 + kx : x, ok);
      }
      for (int i = tid; i < kMmaBK * (kMmaBN / 16); i += kMmaThreads) {
        const int kq = i / (kMmaBN / 16), c = (i % (kMmaBN / 16)) * 16;
        const bool ok = k0 + kq < K && n0 + c < N;
        cp_async16(q8 + (st * kMmaBK + kq) * kQRow + c,
                   ok ? q + (long long)(k0 + kq) * N + n0 + c : q, ok);
      }
    }
    cp_async_commit();
  };

  float acc[kMmaTm][kMmaTn][4];
#pragma unroll
  for (int i = 0; i < kMmaTm; ++i)
#pragma unroll
    for (int j = 0; j < kMmaTn; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) load_step(it);
  for (int it = 0; it < n_k; ++it) {
    const int st = it % kStages;
    cp_async_wait<kStages - 2>();  // step it has landed (this thread's copies)
    __syncthreads();               // everyone's copies; step it - 1 is done
    load_step(it + kStages - 1);   // into the stage that step it - 1 used
    const __nv_bfloat16* xst = xs + st * kMmaBM * kXRow;
    const int8_t* qst = q8 + st * kMmaBK * kQRow;
#pragma unroll
    for (int kk = 0; kk < kMmaBK; kk += 16) {
      unsigned a[kMmaTm][4], r[4], b[kMmaTn][2];
#pragma unroll
      for (int i = 0; i < kMmaTm; ++i)  // rows 16i .. 16i+15, k kk .. kk+15
        ldmatrix_x4(a[i], xst + (16 * i + (lane & 15)) * kXRow + kk + (lane >> 4) * 8);
      // k kk .. kk+15 of the warp's 32 int8 columns, read as 16-bit pairs:
      // r[0], r[1] columns wn .. wn+15 (k and k + 8), r[2], r[3] wn+16 ..
      ldmatrix_x4_trans(r, qst + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kQRow + wn +
                               (lane >> 4) * 16);
      // n-tiles: 0 the even columns of wn .. wn+15, 1 the odd ones, 2 and 3
      // the same of wn+16 .. wn+31
      int8_pairs_to_bf16(r[0], b[0][0], b[1][0]);
      int8_pairs_to_bf16(r[1], b[0][1], b[1][1]);
      int8_pairs_to_bf16(r[2], b[2][0], b[3][0]);
      int8_pairs_to_bf16(r[3], b[2][1], b[3][1]);
#pragma unroll
      for (int i = 0; i < kMmaTm; ++i) {
#pragma unroll
        for (int j = 0; j < kMmaTn; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

  // epilogue: in n-tile pair h (2h even, 2h + 1 odd), lane holds columns
  // wn + 16h + 4*t4 .. +3 of rows gid and gid + 8 of each m-tile: scale,
  // round to bf16, one 8-byte store each
  const int gid = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int h = 0; h < kMmaTn / 2; ++h) {
    const int col = n0 + wn + 16 * h + 4 * t4;
    if (col >= N) continue;
    const float4 sc = *reinterpret_cast<const float4*>(scale + col);
#pragma unroll
    for (int i = 0; i < kMmaTm; ++i) {
      const float* e = acc[i][2 * h];
      const float* o = acc[i][2 * h + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + 16 * i + gid + 8 * half;
        if (row >= B) continue;
        const __nv_bfloat162 lo = __floats2bfloat162_rn(e[2 * half] * sc.x, o[2 * half] * sc.y);
        const __nv_bfloat162 hi =
            __floats2bfloat162_rn(e[2 * half + 1] * sc.z, o[2 * half + 1] * sc.w);
        uint2 v;
        v.x = *reinterpret_cast<const unsigned*>(&lo);
        v.y = *reinterpret_cast<const unsigned*>(&hi);
        *reinterpret_cast<uint2*>(out + (long long)row * N + col) = v;
      }
    }
  }
}

}  // namespace

// W8A16 on the tensor cores: bf16 x [B, K] (K % 8 == 0) @ q [K, N] int8
// (N % 16 == 0) * scale [N] -> bf16 out [B, N]; x, q and scale 16-byte
// aligned.
extern "C" int int8_matmul_w8a16_mma(const void* x, const void* q, const void* scale, void* out,
                                     int B, int K, int N, void* stream) {
  if (B <= 0 || K <= 0 || N <= 0 || K % 8 || N % 16 || (B + kMmaBM - 1) / kMmaBM > 65535 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(scale) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // above 48 KB of shared memory only by asking (per device; cheap to repeat)
  const cudaError_t e = cudaFuncSetAttribute(
      w8a16_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMmaSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + kMmaBN - 1) / kMmaBN, (B + kMmaBM - 1) / kMmaBM);
  w8a16_mma_kernel<<<grid, kMmaThreads, kMmaSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), B, K, N);
  return static_cast<int>(cudaGetLastError());
}

// W8A16 at decode rows (cluster_splitk.cuh). dtype: 0 float32, 1 bfloat16
// (of x and out). q and scale point at the whole stack; `layer` selects
// [layer, :, :]. rows: x rows per CTA (1, 2, 4 or 8); the K rows are
// split over `cluster` CTAs (a power of two, at most 16) of k_per_cta
// rows each (a multiple of 16), none of them empty.
extern "C" int int8_matmul_w8a16(const void* x, const void* q, const void* scale, void* out,
                                 int dtype, int B, int K, int N, int layer, int rows, int cluster,
                                 int k_per_cta, void* stream) {
  if (splitk::bad_shape(1, B, K, N, rows, cluster, k_per_cta) || layer < 0 || dtype < 0 ||
      dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int8_t* ql = static_cast<const int8_t*>(q) + (long long)layer * K * N;
  const float* sl = static_cast<const float*>(scale) + (long long)layer * N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = splitk::launch<Int8Rows>(dtype, rows, x, ql, sl, out, B, K, N,
                                               cluster, k_per_cta, s);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// W8A8 at decode rows (cluster_splitk.cuh): x [B, K] float32 / bfloat16
// (16-byte aligned, K % 4 == 0), quantised per row in the kernel, each
// row's scale from its own max|x| or, where row_amax ([B] float32) is
// given, from row_amax[b]; the other arguments as int8_matmul_w8a16's.
extern "C" int int8_matmul_w8a8(const void* x, const void* q, const void* scale, void* out,
                                int dtype, int B, int K, int N, int layer, int rows, int cluster,
                                int k_per_cta, const void* row_amax, void* stream) {
  if (splitk::bad_shape(1, B, K, N, rows, cluster, k_per_cta, 1) || K % 4 || layer < 0 ||
      dtype < 0 || dtype > 1 || reinterpret_cast<uintptr_t>(x) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int8_t* ql = static_cast<const int8_t*>(q) + (long long)layer * K * N;
  const float* sl = static_cast<const float*>(scale) + (long long)layer * N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = splitk::launch<W8A8Rows>(dtype, rows, x, ql, sl, out, B, K, N, cluster,
                                                 k_per_cta, s,
                                                 static_cast<const float*>(row_amax));
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// W8A8 on the s8 tensor cores: x and row_amax as above, N % 128 == 0, K split into
// `splits` ranges of k_per_split rows (a multiple of 64, at most
// max_k_per_split(1) = 3008);
// xq scratch of B * Kp bytes (Kp = K rounded up to 64) and sx of B float32
// always, partial of splits * B * N int32 when splits > 1; x, q (at the
// layer) and xq 16-byte aligned.
extern "C" int int8_matmul_w8a8_mma(const void* x, const void* q, const void* scale, void* out,
                                    void* partial, void* xq, void* sx, int dtype, int B, int K,
                                    int N, int layer, int splits, int k_per_split,
                                    const void* row_amax, void* stream) {
  const int8_t* ql = static_cast<const int8_t*>(q) + (long long)layer * K * N;
  const float* sl = static_cast<const float*>(scale) + (long long)layer * N;
  if (B <= 0 || K <= 0 || K % 4 || N <= 0 || N % s8mma::kBN || layer < 0 || dtype < 0 ||
      dtype > 1 || (B + s8mma::kBM - 1) / s8mma::kBM > 65535 || splits < 1 || splits > 65535 ||
      k_per_split <= 0 || k_per_split % s8mma::kBK ||
      k_per_split > s8mma::max_k_per_split(1) || (long long)splits * k_per_split < K ||
      (long long)(splits - 1) * k_per_split >= K || (splits > 1 && partial == nullptr) ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(ql) % 16 ||
      reinterpret_cast<uintptr_t>(xq) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* pt = static_cast<int*>(partial);
  int8_t* xb = static_cast<int8_t*>(xq);
  float* sxf = static_cast<float*>(sx);
  const float* am = static_cast<const float*>(row_amax);
  return dtype == 0 ? launch_w8a8_mma<float>(x, ql, sl, out, pt, xb, sxf, B, K, N, splits,
                                             k_per_split, am, s)
                    : launch_w8a8_mma<__nv_bfloat16>(x, ql, sl, out, pt, xb, sxf, B, K, N, splits,
                                                     k_per_split, am, s);
}
