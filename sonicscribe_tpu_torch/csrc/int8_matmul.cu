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
// IEEE division for sx), so a call launches only this file's kernels. It
// streams q on the CUDA cores, fused: each block takes its rows' max|x|
// over the whole K, then quantises x as it stages a 128-row chunk in
// shared memory; a block owns 128 columns, each thread reads 16 of them in
// 16-byte loads of 4 consecutive rows, regrouped with __byte_perm into
// words of 4 k per column for __dp4a (int32 sums, exact, so the output
// equals the plain version's bits); k-lanes are reduced with warp shuffles
// and one shared-memory pass. Where the column tiles alone give too few
// blocks to fill the 132 SMs, K is split over blocks (grid.z); each block
// writes its int32 partial sums and a second pass adds the splits in
// order, reading sx from scratch, applies the scales and casts.
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
// scale [L, 1, N] float32 (contiguous), out [B, N] in x's type; for W8A8
// partial [splits, B, N] int32 and sx [B] float32 scratch when splits > 1.
// N must be a multiple of 16; W8A8 needs K % 4 == 0 and 16-byte aligned x;
// the mma entry needs bf16 x with K % 8 == 0 and 16-byte aligned x and
// scale (16-byte copies and loads). The wrapper (ops/int8_matmul.py)
// checks and picks the design and the launch shape; each entry returns the
// cudaError of its launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "act_quant.cuh"
#include "cluster_splitk.cuh"
#include "common.cuh"

namespace {

using splitk::kColsPerThread;
using splitk::kColThreads;
using splitk::kKLanes;
using splitk::kThreads;
using splitk::kTileN;
using splitk::kWarps;
constexpr int kChunkK = 128;  // W8A8: k rows staged per pass

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
struct Int8Rows {
  static constexpr int kHalves = 1;
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
__device__ __forceinline__ void regroup(const uint4 (&r)[4], int (&c)[kColsPerThread]) {
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

template <typename T, int BT>
__global__ void __launch_bounds__(kThreads)
w8a8_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
            const float* __restrict__ scale, T* __restrict__ out, int* __restrict__ partial,
            float* __restrict__ sx_out, int B, int K, int N, int k_per_split) {
  __shared__ int xs[BT][kChunkK / 4];  // 4 consecutive k of one row per word
  __shared__ int red[kWarps][BT][kTileN];
  __shared__ float wmax[kWarps][BT];
  __shared__ float sxs[BT], rsxs[BT];  // the rows' scales and their rounded reciprocals
  const int tid = threadIdx.x, ct = tid % kColThreads, kl = tid / kColThreads;
  const int lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kTileN, r0 = blockIdx.y * BT, split = blockIdx.z;
  const int col = n0 + ct * kColsPerThread;
  const int k_begin = split * k_per_split, k_end = min(K, k_begin + k_per_split);

  // the rows' scales, over the whole K (4 values a load, all rows at once)
  float m[BT];
#pragma unroll
  for (int b = 0; b < BT; ++b) m[b] = 0.f;
  for (int v = tid; v < K / 4; v += kThreads) {
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      if (r0 + b < B) m[b] = fmaxf(m[b], absmax4(x + (long long)(r0 + b) * K + 4 * v));
    }
  }
#pragma unroll
  for (int b = 0; b < BT; ++b) {
    const float w = warp_max(m[b]);
    if (lane == 0) wmax[warp][b] = w;
  }
  __syncthreads();
  if (tid < BT) {
    float mx = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wmax[w][tid]);
    sxs[tid] = act_scale(mx);
    rsxs[tid] = __frcp_rn(sxs[tid]);
    // the split-K pass reads the scales here
    if (sx_out && blockIdx.x == 0 && split == 0 && r0 + tid < B) sx_out[r0 + tid] = sxs[tid];
  }

  int acc[BT][kColsPerThread];
#pragma unroll
  for (int b = 0; b < BT; ++b) {
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[b][j] = 0;
  }

  for (int c0 = k_begin; c0 < k_end; c0 += kChunkK) {
    __syncthreads();  // the scales are set; the previous chunk's reads of xs are done
    for (int i = tid; i < BT * (kChunkK / 4); i += kThreads) {
      const int b = i / (kChunkK / 4), g = i % (kChunkK / 4);
      const int r = r0 + b, k = c0 + 4 * g;
      int w = 0;
      if (r < B && k < k_end) {  // K % 4 == 0: k..k+3 all lie below k_end
        float v[4];
        load4(x + (long long)r * K + k, v);
        w = quant4(v, sxs[b], rsxs[b]);
      }
      xs[b][g] = w;
    }
    __syncthreads();
    const int k = c0 + 4 * kl;  // this lane's 4 rows of the chunk
    if (col < N && k < k_end) {
      uint4 rows[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) rows[i] = load16(q + (long long)(k + i) * N + col);
      int wc[kColsPerThread];
      regroup(rows, wc);
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        const int xv = xs[b][kl];
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) acc[b][j] = __dp4a(wc[j], xv, acc[b][j]);
      }
    }
  }

  // k-lanes by shuffles, warps through shared memory
#pragma unroll
  for (int b = 0; b < BT; ++b) {
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[b][j] = lane_sum(acc[b][j]);
  }
  if (lane < kColThreads) {
#pragma unroll
    for (int b = 0; b < BT; ++b) {
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) red[warp][b][lane * kColsPerThread + j] = acc[b][j];
    }
  }
  __syncthreads();
  for (int i = tid; i < BT * kTileN; i += kThreads) {
    const int b = i / kTileN, c = i % kTileN;
    const int r = r0 + b, n = n0 + c;
    if (r >= B || n >= N) continue;
    int v = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w][b][c];
    if (partial) {
      partial[((long long)split * B + r) * N + n] = v;
    } else {
      store(out + (long long)r * N + n, __int2float_rn(v) * sxs[b] * scale[n]);
    }
  }
}

// Second pass of a split-K W8A8 launch: add the splits in order, scale, cast.
template <typename T>
__global__ void w8a8_reduce(const int* __restrict__ partial, const float* __restrict__ sx,
                            const float* __restrict__ scale, T* __restrict__ out, int splits,
                            int B, int N) {
  const long long total = (long long)B * N;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  int v = 0;
  for (int s = 0; s < splits; ++s) v += partial[s * total + i];
  store(out + i, __int2float_rn(v) * sx[i / N] * scale[i % N]);
}

template <typename T, int BT>
void launch_w8a8(const void* x, const int8_t* q, const float* scale, void* out, int* partial,
                 float* sx, int B, int K, int N, int splits, int k_per_split,
                 cudaStream_t stream) {
  const dim3 grid((N + kTileN - 1) / kTileN, (B + BT - 1) / BT, splits);
  w8a8_kernel<T, BT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), q, scale, static_cast<T*>(out), splits > 1 ? partial : nullptr,
      splits > 1 ? sx : nullptr, B, K, N, k_per_split);
  if (splits > 1) {
    const long long total = (long long)B * N;
    w8a8_reduce<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        partial, sx, scale, static_cast<T*>(out), splits, B, N);
  }
}

template <typename T>
void dispatch_w8a8(int rows, const void* x, const int8_t* q, const float* scale, void* out,
                   int* partial, float* sx, int B, int K, int N, int splits, int k_per_split,
                   cudaStream_t s) {
  switch (rows) {
    case 1: launch_w8a8<T, 1>(x, q, scale, out, partial, sx, B, K, N, splits, k_per_split, s); break;
    case 2: launch_w8a8<T, 2>(x, q, scale, out, partial, sx, B, K, N, splits, k_per_split, s); break;
    case 4: launch_w8a8<T, 4>(x, q, scale, out, partial, sx, B, K, N, splits, k_per_split, s); break;
    default: launch_w8a8<T, 8>(x, q, scale, out, partial, sx, B, K, N, splits, k_per_split, s);
  }
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

// W8A8: x [B, K] float32 / bfloat16 (16-byte aligned, K % 4 == 0),
// quantised per row in the kernel; other arguments as the streaming
// W8A16 launch had them: rows 1, 2, 4 or 8, K split into `splits` ranges
// of k_per_split rows (a multiple of 128); partial holds splits * B * N
// int32 sums and sx B float32 scales when splits > 1.
extern "C" int int8_matmul_w8a8(const void* x, const void* q, const void* scale, void* out,
                                void* partial, void* sx, int dtype, int B, int K, int N,
                                int layer, int rows, int splits, int k_per_split, void* stream) {
  if (B <= 0 || K <= 0 || N <= 0 || layer < 0 || N % kColsPerThread || K % 4 || dtype < 0 ||
      dtype > 1 || (rows != 1 && rows != 2 && rows != 4 && rows != 8) || splits < 1 ||
      k_per_split <= 0 || k_per_split % kChunkK || (long long)splits * k_per_split < K ||
      (long long)(splits - 1) * k_per_split >= K || (B + rows - 1) / rows > 65535 ||
      splits > 65535 || reinterpret_cast<uintptr_t>(x) % 16 ||
      (splits > 1 && (partial == nullptr || sx == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int8_t* ql = static_cast<const int8_t*>(q) + (long long)layer * K * N;
  const float* sl = static_cast<const float*>(scale) + (long long)layer * N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* p = static_cast<int*>(partial);
  float* sxf = static_cast<float*>(sx);
  if (dtype == 0) {
    dispatch_w8a8<float>(rows, x, ql, sl, out, p, sxf, B, K, N, splits, k_per_split, s);
  } else {
    dispatch_w8a8<__nv_bfloat16>(rows, x, ql, sl, out, p, sxf, B, K, N, splits, k_per_split, s);
  }
  return static_cast<int>(cudaGetLastError());
}
