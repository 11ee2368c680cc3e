// Int4-weight matrix products of the int4 decode-projection sweep.
//
// Replaces the TPU kernels of sonicscribe_tpu/ops/int4_pallas.py:
// `_kernel_w4a16` (entry `int4_matmul`), `_stacked_kernel_w4a16`
// (`int4_matmul_stacked`), `_kernel_w4a8` (`int4_matmul_w4a8`) and
// `_stacked_kernel_w4a8` (`int4_matmul_w4a8_stacked`):
//
//   W4A16: out[b, n] = (sum_k<K/2 x[b, k] * lo[k, n]
//                       + x[b, K/2 + k] * hi[k, n] in float32) * scale[n]
//   W4A8:  out[b, n] = float32(sum_k<K/2 xq[b, k] * lo[k, n]
//                              + xq[b, K/2 + k] * hi[k, n] in int32)
//                      * sx[b] * scale[n]
//
// cast to x's type (float32 or bfloat16). packed is one layer of a stack
// [L, K/2, N] int8 in the JAX layout (N contiguous): the low nibble of
// packed[k, n] is weight row k, the high nibble row k + K/2, both
// sign-extended (lo and hi above). The layer is read by offset from the
// whole stack, so no slice is ever copied.
//
// What bounds it on an H100: at decode (B of 1 to 64 rows) bytes. The
// weight is K/2 * N bytes and each byte feeds 4 * B operations, far below
// the card's ridge, so the design streams packed once:
// - a block owns 128 columns; each thread reads 16 of them in one 16-byte
//   load per packed row, and its 32 k-lanes walk the block's packed rows in
//   an interleaved order so that a warp reads whole 128-byte lines;
// - one packed row gives two k rows of the same 16 columns, so the x values
//   of both halves of a chunk (k and K/2 + k) are staged in shared memory;
// - where the column tiles alone give too few blocks to fill the 132 SMs,
//   the K/2 packed rows are split over blocks (grid.z); each block writes
//   its partial sums and a second pass adds the splits in order, applies
//   the scale and casts (no atomics: the result is deterministic);
// - W4A16 sign-extends each nibble with one shift pair on the 32-bit word
//   and sums in float32 (bf16 * a code in [-8, 7] is exact in float32);
//   W4A8 regroups four packed rows per column with __byte_perm, splits each
//   word into two words of 4 signed bytes (low nibbles: rows k..k+3; high
//   nibbles: rows K/2+k..K/2+k+3) with one __vsub4 each, and runs two
//   __dp4a against the staged activation words of each half.
// The products run on the CUDA cores: right, and at B > 8 far from the
// tensor cores' rate (mma/wgmma is later work).
//
// Layout: x [B, K] (float32 / bfloat16, contiguous), xq [B, K] int8 and
// sx [B] float32 for W4A8, packed [L, K/2, N] int8 and scale [L, 1, N]
// float32 (contiguous), out [B, N] in x's type, partial [splits, B, N]
// float32 / int32 scratch when splits > 1. N must be a multiple of 16 (the
// wrapper holds it to the JAX gate's 128); W4A8 needs K/2 % 4 == 0. The
// wrapper (ops/int4_matmul.py) checks and picks the launch shape; each
// entry returns the cudaError of its launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColsPerThread = 16;                     // one 16-byte load of packed
constexpr int kColThreads = 8;
constexpr int kTileN = kColThreads * kColsPerThread;  // 128 columns per block
constexpr int kKLanes = kThreads / kColThreads;        // 32
constexpr int kChunkK = 128;                           // packed rows staged per pass
constexpr int kRowsPerLane = kChunkK / kKLanes;        // 4

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint4 load16(const int8_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// nibble `i` (0..7, from the least significant) of w, sign-extended
__device__ __forceinline__ float nibble(unsigned w, int i) {
  return static_cast<float>(static_cast<int>(w << (28 - 4 * i)) >> 28);
}

// packed rows k..k+3 of 16 columns -> per column one word of its 4 packed bytes
__device__ __forceinline__ void regroup(const uint4 (&r)[4], unsigned (&c)[kColsPerThread]) {
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
    c[4 * i + 0] = __byte_perm(ab_lo, cd_lo, 0x5410);  // a0 b0 c0 d0
    c[4 * i + 1] = __byte_perm(ab_lo, cd_lo, 0x7632);  // a1 b1 c1 d1
    c[4 * i + 2] = __byte_perm(ab_hi, cd_hi, 0x5410);
    c[4 * i + 3] = __byte_perm(ab_hi, cd_hi, 0x7632);
  }
}

// 4 packed bytes -> 4 signed bytes of their low (high) nibbles: (n ^ 8) - 8
__device__ __forceinline__ int low_nibbles(unsigned w) {
  return static_cast<int>(__vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u));
}
__device__ __forceinline__ int high_nibbles(unsigned w) { return low_nibbles(w >> 4); }

template <typename Acc>
__device__ __forceinline__ Acc lane_sum(Acc v) {
  // the 4 k-lanes of a warp: lanes 8 and 16 apart hold the same columns
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// Reduce the block's k-lanes and hand each (row, column) sum to `emit`.
template <typename Acc, int BT, typename Emit>
__device__ __forceinline__ void block_reduce(Acc (&acc)[BT][kColsPerThread],
                                             Acc (&red)[kWarps][BT][kTileN], int B, int N,
                                             int r0, int n0, Emit emit) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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
    Acc v = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w][b][c];
    emit(r, n, v);
  }
}

template <typename T, int BT>
__global__ void __launch_bounds__(kThreads)
w4a16_kernel(const T* __restrict__ x, const int8_t* __restrict__ p,
             const float* __restrict__ scale, T* __restrict__ out,
             float* __restrict__ partial, int B, int K2, int N, int k_per_split) {
  __shared__ float xs[2][BT][kChunkK];  // x[r, c0 + kk] and x[r, K/2 + c0 + kk]
  __shared__ float red[kWarps][BT][kTileN];
  const int tid = threadIdx.x, ct = tid % kColThreads, kl = tid / kColThreads;
  const int n0 = blockIdx.x * kTileN, r0 = blockIdx.y * BT, split = blockIdx.z;
  const int col = n0 + ct * kColsPerThread;
  const long long K = 2LL * K2;
  const int k_begin = split * k_per_split, k_end = min(K2, k_begin + k_per_split);

  float acc[BT][kColsPerThread];
#pragma unroll
  for (int b = 0; b < BT; ++b) {
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[b][j] = 0.f;
  }

  for (int c0 = k_begin; c0 < k_end; c0 += kChunkK) {
    __syncthreads();  // the previous chunk's reads of xs are done
    for (int i = tid; i < 2 * BT * kChunkK; i += kThreads) {
      const int h = i / (BT * kChunkK), b = (i / kChunkK) % BT, kk = i % kChunkK;
      const int r = r0 + b, k = c0 + kk;
      xs[h][b][kk] = (r < B && k < k_end) ? to_f32(x[r * K + (long long)h * K2 + k]) : 0.f;
    }
    __syncthreads();
    if (col < N) {
      uint4 w[kRowsPerLane];
#pragma unroll
      for (int i = 0; i < kRowsPerLane; ++i) {
        const int k = c0 + kl + i * kKLanes;
        w[i] = k < k_end ? load16(p + (long long)k * N + col) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int i = 0; i < kRowsPerLane; ++i) {
        const int kk = kl + i * kKLanes;
        float xl[BT], xh[BT];
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          xl[b] = xs[0][b][kk];
          xh[b] = xs[1][b][kk];
        }
        const unsigned words[4] = {w[i].x, w[i].y, w[i].z, w[i].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float lo = nibble(words[q], 2 * j), hi = nibble(words[q], 2 * j + 1);
#pragma unroll
            for (int b = 0; b < BT; ++b) {
              acc[b][4 * q + j] = fmaf(xh[b], hi, fmaf(xl[b], lo, acc[b][4 * q + j]));
            }
          }
        }
      }
    }
  }

  block_reduce<float, BT>(acc, red, B, N, r0, n0, [&](int r, int n, float v) {
    if (partial) {
      partial[((long long)split * B + r) * N + n] = v;
    } else {
      store(out + (long long)r * N + n, v * scale[n]);
    }
  });
}

template <typename T, int BT>
__global__ void __launch_bounds__(kThreads)
w4a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
            const int8_t* __restrict__ p, const float* __restrict__ scale,
            T* __restrict__ out, int* __restrict__ partial, int B, int K2, int N,
            int k_per_split) {
  // 4 consecutive k of one row per word: xq[r, c0 + 4g..] and xq[r, K/2 + c0 + 4g..]
  __shared__ int xs[2][BT][kChunkK / 4];
  __shared__ int red[kWarps][BT][kTileN];
  const int tid = threadIdx.x, ct = tid % kColThreads, kl = tid / kColThreads;
  const int n0 = blockIdx.x * kTileN, r0 = blockIdx.y * BT, split = blockIdx.z;
  const int col = n0 + ct * kColsPerThread;
  const long long K = 2LL * K2;
  const int k_begin = split * k_per_split, k_end = min(K2, k_begin + k_per_split);
  const int* x32 = reinterpret_cast<const int*>(xq);

  int acc[BT][kColsPerThread];
#pragma unroll
  for (int b = 0; b < BT; ++b) {
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[b][j] = 0;
  }

  for (int c0 = k_begin; c0 < k_end; c0 += kChunkK) {
    __syncthreads();
    for (int i = tid; i < 2 * BT * (kChunkK / 4); i += kThreads) {
      const int h = i / (BT * (kChunkK / 4)), b = (i / (kChunkK / 4)) % BT, g = i % (kChunkK / 4);
      const int r = r0 + b, k = c0 + 4 * g;
      xs[h][b][g] = (r < B && k < k_end) ? x32[(r * K + (long long)h * K2 + k) / 4] : 0;
    }
    __syncthreads();
    const int k = c0 + 4 * kl;  // this lane's 4 packed rows of the chunk
    if (col < N && k < k_end) {  // K/2 % 4 == 0: rows k..k+3 all lie below k_end
      uint4 rows[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) rows[i] = load16(p + (long long)(k + i) * N + col);
      unsigned wc[kColsPerThread];
      regroup(rows, wc);
      int xl[BT], xh[BT];
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        xl[b] = xs[0][b][kl];
        xh[b] = xs[1][b][kl];
      }
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int lo = low_nibbles(wc[j]), hi = high_nibbles(wc[j]);
#pragma unroll
        for (int b = 0; b < BT; ++b) acc[b][j] = __dp4a(hi, xh[b], __dp4a(lo, xl[b], acc[b][j]));
      }
    }
  }

  block_reduce<int, BT>(acc, red, B, N, r0, n0, [&](int r, int n, int v) {
    if (partial) {
      partial[((long long)split * B + r) * N + n] = v;
    } else {
      store(out + (long long)r * N + n, __int2float_rn(v) * sx[r] * scale[n]);
    }
  });
}

// Second pass of a split-K launch: add the splits in order, scale, cast.
template <typename T>
__global__ void w4a16_reduce(const float* __restrict__ partial, const float* __restrict__ scale,
                             T* __restrict__ out, int splits, int B, int N) {
  const long long total = (long long)B * N;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += partial[s * total + i];
  store(out + i, v * scale[i % N]);
}

template <typename T>
__global__ void w4a8_reduce(const int* __restrict__ partial, const float* __restrict__ sx,
                            const float* __restrict__ scale, T* __restrict__ out, int splits,
                            int B, int N) {
  const long long total = (long long)B * N;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  int v = 0;
  for (int s = 0; s < splits; ++s) v += partial[s * total + i];
  store(out + i, __int2float_rn(v) * sx[i / N] * scale[i % N]);
}

bool bad_shape(int B, int K2, int N, int layer, int rows, int splits, int k_per_split) {
  if (B <= 0 || K2 <= 0 || N <= 0 || layer < 0 || N % kColsPerThread) return true;
  if (rows != 1 && rows != 4 && rows != 8) return true;
  if (splits < 1 || k_per_split <= 0 || k_per_split % kChunkK) return true;
  if ((long long)splits * k_per_split < K2 || (long long)(splits - 1) * k_per_split >= K2) return true;
  return (B + rows - 1) / rows > 65535 || splits > 65535;
}

template <typename T, int BT>
void launch_w4a16(const void* x, const int8_t* p, const float* scale, void* out, float* partial,
                  int B, int K2, int N, int splits, int k_per_split, cudaStream_t stream) {
  const dim3 grid((N + kTileN - 1) / kTileN, (B + BT - 1) / BT, splits);
  w4a16_kernel<T, BT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), p, scale, static_cast<T*>(out), splits > 1 ? partial : nullptr,
      B, K2, N, k_per_split);
  if (splits > 1) {
    const long long total = (long long)B * N;
    w4a16_reduce<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        partial, scale, static_cast<T*>(out), splits, B, N);
  }
}

template <typename T, int BT>
void launch_w4a8(const int8_t* xq, const float* sx, const int8_t* p, const float* scale, void* out,
                 int* partial, int B, int K2, int N, int splits, int k_per_split,
                 cudaStream_t stream) {
  const dim3 grid((N + kTileN - 1) / kTileN, (B + BT - 1) / BT, splits);
  w4a8_kernel<T, BT><<<grid, kThreads, 0, stream>>>(
      xq, sx, p, scale, static_cast<T*>(out), splits > 1 ? partial : nullptr, B, K2, N,
      k_per_split);
  if (splits > 1) {
    const long long total = (long long)B * N;
    w4a8_reduce<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        partial, sx, scale, static_cast<T*>(out), splits, B, N);
  }
}

template <typename T>
void dispatch_w4a16(int rows, const void* x, const int8_t* p, const float* scale, void* out,
                    float* partial, int B, int K2, int N, int splits, int k_per_split,
                    cudaStream_t s) {
  switch (rows) {
    case 1: launch_w4a16<T, 1>(x, p, scale, out, partial, B, K2, N, splits, k_per_split, s); break;
    case 4: launch_w4a16<T, 4>(x, p, scale, out, partial, B, K2, N, splits, k_per_split, s); break;
    default: launch_w4a16<T, 8>(x, p, scale, out, partial, B, K2, N, splits, k_per_split, s);
  }
}

template <typename T>
void dispatch_w4a8(int rows, const int8_t* xq, const float* sx, const int8_t* p,
                   const float* scale, void* out, int* partial, int B, int K2, int N, int splits,
                   int k_per_split, cudaStream_t s) {
  switch (rows) {
    case 1: launch_w4a8<T, 1>(xq, sx, p, scale, out, partial, B, K2, N, splits, k_per_split, s); break;
    case 4: launch_w4a8<T, 4>(xq, sx, p, scale, out, partial, B, K2, N, splits, k_per_split, s); break;
    default: launch_w4a8<T, 8>(xq, sx, p, scale, out, partial, B, K2, N, splits, k_per_split, s);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (of x and out). packed and scale point at
// the whole stack; `layer` selects [layer, :, :]. K2 is the packed row
// count K/2 (x has 2 * K2 columns). rows: x rows per block (1, 4 or 8; a
// 2-row tile of the W4A16 kernel spilled registers).
// The K2 packed rows are split into `splits` ranges of k_per_split rows (a
// multiple of 128); partial holds splits * B * N float32 when splits > 1.
extern "C" int int4_matmul_w4a16(const void* x, const void* packed, const void* scale, void* out,
                                 void* partial, int dtype, int B, int K2, int N, int layer,
                                 int rows, int splits, int k_per_split, void* stream) {
  if (bad_shape(B, K2, N, layer, rows, splits, k_per_split) || dtype < 0 || dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int8_t* pl = static_cast<const int8_t*>(packed) + (long long)layer * K2 * N;
  const float* sl = static_cast<const float*>(scale) + (long long)layer * N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(partial);
  if (dtype == 0) {
    dispatch_w4a16<float>(rows, x, pl, sl, out, pt, B, K2, N, splits, k_per_split, s);
  } else {
    dispatch_w4a16<__nv_bfloat16>(rows, x, pl, sl, out, pt, B, K2, N, splits, k_per_split, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// As int4_matmul_w4a16 with int8 activations xq [B, 2 * K2] and their
// per-row scales sx [B]; K2 % 4 == 0; partial holds int32 sums.
extern "C" int int4_matmul_w4a8(const void* xq, const void* sx, const void* packed,
                                const void* scale, void* out, void* partial, int dtype, int B,
                                int K2, int N, int layer, int rows, int splits, int k_per_split,
                                void* stream) {
  if (bad_shape(B, K2, N, layer, rows, splits, k_per_split) || K2 % 4 || dtype < 0 || dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int8_t* pl = static_cast<const int8_t*>(packed) + (long long)layer * K2 * N;
  const float* sl = static_cast<const float*>(scale) + (long long)layer * N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* x = static_cast<const int8_t*>(xq);
  const float* sxf = static_cast<const float*>(sx);
  int* pt = static_cast<int*>(partial);
  if (dtype == 0) {
    dispatch_w4a8<float>(rows, x, sxf, pl, sl, out, pt, B, K2, N, splits, k_per_split, s);
  } else {
    dispatch_w4a8<__nv_bfloat16>(rows, x, sxf, pl, sl, out, pt, B, K2, N, splits, k_per_split, s);
  }
  return static_cast<int>(cudaGetLastError());
}
