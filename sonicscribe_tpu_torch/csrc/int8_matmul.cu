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
// card's ridge, so the design streams q once at the memory rate:
// - a block owns 128 columns; each thread reads 16 of them in one 16-byte
//   load per k row, and its 32 k-lanes walk the block's rows in an
//   interleaved order so that a warp reads whole 128-byte lines;
// - where the column tiles alone give too few blocks to fill the 132 SMs
//   (qkv's N = 3072 gives 24), K is split over blocks (grid.z); each block
//   writes its partial sums and a second pass adds the splits in order,
//   applies the scale and casts (no atomics: the result is deterministic);
// - the x rows of a 128-row chunk are staged in shared memory, and float32
//   sums (W8A16: bf16 * int8 is exact in float32) or int32 sums (W8A8,
//   __dp4a over 4 consecutive k regrouped from four 16-byte row loads with
//   __byte_perm) stay in registers; k-lanes are reduced with warp shuffles
//   and one shared-memory pass, and the scale is applied in the epilogue.
// At prefill and in the encoder (B of hundreds to 1536 rows) the same loop
// walks row tiles of 8 (grid.y) and the products run on the CUDA cores:
// right, and far from the tensor cores' rate (mma/wgmma is later work).
//
// Layout: x [B, K] (float32 / bfloat16, contiguous), xq [B, K] int8 and
// sx [B] float32 for W8A8, q [L, K, N] int8 and scale [L, 1, N] float32
// (contiguous), out [B, N] in x's type, partial [splits, B, N] float32 /
// int32 scratch when splits > 1. N must be a multiple of 16; W8A8 needs
// K % 4 == 0. The wrapper (ops/int8_matmul.py) checks and picks the
// launch shape; each entry returns the cudaError of its launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColsPerThread = 16;                     // one 16-byte load of q
constexpr int kColThreads = 8;
constexpr int kTileN = kColThreads * kColsPerThread;  // 128 columns per block
constexpr int kKLanes = kThreads / kColThreads;        // 32
constexpr int kChunkK = 128;                           // k rows staged per pass
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
w8a16_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
             const float* __restrict__ scale, T* __restrict__ out,
             float* __restrict__ partial, int B, int K, int N, int k_per_split) {
  __shared__ float xs[BT][kChunkK];
  __shared__ float red[kWarps][BT][kTileN];
  const int tid = threadIdx.x, ct = tid % kColThreads, kl = tid / kColThreads;
  const int n0 = blockIdx.x * kTileN, r0 = blockIdx.y * BT, split = blockIdx.z;
  const int col = n0 + ct * kColsPerThread;
  const int k_begin = split * k_per_split, k_end = min(K, k_begin + k_per_split);

  float acc[BT][kColsPerThread];
#pragma unroll
  for (int b = 0; b < BT; ++b) {
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[b][j] = 0.f;
  }

  for (int c0 = k_begin; c0 < k_end; c0 += kChunkK) {
    __syncthreads();  // the previous chunk's reads of xs are done
    for (int i = tid; i < BT * kChunkK; i += kThreads) {
      const int b = i / kChunkK, kk = i % kChunkK;
      const int r = r0 + b, k = c0 + kk;
      xs[b][kk] = (r < B && k < k_end) ? to_f32(x[(long long)r * K + k]) : 0.f;
    }
    __syncthreads();
    if (col < N) {
      uint4 w[kRowsPerLane];
#pragma unroll
      for (int i = 0; i < kRowsPerLane; ++i) {
        const int k = c0 + kl + i * kKLanes;
        w[i] = k < k_end ? load16(q + (long long)k * N + col) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int i = 0; i < kRowsPerLane; ++i) {
        float wf[kColsPerThread];
        unpack(w[i], wf);
        const int kk = kl + i * kKLanes;
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          const float xv = xs[b][kk];
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j) acc[b][j] = fmaf(xv, wf[j], acc[b][j]);
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
w8a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
            const int8_t* __restrict__ q, const float* __restrict__ scale,
            T* __restrict__ out, int* __restrict__ partial, int B, int K, int N,
            int k_per_split) {
  __shared__ int xs[BT][kChunkK / 4];  // 4 consecutive k of one row per word
  __shared__ int red[kWarps][BT][kTileN];
  const int tid = threadIdx.x, ct = tid % kColThreads, kl = tid / kColThreads;
  const int n0 = blockIdx.x * kTileN, r0 = blockIdx.y * BT, split = blockIdx.z;
  const int col = n0 + ct * kColsPerThread;
  const int k_begin = split * k_per_split, k_end = min(K, k_begin + k_per_split);
  const int* x32 = reinterpret_cast<const int*>(xq);

  int acc[BT][kColsPerThread];
#pragma unroll
  for (int b = 0; b < BT; ++b) {
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[b][j] = 0;
  }

  for (int c0 = k_begin; c0 < k_end; c0 += kChunkK) {
    __syncthreads();
    for (int i = tid; i < BT * (kChunkK / 4); i += kThreads) {
      const int b = i / (kChunkK / 4), g = i % (kChunkK / 4);
      const int r = r0 + b, k = c0 + 4 * g;
      xs[b][g] = (r < B && k < k_end) ? x32[((long long)r * K + k) / 4] : 0;
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
__global__ void w8a16_reduce(const float* __restrict__ partial, const float* __restrict__ scale,
                             T* __restrict__ out, int splits, int B, int N) {
  const long long total = (long long)B * N;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += partial[s * total + i];
  store(out + i, v * scale[i % N]);
}

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

bool bad_shape(int B, int K, int N, int layer, int rows, int splits, int k_per_split) {
  if (B <= 0 || K <= 0 || N <= 0 || layer < 0 || N % kColsPerThread) return true;
  if (rows != 1 && rows != 2 && rows != 4 && rows != 8) return true;
  if (splits < 1 || k_per_split <= 0 || k_per_split % kChunkK) return true;
  if ((long long)splits * k_per_split < K || (long long)(splits - 1) * k_per_split >= K) return true;
  return (B + rows - 1) / rows > 65535 || splits > 65535;
}

template <typename T, int BT>
void launch_w8a16(const void* x, const int8_t* q, const float* scale, void* out, float* partial,
                  int B, int K, int N, int splits, int k_per_split, cudaStream_t stream) {
  const dim3 grid((N + kTileN - 1) / kTileN, (B + BT - 1) / BT, splits);
  w8a16_kernel<T, BT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), q, scale, static_cast<T*>(out), splits > 1 ? partial : nullptr,
      B, K, N, k_per_split);
  if (splits > 1) {
    const long long total = (long long)B * N;
    w8a16_reduce<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        partial, scale, static_cast<T*>(out), splits, B, N);
  }
}

template <typename T, int BT>
void launch_w8a8(const int8_t* xq, const float* sx, const int8_t* q, const float* scale, void* out,
                 int* partial, int B, int K, int N, int splits, int k_per_split,
                 cudaStream_t stream) {
  const dim3 grid((N + kTileN - 1) / kTileN, (B + BT - 1) / BT, splits);
  w8a8_kernel<T, BT><<<grid, kThreads, 0, stream>>>(
      xq, sx, q, scale, static_cast<T*>(out), splits > 1 ? partial : nullptr, B, K, N,
      k_per_split);
  if (splits > 1) {
    const long long total = (long long)B * N;
    w8a8_reduce<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        partial, sx, scale, static_cast<T*>(out), splits, B, N);
  }
}

template <typename T>
void dispatch_w8a16(int rows, const void* x, const int8_t* q, const float* scale, void* out,
                    float* partial, int B, int K, int N, int splits, int k_per_split,
                    cudaStream_t s) {
  switch (rows) {
    case 1: launch_w8a16<T, 1>(x, q, scale, out, partial, B, K, N, splits, k_per_split, s); break;
    case 2: launch_w8a16<T, 2>(x, q, scale, out, partial, B, K, N, splits, k_per_split, s); break;
    case 4: launch_w8a16<T, 4>(x, q, scale, out, partial, B, K, N, splits, k_per_split, s); break;
    default: launch_w8a16<T, 8>(x, q, scale, out, partial, B, K, N, splits, k_per_split, s);
  }
}

template <typename T>
void dispatch_w8a8(int rows, const int8_t* xq, const float* sx, const int8_t* q,
                   const float* scale, void* out, int* partial, int B, int K, int N, int splits,
                   int k_per_split, cudaStream_t s) {
  switch (rows) {
    case 1: launch_w8a8<T, 1>(xq, sx, q, scale, out, partial, B, K, N, splits, k_per_split, s); break;
    case 2: launch_w8a8<T, 2>(xq, sx, q, scale, out, partial, B, K, N, splits, k_per_split, s); break;
    case 4: launch_w8a8<T, 4>(xq, sx, q, scale, out, partial, B, K, N, splits, k_per_split, s); break;
    default: launch_w8a8<T, 8>(xq, sx, q, scale, out, partial, B, K, N, splits, k_per_split, s);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (of x and out). q and scale point at the
// whole stack; `layer` selects [layer, :, :]. rows: x rows per block
// (1, 2, 4 or 8). K is split into `splits` ranges of k_per_split rows
// (a multiple of 128); partial holds splits * B * N float32 when splits > 1.
extern "C" int int8_matmul_w8a16(const void* x, const void* q, const void* scale, void* out,
                                 void* partial, int dtype, int B, int K, int N, int layer,
                                 int rows, int splits, int k_per_split, void* stream) {
  if (bad_shape(B, K, N, layer, rows, splits, k_per_split) || dtype < 0 || dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int8_t* ql = static_cast<const int8_t*>(q) + (long long)layer * K * N;
  const float* sl = static_cast<const float*>(scale) + (long long)layer * N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  if (dtype == 0) {
    dispatch_w8a16<float>(rows, x, ql, sl, out, p, B, K, N, splits, k_per_split, s);
  } else {
    dispatch_w8a16<__nv_bfloat16>(rows, x, ql, sl, out, p, B, K, N, splits, k_per_split, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// As int8_matmul_w8a16 with int8 activations xq [B, K] and their per-row
// scales sx [B]; K % 4 == 0; partial holds int32 sums.
extern "C" int int8_matmul_w8a8(const void* xq, const void* sx, const void* q, const void* scale,
                                void* out, void* partial, int dtype, int B, int K, int N,
                                int layer, int rows, int splits, int k_per_split, void* stream) {
  if (bad_shape(B, K, N, layer, rows, splits, k_per_split) || K % 4 || dtype < 0 || dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int8_t* ql = static_cast<const int8_t*>(q) + (long long)layer * K * N;
  const float* sl = static_cast<const float*>(scale) + (long long)layer * N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* x = static_cast<const int8_t*>(xq);
  const float* sxf = static_cast<const float*>(sx);
  int* p = static_cast<int*>(partial);
  if (dtype == 0) {
    dispatch_w8a8<float>(rows, x, sxf, ql, sl, out, p, B, K, N, splits, k_per_split, s);
  } else {
    dispatch_w8a8<__nv_bfloat16>(rows, x, sxf, ql, sl, out, p, B, K, N, splits, k_per_split, s);
  }
  return static_cast<int>(cudaGetLastError());
}
