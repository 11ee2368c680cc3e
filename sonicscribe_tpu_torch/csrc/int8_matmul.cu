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
// The same loop walks row tiles of 8 (grid.y) for more rows, on the CUDA
// cores; it serves float32 x at every B, the stacked entry and W8A8.
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
// Layout: x [B, K] (float32 / bfloat16, contiguous), xq [B, K] int8 and
// sx [B] float32 for W8A8, q [L, K, N] int8 and scale [L, 1, N] float32
// (contiguous), out [B, N] in x's type, partial [splits, B, N] float32 /
// int32 scratch when splits > 1. N must be a multiple of 16; W8A8 needs
// K % 4 == 0; the mma entry needs bf16 x with K % 8 == 0 and 16-byte
// aligned x and scale (16-byte copies and loads). The wrapper (ops/int8_matmul.py)
// checks and picks the design and the launch shape; each entry returns the
// cudaError of its launches.

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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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
