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
// What bounds it on an H100: at decode (B of 1 to 8 rows) bytes. The
// weight is K/2 * N bytes and each byte feeds 4 * B operations, far below
// the card's ridge. With more rows each byte feeds more operations than
// the CUDA cores keep up with, and the product belongs on the tensor cores.
//
// W4A16 has two designs (the wrapper picks by B and x's type):
// - decode rows, and float32 x at every B: cluster_splitk.cuh's one-launch
//   streaming design (a CTA per 128 columns and slice of packed rows, all
//   its weight pieces in flight at once, the slices of a column tile one
//   thread-block cluster that adds its sums in rank 0 in rank order). `Int4Rows` is its weight policy: one packed row gives two
//   k rows of the same 16 columns, so x is staged for both halves (k and
//   K/2 + k); each nibble is sign-extended by one shift pair on the 32-bit
//   word, and bf16 * a code in [-8, 7] is exact in float32;
// - bf16 x from W4A16_MMA_MIN_ROWS rows: bf16 tensor cores (mma.sync
//   m16n8k16, float32 sums), the W4A8 mma design below with bf16 x: 64 x 128
//   tiles of 8 warps (2 x 4, 32 x 32 each); each stage of a 4-stage cp.async
//   ring holds 64 packed rows as stored and the tile's x rows over both
//   halves of those k (x is not quantised). ldmatrix.trans over the packed
//   tile read as 16-bit column pairs gives each lane packed rows k, k+1 of
//   two neighbouring columns; the nibbles become bf16 exactly in registers:
//   the unsigned nibble u = code + 8 goes into the low mantissa bits of
//   bf16 128 (0x4300 | u = 128 + u, whose ulp is 1, by __byte_perm, which
//   also splits the even and odd columns) and 136 comes off (__hsub2), so
//   every product is exact and only the float32 summation order differs
//   from the plain version. The lo plane's fragments meet x's first half,
//   the hi plane's its second, in one accumulator. Where the tiles alone
//   leave SMs idle, K/2 is split over blocks (grid.z) and a second pass adds
//   the splits in order, applies the scale and casts.
//
// W4A8 quantises x itself (act_quant.cuh), so a call launches nothing but
// this file's kernels: sx = max(max|x|, 1e-8) / 127 per row (an IEEE
// division) and xq = clamp(rint(x / sx), -127, 127) (the JAX recipe, bit
// for bit). Two designs (the wrapper picks by B):
// - up to 4 rows (decode), a streaming kernel on the CUDA cores, fused:
//   a block owns 128 columns, each thread reads 16 of them in 16-byte loads
//   of 4 packed rows; each block takes its rows' max|x| over the whole K,
//   then quantises x as it stages a chunk; four packed rows per column
//   regrouped with __byte_perm, each word split into two words of 4 signed
//   bytes (low nibbles: rows k..k+3; high nibbles: rows K/2+k..K/2+k+3)
//   with one __vsub4 each, two __dp4a; K/2 split over blocks as above when
//   the column tiles leave SMs idle (int32 partials, sx from scratch);
// - 5 rows or more, s8 tensor cores: s8_mma.cuh's design (shared with
//   W8A8), a quantise kernel (a block per row, xq [B][2][K/2 rounded up],
//   x's two halves as two planes), then mma.sync m16n8k32 over 64 x 128
//   tiles of 8 warps with packed streaming in, as stored, through a
//   4-stage cp.async ring. `NibblePlanes` is its fragment policy: a mask
//   and an xor turn each 4-row B fragment of packed bytes into the
//   lo-plane and hi-plane fragments as unsigned bytes, code + 8 (s8 x u8
//   mma; the 8 * sum(xq) this adds is taken off in the epilogue); two mma
//   per fragment (x's first half against lo, its second half against hi)
//   add into one int32 accumulator: exact, so the output is bit-equal to
//   the plain version. Where the tiles alone leave SMs idle, K/2 is split
//   as above.
//
// Layout: x [B, K] (float32 / bfloat16, contiguous), packed [L, K/2, N]
// int8 and scale [L, 1, N] float32 (contiguous), out [B, N] in x's type,
// partial [splits, B, N] float32 / int32 scratch and, for W4A8, sx [B]
// float32 scratch when splits > 1 (always for the W4A8 mma design, with
// xq [B, 2, K/2 rounded up to 64] int8). N must be a multiple of 16 (the
// wrapper holds it to the JAX gate's 128; the mma designs need it); W4A8
// needs K/2 % 4 == 0 and 16-byte aligned x; W4A16's mma design bf16 x,
// K/2 % 8 == 0 and 16-byte aligned x and scale. The wrapper
// (ops/int4_matmul.py) checks and picks the design and launch shape; each
// entry returns the cudaError of its launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "act_quant.cuh"
#include "cluster_splitk.cuh"
#include "common.cuh"
#include "s8_mma.cuh"

namespace {

using splitk::kColsPerThread;
using splitk::kColThreads;
using splitk::kKLanes;
using splitk::kThreads;
using splitk::kTileN;
using splitk::kWarps;
constexpr int kChunkK = 128;  // W4A8 streaming: packed rows staged per pass

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

// the W4A16 weight policy of cluster_splitk.cuh: a packed row holds weight
// rows k (low nibbles, against x[b, k]) and K/2 + k (high, x[b, K/2 + k])
struct Int4Rows : splitk::FloatX<2, Int4Rows> {
  template <int BT>
  __device__ __forceinline__ static void accumulate(float (&acc)[BT][kColsPerThread], const uint4 w,
                                             const float (&xv)[2][BT]) {
    const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float lo = nibble(words[q], 2 * j), hi = nibble(words[q], 2 * j + 1);
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          acc[b][4 * q + j] = fmaf(xv[1][b], hi, fmaf(xv[0][b], lo, acc[b][4 * q + j]));
        }
      }
    }
  }
};

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
w4a8_kernel(const T* __restrict__ x, const int8_t* __restrict__ p,
            const float* __restrict__ scale, T* __restrict__ out, int* __restrict__ partial,
            float* __restrict__ sx_out, int B, int K2, int N, int k_per_split) {
  // 4 consecutive k of one row per word: xq[r, c0 + 4g..] and xq[r, K/2 + c0 + 4g..]
  __shared__ int xs[2][BT][kChunkK / 4];
  __shared__ int red[kWarps][BT][kTileN];
  __shared__ float wmax[kWarps][BT];
  __shared__ float sxs[BT], rsxs[BT];  // the rows' scales and their rounded reciprocals
  const int tid = threadIdx.x, ct = tid % kColThreads, kl = tid / kColThreads;
  const int lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kTileN, r0 = blockIdx.y * BT, split = blockIdx.z;
  const int col = n0 + ct * kColsPerThread;
  const long long K = 2LL * K2;
  const int k_begin = split * k_per_split, k_end = min(K2, k_begin + k_per_split);

  // the rows' scales, over the whole K (16-byte loads, all rows at once)
  constexpr int E = 16 / sizeof(T);
  float m[BT];
#pragma unroll
  for (int b = 0; b < BT; ++b) m[b] = 0.f;
  for (int v = tid; v < K / E; v += kThreads) {
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      if (r0 + b < B) m[b] = fmaxf(m[b], absmax16(x + (r0 + b) * K + (long long)v * E));
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
    for (int i = tid; i < 2 * BT * (kChunkK / 4); i += kThreads) {
      const int h = i / (BT * (kChunkK / 4)), b = (i / (kChunkK / 4)) % BT, g = i % (kChunkK / 4);
      const int r = r0 + b, k = c0 + 4 * g;
      int w = 0;
      if (r < B && k < k_end) {
        float v[4];
        load4(x + r * K + (long long)h * K2 + k, v);
        w = quant4(v, sxs[b], rsxs[b]);
      }
      xs[h][b][g] = w;
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
      store(out + (long long)r * N + n, __int2float_rn(v) * sxs[r - r0] * scale[n]);
    }
  });
}

// ---------------------------------------------------------------- W4A8 mma

constexpr int kQWarps = s8mma::kWarps;     // 2 along M x 4 along N
constexpr int kQThreads = s8mma::kThreads;
constexpr int kQBM = s8mma::kBM, kQBN = s8mma::kBN;  // block tile; a warp's is 32 x 32
constexpr int kQBK = s8mma::kBK;           // packed rows per stage
constexpr int kQStages = s8mma::kStages;
constexpr int kQRow = s8mma::kRow;         // bytes per packed row of a stage
constexpr int kQStage = s8mma::kStage;     // 9,216 bytes
constexpr int kQMaxKPerSplit = s8mma::max_k_per_split(2);  // 1472 packed rows of x a block holds
static_assert(kQMaxKPerSplit == 1472, "ops/int4_matmul.py MMA_MAX_K_PER_SPLIT");

// 4 packed bytes -> 4 unsigned bytes of their low (high) nibbles plus 8:
// the code + 8, in [0, 15]; the 8 comes back out as 8 * sum(xq), exactly
__device__ __forceinline__ unsigned low_nibbles_u(unsigned w) {
  return (w & 0x0F0F0F0Fu) ^ 0x08080808u;
}
__device__ __forceinline__ unsigned high_nibbles_u(unsigned w) { return low_nibbles_u(w >> 4); }

// the W4A8 fragment policy of s8_mma.cuh: a packed row's low nibbles meet
// x's first half, its high nibbles the second, as unsigned code + 8 (s8 x
// u8 mma)
struct NibblePlanes {
  static constexpr int kPlanes = 2, kOffset = 8;
  __device__ __forceinline__ static void planes(unsigned w, unsigned (&p)[2]) {
    p[0] = low_nibbles_u(w), p[1] = high_nibbles_u(w);
  }
  __device__ __forceinline__ static void mma(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                             unsigned b1) {
    s8mma::mma_s8u8(d, a, b0, b1);
  }
};

// Per-row quantisation for the mma design, one block per row of x: sx[r],
// and xq [B][2][K2p] (x's first half, then its second; K2p = K2 rounded up
// to kQBK, zeros past K2) in the fragments' k order (s8_mma.cuh).
template <typename T>
__global__ void __launch_bounds__(kQThreads)
w4a8_quant_kernel(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx,
                  int K2, int K2p) {
  s8mma::quantize_row<T, 2>(x, xq, sx, K2, K2p);
}

template <typename T>
__global__ void __launch_bounds__(kQThreads)
w4a8_mma_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                const int8_t* __restrict__ p, const float* __restrict__ scale,
                T* __restrict__ out, int* __restrict__ partial, int B, int K2, int K2p, int N,
                int k_per_split) {
  s8mma::product<T, NibblePlanes>(xq, sx, p, scale, out, partial, B, K2, K2p, N, k_per_split);
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
  s8mma::reduce_splits<T>(partial, sx, scale, out, splits, B, N);
}

bool bad_shape(int B, int K2, int N, int layer, int rows, int splits, int k_per_split) {
  if (B <= 0 || K2 <= 0 || N <= 0 || layer < 0 || N % kColsPerThread) return true;
  if (rows != 1 && rows != 4 && rows != 8) return true;
  if (splits < 1 || k_per_split <= 0 || k_per_split % kChunkK) return true;
  if ((long long)splits * k_per_split < K2 || (long long)(splits - 1) * k_per_split >= K2) return true;
  return (B + rows - 1) / rows > 65535 || splits > 65535;
}

template <typename T, int BT>
void launch_w4a8(const void* x, const int8_t* p, const float* scale, void* out, int* partial,
                 float* sx, int B, int K2, int N, int splits, int k_per_split,
                 cudaStream_t stream) {
  const dim3 grid((N + kTileN - 1) / kTileN, (B + BT - 1) / BT, splits);
  w4a8_kernel<T, BT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), p, scale, static_cast<T*>(out), splits > 1 ? partial : nullptr,
      splits > 1 ? sx : nullptr, B, K2, N, k_per_split);
  if (splits > 1) {
    const long long total = (long long)B * N;
    w4a8_reduce<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        partial, sx, scale, static_cast<T*>(out), splits, B, N);
  }
}

template <typename T>
int launch_w4a8_mma(const void* x, const int8_t* p, const float* scale, void* out, int* partial,
                    int8_t* xq, float* sx, int B, int K2, int N, int splits, int k_per_split,
                    cudaStream_t stream) {
  const int K2p = (K2 + kQBK - 1) / kQBK * kQBK;
  w4a8_quant_kernel<T><<<B, kQThreads, 0, stream>>>(static_cast<const T*>(x), xq, sx, K2, K2p);
  const int smem = s8mma::smem_bytes(2, k_per_split);
  const cudaError_t e = cudaFuncSetAttribute(
      w4a8_mma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(N / kQBN, (B + kQBM - 1) / kQBM, splits);
  w4a8_mma_kernel<T><<<grid, kQThreads, smem, stream>>>(
      xq, sx, p, scale, static_cast<T*>(out), splits > 1 ? partial : nullptr, B, K2, K2p, N,
      k_per_split);
  if (splits > 1) {
    const long long total = (long long)B * N;
    w4a8_reduce<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        partial, sx, scale, static_cast<T*>(out), splits, B, N);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
void dispatch_w4a8(int rows, const void* x, const int8_t* p, const float* scale, void* out,
                   int* partial, float* sx, int B, int K2, int N, int splits, int k_per_split,
                   cudaStream_t s) {
  if (rows == 1) {
    launch_w4a8<T, 1>(x, p, scale, out, partial, sx, B, K2, N, splits, k_per_split, s);
  } else {  // 2 to 4 rows; from 5 the tensor-core design runs
    launch_w4a8<T, 4>(x, p, scale, out, partial, sx, B, K2, N, splits, k_per_split, s);
  }
}

// ---------------------------------------------------------------- W4A16 mma

constexpr int kHXRow = kQBK + 8;                 // bf16 per x row of a stage (+16 bytes)
constexpr int kHXStage = 2 * kQBM * kHXRow * 2;  // bytes: the tile's x rows, both halves
constexpr int kHStage = kQStage + kHXStage;      // 27,648
constexpr int kHSmem = kQStages * kHStage;       // 110,592: two blocks per SM

// a bf16 pair minus 136 each (exact on 128 + u, u in [0, 15])
__device__ __forceinline__ unsigned minus136(unsigned v) {
  __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&v);
  b = __hsub2(b, __bfloat162bfloat162(__ushort_as_bfloat16(0x4308)));
  return *reinterpret_cast<unsigned*>(&b);
}

// One register of ldmatrix.trans over packed bytes: p(k, c), p(k, c+1),
// p(k+1, c), p(k+1, c+1). -> the bf16 code pairs (k, k+1) of column c
// ([0]) and c + 1 ([1]) of the lo plane (low nibbles: weight rows k, k+1)
// and of the hi plane (high nibbles: rows K/2 + k, K/2 + k + 1), exact:
// u = code + 8 = nibble ^ 8 in the low byte of bf16 0x4300 (128 + u), 136
// off.
__device__ __forceinline__ void nibble_pairs_to_bf16(unsigned r, unsigned (&lo)[2],
                                                     unsigned (&hi)[2]) {
  const unsigned l = (r & 0x0F0F0F0Fu) ^ 0x08080808u;
  const unsigned h = ((r >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
  lo[0] = minus136(__byte_perm(l, 0x43434343u, 0x4240));
  lo[1] = minus136(__byte_perm(l, 0x43434343u, 0x4341));
  hi[0] = minus136(__byte_perm(h, 0x43434343u, 0x4240));
  hi[1] = minus136(__byte_perm(h, 0x43434343u, 0x4341));
}

__global__ void __launch_bounds__(kQThreads)
w4a16_mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ p,
                 const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ partial, int B, int K2, int N, int k_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];  // [kQStages][kHStage]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;
  const int n0 = blockIdx.x * kQBN, r0 = blockIdx.y * kQBM, split = blockIdx.z;
  const int k_begin = split * k_per_split, k_end = min(K2, k_begin + k_per_split);
  const int n_steps = (k_end - k_begin + kQBK - 1) / kQBK;
  const long long K = 2LL * K2;

  // step `it` into stage it % kQStages: packed rows k0 .. k0 + 63 as stored
  // ([kQBK][kQRow] bytes), then x's columns k0 .. k0 + 63 and K/2 + k0 ..
  // of the tile's rows ([2][kQBM][kHXRow] bf16), 16 bytes a copy, zeros
  // past the split, K/2 and B; one commit group per step, empty past the
  // last
  auto load_step = [&](int it) {
    if (it < n_steps) {
      const int k0 = k_begin + it * kQBK;
      unsigned char* st = smem + (it % kQStages) * kHStage;
      for (int i = tid; i < kQBK * (kQBN / 16); i += kQThreads) {
        const int kq = i / (kQBN / 16), c = (i % (kQBN / 16)) * 16;
        const bool ok = k0 + kq < k_end;
        cp_async16(st + kq * kQRow + c, ok ? p + (long long)(k0 + kq) * N + n0 + c : p, ok);
      }
      __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(st + kQStage);
      for (int i = tid; i < 2 * kQBM * (kQBK / 8); i += kQThreads) {
        const int hr = i / (kQBK / 8), kx = (i % (kQBK / 8)) * 8;
        const int h = hr / kQBM, r = hr % kQBM;
        const bool ok = r0 + r < B && k0 + kx < k_end;  // K/2 % 8 == 0: whole pieces
        cp_async16(xs + hr * kHXRow + kx, ok ? x + (r0 + r) * K + h * K2 + k0 + kx : x, ok);
      }
    }
    cp_async_commit();
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int it = 0; it < kQStages - 1; ++it) load_step(it);
  for (int it = 0; it < n_steps; ++it) {
    cp_async_wait<kQStages - 2>();  // step it has landed (this thread's copies)
    __syncthreads();                // everyone's copies; step it - 1 is done
    load_step(it + kQStages - 1);   // into the stage that step it - 1 used
    const unsigned char* st = smem + (it % kQStages) * kHStage;
    const __nv_bfloat16* xst = reinterpret_cast<const __nv_bfloat16*>(st + kQStage);
#pragma unroll
    for (int kk = 0; kk < kQBK; kk += 16) {
      // packed rows kk .. kk + 15 of the warp's 32 columns, as 16-bit column
      // pairs: r[0], r[1] columns wn .. wn + 15 (rows kk.., kk + 8..), r[2],
      // r[3] wn + 16 ..; n-tiles: 2g the even columns of wn + 16g .. + 15,
      // 2g + 1 the odd ones
      unsigned r[4], blo[4][2], bhi[4][2];
      ldmatrix_x4_trans(r, st + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kQRow + wn +
                               (lane >> 4) * 16);
#pragma unroll
      for (int g = 0; g < 2; ++g) {
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          unsigned lo[2], hi[2];
          nibble_pairs_to_bf16(r[2 * g + f], lo, hi);
          blo[2 * g][f] = lo[0], blo[2 * g + 1][f] = lo[1];
          bhi[2 * g][f] = hi[0], bhi[2 * g + 1][f] = hi[1];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        unsigned alo[4], ahi[4];  // rows wm + 16i .., x's columns k (lo) and K/2 + k (hi)
        const int row = wm + 16 * i + (lane & 15);
        ldmatrix_x4(alo, xst + row * kHXRow + kk + (lane >> 4) * 8);
        ldmatrix_x4(ahi, xst + (kQBM + row) * kHXRow + kk + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_bf16(acc[i][j], alo, blo[j][0], blo[j][1]);
          mma_bf16(acc[i][j], ahi, bhi[j][0], bhi[j][1]);
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

  // epilogue: in n-tile pair g, lane holds columns wn + 16g + 4*t4 .. +3
  // (even, odd, even, odd) of rows gid and gid + 8 of each m-tile: scale,
  // round to bf16, one 8-byte store each (or float32 partial sums)
  const int gid = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int col = n0 + wn + 16 * g + 4 * t4;
    const float4 sc = *reinterpret_cast<const float4*>(scale + col);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float* e = acc[i][2 * g];
      const float* o = acc[i][2 * g + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + wm + 16 * i + gid + 8 * half;
        if (row >= B) continue;
        if (partial) {
          *reinterpret_cast<float4*>(partial + ((long long)split * B + row) * N + col) =
              make_float4(e[2 * half], o[2 * half], e[2 * half + 1], o[2 * half + 1]);
          continue;
        }
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

int launch_w4a16_mma(const void* x, const int8_t* p, const float* scale, void* out,
                     float* partial, int B, int K2, int N, int splits, int k_per_split,
                     cudaStream_t stream) {
  // above 48 KB of shared memory only by asking (per device; cheap to repeat)
  const cudaError_t e = cudaFuncSetAttribute(
      w4a16_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kHSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(N / kQBN, (B + kQBM - 1) / kQBM, splits);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  w4a16_mma_kernel<<<grid, kQThreads, kHSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), p, scale, o, splits > 1 ? partial : nullptr, B, K2, N,
      k_per_split);
  if (splits > 1) {
    const long long total = (long long)B * N;
    w4a16_reduce<__nv_bfloat16><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        partial, scale, o, splits, B, N);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// W4A16 at decode rows and for float32 x (cluster_splitk.cuh). dtype: 0
// float32, 1 bfloat16 (of x and out). packed and scale point at the whole
// stack; `layer` selects [layer, :, :]. K2 is the packed row count K/2 (x
// has 2 * K2 columns). rows: x rows per CTA (1, 2, 4 or 8); the K2 packed
// rows are split over `cluster` CTAs (a power of two, at most 16) of
// k_per_cta rows each (a multiple of 16), none of them empty.
extern "C" int int4_matmul_w4a16(const void* x, const void* packed, const void* scale, void* out,
                                 int dtype, int B, int K2, int N, int layer, int rows, int cluster,
                                 int k_per_cta, void* stream) {
  if (splitk::bad_shape(2, B, K2, N, rows, cluster, k_per_cta) || layer < 0 || dtype < 0 ||
      dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int8_t* pl = static_cast<const int8_t*>(packed) + (long long)layer * K2 * N;
  const float* sl = static_cast<const float*>(scale) + (long long)layer * N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = splitk::launch<Int4Rows>(dtype, rows, x, pl, sl, out, B, K2, N,
                                               cluster, k_per_cta, s);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// W4A16 on the bf16 tensor cores: bf16 x [B, 2 * K2] (K2 % 8 == 0), N %
// 128 == 0, K2 split into `splits` ranges of k_per_split packed rows (a
// multiple of 64); partial holds splits * B * N float32 when splits > 1;
// x, packed and scale (at the layer) 16-byte aligned.
extern "C" int int4_matmul_w4a16_mma(const void* x, const void* packed, const void* scale,
                                     void* out, void* partial, int B, int K2, int N, int layer,
                                     int splits, int k_per_split, void* stream) {
  const int8_t* pl = static_cast<const int8_t*>(packed) + (long long)layer * K2 * N;
  const float* sl = static_cast<const float*>(scale) + (long long)layer * N;
  if (B <= 0 || K2 <= 0 || K2 % 8 || N <= 0 || N % kQBN || layer < 0 ||
      (B + kQBM - 1) / kQBM > 65535 || splits < 1 || splits > 65535 || k_per_split <= 0 ||
      k_per_split % kQBK || (long long)splits * k_per_split < K2 ||
      (long long)(splits - 1) * k_per_split >= K2 || (splits > 1 && partial == nullptr) ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(pl) % 16 ||
      reinterpret_cast<uintptr_t>(sl) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_w4a16_mma(x, pl, sl, out, static_cast<float*>(partial), B, K2, N, splits,
                          k_per_split, static_cast<cudaStream_t>(stream));
}

// W4A8 on the CUDA cores: x [B, 2 * K2] float32 / bfloat16, quantised per
// row in the kernel; rows 1 or 4 (more rows take the tensor-core entry);
// K2 % 4 == 0; partial holds int32 sums and sx B float32 scales when
// splits > 1.
extern "C" int int4_matmul_w4a8(const void* x, const void* packed, const void* scale, void* out,
                                void* partial, void* sx, int dtype, int B, int K2, int N,
                                int layer, int rows, int splits, int k_per_split, void* stream) {
  if (bad_shape(B, K2, N, layer, rows, splits, k_per_split) || rows == 8 || K2 % 4 || dtype < 0 ||
      dtype > 1 || reinterpret_cast<uintptr_t>(x) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int8_t* pl = static_cast<const int8_t*>(packed) + (long long)layer * K2 * N;
  const float* sl = static_cast<const float*>(scale) + (long long)layer * N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* pt = static_cast<int*>(partial);
  float* sxf = static_cast<float*>(sx);
  if (dtype == 0) {
    dispatch_w4a8<float>(rows, x, pl, sl, out, pt, sxf, B, K2, N, splits, k_per_split, s);
  } else {
    dispatch_w4a8<__nv_bfloat16>(rows, x, pl, sl, out, pt, sxf, B, K2, N, splits, k_per_split, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// W4A8 on the tensor cores, arguments as int4_matmul_w4a8 without `rows`,
// and xq scratch of B * 2 * K2p bytes (K2p = K2 rounded up to 64) and sx of
// B float32 always: N % 128 == 0, k_per_split a multiple of 64 and at most
// 1472, x, packed and xq 16-byte aligned.
extern "C" int int4_matmul_w4a8_mma(const void* x, const void* packed, const void* scale,
                                    void* out, void* partial, void* xq, void* sx, int dtype,
                                    int B, int K2, int N, int layer, int splits, int k_per_split,
                                    void* stream) {
  if (B <= 0 || K2 <= 0 || K2 % 4 || N <= 0 || N % kQBN || layer < 0 || dtype < 0 ||
      dtype > 1 || (B + kQBM - 1) / kQBM > 65535 || splits < 1 || splits > 65535 ||
      k_per_split <= 0 || k_per_split % kQBK || k_per_split > kQMaxKPerSplit ||
      (long long)splits * k_per_split < K2 || (long long)(splits - 1) * k_per_split >= K2 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(packed) % 16 ||
      reinterpret_cast<uintptr_t>(xq) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int8_t* pl = static_cast<const int8_t*>(packed) + (long long)layer * K2 * N;
  const float* sl = static_cast<const float*>(scale) + (long long)layer * N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* pt = static_cast<int*>(partial);
  int8_t* q = static_cast<int8_t*>(xq);
  float* sxf = static_cast<float*>(sx);
  return dtype == 0
             ? launch_w4a8_mma<float>(x, pl, sl, out, pt, q, sxf, B, K2, N, splits, k_per_split, s)
             : launch_w4a8_mma<__nv_bfloat16>(x, pl, sl, out, pt, q, sxf, B, K2, N, splits,
                                              k_per_split, s);
}

