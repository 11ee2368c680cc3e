// One-launch split-K streaming product at decode rows, shared by W8A16 and
// W8A8 (int8_matmul.cu) and W4A16 (int4_matmul.cu): the decode-row form of
// the TPU kernels sonicscribe_tpu/ops/int8_pallas.py `_stacked_kernel` and
// `_kernel`, int4_pallas.py `_kernel_w4a16` and `_stacked_kernel_w4a16`,
// and of ops/quant.py `matmul_w8a8`, which the JAX package leaves to XLA:
//
//   out[b, n] = finish(sum over the rows k of q of x[b, k] * q[k, n]) * scale[n]
//
// (for W4A16 a row of q holds two rows of the weight, see the policy; for
// W8A8 x is quantised per row and the sums are int32, finish multiplies
// by the row's scale) cast to x's type. At decode (B of 1 to 8 rows) the
// product is bound by the weight's bytes, which each feed only 2B (int8)
// or 4B (int4) operations, and a call is a few microseconds: what costs is
// latency, the launch and a second pass, not the arithmetic. So:
// - a CTA owns 128 columns (8 threads of 16, one 16-byte piece of a row
//   each) and a slice of `k_per_cta` rows of q (a multiple of 16), and
//   loads it as 16-byte pieces straight into registers, 8 pieces per
//   k-lane (4 at 8 x rows) in flight before the arithmetic uses them, and
//   before x is read; q takes no shared memory. (Per-thread cp.async and
//   bulk copies of the slice into shared memory measured slower on the
//   H100, PERF.md.)
// - x's rows over the slice are staged once, by the policy, while the
//   weight loads are in flight;
// - the splits of one column tile are the CTAs of one thread-block cluster
//   along K (grid.z = cluster size, at most 16; above 8 the card must admit
//   non-portable sizes). Each CTA adds its k-lanes (warp shuffles, then one
//   shared-memory pass over the 8 warps) and writes its 128 x rows sums into
//   its slot of rank 0's shared memory (distributed shared memory); after
//   one cluster barrier rank 0 adds the slots in rank order, finishes,
//   applies the scale, casts and stores. One launch, no global scratch, and
//   a fixed summation order: two runs give equal bits.
// More rows than 8 take row tiles of 8 (grid.y), each reading the weight
// again.
//
// The weight policy W gives:
// - Acc, the sums' type (float, or int for W8A8's __dp4a);
// - kHalves, x halves per row of q (1; 2 for int4's planes);
// - kRows, the rows of q a k-lane takes together: 1, or 4 consecutive rows
//   (rows base + (s * 32 + k-lane) * kRows + j, j < kRows, for its step s);
// - kXBytes, bytes of staged x per value (4 as float, 1 as int8), and
//   kActFloats, the floats of per-row state it keeps (W8A8's scales);
// - stage(...), which puts x's rows over the slice into shared memory
//   ([kHalves][BT][k_per_cta] values) and the per-row state into `act`;
//   its last argument is the launch's `row_amax` (null unless the caller
//   gives W8A8 each row's max|x|, see W8A8Rows; the float policies ignore
//   it);
// - step(acc, kRows 16-byte pieces, staged x, k_per_cta, r), which adds
//   the products of rows r .. r + kRows - 1 into acc;
// - finish(sum, b, act), the sum of row b as float before the scale.

#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace splitk {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColsPerThread = 16;
constexpr int kColThreads = 8;
constexpr int kTileN = kColThreads * kColsPerThread;  // 128 columns per CTA
constexpr int kKLanes = kThreads / kColThreads;        // 32
constexpr int kRowAlign = 16;                          // k_per_cta % 16 == 0
constexpr int kMaxCluster = 16;
constexpr int kMaxSmem = 232448;                       // a CTA's shared memory on the H100

// bytes of dynamic shared memory: x (x_bytes per value), the warps' sums
// and the cluster's slots (read in rank 0), 4 bytes each
constexpr long long smem_bytes(int halves, int rows, int cluster, int k_per_cta,
                               int x_bytes = 4) {
  return (long long)x_bytes * halves * rows * k_per_cta +
         4LL * (kWarps + cluster) * rows * kTileN;
}

// The float-x policies (W8A16, W4A16): x staged as float, one row of q per
// k-lane step; `Derived::accumulate(acc, 16 bytes of a row of q, x's values
// for that row)` adds the row's products into acc in float32.
template <int H, typename Derived>
struct FloatX {
  using Acc = float;
  static constexpr int kHalves = H, kRows = 1, kXBytes = 4, kActFloats = 1;

  // x[r0 + b, h * Kq + k_begin + kk] as float into [H][BT][k_per_cta],
  // zeros past B and the slice (both halves K/2 apart for the int4 planes)
  template <typename T, int BT>
  __device__ __forceinline__ static void stage(const T* __restrict__ x, unsigned char* smem,
                                               float*, int B, int r0, int Kq, int k_begin,
                                               int rows, int k_per_cta, cg::cluster_group&,
                                               const float*) {
    float* xs = reinterpret_cast<float*>(smem);
    const long long Kx = (long long)H * Kq;
    for (int i = threadIdx.x; i < H * BT * k_per_cta; i += kThreads) {
      const int h = i / (BT * k_per_cta), b = (i / k_per_cta) % BT, kk = i % k_per_cta;
      const int r = r0 + b;
      xs[i] = (r < B && kk < rows) ? to_f32(x[r * Kx + (long long)h * Kq + k_begin + kk]) : 0.f;
    }
  }

  template <int BT>
  __device__ __forceinline__ static void step(float (&acc)[BT][kColsPerThread],
                                              const uint4* w, const unsigned char* smem,
                                              int k_per_cta, int r) {
    const float* xs = reinterpret_cast<const float*>(smem);
    float xv[H][BT];
#pragma unroll
    for (int h = 0; h < H; ++h) {
#pragma unroll
      for (int b = 0; b < BT; ++b) xv[h][b] = xs[(h * BT + b) * k_per_cta + r];
    }
    Derived::template accumulate<BT>(acc, w[0], xv);
  }

  __device__ __forceinline__ static float finish(float v, int, const float*) { return v; }
};

template <typename T, int BT, typename W>
__global__ void __launch_bounds__(kThreads)
kernel(const T* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ scale,
       T* __restrict__ out, int B, int Kq, int N, int k_per_cta,
       const float* __restrict__ row_amax) {
  using Acc = typename W::Acc;
  constexpr int R = W::kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float act[W::kActFloats];  // the policy's per-row state
  // x: [kHalves][BT][k_per_cta] values of kXBytes; then the sums
  Acc* red = reinterpret_cast<Acc*>(smem + W::kXBytes * W::kHalves * BT * k_per_cta);  // [kWarps][BT][kTileN]
  Acc* slots = red + kWarps * BT * kTileN;  // [cluster][BT][kTileN]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ct = tid % kColThreads, kl = tid / kColThreads;
  const int n0 = blockIdx.x * kTileN, r0 = blockIdx.y * BT;
  const int col = n0 + ct * kColsPerThread;
  const int k_begin = rank * k_per_cta;
  const int rows = max(0, min(Kq - k_begin, k_per_cta));  // this CTA's rows of q

  // this thread's 16-byte pieces: kRegRows / R steps of R rows, 8 pieces in
  // flight (4 at 8 x rows, whose sums already hold 128 registers)
  constexpr int kRegRows = BT == 8 ? 4 : 8;
  static_assert(kRegRows % R == 0, "whole steps in flight");
  uint4 wr[kRegRows];
  auto load_rows = [&](int base) {
#pragma unroll
    for (int i = 0; i < kRegRows; ++i) {
      const int r = base + (i / R * kKLanes + kl) * R + i % R;
      wr[i] = (col < N && r < rows) ? load16(q + (long long)(k_begin + r) * N + col)
                                    : make_uint4(0, 0, 0, 0);
    }
  };
  load_rows(0);  // the weight is in flight while x is staged
  W::template stage<T, BT>(x, smem, act, B, r0, Kq, k_begin, rows, k_per_cta, cluster,
                           row_amax);
  __syncthreads();

  Acc acc[BT][kColsPerThread];
#pragma unroll
  for (int b = 0; b < BT; ++b) {
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[b][j] = 0;
  }
  for (int base = 0; base < rows; base += kRegRows * kKLanes) {
    if (base) load_rows(base);
#pragma unroll
    for (int s = 0; s < kRegRows / R; ++s) {
      const int r = base + (s * kKLanes + kl) * R;
      if (col < N && r < rows) W::template step<BT>(acc, wr + s * R, smem, k_per_cta, r);
    }
  }

  // the CTA's sums: k-lanes by shuffles, warps through shared memory
#pragma unroll
  for (int b = 0; b < BT; ++b) {
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[b][j] = lane_sum(acc[b][j]);
  }
  if (lane < kColThreads) {
#pragma unroll
    for (int b = 0; b < BT; ++b) {
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        red[(warp * BT + b) * kTileN + lane * kColsPerThread + j] = acc[b][j];
    }
  }
  __syncthreads();
  // into this rank's slot in rank 0's shared memory
  Acc* dst = cluster.map_shared_rank(slots, 0) + rank * BT * kTileN;
  for (int i = tid; i < BT * kTileN; i += kThreads) {
    Acc v = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w * BT * kTileN + i];
    dst[i] = v;
  }
  cluster.sync();  // every slot written (release / acquire)
  if (rank != 0) return;
  for (int i = tid; i < BT * kTileN; i += kThreads) {
    const int r = r0 + i / kTileN, n = n0 + i % kTileN;
    if (r >= B || n >= N) continue;
    Acc v = 0;
    for (int s = 0; s < n_ranks; ++s) v += slots[s * BT * kTileN + i];
    store(out + (long long)r * N + n, W::finish(v, i / kTileN, act) * scale[n]);
  }
}

// Whether (rows, cluster, k_per_cta) is a launch this design takes: every
// row of q in exactly one CTA, none empty, and the shared memory fits.
inline bool bad_shape(int halves, int B, int Kq, int N, int rows, int cluster, int k_per_cta,
                      int x_bytes = 4) {
  if (B <= 0 || Kq <= 0 || N <= 0 || N % kColsPerThread) return true;
  if (rows != 1 && rows != 2 && rows != 4 && rows != 8) return true;
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1))) return true;
  if (k_per_cta <= 0 || k_per_cta % kRowAlign) return true;
  if ((long long)cluster * k_per_cta < Kq || (long long)(cluster - 1) * k_per_cta >= Kq) return true;
  if ((B + rows - 1) / rows > 65535) return true;
  return smem_bytes(halves, rows, cluster, k_per_cta, x_bytes) > kMaxSmem;
}

template <typename T, int BT, typename W>
cudaError_t launch_tile(const void* x, const int8_t* q, const float* scale, void* out, int B,
                        int Kq, int N, int cluster, int k_per_cta, cudaStream_t stream,
                        const float* row_amax) {
  auto* kern = kernel<T, BT, W>;
  const int smem = static_cast<int>(smem_bytes(W::kHalves, BT, cluster, k_per_cta, W::kXBytes));
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && cluster > 8) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kTileN - 1) / kTileN, (B + BT - 1) / BT, cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cluster;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(x), q, scale, static_cast<T*>(out),
                            B, Kq, N, k_per_cta, row_amax);
}

template <typename T, typename W>
cudaError_t launch_rows(int rows, const void* x, const int8_t* q, const float* scale, void* out,
                        int B, int Kq, int N, int cluster, int k_per_cta, cudaStream_t s,
                        const float* a) {
  switch (rows) {
    case 1: return launch_tile<T, 1, W>(x, q, scale, out, B, Kq, N, cluster, k_per_cta, s, a);
    case 2: return launch_tile<T, 2, W>(x, q, scale, out, B, Kq, N, cluster, k_per_cta, s, a);
    case 4: return launch_tile<T, 4, W>(x, q, scale, out, B, Kq, N, cluster, k_per_cta, s, a);
    default: return launch_tile<T, 8, W>(x, q, scale, out, B, Kq, N, cluster, k_per_cta, s, a);
  }
}

// dtype: 0 float32, 1 bfloat16 (of x and out); rows: x rows per CTA (1, 2,
// 4 or 8); row_amax: [B] float32 for the policy's stage, or null. The
// caller has checked bad_shape.
template <typename W>
cudaError_t launch(int dtype, int rows, const void* x, const int8_t* q, const float* scale,
                   void* out, int B, int Kq, int N, int cluster, int k_per_cta, cudaStream_t s,
                   const float* row_amax = nullptr) {
  return dtype == 0
             ? launch_rows<float, W>(rows, x, q, scale, out, B, Kq, N, cluster, k_per_cta, s,
                                     row_amax)
             : launch_rows<__nv_bfloat16, W>(rows, x, q, scale, out, B, Kq, N, cluster,
                                             k_per_cta, s, row_amax);
}

}  // namespace splitk
