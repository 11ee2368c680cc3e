// One-launch split-K streaming product at decode rows, shared by W8A16
// (int8_matmul.cu) and W4A16 (int4_matmul.cu): the decode-row form of the
// TPU kernels sonicscribe_tpu/ops/int8_pallas.py `_stacked_kernel` and
// `_kernel`, and int4_pallas.py `_kernel_w4a16` and `_stacked_kernel_w4a16`:
//
//   out[b, n] = (sum over the rows k of q of x[b, k] * q[k, n] in float32)
//               * scale[n]
//
// (for W4A16 a row of q holds two rows of the weight, see the policy)
//
// cast to x's type. At decode (B of 1 to 8 rows) the product is bound by
// the weight's bytes, which each feed only 2B (W8A16) or 4B (W4A16)
// operations, and a call is a few microseconds: what costs is latency, the
// launch and a second pass, not the FMAs. So:
// - a CTA owns 128 columns (8 threads of 16, one 16-byte piece of a row
//   each) and a slice of `k_per_cta` rows of q (a multiple of 16), and
//   loads it as 16-byte pieces straight into registers, 8 rows per k-lane
//   (4 at 8 x rows) in flight before the FMAs use them; q takes no shared
//   memory. (Per-thread cp.async and bulk copies of the slice into shared
//   memory measured slower on the H100, PERF.md.)
// - x's rows over the slice are staged once, as float (both halves K/2
//   apart for the int4 planes);
// - the splits of one column tile are the CTAs of one thread-block cluster
//   along K (grid.z = cluster size, at most 16; above 8 the card must admit
//   non-portable sizes). Each CTA adds its k-lanes (warp shuffles, then one
//   shared-memory pass over the 8 warps) and writes its 128 x rows sums into
//   its slot of rank 0's shared memory (distributed shared memory); after
//   one cluster barrier rank 0 adds the slots in rank order, applies the
//   scale, casts and stores. One launch, no global scratch, and a fixed
//   summation order: two runs give equal bits.
// More rows than 8 take row tiles of 8 (grid.y), each reading the weight
// again: only float32 x and bf16 x whose shape the tensor-core designs do
// not take come here with B > 8.
//
// The weight policy W gives kHalves (x halves per row of q: 1 for int8, 2
// for int4's planes) and accumulate(acc, 16 bytes of a row of q, x's values
// for that row), which adds the row's products into acc in float32.

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

// bytes of dynamic shared memory: x, the warps' sums and the cluster's
// slots (read in rank 0)
constexpr long long smem_bytes(int halves, int rows, int cluster, int k_per_cta) {
  return 4LL * ((long long)halves * rows * k_per_cta + (kWarps + cluster) * rows * kTileN);
}

template <typename T, int BT, typename W>
__global__ void __launch_bounds__(kThreads)
kernel(const T* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ scale,
       T* __restrict__ out, int B, int Kq, int N, int k_per_cta) {
  constexpr int H = W::kHalves;
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);     // [H][BT][k_per_cta]
  float* red = xs + H * BT * k_per_cta;           // [kWarps][BT][kTileN]
  float* slots = red + kWarps * BT * kTileN;      // [cluster][BT][kTileN]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ct = tid % kColThreads, kl = tid / kColThreads;
  const int n0 = blockIdx.x * kTileN, r0 = blockIdx.y * BT;
  const int col = n0 + ct * kColsPerThread;
  const int k_begin = rank * k_per_cta;
  const int rows = max(0, min(Kq - k_begin, k_per_cta));  // this CTA's rows of q

  // this thread's 16-byte pieces of rows base + kl + 32i, 8 rows in flight
  // (4 at 8 x rows, whose sums already hold 128 registers)
  constexpr int kRegRows = BT == 8 ? 4 : 8;
  uint4 wr[kRegRows];
  auto load_rows = [&](int base) {
#pragma unroll
    for (int i = 0; i < kRegRows; ++i) {
      const int r = base + i * kKLanes + kl;
      wr[i] = (col < N && r < rows) ? load16(q + (long long)(k_begin + r) * N + col)
                                    : make_uint4(0, 0, 0, 0);
    }
  };
  load_rows(0);

  // x[r0 + b, h * Kq + k_begin + kk] as float, zeros past B and the slice
  const long long Kx = (long long)H * Kq;
  for (int i = tid; i < H * BT * k_per_cta; i += kThreads) {
    const int h = i / (BT * k_per_cta), b = (i / k_per_cta) % BT, kk = i % k_per_cta;
    const int r = r0 + b;
    xs[i] = (r < B && kk < rows) ? to_f32(x[r * Kx + (long long)h * Kq + k_begin + kk]) : 0.f;
  }
  __syncthreads();

  float acc[BT][kColsPerThread];
#pragma unroll
  for (int b = 0; b < BT; ++b) {
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[b][j] = 0.f;
  }
  auto accumulate_row = [&](const uint4 w, int r) {
    float xv[H][BT];
#pragma unroll
    for (int h = 0; h < H; ++h) {
#pragma unroll
      for (int b = 0; b < BT; ++b) xv[h][b] = xs[(h * BT + b) * k_per_cta + r];
    }
    W::template accumulate<BT>(acc, w, xv);
  };
  for (int base = 0; base < rows; base += kRegRows * kKLanes) {
    if (base) load_rows(base);
#pragma unroll
    for (int i = 0; i < kRegRows; ++i) {
      const int r = base + i * kKLanes + kl;
      if (col < N && r < rows) accumulate_row(wr[i], r);
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
  float* dst = cluster.map_shared_rank(slots, 0) + rank * BT * kTileN;
  for (int i = tid; i < BT * kTileN; i += kThreads) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w * BT * kTileN + i];
    dst[i] = v;
  }
  cluster.sync();  // every slot written (release / acquire)
  if (rank != 0) return;
  for (int i = tid; i < BT * kTileN; i += kThreads) {
    const int r = r0 + i / kTileN, n = n0 + i % kTileN;
    if (r >= B || n >= N) continue;
    float v = 0.f;
    for (int s = 0; s < n_ranks; ++s) v += slots[s * BT * kTileN + i];
    store(out + (long long)r * N + n, v * scale[n]);
  }
}

// Whether (rows, cluster, k_per_cta) is a launch this design takes: every
// row of q in exactly one CTA, none empty, and the shared memory fits.
inline bool bad_shape(int halves, int B, int Kq, int N, int rows, int cluster, int k_per_cta) {
  if (B <= 0 || Kq <= 0 || N <= 0 || N % kColsPerThread) return true;
  if (rows != 1 && rows != 2 && rows != 4 && rows != 8) return true;
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1))) return true;
  if (k_per_cta <= 0 || k_per_cta % kRowAlign) return true;
  if ((long long)cluster * k_per_cta < Kq || (long long)(cluster - 1) * k_per_cta >= Kq) return true;
  if ((B + rows - 1) / rows > 65535) return true;
  return smem_bytes(halves, rows, cluster, k_per_cta) > kMaxSmem;
}

template <typename T, int BT, typename W>
cudaError_t launch_tile(const void* x, const int8_t* q, const float* scale, void* out, int B,
                        int Kq, int N, int cluster, int k_per_cta, cudaStream_t stream) {
  auto* kern = kernel<T, BT, W>;
  const int smem = static_cast<int>(smem_bytes(W::kHalves, BT, cluster, k_per_cta));
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
                            B, Kq, N, k_per_cta);
}

template <typename T, typename W>
cudaError_t launch_rows(int rows, const void* x, const int8_t* q, const float* scale, void* out,
                        int B, int Kq, int N, int cluster, int k_per_cta, cudaStream_t s) {
  switch (rows) {
    case 1: return launch_tile<T, 1, W>(x, q, scale, out, B, Kq, N, cluster, k_per_cta, s);
    case 2: return launch_tile<T, 2, W>(x, q, scale, out, B, Kq, N, cluster, k_per_cta, s);
    case 4: return launch_tile<T, 4, W>(x, q, scale, out, B, Kq, N, cluster, k_per_cta, s);
    default: return launch_tile<T, 8, W>(x, q, scale, out, B, Kq, N, cluster, k_per_cta, s);
  }
}

// dtype: 0 float32, 1 bfloat16 (of x and out); rows: x rows per CTA (1, 2,
// 4 or 8). The caller has checked bad_shape.
template <typename W>
cudaError_t launch(int dtype, int rows, const void* x, const int8_t* q, const float* scale,
                   void* out, int B, int Kq, int N, int cluster, int k_per_cta, cudaStream_t s) {
  return dtype == 0
             ? launch_rows<float, W>(rows, x, q, scale, out, B, Kq, N, cluster, k_per_cta, s)
             : launch_rows<__nv_bfloat16, W>(rows, x, q, scale, out, B, Kq, N, cluster,
                                             k_per_cta, s);
}

}  // namespace splitk
