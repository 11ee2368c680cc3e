// The s8 tensor-core design shared by W4A8 (int4_matmul.cu) and W8A8
// (int8_matmul.cu) from their row thresholds: a quantise kernel, then a
// product on mma.sync m16n8k32 with int32 sums, and a split-K pass.
//
// - Quantise: one block per row of x. sx = max(max|x|, 1e-8) / 127 (an
//   IEEE division, act_quant.cuh) and xq = clamp(rint(x / sx), -127, 127),
//   stored as [B][planes][Krp] int8 (Krp = the weight's rows Kr rounded up
//   to kBK, zeros past Kr): plane h holds x's columns h * Kr .. h * Kr +
//   Kr - 1 (W4A8 has two, x's halves against the two nibble planes; W8A8
//   one), each group of 32 rows in the B fragment's k order (xq_slot), so
//   that the product copies its rows as they are. (Fused into the product,
//   each of its ~100 blocks read and quantised the same x rows again,
//   which cost more than the product itself.)
// - Product: 64 x 128 tiles of 8 warps (2 x 4, 32 x 32 each). A block's xq
//   rows over its split (one cp.async group), then the weight rows, as
//   stored, through a 4-stage cp.async ring. ldmatrix.trans over the int8
//   tile read as 16-bit column pairs gives each lane rows k, k+1 (and k+8,
//   k+9) of two neighbouring columns; __byte_perm joins them into the
//   4-row B fragment of one column (even and odd columns apart), and the
//   policy turns it into its planes' fragments. Fragment k = 4t + i holds
//   row 2t + (i & 1) + 8 (i >> 1) of its 16, the order xq is stored in, so
//   no transpose pass is needed. Each plane's mma adds into one int32
//   accumulator: exact, so the output is bit-equal to the plain version.
// - Where the tiles alone leave SMs idle, the rows are split over blocks
//   (grid.z); each writes int32 partial sums and the split-K pass adds the
//   splits in order, applies sx and the scale and casts.
//
// The fragment policy F gives kPlanes, kOffset (a constant the policy adds
// to every weight; kOffset * sum(xq) is taken off in the epilogue),
// planes(word, out[kPlanes]) and mma(acc, a, b0, b1).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "act_quant.cuh"
#include "common.cuh"

namespace s8mma {

constexpr int kWarps = 8;                 // 2 along M x 4 along N
constexpr int kThreads = kWarps * 32;
constexpr int kBM = 64, kBN = 128;        // block tile; a warp's is 32 x 32
constexpr int kBK = 64;                   // weight rows per stage
constexpr int kStages = 4;
constexpr int kRow = kBN + 16;            // bytes per weight row of a stage
constexpr int kStage = kBK * kRow;        // 9,216 bytes
constexpr int kBlockSmem = 232448 - 1024;  // a block's dynamic shared memory (static beside it)

// Rows of xq per plane a block holds over its split (a multiple of kBK):
// 1472 with two planes, 2944 with one.
constexpr int max_k_per_split(int planes) {
  return ((kBlockSmem - kStages * kStage) / (planes * kBM) - 16) / kBK * kBK;
}

constexpr int smem_bytes(int planes, int k_per_split) {
  return planes * kBM * (k_per_split + 16) + kStages * kStage;
}

// s8 A x s8 B and s8 A x u8 B, int32 sums
__device__ __forceinline__ void mma_s8s8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_s8u8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset, within its group of 32, at which the staged xq of row 4u +
// 2j (and 4u + 2j + 1 next to it), j = 0 or 1, is stored: the mma's k
// index of that row in the B fragment. Fragment k = 4t + i holds row 2t +
// (i & 1) + 8 (i >> 1), the order ldmatrix.trans gives.
__device__ __forceinline__ int xq_slot(int u, int j) {
  return 16 * (u >> 2) + 8 * (u & 1) + 2 * ((u >> 1) & 1) + 4 * j;
}

// The quantise kernel's body, one block per row of x [B, P * Kr]: sx[r],
// and xq [B][P][Krp] in the fragments' k order. sx[r] comes from the row's
// own max|x|, or from row_amax[r] where that is given (W8A8 on a
// tensor-parallel rank's share of the row).
template <typename T, int P>
__device__ __forceinline__ void quantize_row(const T* __restrict__ x, int8_t* __restrict__ xq,
                                             float* __restrict__ sx, int Kr, int Krp,
                                             const float* __restrict__ row_amax = nullptr) {
  __shared__ float wmax[kWarps];
  __shared__ float sxr[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, r = blockIdx.x;
  const long long K = (long long)P * Kr;
  const T* xr = x + r * K;
  constexpr int E = 16 / sizeof(T);
  float m = 0.f;
  if (row_amax == nullptr) {
    if (K % E == 0) {  // rows 16-byte aligned: 16-byte loads
      for (int v = tid; v < K / E; v += kThreads) m = fmaxf(m, absmax16(xr + (long long)v * E));
    } else {
      for (int v = tid; v < K / 4; v += kThreads) m = fmaxf(m, absmax4(xr + 4LL * v));
    }
    m = warp_max(m);
    if (lane == 0) wmax[warp] = m;
    __syncthreads();
  }
  if (tid == 0) {
    if (row_amax != nullptr) {
      m = row_amax[r];
    } else {
#pragma unroll
      for (int w = 1; w < kWarps; ++w) m = fmaxf(m, wmax[w]);
    }
    sxr[0] = act_scale(m);
    sxr[1] = __frcp_rn(sxr[0]);
    sx[r] = sxr[0];
  }
  __syncthreads();
  const float s = sxr[0], rs = sxr[1];
  // a thread per group of 32 rows of one plane: 8 quads -> 32 bytes
  for (int g = tid; g < P * (Krp / 32); g += kThreads) {
    const int h = g / (Krp / 32), k0 = (g % (Krp / 32)) * 32;
    unsigned char b[32];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      unsigned w = 0;
      if (k0 + 4 * u < Kr) {
        float v[4];
        load4(xr + (long long)h * Kr + k0 + 4 * u, v);
        w = static_cast<unsigned>(quant4(v, s, rs));
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        b[xq_slot(u, j)] = static_cast<unsigned char>(w >> (16 * j));
        b[xq_slot(u, j) + 1] = static_cast<unsigned char>(w >> (16 * j + 8));
      }
    }
    uint4 lo, hi;
    lo.x = b[0] | b[1] << 8 | b[2] << 16 | (unsigned)b[3] << 24;
    lo.y = b[4] | b[5] << 8 | b[6] << 16 | (unsigned)b[7] << 24;
    lo.z = b[8] | b[9] << 8 | b[10] << 16 | (unsigned)b[11] << 24;
    lo.w = b[12] | b[13] << 8 | b[14] << 16 | (unsigned)b[15] << 24;
    hi.x = b[16] | b[17] << 8 | b[18] << 16 | (unsigned)b[19] << 24;
    hi.y = b[20] | b[21] << 8 | b[22] << 16 | (unsigned)b[23] << 24;
    hi.z = b[24] | b[25] << 8 | b[26] << 16 | (unsigned)b[27] << 24;
    hi.w = b[28] | b[29] << 8 | b[30] << 16 | (unsigned)b[31] << 24;
    uint4* dst = reinterpret_cast<uint4*>(xq + ((long long)r * P + h) * Krp + k0);
    dst[0] = lo;
    dst[1] = hi;
  }
}

// The B fragments of weight rows kk .. kk + 31 of columns wn + 16g .. + 15
// of a stage: ldmatrix.trans over the tile read as 16-bit column pairs
// (r[m]: rows kk + 8m + 2t, + 1 of columns 2c, 2c + 1 for lane 4c + t),
// joined by __byte_perm into the even (e) and odd (o) columns' 4-row
// words, b0 (rows kk + 2t, +1, +8, +9) and b1 (kk + 16 + ...).
__device__ __forceinline__ void load_b(const int8_t* stage, int kk, int col, int lane,
                                       unsigned (&e)[2], unsigned (&o)[2]) {
  unsigned r[4];
  ldmatrix_x4_trans(r, stage + (kk + lane) * kRow + col);
  e[0] = __byte_perm(r[0], r[1], 0x6420), e[1] = __byte_perm(r[2], r[3], 0x6420);
  o[0] = __byte_perm(r[0], r[1], 0x7531), o[1] = __byte_perm(r[2], r[3], 0x7531);
}

// The product kernel's body: xq [B][P][Krp] (quantize_row), w [Kr, N] int8
// rows, out [B, N] or int32 partial [splits, B, N] when partial is set.
template <typename T, typename F>
__device__ __forceinline__ void product(const int8_t* __restrict__ xq,
                                        const float* __restrict__ sx,
                                        const int8_t* __restrict__ w,
                                        const float* __restrict__ scale, T* __restrict__ out,
                                        int* __restrict__ partial, int B, int Kr, int Krp, int N,
                                        int k_per_split) {
  constexpr int P = F::kPlanes;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int xsum[kBM];  // sum of the row's xq over the block's rows, all planes (kOffset)
  const int xrow = k_per_split + 16;  // an odd multiple of 16 bytes: ldmatrix conflict-free
  int8_t* xs = reinterpret_cast<int8_t*>(smem);                     // [P][kBM][xrow]
  int8_t* ring = reinterpret_cast<int8_t*>(smem + P * kBM * xrow);  // [kStages][kBK][kRow]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;
  const int n0 = blockIdx.x * kBN, r0 = blockIdx.y * kBM, split = blockIdx.z;
  const int k_begin = split * k_per_split, k_end = min(Krp, k_begin + k_per_split);
  const int n_steps = (k_end - k_begin) / kBK;

  // the block's rows of xq over its split, every plane (zeros past B), as
  // one commit group; warp w takes the plane-rows w, w + 8, ...
  for (int hr = warp; hr < P * kBM; hr += kWarps) {
    const int h = hr / kBM, rr = hr % kBM;
    const bool ok = r0 + rr < B;
    const int8_t* src = xq + ((long long)(ok ? r0 + rr : 0) * P + h) * Krp + k_begin;
    for (int c = 16 * lane; c < n_steps * kBK; c += 16 * 32) {
      cp_async16(xs + hr * xrow + c, src + c, ok);
    }
  }
  cp_async_commit();

  // weight rows of step `it` into stage it % kStages, 16 bytes a copy,
  // zeros past Kr; one commit group per step, empty past the last
  auto load_step = [&](int it) {
    if (it < n_steps) {
      const int k0 = k_begin + it * kBK;
      int8_t* dst = ring + (it % kStages) * kStage;
#pragma unroll
      for (int i = tid; i < kBK * (kBN / 16); i += kThreads) {
        const int kq = i / (kBN / 16), c = (i % (kBN / 16)) * 16;
        const bool ok = k0 + kq < Kr;
        cp_async16(dst + kq * kRow + c, ok ? w + (long long)(k0 + kq) * N + n0 + c : w, ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) load_step(it);

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // stream the weight through the ring
  for (int it = 0; it < n_steps; ++it) {
    cp_async_wait<kStages - 2>();  // xq and step it have landed (this thread's copies)
    __syncthreads();               // everyone's copies; step it - 1 is done
    load_step(it + kStages - 1);   // into the stage that step it - 1 used
    const int8_t* wst = ring + (it % kStages) * kStage;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      // B per plane: n-tiles 2g (even columns of wn + 16g .. + 15) and 2g + 1 (odd)
      unsigned b[P][4][2];
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        unsigned e[2], o[2];
        load_b(wst, kk, wn + 16 * g, lane, e, o);
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          unsigned pe[P], po[P];
          F::planes(e[f], pe);
          F::planes(o[f], po);
#pragma unroll
          for (int h = 0; h < P; ++h) b[h][2 * g][f] = pe[h], b[h][2 * g + 1][f] = po[h];
        }
      }
      const int kx = it * kBK + kk + (lane >> 4) * 16;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        unsigned a[P][4];
        const int row = wm + 16 * i + (lane & 15);
#pragma unroll
        for (int h = 0; h < P; ++h) ldmatrix_x4(a[h], xs + (h * kBM + row) * xrow + kx);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int h = 0; h < P; ++h) F::mma(acc[i][j], a[h], b[h][j][0], b[h][j][1]);
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
  if constexpr (F::kOffset != 0) {
    // each row's sum of xq over every plane (warp w: rows w, w + 8, ...)
    for (int rr = warp; rr < kBM; rr += kWarps) {
      int t = 0;
      for (int c = 16 * lane; c < n_steps * kBK; c += 16 * 32) {
#pragma unroll
        for (int h = 0; h < P; ++h) {
          const uint4 q = *reinterpret_cast<const uint4*>(xs + (h * kBM + rr) * xrow + c);
          t = __dp4a(static_cast<int>(q.x), 0x01010101, t);
          t = __dp4a(static_cast<int>(q.y), 0x01010101, t);
          t = __dp4a(static_cast<int>(q.z), 0x01010101, t);
          t = __dp4a(static_cast<int>(q.w), 0x01010101, t);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
      if (lane == 0) xsum[rr] = t;
    }
    __syncthreads();
  }

  // epilogue: in n-tile pair g, lane holds columns wn + 16g + 4*t4 .. +3
  // (even c0, odd c0, even c1, odd c1) of rows gid and gid + 8 of each m-tile
  const int gid = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int col = n0 + wn + 16 * g + 4 * t4;
    if (col >= N) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int* e = acc[i][2 * g];
      const int* o = acc[i][2 * g + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rr = wm + 16 * i + gid + 8 * half, row = r0 + rr;
        if (row >= B) continue;
        // sum(xq * (w + kOffset)) - kOffset sum(xq) = sum(xq * w)
        const int c = F::kOffset != 0 ? F::kOffset * xsum[rr] : 0;
        const int v[4] = {e[2 * half] - c, o[2 * half] - c, e[2 * half + 1] - c,
                          o[2 * half + 1] - c};
        if (partial) {
          *reinterpret_cast<int4*>(partial + ((long long)split * B + row) * N + col) =
              make_int4(v[0], v[1], v[2], v[3]);
        } else {
          const float s = sx[row];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            store(out + (long long)row * N + col + j, __int2float_rn(v[j]) * s * scale[col + j]);
        }
      }
    }
  }
}

// The split-K pass's body: add the int32 splits in order, apply sx and
// the scale, cast.
template <typename T>
__device__ __forceinline__ void reduce_splits(const int* __restrict__ partial,
                                              const float* __restrict__ sx,
                                              const float* __restrict__ scale,
                                              T* __restrict__ out, int splits, int B, int N) {
  const long long total = (long long)B * N;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  int v = 0;
  for (int s = 0; s < splits; ++s) v += partial[s * total + i];
  store(out + i, __int2float_rn(v) * sx[i / N] * scale[i % N]);
}

}  // namespace s8mma
