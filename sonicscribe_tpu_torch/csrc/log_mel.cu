// Fused log-mel spectrum: framing -> windowed real DFT -> power -> mel
// projection -> log10(max(., 1e-10)), with the spectrum kept on chip.
//
// Replaces the TPU kernel sonicscribe_tpu/ops/mel_pallas.py (`_mel_kernel`,
// entry `log_mel_pallas`), which computes the same function as two
// jnp.dot on the matrix unit over frames cut out by XLA (im2col).
//
// What bounds it on an H100: operations. Per frame the DFT is a
// [n_fft] x [n_fft, 2*n_bins] product (~643 kflop at n_fft = 400), the mel
// projection 2 * n_bins * n_mels flops, against ~1.1 KB of audio read and
// 512 B written. On the CUDA cores in float32 that is 67 TFLOP/s; on the
// tensor cores TF32 runs at 495 TFLOP/s dense, but one TF32 pass (a 10-bit
// mantissa) is ~0.1 off in log10. So the DFT runs as 3xTF32: each operand
// v is split into big = rna_tf32(v) and small = rna_tf32(v - big), and
// each k-step of 8 sums big*small and small*big, then big*big (mma.sync
// m16n8k8 tf32), starting from zero; the step's sums are then added to the
// running float32 sums on the CUDA cores. The tensor cores' own float32
// accumulation truncates: carried across all 50 k-steps it put spectral
// nulls up to 4.5e-3 off the float32 plain version in log10 on an H100;
// from zero each step it rounds only a step's 8 products, and the result
// is as accurate as float32 on the CUDA cores.
//
// Design:
// - a block owns F frames (16 or 32, one or two m-tiles of 16) across all
//   2*n_bins columns (padded to n-tiles of 8); its 8 warps split the
//   n-tiles, so the power and the mel projection stay in shared memory;
// - all copies are bulk copies (cp.async.bulk, Hopper's copy engine) that
//   complete on mbarriers, one issuing thread each (per-thread cp.async
//   copies of the basis held each block to a small share of L2's rate);
// - the frames are cut out of the reflect-padded audio once per block into
//   shared memory (im2col: one 1600-byte copy per frame) with a row stride
//   of n_fft + 4 floats: the hop (160 = 5 x 32 banks) would put every frame
//   of an A fragment on the same bank, an 8-way conflict;
// - the basis streams through shared memory in slices of 16 whole rows (one
//   contiguous 25,728-byte copy each), a 3-stage ring; the big/small split
//   of both operands happens in registers, so the basis is read once per
//   block (643 KB from L2) and never stored twice;
// - after the DFT the spectrum overwrites the basis ring; the power pass
//   works in place, and the mel projection sums only each filter's band of
//   bins ([start, end) per mel, from the host; the first kMaxBand weights in
//   registers, a wider filter's rest read from the cache): the skipped terms
//   are 0 * power, so the result equals the dense sum's. The global-max
//   clamp and the (x + 4) / 4 scaling need every frame and stay outside.
//
// Layout: audio [rows][n_audio] float32 (reflect-padded, rows row_stride
// floats apart), basis [n_fft, 2*n_bins] float32 (windowed cos | -sin), fb
// [n_bins, n_mels] float32, bands [n_mels, 2] int32, out [rows][n_frames,
// n_mels] float32; frame t of row r = audio[r*row_stride + t*hop : ... +
// n_fft]. A batch of rows (the continuous batcher's ring prefill) is one
// launch: blockIdx.y is the row, and every row's frames stay 16-byte
// aligned because row_stride and hop are multiples of 4 floats.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 16;      // basis rows per stage (two k-steps of 8)
constexpr int kStages = 3;   // basis slices in flight
constexpr int kMaxNT = 7;    // n-tiles per warp: 2 * n_bins <= 8 * 8 * 7 = 448
constexpr int kMaxBand = 16;  // bins per mel filter held in registers
constexpr int kFrameGroups = 2;  // threads per mel filter in the projection
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ---- bulk copies (the copy engine, cp.async.bulk) completing on an mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)));
}

// make the barriers' initialisation visible to the copy engine
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the one arrival of this phase, which also expects `bytes` to land
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16; both addresses 16-byte aligned) global -> shared
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// order this thread's earlier shared-memory accesses (after a barrier: the
// block's) before a bulk copy that overwrites them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// cvt.rna.tf32.f32 for finite v: round to a 10-bit mantissa, to nearest,
// ties away from zero (the bit pattern's magnitude rounded half up), in two
// integer operations (equal bits to cvt.rna on the H100, and faster)
__device__ __forceinline__ unsigned rna_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// v = big + small, each rounded to TF32 as above, as the tensor cores take
// it; v - big is exact in float32
__device__ __forceinline__ void split_tf32(float v, unsigned& big, unsigned& small) {
  big = rna_tf32(v);
  small = rna_tf32(v - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int F>
__global__ void __launch_bounds__(kThreads, F == 16 ? 2 : 1)
log_mel_kernel(const float* __restrict__ audio, const float* __restrict__ basis,
               const float* __restrict__ fb, const int* __restrict__ bands,
               float* __restrict__ out, int n_frames, int hop,
               int n_fft, int n_bins, int n_mels, int fstride, int sstride,
               long long row_stride) {
  constexpr int MT = F / 16;  // m-tiles
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bars[kStages + 1];  // the ring's stages, then the frames
  float* frames = smem;               // [F][fstride]
  float* ring = smem + F * fstride;   // [kStages][kBK][cols]; then spec [F][sstride]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, t4 = lane & 3;
  const int cols = 2 * n_bins;
  const int n_tiles = (cols + 7) / 8;
  const int n_steps = n_fft / kBK;
  const int t0 = blockIdx.x * F;
  const int nf = min(F, n_frames - t0);
  audio += blockIdx.y * row_stride;  // this block's row of the batch
  out += (long long)blockIdx.y * n_frames * n_mels;
  const unsigned slice_bytes = sizeof(float) * kBK * cols;

  // basis slice `it` (kBK whole rows: contiguous) into stage it % kStages;
  // one thread issues it after the block is done with the stage
  auto load_slice = [&](int it) {
    if (it < n_steps) {
      uint64_t* bar = &bars[it % kStages];
      fence_proxy_async();
      mbar_expect(bar, slice_bytes);
      bulk_copy(ring + (it % kStages) * kBK * cols, basis + (long long)it * kBK * cols,
                slice_bytes, bar);
    }
  };
  if (tid == 0) {
    for (int i = 0; i <= kStages; ++i) mbar_init(&bars[i]);
    mbar_init_fence();
  }
  __syncthreads();  // the barriers exist before anyone waits on them
  if (tid == 0) {
    // im2col: each of the block's frames is n_fft contiguous samples
    mbar_expect(&bars[kStages], sizeof(float) * nf * n_fft);
    for (int f = 0; f < nf; ++f) {
      bulk_copy(frames + f * fstride, audio + (long long)(t0 + f) * hop, sizeof(float) * n_fft,
                &bars[kStages]);
    }
#pragma unroll
    for (int it = 0; it < kStages - 1; ++it) load_slice(it);
  }
  // frames past the last are zeros
  for (int i = nf * fstride + tid; i < F * fstride; i += kThreads) frames[i] = 0.f;
  mbar_wait(&bars[kStages], 0);

  float acc[MT][kMaxNT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < kMaxNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int it = 0; it < n_steps; ++it) {
    mbar_wait(&bars[it % kStages], (it / kStages) & 1);  // slice it has landed
    __syncthreads();  // the zeroed frames are written; every warp is done with slice it - 1
    if (tid == 0) load_slice(it + kStages - 1);  // into the stage that slice it - 1 used
    const float* bst = ring + (it % kStages) * kBK * cols;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      const int k = it * kBK + kk;
      // A: rows gid / gid + 8 of each m-tile, k + t4 and k + t4 + 4
      unsigned ab[MT][4], as[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* fr = frames + (16 * i + gid) * fstride + k + t4;
        split_tf32(fr[0], ab[i][0], as[i][0]);
        split_tf32(fr[8 * fstride], ab[i][1], as[i][1]);
        split_tf32(fr[4], ab[i][2], as[i][2]);
        split_tf32(fr[8 * fstride + 4], ab[i][3], as[i][3]);
      }
#pragma unroll
      for (int j = 0; j < kMaxNT; ++j) {
        const int nt = warp + kWarps * j;
        if (nt >= n_tiles) break;  // warp-uniform
        // B: rows kk + t4 and kk + t4 + 4 of column 8 * nt + gid (the last
        // n-tile's columns past 2 * n_bins read the next row: their sums are
        // never used)
        const float* bp = bst + (kk + t4) * cols + 8 * nt + gid;
        unsigned bb0, bs0, bb1, bs1;
        split_tf32(bp[0], bb0, bs0);
        split_tf32(bp[4 * cols], bb1, bs1);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(d, ab[i], bs0, bs1);  // big * small
          mma_tf32(d, as[i], bb0, bb1);  // small * big
          mma_tf32(d, ab[i], bb0, bb1);  // big * big
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += d[e];
        }
      }
    }
  }
  __syncthreads();  // every warp is done with the ring: it becomes the spectrum

  float* spec = ring;  // [F][sstride]
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < kMaxNT; ++j) {
      const int nt = warp + kWarps * j;
      if (nt >= n_tiles) break;
      const int c = 8 * nt + 2 * t4;
      float* s0 = spec + (16 * i + gid) * sstride + c;
      float* s1 = s0 + 8 * sstride;
      s0[0] = acc[i][j][0];
      s0[1] = acc[i][j][1];
      s1[0] = acc[i][j][2];
      s1[1] = acc[i][j][3];
    }
  }
  __syncthreads();

  // power spectrum, in place over the real half (each entry has one owner)
  for (int i = tid; i < F * n_bins; i += kThreads) {
    const int f = i / n_bins, b = i % n_bins;
    const float re = spec[f * sstride + b], im = spec[f * sstride + n_bins + b];
    spec[f * sstride + b] = re * re + im * im;
  }
  __syncthreads();

  // mel projection over each filter's band of bins, then log10: a thread
  // per (mel, frame group) holds its filter's weights in registers
  for (int i = tid; i < n_mels * kFrameGroups; i += kThreads) {
    const int m = i % n_mels, g = i / n_mels;
    const int b0 = bands[2 * m], nb = bands[2 * m + 1] - b0;
    float w[kMaxBand];
#pragma unroll
    for (int j = 0; j < kMaxBand; ++j) w[j] = j < nb ? fb[(b0 + j) * n_mels + m] : 0.f;
    for (int f = g; f < nf; f += kFrameGroups) {
      const float* pw = spec + f * sstride + b0;
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxBand; ++j) {
        if (j < nb) a = fmaf(pw[j], w[j], a);
      }
      for (int j = kMaxBand; j < nb; ++j) a = fmaf(pw[j], fb[(b0 + j) * n_mels + m], a);
      out[(long long)(t0 + f) * n_mels + m] = log10f(fmaxf(a, 1e-10f));
    }
  }
}

template <int F>
int launch(const float* audio, const float* basis, const float* fb, const int* bands, float* out,
           int n_frames, int hop, int n_fft, int n_bins, int n_mels, int rows,
           long long row_stride, cudaStream_t stream) {
  const int fstride = n_fft + 4;  // 4 x an odd number: a fragment's 8 frames on distinct banks
  const int npad = (2 * n_bins + 7) / 8 * 8;
  const int sstride = (npad / 8) % 2 ? npad : npad + 8;
  // the ring, with 8 floats past its end for the last n-tile's reads, or
  // the spectrum, whichever is larger
  const size_t ring = std::max((size_t)kStages * kBK * 2 * n_bins + 8, (size_t)F * sstride);
  const size_t smem = sizeof(float) * ((size_t)F * fstride + ring);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(log_mel_kernel<F>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 blocks((n_frames + F - 1) / F, rows);
  log_mel_kernel<F><<<blocks, kThreads, smem, stream>>>(audio, basis, fb, bands, out, n_frames,
                                                        hop, n_fft, n_bins, n_mels, fstride,
                                                        sstride, row_stride);
  return (int)cudaGetLastError();
}

}  // namespace

// frames_per_block: 16 or 32 (the wrapper picks). audio and basis 16-byte
// aligned, hop % 4 == 0, row_stride % 4 == 0 (>= n_audio for rows > 1),
// n_fft % 16 == 0 (whole rows and frames are bulk copies), 2 * n_bins <=
// 448, every frame inside its row's n_audio samples (the wrapper checks),
// 1 <= rows <= 65535. Returns the cudaError_t of the launch (0 on success).
extern "C" int log_mel(const void* audio, long long n_audio, long long row_stride, int rows,
                       const void* basis, const void* fb, const void* bands, void* out,
                       int n_frames, int hop, int n_fft, int n_bins, int n_mels,
                       int frames_per_block, void* stream) {
  if (n_frames < 1 || hop < 1 || hop % 4 || n_fft < kBK || n_fft % kBK || n_bins < 1 ||
      n_mels < 1 || 2 * n_bins > 8 * kWarps * kMaxNT || rows < 1 || rows > 65535 ||
      row_stride % 4 || (rows > 1 && row_stride < n_audio) ||
      (long long)(n_frames - 1) * hop + n_fft > n_audio ||
      reinterpret_cast<uintptr_t>(audio) % 16 || reinterpret_cast<uintptr_t>(basis) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const float* a = static_cast<const float*>(audio);
  const float* bs = static_cast<const float*>(basis);
  const float* f = static_cast<const float*>(fb);
  const int* bd = static_cast<const int*>(bands);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (frames_per_block) {
    case 16:
      return launch<16>(a, bs, f, bd, o, n_frames, hop, n_fft, n_bins, n_mels, rows, row_stride, s);
    case 32:
      return launch<32>(a, bs, f, bd, o, n_frames, hop, n_fft, n_bins, n_mels, rows, row_stride, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
