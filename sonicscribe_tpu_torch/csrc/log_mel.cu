// Fused log-mel spectrum: framing -> windowed real DFT -> power -> mel
// projection -> log10(max(., 1e-10)), with the spectrum kept on chip.
//
// Replaces the TPU kernel sonicscribe_tpu/ops/mel_pallas.py (`_mel_kernel`,
// entry `log_mel_pallas`). On the TPU the frames were cut out by XLA
// (im2col) because Mosaic needs 128-aligned slices and the hop is 160; here
// each block cuts its own frames out of the reflect-padded audio in shared
// memory, so the [T, n_fft] frame matrix never exists in device memory.
//
// What bounds it on an H100: operations. Per frame it does
// 2 * n_fft * 2 * n_bins (the DFT, ~643 kflop at n_fft = 400) plus
// 2 * n_bins * n_mels (the mel projection) float32 flops, against
// ~1.1 KB of audio read and 512 B written, so it sits far above the
// memory ridge. It computes in float32 on the CUDA cores (no TF32: that
// would cost ~1e-3 relative error), one thread per DFT column with the
// block's frames in registers, so each basis value read from device
// memory (L2-resident, 643 KB) feeds kFrames multiply-adds, and each
// audio sample read from shared memory is a broadcast. The global-max
// clamp and the (x + 4) / 4 scaling need every frame and stay outside.
//
// Layout: audio [n_audio] float32 (reflect-padded), basis [n_fft, 2*n_bins]
// float32 (windowed cos | -sin), fb [n_bins, n_mels] float32,
// out [n_frames, n_mels] float32, frame t = audio[t*hop : t*hop + n_fft].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFrames = 16;  // frames per block

__global__ void __launch_bounds__(kThreads)
log_mel_kernel(const float* __restrict__ audio, long long n_audio,
               const float* __restrict__ basis, const float* __restrict__ fb,
               float* __restrict__ out, int n_frames, int hop, int n_fft, int n_bins,
               int n_mels) {
  extern __shared__ float smem[];
  const int span = (kFrames - 1) * hop + n_fft;
  float* samples = smem;        // [span]
  float* spec = smem + span;    // [kFrames][2 * n_bins], then power in place
  const int cols = 2 * n_bins;
  const int t0 = blockIdx.x * kFrames;
  const int nf = min(kFrames, n_frames - t0);
  const long long base = (long long)t0 * hop;

  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const long long a = base + i;
    samples[i] = a < n_audio ? audio[a] : 0.f;
  }
  __syncthreads();

  // windowed DFT: thread per output column, the block's frames in registers
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    float acc[kFrames];
#pragma unroll
    for (int f = 0; f < kFrames; ++f) acc[f] = 0.f;
    for (int n = 0; n < n_fft; ++n) {
      const float w = basis[(long long)n * cols + c];
#pragma unroll
      for (int f = 0; f < kFrames; ++f) acc[f] = fmaf(samples[f * hop + n], w, acc[f]);
    }
#pragma unroll
    for (int f = 0; f < kFrames; ++f) spec[f * cols + c] = acc[f];
  }
  __syncthreads();

  // power spectrum, in place over the real half (each entry has one owner)
  for (int i = threadIdx.x; i < kFrames * n_bins; i += blockDim.x) {
    const int f = i / n_bins, b = i % n_bins;
    const float re = spec[f * cols + b], im = spec[f * cols + n_bins + b];
    spec[f * cols + b] = re * re + im * im;
  }
  __syncthreads();

  // mel projection and log10
  for (int i = threadIdx.x; i < nf * n_mels; i += blockDim.x) {
    const int f = i / n_mels, m = i % n_mels;
    const float* pw = spec + f * cols;
    float acc = 0.f;
    for (int b = 0; b < n_bins; ++b) acc = fmaf(pw[b], fb[b * n_mels + m], acc);
    out[(long long)(t0 + f) * n_mels + m] = log10f(fmaxf(acc, 1e-10f));
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int log_mel(const void* audio, long long n_audio, const void* basis,
                       const void* fb, void* out, int n_frames, int hop, int n_fft,
                       int n_bins, int n_mels, void* stream) {
  if (n_frames < 1 || hop < 1 || n_fft < 1 || n_bins < 1 || n_mels < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)(kFrames - 1) * hop + n_fft + (size_t)kFrames * 2 * n_bins);
  cudaError_t err = cudaFuncSetAttribute(
      log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_frames + kFrames - 1) / kFrames;
  log_mel_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)audio, n_audio, (const float*)basis, (const float*)fb, (float*)out,
      n_frames, hop, n_fft, n_bins, n_mels);
  return (int)cudaGetLastError();
}
