// Dynamic per-row int8 quantisation of activations, shared by the W8A8
// (int8_matmul.cu) and W4A8 (int4_matmul.cu) kernels.
//
// The JAX recipe (sonicscribe_tpu/ops/quant.py:matmul_w8a8 and
// int4_pallas.py:_quant_acts), bit for bit:
//   sx = max(max|x|, 1e-8) / 127      an IEEE division
//   xq = clamp(rint(x / sx), -127, 127)   rint rounds half to even
// PyTorch's CUDA division by a Python scalar multiplies by the reciprocal
// instead, so these kernels never take sx or xq from PyTorch.

#pragma once

#include <cuda_bf16.h>

// 4 consecutive values of x (16-byte aligned for float32, 8 for bf16) as float
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(q.x << 16), v[1] = __uint_as_float(q.x & 0xFFFF0000u);
  v[2] = __uint_as_float(q.y << 16), v[3] = __uint_as_float(q.y & 0xFFFF0000u);
}

// max|v| over 4 consecutive values (aligned as load4)
template <typename T>
__device__ __forceinline__ float absmax4(const T* p) {
  float v[4];
  load4(p, v);
  return fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])), fmaxf(fabsf(v[2]), fabsf(v[3])));
}

// max|v| over 16 bytes of x (4 float32 or 8 bf16; 16-byte aligned)
__device__ __forceinline__ float absmax16(const float* p) { return absmax4(p); }
__device__ __forceinline__ float absmax16(const __nv_bfloat16* p) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    m = fmaxf(m, fmaxf(fabsf(__uint_as_float(w[j] << 16)),
                       fabsf(__uint_as_float(w[j] & 0xFFFF0000u))));
  }
  return m;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// sx = max(max|x|, 1e-8) / 127, an IEEE division (quant.py:matmul_w8a8)
__device__ __forceinline__ float act_scale(float absmax) {
  return __fdiv_rn(fmaxf(absmax, 1e-8f), 127.0f);
}

// clamp(rint(v / sx), -127, 127) with v / sx the IEEE quotient; rint rounds
// half to even, as jnp.round. |v| <= 127 sx, so the quotient is at most
// ~127; v * rsx (rsx = 1 / sx rounded) lies within 2.3e-5 of it, and the two
// round to the same integer unless they lie that close to a half: only
// there is the (slow) IEEE division taken.
__device__ __forceinline__ int quant(float v, float sx, float rsx) {
  float q = v * rsx;
  if (fabsf(fabsf(q - rintf(q)) - 0.5f) <= 6.103515625e-05f) q = __fdiv_rn(v, sx);  // 2^-14
  return static_cast<int>(fminf(fmaxf(rintf(q), -127.f), 127.f));
}

// 4 values -> one word of 4 s8, value j in byte j
__device__ __forceinline__ int quant4(const float (&v)[4], float sx, float rsx) {
  unsigned w = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w |= (static_cast<unsigned>(quant(v[j], sx, rsx)) & 0xFFu) << (8 * j);
  }
  return static_cast<int>(w);
}
