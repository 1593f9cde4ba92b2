// Shared helpers of the port's attention kernels (sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nxdi {

// Masked-score fill of the reference kernels (ops/*_attention.py NEG_INF):
// finite, so exp(NEG_INF - NEG_INF) == 1 and the mask, not an inf, zeroes p.
constexpr float NEG_INF = -1e30f;

// dtype codes passed from Python
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, like torch's .to(bf16)
}

__device__ __forceinline__ float quiet_nan() { return __int_as_float(0x7FC00000); }

// round an fp32 value to bf16 precision (the reference's bf16 softmax mode)
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// max / sum over aligned groups of `Width` lanes (Width a power of two <= 32);
// every lane of the warp must take part
template <int Width>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = Width / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int Width>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = Width / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The gated activations of the MLP kernels (B7, B9) on fp32 gate and up
// values: silu(g) u, gelu_tanh(g) u, or GPT-OSS's clamped swiglu.
enum Act : int { kSilu = 0, kGeluTanh = 1, kSwiglu = 2 };

struct Glu {
  int act;
  float scale, bias, limit;
  int has_limit;
};

__device__ __forceinline__ float glu(float g, float u, const Glu& p) {
  if (p.act == kSwiglu) {
    if (p.has_limit) {
      g = fminf(g, p.limit);
      u = fminf(fmaxf(u, -p.limit), p.limit);
    }
    return g * (1.f / (1.f + expf(-p.scale * g))) * (u + p.bias);
  }
  if (p.act == kSilu) return g / (1.f + expf(-g)) * u;
  // gelu, tanh approximation (the TPU kernel's jax.nn.gelu(approximate=True))
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * g * (1.f + tanhf(c * (g + 0.044715f * g * g * g))) * u;
}

}  // namespace nxdi
