// Shared helpers of the port's attention kernels (sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nxdi {

// Masked-score fill of the reference kernels (ops/*_attention.py NEG_INF):
// finite, so exp(NEG_INF - NEG_INF) == 1 and the mask, not an inf, zeroes p.
constexpr float NEG_INF = -1e30f;

// dtype codes passed from Python; the last three are the 1-byte codes of a
// quantized KV cache (ops/decode_attention.py _CODE_DTYPES)
enum DType : int { kFloat32 = 0, kBFloat16 = 1, kInt8 = 2, kFp8E4M3 = 3, kFp8E5M2 = 4 };

// 1-byte fp8 KV codes (torch.float8_e4m3fn / float8_e5m2): the raw byte,
// converted to float through half precision, which holds every value of
// both formats exactly
struct Fp8E4M3 { uint8_t x; };
struct Fp8E5M2 { uint8_t x; };

__device__ __forceinline__ float fp8_to_float(uint8_t b, __nv_fp8_interpretation_t kind) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(b), kind)));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_float(Fp8E4M3 x) { return fp8_to_float(x.x, __NV_E4M3); }
__device__ __forceinline__ float to_float(Fp8E5M2 x) { return fp8_to_float(x.x, __NV_E5M2); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, like torch's .to(bf16)
}

// A code cache's dequant factor scale[i] / qmax (the layer's running absmax
// of one kv head over the code type's largest magnitude; the reference's
// k_scale / v_scale), read on the device at launch so a captured graph sees
// each step's scales; 1 for a plain cache (scale null).
__device__ __forceinline__ float dequant_factor(const float* scale, int i, float qmax) {
  return scale != nullptr ? scale[i] / qmax : 1.f;
}

__device__ __forceinline__ float quiet_nan() { return __int_as_float(0x7FC00000); }

// round an fp32 value to bf16 precision (the reference's bf16 softmax mode)
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// 16 raw bytes as floats: 8 bf16 or 4 fp32 (bf16 bits b are the float bits
// b << 16, the lower address in the low half)
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(uint4 r, float* v) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(uint4 r, float* v) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
};
// Byte k (a constant) of a word of int8 codes as a float, exactly and
// without I2F (a quarter-rate conversion): ``biased`` is the word XOR
// 0x80808080 (each byte x + 128), placed as the low byte of 2^23 it gives
// the float 2^23 + 128 + x, and one FADD takes 2^23 + 128 off.
__device__ __forceinline__ float int8_byte_to_float(uint32_t biased, int k) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7650 + k)) - 8388736.f;
}

// 16 KV codes (the lower address in the low byte)
template <> struct Vec16<int8_t> {
  static constexpr int N = 16;
  static __device__ __forceinline__ void unpack(uint4 r, float* v) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) v[4 * i + k] = int8_byte_to_float(w[i] ^ 0x80808080u, k);
  }
};
__device__ __forceinline__ void unpack_fp8x16(uint4 r, __nv_fp8_interpretation_t kind, float* v) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __half2 pair(__nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(w[i] >> (16 * h)), kind));
      const float2 f = __half22float2(pair);
      v[4 * i + 2 * h] = f.x;
      v[4 * i + 2 * h + 1] = f.y;
    }
}
template <> struct Vec16<Fp8E4M3> {
  static constexpr int N = 16;
  static __device__ __forceinline__ void unpack(uint4 r, float* v) { unpack_fp8x16(r, __NV_E4M3, v); }
};
template <> struct Vec16<Fp8E5M2> {
  static constexpr int N = 16;
  static __device__ __forceinline__ void unpack(uint4 r, float* v) { unpack_fp8x16(r, __NV_E5M2, v); }
};

// N consecutive values from 16-byte aligned shared or global memory as
// floats (N a multiple of the 16 bytes' element count)
template <typename T, int N>
__device__ __forceinline__ void load_floats(const T* p, float* v) {
  constexpr int E = Vec16<T>::N;
  static_assert(N % E == 0, "whole 16-byte vectors");
#pragma unroll
  for (int i = 0; i < N / E; ++i) Vec16<T>::unpack(*reinterpret_cast<const uint4*>(p + i * E), v + i * E);
}

// Asynchronous copies from device memory into shared memory (sm_80+): one
// 16-byte (or 4-byte) copy per call; with `full` false nothing is read and
// the destination is zero-filled. Copies join a group at commit, and
// wait<N> returns when at most N of this thread's groups are in flight.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Programmatic dependent launch: a kernel launched with
// cudaLaunchAttributeProgrammaticStreamSerialization (launch_ex's `after`)
// may start once every block of the launch before it has called
// pdl_launch_dependents (or exited), and pdl_wait returns once that launch
// has completed and its writes are visible. Without the attribute both are
// no-ops.
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }
__device__ __forceinline__ void pdl_launch_dependents() { asm volatile("griddepcontrol.launch_dependents;"); }

// A launch on `st`; `after` lets it start while the launch before it on the
// stream still runs (the kernel then calls pdl_wait before it reads what
// that launch writes). Dynamic shared memory above 48 KB is opted into.
template <typename... Params, typename... Args>
cudaError_t launch_ex(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem, cudaStream_t st, bool after,
                      Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = after ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The last of `total` blocks that share a completion counter: each block
// calls this once, after every thread has written what the last one will
// read; it returns true in exactly one block, the last to arrive, which
// then reads the others' writes (with __ldcg, past L1) and has already
// reset the counter to 0 for the next launch. The counter decides only who
// finishes, never an order of summation. Every thread of the block must
// call it. The barrier orders the block's writes before thread 0's
// acquire-release count at gpu scope (release: they are visible before the
// count; acquire: the last block's later reads see every other block's),
// the pattern of a serial split-K semaphore; one thread fences, not each.
__device__ __forceinline__ bool last_block(unsigned* counter, unsigned total) {
  __shared__ int last_s;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned prev;
    asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;" : "=r"(prev) : "l"(counter) : "memory");
    last_s = prev == total - 1;
    if (last_s) *counter = 0u;
  }
  __syncthreads();
  return last_s;
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
