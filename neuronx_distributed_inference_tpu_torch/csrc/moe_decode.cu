// Selected-experts MoE decode for Hopper (sm_90a): kernel B7 of the port.
//
// Replaces the TPU kernel neuronx_distributed_inference_tpu/ops/
// moe_decode.py::fused_moe_decode (_moe_kernel).
//
// What it computes, for T tokens (T * k <= 64 rows), each with k selected
// experts e = topk_idx[t, j] and combine weights w = topk_w[t, j]:
//   row r = t * k + j:  a_r = glu(x_t @ Wg_e, x_t @ Wu_e)   (I values)
//                       y_r = a_r @ Wd_e                     (H values)
//   out_t = sum_j w[t, j] * y_{t*k+j}
// with Wg, Wu (E, H, I) and Wd (E, I, H) in x's dtype (bf16 or fp32), every
// dot in fp32. The roundings are the TPU kernel's: a_r is rounded to the
// weight dtype before the down product, each y_r to x's dtype, and the
// combine is taken in fp32 and rounded once to x's dtype. glu is silu(g) u,
// gelu_tanh(g) u, or GPT-OSS's clamped swiglu
//   g' = min(g, limit), u' = clip(u, -limit, limit),
//   g' sigmoid(scale g') (u' + bias).
// An expert id outside [0, E) makes its selection's output NaN, so a bad
// routing shows in the logits instead of reading another expert's weights.
//
// What bounds it on an H100: at decode it reads each selected expert's
// 3 H I weights once per selection for 6 H I FLOP, about 1.5 FLOP per byte
// in bf16, far below the card's ~295 FLOP/byte ridge: memory bandwidth
// bounds it (Qwen3-30B-A3B at batch 1 reads 8 experts, 75.5 MB, a layer:
// 0.0225 ms at 3.35 TB/s). The dense all-experts route it replaces reads all
// 128 experts, 1.21 GB a layer.
//
// Design: the TPU kernel carried an fp32 (1, H) sum across a sequential
// grid axis over I tiles. Blocks on Hopper run in no order and nothing
// carries between them, so the work is three launches from one entry (one
// B7 launch), joined by scratch the wrapper allocates in x's dtype: the
// activations (T * k, I) and the per-selection outputs (T * k, H).
//   1. gate/up: grid (ceil(I / 64), T * k). The block reads its own expert
//      id and stages x_t in fp32 in shared memory; its 8 warps split H into
//      contiguous chunks and lane l owns columns 2l, 2l + 1 of the block's
//      64, so a warp reads 128 (bf16) or 256 (fp32) contiguous bytes of each
//      weight row. Each lane issues the loads of 16 rows of both matrices
//      before it uses any (rows past its chunk are clamped to a valid
//      address and weighted 0), so 32 loads are in flight per lane. The
//      warps' sums are reduced through shared memory in warp order (no
//      atomics: greedy tokens repeat from run to run); the GLU runs in fp32
//      and the activation is stored rounded to the weight dtype.
//   2. down: grid (ceil(H / 128), T * k). The block stages its activation
//      row in fp32, its warps split I, lane l owns columns 4l .. 4l + 3
//      (16 rows in flight per lane), the warps' sums are reduced in warp
//      order and the selection's output is stored rounded to x's dtype.
//   3. combine: out[t] = sum_j w[t, j] * y[t * k + j] in fp32, j in order,
//      rounded once to x's dtype.
// Masks handle any H and I: wide loads where I and H are multiples of 4
// and the bases are aligned, element loads otherwise and at the ragged
// column edge. Qwen3-30B-A3B at batch 1 runs 12 x 8 = 96 gate/up blocks
// and 16 x 8 = 128 down blocks on the 132 SMs. Splitting H across blocks
// for gate/up, cp.async/TMA staging and tensor-core tiles near 64 rows are
// later steps.

#include <stdint.h>

#include "common.cuh"

namespace nxdi {
namespace {

constexpr int MOE_THREADS = 256;
constexpr int MOE_WARPS = MOE_THREADS / 32;
constexpr int GU_COLS = 64;     // gate/up columns per block: 32 lanes x 2
constexpr int DOWN_COLS = 128;  // down columns per block: 32 lanes x 4
constexpr int MOE_MAX_ROWS = 64;
constexpr int INFLIGHT = 16;  // weight rows a lane loads before using them

// Raw wide loads of 2 or 4 consecutive elements, kept as loaded so a lane
// can have many in flight; unpacked to floats only when used. bf16 bits b
// are the float bits b << 16, the lower address in the low half.
template <typename T> struct Wide;
template <> struct Wide<float> {
  using R2 = float2;
  using R4 = float4;
  static __device__ __forceinline__ R2 load2(const float* p) { return __ldg(reinterpret_cast<const float2*>(p)); }
  static __device__ __forceinline__ R4 load4(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
  static __device__ __forceinline__ void unpack(R2 r, float v[2]) { v[0] = r.x; v[1] = r.y; }
  static __device__ __forceinline__ void unpack(R4 r, float v[4]) { v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w; }
};
template <> struct Wide<__nv_bfloat16> {
  using R2 = uint32_t;
  using R4 = uint2;
  static __device__ __forceinline__ R2 load2(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  static __device__ __forceinline__ R4 load4(const __nv_bfloat16* p) { return __ldg(reinterpret_cast<const uint2*>(p)); }
  static __device__ __forceinline__ void unpack(R2 r, float v[2]) {
    v[0] = __uint_as_float(r << 16);
    v[1] = __uint_as_float(r & 0xFFFF0000u);
  }
  static __device__ __forceinline__ void unpack(R4 r, float v[4]) {
    unpack(r.x, v);
    unpack(r.y, v + 2);
  }
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(MOE_THREADS)
moe_gate_up_kernel(const T* __restrict__ x, const int* __restrict__ idx, const T* __restrict__ wg,
                   const T* __restrict__ wu, T* __restrict__ act, int k, int E, int H, int I, Glu p) {
  extern __shared__ float moe_smem[];
  float* xs = moe_smem;       // [H]
  float* red = moe_smem + H;  // [2][MOE_WARPS][GU_COLS]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.y;
  const int t = r / k;
  const int e = idx[r];
  const int tile0 = blockIdx.x * GU_COLS;
  if (e < 0 || e >= E) {
    for (int c = threadIdx.x; c < GU_COLS; c += MOE_THREADS)
      if (tile0 + c < I) act[(size_t)r * I + tile0 + c] = from_float<T>(quiet_nan());
    return;  // uniform over the block
  }
  for (int h = threadIdx.x; h < H; h += MOE_THREADS) xs[h] = to_float(x[(size_t)t * H + h]);
  __syncthreads();

  const int col = tile0 + lane * 2;
  const T* pg = wg + (size_t)e * H * I + col;
  const T* pu = wu + (size_t)e * H * I + col;
  const int per_warp = (H + MOE_WARPS - 1) / MOE_WARPS;
  const int h0 = warp * per_warp;
  const int h1 = min(H, h0 + per_warp);
  float g[2] = {0.f, 0.f}, u[2] = {0.f, 0.f};
  if (VEC && col + 1 < I) {
    for (int h = h0; h < h1; h += INFLIGHT) {
      typename Wide<T>::R2 rg[INFLIGHT], ru[INFLIGHT];
#pragma unroll
      for (int s = 0; s < INFLIGHT; ++s) {
        const size_t off = (size_t)min(h + s, h1 - 1) * I;
        rg[s] = Wide<T>::load2(pg + off);
        ru[s] = Wide<T>::load2(pu + off);
      }
#pragma unroll
      for (int s = 0; s < INFLIGHT; ++s) {
        const float xv = h + s < h1 ? xs[h + s] : 0.f;
        float vg[2], vu[2];
        Wide<T>::unpack(rg[s], vg);
        Wide<T>::unpack(ru[s], vu);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          g[c] = fmaf(xv, vg[c], g[c]);
          u[c] = fmaf(xv, vu[c], u[c]);
        }
      }
    }
  } else {
    for (int h = h0; h < h1; ++h) {
      const float xv = xs[h];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (col + c < I) {
          g[c] = fmaf(xv, to_float(pg[(size_t)h * I + c]), g[c]);
          u[c] = fmaf(xv, to_float(pu[(size_t)h * I + c]), u[c]);
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    red[warp * GU_COLS + lane * 2 + c] = g[c];
    red[(MOE_WARPS + warp) * GU_COLS + lane * 2 + c] = u[c];
  }
  __syncthreads();
  if (threadIdx.x < GU_COLS && tile0 + (int)threadIdx.x < I) {
    float gs = 0.f, us = 0.f;
#pragma unroll
    for (int w = 0; w < MOE_WARPS; ++w) {
      gs += red[w * GU_COLS + threadIdx.x];
      us += red[(MOE_WARPS + w) * GU_COLS + threadIdx.x];
    }
    act[(size_t)r * I + tile0 + threadIdx.x] = from_float<T>(glu(gs, us, p));
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(MOE_THREADS)
moe_down_kernel(const T* __restrict__ act, const int* __restrict__ idx, const T* __restrict__ wd,
                T* __restrict__ ysel, int E, int H, int I) {
  extern __shared__ float moe_smem[];
  float* as = moe_smem;       // [I]
  float* red = moe_smem + I;  // [MOE_WARPS][DOWN_COLS]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.y;
  const int e = idx[r];
  const int tile0 = blockIdx.x * DOWN_COLS;
  if (e < 0 || e >= E) {
    for (int c = threadIdx.x; c < DOWN_COLS; c += MOE_THREADS)
      if (tile0 + c < H) ysel[(size_t)r * H + tile0 + c] = from_float<T>(quiet_nan());
    return;  // uniform over the block
  }
  for (int i = threadIdx.x; i < I; i += MOE_THREADS) as[i] = to_float(act[(size_t)r * I + i]);
  __syncthreads();

  const int col = tile0 + lane * 4;
  const T* pd = wd + (size_t)e * I * H + col;
  const int per_warp = (I + MOE_WARPS - 1) / MOE_WARPS;
  const int i0 = warp * per_warp;
  const int i1 = min(I, i0 + per_warp);
  float y[4] = {0.f, 0.f, 0.f, 0.f};
  if (VEC && col + 3 < H) {
    for (int i = i0; i < i1; i += INFLIGHT) {
      typename Wide<T>::R4 rw[INFLIGHT];
#pragma unroll
      for (int s = 0; s < INFLIGHT; ++s) rw[s] = Wide<T>::load4(pd + (size_t)min(i + s, i1 - 1) * H);
#pragma unroll
      for (int s = 0; s < INFLIGHT; ++s) {
        const float av = i + s < i1 ? as[i + s] : 0.f;
        float v[4];
        Wide<T>::unpack(rw[s], v);
#pragma unroll
        for (int c = 0; c < 4; ++c) y[c] = fmaf(av, v[c], y[c]);
      }
    }
  } else {
    for (int i = i0; i < i1; ++i) {
      const float av = as[i];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (col + c < H) y[c] = fmaf(av, to_float(pd[(size_t)i * H + c]), y[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) red[warp * DOWN_COLS + lane * 4 + c] = y[c];
  __syncthreads();
  if (threadIdx.x < DOWN_COLS && tile0 + (int)threadIdx.x < H) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < MOE_WARPS; ++w) s += red[w * DOWN_COLS + threadIdx.x];
    ysel[(size_t)r * H + tile0 + threadIdx.x] = from_float<T>(s);  // the selection's output in x's dtype
  }
}

template <typename T>
__global__ void __launch_bounds__(MOE_THREADS)
moe_combine_kernel(const T* __restrict__ ysel, const float* __restrict__ topk_w, T* __restrict__ out, int k,
                   int H) {
  const int t = blockIdx.y;
  const int h = blockIdx.x * MOE_THREADS + threadIdx.x;
  if (h >= H) return;
  float s = 0.f;
  for (int j = 0; j < k; ++j) s = fmaf(topk_w[t * k + j], to_float(ysel[(size_t)(t * k + j) * H + h]), s);
  out[(size_t)t * H + h] = from_float<T>(s);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, bool VEC>
cudaError_t moe_launch(const void* x, const int* idx, const float* topk_w, const void* wg, const void* wu,
                       const void* wd, void* act, void* ysel, void* out, int T_, int k, int E, int H, int I, Glu p,
                       cudaStream_t stream) {
  const size_t smem1 = ((size_t)H + 2 * MOE_WARPS * GU_COLS) * sizeof(float);
  const size_t smem2 = ((size_t)I + MOE_WARPS * DOWN_COLS) * sizeof(float);
  cudaError_t err = allow_smem(moe_gate_up_kernel<T, VEC>, smem1);
  if (err != cudaSuccess) return err;
  err = allow_smem(moe_down_kernel<T, VEC>, smem2);
  if (err != cudaSuccess) return err;
  const int R = T_ * k;
  moe_gate_up_kernel<T, VEC><<<dim3((I + GU_COLS - 1) / GU_COLS, R), MOE_THREADS, smem1, stream>>>(
      static_cast<const T*>(x), idx, static_cast<const T*>(wg), static_cast<const T*>(wu), static_cast<T*>(act),
      k, E, H, I, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_down_kernel<T, VEC><<<dim3((H + DOWN_COLS - 1) / DOWN_COLS, R), MOE_THREADS, smem2, stream>>>(
      static_cast<const T*>(act), idx, static_cast<const T*>(wd), static_cast<T*>(ysel), E, H, I);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_combine_kernel<T><<<dim3((H + MOE_THREADS - 1) / MOE_THREADS, T_), MOE_THREADS, 0, stream>>>(
      static_cast<const T*>(ysel), topk_w, static_cast<T*>(out), k, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t moe_dispatch(const void* x, const int* idx, const float* topk_w, const void* wg, const void* wu,
                         const void* wd, void* act, void* ysel, void* out, int T_, int k, int E, int H, int I,
                         Glu p, int vec, cudaStream_t st) {
  if (vec) return moe_launch<T, true>(x, idx, topk_w, wg, wu, wd, act, ysel, out, T_, k, E, H, I, p, st);
  return moe_launch<T, false>(x, idx, topk_w, wg, wu, wd, act, ysel, out, T_, k, E, H, I, p, st);
}

}  // namespace
}  // namespace nxdi

// x (T, H); topk_idx (T, k) int32 and topk_w (T, k) fp32; w_gate, w_up
// (E, H, I) and w_down (E, I, H) in x's dtype; scratch act (T * k, I) and
// ysel (T * k, H) in x's dtype; out (T, H) in x's dtype; all contiguous.
// act_kind: 0 silu, 1 gelu (tanh), 2 clamped swiglu (act_scale, act_bias,
// swiglu_limit when has_limit). vec = 1 allows wide loads (I and H
// multiples of 4, 16-byte aligned bases). Three launches on the stream,
// one B7 launch.
extern "C" int nxdi_moe_decode(const void* x, const void* topk_idx, const void* topk_w, const void* w_gate,
                               const void* w_up, const void* w_down, void* act, void* ysel, void* out, int T, int k,
                               int E,
                               int H, int I, int dtype, int act_kind, float act_scale, float act_bias,
                               float swiglu_limit, int has_limit, int vec, void* stream) {
  using namespace nxdi;
  if (T < 1 || k < 1 || T * k > MOE_MAX_ROWS || E < 1 || H < 1 || I < 1 || act_kind < 0 || act_kind > 2)
    return (int)cudaErrorInvalidValue;
  const Glu p{act_kind, act_scale, act_bias, swiglu_limit, has_limit};
  const int* idx = static_cast<const int*>(topk_idx);
  const float* w = static_cast<const float*>(topk_w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return (int)moe_dispatch<float>(x, idx, w, w_gate, w_up, w_down, act, ysel, out, T, k, E, H, I, p, vec, st);
  if (dtype == kBFloat16)
    return (int)moe_dispatch<__nv_bfloat16>(x, idx, w, w_gate, w_up, w_down, act, ysel, out, T, k, E, H, I, p, vec,
                                            st);
  return (int)cudaErrorInvalidValue;
}
