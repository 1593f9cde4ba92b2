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
// weight dtype after the full H sum and the GLU, each y_r to x's dtype
// after the full I sum, and the combine is taken in fp32 over j in order
// and rounded once to x's dtype. glu is silu(g) u, gelu_tanh(g) u, or
// GPT-OSS's clamped swiglu
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
// 128 experts, 1.21 GB a layer. Reaching that rate takes ~3 MB in flight
// across the card (3.35 TB/s times a ~1 us load latency), from enough
// blocks on every SM.
//
// Design: the TPU kernel carried an fp32 (1, H) sum across a sequential
// grid axis over I tiles. Blocks on Hopper run in no order and nothing
// carries between them, so the work is three launches from one entry (one
// B7 launch), joined by fp32 scratch the wrapper keeps (ops/_cuda.scratch):
//   1. gate/up: grid (ceil(I / 64) column tiles, S splits of H, T * k).
//      S comes from the shapes and the SM count alone (ops/moe_decode.py::
//      moe_h_split: about MOE_BLOCKS_PER_SM blocks an SM; 3 splits of 704
//      rows, 288 blocks, at Qwen3-30B-A3B's batch 1, where one block per
//      column tile and row was 96 blocks on 132 SMs). Warp w sums the w-th
//      eighth of the split's rows in order, lane l columns 2l, 2l + 1: the
//      warp streams its eighth in tiles of 4 rows of Wg and of Wu (64
//      columns) with their x values through stages of its own by cp.async
//      (zero fill past its rows and the last column), all stages but one in
//      flight, and synchronizes only within itself, so no warp waits on
//      another's loads. The warps' sums meet once, in warp order, and the
//      fp32 partial (g, u) sums go to scratch (S, T * k, 2, I).
//   2. down: grid (ceil(H / 64), T * k), two blocks an SM at Qwen3's batch
//      1 (256). Each warp puts its first tiles of Wd (8 rows of its eighth
//      of I) in flight, waits for the gate/up launch, sums its rows' S
//      partials in split order, applies the GLU and rounds each activation
//      to the weight dtype (from L2), then streams its eighth as above. The
//      selection's full I sum stays inside one block, reduced in warp
//      order, and is stored rounded to x's dtype.
//   3. combine: out[t] = sum_j w[t, j] * y[t * k + j] in fp32, j in order,
//      rounded once to x's dtype.
// At one split both sums run in the first version's order (a warp's
// eighth of the rows in order, then the warps), so B7's output there is
// bit for bit what it was. The stage count of each launch comes from the
// shapes and the SM count (ops/moe_decode.py::moe_stages): about 56 KB of
// weights in flight on each SM for gate/up and 96 KB for down (4 and 8
// stages at Qwen3's batch 1; 2 and 3 at its batch 8, where six or more
// blocks share an SM; 3 and 8 at Mixtral-8x7B's batch 1, where one down
// block has an SM to itself).
// The down and combine launches are programmatic dependent launches: each
// starts while the launch before it drains, stages what does not depend on
// it (Wd's first tiles) and then waits for it (griddepcontrol), so the gaps
// between the three launches close.
// Every sum is in a fixed order, no atomics: greedy tokens repeat from run
// to run. Widths whose rows are a multiple of 16 bytes, at 16-byte aligned
// bases, take the cp.async path; any other width stages its tiles by
// element loads, with the same arithmetic.

#include <stdint.h>

#include "common.cuh"

namespace nxdi {
namespace {

constexpr int MOE_THREADS = 256;
constexpr int MOE_WARPS = MOE_THREADS / 32;
constexpr int MOE_COLS = 64;  // columns per block, both launches: 32 lanes x 2
constexpr int GU_ROWS = 32;   // rows of H per gate/up tile: 4 of each warp's chunk
constexpr int DN_ROWS = 64;   // rows of I per down tile: 8 of each warp's chunk
constexpr int MOE_MAX_ROWS = 64;
constexpr int MOE_MAX_SPLITS = 16;
// pdl_wait / pdl_launch_dependents and launch_ex: common.cuh (programmatic
// dependent launch).

// two consecutive elements of a staged tile as floats
__device__ __forceinline__ void load_pair(const float* p, float v[2]) {
  const float2 r = *reinterpret_cast<const float2*>(p);
  v[0] = r.x;
  v[1] = r.y;
}
__device__ __forceinline__ void load_pair(const __nv_bfloat16* p, float v[2]) {
  const uint32_t r = *reinterpret_cast<const uint32_t*>(p);
  v[0] = __uint_as_float(r << 16);
  v[1] = __uint_as_float(r & 0xFFFF0000u);
}

// A warp stages ROWS consecutive rows of a row-major weight, columns
// [c0, c0 + MOE_COLS), into its own shared memory: rows [row0, row0 + n)
// of w (row stride ld), then zeros; columns at or past ncols read as
// zeros. VEC: 16-byte cp.async copies (rows of a multiple of 16 bytes,
// aligned base), which the caller commits as one group; else element
// loads, stored before the call returns.
template <typename T, bool VEC, int ROWS>
__device__ __forceinline__ void stage_rows(T* dst, const T* w, int row0, int n, int c0, int ncols, int ld) {
  const int lane = threadIdx.x % 32;
  if (VEC) {
    constexpr int EPC = 16 / (int)sizeof(T);  // elements per copy
    constexpr int CPR = MOE_COLS / EPC;       // copies per row
#pragma unroll
    for (int i = lane; i < ROWS * CPR; i += 32) {
      const int rr = i / CPR, c = (i % CPR) * EPC;
      const bool ok = rr < n && c0 + c < ncols;
      cp_async16(dst + rr * MOE_COLS + c, ok ? w + (size_t)(row0 + rr) * ld + c0 + c : w, ok);
    }
  } else {
    for (int i = lane; i < ROWS * MOE_COLS; i += 32) {
      const int rr = i / MOE_COLS, c = i % MOE_COLS;
      dst[i] = rr < n && c0 + c < ncols ? w[(size_t)(row0 + rr) * ld + c0 + c] : from_float<T>(0.f);
    }
  }
}

// a staged (ROWS x MOE_COLS) tile against ROWS vector values v (taken as
// fp32), rows in order: lane l at columns 2l, 2l + 1
template <typename T, int ROWS, typename V>
__device__ __forceinline__ void tile_dot(const T* tile, const V* v, float acc[2]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    float wv[2];
    load_pair(tile + i * MOE_COLS + 2 * lane, wv);
    const float xv = to_float(v[i]);
    acc[0] = fmaf(xv, wv[0], acc[0]);
    acc[1] = fmaf(xv, wv[1], acc[1]);
  }
}

// Both weight launches give each warp a contiguous chunk of cw rows, summed
// in order, and a pipeline of its own: the warp streams its chunk's tiles
// of RPW rows through STAGES shared-memory stages (all but one in flight)
// and synchronizes only within itself, so no warp waits on another's loads.
// The warps' sums meet once, at the end, in warp order.

// grid (column tiles, splits, rows): the fp32 partial sums of x_t @ Wg_e
// and x_t @ Wu_e over rows [z * per, (z + 1) * per) of H, to
// part[((z * R + r) * 2 + m) * I + col] (m 0 gate, 1 up)
template <typename T, bool VEC, int STAGES>
__global__ void __launch_bounds__(MOE_THREADS)
moe_gate_up_kernel(const T* __restrict__ x, const int* __restrict__ idx, const T* __restrict__ wg,
                   const T* __restrict__ wu, float* __restrict__ part, int k, int E, int H, int I, int per) {
  constexpr int RPW = GU_ROWS / MOE_WARPS;  // rows a warp stages a tile
  // its gate and up rows, then 16 bytes for their x values (4 of them)
  constexpr int WSTAGE = 2 * RPW * MOE_COLS + 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char moe_smem[];
  T* tiles = reinterpret_cast<T*>(moe_smem);                                    // [MOE_WARPS][STAGES][WSTAGE]
  float* red = reinterpret_cast<float*>(tiles + MOE_WARPS * STAGES * WSTAGE);  // [2][MOE_WARPS][MOE_COLS]
  pdl_launch_dependents();  // the down launch may start staging its weights
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = blockIdx.x * MOE_COLS, z = blockIdx.y, r = blockIdx.z;
  const int e = idx[r];
  if (e < 0 || e >= E) return;  // the down launch writes the selection's NaN
  const int cw = per / MOE_WARPS;  // per is a multiple of GU_ROWS
  const int hw = z * per + warp * cw;                    // the warp's first row
  const int n = max(0, min(cw, min(H, (z + 1) * per) - hw));  // its rows in H
  const int nt = (n + RPW - 1) / RPW;
  T* mine = tiles + warp * STAGES * WSTAGE;
  const T* g = wg + (size_t)e * H * I;
  const T* u = wu + (size_t)e * H * I;
  const T* xt = x + (size_t)(r / k) * H;
  auto stage = [&](int j) {
    T* dst = mine + (j % STAGES) * WSTAGE;
    const int h = hw + j * RPW, m = min(RPW, n - j * RPW);
    stage_rows<T, VEC, RPW>(dst, g, h, m, c0, I, I);
    stage_rows<T, VEC, RPW>(dst + RPW * MOE_COLS, u, h, m, c0, I, I);
    // x at those rows, zeros past them: 4-byte copies (m is even on this
    // path: H and the chunks are multiples of 16 bytes of elements)
    constexpr int EPC = 4 / (int)sizeof(T);
    if (lane < RPW / EPC) {
      const int rr = lane * EPC;
      if (VEC) {
        cp_async4(dst + 2 * RPW * MOE_COLS + rr, rr < m ? xt + h + rr : xt, rr < m);
      } else {
        for (int i = 0; i < EPC; ++i)
          dst[2 * RPW * MOE_COLS + rr + i] = rr + i < m ? xt[h + rr + i] : from_float<T>(0.f);
      }
    }
  };
  // one copy group a tile; empty groups past the last keep the count
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < nt) stage(j);
    cp_async_commit();
  }
  float ga[2] = {0.f, 0.f}, ua[2] = {0.f, 0.f};
  for (int j = 0; j < nt; ++j) {
    cp_async_wait<STAGES - 2>();
    __syncwarp();  // tile j landed for every lane; every lane is done with tile j - 1's stage
    if (j + STAGES - 1 < nt) stage(j + STAGES - 1);
    cp_async_commit();
    const T* tg = mine + (j % STAGES) * WSTAGE;
    tile_dot<T, RPW>(tg, tg + 2 * RPW * MOE_COLS, ga);
    tile_dot<T, RPW>(tg + RPW * MOE_COLS, tg + 2 * RPW * MOE_COLS, ua);
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    red[warp * MOE_COLS + 2 * lane + c] = ga[c];
    red[(MOE_WARPS + warp) * MOE_COLS + 2 * lane + c] = ua[c];
  }
  __syncthreads();
  if (tid < MOE_COLS && c0 + tid < I) {
    float gs = 0.f, us = 0.f;
#pragma unroll
    for (int w = 0; w < MOE_WARPS; ++w) {
      gs += red[w * MOE_COLS + tid];
      us += red[(MOE_WARPS + w) * MOE_COLS + tid];
    }
    float* out = part + ((size_t)z * gridDim.z + r) * 2 * I + c0 + tid;
    out[0] = gs;
    out[I] = us;
  }
}

// grid (column tiles, rows): y_r over columns [c0, c0 + 64) of H, the
// activation summed from the gate/up partials in split order
template <typename T, bool VEC, int STAGES>
__global__ void __launch_bounds__(MOE_THREADS)
moe_down_kernel(const float* __restrict__ part, const int* __restrict__ idx, const T* __restrict__ wd,
                T* __restrict__ ysel, int E, int H, int I, int splits, Glu p) {
  constexpr int RPW = DN_ROWS / MOE_WARPS;  // rows a warp stages a tile
  constexpr int WSTAGE = RPW * MOE_COLS;
  extern __shared__ __align__(16) unsigned char moe_smem[];
  T* tiles = reinterpret_cast<T*>(moe_smem);                                    // [MOE_WARPS][STAGES][WSTAGE]
  float* red = reinterpret_cast<float*>(tiles + MOE_WARPS * STAGES * WSTAGE);  // [MOE_WARPS][MOE_COLS]
  pdl_launch_dependents();  // the combine launch may start
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = blockIdx.x * MOE_COLS, r = blockIdx.y, R = gridDim.y;
  const int e = idx[r];
  if (e < 0 || e >= E) {
    pdl_wait();
    if (tid < MOE_COLS && c0 + tid < H) ysel[(size_t)r * H + c0 + tid] = from_float<T>(quiet_nan());
    return;  // uniform over the block
  }
  const int cw = (I + MOE_WARPS - 1) / MOE_WARPS;  // each warp's chunk of I
  const int cwp = (cw + RPW - 1) / RPW * RPW;
  const int iw = warp * cw;                           // the warp's first row
  const int n = max(0, min(cw, I - iw));              // its rows in I
  const int nt = (n + RPW - 1) / RPW;
  float* as = red + MOE_WARPS * MOE_COLS + warp * cwp;  // its activations [cwp]
  T* mine = tiles + warp * STAGES * WSTAGE;
  const T* d = wd + (size_t)e * I * H;
  auto stage = [&](int j) {
    stage_rows<T, VEC, RPW>(mine + (j % STAGES) * WSTAGE, d, iw + j * RPW, min(RPW, n - j * RPW), c0, H, H);
  };
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < nt) stage(j);
    cp_async_commit();
  }
  // the warp's activations: the splits' (g, u) in split order, the GLU,
  // rounded to the weight dtype; zeros past its rows
  pdl_wait();  // the gate/up launch is complete and its partials visible
  for (int q = lane; q < nt * RPW; q += 32) {
    float a = 0.f;
    if (q < n) {
      float gs = 0.f, us = 0.f;
      for (int zz = 0; zz < splits; ++zz) {
        const float* pz = part + ((size_t)zz * R + r) * 2 * I + iw + q;
        gs += pz[0];
        us += pz[I];
      }
      a = to_float(from_float<T>(glu(gs, us, p)));
    }
    as[q] = a;
  }

  float ya[2] = {0.f, 0.f};
  for (int j = 0; j < nt; ++j) {
    cp_async_wait<STAGES - 2>();
    __syncwarp();  // tile j and the activations visible to every lane
    if (j + STAGES - 1 < nt) stage(j + STAGES - 1);
    cp_async_commit();
    tile_dot<T, RPW>(mine + (j % STAGES) * WSTAGE, as + j * RPW, ya);
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) red[warp * MOE_COLS + 2 * lane + c] = ya[c];
  __syncthreads();
  if (tid < MOE_COLS && c0 + tid < H) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < MOE_WARPS; ++w) s += red[w * MOE_COLS + tid];
    ysel[(size_t)r * H + c0 + tid] = from_float<T>(s);  // the selection's output in x's dtype
  }
}

template <typename T>
__global__ void __launch_bounds__(MOE_THREADS)
moe_combine_kernel(const T* __restrict__ ysel, const float* __restrict__ topk_w, T* __restrict__ out, int k,
                   int H) {
  pdl_wait();  // the down launch is complete
  const int t = blockIdx.y;
  const int h = blockIdx.x * MOE_THREADS + threadIdx.x;
  if (h >= H) return;
  float s = 0.f;
  for (int j = 0; j < k; ++j) s = fmaf(topk_w[t * k + j], to_float(ysel[(size_t)(t * k + j) * H + h]), s);
  out[(size_t)t * H + h] = from_float<T>(s);
}

template <typename T, bool VEC, int STAGES>
cudaError_t gate_up(const void* x, const int* idx, const void* wg, const void* wu, float* part, int R, int k, int E,
                    int H, int I, int splits, int per, cudaStream_t st) {
  const size_t smem = STAGES * (sizeof(T) * 2 * GU_ROWS * MOE_COLS + 16 * MOE_WARPS) +
                      sizeof(float) * 2 * MOE_WARPS * MOE_COLS;
  return launch_ex(moe_gate_up_kernel<T, VEC, STAGES>, dim3((I + MOE_COLS - 1) / MOE_COLS, splits, R),
                   dim3(MOE_THREADS), smem, st, false,
                static_cast<const T*>(x), idx, static_cast<const T*>(wg), static_cast<const T*>(wu), part, k, E, H, I,
                per);
}

template <typename T, bool VEC, int STAGES>
cudaError_t down(const float* part, const int* idx, const void* wd, void* ysel, int R, int E, int H, int I, int splits,
                 Glu p, cudaStream_t st) {
  constexpr int RPW = DN_ROWS / MOE_WARPS;
  const int cwp = ((I + MOE_WARPS - 1) / MOE_WARPS + RPW - 1) / RPW * RPW;  // a warp's activations
  const size_t smem = sizeof(T) * STAGES * DN_ROWS * MOE_COLS +
                      sizeof(float) * (MOE_WARPS * MOE_COLS + (size_t)MOE_WARPS * cwp);
  return launch_ex(moe_down_kernel<T, VEC, STAGES>, dim3((H + MOE_COLS - 1) / MOE_COLS, R), dim3(MOE_THREADS), smem,
                   st, true, part, idx,
                static_cast<const T*>(wd), static_cast<T*>(ysel), E, H, I, splits, p);
}

// the three launches, with gs and ds weight tiles in shared memory (2, 3,
// 4, 6 or 8: ops/moe_decode.py::MOE_STAGES)
template <typename T, bool VEC>
cudaError_t moe_launch(const void* x, const int* idx, const float* topk_w, const void* wg, const void* wu,
                       const void* wd, float* part, void* ysel, void* out, int T_, int k, int E, int H, int I,
                       int splits, int per, int gs, int ds, Glu p, cudaStream_t st) {
  const int R = T_ * k;
  cudaError_t err = cudaErrorInvalidValue;
  switch (gs) {
    case 2: err = gate_up<T, VEC, 2>(x, idx, wg, wu, part, R, k, E, H, I, splits, per, st); break;
    case 3: err = gate_up<T, VEC, 3>(x, idx, wg, wu, part, R, k, E, H, I, splits, per, st); break;
    case 4: err = gate_up<T, VEC, 4>(x, idx, wg, wu, part, R, k, E, H, I, splits, per, st); break;
    case 6: err = gate_up<T, VEC, 6>(x, idx, wg, wu, part, R, k, E, H, I, splits, per, st); break;
    case 8: err = gate_up<T, VEC, 8>(x, idx, wg, wu, part, R, k, E, H, I, splits, per, st); break;
  }
  if (err != cudaSuccess) return err;
  err = cudaErrorInvalidValue;
  switch (ds) {
    case 2: err = down<T, VEC, 2>(part, idx, wd, ysel, R, E, H, I, splits, p, st); break;
    case 3: err = down<T, VEC, 3>(part, idx, wd, ysel, R, E, H, I, splits, p, st); break;
    case 4: err = down<T, VEC, 4>(part, idx, wd, ysel, R, E, H, I, splits, p, st); break;
    case 6: err = down<T, VEC, 6>(part, idx, wd, ysel, R, E, H, I, splits, p, st); break;
    case 8: err = down<T, VEC, 8>(part, idx, wd, ysel, R, E, H, I, splits, p, st); break;
  }
  if (err != cudaSuccess) return err;
  return launch_ex(moe_combine_kernel<T>, dim3((H + MOE_THREADS - 1) / MOE_THREADS, T_), dim3(MOE_THREADS), 0, st, true,
                static_cast<const T*>(ysel), topk_w, static_cast<T*>(out), k, H);
}

}  // namespace
}  // namespace nxdi

// x (T, H); topk_idx (T, k) int32 and topk_w (T, k) fp32; w_gate, w_up
// (E, H, I) and w_down (E, I, H) in x's dtype; out (T, H) in x's dtype; all
// contiguous. Scratch: part, fp32 (splits, T * k, 2, I), the gate/up
// partial sums; ysel (T * k, H) in x's dtype, the selections' outputs.
// splits, per: H split into splits ranges of per rows (per a multiple of
// 32; ops/moe_decode.py::moe_h_split); gate_stages, down_stages: weight
// tiles in shared memory per block of each launch (2, 3, 4, 6 or 8;
// ops/moe_decode.py::moe_stages). act_kind: 0 silu, 1 gelu (tanh), 2
// clamped swiglu (act_scale, act_bias, swiglu_limit when has_limit).
// vec = 1 takes the 16-byte copies (rows of I and H elements a multiple of
// 16 bytes, 16-byte aligned bases of x and the weights). Three launches on
// the stream, one B7 launch.
extern "C" int nxdi_moe_decode(const void* x, const void* topk_idx, const void* topk_w, const void* w_gate,
                               const void* w_up, const void* w_down, float* part, void* ysel, void* out, int T,
                               int k, int E, int H, int I, int splits, int per, int gate_stages, int down_stages,
                               int dtype, int act_kind, float act_scale, float act_bias, float swiglu_limit,
                               int has_limit, int vec, void* stream) {
  using namespace nxdi;
  if (T < 1 || k < 1 || T * k > MOE_MAX_ROWS || E < 1 || H < 1 || I < 1 || act_kind < 0 || act_kind > 2)
    return (int)cudaErrorInvalidValue;
  if (splits < 1 || splits > MOE_MAX_SPLITS || per < 1 || per % GU_ROWS || (long long)(splits - 1) * per >= H ||
      (long long)splits * per < H)
    return (int)cudaErrorInvalidValue;
  const Glu p{act_kind, act_scale, act_bias, swiglu_limit, has_limit};
  const int* idx = static_cast<const int*>(topk_idx);
  const float* w = static_cast<const float*>(topk_w);
  const int gs = gate_stages, ds = down_stages;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32 && vec)
    return (int)moe_launch<float, true>(x, idx, w, w_gate, w_up, w_down, part, ysel, out, T, k, E, H, I, splits, per,
                                        gs, ds, p, st);
  if (dtype == kFloat32)
    return (int)moe_launch<float, false>(x, idx, w, w_gate, w_up, w_down, part, ysel, out, T, k, E, H, I, splits,
                                         per, gs, ds, p, st);
  if (dtype == kBFloat16 && vec)
    return (int)moe_launch<__nv_bfloat16, true>(x, idx, w, w_gate, w_up, w_down, part, ysel, out, T, k, E, H, I,
                                                splits, per, gs, ds, p, st);
  if (dtype == kBFloat16)
    return (int)moe_launch<__nv_bfloat16, false>(x, idx, w, w_gate, w_up, w_down, part, ysel, out, T, k, E, H, I,
                                                 splits, per, gs, ds, p, st);
  return (int)cudaErrorInvalidValue;
}
