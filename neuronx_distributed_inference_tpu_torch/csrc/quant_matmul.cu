// int4 fused-dequant matmul for Hopper (sm_90a): kernel B6 of the port.
//
// Replaces the TPU kernel neuronx_distributed_inference_tpu/ops/
// quant_matmul.py::quant_matmul (_qmm_kernel).
//
// What it computes: out (rows, N) = x (rows, K) @ dequant(packed, scale),
// rows 1..64, x bf16 or fp32, out in x's dtype, every sum in fp32.
//   packed: uint8 (Kp/2, N), N-contiguous, midpoint split: byte row j holds
//     code k = j in its low nibble and k = Kp/2 + j in its high nibble; a
//     code is q + 8 (0x88 is the zero pad). Kp is a multiple of 256.
//   scale: fp32 (Kp/128, N); groups 0 .. Kp/256 - 1 cover the low plane,
//     the rest the high plane.
// For each group of 128 k, the partial dot over the codes (q = code - 8)
// is multiplied by that group's scale AFTER the dot, as the TPU kernel
// does. The dequantized matrix never exists in memory. x reads as zero past
// K, so the pad rows of a K that is not a multiple of 256 add nothing.
//
// What bounds it on an H100: at decode row counts it reads 0.5 byte of
// codes and 1/32 byte of scale per weight for 2 * rows FLOP, a few FLOP per
// byte, far below the card's ~295 FLOP/byte ridge: memory bandwidth bounds
// it (the 8B up projection at 1 row moves 31.2 MB, 0.0093 ms at
// 3.35 TB/s). The design reads every code byte once per row tile and keeps
// the arithmetic light enough not to stand in the way:
//   - Threads lie along N: lane l of a warp owns columns n0 + 4l .. 4l + 3
//     and loads their 4 code bytes of one byte row as one 32-bit word, so a
//     warp reads 128 contiguous bytes per byte row (byte loads where N % 4
//     or the base alignment rule that out, and at the ragged N edge). Each
//     lane keeps 16 such words in flight.
//   - A block (256 threads, 8 warps) owns 128 columns and one tile of RT
//     rows (RT = 1, 2, 4 or 8: the smallest power of two >= rows, capped at
//     8; the grid's y axis covers rows up to 64). Its warps split K: warp w
//     takes the group pairs w, w + 8, ...; pair g is byte rows
//     [128 g, 128 g + 128), which hold low-plane group g and high-plane
//     group Kp/256 + g.
//   - x is staged through shared memory one group pair at a time, per
//     warp: RT rows x 128 (low, high) fp32 pairs, read back as one 8-byte
//     broadcast per row and byte row.
//   - Each lane keeps fp32 accumulators in registers: the pair's low and
//     high partial dots and the scaled total, RT x 4 of each.
//   - A code becomes a float without an int-to-float conversion (a quarter-
//     rate instruction): as_float(0x4B000000 | nibble) - (2^23 + 8) is
//     exactly nibble - 8.
//   - The 8 warps' totals are reduced in shared memory in warp order (no
//     float atomics), so the output is the same from run to run.
// Blocks: ceil(N / 128) x ceil(rows / RT). At one row: 48 for the 8B fused
// QKV (N 6144), 32 for o and down (N 4096), 112 for gate and up
// (N 14336), 1002 for the lm head (N 128256); at 1B widths 24 (QKV 3072),
// 16 (o, down 2048), 64 (gate, up 8192), 1002 (lm head). So N = 4096 keeps
// 32 of the 132 SMs busy: splitting K over blocks (with a second pass) and
// tensor-core tiles are later steps.

#include <stdint.h>

#include "common.cuh"

namespace nxdi {
namespace {

constexpr int QMM_THREADS = 256;
constexpr int QMM_WARPS = QMM_THREADS / 32;
constexpr int QMM_COLS = 128;  // columns per block: 32 lanes x 4
constexpr int QMM_GROUP = 128;  // k per scale group = byte rows per group pair
constexpr int QMM_MAX_ROWS = 64;
constexpr int QMM_INFLIGHT = 16;  // code words a lane loads before using them

template <int RT>
__host__ __device__ constexpr size_t qmm_smem_bytes() {
  // x staging, per warp RT x 128 float2; the reduction (per warp RT x 128
  // floats) reuses the space once every warp is done with x
  return (size_t)QMM_WARPS * RT * QMM_GROUP * sizeof(float2);
}

// nibble (0..15) -> nibble - 8 as a float, exactly
__device__ __forceinline__ float code_value(uint32_t nibble) {
  return __int_as_float(0x4B000000u | nibble) - 8388616.0f;
}

// the 4 code bytes of columns n0 .. n0 + 3 in one byte row; columns past N
// read as the zero pad 0x88
__device__ __forceinline__ uint32_t load_codes(const uint8_t* p, int n0, int N, int vec) {
  if (vec && n0 + 3 < N) return __ldg(reinterpret_cast<const uint32_t*>(p));
  uint32_t w = 0x88888888u;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (n0 + c < N) w = (w & ~(0xFFu << (8 * c))) | ((uint32_t)__ldg(p + c) << (8 * c));
  }
  return w;
}

template <typename T, int RT>
__global__ void __launch_bounds__(QMM_THREADS)
qmm_kernel(const T* __restrict__ x, const uint8_t* __restrict__ packed,
           const float* __restrict__ scale, T* __restrict__ out,
           int rows, int K, int k_half, int N, int vec) {
  extern __shared__ float2 qmm_smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.y * RT;
  const int n0 = blockIdx.x * QMM_COLS + lane * 4;
  const int pairs = k_half / QMM_GROUP;
  float2* xs = qmm_smem + (size_t)warp * RT * QMM_GROUP;

  float acc[RT][4];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int g = warp; g < pairs; g += QMM_WARPS) {
    const int j0 = g * QMM_GROUP;
    // stage this pair's x: (x[row][j0 + j], x[row][k_half + j0 + j])
    __syncwarp();
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int row = row0 + r;
#pragma unroll
      for (int i = 0; i < QMM_GROUP / 32; ++i) {
        const int j = lane + 32 * i;
        const int klo = j0 + j;
        const int khi = k_half + j0 + j;
        float lo = 0.f, hi = 0.f;
        if (row < rows) {
          const T* xr = x + (size_t)row * K;
          if (klo < K) lo = to_float(xr[klo]);
          if (khi < K) hi = to_float(xr[khi]);
        }
        xs[r * QMM_GROUP + j] = make_float2(lo, hi);
      }
    }
    __syncwarp();

    float plo[RT][4], phi[RT][4];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) plo[r][c] = phi[r][c] = 0.f;

    const uint8_t* pg = packed + (size_t)j0 * N + n0;
    for (int jb = 0; jb < QMM_GROUP; jb += QMM_INFLIGHT) {
      uint32_t words[QMM_INFLIGHT];
#pragma unroll
      for (int u = 0; u < QMM_INFLIGHT; ++u)
        words[u] = load_codes(pg + (size_t)(jb + u) * N, n0, N, vec);
#pragma unroll
      for (int u = 0; u < QMM_INFLIGHT; ++u) {
        const uint32_t lo4 = words[u] & 0x0F0F0F0Fu;
        const uint32_t hi4 = (words[u] >> 4) & 0x0F0F0F0Fu;
        float cl[4], ch[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          cl[c] = code_value((lo4 >> (8 * c)) & 0xFFu);
          ch[c] = code_value((hi4 >> (8 * c)) & 0xFFu);
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float2 xv = xs[r * QMM_GROUP + jb + u];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            plo[r][c] = fmaf(xv.x, cl[c], plo[r][c]);
            phi[r][c] = fmaf(xv.y, ch[c], phi[r][c]);
          }
        }
      }
    }

    // this pair's two groups: each partial dot times its scale
    float slo[4], shi[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + c;
      slo[c] = n < N ? __ldg(scale + (size_t)g * N + n) : 0.f;
      shi[c] = n < N ? __ldg(scale + (size_t)(pairs + g) * N + n) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[r][c] = fmaf(phi[r][c], shi[c], fmaf(plo[r][c], slo[c], acc[r][c]));
  }

  // the warps' totals, summed in warp order
  __syncthreads();
  float4* red = reinterpret_cast<float4*>(qmm_smem);  // [warp][r][32 lanes]
#pragma unroll
  for (int r = 0; r < RT; ++r)
    red[(warp * RT + r) * 32 + lane] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  const float* redf = reinterpret_cast<const float*>(qmm_smem);
  for (int idx = threadIdx.x; idx < RT * QMM_COLS; idx += QMM_THREADS) {
    const int r = idx / QMM_COLS;
    const int col = idx % QMM_COLS;
    const int row = row0 + r;
    const int n = blockIdx.x * QMM_COLS + col;
    if (row >= rows || n >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < QMM_WARPS; ++w) s += redf[(w * RT + r) * QMM_COLS + col];
    out[(size_t)row * N + n] = from_float<T>(s);
  }
}

template <typename T, int RT>
cudaError_t qmm_launch(const void* x, const void* packed, const float* scale, void* out,
                       int rows, int K, int k_half, int N, int vec, cudaStream_t stream) {
  constexpr size_t smem = qmm_smem_bytes<RT>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(qmm_kernel<T, RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((N + QMM_COLS - 1) / QMM_COLS, (rows + RT - 1) / RT);
  qmm_kernel<T, RT><<<grid, QMM_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(packed), scale, static_cast<T*>(out),
      rows, K, k_half, N, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t qmm_dispatch(const void* x, const void* packed, const float* scale, void* out,
                         int rows, int K, int k_half, int N, int vec, cudaStream_t st) {
  if (rows <= 1) return qmm_launch<T, 1>(x, packed, scale, out, rows, K, k_half, N, vec, st);
  if (rows <= 2) return qmm_launch<T, 2>(x, packed, scale, out, rows, K, k_half, N, vec, st);
  if (rows <= 4) return qmm_launch<T, 4>(x, packed, scale, out, rows, K, k_half, N, vec, st);
  return qmm_launch<T, 8>(x, packed, scale, out, rows, K, k_half, N, vec, st);
}

}  // namespace
}  // namespace nxdi

// x (rows, K) contiguous; packed (k_half, N) uint8 contiguous, k_half =
// Kp / 2 a multiple of 128; scale (Kp / 128, N) fp32 contiguous; out (rows,
// N) contiguous in x's dtype. vec = 1 allows 4-byte code loads (N % 4 == 0
// and a 4-byte aligned base).
extern "C" int nxdi_quant_matmul(const void* x, const void* packed, const void* scale, void* out,
                                 int rows, int K, int k_half, int N, int dtype, int vec, void* stream) {
  using namespace nxdi;
  if (rows < 1 || rows > QMM_MAX_ROWS || k_half <= 0 || k_half % QMM_GROUP != 0 || K < 1 ||
      K > 2 * k_half || N < 1)
    return (int)cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return (int)qmm_dispatch<float>(x, packed, s, out, rows, K, k_half, N, vec, st);
  if (dtype == kBFloat16) return (int)qmm_dispatch<__nv_bfloat16>(x, packed, s, out, rows, K, k_half, N, vec, st);
  return (int)cudaErrorInvalidValue;
}
