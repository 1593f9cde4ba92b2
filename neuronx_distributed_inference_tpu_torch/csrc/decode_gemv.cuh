// The decode-sized matrix products of the fused decode layer (B8, B9) for
// Hopper (sm_90a): Y[r][n] = sum_k A[r][k] W[k][n] for a few rows r (the
// batch's new tokens) and a weight W (K, N) in the activation dtype, every
// product and sum in fp32.
//
// At decode each weight element is used by a handful of rows, far below the
// H100's ~295 FLOP/byte ridge: the products are bound by streaming W from
// memory once, so what counts is the bytes in flight. A block owns GV_COLS =
// 32 output columns (narrow, so that even a 2048-wide product runs 64
// column tiles) for up to GV_MAX_ROWS rows and its 8 warps split the
// block's range of K. A lane loads 16 bytes of a weight row at a time (8
// bf16 or 4 fp32 columns), so one warp load covers 8 bf16 (4 fp32) rows of
// the block's columns, and each lane issues U such loads (8, or 4 for two
// weights over 4 rows) before it uses any. Where the column tiles alone would not fill
// the card, the grid's z axis splits K (each block over at least 256 of it,
// at most GV_MAX_SPLITS ways) and the blocks store fp32 partial sums, which
// the consumer adds in split order. The lanes that share columns are added
// by an xor tree and the warps in warp order through shared memory: no
// atomics anywhere, so a result repeats from run to run.
//
// The A operand is a (rows, K) matrix in T (the normed input, the
// attention rows, the activations), staged GV_CHUNK values of K at a time
// into shared memory as fp32; each finished column goes to a sink functor,
//   sink(split, row, n, v)    v[m] = the sum over this block's range of K
//                             for weight m (NMAT = 2 reads two weights of
//                             one shape at once: gate and up).
// and, after the last column, sink.finish(r0, rt) runs in every thread.
// A column past N and a K range past K are masked: any N and K work, with
// 16-byte loads where N is a multiple of 16 bytes and the weights 16-byte
// aligned (vec), element loads otherwise and at the ragged column edge.
// rmsnorm_rows writes the normed input the Pallas kernels feed their
// products, and residual_sum adds the split partial sums to x (B9's
// launches). B8 folds both into its GEMVs: GV_NORM stages the normed input
// itself, and ResidualSink's last split block adds the residual.

#pragma once

#include "common.cuh"

namespace nxdi {

constexpr int GV_THREADS = 256;
constexpr int GV_WARPS = GV_THREADS / 32;
constexpr int GV_COLS = 32;
constexpr int GV_MAX_ROWS = 4;
constexpr int GV_CHUNK = 2048;
constexpr int GV_MAX_SPLITS = 16;

// round an fp32 value to T's precision and back
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// The A operand's prologue and the launch's place in a chain of
// programmatic dependent launches (common.cuh), as template flags:
//   GV_NORM     stage rmsnorm(A) * gamma, rounded to T, in place of A: each
//               block computes its rows' rsqrt(mean(x^2) + eps) itself in
//               rmsnorm_rows's order (the block's threads as that kernel's,
//               an xor tree in each warp, then warp by warp), so the staged
//               values are rmsnorm_rows's normed input bit for bit;
//   GV_WAIT     A is the output of the launch before this one: the block
//               waits for it (pdl_wait) before it stages A;
//   GV_PREFETCH with GV_WAIT: before it waits, the block prefetches its
//               weight tile into L2, so the wait overlaps the weight reads;
//   GV_TRIGGER  the launch after this one may start at once.
enum : int { GV_NORM = 1, GV_WAIT = 2, GV_TRIGGER = 4, GV_PREFETCH = 8 };

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

template <typename T, int NMAT, int RT, class Sink, int FLAGS>
__global__ void __launch_bounds__(GV_THREADS)
gemv_kernel(const T* __restrict__ A, const T* __restrict__ w0, const T* __restrict__ w1, int K, int N, int rows,
            int k_per_split, int vec, Sink sink, const T* __restrict__ gamma, float eps) {
  constexpr int V = Vec16<T>::N;      // columns a lane loads at once (16 bytes)
  constexpr int LPR = GV_COLS / V;    // lanes that share one weight row
  constexpr int RPW = 32 / LPR;       // weight rows one warp load covers
  // warp loads a lane issues before using them: 8, or 4 where the sums of
  // two weights over 4 rows leave too few registers for 8
  constexpr int U = NMAT * RT <= 4 ? 8 : 4;
  extern __shared__ float gv_smem[];
  float* As = gv_smem;                                 // [RT][GV_CHUNK]
  float* red = As + RT * GV_CHUNK;                     // [NMAT][GV_WARPS][RT][GV_COLS]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane / LPR;  // the lane's row within a warp load
  const int r0 = blockIdx.y * RT;
  const int rt = min(RT, rows - r0);
  const int split = blockIdx.z;
  const int k0 = split * k_per_split;
  const int k1 = min(K, k0 + k_per_split);

  if (FLAGS & GV_TRIGGER) pdl_launch_dependents();
  if (FLAGS & GV_PREFETCH) {
    // rows [k0, k1) of the block's columns, 32 bytes a prefetch
    const int per_row = (min(GV_COLS, N - (int)blockIdx.x * GV_COLS) * (int)sizeof(T) + 31) / 32;
    for (int i = threadIdx.x; i < (k1 - k0) * per_row; i += GV_THREADS) {
      const size_t off = (size_t)(k0 + i / per_row) * N + blockIdx.x * GV_COLS;
      const int byte = (i % per_row) * 32;
      prefetch_l2(reinterpret_cast<const char*>(w0 + off) + byte);
      if (NMAT == 2) prefetch_l2(reinterpret_cast<const char*>(w1 + off) + byte);
    }
  }
  if (FLAGS & GV_WAIT) pdl_wait();
  float inv[RT];  // GV_NORM: each row's rsqrt(mean(x^2) + eps)
  if (FLAGS & GV_NORM) {
    __shared__ float part[RT][GV_WARPS];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      float s = 0.f;
      if (r < rt) {
        const T* row = A + (size_t)(r0 + r) * K;
#pragma unroll 4
        for (int h = threadIdx.x; h < K; h += GV_THREADS) {
          const float v = to_float(row[h]);
          s = fmaf(v, v, s);
        }
      }
      s = group_sum<32>(s);
      if (lane == 0) part[r][warp] = s;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < GV_WARPS; ++w) t += part[r][w];
      inv[r] = rsqrtf(t / K + eps);
    }
  }
  // A[r][k] as staged: as stored, or its normed value rounded to T
  auto a_val = [&](int r, int k) {
    const float a = to_float(A[(size_t)(r0 + r) * K + k]);
    return (FLAGS & GV_NORM) ? round_to<T>(a * inv[r] * to_float(gamma[k])) : a;
  };

  const int col = blockIdx.x * GV_COLS + (lane % LPR) * V;
  const T* w[2] = {w0 + col, (NMAT == 2 ? w1 : w0) + col};
  const bool wide = vec && col + V <= N;
  float acc[NMAT][RT][V];
#pragma unroll
  for (int m = 0; m < NMAT; ++m)
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < V; ++c) acc[m][r][c] = 0.f;

  for (int kc = k0; kc < k1; kc += GV_CHUNK) {
    const int kn = min(GV_CHUNK, k1 - kc);
    __syncthreads();  // the last chunk's readers are done
    for (int kb = threadIdx.x; kb < kn; kb += GV_THREADS * 4) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = kb + j * GV_THREADS;
        if (kk < kn) {
#pragma unroll
          for (int r = 0; r < RT; ++r) As[r * GV_CHUNK + kk] = r < rt ? a_val(r, kc + kk) : 0.f;
        }
      }
    }
    __syncthreads();
    const int per_warp = (kn + GV_WARPS - 1) / GV_WARPS;
    const int h0 = warp * per_warp;
    const int h1 = min(kn, h0 + per_warp);
    if (wide) {
      for (int h = h0; h < h1; h += U * RPW) {
        uint4 raw[NMAT][U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          // rows past the warp's range are clamped to its last and weighted 0
          const size_t off = (size_t)(kc + min(h + u * RPW + sub, h1 - 1)) * N;
#pragma unroll
          for (int m = 0; m < NMAT; ++m) raw[m][u] = __ldg(reinterpret_cast<const uint4*>(w[m] + off));
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int hs = h + u * RPW + sub;
          const bool ok = hs < h1;
          float a[RT];
#pragma unroll
          for (int r = 0; r < RT; ++r) a[r] = ok ? As[r * GV_CHUNK + min(hs, h1 - 1)] : 0.f;
#pragma unroll
          for (int m = 0; m < NMAT; ++m) {
            float v[V];
            Vec16<T>::unpack(raw[m][u], v);
#pragma unroll
            for (int r = 0; r < RT; ++r)
#pragma unroll
              for (int c = 0; c < V; ++c) acc[m][r][c] = fmaf(a[r], v[c], acc[m][r][c]);
          }
        }
      }
    } else {
      for (int h = h0 + sub; h < h1; h += RPW) {
        const size_t off = (size_t)(kc + h) * N;
#pragma unroll
        for (int c = 0; c < V; ++c) {
          if (col + c >= N) continue;
#pragma unroll
          for (int m = 0; m < NMAT; ++m) {
            const float v = to_float(w[m][off + c]);
#pragma unroll
            for (int r = 0; r < RT; ++r) acc[m][r][c] = fmaf(As[r * GV_CHUNK + h], v, acc[m][r][c]);
          }
        }
      }
    }
  }

  // the lanes that share columns hold sums over different rows: add them in
  // a fixed order (an xor tree over the lane bits above LPR)
#pragma unroll
  for (int m = 0; m < NMAT; ++m)
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < V; ++c)
#pragma unroll
        for (int o = LPR; o < 32; o <<= 1) acc[m][r][c] += __shfl_xor_sync(0xffffffffu, acc[m][r][c], o);
  if (sub == 0) {
#pragma unroll
    for (int m = 0; m < NMAT; ++m)
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int c = 0; c < V; ++c) red[((m * GV_WARPS + warp) * RT + r) * GV_COLS + lane * V + c] = acc[m][r][c];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rt * GV_COLS; i += GV_THREADS) {
    const int r = i / GV_COLS, c = i % GV_COLS;
    const int n = blockIdx.x * GV_COLS + c;
    if (n >= N) continue;
    float v[NMAT];
#pragma unroll
    for (int m = 0; m < NMAT; ++m) {
      float s = 0.f;
#pragma unroll
      for (int wp = 0; wp < GV_WARPS; ++wp) s += red[((m * GV_WARPS + wp) * RT + r) * GV_COLS + c];
      v[m] = s;
    }
    sink(split, r0 + r, n, v);
  }
  sink.finish(r0, rt);
}

template <int RT, int NMAT>
constexpr size_t gemv_smem() {
  return sizeof(float) * ((size_t)RT * GV_CHUNK + (size_t)NMAT * GV_WARPS * RT * GV_COLS);
}

template <typename T, int NMAT, int RT, int FLAGS, class Sink>
cudaError_t gemv_launch_rt(const T* A, const T* w0, const T* w1, int K, int N, int rows, int splits,
                           int k_per_split, int vec, Sink sink, cudaStream_t stream, const T* gamma, float eps) {
  const dim3 grid((N + GV_COLS - 1) / GV_COLS, (rows + RT - 1) / RT, splits);
  if (FLAGS & GV_TRIGGER) {
    // the launch after this one starts while this one runs: its blocks need
    // room beside these, so the SMs keep their most shared memory (not L1)
    const cudaError_t err = cudaFuncSetAttribute(gemv_kernel<T, NMAT, RT, Sink, FLAGS>,
                                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  return launch_ex(gemv_kernel<T, NMAT, RT, Sink, FLAGS>, grid, dim3(GV_THREADS), gemv_smem<RT, NMAT>(), stream,
                   (FLAGS & GV_WAIT) != 0, A, w0, w1, K, N, rows, k_per_split, vec, sink, gamma, eps);
}

// Y = A W (and A W1 for NMAT = 2) over A's `rows` rows, the rows per block
// the least power of two that holds them (at most GV_MAX_ROWS); FLAGS and
// gamma / eps: the prologue and the launch chain (gemv_kernel)
template <typename T, int NMAT, class Sink, int FLAGS = 0>
cudaError_t gemv_launch(const T* A, const T* w0, const T* w1, int K, int N, int rows, int splits, int k_per_split,
                        int vec, Sink sink, cudaStream_t st, const T* gamma = nullptr, float eps = 0.f) {
  if (splits < 1 || splits > GV_MAX_SPLITS) return cudaErrorInvalidValue;
  if (rows <= 1)
    return gemv_launch_rt<T, NMAT, 1, FLAGS>(A, w0, w1, K, N, rows, splits, k_per_split, vec, sink, st, gamma, eps);
  if (rows <= 2)
    return gemv_launch_rt<T, NMAT, 2, FLAGS>(A, w0, w1, K, N, rows, splits, k_per_split, vec, sink, st, gamma, eps);
  return gemv_launch_rt<T, NMAT, 4, FLAGS>(A, w0, w1, K, N, rows, splits, k_per_split, vec, sink, st, gamma, eps);
}

// ---- the normed input ------------------------------------------------------

// normed = rmsnorm(x) (rows, H) with gamma (H,), in fp32 as the Pallas kernels
// compute it, (x * rsqrt(mean(x^2) + eps)) * gamma, rounded to T once: one
// block per row, its threads' sums of squares added in a fixed order (an
// xor tree within each warp, then warp by warp)
template <typename T>
__global__ void __launch_bounds__(GV_THREADS)
rmsnorm_rows_kernel(const T* __restrict__ x, const T* __restrict__ gamma, T* __restrict__ normed, int H, float eps) {
  __shared__ float part[GV_WARPS];
  const T* row = x + (size_t)blockIdx.x * H;
  float s = 0.f;
#pragma unroll 4
  for (int h = threadIdx.x; h < H; h += GV_THREADS) {
    const float v = to_float(row[h]);
    s = fmaf(v, v, s);
  }
  s = group_sum<32>(s);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = s;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < GV_WARPS; ++w) t += part[w];
  const float inv = rsqrtf(t / H + eps);
  for (int h = threadIdx.x; h < H; h += GV_THREADS)
    normed[(size_t)blockIdx.x * H + h] = from_float<T>(to_float(row[h]) * inv * to_float(gamma[h]));
}

template <typename T>
cudaError_t rmsnorm_rows(const T* x, const T* gamma, T* normed, int rows, int H, float eps, cudaStream_t stream) {
  rmsnorm_rows_kernel<T><<<rows, GV_THREADS, 0, stream>>>(x, gamma, normed, H, eps);
  return cudaGetLastError();
}

// ---- sinks -----------------------------------------------------------------

// fp32 partial sums (splits, rows, N)
struct PartialSink {
  float* part;
  int rows, N;

  __device__ void operator()(int split, int row, int n, const float* v) const {
    part[((size_t)split * rows + row) * N + n] = v[0];
  }
  __device__ void finish(int, int) const {}
};

// the gated activation of gate (v[0]) and up (v[1]), rounded to T
template <typename T>
struct GluSink {
  T* act;
  int N;
  Glu glu_kind;

  __device__ void operator()(int, int row, int n, const float* v) const {
    act[(size_t)row * N + n] = from_float<T>(glu(v[0], v[1], glu_kind));
  }
  __device__ void finish(int, int) const {}
};

// out = x + the sum over the K splits (the grid's z axis), in split order,
// rounded once to T: residual_sum's arithmetic, without its launch. Each
// block stores its fp32 partial sums (splits, rows, N); the last of a
// column tile's split blocks (a completion counter per tile, last_block)
// adds them. With one split the block writes out itself.
template <typename T>
struct ResidualSink {
  float* part;
  const T* x;
  T* out;
  unsigned* counter;  // one per (row tile, column tile), 0 between launches
  int rows, N;

  __device__ void operator()(int split, int row, int n, const float* v) const {
    if (gridDim.z == 1) {
      float s = 0.f;
      s += v[0];
      out[(size_t)row * N + n] = from_float<T>(to_float(x[(size_t)row * N + n]) + s);
    } else {
      part[((size_t)split * rows + row) * N + n] = v[0];
    }
  }
  __device__ void finish(int r0, int rt) const {
    if (gridDim.z == 1 || !last_block(counter + blockIdx.y * gridDim.x + blockIdx.x, gridDim.z)) return;
    for (int i = threadIdx.x; i < rt * GV_COLS; i += GV_THREADS) {
      const int row = r0 + i / GV_COLS, n = blockIdx.x * GV_COLS + i % GV_COLS;
      if (n >= N) continue;
      float s = 0.f;
      for (int z = 0; z < (int)gridDim.z; ++z) s += __ldcg(part + ((size_t)z * rows + row) * N + n);
      out[(size_t)row * N + n] = from_float<T>(to_float(x[(size_t)row * N + n]) + s);
    }
  }
};

// ---- the residual ------------------------------------------------------------

// out = x + sum over splits of part (splits, rows * N), the sum in split
// order, rounded once to T
template <typename T>
__global__ void residual_sum_kernel(const T* __restrict__ x, const float* __restrict__ part, T* __restrict__ out,
                                    int splits, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[(size_t)z * n + i];
  out[i] = from_float<T>(to_float(x[i]) + s);
}

template <typename T>
cudaError_t residual_sum(const T* x, const float* part, T* out, int splits, int n, cudaStream_t stream) {
  residual_sum_kernel<T><<<(n + 255) / 256, 256, 0, stream>>>(x, part, out, splits, n);
  return cudaGetLastError();
}

}  // namespace nxdi
