// The decode-sized matrix products of the fused decode layer (B8, B9) for
// Hopper (sm_90a): Y[r][n] = sum_k A[r][k] W[k][n] for the rows r of A (the
// batch's new tokens) and a weight W (K, N) in the activation dtype, every
// product and sum in fp32. B8 runs its QKV and o-proj products on this loop,
// B9 its gate/up and down products.
//
// At decode each weight element is used by a few rows, far below the H100's
// ~295 FLOP/byte ridge: the products are bound by streaming W from memory
// once, so what counts is the bytes in flight and that no weight is read
// twice. The design:
//   - A block owns GV_COLS = 128 output columns (a bf16 weight row is 256
//     contiguous bytes) and one split of K; the grid is (column tiles, 1,
//     splits). Where the column tiles alone do not fill the card, K is split
//     (ops/decode_block.py::gemv_split: about two blocks an SM, each over a
//     multiple of GV_K_ALIGN rows of K, at most GV_MAX_SPLITS), and the
//     blocks store fp32 partial sums that the sink adds in split order.
//   - The block's weight rows stream through a ring of GV_STAGES shared
//     stages of GV_STAGE_BYTES (16-byte cp.async copies), the next stages in
//     flight while one is used, one barrier a stage (3 stages of 16 KB ran
//     faster than 4 or 6 at every timed point). The first stages are issued
//     before the rmsnorm prologue, before A is staged and before the wait
//     for the launch before (the weights depend on neither). Only x's rows
//     and gamma's range go ahead of them, in one group of copies where they
//     fit GV_XS_BYTES: an SM's loads queue behind its copies, and x read
//     after the weights' first stages arrived several us later.
//   - Rows are not on the grid: a block holds every row of A, so each weight
//     is streamed once for up to GV_MAX_ROWS rows; past that the block loops
//     over its row groups of GV_MAX_ROWS (each pass streams the weights
//     again). A is staged into a shared slab of up to GV_SLAB_BYTES, a range
//     of K at a time.
//   - Two bodies on the same ring. bf16 with more than GV_FMA_ROWS rows: the
//     tensor cores, mma.sync m16n8k16 (mma.cuh) with the rows as M padded to
//     16, 32, 48 or 64; warp w owns columns [16 w, 16 w + 16) over the whole
//     K range, its B fragments by ldmatrix.trans from the ring. Otherwise
//     (and always in fp32) fp32 FMAs, the rows in tiles of 1, 2 or 4: a lane
//     reads 16 bytes of a weight row, the warps split each stage's rows, and
//     the lanes and then the warps are added in a fixed order.
// No atomics in any sum: a result repeats from run to run. The last split
// block of a column tile adds the splits' partials, a batch of splits'
// loads in flight before any is added.
//
// Each finished value goes to a sink functor,
//   sink(split, row, n, v)    v[m] = the sum over this block's range of K
//                             for weight m (NMAT = 2 reads two weights of
//                             one shape at once: gate and up),
// and after the block's last row, sink.finish(rows) runs in every thread.
// A column past N and rows of K past the split are masked: any N and K
// work, with 16-byte copies where N is a multiple of 16 bytes and the
// weights 16-byte aligned, element loads otherwise.

#pragma once

#include <type_traits>

#include "mma.cuh"

namespace nxdi {

constexpr int GV_THREADS = 256;
constexpr int GV_WARPS = GV_THREADS / 32;
constexpr int GV_COLS = 128;           // output columns a block owns
constexpr int GV_STAGES = 3;           // weight stages in the ring
constexpr int GV_STAGE_BYTES = 16384;  // weight bytes one stage holds (both weights where NMAT = 2)
constexpr int GV_PAD = 16;             // bytes after each shared weight row (ldmatrix without bank conflicts)
constexpr int GV_MAX_ROWS = 64;        // rows one pass of the tensor-core body holds
constexpr int GV_FMA_ROWS = 2;         // bf16 products of at most this many rows take the FMA body
constexpr int GV_SLAB_BYTES = 32768;   // the most bytes of A a block stages at once
constexpr int GV_XS_BYTES = 24576;     // GV_NORM: x's rows and gamma's range staged whole
constexpr int GV_K_ALIGN = 64;         // a split's range of K is a multiple of this (of every stage)
constexpr int GV_MAX_SPLITS = 16;

// The A operand's prologue and the launch's place in a chain of
// programmatic dependent launches (common.cuh), as template flags:
//   GV_NORM     stage rmsnorm(A) * gamma, rounded to T, in place of A: each
//               block computes its rows' rsqrt(mean(x^2) + eps) itself in
//               the order of a one-block-per-row rmsnorm of GV_THREADS
//               threads (each thread's squares in order, an xor tree in
//               each warp, then warp by warp), then x * inv * gamma rounded
//               once;
//   GV_WAIT     A is the output of the launch before this one: the block
//               issues its first weight stages, then waits for it
//               (pdl_wait) before it stages A;
//   GV_TRIGGER  the launch after this one may start at once.
enum : int { GV_NORM = 1, GV_WAIT = 2, GV_TRIGGER = 4 };

// The ring's geometry for NMAT weights of T
template <typename T, int NMAT>
struct GvRing {
  static constexpr int V = Vec16<T>::N;                                      // elements a 16-byte copy moves
  static constexpr int CPR = GV_COLS / V;                                    // copies per weight row
  static constexpr int KS = GV_STAGE_BYTES / (NMAT * GV_COLS * (int)sizeof(T));  // rows of K a stage holds
  static constexpr int WLD = GV_COLS * (int)sizeof(T) + GV_PAD;              // bytes per shared weight row
  static constexpr int MAT = KS * WLD;                                       // one weight's bytes in a stage
  static constexpr int STAGE = NMAT * MAT;
  static constexpr int BYTES = GV_STAGES * STAGE;
  static_assert(GV_K_ALIGN % KS == 0 && KS % 16 == 0, "a split's range holds whole stages of k16 steps");
};

// The slab's range of K for ROWS rows: the split's range rounded up to
// GV_K_ALIGN, at most what GV_SLAB_BYTES holds (a multiple of GV_K_ALIGN,
// so that a stage never straddles two ranges)
template <typename T, int ROWS>
__host__ __device__ constexpr int gv_slab_k(int kps) {
  constexpr int most = GV_SLAB_BYTES / (ROWS * (int)sizeof(T)) / GV_K_ALIGN * GV_K_ALIGN;
  const int want = (kps + GV_K_ALIGN - 1) / GV_K_ALIGN * GV_K_ALIGN;
  return want < most ? want : most;
}

// One product's operands and shapes
template <typename T>
struct GemvArgs {
  const T* A;      // (rows, K)
  const T* w0;     // (K, N)
  const T* w1;     // (K, N): the second weight where NMAT = 2
  const T* gamma;  // (K,): GV_NORM
  float eps;
  int K, N, rows;
  int kps;   // rows of K per split, a multiple of GV_K_ALIGN
  int vec;   // 1: 16-byte weight copies (set by gemv_launch)
  int avec;  // 1: 16-byte loads of A and gamma (set by gemv_launch)
  int xs;    // 1: GV_NORM stages x's rows and gamma's range whole (set by gemv_launch_body)
};

template <typename T, int NMAT, int ROWS, bool MMA, class Sink, int FLAGS>
__global__ void __launch_bounds__(GV_THREADS, 2) gemv_kernel(const GemvArgs<T> p, Sink sink) {
  using R = GvRing<T, NMAT>;
  constexpr int V = R::V, KS = R::KS;
  extern __shared__ __align__(16) unsigned char gv_smem[];  // the ring, then the slab [ROWS][ald]
  __shared__ float part_s[ROWS][GV_WARPS];                   // GV_NORM: each warp's sum of squares
  __shared__ float inv_s[ROWS];                              // GV_NORM: each row's rsqrt(mean(x^2) + eps)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * GV_COLS;
  const int split = blockIdx.z;
  const int k0 = split * p.kps;
  const int k1 = min(p.K, k0 + p.kps);
  const int n_st = (k1 - k0 + KS - 1) / KS;
  const int ach = gv_slab_k<T, ROWS>(p.kps);
  const int ald = ach + 16 / (int)sizeof(T);  // 16 bytes of padding a slab row
  T* slab = reinterpret_cast<T*>(gv_smem + R::BYTES);
  T* xs = slab + ROWS * ald;  // GV_NORM: the pass's x rows, then gamma[k0, k0 + ach)

  if (FLAGS & GV_TRIGGER) pdl_launch_dependents();

  // stage s of the split's rows into ring slot `slot`: KS rows of each
  // weight's GV_COLS columns, rows past k1 and columns past N zero-filled
  auto load_stage = [&](int s, int slot) {
    unsigned char* dst = gv_smem + slot * R::STAGE;
    const int kb = k0 + s * KS;
    if (p.vec) {
#pragma unroll
      for (int i = tid; i < NMAT * KS * R::CPR; i += GV_THREADS) {
        const int m = i / (KS * R::CPR), r = (i / R::CPR) % KS, c = i % R::CPR;
        const int k = kb + r, n = n0 + c * V;
        const T* w = (NMAT == 2 && m) ? p.w1 : p.w0;
        const bool ok = k < k1 && n < p.N;
        cp_async16(dst + m * R::MAT + r * R::WLD + c * 16, ok ? w + (size_t)k * p.N + n : w, ok);
      }
    } else {
      for (int i = tid; i < NMAT * KS * GV_COLS; i += GV_THREADS) {
        const int m = i / (KS * GV_COLS), r = (i / GV_COLS) % KS, c = i % GV_COLS;
        const int k = kb + r, n = n0 + c;
        const T* w = (NMAT == 2 && m) ? p.w1 : p.w0;
        reinterpret_cast<T*>(dst + m * R::MAT + r * R::WLD)[c] =
            k < k1 && n < p.N ? w[(size_t)k * p.N + n] : from_float<T>(0.f);
      }
    }
    cp_async_commit();
  };
  // the first GV_STAGES - 1 stages in flight (an empty group where the split
  // has fewer), so that every step waits for the same group count
  auto ring_start = [&]() {
#pragma unroll
    for (int s = 0; s < GV_STAGES - 1; ++s) {
      if (s < n_st) load_stage(s, s);
      else cp_async_commit();
    }
  };
  // p.xs (GV_NORM, x's rows of a pass and gamma's range within
  // GV_XS_BYTES): one group of 16-byte copies stages them whole, before any
  // weight stage, so that the weights queue behind them and not the other
  // way round
  auto stage_x = [&](int r0, int rt) {
    const T* src = p.A + (size_t)r0 * p.K;
    for (int i = tid; i < rt * p.K / V; i += GV_THREADS) cp_async16(xs + i * V, src + i * V, true);
    T* xg = xs + rt * p.K;
    for (int i = tid; i < ach / V; i += GV_THREADS) {
      const int k = k0 + i * V;
      cp_async16(xg + i * V, k < k1 ? p.gamma + k : p.gamma, k < k1);
    }
    cp_async_commit();
  };
  if (p.xs) stage_x(0, min(ROWS, p.rows));
  ring_start();
  if (FLAGS & GV_WAIT) pdl_wait();

  // GV_NORM without p.xs: inv_s[r] for the pass's rows r0 .. r0 + rt - 1,
  // RB rows' loads two (past 16 rows four) deep in flight at once (8 x 2 up
  // to 16 rows and 16 x 4 past them measured fastest), each row's sum in
  // the one-block-per-row order
  auto row_norms = [&](int r0, int rt) {
    constexpr int RB = ROWS < 8 ? ROWS : ROWS <= 16 ? 8 : 16;
    for (int rb = 0; rb < rt; rb += RB) {
      float s[RB];
#pragma unroll
      for (int q = 0; q < RB; ++q) s[q] = 0.f;
#pragma unroll (ROWS <= 16 ? 2 : 4)
      for (int h = tid; h < p.K; h += GV_THREADS) {
#pragma unroll
        for (int q = 0; q < RB; ++q) {
          if (rb + q < rt) {
            const float v = to_float(p.A[(size_t)(r0 + rb + q) * p.K + h]);
            s[q] = fmaf(v, v, s[q]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < RB; ++q) {
        const float t = group_sum<32>(s[q]);
        if (lane == 0 && rb + q < rt) part_s[rb + q][warp] = t;
      }
    }
    __syncthreads();
    if (tid < rt) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < GV_WARPS; ++w) t += part_s[tid][w];
      inv_s[tid] = rsqrtf(t / p.K + p.eps);
    }
    __syncthreads();
  };
  // the slab: slab[r][j] = A[r0 + r][kb + j] as staged (normed with
  // GV_NORM), 0 for rows past rt and for k past the split
  auto stage_slab = [&](int r0, int rt, int kb) {
    if (p.avec) {
      // 16-byte loads of A (and gamma), four a thread in flight at once
      const int per = ach / V;  // 16-byte loads a slab row
#pragma unroll 4
      for (int i = tid; i < ROWS * per; i += GV_THREADS) {
        const int r = i / per, j = (i % per) * V;
        const int k = kb + j;
        T* dst = slab + r * ald + j;
        const bool in = r < rt && k < k1;
        uint4 raw = make_uint4(0u, 0u, 0u, 0u), gr = raw;
        if (in) raw = *reinterpret_cast<const uint4*>(p.A + (size_t)(r0 + r) * p.K + k);
        if ((FLAGS & GV_NORM) && in) {
          gr = *reinterpret_cast<const uint4*>(p.gamma + k);
          float v[V], g[V];
          Vec16<T>::unpack(raw, v);
          Vec16<T>::unpack(gr, g);
#pragma unroll
          for (int e = 0; e < V; ++e) dst[e] = from_float<T>(v[e] * inv_s[r] * g[e]);
        } else {
          *reinterpret_cast<uint4*>(dst) = raw;
        }
      }
    } else {
      for (int i = tid; i < ROWS * ach; i += GV_THREADS) {
        const int r = i / ach, j = i % ach;
        const int k = kb + j;
        float a = 0.f;
        if (r < rt && k < k1) {
          a = to_float(p.A[(size_t)(r0 + r) * p.K + k]);
          if (FLAGS & GV_NORM) a = a * inv_s[r] * to_float(p.gamma[k]);
        }
        slab[r * ald + j] = from_float<T>(a);
      }
    }
  };

  // p.xs: inv_s and the slab from the staged x and gamma, each row's sum in
  // the one-block-per-row order
  auto norm_from_xs = [&](int rt) {
    cp_async_wait<GV_STAGES - 1>();  // x and gamma (the oldest group) have landed
    __syncthreads();
    for (int r = 0; r < rt; ++r) {
      float s = 0.f;
      for (int h = tid; h < p.K; h += GV_THREADS) {
        const float v = to_float(xs[r * p.K + h]);
        s = fmaf(v, v, s);
      }
      s = group_sum<32>(s);
      if (lane == 0) part_s[r][warp] = s;
    }
    __syncthreads();
    if (tid < rt) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < GV_WARPS; ++w) t += part_s[tid][w];
      inv_s[tid] = rsqrtf(t / p.K + p.eps);
    }
    __syncthreads();
    const T* xg = xs + rt * p.K;
    for (int i = tid; i < ROWS * ach; i += GV_THREADS) {
      const int r = i / ach, j = i % ach;
      const int k = k0 + j;
      float a = 0.f;
      if (r < rt && k < k1) a = to_float(xs[r * p.K + k]) * inv_s[r] * to_float(xg[j]);
      slab[r * ald + j] = from_float<T>(a);
    }
  };

  // step s of a pass: stage s has landed, and every warp is done with the
  // slot the last step used: refill it with the stage GV_STAGES - 1 ahead,
  // and stage A's next range where stage s starts one; returns stage s
  auto step = [&](int r0, int rt, int s) {
    cp_async_wait<GV_STAGES - 2>();
    __syncthreads();
    if (s + GV_STAGES - 1 < n_st) load_stage(s + GV_STAGES - 1, (s + GV_STAGES - 1) % GV_STAGES);
    else cp_async_commit();
    if (s > 0 && (s * KS) % ach == 0) {
      stage_slab(r0, rt, k0 + s * KS);
      __syncthreads();
    }
    return static_cast<const unsigned char*>(gv_smem + (s % GV_STAGES) * R::STAGE);
  };

  for (int r0 = 0; r0 < p.rows; r0 += ROWS) {
    const int rt = min(ROWS, p.rows - r0);
    if (r0 > 0) {
      __syncthreads();  // the last pass is done with the ring and the slab
      if (p.xs) stage_x(r0, rt);
      ring_start();
    }
    if (p.xs) {
      norm_from_xs(rt);
    } else {
      if (FLAGS & GV_NORM) row_norms(r0, rt);
      stage_slab(r0, rt, k0);
    }
    __syncthreads();

    if constexpr (MMA) {
      // ---- tensor cores: warp w owns columns [16 w, 16 w + 16) ----
      constexpr int MT = ROWS / 16;
      float acc[NMAT][MT][2][4];
#pragma unroll
      for (int m = 0; m < NMAT; ++m)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int t = 0; t < 2; ++t) acc[m][mt][t][0] = acc[m][mt][t][1] = acc[m][mt][t][2] = acc[m][mt][t][3] = 0.f;
      for (int s = 0; s < n_st; ++s) {
        const unsigned char* st = step(r0, rt, s);
        const int kc = (s * KS) % ach;
#pragma unroll
        for (int ks = 0; ks < KS / 16; ++ks) {
          uint32_t a[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            ldmatrix_x4(a[mt], slab + (mt * 16 + (lane % 8) + 8 * ((lane / 8) % 2)) * ald + kc + ks * 16 + 8 * (lane / 16));
#pragma unroll
          for (int m = 0; m < NMAT; ++m) {
            uint32_t b[4];  // k 16 x columns 16: b[0], b[1] the first 8 columns, b[2], b[3] the next
            ldmatrix_x4_trans(b, st + m * R::MAT + (ks * 16 + (lane % 8) + 8 * ((lane / 8) % 2)) * R::WLD +
                                     (warp * 16 + 8 * (lane / 16)) * (int)sizeof(T));
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_bf16(acc[m][mt][0], a[mt], b[0], b[1]);
              mma_bf16(acc[m][mt][1], a[mt], b[2], b[3]);
            }
          }
        }
      }
      cp_async_wait<0>();  // (the empty groups)
      const int g = lane / 4, t4 = lane % 4;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = mt * 16 + g + 8 * (i >> 1);
            const int n = n0 + warp * 16 + t * 8 + 2 * t4 + (i & 1);
            if (r < rt && n < p.N) {
              float v[NMAT];
#pragma unroll
              for (int m = 0; m < NMAT; ++m) v[m] = acc[m][mt][t][i];
              sink(split, r0 + r, n, v);
            }
          }
    } else {
      // ---- FMAs: a lane reads 16 bytes of a weight row, the warps split
      // each stage's rows ----
      constexpr int LPR = GV_COLS / V;      // lanes that share one weight row
      constexpr int RPW = 32 / LPR;         // weight rows one warp reads at once
      constexpr int PASS = GV_WARPS * RPW;  // weight rows the block reads at once
      const int sub = lane / LPR, c = lane % LPR;
      float acc[NMAT][ROWS][V];
#pragma unroll
      for (int m = 0; m < NMAT; ++m)
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int e = 0; e < V; ++e) acc[m][r][e] = 0.f;
      for (int s = 0; s < n_st; ++s) {
        const unsigned char* st = step(r0, rt, s);
        const int kc = (s * KS) % ach;
#pragma unroll
        for (int j = 0; j < KS / PASS; ++j) {
          const int kr = j * PASS + warp * RPW + sub;  // the lane's row of the stage
          float a[ROWS];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) a[r] = to_float(slab[r * ald + kc + kr]);
#pragma unroll
          for (int m = 0; m < NMAT; ++m) {
            float v[V];
            Vec16<T>::unpack(*reinterpret_cast<const uint4*>(st + m * R::MAT + kr * R::WLD + c * 16), v);
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
#pragma unroll
              for (int e = 0; e < V; ++e) acc[m][r][e] = fmaf(a[r], v[e], acc[m][r][e]);
          }
        }
      }
      cp_async_wait<0>();
      // the lanes that share columns hold other rows of K: add them in a
      // fixed order (an xor tree over the lane bits above LPR), then the
      // warps in warp order through shared memory (the ring's space)
#pragma unroll
      for (int m = 0; m < NMAT; ++m)
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int e = 0; e < V; ++e)
#pragma unroll
            for (int o = LPR; o < 32; o <<= 1) acc[m][r][e] += __shfl_xor_sync(0xffffffffu, acc[m][r][e], o);
      float* red = reinterpret_cast<float*>(gv_smem);  // [NMAT][GV_WARPS][ROWS][GV_COLS]
      static_assert(NMAT * GV_WARPS * ROWS * GV_COLS * sizeof(float) <= (size_t)R::BYTES, "red fits the ring");
      __syncthreads();  // every warp is done with the ring
      if (sub == 0) {
#pragma unroll
        for (int m = 0; m < NMAT; ++m)
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
#pragma unroll
            for (int e = 0; e < V; ++e) red[((m * GV_WARPS + warp) * ROWS + r) * GV_COLS + c * V + e] = acc[m][r][e];
      }
      __syncthreads();
      for (int i = tid; i < rt * GV_COLS; i += GV_THREADS) {
        const int r = i / GV_COLS, cc = i % GV_COLS;
        const int n = n0 + cc;
        if (n >= p.N) continue;
        float v[NMAT];
#pragma unroll
        for (int m = 0; m < NMAT; ++m) {
          float sum = 0.f;
#pragma unroll
          for (int w = 0; w < GV_WARPS; ++w) sum += red[((m * GV_WARPS + w) * ROWS + r) * GV_COLS + cc];
          v[m] = sum;
        }
        sink(split, r0 + r, n, v);
      }
    }
  }
  sink.finish(p.rows);
}

template <typename T, int NMAT, int ROWS, bool MMA, int FLAGS, class Sink>
cudaError_t gemv_launch_body(GemvArgs<T> p, int splits, Sink sink, cudaStream_t st) {
  auto kernel = gemv_kernel<T, NMAT, ROWS, MMA, Sink, FLAGS>;
  const int ach = gv_slab_k<T, ROWS>(p.kps);
  // x's rows of a pass (each pass holds at most the first's) and gamma's
  // range staged whole where they fit: the room is taken only then
  p.xs = (FLAGS & GV_NORM) && !(FLAGS & GV_WAIT) && p.avec &&
         ((size_t)(ROWS < p.rows ? ROWS : p.rows) * p.K + ach) * sizeof(T) <= (size_t)GV_XS_BYTES;
  const size_t smem = GvRing<T, NMAT>::BYTES + (size_t)ROWS * (ach * sizeof(T) + 16) + (p.xs ? GV_XS_BYTES : 0);
  const dim3 grid((p.N + GV_COLS - 1) / GV_COLS, 1, splits);
  if (FLAGS & GV_TRIGGER) {
    // the launch after this one starts while this one runs: its blocks need
    // room beside these, so the SMs keep their most shared memory (not L1)
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  return launch_ex(kernel, grid, dim3(GV_THREADS), smem, st, (FLAGS & GV_WAIT) != 0, p, sink);
}

// Y = A W (and A W1 for NMAT = 2) over A's rows, K split `splits` ways of
// p.kps rows (every split non-empty); FLAGS: the prologue and the launch
// chain (gemv_kernel). bf16 takes the tensor-core body past GV_FMA_ROWS
// rows, with the least of 16, 32, 48 or 64 rows that holds them (more rows:
// passes of 64; at 3 and 4 rows it matched or beat FMA tiles of 4, which
// spill), and the FMA body with row tiles of 1 or 2 below; fp32 the FMA
// body with row tiles of 1, 2 or 4 (more rows: passes of 4).
template <typename T, int NMAT, class Sink, int FLAGS = 0>
cudaError_t gemv_launch(GemvArgs<T> p, int splits, Sink sink, cudaStream_t st) {
  if (p.rows < 1 || p.K < 1 || p.N < 1 || splits < 1 || splits > GV_MAX_SPLITS || p.kps < 1 ||
      p.kps % GV_K_ALIGN != 0 || (long long)(splits - 1) * p.kps >= p.K || (long long)splits * p.kps < p.K ||
      (NMAT == 2 && p.w1 == nullptr) || ((FLAGS & GV_NORM) && p.gamma == nullptr))
    return cudaErrorInvalidValue;
  auto aligned16 = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  p.vec = (p.N * sizeof(T)) % 16 == 0 && aligned16(p.w0) && (NMAT == 1 || aligned16(p.w1));
  p.avec = (p.K * sizeof(T)) % 16 == 0 && aligned16(p.A) && (p.gamma == nullptr || aligned16(p.gamma));
  constexpr bool tc = std::is_same<T, __nv_bfloat16>::value;
  if (!tc || p.rows <= GV_FMA_ROWS) {
    if (p.rows <= 1) return gemv_launch_body<T, NMAT, 1, false, FLAGS>(p, splits, sink, st);
    if constexpr (tc && GV_FMA_ROWS <= 2) {
      return gemv_launch_body<T, NMAT, 2, false, FLAGS>(p, splits, sink, st);
    } else {
      if (p.rows <= 2) return gemv_launch_body<T, NMAT, 2, false, FLAGS>(p, splits, sink, st);
      return gemv_launch_body<T, NMAT, 4, false, FLAGS>(p, splits, sink, st);
    }
  }
  if constexpr (tc) {
    if (p.rows <= 16) return gemv_launch_body<T, NMAT, 16, true, FLAGS>(p, splits, sink, st);
    if (p.rows <= 32) return gemv_launch_body<T, NMAT, 32, true, FLAGS>(p, splits, sink, st);
    if (p.rows <= 48) return gemv_launch_body<T, NMAT, 48, true, FLAGS>(p, splits, sink, st);
    return gemv_launch_body<T, NMAT, GV_MAX_ROWS, true, FLAGS>(p, splits, sink, st);
  }
  return cudaErrorInvalidValue;
}

// ---- sinks -----------------------------------------------------------------

// s[m] = the sum over the K splits (the grid's z axis) of the fp32 partials
// base[m][o + z zstride], in split order from zero, for NS sums of one
// output: ZB splits' loads of all of them are issued before any is added.
// (One output a thread at a time ran faster than four: the last split
// blocks' loads then wait behind fewer of their own.)
template <int NS, int ZB>
__device__ __forceinline__ void split_sums(const float* const (&base)[NS], size_t zstride, size_t o,
                                           float (&s)[NS]) {
  const int Z = gridDim.z;
#pragma unroll
  for (int m = 0; m < NS; ++m) s[m] = 0.f;
  for (int z0 = 0; z0 < Z; z0 += ZB) {
    float v[NS][ZB];
#pragma unroll
    for (int m = 0; m < NS; ++m)
#pragma unroll
      for (int z = 0; z < ZB; ++z) v[m][z] = z0 + z < Z ? __ldcg(base[m] + o + (z0 + z) * zstride) : 0.f;
#pragma unroll
    for (int m = 0; m < NS; ++m)
#pragma unroll
      for (int z = 0; z < ZB; ++z)
        if (z0 + z < Z) s[m] += v[m][z];
  }
}

// fp32 partial sums (splits, rows, N)
struct PartialSink {
  float* part;
  int rows, N;

  __device__ void operator()(int split, int row, int n, const float* v) const {
    part[((size_t)split * rows + row) * N + n] = v[0];
  }
  __device__ void finish(int) const {}
};

// out = x + the sum over the K splits in split order, rounded once to T.
// Each block stores its fp32 partial sums (splits, rows, N); the last of a
// column tile's split blocks (a completion counter per tile, last_block)
// adds them. With one split the block writes out itself.
template <typename T>
struct ResidualSink {
  float* part;
  const T* x;
  T* out;
  unsigned* counter;  // one per column tile, 0 between launches
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
  __device__ void finish(int) const {
    if (gridDim.z == 1 || !last_block(counter + blockIdx.x, gridDim.z)) return;
    const float* const base[1] = {part};
    for (int i = threadIdx.x; i < rows * GV_COLS; i += GV_THREADS) {
      const int row = i / GV_COLS, n = blockIdx.x * GV_COLS + i % GV_COLS;
      if (n >= N) continue;
      const size_t o = (size_t)row * N + n;
      float s[1];
      split_sums<1, 8>(base, (size_t)rows * N, o, s);
      out[o] = from_float<T>(to_float(x[o]) + s[0]);
    }
  }};

// act = glu(gate, up) rounded once to T, gate (v[0]) and up (v[1]) each the
// sum over the K splits in split order. Each block stores its fp32 partial
// sums, gate's (splits, rows, N) then up's; the last of a column tile's
// split blocks (last_block) adds them and applies the activation. With one
// split the block writes act itself.
template <typename T>
struct GluSplitSink {
  float* part;
  T* act;
  unsigned* counter;  // one per column tile, 0 between launches
  int rows, N;
  Glu glu_kind;

  __device__ void operator()(int split, int row, int n, const float* v) const {
    const size_t o = (size_t)row * N + n;
    if (gridDim.z == 1) {
      float g = 0.f, u = 0.f;
      g += v[0];
      u += v[1];
      act[o] = from_float<T>(glu(g, u, glu_kind));
    } else {
      part[(size_t)split * rows * N + o] = v[0];
      part[((size_t)gridDim.z + split) * rows * N + o] = v[1];
    }
  }
  __device__ void finish(int) const {
    if (gridDim.z == 1 || !last_block(counter + blockIdx.x, gridDim.z)) return;
    const size_t zs = (size_t)rows * N;
    const float* const base[2] = {part, part + gridDim.z * zs};  // gate's partials, up's
    for (int i = threadIdx.x; i < rows * GV_COLS; i += GV_THREADS) {
      const int row = i / GV_COLS, n = blockIdx.x * GV_COLS + i % GV_COLS;
      if (n >= N) continue;
      const size_t o = (size_t)row * N + n;
      float s[2];
      split_sums<2, 4>(base, zs, o, s);
      act[o] = from_float<T>(glu(s[0], s[1], glu_kind));
    }
  }};

}  // namespace nxdi
