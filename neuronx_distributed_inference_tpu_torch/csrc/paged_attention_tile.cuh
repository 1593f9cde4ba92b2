// The paged kv loop shared by the paged flash prefill kernel (B5,
// paged_flash_attention.cu) and the ragged paged attention kernel (B3,
// ragged_paged_attention.cu).
//
// A block of THREADS threads holds BQ query rows in shared memory, each with
// its absolute position (-1 = no query), all of one kv head g and one row of
// the block table. attend() walks that row's paged cache in tiles of BKV
// positions up to min(the block's largest position, limit - 1), reading
// position s of head g from block bt_row[s / bs] of the head-major
// (NB+1, Hkv, bs, D) layer. Block 0 (the garbage block, which the fault
// tests fill with NaN), any id outside [1, NB] and any position >= limit load
// as zeros, so a masked probability (exactly 0) never multiplies a NaN. The
// softmax is online, in fp32, with NEG_INF = -1e30 fills and masked
// probabilities zeroed: a query row with no valid key ends with l == 0 and
// acc == 0, and finalize() writes exact zeros for it (acc / max(l, 1e-30)).
//
// The BQ query rows share every K/V tile load, which is how GQA runs without
// repeat_kv: a block holds several q heads of one kv head.
#pragma once

#include "common.cuh"

namespace nxdi {
namespace paged {

constexpr int BQ = 64;   // query rows per block
constexpr int BKV = 64;  // kv positions per tile
constexpr int THREADS = 128;
// thread (r, c) = (tid / CG, tid % CG) owns query rows r + RG * i (i < ROWS_T)
// and score columns c + CG * j (j < COLS_T) of the BQ x BKV score tile, and
// output columns c + CG * j (j < D / CG) of its rows
constexpr int RG = 16;
constexpr int CG = 8;
constexpr int ROWS_T = BQ / RG;
constexpr int COLS_T = BKV / CG;

template <int D>
constexpr size_t smem_bytes() {
  // Q and K tiles padded to D + 1 floats a row (conflict-free column reads),
  // V tile, probability tile padded to BKV + 1, query positions
  return sizeof(float) * (size_t)(BQ * (D + 1) + BKV * (D + 1) + BKV * D + BQ * (BKV + 1)) +
         sizeof(int) * BQ;
}

// the block's shared memory, carved from one dynamic allocation
template <int D>
struct Smem {
  float* Qs;    // (BQ, D + 1) queries in fp32
  float* Ks;    // (BKV, D + 1)
  float* Vs;    // (BKV, D)
  float* Ps;    // (BQ, BKV + 1) probabilities
  int* pos;     // (BQ,) query positions, -1 = no query
  __device__ explicit Smem(float* smem)
      : Qs(smem),
        Ks(smem + BQ * (D + 1)),
        Vs(smem + BQ * (D + 1) + BKV * (D + 1)),
        Ps(smem + BQ * (D + 1) + BKV * (D + 1) + BKV * D),
        pos(reinterpret_cast<int*>(smem + BQ * (D + 1) + BKV * (D + 1) + BKV * D + BQ * (BKV + 1))) {}
};

// Attention of the block's BQ query rows over one block-table row. The
// caller has filled sm.Qs and sm.pos and synchronised. On return thread
// (r, c) holds l_i[i] and acc[i][j] for query row r + RG * i, output column
// c + CG * j.
template <typename T, int D>
__device__ __forceinline__ void attend(const Smem<D>& sm, const T* kc, const T* vc, const int* bt_row,
                                       int g, int Hkv, int bs, int NB1, int limit, float scale,
                                       float (&l_i)[ROWS_T], float (&acc)[ROWS_T][D / CG]) {
  constexpr int LD = D + 1;
  constexpr int PLD = BKV + 1;
  constexpr int DT = D / CG;
  const int tid = threadIdx.x;
  const int r = tid / CG;
  const int c = tid % CG;

  // the last kv position any row of this block may attend
  int last = -1;
  for (int row = 0; row < BQ; ++row) last = max(last, sm.pos[row]);
  last = min(last, limit - 1);

  float m_i[ROWS_T];
#pragma unroll
  for (int i = 0; i < ROWS_T; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DT; ++j) acc[i][j] = 0.f;
  }

  const int n_tiles = last < 0 ? 0 : last / BKV + 1;
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int kv_start = jt * BKV;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BKV * D; idx += THREADS) {
      const int col = idx / D, d = idx % D;
      const int s = kv_start + col;
      float kv = 0.f, vv = 0.f;
      if (s < limit) {
        const int blk = bt_row[s / bs];
        if (blk > 0 && blk < NB1) {
          const long long a = (((long long)blk * Hkv + g) * bs + s % bs) * D + d;
          kv = to_float(kc[a]);
          vv = to_float(vc[a]);
        }
      }
      sm.Ks[col * LD + d] = kv;
      sm.Vs[col * D + d] = vv;
    }
    __syncthreads();

    float sc[ROWS_T][COLS_T];
#pragma unroll
    for (int i = 0; i < ROWS_T; ++i)
#pragma unroll
      for (int j = 0; j < COLS_T; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[ROWS_T], kv[COLS_T];
#pragma unroll
      for (int i = 0; i < ROWS_T; ++i) qv[i] = sm.Qs[(r + RG * i) * LD + d];
#pragma unroll
      for (int j = 0; j < COLS_T; ++j) kv[j] = sm.Ks[(c + CG * j) * LD + d];
#pragma unroll
      for (int i = 0; i < ROWS_T; ++i)
#pragma unroll
        for (int j = 0; j < COLS_T; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < ROWS_T; ++i) {
      const int lrow = r + RG * i;
      const int qpos = sm.pos[lrow];
      bool ok[COLS_T];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < COLS_T; ++j) {
        const int s = kv_start + c + CG * j;
        ok[j] = s <= qpos && s < limit;
        sc[i][j] = ok[j] ? sc[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
      mx = group_max<CG>(mx);
      const float m_new = fmaxf(m_i[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < COLS_T; ++j) {
        const float pv = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        sm.Ps[lrow * PLD + c + CG * j] = pv;
        sum += pv;
      }
      sum = group_sum<CG>(sum);
      const float alpha = expf(m_i[i] - m_new);
      l_i[i] = l_i[i] * alpha + sum;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < DT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BKV; ++kk) {
      float pr[ROWS_T];
#pragma unroll
      for (int i = 0; i < ROWS_T; ++i) pr[i] = sm.Ps[(r + RG * i) * PLD + kk];
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const float vv = sm.Vs[kk * D + c + CG * j];
#pragma unroll
        for (int i = 0; i < ROWS_T; ++i) acc[i][j] = fmaf(pr[i], vv, acc[i][j]);
      }
    }
  }
}

// Write query row i's result (thread-local index i < ROWS_T) to `dst`, the
// row's D outputs: acc / max(l, 1e-30), exact zeros for a row with no key.
template <typename T, int D>
__device__ __forceinline__ void finalize_row(T* dst, float l, const float (&acc_row)[D / CG]) {
  const int c = threadIdx.x % CG;
  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int j = 0; j < D / CG; ++j) dst[c + CG * j] = from_float<T>(acc_row[j] / denom);
}

// Opt the kernel into its dynamic shared memory (above 48 KB at D = 64).
template <int D, typename K>
cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes<D>());
}

}  // namespace paged
}  // namespace nxdi
