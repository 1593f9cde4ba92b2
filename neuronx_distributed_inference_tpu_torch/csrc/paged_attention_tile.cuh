// The paged kv loops shared by the paged flash prefill kernel (B5,
// paged_flash_attention.cu) and the ragged paged attention kernel (B3,
// ragged_paged_attention.cu): attend(), the fp32 FMA loop both run for an
// fp32 q, and flash_mma(), the tensor-core body of B5 and of B3's prefill
// tiles for a bf16 q over a bf16 cache or 1-byte int8 / fp8 codes (below).
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

#include "mma.cuh"

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

// Attention of the block's BQ query rows over one block-table row, the
// cache of element type T (bf16, fp32, or 1-byte int8/fp8 KV codes, each
// converted to fp32 as it is loaded). The caller has filled sm.Qs and
// sm.pos and synchronised. On return thread
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
// row's D outputs: acc / max(l, 1e-30) times vf (a code cache's V factor,
// else 1), exact zeros for a row with no key.
template <typename T, int D>
__device__ __forceinline__ void finalize_row(T* dst, float l, const float (&acc_row)[D / CG], float vf) {
  const int c = threadIdx.x % CG;
  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int j = 0; j < D / CG; ++j) dst[c + CG * j] = from_float<T>(acc_row[j] / denom * vf);
}

// ---------------------------------------------------------------------------
// bf16 q: tensor cores (B5, and B3's prefill tiles)
// ---------------------------------------------------------------------------

// Eight 1-byte codes (the lower address in the low byte) as eight bf16, the
// lower address in the low half: exactly, since every int8 in [-127, 127]
// and every finite e4m3 / e5m2 value is a bf16 value (fp8 through half
// precision, which holds both formats).
template <typename C>
__device__ __forceinline__ uint4 codes_to_bf16(uint2 w);
template <>
__device__ __forceinline__ uint4 codes_to_bf16<int8_t>(uint2 w) {
  const uint32_t in[2] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u};
  uint32_t out[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = 2 * (i % 2);
    out[i] = pack_bf16(int8_byte_to_float(in[i / 2], k), int8_byte_to_float(in[i / 2], k + 1));
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}
__device__ __forceinline__ uint4 fp8_to_bf16(uint2 w, __nv_fp8_interpretation_t kind) {
  const uint32_t in[2] = {w.x, w.y};
  uint32_t out[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __half2 h(__nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(in[i / 2] >> (16 * (i % 2))), kind));
    const float2 f = __half22float2(h);
    out[i] = pack_bf16(f.x, f.y);
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}
template <>
__device__ __forceinline__ uint4 codes_to_bf16<Fp8E4M3>(uint2 w) { return fp8_to_bf16(w, __NV_E4M3); }
template <>
__device__ __forceinline__ uint4 codes_to_bf16<Fp8E5M2>(uint2 w) { return fp8_to_bf16(w, __NV_E5M2); }

// The shared memory of flash_mma over a cache of element type C: Q (bf16
// rows padded by 16 bytes), then the K / V stages, then the query
// positions. bf16: two stages of (K, V) bf16 tiles, read by ldmatrix as
// they land. Codes: three stages of (K, V) code tiles (1-byte rows padded
// by 16 bytes: half a bf16 stage, so a third fits) and one (K, V) pair of
// bf16 tiles that each code tile is converted into before ldmatrix reads it.
template <typename C, int D>
struct MmaTile {
  static constexpr bool CODES = sizeof(C) == 1;
  static constexpr int LD = D + 8;     // bf16 per shared row: 16 bytes of padding
  static constexpr int KV = BKV * LD;  // one bf16 K or V tile
  static constexpr int LDC = D + 16;   // bytes per code row: 16 bytes of padding
  static constexpr int STAGES = CODES ? 3 : 2;
  static constexpr int STAGE = CODES ? 2 * BKV * LDC : 2 * KV * 2;  // bytes of one stage's (K, V)
  static constexpr size_t smem = sizeof(__nv_bfloat16) * (size_t)(BQ * LD + (CODES ? 2 * KV : 0)) +
                                 (size_t)STAGES * STAGE + sizeof(int) * BQ;
};

// The tensor-core body of B5 (paged_flash_mma) and of B3's prefill tiles
// (ragged_paged_attention.cu): the block's BQ bf16 query rows, 16 a warp,
// over one block-table row of kv head hk of a cache of C (bf16, or int8 /
// fp8 codes), up to min(the rows' largest position, limit - 1). row_off(r):
// the element offset of query row r in q and out, or -1 for a row that is
// neither read nor written; row_pos(r): its position (-1: no valid key; the
// row is written as zeros). scale: the score scale, a code cache's K factor
// folded in; vf: the V factor the finalized output is multiplied by before
// its one rounding to bf16 (1 for a bf16 cache). The design is
// paged_flash_attention.cu's (mma.sync m16n8k16, P in registers, K / V by
// 16-byte cp.async through the table into padded stages, the zero rule as
// cp.async's zero fill; code tiles converted to bf16 in shared memory
// first). smem_raw: MmaTile<C, D>::smem bytes, 16-byte aligned.
template <typename C, int D, class RowOff, class RowPos>
__device__ __forceinline__ void flash_mma(unsigned char* smem_raw, const __nv_bfloat16* qp, __nv_bfloat16* op,
                                          RowOff row_off, RowPos row_pos, const C* k_layer, const C* v_layer,
                                          const int* bt_row, int hk, int Hkv, int bs, int NB1, int limit, float scale,
                                          float vf) {
  using Tile = MmaTile<C, D>;
  using bf16 = __nv_bfloat16;
  constexpr bool CODES = Tile::CODES;
  constexpr int LD = Tile::LD;
  constexpr int STAGES = Tile::STAGES;
  constexpr int QCH = D / 8;                       // 16-byte chunks per q row
  constexpr int Q_STEP = THREADS / QCH;            // rows between one thread's q chunks
  constexpr int EC = 16 / (int)sizeof(C);          // cache elements per 16-byte chunk
  constexpr int KCH = D / EC;                      // 16-byte chunks per cache row
  constexpr int ROW_STEP = THREADS / KCH;          // rows between one thread's cache chunks
  constexpr int SLD = CODES ? Tile::LDC : LD;      // elements per staged row
  constexpr int KS = D / 16;                       // k steps of Q K^T
  constexpr int NT = BKV / 8;                      // n tiles of the score tile
  constexpr int DT = D / 8;                        // n tiles of the output
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Kb = Qs + BQ * LD;  // codes: the converted K tile, V right after
  unsigned char* stages = reinterpret_cast<unsigned char*>(Kb + (CODES ? 2 * Tile::KV : 0));
  int* pos_s = reinterpret_cast<int*>(stages + STAGES * Tile::STAGE);  // stage s: K at s STAGE, V half a stage on

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // thread tid copies q chunk tid % QCH of rows tid / QCH + Q_STEP u, and
  // cache chunk tid % KCH of tile rows tid / KCH + ROW_STEP u
  const int qr = tid / QCH, qc = (tid % QCH) * 8;
  const int cr = tid / KCH, cc = (tid % KCH) * EC;

  if (limit <= 0) {  // an inactive row: zeros, no cache read
    for (int r = qr; r < BQ; r += Q_STEP) {
      const long long o = row_off(r);
      if (o >= 0) *reinterpret_cast<uint4*>(op + o + qc) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  for (int r = qr; r < BQ; r += Q_STEP) {
    const long long o = row_off(r);
    cp_async16(Qs + r * LD + qc, qp + (o >= 0 ? o : 0) + qc, o >= 0);
  }
  cp_async_commit();
  if (tid < BQ) pos_s[tid] = row_off(tid) >= 0 ? row_pos(tid) : -1;
  __syncthreads();

  // the last kv position any row of this block may attend
  int last = -1;
  for (int r = 0; r < BQ; ++r) last = max(last, pos_s[r]);
  last = min(last, limit - 1);
  const int n_tiles = last < 0 ? 0 : last / BKV + 1;

  const C* kp = k_layer + cc;
  const C* vp = v_layer + cc;
  auto stage_k = [&](int stage) { return reinterpret_cast<C*>(stages + stage * Tile::STAGE); };
  auto load_tile = [&](int j, int stage) {
    const int kv0 = j * BKV;
    C* Ks = stage_k(stage) + cc;
    C* Vs = Ks + BKV * SLD;
#pragma unroll
    for (int r = cr; r < BKV; r += ROW_STEP) {
      const int s = kv0 + r;
      const int blk = s < limit ? __ldg(bt_row + s / bs) : 0;
      // the zero rule: past kv_limit, block 0 and ids outside [1, NB] are
      // zero-filled, never read
      const bool ok = s < limit && blk > 0 && blk < NB1;
      const long long a = ok ? (((long long)blk * Hkv + hk) * bs + s % bs) * D : 0;
      cp_async16(Ks + r * SLD, kp + a, ok);
      cp_async16(Vs + r * SLD, vp + a, ok);
    }
    cp_async_commit();
  };

  // lane (g, t) = (lane / 4, lane % 4) holds rows g and g + 8 of the warp's
  // 16: score / output columns 8 n + 2 t and 8 n + 2 t + 1 of each n tile
  const int g = lane / 4, t4 = lane % 4;
  const int row0 = warp * 16 + g;
  // each row's allowed columns: [0, min(pos, kv_limit - 1)] (empty for a row
  // with no query)
  const int col_hi[2] = {min(pos_s[row0], limit - 1), min(pos_s[row0 + 8], limit - 1)};
  float m_i[2] = {NEG_INF, NEG_INF}, l_i[2] = {0.f, 0.f};
  float o[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  uint32_t qf[KS][4];

  // tiles 0 .. STAGES - 2 in flight before the loop; tile j + STAGES - 1
  // issued at the top of iteration j, into the stage that tile j - 1 left
  for (int j = 0; j < STAGES - 1 && j < n_tiles; ++j) load_tile(j, j);
  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j % STAGES;
    const int ahead = min(n_tiles - 1 - j, STAGES - 1);  // tiles after j in flight once this one is issued
    if (j + STAGES - 1 < n_tiles) load_tile(j + STAGES - 1, (j + STAGES - 1) % STAGES);
    if (ahead >= 2) cp_async_wait<2>();
    else if (ahead == 1) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();
    if (j == 0) {
      // A fragments of the warp's 16 Q rows: matrices (rows 0-7 | 8-15) x
      // (cols 0-7 | 8-15) of each k step
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldmatrix_x4(qf[ks], Qs + (warp * 16 + (lane % 8) + 8 * ((lane / 8) % 2)) * LD + ks * 16 + 8 * (lane / 16));
    }
    const bf16* Ks;
    if constexpr (CODES) {
      // the code tile into the bf16 pair, 8 codes a thread at a time; the
      // barrier at the top of this iteration saw every warp done with the
      // previous tile's pair
      const unsigned char* src = stages + stage * Tile::STAGE;
      constexpr int UNITS = BKV * D / 8;  // 8-code units of one tile
#pragma unroll
      for (int i = 0; i < 2 * UNITS / THREADS; ++i) {
        const int u = tid + i * THREADS;
        const int kvi = u / UNITS, r = (u % UNITS) / (D / 8), c8 = (u % (D / 8)) * 8;
        const uint2 w = *reinterpret_cast<const uint2*>(src + kvi * BKV * SLD + r * SLD + c8);
        *reinterpret_cast<uint4*>(Kb + kvi * Tile::KV + r * LD + c8) = codes_to_bf16<C>(w);
      }
      __syncthreads();
      Ks = Kb;
    } else {
      Ks = stage_k(stage);
    }
    const bf16* Vs = Ks + (CODES ? Tile::KV : BKV * SLD);
    const int kv0 = j * BKV;

    // S = Q K^T: K rows are the B operand's columns as stored (no transpose)
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int pp = 0; pp < NT / 2; ++pp) {
        uint32_t kb[4];
        ldmatrix_x4(kb, Ks + (pp * 16 + (lane % 8) + 8 * (lane / 16)) * LD + ks * 16 + 8 * ((lane / 8) % 2));
        mma_bf16(s[2 * pp], qf[ks], kb[0], kb[1]);
        mma_bf16(s[2 * pp + 1], qf[ks], kb[2], kb[3]);
      }
    }

    // the mask: a tile that every row of the warp sees whole takes no
    // per-element predicate
    float alpha[2];
    if (__all_sync(0xffffffffu, col_hi[0] >= kv0 + BKV - 1 && col_hi[1] >= kv0 + BKV - 1)) {
      softmax_step<false, false>(s, 0u, scale, m_i, l_i, alpha);
    } else {
      uint32_t ok_bits = 0;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ok_bits |= (kv0 + n * 8 + 2 * t4 + (e & 1) <= col_hi[e >> 1] ? 1u : 0u) << (n * 4 + e);
      softmax_step<true, false>(s, ok_bits, scale, m_i, l_i, alpha);
    }
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: P's two n tiles per k16 step are the A fragment; V through
    // ldmatrix.trans is the B operand
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int qq = 0; qq < D / 16; ++qq) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, Vs + (kk * 16 + (lane % 8) + 8 * ((lane / 8) % 2)) * LD + qq * 16 + 8 * (lane / 16));
        mma_bf16(o[2 * qq], a, vb[0], vb[1]);
        mma_bf16(o[2 * qq + 1], a, vb[2], vb[3]);
      }
    }
    // bf16: every warp is done with this stage before it is refilled (codes:
    // the next iteration's first barrier guards the converted pair, and the
    // code stage was free once converted)
    if constexpr (!CODES) __syncthreads();
  }
  cp_async_wait<0>();  // (no tile: the Q copy)

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const long long off = row_off(row0 + 8 * rr);
    if (off < 0) continue;
    const float denom = fmaxf(l_i[rr], 1e-30f);
    __nv_bfloat162* orow = reinterpret_cast<__nv_bfloat162*>(op + off);
#pragma unroll
    for (int n = 0; n < DT; ++n)
      orow[(n * 8 + 2 * t4) / 2] = __floats2bfloat162_rn(o[n][2 * rr] / denom * vf, o[n][2 * rr + 1] / denom * vf);
  }
}

// Opt the kernel into its dynamic shared memory (above 48 KB at D = 64).
template <int D, typename K>
cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes<D>());
}

}  // namespace paged
}  // namespace nxdi
