// Prefill flash attention for Hopper (sm_90a): kernel B2 of the port.
//
// Replaces the TPU kernels neuronx_distributed_inference_tpu/ops/
// flash_attention.py::_flash_kernel (flash_attention_bhsd) and
// ::_flash_kernel_packed (_packed_flash_call). The packed variant pairs two
// D=64 heads in one 128-lane TPU tile; on Hopper that trick has no purpose,
// so the D=64 case is the D=64 instance of this one kernel, and its bf16
// softmax mode is the `softmax_bf16` flag.
//
// What it computes, per (batch, q head, row): an online softmax over the
// row's live kv tiles with the reference's mask predicate (key_valid fused
// with causal / sliding-window / chunked bounds), NEG_INF = -1e30 fills,
// masked probabilities exactly 0, out = acc / max(l, 1e-30), and the row's
// softmax stats (m, l) for the sink fold outside the kernel. In the bf16
// softmax mode the exp input and the probabilities are rounded to bf16.
//
// What bounds it on an H100: at the main path's shapes (S = 128..512,
// D = 64 or 128, 32 q heads) the causal work is ~2 * S^2 * D FLOP per head
// against 1.3 to 5.2 MB of q/k/v/out traffic: under the card's ~295
// FLOP/byte ridge, so at the roofline memory bounds it, with the bf16
// tensor-core rate close behind at S = 512. Reaching either takes the
// tensor cores: on the CUDA cores' fp32 FMAs the products alone run ~15x
// under the bf16 rate.
//
// bf16 design (flash_fwd_mma):
//   - Both products on the tensor cores, mma.sync m16n8k16 bf16 -> fp32.
//     A block is 4 warps over 64 query rows; each warp owns 16: its Q
//     fragments (ldmatrix, once), the 16 x 64 score tile, the online-softmax
//     state and the 16 x D output accumulator all live in the warp's
//     registers. Row max and row sum reduce across the 4 lanes of a quad.
//     The probabilities become the bf16 A operand of the P.V product in
//     registers (the score tile's accumulator layout of two n8 tiles is the
//     A layout of one k16 step), so P never goes through shared memory. l
//     sums the fp32 probabilities; only the P.V operand is rounded to bf16,
//     the rounding the TPU's MXU makes at default precision (and the packed
//     kernel's softmax_bf16 mode makes anyway).
//   - K / V tiles of 64 positions sit in shared memory as bf16, rows padded
//     by 16 bytes so the 8 row addresses of each ldmatrix (K) and
//     ldmatrix.trans (V) fall in distinct banks. They arrive by 16-byte
//     cp.async (rows past S zero-filled) into two stages: the next live
//     tile is in flight while this one is computed. Q is loaded once. At
//     D = 128 a block takes 87.5 KB of shared memory: two blocks an SM.
//   - The dead-tile skip stays: a block walks only the interval of kv tiles
//     that the causal / window / chunk bounds leave live for its rows.
//   - The mask costs no division in the tile loop: each row's allowed
//     columns are one interval, found once; key validity of a tile is two
//     ballot words; a tile every row of the warp sees whole skips the
//     per-element predicate. exp is one FFMA (scale and log2 e folded) and
//     MUFU.EX2; the bf16 softmax mode is a template instance of its own.
//     (`allowed` per element, with its integer divisions, nearly doubles
//     the kernel's time at S = 512: scripts/torch_attention_variants.py.)
//   - 64 rows a block at every shape: at S = 128 and 32 heads that is 64
//     blocks on 132 SMs, yet 16- or 32-row blocks (256 / 128 blocks) ran
//     slower there too; the longest block's chain of kv tiles, not the
//     grid's width, sets the time.
//   - mma.sync and not wgmma / TMA: at S <= 512 a block computes at most 8
//     kv tiles, too little work to pay for a TMA descriptor, mbarrier ring
//     and warpgroup tiles per block. wgmma + TMA is the next step (ROADMAP,
//     queue B).
// fp32 design (flash_fwd_fp32): fp32 FMAs on the CUDA cores. TF32
// tensor-core products would break the fp32 parity checks' 1e-4 tolerance,
// and fp32 attention runs only in those checks.
//
// No atomics: every sum runs in a fixed order, so results repeat bit for bit.
//
// Layout: q (B, S, Hq, D), k/v (B, S, Hkv, D) with unit element stride and
// head stride D (batch and token strides are arguments, so split views of
// a fused QKV projection need no copy; bf16 needs 16-byte aligned bases and
// token and batch strides that are multiples of 8 elements, which the
// wrapper checks); key_valid (B, S) int32; out (B, S, Hq, D) contiguous;
// m, l (B, Hq, S) fp32.

#include <climits>

#include "mma.cuh"

namespace nxdi {
namespace {

constexpr int BKV = 64;  // kv positions per tile

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  const int* key_valid;
  void* out;
  float* m;
  float* l;
  int S, Hq, Hkv;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss;
  float scale;
  int causal, window, chunk, softmax_bf16;
};

// reference _tile_live: false when the (bq, BKV) tile lies entirely outside
// the mask
__device__ __forceinline__ bool tile_live(int q_start, int bq, int kv_start, const FlashParams& p) {
  const int q_last = q_start + bq - 1;
  bool run = !p.causal || kv_start <= q_last;
  if (p.window > 0) run = run && (kv_start + BKV - 1 > q_start - p.window);
  if (p.chunk > 0) {
    run = run && (kv_start / p.chunk) <= (q_last / p.chunk);
    run = run && ((kv_start + BKV - 1) / p.chunk) >= (q_start / p.chunk);
  }
  return run;
}

// reference _tile_mask for one (row, col)
__device__ __forceinline__ bool allowed(int row, int col, bool valid, const FlashParams& p) {
  bool ok = valid;
  if (p.causal) ok = ok && col <= row;
  if (p.window > 0) ok = ok && col > row - p.window;
  if (p.chunk > 0) ok = ok && (col / p.chunk) == (row / p.chunk);
  return ok;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (the mma.sync helpers and the softmax step are in
// mma.cuh, shared with B5 and B6)
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 4;

template <int D>
struct MmaTile {
  static constexpr int BQ = 16 * MMA_WARPS;  // query rows per block
  static constexpr int LD = D + 8;     // bf16 per shared row: 16 bytes of padding
  static constexpr int KV = BKV * LD;  // one K or V tile
  // Q, then two stages of (K, V), then two stages of key validity
  static constexpr size_t smem = sizeof(__nv_bfloat16) * (size_t)(BQ * LD + 4 * KV) + sizeof(int) * 2 * BKV;
};

template <int D, bool SOFTMAX_BF16>
__global__ void __launch_bounds__(MMA_WARPS * 32) flash_fwd_mma(const FlashParams p) {
  using Tile = MmaTile<D>;
  using bf16 = __nv_bfloat16;
  constexpr int BQ = Tile::BQ;
  constexpr int LD = Tile::LD;
  constexpr int THREADS = MMA_WARPS * 32;
  constexpr int CH = D / 8;              // 16-byte chunks per row
  constexpr int ROW_STEP = THREADS / CH; // rows between one thread's chunks
  constexpr int KS = D / 16;             // k steps of Q K^T
  constexpr int NT = BKV / 8;            // n tiles of the score tile
  constexpr int DT = D / 8;              // n tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* KVs = Qs + BQ * LD;  // stage s: K at KVs + 2 s KV, V right after
  int* valid_s = reinterpret_cast<int*>(KVs + 4 * Tile::KV);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q_start = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  // thread tid copies chunk tid % CH of rows tid / CH + ROW_STEP u
  const int cr = tid / CH, cc = (tid % CH) * 8;
  const bf16* qp = static_cast<const bf16*>(p.q) + (long long)b * p.q_sb + (long long)h * D + cc;
  const bf16* kp = static_cast<const bf16*>(p.k) + (long long)b * p.k_sb + (long long)hk * D + cc;
  const bf16* vp = static_cast<const bf16*>(p.v) + (long long)b * p.v_sb + (long long)hk * D + cc;
  const int* valid_row = p.key_valid + (long long)b * p.S;

#pragma unroll
  for (int r = cr; r < BQ; r += ROW_STEP) {
    const int s = q_start + r;
    cp_async16(Qs + r * LD + cc, qp + (long long)(s < p.S ? s : 0) * p.q_ss, s < p.S);
  }
  cp_async_commit();

  // the live kv tiles are an interval: causal bounds it above, the window
  // below, the chunk on both sides
  const int nkv = (p.S + BKV - 1) / BKV;
  int j0 = nkv, j1 = 0;
  for (int j = 0; j < nkv; ++j) {
    if (tile_live(q_start, BQ, j * BKV, p)) {
      j0 = min(j0, j);
      j1 = j + 1;
    }
  }

  auto load_tile = [&](int j, int stage) {
    const int kv0 = j * BKV;
    bf16* Ks = KVs + 2 * stage * Tile::KV + cc;
    bf16* Vs = Ks + Tile::KV;
#pragma unroll
    for (int r = cr; r < BKV; r += ROW_STEP) {
      const int s = kv0 + r;
      const long long src = (long long)(s < p.S ? s : 0);
      cp_async16(Ks + r * LD, kp + src * p.k_ss, s < p.S);
      cp_async16(Vs + r * LD, vp + src * p.v_ss, s < p.S);
    }
    for (int i = tid; i < BKV; i += THREADS) {
      const int s = kv0 + i;
      cp_async4(valid_s + stage * BKV + i, valid_row + (s < p.S ? s : 0), s < p.S);
    }
    cp_async_commit();
  };

  // lane (g, t) = (lane / 4, lane % 4) holds rows g and g + 8 of the warp's
  // 16: score / output columns 8 n + 2 t and 8 n + 2 t + 1 of each n tile
  const int g = lane / 4, t4 = lane % 4;
  const int row0 = q_start + warp * 16 + g;
  // the mask predicate as each row's interval of allowed columns (key
  // validity apart): `allowed` with no division in the tile loop
  int col_lo[2], col_hi[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = row0 + 8 * rr;
    col_lo[rr] = p.window > 0 ? row - p.window + 1 : 0;
    col_hi[rr] = p.causal ? row : INT_MAX;
    if (p.chunk > 0) {
      const int c0 = row / p.chunk * p.chunk;
      col_lo[rr] = max(col_lo[rr], c0);
      col_hi[rr] = min(col_hi[rr], c0 + p.chunk - 1);
    }
  }
  float m_i[2] = {NEG_INF, NEG_INF}, l_i[2] = {0.f, 0.f};
  float o[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  uint32_t qf[KS][4];

  if (j0 < j1) load_tile(j0, 0);
  for (int j = j0; j < j1; ++j) {
    const int stage = (j - j0) & 1;
    if (j + 1 < j1) {
      load_tile(j + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == j0) {
      // A fragments of the warp's 16 Q rows: matrices (rows 0-7 | 8-15) x
      // (cols 0-7 | 8-15) of each k step
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldmatrix_x4(qf[ks], Qs + (warp * 16 + (lane % 8) + 8 * ((lane / 8) % 2)) * LD + ks * 16 + 8 * (lane / 16));
    }
    const bf16* Ks = KVs + 2 * stage * Tile::KV;
    const bf16* Vs = Ks + Tile::KV;
    const int* vs = valid_s + stage * BKV;
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

    // the mask: key validity of the tile's 64 columns as two ballot words;
    // a tile that every row of the warp sees whole takes no per-element
    // predicate
    const uint32_t vbits[2] = {__ballot_sync(0xffffffffu, vs[lane] != 0),
                               __ballot_sync(0xffffffffu, vs[lane + 32] != 0)};
    const bool whole = __all_sync(0xffffffffu, (vbits[0] & vbits[1]) == 0xffffffffu &&
                                                   col_lo[0] <= kv0 && col_lo[1] <= kv0 &&
                                                   col_hi[0] >= kv0 + BKV - 1 && col_hi[1] >= kv0 + BKV - 1);
    float alpha[2];
    if (whole) {
      softmax_step<false, SOFTMAX_BF16>(s, 0u, p.scale, m_i, l_i, alpha);
    } else {
      uint32_t ok_bits = 0;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * t4 + (e & 1);
          const int rr = e >> 1;
          const bool ok = ((vbits[n / 4] >> (col % 32)) & 1u) && kv0 + col >= col_lo[rr] && kv0 + col <= col_hi[rr];
          ok_bits |= (ok ? 1u : 0u) << (n * 4 + e);
        }
      }
      softmax_step<true, SOFTMAX_BF16>(s, ok_bits, p.scale, m_i, l_i, alpha);
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
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();  // (no live tile: the Q copy)

  bf16* op = static_cast<bf16*>(p.out) + (long long)b * p.S * p.Hq * D + (long long)h * D;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = row0 + 8 * rr;
    if (row >= p.S) continue;
    const float denom = fmaxf(l_i[rr], 1e-30f);
    __nv_bfloat162* orow = reinterpret_cast<__nv_bfloat162*>(op + (long long)row * p.Hq * D);
#pragma unroll
    for (int n = 0; n < DT; ++n)
      orow[(n * 8 + 2 * t4) / 2] = __floats2bfloat162_rn(o[n][2 * rr] / denom, o[n][2 * rr + 1] / denom);
    if (t4 == 0) {
      const long long mo = ((long long)b * p.Hq + h) * p.S + row;
      p.m[mo] = m_i[rr];
      p.l[mo] = l_i[rr];
    }
  }
}

template <int D, bool SOFTMAX_BF16>
cudaError_t launch_mma(const FlashParams& p, int B, cudaStream_t stream) {
  using Tile = MmaTile<D>;
  const cudaError_t err = cudaFuncSetAttribute(flash_fwd_mma<D, SOFTMAX_BF16>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tile::smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + Tile::BQ - 1) / Tile::BQ, p.Hq, B);
  flash_fwd_mma<D, SOFTMAX_BF16><<<grid, MMA_WARPS * 32, Tile::smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_mma(const FlashParams& p, int B, cudaStream_t st) {
  return p.softmax_bf16 ? launch_mma<D, true>(p, B, st) : launch_mma<D, false>(p, B, st);
}

// ---------------------------------------------------------------------------
// fp32: FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int BQ = 64;  // query rows per block
constexpr int THREADS = 128;
// thread (r, c) = (tid / 8, tid % 8) owns query rows r + 16 * i (i < 4)
// and score columns c + 8 * j (j < 8) of the 64 x 64 score tile, and
// output columns c + 8 * j (j < D / 8) of its rows
constexpr int RG = 16;
constexpr int CG = 8;
constexpr int ROWS_T = BQ / RG;
constexpr int COLS_T = BKV / CG;

template <int D>
constexpr size_t fp32_smem_bytes() {
  // Q and K tiles padded to D + 1 floats a row (conflict-free column reads),
  // V tile, probability tile padded to BKV + 1, key validity of the tile
  return sizeof(float) * (size_t)(BQ * (D + 1) + BKV * (D + 1) + BKV * D + BQ * (BKV + 1)) +
         sizeof(int) * BKV;
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_fp32(const FlashParams p) {
  using T = float;
  constexpr int LD = D + 1;
  constexpr int PLD = BKV + 1;
  constexpr int DT = D / CG;  // output columns per thread and row
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BKV * LD;
  float* Ps = Vs + BKV * D;
  int* valid_s = reinterpret_cast<int*>(Ps + BQ * PLD);

  const int tid = threadIdx.x;
  const int r = tid / CG;
  const int c = tid % CG;
  const int q_start = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);

  const T* qp = static_cast<const T*>(p.q) + (long long)b * p.q_sb + (long long)h * D;
  const T* kp = static_cast<const T*>(p.k) + (long long)b * p.k_sb + (long long)hk * D;
  const T* vp = static_cast<const T*>(p.v) + (long long)b * p.v_sb + (long long)hk * D;
  const int* valid_row = p.key_valid + (long long)b * p.S;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int row = idx / D, d = idx % D;
    const int s = q_start + row;
    Qs[row * LD + d] = s < p.S ? to_float(qp[(long long)s * p.q_ss + d]) : 0.f;
  }

  float m_i[ROWS_T], l_i[ROWS_T], acc[ROWS_T][DT];
#pragma unroll
  for (int i = 0; i < ROWS_T; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DT; ++j) acc[i][j] = 0.f;
  }

  const int nkv = (p.S + BKV - 1) / BKV;
  for (int jt = 0; jt < nkv; ++jt) {
    const int kv_start = jt * BKV;
    if (!tile_live(q_start, BQ, kv_start, p)) continue;  // uniform over the block
    __syncthreads();  // the previous tile's readers are done (and Q is loaded)
    for (int idx = tid; idx < BKV * D; idx += THREADS) {
      const int row = idx / D, d = idx % D;
      const int s = kv_start + row;
      float kv = 0.f, vv = 0.f;
      if (s < p.S) {
        kv = to_float(kp[(long long)s * p.k_ss + d]);
        vv = to_float(vp[(long long)s * p.v_ss + d]);
        if (p.softmax_bf16) vv = round_bf16(vv);  // the packed bf16 PV operand
      }
      Ks[row * LD + d] = kv;
      Vs[row * D + d] = vv;
    }
    for (int idx = tid; idx < BKV; idx += THREADS) {
      const int s = kv_start + idx;
      valid_s[idx] = (s < p.S && valid_row[s] > 0) ? 1 : 0;
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
      for (int i = 0; i < ROWS_T; ++i) qv[i] = Qs[(r + RG * i) * LD + d];
#pragma unroll
      for (int j = 0; j < COLS_T; ++j) kv[j] = Ks[(c + CG * j) * LD + d];
#pragma unroll
      for (int i = 0; i < ROWS_T; ++i)
#pragma unroll
        for (int j = 0; j < COLS_T; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < ROWS_T; ++i) {
      const int lrow = r + RG * i;
      const int row = q_start + lrow;
      bool ok[COLS_T];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < COLS_T; ++j) {
        const int lcol = c + CG * j;
        ok[j] = allowed(row, kv_start + lcol, valid_s[lcol] != 0, p);
        sc[i][j] = ok[j] ? sc[i][j] * p.scale : NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
      mx = group_max<CG>(mx);
      const float m_new = fmaxf(m_i[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < COLS_T; ++j) {
        float t = sc[i][j] - m_new;
        if (p.softmax_bf16) t = round_bf16(t);
        float e = expf(t);
        if (p.softmax_bf16) e = round_bf16(e);
        const float pv = ok[j] ? e : 0.f;
        Ps[lrow * PLD + c + CG * j] = pv;
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
      for (int i = 0; i < ROWS_T; ++i) pr[i] = Ps[(r + RG * i) * PLD + kk];
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const float vv = Vs[kk * D + c + CG * j];
#pragma unroll
        for (int i = 0; i < ROWS_T; ++i) acc[i][j] = fmaf(pr[i], vv, acc[i][j]);
      }
    }
  }

  T* op = static_cast<T*>(p.out) + (long long)b * p.S * p.Hq * D + (long long)h * D;
#pragma unroll
  for (int i = 0; i < ROWS_T; ++i) {
    const int row = q_start + r + RG * i;
    if (row >= p.S) continue;
    const float denom = fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DT; ++j)
      op[(long long)row * p.Hq * D + c + CG * j] = from_float<T>(acc[i][j] / denom);
    if (c == 0) {
      const long long o = ((long long)b * p.Hq + h) * p.S + row;
      p.m[o] = m_i[i];
      p.l[o] = l_i[i];
    }
  }
}

template <int D>
cudaError_t launch_fp32(const FlashParams& p, int B, cudaStream_t stream) {
  constexpr size_t smem = fp32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_fp32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + BQ - 1) / BQ, p.Hq, B);
  flash_fwd_fp32<D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace nxdi

extern "C" int nxdi_flash_attention_fwd(
    const void* q, const void* k, const void* v, const int* key_valid,
    void* out, float* m, float* l,
    int B, int S, int Hq, int Hkv, int D,
    int q_sb, int q_ss, int k_sb, int k_ss, int v_sb, int v_ss,
    float scale, int causal, int window, int chunk, int softmax_bf16,
    int dtype, void* stream) {
  using namespace nxdi;
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  FlashParams p{q, k, v, key_valid, out, m, l, S, Hq, Hkv,
                q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                scale, causal, window, chunk, softmax_bf16};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kFloat32 && D == 64) err = launch_fp32<64>(p, B, st);
  else if (dtype == kFloat32 && D == 128) err = launch_fp32<128>(p, B, st);
  else if (dtype == kBFloat16 && D == 64) err = dispatch_mma<64>(p, B, st);
  else if (dtype == kBFloat16 && D == 128) err = dispatch_mma<128>(p, B, st);
  return (int)err;
}
