// Ragged paged attention on Hopper (sm_90a): kernel B3 of the port.
//
// Replaces the TPU kernel neuronx_distributed_inference_tpu/ops/
// ragged_paged_attention.py::ragged_paged_attention (_ragged_kernel) for
// bf16/fp32 caches and, in code mode, int8/fp8 code blocks with the
// reference's k_scale / v_scale.
//
// What it computes: one launch for a serving step's prefill chunks AND
// decode rows, their query tokens packed on one axis of T slots (T a
// multiple of Q_TILE = 16). Row r owns slots [row_start[r], row_start[r] +
// row_len[r]) (row_len 0 = inactive); every row_start is a multiple of
// Q_TILE, so a tile of 16 slots belongs to at most one row. Slot i of row r
// sits at position q_pos = ctx_len[r] - row_len[r] + (i - row_start[r]) and
// attends the row's paged cache at positions p <= q_pos with p < ctx_len[r]
// (prior context plus causal among the new tokens, whose K/V the caller has
// already written). Online softmax in fp32 with NEG_INF = -1e30 fills and
// masked probabilities zeroed; out = acc / max(l, 1e-30). A slot that
// belongs to no row, or that lies past its row's row_len, gets exact zeros:
// every element of out is written.
//
// Design: one block per (q tile of 16 slots, kv head g, head group, kv
// split); the grid's z axis runs head groups within splits. Its query rows
// are the 16 slots times up to 4 q heads of kv head g (HG heads, the
// largest divisor of n_rep that is <= 4): they share every K/V tile load,
// so repeat_kv never exists. The block finds its tile's row by scanning the
// R descriptors itself (R is the session's slot count, a few dozen at
// most): the first active row whose segment holds the tile's first slot.
// No tensor is built per launch (the TPU wrapper built tile_row / tile_max
// for its scalar prefetch in every layer), and the descriptors are the same
// in all layers. Then, by the tile's row:
// - bf16, a prefill tile (row_len > 1, which includes a chunk that starts
//   mid-context): B5's tensor-core body (paged_attention_tile.cuh
//   flash_mma: mma.sync m16n8k16 for Q K^T and P V with P in registers,
//   rounded to bf16 for P V as B5 does; K / V by 16-byte cp.async through
//   the block table into two padded stages), query row qr = slot qr % 16 of
//   local head qr / 16, so warp w holds head w's 16 slots. Split 0 only.
// - bf16, a decode tile (row_len == 1: one live slot of 16): B4's split
//   template (decode_attention.cu split_kernel, paged mode), warp w < HG
//   owning the one query row of head w: the split's positions [z per, (z +
//   1) per) of the row's context, its table entries staged in shared memory,
//   64-position tiles by 16-byte cp.async into two stages, one barrier a
//   tile, fp32 FMAs (one query row a kv head: tensor cores would buy
//   nothing). A split past the row's context exits at once. With more than
//   one live split each stores its (m, l, acc) and the last to finish (a
//   completion counter per (tile, kv head, head group), common.cuh
//   last_block) combines the live splits in split order, in the same
//   launch: one B3 launch a layer. Split 0 writes the tile's 15 other slots
//   as zeros. The split (ops/ragged_paged_attention.py::ragged_decode_split)
//   is B4's rule over the table's MB * bs positions for the grid's (tile, kv
//   head, head group) blocks: a function of the shapes and the card only.
// - fp32 (parity checks only): the first version's FMA loop,
//   paged_attention_tile.cuh attend (B5's fp32 path too), no split.
// - Code mode (int8 / fp8 e4m3 / e5m2 code blocks with the layer's (Hkv,)
//   running scales and the code type's qmax, read on the device at launch,
//   so a captured graph sees each step's): the same routes over 1-byte
//   code tiles, the caller's q taken as it is and nothing folded into it or
//   written around the launch; K's factor scale / qmax multiplies the score
//   scale, V's the finalized output (after the combine) before its one
//   rounding. With a bf16 q, prefill tiles run flash_mma over code tiles
//   (three 1-byte stages, each tile converted by the block into a padded
//   bf16 pair: exactly, every code being a bf16 value) and decode tiles
//   the split template over code tiles (kv_tile.cuh, B4's staging: 1-byte
//   rows padded by 16 bytes, codes to fp32 in registers), split and
//   combined in the launch as in bf16. An fp32 q takes attend, one split.
// - A tile of no row writes zeros; so does a prefill tile's slot past its
//   row's row_len. Block 0, any id outside [1, NB] and any position >=
//   ctx_len[r] load as zeros (cp.async's zero fill in bf16): the fault
//   tests fill block 0 with NaN, and 0 * NaN is NaN.
// No atomics in any sum: the combine runs in split order, so results repeat
// bit for bit.
//
// What bounds it on an H100: K/V bytes. The serving row's mixed step (one
// 128-token chunk from 0 and 7 decode rows 192 deep; Hq 32, Hkv 8, D 64,
// bf16) moves ~5.0 MB of q, out and K/V for ~79 MFLOP, ~16 FLOP/byte, far
// under the ~295 FLOP/byte ridge (ops/roofline.py, RAGGED_POINTS). The
// first version ran every tile through fp32 FMAs, element loads and three
// barriers a tile, with a decode row's tile 1 slot of 16 live: its time
// (0.1083 ms at both points) was the longest chain of 192 positions.
//
// Layout: q (T, Hq, D) contiguous; k/v one layer (NB+1, Hkv, bs, D)
// contiguous (bf16: 16-byte aligned bases); block_table (R, MB) int32;
// row_start, row_len, ctx_len (R,) int32; out (T, Hq, D) contiguous.

#include <algorithm>

#include "kv_tile.cuh"
#include "paged_attention_tile.cuh"

namespace nxdi {
namespace {

using paged::BQ;
using paged::RG;
using paged::ROWS_T;
using paged::THREADS;

constexpr int Q_TILE = 16;  // packed slots per tile (the reference's RAGGED_Q_TILE)
constexpr int DS_TILE = kv::TILE;  // decode tiles: positions per staged tile
constexpr int MAX_SPLITS = 32;

struct RaggedParams {
  const void* q;
  const void* k;
  const void* v;
  const int* block_table;
  const int* row_start;
  const int* row_len;
  const int* ctx_len;
  void* out;
  float* m_part;  // decode tiles' split partials: (splits, T / 16, Hq)
  float* l_part;
  float* acc_part;  // (splits, T / 16, Hq, D)
  unsigned* counter;  // (T / 16, Hkv, head groups), 0 between launches
  int R, Hq, Hkv, HG, NB1, bs, MB, splits, per, tiles;
  float scale;
  // code mode: the layer's (Hkv,) fp32 K / V running scales and the code
  // type's qmax (null and 0 for a plain cache)
  const float* k_scale;
  const float* v_scale;
  float qmax;
};

// The tile's row: the first active row whose segment holds slot t0, or R.
// Every thread of the block must call it.
__device__ __forceinline__ int tile_owner(const RaggedParams& p, int t0) {
  __shared__ int owner;
  if (threadIdx.x == 0) owner = p.R;
  __syncthreads();
  for (int r = threadIdx.x; r < p.R; r += THREADS) {
    const int rs = p.row_start[r], rl = p.row_len[r];
    if (rl > 0 && rs <= t0 && t0 < rs + rl) atomicMin(&owner, r);
  }
  __syncthreads();
  return owner;
}

// T: q and out; C: the cache (T, or 1-byte codes with T = float)
template <typename T, typename C, int D>
__global__ void __launch_bounds__(THREADS) ragged_paged_kernel(const RaggedParams p) {
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  const paged::Smem<D> sm(smem);

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * Q_TILE;  // the tile's first packed slot
  const int g = blockIdx.y;
  const int h0 = g * (p.Hq / p.Hkv) + blockIdx.z * p.HG;  // the block's first q head
  const T* qp = static_cast<const T*>(p.q);
  T* op = static_cast<T*>(p.out);

  const int row = tile_owner(p, t0);
  const bool has = row < p.R;
  const int rs = has ? p.row_start[row] : 0;
  const int rl = has ? p.row_len[row] : 0;
  const int cl = has ? p.ctx_len[row] : 0;
  // the row's table covers MB * bs positions: nothing past them exists
  const int limit = has ? min(cl, p.MB * p.bs) : 0;

  // query row qr -> (slot t0 + qr % Q_TILE, head h0 + qr / Q_TILE); rows of
  // no head, and slots past the row's segment, carry position -1
  for (int qr = tid; qr < BQ; qr += THREADS) {
    const int off = t0 + qr % Q_TILE - rs;
    sm.pos[qr] = (has && qr / Q_TILE < p.HG && off < rl) ? cl - rl + off : -1;
  }
  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int qr = idx / D, d = idx % D;
    const int lh = qr / Q_TILE;
    sm.Qs[qr * LD + d] =
        lh < p.HG ? to_float(qp[((long long)(t0 + qr % Q_TILE) * p.Hq + h0 + lh) * D + d]) : 0.f;
  }
  __syncthreads();

  float l_i[ROWS_T], acc[ROWS_T][D / paged::CG];
  paged::attend<C, D>(sm, static_cast<const C*>(p.k), static_cast<const C*>(p.v),
                      p.block_table + (long long)(has ? row : 0) * p.MB, g, p.Hkv, p.bs, p.NB1,
                      limit, p.scale * dequant_factor(p.k_scale, g, p.qmax), l_i, acc);
  const float vf = dequant_factor(p.v_scale, g, p.qmax);

  // thread (r, c) holds the rows r + RG * i: slot r of the tile, local head i
  const int r = tid / paged::CG;
#pragma unroll
  for (int i = 0; i < ROWS_T; ++i) {
    const int qr = r + RG * i;
    const int lh = qr / Q_TILE;
    if (lh >= p.HG) continue;
    paged::finalize_row<T, D>(op + ((long long)(t0 + qr % Q_TILE) * p.Hq + h0 + lh) * D, l_i[i], acc[i], vf);
  }
}

static_assert(RG == Q_TILE, "a thread's rows must be one slot's heads");

// ---------------------------------------------------------------------------
// bf16 q: prefill tiles on the tensor cores, decode tiles split over the
// grid; over a bf16 cache or code blocks C
// ---------------------------------------------------------------------------

// A decode tile's shared memory: the HG bf16 query rows, two stages of (K,
// V) tiles of C in padded rows (kv_tile.cuh), a probability row per warp,
// the split's table entries.
template <typename C, int D>
struct DecodeTile {
  static constexpr int KV = kv::Row<C, D>::KV;
  static size_t smem(int per, int bs) {
    return sizeof(__nv_bfloat16) * (size_t)4 * D + sizeof(C) * (size_t)4 * KV + sizeof(float) * 4 * DS_TILE +
           sizeof(int) * (per / bs + 2);
  }
};

// The decode tile `tile` (its live slot t0 = 16 tile, row `row`, limit
// positions of context) for kv head g, q heads [h0, h0 + HG), kv split z.
template <typename C, int D>
__device__ __forceinline__ void decode_tile(unsigned char* smem_raw, const RaggedParams& p, int tile, int g, int h0,
                                            int hgi, int z, int row, int limit) {
  using bf16 = __nv_bfloat16;
  using Tile = DecodeTile<C, D>;
  constexpr int EQ = 8;        // bf16 per 16 bytes
  constexpr int QPR = D / EQ;  // 16-byte vectors per q row
  constexpr int DPL = D / 32;  // output dims per lane
  const int lo = z * p.per;
  if (lo >= limit) return;  // past the row's context: the combine counts live splits only
  const int hi = min(lo + p.per, limit);
  const int n_live = (limit + p.per - 1) / p.per;
  const int nt = (hi - lo + DS_TILE - 1) / DS_TILE;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int t0 = tile * Q_TILE;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // (4, D)
  C* KVs = reinterpret_cast<C*>(Qs + 4 * D);     // stage s: K at 2 s KV, V right after
  float* Pw = reinterpret_cast<float*>(KVs + 4 * Tile::KV) + warp * DS_TILE;
  int* table_s = reinterpret_cast<int*>(reinterpret_cast<float*>(KVs + 4 * Tile::KV) + 4 * DS_TILE);
  const bf16* qp = static_cast<const bf16*>(p.q);
  bf16* op = static_cast<bf16*>(p.out);

  // warp w < HG owns the query row of head h0 + w at slot t0
  for (int i = tid; i < p.HG * QPR; i += THREADS) {
    const int r = i / QPR, e = (i % QPR) * EQ;
    cp_async16(Qs + r * D + e, qp + ((long long)t0 * p.Hq + h0 + r) * D + e, true);
  }
  cp_async_commit();
  // the split's table entries, ids outside [1, NB] as 0 (zero fill)
  const int blk0 = lo / p.bs;
  const int* bt = p.block_table + (long long)row * p.MB;
  for (int i = tid; i <= (hi - 1) / p.bs - blk0; i += THREADS) {
    const int blk = bt[blk0 + i];
    table_s[i] = blk > 0 && blk < p.NB1 ? blk : 0;
  }
  __syncthreads();

  const C* kc = static_cast<const C*>(p.k);
  const C* vc = static_cast<const C*>(p.v);
  auto load_tile = [&](int j, int stage) {
    const int s0 = lo + j * DS_TILE;
    C* Ks = KVs + 2 * stage * Tile::KV;
    kv::stage_tile<C, D>(Ks, Ks + Tile::KV, kc, vc, min(DS_TILE, hi - s0), [&](int c, int e) -> long long {
      const int s = s0 + c;
      const int blk = table_s[s / p.bs - blk0];  // block 0 reads nothing
      return blk != 0 ? (((long long)blk * p.Hkv + g) * p.bs + s % p.bs) * D + e : -1;
    }, tid, THREADS);
  };

  const float score_scale = p.scale * dequant_factor(p.k_scale, g, p.qmax);
  const bool has_row = warp < p.HG;
  float m_r[1] = {NEG_INF}, l_r[1] = {0.f}, acc[1][DPL];
#pragma unroll
  for (int k = 0; k < DPL; ++k) acc[0][k] = 0.f;
  load_tile(0, 0);
  for (int j = 0, stage = 0; j < nt; ++j, stage ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // tile j landed for every thread; every warp is done with the other stage
    if (j + 1 < nt) load_tile(j + 1, stage ^ 1);
    if (!has_row) continue;
    const C* Ks = KVs + 2 * stage * Tile::KV;
    // every position < limit is allowed
    kv::tile_rows<bf16, C, D, 1, THREADS / 32>(Qs, Ks, Ks + Tile::KV, min(DS_TILE, hi - lo - j * DS_TILE), 1,
                                               score_scale, [](int, int) { return true; }, Pw, m_r, l_r, acc);
  }
  cp_async_wait<0>();

  // the tile's 15 other slots are no row's: exact zeros (split 0)
  if (z == 0) {
    for (int i = tid; i < (Q_TILE - 1) * p.HG * QPR; i += THREADS) {
      const int slot = t0 + 1 + i / (p.HG * QPR), r = (i / QPR) % p.HG, e = (i % QPR) * EQ;
      *reinterpret_cast<uint4*>(op + ((long long)slot * p.Hq + h0 + r) * D + e) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  const float vf = dequant_factor(p.v_scale, g, p.qmax);
  const long long TH = (long long)p.tiles * p.Hq;
  const long long rh = (long long)tile * p.Hq + h0 + warp;  // (tile, q head) of the warp's row
  bf16* orow = op + ((long long)t0 * p.Hq + h0 + warp) * D + lane * DPL;
  if (n_live == 1) {
    if (has_row) {
#pragma unroll
      for (int k = 0; k < DPL; ++k) orow[k] = from_float<bf16>(acc[0][k] / fmaxf(l_r[0], 1e-30f) * vf);
    }
    return;
  }
  if (has_row) {
    const long long o = z * TH + rh;
    if (lane == 0) {
      p.m_part[o] = m_r[0];
      p.l_part[o] = l_r[0];
    }
#pragma unroll
    for (int k = 0; k < DPL; ++k) p.acc_part[o * D + lane * DPL + k] = acc[0][k];
  }
  const int n_hg = (p.Hq / p.Hkv) / p.HG;
  if (!last_block(p.counter + ((long long)tile * p.Hkv + g) * n_hg + hgi, n_live) || !has_row) return;
  // the live splits in split order: lane z loads split z's (m, l); sum_z
  // acc_z e^(m_z - M) / max(sum_z l_z e^(m_z - M), 1e-30), M their maximum
  const float mz = lane < n_live ? __ldcg(p.m_part + lane * TH + rh) : NEG_INF;
  const float lz = lane < n_live ? __ldcg(p.l_part + lane * TH + rh) : 0.f;
  constexpr int ZB = 8;
  float az[ZB][DPL];
  auto load_az = [&](int z0) {
#pragma unroll
    for (int u = 0; u < ZB; ++u)
#pragma unroll
      for (int k = 0; k < DPL; ++k)
        az[u][k] = z0 + u < n_live ? __ldcg(p.acc_part + ((z0 + u) * TH + rh) * D + lane * DPL + k) : 0.f;
  };
  load_az(0);  // in flight beside the (m, l) loads
  const float mx = group_max<32>(mz);
  const float w = expf(mz - mx);
  float num[DPL], den = 0.f;
#pragma unroll
  for (int k = 0; k < DPL; ++k) num[k] = 0.f;
  for (int z0 = 0; z0 < n_live; z0 += ZB) {
    if (z0) load_az(z0);
#pragma unroll
    for (int u = 0; u < ZB; ++u) {
      if (z0 + u < n_live) {
        const float wz = __shfl_sync(0xffffffffu, w, z0 + u);
        den = fmaf(__shfl_sync(0xffffffffu, lz, z0 + u), wz, den);
#pragma unroll
        for (int k = 0; k < DPL; ++k) num[k] = fmaf(az[u][k], wz, num[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < DPL; ++k) orow[k] = from_float<bf16>(num[k] / fmaxf(den, 1e-30f) * vf);
}

template <typename C, int D>
__global__ void __launch_bounds__(THREADS) ragged_bf16_kernel(const RaggedParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tile = blockIdx.x, t0 = tile * Q_TILE;
  const int g = blockIdx.y;
  const int n_hg = (p.Hq / p.Hkv) / p.HG;
  const int hgi = blockIdx.z % n_hg, z = blockIdx.z / n_hg;
  const int h0 = g * (p.Hq / p.Hkv) + hgi * p.HG;  // the block's first q head
  const int row = tile_owner(p, t0);
  const bool has = row < p.R;
  const int rs = has ? p.row_start[row] : 0;
  const int rl = has ? p.row_len[row] : 0;
  const int cl = has ? p.ctx_len[row] : 0;
  // the row's table covers MB * bs positions: nothing past them exists
  const int limit = has ? min(cl, p.MB * p.bs) : 0;
  if (rl == 1) {
    decode_tile<C, D>(smem_raw, p, tile, g, h0, hgi, z, row, limit);
    return;
  }
  if (z > 0) return;  // a prefill tile, or a tile of no row: split 0 only
  // query row qr: slot t0 + qr % 16 of head h0 + qr / 16; rows of no head
  // are neither read nor written, slots past the row's segment are zeros
  auto row_off = [&](int qr) -> long long {
    return qr / Q_TILE < p.HG ? ((long long)(t0 + qr % Q_TILE) * p.Hq + h0 + qr / Q_TILE) * D : -1;
  };
  auto row_pos = [&](int qr) {
    const int off = t0 + qr % Q_TILE - rs;
    return has && off < rl ? cl - rl + off : -1;
  };
  paged::flash_mma<C, D>(smem_raw, static_cast<const __nv_bfloat16*>(p.q), static_cast<__nv_bfloat16*>(p.out),
                         row_off, row_pos, static_cast<const C*>(p.k), static_cast<const C*>(p.v),
                         p.block_table + (long long)(has ? row : 0) * p.MB, g, p.Hkv, p.bs, p.NB1, limit,
                         p.scale * dequant_factor(p.k_scale, g, p.qmax), dequant_factor(p.v_scale, g, p.qmax));
}

template <typename T, typename C, int D>
cudaError_t launch(const RaggedParams& p, cudaStream_t stream) {
  cudaError_t err = paged::allow_smem<D>(ragged_paged_kernel<T, C, D>);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.tiles, p.Hkv, (p.Hq / p.Hkv) / p.HG);
  ragged_paged_kernel<T, C, D><<<grid, THREADS, paged::smem_bytes<D>(), stream>>>(p);
  return cudaGetLastError();
}

template <typename C, int D>
cudaError_t launch_bf16(const RaggedParams& p, cudaStream_t stream) {
  const size_t smem = std::max(paged::MmaTile<C, D>::smem, DecodeTile<C, D>::smem(p.per, p.bs));
  const dim3 grid(p.tiles, p.Hkv, (p.Hq / p.Hkv) / p.HG * p.splits);
  return launch_ex(ragged_bf16_kernel<C, D>, grid, dim3(THREADS), smem, stream, false, p);
}

// a code cache C under a bf16 q (the split routes) or an fp32 q (attend,
// one split)
template <typename C>
cudaError_t launch_codes(const RaggedParams& p, int D, int dtype, cudaStream_t stream) {
  if (!p.k_scale || !p.v_scale || !(p.qmax > 0.f)) return cudaErrorInvalidValue;
  if (dtype == kBFloat16 && D == 64) return launch_bf16<C, 64>(p, stream);
  if (dtype == kBFloat16 && D == 128) return launch_bf16<C, 128>(p, stream);
  if (dtype == kFloat32 && p.splits == 1 && D == 64) return launch<float, C, 64>(p, stream);
  if (dtype == kFloat32 && p.splits == 1 && D == 128) return launch<float, C, 128>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace nxdi

// splits, per: the decode tiles' kv split (ops/ragged_paged_attention.py::
// ragged_decode_split; bf16 q only, fp32 takes 1); m_part / l_part /
// acc_part: fp32 scratch of splits * T / 16 * Hq (* D) values, counters:
// T / 16 * Hkv * (n_rep / HG) completion counters, zero on entry and left
// zero; both unused (may be null) for one split. cache_dtype: dtype, or an
// int8/fp8 code type, whose layer's (Hkv,) fp32 running scales k_scale /
// v_scale and qmax come with it (null and 0 for a plain cache).
extern "C" int nxdi_ragged_paged_attention(
    const void* q, const void* k, const void* v, const int* block_table,
    const int* row_start, const int* row_len, const int* ctx_len, void* out,
    float* m_part, float* l_part, float* acc_part, void* counters,
    int T, int R, int Hq, int Hkv, int HG, int D, int NB1, int bs, int MB, int splits, int per,
    float scale, int dtype, int cache_dtype, const float* k_scale, const float* v_scale, float qmax, void* stream) {
  using namespace nxdi;
  if (T <= 0 || T % Q_TILE != 0 || R <= 0 || Hkv <= 0 || Hq % Hkv != 0 || HG <= 0 ||
      (Hq / Hkv) % HG != 0 || HG * Q_TILE > BQ || NB1 <= 0 || bs <= 0 || MB <= 0 || splits < 1 ||
      splits > MAX_SPLITS || per < 1 || (long long)(splits - 1) * per >= (long long)MB * bs ||
      (long long)splits * per < (long long)MB * bs ||
      (splits > 1 && (!m_part || !l_part || !acc_part || !counters)))
    return (int)cudaErrorInvalidValue;
  RaggedParams p{q, k, v, block_table, row_start, row_len, ctx_len, out, m_part, l_part, acc_part,
                 static_cast<unsigned*>(counters), R, Hq, Hkv, HG, NB1, bs, MB, splits, per, T / Q_TILE, scale,
                 k_scale, v_scale, qmax};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cache_dtype == kInt8) return (int)launch_codes<int8_t>(p, D, dtype, st);
  if (cache_dtype == kFp8E4M3) return (int)launch_codes<Fp8E4M3>(p, D, dtype, st);
  if (cache_dtype == kFp8E5M2) return (int)launch_codes<Fp8E5M2>(p, D, dtype, st);
  if (cache_dtype != dtype) return (int)cudaErrorInvalidValue;
  if (dtype == kFloat32 && splits == 1 && D == 64) return (int)launch<float, float, 64>(p, st);
  if (dtype == kFloat32 && splits == 1 && D == 128) return (int)launch<float, float, 128>(p, st);
  if (dtype == kBFloat16 && D == 64) return (int)launch_bf16<__nv_bfloat16, 64>(p, st);
  if (dtype == kBFloat16 && D == 128) return (int)launch_bf16<__nv_bfloat16, 128>(p, st);
  return (int)cudaErrorInvalidValue;
}
