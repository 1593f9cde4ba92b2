// The fused decode attention block for Hopper (sm_90a): kernel B8 of the
// port.
//
// Replaces the TPU kernel neuronx_distributed_inference_tpu/ops/
// decode_block.py::fused_attn_block (_attn_block_kernel).
//
// What it computes, for batch row b with K <= 16 new tokens (rows r = b K + t
// of x, H wide), Hq query heads over Hkv kv heads of width D:
//   n_r   = rmsnorm(x_r) * gamma in fp32, rounded to the weight dtype once
//   qkv_r = n_r @ Wqkv in fp32 ([q | k | v], (Hq + 2 Hkv) D columns)
//   q, k  = RoPE (half rotation, fp32) of their heads at the tokens' cos/sin;
//           k_new / v_new = k and v rounded to x's dtype (returned for the
//           cache scatter the caller does after this kernel)
//   attn  = softmax attention of each q head over
//           - the row's own new tokens, causal (token t sees t' <= t), with
//             the fp32 k and v: the "active" part, and
//           - the prior cache, line slot_ids[b] of layer `layer` of the full
//             stacked (L, R, S_max, Hkv, D) cache, positions [0, S_kv), read
//             in the cache's dtype and widened, under the decode mask with
//             this step's slots [p0, p0 + K) taken out (p0 = positions[b, 0]);
//           fp32 scores, out = acc / max(l, 1e-30)
//   out_r = x_r + attn_r (rounded to the weight dtype) @ Wout, summed in fp32
//           and rounded once to x's dtype.
// These are the Pallas kernel's roundings. A row whose prior mask is all
// false still attends its own tokens, so its output is finite. A slot id
// outside [0, R) makes the row's output NaN.
//
// What bounds it on an H100: a decode layer reads the QKV and o-proj weights
// once (Wqkv 12.6 MB plus Wout 8.4 MB, 21.0 MB at Llama-3.2-1B) and each
// row's live cache once (2 S Hkv D values), with a handful of FLOP per byte
// against the card's ~295 FLOP/byte ridge: memory bandwidth bounds it.
//
// Design: the Pallas kernel ran one sequential grid per batch row (QKV
// tiles, then RoPE and the active part, then the cache tiles, then o-proj
// tiles) with fp32 scratch carried from step to step. Blocks on Hopper run
// in no order and carry nothing, so this is three grid launches from one
// entry (one B8 launch). The o-proj is a programmatic dependent launch
// (common.cuh) of the attention launch: it starts while (b) runs and waits
// for it (griddepcontrol) where it reads its output. The attention launch
// waits for the QKV launch to end: the product loop's blocks fill the SMs,
// so an attention block started early only lands where a QKV block has
// left, crowded, and ran the launch slower than one started after it
// (scripts/torch_attention_variants.py b8, "attn-pdl").
//   a. QKV (csrc/decode_gemv.cuh, GV_NORM): one block per 128 columns of
//      Wqkv holding every row, H split over the grid's z axis where the
//      column tiles alone do not fill the card (24 tiles x 11 splits at
//      1B). Each block computes its rows' rmsnorm itself, in the order of
//      a one-block-per-row rmsnorm, and stages the normed input rounded to
//      the weight dtype. fp32 partial sums.
//   b. attention, on B1's split template (csrc/decode_attention.cu
//      split_kernel): one block of 4 warps per (kv head, batch row, kv
//      split of `per` positions: one 64-position tile a split while the
//      grid stays within 4 blocks an SM, ops/decode_block.py::kv_split);
//      warp w owns query rows w, w + 4, ... (row hl K + t is local q head hl
//      at token t, rep-major, so GQA needs no repeat_kv), their scores,
//      online softmax (warp shuffles) and fp32 accumulators in registers,
//      the probabilities through a per-warp shared row. The block reads
//      its split's mask bytes once into a bit per (token, position) in
//      shared memory (the prior mask: this step's slots out, positions past
//      S_kv out), so no mask byte is read in the score loop and dead
//      64-position tiles are skipped; it issues its first live tile's
//      16-byte cp.async and stages its tokens' cos / sin. A split with no
//      live tile stores (NEG_INF, 0, 0). The others add the QKV partials in
//      split order and apply RoPE in fp32 to their q rows; the last split (at a decode
//      step's usual depth the one with the fewest live tiles) also ropes
//      the new keys, writes k_new / v_new and runs the active part over the
//      K new columns alone (causal). The live tiles stream through two
//      cp.async stages, one barrier a tile. Products are fp32 FMAs: at
//      n_rep K FLOP a byte the tensor cores would buy nothing. Each split
//      stores its unnormalized (m, l, acc); the last split block of a (row,
//      kv head) to finish (a completion counter, common.cuh last_block)
//      combines all splits in split order and writes the attention rows
//      rounded to the o-proj weight's dtype. One split finalizes in place.
//   c. o-proj (the GEMV with ResidualSink, GV_WAIT): fp32 partial sums
//      over a split of Hq D; each block issues its first weight stages
//      while (b) runs, then waits for it. The last split block of a column
//      tile adds x and the partials in split order and rounds once.
// The counters return to 0 in the block that finishes, so a call needs no
// host reset. No atomics in any sum: every sum runs in a fixed order, so
// greedy tokens repeat.

#include "decode_gemv.cuh"

namespace nxdi {
namespace {

constexpr int AT_THREADS = 128;
constexpr int AT_WARPS = AT_THREADS / 32;
constexpr int AT_MAX_ROWS = 64;  // n_rep * K query rows a block holds
constexpr int AT_TILE = 64;      // cache positions per staged tile
constexpr int AT_MAX_SPLITS = 32;

struct AttnParams {
  const float* qkv_part;  // (s_qkv, B K, N3)
  const float* cos;       // (B K, D / 2)
  const float* sin;
  const void* k_cache;  // (L, R, S_max, Hkv, D)
  const void* v_cache;
  const int* slot_ids;         // (B,)
  const unsigned char* mask;   // b * mask_sb + t * mask_st + s
  const int* positions;        // (B, K)
  float* m_part;               // (splits, B K, Hq)
  float* l_part;
  float* acc_part;             // (splits, B K, Hq, D)
  unsigned* counter;           // (B, Hkv), 0 between launches
  void* attn;                  // (B K, Hq D) in x's dtype
  void* k_new;                 // (B, K, Hkv, D)
  void* v_new;
  int B, K, Hq, Hkv, N3, R, S_max, S_kv, layer, s_qkv, splits, per;
  long long mask_sb, mask_st;
  float scale;
};

// The block's shared memory: fp32 q rows and new k / v rows (D + 4 floats a
// row: 16-byte aligned, and 8 lanes reading 8 rows hit distinct banks), two
// stages of (K, V) tiles in the cache's dtype padded by 16 bytes a row, a
// probability row per (warp, row), the prior-mask bits of the split (a
// 32-bit word per token and 32 positions), a live flag per tile and the
// K tokens' cos / sin.
template <typename T, int D>
struct AttnTile {
  static constexpr int LQ = D + 4;
  static constexpr int LD = D + 16 / (int)sizeof(T);
  static constexpr int KV = AT_TILE * LD;
  static __host__ __device__ int tiles(int per) { return (per + AT_TILE - 1) / AT_TILE; }
  static __host__ __device__ size_t kv_offset(int rows, int K) {
    return sizeof(float) * (size_t)(rows + 2 * K) * LQ;  // 16-byte multiple
  }
  static __host__ __device__ size_t pw_offset(int rows, int K) { return kv_offset(rows, K) + sizeof(T) * 4 * KV; }
  static __host__ __device__ size_t bits_offset(int rows, int K, int rw) {
    return pw_offset(rows, K) + sizeof(float) * AT_WARPS * rw * AT_TILE;
  }
  static __host__ __device__ size_t smem(int rows, int K, int rw, int per) {
    // ... then the live flags rounded up to 16 bytes, then cos / sin of the K tokens
    return bits_offset(rows, K, rw) + sizeof(unsigned) * K * tiles(per) * 2 + ((tiles(per) + 15) & ~15) +
           sizeof(float) * K * D;
  }
};

template <typename T, int D, int RW>
__global__ void __launch_bounds__(AT_THREADS) attn_kernel(const AttnParams p) {
  using Tile = AttnTile<T, D>;
  constexpr int LQ = Tile::LQ;
  constexpr int LD = Tile::LD;
  constexpr int HALF = D / 2;
  constexpr int EV = Vec16<T>::N;  // elements per 16 bytes
  constexpr int VPR = D / EV;      // 16-byte vectors per position
  constexpr int DPL = D / 32;      // output dims per lane
  extern __shared__ __align__(16) unsigned char at_smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int n_rep = p.Hq / p.Hkv;
  const int K = p.K;
  const int rows = n_rep * K;
  const int BK = p.B * K;
  // the split that also runs the active part (the row's new tokens): the
  // last, which at a decode step's usual depth has the fewest live tiles
  const int act = p.splits - 1;
  const int nk = z == act ? K : 0;  // the new tokens' k / v: that split only
  float* Qs = reinterpret_cast<float*>(at_smem);  // (rows, LQ), then k_new, v_new (K, LQ) each
  float* Kn = Qs + rows * LQ;
  float* Vn = Kn + K * LQ;
  T* KVs = reinterpret_cast<T*>(at_smem + Tile::kv_offset(rows, K));  // stage s: K at 2 s KV, V right after
  float* Pw = reinterpret_cast<float*>(at_smem + Tile::pw_offset(rows, K)) + warp * RW * AT_TILE;
  unsigned* okw = reinterpret_cast<unsigned*>(at_smem + Tile::bits_offset(rows, K, RW));
  const int lo = z * p.per, hi = min(lo + p.per, p.S_kv);
  const int nt = Tile::tiles(hi - lo);
  unsigned char* live_s = reinterpret_cast<unsigned char*>(okw + K * nt * 2);

  const int slot = p.slot_ids[b];
  const bool slot_ok = slot >= 0 && slot < p.R;
  const int p0 = p.positions[b * K];

  // --- before the QKV launch completes: the split's prior-mask bits and
  // its first live tile (neither depends on that launch) ---
  const T* kc = static_cast<const T*>(p.k_cache);
  const T* vc = static_cast<const T*>(p.v_cache);
  const long long line = ((long long)p.layer * p.R + (slot_ok ? slot : 0)) * p.S_max;
  const long long pos_stride = (long long)p.Hkv * D;
  auto load_tile = [&](int j, int stage) {
    const int s0 = lo + j * AT_TILE, n = min(AT_TILE, hi - s0);
    T* Ks = KVs + 2 * stage * Tile::KV;
    T* Vs = Ks + Tile::KV;
    for (int i = tid; i < n * VPR; i += AT_THREADS) {
      const int c = i / VPR, e = (i % VPR) * EV;
      const long long off = (line + s0 + c) * pos_stride + (long long)g * D + e;
      cp_async16(Ks + c * LD + e, kc + off, true);
      cp_async16(Vs + c * LD + e, vc + off, true);
    }
    cp_async_commit();
  };
  // the row's K tokens' cos / sin (inputs of this call) in shared memory
  float* cs = reinterpret_cast<float*>(live_s + ((nt + 15) & ~15));
  for (int i = tid; i < K * HALF; i += AT_THREADS) {
    cs[i] = p.cos[b * K * HALF + i];
    cs[K * HALF + i] = p.sin[b * K * HALF + i];
  }
  // bit `lane` of word (t nt + j) 2 + half: position lo + 64 j + 32 half +
  // lane is allowed for token t (none where the slot is out of range); the
  // mask bytes load beside the slot id and the positions
  const unsigned char* mrow = p.mask + (long long)b * p.mask_sb;
  for (int w = warp; w < K * nt * 2; w += AT_WARPS) {
    const int t = w / (nt * 2), s = lo + (w % (nt * 2)) * 32 + lane;
    const bool in = s < hi && mrow[t * p.mask_st + s];
    const bool ok = in && slot_ok && !(s >= p0 && s < p0 + K);
    const unsigned bits = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) okw[w] = bits;
  }
  __syncthreads();
  for (int j = tid; j < nt; j += AT_THREADS) {
    unsigned any = 0;
    for (int t = 0; t < K; ++t) any |= okw[(t * nt + j) * 2] | okw[(t * nt + j) * 2 + 1];
    live_s[j] = any != 0;
  }
  __syncthreads();
  auto next_live = [&](int j) {
    while (j < nt && !live_s[j]) ++j;
    return j;
  };
  int j = next_live(0);
  if (j < nt) load_tile(j, 0);

  const int nrw = (rows - warp + AT_WARPS - 1) / AT_WARPS;  // rows this warp owns
  float m_r[RW], l_r[RW], acc[RW][DPL];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    m_r[i] = NEG_INF;
    l_r[i] = 0.f;
#pragma unroll
    for (int k = 0; k < DPL; ++k) acc[i][k] = 0.f;
  }
  // a split with no live tile (and not the active part's) stores (NEG_INF,
  // 0, 0): it reads nothing the QKV launch writes
  const bool idle = j >= nt && z != act;
  pdl_launch_dependents();  // the o-proj launch may start issuing its weight stages
  if (!idle) {

    // the q rows and, in the last split, the new tokens' k and v: the QKV
    // partial sums added in split order, ZQ splits' loads issued before
    // their adds
    constexpr int ZQ = 8;
    const int n_el = (rows + 2 * nk) * D;
    const size_t zstride = (size_t)BK * p.N3;
    for (int idx = tid; idx < n_el; idx += AT_THREADS) {
      const int rr = idx / D, d = idx % D;
      int row, col;
      if (rr < rows) {
        row = b * K + rr % K;
        col = (g * n_rep + rr / K) * D + d;
      } else if (rr < rows + nk) {
        row = b * K + rr - rows;
        col = (p.Hq + g) * D + d;
      } else {
        row = b * K + rr - rows - nk;
        col = (p.Hq + p.Hkv + g) * D + d;
      }
      const float* src = p.qkv_part + (size_t)row * p.N3 + col;
      float sum = 0.f;
      for (int z0 = 0; z0 < p.s_qkv; z0 += ZQ) {
        float v[ZQ];
#pragma unroll
        for (int w = 0; w < ZQ; ++w) v[w] = z0 + w < p.s_qkv ? src[(z0 + w) * zstride] : 0.f;
#pragma unroll
        for (int w = 0; w < ZQ; ++w) sum += v[w];
      }
      Qs[rr * LQ + d] = sum;  // Kn and Vn follow Qs row for row
    }
    __syncthreads();
    // RoPE (half rotation, fp32) of the q rows and the new keys, in place
    for (int idx = tid; idx < (rows + nk) * HALF; idx += AT_THREADS) {
      const int rr = idx / HALF, i = idx % HALF;
      float* x = Qs + rr * LQ;
      const int t = rr < rows ? rr % K : rr - rows;
      const float c = cs[t * HALF + i], s = cs[K * HALF + t * HALF + i];
      const float x1 = x[i], x2 = x[i + HALF];
      x[i] = x1 * c - x2 * s;
      x[i + HALF] = x2 * c + x1 * s;
    }
    __syncthreads();

    if (z == act) {
      // k_new / v_new for the cache scatter, then the active part: lane c
      // scores new token c (c < K) for the warp's rows, causal among the
      // row's K tokens
      T* kn = static_cast<T*>(p.k_new);
      T* vn = static_cast<T*>(p.v_new);
      for (int idx = tid; idx < K * D; idx += AT_THREADS) {
        const int c = idx / D, d = idx % D;
        const size_t o = ((size_t)(b * K + c) * p.Hkv + g) * D + d;
        kn[o] = from_float<T>(Kn[c * LQ + d]);
        vn[o] = from_float<T>(Vn[c * LQ + d]);
      }
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        if (i >= nrw) continue;
        const int r = warp + AT_WARPS * i, t = r % K;
        const int c = min(lane, K - 1);
        float dot = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; d += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(Qs + r * LQ + d);
          const float4 kv = *reinterpret_cast<const float4*>(Kn + c * LQ + d);
          dot = fmaf(qv.x, kv.x, dot);
          dot = fmaf(qv.y, kv.y, dot);
          dot = fmaf(qv.z, kv.z, dot);
          dot = fmaf(qv.w, kv.w, dot);
        }
        const bool ok = lane <= t;  // lane < K: t < K
        const float sc = ok ? dot * p.scale : NEG_INF;
        const float m_new = fmaxf(m_r[i], group_max<32>(sc));
        const float pr = ok ? expf(sc - m_new) : 0.f;
        const float alpha = expf(m_r[i] - m_new);
        l_r[i] = l_r[i] * alpha + group_sum<32>(pr);
        m_r[i] = m_new;
#pragma unroll
        for (int k = 0; k < DPL; ++k) acc[i][k] *= alpha;
        for (int cc = 0; cc <= t; ++cc) {
          const float pc = __shfl_sync(0xffffffffu, pr, cc);
#pragma unroll
          for (int k = 0; k < DPL; ++k) acc[i][k] = fmaf(pc, Vn[cc * LQ + lane * DPL + k], acc[i][k]);
        }
      }
    }

    // the prior cache: the split's live tiles, two stages
    for (int stage = 0; j < nt; stage ^= 1) {
      cp_async_wait<0>();
      __syncthreads();  // tile j landed for every thread; every warp is done with the other stage
      const int jn = next_live(j + 1);
      if (jn < nt) load_tile(jn, stage ^ 1);

      const int s0 = lo + j * AT_TILE, n = min(AT_TILE, hi - s0);
      const T* Ks = KVs + 2 * stage * Tile::KV;
      const T* Vs = Ks + Tile::KV;
      const bool two = n > 32;  // positions lane + 32 in use (warp-uniform)
      float dot[RW][2];
#pragma unroll
      for (int i = 0; i < RW; ++i) dot[i][0] = dot[i][1] = 0.f;
#pragma unroll 2
      for (int e = 0; e < D; e += EV) {
        float k0[EV], k1[EV];
        Vec16<T>::unpack(*reinterpret_cast<const uint4*>(Ks + lane * LD + e), k0);
        Vec16<T>::unpack(*reinterpret_cast<const uint4*>(Ks + (two ? lane + 32 : lane) * LD + e), k1);
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          if (i < nrw) {
            const float* qr = Qs + (warp + AT_WARPS * i) * LQ + e;
#pragma unroll
            for (int u = 0; u < EV; u += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(qr + u);
              const float q4[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
              for (int w = 0; w < 4; ++w) {
                dot[i][0] = fmaf(q4[w], k0[u + w], dot[i][0]);
                dot[i][1] = fmaf(q4[w], k1[u + w], dot[i][1]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        if (i < nrw) {
          const int t = (warp + AT_WARPS * i) % K;
          const bool ok0 = (okw[(t * nt + j) * 2] >> lane) & 1u;
          const bool ok1 = (okw[(t * nt + j) * 2 + 1] >> lane) & 1u;
          const float sa = ok0 ? dot[i][0] * p.scale : NEG_INF;
          const float sb = ok1 ? dot[i][1] * p.scale : NEG_INF;
          const float m_new = fmaxf(m_r[i], group_max<32>(fmaxf(sa, sb)));
          const float pa = ok0 ? expf(sa - m_new) : 0.f;
          const float pb = ok1 ? expf(sb - m_new) : 0.f;
          const float alpha = expf(m_r[i] - m_new);
          l_r[i] = l_r[i] * alpha + group_sum<32>(pa + pb);
          m_r[i] = m_new;
#pragma unroll
          for (int k = 0; k < DPL; ++k) acc[i][k] *= alpha;
          Pw[i * AT_TILE + lane] = pa;
          Pw[i * AT_TILE + lane + 32] = pb;
        }
      }
      __syncwarp();
#pragma unroll 4
      for (int c = 0; c < n; ++c) {
        float vv[DPL];
#pragma unroll
        for (int k = 0; k < DPL; ++k) vv[k] = to_float(Vs[c * LD + lane * DPL + k]);
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          if (i < nrw) {
            const float pr = Pw[i * AT_TILE + c];
#pragma unroll
            for (int k = 0; k < DPL; ++k) acc[i][k] = fmaf(pr, vv[k], acc[i][k]);
          }
        }
      }
      j = jn;
    }
  }  // !idle
  cp_async_wait<0>();

  // the attention rows (row b K + t, head h: attn[(b K + t) Hq D + h D + d]):
  // with one split, acc / max(l, 1e-30) here; else this split's
  // unnormalized state, and the last split block combines
  T* attn = static_cast<T*>(p.attn);
  const long long BKH = (long long)BK * p.Hq;
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    if (i >= nrw) continue;
    const int r = warp + AT_WARPS * i;
    const long long rh = ((long long)b * K + r % K) * p.Hq + g * n_rep + r / K;  // (row, q head)
    if (p.splits == 1) {
#pragma unroll
      for (int k = 0; k < DPL; ++k)
        attn[rh * D + lane * DPL + k] = from_float<T>(slot_ok ? acc[i][k] / fmaxf(l_r[i], 1e-30f) : quiet_nan());
    } else {
      const long long o = (long long)z * BKH + rh;
      if (lane == 0) {
        p.m_part[o] = m_r[i];
        p.l_part[o] = l_r[i];
      }
#pragma unroll
      for (int k = 0; k < DPL; ++k) p.acc_part[o * D + lane * DPL + k] = slot_ok ? acc[i][k] : quiet_nan();
    }
  }
  if (p.splits == 1 || !last_block(p.counter + b * p.Hkv + g, p.splits)) return;

  // the combine: a warp per (row, q head) of the block, lane z loads split
  // z's (m, l); sum_z acc_z e^(m_z - M) / max(sum_z l_z e^(m_z - M), 1e-30)
  // with M the splits' maximum, the sums in split order, eight splits'
  // loads issued before their terms are added
  constexpr int ZB = 8;
  for (int r = warp; r < rows; r += AT_WARPS) {
    const long long rh = ((long long)b * K + r % K) * p.Hq + g * n_rep + r / K;
    const float mz = lane < p.splits ? __ldcg(p.m_part + lane * BKH + rh) : NEG_INF;
    const float lz = lane < p.splits ? __ldcg(p.l_part + lane * BKH + rh) : 0.f;
    float az[ZB][DPL];
    auto load_az = [&](int z0) {
#pragma unroll
      for (int u = 0; u < ZB; ++u)
#pragma unroll
        for (int k = 0; k < DPL; ++k)
          az[u][k] = z0 + u < p.splits ? __ldcg(p.acc_part + ((z0 + u) * BKH + rh) * D + lane * DPL + k) : 0.f;
    };
    load_az(0);  // in flight beside the (m, l) loads
    const float mx = group_max<32>(mz);
    const float w = expf(mz - mx);
    float num[DPL], den = 0.f;
#pragma unroll
    for (int k = 0; k < DPL; ++k) num[k] = 0.f;
    for (int z0 = 0; z0 < p.splits; z0 += ZB) {
      if (z0) load_az(z0);
#pragma unroll
      for (int u = 0; u < ZB; ++u) {
        if (z0 + u < p.splits) {
          const float wz = __shfl_sync(0xffffffffu, w, z0 + u);
          den = fmaf(__shfl_sync(0xffffffffu, lz, z0 + u), wz, den);
#pragma unroll
          for (int k = 0; k < DPL; ++k) num[k] = fmaf(az[u][k], wz, num[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < DPL; ++k) attn[rh * D + lane * DPL + k] = from_float<T>(num[k] / fmaxf(den, 1e-30f));
  }
}

template <typename T, int D, int RW>
cudaError_t attn_launch(const AttnParams& p, cudaStream_t st) {
  const int rows = (p.Hq / p.Hkv) * p.K;
  const size_t smem = AttnTile<T, D>::smem(rows, p.K, RW, p.per);
  return launch_ex(attn_kernel<T, D, RW>, dim3(p.Hkv, p.B, p.splits), dim3(AT_THREADS), smem, st, false, p);
}

template <typename T, int D>
cudaError_t attn_dispatch(const AttnParams& p, cudaStream_t st) {
  const int per_warp = ((p.Hq / p.Hkv) * p.K + AT_WARPS - 1) / AT_WARPS;
  return per_warp <= 2 ? attn_launch<T, D, 2>(p, st) : attn_launch<T, D, AT_MAX_ROWS / AT_WARPS>(p, st);
}

template <typename T>
cudaError_t block_launch(const T* x, const T* gamma, const T* wqkv, const T* wout, AttnParams p, float* o_part,
                         unsigned* o_counter, T* out, int H, int D, int s_o, int kps_qkv, int kps_o, float eps,
                         cudaStream_t st) {
  const int BK = p.B * p.K;
  const int HqD = p.Hq * D;
  const GemvArgs<T> qkv{x, wqkv, nullptr, gamma, eps, H, p.N3, BK, kps_qkv, 0, 0, 0};
  cudaError_t err = gemv_launch<T, 1, PartialSink, GV_NORM>(
      qkv, p.s_qkv, PartialSink{const_cast<float*>(p.qkv_part), BK, p.N3}, st);
  if (err != cudaSuccess) return err;
  err = D == 64 ? attn_dispatch<T, 64>(p, st) : attn_dispatch<T, 128>(p, st);
  if (err != cudaSuccess) return err;
  const GemvArgs<T> o{static_cast<const T*>(p.attn), wout, nullptr, nullptr, 0.f, HqD, H, BK, kps_o, 0, 0, 0};
  return gemv_launch<T, 1, ResidualSink<T>, GV_WAIT>(
      o, s_o, ResidualSink<T>{o_part, x, out, o_counter, BK, H}, st);
}

}  // namespace
}  // namespace nxdi

// x (B, K, H), gamma (H,), wqkv (H, (Hq + 2 Hkv) D), wout (Hq D, H) and
// the caches (L, R, S_max, Hkv, D) in one dtype (0 fp32, 1 bf16),
// contiguous, the caches 16-byte aligned; cos / sin (B, K, D / 2) fp32;
// slot_ids (B,) and positions (B, K) int32; mask bytes at b * mask_sb +
// t * mask_st + s, S_kv <= S_max wide. Scratch: qkv_part (s_qkv, B K, N3),
// m_part / l_part (s_kv, B K, Hq), acc_part (s_kv, B K, Hq D) and o_part
// (s_o, B K, H), fp32; attn (B K, Hq D) in x's dtype; counters: B Hkv for
// the attention launch, then one per 128 o-proj columns, zero on entry and
// left zero. Outputs: out (B, K, H), k_new / v_new (B, K,
// Hkv, D). The QKV product splits H s_qkv ways (kps_qkv each), the prior
// cache splits s_kv ways (per positions each, a multiple of 16), the o-proj
// splits Hq D s_o ways (kps_o each), both a multiple of 64.
// Three launches on the stream, one B8 launch.
extern "C" int nxdi_fused_attn_block(
    const void* x, const void* gamma, const void* wqkv, const void* wout, const void* cos, const void* sin,
    const void* k_cache, const void* v_cache, const void* slot_ids, const void* mask, const void* positions,
    void* qkv_part, void* m_part, void* l_part, void* acc_part, void* attn, void* o_part, void* counters, void* out,
    void* k_new, void* v_new,
    int B, int K, int H, int Hq, int Hkv, int D, int L, int R, int S_max, int S_kv, int layer, int mask_sb,
    int mask_st, int s_qkv, int kps_qkv, int s_kv, int per, int s_o, int kps_o, int dtype,
    float scale, float eps, void* stream) {
  using namespace nxdi;
  if (B < 1 || K < 1 || K > 16 || Hkv < 1 || Hq % Hkv != 0 || (Hq / Hkv) * K > AT_MAX_ROWS ||
      (D != 64 && D != 128) || S_kv < 1 || S_kv > S_max || layer < 0 || layer >= L || s_qkv < 1 ||
      kps_qkv < 1 || s_kv < 1 || s_kv > AT_MAX_SPLITS || per < 16 || per % 16 || (long long)(s_kv - 1) * per >= S_kv ||
      (long long)s_kv * per < S_kv || s_o < 1 || kps_o < 1)
    return (int)cudaErrorInvalidValue;
  unsigned* cnt = static_cast<unsigned*>(counters);
  AttnParams p{static_cast<const float*>(qkv_part), static_cast<const float*>(cos), static_cast<const float*>(sin),
               k_cache, v_cache, static_cast<const int*>(slot_ids), static_cast<const unsigned char*>(mask),
               static_cast<const int*>(positions), static_cast<float*>(m_part), static_cast<float*>(l_part),
               static_cast<float*>(acc_part), cnt, attn, k_new, v_new,
               B, K, Hq, Hkv, (Hq + 2 * Hkv) * D, R, S_max, S_kv, layer, s_qkv, s_kv, per,
               mask_sb, mask_st, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* op = static_cast<float*>(o_part);
  unsigned* o_cnt = cnt + B * Hkv;
  if (dtype == kFloat32)
    return (int)block_launch<float>(static_cast<const float*>(x), static_cast<const float*>(gamma),
                                    static_cast<const float*>(wqkv), static_cast<const float*>(wout), p, op, o_cnt,
                                    static_cast<float*>(out), H, D, s_o, kps_qkv, kps_o, eps, st);
  if (dtype == kBFloat16) {
    using Bf = __nv_bfloat16;
    return (int)block_launch<Bf>(static_cast<const Bf*>(x), static_cast<const Bf*>(gamma),
                                 static_cast<const Bf*>(wqkv), static_cast<const Bf*>(wout), p, op, o_cnt,
                                 static_cast<Bf*>(out), H, D, s_o, kps_qkv, kps_o, eps, st);
  }
  return (int)cudaErrorInvalidValue;
}
