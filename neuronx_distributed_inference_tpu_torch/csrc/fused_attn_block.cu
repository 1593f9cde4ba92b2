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
// once (12.6 MB at Llama-3.2-1B) and each row's live cache once (2 S Hkv D
// values), with a handful of FLOP per byte against the card's ~295
// FLOP/byte ridge: memory bandwidth bounds it.
//
// Design: the Pallas kernel ran one sequential grid per batch row (QKV
// tiles, then RoPE and the active part, then the cache tiles, then o-proj
// tiles) with fp32 scratch carried from step to step. Blocks on Hopper run
// in no order and carry nothing, so this is six launches from one entry
// (one B8 launch):
//   a. the rmsnorm of each row, rounded to the weight dtype, then the QKV
//      product (csrc/decode_gemv.cuh): one block per 32 columns of Wqkv and
//      up to 4 rows, H split over the grid's z axis where the column tiles
//      alone do not fill the card; fp32 partial sums;
//   b. attention: one block per (kv head, batch row, kv split). It adds the
//      QKV partials in split order into shared memory (every split's load
//      issued before the adds), applies RoPE there to its n_rep K query rows
//      (rep-major, as the Pallas kernel's rows) and, in split 0, to the new
//      keys, writes k_new / v_new and runs the active part; then the online
//      softmax over its share of the prior cache's tiles of 64 positions,
//      each tile's K and V read with 16-byte loads all issued before use.
//      The block computes the pruned mask and the tile-skip bits itself from
//      the mask and positions, one pass for up to 32 tiles (in place of the
//      Pallas kernel's scalar prefetch), and skips tiles with no allowed
//      position. The kv axis is
//      split so that about one block runs per SM (8 splits of one tile at
//      Llama-3.2-1B batch 1, bucket 512): the 8 blocks of one split per
//      (row, kv head) would leave the card idle, as B1 does. Each split
//      stores its unnormalized (m, l, acc);
//   c. combine: the splits' (m, l, acc) in split order into the attention
//      rows, rounded to the o-proj weight's dtype;
//   d. o-proj: the GEMV again, fp32 partial sums over a split of Hq D;
//   e. the residual: x + the partial sums in split order, rounded once.
// No atomics: every sum runs in a fixed order, so greedy tokens repeat.
// Tensor-core tiles, TMA staging and one persistent launch are later steps.

#include "decode_gemv.cuh"

namespace nxdi {
namespace {

constexpr int AT_THREADS = 128;
constexpr int AT_WARPS = AT_THREADS / 32;
constexpr int AT_MAX_ROWS = 64;  // n_rep * K query rows a block holds
constexpr int AT_TILE = 64;      // cache positions per tile
constexpr int AT_MAX_SPLITS = 16;

struct AttnParams {
  const float* qkv_part;  // (s_qkv, B K, N3)
  const float* cos;       // (B K, D / 2)
  const float* sin;
  const void* k_cache;  // (L, R, S_max, Hkv, D)
  const void* v_cache;
  const int* slot_ids;         // (B,)
  const unsigned char* mask;   // b * mask_sb + t * mask_st + s
  const int* positions;        // (B, K)
  float* m_part;               // (s_kv, B K, Hq)
  float* l_part;
  float* acc_part;             // (s_kv, B K, Hq D)
  void* k_new;                 // (B, K, Hkv, D)
  void* v_new;
  int B, K, Hq, Hkv, N3, R, S_max, S_kv, layer, s_qkv, tiles_per;
  long long mask_sb, mask_st;
  float scale;
};

template <int D>
__host__ __device__ constexpr size_t attn_smem(int rows) {
  // Q rows and the K tile padded to D + 1 floats (conflict-free column
  // reads), V tile, score / probability tile padded to TILE + 1, per-row
  // (m, l, alpha), per-score mask bytes
  return sizeof(float) * (size_t)(rows * (D + 1) + AT_TILE * (D + 1) + AT_TILE * D + rows * (AT_TILE + 1) + 3 * rows) +
         (size_t)rows * AT_TILE;
}

// The block's attention state: query rows, the current K / V tile, scores
// and the per-row softmax state in shared memory; each thread's share of
// the (row, d) accumulators in registers.
template <int D>
struct Tile {
  static constexpr int LD = D + 1;
  static constexpr int SLD = AT_TILE + 1;
  static constexpr int NACC = AT_MAX_ROWS * D / AT_THREADS;
  float* Qs;
  float* Ks;
  float* Vs;
  float* Ss;
  float* m_s;
  float* l_s;
  float* alpha_s;
  unsigned char* ok_s;
  int rows;

  __device__ Tile(float* smem, int rows_) : rows(rows_) {
    Qs = smem;
    Ks = Qs + rows * LD;
    Vs = Ks + AT_TILE * LD;
    Ss = Vs + AT_TILE * D;
    m_s = Ss + rows * SLD;
    l_s = m_s + rows;
    alpha_s = l_s + rows;
    ok_s = reinterpret_cast<unsigned char*>(alpha_s + rows);
  }

  // One online-softmax step over the tile in Ks / Vs (loaded and
  // synchronized by the caller); allowed(r, c) says whether row r may
  // attend column c. Ends synchronized, so the next tile may be loaded.
  template <class Allowed>
  __device__ void update(float (&acc)[NACC], float scale, Allowed allowed) {
    const int tid = threadIdx.x;
    for (int idx = tid; idx < rows * AT_TILE; idx += AT_THREADS) {
      const int r = idx / AT_TILE, c = idx % AT_TILE;
      const bool ok = allowed(r, c);
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(Qs[r * LD + d], Ks[c * LD + d], dot);
      Ss[r * SLD + c] = ok ? dot * scale : NEG_INF;
      ok_s[r * AT_TILE + c] = ok ? 1 : 0;
    }
    __syncthreads();
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < rows; r += AT_WARPS) {
      float sv[AT_TILE / 32];
      bool okv[AT_TILE / 32];
      float mx = NEG_INF;
#pragma unroll
      for (int i = 0; i < AT_TILE / 32; ++i) {
        const int c = lane + 32 * i;
        sv[i] = Ss[r * SLD + c];
        okv[i] = ok_s[r * AT_TILE + c];
        mx = fmaxf(mx, sv[i]);
      }
      mx = group_max<32>(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < AT_TILE / 32; ++i) {
        const float pr = okv[i] ? expf(sv[i] - m_new) : 0.f;
        Ss[r * SLD + lane + 32 * i] = pr;
        sum += pr;
      }
      sum = group_sum<32>(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int idx = tid + AT_THREADS * i;
      if (idx < rows * D) {
        const int r = idx / D, d = idx % D;
        float a = acc[i] * alpha_s[r];
#pragma unroll 8
        for (int c = 0; c < AT_TILE; ++c) a = fmaf(Ss[r * SLD + c], Vs[c * D + d], a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(AT_THREADS) attn_kernel(const AttnParams p) {
  extern __shared__ float at_smem[];
  constexpr int HALF = D / 2;
  const int tid = threadIdx.x;
  const int g = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int n_rep = p.Hq / p.Hkv;
  const int K = p.K;
  const int rows = n_rep * K;
  const int BK = p.B * K;
  Tile<D> tile(at_smem, rows);

  // this block's q rows and, in split 0, the new tokens' k and v: the QKV
  // product's partial sums added in split order (every split's load issued
  // before the adds) into Qs (row r = hl * K + t is q head g * n_rep + hl at
  // token t, rep-major) and Ks / Vs (row c is token c)
  const int nk = z == 0 ? K : 0;
  for (int idx = tid; idx < (rows + 2 * nk) * D; idx += AT_THREADS) {
    const int rr = idx / D, d = idx % D;
    int row, col;
    float* dst;
    if (rr < rows) {
      row = b * K + rr % K;
      col = (g * n_rep + rr / K) * D + d;
      dst = tile.Qs + rr * Tile<D>::LD + d;
    } else if (rr < rows + nk) {
      row = b * K + rr - rows;
      col = (p.Hq + g) * D + d;
      dst = tile.Ks + (rr - rows) * Tile<D>::LD + d;
    } else {
      row = b * K + rr - rows - nk;
      col = (p.Hq + p.Hkv + g) * D + d;
      dst = tile.Vs + (rr - rows - nk) * D + d;
    }
    float v[GV_MAX_SPLITS];
#pragma unroll
    for (int zz = 0; zz < GV_MAX_SPLITS; ++zz)
      v[zz] = zz < p.s_qkv ? p.qkv_part[((size_t)zz * BK + row) * p.N3 + col] : 0.f;
    float s = 0.f;
#pragma unroll
    for (int zz = 0; zz < GV_MAX_SPLITS; ++zz) s += v[zz];
    *dst = s;
  }
  // the active tile's columns past the K new tokens hold zeros
  for (int idx = tid; z == 0 && idx < (AT_TILE - nk) * D; idx += AT_THREADS) {
    const int c = nk + idx / D, d = idx % D;
    tile.Ks[c * Tile<D>::LD + d] = 0.f;
    tile.Vs[c * D + d] = 0.f;
  }
  for (int r = tid; r < rows; r += AT_THREADS) {
    tile.m_s[r] = NEG_INF;
    tile.l_s[r] = 0.f;
  }
  __syncthreads();
  // RoPE (half rotation, fp32) of the q rows and the new keys, in place
  for (int idx = tid; idx < (rows + nk) * HALF; idx += AT_THREADS) {
    const int rr = idx / HALF, j = idx % HALF;
    const bool is_q = rr < rows;
    float* x = is_q ? tile.Qs + rr * Tile<D>::LD : tile.Ks + (rr - rows) * Tile<D>::LD;
    const int row = b * K + (is_q ? rr % K : rr - rows);
    const float c = p.cos[row * HALF + j], s = p.sin[row * HALF + j];
    const float x1 = x[j], x2 = x[j + HALF];
    x[j] = x1 * c - x2 * s;
    x[j + HALF] = x2 * c + x1 * s;
  }
  __syncthreads();
  float acc[Tile<D>::NACC];
#pragma unroll
  for (int i = 0; i < Tile<D>::NACC; ++i) acc[i] = 0.f;

  const int slot = p.slot_ids[b];
  const bool slot_ok = slot >= 0 && slot < p.R;
  const unsigned char* mrow = p.mask + (long long)b * p.mask_sb;
  const int p0 = p.positions[b * K];

  if (z == 0) {
    // k_new / v_new for the cache scatter, then the active part: the row's
    // K new tokens, causal among themselves
    T* kn = static_cast<T*>(p.k_new);
    T* vn = static_cast<T*>(p.v_new);
    for (int idx = tid; idx < K * D; idx += AT_THREADS) {
      const int c = idx / D, d = idx % D;
      const size_t o = ((size_t)(b * K + c) * p.Hkv + g) * D + d;
      kn[o] = from_float<T>(tile.Ks[c * Tile<D>::LD + d]);
      vn[o] = from_float<T>(tile.Vs[c * D + d]);
    }
    tile.update(acc, p.scale, [&](int r, int c) { return c < K && c <= r % K; });
  }

  // the prior cache: this split's tiles of the row's line, this step's
  // slots taken out of the mask
  auto prior_ok = [&](int t, int s) {
    return s < p.S_kv && mrow[t * p.mask_st + s] && !(s >= p0 && s < p0 + K);
  };
  const T* kc = static_cast<const T*>(p.k_cache);
  const T* vc = static_cast<const T*>(p.v_cache);
  const size_t line = ((size_t)p.layer * p.R + (slot_ok ? slot : 0)) * p.S_max;
  const size_t pos_stride = (size_t)p.Hkv * D;
  constexpr int EV = Vec16<T>::N;
  constexpr int VPR = D / EV;               // 16-byte vectors per position
  constexpr int NV = AT_TILE * VPR;         // per tile and matrix
  constexpr int BATCH = 4;                  // vectors a thread loads before storing
  static_assert(NV % (AT_THREADS * BATCH) == 0, "tile vectors must divide over the block");
  const int n_tiles = (p.S_kv + AT_TILE - 1) / AT_TILE;
  const int j1 = min(n_tiles, (z + 1) * p.tiles_per);
  __shared__ unsigned warp_bits[AT_WARPS];
  const int warp = tid / 32, lane = tid % 32;
  // the split's tiles in groups of 32: one pass over the group's mask bytes
  // marks the tiles that hold an allowed position, so a tile costs one
  // round trip to memory (its K and V) and the others are skipped
  for (int g0 = z * p.tiles_per; g0 < j1; g0 += 32) {
    const int span = min(32, j1 - g0) * AT_TILE;
    unsigned bits = 0;
    for (int idx = tid; idx < K * span; idx += AT_THREADS) {
      const int s = g0 * AT_TILE + idx % span;
      if (prior_ok(idx / span, s)) bits |= 1u << (s / AT_TILE - g0);
    }
    bits = __reduce_or_sync(0xffffffffu, bits);
    if (lane == 0) warp_bits[warp] = bits;
    __syncthreads();
    bits = 0;
#pragma unroll
    for (int w = 0; w < AT_WARPS; ++w) bits |= warp_bits[w];
    for (int jt = g0; jt < g0 + span / AT_TILE; ++jt) {
      if (!((bits >> (jt - g0)) & 1u)) continue;  // uniform over the block
      const int s0 = jt * AT_TILE;
      for (int base = 0; base < NV; base += AT_THREADS * BATCH) {
        uint4 rk[BATCH], rv[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          const int vi = base + u * AT_THREADS + tid;
          const int c = vi / VPR, e = (vi % VPR) * EV;
          const bool in = slot_ok && s0 + c < p.S_kv;
          const size_t off = (line + s0 + c) * pos_stride + (size_t)g * D + e;
          rk[u] = in ? __ldg(reinterpret_cast<const uint4*>(kc + off)) : make_uint4(0, 0, 0, 0);
          rv[u] = in ? __ldg(reinterpret_cast<const uint4*>(vc + off)) : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          const int vi = base + u * AT_THREADS + tid;
          const int c = vi / VPR, e = (vi % VPR) * EV;
          float kf[EV], vf[EV];
          Vec16<T>::unpack(rk[u], kf);
          Vec16<T>::unpack(rv[u], vf);
#pragma unroll
          for (int i = 0; i < EV; ++i) {
            tile.Ks[c * Tile<D>::LD + e + i] = kf[i];
            tile.Vs[c * D + e + i] = vf[i];
          }
        }
      }
      __syncthreads();
      tile.update(acc, p.scale, [&](int r, int c) { return prior_ok(r % K, s0 + c); });
    }
    __syncthreads();  // every thread has read warp_bits before the next group writes it
  }

  // this split's unnormalized state
  for (int r = tid; r < rows; r += AT_THREADS) {
    const int h = g * n_rep + r / K, row = b * K + r % K;
    const size_t o = ((size_t)z * BK + row) * p.Hq + h;
    p.m_part[o] = tile.m_s[r];
    p.l_part[o] = tile.l_s[r];
  }
#pragma unroll
  for (int i = 0; i < Tile<D>::NACC; ++i) {
    const int idx = tid + AT_THREADS * i;
    if (idx >= rows * D) continue;
    const int r = idx / D, d = idx % D;
    const int h = g * n_rep + r / K, row = b * K + r % K;
    p.acc_part[(((size_t)z * BK + row) * p.Hq + h) * D + d] = slot_ok ? acc[i] : quiet_nan();
  }
}

// The attention rows: each (row, q head)'s kv splits combined in split
// order, sum_z acc_z e^(m_z - m) / max(sum_z l_z e^(m_z - m), 1e-30) with m
// the splits' maximum (acc / max(l, 1e-30) for one split), rounded to the
// o-proj weight's dtype. One thread per (row, head, d); every split's load
// is issued before the sums.
template <typename T>
__global__ void combine_kernel(const float* __restrict__ m_part, const float* __restrict__ l_part,
                               const float* __restrict__ acc_part, T* __restrict__ attn, int splits, int BK, int Hq,
                               int D) {
  const int HqD = Hq * D;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= BK * HqD) return;
  const int row = i / HqD, h = (i % HqD) / D;
  float mz[AT_MAX_SPLITS], lz[AT_MAX_SPLITS], az[AT_MAX_SPLITS];
#pragma unroll
  for (int z = 0; z < AT_MAX_SPLITS; ++z) {
    const size_t o = ((size_t)z * BK + row) * Hq + h;
    mz[z] = z < splits ? m_part[o] : NEG_INF;
    lz[z] = z < splits ? l_part[o] : 0.f;
    az[z] = z < splits ? acc_part[(size_t)z * BK * HqD + i] : 0.f;
  }
  float mx = NEG_INF;
#pragma unroll
  for (int z = 0; z < AT_MAX_SPLITS; ++z) mx = fmaxf(mx, mz[z]);
  float num = 0.f, den = 0.f;
#pragma unroll
  for (int z = 0; z < AT_MAX_SPLITS; ++z) {
    if (z < splits) {
      const float wz = expf(mz[z] - mx);
      num = fmaf(az[z], wz, num);
      den = fmaf(lz[z], wz, den);
    }
  }
  attn[i] = from_float<T>(num / fmaxf(den, 1e-30f));
}

template <typename T, int D>
cudaError_t attn_launch(const AttnParams& p, int s_kv, cudaStream_t st) {
  const int rows = (p.Hq / p.Hkv) * p.K;
  cudaError_t err = cudaFuncSetAttribute(attn_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)attn_smem<D>(AT_MAX_ROWS));
  if (err != cudaSuccess) return err;
  attn_kernel<T, D><<<dim3(p.Hkv, p.B, s_kv), AT_THREADS, attn_smem<D>(rows), st>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t block_launch(const T* x, const T* gamma, const T* wqkv, const T* wout, AttnParams p, T* normed, T* attn,
                         float* o_part, T* out, int H, int D, int s_kv, int s_o, int kps_qkv, int kps_o, int vec,
                         float eps, cudaStream_t st) {
  const int BK = p.B * p.K;
  const int HqD = p.Hq * D;
  cudaError_t err = rmsnorm_rows<T>(x, gamma, normed, BK, H, eps, st);
  if (err != cudaSuccess) return err;
  err = gemv_launch<T, 1>(normed, wqkv, (const T*)nullptr, H, p.N3, BK, p.s_qkv, kps_qkv, vec,
                          PartialSink{const_cast<float*>(p.qkv_part), BK, p.N3}, st);
  if (err != cudaSuccess) return err;
  err = D == 64 ? attn_launch<T, 64>(p, s_kv, st) : attn_launch<T, 128>(p, s_kv, st);
  if (err != cudaSuccess) return err;
  combine_kernel<T><<<(BK * HqD + 255) / 256, 256, 0, st>>>(p.m_part, p.l_part, p.acc_part, attn, s_kv, BK, p.Hq, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = gemv_launch<T, 1>(attn, wout, (const T*)nullptr, HqD, H, BK, s_o, kps_o, vec, PartialSink{o_part, BK, H}, st);
  if (err != cudaSuccess) return err;
  return residual_sum<T>(x, o_part, out, s_o, BK * H, st);
}

}  // namespace
}  // namespace nxdi

// x (B, K, H), gamma (H,), wqkv (H, (Hq + 2 Hkv) D), wout (Hq D, H) and
// the caches (L, R, S_max, Hkv, D) in one dtype (0 fp32, 1 bf16),
// contiguous, the caches 16-byte aligned; cos / sin (B, K, D / 2) fp32;
// slot_ids (B,) and positions (B, K) int32; mask bytes at b * mask_sb +
// t * mask_st + s, S_kv <= S_max wide. Scratch: qkv_part (s_qkv, B K, N3),
// m_part / l_part (s_kv, B K, Hq), acc_part (s_kv, B K, Hq D) and o_part
// (s_o, B K, H), fp32, and normed (B K, H) and attn (B K, Hq D) in x's
// dtype. Outputs: out
// (B, K, H), k_new / v_new (B, K, Hkv, D). The QKV product splits H s_qkv
// ways (kps_qkv each), the prior cache's tiles split s_kv ways (tiles_per
// each), the o-proj splits Hq D s_o ways (kps_o each). vec = 1 allows
// 16-byte weight loads. Six launches on the stream, one B8 launch.
extern "C" int nxdi_fused_attn_block(
    const void* x, const void* gamma, const void* wqkv, const void* wout, const void* cos, const void* sin,
    const void* k_cache, const void* v_cache, const void* slot_ids, const void* mask, const void* positions,
    void* normed, void* qkv_part, void* m_part, void* l_part, void* acc_part, void* attn, void* o_part, void* out,
    void* k_new, void* v_new,
    int B, int K, int H, int Hq, int Hkv, int D, int L, int R, int S_max, int S_kv, int layer, int mask_sb,
    int mask_st, int s_qkv, int kps_qkv, int s_kv, int tiles_per, int s_o, int kps_o, int dtype, int vec,
    float scale, float eps, void* stream) {
  using namespace nxdi;
  if (B < 1 || K < 1 || K > 16 || Hkv < 1 || Hq % Hkv != 0 || (Hq / Hkv) * K > AT_MAX_ROWS ||
      (D != 64 && D != 128) || S_kv < 1 || S_kv > S_max || layer < 0 || layer >= L || s_qkv < 1 ||
      kps_qkv < 1 || s_kv < 1 || s_kv > AT_MAX_SPLITS || tiles_per < 1 || s_o < 1 || kps_o < 1)
    return (int)cudaErrorInvalidValue;
  AttnParams p{static_cast<const float*>(qkv_part), static_cast<const float*>(cos), static_cast<const float*>(sin),
               k_cache, v_cache, static_cast<const int*>(slot_ids), static_cast<const unsigned char*>(mask),
               static_cast<const int*>(positions), static_cast<float*>(m_part), static_cast<float*>(l_part),
               static_cast<float*>(acc_part), k_new, v_new,
               B, K, Hq, Hkv, (Hq + 2 * Hkv) * D, R, S_max, S_kv, layer, s_qkv, tiles_per,
               mask_sb, mask_st, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* op = static_cast<float*>(o_part);
  if (dtype == kFloat32)
    return (int)block_launch<float>(static_cast<const float*>(x), static_cast<const float*>(gamma),
                                    static_cast<const float*>(wqkv), static_cast<const float*>(wout), p,
                                    static_cast<float*>(normed), static_cast<float*>(attn), op,
                                    static_cast<float*>(out), H, D, s_kv, s_o, kps_qkv, kps_o, vec, eps, st);
  if (dtype == kBFloat16) {
    using Bf = __nv_bfloat16;
    return (int)block_launch<Bf>(static_cast<const Bf*>(x), static_cast<const Bf*>(gamma),
                                 static_cast<const Bf*>(wqkv), static_cast<const Bf*>(wout), p,
                                 static_cast<Bf*>(normed), static_cast<Bf*>(attn), op,
                                 static_cast<Bf*>(out), H, D, s_kv, s_o, kps_qkv, kps_o, vec, eps, st);
  }
  return (int)cudaErrorInvalidValue;
}
