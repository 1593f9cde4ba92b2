// Decode (token-generation) attention for Hopper (sm_90a), over the
// contiguous KV cache (kernel B1 of the port) and over the paged block
// cache (kernel B4).
//
// Replaces the TPU kernels neuronx_distributed_inference_tpu/ops/
// decode_attention.py::tkg_decode_attention (B1) and
// ::paged_tkg_decode_attention (B4) (both _common_call -> _tkg_kernel,
// _body, _finalize) for bf16/fp32 caches and, in code mode, for int8/fp8
// (e4m3, e5m2) QuantizedKV caches.
//
// What both compute: for batch row b and kv head g, the n_rep * K query
// rows of that group (row hl * K + t is local q head hl = h - g * n_rep at
// token t, the reference's rep-major _prep_q order, so GQA needs no
// repeat_kv; K <= 16) attend the row's cache over positions [0, S_kv) under the
// (B, 1, K, S_kv) boolean decode mask, with an online softmax over kv
// tiles. Tiles whose mask is all false for the batch row are skipped.
// Without a sink, out = acc / max(l, 1e-30); with one, the sink logit joins
// the denominator after both are renormalized to max(m, sink). A row with
// no valid key comes out as exact zeros.
//
// What bounds it on an H100: decode reads each layer's live cache once
// (2 * S_kv * Hkv * D * bytes) for ~4 * n_rep * K * S_kv * Hkv * D FLOP, an
// arithmetic intensity of about n_rep * K FLOP per byte, far below the
// card's ~295 FLOP/byte ridge: memory bandwidth bounds it. At batch 1 the
// live cache is well under a MB a layer (0.2 us at 3.35 TB/s), so what a
// call costs in practice is its chain of dependent round trips to memory.
//
// B1, contiguous (split_kernel + split_combine_kernel; flash-decoding):
//   - Grid (kv head x row chunk, batch row, split): a block holds at most
//     MAX_ROWS = 64 of the group's rows, so a group of more (n_rep 8 at
//     K > 8: GPT-OSS's and Qwen3's 9-16-query passes) is split into
//     row chunks of 64 that read the same tiles. Split z takes positions
//     [z * per, (z + 1) * per), per a multiple of 16. The wrapper picks the
//     split from the shapes alone (ops/decode_attention.py::
//     decode_kv_split): at least one block per SM, one 64-position tile a
//     split where at most MAX_SPLITS allow it (32 splits of 16 positions at
//     Llama-3.2-1B's 8 kv heads, batch 1, bucket 512; 8 of 64 at batch 8),
//     one split once the (row, kv head) pairs fill the card. One block per
//     (row, kv head) alone would be 8 blocks at 1B, 4 at Qwen3, on 132 SMs.
//   - A block issues its q rows' 16-byte copies, reads its split's mask
//     bytes once (which 64-position tiles hold an allowed position), and
//     loads nothing more when none does. Live tiles arrive by 16-byte
//     cp.async into two shared-memory stages, the next tile in flight while
//     this one is computed; one barrier a tile.
//   - Warp w owns query rows w, w + 4, ...: their scores (lane c at
//     positions c and c + 32), online softmax (warp shuffles) and fp32
//     accumulators (lane c at dims c D/32 ...) live in its registers; the
//     probabilities go through a per-warp shared row. Products are fp32
//     FMAs: at n_rep * K FLOP a byte the tensor cores would buy nothing.
//   - Each split writes its fp32 (m, l, acc) per (row, q head) to scratch
//     the wrapper allocates; a second launch from the same entry combines
//     the splits in split order (M = max m_z, weights e^(m_z - M)) and
//     applies the sink once, after the combine. A split with no live tile
//     writes (NEG_INF, 0, 0), so a row with no valid key combines to exact
//     zeros, with or without a sink. One split finalizes in place.
//   - The cache is read straight out of the full stacked cache (no bucket
//     slice, no repeat_kv); no atomics, so results repeat bit for bit.
// B4, paged (the same split_kernel + split_combine_kernel, PAGED = true):
//   - The kernel reads block_table[b, s / bs] itself (the TPU kernel had it
//     as scalar prefetch): a block stages its split's entries in shared
//     memory while it reads the mask, so no tile load waits on a table
//     read. Each 16-byte chunk of a staged 64-position tile is fetched from
//     the head-major (L, NB+1, Hkv, bs, D) cache: position s of head g is
//     ((layer * (NB+1) + blk) * Hkv + g) * bs * D + (s % bs) * D. A tile
//     spans 2 blocks (bs 32) or 4 (bs 16), and a split of 16 positions may
//     start a tile in the middle of a block.
//   - Block 0 is the garbage block, where invalid writes land and where the
//     fault tests write NaN: its chunks (and those of any id outside
//     [1, NB]) are cp.async's zero fill, nothing read, the reference's read
//     scrub (block_kvcache.py::read_block_cache_at_layer). A masked
//     probability is exactly 0, but 0 * NaN is NaN, and a live tile may
//     hold a block-0 chunk beside valid positions (a zero-table tail inside
//     the tile, an inactive row's position 0), so a NaN must never reach
//     shared memory: the zero fill rules that out.
//   - The split is B1's rule over the table's MB * bs positions
//     (decode_kv_split(MB * bs, B * Hkv, sms)): at the serving row's decode
//     step (8 rows, width 1024, 8 kv heads) 16 splits of one 64-position
//     tile, 1024 blocks, of which those past a row's length read only
//     their mask bytes and write (NEG_INF, 0, 0).
//
// Code mode (a cache type C of 1-byte codes beside the q and output type T):
//   - The kernel reads the layer's (Hkv,) running scales itself and takes
//     each head's dequant factors scale / qmax: K's multiplies the score
//     scale (the reference's _fold_k_dequant folds it into q; a per-head
//     constant, so the same product up to fp32 rounding), V's the finalized
//     output before its one rounding to T (_apply_v_dequant). So a call is
//     one launch (and the combine), with no fold or rescale pass around it,
//     and the scales are read on the device at launch (a captured graph
//     sees each step's).
//   - K and V tiles are staged as codes (kv_tile.cuh, which B3's decode
//     tiles share): one position's D bytes a row padded by 16 bytes, 16
//     codes a 16-byte chunk, so B4 still fetches each chunk through its
//     block's entry and zero-fills block 0's; the codes become fp32 in
//     registers. No dequantized cache is written anywhere, and a decode
//     step reads half the bf16 bytes.
//
// Layout: q (B, K, Hq, D) contiguous; caches contiguous (B1: (L, R, S_max,
// Hkv, D), 16-byte aligned); block_table (B, MB) int32 contiguous (paged);
// mask bytes addressed as b * mask_sb + t * mask_st + s; sink (Hq,) fp32 or
// null; out (B, K, Hq, D) contiguous.

#include "kv_tile.cuh"

namespace nxdi {
namespace {

constexpr int MAX_ROWS = 64;  // query rows a block holds (a row chunk)
constexpr int MAX_Q = 16;     // K: queries a batch row

// ---------------------------------------------------------------------------
// B1 and B4: the kv axis split over blocks
// ---------------------------------------------------------------------------

constexpr int SP_THREADS = 128;
constexpr int SP_WARPS = SP_THREADS / 32;
constexpr int SP_TILE = kv::TILE;  // positions per staged tile
constexpr int MAX_SPLITS = 32;  // kv splits per (batch row, kv head)

struct SplitParams {
  const void* q;
  const void* k_cache;
  const void* v_cache;
  const unsigned char* mask;
  const float* sink;
  void* out;
  float* m_part;    // (splits, B K, Hq)
  float* l_part;
  float* acc_part;  // (splits, B K, Hq, D)
  const int* block_table;  // B4: (B, MB)
  int B, K, Hq, Hkv, S_kv, layer, splits, per;
  int R, S_max;        // B1: cache lines, positions per line
  int NB1, MB, bs_lg;  // B4: blocks (garbage block included), table width, log2 block size
  long long mask_sb, mask_st;
  float scale;
  // code mode: the caches' (L, Hkv) fp32 running scales and the code type's
  // qmax (null for a plain cache)
  const float* k_scale;
  const float* v_scale;
  float qmax;
};

// blocks a kv head's n_rep * K query rows take, MAX_ROWS rows each
__host__ __device__ __forceinline__ int row_chunks(const SplitParams& p) {
  return ((p.Hq / p.Hkv) * p.K + MAX_ROWS - 1) / MAX_ROWS;
}

// the layer's dequant factor scale / qmax of kv head g (1 for a plain cache)
__device__ __forceinline__ float dequant_factor(const float* scale, const SplitParams& p, int g) {
  return nxdi::dequant_factor(scale, p.layer * p.Hkv + g, p.qmax);
}

// T: q and out; C: the cache (T, or 1-byte codes)
template <typename T, typename C, int D>
struct SplitTile {
  static constexpr int KV = kv::Row<C, D>::KV;  // one K or V tile of padded rows
  // q rows, two stages of (K, V), a probability row per (warp, row), the
  // live-tile bits per (32 tiles, warp), B4's table entries of the split
  static __host__ __device__ int groups(int per) { return ((per + SP_TILE - 1) / SP_TILE + 31) / 32; }
  static int table_entries(int per) { return per / 16 + 2; }  // blocks of >= 16 positions
  static size_t smem(int rows, int rw, int per, bool paged) {
    return sizeof(T) * (size_t)rows * D + sizeof(C) * 4 * (size_t)KV + sizeof(float) * SP_WARPS * rw * SP_TILE +
           sizeof(unsigned) * SP_WARPS * groups(per) + (paged ? sizeof(int) * table_entries(per) : 0);
  }
};

// the reference's _finalize for one output value
__device__ __forceinline__ float finalize(float acc, float m, float l, const float* sink, int h) {
  if (sink != nullptr) {
    // renormalize to m2 = max(m, sink) so rows that saw no valid key stay
    // finite (and zero)
    const float sk = sink[h];
    const float m2 = fmaxf(m, sk);
    const float alpha = expf(m - m2);
    const float denom = l * alpha + expf(sk - m2);
    return acc * alpha / denom;
  }
  return acc / fmaxf(l, 1e-30f);
}

// RW: the most query rows one warp owns (rows w, w + 4, ... of the group);
// PAGED: B4's address mode (the block table), else B1's (the cache line);
// C: the cache's element type (T, or 1-byte codes in code mode)
template <typename T, typename C, int D, int RW, bool PAGED>
__global__ void __launch_bounds__(SP_THREADS) split_kernel(const SplitParams p) {
  using Tile = SplitTile<T, C, D>;
  constexpr int EQ = Vec16<T>::N;  // q elements per 16 bytes
  constexpr int QPR = D / EQ;      // 16-byte vectors per q row
  constexpr int DPL = D / 32;      // output dims per lane
  extern __shared__ __align__(16) unsigned char sp_smem[];
  const int n_rep = p.Hq / p.Hkv;
  const int K = p.K;
  // this block's row chunk: rows [r0, r0 + rows) of kv head g's group
  const int chunks = row_chunks(p);
  const int g = blockIdx.x / chunks, r0 = (blockIdx.x % chunks) * MAX_ROWS;
  const int rows = min(MAX_ROWS, n_rep * K - r0);
  T* Qs = reinterpret_cast<T*>(sp_smem);
  C* KVs = reinterpret_cast<C*>(Qs + rows * D);  // stage s: K at KVs + 2 s KV, V right after
  float* Pw = reinterpret_cast<float*>(KVs + 4 * Tile::KV) + (threadIdx.x / 32) * RW * SP_TILE;
  unsigned* bits_s = reinterpret_cast<unsigned*>(reinterpret_cast<float*>(KVs + 4 * Tile::KV) +
                                                 SP_WARPS * RW * SP_TILE);
  int* table_s = reinterpret_cast<int*>(bits_s + SP_WARPS * Tile::groups(p.per));

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y, z = blockIdx.z;
  const int lo = z * p.per, hi = min(lo + p.per, p.S_kv);
  const float score_scale = p.scale * dequant_factor(p.k_scale, p, g);
  const int nt = (hi - lo + SP_TILE - 1) / SP_TILE;
  const unsigned char* mrow = p.mask + (long long)b * p.mask_sb;

  // the group's q rows, in flight while the mask is read
  const T* q = static_cast<const T*>(p.q);
  for (int i = tid; i < rows * QPR; i += SP_THREADS) {
    const int r = i / QPR, e = (i % QPR) * EQ;
    const int hl = (r0 + r) / K, t = (r0 + r) % K;
    cp_async16(Qs + r * D + e, q + (((long long)b * K + t) * p.Hq + g * n_rep + hl) * D + e, true);
  }
  cp_async_commit();

  // B4: the split's table entries, block ids outside [1, NB] as 0 (zero
  // fill), read beside the mask
  const int blk0 = lo >> p.bs_lg;
  if (PAGED) {
    const int* row = p.block_table + (long long)b * p.MB;
    for (int i = tid; i <= ((hi - 1) >> p.bs_lg) - blk0; i += SP_THREADS) {
      const int blk = row[blk0 + i];
      table_s[i] = blk > 0 && blk < p.NB1 ? blk : 0;
    }
  }

  // which of the split's tiles hold an allowed position: one pass over its
  // mask bytes, 32 tiles a word, a word per warp
  for (int w0 = 0; w0 * 32 < nt; ++w0) {
    const int s_lo = lo + w0 * 32 * SP_TILE;
    const int span = min(hi, s_lo + 32 * SP_TILE) - s_lo;
    unsigned bits = 0;
    for (int idx = tid; idx < K * span; idx += SP_THREADS) {
      const int t = idx / span, s = idx % span;
      if (mrow[t * p.mask_st + s_lo + s]) bits |= 1u << (s / SP_TILE);
    }
    bits = __reduce_or_sync(0xffffffffu, bits);
    if (lane == 0) bits_s[w0 * SP_WARPS + warp] = bits;
  }
  __syncthreads();
  auto next_live = [&](int j) {
    for (; j < nt; ++j) {
      const unsigned* w = bits_s + (j / 32) * SP_WARPS;
      if (((w[0] | w[1] | w[2] | w[3]) >> (j % 32)) & 1u) break;
    }
    return j;
  };

  const C* kc = static_cast<const C*>(p.k_cache);
  const C* vc = static_cast<const C*>(p.v_cache);
  const long long line = PAGED ? 0 : ((long long)p.layer * p.R + b) * p.S_max;
  const long long pos_stride = (long long)p.Hkv * D;
  const int bs_mask = (1 << p.bs_lg) - 1;
  auto load_tile = [&](int j, int stage) {
    const int s0 = lo + j * SP_TILE;
    C* Ks = KVs + 2 * stage * Tile::KV;
    kv::stage_tile<C, D>(Ks, Ks + Tile::KV, kc, vc, min(SP_TILE, hi - s0), [&](int c, int e) -> long long {
      if (!PAGED) return (line + s0 + c) * pos_stride + (long long)g * D + e;
      // position s of head g in block blk; block 0 reads nothing
      const int s = s0 + c;
      const int blk = table_s[(s >> p.bs_lg) - blk0];
      return blk != 0 ? ((((long long)p.layer * p.NB1 + blk) * p.Hkv + g) << p.bs_lg) * D + (s & bs_mask) * D + e
                      : -1;
    }, tid, SP_THREADS);
  };

  const int nrw = (rows - warp + SP_WARPS - 1) / SP_WARPS;  // rows this warp owns
  float m_r[RW], l_r[RW], acc[RW][DPL];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    m_r[i] = NEG_INF;
    l_r[i] = 0.f;
#pragma unroll
    for (int k = 0; k < DPL; ++k) acc[i][k] = 0.f;
  }

  int j = next_live(0);
  if (j < nt) load_tile(j, 0);
  for (int stage = 0; j < nt; stage ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // tile j landed for every thread; every warp is done with the other stage
    const int jn = next_live(j + 1);
    if (jn < nt) load_tile(jn, stage ^ 1);

    const int s0 = lo + j * SP_TILE;
    const C* Ks = KVs + 2 * stage * Tile::KV;
    kv::tile_rows<T, C, D, RW, SP_WARPS>(
        Qs, Ks, Ks + Tile::KV, min(SP_TILE, hi - s0), nrw, score_scale,
        [&](int i, int c) { return mrow[((r0 + warp + SP_WARPS * i) % K) * p.mask_st + s0 + c] != 0; }, Pw, m_r, l_r, acc);
    j = jn;
  }
  cp_async_wait<0>();  // (no live tile: the q copies)

  T* out = static_cast<T*>(p.out);
  const long long BKH = (long long)p.B * K * p.Hq;
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    if (i >= nrw) continue;
    const int r = r0 + warp + SP_WARPS * i;
    const int h = g * n_rep + r / K;
    const long long rh = ((long long)b * K + r % K) * p.Hq + h;  // (row, q head)
    if (p.splits == 1) {
      const float vf = dequant_factor(p.v_scale, p, g);
#pragma unroll
      for (int k = 0; k < DPL; ++k)
        out[rh * D + lane * DPL + k] = from_float<T>(finalize(acc[i][k], m_r[i], l_r[i], p.sink, h) * vf);
    } else {
      const long long o = (long long)z * BKH + rh;
      if (lane == 0) {
        p.m_part[o] = m_r[i];
        p.l_part[o] = l_r[i];
      }
#pragma unroll
      for (int k = 0; k < DPL; ++k) p.acc_part[o * D + lane * DPL + k] = acc[i][k];
    }
  }
}

// One warp per (row, q head), lane c over dims c D/32 ...: the splits'
// (m, l, acc) combined in split order, sum_z acc_z e^(m_z - M) and
// sum_z l_z e^(m_z - M) with M the splits' maximum, then the reference's
// _finalize once. Lane z loads split z's (m, l) and takes its weight; every
// split's load is issued before the sums.
template <typename T, int D>
__global__ void split_combine_kernel(const SplitParams p) {
  constexpr int DPL = D / 32;
  const long long BKH = (long long)p.B * p.K * p.Hq;
  const long long rh = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (rh >= BKH) return;
  const float mz = lane < p.splits ? p.m_part[lane * BKH + rh] : NEG_INF;
  const float lz = lane < p.splits ? p.l_part[lane * BKH + rh] : 0.f;
  float az[MAX_SPLITS][DPL];
#pragma unroll
  for (int z = 0; z < MAX_SPLITS; ++z)
#pragma unroll
    for (int k = 0; k < DPL; ++k) az[z][k] = z < p.splits ? p.acc_part[(z * BKH + rh) * D + lane * DPL + k] : 0.f;
  const float mx = group_max<32>(mz);
  const float w = expf(mz - mx);
  float num[DPL] = {}, den = 0.f;
#pragma unroll
  for (int z = 0; z < MAX_SPLITS; ++z) {
    if (z < p.splits) {
      const float wz = __shfl_sync(0xffffffffu, w, z);
      den = fmaf(__shfl_sync(0xffffffffu, lz, z), wz, den);
#pragma unroll
      for (int k = 0; k < DPL; ++k) num[k] = fmaf(az[z][k], wz, num[k]);
    }
  }
  T* out = static_cast<T*>(p.out) + rh * D + lane * DPL;
  const int h = (int)(rh % p.Hq);
  const float vf = dequant_factor(p.v_scale, p, h / (p.Hq / p.Hkv));
#pragma unroll
  for (int k = 0; k < DPL; ++k) out[k] = from_float<T>(finalize(num[k], mx, den, p.sink, h) * vf);
}

template <typename T, typename C, int D, int RW, bool PAGED>
cudaError_t split_launch(const SplitParams& p, cudaStream_t st) {
  const int rows = min(MAX_ROWS, (p.Hq / p.Hkv) * p.K);  // a block's
  const size_t smem = SplitTile<T, C, D>::smem(rows, RW, p.per, PAGED);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(split_kernel<T, C, D, RW, PAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  split_kernel<T, C, D, RW, PAGED><<<dim3(p.Hkv * row_chunks(p), p.B, p.splits), SP_THREADS, smem, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  constexpr int PAIRS = 2;  // (row, q head) pairs per combine block, a warp each
  split_combine_kernel<T, D><<<(unsigned)((p.B * p.K * p.Hq + PAIRS - 1) / PAIRS), PAIRS * 32, 0, st>>>(p);
  return cudaGetLastError();
}

template <typename T, typename C, int D, bool PAGED>
cudaError_t split_dispatch(const SplitParams& p, cudaStream_t st) {
  const int per_warp = (min(MAX_ROWS, (p.Hq / p.Hkv) * p.K) + SP_WARPS - 1) / SP_WARPS;
  return per_warp <= 2 ? split_launch<T, C, D, 2, PAGED>(p, st)
                       : split_launch<T, C, D, MAX_ROWS / SP_WARPS, PAGED>(p, st);
}

template <typename C, bool PAGED>
cudaError_t code_dispatch(const SplitParams& p, int D, int dtype, cudaStream_t st) {
  if (!p.k_scale || !p.v_scale || !(p.qmax > 0.f)) return cudaErrorInvalidValue;
  if (dtype == kFloat32 && D == 64) return split_dispatch<float, C, 64, PAGED>(p, st);
  if (dtype == kFloat32 && D == 128) return split_dispatch<float, C, 128, PAGED>(p, st);
  if (dtype == kBFloat16 && D == 64) return split_dispatch<__nv_bfloat16, C, 64, PAGED>(p, st);
  if (dtype == kBFloat16 && D == 128) return split_dispatch<__nv_bfloat16, C, 128, PAGED>(p, st);
  return cudaErrorInvalidValue;
}

// dtype: q's and out's; cache_dtype: the caches' (equal, or 1-byte codes
// with their scales: the code mode)
template <bool PAGED>
cudaError_t split_entry(const SplitParams& p, int D, int dtype, int cache_dtype, cudaStream_t st) {
  if (p.splits < 1 || p.splits > MAX_SPLITS || p.per <= 0 || p.per % 16 || (long long)(p.splits - 1) * p.per >= p.S_kv ||
      (long long)p.splits * p.per < p.S_kv || (p.splits > 1 && (!p.m_part || !p.l_part || !p.acc_part)))
    return cudaErrorInvalidValue;
  if (cache_dtype == dtype) {
    if (dtype == kFloat32 && D == 64) return split_dispatch<float, float, 64, PAGED>(p, st);
    if (dtype == kFloat32 && D == 128) return split_dispatch<float, float, 128, PAGED>(p, st);
    if (dtype == kBFloat16 && D == 64) return split_dispatch<__nv_bfloat16, __nv_bfloat16, 64, PAGED>(p, st);
    if (dtype == kBFloat16 && D == 128) return split_dispatch<__nv_bfloat16, __nv_bfloat16, 128, PAGED>(p, st);
    return cudaErrorInvalidValue;
  }
  if (cache_dtype == kInt8) return code_dispatch<int8_t, PAGED>(p, D, dtype, st);
  if (cache_dtype == kFp8E4M3) return code_dispatch<Fp8E4M3, PAGED>(p, D, dtype, st);
  if (cache_dtype == kFp8E5M2) return code_dispatch<Fp8E5M2, PAGED>(p, D, dtype, st);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace nxdi

// splits, per: the wrapper's kv split (ops/decode_attention.py::
// decode_kv_split); m_part / l_part / acc_part: fp32 scratch of
// splits * B * K * Hq (* D) values, unused (may be null) for one split;
// cache_dtype: dtype, or an int8/fp8 code type, whose (L, Hkv) fp32
// running scales k_scale / v_scale and qmax come with it (null and 0 for a
// plain cache).
extern "C" int nxdi_tkg_decode_attention(
    const void* q, const void* k_cache, const void* v_cache, const void* mask,
    const float* sink, void* out, float* m_part, float* l_part, float* acc_part,
    int B, int K, int Hq, int Hkv, int D, int L, int R, int S_max, int S_kv, int layer,
    int mask_sb, int mask_st, int splits, int per,
    float scale, int dtype, int cache_dtype, const float* k_scale, const float* v_scale, float qmax,
    void* stream) {
  using namespace nxdi;
  if (B <= 0 || K <= 0 || Hkv <= 0 || Hq % Hkv != 0 || K > MAX_Q ||
      S_kv <= 0 || S_kv > S_max || B > R || layer < 0 || layer >= L)
    return (int)cudaErrorInvalidValue;
  SplitParams p{q, k_cache, v_cache, static_cast<const unsigned char*>(mask), sink, out, m_part, l_part, acc_part,
                nullptr, B, K, Hq, Hkv, S_kv, layer, splits, per, R, S_max, 0, 0, 0, mask_sb, mask_st, scale,
                k_scale, v_scale, qmax};
  return (int)split_entry<false>(p, D, dtype, cache_dtype, static_cast<cudaStream_t>(stream));
}

// B4: the same split over the table's MB * bs positions, bs 16 or 32; the
// cache (L, NB1, Hkv, bs, D) head-major.
extern "C" int nxdi_paged_decode_attention(
    const void* q, const void* k_cache, const void* v_cache, const void* mask,
    const float* sink, const int* block_table, void* out, float* m_part, float* l_part, float* acc_part,
    int B, int K, int Hq, int Hkv, int D, int L, int NB1, int bs, int MB, int layer,
    int mask_sb, int mask_st, int splits, int per,
    float scale, int dtype, int cache_dtype, const float* k_scale, const float* v_scale, float qmax,
    void* stream) {
  using namespace nxdi;
  if (B <= 0 || K <= 0 || Hkv <= 0 || Hq % Hkv != 0 || K > MAX_Q ||
      MB <= 0 || NB1 <= 0 || layer < 0 || layer >= L || (bs != 16 && bs != 32))
    return (int)cudaErrorInvalidValue;
  SplitParams p{q, k_cache, v_cache, static_cast<const unsigned char*>(mask), sink, out, m_part, l_part, acc_part,
                block_table, B, K, Hq, Hkv, MB * bs, layer, splits, per, 0, 0, NB1, MB, bs == 16 ? 4 : 5,
                mask_sb, mask_st, scale, k_scale, v_scale, qmax};
  return (int)split_entry<true>(p, D, dtype, cache_dtype, static_cast<cudaStream_t>(stream));
}
