// Decode (token-generation) attention for Hopper (sm_90a), over the
// contiguous KV cache (kernel B1 of the port) and over the paged block
// cache (kernel B4). One kernel template serves both: its PAGED parameter
// selects how a (batch row, kv tile) maps to cache addresses.
//
// Replaces the TPU kernels neuronx_distributed_inference_tpu/ops/
// decode_attention.py::tkg_decode_attention (B1) and
// ::paged_tkg_decode_attention (B4) (both _common_call -> _tkg_kernel,
// _body, _finalize) for bf16/fp32 caches.
//
// What it computes: for batch row b and kv head g, the n_rep * K query rows
// of that group (row hl * K + t is local q head hl = h - g * n_rep at token
// t, the reference's rep-major _prep_q order, so GQA needs no repeat_kv)
// attend the row's cache over positions [0, S_kv) under the (B, 1, K, S_kv)
// boolean decode mask, with an online softmax over kv tiles. Tiles whose
// mask is all false for the batch row are skipped. Without a sink,
// out = acc / max(l, 1e-30); with one, the sink logit joins the denominator
// after both are renormalized to max(m, sink).
//
// Address modes:
//   contiguous (B1): tiles of 64 positions of cache line b of `layer` in the
//     (L, R, S_max, Hkv, D) cache; position s of head g at
//     ((layer * R + b) * S_max + s) * Hkv * D + g * D.
//   paged (B4): one tile per block-table entry j, TILE = block size. The
//     kernel reads block_table[b, j] itself (the TPU kernel had it as scalar
//     prefetch) and addresses the head-major (L, NB+1, Hkv, bs, D) cache:
//     block blk of head g is the contiguous (bs, D) tile at
//     ((layer * (NB+1) + blk) * Hkv + g) * bs * D, so its loads are unit
//     stride. Block 0 is the garbage block, where invalid writes land and
//     where the fault tests write NaN: its tiles (and any id outside
//     [1, NB]) load as zeros, the reference's read scrub
//     (block_kvcache.py::read_block_cache_at_layer). A masked probability is
//     exactly 0, but 0 * NaN is NaN, so a tile that holds both a valid
//     position and a block-0 value must never multiply one by the other:
//     the zero load and the all-false tile skip together rule that out.
//
// What bounds it on an H100: decode reads each layer's live cache once
// (2 * S_kv * Hkv * D * bytes) for ~4 * n_rep * K * S_kv * Hkv * D FLOP, an
// arithmetic intensity of about n_rep * K FLOP per byte, far below the
// card's ~295 FLOP/byte ridge: memory bandwidth bounds it. The design reads
// every live cache tile once, straight out of the full stacked cache (no
// bucket slice, no block gather, no repeat_kv broadcast) and shares it among
// all the group's query rows. One block per (batch row, kv head) gives
// B * Hkv blocks (64 at the serving batch of 8 for Llama-3.2-1B) on 132
// SMs; splitting the kv axis over more blocks is a later step.
//
// Layout: q (B, K, Hq, D) contiguous; caches contiguous as above;
// block_table (B, MB) int32 contiguous (paged); mask bytes addressed as
// b * mask_sb + t * mask_st + s; sink (Hq,) fp32 or null; out (B, K, Hq, D)
// contiguous.

#include "common.cuh"

namespace nxdi {
namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_ROWS = 64;  // n_rep * K
constexpr int CONTIG_TILE = 64;  // kv positions per tile, contiguous mode

struct DecodeParams {
  const void* q;
  const void* k_cache;
  const void* v_cache;
  const unsigned char* mask;
  const float* sink;
  const int* block_table;  // paged mode only
  void* out;
  int K, Hq, Hkv, R, S_max, S_kv, layer;
  int NB1, MB;  // paged mode: blocks (garbage block included), table width
  long long mask_sb, mask_st;
  float scale;
};

template <int D, int TILE>
__host__ __device__ constexpr size_t smem_bytes(int rows) {
  // Q rows and the K tile padded to D + 1 floats (conflict-free column
  // reads), V tile, score / probability tile padded to TILE + 1, per-row
  // (m, l, alpha), per-score mask bytes
  return sizeof(float) * (size_t)(rows * (D + 1) + TILE * (D + 1) + TILE * D + rows * (TILE + 1) + 3 * rows) +
         (size_t)rows * TILE;
}

template <typename T, int D, int TILE, bool PAGED>
__global__ void __launch_bounds__(THREADS) decode_kernel(const DecodeParams p) {
  constexpr int LD = D + 1;
  constexpr int SLD = TILE + 1;
  constexpr int NACC = MAX_ROWS * D / THREADS;  // (row, d) outputs per thread, at most
  constexpr int PER_LANE = (TILE + 31) / 32;  // scores per lane in the softmax update
  extern __shared__ float smem[];
  const int n_rep = p.Hq / p.Hkv;
  const int rows = n_rep * p.K;
  float* Qs = smem;
  float* Ks = Qs + rows * LD;
  float* Vs = Ks + TILE * LD;
  float* Ss = Vs + TILE * D;
  float* m_s = Ss + rows * SLD;
  float* l_s = m_s + rows;
  float* alpha_s = l_s + rows;
  unsigned char* ok_s = reinterpret_cast<unsigned char*>(alpha_s + rows);

  const int tid = threadIdx.x;
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const T* q = static_cast<const T*>(p.q);
  const T* kc = static_cast<const T*>(p.k_cache);
  const T* vc = static_cast<const T*>(p.v_cache);
  const unsigned char* mrow = p.mask + (long long)b * p.mask_sb;

  for (int idx = tid; idx < rows * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    const int hl = r / p.K, t = r % p.K;
    const int h = g * n_rep + hl;
    Qs[r * LD + d] = to_float(q[(((long long)b * p.K + t) * p.Hq + h) * D + d]);
  }
  for (int r = tid; r < rows; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  const int n_pairs = rows * D;

  const int n_tiles = (p.S_kv + TILE - 1) / TILE;
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int s0 = jt * TILE;
    int any = 0;
    for (int idx = tid; idx < p.K * TILE; idx += THREADS) {
      const int t = idx / TILE, s = s0 + idx % TILE;
      if (s < p.S_kv && mrow[t * p.mask_st + s]) any = 1;
    }
    // also the barrier after the previous tile's readers of Ks / Vs / Ss
    if (!__syncthreads_or(any)) continue;

    // base address of the tile's first position for kv head g, and the
    // stride between positions; a null base loads zeros
    long long base = -1;
    long long pos_stride;
    if (PAGED) {
      const int blk = p.block_table[(long long)b * p.MB + jt];
      if (blk > 0 && blk < p.NB1) base = (((long long)p.layer * p.NB1 + blk) * p.Hkv + g) * TILE * D;
      pos_stride = D;
    } else {
      base = ((((long long)p.layer * p.R + b) * p.S_max + s0) * p.Hkv + g) * D;
      pos_stride = (long long)p.Hkv * D;
    }
    for (int idx = tid; idx < TILE * D; idx += THREADS) {
      const int c = idx / D, d = idx % D;
      float kv = 0.f, vv = 0.f;
      if (base >= 0 && s0 + c < p.S_kv) {
        kv = to_float(kc[base + c * pos_stride + d]);
        vv = to_float(vc[base + c * pos_stride + d]);
      }
      Ks[c * LD + d] = kv;
      Vs[c * D + d] = vv;
    }
    __syncthreads();

    for (int idx = tid; idx < rows * TILE; idx += THREADS) {
      const int r = idx / TILE, c = idx % TILE;
      const int t = r % p.K, s = s0 + c;
      const bool ok = s < p.S_kv && mrow[t * p.mask_st + s];
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(Qs[r * LD + d], Ks[c * LD + d], dot);
      Ss[r * SLD + c] = ok ? dot * p.scale : NEG_INF;
      ok_s[r * TILE + c] = ok ? 1 : 0;
    }
    __syncthreads();

    // online-softmax update, one warp per row
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < rows; r += WARPS) {
      float sv[PER_LANE];
      bool okv[PER_LANE];
      float mx = NEG_INF;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        const int c = lane + 32 * i;
        sv[i] = c < TILE ? Ss[r * SLD + c] : NEG_INF;
        okv[i] = c < TILE && ok_s[r * TILE + c];
        mx = fmaxf(mx, sv[i]);
      }
      mx = group_max<32>(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        const int c = lane + 32 * i;
        const float pr = okv[i] ? expf(sv[i] - m_new) : 0.f;
        if (c < TILE) Ss[r * SLD + c] = pr;
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
      const int idx = tid + THREADS * i;
      if (idx < n_pairs) {
        const int r = idx / D, d = idx % D;
        float a = acc[i] * alpha_s[r];
#pragma unroll 8
        for (int c = 0; c < TILE; ++c) a = fmaf(Ss[r * SLD + c], Vs[c * D + d], a);
        acc[i] = a;
      }
    }
  }
  __syncthreads();

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int idx = tid + THREADS * i;
    if (idx >= n_pairs) continue;
    const int r = idx / D, d = idx % D;
    const int hl = r / p.K, t = r % p.K;
    const int h = g * n_rep + hl;
    float o;
    if (p.sink != nullptr) {
      // reference _finalize: renormalize to m2 = max(m, sink) so rows that
      // saw no valid key stay finite
      const float sk = p.sink[h];
      const float m2 = fmaxf(m_s[r], sk);
      const float alpha = expf(m_s[r] - m2);
      const float denom = l_s[r] * alpha + expf(sk - m2);
      o = acc[i] * alpha / denom;
    } else {
      o = acc[i] / fmaxf(l_s[r], 1e-30f);
    }
    out[(((long long)b * p.K + t) * p.Hq + h) * D + d] = from_float<T>(o);
  }
}

template <typename T, int D, int TILE, bool PAGED>
cudaError_t launch(const DecodeParams& p, int B, cudaStream_t stream) {
  const int rows = (p.Hq / p.Hkv) * p.K;
  cudaError_t err = cudaFuncSetAttribute(decode_kernel<T, D, TILE, PAGED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes<D, TILE>(MAX_ROWS));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.Hkv, B);
  decode_kernel<T, D, TILE, PAGED><<<grid, THREADS, smem_bytes<D, TILE>(rows), stream>>>(p);
  return cudaGetLastError();
}

template <int TILE, bool PAGED>
cudaError_t dispatch(const DecodeParams& p, int B, int D, int dtype, cudaStream_t st) {
  if (dtype == kFloat32 && D == 64) return launch<float, 64, TILE, PAGED>(p, B, st);
  if (dtype == kFloat32 && D == 128) return launch<float, 128, TILE, PAGED>(p, B, st);
  if (dtype == kBFloat16 && D == 64) return launch<__nv_bfloat16, 64, TILE, PAGED>(p, B, st);
  if (dtype == kBFloat16 && D == 128) return launch<__nv_bfloat16, 128, TILE, PAGED>(p, B, st);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace nxdi

extern "C" int nxdi_tkg_decode_attention(
    const void* q, const void* k_cache, const void* v_cache, const void* mask,
    const float* sink, void* out,
    int B, int K, int Hq, int Hkv, int D, int L, int R, int S_max, int S_kv, int layer,
    int mask_sb, int mask_st,
    float scale, int dtype, void* stream) {
  using namespace nxdi;
  if (B <= 0 || K <= 0 || Hkv <= 0 || Hq % Hkv != 0 || (Hq / Hkv) * K > MAX_ROWS ||
      S_kv <= 0 || S_kv > S_max || B > R || layer < 0 || layer >= L)
    return (int)cudaErrorInvalidValue;
  DecodeParams p{q, k_cache, v_cache, static_cast<const unsigned char*>(mask), sink, nullptr, out,
                 K, Hq, Hkv, R, S_max, S_kv, layer, 0, 0, mask_sb, mask_st, scale};
  return (int)dispatch<CONTIG_TILE, false>(p, B, D, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int nxdi_paged_decode_attention(
    const void* q, const void* k_cache, const void* v_cache, const void* mask,
    const float* sink, const int* block_table, void* out,
    int B, int K, int Hq, int Hkv, int D, int L, int NB1, int bs, int MB, int layer,
    int mask_sb, int mask_st,
    float scale, int dtype, void* stream) {
  using namespace nxdi;
  if (B <= 0 || K <= 0 || Hkv <= 0 || Hq % Hkv != 0 || (Hq / Hkv) * K > MAX_ROWS ||
      MB <= 0 || NB1 <= 0 || layer < 0 || layer >= L)
    return (int)cudaErrorInvalidValue;
  DecodeParams p{q, k_cache, v_cache, static_cast<const unsigned char*>(mask), sink, block_table, out,
                 K, Hq, Hkv, 0, 0, MB * bs, layer, NB1, MB, mask_sb, mask_st, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bs == 16) return (int)dispatch<16, true>(p, B, D, dtype, st);
  if (bs == 32) return (int)dispatch<32, true>(p, B, D, dtype, st);
  return (int)cudaErrorInvalidValue;
}
