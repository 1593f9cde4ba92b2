// Decode (token-generation) attention over the contiguous KV cache for
// Hopper (sm_90a): kernel B1 of the port.
//
// Replaces the TPU kernel neuronx_distributed_inference_tpu/ops/
// decode_attention.py::tkg_decode_attention (_common_call -> _tkg_kernel,
// _body, _finalize) for bf16/fp32 caches.
//
// What it computes: for batch row b and kv head g, the n_rep * K query rows
// of that group (row hl * K + t is local q head hl = h - g * n_rep at token
// t, the reference's rep-major _prep_q order, so GQA needs no repeat_kv)
// attend cache line b of layer `layer` over positions [0, S_kv) under the
// (B, 1, K, S_kv) boolean decode mask, with an online softmax over kv tiles.
// Tiles whose mask is all false for the batch row are skipped. Without a
// sink, out = acc / max(l, 1e-30); with one, the sink logit joins the
// denominator after both are renormalized to max(m, sink).
//
// What bounds it on an H100: decode reads each layer's cache bucket once
// (2 * S_kv * Hkv * D * bytes) for ~4 * n_rep * K * S_kv * Hkv * D FLOP, an
// arithmetic intensity of about n_rep * K FLOP per byte, far below the
// card's ~295 FLOP/byte ridge: memory bandwidth bounds it. The design reads
// every cache tile once, straight out of the full stacked cache (no bucket
// slice copy, no repeat_kv broadcast) and shares it among all the group's
// query rows. One block per (batch row, kv head) gives only B * Hkv blocks
// (8 at batch 1 for Llama-3.2-1B) on 132 SMs, so one launch cannot reach
// the card's bandwidth; splitting the kv axis over more blocks is a later
// step.
//
// Layout: q (B, K, Hq, D) contiguous; caches (L, R, S_max, Hkv, D)
// contiguous; mask bytes addressed as b * mask_sb + t * mask_st + s;
// sink (Hq,) fp32 or null; out (B, K, Hq, D) contiguous.

#include "common.cuh"

namespace nxdi {
namespace {

constexpr int BS = 64;  // kv positions per tile (two per lane of a warp)
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_ROWS = 64;  // n_rep * K

struct DecodeParams {
  const void* q;
  const void* k_cache;
  const void* v_cache;
  const unsigned char* mask;
  const float* sink;
  void* out;
  int K, Hq, Hkv, R, S_max, S_kv, layer;
  long long mask_sb, mask_st;
  float scale;
};

template <int D>
__host__ __device__ constexpr size_t smem_bytes(int rows) {
  // Q rows and the K tile padded to D + 1 floats (conflict-free column
  // reads), V tile, score / probability tile padded to BS + 1, per-row
  // (m, l, alpha), per-score mask bytes
  return sizeof(float) * (size_t)(rows * (D + 1) + BS * (D + 1) + BS * D + rows * (BS + 1) + 3 * rows) +
         (size_t)rows * BS;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) tkg_decode_kernel(const DecodeParams p) {
  constexpr int LD = D + 1;
  constexpr int SLD = BS + 1;
  constexpr int NACC = MAX_ROWS * D / THREADS;  // (row, d) outputs per thread, at most
  extern __shared__ float smem[];
  const int n_rep = p.Hq / p.Hkv;
  const int rows = n_rep * p.K;
  float* Qs = smem;
  float* Ks = Qs + rows * LD;
  float* Vs = Ks + BS * LD;
  float* Ss = Vs + BS * D;
  float* m_s = Ss + rows * SLD;
  float* l_s = m_s + rows;
  float* alpha_s = l_s + rows;
  unsigned char* ok_s = reinterpret_cast<unsigned char*>(alpha_s + rows);

  const int tid = threadIdx.x;
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const T* q = static_cast<const T*>(p.q);
  // cache line b of `layer`, kv head g: position s at line + s * Hkv * D
  const long long line = (((long long)p.layer * p.R + b) * p.S_max * p.Hkv + g) * D;
  const T* kc = static_cast<const T*>(p.k_cache) + line;
  const T* vc = static_cast<const T*>(p.v_cache) + line;
  const long long pos_stride = (long long)p.Hkv * D;
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

  const int n_tiles = (p.S_kv + BS - 1) / BS;
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int s0 = jt * BS;
    int any = 0;
    for (int idx = tid; idx < p.K * BS; idx += THREADS) {
      const int t = idx / BS, s = s0 + idx % BS;
      if (s < p.S_kv && mrow[t * p.mask_st + s]) any = 1;
    }
    // also the barrier after the previous tile's readers of Ks / Vs / Ss
    if (!__syncthreads_or(any)) continue;

    for (int idx = tid; idx < BS * D; idx += THREADS) {
      const int c = idx / D, d = idx % D;
      const int s = s0 + c;
      float kv = 0.f, vv = 0.f;
      if (s < p.S_kv) {
        kv = to_float(kc[s * pos_stride + d]);
        vv = to_float(vc[s * pos_stride + d]);
      }
      Ks[c * LD + d] = kv;
      Vs[c * D + d] = vv;
    }
    __syncthreads();

    for (int idx = tid; idx < rows * BS; idx += THREADS) {
      const int r = idx / BS, c = idx % BS;
      const int t = r % p.K, s = s0 + c;
      const bool ok = s < p.S_kv && mrow[t * p.mask_st + s];
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(Qs[r * LD + d], Ks[c * LD + d], dot);
      Ss[r * SLD + c] = ok ? dot * p.scale : NEG_INF;
      ok_s[r * BS + c] = ok ? 1 : 0;
    }
    __syncthreads();

    // online-softmax update, one warp per row
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < rows; r += WARPS) {
      const float sa = Ss[r * SLD + lane], sb = Ss[r * SLD + lane + 32];
      const float mx = group_max<32>(fmaxf(sa, sb));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float pa = ok_s[r * BS + lane] ? expf(sa - m_new) : 0.f;
      const float pb = ok_s[r * BS + lane + 32] ? expf(sb - m_new) : 0.f;
      Ss[r * SLD + lane] = pa;
      Ss[r * SLD + lane + 32] = pb;
      const float sum = group_sum<32>(pa + pb);
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
        for (int c = 0; c < BS; ++c) a = fmaf(Ss[r * SLD + c], Vs[c * D + d], a);
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

template <typename T, int D>
cudaError_t launch(const DecodeParams& p, int B, cudaStream_t stream) {
  const int rows = (p.Hq / p.Hkv) * p.K;
  cudaError_t err = cudaFuncSetAttribute(
      tkg_decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes<D>(MAX_ROWS));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.Hkv, B);
  tkg_decode_kernel<T, D><<<grid, THREADS, smem_bytes<D>(rows), stream>>>(p);
  return cudaGetLastError();
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
  DecodeParams p{q, k_cache, v_cache, static_cast<const unsigned char*>(mask), sink, out,
                 K, Hq, Hkv, R, S_max, S_kv, layer, mask_sb, mask_st, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kFloat32 && D == 64) err = launch<float, 64>(p, B, st);
  else if (dtype == kFloat32 && D == 128) err = launch<float, 128>(p, B, st);
  else if (dtype == kBFloat16 && D == 64) err = launch<__nv_bfloat16, 64>(p, B, st);
  else if (dtype == kBFloat16 && D == 128) err = launch<__nv_bfloat16, 128>(p, B, st);
  return (int)err;
}
