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
// masked probabilities zeroed, out = acc / max(l, 1e-30), and the row's
// softmax stats (m, l) for the sink fold outside the kernel.
//
// What bounds it on an H100: at the main path's shapes (S = 128..512,
// D = 64, 32 q heads) the causal work is ~2 * S^2 * D FLOP per head, 0.07
// to 1.1 GFLOP, against 1.3 to 5.2 MB of q/k/v/out traffic: under the
// card's ~295 FLOP/byte ridge, so at the roofline memory bounds it, with
// the tensor-core rate close behind at S = 512. This first version does its
// products with fp32 FMAs on the CUDA cores (about 1/15 of the bf16
// tensor-core rate) and so is compute bound far above that bound;
// mma.sync / wgmma tiles are a later step. What the design does
// about the bound: K/V tiles are staged once per block in shared memory and
// reused by all 64 query rows of the tile, the TPU's sequential kv grid axis
// becomes a loop inside the block that stops at the causal / window /
// chunk frontier (dead tiles skipped), GQA reads kv head h / n_rep directly
// so no repeat_kv copy is ever made, and ragged sequence edges are masked
// in the kernel.
//
// Layout: q (B, S, Hq, D), k/v (B, S, Hkv, D) with unit element stride and
// head stride D (batch and token strides are arguments, so split views of
// a fused QKV projection need no copy); key_valid (B, S) int32;
// out (B, S, Hq, D) contiguous; m, l (B, Hq, S) fp32.

#include "common.cuh"

namespace nxdi {
namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BKV = 64;      // kv positions per tile
constexpr int THREADS = 128;
// thread (r, c) = (tid / 8, tid % 8) owns query rows r + 16 * i (i < 4)
// and score columns c + 8 * j (j < 8) of the 64 x 64 score tile, and
// output columns c + 8 * j (j < D / 8) of its rows
constexpr int RG = 16;
constexpr int CG = 8;
constexpr int ROWS_T = BQ / RG;
constexpr int COLS_T = BKV / CG;

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

template <int D>
constexpr size_t smem_bytes() {
  // Q and K tiles padded to D + 1 floats a row (conflict-free column reads),
  // V tile, probability tile padded to BKV + 1, key validity of the tile
  return sizeof(float) * (size_t)(BQ * (D + 1) + BKV * (D + 1) + BKV * D + BQ * (BKV + 1)) +
         sizeof(int) * BKV;
}

// reference _tile_live: false when the (BQ, BKV) tile lies entirely outside
// the mask
__device__ __forceinline__ bool tile_live(int q_start, int kv_start, const FlashParams& p) {
  const int q_last = q_start + BQ - 1;
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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const FlashParams p) {
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
    if (!tile_live(q_start, kv_start, p)) continue;  // uniform over the block
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

template <typename T, int D>
cudaError_t launch(const FlashParams& p, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + BQ - 1) / BQ, p.Hq, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
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
  if (dtype == kFloat32 && D == 64) err = launch<float, 64>(p, B, st);
  else if (dtype == kFloat32 && D == 128) err = launch<float, 128>(p, B, st);
  else if (dtype == kBFloat16 && D == 64) err = launch<__nv_bfloat16, 64>(p, B, st);
  else if (dtype == kBFloat16 && D == 128) err = launch<__nv_bfloat16, 128>(p, B, st);
  return (int)err;
}
