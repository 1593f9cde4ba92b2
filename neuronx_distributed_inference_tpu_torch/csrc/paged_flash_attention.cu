// Paged flash attention for chunked and prefix prefill on Hopper (sm_90a):
// kernel B5 of the port.
//
// Replaces the TPU kernel neuronx_distributed_inference_tpu/ops/
// paged_flash_attention.py::paged_flash_attention (_paged_kernel) for
// bf16/fp32 caches and, in code mode, int8/fp8 code blocks with the
// reference's k_scale / v_scale.
//
// What it computes: query token t of row b (position positions[b, t])
// attends the row's paged cache at positions p <= positions[b, t] with
// p < kv_limit[b] — the prior context plus causal attention among the new
// tokens, whose K/V the caller has already written (write-then-attend).
// Online softmax with NEG_INF = -1e30 fills and masked probabilities
// zeroed; out = acc / max(l, 1e-30), so a row with no valid key writes
// zeros, as the reference's finalize does.
//
// The block: one block per (q tile, kv head, row). Its 64 query rows are
// the n_rep q heads of kv head g times TQP = 64 / n_rep (rounded down) query
// positions (row r = local head r / TQP, position iq * TQP + r % TQP), so
// the n_rep heads share every K/V tile and no repeat_kv exists; a 128-token
// chunk runs 8 blocks per (row, kv head) at n_rep 4: 512 blocks at batch 8.
// Where n_rep does not divide 64 (DBRX's 6: 10 positions, 60 rows) the last
// 64 mod n_rep rows hold no query: no read, no write, no valid key. The TPU grid (B, Hq,
// q_tiles, MB) ran its kv axis in order; here the kv loop lives inside the
// block and stops at min(the block's largest query position, kv_limit - 1).
// A row with kv_limit == 0 (an inactive slot of a chunk pass, which runs at
// the session's full batch with a zero block table) writes zeros and exits.
// Reads go through the block table: position s of kv head g lives in block
// blk = block_table[b, s / bs] of the head-major (NB+1, Hkv, bs, D) layer at
// ((blk * Hkv + g) * bs + s % bs) * D; the kernel reads the table itself
// (the TPU kernel had it as scalar prefetch). Positions at or past kv_limit,
// block 0 (the garbage block, which the fault tests fill with NaN) and any
// id outside [1, NB] load as zeros, so a NaN never reaches the products.
//
// What bounds it on an H100: a 128-token chunk over a context of S keys
// does ~4 * D * Hq * 128 * S FLOP for ~2 * S * Hkv * D * bytes of K/V and
// 2 * 128 * Hq * D * bytes of q/out; at S = 128, D = 64, Hq 32 / Hkv 8 in
// bf16 that is ~67 MFLOP per row (causal: half) against ~1.3 MB: under the
// card's ~295 FLOP/byte ridge, so memory bounds it at the roofline, with the
// bf16 tensor-core rate close behind. Reaching either takes the tensor
// cores: this kernel's first version did both products as fp32 FMAs (~1/15 of the bf16
// rate), loaded K/V element by element through the table with a conversion
// each, and passed the probabilities through shared memory behind three
// barriers a tile (0.1264 ms for 8 x 128 new tokens, 2.1x SDPA on K/V
// gathered beforehand).
//
// bf16 design (paged_flash_mma, its body paged_attention_tile.cuh
// flash_mma, which B3's prefill tiles run too), after B2's
// (flash_attention.cu):
//   - Both products on the tensor cores, mma.sync m16n8k16 bf16 -> fp32
//     (mma.cuh). 4 warps x 16 query rows; each warp keeps its Q fragments
//     (ldmatrix, once), its 16 x 64 score tile, its softmax state and its
//     16 x D output in registers. P becomes the bf16 A operand of P.V in
//     registers and never goes through shared memory; l sums the fp32
//     probabilities, and only the P.V operand is rounded to bf16 (the
//     rounding the TPU's MXU makes at default precision). One FFMA and
//     ex2.approx per probability.
//   - K / V tiles of 64 positions (2 or 4 cache blocks at bs 32 or 16)
//     arrive by 16-byte cp.async straight from the head-major layer (a
//     block's head-g slice is bs x D contiguous) into two stages padded by
//     16 bytes a row, so ldmatrix (K) and ldmatrix.trans (V) hit distinct
//     banks; the next tile is in flight while this one is computed. The
//     zero rule is cp.async's zero-fill, per 16-byte chunk: the tensor core
//     multiplies every element, so a NaN of block 0 must never reach shared
//     memory, and none does.
//   - Each row's allowed columns are one interval, [0, min(pos, kv_limit -
//     1)], found once; a tile that every row of a warp sees whole skips the
//     per-element predicate.
// fp32 design (paged_flash_kernel): the first version's FMA loop, the
// paged::attend of paged_attention_tile.cuh that the ragged kernel B3
// shares; an fp32 q runs only in the parity checks, and TF32 products
// would break their bound.
//
// Code mode (int8 / fp8 e4m3 / e5m2 code blocks with the layer's (Hkv,)
// running scales and the code type's qmax, read on the device at launch,
// so a captured graph sees each step's): the kernel takes the caller's q
// as it is, folds nothing into it and writes no dequantized cache; a call
// is one launch with no pass around it. K's factor scale / qmax multiplies
// the score scale (the reference folds it into an fp32 q: the same
// product up to fp32 rounding), V's the finalized output before its one
// rounding (the reference's v_scale).
//   - bf16 q: paged_flash_mma<C>, the tensor-core body over code tiles.
//     Code K / V tiles arrive by 16-byte cp.async (16 codes of one
//     position a chunk, still through the table, block 0 still cp.async's
//     zero fill: its 0x7F is NaN in e4m3) into three stages of 1-byte rows
//     padded by 16 bytes (a code stage is half a bf16 stage). Each tile is
//     converted once, by the whole block, into a padded bf16 (K, V) pair
//     that the bf16 path's ldmatrix / ldmatrix.trans read unchanged: every
//     int8 in [-127, 127] and every finite e4m3 / e5m2 value is a bf16
//     value, so Q.K^T and P.V are the bf16 tiles' mma.sync and the only
//     rounding beyond the reference's is P's to bf16 at P.V, as in bf16.
//     (Converting in registers into the B-operand layout instead, with no
//     bf16 copy, is slower: scripts/torch_attention_variants.py b5codes.)
//   - fp32 q (parity checks only): paged_flash_kernel<float, C>, attend()
//     with each code converted to fp32 as it is loaded.
//
// No atomics: every sum runs in a fixed order, so results repeat bit for bit.
//
// Layout: q (B, Sq, Hq, D) contiguous; k/v one layer (NB+1, Hkv, bs, D)
// contiguous (bf16: 16-byte aligned bases, which the wrapper checks);
// block_table (B, MB) int32; positions (B, Sq) int32; kv_limit (B,) int32;
// out (B, Sq, Hq, D) contiguous.

#include "paged_attention_tile.cuh"

namespace nxdi {
namespace {

using paged::BQ;
using paged::RG;
using paged::ROWS_T;
using paged::THREADS;

struct PagedFlashParams {
  const void* q;
  const void* k;
  const void* v;
  const int* block_table;
  const int* positions;
  const int* kv_limit;
  void* out;
  int Sq, Hq, Hkv, NB1, bs, MB;
  float scale;
  // code mode: the layer's (Hkv,) fp32 K / V running scales and the code
  // type's qmax (null and 0 for a plain cache)
  const float* k_scale;
  const float* v_scale;
  float qmax;
};

// ---------------------------------------------------------------------------
// bf16 q: tensor cores, over a bf16 cache or code blocks C
// ---------------------------------------------------------------------------

template <typename C, int D>
__global__ void __launch_bounds__(THREADS) paged_flash_mma(const PagedFlashParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int iq = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rep = p.Hq / p.Hkv;
  const int tqp = BQ / n_rep;  // query positions per block
  const int used = tqp * n_rep;  // rows that hold a query
  // query row r -> position index t and q head h
  auto row_t = [&](int r) { return iq * tqp + r % tqp; };
  auto live = [&](int r) { return r < used && row_t(r) < p.Sq; };
  auto row_off = [&](int r) -> long long {  // (b, t, h) element offset of row r in q / out
    return live(r) ? (((long long)b * p.Sq + row_t(r)) * p.Hq + hk * n_rep + r / tqp) * D : -1;
  };
  auto row_pos = [&](int r) { return live(r) ? p.positions[(long long)b * p.Sq + row_t(r)] : -1; };
  // a row's table covers MB * bs positions: nothing past them exists
  paged::flash_mma<C, D>(smem_raw, static_cast<const __nv_bfloat16*>(p.q), static_cast<__nv_bfloat16*>(p.out),
                         row_off, row_pos, static_cast<const C*>(p.k), static_cast<const C*>(p.v),
                         p.block_table + (long long)b * p.MB, hk, p.Hkv, p.bs, p.NB1,
                         min(p.kv_limit[b], p.MB * p.bs), p.scale * dequant_factor(p.k_scale, hk, p.qmax),
                         dequant_factor(p.v_scale, hk, p.qmax));
}

template <typename C, int D>
cudaError_t launch_mma(const PagedFlashParams& p, int B, cudaStream_t stream) {
  using Tile = paged::MmaTile<C, D>;
  const cudaError_t err = cudaFuncSetAttribute(paged_flash_mma<C, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)Tile::smem);
  if (err != cudaSuccess) return err;
  const int tqp = BQ / (p.Hq / p.Hkv);
  const dim3 grid((p.Sq + tqp - 1) / tqp, p.Hkv, B);
  paged_flash_mma<C, D><<<grid, THREADS, Tile::smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: FMAs on the CUDA cores
// ---------------------------------------------------------------------------

// T: q and out; C: the cache (T, or 1-byte codes with T = float)
template <typename T, typename C, int D>
__global__ void __launch_bounds__(THREADS) paged_flash_kernel(const PagedFlashParams p) {
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  const paged::Smem<D> sm(smem);

  const int tid = threadIdx.x;
  const int iq = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rep = p.Hq / p.Hkv;
  const int tqp = BQ / n_rep;  // query positions per block
  const int used = tqp * n_rep;  // rows that hold a query
  // a row's table covers MB * bs positions: nothing past them exists
  const int limit = min(p.kv_limit[b], p.MB * p.bs);
  const T* qp = static_cast<const T*>(p.q);
  T* op = static_cast<T*>(p.out);

  // query row -> (position index t, head h); rows past Sq or past the used
  // rows carry position -1
  for (int row = tid; row < BQ; row += THREADS) {
    const int t = iq * tqp + row % tqp;
    sm.pos[row] = row < used && t < p.Sq ? p.positions[(long long)b * p.Sq + t] : -1;
  }
  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int row = idx / D, d = idx % D;
    const int t = iq * tqp + row % tqp;
    const int h = g * n_rep + row / tqp;
    sm.Qs[row * LD + d] = row < used && t < p.Sq ? to_float(qp[(((long long)b * p.Sq + t) * p.Hq + h) * D + d]) : 0.f;
  }
  __syncthreads();

  float l_i[ROWS_T], acc[ROWS_T][D / paged::CG];
  paged::attend<C, D>(sm, static_cast<const C*>(p.k), static_cast<const C*>(p.v),
                      p.block_table + (long long)b * p.MB, g, p.Hkv, p.bs, p.NB1, limit,
                      p.scale * dequant_factor(p.k_scale, g, p.qmax), l_i, acc);
  const float vf = dequant_factor(p.v_scale, g, p.qmax);

  const int r = tid / paged::CG;
#pragma unroll
  for (int i = 0; i < ROWS_T; ++i) {
    const int lrow = r + RG * i;
    const int t = iq * tqp + lrow % tqp;
    if (lrow >= used || t >= p.Sq) continue;
    const int h = g * n_rep + lrow / tqp;
    paged::finalize_row<T, D>(op + (((long long)b * p.Sq + t) * p.Hq + h) * D, l_i[i], acc[i], vf);
  }
}

template <typename T, typename C, int D>
cudaError_t launch(const PagedFlashParams& p, int B, cudaStream_t stream) {
  cudaError_t err = paged::allow_smem<D>(paged_flash_kernel<T, C, D>);
  if (err != cudaSuccess) return err;
  const int tqp = BQ / (p.Hq / p.Hkv);
  const dim3 grid((p.Sq + tqp - 1) / tqp, p.Hkv, B);
  paged_flash_kernel<T, C, D><<<grid, THREADS, paged::smem_bytes<D>(), stream>>>(p);
  return cudaGetLastError();
}

// a code cache C under a bf16 q (tensor cores) or an fp32 q (attend)
template <typename C>
cudaError_t launch_codes(const PagedFlashParams& p, int B, int D, int dtype, cudaStream_t stream) {
  if (!p.k_scale || !p.v_scale || !(p.qmax > 0.f)) return cudaErrorInvalidValue;
  if (dtype == kBFloat16 && D == 64) return launch_mma<C, 64>(p, B, stream);
  if (dtype == kBFloat16 && D == 128) return launch_mma<C, 128>(p, B, stream);
  if (dtype == kFloat32 && D == 64) return launch<float, C, 64>(p, B, stream);
  if (dtype == kFloat32 && D == 128) return launch<float, C, 128>(p, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace nxdi

// dtype: q's and out's (bf16 or fp32); cache_dtype: dtype, or an int8/fp8
// code type, whose layer's (Hkv,) fp32 running scales k_scale / v_scale
// and qmax come with it (null and 0 for a plain cache).
extern "C" int nxdi_paged_flash_attention(
    const void* q, const void* k, const void* v, const int* block_table,
    const int* positions, const int* kv_limit, void* out,
    int B, int Sq, int Hq, int Hkv, int D, int NB1, int bs, int MB,
    float scale, int dtype, int cache_dtype, const float* k_scale, const float* v_scale, float qmax, void* stream) {
  using namespace nxdi;
  if (B <= 0 || Sq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > BQ ||
      NB1 <= 0 || bs <= 0 || MB <= 0)
    return (int)cudaErrorInvalidValue;
  PagedFlashParams p{q, k, v, block_table, positions, kv_limit, out,
                     Sq, Hq, Hkv, NB1, bs, MB, scale, k_scale, v_scale, qmax};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (cache_dtype == kInt8) err = launch_codes<int8_t>(p, B, D, dtype, st);
  else if (cache_dtype == kFp8E4M3) err = launch_codes<Fp8E4M3>(p, B, D, dtype, st);
  else if (cache_dtype == kFp8E5M2) err = launch_codes<Fp8E5M2>(p, B, D, dtype, st);
  else if (cache_dtype != dtype) err = cudaErrorInvalidValue;
  else if (dtype == kFloat32 && D == 64) err = launch<float, float, 64>(p, B, st);
  else if (dtype == kFloat32 && D == 128) err = launch<float, float, 128>(p, B, st);
  else if (dtype == kBFloat16 && D == 64) err = launch_mma<__nv_bfloat16, 64>(p, B, st);
  else if (dtype == kBFloat16 && D == 128) err = launch_mma<__nv_bfloat16, 128>(p, B, st);
  return (int)err;
}
