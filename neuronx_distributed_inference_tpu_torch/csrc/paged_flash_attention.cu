// Paged flash attention for chunked and prefix prefill on Hopper (sm_90a):
// kernel B5 of the port.
//
// Replaces the TPU kernel neuronx_distributed_inference_tpu/ops/
// paged_flash_attention.py::paged_flash_attention (_paged_kernel) for
// bf16/fp32 caches.
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
// the n_rep q heads of kv head g times 64 / n_rep query positions (row r =
// local head r / TQP, position iq * TQP + r % TQP), so the n_rep heads share
// every K/V tile and no repeat_kv exists; a 128-token chunk runs 8 blocks per
// (row, kv head) at n_rep 4: 512 blocks at batch 8. The TPU grid (B, Hq,
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
// shares; fp32 runs only in the parity checks, and TF32 products would
// break their bound.
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
};

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS) paged_flash_mma(const PagedFlashParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int iq = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rep = p.Hq / p.Hkv;
  const int tqp = BQ / n_rep;  // query positions per block
  // query row r -> position index t and q head h
  auto row_t = [&](int r) { return iq * tqp + r % tqp; };
  auto row_off = [&](int r) -> long long {  // (b, t, h) element offset of row r in q / out
    return row_t(r) < p.Sq ? (((long long)b * p.Sq + row_t(r)) * p.Hq + hk * n_rep + r / tqp) * D : -1;
  };
  auto row_pos = [&](int r) { return row_t(r) < p.Sq ? p.positions[(long long)b * p.Sq + row_t(r)] : -1; };
  // a row's table covers MB * bs positions: nothing past them exists
  paged::flash_mma<D>(smem_raw, static_cast<const __nv_bfloat16*>(p.q), static_cast<__nv_bfloat16*>(p.out),
                      row_off, row_pos, static_cast<const __nv_bfloat16*>(p.k), static_cast<const __nv_bfloat16*>(p.v),
                      p.block_table + (long long)b * p.MB, hk, p.Hkv, p.bs, p.NB1,
                      min(p.kv_limit[b], p.MB * p.bs), p.scale);
}

template <int D>
cudaError_t launch_mma(const PagedFlashParams& p, int B, cudaStream_t stream) {
  using Tile = paged::MmaTile<D>;
  const cudaError_t err = cudaFuncSetAttribute(paged_flash_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)Tile::smem);
  if (err != cudaSuccess) return err;
  const int tqp = BQ / (p.Hq / p.Hkv);
  const dim3 grid((p.Sq + tqp - 1) / tqp, p.Hkv, B);
  paged_flash_mma<D><<<grid, THREADS, Tile::smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: FMAs on the CUDA cores
// ---------------------------------------------------------------------------

template <typename T, int D>
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
  // a row's table covers MB * bs positions: nothing past them exists
  const int limit = min(p.kv_limit[b], p.MB * p.bs);
  const T* qp = static_cast<const T*>(p.q);
  T* op = static_cast<T*>(p.out);

  // query row -> (position index t, head h); rows past Sq carry position -1
  for (int row = tid; row < BQ; row += THREADS) {
    const int t = iq * tqp + row % tqp;
    sm.pos[row] = t < p.Sq ? p.positions[(long long)b * p.Sq + t] : -1;
  }
  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int row = idx / D, d = idx % D;
    const int t = iq * tqp + row % tqp;
    const int h = g * n_rep + row / tqp;
    sm.Qs[row * LD + d] = t < p.Sq ? to_float(qp[(((long long)b * p.Sq + t) * p.Hq + h) * D + d]) : 0.f;
  }
  __syncthreads();

  float l_i[ROWS_T], acc[ROWS_T][D / paged::CG];
  paged::attend<T, D>(sm, static_cast<const T*>(p.k), static_cast<const T*>(p.v),
                      p.block_table + (long long)b * p.MB, g, p.Hkv, p.bs, p.NB1, limit, p.scale,
                      l_i, acc);

  const int r = tid / paged::CG;
#pragma unroll
  for (int i = 0; i < ROWS_T; ++i) {
    const int lrow = r + RG * i;
    const int t = iq * tqp + lrow % tqp;
    if (t >= p.Sq) continue;
    const int h = g * n_rep + lrow / tqp;
    paged::finalize_row<T, D>(op + (((long long)b * p.Sq + t) * p.Hq + h) * D, l_i[i], acc[i]);
  }
}

template <typename T, int D>
cudaError_t launch(const PagedFlashParams& p, int B, cudaStream_t stream) {
  cudaError_t err = paged::allow_smem<D>(paged_flash_kernel<T, D>);
  if (err != cudaSuccess) return err;
  const int tqp = BQ / (p.Hq / p.Hkv);
  const dim3 grid((p.Sq + tqp - 1) / tqp, p.Hkv, B);
  paged_flash_kernel<T, D><<<grid, THREADS, paged::smem_bytes<D>(), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace nxdi

extern "C" int nxdi_paged_flash_attention(
    const void* q, const void* k, const void* v, const int* block_table,
    const int* positions, const int* kv_limit, void* out,
    int B, int Sq, int Hq, int Hkv, int D, int NB1, int bs, int MB,
    float scale, int dtype, void* stream) {
  using namespace nxdi;
  if (B <= 0 || Sq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || BQ % (Hq / Hkv) != 0 ||
      NB1 <= 0 || bs <= 0 || MB <= 0)
    return (int)cudaErrorInvalidValue;
  PagedFlashParams p{q, k, v, block_table, positions, kv_limit, out,
                     Sq, Hq, Hkv, NB1, bs, MB, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kFloat32 && D == 64) err = launch<float, 64>(p, B, st);
  else if (dtype == kFloat32 && D == 128) err = launch<float, 128>(p, B, st);
  else if (dtype == kBFloat16 && D == 64) err = launch_mma<64>(p, B, st);
  else if (dtype == kBFloat16 && D == 128) err = launch_mma<128>(p, B, st);
  return (int)err;
}
