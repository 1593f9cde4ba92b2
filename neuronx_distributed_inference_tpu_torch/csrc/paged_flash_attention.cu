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
// Design (the kv loop itself lives in paged_attention_tile.cuh, shared with
// the ragged kernel B3):
// - The TPU grid (B, Hq, q_tiles, MB) ran its kv axis in order; here the kv
//   loop lives inside the block. One block per (q tile, kv head, row): its
//   64 query rows are the n_rep q heads of kv head g times 64 / n_rep query
//   positions (row r = local head r / TQP, position iq * TQP + r % TQP), so
//   the n_rep heads share every K/V tile load and no repeat_kv exists.
// - The q tile. The session sends chunks of kernel_q_tile_size tokens (128
//   on the serving row). A block that held all 128 positions of the 4 heads
//   of a Llama-3.2-1B kv group would need 128 KB of fp32 Q in shared memory
//   and 128 accumulators per thread. The kernel takes 64 query rows a
//   block instead (16 positions x 4 heads at n_rep 4; 66.8 KB of shared
//   memory at D = 64, three blocks per SM), so a 128-token chunk runs 8
//   blocks per (row, kv head): 512 blocks at batch 8.
// - It stops early: the kv loop ends at min(the block's largest query
//   position, kv_limit - 1). A row with kv_limit == 0 (an inactive slot of
//   a chunk pass, which runs at the session's full batch with a zero block
//   table) writes zeros and exits at once.
// - Reads through the block table: position s of kv head g lives in block
//   blk = block_table[b, s / bs] of the head-major (NB+1, Hkv, bs, D) layer
//   at ((blk * Hkv + g) * bs + s % bs) * D. The kernel reads the table
//   itself (the TPU kernel had it as scalar prefetch). Positions at or past
//   kv_limit, and block 0 (the garbage block, which the fault tests fill
//   with NaN) load as zeros, so a masked probability (exactly 0) never
//   multiplies a NaN.
//
// What bounds it on an H100: a 128-token chunk over a context of S keys
// does ~4 * D * Hq * 128 * S FLOP for ~2 * S * Hkv * D * bytes of K/V and
// 2 * 128 * Hq * D * bytes of q/out; at S = 256, D = 64, Hq 32 / Hkv 8 in
// bf16 that is ~268 MFLOP per row against ~1.3 MB: ~200 FLOP/byte, under
// the ~295 FLOP/byte ridge, so at the roofline memory bounds it with the
// tensor-core rate close behind. This first version does its products with
// fp32 FMAs on the CUDA cores (about 1/15 of the bf16 tensor-core rate), so
// it is compute bound far above that bound; mma.sync / wgmma tiles are a
// later step, as for B2.
//
// Layout: q (B, Sq, Hq, D) contiguous; k/v one layer (NB+1, Hkv, bs, D)
// contiguous; block_table (B, MB) int32; positions (B, Sq) int32;
// kv_limit (B,) int32; out (B, Sq, Hq, D) contiguous.

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
  else if (dtype == kBFloat16 && D == 64) err = launch<__nv_bfloat16, 64>(p, B, st);
  else if (dtype == kBFloat16 && D == 128) err = launch<__nv_bfloat16, 128>(p, B, st);
  return (int)err;
}
