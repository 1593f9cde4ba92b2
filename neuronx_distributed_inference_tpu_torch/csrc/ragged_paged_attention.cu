// Ragged paged attention on Hopper (sm_90a): kernel B3 of the port.
//
// Replaces the TPU kernel neuronx_distributed_inference_tpu/ops/
// ragged_paged_attention.py::ragged_paged_attention (_ragged_kernel) for
// bf16/fp32 caches.
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
// Design:
// - One block per (q tile of 16 slots, kv head g, head group). Its 64 query
//   rows are the 16 slots times up to 4 q heads of kv head g (HG heads, the
//   largest divisor of n_rep that is <= 4); they share every K/V tile load,
//   so repeat_kv never exists. At the Llama-3.2-1B shape (n_rep 4) a block
//   holds all four heads of its kv head, the same block shape as B5's. n_rep
//   8 runs two head groups, each loading the tile's K/V; n_rep 1 and 2 leave
//   48 and 32 of the 64 rows empty.
// - The row of a tile: the block scans the R descriptors itself (R is the
//   session's slot count, a few dozen at most) for the row whose segment
//   holds the tile's first slot. The TPU wrapper built tile_row / tile_max
//   tensors for its scalar prefetch in every layer; the serving step is
//   host-bound at ~1000 launches a step, and the descriptors are the same in
//   all layers, so no tensor is built per launch here.
// - The kv loop (paged_attention_tile.cuh, shared with B5) stops at
//   min(the tile's largest q_pos, ctx_len[r] - 1) and reads
//   block_table[r, s / bs] in the kernel; block 0, any id outside [1, NB]
//   and any position >= ctx_len[r] load as zeros (the fault tests fill block
//   0 with NaN, and 0 * NaN is NaN). A tile of no row, or of rows past
//   their row_len, runs no kv tile and writes zeros.
//
// What bounds it on an H100: K/V bytes. The serving row's mixed step (one
// 128-token chunk from 0 and 7 decode rows 192 deep; Hq 32, Hkv 8, D 64,
// bf16) moves ~5.0 MB of q, out and K/V for ~79 MFLOP, ~16 FLOP/byte, far
// under the ~295 FLOP/byte ridge (ops/roofline.py, RAGGED_POINTS). This
// first version runs its products as fp32 FMAs on the CUDA cores and gives
// each decode row a whole 16-slot tile (1 of 16 slots live), so its time is
// latency and wasted lanes, not bytes; tensor-core tiles and a decode-row
// packing are later steps.
//
// Layout: q (T, Hq, D) contiguous; k/v one layer (NB+1, Hkv, bs, D)
// contiguous; block_table (R, MB) int32; row_start, row_len, ctx_len (R,)
// int32; out (T, Hq, D) contiguous.

#include "paged_attention_tile.cuh"

namespace nxdi {
namespace {

using paged::BQ;
using paged::RG;
using paged::ROWS_T;
using paged::THREADS;

constexpr int Q_TILE = 16;  // packed slots per tile (the reference's RAGGED_Q_TILE)

struct RaggedParams {
  const void* q;
  const void* k;
  const void* v;
  const int* block_table;
  const int* row_start;
  const int* row_len;
  const int* ctx_len;
  void* out;
  int R, Hq, Hkv, HG, NB1, bs, MB;
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) ragged_paged_kernel(const RaggedParams p) {
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  const paged::Smem<D> sm(smem);
  __shared__ int owner;

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * Q_TILE;  // the tile's first packed slot
  const int g = blockIdx.y;
  const int h0 = g * (p.Hq / p.Hkv) + blockIdx.z * p.HG;  // the block's first q head
  const T* qp = static_cast<const T*>(p.q);
  T* op = static_cast<T*>(p.out);

  // the tile's row: the first active row whose segment holds slot t0
  if (tid == 0) owner = p.R;
  __syncthreads();
  for (int r = tid; r < p.R; r += THREADS) {
    const int rs = p.row_start[r], rl = p.row_len[r];
    if (rl > 0 && rs <= t0 && t0 < rs + rl) atomicMin(&owner, r);
  }
  __syncthreads();
  const int row = owner;
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
  paged::attend<T, D>(sm, static_cast<const T*>(p.k), static_cast<const T*>(p.v),
                      p.block_table + (long long)(has ? row : 0) * p.MB, g, p.Hkv, p.bs, p.NB1,
                      limit, p.scale, l_i, acc);

  // thread (r, c) holds the rows r + RG * i: slot r of the tile, local head i
  const int r = tid / paged::CG;
#pragma unroll
  for (int i = 0; i < ROWS_T; ++i) {
    const int qr = r + RG * i;
    const int lh = qr / Q_TILE;
    if (lh >= p.HG) continue;
    paged::finalize_row<T, D>(op + ((long long)(t0 + qr % Q_TILE) * p.Hq + h0 + lh) * D, l_i[i], acc[i]);
  }
}

static_assert(RG == Q_TILE, "a thread's rows must be one slot's heads");

template <typename T, int D>
cudaError_t launch(const RaggedParams& p, int T_slots, cudaStream_t stream) {
  cudaError_t err = paged::allow_smem<D>(ragged_paged_kernel<T, D>);
  if (err != cudaSuccess) return err;
  const dim3 grid(T_slots / Q_TILE, p.Hkv, (p.Hq / p.Hkv) / p.HG);
  ragged_paged_kernel<T, D><<<grid, THREADS, paged::smem_bytes<D>(), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace nxdi

extern "C" int nxdi_ragged_paged_attention(
    const void* q, const void* k, const void* v, const int* block_table,
    const int* row_start, const int* row_len, const int* ctx_len, void* out,
    int T, int R, int Hq, int Hkv, int HG, int D, int NB1, int bs, int MB,
    float scale, int dtype, void* stream) {
  using namespace nxdi;
  if (T <= 0 || T % Q_TILE != 0 || R <= 0 || Hkv <= 0 || Hq % Hkv != 0 || HG <= 0 ||
      (Hq / Hkv) % HG != 0 || HG * Q_TILE > BQ || NB1 <= 0 || bs <= 0 || MB <= 0)
    return (int)cudaErrorInvalidValue;
  RaggedParams p{q, k, v, block_table, row_start, row_len, ctx_len, out,
                 R, Hq, Hkv, HG, NB1, bs, MB, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kFloat32 && D == 64) err = launch<float, 64>(p, T, st);
  else if (dtype == kFloat32 && D == 128) err = launch<float, 128>(p, T, st);
  else if (dtype == kBFloat16 && D == 64) err = launch<__nv_bfloat16, 64>(p, T, st);
  else if (dtype == kBFloat16 && D == 128) err = launch<__nv_bfloat16, 128>(p, T, st);
  return (int)err;
}
