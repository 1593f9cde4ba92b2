// The staged K / V tiles of the decode kernels' split template, shared by
// B1 / B4 (decode_attention.cu split_kernel) and B3's decode tiles
// (ragged_paged_attention.cu decode_tile), over a cache of bf16 / fp32 or
// of 1-byte int8 / fp8 codes.
//
// A tile holds up to TILE positions of one kv head: one position's D values
// a row, padded by 16 bytes (code rows 80 or 144 bytes apart: the 16-byte
// reads of a quarter warp hit distinct banks). A 16-byte chunk is 16 codes
// (8 bf16, 4 fp32) of one position, so a paged kernel fetches each chunk
// through its block's table entry and zero-fills block 0's. Codes become
// fp32 in registers (Vec16 / to_float: int8 exactly; e4m3 / e5m2 through
// half precision, also exactly); statistics and accumulators stay fp32.
// No dequantized cache is written anywhere: a code mode reads the layer's
// scales on the device (common.cuh dequant_factor) and puts K's factor on
// the score scale and V's on the finalized output.
#pragma once

#include "common.cuh"

namespace nxdi {
namespace kv {

constexpr int TILE = 64;  // positions per staged tile

template <typename C, int D>
struct Row {
  static constexpr int LD = D + 16 / (int)sizeof(C);  // elements per staged row
  static constexpr int EV = Vec16<C>::N;              // elements per 16-byte chunk
  static constexpr int VPR = D / EV;                  // chunks per position
  static constexpr int KV = TILE * LD;                // one K or V tile
};

// Copy a tile's positions [0, n) into Ks / Vs by 16-byte cp.async, the
// `nthreads` threads of the block in turn, and commit them as one group.
// offset(c, e): the element offset of chunk e (its first element) of
// position c in both caches, or -1 for a chunk that is zero-filled and
// never read (block 0, an id outside the pool).
template <typename C, int D, class Offset>
__device__ __forceinline__ void stage_tile(C* Ks, C* Vs, const C* kc, const C* vc, int n, Offset offset, int tid,
                                           int nthreads) {
  using R = Row<C, D>;
  for (int i = tid; i < n * R::VPR; i += nthreads) {
    const int c = i / R::VPR, e = (i % R::VPR) * R::EV;
    const long long off = offset(c, e);
    const bool full = off >= 0;
    cp_async16(Ks + c * R::LD + e, kc + (full ? off : 0), full);
    cp_async16(Vs + c * R::LD + e, vc + (full ? off : 0), full);
  }
  cp_async_commit();
}

// One staged tile of n <= TILE positions for the query rows warp w owns:
// rows w + WARPS i (i < nrw <= RW), each D values of T at Qs + row * D.
// Lane c scores positions c and c + 32 (score_scale on the raw Q.K^T, the
// K factor folded into it); each row's online softmax updates (m, l) and
// shrinks acc; the probabilities go through the warp's rows of Pw (RW x
// TILE floats) into P.V, lane c holding output dims c D/32 .. c D/32 +
// D/32 - 1 of each row. ok(i, c): whether row i may attend position c.
template <typename T, typename C, int D, int RW, int WARPS, class Ok>
__device__ __forceinline__ void tile_rows(const T* Qs, const C* Ks, const C* Vs, int n, int nrw, float score_scale,
                                          Ok ok, float* Pw, float (&m_r)[RW], float (&l_r)[RW],
                                          float (&acc)[RW][D / 32]) {
  using R = Row<C, D>;
  constexpr int LD = R::LD;
  constexpr int EV = R::EV;
  constexpr int DPL = D / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool two = n > 32;  // positions lane + 32 in use (warp-uniform)
  float dot[RW][2];
#pragma unroll
  for (int i = 0; i < RW; ++i) dot[i][0] = dot[i][1] = 0.f;
#pragma unroll 2
  for (int e = 0; e < D; e += EV) {
    float k0[EV], k1[EV];
    Vec16<C>::unpack(*reinterpret_cast<const uint4*>(Ks + lane * LD + e), k0);
    Vec16<C>::unpack(*reinterpret_cast<const uint4*>(Ks + (two ? lane + 32 : lane) * LD + e), k1);
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      if (i < nrw) {
        float qv[EV];
        load_floats<T, EV>(Qs + (warp + WARPS * i) * D + e, qv);
#pragma unroll
        for (int u = 0; u < EV; ++u) {
          dot[i][0] = fmaf(qv[u], k0[u], dot[i][0]);
          dot[i][1] = fmaf(qv[u], k1[u], dot[i][1]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    if (i < nrw) {
      const bool ok0 = lane < n && ok(i, lane);
      const bool ok1 = lane + 32 < n && ok(i, lane + 32);
      const float sa = ok0 ? dot[i][0] * score_scale : NEG_INF;
      const float sb = ok1 ? dot[i][1] * score_scale : NEG_INF;
      const float m_new = fmaxf(m_r[i], group_max<32>(fmaxf(sa, sb)));
      const float pa = ok0 ? expf(sa - m_new) : 0.f;
      const float pb = ok1 ? expf(sb - m_new) : 0.f;
      const float alpha = expf(m_r[i] - m_new);
      l_r[i] = l_r[i] * alpha + group_sum<32>(pa + pb);
      m_r[i] = m_new;
#pragma unroll
      for (int k = 0; k < DPL; ++k) acc[i][k] *= alpha;
      Pw[i * TILE + lane] = pa;
      Pw[i * TILE + lane + 32] = pb;
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
        const float pr = Pw[i * TILE + c];
#pragma unroll
        for (int k = 0; k < DPL; ++k) acc[i][k] = fmaf(pr, vv[k], acc[i][k]);
      }
    }
  }
}

}  // namespace kv
}  // namespace nxdi
