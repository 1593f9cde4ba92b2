// Tensor-core helpers shared by the port's bf16 kernels on mma.sync tiles:
// prefill flash attention (B2, flash_attention.cu), paged flash prefill (B5,
// paged_flash_attention.cu) and the int4 fused-dequant matmul (B6,
// quant_matmul.cu).
//
// Fragment layouts of mma.sync.m16n8k16 (bf16 in, fp32 accumulate), for lane
// (g, t) = (lane / 4, lane % 4):
//   A (16 x 16, row): a0 = (row g, k 2t..2t+1), a1 = (row g + 8, k 2t..),
//     a2 = (row g, k 2t + 8..), a3 = (row g + 8, k 2t + 8..);
//   B (16 x 8, col): b0 = (k 2t..2t+1, col g), b1 = (k 2t + 8.., col g);
//   C (16 x 8): c0, c1 = (row g, cols 2t, 2t + 1), c2, c3 = (row g + 8, ...).
// Each 32-bit register holds two bf16, the lower k (or column) in the low
// half.
#pragma once

#include "common.cuh"

namespace nxdi {

constexpr float LOG2E = 1.4426950408889634f;  // exp(x) = exp2(x log2 e)

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, MUFU.EX2 (2 ulp; denormal results flush to 0)
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One online-softmax step over a warp's 16 x 8 NT score tile s (raw Q K^T,
// unscaled) for rows g and g + 8. MASKED: bit 4 n + e of ok_bits says
// whether element (n, e) is allowed; else the whole tile is. Leaves the
// probabilities in s (exactly 0 where masked), updates the rows' max m
// (of the scaled scores, as the reference's) and sum l (of the fp32
// probabilities), and returns the factor alpha by which the rows' earlier
// accumulators shrink. SOFTMAX_BF16 rounds the exp input and output to bf16
// (the packed flash kernel's mode).
template <bool MASKED, bool SOFTMAX_BF16, int NT>
__device__ __forceinline__ void softmax_step(float (&s)[NT][4], uint32_t ok_bits, float scale, float (&m_i)[2],
                                             float (&l_i)[2], float (&alpha)[2]) {
  auto ok = [&](int n, int e) { return !MASKED || ((ok_bits >> (n * 4 + e)) & 1u); };
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], ok(n, e) ? s[n][e] : NEG_INF);
  float m2[2];  // the new max, times log2 e
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    mx[rr] = group_max<4>(mx[rr]);
    // max(scale * s) = scale * max(s): the fp32 product is monotonic
    const float m_new = fmaxf(m_i[rr], mx[rr] > NEG_INF ? mx[rr] * scale : NEG_INF);
    alpha[rr] = ex2((m_i[rr] - m_new) * LOG2E);
    m_i[rr] = m_new;
    m2[rr] = m_new * LOG2E;
  }
  const float scale2 = scale * LOG2E;
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float pr;
      if (SOFTMAX_BF16) {
        // the packed kernel's bf16 mode: exp input and output rounded
        pr = round_bf16(ex2(round_bf16(s[n][e] * scale - m_i[e >> 1]) * LOG2E));
      } else {
        pr = ex2(fmaf(s[n][e], scale2, -m2[e >> 1]));  // e^(scale s - m)
      }
      s[n][e] = ok(n, e) ? pr : 0.f;
      sum[e >> 1] += s[n][e];
    }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) l_i[rr] = l_i[rr] * alpha[rr] + group_sum<4>(sum[rr]);
}

}  // namespace nxdi
