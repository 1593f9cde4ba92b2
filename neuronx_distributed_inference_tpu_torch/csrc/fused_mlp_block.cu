// The fused decode MLP block for Hopper (sm_90a): kernel B9 of the port.
//
// Replaces the TPU kernel neuronx_distributed_inference_tpu/ops/
// decode_block.py::fused_mlp_block (_mlp_kernel).
//
// What it computes, for the rows r of x (B * K decode tokens, H wide):
//   n_r   = rmsnorm(x_r) * gamma, in fp32, rounded to the weight dtype once
//   a_r   = act(n_r @ Wg) * (n_r @ Wu)   (I values, fp32, rounded once)
//   out_r = x_r + a_r @ Wd               (fp32, rounded once to x's dtype)
// with Wg, Wu (H, I), Wd (I, H) and gamma (H,) in x's dtype (bf16 or fp32)
// and act silu or the tanh gelu. These are the Pallas kernel's roundings.
//
// What bounds it on an H100: each weight element is used by B * K rows (1
// to 16 at decode), so the block reads 3 H I weights for 6 B K H I FLOP, a
// few FLOP per byte against the card's ~295 FLOP/byte ridge: memory
// bandwidth bounds it. Llama-3.2-1B's MLP holds 100.7 MB of bf16 weights,
// 0.030 ms at 3.35 TB/s.
//
// Design: the Pallas kernel carried an fp32 (K, H) sum across a sequential
// grid axis over I tiles. Blocks on Hopper run in no order and nothing
// carries between them, so this is four launches from one entry (one B9
// launch), each product streaming its weight once (csrc/decode_gemv.cuh):
//   1. the rmsnorm of each row, rounded to the weight dtype;
//   2. gate/up: one block per 32 columns of I and up to 4 rows, both
//      weights' sums at once, storing act(g) u rounded to the weight dtype
//      into an (rows, I) scratch; Llama-3.2-1B runs 256 blocks;
//   3. down: one block per 32 columns of H, with I split over the grid's z
//      axis so that the card holds about two blocks an SM (4 splits of 2048
//      at 1B), each storing fp32 partial sums;
//   4. the residual: x + the partial sums added in split order, rounded once.
// Any H and I work (masked column edges, element loads where a row is not
// a multiple of 16 bytes). Tensor-core tiles, TMA staging and a persistent
// schedule are later steps.

#include "decode_gemv.cuh"

namespace nxdi {
namespace {

template <typename T>
cudaError_t mlp_launch(const T* x, const T* gamma, const T* wg, const T* wu, const T* wd, T* normed, T* act,
                       float* d_part, T* out, int rows, int H, int I, int s_down, int kps_down, int act_kind, int vec,
                       float eps, cudaStream_t st) {
  cudaError_t err = rmsnorm_rows<T>(x, gamma, normed, rows, H, eps, st);
  if (err != cudaSuccess) return err;
  err = gemv_launch<T, 2>(normed, wg, wu, H, I, rows, 1, H, vec, GluSink<T>{act, I, Glu{act_kind, 1.f, 0.f, 0.f, 0}},
                          st);
  if (err != cudaSuccess) return err;
  err = gemv_launch<T, 1>(act, wd, (const T*)nullptr, I, H, rows, s_down, kps_down, vec, PartialSink{d_part, rows, H},
                          st);
  if (err != cudaSuccess) return err;
  return residual_sum<T>(x, d_part, out, s_down, rows * H, st);
}

}  // namespace
}  // namespace nxdi

// x (rows, H), gamma (H,), w_gate / w_up (H, I), w_down (I, H), all in one
// dtype (0 fp32, 1 bf16) and contiguous; scratch normed (rows, H) and act
// (rows, I) in that dtype and d_part (s_down, rows, H) fp32; out (rows, H). act_kind 0 silu, 1 gelu
// (tanh). The down product's I axis is split s_down ways, kps_down rows
// each; vec = 1 allows 16-byte weight loads (rows of H and I a multiple of
// 16 bytes, 16-byte aligned weights). Four launches on the stream, one B9
// launch.
extern "C" int nxdi_fused_mlp_block(const void* x, const void* gamma, const void* w_gate, const void* w_up,
                                    const void* w_down, void* normed, void* act, void* d_part, void* out, int rows,
                                    int H, int I,
                                    int s_down, int kps_down, int dtype, int act_kind, int vec, float eps,
                                    void* stream) {
  using namespace nxdi;
  if (rows < 1 || H < 1 || I < 1 || s_down < 1 || kps_down < 1 || act_kind < 0 || act_kind > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dp = static_cast<float*>(d_part);
  if (dtype == kFloat32)
    return (int)mlp_launch<float>(static_cast<const float*>(x), static_cast<const float*>(gamma),
                                  static_cast<const float*>(w_gate), static_cast<const float*>(w_up),
                                  static_cast<const float*>(w_down), static_cast<float*>(normed),
                                  static_cast<float*>(act), dp,
                                  static_cast<float*>(out), rows, H, I, s_down, kps_down, act_kind, vec, eps, st);
  if (dtype == kBFloat16) {
    using B = __nv_bfloat16;
    return (int)mlp_launch<B>(static_cast<const B*>(x), static_cast<const B*>(gamma), static_cast<const B*>(w_gate),
                              static_cast<const B*>(w_up), static_cast<const B*>(w_down), static_cast<B*>(normed),
                              static_cast<B*>(act), dp,
                              static_cast<B*>(out), rows, H, I, s_down, kps_down, act_kind, vec, eps, st);
  }
  return (int)cudaErrorInvalidValue;
}
