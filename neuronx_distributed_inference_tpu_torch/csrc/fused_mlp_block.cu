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
// What bounds it on an H100: each weight element is used by the B * K rows,
// so the block reads 3 H I weights for 6 B K H I FLOP, a few FLOP per byte
// against the card's ~295 FLOP/byte ridge: memory bandwidth bounds it.
// Llama-3.2-1B's MLP holds 100.7 MB of bf16 weights, 0.030 ms at 3.35 TB/s;
// the design's aim is to read each weight once, at any row count up to 64,
// with enough bytes in flight to stream at the card's rate.
//
// Design: the Pallas kernel carried an fp32 (K, H) sum across a sequential
// grid axis over I tiles. Blocks on Hopper run in no order and nothing
// carries between them, so this is two grid launches from one entry (one B9
// launch) on the product loop of csrc/decode_gemv.cuh, joined by
// programmatic dependent launch (common.cuh):
//   a. gate/up (GV_NORM | GV_TRIGGER): both weights at once, a block per
//      128 columns of I and split of H (gemv_split: 64 tiles x 4 splits of
//      512 at 1B). Each block computes its rows' rmsnorm itself and stages
//      the normed input rounded to the weight dtype (x and gamma's range in
//      one group of copies ahead of its weight stages, where they fit). The
//      blocks store fp32 partial sums of gate and of up; the last split
//      block of a column tile (a completion counter, GluSplitSink) adds
//      each in split order, applies the activation and rounds act(g) u
//      once. It lets (b) start at once.
//   b. down (GV_WAIT): a block per 128 columns of H and split of I (16
//      tiles x 16 splits of 512 at 1B); it issues its first weight stages
//      before it waits for (a), then stages act. The last split block of a
//      column tile adds x and the partials in split order and rounds once
//      (ResidualSink). Prefetching the rest of its tile into L2 before the
//      wait measured slower at every timed point: it crowds the reads that
//      (a)'s last blocks wait on (scripts/torch_attention_variants.py b9).
// bf16 rows past 2 run on the tensor cores; the rows live in the block, so
// every weight is read once for up to 64 rows. The counters return to 0 in
// the block that finishes, so a call needs no host reset. No atomics in any
// sum: every sum runs in a fixed order, so greedy tokens repeat.

#include "decode_gemv.cuh"

namespace nxdi {
namespace {

// the down product's sink: ResidualSink under a name of its own, so that a
// profile tells B9's down launch from B8's o-proj
template <typename T>
struct DownSink : ResidualSink<T> {};

template <typename T>
cudaError_t mlp_launch(const T* x, const T* gamma, const T* wg, const T* wu, const T* wd, float* gu_part, T* act,
                       float* d_part, unsigned* counters, T* out, int rows, int H, int I, int s_gu, int kps_gu,
                       int s_down, int kps_down, int act_kind, float eps, cudaStream_t st) {
  const GemvArgs<T> gu{x, wg, wu, gamma, eps, H, I, rows, kps_gu, 0, 0, 0};
  cudaError_t err = gemv_launch<T, 2, GluSplitSink<T>, GV_NORM | GV_TRIGGER>(
      gu, s_gu, GluSplitSink<T>{gu_part, act, counters, rows, I, Glu{act_kind, 1.f, 0.f, 0.f, 0}}, st);
  if (err != cudaSuccess) return err;
  const GemvArgs<T> dn{act, wd, nullptr, nullptr, 0.f, I, H, rows, kps_down, 0, 0, 0};
  unsigned* d_counters = counters + (I + GV_COLS - 1) / GV_COLS;
  return gemv_launch<T, 1, DownSink<T>, GV_WAIT>(
      dn, s_down, DownSink<T>{{d_part, x, out, d_counters, rows, H}}, st);
}

}  // namespace
}  // namespace nxdi

// x (rows, H), gamma (H,), w_gate / w_up (H, I), w_down (I, H), all in one
// dtype (0 fp32, 1 bf16) and contiguous; out (rows, H). act_kind 0 silu, 1
// gelu (tanh). The gate/up product splits H s_gu ways (kps_gu rows each),
// the down product I s_down ways (kps_down each), both a multiple of 64.
// Scratch: gu_part (2, s_gu, rows, I) and d_part (s_down, rows, H) fp32, act
// (rows, I) in x's dtype, 16-byte aligned; counters: one per 128 columns of
// I, then one per 128 columns of H, zero on entry and left zero. Two
// launches on the stream, one B9 launch.
extern "C" int nxdi_fused_mlp_block(const void* x, const void* gamma, const void* w_gate, const void* w_up,
                                    const void* w_down, void* gu_part, void* act, void* d_part, void* counters,
                                    void* out, int rows, int H, int I, int s_gu, int kps_gu, int s_down, int kps_down,
                                    int dtype, int act_kind, float eps, void* stream) {
  using namespace nxdi;
  if (rows < 1 || H < 1 || I < 1 || act_kind < 0 || act_kind > 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* gp = static_cast<float*>(gu_part);
  float* dp = static_cast<float*>(d_part);
  unsigned* cnt = static_cast<unsigned*>(counters);
  if (dtype == kFloat32)
    return (int)mlp_launch<float>(static_cast<const float*>(x), static_cast<const float*>(gamma),
                                  static_cast<const float*>(w_gate), static_cast<const float*>(w_up),
                                  static_cast<const float*>(w_down), gp, static_cast<float*>(act), dp, cnt,
                                  static_cast<float*>(out), rows, H, I, s_gu, kps_gu, s_down, kps_down, act_kind, eps,
                                  st);
  if (dtype == kBFloat16) {
    using B = __nv_bfloat16;
    return (int)mlp_launch<B>(static_cast<const B*>(x), static_cast<const B*>(gamma), static_cast<const B*>(w_gate),
                              static_cast<const B*>(w_up), static_cast<const B*>(w_down), gp, static_cast<B*>(act),
                              dp, cnt, static_cast<B*>(out), rows, H, I, s_gu, kps_gu, s_down, kps_down, act_kind,
                              eps, st);
  }
  return (int)cudaErrorInvalidValue;
}
