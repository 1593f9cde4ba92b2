// int4 fused-dequant matmul for Hopper (sm_90a): kernel B6 of the port.
//
// Replaces the TPU kernel neuronx_distributed_inference_tpu/ops/
// quant_matmul.py::quant_matmul (_qmm_kernel).
//
// What it computes: out (rows, N) = x (rows, K) @ dequant(packed, scale),
// rows 1..64, x bf16 or fp32, out in x's dtype, every sum in fp32.
//   packed: uint8 (Kp/2, N), N-contiguous, midpoint split: byte row j holds
//     code k = j in its low nibble and k = Kp/2 + j in its high nibble; a
//     code is q + 8 (0x88 is the zero pad). Kp is a multiple of 256.
//   scale: fp32 (Kp/128, N); groups 0 .. Kp/256 - 1 cover the low plane,
//     the rest the high plane.
// For each group of 128 k, the partial dot over the codes (q = code - 8)
// is multiplied by that group's scale AFTER the dot, as the TPU kernel
// does. The dequantized matrix never exists in memory, and the weights are
// read in the layout they are stored in (no repacked copy). x reads as zero
// past K, so the pad rows of a K that is not a multiple of 256 add nothing.
//
// What bounds it on an H100: at decode row counts it reads 0.5 byte of
// codes and 1/32 byte of scale per weight for 2 * rows FLOP, a few FLOP per
// byte, far below the card's ~295 FLOP/byte ridge: memory bandwidth bounds
// it (the 8B down projection at 1 row moves 31.2 MB, 0.0093 ms at
// 3.35 TB/s). The first version reached 9% of that: one block per 128 columns
// walked all of K (32 blocks on 132 SMs at N = 4096), each lane kept 16
// four-byte words in flight (~0.5 MB across the card, where ~3 MB is
// needed at ~1 us of latency), and at 8 rows its fp32 FMAs on 16 SMs took
// longer than the loads.
//
// Design:
//   - Split K over blocks. The group pairs (pair g = byte rows [128 g,
//     128 g + 128): low-plane group g and high-plane group Kp/256 + g) are
//     cut into `splits` contiguous ranges of `per_split` pairs, one per
//     grid z; ops/quant_matmul.py::quant_matmul_split picks the count from
//     the shapes and the SM count alone: enough splits for ~2 blocks an SM
//     (1, 4 or 8 ran slower at most timed shapes), one split once the
//     column and row tiles fill the card. At one row: 8B down 8 splits of 7
//     pairs (256 blocks), o 8 of 2 (256), qkv 6 of 3 (288), gate / up 3 of
//     6 (336), lm head 1 (1002 blocks); at the 1B widths and 8 rows: down
//     16 of 2 (256), o 8 of 1 (128), qkv 8 of 1 (192), gate / up 4 of 2
//     (256), lm head 1 (1002). Each block of a split writes its fp32
//     partial (rows, 128) to scratch (splits, rows, N); a second launch
//     from the same entry sums the partials in split order and casts. No
//     float atomics: results repeat bit for bit.
//   - Bytes in flight: a block's codes arrive by 16-byte cp.async along N
//     into QMM_STAGES shared stages of one group pair each (128 byte rows x
//     128 columns, 16 KB), the next pairs in flight while this one is
//     computed, one barrier a pair.
//   - bf16 activations: both planes' products on the tensor cores,
//     mma.sync m16n8k16 bf16 -> fp32 (mma.cuh), at every row count. x is the
//     A operand: 16 or 32 rows a block (rows past `rows` are zero-filled by
//     cp.async, never read), staged beside the codes with the pair's low
//     (x[:, 128 g ..]) and high (x[:, Kp/2 + 128 g ..]) columns. The codes
//     are the B operand, built per thread from shared memory: a 32-bit word
//     of one byte row holds 4 columns, and two k-adjacent words give, per
//     column, one low-plane and one high-plane bf16 pair (prmt + lop3 to
//     0x4300 | nibble = 128 + code, then one bf16x2 subtract of 136). So the
//     B fragment's column g of n tile t is column 4 g + t of the warp's 32,
//     and a thread's accumulators land on 8 adjacent columns. code - 8 in
//     [-8, 7] and bf16 x are exact in bf16, so every product is exact and only
//     the order of the fp32 sums differs from the plain version. Each group's
//     accumulator is scaled after its 8 k-steps. The FMA body below ran
//     1.4-2.1x slower at 1 bf16 row on an H100, so bf16 takes this body at
//     every row count.
//     What bounds this body there is instruction issue, not DRAM: a k16
//     step costs ~60 instructions a warp (the code conversion) for 8 mma,
//     and 8B down runs 17 us with its 31 MB already in L2 (bound 9.3 us).
//   - fp32 activations (the parity checks only): the first version's FMA
//     body under the same split: 8 warps share a block's pairs, lane l
//     owns 4 columns, a code becomes a float as as_float(0x4B000000 |
//     nibble) - (2^23 + 8), the warps' totals are reduced in warp order.
//     TF32 products would break the fp32 parity bound.
//
// Layout: x (rows, K) contiguous; packed (k_half, N) uint8 contiguous,
// k_half = Kp / 2 a multiple of 128; scale (Kp / 128, N) fp32 contiguous;
// out (rows, N) contiguous in x's dtype; partial (splits, rows, N) fp32
// when splits > 1. 16-byte copies need N % 16 == 0 (codes) and K % 8 == 0
// (bf16 x) with 16-byte aligned bases; other layouts are staged by plain
// loads.

#include <stdint.h>

#include "mma.cuh"

namespace nxdi {
namespace {

constexpr int QMM_COLS = 128;   // columns per block
constexpr int QMM_GROUP = 128;  // k per scale group = byte rows per group pair
constexpr int QMM_MAX_ROWS = 64;

struct QmmParams {
  const void* x;
  const uint8_t* packed;
  const float* scale;
  void* out;
  float* partial;  // (splits, rows, N) when splits > 1
  int rows, K, k_half, N, pairs, splits, per_split;
};

// value of (row, n) from split z: the output itself with one split, else
// the split's fp32 partial
template <typename T>
__device__ __forceinline__ void store_result(const QmmParams& p, int z, int row, int n, float v) {
  if (p.splits == 1)
    static_cast<T*>(p.out)[(size_t)row * p.N + n] = from_float<T>(v);
  else
    p.partial[((size_t)z * p.rows + row) * p.N + n] = v;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 4;  // each owns 32 of the block's 128 columns
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int CLD = QMM_COLS + 16;      // code bytes per shared row (16 of padding)
constexpr int XLD = 2 * QMM_GROUP + 8;  // bf16 per shared x row: low, high, 16 bytes of padding

constexpr int QMM_STAGES = 3;  // group pairs in shared memory: one computed, the rest in flight

template <int MT>
struct TcTile {
  static constexpr int ROWS = 16 * MT;              // x rows per block
  static constexpr int CODES = QMM_GROUP * CLD;     // bytes of one code stage
  static constexpr int XS = ROWS * XLD;             // bf16 of one x stage
  static constexpr size_t smem = QMM_STAGES * ((size_t)CODES + sizeof(__nv_bfloat16) * (size_t)XS);
};

// Byte t of wa and byte t of wb (two k-adjacent byte rows of one column) as
// the bf16 pairs (lo nibble of wa, lo of wb) and (hi of wa, hi of wb), each
// value code - 8, exactly.
template <int BYTE>
__device__ __forceinline__ void nibble_pairs(uint32_t wa, uint32_t wb, uint32_t& lo, uint32_t& hi) {
  const uint32_t v = __byte_perm(wa, wb, BYTE | ((BYTE + 4) << 8));  // byte 0: wa's, byte 2: wb's
  const uint32_t l = (v & 0x000F000Fu) | 0x43004300u;           // bf16 128 + code
  const uint32_t h = ((v >> 4) & 0x000F000Fu) | 0x43004300u;
  const __nv_bfloat162 off = __floats2bfloat162_rn(136.f, 136.f);
  const __nv_bfloat162 lv = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&l), off);
  const __nv_bfloat162 hv = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&h), off);
  lo = *reinterpret_cast<const uint32_t*>(&lv);
  hi = *reinterpret_cast<const uint32_t*>(&hv);
}

template <int MT>
__global__ void __launch_bounds__(TC_THREADS) qmm_tc_kernel(const QmmParams p, int cvec, int xvec) {
  using bf16 = __nv_bfloat16;
  using Tile = TcTile<MT>;
  constexpr int ROWS = Tile::ROWS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* Cs = smem_raw;  // stage s at Cs + s CODES: (128 byte rows, CLD)
  bf16* Xs = reinterpret_cast<bf16*>(smem_raw + QMM_STAGES * Tile::CODES);  // stage s at Xs + s XS: (ROWS, XLD)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int n_blk = blockIdx.x * QMM_COLS;
  const int row0 = blockIdx.y * ROWS;
  const int z = blockIdx.z;
  const int p0 = z * p.per_split;
  const int p1 = min(p0 + p.per_split, p.pairs);
  const int N = p.N, K = p.K;
  const bf16* x = static_cast<const bf16*>(p.x);

  auto load_stage = [&](int gp, int stage) {
    uint8_t* cs = Cs + stage * Tile::CODES;
    const uint8_t* src = p.packed + (size_t)gp * QMM_GROUP * N + n_blk;
    if (cvec) {
      // 128 rows x 8 chunks of 16 bytes; columns past N are zero-filled
      // (their products land only in columns that are never written)
#pragma unroll
      for (int i = tid; i < QMM_GROUP * 8; i += TC_THREADS) {
        const int r = i / 8, c = (i % 8) * 16;
        const bool ok = n_blk + c < N;
        cp_async16(cs + r * CLD + c, ok ? src + (size_t)r * N + c : p.packed, ok);
      }
    } else {
      for (int i = tid; i < QMM_GROUP * QMM_COLS / 4; i += TC_THREADS) {
        const int r = i / (QMM_COLS / 4), c = (i % (QMM_COLS / 4)) * 4;
        uint32_t w = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n_blk + c + e < N) w |= (uint32_t)__ldg(src + (size_t)r * N + c + e) << (8 * e);
        *reinterpret_cast<uint32_t*>(cs + r * CLD + c) = w;
      }
    }
    bf16* xs = Xs + stage * Tile::XS;
    const int klo = gp * QMM_GROUP, khi = p.k_half + gp * QMM_GROUP;
    if (xvec) {
      // ROWS rows x 32 chunks of 8 bf16 (16 low, 16 high); rows past `rows`
      // and k past K are zero-filled, not read
#pragma unroll
      for (int i = tid; i < ROWS * 32; i += TC_THREADS) {
        const int r = i / 32, c = (i % 32) * 8;
        const int k = c < QMM_GROUP ? klo + c : khi + c - QMM_GROUP;
        const int row = row0 + r;
        const bool ok = row < p.rows && k < K;
        cp_async16(xs + r * XLD + c, ok ? x + (size_t)row * K + k : x, ok);
      }
    } else {
      for (int i = tid; i < ROWS * 2 * QMM_GROUP; i += TC_THREADS) {
        const int r = i / (2 * QMM_GROUP), c = i % (2 * QMM_GROUP);
        const int k = c < QMM_GROUP ? klo + c : khi + c - QMM_GROUP;
        const int row = row0 + r;
        xs[r * XLD + c] = row < p.rows && k < K ? x[(size_t)row * K + k] : __float2bfloat16(0.f);
      }
    }
    cp_async_commit();
  };

  // the warp's 32 columns; this thread's accumulators hold columns
  // nc .. nc + 7 (C column 2 t4 + e of n tile t is column 8 t4 + 4 e + t)
  const int wcol = warp * 32;
  const int nc = n_blk + wcol + 8 * t4;
  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[mt][t][0] = acc[mt][t][1] = acc[mt][t][2] = acc[mt][t][3] = 0.f;

  // the first QMM_STAGES - 1 pairs in flight (an empty group where the
  // split has fewer), so every iteration waits for the same group count
#pragma unroll
  for (int s = 0; s < QMM_STAGES - 1; ++s) {
    if (p0 + s < p1) load_stage(p0 + s, s);
    else cp_async_commit();
  }
  for (int gp = p0; gp < p1; ++gp) {
    const int stage = (gp - p0) % QMM_STAGES;
    // this pair's scales for the thread's 8 columns, issued before the wait
    float s_lo[8], s_hi[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const bool ok = nc + c < N;
      s_lo[c] = ok ? __ldg(p.scale + (size_t)gp * N + nc + c) : 0.f;
      s_hi[c] = ok ? __ldg(p.scale + (size_t)(p.pairs + gp) * N + nc + c) : 0.f;
    }
    cp_async_wait<QMM_STAGES - 2>();
    // this pair has landed, and every warp is done with the stage the last
    // iteration computed: refill it with the pair QMM_STAGES - 1 ahead
    __syncthreads();
    const int ahead = gp + QMM_STAGES - 1;
    if (ahead < p1) load_stage(ahead, (stage + QMM_STAGES - 1) % QMM_STAGES);
    else cp_async_commit();
    const uint8_t* cs = Cs + stage * Tile::CODES + wcol + 4 * g;
    const bf16* xs = Xs + stage * Tile::XS;

    float plo[MT][4][4], phi[MT][4][4];  // the pair's two groups' partial dots
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) plo[mt][t][i] = phi[mt][t][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < QMM_GROUP / 16; ++ks) {
      uint32_t alo[MT][4], ahi[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const bf16* xa = xs + (mt * 16 + (lane % 8) + 8 * ((lane / 8) % 2)) * XLD + ks * 16 + 8 * (lane / 16);
        ldmatrix_x4(alo[mt], xa);
        ldmatrix_x4(ahi[mt], xa + QMM_GROUP);
      }
      // byte rows 16 ks + 2 t4 (+1) and + 8 (+9): columns 4 g .. 4 g + 3
      const uint8_t* cr = cs + (ks * 16 + 2 * t4) * CLD;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(cr);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(cr + CLD);
      const uint32_t w2 = *reinterpret_cast<const uint32_t*>(cr + 8 * CLD);
      const uint32_t w3 = *reinterpret_cast<const uint32_t*>(cr + 9 * CLD);
      uint32_t blo[4][2], bhi[4][2];
      nibble_pairs<0>(w0, w1, blo[0][0], bhi[0][0]);
      nibble_pairs<0>(w2, w3, blo[0][1], bhi[0][1]);
      nibble_pairs<1>(w0, w1, blo[1][0], bhi[1][0]);
      nibble_pairs<1>(w2, w3, blo[1][1], bhi[1][1]);
      nibble_pairs<2>(w0, w1, blo[2][0], bhi[2][0]);
      nibble_pairs<2>(w2, w3, blo[2][1], bhi[2][1]);
      nibble_pairs<3>(w0, w1, blo[3][0], bhi[3][0]);
      nibble_pairs<3>(w2, w3, blo[3][1], bhi[3][1]);
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(plo[mt][t], alo[mt], blo[t][0], blo[t][1]);
          mma_bf16(phi[mt][t], ahi[mt], bhi[t][0], bhi[t][1]);
        }
    }
    // each group's partial dot times its scale
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = 4 * (i & 1) + t;
          acc[mt][t][i] = fmaf(phi[mt][t][i], s_hi[c], fmaf(plo[mt][t][i], s_lo[c], acc[mt][t][i]));
        }
  }
  cp_async_wait<0>();  // (the empty groups)

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + mt * 16 + g + 8 * (i >> 1);
      if (row >= p.rows) continue;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int n = nc + 4 * (i & 1) + t;
        if (n < N) store_result<bf16>(p, z, row, n, acc[mt][t][i]);
      }
    }
}

template <int MT>
cudaError_t tc_launch(const QmmParams& p, int cvec, int xvec, cudaStream_t stream) {
  constexpr size_t smem = TcTile<MT>::smem;
  const cudaError_t err =
      cudaFuncSetAttribute(qmm_tc_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + QMM_COLS - 1) / QMM_COLS, (p.rows + TcTile<MT>::ROWS - 1) / TcTile<MT>::ROWS, p.splits);
  qmm_tc_kernel<MT><<<grid, TC_THREADS, smem, stream>>>(p, cvec, xvec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int FMA_THREADS = 256;
constexpr int FMA_WARPS = FMA_THREADS / 32;
constexpr int FMA_INFLIGHT = 16;  // code words a lane loads before using them

template <int RT>
__host__ __device__ constexpr size_t fma_smem_bytes() {
  // x staging, per warp RT x 128 float2; the reduction (per warp RT x 128
  // floats) reuses the space once every warp is done with x
  return (size_t)FMA_WARPS * RT * QMM_GROUP * sizeof(float2);
}

// nibble (0..15) -> nibble - 8 as a float, exactly
__device__ __forceinline__ float code_value(uint32_t nibble) {
  return __int_as_float(0x4B000000u | nibble) - 8388616.0f;
}

// the 4 code bytes of columns n0 .. n0 + 3 in one byte row; columns past N
// read as the zero pad 0x88
__device__ __forceinline__ uint32_t load_codes(const uint8_t* p, int n0, int N, int vec) {
  if (vec && n0 + 3 < N) return __ldg(reinterpret_cast<const uint32_t*>(p));
  uint32_t w = 0x88888888u;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (n0 + c < N) w = (w & ~(0xFFu << (8 * c))) | ((uint32_t)__ldg(p + c) << (8 * c));
  }
  return w;
}

// A block (8 warps) owns 128 columns (lane l: columns 4 l .. 4 l + 3, one
// 32-bit code word per byte row) and a tile of RT rows; its warps take the
// pairs p0 + w, p0 + w + 8, ... of its split.
template <typename T, int RT>
__global__ void __launch_bounds__(FMA_THREADS) qmm_fma_kernel(const QmmParams p, int vec) {
  extern __shared__ float2 qmm_smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.y * RT;
  const int n0 = blockIdx.x * QMM_COLS + lane * 4;
  const int z = blockIdx.z;
  const int p0 = z * p.per_split;
  const int p1 = min(p0 + p.per_split, p.pairs);
  const int N = p.N, K = p.K, k_half = p.k_half;
  const T* x = static_cast<const T*>(p.x);
  float2* xs = qmm_smem + (size_t)warp * RT * QMM_GROUP;

  float acc[RT][4];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int g = p0 + warp; g < p1; g += FMA_WARPS) {
    const int j0 = g * QMM_GROUP;
    // stage this pair's x: (x[row][j0 + j], x[row][k_half + j0 + j])
    __syncwarp();
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int row = row0 + r;
#pragma unroll
      for (int i = 0; i < QMM_GROUP / 32; ++i) {
        const int j = lane + 32 * i;
        const int klo = j0 + j;
        const int khi = k_half + j0 + j;
        float lo = 0.f, hi = 0.f;
        if (row < p.rows) {
          const T* xr = x + (size_t)row * K;
          if (klo < K) lo = to_float(xr[klo]);
          if (khi < K) hi = to_float(xr[khi]);
        }
        xs[r * QMM_GROUP + j] = make_float2(lo, hi);
      }
    }
    __syncwarp();

    float plo[RT][4], phi[RT][4];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) plo[r][c] = phi[r][c] = 0.f;

    const uint8_t* pg = p.packed + (size_t)j0 * N + n0;
    for (int jb = 0; jb < QMM_GROUP; jb += FMA_INFLIGHT) {
      uint32_t words[FMA_INFLIGHT];
#pragma unroll
      for (int u = 0; u < FMA_INFLIGHT; ++u)
        words[u] = load_codes(pg + (size_t)(jb + u) * N, n0, N, vec);
#pragma unroll
      for (int u = 0; u < FMA_INFLIGHT; ++u) {
        const uint32_t lo4 = words[u] & 0x0F0F0F0Fu;
        const uint32_t hi4 = (words[u] >> 4) & 0x0F0F0F0Fu;
        float cl[4], ch[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          cl[c] = code_value((lo4 >> (8 * c)) & 0xFFu);
          ch[c] = code_value((hi4 >> (8 * c)) & 0xFFu);
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float2 xv = xs[r * QMM_GROUP + jb + u];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            plo[r][c] = fmaf(xv.x, cl[c], plo[r][c]);
            phi[r][c] = fmaf(xv.y, ch[c], phi[r][c]);
          }
        }
      }
    }

    // this pair's two groups: each partial dot times its scale
    float slo[4], shi[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + c;
      slo[c] = n < N ? __ldg(p.scale + (size_t)g * N + n) : 0.f;
      shi[c] = n < N ? __ldg(p.scale + (size_t)(p.pairs + g) * N + n) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[r][c] = fmaf(phi[r][c], shi[c], fmaf(plo[r][c], slo[c], acc[r][c]));
  }

  // the warps' totals, summed in warp order
  __syncthreads();
  float4* red = reinterpret_cast<float4*>(qmm_smem);  // [warp][r][32 lanes]
#pragma unroll
  for (int r = 0; r < RT; ++r)
    red[(warp * RT + r) * 32 + lane] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  const float* redf = reinterpret_cast<const float*>(qmm_smem);
  for (int idx = threadIdx.x; idx < RT * QMM_COLS; idx += FMA_THREADS) {
    const int r = idx / QMM_COLS;
    const int col = idx % QMM_COLS;
    const int row = row0 + r;
    const int n = blockIdx.x * QMM_COLS + col;
    if (row >= p.rows || n >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < FMA_WARPS; ++w) s += redf[(w * RT + r) * QMM_COLS + col];
    store_result<T>(p, z, row, n, s);
  }
}

template <typename T, int RT>
cudaError_t fma_launch(const QmmParams& p, int vec, cudaStream_t stream) {
  constexpr size_t smem = fma_smem_bytes<RT>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(qmm_fma_kernel<T, RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.N + QMM_COLS - 1) / QMM_COLS, (p.rows + RT - 1) / RT, p.splits);
  qmm_fma_kernel<T, RT><<<grid, FMA_THREADS, smem, stream>>>(p, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fma_dispatch(const QmmParams& p, int row_tile, int vec, cudaStream_t st) {
  switch (row_tile) {
    case 1: return fma_launch<T, 1>(p, vec, st);
    case 2: return fma_launch<T, 2>(p, vec, st);
    case 4: return fma_launch<T, 4>(p, vec, st);
    case 8: return fma_launch<T, 8>(p, vec, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// the second launch: partials summed in split order
// ---------------------------------------------------------------------------

constexpr int COMBINE_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS) qmm_combine_kernel(const QmmParams p) {
  const size_t count = (size_t)p.rows * p.N;
  const size_t i = (size_t)blockIdx.x * COMBINE_THREADS + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
#pragma unroll 8
  for (int z = 0; z < p.splits; ++z) s += p.partial[z * count + i];
  static_cast<T*>(p.out)[i] = from_float<T>(s);
}

template <typename T>
cudaError_t combine_launch(const QmmParams& p, cudaStream_t stream) {
  const size_t count = (size_t)p.rows * p.N;
  qmm_combine_kernel<T><<<(unsigned)((count + COMBINE_THREADS - 1) / COMBINE_THREADS), COMBINE_THREADS, 0,
                          stream>>>(p);
  return cudaGetLastError();
}

bool aligned(const void* ptr, uintptr_t bytes) { return reinterpret_cast<uintptr_t>(ptr) % bytes == 0; }

}  // namespace
}  // namespace nxdi

// x (rows, K); packed (k_half, N); scale (Kp / 128, N); out (rows, N);
// partial (splits, rows, N) fp32, read only when splits > 1. Split z takes
// group pairs [z per_split, min((z + 1) per_split, Kp / 256)); every split
// must hold at least one pair. row_tile is the rows a block takes, as
// ops/quant_matmul.py::qmm_row_tile picks it (the split rule counts the
// blocks by it): 16 or 32 for bf16 (the tensor-core body), 1, 2, 4 or 8 for
// fp32 (the FMA body).
extern "C" int nxdi_quant_matmul(const void* x, const void* packed, const void* scale, void* out, void* partial,
                                 int rows, int K, int k_half, int N, int splits, int per_split, int row_tile,
                                 int dtype, void* stream) {
  using namespace nxdi;
  const int pairs = k_half / QMM_GROUP;
  if (rows < 1 || rows > QMM_MAX_ROWS || k_half <= 0 || k_half % QMM_GROUP != 0 || K < 1 || K > 2 * k_half ||
      N < 1 || splits < 1 || per_split < 1 || (long long)(splits - 1) * per_split >= pairs ||
      (long long)splits * per_split < pairs || (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const QmmParams p{x, static_cast<const uint8_t*>(packed), static_cast<const float*>(scale), out,
                    static_cast<float*>(partial), rows, K, k_half, N, pairs, splits, per_split};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kFloat32) {
    err = fma_dispatch<float>(p, row_tile, N % 4 == 0 && aligned(packed, 4), st);
    if (err == cudaSuccess && splits > 1) err = combine_launch<float>(p, st);
  } else if (dtype == kBFloat16) {
    const int cvec = N % 16 == 0 && aligned(packed, 16);
    const int xvec = K % 8 == 0 && aligned(x, 16);
    if (row_tile == 16) err = tc_launch<1>(p, cvec, xvec, st);
    else if (row_tile == 32) err = tc_launch<2>(p, cvec, xvec, st);
    if (err == cudaSuccess && splits > 1) err = combine_launch<__nv_bfloat16>(p, st);
  }
  return (int)err;
}
