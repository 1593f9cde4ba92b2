"""Time design alternatives of the PyTorch/CUDA port's attention kernels B1
and B4 (decode over the contiguous and the paged cache,
``csrc/decode_attention.cu``) and B2 (prefill flash,
``csrc/flash_attention.cu``), of the int4 matmul B6
(``csrc/quant_matmul.cu``), of the MoE decode B7 (``csrc/moe_decode.cu``)
and of the fused decode blocks B8 and B9 (``csrc/fused_attn_block.cu``,
``csrc/fused_mlp_block.cu``), on one H100, beside the kernels as built.

    python3 scripts/torch_attention_variants.py [b2] [b1] [b4] [b6] [b7] [b8] [b9] [b3] [points] [b6host] [host] [tok]

(no argument: b2, b1, b4, b6, b7, b8, b9 and b3)

Each alternative is the kernel's own source with one decision changed,
compiled with the port's nvcc flags (``ops/_cuda.py``) into
``build/torch_kernels/variants/`` and loaded under the port's wrapper, so
every alternative runs the same wrapper, inputs and timing: each is held
to the plain version first (``chip_smoke.check_flash`` /
``check_decode``), then timed with ``chip_smoke.time_ms`` (CUDA events, L2
flushed, device time only), and its launches timed by torch.profiler.

B2, at the three timed prefill shapes (batch 1, 32 q / 8 kv heads, the
fused QKV projection's views):
  built      64 query rows a block (4 warps), the interval mask;
  rows16/32  1 or 2 warps a block: 256 / 128 blocks at S=128;
  predicate  the per-element mask predicate ``allowed`` (an integer
             division per element once a chunk is set) and no whole-tile
             path.
B1, at batch 1 (Llama-3.2-1B's 8 kv heads, Qwen3-30B-A3B's 4), 4 and 8:
  the split rule (``ops/decode_attention.py::decode_kv_split``) against
  fixed split lengths of 16 to 160 positions; and
  thread-combine  the combine with one thread per (row, head, dim), each
             loading every split's (m, l), against one warp per (row,
             head).
B6, bf16, at the 8B row's o, down and gate projections at 1 row and the
1B row's qkv, o and down at 8 rows:
  built      the tensor-core body at every row count, split K by
             ``ops/quant_matmul.py::quant_matmul_split``;
  fma-rows2  bf16 calls of at most 2 rows on the FMA body (the first
             version's, under the same split, with row tiles of 1 or 2);
  stages2/4  2 or 4 group pairs in shared memory instead of 3;
  stages2-min4, stages3-min3  registers capped for 4 (3) blocks an SM
             (__launch_bounds__), with 2 (3) stages, so that many fit;
  and the built kernel under other split rules: no split, and the rule
  aiming at 1, 4 or 8 blocks an SM instead of QMM_BLOCKS_PER_SM.
B4, bf16, at the serving row's decode step (8 rows, 8 kv heads, D 64,
a 1024-wide table of blocks of 32, 192 deep), the same at blocks of 16,
960 deep, and one row 960 deep: the split rule (``decode_kv_split`` over
the table's positions) against fixed split lengths of 16 to 256
positions (at most 32 splits) and one split.
B7, bf16, at Qwen3-30B-A3B's batch 1 and 8 and Mixtral-8x7B's batch 1
(``ops/roofline.MOE_POINTS``):
  built      H split by ``ops/moe_decode.py::moe_h_split``, the weight
             tiles in shared memory by ``moe_stages``, the down and
             combine launches started early (programmatic dependent
             launch);
  no-pdl     each launch waits for the one before it to end;
  l2-128/256 the weight copies with an L2 fetch-size hint of 128 or 256
             bytes (a 64-column bf16 tile row is 128);
  and the built kernel with each launch's stage count fixed at 2 to 8,
  and with 1 to 11 splits of H instead of the rule's; device us per
  launch with the L2 flushed (``chip_smoke.launch_breakdown``).
B8, bf16, at the 1B decode layer it is timed at (batch 1 and 4, bucket
512, 255 deep; chip_smoke.fused_timed_inputs), device ms, the same with the
L2 evicted by a read (clean L2, ``time_clean``), and us per launch
(chip_smoke.launch_breakdown, with each launch's time past the one before):
  built      QKV, then attention (after QKV ends), then the o-proj as a
             programmatic dependent launch of the attention (its first
             weight stages in flight before it waits), QKV partials added
             8 splits' loads at a time;
  attn-pdl   the attention also started early, as a programmatic
             dependent launch of QKV that waits inside;
  late-trigger the attention launch lets the o-proj start only once its
             splits are stored;
  no-pdl     each launch waits for the one before it to end;
  zq4/zq16   the QKV partials' loads 4 or 16 splits at a time;
  stages4, no-xs, lb3  the product loop's knobs (LB3 .. MMA_ALL below);
  active-first, qkv-ldcg, spec-tile  the attention's active part in split
             0, the QKV partials read past L1, the split's first tile
             copied before its mask bits are known;
  and the built kernel under other kv splits than ``ops/decode_block.py::
  kv_split`` (``_kv_plan``): B1's ``decode_kv_split``, the first kv_split
  (about one block an SM), 128 positions a split, one split.
B9, bf16, at the 1B MLP with 1, 4, 16 and 64 rows and the 8B MLP with 1 row
(b9_points), device ms, clean-L2 ms and us per launch:
  built      gate/up -> down as programmatic dependent launches on the
             product loop of csrc/decode_gemv.cuh (128 columns a block, 3
             weight stages of 16 KB, x and gamma staged ahead of them for
             the norm where they fit, FMAs up to 2 bf16 rows, the tensor
             cores past that), the split rule aiming at 2 blocks an SM;
  stages4    4 weight stages in the ring;
  no-xs      x read by loads for the norm, behind the weight stages;
  fma4, mma-all  FMAs up to 4 bf16 rows, or the tensor cores at every row
             count;
  no-pdl     down waits for gate/up to end;
  cols64     64 columns and 4 warps a block, 8 KB stages;
  lb3        registers capped for 3 blocks an SM;
  and the built kernel (and cols64) under other split targets of
  ``ops/decode_block.py::gemv_split`` (GEMV_BLOCKS_PER_SM 1, 3, 4).
b9timeline: the built kernel with a globaltimer stamp from each block of
  both launches at ten points (B9_STAMPS), us after the first gate/up
  block's entry.
points: B9 as built at b9_points and B8 at its two timed points, using
  only what earlier trees also have: run parent, change, change, parent.
b8timeline: the built attention launch and no-pdl with a globaltimer stamp
  from each block at eight points (B8_TIMELINE), us after the first entry.
B3, bf16, at the serving row's two points (``ops/roofline.RAGGED_POINTS``)
and 8 decode rows 1000 deep (a 1024-wide table of blocks of 32): the decode
tiles' split rule (``ops/ragged_paged_attention.py::ragged_decode_split``)
against fixed splits of 64, 128 and 256 positions and no split.
host: B4's and B7's host cost, the wrapper's microseconds per call
  enqueued back to back (least and median of 7 runs of 200) at B4's timed
  shape and B7's Qwen3 batch 1, and B7's device time and us per launch
  at its three timed points.
tok10: the sync ragged drain's tok/s and the 1B generate() at batch 4
  with the fused layer on (tok/s), twice each.
tok: the split serving drain (8 staggered requests of 128 + 128 tokens,
  Llama-3.2-1B shapes, bf16, random weights: aggregate tok/s) twice and
  Qwen3-30B-A3B generate() (batch 1, 128 + 256 tokens, random weights at
  full depth: decode tok/s) twice.
host, tok and tok10, like b6host, use only what earlier trees also have: run
  parent, change, change, parent in one call.
b6host: B6's host cost, the wrapper's microseconds per call enqueued back
  to back at the 8B o and down shapes (1 row; the least and the median of 7
  runs of 200 calls), and the int4 8B generate() (bf16_8b_int4, 256
  tokens) twice, decode tok/s. It uses
  only what earlier trees also have, so a copy of this script placed in a
  parent checkout times the parent's wrapper: run parent, change, change,
  parent in one call.
Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FLASH_VARIANTS = {
    "built": [],
    "rows16": [("constexpr int MMA_WARPS = 4;", "constexpr int MMA_WARPS = 1;")],
    "rows32": [("constexpr int MMA_WARPS = 4;", "constexpr int MMA_WARPS = 2;")],
    "predicate": [
        ("    float alpha[2];\n    if (whole) {", "    float alpha[2];\n    if (false && whole) {"),
        (
            "const bool ok = ((vbits[n / 4] >> (col % 32)) & 1u) && kv0 + col >= col_lo[rr] && "
            "kv0 + col <= col_hi[rr];",
            "const bool ok = allowed(row0 + 8 * rr, kv0 + col, vs[col] != 0, p);",
        ),
    ],
}

THREAD_COMBINE = '''template <typename T, int D>
__global__ void split_combine_kernel(const SplitParams p) {
  const long long BKH = (long long)p.B * p.K * p.Hq;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= BKH * D) return;
  const long long rh = i / D;
  float mz[MAX_SPLITS], lz[MAX_SPLITS], az[MAX_SPLITS];
#pragma unroll
  for (int z = 0; z < MAX_SPLITS; ++z) {
    mz[z] = z < p.splits ? p.m_part[z * BKH + rh] : NEG_INF;
    lz[z] = z < p.splits ? p.l_part[z * BKH + rh] : 0.f;
    az[z] = z < p.splits ? p.acc_part[z * BKH * D + i] : 0.f;
  }
  float mx = NEG_INF;
#pragma unroll
  for (int z = 0; z < MAX_SPLITS; ++z) mx = fmaxf(mx, mz[z]);
  float num = 0.f, den = 0.f;
#pragma unroll
  for (int z = 0; z < MAX_SPLITS; ++z) {
    if (z < p.splits) {
      const float w = expf(mz[z] - mx);
      num = fmaf(az[z], w, num);
      den = fmaf(lz[z], w, den);
    }
  }
  static_cast<T*>(p.out)[i] = from_float<T>(finalize(num, mx, den, p.sink, (int)(rh % p.Hq)));
}

'''


def decode_variants(src):
    start = src.index("template <typename T, int D>\n__global__ void split_combine_kernel(")
    end = src.index("template <typename T, int D, int RW>\ncudaError_t split_launch(")
    launch = [line for line in src.splitlines() if "split_combine_kernel<T, D><<<" in line]
    assert len(launch) == 1, launch
    new_launch = "  split_combine_kernel<T, D><<<(unsigned)((p.B * p.K * p.Hq * D + 255) / 256), 256, 0, st>>>(p);"
    return {"built": [], "thread-combine": [(src[start:end], THREAD_COMBINE), (launch[0], new_launch)]}


def build_variants(_cuda, kernel, variants):
    """{name: library path}: the source with each variant's replacements
    (each must match), one nvcc per variant, all started together. A
    replacement (header, old, new) patches a header the source includes:
    the patched copy is written beside the variant's source, which finds it
    there before the package's."""
    procs, paths = {}, {}
    for name, patches in variants.items():
        files = {}
        for patch in patches:
            file, old, new = patch if len(patch) == 3 else (f"{kernel}.cu", *patch)
            text = files.get(file) or (_cuda.CSRC / file).read_text()
            if old not in text:
                raise SystemExit(f"{kernel} variant {name}: {file} no longer holds {old[:60]!r}")
            files[file] = text.replace(old, new)
        d = _cuda.BUILD_ROOT / "variants" / kernel / name
        if d.exists():
            for stale in d.glob("*.cuh"):
                stale.unlink()
        d.mkdir(parents=True, exist_ok=True)
        files.setdefault(f"{kernel}.cu", (_cuda.CSRC / f"{kernel}.cu").read_text())
        for file, text in files.items():
            (d / file).write_text(text)
        paths[name] = d / f"lib{kernel}.so"
        cmd = [_cuda.nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-o", str(paths[name]),
               str(d / f"{kernel}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    import chip_smoke

    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{kernel} variant {name} does not build:\n{log}")
        for fn, regs in chip_smoke.ptxas_summary(log).items():
            print(f"{kernel} {name}: {fn}: {regs}", flush=True)
    return paths


def use(_cuda, kernel, path):
    """Load ``path`` as kernel library ``kernel`` behind the port's wrappers."""
    _cuda._libs[kernel] = ctypes.CDLL(str(path))
    for key in [k for k in _cuda._fns if k[0] == kernel]:
        del _cuda._fns[key]


def launch_us(torch, chip_smoke, fn, n=20):
    """Device us per call of each kernel ``fn`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        name = chip_smoke.port_kernel_name(e.name)
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / n
    return ", ".join(f"{k} {v:.2f}" for k, v in by_name.items())


def flash_times(torch, chip_smoke, _cuda, fa):
    import torch.nn.functional as F

    paths = build_variants(_cuda, "flash_attention", FLASH_VARIANTS)
    rng = np.random.RandomState(2)
    for S, D in ((128, 64), (512, 64), (512, 128)):
        q, k, v = chip_smoke.fused_qkv_inputs(torch, rng, 1, S, 32, 8, D, torch.bfloat16)
        key_valid = torch.ones((1, S), dtype=torch.int32, device="cuda")
        kw = dict(scale=D ** -0.5, causal=True, softmax_bf16=False, window=None, chunk=None)
        qt = q.transpose(1, 2)
        kt, vt = (x.transpose(1, 2).repeat_interleave(4, dim=1) for x in (k, v))
        sdpa = chip_smoke.time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
        for name, path in paths.items():
            use(_cuda, "flash_attention", path)
            chip_smoke.check_flash(torch, fa, q, k, v, key_valid, kw, f"{name} S={S} D={D}")

            def f():
                return fa.flash_attention_fwd(q, k, v, key_valid, **kw)

            ms = chip_smoke.time_ms(torch, f)
            print(f"B2 S={S} D={D} {name}: {ms:.4f} ms (sdpa {sdpa:.4f}); device us per launch: "
                  f"{launch_us(torch, chip_smoke, f)}", flush=True)


def decode_times(torch, chip_smoke, _cuda, da):
    from neuronx_distributed_inference_tpu_torch.modules.masks import token_gen_mask

    src = (_cuda.CSRC / "decode_attention.cu").read_text()
    paths = build_variants(_cuda, "decode_attention", decode_variants(src))
    rule = da.decode_kv_split
    rng = np.random.RandomState(3)
    try:
        for B, Hkv, D in ((1, 8, 64), (1, 4, 128), (4, 8, 64), (8, 8, 64), (8, 4, 128)):
            bucket, valid = 512, 412
            q, kc, vc, _ = chip_smoke._decode_inputs(
                torch, rng, B, 1, 32, Hkv, D, 16, 1024, bucket, torch.bfloat16, [valid] * B
            )
            cols = torch.arange(bucket, device="cuda")[None, :].expand(B, bucket)
            mask = token_gen_mask((cols < valid).to(torch.int32), 1)
            kw = dict(scale=D ** -0.5, n_kv=Hkv)
            splits = [(name, None) for name in paths] + [("built", per) for per in (16, 32, 64, 128, 160)]
            for name, per in splits:
                use(_cuda, "decode_attention", paths[name])
                da.decode_kv_split = rule if per is None else (lambda S, b, s, per=per: (-(-S // per), per))
                da._split_plan.cache_clear()
                split = da.decode_kv_split(bucket, B * Hkv, _cuda.sm_count(q.device))
                label = f"{name} {'rule' if per is None else 'fixed'} split {split[0]} x {split[1]}"
                chip_smoke.check_decode(torch, da, q, kc, vc, 3, mask, None, kw, f"B={B} Hkv={Hkv} {label}")
                def f():
                    return da.tkg_decode_attention(q, kc, vc, 3, mask, None, **kw)

                ms = chip_smoke.time_ms(torch, f)
                print(f"B1 B={B} Hkv={Hkv} D={D} bucket={bucket} valid={valid} {label}: {ms:.4f} ms; "
                      f"device us per launch: {launch_us(torch, chip_smoke, f)}", flush=True)
    finally:
        da.decode_kv_split = rule
        da._split_plan.cache_clear()


QMM_TC_BOUNDS = "__launch_bounds__(TC_THREADS) qmm_tc_kernel"
QMM_VARIANTS = {
    "built": [],
    "fma-rows2": [("    if (row_tile == 16) err = tc_launch<1>",
                   "    if (row_tile <= 2) err = fma_dispatch<__nv_bfloat16>(p, row_tile, "
                   "N % 4 == 0 && aligned(packed, 4), st);\n    else if (row_tile == 16) err = tc_launch<1>")],
    "stages2": [("constexpr int QMM_STAGES = 3;", "constexpr int QMM_STAGES = 2;")],
    "stages4": [("constexpr int QMM_STAGES = 3;", "constexpr int QMM_STAGES = 4;")],
    "stages2-min4": [("constexpr int QMM_STAGES = 3;", "constexpr int QMM_STAGES = 2;"),
                     (QMM_TC_BOUNDS, QMM_TC_BOUNDS.replace("TC_THREADS", "TC_THREADS, 4"))],
    "stages3-min3": [(QMM_TC_BOUNDS, QMM_TC_BOUNDS.replace("TC_THREADS", "TC_THREADS, 3"))],
}


def fma_row_tile(rule):
    """The row-tile rule of the fma-rows2 variant: bf16 calls of at most 2
    rows in FMA row tiles, the rest as ``rule``."""
    import torch

    return lambda rows, dtype: rows if dtype == torch.bfloat16 and rows <= 2 else rule(rows, dtype)


def qmm_times(torch, chip_smoke, _cuda, qmm):
    from neuronx_distributed_inference_tpu_torch.ops.roofline import QMM_POINTS, int4_projections

    paths = build_variants(_cuda, "quant_matmul", QMM_VARIANTS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    rule, target, row_tile = qmm.quant_matmul_split, qmm.QMM_BLOCKS_PER_SM, qmm.qmm_row_tile
    runs = [(name, None, None) for name in paths]
    runs += [(name, "4 blocks an SM", 4) for name in paths if name.endswith("min4")]
    runs += [("built", "no split", lambda pairs, c, r, s: (1, pairs))]
    runs += [("built", f"{t} blocks an SM", t) for t in (1, 4, 8) if t != target]
    try:
        for label, names in (("8b", ("o", "down", "gate")), ("1b", ("qkv", "o", "down"))):
            pt = QMM_POINTS[label]
            rows = pt["rows"]
            for name in names:
                K, N = int4_projections(pt["m"])[name]
                packed, scale = chip_smoke.qmm_inputs(torch, gen, K, N)
                x = torch.randn((rows, K), generator=gen, device="cuda").to(torch.bfloat16)
                w = qmm.dequantize_int4(packed, scale, K, torch.bfloat16)
                lib = chip_smoke.time_ms(torch, lambda: torch.matmul(x, w))
                for variant, split, how in runs:
                    use(_cuda, "quant_matmul", paths[variant])
                    qmm.quant_matmul_split, qmm.QMM_BLOCKS_PER_SM = rule, target
                    qmm.qmm_row_tile = fma_row_tile(row_tile) if variant == "fma-rows2" else row_tile
                    if callable(how):
                        qmm.quant_matmul_split = how
                    elif how is not None:
                        qmm.QMM_BLOCKS_PER_SM = how
                    qmm._plan.cache_clear()
                    grid = chip_smoke.qmm_grid_text(torch, qmm, rows, K, N, torch.bfloat16)
                    case = f"{label} {name} rows={rows} {variant}, {split or 'the rule'}: {grid}"
                    chip_smoke.check_qmm(torch, qmm, x, packed, scale, case)

                    def f():
                        return qmm.quant_matmul(x, packed, scale)

                    ms = chip_smoke.time_ms(torch, f)
                    print(f"B6 {case}: {ms:.4f} ms (matmul on the bf16 weight {lib:.4f}); device us per "
                          f"launch: {launch_us(torch, chip_smoke, f)}", flush=True)
                del packed, scale, w
    finally:
        qmm.quant_matmul_split, qmm.QMM_BLOCKS_PER_SM, qmm.qmm_row_tile = rule, target, row_tile
        qmm._plan.cache_clear()


def paged_times(torch, chip_smoke, _cuda, da):
    """B4 under its split rule and under fixed split lengths."""
    rule = da.decode_kv_split
    rng = np.random.RandomState(4)
    try:
        for B, ctx, bs in ((8, 192, 32), (8, 192, 16), (8, 960, 32), (1, 960, 32)):
            q, k, v, bt, mask = chip_smoke.serving_decode_inputs(torch, rng, ctx, B=B, bs=bs)
            Hkv, D = k.shape[2], q.shape[3]
            kw = dict(scale=D ** -0.5, n_kv=Hkv)
            ref = da.paged_tkg_decode_attention_plain(q.float(), k.float(), v.float(), 0, bt, mask, None, **kw)
            S = bt.shape[1] * bs
            for per in [None] + [n for n in (16, 32, 64, 128, 256, S) if -(-S // n) <= da.MAX_KV_SPLITS]:
                da.decode_kv_split = rule if per is None else (lambda S, b, s, per=per: (-(-S // per), per))
                da._split_plan.cache_clear()
                split = da.decode_kv_split(S, B * Hkv, _cuda.sm_count(q.device))
                label = f"{'rule' if per is None else 'fixed'} split {split[0]} x {split[1]}"
                case = f"B={B} ctx={ctx} bs={bs} {label}"
                out = da.paged_tkg_decode_attention(q, k, v, 0, bt, mask, None, **kw)
                chip_smoke.check_close(torch, out, ref, case, "paged_tkg_decode_attention")

                def f():
                    return da.paged_tkg_decode_attention(q, k, v, 0, bt, mask, None, **kw)

                ms = chip_smoke.time_ms(torch, f)
                print(f"B4 {case}: {ms:.4f} ms; device us per launch: {launch_us(torch, chip_smoke, f)}", flush=True)
            del q, k, v
    finally:
        da.decode_kv_split = rule
        da._split_plan.cache_clear()


MOE_STAGE_COPY = "cp_async16(dst + rr * MOE_COLS + c, ok ? w + (size_t)(row0 + rr) * ld + c0 + c : w, ok);"


def l2_hint(size):
    """The weight copies with an L2 fetch-size hint of ``size`` bytes."""
    return MOE_STAGE_COPY.replace("cp_async16(", "cp_async16_l2_%d(" % size), f"""
__device__ __forceinline__ void cp_async16_l2_{size}(void* dst, const void* src, bool full) {{
  asm volatile("cp.async.cg.shared.global.L2::{size}B [%0], [%1], 16, %2;\\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(full ? 16 : 0));
}}
"""


MOE_VARIANTS = {
    "built": [],
    "no-pdl": [("st, true, part, idx,", "st, false, part, idx,"),
               ("dim3(MOE_THREADS), 0, st, true,", "dim3(MOE_THREADS), 0, st, false,")],
}
for _size in (128, 256):
    _copy, _helper = l2_hint(_size)
    MOE_VARIANTS[f"l2-{_size}"] = [(MOE_STAGE_COPY, _copy),
                                   ("// two consecutive elements of a staged tile", _helper + "\n// two consecutive elements of a staged tile")]


def moe_times(torch, chip_smoke, _cuda, md):
    from neuronx_distributed_inference_tpu_torch.ops.roofline import MOE_POINTS

    paths = build_variants(_cuda, "moe_decode", MOE_VARIANTS)
    split_rule, stage_rule = md.moe_h_split, md.moe_stages
    runs = [(name, None) for name in paths]
    runs += [("built", ("gate stages", n)) for n in md.MOE_STAGES]
    runs += [("built", ("down stages", n)) for n in md.MOE_STAGES]
    runs += [("built", ("splits", n)) for n in (1, 2, 3, 4, 6, 8, 11)]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    try:
        for label, pt in MOE_POINTS.items():
            m, T = pt["m"], pt["tokens"]
            args = chip_smoke.moe_inputs(torch, gen, T, m["k"], m["E"], m["H"], m["I"], torch.bfloat16)
            for variant, how in runs:
                use(_cuda, "moe_decode", paths[variant])
                md.moe_h_split, md.moe_stages = split_rule, stage_rule
                what, n = how or ("the rules", None)
                if what == "splits":
                    def fixed_split(H, I, rows, sms, n=n):
                        per = -(-(-(-H // n)) // md.MOE_SPLIT_ROWS) * md.MOE_SPLIT_ROWS
                        return -(-H // per), per

                    md.moe_h_split = fixed_split
                elif what in ("gate stages", "down stages"):
                    calls = []  # the plan asks for the gate/up launch's stages first

                    def fixed(blocks, sms, stage_bytes, fixed_bytes, target, which=what, n=n, calls=calls):
                        calls.append(1)
                        mine = (len(calls) == 1) == (which == "gate stages")
                        return n if mine else stage_rule(blocks, sms, stage_bytes, fixed_bytes, target)

                    md.moe_stages = fixed
                md._plan.cache_clear()
                grid = md.moe_grid_text(T, m["k"], m["H"], m["I"], torch.bfloat16, args[0].device)
                case = f"{label} {variant}, {what}{'' if n is None else f' {n}'}: {grid}"
                chip_smoke.check_moe(torch, md, args, {}, case)

                def f():
                    return md.fused_moe_decode(*args)

                ms = chip_smoke.time_ms(torch, f)
                parts = chip_smoke.launch_breakdown(torch, f, chip_smoke.B7_LAUNCHES)
                print(f"B7 {case}: {ms:.4f} ms; device us per launch (L2 flushed): "
                      + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()), flush=True)
            del args
            torch.cuda.empty_cache()
    finally:
        md.moe_h_split, md.moe_stages = split_rule, stage_rule
        md._plan.cache_clear()


#: knobs of the product loop of B8 and B9 (csrc/decode_gemv.cuh), as
#: patches of the header: registers capped for 3 blocks an SM (80), so that
#: a dependent launch's blocks fit beside 2 of its blocks; 4 ring stages
#: instead of 3; no whole staging of x and gamma ahead of the weights for
#: the norm; the FMA body up to 4 bf16 rows, or none
GV = "decode_gemv.cuh"
LB3 = (GV, "__launch_bounds__(GV_THREADS, 2) gemv_kernel", "__launch_bounds__(GV_THREADS, 3) gemv_kernel")
STAGES4 = (GV, "constexpr int GV_STAGES = 3;", "constexpr int GV_STAGES = 4;")
NO_XS = (GV, "constexpr int GV_XS_BYTES = 24576;", "constexpr int GV_XS_BYTES = 0;")
FMA4 = (GV, "constexpr int GV_FMA_ROWS = 2;", "constexpr int GV_FMA_ROWS = 4;")
MMA_ALL = (GV, "constexpr int GV_FMA_ROWS = 2;", "constexpr int GV_FMA_ROWS = 0;")
#: B8's attention launch started early, as a programmatic dependent launch
#: of the QKV launch, and waiting for it inside
ATTN_PDL = [
    ("smem, st, false, p);", "smem, st, true, p);"),
    ("  pdl_launch_dependents();  // the o-proj launch may start issuing its weight stages\n",
     "  if (!idle) pdl_wait();\n  pdl_launch_dependents();  // the o-proj launch may start issuing its weight stages\n"),
    ("gemv_launch<T, 1, PartialSink, GV_NORM>(", "gemv_launch<T, 1, PartialSink, GV_NORM | GV_TRIGGER>("),
]

B8_VARIANTS = {
    "built": [],
    "attn-pdl": ATTN_PDL,
    "late-trigger": [
        ("  pdl_launch_dependents();  // the o-proj launch may start issuing its weight stages\n", ""),
        ("  // the attention rows (row b K + t", "  pdl_launch_dependents();\n  // the attention rows (row b K + t"),
    ],
    "no-pdl": [("GV_WAIT>(", "0>(")],
    "zq4": [("    constexpr int ZQ = 8;\n", "    constexpr int ZQ = 4;\n")],
    "zq16": [("    constexpr int ZQ = 8;\n", "    constexpr int ZQ = 16;\n")],
    "stages4": [STAGES4],
    "no-xs": [NO_XS],
    "lb3": [LB3],
    "active-first": [("  const int act = p.splits - 1;", "  const int act = 0;")],
    "qkv-ldcg": [("? src[(z0 + w) * zstride] : 0.f;", "? __ldcg(src + (z0 + w) * zstride) : 0.f;")],
    "spec-tile": [
        ("    cp_async_commit();\n  };\n  // the row's K tokens' cos / sin",
         "    cp_async_commit();\n  };\n  if (slot_ok && nt > 0) load_tile(0, 0);  // before the mask says it lives\n"
         "  // the row's K tokens' cos / sin"),
        ("  int j = next_live(0);\n  if (j < nt) load_tile(j, 0);\n",
         "  int j = next_live(0);\n  if (j != 0 && j < nt) {\n    cp_async_wait<0>();\n    load_tile(j, 0);\n  }\n"),
    ],
}


#: B8's attention launch with a globaltimer stamp (ns) from thread 0 of each
#: block at ten points (B8_STAMPS): entry, before and after its wait for the
#: QKV launch, after its QKV partial loads, after RoPE, at the prior tiles'
#: start, after them, at the completion count, the combine's start and end
#: (the last two in the last block only)
B8_STAMPS = ("entry", "wait", "waited", "qkv", "rope", "tiles", "softmax", "tiled", "counting", "combine", "end",
             "qkv once")
B8_TIMELINE = [
    ("namespace nxdi {\nnamespace {\n",
     "__device__ unsigned long long nxdi_tl[16384];\n#define TL(k) do { if (threadIdx.x == 0) { unsigned long long t_; "
     "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); nxdi_tl[((blockIdx.z * gridDim.y + blockIdx.y) * "
     "gridDim.x + blockIdx.x) * 16 + (k)] = t_; } } while (0)\nnamespace nxdi {\nnamespace {\n"),
    ("  const int g = blockIdx.x, b = blockIdx.y, z = blockIdx.z;\n",
     "  const int g = blockIdx.x, b = blockIdx.y, z = blockIdx.z;\n  TL(0);\n"),
    ("  pdl_launch_dependents();  // the o-proj launch may start issuing its weight stages\n",
     "  TL(1);\n  TL(2);\n  pdl_launch_dependents();  // the o-proj launch may start issuing its weight stages\n"),
    ("      Qs[rr * LQ + d] = sum;  // Kn and Vn follow Qs row for row\n    }\n",
     "      Qs[rr * LQ + d] = sum;  // Kn and Vn follow Qs row for row\n    }\n"
     "    TL(3);\n"),
    ("    if (z == act) {\n      // k_new / v_new", "    TL(4);\n    if (z == act) {\n      // k_new / v_new"),
    ("    // the prior cache: the split's live tiles, two stages\n",
     "    TL(5);\n    // the prior cache: the split's live tiles, two stages\n"),
    ("      __syncwarp();\n", "      TL(6);\n      __syncwarp();\n"),
    ("  // the attention rows (row b K + t", "  TL(7);\n  // the attention rows (row b K + t"),
    ("  if (p.splits == 1 || !last_block(", "  TL(8);\n  if (p.splits == 1 || !last_block("),
    ("  constexpr int ZB = 8;\n", "  TL(9);\n  constexpr int ZB = 8;\n"),
    ("num[k] / fmaxf(den, 1e-30f));\n  }\n}\n", "num[k] / fmaxf(den, 1e-30f));\n  }\n  TL(10);\n}\n"),
    ("  return (int)cudaErrorInvalidValue;\n}\n",
     "  return (int)cudaErrorInvalidValue;\n}\nextern \"C\" int nxdi_tl_read(void* dst) {\n"
     "  return (int)cudaMemcpyFromSymbol(dst, nxdi_tl, sizeof(nxdi_tl));\n}\nextern \"C\" int nxdi_tl_clear() {\n"
     "  static unsigned long long z[16384];\n  return (int)cudaMemcpyToSymbol(nxdi_tl, z, sizeof(nxdi_tl));\n}\n"),
]
#: diagnostic: the QKV partial loads run twice (same results), stamp 11
#: ("qkv once") after the first pass
B8_QKV_TWICE = [("    const int n_el = (rows + 2 * nk) * D;\n",
                 "    const int n_el = (rows + 2 * nk) * D;\n    for (int pass = 0; pass < 2; ++pass) {\n    if (pass) TL(11);\n"),
                ("      Qs[rr * LQ + d] = sum;  // Kn and Vn follow Qs row for row\n    }\n",
                 "      Qs[rr * LQ + d] = sum;  // Kn and Vn follow Qs row for row\n    }\n"
                 "    }\n")]
#: diagnostic only (the results are wrong): the QKV partial sums read as 0
B8_NO_QKV = [("v[w] = z0 + w < p.s_qkv ? src[(z0 + w) * zstride] : 0.f;", "v[w] = 0.f;")]


def fused_attn_timeline(torch, chip_smoke, _cuda, db):
    """Where B8's attention launch spends its time: the timeline variant of
    the built kernel and of no-pdl at the timed 1B layer, each call after an
    L2 flush and a spin (as chip_smoke.time_ms); per stamp, the blocks'
    least / median / largest us after the first block's entry."""
    variants = {f"timeline {name}": B8_TIMELINE + B8_VARIANTS[name]
                for name in ("built", "no-pdl", "qkv-ldcg")}
    variants["timeline qkv twice"] = B8_TIMELINE + B8_QKV_TWICE
    variants["timeline no-qkv-loads (wrong results)"] = B8_TIMELINE + B8_NO_QKV
    paths = build_variants(_cuda, "fused_attn_block", variants)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    try:
        for B in (1, 4):
            args, _ = chip_smoke.fused_timed_inputs(torch, gen, B)
            D, Hkv = args[6].shape[-1], args[6].shape[3]
            kw = dict(scale=D ** -0.5, eps=chip_smoke.FUSED_EPS, n_kv=Hkv)
            for name, path in paths.items():
                use(_cuda, "fused_attn_block", path)
                lib = _cuda._libs["fused_attn_block"]
                rows = []
                for _ in range(5):
                    db.fused_attn_block(*args, **kw)
                    torch.cuda.synchronize()
                    lib.nxdi_tl_clear()
                    flush.zero_()
                    torch.cuda._sleep(chip_smoke.SPIN_CYCLES)
                    db.fused_attn_block(*args, **kw)
                    torch.cuda.synchronize()
                    buf = (ctypes.c_ulonglong * 16384)()
                    lib.nxdi_tl_read(buf)
                    t = np.array(buf, dtype=np.float64).reshape(-1, 16)[:, : len(B8_STAMPS)]
                    t = t[t[:, 0] > 0]
                    rows.append((t - t[:, 0].min()) / 1e3)
                t = np.concatenate(rows)
                parts = []
                for k, stamp in enumerate(B8_STAMPS):
                    col = t[:, k][t[:, k] >= 0]
                    if len(col):
                        parts.append(f"{stamp} {col.min():.2f}/{np.median(col):.2f}/{col.max():.2f}")
                print(f"B8 B={B} {name}: {len(t) // 5} blocks, us after the first entry (least/median/largest): "
                      + ", ".join(parts), flush=True)
                z = (np.arange(len(t)) % (len(t) // 5)) // (B * Hkv)  # each block's kv split
                k, kt = B8_STAMPS.index("counting"), B8_STAMPS.index("tiles")
                print(f"  by kv split, median us at counting (and at tiles): " + ", ".join(
                    f"{zz}: {np.median(t[z == zz, k]):.2f} ({np.median(t[z == zz, kt]):.2f})"
                    for zz in range(z.max() + 1)), flush=True)
            del args
    finally:
        _cuda._libs.pop("fused_attn_block", None)
        for key in [k for k in _cuda._fns if k[0] == "fused_attn_block"]:
            del _cuda._fns[key]


def fused_attn_times(torch, chip_smoke, _cuda, db):
    """B8's variants and kv splits at the timed 1B decode layer."""
    from neuronx_distributed_inference_tpu_torch.ops.decode_attention import decode_kv_split

    paths = build_variants(_cuda, "fused_attn_block", B8_VARIANTS)
    plan = db._kv_plan
    def first_rule(S, blocks, sms):  # the first kv_split: about one block per SM, at most 16 splits
        n = -(-S // 64)
        per = -(-n // min(n, 16, -(-sms // blocks)))
        return -(-n // per), per * 64

    rules = {
        "decode_kv_split": decode_kv_split,
        "first kv_split": first_rule,
        "per 128": lambda S, b, s: (-(-S // 128), 128),
        "one split": lambda S, b, s: (1, -(-S // 16) * 16),
    }
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    try:
        for B in (1, 4):
            args, _ = chip_smoke.fused_timed_inputs(torch, gen, B)
            D, Hkv = args[6].shape[-1], args[6].shape[3]
            kw = dict(scale=D ** -0.5, eps=chip_smoke.FUSED_EPS, n_kv=Hkv)
            runs = [(name, path, None) for name, path in paths.items()]
            runs += [(f"built, {label}", paths["built"], rule) for label, rule in rules.items()]
            for name, path, rule in runs:
                use(_cuda, "fused_attn_block", path)
                db._kv_plan = plan if rule is None else rule
                split = db._kv_plan(args[10].shape[-1], B * Hkv, _cuda.sm_count(args[0].device))
                case = f"B={B} {name} ({split[0]} splits of {split[1]})"
                chip_smoke.check_fused_attn(torch, db, args, case)

                def f():
                    return db.fused_attn_block(*args, **kw)

                ms, clean = chip_smoke.time_ms(torch, f), time_clean(torch, f)
                us = chip_smoke.launch_breakdown(torch, f, chip_smoke.B8_LAUNCHES)
                print(f"B8 {case}: {ms:.4f} ms (clean L2 {clean:.4f}); device us per launch: "
                      + ", ".join(f"{k} {v:.2f}" for k, v in us.items()), flush=True)
            del args
    finally:
        db._kv_plan = plan
        _cuda._libs.pop("fused_attn_block", None)  # the next call loads the kernel as built
        for key in [k for k in _cuda._fns if k[0] == "fused_attn_block"]:
            del _cuda._fns[key]


#: B9 design alternatives: patches of csrc/fused_mlp_block.cu, or
#: (header, old, new) of the product loop it includes
B9_VARIANTS = {
    "built": [],
    "stages4": [STAGES4],
    "no-xs": [NO_XS],
    "fma4": [FMA4],
    "mma-all": [MMA_ALL],
    "no-pdl": [("GV_WAIT>(", "0>(")],
    "cols64": [
        (GV, "constexpr int GV_THREADS = 256;", "constexpr int GV_THREADS = 128;"),
        (GV, "constexpr int GV_COLS = 128;", "constexpr int GV_COLS = 64;"),
        (GV, "constexpr int GV_STAGE_BYTES = 16384;", "constexpr int GV_STAGE_BYTES = 8192;"),
    ],
    "lb3": [LB3],
}
#: the variants' columns a block (the wrapper's split rule and counters
#: follow it)
B9_VARIANT_COLS = {"cols64": 64}


#: the product loop (csrc/decode_gemv.cuh) with a globaltimer stamp (ns)
#: from thread 0 of each block at B9_STAMPS; gate/up blocks (two weights)
#: at slots 0..511, down blocks at 512..1023
#: the variants B9's timeline runs
B9_TIMELINE_OF = ("built",)
B9_STAMPS = ("entry", "issued", "waited", "normed", "slab", "stage 0", "stage n/2", "loop end", "sunk", "end")
B9_TIMELINE = [
    ("decode_gemv.cuh", '#include "mma.cuh"\n',
     '#include "mma.cuh"\n__device__ unsigned long long nxdi_tl[16384];\n#define TL(k) do { if (threadIdx.x == 0) { '
     'unsigned long long t_; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); nxdi_tl[((NMAT == 1 ? 512 : 0) + '
     'blockIdx.z * gridDim.x + blockIdx.x) * 16 + (k)] = t_; } } while (0)\n'),
    ("decode_gemv.cuh", "  if (FLAGS & GV_TRIGGER) pdl_launch_dependents();\n\n",
     "  TL(0);\n  if (FLAGS & GV_TRIGGER) pdl_launch_dependents();\n\n"),
    ("decode_gemv.cuh", "  if (FLAGS & GV_WAIT) pdl_wait();\n", "  TL(1);\n  if (FLAGS & GV_WAIT) pdl_wait();\n  TL(2);\n"),
    ("decode_gemv.cuh", "      norm_from_xs(rt);\n", "      norm_from_xs(rt);\n      TL(3);\n"),
    ("decode_gemv.cuh", "      if (FLAGS & GV_NORM) row_norms(r0, rt);\n      stage_slab(r0, rt, k0);\n",
     "      if (FLAGS & GV_NORM) row_norms(r0, rt);\n      TL(3);\n      stage_slab(r0, rt, k0);\n"),
    ("decode_gemv.cuh", "      stage_slab(r0, rt, k0);\n    }\n    __syncthreads();\n",
     "      stage_slab(r0, rt, k0);\n    }\n    __syncthreads();\n    TL(4);\n"),
    ("decode_gemv.cuh", "    else cp_async_commit();\n    if (s > 0 && (s * KS) % ach == 0) {\n",
     "    else cp_async_commit();\n    if (s == 0) TL(5);\n    if (s == n_st / 2) TL(6);\n"
     "    if (s > 0 && (s * KS) % ach == 0) {\n"),
    ("decode_gemv.cuh", "      cp_async_wait<0>();  // (the empty groups)\n", "      cp_async_wait<0>();  // (the empty groups)\n      TL(7);\n"),
    ("decode_gemv.cuh", "      cp_async_wait<0>();\n      // the lanes", "      cp_async_wait<0>();\n      TL(7);\n      // the lanes"),
    ("decode_gemv.cuh", "  sink.finish(p.rows);\n}\n", "  TL(8);\n  sink.finish(p.rows);\n  TL(9);\n}\n"),
    ("  return (int)cudaErrorInvalidValue;\n}\n",
     "  return (int)cudaErrorInvalidValue;\n}\nextern \"C\" int nxdi_tl_read(void* dst) {\n"
     "  return (int)cudaMemcpyFromSymbol(dst, nxdi_tl, sizeof(nxdi_tl));\n}\nextern \"C\" int nxdi_tl_clear() {\n"
     "  static unsigned long long z[16384];\n  return (int)cudaMemcpyToSymbol(nxdi_tl, z, sizeof(nxdi_tl));\n}\n"),
]


def fused_mlp_timeline(torch, chip_smoke, _cuda, db):
    """Where B9's two launches spend their time: timeline variants
    (B9_TIMELINE_OF) at the 1B MLP with 1 and 16 rows and the 8B MLP with 1
    row, each call after an L2 flush and a spin (as chip_smoke.time_ms);
    per stamp and launch, the blocks' least / median / largest us after the
    first gate/up block's entry."""
    paths = build_variants(_cuda, "fused_mlp_block", {f"timeline {name}": B9_TIMELINE + B9_VARIANTS[name]
                                                       for name in B9_TIMELINE_OF})
    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    points = [p for p in b9_points() if p[0] in ("1b bs1", "1b rows16", "8b bs1")]
    try:
        for (variant, path), (label, m, rows) in ((v, p) for v in paths.items() for p in points):
            use(_cuda, "fused_mlp_block", path)
            lib = _cuda._libs["fused_mlp_block"]
            args = b9_inputs(torch, gen, m, rows)
            label = f"{variant} {label}"
            chip_smoke.check_fused_mlp(torch, db, args, "silu", label)
            runs = []
            for _ in range(5):
                db.fused_mlp_block(*args, eps=chip_smoke.FUSED_EPS)
                torch.cuda.synchronize()
                lib.nxdi_tl_clear()
                flush.zero_()
                torch.cuda._sleep(chip_smoke.SPIN_CYCLES)
                db.fused_mlp_block(*args, eps=chip_smoke.FUSED_EPS)
                torch.cuda.synchronize()
                buf = (ctypes.c_ulonglong * 16384)()
                lib.nxdi_tl_read(buf)
                t = np.array(buf, dtype=np.float64).reshape(-1, 16)[:, : len(B9_STAMPS)]
                t0 = t[:512, 0][t[:512, 0] > 0].min()
                runs.append((t[:512], t[512:], t0))
            for which, k in (("gate/up", 0), ("down", 1)):
                blocks = np.concatenate([(r[k][r[k][:, 0] > 0] - r[2]) / 1e3 for r in runs])
                parts = []
                for j, stamp in enumerate(B9_STAMPS):
                    col = blocks[:, j][blocks[:, j] > -1e6]
                    if len(col):
                        parts.append(f"{stamp} {col.min():.2f}/{np.median(col):.2f}/{col.max():.2f}")
                print(f"B9 timeline {label} {which}: {len(blocks) // 5} blocks, us after the first gate/up entry "
                      f"(least/median/largest): " + ", ".join(parts), flush=True)
            del args
            torch.cuda.empty_cache()
    finally:
        _cuda._libs.pop("fused_mlp_block", None)
        for key in [k for k in _cuda._fns if k[0] == "fused_mlp_block"]:
            del _cuda._fns[key]


def time_clean(torch, fn, iters=40, warmup=5):
    """chip_smoke.time_ms with the L2 evicted by a 64 MiB read instead of a
    write: the lines left in L2 are clean, so a kernel that reads its
    weights does not also write back the flush's dirty lines (as on the
    main path, where the kernels before it mostly read)."""
    import chip_smoke

    flush = torch.ones(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        flush.max()
        torch.cuda._sleep(chip_smoke.SPIN_CYCLES)
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def b9_points():
    """(label, widths, rows) of B9's timed points: the 1B MLP at 1, 4, 16
    and 64 rows and the 8B MLP at 1 row (ops/roofline.FUSED_POINTS and the
    64-row point)."""
    from neuronx_distributed_inference_tpu_torch.ops.roofline import MODEL_1B, MODEL_8B

    return [("1b bs1", MODEL_1B, 1), ("1b bs4", MODEL_1B, 4), ("1b rows16", MODEL_1B, 16),
            ("1b rows64", MODEL_1B, 64), ("8b bs1", MODEL_8B, 1)]


def b9_inputs(torch, gen, m, rows):
    """B9's arguments at one decode step (bf16, K=1, weights of std 0.02)."""
    def rn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std).to(torch.bfloat16)

    H, I = m["H"], m["I"]
    return (rn(rows, 1, H), 1 + rn(H, std=0.1), rn(H, I, std=0.02), rn(H, I, std=0.02), rn(I, H, std=0.02))


def fused_mlp_times(torch, chip_smoke, _cuda, db):
    """B9's variants, and the built kernel under other split targets
    (GEMV_BLOCKS_PER_SM), at b9_points: device ms and us per launch."""
    paths = build_variants(_cuda, "fused_mlp_block", B9_VARIANTS)
    cols, target = db.GEMV_COLS, db.GEMV_BLOCKS_PER_SM
    runs = [(name, None) for name in paths]
    runs += [("built", t) for t in (1, 3, 4) if t != target] + [("cols64", 4)]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    try:
        for label, m, rows in b9_points():
            args = b9_inputs(torch, gen, m, rows)
            for name, blocks in runs:
                use(_cuda, "fused_mlp_block", paths[name])
                db.GEMV_COLS = B9_VARIANT_COLS.get(name, cols)
                db.GEMV_BLOCKS_PER_SM = blocks or target
                case = f"{label} {name}, {db.GEMV_BLOCKS_PER_SM} blocks an SM"
                chip_smoke.check_fused_mlp(torch, db, args, "silu", case)

                def f():
                    return db.fused_mlp_block(*args, eps=chip_smoke.FUSED_EPS)

                ms = chip_smoke.time_ms(torch, f)
                clean = time_clean(torch, f)
                us = chip_smoke.launch_breakdown(torch, f, chip_smoke.B9_LAUNCHES)
                print(f"B9 {case}: {ms:.4f} ms (clean L2 {clean:.4f}); device us per launch: "
                      + ", ".join(f"{k} {v:.2f}" for k, v in us.items()), flush=True)
            del args
            torch.cuda.empty_cache()
    finally:
        db.GEMV_COLS, db.GEMV_BLOCKS_PER_SM = cols, target
        _cuda._libs.pop("fused_mlp_block", None)  # the next call loads the kernel as built
        for key in [k for k in _cuda._fns if k[0] == "fused_mlp_block"]:
            del _cuda._fns[key]


def fused_points(torch, chip_smoke, db):
    """B9 as built at b9_points and B8 at the 1B layer's batch 1 and 4
    (chip_smoke.fused_timed_inputs): device ms and us per launch. Uses only
    what earlier trees also have: copy this script into a parent checkout
    and run parent, change, change, parent in one call."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    for B in (1, 4):
        args, _ = chip_smoke.fused_timed_inputs(torch, gen, B)
        kw = dict(scale=args[6].shape[-1] ** -0.5, eps=chip_smoke.FUSED_EPS, n_kv=args[6].shape[3])
        chip_smoke.check_fused_attn(torch, db, args, f"points B8 B={B}")

        def f():
            return db.fused_attn_block(*args, **kw)

        ms, clean = chip_smoke.time_ms(torch, f), time_clean(torch, f)
        us = chip_smoke.launch_breakdown(torch, f, chip_smoke.B8_LAUNCHES)
        print(f"points B8 1b B={B}: {ms:.4f} ms (clean L2 {clean:.4f}); device us per launch: "
              + ", ".join(f"{k} {v:.2f}" for k, v in us.items()), flush=True)
        del args
    for label, m, rows in b9_points():
        args = b9_inputs(torch, gen, m, rows)
        chip_smoke.check_fused_mlp(torch, db, args, "silu", f"points B9 {label}")

        def g():
            return db.fused_mlp_block(*args, eps=chip_smoke.FUSED_EPS)

        ms, clean = chip_smoke.time_ms(torch, g), time_clean(torch, g)
        us = chip_smoke.launch_breakdown(torch, g, chip_smoke.B9_LAUNCHES)
        print(f"points B9 {label}: {ms:.4f} ms (clean L2 {clean:.4f}); device us per launch: "
              + ", ".join(f"{k} {v:.2f}" for k, v in us.items()), flush=True)
        del args
        torch.cuda.empty_cache()


def ragged_times(torch, chip_smoke, _cuda, rp):
    """B3's decode-tile split rule against fixed splits and no split."""
    from neuronx_distributed_inference_tpu_torch.ops.roofline import RAGGED_POINTS

    rule = rp.ragged_decode_split
    points = dict(RAGGED_POINTS)
    points["decode 1000 deep"] = dict(row_len=(1,) * 8, ctx_len=(1000,) * 8, width=1024, block_size=32)
    rng = np.random.RandomState(8)
    try:
        for name, pt in points.items():
            bs, width = pt["block_size"], pt["width"]
            inputs = chip_smoke.ragged_case(
                torch, rng, list(pt["row_len"]), list(pt["ctx_len"]), 32, 8, 64, bs, width // bs, torch.bfloat16,
                NB=512,
            )
            q, k, v, table, rs, rl, cl, _ = inputs
            kw = dict(scale=0.125, n_rep=4)
            for per in (None, 64, 128, 256, width):
                rp.ragged_decode_split = rule if per is None else (lambda T, w, h, n, s, per=per: (-(-w // per), per))
                split = rp.ragged_decode_split(q.shape[0], width, 8, 4, _cuda.sm_count(q.device))
                case = f"{name} point, {'rule' if per is None else 'fixed'} {split[0]} splits of {split[1]}"
                chip_smoke.check_ragged(torch, rp, inputs, case, chip_smoke.DECODE_ATOL)
                ms = chip_smoke.time_ms(torch, lambda: rp.ragged_paged_attention(q, k, v, table, rs, rl, cl, **kw))
                print(f"B3 {case}: {ms:.4f} ms", flush=True)
    finally:
        rp.ragged_decode_split = rule


def host_us(torch, fn, label):
    """The least and the median of 7 runs of 200 calls enqueued back to
    back, host microseconds per call."""
    import time

    for _ in range(50):
        fn()
    runs = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        runs.append((time.perf_counter() - t0) / 200 * 1e6)
    runs.sort()
    print(f"{label}: us per call enqueued, least {runs[0]:.2f}, median {runs[3]:.2f}", flush=True)


def host(torch, chip_smoke, da, md):
    from neuronx_distributed_inference_tpu_torch.ops.roofline import MOE_POINTS

    q, k, v, bt, mask = chip_smoke.serving_decode_inputs(torch, np.random.RandomState(5), 192)
    kw = dict(scale=q.shape[3] ** -0.5, n_kv=k.shape[2])
    host_us(torch, lambda: da.paged_tkg_decode_attention(q, k, v, 0, bt, mask, None, **kw),
            "B4 host B=8 ctx=192 bs=32 width=1024")
    del q, k, v
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    for label, pt in MOE_POINTS.items():
        m, T = pt["m"], pt["tokens"]
        args = chip_smoke.moe_inputs(torch, gen, T, m["k"], m["E"], m["H"], m["I"], torch.bfloat16)
        if label == "qwen3 bs1":
            host_us(torch, lambda: md.fused_moe_decode(*args), f"B7 host {label}")
        ms = chip_smoke.time_ms(torch, lambda: md.fused_moe_decode(*args))
        print(f"B7 {label}: {ms:.4f} ms; device us per launch: "
              f"{launch_us(torch, chip_smoke, lambda: md.fused_moe_decode(*args))}", flush=True)
        del args
        torch.cuda.empty_cache()


def tok(torch, chip_smoke):
    import time

    from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM
    from neuronx_distributed_inference_tpu_torch.telemetry import TelemetrySession

    s = chip_smoke.SERVING
    app = ModelForCausalLM(None, chip_smoke._serving_config()).load(random_weights=True).warmup()
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, app.spec.vocab_size - 10, size=(s["prompt"],)).tolist() for _ in range(s["n_requests"])]
    chip_smoke._serve(torch, app, prompts, s["gen"], TelemetrySession())  # warm pass
    for i in range(2):
        sess, total_s = chip_smoke._serve(torch, app, prompts, s["gen"], TelemetrySession())
        tokens = sum(len(r.generated) for r in sess.requests.values())
        print(f"tok split serving drain #{i}: {total_s * 1e3:.1f} ms, aggregate {tokens / total_s:.1f} tok/s",
              flush=True)
    del app, sess
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    app = ModelForCausalLM(None, chip_smoke._config_qwen3()).load(random_weights=True).warmup()
    print(f"tok qwen3-30b-a3b load + warmup {time.perf_counter() - t0:.1f} s", flush=True)
    for i in range(2):
        chip_smoke._generate_run(torch, app, 128, 256, f"tok qwen3-30b-a3b generate() #{i}")


def tok_ragged_fused(torch, chip_smoke):
    """The sync ragged drain's aggregate tok/s (B3 on every layer of every
    step) twice, and Llama-3.2-1B generate() at batch 4 with the fused
    decode layer on (B8 and B9 on every decode layer) twice, random weights
    from seed 0. Uses only what earlier trees also have: run parent,
    change, change, parent in one call."""
    from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM
    from neuronx_distributed_inference_tpu_torch.telemetry import TelemetrySession

    s = chip_smoke.SERVING
    cfg = chip_smoke._serving_config(serving_ragged=True, serving_ragged_async=False)
    app = ModelForCausalLM(None, cfg).load(random_weights=True).warmup()
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, app.spec.vocab_size - 10, size=(s["prompt"],)).tolist() for _ in range(s["n_requests"])]
    chip_smoke._serve(torch, app, prompts, s["gen"], TelemetrySession())  # warm pass
    for i in range(2):
        sess, total_s = chip_smoke._serve(torch, app, prompts, s["gen"], TelemetrySession())
        tokens = sum(len(r.generated) for r in sess.requests.values())
        print(f"tok sync ragged drain #{i}: {total_s * 1e3:.1f} ms, aggregate {tokens / total_s:.1f} tok/s",
              flush=True)
    del app, sess
    torch.cuda.empty_cache()
    app = ModelForCausalLM(None, chip_smoke._config_fused(4, True)).load(random_weights=True).warmup()
    for i in range(2):
        chip_smoke._generate_run(torch, app, 128, 256, f"tok 1b fused generate() #{i}", batch=4)


def b6_host(torch, chip_smoke, qmm):
    import time

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for K, N in ((4096, 4096), (14336, 4096)):
        packed, scale = chip_smoke.qmm_inputs(torch, gen, K, N)
        x = torch.randn((1, K), generator=gen, device="cuda").to(torch.bfloat16)
        for _ in range(50):
            qmm.quant_matmul(x, packed, scale)
        runs = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                qmm.quant_matmul(x, packed, scale)
            runs.append((time.perf_counter() - t0) / 200 * 1e6)
        runs.sort()
        print(f"B6 host K={K} N={N} 1 row: us per call enqueued, least {runs[0]:.2f}, median {runs[3]:.2f}",
              flush=True)
    from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM

    app = ModelForCausalLM(None, chip_smoke._config_8b_int4()).load(random_weights=True).warmup()
    for i in range(2):
        chip_smoke._generate_run(torch, app, 128, 256, f"B6 host int4 8B generate() #{i}")


def main():
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("torch_attention_variants: no CUDA device visible to torch", file=sys.stderr)
        sys.exit(2)
    import chip_smoke
    from neuronx_distributed_inference_tpu_torch.ops import _cuda
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention as da
    from neuronx_distributed_inference_tpu_torch.ops import flash_attention as fa
    from neuronx_distributed_inference_tpu_torch.ops import moe_decode as md
    from neuronx_distributed_inference_tpu_torch.ops import quant_matmul as qmm
    from neuronx_distributed_inference_tpu_torch.ops import ragged_paged_attention as rp
    from neuronx_distributed_inference_tpu_torch.ops import decode_block as db

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    parts = set(sys.argv[1:]) or {"b2", "b1", "b4", "b6", "b7", "b8", "b9", "b3"}
    print(f"tree: {REPO}", flush=True)
    if "b2" in parts:
        flash_times(torch, chip_smoke, _cuda, fa)
    if "b1" in parts:
        decode_times(torch, chip_smoke, _cuda, da)
    if "b6" in parts:
        qmm_times(torch, chip_smoke, _cuda, qmm)
    if "b4" in parts:
        paged_times(torch, chip_smoke, _cuda, da)
    if "b7" in parts:
        moe_times(torch, chip_smoke, _cuda, md)
    if "b8" in parts:
        fused_attn_times(torch, chip_smoke, _cuda, db)
    if "b9" in parts:
        fused_mlp_times(torch, chip_smoke, _cuda, db)
    if "b9timeline" in parts:
        fused_mlp_timeline(torch, chip_smoke, _cuda, db)
    if "points" in parts:
        fused_points(torch, chip_smoke, db)
    if "b8timeline" in parts:
        fused_attn_timeline(torch, chip_smoke, _cuda, db)
    if "b3" in parts:
        ragged_times(torch, chip_smoke, _cuda, rp)
    if "b6host" in parts:
        b6_host(torch, chip_smoke, qmm)
    if "host" in parts:
        host(torch, chip_smoke, da, md)
    if "tok" in parts:
        tok(torch, chip_smoke)
    if "tok10" in parts:
        tok_ragged_fused(torch, chip_smoke)


if __name__ == "__main__":
    main()
