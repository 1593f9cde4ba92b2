"""Time design alternatives of the PyTorch/CUDA port's attention kernels B1
and B4 (decode over the contiguous and the paged cache,
``csrc/decode_attention.cu``) and B2 (prefill flash,
``csrc/flash_attention.cu``), of the int4 matmul B6
(``csrc/quant_matmul.cu``) and of the MoE decode B7
(``csrc/moe_decode.cu``), on one H100, beside the kernels as built.

    python3 scripts/torch_attention_variants.py [b2] [b1] [b4] [b6] [b7] [b6host] [host] [tok]

(no argument: b2, b1, b4, b6 and b7)

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
host: B4's and B7's host cost, the wrapper's microseconds per call
  enqueued back to back (least and median of 7 runs of 200) at B4's timed
  shape and B7's Qwen3 batch 1, and B7's device time and us per launch
  at its three timed points.
tok: the split serving drain (8 staggered requests of 128 + 128 tokens,
  Llama-3.2-1B shapes, bf16, random weights: aggregate tok/s) twice and
  Qwen3-30B-A3B generate() (batch 1, 128 + 256 tokens, random weights at
  full depth: decode tok/s) twice.
host and tok, like b6host, use only what earlier trees also have: run
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
    (each must match), one nvcc per variant, all started together."""
    src = (_cuda.CSRC / f"{kernel}.cu").read_text()
    procs, paths = {}, {}
    for name, patches in variants.items():
        text = src
        for old, new in patches:
            if old not in text:
                raise SystemExit(f"{kernel} variant {name}: the source no longer holds {old[:60]!r}")
            text = text.replace(old, new)
        d = _cuda.BUILD_ROOT / "variants" / kernel / name
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{kernel}.cu").write_text(text)
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
    "no-pdl": [("  cfg.numAttrs = after ? 1 : 0;", "  cfg.numAttrs = 0;")],
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

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    parts = set(sys.argv[1:]) or {"b2", "b1", "b4", "b6", "b7"}
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
    if "b6host" in parts:
        b6_host(torch, chip_smoke, qmm)
    if "host" in parts:
        host(torch, chip_smoke, da, md)
    if "tok" in parts:
        tok(torch, chip_smoke)


if __name__ == "__main__":
    main()
