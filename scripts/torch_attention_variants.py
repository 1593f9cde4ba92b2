"""Time design alternatives of the PyTorch/CUDA port's attention kernels B1
(decode, ``csrc/decode_attention.cu``) and B2 (prefill flash,
``csrc/flash_attention.cu``) on one H100, beside the kernels as built.

    python3 scripts/torch_attention_variants.py

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
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{kernel} variant {name} does not build:\n{log}")
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

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    flash_times(torch, chip_smoke, _cuda, fa)
    decode_times(torch, chip_smoke, _cuda, da)


if __name__ == "__main__":
    main()
