"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device: the card's name and power limit, torch, compute capability 9.0;
  2. build: every CUDA kernel source with nvcc from the package's csrc/, one
     nvcc per source, all started together (ptxas report);
  3. each kernel against its plain PyTorch version on the card, over shapes,
     dtypes, masks and modes, the main paths' shapes and layouts among them,
     with the tolerance printed beside the error: prefill flash (B2), decode
     (B1), paged decode (B4), paged flash prefill (B5) and ragged paged
     attention (B3), the paged ones with NaN in the garbage block 0,
     zero-table tails and inactive rows;
  4. kernel times at the main paths' shapes and layouts (CUDA events, L2
     flushed before each launch), each held to its plain version first,
     beside the plain version, one PyTorch library call, and the card's
     bound for the same work;
  5. the generate() path at full width: Llama-3.2-1B shapes with seeded
     random weights, bf16, greedy generate() of 256 tokens after a 128-token
     prompt at batch 1 (launch counts asserted), a right-padded batch-2
     call, a profiler trace of one decode chunk, and a teacher-forced
     comparison of the kernel path's logits with the plain path's and with
     fp32;
  6. the serving path at full width: a ServingSession over the paged cache
     with chunked prefill (8 slots, 512 blocks of 32, 8 staggered requests
     of 128 + 128 tokens; launch counts asserted from the session's own
     dispatch count), a short paged run admitting through the context
     encoding program, and a teacher-forced check of the paged path;
  7. the ragged mixed-step serving path at full width: the same traffic
     through ServingSession(serving_ragged=True), synchronous and 1-ahead
     (launch counts asserted: B3 16 times per mixed dispatch, nothing else),
     a short run admitting through the context program, a teacher-forced
     check of mixed_forward, and a profile of 16 steady-state steps.
Each phase prints its seconds. The line before the card's name lists every
kernel with its launches, times and bound; the last line of standard output
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "neuronx_distributed_inference_tpu_torch"


def log(*args):
    print(*args, flush=True)


def expect_launches(**nonzero):
    """The launch counts a run must show: ``nonzero`` by kernel name, every
    other kernel of ops/_cuda.py 0."""
    from neuronx_distributed_inference_tpu_torch.ops import _cuda

    return {**{name: 0 for name in _cuda.KERNELS}, **nonzero}


def plain_run(what, fn, *args):
    """``fn(*args)`` with every launch count read around it: a plain-path
    run must launch no kernel, or a check against it would compare a kernel
    with itself."""
    from neuronx_distributed_inference_tpu_torch.ops import _cuda

    _cuda.reset_launch_counts()
    out = fn(*args)
    if _cuda.launch_counts() != expect_launches():
        raise SystemExit(f"{what}: the plain run launched kernels: {_cuda.launch_counts()}")
    return out


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------


def phase_device(torch):
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    cap = torch.cuda.get_device_capability(0)
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} capability {cap}")
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability (9, 0), got {cap}")
    return smi


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def time_ms(torch, fn, iters=40, warmup=5):
    """Mean device time of ``fn`` over ``iters`` launches, each timed by its
    own CUDA events after a 64 MiB write that evicts the 50 MB L2 (on the
    main path, each attention call follows ~100 MB of weight traffic)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        flush.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def bound(nbytes, flops):
    """The card's least time for bf16 work (ops/roofline.py)."""
    from neuronx_distributed_inference_tpu_torch.ops.roofline import bound_ms

    return bound_ms(nbytes, flops)


def flash_work(q, k, key_valid, mask):
    """Bytes (q, k, v, key_valid read once; out, m, l written once) and the
    FLOPs these inputs need (4 * D per allowed (row, key) pair per head)."""
    B, S, Hq, D = q.shape
    e = q.element_size()
    nbytes = (2 * q.numel() + 2 * k.numel()) * e + key_valid.numel() * 4 + 2 * B * Hq * S * 4
    flops = 4 * D * Hq * int(mask.sum().item())
    return nbytes, flops


def decode_work(q, k_cache, mask):
    """Bytes of the cache positions the mask needs (K and V, one layer),
    q, out and the mask; FLOPs 4 * D per allowed (row, position) per head."""
    B, K, Hq, D = q.shape
    Hkv = k_cache.shape[3]
    e = q.element_size()
    positions = int(mask[:, 0].any(dim=1).sum().item())  # (batch row, position) pairs read
    nbytes = 2 * positions * Hkv * D * k_cache.element_size() + 2 * q.numel() * e + mask.numel()
    flops = 4 * D * Hq * int(mask.sum().item())
    return nbytes, flops


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------

M_TOL = 1e-3  # flash row max, absolute


def flash_tolerances(torch, dtype, softmax_bf16):
    """(out, l relative) tolerances of one flash case; m is held to M_TOL."""
    if softmax_bf16:
        return 3e-2, 2e-2
    return (1.5e-2 if dtype == torch.bfloat16 else 1e-4), 1e-4


def check_flash(torch, fa, q, k, v, key_valid, kw, case):
    """One flash case, kernel against plain on the same inputs: out on the
    rows that have a valid key, and the row stats m and l. Returns the out
    error; exits past a tolerance."""
    out, m, l = fa.flash_attention_fwd(q, k, v, key_valid, **kw)
    ref, m_ref, l_ref = fa.flash_attention_plain(q, k, v, key_valid, **kw)
    torch.cuda.synchronize()
    rows = fa.prefill_mask(key_valid, kw["causal"], kw["window"], kw["chunk"])[:, 0].any(dim=-1)
    err = (out.float() - ref.float()).abs().amax(dim=(2, 3))[rows].max().item()
    m_err = (m - m_ref).abs().transpose(1, 2)[rows].max().item()
    l_rel = ((l - l_ref).abs() / l_ref.clamp(min=1e-30)).transpose(1, 2)[rows].max().item()
    tol, l_tol = flash_tolerances(torch, q.dtype, kw["softmax_bf16"])
    ok = err <= tol and m_err <= M_TOL and l_rel <= l_tol
    log(
        f"  flash {case}: out err {err:.3e} (tol {tol:.1e}), m err {m_err:.1e} (tol {M_TOL:.0e}), "
        f"l rel err {l_rel:.1e} (tol {l_tol:.1e}) {'ok' if ok else 'FAIL'}"
    )
    if not ok:
        raise SystemExit(f"flash_attention disagrees with its plain version: {case}")
    return err


def fused_qkv_inputs(torch, rng, B, S, Hq, Hkv, D, dtype, hidden=2048):
    """q, k, v as the main path hands them to the flash kernel: qkv_project
    over one fused (hidden, (Hq + 2 Hkv) D) weight, so v is a split view
    with token stride (Hq + 2 Hkv) D and q, k carry RoPE."""
    from neuronx_distributed_inference_tpu_torch.modules.attention import AttnSpec, qkv_project
    from neuronx_distributed_inference_tpu_torch.modules.rope import default_inv_freq, rope_cos_sin

    x = torch.from_numpy(rng.randn(B, S, hidden).astype(np.float32)).to("cuda", dtype)
    w = torch.from_numpy(
        rng.randn(hidden, (Hq + 2 * Hkv) * D).astype(np.float32) * (0.5 / hidden ** 0.5)
    ).to("cuda", dtype)  # q, k, v entries of std ~0.5
    pos = torch.arange(S, device="cuda")[None, :].expand(B, S)
    cos, sin = rope_cos_sin(pos, default_inv_freq(D, 500000.0).cuda())
    spec = AttnSpec(num_heads=Hq, num_kv_heads=Hkv, head_dim=D)
    q, k, v = qkv_project({"qkv_proj": {"weight": w}}, x, cos, sin, spec)
    if v.stride(1) != (Hq + 2 * Hkv) * D:
        raise SystemExit(f"v is not the fused projection's split view: strides {v.stride()}")
    return q, k, v


def phase_flash_parity(torch, fa):
    rng = np.random.RandomState(0)
    worst = 0.0
    n = 0
    for D in (64, 128):
        for n_rep in (1, 4):
            for dtype in (torch.bfloat16, torch.float32):
                for S in (128, 512, 1000):
                    for flavor in ("causal", "window", "chunk"):
                        for softmax_bf16 in (False, True):
                            B, Hkv = 2, 2
                            Hq = Hkv * n_rep
                            q, k, v = (
                                torch.from_numpy(rng.randn(B, S, h, D).astype(np.float32) * 0.5)
                                .to("cuda", dtype)
                                for h in (Hq, Hkv, Hkv)
                            )
                            kv = np.ones((B, S), np.int32)
                            kv[1, int(S * 0.6):] = 0  # ragged key validity
                            key_valid = torch.from_numpy(kv).cuda()
                            kw = dict(
                                scale=D ** -0.5, causal=True, softmax_bf16=softmax_bf16,
                                window=100 if flavor == "window" else None,
                                chunk=96 if flavor == "chunk" else None,
                            )
                            case = f"D={D} n_rep={n_rep} {str(dtype)[6:]} S={S} {flavor} softmax_bf16={softmax_bf16}"
                            worst = max(worst, check_flash(torch, fa, q, k, v, key_valid, kw, case))
                            n += 1
    # the main path's shapes and layout: 32 q / 8 kv heads, D=64, the CTE
    # buckets, q/k/v straight out of the fused projection; batch 2 has a
    # right-padded row as the batch-2 generate() call does
    for dtype in (torch.bfloat16, torch.float32):
        for S in (128, 512):
            for B in (1, 2):
                for softmax_bf16 in (False, True):
                    q, k, v = fused_qkv_inputs(torch, rng, B, S, 32, 8, 64, dtype)
                    kv = np.ones((B, S), np.int32)
                    if B == 2:
                        kv[1, int(S * 0.6):] = 0
                    key_valid = torch.from_numpy(kv).cuda()
                    kw = dict(scale=0.125, causal=True, softmax_bf16=softmax_bf16, window=None, chunk=None)
                    case = (
                        f"main-path layout B={B} S={S} Hq=32 Hkv=8 D=64 {str(dtype)[6:]} "
                        f"softmax_bf16={softmax_bf16} v strides {v.stride()}"
                    )
                    worst = max(worst, check_flash(torch, fa, q, k, v, key_valid, kw, case))
                    n += 1
    log(f"flash_attention: {n} cases agree with the plain version (largest out err {worst:.3e})")


# Decode: the queries are scaled so that the scores have a standard deviation
# of about 3, which puts most of each row's softmax weight on a few positions:
# a skipped or doubled tile then moves the output by far more than the
# tolerance. The plain version runs in fp32 on the same (bf16-valued) inputs.
# The kernel computes in fp32 and rounds once to the output dtype, so a bf16
# output may sit up to half a bf16 ulp, at most 2^-8 of its value, from it.
DECODE_Q_STD = 6.0
DECODE_ATOL = 1e-4
DECODE_RTOL_BF16 = 2.0 ** -8


def _decode_inputs(torch, rng, B, K, Hq, Hkv, D, L, S_max, bucket, dtype, valid, window=None):
    q = torch.from_numpy(rng.randn(B, K, Hq, D).astype(np.float32) * DECODE_Q_STD).to("cuda", dtype)
    kc = torch.from_numpy(rng.randn(L, B + 1, S_max, Hkv, D).astype(np.float32) * 0.5).to("cuda", dtype)
    vc = torch.from_numpy(rng.randn(L, B + 1, S_max, Hkv, D).astype(np.float32) * 0.5).to("cuda", dtype)
    pos = np.stack([np.arange(valid[b] - K, valid[b]) for b in range(B)])  # (B, K)
    cols = np.arange(bucket)[None, None, :]
    mask = cols <= pos[:, :, None]
    if window is not None:
        mask &= cols > pos[:, :, None] - window
    return q, kc, vc, torch.from_numpy(mask[:, None]).cuda()


def check_close(torch, out, ref, case, what, rows=None, atol=DECODE_ATOL):
    """Kernel output against the plain version in fp32 on the same input
    values, within one rounding of the output dtype: the bound is
    atol + rtol * |plain| with rtol 2^-8 for bf16 (half a bf16 ulp), 0 for
    fp32. ``rows`` (a bool mask over the leading dims) limits the check to
    rows that have a valid key. Returns the max abs error; exits past it."""
    rtol = DECODE_RTOL_BF16 if out.dtype == torch.bfloat16 else 0.0
    o, r = out.float(), ref.float()
    if not torch.isfinite(o).all():
        raise SystemExit(f"{what} returned non-finite values: {case}")
    if rows is not None:
        o, r = o[rows], r[rows]
    diff = (o - r).abs()
    err = diff.max().item()
    use = (diff / (atol + rtol * r.abs())).max().item()
    ok = use <= 1.0
    log(
        f"  {what} {case}: max abs err {err:.3e}, largest share of the bound (atol {atol:.0e} "
        f"+ rtol {rtol:.2e} x |plain|) {use:.3f}, |plain| up to {r.abs().max().item():.3f} {'ok' if ok else 'FAIL'}"
    )
    if not ok:
        raise SystemExit(f"{what} disagrees with its plain version: {case}")
    return err


def check_decode(torch, da, q, kc, vc, layer, mask, sink, kw, case):
    """One decode case, kernel against the plain version in fp32 on the
    same input values, within check_close's one-rounding bound."""
    out = da.tkg_decode_attention(q, kc, vc, layer, mask, sink, **kw)
    ref = da.tkg_decode_attention_plain(q.float(), kc.float(), vc.float(), layer, mask, sink, **kw)
    torch.cuda.synchronize()
    return check_close(torch, out, ref, case, "tkg_decode_attention")


def phase_decode_parity(torch, da):
    rng = np.random.RandomState(1)
    worst = 0.0
    n = 0
    for D in (64, 128):
        for dtype in (torch.bfloat16, torch.float32):
            for K in (1, 4):
                for bucket in (512, 1024):
                    for sink in (False, True):
                        for window in (None, 200):
                            B, Hq, Hkv, L = 2, 32, 8, 3
                            # row 1 uses 90 positions: tiles past the first two are dead
                            valid = [bucket - 7, 90]
                            q, kc, vc, mask = _decode_inputs(
                                torch, rng, B, K, Hq, Hkv, D, L, 1024, bucket, dtype, valid, window
                            )
                            sk = torch.from_numpy(rng.randn(Hq).astype(np.float32)).cuda() if sink else None
                            kw = dict(scale=D ** -0.5, n_kv=Hkv)
                            case = f"D={D} {str(dtype)[6:]} K={K} bucket={bucket} sink={sink} window={window}"
                            worst = max(worst, check_decode(torch, da, q, kc, vc, 1, mask, sk, kw, case))
                            n += 1
    log(f"tkg_decode_attention: {n} cases agree with the plain version (largest abs err {worst:.3e})")


# ---------------------------------------------------------------------------
# 4. kernel times at the main path's shapes
# ---------------------------------------------------------------------------


def phase_times(torch, fa, da):
    """Each kernel at the main path's shapes and layout, held to its plain
    version with the parity phases' tolerances, then timed."""
    import torch.nn.functional as F

    from neuronx_distributed_inference_tpu_torch.modules.masks import token_gen_mask

    rows = {}
    rng = np.random.RandomState(2)
    B, Hq, Hkv = 1, 32, 8
    # the main path's two CTE buckets at head_dim 64 (the reference's packed
    # kernel), and the head_dim-128 instance (its unpacked kernel) at 512
    for S, D in ((128, 64), (512, 64), (512, 128)):
        q, k, v = fused_qkv_inputs(torch, rng, B, S, Hq, Hkv, D, torch.bfloat16)
        key_valid = torch.ones((B, S), dtype=torch.int32, device="cuda")
        kw = dict(scale=D ** -0.5, causal=True, softmax_bf16=False, window=None, chunk=None)
        err = check_flash(torch, fa, q, k, v, key_valid, kw, f"timed B=1 S={S} Hq=32 Hkv=8 D={D} bf16")
        qt = q.transpose(1, 2)
        kt = k.transpose(1, 2).repeat_interleave(Hq // Hkv, dim=1)
        vt = v.transpose(1, 2).repeat_interleave(Hq // Hkv, dim=1)
        ms = time_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, key_valid, **kw))
        plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v, key_valid, **kw))
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
        nbytes, flops = flash_work(q, k, key_valid, fa.prefill_mask(key_valid))
        b_ms, b_by = bound(nbytes, flops)
        rows[("flash_attention", S, D)] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err
        )
        log(
            f"flash_attention B=1 S={S} Hq=32 Hkv=8 D={D} bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), err vs plain {err:.3e}"
        )
    L, S_max, D = 16, 1024, 64
    for bucket in (512, 1024):
        valid = bucket - 100
        q, kc, vc, _ = _decode_inputs(
            torch, rng, B, 1, Hq, Hkv, D, L, S_max, bucket, torch.bfloat16, [valid]
        )
        # the main path's decode mask: token_gen_mask's broadcast view
        cols = torch.arange(bucket, device="cuda")[None, :]
        mask = token_gen_mask((cols < valid).to(torch.int32), 1)
        kw = dict(scale=D ** -0.5, n_kv=Hkv)
        state = {"layer": 0}

        def next_layer():
            state["layer"] = (state["layer"] + 1) % L
            return state["layer"]

        err = check_decode(
            torch, da, q, kc, vc, 0, mask, None, kw, f"timed B=1 K=1 bucket={bucket} valid={valid} D=64 bf16"
        )
        qt = q.transpose(1, 2)
        kt = kc[0, :B, :bucket].permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, dim=1)
        vt = vc[0, :B, :bucket].permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, dim=1)
        ms = time_ms(torch, lambda: da.tkg_decode_attention(q, kc, vc, next_layer(), mask, None, **kw))
        plain_ms = time_ms(torch, lambda: da.tkg_decode_attention_plain(q, kc, vc, next_layer(), mask, None, **kw))
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
        nbytes, flops = decode_work(q, kc, mask)
        b_ms, b_by = bound(nbytes, flops)
        rows[("decode_attention", bucket)] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err
        )
        log(
            f"tkg_decode_attention B=1 K=1 bucket={bucket} valid={valid} Hq=32 Hkv=8 D=64 bf16: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), "
            f"err vs plain {err:.3e}"
        )
    return rows


# ---------------------------------------------------------------------------
# 3b. the paged kernels (B4, B5) against their plain versions
# ---------------------------------------------------------------------------


def paged_pool(torch, rng, L, NB, Hkv, bs, D, dtype):
    """A head-major pool (L, NB+1, Hkv, bs, D) with NaN in garbage block 0."""
    k = torch.from_numpy(rng.randn(L, NB + 1, Hkv, bs, D).astype(np.float32) * 0.5)
    v = torch.from_numpy(rng.randn(L, NB + 1, Hkv, bs, D).astype(np.float32) * 0.5)
    k[:, 0] = float("nan")
    v[:, 0] = float("nan")
    return k.to("cuda", dtype), v.to("cuda", dtype)


def paged_tables(rng, lens, MB, bs, NB):
    """(B, MB) tables: distinct random blocks covering each row's length,
    zero tails (block 0) past it; a row of length 0 is all zeros."""
    table = np.zeros((len(lens), MB), np.int32)
    free = rng.permutation(np.arange(1, NB + 1))
    used = 0
    for b, n in enumerate(lens):
        nb = -(-int(n) // bs)
        table[b, :nb] = free[used : used + nb]
        used += nb
    return table


def phase_paged_decode_parity(torch, da):
    """B4 at batch 1 and 8, block size 16 and 32, D 64 and 128, Hq 32 / Hkv 8,
    bf16 and fp32, q_len 1 and (through the routing rule) 4: every case has
    NaN in block 0, zero-table tails, lengths that are not block multiples
    and, at batch 8, inactive rows (zero table, mask true only at position
    0, as the session's decode pass builds them)."""
    from neuronx_distributed_inference_tpu_torch.models.base import paged_attend
    from neuronx_distributed_inference_tpu_torch.modules.attention import AttnSpec
    from neuronx_distributed_inference_tpu_torch.modules.masks import spec_token_gen_mask
    from neuronx_distributed_inference_tpu_torch.ops import _cuda

    rng = np.random.RandomState(3)
    worst, n = 0.0, 0
    Hq, Hkv, L, MB = 32, 8, 2, 24
    for D in (64, 128):
        for bs in (16, 32):
            for dtype in (torch.bfloat16, torch.float32):
                for B in (1, 8):
                    for K in (1, 4):
                        NB = MB * B + 4
                        lens = [MB * bs - 5, 3 * bs + 7, 0, bs, 0, 5 * bs - 1, 11, 0][:B]
                        table = paged_tables(rng, lens, MB, bs, NB)
                        k, v = paged_pool(torch, rng, L, NB, Hkv, bs, D, dtype)
                        q = torch.from_numpy(rng.randn(B, K, Hq, D).astype(np.float32) * DECODE_Q_STD).to("cuda", dtype)
                        act = np.array(lens) > 0
                        pos = np.where(act[:, None], np.array(lens)[:, None] - K + np.arange(K)[None, :], 0)
                        attn = (np.arange(MB * bs)[None, :] < np.maximum(np.array(lens), 1)[:, None]).astype(np.int32)
                        mask = spec_token_gen_mask(torch.from_numpy(attn).cuda(), torch.from_numpy(pos).cuda())
                        bt = torch.from_numpy(table).cuda()
                        kw = dict(scale=D ** -0.5, n_kv=Hkv)
                        case = f"B={B} K={K} bs={bs} D={D} {str(dtype)[6:]}"
                        before = _cuda.launch_counts()["paged_decode_attention"]
                        if K == 1:
                            out = da.paged_tkg_decode_attention(q, k, v, 1, bt, mask, None, **kw)
                        else:
                            # q_len 4 < 8: the routing rule sends it to B4
                            spec = AttnSpec(num_heads=Hq, num_kv_heads=Hkv, head_dim=D)
                            out = paged_attend(
                                q, k, v, 1, mask, torch.from_numpy(pos).cuda(), bt,
                                torch.from_numpy(np.array(lens, np.int32)).cuda(), spec,
                            )
                        torch.cuda.synchronize()
                        if _cuda.launch_counts()["paged_decode_attention"] != before + 1:
                            raise SystemExit(f"paged decode case did not launch B4: {case}")
                        ref = da.paged_tkg_decode_attention_plain(q.float(), k.float(), v.float(), 1, bt, mask, None, **kw)
                        rows = torch.from_numpy(act).cuda()
                        worst = max(worst, check_close(torch, out, ref, case, "paged_tkg_decode_attention", rows))
                        n += 1
    log(f"paged_tkg_decode_attention: {n} cases agree with the plain version (largest abs err {worst:.3e})")


def phase_paged_flash_parity(torch, pf):
    """B5 at batch 1 and 8, block size 16 and 32, D 64 and 128, Hq 32 / Hkv 8,
    bf16 and fp32, Sq 128 (the serving row's chunk): prefix + causal, a
    kv_limit that is not a block multiple, zero-table tails, NaN in block 0
    and, at batch 8, kv_limit 0 rows, which must be exactly zero."""
    from neuronx_distributed_inference_tpu_torch.ops import _cuda

    rng = np.random.RandomState(4)
    worst, n = 0.0, 0
    Hq, Hkv, MB, Sq = 32, 8, 16, 128
    for D in (64, 128):
        for bs in (16, 32):
            for dtype in (torch.bfloat16, torch.float32):
                for B in (1, 8):
                    NB = MB * B + 4
                    starts = np.array([70, 0, 0, 200, 0, 3, 300, 0][:B])
                    news = np.array([Sq, Sq, 0, 41, 0, Sq - 9, 77, 0][:B])  # new tokens; 0 = inactive
                    limits = np.where(news > 0, starts + news, 0)
                    if (limits > MB * bs).any():
                        limits = np.minimum(limits, MB * bs)
                        starts = np.minimum(starts, np.maximum(limits - news, 0))
                    table = paged_tables(rng, limits, MB, bs, NB)
                    k, v = paged_pool(torch, rng, 1, NB, Hkv, bs, D, dtype)
                    k, v = k[0], v[0]
                    q = torch.from_numpy(rng.randn(B, Sq, Hq, D).astype(np.float32) * DECODE_Q_STD).to("cuda", dtype)
                    pos = torch.from_numpy((starts[:, None] + np.arange(Sq)[None, :]).astype(np.int32)).cuda()
                    lim = torch.from_numpy(limits.astype(np.int32)).cuda()
                    bt = torch.from_numpy(table).cuda()
                    kw = dict(scale=D ** -0.5, n_rep=Hq // Hkv)
                    case = f"B={B} Sq={Sq} bs={bs} D={D} {str(dtype)[6:]} kv_limit {limits.tolist()}"
                    before = _cuda.launch_counts()["paged_flash_attention"]
                    out = pf.paged_flash_attention(q, k, v, bt, pos, lim, **kw)
                    torch.cuda.synchronize()
                    if _cuda.launch_counts()["paged_flash_attention"] != before + 1:
                        raise SystemExit(f"paged flash case did not launch B5: {case}")
                    ref = pf.paged_flash_attention_plain(q.float(), k.float(), v.float(), bt, pos, lim, **kw)
                    if (out[torch.from_numpy(limits == 0).cuda()] != 0).any():
                        raise SystemExit(f"paged_flash_attention: a kv_limit-0 row is not zero: {case}")
                    # a query row has a valid key when its position and the limit allow one
                    rows = (pos >= 0) & (lim[:, None] > 0)
                    worst = max(worst, check_close(torch, out, ref, case, "paged_flash_attention", rows))
                    n += 1
    log(f"paged_flash_attention: {n} cases agree with the plain version (largest abs err {worst:.3e})")


def serving_decode_inputs(torch, rng, ctx, B=8, Hq=32, Hkv=8, D=64, bs=32, width=1024, L=16):
    """The serving row's decode step: B rows of ctx tokens each in a bs-block
    pool over a width-token bucket, q_len 1, bf16."""
    MB = width // bs
    NB = 512
    table = paged_tables(rng, [ctx] * B, MB, bs, NB)
    k = torch.from_numpy(rng.randn(L, NB + 1, Hkv, bs, D).astype(np.float32) * 0.5).to("cuda", torch.bfloat16)
    v = torch.from_numpy(rng.randn(L, NB + 1, Hkv, bs, D).astype(np.float32) * 0.5).to("cuda", torch.bfloat16)
    q = torch.from_numpy(rng.randn(B, 1, Hq, D).astype(np.float32) * DECODE_Q_STD).to("cuda", torch.bfloat16)
    from neuronx_distributed_inference_tpu_torch.modules.masks import token_gen_mask

    attn = (torch.arange(width, device="cuda")[None, :] < ctx).to(torch.int32).expand(B, width)
    return q, k, v, torch.from_numpy(table).cuda(), token_gen_mask(attn, 1)


def phase_paged_times(torch, da, pf):
    """B4 and B5 at the serving row's shapes, each held to its plain version
    first, beside the plain version, F.scaled_dot_product_attention on K/V
    gathered beforehand (the gather not timed; a yardstick only), and the
    bound for the same work."""
    import torch.nn.functional as F

    from neuronx_distributed_inference_tpu_torch.modules.block_kvcache import read_block_cache_at_layer

    rows = {}
    rng = np.random.RandomState(5)
    Hq, Hkv, D = 32, 8, 64
    # decode: 8 rows, mid-stream at 128 prompt + 64 generated tokens
    ctx = 192
    q, k, v, bt, mask = serving_decode_inputs(torch, rng, ctx)
    kw = dict(scale=D ** -0.5, n_kv=Hkv)
    out = da.paged_tkg_decode_attention(q, k, v, 0, bt, mask, None, **kw)
    ref = da.paged_tkg_decode_attention_plain(q.float(), k.float(), v.float(), 0, bt, mask, None, **kw)
    err = check_close(torch, out, ref, f"timed B=8 ctx={ctx} bs=32 bucket=1024 D=64 bf16", "paged_tkg_decode_attention")
    state = {"layer": 0}

    def next_layer():
        state["layer"] = (state["layer"] + 1) % k.shape[0]
        return state["layer"]

    k_r, v_r = read_block_cache_at_layer(k, v, 0, bt)
    kt = k_r.permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, dim=1)
    vt = v_r.permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, dim=1)
    qt = q.transpose(1, 2)
    ms = time_ms(torch, lambda: da.paged_tkg_decode_attention(q, k, v, next_layer(), bt, mask, None, **kw))
    plain_ms = time_ms(torch, lambda: da.paged_tkg_decode_attention_plain(q, k, v, next_layer(), bt, mask, None, **kw))
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
    B = q.shape[0]
    nbytes = 2 * B * ctx * Hkv * D * k.element_size() + 2 * q.numel() * q.element_size() + mask.numel() + bt.numel() * 4
    flops = 4 * D * Hq * int(mask.sum().item())
    b_ms, b_by = bound(nbytes, flops)
    rows["paged_decode_attention"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
    log(
        f"paged_tkg_decode_attention B=8 ctx={ctx} bs=32 bucket=1024 Hq=32 Hkv=8 D=64 bf16: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), err vs plain {err:.3e}"
    )
    del k, v, k_r, v_r, kt, vt

    # chunk pass: 8 rows each prefilling a 128-token prompt (start 0,
    # kv_limit 128), the serving row's admission chunks, bucket 1024
    B, Sq, bs, width, NB = 8, 128, 32, 1024, 512
    MB = width // bs
    table = paged_tables(rng, [Sq] * B, MB, bs, NB)
    k = torch.from_numpy(rng.randn(NB + 1, Hkv, bs, D).astype(np.float32) * 0.5).to("cuda", torch.bfloat16)
    v = torch.from_numpy(rng.randn(NB + 1, Hkv, bs, D).astype(np.float32) * 0.5).to("cuda", torch.bfloat16)
    q = torch.from_numpy(rng.randn(B, Sq, Hq, D).astype(np.float32) * DECODE_Q_STD).to("cuda", torch.bfloat16)
    bt = torch.from_numpy(table).cuda()
    pos = torch.arange(Sq, device="cuda", dtype=torch.int32)[None, :].expand(B, Sq).contiguous()
    lim = torch.full((B,), Sq, device="cuda", dtype=torch.int32)
    kw = dict(scale=D ** -0.5, n_rep=Hq // Hkv)
    out = pf.paged_flash_attention(q, k, v, bt, pos, lim, **kw)
    ref = pf.paged_flash_attention_plain(q.float(), k.float(), v.float(), bt, pos, lim, **kw)
    err = check_close(torch, out, ref, "timed B=8 Sq=128 kv_limit=128 bs=32 bucket=1024 D=64 bf16", "paged_flash_attention")
    k_r, v_r = read_block_cache_at_layer(k[None], v[None], 0, bt)
    kt = k_r.permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, dim=1)
    vt = v_r.permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, dim=1)
    qt = q.transpose(1, 2)
    cols = torch.arange(width, device="cuda")[None, None, None, :]
    smask = (cols <= pos[:, None, :, None]) & (cols < lim[:, None, None, None])
    ms = time_ms(torch, lambda: pf.paged_flash_attention(q, k, v, bt, pos, lim, **kw))
    plain_ms = time_ms(torch, lambda: pf.paged_flash_attention_plain(q, k, v, bt, pos, lim, **kw))
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=smask))
    nbytes = (2 * q.numel() + 2 * B * Sq * Hkv * D) * q.element_size() + (pos.numel() + lim.numel() + bt.numel()) * 4
    flops = 4 * D * Hq * int(smask.sum().item())
    b_ms, b_by = bound(nbytes, flops)
    rows["paged_flash_attention"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
    log(
        f"paged_flash_attention B=8 Sq=128 kv_limit=128 bs=32 bucket=1024 Hq=32 Hkv=8 D=64 bf16: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), err vs plain {err:.3e}"
    )
    return rows


# ---------------------------------------------------------------------------
# 3c. the ragged kernel (B3) against its plain version
# ---------------------------------------------------------------------------

RAGGED_FP32_ATOL = 1e-5


def ragged_case(torch, rng, row_len, ctx_len, Hq, Hkv, D, bs, MB, dtype, NB=None):
    """One ragged launch's inputs: rows of ``row_len`` new tokens over
    ``ctx_len`` positions packed in 16-aligned segments (an inactive row
    starts at 0 when it is the first, past the packed end otherwise), a
    one-layer pool with NaN in block 0, tables covering each row's context
    (zero tails), q with sharpened scores. Returns (q, k, v, table,
    row_start, row_len, ctx_len, valid slots), on the card."""
    from neuronx_distributed_inference_tpu_torch.ops.ragged_paged_attention import (
        RAGGED_Q_TILE,
        packed_positions,
    )

    starts, cur = [], 0
    for n in row_len:
        starts.append(cur)
        cur += -(-n // RAGGED_Q_TILE) * RAGGED_Q_TILE
    T = max(cur, RAGGED_Q_TILE)
    starts = [s if n or r == 0 else T for r, (s, n) in enumerate(zip(starts, row_len))]
    NB = NB or sum(-(-c // bs) for c in ctx_len) + 4
    table = torch.from_numpy(paged_tables(rng, ctx_len, MB, bs, NB)).cuda()
    k, v = paged_pool(torch, rng, 1, NB, Hkv, bs, D, dtype)
    q = torch.from_numpy(rng.randn(T, Hq, D).astype(np.float32) * DECODE_Q_STD).to("cuda", dtype)
    desc = [torch.tensor(a, dtype=torch.int32, device="cuda") for a in (starts, row_len, ctx_len)]
    pos, _ = packed_positions(T, *desc)
    return (q, k[0], v[0], table, *desc, pos >= 0)


def check_ragged(torch, rp, case_inputs, case, atol):
    """One B3 launch against the plain version in fp32 on the same values
    (check_close on the valid slots); the padded slots must be exact
    zeros. Returns the max abs error."""
    from neuronx_distributed_inference_tpu_torch.ops import _cuda

    q, k, v, table, rs, rl, cl, valid = case_inputs
    kw = dict(scale=q.shape[-1] ** -0.5, n_rep=q.shape[1] // k.shape[1])
    before = _cuda.launch_counts()["ragged_paged_attention"]
    out = rp.ragged_paged_attention(q, k, v, table, rs, rl, cl, **kw)
    torch.cuda.synchronize()
    if _cuda.launch_counts()["ragged_paged_attention"] != before + 1:
        raise SystemExit(f"ragged case did not launch B3: {case}")
    if (out[~valid] != 0).any():
        raise SystemExit(f"ragged_paged_attention: a padded slot is not exact zeros: {case}")
    ref = rp.ragged_paged_attention_plain(q.float(), k.float(), v.float(), table, rs, rl, cl, **kw)
    return check_close(torch, out, ref, case, "ragged_paged_attention", valid, atol=atol)


def phase_ragged_parity(torch, rp):
    """B3 at D 64 and 128, block size 16 and 32, bf16 and fp32, n_rep 1, 4
    and 8 (8 kv heads): a chunk that starts mid-context, a chunk from 0 of a
    non-16 length, decode rows, inactive rows (row_len 0 starting at 0 and
    past the packed end), NaN in block 0 and zero-table tails; then the
    serving row's two timed points (roofline.RAGGED_POINTS) at their shapes.
    Tolerances: one bf16 rounding (check_close), 1e-5 at fp32."""
    from neuronx_distributed_inference_tpu_torch.ops.roofline import RAGGED_POINTS

    rng = np.random.RandomState(7)
    worst, n = 0.0, 0
    Hkv, MB = 8, 12
    row_len = [0, 41, 1, 16, 1, 3, 0, 1]
    for D in (64, 128):
        for bs in (16, 32):
            for dtype in (torch.bfloat16, torch.float32):
                for n_rep in (1, 4, 8):
                    ctx_len = [0, 41 + 70, min(150, MB * bs), 16, 9, 3 + 100, 0, 1]
                    inputs = ragged_case(torch, rng, row_len, ctx_len, Hkv * n_rep, Hkv, D, bs, MB, dtype)
                    case = f"D={D} bs={bs} {str(dtype)[6:]} n_rep={n_rep} row_len {row_len} ctx_len {ctx_len}"
                    atol = DECODE_ATOL if dtype == torch.bfloat16 else RAGGED_FP32_ATOL
                    worst = max(worst, check_ragged(torch, rp, inputs, case, atol))
                    n += 1
    for name, pt in RAGGED_POINTS.items():
        bs = pt["block_size"]
        inputs = ragged_case(
            torch, rng, list(pt["row_len"]), list(pt["ctx_len"]), 32, 8, 64, bs, pt["width"] // bs,
            torch.bfloat16, NB=512,
        )
        worst = max(worst, check_ragged(torch, rp, inputs, f"serving {name} point, bf16", DECODE_ATOL))
        n += 1
    log(f"ragged_paged_attention: {n} cases agree with the plain version (largest abs err {worst:.3e})")


def phase_ragged_times(torch, rp):
    """B3 at the serving row's two points (roofline.RAGGED_POINTS), held to
    its plain version first, beside the plain version, the bound for this
    run's inputs, and a library yardstick: F.scaled_dot_product_attention
    per active row on K/V gathered beforehand with a mask built beforehand
    (neither timed)."""
    import torch.nn.functional as F

    from neuronx_distributed_inference_tpu_torch.modules.block_kvcache import read_block_cache_at_layer
    from neuronx_distributed_inference_tpu_torch.ops.roofline import RAGGED_POINTS, ragged_work

    rows = {}
    rng = np.random.RandomState(8)
    for name, pt in RAGGED_POINTS.items():
        bs, width = pt["block_size"], pt["width"]
        inputs = ragged_case(
            torch, rng, list(pt["row_len"]), list(pt["ctx_len"]), 32, 8, 64, bs, width // bs, torch.bfloat16,
            NB=512,
        )
        q, k, v, table, rs, rl, cl, _ = inputs
        err = check_ragged(torch, rp, inputs, f"timed serving {name} point, bf16", DECODE_ATOL)
        kw = dict(scale=0.125, n_rep=4)
        k_r, v_r = read_block_cache_at_layer(k[None], v[None], 0, table)
        cols = torch.arange(width, device="cuda")
        per_row = []
        for r, (s0, n, c) in enumerate(zip(rs.tolist(), rl.tolist(), cl.tolist())):
            if n == 0:
                continue
            qpos = torch.arange(c - n, c, device="cuda")
            per_row.append((
                q[s0 : s0 + n].transpose(0, 1)[None],
                k_r[r].transpose(0, 1).repeat_interleave(4, dim=0)[None],
                v_r[r].transpose(0, 1).repeat_interleave(4, dim=0)[None],
                ((cols[None, :] <= qpos[:, None]) & (cols[None, :] < c))[None, None],
            ))
        ms = time_ms(torch, lambda: rp.ragged_paged_attention(q, k, v, table, rs, rl, cl, **kw))
        plain_ms = time_ms(torch, lambda: rp.ragged_paged_attention_plain(q, k, v, table, rs, rl, cl, **kw))
        lib_ms = time_ms(torch, lambda: [F.scaled_dot_product_attention(a, b, c, attn_mask=m) for a, b, c, m in per_row])
        nbytes, flops = ragged_work(
            rl.tolist(), cl.tolist(), width, bs, dict(Hq=q.shape[1], Hkv=k.shape[1], D=q.shape[2]), q.element_size()
        )
        b_ms, b_by = bound(nbytes, flops)
        rows[("ragged_paged_attention", name)] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err
        )
        log(
            f"ragged_paged_attention {name} point (row_len {list(pt['row_len'])}, ctx_len {list(pt['ctx_len'])}, "
            f"bs={bs} width={width} Hq=32 Hkv=8 D=64 bf16): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa per row {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), err vs plain {err:.3e}"
        )
        del k_r, v_r, per_row
    return rows


# ---------------------------------------------------------------------------
# 5. the main path
# ---------------------------------------------------------------------------


def _config(batch_size, **kw):
    from neuronx_distributed_inference_tpu_torch.config import Config
    from neuronx_distributed_inference_tpu_torch.models.llama import LLAMA_1B, LlamaInferenceConfig

    base = dict(
        batch_size=batch_size, seq_len=1024, dtype="bfloat16",
        context_encoding_buckets=[128, 512], token_generation_buckets=[512, 1024],
        fused_qkv=True, seed=0, device="cuda",
    )
    tc = Config(**{**base, **kw})
    return LlamaInferenceConfig(tc, load_config=lambda c: [setattr(c, k, v) for k, v in LLAMA_1B.items()])


def phase_main_path(torch):
    from neuronx_distributed_inference_tpu_torch.ops import _cuda
    from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM

    prompt_len, n_new = 128, 256
    t0 = time.perf_counter()
    app = ModelForCausalLM(None, _config(1)).load(random_weights=True).warmup()
    torch.cuda.synchronize()
    n_layers = app.spec.num_layers
    log(f"main path: load + warmup {time.perf_counter() - t0:.2f} s")
    vocab = app.spec.vocab_size
    prompt = np.random.RandomState(0).randint(0, vocab, size=(1, prompt_len))

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = app.generate(prompt, max_new_tokens=1)
    ttft_ms = (time.perf_counter() - t0) * 1e3

    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    out = app.generate(prompt, max_new_tokens=n_new)
    total_s = time.perf_counter() - t0
    launches = _cuda.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    decode_tok_s = (n_new - 1) / (total_s - ttft_ms / 1e3)
    log(
        f"main path (bf16, batch 1, prompt {prompt_len}, {n_new} new tokens): TTFT {ttft_ms:.2f} ms, "
        f"generate {total_s * 1e3:.1f} ms, decode {decode_tok_s:.1f} tok/s, peak memory {peak / 2**30:.3f} GiB"
    )
    log(f"main path launches: {launches}")
    # 255 remaining tokens run as one 256-step pow2 chunk in bucket 512
    want = expect_launches(flash_attention=n_layers, decode_attention=n_layers * 256)
    if launches != want:
        raise SystemExit(f"launch counts {launches} != expected {want}")
    gen = out.sequences[:, prompt_len:]
    if gen.shape != (1, n_new) or gen.min() < 0 or gen.max() >= vocab:
        raise SystemExit(f"bad generated tokens: shape {gen.shape}, range [{gen.min()}, {gen.max()}]")
    if first.sequences[0, prompt_len] != out.sequences[0, prompt_len]:
        raise SystemExit("first token differs between two generate() calls")

    # right-padded batch 2 on a second app over the same weights
    app2 = ModelForCausalLM(None, _config(2)).load(params=app.params)
    ids2 = np.random.RandomState(1).randint(0, vocab, size=(2, prompt_len))
    mask2 = np.ones_like(ids2)
    mask2[1, 77:] = 0
    ids2[1, 77:] = 0
    out2 = app2.generate(ids2, mask2, max_new_tokens=32)
    gen2 = out2.sequences[:, prompt_len:]
    if gen2.shape != (2, 32) or gen2.min() < 0 or gen2.max() >= vocab:
        raise SystemExit(f"bad batch-2 tokens: shape {gen2.shape}, range [{gen2.min()}, {gen2.max()}]")
    log(f"batch 2 right-padded (lengths 128, 77): 32 tokens per row generated, first row {gen2[0, :8].tolist()}")
    del app2

    profile = phase_profile(torch, app, out.sequences[0], prompt_len)
    forced = teacher_forced(torch, app, out.sequences[0], prompt_len)
    return dict(
        **profile, ttft_ms=ttft_ms, decode_tok_s=decode_tok_s, peak_bytes=peak, launches=launches,
        params=app.params, **forced,
    )


def phase_profile(torch, app, seq, prompt_len, steps=16):
    """Where a decode step's time goes: one ``steps``-step decode chunk in
    bucket 512 (it re-decodes from the first generated token, rewriting
    cache positions the main path already wrote with the same tokens)."""
    from neuronx_distributed_inference_tpu_torch.modules.sampling import prepare_sampling_params

    args = (
        np.array([[seq[prompt_len]]]), np.array([[prompt_len + 1]]), np.zeros(1, np.int32),
        prepare_sampling_params(1),
    )

    def chunk():
        app.token_generation_model.decode_chunk(app.params, app.kv_cache, *args, num_steps=steps, bucket=512)
        torch.cuda.synchronize()

    return profile_chunk(torch, chunk, steps, "decode step (batch 1, bucket 512)")


def profile_chunk(torch, chunk, steps, label):
    """Run ``chunk`` (``steps`` decode steps ending in a synchronize) once
    to warm, once timed on the host clock without the profiler, then once
    traced with torch.profiler for the device's busy time, the kernels by
    name and the host-side operators by their own (self) CPU time."""
    from torch.profiler import ProfilerActivity, profile

    chunk()
    t0 = time.perf_counter()
    chunk()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chunk()
        traced_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    log(
        f"{label}: {step_ms:.3f} ms on the host clock; traced chunk "
        f"{traced_ms:.1f} ms for {steps} steps, device busy {busy_ms:.2f} ms "
        f"({busy_ms / traced_ms:.3f} of the traced wall time), {len(kernels) / steps:.0f} kernels per step"
    )
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"  {ms / steps:8.4f} ms/step  {name[:110]}")
    host_ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:8]
    for e in host_ops:
        log(f"  host {e.self_cpu_time_total / 1e3 / steps:8.4f} ms/step, {e.count / steps:6.1f} calls/step  {e.key[:90]}")
    return dict(
        decode_step_ms=step_ms, device_busy_frac=busy_ms / traced_ms,
        kernels_per_step=len(kernels) / steps,
        kernel_ms_per_step={name: ms / steps for name, ms in by_name.items()},
    )


def phase_serving_profile(torch, app, ctx=192, steps=16):
    """Where a serving decode step's time goes: a ``steps``-step decode
    chunk over the paged cache at the session's 8 rows, each ``ctx`` tokens
    deep (random tokens; the cache holds whatever the serving run left)."""
    from neuronx_distributed_inference_tpu_torch.modules.sampling import prepare_sampling_params

    s = SERVING
    B, bs, width = s["slots"], s["block_size"], s["seq"]
    per_row = width // bs
    table = np.arange(1, B * per_row + 1, dtype=np.int32).reshape(B, per_row)
    rng = np.random.RandomState(6)
    last = rng.randint(0, app.spec.vocab_size, size=(B, 1))
    pos = np.full((B, 1), ctx, np.int32)

    def chunk():
        app.token_generation_model.decode_chunk(
            app.params, app.kv_cache, last, pos, np.arange(B, dtype=np.int32),
            prepare_sampling_params(B), num_steps=steps, bucket=width, block_table=table,
        )
        torch.cuda.synchronize()

    return profile_chunk(torch, chunk, steps, f"serving decode step (8 rows, {ctx} deep, paged bucket {width})")


def _forced_logits(torch, cfg, params, seq, prompt_len):
    """Logits of the prefill and of every decode step over ``seq``, each
    step fed the recorded token (teacher forcing), through forward()."""
    from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM

    a = ModelForCausalLM(None, cfg).load(params=params)
    seq_ids = np.zeros(1, np.int32)
    steps = [a.forward(seq[None, :prompt_len], np.arange(prompt_len)[None, :], seq_ids)[1][:, -1]]
    for p in range(prompt_len, len(seq) - 1):
        steps.append(a.forward(seq[None, p : p + 1], np.array([[p]]), seq_ids)[1][:, -1])
    return np.concatenate(steps, axis=0)  # (positions, V)


#: how much farther from fp32 the kernel path may sit than the plain path
FORCED_RATIO = 1.25


def teacher_forced(torch, app, seq, prompt_len):
    """The kernel path against the plain path (both tri-states False) on the
    same bf16 weights, teacher-forced over the kernel path's own tokens,
    with an fp32 run of the plain path on the same weights as the reference.

    Two bf16 paths that round at different places each sit some distance
    from fp32; the kernel path is right when it sits no farther from fp32
    than FORCED_RATIO times the plain path does, by the largest and by the
    root-mean-square logit error. Its greedy argmax must also equal fp32's
    wherever fp32's top-2 margin exceeds twice its own largest error."""
    off = dict(attn_kernel_enabled=False, attn_block_tkg_kernel_enabled=False)
    k = _forced_logits(torch, _config(1, output_logits=True), app.params, seq, prompt_len)
    pl = plain_run(
        "teacher-forced bf16", _forced_logits, torch, _config(1, output_logits=True, **off), app.params, seq,
        prompt_len,
    )
    params32 = _map_tree(app.params, lambda t: t.float())
    f32 = plain_run(
        "teacher-forced fp32", _forced_logits, torch, _config(1, output_logits=True, dtype="float32", **off),
        params32, seq, prompt_len,
    )
    del params32
    return _forced_gate(k, pl, f32, "teacher-forced logits")


def _forced_gate(k, pl, f32, what):
    """Gate the kernel path's logits ``k`` against the plain path's ``pl``,
    both against fp32 ``f32`` (see teacher_forced)."""
    if not (np.isfinite(k).all() and np.isfinite(pl).all()):
        raise SystemExit("non-finite logits on the main path")
    err = float(np.abs(k - pl).max())
    max_k32, max_p32 = float(np.abs(k - f32).max()), float(np.abs(pl - f32).max())
    rms_k32 = float(np.sqrt(np.mean((k - f32) ** 2)))
    rms_p32 = float(np.sqrt(np.mean((pl - f32) ** 2)))
    top2 = np.sort(f32, axis=-1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 2 * max_k32
    ref_arg = f32.argmax(-1)
    agree = (k.argmax(-1) == ref_arg)[decided]
    log(
        f"{what} over {k.shape[0]} positions (scale: max |logit| {np.abs(f32).max():.3f}): "
        f"kernel vs fp32 max {max_k32:.4f} rms {rms_k32:.5f}; plain vs fp32 max {max_p32:.4f} "
        f"rms {rms_p32:.5f}; ratios max {max_k32 / max_p32:.3f} rms {rms_k32 / rms_p32:.3f} "
        f"(limit {FORCED_RATIO}); kernel vs plain max {err:.4f}"
    )
    log(
        f"  greedy argmax equal to fp32's at {int(agree.sum())}/{int(decided.sum())} positions whose fp32 "
        f"margin > 2 x {max_k32:.4f}; overall kernel {int((k.argmax(-1) == ref_arg).sum())}, "
        f"plain {int((pl.argmax(-1) == ref_arg).sum())} of {k.shape[0]}"
    )
    if max_k32 > FORCED_RATIO * max_p32 or rms_k32 > FORCED_RATIO * rms_p32 or not agree.all():
        raise SystemExit("kernel path sits farther from fp32 than the plain path allows")
    return dict(
        kernel_vs_plain=err, kernel_vs_fp32=max_k32, plain_vs_fp32=max_p32,
        kernel_vs_fp32_rms=rms_k32, plain_vs_fp32_rms=rms_p32,
    )


# ---------------------------------------------------------------------------
# 6. the serving path
# ---------------------------------------------------------------------------

SERVING = dict(n_requests=8, prompt=128, gen=128, slots=8, blocks=512, block_size=32, seq=1024)


def _serving_config(chunked=True, **kw):
    """The serving_1b_int8 row's configuration in bf16 (bench.py:990-991,
    1472-1485 with build_app(block_kv=...) at bench.py:160-174): Llama-3.2-1B
    shapes, 8 slots, seq 1024, CTE and TKG buckets [1024], a paged pool of
    512 blocks of 32, chunked prefill of up to 8 rows in 128-token tiles."""
    from neuronx_distributed_inference_tpu_torch.config import ChunkedPrefillConfig

    s = SERVING
    extra = dict(
        is_continuous_batching=True, ctx_batch_size=1, is_block_kv_layout=True,
        pa_num_blocks=s["blocks"], pa_block_size=s["block_size"],
        context_encoding_buckets=[s["seq"]], token_generation_buckets=[s["seq"]],
    )
    if chunked:
        extra.update(
            is_chunked_prefill=True,
            chunked_prefill_config=ChunkedPrefillConfig(max_num_seqs=s["slots"], kernel_q_tile_size=128),
        )
    return _config(s["slots"], **{**extra, **kw})


def _serve(torch, app, prompts, gen, telemetry):
    """bench.py's serving traffic (measure_serving): two requests up front,
    one more per step() while slots are free, then run_to_completion in
    16-step chunks once every request is producing. Returns (session,
    seconds)."""
    from neuronx_distributed_inference_tpu_torch.runtime.serving import ServingSession

    app.init_kv_cache()
    sess = ServingSession(app, telemetry=telemetry)
    t0 = time.perf_counter()
    nxt, produced = 0, set()
    for _ in range(2):
        if not sess.add_request(str(nxt), prompts[nxt], max_new_tokens=gen):
            raise SystemExit(f"serving: request {nxt} refused")
        nxt += 1
    while True:
        produced.update(sess.step())
        if nxt < len(prompts) and sess.free_slots:
            if not sess.add_request(str(nxt), prompts[nxt], max_new_tokens=gen):
                raise SystemExit(f"serving: request {nxt} refused")
            nxt += 1
        if nxt >= len(prompts):
            if not sess.active:
                break
            if len(produced) >= len(prompts):
                sess.run_to_completion(decode_chunk_size=16)
                break
    torch.cuda.synchronize()
    return sess, time.perf_counter() - t0


def phase_serving(torch, params):
    """The serving path at full width, on the generate() path's weights."""
    from neuronx_distributed_inference_tpu_torch.ops import _cuda
    from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM
    from neuronx_distributed_inference_tpu_torch.telemetry import TelemetrySession

    s = SERVING
    t0 = time.perf_counter()
    app = ModelForCausalLM(None, _serving_config()).load(params=params).warmup()
    torch.cuda.synchronize()
    n_layers = app.spec.num_layers
    vocab = app.spec.vocab_size
    log(f"serving: load + warmup {time.perf_counter() - t0:.2f} s")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, vocab - 10, size=(s["prompt"],)).tolist() for _ in range(s["n_requests"])]
    _serve(torch, app, prompts, s["gen"], TelemetrySession())  # warm pass: first-call costs

    tel = TelemetrySession()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    sess, total_s = _serve(torch, app, prompts, s["gen"], tel)
    launches = _cuda.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    counts = {rid: len(r.generated) for rid, r in sess.requests.items()}
    ttft = [t * 1e3 for t in tel.ttft_values_s()]
    itl = [t * 1e3 for t in tel.itl_values_s()]
    pct = tel.percentile
    tok_s = sum(counts.values()) / total_s
    faults = dict(
        rejected=sum(tel.rejected.values()), quarantined=tel.counters["quarantined"],
        preempted=tel.counters["preempted"],
    )
    log(
        f"serving (bf16, 8 slots, 512 blocks x 32, chunked prefill 8 x 128, {s['n_requests']} requests of "
        f"{s['prompt']} + {s['gen']} tokens, staggered): {total_s * 1e3:.1f} ms, aggregate {tok_s:.1f} tok/s, "
        f"TTFT p50 {pct(ttft, 0.5):.2f} ms p99 {pct(ttft, 0.99):.2f} ms, ITL p50 {pct(itl, 0.5):.3f} ms "
        f"p99 {pct(itl, 0.99):.3f} ms, peak memory {peak / 2**30:.3f} GiB, {faults}"
    )
    log(f"serving dispatches {dict(sess.dispatches)}, launches {launches}")
    if sorted(counts.values()) != [s["gen"]] * s["n_requests"] or len(counts) != s["n_requests"]:
        raise SystemExit(f"serving: not every request completed: {counts}")
    if any(faults.values()) or any(r.status != "finished" for r in sess.requests.values()):
        raise SystemExit(f"serving: faults on clean traffic: {faults}")
    want = expect_launches(
        paged_flash_attention=sess.dispatches["prefill_chunk"] * n_layers,
        paged_decode_attention=sess.dispatches["decode_steps"] * n_layers,
    )
    if launches != want or not want["paged_flash_attention"] or not want["paged_decode_attention"]:
        raise SystemExit(f"serving launch counts {launches} != expected {want}")
    for rid, r in sess.requests.items():
        if min(r.generated) < 0 or max(r.generated) >= vocab:
            raise SystemExit(f"serving: request {rid} has tokens outside the vocab")

    # a short paged run admitting through the context-encoding program (B2)
    app2 = ModelForCausalLM(None, _serving_config(chunked=False)).load(params=params).warmup()
    _cuda.reset_launch_counts()
    sess2, s2 = _serve(torch, app2, prompts[:4], 32, TelemetrySession())
    launches2 = _cuda.launch_counts()
    counts2 = [len(r.generated) for r in sess2.requests.values()]
    log(f"paged without chunked prefill (4 x 32 tokens): {s2 * 1e3:.1f} ms, dispatches {dict(sess2.dispatches)}, launches {launches2}")
    want2 = expect_launches(
        flash_attention=sess2.dispatches["prefill"] * n_layers,
        paged_decode_attention=sess2.dispatches["decode_steps"] * n_layers,
    )
    if counts2 != [32] * 4 or sess2.dispatches["prefill"] != 4 or launches2 != want2:
        raise SystemExit(f"paged CTE admission run: tokens {counts2}, launches {launches2} != {want2}")
    del app2, sess2

    profile = phase_serving_profile(torch, app)
    forced = paged_teacher_forced(torch, params, prompts[0] + sess.requests["0"].generated)
    return dict(
        **{f"serving_{k}": v for k, v in profile.items()},
        tokens={rid: list(r.generated) for rid, r in sess.requests.items()},
        launches=launches, tok_s=tok_s, total_ms=total_s * 1e3, peak_bytes=peak,
        ttft_p50_ms=pct(ttft, 0.5), ttft_p99_ms=pct(ttft, 0.99), itl_p50_ms=pct(itl, 0.5),
        itl_p99_ms=pct(itl, 0.99), **faults, **forced,
    )


def _paged_forced_logits(torch, cfg, params, seq, prompt_len):
    """Logits of one 128-token chunk pass over an empty paged cache (B5's
    route) and of every later position as a single-token step (B4's
    route), each fed the recorded token, through forward(slot_mapping=,
    block_table=). Request 0 sits in row 0 of the 8-row runner."""
    from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM

    a = ModelForCausalLM(None, cfg).load(params=params)
    bs, width = SERVING["block_size"], SERVING["seq"]
    blocks = np.arange(1, width // bs + 1, dtype=np.int32)
    table = blocks[None, :]
    seq_ids = np.zeros(1, np.int32)

    def mask(upto):
        m = np.zeros((1, width), np.int32)
        m[0, :upto] = 1
        return m

    pos = np.arange(prompt_len, dtype=np.int32)[None, :]
    slots = (blocks[pos // bs] * bs + pos % bs).astype(np.int32)
    _, lg = a.forward(
        np.asarray(seq[:prompt_len])[None, :], pos, seq_ids, attention_mask=mask(prompt_len),
        slot_mapping=slots, block_table=table, phase="tkg",
    )
    steps = [lg[0]]
    for p in range(prompt_len, len(seq) - 1):
        _, lg = a.forward(
            np.array([[seq[p]]]), np.array([[p]], np.int32), seq_ids, attention_mask=mask(p + 1),
            block_table=table, phase="tkg",
        )
        steps.append(lg[0])
    del a
    return np.concatenate(steps, axis=0)  # (positions, V)


def paged_teacher_forced(torch, params, seq, prompt_len=128):
    """The paged kernel path (B5 for the chunk, B4 for the steps) against the
    plain paged path on the same bf16 weights and an fp32 run of the plain
    path, teacher-forced over request 0's served tokens; the gate of the
    generate() path's check (FORCED_RATIO by max and RMS, argmax on decided
    positions)."""
    from neuronx_distributed_inference_tpu_torch.ops import _cuda

    off = dict(attn_kernel_enabled=False, attn_block_tkg_kernel_enabled=False)
    _cuda.reset_launch_counts()
    k = _paged_forced_logits(torch, _serving_config(output_logits=True), params, seq, prompt_len)
    kl = _cuda.launch_counts()
    n_layers = len(params["layers"])
    if kl["paged_flash_attention"] != n_layers or kl["paged_decode_attention"] != n_layers * (len(seq) - 1 - prompt_len):
        raise SystemExit(f"paged teacher-forced run did not take B5 then B4: {kl}")
    pl = plain_run(
        "paged teacher-forced bf16", _paged_forced_logits, torch, _serving_config(output_logits=True, **off),
        params, seq, prompt_len,
    )
    params32 = _map_tree(params, lambda t: t.float())
    f32 = plain_run(
        "paged teacher-forced fp32", _paged_forced_logits, torch,
        _serving_config(output_logits=True, dtype="float32", **off), params32, seq, prompt_len,
    )
    del params32
    return _forced_gate(k, pl, f32, "paged teacher-forced logits (one 128-token chunk through B5, then B4 steps)")


# ---------------------------------------------------------------------------
# 7. the ragged mixed-step serving path
# ---------------------------------------------------------------------------


def _ragged_run(torch, app, prompts, gen, split_tokens, label):
    """One ragged drain of _serve's traffic with the launch counts read
    around it: every request complete, no fault, B3 launched 16 times per
    mixed dispatch and no other kernel. Returns its metrics."""
    from neuronx_distributed_inference_tpu_torch.ops import _cuda
    from neuronx_distributed_inference_tpu_torch.telemetry import TelemetrySession

    n_layers = app.spec.num_layers
    vocab = app.spec.vocab_size
    tel = TelemetrySession()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    sess, total_s = _serve(torch, app, prompts, gen, tel)
    launches = _cuda.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    counts = {rid: len(r.generated) for rid, r in sess.requests.items()}
    ttft = [t * 1e3 for t in tel.ttft_values_s()]
    itl = [t * 1e3 for t in tel.itl_values_s()]
    pct = tel.percentile
    tok_s = sum(counts.values()) / total_s
    faults = dict(
        rejected=sum(tel.rejected.values()), quarantined=tel.counters["quarantined"],
        preempted=tel.counters["preempted"],
    )
    padded, real = sum(tel.mixed_steps["padded_slots"]), sum(tel.mixed_steps["query_tokens"])
    log(
        f"ragged serving {label} (bf16, 8 slots, 512 blocks x 32, {len(prompts)} requests of "
        f"{len(prompts[0])} + {gen} tokens, staggered): {total_s * 1e3:.1f} ms, aggregate {tok_s:.1f} tok/s, "
        f"TTFT p50 {pct(ttft, 0.5):.2f} ms p99 {pct(ttft, 0.99):.2f} ms, ITL p50 {pct(itl, 0.5):.3f} ms "
        f"p99 {pct(itl, 0.99):.3f} ms, padded-slot share {padded / (padded + real):.3f}, "
        f"peak memory {peak / 2**30:.3f} GiB, {faults}"
    )
    host = np.array(tel.step_host_ms)
    wait = np.array(tel.step_fetch_wait_ms)
    host_share = np.clip(host, 0, None).sum() / (np.clip(host, 0, None).sum() + np.clip(wait, 0, None).sum())
    log(
        f"  {len(host)} steps: host ms/step mean {host.mean():.3f} p50 {np.median(host):.3f} max {host.max():.3f}; "
        f"fetch wait ms/step mean {wait.mean():.3f} max {wait.max():.3f}; host share {host_share:.3f}"
    )
    log(f"  dispatches {dict(sess.dispatches)}, launches {launches}")
    if sorted(counts.values()) != [gen] * len(prompts):
        raise SystemExit(f"ragged serving {label}: not every request completed: {counts}")
    if any(faults.values()) or any(r.status != "finished" for r in sess.requests.values()):
        raise SystemExit(f"ragged serving {label}: faults on clean traffic: {faults}")
    for rid, r in sess.requests.items():
        if min(r.generated) < 0 or max(r.generated) >= vocab:
            raise SystemExit(f"ragged serving {label}: request {rid} has tokens outside the vocab")
    if split_tokens is not None:
        same = sum(
            sum(a == b for a, b in zip(r.generated, split_tokens[rid])) for rid, r in sess.requests.items()
        )
        log(f"  tokens equal to the split run's at {same} of {sum(counts.values())} positions (not a gate)")
    return dict(
        sess=sess, launches=launches, tok_s=tok_s, peak_bytes=peak, itl_p50_ms=pct(itl, 0.5),
        itl_p99_ms=pct(itl, 0.99), ttft_p50_ms=pct(ttft, 0.5), ttft_p99_ms=pct(ttft, 0.99),
    )


def phase_ragged_serving(torch, params, split_tokens):
    """The serving_1b_int8_ragged row's configuration in bf16 (int8 weights
    wait for A6): _serving_config with serving_ragged, on _serve's traffic,
    synchronous (the row pins serving_ragged_async=False) and 1-ahead, each
    warmed by one pass, then measured in turns (sync, 1-ahead, 1-ahead,
    sync: host-clock metrics drift on a shared host); a short run without
    chunked prefill; the ragged teacher-forced check and a profile of 16
    steady-state steps."""
    from neuronx_distributed_inference_tpu_torch.ops import _cuda
    from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM
    from neuronx_distributed_inference_tpu_torch.telemetry import TelemetrySession

    s = SERVING
    t0 = time.perf_counter()
    apps = {
        label: ModelForCausalLM(None, _serving_config(serving_ragged=True, serving_ragged_async=ragged_async))
        .load(params=params).warmup()
        for label, ragged_async in (("sync", False), ("1-ahead", True))
    }
    torch.cuda.synchronize()
    app = apps["1-ahead"]
    n_layers = app.spec.num_layers
    log(f"ragged serving: load + warmup of both apps {time.perf_counter() - t0:.2f} s, mixed buckets {app.mixed_step_model.buckets}")
    rng = np.random.RandomState(0)  # phase_serving's prompts
    prompts = [rng.randint(0, app.spec.vocab_size - 10, size=(s["prompt"],)).tolist() for _ in range(s["n_requests"])]
    for a in apps.values():
        _serve(torch, a, prompts, s["gen"], TelemetrySession())  # warm pass: first-call costs
    runs = {}
    for turn, label in enumerate(("sync", "1-ahead", "1-ahead", "sync")):
        run = _ragged_run(torch, apps[label], prompts, s["gen"], split_tokens, f"{label} (turn {turn + 1})")
        sess = run.pop("sess")
        want = expect_launches(ragged_paged_attention=sess.dispatches["mixed_step"] * n_layers)
        if run["launches"] != want or not want["ragged_paged_attention"] or set(sess.dispatches) != {"mixed_step"}:
            raise SystemExit(f"ragged serving {label}: launches {run['launches']} != {want}, dispatches {dict(sess.dispatches)}")
        run["tokens0"] = list(sess.requests["0"].generated)
        runs.setdefault(label, run)

    # without chunked prefill: admission through the context program (B2),
    # then mixed decode steps (B3)
    app3 = ModelForCausalLM(None, _serving_config(chunked=False, serving_ragged=True)).load(params=params).warmup()
    _cuda.reset_launch_counts()
    sess3, s3 = _serve(torch, app3, prompts[:4], 32, TelemetrySession())
    launches3 = _cuda.launch_counts()
    counts3 = [len(r.generated) for r in sess3.requests.values()]
    log(f"ragged without chunked prefill (4 x 32 tokens): {s3 * 1e3:.1f} ms, dispatches {dict(sess3.dispatches)}, launches {launches3}")
    want3 = expect_launches(
        flash_attention=4 * n_layers, ragged_paged_attention=sess3.dispatches["mixed_step"] * n_layers
    )
    if counts3 != [32] * 4 or sess3.dispatches["prefill"] != 4 or launches3 != want3:
        raise SystemExit(f"ragged CTE admission run: tokens {counts3}, launches {launches3} != {want3}")
    del app3, sess3

    profile = {label: phase_ragged_profile(torch, a, prompts, label) for label, a in apps.items()}
    del apps, app
    forced = ragged_teacher_forced(torch, params, prompts[0] + runs["sync"]["tokens0"])
    return dict(runs=runs, profile=profile, forced=forced)


def phase_ragged_profile(torch, app, prompts, label, steps=16):
    """Where a steady-state ragged step's time goes: 8 requests decoding,
    ``steps`` step() calls per traced chunk, on the app of one form (sync
    or 1-ahead)."""
    from neuronx_distributed_inference_tpu_torch.runtime.serving import ServingSession

    app.init_kv_cache()
    sess = ServingSession(app)
    for i, p in enumerate(prompts):
        if not sess.add_request(f"p{i}", p, max_new_tokens=4 * steps + 16):
            raise SystemExit(f"ragged profile: request {i} refused")
    for _ in range(64):  # into steady decode (1-ahead: with a step in flight)
        if not (sess.prefilling or (sess.ragged_async and sess._pending is None)):
            break
        sess.step()
    else:
        raise SystemExit(f"ragged profile ({label}): the session did not reach steady decode")

    def chunk():
        for _ in range(steps):
            sess.step()
        torch.cuda.synchronize()

    prof = profile_chunk(torch, chunk, steps, f"ragged serving step (8 rows decoding, {label}, {steps} steps)")
    b3 = sum(ms for name, ms in prof["kernel_ms_per_step"].items() if "ragged_paged_kernel" in name)
    log(f"  B3 (ragged_paged_kernel) {b3:.4f} ms/step")
    sess.run_to_completion()
    return dict(prof, b3_ms_per_step=b3)


def _ragged_forced_logits(torch, cfg, params, seq, prompt_len):
    """Logits of one ``prompt_len``-token chunk row from position 0 and of
    every later position as a single-token row, each fed the recorded token,
    through the mixed-step runner (mixed_forward) with request 0 in row 0 of
    the 8 rows."""
    from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM

    a = ModelForCausalLM(None, cfg).load(params=params)
    mr = a.mixed_step_model
    bs, width = SERVING["block_size"], SERVING["seq"]
    R = mr.num_rows
    table = np.zeros((R, width // bs), np.int32)
    table[0] = np.arange(1, width // bs + 1)
    steps = []
    for lo, hi in [(0, prompt_len)] + [(p, p + 1) for p in range(prompt_len, len(seq) - 1)]:
        pos = np.arange(lo, hi, dtype=np.int32)
        row_len = np.zeros(R, np.int32)
        ctx_len = np.zeros(R, np.int32)
        row_len[0], ctx_len[0] = hi - lo, hi
        inputs, _ = mr.prepare(
            np.asarray(seq[lo:hi], np.int32), pos, (table[0, pos // bs] * bs + pos % bs).astype(np.int32),
            np.zeros(R, np.int32), row_len, ctx_len, table, width,
        )
        out = mr(a.params, a.kv_cache, inputs)
        a.kv_cache = out.cache
        steps.append(out.logits[0].float().cpu().numpy())
    del a
    return np.concatenate(steps, axis=0)  # (positions, V)


def ragged_teacher_forced(torch, params, seq, prompt_len=128):
    """mixed_forward with B3 against the plain path on the same bf16 weights
    and an fp32 run of the plain path, teacher-forced over request 0's
    served tokens; the gate of the other teacher-forced checks."""
    from neuronx_distributed_inference_tpu_torch.ops import _cuda

    off = dict(attn_kernel_enabled=False, attn_block_tkg_kernel_enabled=False)
    _cuda.reset_launch_counts()
    k = _ragged_forced_logits(torch, _serving_config(serving_ragged=True, output_logits=True), params, seq, prompt_len)
    kl = _cuda.launch_counts()
    n_layers = len(params["layers"])
    want = expect_launches(ragged_paged_attention=n_layers * (len(seq) - prompt_len))
    if kl != want:
        raise SystemExit(f"ragged teacher-forced run: launches {kl} != {want}")
    pl = plain_run(
        "ragged teacher-forced bf16", _ragged_forced_logits, torch,
        _serving_config(serving_ragged=True, output_logits=True, **off), params, seq, prompt_len,
    )
    params32 = _map_tree(params, lambda t: t.float())
    f32 = plain_run(
        "ragged teacher-forced fp32", _ragged_forced_logits, torch,
        _serving_config(serving_ragged=True, output_logits=True, dtype="float32", **off), params32, seq,
        prompt_len,
    )
    del params32
    return _forced_gate(k, pl, f32, "ragged teacher-forced logits (one 128-token chunk row, then single-token rows, through B3)")


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(v, fn) for v in tree]
    return fn(tree)


def timed(name, fn, *args):
    """Run one phase and print its seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main():
    sys.path.insert(0, REPO)
    import torch

    smi = phase_device(torch)
    from neuronx_distributed_inference_tpu_torch.ops import _cuda
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention as da
    from neuronx_distributed_inference_tpu_torch.ops import flash_attention as fa
    from neuronx_distributed_inference_tpu_torch.ops import paged_flash_attention as pf
    from neuronx_distributed_inference_tpu_torch.ops import ragged_paged_attention as rp

    reports = timed("build", _cuda.build)
    for name, rep_ in reports.items():
        log(f"--- {name} ptxas ---\n{rep_}")

    timed("flash parity", phase_flash_parity, torch, fa)
    timed("decode parity", phase_decode_parity, torch, da)
    timed("paged decode parity", phase_paged_decode_parity, torch, da)
    timed("paged flash parity", phase_paged_flash_parity, torch, pf)
    timed("ragged parity", phase_ragged_parity, torch, rp)
    times = timed("times", phase_times, torch, fa, da)
    times.update(timed("paged times", phase_paged_times, torch, da, pf))
    times.update(timed("ragged times", phase_ragged_times, torch, rp))
    main_path = timed("main path", phase_main_path, torch)
    params = main_path.pop("params")
    serving = timed("serving", phase_serving, torch, params)
    ragged = timed("ragged serving", phase_ragged_serving, torch, params, serving["tokens"])

    entries = []
    for name, key, source, replaces, launches in (
        # the main path's head_dim 64 takes the reference's packed kernel
        ("flash_attention", ("flash_attention", 128, 64), "csrc/flash_attention.cu",
         "neuronx_distributed_inference_tpu/ops/flash_attention.py:335", main_path["launches"]),
        ("decode_attention", ("decode_attention", 512), "csrc/decode_attention.cu",
         "neuronx_distributed_inference_tpu/ops/decode_attention.py:195", main_path["launches"]),
        # B4 is paged_tkg_decode_attention (:284), which reaches the same
        # _common_call pallas_call as B1
        ("paged_decode_attention", "paged_decode_attention", "csrc/decode_attention.cu",
         "neuronx_distributed_inference_tpu/ops/decode_attention.py:284", serving["launches"]),
        ("paged_flash_attention", "paged_flash_attention", "csrc/paged_flash_attention.cu",
         "neuronx_distributed_inference_tpu/ops/paged_flash_attention.py:200", serving["launches"]),
        # B3 at the serving row's mixed step; launches of the synchronous
        # ragged drain
        ("ragged_paged_attention", ("ragged_paged_attention", "mixed"), "csrc/ragged_paged_attention.cu",
         "neuronx_distributed_inference_tpu/ops/ragged_paged_attention.py:267", ragged["runs"]["sync"]["launches"]),
    ):
        t = times[key]
        entries.append({
            "name": name, "route": "cuda", "source": f"{PKG}/{source}", "replaces": replaces,
            "launches": launches[name], "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    log(f"card: {smi}")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)


if __name__ == "__main__":
    main()
