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
     zero-table tails and inactive rows; B1's kv split (the 64-row group,
     one split, rows with no valid key, batch 8 at bucket 1024), B4's (the
     same split over the block table: widths no tile divides, a zero table
     entry inside a row, the serving decode shape), B2 at
     lengths no block divides and on D=128 fused-QKV views, and every B5
     case (bf16 held also to a plain version that rounds P to bf16), each
     launched twice and required bit-identical; B4, B5 and B3 also at
     Qwen3-30B-A3B's head shape (32 q / 4 kv heads of 128, blocks of 32);
  4. kernel times at the main paths' shapes and layouts (CUDA events, L2
     flushed before each launch), each held to its plain version first,
     beside the plain version, one PyTorch library call, and the card's
     bound for the same work (B1 and B4 with their split counts and grids,
     B7 with its grids and each of its launches' device time; B4, B5 and
     B3 also at the Qwen3 serving shape);
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
     check of mixed_forward, and a profile of PROFILE_STEPS steady-state steps;
  8. the quantized paths: B6 (int4 fused-dequant matmul) against its plain
     version at rows 1 to 64 (each case launched twice, bit-identical, with
     its split-K count and grid printed) and timed, then the bf16_8b_int4,
     int8_1b_bs1 and serving_1b_int4_ragged rows (exact B6 / int4_dense
     counts; profiles of the 8B decode step and the int4 ragged step);
  9. the MoE path: B7 (selected-experts MoE decode) against its plain
     version at Qwen3-30B-A3B and Mixtral-8x7B widths and widths no tile
     divides, timed at one layer beside the dense all-experts route, then
     Qwen3-30B-A3B at full width and depth (48 layers, 128 experts, top-8,
     57 GiB of seeded random bf16 weights made on the card): generate() at
     batch 1 with exact B2 / B1 / B7 / moe_grouped counts and no dense MoE
     call, a batch-8 generate() (64 rows for B7), a profile, and the
     teacher-forced gate on its first 4 layers with the router's top-k flips
     counted. B1 and B2 also run at its GQA 8:1 shape in phases 3 and 4.
     Then Qwen3-30B-A3B through the serving sessions (phase_qwen3_serving):
     the serving row's paged configuration and traffic, split and ragged,
     sync and 1-ahead, graphs on, one parameter set: exact B4 / B5 / B3 /
     B7 and moe_grouped / moe_dense counts, the grouped-route steps run
     eagerly (no capture of a ragged step of 64 packed tokens or more, the
     split decode step captured), nothing captured after the seal, each
     request its 128 tokens, host ms and device-busy share a step, peak
     memory, and the paged teacher-forced gate with routing pinned;
 10. the fused decode layer: B8 (the attention block) and B9 (the MLP
     block) against their plain versions (B8: D 64 and 128, GQA 4:1 and
     8:1, batch 1 and 4, K 1 and 4, buckets 512 and 1024, rows on the
     garbage line; B9: 1 to 80 rows, silu and the tanh gelu, widths no tile
     divides), each case launched twice more, bit-identical; timed at the
     1B decode layer at batch 1 and 4 beside the unfused layer (B9 also at
     16 rows and at Llama-3.1-8B's MLP width), then
     Llama-3.2-1B generate() at batch 4 (bf16_1b_bs4) and batch 1 with the
     fused layer on and off in turn (exact counts, tok/s, TTFT, profiles)
     and its teacher-forced gate;
 11. CUDA graphs: every runner above captures one graph per key (the
     default, cuda_graphs=True); the graph phase runs each main path with
     graphs on and off in turns, on the same weights: 1B generate() with the
     fused layer off and on at batch 1 and 4, the split and ragged serving
     drains sync and 1-ahead (and, inside phases 8 and 9, int4 8B and
     Qwen3-30B-A3B generate() beside an eager twin), requiring identical
     greedy tokens, equal launch counts and no capture after warmup and the
     seal (RetraceGuard), with host ms, device busy, kernels and launch
     calls per step and peak memory of both; then 1B sampled generate()
     through the graphs against warped_probs on the card (chi-square), and
     whether B8's and B9's programmatic dependent launches still start early
     when replayed from a graph;
 12. the quantized KV cache (phase_kv_quant): the int8 / fp8 e4m3 / e5m2
     code modes of B1, B4, B5 and B3 against their plain versions (B1 at
     the 1B shape, buckets 512 and 8704, batch 1 and 4, q_len 1 and 4, at
     16896 batch 1, and Qwen3's; B4 at blocks of 32 and 16; B1 and B4 with
     an fp32 q; B5 after a prefix; B3 at both RAGGED_POINTS; each
     bit-identical twice); the bf16 twins' B1 at 8704 and 16896 and B2 at
     the 8192- and 16384-token prompts against their plain versions; the
     code modes timed beside the bf16 mode with their bounds at code bytes
     and SDPA on K/V dequantized beforehand; the long-context rows
     bf16_1b_8k_kvq8 and bf16_1b_16k_kvq8 at full width and depth with
     graphs on and off (equal tokens, bit-identical final scales, the
     graphed decode step profiled) beside their bf16 twins with graphs on
     (and the 8k row with fp8 codes): tokens, B1 launches equal to the
     twin's, cache bytes, peak memory, decode ms per token; the kv-int8
     teacher-forced gate; and the split and ragged drains, sync and
     1-ahead, with an int8 cache, graphs on and off (code-mode launches, no
     fault, equal tokens);
 13. speculative decoding (run after the ragged serving phase): B3 on
     verify rows of 2–4 tokens 196 and 1000 deep beside a chunk and decode
     rows, and B1 with K = 4 queries a row, against their plain versions,
     each bit-identical twice; B1 K = 4 timed (B3 at RAGGED_POINTS["spec"]
     with the other points); serving_1b_int8_spec_ragged (the int8 1B
     target with a random 4-layer draft (a) and with its own params as the
     draft (b), 1-ahead and sync, graphs on and off: identical tokens and
     launches, nothing captured after the seal, one mixed_step_spec
     dispatch a step, B3 / B2 / B1 counts from the dispatches, no fault,
     the teacher-forced token gate, with (b) every rejected draft at a near
     tie and an fp32 twin accepting >= 0.9), profiled beside the plain
     ragged 1-ahead drain; the split path with (b) (B1 K = 4 verify
     launches); FusedSpecModelForCausalLM with (a) and (b) beside plain
     generate().
 14. the multi-replica front-end (phase_router): bench.py's
     serving_1b_int8_router, _router_threaded, _elastic and _disagg rows
     (the int8 1B at full width and depth, 2 replicas sharing the card,
     least_loaded, 8 requests of 128 + 128 tokens, each replica its own
     weights): the sequential and the threaded router over the paged cache,
     the elastic fleet (the highest-id replica retired at step 2, a fresh
     session re-joining over its app), the disaggregated tier (a prefill
     stage handing each prompt's KV line to 2 contiguous decode replicas)
     and the same traffic with the tier off; every app warmed and sealed
     first; every request finishes its budget, 0/0/0 rejected / failover /
     re-admitted, threaded tokens equal sequential ones, 8 hand-offs and
     tokens equal to the tier-off drain's, elastic attainment 1.0 with no
     leaked block or thread, no capture after the seal, launches equal to
     the dispatches times the layers; B1 and B2b timed at the row's
     shapes; tok/s, host ms and device-busy share per router step, the
     overlap, per-replica tokens and balance, the hand-off's ms and bytes.
 15. the open-loop goodput rows (phase_workload, on phase 14's warm apps):
     serving_1b_int8_goodput, _goodput_burst, _goodput_chaos and
     _disagg_chaos at bench.py's hardware-scale traces through the workload
     driver on a virtual clock, scored by the SLO scorer with a live
     SloMonitor: bench.py's goodput fields; clean attainment 1.0, burst
     backlog refusals, 0 rejected outside the backlog and 0 quarantined, the
     chaos kill landing with a finite recovery, the tier kill's local
     prefills with every request finished, launches equal to the
     dispatches times the layers, nothing captured.
Each phase prints its seconds. The line before the card's name lists every
kernel with its launches, times and bound; the last line of standard output
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "neuronx_distributed_inference_tpu_torch"


def log(*args):
    print(*args, flush=True)


def all_counts():
    """Every kernel's launch count and the int4 dense route's call count
    (ops/_cuda.py)."""
    from neuronx_distributed_inference_tpu_torch.ops import _cuda

    return {**_cuda.launch_counts(), **_cuda.route_counts()}


def expect_launches(**nonzero):
    """The counts a run must show: ``nonzero`` by kernel (or route) name,
    every other kernel and route of ops/_cuda.py 0."""
    from neuronx_distributed_inference_tpu_torch.ops import _cuda

    return {**{name: 0 for name in (*_cuda.KERNELS, *_cuda.ROUTES)}, **nonzero}


def plain_run(what, fn, *args):
    """``fn(*args)`` with every count read around it, B6 turned off: a
    plain-path run must launch no kernel and take no dense int4 route, or a
    check against it would compare a kernel with itself. The MoE routes
    (``moe_dense``, ``moe_grouped``) are plain PyTorch and may be taken."""
    from neuronx_distributed_inference_tpu_torch.ops import _cuda
    from neuronx_distributed_inference_tpu_torch.ops.kernel_mode import quant_matmul_mode

    _cuda.reset_launch_counts()
    with quant_matmul_mode(False):
        out = fn(*args)
    counts = all_counts()
    if any(counts[name] for name in (*_cuda.KERNELS, "int4_dense")):
        raise SystemExit(f"{what}: the plain run launched kernels: {counts}")
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


#: cycles of the spin kernel queued before each timed launch (~0.5 ms)
SPIN_CYCLES = 1_000_000


def time_ms(torch, fn, iters=40, warmup=5, spin=SPIN_CYCLES):
    """Mean device time of ``fn`` over ``iters`` launches, each timed by its
    own CUDA events after a 64 MiB write that evicts the 50 MB L2 (on the
    main path, each attention call follows ~100 MB of weight traffic). A
    spin kernel of ``spin`` cycles queued before the start event keeps the
    card busy while the host runs the wrapper and enqueues the launch, so
    the events time the device's work and not the host's launch cost (an
    eager layer of many kernels needs a longer spin)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        flush.zero_()
        torch.cuda._sleep(spin)
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def graphed_ms(torch, fn):
    """time_ms of ``fn`` captured once into a CUDA graph and replayed: the
    device time of its kernels without the host's cost of launching them
    one by one (a yardstick made of many small launches)."""
    fn()  # warm: allocations and library handles outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(torch, graph.replay)


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


def fused_qkv_inputs(torch, rng, B, S, Hq, Hkv, D, dtype, hidden=2048, qk_norm=False, theta=500000.0):
    """q, k, v as the main path hands them to the flash kernel: qkv_project
    over one fused (hidden, (Hq + 2 Hkv) D) weight, so v is a split view
    with token stride (Hq + 2 Hkv) D and q, k carry RoPE (after Qwen3's
    per-head RMSNorm with ``qk_norm``, norm weights drawn around 1)."""
    from neuronx_distributed_inference_tpu_torch.modules.attention import AttnSpec, qkv_project
    from neuronx_distributed_inference_tpu_torch.modules.rope import default_inv_freq, rope_cos_sin

    x = torch.from_numpy(rng.randn(B, S, hidden).astype(np.float32)).to("cuda", dtype)
    w = torch.from_numpy(
        rng.randn(hidden, (Hq + 2 * Hkv) * D).astype(np.float32) * (0.5 / hidden ** 0.5)
    ).to("cuda", dtype)  # q, k, v entries of std ~0.5
    pos = torch.arange(S, device="cuda")[None, :].expand(B, S)
    cos, sin = rope_cos_sin(pos, default_inv_freq(D, theta).cuda())
    spec = AttnSpec(num_heads=Hq, num_kv_heads=Hkv, head_dim=D, qk_norm=qk_norm)
    params = {"qkv_proj": {"weight": w}}
    if qk_norm:
        for name in ("q_norm", "k_norm"):
            params[name] = {"weight": torch.from_numpy(1 + 0.1 * rng.randn(D).astype(np.float32)).to("cuda", dtype)}
    q, k, v = qkv_project(params, x, cos, sin, spec)
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
    # Qwen3-30B-A3B's prefill: GQA 8:1 (32 q over 4 kv heads), D=128, q and
    # k through the per-head RMSNorm, the CTE bucket 128 (and 512)
    for dtype in (torch.bfloat16, torch.float32):
        for S in (128, 512):
            for B in (1, 2):
                q, k, v = fused_qkv_inputs(torch, rng, B, S, 32, 4, 128, dtype, qk_norm=True, theta=1e6)
                kv = np.ones((B, S), np.int32)
                if B == 2:
                    kv[1, int(S * 0.6):] = 0
                key_valid = torch.from_numpy(kv).cuda()
                kw = dict(scale=128 ** -0.5, causal=True, softmax_bf16=False, window=None, chunk=None)
                case = f"qwen3 layout B={B} S={S} Hq=32 Hkv=4 D=128 qk-norm {str(dtype)[6:]}"
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
    # Qwen3-30B-A3B's decode: GQA 8:1 (32 q over 4 kv heads), D=128, the TKG
    # bucket 512, batch 1 and 8 (one row shallow: dead tiles)
    for dtype in (torch.bfloat16, torch.float32):
        for B in (1, 8):
            for K in (1, 4):
                valid = [505, 90, 300, 128, 512, 17, 400, 256][:B]
                q, kc, vc, mask = _decode_inputs(torch, rng, B, K, 32, 4, 128, 3, 1024, 512, dtype, valid)
                kw = dict(scale=128 ** -0.5, n_kv=4)
                case = f"qwen3 B={B} Hq=32 Hkv=4 D=128 {str(dtype)[6:]} K={K} bucket=512"
                worst = max(worst, check_decode(torch, da, q, kc, vc, 1, mask, None, kw, case))
                n += 1
    log(f"tkg_decode_attention: {n} cases agree with the plain version (largest abs err {worst:.3e})")


def check_repeat(torch, what, fn, case):
    """Run ``fn`` twice on the same inputs: the outputs must be equal bit for
    bit (every sum in a fixed order, no atomics)."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    a, b = (a if isinstance(a, tuple) else (a,)), (b if isinstance(b, tuple) else (b,))
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise SystemExit(f"{what} is not bit-identical across two launches: {case}")
    log(f"  {what} {case}: two launches bit-identical")


def phase_decode_split_parity(torch, da):
    """B1's kv split against the plain version: the 64-row group
    (K = 16, n_rep 4), one split (the (row, kv head) pairs fill the card:
    eight tiles through the two-stage pipeline), rows with no valid key (all
    splits dead) with and without a sink, batch 8 at bucket 1024, a bucket
    no split divides, a 4096 bucket (two tiles a split); each case launched
    twice, bit-identical."""
    from neuronx_distributed_inference_tpu_torch.ops import _cuda

    rng = np.random.RandomState(11)
    sms = _cuda.sm_count(torch.device("cuda"))
    n = 0
    for D in (64, 128):
        for dtype in (torch.bfloat16, torch.float32):
            for B, K, Hkv, bucket, valid, dead, sink in (
                (2, 16, 8, 512, [500, 90], None, False),  # 64 rows a group
                (20, 1, 8, 512, [512 - 13 * i for i in range(20)], None, True),  # one split
                (3, 1, 8, 512, [400, 300, 200], 1, True),  # a row with no valid key, a sink
                (3, 4, 4, 512, [512, 260, 100], 2, False),  # ... without a sink
                (8, 1, 8, 1024, [1024, 1000, 900, 700, 513, 300, 64, 17], None, False),  # batch 8
                (2, 1, 8, 1000, [1000, 333], None, True),  # the last split shorter
                (1, 1, 8, 4096, [4000], None, False),  # 32 splits of two tiles
            ):
                Hq = 32
                q, kc, vc, mask = _decode_inputs(
                    torch, rng, B, K, Hq, Hkv, D, 2, max(1024, bucket), bucket, dtype, valid
                )
                if dead is not None:
                    mask[dead] = False
                sk = torch.from_numpy(rng.randn(Hq).astype(np.float32)).cuda() if sink else None
                kw = dict(scale=D ** -0.5, n_kv=Hkv)
                splits, per = da.decode_kv_split(bucket, B * Hkv, sms)
                case = (f"D={D} {str(dtype)[6:]} B={B} K={K} Hkv={Hkv} bucket={bucket} sink={sink} "
                        f"dead row={dead} splits={splits}x{per}")
                out = da.tkg_decode_attention(q, kc, vc, 1, mask, sk, **kw)
                ref = da.tkg_decode_attention_plain(q.float(), kc.float(), vc.float(), 1, mask, sk, **kw)
                torch.cuda.synchronize()
                rows = mask[:, 0].any(dim=-1)  # (B, K): rows with a valid key
                if sink:
                    rows = torch.ones_like(rows)  # the plain version is exactly zero there too
                check_close(torch, out, ref, case, "tkg_decode_attention", rows=rows)
                if dead is not None and not (out[dead] == 0).all():
                    raise SystemExit(f"tkg_decode_attention: a row with no valid key is not exactly zero: {case}")
                check_repeat(torch, "tkg_decode_attention", lambda: da.tkg_decode_attention(q, kc, vc, 1, mask, sk, **kw), case)
                n += 1
    log(f"tkg_decode_attention split cases: {n} agree with the plain version, each bit-identical twice")
    return n


def phase_flash_layout_parity(torch, fa):
    """B2 at sequence lengths no 64-row block divides and on the fused
    QKV projection's strided views at D = 128 (Llama-3-8B's layout: token
    stride (32 + 16) * 128), both dtypes and softmax modes; each case
    launched twice, bit-identical."""
    rng = np.random.RandomState(12)
    n = 0
    for dtype in (torch.bfloat16, torch.float32):
        for S, D, B in ((77, 64, 2), (200, 64, 1), (200, 128, 2), (128, 128, 1), (512, 128, 2)):
            for softmax_bf16 in ((False, True) if D == 64 else (False,)):
                q, k, v = fused_qkv_inputs(torch, rng, B, S, 32, 8, D, dtype, hidden=1024)
                kv = np.ones((B, S), np.int32)
                if B == 2:
                    kv[1, int(S * 0.6):] = 0
                key_valid = torch.from_numpy(kv).cuda()
                kw = dict(scale=D ** -0.5, causal=True, softmax_bf16=softmax_bf16, window=None, chunk=None)
                case = (f"B={B} S={S} Hq=32 Hkv=8 D={D} {str(dtype)[6:]} softmax_bf16={softmax_bf16} "
                        f"v strides {v.stride()}")
                check_flash(torch, fa, q, k, v, key_valid, kw, case)
                check_repeat(torch, "flash_attention", lambda: fa.flash_attention_fwd(q, k, v, key_valid, **kw), case)
                n += 1
    log(f"flash_attention layout cases: {n} agree with the plain version, each bit-identical twice")
    return n


def ptxas_summary(report):
    """{kernel: "N registers, S bytes spill stores, L bytes spill loads"} from a ptxas report
    (kernel names without the namespace's mangled prefix)."""
    import re

    out, name = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = re.sub(r"^.*_cu_[0-9a-f]{8}\d+", "", line.split("'")[1])
        elif name and "spill stores" in line:
            stores, loads = line.split(",")[1:3]
            out[name] = f"{stores.strip()}, {loads.strip()}"
        elif name and "registers" in line:
            out[name] = f"{line.split('Used')[1].split(',')[0].strip()}, " + out.get(name, "")
    return out


# ---------------------------------------------------------------------------
# 4. kernel times at the main path's shapes
# ---------------------------------------------------------------------------


def log_split(torch, da, B, Hkv, bucket):
    """B1's kv split and grid at one shape (ops/decode_attention.py)."""
    from neuronx_distributed_inference_tpu_torch.ops import _cuda

    splits, per = da.decode_kv_split(bucket, B * Hkv, _cuda.sm_count(torch.device("cuda")))
    log(f"  B1 at B={B} Hkv={Hkv} bucket={bucket}: {splits} splits of {per} positions, grid "
        f"({Hkv}, {B}, {splits}) = {Hkv * B * splits} blocks{' + the combine launch' if splits > 1 else ''}")


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
        log_split(torch, da, B, Hkv, bucket)
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
    # Qwen3-30B-A3B's decode step: 32 q over 4 kv heads, D=128, bucket 512
    L, bucket, Hkv, D = 48, 512, 4, 128
    valid = bucket - 100
    q, kc, vc, _ = _decode_inputs(torch, rng, B, 1, Hq, Hkv, D, L, S_max, bucket, torch.bfloat16, [valid])
    cols = torch.arange(bucket, device="cuda")[None, :]
    mask = token_gen_mask((cols < valid).to(torch.int32), 1)
    kw = dict(scale=D ** -0.5, n_kv=Hkv)
    layer = {"i": 0}

    def next_l():
        layer["i"] = (layer["i"] + 1) % L
        return layer["i"]

    err = check_decode(torch, da, q, kc, vc, 0, mask, None, kw, f"timed qwen3 B=1 K=1 bucket={bucket} valid={valid}")
    log_split(torch, da, B, Hkv, bucket)
    qt = q.transpose(1, 2)
    kt = kc[0, :B, :bucket].permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, dim=1)
    vt = vc[0, :B, :bucket].permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, dim=1)
    ms = time_ms(torch, lambda: da.tkg_decode_attention(q, kc, vc, next_l(), mask, None, **kw))
    plain_ms = time_ms(torch, lambda: da.tkg_decode_attention_plain(q, kc, vc, next_l(), mask, None, **kw))
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
    b_ms, b_by = bound(*decode_work(q, kc, mask))
    rows[("decode_attention", bucket, "qwen3")] = dict(
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err
    )
    log(
        f"tkg_decode_attention qwen3 B=1 K=1 bucket={bucket} valid={valid} Hq=32 Hkv=4 D=128 bf16: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), err vs plain {err:.3e}"
    )
    del kc, vc
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
    0, as the session's decode pass builds them); the Qwen3 head-shape
    cases (qwen3_paged_decode_parity). Then the split cases
    (phase_paged_decode_split_parity). Returns the number of cases of each
    part: each launches B4 once, each split case twice more."""
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
    n += qwen3_paged_decode_parity(torch, da)
    log(f"paged_tkg_decode_attention: {n} cases agree with the plain version (largest abs err {worst:.3e})")
    return n, phase_paged_decode_split_parity(torch, da)


def phase_paged_decode_split_parity(torch, da):
    """B4's kv split (B1's rule over the table's MB * bs positions) against
    the plain version on every row, inactive ones included: widths that are
    no multiple of 64 (MB 27: splits that start inside a block), a zero
    entry inside a row's valid range with the mask true there (a block-0
    chunk beside valid positions in a live tile: both read zeros, never the
    NaN), a sink, the serving row's decode shape (16 splits of one tile),
    and batch 20 (one split: every tile through the two-stage pipeline);
    each case launched twice, bit-identical. Returns the number of cases."""
    from neuronx_distributed_inference_tpu_torch.modules.masks import spec_token_gen_mask
    from neuronx_distributed_inference_tpu_torch.ops import _cuda

    rng = np.random.RandomState(13)
    sms = _cuda.sm_count(torch.device("cuda"))
    Hq, Hkv, L, n = 32, 8, 2, 0
    for D in (64, 128):
        for dtype in (torch.bfloat16, torch.float32):
            for B, K, bs, MB, lens, hole, sink in (
                (1, 1, 32, 27, [800], False, False),  # 864 wide
                (3, 4, 16, 27, [430, 100, 0], True, True),  # 432 wide, a hole in row 0, an inactive row
                (8, 1, 32, 32, [192, 1000, 0, 33, 192, 64, 511, 1], True, False),  # the serving decode shape
                (20, 1, 16, 24, [384 - 17 * i for i in range(20)], False, False),  # one split
            ):
                NB = MB * B + 4
                table = paged_tables(rng, lens, MB, bs, NB)
                if hole:
                    table[0, 5] = 0  # inside row 0's valid range
                k, v = paged_pool(torch, rng, L, NB, Hkv, bs, D, dtype)
                q = torch.from_numpy(rng.randn(B, K, Hq, D).astype(np.float32) * DECODE_Q_STD).to("cuda", dtype)
                lens_a = np.array(lens)
                pos = np.where(lens_a[:, None] > 0, lens_a[:, None] - K + np.arange(K)[None, :], 0)
                attn = (np.arange(MB * bs)[None, :] < np.maximum(lens_a, 1)[:, None]).astype(np.int32)
                mask = spec_token_gen_mask(torch.from_numpy(attn).cuda(), torch.from_numpy(pos).cuda())
                bt = torch.from_numpy(table).cuda()
                sk = torch.from_numpy(rng.randn(Hq).astype(np.float32)).cuda() if sink else None
                kw = dict(scale=D ** -0.5, n_kv=Hkv)
                splits, per = da.decode_kv_split(MB * bs, B * Hkv, sms)
                case = (f"B={B} K={K} bs={bs} MB={MB} D={D} {str(dtype)[6:]} hole={hole} sink={sink} "
                        f"splits={splits}x{per}")
                before = _cuda.launch_counts()["paged_decode_attention"]
                out = da.paged_tkg_decode_attention(q, k, v, 1, bt, mask, sk, **kw)
                torch.cuda.synchronize()
                if _cuda.launch_counts()["paged_decode_attention"] != before + 1:
                    raise SystemExit(f"paged decode split case did not launch B4 once: {case}")
                ref = da.paged_tkg_decode_attention_plain(q.float(), k.float(), v.float(), 1, bt, mask, sk, **kw)
                check_close(torch, out, ref, case, "paged_tkg_decode_attention")
                check_repeat(torch, "paged_tkg_decode_attention",
                             lambda: da.paged_tkg_decode_attention(q, k, v, 1, bt, mask, sk, **kw), case)
                n += 1
    log(f"paged_tkg_decode_attention split cases: {n} agree with the plain version on every row, each "
        "bit-identical twice")
    return n


#: kv positions per tile of B5's online softmax (paged::BKV)
B5_KV_TILE = 64
#: a probability within this many fp32 ulps (2^-16 of it) of a bf16
#: rounding midpoint may round either way when the kernel's scores differ
#: from the plain version's in the last bits (summation order)
P_FLIP_ULPS = 128


def paged_flash_plain_bf16_p(torch, pf, q, k, v, bt, pos, lim, *, scale, n_rep, tile, k_scale=None, v_scale=None):
    """paged_flash_attention_plain in fp32 with the probabilities rounded
    to bf16 before P.V (the kernel's one extra rounding, and the TPU MXU's
    at default precision), computed as B5's online softmax computes them:
    over kv tiles of ``tile`` positions, each row keeps its running max m
    (of the scaled scores), takes p = 2^(s scale log2e - m log2e) with one
    rounding of the argument (the kernel's FFMA), sums the fp32 p into l
    and shrinks l and the accumulator by 2^((m_old - m_new) log2e) at each
    tile. So p is rounded to bf16 relative to the running max, not the
    final one. With ``tile`` at least the context, m is the final max, as
    in the plain version. Code blocks (k, v int8/fp8) come with their
    (Hkv,) factors, as the code mode uses them: the raw scores are over the
    codes (each a bf16 value), K's factor multiplies the score scale in
    fp32, V's the normalized output. Returns (out, flip), both (B, Sq, Hq,
    D) fp32: ``flip`` is what the output moves by if every probability
    within P_FLIP_ULPS of a bf16 rounding midpoint rounds the other way
    (one bf16 ulp each, shrunk and normalized as its term of the output)."""
    from neuronx_distributed_inference_tpu_torch.modules.attention import repeat_kv
    from neuronx_distributed_inference_tpu_torch.modules.block_kvcache import read_block_cache_at_layer

    k_r, v_r = read_block_cache_at_layer(k[None].float(), v[None].float(), 0, bt)
    kf, vt = repeat_kv(k_r, n_rep), repeat_kv(v_r, n_rep).transpose(1, 2)  # vt: (B, Hq, S, D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf)  # raw scores, as the kernel's Q.K^T
    kv_pos = torch.arange(kf.shape[1], device=q.device)[None, None, None, :]
    mask = (kv_pos <= pos.to(torch.int64)[:, None, :, None]) & (kv_pos < lim.to(torch.int64)[:, None, None, None])
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32, device=q.device)
    ones = torch.ones(s.shape[1], dtype=torch.float32, device=q.device)
    k_f = ones if k_scale is None else k_scale.float().repeat_interleave(n_rep)
    v_f = ones if v_scale is None else v_scale.float().repeat_interleave(n_rep)
    scale_t = (torch.tensor(scale, dtype=torch.float32, device=q.device) * k_f)[None, :, None]  # (1, Hq, 1)
    scale2 = (scale_t * log2e).double()[..., None]
    m = torch.full(s.shape[:-1], pf.NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((*s.shape[:-1], vt.shape[-1]), dtype=torch.float32, device=q.device)
    flip = torch.zeros_like(acc)
    for t0 in range(0, s.shape[-1], tile):
        st, mt, vs = s[..., t0:t0 + tile], mask[..., t0:t0 + tile], vt[..., t0:t0 + tile, :]
        mx = torch.where(mt, st, pf.NEG_INF).amax(dim=-1)
        m_new = torch.maximum(m, torch.where(mx > pf.NEG_INF, mx * scale_t, pf.NEG_INF))
        alpha = torch.exp2((m - m_new) * log2e)
        # s * scale2 - m_new log2e rounded once: the fp32 product is exact in fp64
        arg = (st.double() * scale2 - (m_new * log2e).double()[..., None]).float()
        p = torch.where(mt, torch.exp2(arg), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + p.to(torch.bfloat16).float() @ vs
        # the low 16 bits of an fp32 p decide its bf16 rounding: 0x8000 is the midpoint
        near = mt & ((p.view(torch.int32) & 0xFFFF) - 0x8000).abs().lt(P_FLIP_ULPS) & (p > 0)
        ulp = torch.ldexp(torch.ones_like(p), torch.frexp(p).exponent - 8)  # a bf16 ulp of p
        flip = flip * alpha[..., None] + torch.where(near, ulp, 0.0) @ vs.abs()
        m = m_new
    denom = torch.clamp(l, min=1e-30)[..., None]
    v_f = v_f[None, :, None, None]
    return (acc / denom * v_f).transpose(1, 2), (flip / denom * v_f).transpose(1, 2)


def exact_score_inputs(torch, q, k):
    """q rounded to quarters (|q| <= 12) and k to eighths (|k| <= 3), NaN
    kept in block 0: every product is a multiple of 2^-5 and every Q.K^T sum
    stays below 2^24 of them, so the scores are exact in fp32 in any
    summation order, the kernel's and the plain version's alike."""
    qq = (q.float() * 4).round().clamp(-48, 48).div(4).to(q.dtype)
    kq = (k.float() * 8).round().clamp(-24, 24).div(8).to(k.dtype)
    kq[0] = float("nan")
    return qq, kq


def check_paged_flash(torch, pf, q, k, v, bt, pos, lim, kw, case, exact_scores=False, codes=None, factors=None):
    """One B5 launch against its plain versions on the same inputs, then two
    more launches that must be bit-identical. Over code blocks, ``codes``
    are the kernel's scale kwargs (the layer's running scales and qmax,
    as the model passes them) and ``factors`` the plain versions' (scale /
    qmax); the launch must count once under the code mode. fp32:
    within check_close's bound of paged_flash_attention_plain. bf16, two
    parts: (1) against the plain version that rounds P to bf16 at P.V as
    the kernel does, relative to the running max of its kv tiles
    (paged_flash_plain_bf16_p at B5_KV_TILE): within check_close's
    one-rounding bound alone on ``exact_scores`` inputs (exact_score_inputs:
    the two compute the same scores bit for bit); on other inputs, whose
    scores differ in the last bits, within that bound plus one bf16 ulp of
    each probability within P_FLIP_ULPS of a rounding midpoint (check_close's
    share alone, and against the plain at one tile, P rounded relative to
    the final max, printed beside it); (2) within B2's bf16 tolerance
    (flash_tolerances) of the unchanged plain version. Only rows with a
    valid key are compared; kv_limit-0 rows must be exactly zero. Returns
    the max abs error against the unchanged plain version."""
    counter = "paged_flash_attention_codes" if codes else "paged_flash_attention"
    kernel_kw, plain_kw = {**kw, **(codes or {})}, {**kw, **(factors or {})}
    out = _code_launch(torch, counter, lambda: pf.paged_flash_attention(q, k, v, bt, pos, lim, **kernel_kw))
    ref = pf.paged_flash_attention_plain(q.float(), k.float(), v.float(), bt, pos, lim, **plain_kw)
    torch.cuda.synchronize()
    if (out[lim == 0] != 0).any():
        raise SystemExit(f"paged_flash_attention: a kv_limit-0 row is not zero: {case}")
    check_repeat(torch, counter, lambda: pf.paged_flash_attention(q, k, v, bt, pos, lim, **kernel_kw), case)
    # a query row has a valid key when its position and the limit allow one
    rows = (pos >= 0) & (lim[:, None] > 0)
    if q.dtype != torch.bfloat16:
        return check_close(torch, out, ref, case, counter, rows)
    if not torch.isfinite(out.float()).all():
        raise SystemExit(f"paged_flash_attention returned non-finite values: {case}")
    o = out.float()[rows]
    r, flip = (t[rows] for t in paged_flash_plain_bf16_p(torch, pf, q, k, v, bt, pos, lim, **plain_kw,
                                                         tile=B5_KV_TILE))
    diff = (o - r).abs()
    one = DECODE_ATOL + DECODE_RTOL_BF16 * r.abs()
    share_one = (diff / one).max().item()
    use = share_one if exact_scores else (diff / (one + flip)).max().item()
    r_final = paged_flash_plain_bf16_p(torch, pf, q, k, v, bt, pos, lim, **plain_kw,
                                       tile=k.shape[2] * bt.shape[1])[0]
    share_final = ((o - r_final[rows]).abs() / one).max().item()
    err = (out.float() - ref.float()).abs()[rows].max().item()
    tol = flash_tolerances(torch, q.dtype, False)[0]
    ok = use <= 1.0 and err <= tol
    bound = "" if exact_scores else f" + the flips of the p within {P_FLIP_ULPS} fp32 ulps of a bf16 midpoint"
    log(
        f"  {counter} {case}: vs plain with bf16 P (running max, {B5_KV_TILE}-position tiles) max abs "
        f"err {diff.max().item():.3e}, share of (atol {DECODE_ATOL:.0e} + rtol {DECODE_RTOL_BF16:.2e} x |plain|{bound}) "
        f"{use:.3f} (check_close's alone {share_one:.3f}; P rounded against the final max: {share_final:.3f}); "
        f"vs plain max abs err {err:.3e} (tol {tol:.1e}) {'ok' if ok else 'FAIL'}"
    )
    if not ok:
        raise SystemExit(f"paged_flash_attention disagrees with its plain version: {case}")
    return err


def paged_flash_rows(torch, rng, B, Sq, MB, bs, NB):
    """B5's parity rows on the card: prefix + causal (starts 70, 0, 200,
    3, 300), a kv_limit that is not a block multiple, and at batch 8
    kv_limit-0 rows (inactive), within the table's MB * bs positions.
    Returns (table, pos, lim) on the card."""
    starts = np.array([70, 0, 0, 200, 0, 3, 300, 0][:B])
    news = np.array([Sq, Sq, 0, 41, 0, Sq - 9, 77, 0][:B])  # new tokens; 0 = inactive
    limits = np.where(news > 0, starts + news, 0)
    if (limits > MB * bs).any():
        limits = np.minimum(limits, MB * bs)
        starts = np.minimum(starts, np.maximum(limits - news, 0))
    table = paged_tables(rng, limits, MB, bs, NB)
    pos = starts[:, None] + np.arange(Sq)[None, :]
    return tuple(torch.from_numpy(a.astype(np.int32)).cuda() for a in (table, pos, limits))


def phase_paged_flash_parity(torch, pf):
    """B5 at batch 1 and 8, block size 16 and 32, D 64 and 128, Hq 32 / Hkv 8,
    bf16 and fp32, Sq 128 (the serving row's chunk): prefix + causal, a
    kv_limit that is not a block multiple, zero-table tails, NaN in block 0
    and, at batch 8, kv_limit 0 rows, which must be exactly zero
    (paged_flash_rows); bf16 checked in two parts (check_paged_flash), on
    the random inputs and again on exact-score inputs (exact_score_inputs);
    each case launched twice, bit-identical; then the Qwen3 head-shape
    cases (qwen3_paged_flash_parity)."""
    rng = np.random.RandomState(4)
    worst, n = 0.0, 0
    Hq, Hkv, MB, Sq = 32, 8, 16, 128
    for D in (64, 128):
        for bs in (16, 32):
            for dtype in (torch.bfloat16, torch.float32):
                for B in (1, 8):
                    NB = MB * B + 4
                    bt, pos, lim = paged_flash_rows(torch, rng, B, Sq, MB, bs, NB)
                    k, v = paged_pool(torch, rng, 1, NB, Hkv, bs, D, dtype)
                    k, v = k[0], v[0]
                    q = torch.from_numpy(rng.randn(B, Sq, Hq, D).astype(np.float32) * DECODE_Q_STD).to("cuda", dtype)
                    kw = dict(scale=D ** -0.5, n_rep=Hq // Hkv)
                    limits = lim.cpu().numpy()
                    case = f"B={B} Sq={Sq} bs={bs} D={D} {str(dtype)[6:]} kv_limit {limits.tolist()}"
                    for exact in (False, True) if dtype == torch.bfloat16 else (False,):
                        qc, kc = exact_score_inputs(torch, q, k) if exact else (q, k)
                        what = f"{case}{', exact scores' if exact else ''}"
                        worst = max(worst, check_paged_flash(torch, pf, qc, kc, v, bt, pos, lim, kw, what, exact))
                        n += 1
    n += qwen3_paged_flash_parity(torch, pf)
    log(f"paged_flash_attention: {n} cases agree with the plain version, each bit-identical twice "
        f"(largest abs err {worst:.3e})")


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
    """B4 and B5 at the serving row's shapes (paged_times at the 1B heads)."""
    return paged_times(torch, da, pf, np.random.RandomState(5), 32, 8, 64)


def paged_times(torch, da, pf, rng, Hq, Hkv, D, tag=None):
    """B4 and B5 at the serving row's shapes with Hq / Hkv heads of D, each
    held to its plain version first, beside the plain version,
    F.scaled_dot_product_attention on K/V gathered beforehand (the gather
    not timed; a yardstick only), and the bound for the same work. Rows are
    keyed by kernel name, or (name, ``tag``) with a tag."""
    import torch.nn.functional as F

    from neuronx_distributed_inference_tpu_torch.modules.block_kvcache import read_block_cache_at_layer
    from neuronx_distributed_inference_tpu_torch.ops import _cuda

    rows = {}
    heads = f"Hq={Hq} Hkv={Hkv} D={D}"
    # decode: 8 rows, mid-stream at 128 prompt + 64 generated tokens
    ctx = 192
    q, k, v, bt, mask = serving_decode_inputs(torch, rng, ctx, Hq=Hq, Hkv=Hkv, D=D)
    kw = dict(scale=D ** -0.5, n_kv=Hkv)
    out = da.paged_tkg_decode_attention(q, k, v, 0, bt, mask, None, **kw)
    ref = da.paged_tkg_decode_attention_plain(q.float(), k.float(), v.float(), 0, bt, mask, None, **kw)
    err = check_close(torch, out, ref, f"timed B=8 ctx={ctx} bs=32 bucket=1024 {heads} bf16", "paged_tkg_decode_attention")
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
    rows["paged_decode_attention" if tag is None else ("paged_decode_attention", tag)] = dict(
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err
    )
    splits, per = da.decode_kv_split(bt.shape[1] * k.shape[3], B * Hkv, _cuda.sm_count(q.device))
    parts = launch_breakdown(torch, lambda: da.paged_tkg_decode_attention(q, k, v, 0, bt, mask, None, **kw),
                             ("split", "combine") if splits > 1 else ("split",))
    log(
        f"paged_tkg_decode_attention B=8 ctx={ctx} bs=32 bucket=1024 {heads} bf16: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), err vs plain {err:.3e}; "
        f"{splits} splits of {per} positions, grid ({Hkv}, {B}, {splits}) = {Hkv * B * splits} blocks; device us "
        "per launch: " + ", ".join(f"{name} {us:.2f}" for name, us in parts.items())
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
    err = check_paged_flash(torch, pf, q, k, v, bt, pos, lim, kw, f"timed B=8 Sq=128 kv_limit=128 bs=32 bucket=1024 {heads} bf16")
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
    rows["paged_flash_attention" if tag is None else ("paged_flash_attention", tag)] = dict(
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err
    )
    log(
        f"paged_flash_attention B=8 Sq=128 kv_limit=128 bs=32 bucket=1024 {heads} bf16: kernel {ms:.4f} ms, "
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


def ragged_plain_bf16_p(torch, rp, q, k, v, table, rs, rl, cl, *, scale, n_rep, k_scale=None, v_scale=None):
    """B3's plain version for the slots of its tensor-core tiles (bf16 rows
    of more than one new token, ops/ragged_paged_attention.py::tile_route):
    B5's paged_flash_plain_bf16_p on each such row (its segment's queries at
    their positions over its table row, ctx_len the limit), P rounded to
    bf16 relative to the running max of B5_KV_TILE-position tiles as the
    kernel rounds it; code blocks with their (Hkv,) factors, as B5's.
    Returns (out, flip), (T, Hq, D) fp32, zero on other slots."""
    from neuronx_distributed_inference_tpu_torch.ops import paged_flash_attention as pf

    positions, _ = rp.packed_positions(q.shape[0], rs, rl, cl)
    out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    flip = torch.zeros_like(out)
    for r, (s0, n) in enumerate(zip(rs.tolist(), rl.tolist())):
        if rp.tile_route(n, q.dtype, k.dtype) != "prefill":
            continue
        o, f = paged_flash_plain_bf16_p(
            torch, pf, q[s0 : s0 + n][None], k, v, table[r : r + 1], positions[s0 : s0 + n][None], cl[r : r + 1],
            scale=scale, n_rep=n_rep, tile=B5_KV_TILE, k_scale=k_scale, v_scale=v_scale,
        )
        out[s0 : s0 + n], flip[s0 : s0 + n] = o[0], f[0]
    return out, flip


def check_ragged(torch, rp, case_inputs, case, atol, exact_scores=False, codes=None, factors=None):
    """One B3 launch against its plain versions on the same values, then two
    more launches that must be bit-identical. Over code blocks, ``codes``
    are the kernel's scale kwargs and ``factors`` the plain versions' (as
    check_paged_flash's), and the launch must count once under the code
    mode. The padded slots must be exact
    zeros. Slots of fp32 launches and of decode tiles (tile_route): within
    check_close's one-rounding bound of the plain version in fp32. Slots of
    bf16 tensor-core tiles, as B5's (check_paged_flash): within that bound
    of ragged_plain_bf16_p, which rounds P as the kernel does, alone on
    ``exact_scores`` inputs (exact_score_inputs) and plus the flips of the
    probabilities within P_FLIP_ULPS of a bf16 midpoint on others; and
    within B2's bf16 tolerance (flash_tolerances) of the plain version.
    Returns the max abs error against the plain version."""
    q, k, v, table, rs, rl, cl, valid = case_inputs
    kw = dict(scale=q.shape[-1] ** -0.5, n_rep=q.shape[1] // k.shape[1])
    counter = "ragged_paged_attention_codes" if codes else "ragged_paged_attention"
    kernel_kw, plain_kw = {**kw, **(codes or {})}, {**kw, **(factors or {})}
    out = _code_launch(torch, counter, lambda: rp.ragged_paged_attention(q, k, v, table, rs, rl, cl, **kernel_kw))
    if (out[~valid] != 0).any():
        raise SystemExit(f"ragged_paged_attention: a padded slot is not exact zeros: {case}")
    ref = rp.ragged_paged_attention_plain(q.float(), k.float(), v.float(), table, rs, rl, cl, **plain_kw)
    _, row_id = rp.packed_positions(q.shape[0], rs, rl, cl)
    mma = valid & torch.tensor(
        [rp.tile_route(n, q.dtype, k.dtype) == "prefill" for n in rl.tolist()], device=q.device
    )[row_id]
    err = 0.0
    if (valid & ~mma).any():
        err = check_close(torch, out, ref, f"{case}, fp32 FMA slots", counter, valid & ~mma, atol=atol)
    if mma.any():
        if not torch.isfinite(out.float()).all():
            raise SystemExit(f"ragged_paged_attention returned non-finite values: {case}")
        o = out.float()[mma]
        r, flip = (t[mma] for t in ragged_plain_bf16_p(torch, rp, q, k, v, table, rs, rl, cl, **plain_kw))
        diff = (o - r).abs()
        one = atol + DECODE_RTOL_BF16 * r.abs()
        share_one = (diff / one).max().item()
        use = share_one if exact_scores else (diff / (one + flip)).max().item()
        err_mma = (out.float() - ref.float()).abs()[mma].max().item()
        tol = flash_tolerances(torch, q.dtype, False)[0]
        ok = use <= 1.0 and err_mma <= tol
        extra = "" if exact_scores else f" + the flips of the p within {P_FLIP_ULPS} fp32 ulps of a bf16 midpoint"
        log(
            f"  {counter} {case}, tensor-core slots: vs plain with bf16 P ({B5_KV_TILE}-position tiles) "
            f"max abs err {diff.max().item():.3e}, share of (atol {atol:.0e} + rtol {DECODE_RTOL_BF16:.2e} x "
            f"|plain|{extra}) {use:.3f} (check_close's alone {share_one:.3f}); vs plain max abs err {err_mma:.3e} "
            f"(tol {tol:.1e}) {'ok' if ok else 'FAIL'}"
        )
        if not ok:
            raise SystemExit(f"ragged_paged_attention disagrees with its plain version: {case}")
        err = max(err, err_mma)
    check_repeat(torch, counter, lambda: rp.ragged_paged_attention(q, k, v, table, rs, rl, cl, **kernel_kw), case)
    return err


#: B3's split cases: a chunk that starts mid-context beside decode rows 1,
#: 63, 64, 65 and 1000 deep and one at the table's full width (1024), in one
#: launch: (row_len, ctx_len)
RAGGED_SPLIT_ROWS = ([37, 1, 1, 1, 1, 1, 1], [37 + 250, 1, 63, 64, 65, 1000, 1024])


def phase_ragged_parity(torch, rp):
    """B3 at D 64 and 128, block size 16 and 32, bf16 and fp32, n_rep 1, 4
    and 8 (8 kv heads): a chunk that starts mid-context, a chunk from 0 of a
    non-16 length, decode rows, inactive rows (row_len 0 starting at 0 and
    past the packed end), NaN in block 0 and zero-table tails; then
    RAGGED_SPLIT_ROWS at a table 1024 wide (decode rows whose kv axis splits
    over the grid, each split count printed); then the serving row's two
    timed points (roofline.RAGGED_POINTS) at their shapes, and at Qwen3's
    heads (qwen3_ragged_parity). Every bf16 case
    runs again on exact-score inputs (exact_score_inputs). Tolerances:
    check_ragged (one bf16 rounding, 1e-5 at fp32; B5's P-rounding
    reference for tensor-core tiles); every case bit-identical twice."""
    from neuronx_distributed_inference_tpu_torch.ops import _cuda
    from neuronx_distributed_inference_tpu_torch.ops.roofline import RAGGED_POINTS

    rng = np.random.RandomState(7)
    worst, n = 0.0, 0

    def run(inputs, case, atol):
        nonlocal worst, n
        bf16 = inputs[0].dtype == torch.bfloat16
        for exact in (False, True) if bf16 else (False,):
            q, k = exact_score_inputs(torch, inputs[0], inputs[1]) if exact else inputs[:2]
            what = f"{case}{', exact scores' if exact else ''}"
            worst = max(worst, check_ragged(torch, rp, (q, k, *inputs[2:]), what, atol, exact))
            n += 1

    Hkv, MB = 8, 12
    row_len = [0, 41, 1, 16, 1, 3, 0, 1]
    for D in (64, 128):
        for bs in (16, 32):
            for dtype in (torch.bfloat16, torch.float32):
                atol = DECODE_ATOL if dtype == torch.bfloat16 else RAGGED_FP32_ATOL
                for n_rep in (1, 4, 8):
                    ctx_len = [0, 41 + 70, min(150, MB * bs), 16, 9, 3 + 100, 0, 1]
                    inputs = ragged_case(torch, rng, row_len, ctx_len, Hkv * n_rep, Hkv, D, bs, MB, dtype)
                    run(inputs, f"D={D} bs={bs} {str(dtype)[6:]} n_rep={n_rep} row_len {row_len} ctx_len {ctx_len}", atol)
                for n_rep in (1, 4, 8):
                    width = 1024
                    split_len, split_ctx = (list(a) for a in RAGGED_SPLIT_ROWS)
                    inputs = ragged_case(torch, rng, split_len, split_ctx, Hkv * n_rep, Hkv, D, bs, width // bs, dtype)
                    T = inputs[0].shape[0]
                    splits, per = (rp.ragged_decode_split(T, width, Hkv, n_rep, _cuda.sm_count(inputs[0].device))
                                   if dtype == torch.bfloat16 else (1, width))
                    run(inputs, f"split D={D} bs={bs} {str(dtype)[6:]} n_rep={n_rep} row_len {split_len} ctx_len "
                        f"{split_ctx} width {width} ({splits} splits of {per})", atol)
    for name, pt in RAGGED_POINTS.items():
        bs = pt["block_size"]
        inputs = ragged_case(
            torch, rng, list(pt["row_len"]), list(pt["ctx_len"]), 32, 8, 64, bs, pt["width"] // bs,
            torch.bfloat16, NB=512,
        )
        run(inputs, f"serving {name} point, bf16", DECODE_ATOL)
    n += qwen3_ragged_parity(torch, rp)
    log(f"ragged_paged_attention: {n} cases agree with the plain version, each bit-identical twice "
        f"(largest abs err {worst:.3e})")
    return n


def sdpa_per_row(torch, q, k_r, v_r, rs, rl, cl, width, n_rep):
    """B3's library yardstick's operands: for each active row, its packed
    queries, its gathered K / V (R, W, Hkv, D) with the kv heads repeated,
    and its causal mask over the context, built beforehand."""
    cols = torch.arange(width, device="cuda")
    per_row = []
    for r, (s0, n, c) in enumerate(zip(rs.tolist(), rl.tolist(), cl.tolist())):
        if n:
            qpos = torch.arange(c - n, c, device="cuda")
            per_row.append((
                q[s0 : s0 + n].transpose(0, 1)[None],
                k_r[r].transpose(0, 1).repeat_interleave(n_rep, dim=0)[None],
                v_r[r].transpose(0, 1).repeat_interleave(n_rep, dim=0)[None],
                ((cols[None, :] <= qpos[:, None]) & (cols[None, :] < c))[None, None],
            ))
    return per_row


def sdpa_per_row_ms(torch, F, per_row):
    """(eager, graphed) ms of one F.scaled_dot_product_attention per row:
    eager, the host's launches bound it (a dozen calls); replayed from a
    CUDA graph (graphed_ms), the device's work alone, the yardstick."""
    def run():
        return [F.scaled_dot_product_attention(a, b, c, attn_mask=m) for a, b, c, m in per_row]

    return time_ms(torch, run), graphed_ms(torch, run)


def phase_ragged_times(torch, rp):
    """B3 at the serving row's points (ragged_times at the 1B heads)."""
    return ragged_times(torch, rp, np.random.RandomState(8), 32, 8, 64)


def ragged_times(torch, rp, rng, Hq, Hkv, D, tag=None):
    """B3 at the serving row's points (roofline.RAGGED_POINTS) with Hq / Hkv
    heads of D, held to its plain version first, beside the plain version,
    the bound for this run's inputs, and a library yardstick:
    F.scaled_dot_product_attention per active row on K/V gathered
    beforehand with a mask built beforehand (neither timed), replayed from
    a CUDA graph (device time; the eager loop's host-bound time printed
    beside it). Rows are keyed (kernel name, point), or (name, point, tag)."""
    import torch.nn.functional as F

    from neuronx_distributed_inference_tpu_torch.modules.block_kvcache import read_block_cache_at_layer
    from neuronx_distributed_inference_tpu_torch.ops import _cuda
    from neuronx_distributed_inference_tpu_torch.ops.roofline import RAGGED_POINTS, ragged_work

    rows = {}
    n_rep = Hq // Hkv
    for name, pt in RAGGED_POINTS.items():
        bs, width = pt["block_size"], pt["width"]
        inputs = ragged_case(
            torch, rng, list(pt["row_len"]), list(pt["ctx_len"]), Hq, Hkv, D, bs, width // bs, torch.bfloat16,
            NB=512,
        )
        q, k, v, table, rs, rl, cl, _ = inputs
        err = check_ragged(torch, rp, inputs, f"timed serving {name} point, Hq={Hq} Hkv={Hkv} D={D} bf16", DECODE_ATOL)
        kw = dict(scale=D ** -0.5, n_rep=n_rep)
        k_r, v_r = read_block_cache_at_layer(k[None], v[None], 0, table)
        per_row = sdpa_per_row(torch, q, k_r, v_r, rs, rl, cl, width, n_rep)
        ms = time_ms(torch, lambda: rp.ragged_paged_attention(q, k, v, table, rs, rl, cl, **kw))
        plain_ms = time_ms(torch, lambda: rp.ragged_paged_attention_plain(q, k, v, table, rs, rl, cl, **kw))
        eager_ms, lib_ms = sdpa_per_row_ms(torch, F, per_row)
        nbytes, flops = ragged_work(
            rl.tolist(), cl.tolist(), width, bs, dict(Hq=q.shape[1], Hkv=k.shape[1], D=q.shape[2]), q.element_size()
        )
        b_ms, b_by = bound(nbytes, flops)
        rows[("ragged_paged_attention", name) + ((tag,) if tag else ())] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err
        )
        splits, per = rp.ragged_decode_split(q.shape[0], width, k.shape[1], n_rep, _cuda.sm_count(q.device))
        log(
            f"ragged_paged_attention {name} point (row_len {list(pt['row_len'])}, ctx_len {list(pt['ctx_len'])}, "
            f"bs={bs} width={width} Hq={Hq} Hkv={Hkv} D={D} bf16; decode tiles in {splits} splits of {per}): "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa per row replayed from a graph {lib_ms:.4f} ms "
            f"(eager, host-bound: {eager_ms:.4f}), bound {b_ms:.5f} ms ({b_by}), err vs plain {err:.3e}"
        )
        del k_r, v_r, per_row
    return rows


# ---------------------------------------------------------------------------
# 3c'. B4, B5 and B3 at Qwen3-30B-A3B's head shape
# ---------------------------------------------------------------------------

#: Qwen3-30B-A3B's attention heads (models/mixtral.QWEN3_30B_A3B): 32 q and
#: 4 kv heads of 128, n_rep 8
QWEN3_HEADS = dict(Hq=32, Hkv=4, D=128)


def qwen3_paged_decode_parity(torch, da):
    """B4 at Qwen3's head shape, block size 32, bf16, q_len 1: batch 1 and
    the serving decode step's 8 rows over a 1024-wide table (mid-stream
    depths, one inactive row), NaN in block 0 and zero-table tails; active
    rows within check_close's bound of the plain version. Returns the number
    of cases (each launches B4 once)."""
    from neuronx_distributed_inference_tpu_torch.modules.masks import spec_token_gen_mask
    from neuronx_distributed_inference_tpu_torch.ops import _cuda

    rng = np.random.RandomState(23)
    Hq, Hkv, D = QWEN3_HEADS["Hq"], QWEN3_HEADS["Hkv"], QWEN3_HEADS["D"]
    bs, MB, L, n = 32, 32, 2, 0
    for lens in ([412], [192, 1000, 0, 33, 192, 64, 511, 129]):
        B = len(lens)
        NB = MB * B + 4
        bt = torch.from_numpy(paged_tables(rng, lens, MB, bs, NB)).cuda()
        k, v = paged_pool(torch, rng, L, NB, Hkv, bs, D, torch.bfloat16)
        q = torch.from_numpy(rng.randn(B, 1, Hq, D).astype(np.float32) * DECODE_Q_STD).to("cuda", torch.bfloat16)
        lens_a = np.array(lens)
        pos = np.where(lens_a[:, None] > 0, lens_a[:, None] - 1, 0)
        attn = (np.arange(MB * bs)[None, :] < np.maximum(lens_a, 1)[:, None]).astype(np.int32)
        mask = spec_token_gen_mask(torch.from_numpy(attn).cuda(), torch.from_numpy(pos).cuda())
        kw = dict(scale=D ** -0.5, n_kv=Hkv)
        case = f"qwen3 heads B={B} bs={bs} bucket={MB * bs} Hq={Hq} Hkv={Hkv} D={D} bf16"
        before = _cuda.launch_counts()["paged_decode_attention"]
        out = da.paged_tkg_decode_attention(q, k, v, 1, bt, mask, None, **kw)
        torch.cuda.synchronize()
        if _cuda.launch_counts()["paged_decode_attention"] != before + 1:
            raise SystemExit(f"paged decode case did not launch B4: {case}")
        ref = da.paged_tkg_decode_attention_plain(q.float(), k.float(), v.float(), 1, bt, mask, None, **kw)
        check_close(torch, out, ref, case, "paged_tkg_decode_attention", torch.from_numpy(lens_a > 0).cuda())
        n += 1
    return n


def qwen3_paged_flash_parity(torch, pf):
    """B5 at Qwen3's head shape, block size 32, bf16, the serving chunk of
    128 queries at batch 1 and 8 over a 1024-wide table (paged_flash_rows:
    prefix + causal rows, kv_limit-0 rows), on random and on exact-score
    inputs (check_paged_flash, each launched twice more, bit-identical).
    Returns the number of cases."""
    rng = np.random.RandomState(24)
    Hq, Hkv, D = QWEN3_HEADS["Hq"], QWEN3_HEADS["Hkv"], QWEN3_HEADS["D"]
    bs, MB, Sq, n = 32, 32, 128, 0
    for B in (1, 8):
        NB = MB * B + 4
        bt, pos, lim = paged_flash_rows(torch, rng, B, Sq, MB, bs, NB)
        k, v = paged_pool(torch, rng, 1, NB, Hkv, bs, D, torch.bfloat16)
        k, v = k[0], v[0]
        q = torch.from_numpy(rng.randn(B, Sq, Hq, D).astype(np.float32) * DECODE_Q_STD).to("cuda", torch.bfloat16)
        kw = dict(scale=D ** -0.5, n_rep=Hq // Hkv)
        case = f"qwen3 heads B={B} Sq={Sq} bs={bs} Hq={Hq} Hkv={Hkv} D={D} bf16 kv_limit {lim.tolist()}"
        for exact in (False, True):
            qc, kc = exact_score_inputs(torch, q, k) if exact else (q, k)
            check_paged_flash(torch, pf, qc, kc, v, bt, pos, lim, kw, f"{case}{', exact scores' if exact else ''}", exact)
            n += 1
    return n


def qwen3_ragged_parity(torch, rp):
    """B3 at Qwen3's head shape, bf16, at the serving row's points
    (roofline.RAGGED_POINTS: a 128-token chunk beside 7 decode rows, 8
    decode rows, a chunk beside 7 verify rows) over a 1024-wide table, on
    random and on exact-score inputs (check_ragged, each launched twice
    more, bit-identical). Returns the number of cases."""
    from neuronx_distributed_inference_tpu_torch.ops.roofline import RAGGED_POINTS

    rng = np.random.RandomState(25)
    Hq, Hkv, D = QWEN3_HEADS["Hq"], QWEN3_HEADS["Hkv"], QWEN3_HEADS["D"]
    n = 0
    for name, pt in RAGGED_POINTS.items():
        bs = pt["block_size"]
        inputs = ragged_case(
            torch, rng, list(pt["row_len"]), list(pt["ctx_len"]), Hq, Hkv, D, bs, pt["width"] // bs, torch.bfloat16,
            NB=512,
        )
        for exact in (False, True):
            q, k = exact_score_inputs(torch, inputs[0], inputs[1]) if exact else inputs[:2]
            what = f"qwen3 heads serving {name} point, Hq={Hq} Hkv={Hkv} D={D} bf16{', exact scores' if exact else ''}"
            check_ragged(torch, rp, (q, k, *inputs[2:]), what, DECODE_ATOL, exact)
            n += 1
    return n


def phase_qwen3_shape_times(torch, da, pf, rp):
    """B4, B5 and B3 at the Qwen3 serving row's shapes (8 rows at bucket
    1024, block size 32, Qwen3's heads): paged_times and ragged_times, each
    beside its plain version, SDPA on gathered K/V (B3: per row, replayed
    from a graph) and the bound. Rows keyed with the tag "qwen3"."""
    h = QWEN3_HEADS
    rows = paged_times(torch, da, pf, np.random.RandomState(26), h["Hq"], h["Hkv"], h["D"], tag="qwen3")
    rows.update(ragged_times(torch, rp, np.random.RandomState(27), h["Hq"], h["Hkv"], h["D"], tag="qwen3"))
    return rows


# ---------------------------------------------------------------------------
# 3d. the int4 fused-dequant matmul (B6) against its plain version
# ---------------------------------------------------------------------------

QMM_FP32_RTOL = 1e-5  # of max |plain|
QMM_BF16_RTOL = 2.0 ** -8  # one bf16 rounding of |plain in fp32|


def qmm_shapes():
    """(label, K, N): every int4 projection of the 8B and 1B rows
    (ops/roofline.py), and a padded K with an N that is not a multiple of
    128 or of 4."""
    from neuronx_distributed_inference_tpu_torch.ops.roofline import MODEL_1B, MODEL_8B, int4_projections

    shapes = []
    for label, m in (("8b", MODEL_8B), ("1b", MODEL_1B)):
        shapes += [(f"{label} {name}", K, N) for name, (K, N) in int4_projections(m).items()]
    return shapes + [("padded", 1000, 200), ("padded odd", 1000, 203)]


def qmm_inputs(torch, gen, K, N):
    """Random codes over all 256 byte values and a distinct random scale per
    (group, column), between 0.5 and 1.5 times 0.01, so a wrong group or
    plane moves the output far past the tolerance."""
    kp = -(-K // 256) * 256
    packed = torch.randint(0, 256, (kp // 2, N), generator=gen, device="cuda", dtype=torch.uint8)
    scale = (torch.rand((kp // 128, N), generator=gen, device="cuda") + 0.5) * 0.01
    return packed, scale


def check_qmm(torch, qmm, x, packed, scale, case):
    """One B6 launch against the plain version: fp32 within QMM_FP32_RTOL of
    max |plain|; bf16 within one bf16 rounding of the plain version's fp32
    result (the same inputs, upcast) plus QMM_FP32_RTOL of its max. Returns
    the max abs error."""
    from neuronx_distributed_inference_tpu_torch.ops import _cuda

    before = _cuda.launch_counts()["quant_matmul"]
    out = qmm.quant_matmul(x, packed, scale)
    torch.cuda.synchronize()
    if _cuda.launch_counts()["quant_matmul"] != before + 1:
        raise SystemExit(f"quant_matmul case did not launch B6: {case}")
    ref = qmm.quant_matmul_plain(x.float(), packed, scale)
    o = out.float()
    if not torch.isfinite(o).all():
        raise SystemExit(f"quant_matmul returned non-finite values: {case}")
    atol = QMM_FP32_RTOL * ref.abs().max().item()
    rtol = QMM_BF16_RTOL if x.dtype == torch.bfloat16 else 0.0
    diff = (o - ref).abs()
    err = diff.max().item()
    use = (diff / (atol + rtol * ref.abs())).max().item()
    ok = use <= 1.0
    log(
        f"  quant_matmul {case}: max abs err {err:.3e}, largest share of the bound (atol {atol:.1e} "
        f"+ rtol {rtol:.2e} x |plain|) {use:.3f}, |plain| up to {ref.abs().max().item():.3f} {'ok' if ok else 'FAIL'}"
    )
    if not ok:
        raise SystemExit(f"quant_matmul disagrees with its plain version: {case}")
    return err


#: B6's parity row counts: 1, 2, 8, 16 and 64, and 3, 5, 24 and 40, row
#: tiles that pad the tensor cores' m16 tile
QMM_PARITY_ROWS = (1, 2, 3, 5, 8, 16, 24, 40, 64)


def qmm_grid_text(torch, qmm, rows, K, N, dtype):
    """B6's split count and grid at one shape (ops/quant_matmul.py)."""
    from neuronx_distributed_inference_tpu_torch.ops import _cuda

    kp = -(-K // 256) * 256
    cols, row_tiles, splits, per = qmm.qmm_grid(rows, kp // 2, N, dtype, _cuda.sm_count(torch.device("cuda")))
    return (f"{splits} splits of {per} pairs, grid ({cols}, {row_tiles}, {splits}) = {cols * row_tiles * splits} "
            f"blocks{' + the combine launch' if splits > 1 else ''}")


def phase_quant_matmul_parity(torch, qmm):
    """B6 at rows QMM_PARITY_ROWS, bf16 and fp32, over every shape of
    qmm_shapes(), each case launched twice, bit-identical."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    worst, n = 0.0, 0
    for label, K, N in qmm_shapes():
        packed, scale = qmm_inputs(torch, gen, K, N)
        for rows in QMM_PARITY_ROWS:
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn((rows, K), generator=gen, device="cuda").to(dtype)
                case = f"{label} rows={rows} K={K} N={N} {str(dtype)[6:]}: {qmm_grid_text(torch, qmm, rows, K, N, dtype)}"
                worst = max(worst, check_qmm(torch, qmm, x, packed, scale, case))
                check_repeat(torch, "quant_matmul", lambda: qmm.quant_matmul(x, packed, scale), case)
                n += 1
        del packed, scale
    log(f"quant_matmul: {n} cases agree with the plain version, each bit-identical twice (largest abs err {worst:.3e})")
    return n


def phase_quant_matmul_times(torch, qmm):
    """B6 at the 8B row's projections at 1 row and the 1B row's at 8 rows
    (ops/roofline.QMM_POINTS), bf16, held to its plain version first, beside
    the plain version, torch.matmul of x by the weight dequantized to bf16
    beforehand (not timed; the cost the int4 format is meant to beat), and
    the bound of ops/roofline.int4_matmul."""
    from neuronx_distributed_inference_tpu_torch.ops.roofline import QMM_POINTS, int4_matmul, int4_projections

    rows_out = {}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)
    for label, pt in QMM_POINTS.items():
        rows = pt["rows"]
        for name, (K, N) in int4_projections(pt["m"]).items():
            packed, scale = qmm_inputs(torch, gen, K, N)
            x = torch.randn((rows, K), generator=gen, device="cuda").to(torch.bfloat16)
            case = f"timed {label} {name} rows={rows} K={K} N={N} bf16"
            err = check_qmm(torch, qmm, x, packed, scale, case)
            w = qmm.dequantize_int4(packed, scale, K, torch.bfloat16)
            ms = time_ms(torch, lambda: qmm.quant_matmul(x, packed, scale))
            plain_ms = time_ms(torch, lambda: qmm.quant_matmul_plain(x, packed, scale), iters=10)
            lib_ms = time_ms(torch, lambda: torch.matmul(x, w))
            b_ms, b_by = bound(*int4_matmul(rows, K, N))
            rows_out[("quant_matmul", label, name)] = dict(
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
            )
            log(
                f"quant_matmul {label} {name} rows={rows} K={K} N={N} bf16 "
                f"({qmm_grid_text(torch, qmm, rows, K, N, torch.bfloat16)}): kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, matmul on the bf16 weight {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), "
                f"{b_ms / ms:.3f} of the bound, err vs plain {err:.3e}"
            )
            del packed, scale, w
    return rows_out


# ---------------------------------------------------------------------------
# 5. the main path
# ---------------------------------------------------------------------------


def _config(batch_size, model=None, **kw):
    """The bf16_1b_bs1 row's configuration (Llama-3.2-1B shapes unless
    ``model`` gives others), ``kw`` overriding its Config fields."""
    from neuronx_distributed_inference_tpu_torch.config import Config
    from neuronx_distributed_inference_tpu_torch.models.llama import LLAMA_1B, LlamaInferenceConfig

    base = dict(
        batch_size=batch_size, seq_len=1024, dtype="bfloat16",
        context_encoding_buckets=[128, 512], token_generation_buckets=[512, 1024],
        fused_qkv=True, seed=0, device="cuda",
    )
    tc = Config(**{**base, **kw})
    attrs = model or LLAMA_1B
    return LlamaInferenceConfig(tc, load_config=lambda c: [setattr(c, k, v) for k, v in attrs.items()])


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
    launches = all_counts()
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


#: steps of each traced chunk (reading a trace costs the host a fraction of
#: a ms for every kernel in it: ~1000 a 1B step)
PROFILE_STEPS = 8


def phase_profile(torch, app, seq, prompt_len, steps=PROFILE_STEPS, label="decode step", bucket=512):
    """Where a decode step's time goes: one ``steps``-step decode chunk in
    ``bucket`` over every row of ``seq`` ((S,) or (B, S) tokens; it
    re-decodes from the first generated token, rewriting cache positions
    the generate() run already wrote)."""
    from neuronx_distributed_inference_tpu_torch.modules.sampling import prepare_sampling_params

    seq = np.atleast_2d(seq)
    B = seq.shape[0]
    args = (
        seq[:, prompt_len : prompt_len + 1], np.full((B, 1), prompt_len + 1), np.arange(B, dtype=np.int32),
        prepare_sampling_params(B),
    )

    def chunk():
        app.token_generation_model.decode_chunk(app.params, app.kv_cache, *args, num_steps=steps, bucket=bucket)
        torch.cuda.synchronize()

    return profile_chunk(torch, chunk, steps, f"{label} (batch {B}, bucket {bucket})")


def port_kernel_name(name):
    """A port kernel's profiler name without its namespace and arguments:
    ``split_kernel<__nv_bfloat16, 64, 2>``."""
    import re

    m = re.search(r"nxdi::(?:\(anonymous namespace\)::)?(\w+(?:<(?:[^()]|\(anonymous namespace\))*>)?)", name)
    return m.group(1) if m else name[:60]


def union_ms(intervals):
    """The length in ms of the union of (start, end) intervals in us: the
    device time while any of them ran. Launches that overlap (B7's down and
    combine start while the launch before them drains, and wait inside)
    count once; summing their durations would count the wait too."""
    total, covered = 0.0, float("-inf")
    for start, end in sorted(intervals):
        start = max(start, covered)
        if end > start:
            total += end - start
            covered = end
    return total / 1e3


def profile_chunk(torch, chunk, steps, label):
    """Run ``chunk`` (``steps`` decode steps ending in a synchronize) once
    to warm, once timed on the host clock without the profiler, then once
    traced with torch.profiler for the device's busy time (the union of the
    kernels' intervals), the kernels by name (their summed durations) and
    the host-side operators by their own (self) CPU time."""
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
    intervals = [(e.name, e.time_range.start, e.time_range.end) for e in kernels]
    busy_ms = union_ms((start, end) for _, start, end in intervals)
    by_name, calls = {}, {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        calls[e.name] = calls.get(e.name, 0) + 1
    log(
        f"{label}: {step_ms:.3f} ms on the host clock; traced chunk "
        f"{traced_ms:.1f} ms for {steps} steps, device busy {busy_ms:.2f} ms "
        f"({busy_ms / traced_ms:.3f} of the traced wall time), {len(kernels) / steps:.0f} kernels per step"
    )
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"  {ms / steps:8.4f} ms/step  {name[:110]}")
    port = sorted(((port_kernel_name(n), ms) for n, ms in by_name.items() if "nxdi::" in n), key=lambda kv: -kv[1])
    if port:
        log("  port kernels, ms/step: " + ", ".join(f"{n} {ms / steps:.4f}" for n, ms in port))
    averages = prof.key_averages()
    host_ops = sorted(averages, key=lambda e: -e.self_cpu_time_total)[:8]
    for e in host_ops:
        log(f"  host {e.self_cpu_time_total / 1e3 / steps:8.4f} ms/step, {e.count / steps:6.1f} calls/step  {e.key[:90]}")
    # the launch calls of the CUDA runtime: kernels one by one (cudaLaunchKernel,
    # and cudaLaunchKernelExC for the programmatic dependent launches) or a
    # whole captured graph at once (cudaGraphLaunch)
    launch_api = {
        name: (sum(e.self_cpu_time_total for e in averages if e.key.startswith(name)) / 1e3 / steps,
               sum(e.count for e in averages if e.key.startswith(name)) / steps)
        for name in ("cudaLaunchKernelEx", "cudaGraphLaunch")
    }
    launch_api["cudaLaunchKernel"] = (
        sum(e.self_cpu_time_total for e in averages if e.key == "cudaLaunchKernel") / 1e3 / steps,
        sum(e.count for e in averages if e.key == "cudaLaunchKernel") / steps,
    )
    log("  launch calls, host ms/step (calls/step): " + ", ".join(
        f"{name} {ms:.3f} ({n:.1f})" for name, (ms, n) in launch_api.items()
    ))
    return dict(
        launch_api=launch_api,
        decode_step_ms=step_ms, device_busy_frac=busy_ms / traced_ms, device_busy_ms=busy_ms / steps,
        kernels_per_step=len(kernels) / steps,
        kernel_ms_per_step={name: ms / steps for name, ms in by_name.items()},
        kernel_calls_per_step={name: n / steps for name, n in calls.items()},
        busy_ms_per_step=lambda keep: union_ms((a, b) for n, a, b in intervals if keep(n)) / steps,
    )


def b6_per_step(profile):
    """B6's device ms and kernels per step in a profile (its tensor-core or
    FMA launch and, where K is split, its combine launch)."""
    ms = calls = combine = 0.0
    for name, t in profile["kernel_ms_per_step"].items():
        short = port_kernel_name(name)
        if short.startswith("qmm_"):
            ms += t
            calls += profile["kernel_calls_per_step"][name]
            if short.startswith("qmm_combine"):
                combine += profile["kernel_calls_per_step"][name]
    return ms, calls, combine


def phase_serving_profile(torch, app, ctx=192, steps=PROFILE_STEPS):
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
    gate = _forced_gate(k, pl, f32, "teacher-forced logits")
    # the fused layer's gate (phase_fused_1b) reuses the same references
    return dict(gate, forced_seq=seq, plain_logits=pl, fp32_logits=f32)


def _forced_gate(k, pl, f32, what, exit_on_fail=True):
    """Gate the kernel path's logits ``k`` against the plain path's ``pl``,
    both against fp32 ``f32`` (see teacher_forced). With ``exit_on_fail``
    False a failure is returned (``passed`` False) instead of exiting."""
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
    passed = not (max_k32 > FORCED_RATIO * max_p32 or rms_k32 > FORCED_RATIO * rms_p32 or not agree.all())
    if not passed and exit_on_fail:
        raise SystemExit("kernel path sits farther from fp32 than the plain path allows")
    return dict(
        kernel_vs_plain=err, kernel_vs_fp32=max_k32, plain_vs_fp32=max_p32,
        kernel_vs_fp32_rms=rms_k32, plain_vs_fp32_rms=rms_p32, passed=passed,
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
    launches = all_counts()
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
    launches2 = all_counts()
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
    kl = all_counts()
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
    launches = all_counts()
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
        buckets=dict(tel.buckets),
    )


def phase_ragged_serving(torch, params, split_tokens):
    """The serving_1b_int8_ragged row's configuration in bf16 (int8 weights
    wait for A6): _serving_config with serving_ragged, on _serve's traffic,
    synchronous (the row pins serving_ragged_async=False) and 1-ahead, each
    warmed by one pass, then measured in turns (sync, 1-ahead, 1-ahead,
    sync: host-clock metrics drift on a shared host); a short run without
    chunked prefill; the ragged teacher-forced check and a profile of
    PROFILE_STEPS steady-state steps."""
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
    launches3 = all_counts()
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


#: B3's kernels by profiler name: the fp32 launch and the bf16 one (tensor-core
#: prefill tiles and split decode tiles)
B3_KERNELS = ("ragged_paged_kernel", "ragged_bf16_kernel")


def phase_ragged_profile(torch, app, prompts, label, steps=PROFILE_STEPS):
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
    b3 = sum(ms for name, ms in prof["kernel_ms_per_step"].items() if any(k in name for k in B3_KERNELS))
    log(f"  B3 ({' + '.join(B3_KERNELS)}) {b3:.4f} ms/step")
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
    kl = all_counts()
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


# ---------------------------------------------------------------------------
# 8. the quantized paths
# ---------------------------------------------------------------------------

#: bf16_8b_int4's teacher-forced gate runs the first layers of the 8B model:
#: an fp32 copy of all 32 (~32 GB) would crowd the 80 GB card
INT4_8B_FORCED_LAYERS = 8
#: int4 projections per layer: fused QKV, o, gate, up, down
INT4_PROJ_PER_LAYER = 5


def _config_8b_int4(model=None, **kw):
    """The bf16_8b_int4 row's configuration (bench.py:1218-1223): Llama-3.1-8B
    shapes, grouped int4 weights, bf16, batch 1, seq 1024, CTE bucket [128],
    TKG bucket [512], fused QKV."""
    from neuronx_distributed_inference_tpu_torch.models.llama import LLAMA_8B

    return _config(
        1, model=model or LLAMA_8B, weight_dtype="int4", context_encoding_buckets=[128],
        token_generation_buckets=[512], **kw,
    )


def _config_1b_int8(**kw):
    """The int8_1b_bs1 row's configuration (bench.py:1034-1038, built with
    fused_qkv = not quantized at bench.py:182-185): Llama-3.2-1B shapes,
    int8 per-channel weights, lm head included, CTE bucket [128], TKG [512]."""
    return _config(
        1, weight_dtype="int8", fused_qkv=False, context_encoding_buckets=[128],
        token_generation_buckets=[512], **kw,
    )


def _dequantized(tree, dtype):
    """The params with every quantized entry replaced by its dequantized
    weight (int4: codes x group scales; int8: codes x channel scales) and
    every other float leaf in ``dtype``."""
    import torch

    from neuronx_distributed_inference_tpu_torch.ops import quant_matmul as qmm

    if isinstance(tree, list):
        return [_dequantized(v, dtype) for v in tree]
    if isinstance(tree, dict) and "scale" in tree:
        w, sc = tree["weight"], tree["scale"]
        if w.dtype == torch.uint8:
            return {"weight": qmm.dequantize_int4(w, sc, None, dtype)}
        return {"weight": (w.float() * sc[..., None, :]).to(dtype)}
    if isinstance(tree, dict):
        return {k: _dequantized(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def quantized_teacher_forced(torch, cfg_fn, params, seq, prompt_len, want, label):
    """The kernel path on the quantized weights against the plain path
    (attention kernels and B6 off) on the same weights and an fp32 run of
    the plain path on the dequantized weights, teacher-forced over ``seq``
    through forward(); the kernel run's counts must equal ``want``. The gate
    of the other teacher-forced checks (FORCED_RATIO by max and RMS, argmax
    on decided positions)."""
    off = dict(attn_kernel_enabled=False, attn_block_tkg_kernel_enabled=False)
    from neuronx_distributed_inference_tpu_torch.ops import _cuda

    _cuda.reset_launch_counts()
    k = _forced_logits(torch, cfg_fn(output_logits=True), params, seq, prompt_len)
    if all_counts() != want:
        raise SystemExit(f"{label}: kernel run counts {all_counts()} != {want}")
    pl = plain_run(f"{label} bf16", _forced_logits, torch, cfg_fn(output_logits=True, **off), params, seq, prompt_len)
    params32 = _dequantized(params, torch.float32)
    f32 = plain_run(
        f"{label} fp32", _forced_logits, torch, cfg_fn(output_logits=True, dtype="float32", **off), params32, seq,
        prompt_len,
    )
    del params32
    torch.cuda.empty_cache()
    return _forced_gate(k, pl, f32, label)


def _generate_run(torch, app, prompt_len, n_new, label, batch=1):
    """TTFT (a one-token generate()), then a timed ``n_new``-token generate()
    with the counts read around it, from a seeded prompt of ``batch`` rows.
    Returns (output, metrics); tok/s counts every row's tokens."""
    from neuronx_distributed_inference_tpu_torch.ops import _cuda

    vocab = app.spec.vocab_size
    prompt = np.random.RandomState(0).randint(0, vocab, size=(batch, prompt_len))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = app.generate(prompt, max_new_tokens=1)
    ttft_ms = (time.perf_counter() - t0) * 1e3
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    out = app.generate(prompt, max_new_tokens=n_new)
    total_s = time.perf_counter() - t0
    launches = all_counts()
    peak = torch.cuda.max_memory_allocated()
    decode_tok_s = batch * (n_new - 1) / (total_s - ttft_ms / 1e3)
    log(
        f"{label} (batch {batch}, prompt {prompt_len}, {n_new} new tokens): TTFT {ttft_ms:.2f} ms, generate "
        f"{total_s * 1e3:.1f} ms, decode {decode_tok_s:.1f} tok/s, peak memory {peak / 2**30:.3f} GiB"
    )
    log(f"{label} launches: {launches}")
    gen = out.sequences[:, prompt_len:]
    if gen.shape != (batch, n_new) or gen.min() < 0 or gen.max() >= vocab:
        raise SystemExit(f"{label}: bad generated tokens: shape {gen.shape}, range [{gen.min()}, {gen.max()}]")
    if (first.sequences[:, prompt_len] != out.sequences[:, prompt_len]).any():
        raise SystemExit(f"{label}: first token differs between two generate() calls")
    return out, dict(ttft_ms=ttft_ms, decode_tok_s=decode_tok_s, peak_bytes=peak, launches=launches)


def phase_int4_8b(torch):
    """The bf16_8b_int4 row at full width and depth: seeded random bf16
    weights quantized to int4 at load on the card, greedy generate() of 256
    tokens after a 128-token prompt with exact counts, a profile of one
    16-step decode chunk, and the teacher-forced gate on the first
    INT4_8B_FORCED_LAYERS layers."""
    from neuronx_distributed_inference_tpu_torch.analysis.retrace_guard import RetraceGuard
    from neuronx_distributed_inference_tpu_torch.models.llama import LLAMA_8B
    from neuronx_distributed_inference_tpu_torch.ops.roofline import MODEL_8B, bound_ms, int4_step_bytes
    from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM

    prompt_len, n_new = 128, 256
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    app = ModelForCausalLM(None, _config_8b_int4(retrace_guard=True)).load(random_weights=True)
    torch.cuda.synchronize()
    load_s, load_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    app.warmup()
    torch.cuda.synchronize()
    log(
        f"int4 8B: load (random bf16 weights, int4 at load) {load_s:.2f} s, peak {load_peak / 2**30:.3f} GiB; "
        f"warmup {time.perf_counter() - t0:.2f} s; params {_tree_bytes(app.params) / 2**30:.3f} GiB"
    )
    L = app.spec.num_layers
    with RetraceGuard():  # warmed and sealed: nothing is captured
        out, run = _generate_run(torch, app, prompt_len, n_new, "int4 8B generate()")
    # the prefill's projections have 128 rows (dense route), its lm head one
    # (B6); each of the 256 decode steps runs every projection and the lm
    # head at one row (B6)
    per_step = INT4_PROJ_PER_LAYER * L + 1
    want = expect_launches(
        quant_matmul=1 + 256 * per_step, int4_dense=INT4_PROJ_PER_LAYER * L,
        flash_attention=L, decode_attention=L * 256,
    )
    if run["launches"] != want:
        raise SystemExit(f"int4 8B launch counts {run['launches']} != expected {want}")
    profile = phase_profile(torch, app, out.sequences[0], prompt_len)
    eager = eager_twin(torch, "int4 8B generate()", _config_8b_int4(cuda_graphs=False), app, out, run, prompt_len, n_new)
    b6, b6_calls, b6_combine = b6_per_step(profile)
    busy = sum(profile["kernel_ms_per_step"].values())
    step_bound = bound_ms(int4_step_bytes(MODEL_8B), 0)[0]
    log(
        f"  B6 {b6:.4f} ms/step in {b6_calls:.0f} kernels a step ({b6_combine:.0f} of them split-K combines), "
        f"{b6 / busy:.3f} of the device's busy time ({busy:.3f} ms/step); "
        f"weight bound of the step {step_bound:.4f} ms ({step_bound / b6:.3f} of B6's time); host clock "
        f"{profile['decode_step_ms']:.3f} ms/step"
    )
    n = INT4_8B_FORCED_LAYERS
    params = dict(app.params, layers=app.params["layers"][:n])
    steps = len(out.sequences[0]) - 1 - prompt_len
    forced = quantized_teacher_forced(
        torch, lambda **kw: _config_8b_int4(model={**LLAMA_8B, "num_hidden_layers": n}, **kw), params,
        out.sequences[0], prompt_len,
        expect_launches(
            quant_matmul=1 + steps * (INT4_PROJ_PER_LAYER * n + 1), int4_dense=INT4_PROJ_PER_LAYER * n,
            flash_attention=n, decode_attention=n * steps,
        ),
        f"int4 8B teacher-forced logits (first {n} of {L} layers)",
    )
    del app, params
    torch.cuda.empty_cache()
    return dict(
        run, **profile, b6_ms_per_step=b6, b6_busy_share=b6 / busy, step_bound_ms=step_bound, eager=eager, **forced
    )


def _tree_bytes(tree):
    if isinstance(tree, list):
        return sum(_tree_bytes(v) for v in tree)
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def phase_int8_1b(torch):
    """The int8_1b_bs1 row at full width and depth: the main path's seeded
    random weights quantized to int8 at load, greedy generate() of 256
    tokens after a 128-token prompt (B2 at D=64 and B1; int8 products are
    plain PyTorch, so no B6), and the teacher-forced gate."""
    from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM

    prompt_len, n_new = 128, 256
    t0 = time.perf_counter()
    app = ModelForCausalLM(None, _config_1b_int8()).load(random_weights=True).warmup()
    torch.cuda.synchronize()
    log(f"int8 1B: load (int8 at load) + warmup {time.perf_counter() - t0:.2f} s, params "
        f"{_tree_bytes(app.params) / 2**30:.3f} GiB")
    L = app.spec.num_layers
    out, run = _generate_run(torch, app, prompt_len, n_new, "int8 1B generate()")
    want = expect_launches(flash_attention=L, decode_attention=L * 256)
    if run["launches"] != want:
        raise SystemExit(f"int8 1B launch counts {run['launches']} != expected {want}")
    steps = len(out.sequences[0]) - 1 - prompt_len
    forced = quantized_teacher_forced(
        torch, _config_1b_int8, app.params, out.sequences[0], prompt_len,
        expect_launches(flash_attention=L, decode_attention=L * steps), "int8 1B teacher-forced logits",
    )
    del app
    torch.cuda.empty_cache()
    return dict(run, **forced)


def phase_int4_ragged(torch):
    """The serving_1b_int4_ragged row (bench.py:1063-1068): the ragged
    phase's configuration and traffic, synchronous, with the main path's
    seeded random weights quantized to int4 at load. Counts from the route
    rule and the session's own record: every mixed dispatch launches B3
    once per layer and the lm head's B6 once (its 8 gathered rows); its
    projections go to B6 when the dispatch packs at most 64 tokens, to the
    dense route otherwise."""
    from neuronx_distributed_inference_tpu_torch.ops.kernel_mode import QMM_MAX_ROWS
    from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM
    from neuronx_distributed_inference_tpu_torch.runtime.model_runner import TAG_MIXED_STEP
    from neuronx_distributed_inference_tpu_torch.telemetry import TelemetrySession

    s = SERVING
    t0 = time.perf_counter()
    app = ModelForCausalLM(
        None, _serving_config(serving_ragged=True, serving_ragged_async=False, weight_dtype="int4"),
    ).load(random_weights=True).warmup()
    torch.cuda.synchronize()
    L = app.spec.num_layers
    log(f"int4 ragged serving: load (int4 at load) + warmup {time.perf_counter() - t0:.2f} s")
    rng = np.random.RandomState(0)  # phase_serving's prompts
    prompts = [rng.randint(0, app.spec.vocab_size - 10, size=(s["prompt"],)).tolist() for _ in range(s["n_requests"])]
    _serve(torch, app, prompts, s["gen"], TelemetrySession())  # warm pass
    run = _ragged_run(torch, app, prompts, s["gen"], None, "int4 sync")
    sess = run.pop("sess")
    mixed = sess.dispatches["mixed_step"]
    narrow = sum(n for (tag, b), n in run["buckets"].items() if tag == TAG_MIXED_STEP and b <= QMM_MAX_ROWS)
    wide = sum(n for (tag, b), n in run["buckets"].items() if tag == TAG_MIXED_STEP and b > QMM_MAX_ROWS)
    want = expect_launches(
        ragged_paged_attention=mixed * L,
        quant_matmul=narrow * INT4_PROJ_PER_LAYER * L + mixed,
        int4_dense=wide * INT4_PROJ_PER_LAYER * L,
    )
    log(f"  mixed dispatches {mixed}: {narrow} packing <= {QMM_MAX_ROWS} tokens, {wide} more; buckets {run['buckets']}")
    if run["launches"] != want or narrow + wide != mixed or set(sess.dispatches) != {"mixed_step"}:
        raise SystemExit(f"int4 ragged serving: counts {run['launches']} != {want}, dispatches {dict(sess.dispatches)}")
    del sess
    profile = phase_ragged_profile(torch, app, prompts, "int4 sync")
    b6, b6_calls, b6_combine = b6_per_step(profile)
    log(f"  B6 {b6:.4f} ms/step in {b6_calls:.0f} kernels a step ({b6_combine:.0f} of them split-K combines)")
    del app
    torch.cuda.empty_cache()
    return dict(run, mixed=mixed, narrow=narrow, wide=wide, profile=profile, b6_ms_per_step=b6)

# ---------------------------------------------------------------------------
# B7: selected-experts MoE decode, and the Qwen3-30B-A3B generate() path
# ---------------------------------------------------------------------------

#: fp32 summation-order allowance of B7's check, relative to the largest
#: sum_j |w_j| |y_j| of the case (as QMM_FP32_RTOL for B6)
MOE_FP32_RTOL = 1e-5
#: one bf16 rounding step, relative: two fp32 values a few ulps apart round
#: to bf16 values at most one step (2^-7 of the value) apart
MOE_BF16_STEP = 2.0 ** -7
#: GLU variants of the parity cases: silu, and GPT-OSS's clamped swiglu
MOE_GLUS = {
    "silu": dict(act="silu"),
    "swiglu": dict(act="silu", act_scale=1.702, act_bias=1.0, swiglu_limit=7.0),
}


def moe_inputs(torch, gen, T, k, E, H, I, dtype, pool=None):
    """x (T, H), weights with gate/up entries of std ~2 / sqrt(H) so gate
    values reach past the swiglu limit, down std 1 / sqrt(I), and top-k ids
    drawn without repeats per token from ``pool`` experts (all E when None;
    a small pool makes tokens share experts), with softmax weights."""
    x = torch.randn((T, H), generator=gen, device="cuda").to(dtype)
    wg = (torch.randn((E, H, I), generator=gen, device="cuda") * (2.0 / H ** 0.5)).to(dtype)
    wu = (torch.randn((E, H, I), generator=gen, device="cuda") * (2.0 / H ** 0.5)).to(dtype)
    wd = (torch.randn((E, I, H), generator=gen, device="cuda") * (1.0 / I ** 0.5)).to(dtype)
    n = pool or E
    keys = torch.rand((T, n), generator=gen, device="cuda")
    idx = keys.argsort(dim=1)[:, :k].to(torch.int32)  # k distinct of the pool per token
    w = torch.softmax(torch.randn((T, k), generator=gen, device="cuda"), dim=-1)
    return x, idx, w, wg, wu, wd


def check_moe(torch, md, args, glu, case):
    """One B7 launch against the plain version on the same inputs. The
    bound per element is MOE_BF16_STEP x (sum_j |w_j| |y_j| + |out|) for bf16
    (each selection's output and the combine may each land one bf16 step
    away) plus MOE_FP32_RTOL of the case's largest sum_j |w_j| |y_j|; fp32
    has the second term only. Returns the max abs error."""
    from neuronx_distributed_inference_tpu_torch.ops import _cuda

    x, idx, w, wg, wu, wd = args
    before = _cuda.launch_counts()["moe_decode"]
    out = md.fused_moe_decode(x, idx, w, wg, wu, wd, **glu)
    torch.cuda.synchronize()
    if _cuda.launch_counts()["moe_decode"] != before + 1:
        raise SystemExit(f"fused_moe_decode case did not launch B7: {case}")
    ref = plain_run(f"moe {case}", lambda: md.fused_moe_decode_plain(x, idx, w, wg, wu, wd, **glu)).float()
    y = md.selection_outputs_plain(x, idx, wg, wu, wd, **glu).float()  # (T, k, H)
    mag = torch.einsum("tk,tkh->th", w.abs(), y.abs())
    o = out.float()
    if not torch.isfinite(o).all():
        raise SystemExit(f"fused_moe_decode returned non-finite values: {case}")
    step = MOE_BF16_STEP if x.dtype == torch.bfloat16 else 0.0
    atol = MOE_FP32_RTOL * mag.max().item()
    diff = (o - ref).abs()
    err = diff.max().item()
    use = (diff / (atol + step * (mag + ref.abs()))).max().item()
    ok = use <= 1.0
    log(
        f"  fused_moe_decode {case}: max abs err {err:.3e}, largest share of the bound (atol {atol:.1e} + "
        f"{step:.2e} x (sum|w||y| + |plain|)) {use:.3f}, |plain| up to {ref.abs().max().item():.3f} "
        f"{'ok' if ok else 'FAIL'}"
    )
    if not ok:
        raise SystemExit(f"fused_moe_decode disagrees with its plain version: {case}")
    return err


def moe_cases():
    """(label, T, k, E, H, I, pool): Qwen3-30B-A3B widths at 1, 2 and 8
    tokens (8 x 8 = 64 rows; 2 and 8 tokens drawn from 16 experts, so they
    share; 3, 2 and 1 splits of H), Mixtral-8x7B widths at 1 and 4 tokens,
    and widths no tile divides, each with a ragged last column tile and a
    ragged last split of H: I 333 and H 1001 take the element loads; I 332
    the element loads in bf16 (664-byte rows) and the 16-byte copies in
    fp32; I 328 and H 1000 the 16-byte copies in both."""
    return [
        ("qwen3", 1, 8, 128, 2048, 768, None),
        ("qwen3 shared", 2, 8, 128, 2048, 768, 16),
        ("qwen3 64 rows", 8, 8, 128, 2048, 768, 16),
        ("mixtral", 1, 2, 8, 4096, 14336, None),
        ("mixtral", 4, 2, 8, 4096, 14336, None),
        ("odd", 3, 4, 6, 1001, 333, None),
        ("ragged tile", 5, 3, 7, 1000, 332, None),
        ("ragged tile, 16-byte rows", 5, 3, 7, 1000, 328, None),
    ]


def phase_moe_parity(torch, md):
    """B7 against its plain version over moe_cases(), bf16 and fp32, silu
    and the clamped swiglu. Returns the number of cases."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    worst, n = 0.0, 0
    for label, T, k, E, H, I, pool in moe_cases():
        for dtype in (torch.bfloat16, torch.float32):
            args = moe_inputs(torch, gen, T, k, E, H, I, dtype, pool)
            for gname, glu in MOE_GLUS.items():
                case = f"{label} T={T} k={k} E={E} H={H} I={I} {str(dtype)[6:]} {gname}"
                worst = max(worst, check_moe(torch, md, args, glu, case))
                n += 1
            del args
            torch.cuda.empty_cache()
    log(f"fused_moe_decode: {n} cases agree with the plain version (largest abs err {worst:.3e})")
    return n


def phase_moe_times(torch, md):
    """B7 over one layer at the points of ops/roofline.MOE_POINTS (Qwen3 at
    batch 1 and 8 with each token's experts drawn from all 128, Mixtral at
    batch 1), bf16, held to its plain version first, beside the plain
    version and the dense all-experts route the reference takes by default
    (modules/moe.expert_mlps_dense on the same x and routing). No single
    PyTorch call computes an MoE layer: no library time. The bound counts
    the distinct experts this run's routing chose."""
    from neuronx_distributed_inference_tpu_torch.modules.moe import MoESpec, expert_mlps_dense
    from neuronx_distributed_inference_tpu_torch.ops.roofline import MOE_POINTS, moe_decode

    rows = {}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    for label, pt in MOE_POINTS.items():
        m, T = pt["m"], pt["tokens"]
        args = moe_inputs(torch, gen, T, m["k"], m["E"], m["H"], m["I"], torch.bfloat16)
        x, idx, w, wg, wu, wd = args
        err = check_moe(torch, md, args, {}, f"timed {label}")
        distinct = int(torch.unique(idx).numel())
        aff = torch.zeros((T, m["E"]), device="cuda").scatter(1, idx.long(), w)
        experts = {"gate_proj": {"weight": wg}, "up_proj": {"weight": wu}, "down_proj": {"weight": wd}}
        spec = MoESpec(num_experts=m["E"], top_k=m["k"])
        ms = time_ms(torch, lambda: md.fused_moe_decode(x, idx, w, wg, wu, wd))
        plain_ms = time_ms(torch, lambda: md.fused_moe_decode_plain(x, idx, w, wg, wu, wd), iters=10)
        dense_ms = time_ms(torch, lambda: expert_mlps_dense(experts, x, aff, spec), iters=20)
        b_ms, b_by = bound(*moe_decode(m, T, distinct))
        parts = launch_breakdown(torch, lambda: md.fused_moe_decode(x, idx, w, wg, wu, wd), B7_LAUNCHES)
        rows[("moe_decode", label)] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
            dense_ms=dense_ms, distinct=distinct, launches_us=parts,
        )
        log(
            f"fused_moe_decode {label} (one layer, T={T}, top-{m['k']} of {m['E']}, {distinct} distinct experts, "
            f"H {m['H']}, I {m['I']}, bf16, {md.moe_grid_text(T, m['k'], m['H'], m['I'], x.dtype, x.device)}): kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, dense all-experts route {dense_ms:.4f} ms, bound {b_ms:.5f} ms "
            f"({b_by}), {b_ms / ms:.3f} of the bound, err vs plain {err:.3e}; device us per launch: "
            + ", ".join(f"{name} {us:.2f}" for name, us in parts.items())
        )
        del args, x, idx, w, wg, wu, wd, experts
        torch.cuda.empty_cache()
    return rows


#: Qwen3-30B-A3B layers the teacher-forced gate runs: an fp32 copy of 4 of
#: the 48 layers (with the embedding and lm head) is ~12 GB beside the 57
#: GiB of bf16 params
QWEN3_FORCED_LAYERS = 4
#: steps of the Qwen3 profiles: ~5300 kernels a decode step (22700 an eager
#: ragged step), and torch.profiler spends ~0.6 ms of host time on each
#: kernel it traced when the trace is read
QWEN3_PROFILE_STEPS = 4


def _config_qwen3(batch_size=1, model=None, **kw):
    """Qwen3-30B-A3B (models/mixtral.QWEN3_30B_A3B) at full width and
    depth: bf16, seq_len 1024, CTE bucket [128], TKG bucket [512], fused
    QKV, contiguous cache; ``kw`` overrides MoEConfig fields."""
    from neuronx_distributed_inference_tpu_torch.config import MoEConfig
    from neuronx_distributed_inference_tpu_torch.models.mixtral import QWEN3_30B_A3B, MoEInferenceConfig

    base = dict(
        batch_size=batch_size, seq_len=1024, dtype="bfloat16", context_encoding_buckets=[128],
        token_generation_buckets=[512], fused_qkv=True, seed=0, device="cuda",
    )
    attrs = model or QWEN3_30B_A3B
    return MoEInferenceConfig(MoEConfig(**{**base, **kw}), load_config=lambda c: [setattr(c, k, v) for k, v in attrs.items()])


class _Recorder:
    """Wraps a function of modules/moe for the length of a ``with`` block
    and keeps what ``keep`` takes from each call (on the device)."""

    def __init__(self, name, keep):
        self.name, self.keep, self.calls = name, keep, []

    def __enter__(self):
        from neuronx_distributed_inference_tpu_torch.modules import moe

        self.real = getattr(moe, self.name)

        def wrapped(*args, **kw):
            out = self.real(*args, **kw)
            self.calls.append(self.keep(args, out))
            return out

        setattr(moe, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        from neuronx_distributed_inference_tpu_torch.modules import moe

        setattr(moe, self.name, self.real)


def _selections(torch, cfg, params, seq, prompt_len, plain=False, logits_fn=None):
    """Teacher-forced logits over ``seq`` (``logits_fn``, default
    _forced_logits) and the router's top-k selection of each call:
    (logits, [(T, E) bool per call, prefill first, in layer order])."""
    logits_fn = logits_fn or _forced_logits
    fn = (lambda *a: plain_run("qwen3 teacher-forced plain", logits_fn, *a)) if plain else \
        (lambda *a: logits_fn(*a))
    with _Recorder("router_top_k", lambda args, out: out[1].clone()) as rec:
        logits = fn(torch, cfg, params, seq, prompt_len)
    return logits, rec.calls


def _flipped_positions(a, b, n_layers):
    """Per logits row (the prefill's last token, then each decode step),
    whether any layer's top-k selection differs between call lists a, b;
    and the number of (position, layer) pairs that differ."""
    rows, pairs = [], 0
    for i in range(0, len(a), n_layers):
        diff = [bool((x[-1] != y[-1]).any()) for x, y in zip(a[i : i + n_layers], b[i : i + n_layers])]
        rows.append(any(diff))
        pairs += sum(diff)
    return np.array(rows), pairs


class _PinnedRouting:
    """Replays recorded top-k selections in modules/moe.router_top_k for
    the length of a ``with`` block: each call takes the next recorded (T, E)
    selection and weighs it by this run's own softmax scores, renormalized
    over the selection (the Qwen3-MoE router: softmax, norm_topk_prob)."""

    def __init__(self, selections):
        self.selections, self.i = selections, 0

    def route(self, router_logits, spec, correction_bias=None):
        import torch

        if spec.scoring_func != "softmax" or not spec.normalize_top_k_affinities or correction_bias is not None:
            raise SystemExit("pinned routing replays the softmax router with renormalized weights only")
        sel = self.selections[self.i].to(router_logits.device)
        self.i += 1
        w = torch.where(sel, torch.softmax(router_logits, dim=-1), torch.zeros_like(router_logits))
        return w / (w.sum(dim=-1, keepdim=True) + 1e-20) * spec.routed_scaling_factor, sel

    def __enter__(self):
        from neuronx_distributed_inference_tpu_torch.modules import moe

        self.real = moe.router_top_k
        moe.router_top_k = self.route
        return self

    def __exit__(self, *exc):
        from neuronx_distributed_inference_tpu_torch.modules import moe

        moe.router_top_k = self.real


def qwen3_teacher_forced(torch, params, seq, prompt_len, L, logits_fn=None, cfg_fn=None, what=None):
    """The teacher-forced gate on the first QWEN3_FORCED_LAYERS layers: the
    kernel path (B2, B1, B7, the grouped prefill) against the plain path
    (attention kernels off, moe_fused_kernel_enabled False: the dense
    all-experts decode) on the same bf16 weights, and an fp32 run of the
    plain path. A near-flat random router lets a top-k set flip between two
    paths on a near-tie; a flip moves that position's logits, and through
    the cache later ones, far more than bf16 rounding does. The kernel and
    plain paths first run routing on their own: the flips of each pair of
    runs are counted and printed, and a failure of that gate passes only
    where such flips exist. Then the kernel and plain paths run
    with every call routed as the fp32 run routed (each run weighing those
    experts by its own scores): that gate sees the paths' arithmetic alone,
    and its failure fails the phase. ``logits_fn`` and ``cfg_fn`` run
    another path the same way (default: _forced_logits over _config_qwen3,
    the generate() path). Each run's seconds are printed."""
    from neuronx_distributed_inference_tpu_torch.models.mixtral import QWEN3_30B_A3B

    logits_fn, cfg_fn = logits_fn or _forced_logits, cfg_fn or _config_qwen3
    n = QWEN3_FORCED_LAYERS
    model = {**QWEN3_30B_A3B, "num_hidden_layers": n}
    sub = dict(params, layers=params["layers"][:n])
    # eager programs: the router's selections are recorded and pinned per
    # call in Python, which a graph's replay never enters
    off = dict(
        attn_kernel_enabled=False, attn_block_tkg_kernel_enabled=False, moe_fused_kernel_enabled=False,
        cuda_graphs=False,
    )
    cfg_k = cfg_fn(model=model, output_logits=True, cuda_graphs=False)
    cfg_p = cfg_fn(model=model, output_logits=True, **off)
    label = f"{what or 'qwen3 teacher-forced logits'} (first {n} of {L} layers)"
    secs = {}

    def timed_run(name, fn):
        t0 = time.perf_counter()
        out = fn()
        secs[name] = time.perf_counter() - t0
        return out

    sub32 = _map_tree(sub, lambda t: t.float())
    f32, sel_f = timed_run("fp32", lambda: _selections(
        torch, cfg_fn(model=model, output_logits=True, dtype="float32", **off), sub32, seq, prompt_len, True,
        logits_fn=logits_fn,
    ))
    del sub32
    torch.cuda.empty_cache()
    k, sel_k = timed_run("kernel", lambda: _selections(torch, cfg_k, sub, seq, prompt_len, logits_fn=logits_fn))
    pl, sel_p = timed_run("plain", lambda: _selections(torch, cfg_p, sub, seq, prompt_len, True, logits_fn=logits_fn))
    kp_rows, kp = _flipped_positions(sel_k, sel_p, n)
    kf_rows, kf = _flipped_positions(sel_k, sel_f, n)
    pf_rows, pf = _flipped_positions(sel_p, sel_f, n)
    log(
        f"{label}: top-k sets differ at {kp} (position, layer) pairs of {len(kp_rows) * n} between the kernel "
        f"and the plain bf16 paths ({int(kp_rows.sum())} positions); kernel vs fp32 {kf} ({int(kf_rows.sum())}), "
        f"plain vs fp32 {pf} ({int(pf_rows.sum())})"
    )
    forced = _forced_gate(k, pl, f32, label, exit_on_fail=False)
    forced.update(flips_kernel_plain=kp, flips_kernel_fp32=kf, flips_plain_fp32=pf)
    if not forced["passed"] and kf + pf == 0:
        raise SystemExit(f"{label}: the gate failed with no top-k flip to explain it")
    if not forced["passed"]:
        log("  the gate failed with each run routing on its own, and the runs' top-k sets differ (above)")
    # every run routed as the fp32 run routed: no discontinuity left, so the
    # gate compares the paths' arithmetic alone, and must pass
    with _PinnedRouting(sel_f):
        k_pin = timed_run("kernel, pinned", lambda: logits_fn(torch, cfg_k, sub, seq, prompt_len))
    with _PinnedRouting(sel_f):
        pl_pin = timed_run("plain, pinned", lambda: plain_run(
            "qwen3 teacher-forced plain, pinned routing", logits_fn, torch, cfg_p, sub, seq, prompt_len
        ))
    forced["pinned"] = _forced_gate(k_pin, pl_pin, f32, f"{label}, routing pinned to the fp32 run's")
    log(f"  {label}: seconds per run " + ", ".join(f"{k_} {v:.1f}" for k_, v in secs.items()))
    return forced


def phase_qwen3_moe(torch):
    """Qwen3-30B-A3B at full width and depth with seeded random bf16
    weights made on the card: load (time, peak, params bytes), greedy
    generate() of 256 tokens after a 128-token prompt at batch 1 with exact
    counts (B2 once per layer; B1 and B7 once per layer and decode step;
    the 128-token prefill through the grouped route; no dense MoE call), a
    batch-8 generate() (64 rows for B7) with its distinct experts per layer,
    a profile of QWEN3_PROFILE_STEPS decode steps, and the teacher-forced
    gate."""
    from neuronx_distributed_inference_tpu_torch.analysis.retrace_guard import RetraceGuard
    from neuronx_distributed_inference_tpu_torch.ops import _cuda
    from neuronx_distributed_inference_tpu_torch.ops.roofline import MODEL_QWEN3_MOE, bound_ms, moe_decode
    from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM

    prompt_len, n_new = 128, 256
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    app = ModelForCausalLM(None, _config_qwen3(retrace_guard=True)).load(random_weights=True)
    torch.cuda.synchronize()
    load_s, load_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    params_bytes = _tree_bytes(app.params)
    t0 = time.perf_counter()
    app.warmup()
    torch.cuda.synchronize()
    log(
        f"qwen3-30b-a3b: load (random bf16 weights on the card) {load_s:.2f} s, peak {load_peak / 2**30:.3f} GiB, "
        f"params {params_bytes / 2**30:.3f} GiB; warmup {time.perf_counter() - t0:.2f} s"
    )
    L = app.spec.num_layers
    with RetraceGuard():  # warmed and sealed: nothing is captured
        out, run = _generate_run(torch, app, prompt_len, n_new, "qwen3-30b-a3b generate()")
    # 255 remaining tokens run as one 256-step chunk in bucket 512
    want = expect_launches(
        flash_attention=L, decode_attention=L * 256, moe_decode=L * 256, moe_grouped=L,
    )
    if run["launches"] != want:
        raise SystemExit(f"qwen3 launch counts {run['launches']} != expected {want}")

    # batch 8: 8 seeded prompts, 64 new tokens; B7 takes 8 x 8 = 64 rows
    app8 = ModelForCausalLM(None, _config_qwen3(8)).load(params=app.params)
    ids8 = np.random.RandomState(3).randint(0, app.spec.vocab_size, size=(8, prompt_len))
    app8.generate(ids8, max_new_tokens=1)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    app8.generate(ids8, max_new_tokens=1)
    ttft8 = time.perf_counter() - t0
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    out8 = app8.generate(ids8, max_new_tokens=64)
    total8 = time.perf_counter() - t0
    counts8 = all_counts()
    tok_s8 = 8 * 63 / (total8 - ttft8)
    want8 = expect_launches(flash_attention=L, decode_attention=L * 64, moe_decode=L * 64, moe_grouped=L)
    gen8 = out8.sequences[:, prompt_len:]
    log(
        f"qwen3-30b-a3b generate() batch 8 (prompt {prompt_len}, 64 new tokens): TTFT {ttft8 * 1e3:.2f} ms, "
        f"generate {total8 * 1e3:.1f} ms, decode {tok_s8:.1f} tok/s; launches {counts8}"
    )
    if counts8 != want8:
        raise SystemExit(f"qwen3 batch-8 counts {counts8} != expected {want8}")
    if gen8.shape != (8, 64) or gen8.min() < 0 or gen8.max() >= app.spec.vocab_size:
        raise SystemExit(f"qwen3 batch 8: bad tokens, shape {gen8.shape}")
    # the expert census records each B7 call in Python: an eager twin (a
    # replay enters no Python)
    app8e = ModelForCausalLM(None, _config_qwen3(8, cuda_graphs=False)).load(params=app.params)
    with _Recorder("fused_moe_decode", lambda args, out: args[1].clone()) as rec:
        app8e.generate(ids8, max_new_tokens=8)
    del app8e
    distinct = np.array([int(torch.unique(ids).numel()) for ids in rec.calls if ids.shape[0] == 8])
    b8 = [bound_ms(*moe_decode(MODEL_QWEN3_MOE, 8, int(d)))[0] for d in distinct]
    log(
        f"  batch-8 decode: distinct experts per layer and step over {len(distinct)} B7 calls: mean "
        f"{distinct.mean():.2f}, min {distinct.min()}, max {distinct.max()} of 64 selections (bound per layer "
        f"{np.mean(b8):.5f} ms on average)"
    )
    del app8
    torch.cuda.empty_cache()

    profile = phase_profile(torch, app, out.sequences[0], prompt_len, steps=QWEN3_PROFILE_STEPS)
    b7 = profile["busy_ms_per_step"](lambda name: "moe_" in name)
    busy = profile["device_busy_ms"]
    b7_bound = L * bound_ms(*moe_decode(MODEL_QWEN3_MOE, 1, 8))[0]
    log(
        f"  B7 (the union of its gate/up, down and combine kernels' intervals) {b7:.4f} ms/step against its "
        f"{b7_bound:.4f} ms step bound "
        f"({b7_bound / b7:.3f} of it), {b7 / busy:.3f} of the device's busy time ({busy:.3f} ms/step); "
        f"{profile['kernels_per_step']:.0f} kernels per step; host clock {profile['decode_step_ms']:.3f} ms/step"
    )
    eager = eager_twin(
        torch, "qwen3-30b-a3b generate()", _config_qwen3(cuda_graphs=False), app, out, run, prompt_len, n_new,
        profile_steps=QWEN3_PROFILE_STEPS,
    )
    forced = qwen3_teacher_forced(torch, app.params, out.sequences[0], prompt_len, L)
    del app
    torch.cuda.empty_cache()
    return dict(
        run, **profile, load_s=load_s, load_peak=load_peak, params_bytes=params_bytes, ttft8_ms=ttft8 * 1e3,
        decode_tok_s8=tok_s8, distinct_mean=float(distinct.mean()), b7_ms_per_step=b7, b7_busy_share=b7 / busy,
        b7_step_bound_ms=b7_bound, eager=eager, **forced,
    )



# ---------------------------------------------------------------------------
# 9b. Qwen3-30B-A3B through the serving sessions
# ---------------------------------------------------------------------------


def _config_qwen3_serving(model=None, **kw):
    """Qwen3-30B-A3B (full width and depth unless ``model`` gives others) on
    the serving row's paged configuration: 8 slots, 512 blocks of 32
    (1,610,612,736 bytes of bf16 K/V over 48 layers), chunked prefill of up
    to 8 rows in 128-token tiles, CTE bucket [128], TKG bucket [1024], seq
    1024; ``kw`` overrides MoEConfig fields."""
    from neuronx_distributed_inference_tpu_torch.config import ChunkedPrefillConfig

    s = SERVING
    return _config_qwen3(
        s["slots"], model=model, is_continuous_batching=True, ctx_batch_size=1, is_block_kv_layout=True,
        pa_num_blocks=s["blocks"], pa_block_size=s["block_size"], context_encoding_buckets=[128],
        token_generation_buckets=[s["seq"]], is_chunked_prefill=True,
        chunked_prefill_config=ChunkedPrefillConfig(max_num_seqs=s["slots"], kernel_q_tile_size=128), **kw,
    )


#: the Qwen3 serving drains: (path, form) -> MoEConfig fields
QWEN3_SERVING_FORMS = {
    ("split", "sync"): dict(async_mode=False),
    ("split", "1-ahead"): dict(async_mode=True),
    ("ragged", "sync"): dict(serving_ragged=True, serving_ragged_async=False),
    ("ragged", "1-ahead"): dict(serving_ragged=True, serving_ragged_async=True),
}


def _qwen3_drain(torch, app, prompts, gen, host_read, label):
    """One drain of _serve's traffic on a Qwen3 serving app, the launch and
    route counts read around it and held to the sessions' dispatch counters
    (split: B5 and the grouped route once a layer and chunk pass, B4 and B7
    once a layer and decode step; ragged: B3 once a layer and mixed step,
    the grouped route on steps of ``host_read`` packed tokens or more, the
    dense route on the rest, from the bucket census). Every request must
    get its tokens, with no fault. Returns the drain's record."""
    from neuronx_distributed_inference_tpu_torch.ops import _cuda
    from neuronx_distributed_inference_tpu_torch.telemetry import TelemetrySession

    L, vocab = app.spec.num_layers, app.spec.vocab_size
    tel = TelemetrySession()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    sess, total_s = _serve(torch, app, prompts, gen, tel)
    launches = all_counts()
    peak = torch.cuda.max_memory_allocated()
    counts = sorted(len(r.generated) for r in sess.requests.values())
    faults = dict(
        rejected=sum(tel.rejected.values()), quarantined=tel.counters["quarantined"],
        preempted=tel.counters["preempted"],
    )
    d = dict(sess.dispatches)
    if sess.ragged:
        from neuronx_distributed_inference_tpu_torch.ops.kernel_mode import MOE_TKG_MAX_ROWS

        mr = app.mixed_step_model
        buckets = {b: n for (tag, b), n in tel.buckets.items() if tag == mr.tag}
        eager = sum(n for b, n in buckets.items() if b >= host_read)
        # a smaller step routes its packed tokens as decode rows: B7 where
        # they fit its 64 rows (never at Qwen3's top-8), else dense
        k = app.builder.moe_spec().top_k
        b7 = sum(n for b, n in buckets.items() if b < host_read and b * k <= MOE_TKG_MAX_ROWS)
        steps = d["mixed_step"]
        want = expect_launches(
            ragged_paged_attention=steps * L, moe_grouped=eager * L, moe_decode=b7 * L,
            moe_dense=(steps - eager - b7) * L,
        )
    else:
        buckets = {b: n for (tag, b), n in tel.buckets.items()}
        eager = d.get("prefill_chunk", 0)
        steps = eager + d.get("decode_steps", 0)
        want = expect_launches(
            paged_flash_attention=eager * L, moe_grouped=eager * L,
            paged_decode_attention=d["decode_steps"] * L, moe_decode=d["decode_steps"] * L,
        )
    ttft = [t * 1e3 for t in tel.ttft_values_s()]
    itl = [t * 1e3 for t in tel.itl_values_s()]
    pct = tel.percentile
    tok_s = sum(counts) / total_s
    log(
        f"qwen3-30b-a3b serving {label} (bf16, 8 slots, 512 blocks x 32, chunked prefill 8 x 128, "
        f"{len(prompts)} requests of {len(prompts[0])} + {gen} tokens, staggered): {total_s * 1e3:.1f} ms, "
        f"aggregate {tok_s:.1f} tok/s, TTFT p50 {pct(ttft, 0.5):.2f} ms p99 {pct(ttft, 0.99):.2f} ms, ITL p50 "
        f"{pct(itl, 0.5):.3f} ms p99 {pct(itl, 0.99):.3f} ms, peak memory {peak / 2**30:.3f} GiB, {faults}"
    )
    log(
        f"  dispatches {d}, {eager} of {steps} dispatches eager (the grouped route's host read), "
        f"{(total_s * 1e3 / steps):.2f} ms a dispatch on the host clock; buckets {buckets}; launches {launches}"
    )
    if counts != [gen] * len(prompts) or any(faults.values()):
        raise SystemExit(f"qwen3 serving {label}: tokens per request {counts}, faults {faults}")
    if any(r.status != "finished" for r in sess.requests.values()):
        raise SystemExit(f"qwen3 serving {label}: a request did not finish")
    for rid, r in sess.requests.items():
        if min(r.generated) < 0 or max(r.generated) >= vocab:
            raise SystemExit(f"qwen3 serving {label}: request {rid} has tokens outside the vocab")
    if launches != want:
        raise SystemExit(f"qwen3 serving {label}: launches {launches} != expected {want}")
    return dict(
        tokens={rid: list(r.generated) for rid, r in sess.requests.items()}, launches=launches, tok_s=tok_s,
        total_ms=total_s * 1e3, peak_bytes=peak, eager_steps=eager, steps=steps, dispatches=d, buckets=buckets,
        ttft_p50_ms=pct(ttft, 0.5), itl_p50_ms=pct(itl, 0.5),
    )


def _qwen3_step_profile(torch, app, prompts, label, steps):
    """Host ms and the device's busy share of ``steps`` steady-state
    step() calls, 8 requests decoding (1-ahead: a step in flight); the
    session is dropped after them."""
    from neuronx_distributed_inference_tpu_torch.runtime.serving import ServingSession

    app.init_kv_cache()
    sess = ServingSession(app)
    for i, p in enumerate(prompts):
        if not sess.add_request(f"p{i}", p, max_new_tokens=steps + 8):
            raise SystemExit(f"qwen3 profile: request {i} refused")
    for _ in range(64):
        if not (sess.prefilling or (sess.ragged_async and sess._pending is None)):
            break
        sess.step()
    else:
        raise SystemExit(f"qwen3 profile ({label}): the session did not reach steady decode")
    torch.cuda.synchronize()
    prof = _start_profile(torch)
    t0 = time.perf_counter()
    for _ in range(steps):
        sess.step()
    torch.cuda.synchronize()
    rec = _stop_profile(torch, prof, time.perf_counter() - t0, steps)
    log(
        f"  qwen3 serving {label}, {steps} steady steps (8 rows decoding) profiled: host {rec['host_ms']:.3f} "
        f"ms/step, device busy {rec['device_busy_ms']:.3f} ms/step ({rec['busy_frac']:.3f} of the wall), "
        f"{rec['kernels']:.0f} kernels/step, cudaGraphLaunch {rec['graph_launch_ms']:.3f} and synchronizing "
        f"calls {rec['sync_ms']:.3f} host ms/step"
    )
    return rec


def phase_qwen3_serving(torch):
    """Qwen3-30B-A3B served at full width and depth (48 layers, 128 experts,
    top-8; seeded random bf16 weights made on the card, one parameter set
    shared by every app) on the serving row's paged configuration
    (_config_qwen3_serving) and traffic (8 staggered requests of 128 + 128
    tokens): the split drain (B5 chunks through the grouped route, run
    eagerly; the 8-row decode step through B4 and B7, captured) and the
    ragged drain (B3; mixed steps of 64 packed tokens or more through the
    grouped route, run eagerly; smaller ones through the dense route,
    captured), each sync and 1-ahead with graphs on, every runner warmed
    and sealed first. Gates: every request gets its 128 tokens with 0
    rejected / quarantined / preempted; nothing captured after the seal; no
    ragged step of the grouped route's size captured and the split decode
    step captured; exact B4 / B5 / B3 / B7 launches and moe_grouped /
    moe_dense routes (_qwen3_drain); the paged teacher-forced gate on
    QWEN3_FORCED_LAYERS layers with routing pinned to the fp32 run's, over
    request 0's served tokens.
    Prints the captured graphs, the eager dispatches, host ms and
    device-busy share a step (profiled), peak memory, and how many tokens
    the split and ragged drains share (not a gate: bf16 top-k flips)."""
    import gc

    from neuronx_distributed_inference_tpu_torch.analysis.retrace_guard import RetraceGuard
    from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM

    s = SERVING
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    apps, params = {}, None
    for key, kw in QWEN3_SERVING_FORMS.items():
        app = ModelForCausalLM(None, _config_qwen3_serving(**kw))
        apps[key] = app.load(params=params) if params is not None else app.load(random_weights=True)
        params = apps[key].params
    torch.cuda.synchronize()
    load_s, load_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    for app in apps.values():
        app.warmup()
    _seal(apps.values())
    torch.cuda.synchronize()
    first = next(iter(apps.values()))
    L, vocab = first.spec.num_layers, first.spec.vocab_size
    host_read = first.builder.host_read_tokens()
    log(
        f"qwen3-30b-a3b serving: 4 apps over one parameter set ({_tree_bytes(params) / 2**30:.3f} GiB), load "
        f"{load_s:.2f} s, peak {load_peak / 2**30:.3f} GiB, KV cache {first.kv_cache_nbytes} bytes an app; warmup "
        f"and seal {time.perf_counter() - t0:.2f} s; mixed buckets "
        f"{apps[('ragged', 'sync')].mixed_step_model.buckets}, eager from {host_read} packed tokens"
    )
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, vocab - 10, size=(s["prompt"],)).tolist() for _ in range(s["n_requests"])]
    captures = {key: app.graphs.captures for key, app in apps.items()}
    runs = {}
    with RetraceGuard():
        for key, app in apps.items():
            runs[key] = _qwen3_drain(torch, app, prompts, s["gen"], host_read, "/".join(key))
    if {key: app.graphs.captures for key, app in apps.items()} != captures:
        raise SystemExit("qwen3 serving: a graph was captured after the seal")
    for key, app in apps.items():
        if key[0] == "ragged":
            big = sorted(k for k in app.mixed_step_model._prog.captured if k[1] >= host_read)
            if big:
                raise SystemExit(f"qwen3 serving {key}: grouped-route mixed steps captured: {big}")
        elif not any(k[0] == "decode" for k in app.token_generation_model._prog.captured):
            raise SystemExit(f"qwen3 serving {key}: the decode step was not captured")
    log(
        "qwen3 serving graphs captured per app: "
        + ", ".join(f"{'/'.join(k)} {n}" for k, n in captures.items())
    )
    for form in ("sync", "1-ahead"):
        a, b = runs[("split", form)]["tokens"], runs[("ragged", form)]["tokens"]
        same = sum(sum(x == y for x, y in zip(a[rid], b[rid])) for rid in a)
        log(f"  {form}: ragged tokens equal to the split drain's at {same} of {sum(len(v) for v in a.values())} "
            "positions (not a gate: bf16 top-k flips)")
    # the synchronous forms (the drains above give every form's host ms a
    # dispatch); an eager ragged step launches ~4x a decode step's kernels
    profiles = {
        key: _qwen3_step_profile(torch, app, prompts, "/".join(key), QWEN3_PROFILE_STEPS // (1 + (key[0] == "ragged")))
        for key, app in apps.items() if key[1] == "sync"
    }
    del apps, app, first
    gc.collect()
    torch.cuda.empty_cache()
    seq = prompts[0] + runs[("split", "sync")]["tokens"]["0"]
    forced = qwen3_teacher_forced(
        torch, params, np.array(seq), s["prompt"], L, logits_fn=_paged_forced_logits, cfg_fn=_config_qwen3_serving,
        what="qwen3 paged teacher-forced logits (one 128-token chunk through B5 and the grouped route, then B4 "
        "and B7 steps)",
    )
    del params
    gc.collect()
    torch.cuda.empty_cache()
    split = runs[("split", "sync")]["launches"]
    return dict(
        runs=runs, profiles=profiles, forced=forced,
        launches={
            "paged_decode_attention_qwen3": split["paged_decode_attention"],
            "paged_flash_attention_qwen3": split["paged_flash_attention"],
            "ragged_paged_attention_qwen3": runs[("ragged", "sync")]["launches"]["ragged_paged_attention"],
            "moe_decode_qwen3_serving": split["moe_decode"],
        },
    )


# ---------------------------------------------------------------------------
# B8 / B9: the fused decode layer, and Llama-3.2-1B generate() through it
# ---------------------------------------------------------------------------

#: fp32 summation-order allowance of B8's and B9's checks, relative to the
#: case's largest magnitude of the sums behind an output (as MOE_FP32_RTOL)
FUSED_FP32_RTOL = 1e-5
FUSED_EPS = 1e-5
#: the device of the fused phases' inputs (a CPU rehearsal sets "cpu")
DEV = "cuda"
#: Llama-3.2-1B's rope_theta
ROPE_THETA = 500000.0
#: (label, H, Hq, Hkv, D) of B8's parity cases: D 64 and 128 at GQA 4:1 and
#: 8:1, Llama-3.2-1B's layer first and Qwen3-30B-A3B's attention widths last
FUSED_ATTN_SHAPES = [
    ("1b", 2048, 32, 8, 64),
    ("gqa8 d64", 1024, 16, 2, 64),
    ("d128", 1024, 16, 4, 128),
    ("qwen3 widths", 2048, 32, 4, 128),
]
#: (label, H, I) of B9's parity cases: Llama-3.2-1B's MLP, widths no 64-wide
#: tile divides, and an odd I (element loads)
FUSED_MLP_SHAPES = [("1b", 2048, 8192), ("ragged tile", 1000, 1500), ("odd", 512, 333)]
#: (B, K) of B9's parity cases: 1, 2, 3 rows (the FMA body's row tiles), 5
#: to 64 (the tensor-core body's 16 to 64 rows, every weight read once) and
#: 80 (two passes of 64 rows)
FUSED_MLP_ROWS = [(1, 1), (2, 1), (3, 1), (5, 1), (2, 4), (4, 4), (3, 8), (5, 8), (4, 16), (5, 16)]


def check_fused(torch, out, ref, mag, case, what):
    """One output of B8 or B9 against its plain version on the same inputs.
    Both round at the same places, so for bf16 the bound is MOE_BF16_STEP x
    (mag + |plain|): a value a few fp32 ulps away may round one bf16 step
    away, and so may each term that enters the last sum rounded; mag is the
    sum of the absolute terms behind each element. Both dtypes add
    FUSED_FP32_RTOL x the case's largest mag for the fp32 summation order.
    Returns the max abs error; exits past the bound."""
    step = MOE_BF16_STEP if out.dtype == torch.bfloat16 else 0.0
    o, r = out.float(), ref.float()
    if not torch.isfinite(o).all():
        raise SystemExit(f"{what} returned non-finite values: {case}")
    atol = FUSED_FP32_RTOL * mag.max().item()
    diff = (o - r).abs()
    err = diff.max().item()
    use = (diff / (atol + step * (mag + r.abs()))).max().item()
    ok = use <= 1.0
    log(
        f"  {what} {case}: max abs err {err:.3e}, largest share of the bound (atol {atol:.1e} + {step:.2e} x "
        f"(mag + |plain|)) {use:.3f}, |plain| up to {r.abs().max().item():.3f} {'ok' if ok else 'FAIL'}"
    )
    if not ok:
        raise SystemExit(f"{what} disagrees with its plain version: {case}")
    return err


def _rope_tables(torch, pos, D):
    from neuronx_distributed_inference_tpu_torch.modules.rope import default_inv_freq, rope_cos_sin

    return rope_cos_sin(pos, default_inv_freq(D, ROPE_THETA).to(pos.device))


def fused_attn_inputs(torch, gen, B, K, H, Hq, Hkv, D, bucket, dtype, garbage_row=False, L=2, S_max=1024):
    """One B8 call's arguments on the card: x of std 1, gamma around 1,
    weights of std 1 / sqrt(fan-in) (q, k, v and the output near 1), both
    caches of std 1 in every line (the garbage line too). Row 0 sits near
    the bucket's end with positions 64 to 191 masked out (two whole tiles
    to skip), the others shallower (partial last tiles); the mask is each
    token's causal decode mask, this step's slots included. With
    ``garbage_row`` the last row writes to the garbage line with an
    all-false mask: it attends its own tokens only."""
    def rn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=DEV) * std

    x = rn(B, K, H).to(dtype)
    gamma = (1 + 0.1 * rn(H)).to(dtype)
    wqkv = rn(H, (Hq + 2 * Hkv) * D, std=H ** -0.5).to(dtype)
    wout = rn(Hq * D, H, std=(Hq * D) ** -0.5).to(dtype)
    kc, vc = rn(L, B + 1, S_max, Hkv, D).to(dtype), rn(L, B + 1, S_max, Hkv, D).to(dtype)
    p0 = [bucket - K - 5, 77, 200, 3][:B]
    pos = torch.tensor([[p + t for t in range(K)] for p in p0], dtype=torch.int32, device=DEV)
    cols = torch.arange(bucket, device=DEV)
    mask = (cols[None, None, :] <= pos[:, :, None])[:, None].contiguous()
    mask[0, :, :, 64:192] = False
    slots = torch.arange(B, dtype=torch.int32, device=DEV)
    if garbage_row:
        slots[-1] = B
        mask[-1] = False
    cos, sin = _rope_tables(torch, pos, D)
    return (x, gamma, wqkv, wout, cos, sin, kc, vc, 1, slots, mask, pos)


def check_fused_attn(torch, db, args, case):
    """One B8 launch (exactly one count) against its plain version: the
    hidden output (mag: |x| + |attention rows| @ |Wout|), k_new (mag: the
    QKV terms of each k column and of its RoPE partner) and v_new (its QKV
    terms). Returns the max abs error."""
    from neuronx_distributed_inference_tpu_torch.ops import _cuda

    x, gamma, wqkv, wout, cos, sin, kc, vc, li, slots, mask, pos = args
    B, K, H = x.shape
    D = kc.shape[-1]
    Hkv = kc.shape[3]
    Hq = wqkv.shape[1] // D - 2 * Hkv
    kw = dict(scale=D ** -0.5, eps=FUSED_EPS, n_kv=Hkv)
    before = _cuda.launch_counts()["fused_attn_block"]
    out, k_new, v_new = db.fused_attn_block(*args, **kw)
    torch.cuda.synchronize()
    if _cuda.launch_counts()["fused_attn_block"] != before + 1:
        raise SystemExit(f"fused_attn_block case did not launch B8 once: {case}")
    ref, rk, rv = plain_run(f"fused_attn_block {case}", lambda: db.fused_attn_block_plain(*args, **kw))
    normed, _, _, attn = db.attn_rows_plain(x, gamma, wqkv, cos, sin, kc, vc, li, slots, mask, pos, **kw)
    mag = normed.abs() @ wqkv.float().abs()
    mk = mag[..., Hq * D : (Hq + Hkv) * D].reshape(B, K, Hkv, D)
    mk = mk + torch.cat([mk[..., D // 2 :], mk[..., : D // 2]], dim=-1)
    mv = mag[..., (Hq + Hkv) * D :].reshape(B, K, Hkv, D)
    mo = x.float().abs() + attn.abs().to(wout.dtype).float() @ wout.float().abs()
    return max(
        check_fused(torch, out, ref, mo, case, "fused_attn_block out"),
        check_fused(torch, k_new, rk, mk, case, "fused_attn_block k_new"),
        check_fused(torch, v_new, rv, mv, case, "fused_attn_block v_new"),
    )


def fused_mlp_inputs(torch, gen, B, K, H, I, dtype):
    """x of std 1, gamma around 1, gate / up of std 1 / sqrt(H), down of std
    1 / sqrt(I)."""
    def rn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=DEV) * std

    return (rn(B, K, H).to(dtype), (1 + 0.1 * rn(H)).to(dtype), rn(H, I, std=H ** -0.5).to(dtype),
            rn(H, I, std=H ** -0.5).to(dtype), rn(I, H, std=I ** -0.5).to(dtype))


def mlp_plan_text(torch, db, x, I):
    """B9's two grids at x's rows, as the wrapper plans them."""
    from neuronx_distributed_inference_tpu_torch.ops import _cuda

    B, K, H = x.shape
    (s_gu, k_gu), (s_d, k_d), _, _ = db.mlp_plan(H, I, B * K, x.element_size(), _cuda.sm_count(x.device))
    cols = db.GEMV_COLS
    return (f"gate/up {-(-I // cols)} tiles x {s_gu} splits of {k_gu}, down {-(-H // cols)} tiles x {s_d} "
            f"splits of {k_d}")


def check_fused_mlp(torch, db, args, act, case):
    """One B9 launch (exactly one count) against its plain version (mag:
    |x| + |act(g) u| @ |Wd|). Returns the max abs error."""
    from neuronx_distributed_inference_tpu_torch.ops import _cuda

    x, gamma, wg, wu, wd = args
    if DEV != "cpu":
        case = f"{case} ({mlp_plan_text(torch, db, x, wg.shape[1])})"
    before = _cuda.launch_counts()["fused_mlp_block"]
    out = db.fused_mlp_block(*args, eps=FUSED_EPS, act=act)
    torch.cuda.synchronize()
    if _cuda.launch_counts()["fused_mlp_block"] != before + 1:
        raise SystemExit(f"fused_mlp_block case did not launch B9 once: {case}")
    ref = plain_run(f"fused_mlp_block {case}", lambda: db.fused_mlp_block_plain(*args, eps=FUSED_EPS, act=act))
    a = db.glu_rows_plain(x, gamma, wg, wu, eps=FUSED_EPS, act=act).to(wd.dtype).float()
    mag = x.float().abs() + a.abs() @ wd.float().abs()
    return check_fused(torch, out, ref, mag, case, "fused_mlp_block")


#: B8's cases of n_rep * K = 64 query rows a block, at D 128: (label of
#: FUSED_ATTN_SHAPES, K)
FUSED_FULL_ROWS = [("d128", 16), ("qwen3 widths", 8)]


def phase_fused_parity(torch, db):
    """B8 over FUSED_ATTN_SHAPES at batch 1 and 4, K 1 and 4, buckets 512
    and 1024, bf16 and fp32, plus rows on the garbage line with an all-false
    mask and the 64-row blocks of FUSED_FULL_ROWS (K 16 and 8 at D 128);
    each B8 case launched twice more on the same scratch and counters and
    required bit-identical (its completion counters reset themselves); B9
    over FUSED_MLP_SHAPES at the (B, K) of FUSED_MLP_ROWS (1 to 80 rows),
    silu and the tanh gelu, bf16 and fp32, each case launched twice more
    and required bit-identical. Returns (B8 cases, B9 cases)."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(13)
    n_attn = n_mlp = 0
    worst_attn = worst_mlp = 0.0
    shapes = {label: (H, Hq, Hkv, D) for label, H, Hq, Hkv, D in FUSED_ATTN_SHAPES}

    def attn_case(args, case):
        kw = dict(scale=args[6].shape[-1] ** -0.5, eps=FUSED_EPS, n_kv=args[6].shape[3])
        err = check_fused_attn(torch, db, args, case)
        check_repeat(torch, "fused_attn_block", lambda: db.fused_attn_block(*args, **kw), case)
        return err

    for label, H, Hq, Hkv, D in FUSED_ATTN_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            for B in (1, 4):
                for K in (1, 4):
                    for bucket in (512, 1024):
                        args = fused_attn_inputs(torch, gen, B, K, H, Hq, Hkv, D, bucket, dtype)
                        case = f"{label} H={H} Hq={Hq} Hkv={Hkv} D={D} {str(dtype)[6:]} B={B} K={K} bucket={bucket}"
                        worst_attn = max(worst_attn, attn_case(args, case))
                        n_attn += 1
    label, H, Hq, Hkv, D = FUSED_ATTN_SHAPES[0]
    for dtype in (torch.bfloat16, torch.float32):
        for K in (1, 4):
            args = fused_attn_inputs(torch, gen, 4, K, H, Hq, Hkv, D, 512, dtype, garbage_row=True)
            case = f"{label} garbage row {str(dtype)[6:]} B=4 K={K} bucket=512"
            worst_attn = max(worst_attn, attn_case(args, case))
            n_attn += 1
    for label, K in FUSED_FULL_ROWS:
        H, Hq, Hkv, D = shapes[label]
        for dtype in (torch.bfloat16, torch.float32):
            for B in (1, 4):
                args = fused_attn_inputs(torch, gen, B, K, H, Hq, Hkv, D, 512, dtype)
                case = f"{label} H={H} Hq={Hq} Hkv={Hkv} D={D} {str(dtype)[6:]} B={B} K={K} ({Hq // Hkv * K} rows) bucket=512"
                worst_attn = max(worst_attn, attn_case(args, case))
                n_attn += 1
    torch.cuda.empty_cache()
    for label, H, I in FUSED_MLP_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            for B, K in FUSED_MLP_ROWS:
                args = fused_mlp_inputs(torch, gen, B, K, H, I, dtype)
                for act in ("silu", "gelu_pytorch_tanh"):
                    case = f"{label} H={H} I={I} {str(dtype)[6:]} B={B} K={K} ({B * K} rows) {act}"
                    worst_mlp = max(worst_mlp, check_fused_mlp(torch, db, args, act, case))
                    check_repeat(torch, "fused_mlp_block",
                                 lambda: db.fused_mlp_block(*args, eps=FUSED_EPS, act=act), case)
                    n_mlp += 1
                del args
            torch.cuda.empty_cache()
    log(f"fused_attn_block: {n_attn} cases agree with the plain version (largest abs err {worst_attn:.3e})")
    log(f"fused_mlp_block: {n_mlp} cases agree with the plain version (largest abs err {worst_mlp:.3e})")
    return n_attn, n_mlp


#: the 1B decode step the fused layer is timed at: bucket 512, every row's
#: new token at position FUSED_TIMED_CTX - 1 (the middle of the 128 + 256
#: token generate())
FUSED_TIMED_CTX = 256
#: the spin before an eager unfused half-layer (~40 launches from the host)
UNFUSED_SPIN = 8 * SPIN_CYCLES


def fused_timed_inputs(torch, gen, B):
    """B8's and B9's arguments at the 1B decode step they are timed at
    (bf16, K=1, bucket 512, every row FUSED_TIMED_CTX deep, one layer's
    weights of std 0.02): (attention args, MLP args), both on x."""
    from neuronx_distributed_inference_tpu_torch.modules.masks import token_gen_mask
    from neuronx_distributed_inference_tpu_torch.ops.roofline import MODEL_1B

    m = MODEL_1B
    H, Hq, Hkv, D, I = m["H"], m["Hq"], m["Hkv"], m["D"], m["I"]
    bucket, ctx, bf16 = 512, FUSED_TIMED_CTX, torch.bfloat16

    def rn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=DEV) * std).to(bf16)

    x, g1, g2 = rn(B, 1, H), 1 + rn(H, std=0.1), 1 + rn(H, std=0.1)
    wqkv, wout = rn(H, (Hq + 2 * Hkv) * D, std=0.02), rn(Hq * D, H, std=0.02)
    wg, wu, wd = rn(H, I, std=0.02), rn(H, I, std=0.02), rn(I, H, std=0.02)
    kc, vc = rn(m["L"], B + 1, 1024, Hkv, D), rn(m["L"], B + 1, 1024, Hkv, D)
    pos = torch.full((B, 1), ctx - 1, dtype=torch.int32, device=DEV)
    cols = torch.arange(bucket, device=DEV)[None, :]
    mask = token_gen_mask((cols < ctx).to(torch.int32).expand(B, bucket), 1)  # the main path's view
    slots = torch.arange(B, dtype=torch.int32, device=DEV)
    cos, sin = _rope_tables(torch, pos, D)
    return (x, g1, wqkv, wout, cos, sin, kc, vc, 1, slots, mask, pos), (x, g2, wg, wu, wd)


def phase_fused_times(torch, db):
    """B8 and B9 at Llama-3.2-1B's decode shapes (bf16, K=1, bucket 512,
    every row FUSED_TIMED_CTX deep, one layer's weights of std 0.02), at
    batch 1 and 4: each held to its plain version first, then timed beside
    its plain version, its bound, and the unfused route over the same
    inputs, the port's eager path with B1: the attention half (rmsnorm,
    fused QKV, RoPE, the cache scatter, B1, o-proj, residual) and the MLP
    half (rmsnorm, gated_mlp, residual), and the whole layer each way (B8,
    the scatter and B9 against the two unfused halves); then B9 alone at
    the other FUSED_POINTS (16 rows of the 1B MLP, the 8B MLP at batch 1).
    No single PyTorch call computes either block: no library time."""
    from neuronx_distributed_inference_tpu_torch.models.base import ModelSpec, gated_mlp
    from neuronx_distributed_inference_tpu_torch.modules.attention import AttnSpec, o_project, qkv_project
    from neuronx_distributed_inference_tpu_torch.modules.kvcache import update_cache_at_layer
    from neuronx_distributed_inference_tpu_torch.modules.norm import rms_norm
    from neuronx_distributed_inference_tpu_torch.ops.decode_attention import tkg_decode_attention
    from neuronx_distributed_inference_tpu_torch.ops.roofline import FUSED_POINTS, MODEL_1B, attn_block, mlp_block

    m = MODEL_1B
    H, Hq, Hkv, D, I = m["H"], m["Hq"], m["Hkv"], m["D"], m["I"]
    bucket, ctx = 512, FUSED_TIMED_CTX
    aspec = AttnSpec(num_heads=Hq, num_kv_heads=Hkv, head_dim=D)
    spec = ModelSpec(num_layers=m["L"], vocab_size=8, attn=aspec, rms_eps=FUSED_EPS)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(14)
    rows = {}
    for B in (1, 4):
        attn_args, mlp_args = fused_timed_inputs(torch, gen, B)
        x, g1, wqkv, wout, cos, sin, kc, vc, _, slots, mask, pos = attn_args
        g2, wg, wu, wd = mlp_args[1:]
        kw = dict(scale=D ** -0.5, eps=FUSED_EPS, n_kv=Hkv)
        err_a = check_fused_attn(torch, db, attn_args, f"timed 1b B={B} K=1 bucket={bucket} ctx={ctx} bf16")
        err_m = check_fused_mlp(torch, db, mlp_args, "silu", f"timed 1b B={B} K=1 bf16 silu")
        attn_p = {"qkv_proj": {"weight": wqkv}, "o_proj": {"weight": wout}}
        mlp_p = {"gate_proj": {"weight": wg}, "up_proj": {"weight": wu}, "down_proj": {"weight": wd}}

        def unfused_attn(h):
            q, k, v = qkv_project(attn_p, rms_norm(h, g1, FUSED_EPS), cos, sin, aspec)
            update_cache_at_layer(kc, vc, k, v, 1, slots, pos)
            a = tkg_decode_attention(q, kc, vc, 1, mask, None, scale=D ** -0.5, n_kv=Hkv)
            return h + o_project(attn_p, a)

        def unfused_mlp(h):
            return h + gated_mlp(mlp_p, rms_norm(h, g2, FUSED_EPS), spec)

        def fused_layer():
            h, k_new, v_new = db.fused_attn_block(*attn_args, **kw)
            update_cache_at_layer(kc, vc, k_new, v_new, 1, slots, pos)
            return db.fused_mlp_block(h, g2, wg, wu, wd, eps=FUSED_EPS)

        t = dict(
            attn=time_ms(torch, lambda: db.fused_attn_block(*attn_args, **kw)),
            attn_plain=time_ms(torch, lambda: db.fused_attn_block_plain(*attn_args, **kw), iters=10),
            mlp=time_ms(torch, lambda: db.fused_mlp_block(*mlp_args, eps=FUSED_EPS)),
            mlp_plain=time_ms(torch, lambda: db.fused_mlp_block_plain(*mlp_args, eps=FUSED_EPS), iters=10),
            unfused_attn=time_ms(torch, lambda: unfused_attn(x), spin=UNFUSED_SPIN),
            unfused_mlp=time_ms(torch, lambda: unfused_mlp(x), spin=UNFUSED_SPIN),
            fused_layer=time_ms(torch, fused_layer, spin=UNFUSED_SPIN),
            unfused_layer=time_ms(torch, lambda: unfused_mlp(unfused_attn(x)), spin=UNFUSED_SPIN),
        )
        b8 = launch_breakdown(torch, lambda: db.fused_attn_block(*attn_args, **kw), B8_LAUNCHES)
        b9 = launch_breakdown(torch, lambda: db.fused_mlp_block(*mlp_args, eps=FUSED_EPS), B9_LAUNCHES)
        parts = {**{f"B8 {k}": v for k, v in b8.items()}, **{f"B9 {k}": v for k, v in b9.items()}}
        log(f"  launches inside B8 and B9 at B={B}, device us: " + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()))
        prior = int(db.prior_mask(mask, pos)[:, 0].any(dim=1).sum().item())  # (row, position) pairs read
        ba, ba_by = bound(*attn_block(m, B, 1, prior, bucket))
        bm, bm_by = bound(*mlp_block(m, B))
        rows[("fused_attn_block", B)] = dict(
            ms=t["attn"], plain_ms=t["attn_plain"], library_ms=None, bound_ms=ba, bound_by=ba_by, max_abs_err=err_a,
            unfused_ms=t["unfused_attn"],
        )
        rows[("fused_mlp_block", B)] = dict(
            ms=t["mlp"], plain_ms=t["mlp_plain"], library_ms=None, bound_ms=bm, bound_by=bm_by, max_abs_err=err_m,
            unfused_ms=t["unfused_mlp"],
        )
        rows[("fused_layer", B)] = dict(fused_ms=t["fused_layer"], unfused_ms=t["unfused_layer"], launches_us=parts)
        log(
            f"fused_attn_block 1b B={B} K=1 bucket={bucket} {prior} cached positions read, bf16: kernel "
            f"{t['attn']:.4f} ms, plain {t['attn_plain']:.4f} ms, unfused attention half (B1) "
            f"{t['unfused_attn']:.4f} ms, bound {ba:.5f} ms ({ba_by}), {ba / t['attn']:.3f} of the bound"
        )
        log(
            f"fused_mlp_block 1b B={B} K=1 H={H} I={I} bf16: kernel {t['mlp']:.4f} ms, plain "
            f"{t['mlp_plain']:.4f} ms, unfused MLP half {t['unfused_mlp']:.4f} ms, bound {bm:.5f} ms ({bm_by}), "
            f"{bm / t['mlp']:.3f} of the bound"
        )
        log(
            f"decode layer 1b B={B}: fused (B8, scatter, B9) {t['fused_layer']:.4f} ms, unfused "
            f"{t['unfused_layer']:.4f} ms (device time)"
        )
        del kc, vc, wqkv, wout, wg, wu, wd
        torch.cuda.empty_cache()
    for label, pt in FUSED_POINTS.items():
        if pt["prior"] is None:  # B9 alone: 16 rows of the 1B MLP, the 8B MLP at batch 1
            rows[("fused_mlp_block", label)] = time_mlp_point(torch, db, gen, label, pt["m"], pt["batch"])
    return rows


def mlp_timed_inputs(torch, gen, m, B):
    """B9's arguments at one decode step of the widths ``m`` (bf16, K=1,
    ``B`` rows, weights of std 0.02, as fused_timed_inputs)."""
    def rn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=DEV) * std).to(torch.bfloat16)

    H, I = m["H"], m["I"]
    return (rn(B, 1, H), 1 + rn(H, std=0.1), rn(H, I, std=0.02), rn(H, I, std=0.02), rn(I, H, std=0.02))


def time_mlp_point(torch, db, gen, label, m, B):
    """B9 alone at one timed point: held to its plain version, then timed
    beside it, its bound and the unfused MLP half (rmsnorm, gated_mlp,
    residual), with its device us per launch."""
    from neuronx_distributed_inference_tpu_torch.models.base import ModelSpec, gated_mlp
    from neuronx_distributed_inference_tpu_torch.modules.attention import AttnSpec
    from neuronx_distributed_inference_tpu_torch.modules.norm import rms_norm
    from neuronx_distributed_inference_tpu_torch.ops.roofline import mlp_block

    args = mlp_timed_inputs(torch, gen, m, B)
    x, g2, wg, wu, wd = args
    H, I = m["H"], m["I"]
    err = check_fused_mlp(torch, db, args, "silu", f"timed {label} B={B} K=1 H={H} I={I} bf16 silu")
    spec = ModelSpec(num_layers=m["L"], vocab_size=8, rms_eps=FUSED_EPS,
                     attn=AttnSpec(num_heads=m["Hq"], num_kv_heads=m["Hkv"], head_dim=m["D"]))
    mlp_p = {"gate_proj": {"weight": wg}, "up_proj": {"weight": wu}, "down_proj": {"weight": wd}}
    ms = time_ms(torch, lambda: db.fused_mlp_block(*args, eps=FUSED_EPS))
    plain_ms = time_ms(torch, lambda: db.fused_mlp_block_plain(*args, eps=FUSED_EPS), iters=10)
    unfused_ms = time_ms(torch, lambda: x + gated_mlp(mlp_p, rms_norm(x, g2, FUSED_EPS), spec), spin=UNFUSED_SPIN)
    us = launch_breakdown(torch, lambda: db.fused_mlp_block(*args, eps=FUSED_EPS), B9_LAUNCHES)
    bm, bm_by = bound(*mlp_block(m, B))
    log(f"  launches inside B9 at {label}, device us: " + ", ".join(f"{k} {v:.2f}" for k, v in us.items()))
    log(
        f"fused_mlp_block {label} B={B} K=1 H={H} I={I} bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"unfused MLP half {unfused_ms:.4f} ms, bound {bm:.5f} ms ({bm_by}), {bm / ms:.3f} of the bound"
    )
    del args, x, wg, wu, wd
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bm, bound_by=bm_by, max_abs_err=err,
                unfused_ms=unfused_ms, launches_us=us)


#: the grid launches of one B7, one B8 and one B9 call, in launch order
B7_LAUNCHES = ("gate/up", "down", "combine")
B8_LAUNCHES = ("QKV", "attention", "o-proj")
B9_LAUNCHES = ("gate/up", "down")


def launch_breakdown(torch, fn, labels, n=10):
    """Device time in us of each grid launch inside one call of ``fn``
    (``labels`` names them in launch order; each is a kernel of its own
    name): torch.profiler over ``n`` calls, the L2 evicted and a spin queued
    before each (as in time_ms, so the call's launches are queued before
    the card reaches them). A programmatic dependent launch starts before
    the one before it ends and waits inside, so each later launch also gets
    "<label> past <previous>": from the later of its start and the previous
    launch's end to its own end, the time the call spends on it alone. A
    trace may drop a launch (most often its first), so the launches are
    grouped into calls by the spin's gap, the labels follow the name order
    of the calls that hold every launch, and the averages are over those
    calls; a trace with fewer than half of them is taken again (twice at
    most), then fails."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    fn()
    torch.cuda.synchronize()
    calls = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                flush.zero_()
                torch.cuda._sleep(SPIN_CYCLES)
                fn()
            torch.cuda.synchronize()
        ours = sorted(
            (e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA and "nxdi" in e.name),
            key=lambda e: e.time_range.start,
        )
        groups = []
        for e in ours:  # a new call after a gap of more than 100 us (the spin is ~500 us)
            if not groups or e.time_range.start - groups[-1][-1].time_range.end > 100:
                groups.append([])
            groups[-1].append(e)
        calls = [g for g in groups if len(g) == len(labels) and len({e.name for e in g}) == len(labels)]
        if len(calls) >= n // 2:
            break
    else:
        raise SystemExit(f"launch breakdown: {len(calls)} whole calls of {labels} in {n}")
    order = max({tuple(e.name for e in g) for g in calls}, key=lambda o: sum(tuple(e.name for e in g) == o for g in calls))
    calls = [g for g in calls if tuple(e.name for e in g) == order]
    by = {label: sum(g[k].time_range.elapsed_us() for g in calls) / len(calls) for k, label in enumerate(labels)}
    for k in range(1, len(labels)):
        past = [g[k].time_range.end - max(g[k].time_range.start, g[k - 1].time_range.end) for g in calls]
        by[f"{labels[k]} past {labels[k - 1]}"] = sum(past) / len(past)
        # > 0: the launch started that many us before the one ahead of it ended
        early = [g[k - 1].time_range.end - g[k].time_range.start for g in calls]
        by[f"{labels[k]} early"] = sum(early) / len(early)
    return by


def _config_fused(batch_size, fused, **kw):
    """Llama-3.2-1B generate() with the fused decode layer on (both flags
    True) or off (both False): batch 4 is the bf16_1b_bs4 row
    (bench.py:1029-1033: CTE [128], TKG [512]); batch 1 the main path's
    bf16_1b_bs1 configuration."""
    flags = dict(fused_attn_block_kernel_enabled=fused, fused_mlp_kernel_enabled=fused)
    if batch_size == 4:
        flags.update(context_encoding_buckets=[128], token_generation_buckets=[512])
    return _config(batch_size, **flags, **kw)


def fused_teacher_forced(torch, params, ref, n_layers, prompt_len=128):
    """The fused path's teacher-forced logits over the main path's tokens,
    gated against the main path's plain bf16 and fp32 logits (the rules of
    teacher_forced). Every decode step's layers must take B8 and B9."""
    from neuronx_distributed_inference_tpu_torch.ops import _cuda

    seq = ref["forced_seq"]
    _cuda.reset_launch_counts()
    k = _forced_logits(torch, _config_fused(1, True, output_logits=True), params, seq, prompt_len)
    counts = all_counts()
    steps = n_layers * (len(seq) - 1 - prompt_len)
    want = expect_launches(flash_attention=n_layers, fused_attn_block=steps, fused_mlp_block=steps)
    if counts != want:
        raise SystemExit(f"fused teacher-forced run: counts {counts} != {want}")
    return _forced_gate(k, ref["plain_logits"], ref["fp32_logits"], "fused teacher-forced logits")


def phase_fused_1b(torch, params, ref):
    """Llama-3.2-1B generate() at batch 4 (bf16_1b_bs4) and batch 1, each
    with the fused decode layer on and off, all in this call, on the main
    path's weights (128-token seeded prompts, 256 greedy tokens): exact
    counts (with it on, B8 = B9 = the B1 count of the run with it off, B1 =
    0, B2 = 16), tok/s, TTFT and a profile of one 16-step decode chunk
    each; then the fused path's teacher-forced gate. Batch 4 runs on first,
    batch 1 off first."""
    from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM

    prompt_len, n_new = 128, 256
    runs = {}
    for batch, order in ((4, (True, False)), (1, (False, True))):
        for fused in order:
            label = f"1B generate, fused layer {'on' if fused else 'off'}"
            app = ModelForCausalLM(None, _config_fused(batch, fused)).load(params=params).warmup()
            n_layers = app.spec.num_layers
            out, run = _generate_run(torch, app, prompt_len, n_new, label, batch=batch)
            run.update(phase_profile(torch, app, out.sequences, prompt_len, label=label))
            run["tokens"] = out.sequences[:, prompt_len:]
            runs[(batch, fused)] = run
            del app
            torch.cuda.empty_cache()
        on, off = runs[(batch, True)], runs[(batch, False)]
        b1 = off["launches"]["decode_attention"]
        # the 255 tokens after the first run as one 256-step chunk in bucket 512
        want_off = expect_launches(flash_attention=n_layers, decode_attention=n_layers * 256)
        want_on = expect_launches(flash_attention=n_layers, fused_attn_block=b1, fused_mlp_block=b1)
        if off["launches"] != want_off or on["launches"] != want_on:
            raise SystemExit(
                f"fused 1B batch {batch}: counts on {on['launches']} != {want_on} or off {off['launches']} != {want_off}"
            )
        same = float((on["tokens"] == off["tokens"]).mean())
        log(
            f"fused layer at batch {batch}, on vs off: decode {on['decode_tok_s']:.1f} vs {off['decode_tok_s']:.1f} "
            f"tok/s, TTFT {on['ttft_ms']:.2f} vs {off['ttft_ms']:.2f} ms, host {on['decode_step_ms']:.3f} vs "
            f"{off['decode_step_ms']:.3f} ms/step, device busy {on['device_busy_ms']:.3f} vs "
            f"{off['device_busy_ms']:.3f} ms/step (share {on['device_busy_frac']:.3f} vs "
            f"{off['device_busy_frac']:.3f}), {on['kernels_per_step']:.0f} vs {off['kernels_per_step']:.0f} kernels per "
            f"step; greedy tokens equal at {same:.3f} of positions"
        )
    forced = fused_teacher_forced(torch, params, ref, n_layers)
    return dict(runs=runs, forced=forced, launches=runs[(4, True)]["launches"])


# ---------------------------------------------------------------------------
# 11. CUDA graphs: every main path with graphs on and off in this call
# ---------------------------------------------------------------------------


def _same_tokens(a, b):
    if isinstance(a, dict):
        return a == b
    return np.array_equal(np.asarray(a), np.asarray(b))


def graph_run(torch, make_app, run, graphs, profile=None, warm_pass=False):
    """One workload on an app that ``make_app(graphs)`` builds and warms:
    with ``warm_pass`` (and graphs) the workload runs once first and every
    runner is sealed after it (configs that warmup() leaves unsealed). The
    measured run sits inside a RetraceGuard that fails with graphs on:
    after warmup and the seal, a steady-state run captures nothing. Returns
    the tokens, launch counts, peak memory (allocated, and reserved: the
    graphs' pool holds freed blocks), warmup and run seconds, captures and
    ``profile(app, tokens)``'s numbers."""
    from neuronx_distributed_inference_tpu_torch.analysis.retrace_guard import RetraceGuard
    from neuronx_distributed_inference_tpu_torch.ops import _cuda

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    app = make_app(graphs)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    if warm_pass and graphs:
        run(app)
        for runner in app._all_runners():
            runner.seal()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    with RetraceGuard(fail=graphs):
        tokens = run(app)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = all_counts()
    peak, reserved = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
    prof = {}
    if profile is not None:
        # the profile may reach keys the run did not (a fresh session's
        # packing): lift the seal for it
        with contextlib.ExitStack() as stack:
            for runner in app._all_runners():
                stack.enter_context(runner.seal_suspended())
            prof = profile(app, tokens)
    return dict(
        tokens=tokens, counts=counts, peak_bytes=peak, reserved_bytes=reserved, warm_s=warm_s, run_s=run_s,
        captures=app.graphs.captures, **{k: v for k, v in prof.items() if k != "busy_ms_per_step"},
    )


def graph_pair(torch, label, make_app, run, profile=None, warm_pass=False, profile_off=True):
    """One workload with the runners' programs run eagerly
    (``cuda_graphs=False``) and through captured graphs (graph_run each).
    Requires byte-identical greedy tokens and equal launch counts (the
    graphs' census added per replay), and no capture after the graph app's
    warmup and seal; prints the profile's host ms, device busy, kernels and
    launch calls per step (both runs', or with ``profile_off=False`` the
    graphed run's only) and the peak memory of both."""
    res = {graphs: graph_run(torch, make_app, run, graphs, profile if graphs or profile_off else None, warm_pass)
           for graphs in (False, True)}
    off, on = res[False], res[True]
    if not _same_tokens(off["tokens"], on["tokens"]):
        raise SystemExit(f"graphs, {label}: the greedy tokens differ between graphs on and off")
    if off["counts"] != on["counts"] or not sum(on["counts"].values()):
        raise SystemExit(f"graphs, {label}: launch counts on {on['counts']} != off {off['counts']}")
    if off["captures"] or not on["captures"]:
        raise SystemExit(f"graphs, {label}: captures off {off['captures']}, on {on['captures']}")
    line = (
        f"graphs on vs off, {label}: tokens identical, launch counts equal; {on['captures']} graphs captured at "
        f"warmup (and first use), none after; warmup {on['warm_s']:.2f} vs {off['warm_s']:.2f} s, run "
        f"{on['run_s'] * 1e3:.1f} vs {off['run_s'] * 1e3:.1f} ms; peak memory allocated {on['peak_bytes'] / 2**30:.3f} "
        f"vs {off['peak_bytes'] / 2**30:.3f} GiB, reserved {on['reserved_bytes'] / 2**30:.3f} vs "
        f"{off['reserved_bytes'] / 2**30:.3f} GiB"
    )
    if profile is not None and not profile_off:
        line += (f"; graphed run: host {on['decode_step_ms']:.3f} ms/step, device busy {on['device_busy_ms']:.3f} "
                 f"ms/step (share {on['device_busy_frac']:.3f}), {on['kernels_per_step']:.0f} kernels per step, "
                 f"cudaGraphLaunch {on['launch_api']['cudaGraphLaunch'][0]:.3f} ms/step")
    elif profile is not None:
        api = lambda r, n: r["launch_api"][n][0]  # noqa: E731
        line += (
            f"; host {on['decode_step_ms']:.3f} vs {off['decode_step_ms']:.3f} ms/step, device busy "
            f"{on['device_busy_ms']:.3f} vs {off['device_busy_ms']:.3f} ms/step (share {on['device_busy_frac']:.3f} vs "
            f"{off['device_busy_frac']:.3f}), {on['kernels_per_step']:.0f} vs {off['kernels_per_step']:.0f} kernels per "
            f"step; cudaLaunchKernel {api(on, 'cudaLaunchKernel'):.3f} vs {api(off, 'cudaLaunchKernel'):.3f} ms/step, "
            f"cudaLaunchKernelEx {api(on, 'cudaLaunchKernelEx'):.3f} vs {api(off, 'cudaLaunchKernelEx'):.3f}, "
            f"cudaGraphLaunch {api(on, 'cudaGraphLaunch'):.3f} vs {api(off, 'cudaGraphLaunch'):.3f}"
        )
    log(line)
    for r in res.values():
        r.pop("tokens")
    return res


def phase_graphs(torch, params):
    """Graphs on and off, in turns, on the 1B weights: generate() with the
    fused decode layer off and on at batch 1 and 4 (sealed by warmup), and
    the split and ragged serving drains of _serve's traffic, synchronous and
    1-ahead (sealed after a warm pass), each through graph_pair."""
    from neuronx_distributed_inference_tpu_torch.models.llama import LLAMA_1B
    from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM
    from neuronx_distributed_inference_tpu_torch.telemetry import TelemetrySession

    prompt_len, n_new = 128, 256
    vocab = LLAMA_1B["vocab_size"]
    out = {}
    for batch in (1, 4):
        prompt = np.random.RandomState(0).randint(0, vocab, size=(batch, prompt_len))
        for fused in (False, True):
            label = f"1B generate, batch {batch}, fused layer {'on' if fused else 'off'}"

            def make(graphs, batch=batch, fused=fused):
                cfg = _config_fused(batch, fused, cuda_graphs=graphs, retrace_guard=True)
                return ModelForCausalLM(None, cfg).load(params=params).warmup()

            def run(app, prompt=prompt):
                return app.generate(prompt, max_new_tokens=n_new).sequences

            def prof(app, seq, label=label):
                return phase_profile(torch, app, seq, prompt_len, label=label)

            out[("generate", batch, fused)] = graph_pair(torch, label, make, run, prof)

    s = SERVING
    rng = np.random.RandomState(0)  # phase_serving's prompts
    prompts = [rng.randint(0, vocab - 10, size=(s["prompt"],)).tolist() for _ in range(s["n_requests"])]
    for kind in ("split", "ragged"):
        for one_ahead in (False, True):
            label = f"{kind} serving drain, {'1-ahead' if one_ahead else 'sync'}"
            kw = dict(async_mode=one_ahead)
            if kind == "ragged":
                kw = dict(serving_ragged=True, serving_ragged_async=one_ahead)

            def make(graphs, kw=kw):
                return ModelForCausalLM(None, _serving_config(cuda_graphs=graphs, **kw)).load(params=params).warmup()

            def run(app):
                sess, _ = _serve(torch, app, prompts, s["gen"], TelemetrySession())
                if any(r.status != "finished" for r in sess.requests.values()):
                    raise SystemExit(f"graphs, {label}: a request did not finish")
                return {rid: list(r.generated) for rid, r in sess.requests.items()}

            prof = None
            if kind == "ragged":
                def prof(app, _tokens, label=label):
                    return phase_ragged_profile(torch, app, prompts, label)
            elif not one_ahead:
                def prof(app, _tokens):
                    return phase_serving_profile(torch, app)
            out[(kind, one_ahead)] = graph_pair(torch, label, make, run, prof, warm_pass=True)
    return out


def eager_twin(torch, label, cfg, app, out, run, prompt_len, n_new, profile_steps=PROFILE_STEPS):
    """The generate() ``out``/``run`` of ``app`` (graphs, sealed) against an
    eager twin (``cfg``, cuda_graphs=False) over the same params: identical
    greedy tokens and launch counts; the twin's profile and peak memory
    printed beside the graph run's."""
    from neuronx_distributed_inference_tpu_torch.ops import _cuda
    from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    twin = ModelForCausalLM(None, cfg).load(params=app.params).warmup()
    prompt = np.random.RandomState(0).randint(0, app.spec.vocab_size, size=(1, prompt_len))
    _cuda.reset_launch_counts()
    got = twin.generate(prompt, max_new_tokens=n_new)
    counts = all_counts()
    peak = torch.cuda.max_memory_allocated()
    if not np.array_equal(got.sequences, out.sequences) or counts != run["launches"]:
        raise SystemExit(f"{label}: eager twin tokens or counts differ (counts {counts} vs {run['launches']})")
    prof = phase_profile(torch, twin, got.sequences[0], prompt_len, steps=profile_steps, label=f"{label}, graphs off")
    del twin
    torch.cuda.empty_cache()
    log(f"graphs on vs off, {label}: tokens identical, launch counts equal; peak memory {run['peak_bytes'] / 2**30:.3f} vs {peak / 2**30:.3f} GiB")
    return {k: v for k, v in prof.items() if k != "busy_ms_per_step"}


#: the sampled phase: draws per row set, and the warping it samples with
SAMPLED_ROWS, SAMPLED_CALLS = 64, 40
SAMPLED_PARAMS = dict(top_k=50, top_p=0.9, temperature=0.8)


def phase_sampled(torch, params):
    """Multinomial sampling through the captured graphs at 1B: 64 rows of
    one seeded prompt generate 8 tokens with do_sample, 40 calls (each call
    reseeds the generator): the first tokens (the context program's draws,
    2560 of one distribution) against warped_probs of the run's own
    first-step logits on the card, by a chi-square test (p > 1e-3; bins
    below 5 expected draws merged); every decode step's draw inside its own
    step's warped window; two calls differ."""
    from scipy import stats

    from neuronx_distributed_inference_tpu_torch.config import OnDeviceSamplingConfig
    from neuronx_distributed_inference_tpu_torch.modules.sampling import prepare_sampling_params, warped_probs
    from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM

    B, prompt_len = SAMPLED_ROWS, 128
    cfg = _config(
        B, seq_len=256, context_encoding_buckets=[128], token_generation_buckets=[256], output_logits=True,
        on_device_sampling_config=OnDeviceSamplingConfig(do_sample=True, top_k=50),
    )
    app = ModelForCausalLM(None, cfg).load(params=params).warmup()
    prompt = np.tile(np.random.RandomState(4).randint(0, app.spec.vocab_size, size=(1, prompt_len)), (B, 1))
    firsts, seqs = [], []
    sp = torch.from_numpy(prepare_sampling_params(B, **SAMPLED_PARAMS)).to(DEV)
    outside = 0
    for _ in range(SAMPLED_CALLS):
        out = app.generate(prompt, max_new_tokens=8, **SAMPLED_PARAMS)
        gen = out.sequences[:, prompt_len:]
        firsts.append(gen[:, 0])
        seqs.append(gen)
        logits = torch.from_numpy(out.logits).to(DEV)  # (B, 8, V)
        for j in range(gen.shape[1]):
            probs = warped_probs(logits[:, j], sp, app.spec.max_topk)
            chosen = probs[torch.arange(B, device=DEV), torch.from_numpy(gen[:, j]).to(DEV)]
            outside += int((chosen <= 0).sum())
    p0 = warped_probs(torch.from_numpy(out.logits[:1, 0]).to(DEV), sp[:1], app.spec.max_topk)[0].cpu().numpy()
    draws = np.concatenate(firsts)
    n = draws.size
    kept = np.flatnonzero(p0 > 0)
    expected = p0[kept].astype(np.float64) / p0[kept].sum() * n
    counts = np.bincount(draws, minlength=p0.size)[kept]
    big = expected >= 5
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(expected[big], expected[~big].sum())
    if exp[-1] == 0:
        obs, exp = obs[:-1], exp[:-1]
    outside += n - int(obs.sum())  # first tokens outside the window
    chi2, p = stats.chisquare(obs, exp * (obs.sum() / exp.sum()))
    distinct_calls = len({tuple(g[0]) for g in seqs})
    log(
        f"sampled 1B generate (graphs, top_k 50, top_p 0.9, temperature 0.8): {n} first-token draws over "
        f"{kept.size} kept tokens ({int(big.sum())} bins of >= 5 expected, the rest merged): chi-square {chi2:.2f}, "
        f"p {p:.4f}; decode draws outside their step's window: {outside} of {SAMPLED_CALLS * B * 8}; "
        f"{distinct_calls} distinct row-0 continuations in {SAMPLED_CALLS} calls"
    )
    if p <= 1e-3 or outside or distinct_calls < 2:
        raise SystemExit("sampled phase: the draws do not follow warped_probs")
    del app
    torch.cuda.empty_cache()
    return dict(chi2=chi2, p=p, draws=n)


def phase_pdl_graphs(torch, db):
    """Does programmatic dependent launch survive graph capture? B8's three
    and B9's two launches at the 1B decode step, batch 1 (fused_timed_inputs),
    profiled eagerly and as the replay of one captured graph of the call:
    each later launch's start before the launch ahead of it ends ("early",
    us) and its time past it."""
    from neuronx_distributed_inference_tpu_torch.ops.roofline import MODEL_1B
    from neuronx_distributed_inference_tpu_torch.runtime.graphs import GraphSet

    gen = torch.Generator(device=DEV)
    gen.manual_seed(14)
    attn_args, mlp_args = fused_timed_inputs(torch, gen, 1)
    D, Hkv = MODEL_1B["D"], MODEL_1B["Hkv"]
    calls = {
        "B8": (lambda: db.fused_attn_block(*attn_args, scale=D ** -0.5, eps=FUSED_EPS, n_kv=Hkv), B8_LAUNCHES),
        "B9": (lambda: db.fused_mlp_block(*mlp_args, eps=FUSED_EPS), B9_LAUNCHES),
    }
    gs = GraphSet(torch.device("cuda"), True)
    out = {}
    for name, (fn, labels) in calls.items():
        scope = gs.scope("pdl", name)
        gs.eager(scope, fn)
        g = gs.capture(scope, fn, ())
        eager, graph = launch_breakdown(torch, fn, labels), launch_breakdown(torch, g.replay, labels)
        out[name] = dict(eager=eager, graph=graph)
        log(f"PDL under graphs, {name} (1B, batch 1), us: " + "; ".join(
            f"{k} {graph[k]:.2f} (eager {eager[k]:.2f})" for k in eager
        ))
    gs.close()
    return out


# ---------------------------------------------------------------------------
# 12. the quantized KV cache: the code modes of B1, B4, B5 and B3, and the
#     long-context rows
# ---------------------------------------------------------------------------

#: the int8/fp8 code types of a quantized KV cache (Config.kv_cache_dtype
#: int8, fp8 = float8_e4m3, float8_e5m2)
KV_CODES = ("int8", "float8_e4m3fn", "float8_e5m2")
#: the counters of the code modes (ops/_cuda.py KERNELS)
CODE_COUNTERS = {
    "decode_attention": "decode_attention_codes", "paged_decode_attention": "paged_decode_attention_codes",
    "paged_flash_attention": "paged_flash_attention_codes", "ragged_paged_attention": "ragged_paged_attention_codes",
}


def code_stream(torch, rng, shape, L, H, code, garbage_block=False):
    """A QuantizedKV stream on the card: random codes over the code type's
    range (normal, a quarter of qmax wide, clipped; drawn on the card from a
    seed of ``rng``) and (L, H) scales in [0.5, 2). With ``garbage_block``
    block 0 of the head-major paged layout holds byte 0x7F (NaN for fp8, 127
    for int8): the kernels must not read it."""
    from neuronx_distributed_inference_tpu_torch.modules.kvcache import QuantizedKV, kv_qmax

    dt = getattr(torch, code)
    qmax = kv_qmax(dt)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(int(rng.randint(1 << 31)))
    x = torch.clamp(torch.randn(shape, generator=gen, device="cuda") * (qmax / 4), -qmax, qmax)
    data = (torch.round(x) if dt == torch.int8 else x).to(dt)
    if garbage_block:
        data.view(torch.uint8)[:, 0] = 0x7F
    scale = torch.from_numpy(rng.uniform(0.5, 2.0, (L, H)).astype(np.float32)).cuda()
    return QuantizedKV(data, scale)


def _code_launch(torch, counter, fn):
    """``fn()`` (one wrapper call) must launch the code mode once and
    nothing else."""
    from neuronx_distributed_inference_tpu_torch.ops import _cuda

    before = all_counts()
    out = fn()
    torch.cuda.synchronize()
    after = all_counts()
    moved = {n: after[n] - before[n] for n in after if after[n] != before[n]}
    if moved != {counter: 1}:
        raise SystemExit(f"{counter}: a code-mode call launched {moved}")
    return out


def check_codes(torch, what, counter, kernel, plain, case, rows=None):
    """The code mode (bf16 or fp32 q, 1-byte codes) against its plain
    version in fp32 on the same codes and scales (dequantized after the gather),
    within check_close's one-rounding bound, then launched twice more,
    bit-identical."""
    out = _code_launch(torch, counter, kernel)
    ref = plain()
    err = check_close(torch, out, ref, case, what, rows)
    check_repeat(torch, what, kernel, case)
    return err


def kvq_decode_case(torch, rng, code, B, K, Hq, Hkv, D, bucket, L=2, q_dtype=None):
    """B1's inputs over a quantized contiguous cache (L, B+1, bucket, Hkv,
    D): rows of lengths bucket - 7 and shorter, q_len K, q in ``q_dtype``
    (bf16 by default)."""
    kq = code_stream(torch, rng, (L, B + 1, bucket, Hkv, D), L, Hkv, code)
    vq = code_stream(torch, rng, (L, B + 1, bucket, Hkv, D), L, Hkv, code)
    valid = [bucket - 7, 90, bucket // 2, 300][:B]
    pos = np.stack([np.arange(valid[b] - K, valid[b]) for b in range(B)])
    mask = torch.from_numpy((np.arange(bucket)[None, None, :] <= pos[:, :, None])[:, None]).cuda()
    q = torch.from_numpy(rng.randn(B, K, Hq, D).astype(np.float32) * DECODE_Q_STD).to("cuda", q_dtype or torch.bfloat16)
    return q, kq, vq, mask


def kvq_paged_decode_case(torch, rng, code, bs, ctx=192, B=8, Hq=32, Hkv=8, D=64, width=1024, L=2, NB=512, K=1,
                          q_dtype=None):
    """B4's inputs: the serving row's decode step (B rows ctx deep, q_len K,
    q in ``q_dtype``, bf16 by default) over a quantized paged pool with 0x7F
    in block 0."""
    from neuronx_distributed_inference_tpu_torch.modules.masks import token_gen_mask

    MB = width // bs
    table = torch.from_numpy(paged_tables(rng, [ctx] * B, MB, bs, NB)).cuda()
    kq = code_stream(torch, rng, (L, NB + 1, Hkv, bs, D), L, Hkv, code, garbage_block=True)
    vq = code_stream(torch, rng, (L, NB + 1, Hkv, bs, D), L, Hkv, code, garbage_block=True)
    q = torch.from_numpy(rng.randn(B, K, Hq, D).astype(np.float32) * DECODE_Q_STD).to("cuda", q_dtype or torch.bfloat16)
    attn = (torch.arange(width, device="cuda")[None, :] < ctx).to(torch.int32).expand(B, width)
    return q, kq, vq, table, token_gen_mask(attn, K)


def code_kwargs(kq, vq, layer=0):
    """(codes, factors) of one layer of two QuantizedKV streams: the code
    mode's scale kwargs as the model passes them (views of the layer's
    running scales, the code type's qmax: the kernel divides on the device)
    and the plain versions' factors scale / qmax."""
    from neuronx_distributed_inference_tpu_torch.modules.kvcache import kv_qmax, layer_dequant_factors

    codes = dict(k_scale=kq.scale[layer], v_scale=vq.scale[layer], kv_qmax=kv_qmax(kq.dtype))
    return codes, dict(k_scale=layer_dequant_factors(kq, layer), v_scale=layer_dequant_factors(vq, layer))


def code_exact_scores(torch, q, kc):
    """exact_score_inputs over code blocks: q rounded to quarters (|q| <=
    12); int8 codes as they are (integers, |k| <= 127), fp8 codes rounded to
    eighths (|k| <= 24; the nearest fp8 value of an eighth is an eighth);
    block 0 keeps 0x7F. Every product is a multiple of 2^-5 and every Q.K^T
    sum stays below 2^24 of them, so the raw scores are exact in fp32 in any
    order, the kernel's and the plain version's alike."""
    qq = (q.float() * 4).round().clamp(-48, 48).div(4).to(q.dtype)
    kq = kc.clone() if kc.dtype == torch.int8 else (kc.float() * 8).round().clamp(-24, 24).div(8).to(kc.dtype)
    kq.view(torch.uint8)[0] = 0x7F
    return qq, kq


def kvq_chunk_case(torch, rng, code, prefix=64, Sq=128, B=8, Hq=32, Hkv=8, D=64, bs=32, width=1024, NB=512):
    """B5's timed inputs: B rows prefilling Sq new tokens after a
    ``prefix``-token prefix (positions prefix .. prefix + Sq - 1, kv_limit
    prefix + Sq), one layer of a quantized pool with 0x7F in block 0, bf16
    q, and code_kwargs."""
    MB = width // bs
    table = torch.from_numpy(paged_tables(rng, [prefix + Sq] * B, MB, bs, NB)).cuda()
    kq = code_stream(torch, rng, (1, NB + 1, Hkv, bs, D), 1, Hkv, code, garbage_block=True)
    vq = code_stream(torch, rng, (1, NB + 1, Hkv, bs, D), 1, Hkv, code, garbage_block=True)
    q = torch.from_numpy(rng.randn(B, Sq, Hq, D).astype(np.float32) * DECODE_Q_STD).to("cuda", torch.bfloat16)
    pos = (prefix + torch.arange(Sq, device="cuda", dtype=torch.int32))[None, :].expand(B, Sq).contiguous()
    lim = torch.full((B,), prefix + Sq, device="cuda", dtype=torch.int32)
    return (q, kq.data[0], vq.data[0], table, pos, lim, *code_kwargs(kq, vq))


def kvq_flash_case(torch, rng, code, D, bs, q_dtype, B=8, Sq=128, Hq=32, Hkv=8, MB=16):
    """B5's parity inputs over code blocks: phase_paged_flash_parity's rows
    (paged_flash_rows: prefix + causal, kv_limit-0 rows) over one layer of a
    quantized pool with 0x7F in block 0, q in ``q_dtype``, and code_kwargs."""
    NB = MB * B + 4
    bt, pos, lim = paged_flash_rows(torch, rng, B, Sq, MB, bs, NB)
    kq = code_stream(torch, rng, (1, NB + 1, Hkv, bs, D), 1, Hkv, code, garbage_block=True)
    vq = code_stream(torch, rng, (1, NB + 1, Hkv, bs, D), 1, Hkv, code, garbage_block=True)
    q = torch.from_numpy(rng.randn(B, Sq, Hq, D).astype(np.float32) * DECODE_Q_STD).to("cuda", q_dtype)
    return (q, kq.data[0], vq.data[0], bt, pos, lim, *code_kwargs(kq, vq))


def kvq_ragged_case(torch, rng, code, row_len, ctx_len, bs, width, Hq=32, Hkv=8, D=64, NB=512, q_dtype=None):
    """B3's inputs: ragged_case's packing over one layer of a quantized pool
    with 0x7F in block 0, q in ``q_dtype`` (bf16 by default), and
    code_kwargs: (q, k, v, table, row_start, row_len, ctx_len, valid
    slots), codes, factors."""
    NB = NB or sum(-(-c // bs) for c in ctx_len) + 4
    q, _, _, table, rs, rl, cl, valid = ragged_case(
        torch, rng, list(row_len), list(ctx_len), Hq, Hkv, D, bs, width // bs, torch.float32, NB=NB
    )
    kq = code_stream(torch, rng, (1, NB + 1, Hkv, bs, D), 1, Hkv, code, garbage_block=True)
    vq = code_stream(torch, rng, (1, NB + 1, Hkv, bs, D), 1, Hkv, code, garbage_block=True)
    return (q.to(q_dtype or torch.bfloat16), kq.data[0], vq.data[0], table, rs, rl, cl, valid), *code_kwargs(kq, vq)


#: fp32 q over a code cache (an fp32 model with an int8/fp8 KV cache): B1
#: and B4 cases (Hq, Hkv, D, B, K) that reach each of the kernel's fp32-q
#: instances, D 64 and 128 by rows a warp holds (n_rep * K up to 8, and more)
KVQ_FP32_CASES = ((32, 8, 64, 1, 1), (32, 8, 64, 4, 4), (32, 4, 128, 1, 1), (32, 4, 128, 2, 4))


def phase_kvq_parity(torch, da, pf, rp):
    """Each code mode (int8, e4m3, e5m2) against its plain version on the
    card, each case launched twice more, bit-identical: B1 at Llama-3.2-1B's
    shape (Hq 32, Hkv 8, D 64) at buckets 512 and 8704, batch 1 and 4, q_len
    1 and 4, at 16896 (the 16k row's decode: batch 1, q_len 1), and at
    Qwen3's (Hkv 4, D 128) at 512; B4 at 8 rows 192 deep, blocks of 32 and
    16; B1 and B4 with an fp32 q at KVQ_FP32_CASES. B5 and B3 at D 64 and
    128, blocks of 16 and 32, bf16 and fp32 q, over pools with 0x7F in
    block 0 and the kernel given the layer's running scales and qmax: B5 at
    paged_flash_rows (kv_limit-0 rows), B3 at RAGGED_SPLIT_ROWS 1024 wide
    (a chunk mid-context and decode rows 1 to 1024 deep: several live
    splits), then at roofline.RAGGED_POINTS; every bf16 case again on
    code_exact_scores inputs. Bounds: check_paged_flash / check_ragged
    (bf16 q: the tensor-core tiles against the plain version that rounds P
    as they do, the decode tiles within one bf16 rounding; fp32 q within
    1e-4 / 1e-5)."""
    from neuronx_distributed_inference_tpu_torch.ops import _cuda
    from neuronx_distributed_inference_tpu_torch.ops.roofline import RAGGED_POINTS

    rng = np.random.RandomState(12)
    n, worst = 0, 0.0
    bf16 = torch.bfloat16
    for code in KV_CODES:
        shapes = [(32, 8, 64, bucket, B, K, bf16) for bucket in (512, 8704) for B in (1, 4) for K in (1, 4)]
        shapes += [(32, 8, 64, 16896, 1, 1, bf16), (32, 4, 128, 512, 1, 1, bf16)]
        shapes += [(Hq, Hkv, D, 512, B, K, torch.float32) for Hq, Hkv, D, B, K in KVQ_FP32_CASES]
        for Hq, Hkv, D, bucket, B, K, dt in shapes:
            q, kq, vq, mask = kvq_decode_case(torch, rng, code, B, K, Hq, Hkv, D, bucket, q_dtype=dt)
            kw = dict(scale=D ** -0.5, n_kv=Hkv)
            case = f"{code} B={B} K={K} Hq={Hq} Hkv={Hkv} D={D} bucket={bucket} q {str(dt)[6:]}"
            worst = max(worst, check_codes(
                torch, "tkg_decode_attention", "decode_attention_codes",
                lambda: da.tkg_decode_attention(q, kq, vq, 1, mask, None, **kw),
                lambda: da.tkg_decode_attention_plain(q.float(), kq, vq, 1, mask, None, **kw), case,
            ))
            n += 1
            del kq, vq
        paged = [(32, 8, 64, 8, 1, bs, bf16) for bs in (32, 16)]
        paged += [(Hq, Hkv, D, B, K, bs, torch.float32)
                  for (Hq, Hkv, D, B, K), bs in zip(KVQ_FP32_CASES, (32, 16, 32, 16))]
        for Hq, Hkv, D, B, K, bs, dt in paged:
            q, kq, vq, bt, mask = kvq_paged_decode_case(torch, rng, code, bs, B=B, Hq=Hq, Hkv=Hkv, D=D, K=K,
                                                        q_dtype=dt)
            kw = dict(scale=D ** -0.5, n_kv=Hkv)
            worst = max(worst, check_codes(
                torch, "paged_tkg_decode_attention", "paged_decode_attention_codes",
                lambda: da.paged_tkg_decode_attention(q, kq, vq, 1, bt, mask, None, **kw),
                lambda: da.paged_tkg_decode_attention_plain(q.float(), kq, vq, 1, bt, mask, None, **kw),
                f"{code} B={B} K={K} Hq={Hq} Hkv={Hkv} D={D} ctx=192 bs={bs} width=1024 q {str(dt)[6:]}",
            ))
            n += 1
        for D in (64, 128):
            for bs in (16, 32):
                for dt in (bf16, torch.float32):
                    what = f"{code} D={D} bs={bs} q {str(dt)[6:]}"
                    q, kc, vc, bt, pos, lim, codes, factors = kvq_flash_case(torch, rng, code, D, bs, dt)
                    kw = dict(scale=D ** -0.5, n_rep=4)
                    for exact in (False, True) if dt == bf16 else (False,):
                        qc, kcc = code_exact_scores(torch, q, kc) if exact else (q, kc)
                        case = f"{what} B=8 Sq=128 kv_limit {lim.tolist()}{', exact scores' if exact else ''}"
                        worst = max(worst, check_paged_flash(torch, pf, qc, kcc, vc, bt, pos, lim, kw, case, exact,
                                                             codes, factors))
                        n += 1
                    split_len, split_ctx = RAGGED_SPLIT_ROWS
                    inputs, codes, factors = kvq_ragged_case(torch, rng, code, split_len, split_ctx, bs, 1024, D=D,
                                                             NB=None, q_dtype=dt)
                    T = inputs[0].shape[0]
                    splits, per = rp.ragged_decode_split(T, 1024, 8, 4, _cuda.sm_count(inputs[0].device)) \
                        if dt == bf16 else (1, 1024)
                    atol = DECODE_ATOL if dt == bf16 else RAGGED_FP32_ATOL
                    for exact in (False, True) if dt == bf16 else (False,):
                        qc, kcc = code_exact_scores(torch, *inputs[:2]) if exact else inputs[:2]
                        case = (f"{what} row_len {split_len} ctx_len {split_ctx} width 1024 ({splits} splits of {per})"
                                f"{', exact scores' if exact else ''}")
                        worst = max(worst, check_ragged(torch, rp, (qc, kcc, *inputs[2:]), case, atol, exact,
                                                        codes, factors))
                        n += 1
        for name, pt in RAGGED_POINTS.items():
            inputs, codes, factors = kvq_ragged_case(
                torch, rng, code, pt["row_len"], pt["ctx_len"], pt["block_size"], pt["width"]
            )
            for exact in (False, True):
                qc, kcc = code_exact_scores(torch, *inputs[:2]) if exact else inputs[:2]
                case = f"{code} {name} point{', exact scores' if exact else ''}"
                worst = max(worst, check_ragged(torch, rp, (qc, kcc, *inputs[2:]), case, DECODE_ATOL, exact,
                                                codes, factors))
                n += 1
    log(f"code modes: {n} cases agree with their plain versions, each bit-identical twice (largest abs err {worst:.3e})")
    return n


def phase_long_context_parity(torch, da, fa):
    """The bf16 twins' kernels at the long-context rows' shapes, against
    their plain versions: B1's bf16 mode at buckets 8704 and 16896 (batch
    1, q_len 1, Hq 32, Hkv 8, D 64; check_close's bound, two more launches
    bit-identical) and B2 at the 8192- and 16384-token prompts (batch 1,
    the fused projection's layout, the main path's fp32 softmax; check_flash's
    bounds). The plain B2 runs one kv head's group of q heads at a time: a
    whole (32, S, S) fp32 score tensor would not fit the card."""
    rng = np.random.RandomState(14)
    for bucket in (8704, 16896):
        q, kc, vc, mask = _decode_inputs(torch, rng, 1, 1, 32, 8, 64, 2, bucket, bucket, torch.bfloat16,
                                         [bucket - 7])
        kw = dict(scale=0.125, n_kv=8)
        case = f"bf16 B=1 K=1 Hq=32 Hkv=8 D=64 bucket={bucket}"
        check_codes(torch, "tkg_decode_attention", "decode_attention",
                    lambda: da.tkg_decode_attention(q, kc, vc, 1, mask, None, **kw),
                    lambda: da.tkg_decode_attention_plain(q.float(), kc.float(), vc.float(), 1, mask, None, **kw),
                    case)
        del q, kc, vc, mask
    for S in (8192, 16384):
        q, k, v = fused_qkv_inputs(torch, rng, 1, S, 32, 8, 64, torch.bfloat16)
        key_valid = torch.ones((1, S), dtype=torch.int32, device="cuda")
        kw = dict(scale=0.125, causal=True, softmax_bf16=False, window=None, chunk=None)
        out, m, l = _code_launch(torch, "flash_attention", lambda: fa.flash_attention_fwd(q, k, v, key_valid, **kw))
        err = m_err = l_rel = 0.0
        for h in range(8):
            g = slice(4 * h, 4 * h + 4)
            ref, m_ref, l_ref = fa.flash_attention_plain(q[:, :, g], k[:, :, h : h + 1], v[:, :, h : h + 1],
                                                         key_valid, **kw)
            err = max(err, (out[:, :, g].float() - ref.float()).abs().max().item())
            m_err = max(m_err, (m[:, g] - m_ref).abs().max().item())
            l_rel = max(l_rel, ((l[:, g] - l_ref).abs() / l_ref.clamp(min=1e-30)).max().item())
            del ref, m_ref, l_ref
            torch.cuda.empty_cache()
        tol, l_tol = flash_tolerances(torch, q.dtype, False)
        ok = err <= tol and m_err <= M_TOL and l_rel <= l_tol
        case = f"main-path layout B=1 S={S} Hq=32 Hkv=8 D=64 bfloat16 softmax_bf16=False"
        log(f"  flash {case}: out err {err:.3e} (tol {tol:.1e}), m err {m_err:.1e} (tol {M_TOL:.0e}), "
            f"l rel err {l_rel:.1e} (tol {l_tol:.1e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"flash_attention disagrees with its plain version: {case}")
        check_repeat(torch, "flash_attention", lambda: fa.flash_attention_fwd(q, k, v, key_valid, **kw), case)
        del q, k, v, out, m, l
        torch.cuda.empty_cache()
    log("long-context shapes: B1's bf16 mode at 8704 and 16896 and B2 at 8192 and 16384 agree with their plain "
        "versions, each bit-identical twice")
    return 4


def _sdpa_rows(torch, q, k_r, v_r, mask, n_rep):
    """SDPA's operands from q (B, K, Hq, D) and dequantized (B, S, Hkv, D)
    K/V in q's dtype: the library yardstick."""
    return (q.transpose(1, 2), k_r.to(q.dtype).permute(0, 2, 1, 3).repeat_interleave(n_rep, dim=1),
            v_r.to(q.dtype).permute(0, 2, 1, 3).repeat_interleave(n_rep, dim=1), mask)


def phase_kvq_times(torch, da, pf, rp):
    """Each code mode at its timed point (B1 at buckets 512 and 8704 batch
    1, B4 at blocks of 32, B5 at 8 x 128 new tokens after a 64-token
    prefix, B3 mixed and decode), held to its plain version first, beside
    the bf16 mode at the same point, in this call: kernel ms (L2 flushed)
    per code type, the int8 plain version's ms, SDPA on K/V dequantized
    beforehand (the dequantization not timed; for B3 one call per row,
    replayed from a CUDA graph), and the bound at code bytes
    (ops/roofline.py, each input read once: codes, the (Hkv,) factors, bf16
    q and out)."""
    import torch.nn.functional as F

    from neuronx_distributed_inference_tpu_torch.modules.block_kvcache import read_block_cache_at_layer
    from neuronx_distributed_inference_tpu_torch.modules.kvcache import QuantizedKV, dequantize_kv, read_cache_at_layer
    from neuronx_distributed_inference_tpu_torch.modules.masks import token_gen_mask
    from neuronx_distributed_inference_tpu_torch.ops.roofline import CODE, RAGGED_POINTS, ragged_work

    rng = np.random.RandomState(13)
    rows = {}

    def record(key, label, ms_by_code, bf16_ms, plain_ms, lib_ms, nbytes, flops, err):
        b_ms, b_by = bound(nbytes, flops)
        rows[key] = dict(ms=ms_by_code["int8"], plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                         max_abs_err=err, by_code=ms_by_code, bf16_ms=bf16_ms)
        log(f"{label}: code mode " + ", ".join(f"{c} {ms:.4f}" for c, ms in ms_by_code.items())
            + f" ms; bf16 mode {bf16_ms:.4f} ms; int8 plain {plain_ms:.4f} ms, sdpa on dequantized K/V {lib_ms:.4f} ms, "
            f"bound at code bytes {b_ms:.5f} ms ({b_by}), err vs plain {err:.3e}")

    # B1, the long-context rows' decode at batch 1 (and the main path's 512)
    Hq, Hkv, D, L = 32, 8, 64, 4
    for bucket in (512, 8704):
        valid = bucket - 100
        cols = torch.arange(bucket, device="cuda")[None, :]
        mask = token_gen_mask((cols < valid).to(torch.int32), 1)
        q = torch.from_numpy(rng.randn(1, 1, Hq, D).astype(np.float32) * DECODE_Q_STD).to("cuda", torch.bfloat16)
        kw = dict(scale=D ** -0.5, n_kv=Hkv)
        state = {"layer": 0}

        def nxt():
            state["layer"] = (state["layer"] + 1) % L
            return state["layer"]

        ms_by, err = {}, 0.0
        for code in KV_CODES:
            kq = code_stream(torch, rng, (L, 2, bucket, Hkv, D), L, Hkv, code)
            vq = code_stream(torch, rng, (L, 2, bucket, Hkv, D), L, Hkv, code)
            e = check_close(torch, da.tkg_decode_attention(q, kq, vq, 0, mask, None, **kw),
                            da.tkg_decode_attention_plain(q.float(), kq, vq, 0, mask, None, **kw),
                            f"timed {code} B=1 bucket={bucket}", "tkg_decode_attention")
            ms_by[code] = time_ms(torch, lambda: da.tkg_decode_attention(q, kq, vq, nxt(), mask, None, **kw))
            if code == "int8":
                err = e
                plain_ms = time_ms(torch, lambda: da.tkg_decode_attention_plain(q, kq, vq, nxt(), mask, None, **kw))
                k_r, v_r = read_cache_at_layer(kq, vq, 0, 1, bucket)
                sd = _sdpa_rows(torch, q, k_r, v_r, mask, Hq // Hkv)
                lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(sd[0], sd[1], sd[2], attn_mask=sd[3]))
                kb, vb = kq.data.to(torch.bfloat16), vq.data.to(torch.bfloat16)
                bf16_ms = time_ms(torch, lambda: da.tkg_decode_attention(q, kb, vb, nxt(), mask, None, **kw))
                nbytes, flops = decode_work(q, kq.data, mask)
                nbytes += 2 * Hkv * 4  # the layer's K and V factors
                del k_r, v_r, sd, kb, vb
            del kq, vq
        record(("decode_attention_codes", bucket), f"tkg_decode_attention code mode B=1 K=1 bucket={bucket} "
               f"valid={valid} Hq=32 Hkv=8 D=64", ms_by, bf16_ms, plain_ms, lib_ms, nbytes, flops, err)

    # B4, the serving row's decode step (8 rows 192 deep, blocks of 32)
    ms_by, ctx = {}, 192
    for code in KV_CODES:
        q, kq, vq, bt, mask = kvq_paged_decode_case(torch, rng, code, 32, L=L)
        kw = dict(scale=0.125, n_kv=Hkv)
        e = check_close(torch, da.paged_tkg_decode_attention(q, kq, vq, 0, bt, mask, None, **kw),
                        da.paged_tkg_decode_attention_plain(q.float(), kq, vq, 0, bt, mask, None, **kw),
                        f"timed {code} B=8 ctx=192 bs=32", "paged_tkg_decode_attention")
        ms_by[code] = time_ms(torch, lambda: da.paged_tkg_decode_attention(q, kq, vq, nxt(), bt, mask, None, **kw))
        if code == "int8":
            err = e
            plain_ms = time_ms(torch, lambda: da.paged_tkg_decode_attention_plain(q, kq, vq, nxt(), bt, mask, None, **kw))
            k_r, v_r = read_block_cache_at_layer(kq, vq, 0, bt)
            sd = _sdpa_rows(torch, q, k_r, v_r, mask, Hq // Hkv)
            lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(sd[0], sd[1], sd[2], attn_mask=sd[3]))
            kb, vb = kq.data.to(torch.bfloat16), vq.data.to(torch.bfloat16)
            bf16_ms = time_ms(torch, lambda: da.paged_tkg_decode_attention(q, kb, vb, nxt(), bt, mask, None, **kw))
            B = q.shape[0]
            nbytes = 2 * B * ctx * Hkv * D * CODE + 2 * q.numel() * 2 + mask.numel() + bt.numel() * 4 + 2 * Hkv * 4
            flops = 4 * D * Hq * int(mask.sum().item())
            del k_r, v_r, sd, kb, vb
    record("paged_decode_attention_codes", "paged_tkg_decode_attention code mode B=8 ctx=192 bs=32 bucket=1024",
           ms_by, bf16_ms, plain_ms, lib_ms, nbytes, flops, err)

    # B5, 8 rows x 128 new tokens after a 64-token prefix
    ms_by = {}
    for code in KV_CODES:
        q, kc, vc, bt, pos, lim, codes, factors = kvq_chunk_case(torch, rng, code)
        kw = dict(scale=0.125, n_rep=4)
        e = check_paged_flash(torch, pf, q, kc, vc, bt, pos, lim, kw, f"timed {code} B=8 Sq=128 prefix 64", False,
                              codes, factors)
        ms_by[code] = time_ms(torch, lambda: pf.paged_flash_attention(q, kc, vc, bt, pos, lim, **codes, **kw))
        if code == "int8":
            err = e
            plain_ms = time_ms(torch, lambda: pf.paged_flash_attention_plain(q, kc, vc, bt, pos, lim, **factors, **kw))
            k_r, v_r = read_block_cache_at_layer(kc[None], vc[None], 0, bt)
            k_r, v_r = k_r.float() * factors["k_scale"][:, None], v_r.float() * factors["v_scale"][:, None]
            cols = torch.arange(k_r.shape[1], device="cuda")[None, None, None, :]
            smask = (cols <= pos[:, None, :, None]) & (cols < lim[:, None, None, None])
            sd = _sdpa_rows(torch, q, k_r, v_r, smask, 4)
            lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(sd[0], sd[1], sd[2], attn_mask=sd[3]))
            kb, vb = kc.to(torch.bfloat16), vc.to(torch.bfloat16)
            bf16_ms = time_ms(torch, lambda: pf.paged_flash_attention(q, kb, vb, bt, pos, lim, **kw))
            B, Sq = pos.shape
            nbytes = 2 * q.numel() * 2 + 2 * B * int(lim[0]) * Hkv * D * CODE + (pos.numel() + lim.numel() + bt.numel()) * 4
            nbytes += 2 * Hkv * 4
            flops = 4 * D * Hq * int(smask.sum().item())
            del k_r, v_r, sd, kb, vb
    record("paged_flash_attention_codes", "paged_flash_attention code mode B=8 Sq=128 after a 64-token prefix, bs=32",
           ms_by, bf16_ms, plain_ms, lib_ms, nbytes, flops, err)

    # B3 at the serving row's two points; the yardstick, a loop of SDPA
    # calls per row, timed eagerly (host-bound) and replayed from a graph
    for name, pt in RAGGED_POINTS.items():
        ms_by = {}
        for code in KV_CODES:
            inputs, codes, factors = kvq_ragged_case(
                torch, rng, code, pt["row_len"], pt["ctx_len"], pt["block_size"], pt["width"]
            )
            q, kc, vc, bt, rs, rl, cl, _ = inputs
            kw = dict(scale=0.125, n_rep=4)
            e = check_ragged(torch, rp, inputs, f"timed {code} {name} point", DECODE_ATOL, False, codes, factors)
            ms_by[code] = time_ms(torch, lambda: rp.ragged_paged_attention(q, kc, vc, bt, rs, rl, cl, **codes, **kw))
            if code == "int8":
                err = e
                plain_ms = time_ms(torch, lambda: rp.ragged_paged_attention_plain(q, kc, vc, bt, rs, rl, cl, **factors,
                                                                                  **kw))
                k_r, v_r = read_block_cache_at_layer(kc[None], vc[None], 0, bt)
                k_r = (k_r.float() * factors["k_scale"][:, None]).to(q.dtype)
                v_r = (v_r.float() * factors["v_scale"][:, None]).to(q.dtype)
                per_row = sdpa_per_row(torch, q, k_r, v_r, rs, rl, cl, pt["width"], 4)
                eager_ms, lib_ms = sdpa_per_row_ms(torch, F, per_row)
                kb, vb = kc.to(torch.bfloat16), vc.to(torch.bfloat16)
                bf16_ms = time_ms(torch, lambda: rp.ragged_paged_attention(q, kb, vb, bt, rs, rl, cl, **kw))
                nbytes, flops = ragged_work(rl.tolist(), cl.tolist(), pt["width"], pt["block_size"],
                                            dict(Hq=Hq, Hkv=Hkv, D=D), 2, kv_elt=CODE)
                del k_r, v_r, per_row, kb, vb
        record(("ragged_paged_attention_codes", name), f"ragged_paged_attention code mode {name} point",
               ms_by, bf16_ms, plain_ms, lib_ms, nbytes, flops, err)
        log(f"  sdpa per row on dequantized K/V, {name} point: replayed from a graph {lib_ms:.4f} ms (the "
            f"yardstick), eager {eager_ms:.4f} ms (host-bound)")
    return rows


#: the long-context rows (bench.py:1001-1002, 1234-1253): Llama-3.2-1B,
#: batch 1, an 8192- or 16384-token prompt, 32 new tokens, one CTE bucket
#: at the prompt and one TKG bucket at 8704 / 16896 positions
KVQ_ROWS = {"8k": dict(prompt=8192, seq=8704), "16k": dict(prompt=16384, seq=16896)}
KVQ_NEW = 32


def _config_kvq(row, **kw):
    r = KVQ_ROWS[row]
    return _config(1, seq_len=r["seq"], context_encoding_buckets=[r["prompt"]],
                   token_generation_buckets=[r["seq"]], **kw)


def _kvq_generate(torch, app, row, label):
    """One long-context generate() on a warmed app: TTFT and a timed 32-token
    generate() (_generate_run), B2 launched once a layer and B1 (its code
    mode on a quantized cache) as the only other kernel; prints tokens, B1
    launches, cache bytes, peak memory and decode ms per token."""
    kv = app.config.torch_config.kv_quantized
    out, run = _generate_run(torch, app, KVQ_ROWS[row]["prompt"], KVQ_NEW, label)
    b1 = run["launches"]["decode_attention_codes" if kv else "decode_attention"]
    L = app.spec.num_layers
    want = expect_launches(flash_attention=L, **{("decode_attention_codes" if kv else "decode_attention"): b1})
    if run["launches"] != want or not b1:
        raise SystemExit(f"{label}: launches {run['launches']}, expected B2 {L} and B1 only")
    nbytes = app.kv_cache_nbytes
    log(f"{label}: {KVQ_NEW} tokens {out.sequences[0, -KVQ_NEW:].tolist()[:8]}...; B1 launches {b1}; KV cache "
        f"{nbytes / 2**20:.1f} MiB; peak {run['peak_bytes'] / 2**30:.3f} GiB; decode "
        f"{1e3 / run['decode_tok_s']:.3f} ms/token ({run['decode_tok_s']:.1f} tok/s), TTFT {run['ttft_ms']:.1f} ms")
    return out, dict(run, b1=b1, cache_bytes=nbytes, tokens=out.sequences[0, -KVQ_NEW:].tolist())


def kvq_teacher_forced(torch, params, seq, prompt_len):
    """The kv-int8 kernel route and the kv-int8 plain route (attention
    kernels off: B2's plain prefill, the dequantizing decode read), each
    teacher-forced over ``seq`` against an fp32 run of the plain route with
    the int8 cache on the same weights: the kernel route sits no farther
    from fp32 than FORCED_RATIO times the plain route (max and RMS)."""
    from neuronx_distributed_inference_tpu_torch.ops import _cuda

    off = dict(attn_kernel_enabled=False, attn_block_tkg_kernel_enabled=False)
    _cuda.reset_launch_counts()
    k = _forced_logits(torch, _config(1, output_logits=True, kv_cache_dtype="int8"), params, seq, prompt_len)
    steps = len(seq) - 1 - prompt_len
    L = 16
    want = expect_launches(flash_attention=L, decode_attention_codes=L * steps)
    if all_counts() != want:
        raise SystemExit(f"kv-int8 teacher-forced: kernel run counts {all_counts()} != {want}")
    pl = plain_run("kv-int8 teacher-forced bf16", _forced_logits, torch,
                   _config(1, output_logits=True, kv_cache_dtype="int8", **off), params, seq, prompt_len)
    params32 = _map_tree(params, lambda t: t.float())
    f32 = plain_run("kv-int8 teacher-forced fp32", _forced_logits, torch,
                    _config(1, output_logits=True, dtype="float32", kv_cache_dtype="int8", **off), params32, seq,
                    prompt_len)
    del params32
    torch.cuda.empty_cache()
    return _forced_gate(k, pl, f32, "kv-int8 teacher-forced logits")


def phase_kv_quant(torch, da, pf, rp, fa, params, forced_seq):
    """The quantized KV cache on every path: the code modes' parity and
    times; the bf16 twins' kernels at the long-context shapes; the
    long-context rows bf16_1b_8k_kvq8 and bf16_1b_16k_kvq8 at full width
    and depth with graphs on and off (identical tokens, bit-identical final
    scales, nothing captured after the seal; the graphed decode step
    profiled) beside their bf16 twins run once with graphs on (and the 8k
    row once more with fp8 codes), B1's code mode launched as often as the
    twin's bf16 mode; the kv-int8 teacher-forced gate; the split and ragged
    serving drains, sync and 1-ahead, with an int8 cache through graph_pair
    (code launches of B4, B5, B3 > 0, no fault, tokens equal with graphs on
    and off), the synchronous drains' graphed steps profiled (kernels a
    step, device busy, cudaGraphLaunch host ms)."""
    from neuronx_distributed_inference_tpu_torch.models.llama import LLAMA_1B
    from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM
    from neuronx_distributed_inference_tpu_torch.telemetry import TelemetrySession

    n_cases = timed("kv code-mode parity", phase_kvq_parity, torch, da, pf, rp)
    n_cases += timed("long-context shapes parity", phase_long_context_parity, torch, da, fa)
    times = timed("kv code-mode times", phase_kvq_times, torch, da, pf, rp)
    vocab = LLAMA_1B["vocab_size"]
    # each long-context row with graphs on and off (graph_pair), its bf16
    # twin with graphs on; the metrics are the graphed runs'
    runs, graphs = {}, {}
    for row, r in KVQ_ROWS.items():
        for kv in (None, "int8"):
            name = f"bf16_1b_{row}{'_kvq8' if kv else ''}"

            def make(graphs_on, row=row, kv=kv):
                cfg = _config_kvq(row, kv_cache_dtype=kv, cuda_graphs=graphs_on, retrace_guard=True)
                return ModelForCausalLM(None, cfg).load(params=params).warmup()

            def run(app, row=row, kv=kv, name=name):
                on = app.graphs.enabled
                out, m = _kvq_generate(torch, app, row, f"{name}, graphs {'on' if on else 'off'}")
                if on:
                    runs[(row, kv)] = m
                res = dict(tokens=out.sequences[0].tolist())
                if kv:
                    res.update(k_scale=app.kv_cache.k.scale.cpu().numpy().tobytes(),
                               v_scale=app.kv_cache.v.scale.cpu().numpy().tobytes())
                return res

            def prof(app, out, r=r, name=name):
                return phase_profile(torch, app, np.asarray(out["tokens"]), r["prompt"],
                                     label=f"{name} decode step, graphs on", bucket=r["seq"])

            if kv:
                graphs[(row, kv)] = graph_pair(torch, f"{name} generate (tokens and final scales)", make, run, prof,
                                               profile_off=False)
                log(f"{name}: final (L, Hkv) K and V scales bit-identical with graphs on and off")
            else:
                res = graph_run(torch, make, run, True, prof)
                if not res["captures"]:
                    raise SystemExit(f"{name}: no graph captured with graphs on")
                res.pop("tokens")
                graphs[(row, kv)] = {True: res}
        twin, q8 = runs[(row, None)], runs[(row, "int8")]
        if q8["b1"] != twin["b1"]:
            raise SystemExit(f"bf16_1b_{row}_kvq8: B1 code launches {q8['b1']} != the twin's {twin['b1']}")
        same = sum(a == b for a, b in zip(q8["tokens"], twin["tokens"]))
        log(f"bf16_1b_{row}_kvq8 vs bf16_1b_{row} (graphs on): cache {q8['cache_bytes'] / twin['cache_bytes']:.4f} of "
            f"the bf16 bytes, decode {1e3 / q8['decode_tok_s']:.3f} vs {1e3 / twin['decode_tok_s']:.3f} ms/token, "
            f"tokens equal at {same} of {KVQ_NEW} (not a gate: random weights, quantized cache)")
    app = ModelForCausalLM(None, _config_kvq("8k", kv_cache_dtype="fp8")).load(params=params).warmup()
    runs[("8k", "fp8")] = _kvq_generate(torch, app, "8k", "bf16_1b_8k (kv fp8)")[1]
    del app
    torch.cuda.empty_cache()
    forced = kvq_teacher_forced(torch, params, forced_seq[: 128 + 64], 128)

    s = SERVING
    rng = np.random.RandomState(0)  # phase_serving's prompts
    prompts = [rng.randint(0, vocab - 10, size=(s["prompt"],)).tolist() for _ in range(s["n_requests"])]
    serving = {}
    for kind in ("split", "ragged"):
        for one_ahead in (False, True):
            label = f"kv-int8 {kind} serving drain, {'1-ahead' if one_ahead else 'sync'}"
            kw = dict(async_mode=one_ahead, kv_cache_dtype="int8")
            if kind == "ragged":
                kw = dict(serving_ragged=True, serving_ragged_async=one_ahead, kv_cache_dtype="int8")

            def make(graphs, kw=kw):
                return ModelForCausalLM(None, _serving_config(cuda_graphs=graphs, **kw)).load(params=params).warmup()

            def run(app, label=label):
                tel = TelemetrySession()
                sess, _ = _serve(torch, app, prompts, s["gen"], tel)
                faults = sum(tel.rejected.values()) + tel.counters["quarantined"] + tel.counters["preempted"]
                if faults or any(r.status != "finished" for r in sess.requests.values()):
                    raise SystemExit(f"{label}: faults on clean traffic ({faults}) or an unfinished request")
                return {rid: list(r.generated) for rid, r in sess.requests.items()}

            # the synchronous drains' graphed steps profiled, beside the bf16
            # drains' in phase_graphs
            prof = None
            if kind == "ragged" and not one_ahead:
                def prof(app, _tokens, label=label):
                    return phase_ragged_profile(torch, app, prompts, label)
            elif not one_ahead:
                def prof(app, _tokens):
                    return phase_serving_profile(torch, app)
            res = graph_pair(torch, label, make, run, prof, warm_pass=True, profile_off=False)
            counts = res[True]["counts"]
            need = ("ragged_paged_attention_codes",) if kind == "ragged" else (
                "paged_decode_attention_codes", "paged_flash_attention_codes")
            plain = [n for n in ("paged_decode_attention", "paged_flash_attention", "ragged_paged_attention")
                     if counts[n]]
            if not all(counts[n] for n in need) or plain:
                raise SystemExit(f"{label}: code-mode launches {counts}")
            log(f"{label}: launches {{{', '.join(f'{n}: {counts[n]}' for n in need)}}}, 0 rejected or quarantined")
            serving[(kind, one_ahead)] = counts

    return dict(cases=n_cases, times=times, runs=runs, forced=forced, serving=serving, graphs=graphs)


# ---------------------------------------------------------------------------
# 13. speculative decoding (A7's first part)
# ---------------------------------------------------------------------------

#: serving_1b_int8_spec_ragged's speculation length (bench.py:1087-1097)
SPEC_K = 4
#: steps of the spec-ragged profiles (3000 to 7200 kernels a step; reading
#: a trace costs the host ~0.5 ms a kernel)
SPEC_PROFILE_STEPS = 4
#: B3's verify-segment cases in one launch, a table 1024 wide: a chunk from
#: mid-context, plain decode rows, and verify rows of 2, 3 and 4 tokens 196
#: and 1000 deep: (row_len, ctx_len)
SPEC_RAGGED_ROWS = ([40, 1, 2, 3, 4, 2, 3, 4, 1], [40 + 60, 196, 196, 196, 196, 1000, 1000, 1000, 1000])
#: B1's verify cases: batch 8 (the split path's target), K = 4, rows of
#: these depths
SPEC_DECODE_VALID = [196, 200, 256, 100, 500, 197, 130, 260]


def phase_spec_parity(torch, da, rp):
    """B3 on verify segments (SPEC_RAGGED_ROWS) at D 64 and 128, blocks of
    16 and 32, bf16 and fp32, n_rep 1, 4 and 8, each bf16 case again on
    exact-score inputs, through check_ragged (verify rows take the
    tensor-core prefill tiles: B5's P-rounding reference); the spec point
    runs in phase_ragged_parity with the other RAGGED_POINTS. Then B1 with
    K = 4 queries a row (the split path's verify and fused speculation's) at
    batch 8, buckets 512 and 1024, bf16 and fp32, through check_decode.
    Every case is bit-identical twice."""
    rng = np.random.RandomState(15)
    worst, n = 0.0, 0
    Hkv, width = 8, 1024
    row_len, ctx_len = (list(a) for a in SPEC_RAGGED_ROWS)
    for D in (64, 128):
        for bs in (16, 32):
            for dtype in (torch.bfloat16, torch.float32):
                atol = DECODE_ATOL if dtype == torch.bfloat16 else RAGGED_FP32_ATOL
                for n_rep in (1, 4, 8):
                    inputs = ragged_case(torch, rng, row_len, ctx_len, Hkv * n_rep, Hkv, D, bs, width // bs, dtype)
                    for exact in (False, True) if dtype == torch.bfloat16 else (False,):
                        q, k = exact_score_inputs(torch, inputs[0], inputs[1]) if exact else inputs[:2]
                        case = (f"verify rows D={D} bs={bs} {str(dtype)[6:]} n_rep={n_rep} row_len {row_len} "
                                f"ctx_len {ctx_len}{', exact scores' if exact else ''}")
                        worst = max(worst, check_ragged(torch, rp, (q, k, *inputs[2:]), case, atol, exact))
                        n += 1
    log(f"ragged_paged_attention verify segments: {n} cases agree with the plain version, each bit-identical "
        f"twice (largest abs err {worst:.3e})")
    worst1, n1 = 0.0, 0
    B, Hq, D, L = 8, 32, 64, 2
    for dtype in (torch.bfloat16, torch.float32):
        for bucket in (512, 1024):
            q, kc, vc, mask = _decode_inputs(torch, rng, B, SPEC_K, Hq, Hkv, D, L, 1024, bucket, dtype, SPEC_DECODE_VALID)
            kw = dict(scale=D ** -0.5, n_kv=Hkv)
            case = f"verify B={B} K={SPEC_K} bucket={bucket} rows {SPEC_DECODE_VALID} deep {str(dtype)[6:]}"
            worst1 = max(worst1, check_decode(torch, da, q, kc, vc, 1, mask, None, kw, case))
            check_repeat(torch, "tkg_decode_attention",
                         lambda: da.tkg_decode_attention(q, kc, vc, 1, mask, None, **kw), case)
            n1 += 1
    log(f"tkg_decode_attention K={SPEC_K}: {n1} cases agree with the plain version, each bit-identical twice "
        f"(largest abs err {worst1:.3e})")
    return n + n1


def phase_spec_times(torch, da):
    """B1 with K = 4 queries a row at batch 8, bucket 1024, rows 196 deep
    (the split path's verify pass), held to its plain version, beside the
    plain version, the bound for this run's inputs and SDPA over the cache
    slice gathered beforehand (not timed). B3 at the spec point is timed in
    phase_ragged_times."""
    import torch.nn.functional as F

    rng = np.random.RandomState(16)
    B, Hq, Hkv, D, L, bucket = 8, 32, 8, 64, 16, 1024
    valid = [196] * B
    q, kc, vc, mask = _decode_inputs(torch, rng, B, SPEC_K, Hq, Hkv, D, L, 1024, bucket, torch.bfloat16, valid)
    kw = dict(scale=D ** -0.5, n_kv=Hkv)
    state = {"layer": 0}

    def next_layer():
        state["layer"] = (state["layer"] + 1) % L
        return state["layer"]

    case = f"timed verify B={B} K={SPEC_K} bucket={bucket} rows 196 deep D=64 bf16"
    err = check_decode(torch, da, q, kc, vc, 0, mask, None, kw, case)
    log_split(torch, da, B, Hkv, bucket)
    qt = q.transpose(1, 2)
    kt = kc[0, :B, :bucket].permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, dim=1)
    vt = vc[0, :B, :bucket].permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, dim=1)
    ms = time_ms(torch, lambda: da.tkg_decode_attention(q, kc, vc, next_layer(), mask, None, **kw))
    plain_ms = time_ms(torch, lambda: da.tkg_decode_attention_plain(q, kc, vc, next_layer(), mask, None, **kw))
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
    b_ms, b_by = bound(*decode_work(q, kc, mask))
    log(f"tkg_decode_attention {case}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
        f"bound {b_ms:.5f} ms ({b_by}), err vs plain {err:.3e}")
    del kc, vc
    return {("decode_attention_verify", bucket): dict(
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err
    )}


def _spec_target_config(graphs=True, one_ahead=True, **kw):
    """serving_1b_int8_spec_ragged's target (bench.py:1087-1097): the
    serving row's paged pool and chunked prefill, serving_ragged with
    serving_spec_ragged and k = 4, int8 weights (fused QKV off, as the
    bench builds int8 apps)."""
    return _serving_config(
        serving_ragged=True, serving_ragged_async=one_ahead, serving_spec_ragged=True, speculation_length=SPEC_K,
        weight_dtype="int8", fused_qkv=False, cuda_graphs=graphs, **kw,
    )


def _spec_draft_config(graphs=True, model=None, seed=0, **kw):
    """The row's draft app (bench.py:1436-1442): the contiguous cache at the
    session's 8 slots and seq 1024, CTE and TKG buckets [1024], a context
    batch of 1, int8 weights."""
    s = SERVING
    return _config(
        s["slots"], model=model, is_continuous_batching=True, ctx_batch_size=1,
        context_encoding_buckets=[s["seq"]], token_generation_buckets=[s["seq"]],
        weight_dtype="int8", fused_qkv=False, cuda_graphs=graphs, seed=seed, **kw,
    )


class _SpecApps:
    """A target and a draft app as one workload's app for graph_run."""

    def __init__(self, target, draft):
        self.target, self.draft = target, draft

    def _all_runners(self):
        return self.target._all_runners() + self.draft._all_runners()

    @property
    def graphs(self):
        import types

        return types.SimpleNamespace(captures=self.target.graphs.captures + self.draft.graphs.captures)


def _serve_spec(torch, target, draft, prompts, gen, telemetry):
    """measure_serving_spec's traffic (bench.py:494-525): two requests up
    front, then one more per step() while slots are free, until every
    request ends. Returns (session, seconds, steps); the session's
    ``rounds`` lists each verify round's (request id, accepted drafts,
    drafted, the position of its first rejected draft or None) as the
    device counted them, before any cut at EOS or the budget."""
    from neuronx_distributed_inference_tpu_torch.runtime.serving import SpeculativeServingSession

    target.init_kv_cache()
    draft.init_kv_cache()
    sess = SpeculativeServingSession(target, draft, speculation_length=SPEC_K, telemetry=telemetry)
    sess.rounds = []
    note = sess._note_acceptance

    def noted(req, accepted, drafted):
        # the spec-ragged consume notes after advancing req.pos past the
        # committed tokens, the split path before
        rejected = None
        if accepted < drafted:
            rejected = req.pos if sess.spec_ragged else req.pos + accepted + 1
        sess.rounds.append((req.req_id, accepted, drafted, rejected))
        note(req, accepted, drafted)

    sess._note_acceptance = noted
    t0 = time.perf_counter()
    nxt, steps = 0, 0
    for _ in range(2):
        if not sess.add_request(str(nxt), prompts[nxt], max_new_tokens=gen):
            raise SystemExit(f"spec serving: request {nxt} refused")
        nxt += 1
    while True:
        sess.step()
        steps += 1
        if nxt < len(prompts) and sess.free_slots:
            if not sess.add_request(str(nxt), prompts[nxt], max_new_tokens=gen):
                raise SystemExit(f"spec serving: request {nxt} refused")
            nxt += 1
            continue
        if nxt >= len(prompts) and not (sess.active or sess._readmit):
            break
    torch.cuda.synchronize()
    return sess, time.perf_counter() - t0, steps


def spec_acceptance(sess, tel):
    """(acceptance rate, the bench's rate, mean tokens committed per verify
    round, verify rounds): the rate as the device counted it (accepted over
    drafted, _serve_spec's rounds), and the bench's rule over the committed
    tokens (measure_serving_spec: committed minus observations over drafted,
    lower where EOS or the budget cut a round)."""
    accepted = sum(r[1] for r in sess.rounds)
    drafted = sum(r[2] for r in sess.rounds)
    rounds = len(sess.rounds)
    committed = max(0, sum(tel.spec_accept_len) - len(tel.spec_accept_len))
    if not drafted:
        return None, None, None, rounds
    return accepted / drafted, committed / sum(tel.spec_draft_len), (committed + rounds) / rounds, rounds


def _spec_checks(sess, tel, gen, n_requests, vocab, label):
    """Every request complete, no fault, rejection or quarantine, tokens in
    the vocab."""
    counts = {rid: len(r.generated) for rid, r in sess.requests.items()}
    faults = dict(rejected=sum(tel.rejected.values()), quarantined=tel.counters["quarantined"],
                  preempted=tel.counters["preempted"])
    if sorted(counts.values()) != [gen] * n_requests:
        raise SystemExit(f"{label}: not every request completed: {counts}")
    if any(faults.values()) or any(r.status != "finished" for r in sess.requests.values()):
        raise SystemExit(f"{label}: faults on clean traffic: {faults}")
    for rid, r in sess.requests.items():
        if min(r.generated) < 0 or max(r.generated) >= vocab:
            raise SystemExit(f"{label}: request {rid} has tokens outside the vocab")
    return counts


def spec_token_gate(torch, app, params, prompts, tokens, margin, label, rejections=None):
    """The served tokens against ONE teacher-forced prefill of prompt +
    committed tokens through the same weights (modules' decoder stack over a
    fresh contiguous cache, B2): every committed token must be the prefill's
    argmax at its position wherever the top-2 margin there exceeds
    ``margin`` (twice the kernel path's largest logit error against fp32 in
    the teacher-forced gate of the same width); the positions under the
    margin are counted and printed. ``rejections`` ({request id: [position,
    ...]}, the first rejected draft of each round) are sorted by the same
    margin: with the target's own weights as the draft, a draft can only be
    rejected where the two paths' rounding may flip the argmax, so every
    rejection must sit at a position under the margin. Returns the counts,
    and the rejections over the margin."""
    from neuronx_distributed_inference_tpu_torch.models import base
    from neuronx_distributed_inference_tpu_torch.modules.kvcache import init_cache

    spec, mlp_fn = app.spec, app.builder.mlp_fn()
    dev = params["embed_tokens"]["weight"].device
    total = under = bad = 0
    rej_total = rej_over = 0
    for rid, gen in tokens.items():
        seq = list(prompts[int(rid)]) + list(gen)
        P, S = len(prompts[int(rid)]), len(seq)
        cache = init_cache(spec.num_layers, 1, S, spec.attn.num_kv_heads, spec.attn.head_dim,
                           dtype=torch.bfloat16, device=dev)
        inputs = base.StepInputs(
            input_ids=torch.tensor([seq], dtype=torch.int64, device=dev),
            attention_mask=torch.ones((1, S), dtype=torch.int32, device=dev),
            position_ids=torch.arange(S, dtype=torch.int32, device=dev)[None],
            seq_ids=torch.zeros(1, dtype=torch.int32, device=dev),
            sampling_params=torch.ones((1, 3), dtype=torch.float32, device=dev),
        )
        with torch.no_grad():
            hidden, _ = base.run_decoder_layers(
                params, base.embed(params, inputs.input_ids), cache, inputs, spec=spec,
                phase=base.PHASE_CONTEXT_ENCODING, mlp_fn=mlp_fn,
            )
            logits = base.lm_head(params, hidden[:, P - 1 : S - 1], spec)[0, :, : spec.vocab_size].float()
        top2 = torch.topk(logits, 2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > margin
        wrong = logits.argmax(-1) != torch.tensor(gen, device=dev)
        total += len(gen)
        under += int((~decided).sum().item())
        bad += int((wrong & decided).sum().item())
        for pos in (rejections or {}).get(rid, ()):
            if P <= pos < S:
                rej_total += 1
                rej_over += int(decided[pos - P].item())
        del cache, logits
    log(f"  {label} token gate: {total - under} of {total} committed tokens decided (top-2 margin > {margin:.4f}), "
        f"{under} under the margin; {bad} decided tokens differ from the teacher-forced argmax"
        + (f"; {rej_total} rejected drafts, {rej_over} of them at a decided position" if rejections else ""))
    if bad:
        raise SystemExit(f"{label}: {bad} committed tokens differ from the teacher-forced argmax past the margin")
    return dict(decided=total - under, under_margin=under, rejections=rej_total, rejections_decided=rej_over)


#: the least acceptance of a draft that is the target itself, every path
#: in fp32 (phase_spec_serving's fp32 twin). In bf16 the draft and the
#: target round differently, and on these random weights (top-2 margins
#: about exponential with mean ~0.2 at vocab 128256) that flips the argmax
#: at near ties: those rejections are held to the token gate's margin
#: instead (_own_draft_faults)
OWN_DRAFT_ACCEPTANCE = 0.9


def _own_draft_faults(label, draft, gate):
    """With the target's own weights as the draft (draft (b)), a rejection
    at a decided position (a top-2 margin past the token gate's) is a
    fault: only rounding at a near tie may reject such a draft."""
    if draft != "b" or not gate["rejections_decided"]:
        return []
    return [f"{label}: {gate['rejections_decided']} of {gate['rejections']} rejected drafts sit at decided positions"]


def _rejections(sess):
    """{request id: [position of each round's first rejected draft]}."""
    out = {}
    for rid, _a, _d, pos in sess.rounds:
        if pos is not None:
            out.setdefault(rid, []).append(pos)
    return out


def phase_spec_profile(torch, target, draft, prompts, label, steps=PROFILE_STEPS):
    """Where a steady spec-ragged step's time goes: 8 requests decoding with
    proposals in flight, ``steps`` step() calls per traced chunk."""
    from neuronx_distributed_inference_tpu_torch.runtime.serving import SpeculativeServingSession

    target.init_kv_cache()
    draft.init_kv_cache()
    sess = SpeculativeServingSession(target, draft, speculation_length=SPEC_K)
    for i, p in enumerate(prompts):
        # profile_chunk runs the chunk three times: room for 3 x steps full rounds
        if not sess.add_request(f"p{i}", p, max_new_tokens=SPEC_K * (3 * steps + 8)):
            raise SystemExit(f"spec profile: request {i} refused")
    for _ in range(64):
        if not sess.prefilling and sess._draft_prop is not None and (not sess.ragged_async or sess._pending is not None):
            break
        sess.step()
    else:
        raise SystemExit(f"spec profile ({label}): the session did not reach steady speculation")

    def chunk():
        for _ in range(steps):
            sess.step()
        torch.cuda.synchronize()

    prof = profile_chunk(torch, chunk, steps, f"spec-ragged serving step (8 rows, {label}, {steps} steps)")
    b3 = sum(ms for name, ms in prof["kernel_ms_per_step"].items() if any(k in name for k in B3_KERNELS))
    log(f"  B3 ({' + '.join(B3_KERNELS)}) {b3:.4f} ms/step")
    sess.run_to_completion()
    return dict(prof, b3_ms_per_step=b3)


def phase_spec_serving(torch, margin):
    """serving_1b_int8_spec_ragged at full width: the int8 1B target (the
    main path's seeded weights quantized at load) and two drafts: (a) the
    4-layer 1B-width draft (LLAMA_1B_DRAFT4), random from its own seed
    (the row's own, low acceptance), (b) the target's own params (every
    draft accepted but at near ties, where the two paths' rounding may flip
    the argmax). Each through graph_pair, 1-ahead and synchronous: graphs on
    and off give identical tokens and launch counts, nothing is captured
    after the warm pass and the seal, one mixed_step_spec dispatch per step
    (B3 launches = 16 per dispatch, B2 = the draft's layers per draft
    prefill, B1 = k x the draft's layers per chained propose, nothing
    else), no fault, the token gate, with (b) no rejected draft at a
    decided position; draft (b)'s fp32 twin accepting at least
    OWN_DRAFT_ACCEPTANCE; then the plain ragged 1-ahead drain on the same
    int8 weights, and profiles of SPEC_PROFILE_STEPS steady steps of each.
    ``margin``: the token gate's margin (from the ragged teacher-forced
    gate)."""
    from neuronx_distributed_inference_tpu_torch.models.llama import LLAMA_1B
    from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM
    from neuronx_distributed_inference_tpu_torch.telemetry import TelemetrySession

    s = SERVING
    t0 = time.perf_counter()
    base_target = ModelForCausalLM(None, _spec_target_config(graphs=False)).load(random_weights=True)
    tparams = base_target.params
    draft4 = dict(LLAMA_1B, num_hidden_layers=4)
    dparams = ModelForCausalLM(None, _spec_draft_config(False, draft4, seed=1)).load(random_weights=True).params
    del base_target
    torch.cuda.synchronize()
    log(f"spec serving: int8 target and draft weights {time.perf_counter() - t0:.2f} s")
    L = len(tparams["layers"])
    vocab = LLAMA_1B["vocab_size"]
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, vocab - 10, size=(s["prompt"],)).tolist() for _ in range(s["n_requests"])]
    drafts = {"a": (draft4, dparams), "b": (LLAMA_1B, tparams)}
    out, failures = {}, []
    for name, (dmodel, dp) in drafts.items():
        Ld = dmodel["num_hidden_layers"]
        for one_ahead in (True, False):
            label = f"spec-ragged drain, draft ({name}), {'1-ahead' if one_ahead else 'sync'}"
            state = {}

            def make(graphs, one_ahead=one_ahead, dmodel=dmodel, dp=dp):
                t = ModelForCausalLM(None, _spec_target_config(graphs, one_ahead)).load(params=tparams).warmup()
                d = ModelForCausalLM(None, _spec_draft_config(graphs, dmodel)).load(params=dp).warmup()
                return _SpecApps(t, d)

            def run(apps, label=label, Ld=Ld, state=state):
                before = all_counts()
                tel = TelemetrySession()
                sess, secs, steps = _serve_spec(torch, apps.target, apps.draft, prompts, s["gen"], tel)
                after = all_counts()
                counts = {k: after[k] - before[k] for k in after}
                _spec_checks(sess, tel, s["gen"], len(prompts), vocab, label)
                d = sess.dispatches
                want = expect_launches(
                    ragged_paged_attention=d["mixed_step_spec"] * L, flash_attention=d["prefill_draft"] * Ld,
                    decode_attention=d["draft_chain"] * SPEC_K * Ld,
                )
                if counts != want or not want["ragged_paged_attention"]:
                    raise SystemExit(f"{label}: launches {counts} != {want}, dispatches {dict(d)}")
                if set(d) - {"mixed_step_spec", "draft_chain", "prefill_draft"}:
                    raise SystemExit(f"{label}: dispatches other than the spec step's: {dict(d)}")
                if tel.steps["mixed"] != d["mixed_step_spec"] or d["mixed_step_spec"] > steps:
                    raise SystemExit(f"{label}: {d['mixed_step_spec']} mixed dispatches in {steps} steps")
                state.update(sess=sess, tel=tel, secs=secs, steps=steps, counts=counts)
                return {rid: list(r.generated) for rid, r in sess.requests.items()}

            def prof(apps, _tokens, label=label):
                return phase_spec_profile(torch, apps.target, apps.draft, prompts, label, steps=SPEC_PROFILE_STEPS)

            res = graph_pair(torch, label, make, run, prof if one_ahead else None, warm_pass=True, profile_off=False)
            sess, tel = state["sess"], state["tel"]
            rate, bench_rate, per_round, rounds = spec_acceptance(sess, tel)
            tokens = {rid: list(r.generated) for rid, r in sess.requests.items()}
            n_tok = sum(len(v) for v in tokens.values())
            d = sess.dispatches
            log(f"  {label}, graphs on: {state['steps']} steps, {d['mixed_step_spec']} mixed_step_spec dispatches, "
                f"{d['draft_chain']} chained draft proposes, {d['prefill_draft']} draft prefills; acceptance "
                f"{rate:.4f} over {rounds} verify rounds (the bench's rule over committed tokens: "
                f"{bench_rate:.4f}), {per_round:.3f} tokens committed per verify round; "
                f"aggregate {n_tok / state['secs']:.1f} tok/s (one run); launches {state['counts']}")
            gate = spec_token_gate(torch, ModelForCausalLM(None, _spec_target_config()), tparams, prompts, tokens,
                                   margin, label, _rejections(sess))
            failures += _own_draft_faults(label, name, gate)
            out[(name, one_ahead)] = dict(
                res[True], acceptance=rate, per_round=per_round, rounds=rounds, tok_s=n_tok / state["secs"],
                steps=state["steps"], dispatches=dict(d), gate=gate, spec_launches=state["counts"],
            )

    # the fp32 twin of draft (b): every path in fp32 (int8 weights quantized
    # from the same seeded fp32 draws), sync, graphs on: with no rounding
    # apart, a draft that is the target must be accepted
    t32 = ModelForCausalLM(None, _spec_target_config(True, False, dtype="float32")).load(random_weights=True).warmup()
    d32 = ModelForCausalLM(None, _spec_draft_config(dtype="float32")).load(params=t32.params).warmup()
    _serve_spec(torch, t32, d32, prompts, s["gen"], TelemetrySession())  # warm pass: first-use captures
    tel = TelemetrySession()
    sess32, _secs, _steps = _serve_spec(torch, t32, d32, prompts, s["gen"], tel)
    rate32, _b, per_round32, rounds32 = spec_acceptance(sess32, tel)
    log(f"spec-ragged drain, draft (b), sync, fp32 twin: acceptance {rate32:.4f} over {rounds32} verify rounds, "
        f"{per_round32:.3f} tokens committed per round")
    if rate32 is None or rate32 < OWN_DRAFT_ACCEPTANCE:
        failures.append(f"the fp32 twin's acceptance {rate32} with the target as its own draft "
                        f"(want >= {OWN_DRAFT_ACCEPTANCE})")
    del t32, d32, sess32

    # the plain ragged 1-ahead drain of the same requests on the same weights
    app = ModelForCausalLM(None, _serving_config(
        serving_ragged=True, serving_ragged_async=True, weight_dtype="int8", fused_qkv=False,
    )).load(params=tparams).warmup()
    _serve(torch, app, prompts, s["gen"], TelemetrySession())  # warm pass
    sess, secs = _serve(torch, app, prompts, s["gen"], TelemetrySession())
    n_tok = sum(len(r.generated) for r in sess.requests.values())
    log(f"plain ragged 1-ahead drain, int8, same requests: {secs * 1e3:.1f} ms, aggregate {n_tok / secs:.1f} tok/s "
        f"(one run), {sess.dispatches['mixed_step']} mixed dispatches")
    plain_prof = phase_ragged_profile(torch, app, prompts, "int8 plain 1-ahead")
    del app, sess
    for key, r in out.items():
        if key[1]:
            log(f"spec-ragged vs plain ragged, 1-ahead, int8, graphs on: draft ({key[0]}) host "
                f"{r['decode_step_ms']:.3f} vs {plain_prof['decode_step_ms']:.3f} ms/step, device busy "
                f"{r['device_busy_ms']:.3f} vs {plain_prof['device_busy_ms']:.3f} ms/step, kernels/step "
                f"{r['kernels_per_step']:.0f} vs {plain_prof['kernels_per_step']:.0f}, cudaGraphLaunch "
                f"{r['launch_api']['cudaGraphLaunch'][0]:.3f} vs {plain_prof['launch_api']['cudaGraphLaunch'][0]:.3f} "
                f"ms/step; acceptance {r['acceptance']:.4f}, {r['per_round']:.3f} tokens per verify round; "
                f"aggregate {r['tok_s']:.1f} vs {n_tok / secs:.1f} tok/s (one run each)")
    if failures:
        raise SystemExit("spec serving: " + "; ".join(failures))
    return dict(runs=out, tparams=tparams, prompts=prompts, plain_tok_s=n_tok / secs,
                launches={"ragged_paged_attention_spec": out[("a", True)]["spec_launches"]["ragged_paged_attention"]})


def phase_split_spec(torch, tparams, prompts, margin):
    """The same requests through SpeculativeServingSession's split path on
    the contiguous cache (target batch 8, seq 1024, CTE and TKG buckets
    [1024], int8) with draft (b), the target's params: a warm pass, then the
    measured drain: B1 with K = 4 for the target's verify (one launch a
    layer per speculate dispatch) and K = 1 for the draft's k steps, B2
    for both prefills, nothing else; the token gate and the own-draft
    checks (_own_draft_faults)."""
    from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM
    from neuronx_distributed_inference_tpu_torch.telemetry import TelemetrySession

    s = SERVING
    L = len(tparams["layers"])
    target = ModelForCausalLM(None, _spec_draft_config()).load(params=tparams).warmup()
    draft = ModelForCausalLM(None, _spec_draft_config()).load(params=tparams).warmup()
    _serve_spec(torch, target, draft, prompts, s["gen"], TelemetrySession())  # warm pass: first-use captures
    before = all_counts()
    tel = TelemetrySession()
    sess, secs, steps = _serve_spec(torch, target, draft, prompts, s["gen"], tel)
    after = all_counts()
    counts = {k: after[k] - before[k] for k in after}
    _spec_checks(sess, tel, s["gen"], len(prompts), target.spec.vocab_size, "split spec drain")
    d = sess.dispatches
    want = expect_launches(
        flash_attention=(d["prefill"] + d["prefill_draft"]) * L,
        decode_attention=d["speculate"] * L * SPEC_K + d["decode_steps"] * L,
        decode_attention_verify=d["speculate"] * L,
    )
    if counts != want or not d["speculate"]:
        raise SystemExit(f"split spec drain: launches {counts} != {want}, dispatches {dict(d)}")
    rate, bench_rate, per_round, rounds = spec_acceptance(sess, tel)
    tokens = {rid: list(r.generated) for rid, r in sess.requests.items()}
    n_tok = sum(len(v) for v in tokens.values())
    verify = counts["decode_attention_verify"]
    log(f"split spec drain (contiguous, int8, draft (b)): {secs * 1e3:.1f} ms, aggregate {n_tok / secs:.1f} tok/s "
        f"(one run), {steps} steps, dispatches {dict(d)}; B1 K={SPEC_K} verify launches {verify} beside "
        f"{counts['decode_attention']} B1 K=1 launches; acceptance {rate:.4f} over {rounds} rounds (the bench's rule: "
        f"{bench_rate:.4f}), {per_round:.3f} tokens committed per round")
    gate = spec_token_gate(torch, target, tparams, prompts, tokens, margin, "split spec drain", _rejections(sess))
    failures = _own_draft_faults("split spec drain", "b", gate)
    if failures:
        raise SystemExit("; ".join(failures))
    del target, draft
    return dict(launches={"decode_attention_verify": verify}, tok_s=n_tok / secs, acceptance=rate, gate=gate)


def phase_fused_spec(torch, params, margin):
    """FusedSpecModelForCausalLM with the 1B target (the main path's bf16
    weights) and draft (a), the 4-layer draft random from its own seed, or
    (b), the target itself: batch 1, a 128-token prompt, 128 new tokens,
    greedy, a warm generate() then a measured one; exact B2 / B1 counts,
    the token gate; with (b) no draft rejected at a decided position and
    acceptance of at least OWN_DRAFT_ACCEPTANCE (the share of rounds
    accepted in full printed); tok/s beside plain generate() (one run
    each)."""
    from neuronx_distributed_inference_tpu_torch.config import FusedSpecConfig
    from neuronx_distributed_inference_tpu_torch.models.llama import LLAMA_1B
    from neuronx_distributed_inference_tpu_torch.ops import _cuda
    from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM
    from neuronx_distributed_inference_tpu_torch.runtime.fused_spec import FusedSpecModelForCausalLM

    prompt_len, n_new = 128, 128
    L = len(params["layers"])
    prompt = np.random.RandomState(0).randint(0, LLAMA_1B["vocab_size"], size=(1, prompt_len))
    plain = ModelForCausalLM(None, _config(1)).load(params=params).warmup()
    plain.generate(prompt, max_new_tokens=n_new)
    t0 = time.perf_counter()
    ref = plain.generate(prompt, max_new_tokens=n_new).sequences
    plain_s = time.perf_counter() - t0
    del plain
    out, failures = {}, []
    for name, draft_model in (("a", dict(LLAMA_1B, num_hidden_layers=4)), ("b", LLAMA_1B)):
        cfg = _config(1, speculation_length=SPEC_K, enable_fused_speculation=True)
        cfg.fused_spec_config = FusedSpecConfig(draft_config=_config(1, model=draft_model, seed=1))
        app = FusedSpecModelForCausalLM(None, cfg)
        if name == "a":
            app.load(target_params=params, random_weights=True)
        else:
            app.load(target_params=params, draft_params=params)
        Ld = draft_model["num_hidden_layers"]
        counts = []
        call = app._call

        def counted(prog, phase, arrs, bucket, fn, call=call, counts=counts):
            tokens, c = call(prog, phase, arrs, bucket, fn)
            if phase == "tkg":
                counts.append(c.cpu().numpy())
            return tokens, c

        app._call = counted
        app.generate(prompt, max_new_tokens=n_new)  # warm: first-use captures
        app.seal()
        counts.clear()
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        got = app.generate(prompt, max_new_tokens=n_new).sequences
        secs = time.perf_counter() - t0
        launches = all_counts()
        rounds = len(counts)
        want = expect_launches(
            flash_attention=L + Ld, decode_attention=rounds * SPEC_K * Ld, decode_attention_verify=rounds * L
        )
        if launches != want:
            raise SystemExit(f"fused spec ({name}): launches {launches} != {want}")
        c = np.concatenate(counts)
        # every round but the last, which the budget may cut, commits its count
        full = float((c[:-1] == SPEC_K).mean()) if rounds > 1 else 1.0
        gen = got[0, prompt_len:]
        same = int((gen == ref[0, prompt_len:]).sum())
        log(f"fused spec generate, draft ({name}), batch 1, {prompt_len} + {n_new} tokens: {secs * 1e3:.1f} ms, "
            f"{n_new / secs:.1f} tok/s beside plain generate() {n_new / plain_s:.1f} tok/s (generate() wall time, "
            f"prefill included, one run each); {rounds} rounds, mean count {c.mean():.3f}, share of full rounds {full:.3f}; tokens equal to "
            f"plain generate()'s at {same} of {n_new} positions (not a gate); launches {launches}")
        rejections, pos = [], prompt_len  # pos: the position of each round's last token
        for cnt in c.tolist():
            if cnt < SPEC_K:
                rejections.append(pos + cnt)
            pos += cnt
        gate = spec_token_gate(torch, ModelForCausalLM(None, _config(1)), params, [prompt[0].tolist()],
                               {"0": gen.tolist()}, margin, f"fused spec ({name})", {"0": rejections})
        failures += _own_draft_faults(f"fused spec ({name})", name, gate)
        out[name] = dict(tok_s=n_new / secs, rounds=rounds, full=full, gate=gate, launches=launches)
        del app
    out["plain_tok_s"] = n_new / plain_s
    if failures:
        raise SystemExit("; ".join(failures))
    return out


# ---------------------------------------------------------------------------
# 14. the multi-replica front-end (ROADMAP A8's first part)
# ---------------------------------------------------------------------------

#: bench.py::measure_router's drain (:581-700) on the rows' configuration
#: (bench.py:990-991, 1105-1160): 2 replicas sharing the card, least_loaded,
#: 8 requests of 128 + 128 tokens; the elastic row retires the highest-id
#: replica at router step 2
ROUTER = dict(replicas=2, policy="least_loaded", retire_step=2)
#: steady router steps of each profiled window
ROUTER_PROFILE_STEPS = 8


def _router_config(paged, stage=None, **kw):
    """A replica app of the router rows: the serving_1b_int8 row's int8
    Llama-3.2-1B at full width and depth (fused QKV off, as the bench builds
    int8 apps), 8 slots, seq 1024, CTE and TKG buckets [1024], seed 0; the
    router, threaded and elastic rows over the paged pool of 512 blocks of
    32 with chunked prefill, the disaggregated row over the contiguous cache
    (bench.py:1306-1341: 9 lines of 1024, a context batch of 1), its prefill
    stage with ``is_prefill_stage=True``."""
    if paged:
        return _serving_config(weight_dtype="int8", fused_qkv=False, **kw)
    s = SERVING
    return _config(
        s["slots"], is_continuous_batching=True, ctx_batch_size=1, context_encoding_buckets=[s["seq"]],
        token_generation_buckets=[s["seq"]], weight_dtype="int8", fused_qkv=False, is_prefill_stage=stage, **kw,
    )


def _router_apps(torch, paged, n, stage=None):
    """``n`` warm apps, each with its own copy of the seed-0 int8 weights,
    every runner sealed: a later capture raises RetraceError (a capture
    fails while another replica's thread launches work)."""
    from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM

    apps = []
    for _ in range(n):
        app = ModelForCausalLM(None, _router_config(paged, stage)).load(random_weights=True).warmup()
        apps.append(app)
    return apps


def _seal(apps):
    for app in apps:
        for runner in app._all_runners():
            runner.seal()


def _route(torch, apps, prompts, gen, threaded=False, tier_apps=(), elastic=False, profile_at=None):
    """One drain of measure_router's traffic through a ServingRouter: 2
    requests up front, one more after each router step, until every request
    ends; ``elastic`` retires the highest-id replica at ROUTER's step and
    re-joins a fresh session over the same app once its drain finalizes.
    With ``profile_at``, router steps [profile_at, profile_at +
    ROUTER_PROFILE_STEPS) run
    under torch.profiler (host ms and the device's busy share of them).
    Returns the drain's record."""
    import threading

    from neuronx_distributed_inference_tpu_torch.ops import _cuda
    from neuronx_distributed_inference_tpu_torch.runtime.replica import PrefillReplicaHandle
    from neuronx_distributed_inference_tpu_torch.runtime.router import ServingRouter
    from neuronx_distributed_inference_tpu_torch.runtime.serving import ServingSession
    from neuronx_distributed_inference_tpu_torch.telemetry import TelemetrySession

    threads_before = threading.active_count()
    for app in (*apps, *tier_apps):
        app.init_kv_cache()
    torch.cuda.synchronize()
    tel = TelemetrySession()
    base = tel.registry.snapshot()
    tier = [PrefillReplicaHandle(app, i) for i, app in enumerate(tier_apps)]
    sessions = [ServingSession(app, telemetry=tel) for app in apps]
    all_sessions = list(sessions)
    rec = dict(profile=None, retired=0, added=0)
    _cuda.reset_launch_counts()
    step_ms, prof = [], None
    t0 = time.perf_counter()
    with ServingRouter(sessions, policy=ROUTER["policy"], telemetry=tel, prefill_replicas=tier, threaded=threaded) as router:
        nxt = steps = 0
        retired_id = None
        for _ in range(2):
            if not router.add_request(str(nxt), prompts[nxt], max_new_tokens=gen):
                raise SystemExit(f"router: request {nxt} refused")
            nxt += 1
        while True:
            if profile_at is not None and steps == profile_at:
                prof = _start_profile(torch)
                t_prof = time.perf_counter()
            ts = time.perf_counter()
            router.step()
            step_ms.append((time.perf_counter() - ts) * 1e3)
            steps += 1
            if prof is not None and steps == profile_at + ROUTER_PROFILE_STEPS:
                torch.cuda.synchronize()
                rec["profile"] = _stop_profile(torch, prof, time.perf_counter() - t_prof, ROUTER_PROFILE_STEPS)
                prof = None
            if elastic:
                if retired_id is None and steps >= ROUTER["retire_step"]:
                    retired_id = max(router.replicas, key=lambda h: h.replica_id).replica_id
                    router.retire_replica(retired_id, drain=True)
                    rec["retired"] += 1
                elif retired_id is not None and not rec["added"] and all(
                    h.replica_id != retired_id for h in router.replicas
                ):
                    sess = ServingSession(apps[-1], telemetry=tel)
                    all_sessions.append(sess)
                    router.add_replica(sess)
                    rec["added"] += 1
            if nxt < len(prompts):
                if not router.add_request(str(nxt), prompts[nxt], max_new_tokens=gen):
                    raise SystemExit(f"router: request {nxt} refused")
                nxt += 1
                continue
            if not router.has_live_work:
                break
        torch.cuda.synchronize()
        if prof is not None:  # the drain ended inside the window
            rec["profile"] = _stop_profile(torch, prof, time.perf_counter() - t_prof, steps - profile_at)
        rec["secs"] = time.perf_counter() - t0
        rec["launches"] = all_counts()
        rec["tokens"] = {rid: list(r.tokens) for rid, r in router.requests.items()}
        rec["status"] = {rid: r.status for rid, r in router.requests.items()}
        rec["per_replica"] = [h.tokens_served for h in router.replicas]
        rec["handoffs"] = sum(p.handoffs for p in router.prefill_replicas)
        rec["steps"] = steps
    rec["leaked_threads"] = threading.active_count() - threads_before
    rec["leaked_blocks"] = sum(len(s.allocator.seq_blocks) for s in all_sessions if s.allocator is not None)
    rec["dispatches"] = {k: sum(s.dispatches[k] for s in all_sessions) for k in ("prefill", "prefill_chunk", "decode_steps")}
    rec["step_ms"] = step_ms
    snap = tel.registry.snapshot()
    tel.close()

    def total(s, name, key="value"):
        fam = s.get(name)
        return float(sum(smp[key] for smp in fam["samples"])) if fam else 0.0

    def delta(name, key="value"):
        return total(snap, name, key) - total(base, name, key)

    replica_ms, phase_ms = delta("nxdi_replica_step_ms", "sum"), delta("nxdi_router_step_ms", "sum")
    rec["overlap_frac"] = max(0.0, 1.0 - phase_ms / replica_ms) if replica_ms > 0 else None
    rec["faults"] = dict(
        rejected=delta("nxdi_router_rejected_total") + delta("nxdi_requests_rejected_total"),
        failover=delta("nxdi_router_failovers_total"), readmitted=delta("nxdi_requests_preempted_total"),
        quarantined=delta("nxdi_rows_quarantined_total"), handoff_failures=delta("nxdi_handoff_failures_total"),
        handoff_local_prefill=delta("nxdi_handoff_local_prefill_total"),
    )
    rec["elastic_events"] = {s_["labels"]["event"]: s_["value"] for s_ in snap.get("nxdi_router_elastic_total", {"samples": []})["samples"]}
    rec["handoff_ms"] = (delta("nxdi_handoff_ms", "sum"), delta("nxdi_handoff_ms", "count"))
    return rec


def _start_profile(torch):
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def _stop_profile(torch, prof, wall_s, steps):
    """Host ms per router step and the device's busy share (the union of
    every kernel's interval, on every replica's stream) of the window, and
    the host ms per router step inside the CUDA runtime's graph launches
    and its synchronizing calls (summed over the replicas' threads)."""
    prof.__exit__(None, None, None)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = union_ms((e.time_range.start, e.time_range.end) for e in kernels)
    averages = prof.key_averages()

    def api_ms(pred):
        return sum(e.self_cpu_time_total for e in averages if pred(e.key)) / 1e3 / steps

    return dict(
        host_ms=wall_s * 1e3 / steps, device_busy_ms=busy_ms / steps, busy_frac=busy_ms / (wall_s * 1e3),
        kernels=len(kernels) / steps, graph_launch_ms=api_ms(lambda k: k.startswith("cudaGraphLaunch")),
        sync_ms=api_ms(lambda k: k.startswith("cuda") and "Synchronize" in k),
    )


def _check_router_run(label, rec, n_requests, gen, vocab, want):
    """The row's gates: every request finished with its whole budget, in
    the vocab; 0/0/0 rejected / failover / re-admitted and no quarantine;
    the kernels counted are the dispatches times the layers."""
    counts = sorted(len(v) for v in rec["tokens"].values())
    if counts != [gen] * n_requests or any(s != "finished" for s in rec["status"].values()):
        raise SystemExit(f"{label}: not every request finished its budget: {counts} {rec['status']}")
    for rid, toks in rec["tokens"].items():
        if min(toks) < 0 or max(toks) >= vocab:
            raise SystemExit(f"{label}: request {rid} has tokens outside the vocab")
    f = rec["faults"]
    if f["rejected"] or f["failover"] or f["readmitted"] or f["quarantined"]:
        raise SystemExit(f"{label}: containment events on clean traffic: {f}")
    if rec["launches"] != want or not any(want.values()):
        raise SystemExit(f"{label}: launches {rec['launches']} != expected {want}, dispatches {rec['dispatches']}")


def _router_line(label, rec):
    n = len(rec["per_replica"])
    total = sum(len(v) for v in rec["tokens"].values())
    even = total / n if n else 0
    rec["tok_s"] = total / rec["secs"]
    rec["balance_frac"] = min(rec["per_replica"]) / even if even else None
    steps = np.array(rec["step_ms"])
    p = rec["profile"]
    prof = (
        f"profiled {ROUTER_PROFILE_STEPS} steady steps: host {p['host_ms']:.3f} ms/step, device busy "
        f"{p['device_busy_ms']:.3f} ms/step ({p['busy_frac']:.3f}), {p['kernels']:.0f} kernels/step, "
        f"cudaGraphLaunch {p['graph_launch_ms']:.3f} and synchronizing calls {p['sync_ms']:.3f} host ms/step"
        if p else "not profiled"
    )
    overlap = "None" if rec["overlap_frac"] is None else f"{rec['overlap_frac']:.4f}"
    log(
        f"{label}: {rec['secs'] * 1e3:.1f} ms, aggregate {rec['tok_s']:.1f} tok/s, {rec['steps']} router steps, "
        f"host ms/router step mean {steps.mean():.3f} p50 {np.median(steps):.3f}; {prof}; "
        f"router_step_overlap_frac {overlap}; per replica tokens {rec['per_replica']}, "
        f"balance_frac {rec['balance_frac']:.4f}; dispatches {rec['dispatches']}; faults {rec['faults']}"
    )


def router_kernel_times(torch, fa, da):
    """B1 and B2b at the disaggregated row's shapes (decode: 8 rows at
    bucket 1024; prefill: batch 1, one 128-token prompt in the 1024
    bucket), each held to its plain version first, then timed beside the
    plain version, SDPA and the bound. B4 and B5 run at the serving row's
    shapes, timed by phase_paged_times."""
    import torch.nn.functional as F

    rows = {}
    rng = np.random.RandomState(16)
    Hq, Hkv, D, L, S = 32, 8, 64, 16, SERVING["seq"]
    prompt = SERVING["prompt"]
    q, k, v = fused_qkv_inputs(torch, rng, 1, S, Hq, Hkv, D, torch.bfloat16)
    key_valid = (torch.arange(S, device="cuda")[None, :] < prompt).to(torch.int32)
    kw = dict(scale=D ** -0.5, causal=True, softmax_bf16=False, window=None, chunk=None)
    err = check_flash(torch, fa, q, k, v, key_valid, kw, f"router prefill B=1 S={S} valid={prompt} D=64 bf16")
    mask = fa.prefill_mask(key_valid, True, None, None)
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2).repeat_interleave(Hq // Hkv, dim=1)
    vt = v.transpose(1, 2).repeat_interleave(Hq // Hkv, dim=1)
    ms = time_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, key_valid, **kw))
    plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v, key_valid, **kw))
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
    b_ms, b_by = bound(*flash_work(q, k, key_valid, mask))
    rows[("flash_attention", "router")] = dict(
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err
    )
    log(
        f"flash_attention router prefill B=1 S={S} valid={prompt} Hq=32 Hkv=8 D=64 bf16: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), err vs plain {err:.3e}"
    )
    B = SERVING["slots"]
    valid = [prompt + 64 + 8 * i for i in range(B)]  # mid-drain depths
    q, kc, vc, mask = _decode_inputs(torch, rng, B, 1, Hq, Hkv, D, L, S, S, torch.bfloat16, valid)
    kw = dict(scale=D ** -0.5, n_kv=Hkv)
    state = {"layer": 0}

    def next_layer():
        state["layer"] = (state["layer"] + 1) % L
        return state["layer"]

    err = check_decode(torch, da, q, kc, vc, 0, mask, None, kw, f"router decode B={B} K=1 bucket={S} D=64 bf16")
    log_split(torch, da, B, Hkv, S)
    qt = q.transpose(1, 2)
    kt = kc[0, :B, :S].permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, dim=1)
    vt = vc[0, :B, :S].permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, dim=1)
    ms = time_ms(torch, lambda: da.tkg_decode_attention(q, kc, vc, next_layer(), mask, None, **kw))
    plain_ms = time_ms(torch, lambda: da.tkg_decode_attention_plain(q, kc, vc, next_layer(), mask, None, **kw))
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
    b_ms, b_by = bound(*decode_work(q, kc, mask))
    rows[("decode_attention", "router")] = dict(
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err
    )
    log(
        f"tkg_decode_attention router decode B={B} K=1 bucket={S} valid {valid[0]}..{valid[-1]} Hq=32 Hkv=8 D=64 "
        f"bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), "
        f"err vs plain {err:.3e}"
    )
    del kc, vc
    return rows


def _handoff_cost(torch, pre, dec, n=20):
    """One request's hand-off on the card outside the drain: extract the
    prefill stage's populated line 0 (the last prompt's 128 positions) and
    inject it into the decode app's line 0. Host-clock ms per hand-off
    (median of ``n``, each ended by a synchronize) and the device ms of the
    two steps (CUDA events), and the payload's bytes."""
    from neuronx_distributed_inference_tpu_torch.runtime.disaggregated import extract_request_kv, inject_request_kv

    seq0 = np.zeros((1,), np.int32)
    S = SERVING["prompt"]

    def once():
        kv = extract_request_kv(pre, seq0, upto=S)
        inject_request_kv(dec, seq0, kv)
        return kv

    kv = once()
    torch.cuda.synchronize()
    nbytes = sum(kv[k].numel() * kv[k].element_size() for k in ("k", "v", "k_scale", "v_scale") if k in kv)
    host = []
    for _ in range(n):
        t0 = time.perf_counter()
        once()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        once()
    end.record()
    torch.cuda.synchronize()
    return dict(host_ms=float(np.median(host)), device_ms=start.elapsed_time(end) / n, bytes=nbytes)


def phase_router(torch, fa, da):
    """The router rows at full width (bench.py::measure_router): the
    sequential router, the threaded router, the elastic fleet (paged, split
    path: B5 prefill chunks, B4 decode) and the disaggregated row (a
    prefill stage and two contiguous decode replicas: B2b prefill, B1
    decode), then the same disaggregated traffic with the tier off. Every
    app is warmed, one drain of each kind warms the rest, and every runner
    is sealed before the measured drains. Gates: every request finishes its
    budget; rejected / failover / re-admitted 0/0/0; sequential and threaded
    tokens identical; 8 hand-offs with no failure and no local prefill,
    tokens equal to the tier-off drain's; elastic attainment 1.0 with one
    retire and one add, no KV block or thread leaked; no graph captured
    after the seal; the kernels counted equal the dispatches times the
    layers. Prints each drain's tok/s, host ms and device-busy share per
    router step, the overlap, tokens and balance per replica, and the
    hand-off's ms and bytes."""
    from neuronx_distributed_inference_tpu_torch.analysis.retrace_guard import RetraceGuard
    from neuronx_distributed_inference_tpu_torch.models.llama import LLAMA_1B

    s = SERVING
    vocab, L = LLAMA_1B["vocab_size"], LLAMA_1B["num_hidden_layers"]
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, vocab - 10, size=(s["prompt"],)).tolist() for _ in range(s["n_requests"])]
    out = dict(times=router_kernel_times(torch, fa, da))
    at = 12  # every request placed and prefilled: steady decode

    t0 = time.perf_counter()
    apps = _router_apps(torch, True, ROUTER["replicas"])
    torch.cuda.synchronize()
    log(f"router: 2 paged int8 apps loaded and warmed {time.perf_counter() - t0:.2f} s")
    _route(torch, apps, prompts, s["gen"])  # warm pass: first-call costs
    _seal(apps)
    captures = sum(a.graphs.captures for a in apps)
    runs = {}
    with RetraceGuard():
        for label, kw in (
            ("router", {}), ("router_threaded", dict(threaded=True)), ("elastic", dict(elastic=True)),
        ):
            runs[label] = _route(torch, apps, prompts, s["gen"], **kw)
            d = runs[label]["dispatches"]
            want = expect_launches(
                paged_flash_attention=d["prefill_chunk"] * L, paged_decode_attention=d["decode_steps"] * L
            )
            _check_router_run(label, runs[label], len(prompts), s["gen"], vocab, want)
        for label, kw in (("router", {}), ("router_threaded", dict(threaded=True))):
            runs[label]["profile"] = _route(torch, apps, prompts, s["gen"], profile_at=at, **kw)["profile"]
    if sum(a.graphs.captures for a in apps) != captures:
        raise SystemExit("router: a graph was captured after the seal")
    if runs["router_threaded"]["tokens"] != runs["router"]["tokens"]:
        raise SystemExit("router: the threaded drain's tokens differ from the sequential drain's")
    e = runs["elastic"]
    attainment = sum(st == "finished" for st in e["status"].values()) / len(prompts)
    if (attainment, e["retired"], e["added"], e["leaked_blocks"], e["leaked_threads"]) != (1.0, 1, 1, 0, 0) or e[
        "elastic_events"
    ] != {"retire": 1.0, "retire_done": 1.0, "add": 1.0}:
        raise SystemExit(
            f"elastic: attainment {attainment}, retired {e['retired']}, added {e['added']}, leaked blocks "
            f"{e['leaked_blocks']}, leaked threads {e['leaked_threads']}, events {e['elastic_events']}"
        )
    for label in ("router", "router_threaded"):
        if runs[label]["leaked_blocks"] or runs[label]["leaked_threads"]:
            raise SystemExit(f"{label}: leaked {runs[label]['leaked_blocks']} blocks, {runs[label]['leaked_threads']} threads")

    t0 = time.perf_counter()
    dec = _router_apps(torch, False, ROUTER["replicas"])
    pre = _router_apps(torch, False, 1, stage=True)
    torch.cuda.synchronize()
    log(f"router: 2 contiguous int8 decode apps and 1 prefill stage loaded and warmed {time.perf_counter() - t0:.2f} s")
    _route(torch, dec, prompts, s["gen"], tier_apps=pre)  # warm pass
    _seal(dec + pre)
    captures = sum(a.graphs.captures for a in dec + pre)
    with RetraceGuard():
        for label, tier in (("disagg", pre), ("disagg_tier_off", ())):
            runs[label] = _route(torch, dec, prompts, s["gen"], tier_apps=tier)
            d = runs[label]["dispatches"]
            want = expect_launches(
                flash_attention=(d["prefill"] + runs[label]["handoffs"]) * L, decode_attention=d["decode_steps"] * L
            )
            _check_router_run(label, runs[label], len(prompts), s["gen"], vocab, want)
        runs["disagg"]["profile"] = _route(torch, dec, prompts, s["gen"], tier_apps=pre, profile_at=at)["profile"]
    if sum(a.graphs.captures for a in dec + pre) != captures:
        raise SystemExit("disagg: a graph was captured after the seal")
    g = runs["disagg"]
    if (g["handoffs"], g["faults"]["handoff_failures"], g["faults"]["handoff_local_prefill"], g["dispatches"]["prefill"]) != (
        len(prompts), 0, 0, 0
    ):
        raise SystemExit(f"disagg: hand-offs {g['handoffs']}, faults {g['faults']}, local prefills {g['dispatches']['prefill']}")
    if g["tokens"] != runs["disagg_tier_off"]["tokens"]:
        raise SystemExit("disagg: the tier's tokens differ from the tier-off drain's")
    cost = _handoff_cost(torch, pre[0], dec[0])
    for label, rec in runs.items():
        _router_line(label, rec)
    h_sum, h_n = g["handoff_ms"]
    log(
        f"disagg hand-off: {h_n:.0f} in the drain, {h_sum / max(h_n, 1):.3f} ms each (prefill + extract + inject, "
        f"host clock); extract + inject alone {cost['host_ms']:.3f} ms host clock, {cost['device_ms']:.4f} ms device, "
        f"{cost['bytes']} bytes a request"
    )
    # the warm, sealed apps serve the goodput rows next (phase_workload)
    out.update(runs=runs, handoff=cost, apps=dict(paged=apps, dec=dec, pre=pre))
    out["launches"] = {
        "flash_attention_router": runs["disagg"]["launches"]["flash_attention"],
        "decode_attention_router": runs["disagg"]["launches"]["decode_attention"],
        "paged_flash_attention_router": runs["router"]["launches"]["paged_flash_attention"],
        "paged_decode_attention_router": runs["router"]["launches"]["paged_decode_attention"],
    }
    return out


# ---------------------------------------------------------------------------
# 12. the open-loop goodput rows (workload driver, SLO scorer)
# ---------------------------------------------------------------------------

#: bench.py's hardware-scale traces of the goodput rows (bench.py:1003-1019)
#: and their setups (bench.py:1176-1205): the clean and burst rows on one
#: paged replica, the chaos row on two with a decode replica killed at step
#: 16, the disaggregated chaos row on two contiguous decode replicas and one
#: prefill stage with the kill aimed at the tier
_WL_CHAOS = dict(
    seed=14, n_requests=32, rate=2.0, arrival_kind="poisson", shared_prefix_len=32, max_prompt_len=128,
    min_output_len=64, max_output_len=128, ttft_slo_s=1e4, itl_slo_s=1e3,
)
WORKLOAD_ROWS = {
    "serving_1b_int8_goodput": dict(workload=dict(
        seed=14, n_requests=24, rate=2.0, arrival_kind="poisson", shared_prefix_len=32, max_prompt_len=128,
        min_output_len=32, max_output_len=128, ttft_slo_s=1e4, itl_slo_s=1e3,
    )),
    "serving_1b_int8_goodput_burst": dict(workload=dict(
        seed=14, n_requests=32, rate=8.0, arrival_kind="onoff", shared_prefix_len=32, max_prompt_len=128,
        min_output_len=32, max_output_len=128, ttft_slo_s=1e4, itl_slo_s=1e3,
    )),
    "serving_1b_int8_goodput_chaos": dict(workload=_WL_CHAOS, replicas=2, kill_step=16),
    "serving_1b_int8_disagg_chaos": dict(workload=_WL_CHAOS, replicas=2, kill_step=16, tier="prefill", prefill=1),
}


def measure_goodput(torch, apps, *, workload, kill_step=None, tier="decode", prefill_apps=(), bucket_steps=4):
    """One open-loop run of a seeded trace (bench.py::measure_goodput's
    fields): the workload driver on a virtual clock over one session or a
    router of ``apps`` (and the prefill tier of ``prefill_apps``), a live
    SloMonitor attached, scored by the SLO scorer. The apps come warm and
    sealed; the run's own registry gives the counter values. Returns the
    fields, the launches and the dispatches of the run."""
    from neuronx_distributed_inference_tpu_torch.ops import _cuda
    from neuronx_distributed_inference_tpu_torch.runtime.replica import PrefillReplicaHandle, ReplicaHandle
    from neuronx_distributed_inference_tpu_torch.runtime.router import ServingRouter
    from neuronx_distributed_inference_tpu_torch.runtime.serving import ServingSession
    from neuronx_distributed_inference_tpu_torch.telemetry import SloMonitor, TelemetrySession
    from neuronx_distributed_inference_tpu_torch.workload import (
        ChaosPlan,
        VirtualClock,
        WorkloadDriver,
        generate,
        score,
        standard_spec,
    )

    trace = generate(standard_spec(vocab_size=apps[0].spec.vocab_size - 10, **workload))
    chaos = ChaosPlan(kill_step=kill_step, tier=tier) if kill_step is not None else None
    for app in (*apps, *prefill_apps):
        app.init_kv_cache()
    torch.cuda.synchronize()
    vc = VirtualClock()
    tel = TelemetrySession(clock=vc.now)
    mon = SloMonitor()
    tel.attach_slo_monitor(mon)
    sessions = [ServingSession(app, telemetry=tel, clock=vc.now) for app in apps]
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    if len(apps) > 1:
        handles = [ReplicaHandle(sess, i, clock=vc.now) for i, sess in enumerate(sessions)]
        tier_handles = [PrefillReplicaHandle(app, i) for i, app in enumerate(prefill_apps)]
        with ServingRouter(handles, policy="least_loaded", telemetry=tel, clock=vc.now,
                           prefill_replicas=tier_handles) as router:
            with warnings.catch_warnings():
                # the tier's death is announced by one warning: the behaviour
                # under test
                warnings.filterwarnings("ignore", message="disaggregated prefill tier is DEAD")
                result = WorkloadDriver(router, trace, clock=vc, telemetry=tel, chaos=chaos).run()
            handoffs = sum(p.handoffs for p in router.prefill_replicas)
    else:
        result = WorkloadDriver(sessions[0], trace, clock=vc, telemetry=tel).run()
        handoffs = 0
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = all_counts()
    report = score(result, tel, bucket_steps=bucket_steps)
    snap = tel.registry.snapshot()
    tel.close()

    def total(name, exclude=()):
        fam = snap.get(name)
        return float(sum(
            smp["value"] for smp in (fam["samples"] if fam else ()) if smp["labels"].get("reason") not in exclude
        ))

    res = dict(
        decode_tok_s=report.total_tokens / total_s, goodput_tok_s=report.slo_met_tokens / total_s,
        slo_attainment=report.attainment, slo_attainment_by_tenant=report.attainment_by_tenant,
        slo_misses=report.misses_by_kind, slo_met_tokens=report.slo_met_tokens, total_tokens=report.total_tokens,
        n_requests=len(trace.arrivals), n_replicas=len(apps), virtual_steps=result.steps,
        backlog_refusals=result.backlog_refusals, goodput_series=report.series, workload_digest=trace.digest(),
        rejected=total("nxdi_requests_rejected_total", exclude=("backlog",)) + total("nxdi_router_rejected_total"),
        backlog_rejected=total("nxdi_requests_rejected_total") - total("nxdi_requests_rejected_total", ("backlog",)),
        quarantined=total("nxdi_rows_quarantined_total"), preempted=total("nxdi_requests_preempted_total"),
        wall_s=total_s,
    )
    if prefill_apps:
        res.update(
            n_prefill_replicas=len(prefill_apps), handoff_failures=total("nxdi_handoff_failures_total"),
            handoff_local_prefill=total("nxdi_handoff_local_prefill_total"),
        )
    if chaos is not None:
        dip = report.dip
        res.update(
            chaos=result.chaos, failover=total("nxdi_router_failovers_total"),
            goodput_dip_frac=dip.dip_frac if dip else None, goodput_recovery_steps=dip.recovery_steps if dip else None,
        )
    dispatches = {k: sum(s.dispatches[k] for s in sessions) for k in ("prefill", "prefill_chunk", "decode_steps")}
    burn = {s_["labels"]["window"]: s_["value"] for s_ in snap["nxdi_slo_burn_rate"]["samples"]
            if s_["labels"]["tenant"] == "_all"}
    return dict(
        res=res, launches=launches, dispatches=dispatches, handoffs=handoffs, statuses=result.statuses,
        monitor=mon.snapshot(), burn_rate=burn,
    )


def phase_workload(torch, router_apps):
    """The four open-loop goodput rows of bench.py at hardware scale on
    phase_router's int8 Llama-3.2-1B apps (warm and sealed; a capture
    raises): the clean and burst rows on one paged replica (split path: B5
    chunks, B4 decode), the chaos row on both paged replicas, the
    disaggregated chaos row on the two contiguous decode replicas and the
    prefill stage (B2b prefill, B1 decode). Prints bench.py's fields for
    each. Gates: clean slo_attainment 1.0; burst backlog refusals > 0; on
    every row 0 rejected outside the backlog and 0 quarantined; the chaos
    row's kill lands and its recovery is finite; the disaggregated row
    counts local prefills > 0 and every request finishes; nothing captured;
    the kernels counted equal the dispatches times the layers."""
    from neuronx_distributed_inference_tpu_torch.analysis.retrace_guard import RetraceGuard

    paged, dec, pre = router_apps["paged"], router_apps["dec"], router_apps["pre"]
    L = paged[0].spec.num_layers
    every = paged + dec + pre
    captures = sum(a.graphs.captures for a in every)
    rows = {}
    with RetraceGuard():
        for name, row in WORKLOAD_ROWS.items():
            n = row.get("replicas", 1)
            apps, tier = (dec[:n], pre[: row["prefill"]]) if row.get("prefill") else (paged[:n], [])
            rec = measure_goodput(
                torch, apps, workload=row["workload"], kill_step=row.get("kill_step"),
                tier=row.get("tier", "decode"), prefill_apps=tier,
            )
            r, d = rec["res"], rec["dispatches"]
            log(f"{name}: {json.dumps(r, sort_keys=True)}")
            log(
                f"  {r['wall_s']:.2f} s wall for {r['virtual_steps']} virtual steps "
                f"({r['wall_s'] * 1e3 / r['virtual_steps']:.2f} ms a step); dispatches {d}, hand-offs "
                f"{rec['handoffs']}, launches {rec['launches']}; live SloMonitor: {rec['monitor']['met']} of "
                f"{rec['monitor']['judged']} judged met, burn rate by window {rec['burn_rate']}"
            )
            if tier:
                want = expect_launches(
                    flash_attention=(d["prefill"] + rec["handoffs"]) * L, decode_attention=d["decode_steps"] * L
                )
            else:
                want = expect_launches(
                    paged_flash_attention=d["prefill_chunk"] * L, paged_decode_attention=d["decode_steps"] * L
                )
            if rec["launches"] != want:
                raise SystemExit(f"{name}: launches {rec['launches']} != expected {want}")
            if r["rejected"] or r["quarantined"]:
                raise SystemExit(f"{name}: {r['rejected']} rejected outside the backlog, {r['quarantined']} quarantined")
            rows[name] = rec
    if sum(a.graphs.captures for a in every) != captures:
        raise SystemExit("workload: a graph was captured after the seal")
    clean, burst = rows["serving_1b_int8_goodput"]["res"], rows["serving_1b_int8_goodput_burst"]["res"]
    if clean["slo_attainment"] != 1.0:
        raise SystemExit(f"serving_1b_int8_goodput: slo_attainment {clean['slo_attainment']} != 1.0")
    if burst["backlog_refusals"] <= 0:
        raise SystemExit("serving_1b_int8_goodput_burst: no backlog refusal: the burst never overran the slots")
    chaos = rows["serving_1b_int8_goodput_chaos"]["res"]
    if "replica" not in (chaos["chaos"] or {}) or chaos["goodput_recovery_steps"] is None:
        raise SystemExit(
            f"serving_1b_int8_goodput_chaos: kill {chaos['chaos']}, recovery {chaos['goodput_recovery_steps']}"
        )
    disagg = rows["serving_1b_int8_disagg_chaos"]
    if disagg["res"]["handoff_local_prefill"] <= 0 or any(s != "finished" for s in disagg["statuses"].values()):
        raise SystemExit(
            f"serving_1b_int8_disagg_chaos: local prefills {disagg['res']['handoff_local_prefill']}, statuses "
            f"{sorted(set(disagg['statuses'].values()))}"
        )
    return {name: rec["res"] for name, rec in rows.items()}


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
    from neuronx_distributed_inference_tpu_torch.ops import decode_block as db
    from neuronx_distributed_inference_tpu_torch.ops import flash_attention as fa
    from neuronx_distributed_inference_tpu_torch.ops import moe_decode as md
    from neuronx_distributed_inference_tpu_torch.ops import paged_flash_attention as pf
    from neuronx_distributed_inference_tpu_torch.ops import quant_matmul as qmm
    from neuronx_distributed_inference_tpu_torch.ops import ragged_paged_attention as rp

    reports = timed("build", _cuda.build)
    for name, rep_ in reports.items():
        log(f"--- {name} ptxas ---\n{rep_}")
    for name in ("flash_attention", "decode_attention", "paged_flash_attention", "quant_matmul"):  # B2, B1/B4, B5, B6
        for kernel, regs in ptxas_summary(reports[name]).items():
            log(f"registers {name}: {kernel}: {regs}")

    timed("flash parity", phase_flash_parity, torch, fa)
    timed("decode parity", phase_decode_parity, torch, da)
    timed("decode split parity", phase_decode_split_parity, torch, da)
    timed("flash layout parity", phase_flash_layout_parity, torch, fa)
    timed("paged decode parity", phase_paged_decode_parity, torch, da)
    timed("paged flash parity", phase_paged_flash_parity, torch, pf)
    timed("ragged parity", phase_ragged_parity, torch, rp)
    times = timed("times", phase_times, torch, fa, da)
    times.update(timed("paged times", phase_paged_times, torch, da, pf))
    times.update(timed("ragged times", phase_ragged_times, torch, rp))
    times.update(timed("qwen3 shape times", phase_qwen3_shape_times, torch, da, pf, rp))
    timed("quant_matmul parity", phase_quant_matmul_parity, torch, qmm)
    times.update(timed("quant_matmul times", phase_quant_matmul_times, torch, qmm))
    timed("moe_decode parity", phase_moe_parity, torch, md)
    times.update(timed("moe_decode times", phase_moe_times, torch, md))
    timed("fused block parity", phase_fused_parity, torch, db)
    times.update(timed("fused block times", phase_fused_times, torch, db))
    main_path = timed("main path", phase_main_path, torch)
    params = main_path.pop("params")
    serving = timed("serving", phase_serving, torch, params)
    ragged = timed("ragged serving", phase_ragged_serving, torch, params, serving["tokens"])
    timed("spec parity", phase_spec_parity, torch, da, rp)
    times.update(timed("spec times", phase_spec_times, torch, da))
    margin = 2 * ragged["forced"]["kernel_vs_fp32"]
    spec = timed("spec-ragged serving", phase_spec_serving, torch, margin)
    split_spec = timed("split spec serving", phase_split_spec, torch, spec.pop("tparams"), spec["prompts"], margin)
    timed("fused spec generate", phase_fused_spec, torch, params, 2 * main_path["kernel_vs_fp32"])
    router = timed("router", phase_router, torch, fa, da)
    times.update(router["times"])
    timed("workload", phase_workload, torch, router.pop("apps"))
    torch.cuda.empty_cache()
    fused = timed("fused 1B generate", phase_fused_1b, torch, params, main_path)
    graphs = timed("graphs on and off", phase_graphs, torch, params)
    timed("sampled 1B generate", phase_sampled, torch, params)
    timed("pdl under graphs", phase_pdl_graphs, torch, db)
    kvq = timed("kv quant", phase_kv_quant, torch, da, pf, rp, fa, params, main_path["forced_seq"])
    times.update(kvq["times"])
    for key in ("forced_seq", "plain_logits", "fp32_logits"):
        main_path.pop(key)
    del params
    torch.cuda.empty_cache()
    int4_8b = timed("int4 8B generate", phase_int4_8b, torch)
    timed("int8 1B generate", phase_int8_1b, torch)
    timed("int4 ragged serving", phase_int4_ragged, torch)
    qwen3 = timed("qwen3-30b-a3b generate", phase_qwen3_moe, torch)
    qwen3_serving = timed("qwen3-30b-a3b serving", phase_qwen3_serving, torch)

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
        # B6 at the 8B up projection, one row; launches of the int4 8B
        # generate()
        ("quant_matmul", ("quant_matmul", "8b", "up"), "csrc/quant_matmul.cu",
         "neuronx_distributed_inference_tpu/ops/quant_matmul.py:231", int4_8b["launches"]),
        # B7 at one Qwen3-30B-A3B layer, batch 1; launches of the Qwen3
        # generate()
        ("moe_decode", ("moe_decode", "qwen3 bs1"), "csrc/moe_decode.cu",
         "neuronx_distributed_inference_tpu/ops/moe_decode.py:159", qwen3["launches"]),
        # B8 and B9 at one Llama-3.2-1B decode layer, batch 4 (bf16_1b_bs4);
        # launches of the batch-4 generate() with the fused layer on
        ("fused_attn_block", ("fused_attn_block", 4), "csrc/fused_attn_block.cu",
         "neuronx_distributed_inference_tpu/ops/decode_block.py:397", fused["launches"]),
        ("fused_mlp_block", ("fused_mlp_block", 4), "csrc/fused_mlp_block.cu",
         "neuronx_distributed_inference_tpu/ops/decode_block.py:504", fused["launches"]),
        # the int8/fp8 code modes (a quantized KV cache): B1 at the 8k
        # row's bucket 8704, batch 1, launches of bf16_1b_8k_kvq8's
        # generate(); B4 and B5 at the serving row's points, launches of the
        # kv-int8 split drain (sync, graphs on); B3 at the mixed point,
        # launches of the kv-int8 ragged drain (sync, graphs on)
        ("decode_attention_codes", ("decode_attention_codes", 8704), "csrc/decode_attention.cu",
         "neuronx_distributed_inference_tpu/ops/decode_attention.py:195", kvq["runs"][("8k", "int8")]["launches"]),
        ("paged_decode_attention_codes", "paged_decode_attention_codes", "csrc/decode_attention.cu",
         "neuronx_distributed_inference_tpu/ops/decode_attention.py:284", kvq["serving"][("split", False)]),
        ("paged_flash_attention_codes", "paged_flash_attention_codes", "csrc/paged_flash_attention.cu",
         "neuronx_distributed_inference_tpu/ops/paged_flash_attention.py:200", kvq["serving"][("split", False)]),
        ("ragged_paged_attention_codes", ("ragged_paged_attention_codes", "mixed"), "csrc/ragged_paged_attention.cu",
         "neuronx_distributed_inference_tpu/ops/ragged_paged_attention.py:267", kvq["serving"][("ragged", False)]),
        # speculation: B3 at the spec point (a chunk beside 7 verify rows of
        # k = 4), launches of the spec-ragged drain with draft (a), 1-ahead,
        # graphs on; B1 with K = 4 at batch 8, bucket 1024, launches of the
        # split path's verify passes (the wrapper's own K > 1 counter in
        # the split spec drain)
        ("ragged_paged_attention_spec", ("ragged_paged_attention", "spec"), "csrc/ragged_paged_attention.cu",
         "neuronx_distributed_inference_tpu/ops/ragged_paged_attention.py:267", spec["launches"]),
        ("decode_attention_verify", ("decode_attention_verify", 1024), "csrc/decode_attention.cu",
         "neuronx_distributed_inference_tpu/ops/decode_attention.py:195", split_spec["launches"]),
        # the router rows: B2b at the disaggregated prefill (batch 1, a
        # 128-token prompt in the 1024 bucket) and B1 at its decode (8 rows,
        # bucket 1024), launches of the disaggregated drain (the tier on);
        # B5 and B4 at the serving row's points, launches of the sequential
        # router drain
        ("flash_attention_router", ("flash_attention", "router"), "csrc/flash_attention.cu",
         "neuronx_distributed_inference_tpu/ops/flash_attention.py:335", router["launches"]),
        ("decode_attention_router", ("decode_attention", "router"), "csrc/decode_attention.cu",
         "neuronx_distributed_inference_tpu/ops/decode_attention.py:195", router["launches"]),
        ("paged_flash_attention_router", "paged_flash_attention", "csrc/paged_flash_attention.cu",
         "neuronx_distributed_inference_tpu/ops/paged_flash_attention.py:200", router["launches"]),
        ("paged_decode_attention_router", "paged_decode_attention", "csrc/decode_attention.cu",
         "neuronx_distributed_inference_tpu/ops/decode_attention.py:284", router["launches"]),
        # Qwen3-30B-A3B served: B4, B5 and B3 at its head shape (32 q / 4 kv
        # heads of 128) at the serving row's points, launches of the sync
        # split drain (B4, B5) and the sync ragged drain (B3); B7 at one
        # layer, 8 rows x top-8, launches of the sync split drain
        ("paged_decode_attention_qwen3", ("paged_decode_attention", "qwen3"), "csrc/decode_attention.cu",
         "neuronx_distributed_inference_tpu/ops/decode_attention.py:284", qwen3_serving["launches"]),
        ("paged_flash_attention_qwen3", ("paged_flash_attention", "qwen3"), "csrc/paged_flash_attention.cu",
         "neuronx_distributed_inference_tpu/ops/paged_flash_attention.py:200", qwen3_serving["launches"]),
        ("ragged_paged_attention_qwen3", ("ragged_paged_attention", "mixed", "qwen3"),
         "csrc/ragged_paged_attention.cu", "neuronx_distributed_inference_tpu/ops/ragged_paged_attention.py:267",
         qwen3_serving["launches"]),
        ("moe_decode_qwen3_serving", ("moe_decode", "qwen3 bs8"), "csrc/moe_decode.cu",
         "neuronx_distributed_inference_tpu/ops/moe_decode.py:159", qwen3_serving["launches"]),
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
