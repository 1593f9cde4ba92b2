"""The least time one H100 could take for a kernel's work (its roofline
bound).

    python -m neuronx_distributed_inference_tpu_torch.ops.roofline

prints the bounds of B8 and B9 at their timed points (:data:`FUSED_POINTS`),
the bounds of B3's three timed points and B1's at the long-context decode
buckets (:data:`KVQ_BUCKETS`), each over a bf16 and an int8/fp8 cache, B6's bound at every
projection of the int4 rows (:data:`QMM_POINTS`) with the whole decode
step's weight bytes, and B7's bound at its timed points
(:data:`MOE_POINTS`) with the Qwen3-30B-A3B decode step's weight bytes. The bound is the larger of two times: the bytes the
function must move (each input read once, each output written once) over
the card's memory rate, and its operations over the card's peak rate for
their type. The rates are NVIDIA's published figures for one H100 SXM at
its 700 W limit (dense, no sparsity). ``chip_smoke.py`` computes the bounds
of the kernels from its own inputs with :func:`bound_ms` (B3's with
:func:`ragged_work`, B8's and B9's with :func:`attn_block` and
:func:`mlp_block`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

HBM_BYTES_PER_S = 3.35e12  # HBM3
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor-core peak

BF16 = 2  # bytes
F32 = 4
I32 = 4
CODE = 1  # an int8/fp8 KV code

#: the two Llama widths the bench rows run (the reference's
#: analysis/device_model.py LLAMA_1B / LLAMA_8B)
MODEL_1B = dict(H=2048, I=8192, Hq=32, Hkv=8, D=64, L=16)
MODEL_8B = dict(H=4096, I=14336, Hq=32, Hkv=8, D=128, L=32)

#: the MoE widths (models/mixtral.py QWEN3_30B_A3B, MIXTRAL_8X7B): E
#: experts, k selected per token, I the expert intermediate size, V the vocab
MODEL_QWEN3_MOE = dict(H=2048, I=768, Hq=32, Hkv=4, D=128, L=48, E=128, k=8, V=151936)
MODEL_MIXTRAL = dict(H=4096, I=14336, Hq=32, Hkv=8, D=128, L=32, E=8, k=2, V=32000)
#: DBRX (models/dbrx.DBRX_BASE) and DeepSeek-V3's MoE layers
#: (models/deepseek.DEEPSEEK_V3, I the routed experts' width; its attention
#: is MLA, with no Hkv / D)
MODEL_DBRX = dict(H=6144, I=10752, Hq=48, Hkv=8, D=128, L=40, E=16, k=4, V=100352)
MODEL_DEEPSEEK_V3 = dict(H=7168, I=2048, L=61, E=256, k=8, V=129280)
# Llama-4-Scout-17B-16E's text widths: I is an expert's (and the shared
# expert's) width, I_mlp a dense layer's
MODEL_LLAMA4_SCOUT = dict(H=5120, I=8192, I_mlp=16384, Hq=40, Hkv=8, D=128, L=48, E=16, k=1, V=202048)

#: openai/whisper-large-v3's decoder (d model, F the FFN width, V the tied
#: vocab) and FLUX.1-dev's DiT (dim, 24 heads of 128, 19 dual and 38 single
#: blocks, the MLP 4 x dim)
MODEL_WHISPER_LARGE_V3 = dict(d=1280, F=5120, L=32, H=20, V=51866)
MODEL_FLUX_DEV = dict(dim=3072, H=24, D=128, dual=19, single=38, mlp=12288)


def whisper_decode_step(m: Dict[str, int], batch: int, enc_states: int, cache_len: int) -> Tuple[int, int]:
    """(bytes, FLOPs) of one Whisper decode step, one token a row: every
    decoder weight read once (the tied vocab matrix included), the encoder
    states and the self-attention cache read; FLOPs of the projections and
    of the cross K / V recomputed from ``enc_states`` states a row at every
    step, as the reference computes them."""
    d, F, L, V = m["d"], m["F"], m["L"], m["V"]
    per_layer = 8 * d * d + 2 * d * F  # self and cross q / k / v / o, fc1 / fc2
    weights = L * per_layer + V * d
    nbytes = weights * BF16 + batch * enc_states * d * BF16 + 2 * L * batch * cache_len * d * BF16
    flops = 2 * batch * weights + L * 2 * 2 * batch * enc_states * d * d + L * 4 * batch * (enc_states + cache_len) * d
    return nbytes, flops


def flux_step(m: Dict[str, int], batch: int, img_tokens: int, txt_tokens: int) -> Tuple[int, int]:
    """(bytes, FLOPs) of one FLUX DiT forward: the block weights read once;
    2 FLOPs a weight a token (each dual block's weights see their stream's
    tokens, a single block's all of them) and the joint attention's QK and
    PV products over every block."""
    dim, mlp = m["dim"], m["mlp"]
    inner = m["H"] * m["D"]
    dual_stream = 6 * dim * dim + 3 * dim * inner + inner * dim + 2 * dim * mlp  # one stream's
    single = dim * 3 * dim + 3 * dim * inner + dim * mlp + inner * dim + mlp * dim
    L = img_tokens + txt_tokens
    weights = m["dual"] * 2 * dual_stream + m["single"] * single
    nbytes = weights * BF16
    flops = 2 * batch * (m["dual"] * dual_stream * L + m["single"] * single * L)
    flops += (m["dual"] + m["single"]) * 4 * batch * L * L * inner
    return nbytes, flops


INT4_GROUP = 128  # rows of K per scale (the reference's quant_matmul.INT4_GROUP)


def bound_ms(nbytes: float, flops: float, flop_rate: float = BF16_FLOP_PER_S) -> Tuple[float, str]:
    """(least time in ms, "bytes" or "operations") for ``nbytes`` moved and
    ``flops`` done at ``flop_rate``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kv_factor_bytes(m: Dict[str, int], kv_elt: int) -> int:
    """The (Hkv,) fp32 K and V dequant factors a call over 1-byte code
    blocks reads (none for a plain cache)."""
    return 2 * m["Hkv"] * F32 if kv_elt == CODE else 0


def attention_work(q_tokens: int, kv_positions: int, pairs: int, m: Dict[str, int],
                   kv_elt: int = BF16) -> Tuple[int, int]:
    """Bytes and FLOPs of attention with bf16 q and out: q read and out
    written per query token, K and V read once per cache position at
    ``kv_elt`` bytes an element (CODE for an int8/fp8 cache, with its
    factors), 4 * D FLOPs per allowed (query, key) pair per q head."""
    nbytes = 2 * q_tokens * m["Hq"] * m["D"] * BF16 + 2 * kv_positions * m["Hkv"] * m["D"] * kv_elt
    return nbytes + kv_factor_bytes(m, kv_elt), 4 * m["D"] * m["Hq"] * pairs


#: the decode buckets of the long-context rows bf16_1b_8k(_kvq8) and
#: bf16_1b_16k(_kvq8): an 8192 / 16384-token prompt and 32 new tokens in a
#: cache of 8704 / 16896 positions, where the K/V reads dominate a step
KVQ_BUCKETS = {"bf16_1b_8k": 8704, "bf16_1b_16k": 16896}

RAGGED_Q_TILE = 16  # packed slots per q tile (ops/ragged_paged_attention.py)

#: B3's timed points on the serving_1b_int8_ragged row (8 slots, a kv width
#: of 1024 in blocks of 32), as each row's new tokens and context length
#: (new tokens included): the mixed step (one 128-token chunk from position
#: 0 and 7 decode rows 192 deep), a decode-only step (8 rows 192 deep,
#: each one token in its own tile of 16), and a spec step of
#: serving_1b_int8_spec_ragged (k = 4: the chunk beside 7 verify rows of 4
#: tokens, 196 deep). chip_smoke.py times B3 at all three.
RAGGED_POINTS = {
    "mixed": dict(row_len=(128,) + (1,) * 7, ctx_len=(128,) + (192,) * 7, width=1024, block_size=32),
    "decode": dict(row_len=(1,) * 8, ctx_len=(192,) * 8, width=1024, block_size=32),
    "spec": dict(row_len=(128,) + (4,) * 7, ctx_len=(128,) + (196,) * 7, width=1024, block_size=32),
}


def ragged_work(row_len, ctx_len, width: int, block_size: int, m: Dict[str, int] = MODEL_1B,
                elt: int = BF16, kv_elt: Optional[int] = None) -> Tuple[int, int]:
    """B3's bytes and FLOPs for one launch: q read over the rows' real
    tokens only (a padded slot's output is zeros whatever its q holds), out
    written over all T packed slots (each row's segment rounded up to 16;
    every element is written), K and V read once per context position of
    each row, the (row_start, row_len, ctx_len) descriptors and the block
    tables (int32), and with ``kv_elt`` = CODE (K and V as int8/fp8 codes;
    default: ``elt``) the layer's factors; 4 * D FLOPs per allowed (query,
    key) pair per q head, where a row of n new tokens over a context of c
    has n (c - n) + n (n + 1) / 2 pairs."""
    kv_elt = elt if kv_elt is None else kv_elt
    T = sum(-(-int(n) // RAGGED_Q_TILE) * RAGGED_Q_TILE for n in row_len)
    R = len(row_len)
    q_tokens = sum(int(n) for n in row_len)
    kv_positions = sum(int(c) for n, c in zip(row_len, ctx_len) if n > 0)
    pairs = sum(int(n) * (int(c) - int(n)) + int(n) * (int(n) + 1) // 2 for n, c in zip(row_len, ctx_len))
    nbytes = (q_tokens + T) * m["Hq"] * m["D"] * elt + 2 * kv_positions * m["Hkv"] * m["D"] * kv_elt
    nbytes += 3 * R * I32 + R * (width // block_size) * I32 + kv_factor_bytes(m, kv_elt)
    return nbytes, 4 * m["D"] * m["Hq"] * pairs


def int4_matmul(tokens: int, K: int, N: int, elt: int = BF16) -> Tuple[int, int]:
    """B6: x (tokens, K) read once, packed int4 codes (Kp/2, N) u8 with f32
    scales (Kp/128, N), out (tokens, N) written once, x and out ``elt``
    bytes each (Kp: K rounded up to 256); 2 FLOPs per (token, k, n)."""
    kp = -(-K // (2 * INT4_GROUP)) * 2 * INT4_GROUP
    nbytes = tokens * K * elt + (kp // 2) * N + (kp // INT4_GROUP) * N * F32 + tokens * N * elt
    return nbytes, 2 * tokens * K * N


def int4_projections(m: Dict[str, int], vocab: int = 128256) -> Dict[str, Tuple[int, int]]:
    """(K, N) of every int4 projection of a decode step with fused QKV:
    qkv, o, gate, up and down per layer, and the lm head."""
    H, I, D = m["H"], m["I"], m["D"]
    return {
        "qkv": (H, (m["Hq"] + 2 * m["Hkv"]) * D), "o": (m["Hq"] * D, H),
        "gate": (H, I), "up": (H, I), "down": (I, H), "lm_head": (H, vocab),
    }


#: B6's timed points: each projection of the bf16_8b_int4 row at one row
#: (batch-1 decode) and of the serving_1b_int4_ragged row at 8 rows (the
#: 8-slot split decode step and the ragged step's lm head)
QMM_POINTS = {
    "8b": dict(m=MODEL_8B, rows=1),
    "1b": dict(m=MODEL_1B, rows=8),
}


def int4_step_bytes(m: Dict[str, int], rows: int = 1) -> int:
    """B6's bytes over one whole decode step: every layer's projections and
    the lm head, at ``rows`` rows."""
    total = 0
    for name, (K, N) in int4_projections(m).items():
        total += int4_matmul(rows, K, N)[0] * (1 if name == "lm_head" else m["L"])
    return total


def moe_decode(m: Dict[str, int], tokens: int, distinct_experts: int) -> Tuple[int, int]:
    """B7 at the widths ``m``: the selected experts' gate, up and down
    weights (each distinct expert read once however many tokens chose it),
    x and out in bf16, the (tokens, k) int32 ids and fp32 weights; GLU
    FLOPs per (token, selection) row."""
    H, I, k = m["H"], m["I"], m["k"]
    nbytes = distinct_experts * 3 * H * I * BF16 + 2 * tokens * H * BF16 + tokens * k * (I32 + F32)
    return nbytes, tokens * k * 3 * 2 * H * I


#: B7's timed points: one layer of Qwen3-30B-A3B at batch 1 (8 experts) and
#: batch 8 (64 selections; ``distinct`` is the most they can touch), and of
#: Mixtral-8x7B at batch 1 (2 of 8 experts)
MOE_POINTS = {
    "qwen3 bs1": dict(m=MODEL_QWEN3_MOE, tokens=1, distinct=8),
    "qwen3 bs8": dict(m=MODEL_QWEN3_MOE, tokens=8, distinct=64),
    "mixtral bs1": dict(m=MODEL_MIXTRAL, tokens=1, distinct=2),
}


def moe_dense_bytes(m: Dict[str, int], tokens: int) -> int:
    """The dense all-experts route B7 replaces: every expert's weights, x
    and out, once."""
    return m["E"] * 3 * m["H"] * m["I"] * BF16 + 2 * tokens * m["H"] * BF16


def moe_step_bytes(m: Dict[str, int], rows: int = 1, distinct: int = None) -> int:
    """The weight bytes of one MoE decode step at ``rows`` tokens in bf16
    (the KV cache, which depends on the context, left out): per layer the
    attention projections, the q/k norms and the two layer norms, the router
    and B7's bytes with ``distinct`` experts (by default the most ``rows``
    tokens can touch); then the final norm and the untied lm head."""
    H, D, E, k = m["H"], m["D"], m["E"], m["k"]
    if distinct is None:
        distinct = min(E, rows * k)
    attn = (H * (m["Hq"] + 2 * m["Hkv"]) * D + m["Hq"] * D * H + 2 * D + 2 * H) * BF16
    router = H * E * BF16
    layer = attn + router + moe_decode(m, rows, distinct)[0]
    return m["L"] * layer + (H + H * m["V"]) * BF16


def attn_block(m: Dict[str, int], batch: int, K: int, prior: int, bucket: int, elt: int = BF16) -> Tuple[int, int]:
    """B8 over one decode layer at the widths ``m``: Wqkv, Wout and gamma
    read once, x read and out written, k_new / v_new written, fp32 cos /
    sin, the mask bytes, slot ids and positions read, and K and V read once
    at each of the ``prior`` (row, cached position) pairs the pruned mask
    allows. FLOPs: the two products, and 4 D per allowed (query, key) pair
    per q head, each of a row's K tokens over the prior positions and the
    new tokens causally."""
    H, Hq, Hkv, D = m["H"], m["Hq"], m["Hkv"], m["D"]
    n3 = (Hq + 2 * Hkv) * D
    rows = batch * K
    nbytes = (H * n3 + Hq * D * H + H) * elt + 2 * rows * H * elt + 2 * rows * Hkv * D * elt
    nbytes += 2 * rows * (D // 2) * F32 + rows * bucket + batch * I32 + rows * I32 + 2 * prior * Hkv * D * elt
    pairs = K * prior + batch * K * (K + 1) // 2
    return nbytes, 2 * rows * H * n3 + 2 * rows * Hq * D * H + 4 * D * Hq * pairs


def mlp_block(m: Dict[str, int], rows: int, elt: int = BF16) -> Tuple[int, int]:
    """B9 over one decode layer's MLP at the widths ``m``: the gate, up and
    down weights and gamma read once, x read and out written for ``rows``
    tokens; 6 H I FLOPs a token."""
    H, I = m["H"], m["I"]
    return (3 * H * I + H) * elt + 2 * rows * H * elt, 6 * rows * H * I


#: B8's and B9's timed points (chip_smoke.phase_fused_times): one decode
#: layer at the widths ``m``, K = 1, ``batch`` rows. B8 and B9 at
#: Llama-3.2-1B's batch 1 and 4, bucket 512, each row's new token at
#: position 255 (``prior``: 255 cached positions read per row); B9 alone
#: (``prior`` None) at 16 rows, where the weights are still read once, and
#: at Llama-3.1-8B's MLP width.
FUSED_POINTS = {
    "bs1": dict(m=MODEL_1B, batch=1, prior=255),
    "bs4": dict(m=MODEL_1B, batch=4, prior=4 * 255),
    "rows16": dict(m=MODEL_1B, batch=16, prior=None),
    "8b bs1": dict(m=MODEL_8B, batch=1, prior=None),
}


def main() -> None:
    print("| # | kernel | point | shapes | bytes | FLOPs | bound ms (by) |")
    print("|---|---|---|---|---|---|---|")
    for label, pt in FUSED_POINTS.items():
        m, B = pt["m"], pt["batch"]
        work = [("B9", "fused_mlp_block", f"K=1, H {m['H']}, I {m['I']}, bf16", mlp_block(m, B))]
        if pt["prior"] is not None:
            work.insert(0, ("B8", "fused_attn_block", f"K=1, bucket 512, {pt['prior']} cached positions read, bf16",
                            attn_block(m, B, 1, pt["prior"], 512)))
        for tag, name, shapes, (nbytes, flops) in work:
            ms, by = bound_ms(nbytes, flops)
            print(f"| {tag} | `{name}` | decode layer, {label} ({B} rows) | {shapes} | {nbytes:,} | {flops:,} | "
                  f"{ms:.5f} ({by}) |")
    for label, pt in QMM_POINTS.items():
        for name, (K, N) in int4_projections(pt["m"]).items():
            nbytes, flops = int4_matmul(pt["rows"], K, N)
            ms, by = bound_ms(nbytes, flops)
            print(
                f"| B6 | `quant_matmul` | {label} {name}, {pt['rows']} row(s) | K {K} x N {N}, int4 codes, "
                f"f32 scales per 128 rows, bf16 x | {nbytes:,} | {flops:,} | {ms:.5f} ({by}) |"
            )
        step = int4_step_bytes(pt["m"], pt["rows"])
        print(f"| B6 | `quant_matmul` | {label} whole decode step | every layer and the lm head | {step:,} | "
              f"| {bound_ms(step, 0)[0]:.5f} (bytes) |")
    for label, pt in MOE_POINTS.items():
        m = pt["m"]
        nbytes, flops = moe_decode(m, pt["tokens"], pt["distinct"])
        ms, by = bound_ms(nbytes, flops)
        dense = bound_ms(moe_dense_bytes(m, pt["tokens"]), 0)[0]
        print(
            f"| B7 | `fused_moe_decode` | {label}, one layer | H {m['H']}, I {m['I']}, top-{m['k']} of {m['E']}, "
            f"{pt['distinct']} distinct experts, bf16 | {nbytes:,} | {flops:,} | {ms:.5f} ({by}); dense route "
            f"{dense:.5f} |"
        )
    step = moe_step_bytes(MODEL_QWEN3_MOE)
    print(f"| B7 | `fused_moe_decode` | qwen3 whole decode step, batch 1 | every layer and the lm head | {step:,} | "
          f"| {bound_ms(step, 0)[0]:.5f} (bytes) |")
    for name, pt in RAGGED_POINTS.items():
        for kv_elt, kind in ((BF16, "bf16"), (CODE, "int8/fp8 KV codes")):
            nbytes, flops = ragged_work(**pt, kv_elt=kv_elt)
            ms, by = bound_ms(nbytes, flops)
            print(
                f"| B3 | `ragged_paged_attention` | serving_1b_int8_ragged | {name} point: row_len "
                f"{list(pt['row_len'])}, ctx_len {list(pt['ctx_len'])}, {kind} | {nbytes:,} | {flops:,} | "
                f"{ms:.5f} ({by}) |"
            )
    for label, bucket in KVQ_BUCKETS.items():
        for kv_elt, kind in ((BF16, "bf16"), (CODE, "int8/fp8 KV codes")):
            nbytes, flops = attention_work(1, bucket, bucket, MODEL_1B, kv_elt)
            ms, by = bound_ms(nbytes, flops)
            print(f"| B1 | `tkg_decode_attention` | {label}, batch 1 | one layer, bucket {bucket}, {kind} | "
                  f"{nbytes:,} | {flops:,} | {ms:.5f} ({by}) |")


if __name__ == "__main__":
    main()
