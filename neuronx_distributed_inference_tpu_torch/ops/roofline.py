"""The least time one H100 could take for a kernel's work (its roofline
bound), and that bound worked out on paper for the TPU kernels the port has
not ported yet.

    python -m neuronx_distributed_inference_tpu_torch.ops.roofline

prints the paper bounds of B6–B9, each at the shapes of the bench row that
would run it, and the bounds of B3's two timed points. The bound is the larger of two times: the bytes the
function must move (each input read once, each output written once) over
the card's memory rate, and its operations over the card's peak rate for
their type. The rates are NVIDIA's published figures for one H100 SXM at
its 700 W limit (dense, no sparsity). ``chip_smoke.py`` computes the bounds
of the ported kernels from its own inputs with :func:`bound_ms` (B3's with
:func:`ragged_work`, at the points of :data:`RAGGED_POINTS`).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

HBM_BYTES_PER_S = 3.35e12  # HBM3
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor-core peak

BF16 = 2  # bytes
F32 = 4
I32 = 4

#: the two Llama widths the bench rows run (the reference's
#: analysis/device_model.py LLAMA_1B / LLAMA_8B)
MODEL_1B = dict(H=2048, I=8192, Hq=32, Hkv=8, D=64, L=16)
MODEL_8B = dict(H=4096, I=14336, Hq=32, Hkv=8, D=128, L=32)

INT4_GROUP = 128  # rows of K per scale (the reference's quant_matmul.INT4_GROUP)


def bound_ms(nbytes: float, flops: float, flop_rate: float = BF16_FLOP_PER_S) -> Tuple[float, str]:
    """(least time in ms, "bytes" or "operations") for ``nbytes`` moved and
    ``flops`` done at ``flop_rate``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_work(q_tokens: int, kv_positions: int, pairs: int, m: Dict[str, int]) -> Tuple[int, int]:
    """Bytes and FLOPs of attention in bf16: q read and out written per
    query token, K and V read once per cache position, 4 * D FLOPs per
    allowed (query, key) pair per q head."""
    nbytes = 2 * q_tokens * m["Hq"] * m["D"] * BF16 + 2 * kv_positions * m["Hkv"] * m["D"] * BF16
    return nbytes, 4 * m["D"] * m["Hq"] * pairs


RAGGED_Q_TILE = 16  # packed slots per q tile (ops/ragged_paged_attention.py)

#: B3's timed points on the serving_1b_int8_ragged row (8 slots, a kv width
#: of 1024 in blocks of 32), as each row's new tokens and context length
#: (new tokens included): the mixed step (one 128-token chunk from position
#: 0 and 7 decode rows 192 deep) and a decode-only step (8 rows 192 deep,
#: each one token in its own tile of 16). chip_smoke.py times B3 at both.
RAGGED_POINTS = {
    "mixed": dict(row_len=(128,) + (1,) * 7, ctx_len=(128,) + (192,) * 7, width=1024, block_size=32),
    "decode": dict(row_len=(1,) * 8, ctx_len=(192,) * 8, width=1024, block_size=32),
}


def ragged_work(row_len, ctx_len, width: int, block_size: int, m: Dict[str, int] = MODEL_1B,
                elt: int = BF16) -> Tuple[int, int]:
    """B3's bytes and FLOPs for one launch: q read over the rows' real
    tokens only (a padded slot's output is zeros whatever its q holds), out
    written over all T packed slots (each row's segment rounded up to 16;
    every element is written), K and V read once per context position of
    each row, the (row_start, row_len, ctx_len) descriptors and the block
    tables (int32); 4 * D FLOPs per allowed (query, key) pair per q head,
    where a row of n new tokens over a context of c has
    n (c - n) + n (n + 1) / 2 pairs."""
    T = sum(-(-int(n) // RAGGED_Q_TILE) * RAGGED_Q_TILE for n in row_len)
    R = len(row_len)
    q_tokens = sum(int(n) for n in row_len)
    kv_positions = sum(int(c) for n, c in zip(row_len, ctx_len) if n > 0)
    pairs = sum(int(n) * (int(c) - int(n)) + int(n) * (int(n) + 1) // 2 for n, c in zip(row_len, ctx_len))
    nbytes = (q_tokens + T) * m["Hq"] * m["D"] * elt + 2 * kv_positions * m["Hkv"] * m["D"] * elt
    nbytes += 3 * R * I32 + R * (width // block_size) * I32
    return nbytes, 4 * m["D"] * m["Hq"] * pairs


def int4_matmul(tokens: int, K: int, N: int) -> Tuple[int, int]:
    """B6: x (tokens, K) bf16 against packed int4 codes (K/2, N) u8 with f32
    scales (K/128, N), out (tokens, N) bf16."""
    nbytes = tokens * K * BF16 + (K // 2) * N + (K // INT4_GROUP) * N * F32 + tokens * N * BF16
    return nbytes, 2 * tokens * K * N


def moe_decode(tokens: int, top_k: int, distinct_experts: int) -> Tuple[int, int]:
    """B7: the selected experts' gate, up and down weights (each read once
    however many tokens chose it), x and out, GLU FLOPs per selection."""
    m = MODEL_1B
    expert = 3 * m["H"] * m["I"] * BF16
    nbytes = distinct_experts * expert + 2 * tokens * m["H"] * BF16 + tokens * top_k * F32
    return nbytes, tokens * top_k * 3 * 2 * m["H"] * m["I"]


def attn_block(batch: int, ctx: int) -> Tuple[int, int]:
    """B8: norm, fused QKV, RoPE, attention over ``ctx`` cached positions
    per row, o-proj and residual, for one decode token per row; k_new/v_new
    written for the cache scatter outside the kernel."""
    m = MODEL_1B
    n3 = (m["Hq"] + 2 * m["Hkv"]) * m["D"]
    weights = (m["H"] * n3 + m["Hq"] * m["D"] * m["H"] + m["H"]) * BF16
    cache = 2 * batch * ctx * m["Hkv"] * m["D"] * BF16
    acts = 2 * batch * m["H"] * BF16 + 2 * batch * m["Hkv"] * m["D"] * BF16 + 2 * batch * (m["D"] // 2) * F32
    flops = 2 * batch * m["H"] * n3 + 2 * batch * m["Hq"] * m["D"] * m["H"] + 4 * m["D"] * m["Hq"] * batch * ctx
    return weights + cache + acts, flops


def mlp_block(batch: int) -> Tuple[int, int]:
    """B9: norm, gate/up GLU, down-projection and residual, one decode token
    per row."""
    m = MODEL_1B
    weights = (3 * m["H"] * m["I"] + m["H"]) * BF16
    return weights + 2 * batch * m["H"] * BF16, 3 * 2 * batch * m["H"] * m["I"]


def paper_bounds() -> List[dict]:
    """One row per kernel still to port: where its shapes come from, its
    bytes and FLOPs, and its bound on one H100."""
    cases = [
        ("B6", "quant_matmul", "bf16_8b_int4",
         "decode at batch 1, the 8B up projection K 4096 x N 14336, int4 codes, f32 scales per 128 rows",
         int4_matmul(1, MODEL_8B["H"], MODEL_8B["I"])),
        ("B7", "fused_moe_decode", "none (off by default; no MoE bench row)",
         "the kernel registry's case: 4 tokens, top-2 of 8 experts at 1B widths, all 8 experts chosen",
         moe_decode(4, 2, 8)),
        ("B8", "fused_attn_block", "bf16_1b_bs4 (when enabled; off by default)",
         "one decode layer at batch 4, 256 cached positions per row, bf16",
         attn_block(4, 256)),
        ("B9", "fused_mlp_block", "bf16_1b_bs4 (when enabled; off by default)",
         "one decode layer's MLP at batch 4, H 2048, I 8192, bf16",
         mlp_block(4)),
    ]
    rows = []
    for tag, name, bench_row, shape, (nbytes, flops) in cases:
        ms, by = bound_ms(nbytes, flops)
        rows.append(dict(tag=tag, name=name, bench_row=bench_row, shape=shape,
                         bytes=nbytes, flops=flops, bound_ms=ms, bound_by=by))
    return rows


def main() -> None:
    print("| # | kernel | bench row | shapes | bytes | FLOPs | bound ms (by) |")
    print("|---|---|---|---|---|---|---|")
    for r in paper_bounds():
        print(
            f"| {r['tag']} | `{r['name']}` | {r['bench_row']} | {r['shape']} | {r['bytes']:,} | "
            f"{r['flops']:,} | {r['bound_ms']:.5f} ({r['bound_by']}) |"
        )
    for name, pt in RAGGED_POINTS.items():
        nbytes, flops = ragged_work(**pt)
        ms, by = bound_ms(nbytes, flops)
        print(
            f"| B3 | `ragged_paged_attention` | serving_1b_int8_ragged | {name} point: row_len "
            f"{list(pt['row_len'])}, ctx_len {list(pt['ctx_len'])}, bf16 | {nbytes:,} | {flops:,} | {ms:.5f} ({by}) |"
        )


if __name__ == "__main__":
    main()
