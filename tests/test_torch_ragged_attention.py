"""The plain version of the port's ragged paged attention kernel (B3) held
against the JAX package's Pallas kernel in interpret mode and against its
native version, on the same inputs made by numpy from a seed, in fp32
within 1e-5 on the valid packed slots.

Every case has GQA, zero-table tails and the garbage block 0 filled with
NaN; padded slots (between segments, and past every segment) must be
finite. The cases follow the reference's (tests/test_ragged_attention.py):
pure decode, pure prefill, mixed with inactive rows (``row_len`` 0 with
``row_start`` 0 or past the packed end), odd row counts, a chunk that
starts mid-context, at head_dim 64 and 128. The wrapper, given CPU
tensors, takes the plain version and launches nothing."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.modules.attention import AttnSpec as JaxAttnSpec
from neuronx_distributed_inference_tpu.ops.ragged_paged_attention import (
    ragged_attention_native as jax_native,
)
from neuronx_distributed_inference_tpu.ops.ragged_paged_attention import (
    ragged_paged_attention as jax_kernel,
)
from neuronx_distributed_inference_tpu_torch.modules.attention import AttnSpec
from neuronx_distributed_inference_tpu_torch.ops import _cuda, kernel_mode
from neuronx_distributed_inference_tpu_torch.ops import ragged_paged_attention as trp

ATOL = 1e-5
L, HQ, HKV = 2, 8, 2
NB, BS, MB = 16, 16, 8


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _pack(ctx, qlen):
    """q-tile aligned row segments, as the session packs them; an inactive
    row's start is the packing cursor (0 when it comes first, the packed end
    when it comes last). Returns (row_start, T, positions)."""
    tq = trp.RAGGED_Q_TILE
    row_start, cur = [], 0
    for n in qlen:
        row_start.append(cur)
        cur += -(-n // tq) * tq if n else 0
    T = max(cur, tq)
    positions = np.full(T, -1, np.int32)
    for r, n in enumerate(qlen):
        if n:
            positions[row_start[r] : row_start[r] + n] = np.arange(ctx[r] - n, ctx[r])
    return np.asarray(row_start, np.int32), T, positions


def _build_case(ctx, qlen, D, seed=0):
    """A paged pool (NaN in block 0, random values elsewhere), per-row
    tables covering each row's context (zero tails), packed queries."""
    rng = np.random.RandomState(seed)
    k = (rng.randn(L, NB + 1, HKV, BS, D) * 0.3).astype(np.float32)
    v = (rng.randn(L, NB + 1, HKV, BS, D) * 0.3).astype(np.float32)
    k[:, 0] = np.nan
    v[:, 0] = np.nan
    bt = np.zeros((len(ctx), MB), np.int32)
    free = list(rng.permutation(np.arange(1, NB + 1)))
    for r, c in enumerate(ctx):
        for i in range(-(-c // BS)):
            bt[r, i] = free.pop(0)
    row_start, T, positions = _pack(ctx, qlen)
    q = (rng.randn(T, HQ, D) * 0.3).astype(np.float32)
    return dict(
        q=q, k=k, v=v, bt=bt, positions=positions, row_start=row_start,
        row_len=np.asarray(qlen, np.int32), ctx_len=np.asarray(ctx, np.int32),
    )


CASES = {
    "pure_decode": ([17, 45, 9, 31], [1, 1, 1, 1]),
    "pure_prefill": ([48, 23], [16, 16]),
    "mixed_inactive_last": ([48, 23, 5, 0], [16, 1, 1, 0]),
    "mixed_inactive_first": ([0, 40, 7], [0, 9, 1]),
    "odd_rows": ([40, 12, 7], [9, 3, 1]),
    "chunk_mid_context": ([61, 100, 3], [13, 1, 3]),
}


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_kernel_and_native(case, D):
    ctx, qlen = CASES[case]
    c = _build_case(ctx, qlen, D, seed=len(case) + D)
    layer = 1
    scale = D ** -0.5
    ref_kernel = np.asarray(jax_kernel(
        jnp.asarray(c["q"]), jnp.asarray(c["k"][layer]), jnp.asarray(c["v"][layer]), jnp.asarray(c["bt"]),
        jnp.asarray(c["row_start"]), jnp.asarray(c["row_len"]), jnp.asarray(c["ctx_len"]),
        scale=scale, n_rep=HQ // HKV, interpret=True,
    ))
    ref_native = np.asarray(jax_native(
        jnp.asarray(c["q"]), jnp.asarray(c["k"]), jnp.asarray(c["v"]), jnp.int32(layer), jnp.asarray(c["bt"]),
        jnp.asarray(c["positions"]), jnp.asarray(c["row_start"]), jnp.asarray(c["row_len"]),
        jnp.asarray(c["ctx_len"]), JaxAttnSpec(num_heads=HQ, num_kv_heads=HKV, head_dim=D),
    ))
    _cuda.reset_launch_counts()
    out = trp.ragged_paged_attention(
        _t(c["q"]), _t(c["k"][layer]), _t(c["v"][layer]), _t(c["bt"]), _t(c["row_start"]),
        _t(c["row_len"]), _t(c["ctx_len"]), scale=scale, n_rep=HQ // HKV,
    ).numpy()
    native = trp.ragged_attention_native(
        _t(c["q"]), _t(c["k"]), _t(c["v"]), layer, _t(c["bt"]), _t(c["positions"]), _t(c["row_start"]),
        _t(c["row_len"]), _t(c["ctx_len"]), AttnSpec(num_heads=HQ, num_kv_heads=HKV, head_dim=D),
    ).numpy()
    assert _cuda.launch_counts()["ragged_paged_attention"] == 0
    valid = c["positions"] >= 0
    assert np.isfinite(out).all() and np.isfinite(native).all()
    np.testing.assert_array_equal(out, native)  # the wrapper's CPU path is the native version
    np.testing.assert_allclose(out[valid], ref_kernel[valid], atol=ATOL, rtol=0)
    np.testing.assert_allclose(out[valid], ref_native[valid], atol=ATOL, rtol=0)
    # padded slots: the reference kernel writes exact zeros
    np.testing.assert_array_equal(ref_kernel[~valid], 0.0)


def test_packed_positions_follow_the_descriptors():
    ctx, qlen = CASES["mixed_inactive_first"]
    row_start, T, positions = _pack(ctx, qlen)
    pos, row_id = trp.packed_positions(T, _t(row_start), _t(np.asarray(qlen)), _t(np.asarray(ctx)))
    np.testing.assert_array_equal(pos.numpy(), positions)
    assert row_id[0].item() == 1 and row_id[-1].item() == 0  # padded slots route to row 0


def test_layer_dispatch_follows_the_tri_state():
    """ragged_attention takes the kernel's wrapper unless use_flash_kernel
    is False; on CPU tensors both routes compute the native math."""
    c = _build_case(*CASES["odd_rows"], D=64, seed=3)
    args = (
        _t(c["q"])[None], _t(c["k"]), _t(c["v"]), 0, _t(c["bt"]), _t(c["positions"])[None],
        _t(c["row_start"]), _t(c["row_len"]), _t(c["ctx_len"]),
    )
    outs = []
    for flag in (None, True, False):
        spec = AttnSpec(num_heads=HQ, num_kv_heads=HKV, head_dim=64, use_flash_kernel=flag)
        assert kernel_mode.use_ragged(spec) is (flag is not False)
        outs.append(trp.ragged_attention(*args, spec).numpy())
    np.testing.assert_array_equal(outs[0], outs[2])
    np.testing.assert_array_equal(outs[1], outs[2])


def test_wrapper_refuses_what_the_slice_does_not_take():
    c = _build_case(*CASES["pure_decode"], D=64)
    args = [_t(c[n]) for n in ("q",)] + [_t(c["k"][0]), _t(c["v"][0])] + [
        _t(c[n]) for n in ("bt", "row_start", "row_len", "ctx_len")
    ]
    kw = dict(scale=0.125, n_rep=HQ // HKV)
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        trp.ragged_paged_attention(*args, **kw, k_scale=torch.ones(HKV), v_scale=torch.ones(HKV))
    with pytest.raises(ValueError, match="multiple of 16"):
        trp.ragged_paged_attention(args[0][:15], *args[1:], **kw)
    with pytest.raises(ValueError, match="n_rep"):
        trp.ragged_paged_attention(*args, scale=0.125, n_rep=3)
    assert [trp.block_heads(n) for n in (1, 2, 3, 4, 6, 8, 16)] == [1, 2, 3, 4, 3, 4, 4]


# ---------------------------------------------------------------------------
# the kernel's bf16 algorithm (csrc/ragged_paged_attention.cu), in PyTorch
# ---------------------------------------------------------------------------

H100_SMS = 132
TILE = 64  # kv positions per staged tile of both bf16 routes


def _kernel_model(q, k, v, bt, row_start, row_len, ctx_len, *, scale, n_rep, round_p):
    """B3's bf16 launch in PyTorch, row by row as tile_route sends each
    row's tiles: a prefill row's slots by the online softmax of the
    tensor-core body over 64-position tiles from position 0 (l sums the
    fp32 probabilities; with ``round_p`` P.V takes them rounded to bf16, as
    mma.sync does); a decode row over ragged_decode_split's splits of its
    table's positions, each split's (m, l, acc), the splits past its
    context taking no part, combined in split order (M = max m_z, weights
    e^(m_z - M)); every other slot zero. k / v: one layer, block 0 NaN."""
    from neuronx_distributed_inference_tpu_torch.modules.block_kvcache import read_block_cache_at_layer

    T, Hq, D = q.shape
    k_r, v_r = read_block_cache_at_layer(k[None], v[None], 0, bt)  # (R, W, Hkv, D), block 0 as zeros
    W = k_r.shape[1]
    splits, per = trp.ragged_decode_split(T, W, k.shape[1], n_rep, H100_SMS)
    out = torch.zeros_like(q)
    for r, (s0, n, c) in enumerate(zip(row_start.tolist(), row_len.tolist(), ctx_len.tolist())):
        route = trp.tile_route(n, torch.bfloat16)
        if route == "zeros":
            continue
        kf = k_r[r].repeat_interleave(n_rep, dim=1)  # (W, Hq, D)
        vf = v_r[r].repeat_interleave(n_rep, dim=1)
        qpos = torch.arange(c - n, c)[:, None, None]  # (n, 1, 1)
        s = torch.einsum("thd,shd->ths", q[s0 : s0 + n], kf) * scale  # (n, Hq, W)
        cols = torch.arange(W)[None, None, :]
        ok = (cols <= qpos) & (cols < min(c, W))
        if route == "prefill":
            m = torch.full((n, Hq), NEG_INF)
            l = torch.zeros(n, Hq)
            acc = torch.zeros(n, Hq, D)
            for t0 in range(0, W, TILE):
                st, okt = s[..., t0 : t0 + TILE], ok[..., t0 : t0 + TILE]
                mx = torch.where(okt, st, NEG_INF).amax(dim=-1)
                m_new = torch.maximum(m, mx)
                alpha = torch.exp(m - m_new)
                p = torch.where(okt, torch.exp(st - m_new[..., None]), 0.0)
                l = l * alpha + p.sum(dim=-1)
                pv = p.to(torch.bfloat16).float() if round_p else p
                acc = acc * alpha[..., None] + torch.einsum("ths,shd->thd", pv, vf[t0 : t0 + TILE])
                m = m_new
            out[s0 : s0 + n] = acc / torch.clamp(l, min=1e-30)[..., None]
        else:
            parts = []
            for z in range(-(-min(c, W) // per)):  # the live splits
                sl = slice(z * per, (z + 1) * per)
                sz = torch.where(ok[..., sl], s[..., sl], NEG_INF)
                mz = sz.amax(dim=-1)
                pz = torch.where(ok[..., sl], torch.exp(sz - mz[..., None]), 0.0)
                parts.append((mz, pz.sum(dim=-1), torch.einsum("ths,shd->thd", pz, vf[sl])))
            M = torch.stack([mz for mz, _, _ in parts]).amax(dim=0)
            den = torch.zeros_like(M)
            num = torch.zeros_like(parts[0][2])
            for mz, lz, az in parts:  # split order
                w = torch.exp(mz - M)
                den = den + lz * w
                num = num + az * w[..., None]
            out[s0 : s0 + n] = num / torch.clamp(den, min=1e-30)[..., None]
    return out, splits


NEG_INF = -1e30

#: decode rows deeper than one split beside a chunk that starts mid-context
#: and an inactive row: (ctx_len, row_len)
SPLIT_CASES = {
    "deep_decode": ([128, 60, 17], [1, 1, 1]),
    "decode_beside_chunk": ([40, 70, 20, 0], [21, 1, 1, 0]),
}


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("case", sorted(CASES) + sorted(SPLIT_CASES))
def test_kernel_algorithm_matches_jax_kernel(case, D):
    """The bf16 launch's algorithm (_kernel_model without P's rounding: the
    routes, the decode splits and their combine in split order) against the
    JAX kernel in interpret mode, fp32 within 1e-5 on the valid slots, exact
    zeros elsewhere."""
    ctx, qlen = {**CASES, **SPLIT_CASES}[case]
    c = _build_case(ctx, qlen, D, seed=len(case) + D + 1)
    layer, scale = 1, D ** -0.5
    ref = np.asarray(jax_kernel(
        jnp.asarray(c["q"]), jnp.asarray(c["k"][layer]), jnp.asarray(c["v"][layer]), jnp.asarray(c["bt"]),
        jnp.asarray(c["row_start"]), jnp.asarray(c["row_len"]), jnp.asarray(c["ctx_len"]),
        scale=scale, n_rep=HQ // HKV, interpret=True,
    ))
    out, splits = _kernel_model(
        _t(c["q"]), _t(c["k"][layer]), _t(c["v"][layer]), _t(c["bt"]), _t(c["row_start"]), _t(c["row_len"]),
        _t(c["ctx_len"]), scale=scale, n_rep=HQ // HKV, round_p=False,
    )
    out = out.numpy()
    valid = c["positions"] >= 0
    np.testing.assert_allclose(out[valid], ref[valid], atol=ATOL, rtol=0)
    np.testing.assert_array_equal(out[~valid], 0.0)
    if case in SPLIT_CASES:
        assert splits > 1 and max(ctx) > MB * BS // splits  # a decode row spans several splits


@pytest.mark.parametrize("D", [64, 128])
def test_kernel_p_rounding_within_card_tolerance(D):
    """With P rounded to bf16 for P.V in the prefill tiles (the tensor-core
    body's one extra rounding), at bf16-valued inputs with the card checks'
    sharpened q (std 6) and NaN in block 0, the launch's algorithm stays
    within B2's card tolerance of 1.5e-2 of the plain version on the chunk's
    slots, and rounds nothing on the decode rows (1e-5)."""
    ctx, qlen = SPLIT_CASES["decode_beside_chunk"]
    c = _build_case(ctx, qlen, D, seed=40 + D)
    bf16 = lambda a: torch.from_numpy(a).to(torch.bfloat16).float()  # noqa: E731
    q, k, v = bf16(c["q"] * 20.0), bf16(c["k"][0] * 3.0), bf16(c["v"][0])
    args = (_t(c["bt"]), _t(c["row_start"]), _t(c["row_len"]), _t(c["ctx_len"]))
    kw = dict(scale=D ** -0.5, n_rep=HQ // HKV)
    out, _ = _kernel_model(q, k, v, *args, **kw, round_p=True)
    ref = trp.ragged_paged_attention_plain(q, k, v, *args, **kw)
    chunk = slice(0, qlen[0])
    decode = [c["row_start"][r] for r in (1, 2)]
    err = (out[chunk] - ref[chunk]).abs().max().item()
    assert 0 < err <= 1.5e-2, err  # the rounding is there, within the tolerance
    assert (out[decode] - ref[decode]).abs().max().item() <= ATOL


@pytest.mark.parametrize(
    "T, width, n_rep, want",
    [
        (240, 1024, 4, (16, 64)),  # the mixed point: 15 tiles x 8 kv heads
        (128, 1024, 4, (16, 64)),  # the decode point: 8 tiles x 8 kv heads
        (128, 1024, 8, (16, 64)),  # two head groups a kv head
        (128, 8192, 4, (32, 256)),  # a wide table: at most 32 splits
        (2048, 1024, 4, (1, 1024)),  # 128 tiles x 8 kv heads fill the card
        (16, 100, 1, (7, 16)),  # a width no tile divides
    ],
)
def test_ragged_decode_split(T, width, n_rep, want):
    """B4's rule over the table's width for the grid's (tile, kv head, head
    group) blocks: every position in one split, in order, at most 32
    splits, a multiple of 16 positions each; one split once the blocks fill
    the card."""
    splits, per = trp.ragged_decode_split(T, width, 8, n_rep, sms=H100_SMS)
    assert (splits, per) == want
    assert per % 16 == 0 and splits <= 32
    assert (splits - 1) * per < width <= splits * per


@pytest.mark.parametrize(
    "row_len, dtype, want",
    [
        (0, torch.bfloat16, "zeros"),
        (1, torch.bfloat16, "decode"),
        (2, torch.bfloat16, "prefill"),
        (128, torch.bfloat16, "prefill"),
        (0, torch.float32, "zeros"),
        (1, torch.float32, "attend"),
        (41, torch.float32, "attend"),
    ],
)
def test_tile_route(row_len, dtype, want):
    """A tile's route by its row's new tokens and the dtype."""
    assert trp.tile_route(row_len, dtype) == want
