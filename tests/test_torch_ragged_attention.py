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
