"""The plain versions of the port's paged attention kernels — B4
(``paged_tkg_decode_attention``) and B5 (``paged_flash_attention``) — held
against the JAX package's Pallas kernels in interpret mode, on the same
inputs made by numpy from a seed, in fp32 within 2e-5 (summation order
differs between the two).

Every case has GQA and zero-table tails, and block 0 (the garbage block)
filled with NaN: the outputs must be finite and agree. B5's cases include
a row with ``kv_limit`` 0 (an inactive slot of a chunk pass), which both
write as zeros. The wrappers, given CPU tensors, take the plain versions
and launch nothing. A test-local plain B5 that rounds P to bf16 before P.V
(the tensor-core kernel's one extra rounding) stays within 1.5e-2 of the
plain version and of the JAX kernel at the serving row's widths.

B4's CUDA kernel is B1's split kernel in its paged address mode: the
table's ``MB * bs`` positions split by ``decode_kv_split`` (held here to
cover every position once, at bs 16 and 32 and widths that are not
multiples of 64, and pinned at the serving row's decode shape), block 0
read as zeros, the splits' softmax states combined in split order. That
algorithm, run in PyTorch at fp32, is held against the JAX kernel within
2e-5 (as B1's)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.ops.decode_attention import (
    paged_tkg_decode_attention as jax_paged_decode,
)
from neuronx_distributed_inference_tpu.ops.paged_flash_attention import (
    paged_flash_attention as jax_paged_flash,
)
from neuronx_distributed_inference_tpu_torch.modules import masks as tmasks
from neuronx_distributed_inference_tpu_torch.modules.attention import AttnSpec
from neuronx_distributed_inference_tpu_torch.ops import _cuda, kernel_mode
from neuronx_distributed_inference_tpu_torch.ops import decode_attention as tda
from neuronx_distributed_inference_tpu_torch.ops import paged_flash_attention as tpf
from tests.test_torch_decode_attention import H100_SMS, _split_combine

ATOL = 2e-5
HQ, HKV, D = 4, 2, 64


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _pool(rng, L, NB, bs):
    """Head-major pool (L, NB+1, Hkv, bs, D) with NaN in garbage block 0."""
    k = (rng.randn(L, NB + 1, HKV, bs, D) * 0.5).astype(np.float32)
    v = (rng.randn(L, NB + 1, HKV, bs, D) * 0.5).astype(np.float32)
    k[:, 0] = np.nan
    v[:, 0] = np.nan
    return k, v


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("sink", [False, True])
def test_paged_decode_plain_matches_jax_kernel(K, bs, sink):
    rng = np.random.RandomState(K * 10 + bs + int(sink))
    L, NB, MB, B = 2, 10, 4, 3
    k, v = _pool(rng, L, NB, bs)
    q = rng.randn(B, K, HQ, D).astype(np.float32)
    # rows of different lengths; unused table tails point at block 0
    lens = np.array([MB * bs, bs + 3, 2 * bs])
    bt = np.zeros((B, MB), np.int32)
    bt[0] = [4, 9, 2, 7]
    bt[1, :2] = [10, 1]
    bt[2, :2] = [3, 5]
    pos = lens[:, None] - K + np.arange(K)[None, :]  # the K newest positions
    attn = (np.arange(MB * bs)[None, :] < lens[:, None]).astype(np.int32)
    mask = np.asarray(tmasks.spec_token_gen_mask(_t(attn), _t(pos)))
    sk = rng.randn(HQ).astype(np.float32) if sink else None
    kw = dict(scale=D ** -0.5, n_kv=HKV)
    ref = jax_paged_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(1), jnp.asarray(bt),
        jnp.asarray(mask), None if sk is None else jnp.asarray(sk), interpret=True, **kw,
    )
    _cuda.reset_launch_counts()
    out = tda.paged_tkg_decode_attention(
        _t(q), _t(k), _t(v), 1, _t(bt), _t(mask), None if sk is None else _t(sk), **kw
    )
    assert _cuda.launch_counts()["paged_decode_attention"] == 0
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize(
    "MB, bs, blocks",
    [
        (32, 32, 64),  # the serving row's decode step: 8 rows x 8 kv heads, width 1024
        (32, 32, 8),  # one row
        (24, 16, 8),
        (27, 16, 8),  # a width of 432: no multiple of 64
        (27, 32, 64),  # 864
        (5, 32, 6),  # splits of 16 start inside a block of 32
        (256, 16, 2),  # 4096 positions: capped at 32 splits
        (40, 32, 160),  # the (row, kv head) pairs fill the card: one split
    ],
)
def test_paged_decode_kv_split_covers_every_position_once(MB, bs, blocks):
    """B4 splits the table's MB * bs positions by B1's rule: each position
    in one split, in order, none empty, and a split's positions touch at
    most per / 16 + 2 table entries (the kernel's staged table)."""
    S = MB * bs
    splits, per = tda.decode_kv_split(S, blocks, H100_SMS)
    assert 1 <= splits <= tda.MAX_KV_SPLITS and per % tda.SPLIT_ALIGN == 0
    ranges = [range(z * per, min((z + 1) * per, S)) for z in range(splits)]
    assert all(len(r) > 0 for r in ranges)
    assert [s for r in ranges for s in r] == list(range(S))
    assert all((r[-1] // bs) - (r[0] // bs) + 1 <= per // 16 + 2 for r in ranges)
    if blocks >= H100_SMS:
        assert splits == 1


def test_paged_decode_kv_split_at_the_timed_shape():
    """The serving row's decode step (8 rows, 8 kv heads, 32 blocks of 32)
    takes 16 splits of one 64-position tile: 1024 blocks on 132 SMs, of
    which those past a row's 192 positions read only their mask bytes."""
    assert tda.decode_kv_split(32 * 32, 8 * 8, H100_SMS) == (16, 64)


def _paged_split_combine(q, k, v, layer, bt, mask, sink, *, scale, n_kv):
    """B4's algorithm in PyTorch: each row's positions through its table,
    block 0 and ids outside [1, NB] as zeros (the kernel's zero fill; the
    NaN there is never read), then B1's split and combine over the
    table's MB * bs positions."""
    B, MB = bt.shape
    NB1, bs = k.shape[1], k.shape[3]
    ok = ((bt > 0) & (bt < NB1))[:, :, None, None, None]
    idx = torch.where(bt > 0, bt, 0).clamp(max=NB1 - 1).long()

    def line(c):  # (1, B, MB * bs, Hkv, D): one cache line a row
        blocks = torch.where(ok, c[layer][idx], torch.zeros(()))  # (B, MB, Hkv, bs, D)
        return blocks.permute(0, 1, 3, 2, 4).reshape(1, B, MB * bs, n_kv, -1)

    return _split_combine(q, line(k), line(v), 0, mask, sink, scale=scale, n_kv=n_kv)


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("bs", [16, 32])
@pytest.mark.parametrize("sink", [False, True])
def test_paged_split_combine_matches_jax_kernel(K, bs, sink):
    """Row 0 runs the table's full width less 5; row 1 ends 7 positions
    into a block, the rest of its table zeros, so its last live 64-position
    tile holds block-0 chunks beside valid positions; row 2 is inactive
    (zero table, mask true only at position 0, as the session builds it).
    Block 0 holds NaN; the width (6 or 5 blocks) is no multiple of 64 at
    bs 16 and 32 (96, 160). The JAX kernel reads the NaN wherever the mask
    allows a block-0 position (the inactive row; the session drops its
    output), so it is the reference for the active rows. The port's plain
    version scrubs block 0 to zeros, as the kernel's zero fill does: it is
    the reference for every row, also once row 3 gets a zero entry inside
    its valid range."""
    rng = np.random.RandomState(40 + K * 10 + bs + int(sink))
    L, B = 2, 4
    MB = 6 if bs == 16 else 5
    NB = B * MB + 2
    k, v = _pool(rng, L, NB, bs)
    q = rng.randn(B, K, HQ, D).astype(np.float32)
    lens = np.array([MB * bs - 5, bs + 7, 0, 3 * bs])
    bt = np.zeros((B, MB), np.int32)
    free = rng.permutation(np.arange(1, NB + 1))
    bt[0] = free[:MB]
    bt[1, :2] = free[MB:MB + 2]
    bt[3, :3] = free[MB + 2:MB + 5]
    act = lens > 0
    pos = np.where(act[:, None], lens[:, None] - K + np.arange(K)[None, :], 0)
    attn = (np.arange(MB * bs)[None, :] < np.maximum(lens, 1)[:, None]).astype(np.int32)
    mask = np.asarray(tmasks.spec_token_gen_mask(_t(attn), _t(pos)))
    sk = rng.randn(HQ).astype(np.float32) if sink else None
    kw = dict(scale=D ** -0.5, n_kv=HKV)
    splits, per = tda.decode_kv_split(MB * bs, B * HKV, H100_SMS)
    assert splits > 1 and per < bs * 2  # splits that start inside blocks, tiles that span them
    ref = np.asarray(jax_paged_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(1), jnp.asarray(bt),
        jnp.asarray(mask), None if sk is None else jnp.asarray(sk), interpret=True, **kw,
    ))
    for hole in (False, True):
        if hole:
            bt[3, 1] = 0  # a zero entry inside row 3's valid range
        args = (_t(q), _t(k), _t(v), 1, _t(bt), _t(mask), None if sk is None else _t(sk))
        port = _paged_split_combine(*args, **kw).numpy()
        assert np.isfinite(port).all()
        plain = tda.paged_tkg_decode_attention_plain(*args, **kw).numpy()
        np.testing.assert_allclose(port, plain, atol=ATOL, rtol=0)
        if not hole:
            assert np.isfinite(ref[act]).all()
            np.testing.assert_allclose(port[act], ref[act], atol=ATOL, rtol=0)


@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("Sq", [16, 24])
def test_paged_flash_plain_matches_jax_kernel(bs, Sq):
    """Prefix + causal among the new tokens, a kv_limit that is not a
    multiple of the block size, zero tails, NaN block 0, a kv_limit-0 row."""
    rng = np.random.RandomState(bs + Sq)
    NB, MB, B = 14, 6, 3
    k, v = _pool(rng, 1, NB, bs)
    k, v = k[0], v[0]  # one layer
    q = rng.randn(B, Sq, HQ, D).astype(np.float32) * 0.5
    starts = np.array([bs + 5, 3, 0])
    positions = starts[:, None] + np.arange(Sq)[None, :]
    kv_limit = np.array([starts[0] + Sq, starts[1] + Sq - 2, 0])  # row 2 inactive
    bt = np.zeros((B, MB), np.int32)
    n0 = -(-int(kv_limit[0]) // bs)
    n1 = -(-int(kv_limit[1]) // bs)
    bt[0, :n0] = rng.permutation(np.arange(1, NB + 1))[:n0]
    bt[1, :n1] = rng.permutation(np.arange(1, NB + 1))[:n1]
    kw = dict(scale=D ** -0.5, n_rep=HQ // HKV)
    ref = jax_paged_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
        jnp.asarray(positions), jnp.asarray(kv_limit), tq=8, interpret=True, **kw,
    )
    _cuda.reset_launch_counts()
    out = tpf.paged_flash_attention(_t(q), _t(k), _t(v), _t(bt), _t(positions), _t(kv_limit), **kw)
    assert _cuda.launch_counts()["paged_flash_attention"] == 0
    out = out.numpy()
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out[2], 0.0)  # no valid key: zeros
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL, rtol=0)


def test_paged_flash_plain_equals_paged_decode_plain_on_valid_rows():
    """The two plain versions compute one function where both apply: B5's
    mask (kv_pos <= q_pos, < kv_limit) is B4's spec_token_gen_mask over
    the cache occupancy."""
    rng = np.random.RandomState(7)
    bs, NB, MB, B, Sq = 16, 8, 3, 2, 4
    k, v = _pool(rng, 1, NB, bs)
    q = rng.randn(B, Sq, HQ, D).astype(np.float32)
    bt = np.array([[2, 5, 0], [7, 1, 3]], np.int32)
    limit = np.array([20, 40])
    pos = limit[:, None] - Sq + np.arange(Sq)[None, :]
    attn = (np.arange(MB * bs)[None, :] < limit[:, None]).astype(np.int32)
    mask = tmasks.spec_token_gen_mask(_t(attn), _t(pos))
    a = tpf.paged_flash_attention_plain(
        _t(q), _t(k[0]), _t(v[0]), _t(bt), _t(pos), _t(limit), scale=0.125, n_rep=2
    )
    b = tda.paged_tkg_decode_attention_plain(_t(q), _t(k), _t(v), 0, _t(bt), mask, scale=0.125, n_kv=HKV)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=0)


def test_routing_rule_follows_the_reference():
    """q_len < 8 goes to B4, q_len >= 8 to B5 (reference kernel_mode.py:
    162-172, without its tile gates); attn_kernel_enabled=False turns B5
    off, and the tri-states decide nothing else."""
    for flag in (None, True):
        spec = AttnSpec(num_heads=HQ, num_kv_heads=HKV, head_dim=D, use_flash_kernel=flag)
        assert [kernel_mode.use_paged_flash(spec, n) for n in (1, 4, 7, 8, 128)] == [
            False, False, False, True, True,
        ]
    off = AttnSpec(num_heads=HQ, num_kv_heads=HKV, head_dim=D, use_flash_kernel=False)
    assert not kernel_mode.use_paged_flash(off, 128)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    rng = np.random.RandomState(3)
    k, v = _pool(rng, 1, 4, 16)
    q = _t(rng.randn(1, 1, HQ, D).astype(np.float32))
    bt = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="MB \\* block size"):
        tda.paged_tkg_decode_attention(
            q, _t(k), _t(v), 0, bt, torch.ones((1, 1, 1, 48), dtype=torch.bool), scale=0.1, n_kv=HKV
        )
    with pytest.raises(ValueError, match="n_rep"):
        tpf.paged_flash_attention(
            _t(rng.randn(1, 8, HQ, D).astype(np.float32)), _t(k[0]), _t(v[0]), bt,
            torch.zeros((1, 8), dtype=torch.int32), torch.zeros(1, dtype=torch.int32), scale=0.1, n_rep=3,
        )


def _plain_bf16_p(q, k, v, bt, positions, kv_limit, scale, n_rep):
    """paged_flash_attention_plain with the probabilities rounded to bf16
    before P.V, as B5's tensor-core product takes them; l sums them in fp32
    before the rounding."""
    from neuronx_distributed_inference_tpu_torch.modules.attention import repeat_kv
    from neuronx_distributed_inference_tpu_torch.modules.block_kvcache import read_block_cache_at_layer

    k_r, v_r = read_block_cache_at_layer(k[None], v[None], 0, bt)
    kf, vf = repeat_kv(k_r, n_rep).float(), repeat_kv(v_r, n_rep).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    kv_pos = torch.arange(kf.shape[1])[None, None, None, :]
    mask = (kv_pos <= positions.long()[:, None, :, None]) & (kv_pos < kv_limit.long()[:, None, None, None])
    s = torch.where(mask, s, torch.full_like(s, tpf.NEG_INF))
    p = torch.where(mask, torch.exp(s - s.amax(dim=-1, keepdim=True)), torch.zeros_like(s))
    l = p.sum(dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(torch.bfloat16).float(), vf)
    return out / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]


@pytest.mark.parametrize("Dh", [64, 128])
def test_bf16_probabilities_within_card_tolerance(Dh):
    """The serving row's widths (32 q / 8 kv heads, block size 32) at a
    small depth (a 32-token chunk after a 70-token prefix, a row with
    kv_limit 0), bf16-valued inputs with chip_smoke's sharpened q (std 6)
    and NaN in block 0: rounding P to bf16 before P.V, the tensor-core
    kernel's one extra rounding, moves the output by less than B2's card
    tolerance of 1.5e-2, against the plain version and against the JAX
    kernel in interpret mode."""
    rng = np.random.RandomState(11 + Dh)
    Hq, Hkv, bs, NB, MB, B, Sq = 32, 8, 32, 9, 4, 2, 32
    bf16 = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).float()  # noqa: E731
    k = bf16(rng.randn(NB + 1, Hkv, bs, Dh) * 0.5)
    v = bf16(rng.randn(NB + 1, Hkv, bs, Dh) * 0.5)
    k[0] = float("nan")
    v[0] = float("nan")
    q = bf16(rng.randn(B, Sq, Hq, Dh) * 6.0)
    positions = torch.from_numpy((70 + np.arange(Sq))[None, :].repeat(B, 0).astype(np.int32))
    kv_limit = torch.tensor([70 + Sq, 0], dtype=torch.int32)  # row 1 inactive
    bt = torch.zeros((B, MB), dtype=torch.int32)
    bt[0] = torch.from_numpy(rng.permutation(np.arange(1, NB + 1))[:MB].astype(np.int32))
    kw = dict(scale=Dh ** -0.5, n_rep=Hq // Hkv)
    out = _plain_bf16_p(q, k, v, bt, positions, kv_limit, **kw)
    ref = tpf.paged_flash_attention_plain(q, k, v, bt, positions, kv_limit, **kw)
    jax_ref = np.asarray(jax_paged_flash(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()), jnp.asarray(bt.numpy()),
        jnp.asarray(positions.numpy()), jnp.asarray(kv_limit.numpy()), tq=Sq, interpret=True, **kw,
    ))
    assert torch.isfinite(out).all()
    assert (out[1] == 0).all()  # kv_limit 0: zeros
    for r in (ref.numpy(), jax_ref):
        err = np.abs(out.numpy()[0] - r[0]).max()
        assert err <= 1.5e-2, err
        assert err > 0  # the rounding is there
