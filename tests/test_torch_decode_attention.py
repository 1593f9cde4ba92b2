"""Kernel B1's plain version (the port's ``tkg_decode_attention_plain``) and
its wrapper on CPU tensors against the JAX package's Pallas decode kernel
``tkg_decode_attention`` run in interpret mode on the CPU: q_len 1 and 4,
buckets 128 and 256 over a larger stacked cache, masks whose tail tiles are
entirely dead, with and without a learned sink. fp32, atol 2e-5.

The CUDA kernel splits the kv axis over blocks and combines the splits'
softmax states in split order: :func:`decode_kv_split` (its rule) is held
here to cover every position once, and that algorithm, run in PyTorch at
fp32 with the rule's splits, against the JAX kernel (sinks, q_len 4 and 16,
rows whose later splits or all splits are masked, a window mask)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.ops.decode_attention import tkg_decode_attention as jax_tkg
from neuronx_distributed_inference_tpu_torch.ops import _cuda
from neuronx_distributed_inference_tpu_torch.ops import decode_attention as tda

L, R, S_MAX = 3, 5, 384
HQ, HKV, D = 8, 2, 64
H100_SMS = 132


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _case(seed, B, K, bucket, valid, window=None):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, K, HQ, D) * 0.3).astype(np.float32)
    kc = (rng.randn(L, R, S_MAX, HKV, D) * 0.3).astype(np.float32)
    vc = (rng.randn(L, R, S_MAX, HKV, D) * 0.3).astype(np.float32)
    pos = np.stack([np.arange(valid[b] - K, valid[b]) for b in range(B)])  # (B, K)
    cols = np.arange(bucket)[None, None, :]
    mask = cols <= pos[:, :, None]
    if window is not None:
        mask &= cols > pos[:, :, None] - window
    sink = (rng.randn(HQ) * 0.5).astype(np.float32)
    return q, kc, vc, mask[:, None], sink


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("bucket", [128, 256])
@pytest.mark.parametrize("sink", [False, True])
def test_plain_matches_kernel(K, bucket, sink):
    # row 1 fills 37 positions only: with 64-wide tiles the later tiles of
    # the bucket are all masked and skipped by the kernel
    q, kc, vc, mask, sk = _case(K + bucket, 2, K, bucket, [bucket - 3, 37])
    sk = sk if sink else None
    layer = 1
    ref = jax_tkg(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.int32(layer), jnp.asarray(mask),
        None if sk is None else jnp.asarray(sk), scale=D**-0.5, n_kv=HKV, bs=64, interpret=True,
    )
    args = (torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc), layer, torch.from_numpy(mask),
            None if sk is None else torch.from_numpy(sk))
    plain = tda.tkg_decode_attention_plain(*args, scale=D**-0.5, n_kv=HKV)
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), atol=2e-5, rtol=0)
    _cuda.reset_launch_counts()
    wrapped = tda.tkg_decode_attention(*args, scale=D**-0.5, n_kv=HKV)
    assert _cuda.launch_counts()["decode_attention"] == 0  # CPU tensors: plain version
    np.testing.assert_array_equal(wrapped.numpy(), plain.numpy())


def test_plain_matches_kernel_windowed_mask():
    """Leading tiles dead too: a window mask keeps only the last 40 positions."""
    q, kc, vc, mask, _ = _case(9, 2, 1, 256, [250, 200], window=40)
    ref = jax_tkg(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.int32(2), jnp.asarray(mask), None,
        scale=D**-0.5, n_kv=HKV, bs=64, interpret=True,
    )
    out = tda.tkg_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc), 2, torch.from_numpy(mask),
        scale=D**-0.5, n_kv=HKV,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, kc, vc, mask, _ = (torch.from_numpy(a) for a in _case(0, 2, 1, 128, [100, 50]))
    kw = dict(scale=D**-0.5, n_kv=HKV)
    with pytest.raises(ValueError, match="rows"):
        tda.tkg_decode_attention(q.repeat(1, 17, 1, 1), kc, vc, 0, mask.repeat(1, 1, 17, 1), **kw)
    with pytest.raises(ValueError, match="outside the cache"):
        tda.tkg_decode_attention(q, kc, vc, L, mask, **kw)
    with pytest.raises(ValueError, match="mask"):
        tda.tkg_decode_attention(q, kc, vc, 0, mask.int(), **kw)
    with pytest.raises(ValueError, match="dtypes"):
        tda.tkg_decode_attention(q.bfloat16(), kc, vc, 0, mask, **kw)


@pytest.mark.parametrize(
    "S_kv, blocks, sms",
    [
        (512, 8, H100_SMS),  # Llama-3.2-1B, batch 1, bucket 512
        (1024, 8, H100_SMS),
        (512, 4, H100_SMS),  # Qwen3-30B-A3B, batch 1
        (512, 64, H100_SMS),  # 1B, batch 8
        (1024, 64, H100_SMS),
        (512, 32, H100_SMS),
        (128, 8, H100_SMS),
        (1000, 160, H100_SMS),  # the (row, kv head) pairs alone fill the card
        (4096, 1, H100_SMS),
        (32768, 2, H100_SMS),
        (37, 2, H100_SMS),
        (16, 1, H100_SMS),
        (1, 1, H100_SMS),
        (256, 4, 16),
        (999, 3, 1),
    ],
)
def test_decode_kv_split_covers_every_position_once(S_kv, blocks, sms):
    splits, per = tda.decode_kv_split(S_kv, blocks, sms)
    assert 1 <= splits <= tda.MAX_KV_SPLITS
    assert per % tda.SPLIT_ALIGN == 0
    ranges = [range(z * per, min((z + 1) * per, S_kv)) for z in range(splits)]
    assert all(len(r) > 0 for r in ranges)  # no empty split
    assert [s for r in ranges for s in r] == list(range(S_kv))  # in order, each position once
    if blocks >= sms:
        assert splits == 1  # the (row, kv head) pairs alone fill the card: no combine


def test_decode_kv_split_at_the_timed_shapes():
    """On 132 SMs at bucket 512: batch 1 takes 32 splits of 16 positions,
    256 blocks at Llama-3.2-1B's 8 kv heads and 128 at Qwen3-30B-A3B's 4
    (16-position splits are the finest); batch 4 and 8 take one 64-position
    tile a split (8 splits), so every block makes one trip to memory; a
    bucket past 32 tiles caps the count at 32."""
    assert tda.decode_kv_split(512, 8, H100_SMS) == (32, 16)
    assert tda.decode_kv_split(512, 4, H100_SMS) == (32, 16)
    assert tda.decode_kv_split(512, 4 * 8, H100_SMS) == (8, 64)
    assert tda.decode_kv_split(512, 8 * 8, H100_SMS) == (8, 64)
    assert tda.decode_kv_split(4096, 8, H100_SMS) == (32, 128)


def _split_combine(q, kc, vc, layer, mask, sink, *, scale, n_kv):
    """The CUDA kernel's algorithm in PyTorch: the plain decode over each
    split of the wrapper's rule, each split's (m, l, acc) with m = NEG_INF,
    l = 0, acc = 0 where it has no allowed position, combined in split order
    (M = max m_z, weights e^(m_z - M)), then the reference's _finalize."""
    B, K, Hq, Dh = q.shape
    S = mask.shape[-1]
    splits, per = tda.decode_kv_split(S, B * n_kv, H100_SMS)
    assert splits > 1
    n_rep = Hq // n_kv
    k = kc[layer, :B, :S].repeat_interleave(n_rep, dim=2)  # (B, S, Hq, D)
    v = vc[layer, :B, :S].repeat_interleave(n_rep, dim=2)
    scores = torch.einsum("bthd,bshd->bhts", q, k) * scale  # (B, Hq, K, S)
    allowed = mask[:, 0][:, None].expand_as(scores)
    neg = torch.full_like(scores, NEG_INF)
    parts = []
    for z in range(splits):
        sl = slice(z * per, min((z + 1) * per, S))
        sz = torch.where(allowed[..., sl], scores[..., sl], neg[..., sl])
        mz = sz.amax(dim=-1)
        pz = torch.where(allowed[..., sl], torch.exp(sz - mz[..., None]), torch.zeros_like(sz))
        parts.append((mz, pz.sum(dim=-1), torch.einsum("bhts,bshd->bhtd", pz, v[:, sl])))
    M = torch.stack([mz for mz, _, _ in parts]).amax(dim=0)
    l = torch.zeros_like(M)
    acc = torch.zeros_like(parts[0][2])
    for mz, lz, az in parts:  # split order
        w = torch.exp(mz - M)
        l = l + lz * w
        acc = acc + az * w[..., None]
    if sink is None:
        out = acc / torch.clamp(l, min=1e-30)[..., None]
    else:
        sk = sink[None, :, None]
        m2 = torch.maximum(M, sk)
        alpha = torch.exp(M - m2)
        out = acc * (alpha / (l * alpha + torch.exp(sk - m2)))[..., None]
    return out.permute(0, 2, 1, 3)  # (B, K, Hq, D)


NEG_INF = -1e30


@pytest.mark.parametrize("K", [4, 16])
@pytest.mark.parametrize("sink", [False, True])
@pytest.mark.parametrize("window", [None, 40], ids=["causal", "window"])
def test_split_combine_matches_kernel(K, sink, window):
    """Row 0 fills most of the bucket; row 1 fills 37 positions, so its
    splits past the third are all masked; row 2 has no valid key at all
    (exact zeros, with and without a sink). K = 16 with n_rep 4 is the
    64-row group."""
    bucket = 256
    q, kc, vc, mask, sk = _case(100 + K, 3, K, bucket, [bucket - 3, 37, K], window)
    mask[2] = False
    sk = sk if sink else None
    layer = 1
    ref = np.asarray(jax_tkg(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.int32(layer), jnp.asarray(mask),
        None if sk is None else jnp.asarray(sk), scale=D**-0.5, n_kv=HKV, bs=64, interpret=True,
    ))
    port = _split_combine(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc), layer, torch.from_numpy(mask),
        None if sk is None else torch.from_numpy(sk), scale=D**-0.5, n_kv=HKV,
    ).numpy()
    np.testing.assert_allclose(port, ref, atol=2e-5, rtol=0)
    assert (port[2] == 0).all() and (ref[2] == 0).all()
