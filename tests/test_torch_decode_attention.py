"""Kernel B1's plain version (the port's ``tkg_decode_attention_plain``) and
its wrapper on CPU tensors against the JAX package's Pallas decode kernel
``tkg_decode_attention`` run in interpret mode on the CPU: q_len 1 and 4,
buckets 128 and 256 over a larger stacked cache, masks whose tail tiles are
entirely dead, with and without a learned sink. fp32, atol 2e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.ops.decode_attention import tkg_decode_attention as jax_tkg
from neuronx_distributed_inference_tpu_torch.ops import _cuda
from neuronx_distributed_inference_tpu_torch.ops import decode_attention as tda

L, R, S_MAX = 3, 5, 384
HQ, HKV, D = 8, 2, 64


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
