"""The PyTorch port's model modules against the JAX package's, on the CPU in
fp32: the same numpy inputs through both, atol 1e-6 (exact where the
result is integer or boolean)."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.modules import autobucketing as jab
from neuronx_distributed_inference_tpu.modules import kvcache as jkv
from neuronx_distributed_inference_tpu.modules import masks as jmasks
from neuronx_distributed_inference_tpu.modules import norm as jnorm
from neuronx_distributed_inference_tpu.modules import rope as jrope
from neuronx_distributed_inference_tpu.modules import sampling as jsamp
from neuronx_distributed_inference_tpu_torch.modules import autobucketing as tab
from neuronx_distributed_inference_tpu_torch.modules import kvcache as tkv
from neuronx_distributed_inference_tpu_torch.modules import masks as tmasks
from neuronx_distributed_inference_tpu_torch.modules import norm as tnorm
from neuronx_distributed_inference_tpu_torch.modules import rope as trope
from neuronx_distributed_inference_tpu_torch.modules import sampling as tsamp

ATOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_rms_norm_and_apply_norm():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 32).astype(np.float32)
    w = rng.randn(32).astype(np.float32)
    ref = np.asarray(jnorm.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    np.testing.assert_allclose(tnorm.rms_norm(_t(x), _t(w), 1e-5).numpy(), ref, atol=ATOL)
    np.testing.assert_allclose(tnorm.apply_norm(_t(x), _t(w), 1e-5).numpy(), ref, atol=ATOL)


@pytest.mark.parametrize(
    "scaling",
    [
        None,
        {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
         "original_max_position_embeddings": 8192},
        {"rope_type": "yarn", "factor": 4.0, "beta_fast": 32.0, "beta_slow": 1.0,
         "original_max_position_embeddings": 4096},
        {"rope_type": "linear", "factor": 2.0},
    ],
    ids=["default", "llama3", "yarn", "linear"],
)
def test_inv_freq_and_rope(scaling):
    cfg = SimpleNamespace(hidden_size=256, num_attention_heads=4, rope_theta=500000.0, rope_scaling=scaling)
    ref_inv = np.asarray(jrope.compute_inv_freq(cfg))
    inv = trope.compute_inv_freq(cfg)
    np.testing.assert_allclose(inv.numpy(), ref_inv, rtol=1e-6, atol=0)
    assert trope.rope_attention_scaling(cfg) == jrope.rope_attention_scaling(cfg)

    rng = np.random.RandomState(1)
    pos = rng.randint(0, 2000, size=(2, 7)).astype(np.int32)
    scale = jrope.rope_attention_scaling(cfg)
    jc, js = jrope.rope_cos_sin(jnp.asarray(pos), jnp.asarray(ref_inv), scale)
    tc, ts = trope.rope_cos_sin(_t(pos), _t(ref_inv), scale)
    # cos/sin of angles up to ~2000 rad: fp32 argument reduction may differ
    # in the last bit between XLA and PyTorch
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-6)

    x = rng.randn(2, 7, 3, 64).astype(np.float32)
    ref = np.asarray(jrope.apply_rope(jnp.asarray(x), jc, js))
    out = trope.apply_rope(_t(x), _t(np.asarray(jc)), _t(np.asarray(js)))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_masks():
    am = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.int32)
    np.testing.assert_array_equal(
        tmasks.causal_mask(_t(am)).numpy(), np.asarray(jmasks.causal_mask(jnp.asarray(am)))
    )
    for n_active in (1, 3):
        np.testing.assert_array_equal(
            tmasks.token_gen_mask(_t(am), n_active).numpy(),
            np.asarray(jmasks.token_gen_mask(jnp.asarray(am), n_active)),
        )


def test_autobucketing():
    for lo, hi in ((128, 1024), (1, 100), (128, 128), (100, 1000)):
        assert tab.generate_buckets(lo, hi) == jab.generate_buckets(lo, hi)
    cases = [
        dict(context_encoding_buckets=None, token_generation_buckets=None, enable_bucketing=True,
             max_context_length=1024, max_length=1024, seq_len=1024),
        dict(context_encoding_buckets=[512, 128], token_generation_buckets=[1024, 512],
             enable_bucketing=True, max_context_length=1024, max_length=1024, seq_len=1024),
        dict(context_encoding_buckets=None, token_generation_buckets=None, enable_bucketing=False,
             max_context_length=300, max_length=None, seq_len=600),
    ]
    for kw in cases:
        cfg = SimpleNamespace(**kw, is_chunked_prefill=False, chunked_prefill_config=None)
        assert tab.generate_context_encoding_buckets(cfg) == jab.generate_context_encoding_buckets(cfg)
        assert tab.generate_token_generation_buckets(cfg) == jab.generate_token_generation_buckets(cfg)
        assert tab.generate_chunk_q_buckets(cfg) == jab.generate_chunk_q_buckets(cfg)
    for n in (1, 127, 128, 129, 512, 1000):
        assert tab.get_target_bucket([128, 512, 1024], n) == jab.get_target_bucket([128, 512, 1024], n)
        assert tab.pow2_bucket(n) == jab.pow2_bucket(n)
        assert tab.round_up(n, 64) == jab.round_up(n, 64)
    with pytest.raises(ValueError):
        tab.get_target_bucket([128], 129)


def test_kvcache_update_and_read():
    """Writes past S_max are dropped, seq_id -1 rows land in the garbage
    line, and reads slice (batch, bucket). JAX drops out-of-range writes;
    the port redirects them to position 0 of the garbage line, so the
    garbage line is compared everywhere but there."""
    L, B, S_max, H, D = 2, 3, 16, 2, 4
    rng = np.random.RandomState(2)
    jc = jkv.init_cache(L, B, S_max, H, D, dtype=jnp.float32)
    tc = tkv.init_cache(L, B, S_max, H, D, dtype=torch.float32, device="cpu")
    assert tuple(tc.k.shape) == jc.k.shape == (L, B + 1, S_max, H, D)
    assert tkv.kv_batch_size(tc) == jkv.kv_batch_size(jc) == B
    seq_ids = np.array([2, -1, 0], np.int32)
    np.testing.assert_array_equal(
        tkv.slot_ids_from_seq_ids(_t(seq_ids), B).numpy(),
        np.asarray(jkv.slot_ids_from_seq_ids(jnp.asarray(seq_ids), B)),
    )
    slots = np.asarray(jkv.slot_ids_from_seq_ids(jnp.asarray(seq_ids), B))
    positions = np.array([[12, 13, 14, 15, 16, 17], [0, 1, 2, 3, 4, 5], [3, 4, 5, 6, 7, 8]], np.int32)
    k_new = rng.randn(B, 6, H, D).astype(np.float32)
    v_new = rng.randn(B, 6, H, D).astype(np.float32)
    jk, jv = jkv.update_cache_at_layer(
        jc.k, jc.v, jnp.asarray(k_new), jnp.asarray(v_new), 1, jnp.asarray(slots), jnp.asarray(positions)
    )
    tk, tv = tkv.update_cache_at_layer(tc.k, tc.v, _t(k_new), _t(v_new), 1, _t(slots), _t(positions))
    assert tk is tc.k and tv is tc.v  # updated in place
    for t_arr, j_arr in ((tk, jk), (tv, jv)):
        t_np, j_np = t_arr.numpy(), np.asarray(j_arr)
        np.testing.assert_array_equal(t_np[:, :B], j_np[:, :B])
        np.testing.assert_array_equal(t_np[:, B, 1:], j_np[:, B, 1:])
    # the -1 row's values sit in the garbage line; line 1 stays empty
    np.testing.assert_array_equal(tk.numpy()[1, B, 1:6], k_new[1, 1:6])
    assert not tk.numpy()[:, 1].any()
    for bucket in (8, 16):
        rk, rv = tkv.read_cache_at_layer(tk, tv, 1, B, bucket)
        jrk, jrv = jkv.read_cache_at_layer(jk, jv, jnp.int32(1), B, bucket)
        np.testing.assert_array_equal(rk.numpy(), np.asarray(jrk))
        np.testing.assert_array_equal(rv.numpy(), np.asarray(jrv))


def test_sampling_greedy_and_padded_logits():
    rng = np.random.RandomState(3)
    logits = rng.randn(3, 2, 10).astype(np.float32)
    logits[0, 0, 2] = logits[0, 0, 5] = 9.0  # a tie: both take the first maximum
    logits[1, 1, 8] = 50.0  # the largest value sits in the padded tail
    ref = np.asarray(jsamp.mask_padded_logits(jnp.asarray(logits), 7))
    out = tsamp.mask_padded_logits(_t(logits), 7)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (out.numpy()[..., 7:] == np.finfo(np.float32).min).all()
    np.testing.assert_array_equal(
        tsamp.greedy_sample(out).numpy(), np.asarray(jsamp.greedy_sample(jnp.asarray(ref)))
    )
    np.testing.assert_array_equal(
        tsamp.sample_tokens(out, None).numpy(),
        np.asarray(jsamp.sample_tokens(jnp.asarray(ref), jnp.zeros((3, 3)), None, 256, False)),
    )
    # without a generator a sampling call decodes greedily, as the
    # reference's does without a key
    np.testing.assert_array_equal(
        tsamp.sample_tokens(out, _t(np.ones((3, 3), np.float32)), None, do_sample=True).numpy(),
        np.asarray(jsamp.sample_tokens(jnp.asarray(ref), jnp.ones((3, 3)), None, 256, True)),
    )


def test_sampling_params():
    for args in ((2,), (2, 5, 0.9, 0.7), (3, [1, 2, 3], None, [1.0, 0.5, 0.0])):
        np.testing.assert_array_equal(
            tsamp.prepare_sampling_params(*args), jsamp.prepare_sampling_params(*args)
        )
    for bad in ([[0, 1.0, 1.0]], [[1, 0.0, 1.0]], [[1, 1.0, -1.0]], [[300, 1.0, 1.0]]):
        arr = np.asarray(bad, np.float32)
        with pytest.raises(ValueError):
            jsamp.validate_sampling_params(arr, 256)
        with pytest.raises(ValueError):
            tsamp.validate_sampling_params(arr, 256)
    tsamp.validate_sampling_params(tsamp.prepare_sampling_params(2), 256)
