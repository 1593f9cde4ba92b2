"""Assisted decoding over ring caches in the port (``runtime/assisted.py``
``RingSnapshotGuard``), held against the JAX package on the CPU at fp32.

A speculation round writes candidate K/V at ring slots (p + j) mod W,
destroying the live K/V of positions p + j - W; the guard snapshots the
at-risk slots and restores the rejected ones. The oracles are the
reference's tests/test_assisted_ring.py: the guard's unit cases on the
plain, the quantized and the interleaved cache (the same restores as the
JAX guard's), greedy ``assisted_generate`` byte-equal to the target's own
``generate()`` (and to JAX's assisted run) across several ring wraps with a
wrong draft forcing rejections and with the target as its own draft, on the
bounded ring (a Mistral-style window) and on GPT-OSS's interleaved cache; a
sampled run; and the refusal of a round longer than the window."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import GptOssConfig, GptOssForCausalLM

from neuronx_distributed_inference_tpu.config import TpuConfig
from neuronx_distributed_inference_tpu.models.llama import LlamaInferenceConfig as JaxLlamaConfig
from neuronx_distributed_inference_tpu.modules.kvcache import InterleavedKVCache as JaxInterleaved
from neuronx_distributed_inference_tpu.modules.kvcache import KVCache as JaxKVCache
from neuronx_distributed_inference_tpu.runtime.application import TpuModelForCausalLM
from neuronx_distributed_inference_tpu.runtime.assisted import RingSnapshotGuard as JaxGuard
from neuronx_distributed_inference_tpu.runtime.assisted import assisted_generate as jax_assisted
from neuronx_distributed_inference_tpu_torch.config import Config, MoEConfig
from neuronx_distributed_inference_tpu_torch.models.gpt_oss import GptOssInferenceConfig
from neuronx_distributed_inference_tpu_torch.models.llama import LlamaInferenceConfig
from neuronx_distributed_inference_tpu_torch.modules.kvcache import InterleavedKVCache, KVCache, QuantizedKV
from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM
from neuronx_distributed_inference_tpu_torch.runtime.assisted import RingSnapshotGuard, assisted_generate
from tests.conftest import make_random_hf_state_dict

W = 16
HF = dict(
    model_type="llama", hidden_size=128, intermediate_size=128, num_attention_heads=2, num_key_value_heads=1,
    head_dim=64, num_hidden_layers=2, vocab_size=128, rms_norm_eps=1e-5, rope_theta=10000.0,
    max_position_embeddings=256, hidden_act="silu", tie_word_embeddings=False,
)
GEN = dict(batch_size=2, seq_len=64, dtype="float32", sliding_window=W)
PROMPTS = np.array([[5, 17, 92, 41, 33, 88, 2, 11], [64, 3, 27, 9, 0, 0, 0, 0]])
MASK = np.array([[1] * 8, [1, 1, 1, 1, 0, 0, 0, 0]])
N_NEW = 30  # positions cross the W = 16 boundary twice
K = 4


def _load(c):
    for k, v in HF.items():
        setattr(c, k, v)


def _fake(cache, bounded=None, ring=None):
    return types.SimpleNamespace(spec=types.SimpleNamespace(bounded_window=bounded, ring_window=ring), kv_cache=cache)


def _clobber(arrays, pos, n, Wd):
    """The speculative writes of one round: slot (p + j) mod W of row b gets
    50 + 10 b + j (k) and -(50 + 10 b + j) (v); the garbage row is
    scribbled too."""
    slots = (pos[:, None] + np.arange(n)) % Wd
    out = [a.copy() for a in arrays]
    for b in range(len(pos)):
        for j in range(n):
            out[0][:, b, slots[b, j]] = 50 + 10 * b + j
            out[1][:, b, slots[b, j]] = -(50 + 10 * b + j)
    out[0][:, -1, 0] = -5.0
    return out


@pytest.mark.parametrize("quantized", [False, True], ids=["plain", "int8_codes"])
def test_guard_restores_like_reference(quantized):
    L, R, H, D = 2, 3, 2, 4
    rng = np.random.RandomState(0)
    k0, v0 = (rng.randn(L, R, 8, H, D).astype(np.float32) for _ in range(2))
    if quantized:
        k0, v0 = (np.clip(np.round(a * 40), -127, 127).astype(np.int8) for a in (k0, v0))
    pos, n, counts = np.array([6, 13]), 4, np.array([1, 3])

    def port_stream(a):
        t = torch.from_numpy(a.copy())
        return QuantizedKV(data=t, scale=torch.ones(L, H)) if quantized else t

    app = _fake(KVCache(k=port_stream(k0), v=port_stream(v0)), bounded=8)
    guard = RingSnapshotGuard(app, n)
    guard.snapshot(pos)
    k1, v1 = _clobber([k0, v0], pos, n, 8)
    arrays = (app.kv_cache.k.data, app.kv_cache.v.data) if quantized else (app.kv_cache.k, app.kv_cache.v)
    for t, a in zip(arrays, (k1, v1)):
        t.copy_(torch.from_numpy(a))  # in place, as the port's caches are written
    guard.restore(counts)

    jax_app = _fake(JaxKVCache(k=jnp.asarray(k0), v=jnp.asarray(v0)), bounded=8)
    jg = JaxGuard(jax_app, n)
    jg.snapshot(pos)
    jax_app.kv_cache = JaxKVCache(k=jnp.asarray(k1), v=jnp.asarray(v1))
    jg.restore(counts)
    for t, j in zip(arrays, (jax_app.kv_cache.k, jax_app.kv_cache.v)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(arrays[0][:, 2].numpy(), k1[:, 2])  # the garbage row untouched


def test_guard_restores_the_interleaved_ring_stack_only():
    Wd = 4
    rng = np.random.RandomState(1)
    full = rng.randn(1, 2, 16, 2, 4).astype(np.float32)
    ring0 = rng.randn(2, 2, Wd, 2, 4).astype(np.float32)
    cache = InterleavedKVCache(*(torch.from_numpy(a.copy()) for a in (full, full, ring0, ring0)))
    app = _fake(cache, ring=Wd)
    guard = RingSnapshotGuard(app, 3)
    pos = np.array([3])
    guard.snapshot(pos)
    slots = (pos[0] + np.arange(3)) % Wd
    ring1 = ring0.copy()
    ring1[:, 0, slots] = 7.0
    cache.k_ring.copy_(torch.from_numpy(ring1))
    cache.v_ring.copy_(torch.from_numpy(ring1))
    cache.k_full.fill_(3.0)
    guard.restore(np.array([1]))

    jax_app = _fake(JaxInterleaved(*(jnp.asarray(a) for a in (full, full, ring0, ring0))), ring=Wd)
    jg = JaxGuard(jax_app, 3)
    jg.snapshot(pos)
    jax_app.kv_cache = JaxInterleaved(*(jnp.asarray(a) for a in (full, full, ring1, ring1)))
    jg.restore(np.array([1]))
    np.testing.assert_array_equal(cache.k_ring.numpy(), np.asarray(jax_app.kv_cache.k_ring))
    np.testing.assert_array_equal(cache.v_ring.numpy(), np.asarray(jax_app.kv_cache.v_ring))
    assert float(cache.k_full.min()) == 3.0  # the full stack is not the guard's


@pytest.fixture(scope="module")
def sds():
    torch.set_num_threads(1)
    cfg = JaxLlamaConfig(TpuConfig(**GEN), load_config=_load)
    return {seed: make_random_hf_state_dict(cfg, seed=seed) for seed in (0, 7)}


def _port(sd, **kw):
    return ModelForCausalLM(None, LlamaInferenceConfig(Config(**{**GEN, **kw}, device="cpu"), load_config=_load)).load(
        state_dict=sd
    )


def _jax(sd, **kw):
    return TpuModelForCausalLM(None, JaxLlamaConfig(TpuConfig(**{**GEN, **kw}), load_config=_load)).load(state_dict=sd)


@pytest.mark.parametrize("draft_seed", [7, 0], ids=["wrong_draft", "target_as_draft"])
def test_bounded_ring_greedy_assisted_matches_generate_and_jax(sds, draft_seed):
    plain = _port(sds[0])
    assert plain.spec.bounded_window == W
    golden = plain.generate(PROMPTS, MASK, max_new_tokens=N_NEW).sequences
    target, draft = _port(sds[0]), _port(sds[draft_seed])
    out = assisted_generate(target, draft, PROMPTS, MASK, max_new_tokens=N_NEW, speculation_length=K)
    np.testing.assert_array_equal(out.sequences[:, : golden.shape[1]], golden)
    want = jax_assisted(_jax(sds[0]), _jax(sds[draft_seed]), PROMPTS, MASK, max_new_tokens=N_NEW,
                        speculation_length=K)
    np.testing.assert_array_equal(out.sequences, np.asarray(want.sequences))


def test_interleaved_ring_greedy_assisted_matches_generate():
    """GPT-OSS's interleaved cache: the guard restores the sliding layers'
    ring stack; a draft of other weights forces rejections."""
    torch.set_num_threads(1)
    hf_cfg = dict(
        vocab_size=128, hidden_size=64, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=64, num_local_experts=4, num_experts_per_tok=2, sliding_window=8,
        max_position_embeddings=256, rope_scaling=None, attn_implementation="eager", eos_token_id=None,
        pad_token_id=0, tie_word_embeddings=False,
    )
    sds = []
    for seed in (2, 5):
        torch.manual_seed(seed)
        model = GptOssForCausalLM(GptOssConfig(**hf_cfg)).eval().float()
        sds.append({k: v.float().numpy() for k, v in model.state_dict().items()})

    def load(c):
        c.model_type = "gpt_oss"
        for k, v in hf_cfg.items():
            setattr(c, k, v)

    def app(sd):
        cfg = GptOssInferenceConfig(MoEConfig(batch_size=2, seq_len=64, dtype="float32", device="cpu"), load_config=load)
        return ModelForCausalLM(None, cfg).load(state_dict=sd)

    golden = app(sds[0]).generate(PROMPTS, MASK, max_new_tokens=24).sequences
    target = app(sds[0])
    assert isinstance(target.kv_cache, InterleavedKVCache)
    out = assisted_generate(target, app(sds[1]), PROMPTS, MASK, max_new_tokens=24, speculation_length=K)
    np.testing.assert_array_equal(out.sequences[:, : golden.shape[1]], golden)


def test_sampled_assisted_on_the_ring_runs_and_repeats(sds):
    sampling = dict(output_logits=True, seed=3, on_device_sampling_config={"do_sample": True})
    target, draft = _port(sds[0], **sampling), _port(sds[7], **sampling)
    prompts = np.array([[5, 17, 92, 41], [64, 3, 27, 9]])
    run = lambda: assisted_generate(target, draft, prompts, np.ones_like(prompts), max_new_tokens=24,  # noqa: E731
                                    speculation_length=K, temperature=5.0, top_k=50)
    out1 = run()
    gen = out1.sequences[:, 4:]
    assert gen.shape[1] == 24 and gen.min() >= 0 and gen.max() < 128
    # apps built alike draw alike (the k-th call of an app seeds (seed, k))
    fresh_t, fresh_d = _port(sds[0], **sampling), _port(sds[7], **sampling)
    out2 = assisted_generate(fresh_t, fresh_d, prompts, np.ones_like(prompts), max_new_tokens=24,
                             speculation_length=K, temperature=5.0, top_k=50)
    np.testing.assert_array_equal(out1.sequences, out2.sequences)


def test_speculation_longer_than_the_window_raises(sds):
    app = _port(sds[0], sliding_window=4)
    with pytest.raises(ValueError, match="ring window"):
        assisted_generate(app, app, PROMPTS[:, :2], MASK[:, :2], max_new_tokens=4, speculation_length=6)
