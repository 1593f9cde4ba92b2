"""GPT-OSS in the port, held against the JAX package (and HF
``transformers``' ``GptOssForCausalLM`` built in-process from a seed) on the
CPU at fp32: hidden 64, 4 layers alternating sliding / global (window 4),
4 q / 2 kv heads of 64 (the kernels' head dims), 4 experts top-2, vocab 128.

- ``generate()`` on the interleaved cache (the sliding layers on rings of W
  slots, the global layers on full-length lines): prompts past the window,
  decode across the wrap; tokens identical to JAX's and HF's, logits within
  1e-4 of JAX's; the cache's per-layer sizing and its bytes;
- the contiguous (ring) and paged ``ServingSession``, the reference's
  ``test_gpt_oss_class_serving_session`` cases: streams equal to isolated
  ``generate()`` runs and to the JAX session's; the paged pool with chunked
  prefill takes the layer groups' masks and the sinks on every pass;
- the weight carry of the stacked layer tree (sinks, biases, router and
  expert biases), random params, and the refusals."""

import jax
import numpy as np
import pytest
import torch
from transformers import GptOssConfig, GptOssForCausalLM

from neuronx_distributed_inference_tpu.config import ChunkedPrefillConfig as JaxChunked
from neuronx_distributed_inference_tpu.config import TpuConfig
from neuronx_distributed_inference_tpu.models.gpt_oss import GptOssInferenceConfig as JaxGptOssConfig
from neuronx_distributed_inference_tpu.runtime.application import TpuModelForCausalLM
from neuronx_distributed_inference_tpu.runtime.serving import ServingSession as JaxSession
from neuronx_distributed_inference_tpu_torch.config import ChunkedPrefillConfig, Config, MoEConfig
from neuronx_distributed_inference_tpu_torch.models.base import (
    PHASE_CONTEXT_ENCODING,
    LayerGroupSpec,
    embed,
    lm_head,
    run_decoder_layers,
)
from neuronx_distributed_inference_tpu_torch.models.builder import params_from_jax
from neuronx_distributed_inference_tpu_torch.models.gpt_oss import GptOssInferenceConfig
from neuronx_distributed_inference_tpu_torch.modules.kvcache import (
    InterleavedKVCache,
    KVCache,
    cache_streams,
    kv_batch_size,
)
from neuronx_distributed_inference_tpu_torch.ops import _cuda
from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM
from neuronx_distributed_inference_tpu_torch.runtime.serving import ServingSession

W = 4
HF_CFG = dict(
    vocab_size=128, hidden_size=64, intermediate_size=64, num_hidden_layers=4, num_attention_heads=4,
    num_key_value_heads=2, head_dim=64, num_local_experts=4, num_experts_per_tok=2, sliding_window=W,
    max_position_embeddings=256, rope_scaling=None, attn_implementation="eager", eos_token_id=None,
    pad_token_id=0, tie_word_embeddings=False,
)
GEN = dict(batch_size=2, seq_len=64, dtype="float32", output_logits=True)
SERVE = dict(is_continuous_batching=True, batch_size=3, ctx_batch_size=1, seq_len=64, dtype="float32")
PAGED = dict(is_block_kv_layout=True, pa_block_size=16, pa_num_blocks=16, is_chunked_prefill=True)
PROMPTS = np.array([[5, 17, 92, 41, 33, 88, 2, 11, 64, 3], [7, 8, 9, 10, 11, 12, 0, 0, 0, 0]])
MASK = np.array([[1] * 10, [1] * 6 + [0] * 4])
N_NEW = 10
ATOL = 1e-4
REQS = {"short": [5, 17, 92, 41], "long": list(range(30, 44)), "mid": [64, 3, 27, 9, 14, 33]}


@pytest.fixture(scope="module")
def hf_model():
    torch.set_num_threads(1)
    cfg = GptOssConfig(**HF_CFG)
    torch.manual_seed(3)
    hf = GptOssForCausalLM(cfg).eval().float()
    return cfg, hf, {k: v.float().numpy() for k, v in hf.state_dict().items()}


def _loader(cfg):
    def load(c):
        c.model_type = "gpt_oss"
        for k, v in cfg.to_dict().items():
            setattr(c, k, v)

    return load


def _jax_app(cfg, sd, **kw):
    kw = {**GEN, **kw}
    chunked = kw.pop("chunked", None)
    if chunked:
        kw["chunked_prefill_config"] = JaxChunked(**chunked)
    return TpuModelForCausalLM(None, JaxGptOssConfig(TpuConfig(**kw), load_config=_loader(cfg))).load(state_dict=sd)


def _port_cfg(cfg, **kw):
    kw = {**GEN, **kw}
    chunked = kw.pop("chunked", None)
    if chunked:
        kw["chunked_prefill_config"] = ChunkedPrefillConfig(**chunked)
    return GptOssInferenceConfig(MoEConfig(**kw, device="cpu"), load_config=_loader(cfg))


def _port_app(cfg, sd=None, params=None, **kw):
    app = ModelForCausalLM(None, _port_cfg(cfg, **kw))
    return app.load(params=params) if params is not None else app.load(state_dict=sd)


def _same(port_out, jax_out):
    np.testing.assert_array_equal(port_out.sequences, np.asarray(jax_out.sequences))
    np.testing.assert_allclose(port_out.logits, np.asarray(jax_out.logits), atol=ATOL, rtol=0)


def test_interleaved_generate_matches_jax_and_hf(hf_model):
    cfg, hf, sd = hf_model
    jax_app, port = _jax_app(cfg, sd), _port_app(cfg, sd)
    spec = port.spec
    assert spec.ring_window == W and spec.attn.has_sink and spec.attn.qkv_bias and spec.attn.o_bias
    assert spec.layer_groups == tuple(LayerGroupSpec(1, w) for w in (W, None, W, None))
    cache = port.kv_cache
    assert isinstance(cache, InterleavedKVCache)
    assert cache.k_ring.shape[:3] == (2, 3, W) and cache.k_full.shape[:3] == (2, 3, 64)
    # no k / v alias of one stack: a caller that takes them for the whole
    # cache fails loudly; whole-cache operations see every stream
    assert not hasattr(cache, "k") and not hasattr(cache, "v") and kv_batch_size(cache) == 2
    assert cache_streams(cache) == (cache.k_full, cache.v_full, cache.k_ring, cache.v_ring)
    # the sliding layers hold W of the 64 positions: (2 * 64 + 2 * 4) / (4 * 64)
    assert port.kv_cache_nbytes == 2 * 2 * 3 * (64 + W) * 2 * 64 * 4
    _cuda.reset_launch_counts()
    out = port.generate(PROMPTS, MASK, max_new_tokens=N_NEW)
    assert _cuda.launch_counts() == {n: 0 for n in _cuda.KERNELS}
    _same(out, jax_app.generate(PROMPTS, MASK, max_new_tokens=N_NEW))
    want = hf.generate(input_ids=torch.tensor(PROMPTS[:1]), max_new_tokens=N_NEW, do_sample=False, pad_token_id=0)
    np.testing.assert_array_equal(out.sequences[:1], want.numpy())


def test_hf_parity_logits(hf_model):
    """The prefill logits of every position against HF's forward (the
    reference's tests/test_model_hub2.py::test_gpt_oss_hf_parity), through
    one context pass of the port's plain masked path and of B2's wrapper
    (its CPU plain version folds the sinks through (m, l))."""
    cfg, hf, sd = hf_model
    ids = PROMPTS[:1]
    with torch.no_grad():
        want = hf(torch.tensor(ids)).logits.float().numpy()
    for flash in (None, False):
        app = _port_app(cfg, sd, batch_size=1, attn_kernel_enabled=flash)
        inputs, _ = app.context_encoding_model.prepare(
            ids, np.ones_like(ids), np.arange(10)[None].astype(np.int32), np.array([0], np.int32)
        )
        with torch.no_grad():
            h = embed(app.params, inputs.input_ids)
            h, _ = run_decoder_layers(
                app.params, h, app.kv_cache, inputs, spec=app.spec, phase=PHASE_CONTEXT_ENCODING,
                mlp_fn=app.builder.mlp_fn(),
            )
            logits = lm_head(app.params, h, app.spec)[..., : app.spec.vocab_size].numpy()
        np.testing.assert_allclose(logits[:, :10], want, atol=ATOL, rtol=0)


def _drive(sess):
    items = list(REQS.items())
    assert sess.add_request(items[0][0], items[0][1], max_new_tokens=6)
    sess.step()
    for rid, p in items[1:]:
        assert sess.add_request(rid, p, max_new_tokens=6)
    return sess.run_to_completion()


@pytest.mark.parametrize("layout", ["contiguous_ring", "paged_chunked"])
def test_serving_session_matches_generate_and_jax(hf_model, layout):
    cfg, _, sd = hf_model
    kw = dict(SERVE)
    if layout == "paged_chunked":
        kw.update(PAGED, chunked=dict(max_num_seqs=2, kernel_q_tile_size=8))
    port = _port_app(cfg, sd, **kw)
    if layout == "paged_chunked":
        assert port.spec.ring_window is None and port.spec.layer_groups is not None
    else:
        assert isinstance(port.kv_cache, InterleavedKVCache)
    gen = _port_app(cfg, sd, batch_size=1)
    golden = {}
    for rid, p in REQS.items():
        ids = np.asarray(p)[None, :]
        golden[rid] = gen.generate(ids, np.ones_like(ids), max_new_tokens=6).sequences[0, ids.shape[1]:].tolist()
    got = _drive(ServingSession(port))
    assert got == golden
    assert got == _drive(JaxSession(_jax_app(cfg, sd, **kw)))


def test_weight_carry_and_random_params(hf_model):
    """The JAX app's stacked layer tree, fetched as numpy, runs in the port
    as it is; the port's random params carry every leaf of it."""
    cfg, _, sd = hf_model
    jax_app = _jax_app(cfg, sd)
    tree = jax.tree.map(np.asarray, jax_app.params)
    port = _port_app(cfg, params=params_from_jax(tree, torch.float32, "cpu"))
    _same(port.generate(PROMPTS, MASK, max_new_tokens=N_NEW), jax_app.generate(PROMPTS, MASK, max_new_tokens=N_NEW))

    def shapes(t):
        return {k: shapes(v) for k, v in t.items()} if isinstance(t, dict) else tuple(t.shape)

    rnd = ModelForCausalLM(None, _port_cfg(cfg)).builder.random_params()
    assert shapes(rnd) == shapes(tree)
    layers = rnd["layers"]
    assert torch.equal(layers["input_layernorm"]["weight"], torch.ones_like(layers["input_layernorm"]["weight"]))
    assert abs(float(layers["mlp"]["experts"]["gate_proj"]["weight"].std()) - 0.05) < 0.005
    assert float(layers["self_attn"]["sink"]["weight"].abs().sum()) > 0


def test_full_length_contiguous_cache_when_the_window_covers_seq_len(hf_model):
    """A window at least seq_len long keeps one plain full-length cache
    with the sliding layers' (then vacuous) masks, as the reference's gate
    does."""
    cfg, _, sd = hf_model
    kw = dict(seq_len=W, context_encoding_buckets=[4], token_generation_buckets=[4])
    port, jax_app = _port_app(cfg, sd, **kw), _jax_app(cfg, sd, **kw)
    assert port.spec.ring_window is None and type(port.kv_cache) is KVCache
    ids, mask = PROMPTS[:, :2], MASK[:, :2]
    _same(port.generate(ids, mask, max_new_tokens=2), jax_app.generate(ids, mask, max_new_tokens=2))


def test_refusals(hf_model):
    cfg, _, sd = hf_model
    # the reference's own refusal: the interleaved stacks carry no scales
    with pytest.raises(NotImplementedError, match="interleaved"):
        _port_app(cfg, sd, kv_cache_dtype="int8")
    # the ragged mixed step keeps refusing layer groups, windows and sinks
    ragged = ServingSession(_port_app(cfg, sd, **SERVE, **PAGED, serving_ragged=True,
                                      chunked=dict(max_num_seqs=2, kernel_q_tile_size=16)))
    assert ragged.add_request("r", [5, 17, 92], max_new_tokens=2)
    with pytest.raises(NotImplementedError, match="layer stacks"):
        ragged.step()
    # chunked attention is ported (it was refused naming A9 until it landed)
    assert Config(device="cpu", attention_chunk_size=8).attention_chunk_size == 8
