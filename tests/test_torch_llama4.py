"""Llama4 text in the port, held against the JAX package (and HF
``transformers``' ``Llama4ForCausalLM`` built in-process from a seed) on the
CPU:

- the JAX oracle's config (``tests/test_model_hub2.py::
  test_llama4_text_hf_parity``: head_dim 16, so the attention kernels'
  wrappers, which take 64 or 128, are off) at ``interleave_moe_layer_step``
  2 (dense / MoE layers interleaved) and 1 (every layer MoE), and a
  head_dim-64 config through the kernels' plain versions: chunk 4 and
  ``floor_scale`` 8 make both the chunk masks and the NoPE temperature
  bite inside 8 + 6 tokens; greedy tokens identical to JAX's and HF's,
  logits within ATOL of JAX's at fp32; bf16 within BF16_ATOL of JAX's bf16
  logits;
- ``apply_rope_interleaved`` and the L2 qk-norm against the reference's;
- int8 weights and an int8 KV cache, as the reference takes them;
- the weight carry from the JAX package, random params per run, the nested
  ``text_config`` flattening;
- the contiguous ``ServingSession`` against the JAX session and
  ``generate()``;
- each reference refusal, with the reference's words."""

import jax
import numpy as np
import pytest
import torch
from transformers import Llama4ForCausalLM, Llama4TextConfig

from neuronx_distributed_inference_tpu.config import MoETpuConfig, TpuConfig
from neuronx_distributed_inference_tpu.models.llama4 import Llama4TextInferenceConfig as JaxLlama4Config
from neuronx_distributed_inference_tpu.modules.rope import apply_rope_interleaved as jax_rope_interleaved
from neuronx_distributed_inference_tpu.runtime.application import TpuModelForCausalLM
from neuronx_distributed_inference_tpu.runtime.serving import ServingSession as JaxSession
from neuronx_distributed_inference_tpu_torch.config import Config, InferenceConfig, MoEConfig
from neuronx_distributed_inference_tpu_torch.models.base import LayerGroupSpec, gated_mlp
from neuronx_distributed_inference_tpu_torch.models.builder import params_from_jax
from neuronx_distributed_inference_tpu_torch.models.llama4 import (
    Llama4TextInferenceConfig,
    Llama4TextModelBuilder,
    _l2_norm,
)
from neuronx_distributed_inference_tpu_torch.modules.rope import apply_rope_interleaved
from neuronx_distributed_inference_tpu_torch.ops import _cuda
from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM
from neuronx_distributed_inference_tpu_torch.runtime.serving import ServingSession

PROMPT = np.array([[5, 17, 92, 41, 33, 88, 2, 11], [64, 3, 27, 9, 14, 0, 0, 0]])
MASK = np.array([[1] * 8, [1] * 5 + [0] * 3])
N_NEW = 6
ATOL = 1e-4
#: bf16 logits of the two packages, each rounding its own bf16 products:
#: about 3x the largest gap measured on test_bf16_matches_jax_within_tolerance's
#: inputs (4.2e-3 at step 2, 4.9e-3 at step 1, every position; typical
#: |logit| 0.17)
BF16_ATOL = 1.5e-2
#: the JAX oracle's config (head_dim 16)
ORACLE = dict(
    vocab_size=128, hidden_size=64, intermediate_size=128, intermediate_size_mlp=256, num_hidden_layers=4,
    num_attention_heads=4, num_key_value_heads=2, head_dim=16, num_local_experts=2, num_experts_per_tok=1,
    attention_chunk_size=4, max_position_embeddings=256, rope_theta=10000.0, rope_scaling=None,
    eos_token_id=None, bos_token_id=None, pad_token_id=0, tie_word_embeddings=False, attention_bias=False,
    use_qk_norm=True, attn_temperature_tuning=True, floor_scale=8, attn_scale=0.1,
)
#: the kernels' head_dim: 4 q / 2 kv heads of 64
WIDE = dict(ORACLE, hidden_size=128, head_dim=64)
KERNELS_OFF = dict(attn_kernel_enabled=False, attn_block_tkg_kernel_enabled=False)
GEN = dict(batch_size=2, seq_len=64, dtype="float32", output_logits=True)


def _hf(cfg: dict, step: int = 1, seed=0, **over):
    torch.manual_seed(seed)
    hf_cfg = Llama4TextConfig(**dict(cfg, interleave_moe_layer_step=step, **over), attn_implementation="eager")
    hf = Llama4ForCausalLM(hf_cfg).eval().float()
    return hf, {k: v.float().numpy() for k, v in hf.state_dict().items()}


def _loader(hf):
    attrs = hf.config.to_dict()

    def load(c):
        c.model_type = "llama4_text"
        for k, v in attrs.items():
            setattr(c, k, v)

    return load


def _jax_app(hf, sd, **kw):
    cfg = JaxLlama4Config(MoETpuConfig(**{**GEN, **kw}), load_config=_loader(hf))
    return TpuModelForCausalLM(None, cfg).load(state_dict=sd)


def _port_cfg(hf, **kw):
    return Llama4TextInferenceConfig(MoEConfig(**{**GEN, **kw}, device="cpu"), load_config=_loader(hf))


def _port_app(hf, sd=None, params=None, **kw):
    app = ModelForCausalLM(None, _port_cfg(hf, **kw))
    return app.load(params=params) if params is not None else app.load(state_dict=sd)


def _same(port_out, jax_out, atol=ATOL):
    np.testing.assert_array_equal(port_out.sequences, np.asarray(jax_out.sequences))
    np.testing.assert_allclose(port_out.logits, np.asarray(jax_out.logits), atol=atol, rtol=0)


def _hf_tokens(hf, n=N_NEW):
    out = []
    for b in range(PROMPT.shape[0]):
        v = int(MASK[b].sum())
        with torch.no_grad():
            seq = hf.generate(torch.tensor(PROMPT[b : b + 1, :v]), max_new_tokens=n, do_sample=False, pad_token_id=0)
        out.append(seq[0, v:].numpy())
    return np.stack(out)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


@pytest.mark.parametrize("step", [2, 1])
def test_oracle_config_matches_jax_and_hf(step):
    """The JAX oracle's config: tokens equal to JAX's and HF's, logits
    within ATOL of JAX's; the plain attention (head_dim 16). Step 2 runs
    single-layer groups of all four layer functions, step 1 a MoE rope run
    and a MoE NoPE layer."""
    hf, sd = _hf(ORACLE, step)
    port = _port_app(hf, sd, **KERNELS_OFF)
    groups = port.spec.layer_groups
    if step == 2:
        assert groups == (LayerGroupSpec(1, None, 4, 0), LayerGroupSpec(1, None, 4, 2),
                          LayerGroupSpec(1, None, 4, 0), LayerGroupSpec(1, None, None, 3))
    else:
        assert groups == (LayerGroupSpec(3, None, 4, 2), LayerGroupSpec(1, None, None, 3))
    out = port.generate(PROMPT, MASK, max_new_tokens=N_NEW)
    _same(out, _jax_app(hf, sd).generate(PROMPT, MASK, max_new_tokens=N_NEW))
    np.testing.assert_array_equal(out.sequences[:, PROMPT.shape[1]:], _hf_tokens(hf))


@pytest.mark.parametrize("step", [2, 1])
def test_kernel_head_dim_matches_jax_and_hf(step):
    """At the kernels' head_dim the same through B2's and B1's wrappers,
    which take their plain versions on the CPU (no launch counted)."""
    hf, sd = _hf(WIDE, step, seed=1)
    port = _port_app(hf, sd)
    _cuda.reset_launch_counts()
    out = port.generate(PROMPT, MASK, max_new_tokens=N_NEW)
    assert _cuda.launch_counts() == {n: 0 for n in _cuda.KERNELS}
    _same(out, _jax_app(hf, sd).generate(PROMPT, MASK, max_new_tokens=N_NEW))
    np.testing.assert_array_equal(out.sequences[:, PROMPT.shape[1]:], _hf_tokens(hf))


@pytest.mark.parametrize("what", ["chunk", "temperature"])
def test_chunk_and_temperature_change_the_logits(what):
    """The oracle's chunk 4 and floor_scale 8 are not idle: a chunk past the
    sequence, or a floor_scale past it, moves the logits by more than 5 x
    ATOL, in both packages alike."""
    over = dict(attention_chunk_size=64) if what == "chunk" else dict(floor_scale=64)
    logits = []
    for o in ({}, over):
        hf, sd = _hf(WIDE, 1, seed=2, **o)
        out = _port_app(hf, sd).generate(PROMPT, MASK, max_new_tokens=N_NEW)
        _same(out, _jax_app(hf, sd).generate(PROMPT, MASK, max_new_tokens=N_NEW))
        logits.append(out.logits)
    assert np.abs(logits[0] - logits[1]).max() > 5 * ATOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_interleaved_and_l2_norm_match_reference(dtype):
    from neuronx_distributed_inference_tpu.modules.rope import rope_cos_sin as jax_cos_sin

    rng = np.random.RandomState(3)
    x = (rng.randn(2, 5, 3, 64) * 2).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 8191]])
    inv = (1.0 / (5e5 ** (np.arange(0, 64, 2) / 64))).astype(np.float32)
    jdt = {"float32": jax.numpy.float32, "bfloat16": jax.numpy.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    cos, sin = (np.asarray(t) for t in jax_cos_sin(jax.numpy.asarray(pos), jax.numpy.asarray(inv)))
    want = np.asarray(jax_rope_interleaved(jax.numpy.asarray(x, jdt), cos, sin).astype(jax.numpy.float32))
    got = apply_rope_interleaved(torch.from_numpy(x).to(tdt), torch.from_numpy(cos), torch.from_numpy(sin))
    assert got.dtype == tdt
    # fp32: sin / cos agree to the last bits; bf16: one bf16 ulp
    tol = 1e-5 if dtype == "float32" else 2 ** -7 * float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)
    # the reference's weightless L2 norm, inlined in its layer
    xf = jax.numpy.asarray(x, jdt).astype(jax.numpy.float32)
    ref = (xf * jax.lax.rsqrt(jax.numpy.mean(xf * xf, -1, keepdims=True) + 1e-6)).astype(jdt)
    got = _l2_norm(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    tol = 1e-6 if dtype == "float32" else 2 ** -7 * float(np.abs(np.asarray(ref, np.float32)).max())
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jax.numpy.float32)), atol=tol, rtol=0)


@pytest.mark.parametrize("step", [2, 1])
def test_bf16_matches_jax_within_tolerance(step):
    hf, sd = _hf(WIDE, step, seed=4)
    out = _port_app(hf, sd, dtype="bfloat16").generate(PROMPT, MASK, max_new_tokens=N_NEW)
    jax_out = _jax_app(hf, sd, dtype="bfloat16").generate(PROMPT, MASK, max_new_tokens=N_NEW)
    np.testing.assert_array_equal(out.sequences, np.asarray(jax_out.sequences))
    np.testing.assert_allclose(out.logits, np.asarray(jax_out.logits, np.float32), atol=BF16_ATOL, rtol=0)


@pytest.mark.parametrize(
    "kw",
    [dict(quantized=True), dict(weight_dtype="int4"), dict(kv_cache_dtype="int8", attn_kernel_enabled=False),
     dict(fused_shared_experts=True)],
    ids=["int8_weights", "int4_weights", "int8_kv", "fused_shared_experts"],
)
def test_quantized_settings_match_jax(kw):
    """int8 and int4 weights (both packages' quantize-at-load walks no layer
    list, so only the lm head quantizes), the int8 KV cache (decode through
    B1's code mode) and the shared expert's fused gate / up projection. The int8 cache's running absmax takes every write in range,
    the prompt's bucket padding too, and a padded query inside a chunk of
    padding sees no valid key: B2 gives it zeros, the reference's native
    prefill a uniform softmax (ROADMAP C), so that padding's K differs and
    so would the scale. Both packages prefill through the plain path here."""
    hf, sd = _hf(WIDE, 2, seed=5)
    _same(_port_app(hf, sd, **kw).generate(PROMPT, MASK, max_new_tokens=N_NEW),
          _jax_app(hf, sd, **kw).generate(PROMPT, MASK, max_new_tokens=N_NEW))


@pytest.mark.parametrize("step", [2, 1])
def test_weight_carry_and_random_params(step):
    """The JAX app's per-run params, fetched as numpy, run in the port as
    they are; the port's random params have the same runs and leaves,
    norms ones."""
    hf, sd = _hf(WIDE, step, seed=6)
    jax_app = _jax_app(hf, sd)
    tree = jax.tree.map(np.asarray, jax_app.params)
    port = _port_app(hf, params=params_from_jax(tree, torch.float32, "cpu"))
    _same(port.generate(PROMPT, MASK, max_new_tokens=N_NEW), jax_app.generate(PROMPT, MASK, max_new_tokens=N_NEW))

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [shapes(v) for v in t]
        return tuple(t.shape)

    rnd = port.builder.random_params()
    assert shapes(rnd) == shapes(tree)
    assert len(rnd["layers"]) == len(port.builder.runs)
    for group in rnd["layers"]:
        for name in ("input_layernorm", "post_attention_layernorm"):
            assert torch.equal(group[name]["weight"], torch.ones_like(group[name]["weight"]))
    # the four layer / MLP functions, picked by each run's fn_idx
    mlps = port.builder.mlp_fn()
    assert mlps[0] is gated_mlp and mlps[1] is gated_mlp and mlps[2] is mlps[3] is not gated_mlp
    layers = port.builder.layer_fn()
    assert [f.keywords["use_rope"] for f in layers] == [True, False, True, False]


def test_nested_text_config_is_flattened():
    """A conditional-generation config carries the decoder's fields in
    text_config: the config class and the builder (on a plain
    InferenceConfig) both flatten them, as the reference's do."""
    hf, sd = _hf(WIDE, 1, seed=7)
    attrs = hf.config.to_dict()

    def nested(c):
        c.model_type = "llama4"
        c.text_config = dict(attrs)

    port = ModelForCausalLM(None, Llama4TextInferenceConfig(Config(**GEN, device="cpu"), load_config=nested))
    plain = InferenceConfig(Config(**GEN, device="cpu"), load_config=nested)
    assert not hasattr(plain, "hidden_size")
    builder = Llama4TextModelBuilder(plain)
    assert plain.hidden_size == attrs["hidden_size"] and builder.runs == port.builder.runs
    assert port.config.attention_chunk_size == 4 and port.spec.layer_groups == builder.model_spec().layer_groups
    jax_cfg = JaxLlama4Config(TpuConfig(**GEN), load_config=nested)
    for name in ("hidden_size", "num_hidden_layers", "num_local_experts", "floor_scale", "no_rope_layers"):
        assert getattr(port.config, name) == getattr(jax_cfg, name), name
    _same(port.load(state_dict=sd).generate(PROMPT, MASK, max_new_tokens=N_NEW),
          _jax_app(hf, sd).generate(PROMPT, MASK, max_new_tokens=N_NEW))


def test_serving_session_matches_jax_and_generate():
    """The contiguous ServingSession (the paged cache is refused): each
    request's stream equals its isolated generate() and the JAX session's;
    the 14-token request crosses chunk and temperature boundaries."""
    hf, sd = _hf(WIDE, 2, seed=8)
    kw = dict(is_continuous_batching=True, batch_size=3, ctx_batch_size=1, output_logits=False)
    serve = _port_app(hf, sd, **kw)
    gen = _port_app(hf, params=serve.params, batch_size=1, output_logits=False)
    reqs = {"a": [5, 17, 92, 41], "b": list(range(30, 44)), "c": [64, 3, 27, 9, 14, 33]}
    got, jax_got = {}, {}
    for sess, out in ((ServingSession(serve), got), (JaxSession(_jax_app(hf, sd, **kw)), jax_got)):
        for rid, p in reqs.items():
            assert sess.add_request(rid, p, max_new_tokens=6)
        out.update(sess.run_to_completion())
    assert got == jax_got
    for rid, p in reqs.items():
        assert got[rid] == gen.generate(np.array([p]), max_new_tokens=6).sequences[0, len(p):].tolist(), rid


@pytest.mark.parametrize(
    "kw, why",
    [
        (dict(is_block_kv_layout=True, is_continuous_batching=True, pa_block_size=16, pa_num_blocks=16), "paged cache"),
        (dict(fused_qkv=True), "fused_qkv"),
        (dict(enable_fused_speculation=True, speculation_length=2), "fused speculation"),
    ],
    ids=["paged", "fused_qkv", "fused_speculation"],
)
def test_reference_refusals(kw, why):
    """The reference's refusals, word for word, in both packages."""
    hf, _ = _hf(ORACLE, 1, seed=9)
    want = f"Llama4 with {why} is not implemented"
    with pytest.raises(NotImplementedError, match=want):
        ModelForCausalLM(None, _port_cfg(hf, **kw))
    with pytest.raises(NotImplementedError, match=want):
        TpuModelForCausalLM(None, JaxLlama4Config(TpuConfig(**{**GEN, **kw}), load_config=_loader(hf)))
