"""DeepSeek-V3 in the port, held against the JAX package (and HF
``transformers``' ``DeepseekV3ForCausalLM`` built in-process from a seed) on
the CPU at fp32: greedy tokens identical to JAX's (and HF's), logits within
ATOL of JAX's.

- the configs of the three JAX oracles (``tests/test_model_hub2.py``:
  ``test_deepseek_v3_hf_parity[False|True]``, q_lora_rank 24, 1 dense + 2
  MoE layers, and ``test_deepseek_fused_shared_experts_parity``, q_lora_rank
  None, 2 shared experts), both ``rope_interleave`` cases, the fused shared
  experts equal to the separate layout;
- a seeded nonzero ``e_score_correction_bias`` (it changes the selected
  experts), the published YaRN ``rope_scaling`` (port equal to JAX; HF's
  cos / sin factor differs, ROADMAP C), bf16 within BF16_ATOL of fp32;
- the per-group layer functions in every program: a windowed prefill and
  a generate() past a decode chunk, the MoE route counts per group;
- the latent cache's shapes and bytes, the contiguous ``ServingSession``,
  random params, the weight carry from the JAX package, and each refusal's
  message;
- MLA on the int8 and e4m3 latent caches: ``generate()`` on the oracle
  config (both ``rope_interleave`` cases) and the contiguous
  ``ServingSession`` against JAX's, the streams' (L, 1) scales within
  SCALE_RTOL and their codes byte for byte from one write of the same
  values, the rope keys seeded on ten times the latent's range."""

import jax
import numpy as np
import pytest
import torch
from transformers.models.deepseek_v3 import DeepseekV3Config, DeepseekV3ForCausalLM

from neuronx_distributed_inference_tpu.config import MoETpuConfig
from neuronx_distributed_inference_tpu.models.deepseek import DeepseekV3InferenceConfig as JaxDeepseekConfig
from neuronx_distributed_inference_tpu.runtime.application import TpuModelForCausalLM
from neuronx_distributed_inference_tpu_torch.config import MoEConfig
from neuronx_distributed_inference_tpu_torch.models.base import LayerGroupSpec, gated_mlp
from neuronx_distributed_inference_tpu_torch.models.builder import params_from_jax
from neuronx_distributed_inference_tpu_torch.models.deepseek import DeepseekV3InferenceConfig
from neuronx_distributed_inference_tpu_torch.modules import kvcache as tkv
from neuronx_distributed_inference_tpu_torch.modules.kvcache import KVCache, QuantizedKV
from neuronx_distributed_inference_tpu_torch.modules.moe import router_top_k
from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM
from neuronx_distributed_inference_tpu_torch.runtime.serving import ServingSession, SpeculativeServingSession

PROMPT = np.array([[5, 17, 92, 41, 33, 88, 2, 11], [64, 3, 27, 9, 14, 0, 0, 0]])
MASK = np.array([[1] * 8, [1] * 5 + [0] * 3])
N_NEW = 6
ATOL = 1e-4
#: the port's bf16 logits against JAX's fp32 ones: about 3x the largest gap
#: measured on test_bf16_within_tolerance_of_fp32's inputs (3.8e-3, every
#: position; typical |logit| 0.13)
BF16_ATOL = 1.2e-2
GEN = dict(batch_size=2, seq_len=64, dtype="float32", output_logits=True)
#: test_deepseek_v3_hf_parity's config
ORACLE = dict(
    vocab_size=128, hidden_size=64, intermediate_size=96, moe_intermediate_size=32, num_hidden_layers=3,
    num_attention_heads=4, num_key_value_heads=4, n_shared_experts=1, n_routed_experts=4,
    routed_scaling_factor=2.5, kv_lora_rank=16, q_lora_rank=24, qk_rope_head_dim=8, v_head_dim=16,
    qk_nope_head_dim=16, n_group=2, topk_group=1, num_experts_per_tok=2, first_k_dense_replace=1,
    norm_topk_prob=True, attention_bias=False, rms_norm_eps=1e-5, max_position_embeddings=256,
    eos_token_id=None, bos_token_id=None, tie_word_embeddings=False,
)
#: test_deepseek_fused_shared_experts_parity's config
SHARED2 = dict(
    ORACLE, num_hidden_layers=2, n_shared_experts=2, routed_scaling_factor=1.0, q_lora_rank=None,
    n_group=1, topk_group=1, first_k_dense_replace=0, rope_interleave=False,
)
#: the published config's rope_scaling
#: the quantized streams' scales against JAX's: the two frameworks' fp32
#: latents differ in the last bits (ROADMAP C), as on the Llama cache
SCALE_RTOL = 1e-5
#: codes of a whole generate() against JAX's: a code may differ by one step
#: where the two frameworks' fp32 values straddle a rounding midpoint, at
#: most this share of them (one write of the same values matches byte for
#: byte, test_quantized_latent_write_matches_jax)
CODE_FLIP_SHARE = 1e-3
YARN = dict(type="yarn", factor=40, mscale=1.0, mscale_all_dim=1.0, original_max_position_embeddings=4096,
            beta_fast=32, beta_slow=1)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


def _hf(cfg, seed=0, bias_seed=None):
    torch.manual_seed(seed)
    hf = DeepseekV3ForCausalLM(DeepseekV3Config(**cfg)).eval().float()
    if bias_seed is not None:
        rng = np.random.RandomState(bias_seed)
        for name, b in hf.named_buffers():
            if name.endswith("e_score_correction_bias"):
                b.copy_(torch.from_numpy(rng.randn(*b.shape).astype(np.float32) * 0.5))
    return hf, {k: v.float().numpy() for k, v in hf.state_dict().items()}


def _loader(hf):
    attrs = hf.config.to_dict()

    def load(c):
        c.model_type = "deepseek_v3"
        for k, v in attrs.items():
            setattr(c, k, v)

    return load


def _jax_app(hf, sd, **kw):
    cfg = JaxDeepseekConfig(MoETpuConfig(**{**GEN, **kw}), load_config=_loader(hf))
    return TpuModelForCausalLM(None, cfg).load(state_dict=sd)


def _port_cfg(hf, **kw):
    return DeepseekV3InferenceConfig(MoEConfig(**{**GEN, **kw}, device="cpu"), load_config=_loader(hf))


def _port_app(hf, sd=None, params=None, **kw):
    app = ModelForCausalLM(None, _port_cfg(hf, **kw))
    return app.load(params=params) if params is not None else app.load(state_dict=sd)


def _same(port_out, jax_out, atol=ATOL):
    np.testing.assert_array_equal(port_out.sequences, np.asarray(jax_out.sequences))
    np.testing.assert_allclose(port_out.logits, np.asarray(jax_out.logits), atol=atol, rtol=0)


def _hf_run(hf, n=N_NEW):
    """HF's per-row unpadded greedy tokens and logits."""
    seqs, logits = [], []
    for b in range(PROMPT.shape[0]):
        v = int(MASK[b].sum())
        with torch.no_grad():
            out = hf.generate(torch.tensor(PROMPT[b : b + 1, :v]), max_new_tokens=n, do_sample=False,
                              output_logits=True, return_dict_in_generate=True, pad_token_id=0)
        seqs.append(out.sequences[0, v:].numpy())
        logits.append(torch.stack(out.logits, dim=1)[0].numpy())
    return np.stack(seqs), np.stack(logits)


@pytest.mark.parametrize("rope_interleave", [False, True])
def test_oracle_config_matches_jax_and_hf(rope_interleave):
    """test_deepseek_v3_hf_parity's config: tokens equal to JAX's and HF's,
    logits within ATOL of JAX's (and the oracle's 2e-3 of HF's)."""
    hf, sd = _hf(dict(ORACLE, rope_interleave=rope_interleave))
    port = _port_app(hf, sd)
    assert port.spec.layer_groups == (LayerGroupSpec(1, fn_idx=0), LayerGroupSpec(2, fn_idx=1))
    out = port.generate(PROMPT, MASK, max_new_tokens=N_NEW)
    _same(out, _jax_app(hf, sd).generate(PROMPT, MASK, max_new_tokens=N_NEW))
    seq, logits = _hf_run(hf)
    np.testing.assert_array_equal(out.sequences[:, PROMPT.shape[1]:], seq)
    np.testing.assert_allclose(out.logits, logits, atol=2e-3, rtol=2e-3)


def test_fused_shared_experts_equal_separate_and_jax():
    """test_deepseek_fused_shared_experts_parity's config (q_lora_rank None,
    2 shared experts): the fused gate_up layout equals the separate one
    (2e-5, the oracle's bound) and JAX's fused run."""
    hf, sd = _hf(SHARED2, seed=2)
    outs = {}
    for fused in (False, True):
        port = _port_app(hf, sd, fused_shared_experts=fused)
        shared = port.params["layers"][0]["mlp"]["shared_experts"]
        assert ("gate_up_proj" in shared) == fused
        outs[fused] = port.generate(PROMPT, MASK, max_new_tokens=5)
    np.testing.assert_array_equal(outs[True].sequences, outs[False].sequences)
    np.testing.assert_allclose(outs[True].logits, outs[False].logits, atol=2e-5, rtol=2e-5)
    _same(outs[True], _jax_app(hf, sd, fused_shared_experts=True).generate(PROMPT, MASK, max_new_tokens=5))


def test_nonzero_correction_bias_changes_selection_and_matches_jax():
    """A seeded nonzero e_score_correction_bias (the random params zero it)
    in both packages: it changes the experts the router selects, and the
    port equals JAX and HF with it."""
    hf, sd = _hf(ORACLE, seed=3, bias_seed=11)
    port = _port_app(hf, sd)
    router = port.params["layers"][1]["mlp"]["router"]
    bias = router["e_score_correction_bias"]
    assert float(bias.abs().min()) > 0
    x = port.params["embed_tokens"]["weight"][:64]
    logits = x.float() @ router["weight"].float()
    spec = port.builder.moe_spec()
    assert spec.scoring_func == "sigmoid" and spec.n_group == 2 and spec.routed_scaling_factor == 2.5
    _, with_bias = router_top_k(logits, spec, correction_bias=bias.float())
    _, without = router_top_k(logits, spec)
    assert not torch.equal(with_bias, without)
    out = port.generate(PROMPT, MASK, max_new_tokens=N_NEW)
    _same(out, _jax_app(hf, sd).generate(PROMPT, MASK, max_new_tokens=N_NEW))
    np.testing.assert_array_equal(out.sequences[:, PROMPT.shape[1]:], _hf_run(hf)[0])


def test_published_yarn_scaling_matches_jax():
    """DeepSeek-V3's published rope_scaling (YaRN, factor 40): the port
    equals JAX. cos / sin carry yarn_mscale(40, mscale=1) = 1.369 in both
    (the reference's rope_attention_scaling); HF's DeepseekV3 applies 1.0
    there (its mscale / mscale_all_dim ratio), so both packages stand
    apart from HF by the same amount (ROADMAP C)."""
    hf, sd = _hf(dict(ORACLE, rope_scaling=YARN, max_position_embeddings=163840), seed=4)
    port = _port_app(hf, sd)
    assert abs(port.spec.attention_scaling - (0.1 * np.log(40) + 1)) < 1e-12
    mla = port.builder.mla_spec()
    assert abs(mla.scale - (0.1 * np.log(40) + 1) ** 2 / np.sqrt(24)) < 1e-12
    out = port.generate(PROMPT, MASK, max_new_tokens=N_NEW)
    jax_out = _jax_app(hf, sd).generate(PROMPT, MASK, max_new_tokens=N_NEW)
    _same(out, jax_out)
    hf_logits = _hf_run(hf)[1]
    gap_port = np.abs(out.logits[:, 0] - hf_logits[:, 0]).max()
    gap_jax = np.abs(np.asarray(jax_out.logits)[:, 0] - hf_logits[:, 0]).max()
    assert abs(gap_port - gap_jax) < 1e-4 and gap_port > 1e-3


def test_bf16_within_tolerance_of_fp32():
    """bf16 against fp32: the JAX package's bf16 MLA does not run on the
    CPU (XLA's CPU dot takes no BF16 x BF16 = F32 product), so the port's
    bf16 logits are held within BF16_ATOL of JAX's fp32 ones at every
    generated position, with the same greedy tokens."""
    hf, sd = _hf(ORACLE, seed=5)
    out = _port_app(hf, sd, dtype="bfloat16").generate(PROMPT, MASK, max_new_tokens=N_NEW)
    jax_out = _jax_app(hf, sd).generate(PROMPT, MASK, max_new_tokens=N_NEW)
    np.testing.assert_array_equal(out.sequences, np.asarray(jax_out.sequences))
    np.testing.assert_allclose(out.logits, np.asarray(jax_out.logits), atol=BF16_ATOL, rtol=0)


def test_group_functions_in_every_program():
    """A prompt longer than max_context_length prefills in windows (the
    context program, then a multi-token token-generation pass), and 20 new
    tokens cross decode chunks with an EOS given (chunks of 8): every
    program runs the dense MLP on group 0 and the MoE block on group 1
    (1 and 2 calls a pass), equal to JAX."""
    hf, sd = _hf(ORACLE, seed=6)
    kw = dict(max_context_length=8, context_encoding_buckets=[8], token_generation_buckets=[32, 64])
    port = _port_app(hf, sd, **kw)
    calls = {"dense": 0, "moe": 0}

    def counted(fn, name):
        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)

        return run

    for runner in port.runners:
        dense, moe = runner.mlp_fn
        assert dense is gated_mlp
        runner.mlp_fn = [counted(dense, "dense"), counted(moe, "moe")]
    ids = np.tile(np.arange(3, 15), (2, 1))
    mask = np.ones_like(ids)
    mask[1, 10:] = 0
    eos = 127
    out = port.generate(ids, mask, max_new_tokens=20, eos_token_id=eos)
    assert eos not in out.sequences[:, ids.shape[1]:]
    # 2 prefill passes + 3 decode chunks of 8 steps (19 tokens after the first)
    assert calls == {"dense": 2 + 3 * 8, "moe": 2 * (2 + 3 * 8)}
    _same(out, _jax_app(hf, sd, **kw).generate(ids, mask, max_new_tokens=20, eos_token_id=eos))


def test_latent_cache_shapes_and_bytes():
    hf, sd = _hf(ORACLE, seed=7)
    port = _port_app(hf, sd)
    cache = port.kv_cache
    assert isinstance(cache, KVCache)
    # (L, B + garbage, seq_len, 1, kv_lora_rank) / (..., 1, qk_rope_head_dim)
    assert tuple(cache.k.shape) == (3, 3, 64, 1, 16) and tuple(cache.v.shape) == (3, 3, 64, 1, 8)
    assert port.kv_cache_nbytes == 3 * 3 * 64 * (16 + 8) * 4
    jax_cache = _jax_app(hf, sd).kv_cache
    assert tuple(cache.k.shape) == jax_cache.k.shape and tuple(cache.v.shape) == jax_cache.v.shape


def test_serving_session_matches_generate():
    """The contiguous ServingSession (the paged cache is refused): each
    request's stream equals its isolated generate(); a request prefilled
    into slot s > 0 reads its own cache line. The JAX session's MLA layer
    reads lines 0..B-1 whatever the rows' slots, so its streams of the
    requests in slots 1 and 2 differ from generate() (ROADMAP C,
    "Reference-side state"); request "a", in slot 0, agrees."""
    from neuronx_distributed_inference_tpu.runtime.serving import ServingSession as JaxSession

    hf, sd = _hf(ORACLE, seed=8)
    kw = dict(is_continuous_batching=True, batch_size=3, ctx_batch_size=1, output_logits=False)
    serve = _port_app(hf, sd, **kw)
    gen = _port_app(hf, params=serve.params, batch_size=1, output_logits=False)
    reqs = {"a": [5, 17, 92, 41], "b": list(range(30, 44)), "c": [64, 3, 27, 9, 14, 33]}
    got, jax_got = {}, {}
    for sess, out in ((ServingSession(serve), got), (JaxSession(_jax_app(hf, sd, **kw)), jax_got)):
        for rid, p in reqs.items():
            assert sess.add_request(rid, p, max_new_tokens=6)
        out.update(sess.run_to_completion())
    for rid, p in reqs.items():
        want = gen.generate(np.array([p]), max_new_tokens=6).sequences[0, len(p):].tolist()
        assert got[rid] == want, rid
        assert (jax_got[rid] == want) == (rid == "a"), rid


def test_weight_carry_and_random_params():
    """The JAX app's per-group params, fetched as numpy, run in the port as
    they are; the port's random params have the same groups and leaves,
    norms ones and the correction bias zeros."""
    hf, sd = _hf(ORACLE, seed=9)
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
    dense, moe = rnd["layers"]
    assert "router" not in dense["mlp"] and set(moe["mlp"]) == {"router", "experts", "shared_experts"}
    for g in (dense, moe):
        for norm in (g["input_layernorm"], g["self_attn"]["kv_a_layernorm"], g["self_attn"]["q_a_layernorm"]):
            assert torch.equal(norm["weight"], torch.ones_like(norm["weight"]))
    assert float(moe["mlp"]["router"]["e_score_correction_bias"].abs().max()) == 0
    assert abs(float(moe["mlp"]["experts"]["gate_proj"]["weight"].std()) - 0.05) < 0.005
    assert port.builder.mlp_fn()[0] is gated_mlp


@pytest.mark.parametrize(
    "kw, match",
    [
        (dict(is_block_kv_layout=True, is_continuous_batching=True), "DeepSeek-V3 MLA with paged cache is not implemented"),
        (dict(fused_qkv=True), "DeepSeek-V3 MLA with fused_qkv is not implemented"),
        (dict(quantized=True), r"ROADMAP A9 \(MLA with quantized weights\)"),
        (dict(weight_dtype="int4"), r"ROADMAP A9 \(MLA with quantized weights\)"),
    ],
)
def test_refusals(kw, match):
    hf, _ = _hf(ORACLE, seed=10)
    with pytest.raises(NotImplementedError, match=match):
        ModelForCausalLM(None, _port_cfg(hf, **kw))


def test_speculation_refusals():
    """Speculation with an MLA target or draft (the split speculative
    session, fused speculation) is refused naming its ROADMAP item; Medusa
    raises the reference's own message."""
    from neuronx_distributed_inference_tpu_torch.config import FusedSpecConfig
    from neuronx_distributed_inference_tpu_torch.runtime.fused_spec import FusedSpecModelForCausalLM
    from neuronx_distributed_inference_tpu_torch.runtime.medusa import MedusaModelForCausalLM

    hf, sd = _hf(ORACLE, seed=10)
    app = _port_app(hf, sd, is_continuous_batching=True, batch_size=2, ctx_batch_size=1, output_logits=False)
    with pytest.raises(NotImplementedError, match=r"ROADMAP A9 \(MLA speculation\)"):
        SpeculativeServingSession(app, app, speculation_length=3)
    spec = dict(speculation_length=3, enable_fused_speculation=True)
    cfg = _port_cfg(hf, **spec)
    cfg.fused_spec_config = FusedSpecConfig(draft_config=_port_cfg(hf))
    with pytest.raises(NotImplementedError, match=r"ROADMAP A9 \(MLA speculation\)"):
        FusedSpecModelForCausalLM(None, cfg)
    with pytest.raises(NotImplementedError, match="medusa over models with custom decoder layers"):
        MedusaModelForCausalLM(None, _port_cfg(hf, medusa_speculation_length=4, num_medusa_heads=3))


# ---------------------------------------------------------------------------
# MLA on the int8 / e4m3 latent cache
# ---------------------------------------------------------------------------


def _code_bytes(t):
    if isinstance(t, torch.Tensor):
        return t.view(torch.uint8).numpy().astype(np.int16)
    return np.asarray(t).view(np.uint8).astype(np.int16)


def _assert_streams_close(port_cache, jax_cache, lines):
    """Each stream's (L, 1) scales within SCALE_RTOL of JAX's; its codes on
    the real lines equal but for one-step flips at rounding midpoints."""
    for ts, js in ((port_cache.k, jax_cache.k), (port_cache.v, jax_cache.v)):
        assert isinstance(ts, QuantizedKV) and tuple(ts.scale.shape) == tuple(js.scale.shape)
        np.testing.assert_allclose(ts.scale.numpy(), np.asarray(js.scale), rtol=SCALE_RTOL, atol=0)
        tb, jb = _code_bytes(ts.data[:, :lines]), _code_bytes(js.data[:, :lines])
        diff = np.abs(tb - jb)
        assert diff.max() <= 1 and (diff > 0).mean() <= CODE_FLIP_SHARE


@pytest.mark.parametrize("rope_interleave", [False, True])
@pytest.mark.parametrize("kvd", ["int8", "fp8"])
def test_quantized_latent_cache_matches_jax(kvd, rope_interleave):
    """generate() on the int8 / e4m3 latent cache: tokens equal to JAX's,
    logits within ATOL, both streams as JAX leaves them."""
    hf, sd = _hf(dict(ORACLE, rope_interleave=rope_interleave))
    port = _port_app(hf, sd, kv_cache_dtype=kvd)
    jax_app = _jax_app(hf, sd, kv_cache_dtype=kvd)
    _same(port.generate(PROMPT, MASK, max_new_tokens=N_NEW), jax_app.generate(PROMPT, MASK, max_new_tokens=N_NEW))
    _assert_streams_close(port.kv_cache, jax_app.kv_cache, PROMPT.shape[0])
    assert float(port.kv_cache.k.scale.min()) > 0 and float(port.kv_cache.v.scale.min()) > 0


@pytest.mark.parametrize("kvd", ["int8", "fp8"])
def test_quantized_latent_write_matches_jax(kvd):
    """One write of the same fp32 latent (width 16) and rope keys (width 8,
    on ten times the latent's range) at layer 1: each stream's codes byte
    for byte and its own (1,) scale equal to JAX's; the rope stream's scale
    is about ten times the latent's, so a shared absmax would show."""
    import jax.numpy as jnp
    from neuronx_distributed_inference_tpu.modules import kvcache as jkv

    rng = np.random.RandomState(3)
    B, S, L = 2, 5, 3
    c = rng.randn(B, S, 1, 16).astype(np.float32)
    pe = (rng.randn(B, S, 1, 8) * 10).astype(np.float32)
    slots, pos = np.array([0, 1], np.int32), np.tile(np.arange(S, dtype=np.int32), (B, 1))
    pos[1, -1] = 64  # out of range: kept out of the scales
    dt = {"int8": (torch.int8, jnp.int8), "fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn)}[kvd]
    port = tkv.init_cache(L, B, 64, 1, 16, dt[0], device="cpu", v_heads=1, v_head_dim=8)
    jc = jkv.init_cache(L, B, 64, 1, 16, dtype=dt[1], v_heads=1, v_head_dim=8)
    tkv.update_cache_at_layer(port.k, port.v, torch.from_numpy(c), torch.from_numpy(pe), 1,
                              torch.from_numpy(slots), torch.from_numpy(pos))
    jk, jv = jkv.update_cache_at_layer(jc.k, jc.v, jnp.asarray(c), jnp.asarray(pe), 1, jnp.asarray(slots),
                                       jnp.asarray(pos))
    for ts, js in ((port.k, jk), (port.v, jv)):
        np.testing.assert_array_equal(_code_bytes(ts.data[:, :B]), _code_bytes(js.data[:, :B]))
        np.testing.assert_array_equal(ts.scale.numpy(), np.asarray(js.scale))
    valid = pos < 64
    ks, vs = float(port.k.scale[1, 0]), float(port.v.scale[1, 0])
    assert ks == float(np.abs(c[valid]).max()) and vs == float(np.abs(pe[valid]).max())
    assert vs > 5 * ks and float(port.k.scale[0].abs().sum() + port.k.scale[2].abs().sum()) == 0


@pytest.mark.parametrize("kvd", ["int8", "fp8"])
def test_quantized_latent_serving_session_matches_jax(kvd):
    """The contiguous ServingSession on one slot (both packages' MLA layers
    then read the same line) over the quantized latent cache: each
    request's stream equal to JAX's, and the scales the requests leave
    (they grow over all three: the scales are never reset)."""
    from neuronx_distributed_inference_tpu.runtime.serving import ServingSession as JaxSession

    hf, sd = _hf(ORACLE, seed=8)
    kw = dict(is_continuous_batching=True, batch_size=1, ctx_batch_size=1, output_logits=False,
              kv_cache_dtype=kvd)
    port, jax_app = _port_app(hf, sd, **kw), _jax_app(hf, sd, **kw)
    reqs = {"a": [5, 17, 92, 41], "b": list(range(30, 44)), "c": [64, 3, 27, 9, 14, 33]}
    got = {ServingSession: {}, JaxSession: {}}
    for app, sess_cls in ((port, ServingSession), (jax_app, JaxSession)):
        sess = sess_cls(app)
        for rid, p in reqs.items():  # one slot: each request in turn
            assert sess.add_request(rid, p, max_new_tokens=6)
            got[sess_cls].update(sess.run_to_completion())
    assert got[ServingSession] == got[JaxSession]
    for ts, js in ((port.kv_cache.k, jax_app.kv_cache.k), (port.kv_cache.v, jax_app.kv_cache.v)):
        np.testing.assert_allclose(ts.scale.numpy(), np.asarray(js.scale), rtol=SCALE_RTOL, atol=0)


@pytest.mark.parametrize("kvd", ["int8", "fp8", "float8_e5m2"])
def test_quantized_latent_cache_bytes(kvd):
    """One byte a latent and a rope value, plus each stream's (L, 1) fp32
    scales: (16 + 8) bytes a token a layer against fp32's 96."""
    hf, sd = _hf(ORACLE, seed=7)
    port = _port_app(hf, sd, kv_cache_dtype=kvd)
    cache = port.kv_cache
    assert tuple(cache.k.shape) == (3, 3, 64, 1, 16) and tuple(cache.v.shape) == (3, 3, 64, 1, 8)
    assert tuple(cache.k.scale.shape) == tuple(cache.v.scale.shape) == (3, 1)
    assert port.kv_cache_nbytes == 3 * 3 * 64 * (16 + 8) + 2 * 3 * 4
