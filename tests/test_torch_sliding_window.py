"""Sliding-window attention and attention biases in the port, held against
the JAX package on the CPU at fp32: tiny Mistral (window 4) and Qwen2 (q/k/v
biases) models built in-process by ``transformers`` from a seed, head_dim
64 (the kernels' head dims; their wrappers take their plain versions on
CPU tensors), loaded into both packages from one state dict.

- the windowed masks against the reference's;
- ``generate()`` on the ring-bounded cache (W slots a line), prompts past
  the window and decode across the wrap, eager-fused and split qkv; the
  same with an int8 ring; tokens identical to JAX's (and HF's), logits
  within 1e-4;
- the contiguous ``ServingSession`` (windowed admission into the ring) and
  the paged one with chunked prefill, whose multi-token passes a windowed
  model must keep off B5 (the B5 kernel knows no window: routed there, the
  CPU plain version of B5 ignores the window too, and the tokens part from
  JAX's);
- fused speculation over a windowed target and draft (full-length lines
  with windowed masks: fused speculation keeps position == slot);
- Qwen2's biases (split and fused qkv), and the weight carry of every new
  leaf (``params_from_jax``)."""

import numpy as np
import pytest
import torch
import transformers

from neuronx_distributed_inference_tpu.config import ChunkedPrefillConfig as JaxChunked
from neuronx_distributed_inference_tpu.config import FusedSpecConfig as JaxFusedSpecConfig
from neuronx_distributed_inference_tpu.config import TpuConfig
from neuronx_distributed_inference_tpu.models.llama import LlamaInferenceConfig as JaxConfig
from neuronx_distributed_inference_tpu.modules import masks as jmasks
from neuronx_distributed_inference_tpu.modules.kvcache import QuantizedKV as JaxQuantizedKV
from neuronx_distributed_inference_tpu.runtime.application import TpuModelForCausalLM
from neuronx_distributed_inference_tpu.runtime.fused_spec import TpuFusedSpecModelForCausalLM
from neuronx_distributed_inference_tpu.runtime.serving import ServingSession as JaxSession
from neuronx_distributed_inference_tpu_torch.config import ChunkedPrefillConfig, Config, FusedSpecConfig
from neuronx_distributed_inference_tpu_torch.models.builder import params_from_jax
from neuronx_distributed_inference_tpu_torch.models.llama import LlamaInferenceConfig
from neuronx_distributed_inference_tpu_torch.modules import masks
from neuronx_distributed_inference_tpu_torch.modules.kvcache import QuantizedKV
from neuronx_distributed_inference_tpu_torch.ops import _cuda
from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM
from neuronx_distributed_inference_tpu_torch.runtime.fused_spec import FusedSpecModelForCausalLM
from neuronx_distributed_inference_tpu_torch.runtime.serving import ServingSession

W = 4
COMMON = dict(
    vocab_size=128, hidden_size=128, intermediate_size=128, num_hidden_layers=2, num_attention_heads=2,
    num_key_value_heads=1, head_dim=64, rms_norm_eps=1e-5, max_position_embeddings=256,
    tie_word_embeddings=False, attn_implementation="eager", eos_token_id=None, bos_token_id=None,
)
MODELS = {
    "mistral": (transformers.MistralConfig, transformers.MistralForCausalLM, dict(sliding_window=W)),
    "qwen2": (transformers.Qwen2Config, transformers.Qwen2ForCausalLM, {}),
}
GEN = dict(batch_size=2, seq_len=64, dtype="float32", output_logits=True)
PROMPTS = np.array([[5, 17, 92, 41, 33, 88, 2, 11, 64, 3], [7, 8, 9, 10, 11, 12, 0, 0, 0, 0]])
MASK = np.array([[1] * 10, [1] * 6 + [0] * 4])
N_NEW = 12
ATOL = 1e-4
SERVE = dict(is_continuous_batching=True, batch_size=3, ctx_batch_size=1, seq_len=64, dtype="float32")
PAGED = dict(is_block_kv_layout=True, pa_block_size=16, pa_num_blocks=16, is_chunked_prefill=True)
REQS = {"r1": [5, 17, 92, 41, 33, 88, 2, 11, 64, 3, 14, 90, 21], "r2": list(range(30, 52)), "r3": [7, 7, 7]}


def _attrs(name):
    cfg = MODELS[name][0](**COMMON, **MODELS[name][2])
    attrs = dict(model_type=name, hidden_act="silu", rope_theta=cfg.rope_theta)
    for k in ("hidden_size", "intermediate_size", "num_hidden_layers", "num_attention_heads",
              "num_key_value_heads", "vocab_size", "rms_norm_eps", "tie_word_embeddings", "head_dim"):
        attrs[k] = getattr(cfg, k)
    attrs.update(MODELS[name][2])
    return attrs


def _load(name):
    attrs = _attrs(name)
    return lambda c: [setattr(c, k, v) for k, v in attrs.items()]


_HF = {}


def _hf(name):
    """(HF model, state dict), built once from seed 0."""
    if name not in _HF:
        torch.set_num_threads(1)
        cls, model_cls, extra = MODELS[name]
        torch.manual_seed(0)
        hf = model_cls(cls(**COMMON, **extra)).eval().float()
        _HF[name] = hf, {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    return _HF[name]


def _jax_app(name, sd, **kw):
    kw = {**GEN, **kw}
    chunked = kw.pop("chunked", None)
    if chunked:
        kw["chunked_prefill_config"] = JaxChunked(**chunked)
    return TpuModelForCausalLM(None, JaxConfig(TpuConfig(**kw), load_config=_load(name))).load(state_dict=sd)


def _port_app(name, sd=None, params=None, **kw):
    kw = {**GEN, **kw}
    chunked = kw.pop("chunked", None)
    if chunked:
        kw["chunked_prefill_config"] = ChunkedPrefillConfig(**chunked)
    app = ModelForCausalLM(None, LlamaInferenceConfig(Config(**kw, device="cpu"), load_config=_load(name)))
    return app.load(params=params) if params is not None else app.load(state_dict=sd)


def _same(port_out, jax_out):
    np.testing.assert_array_equal(port_out.sequences, np.asarray(jax_out.sequences))
    np.testing.assert_allclose(port_out.logits, np.asarray(jax_out.logits), atol=ATOL, rtol=0)


def test_windowed_masks_match_reference():
    rng = np.random.RandomState(0)
    valid = (rng.rand(2, 9) > 0.2).astype(np.int32)
    pos = np.tile(np.arange(9, dtype=np.int32), (2, 1))
    got = masks.windowed_mask(torch.from_numpy(valid), torch.from_numpy(pos), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jmasks.windowed_mask(valid, pos, 3)))
    cache_pos = rng.randint(0, 12, size=(2, 5)).astype(np.int32)
    q = np.array([[10], [7]], np.int32)
    slot_valid = rng.rand(2, 5) > 0.3
    got = masks.windowed_token_gen_mask(
        torch.from_numpy(cache_pos), torch.from_numpy(q), torch.from_numpy(slot_valid), 4
    )
    want = jmasks.windowed_token_gen_mask(cache_pos, q, slot_valid, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fused_qkv", [False, True], ids=["split_qkv", "fused_qkv"])
def test_mistral_ring_generate_matches_jax_and_hf(fused_qkv):
    """Ring of W slots: a 10-token prompt prefills in windows of W, decode
    wraps the ring three times."""
    hf, sd = _hf("mistral")
    jax_app, port = _jax_app("mistral", sd, fused_qkv=fused_qkv), _port_app("mistral", sd, fused_qkv=fused_qkv)
    assert port.spec.bounded_window == W and port.kv_cache.k.shape[2] == W
    assert port.token_generation_model.buckets == [W]
    _cuda.reset_launch_counts()
    out = port.generate(PROMPTS, MASK, max_new_tokens=N_NEW)
    assert _cuda.launch_counts() == {n: 0 for n in _cuda.KERNELS}
    _same(out, jax_app.generate(PROMPTS, MASK, max_new_tokens=N_NEW))
    want = hf.generate(input_ids=torch.tensor(PROMPTS[:1]), max_new_tokens=N_NEW, do_sample=False, pad_token_id=0)
    np.testing.assert_array_equal(out.sequences[:1], want.numpy())


def test_config_sliding_window_on_llama_matches_jax():
    """``Config.sliding_window`` windows a model whose HF config has none,
    as the reference's ``TpuConfig.sliding_window`` does: a llama model
    gets the ring too."""
    _, sd = _hf("mistral")
    attrs = {**_attrs("mistral"), "model_type": "llama"}
    del attrs["sliding_window"]

    def load(c):
        for k, v in attrs.items():
            setattr(c, k, v)

    kw = dict(GEN, sliding_window=W)
    jax_app = TpuModelForCausalLM(None, JaxConfig(TpuConfig(**kw), load_config=load)).load(state_dict=sd)
    port = ModelForCausalLM(None, LlamaInferenceConfig(Config(**kw, device="cpu"), load_config=load)).load(state_dict=sd)
    assert port.spec.bounded_window == W
    _same(port.generate(PROMPTS, MASK, max_new_tokens=N_NEW), jax_app.generate(PROMPTS, MASK, max_new_tokens=N_NEW))


def test_mistral_ring_int8_kv_matches_jax():
    """The ring with int8 codes (the reference's tests/test_kv_quant.py
    ring case): the prior read dequantizes, the mod-W write quantizes."""
    _, sd = _hf("mistral")
    jax_app, port = _jax_app("mistral", sd, kv_cache_dtype="int8"), _port_app("mistral", sd, kv_cache_dtype="int8")
    assert isinstance(port.kv_cache.k, QuantizedKV) and port.kv_cache.k.shape[2] == W
    _same(port.generate(PROMPTS, MASK, max_new_tokens=N_NEW), jax_app.generate(PROMPTS, MASK, max_new_tokens=N_NEW))
    assert isinstance(jax_app.kv_cache.k, JaxQuantizedKV)
    np.testing.assert_allclose(port.kv_cache.k.scale.numpy(), np.asarray(jax_app.kv_cache.k.scale), rtol=1e-5)


def _drive(sess, reqs, staggered=True):
    items = list(reqs.items())
    assert sess.add_request(items[0][0], items[0][1], max_new_tokens=8)
    if staggered:
        sess.step()
    for rid, p in items[1:]:
        assert sess.add_request(rid, p, max_new_tokens=8)
    return sess.run_to_completion()


@pytest.mark.parametrize("layout", ["contiguous_ring", "paged_chunked"])
def test_mistral_serving_matches_jax(layout):
    """The contiguous session admits prompts past W in windows into the
    ring; the paged one prefills in chunks of 8 tokens, multi-token passes
    that must take the windowed masks (not B5)."""
    _, sd = _hf("mistral")
    kw = dict(SERVE)
    if layout == "paged_chunked":
        kw.update(PAGED, chunked=dict(max_num_seqs=2, kernel_q_tile_size=8))
    jax_app, port = _jax_app("mistral", sd, **kw), _port_app("mistral", sd, **kw)
    assert port.spec.bounded_window == (W if layout == "contiguous_ring" else None)
    want = _drive(JaxSession(jax_app), REQS)
    _cuda.reset_launch_counts()
    got = _drive(ServingSession(port), REQS)
    assert got == want
    assert _cuda.launch_counts() == {n: 0 for n in _cuda.KERNELS}


def test_windowed_paged_chunk_pass_matches_jax():
    """One multi-token pass of 8 tokens over the paged pool, positions past
    the window (the forward API an external scheduler drives): the pass
    must take the windowed mask. Sent to B5, whose causal + prefix mask
    knows no window, its logits part from the reference's."""
    _, sd = _hf("mistral")
    kw = dict(SERVE, is_block_kv_layout=True, pa_block_size=16, pa_num_blocks=16)
    jax_app, port = _jax_app("mistral", sd, **kw), _port_app("mistral", sd, **kw)
    ids = np.array([[5, 17, 92, 41, 33, 88, 2, 11, 64, 3, 14, 90, 21, 8, 9, 1]], np.int32)
    table = np.array([[1, 2, 3, 4]], np.int32)  # the 64-position decode bucket
    outs = []
    for app in (jax_app, port):
        # 8 prompt tokens by context encoding, then the next 8 as one pass
        app.forward(ids[:, :8], np.arange(8)[None], np.array([0]), slot_mapping=16 + np.arange(8)[None])
        pos = np.arange(8, 16)[None]
        _, logits = app.forward(
            ids[:, 8:], pos, np.array([0]), attention_mask=(np.arange(64) < 16)[None].astype(np.int32),
            slot_mapping=16 + pos, block_table=table, phase="tkg",
        )
        outs.append(np.asarray(logits))
    np.testing.assert_allclose(outs[1], outs[0], atol=ATOL, rtol=0)


def test_fused_speculation_with_windowed_masks_matches_jax():
    """A windowed target and a draft of perturbed weights in one program
    per phase: no ring (fused speculation assumes position == slot), the
    windowed masks on full-length lines; tokens equal JAX's fused app's and
    the ring-bounded plain ``generate()``'s."""
    _, sd = _hf("mistral")
    rng = np.random.RandomState(1)
    draft_sd = {k: v + 0.02 * rng.randn(*v.shape).astype(np.float32) for k, v in sd.items()}
    spec_kw = dict(GEN, speculation_length=4, enable_fused_speculation=True)
    cfg = LlamaInferenceConfig(Config(**spec_kw, device="cpu"), load_config=_load("mistral"))
    cfg.fused_spec_config = FusedSpecConfig(
        draft_config=LlamaInferenceConfig(Config(**GEN, device="cpu"), load_config=_load("mistral"))
    )
    port = FusedSpecModelForCausalLM(None, cfg).load(target_state_dict=sd, draft_state_dict=draft_sd)
    assert port.target_spec.sliding_window == W and port.target_spec.bounded_window is None
    jcfg = JaxConfig(TpuConfig(**spec_kw), load_config=_load("mistral"))
    jcfg.fused_spec_config = JaxFusedSpecConfig(draft_config=JaxConfig(TpuConfig(**GEN), load_config=_load("mistral")))
    jax_app = TpuFusedSpecModelForCausalLM(None, jcfg).load(target_state_dict=sd, draft_state_dict=draft_sd)
    got = port.generate(PROMPTS, MASK, max_new_tokens=N_NEW).sequences
    np.testing.assert_array_equal(got, np.asarray(jax_app.generate(PROMPTS, MASK, max_new_tokens=N_NEW).sequences))
    plain = _port_app("mistral", sd).generate(PROMPTS, MASK, max_new_tokens=N_NEW).sequences
    np.testing.assert_array_equal(got[:, : plain.shape[1]], plain)


@pytest.mark.parametrize("fused_qkv", [False, True], ids=["split_qkv", "fused_qkv"])
def test_qwen2_matches_jax_and_hf(fused_qkv):
    hf, sd = _hf("qwen2")
    jax_app, port = _jax_app("qwen2", sd, fused_qkv=fused_qkv), _port_app("qwen2", sd, fused_qkv=fused_qkv)
    sa = port.params["layers"][0]["self_attn"]
    if fused_qkv:
        assert sa["qkv_proj"]["bias"].shape == (4 * 64,)
    else:
        assert sa["q_proj"]["bias"].shape == (128,) and "bias" not in sa["o_proj"]
    out = port.generate(PROMPTS, MASK, max_new_tokens=N_NEW)
    _same(out, jax_app.generate(PROMPTS, MASK, max_new_tokens=N_NEW))
    want = hf.generate(input_ids=torch.tensor(PROMPTS[:1]), max_new_tokens=N_NEW, do_sample=False, pad_token_id=0)
    np.testing.assert_array_equal(out.sequences[:1], want.numpy())


@pytest.mark.parametrize("name", ["mistral", "qwen2"])
def test_weight_carry_of_biases_and_windows(name):
    """The JAX app's params, fetched as numpy, run in the port as they are
    (the q/k/v bias leaves included), and random params carry the biases."""
    _, sd = _hf(name)
    jax_app = _jax_app(name, sd)
    tree = __import__("jax").tree.map(np.asarray, jax_app.params)
    port = _port_app(name, params=params_from_jax(tree, torch.float32, "cpu"))
    _same(port.generate(PROMPTS, MASK, max_new_tokens=N_NEW), jax_app.generate(PROMPTS, MASK, max_new_tokens=N_NEW))
    rnd = ModelForCausalLM(None, LlamaInferenceConfig(Config(**GEN, device="cpu"), load_config=_load(name)))
    shapes = rnd.builder.param_shapes()["layers"]["self_attn"]
    assert ("bias" in shapes["q_proj"]) == (name == "qwen2")
    p = rnd.builder.random_params()["layers"]["self_attn"]
    if name == "qwen2":
        assert p["k_proj"]["bias"].shape == (2, 64) and float(p["k_proj"]["bias"].std()) > 0


def test_ring_spec_fields():
    """The ring bound follows the reference's layout gate: the paged pool
    and fused speculation keep full-length lines."""
    _, sd = _hf("mistral")
    cfg = LlamaInferenceConfig(Config(**GEN, device="cpu"), load_config=_load("mistral"))
    spec = ModelForCausalLM(None, cfg).spec
    assert (spec.sliding_window, spec.bounded_window, spec.ring_window, spec.layer_groups) == (W, W, None, None)
    paged = LlamaInferenceConfig(Config(**SERVE, **PAGED, device="cpu"), load_config=_load("mistral"))
    spec = ModelForCausalLM(None, paged).spec
    assert (spec.sliding_window, spec.bounded_window) == (W, None)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("K", [9, 12, 16, 17])
def test_gqa8_passes_of_up_to_16_queries_take_the_decode_kernels(monkeypatch, paged, K):
    """At n_rep 8 (GPT-OSS's and Qwen3's heads) a pass of up to 16 queries a
    row goes to B1's / B4's wrapper with its mask and sink (n_rep * K above
    one block's 64 rows: row chunks on the card), as the reference's
    ``use_tkg`` gate (q_len <= 16) sends it to its kernel; a longer pass of
    a windowed or sink model takes the plain path. Either way the result is
    the plain route's (``use_tkg_kernel=False``)."""
    from neuronx_distributed_inference_tpu_torch.models import base
    from neuronx_distributed_inference_tpu_torch.modules.attention import AttnSpec
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention as da

    seen = []
    for name in ("tkg_decode_attention", "paged_tkg_decode_attention"):
        real = getattr(da, name)
        monkeypatch.setattr(da, name, lambda *a, _real=real, **kw: seen.append(a[0].shape[1]) or _real(*a, **kw))
    rng = np.random.RandomState(5)
    B, Hq, Hkv, D, S, bs = 2, 16, 2, 64, 64, 16
    q = torch.from_numpy(rng.randn(B, K, Hq, D).astype(np.float32))
    sink = torch.from_numpy(rng.randn(Hq).astype(np.float32))
    pos = torch.tensor([[40 - K + t for t in range(K)], [S - K + t for t in range(K)]])
    cols = torch.arange(S)[None, None, None, :]
    mask = (cols <= pos[:, None, :, None]) & (cols > pos[:, None, :, None] - 4)
    outs = {}
    for tkg in (None, False):
        aspec = AttnSpec(num_heads=Hq, num_kv_heads=Hkv, head_dim=D, has_sink=True, use_tkg_kernel=tkg)
        if paged:
            NB = B * S // bs
            kc = torch.from_numpy(rng.randn(1, NB + 1, Hkv, bs, D).astype(np.float32)) if tkg is None else kc
            vc = torch.from_numpy(rng.randn(1, NB + 1, Hkv, bs, D).astype(np.float32)) if tkg is None else vc
            table = torch.arange(1, NB + 1, dtype=torch.int32).reshape(B, S // bs)
            outs[tkg] = base.paged_attend(q, kc, vc, 0, mask, pos, table, pos[:, -1] + 1, aspec, sink,
                                          plain_model=False)
        else:
            kc = torch.from_numpy(rng.randn(1, B + 1, S, Hkv, D).astype(np.float32)) if tkg is None else kc
            vc = torch.from_numpy(rng.randn(1, B + 1, S, Hkv, D).astype(np.float32)) if tkg is None else vc
            outs[tkg] = base.contiguous_decode_attend(q, kc, vc, 0, mask, None, aspec, sink)
    assert seen == ([K] if K <= da.MAX_Q_LEN else [])
    torch.testing.assert_close(outs[None], outs[False], atol=1e-6, rtol=0)
