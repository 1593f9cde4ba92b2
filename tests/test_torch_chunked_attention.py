"""Chunked attention (``attention_chunk_size``, Llama4's flavor) on a plain
tiny Llama in the port, held against the JAX package on the CPU at fp32:
head_dim 64 (the kernels' head dims; their wrappers take their plain
versions on CPU tensors), one HF state dict made from a seed loaded into
both packages, chunk 4 against 10-token prompts and 12 new tokens.

- ``chunked_mask`` and the decode chunk mask against the reference's;
- ``generate()`` on the contiguous cache, fp32, bf16 and on int8 codes
  (the reference's ``tests/test_kv_quant.py::test_chunked_attention_mask_
  e2e``): tokens identical to JAX's, logits within 1e-4 at fp32 and
  BF16_ATOL at bf16; the cache keeps full-length lines;
- a windowed prefill (``max_context_length < seq_len``): later windows are
  multi-token passes under the chunk mask;
- the contiguous and the paged split ``ServingSession`` equal to JAX's; the
  paged chunk passes stay off B5 (its causal + prefix mask knows no chunk)
  and go to B4 with the chunk mask;
- B8's gate: a chunked layer takes the fused attention block at one new
  token a row only;
- the ragged step and token trees refuse chunked attention, as the
  reference does."""

import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.config import ChunkedPrefillConfig as JaxChunked
from neuronx_distributed_inference_tpu.config import TpuConfig
from neuronx_distributed_inference_tpu.models.base import StepInputs as JaxStepInputs
from neuronx_distributed_inference_tpu.models.base import build_mask as jax_build_mask
from neuronx_distributed_inference_tpu.models.llama import LlamaInferenceConfig as JaxConfig
from neuronx_distributed_inference_tpu.modules import masks as jmasks
from neuronx_distributed_inference_tpu.runtime.application import TpuModelForCausalLM
from neuronx_distributed_inference_tpu.runtime.serving import ServingSession as JaxSession
from neuronx_distributed_inference_tpu_torch.config import ChunkedPrefillConfig, Config, FusedSpecConfig
from neuronx_distributed_inference_tpu_torch.models import base
from neuronx_distributed_inference_tpu_torch.models.llama import LlamaInferenceConfig
from neuronx_distributed_inference_tpu_torch.modules import masks
from neuronx_distributed_inference_tpu_torch.modules.kvcache import QuantizedKV
from neuronx_distributed_inference_tpu_torch.ops import _cuda
from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM
from neuronx_distributed_inference_tpu_torch.runtime.serving import ServingSession
from tests.conftest import make_random_hf_state_dict

C = 4
HF = dict(
    model_type="llama", hidden_size=128, intermediate_size=256, num_attention_heads=2,
    num_key_value_heads=1, num_hidden_layers=2, vocab_size=128, rms_norm_eps=1e-5,
    rope_theta=10000.0, max_position_embeddings=256, hidden_act="silu", tie_word_embeddings=False,
)
GEN = dict(batch_size=2, seq_len=64, dtype="float32", output_logits=True, attention_chunk_size=C)
PROMPTS = np.array([[5, 17, 92, 41, 33, 88, 2, 11, 64, 3], [7, 8, 9, 10, 11, 12, 0, 0, 0, 0]])
MASK = np.array([[1] * 10, [1] * 6 + [0] * 4])
N_NEW = 12
ATOL = 1e-4
#: the reference's deviation limit of the int8 cache (tests/test_kv_quant.py)
INT8_LOGIT_TOL = 0.25
#: bf16 logits of the two packages, each rounding its own bf16 products:
#: about 3x the largest gap measured on test_generate_matches_jax[bf16]'s
#: inputs (1.6e-2, every position; typical |logit| 0.44)
BF16_ATOL = 5e-2
SERVE = dict(is_continuous_batching=True, batch_size=3, ctx_batch_size=1, seq_len=64, dtype="float32",
             attention_chunk_size=C)
PAGED = dict(is_block_kv_layout=True, pa_block_size=16, pa_num_blocks=16, is_chunked_prefill=True,
             chunked=dict(max_num_seqs=2, kernel_q_tile_size=8))
REQS = {"r1": [5, 17, 92, 41, 33, 88, 2, 11, 64, 3, 14, 90, 21], "r2": list(range(30, 52)), "r3": [7, 7, 7]}


def _load(c):
    for k, v in HF.items():
        setattr(c, k, v)


@pytest.fixture(scope="module")
def sd():
    torch.set_num_threads(1)
    return make_random_hf_state_dict(JaxConfig(TpuConfig(**GEN), load_config=_load), seed=21)


def _kw(kw):
    kw = {**GEN, **kw}
    chunked = kw.pop("chunked", None)
    return kw, chunked


def _jax_app(sd, **kw):
    kw, chunked = _kw(kw)
    if chunked:
        kw["chunked_prefill_config"] = JaxChunked(**chunked)
    return TpuModelForCausalLM(None, JaxConfig(TpuConfig(**kw), load_config=_load)).load(state_dict=sd)


def _port_app(sd, **kw):
    kw, chunked = _kw(kw)
    if chunked:
        kw["chunked_prefill_config"] = ChunkedPrefillConfig(**chunked)
    return ModelForCausalLM(None, LlamaInferenceConfig(Config(**kw, device="cpu"), load_config=_load)).load(state_dict=sd)


def _same(port_out, jax_out):
    np.testing.assert_array_equal(port_out.sequences, np.asarray(jax_out.sequences))
    np.testing.assert_allclose(port_out.logits, np.asarray(jax_out.logits), atol=ATOL, rtol=0)


def test_chunked_masks_match_reference():
    rng = np.random.RandomState(0)
    valid = (rng.rand(2, 11) > 0.2).astype(np.int32)
    pos = np.tile(np.arange(11, dtype=np.int32), (2, 1))
    pos[1] -= 2  # a row whose chunks start off the index grid
    got = masks.chunked_mask(torch.from_numpy(valid), torch.from_numpy(pos), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jmasks.chunked_mask(valid, pos, 3)))
    # build_mask at prefill and at decode (1 and 3 queries a row), with and
    # without a window beside the chunk
    spec = base.ModelSpec(num_layers=1, vocab_size=8, attn=None)
    cache_valid = (np.arange(16)[None, :] <= np.array([[9], [13]])).astype(np.int32)
    cases = [
        ("context_encoding", valid, pos),
        ("token_generation", cache_valid, np.array([[9], [13]], np.int32)),
        ("token_generation", cache_valid, np.array([[7, 8, 9], [11, 12, 13]], np.int32)),
    ]
    for phase, am, p in cases:
        for window in (None, 6):
            ids = np.zeros(p.shape, np.int32)
            jin = JaxStepInputs(input_ids=ids, attention_mask=am, position_ids=p, seq_ids=np.arange(2),
                                sampling_params=np.zeros((2, 3), np.float32))
            want = np.asarray(jax_build_mask(jin, None, phase, window=window, chunk=C))
            tin = base.StepInputs(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(am),
                                  position_ids=torch.from_numpy(p), seq_ids=torch.arange(2),
                                  sampling_params=torch.zeros((2, 3)))
            np.testing.assert_array_equal(base.build_mask(tin, spec, phase, window=window, chunk=C).numpy(), want)


@pytest.mark.parametrize("dtype, kv", [("float32", None), ("bfloat16", None), ("float32", "int8")],
                         ids=["fp32", "bf16", "fp32_int8_cache"])
def test_generate_matches_jax(sd, dtype, kv):
    """The chunk masks on the contiguous cache (full-length lines), through
    B2's and B1's wrappers (B1's code mode on the int8 cache); bf16 within
    BF16_ATOL of JAX's bf16 logits. On the int8 cache both packages prefill
    through the plain path: the cache's running absmax takes the prompt's
    bucket padding too, and a padded query inside a chunk of padding sees
    no valid key, which B2 answers with zeros and the reference's native
    prefill with a uniform softmax (ROADMAP C)."""
    kw = dict(dtype=dtype, **(dict(kv_cache_dtype=kv, attn_kernel_enabled=False) if kv else {}))
    port = _port_app(sd, **kw)
    assert port.spec.attention_chunk_size == C and port.spec.bounded_window is None
    assert port.kv_cache.k.shape[2] == GEN["seq_len"] and isinstance(port.kv_cache.k, QuantizedKV) == bool(kv)
    _cuda.reset_launch_counts()
    out = port.generate(PROMPTS, MASK, max_new_tokens=N_NEW)
    assert _cuda.launch_counts() == {n: 0 for n in _cuda.KERNELS}
    jax_out = _jax_app(sd, **kw).generate(PROMPTS, MASK, max_new_tokens=N_NEW)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(out.sequences, np.asarray(jax_out.sequences))
        np.testing.assert_allclose(out.logits, np.asarray(jax_out.logits, np.float32), atol=BF16_ATOL, rtol=0)
    else:
        _same(out, jax_out)
    if kv:
        # the reference's e2e check: the int8 cache's tokens are the plain
        # cache's, its logits within the reference's deviation limit
        plain = _port_app(sd, attn_kernel_enabled=False).generate(PROMPTS, MASK, max_new_tokens=N_NEW)
        np.testing.assert_array_equal(out.sequences, plain.sequences)
        dev = np.abs(out.logits - plain.logits).max()
        assert 0 < dev <= INT8_LOGIT_TOL, dev


def test_chunk_changes_the_logits(sd):
    """Chunk 4 is not idle over 22 positions: without it the logits move."""
    chunked = _port_app(sd).generate(PROMPTS, MASK, max_new_tokens=N_NEW)
    plain = _port_app(sd, attention_chunk_size=None).generate(PROMPTS, MASK, max_new_tokens=N_NEW)
    assert np.abs(chunked.logits - plain.logits).max() > 1e-2


def test_windowed_prefill_matches_jax(sd):
    """A prompt past ``max_context_length``: window 0 by the context
    program (B2's chunk predicate), the later windows as 8-token passes over
    the contiguous cache under the chunk mask (B1)."""
    kw = dict(seq_len=96, max_context_length=8, context_encoding_buckets=[8],
              token_generation_buckets=[32, 64, 96])
    rng = np.random.RandomState(3)
    ids = rng.randint(1, HF["vocab_size"], size=(2, 27))
    mask = np.ones_like(ids)
    mask[1, 20:] = 0
    _same(_port_app(sd, **kw).generate(ids, mask, max_new_tokens=N_NEW),
          _jax_app(sd, **kw).generate(ids, mask, max_new_tokens=N_NEW))


def _drive(sess):
    items = list(REQS.items())
    assert sess.add_request(items[0][0], items[0][1], max_new_tokens=8)
    sess.step()
    for rid, p in items[1:]:
        assert sess.add_request(rid, p, max_new_tokens=8)
    return sess.run_to_completion()


@pytest.mark.parametrize("layout", ["contiguous", "paged_split"])
def test_serving_session_matches_jax(sd, layout, monkeypatch):
    """The contiguous session and the paged split session (chunked prefill,
    8-token chunk passes) drain JAX's tokens. On the paged pool no pass
    reaches B5, and every pass of at most 16 tokens goes to B4 with the
    chunk mask."""
    from neuronx_distributed_inference_tpu_torch.ops import decode_attention, paged_flash_attention

    kw = dict(SERVE, **PAGED) if layout == "paged_split" else dict(SERVE)
    calls = {"b5": 0, "b4": 0}
    real_b4 = decode_attention.paged_tkg_decode_attention

    def b4(q, *a, **k):
        assert q.shape[1] <= 16 and a[4] is not None
        calls["b4"] += 1
        return real_b4(q, *a, **k)

    monkeypatch.setattr(paged_flash_attention, "paged_flash_attention",
                        lambda *a, **k: calls.__setitem__("b5", calls["b5"] + 1))
    monkeypatch.setattr(decode_attention, "paged_tkg_decode_attention", b4)
    want = _drive(JaxSession(_jax_app(sd, **kw)))
    got = _drive(ServingSession(_port_app(sd, **kw)))
    assert got == want
    assert calls["b5"] == 0
    assert (calls["b4"] > 0) == (layout == "paged_split")


@pytest.mark.parametrize("K", [1, 3])
def test_fused_block_takes_a_chunked_layer_at_one_token_only(sd, K):
    """B8's gate on a chunked layer: at one new token a row (its in-flight
    part is the token itself; the chunk bounds the prior part through the
    mask) it takes the fused block, at more it does not, as the
    reference's gate decides."""
    port = _port_app(sd, fused_qkv=True, fused_attn_block_kernel_enabled=True)
    layer = base.flat_layers(port.params["layers"])[0]
    cos = torch.zeros((2, K, 32))
    mask = torch.ones((2, 1, K, 16), dtype=torch.bool)
    assert base._fused_attn_eligible(layer, mask, port.spec, cos, port.kv_cache.k, None, C) == (K == 1)
    assert base._fused_attn_eligible(layer, mask, port.spec, cos, port.kv_cache.k, None, None)


def test_fused_block_generate_matches_jax(sd):
    """generate() with both fused flags on: every decode step's layers go
    through B8 (and B9) with the chunk in their masks; tokens equal JAX's
    with the same flags."""
    from neuronx_distributed_inference_tpu_torch.ops import decode_block

    kw = dict(fused_qkv=True, fused_attn_block_kernel_enabled=True, fused_mlp_kernel_enabled=True)
    calls = []
    real = decode_block.fused_attn_block
    decode_block.fused_attn_block = lambda *a, **k: calls.append(a[-2].shape) or real(*a, **k)
    try:
        out = _port_app(sd, **kw).generate(PROMPTS, MASK, max_new_tokens=N_NEW)
    finally:
        decode_block.fused_attn_block = real
    # every decode step's layers (the decode chunks may run past the last
    # token needed), one query a row each
    assert len(calls) >= (N_NEW - 1) * HF["num_hidden_layers"] and all(m[-2] == 1 for m in calls)
    _same(out, _jax_app(sd, **kw).generate(PROMPTS, MASK, max_new_tokens=N_NEW))


def test_ragged_and_token_tree_refusals(sd):
    """The ragged mixed step refuses chunked attention at the config, in
    both packages, and so does the ragged step itself; a token tree over a
    chunked target is refused (its ancestry mask would replace the chunk
    masks)."""
    from neuronx_distributed_inference_tpu_torch.runtime.fused_spec import EagleSpecModelForCausalLM

    ragged = dict(is_block_kv_layout=True, is_continuous_batching=True, is_chunked_prefill=True,
                  serving_ragged=True, attention_chunk_size=C)
    with pytest.raises(NotImplementedError, match="no sliding-window/chunked attention"):
        Config(device="cpu", **ragged)
    with pytest.raises(NotImplementedError, match="no sliding-window/chunked attention"):
        TpuConfig(**ragged)
    spec = base.ModelSpec(num_layers=1, vocab_size=8, attn=base.AttnSpec(2, 1, 64), attention_chunk_size=C)
    with pytest.raises(NotImplementedError, match="chunked attention"):
        base.mixed_forward(None, None, None, spec=spec)

    cfg = LlamaInferenceConfig(
        Config(**GEN, device="cpu", speculation_length=4, enable_fused_speculation=True,
               enable_eagle_speculation=True, token_tree_config={0: [1, 2]}),
        load_config=_load,
    )
    cfg.fused_spec_config = FusedSpecConfig(draft_config=LlamaInferenceConfig(
        Config(**GEN, device="cpu"), load_config=lambda c: [_load(c), setattr(c, "model_type", "llama-eagle"),
                                                            setattr(c, "num_hidden_layers", 1)],
    ))
    with pytest.raises(NotImplementedError, match="plain-attention target"):
        EagleSpecModelForCausalLM(None, cfg)
