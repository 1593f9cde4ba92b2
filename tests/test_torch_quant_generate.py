"""The quantized paths of the port as a whole, held against the JAX package
on the CPU at fp32: greedy ``generate()`` with int8 and with int4 weights
(batch 1, and batch 2 right-padded) byte-identical to the JAX app's, with
the JAX int4 projections run both natively and through the Pallas kernel in
interpret mode, logits within 1e-4; and the split ``ServingSession`` (int8,
int4) and the ragged session (int4) byte-identical to the JAX sessions on
one mix each.

The tiny model is the reference's kernel-eligible shape
(tests/test_quant_matmul.py: hidden 256, intermediate 512), so every
decode projection of the JAX kernel run goes through its Pallas kernel.
Both packages quantize the same HF state dict at load. On CPU tensors B6's
wrapper takes its plain version, so nothing launches."""

import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.config import ChunkedPrefillConfig as JaxChunked
from neuronx_distributed_inference_tpu.config import TpuConfig
from neuronx_distributed_inference_tpu.models.llama import LlamaInferenceConfig as JaxLlamaConfig
from neuronx_distributed_inference_tpu.ops.kernel_mode import quant_matmul_mode
from neuronx_distributed_inference_tpu.runtime.application import TpuModelForCausalLM
from neuronx_distributed_inference_tpu.runtime.serving import ServingSession as JaxSession
from neuronx_distributed_inference_tpu_torch.config import ChunkedPrefillConfig, Config
from neuronx_distributed_inference_tpu_torch.models.llama import LlamaInferenceConfig
from neuronx_distributed_inference_tpu_torch.ops import _cuda
from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM
from neuronx_distributed_inference_tpu_torch.runtime.serving import ServingSession
from tests.conftest import make_random_hf_state_dict

HF = dict(
    model_type="llama", hidden_size=256, intermediate_size=512, num_attention_heads=4,
    num_key_value_heads=2, num_hidden_layers=2, vocab_size=128, rms_norm_eps=1e-5,
    rope_theta=10000.0, max_position_embeddings=512, hidden_act="silu", tie_word_embeddings=False,
)
TC = dict(
    batch_size=2, seq_len=256, dtype="float32", context_encoding_buckets=[128],
    token_generation_buckets=[128, 256], fused_qkv=True, output_logits=True,
)
PROMPTS = np.array([[5, 17, 92, 41, 33, 88, 2, 11], [64, 3, 27, 9, 0, 0, 0, 0]])
MASK = np.array([[1] * 8, [1, 1, 1, 1, 0, 0, 0, 0]])
N_NEW = 10
ATOL = 1e-4


def _load(c):
    for k, v in HF.items():
        setattr(c, k, v)


@pytest.fixture(scope="module")
def sd():
    torch.set_num_threads(1)
    return make_random_hf_state_dict(JaxLlamaConfig(TpuConfig(**TC), load_config=_load), seed=3)


def _counts_zero():
    return _cuda.launch_counts() == {n: 0 for n in _cuda.KERNELS} and _cuda.route_counts() == {n: 0 for n in _cuda.ROUTES}


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("weights", ["int8", "int4"])
def test_quantized_generate_matches_jax(sd, weights, batch):
    ids, mask = PROMPTS[:batch], MASK[:batch]
    jax_app = TpuModelForCausalLM(None, JaxLlamaConfig(TpuConfig(**TC, weight_dtype=weights), load_config=_load))
    jax_app.load(state_dict=sd)
    ref = jax_app.generate(ids, mask, max_new_tokens=N_NEW)
    port = ModelForCausalLM(
        None, LlamaInferenceConfig(Config(**TC, weight_dtype=weights, device="cpu"), load_config=_load)
    ).load(state_dict=sd)
    _cuda.reset_launch_counts()
    out = port.generate(ids, mask, max_new_tokens=N_NEW)
    assert _counts_zero()
    np.testing.assert_array_equal(out.sequences, ref.sequences)
    np.testing.assert_allclose(out.logits, np.asarray(ref.logits), atol=ATOL, rtol=0)
    if weights == "int4":
        # a fresh JAX app traces its programs with the Pallas kernel forced on
        kern_app = TpuModelForCausalLM(
            None, JaxLlamaConfig(TpuConfig(**TC, weight_dtype=weights), load_config=_load)
        )
        kern_app.load(state_dict=sd)
        with quant_matmul_mode(True):
            kern = kern_app.generate(ids, mask, max_new_tokens=N_NEW)
        np.testing.assert_array_equal(out.sequences, kern.sequences)
        np.testing.assert_allclose(out.logits, np.asarray(kern.logits), atol=ATOL, rtol=0)


SERVE = dict(
    is_continuous_batching=True, batch_size=4, ctx_batch_size=1, seq_len=64, dtype="float32",
    is_block_kv_layout=True, pa_block_size=16, pa_num_blocks=24, is_chunked_prefill=True,
)
SERVE_PROMPTS = {
    "r1": [5, 17, 92, 41, 8, 3, 77, 21, 60, 14, 2, 90],
    "r2": list(range(30, 52)),  # prefills across chunks
    "r3": [7, 7, 7],
}


def _drive(sess, max_steps=300):
    assert sess.add_request("r1", SERVE_PROMPTS["r1"][:4], max_new_tokens=6)
    sess.step()
    assert sess.add_request("r2", SERVE_PROMPTS["r2"], max_new_tokens=6)
    sess.step()
    assert sess.add_request("r3", SERVE_PROMPTS["r3"], max_new_tokens=5)
    for _ in range(max_steps):
        if not (sess.active or sess._readmit):
            break
        sess.step()
    else:
        raise AssertionError("session failed to drain within max_steps")
    return {rid: list(r.generated) for rid, r in sess.requests.items()}


@pytest.mark.parametrize(
    "weights, ragged", [("int8", False), ("int4", False), ("int4", True)], ids=["split-int8", "split-int4", "ragged-int4"]
)
def test_quantized_serving_matches_jax(sd, weights, ragged):
    """The staggered mix (a long prompt's chunks overlap live decode rows)
    through the split session and the synchronous ragged session."""
    kw = dict(SERVE, weight_dtype=weights)
    if ragged:
        kw.update(serving_ragged=True, serving_ragged_async=False)
    chunk = dict(max_num_seqs=2, kernel_q_tile_size=16)
    jax_app = TpuModelForCausalLM(
        None, JaxLlamaConfig(TpuConfig(**kw, chunked_prefill_config=JaxChunked(**chunk)), load_config=_load)
    )
    jax_app.load(state_dict=sd)
    port = ModelForCausalLM(
        None,
        LlamaInferenceConfig(Config(**kw, chunked_prefill_config=ChunkedPrefillConfig(**chunk), device="cpu"),
                             load_config=_load),
    ).load(state_dict=sd)
    ref = _drive(JaxSession(jax_app))
    _cuda.reset_launch_counts()
    sess = ServingSession(port)
    got = _drive(sess)
    assert _counts_zero()
    assert got == ref and all(len(v) in (5, 6) for v in got.values())
    if ragged:
        assert set(sess.dispatches) == {"mixed_step"}
