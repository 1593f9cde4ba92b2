"""MXFP4 expert weights in the port (``ops/mxfp4.py``), held against the JAX
package's numpy dequant and ``transformers``' own converter on the CPU:

- the dequant (table gather times ``exp2(scale - 127)``, the swap of the
  last two axes) equals the reference's bit for bit in fp32, over the whole
  e8m0 range short of overflow, and the bf16 cast of it;
- an unstacked tensor and the state-dict form give the same bits;
- ``repack_mxfp4_to_int4`` gives the reference's grouped-int4 codes and
  scales;
- a GPT-OSS loaded from a packed state dict equals the JAX one loaded from
  the same dict (tokens byte-identical, logits within 1e-4)."""

import numpy as np
import pytest
import torch
from transformers import GptOssConfig, GptOssForCausalLM
from transformers.integrations.mxfp4 import convert_moe_packed_tensors

from neuronx_distributed_inference_tpu.config import TpuConfig
from neuronx_distributed_inference_tpu.models.gpt_oss import GptOssInferenceConfig as JaxGptOssConfig
from neuronx_distributed_inference_tpu.ops import mxfp4 as jmx
from neuronx_distributed_inference_tpu.runtime.application import TpuModelForCausalLM
from neuronx_distributed_inference_tpu_torch.config import MoEConfig
from neuronx_distributed_inference_tpu_torch.models.gpt_oss import GptOssInferenceConfig
from neuronx_distributed_inference_tpu_torch.ops import mxfp4
from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM


def _packed(seed, E, rows, cols, lo=110, hi=140):
    rng = np.random.RandomState(seed)
    blocks = rng.randint(0, 256, size=(E, rows, cols // 32, 16), dtype=np.uint8)
    scales = rng.randint(lo, hi, size=(E, rows, cols // 32), dtype=np.uint8)
    return blocks, scales


def test_table_matches_reference():
    np.testing.assert_array_equal(np.asarray(mxfp4.FP4_VALUES, np.float32), jmx.FP4_VALUES)


@pytest.mark.parametrize("lo, hi", [(110, 140), (0, 255)], ids=["typical", "full_e8m0"])
def test_dequant_bit_identical_to_reference(lo, hi):
    """Every exponent but 255 (2^128 overflows fp32 in both), subnormal
    products included."""
    blocks, scales = _packed(0, 3, 6, 64, lo, hi)
    want = jmx.dequantize_mxfp4(blocks, scales)
    got = mxfp4.dequantize_mxfp4(blocks, scales).numpy()
    assert got.shape == want.shape == (3, 64, 6)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    ref = convert_moe_packed_tensors(torch.tensor(blocks), torch.tensor(scales), dtype=torch.float32,
                                     rows_per_chunk=64).numpy()
    np.testing.assert_array_equal(got, ref)
    bf = mxfp4.dequantize_mxfp4(torch.from_numpy(blocks), torch.from_numpy(scales), torch.bfloat16)
    assert torch.equal(bf, torch.from_numpy(want).to(torch.bfloat16))


def test_dequant_of_unstacked_tensors_and_state_dict():
    """One expert (no leading axis) and torch inputs dequantize as the
    reference does; mismatched scales raise; the state-dict form replaces
    every packed pair."""
    blocks, scales = _packed(1, 2, 8, 32)
    got = mxfp4.dequantize_mxfp4(torch.from_numpy(blocks[0]), torch.from_numpy(scales[0]))
    np.testing.assert_array_equal(got.numpy(), jmx.dequantize_mxfp4(blocks[:1], scales[:1])[0])
    with pytest.raises(ValueError, match="do not match"):
        mxfp4.dequantize_mxfp4(blocks, scales[:, :4])
    sd = {"w_blocks": blocks, "w_scales": scales, "b": np.ones(3, np.float32)}
    got, want = mxfp4.dequantize_packed_state_dict(sd), jmx.dequantize_packed_state_dict(sd)
    assert sorted(got) == sorted(want) == ["b", "w"]
    np.testing.assert_array_equal(got["w"].numpy(), want["w"])


def test_repack_to_int4_matches_reference():
    blocks, scales = _packed(2, 2, 64, 256, 118, 132)
    got = mxfp4.repack_mxfp4_to_int4(blocks, scales, group_size=128)
    want = jmx.repack_mxfp4_to_int4(blocks, scales, group_size=128)
    np.testing.assert_array_equal(got["weight"].numpy(), np.asarray(want["weight"]))
    np.testing.assert_allclose(got["scale"].numpy(), np.asarray(want["scale"]), rtol=1e-6, atol=0)


def test_gpt_oss_loads_packed_checkpoint_like_jax():
    """The reference's tests/test_quantization2.py case at head_dim 64: the
    packed dict through both loaders, and the port's also against a plain
    dict of the dequantized experts."""
    torch.set_num_threads(1)
    cfg = GptOssConfig(
        vocab_size=128, hidden_size=64, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=64, num_local_experts=2, num_experts_per_tok=1, sliding_window=4,
        max_position_embeddings=256, rope_scaling=None, attn_implementation="eager", eos_token_id=None,
        pad_token_id=0, tie_word_embeddings=False,
    )
    torch.manual_seed(0)
    base = {k: v.float().numpy() for k, v in GptOssForCausalLM(cfg).eval().float().state_dict().items()}
    packed, plain = dict(base), dict(base)
    for i in range(2):
        for seed, (name, rows, cols) in enumerate(
            ((f"model.layers.{i}.mlp.experts.gate_up_proj", 128, 64), (f"model.layers.{i}.mlp.experts.down_proj", 64, 64))
        ):
            blocks, scales = _packed(10 * i + seed, 2, rows, cols, 118, 132)
            del packed[name]
            packed[name + "_blocks"], packed[name + "_scales"] = blocks, scales
            plain[name] = jmx.dequantize_mxfp4(blocks, scales)

    def load(c):
        c.model_type = "gpt_oss"
        for k, v in cfg.to_dict().items():
            setattr(c, k, v)

    kw = dict(batch_size=1, seq_len=64, dtype="float32", output_logits=True)
    jax_app = TpuModelForCausalLM(None, JaxGptOssConfig(TpuConfig(**kw), load_config=load)).load(state_dict=packed)
    ports = [
        ModelForCausalLM(None, GptOssInferenceConfig(MoEConfig(**kw, device="cpu"), load_config=load)).load(state_dict=sd)
        for sd in (packed, plain)
    ]
    gate = ports[0].params["layers"][0]["mlp"]["experts"]["gate_proj"]["weight"]
    np.testing.assert_array_equal(gate.numpy(), plain["model.layers.0.mlp.experts.gate_up_proj"][..., 0::2])
    ids = np.array([[5, 17, 92, 41, 33, 88, 2, 11]])
    want = jax_app.generate(ids, max_new_tokens=8)
    for port in ports:
        out = port.generate(ids, max_new_tokens=8)
        np.testing.assert_array_equal(out.sequences, np.asarray(want.sequences))
        np.testing.assert_allclose(out.logits, np.asarray(want.logits), atol=1e-4, rtol=0)
