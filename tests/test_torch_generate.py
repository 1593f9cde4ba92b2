"""The PyTorch port's main path as a whole, held against the JAX package on
the CPU: greedy ``generate()`` on a tiny head_dim-64 Llama with fused QKV.

The JAX app runs with both attention kernels forced on (Pallas in interpret
mode on the CPU); the port runs on ``device="cpu"``, where its kernel
wrappers take their plain versions, on the same weights handed over by
``params_from_jax``. In fp32 the greedy tokens must be identical and the
logits within atol 1e-4 (summation order differs between XLA and PyTorch).
"""

import numpy as np
import pytest
import torch
import transformers

from neuronx_distributed_inference_tpu.config import TpuConfig
from neuronx_distributed_inference_tpu.models.llama import LlamaInferenceConfig as JaxLlamaConfig
from neuronx_distributed_inference_tpu.runtime.application import TpuModelForCausalLM
from neuronx_distributed_inference_tpu_torch.config import Config
from neuronx_distributed_inference_tpu_torch.models.builder import params_from_jax
from neuronx_distributed_inference_tpu_torch.models.llama import LlamaInferenceConfig
from neuronx_distributed_inference_tpu_torch.ops import _cuda
from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM
from tests.conftest import make_random_hf_state_dict

HF = dict(
    model_type="llama",
    hidden_size=256,
    intermediate_size=512,
    num_attention_heads=4,
    num_key_value_heads=2,
    num_hidden_layers=2,
    vocab_size=128,
    rms_norm_eps=1e-5,
    rope_theta=10000.0,
    max_position_embeddings=512,
    hidden_act="silu",
    tie_word_embeddings=False,
)
TC = dict(
    batch_size=2,
    seq_len=256,
    dtype="float32",
    context_encoding_buckets=[128],
    token_generation_buckets=[128, 256],
    fused_qkv=True,
    output_logits=True,
)
PROMPTS = np.array([[5, 17, 92, 41, 33, 88, 2, 11], [64, 3, 27, 9, 0, 0, 0, 0]])
MASK = np.array([[1] * 8, [1, 1, 1, 1, 0, 0, 0, 0]])
N_NEW = 12
ATOL = 1e-4


def _load(cfg, **attrs):
    def load_config(c):
        for k, v in {**HF, **attrs}.items():
            setattr(c, k, v)

    return load_config


def _jax_app(kernels: bool, sd, **tc):
    kw = dict(attn_kernel_enabled=kernels, attn_block_tkg_kernel_enabled=kernels)
    cfg = JaxLlamaConfig(TpuConfig(**{**TC, **tc, **kw}), load_config=_load(None))
    return TpuModelForCausalLM(None, cfg).load(state_dict=sd)


def _port_app(params=None, sd=None, **tc):
    cfg = LlamaInferenceConfig(Config(**{**TC, **tc, "device": "cpu"}), load_config=_load(None))
    app = ModelForCausalLM(None, cfg)
    if params is not None:
        return app.load(params=params)
    return app.load(state_dict=sd)


@pytest.fixture(scope="module")
def apps():
    torch.set_num_threads(1)
    cfg = JaxLlamaConfig(TpuConfig(**TC), load_config=_load(None))
    sd = make_random_hf_state_dict(cfg, seed=3)
    jax_app = _jax_app(True, sd)
    import jax

    tree = jax.device_get(jax_app.params)
    port = _port_app(params=params_from_jax(tree, torch.float32, "cpu"))
    return jax_app, port, sd


@pytest.mark.parametrize("batch", [1, 2])
def test_generate_matches_jax_kernels(apps, batch):
    jax_app, port, _ = apps
    ids, mask = PROMPTS[:batch], MASK[:batch]
    ref = jax_app.generate(ids, mask, max_new_tokens=N_NEW)
    _cuda.reset_launch_counts()
    out = port.generate(ids, mask, max_new_tokens=N_NEW)
    np.testing.assert_array_equal(out.sequences, ref.sequences)
    np.testing.assert_allclose(out.logits, np.asarray(ref.logits), atol=ATOL, rtol=0)
    # on CPU tensors the wrappers take the plain versions and launch nothing
    assert _cuda.launch_counts() == {name: 0 for name in _cuda.KERNELS}


def test_generate_eos_chunking_matches_jax(apps):
    jax_app, port, _ = apps
    free = jax_app.generate(PROMPTS, MASK, max_new_tokens=N_NEW).sequences
    # an EOS that row 0 emits mid-way, after the first 8-step chunk
    eos = int(free[0, 8 + 10])
    ref = jax_app.generate(PROMPTS, MASK, max_new_tokens=N_NEW + 8, eos_token_id=eos)
    out = port.generate(PROMPTS, MASK, max_new_tokens=N_NEW + 8, eos_token_id=eos)
    np.testing.assert_array_equal(out.sequences, ref.sequences)
    np.testing.assert_allclose(out.logits, np.asarray(ref.logits), atol=ATOL, rtol=0)


def test_forward_matches_jax_kernels_off(apps):
    """Prefill + one forced decode step through ``forward()`` against the
    JAX app with its kernels off, on the port with its kernels off too."""
    _, _, sd = apps
    jax_app = _jax_app(False, sd)
    port = _port_app(sd=sd, attn_kernel_enabled=False, attn_block_tkg_kernel_enabled=False)
    pos = np.tile(np.arange(8, dtype=np.int32), (2, 1))
    seq = np.arange(2, dtype=np.int32)
    for app in (jax_app, port):
        app._ref = app.forward(PROMPTS, pos, seq, attention_mask=MASK)
    forced = np.array([[7], [11]], np.int32)
    step_pos = MASK.sum(1).astype(np.int32)[:, None]
    for app in (jax_app, port):
        app._step = app.forward(forced, step_pos, seq)
    for a, b in ((jax_app._ref, port._ref), (jax_app._step, port._step)):
        np.testing.assert_array_equal(b[0], np.asarray(a[0]))
        np.testing.assert_allclose(b[1], np.asarray(a[1]), atol=ATOL, rtol=0)


def test_generate_matches_hf_transformers():
    """Greedy tokens against HF transformers per unpadded row, as
    tests/test_hf_parity.py holds the JAX package (logits within 1e-3)."""
    torch.set_num_threads(1)
    hf_cfg = transformers.LlamaConfig(
        vocab_size=HF["vocab_size"], hidden_size=HF["hidden_size"],
        intermediate_size=HF["intermediate_size"], num_hidden_layers=HF["num_hidden_layers"],
        num_attention_heads=HF["num_attention_heads"], num_key_value_heads=HF["num_key_value_heads"],
        rms_norm_eps=HF["rms_norm_eps"], rope_theta=HF["rope_theta"],
        max_position_embeddings=HF["max_position_embeddings"], tie_word_embeddings=False,
        attn_implementation="eager", eos_token_id=None, bos_token_id=None,
    )
    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(hf_cfg).eval().to(torch.float32)
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    port = _port_app(sd=sd)
    out = port.generate(PROMPTS, MASK, max_new_tokens=8)
    for b in range(2):
        valid = int(MASK[b].sum())
        row = np.concatenate([PROMPTS[b, :valid], out.sequences[b, 8:]])
        with torch.no_grad():
            hf_out = hf.generate(
                input_ids=torch.tensor(PROMPTS[b : b + 1, :valid]), max_new_tokens=8,
                do_sample=False, pad_token_id=0,
            )
            hf_logits = hf(input_ids=torch.tensor(row[None, :])).logits[0].numpy()
        np.testing.assert_array_equal(out.sequences[b, 8:], hf_out[0, valid:].numpy())
        for i in range(8):
            np.testing.assert_allclose(out.logits[b, i], hf_logits[valid + i - 1], atol=1e-3, rtol=1e-3)
