"""Llama and Mistral model plugins (counterpart of
``neuronx_distributed_inference_tpu/models/llama.py``): config mapping only;
the compute graph is the shared decoder core in ``models/base.py``."""

from __future__ import annotations

from neuronx_distributed_inference_tpu_torch.config import InferenceConfig
from neuronx_distributed_inference_tpu_torch.models.builder import DecoderModelBuilder
from neuronx_distributed_inference_tpu_torch.models.registry import register_model

#: Llama-3.2-1B shapes (copied from the reference's
#: analysis/device_model.py LLAMA_1B — the headline bench model)
LLAMA_1B = dict(
    model_type="llama",
    hidden_size=2048,
    intermediate_size=8192,
    num_attention_heads=32,
    num_key_value_heads=8,
    num_hidden_layers=16,
    vocab_size=128256,
    rms_norm_eps=1e-5,
    rope_theta=500000.0,
    max_position_embeddings=2048,
    hidden_act="silu",
    tie_word_embeddings=True,
    head_dim=64,
)

#: Llama-3.1-8B shapes (copied from the reference's analysis/device_model.py
#: LLAMA_8B, the shape of the bench rows int8_8b_bs1 and bf16_8b_int4)
LLAMA_8B = dict(
    model_type="llama",
    hidden_size=4096,
    intermediate_size=14336,
    num_attention_heads=32,
    num_key_value_heads=8,
    num_hidden_layers=32,
    vocab_size=128256,
    rms_norm_eps=1e-5,
    rope_theta=500000.0,
    max_position_embeddings=2048,
    hidden_act="silu",
    tie_word_embeddings=False,
    head_dim=128,
)


class LlamaInferenceConfig(InferenceConfig):
    """Counterpart of the reference ``LlamaInferenceConfig``."""

    _REQUIRED_ATTRS = (
        "hidden_size",
        "num_attention_heads",
        "num_hidden_layers",
        "num_key_value_heads",
        "vocab_size",
        "intermediate_size",
    )


#: Mistral-7B-v0.1 shapes (the public ``mistralai/Mistral-7B-v0.1``
#: config.json): the llama graph with a 4096-token sliding window
MISTRAL_7B = dict(
    model_type="mistral",
    hidden_size=4096,
    intermediate_size=14336,
    num_attention_heads=32,
    num_key_value_heads=8,
    num_hidden_layers=32,
    vocab_size=32000,
    rms_norm_eps=1e-5,
    rope_theta=10000.0,
    max_position_embeddings=32768,
    sliding_window=4096,
    hidden_act="silu",
    tie_word_embeddings=False,
    head_dim=128,
)


@register_model("llama")
class LlamaModelBuilder(DecoderModelBuilder):
    """Llama uses the shared decoder builder as it is."""


@register_model("mistral")
class MistralModelBuilder(DecoderModelBuilder):
    """Mistral: the llama graph with sliding-window attention, its window
    read from the HF config's ``sliding_window`` unless
    ``Config.sliding_window`` sets one."""

    hf_sliding_window = True
