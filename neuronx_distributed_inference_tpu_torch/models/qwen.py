"""Qwen2 and Qwen3 model plugins (counterpart of
``neuronx_distributed_inference_tpu/models/qwen.py``): the llama decoder
graph with q/k/v projection biases (Qwen2) or a per-head RMSNorm on q and k
before RoPE (Qwen3)."""

from __future__ import annotations

from neuronx_distributed_inference_tpu_torch.config import InferenceConfig
from neuronx_distributed_inference_tpu_torch.models.builder import DecoderModelBuilder
from neuronx_distributed_inference_tpu_torch.models.registry import register_model


class QwenInferenceConfig(InferenceConfig):
    """Counterpart of the reference ``QwenInferenceConfig``."""

    _REQUIRED_ATTRS = (
        "hidden_size",
        "num_attention_heads",
        "num_hidden_layers",
        "num_key_value_heads",
        "vocab_size",
        "intermediate_size",
    )


@register_model("qwen2")
class Qwen2ModelBuilder(DecoderModelBuilder):
    """Qwen2: the attention projections carry biases (reference modeling_qwen2.py)."""

    qkv_bias = True


@register_model("qwen3")
class Qwen3ModelBuilder(DecoderModelBuilder):
    """Qwen3: per-head RMSNorm on q/k before RoPE (reference modeling_qwen3.py)."""

    qk_norm = True
