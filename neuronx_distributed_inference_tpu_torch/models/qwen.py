"""Qwen3 model plugin (counterpart of ``neuronx_distributed_inference_tpu/
models/qwen.py``): the llama decoder graph with a per-head RMSNorm on q and
k before RoPE. Qwen2's qkv bias waits for ROADMAP A9."""

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


@register_model("qwen3")
class Qwen3ModelBuilder(DecoderModelBuilder):
    """Qwen3: per-head RMSNorm on q/k before RoPE (reference modeling_qwen3.py)."""

    qk_norm = True
