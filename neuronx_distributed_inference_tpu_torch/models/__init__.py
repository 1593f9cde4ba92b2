"""Model hub of the port: each plugin registers a builder keyed by HF
model_type: llama, qwen3, and the MoE family (mixtral, qwen3_moe). ROADMAP
A9 lists the other families."""

from neuronx_distributed_inference_tpu_torch.models.registry import (  # noqa: F401
    MODEL_REGISTRY,
    get_model_builder,
    register_model,
)
from neuronx_distributed_inference_tpu_torch.models import llama, mixtral, qwen  # noqa: F401
