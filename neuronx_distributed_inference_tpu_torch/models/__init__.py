"""Model hub of the port: each plugin registers a builder keyed by HF
model_type. Only llama is ported (ROADMAP A9 lists the other families)."""

from neuronx_distributed_inference_tpu_torch.models.registry import (  # noqa: F401
    MODEL_REGISTRY,
    get_model_builder,
    register_model,
)
from neuronx_distributed_inference_tpu_torch.models import llama  # noqa: F401
