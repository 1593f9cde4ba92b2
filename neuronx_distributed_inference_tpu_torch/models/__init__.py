"""Model hub of the port: each plugin registers a builder keyed by HF
model_type: llama, mistral, qwen2, qwen3, the MoE family (mixtral,
qwen3_moe), gpt_oss, dbrx, deepseek_v3, llama4_text / llama4 and the EAGLE
drafts (llama-eagle, llama-eagle3). ROADMAP A9 lists the other families."""

from neuronx_distributed_inference_tpu_torch.models.registry import (  # noqa: F401
    MODEL_REGISTRY,
    get_model_builder,
    register_model,
)
from neuronx_distributed_inference_tpu_torch.models import (  # noqa: F401
    dbrx,
    deepseek,
    eagle_draft,
    gpt_oss,
    llama,
    llama4,
    mixtral,
    qwen,
)
