"""Mixtral and Qwen3-MoE model plugins (counterpart of ``neuronx_distributed_
inference_tpu/models/mixtral.py``): the llama decoder graph with the MoE
block (``modules/moe.py``) as its MLP, experts stacked ``(L, E, ...)``."""

from __future__ import annotations

from typing import Dict

import numpy as np

from neuronx_distributed_inference_tpu_torch.config import InferenceConfig
from neuronx_distributed_inference_tpu_torch.models.builder import DecoderModelBuilder, _to_torch, hf_array
from neuronx_distributed_inference_tpu_torch.models.registry import register_model
from neuronx_distributed_inference_tpu_torch.modules.moe import MoESpec, grouped_route_tokens, moe_layer
from neuronx_distributed_inference_tpu_torch.ops.quant import skip_keys

#: Qwen3-30B-A3B (the public ``Qwen/Qwen3-30B-A3B`` config.json): 30.53 B
#: parameters, 61.06 GB in bf16, the MoE model of the family that fits one
#: 80 GB card in bf16
QWEN3_30B_A3B = dict(
    model_type="qwen3_moe",
    hidden_size=2048,
    intermediate_size=6144,
    moe_intermediate_size=768,
    num_hidden_layers=48,
    num_attention_heads=32,
    num_key_value_heads=4,
    head_dim=128,
    num_experts=128,
    num_experts_per_tok=8,
    norm_topk_prob=True,
    decoder_sparse_step=1,
    mlp_only_layers=[],
    vocab_size=151936,
    rms_norm_eps=1e-6,
    rope_theta=1000000.0,
    max_position_embeddings=40960,
    hidden_act="silu",
    tie_word_embeddings=False,
)

#: Mixtral-8x7B (the public ``mistralai/Mixtral-8x7B-v0.1`` config.json):
#: 46.7 B parameters, 93 GB in bf16, more than one 80 GB card holds
MIXTRAL_8X7B = dict(
    model_type="mixtral",
    hidden_size=4096,
    intermediate_size=14336,
    num_hidden_layers=32,
    num_attention_heads=32,
    num_key_value_heads=8,
    head_dim=128,
    num_local_experts=8,
    num_experts_per_tok=2,
    vocab_size=32000,
    rms_norm_eps=1e-5,
    rope_theta=1000000.0,
    max_position_embeddings=32768,
    hidden_act="silu",
    tie_word_embeddings=False,
)


class MoEInferenceConfig(InferenceConfig):
    """Counterpart of the reference ``MoEInferenceConfig``."""

    _REQUIRED_ATTRS = (
        "hidden_size",
        "num_attention_heads",
        "num_hidden_layers",
        "num_key_value_heads",
        "vocab_size",
    )


class MoEDecoderModelBuilder(DecoderModelBuilder):
    """Shared MoE builder: llama attention plus the MoE block. Quantized
    weights (``quantized=True``: int8 / fp8 per channel, per tensor or
    blockwise; ``weight_dtype="int4"``) quantize the experts with every
    other linear the config does not skip; ``modules/moe.py`` takes each
    format on every route."""

    config_cls = MoEInferenceConfig
    is_moe = True

    # HF name templates (mixtral layout); qwen3-moe overrides
    HF_ROUTER = "block_sparse_moe.gate.weight"
    HF_EXPERT_GATE = "block_sparse_moe.experts.{e}.w1.weight"
    HF_EXPERT_DOWN = "block_sparse_moe.experts.{e}.w2.weight"
    HF_EXPERT_UP = "block_sparse_moe.experts.{e}.w3.weight"

    def __init__(self, config):
        super().__init__(config)
        # the base shapes read intermediate_size; checkpoints that declare
        # only moe_intermediate_size alias it
        if getattr(config, "intermediate_size", None) is None:
            config.intermediate_size = self.expert_intermediate

    @property
    def num_experts(self) -> int:
        for attr in ("num_local_experts", "num_experts"):
            n = getattr(self.config, attr, None)
            if n is not None:
                return n
        raise ValueError("MoE config needs num_local_experts (mixtral) or num_experts (qwen3-moe)")

    @property
    def expert_intermediate(self) -> int:
        for attr in ("moe_intermediate_size", "intermediate_size"):
            n = getattr(self.config, attr, None)
            if n is not None:
                return n
        raise ValueError("MoE config needs moe_intermediate_size or intermediate_size")

    def _check_all_sparse(self):
        """The layer loop runs one stacked MoE block per layer; checkpoints
        that mix dense and sparse layers are refused, as the reference
        refuses them."""
        cfg = self.config
        if getattr(cfg, "mlp_only_layers", None):
            raise NotImplementedError("mixed dense/sparse layers (mlp_only_layers) not yet supported")
        step = getattr(cfg, "decoder_sparse_step", 1)
        if step not in (0, 1):
            raise NotImplementedError(f"decoder_sparse_step={step} (mixed dense/sparse) not yet supported")

    def moe_spec(self) -> MoESpec:
        cfg = self.config
        tc = cfg.torch_config
        return MoESpec(
            num_experts=self.num_experts,
            top_k=getattr(cfg, "num_experts_per_tok", 2),
            normalize_top_k_affinities=bool(getattr(cfg, "norm_topk_prob", True)),
            router_dtype=getattr(tc, "router_dtype", "float32"),
            act=getattr(cfg, "hidden_act", "silu"),
            early_affinity_modulation=bool(getattr(tc, "early_expert_affinity_modulation", False)),
            act_scale=float(getattr(tc, "hidden_act_scaling_factor", 1.0)),
            act_bias=float(getattr(tc, "hidden_act_bias", 0.0)),
            capacity_factor=getattr(tc, "capacity_factor", None),
            ep_degree=tc.ep_degree,
            moe_fused_kernel=getattr(tc, "moe_fused_kernel_enabled", None),
        )

    def param_shapes(self) -> Dict:
        shapes = super().param_shapes()
        cfg = self.config
        L, H = cfg.num_hidden_layers, cfg.hidden_size
        E, I = self.num_experts, self.expert_intermediate
        shapes["layers"]["mlp"] = {
            "router": {"weight": (L, H, E)},
            "experts": {
                "gate_proj": {"weight": (L, E, H, I)},
                "up_proj": {"weight": (L, E, H, I)},
                "down_proj": {"weight": (L, E, I, H)},
            },
        }
        return shapes

    def convert_hf_state_dict(self, sd, dtype=None):
        """HF checkpoint -> params, the experts stacked (L, E, in, out)."""
        self._check_all_sparse()
        cfg = self.config
        dtype = dtype or self.dtype
        L, E = cfg.num_hidden_layers, self.num_experts
        # the base conversion reads dense mlp names: give it tiny
        # placeholders, then replace its mlp with the stacked experts
        sd = dict(sd)
        zero = np.zeros((1, cfg.hidden_size), np.float32)
        for i in range(L):
            p = self.HF_LAYER_PREFIX.format(i=i)
            sd.setdefault(p + "mlp.gate_proj.weight", zero)
            sd.setdefault(p + "mlp.up_proj.weight", zero)
            sd.setdefault(p + "mlp.down_proj.weight", zero.T)
        params = super().convert_hf_state_dict(sd, dtype)

        def stacked(tmpl, per_expert):
            arr = np.stack([
                np.stack([hf_array(sd, self.HF_LAYER_PREFIX.format(i=i) + tmpl.format(e=e)).T for e in range(E)])
                if per_expert else hf_array(sd, self.HF_LAYER_PREFIX.format(i=i) + tmpl).T
                for i in range(L)
            ])
            return _to_torch(arr, dtype, self.device)

        params["layers"]["mlp"] = {
            "router": {"weight": stacked(self.HF_ROUTER, False)},
            "experts": {
                "gate_proj": {"weight": stacked(self.HF_EXPERT_GATE, True)},
                "up_proj": {"weight": stacked(self.HF_EXPERT_UP, True)},
                "down_proj": {"weight": stacked(self.HF_EXPERT_DOWN, True)},
            },
        }
        return params

    def host_read_tokens(self):
        """Prefill-sized steps of this model may take the grouped MoE route,
        which reads its group sizes on the host (``modules/moe.py``).
        Blockwise-quantized experts (``quantization_type="blockwise"``, an
        expert projection not in ``modules_to_not_convert``) never take it,
        so their steps are all captured."""
        tc = self.config.torch_config
        if tc.quantized and tc.quantization_type == "blockwise":
            skip = skip_keys(tc)
            if any(not any(k in ("layers", "mlp", "experts", name) for k in skip)
                   for name in ("gate_proj", "up_proj", "down_proj")):
                return None
        return grouped_route_tokens(self.moe_spec())

    def mlp_fn(self):
        mspec = self.moe_spec()

        def moe_mlp_fn(mlp_params, hidden, model_spec):
            return moe_layer(mlp_params, hidden, mspec)

        return moe_mlp_fn


@register_model("mixtral")
class MixtralModelBuilder(MoEDecoderModelBuilder):
    """Reference: models/mixtral/modeling_mixtral.py."""


@register_model("qwen3_moe")
class Qwen3MoeModelBuilder(MoEDecoderModelBuilder):
    """Reference: models/qwen3_moe/modeling_qwen3_moe.py: qk norm plus MoE."""

    qk_norm = True
    HF_ROUTER = "mlp.gate.weight"
    HF_EXPERT_GATE = "mlp.experts.{e}.gate_proj.weight"
    HF_EXPERT_DOWN = "mlp.experts.{e}.down_proj.weight"
    HF_EXPERT_UP = "mlp.experts.{e}.up_proj.weight"
