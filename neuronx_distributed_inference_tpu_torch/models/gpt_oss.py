"""GPT-OSS model plugin (counterpart of ``neuronx_distributed_inference_tpu/
models/gpt_oss.py``): learned attention sinks, interleaved sliding / global
layers, biased attention and a biased clamped-swiglu MoE.

- ``layer_types`` become :class:`~.base.LayerGroupSpec` runs; the sinks are
  the attention's ``sink`` leaves, which B1, B2 and B4 take.
- The expert math is :class:`~..modules.moe.MoESpec` with softmax-after-top-k
  routing, a router bias, ``act_scale`` 1.702, ``act_bias`` 1 and the
  ``swiglu_limit`` clamp; HF's interleaved ``gate_up_proj`` is
  de-interleaved into gate / up at load.
- The KV cache is sized per layer where the layout allows it
  (:func:`~.builder.ring_layout_ok`): the sliding layers ring-bound to W
  slots, the global layers on full-length lines
  (``modules/kvcache.InterleavedKVCache``). On the paged pool every layer
  keeps full-length lines and the sliding layers take windowed masks.
- MXFP4 checkpoints (``*_blocks`` / ``*_scales``) dequantize on the device
  one tensor at a time (``ops/mxfp4.py``), never the whole checkpoint at
  once.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from neuronx_distributed_inference_tpu_torch.config import InferenceConfig
from neuronx_distributed_inference_tpu_torch.models.base import LayerGroupSpec
from neuronx_distributed_inference_tpu_torch.models.builder import (
    DecoderModelBuilder,
    _to_torch,
    hf_array,
    ring_layout_ok,
)
from neuronx_distributed_inference_tpu_torch.models.mixtral import MoEDecoderModelBuilder
from neuronx_distributed_inference_tpu_torch.models.registry import register_model
from neuronx_distributed_inference_tpu_torch.modules.moe import MoESpec
from neuronx_distributed_inference_tpu_torch.ops.mxfp4 import BLOCKS, SCALES, dequantize_mxfp4

#: GPT-OSS-20B (the public ``openai/gpt-oss-20b`` config.json): 20.9 B
#: parameters, 41.8 GB in bf16 (experts 38.2 GB)
GPT_OSS_20B = dict(
    model_type="gpt_oss",
    hidden_size=2880,
    intermediate_size=2880,
    num_hidden_layers=24,
    num_attention_heads=64,
    num_key_value_heads=8,
    head_dim=64,
    num_local_experts=32,
    num_experts_per_tok=4,
    layer_types=["sliding_attention", "full_attention"] * 12,
    sliding_window=128,
    vocab_size=201088,
    rms_norm_eps=1e-5,
    rope_theta=150000.0,
    rope_scaling=dict(
        rope_type="yarn", factor=32.0, beta_fast=32.0, beta_slow=1.0,
        original_max_position_embeddings=4096, truncate=False,
    ),
    max_position_embeddings=131072,
    swiglu_limit=7.0,
    hidden_act="silu",
    attention_bias=True,
    tie_word_embeddings=False,
)


class GptOssInferenceConfig(InferenceConfig):
    """Counterpart of the reference ``GptOssInferenceConfig``."""

    _REQUIRED_ATTRS = (
        "hidden_size",
        "num_attention_heads",
        "num_hidden_layers",
        "num_key_value_heads",
        "vocab_size",
        "num_local_experts",
    )


def _layer_runs(layer_types: List[str]) -> List[Tuple[int, int, str]]:
    """Contiguous (start, end, type) runs of ``layer_types``."""
    runs = []
    start = 0
    for i in range(1, len(layer_types) + 1):
        if i == len(layer_types) or layer_types[i] != layer_types[start]:
            runs.append((start, i, layer_types[start]))
            start = i
    return runs


@register_model("gpt_oss")
class GptOssModelBuilder(MoEDecoderModelBuilder):
    """Reference: models/gpt_oss/modeling_gpt_oss.py NeuronGptOssForCausalLM.
    One stacked param tree for all layers (they are structurally uniform);
    ``ModelSpec.layer_groups`` carries each layer's attention flavor."""

    qkv_bias = True
    o_bias = True

    def __init__(self, config):
        super().__init__(config)
        L = config.num_hidden_layers
        self.layer_types = list(
            getattr(config, "layer_types", None)
            or ["sliding_attention" if i % 2 == 0 else "full_attention" for i in range(L)]
        )
        self.runs = _layer_runs(self.layer_types)

    def attn_spec(self):
        return dataclasses.replace(super().attn_spec(), has_sink=True)

    def model_spec(self):
        tc = self.config.torch_config
        spec = super().model_spec()
        sw = getattr(self.config, "sliding_window", None)
        groups = tuple(
            LayerGroupSpec(num_layers=e - s, sliding_window=sw if t == "sliding_attention" else None)
            for s, e, t in self.runs
        )
        # per-layer cache sizing where the layout allows a ring (the
        # reference's gate: both flavors present, W < seq_len)
        kinds = {t for _, _, t in self.runs}
        ring = bool(
            sw and sw < tc.seq_len and kinds == {"sliding_attention", "full_attention"} and ring_layout_ok(tc)
        )
        return dataclasses.replace(
            spec, layer_groups=groups, sliding_window=None, bounded_window=None,
            ring_window=sw if ring else None,
        )

    def init_kv_cache(self):
        spec = self.model_spec()
        if spec.ring_window is None:
            return super().init_kv_cache()
        from neuronx_distributed_inference_tpu_torch.modules.kvcache import init_interleaved_cache

        tc = self.config.torch_config
        if tc.kv_quantized:
            # the reference's refusal: the interleaved stacks carry no scale
            # streams
            raise NotImplementedError(
                "kv_cache_dtype int8/fp8 is not implemented for the "
                "interleaved (GPT-OSS sliding/global) cache; supported cache "
                "variants: contiguous, ring-bounded, and paged"
            )
        num_sliding = sum(t == "sliding_attention" for t in self.layer_types)
        return init_interleaved_cache(
            len(self.layer_types) - num_sliding, num_sliding, tc.max_batch_size, tc.seq_len,
            spec.ring_window, self.num_kv_heads, self.head_dim, dtype=tc.kv_dtype, device=self.device,
        )

    def moe_spec(self) -> MoESpec:
        cfg = self.config
        tc = cfg.torch_config
        # model constants, set as the reference's plugin sets them
        return MoESpec(
            num_experts=cfg.num_local_experts,
            top_k=getattr(cfg, "num_experts_per_tok", 4),
            router_dtype=getattr(tc, "router_dtype", "float32"),
            scoring_func="softmax_topk",
            router_bias=True,
            act_scale=1.702,
            act_bias=1.0,
            swiglu_limit=float(getattr(cfg, "swiglu_limit", 7.0) or 7.0),
            capacity_factor=getattr(tc, "capacity_factor", None),
            ep_degree=tc.ep_degree,
            moe_fused_kernel=getattr(tc, "moe_fused_kernel_enabled", None),
        )

    # ---- params ------------------------------------------------------------

    def param_shapes(self) -> Dict:
        shapes = super().param_shapes()
        cfg = self.config
        L, H, E = cfg.num_hidden_layers, cfg.hidden_size, self.num_experts
        I = self.expert_intermediate
        shapes["layers"]["self_attn"]["sink"] = {"weight": (L, self.num_heads)}
        mlp = shapes["layers"]["mlp"]
        mlp["router"]["bias"] = (L, E)
        mlp["experts"]["gate_proj"]["bias"] = (L, E, I)
        mlp["experts"]["up_proj"]["bias"] = (L, E, I)
        mlp["experts"]["down_proj"]["bias"] = (L, E, H)
        return shapes

    def random_params(self, std: float = 0.05) -> Dict:
        """Seeded random weights at the reference's std 0.05, norms ones."""
        return super().random_params(std=std)

    def _expert_leaf(self, sd: Dict, name: str, dtype: torch.dtype) -> torch.Tensor:
        """One layer's (E, in, out) expert tensor on the device: a plain HF
        tensor, or an MXFP4 pair dequantized there, an expert at a time."""
        if name + BLOCKS in sd:
            return dequantize_mxfp4(sd[name + BLOCKS], sd[name + SCALES], dtype, self.device)
        return _to_torch(sd[name], dtype, self.device)

    def convert_hf_state_dict(self, sd, dtype=None):
        """HF checkpoint (plain or MXFP4-packed experts) -> params. The
        attention, norms, embedding and head convert as the llama family
        does (with q/k/v/o biases); sinks and router stack per layer; the
        experts fill preallocated (L, E, in, out) leaves one layer at a
        time, HF's [g0, u0, g1, u1, ...] ``gate_up_proj`` de-interleaved,
        so the fp32 transient is one layer's dequantized tensor at most."""
        cfg = self.config
        dtype = dtype or self.dtype
        L, H, E, I = cfg.num_hidden_layers, cfg.hidden_size, self.num_experts, self.expert_intermediate
        prefixes = [self.HF_LAYER_PREFIX.format(i=i) for i in range(L)]
        # the base conversion reads dense mlp names: tiny placeholders, then
        # its mlp is replaced below
        base_sd = dict(sd)
        zero = np.zeros((1, H), np.float32)
        for p in prefixes:
            for n, z in (("gate_proj", zero), ("up_proj", zero), ("down_proj", zero.T)):
                base_sd.setdefault(p + f"mlp.{n}.weight", z)
        params = DecoderModelBuilder.convert_hf_state_dict(self, base_sd, dtype)

        def stack(suffix, transpose=False):
            arr = np.stack([hf_array(sd, p + suffix).T if transpose else hf_array(sd, p + suffix) for p in prefixes])
            return _to_torch(arr, dtype, self.device)

        params["layers"]["self_attn"]["sink"] = {"weight": stack("self_attn.sinks")}
        shapes = {"gate_proj": (E, H, I), "up_proj": (E, H, I), "down_proj": (E, I, H)}
        experts = {
            n: {"weight": torch.empty((L, *s), dtype=dtype, device=self.device)} for n, s in shapes.items()
        }
        for i, p in enumerate(prefixes):
            pe = p + "mlp.experts."
            gate_up = self._expert_leaf(sd, pe + "gate_up_proj", dtype)  # (E, H, 2I)
            experts["gate_proj"]["weight"][i].copy_(gate_up[..., 0::2])
            experts["up_proj"]["weight"][i].copy_(gate_up[..., 1::2])
            del gate_up
            experts["down_proj"]["weight"][i].copy_(self._expert_leaf(sd, pe + "down_proj", dtype))
        gate_up_b = stack("mlp.experts.gate_up_proj_bias")  # (L, E, 2I)
        experts["gate_proj"]["bias"] = gate_up_b[..., 0::2].contiguous()
        experts["up_proj"]["bias"] = gate_up_b[..., 1::2].contiguous()
        experts["down_proj"]["bias"] = stack("mlp.experts.down_proj_bias")
        params["layers"]["mlp"] = {
            "router": {"weight": stack("mlp.router.weight", transpose=True), "bias": stack("mlp.router.bias")},
            "experts": experts,
        }
        return params
