"""DBRX model plugin (counterpart of ``neuronx_distributed_inference_tpu/
models/dbrx.py``): a LayerNorm decoder (no bias), a fused ``Wqkv`` with
``clip_qkv``, and a 16-expert MoE with p-norm renormalized routing.

- The HF config nests ``attn_config`` / ``ffn_config``;
  :class:`DbrxInferenceConfig` flattens them onto the canonical names.
- ``Wqkv`` splits into q / k / v at conversion (``fused_qkv`` fuses them
  again, as for any model); ``clip_qkv`` is ``AttnSpec.qkv_clip``, which
  clamps q, k and v on every path that makes them and keeps the model off
  the fused block B8 (as its LayerNorm does).
- The experts' ``w1`` / ``v1`` / ``w2`` (E * I, H) tensors become the
  stacked gate / up (E, H, I) and down (E, I, H) leaves; the router is
  softmax, top-k, then the p-norm (``MoESpec.norm_weights_p``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from neuronx_distributed_inference_tpu_torch.models.builder import _to_torch, hf_array
from neuronx_distributed_inference_tpu_torch.models.mixtral import MoEDecoderModelBuilder, MoEInferenceConfig
from neuronx_distributed_inference_tpu_torch.models.registry import register_model
from neuronx_distributed_inference_tpu_torch.modules.rope import compute_inv_freq

#: DBRX (the public ``databricks/dbrx-base`` config.json): 132 B
#: parameters in 40 layers, 6.52 GB a layer in bf16
DBRX_BASE = dict(
    model_type="dbrx",
    d_model=6144,
    n_heads=48,
    n_layers=40,
    max_seq_len=32768,
    vocab_size=100352,
    attn_config=dict(kv_n_heads=8, clip_qkv=8, rope_theta=500000),
    ffn_config=dict(
        ffn_hidden_size=10752, moe_num_experts=16, moe_top_k=4, moe_normalize_expert_weights=1,
        ffn_act_fn=dict(name="silu"),
    ),
    tie_word_embeddings=False,
)


def _as_dict(c) -> dict:
    if not c:
        return {}
    if isinstance(c, dict):
        return c
    return c.to_dict() if hasattr(c, "to_dict") else vars(c)


class DbrxInferenceConfig(MoEInferenceConfig):
    """The reference's ``DbrxInferenceConfig``: DBRX's nested
    ``attn_config`` / ``ffn_config`` flattened onto the HF attribute
    names."""

    def add_derived_config(self):
        if hasattr(self, "d_model"):
            self.hidden_size = self.d_model
            self.num_attention_heads = self.n_heads
            self.num_hidden_layers = self.n_layers
            self.max_position_embeddings = getattr(self, "max_seq_len", 4096)
        ac = _as_dict(getattr(self, "attn_config", None))
        fc = _as_dict(getattr(self, "ffn_config", None))
        if ac:
            self.num_key_value_heads = ac.get("kv_n_heads", self.num_attention_heads)
            self.rope_theta = ac.get("rope_theta", 10000.0)
            self.clip_qkv = ac.get("clip_qkv")
        if fc:
            self.intermediate_size = fc.get("ffn_hidden_size")
            self.num_experts = fc.get("moe_num_experts", 1)
            self.num_experts_per_tok = fc.get("moe_top_k", 1)
            act = fc.get("ffn_act_fn") or {}
            self.hidden_act = act.get("name", "silu") if isinstance(act, dict) else "silu"
            # the p-norm exponent of the router; None: no renormalization
            self.moe_normalize_expert_weights = fc.get("moe_normalize_expert_weights", 1)
            self.norm_topk_prob = False
        self.rms_norm_eps = 1e-5  # nn.LayerNorm's default eps
        self.tie_word_embeddings = False


@register_model("dbrx")
class DbrxModelBuilder(MoEDecoderModelBuilder):
    """Reference: models/dbrx/modeling_dbrx.py NeuronDbrxForCausalLM."""

    config_cls = DbrxInferenceConfig
    norm_type = "layernorm"

    def attn_spec(self):
        clip = getattr(self.config, "clip_qkv", None)
        return dataclasses.replace(super().attn_spec(), qkv_clip=float(clip) if clip else None)

    def moe_spec(self):
        p = getattr(self.config, "moe_normalize_expert_weights", 1)
        return dataclasses.replace(super().moe_spec(), norm_weights_p=float(p) if p is not None else None)

    def convert_hf_state_dict(self, sd: Dict, dtype=None) -> Dict:
        """HF DBRX checkpoint -> params: ``Wqkv`` split into q / k / v, the
        experts' (E * I, H) ``w1`` / ``v1`` read as (E, H, I) gate / up and
        ``w2`` as (E, I, H) down, the norms' weights (no bias)."""
        cfg = self.config
        dtype = dtype or self.dtype
        L, D = cfg.num_hidden_layers, self.head_dim
        E, I, H = self.num_experts, self.expert_intermediate, cfg.hidden_size
        q_sz, kv_sz = self.num_heads * D, self.num_kv_heads * D

        def get(name):
            return hf_array(sd, name)

        def stack(fn):
            return _to_torch(np.stack([fn(f"transformer.blocks.{i}.") for i in range(L)]), dtype, self.device)

        def wqkv(p, lo, hi):
            return get(p + "norm_attn_norm.attn.Wqkv.weight")[lo:hi].T

        fp = "ffn.experts.mlp."
        layers = {
            "input_layernorm": {"weight": stack(lambda p: get(p + "norm_attn_norm.norm_1.weight"))},
            "post_attention_layernorm": {"weight": stack(lambda p: get(p + "norm_attn_norm.norm_2.weight"))},
            "self_attn": {
                "q_proj": {"weight": stack(lambda p: wqkv(p, 0, q_sz))},
                "k_proj": {"weight": stack(lambda p: wqkv(p, q_sz, q_sz + kv_sz))},
                "v_proj": {"weight": stack(lambda p: wqkv(p, q_sz + kv_sz, q_sz + 2 * kv_sz))},
                "o_proj": {"weight": stack(lambda p: get(p + "norm_attn_norm.attn.out_proj.weight").T)},
            },
            "mlp": {
                "router": {"weight": stack(lambda p: get(p + "ffn.router.layer.weight").T)},
                "experts": {
                    "gate_proj": {"weight": stack(lambda p: get(p + fp + "w1").reshape(E, I, H).transpose(0, 2, 1))},
                    "up_proj": {"weight": stack(lambda p: get(p + fp + "v1").reshape(E, I, H).transpose(0, 2, 1))},
                    "down_proj": {"weight": stack(lambda p: get(p + fp + "w2").reshape(E, I, H))},
                },
            },
        }
        embed = get("transformer.wte.weight")
        vpad = self.padded_vocab - embed.shape[0]
        lm = get("lm_head.weight").T if "lm_head.weight" in sd else embed.T
        if vpad:
            embed = np.pad(embed, ((0, vpad), (0, 0)))
            lm = np.pad(lm, ((0, 0), (0, vpad)))
        params = {
            "embed_tokens": {"weight": _to_torch(embed, dtype, self.device)},
            "rope": {"inv_freq": compute_inv_freq(cfg).to(self.device)},
            "layers": layers,
            "norm": {"weight": _to_torch(get("transformer.norm_f.weight"), dtype, self.device)},
            "lm_head": {"weight": _to_torch(lm, dtype, self.device)},
        }
        if cfg.torch_config.fused_qkv:
            params = self._fuse_qkv(params)
        return params
