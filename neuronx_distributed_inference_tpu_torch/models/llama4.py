"""Llama4 text model plugin (counterpart of ``neuronx_distributed_inference_
tpu/models/llama4.py``): chunked-attention rope layers interleaved with
global NoPE layers, the weightless L2 qk-norm, NoPE attention temperature
tuning, and the sigmoid-top-k MoE with early affinity modulation and a
shared expert, interleaved with dense MLPs.

- The layers run as ``LayerGroupSpec`` runs of one (MoE?, rope?) pair:
  ``fn_idx = 2 * moe + nope`` picks one of four layer / MLP function pairs,
  and a rope run's ``attention_chunk_size`` sets its masks and B2's chunk
  predicate (NoPE runs attend globally). The params' ``layers`` is a list
  of the runs' stacks. Scout (every layer MoE, every 4th NoPE) is a few
  runs; Maverick's dense / MoE interleave runs single-layer groups.
- A layer (:func:`llama4_decoder_layer`) writes its K/V into the
  full-length contiguous cache, then prefill attends the in-flight K/V
  through B2 with the run's chunk, and decode attends the cache through B1
  under the run's mask (the reference decodes through its plain
  ``attention_decode``, which B1 computes).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import numpy as np
import torch

from neuronx_distributed_inference_tpu_torch.config import InferenceConfig
from neuronx_distributed_inference_tpu_torch.models.base import (
    PHASE_CONTEXT_ENCODING,
    LayerGroupSpec,
    contiguous_decode_attend,
    gated_mlp,
)
from neuronx_distributed_inference_tpu_torch.models.builder import DecoderModelBuilder, _to_torch, hf_array
from neuronx_distributed_inference_tpu_torch.models.registry import register_model
from neuronx_distributed_inference_tpu_torch.modules.attention import attention_prefill, o_project
from neuronx_distributed_inference_tpu_torch.modules.kvcache import update_cache_at_layer
from neuronx_distributed_inference_tpu_torch.modules.moe import (
    MoESpec,
    fuse_shared_expert_params,
    grouped_route_tokens,
    moe_layer,
    shared_expert_mlp,
    shared_expert_shapes,
)
from neuronx_distributed_inference_tpu_torch.modules.norm import rms_norm
from neuronx_distributed_inference_tpu_torch.modules.rope import apply_rope_interleaved, compute_inv_freq
from neuronx_distributed_inference_tpu_torch.ops.quant import linear

#: Llama-4-Scout-17B-16E's text widths (the ``text_config`` of the public
#: ``meta-llama/Llama-4-Scout-17B-16E`` config.json, and transformers'
#: ``Llama4TextConfig()`` defaults): 48 layers, every one MoE (16 experts
#: top-1 and a shared expert), every 4th NoPE, chunked attention of 8192
#: on the rope layers. Its llama3-type ``rope_scaling`` is left out.
LLAMA4_SCOUT = dict(
    model_type="llama4_text",
    hidden_size=5120,
    intermediate_size=8192,
    intermediate_size_mlp=16384,
    num_hidden_layers=48,
    num_attention_heads=40,
    num_key_value_heads=8,
    head_dim=128,
    num_local_experts=16,
    num_experts_per_tok=1,
    interleave_moe_layer_step=1,
    vocab_size=202048,
    attention_chunk_size=8192,
    use_qk_norm=True,
    attn_temperature_tuning=True,
    floor_scale=8192,
    attn_scale=0.1,
    rms_norm_eps=1e-5,
    rope_theta=500000.0,
    rope_scaling=None,
    max_position_embeddings=131072,
    hidden_act="silu",
    tie_word_embeddings=False,
)


def _flatten_text_config(config) -> None:
    """A conditional-generation config nests the decoder's fields in
    ``text_config``: set them on the config itself."""
    text_cfg = getattr(config, "text_config", None)
    if isinstance(text_cfg, dict):
        for k, v in text_cfg.items():
            setattr(config, k, v)


class Llama4TextInferenceConfig(InferenceConfig):
    """Counterpart of the reference's ``Llama4TextInferenceConfig``."""

    _REQUIRED_ATTRS = (
        "hidden_size",
        "num_attention_heads",
        "num_hidden_layers",
        "num_key_value_heads",
        "vocab_size",
    )

    def add_derived_config(self):
        # before the required attributes are checked
        _flatten_text_config(self)


def _l2_norm(x: torch.Tensor) -> torch.Tensor:
    """The weightless L2 norm of Llama4's qk-norm (eps 1e-6), in fp32."""
    xf = x.float()
    return (xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6)).to(x.dtype)


def llama4_decoder_layer(
    layer_params: dict,
    hidden: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    layer_idx: int,
    mask: torch.Tensor,
    slot_ids: torch.Tensor,
    positions: torch.Tensor,
    spec,
    phase: str,
    mlp_fn,
    use_rope: bool = True,
    qk_norm: bool = True,
    temp_tuning: bool = False,
    floor_scale: float = 8192.0,
    attn_scale: float = 0.1,
    key_valid: Optional[torch.Tensor] = None,
    block_inputs=None,
    window: Optional[int] = None,
    chunk: Optional[int] = None,
    # the layer loop's other hints (fused_ok, ring, plain_model): no fused
    # block, ring or paged pool reaches this layer
    **_hints,
):
    """One Llama4 decoder layer (the reference's): complex-pair rope on rope
    layers only, then the weightless L2 qk-norm; on NoPE layers q scaled by
    ``log1p(floor((pos + 1) / floor_scale)) * attn_scale + 1``; write, then
    attend: prefill through B2 with the layer's window / chunk, decode
    through B1 under ``mask``. Returns (hidden, k_cache, v_cache), the
    cache written in place."""
    if block_inputs is not None:
        raise NotImplementedError("Llama4 with the paged cache is not implemented")
    aspec = spec.attn
    sa = layer_params["self_attn"]
    residual = hidden
    hidden = rms_norm(hidden, layer_params["input_layernorm"]["weight"], spec.rms_eps)
    B, S, _ = hidden.shape
    q = linear(sa["q_proj"], hidden).reshape(B, S, aspec.num_heads, aspec.head_dim)
    k = linear(sa["k_proj"], hidden).reshape(B, S, aspec.num_kv_heads, aspec.head_dim)
    v = linear(sa["v_proj"], hidden).reshape(B, S, aspec.num_kv_heads, aspec.head_dim)
    if use_rope:
        q = apply_rope_interleaved(q, cos, sin)
        k = apply_rope_interleaved(k, cos, sin)
        if qk_norm:
            q, k = _l2_norm(q), _l2_norm(k)
    elif temp_tuning:
        scales = torch.log1p(torch.floor((positions.float() + 1.0) / floor_scale)) * attn_scale + 1.0
        q = (q.float() * scales[:, :, None, None]).to(q.dtype)

    k_cache, v_cache = update_cache_at_layer(k_cache, v_cache, k, v, layer_idx, slot_ids, positions)
    if phase == PHASE_CONTEXT_ENCODING:
        attn_out = attention_prefill(q, k, v, mask, aspec, key_valid=key_valid, window=window, chunk=chunk)
    else:
        attn_out = contiguous_decode_attend(q, k_cache, v_cache, layer_idx, mask, spec, aspec)
    hidden = residual + o_project(sa, attn_out, aspec)
    residual = hidden
    hidden = rms_norm(hidden, layer_params["post_attention_layernorm"]["weight"], spec.rms_eps)
    return residual + mlp_fn(layer_params["mlp"], hidden, spec), k_cache, v_cache


@register_model("llama4_text")
@register_model("llama4")
class Llama4TextModelBuilder(DecoderModelBuilder):
    """Reference: models/llama4/modeling_llama4_text.py
    NeuronLlama4ForCausalLM (the text side)."""

    config_cls = Llama4TextInferenceConfig

    def __init__(self, config):
        # a plain InferenceConfig of a conditional-generation model
        if not hasattr(config, "hidden_size"):
            _flatten_text_config(config)
        super().__init__(config)
        tc = config.torch_config
        for flag, why in (
            (tc.is_block_kv_layout, "paged cache"),
            (getattr(tc, "cp_degree", 1) > 1, "context parallelism"),
            (getattr(tc, "attention_dp_degree", 1) > 1, "attention-DP"),
            (getattr(tc, "data_parallel_degree", 1) > 1, "whole-model DP"),
            (tc.fused_qkv, "fused_qkv"),
            (tc.enable_fused_speculation, "fused speculation"),
            (tc.lora_config is not None, "LoRA serving"),
        ):
            if flag:
                raise NotImplementedError(f"Llama4 with {why} is not implemented")
        L = config.num_hidden_layers
        step = getattr(config, "interleave_moe_layer_step", 1)
        moe_layers = getattr(config, "moe_layers", None)
        if moe_layers is None:
            moe_layers = [i for i in range(L) if (i + 1) % max(step, 1) == 0]
        moe_set = set(moe_layers)
        self.is_moe = [i in moe_set for i in range(L)]
        # 1 = rope (the HF convention): every 4th layer NoPE by default
        no_rope = getattr(config, "no_rope_layers", None) or [int((i + 1) % 4 != 0) for i in range(L)]
        self.use_rope = [bool(x) for x in no_rope]
        self.chunk = getattr(config, "attention_chunk_size", None)
        # contiguous runs of one (moe?, rope?) pair
        self.runs = []
        start = 0
        for i in range(1, L + 1):
            if i == L or (self.is_moe[i], self.use_rope[i]) != (self.is_moe[start], self.use_rope[start]):
                self.runs.append((start, i))
                start = i

    def _fn_idx(self, i: int) -> int:
        return 2 * int(self.is_moe[i]) + int(not self.use_rope[i])

    def model_spec(self):
        groups = tuple(
            LayerGroupSpec(
                num_layers=e - s,
                # rope layers attend in chunks, NoPE layers globally
                attention_chunk_size=self.chunk if self.use_rope[s] else None,
                fn_idx=self._fn_idx(s),
            )
            for s, e in self.runs
        )
        return dataclasses.replace(
            super().model_spec(), layer_groups=groups, attention_chunk_size=None, sliding_window=None
        )

    def moe_spec(self) -> MoESpec:
        cfg = self.config
        tc = cfg.torch_config
        return MoESpec(
            num_experts=cfg.num_local_experts,
            top_k=getattr(cfg, "num_experts_per_tok", 1),
            router_dtype=getattr(tc, "router_dtype", "float32"),
            scoring_func="sigmoid_topk",
            normalize_top_k_affinities=False,
            early_affinity_modulation=True,
            act=getattr(cfg, "hidden_act", "silu"),
            capacity_factor=getattr(tc, "capacity_factor", None),
            ep_degree=tc.ep_degree,
            moe_fused_kernel=getattr(tc, "moe_fused_kernel_enabled", None),
        )

    def host_read_tokens(self):
        """A MoE run's grouped prefill route reads its group sizes on the
        host (``modules/moe.py``); a model of dense runs only never does."""
        return grouped_route_tokens(self.moe_spec()) if any(self.is_moe) else None

    def mlp_fn(self):
        mspec = self.moe_spec()
        act = getattr(self.config, "hidden_act", "silu")

        def moe_mlp_fn(mlp_params, hidden, model_spec):
            return moe_layer(mlp_params, hidden, mspec, shared_mlp_fn=lambda p, x: shared_expert_mlp(p, x, act))

        # fn_idx: 0 / 1 dense (rope / NoPE), 2 / 3 MoE (rope / NoPE)
        return [gated_mlp, gated_mlp, moe_mlp_fn, moe_mlp_fn]

    def layer_fn(self):
        cfg = self.config
        common = dict(
            qk_norm=bool(getattr(cfg, "use_qk_norm", True)),
            temp_tuning=bool(getattr(cfg, "attn_temperature_tuning", False)),
            floor_scale=float(getattr(cfg, "floor_scale", 8192.0)),
            attn_scale=float(getattr(cfg, "attn_scale", 0.1)),
        )
        rope_layer = functools.partial(llama4_decoder_layer, use_rope=True, **common)
        nope_layer = functools.partial(llama4_decoder_layer, use_rope=False, **common)
        return [rope_layer, nope_layer, rope_layer, nope_layer]

    # ---- params ----------------------------------------------------------

    def _group_shapes(self, s: int, e: int) -> Dict:
        cfg = self.config
        n, H = e - s, cfg.hidden_size
        D, Hq, Hkv = self.head_dim, self.num_heads, self.num_kv_heads
        shapes = {
            "input_layernorm": {"weight": (n, H)},
            "post_attention_layernorm": {"weight": (n, H)},
            "self_attn": {
                "q_proj": {"weight": (n, H, Hq * D)},
                "k_proj": {"weight": (n, H, Hkv * D)},
                "v_proj": {"weight": (n, H, Hkv * D)},
                "o_proj": {"weight": (n, Hq * D, H)},
            },
        }
        if self.is_moe[s]:
            E, I = cfg.num_local_experts, cfg.intermediate_size
            shapes["mlp"] = {
                "router": {"weight": (n, H, E)},
                "experts": {
                    "gate_proj": {"weight": (n, E, H, I)},
                    "up_proj": {"weight": (n, E, H, I)},
                    "down_proj": {"weight": (n, E, I, H)},
                },
                "shared_experts": shared_expert_shapes(
                    n, H, I, bool(getattr(cfg.torch_config, "fused_shared_experts", False))
                ),
            }
        else:
            I = getattr(cfg, "intermediate_size_mlp", cfg.intermediate_size)
            shapes["mlp"] = {
                "gate_proj": {"weight": (n, H, I)},
                "up_proj": {"weight": (n, H, I)},
                "down_proj": {"weight": (n, I, H)},
            }
        return shapes

    def param_shapes(self) -> Dict:
        cfg = self.config
        H, V = cfg.hidden_size, self.padded_vocab
        shapes = {
            "embed_tokens": {"weight": (V, H)},
            "layers": [self._group_shapes(s, e) for s, e in self.runs],
            "norm": {"weight": (H,)},
        }
        if not getattr(cfg, "tie_word_embeddings", False):
            shapes["lm_head"] = {"weight": (H, V)}
        return shapes

    def random_params(self, std: float = 0.05) -> Dict:
        """Seeded random weights at the reference's std 0.05, norms ones."""
        return super().random_params(std=std)

    def convert_hf_state_dict(self, sd: Dict, dtype: Optional[torch.dtype] = None) -> Dict:
        """HF ``Llama4ForCausalLM`` checkpoint -> the per-run params: (out,
        in) projections transposed; a MoE layer's ``experts.gate_up_proj``
        (E, H, 2 I) split into its gate and up halves, ``experts.down_proj``
        (E, I, H) as it is, the router and the shared expert transposed (the
        shared expert fused when ``fused_shared_experts``); a dense layer's
        MLP transposed."""
        cfg = self.config
        dtype = dtype or self.dtype

        def get(name):
            return hf_array(sd, name)

        def lt(name):  # (out, in) -> (in, out)
            return get(name).T

        def layer(i):
            p = f"model.layers.{i}."
            f = p + "feed_forward."
            out = {
                "input_layernorm": {"weight": get(p + "input_layernorm.weight")},
                "post_attention_layernorm": {"weight": get(p + "post_attention_layernorm.weight")},
                "self_attn": {
                    n: {"weight": lt(p + f"self_attn.{n}.weight")} for n in ("q_proj", "k_proj", "v_proj", "o_proj")
                },
            }
            if self.is_moe[i]:
                gate_up = get(f + "experts.gate_up_proj")  # (E, H, 2I)
                I = gate_up.shape[-1] // 2
                out["mlp"] = {
                    "router": {"weight": lt(f + "router.weight")},
                    "experts": {
                        "gate_proj": {"weight": gate_up[..., :I]},
                        "up_proj": {"weight": gate_up[..., I:]},
                        "down_proj": {"weight": get(f + "experts.down_proj")},
                    },
                    "shared_experts": {
                        n: {"weight": lt(f + f"shared_expert.{n}.weight")} for n in ("gate_proj", "up_proj", "down_proj")
                    },
                }
            else:
                out["mlp"] = {n: {"weight": lt(f + f"{n}.weight")} for n in ("gate_proj", "up_proj", "down_proj")}
            return out

        def stack(*xs):
            if isinstance(xs[0], dict):
                return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
            return _to_torch(np.stack(xs), dtype, self.device)

        groups = []
        for s, e in self.runs:
            group = stack(*(layer(i) for i in range(s, e)))
            shared = group["mlp"].get("shared_experts")
            if shared is not None and getattr(cfg.torch_config, "fused_shared_experts", False):
                group["mlp"]["shared_experts"] = fuse_shared_expert_params(shared)
            groups.append(group)
        embed = get("model.embed_tokens.weight")
        vpad = self.padded_vocab - embed.shape[0]
        lm = lt("lm_head.weight") if "lm_head.weight" in sd else embed.T
        if vpad:
            embed = np.pad(embed, ((0, vpad), (0, 0)))
            lm = np.pad(lm, ((0, 0), (0, vpad)))
        return {
            "embed_tokens": {"weight": _to_torch(embed, dtype, self.device)},
            "rope": {"inv_freq": compute_inv_freq(cfg).to(self.device)},
            "layers": groups,
            "norm": {"weight": _to_torch(get("model.norm.weight"), dtype, self.device)},
            "lm_head": {"weight": _to_torch(lm, dtype, self.device)},
        }
