"""DeepSeek-V3 model plugin (counterpart of ``neuronx_distributed_inference_
tpu/models/deepseek.py``): MLA attention on a latent cache, sigmoid
group-limited MoE routing with a correction bias, shared experts, and
dense-first layers.

- MLA uses weight absorption, as the reference decodes: the cache holds the
  compressed latent ``c`` (kv_lora_rank values a token) in its K stream and
  the shared rope key ``k_pe`` (qk_rope_head_dim) in its V stream, one
  "head" each, so a token a layer costs r_kv + d_rope values instead of 2 x
  H x D. Scores are ``(q_nope W_k) . c + q_pe . k_pe`` and the output
  ``(probs . c) W_v``. The reference computes this with einsums and no
  Pallas kernel, so :func:`mla_decoder_layer` is plain PyTorch.
- ``first_k_dense_replace`` dense layers, then MoE layers: two
  ``LayerGroupSpec`` groups whose ``fn_idx`` picks ``gated_mlp`` or the MoE
  block (``mlp_fn()`` returns both); the params' ``layers`` is a list of
  the two groups' stacks.
- The MoE router is ``MoESpec``'s sigmoid scoring with the
  ``e_score_correction_bias`` leaf, group-limited top-k and
  ``routed_scaling_factor``; the shared experts
  (``modules/moe.shared_expert_mlp``) add after the route.
- YaRN: cos / sin carry ``rope_attention_scaling`` and the softmax scale
  ``yarn_mscale(factor, mscale_all_dim) ** 2``, as in the reference.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from neuronx_distributed_inference_tpu_torch.config import InferenceConfig
from neuronx_distributed_inference_tpu_torch.models.base import LayerGroupSpec, gated_mlp
from neuronx_distributed_inference_tpu_torch.models.builder import DecoderModelBuilder, _to_torch, hf_array
from neuronx_distributed_inference_tpu_torch.models.registry import register_model
from neuronx_distributed_inference_tpu_torch.modules.kvcache import (
    KVCache,
    QuantizedKV,
    dequantize_kv,
    init_cache,
    update_cache_at_layer,
)
from neuronx_distributed_inference_tpu_torch.modules.moe import (
    MoESpec,
    fuse_shared_expert_params,
    grouped_route_tokens,
    moe_layer,
    shared_expert_mlp,
    shared_expert_shapes,
)
from neuronx_distributed_inference_tpu_torch.modules.norm import rms_norm
from neuronx_distributed_inference_tpu_torch.modules.rope import apply_rope, compute_inv_freq, yarn_mscale
from neuronx_distributed_inference_tpu_torch.ops.quant import linear

#: DeepSeek-V3 (the public ``deepseek-ai/DeepSeek-V3`` config.json): 671 B
#: parameters in 61 layers, the first 3 dense
DEEPSEEK_V3 = dict(
    model_type="deepseek_v3",
    hidden_size=7168,
    intermediate_size=18432,
    moe_intermediate_size=2048,
    num_hidden_layers=61,
    num_attention_heads=128,
    num_key_value_heads=128,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    n_routed_experts=256,
    n_shared_experts=1,
    num_experts_per_tok=8,
    n_group=8,
    topk_group=4,
    routed_scaling_factor=2.5,
    scoring_func="sigmoid",
    norm_topk_prob=True,
    first_k_dense_replace=3,
    vocab_size=129280,
    rms_norm_eps=1e-6,
    rope_theta=10000.0,
    rope_scaling=dict(
        type="yarn", factor=40, mscale=1.0, mscale_all_dim=1.0, original_max_position_embeddings=4096,
        beta_fast=32, beta_slow=1,
    ),
    max_position_embeddings=163840,
    hidden_act="silu",
    tie_word_embeddings=False,
)


class DeepseekV3InferenceConfig(InferenceConfig):
    """Counterpart of the reference ``DeepseekV3InferenceConfig``."""

    _REQUIRED_ATTRS = (
        "hidden_size",
        "num_attention_heads",
        "num_hidden_layers",
        "vocab_size",
        "kv_lora_rank",
        "qk_nope_head_dim",
        "qk_rope_head_dim",
        "v_head_dim",
    )

    def add_derived_config(self):
        # the rope tables cover the rope sub-dimension only
        self.rope_dim = self.qk_rope_head_dim


@dataclass(frozen=True)
class MLASpec:
    """Static MLA dims (the reference's MLASpec)."""

    num_heads: int
    q_lora_rank: Optional[int]
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    scale: float
    rms_eps: float

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


def mla_decoder_layer(
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
    mla: MLASpec = None,
    block_inputs=None,
    # the layer loop's other hints (key_valid, fused_ok, window, ...): this
    # layer's attention reads everything from ``mask``
    **_hints,
):
    """One MLA decoder layer (the reference's, with weight absorption),
    write-then-attend on the latent cache: the K stream holds ``c`` as one
    "head" of kv_lora_rank values, the V stream ``k_pe`` as one head of
    qk_rope_head_dim. Products accumulate in fp32; the softmax is fp32 with
    ``finfo(float32).min`` at masked scores. Returns (hidden, k_cache,
    v_cache), the cache written in place."""
    if block_inputs is not None:
        raise NotImplementedError("MLA with the paged cache is not implemented")
    sa = layer_params["self_attn"]
    residual = hidden
    hidden = rms_norm(hidden, layer_params["input_layernorm"]["weight"], spec.rms_eps)
    B, S, _ = hidden.shape
    H = mla.num_heads

    # q: low-rank (or direct) projection, split nope / rope
    if mla.q_lora_rank:
        q = linear(sa["q_a_proj"], hidden)
        q = rms_norm(q, sa["q_a_layernorm"]["weight"], mla.rms_eps)
        q = linear(sa["q_b_proj"], q)
    else:
        q = linear(sa["q_proj"], hidden)
    q = q.reshape(B, S, H, mla.q_head_dim)
    q_nope = q[..., : mla.qk_nope_head_dim]
    q_pe = apply_rope(q[..., mla.qk_nope_head_dim :], cos, sin)

    # the compressed kv and the rope key
    ckv = linear(sa["kv_a_proj"], hidden)  # (B, S, r_kv + d_rope)
    c = rms_norm(ckv[..., : mla.kv_lora_rank], sa["kv_a_layernorm"]["weight"], mla.rms_eps)
    k_pe = apply_rope(ckv[..., None, mla.kv_lora_rank :], cos, sin)  # (B, S, 1, d_rope)

    # q_nope absorbed into the latent space: (B,S,H,d_nope) . (H,d_nope,r)
    q_c = torch.einsum("bshd,hdr->bshr", q_nope, sa["k_absorb"]["weight"].to(q.dtype))

    k_cache, v_cache = update_cache_at_layer(k_cache, v_cache, c[:, :, None, :], k_pe, layer_idx, slot_ids, positions)
    # each row reads its own cache line (the reference reads lines 0..B-1,
    # the same lines wherever seq_ids is arange(B), as in generate()); a
    # quantized stream dequantizes by its own (1,) scale after the slice, to
    # fp32, as the reference's read_cache_at_layer does
    W = mask.shape[-1]
    if isinstance(k_cache, QuantizedKV):
        c_all = dequantize_kv(k_cache.data[layer_idx, slot_ids, :W], k_cache.scale[layer_idx])[:, :, 0]
        pe_all = dequantize_kv(v_cache.data[layer_idx, slot_ids, :W], v_cache.scale[layer_idx])[:, :, 0]
    else:
        c_all = k_cache[layer_idx, slot_ids, :W, 0]  # (B, W, r)
        pe_all = v_cache[layer_idx, slot_ids, :W, 0]  # (B, W, d_rope)

    scores = (
        torch.einsum("bshr,bwr->bhsw", q_c.float(), c_all.to(q.dtype).float())
        + torch.einsum("bshd,bwd->bhsw", q_pe.float(), pe_all.to(q.dtype).float())
    ) * mla.scale
    scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    latent = torch.einsum("bhsw,bwr->bshr", probs.to(c_all.dtype).float(), c_all.float()).to(hidden.dtype)
    out = torch.einsum("bshr,hrd->bshd", latent, sa["v_absorb"]["weight"].to(hidden.dtype))

    hidden = residual + linear(sa["o_proj"], out.reshape(B, S, H * mla.v_head_dim))
    residual = hidden
    hidden = rms_norm(hidden, layer_params["post_attention_layernorm"]["weight"], spec.rms_eps)
    return residual + mlp_fn(layer_params["mlp"], hidden, spec), k_cache, v_cache


@register_model("deepseek_v3")
class DeepseekV3ModelBuilder(DecoderModelBuilder):
    """Reference: models/deepseek/modeling_deepseek.py NeuronDeepseekForCausalLM."""

    config_cls = DeepseekV3InferenceConfig
    is_moe = True

    def __init__(self, config):
        super().__init__(config)
        tc = config.torch_config
        for flag, why in (
            (tc.is_block_kv_layout, "paged cache"),
            (getattr(tc, "cp_degree", 1) > 1, "context parallelism"),
            (getattr(tc, "attention_dp_degree", 1) > 1, "attention-DP"),
            (getattr(tc, "data_parallel_degree", 1) > 1, "whole-model DP"),
            (tc.fused_qkv, "fused_qkv"),
            (tc.lora_config is not None, "LoRA serving"),
        ):
            if flag:
                raise NotImplementedError(f"DeepSeek-V3 MLA with {why} is not implemented")
        if tc.quantized or tc.weight_int4:
            raise NotImplementedError(
                "DeepSeek-V3 MLA with quantized weights is not ported to PyTorch yet "
                "(ROADMAP A9 (MLA with quantized weights))"
            )
        # one model-parallel shard: the reference's head padding is the
        # identity here
        self.q_heads = config.num_attention_heads
        self.first_dense = getattr(config, "first_k_dense_replace", 0)

    @property
    def num_experts(self) -> int:
        return getattr(self.config, "n_routed_experts")

    def mla_spec(self) -> MLASpec:
        cfg = self.config
        scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
        scaling = getattr(cfg, "rope_scaling", None) or {}
        if scaling.get("mscale_all_dim"):
            m = yarn_mscale(scaling.get("factor", 1.0), scaling["mscale_all_dim"])
            scale = scale * m * m
        return MLASpec(
            num_heads=self.q_heads,
            q_lora_rank=getattr(cfg, "q_lora_rank", None),
            kv_lora_rank=cfg.kv_lora_rank,
            qk_nope_head_dim=cfg.qk_nope_head_dim,
            qk_rope_head_dim=cfg.qk_rope_head_dim,
            v_head_dim=cfg.v_head_dim,
            scale=scale,
            rms_eps=getattr(cfg, "rms_norm_eps", 1e-6),
        )

    def moe_spec(self) -> MoESpec:
        cfg = self.config
        tc = cfg.torch_config
        return MoESpec(
            num_experts=self.num_experts,
            top_k=getattr(cfg, "num_experts_per_tok", 8),
            normalize_top_k_affinities=bool(getattr(cfg, "norm_topk_prob", True)),
            router_dtype=getattr(tc, "router_dtype", "float32"),
            act=getattr(cfg, "hidden_act", "silu"),
            scoring_func=getattr(cfg, "scoring_func", "sigmoid"),
            routed_scaling_factor=float(getattr(cfg, "routed_scaling_factor", 1.0)),
            n_group=getattr(cfg, "n_group", 1),
            topk_group=getattr(cfg, "topk_group", 1),
            capacity_factor=getattr(tc, "capacity_factor", None),
            ep_degree=tc.ep_degree,
            moe_fused_kernel=getattr(tc, "moe_fused_kernel_enabled", None),
        )

    def model_spec(self):
        spec = super().model_spec()
        L = self.config.num_hidden_layers
        groups = []
        if self.first_dense:
            groups.append(LayerGroupSpec(num_layers=self.first_dense, fn_idx=0))
        if L - self.first_dense > 0:
            groups.append(LayerGroupSpec(num_layers=L - self.first_dense, fn_idx=1))
        return dataclasses.replace(spec, layer_groups=tuple(groups))

    def host_read_tokens(self):
        """The MoE layers' grouped route reads its group sizes on the host
        (``modules/moe.py``), as Qwen3-MoE's does."""
        return grouped_route_tokens(self.moe_spec())

    def mlp_fn(self):
        mspec = self.moe_spec()
        act = getattr(self.config, "hidden_act", "silu")
        shared = (lambda p, x: shared_expert_mlp(p, x, act)) if getattr(self.config, "n_shared_experts", 0) else None

        def moe_mlp_fn(mlp_params, hidden, model_spec):
            return moe_layer(mlp_params, hidden, mspec, shared_mlp_fn=shared)

        return [gated_mlp, moe_mlp_fn]

    def layer_fn(self):
        return functools.partial(mla_decoder_layer, mla=self.mla_spec())

    # ---- cache: the latent streams -------------------------------------

    def init_kv_cache(self) -> KVCache:
        """The latent cache: K one head of kv_lora_rank, V one head of
        qk_rope_head_dim; an int8/fp8 ``kv_cache_dtype`` makes each a
        QuantizedKV stream with its own (L, 1) scales."""
        cfg = self.config
        tc = cfg.torch_config
        return init_cache(
            cfg.num_hidden_layers, tc.max_batch_size, tc.seq_len, 1, cfg.kv_lora_rank, dtype=tc.kv_dtype,
            device=self.device, v_heads=1, v_head_dim=cfg.qk_rope_head_dim,
        )

    # ---- params ----------------------------------------------------------

    def _group_sizes(self) -> Tuple[int, int]:
        return self.first_dense, self.config.num_hidden_layers - self.first_dense

    def _attn_shapes(self, L: int) -> Dict:
        cfg = self.config
        H, Hq = cfg.hidden_size, self.q_heads
        dq = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        r_q = getattr(cfg, "q_lora_rank", None)
        shapes = {
            "kv_a_proj": {"weight": (L, H, cfg.kv_lora_rank + cfg.qk_rope_head_dim)},
            "kv_a_layernorm": {"weight": (L, cfg.kv_lora_rank)},
            "k_absorb": {"weight": (L, Hq, cfg.qk_nope_head_dim, cfg.kv_lora_rank)},
            "v_absorb": {"weight": (L, Hq, cfg.kv_lora_rank, cfg.v_head_dim)},
            "o_proj": {"weight": (L, Hq * cfg.v_head_dim, H)},
        }
        if r_q:
            shapes["q_a_proj"] = {"weight": (L, H, r_q)}
            shapes["q_a_layernorm"] = {"weight": (L, r_q)}
            shapes["q_b_proj"] = {"weight": (L, r_q, Hq * dq)}
        else:
            shapes["q_proj"] = {"weight": (L, H, Hq * dq)}
        return shapes

    def _moe_mlp_shapes(self, L: int) -> Dict:
        cfg = self.config
        H, E, I = cfg.hidden_size, self.num_experts, cfg.moe_intermediate_size
        shapes = {
            "router": {"weight": (L, H, E), "e_score_correction_bias": (L, E)},
            "experts": {
                "gate_proj": {"weight": (L, E, H, I)},
                "up_proj": {"weight": (L, E, H, I)},
                "down_proj": {"weight": (L, E, I, H)},
            },
        }
        n_shared = getattr(cfg, "n_shared_experts", 0)
        if n_shared:
            shapes["shared_experts"] = shared_expert_shapes(
                L, H, I * n_shared, bool(getattr(cfg.torch_config, "fused_shared_experts", False))
            )
        return shapes

    def param_shapes(self) -> Dict:
        cfg = self.config
        H, I, V = cfg.hidden_size, cfg.intermediate_size, self.padded_vocab
        groups = []
        for n, mlp in zip(self._group_sizes(), ("dense", "moe")):
            if not n:
                continue
            groups.append({
                "input_layernorm": {"weight": (n, H)},
                "post_attention_layernorm": {"weight": (n, H)},
                "self_attn": self._attn_shapes(n),
                "mlp": {
                    "gate_proj": {"weight": (n, H, I)},
                    "up_proj": {"weight": (n, H, I)},
                    "down_proj": {"weight": (n, I, H)},
                } if mlp == "dense" else self._moe_mlp_shapes(n),
            })
        return {
            "embed_tokens": {"weight": (V, H)},
            "layers": groups,
            "norm": {"weight": (H,)},
            "lm_head": {"weight": (H, V)},
        }

    def random_params(self, std: float = 0.05) -> Dict:
        """Seeded random weights at the reference's std 0.05, the norms
        (MLA's q_a / kv_a norms too) ones and the correction bias zeros, as
        the reference's random params set them."""
        params = super().random_params(std=std)
        for group in params["layers"]:
            router = group["mlp"].get("router")
            if router is not None:
                router["e_score_correction_bias"].zero_()
        return params

    def convert_hf_state_dict(self, sd: Dict, dtype: Optional[torch.dtype] = None) -> Dict:
        """HF DeepSeek-V3 checkpoint -> the per-group params: ``kv_b_proj``
        split into the absorption tensors ``k_absorb`` (H, d_nope, r) and
        ``v_absorb`` (H, r, dv); with ``rope_interleave`` each rope block's
        rows de-interleaved ([r0, i0, r1, i1, ...] -> [r..., i...]) so the
        half-rotation rope applies, as HF's interleaved rope permutes its
        activations; the dense-first group, then the MoE group with the
        router's correction bias and the shared experts (fused when
        ``fused_shared_experts``)."""
        cfg = self.config
        dtype = dtype or self.dtype
        nd, nm = self._group_sizes()
        Hq = cfg.num_attention_heads
        d_nope, d_rope, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        dq = d_nope + d_rope
        r_kv = cfg.kv_lora_rank
        r_q = getattr(cfg, "q_lora_rank", None)

        def get(name):
            return hf_array(sd, name)

        def lt(name):  # (out, in) -> (in, out)
            return get(name).T

        perm = None
        if getattr(cfg, "rope_interleave", False):
            half = d_rope // 2
            perm = np.concatenate([np.arange(half) * 2, np.arange(half) * 2 + 1])

        def fix_q_rope(w):  # (in, Hq * dq)
            if perm is None:
                return w
            w = w.reshape(w.shape[0], Hq, dq).copy()
            w[..., d_nope:] = w[..., d_nope:][..., perm]
            return w.reshape(w.shape[0], -1)

        def fix_kv_rope(w):  # (in, r_kv + d_rope)
            if perm is None:
                return w
            w = w.copy()
            w[..., r_kv:] = w[..., r_kv:][..., perm]
            return w

        def attn(p):
            p += "self_attn."
            out = {
                "kv_a_proj": {"weight": fix_kv_rope(lt(p + "kv_a_proj_with_mqa.weight"))},
                "kv_a_layernorm": {"weight": get(p + "kv_a_layernorm.weight")},
            }
            if r_q:
                out["q_a_proj"] = {"weight": lt(p + "q_a_proj.weight")}
                out["q_a_layernorm"] = {"weight": get(p + "q_a_layernorm.weight")}
                out["q_b_proj"] = {"weight": fix_q_rope(lt(p + "q_b_proj.weight"))}
            else:
                out["q_proj"] = {"weight": fix_q_rope(lt(p + "q_proj.weight"))}
            wkv = get(p + "kv_b_proj.weight").reshape(Hq, d_nope + dv, r_kv)
            out["k_absorb"] = {"weight": wkv[:, :d_nope, :]}
            out["v_absorb"] = {"weight": np.swapaxes(wkv[:, d_nope:, :], 1, 2)}
            out["o_proj"] = {"weight": lt(p + "o_proj.weight")}
            return out

        def mlp_dense(p):
            return {n: {"weight": lt(p + f"mlp.{n}.weight")} for n in ("gate_proj", "up_proj", "down_proj")}

        def mlp_moe(p):
            p += "mlp."
            out = {
                "router": {
                    "weight": lt(p + "gate.weight"),
                    "e_score_correction_bias": get(p + "gate.e_score_correction_bias"),
                },
                "experts": {
                    n: {"weight": np.stack([lt(p + f"experts.{e}.{n}.weight") for e in range(self.num_experts)])}
                    for n in ("gate_proj", "up_proj", "down_proj")
                },
            }
            if getattr(cfg, "n_shared_experts", 0):
                out["shared_experts"] = {
                    n: {"weight": lt(p + f"shared_experts.{n}.weight")} for n in ("gate_proj", "up_proj", "down_proj")
                }
            return out

        def stack_group(ids, mlp):
            per = [
                {
                    "input_layernorm": {"weight": get(f"model.layers.{i}.input_layernorm.weight")},
                    "post_attention_layernorm": {"weight": get(f"model.layers.{i}.post_attention_layernorm.weight")},
                    "self_attn": attn(f"model.layers.{i}."),
                    "mlp": mlp(f"model.layers.{i}."),
                }
                for i in ids
            ]

            def stack(*xs):
                if isinstance(xs[0], dict):
                    return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
                return _to_torch(np.stack(xs), dtype, self.device)

            group = stack(*per)
            shared = group["mlp"].get("shared_experts")
            if shared is not None and getattr(cfg.torch_config, "fused_shared_experts", False):
                group["mlp"]["shared_experts"] = fuse_shared_expert_params(shared)
            return group

        embed = get("model.embed_tokens.weight")
        vpad = self.padded_vocab - embed.shape[0]
        lm = lt("lm_head.weight") if "lm_head.weight" in sd else embed.T
        if vpad:
            embed = np.pad(embed, ((0, vpad), (0, 0)))
            lm = np.pad(lm, ((0, 0), (0, vpad)))
        groups = []
        if nd:
            groups.append(stack_group(range(nd), mlp_dense))
        if nm:
            groups.append(stack_group(range(nd, nd + nm), mlp_moe))
        return {
            "embed_tokens": {"weight": _to_torch(embed, dtype, self.device)},
            "rope": {"inv_freq": compute_inv_freq(cfg).to(self.device)},
            "layers": groups,
            "norm": {"weight": _to_torch(get("model.norm.weight"), dtype, self.device)},
            "lm_head": {"weight": _to_torch(lm, dtype, self.device)},
        }
