"""FLUX's text encoders: CLIP (the pooled prompt vector) and T5 (the
sequence features) (counterpart of the reference's ``models/flux_text.py``).

Each is a plain encode function over a params tree and a converter from
the HF checkpoint, registered with ``runtime/encoder.register_encoder`` by
``runtime/flux.py``. Attention is plain PyTorch (matmul and softmax with
fp32 scores), as the reference computes it in einsums: no Pallas kernel
sits on this path. Parity oracles: ``transformers``' ``CLIPTextModel`` and
``T5EncoderModel``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from neuronx_distributed_inference_tpu_torch.models.base import unstack_layers
from neuronx_distributed_inference_tpu_torch.models.pixtral import stack_layers, tower_tensor
from neuronx_distributed_inference_tpu_torch.modules.norm import layer_norm, rms_norm

#: openai/clip-vit-large-patch14's text tower, FLUX.1's CLIP (HF names)
CLIP_VIT_L14_TEXT = dict(hidden_size=768, num_heads=12, num_layers=12, intermediate_size=3072, vocab_size=49408,
                         max_positions=77, eos_token_id=2)
#: google/t5-v1_1-xxl's encoder, FLUX.1's T5
T5_V1_1_XXL = dict(d_model=4096, num_heads=64, d_kv=64, num_layers=24, d_ff=10240, vocab_size=32128)


def _hf_np(sd: Dict, name: str) -> np.ndarray:
    x = sd[name]
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _tree(tree, dtype, device):
    if isinstance(tree, dict):
        return {k: _tree(v, dtype, device) for k, v in tree.items()}
    return tower_tensor(tree, dtype, device)


def _scores(q, k):
    """(B, L, H, D) q, (B, M, H, D) k -> (B, H, L, M) fp32 products."""
    return torch.matmul(q.transpose(1, 2).float(), k.permute(0, 2, 3, 1).float())


def _attend(probs, v):
    """(B, H, L, M) probabilities (cast to v's dtype), (B, M, H, D) v ->
    (B, L, H * D)."""
    B, M, H, D = v.shape
    out = torch.matmul(probs.to(v.dtype), v.transpose(1, 2))
    return out.transpose(1, 2).reshape(B, -1, H * D)


# ---------------------------------------------------------------------------
# CLIP text encoder
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ClipTextSpec:
    hidden_size: int
    num_heads: int
    num_layers: int
    intermediate_size: int
    vocab_size: int
    max_positions: int
    eos_token_id: int = 2
    act: str = "quick_gelu"  # openai/clip-vit-large-patch14 uses quick_gelu
    eps: float = 1e-5


def _clip_act(name, x):
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x)


def clip_text_encode(params: Dict, input_ids: torch.Tensor, *, spec: ClipTextSpec):
    """-> (last_hidden (B, L, H), pooled (B, H)), causal attention.

    The pooled row: with the LEGACY ``eos_token_id == 2`` (FLUX's CLIP,
    whose tokenizer emits 49407, so id 2 never appears) at
    ``argmax(input_ids)``, the highest id being the end token; else at the
    first true EOS (HF ``CLIPTextTransformer``)."""
    B, L = input_ids.shape
    H, nh = spec.hidden_size, spec.num_heads
    hd = H // nh
    ids = input_ids.long()
    x = params["token_embedding"]["weight"][ids] + params["position_embedding"]["weight"][None, :L]
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))[None, None]

    def lin(p, h):
        return h @ p["weight"] + p["bias"]

    for lp in unstack_layers(params["layers"]):
        h = layer_norm(x, lp["layer_norm1"]["weight"], lp["layer_norm1"]["bias"], spec.eps)
        q = lin(lp["q_proj"], h).reshape(B, L, nh, hd)
        k = lin(lp["k_proj"], h).reshape(B, L, nh, hd)
        v = lin(lp["v_proj"], h).reshape(B, L, nh, hd)
        s = torch.where(causal, _scores(q, k) * hd**-0.5, -torch.inf)
        x = x + lin(lp["out_proj"], _attend(torch.softmax(s, dim=-1), v))
        h = layer_norm(x, lp["layer_norm2"]["weight"], lp["layer_norm2"]["bias"], spec.eps)
        x = x + lin(lp["fc2"], _clip_act(spec.act, lin(lp["fc1"], h)))
    x = layer_norm(x, params["final_layer_norm"]["weight"], params["final_layer_norm"]["bias"], spec.eps)
    if spec.eos_token_id == 2:
        eos_pos = torch.argmax(ids, dim=1)
    else:
        eos_pos = torch.argmax((ids == spec.eos_token_id).to(torch.int32), dim=1)
    pooled = x[torch.arange(B, device=x.device), eos_pos]
    return x, pooled


def convert_clip_text_state_dict(sd: Dict, spec: ClipTextSpec, dtype=torch.float32, device="cpu") -> Dict:
    """HF ``CLIPTextModel`` weights -> the params tree on ``device``."""
    pre = "text_model."

    def layer(i):
        p = f"{pre}encoder.layers.{i}."
        out = {}
        for name, hf in (
            ("q_proj", "self_attn.q_proj"), ("k_proj", "self_attn.k_proj"),
            ("v_proj", "self_attn.v_proj"), ("out_proj", "self_attn.out_proj"),
            ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2"),
        ):
            out[name] = {"weight": _hf_np(sd, p + hf + ".weight").T, "bias": _hf_np(sd, p + hf + ".bias")}
        for name in ("layer_norm1", "layer_norm2"):
            out[name] = {"weight": _hf_np(sd, p + name + ".weight"), "bias": _hf_np(sd, p + name + ".bias")}
        return out

    return {
        **_tree({
            "token_embedding": {"weight": _hf_np(sd, pre + "embeddings.token_embedding.weight")},
            "position_embedding": {"weight": _hf_np(sd, pre + "embeddings.position_embedding.weight")},
            "final_layer_norm": {"weight": _hf_np(sd, pre + "final_layer_norm.weight"),
                                 "bias": _hf_np(sd, pre + "final_layer_norm.bias")},
        }, dtype, device),
        "layers": stack_layers([layer(i) for i in range(spec.num_layers)], dtype, device),
    }


# ---------------------------------------------------------------------------
# T5 encoder
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class T5EncoderSpec:
    d_model: int
    num_heads: int
    d_kv: int  # per-head dim (T5 does NOT tie d_kv to d_model / heads)
    num_layers: int
    d_ff: int
    vocab_size: int
    rel_buckets: int = 32
    rel_max_distance: int = 128
    eps: float = 1e-6
    gated_act: bool = True  # v1.1 / xxl use gated-gelu


def _t5_rel_bucket(rel: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    """Bidirectional relative-position bucketing (HF T5Attention
    ``_relative_position_bucket``, bidirectional=True), the log in fp32."""
    nb = num_buckets // 2
    out = torch.where(rel > 0, nb, 0)
    n = torch.abs(rel)
    max_exact = nb // 2
    large = max_exact + (
        torch.log(n.float() / max_exact + 1e-20) / math.log(max_distance / max_exact) * (nb - max_exact)
    ).to(torch.int32)
    large = torch.clamp(large, max=nb - 1)
    return out + torch.where(n < max_exact, n, large)


def t5_encode(params: Dict, input_ids: torch.Tensor, attention_mask: torch.Tensor, *, spec: T5EncoderSpec):
    """-> last_hidden (B, L, d_model). HF ``T5EncoderModel``: layer 0's
    relative attention bias is shared by every layer, attention is
    unscaled, padded keys get -inf; pre-RMSNorm blocks with a gated-GELU
    (tanh) FFN."""
    B, L = input_ids.shape
    nh, dk = spec.num_heads, spec.d_kv
    x = params["embed_tokens"]["weight"][input_ids.long()]
    pos = torch.arange(L, device=x.device)
    bucket = _t5_rel_bucket(pos[None, :] - pos[:, None], spec.rel_buckets, spec.rel_max_distance)
    bias = params["rel_bias"]["weight"][bucket].permute(2, 0, 1)[None].float()  # (1, nh, L, L)
    key_ok = attention_mask.bool()[:, None, None, :]
    for lp in unstack_layers(params["layers"]):
        h = rms_norm(x, lp["ln1"]["weight"], spec.eps)
        q = (h @ lp["q"]["weight"]).reshape(B, L, nh, dk)
        k = (h @ lp["k"]["weight"]).reshape(B, L, nh, dk)
        v = (h @ lp["v"]["weight"]).reshape(B, L, nh, dk)
        s = torch.where(key_ok, _scores(q, k) + bias, -torch.inf)  # T5: no 1 / sqrt(d)
        x = x + _attend(torch.softmax(s, dim=-1), v) @ lp["o"]["weight"]
        h = rms_norm(x, lp["ln2"]["weight"], spec.eps)
        if spec.gated_act:
            ff = F.gelu(h @ lp["wi_0"]["weight"], approximate="tanh") * (h @ lp["wi_1"]["weight"])
        else:
            ff = torch.relu(h @ lp["wi_0"]["weight"])
        x = x + ff @ lp["wo"]["weight"]
    return rms_norm(x, params["final_norm"]["weight"], spec.eps)


def convert_t5_state_dict(sd: Dict, spec: T5EncoderSpec, dtype=torch.float32, device="cpu") -> Dict:
    """HF ``T5EncoderModel`` weights -> the params tree on ``device``."""

    def layer(i):
        p = f"encoder.block.{i}."
        out = {
            "q": {"weight": _hf_np(sd, p + "layer.0.SelfAttention.q.weight").T},
            "k": {"weight": _hf_np(sd, p + "layer.0.SelfAttention.k.weight").T},
            "v": {"weight": _hf_np(sd, p + "layer.0.SelfAttention.v.weight").T},
            "o": {"weight": _hf_np(sd, p + "layer.0.SelfAttention.o.weight").T},
            "ln1": {"weight": _hf_np(sd, p + "layer.0.layer_norm.weight")},
            "ln2": {"weight": _hf_np(sd, p + "layer.1.layer_norm.weight")},
            "wo": {"weight": _hf_np(sd, p + "layer.1.DenseReluDense.wo.weight").T},
        }
        if spec.gated_act:
            out["wi_0"] = {"weight": _hf_np(sd, p + "layer.1.DenseReluDense.wi_0.weight").T}
            out["wi_1"] = {"weight": _hf_np(sd, p + "layer.1.DenseReluDense.wi_1.weight").T}
        else:
            out["wi_0"] = {"weight": _hf_np(sd, p + "layer.1.DenseReluDense.wi.weight").T}
        return out

    return {
        **_tree({
            "embed_tokens": {"weight": _hf_np(sd, "shared.weight")},
            "rel_bias": {"weight": _hf_np(sd, "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight")},
            "final_norm": {"weight": _hf_np(sd, "encoder.final_layer_norm.weight")},
        }, dtype, device),
        "layers": stack_layers([layer(i) for i in range(spec.num_layers)], dtype, device),
    }
