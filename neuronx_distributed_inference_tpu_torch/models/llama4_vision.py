"""Llama4 vision tower: unfold patch embedding, 2-D rope ViT, pixel-shuffle
adapter (counterpart of the reference's ``models/llama4_vision.py``).

HF ``Llama4VisionModel``: patch unfold + linear (no bias) -> class token
appended LAST -> learned position embedding -> pre-LayerNorm -> encoder
layers (biased q / k / v / o and LayerNorms, a 2-D rope from the patch
grid, non-causal attention, exact GELU) -> post-LayerNorm -> class token
stripped -> pixel shuffle + a two-layer exact-GELU MLP
(``Llama4VisionPixelShuffleMLP``). The features splice into the text
embeddings at the image placeholders through ``runtime/image_to_text.py``.
The attention is plain PyTorch (matmul and softmax), as the reference
computes it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from neuronx_distributed_inference_tpu_torch.models.pixtral import layer_views, stack_layers, tower_tensor
from neuronx_distributed_inference_tpu_torch.modules.norm import layer_norm


#: meta-llama/Llama-4-Scout-17B-16E's published vision_config: 34 layers of
#: 1408, 16 heads, a 336-pixel image in patches of 14 (24 x 24), pixel
#: shuffle 0.5 -> 144 tokens an image; its image token
LLAMA4_SCOUT_VISION = dict(
    model_type="llama4_vision_model", hidden_size=1408, intermediate_size=5632, num_hidden_layers=34,
    num_attention_heads=16, image_size=336, patch_size=14, pixel_shuffle_ratio=0.5, projector_input_dim=4096,
    projector_output_dim=4096, vision_output_dim=4096, rope_theta=10000.0, norm_eps=1e-5,
)
LLAMA4_SCOUT_IMAGE_TOKEN = 200092


@dataclass(frozen=True)
class Llama4VisionSpec:
    hidden_size: int
    num_heads: int
    intermediate_size: int
    num_layers: int
    image_size: int
    patch_size: int
    rope_theta: float
    pixel_shuffle_ratio: float
    projector_input_dim: int
    projector_output_dim: int
    norm_eps: float = 1e-5

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid**2 + 1


def llama4_vision_spec_from_config(vision_cfg) -> Llama4VisionSpec:
    """The spec of an HF vision config (dict or object): the one mapping
    the image-to-text app and the encoder registry share."""
    vg = vision_cfg.get if isinstance(vision_cfg, dict) else lambda k, d=None: getattr(vision_cfg, k, d)
    return Llama4VisionSpec(
        hidden_size=vg("hidden_size"),
        num_heads=vg("num_attention_heads"),
        intermediate_size=vg("intermediate_size"),
        num_layers=vg("num_hidden_layers"),
        image_size=vg("image_size"),
        patch_size=vg("patch_size"),
        rope_theta=vg("rope_theta", 10000.0),
        pixel_shuffle_ratio=vg("pixel_shuffle_ratio", 0.5),
        projector_input_dim=vg("projector_input_dim"),
        projector_output_dim=vg("projector_output_dim"),
        norm_eps=vg("norm_eps", 1e-5),
    )


def llama4_vision_rope(spec: Llama4VisionSpec) -> Tuple[np.ndarray, np.ndarray]:
    """fp32 (cos, sin) tables of shape (patches + 1, 1, D/2) for the 2-D
    patch-grid rope (HF Llama4VisionRotaryEmbedding; the class token's row,
    last, does not rotate)."""
    idx = spec.grid
    img_idx = np.arange(idx**2, dtype=np.int32).reshape(idx**2, 1)
    img_idx = np.concatenate([img_idx, img_idx[:1]], axis=0)
    img_idx[-1, -1] = -2  # the class token
    fx = img_idx % idx
    fy = img_idx // idx
    fd = spec.hidden_size // spec.num_heads // 2
    rope_freq = 1.0 / (spec.rope_theta ** (np.arange(0, fd, 2)[: fd // 2].astype(np.float32) / fd))
    freqs_x = np.repeat((fx + 1)[..., None] * rope_freq[None, None, :], 2, axis=-1)
    freqs_y = np.repeat((fy + 1)[..., None] * rope_freq[None, None, :], 2, axis=-1)
    freqs = np.concatenate([freqs_x, freqs_y], axis=-1)[..., ::2]
    freqs = np.where(img_idx.reshape(-1, 1, 1) < 0, 0.0, freqs)
    return np.cos(freqs).astype(np.float32), np.sin(freqs).astype(np.float32)


def _rope_2d(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Complex-pair rotation of (B, S, H, D) by (S, 1, D/2) fp32 tables; the
    result is fp32 (the reference's promotion)."""
    a = x[..., 0::2].float()
    b = x[..., 1::2].float()
    c, s = cos[None], sin[None]
    return torch.stack([a * c - b * s, a * s + b * c], dim=-1).reshape(x.shape)


def _ln(x: torch.Tensor, p: Dict, eps: float) -> torch.Tensor:
    return layer_norm(x, p["weight"], p["bias"], eps)


def _pixel_shuffle(x: torch.Tensor, ratio: float) -> torch.Tensor:
    """HF pixel_shuffle: two transposes around the channel merges."""
    B, NP, C = x.shape
    side = int(np.sqrt(NP))
    x = x.reshape(B, side, side, C)
    x = x.reshape(B, side, int(side * ratio), int(C / ratio))
    x = x.permute(0, 2, 1, 3)
    x = x.reshape(B, int(side * ratio), int(side * ratio), int(C / ratio**2))
    x = x.permute(0, 2, 1, 3)
    return x.reshape(B, -1, x.shape[-1])


def _affine(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["weight"] + p["bias"]


def llama4_vision_encoder(params: Dict, pixel_values: torch.Tensor, spec: Llama4VisionSpec) -> torch.Tensor:
    """(N, C, H, W) -> (N, shuffled patches, projector_output_dim)."""
    N = pixel_values.shape[0]
    C = pixel_values.shape[1]
    P, g, H = spec.patch_size, spec.grid, spec.hidden_size
    w = params["patch_embedding"]["weight"]  # (C * P * P, H)
    x = pixel_values.to(w.dtype).reshape(N, C, g, P, g, P).permute(0, 2, 4, 1, 3, 5).reshape(N, g * g, C * P * P)
    hidden = x @ w
    # the class token appended at the END (Mllama puts it first)
    cls = params["class_embedding"].to(hidden.dtype).expand(N, 1, H)
    hidden = torch.cat([hidden, cls], dim=1) + params["positional_embedding_vlm"]
    hidden = _ln(hidden, params["layernorm_pre"], spec.norm_eps)

    cos, sin = params["rope"]["cos"], params["rope"]["sin"]
    nh = spec.num_heads
    d = H // nh
    layers = params["layers"]
    for i in range(layers["input_layernorm"]["weight"].shape[0]):
        p = layer_views(layers, i)
        sa = p["self_attn"]
        xn = _ln(hidden, p["input_layernorm"], spec.norm_eps)
        B, S, _ = xn.shape
        q = _rope_2d(_affine(sa["q_proj"], xn).reshape(B, S, nh, d), cos, sin)
        k = _rope_2d(_affine(sa["k_proj"], xn).reshape(B, S, nh, d), cos, sin)
        v = _affine(sa["v_proj"], xn).reshape(B, S, nh, d)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * d**-0.5
        a = torch.softmax(s, dim=-1).to(v.dtype)
        attn = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, S, H)
        hidden = hidden + _affine(sa["o_proj"], attn)
        xn = _ln(hidden, p["post_attention_layernorm"], spec.norm_eps)
        xn = _affine(p["mlp"]["fc2"], F.gelu(_affine(p["mlp"]["fc1"], xn)))
        hidden = hidden + xn
    hidden = _ln(hidden, params["layernorm_post"], spec.norm_eps)[:, :-1, :]  # the class token stripped

    # the vision adapter: pixel shuffle and the exact-GELU MLP
    hidden = _pixel_shuffle(hidden, spec.pixel_shuffle_ratio)
    va = params["vision_adapter"]
    hidden = F.gelu(hidden @ va["fc1"]["weight"])
    return F.gelu(hidden @ va["fc2"]["weight"])


def convert_llama4_vision_state_dict(sd: Dict, spec: Llama4VisionSpec, prefix: str, dtype, device="cpu") -> Dict:
    """HF Llama4VisionModel weights -> the param tree above (projections
    (in, out), layers stacked); the rope tables stay fp32."""
    dtype = dtype or torch.float32

    def get(name):
        if prefix + name not in sd:
            raise KeyError(f"missing HF weight {prefix + name}")
        v = sd[prefix + name]
        return v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float32)

    def lt(name):
        return get(name).T

    def affine(p):
        return {"weight": lt(p + ".weight"), "bias": get(p + ".bias")}

    def norm(p):
        return {"weight": get(p + ".weight"), "bias": get(p + ".bias")}

    def layer(i):
        p = f"model.layers.{i}."
        return {
            "input_layernorm": norm(p + "input_layernorm"),
            "post_attention_layernorm": norm(p + "post_attention_layernorm"),
            "self_attn": {n: affine(p + f"self_attn.{n}") for n in ("q_proj", "k_proj", "v_proj", "o_proj")},
            "mlp": {"fc1": affine(p + "mlp.fc1"), "fc2": affine(p + "mlp.fc2")},
        }

    def t(a):
        return tower_tensor(a, dtype, device)

    cos, sin = llama4_vision_rope(spec)
    return {
        "patch_embedding": {"weight": t(lt("patch_embedding.linear.weight"))},
        "class_embedding": t(get("class_embedding")),
        "positional_embedding_vlm": t(get("positional_embedding_vlm")),
        "layernorm_pre": {k: t(v) for k, v in norm("layernorm_pre").items()},
        "layernorm_post": {k: t(v) for k, v in norm("layernorm_post").items()},
        "layers": stack_layers([layer(i) for i in range(spec.num_layers)], dtype, device),
        "rope": {"cos": tower_tensor(cos, torch.float32, device), "sin": tower_tensor(sin, torch.float32, device)},
        "vision_adapter": {
            "fc1": {"weight": t(lt("vision_adapter.mlp.fc1.weight"))},
            "fc2": {"weight": t(lt("vision_adapter.mlp.fc2.weight"))},
        },
    }
