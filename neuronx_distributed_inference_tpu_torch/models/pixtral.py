"""Pixtral vision encoder, the vision tower of Pixtral / llava (counterpart
of the reference's ``models/pixtral.py``).

HF ``PixtralVisionModel``: patch conv -> RMS ``ln_pre`` -> N transformer
layers (RMS attention_norm, attention with a 2-D rope, RMS ffn_norm,
SwiGLU) -> patch features. Attention is full (non-causal) within an image,
and images ride the batch axis (one size for all), as in the reference. The
attention is plain PyTorch (matmul and softmax), as the reference computes
it: no Pallas kernel sits on this path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from neuronx_distributed_inference_tpu_torch.modules.norm import rms_norm


#: mistral-community/pixtral-12b's published config: the text is
#: Mistral-Nemo (q 32 x 128 = 4096 wide beside a 5120 hidden, so head_dim
#: is explicit), the tower 24 layers of 1024 with 16 heads of 64
PIXTRAL_12B = dict(
    text_config=dict(
        model_type="mistral", hidden_size=5120, head_dim=128, intermediate_size=14336, num_attention_heads=32,
        num_hidden_layers=40, num_key_value_heads=8, rms_norm_eps=1e-5, rope_theta=1e9, sliding_window=None,
        vocab_size=131072, max_position_embeddings=1024000, hidden_act="silu", tie_word_embeddings=False,
    ),
    vision_config=dict(
        model_type="pixtral", hidden_size=1024, head_dim=64, image_size=1024, intermediate_size=4096,
        num_attention_heads=16, num_hidden_layers=24, patch_size=16, rope_theta=10000.0,
    ),
    image_token_index=10,
    projector_hidden_act="gelu",
)


@dataclass(frozen=True)
class PixtralVisionSpec:
    hidden_size: int
    num_layers: int
    num_heads: int
    head_dim: int
    patch_size: int
    image_size: int
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5


def pixtral_rope_table(spec: PixtralVisionSpec) -> np.ndarray:
    """(max_side^2, head_dim) fp32 2-D rope angles: even frequency slots
    carry the row coordinate, odd slots the column (HF
    PixtralRotaryEmbedding)."""
    dim = spec.head_dim
    side = spec.image_size // spec.patch_size
    freqs = 1.0 / (spec.rope_theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    h = np.arange(side)
    w = np.arange(side)
    freqs_h = np.outer(h, freqs[0::2])
    freqs_w = np.outer(w, freqs[1::2])
    table = np.concatenate(
        [np.repeat(freqs_h[:, None, :], side, axis=1), np.repeat(freqs_w[None, :, :], side, axis=0)], axis=-1
    ).reshape(side * side, dim // 2)
    return np.concatenate([table, table], axis=-1).astype(np.float32)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    d2 = x.shape[-1] // 2
    return torch.cat([-x[..., d2:], x[..., :d2]], dim=-1)


def pixtral_vision_encoder(params: Dict, pixel_values: torch.Tensor, spec: PixtralVisionSpec) -> torch.Tensor:
    """(N, C, H, W), one image a batch row -> (N, patches, hidden) patch
    features. An image whose patch grid exceeds the rope table raises.

    The tower computes in the promotion of the pixels' dtype and the
    weights' (the reference's numpy promotion): fp32 pixels run a bf16
    tower in fp32, its weights cast at use."""
    N, C, H, W = pixel_values.shape
    ps = spec.patch_size
    h, w = H // ps, W // ps
    side_max = spec.image_size // ps
    if h > side_max or w > side_max:
        raise ValueError(
            f"image grid {h}x{w} patches exceeds the rope table "
            f"({side_max}x{side_max} from vision_config.image_size="
            f"{spec.image_size}); resize the image or raise image_size"
        )
    # the patch "conv" as patch extraction and one matmul (a stride-ps conv)
    kernel = params["patch_conv"]["weight"]  # (hidden, C, ps, ps)
    cd = torch.promote_types(pixel_values.dtype, kernel.dtype)
    x = pixel_values.to(cd).reshape(N, C, h, ps, w, ps)
    x = x.permute(0, 2, 4, 1, 3, 5).reshape(N, h * w, C * ps * ps)
    x = x @ kernel.reshape(spec.hidden_size, -1).T.to(cd)
    x = rms_norm(x, params["ln_pre"]["weight"], spec.rms_eps)

    # the 2-D rope angles of this grid (row-major patch order)
    side = spec.image_size // spec.patch_size
    rows = torch.arange(h, device=x.device)[:, None] * side
    pos = (rows + torch.arange(w, device=x.device)[None, :]).reshape(-1)
    angles = params["rope"]["table"][pos].float()  # (P, head_dim)
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    P = h * w
    nh, d = spec.num_heads, spec.head_dim

    def rope(t):
        # rotation in fp32, then cast (the reference's)
        tf = t.float()
        return (tf * cos + _rotate_half(tf) * sin).to(t.dtype)

    layers = params["layers"]
    n_layers = layers["attention_norm"]["weight"].shape[0]
    for i in range(n_layers):
        lp = layer_views(layers, i)
        a = lp["attention"]
        hn = rms_norm(x, lp["attention_norm"]["weight"], spec.rms_eps)
        q = rope(_lin(a["q_proj"], hn).reshape(N, P, nh, d))
        k = rope(_lin(a["k_proj"], hn).reshape(N, P, nh, d))
        v = _lin(a["v_proj"], hn).reshape(N, P, nh, d)
        scores = torch.einsum("nphd,nqhd->nhpq", q.float(), k.float())
        probs = torch.softmax(scores * d**-0.5, dim=-1).to(v.dtype)
        out = torch.einsum("nhpq,nqhd->nphd", probs, v)
        x = x + _lin(a["o_proj"], out.reshape(N, P, nh * d))
        f = lp["feed_forward"]
        hn = rms_norm(x, lp["ffn_norm"]["weight"], spec.rms_eps)
        x = x + _lin(f["down_proj"], torch.nn.functional.silu(_lin(f["gate_proj"], hn)) * _lin(f["up_proj"], hn))
    return x


def _lin(entry: Dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ W`` in ``x``'s dtype."""
    return x @ entry["weight"].to(x.dtype)


def layer_views(stacked: Dict, i: int) -> Dict:
    """Layer ``i``'s views of stacked (L, ...) params."""
    if isinstance(stacked, dict):
        return {k: layer_views(v, i) for k, v in stacked.items()}
    return stacked[i]


def pixtral_vision_spec(vision_config) -> PixtralVisionSpec:
    g = vision_config.get if isinstance(vision_config, dict) else lambda k, d=None: getattr(vision_config, k, d)
    hidden = g("hidden_size", 1024)
    heads = g("num_attention_heads", 16)
    return PixtralVisionSpec(
        hidden_size=hidden,
        num_layers=g("num_hidden_layers", 24),
        num_heads=heads,
        head_dim=g("head_dim", None) or hidden // heads,
        patch_size=g("patch_size", 16),
        image_size=g("image_size", 1024),
        rope_theta=g("rope_theta", 10000.0),
        rms_eps=1e-5,
    )


def tower_tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
    """numpy or torch -> ``dtype`` on ``device`` (the towers' converters)."""
    t = x.detach() if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))
    return t.to(device=device, dtype=dtype)


def stack_layers(layers, dtype: torch.dtype, device) -> Dict:
    """A list of per-layer numpy trees -> one tree of stacked (L, ...)
    tensors."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: stack_layers([lp[k] for lp in layers], dtype, device) for k in first}
    return tower_tensor(np.stack([np.asarray(a, np.float32) for a in layers]), dtype, device)


def random_vision_params(spec: PixtralVisionSpec, dtype, device, intermediate=None, seed=11) -> Dict:
    """Seeded random tower weights (std 0.05, norms 1) made on ``device``.
    ``intermediate`` None gives the MLP 2 x hidden wide, as the reference's
    random tower has it (ROADMAP C, Reference-side state)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    L, H = spec.num_layers, spec.hidden_size
    I = intermediate or 2 * H

    def w(*shape):
        return (0.05 * torch.randn(shape, generator=gen, device=device)).to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    return {
        "patch_conv": {"weight": w(H, 3, spec.patch_size, spec.patch_size)},
        "ln_pre": {"weight": ones(H)},
        "layers": {
            "attention_norm": {"weight": ones(L, H)},
            "ffn_norm": {"weight": ones(L, H)},
            "attention": {n: {"weight": w(L, H, H)} for n in ("q_proj", "k_proj", "v_proj", "o_proj")},
            "feed_forward": {
                "gate_proj": {"weight": w(L, H, I)}, "up_proj": {"weight": w(L, H, I)}, "down_proj": {"weight": w(L, I, H)},
            },
        },
        "rope": {"table": tower_tensor(pixtral_rope_table(spec), torch.float32, device)},
    }


def random_projector(H_v: int, H_t: int, dtype, device, seed=7) -> Dict:
    """Seeded random llava projector (std 0.05, zero biases) on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def w(*shape):
        return (0.05 * torch.randn(shape, generator=gen, device=device)).to(dtype)

    zeros = torch.zeros((H_t,), dtype=dtype, device=device)
    return {"linear_1": {"weight": w(H_v, H_t), "bias": zeros}, "linear_2": {"weight": w(H_t, H_t), "bias": zeros.clone()}}


def convert_pixtral_vision_state_dict(sd: Dict, spec: PixtralVisionSpec, prefix: str, dtype, device="cpu") -> Dict:
    """HF PixtralVisionModel weights -> the param tree (layers stacked,
    projections (in, out)); ``dtype`` None keeps fp32. The rope table stays
    fp32."""
    dtype = dtype or torch.float32

    def get(name):
        v = sd[prefix + name]
        return v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float32)

    def lt(name):
        return get(name).T

    layers = []
    for i in range(spec.num_layers):
        p = f"transformer.layers.{i}."
        layers.append({
            "attention_norm": {"weight": get(p + "attention_norm.weight")},
            "ffn_norm": {"weight": get(p + "ffn_norm.weight")},
            "attention": {n: {"weight": lt(p + f"attention.{n}.weight")} for n in ("q_proj", "k_proj", "v_proj", "o_proj")},
            "feed_forward": {
                n: {"weight": lt(p + f"feed_forward.{n}.weight")} for n in ("gate_proj", "up_proj", "down_proj")
            },
        })
    return {
        "patch_conv": {"weight": tower_tensor(get("patch_conv.weight"), dtype, device)},
        "ln_pre": {"weight": tower_tensor(get("ln_pre.weight"), dtype, device)},
        "layers": stack_layers(layers, dtype, device),
        "rope": {"table": tower_tensor(pixtral_rope_table(spec), torch.float32, device)},
    }
