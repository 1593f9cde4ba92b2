"""Mllama (Llama-3.2-Vision): the tiled ViT vision tower and the text
decoder with gated cross-attention layers over a separate vision-KV stream
(counterpart of the reference's ``models/mllama.py``).

- The vision tower: patch conv -> gated pre-tile, position and tile
  embeddings -> the local encoder, its ``intermediate_layers_indices`` taps
  collected inside the loop -> the gated global encoder -> the final
  features and the taps on one feature axis (``vision_output_dim``). The
  taps are stacked on a NEW LAST axis before the reshape, so their features
  come interleaved, as in HF.
- The text decoder: runs of llama self-attention layers, each through the
  port's ``decoder_layer`` (so B2a at the prefill and B1 at decode),
  between single cross-attention layers at the config's
  ``cross_attention_layers``. Each cross layer's K / V come from the vision
  states once, at the prefill, into their own cache stream
  (``MllamaCache.cross_k`` / ``cross_v``); decode steps only read it.
- Cross-attention masking is HF's: per-token tile masks grow to vision-token
  width; a text row that sees no tile attends to everything and its MLP
  delta is zeroed by the full-text-row mask.

The towers' and the cross layers' attention is plain PyTorch (matmul and
softmax), as the reference computes it: no Pallas kernel sits there.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from neuronx_distributed_inference_tpu_torch.config import InferenceConfig
from neuronx_distributed_inference_tpu_torch.models.base import (
    PHASE_CONTEXT_ENCODING,
    ModelSpec,
    StepInputs,
    build_mask,
    decoder_layer,
    gated_mlp,
    gather_last_token,
)
from neuronx_distributed_inference_tpu_torch.models.pixtral import layer_views, stack_layers, tower_tensor
from neuronx_distributed_inference_tpu_torch.modules.attention import AttnSpec, repeat_kv
from neuronx_distributed_inference_tpu_torch.modules.kvcache import GARBAGE_LINES, slot_ids_from_seq_ids
from neuronx_distributed_inference_tpu_torch.modules.norm import layer_norm, rms_norm
from neuronx_distributed_inference_tpu_torch.modules.rope import rope_cos_sin
from neuronx_distributed_inference_tpu_torch.ops.kernel_mode import use_flash
from neuronx_distributed_inference_tpu_torch.ops.quant import linear

NEG_INF = -1e30
#: rows past the text vocabulary in HF's embedding table
LEARNABLE_EMBEDDING_SIZE = 8


#: meta-llama/Llama-3.2-11B-Vision's published config: 40 text layers with
#: cross layers at 3, 8, ..., 38 (llama3 rope scaling, factor 8); a tower of
#: 32 local and 8 global layers of 1280 over 4 tiles of 560 in patches of 14,
#: taps [3, 7, 15, 23, 30] (output 1280 x 6 = 7680)
LLAMA32_11B_VISION = dict(
    text_config=dict(
        model_type="mllama_text_model", hidden_size=4096, num_hidden_layers=40,
        cross_attention_layers=[3, 8, 13, 18, 23, 28, 33, 38], num_attention_heads=32, num_key_value_heads=8,
        intermediate_size=14336, vocab_size=128256, rope_theta=500000.0, rms_norm_eps=1e-5, hidden_act="silu",
        rope_scaling=dict(factor=8.0, high_freq_factor=4.0, low_freq_factor=1.0,
                          original_max_position_embeddings=8192, rope_type="llama3"),
        max_position_embeddings=131072, tie_word_embeddings=False,
    ),
    vision_config=dict(
        model_type="mllama_vision_model", hidden_size=1280, attention_heads=16, intermediate_size=5120,
        num_hidden_layers=32, num_global_layers=8, image_size=560, patch_size=14, max_num_tiles=4,
        intermediate_layers_indices=[3, 7, 15, 23, 30], vision_output_dim=7680, norm_eps=1e-5, num_channels=3,
        supported_aspect_ratios=[[1, 1], [1, 2], [1, 3], [1, 4], [2, 1], [2, 2], [3, 1], [4, 1]],
    ),
    image_token_index=128256,
)


class MllamaInferenceConfig(InferenceConfig):
    _REQUIRED_ATTRS = ("text_config", "vision_config")


# ---------------------------------------------------------------------------
# the vision tower
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MllamaVisionSpec:
    hidden_size: int
    num_heads: int
    intermediate_size: int
    num_layers: int
    num_global_layers: int
    image_size: int
    patch_size: int
    max_num_tiles: int
    intermediate_layers_indices: Tuple[int, ...]
    norm_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1

    @property
    def output_dim(self) -> int:
        return self.hidden_size * (1 + len(self.intermediate_layers_indices))


def mllama_vision_spec(vision_config) -> MllamaVisionSpec:
    vg = vision_config.get if isinstance(vision_config, dict) else lambda k, d=None: getattr(vision_config, k, d)
    return MllamaVisionSpec(
        hidden_size=vg("hidden_size"),
        num_heads=vg("attention_heads"),
        intermediate_size=vg("intermediate_size"),
        num_layers=vg("num_hidden_layers"),
        num_global_layers=vg("num_global_layers"),
        image_size=vg("image_size"),
        patch_size=vg("patch_size"),
        max_num_tiles=vg("max_num_tiles"),
        intermediate_layers_indices=tuple(vg("intermediate_layers_indices")),
        norm_eps=vg("norm_eps", 1e-5),
    )


def _layer_norm(x, w, b, eps):
    return layer_norm(x, w, b, eps)


def _vision_attention(p, x, mask, spec: MllamaVisionSpec):
    """Full (non-causal) attention under an additive fp32 mask (B, 1, S, S)."""
    B, S, H = x.shape
    nh, d = spec.num_heads, spec.hidden_size // spec.num_heads
    q = (x @ p["q_proj"]["weight"]).reshape(B, S, nh, d)
    k = (x @ p["k_proj"]["weight"]).reshape(B, S, nh, d)
    v = (x @ p["v_proj"]["weight"]).reshape(B, S, nh, d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d**-0.5 + mask.float()
    a = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, S, nh * d)
    return out @ p["o_proj"]["weight"]


def _vision_layer(p, x, mask, spec: MllamaVisionSpec, gated: bool):
    h = _layer_norm(x, p["input_layernorm"]["weight"], p["input_layernorm"]["bias"], spec.norm_eps)
    h = _vision_attention(p["self_attn"], h, mask, spec)
    if gated:
        h = torch.tanh(p["gate_attn"]) * h
    x = x + h
    h = _layer_norm(x, p["post_attention_layernorm"]["weight"], p["post_attention_layernorm"]["bias"], spec.norm_eps)
    h = F.gelu(h @ p["mlp"]["fc1"]["weight"] + p["mlp"]["fc1"]["bias"])
    h = h @ p["mlp"]["fc2"]["weight"] + p["mlp"]["fc2"]["bias"]
    if gated:
        h = torch.tanh(p["gate_ffn"]) * h
    return x + h


def mllama_vision_encoder(
    params: dict,
    pixel_values: torch.Tensor,  # (B, num_img, tiles, C, Hpx, Wpx)
    aspect_ratio_ids: torch.Tensor,  # (B, num_img)
    aspect_ratio_mask: torch.Tensor,  # (B, num_img, tiles)
    spec: MllamaVisionSpec,
) -> torch.Tensor:
    """HF MllamaVisionModel.forward, functional. Returns (B, num_img, tiles,
    num_patches, output_dim)."""
    B, NI, T, C, Hp, Wp = pixel_values.shape
    hs = spec.hidden_size
    w = params["patch_embedding"]["weight"]
    px = pixel_values.reshape(B * NI * T, C, Hp, Wp).to(w.dtype)
    patches = F.conv2d(px, w, stride=spec.patch_size)  # (N, hs, hp, wp)
    hidden = patches.reshape(B * NI * T, hs, -1).transpose(1, 2)  # (N, np0, hs)
    np0 = hidden.shape[1]
    ar = aspect_ratio_ids.reshape(B * NI).long()

    # the gated pre-tile position embedding
    pre = params["pre_tile_positional_embedding"]
    emb = pre["embedding"]["weight"][ar].reshape(B * NI, spec.max_num_tiles, 1, hs)
    hidden = hidden.reshape(B * NI, T, np0, hs) + torch.tanh(pre["gate"]) * emb[:, :T]

    # the class token, first
    hidden = hidden.reshape(B * NI * T, np0, hs)
    cls = params["class_embedding"].to(hidden.dtype).expand(B * NI * T, 1, hs)
    hidden = torch.cat([cls, hidden], dim=1)
    npatch = np0 + 1

    # the gated position embedding and the per-aspect tile position embedding
    gpe = params["gated_positional_embedding"]
    gate = torch.tanh(gpe["gate"])
    hidden = hidden.reshape(B * NI, T, npatch, hs) + (1 - gate) * gpe["embedding"][None, None]
    tile_pos = gpe["tile_embedding"]["weight"][ar].reshape(B * NI, spec.max_num_tiles, spec.num_patches, hs)
    hidden = hidden + gate * tile_pos[:, :T]
    hidden = _layer_norm(hidden, params["layernorm_pre"]["weight"], params["layernorm_pre"]["bias"], spec.norm_eps)

    # the patch axis padded to a multiple of 8 (as HF does)
    pad = (8 - npatch % 8) % 8
    hidden = F.pad(hidden, (0, 0, 0, pad))
    plen = npatch + pad

    # the aspect-ratio attention mask (HF _prepare_aspect_ratio_attention_mask):
    # an outer product of the dead positions, scaled by NEG_INF in fp32
    am = aspect_ratio_mask.reshape(B * NI, T).float()[:, :, None].repeat(1, 1, plen)  # 1 = live tile
    am[:, :, npatch:] = 0.0
    am = 1.0 - am.reshape(B * NI, T * plen, 1)
    mask = ((am @ am.transpose(1, 2)) * NEG_INF)[:, None]  # (N, 1, S, S)

    hidden = hidden.reshape(B * NI, T * plen, hs)

    # the local encoder, its taps collected inside the loop
    taps = spec.intermediate_layers_indices
    inter = [torch.zeros_like(hidden) for _ in taps]
    local = params["transformer"]["layers"]
    for li in range(spec.num_layers):
        hidden = _vision_layer(layer_views(local, li), hidden, mask, spec, gated=False)
        for j, tap in enumerate(taps):
            if tap == li:
                inter[j] = hidden

    hidden = _layer_norm(hidden, params["layernorm_post"]["weight"], params["layernorm_post"]["bias"], spec.norm_eps)

    # the gated post-tile embedding, then the gated global encoder
    post = params["post_tile_positional_embedding"]
    emb = post["embedding"]["weight"][ar].reshape(B * NI, spec.max_num_tiles, 1, hs)
    hidden = (hidden.reshape(B * NI, T, plen, hs) + torch.tanh(post["gate"]) * emb[:, :T]).reshape(B * NI, T * plen, hs)
    glob = params["global_transformer"]["layers"]
    for li in range(spec.num_global_layers):
        hidden = _vision_layer(layer_views(glob, li), hidden, mask, spec, gated=True)

    # unpad; [final | taps] on the feature axis, the taps on a NEW LAST axis
    # first (so their features interleave)
    hidden = hidden.reshape(B * NI, T, plen, hs)[:, :, :npatch]
    stacked = torch.stack(inter, dim=-1).reshape(B * NI, T, plen, -1)[:, :, :npatch]
    out = torch.cat([hidden, stacked], dim=-1)
    return out.reshape(B, NI, T, npatch, spec.output_dim)


# ---------------------------------------------------------------------------
# the text decoder with interleaved cross-attention
# ---------------------------------------------------------------------------


@dataclass
class MllamaCache:
    """The text self-attention KV (stacked over the SELF layers) and the
    vision cross-KV stream (stacked over the CROSS layers, written once at
    the prefill): the reference's two streams. One garbage line past the
    batch rows takes the writes of invalid seq ids."""

    k: torch.Tensor  # (L_self, B + G, S_max, Hkv, D)
    v: torch.Tensor
    cross_k: torch.Tensor  # (L_cross, B + G, Sv, Hkv, D)
    cross_v: torch.Tensor


def init_mllama_cache(n_self: int, n_cross: int, batch: int, seq_len: int, max_sv: int, n_kv: int, head_dim: int,
                      dtype, device) -> MllamaCache:
    rows = batch + GARBAGE_LINES

    def z(n, s):
        return torch.zeros((n, rows, s, n_kv, head_dim), dtype=dtype, device=device)

    return MllamaCache(k=z(n_self, seq_len), v=z(n_self, seq_len), cross_k=z(n_cross, max_sv), cross_v=z(n_cross, max_sv))


#: the cross layers' MLP activation (HF's)
_SILU = SimpleNamespace(act="silu")


def _cross_layer(
    p: dict,
    hidden: torch.Tensor,  # (B, S, H)
    cross_k: torch.Tensor,  # (B, Sv, Hkv, D)
    cross_v: torch.Tensor,
    cross_mask: torch.Tensor,  # (B, 1, S, Sv) additive fp32
    full_row: torch.Tensor,  # (B, S, 1) 1 = the row sees some tile
    aspec: AttnSpec,
    rms_eps: float,
) -> torch.Tensor:
    """HF MllamaCrossAttentionDecoderLayer: tanh-gated cross attention and
    a tanh-gated MLP zeroed on the rows that see no tile."""
    B, S, H = hidden.shape
    x = rms_norm(hidden, p["input_layernorm"]["weight"], rms_eps)
    ca = p["cross_attn"]
    q = linear(ca["q_proj"], x).reshape(B, S, aspec.num_heads, aspec.head_dim)
    q = rms_norm(q, ca["q_norm"]["weight"], rms_eps)
    n_rep = aspec.num_heads // aspec.num_kv_heads
    k = repeat_kv(cross_k, n_rep).to(q.dtype)
    v = repeat_kv(cross_v, n_rep).to(q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * aspec.softmax_scale + cross_mask.float()
    a = torch.softmax(s, dim=-1).to(v.dtype)
    attn = linear(ca["o_proj"], torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, S, -1))
    h = hidden + torch.tanh(p["cross_attn_attn_gate"]) * attn
    m = gated_mlp(p["mlp"], rms_norm(h, p["post_attention_layernorm"]["weight"], rms_eps), _SILU)
    m = full_row.to(m.dtype) * m
    return h + torch.tanh(p["cross_attn_mlp_gate"]) * m


def write_cross_kv(
    params: dict,
    cache: MllamaCache,
    cross_states: torch.Tensor,  # (B, Sv, H) projected vision tokens
    slot_ids: torch.Tensor,  # (B,) cache lines (invalid ids already on the garbage line)
    aspec: AttnSpec,
    rms_eps: float,
) -> MllamaCache:
    """Every cross layer's k (k-normed) and v of the vision states, written
    into the cross-KV stream in place (the prefill only)."""
    B, Sv, _ = cross_states.shape
    for i, p in enumerate(params["cross_layers"]):
        ca = p["cross_attn"]
        k = linear(ca["k_proj"], cross_states).reshape(B, Sv, aspec.num_kv_heads, aspec.head_dim)
        k = rms_norm(k, ca["k_norm"]["weight"], rms_eps)
        v = linear(ca["v_proj"], cross_states).reshape(B, Sv, aspec.num_kv_heads, aspec.head_dim)
        cache.cross_k[i, slot_ids] = k.to(cache.cross_k.dtype)
        cache.cross_v[i, slot_ids] = v.to(cache.cross_v.dtype)
    return cache


def mllama_text_forward(
    params: dict,
    cache: MllamaCache,
    inputs: StepInputs,
    cross_mask: torch.Tensor,  # (B, 1, S, Sv) additive
    full_row: torch.Tensor,  # (B, S, 1)
    cross_states: Optional[torch.Tensor],  # (B, Sv, H) at the prefill, None at decode
    *,
    spec: ModelSpec,
    runs: Tuple,  # (('self', count) | ('cross', local index), ...) in layer order
    phase: str,
):
    """The text decoder: runs of self-attention layers (the shared decoder
    layer, B2a / B1) between the cross-attention layers, in the fusion
    schedule's order. The cache is written in place. Returns (logits (B,
    K, V) fp32, cache)."""
    hidden = params["embed_tokens"]["weight"][inputs.input_ids]
    cos, sin = rope_cos_sin(inputs.position_ids, params["rope"]["inv_freq"], spec.attention_scaling)
    key_valid = inputs.attention_mask if phase == PHASE_CONTEXT_ENCODING else None
    flash = key_valid is not None and use_flash(spec.attn)
    mask = None if flash else build_mask(inputs, spec, phase)
    slot_ids = slot_ids_from_seq_ids(inputs.seq_ids, cache.k.shape[1] - GARBAGE_LINES)
    positions = inputs.position_ids
    if cross_states is not None:
        write_cross_kv(params, cache, cross_states, slot_ids, spec.attn, spec.rms_eps)

    k_c, v_c = cache.k, cache.v
    self_offset = 0
    self_run = 0
    for kind, n in runs:
        if kind == "self":
            for j, lp in enumerate(params["self_runs"][self_run]):
                hidden, k_c, v_c = decoder_layer(
                    lp, hidden, cos, sin, k_c, v_c, self_offset + j, mask, slot_ids, positions, spec, phase,
                    gated_mlp, key_valid=key_valid,
                )
            self_run += 1
            self_offset += n
        else:
            hidden = _cross_layer(
                params["cross_layers"][n], hidden, cache.cross_k[n][slot_ids], cache.cross_v[n][slot_ids], cross_mask,
                full_row, spec.attn, spec.rms_eps,
            )
    hidden = rms_norm(hidden, params["norm"]["weight"], spec.rms_eps)
    if phase == PHASE_CONTEXT_ENCODING:
        hidden = gather_last_token(hidden, inputs.attention_mask)
    logits = linear(params["lm_head"], hidden).float()
    return logits[..., : spec.vocab_size], cache


def convert_mllama_vision_state_dict(sd: Dict, spec: MllamaVisionSpec, prefix: str, dtype, device="cpu") -> Dict:
    """HF MllamaVisionModel weights -> the vision param tree of
    :func:`mllama_vision_encoder` (the Mllama app and the encoder registry
    share it)."""
    dtype = dtype or torch.float32

    def get(name):
        if prefix + name not in sd:
            raise KeyError(f"missing HF weight {prefix + name}")
        v = sd[prefix + name]
        return v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float32)

    def lt(name):
        return get(name).T

    def norm(p):
        return {"weight": get(p + ".weight"), "bias": get(p + ".bias")}

    def vlayer(p, gated):
        d = {
            "input_layernorm": norm(p + "input_layernorm"),
            "post_attention_layernorm": norm(p + "post_attention_layernorm"),
            "self_attn": {n: {"weight": lt(p + f"self_attn.{n}.weight")} for n in ("q_proj", "k_proj", "v_proj", "o_proj")},
            "mlp": {
                "fc1": {"weight": lt(p + "mlp.fc1.weight"), "bias": get(p + "mlp.fc1.bias")},
                "fc2": {"weight": lt(p + "mlp.fc2.weight"), "bias": get(p + "mlp.fc2.bias")},
            },
        }
        if gated:
            d["gate_attn"] = get(p + "gate_attn")
            d["gate_ffn"] = get(p + "gate_ffn")
        return d

    def t(name):
        return tower_tensor(get(name), dtype, device)

    return {
        "patch_embedding": {"weight": t("patch_embedding.weight")},
        "class_embedding": t("class_embedding"),
        "gated_positional_embedding": {
            "embedding": t("gated_positional_embedding.embedding"),
            "gate": t("gated_positional_embedding.gate"),
            "tile_embedding": {"weight": t("gated_positional_embedding.tile_embedding.weight")},
        },
        "pre_tile_positional_embedding": {
            "embedding": {"weight": t("pre_tile_positional_embedding.embedding.weight")},
            "gate": t("pre_tile_positional_embedding.gate"),
        },
        "post_tile_positional_embedding": {
            "embedding": {"weight": t("post_tile_positional_embedding.embedding.weight")},
            "gate": t("post_tile_positional_embedding.gate"),
        },
        "layernorm_pre": {"weight": t("layernorm_pre.weight"), "bias": t("layernorm_pre.bias")},
        "layernorm_post": {"weight": t("layernorm_post.weight"), "bias": t("layernorm_post.bias")},
        "transformer": {
            "layers": stack_layers([vlayer(f"transformer.layers.{i}.", False) for i in range(spec.num_layers)],
                                   dtype, device)
        },
        "global_transformer": {
            "layers": stack_layers(
                [vlayer(f"global_transformer.layers.{i}.", True) for i in range(spec.num_global_layers)], dtype, device
            )
        },
    }


def prepare_cross_attention_mask(
    cross_attention_mask: np.ndarray,  # (B, S, num_img, tiles) 1 = attend
    num_vision_tokens: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """HF _prepare_cross_attention_mask: tiles grown to vision-token width;
    a fully masked row is neutralized (attends to everything) and flagged 0
    in the full-text-row mask. Returns ((B, 1, S, Sv) additive, (B, S, 1))."""
    B, S = cross_attention_mask.shape[:2]
    m = np.repeat(cross_attention_mask, num_vision_tokens, axis=3).reshape(B, S, -1)
    inv = 1.0 - m
    add = np.where(inv > 0, NEG_INF, 0.0)[:, None]  # (B, 1, S, Sv)
    full_row = (add != NEG_INF).any(axis=-1).astype(np.float32)[..., None]  # (B, 1, S, 1)
    add = add * full_row  # a fully masked row -> additive 0 (attends to everything)
    return add, full_row[:, 0]
