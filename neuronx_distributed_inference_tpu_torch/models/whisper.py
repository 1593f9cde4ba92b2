"""Whisper encoder-decoder, speech to text (counterpart of the reference's
``models/whisper.py``).

HF Whisper: pre-LN LayerNorm (with bias) transformers, exact-GELU MLPs,
learned positions, and a mel front end of two ``conv1d`` (kernel 3, stride 1
then 2, pad 1). The decoder's ``k_proj`` carries no bias and ``proj_out`` is
tied to ``embed_tokens``. The decoder's self-attention writes its K / V into
the contiguous :class:`~modules.kvcache.KVCache` and attends under
``cols <= positions`` and ``cache_mask``; cross-attention recomputes its K / V
from the encoder states at every step, as the reference does (its docstring
calls precomputing them once a request the planned optimization).

Every attention here is plain PyTorch (matmul and softmax with fp32 scores),
as the reference computes it in einsums: no Pallas kernel sits on this path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from neuronx_distributed_inference_tpu_torch.models.base import unstack_layers
from neuronx_distributed_inference_tpu_torch.models.pixtral import stack_layers, tower_tensor
from neuronx_distributed_inference_tpu_torch.modules.kvcache import (
    KVCache,
    read_cache_at_layer,
    update_cache_at_layer,
)
from neuronx_distributed_inference_tpu_torch.modules.norm import layer_norm

#: openai/whisper-large-v3's published config (the widths; HF's
#: WhisperConfig names)
WHISPER_LARGE_V3 = dict(
    model_type="whisper",
    d_model=1280,
    encoder_layers=32,
    decoder_layers=32,
    encoder_attention_heads=20,
    decoder_attention_heads=20,
    encoder_ffn_dim=5120,
    decoder_ffn_dim=5120,
    num_mel_bins=128,
    vocab_size=51866,
    max_source_positions=1500,
    max_target_positions=448,
    decoder_start_token_id=50258,
    eos_token_id=50257,
)


@dataclass(frozen=True)
class WhisperSpec:
    d_model: int
    encoder_layers: int
    decoder_layers: int
    num_heads: int
    num_mel_bins: int
    vocab_size: int
    max_source_positions: int
    max_target_positions: int

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def _ln(p, x):
    return layer_norm(x, p["weight"], bias=p["bias"], eps=1e-5)


def _proj(p, x):
    y = x @ p["weight"]
    if "bias" in p:
        y = y + p["bias"]
    return y


def _mha(q, k, v, spec: WhisperSpec, mask=None):
    """q (B, Sq, H*D), k / v (B, Sk, H*D) -> (B, Sq, H*D); ``mask`` (B, 1,
    Sq, Sk) bool. fp32 scores and softmax, probabilities in v's dtype."""
    B, Sq, _ = q.shape
    Sk = k.shape[1]
    H, D = spec.num_heads, spec.head_dim
    q = q.reshape(B, Sq, H, D).transpose(1, 2)
    k = k.reshape(B, Sk, H, D).transpose(1, 2)
    v = v.reshape(B, Sk, H, D).transpose(1, 2)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (D**-0.5)
    if mask is not None:
        scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(probs, v).transpose(1, 2).reshape(B, Sq, H * D)


def _attn_block(p, hidden, kv_hidden, spec, mask=None):
    """One (self or cross) attention: q / k / v / out projections around
    :func:`_mha`; ``k_proj`` has no bias (HF)."""
    q = _proj(p["q_proj"], hidden)
    k = kv_hidden @ p["k_proj"]["weight"]
    v = _proj(p["v_proj"], kv_hidden)
    return _proj(p["out_proj"], _mha(q, k, v, spec, mask))


def _mlp(lp, h):
    z = _ln(lp["final_layer_norm"], h)
    return h + _proj(lp["fc2"], F.gelu(_proj(lp["fc1"], z)))


def whisper_encoder(params: Dict, input_features: torch.Tensor, spec: WhisperSpec) -> torch.Tensor:
    """(B, num_mel_bins, T) log-mel -> (B, T // 2, d_model) in the params'
    dtype."""
    dt = params["conv1"]["weight"].dtype
    x = input_features.to(dt)
    x = F.gelu(F.conv1d(x, params["conv1"]["weight"], params["conv1"]["bias"], stride=1, padding=1))
    x = F.gelu(F.conv1d(x, params["conv2"]["weight"], params["conv2"]["bias"], stride=2, padding=1))
    x = x.transpose(1, 2)  # (B, T', d)
    x = x + params["embed_positions"]["weight"][: x.shape[1]][None]
    for lp in unstack_layers(params["layers"]):
        z = _ln(lp["self_attn_layer_norm"], x)
        x = x + _attn_block(lp["self_attn"], z, z, spec)
        x = _mlp(lp, x)
    return _ln(params["layer_norm"], x)


def whisper_decoder_step(
    params: Dict,
    cache: KVCache,
    tokens: torch.Tensor,  # (B, S) int
    positions: torch.Tensor,  # (B, S) int
    cache_mask: torch.Tensor,  # (B, W) int: the valid cache region, this step's included
    encoder_hidden: torch.Tensor,  # (B, T_enc, d_model)
    spec: WhisperSpec,
) -> torch.Tensor:
    """One decoder pass over S tokens (the forced ids' prefill, or a decode
    step): cached causal self-attention, write then attend, and
    cross-attention over the encoder states. Writes the cache IN PLACE and
    returns the (B, S, V) fp32 logits."""
    B, S = tokens.shape
    W = cache_mask.shape[1]
    h = params["embed_tokens"]["weight"][tokens.long()] + params["embed_positions"]["weight"][positions.long()]
    cols = torch.arange(W, device=h.device)[None, None, None, :]
    self_mask = (cols <= positions[:, None, :, None]) & cache_mask.bool()[:, None, None, :]
    slot_ids = torch.arange(B, dtype=torch.int32, device=h.device)
    H, D = spec.num_heads, spec.head_dim
    for li, lp in enumerate(unstack_layers(params["layers"])):
        z = _ln(lp["self_attn_layer_norm"], h)
        sa = lp["self_attn"]
        q = _proj(sa["q_proj"], z)
        k = z @ sa["k_proj"]["weight"]
        v = _proj(sa["v_proj"], z)
        update_cache_at_layer(cache.k, cache.v, k.reshape(B, S, H, D), v.reshape(B, S, H, D), li, slot_ids, positions)
        k_r, v_r = read_cache_at_layer(cache.k, cache.v, li, B, W)
        attn = _mha(q, k_r.reshape(B, W, H * D), v_r.reshape(B, W, H * D), spec, self_mask)
        h = h + _proj(sa["out_proj"], attn)
        z = _ln(lp["encoder_attn_layer_norm"], h)
        h = h + _attn_block(lp["encoder_attn"], z, encoder_hidden, spec)
        h = _mlp(lp, h)
    h = _ln(params["layer_norm"], h)
    return (h @ params["embed_tokens"]["weight"].T).float()  # tied proj_out


def whisper_spec(cfg) -> WhisperSpec:
    g = cfg.get if isinstance(cfg, dict) else lambda k, d=None: getattr(cfg, k, d)
    return WhisperSpec(
        d_model=g("d_model"),
        encoder_layers=g("encoder_layers"),
        decoder_layers=g("decoder_layers"),
        num_heads=g("decoder_attention_heads"),
        num_mel_bins=g("num_mel_bins"),
        vocab_size=g("vocab_size"),
        max_source_positions=g("max_source_positions"),
        max_target_positions=g("max_target_positions"),
    )


def convert_whisper_state_dict(sd: Dict, spec: WhisperSpec, dtype, device) -> Dict:
    """HF WhisperForConditionalGeneration weights -> the params tree
    (``encoder`` / ``decoder``, each with a stacked ``layers`` tree) on
    ``device``. Linear weights transpose to (in, out); the convs keep
    torch's (out, in, 3)."""

    def get(name):
        x = sd[name]
        return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)

    def lin(prefix, bias=True):
        out = {"weight": get(prefix + ".weight").T}
        if bias:
            out["bias"] = get(prefix + ".bias")
        return out

    def wb(prefix):
        return {"weight": get(prefix + ".weight"), "bias": get(prefix + ".bias")}

    def attn(prefix):
        return {
            "q_proj": lin(prefix + ".q_proj"),
            "k_proj": lin(prefix + ".k_proj", bias=False),
            "v_proj": lin(prefix + ".v_proj"),
            "out_proj": lin(prefix + ".out_proj"),
        }

    def layer(p, cross):
        out = {
            "self_attn": attn(p + ".self_attn"),
            "self_attn_layer_norm": wb(p + ".self_attn_layer_norm"),
            "fc1": lin(p + ".fc1"),
            "fc2": lin(p + ".fc2"),
            "final_layer_norm": wb(p + ".final_layer_norm"),
        }
        if cross:
            out["encoder_attn"] = attn(p + ".encoder_attn")
            out["encoder_attn_layer_norm"] = wb(p + ".encoder_attn_layer_norm")
        return out

    def t(tree):
        if isinstance(tree, dict):
            return {k: t(v) for k, v in tree.items()}
        return tower_tensor(tree, dtype, device)

    enc_layers = [layer(f"model.encoder.layers.{i}", False) for i in range(spec.encoder_layers)]
    dec_layers = [layer(f"model.decoder.layers.{i}", True) for i in range(spec.decoder_layers)]
    return {
        "encoder": {
            **t({
                "conv1": wb("model.encoder.conv1"),
                "conv2": wb("model.encoder.conv2"),
                "embed_positions": {"weight": get("model.encoder.embed_positions.weight")},
                "layer_norm": wb("model.encoder.layer_norm"),
            }),
            "layers": stack_layers(enc_layers, dtype, device),
        },
        "decoder": {
            **t({
                "embed_tokens": {"weight": get("model.decoder.embed_tokens.weight")},
                "embed_positions": {"weight": get("model.decoder.embed_positions.weight")},
                "layer_norm": wb("model.decoder.layer_norm"),
            }),
            "layers": stack_layers(dec_layers, dtype, device),
        },
    }


def whisper_param_shapes(spec: WhisperSpec, ffn_dim: int) -> Dict:
    """Leaf shapes of the params tree (``ffn_dim``: the MLP width), for
    seeded weights made on the device."""
    d, V = spec.d_model, spec.vocab_size

    def lin(i, o, bias=True):
        return {"weight": (i, o), "bias": (o,)} if bias else {"weight": (i, o)}

    def attn():
        return {"q_proj": lin(d, d), "k_proj": lin(d, d, bias=False), "v_proj": lin(d, d), "out_proj": lin(d, d)}

    def ln():
        return {"weight": (d,), "bias": (d,)}

    def layer(cross):
        out = {"self_attn": attn(), "self_attn_layer_norm": ln(), "fc1": lin(d, ffn_dim), "fc2": lin(ffn_dim, d),
               "final_layer_norm": ln()}
        if cross:
            out.update(encoder_attn=attn(), encoder_attn_layer_norm=ln())
        return out

    def stack(tree, n):
        return {k: stack(v, n) for k, v in tree.items()} if isinstance(tree, dict) else (n,) + tree

    return {
        "encoder": {
            "conv1": {"weight": (d, spec.num_mel_bins, 3), "bias": (d,)},
            "conv2": {"weight": (d, d, 3), "bias": (d,)},
            "embed_positions": {"weight": (spec.max_source_positions, d)},
            "layers": stack(layer(False), spec.encoder_layers),
            "layer_norm": ln(),
        },
        "decoder": {
            "embed_tokens": {"weight": (V, d)},
            "embed_positions": {"weight": (spec.max_target_positions, d)},
            "layers": stack(layer(True), spec.decoder_layers),
            "layer_norm": ln(),
        },
    }
