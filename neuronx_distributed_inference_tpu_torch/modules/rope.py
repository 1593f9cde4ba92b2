"""Rotary position embeddings (counterpart of the reference's
``modules/rope.py``): the default, llama3-scaled and YaRN ``inv_freq``
variants, fp32 cos/sin tables, the HF half-rotation convention and
Llama4's complex-pair one."""

from __future__ import annotations

import math

import torch


def default_inv_freq(head_dim: int, rope_theta: float = 10000.0) -> torch.Tensor:
    return 1.0 / (rope_theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim))


def llama3_scaled_inv_freq(
    head_dim: int,
    rope_theta: float,
    factor: float = 8.0,
    low_freq_factor: float = 1.0,
    high_freq_factor: float = 4.0,
    original_max_position_embeddings: int = 8192,
) -> torch.Tensor:
    """Llama-3.x rope scaling."""
    inv_freq = default_inv_freq(head_dim, rope_theta)
    old_context_len = original_max_position_embeddings
    low_freq_wavelen = old_context_len / low_freq_factor
    high_freq_wavelen = old_context_len / high_freq_factor
    wavelen = 2 * math.pi / inv_freq
    # wavelen < high_freq_wavelen: keep; > low_freq_wavelen: /factor; else smooth
    smooth = (old_context_len / wavelen - low_freq_factor) / (high_freq_factor - low_freq_factor)
    return torch.where(
        wavelen > low_freq_wavelen,
        inv_freq / factor,
        torch.where(
            wavelen < high_freq_wavelen,
            inv_freq,
            (1 - smooth) * inv_freq / factor + smooth * inv_freq,
        ),
    )


def yarn_inv_freq(
    head_dim: int,
    rope_theta: float,
    factor: float,
    beta_fast: float = 32.0,
    beta_slow: float = 1.0,
    original_max_position_embeddings: int = 4096,
) -> torch.Tensor:
    """YaRN rope scaling."""
    dim = head_dim
    freq_extra = default_inv_freq(dim, rope_theta)
    freq_inter = freq_extra / factor

    def find_dim(num_rot):
        return (dim * math.log(original_max_position_embeddings / (num_rot * 2 * math.pi))) / (
            2 * math.log(rope_theta)
        )

    low = max(math.floor(find_dim(beta_fast)), 0)
    high = min(math.ceil(find_dim(beta_slow)), dim - 1)
    ramp = torch.clamp(
        (torch.arange(dim // 2, dtype=torch.float32) - low) / max(high - low, 1e-3), 0, 1
    )
    mask = 1.0 - ramp
    return freq_inter * (1 - mask) + freq_extra * mask


def yarn_mscale(factor: float, mscale: float = 1.0) -> float:
    if factor <= 1:
        return 1.0
    return 0.1 * mscale * math.log(factor) + 1.0


def rope_attention_scaling(config) -> float:
    """cos/sin magnitude factor from rope_scaling: an explicit
    ``attention_factor`` wins; YaRN defaults to :func:`yarn_mscale`; other
    rope types use 1.0."""
    scaling = getattr(config, "rope_scaling", None)
    if not scaling:
        return 1.0
    if scaling.get("attention_factor") is not None:
        return float(scaling["attention_factor"])
    rope_type = scaling.get("rope_type", scaling.get("type", "default"))
    if rope_type == "yarn":
        return yarn_mscale(scaling.get("factor", 1.0), scaling.get("mscale", 1.0))
    return 1.0


def compute_inv_freq(config) -> torch.Tensor:
    """Pick the rope variant from an InferenceConfig's HF attrs (fp32, CPU;
    the builder moves it to the model's device)."""
    head_dim = getattr(config, "head_dim", None) or (
        config.hidden_size // config.num_attention_heads
    )
    rope_dim = getattr(config, "rope_dim", None) or head_dim
    theta = getattr(config, "rope_theta", 10000.0)
    scaling = getattr(config, "rope_scaling", None)
    if scaling:
        rope_type = scaling.get("rope_type", scaling.get("type", "default"))
        if rope_type == "llama3":
            return llama3_scaled_inv_freq(
                rope_dim,
                theta,
                factor=scaling.get("factor", 8.0),
                low_freq_factor=scaling.get("low_freq_factor", 1.0),
                high_freq_factor=scaling.get("high_freq_factor", 4.0),
                original_max_position_embeddings=scaling.get(
                    "original_max_position_embeddings", 8192
                ),
            )
        if rope_type == "yarn":
            return yarn_inv_freq(
                rope_dim,
                theta,
                factor=scaling.get("factor", 1.0),
                beta_fast=scaling.get("beta_fast", 32.0),
                beta_slow=scaling.get("beta_slow", 1.0),
                original_max_position_embeddings=scaling.get(
                    "original_max_position_embeddings", 4096
                ),
            )
        if rope_type in ("default", "linear", "dynamic"):
            inv = default_inv_freq(rope_dim, theta)
            if rope_type == "linear":
                inv = inv / scaling.get("factor", 1.0)
            return inv
    return default_inv_freq(rope_dim, theta)


def rope_cos_sin(position_ids: torch.Tensor, inv_freq: torch.Tensor, attention_scaling: float = 1.0):
    """fp32 cos/sin tables. position_ids (B, S) -> (B, S, rope_dim/2)."""
    freqs = position_ids[..., None].float() * inv_freq.float()[None, None, :]
    return torch.cos(freqs) * attention_scaling, torch.sin(freqs) * attention_scaling


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """HF half-rotation rope in fp32. x (B, S, H, D); cos/sin (B, S, D/2)."""
    d2 = x.shape[-1] // 2
    xf1 = x[..., :d2].float()
    xf2 = x[..., d2:].float()
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    out1 = xf1 * cos - xf2 * sin
    out2 = xf2 * cos + xf1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


def apply_rope_interleaved(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Complex-pair rope in fp32 (Llama4's ``view_as_complex`` convention):
    adjacent pairs (x[2i], x[2i+1]) rotate by angle i. x (B, S, H, D);
    cos/sin (B, S, D/2)."""
    x0 = x[..., 0::2].float()
    x1 = x[..., 1::2].float()
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    out = torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1).reshape(x.shape)
    return out.to(x.dtype)
