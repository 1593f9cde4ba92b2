"""FLUX's VAE decoder, the AutoencoderKL decoder half (counterpart of the
reference's ``models/flux_vae.py``).

diffusers' ``Decoder``: conv_in -> mid (resnet, single-head attention,
resnet) -> up blocks (layers_per_block + 1 resnets each, a nearest 2x
upsample and a conv between levels) -> GroupNorm -> silu -> conv_out. The
latents are unnormalised (z / scaling_factor + shift_factor) before
conv_in. The reference computes NHWC with HWIO weights; the port computes
NCHW with torch's OIHW weights (``torch.nn.functional.conv2d``) and returns
the reference's (B, 8h, 8w, 3). Group norm runs in fp32. The mid block's
attention is plain PyTorch, as in the reference: no Pallas kernel sits on
this path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from neuronx_distributed_inference_tpu_torch.models.flux_text import _hf_np, _tree

GN_GROUPS = 32


@dataclass(frozen=True)
class VaeDecoderSpec:
    latent_channels: int = 16  # FLUX VAE
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2  # the decoder uses layers_per_block + 1 resnets
    norm_groups: int = GN_GROUPS
    scaling_factor: float = 0.3611
    shift_factor: float = 0.1159
    eps: float = 1e-6


def group_norm(x: torch.Tensor, w, b, groups: int, eps: float) -> torch.Tensor:
    """NCHW group norm in fp32 over (C / g, H, W), cast back."""
    B, C, H, W = x.shape
    g = min(groups, C)
    xf = x.float().reshape(B, g, C // g, H, W)
    mu = xf.mean(dim=(2, 3, 4), keepdim=True)
    var = torch.square(xf - mu).mean(dim=(2, 3, 4), keepdim=True)
    xf = ((xf - mu) * torch.rsqrt(var + eps)).reshape(B, C, H, W)
    return (xf * w.float()[:, None, None] + b.float()[:, None, None]).to(x.dtype)


def conv2d(x: torch.Tensor, params: Dict, stride: int = 1, padding: int = 1) -> torch.Tensor:
    """NCHW conv with OIHW weights, in x's dtype."""
    return F.conv2d(x, params["weight"].to(x.dtype), params["bias"].to(x.dtype), stride=stride, padding=padding)


def _resnet(params: Dict, x: torch.Tensor, spec: VaeDecoderSpec) -> torch.Tensor:
    h = F.silu(group_norm(x, params["norm1"]["weight"], params["norm1"]["bias"], spec.norm_groups, spec.eps))
    h = conv2d(h, params["conv1"])
    h = F.silu(group_norm(h, params["norm2"]["weight"], params["norm2"]["bias"], spec.norm_groups, spec.eps))
    h = conv2d(h, params["conv2"])
    if "conv_shortcut" in params:
        x = conv2d(x, params["conv_shortcut"], padding=0)
    return x + h


def _mid_attention(params: Dict, x: torch.Tensor, spec: VaeDecoderSpec) -> torch.Tensor:
    """Single-head spatial self-attention (diffusers' Attention in the mid
    block): fp32 scores over every pixel pair, the weights cast to x's
    dtype, as in the reference."""
    B, C, H, W = x.shape
    h = group_norm(x, params["group_norm"]["weight"], params["group_norm"]["bias"], spec.norm_groups, spec.eps)
    flat = h.reshape(B, C, H * W).transpose(1, 2)  # (B, HW, C)

    def lin(p, t):
        return t @ p["weight"].to(t.dtype) + p["bias"].to(t.dtype)

    q, k, v = lin(params["to_q"], flat), lin(params["to_k"], flat), lin(params["to_v"], flat)
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * C**-0.5
    o = lin(params["to_out"], torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v))
    return x + o.transpose(1, 2).reshape(B, C, H, W)


def _upsample(params: Dict, x: torch.Tensor) -> torch.Tensor:
    x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)  # nearest 2x
    return conv2d(x, params["conv"])


def vae_decode(params: Dict, latents: torch.Tensor, *, spec: VaeDecoderSpec) -> torch.Tensor:
    """latents (B, h, w, latent_channels) NHWC -> image (B, 8h, 8w, 3) NHWC,
    in [-1, 1]; unnormalises the latents first and computes in fp32 from
    there, as the reference does."""
    z = latents.float() / spec.scaling_factor + spec.shift_factor
    x = conv2d(z.permute(0, 3, 1, 2), params["conv_in"])
    x = _resnet(params["mid"]["resnet_0"], x, spec)
    x = _mid_attention(params["mid"]["attn"], x, spec)
    x = _resnet(params["mid"]["resnet_1"], x, spec)
    for up in params["up"]:
        for ri in range(spec.layers_per_block + 1):
            x = _resnet(up[f"resnet_{ri}"], x, spec)
        if "upsample" in up:
            x = _upsample(up["upsample"], x)
    x = F.silu(group_norm(x, params["norm_out"]["weight"], params["norm_out"]["bias"], spec.norm_groups, spec.eps))
    return conv2d(x, params["conv_out"]).permute(0, 2, 3, 1)


def convert_vae_decoder_state_dict(sd: Dict, spec: VaeDecoderSpec, dtype=torch.float32, device="cpu") -> Dict:
    """diffusers' AutoencoderKL decoder -> the params tree on ``device``:
    convs keep OIHW, the attention projections transpose to (in, out)."""

    def conv(n):
        return {"weight": _hf_np(sd, n + ".weight"), "bias": _hf_np(sd, n + ".bias")}

    def lin(n):
        return {"weight": _hf_np(sd, n + ".weight").T, "bias": _hf_np(sd, n + ".bias")}

    norm = conv

    def resnet(p):
        out = {"norm1": norm(p + ".norm1"), "conv1": conv(p + ".conv1"), "norm2": norm(p + ".norm2"),
               "conv2": conv(p + ".conv2")}
        if p + ".conv_shortcut.weight" in sd:
            out["conv_shortcut"] = conv(p + ".conv_shortcut")
        return out

    pre = "decoder."
    a = pre + "mid_block.attentions.0"
    tree = {
        "conv_in": conv(pre + "conv_in"),
        "mid": {
            "resnet_0": resnet(pre + "mid_block.resnets.0"),
            "attn": {"group_norm": norm(a + ".group_norm"), "to_q": lin(a + ".to_q"), "to_k": lin(a + ".to_k"),
                     "to_v": lin(a + ".to_v"), "to_out": lin(a + ".to_out.0")},
            "resnet_1": resnet(pre + "mid_block.resnets.1"),
        },
        "norm_out": norm(pre + "conv_norm_out"),
        "conv_out": conv(pre + "conv_out"),
    }
    ups = []
    for ui in range(len(spec.block_out_channels)):
        p = pre + f"up_blocks.{ui}"
        blk = {f"resnet_{ri}": resnet(p + f".resnets.{ri}") for ri in range(spec.layers_per_block + 1)}
        if p + ".upsamplers.0.conv.weight" in sd:
            blk["upsample"] = {"conv": conv(p + ".upsamplers.0.conv")}
        ups.append(blk)
    out = _tree(tree, dtype, device)
    out["up"] = [_tree(blk, dtype, device) for blk in ups]
    return out
