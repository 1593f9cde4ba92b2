"""Normalization (counterpart of the reference's ``modules/norm.py``)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in fp32, cast back to ``x``'s dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (out * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias=None, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm computed in fp32 (biased variance, as ``jnp.var``), an
    optional bias, cast back to ``x``'s dtype."""
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    out = (xf - mean) * torch.reciprocal(torch.sqrt(var + eps))
    out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def apply_norm(x, weight, eps: float, kind: str = "rmsnorm", bias=None):
    """Norm dispatch: the llama-family rmsnorm or DBRX's LayerNorm."""
    if kind == "layernorm":
        return layer_norm(x, weight, bias=bias, eps=eps)
    if kind != "rmsnorm":
        raise ValueError(f"unknown norm kind {kind!r} (rmsnorm or layernorm)")
    return rms_norm(x, weight, eps)
