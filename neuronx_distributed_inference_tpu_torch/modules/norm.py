"""Normalization (counterpart of the reference's ``modules/norm.py``)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in fp32, cast back to ``x``'s dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (out * weight.float()).to(x.dtype)


def apply_norm(x, weight, eps: float, kind: str = "rmsnorm"):
    """Norm dispatch. Only the llama-family rmsnorm is ported (LayerNorm
    belongs to DBRX, ROADMAP A9)."""
    if kind != "rmsnorm":
        raise NotImplementedError(f"norm kind {kind!r} is not ported yet (ROADMAP A9)")
    return rms_norm(x, weight, eps)
