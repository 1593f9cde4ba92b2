"""Attention masks (counterpart of the reference's ``modules/masks.py``;
the main-path subset). Masks are boolean, True = attend."""

from __future__ import annotations

import torch


def causal_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """Context-encoding causal mask. attention_mask (B, S) 1 for valid
    tokens -> (B, 1, S, S)."""
    B, S = attention_mask.shape
    causal = torch.tril(torch.ones((S, S), dtype=torch.bool, device=attention_mask.device))
    valid = attention_mask.bool()[:, None, None, :]  # keys valid
    return causal[None, None, :, :] & valid


def token_gen_mask(attention_mask: torch.Tensor, n_active: int = 1) -> torch.Tensor:
    """Decode mask over cache positions. attention_mask (B, S_cache) marks
    populated positions (this step's included) -> (B, 1, n_active, S_cache)."""
    B, S = attention_mask.shape
    return attention_mask.bool()[:, None, None, :].expand(B, 1, n_active, S)
