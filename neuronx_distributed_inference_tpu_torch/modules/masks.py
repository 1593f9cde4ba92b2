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


def spec_token_gen_mask(attention_mask: torch.Tensor, position_ids: torch.Tensor) -> torch.Tensor:
    """Mask for a multi-token decode pass (chunked or prefix prefill on the
    paged cache, speculation later). attention_mask (B, S_cache) marks
    populated positions; position_ids (B, K) are the active tokens'
    positions. Token i attends positions <= position_ids[:, i] (its own slot
    included), so the new tokens are causal among themselves because they
    are written in order. Returns (B, 1, K, S_cache)."""
    S_cache = attention_mask.shape[1]
    cols = torch.arange(S_cache, device=attention_mask.device)[None, None, :]
    per_tok = cols <= position_ids[:, :, None]
    return (per_tok & attention_mask.bool()[:, None, :])[:, None, :, :]
