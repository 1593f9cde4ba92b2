"""Attention masks (counterpart of the reference's ``modules/masks.py``;
the causal, decode, sliding-window and chunked flavors). Masks are boolean,
True = attend."""

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


def windowed_mask(attention_mask: torch.Tensor, position_ids: torch.Tensor, window: int) -> torch.Tensor:
    """Sliding-window causal prefill mask: the query at position p attends
    valid keys in (p - window, p]. Returns (B, 1, S, S)."""
    q_pos = position_ids[:, :, None]
    k_pos = position_ids[:, None, :]
    in_window = (k_pos <= q_pos) & (k_pos > q_pos - window)
    return (in_window & attention_mask.bool()[:, None, :])[:, None, :, :]


def chunked_mask(attention_mask: torch.Tensor, position_ids: torch.Tensor, chunk: int) -> torch.Tensor:
    """Chunked-attention causal prefill mask (Llama4): the query at position
    p attends valid keys at positions <= p in its own block of ``chunk``
    positions. Returns (B, 1, S, S)."""
    q_pos = position_ids[:, :, None]
    k_pos = position_ids[:, None, :]
    same_chunk = torch.div(q_pos, chunk, rounding_mode="floor") == torch.div(k_pos, chunk, rounding_mode="floor")
    return (same_chunk & (k_pos <= q_pos) & attention_mask.bool()[:, None, :])[:, None, :, :]


def windowed_token_gen_mask(
    cache_positions: torch.Tensor, position_ids: torch.Tensor, valid: torch.Tensor, window: int
) -> torch.Tensor:
    """Decode mask over a ring cache: cache_positions (B, W) is the absolute
    position each slot holds, position_ids (B, K) the queries', valid (B, W)
    the populated slots. Returns (B, 1, K, W)."""
    q = position_ids[:, :, None]
    k = cache_positions[:, None, :]
    ok = (k <= q) & (k > q - window) & valid.bool()[:, None, :]
    return ok[:, None, :, :]
