"""Contiguous KV cache (counterpart of the reference's ``modules/kvcache.py``;
the plain, unquantized layout only — ``QuantizedKV`` waits for ROADMAP A6).

The cache is two stacked tensors ``k, v: (L, B+1, S_max, H_kv, D)``. Batch
row ``b`` owns cache line ``b``; the extra line ``B`` is the garbage line
that writes of invalid rows (seq_id -1, padded batch rows) land in, so they
never touch live state. Unlike the reference's donated JAX arrays, the port
updates the cache IN PLACE (``Tensor.__setitem__``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

GARBAGE_LINES = 1  # padding-zone lines for invalid seq_id writes


@dataclass
class KVCache:
    """Stacked per-layer KV buffers, k/v: (L, B+1, S_max, H_kv, D)."""

    k: torch.Tensor
    v: torch.Tensor


def kv_batch_size(cache: KVCache) -> int:
    """Real (non-garbage) cache lines."""
    return cache.k.shape[1] - GARBAGE_LINES


def init_cache(
    num_layers: int,
    batch_size: int,
    max_len: int,
    num_kv_heads: int,
    head_dim: int,
    dtype=torch.bfloat16,
    *,
    device,
) -> KVCache:
    """Zeroed stacked caches on ``device`` (no default: the caller names the
    card or the CPU)."""
    rows = batch_size + GARBAGE_LINES
    shape = (num_layers, rows, max_len, num_kv_heads, head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
    )


def slot_ids_from_seq_ids(seq_ids: torch.Tensor, batch_size: int) -> torch.Tensor:
    """Map seq_ids to cache lines; invalid ids (< 0 or >= B) go to the
    garbage line B."""
    valid = (seq_ids >= 0) & (seq_ids < batch_size)
    return torch.where(valid, seq_ids, torch.full_like(seq_ids, batch_size))


def update_cache_at_layer(
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    layer_idx: int,
    slot_ids: torch.Tensor,
    positions: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write new K/V into the full stacked cache at one layer, IN PLACE.

    k_new/v_new (B, S_new, H_kv, D); slot_ids (B,); positions (B, S_new).

    The reference scatters with ``mode="drop"``, which discards writes
    whose position lies outside ``[0, S_max)`` (the prefill pad positions
    of a bucket can run past the cache). ``index_put_`` raises on such an
    index instead, so those writes are redirected here to position 0 of
    the garbage line, which no real row ever reads — the same effect,
    without a host sync on a data-dependent mask.
    """
    garbage = k_cache.shape[1] - 1
    s_max = k_cache.shape[2]
    ok = (positions >= 0) & (positions < s_max)
    rows = torch.where(ok, slot_ids[:, None].expand_as(positions), garbage)
    pos = torch.where(ok, positions, 0)
    k_cache[layer_idx, rows, pos] = k_new.to(k_cache.dtype)
    v_cache[layer_idx, rows, pos] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


def read_cache_at_layer(
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    layer_idx: int,
    batch_size: int,
    bucket_len: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer's cache sliced to (batch, bucket): views, no copy."""
    return (
        k_cache[layer_idx, :batch_size, :bucket_len],
        v_cache[layer_idx, :batch_size, :bucket_len],
    )
