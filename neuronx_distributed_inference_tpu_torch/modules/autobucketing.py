"""Sequence-length bucket ladders (counterpart of the reference's
``modules/autobucketing.py``; pure Python, copied so the port needs no
import of the JAX package)."""

from __future__ import annotations

from typing import List, Optional


def generate_buckets(min_len: int, max_len: int) -> List[int]:
    """Powers-of-2 ladder from min_len to max_len inclusive."""
    if min_len >= max_len:
        return [max_len]
    lo = max(1, min_len)
    buckets = []
    b = 1 << (lo - 1).bit_length()  # next pow2 >= lo
    while b < max_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_len)
    return buckets


def generate_context_encoding_buckets(
    config, max_context_length: Optional[int] = None
) -> List[int]:
    """CTE buckets."""
    if config.context_encoding_buckets:
        return sorted(config.context_encoding_buckets)
    max_len = max_context_length or config.max_context_length
    if not config.enable_bucketing:
        return [max_len]
    return generate_buckets(128, max_len)


def generate_token_generation_buckets(config, max_length: Optional[int] = None) -> List[int]:
    """TKG buckets over total sequence length."""
    if config.token_generation_buckets:
        return sorted(config.token_generation_buckets)
    max_len = max_length or config.max_length or config.seq_len
    if not config.enable_bucketing:
        return [max_len]
    return generate_buckets(128, max_len)


def generate_fused_spec_buckets(config) -> List[int]:
    """Fused-speculation buckets."""
    return generate_token_generation_buckets(config)


def get_target_bucket(buckets: List[int], length: int) -> int:
    """Smallest bucket >= length."""
    for b in buckets:
        if b >= length:
            return b
    raise ValueError(f"length {length} exceeds max bucket {buckets[-1]}")


def pad_length_to_bucket(length: int, buckets: List[int]) -> int:
    return get_target_bucket(buckets, length)


def round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def pow2_bucket(n: int, lo: int = 8) -> int:
    """Smallest power of two >= n (at least lo)."""
    b = lo
    while b < n:
        b *= 2
    return b


def generate_chunk_q_buckets(config) -> List[int]:
    """Query-length ladder for chunked/prefix prefill."""
    cpc = getattr(config, "chunked_prefill_config", None)
    if getattr(config, "is_chunked_prefill", False) and cpc is not None:
        top = pow2_bucket(cpc.kernel_q_tile_size)
    else:
        top = pow2_bucket(config.max_context_length or config.seq_len)
    out = []
    b = 8
    while b <= top:
        out.append(b)
        b *= 2
    return out
