"""Paged (block) KV cache and its host-side block allocator (counterpart of
the reference's ``modules/block_kvcache.py``), plain or int8/fp8 code
blocks (:class:`~modules.kvcache.QuantizedKV` streams whose (L, H_kv) scales
are shared by the whole pool).

Layout is HEAD-MAJOR ``(L, num_blocks+1, H_kv, block_size, D)``, as in the
reference: one head's block is a contiguous ``(block_size, D)`` tile, which
is also what lets the paged kernels read a block with unit-stride loads.
Block 0 is reserved as the garbage block.

Device side:
- writes scatter token K/V through a flat ``slot_mapping`` (block *
  block_size + offset), IN PLACE (the reference returns a new array);
- reads gather a row's blocks through its ``block_table`` into a contiguous
  ``(B, MB * block_size, H_kv, D)`` view, with the gathered garbage blocks
  zeroed (the NaN scrub); code blocks dequantize after the gather, to fp32.

Host side: :class:`BlockAllocator` and :class:`PrefixCachingAllocator`
manage the free pool, build slot mappings and block tables, and address
prompt prefixes by content (:func:`prefix_chain_keys`). They are plain
Python, copied from the reference.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

from neuronx_distributed_inference_tpu_torch.modules.kvcache import (
    QuantizedKV,
    Stream,
    _quantized_update,
    dequantize_kv,
    new_stream,
)

GARBAGE_BLOCK = 0  # block id 0 reserved for invalid-slot writes


def prefix_chain_keys(tokens: np.ndarray, block_size: int) -> List[bytes]:
    """Content-addressing keys for prefix caching: one running-sha1 key per
    FULL block of ``tokens`` (a block matches only when its content AND
    everything before it match)."""
    keys: List[bytes] = []
    h = hashlib.sha1()
    for i in range(len(tokens) // block_size):
        h.update(np.asarray(tokens[i * block_size : (i + 1) * block_size], np.int32).tobytes())
        keys.append(h.digest())
    return keys


@dataclass
class BlockKVCache:
    """k/v: (L, num_blocks+1, H_kv, block_size, D) — head-major blocks
    (tensors, or QuantizedKV streams of that layout)."""

    k: Stream
    v: Stream

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]

    @property
    def num_blocks(self) -> int:
        return self.k.shape[1] - 1

    @property
    def block_size(self) -> int:
        return self.k.shape[3]


def init_block_cache(
    num_layers: int,
    num_blocks: int,
    block_size: int,
    num_kv_heads: int,
    head_dim: int,
    dtype: torch.dtype,
    device,
) -> BlockKVCache:
    shape = (num_layers, num_blocks + 1, num_kv_heads, block_size, head_dim)
    return BlockKVCache(
        k=new_stream(shape, dtype, device, num_layers, num_kv_heads),
        v=new_stream(shape, dtype, device, num_layers, num_kv_heads),
    )


def kv_block_bytes(num_layers: int, block_size: int, num_kv_heads: int, head_dim: int, dtype) -> int:
    """Bytes of K+V for ONE block across all layers, in the cache dtype —
    what sizes the serving block pool (an int8/fp8 pool of the same bytes
    holds twice the bf16 blocks; the (L, H) scales are left out)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return int(2 * num_layers * num_kv_heads * block_size * head_dim * itemsize)


def update_block_cache_at_layer(
    k_cache: torch.Tensor,  # (L, NB+1, H, bs, D)
    v_cache: torch.Tensor,
    k_new: torch.Tensor,  # (B, S, H, D)
    v_new: torch.Tensor,
    layer_idx: int,
    slot_mapping: torch.Tensor,  # (B, S) flat slots; < 0 -> garbage block
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter token K/V into the paged cache at one layer, IN PLACE.

    The reference drops negative slots by mapping them past the last block
    (scatter ``mode="drop"``); ``index_put_`` raises on such an index, so
    here they are written to offset 0 of the garbage block 0 instead. Every
    read scrubs block 0 to zeros (:func:`read_block_cache_at_layer`, and the
    paged kernels), so what lands there is never read as valid — the same
    design as the contiguous cache's garbage line.

    QuantizedKV streams quantize in this write; writes to a negative slot
    or into the garbage block (an idle row's all-zero table) stay out of
    the pool-wide scale."""
    bs = k_cache.shape[3]
    B, S = slot_mapping.shape
    slots = slot_mapping.reshape(B * S).to(torch.int64)
    ok = slots >= 0
    blocks = torch.where(ok, slots // bs, GARBAGE_BLOCK)
    offs = torch.where(ok, slots % bs, 0)
    H, D = k_new.shape[2], k_new.shape[3]
    if isinstance(k_cache, QuantizedKV):
        valid = (slot_mapping >= 0) & (torch.div(slot_mapping, bs, rounding_mode="floor") != GARBAGE_BLOCK)
        k_codes, v_codes = _quantized_update(k_cache, v_cache, k_new, v_new, layer_idx, valid)
        k_cache.data[layer_idx][blocks, :, offs] = k_codes.reshape(B * S, H, D)
        v_cache.data[layer_idx][blocks, :, offs] = v_codes.reshape(B * S, H, D)
        return k_cache, v_cache
    # k_cache[layer] is (NB+1, H, bs, D); the two index tensors around the
    # head slice give one (B*S, H, D) scatter
    k_cache[layer_idx][blocks, :, offs] = k_new.reshape(B * S, H, D).to(k_cache.dtype)
    v_cache[layer_idx][blocks, :, offs] = v_new.reshape(B * S, H, D).to(v_cache.dtype)
    return k_cache, v_cache


def slot_mapping_from_block_table(
    block_table: torch.Tensor,  # (B, MB)
    positions: torch.Tensor,  # (B, S) logical positions
    block_size: int,
) -> torch.Tensor:
    """Write slots for token-gen steps, computed on the device from the
    block table: position p goes to ``block_table[p // bs] * bs + p % bs``."""
    pos = positions.to(torch.int64)
    block_ids = torch.take_along_dim(block_table.to(torch.int64), pos // block_size, dim=1)
    return (block_ids * block_size + pos % block_size).to(torch.int32)


def read_block_cache_at_layer(
    k_cache: torch.Tensor,  # (L, NB+1, H, bs, D)
    v_cache: torch.Tensor,
    layer_idx: int,
    block_table: torch.Tensor,  # (B, MB); 0 for unused tail entries
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather one layer's blocks of each row into a contiguous
    ``(B, MB * bs, H, D)`` copy in logical position order.

    The gathered garbage blocks are zeroed: table-zero entries all point at
    block 0, whose contents are whatever invalid-slot writes last put there,
    NaN from a poisoned co-batched row included. A masked probability is
    exactly 0, but 0 * NaN = NaN in the P·V product, so without the scrub
    one row's NaN would reach every row through the shared block. Code
    blocks dequantize after the gather, to fp32."""
    if isinstance(k_cache, QuantizedKV):
        k_r, v_r = read_block_cache_at_layer(k_cache.data, v_cache.data, layer_idx, block_table)
        return (
            dequantize_kv(k_r, k_cache.scale[layer_idx]),
            dequantize_kv(v_r, v_cache.scale[layer_idx]),
        )
    B, MB = block_table.shape
    H, bs, D = k_cache.shape[2:]
    idx = block_table.to(torch.int64)
    k = k_cache[layer_idx][idx]  # (B, MB, H, bs, D)
    v = v_cache[layer_idx][idx]
    valid = (idx != GARBAGE_BLOCK)[:, :, None, None, None]
    k = torch.where(valid, k, torch.zeros((), dtype=k.dtype, device=k.device))
    v = torch.where(valid, v, torch.zeros((), dtype=v.dtype, device=v.device))
    k = k.permute(0, 1, 3, 2, 4).reshape(B, MB * bs, H, D)
    v = v.permute(0, 1, 3, 2, 4).reshape(B, MB * bs, H, D)
    return k, v


# ---------------------------------------------------------------------------
# Host-side allocator (plain Python, as in the reference)
# ---------------------------------------------------------------------------


@dataclass
class BlockAllocator:
    """Free-block pool + per-sequence block lists."""

    num_blocks: int
    block_size: int
    free: List[int] = field(default_factory=list)
    seq_blocks: Dict[int, List[int]] = field(default_factory=dict)

    def __post_init__(self):
        # block 0 reserved as garbage
        self.free = list(range(1, self.num_blocks + 1))

    def alloc_seq(self, seq_id: int, num_tokens: int) -> List[int]:
        """Ensure seq has blocks covering num_tokens positions."""
        blocks = self.seq_blocks.setdefault(seq_id, [])
        needed = -(-num_tokens // self.block_size) - len(blocks)
        if needed > len(self.free):
            raise RuntimeError(f"out of KV blocks: need {needed}, free {len(self.free)}")
        for _ in range(max(0, needed)):
            blocks.append(self.free.pop(0))
        return blocks

    def free_seq(self, seq_id: int):
        self.free.extend(self.seq_blocks.pop(seq_id, []))

    def quarantine_seq(self, seq_id: int) -> List[int]:
        """Poisoned release: free this sequence's blocks and return the ids
        the caller must zero-scrub before reuse (all of them: plain-allocator
        blocks are exclusively owned)."""
        blocks = self.seq_blocks.pop(seq_id, [])
        self.free.extend(blocks)
        return blocks

    def slot_mapping(self, seq_id: int, positions: np.ndarray) -> np.ndarray:
        """Logical positions -> global flat slots for this sequence."""
        blocks = self.seq_blocks[seq_id]
        block_ids = np.asarray([blocks[p // self.block_size] for p in positions])
        return block_ids * self.block_size + (np.asarray(positions) % self.block_size)

    def block_table(self, seq_id: int, max_blocks: int) -> np.ndarray:
        blocks = self.seq_blocks.get(seq_id, [])
        table = np.zeros(max_blocks, np.int32)
        n = min(len(blocks), max_blocks)
        table[:n] = blocks[:n]
        return table


@dataclass
class PrefixCachingAllocator(BlockAllocator):
    """Content-addressed block reuse (prefix caching).

    FULL blocks are keyed by a running sha1 over the token prefix, so a
    block matches only when its content AND everything before it match.
    Live blocks carry a refcount (one per attached sequence); freeing a
    sequence moves refcount-0 registered blocks to an LRU evictable pool —
    still matchable — and unregistered (partial-tail) blocks back to the
    free list. Allocation evicts LRU blocks when the free list runs dry."""

    hash_of_block: Dict[int, bytes] = field(default_factory=dict)
    block_by_hash: Dict[bytes, int] = field(default_factory=dict)
    refcount: Dict[int, int] = field(default_factory=dict)
    evictable: "OrderedDict[int, None]" = field(default_factory=OrderedDict)

    def _chain_keys(self, tokens: np.ndarray) -> List[bytes]:
        return prefix_chain_keys(tokens, self.block_size)

    def alloc_seq(self, seq_id: int, num_tokens: int) -> List[int]:
        blocks = self.seq_blocks.setdefault(seq_id, [])
        needed = -(-num_tokens // self.block_size) - len(blocks)
        while needed > len(self.free) and self.evictable:
            victim, _ = self.evictable.popitem(last=False)  # LRU
            key = self.hash_of_block.pop(victim, None)
            if key is not None:
                self.block_by_hash.pop(key, None)
            self.refcount.pop(victim, None)
            self.free.append(victim)
        if needed > len(self.free):
            raise RuntimeError(f"out of KV blocks: need {needed}, free {len(self.free)}")
        for _ in range(max(0, needed)):
            blocks.append(self.free.pop(0))
        return blocks

    def match_prefix(self, seq_id: int, tokens: np.ndarray) -> int:
        """Attach the longest cached block-chain prefix of ``tokens`` to
        ``seq_id``. Returns the number of cached TOKENS (a multiple of the
        block size, capped so at least one token is left to produce the
        next-token logits)."""
        if self.seq_blocks.get(seq_id):
            raise ValueError(f"match_prefix: sequence {seq_id} already holds blocks")
        matched: List[int] = []
        for key in self._chain_keys(tokens):
            b = self.block_by_hash.get(key)
            if b is None:
                break
            matched.append(b)
        while matched and len(matched) * self.block_size >= len(tokens):
            matched.pop()
        for b in matched:
            self.refcount[b] = self.refcount.get(b, 0) + 1
            self.evictable.pop(b, None)
        self.seq_blocks[seq_id] = list(matched)
        return len(matched) * self.block_size

    def match_index_blocks(self, tokens: np.ndarray) -> int:
        """How many leading FULL blocks of ``tokens`` the pool holds (live or
        evictable); read-only."""
        return self.match_keys(self._chain_keys(tokens))

    def match_keys(self, keys: List[bytes]) -> int:
        matched = 0
        for key in keys:
            if key not in self.block_by_hash:
                break
            matched += 1
        return matched

    def commit_seq(self, seq_id: int, tokens: np.ndarray):
        """Register this sequence's full prompt blocks for future matching
        (idempotent; call once the prompt KV is fully written)."""
        blocks = self.seq_blocks.get(seq_id, [])
        for i, key in enumerate(self._chain_keys(tokens)):
            if i >= len(blocks):
                break
            b = blocks[i]
            if self.hash_of_block.get(b) == key:
                continue  # already registered (e.g. matched prefix)
            if key in self.block_by_hash:
                continue  # identical content already cached under another block
            if b in self.hash_of_block:
                continue  # block already carries different content
            self.hash_of_block[b] = key
            self.block_by_hash[key] = b
            self.refcount[b] = self.refcount.get(b, 0) + 1

    def free_seq(self, seq_id: int):
        for b in self.seq_blocks.pop(seq_id, []):
            if b in self.hash_of_block:
                self.refcount[b] -= 1
                if self.refcount[b] <= 0:
                    self.evictable[b] = None  # matchable until evicted
            else:
                self.free.append(b)

    def quarantine_seq(self, seq_id: int) -> List[int]:
        """Poisoned release: blocks another live sequence still references
        stay registered and untouched (their content is a healthy prefill's);
        every other block leaves the prefix index, is freed, and is returned
        for the caller to zero-scrub."""
        scrub: List[int] = []
        for b in self.seq_blocks.pop(seq_id, []):
            if b in self.hash_of_block:
                self.refcount[b] -= 1
                if self.refcount[b] > 0:
                    continue  # a live sharer still attends this block
                key = self.hash_of_block.pop(b)
                self.block_by_hash.pop(key, None)
                self.refcount.pop(b, None)
                self.evictable.pop(b, None)
            self.free.append(b)
            scrub.append(b)
        return scrub
