"""Contiguous KV cache (counterpart of the reference's ``modules/kvcache.py``).

The cache is two stacked tensors ``k, v: (L, B+1, S_max, H_kv, D)``. Batch
row ``b`` owns cache line ``b``; the extra line ``B`` is the garbage line
that writes of invalid rows (seq_id -1, padded batch rows) land in, so they
never touch live state. Unlike the reference's donated JAX arrays, the port
updates the cache IN PLACE (``Tensor.__setitem__``).

An int8/fp8 ``kv_cache_dtype`` makes each stream a :class:`QuantizedKV`:
codes in the same layout plus an ``(L, H_kv)`` fp32 running absmax per
(layer, kv head). A write bumps the layer's scale by the valid new values
and quantizes them with the updated scale (:func:`_quantized_update`), so a
decode step never re-reads the cache to rescale; earlier codes keep
dequantizing as ``codes * scale / qmax`` with the grown scale. Codes AND
scales are updated in place: a captured CUDA graph holds both addresses.
Reads either dequantize after the slice (the plain paths) or hand the codes
and the scales to the attention kernels, which read the scales on the
device and convert the codes themselves (``ops/decode_attention.py``,
:func:`layer_streams`).

Ring caches (sliding-window attention) keep W slots a line: position p
lives in slot ``p mod W`` (:func:`ring_positions`), and a negative
(sentinel) position maps to slot W, out of range, so its write lands in the
garbage line like every other out-of-range write. A uniform stack rings
every layer in the plain :class:`KVCache` (``ModelSpec.bounded_window``);
an interleaved sliding/global stack (GPT-OSS) sizes the cache per layer,
:class:`InterleavedKVCache`: full-length lines for the global layers, rings
for the sliding ones.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch

GARBAGE_LINES = 1  # padding-zone lines for invalid seq_id writes

#: position of a padded token in a prefill window: its write drops into the
#: garbage line and every causal bound masks it
PAD_POSITION_SENTINEL = -(1 << 30)


_KV_QUANT_DTYPES = (torch.int8, torch.float8_e4m3fn, torch.float8_e5m2)


def is_kv_quant_dtype(dtype) -> bool:
    """True for cache storage dtypes that need codes + scales."""
    return dtype in _KV_QUANT_DTYPES


def kv_qmax(dtype) -> float:
    """Largest magnitude of the code dtype: codes span [-qmax, qmax] and
    dequantize as ``codes * scale / qmax`` (127, 448 or 57344)."""
    if dtype == torch.int8:
        return 127.0
    return float(torch.finfo(dtype).max)


@dataclass
class QuantizedKV:
    """One quantized cache stream: ``data`` holds int8/fp8 codes in the
    layout the plain cache would use; ``scale`` is the (L, H_kv) fp32
    running absmax per (layer, kv head) (x ~ codes * scale / qmax). Shape,
    dtype and device proxy to ``data``, so layout code works on either."""

    data: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def ndim(self) -> int:
        return self.data.ndim

    @property
    def device(self):
        return self.data.device


Stream = Union[torch.Tensor, QuantizedKV]


def quantize_kv_codes(x: torch.Tensor, scale: torch.Tensor, code_dtype) -> torch.Tensor:
    """Quantize ``x`` (..., H, D) with the per-head absmax ``scale`` (H,):
    symmetric, codes = clip(x * qmax / max(scale, 1e-8)), rounded half to
    even for int8 and by the fp8 cast for fp8."""
    qmax = kv_qmax(code_dtype)
    s = torch.clamp(scale.float(), min=1e-8)
    y = x.float() * (qmax / s)[..., :, None]
    if code_dtype == torch.int8:
        y = torch.round(y)
    return torch.clamp(y, -qmax, qmax).to(code_dtype)


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Codes (..., H, D) with the per-head absmax ``scale`` (H,) -> fp32."""
    factor = scale.float() / kv_qmax(codes.dtype)
    return codes.float() * factor[..., :, None]


def layer_dequant_factors(stream: QuantizedKV, layer_idx: int) -> torch.Tensor:
    """Per-head factors scale / qmax (H,) of one layer: what the reference
    folds into q (K stream) and the output (V stream)."""
    return stream.scale[layer_idx] / kv_qmax(stream.data.dtype)


def layer_streams(k_cache: Stream, v_cache: Stream, layer_idx: int):
    """One layer of both streams as the paged kernels take it: (k layer,
    v layer, code kwargs). A quantized cache's kwargs are ``k_scale`` /
    ``v_scale``, views of the layer's (H,) running scales that the kernels
    read on the device at launch (no op runs per layer), with ``kv_qmax``,
    the code type's qmax that divides them into factors; a plain cache's
    are empty."""
    if isinstance(k_cache, QuantizedKV):
        return (k_cache.data[layer_idx], v_cache.data[layer_idx],
                dict(k_scale=k_cache.scale[layer_idx], v_scale=v_cache.scale[layer_idx],
                     kv_qmax=kv_qmax(k_cache.data.dtype)))
    return k_cache[layer_idx], v_cache[layer_idx], {}


def _quantized_update(k_stream: QuantizedKV, v_stream: QuantizedKV, k_new: torch.Tensor, v_new: torch.Tensor,
                      layer_idx: int, valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Running-absmax scale update and quantization of one layer's K and V
    writes (the reference's ``_quantized_update`` on each stream).

    ``k_new`` / ``v_new`` (B, S, H, D) are the values about to be written;
    ``valid`` (B, S) marks the writes that may raise the scale. Padded and
    garbage writes and non-finite elements stay out of it: the scale is
    shared by every row of the (layer, head) and only grows, so one
    poisoned row's NaN would otherwise reach every row. Streams of one
    shape go through each step at once (stacked), which halves the step's
    kernels; streams of unequal widths (MLA's latent and rope keys) each on
    their own. Either way each keeps its own scale. ``scale[layer_idx]`` of
    each stream is updated IN PLACE; returns the K and V codes, quantized
    with the updated scales."""
    if k_new.shape == v_new.shape:
        x = torch.stack([k_new, v_new]).float()  # (2, B, S, H, D)
        # |x| over the valid, finite elements: masked and non-finite ones read 0
        kept = torch.nan_to_num(x * valid[None, :, :, None, None], nan=0.0, posinf=0.0, neginf=0.0)
        amax_new = torch.linalg.vector_norm(kept, ord=float("inf"), dim=(1, 2, 4))  # (2, H)
        s = torch.maximum(torch.stack([k_stream.scale[layer_idx], v_stream.scale[layer_idx]]), amax_new)
        codes = quantize_kv_codes(x, s[:, None, None], k_stream.data.dtype)
        k_stream.scale[layer_idx].copy_(s[0])
        v_stream.scale[layer_idx].copy_(s[1])
        return codes[0], codes[1]
    out = []
    for stream, new in ((k_stream, k_new), (v_stream, v_new)):
        x = new.float()
        kept = torch.nan_to_num(x * valid[:, :, None, None], nan=0.0, posinf=0.0, neginf=0.0)
        s = torch.maximum(stream.scale[layer_idx], torch.linalg.vector_norm(kept, ord=float("inf"), dim=(0, 1, 3)))
        out.append(quantize_kv_codes(x, s, stream.data.dtype))
        stream.scale[layer_idx].copy_(s)
    return out[0], out[1]


def cache_streams(cache) -> tuple:
    """Every stream of a cache: (k, v), or an interleaved cache's full and
    ring stacks."""
    if isinstance(cache, InterleavedKVCache):
        return (cache.k_full, cache.v_full, cache.k_ring, cache.v_ring)
    return (cache.k, cache.v)


def cache_nbytes(cache) -> int:
    """Bytes of a cache's streams, codes plus scales for a quantized one
    (both stacks of an interleaved cache)."""
    total = 0
    for stream in cache_streams(cache):
        for t in (stream.data, stream.scale) if isinstance(stream, QuantizedKV) else (stream,):
            total += t.numel() * t.element_size()
    return int(total)


def zero_stream(stream: Stream) -> None:
    """Zero a stream in place (codes and scales of a quantized one)."""
    if isinstance(stream, QuantizedKV):
        stream.data.zero_()
        stream.scale.zero_()
    else:
        stream.zero_()


def stream_ptrs(stream: Stream) -> tuple:
    """The device addresses a stream lives at (a graph's binding)."""
    if isinstance(stream, QuantizedKV):
        return (stream.data.data_ptr(), stream.scale.data_ptr())
    return (stream.data_ptr(),)


def new_stream(shape, dtype, device, num_layers: int, num_heads: int) -> Stream:
    """A zeroed stream: a QuantizedKV of codes and (L, H) fp32 scales for a
    quantized dtype, else a plain tensor."""
    if is_kv_quant_dtype(dtype):
        return QuantizedKV(
            data=torch.zeros(shape, dtype=dtype, device=device),
            scale=torch.zeros((num_layers, num_heads), dtype=torch.float32, device=device),
        )
    return torch.zeros(shape, dtype=dtype, device=device)


@dataclass
class KVCache:
    """Stacked per-layer KV buffers, k/v: (L, B+1, S_max, H_kv, D) tensors
    or :class:`QuantizedKV` streams of that layout."""

    k: Stream
    v: Stream


@dataclass
class InterleavedKVCache:
    """Per-layer-sized cache of an interleaved sliding/global stack
    (GPT-OSS; the reference's ``InterleavedKVCache``): the global layers
    keep full-length lines, the sliding layers rings of W slots, so the
    cache holds the sum of the per-layer sizes.

    k_full/v_full: (L_global, B+1, S_max, H_kv, D)
    k_ring/v_ring: (L_sliding, B+1, W, H_kv, D)

    It has no ``k`` / ``v``: whole-cache operations go through
    :func:`cache_streams`, shape probes through :func:`kv_batch_size`.
    """

    k_full: torch.Tensor
    v_full: torch.Tensor
    k_ring: torch.Tensor
    v_ring: torch.Tensor


def init_interleaved_cache(
    num_global_layers: int,
    num_sliding_layers: int,
    batch_size: int,
    max_len: int,
    window: int,
    num_kv_heads: int,
    head_dim: int,
    dtype=torch.bfloat16,
    *,
    device,
) -> InterleavedKVCache:
    """Zeroed full and ring stacks on ``device``."""
    rows = batch_size + GARBAGE_LINES
    full = (num_global_layers, rows, max_len, num_kv_heads, head_dim)
    ring = (num_sliding_layers, rows, window, num_kv_heads, head_dim)
    return InterleavedKVCache(
        k_full=torch.zeros(full, dtype=dtype, device=device),
        v_full=torch.zeros(full, dtype=dtype, device=device),
        k_ring=torch.zeros(ring, dtype=dtype, device=device),
        v_ring=torch.zeros(ring, dtype=dtype, device=device),
    )


def ring_positions(positions: torch.Tensor, window: int) -> torch.Tensor:
    """Ring slots of positions: ``p mod W``, and W (out of range: the write
    goes to the garbage line) for a negative sentinel position."""
    return torch.where(positions >= 0, positions % window, torch.full_like(positions, window))


def kv_batch_size(cache) -> int:
    """Real (non-garbage) cache lines (every stream of a cache has them)."""
    return cache_streams(cache)[0].shape[1] - GARBAGE_LINES


def init_cache(
    num_layers: int,
    batch_size: int,
    max_len: int,
    num_kv_heads: int,
    head_dim: int,
    dtype=torch.bfloat16,
    *,
    device,
    v_heads: Optional[int] = None,
    v_head_dim: Optional[int] = None,
) -> KVCache:
    """Zeroed stacked caches on ``device`` (no default: the caller names the
    card or the CPU); a quantized ``dtype`` builds QuantizedKV streams with
    zero scales. ``v_heads`` / ``v_head_dim`` size the V stream apart from
    K: DeepSeek-V3's MLA caches its latent (one head of kv_lora_rank) in K
    and its rope keys (one head of qk_rope_head_dim) in V."""
    rows = batch_size + GARBAGE_LINES
    k_shape = (num_layers, rows, max_len, num_kv_heads, head_dim)
    v_shape = (num_layers, rows, max_len, v_heads or num_kv_heads, v_head_dim or head_dim)
    return KVCache(
        k=new_stream(k_shape, dtype, device, num_layers, k_shape[3]),
        v=new_stream(v_shape, dtype, device, num_layers, v_shape[3]),
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

    QuantizedKV streams quantize in this write: the scale's valid mask is
    taken from the ORIGINAL positions and slots (in range, not the garbage
    line), before the redirect, so padded writes never raise the scale.
    """
    garbage = k_cache.shape[1] - 1
    s_max = k_cache.shape[2]
    ok = (positions >= 0) & (positions < s_max)
    rows = torch.where(ok, slot_ids[:, None].expand_as(positions), garbage)
    pos = torch.where(ok, positions, 0)
    if isinstance(k_cache, QuantizedKV):
        valid = ok & (slot_ids != garbage)[:, None]
        k_codes, v_codes = _quantized_update(k_cache, v_cache, k_new, v_new, layer_idx, valid)
        k_cache.data[layer_idx, rows, pos] = k_codes
        v_cache.data[layer_idx, rows, pos] = v_codes
        return k_cache, v_cache
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
    """One layer's cache sliced to (batch, bucket): views, no copy. A
    quantized cache dequantizes after the slice, to fp32."""
    if isinstance(k_cache, QuantizedKV):
        k_r, v_r = read_cache_at_layer(k_cache.data, v_cache.data, layer_idx, batch_size, bucket_len)
        return (
            dequantize_kv(k_r, k_cache.scale[layer_idx]),
            dequantize_kv(v_r, v_cache.scale[layer_idx]),
        )
    return (
        k_cache[layer_idx, :batch_size, :bucket_len],
        v_cache[layer_idx, :batch_size, :bucket_len],
    )
