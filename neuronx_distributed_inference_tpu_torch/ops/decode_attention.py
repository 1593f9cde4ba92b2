"""Decode (token-generation) attention: kernel B1 over the contiguous cache
and kernel B4 over the paged cache (counterparts of the reference's
``ops/decode_attention.py::tkg_decode_attention`` and
``::paged_tkg_decode_attention``). Both are one CUDA C++ kernel template in
``csrc/decode_attention.cu``, in two address modes.

B1 reads the FULL stacked cache ``(L, R, S_max, Hkv, D)`` at
``layer_idx`` (batch row b reads cache line b) and never materializes a
bucket slice or a ``repeat_kv`` copy. Its kv axis is split over blocks
(flash-decoding): each (kv head, batch row, split) block runs the online
softmax for its ``n_rep * K`` query rows (K <= 16), grouped rep-major as the
reference's ``_prep_q`` groups them, in row chunks of at most
:data:`MAX_ROWS` (a block each), over its split's live tiles (tiles
whose mask is all false are skipped), and a second launch from the same
call combines the splits in split order and folds a learned sink into the
denominator once (the reference's ``_finalize``). :func:`decode_kv_split`
picks the split from the shapes and the card's SM count alone, so a call
reads nothing of the device back to the host.

B4 is the same kernel in its paged address mode: it reads the head-major
paged cache ``(L, NB+1, Hkv, bs, D)`` at ``layer_idx`` through the
``(B, MB)`` block table (each 16-byte chunk of a staged tile through its
block's entry), splits the table's ``MB * bs`` positions by the same rule,
and reads the garbage block 0 (and any id outside ``[1, NB]``) as zeros
without loading it (the reference's read scrub).

Both take the split's fp32 partials from one scratch buffer per device and
stream (``_cuda.scratch``), so a call allocates only its output.

:func:`tkg_decode_attention` and :func:`paged_tkg_decode_attention` launch
the kernel for CUDA tensors and run their plain versions only for tensors
on the CPU.

Both take ``QuantizedKV`` streams (an int8/fp8 cache) as the reference's
do, in the kernel's code mode: the kernel reads the 1-byte code tiles and
converts them in registers, and reads the layer's running scales itself:
each kv head's K factor ``scale / qmax`` multiplies its score scale (the
reference folds it into q) and its V factor the finalized output, before
the one rounding to q's dtype. A call stays one launch (and the combine).
Code-mode launches count under :data:`CODE_KERNEL` and
:data:`PAGED_CODE_KERNEL`. The plain versions dequantize after the slice
or gather (``read_cache_at_layer`` / ``read_block_cache_at_layer``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from neuronx_distributed_inference_tpu_torch.modules.kvcache import QuantizedKV, kv_qmax
from neuronx_distributed_inference_tpu_torch.ops import _cuda
from neuronx_distributed_inference_tpu_torch.ops.kernel_mode import launches_kernel

KERNEL = "decode_attention"
PAGED_KERNEL = "paged_decode_attention"
CODE_KERNEL = "decode_attention_codes"  # B1 over an int8/fp8 cache
VERIFY_KERNEL = "decode_attention_verify"  # B1 with K > 1 queries a row over a plain cache
PAGED_CODE_KERNEL = "paged_decode_attention_codes"  # B4 over int8/fp8 code blocks
HEAD_DIMS = (64, 128)
BLOCK_SIZES = (16, 32)  # B4: cache block sizes
MAX_ROWS = 64  # n_rep * K query rows one block holds; more take row chunks
MAX_Q_LEN = 16  # queries a batch row (the reference's use_tkg gate)
MAX_KV_SPLITS = 32  # kv splits per (batch row, kv head)
SPLIT_ALIGN = 16  # positions per split are a multiple of this
KV_TILE = 64  # positions per staged tile
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the 1-byte KV code types (csrc/common.cuh DType)
CODE_DTYPES = {torch.int8: 2, torch.float8_e4m3fn: 3, torch.float8_e5m2: 4}


def decode_kv_split(S_kv: int, blocks: int, sms: int):
    """(splits, positions per split) of B1's and B4's kv axis for
    ``blocks`` (batch row, kv head) pairs over a mask ``S_kv`` wide on a
    card of ``sms`` SMs: enough splits for at least one block per SM, each
    a multiple of SPLIT_ALIGN positions and at most one KV_TILE where that
    leaves at most MAX_KV_SPLITS; one split once the pairs alone fill the
    card. Split z
    covers positions [z * per, (z + 1) * per) of [0, S_kv). A function of
    the shapes only, so the summation order (and the result) repeats from
    call to call."""
    want = -(-sms // max(blocks, 1))
    if want <= 1:
        return 1, _round_up(S_kv, SPLIT_ALIGN)
    per = max(
        SPLIT_ALIGN,
        min(S_kv // want // SPLIT_ALIGN * SPLIT_ALIGN, KV_TILE),  # >= `want` splits, one tile each
        _round_up(-(-S_kv // MAX_KV_SPLITS), SPLIT_ALIGN),  # at most MAX_KV_SPLITS
    )
    return -(-S_kv // per), per


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _code_streams(name: str, k_cache, v_cache):
    """(k data, v data, quantized) of a call's caches; both streams must be
    QuantizedKV of one code dtype, or both plain tensors."""
    qk, qv = isinstance(k_cache, QuantizedKV), isinstance(v_cache, QuantizedKV)
    if qk != qv:
        raise ValueError(f"{name}: one QuantizedKV stream and one plain cache")
    if not qk:
        return k_cache, v_cache, False
    if k_cache.dtype != v_cache.dtype or k_cache.dtype not in CODE_DTYPES:
        raise ValueError(f"{name}: code dtypes {k_cache.dtype}/{v_cache.dtype} (int8 or fp8, both equal)")
    return k_cache.data, v_cache.data, True


def tkg_decode_attention_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    layer_idx: int,
    mask: torch.Tensor,
    sink: Optional[torch.Tensor] = None,
    *,
    scale: float,
    n_kv: int,
) -> torch.Tensor:
    """Plain version: the bucket slice of the reference's native decode path
    (``read_cache_at_layer``, which dequantizes a QuantizedKV cache to
    fp32), ``repeat_kv`` and the masked softmax."""
    from neuronx_distributed_inference_tpu_torch.modules.attention import (
        AttnSpec,
        attention_decode,
    )
    from neuronx_distributed_inference_tpu_torch.modules.kvcache import read_cache_at_layer

    B, K, Hq, D = q.shape
    spec = AttnSpec(num_heads=Hq, num_kv_heads=n_kv, head_dim=D, scale=scale)
    k_r, v_r = read_cache_at_layer(k_cache, v_cache, layer_idx, B, mask.shape[-1])
    return attention_decode(q, k_r, v_r, mask, spec, sink)


def row_chunks(n_rep: int, q_len: int) -> int:
    """Blocks a kv head's ``n_rep * q_len`` query rows take (MAX_ROWS each)."""
    return -(-n_rep * q_len // MAX_ROWS)


def _check_shared(name, q, k_cache, v_cache, n_kv, Hkv, layer_idx, mask, sink, codes=False):
    """The checks B1 and B4 share: the caches' last dim is D, at most
    MAX_Q_LEN queries a row, the layer exists, head_dim, dtypes (the caches'
    equal to q's, or ``codes``) and the sink."""
    B, K, Hq, D = q.shape
    L = k_cache.shape[0]
    if v_cache.shape != k_cache.shape or k_cache.shape[-1] != D or Hkv != n_kv:
        raise ValueError(
            f"{name}: q {tuple(q.shape)}, caches {tuple(k_cache.shape)}/{tuple(v_cache.shape)}, n_kv {n_kv}"
        )
    if Hq % Hkv or K > MAX_Q_LEN:
        raise ValueError(f"{name}: {K} query rows a batch row (max {MAX_Q_LEN}), {Hq} q heads over {Hkv} kv heads")
    if mask.dim() != 4 or mask.shape[:3] != (B, 1, K) or mask.dtype != torch.bool:
        raise ValueError(f"{name}: mask {tuple(mask.shape)} {mask.dtype} != bool {(B, 1, K, '*')}")
    if not 0 <= int(layer_idx) < L:
        raise ValueError(f"{name}: layer {layer_idx} outside the cache's {L} layers")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {D} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES or (not codes and (k_cache.dtype != q.dtype or v_cache.dtype != q.dtype)):
        raise ValueError(f"{name}: dtypes {q.dtype}/{k_cache.dtype}/{v_cache.dtype} (bf16 or fp32, all equal)")
    if sink is not None and tuple(sink.shape) != (Hq,):
        raise ValueError(f"{name}: sink {tuple(sink.shape)} != {(Hq,)}")


def _check(q, k_cache, v_cache, layer_idx, mask, sink, n_kv, codes):
    L, R, S_max, Hkv, _ = k_cache.shape
    _check_shared("tkg_decode_attention", q, k_cache, v_cache, n_kv, Hkv, layer_idx, mask, sink, codes)
    if mask.shape[-1] > S_max or q.shape[0] > R:
        raise ValueError(
            f"tkg_decode_attention: bucket {mask.shape[-1]} / batch {q.shape[0]} outside the cache "
            f"{tuple(k_cache.shape)}"
        )


def _launch_inputs(name, q, k_cache, v_cache, mask, sink):
    """What both kernels need of their inputs beyond the shapes (contiguous
    q and caches at 16-byte aligned bases, a unit position stride in the
    mask), and the fp32 sink and the output they are handed."""
    for arg, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not x.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} needs a 16-byte aligned base")
    if mask.stride(3) != 1:
        raise ValueError(f"{name}: mask needs a unit position stride, got {mask.stride()}")
    sink_f = sink.float().contiguous() if sink is not None else None
    return sink_f, torch.empty_like(q)


@functools.lru_cache(maxsize=None)
def _split_plan(S_kv: int, blocks: int, device: int):
    """decode_kv_split of a launch, once per shape and device."""
    return decode_kv_split(S_kv, blocks, _cuda.sm_count(torch.device("cuda", device)))


def _split_parts(q, S_kv, Hkv, stream):
    """The kv split of a call and the three fp32 partial arrays the kernel
    combines, (m, l, acc) per split and (row, q head), as pointers into the
    stream's scratch; None for one split. The split counts a group's row
    chunks as blocks."""
    B, K, Hq, D = q.shape
    splits, per = _split_plan(S_kv, B * Hkv * row_chunks(Hq // Hkv, K), q.device.index)
    if splits == 1:
        return splits, per, [None] * 3
    n = splits * B * K * Hq
    base = _cuda.scratch(n * (D + 2), q.device, stream).data_ptr()
    return splits, per, [base, base + 4 * n, base + 8 * n]


def scale_args(name, k_scale, v_scale, qmax):
    """The C entries' code-mode arguments: the K and V scales' device
    pointers (contiguous fp32, read by the kernel at launch) and the qmax
    that divides them into factors; (null, null, 0) for a plain cache."""
    if k_scale is None:
        return [None, None, 0.0]
    for x in (k_scale, v_scale):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name}: scales must be contiguous fp32, got {x.dtype} {tuple(x.shape)}")
    if not qmax > 0:
        raise ValueError(f"{name}: qmax {qmax} must be positive")
    return [k_scale.data_ptr(), v_scale.data_ptr(), float(qmax)]


def _code_args(name, streams, Hkv):
    """The C entry's code-mode arguments: the K and V streams' (L, Hkv)
    fp32 running scales and the code type's qmax (none for a plain cache)."""
    if streams is None:
        return [None, None, 0.0]
    k, v = streams
    for x in (k.scale, v.scale):
        if tuple(x.shape) != (k.shape[0], Hkv):
            raise ValueError(f"{name}: scales {tuple(x.shape)} != {(k.shape[0], Hkv)}")
    return scale_args(name, k.scale, v.scale, kv_qmax(k.dtype))


def _launch(q, k_cache, v_cache, layer_idx, mask, sink, scale, n_kv, streams=None):
    """One launch over plain caches of q's dtype, or, with ``streams`` (the
    two QuantizedKV), over their 1-byte codes ``k_cache`` / ``v_cache``."""
    B, K, Hq, D = q.shape
    L, R, S_max, Hkv, _ = k_cache.shape
    S_kv = mask.shape[-1]
    sink_f, out = _launch_inputs("tkg_decode_attention", q, k_cache, v_cache, mask, sink)
    stream = _cuda.stream_ptr(q.device)
    splits, per, parts = _split_parts(q, S_kv, Hkv, stream)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _cuda.function(
        KERNEL, "nxdi_tkg_decode_attention",
        [P] * 9 + [I] * 14 + [ctypes.c_float, I, I, P, P, ctypes.c_float, P],
    )
    # the decode mask is usually a broadcast view (stride 0 over K): the
    # kernel reads it through its batch and token strides, without a copy
    err = fn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), mask.data_ptr(),
        sink_f.data_ptr() if sink_f is not None else None, out.data_ptr(), *parts,
        B, K, Hq, Hkv, D, L, R, S_max, S_kv, int(layer_idx),
        mask.stride(0), mask.stride(2), splits, per,
        float(scale), _DTYPE_CODES[q.dtype], dtype_code(k_cache.dtype),
        *_code_args("tkg_decode_attention", streams, Hkv),
        stream,
    )
    counter = CODE_KERNEL if streams is not None else VERIFY_KERNEL if K > 1 else KERNEL
    _cuda.check(err, counter)
    _cuda.count(counter)
    return out


def dtype_code(dtype: torch.dtype) -> int:
    """The C entries' code of a cache or q dtype (csrc/common.cuh DType)."""
    return CODE_DTYPES[dtype] if dtype in CODE_DTYPES else _DTYPE_CODES[dtype]


def tkg_decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    layer_idx: int,
    mask: torch.Tensor,
    sink: Optional[torch.Tensor] = None,
    *,
    scale: float,
    n_kv: int,
) -> torch.Tensor:
    """Decode attention straight off the stacked contiguous cache.

    q (B, K, Hq, D); k/v cache (L, R, S_max, Hkv, D), plain or QuantizedKV
    streams; mask (B, 1, K, S_kv) bool with S_kv <= S_max; sink (Hq,) or
    None. Returns (B, K, Hq, D) in q's dtype. CUDA tensors launch the kernel
    (its code mode for QuantizedKV) or raise on what it does not take; CPU
    tensors take the plain version."""
    k_t, v_t, codes = _code_streams("tkg_decode_attention", k_cache, v_cache)
    _check(q, k_t, v_t, layer_idx, mask, sink, n_kv, codes)
    tensors = [q, k_t, v_t, mask] + ([sink] if sink is not None else [])
    if not launches_kernel(*tensors):
        return tkg_decode_attention_plain(
            q, k_cache, v_cache, layer_idx, mask, sink, scale=scale, n_kv=n_kv
        )
    return _launch(q, k_t, v_t, layer_idx, mask, sink, scale, n_kv, (k_cache, v_cache) if codes else None)


# ---------------------------------------------------------------------------
# B4: paged decode attention
# ---------------------------------------------------------------------------


def paged_tkg_decode_attention_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    layer_idx: int,
    block_table: torch.Tensor,
    mask: torch.Tensor,
    sink: Optional[torch.Tensor] = None,
    *,
    scale: float,
    n_kv: int,
) -> torch.Tensor:
    """Plain version: the reference's native paged decode path — the
    block-table gather with the garbage-block scrub
    (``read_block_cache_at_layer``, which dequantizes code blocks to fp32),
    ``repeat_kv`` and the masked softmax."""
    from neuronx_distributed_inference_tpu_torch.modules.attention import (
        AttnSpec,
        attention_decode,
    )
    from neuronx_distributed_inference_tpu_torch.modules.block_kvcache import (
        read_block_cache_at_layer,
    )

    B, K, Hq, D = q.shape
    spec = AttnSpec(num_heads=Hq, num_kv_heads=n_kv, head_dim=D, scale=scale)
    k_r, v_r = read_block_cache_at_layer(k_cache, v_cache, layer_idx, block_table)
    return attention_decode(q, k_r, v_r, mask, spec, sink)


def _check_paged(q, k_cache, v_cache, layer_idx, block_table, mask, sink, n_kv, codes):
    name = "paged_tkg_decode_attention"
    B = q.shape[0]
    L, NB1, Hkv, bs, _ = k_cache.shape
    _check_shared(name, q, k_cache, v_cache, n_kv, Hkv, layer_idx, mask, sink, codes)
    if block_table.dim() != 2 or block_table.shape[0] != B or block_table.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{name}: block_table {tuple(block_table.shape)} {block_table.dtype} != int {(B, '*')}")
    width = block_table.shape[1] * bs
    if mask.shape[-1] != width:
        raise ValueError(f"{name}: mask width {mask.shape[-1]} != {width} (MB * block size)")


def _launch_paged(q, k_cache, v_cache, layer_idx, block_table, mask, sink, scale, n_kv, streams=None):
    B, K, Hq, D = q.shape
    L, NB1, Hkv, bs, _ = k_cache.shape
    if bs not in BLOCK_SIZES:
        raise ValueError(f"paged_tkg_decode_attention: block size {bs} not in {BLOCK_SIZES}")
    sink_f, out = _launch_inputs("paged_tkg_decode_attention", q, k_cache, v_cache, mask, sink)
    table = block_table.to(torch.int32).contiguous()
    MB = table.shape[1]
    stream = _cuda.stream_ptr(q.device)
    splits, per, parts = _split_parts(q, MB * bs, Hkv, stream)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _cuda.function(
        KERNEL, "nxdi_paged_decode_attention",
        [P] * 10 + [I] * 14 + [ctypes.c_float, I, I, P, P, ctypes.c_float, P],
    )
    err = fn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), mask.data_ptr(),
        sink_f.data_ptr() if sink_f is not None else None, table.data_ptr(), out.data_ptr(), *parts,
        B, K, Hq, Hkv, D, L, NB1, bs, MB, int(layer_idx),
        mask.stride(0), mask.stride(2), splits, per,
        float(scale), _DTYPE_CODES[q.dtype], dtype_code(k_cache.dtype),
        *_code_args("paged_tkg_decode_attention", streams, Hkv),
        stream,
    )
    counter = PAGED_KERNEL if streams is None else PAGED_CODE_KERNEL
    _cuda.check(err, counter)
    _cuda.count(counter)
    return out


def paged_tkg_decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    layer_idx: int,
    block_table: torch.Tensor,
    mask: torch.Tensor,
    sink: Optional[torch.Tensor] = None,
    *,
    scale: float,
    n_kv: int,
) -> torch.Tensor:
    """Decode attention straight off the paged cache through the block
    table (no gather copy).

    q (B, K, Hq, D); k/v cache (L, NB+1, Hkv, bs, D) head-major, plain or
    QuantizedKV streams; block_table (B, MB) int; mask (B, 1, K, MB * bs)
    bool; sink (Hq,) or None. Returns (B, K, Hq, D) in q's dtype. CUDA
    tensors launch the kernel (its code mode for QuantizedKV) or raise on
    what it does not take; CPU tensors take the plain version."""
    k_t, v_t, codes = _code_streams("paged_tkg_decode_attention", k_cache, v_cache)
    _check_paged(q, k_t, v_t, layer_idx, block_table, mask, sink, n_kv, codes)
    tensors = [q, k_t, v_t, block_table, mask] + ([sink] if sink is not None else [])
    if not launches_kernel(*tensors):
        return paged_tkg_decode_attention_plain(
            q, k_cache, v_cache, layer_idx, block_table, mask, sink, scale=scale, n_kv=n_kv
        )
    return _launch_paged(
        q, k_t, v_t, layer_idx, block_table, mask, sink, scale, n_kv, (k_cache, v_cache) if codes else None
    )
