"""Decode (token-generation) attention over the contiguous cache: kernel B1
(counterpart of the reference's ``ops/decode_attention.py::
tkg_decode_attention``).

The CUDA C++ kernel (``csrc/decode_attention.cu``) reads the FULL stacked
cache ``(L, R, S_max, Hkv, D)`` at ``layer_idx`` (batch row b reads cache
line b) and never materializes a bucket slice or a ``repeat_kv`` copy. Each
(batch row, kv head) block runs the online softmax for its ``n_rep * K``
query rows, grouped rep-major as the reference's ``_prep_q`` groups them,
over kv tiles; tiles whose mask is all false are skipped, and a learned sink
joins the denominator at finalize (the reference's ``_finalize``).

:func:`tkg_decode_attention` launches the kernel for CUDA tensors and runs
:func:`tkg_decode_attention_plain` only for tensors on the CPU. The
reference's int8/fp8 ``QuantizedKV`` mode is not ported yet (ROADMAP A6).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from neuronx_distributed_inference_tpu_torch.ops import _cuda
from neuronx_distributed_inference_tpu_torch.ops.kernel_mode import launches_kernel

KERNEL = "decode_attention"
HEAD_DIMS = (64, 128)
MAX_ROWS = 64  # n_rep * K query rows one block holds
MAX_Q_LEN = 16
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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
    (``read_cache_at_layer``), ``repeat_kv`` and the masked softmax."""
    from neuronx_distributed_inference_tpu_torch.modules.attention import (
        AttnSpec,
        attention_decode,
    )
    from neuronx_distributed_inference_tpu_torch.modules.kvcache import read_cache_at_layer

    B, K, Hq, D = q.shape
    spec = AttnSpec(num_heads=Hq, num_kv_heads=n_kv, head_dim=D, scale=scale)
    k_r, v_r = read_cache_at_layer(k_cache, v_cache, layer_idx, B, mask.shape[-1])
    return attention_decode(q, k_r, v_r, mask, spec, sink)


def _check(q, k_cache, v_cache, layer_idx, mask, sink, n_kv):
    B, K, Hq, D = q.shape
    L, R, S_max, Hkv, Dc = k_cache.shape
    if v_cache.shape != k_cache.shape or Dc != D or Hkv != n_kv:
        raise ValueError(
            f"tkg_decode_attention: q {tuple(q.shape)}, caches {tuple(k_cache.shape)}/"
            f"{tuple(v_cache.shape)}, n_kv {n_kv}"
        )
    if Hq % Hkv or (Hq // Hkv) * K > MAX_ROWS or K > MAX_Q_LEN:
        raise ValueError(
            f"tkg_decode_attention: n_rep*K = {(Hq // max(Hkv, 1)) * K} rows (max {MAX_ROWS}), "
            f"K = {K} (max {MAX_Q_LEN})"
        )
    if mask.dim() != 4 or mask.shape[:3] != (B, 1, K) or mask.dtype != torch.bool:
        raise ValueError(f"tkg_decode_attention: mask {tuple(mask.shape)} {mask.dtype} != bool {(B, 1, K, '*')}")
    if mask.shape[-1] > S_max or B > R or not 0 <= int(layer_idx) < L:
        raise ValueError(
            f"tkg_decode_attention: bucket {mask.shape[-1]} / batch {B} / layer {layer_idx} "
            f"outside the cache {tuple(k_cache.shape)}"
        )
    if D not in HEAD_DIMS:
        raise ValueError(f"tkg_decode_attention: head_dim {D} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(
            f"tkg_decode_attention: dtypes {q.dtype}/{k_cache.dtype}/{v_cache.dtype} (bf16 or fp32, all equal)"
        )
    if sink is not None and tuple(sink.shape) != (Hq,):
        raise ValueError(f"tkg_decode_attention: sink {tuple(sink.shape)} != {(Hq,)}")


def _launch(q, k_cache, v_cache, layer_idx, mask, sink, scale, n_kv):
    B, K, Hq, D = q.shape
    L, R, S_max, Hkv, _ = k_cache.shape
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not x.is_contiguous():
            raise ValueError(f"tkg_decode_attention: {name} must be contiguous")
    if mask.stride(3) != 1:
        raise ValueError(f"tkg_decode_attention: mask needs a unit position stride, got {mask.stride()}")
    sink_f = sink.float().contiguous() if sink is not None else None
    out = torch.empty_like(q)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _cuda.function(
        KERNEL, "nxdi_tkg_decode_attention",
        [P, P, P, P, P, P] + [I] * 12 + [ctypes.c_float, I, P],
    )
    # the decode mask is usually a broadcast view (stride 0 over K): the
    # kernel reads it through its batch and token strides, without a copy
    err = fn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), mask.data_ptr(),
        sink_f.data_ptr() if sink_f is not None else None, out.data_ptr(),
        B, K, Hq, Hkv, D, L, R, S_max, mask.shape[-1], int(layer_idx),
        mask.stride(0), mask.stride(2),
        float(scale), _DTYPE_CODES[q.dtype],
        _cuda.stream_ptr(q.device),
    )
    _cuda.check(err, KERNEL)
    _cuda.LAUNCHES[KERNEL] += 1
    return out


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

    q (B, K, Hq, D); k/v cache (L, R, S_max, Hkv, D); mask (B, 1, K, S_kv)
    bool with S_kv <= S_max; sink (Hq,) or None. Returns (B, K, Hq, D).
    CUDA tensors launch the kernel (or raise on what it does not take); CPU
    tensors take the plain version."""
    _check(q, k_cache, v_cache, layer_idx, mask, sink, n_kv)
    tensors = [q, k_cache, v_cache, mask] + ([sink] if sink is not None else [])
    if not launches_kernel(*tensors):
        return tkg_decode_attention_plain(
            q, k_cache, v_cache, layer_idx, mask, sink, scale=scale, n_kv=n_kv
        )
    return _launch(q, k_cache, v_cache, layer_idx, mask, sink, scale, n_kv)
