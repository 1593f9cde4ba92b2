"""Paged flash attention for chunked and prefix prefill: kernel B5
(counterpart of the reference's ``ops/paged_flash_attention.py::
paged_flash_attention``).

Query token t of row b attends the row's paged cache at positions
``p <= positions[b, t]`` with ``p < kv_limit[b]``: the prior context plus
causal attention among the new tokens, whose K/V are already written
(write-then-attend). The CUDA C++ kernel (``csrc/paged_flash_attention.cu``)
reads the cache blocks through the block table, shares each K/V tile among
the n_rep q heads of a kv head, and stops its kv loop at the block's causal
frontier or ``kv_limit``. Its q tile is 64 query rows (64 / n_rep positions,
rounded down, of the n_rep heads of one kv head; where n_rep does not
divide 64, DBRX's 6, the last rows stay idle). In bf16 both products run on the tensor
cores, with K/V tiles copied by 16-byte ``cp.async`` (16-byte aligned
bases, which the wrapper checks) and the probabilities rounded to bf16 as
the P.V operand; fp32 keeps the FMA loop. The source says why.

:func:`paged_flash_attention` launches the kernel for CUDA tensors and runs
:func:`paged_flash_attention_plain` only for tensors on the CPU.

An int8/fp8 cache layer comes with the layer's per-head scales
``k_scale`` / ``v_scale`` ((Hkv,) fp32) and ``kv_qmax``: the dequant
factors are ``k_scale / kv_qmax`` (the reference's k_scale / v_scale):
pass the factors themselves with ``kv_qmax`` 1, or the layer's running
scales (views of the cache's (L, Hkv) scales) with the code type's qmax.
The kernel's code mode takes the caller's q (bf16: the tensor-core body
over code tiles; fp32: the FMA loop), reads the scales on the device and
converts the 1-byte codes itself: one launch, nothing folded or rescaled
around it. Launches count under :data:`CODE_KERNEL`. The plain version
takes the factors and dequantizes after the gather.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from neuronx_distributed_inference_tpu_torch.ops import _cuda
from neuronx_distributed_inference_tpu_torch.ops.decode_attention import CODE_DTYPES, dtype_code, scale_args
from neuronx_distributed_inference_tpu_torch.ops.kernel_mode import launches_kernel

NEG_INF = -1e30
KERNEL = "paged_flash_attention"
CODE_KERNEL = "paged_flash_attention_codes"  # over int8/fp8 code blocks
HEAD_DIMS = (64, 128)
Q_ROWS = 64  # query rows per kernel block: n_rep may be at most this
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def paged_flash_attention_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    block_table: torch.Tensor,
    positions: torch.Tensor,
    kv_limit: torch.Tensor,
    *,
    scale: float,
    n_rep: int,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version: gather the row's blocks (garbage block 0 read as
    zeros; code blocks then dequantized with ``k_scale`` / ``v_scale``),
    then a masked softmax with ``kv_pos <= q_pos & kv_pos < kv_limit``,
    computed as the kernel's finalize does (masked probabilities exactly 0,
    ``out = acc / max(l, 1e-30)``), so a row with no valid key is zeros.
    Returns (B, Sq, Hq, D) in q's dtype."""
    from neuronx_distributed_inference_tpu_torch.modules.attention import repeat_kv
    from neuronx_distributed_inference_tpu_torch.modules.block_kvcache import (
        read_block_cache_at_layer,
    )

    k_r, v_r = read_block_cache_at_layer(k_cache[None], v_cache[None], 0, block_table)
    if k_scale is not None:
        k_r = k_r.float() * k_scale.float()[:, None]
        v_r = v_r.float() * v_scale.float()[:, None]
    kf = repeat_kv(k_r, n_rep).float()
    vf = repeat_kv(v_r, n_rep).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    kv_pos = torch.arange(kf.shape[1], device=q.device)[None, None, None, :]
    q_pos = positions.to(torch.int64)[:, None, :, None]
    mask = (kv_pos <= q_pos) & (kv_pos < kv_limit.to(torch.int64)[:, None, None, None])
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p / torch.clamp(l, min=1e-30), vf)
    return out.to(q.dtype)


def _check(q, k_cache, v_cache, block_table, positions, kv_limit, n_rep, k_scale, v_scale):
    B, Sq, Hq, D = q.shape
    name = "paged_flash_attention"
    if k_cache.dim() != 4 or v_cache.shape != k_cache.shape or k_cache.shape[3] != D:
        raise ValueError(f"{name}: q {tuple(q.shape)} vs one layer's cache {tuple(k_cache.shape)}/{tuple(v_cache.shape)}")
    Hkv = k_cache.shape[1]
    if Hq != Hkv * n_rep:
        raise ValueError(f"{name}: {Hq} q heads != {Hkv} kv heads x n_rep {n_rep}")
    if block_table.dim() != 2 or block_table.shape[0] != B:
        raise ValueError(f"{name}: block_table {tuple(block_table.shape)} != {(B, '*')}")
    if tuple(positions.shape) != (B, Sq) or tuple(kv_limit.shape) != (B,):
        raise ValueError(f"{name}: positions {tuple(positions.shape)} / kv_limit {tuple(kv_limit.shape)} != {(B, Sq)} / {(B,)}")
    for t, nm in ((block_table, "block_table"), (positions, "positions"), (kv_limit, "kv_limit")):
        if t.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"{name}: {nm} must be an int tensor, got {t.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {D} not in {HEAD_DIMS}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{name}: k_scale and v_scale come together")
    if k_scale is not None:
        if k_cache.dtype not in CODE_DTYPES or v_cache.dtype != k_cache.dtype or q.dtype not in _DTYPE_CODES:
            raise ValueError(f"{name}: k_scale/v_scale need int8/fp8 code caches, got {k_cache.dtype}/{v_cache.dtype}")
        if tuple(k_scale.shape) != (Hkv,) or tuple(v_scale.shape) != (Hkv,):
            raise ValueError(f"{name}: k_scale/v_scale {tuple(k_scale.shape)}/{tuple(v_scale.shape)} != {(Hkv,)}")
    elif q.dtype not in _DTYPE_CODES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"{name}: dtypes {q.dtype}/{k_cache.dtype}/{v_cache.dtype} (bf16 or fp32, all equal)")


def _launch(q, k_cache, v_cache, block_table, positions, kv_limit, scale, n_rep, code_args=(None, None, 0.0)):
    """One launch over plain cache blocks of q's dtype, or, with the
    ``code_args`` of a code cache, over its 1-byte code blocks."""
    B, Sq, Hq, D = q.shape
    NB1, Hkv, bs, _ = k_cache.shape
    if n_rep > Q_ROWS:
        raise ValueError(f"paged_flash_attention: n_rep {n_rep} passes the kernel's {Q_ROWS} query rows")
    if q.shape[0] > 65535 or Hkv > 65535:
        raise ValueError(f"paged_flash_attention: grid too large for q {tuple(q.shape)}")
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not x.is_contiguous():
            raise ValueError(f"paged_flash_attention: {name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"paged_flash_attention: {name} must be 16-byte aligned (the kernel's 16-byte copies)")
    table = block_table.to(torch.int32).contiguous()
    pos = positions.to(torch.int32).contiguous()
    limit = kv_limit.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _cuda.function(KERNEL, "nxdi_paged_flash_attention", [P] * 7 + [I] * 8 + [F, I, I, P, P, F, P])
    err = fn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), table.data_ptr(),
        pos.data_ptr(), limit.data_ptr(), out.data_ptr(),
        B, Sq, Hq, Hkv, D, NB1, bs, table.shape[1],
        float(scale), _DTYPE_CODES[q.dtype], dtype_code(k_cache.dtype), *code_args,
        _cuda.stream_ptr(q.device),
    )
    counter = KERNEL if code_args[0] is None else CODE_KERNEL
    _cuda.check(err, counter)
    _cuda.count(counter)
    return out


def paged_flash_attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k_cache: torch.Tensor,  # (NB+1, Hkv, bs, D) one layer's head-major paged cache
    v_cache: torch.Tensor,
    block_table: torch.Tensor,  # (B, MB) int
    positions: torch.Tensor,  # (B, Sq) int query positions
    kv_limit: torch.Tensor,  # (B,) int valid cache length per row
    *,
    scale: float,
    n_rep: int,
    k_scale: Optional[torch.Tensor] = None,  # (Hkv,) fp32: K factors k_scale / kv_qmax
    v_scale: Optional[torch.Tensor] = None,  # for int8/fp8 code blocks; None = plain cache
    kv_qmax: float = 1.0,
) -> torch.Tensor:
    """Prefix/chunked-prefill attention straight off the paged cache.
    Returns (B, Sq, Hq, D) in q's dtype. CUDA tensors launch the kernel (its
    code mode with ``k_scale``/``v_scale``, one launch) or raise on what it
    does not take; CPU tensors take the plain version."""
    _check(q, k_cache, v_cache, block_table, positions, kv_limit, n_rep, k_scale, v_scale)
    scales = [k_scale, v_scale] if k_scale is not None else []
    if not launches_kernel(q, k_cache, v_cache, block_table, positions, kv_limit, *scales):
        if k_scale is not None and kv_qmax != 1.0:
            k_scale, v_scale = k_scale / kv_qmax, v_scale / kv_qmax
        return paged_flash_attention_plain(
            q, k_cache, v_cache, block_table, positions, kv_limit, scale=scale, n_rep=n_rep,
            k_scale=k_scale, v_scale=v_scale,
        )
    return _launch(q, k_cache, v_cache, block_table, positions, kv_limit, scale, n_rep,
                   scale_args(KERNEL, k_scale, v_scale, kv_qmax))
