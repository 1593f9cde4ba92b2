"""Prefill flash attention: kernel B2 (counterpart of the reference's
``ops/flash_attention.py``).

One CUDA C++ kernel (``csrc/flash_attention.cu``) replaces both TPU kernels
of the reference, ``_flash_kernel`` and the head-pair packed
``_flash_kernel_packed``: the packing is a 128-lane TPU trick, and on Hopper
the D=64 case is simply the D=64 instance of the same kernel. It computes
what they compute: the causal/window/chunk + ``key_valid`` mask predicate
(``_tile_mask``), the dead-tile skip (``_tile_live``), ``NEG_INF = -1e30``
fills, masked probabilities zeroed, ``denom = max(l, 1e-30)``, and the per
row softmax stats ``(m, l)`` that :func:`flash_attention` folds learned
sinks in with. ``softmax_bf16`` reproduces the packed kernel's bf16 mode
(exp input, probabilities and the PV operand rounded to bf16; stats and
accumulator stay fp32).

In bf16 the kernel runs both products on the tensor cores and rounds the
probabilities to bf16 for the P.V product (l sums them in fp32 first), as
the TPU's MXU does at default precision; fp32 keeps fp32 FMAs throughout.
Its bf16 instance stages q/k/v tiles with 16-byte asynchronous copies, so
the wrapper takes, in either dtype, only 16-byte aligned bases and token
and batch strides that are multiples of 8 elements (:func:`_check_launch`);
the fused QKV projection's split views of every model the port runs meet
that.

:func:`flash_attention_fwd` launches the kernel for CUDA tensors and runs
:func:`flash_attention_plain` only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from neuronx_distributed_inference_tpu_torch.ops import _cuda
from neuronx_distributed_inference_tpu_torch.ops.kernel_mode import launches_kernel

NEG_INF = -1e30
KERNEL = "flash_attention"
HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def prefill_mask(
    key_valid: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    chunk: Optional[int] = None,
) -> torch.Tensor:
    """(B, S) key validity -> (B, 1, S, S) bool mask: the kernel's
    ``_tile_mask`` predicate over the whole sequence."""
    B, S = key_valid.shape
    rows = torch.arange(S, device=key_valid.device)[:, None]
    cols = torch.arange(S, device=key_valid.device)[None, :]
    mask = (key_valid > 0)[:, None, None, :].expand(B, 1, S, S)
    if causal:
        mask = mask & (cols <= rows)
    if window is not None:
        mask = mask & (cols > rows - window)
    if chunk is not None:
        mask = mask & ((cols // chunk) == (rows // chunk))
    return mask


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_valid: torch.Tensor,
    *,
    scale: float,
    causal: bool = True,
    window: Optional[int] = None,
    chunk: Optional[int] = None,
    softmax_bf16: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, one softmax over the whole row.

    q (B, S, Hq, D); k/v (B, S, Hkv, D) with Hq a multiple of Hkv (repeated
    here); key_valid (B, S). Returns (out (B, S, Hq, D) in q's dtype,
    m (B, Hq, S) fp32 row max, l (B, Hq, S) fp32 row denominator)."""
    from neuronx_distributed_inference_tpu_torch.modules.attention import repeat_kv

    n_rep = q.shape[2] // k.shape[2]
    kf = repeat_kv(k, n_rep).float()
    vf = repeat_kv(v, n_rep).float()
    if softmax_bf16:
        vf = _round_bf16(vf)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    mask = prefill_mask(key_valid, causal, window, chunk)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    t = s - m[..., None]
    if softmax_bf16:
        t = _round_bf16(t)
    p = torch.exp(t)
    if softmax_bf16:
        p = _round_bf16(p)
    p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    out = out / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype), m, l


def _check(q, k, v, key_valid):
    B, S, Hq, D = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, S) or k.shape[3] != D:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} vs k {tuple(k.shape)} / v {tuple(v.shape)}")
    if Hq % k.shape[2]:
        raise ValueError(f"flash_attention: {Hq} q heads not a multiple of {k.shape[2]} kv heads")
    if tuple(key_valid.shape) != (B, S):
        raise ValueError(f"flash_attention: key_valid {tuple(key_valid.shape)} != {(B, S)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype} (bf16 or fp32, all equal)")
    for name, x in (("q", q), ("k", k), ("v", v)):
        # rows of one token may sit anywhere (split views of the fused QKV
        # output), but the heads of a token must be packed back to back
        if x.stride(3) != 1 or x.stride(2) != D:
            raise ValueError(f"flash_attention: {name} needs unit element and head stride D, got {x.stride()}")


def _check_launch(q, k, v):
    """What the kernel's 16-byte asynchronous copies need of q, k and v:
    16-byte aligned bases, token and batch strides that are multiples of 8
    elements. Raises on anything else."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16 or (x.shape[0] > 1 and x.stride(0) % 8) or x.stride(1) % 8:
            raise ValueError(
                f"flash_attention: {name} needs a 16-byte aligned base and batch / token strides that are "
                f"multiples of 8 elements, got offset {x.data_ptr() % 16} and strides {x.stride()}"
            )


def _launch(q, k, v, key_valid, scale, causal, window, chunk, softmax_bf16):
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    _check_launch(q, k, v)
    valid = key_valid.to(torch.int32).contiguous()
    out = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device)
    m = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    l = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _cuda.function(
        KERNEL, "nxdi_flash_attention_fwd",
        [P, P, P, P, P, P, P] + [I] * 5 + [I] * 6 + [ctypes.c_float] + [I] * 5 + [P],
    )
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        out.data_ptr(), m.data_ptr(), l.data_ptr(),
        B, S, Hq, Hkv, D,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        float(scale), int(causal), int(window or 0), int(chunk or 0), int(softmax_bf16),
        _DTYPE_CODES[q.dtype],
        _cuda.stream_ptr(q.device),
    )
    _cuda.check(err, KERNEL)
    _cuda.count(KERNEL)
    return out, m, l


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_valid: torch.Tensor,
    *,
    scale: float,
    causal: bool = True,
    window: Optional[int] = None,
    chunk: Optional[int] = None,
    softmax_bf16: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's wrapper (counterpart of ``flash_attention_bhsd``, in the
    port's (B, S, H, D) layout): (out, m, l) as :func:`flash_attention_plain`
    returns them. CUDA tensors launch the kernel (or raise on a shape it
    does not take); CPU tensors take the plain version."""
    _check(q, k, v, key_valid)
    kw = dict(scale=scale, causal=causal, window=window, chunk=chunk, softmax_bf16=softmax_bf16)
    if not launches_kernel(q, k, v, key_valid):
        return flash_attention_plain(q, k, v, key_valid, **kw)
    if q.shape[0] > 65535 or q.shape[2] > 65535:
        raise ValueError(f"flash_attention: grid too large for q {tuple(q.shape)}")
    return _launch(q, k, v, key_valid, **kw)


def flash_attention(
    q, k, v, key_valid, spec, causal: bool = True,
    window: Optional[int] = None, chunk: Optional[int] = None, sink=None,
):
    """Prefill attention entry. q (B, S, Hq, D); k/v (B, S, Hkv, D)
    UN-repeated (the kernel reads kv head ``h // n_rep`` itself); key_valid
    (B, S). ``sink`` (Hq,) folds learned sink logits into the denominator
    through the emitted (m, l). The bf16 softmax mode is the reference's
    packed-kernel option: taken for head_dim <= 64 when
    ``spec.softmax_fp32`` is False. Returns (B, S, Hq, D)."""
    softmax_bf16 = (not spec.softmax_fp32) and spec.head_dim <= 64 and spec.num_heads >= 2
    out, m, l = flash_attention_fwd(
        q, k, v, key_valid, scale=spec.softmax_scale, causal=causal,
        window=window, chunk=chunk, softmax_bf16=softmax_bf16,
    )
    if sink is not None:
        # softmax-with-sink = softmax * l / (l + exp(sink - m))
        sk = sink.float()[None, :, None]  # (1, Hq, 1)
        factor = (l / (l + torch.exp(sk - m))).transpose(1, 2)[..., None]  # (B, S, Hq, 1)
        out = (out.float() * factor).to(out.dtype)
    return out
