"""Functional attention core (counterpart of the reference's
``modules/attention.py``; the main-path subset).

- :func:`qkv_project` / :func:`o_project` — projections with RoPE applied,
  through ``ops/quant.linear`` (plain, int8/fp8 or packed int4 weights),
  each row's LoRA delta added first when ``adapter_ids`` is given
  (``modules/lora.apply_lora``), then the q/k/v and o biases of Qwen2 and GPT-OSS (``AttnSpec.qkv_bias``
  / ``o_bias``), DBRX's clamp of q, k and v (``AttnSpec.qkv_clip``) and the
  per-head q/k RMSNorm of Qwen3 (``AttnSpec.qk_norm``) before RoPE.
- :func:`attention_prefill` — context-encoding attention: the B2 flash
  kernel (``ops/flash_attention.py``), with a layer's sliding ``window``
  and learned sink, unless ``use_flash_kernel`` is False, then the plain
  masked softmax.
- :func:`attention_decode` — the plain decode attention over a bucket
  slice; the decode kernel dispatch lives in
  ``models/base.contiguous_decode_attend``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from neuronx_distributed_inference_tpu_torch.modules.lora import apply_lora
from neuronx_distributed_inference_tpu_torch.modules.norm import rms_norm
from neuronx_distributed_inference_tpu_torch.modules.rope import apply_rope
from neuronx_distributed_inference_tpu_torch.ops.kernel_mode import use_flash
from neuronx_distributed_inference_tpu_torch.ops.quant import linear


@dataclass(frozen=True)
class AttnSpec:
    """Static attention hyperparams (counterpart of the reference AttnSpec)."""

    num_heads: int
    num_kv_heads: int
    head_dim: int
    scale: Optional[float] = None
    qk_norm: bool = False  # rmsnorm on per-head q/k before rope (qwen3)
    qkv_bias: bool = False  # q/k/v projection biases (qwen2, gpt-oss)
    o_bias: bool = False  # o projection bias (gpt-oss)
    softmax_fp32: bool = True
    has_sink: bool = False
    rms_norm_eps: float = 1e-6
    # kernel tri-states (config attn_kernel_enabled /
    # attn_block_tkg_kernel_enabled): None and True take the CUDA kernel
    # (its wrapper uses the plain version on CPU tensors), False the plain
    # PyTorch path
    use_flash_kernel: Optional[bool] = None
    use_tkg_kernel: Optional[bool] = None
    # fused decode attention block B8 (config
    # fused_attn_block_kernel_enabled): only True takes it
    use_fused_block: Optional[bool] = None
    # clamp the q/k/v projection outputs to [-clip, clip] (DBRX clip_qkv)
    qkv_clip: Optional[float] = None

    @property
    def softmax_scale(self) -> float:
        return self.scale if self.scale is not None else self.head_dim**-0.5


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, H_kv, D) -> (B, S, H_kv*n_rep, D)."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def qkv_project(
    params: dict,
    hidden: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    spec: AttnSpec,
    adapter_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """hidden (B,S,H) -> q (B,S,Hq,D), k,v (B,S,Hkv,D), with RoPE applied.

    ``qkv_proj`` (fused_qkv) is one matmul split after: with one shard the
    reference's rank-interleaved layout is a plain [q|k|v] split. With
    ``spec.qk_norm`` q and k take a per-head RMSNorm (weights ``q_norm`` /
    ``k_norm``, shape (D,)) before RoPE, on either layout. ``spec.qkv_clip``
    clamps q, k and v after the projection (and its bias), on either
    layout, as the reference does. ``adapter_ids`` (B,) adds each row's LoRA
    delta to q, k and v before all of these (LoRA refuses fused_qkv)."""
    B, S, _ = hidden.shape
    q_sz = spec.num_heads * spec.head_dim
    kv_sz = spec.num_kv_heads * spec.head_dim
    if "qkv_proj" in params:
        fused = linear(params["qkv_proj"], hidden)
        if spec.qkv_bias:
            fused = fused + params["qkv_proj"]["bias"]
        q, k, v = torch.split(fused, [q_sz, kv_sz, kv_sz], dim=-1)
    else:
        q = apply_lora(params["q_proj"], hidden, linear(params["q_proj"], hidden), adapter_ids)
        k = apply_lora(params["k_proj"], hidden, linear(params["k_proj"], hidden), adapter_ids)
        v = apply_lora(params["v_proj"], hidden, linear(params["v_proj"], hidden), adapter_ids)
        if spec.qkv_bias:
            q = q + params["q_proj"]["bias"]
            k = k + params["k_proj"]["bias"]
            v = v + params["v_proj"]["bias"]
    if spec.qkv_clip is not None:
        c = spec.qkv_clip
        q, k, v = torch.clamp(q, -c, c), torch.clamp(k, -c, c), torch.clamp(v, -c, c)
    q = q.reshape(B, S, spec.num_heads, spec.head_dim)
    k = k.reshape(B, S, spec.num_kv_heads, spec.head_dim)
    v = v.reshape(B, S, spec.num_kv_heads, spec.head_dim)
    if spec.qk_norm:
        q = rms_norm(q, params["q_norm"]["weight"], spec.rms_norm_eps)
        k = rms_norm(k, params["k_norm"]["weight"], spec.rms_norm_eps)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def o_project(
    params: dict, attn_out: torch.Tensor, spec: Optional[AttnSpec] = None, adapter_ids: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """(B,S,Hq,D) -> (B,S,H): each row's LoRA delta with ``adapter_ids``,
    then the o bias when ``spec.o_bias``."""
    B, S, Hq, D = attn_out.shape
    flat = attn_out.reshape(B, S, Hq * D)
    out = apply_lora(params["o_proj"], flat, linear(params["o_proj"], flat), adapter_ids)
    if spec is not None and spec.o_bias:
        out = out + params["o_proj"]["bias"]
    return out


def _masked_softmax_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    spec: AttnSpec,
    sink: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain attention: q (B,Sq,Hq,D), k/v (B,Sk,Hq,D), mask (B,1,Sq,Sk).

    Products accumulate in fp32 (the reference's preferred_element_type);
    masked scores take ``finfo(dtype).min`` — never -inf — so a fully
    masked row is a finite uniform softmax, as in the reference."""
    k = k.to(q.dtype)
    v = v.to(q.dtype)
    dtype = torch.float32 if spec.softmax_fp32 else q.dtype
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * spec.softmax_scale
    scores = torch.where(mask, scores.to(dtype), torch.finfo(dtype).min)
    if sink is not None:
        # learned per-head sink logit joins the softmax denominator
        B, H, Sq, Sk = scores.shape
        sink_col = sink.to(dtype)[None, :, None, None].expand(B, H, Sq, 1)
        probs = torch.softmax(torch.cat([scores, sink_col], dim=-1), dim=-1)[..., :Sk]
    else:
        probs = torch.softmax(scores, dim=-1)
    probs = probs.to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(q.dtype)


def attention_prefill(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],
    spec: AttnSpec,
    sink: Optional[torch.Tensor] = None,
    causal: bool = True,
    key_valid: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    chunk: Optional[int] = None,
) -> torch.Tensor:
    """Context-encoding attention. With ``key_valid`` (B, S) the B2 flash
    kernel's wrapper runs on the UN-repeated K/V (the kernel reads kv head
    ``h // n_rep`` itself and masks from ``key_valid`` and the layer's
    sliding ``window``, so ``mask`` may be None; a learned ``sink`` folds in
    through the emitted softmax stats); ``use_flash_kernel=False`` takes
    the plain masked softmax over the dense (B, 1, S, S) ``mask``, which
    carries the window then."""
    if key_valid is not None and causal and use_flash(spec):
        from neuronx_distributed_inference_tpu_torch.ops.flash_attention import (
            flash_attention,
        )

        return flash_attention(
            q, k, v, key_valid, spec, causal=True, window=window, chunk=chunk, sink=sink
        )
    if mask is None:
        raise ValueError("attention_prefill: the plain path needs the dense mask")
    n_rep = spec.num_heads // spec.num_kv_heads
    return _masked_softmax_attention(q, repeat_kv(k, n_rep), repeat_kv(v, n_rep), mask, spec, sink)


def attention_decode(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    mask: torch.Tensor,
    spec: AttnSpec,
    sink: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain token-gen attention over a bucket slice of the cache.
    q (B, K, Hq, D); k/v (B, S_bucket, Hkv, D); mask (B, 1, K, S_bucket)."""
    n_rep = spec.num_heads // spec.num_kv_heads
    return _masked_softmax_attention(
        q, repeat_kv(k_cache, n_rep), repeat_kv(v_cache, n_rep), mask, spec, sink
    )
