"""Selected-experts MoE decode, kernel B7 (counterpart of the reference's
``ops/moe_decode.py``).

At decode the dense all-experts route (``modules/moe.expert_mlps_dense``)
reads every expert's gate, up and down weights for every token: 1.21 GB a
layer at Qwen3-30B-A3B's widths. B7 reads only the selected experts'
weights, 75.5 MB a layer at batch 1. :func:`fused_moe_decode` launches
``csrc/moe_decode.cu`` for CUDA tensors (and raises on what the kernel does
not take) and runs :func:`fused_moe_decode_plain` for CPU tensors.

Both compute what the Pallas kernel computes: for each (token, selection)
row, the selected expert's GLU MLP with every dot in fp32, the activation
rounded to the weight dtype before the down product, each selection's
output rounded to ``x``'s dtype, and the combine with the routing weights in
fp32, rounded once to ``x``'s dtype.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from neuronx_distributed_inference_tpu_torch.ops import _cuda
from neuronx_distributed_inference_tpu_torch.ops.kernel_mode import MOE_TKG_MAX_ROWS, launches_kernel

KERNEL = "moe_decode"

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: the GLU forms of the kernel, as its act codes; every activation but silu
#: is the tanh gelu, as in the Pallas kernel
_ACTS = {"silu": 0, "gelu": 1, "gelu_pytorch_tanh": 1}
_SWIGLU = 2


def _act_code(act: str, act_scale: float, act_bias: float, swiglu_limit: Optional[float]) -> int:
    if act_scale != 1.0 or act_bias != 0.0 or swiglu_limit is not None:
        return _SWIGLU
    if act not in _ACTS:
        raise ValueError(f"fused_moe_decode: act {act!r} (the kernel takes {sorted(_ACTS)})")
    return _ACTS[act]


def glu_plain(g: torch.Tensor, u: torch.Tensor, act: str = "silu", act_scale: float = 1.0,
              act_bias: float = 0.0, swiglu_limit: Optional[float] = None) -> torch.Tensor:
    """The kernel's GLU on fp32 gate and up values."""
    code = _act_code(act, act_scale, act_bias, swiglu_limit)
    if code == _SWIGLU:
        if swiglu_limit is not None:
            g = torch.clamp(g, max=swiglu_limit)
            u = torch.clamp(u, -swiglu_limit, swiglu_limit)
        return g * torch.sigmoid(act_scale * g) * (u + act_bias)
    if code == 0:
        return F.silu(g) * u
    return F.gelu(g, approximate="tanh") * u


def selection_outputs_plain(
    x: torch.Tensor, topk_idx: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
    w_down: torch.Tensor, *, act: str = "silu", act_scale: float = 1.0, act_bias: float = 0.0,
    swiglu_limit: Optional[float] = None,
) -> torch.Tensor:
    """(T, k, H) per-selection outputs in ``x``'s dtype: each row's expert
    weights gathered, the dots in fp32 on ``x`` cast to the weight dtype,
    the activation rounded to the down weight's dtype."""
    T, H = x.shape
    k = topk_idx.shape[1]
    e = topk_idx.reshape(T * k).to(torch.int64)
    xr = x.to(w_gate.dtype).float().repeat_interleave(k, dim=0)[:, None, :]  # (R, 1, H)
    g = torch.bmm(xr, w_gate[e].float())[:, 0]  # (R, I)
    u = torch.bmm(xr, w_up[e].float())[:, 0]
    a = glu_plain(g, u, act, act_scale, act_bias, swiglu_limit).to(w_down.dtype)
    y = torch.bmm(a.float()[:, None, :], w_down[e].float())[:, 0]  # (R, H)
    return y.to(x.dtype).reshape(T, k, H)


def fused_moe_decode_plain(
    x: torch.Tensor, topk_idx: torch.Tensor, topk_w: torch.Tensor, w_gate: torch.Tensor,
    w_up: torch.Tensor, w_down: torch.Tensor, *, act: str = "silu", act_scale: float = 1.0,
    act_bias: float = 0.0, swiglu_limit: Optional[float] = None,
) -> torch.Tensor:
    """B7's plain version: :func:`selection_outputs_plain` combined with the
    routing weights in fp32, then cast to ``x``'s dtype."""
    y = selection_outputs_plain(
        x, topk_idx, w_gate, w_up, w_down, act=act, act_scale=act_scale, act_bias=act_bias,
        swiglu_limit=swiglu_limit,
    )
    return torch.einsum("tk,tkh->th", topk_w.float(), y.float()).to(x.dtype)


def _check(x, topk_idx, topk_w, w_gate, w_up, w_down) -> None:
    """What B7 takes: x (T, H), topk_idx / topk_w (T, k), T * k <= 64,
    w_gate / w_up (E, H, I), w_down (E, I, H), every float in one dtype,
    bf16 or fp32."""
    if x.dim() != 2:
        raise ValueError(f"fused_moe_decode: x must be (T, H), got {tuple(x.shape)}")
    T, H = x.shape
    if topk_idx.dim() != 2 or topk_idx.shape[0] != T or tuple(topk_w.shape) != tuple(topk_idx.shape):
        raise ValueError(
            f"fused_moe_decode: topk_idx {tuple(topk_idx.shape)} and topk_w {tuple(topk_w.shape)} must be (T={T}, k)"
        )
    if topk_idx.dtype.is_floating_point or topk_idx.dtype == torch.bool:
        raise ValueError(f"fused_moe_decode: topk_idx dtype {topk_idx.dtype} (an integer type)")
    k = topk_idx.shape[1]
    if not 1 <= T * k <= MOE_TKG_MAX_ROWS:
        raise ValueError(f"fused_moe_decode: {T * k} (token, selection) rows (B7 takes 1 to {MOE_TKG_MAX_ROWS})")
    if w_gate.dim() != 3 or w_gate.shape[1] != H or tuple(w_up.shape) != tuple(w_gate.shape):
        raise ValueError(
            f"fused_moe_decode: w_gate {tuple(w_gate.shape)} / w_up {tuple(w_up.shape)} must be (E, H={H}, I)"
        )
    E, _, I = w_gate.shape
    if tuple(w_down.shape) != (E, I, H):
        raise ValueError(f"fused_moe_decode: w_down {tuple(w_down.shape)} != {(E, I, H)}")


def _launch(x, topk_idx, topk_w, w_gate, w_up, w_down, act, act_scale, act_bias, swiglu_limit):
    T, H = x.shape
    k = topk_idx.shape[1]
    E, _, I = w_gate.shape
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"fused_moe_decode: x dtype {x.dtype} (bf16 or fp32)")
    for name, w in (("w_gate", w_gate), ("w_up", w_up), ("w_down", w_down)):
        if w.dtype != x.dtype:
            raise ValueError(f"fused_moe_decode: {name} dtype {w.dtype} != x dtype {x.dtype}")
        if not w.is_contiguous():
            raise ValueError(f"fused_moe_decode: {name} must be contiguous")
    if len({t.device for t in (x, topk_idx, topk_w, w_gate, w_up, w_down)}) != 1:
        raise ValueError("fused_moe_decode: inputs on more than one device")
    code = _act_code(act, act_scale, act_bias, swiglu_limit)
    x = x.contiguous()
    idx = topk_idx.to(torch.int32).contiguous()
    w = topk_w.to(torch.float32).contiguous()
    # scratch: the activations and the per-selection outputs
    act_buf = torch.empty((T * k, I), dtype=x.dtype, device=x.device)
    ysel = torch.empty((T * k, H), dtype=x.dtype, device=x.device)
    out = torch.empty((T, H), dtype=x.dtype, device=x.device)
    # wide loads need rows of a multiple of 4 elements and 16-byte aligned bases
    vec = int(I % 4 == 0 and H % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (w_gate, w_up, w_down)))
    P, Ci, Cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _cuda.function(KERNEL, "nxdi_moe_decode", [P] * 9 + [Ci] * 7 + [Cf] * 3 + [Ci, Ci, P])
    err = fn(
        x.data_ptr(), idx.data_ptr(), w.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        act_buf.data_ptr(), ysel.data_ptr(), out.data_ptr(), T, k, E, H, I, _DTYPE_CODES[x.dtype], code,
        float(act_scale), float(act_bias), float(swiglu_limit or 0.0), int(swiglu_limit is not None), vec,
        _cuda.stream_ptr(x.device),
    )
    _cuda.check(err, KERNEL)
    _cuda.LAUNCHES[KERNEL] += 1
    return out


def fused_moe_decode(
    x: torch.Tensor,  # (T, H)
    topk_idx: torch.Tensor,  # (T, k) selected expert per token
    topk_w: torch.Tensor,  # (T, k) combine weights
    w_gate: torch.Tensor,  # (E, H, I)
    w_up: torch.Tensor,  # (E, H, I)
    w_down: torch.Tensor,  # (E, I, H)
    *,
    act: str = "silu",
    act_scale: float = 1.0,
    act_bias: float = 0.0,
    swiglu_limit: Optional[float] = None,
) -> torch.Tensor:
    """Selected-experts-only MoE decode: the (T, H) combined output in
    ``x``'s dtype. CUDA tensors launch B7 (or raise on what it does not
    take: T * k > 64, mixed dtypes, non-contiguous weights); CPU tensors
    take the plain version."""
    _check(x, topk_idx, topk_w, w_gate, w_up, w_down)
    kw = dict(act=act, act_scale=act_scale, act_bias=act_bias, swiglu_limit=swiglu_limit)
    if not launches_kernel(x, topk_idx, topk_w, w_gate, w_up, w_down):
        return fused_moe_decode_plain(x, topk_idx, topk_w, w_gate, w_up, w_down, **kw)
    return _launch(x, topk_idx, topk_w, w_gate, w_up, w_down, act, act_scale, act_bias, swiglu_limit)
