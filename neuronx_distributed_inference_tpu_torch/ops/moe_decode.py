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

The kernel sums the gate/up dots over H in :func:`moe_h_split`'s splits,
each split's fp32 partial sums to scratch, and the down launch adds the
splits in split order before the GLU (a function of the shapes and the SM
count alone, so the result repeats from call to call). Its scratch (the
partial sums and the selections' outputs) is one buffer per device and
stream (``_cuda.scratch``): a call allocates only its output.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from neuronx_distributed_inference_tpu_torch.ops import _cuda
from neuronx_distributed_inference_tpu_torch.ops.kernel_mode import MOE_TKG_MAX_ROWS, launches_kernel

KERNEL = "moe_decode"
MOE_COLS = 64  # columns per block of the gate/up and down launches
MOE_SPLIT_ROWS = 32  # rows of H per gate/up tile: a split holds whole tiles
MOE_MAX_SPLITS = 16
#: gate/up blocks an SM that moe_h_split aims at
MOE_BLOCKS_PER_SM = 2
MOE_THREADS = 256
#: weight tiles a block of either launch may keep in shared memory
MOE_STAGES = (2, 3, 4, 6, 8)
#: weight bytes in flight on each SM that moe_stages aims at, per launch:
#: on one H100 the gate/up launch ran fastest at 50-65 KB and the down
#: launch, whose blocks stream 4 to 28 times fewer tiles, at 55-110 KB
#: (stage counts 2 to 8 at the three timed points,
#: scripts/torch_attention_variants.py b7)
MOE_GATE_INFLIGHT_BYTES = 56 << 10
MOE_DOWN_INFLIGHT_BYTES = 96 << 10
SM_SMEM_BYTES = 228 << 10  # shared memory of one SM, 1 KB of it reserved per block

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


def moe_h_split(H: int, I: int, rows: int, sms: int):
    """(splits, rows of H per split) of B7's gate/up launch for ``rows``
    (token, selection) rows on a card of ``sms`` SMs: enough splits that
    the (column tile, split, row) blocks reach MOE_BLOCKS_PER_SM an SM, each
    a multiple of MOE_SPLIT_ROWS rows, at most MOE_MAX_SPLITS; one split
    once the column tiles and rows alone reach it. Split z sums rows
    [z * per, (z + 1) * per) of H; the down launch adds the splits in
    order."""
    blocks = -(-I // MOE_COLS) * rows
    want = max(1, min(-(-MOE_BLOCKS_PER_SM * sms // blocks), MOE_MAX_SPLITS, -(-H // MOE_SPLIT_ROWS)))
    per = -(-H // want)
    per = -(-per // MOE_SPLIT_ROWS) * MOE_SPLIT_ROWS
    return -(-H // per), per


def moe_stages(blocks: int, sms: int, stage_bytes: int, fixed_bytes: int, target: int) -> int:
    """Weight tiles in shared memory per block for a launch of ``blocks``
    blocks, each holding ``stage_bytes`` a stage beside ``fixed_bytes``:
    the count of MOE_STAGES whose blocks keep closest to ``target`` bytes
    in flight on each SM (all stages but the one in use), with the blocks
    an SM holds at once limited by its threads and shared memory. Fewer
    stages where many blocks share an SM, more where one block has an SM
    to itself."""
    best = None
    for n in MOE_STAGES:
        smem = n * stage_bytes + fixed_bytes
        if smem > SM_SMEM_BYTES - 1024:
            break
        resident = min(2048 // MOE_THREADS, SM_SMEM_BYTES // (smem + 1024))
        miss = abs(min(blocks / sms, resident) * (n - 1) * stage_bytes - target)
        if best is None or miss < best[0]:
            best = (miss, n)
    return best[1]


@functools.lru_cache(maxsize=None)
def _plan(rows: int, H: int, I: int, elt: int, device: int):
    """(splits, rows of H per split, gate/up stages, down stages) of a
    launch, once per shape and device."""
    sms = _cuda.sm_count(torch.device("cuda", device))
    splits, per = moe_h_split(H, I, rows, sms)
    warps = MOE_THREADS // 32
    # the kernel's shared memory (csrc/moe_decode.cu, gate_up() and down()):
    # a gate/up stage holds 32 rows of Wg and Wu and 16 bytes of x a warp, a
    # down stage 64 rows of Wd; beside them the warps' sums and (down) each
    # warp's activations, its I / 8 rows rounded up to 8
    gate = moe_stages(-(-I // MOE_COLS) * splits * rows, sms, elt * 2 * MOE_SPLIT_ROWS * MOE_COLS + 16 * warps,
                      4 * 2 * warps * MOE_COLS, MOE_GATE_INFLIGHT_BYTES)
    cw = -(-I // warps)
    cwp = -(-cw // 8) * 8
    down = moe_stages(-(-H // MOE_COLS) * rows, sms, elt * 64 * MOE_COLS, 4 * (warps * MOE_COLS + warps * cwp),
                      MOE_DOWN_INFLIGHT_BYTES)
    return splits, per, gate, down


def moe_grid_text(T: int, k: int, H: int, I: int, dtype: torch.dtype, device: torch.device) -> str:
    """B7's three grids and stage counts at one shape, for logs."""
    R = T * k
    splits, per, gs, ds = _plan(R, H, I, dtype.itemsize, device.index)
    ci, ch, cc = -(-I // MOE_COLS), -(-H // MOE_COLS), -(-H // 256)
    return (f"gate/up ({ci}, {splits}, {R}) = {ci * splits * R} blocks ({splits} splits of {per} rows of H, "
            f"{gs} stages), down ({ch}, {R}) = {ch * R} ({ds} stages), combine ({cc}, {T}) = {cc * T}")


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
    out = torch.empty((T, H), dtype=x.dtype, device=x.device)
    R = T * k
    splits, per, gate_stages, down_stages = _plan(R, H, I, x.element_size(), x.device.index)
    # scratch: the gate/up partial sums (splits, R, 2, I) in fp32, then the
    # selections' outputs (R, H) in x's dtype, each at a 16-byte boundary
    n_part = -(-splits * R * 2 * I // 4) * 4
    n_ysel = -(-R * H * x.element_size() // 16) * 4
    stream = _cuda.stream_ptr(x.device)
    part = _cuda.scratch(n_part + n_ysel, x.device, stream).data_ptr()
    # 16-byte copies need rows of a multiple of 16 bytes and aligned bases
    row_ok = (I * x.element_size()) % 16 == 0 and (H * x.element_size()) % 16 == 0
    vec = int(row_ok and all(t.data_ptr() % 16 == 0 for t in (x, w_gate, w_up, w_down)))
    P, Ci, Cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _cuda.function(KERNEL, "nxdi_moe_decode", [P] * 9 + [Ci] * 11 + [Cf] * 3 + [Ci, Ci, P])
    err = fn(
        x.data_ptr(), idx.data_ptr(), w.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        part, part + 4 * n_part, out.data_ptr(), T, k, E, H, I, splits, per, gate_stages, down_stages,
        _DTYPE_CODES[x.dtype], code,
        float(act_scale), float(act_bias), float(swiglu_limit or 0.0), int(swiglu_limit is not None), vec,
        stream,
    )
    _cuda.check(err, KERNEL)
    _cuda.count(KERNEL)
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
