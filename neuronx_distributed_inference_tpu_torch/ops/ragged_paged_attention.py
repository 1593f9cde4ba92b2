"""Ragged paged attention for the mixed serving step: kernel B3 (counterpart
of the reference's ``ops/ragged_paged_attention.py``).

One launch covers a serving step's prefill chunks and decode rows: all rows'
query tokens are packed along one axis of T slots, and each row is described
by ``(row_start, row_len, ctx_len)``. Packing contract (the session's
``_build_mixed_descriptors`` keeps it):

- every ``row_start`` is a multiple of :data:`RAGGED_Q_TILE`, so a tile of
  16 slots belongs to at most one row, and T is a multiple of it;
- slot i of row r sits at position ``ctx_len[r] - row_len[r] + (i -
  row_start[r])`` and attends the row's paged cache at positions p <= its
  own with p < ``ctx_len[r]`` (write-then-attend);
- padded slots carry position -1; their cache writes go to the garbage
  block.

:func:`ragged_paged_attention` launches the CUDA C++ kernel
(``csrc/ragged_paged_attention.cu``) for CUDA tensors and takes the plain
version, :func:`ragged_paged_attention_plain` (the reference's
:func:`ragged_attention_native` on one layer), only for CPU tensors. In
bf16 the kernel routes each 16-slot tile by its row (:func:`tile_route`):
a prefill tile runs on the tensor cores, rounding the probabilities to bf16
for P.V as B5 does; a decode tile splits the row's kv axis over the grid
(:func:`ragged_decode_split`) and combines the splits in the same launch.
:func:`ragged_attention` is the decoder layer's dispatch.

An int8/fp8 cache layer comes with the layer's per-head scales
``k_scale`` / ``v_scale`` ((Hkv,) fp32) and ``kv_qmax``: the dequant
factors are ``k_scale / kv_qmax`` (the reference's k_scale / v_scale;
:func:`ragged_attention` passes the cache's running scales, views, with
the code type's qmax). The kernel's code mode takes the caller's q and the
same routes over the 1-byte code tiles (bf16: prefill tiles on the tensor
cores, decode tiles split and combined in the launch; fp32: ``attend``, one
split), reads the scales on the device and converts the codes itself: one
launch, nothing folded or rescaled around it. Launches count under
:data:`CODE_KERNEL`. The plain version takes the factors and dequantizes
after the gather. Not ported here: the tp>1 ``shard_map`` dispatch
(``_dispatch_ragged_kernel``, ROADMAP A10).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from neuronx_distributed_inference_tpu_torch.modules.kvcache import layer_streams
from neuronx_distributed_inference_tpu_torch.ops import _cuda
from neuronx_distributed_inference_tpu_torch.ops.decode_attention import (
    CODE_DTYPES,
    decode_kv_split,
    dtype_code,
    scale_args,
)
from neuronx_distributed_inference_tpu_torch.ops.kernel_mode import launches_kernel, use_ragged

#: q-tile granularity of the packed layout: row starts align to it
RAGGED_Q_TILE = 16
KERNEL = "ragged_paged_attention"
CODE_KERNEL = "ragged_paged_attention_codes"  # over int8/fp8 code blocks
HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_BLOCK_HEADS = 4  # q heads of one kv head per kernel block (64 query rows / 16 slots)


def packed_positions(T: int, row_start: torch.Tensor, row_len: torch.Tensor, ctx_len: torch.Tensor):
    """(positions (T,), owning row (T,)) of the packed slots: slot t belongs
    to the first active row whose segment holds it; a slot of no row has
    position -1 and row 0."""
    tok = torch.arange(T, device=row_start.device)[:, None]
    rs, rl = row_start.to(torch.int64)[None, :], row_len.to(torch.int64)[None, :]
    hits = (tok >= rs) & (tok < rs + rl)
    row_id = torch.argmax(hits.to(torch.int8), dim=1)
    start = row_start.to(torch.int64)[row_id]
    first = (ctx_len.to(torch.int64) - row_len.to(torch.int64))[row_id]
    pos = torch.where(hits.any(dim=1), first + tok[:, 0] - start, torch.full_like(start, -1))
    return pos, row_id


def ragged_attention_native(
    q: torch.Tensor,  # (T, Hq, D)
    k_cache: torch.Tensor,  # (L, NB+1, Hkv, bs, D) the stacked paged cache
    v_cache: torch.Tensor,
    layer_idx: int,
    block_table: torch.Tensor,  # (R, MB)
    positions: torch.Tensor,  # (T,) -1 = padded slot
    row_start: torch.Tensor,  # (R,)
    row_len: torch.Tensor,  # (R,)
    ctx_len: torch.Tensor,  # (R,)
    aspec,
) -> torch.Tensor:
    """Plain version: gather each row's blocks into a contiguous view (block
    0 read as zeros; QuantizedKV code blocks dequantized after the gather),
    route each packed token to its row, and run the plain masked-softmax
    decode attention with the token axis as the batch — the math of the
    split path's plain attention. A padded slot is a uniform average over
    its row's (finite) gathered values. Returns (T, Hq, D)."""
    from neuronx_distributed_inference_tpu_torch.modules.block_kvcache import (
        read_block_cache_at_layer,
    )

    k_r, v_r = read_block_cache_at_layer(k_cache, v_cache, layer_idx, block_table)
    return _attend_rows(q, k_r, v_r, positions, row_start, row_len, ctx_len, aspec)


def _attend_rows(q, k_r, v_r, positions, row_start, row_len, ctx_len, aspec):
    """The plain attention of the packed tokens over their rows' gathered
    (R, W, Hkv, D) K/V. Returns (T, Hq, D)."""
    from neuronx_distributed_inference_tpu_torch.modules.attention import attention_decode

    T = q.shape[0]
    W = k_r.shape[1]
    _, row_id = packed_positions(T, row_start, row_len, ctx_len)
    k_tok = k_r[row_id]  # (T, W, Hkv, D)
    v_tok = v_r[row_id]
    cols = torch.arange(W, device=q.device)[None, None, None, :]
    qpos = positions.to(torch.int64)[:, None, None, None]
    mask = (cols <= qpos) & (cols < ctx_len.to(torch.int64)[row_id][:, None, None, None]) & (qpos >= 0)
    return attention_decode(q[:, None], k_tok, v_tok, mask, aspec)[:, 0]


def ragged_paged_attention_plain(
    q, k_layer, v_layer, block_table, row_start, row_len, ctx_len, *, scale: float, n_rep: int,
    k_scale=None, v_scale=None,
) -> torch.Tensor:
    """The kernel's plain version, with its arguments: the packed positions
    from the descriptors, then :func:`ragged_attention_native`'s gather and
    attention on this one layer with an fp32 softmax; code blocks are
    dequantized after the gather with the factors ``k_scale`` /
    ``v_scale``. Returns (T, Hq, D)."""
    from neuronx_distributed_inference_tpu_torch.modules.attention import AttnSpec
    from neuronx_distributed_inference_tpu_torch.modules.block_kvcache import (
        read_block_cache_at_layer,
    )

    T, Hq, D = q.shape
    positions, _ = packed_positions(T, row_start, row_len, ctx_len)
    spec = AttnSpec(num_heads=Hq, num_kv_heads=Hq // n_rep, head_dim=D, scale=scale)
    k_r, v_r = read_block_cache_at_layer(k_layer[None], v_layer[None], 0, block_table)
    if k_scale is not None:
        k_r = k_r.float() * k_scale.float()[:, None]
        v_r = v_r.float() * v_scale.float()[:, None]
    return _attend_rows(q, k_r, v_r, positions, row_start, row_len, ctx_len, spec)


def _check(q, k_layer, v_layer, block_table, row_start, row_len, ctx_len, n_rep):
    name = KERNEL
    if q.dim() != 3:
        raise ValueError(f"{name}: q must be (T, Hq, D), got {tuple(q.shape)}")
    T, Hq, D = q.shape
    if T % RAGGED_Q_TILE:
        raise ValueError(f"{name}: packed q length {T} not a multiple of {RAGGED_Q_TILE}")
    if k_layer.dim() != 4 or v_layer.shape != k_layer.shape or k_layer.shape[3] != D:
        raise ValueError(f"{name}: q {tuple(q.shape)} vs one layer's cache {tuple(k_layer.shape)}/{tuple(v_layer.shape)}")
    if Hq != k_layer.shape[1] * n_rep:
        raise ValueError(f"{name}: {Hq} q heads != {k_layer.shape[1]} kv heads x n_rep {n_rep}")
    R = row_start.shape[0]
    if block_table.dim() != 2 or block_table.shape[0] != R or tuple(row_len.shape) != (R,) or tuple(ctx_len.shape) != (R,):
        raise ValueError(
            f"{name}: block_table {tuple(block_table.shape)}, row_start/row_len/ctx_len "
            f"{tuple(row_start.shape)}/{tuple(row_len.shape)}/{tuple(ctx_len.shape)} do not describe one set of rows"
        )
    for t, nm in ((block_table, "block_table"), (row_start, "row_start"), (row_len, "row_len"), (ctx_len, "ctx_len")):
        if t.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"{name}: {nm} must be an int tensor, got {t.dtype}")


def block_heads(n_rep: int) -> int:
    """Q heads per kernel block: the largest divisor of ``n_rep`` that is at
    most 4 (the block holds 16 slots x 4 heads)."""
    return next(h for h in range(_BLOCK_HEADS, 0, -1) if n_rep % h == 0)


def tile_route(row_len: int, dtype: torch.dtype, cache_dtype: Optional[torch.dtype] = None) -> str:
    """The kernel's route for a 16-slot tile whose row has ``row_len`` new
    tokens (0: the tile is no row's), by q's ``dtype`` over a cache of
    ``cache_dtype`` (q's by default, or int8/fp8 codes): "zeros" for no
    row, "attend" (the fp32 FMA loop) for an fp32 q, else "decode" (the kv
    split, fp32 FMAs) for one new token and "prefill" (tensor cores, P
    rounded to bf16 for P.V) for more. A code cache takes its q's routes,
    over code tiles (prefill tiles convert each to bf16, exactly)."""
    if cache_dtype is not None and cache_dtype != dtype and cache_dtype not in CODE_DTYPES:
        raise ValueError(f"{KERNEL}: no route for a {dtype} q over a {cache_dtype} cache")
    if row_len <= 0:
        return "zeros"
    if dtype != torch.bfloat16:
        return "attend"
    return "decode" if row_len == 1 else "prefill"


def ragged_decode_split(T: int, width: int, Hkv: int, n_rep: int, sms: int):
    """(splits, positions per split) of a bf16 launch's decode tiles: B4's
    rule (decode_kv_split) over the table's ``width`` = MB * bs positions
    for the grid's T / 16 * Hkv * head-group blocks, over a bf16 or a code
    cache alike. A function of the shapes and the card only, so the
    combine's order (and the result) repeats from call to call. Split z
    covers positions [z * per, (z + 1) * per); a decode row's splits past
    its context exit at once, and the others are combined in split order
    in the same launch."""
    return decode_kv_split(width, (T // RAGGED_Q_TILE) * Hkv * (n_rep // block_heads(n_rep)), sms)


def _launch(q, k_layer, v_layer, block_table, row_start, row_len, ctx_len, scale, n_rep,
            code_args=(None, None, 0.0)):
    """One launch over plain cache blocks of q's dtype, or, with the
    ``code_args`` of a code cache (decode_attention.scale_args), over its
    1-byte code blocks."""
    T, Hq, D = q.shape
    NB1, Hkv, bs, _ = k_layer.shape
    codes = code_args[0] is not None
    if D not in HEAD_DIMS:
        raise ValueError(f"{KERNEL}: head_dim {D} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES or v_layer.dtype != k_layer.dtype or (
        k_layer.dtype not in CODE_DTYPES if codes else k_layer.dtype != q.dtype
    ):
        raise ValueError(f"{KERNEL}: dtypes {q.dtype}/{k_layer.dtype}/{v_layer.dtype} (a bf16 or fp32 q over a "
                         "cache of its dtype, or over int8/fp8 codes with their scales)")
    if Hkv > 65535 or n_rep // block_heads(n_rep) > 65535:
        raise ValueError(f"{KERNEL}: grid too large for {Hkv} kv heads, n_rep {n_rep}")
    for name, x in (("q", q), ("k_layer", k_layer), ("v_layer", v_layer)):
        if not x.is_contiguous():
            raise ValueError(f"{KERNEL}: {name} must be contiguous")
    if q.dtype == torch.bfloat16 and (k_layer.data_ptr() % 16 or v_layer.data_ptr() % 16 or q.data_ptr() % 16):
        raise ValueError(f"{KERNEL}: q and the cache layers must start on 16-byte boundaries")
    table = block_table.to(torch.int32).contiguous()
    rs, rl, cl = (t.to(torch.int32).contiguous() for t in (row_start, row_len, ctx_len))
    MB = table.shape[1]
    stream = _cuda.stream_ptr(q.device)
    splits, per = 1, MB * bs
    if q.dtype == torch.bfloat16:
        splits, per = ragged_decode_split(T, MB * bs, Hkv, n_rep, _cuda.sm_count(q.device))
    parts, counters = [None] * 3, None
    if splits > 1:
        n = splits * (T // RAGGED_Q_TILE) * Hq
        base = _cuda.scratch(n * (D + 2), q.device, stream).data_ptr()
        parts = [base, base + 4 * n, base + 8 * n]
        tiles = (T // RAGGED_Q_TILE) * Hkv * (n_rep // block_heads(n_rep))
        counters = _cuda.counters(tiles, q.device, stream).data_ptr()
    out = torch.empty_like(q)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _cuda.function(KERNEL, "nxdi_ragged_paged_attention", [P] * 12 + [I] * 11 + [F, I, I, P, P, F, P])
    err = fn(
        q.data_ptr(), k_layer.data_ptr(), v_layer.data_ptr(), table.data_ptr(),
        rs.data_ptr(), rl.data_ptr(), cl.data_ptr(), out.data_ptr(), *parts, counters,
        T, rs.shape[0], Hq, Hkv, block_heads(n_rep), D, NB1, bs, MB, splits, per,
        float(scale), _DTYPE_CODES[q.dtype], dtype_code(k_layer.dtype), *code_args, stream,
    )
    counter = CODE_KERNEL if codes else KERNEL
    _cuda.check(err, counter)
    _cuda.count(counter)
    return out


def ragged_paged_attention(
    q: torch.Tensor,  # (T, Hq, D) packed queries, row starts 16-aligned
    k_layer: torch.Tensor,  # (NB+1, Hkv, bs, D) one layer's head-major paged cache
    v_layer: torch.Tensor,
    block_table: torch.Tensor,  # (R, MB) int
    row_start: torch.Tensor,  # (R,) int packed offset of each row's segment
    row_len: torch.Tensor,  # (R,) int query tokens per row (0 = inactive)
    ctx_len: torch.Tensor,  # (R,) int total kv length per row (incl. new)
    *,
    scale: float,
    n_rep: int,
    k_scale: Optional[torch.Tensor] = None,  # (Hkv,) fp32: K factors k_scale / kv_qmax
    v_scale: Optional[torch.Tensor] = None,  # for int8/fp8 code blocks; None = plain cache
    kv_qmax: float = 1.0,
) -> torch.Tensor:
    """Mixed prefill-chunk and decode attention off the paged cache in one
    launch. Returns (T, Hq, D) in q's dtype. CUDA tensors launch the kernel
    (its code mode with ``k_scale``/``v_scale``) or raise on what it does
    not take; CPU tensors take the plain version. Padded slots are exact
    zeros from the kernel and finite from the plain version."""
    _check(q, k_layer, v_layer, block_table, row_start, row_len, ctx_len, n_rep)
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{KERNEL}: k_scale and v_scale come together")
    Hkv = k_layer.shape[1]
    if k_scale is not None and (tuple(k_scale.shape) != (Hkv,) or tuple(v_scale.shape) != (Hkv,)):
        raise ValueError(f"{KERNEL}: k_scale/v_scale {tuple(k_scale.shape)}/{tuple(v_scale.shape)} != {(Hkv,)}")
    if k_scale is not None and (k_layer.dtype not in CODE_DTYPES or v_layer.dtype != k_layer.dtype):
        raise ValueError(f"{KERNEL}: k_scale/v_scale need int8/fp8 code blocks, got {k_layer.dtype}/{v_layer.dtype}")
    scales = [k_scale, v_scale] if k_scale is not None else []
    if not launches_kernel(q, k_layer, v_layer, block_table, row_start, row_len, ctx_len, *scales):
        if k_scale is not None and kv_qmax != 1.0:
            k_scale, v_scale = k_scale / kv_qmax, v_scale / kv_qmax
        return ragged_paged_attention_plain(
            q, k_layer, v_layer, block_table, row_start, row_len, ctx_len, scale=scale, n_rep=n_rep,
            k_scale=k_scale, v_scale=v_scale,
        )
    return _launch(q, k_layer, v_layer, block_table, row_start, row_len, ctx_len, scale, n_rep,
                   scale_args(KERNEL, k_scale, v_scale, kv_qmax))


def ragged_attention(
    q: torch.Tensor,  # (1, T, Hq, D) the mixed step's packed layout
    k_cache: torch.Tensor,  # (L, NB+1, Hkv, bs, D)
    v_cache: torch.Tensor,
    layer_idx: int,
    block_table: torch.Tensor,
    positions: torch.Tensor,  # (1, T)
    row_start: torch.Tensor,
    row_len: torch.Tensor,
    ctx_len: torch.Tensor,
    aspec,
) -> torch.Tensor:
    """The decoder layer's dispatch for the mixed step: the B3 kernel's
    wrapper on this layer of the cache (a QuantizedKV cache's code blocks
    with views of the layer's scales) unless ``use_flash_kernel`` is False,
    then the plain version over the stacked cache. Returns (1, T, Hq, D)."""
    q3 = q[0]
    if use_ragged(aspec):
        k_l, v_l, codes = layer_streams(k_cache, v_cache, layer_idx)
        out = ragged_paged_attention(
            q3, k_l, v_l, block_table, row_start, row_len, ctx_len,
            scale=aspec.softmax_scale, n_rep=aspec.num_heads // aspec.num_kv_heads, **codes,
        )
    else:
        out = ragged_attention_native(
            q3, k_cache, v_cache, layer_idx, block_table, positions[0], row_start, row_len, ctx_len, aspec
        )
    return out[None]
