"""The fused decode layer: the attention block B8 and the MLP block B9
(counterparts of the reference's ``ops/decode_block.py``).

:func:`fused_attn_block` does a decode layer's attention half in one entry:
rmsnorm, the fused QKV product, RoPE, attention of the K new tokens among
themselves (causal) and over the prior cache, the o-projection and the
residual. It returns ``k_new`` / ``v_new`` for the cache scatter, which
the caller does (the reference's ``update_cache_in_kernel=False``).
:func:`fused_mlp_block` does the MLP half: rmsnorm, ``act(gate) * up``, the
down-projection and the residual.

Each wrapper launches its CUDA kernel (``csrc/fused_attn_block.cu``,
``csrc/fused_mlp_block.cu``) for CUDA tensors, or raises on what the kernel
does not take, and runs its plain version for CPU tensors. The plain
versions round where the Pallas kernels round, which is not where the
unfused layer rounds: in B8 the norm is fp32 and cast to the weight dtype
once; q, k and v stay fp32 (RoPE in fp32, the new tokens attend the fp32
k and v) and ``k_new`` / ``v_new`` are rounded to ``x``'s dtype only on
output; the prior cache is read in its dtype and widened; the softmax is
fp32; the attention rows are cast to the o-proj weight's dtype once, and
o-proj plus the residual is summed in fp32 and rounded once. In B9 the
normed input is cast once, gate and up are fp32, ``act(g) * u`` is cast to
the down weight's dtype and ``x + down`` is summed in fp32 and rounded once.

The prior part's mask excludes the slots written this step (the scatter
comes after the kernel; the new tokens are attended as the active part):
``mask & ~(p0 <= col < p0 + K)`` with ``p0 = positions[:, 0]``. A row with
an all-false prior mask still attends its own new tokens, so its output is
finite.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from neuronx_distributed_inference_tpu_torch.ops import _cuda
from neuronx_distributed_inference_tpu_torch.ops.kernel_mode import (
    FUSED_BLOCK_MAX_Q,
    FUSED_MLP_ACTS,
    launches_kernel,
)

ATTN_KERNEL = "fused_attn_block"
MLP_KERNEL = "fused_mlp_block"
HEAD_DIMS = (64, 128)
MAX_ROWS = 64  # n_rep * K query rows one attention block holds
NEG_INF = -1e30  # the reference kernels' masked-score fill
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the activation codes of csrc/fused_mlp_block.cu: every one but silu is
#: the tanh gelu, as in the Pallas kernel
_ACT_CODES = {"silu": 0, "gelu": 1, "gelu_pytorch_tanh": 1}

# the launch geometry of csrc/decode_gemv.cuh and csrc/fused_attn_block.cu
GEMV_COLS = 128  # output columns per block (a block holds every row)
GEMV_MIN_K = 128  # the shortest reduction range one block takes when K is split
GEMV_K_ALIGN = 64  # a split's reduction range is a multiple of this (whole weight stages)
GEMV_MAX_SPLITS = 16  # the most blocks that share one output tile's reduction
GEMV_BLOCKS_PER_SM = 2  # the grid the split aims at
ATTN_TILE = 64  # cache positions per staged attention tile
MAX_KV_SPLITS = 32  # the most blocks that share one (row, kv head)
KV_BLOCKS_PER_SM = 4  # the attention grid's most blocks an SM before a split takes two tiles


def _rms(xf: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 rmsnorm as the Pallas kernels compute it."""
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return xf * torch.rsqrt(var + eps) * gamma.float()


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-rotation RoPE in fp32: x (B, K, heads, D), cos/sin (B, K, D/2)."""
    d2 = x.shape[-1] // 2
    c, s = cos.float()[:, :, None, :], sin.float()[:, :, None, :]
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def prior_mask(mask: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """The decode mask (B, 1, K, S) less the K slots this step writes,
    ``[p0, p0 + K)`` with ``p0 = positions[:, 0]``."""
    K, S = mask.shape[-2], mask.shape[-1]
    cols = torch.arange(S, device=mask.device)[None, None, None, :]
    p0 = positions[:, 0].to(torch.int64)[:, None, None, None]
    return mask & ~((cols >= p0) & (cols < p0 + K))


def attn_rows_plain(
    x, gamma, wqkv, cos, sin, k_cache, v_cache, layer_idx, slot_ids, mask, positions, *,
    scale: float, eps: float, n_kv: int,
):
    """B8's plain version up to the o-projection, all fp32: (the normed
    input as rounded to the weight dtype (B, K, H), the RoPE'd k and the v
    of the new tokens (B, K, Hkv, D), the attention rows (B, K, Hq D))."""
    B, K, H = x.shape
    D = k_cache.shape[-1]
    Hkv = n_kv
    Hq = wqkv.shape[1] // D - 2 * Hkv
    n_rep = Hq // Hkv
    normed = _rms(x.float(), gamma, eps).to(wqkv.dtype).float()
    qkv = normed @ wqkv.float()  # (B, K, N3)
    q = _rope(qkv[..., : Hq * D].reshape(B, K, Hq, D), cos, sin)
    k = _rope(qkv[..., Hq * D : (Hq + Hkv) * D].reshape(B, K, Hkv, D), cos, sin)
    v = qkv[..., (Hq + Hkv) * D :].reshape(B, K, Hkv, D)
    S = mask.shape[-1]
    lines = slot_ids.to(torch.int64)
    kp = k_cache[layer_idx][lines, :S].float()  # (B, S, Hkv, D)
    vp = v_cache[layer_idx][lines, :S].float()
    qg = q.reshape(B, K, Hkv, n_rep, D)  # q head h = g * n_rep + r
    s_act = torch.einsum("btgrd,bugd->bgrtu", qg, k) * scale  # (B, Hkv, n_rep, K, K)
    s_pri = torch.einsum("btgrd,bsgd->bgrts", qg, kp) * scale  # (B, Hkv, n_rep, K, S)
    causal = torch.ones((K, K), dtype=torch.bool, device=x.device).tril()
    ok = torch.cat(
        [causal.expand(B, 1, 1, K, K), prior_mask(mask, positions)[:, :, None]], dim=-1
    ).expand(B, Hkv, n_rep, K, K + S)
    s = torch.where(ok, torch.cat([s_act, s_pri], dim=-1), NEG_INF)
    p = torch.where(ok, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    o = torch.einsum("bgrtu,bugd->bgrtd", p[..., :K], v) + torch.einsum("bgrts,bsgd->bgrtd", p[..., K:], vp)
    o = o / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    return normed, k, v, o.permute(0, 3, 1, 2, 4).reshape(B, K, Hq * D)


def fused_attn_block_plain(
    x, gamma, wqkv, wout, cos, sin, k_cache, v_cache, layer_idx, slot_ids, mask, positions, *,
    scale: float, eps: float, n_kv: int,
):
    """B8's plain version: returns (hidden (B, K, H) with the residual
    added, k_new (B, K, Hkv, D), v_new (B, K, Hkv, D)), rounded where the
    Pallas kernel rounds (module docstring)."""
    _, k, v, attn = attn_rows_plain(
        x, gamma, wqkv, cos, sin, k_cache, v_cache, layer_idx, slot_ids, mask, positions,
        scale=scale, eps=eps, n_kv=n_kv,
    )
    out = (x.float() + attn.to(wout.dtype).float() @ wout.float()).to(x.dtype)
    return out, k.to(x.dtype), v.to(x.dtype)


def _act(act: str):
    if act not in _ACT_CODES:
        raise ValueError(f"fused_mlp_block: act {act!r} (the kernel takes {sorted(_ACT_CODES)})")
    return F.silu if _ACT_CODES[act] == 0 else functools.partial(F.gelu, approximate="tanh")


def glu_rows_plain(x, gamma, w_gate, w_up, *, eps: float, act: str = "silu") -> torch.Tensor:
    """B9's plain version up to the down product: ``act(g) * u`` in fp32,
    (B, K, I), before its rounding to the down weight's dtype."""
    normed = _rms(x.float(), gamma, eps).to(w_gate.dtype).float()
    return _act(act)(normed @ w_gate.float()) * (normed @ w_up.float())


def fused_mlp_block_plain(x, gamma, w_gate, w_up, w_down, *, eps: float, act: str = "silu"):
    """B9's plain version: ``x + down(act(gate) * up)`` of the rms-normed
    input, rounded where the Pallas kernel rounds (module docstring)."""
    a = glu_rows_plain(x, gamma, w_gate, w_up, eps=eps, act=act)
    return (x.float() + a.to(w_down.dtype).float() @ w_down.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# checks and launches
# ---------------------------------------------------------------------------


def _check_attn(x, gamma, wqkv, wout, cos, sin, k_cache, v_cache, layer_idx, slot_ids, mask, positions, n_kv):
    """What B8 takes, on any device: x (B, K, H) with K <= 16; caches
    (L, R, S_max, Hkv, D), D 64 or 128; wqkv (H, (Hq + 2 Hkv) D); wout
    (Hq D, H); cos/sin (B, K, D/2); a bool mask (B, 1, K, S_kv) with
    S_kv <= S_max; integer slot_ids (B,) and positions (B, K); n_rep * K
    <= 64."""
    name = ATTN_KERNEL
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (B, K, H), got {tuple(x.shape)}")
    B, K, H = x.shape
    if not 1 <= K <= FUSED_BLOCK_MAX_Q:
        raise ValueError(f"{name}: {K} new tokens per row (1 to {FUSED_BLOCK_MAX_Q})")
    if k_cache.dim() != 5 or v_cache.shape != k_cache.shape:
        raise ValueError(f"{name}: caches {tuple(k_cache.shape)} / {tuple(v_cache.shape)} != (L, R, S_max, Hkv, D)")
    L, R, S_max, Hkv, D = k_cache.shape
    if Hkv != n_kv or D not in HEAD_DIMS:
        raise ValueError(f"{name}: cache kv heads {Hkv} (n_kv {n_kv}), head_dim {D} (takes {HEAD_DIMS})")
    if wqkv.dim() != 2 or wqkv.shape[0] != H or wqkv.shape[1] % D or wqkv.shape[1] // D <= 2 * Hkv:
        raise ValueError(f"{name}: wqkv {tuple(wqkv.shape)} != (H={H}, (Hq + 2 * {Hkv}) * {D})")
    Hq = wqkv.shape[1] // D - 2 * Hkv
    if Hq % Hkv or (Hq // Hkv) * K > MAX_ROWS:
        raise ValueError(f"{name}: {Hq} q heads over {Hkv} kv heads at K={K} (n_rep * K <= {MAX_ROWS})")
    if tuple(wout.shape) != (Hq * D, H) or tuple(gamma.shape) != (H,):
        raise ValueError(f"{name}: wout {tuple(wout.shape)} != {(Hq * D, H)} or gamma {tuple(gamma.shape)} != {(H,)}")
    if tuple(cos.shape) != (B, K, D // 2) or tuple(sin.shape) != (B, K, D // 2):
        raise ValueError(f"{name}: cos/sin {tuple(cos.shape)}/{tuple(sin.shape)} != {(B, K, D // 2)}")
    if mask.dim() != 4 or mask.shape[:3] != (B, 1, K) or mask.dtype != torch.bool or mask.shape[3] > S_max:
        raise ValueError(f"{name}: mask {tuple(mask.shape)} {mask.dtype} != bool {(B, 1, K, '<= S_max')}")
    for arg, t, shape in (("slot_ids", slot_ids, (B,)), ("positions", positions, (B, K))):
        if tuple(t.shape) != shape or t.dtype.is_floating_point or t.dtype == torch.bool:
            raise ValueError(f"{name}: {arg} {tuple(t.shape)} {t.dtype} != integer {shape}")
    if not 0 <= int(layer_idx) < L:
        raise ValueError(f"{name}: layer {layer_idx} outside the cache's {L} layers")


def _check_mlp(x, gamma, w_gate, w_up, w_down, act):
    """What B9 takes, on any device: x (B, K, H) with K <= 16; gamma (H,);
    w_gate / w_up (H, I); w_down (I, H); an activation of FUSED_MLP_ACTS."""
    name = MLP_KERNEL
    if x.dim() != 3 or not 1 <= x.shape[1] <= FUSED_BLOCK_MAX_Q:
        raise ValueError(f"{name}: x must be (B, K <= {FUSED_BLOCK_MAX_Q}, H), got {tuple(x.shape)}")
    H = x.shape[2]
    if w_gate.dim() != 2 or w_gate.shape[0] != H or tuple(w_up.shape) != tuple(w_gate.shape):
        raise ValueError(f"{name}: w_gate {tuple(w_gate.shape)} / w_up {tuple(w_up.shape)} != (H={H}, I)")
    I = w_gate.shape[1]
    if tuple(w_down.shape) != (I, H) or tuple(gamma.shape) != (H,):
        raise ValueError(f"{name}: w_down {tuple(w_down.shape)} != {(I, H)} or gamma {tuple(gamma.shape)} != {(H,)}")
    if act not in FUSED_MLP_ACTS:
        raise ValueError(f"{name}: act {act!r} (the kernel takes {FUSED_MLP_ACTS})")


def _same_dtype(name, x, **tensors):
    """Every float input of a kernel in x's dtype, bf16 or fp32, and the
    weights and caches contiguous (the kernels address them densely)."""
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: x dtype {x.dtype} (bf16 or fp32)")
    for arg, t in tensors.items():
        if t.dtype != x.dtype:
            raise ValueError(f"{name}: {arg} dtype {t.dtype} != x dtype {x.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def gemv_split(n_cols: int, kdim: int, sms: int):
    """(splits, rows of K per split) of one product of csrc/decode_gemv.cuh
    over ``n_cols`` output columns and a reduction of ``kdim``: enough
    splits for about GEMV_BLOCKS_PER_SM blocks an SM over the column tiles,
    each over at least GEMV_MIN_K of K, at most GEMV_MAX_SPLITS; each
    split's range a multiple of GEMV_K_ALIGN, and as many splits as that
    leaves non-empty. Rows are not on the grid (a block holds them all), so
    the count does not depend on them. A function of the shapes and the card
    only, so the summation order (and the result) repeats from run to run."""
    tiles = -(-n_cols // GEMV_COLS)
    want = max(1, min(GEMV_BLOCKS_PER_SM * sms // tiles, kdim // GEMV_MIN_K, GEMV_MAX_SPLITS))
    per = -(-kdim // want)
    per = -(-per // GEMV_K_ALIGN) * GEMV_K_ALIGN
    return -(-kdim // per), per


def kv_split(S_kv: int, blocks: int, sms: int):
    """(splits, tiles per split) of the prior cache's tiles over the
    ``blocks`` (row, kv head) pairs: one ATTN_TILE tile a split while the
    grid stays within KV_BLOCKS_PER_SM blocks an SM, at most MAX_KV_SPLITS,
    else the fewest tiles a split that keep it there. A split of one tile
    waits on one round trip to memory; a second tile in series costs ~3.5
    us at the 1B layer (scripts/torch_attention_variants.py b8). A
    function of the shapes and the card only, so the combine's order (and
    the result) repeats from run to run. The kernel takes the split as
    ``tiles * ATTN_TILE`` positions (:func:`_kv_plan`)."""
    n_tiles = -(-S_kv // ATTN_TILE)
    want = max(1, min(n_tiles, MAX_KV_SPLITS, KV_BLOCKS_PER_SM * sms // blocks))
    per = -(-n_tiles // want)
    return -(-n_tiles // per), per


def _kv_plan(S_kv: int, blocks: int, sms: int):
    """(splits, positions per split) of B8's attention launch: kv_split's
    tiles of ATTN_TILE positions."""
    splits, tiles = kv_split(S_kv, blocks, sms)
    return splits, tiles * ATTN_TILE


def _launch_attn(x, gamma, wqkv, wout, cos, sin, k_cache, v_cache, layer_idx, slot_ids, mask, positions,
                 scale, eps, n_kv):
    name = ATTN_KERNEL
    _same_dtype(name, x, gamma=gamma, wqkv=wqkv, wout=wout, k_cache=k_cache, v_cache=v_cache)
    if len({t.device for t in (x, gamma, wqkv, wout, cos, sin, k_cache, v_cache, slot_ids, mask, positions)}) != 1:
        raise ValueError(f"{name}: inputs on more than one device")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError(f"{name}: the caches must start on 16-byte boundaries")
    if mask.stride(3) != 1:
        raise ValueError(f"{name}: mask needs a unit position stride, got {mask.stride()}")
    B, K, H = x.shape
    L, R, S_max, Hkv, D = k_cache.shape
    N3 = wqkv.shape[1]
    Hq = N3 // D - 2 * Hkv
    BK, S_kv = B * K, mask.shape[-1]
    dev = x.device
    sms = _cuda.sm_count(dev)
    s_qkv, kps_qkv = gemv_split(N3, H, sms)
    s_kv, per = _kv_plan(S_kv, B * Hkv, sms)
    s_o, kps_o = gemv_split(H, Hq * D, sms)
    stream = _cuda.stream_ptr(dev)
    x = x.contiguous()
    cos, sin = cos.float().contiguous(), sin.float().contiguous()
    slots = slot_ids.to(torch.int32).contiguous()
    pos = positions.to(torch.int32).contiguous()
    # fp32 scratch: the QKV partials, the kv splits' (m, l, acc), the o-proj partials
    sizes = (s_qkv * BK * N3, s_kv * BK * Hq, s_kv * BK * Hq, s_kv * BK * Hq * D, s_o * BK * H)
    base = _cuda.scratch(sum(sizes), dev, stream).data_ptr()
    parts = []
    for n in sizes:
        parts.append(base)
        base += 4 * n
    counters = _cuda.counters(B * Hkv + -(-H // GEMV_COLS), dev, stream)
    attn = torch.empty((BK, Hq * D), dtype=x.dtype, device=dev)
    out = torch.empty_like(x)
    k_new = torch.empty((B, K, Hkv, D), dtype=x.dtype, device=dev)
    v_new = torch.empty_like(k_new)
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _cuda.function(ATTN_KERNEL, "nxdi_fused_attn_block", [P] * 21 + [I] * 20 + [Fl, Fl, P])
    qkv_part, m_part, l_part, acc_part, o_part = parts
    err = fn(
        x.data_ptr(), gamma.data_ptr(), wqkv.data_ptr(), wout.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(), slots.data_ptr(), mask.data_ptr(), pos.data_ptr(),
        qkv_part, m_part, l_part, acc_part, attn.data_ptr(), o_part, counters.data_ptr(),
        out.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        B, K, H, Hq, Hkv, D, L, R, S_max, S_kv, int(layer_idx), mask.stride(0), mask.stride(2),
        s_qkv, kps_qkv, s_kv, per, s_o, kps_o, _DTYPE_CODES[x.dtype],
        float(scale), float(eps), stream,
    )
    _cuda.check(err, ATTN_KERNEL)
    _cuda.count(ATTN_KERNEL)
    return out, k_new, v_new


def mlp_plan(H: int, I: int, rows: int, elt: int, sms: int):
    """B9's launch plan: ((gate/up splits, rows of H each), (down splits,
    rows of I each), the fp32 scratch sizes in values (the gate and up
    partials, act (rows, I) in ``elt``-byte values, the down partials;
    each a whole number of 16 bytes), the completion counters (one per
    GEMV_COLS columns of I, then of H))."""
    gu, dn = gemv_split(I, H, sms), gemv_split(H, I, sms)

    def whole16(n):  # fp32 values, rounded up to 16 bytes
        return -(-n // 4) * 4

    sizes = (whole16(2 * gu[0] * rows * I), whole16(-(-rows * I * elt // 4)), whole16(dn[0] * rows * H))
    return gu, dn, sizes, -(-I // GEMV_COLS) + -(-H // GEMV_COLS)


def _launch_mlp(x, gamma, w_gate, w_up, w_down, eps, act):
    name = MLP_KERNEL
    _same_dtype(name, x, gamma=gamma, w_gate=w_gate, w_up=w_up, w_down=w_down)
    if len({t.device for t in (x, gamma, w_gate, w_up, w_down)}) != 1:
        raise ValueError(f"{name}: inputs on more than one device")
    B, K, H = x.shape
    I = w_gate.shape[1]
    BK = B * K
    dev = x.device
    (s_gu, kps_gu), (s_d, kps_d), sizes, n_counters = mlp_plan(H, I, BK, x.element_size(), _cuda.sm_count(dev))
    stream = _cuda.stream_ptr(dev)
    x = x.contiguous()
    # scratch and counters held by _cuda per stream, never allocated per call
    base = _cuda.scratch(sum(sizes), dev, stream).data_ptr()
    gu_part, act_buf, d_part = base, base + 4 * sizes[0], base + 4 * (sizes[0] + sizes[1])
    counters = _cuda.counters(n_counters, dev, stream)
    out = torch.empty_like(x)
    P, Ci = ctypes.c_void_p, ctypes.c_int
    fn = _cuda.function(MLP_KERNEL, "nxdi_fused_mlp_block", [P] * 10 + [Ci] * 9 + [ctypes.c_float, P])
    err = fn(
        x.data_ptr(), gamma.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        gu_part, act_buf, d_part, counters.data_ptr(), out.data_ptr(),
        BK, H, I, s_gu, kps_gu, s_d, kps_d, _DTYPE_CODES[x.dtype], _ACT_CODES[act],
        float(eps), stream,
    )
    _cuda.check(err, MLP_KERNEL)
    _cuda.count(MLP_KERNEL)
    return out


def fused_attn_block(
    x: torch.Tensor,  # (B, K, H) residual-stream input (pre-norm)
    gamma: torch.Tensor,  # (H,) input_layernorm weight
    wqkv: torch.Tensor,  # (H, (Hq + 2 Hkv) D) fused QKV weight
    wout: torch.Tensor,  # (Hq D, H) output projection weight
    cos: torch.Tensor,  # (B, K, D/2)
    sin: torch.Tensor,
    k_cache: torch.Tensor,  # (L, R, S_max, Hkv, D) the full stacked cache
    v_cache: torch.Tensor,
    layer_idx: int,
    slot_ids: torch.Tensor,  # (B,) cache line per row
    mask: torch.Tensor,  # (B, 1, K, S_kv) decode mask, this step's slots included
    positions: torch.Tensor,  # (B, K) positions of the new tokens
    *,
    scale: float,
    eps: float,
    n_kv: int,
):
    """The fused decode attention block. Returns (hidden (B, K, H) with the
    residual added, k_new (B, K, Hkv, D), v_new (B, K, Hkv, D)); the caller
    scatters k_new / v_new into the cache. CUDA tensors launch B8 (or raise
    on what it does not take); CPU tensors take the plain version."""
    args = (x, gamma, wqkv, wout, cos, sin, k_cache, v_cache, layer_idx, slot_ids, mask, positions)
    _check_attn(*args, n_kv)
    if not launches_kernel(x, gamma, wqkv, wout, cos, sin, k_cache, v_cache, slot_ids, mask, positions):
        return fused_attn_block_plain(*args, scale=scale, eps=eps, n_kv=n_kv)
    return _launch_attn(*args, scale, eps, n_kv)


def fused_mlp_block(
    x: torch.Tensor,  # (B, K, H) residual-stream input (pre-norm)
    gamma: torch.Tensor,  # (H,) post_attention_layernorm weight
    w_gate: torch.Tensor,  # (H, I)
    w_up: torch.Tensor,  # (H, I)
    w_down: torch.Tensor,  # (I, H)
    *,
    eps: float,
    act: str = "silu",
) -> torch.Tensor:
    """The fused decode MLP block: ``x + down(act(gate) * up)`` of the
    rms-normed input. CUDA tensors launch B9 (or raise on what it does not
    take); CPU tensors take the plain version."""
    _check_mlp(x, gamma, w_gate, w_up, w_down, act)
    if not launches_kernel(x, gamma, w_gate, w_up, w_down):
        return fused_mlp_block_plain(x, gamma, w_gate, w_up, w_down, eps=eps, act=act)
    return _launch_mlp(x, gamma, w_gate, w_up, w_down, eps, act)
