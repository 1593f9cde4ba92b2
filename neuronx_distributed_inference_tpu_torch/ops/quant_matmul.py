"""Grouped-int4 weights and the int4 fused-dequant matmul, kernel B6
(counterpart of the reference's ``ops/quant_matmul.py``).

Packed layout (every int4 entry of a param tree)
------------------------------------------------
A logical weight ``(..., K, N)`` quantizes symmetrically per
``(group, out_channel)`` with groups of :data:`INT4_GROUP` along the input
axis. K is zero-padded up to ``Kp``, the next multiple of ``2 * group``,
and stored as

- ``weight``: uint8 ``(..., Kp/2, N)``, **midpoint split**: byte row ``j``
  holds code ``k = j`` in its low nibble and code ``k = Kp/2 + j`` in its
  high nibble, so each nibble plane is a contiguous range of rows and every
  group lies inside one plane;
- ``scale``: float32 ``(..., Kp/group, N)``; groups ``0 .. Kp/2/group - 1``
  cover the low plane, the rest the high plane.

Codes are ``q + 8`` with ``q = clip(round(w / s), -7, 7)``; the pad byte
0x88 dequantizes to exactly 0, and ``w ~ (code - 8) * s``.

B6
--
:func:`quant_matmul` computes ``x @ dequant(packed, scale)`` for a
decode-sized row count without the dequantized matrix ever existing in
memory: each group's partial dot is taken on the codes in fp32 and
multiplied by that group's scale after the dot, as the TPU kernel does. On
a CUDA tensor it launches ``csrc/quant_matmul.cu`` (and raises on what the
kernel does not take); on a CPU tensor it runs :func:`quant_matmul_plain`,
the reference's ``int4_matmul_native``. Calls with more than
:data:`QMM_MAX_ROWS` rows (prefill) take :func:`int4_matmul_dense`: on a
card, the weight dequantized to the activation dtype and one ``torch.matmul``,
counted apart as ``int4_dense`` (``ops/_cuda.py``).
"""

from __future__ import annotations

import ctypes

import torch

from neuronx_distributed_inference_tpu_torch.ops import _cuda
from neuronx_distributed_inference_tpu_torch.ops.kernel_mode import QMM_MAX_ROWS, launches_kernel

KERNEL = "quant_matmul"

#: default scale-group size along the input axis (the reference's)
INT4_GROUP = 128

#: symmetric 4-bit range: codes are q + 8 with q in [-7, 7]
INT4_QMAX = 7.0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def quantize_tensor_int4(w: torch.Tensor, group_size: int = INT4_GROUP) -> dict:
    """Quantize ``(..., K, N)`` to the packed int4 entry ``{"weight": uint8
    (..., Kp/2, N), "scale": f32 (..., Kp/group, N)}`` on ``w``'s device.
    Codes and scales equal the reference's bit for bit: fp32 division and
    round-half-to-even, as ``np.round``/``jnp.round``."""
    wf = w.to(torch.float32)
    *lead, K, N = wf.shape
    span = 2 * group_size
    Kp = -(-K // span) * span
    if Kp != K:
        wf = torch.nn.functional.pad(wf, (0, 0, 0, Kp - K))
    n_g = Kp // group_size
    wg = wf.reshape(*lead, n_g, group_size, N)
    del wf
    scale = wg.abs().amax(dim=-2).clamp_min(1e-8) / INT4_QMAX  # (..., nG, N)
    q = (wg / scale[..., None, :]).round_().clamp_(-INT4_QMAX, INT4_QMAX).add_(8)
    codes = q.to(torch.uint8).reshape(*lead, Kp, N)
    del q
    k2 = Kp // 2
    return {"weight": codes[..., :k2, :] | (codes[..., k2:, :] << 4), "scale": scale}


def is_int4_entry(entry) -> bool:
    """Packed-int4 discriminator: no other weight format stores uint8."""
    return (
        isinstance(entry, dict)
        and "scale" in entry
        and "weight" in entry
        and entry["weight"].dtype == torch.uint8
    )


def _codes(packed: torch.Tensor) -> torch.Tensor:
    """(..., Kp/2, N) packed bytes -> (..., Kp, N) signed codes in fp32."""
    c = packed.to(torch.int32)
    return torch.cat([(c & 15) - 8, (c >> 4) - 8], dim=-2).to(torch.float32)


def dequantize_int4(packed: torch.Tensor, scale: torch.Tensor, k: int = None,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Unpack ``(..., Kp/2, N)`` codes and ``(..., Kp/G, N)`` scales back to
    the logical ``(..., k, N)`` weight (pad rows sliced off when ``k`` is
    given); leading dims pass through."""
    k2, n = packed.shape[-2], packed.shape[-1]
    kp = 2 * k2
    n_g = scale.shape[-2]
    w = _codes(packed)
    lead = w.shape[:-2]
    w = (w.reshape(*lead, n_g, kp // n_g, n) * scale[..., None, :]).reshape(*lead, kp, n)
    if k is not None and k != kp:
        w = w[..., :k, :]
    return w.to(dtype)


def quant_matmul_plain(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """B6's plain version, the reference's ``int4_matmul_native``: the fp32
    dot of each group on the codes, that group's scale after the dot, the
    groups summed, then a cast to ``x.dtype``."""
    if packed.dim() != 2:
        raise ValueError(
            f"int4 matmul takes a 2D packed weight, got {tuple(packed.shape)} "
            "(select the layer before the matmul)"
        )
    k = x.shape[-1]
    k2, n = packed.shape
    kp = 2 * k2
    n_g = scale.shape[-2]
    xf = x.to(torch.float32)
    if kp != k:
        xf = torch.nn.functional.pad(xf, (0, kp - k))
    xg = xf.reshape(*xf.shape[:-1], n_g, kp // n_g)
    wg = _codes(packed).reshape(n_g, kp // n_g, n)
    y = torch.einsum("...ng,ngo->...no", xg, wg)
    y = torch.einsum("...no,no->...o", y, scale.to(torch.float32))
    # contiguous, as x @ W is: a fused QKV output is split into views
    return y.to(x.dtype).contiguous()


def int4_matmul_dense(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The route of calls with more rows than B6 takes (the reference's
    native path outside Pallas, ``ops/quant.py:163``). On a card: the weight
    dequantized to ``x.dtype`` and one large ``torch.matmul``, counted as
    ``int4_dense``; on the CPU: :func:`quant_matmul_plain`."""
    if not launches_kernel(x, packed, scale):
        return quant_matmul_plain(x, packed, scale)
    w = dequantize_int4(packed, scale, x.shape[-1], x.dtype)
    _cuda.ROUTES["int4_dense"] += 1
    return torch.matmul(x, w)


def _check(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> None:
    """What B6 takes: a 2D uint8 packed weight with its f32 scales of shape
    (Kp/128, N), Kp a multiple of 256, 1 <= K <= Kp, bf16 or fp32
    activations."""
    if packed.dim() != 2 or packed.dtype != torch.uint8:
        raise ValueError(f"quant_matmul: packed {tuple(packed.shape)} {packed.dtype} != uint8 (Kp/2, N)")
    k2, n = packed.shape
    kp = 2 * k2
    if kp % (2 * INT4_GROUP) or kp == 0:
        raise ValueError(f"quant_matmul: packed K {kp} is not a positive multiple of {2 * INT4_GROUP}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (kp // INT4_GROUP, n):
        raise ValueError(
            f"quant_matmul: scale {tuple(scale.shape)} {scale.dtype} != float32 {(kp // INT4_GROUP, n)} "
            f"(groups of {INT4_GROUP})"
        )
    k = x.shape[-1]
    if not 1 <= k <= kp:
        raise ValueError(f"quant_matmul: x has K {k}, the packed weight {kp}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"quant_matmul: x dtype {x.dtype} (bf16 or fp32)")


def _launch(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    k = x.shape[-1]
    lead = x.shape[:-1]
    rows = x.numel() // k
    k2, n = packed.shape
    if not 1 <= rows <= QMM_MAX_ROWS:
        raise ValueError(f"quant_matmul: {rows} rows (B6 takes 1 to {QMM_MAX_ROWS})")
    for arg, t in (("x", x), ("packed", packed), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"quant_matmul: {arg} must be contiguous")
    if len({x.device, packed.device, scale.device}) != 1:
        raise ValueError(f"quant_matmul: inputs on {x.device}, {packed.device}, {scale.device}")
    out = torch.empty((*lead, n), dtype=x.dtype, device=x.device)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _cuda.function(KERNEL, "nxdi_quant_matmul", [P, P, P, P] + [I] * 6 + [P])
    # 4-byte code loads need N % 4 == 0 and an aligned base; the kernel reads
    # byte by byte otherwise
    vec = int(n % 4 == 0 and packed.data_ptr() % 4 == 0)
    err = fn(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
        rows, k, k2, n, _DTYPE_CODES[x.dtype], vec, _cuda.stream_ptr(x.device),
    )
    _cuda.check(err, KERNEL)
    _cuda.LAUNCHES[KERNEL] += 1
    return out


def quant_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Fused-dequant ``x @ dequant(packed, scale)``: x (..., K) with at most
    64 rows, packed (Kp/2, N) uint8, scale (Kp/128, N) f32; returns
    (..., N) in ``x.dtype``. CUDA tensors launch B6 (or raise on what it
    does not take); CPU tensors take the plain version."""
    _check(x, packed, scale)
    if not launches_kernel(x, packed, scale):
        return quant_matmul_plain(x, packed, scale)
    return _launch(x, packed, scale)
