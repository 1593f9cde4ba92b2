"""Weight quantization: int8 / fp8 per-channel, per-tensor and blockwise
symmetric, and the grouped int4 format (counterpart of the reference's
``ops/quant.py``; its partition-spec helpers wait for ROADMAP A10 and its
checkpoint save/load for A11).

Quantized linears store ``{"weight": codes (..., in, out), "scale": ...}``:
int8/fp8 codes with ``(..., out)`` per-channel or ``(..., 1)`` per-tensor
scales, applied AFTER the product (exact for a symmetric per-output-channel
scale); blockwise ``(..., in / block, out)`` scales applied per block's
partial product; or the packed int4 entry of ``ops/quant_matmul.py``
(uint8 codes, ``(..., Kp / 128, out)`` scales). :func:`linear` applies any of
them, so quantization is transparent to the model code.

Quantize-at-load runs in torch on the device that holds the params, one
leaf at a time, each stacked leaf in slices along its leading axes
(:func:`quantize_sliced`), and each source leaf is dropped as soon as its
quantized form exists. Codes and scales equal the reference's bit for bit
(fp32 division, round half to even).
"""

from __future__ import annotations

from typing import Sequence

import torch

from neuronx_distributed_inference_tpu_torch.ops import quant_matmul as qmm
from neuronx_distributed_inference_tpu_torch.ops.kernel_mode import quant_matmul_off, use_quant_matmul

QUANT_DTYPES = {
    "int8": torch.int8,
    "fp8": torch.float8_e4m3fn,
    "float8_e4m3": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}

#: param-tree keys never quantized (the reference's): every other linear,
#: the lm head included, converts; norms, the embedding, rope, routers and
#: sinks stay in the compute dtype
DEFAULT_SKIP = ("embed_tokens", "rope", "norm", "input_layernorm",
                "post_attention_layernorm", "q_norm", "k_norm", "router", "sink")


def _qmax(dt: torch.dtype) -> float:
    return 127.0 if dt == torch.int8 else float(torch.finfo(dt).max)


def _to_codes(q: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """fp32 quotients -> codes: int8 rounds half to even and clips to
    [-127, 127]; fp8 casts (round to nearest even)."""
    if dt == torch.int8:
        q = q.round_().clamp_(-127, 127)
    return q.to(dt)


def quantize_tensor(w: torch.Tensor, quant_dtype: str = "int8", per_channel: bool = True) -> dict:
    """Symmetric quantization along the last (output) axis: returns
    ``{"weight": q, "scale": s}`` with w ~ q * s. Per channel reduces only
    the input axis (-2), so stacked (L, ..., in, out) leaves keep one scale
    per (leading dims, out); per tensor reduces the last two axes of each
    leading slice, scale (..., 1)."""
    dt = QUANT_DTYPES[quant_dtype]
    wf = w.to(torch.float32)
    if per_channel:
        absmax = wf.abs().amax(dim=-2)  # (..., out)
    else:
        absmax = wf.abs().amax(dim=(-2, -1), keepdim=True)[..., 0]  # (..., 1)
    scale = absmax.clamp_min(1e-8) / _qmax(dt)
    return {"weight": _to_codes(wf / scale[..., None, :], dt), "scale": scale}


def quantize_tensor_blockwise(w: torch.Tensor, quant_dtype: str = "int8", block_size: int = 128) -> dict:
    """Symmetric blockwise quantization: the input axis (-2) splits into
    blocks of ``block_size``, one scale per (block, out channel). Returns
    ``{"weight": q (..., in, out), "scale": s (..., in / block_size, out)}``."""
    dt = QUANT_DTYPES[quant_dtype]
    wf = w.to(torch.float32)
    *lead, d_in, d_out = wf.shape
    if d_in % block_size != 0:
        raise ValueError(
            f"blockwise quantization needs in-dim {d_in} divisible by block_size {block_size}"
        )
    wb = wf.reshape(*lead, d_in // block_size, block_size, d_out)
    scale = wb.abs().amax(dim=-2).clamp_min(1e-8) / _qmax(dt)  # (..., nb, out)
    q = _to_codes(wb / scale[..., None, :], dt)
    return {"weight": q.reshape(*lead, d_in, d_out), "scale": scale}


def is_quantized_leaf(entry) -> bool:
    return isinstance(entry, dict) and "scale" in entry and "weight" in entry


def linear(entry: dict, x: torch.Tensor) -> torch.Tensor:
    """Apply a (possibly quantized) linear weight, ``x @ W``, dispatching in
    the reference's order: packed int4 (uint8) first, then blockwise, then
    per-channel / per-tensor, then a plain weight.

    int4 calls route by row count (``kernel_mode.use_quant_matmul``): at
    most 64 rows go to B6 (``quant_matmul``), larger calls to the dense
    route (``int4_matmul_dense``); ``quant_matmul_mode(False)`` sends every
    call to the plain version. The int8 / fp8 products stay plain PyTorch,
    the codes cast to ``x.dtype`` and the scale applied after the product,
    as the reference leaves them to XLA."""
    w = entry["weight"]
    if w.dtype == torch.uint8:
        s = entry["scale"]
        if use_quant_matmul(x.numel() // x.shape[-1]):
            return qmm.quant_matmul(x.contiguous(), w, s)
        if quant_matmul_off():
            return qmm.quant_matmul_plain(x, w, s)
        return qmm.int4_matmul_dense(x, w, s)
    if "scale" in entry:
        s = entry["scale"]
        if s.dim() == w.dim():  # blockwise: (..., nb, out) for w (..., in, out)
            nb = s.shape[-2]
            bs = w.shape[-2] // nb
            xb = x.reshape(*x.shape[:-1], nb, bs)
            wb = w.reshape(*w.shape[:-2], nb, bs, w.shape[-1])
            y = torch.einsum("...nb,nbo->...no", xb, wb.to(x.dtype))
            return torch.einsum("...no,no->...o", y, s.to(x.dtype)).contiguous()
        return (x @ w.to(x.dtype)) * s.to(x.dtype)
    return x @ w


def quantize_params(
    params: dict,
    quant_dtype: str = "int8",
    block_size: int = 0,
    per_channel: bool = True,
    skip: Sequence[str] = DEFAULT_SKIP,
    min_ndim: int = 2,
) -> dict:
    """Quantize every eligible ``weight`` leaf of the param tree in place:
    a dict holding a ``weight`` of at least ``min_ndim`` dims and no
    ``scale``, none of whose path keys is in ``skip`` or is ``bias``.
    ``quant_dtype="int4"`` packs the grouped int4 format (groups of
    ``block_size``); a nonzero ``block_size`` quantizes blockwise. One leaf
    at a time, in slices (:func:`quantize_sliced`): each source weight's
    last reference goes as soon as its quantized form exists, so the peak is
    the params plus one leaf's codes plus one slice's fp32 transient."""
    eligible = []

    def walk(node, path):
        if isinstance(node, dict):
            if (
                "weight" in node
                and "scale" not in node
                and not any(s in path for s in skip)
                and isinstance(node["weight"], torch.Tensor)
                and node["weight"].dim() >= min_ndim
                and "bias" not in path
            ):
                eligible.append(node)
                return
            for k in list(node):
                walk(node[k], path + (k,))

    walk(params, ())
    if quant_dtype == "int4":
        def fn(w):
            return qmm.quantize_tensor_int4(w, block_size or qmm.INT4_GROUP)
    elif block_size:
        def fn(w):
            return quantize_tensor_blockwise(w, quant_dtype, block_size)
    else:
        def fn(w):
            return quantize_tensor(w, quant_dtype, per_channel)
    for node in eligible:
        q = quantize_sliced(node["weight"], fn)
        node["weight"] = q["weight"]  # the source leaf's last reference goes
        node["scale"] = q["scale"]
        del q
    return params


#: fp32 elements one slice of :func:`quantize_sliced` may upcast at once
#: (256 MiB)
SLICE_ELEMENTS = 1 << 26


def quantize_sliced(w: torch.Tensor, fn, slice_elements: int = SLICE_ELEMENTS) -> dict:
    """``fn`` (a quantizer returning ``{"weight", "scale"}``) applied to
    ``w`` in slices along its leading (layer, expert) axes, each slice as
    many whole trailing ``(in, out)`` matrices as fit ``slice_elements``,
    its codes and scales written into outputs allocated once. Every scale
    this package makes reduces inside one trailing matrix, so the result
    is the whole-leaf quantize's bit for bit; the transient is one slice's
    fp32 upcast instead of the whole leaf's (Qwen3-30B-A3B's stacked expert
    leaf is 18 GiB in bf16, 36 GiB in fp32)."""
    if w.dim() <= 2:
        return fn(w)
    lead = w.shape[:-2]
    flat = w.reshape(-1, *w.shape[-2:])
    n = flat.shape[0]
    step = max(1, slice_elements // max(1, w.shape[-2] * w.shape[-1]))
    if step >= n:
        return fn(w)
    out = None
    for i in range(0, n, step):
        q = fn(flat[i : i + step])
        if out is None:
            out = {k: v.new_empty((n, *v.shape[1:])) for k, v in q.items()}
        for k, v in q.items():
            out[k][i : i + step] = v
        del q
    return {k: v.reshape(*lead, *v.shape[1:]) for k, v in out.items()}


def skip_keys(tc) -> tuple:
    """The param-tree keys quantize-at-load leaves alone: the config's
    ``modules_to_not_convert``, else :data:`DEFAULT_SKIP`."""
    return tuple(tc.modules_to_not_convert) if tc.modules_to_not_convert else DEFAULT_SKIP


def prepare_quantized_params(params: dict, tc) -> dict:
    """``quantized=True`` quantize-at-load with the config's recipe: int8 or
    fp8, per channel, per tensor or blockwise."""
    blockwise = tc.quantization_type == "blockwise"
    return quantize_params(
        params,
        tc.quantization_dtype,
        per_channel=tc.quantization_type != "per_tensor_symmetric",
        skip=skip_keys(tc),
        block_size=tc.blockwise_matmul_block_size if blockwise else 0,
    )


def prepare_int4_params(params: dict, tc) -> dict:
    """``weight_dtype="int4"`` quantize-at-load: every eligible weight packs
    to the grouped int4 format (uint8 codes, per-(group, out) f32 scales)."""
    return quantize_params(params, "int4", skip=skip_keys(tc), block_size=qmm.INT4_GROUP)
