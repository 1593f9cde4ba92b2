"""Kernel dispatch of the port (counterpart of the reference's
``ops/kernel_mode.py``).

The reference's gates are Mosaic tile rules (seq a multiple of 128,
``kv_width >= 512``) plus an ``on_tpu()`` auto condition; none of them
carries over. Here the config tri-states decide alone:

- ``None`` or ``True``: the CUDA kernel. Its wrapper launches it for a CUDA
  tensor (or raises on a shape it does not take) and uses the plain version
  only for a tensor that lies on the CPU.
- ``False``: the plain PyTorch path, and only because the caller set it.

int4 projections route by their row count (:func:`use_quant_matmul`): at
most :data:`QMM_MAX_ROWS` rows go to the B6 kernel's wrapper, more to the
dense route; ``quant_matmul_mode(False)`` (the reference's mode knob) sends
every call to the plain version.

MoE decode routes by :func:`use_moe_tkg`: the B7 kernel's wrapper for plain
experts and at most :data:`MOE_TKG_MAX_ROWS` (token, selection) rows. Here
``moe_fused_kernel_enabled=None`` means the kernel; in the reference it
means off (its kernel lost to XLA on the TPU at batch 1).

The fused decode layer routes by :func:`use_fused_attn_block` (B8) and
:func:`use_fused_mlp` (B9). For these two, unlike B1-B7, only ``True``
means the kernel: ``None`` and ``False`` mean off, as in the reference
(its ``None`` is "auto", which is off). Keeping them off by default leaves
every other path's kernel launches as they were.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch


def use_flash(spec) -> bool:
    """Prefill attention through the B2 flash kernel's wrapper."""
    return spec.use_flash_kernel is not False


def use_tkg(spec) -> bool:
    """Decode attention through the B1 (contiguous) or B4 (paged) kernel's
    wrapper."""
    return spec.use_tkg_kernel is not False


#: shortest multi-token pass the paged flash kernel (B5) takes; shorter
#: passes on the paged cache (decode, speculation) go to B4
PAGED_FLASH_MIN_Q = 8


def use_paged_flash(spec, q_len: int) -> bool:
    """Attention over the paged cache through the B5 paged flash kernel's
    wrapper: the reference's routing rule (``ops/kernel_mode.py:162-172``)
    without its tile gates — q_len >= 8 goes to B5, shorter passes to B4,
    and ``use_flash_kernel=False`` turns B5 off."""
    return spec.use_flash_kernel is not False and q_len >= PAGED_FLASH_MIN_Q


def use_ragged(spec) -> bool:
    """Mixed-step attention through the B3 ragged kernel's wrapper
    (reference ``ops/kernel_mode.py:208-232``). Its head_dim, tile-alignment
    and model-parallel gates do not carry over: the wrapper raises on a
    packed length that is not a multiple of 16 and on a head_dim the kernel
    does not take, and only ``use_flash_kernel=False`` selects the plain
    path."""
    return spec.use_flash_kernel is not False


# int4 fused-dequant matmul (B6) dispatch mode: a stack whose last entry
# rules, [base, *context overrides] (the reference's _QMM_MODE). "auto" and
# True take the kernel; False the plain version, on any device.
_QMM_MODE: list = ["auto"]

#: the largest row count B6 takes (the reference's decode-sized gate)
QMM_MAX_ROWS = 64


def _check_qmm_mode(mode) -> None:
    if mode not in ("auto", True, False):
        raise ValueError(f"quant matmul mode must be 'auto'/True/False, got {mode!r}")


def set_quant_matmul_mode(mode) -> None:
    """Set the process-level base mode: "auto" | True | False."""
    _check_qmm_mode(mode)
    _QMM_MODE[0] = mode


@contextmanager
def quant_matmul_mode(mode):
    """Temporarily override the quant-matmul dispatch mode."""
    _check_qmm_mode(mode)
    _QMM_MODE.append(mode)
    try:
        yield
    finally:
        _QMM_MODE.pop()


def quant_matmul_off() -> bool:
    """True when the caller turned B6 off: every int4 call then takes the
    plain version (the reference's native path), on any device."""
    return _QMM_MODE[-1] is False


def use_quant_matmul(rows: int) -> bool:
    """The reference's routing rule for int4 projections
    (``ops/kernel_mode.py:275-307``) without its TPU gates (lane-aligned N,
    ``k >= 2 * group``, unsharded mesh, ``on_tpu``): a call with at most
    :data:`QMM_MAX_ROWS` rows goes to B6's wrapper, which masks any N and K
    itself. Larger calls (prefill, wide mixed steps) take the dense route."""
    return not quant_matmul_off() and rows <= QMM_MAX_ROWS


#: the largest (token, selection) row count B7 takes (the reference's
#: decode-sized gate, ``T * k <= 64``)
MOE_TKG_MAX_ROWS = 64


def use_moe_tkg(spec, params: dict, n_tokens: int) -> bool:
    """Decode-sized MoE calls through the B7 kernel's wrapper (the
    reference's ``ops/kernel_mode.py:175-205``; ``spec`` is a MoESpec,
    ``params`` the experts' entries). The structural conditions hold:
    plain bias-free unquantized gate/up/down weights, ``n_tokens * top_k <=
    MOE_TKG_MAX_ROWS``, one expert-parallel rank, no early affinity
    modulation. Its model-parallel condition is the port's single shard.
    ``moe_fused_kernel=False`` takes the dense route; None and True take the
    kernel where the conditions hold, the dense route where they do not."""
    if spec.moe_fused_kernel is False:
        return False
    plain = all(
        isinstance(params.get(k), dict)
        and "weight" in params[k]
        and "scale" not in params[k]
        and "bias" not in params[k]
        for k in ("gate_proj", "up_proj", "down_proj")
    )
    return (
        plain
        and n_tokens * spec.top_k <= MOE_TKG_MAX_ROWS
        and spec.ep_degree == 1
        and not spec.early_affinity_modulation
    )


#: the most new tokens per row the fused attention block takes (the
#: reference's q_len gate)
FUSED_BLOCK_MAX_Q = 16


def use_fused_attn_block(spec, q_len: int) -> bool:
    """The fused decode attention block B8 (``spec`` is an AttnSpec): the
    reference's structural conditions (``ops/decode_block.py:60-86``) of
    at most :data:`FUSED_BLOCK_MAX_Q` new tokens, no qk-norm, no qkv clip
    (DBRX) and no sinks (its qkv/o bias conditions are checked where the
    weights are, ``models/base._plain_weight``).
    Its TPU tile conditions on the kv width do not carry over: the wrapper
    masks the ragged edge and raises on a head_dim it does not take. Only
    ``use_fused_block=True`` turns it on."""
    return (
        spec.use_fused_block is True
        and q_len <= FUSED_BLOCK_MAX_Q
        and not spec.qk_norm
        and spec.qkv_clip is None
        and not spec.has_sink
    )


#: activations of the fused MLP block (every one but silu is the tanh gelu)
FUSED_MLP_ACTS = ("silu", "gelu", "gelu_pytorch_tanh")


def use_fused_mlp(spec) -> bool:
    """The fused decode MLP block B9 (``spec`` is a ModelSpec): rmsnorm and
    an activation the kernel computes; only ``use_fused_mlp=True`` turns
    it on."""
    return spec.use_fused_mlp is True and spec.norm_type == "rmsnorm" and spec.act in FUSED_MLP_ACTS


def launches_kernel(*tensors: torch.Tensor) -> bool:
    """True when a wrapper must launch its CUDA kernel, False when its
    inputs lie on the CPU (plain version). Mixed or other devices raise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"kernel inputs must all be on CUDA or all on the CPU, got {sorted(kinds)}")
