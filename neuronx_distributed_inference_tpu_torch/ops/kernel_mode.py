"""Kernel dispatch of the port (counterpart of the reference's
``ops/kernel_mode.py``).

The reference's gates are Mosaic tile rules (seq a multiple of 128,
``kv_width >= 512``) plus an ``on_tpu()`` auto condition; none of them
carries over. Here the config tri-states decide alone:

- ``None`` or ``True``: the CUDA kernel. Its wrapper launches it for a CUDA
  tensor (or raises on a shape it does not take) and uses the plain version
  only for a tensor that lies on the CPU.
- ``False``: the plain PyTorch path, and only because the caller set it.
"""

from __future__ import annotations

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


def launches_kernel(*tensors: torch.Tensor) -> bool:
    """True when a wrapper must launch its CUDA kernel, False when its
    inputs lie on the CPU (plain version). Mixed or other devices raise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"kernel inputs must all be on CUDA or all on the CPU, got {sorted(kinds)}")
