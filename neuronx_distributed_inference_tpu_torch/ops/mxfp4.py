"""MXFP4 (microscaling fp4) expert weights of GPT-OSS checkpoints
(counterpart of the reference's ``ops/mxfp4.py``).

Format (HF gpt-oss checkpoints, ``transformers.integrations.mxfp4``):

- ``*_blocks``: uint8 (..., G, B), two e2m1 fp4 values a byte, the low
  nibble first;
- ``*_scales``: uint8 (..., G), e8m0 shared exponents biased by 127.

The dequantized tensor is (..., G * B * 2) with its last two logical axes
swapped: (E, rows, cols) packed becomes the (E, cols, rows) plain weight.

The reference dequantizes a whole checkpoint to fp32 numpy on the host; for
GPT-OSS-20B that is 19.1 B expert values, 76 GB. Here a packed tensor is
dequantized on the device a slice of its leading axis at a time (a 16-entry
e2m1 table gather times ``exp2(scale - 127)``, the swap, the cast), so the
fp32 temporaries stay one expert's (:func:`dequantize_mxfp4`). e2m1 times a
power of two is exact in fp32, so the fp32 values equal the reference's bit
for bit.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# e2m1 value table (transformers.integrations.mxfp4.FP4_VALUES)
FP4_VALUES = (
    +0.0, +0.5, +1.0, +1.5, +2.0, +3.0, +4.0, +6.0,
    -0.0, -0.5, -1.0, -1.5, -2.0, -3.0, -4.0, -6.0,
)

#: the suffixes of a packed tensor's two parts in an HF state dict
BLOCKS, SCALES = "_blocks", "_scales"


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _dequantize_slice(blocks: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(rows, G, B) uint8 + (rows, G) uint8 -> (cols, rows) fp32."""
    lut = torch.tensor(FP4_VALUES, dtype=torch.float32, device=blocks.device)
    codes = torch.stack([blocks & 0x0F, blocks >> 4], dim=-1).long()  # (rows, G, B, 2)
    vals = lut[codes].reshape(*blocks.shape[:-1], blocks.shape[-1] * 2)  # (rows, G, 2B)
    vals = vals * torch.exp2(scales.float() - 127.0)[..., None]
    return vals.reshape(blocks.shape[0], -1).transpose(0, 1)


def dequantize_mxfp4(blocks, scales, dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """(..., rows, G, B) uint8 blocks + (..., rows, G) uint8 scales (numpy or
    torch) -> (..., cols, rows) in ``dtype`` on ``device`` (the blocks'
    device by default), matching ``transformers``' ``convert_moe_packed_tensors``
    and the reference's ``dequantize_mxfp4``. One slice of the leading axes
    (an expert) is dequantized at a time, so the fp32 temporaries are one
    slice's."""
    if tuple(blocks.shape[:-1]) != tuple(scales.shape):
        raise ValueError(f"blocks {tuple(blocks.shape)} do not match scales {tuple(scales.shape)}")
    device = device if device is not None else (blocks.device if isinstance(blocks, torch.Tensor) else "cpu")
    *lead, rows, G, B = blocks.shape
    out = torch.empty((*lead, G * B * 2, rows), dtype=dtype, device=device)
    flat_out = out.reshape(-1, G * B * 2, rows)
    for i in range(flat_out.shape[0]):
        idx = np.unravel_index(i, lead) if lead else ()
        flat_out[i].copy_(_dequantize_slice(_as_tensor(blocks[idx], device), _as_tensor(scales[idx], device)))
    return out


def dequantize_packed_state_dict(sd: Dict) -> Dict:
    """Replace every ``<name>_blocks`` / ``<name>_scales`` pair of an HF
    state dict by the dequantized plain fp32 ``<name>`` tensor (one tensor
    at a time, each an expert at a time)."""
    sd = dict(sd)
    for name in [k[: -len(BLOCKS)] for k in sd if k.endswith(BLOCKS)]:
        sd[name] = dequantize_mxfp4(sd.pop(name + BLOCKS), sd.pop(name + SCALES))
    return sd


def repack_mxfp4_to_int4(blocks, scales, group_size: int = 128) -> dict:
    """MXFP4 -> the grouped-int4 entry B6 streams (``ops/quant_matmul.
    quantize_tensor_int4``) for one tensor: e2m1 mantissas on a shared e8m0
    exponent do not map exactly onto one int4 grid, so this dequantizes and
    requantizes per (group, out) absmax, as the reference does. The plain
    (E, cols, rows) layout is (E, in, out) for gate / up; the quantizer
    groups the -2 axis."""
    from neuronx_distributed_inference_tpu_torch.ops.quant_matmul import quantize_tensor_int4

    return quantize_tensor_int4(dequantize_mxfp4(blocks, scales), group_size)
