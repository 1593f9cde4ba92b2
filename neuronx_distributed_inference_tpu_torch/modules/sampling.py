"""Sampling (counterpart of the reference's ``modules/sampling.py``; the
greedy path — multinomial sampling waits for ROADMAP A3b)."""

from __future__ import annotations

import numpy as np
import torch


def prepare_sampling_params(
    batch_size: int,
    top_k=1,
    top_p=1.0,
    temperature=1.0,
) -> np.ndarray:
    """Build the (B, 3) [top_k, top_p, temperature] params array."""

    def _col(v, default):
        arr = np.asarray(v if v is not None else default, dtype=np.float32)
        if arr.ndim == 0:
            arr = np.full((batch_size,), float(arr), dtype=np.float32)
        if arr.shape != (batch_size,):
            raise ValueError(f"sampling param shape {arr.shape} != ({batch_size},)")
        return arr

    return np.stack([_col(top_k, 1), _col(top_p, 1.0), _col(temperature, 1.0)], axis=1)


def validate_sampling_params(params: np.ndarray, max_topk: int) -> None:
    top_k, top_p, temperature = params[:, 0], params[:, 1], params[:, 2]
    if np.any((top_k < -1) | (top_k == 0) | (top_k > max_topk)):
        raise ValueError(f"top_k must be -1 (disabled) or in [1, {max_topk}]")
    if np.any((top_p <= 0) | (top_p > 1.0)):
        raise ValueError("top_p must be in (0, 1]")
    if np.any(temperature < 0):
        raise ValueError("temperature must be >= 0")


def mask_padded_logits(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Fill the padded vocab tail with the dtype's most negative finite value."""
    pad = logits.shape[-1] - vocab_size
    if pad <= 0:
        return logits
    keep = torch.arange(logits.shape[-1], device=logits.device) < vocab_size
    return torch.where(keep, logits, torch.finfo(logits.dtype).min)


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the last axis (the first maximum, like jnp.argmax) ->
    int32 tokens."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_tokens(
    logits: torch.Tensor,
    sampling_params=None,
    generator=None,
    max_topk: int = 256,
    do_sample: bool = False,
) -> torch.Tensor:
    """Tokens from logits (B, V) or (B, K, V): the greedy branch."""
    if do_sample:
        raise NotImplementedError(
            "multinomial sampling is not ported to PyTorch yet (ROADMAP A3b)"
        )
    return greedy_sample(logits)
