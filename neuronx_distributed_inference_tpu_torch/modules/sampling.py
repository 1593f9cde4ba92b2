"""Sampling (counterpart of the reference's ``modules/sampling.py``).

- Per-request params ride as a ``(B, 3) = [top_k, top_p, temperature]``
  tensor.
- Greedy = argmax over the logits (the first maximum).
- Multinomial = temperature -> a static-width top-k window -> per-row
  dynamic-k mask -> top-p cumulative-probability mask -> a categorical draw
  (:func:`sample`), from an explicit ``torch.Generator`` the application
  owns. The draw is the Gumbel-max form of the reference's
  ``jax.random.categorical``; the two generators give different numbers
  from one seed, so the tests compare distributions
  (:func:`warped_probs`).
"""

from __future__ import annotations

from typing import Optional

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


def _warped_window(logits: torch.Tensor, sampling_params: torch.Tensor, max_topk: int):
    """Temperature / top-k / top-p warping, shared by :func:`sample` and
    :func:`warped_probs` so the two agree exactly: logits (B, V) ->
    (masked window logits (B, k_width), window token ids (B, k_width)).

    The window is the ``min(max_topk, V)`` largest logits, sorted
    descending with ties in index order (``jax.lax.top_k``'s order, by a
    stable sort)."""
    V = logits.shape[-1]
    top_k = sampling_params[:, 0]
    top_p = sampling_params[:, 1]
    temperature = torch.clamp(sampling_params[:, 2], min=1e-6)

    logits = logits.float() / temperature[:, None]
    k_width = min(max_topk, V)
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    top_vals, top_idx = vals[:, :k_width], idx[:, :k_width]

    # per-row dynamic top-k (top_k <= 0 disables it)
    ranks = torch.arange(k_width, device=logits.device)[None, :]
    k_eff = torch.where(top_k <= 0, torch.full_like(top_k, k_width), top_k)[:, None]
    keep_k = ranks < k_eff

    # nucleus over the sorted window: a token stays while the probability
    # before it is still below top_p
    probs = torch.softmax(top_vals.masked_fill(~keep_k, float("-inf")), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_p = (cum - probs) < top_p[:, None]

    keep = keep_k & keep_p
    keep[:, 0] = True  # the argmax always stays
    return top_vals.masked_fill(~keep, float("-inf")), top_idx


def sample(
    logits: torch.Tensor,
    sampling_params: torch.Tensor,
    generator: Optional[torch.Generator],
    max_topk: int = 256,
    do_sample: bool = True,
) -> torch.Tensor:
    """Next tokens from logits (B, V): greedy without ``do_sample`` or a
    generator, else one draw per row from the warped window (Gumbel-max:
    the argmax of the window logits plus Gumbel noise from ``generator``).
    Returns int32 (B,)."""
    if not do_sample or generator is None:
        return greedy_sample(logits)
    masked, top_idx = _warped_window(logits, sampling_params, max_topk)
    u = torch.rand(masked.shape, generator=generator, device=masked.device, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))
    choice = torch.argmax(masked + gumbel, dim=-1, keepdim=True)
    return torch.take_along_dim(top_idx, choice, dim=1)[:, 0].to(torch.int32)


def warped_probs(logits: torch.Tensor, sampling_params: torch.Tensor, max_topk: int = 256) -> torch.Tensor:
    """The full-vocab distribution :func:`sample` draws from: logits (B, V)
    -> probs (B, V) fp32, zero outside the kept window."""
    masked, top_idx = _warped_window(logits, sampling_params, max_topk)
    window = torch.softmax(masked, dim=-1)
    full = torch.zeros(logits.shape, dtype=torch.float32, device=logits.device)
    return full.scatter_(1, top_idx, window)


def sample_tokens(
    logits: torch.Tensor,
    sampling_params: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    max_topk: int = 256,
    do_sample: bool = False,
) -> torch.Tensor:
    """Tokens from logits (B, V) or (B, K, V): :func:`sample` per position,
    each position of a row with the row's params."""
    if not do_sample or generator is None:
        return greedy_sample(logits)
    if logits.ndim == 2:
        return sample(logits, sampling_params, generator, max_topk, do_sample)
    B, K, V = logits.shape
    params = torch.repeat_interleave(sampling_params, K, dim=0)
    return sample(logits.reshape(B * K, V), params, generator, max_topk, do_sample).reshape(B, K)
