"""Speculative decoding's device functions (counterpart of the reference's
``modules/speculation.py``): draft proposals, verification and the fused
draft + target step.

- :func:`fused_spec_context_encoding`: the target's prefill (its first
  token) then the draft's, both caches written.
- :func:`fused_spec_token_gen`: one decode round, k draft steps (the last
  only writes the final candidate's K/V into the draft cache, which a
  fully accepted round needs) and ONE k-token target pass, then
  :func:`verify_and_accept`. The runtime captures each round as one CUDA
  graph (``runtime/fused_spec.py``).

The caches take write-then-attend writes at exact positions, so a rejected
candidate needs no clean-up: its entry is masked until the position is
generated and written for real.

Greedy proposals and greedy verification reproduce plain greedy decoding
exactly. Sampled: the draft proposes from its warped distribution q and
:func:`speculative_token_selection` accepts d with probability min(1,
p(d)/q(d)) and resamples the residual norm(max(p - q, 0)) at the first
rejection, so the emitted marginal is the target's p (the reference's
``_speculative_token_selection``). Draws come from an explicit
``torch.Generator`` by Gumbel-max, as in ``modules/sampling.py``: the
reference's JAX keys give other numbers, so the tests hold sampled paths
by distribution.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import torch

from neuronx_distributed_inference_tpu_torch.models.base import (
    PHASE_CONTEXT_ENCODING,
    PHASE_TOKEN_GENERATION,
    ModelSpec,
    StepInputs,
    model_logits,
)
from neuronx_distributed_inference_tpu_torch.modules.kvcache import KVCache
from neuronx_distributed_inference_tpu_torch.modules.sampling import sample, warped_probs


@dataclass
class FusedSpecOutput:
    tokens: torch.Tensor  # (B, K) accepted tokens, 0 past counts
    counts: torch.Tensor  # (B,) valid tokens in `tokens` (1..K)
    draft_cache: KVCache
    target_cache: KVCache


def _categorical(probs: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row from ``probs`` (B, V), as ``jax.random.categorical``
    over log(max(p, 1e-30)) draws, by Gumbel-max. Returns int32 (B,)."""
    u = torch.rand(probs.shape, generator=generator, device=probs.device, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))
    return torch.argmax(torch.log(torch.clamp(probs, min=1e-30)) + gumbel, dim=-1).to(torch.int32)


def propose_next(
    dlogits_last: torch.Tensor,  # (B, V) draft logits at the last position
    sampling_params: torch.Tensor,
    generator: Optional[torch.Generator],
    do_sample: bool,
    max_topk: int,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One draft proposal: (token (B, 1) int32, q distribution (B, V) or
    None). The q it draws from is the one acceptance divides by."""
    if do_sample:
        q = warped_probs(dlogits_last, sampling_params, max_topk)
        return _categorical(q, generator)[:, None], q
    return torch.argmax(dlogits_last, dim=-1).to(torch.int32)[:, None], None


def verify_and_accept(
    cand: torch.Tensor,  # (B, k) candidates
    tlogits: torch.Tensor,  # (B, k, V) target logits
    draft_dists: List[torch.Tensor],  # k-1 (B, V) q distributions when sampling
    sampling_params: torch.Tensor,
    generator: Optional[torch.Generator],
    do_sample: bool,
    max_topk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy contiguous-match or multinomial accept/reject: (tokens (B, k)
    zero past the count, counts (B,) in [1, k])."""
    B, k = cand.shape
    if do_sample:
        q = torch.stack(draft_dists, dim=1)  # (B, k-1, V)
        tl = tlogits[..., : q.shape[-1]]
        p = warped_probs(
            tl.reshape(B * k, -1), torch.repeat_interleave(sampling_params, k, dim=0), max_topk
        ).reshape(B, k, -1)
        return speculative_token_selection(cand, q, p, generator)
    greedy = torch.argmax(tlogits, dim=-1).to(torch.int32)  # (B, k)
    # draft token cand[:, i + 1] is accepted while it equals greedy[:, i]
    matches = (cand[:, 1:].to(torch.int32) == greedy[:, :-1]).to(torch.int32)
    counts = torch.cumprod(matches, dim=1).sum(dim=1) + 1
    idx = torch.arange(k, device=cand.device)[None, :]
    tokens = torch.where(idx < counts[:, None], greedy, torch.zeros_like(greedy))
    return tokens, counts.to(torch.int32)


def first_token(
    tlogits_last: torch.Tensor,  # (B, V) target logits at the prompt's last position
    sampling_params: torch.Tensor,
    generator: Optional[torch.Generator],
    do_sample: bool,
    max_topk: int,
) -> torch.Tensor:
    """The prefill's first token (B, 1): drawn from the warped target
    distribution, as plain decoding's prefill draws it, or greedy."""
    if do_sample and generator is not None:
        return sample(tlogits_last, sampling_params, generator, max_topk, True)[:, None]
    return torch.argmax(tlogits_last, dim=-1).to(torch.int32)[:, None]


def speculative_token_selection(
    cand: torch.Tensor,  # (B, k): cand[:, 0] last accepted, cand[:, 1:] proposals
    draft_probs: torch.Tensor,  # (B, k-1, V): q_i, the distribution cand[:, i+1] came from
    target_probs: torch.Tensor,  # (B, k, V): p_i, the target's after cand[:, i]
    generator: torch.Generator,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multinomial accept/reject (the reference's
    ``speculative_token_selection``): accept d_{i+1} with probability
    min(1, p_i(d)/q_i(d)); at the first rejection draw from the residual
    norm(max(p_i - q_i, 0)), after a full accept draw the bonus token from
    p_{k-1}. Returns (tokens (B, k) zero past the count, counts (B,) in
    [1, k])."""
    B, k = cand.shape
    d = cand[:, 1:].to(torch.int64)  # (B, k-1)
    p_d = torch.take_along_dim(target_probs[:, :-1, :], d[:, :, None], dim=2)[:, :, 0]
    q_d = torch.take_along_dim(draft_probs, d[:, :, None], dim=2)[:, :, 0]
    u = torch.rand((B, k - 1), generator=generator, device=cand.device, dtype=torch.float32)
    accept = (u * torch.clamp(q_d, min=1e-20) < p_d).to(torch.int32)
    acc = torch.cumprod(accept, dim=1).sum(dim=1)  # (B,) in [0, k-1]

    p_at = torch.take_along_dim(target_probs, acc[:, None, None], dim=1)[:, 0]  # (B, V)
    q_at = torch.take_along_dim(draft_probs, torch.clamp(acc, max=k - 2)[:, None, None], dim=1)[:, 0]
    full_accept = (acc == k - 1)[:, None]
    resid = torch.where(full_accept, p_at, torch.clamp(p_at - q_at, min=0.0))
    norm = resid.sum(dim=-1, keepdim=True)
    # a numerically empty residual (p ~= q) falls back to p
    resid = torch.where(norm > 1e-20, resid / torch.clamp(norm, min=1e-20), p_at)
    final_tok = _categorical(resid, generator)  # (B,)

    idx = torch.arange(k, device=cand.device)[None, :]
    shifted = torch.nn.functional.pad(d, (0, 1)).to(torch.int32)  # accepted drafts at 0..acc-1
    acc_c = acc[:, None]
    tokens = torch.where(
        idx < acc_c, shifted, torch.where(idx == acc_c, final_tok[:, None], torch.zeros_like(shifted))
    )
    return tokens, (acc + 1).to(torch.int32)


def _row_mask(bucket: int, pos: torch.Tensor) -> torch.Tensor:
    """(B, 1) positions -> the (B, bucket) int32 cache-validity mask."""
    return (torch.arange(bucket, device=pos.device)[None, :] <= pos).to(torch.int32)


def fused_spec_token_gen(
    draft_params: dict,
    target_params: dict,
    draft_cache: KVCache,
    target_cache: KVCache,
    inputs: StepInputs,
    generator: Optional[torch.Generator] = None,
    *,
    spec_len: int,
    bucket: int,
    draft_spec: ModelSpec,
    target_spec: ModelSpec,
    draft_mlp_fn: Callable,
    target_mlp_fn: Callable,
    do_sample: bool = False,
    max_topk: int = 256,
) -> FusedSpecOutput:
    """One fused decode round producing up to ``spec_len`` tokens a row.

    ``inputs.input_ids`` (B, 1) is the last accepted token and
    ``inputs.position_ids`` (B, 1) its position p; the masks of the
    ``bucket``-wide cache are built on the device from the positions. The
    caches are written in place."""
    k = spec_len
    seq_ids = inputs.seq_ids
    sp = inputs.sampling_params
    cur = inputs.input_ids
    pos = inputs.position_ids
    candidates = [cur]
    draft_dists = []
    for i in range(k):
        step_inputs = StepInputs(
            input_ids=cur, attention_mask=_row_mask(bucket, pos), position_ids=pos,
            seq_ids=seq_ids, sampling_params=sp,
        )
        dlogits, _ = model_logits(
            draft_params, draft_cache, step_inputs, spec=draft_spec, phase=PHASE_TOKEN_GENERATION,
            mlp_fn=draft_mlp_fn,
        )
        if i == k - 1:
            # the last step only writes the last candidate's K/V at p + k - 1
            break
        cur, q = propose_next(dlogits[:, -1, :], sp, generator, do_sample, max_topk)
        if q is not None:
            draft_dists.append(q)
        pos = pos + 1
        candidates.append(cur)

    cand = torch.cat(candidates, dim=1).to(torch.int32)  # (B, k)
    cand_pos = inputs.position_ids + torch.arange(k, dtype=inputs.position_ids.dtype, device=cand.device)[None, :]
    target_inputs = StepInputs(
        input_ids=cand, attention_mask=_row_mask(bucket, cand_pos[:, -1:]), position_ids=cand_pos,
        seq_ids=seq_ids, sampling_params=sp,
    )
    tlogits, _ = model_logits(
        target_params, target_cache, target_inputs, spec=target_spec, phase=PHASE_TOKEN_GENERATION,
        mlp_fn=target_mlp_fn,
    )  # (B, k, V): tlogits[:, i] predicts the token after cand[:, i]
    tokens, counts = verify_and_accept(cand, tlogits, draft_dists, sp, generator, do_sample, max_topk)
    return FusedSpecOutput(tokens=tokens, counts=counts, draft_cache=draft_cache, target_cache=target_cache)


def fused_spec_context_encoding(
    draft_params: dict,
    target_params: dict,
    draft_cache: KVCache,
    target_cache: KVCache,
    inputs: StepInputs,
    generator: Optional[torch.Generator] = None,
    *,
    draft_spec: ModelSpec,
    target_spec: ModelSpec,
    draft_mlp_fn: Callable,
    target_mlp_fn: Callable,
    do_sample: bool = False,
    max_topk: int = 256,
) -> FusedSpecOutput:
    """The fused prefill: the target's context encoding (its first token)
    and the draft's (its cache only), in one program."""
    tlogits, _ = model_logits(
        target_params, target_cache, inputs, spec=target_spec, phase=PHASE_CONTEXT_ENCODING,
        mlp_fn=target_mlp_fn,
    )
    model_logits(
        draft_params, draft_cache, inputs, spec=draft_spec, phase=PHASE_CONTEXT_ENCODING, mlp_fn=draft_mlp_fn,
    )
    token = first_token(tlogits[:, -1, :], inputs.sampling_params, generator, do_sample, max_topk)
    counts = torch.ones((token.shape[0],), dtype=torch.int32, device=token.device)
    return FusedSpecOutput(tokens=token, counts=counts, draft_cache=draft_cache, target_cache=target_cache)
