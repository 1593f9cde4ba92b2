"""Medusa speculation: prediction heads on the target's own hidden states
(counterpart of the reference's ``modules/medusa.py``).

The candidates of a round are the last emitted token and head i's
offset-(i + 1) prediction from the hidden state of that token; the target
verifies them in ONE multi-token pass (B1 with K = the verify length)
through ``modules/speculation.verify_and_accept``, and the hidden that
produced the bonus token refreshes the app's ``(B_kv + 1, H)`` hidden
buffer in place. Greedy verification gives plain greedy decoding's tokens
whatever the heads propose.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from neuronx_distributed_inference_tpu_torch.models.base import (
    PHASE_CONTEXT_ENCODING,
    PHASE_TOKEN_GENERATION,
    ModelSpec,
    StepInputs,
    gather_last_token,
    model_logits,
    unstack_layers,
)
from neuronx_distributed_inference_tpu_torch.modules.kvcache import KVCache, slot_ids_from_seq_ids
from neuronx_distributed_inference_tpu_torch.modules.speculation import _row_mask, first_token, verify_and_accept
from neuronx_distributed_inference_tpu_torch.ops.quant import linear


@dataclass
class MedusaOutput:
    tokens: torch.Tensor  # (B, K) accepted tokens, 0 past counts
    counts: torch.Tensor  # (B,)
    cache: KVCache
    hidden_buffer: torch.Tensor  # (B_kv + 1, H)


def medusa_head_logits(head_params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """One Medusa head: a residual block (SiLU of a biased linear, plus the
    input) and the head's lm head."""
    h = hidden + F.silu(linear(head_params["res"], hidden) + head_params["res"]["bias"])
    return linear(head_params["lm_head"], h)


def medusa_context_encoding(
    params: dict,
    cache: KVCache,
    hidden_buffer: torch.Tensor,
    inputs: StepInputs,
    generator: Optional[torch.Generator] = None,
    *,
    spec: ModelSpec,
    mlp_fn: Callable,
    do_sample: bool = False,
    max_topk: int = 256,
) -> MedusaOutput:
    """The prefill, and the hidden of its last token into each row's line
    of the buffer (in place)."""
    logits, _, hidden = model_logits(
        params, cache, inputs, spec=spec, phase=PHASE_CONTEXT_ENCODING, mlp_fn=mlp_fn, return_hidden=True
    )
    token = first_token(logits[:, -1, :], inputs.sampling_params, generator, do_sample, max_topk)
    slots = slot_ids_from_seq_ids(inputs.seq_ids, hidden_buffer.shape[0] - 1)
    hidden_buffer[slots] = gather_last_token(hidden, inputs.attention_mask)[:, 0, :].to(hidden_buffer.dtype)
    counts = torch.ones((token.shape[0],), dtype=torch.int32, device=token.device)
    return MedusaOutput(token, counts, cache, hidden_buffer)


def medusa_token_gen(
    params: dict,
    cache: KVCache,
    hidden_buffer: torch.Tensor,
    inputs: StepInputs,
    generator: Optional[torch.Generator] = None,
    *,
    spec_len: int,
    bucket: int,
    spec: ModelSpec,
    mlp_fn: Callable,
) -> MedusaOutput:
    """One Medusa decode round: k - 1 head predictions, one k-token verify
    pass, greedy contiguous-match acceptance, the buffer line set to the
    bonus-producing hidden. ``inputs.input_ids`` (B, 1) is the last emitted
    token at ``inputs.position_ids`` (B, 1); the masks of the ``bucket``-wide
    cache are built on the device."""
    k = spec_len
    seq_ids, sp = inputs.seq_ids, inputs.sampling_params
    slots = slot_ids_from_seq_ids(seq_ids, hidden_buffer.shape[0] - 1)
    prev_h = hidden_buffer[slots]  # (B, H): the hidden that produced input_ids
    heads = params["medusa_heads"]
    if isinstance(heads, dict):  # stacked by head: per-head views
        heads = unstack_layers(heads)
    cands = [inputs.input_ids.to(torch.int32)]
    for i in range(k - 1):
        hl = medusa_head_logits(heads[i], prev_h)[..., : spec.vocab_size]
        cands.append(torch.argmax(hl, dim=-1).to(torch.int32)[:, None])
    cand = torch.cat(cands, dim=1)  # (B, k)
    cand_pos = inputs.position_ids + torch.arange(k, dtype=inputs.position_ids.dtype, device=cand.device)[None, :]
    verify_inputs = StepInputs(
        input_ids=cand, attention_mask=_row_mask(bucket, cand_pos[:, -1:]), position_ids=cand_pos,
        seq_ids=seq_ids, sampling_params=sp,
    )
    tlogits, _, t_hidden = model_logits(
        params, cache, verify_inputs, spec=spec, phase=PHASE_TOKEN_GENERATION, mlp_fn=mlp_fn, return_hidden=True
    )
    tokens, counts = verify_and_accept(cand, tlogits, [], sp, None, False, 256)
    bonus = torch.take_along_dim(t_hidden, (counts.long() - 1)[:, None, None], dim=1)[:, 0, :]
    hidden_buffer[slots] = bonus.to(hidden_buffer.dtype)
    return MedusaOutput(tokens, counts, cache, hidden_buffer)
