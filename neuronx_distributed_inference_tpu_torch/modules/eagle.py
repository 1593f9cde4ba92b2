"""EAGLE fused speculation: a feature-level draft chained with the target
(counterpart of the reference's ``modules/eagle.py``).

The draft's input at position i is ``fc([embed(token_i), hidden_{i-1}])``,
where ``hidden_{i-1}`` is the target's hidden state for accepted tokens and
the draft's own output for tokens still in flight. Between rounds one
hidden vector per cache line lives in the app's ``(B_kv + 1, H)`` hidden
buffer (``3H`` for EAGLE3), indexed by cache line; invalid seq ids write
the garbage line ``B_kv``. The buffer and both caches are updated in place,
so a round is one CUDA graph (``runtime/fused_spec.py``).

- :func:`eagle_context_encoding`: the target's prefill keeps every hidden
  state; the draft's prefill takes them shifted by one.
- :func:`eagle_token_gen`: k draft steps (the k-th only writes the last
  candidate's K/V: a fully accepted round needs it), one k-token target
  verify pass returning its hidden states, acceptance through
  ``modules/speculation.verify_and_accept``, and the buffer update.

EAGLE3 (:func:`eagle3_draft_hidden`, :func:`eagle3_capture_layers`): the
target's capture of three layers' outputs (3H) passes the draft's ``fc``;
the draft's own chained feature (H) is used as it is.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from neuronx_distributed_inference_tpu_torch.models.base import (
    PHASE_CONTEXT_ENCODING,
    PHASE_TOKEN_GENERATION,
    ModelSpec,
    StepInputs,
    build_mask,
    contiguous_decode_attend,
    embed,
    gather_last_token,
    lm_head,
    model_logits,
    run_decoder_layers,
    unstack_layers,
)
from neuronx_distributed_inference_tpu_torch.modules.attention import attention_prefill, o_project, qkv_project
from neuronx_distributed_inference_tpu_torch.modules.kvcache import (
    GARBAGE_LINES,
    KVCache,
    kv_batch_size,
    slot_ids_from_seq_ids,
    update_cache_at_layer,
)
from neuronx_distributed_inference_tpu_torch.modules.norm import apply_norm, rms_norm
from neuronx_distributed_inference_tpu_torch.modules.rope import rope_cos_sin
from neuronx_distributed_inference_tpu_torch.modules.speculation import (
    _row_mask,
    first_token,
    propose_next,
    verify_and_accept,
)
from neuronx_distributed_inference_tpu_torch.ops.kernel_mode import use_flash
from neuronx_distributed_inference_tpu_torch.ops.quant import linear


@dataclass
class EagleOutput:
    tokens: torch.Tensor  # (B, K) accepted tokens, 0 past counts
    counts: torch.Tensor  # (B,)
    draft_cache: KVCache
    target_cache: KVCache
    hidden_buffer: torch.Tensor  # (B_kv + 1, H) the feature of each line's last token


def eagle_draft_hidden(
    draft_params: dict,
    token_ids: torch.Tensor,  # (B, S)
    prev_hidden: torch.Tensor,  # (B, S, H) the features, shifted target / draft hiddens
    cache: KVCache,
    inputs: StepInputs,
    *,
    spec: ModelSpec,
    phase: str,
    mlp_fn: Callable,
    input_norm: bool = False,
) -> Tuple[torch.Tensor, KVCache]:
    """The v1 draft's forward with the fc-fused input: (hidden (B, S, H)
    after the final norm, cache)."""
    emb = embed(draft_params, token_ids)
    if input_norm:  # the reference's enable_eagle_draft_input_norm
        emb = rms_norm(emb, draft_params["input_norm"]["weight"], spec.rms_eps)
    fused = torch.cat([emb, prev_hidden.to(emb.dtype)], dim=-1)
    hidden = linear(draft_params["fc"], fused)
    return run_decoder_layers(draft_params, hidden, cache, inputs, spec=spec, phase=phase, mlp_fn=mlp_fn)


def init_hidden_buffer(kv_batch: int, hidden_size: int, dtype, device) -> torch.Tensor:
    """The zeroed hidden buffer: one line a cache line, the garbage line
    included."""
    return torch.zeros((kv_batch + GARBAGE_LINES, hidden_size), dtype=dtype, device=device)


def default_eagle_draft_fn(draft_spec: ModelSpec, draft_mlp_fn: Callable, input_norm: bool) -> Callable:
    """The v1 draft as ``draft_fn(params, tokens, prev_h, cache, inputs,
    phase)`` (EAGLE3 substitutes :func:`eagle3_draft_hidden`)."""

    def draft_fn(params, tokens, prev_h, cache, step_inputs, phase):
        return eagle_draft_hidden(
            params, tokens, prev_h, cache, step_inputs, spec=draft_spec, phase=phase, mlp_fn=draft_mlp_fn,
            input_norm=input_norm,
        )

    return draft_fn


def eagle3_capture_layers(num_layers: int) -> Tuple[int, int, int]:
    """EAGLE3's target taps: layers (1, L/2 - 1, L - 4), clipped to the
    stack for small models; always three (the fc takes a 3H concat)."""
    L = num_layers
    return tuple(min(max(i, 0), L - 1) for i in (1, L // 2 - 1, L - 4))


def eagle3_draft_hidden(
    draft_params: dict,
    token_ids: torch.Tensor,  # (B, S)
    prev_hidden: torch.Tensor,  # (B, S, 3H) the target's capture, or (B, S, H) chained
    cache: KVCache,
    inputs: StepInputs,
    *,
    spec: ModelSpec,
    phase: str,
    mlp_fn: Callable,
) -> Tuple[torch.Tensor, KVCache]:
    """EAGLE3's one fused draft layer (the reference's ``eagle3_draft_hidden``):

    - a 3H target capture passes ``fc`` -> H; the draft's own H feature is
      used as it is;
    - the layer input is [embed(token) | feature] (2H), the halves normed
      apart (``input_layernorm`` / ``hidden_norm``), and q/k/v project 2H;
    - the attention and MLP residual is the feature half before its norm;
    - returns the hidden BEFORE the final norm (the chained feature);
      :func:`eagle3_lm_hidden` norms it for the lm head.

    Attention: B2 in prefill, ``models/base.contiguous_decode_attend`` (B1)
    in decode, under ``inputs.mask_override`` when a tree sets it."""
    aspec = spec.attn
    emb = embed(draft_params, token_ids)
    H = emb.shape[-1]
    feat = prev_hidden.to(emb.dtype)
    if feat.shape[-1] != H:
        feat = linear(draft_params["fc"], feat)
    layers = draft_params["layers"]
    lp = (unstack_layers(layers) if isinstance(layers, dict) else layers)[0]
    emb_n = apply_norm(emb, lp["input_layernorm"]["weight"], spec.rms_eps, spec.norm_type)
    feat_n = apply_norm(feat, lp["hidden_norm"]["weight"], spec.rms_eps, spec.norm_type)
    x = torch.cat([emb_n, feat_n], dim=-1)  # (B, S, 2H)

    rope_pos = inputs.rope_position_ids if inputs.rope_position_ids is not None else inputs.position_ids
    cos, sin = rope_cos_sin(rope_pos, draft_params["rope"]["inv_freq"], spec.attention_scaling)
    q, k, v = qkv_project(lp["self_attn"], x, cos, sin, aspec)
    slot_ids = slot_ids_from_seq_ids(inputs.seq_ids, kv_batch_size(cache))
    k_c, v_c = update_cache_at_layer(cache.k, cache.v, k, v, 0, slot_ids, inputs.position_ids)
    if phase == PHASE_CONTEXT_ENCODING:
        mask = None if use_flash(aspec) else build_mask(inputs, spec, phase)
        attn_out = attention_prefill(q, k, v, mask, aspec, key_valid=inputs.attention_mask)
    else:
        attn_out = contiguous_decode_attend(q, k_c, v_c, 0, build_mask(inputs, spec, phase), spec, aspec)
    h = o_project(lp["self_attn"], attn_out) + feat  # the residual before the norm
    h = h + mlp_fn(lp["mlp"], apply_norm(h, lp["post_attention_layernorm"]["weight"], spec.rms_eps,
                                         spec.norm_type), spec)
    return h, type(cache)(k=k_c, v=v_c)


def eagle3_lm_hidden(draft_params: dict, hidden: torch.Tensor, spec: ModelSpec) -> torch.Tensor:
    """The final norm before EAGLE3's lm head (the chained feature stays
    before it)."""
    return apply_norm(hidden, draft_params["norm"]["weight"], spec.rms_eps, spec.norm_type)


def d2t_table(draft_params: dict) -> Optional[torch.Tensor]:
    """A reduced-vocab EAGLE3 draft's draft -> target offsets, or None."""
    return (draft_params.get("d2t") or {}).get("table")


def eagle_context_encoding(
    draft_params: dict,
    target_params: dict,
    draft_cache: KVCache,
    target_cache: KVCache,
    hidden_buffer: torch.Tensor,
    inputs: StepInputs,
    generator: Optional[torch.Generator] = None,
    *,
    draft_spec: ModelSpec,
    target_spec: ModelSpec,
    draft_mlp_fn: Callable,
    target_mlp_fn: Callable,
    draft_input_norm: bool = False,
    do_sample: bool = False,
    max_topk: int = 256,
    draft_fn: Optional[Callable] = None,
    capture_layers: Optional[Tuple[int, ...]] = None,
) -> EagleOutput:
    """The fused EAGLE prefill: the target's context encoding, keeping every
    hidden state (its capture concat with ``capture_layers``, EAGLE3), then
    the draft's, fed those hidden states shifted right by one (zeros at
    position 0). The hidden that produced the first token goes into each
    row's line of ``hidden_buffer``; everything is written in place."""
    tlogits, _, t_hidden = model_logits(
        target_params, target_cache, inputs, spec=target_spec, phase=PHASE_CONTEXT_ENCODING,
        mlp_fn=target_mlp_fn, return_hidden=True, capture_layers=capture_layers,
    )
    if draft_fn is None:
        draft_fn = default_eagle_draft_fn(draft_spec, draft_mlp_fn, draft_input_norm)
    shifted = F.pad(t_hidden[:, :-1, :], (0, 0, 1, 0))
    draft_fn(draft_params, inputs.input_ids, shifted, draft_cache, inputs, PHASE_CONTEXT_ENCODING)
    token = first_token(tlogits[:, -1, :], inputs.sampling_params, generator, do_sample, max_topk)
    last_hidden = gather_last_token(t_hidden, inputs.attention_mask)[:, 0, :]
    slots = slot_ids_from_seq_ids(inputs.seq_ids, hidden_buffer.shape[0] - 1)
    hidden_buffer[slots] = last_hidden.to(hidden_buffer.dtype)
    counts = torch.ones((token.shape[0],), dtype=torch.int32, device=token.device)
    return EagleOutput(token, counts, draft_cache, target_cache, hidden_buffer)


def eagle_token_gen(
    draft_params: dict,
    target_params: dict,
    draft_cache: KVCache,
    target_cache: KVCache,
    hidden_buffer: torch.Tensor,
    inputs: StepInputs,
    generator: Optional[torch.Generator] = None,
    *,
    spec_len: int,
    bucket: int,
    draft_spec: ModelSpec,
    target_spec: ModelSpec,
    draft_mlp_fn: Callable,
    target_mlp_fn: Callable,
    draft_input_norm: bool = False,
    do_sample: bool = False,
    max_topk: int = 256,
    draft_fn: Optional[Callable] = None,
    draft_lm_hidden_fn: Optional[Callable] = None,
    capture_layers: Optional[Tuple[int, ...]] = None,
) -> EagleOutput:
    """One fused EAGLE decode round (the reference's ``eagle_token_gen``): k
    draft steps chaining the DRAFT's hidden states, the k-th a cache fill
    only; one k-token target verify pass returning its hidden states; greedy
    contiguous-match or multinomial acceptance; the buffer line set to the
    target hidden that produced the bonus token.

    ``inputs.input_ids`` (B, 1) is the last accepted token, at
    ``inputs.position_ids`` (B, 1); the masks of the ``bucket``-wide cache
    are built on the device. A ``d2t`` table in the draft params maps each
    proposal into the target vocab (and its q, when sampling).
    ``draft_fn`` / ``draft_lm_hidden_fn`` / ``capture_layers`` select
    EAGLE3."""
    k = spec_len
    seq_ids = inputs.seq_ids
    sp = inputs.sampling_params
    slots = slot_ids_from_seq_ids(seq_ids, hidden_buffer.shape[0] - 1)
    if draft_fn is None:
        draft_fn = default_eagle_draft_fn(draft_spec, draft_mlp_fn, draft_input_norm)
    d2t = d2t_table(draft_params)

    cur = inputs.input_ids  # (B, 1)
    pos = inputs.position_ids
    prev_h = hidden_buffer[slots][:, None, :]  # (B, 1, H | 3H)
    candidates = [cur]
    draft_dists = []
    for i in range(k):
        step_inputs = StepInputs(
            input_ids=cur, attention_mask=_row_mask(bucket, pos), position_ids=pos, seq_ids=seq_ids,
            sampling_params=sp,
        )
        d_hidden, _ = draft_fn(draft_params, cur, prev_h, draft_cache, step_inputs, PHASE_TOKEN_GENERATION)
        if i == k - 1:
            # cache fill only: after a fully accepted round the draft's
            # position p + k - 1 must hold real K/V for the next round
            break
        lm_h = d_hidden if draft_lm_hidden_fn is None else draft_lm_hidden_fn(draft_params, d_hidden)
        dlogits = lm_head(draft_params, lm_h, draft_spec)[..., : draft_spec.vocab_size]
        cur, q = propose_next(dlogits[:, -1, :], sp, generator, do_sample, max_topk)
        if d2t is not None:
            # a reduced-vocab draft: draft token d is target token d + d2t[d]
            cur = (cur + d2t[cur.long()]).to(torch.int32)
            if q is not None:
                # the accept ratio compares target-vocab probabilities
                from neuronx_distributed_inference_tpu_torch.modules.token_tree import q_to_target_vocab

                q = q_to_target_vocab(q, d2t, target_spec.vocab_size)
        if q is not None:
            draft_dists.append(q)
        prev_h = d_hidden[:, -1:, :]  # chain the draft's own feature
        pos = pos + 1
        candidates.append(cur)

    cand = torch.cat(candidates, dim=1).to(torch.int32)  # (B, k)
    cand_pos = inputs.position_ids + torch.arange(k, dtype=inputs.position_ids.dtype, device=cand.device)[None, :]
    target_inputs = StepInputs(
        input_ids=cand, attention_mask=_row_mask(bucket, cand_pos[:, -1:]), position_ids=cand_pos,
        seq_ids=seq_ids, sampling_params=sp,
    )
    tlogits, _, t_hidden = model_logits(
        target_params, target_cache, target_inputs, spec=target_spec, phase=PHASE_TOKEN_GENERATION,
        mlp_fn=target_mlp_fn, return_hidden=True, capture_layers=capture_layers,
    )  # (B, k, ·)
    tokens, counts = verify_and_accept(cand, tlogits, draft_dists, sp, generator, do_sample, max_topk)
    # the next round's draft feature: the target hidden that produced the
    # bonus token (index counts - 1)
    bonus = torch.take_along_dim(t_hidden, (counts.long() - 1)[:, None, None], dim=1)[:, 0, :]
    hidden_buffer[slots] = bonus.to(hidden_buffer.dtype)
    return EagleOutput(tokens, counts, draft_cache, target_cache, hidden_buffer)
