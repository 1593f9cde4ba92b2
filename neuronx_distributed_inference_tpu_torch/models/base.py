"""The decoder core (counterpart of the reference's ``models/base.py``; the
uniform-stack, greedy subset over the contiguous and the paged cache).

    forward(params, cache, inputs) -> StepOutput(tokens, logits?, cache)

The reference traces this under ``jit`` with the layers in a ``lax.scan``;
the port runs it eagerly, the layers and the decode steps as Python loops.
The cache is updated IN PLACE (``update_cache_at_layer``); the returned
``StepOutput.cache`` is the same object that was passed in.

Prefill attention goes through the B2 flash kernel
(``modules/attention.attention_prefill``). Decode attention goes through the
B1 kernel over the contiguous cache (:func:`contiguous_decode_attend`) and,
over the paged cache (:func:`paged_attend`), multi-token passes of 8 tokens
or more (chunked and prefix prefill) through the B5 paged flash kernel and
shorter ones through the B4 paged decode kernel. The ragged mixed serving
step (:func:`mixed_forward`) packs prefill chunks and decode rows on one
token axis and runs its attention through the B3 ragged kernel. The config
tri-states turn the kernels off.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from neuronx_distributed_inference_tpu_torch.modules import masks
from neuronx_distributed_inference_tpu_torch.modules.block_kvcache import (
    BlockKVCache,
    read_block_cache_at_layer,
    slot_mapping_from_block_table,
    update_block_cache_at_layer,
)
from neuronx_distributed_inference_tpu_torch.modules.attention import (
    AttnSpec,
    attention_decode,
    attention_prefill,
    o_project,
    qkv_project,
)
from neuronx_distributed_inference_tpu_torch.modules.kvcache import (
    KVCache,
    kv_batch_size,
    read_cache_at_layer,
    slot_ids_from_seq_ids,
    update_cache_at_layer,
)
from neuronx_distributed_inference_tpu_torch.modules.norm import apply_norm
from neuronx_distributed_inference_tpu_torch.modules.rope import rope_cos_sin
from neuronx_distributed_inference_tpu_torch.modules.sampling import (
    mask_padded_logits,
    sample_tokens,
)
from neuronx_distributed_inference_tpu_torch.ops.kernel_mode import (
    use_flash,
    use_paged_flash,
    use_tkg,
)

PHASE_CONTEXT_ENCODING = "context_encoding"
PHASE_TOKEN_GENERATION = "token_generation"
PHASE_MIXED = "mixed"


@dataclass(frozen=True)
class ModelSpec:
    """Static model hyperparams (counterpart of the reference ModelSpec;
    the fields the ported path reads)."""

    num_layers: int
    vocab_size: int
    attn: AttnSpec
    rms_eps: float = 1e-6
    act: str = "silu"
    output_logits: bool = False
    cast_logits_fp32: bool = True
    attention_scaling: float = 1.0
    norm_type: str = "rmsnorm"


@dataclass
class StepInputs:
    """Per-step inputs (counterpart of the reference StepInputs)."""

    input_ids: torch.Tensor  # (B, S) int
    attention_mask: torch.Tensor  # CTE: (B, S); TKG: (B, S_bucket) cache-valid mask
    position_ids: torch.Tensor  # (B, S) int
    seq_ids: torch.Tensor  # (B,) cache-line ids (invalid -> garbage line)
    sampling_params: torch.Tensor  # (B, 3) float32
    slot_mapping: Optional[torch.Tensor] = None  # (B, S) paged-cache flat write slots
    block_table: Optional[torch.Tensor] = None  # (B, MB) paged-cache block ids


@dataclass
class MixedStepInputs:
    """Device inputs of ONE ragged mixed prefill+decode step
    (:func:`mixed_forward`; the reference's ``MixedStepInputs``).

    All rows' query tokens are packed along one axis of length T (the
    total-query-token bucket): row r owns packed slots ``[row_start[r],
    row_start[r] + row_len[r])``; slots between segments are padding
    (position and slot -1). Row index == serving slot == block-table row,
    so R is the session's slot count."""

    input_ids: torch.Tensor  # (1, T) int packed tokens
    position_ids: torch.Tensor  # (1, T) int absolute positions; -1 = padded
    slot_mapping: torch.Tensor  # (1, T) int flat paged write slots; -1 = garbage block
    block_table: torch.Tensor  # (R, MB) int
    row_start: torch.Tensor  # (R,) int packed offset per row
    row_len: torch.Tensor  # (R,) int query tokens per row; 0 = inactive
    ctx_len: torch.Tensor  # (R,) int total kv length per row (incl. new)
    sampling_params: torch.Tensor  # (R, 3) float32
    # 1-ahead chaining (serving_ragged_async): chain_src[t] names the row
    # whose PREVIOUS-step token supplies packed slot t's input id (-1 = take
    # input_ids[t] as the host wrote it); chain_tokens is the previous mixed
    # step's (R, 1) token output, still on the device, so a chained decode
    # row's input never round-trips the host. The synchronous path passes
    # inert values (all -1 / zeros); None skips the gather.
    chain_src: Optional[torch.Tensor] = None  # (1, T) int; -1 = host id
    chain_tokens: Optional[torch.Tensor] = None  # (R, 1) int


Cache = Union[KVCache, BlockKVCache]


@dataclass
class StepOutput:
    tokens: torch.Tensor  # (B, K) int32
    logits: Optional[torch.Tensor]  # (B, K, V) or None
    cache: Cache


#: token emitted in place of the argmax when a position's logits are not
#: finite (the reference's serving quarantine reads it)
NON_FINITE_TOKEN = -1


def mark_non_finite_tokens(tokens: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Positions whose logits hold NaN/Inf emit :data:`NON_FINITE_TOKEN`."""
    finite = torch.isfinite(logits).all(dim=-1)
    return torch.where(finite, tokens, torch.full_like(tokens, NON_FINITE_TOKEN))


def act_fn(name: str) -> Callable:
    return {
        "silu": F.silu,
        "gelu": F.gelu,
        "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
    }[name]


def gated_mlp(params: dict, hidden: torch.Tensor, spec: ModelSpec) -> torch.Tensor:
    """SwiGLU MLP."""
    gate = act_fn(spec.act)(hidden @ params["gate_proj"]["weight"])
    up = hidden @ params["up_proj"]["weight"]
    return (gate * up) @ params["down_proj"]["weight"]


def contiguous_decode_attend(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    layer_idx: int,
    mask: torch.Tensor,
    spec: ModelSpec,
    aspec: AttnSpec,
    sink: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Token-gen attention over one layer of the stacked contiguous cache:
    the B1 kernel's wrapper reads the FULL stacked cache at ``layer_idx``
    (no bucket-slice copy); ``use_tkg_kernel=False`` takes the bucket slice
    and the plain masked softmax."""
    if use_tkg(aspec):
        from neuronx_distributed_inference_tpu_torch.ops.decode_attention import (
            tkg_decode_attention,
        )

        return tkg_decode_attention(
            q, k_cache, v_cache, layer_idx, mask, sink,
            scale=aspec.softmax_scale, n_kv=aspec.num_kv_heads,
        )
    k_r, v_r = read_cache_at_layer(k_cache, v_cache, layer_idx, q.shape[0], mask.shape[-1])
    return attention_decode(q, k_r, v_r, mask, aspec, sink=sink)


def paged_attend(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    layer_idx: int,
    mask: Optional[torch.Tensor],
    positions: torch.Tensor,
    block_table: torch.Tensor,
    kv_limit: torch.Tensor,
    aspec: AttnSpec,
    sink: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention of a token-generation pass over one layer of the paged
    cache (the reference's ``decoder_layer`` block branch, ``base.py:619-703``):
    passes of 8 tokens or more go to the B5 paged flash kernel's wrapper,
    shorter ones to the B4 paged decode kernel's wrapper; with both
    tri-states off, the plain block gather and masked softmax."""
    Sq = q.shape[1]
    if use_paged_flash(aspec, Sq):
        if sink is not None:
            raise NotImplementedError(
                "learned attention sinks in a multi-token pass over the paged cache "
                "are not ported to PyTorch yet (ROADMAP A9 (sinks))"
            )
        from neuronx_distributed_inference_tpu_torch.ops.paged_flash_attention import (
            paged_flash_attention,
        )

        return paged_flash_attention(
            q, k_cache[layer_idx], v_cache[layer_idx], block_table, positions, kv_limit,
            scale=aspec.softmax_scale, n_rep=aspec.num_heads // aspec.num_kv_heads,
        )
    if use_tkg(aspec):
        from neuronx_distributed_inference_tpu_torch.ops.decode_attention import (
            paged_tkg_decode_attention,
        )

        return paged_tkg_decode_attention(
            q, k_cache, v_cache, layer_idx, block_table, mask, sink,
            scale=aspec.softmax_scale, n_kv=aspec.num_kv_heads,
        )
    k_r, v_r = read_block_cache_at_layer(k_cache, v_cache, layer_idx, block_table)
    return attention_decode(q, k_r, v_r, mask, aspec, sink=sink)


def decoder_layer(
    layer_params: dict,
    hidden: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    layer_idx: int,
    mask: Optional[torch.Tensor],
    slot_ids: torch.Tensor,
    positions: torch.Tensor,
    spec: ModelSpec,
    phase: str,
    mlp_fn: Callable = gated_mlp,
    key_valid: Optional[torch.Tensor] = None,
    # (slot_mapping (B, S), block_table (B, MB) | None, kv_limit (B,) | None)
    # on the paged cache
    block_inputs: Optional[Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]] = None,
    # (row_start, row_len, ctx_len) (R,) of the ragged mixed step
    ragged_rows: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decoder layer, write-then-attend: this layer's new K/V go into the
    full stacked cache first (in place; through ``slot_mapping`` on the
    paged cache), then prefill attends the in-flight K/V and decode attends
    the cache. Returns (hidden, k_cache, v_cache)."""
    aspec = spec.attn
    residual = hidden
    hidden = apply_norm(
        hidden, layer_params["input_layernorm"]["weight"], spec.rms_eps, spec.norm_type
    )
    q, k, v = qkv_project(layer_params["self_attn"], hidden, cos, sin, aspec)
    if block_inputs is not None:
        k_cache, v_cache = update_block_cache_at_layer(
            k_cache, v_cache, k, v, layer_idx, block_inputs[0]
        )
    else:
        k_cache, v_cache = update_cache_at_layer(
            k_cache, v_cache, k, v, layer_idx, slot_ids, positions
        )
    sink = layer_params["self_attn"].get("sink", {}).get("weight") if aspec.has_sink else None
    if phase == PHASE_CONTEXT_ENCODING:
        attn_out = attention_prefill(q, k, v, mask, aspec, sink=sink, key_valid=key_valid)
    elif ragged_rows is not None:
        # ragged mixed step: prefill-chunk AND decode rows in ONE attention
        # launch off the paged cache, the masks derived from the descriptors
        from neuronx_distributed_inference_tpu_torch.ops.ragged_paged_attention import (
            ragged_attention,
        )

        rs, rl, cl = ragged_rows
        attn_out = ragged_attention(
            q, k_cache, v_cache, layer_idx, block_inputs[1], positions, rs, rl, cl, aspec
        )
    elif block_inputs is not None:
        _, block_table, kv_limit = block_inputs
        attn_out = paged_attend(
            q, k_cache, v_cache, layer_idx, mask, positions, block_table, kv_limit, aspec, sink
        )
    else:
        attn_out = contiguous_decode_attend(
            q, k_cache, v_cache, layer_idx, mask, spec, aspec, sink
        )
    hidden = residual + o_project(layer_params["self_attn"], attn_out)
    residual = hidden
    hidden = apply_norm(
        hidden, layer_params["post_attention_layernorm"]["weight"], spec.rms_eps, spec.norm_type
    )
    return residual + mlp_fn(layer_params["mlp"], hidden, spec), k_cache, v_cache


def build_mask(inputs: StepInputs, spec: ModelSpec, phase: str) -> torch.Tensor:
    """Causal mask for prefill; for token generation the cache-validity
    mask, per token (causal among the new tokens) when a pass carries more
    than one (chunked or prefix prefill on the paged cache)."""
    n_active = inputs.input_ids.shape[1]
    if phase == PHASE_CONTEXT_ENCODING:
        return masks.causal_mask(inputs.attention_mask)
    if n_active > 1:
        return masks.spec_token_gen_mask(inputs.attention_mask, inputs.position_ids)
    return masks.token_gen_mask(inputs.attention_mask, n_active)


def embed(params: dict, input_ids: torch.Tensor) -> torch.Tensor:
    return params["embed_tokens"]["weight"][input_ids]


def lm_head(params: dict, hidden: torch.Tensor, spec: ModelSpec) -> torch.Tensor:
    """(B, K, H) -> (B, K, Vpad): the (H, Vpad) head (a materialized
    transposed copy of the embedding for tied models), fp32 cast, padded
    vocab tail filled with the dtype's most negative value."""
    logits = hidden @ params["lm_head"]["weight"]
    if spec.cast_logits_fp32:
        logits = logits.float()
    return mask_padded_logits(logits, spec.vocab_size)


def gather_last_token(hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """(B, S, H) -> (B, 1, H) at the last valid position of each row."""
    idx = torch.clamp(attention_mask.to(torch.int64).sum(dim=1) - 1, min=0)
    return torch.take_along_dim(hidden, idx[:, None, None], dim=1)


def unstack_layers(layers: Dict) -> List[Dict]:
    """Stacked (L, ...) layer params -> a list of per-layer dicts of views."""
    n = next(iter(_leaves(layers))).shape[0]

    def pick(tree, i):
        if isinstance(tree, dict):
            return {k: pick(v, i) for k, v in tree.items()}
        return tree[i]

    return [pick(layers, i) for i in range(n)]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def prepare_params(params: Dict) -> Dict:
    """A shallow copy whose ``layers`` is the per-layer list the layer loop
    walks (views; no weight is copied). Loaded apps run on this form."""
    out = dict(params)
    if isinstance(out["layers"], dict):
        out["layers"] = unstack_layers(out["layers"])
    return out


def run_decoder_layers(
    params: dict,
    hidden: torch.Tensor,
    cache: Cache,
    inputs: StepInputs,
    *,
    spec: ModelSpec,
    phase: str,
    mlp_fn: Callable = gated_mlp,
) -> Tuple[torch.Tensor, Cache]:
    """Layer stack + final norm over an embedded hidden state (uniform stack:
    one Python loop over the layers, the cache updated in place)."""
    cos, sin = rope_cos_sin(inputs.position_ids, params["rope"]["inv_freq"], spec.attention_scaling)
    positions = inputs.position_ids
    is_block = inputs.slot_mapping is not None or inputs.block_table is not None
    block_inputs = None
    slot_ids = None
    if is_block:
        slot_mapping = inputs.slot_mapping
        if slot_mapping is None:
            # decode writes: slots from the block table, on the device (the
            # host sends tables only)
            slot_mapping = slot_mapping_from_block_table(
                inputs.block_table, positions, cache.block_size
            )
        # valid cache length per row, for the paged flash kernel's bounds
        kv_limit = inputs.attention_mask.to(torch.int32).sum(dim=-1, dtype=torch.int32)
        block_inputs = (slot_mapping, inputs.block_table, kv_limit)
    else:
        slot_ids = slot_ids_from_seq_ids(inputs.seq_ids, kv_batch_size(cache))
    key_valid = inputs.attention_mask if phase == PHASE_CONTEXT_ENCODING else None
    # the flash kernels mask from key_valid / kv_limit themselves: only the
    # plain paths need the dense masks
    flash = key_valid is not None and use_flash(spec.attn)
    paged_flash = (
        is_block and phase != PHASE_CONTEXT_ENCODING
        and use_paged_flash(spec.attn, inputs.input_ids.shape[1])
    )
    mask = None if (flash or paged_flash) else build_mask(inputs, spec, phase)
    layers: Union[Dict, List[Dict]] = params["layers"]
    if isinstance(layers, dict):
        layers = unstack_layers(layers)
    k_cache, v_cache = cache.k, cache.v
    for li, layer_params in enumerate(layers):
        hidden, k_cache, v_cache = decoder_layer(
            layer_params, hidden, cos, sin, k_cache, v_cache, li, mask, slot_ids,
            positions, spec, phase, mlp_fn, key_valid=key_valid, block_inputs=block_inputs,
        )
    hidden = apply_norm(hidden, params["norm"]["weight"], spec.rms_eps, spec.norm_type)
    return hidden, type(cache)(k=k_cache, v=v_cache)


def model_logits(
    params: dict,
    cache: Cache,
    inputs: StepInputs,
    *,
    spec: ModelSpec,
    phase: str,
    mlp_fn: Callable = gated_mlp,
) -> Tuple[torch.Tensor, Cache]:
    """Backbone + lm head, no sampling: (logits (B, K, V), cache)."""
    hidden = embed(params, inputs.input_ids)
    hidden, new_cache = run_decoder_layers(
        params, hidden, cache, inputs, spec=spec, phase=phase, mlp_fn=mlp_fn
    )
    if phase == PHASE_CONTEXT_ENCODING:
        hidden = gather_last_token(hidden, inputs.attention_mask)
    logits = lm_head(params, hidden, spec)[..., : spec.vocab_size]
    return logits, new_cache


def _next_tokens(logits: torch.Tensor, sampling_params: torch.Tensor) -> torch.Tensor:
    """Greedy tokens (the only sampler ported), non-finite rows marked."""
    return mark_non_finite_tokens(sample_tokens(logits, sampling_params), logits)


def decode_steps(
    params: dict,
    cache: Cache,
    last_tokens: torch.Tensor,  # (B, 1) int
    positions: torch.Tensor,  # (B, 1) int write position of last_tokens
    seq_ids: torch.Tensor,  # (B,)
    sampling_params: torch.Tensor,  # (B, 3)
    *,
    spec: ModelSpec,
    num_steps: int,
    bucket: int,
    mlp_fn: Callable = gated_mlp,
    block_table: Optional[torch.Tensor] = None,
):
    """``num_steps`` whole decode iterations, tokens kept on the device (the
    reference runs them as one ``lax.scan`` program; here a Python loop).

    ``block_table`` (B, MB) runs the chunk over the PAGED cache: each step
    derives its write slots on the device from the table and the advancing
    position, so the caller must have allocated blocks covering positions up
    to pos + num_steps, and ``bucket`` must equal MB * block_size.

    Returns (tokens (B, num_steps), logits (B, num_steps, V) | None, cache)."""
    cols = torch.arange(bucket, dtype=torch.int32, device=last_tokens.device)[None, :]
    last = last_tokens.to(torch.int32)
    pos = positions.to(torch.int32)
    toks, outs = [], []
    for _ in range(num_steps):
        inputs = StepInputs(
            input_ids=last,
            attention_mask=(cols <= pos).to(torch.int32),
            position_ids=pos,
            seq_ids=seq_ids,
            sampling_params=sampling_params,
            block_table=block_table,
        )
        logits, cache = model_logits(
            params, cache, inputs, spec=spec, phase=PHASE_TOKEN_GENERATION, mlp_fn=mlp_fn
        )
        tok = _next_tokens(logits, sampling_params)
        toks.append(tok[:, 0])
        if spec.output_logits:
            outs.append(logits[:, 0])
        last, pos = tok, pos + 1
    tokens = torch.stack(toks, dim=1)
    out_logits = torch.stack(outs, dim=1) if spec.output_logits else None
    return tokens, out_logits, cache


def mixed_forward(
    params: dict,
    cache: BlockKVCache,
    inputs: MixedStepInputs,
    *,
    spec: ModelSpec,
    mlp_fn: Callable = gated_mlp,
    spec_width: int = 1,
) -> StepOutput:
    """One ragged mixed prefill+decode serving step (the reference's
    ``mixed_forward``): the batch axis is the packed query-token axis, the
    cache writes scatter through the packed ``slot_mapping`` (in place), and
    attention runs the B3 ragged kernel (ops/ragged_paged_attention.py).
    Emits one next token per row, from each row's LAST packed query position
    (a prefill chunk that completes its prompt emits the first generated
    token, a decode row its next token), so one dispatch replaces the
    context/decode pair of the split path.

    Returns StepOutput with tokens (R, 1); inactive rows (row_len 0) carry
    tokens the host ignores."""
    if spec_width > 1:
        raise NotImplementedError(
            "speculative verification inside the mixed step (spec_width > 1) "
            "is not ported to PyTorch yet (ROADMAP A7 (speculation))"
        )
    if (
        getattr(spec, "layer_groups", None) is not None
        or getattr(spec, "bounded_window", None)
        or getattr(spec, "ring_window", None)
    ):
        raise NotImplementedError(
            "the ragged mixed step supports uniform full-length layer stacks "
            "only (no ring-bounded/interleaved caches or layer groups)"
        )
    if getattr(spec, "sliding_window", None) or getattr(spec, "attention_chunk_size", None) or spec.attn.has_sink:
        raise NotImplementedError(
            "the ragged paged kernel implements the plain causal+prefix mask "
            "only (no sliding-window/chunked attention, no sinks)"
        )

    input_ids = inputs.input_ids
    if inputs.chain_tokens is not None and inputs.chain_src is not None:
        # device-side chained-id gather: packed slots whose chain_src names a
        # row take that row's previous-step token straight off the device. A
        # previous-step NON_FINITE sentinel (-1) clamps to token 0: the
        # poisoned row computes finite garbage this step and is quarantined
        # when the host consumes it.
        R = inputs.chain_tokens.shape[0]
        src = inputs.chain_src.to(torch.int64)
        chained = torch.clamp(inputs.chain_tokens[:, 0], min=0)[torch.clamp(src, 0, R - 1)]
        input_ids = torch.where(src >= 0, chained.to(input_ids.dtype), input_ids)
    hidden = embed(params, input_ids)  # (1, T, H)
    positions = inputs.position_ids
    cos, sin = rope_cos_sin(positions, params["rope"]["inv_freq"], spec.attention_scaling)
    block_inputs = (inputs.slot_mapping, inputs.block_table, inputs.ctx_len)
    ragged = (inputs.row_start, inputs.row_len, inputs.ctx_len)
    layers = params["layers"]
    if isinstance(layers, dict):
        layers = unstack_layers(layers)
    k_cache, v_cache = cache.k, cache.v
    for li, layer_params in enumerate(layers):
        hidden, k_cache, v_cache = decoder_layer(
            layer_params, hidden, cos, sin, k_cache, v_cache, li, None, None, positions, spec,
            PHASE_MIXED, mlp_fn, block_inputs=block_inputs, ragged_rows=ragged,
        )
    hidden = apply_norm(hidden, params["norm"]["weight"], spec.rms_eps, spec.norm_type)
    T = hidden.shape[1]
    # per-row last-token gather off the packed axis; inactive rows clamp to
    # slot 0, which the host never reads
    last_idx = torch.clamp(inputs.row_start.to(torch.int64) + inputs.row_len.to(torch.int64) - 1, 0, T - 1)
    rows_h = hidden[0][last_idx][:, None, :]  # (R, 1, H)
    logits = lm_head(params, rows_h, spec)[..., : spec.vocab_size]  # (R, 1, V)
    tokens = _next_tokens(logits, inputs.sampling_params)
    return StepOutput(
        tokens=tokens, logits=logits if spec.output_logits else None, cache=type(cache)(k=k_cache, v=v_cache)
    )


def forward(
    params: dict,
    cache: Cache,
    inputs: StepInputs,
    *,
    spec: ModelSpec,
    phase: str,
    mlp_fn: Callable = gated_mlp,
) -> StepOutput:
    """One step (counterpart of the reference ``forward``)."""
    logits, new_cache = model_logits(params, cache, inputs, spec=spec, phase=phase, mlp_fn=mlp_fn)
    tokens = _next_tokens(logits, inputs.sampling_params)
    return StepOutput(
        tokens=tokens, logits=logits if spec.output_logits else None, cache=new_cache
    )
