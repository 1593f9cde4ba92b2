"""The decoder core (counterpart of the reference's ``models/base.py``; the
uniform-stack, greedy subset over the contiguous and the paged cache).

    forward(params, cache, inputs) -> StepOutput(tokens, logits?, cache)

The reference traces this under ``jit`` with the layers in a ``lax.scan``;
the port writes it as eager PyTorch, the layers and the decode steps as
Python loops, and the runners capture each step as a CUDA graph.
The cache is updated IN PLACE (``update_cache_at_layer``); the returned
``StepOutput.cache`` is the same object that was passed in.

Prefill attention goes through the B2 flash kernel
(``modules/attention.attention_prefill``). Decode attention goes through the
B1 kernel over the contiguous cache (:func:`contiguous_decode_attend`) or,
with ``fused_attn_block_kernel_enabled`` / ``fused_mlp_kernel_enabled``
set True, each half of a decode layer through the fused blocks B8 / B9
(``ops/decode_block.py``). Over the paged cache (:func:`paged_attend`),
multi-token passes of 8 tokens or more (chunked and prefix prefill) go
through the B5 paged flash kernel and shorter ones through the B4 paged
decode kernel. The ragged mixed serving
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
    use_fused_attn_block,
    use_fused_mlp,
    use_paged_flash,
    use_tkg,
)
from neuronx_distributed_inference_tpu_torch.ops.quant import linear

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
    # fused decode MLP block B9 (config fused_mlp_kernel_enabled): only
    # True takes it
    use_fused_mlp: Optional[bool] = None
    # multinomial sampling (on_device_sampling_config.do_sample) over a
    # top-k window of at most max_topk tokens; a step samples only when it
    # is also handed a generator (the serving session's steps are greedy)
    do_sample: bool = False
    max_topk: int = 256


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
    """The reference's activations; its "gelu" is ``jax.nn.gelu``, whose
    default is the tanh approximation."""
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
    }[name]


def gated_mlp(params: dict, hidden: torch.Tensor, spec: ModelSpec) -> torch.Tensor:
    """SwiGLU MLP, each projection through ``ops/quant.linear``."""
    gate = act_fn(spec.act)(linear(params["gate_proj"], hidden))
    up = linear(params["up_proj"], hidden)
    return linear(params["down_proj"], gate * up)


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
    (no bucket-slice copy). A pass of more than ``MAX_Q_LEN`` tokens (a
    window of a windowed prefill) and ``use_tkg_kernel=False`` take the
    bucket slice and the plain masked softmax, as the reference's gate
    sends them to its native path."""
    from neuronx_distributed_inference_tpu_torch.ops.decode_attention import MAX_Q_LEN

    if use_tkg(aspec) and q.shape[1] <= MAX_Q_LEN:
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


def _plain_weight(entry) -> bool:
    """True when a projection entry is a plain unquantized, bias-free
    weight the fused kernels can stream directly."""
    return (
        isinstance(entry, dict)
        and "weight" in entry
        and "scale" not in entry
        and "bias" not in entry
    )


def _fused_attn_eligible(layer_params: dict, mask, spec: ModelSpec, cos) -> bool:
    """The layer-level conditions of the fused attention block B8 (the
    reference's ``_fused_attn_eligible``; the step-level ones, the
    contiguous cache among them, come from :func:`run_decoder_layers`):
    rmsnorm, a plain fused ``qkv_proj`` and ``o_proj``, full rotary, and the
    gate of ``kernel_mode.use_fused_attn_block``."""
    sa = layer_params.get("self_attn", {})
    return (
        spec.norm_type == "rmsnorm"
        and "qkv_proj" in sa
        and _plain_weight(sa["qkv_proj"])
        and _plain_weight(sa.get("o_proj"))
        and cos.shape[-1] * 2 == spec.attn.head_dim
        and use_fused_attn_block(spec.attn, mask.shape[-2])
    )


def _decoder_layer_mlp(layer_params: dict, hidden, spec: ModelSpec, mlp_fn: Callable, fused_ok: bool):
    """Post-attention norm, MLP and residual; through the fused MLP block B9
    when the step, the MLP (a gated MLP of plain weights) and
    ``kernel_mode.use_fused_mlp`` allow it (the reference's
    ``_decoder_layer_mlp``)."""
    mp = layer_params["mlp"]
    if (
        fused_ok
        and mlp_fn is gated_mlp
        and use_fused_mlp(spec)
        and all(_plain_weight(mp.get(k)) for k in ("gate_proj", "up_proj", "down_proj"))
    ):
        from neuronx_distributed_inference_tpu_torch.ops.decode_block import fused_mlp_block

        return fused_mlp_block(
            hidden, layer_params["post_attention_layernorm"]["weight"], mp["gate_proj"]["weight"],
            mp["up_proj"]["weight"], mp["down_proj"]["weight"], eps=spec.rms_eps, act=spec.act,
        )
    residual = hidden
    hidden = apply_norm(
        hidden, layer_params["post_attention_layernorm"]["weight"], spec.rms_eps, spec.norm_type
    )
    return residual + mlp_fn(mp, hidden, spec)


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
    # run_decoder_layers certifies the step-level conditions of the fused
    # decode kernels (decode over the contiguous cache)
    fused_ok: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decoder layer, write-then-attend: this layer's new K/V go into the
    full stacked cache first (in place; through ``slot_mapping`` on the
    paged cache), then prefill attends the in-flight K/V and decode attends
    the cache. Returns (hidden, k_cache, v_cache).

    A decode step that qualifies runs the attention half as the fused block
    B8, which returns the new K/V for the scatter after it, and the MLP half
    as the fused block B9 (:func:`_decoder_layer_mlp`)."""
    aspec = spec.attn
    if fused_ok and _fused_attn_eligible(layer_params, mask, spec, cos):
        from neuronx_distributed_inference_tpu_torch.ops.decode_block import fused_attn_block

        sa = layer_params["self_attn"]
        hidden, k_new, v_new = fused_attn_block(
            hidden, layer_params["input_layernorm"]["weight"], sa["qkv_proj"]["weight"],
            sa["o_proj"]["weight"], cos, sin, k_cache, v_cache, layer_idx, slot_ids, mask, positions,
            scale=aspec.softmax_scale, eps=spec.rms_eps, n_kv=aspec.num_kv_heads,
        )
        k_cache, v_cache = update_cache_at_layer(
            k_cache, v_cache, k_new, v_new, layer_idx, slot_ids, positions
        )
        return _decoder_layer_mlp(layer_params, hidden, spec, mlp_fn, fused_ok), k_cache, v_cache
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
    return _decoder_layer_mlp(layer_params, hidden, spec, mlp_fn, fused_ok), k_cache, v_cache


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
    transposed copy of the embedding for tied models, quantized like any
    other linear while the embedding stays in the compute dtype) through
    ``ops/quant.linear``, fp32 cast, padded vocab tail filled with the
    dtype's most negative value."""
    logits = linear(params["lm_head"], hidden)
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
    # the step-level conditions of the fused decode kernels (the reference's
    # fused_eligible): decode over the contiguous cache; the mixed step
    # (mixed_forward) never reaches here
    fused_ok = phase != PHASE_CONTEXT_ENCODING and not is_block
    layers: Union[Dict, List[Dict]] = params["layers"]
    if isinstance(layers, dict):
        layers = unstack_layers(layers)
    k_cache, v_cache = cache.k, cache.v
    for li, layer_params in enumerate(layers):
        hidden, k_cache, v_cache = decoder_layer(
            layer_params, hidden, cos, sin, k_cache, v_cache, li, mask, slot_ids,
            positions, spec, phase, mlp_fn, key_valid=key_valid, block_inputs=block_inputs,
            fused_ok=fused_ok,
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


def _next_tokens(
    logits: torch.Tensor, sampling_params: torch.Tensor, spec: ModelSpec, generator=None
) -> torch.Tensor:
    """Next tokens (greedy, or drawn with ``generator`` when the spec
    samples), non-finite rows marked."""
    tokens = sample_tokens(logits, sampling_params, generator, spec.max_topk, spec.do_sample)
    return mark_non_finite_tokens(tokens, logits)


@dataclass
class DecodeState:
    """The device state one decode step reads and advances in place: the
    inputs of :func:`decode_step`. A captured step reads these buffers at
    fixed addresses; the runner refills them before a chunk
    (``runtime/model_runner.SubModelRunner.decode_chunk``, whose loop over
    the steps is the reference's ``decode_steps`` scan)."""

    last: torch.Tensor  # (B, 1) int32 token to feed
    pos: torch.Tensor  # (B, 1) int32 its write position
    seq_ids: torch.Tensor  # (B,)
    sampling_params: torch.Tensor  # (B, 3) float32
    cols: torch.Tensor  # (1, bucket) int32 arange: the mask is cols <= pos
    block_table: Optional[torch.Tensor] = None  # (B, MB) on the paged cache


def decode_step(
    params: dict,
    cache: Cache,
    st: DecodeState,
    *,
    spec: ModelSpec,
    mlp_fn: Callable = gated_mlp,
    generator=None,
):
    """One whole decode iteration with no host read: the mask is built on
    the device from ``cols <= pos``, and ``st.last`` / ``st.pos`` advance in
    place to the new token and the next position, so the same step runs
    again (eagerly, or as a replay of its captured graph) without the host.
    Returns (tokens (B,), logits (B, V) | None)."""
    inputs = StepInputs(
        input_ids=st.last,
        attention_mask=(st.cols <= st.pos).to(torch.int32),
        position_ids=st.pos,
        seq_ids=st.seq_ids,
        sampling_params=st.sampling_params,
        block_table=st.block_table,
    )
    logits, _ = model_logits(params, cache, inputs, spec=spec, phase=PHASE_TOKEN_GENERATION, mlp_fn=mlp_fn)
    tok = _next_tokens(logits, st.sampling_params, spec, generator)
    st.last.copy_(tok)
    st.pos.add_(1)
    return tok[:, 0], (logits[:, 0] if spec.output_logits else None)


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
    tokens = _next_tokens(logits, inputs.sampling_params, spec)
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
    generator=None,
) -> StepOutput:
    """One step (counterpart of the reference ``forward``); ``generator``
    draws the tokens when the spec samples."""
    logits, new_cache = model_logits(params, cache, inputs, spec=spec, phase=phase, mlp_fn=mlp_fn)
    tokens = _next_tokens(logits, inputs.sampling_params, spec, generator)
    return StepOutput(
        tokens=tokens, logits=logits if spec.output_logits else None, cache=new_cache
    )
