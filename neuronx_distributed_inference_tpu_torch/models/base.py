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
token axis and runs its attention through the B3 ragged kernel; its
``spec_width > 1`` form also packs spec-verify rows and counts their
accepted drafts on the device, and :func:`draft_chain_propose` runs a
draft's next proposals from that output. The config tri-states turn the
kernels off.

Sliding-window attention (Mistral, GPT-OSS's sliding layers) runs as the
reference runs it. A layer's window bounds its masks and its B2 prefill; on
a ring cache (``ModelSpec.bounded_window``: every layer rings W slots;
``ModelSpec.ring_window``: the :class:`InterleavedKVCache` of an
interleaved sliding/global stack, described by ``layer_groups``) a ring
layer's decode and multi-token passes attend the W prior ring slots plus
the in-flight chunk (:func:`ring_attention`, plain PyTorch, as in the
reference), and the writes go to slot ``position mod W``. The reference
picks a layer's flavor inside its ``lax.scan``; here the layer loop knows
each layer's flavor in Python, so a captured step is one static sequence.
An interleaved stack's global layers decode through B1 over their
full-length lines, with the model's learned sinks. Over the paged cache
only a model with no window, no chunk and no sink anywhere takes B5; the
others send passes of at most 16 tokens to B4 with their masks and sinks,
and longer ones to the plain block gather.

Chunked attention (``attention_chunk_size``, Llama4's rope layers) keeps
full-length cache lines: a query attends causally within its own block of
``chunk`` positions. Its prefill is B2 with the chunk predicate, its decode
B1 / B4 under the chunk mask (:func:`build_mask`), as the reference runs it.

A builder's ``layer_fn()`` / ``mlp_fn()`` may be lists that the layer loop
indexes by each layer group's ``LayerGroupSpec.fn_idx`` (DeepSeek-V3: MLA
layers, a dense MLP on the first group and the MoE block on the next); the
params' ``layers`` is then a list of the groups' stacks (:func:`flat_layers`).

An int8/fp8 ``kv_cache_dtype`` makes the cache's streams ``QuantizedKV``:
the writes quantize in place, B1, B4, B5 and B3 run their code modes on
the codes and the layer's scales, and B8 is not taken (it streams the cache
in its storage dtype; B9 still is). Prefill attention (B2) attends the
in-flight K/V and does not change.
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
    InterleavedKVCache,
    KVCache,
    QuantizedKV,
    kv_batch_size,
    layer_streams,
    read_cache_at_layer,
    ring_positions,
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
class LayerGroupSpec:
    """One contiguous run of layers of one attention flavor and one pair of
    layer functions (the reference's ``LayerGroupSpec``): GPT-OSS's
    alternating sliding / global layers are a sequence of these, and so are
    DeepSeek-V3's dense-first and MoE layers and Llama4's chunked-rope and
    global NoPE runs, whose ``fn_idx`` picks each group's entry of the
    builder's ``layer_fn()`` / ``mlp_fn()`` lists."""

    num_layers: int
    sliding_window: Optional[int] = None
    attention_chunk_size: Optional[int] = None
    # index into the layer_fn / mlp_fn lists the builder provides
    fn_idx: int = 0


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
    # sliding-window attention of every layer (Mistral)
    sliding_window: Optional[int] = None
    # chunked attention of every layer (Config.attention_chunk_size)
    attention_chunk_size: Optional[int] = None
    # the contiguous cache is a ring of this many slots a line (the window;
    # builder._finalize_bounded)
    bounded_window: Optional[int] = None
    # interleaved per-layer cache (GPT-OSS): the sliding layers ring-bound
    # to this window, the global layers on full-length lines
    ring_window: Optional[int] = None
    # the attention flavor of each run of layers; None = one uniform group
    # with the spec-level sliding_window and attention_chunk_size
    layer_groups: Optional[Tuple[LayerGroupSpec, ...]] = None


#: a layer's attention flavor: (sliding window, chunk), None where unset
Flavor = Tuple[Optional[int], Optional[int]]


def layer_flavors(spec: ModelSpec, num_layers: int) -> List[Flavor]:
    """The (sliding window, attention chunk) of each layer; (None, None) is
    global attention."""
    if spec.layer_groups is None:
        return [(spec.sliding_window, spec.attention_chunk_size)] * num_layers
    flavors = [
        (g.sliding_window, g.attention_chunk_size) for g in spec.layer_groups for _ in range(g.num_layers)
    ]
    if len(flavors) != num_layers:
        raise ValueError(f"layer_groups mismatch: spec says {len(flavors)} layers, params carry {num_layers}")
    return flavors


def layer_fn_indices(spec: ModelSpec, num_layers: int) -> List[int]:
    """The ``fn_idx`` of each layer (0 for a uniform stack)."""
    if spec.layer_groups is None:
        return [0] * num_layers
    return [g.fn_idx for g in spec.layer_groups for _ in range(g.num_layers)]


def _pick(fns, idx: int):
    """A group's entry of a ``layer_fn`` / ``mlp_fn`` list; a single
    function (or None) serves every group."""
    return fns[idx] if isinstance(fns, (list, tuple)) else fns


def plain_attention(spec: ModelSpec) -> bool:
    """No sliding window and no attention chunk in the model or in any of
    its layer groups, and no learned sink: the masks the B5 and B3 kernels
    build are the whole mask (the reference's ``plain_model`` gate)."""
    groups = spec.layer_groups or ()
    return not (
        spec.sliding_window
        or spec.attention_chunk_size
        or spec.attn.has_sink
        or any(g.sliding_window or g.attention_chunk_size for g in groups)
    )


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
    # token trees (modules/token_tree.py): tree nodes write distinct cache
    # slots (position_ids) at rope positions of their depth (these)
    rope_position_ids: Optional[torch.Tensor] = None  # (B, S)
    # a whole attention mask (B, 1, S, bucket), used as it is: a tree's
    # ancestry mask placed at the cache tail
    mask_override: Optional[torch.Tensor] = None
    # (B,) LoRA adapter slot of each row (modules/lora.py; 0 = the base model)
    adapter_ids: Optional[torch.Tensor] = None
    # (B, S, H) input embeddings that replace embed(input_ids): a multimodal
    # prefill's text embeddings with the image features spliced in at the
    # placeholder positions (runtime/image_to_text.py); input_ids still
    # carries the shapes
    inputs_embeds: Optional[torch.Tensor] = None


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
    # speculative verification (the mixed_step_spec family, spec_width > 1):
    # verify_len[r] is row r's verify-window width (1 for plain rows; a spec
    # row's last token plus its drafts); draft_tokens is the draft's (R,
    # spec_width - 1) proposal matrix, still on the device, which chain_src
    # then indexes FLATTENED (r * (spec_width - 1) + j) instead of by row
    verify_len: Optional[torch.Tensor] = None  # (R,) int
    draft_tokens: Optional[torch.Tensor] = None  # (R, spec_width - 1) int


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


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_prior: torch.Tensor,
    v_prior: torch.Tensor,
    positions: torch.Tensor,
    W: int,
    aspec: AttnSpec,
    sink: Optional[torch.Tensor],
) -> torch.Tensor:
    """Decode / multi-token attention of a ring layer (the reference's
    ``ring_attention``): one softmax over [the W prior ring slots | the
    in-flight chunk], masked from absolute positions. ``k_prior`` /
    ``v_prior`` (B, W, Hkv, D) are the ring as it was BEFORE this chunk's
    writes (the caller attends before it writes); ``positions`` (B, S) are
    absolute, negative for padded tokens."""
    p = positions.to(torch.int64)
    head = p[:, :1] - 1  # (B, 1) the last position before the chunk
    slots = torch.arange(W, device=p.device)[None, :]
    # the position ring slot s held before the chunk wrote anything
    slot_pos = head - torch.remainder(head - slots, W)  # (B, W)
    # a slot before the chunk lies below every valid query's position, and a
    # padded query's is below every filled slot's
    prior_ok = masks.windowed_token_gen_mask(slot_pos, p, slot_pos >= 0, W)  # (B, 1, S, W)
    qp = p[:, None, :, None]  # (B, 1, S, 1)
    kp = p[:, None, None, :]  # (B, 1, 1, S)
    active_ok = (kp >= 0) & (kp <= qp) & (kp > qp - W)
    mask = torch.cat([prior_ok, active_ok], dim=-1)
    keys = torch.cat([k_prior.to(k.dtype), k], dim=1)
    vals = torch.cat([v_prior.to(v.dtype), v], dim=1)
    return attention_decode(q, keys, vals, mask, aspec, sink=sink)


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
    (no bucket-slice copy). A pass of more than MAX_Q_LEN (16) queries a
    row (a window of a windowed prefill) and ``use_tkg_kernel=False`` take
    the bucket slice and the plain masked softmax, as the reference's gate
    (``use_tkg``: q_len <= 16) sends them to its native path."""
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
    plain_model: bool = True,
) -> torch.Tensor:
    """Attention of a token-generation pass over one layer of the paged
    cache (the reference's ``decoder_layer`` block branch, ``base.py:619-703``).
    B5 implements the causal + prefix mask only, so it takes a pass (of 8
    tokens or more) only for a ``plain_model`` (:func:`plain_attention`: no
    window, no chunk and no sink anywhere). Other passes of at most 16
    tokens go to the B4 paged decode kernel's wrapper with the layer's mask
    and sink; longer ones of a windowed, chunked or sink model, and every
    pass with the tri-states off, take the plain block gather and masked
    softmax, as the reference's ``use_tkg`` gate (q_len <= 16) sends them."""
    from neuronx_distributed_inference_tpu_torch.ops.decode_attention import MAX_Q_LEN

    Sq = q.shape[1]
    if plain_model and use_paged_flash(aspec, Sq):
        from neuronx_distributed_inference_tpu_torch.ops.paged_flash_attention import (
            paged_flash_attention,
        )

        # a quantized cache hands the kernel this layer's code blocks and
        # views of its per-head scales (the reference's base.py:642-661)
        k_l, v_l, codes = layer_streams(k_cache, v_cache, layer_idx)
        return paged_flash_attention(
            q, k_l, v_l, block_table, positions, kv_limit,
            scale=aspec.softmax_scale, n_rep=aspec.num_heads // aspec.num_kv_heads, **codes,
        )
    if use_tkg(aspec) and Sq <= MAX_Q_LEN:
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
    """True when a projection entry is a plain unquantized, un-LoRA'd,
    bias-free weight the fused kernels can stream directly (an entry with
    adapters attached is not, whether a step passes adapter ids or not)."""
    return (
        isinstance(entry, dict)
        and "weight" in entry
        and "scale" not in entry
        and "lora_A" not in entry
        and "bias" not in entry
    )


def _fused_attn_eligible(layer_params: dict, mask, spec: ModelSpec, cos, k_cache, window, chunk) -> bool:
    """The layer-level conditions of the fused attention block B8 (the
    reference's ``_fused_attn_eligible``; the step-level ones, the
    contiguous full-length cache among them, come from
    :func:`run_decoder_layers`): a plain cache (a quantized one takes B1's
    code mode: B8 streams the cache in its storage dtype), rmsnorm (DBRX's
    LayerNorm stays off B8, as its ``qkv_clip`` does through
    ``use_fused_attn_block``), a plain
    fused ``qkv_proj`` and ``o_proj``, full rotary, one new token a row for
    a windowed or chunked layer (B8's in-flight part is purely causal; the
    window or chunk bounds its prior part through the mask), and the gate
    of ``kernel_mode.use_fused_attn_block``."""
    sa = layer_params.get("self_attn", {})
    return (
        not isinstance(k_cache, QuantizedKV)
        and ((window is None and chunk is None) or mask.shape[-2] == 1)
        and spec.norm_type == "rmsnorm"
        and spec.attn.qkv_clip is None
        and "qkv_proj" in sa
        and _plain_weight(sa["qkv_proj"])
        and _plain_weight(sa.get("o_proj"))
        and cos.shape[-1] * 2 == spec.attn.head_dim
        and use_fused_attn_block(spec.attn, mask.shape[-2])
    )


def _decoder_layer_mlp(
    layer_params: dict, hidden, spec: ModelSpec, mlp_fn: Callable, fused_ok: bool, adapter_ids=None
):
    """Post-attention norm, MLP and residual; through the fused MLP block B9
    when the step (no adapter ids), the MLP (a gated MLP of plain weights)
    and ``kernel_mode.use_fused_mlp`` allow it (the reference's
    ``_decoder_layer_mlp``)."""
    mp = layer_params["mlp"]
    if (
        fused_ok
        and mlp_fn is gated_mlp
        and adapter_ids is None
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
    # this layer's sliding window and attention chunk (None: unbounded)
    window: Optional[int] = None,
    chunk: Optional[int] = None,
    # W when (k_cache, v_cache) holds this layer as a ring of W slots a line
    ring: Optional[int] = None,
    # False when the model has a window, a chunk or a sink anywhere
    # (plain_attention)
    plain_model: bool = True,
    # (B,) LoRA adapter slot of each row: the attention projections add
    # its delta (modules/lora.py)
    adapter_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decoder layer, write-then-attend: this layer's new K/V go into the
    full stacked cache first (in place; through ``slot_mapping`` on the
    paged cache), then prefill attends the in-flight K/V and decode attends
    the cache. Returns (hidden, k_cache, v_cache).

    A ring layer (``ring``: the bounded cache, or an interleaved stack's
    ring) writes slot ``position mod W``; its decode and multi-token passes
    attend the W prior slots and the chunk (:func:`ring_attention`), BEFORE
    the chunk's writes land, since a write may overwrite a slot an earlier
    query of the chunk still reads.

    A decode step that qualifies runs the attention half as the fused block
    B8, which returns the new K/V for the scatter after it, and the MLP half
    as the fused block B9 (:func:`_decoder_layer_mlp`)."""
    aspec = spec.attn
    if fused_ok and _fused_attn_eligible(layer_params, mask, spec, cos, k_cache, window, chunk):
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
        return _decoder_layer_mlp(layer_params, hidden, spec, mlp_fn, fused_ok, adapter_ids), k_cache, v_cache
    residual = hidden
    hidden = apply_norm(
        hidden, layer_params["input_layernorm"]["weight"], spec.rms_eps, spec.norm_type
    )
    q, k, v = qkv_project(layer_params["self_attn"], hidden, cos, sin, aspec, adapter_ids)
    sink = layer_params["self_attn"].get("sink", {}).get("weight") if aspec.has_sink else None
    if ring is not None and phase != PHASE_CONTEXT_ENCODING:
        # attend the prior ring (views of the cache) before the writes land
        k_prior, v_prior = read_cache_at_layer(k_cache, v_cache, layer_idx, q.shape[0], ring)
        attn_out = ring_attention(q, k, v, k_prior, v_prior, positions, ring, aspec, sink)
        k_cache, v_cache = update_cache_at_layer(
            k_cache, v_cache, k, v, layer_idx, slot_ids, ring_positions(positions, ring)
        )
        return _finish_layer(layer_params, residual, attn_out, spec, mlp_fn, fused_ok, adapter_ids), k_cache, v_cache
    if block_inputs is not None:
        k_cache, v_cache = update_block_cache_at_layer(
            k_cache, v_cache, k, v, layer_idx, block_inputs[0]
        )
    else:
        write_pos = positions if ring is None else ring_positions(positions, ring)
        k_cache, v_cache = update_cache_at_layer(
            k_cache, v_cache, k, v, layer_idx, slot_ids, write_pos
        )
    if phase == PHASE_CONTEXT_ENCODING:
        attn_out = attention_prefill(
            q, k, v, mask, aspec, sink=sink, key_valid=key_valid, window=window, chunk=chunk
        )
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
            q, k_cache, v_cache, layer_idx, mask, positions, block_table, kv_limit, aspec, sink,
            plain_model=plain_model,
        )
    else:
        attn_out = contiguous_decode_attend(
            q, k_cache, v_cache, layer_idx, mask, spec, aspec, sink
        )
    return _finish_layer(layer_params, residual, attn_out, spec, mlp_fn, fused_ok, adapter_ids), k_cache, v_cache


def _finish_layer(
    layer_params: dict, residual, attn_out, spec: ModelSpec, mlp_fn: Callable, fused_ok: bool, adapter_ids=None
):
    """o projection and residual, then the MLP half."""
    hidden = residual + o_project(layer_params["self_attn"], attn_out, spec.attn, adapter_ids)
    return _decoder_layer_mlp(layer_params, hidden, spec, mlp_fn, fused_ok, adapter_ids)


def build_mask(
    inputs: StepInputs,
    spec: ModelSpec,
    phase: str,
    window: Optional[int] = None,
    chunk: Optional[int] = None,
) -> torch.Tensor:
    """``inputs.mask_override`` when it is set; else the causal mask for
    prefill (chunked when ``chunk`` is set, else windowed when ``window``
    is), and for token generation the cache-validity mask, per token
    (causal among the new tokens) when a pass carries more than one,
    bounded to (pos - window, pos] when ``window`` is set and to the
    query's own block of ``chunk`` positions when ``chunk`` is."""
    if inputs.mask_override is not None:
        return inputs.mask_override
    n_active = inputs.input_ids.shape[1]
    if phase == PHASE_CONTEXT_ENCODING:
        if chunk:
            return masks.chunked_mask(inputs.attention_mask, inputs.position_ids, chunk)
        if window:
            return masks.windowed_mask(inputs.attention_mask, inputs.position_ids, window)
        return masks.causal_mask(inputs.attention_mask)
    if n_active > 1:
        mask = masks.spec_token_gen_mask(inputs.attention_mask, inputs.position_ids)
    else:
        mask = masks.token_gen_mask(inputs.attention_mask, n_active)
    if window or chunk:
        cols = torch.arange(mask.shape[-1], device=mask.device)[None, None, None, :]
        pos = inputs.position_ids[:, None, :, None]  # (B, 1, K, 1)
        if window:
            mask = mask & (cols > pos - window)
        if chunk:
            mask = mask & (torch.div(cols, chunk, rounding_mode="floor") == torch.div(pos, chunk, rounding_mode="floor"))
    return mask


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


def _is_group_stack(tree) -> bool:
    """True for a stacked (L, ...) layer group: its norm weight has a layer
    axis ((L, H)), a prepared layer's has none ((H,))."""
    return isinstance(tree, dict) and tree["input_layernorm"]["weight"].dim() == 2


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


def flat_layers(layers: Union[Dict, List[Dict]]) -> List[Dict]:
    """The per-layer list of a layer tree: one stacked (L, ...) dict, a list
    of stacked groups with different leaves (the reference's per-group
    stacks, DeepSeek-V3's dense-first and MoE layers), or a list of
    prepared layers, returned as it is."""
    if isinstance(layers, dict):
        return unstack_layers(layers)
    if layers and _is_group_stack(layers[0]):
        return [lp for group in layers for lp in unstack_layers(group)]
    return layers


def prepare_params(params: Dict) -> Dict:
    """A shallow copy whose ``layers`` is the per-layer list the layer loop
    walks (views; no weight is copied). Loaded apps run on this form."""
    out = dict(params)
    out["layers"] = flat_layers(out["layers"])
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
    capture_layers: Optional[Tuple[int, ...]] = None,
    layer_fn: Optional[Callable] = None,
):
    """Layer stack + final norm over an embedded hidden state (one Python
    loop over the layers, the cache updated in place). Returns (hidden,
    cache).

    ``mlp_fn`` and ``layer_fn`` (None: :func:`decoder_layer`) may be lists
    indexed by each layer group's ``fn_idx`` (DeepSeek-V3: a dense MLP on
    the first layers, the MoE block on the rest, every layer MLA); the loop
    stays one static sequence of Python calls, so a captured step holds
    each layer's own functions.

    Each layer takes its flavor's mask (:func:`layer_flavors`: one mask per
    distinct (window, chunk), built once a step) and its cache: a ring
    layer of the bounded cache or of an :class:`InterleavedKVCache` its
    ring stack at its ring index, a global layer of an interleaved cache
    the full stack at its full index. Ring layers build their decode masks
    from positions (:func:`ring_attention`), so no dense mask is built for
    them.

    RoPE takes ``inputs.rope_position_ids`` when it is set (tree nodes at
    their depth) and the cache is written at ``inputs.position_ids``.
    ``capture_layers`` (EAGLE3): a third value, the (B, S, C*H) concat of
    the named layers' outputs (before the final norm), in tap order."""
    rope_pos = inputs.rope_position_ids if inputs.rope_position_ids is not None else inputs.position_ids
    cos, sin = rope_cos_sin(rope_pos, params["rope"]["inv_freq"], spec.attention_scaling)
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
    plain_model = plain_attention(spec)
    # the flash kernels mask from key_valid / kv_limit themselves: only the
    # plain paths need the dense masks
    flash = key_valid is not None and use_flash(spec.attn)
    paged_flash = (
        is_block and phase != PHASE_CONTEXT_ENCODING and plain_model
        and use_paged_flash(spec.attn, inputs.input_ids.shape[1])
    )
    layers = flat_layers(params["layers"])
    flavors = layer_flavors(spec, len(layers))
    fn_idx = layer_fn_indices(spec, len(layers))
    # a custom layer (MLA) computes its attention from the dense mask
    custom = any(_pick(layer_fn, i) is not None for i in set(fn_idx))
    interleaved = isinstance(cache, InterleavedKVCache)
    bounded = spec.bounded_window if not is_block else None
    # ring layers decode from positions; every other layer reads its
    # flavor's mask
    ring_decode = phase != PHASE_CONTEXT_ENCODING and (bounded or interleaved)
    flavor_masks: Dict[Flavor, Optional[torch.Tensor]] = {}
    for w, c in flavors:
        if (w, c) not in flavor_masks:
            skip = not custom and (flash or paged_flash or (ring_decode and (bounded or w is not None)))
            flavor_masks[w, c] = None if skip else build_mask(inputs, spec, phase, window=w, chunk=c)
    # the step-level conditions of the fused decode kernels (the reference's
    # fused_eligible): decode over the contiguous full-length cache at
    # contiguous write positions (B8 builds its own causal mask and ropes at
    # the write position: no tree's rope or mask), no adapter ids; the mixed
    # step (mixed_forward) never reaches here
    fused_ok = (
        phase != PHASE_CONTEXT_ENCODING
        and not is_block
        and not bounded
        and not interleaved
        and inputs.rope_position_ids is None
        and inputs.mask_override is None
        and inputs.adapter_ids is None
    )
    # the adapter ids reach the layers that take them (the shared decoder
    # layer; the custom layers belong to families that refuse LoRA)
    lora_kw = {} if inputs.adapter_ids is None else {"adapter_ids": inputs.adapter_ids}
    captured = [None] * len(capture_layers) if capture_layers is not None else None
    if interleaved:
        streams = {
            False: (cache.k_full, cache.v_full), True: (cache.k_ring, cache.v_ring),
        }
        n_seen = {False: 0, True: 0}
    else:
        k_cache, v_cache = cache.k, cache.v
    for li, (layer_params, (w, c)) in enumerate(zip(layers, flavors)):
        ring = bounded
        idx = li
        if interleaved:
            sliding = w is not None
            ring = spec.ring_window if sliding else None
            k_cache, v_cache = streams[sliding]
            idx = n_seen[sliding]
            n_seen[sliding] += 1
        layer = _pick(layer_fn, fn_idx[li]) or decoder_layer
        hidden, k_cache, v_cache = layer(
            layer_params, hidden, cos, sin, k_cache, v_cache, idx, flavor_masks[w, c], slot_ids,
            positions, spec, phase, _pick(mlp_fn, fn_idx[li]), key_valid=key_valid,
            block_inputs=block_inputs, fused_ok=fused_ok, window=w, chunk=c, ring=ring, plain_model=plain_model,
            **lora_kw,
        )
        if interleaved:
            streams[w is not None] = (k_cache, v_cache)
        if captured is not None:
            for j, tap in enumerate(capture_layers):
                if tap == li:
                    captured[j] = hidden
    hidden = apply_norm(hidden, params["norm"]["weight"], spec.rms_eps, spec.norm_type)
    if interleaved:
        (k_full, v_full), (k_ring, v_ring) = streams[False], streams[True]
        new_cache = InterleavedKVCache(k_full=k_full, v_full=v_full, k_ring=k_ring, v_ring=v_ring)
    else:
        new_cache = type(cache)(k=k_cache, v=v_cache)
    if captured is not None:
        return hidden, new_cache, torch.cat(captured, dim=-1)
    return hidden, new_cache


def model_logits(
    params: dict,
    cache: Cache,
    inputs: StepInputs,
    *,
    spec: ModelSpec,
    phase: str,
    mlp_fn: Callable = gated_mlp,
    return_hidden: bool = False,
    capture_layers: Optional[Tuple[int, ...]] = None,
    layer_fn: Optional[Callable] = None,
):
    """Backbone + lm head, no sampling: (logits (B, K, V), cache), and with
    ``return_hidden`` the full-sequence hidden states after the final norm
    as a third value, or with ``capture_layers`` too (EAGLE3) the (B, S,
    C*H) capture concat in their place. ``inputs.inputs_embeds`` replaces
    the token embeddings when it is set."""
    hidden = inputs.inputs_embeds if inputs.inputs_embeds is not None else embed(params, inputs.input_ids)
    out = run_decoder_layers(
        params, hidden, cache, inputs, spec=spec, phase=phase, mlp_fn=mlp_fn, capture_layers=capture_layers,
        layer_fn=layer_fn,
    )
    hidden, new_cache = out[:2]
    full_hidden = out[2] if capture_layers is not None else hidden
    if phase == PHASE_CONTEXT_ENCODING:
        hidden = gather_last_token(hidden, inputs.attention_mask)
    logits = lm_head(params, hidden, spec)[..., : spec.vocab_size]
    if return_hidden:
        return logits, new_cache, full_hidden
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
    adapter_ids: Optional[torch.Tensor] = None  # (B,) LoRA slots


def decode_step(
    params: dict,
    cache: Cache,
    st: DecodeState,
    *,
    spec: ModelSpec,
    mlp_fn: Callable = gated_mlp,
    generator=None,
    layer_fn: Optional[Callable] = None,
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
        adapter_ids=st.adapter_ids,
    )
    logits, _ = model_logits(
        params, cache, inputs, spec=spec, phase=PHASE_TOKEN_GENERATION, mlp_fn=mlp_fn, layer_fn=layer_fn
    )
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
    tokens the host ignores.

    ``spec_width > 1`` is the speculative-verification program (the
    ``mixed_step_spec`` family): a spec row's segment is its last committed
    token followed by its drafts, gathered on the device from
    ``inputs.draft_tokens``; to B3 it is one more multi-token row under the
    causal mask. The program reads each row's last ``verify_len[r]``
    positions, runs the lm head over the (R, spec_width) window and returns
    tokens (R, spec_width + 1): columns [0, spec_width) are the greedy token
    after each window position (column 0 is THE token of a plain row) and
    column spec_width is the accepted count in [1, verify_len[r]], the
    leading matches of the drafts plus one, computed on the device. Rejected
    draft K/V needs no rollback: those positions are written again next
    round before anything attends them."""
    if spec.layer_groups is not None or spec.bounded_window or spec.ring_window:
        raise NotImplementedError(
            "the ragged mixed step supports uniform full-length layer stacks "
            "only (no ring-bounded/interleaved caches or layer groups)"
        )
    if spec.sliding_window or spec.attention_chunk_size or spec.attn.has_sink:
        raise NotImplementedError(
            "the ragged paged kernel implements the plain causal+prefix mask "
            "only (no sliding-window/chunked attention, no sinks)"
        )

    input_ids = inputs.input_ids
    if spec_width > 1 and inputs.draft_tokens is not None and inputs.chain_src is not None:
        # device-side draft gather: packed slots whose chain_src >= 0 take
        # their id from the flattened (R, spec_width - 1) proposal matrix. A
        # draft's NON_FINITE sentinel (-1) clamps to token 0: a poisoned
        # draft only costs acceptance, never output correctness
        flat = torch.clamp(inputs.draft_tokens.reshape(-1), min=0)
        src = inputs.chain_src.to(torch.int64)
        gathered = flat[torch.clamp(src, 0, flat.shape[0] - 1)]
        input_ids = torch.where(src >= 0, gathered.to(input_ids.dtype), input_ids)
    elif inputs.chain_tokens is not None and inputs.chain_src is not None:
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
    layers = flat_layers(params["layers"])
    k_cache, v_cache = cache.k, cache.v
    for li, layer_params in enumerate(layers):
        hidden, k_cache, v_cache = decoder_layer(
            layer_params, hidden, cos, sin, k_cache, v_cache, li, None, None, positions, spec,
            PHASE_MIXED, mlp_fn, block_inputs=block_inputs, ragged_rows=ragged,
        )
    hidden = apply_norm(hidden, params["norm"]["weight"], spec.rms_eps, spec.norm_type)
    T = hidden.shape[1]
    new_cache = type(cache)(k=k_cache, v=v_cache)
    row_start = inputs.row_start.to(torch.int64)
    row_end = row_start + inputs.row_len.to(torch.int64)
    if spec_width == 1:
        # per-row last-token gather off the packed axis; inactive rows clamp
        # to slot 0, which the host never reads
        last_idx = torch.clamp(row_end - 1, 0, T - 1)
        rows_h = hidden[0][last_idx][:, None, :]  # (R, 1, H)
        logits = lm_head(params, rows_h, spec)[..., : spec.vocab_size]  # (R, 1, V)
        tokens = _next_tokens(logits, inputs.sampling_params, spec)
        return StepOutput(tokens=tokens, logits=logits if spec.output_logits else None, cache=new_cache)

    # spec_width > 1: each row's verify window and greedy acceptance, on the
    # device (the spec-ragged path is greedy by config)
    R = row_start.shape[0]
    verify_len = inputs.verify_len if inputs.verify_len is not None else torch.ones_like(inputs.row_len)
    v = torch.clamp(verify_len.to(torch.int64), 1, spec_width)[:, None]  # (R, 1)
    # column j reads window base + j, clamped to the row's last position
    # past verify_len (duplicates the host never reads)
    base = row_end - v[:, 0]
    j = torch.arange(spec_width, device=hidden.device)[None, :]
    win_idx = torch.clamp(base[:, None] + torch.minimum(j, v - 1), 0, T - 1)  # (R, S)
    rows_h = hidden[0][win_idx.reshape(-1)].reshape(R, spec_width, -1)
    logits = lm_head(params, rows_h, spec)[..., : spec.vocab_size]  # (R, S, V)
    tokens = mark_non_finite_tokens(torch.argmax(logits, dim=-1).to(torch.int32), logits)
    # count = 1 + the leading matches of the drafted ids (window position
    # base + j + 1 holds draft j + 1) with the greedy tokens; a NON_FINITE
    # token (-1) matches no id, so acceptance stops there
    drafted = input_ids[0][torch.clamp(win_idx + 1, 0, T - 1).reshape(-1)].reshape(R, spec_width)
    match = (drafted[:, :-1].to(torch.int32) == tokens[:, :-1]) & (j[:, :-1] + 1 < v)
    counts = 1 + torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)  # (R,) in [1, verify_len]
    tokens = torch.cat([tokens, counts[:, None].to(torch.int32)], dim=1)  # (R, spec_width + 1)
    return StepOutput(tokens=tokens, logits=logits if spec.output_logits else None, cache=new_cache)


def draft_chain_propose(
    params: dict,
    cache: Cache,
    st: DecodeState,
    prev_tokens: torch.Tensor,
    fallback_last: torch.Tensor,
    fallback_pos: torch.Tensor,
    use_chain: torch.Tensor,
    p0_base: torch.Tensor,
    *,
    spec: ModelSpec,
    num_steps: int,
    spec_width: int,
    mlp_fn: Callable = gated_mlp,
) -> torch.Tensor:
    """Draft proposals chained on the previous spec mixed step's output (the
    reference's ``draft_chain_propose``). Each row's frontier, its last
    ACCEPTED token and the position after it, is derived on the device from
    ``prev_tokens`` (R, spec_width + 1) where ``use_chain`` is set (else the
    host's ``fallback_last`` / ``fallback_pos``), written into ``st``, and
    ``num_steps`` greedy decode steps (:func:`decode_step`) run from it, so
    the accepted-token frontier never visits the host between verify and
    the next draft. A non-finite frontier (-1) clamps to token 0: the
    poisoned row's proposals are discarded at its quarantine. ``st`` carries
    the seq ids (-1: the garbage line), the sampling params and the
    bucket's columns; ``p0_base`` (R, 1) is each row's verify-window base.
    Returns the proposals (R, num_steps) int32; the cache is written in
    place."""
    counts = torch.clamp(prev_tokens[:, spec_width : spec_width + 1].to(torch.int64), 1, spec_width)
    chained_last = torch.take_along_dim(prev_tokens[:, :spec_width].to(torch.int64), counts - 1, dim=1)
    uc = use_chain.to(torch.bool)
    st.last.copy_(torch.where(uc, torch.clamp(chained_last, min=0), fallback_last.to(torch.int64)))
    st.pos.copy_(torch.where(uc, p0_base.to(torch.int64) + counts, fallback_pos.to(torch.int64)))
    steps = [decode_step(params, cache, st, spec=spec, mlp_fn=mlp_fn)[0] for _ in range(num_steps)]
    return torch.stack(steps, dim=1).to(torch.int32)


def forward(
    params: dict,
    cache: Cache,
    inputs: StepInputs,
    *,
    spec: ModelSpec,
    phase: str,
    mlp_fn: Callable = gated_mlp,
    generator=None,
    layer_fn: Optional[Callable] = None,
) -> StepOutput:
    """One step (counterpart of the reference ``forward``); ``generator``
    draws the tokens when the spec samples."""
    logits, new_cache = model_logits(
        params, cache, inputs, spec=spec, phase=phase, mlp_fn=mlp_fn, layer_fn=layer_fn
    )
    tokens = _next_tokens(logits, inputs.sampling_params, spec, generator)
    return StepOutput(
        tokens=tokens, logits=logits if spec.output_logits else None, cache=new_cache
    )
