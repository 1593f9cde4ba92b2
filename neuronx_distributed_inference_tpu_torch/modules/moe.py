"""Mixture-of-Experts block: router and expert MLPs (counterpart of the
reference's ``modules/moe.py``).

- Router: a linear in ``router_dtype`` (fp32 by default), then softmax or
  sigmoid scoring (with DeepSeek-V3's correction bias and group-limited
  top-k), top-k, and the renormalized or p-normed affinities; or top-k over
  the raw logits first (``softmax_topk``, ``sigmoid_topk``).
- Experts, gate/up ``(E, H, I)`` and down ``(E, I, H)``, run by one of four
  routes, chosen as the reference chooses (:func:`moe_layer`):
  - prefill (``S >= sparse_dispatch_threshold``) with ``E >= 16 k``: the
    dropless grouped route (:func:`expert_mlps_grouped`), or the dropping
    capacity route (:func:`expert_mlps_capacity`) when ``capacity_factor``
    is set;
  - decode-sized calls that ``kernel_mode.use_moe_tkg`` passes: the B7
    kernel's wrapper (``ops/moe_decode.fused_moe_decode``), which reads only
    the selected experts' weights;
  - everything else: the dense all-experts route (:func:`expert_mlps_dense`).

  Each route but B7 is counted in ``ops/_cuda.ROUTES`` (B7 counts its
  launches). The reference's ``jax.lax.ragged_dot`` is an XLA op, not a
  Pallas kernel: here :func:`_grouped_mm` loops over the non-empty experts
  with one matmul each, which costs one host read of the group sizes per
  layer at prefill.

Experts are plain weights, with an optional bias (GPT-OSS's form). Top-k
follows ``jax.lax.top_k``: a stable descending sort, so among equal values
the lower index comes first, and the expert sort is stable, as
``jnp.argsort`` is. Outside the port for now: shared experts, quantized
expert entries (int8/fp8 scales, blockwise scales, int4) and DBRX (ROADMAP
A9), expert parallelism and hybrid sharding (A10).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from neuronx_distributed_inference_tpu_torch.config import to_dtype
from neuronx_distributed_inference_tpu_torch.ops import _cuda
from neuronx_distributed_inference_tpu_torch.ops.kernel_mode import use_moe_tkg
from neuronx_distributed_inference_tpu_torch.ops.moe_decode import fused_moe_decode


@dataclass(frozen=True)
class MoESpec:
    """Static MoE hyperparams (the reference's MoESpec, without its
    model-parallel and hybrid-sharding fields, ROADMAP A10)."""

    num_experts: int
    top_k: int
    normalize_top_k_affinities: bool = True  # renorm selected affinities to sum 1
    router_dtype: str = "float32"
    act: str = "silu"
    # scale expert INPUTS by affinity instead of outputs
    early_affinity_modulation: bool = False
    router_bias: bool = False
    # DeepSeek-V3 routing: sigmoid scoring with a correction bias and
    # group-limited top-k over n_group expert groups
    scoring_func: str = "softmax"  # or "sigmoid", "softmax_topk", "sigmoid_topk"
    routed_scaling_factor: float = 1.0
    n_group: int = 1
    topk_group: int = 1
    # GPT-OSS expert GLU: x * sigmoid(act_scale * x) clamped, up + act_bias
    act_scale: float = 1.0
    act_bias: float = 0.0
    swiglu_limit: Optional[float] = None
    # p-norm renormalization of the selected weights (DBRX); None = plain
    # sum when normalize_top_k_affinities
    norm_weights_p: Optional[float] = None
    # capacity-factor (dropping) dispatch for prefill; None = dropless
    capacity_factor: Optional[float] = None
    ep_degree: int = 1
    # SEQUENCE length at/above which prefill takes a sparse route
    sparse_dispatch_threshold: int = 64
    # B7 tri-state (config moe_fused_kernel_enabled): None/True = the kernel
    # where use_moe_tkg's conditions hold, False = the dense route
    moe_fused_kernel: Optional[bool] = None


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: values descending, the lower
    index first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _scatter(T: int, E: int, idx: torch.Tensor, weights: torch.Tensor):
    """(T, E) affinities holding ``weights`` at ``idx`` and 0 elsewhere, and
    the (T, E) selection mask of ``idx``."""
    aff = torch.zeros((T, E), dtype=weights.dtype, device=weights.device).scatter(1, idx, weights)
    sel = torch.zeros((T, E), dtype=torch.bool, device=weights.device).scatter(1, idx, True)
    return aff, sel


def router_top_k(
    router_logits: torch.Tensor,  # (T, E) fp32
    spec: MoESpec,
    correction_bias: Optional[torch.Tensor] = None,  # (E,)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (T, E) affinity matrix, zero outside the top-k, and the (T, E)
    bool selection mask of the top-k indices (selection is never inferred
    from a nonzero affinity; an underflowed weight still selects)."""
    T, E = router_logits.shape
    if spec.scoring_func in ("softmax_topk", "sigmoid_topk"):
        # top-k over raw logits, then weight the selected values (GPT-OSS,
        # Llama4), no renormalization
        top_vals, top_idx = _top_k(router_logits, spec.top_k)
        if spec.scoring_func == "sigmoid_topk":
            weights = torch.sigmoid(top_vals)
        else:
            weights = torch.softmax(top_vals, dim=-1)
        return _scatter(T, E, top_idx, weights * spec.routed_scaling_factor)
    if spec.scoring_func == "sigmoid":
        scores = torch.sigmoid(router_logits)
    else:
        scores = torch.softmax(router_logits, dim=-1)
    choice = scores if correction_bias is None else scores + correction_bias[None, :]

    if spec.n_group > 1:
        # keep the topk_group groups ranked by the sum of each group's top-2
        # choice scores, mask the rest
        g = spec.n_group
        grouped = choice.reshape(T, g, E // g)
        top2 = _top_k(grouped, min(2, E // g))[0].sum(dim=-1)  # (T, g)
        _, keep_idx = _top_k(top2, spec.topk_group)
        group_mask = torch.zeros((T, g), dtype=torch.bool, device=choice.device).scatter(1, keep_idx, True)
        choice = torch.where(
            group_mask.repeat_interleave(E // g, dim=1), choice, torch.full_like(choice, -math.inf)
        )

    _, top_idx = _top_k(choice, spec.top_k)  # ranked by choice
    # combine weights use the UNCORRECTED scores of the selected experts
    weights = torch.take_along_dim(scores, top_idx, dim=1)
    if spec.norm_weights_p is not None:
        p = spec.norm_weights_p
        norm = torch.sum(torch.abs(weights) ** p, dim=-1, keepdim=True) ** (1.0 / p)
        weights = weights / (norm + 1e-20)
    elif spec.normalize_top_k_affinities:
        weights = weights / (torch.sum(weights, dim=-1, keepdim=True) + 1e-20)
    return _scatter(T, E, top_idx, weights * spec.routed_scaling_factor)


def _glu_fn(spec: MoESpec):
    """The experts' GLU: act(gate) * up, or GPT-OSS's clamped swiglu."""
    from neuronx_distributed_inference_tpu_torch.models.base import act_fn

    def glu(gate, up):
        if spec.act_scale != 1.0 or spec.act_bias != 0.0 or spec.swiglu_limit is not None:
            if spec.swiglu_limit is not None:
                gate = torch.clamp(gate, max=spec.swiglu_limit)
                up = torch.clamp(up, -spec.swiglu_limit, spec.swiglu_limit)
            return gate * torch.sigmoid(spec.act_scale * gate) * (up + spec.act_bias)
        return act_fn(spec.act)(gate) * up

    return glu


def _plain_entry(entry: dict) -> dict:
    """Expert entries the port runs: plain weights, optionally with a bias.
    Quantized experts (int8 or fp8 codes with per-channel or blockwise
    scales, packed int4 with ``maybe_dequantize_int4``) wait for ROADMAP A9."""
    if "scale" in entry:
        raise NotImplementedError(
            "quantized MoE experts (scaled codes, blockwise scales, maybe_dequantize_int4) are not "
            "ported to PyTorch yet (ROADMAP A9)"
        )
    return entry


def _sorted_dispatch(affinities: torch.Tensor, k: int):
    """(T, E) affinities -> token-replica rows sorted by expert (stable):
    (row_token (T*k,), row_expert, row_weight, group_sizes (E,))."""
    return _sorted_dispatch_order(affinities, k)[:4]


def _sorted_dispatch_order(affinities: torch.Tensor, k: int):
    """:func:`_sorted_dispatch` plus what :func:`_sum_per_token` needs: the
    sort order of the flat (token, selection) rows and the (T, k) ids."""
    T, E = affinities.shape
    w_topk, e_topk = _top_k(affinities, k)
    flat_e = e_topk.reshape(T * k)
    flat_t = torch.arange(T, dtype=torch.int64, device=affinities.device).repeat_interleave(k)
    flat_w = w_topk.reshape(T * k)
    order = torch.argsort(flat_e, stable=True)
    group_sizes = torch.bincount(flat_e, minlength=E)
    return flat_t[order], flat_e[order], flat_w[order], group_sizes, order, e_topk


def _sum_per_token(rows: torch.Tensor, order: torch.Tensor, e_topk: torch.Tensor) -> torch.Tensor:
    """The reference's scatter-add of expert-sorted rows into their tokens
    (``zeros.at[row_token].add(rows)``) in one fixed order: each token's k
    rows added to zero one at a time in increasing expert id, rounding in
    the rows' dtype at each add (in fp32 the sums of the CPU's sequential
    ``index_add_``). On a card ``index_add_`` adds in the order its atomics
    land, which changes from run to run, and so did the greedy tokens of a
    prefill that takes this route."""
    T, k = e_topk.shape
    flat = torch.empty_like(rows)
    flat[order] = rows
    by_expert = torch.argsort(e_topk, dim=1, stable=True)
    per_token = torch.take_along_dim(flat.view(T, k, -1), by_expert[:, :, None], dim=1)
    acc = torch.zeros_like(per_token[:, 0])
    for j in range(k):
        acc = acc + per_token[:, j]
    return acc


def _grouped_mm(entry: dict, x_rows: torch.Tensor, row_expert: torch.Tensor, group_sizes) -> torch.Tensor:
    """Grouped matmul over expert-sorted rows (the reference's ragged_dot):
    x_rows (R, in) sorted by expert, weight (E, in, out), ``group_sizes``
    the rows per expert as host ints -> (R, out); one matmul per non-empty
    expert."""
    entry = _plain_entry(entry)
    w = entry["weight"]
    y = x_rows.new_empty((x_rows.shape[0], w.shape[-1]))
    start = 0
    for e, n in enumerate(group_sizes):
        if n:
            # the product lands in y's rows directly: one kernel an expert
            torch.matmul(x_rows[start : start + n], w[e].to(x_rows.dtype), out=y[start : start + n])
            start += n
    if "bias" in entry:
        y = y + entry["bias"].to(y.dtype)[row_expert]
    return y


def expert_mlps_grouped(params: dict, x: torch.Tensor, affinities: torch.Tensor, spec: MoESpec) -> torch.Tensor:
    """Dropless sorted-token grouped route: T*k rows of expert work instead
    of the dense route's E*T."""
    glu = _glu_fn(spec)
    st, se, sw, group_sizes, order, e_topk = _sorted_dispatch_order(affinities, spec.top_k)
    sizes = group_sizes.tolist()  # the one host read of the layer
    xs = x[st]
    sww = sw.to(x.dtype)[:, None]
    if spec.early_affinity_modulation:
        xs = xs * sww
    g = _grouped_mm(params["gate_proj"], xs, se, sizes)
    u = _grouped_mm(params["up_proj"], xs, se, sizes)
    y = _grouped_mm(params["down_proj"], glu(g, u), se, sizes)
    if not spec.early_affinity_modulation:
        y = y * sww
    return _sum_per_token(y, order, e_topk)


def expert_mlps_capacity(params: dict, x: torch.Tensor, affinities: torch.Tensor, spec: MoESpec) -> torch.Tensor:
    """Capacity-factor (dropping) route: each expert takes at most
    ``C = ceil(T*k/E * capacity_factor)`` token-replicas, in expert-sorted
    (stable) order; the overflow contributes zero."""
    T, H = x.shape
    E, k = spec.num_experts, spec.top_k
    C = max(1, math.ceil(T * k / E * spec.capacity_factor))
    glu = _glu_fn(spec)
    st, se, sw, group_sizes, order, e_topk = _sorted_dispatch_order(affinities, k)
    R = st.shape[0]
    starts = torch.cumsum(group_sizes, dim=0) - group_sizes
    pos = torch.arange(R, device=x.device) - starts[se]
    keep = pos < C
    # kept rows scatter into (E*C, H) buffers; dropped rows land in one
    # extra row that is cut off
    slot = torch.where(keep, se * C + pos, torch.full_like(pos, E * C))
    buf = torch.zeros((E * C + 1, H), dtype=x.dtype, device=x.device)
    buf[slot] = x[st]
    xe = buf[: E * C].reshape(E, C, H)
    sww = sw.to(x.dtype)[:, None]

    def mm(entry, x_in, eq):
        entry = _plain_entry(entry)
        y = torch.einsum(eq, x_in, entry["weight"].to(x_in.dtype))
        if "bias" in entry:
            y = y + entry["bias"].to(y.dtype)[:, None, :]
        return y

    if spec.early_affinity_modulation:
        w_buf = torch.zeros((E * C + 1, 1), dtype=x.dtype, device=x.device)
        w_buf[slot] = sww
        xe = xe * w_buf[: E * C].reshape(E, C, 1)
    g = mm(params["gate_proj"], xe, "ech,ehi->eci")
    u = mm(params["up_proj"], xe, "ech,ehi->eci")
    y = mm(params["down_proj"], glu(g, u), "eci,eih->ech").reshape(E * C, H)
    rows = y[torch.where(keep, slot, torch.full_like(slot, E * C - 1))]
    contrib = torch.where(keep[:, None], rows, torch.zeros_like(rows))
    if not spec.early_affinity_modulation:
        contrib = contrib * sww
    return _sum_per_token(contrib, order, e_topk)


def expert_mlps_dense(
    params: dict,
    x: torch.Tensor,  # (T, H)
    affinities: torch.Tensor,  # (T, E)
    spec: MoESpec,
    selected: Optional[torch.Tensor] = None,  # (T, E) bool top-k selection
) -> torch.Tensor:
    """All-experts route: every expert on every token, combined by the
    affinities (zero outside the top-k)."""

    def expert_mm(entry, x_in, eq):
        entry = _plain_entry(entry)
        y = torch.einsum(eq, x_in, entry["weight"].to(x_in.dtype))
        if "bias" in entry:
            y = y + entry["bias"].to(y.dtype)[:, None, :]
        return y

    glu = _glu_fn(spec)
    aff = affinities.to(x.dtype)
    if spec.early_affinity_modulation:
        # scale the inputs, combine unweighted over the SELECTED experts (a
        # non-selected biased expert must not leak glu(bias))
        xe = torch.einsum("te,th->eth", aff, x)
        g = expert_mm(params["gate_proj"], xe, "eth,ehi->eti")
        u = expert_mm(params["up_proj"], xe, "eth,ehi->eti")
        y = expert_mm(params["down_proj"], glu(g, u), "eti,eih->eth")
        sel = (selected if selected is not None else affinities != 0).to(x.dtype)
        return torch.einsum("te,eth->th", sel, y)
    g = expert_mm(params["gate_proj"], x, "th,ehi->eti")
    u = expert_mm(params["up_proj"], x, "th,ehi->eti")
    y = expert_mm(params["down_proj"], glu(g, u), "eti,eih->eth")  # (E, T, H)
    return torch.einsum("te,eth->th", aff, y)


def grouped_route_tokens(spec: MoESpec) -> Optional[int]:
    """The fewest tokens per row at which :func:`moe_layer` takes the
    grouped route, whose group sizes it reads on the host once a layer (so
    a step that reaches it cannot be captured as a CUDA graph), or None
    when this spec never takes it."""
    if (
        spec.capacity_factor is None
        and spec.num_experts >= 16 * spec.top_k
        and spec.ep_degree == 1
        and spec.top_k < spec.num_experts
    ):
        return spec.sparse_dispatch_threshold
    return None


def moe_layer(params: dict, hidden: torch.Tensor, spec: MoESpec) -> torch.Tensor:
    """The MoE block on (B, S, H): the router, then one route chosen as the
    reference chooses (``modules/moe.py:369-472``). Prefill (S at least
    ``sparse_dispatch_threshold``) takes a sparse route when E >= 16 k (or
    a capacity factor is set) and there is one expert-parallel rank; a
    decode-sized call takes B7 where ``use_moe_tkg`` allows; the rest go
    dense. (The reference's blockwise-scale condition waits for quantized
    experts, ROADMAP A9.)"""
    B, S, H = hidden.shape
    x = hidden.reshape(B * S, H)
    rdt = to_dtype(spec.router_dtype)
    router_logits = x.to(rdt) @ params["router"]["weight"].to(rdt)
    if spec.router_bias:
        router_logits = router_logits + params["router"]["bias"].to(rdt)
    correction = params["router"].get("e_score_correction_bias")
    if correction is not None:
        correction = correction.float()
    affinities, selected = router_top_k(router_logits.float(), spec, correction_bias=correction)
    experts = params["experts"]
    prefill_sized = S >= spec.sparse_dispatch_threshold
    big_ratio = spec.num_experts >= 16 * spec.top_k or spec.capacity_factor is not None
    sparse_ok = (
        prefill_sized
        and big_ratio
        and spec.ep_degree == 1
        and spec.top_k < spec.num_experts
    )
    if sparse_ok and spec.capacity_factor is not None:
        _cuda.count("moe_capacity")
        out = expert_mlps_capacity(experts, x, affinities, spec)
    elif sparse_ok:
        _cuda.count("moe_grouped")
        out = expert_mlps_grouped(experts, x, affinities, spec)
    elif not prefill_sized and use_moe_tkg(spec, experts, x.shape[0]):
        # decode: only the selected experts' weights are read
        w_topk, e_topk = _top_k(affinities, spec.top_k)
        out = fused_moe_decode(
            x, e_topk.to(torch.int32), w_topk,
            experts["gate_proj"]["weight"], experts["up_proj"]["weight"], experts["down_proj"]["weight"],
            act=spec.act, act_scale=spec.act_scale, act_bias=spec.act_bias, swiglu_limit=spec.swiglu_limit,
        )
    else:
        _cuda.count("moe_dense")
        out = expert_mlps_dense(experts, x, affinities, spec, selected)
    return out.reshape(B, S, H).to(hidden.dtype)
