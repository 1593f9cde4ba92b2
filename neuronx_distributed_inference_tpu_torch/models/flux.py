"""FLUX's DiT backbone, the rectified-flow MMDiT (counterpart of the
reference's ``models/flux.py``).

FLUX.1: packed 2x2 latent patches ``hidden (B, Limg, 64)``, the T5 sequence
``txt (B, Ltxt, joint_dim)``, the CLIP pooled vector, the timestep (and the
guidance of the -dev checkpoint) -> the velocity field (B, Limg, 64).

- conditioning ``temb``: sinusoidal(t * 1000) -> MLP [+ sinusoidal(guidance
  * 1000) -> MLP] + pooled -> MLP, in fp32, then the compute dtype; every
  AdaLN-Zero modulation is a linear map of silu(temb), split
  ``[shift, scale, gate, ...]``;
- ``num_dual`` dual-stream blocks: per-stream modulation and qkv, rms q / k
  norms BEFORE the rope, one joint attention over ``[txt | img]`` with the
  interleaved-pair rope of 3 axes, per-stream output projections and
  tanh-GELU FFNs;
- ``num_single`` single-stream blocks over ``[txt | img]``: one modulation,
  attention and MLP branches whose two output projections sum with one
  bias;
- ``norm_out``: AdaLN-continuous, split ``[scale, shift]`` (diffusers'
  order), then the linear to 64 channels.

Attention is plain PyTorch (fp32 scores, softmax, probabilities in the
compute dtype), as the reference computes it in einsums: no Pallas kernel
sits on this path. The reference's ``constrain`` / ``flux_param_pspecs`` are
GSPMD sharding for tp > 1 (ROADMAP A10): the port runs one device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from neuronx_distributed_inference_tpu_torch.models.base import unstack_layers
from neuronx_distributed_inference_tpu_torch.models.flux_text import _hf_np, _tree
from neuronx_distributed_inference_tpu_torch.modules.norm import rms_norm
from neuronx_distributed_inference_tpu_torch.ops.quant import linear

#: black-forest-labs/FLUX.1-dev's transformer config (diffusers'
#: FluxTransformer2DModel: 19 dual and 38 single blocks of 24 heads of 128)
FLUX_1_DEV = dict(dim=3072, num_heads=24, head_dim=128, num_dual=19, num_single=38, in_channels=64, joint_dim=4096,
                  pooled_dim=768, guidance_embeds=True, axes_dims_rope=(16, 56, 56))


@dataclass(frozen=True)
class FluxSpec:
    dim: int  # inner dim (3072 for FLUX.1)
    num_heads: int
    head_dim: int
    num_dual: int  # dual-stream (MMDiT) blocks (19)
    num_single: int  # single-stream blocks (38)
    in_channels: int = 64  # packed 2x2 latent patches
    joint_dim: int = 4096  # T5 feature width
    pooled_dim: int = 768  # CLIP pooled width
    guidance_embeds: bool = True  # FLUX.1-dev; schnell = False
    mlp_ratio: float = 4.0
    axes_dims_rope: Tuple[int, int, int] = (16, 56, 56)
    theta: float = 10000.0


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, diffusers' ``get_timestep_embedding``
    (flip_sin_to_cos, no frequency shift): [cos | sin] halves, fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _lin(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ W + b``, the weight and bias cast to x's dtype: the reference's
    fp32 conditioning promotes bf16 weights so."""
    return x @ p["weight"].to(x.dtype) + p["bias"].to(x.dtype)


def _mlp2(params: dict, x: torch.Tensor) -> torch.Tensor:
    """linear -> silu -> linear (the timestep / guidance / text MLPs)."""
    return _lin(params["linear_2"], F.silu(_lin(params["linear_1"], x)))


def flux_rope_freqs(ids: torch.Tensor, spec: FluxSpec) -> Tuple[torch.Tensor, torch.Tensor]:
    """3-axis rotary tables: ``ids (L, 3)`` -> (cos, sin) each (L,
    head_dim / 2) in fp32, each axis a band of ``axes_dims_rope[a] / 2``
    frequencies."""
    cos, sin = [], []
    for a, d in enumerate(spec.axes_dims_rope):
        half = d // 2
        freqs = 1.0 / (spec.theta ** (torch.arange(0, half, dtype=torch.float32, device=ids.device) / half))
        angles = ids[:, a].float()[:, None] * freqs[None, :]
        cos.append(torch.cos(angles))
        sin.append(torch.sin(angles))
    return torch.cat(cos, dim=-1), torch.cat(sin, dim=-1)


def latent_image_ids(h2: int, w2: int) -> np.ndarray:
    """(h2 * w2, 3) position ids of the packed latent grid: axis 0 zero,
    axis 1 the row, axis 2 the column."""
    ids = np.zeros((h2, w2, 3), np.float32)
    ids[..., 1] = np.arange(h2)[:, None]
    ids[..., 2] = np.arange(w2)[None, :]
    return ids.reshape(h2 * w2, 3)


def _rope_rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Interleaved-pair rotation of (B, L, H, D) by (L, D / 2) tables, in
    fp32, cast back."""
    x0 = x[..., 0::2].float()
    x1 = x[..., 1::2].float()
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    return torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1).reshape(x.shape).to(x.dtype)


def _qk_norm(q, k, params, eps=1e-6):
    return rms_norm(q, params["norm_q"]["weight"], eps), rms_norm(k, params["norm_k"]["weight"], eps)


def _heads(x: torch.Tensor, H: int, D: int) -> torch.Tensor:
    B, L, _ = x.shape
    return x.reshape(B, L, H, D)


def _attention(q, k, v, scale):
    """Full attention over (B, L, H, D) (no mask: diffusion sequences are
    dense): fp32 scores and softmax, probabilities in v's dtype, out in q's
    dtype."""
    s = torch.matmul(q.transpose(1, 2).float(), k.permute(0, 2, 3, 1).float()) * scale
    probs = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(probs, v.transpose(1, 2)).transpose(1, 2).to(q.dtype)


def _proj_qkv(params, x, H, D):
    return tuple(_heads(linear(params[n], x) + params[n]["bias"], H, D) for n in ("to_q", "to_k", "to_v"))


def _modulation(params, temb, chunks: int):
    m = linear(params, F.silu(temb)) + params["bias"]  # (B, chunks * dim)
    return torch.chunk(m, chunks, dim=-1)


def _ff(params, x):
    h = F.gelu(linear(params["in_proj"], x) + params["in_proj"]["bias"], approximate="tanh")
    return linear(params["out_proj"], h) + params["out_proj"]["bias"]


def _layer_norm(x, eps=1e-6):
    """LayerNorm without affine, in fp32, cast back."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mu).mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def dual_block(params, img, txt, temb, cos, sin, spec: FluxSpec):
    """The MMDiT dual-stream block (reference ``NeuronFluxTransformerBlock``)."""
    H, D = spec.num_heads, spec.head_dim
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = _modulation(params["norm1"]["linear"], temb, 6)
    c_shift_msa, c_scale_msa, c_gate_msa, c_shift_mlp, c_scale_mlp, c_gate_mlp = _modulation(
        params["norm1_context"]["linear"], temb, 6
    )
    n_img = _layer_norm(img) * (1 + scale_msa[:, None]) + shift_msa[:, None]
    n_txt = _layer_norm(txt) * (1 + c_scale_msa[:, None]) + c_shift_msa[:, None]

    at = params["attn"]
    qi, ki, vi = _proj_qkv(at, n_img, H, D)
    qi, ki = _qk_norm(qi, ki, at)
    qt, kt, vt = (_heads(linear(at[n], n_txt) + at[n]["bias"], H, D) for n in ("add_q_proj", "add_k_proj", "add_v_proj"))
    qt = rms_norm(qt, at["norm_added_q"]["weight"], 1e-6)
    kt = rms_norm(kt, at["norm_added_k"]["weight"], 1e-6)

    # joint attention over [txt | img], the rope over the joint sequence
    q = _rope_rotate(torch.cat([qt, qi], dim=1), cos, sin)
    k = _rope_rotate(torch.cat([kt, ki], dim=1), cos, sin)
    out = _attention(q, k, torch.cat([vt, vi], dim=1), D**-0.5)
    B, L = out.shape[:2]
    out = out.reshape(B, L, H * D)
    Lt = txt.shape[1]
    txt_out = linear(at["to_add_out"], out[:, :Lt]) + at["to_add_out"]["bias"]
    img_out = linear(at["to_out"], out[:, Lt:]) + at["to_out"]["bias"]

    img = img + gate_msa[:, None] * img_out
    n2 = _layer_norm(img) * (1 + scale_mlp[:, None]) + shift_mlp[:, None]
    img = img + gate_mlp[:, None] * _ff(params["ff"], n2)

    txt = txt + c_gate_msa[:, None] * txt_out
    n2c = _layer_norm(txt) * (1 + c_scale_mlp[:, None]) + c_shift_mlp[:, None]
    txt = txt + c_gate_mlp[:, None] * _ff(params["ff_context"], n2c)
    return img, txt


def single_block(params, x, temb, cos, sin, spec: FluxSpec):
    """The single-stream block: attention and MLP branches in parallel, one
    gated residual (reference ``NeuronFluxSingleTransformerBlock``)."""
    H, D = spec.num_heads, spec.head_dim
    shift, scale_m, gate = _modulation(params["norm"]["linear"], temb, 3)
    n = _layer_norm(x) * (1 + scale_m[:, None]) + shift[:, None]

    at = params["attn"]
    q, k, v = _proj_qkv(at, n, H, D)
    q, k = _qk_norm(q, k, at)
    out = _attention(_rope_rotate(q, cos, sin), _rope_rotate(k, cos, sin), v, D**-0.5)
    B, L = out.shape[:2]
    mlp = F.gelu(linear(params["proj_mlp"], n) + params["proj_mlp"]["bias"], approximate="tanh")
    # the two output projections sum into one residual with one bias
    proj = (
        linear(params["proj_out_attn"], out.reshape(B, L, H * D))
        + linear(params["proj_out_mlp"], mlp)
        + params["proj_out_attn"]["bias"]
    )
    return x + gate[:, None] * proj


def flux_forward(
    params: Dict,
    hidden: torch.Tensor,  # (B, Limg, in_channels) packed latents
    txt: torch.Tensor,  # (B, Ltxt, joint_dim) T5 features
    pooled: torch.Tensor,  # (B, pooled_dim) CLIP pooled
    timestep: torch.Tensor,  # (B,) in [0, 1]
    img_ids: torch.Tensor,  # (Limg, 3)
    txt_ids: torch.Tensor,  # (Ltxt, 3)
    guidance: Optional[torch.Tensor] = None,  # (B,) guidance scale (dev)
    *,
    spec: FluxSpec,
) -> torch.Tensor:
    """One denoising step's velocity field, (B, Limg, in_channels)
    (reference ``NeuronFluxTransformer2DModel.forward``). ``guidance``
    defaults to 3.5 where the spec embeds it."""
    x = linear(params["x_embedder"], hidden) + params["x_embedder"]["bias"]
    temb = _mlp2(params["time_embed"], timestep_embedding(timestep * 1000.0, 256))
    if spec.guidance_embeds:
        g = guidance if guidance is not None else torch.ones_like(timestep) * 3.5
        temb = temb + _mlp2(params["guidance_embed"], timestep_embedding(g * 1000.0, 256))
    temb = (temb + _mlp2(params["text_embed"], pooled.float())).to(x.dtype)
    txt_h = linear(params["context_embedder"], txt) + params["context_embedder"]["bias"]

    cos, sin = flux_rope_freqs(torch.cat([txt_ids, img_ids], dim=0), spec)
    for lp in unstack_layers(params["dual_blocks"]):
        x, txt_h = dual_block(lp, x, txt_h, temb, cos, sin, spec)
    cat = torch.cat([txt_h, x], dim=1)
    for lp in unstack_layers(params["single_blocks"]):
        cat = single_block(lp, cat, temb, cos, sin, spec)
    x = cat[:, txt_h.shape[1]:]

    # AdaLayerNormContinuous: diffusers' chunk order is [scale, shift]
    scale_, shift = _modulation(params["norm_out"]["linear"], temb, 2)
    x = _layer_norm(x) * (1 + scale_[:, None]) + shift[:, None]
    return linear(params["proj_out"], x) + params["proj_out"]["bias"]


# ---------------------------------------------------------------------------
# params: shapes, seeded weights, the diffusers conversion
# ---------------------------------------------------------------------------


def flux_param_shapes(spec: FluxSpec) -> Dict:
    d = spec.dim
    inner = spec.num_heads * spec.head_dim
    mlp = int(d * spec.mlp_ratio)

    def lin(i, o):
        return {"weight": (i, o), "bias": (o,)}

    norms = {k: {"weight": (spec.head_dim,)} for k in ("norm_q", "norm_k")}
    dual = {
        "norm1": {"linear": lin(d, 6 * d)},
        "norm1_context": {"linear": lin(d, 6 * d)},
        "attn": {
            **{k: lin(d, inner) for k in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj")},
            "to_out": lin(inner, d),
            "to_add_out": lin(inner, d),
            **norms,
            **{k: {"weight": (spec.head_dim,)} for k in ("norm_added_q", "norm_added_k")},
        },
        "ff": {"in_proj": lin(d, mlp), "out_proj": lin(mlp, d)},
        "ff_context": {"in_proj": lin(d, mlp), "out_proj": lin(mlp, d)},
    }
    single = {
        "norm": {"linear": lin(d, 3 * d)},
        "attn": {**{k: lin(d, inner) for k in ("to_q", "to_k", "to_v")}, **norms},
        "proj_mlp": lin(d, mlp),
        "proj_out_attn": lin(inner, d),
        "proj_out_mlp": {"weight": (mlp, d)},
    }

    def stack(tree, n):
        return {k: stack(v, n) for k, v in tree.items()} if isinstance(tree, dict) else (n,) + tree

    shapes = {
        "x_embedder": lin(spec.in_channels, d),
        "context_embedder": lin(spec.joint_dim, d),
        "time_embed": {"linear_1": lin(256, d), "linear_2": lin(d, d)},
        "text_embed": {"linear_1": lin(spec.pooled_dim, d), "linear_2": lin(d, d)},
        "dual_blocks": stack(dual, spec.num_dual),
        "single_blocks": stack(single, spec.num_single),
        "norm_out": {"linear": lin(d, 2 * d)},
        "proj_out": lin(d, spec.in_channels),
    }
    if spec.guidance_embeds:
        shapes["guidance_embed"] = {"linear_1": lin(256, d), "linear_2": lin(d, d)}
    return shapes


def sorted_leaf_paths(tree, path=()):
    """The (path, leaf) pairs of a shapes tree in the JAX package's
    ``jax.tree.flatten`` order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from sorted_leaf_paths(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from sorted_leaf_paths(v, path + (i,))
    else:
        yield path, tree


def seeded_tree(shapes: Dict, seed: int, std: float, dtype, device) -> Dict:
    """Seeded normal leaves (``std``) drawn from one ``np.random.RandomState``
    stream over the JAX package's leaf order, so a tree equals the
    reference's random tree bit for bit at fp32."""
    rng = np.random.RandomState(seed)
    out: Dict = {}
    for path, shape in sorted_leaf_paths(shapes):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.from_numpy(rng.randn(*shape).astype(np.float32) * std).to(device=device, dtype=dtype)
    return out


def flux_random_params(spec: FluxSpec, seed: int = 0, dtype=torch.float32, device="cpu") -> Dict:
    """The reference's ``flux_random_params``: std 0.02, the q / k norm
    weights then set to ones."""
    params = seeded_tree(flux_param_shapes(spec), seed, 0.02, dtype, device)
    for blocks in ("dual_blocks", "single_blocks"):
        at = params[blocks]["attn"]
        for k in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            if k in at:
                at[k]["weight"] = torch.ones_like(at[k]["weight"])
    return params


def convert_flux_state_dict(sd: Dict, spec: FluxSpec, dtype=torch.float32, device="cpu") -> Dict:
    """A diffusers ``FluxTransformer2DModel`` state dict -> the params tree
    on ``device``; linear weights transpose to (in, out), and each single
    block's packed ``proj_out`` ([attn | mlp] inputs) splits in two."""
    inner = spec.num_heads * spec.head_dim

    def lin(name):
        return {"weight": _hf_np(sd, name + ".weight").T, "bias": _hf_np(sd, name + ".bias")}

    def w(name):
        return {"weight": _hf_np(sd, name)}

    def stack(fn, n):
        layers = [fn(i) for i in range(n)]

        def st(trees):
            if isinstance(trees[0], dict):
                return {k: st([t[k] for t in trees]) for k in trees[0]}
            return np.stack(trees)

        return st(layers)

    def dual(i):
        p = f"transformer_blocks.{i}."
        return {
            "norm1": {"linear": lin(p + "norm1.linear")},
            "norm1_context": {"linear": lin(p + "norm1_context.linear")},
            "attn": {
                **{n: lin(p + "attn." + n) for n in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj",
                                                     "to_add_out")},
                "to_out": lin(p + "attn.to_out.0"),
                **{n: w(p + f"attn.{n}.weight") for n in ("norm_q", "norm_k", "norm_added_q", "norm_added_k")},
            },
            "ff": {"in_proj": lin(p + "ff.net.0.proj"), "out_proj": lin(p + "ff.net.2")},
            "ff_context": {"in_proj": lin(p + "ff_context.net.0.proj"), "out_proj": lin(p + "ff_context.net.2")},
        }

    def single(i):
        p = f"single_transformer_blocks.{i}."
        po = _hf_np(sd, p + "proj_out.weight").T  # (inner + mlp, dim)
        return {
            "norm": {"linear": lin(p + "norm.linear")},
            "attn": {**{n: lin(p + "attn." + n) for n in ("to_q", "to_k", "to_v")},
                     **{n: w(p + f"attn.{n}.weight") for n in ("norm_q", "norm_k")}},
            "proj_mlp": lin(p + "proj_mlp"),
            "proj_out_attn": {"weight": po[:inner], "bias": _hf_np(sd, p + "proj_out.bias")},
            "proj_out_mlp": {"weight": po[inner:]},
        }

    tree = {
        "x_embedder": lin("x_embedder"),
        "context_embedder": lin("context_embedder"),
        "time_embed": {n: lin(f"time_text_embed.timestep_embedder.{n}") for n in ("linear_1", "linear_2")},
        "text_embed": {n: lin(f"time_text_embed.text_embedder.{n}") for n in ("linear_1", "linear_2")},
        "dual_blocks": stack(dual, spec.num_dual),
        "single_blocks": stack(single, spec.num_single),
        "norm_out": {"linear": lin("norm_out.linear")},
        "proj_out": lin("proj_out"),
    }
    if spec.guidance_embeds:
        tree["guidance_embed"] = {n: lin(f"time_text_embed.guidance_embedder.{n}") for n in ("linear_1", "linear_2")}
    return _tree(tree, dtype, device)
