"""FLUX text-to-image pipeline: the CLIP and T5 encoders, the DiT backbone
and the VAE decoder (counterpart of the reference's ``runtime/flux.py``,
``TpuFluxPipeline``).

The encoders run through ``runtime/encoder.EncoderApplication`` (registered
here as ``flux_clip_text``, ``flux_t5`` and ``flux_vae_decoder``); the
denoise loop is a host loop of flow-match Euler steps over the backbone
with the latents on the device. Every stage runs eagerly: a step is one
pass over 57 blocks of large GEMMs (about 95 ms of bound work at 1024 x
1024 on an H100) from some two thousand launches, so a graph would save
little of it (ROADMAP C, "Differences by design").

The initial noise comes from a ``torch.Generator`` seeded with ``seed`` on
the pipeline's device (:func:`initial_noise`): JAX's
``jax.random.normal(PRNGKey(seed))`` stream cannot be reproduced, so the
tests hand both pipelines the same noise.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from neuronx_distributed_inference_tpu_torch.config import resolve_device, to_dtype
from neuronx_distributed_inference_tpu_torch.models.flux import (
    FluxSpec,
    convert_flux_state_dict,
    flux_forward,
    flux_random_params,
    latent_image_ids,
    seeded_tree,
)
from neuronx_distributed_inference_tpu_torch.models.flux_text import (
    ClipTextSpec,
    T5EncoderSpec,
    clip_text_encode,
    convert_clip_text_state_dict,
    convert_t5_state_dict,
    t5_encode,
)
from neuronx_distributed_inference_tpu_torch.models.flux_vae import (
    VaeDecoderSpec,
    convert_vae_decoder_state_dict,
    vae_decode,
)
from neuronx_distributed_inference_tpu_torch.runtime.encoder import EncoderApplication, register_encoder


@register_encoder("flux_clip_text")
def _clip_factory(spec: ClipTextSpec):
    return clip_text_encode, lambda sd, dt, dev: convert_clip_text_state_dict(sd, spec, dt, dev), {"spec": spec}


@register_encoder("flux_t5")
def _t5_factory(spec: T5EncoderSpec):
    return t5_encode, lambda sd, dt, dev: convert_t5_state_dict(sd, spec, dt, dev), {"spec": spec}


@register_encoder("flux_vae_decoder")
def _vae_factory(spec: VaeDecoderSpec):
    return vae_decode, lambda sd, dt, dev: convert_vae_decoder_state_dict(sd, spec, dt, dev), {"spec": spec}


def calculate_shift(
    image_seq_len: int,
    base_seq_len: int = 256,
    max_seq_len: int = 4096,
    base_shift: float = 0.5,
    max_shift: float = 1.16,
) -> float:
    """Dynamic shifting's mu (the reference pipeline's ``calculate_shift``)."""
    m = (max_shift - base_shift) / (max_seq_len - base_seq_len)
    b = base_shift - m * base_seq_len
    return image_seq_len * m + b


def flow_match_sigmas(num_steps: int, image_seq_len: int, dynamic_shift: bool = True) -> np.ndarray:
    """FlowMatchEulerDiscreteScheduler's sigmas with FLUX's time shift:
    linspace(1, 1 / N) through the exp(mu) shift, then a final 0."""
    sigmas = np.linspace(1.0, 1.0 / num_steps, num_steps, dtype=np.float64)
    if dynamic_shift:
        mu = calculate_shift(image_seq_len)
        sigmas = math.exp(mu) / (math.exp(mu) + (1.0 / sigmas - 1.0))
    else:
        shift = 3.0
        sigmas = shift * sigmas / (1.0 + (shift - 1.0) * sigmas)
    return np.concatenate([sigmas, [0.0]]).astype(np.float32)


def pack_latents(latents: torch.Tensor) -> torch.Tensor:
    """(B, h, w, C) NHWC -> (B, h/2 * w/2, 4C) 2x2 patches."""
    B, h, w, C = latents.shape
    x = latents.reshape(B, h // 2, 2, w // 2, 2, C).permute(0, 1, 3, 5, 2, 4)  # (B, h2, w2, C, 2, 2)
    return x.reshape(B, (h // 2) * (w // 2), C * 4)


def unpack_latents(latents: torch.Tensor, h2: int, w2: int) -> torch.Tensor:
    """(B, h2 * w2, 4C) -> (B, 2 h2, 2 w2, C) NHWC."""
    B, L, C4 = latents.shape
    C = C4 // 4
    x = latents.reshape(B, h2, w2, C, 2, 2).permute(0, 1, 4, 2, 5, 3)  # (B, h2, 2, w2, 2, C)
    return x.reshape(B, h2 * 2, w2 * 2, C)


def initial_noise(shape, seed: int, device) -> torch.Tensor:
    """The denoise loop's starting latents: fp32 normals from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=device)


def _mesh_devices(mesh) -> int:
    """Devices of a mesh: None is one; an int counts; else the size of its
    ``devices`` (a JAX-style mesh) or of the object itself (a list)."""
    if mesh is None:
        return 1
    if isinstance(mesh, int):
        return mesh
    return int(np.asarray(getattr(mesh, "devices", mesh), dtype=object).size)


@dataclass
class FluxPipelineConfig:
    """The sub-models' specs and the image geometry (the reference's four
    sub-application configs). ``device`` is the card unless the caller
    asks for the CPU."""

    backbone: FluxSpec
    clip: ClipTextSpec
    t5: T5EncoderSpec
    vae: VaeDecoderSpec = field(default_factory=VaeDecoderSpec)
    height: int = 1024
    width: int = 1024
    dtype: str = "bfloat16"
    device: str = "cuda"

    @property
    def vae_scale(self) -> int:
        # one nearest 2x upsample between consecutive decoder blocks
        return 2 ** (len(self.vae.block_out_channels) - 1)


class FluxPipeline:
    """Token ids (CLIP's and T5's) -> latents (flow-match Euler over the
    DiT's velocity field) -> image (the VAE decoder). Callers tokenize, as
    the reference's callers do."""

    def __init__(self, config: FluxPipelineConfig, mesh=None):
        if _mesh_devices(mesh) > 1:
            raise NotImplementedError(
                "FLUX over a mesh of more than one device (the reference's tensor-parallel DiT) is not "
                "ported to PyTorch yet (ROADMAP A10)"
            )
        self.config = config
        self.device = resolve_device(config.device)
        self.dtype = to_dtype(config.dtype)
        self.clip_app = EncoderApplication.from_registry("flux_clip_text", config.clip, device=self.device)
        self.t5_app = EncoderApplication.from_registry("flux_t5", config.t5, device=self.device)
        self.vae_app = EncoderApplication.from_registry("flux_vae_decoder", config.vae, device=self.device)
        self.backbone_params = None

    # ---- loading ---------------------------------------------------------

    def load(
        self,
        clip_state_dict=None,
        t5_state_dict=None,
        backbone_state_dict=None,
        vae_state_dict=None,
        random_weights: bool = False,
        seed: int = 0,
        params: Optional[Dict] = None,
    ):
        """HF / diffusers state dicts in the config's dtype; or the
        reference's seeded random trees (``seed`` the backbone's, + 1 CLIP,
        + 2 T5, + 3 the VAE); or ``params`` = {"backbone", "clip", "t5",
        "vae"} in the port's layout, taken as they are (the card seeds them
        on the device)."""
        cfg, dt, dev = self.config, self.dtype, self.device
        if params is not None:
            self.backbone_params = params["backbone"]
            for app, key in ((self.clip_app, "clip"), (self.t5_app, "t5"), (self.vae_app, "vae")):
                app.load(params=params[key])
            return self
        if random_weights:
            self.backbone_params = flux_random_params(cfg.backbone, seed, dt, dev)
            self.clip_app.load(params=random_like_clip(cfg.clip, seed + 1, dt, dev))
            self.t5_app.load(params=random_like_t5(cfg.t5, seed + 2, dt, dev))
            self.vae_app.load(params=random_like_vae(cfg.vae, seed + 3, dt, dev))
            return self
        if backbone_state_dict is None:
            raise NotImplementedError(
                "loading FLUX from a checkpoint path is not ported to PyTorch yet (ROADMAP A11); pass the "
                "state dicts, params= or random_weights=True"
            )
        self.backbone_params = convert_flux_state_dict(backbone_state_dict, cfg.backbone, dt, dev)
        self.clip_app.load(state_dict=clip_state_dict, dtype=dt)
        self.t5_app.load(state_dict=t5_state_dict, dtype=dt)
        self.vae_app.load(state_dict=vae_state_dict, dtype=dt)
        return self

    # ---- generation ------------------------------------------------------

    def encode_text(self, clip_ids, t5_ids, t5_mask=None):
        """-> (pooled (B, pooled_dim), txt (B, Lt5, joint_dim) in the
        compute dtype)."""
        if t5_mask is None:
            t5_mask = np.ones_like(np.asarray(t5_ids))
        _, pooled = self.clip_app(np.asarray(clip_ids, np.int64))
        txt = self.t5_app(np.asarray(t5_ids, np.int64), np.asarray(t5_mask, np.int32)).to(self.dtype)
        return pooled, txt

    @torch.no_grad()
    def denoise(self, packed, txt, pooled, h2: int, w2: int, num_inference_steps: int,
                guidance_scale: float = 3.5) -> torch.Tensor:
        """The flow-match Euler loop from the packed latents: ``x_{i+1} =
        x_i + (sigma_{i+1} - sigma_i) * v(x_i, sigma_i)`` in fp32, the
        latents kept in the compute dtype. Returns the packed latents."""
        dev, B = self.device, packed.shape[0]
        spec = self.config.backbone
        img_ids = torch.as_tensor(latent_image_ids(h2, w2), device=dev)
        txt_ids = torch.zeros((txt.shape[1], 3), dtype=torch.float32, device=dev)
        guidance = torch.full((B,), guidance_scale, dtype=torch.float32, device=dev) if spec.guidance_embeds else None
        sigmas = flow_match_sigmas(num_inference_steps, h2 * w2)
        for i in range(num_inference_steps):
            t = torch.full((B,), float(sigmas[i]), dtype=torch.float32, device=dev)
            v = flux_forward(self.backbone_params, packed, txt, pooled, t, img_ids, txt_ids, guidance, spec=spec)
            packed = (packed.float() + float(sigmas[i + 1] - sigmas[i]) * v.float()).to(self.dtype)
        return packed

    @torch.no_grad()
    def generate(
        self,
        clip_ids: np.ndarray,  # (B, Lclip) CLIP token ids
        t5_ids: np.ndarray,  # (B, Lt5) T5 token ids
        t5_mask: Optional[np.ndarray] = None,
        num_inference_steps: int = 4,
        guidance_scale: float = 3.5,
        seed: int = 0,
        height: Optional[int] = None,
        width: Optional[int] = None,
    ) -> np.ndarray:
        """-> images (B, H, W, 3) float32 in [0, 1]."""
        cfg = self.config
        H, W = height or cfg.height, width or cfg.width
        h, w = H // cfg.vae_scale, W // cfg.vae_scale
        h2, w2 = h // 2, w // 2
        B = np.asarray(clip_ids).shape[0]
        pooled, txt = self.encode_text(clip_ids, t5_ids, t5_mask)
        latents = initial_noise((B, h, w, cfg.backbone.in_channels // 4), seed, self.device)
        packed = self.denoise(pack_latents(latents).to(self.dtype), txt, pooled, h2, w2, num_inference_steps,
                              guidance_scale)
        img = self.vae_app(unpack_latents(packed.float(), h2, w2))
        return np.clip(img.float().cpu().numpy() / 2 + 0.5, 0.0, 1.0)


# ---------------------------------------------------------------------------
# seeded random sub-models (the reference's, bit for bit at fp32)
# ---------------------------------------------------------------------------


def _stacked(tree, n):
    return {k: _stacked(v, n) for k, v in tree.items()} if isinstance(tree, dict) else (n,) + tree


def clip_param_shapes(spec: ClipTextSpec) -> Dict:
    H, I = spec.hidden_size, spec.intermediate_size

    def lin(i, o):
        return {"weight": (i, o), "bias": (o,)}

    layer = {
        **{k: lin(H, H) for k in ("q_proj", "k_proj", "v_proj", "out_proj")},
        "fc1": lin(H, I),
        "fc2": lin(I, H),
        "layer_norm1": {"weight": (H,), "bias": (H,)},
        "layer_norm2": {"weight": (H,), "bias": (H,)},
    }
    return {
        "token_embedding": {"weight": (spec.vocab_size, H)},
        "position_embedding": {"weight": (spec.max_positions, H)},
        "layers": _stacked(layer, spec.num_layers),
        "final_layer_norm": {"weight": (H,), "bias": (H,)},
    }


def t5_param_shapes(spec: T5EncoderSpec) -> Dict:
    D, inner = spec.d_model, spec.num_heads * spec.d_kv
    layer = {
        "q": {"weight": (D, inner)}, "k": {"weight": (D, inner)}, "v": {"weight": (D, inner)},
        "o": {"weight": (inner, D)}, "ln1": {"weight": (D,)}, "ln2": {"weight": (D,)},
        "wi_0": {"weight": (D, spec.d_ff)}, "wi_1": {"weight": (D, spec.d_ff)}, "wo": {"weight": (spec.d_ff, D)},
    }
    return {
        "embed_tokens": {"weight": (spec.vocab_size, D)},
        "rel_bias": {"weight": (spec.rel_buckets, spec.num_heads)},
        "layers": _stacked(layer, spec.num_layers),
        "final_norm": {"weight": (D,)},
    }


def vae_param_shapes(spec: VaeDecoderSpec) -> Dict:
    """The VAE decoder tree's shapes (convs OIHW; ``up`` a list of blocks)."""
    ch = list(reversed(spec.block_out_channels))

    def conv(i, o, k=3):
        return {"weight": (o, i, k, k), "bias": (o,)}

    def norm(c):
        return {"weight": (c,), "bias": (c,)}

    def resnet(i, o):
        out = {"norm1": norm(i), "conv1": conv(i, o), "norm2": norm(o), "conv2": conv(o, o)}
        if i != o:
            out["conv_shortcut"] = conv(i, o, k=1)
        return out

    c0 = ch[0]
    lin = {"weight": (c0, c0), "bias": (c0,)}
    up, prev = [], c0
    for ui, c in enumerate(ch):
        blk = {f"resnet_{ri}": resnet(prev if ri == 0 else c, c) for ri in range(spec.layers_per_block + 1)}
        if ui < len(ch) - 1:
            blk["upsample"] = {"conv": conv(c, c)}
        up.append(blk)
        prev = c
    return {
        "conv_in": conv(spec.latent_channels, c0),
        "mid": {"resnet_0": resnet(c0, c0), "attn": {"group_norm": norm(c0), "to_q": lin, "to_k": lin, "to_v": lin,
                                                    "to_out": lin}, "resnet_1": resnet(c0, c0)},
        "up": up,
        "norm_out": norm(ch[-1]),
        "conv_out": conv(ch[-1], spec.out_channels),
    }


def random_like_clip(spec: ClipTextSpec, seed: int, dtype, device) -> Dict:
    return seeded_tree(clip_param_shapes(spec), seed, 0.05, dtype, device)


def random_like_t5(spec: T5EncoderSpec, seed: int, dtype, device) -> Dict:
    return seeded_tree(t5_param_shapes(spec), seed, 0.05, dtype, device)


def random_like_vae(spec: VaeDecoderSpec, seed: int, dtype, device) -> Dict:
    """The reference's seeded VAE: std-0.05 conv and attention weights drawn
    in its construction order (conv_in, the mid block, norm_out's conv_out,
    then the up blocks), HWIO draws stored as OIHW; biases zero, norms
    ones."""
    rng = np.random.RandomState(seed)
    ch = list(reversed(spec.block_out_channels))  # the decoder runs high -> low

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    def conv(i, o, k=3):
        w = rng.randn(k, k, i, o).astype(np.float32) * 0.05
        return {"weight": t(w.transpose(3, 2, 0, 1)), "bias": torch.zeros((o,), dtype=dtype, device=device)}

    def lin(i, o):
        return {"weight": t(rng.randn(i, o).astype(np.float32) * 0.05),
                "bias": torch.zeros((o,), dtype=dtype, device=device)}

    def norm(c):
        return {"weight": torch.ones((c,), dtype=dtype, device=device),
                "bias": torch.zeros((c,), dtype=dtype, device=device)}

    def resnet(i, o):
        out = {"norm1": norm(i), "conv1": conv(i, o), "norm2": norm(o), "conv2": conv(o, o)}
        if i != o:
            out["conv_shortcut"] = conv(i, o, k=1)
        return out

    c0 = ch[0]
    params = {
        "conv_in": conv(spec.latent_channels, c0),
        "mid": {
            "resnet_0": resnet(c0, c0),
            "attn": {"group_norm": norm(c0), "to_q": lin(c0, c0), "to_k": lin(c0, c0), "to_v": lin(c0, c0),
                     "to_out": lin(c0, c0)},
            "resnet_1": resnet(c0, c0),
        },
        "up": [],
        "norm_out": norm(ch[-1]),
        "conv_out": conv(ch[-1], spec.out_channels),
    }
    prev = c0
    for ui, c in enumerate(ch):
        blk = {f"resnet_{ri}": resnet(prev if ri == 0 else c, c) for ri in range(spec.layers_per_block + 1)}
        if ui < len(ch) - 1:
            blk["upsample"] = {"conv": conv(c, c)}
        params["up"].append(blk)
        prev = c
    return params
