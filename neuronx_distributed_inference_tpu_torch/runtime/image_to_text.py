"""Image-to-text application: vision tower + projector + causal-LM decoder
(counterpart of the reference's ``runtime/image_to_text.py``,
``TpuImageToTextModel``).

The images are encoded, projected into the text embedding space and
spliced in at the image-placeholder positions; then the ordinary causal-LM
prefill and decode run. The decoder is the unmodified
:class:`~.application.ModelForCausalLM`: the images enter only through
``inputs_embeds`` at the prefill, whose context-encoding program is a CUDA
graph key of its own, so every decoder feature (buckets, graphs, the seal,
sampling) applies unchanged. Towers: Pixtral (llava layout) and Llama4
(unfold patches, pixel shuffle), each plain PyTorch, run eagerly once a
request.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from neuronx_distributed_inference_tpu_torch.config import InferenceConfig, to_dtype
from neuronx_distributed_inference_tpu_torch.models import get_model_builder
from neuronx_distributed_inference_tpu_torch.models.base import act_fn, embed
from neuronx_distributed_inference_tpu_torch.models.pixtral import (
    convert_pixtral_vision_state_dict,
    pixtral_vision_encoder,
    pixtral_vision_spec,
    random_projector,
    random_vision_params,
    tower_tensor,
)
from neuronx_distributed_inference_tpu_torch.modules.sampling import prepare_sampling_params
from neuronx_distributed_inference_tpu_torch.runtime.application import GenerationOutput, ModelForCausalLM
from neuronx_distributed_inference_tpu_torch.runtime.model_runner import as_device_tensor


class ImageToTextModel:
    """Llava-architecture multimodal app (vision tower Pixtral or Llama4).

    ``config`` carries the HF multimodal attributes: ``text_config`` and
    ``vision_config`` dicts, ``image_token_index``, ``projector_hidden_act``.
    The text decoder is a whole :class:`ModelForCausalLM` built from
    ``text_config`` on the config's device."""

    def __init__(self, model_path: Optional[str], config: InferenceConfig):
        self.config = config
        self.model_path = model_path
        tc = config.torch_config
        vision_cfg = getattr(config, "vision_config", None)
        text_cfg = getattr(config, "text_config", None)
        if vision_cfg is None or text_cfg is None:
            raise ValueError("multimodal config needs vision_config and text_config")
        vg = vision_cfg.get if isinstance(vision_cfg, dict) else lambda k, d=None: getattr(vision_cfg, k, d)
        # the vision backend: the pixtral / llava tower or the llama4 one,
        # both feeding the same inputs_embeds splice
        self.vision_kind = "llama4" if "llama4" in str(vg("model_type", "pixtral")) else "pixtral"
        if self.vision_kind == "llama4":
            from neuronx_distributed_inference_tpu_torch.models.llama4_vision import (
                llama4_vision_encoder,
                llama4_vision_spec_from_config,
            )

            self.vision_spec = llama4_vision_spec_from_config(vision_cfg)
            self._encode_fn = llama4_vision_encoder
        else:
            self.vision_spec = pixtral_vision_spec(vision_cfg)
            self._encode_fn = pixtral_vision_encoder
        self.image_token = getattr(config, "image_token_index", None)
        if self.image_token is None:
            raise ValueError("config.image_token_index required")
        self.projector_act = getattr(config, "projector_hidden_act", "gelu")

        tg = text_cfg.get if isinstance(text_cfg, dict) else lambda k, d=None: getattr(text_cfg, k, d)
        text_type = tg("model_type", "llama")

        def load_text(cfg_obj):
            cfg_obj.model_type = text_type
            items = text_cfg.items() if isinstance(text_cfg, dict) else vars(text_cfg).items()
            for k, v in items:
                setattr(cfg_obj, k, v)

        builder_cls = get_model_builder(text_type)
        config_cls = getattr(builder_cls, "config_cls", InferenceConfig)
        self.text = ModelForCausalLM(model_path, config_cls(dataclasses.replace(tc), load_config=load_text))
        self.device = self.text.device
        self.vision_params: Optional[Dict] = None
        self.projector: Optional[Dict] = None

    # ---- load ------------------------------------------------------------

    def load(self, model_path=None, state_dict=None, random_weights: bool = False, params=None):
        """Weights from an HF llava / Llama4 state dict, seeded random
        weights (Pixtral only, as in the reference), or ``params``: a dict
        of the port's ``text`` params (as ``ModelForCausalLM.load(params=)``
        takes them), ``vision`` and ``projector`` trees, taken as they are
        (the card phases seed them on the device)."""
        dt = to_dtype(self.config.torch_config.dtype)
        if params is not None:
            self.text.load(params=params["text"])
            self.vision_params, self.projector = params["vision"], params["projector"]
            return self
        if random_weights and self.vision_kind == "llama4":
            raise NotImplementedError("llama4-vision random init is not wired; pass an HF state dict")
        if random_weights:
            self.text.load(random_weights=True)
            self.vision_params = random_vision_params(self.vision_spec, dt, self.device)
            self.projector = random_projector(self.vision_spec.hidden_size, self.text.config.hidden_size, dt, self.device)
            return self
        if state_dict is None:
            raise NotImplementedError(
                "loading a checkpoint from a path is not ported to PyTorch yet "
                "(ROADMAP A11); pass state_dict=, params= or random_weights=True"
            )

        def proj(name):
            v = state_dict[name]
            return v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float32)

        if self.vision_kind == "llama4":
            # HF llama4 layout: vision_model.* / multi_modal_projector.* /
            # language_model.model.* / language_model.lm_head.weight, one
            # bias-free projector linear
            from neuronx_distributed_inference_tpu_torch.models.llama4_vision import convert_llama4_vision_state_dict

            text_sd = {}
            for k, v in state_dict.items():
                if k.startswith("language_model.model."):
                    text_sd["model." + k[len("language_model.model.") :]] = v
                elif k == "language_model.lm_head.weight":
                    text_sd["lm_head.weight"] = v
            self.text.load(state_dict=text_sd)
            self.vision_params = convert_llama4_vision_state_dict(
                state_dict, self.vision_spec, "vision_model.", dt, self.device
            )
            self.projector = {
                "linear_1": {"weight": tower_tensor(proj("multi_modal_projector.linear_1.weight").T, dt, self.device)}
            }
            return self
        # HF llava layout: model.vision_tower.* / model.multi_modal_projector.*
        # / model.language_model.* / lm_head.weight
        text_sd = {}
        for k, v in state_dict.items():
            if k.startswith("model.language_model."):
                text_sd["model." + k[len("model.language_model.") :]] = v
            elif k == "lm_head.weight":
                text_sd[k] = v
        self.text.load(state_dict=text_sd)
        self.vision_params = convert_pixtral_vision_state_dict(
            state_dict, self.vision_spec, "model.vision_tower.", dt, self.device
        )
        p = "model.multi_modal_projector."
        self.projector = {
            n: {
                "weight": tower_tensor(proj(p + n + ".weight").T, dt, self.device),
                "bias": tower_tensor(proj(p + n + ".bias"), dt, self.device),
            }
            for n in ("linear_1", "linear_2")
        }
        return self

    # ---- the multimodal prefill -----------------------------------------

    def warmup(self):
        """Warm the text app (its programs, and its seal under the retrace
        guard), then capture the inputs_embeds context-encoding program of
        every bucket under ``seal_suspended()``: a separate key, so the
        first image request captures nothing."""
        self.text.warmup()
        cte = self.text.context_encoding_model
        H = self.text.config.hidden_size
        dt = to_dtype(self.config.torch_config.dtype)
        B = cte.batch_size
        with cte.seal_suspended():
            for bucket in cte.buckets:
                inputs, _ = cte.prepare(
                    np.zeros((B, bucket), np.int64), np.ones((B, bucket), np.int64),
                    np.tile(np.arange(bucket, dtype=np.int32), (B, 1)), np.arange(B, dtype=np.int32),
                    prepare_sampling_params(B),
                    inputs_embeds=torch.zeros((B, bucket, H), dtype=dt, device=self.device),
                )
                cte(self.text.params, self.text.kv_cache, inputs)
        return self

    @torch.no_grad()
    def encode_images(self, pixel_values) -> torch.Tensor:
        """(N, C, H, W) -> (N, patches, H_text): the tower, then the
        projector."""
        px = as_device_tensor(pixel_values, self.device)
        feats = self._encode_fn(self.vision_params, px, self.vision_spec)
        p = self.projector
        if self.vision_kind == "llama4":
            # one bias-free linear, no activation (HF Llama4MultiModalProjector)
            return feats @ p["linear_1"]["weight"].to(feats.dtype)
        x = feats @ p["linear_1"]["weight"].to(feats.dtype) + p["linear_1"]["bias"].to(feats.dtype)
        x = act_fn(self.projector_act)(x)
        return x @ p["linear_2"]["weight"].to(x.dtype) + p["linear_2"]["bias"].to(x.dtype)

    @torch.no_grad()
    def merge_embeddings(self, input_ids, image_features: torch.Tensor) -> torch.Tensor:
        """The text embeddings with the image features spliced in at the
        placeholder positions, in raster order (the embeddings' dtype)."""
        ids = np.asarray(input_ids)
        embeds = embed(self.text.params, torch.from_numpy(ids.astype(np.int64)).to(self.device))
        flat = image_features.reshape(-1, image_features.shape[-1])
        b_idx, s_idx = np.nonzero(ids == self.image_token)
        if len(b_idx) != flat.shape[0]:
            raise ValueError(
                f"image tokens ({len(b_idx)}) != image features "
                f"({flat.shape[0]}); check image_token_index / image sizes"
            )
        embeds = embeds.clone()
        embeds[torch.from_numpy(b_idx).to(self.device), torch.from_numpy(s_idx).to(self.device)] = flat.to(embeds.dtype)
        return embeds

    def generate(self, input_ids, attention_mask=None, pixel_values=None, **kwargs) -> GenerationOutput:
        if pixel_values is None:
            return self.text.generate(input_ids, attention_mask, **kwargs)
        embeds = self.merge_embeddings(input_ids, self.encode_images(pixel_values))
        return self.text.generate(input_ids, attention_mask, inputs_embeds=embeds, **kwargs)

