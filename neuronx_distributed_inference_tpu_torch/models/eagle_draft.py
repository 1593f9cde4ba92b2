"""EAGLE draft builders (counterpart of the reference's
``models/eagle_draft.py``): a llama-family draft whose input is
``fc([embed(token), feature])``.

- ``llama-eagle`` (:class:`EagleLlamaDraftBuilder`): a llama decoder (one
  layer in the published checkpoints) plus ``fc`` (2H -> H) and, with
  ``enable_eagle_draft_input_norm``, an rms ``input_norm`` of the
  embedding. Run by ``modules/eagle.eagle_draft_hidden``.
- ``llama-eagle3`` (:class:`Eagle3LlamaDraftBuilder`): ONE fused layer whose
  q/k/v project the 2H ``[embed | feature]`` concat, a ``hidden_norm`` of
  the feature half, ``fc`` (3H -> H) over the target's three-layer capture,
  and optionally a reduced lm-head vocab (``draft_vocab_size``) with a
  ``d2t`` table mapping draft token d to target token ``d + d2t[d]``. Run by
  ``modules/eagle.eagle3_draft_hidden``.

HF checkpoints carry the decoder under llama names plus ``fc.weight``
(and ``d2t``, ``model.layers.0.hidden_norm.weight`` for EAGLE3); a missing
final norm reads as ones. Random weights follow the base builder's (norm
weights, ``input_norm`` and ``hidden_norm`` among them, are ones; a random
``d2t`` is zeros, the identity map).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from neuronx_distributed_inference_tpu_torch.models.builder import (
    DecoderModelBuilder,
    _to_torch,
    hf_array,
    pad_vocab,
)
from neuronx_distributed_inference_tpu_torch.models.llama import LlamaInferenceConfig
from neuronx_distributed_inference_tpu_torch.models.registry import register_model


def _with_final_norm(sd: Dict, hidden: int) -> Dict:
    """EAGLE checkpoints may omit the final norm (an identity): ones."""
    sd = dict(sd)
    sd.setdefault("model.norm.weight", np.ones(hidden, np.float32))
    return sd


def _fc(sd: Dict) -> np.ndarray:
    """The fusion layer in (in, out) orientation."""
    return hf_array(sd, "fc.weight" if "fc.weight" in sd else "model.fc.weight").T


@register_model("llama-eagle")
class EagleLlamaDraftBuilder(DecoderModelBuilder):
    """Llama draft + fc input fusion (+ optional draft input norm)."""

    config_cls = LlamaInferenceConfig

    @property
    def _input_norm(self) -> bool:
        return bool(self.config.torch_config.enable_eagle_draft_input_norm)

    def param_shapes(self) -> Dict:
        shapes = super().param_shapes()
        H = self.config.hidden_size
        shapes["fc"] = {"weight": (2 * H, H)}
        if self._input_norm:
            shapes["input_norm"] = {"weight": (H,)}
        return shapes

    def convert_hf_state_dict(self, sd: Dict, dtype: Optional[torch.dtype] = None) -> Dict:
        dtype = dtype or self.dtype
        H = self.config.hidden_size
        sd = _with_final_norm(sd, H)
        params = super().convert_hf_state_dict(sd, dtype)
        params["fc"] = {"weight": _to_torch(_fc(sd), dtype, self.device)}
        if self._input_norm:
            w = hf_array(sd, "input_norm.weight") if "input_norm.weight" in sd else np.ones(H, np.float32)
            params["input_norm"] = {"weight": _to_torch(w, dtype, self.device)}
        return params


@register_model("llama-eagle3")
class Eagle3LlamaDraftBuilder(DecoderModelBuilder):
    """EAGLE3 draft: ONE fused llama layer whose qkv consumes the
    [embed | feature] 2H concat, split input norms and a 3H -> H fc over
    the target's capture (the reference's ``Eagle3LlamaDraftBuilder``)."""

    config_cls = LlamaInferenceConfig

    def __init__(self, config):
        super().__init__(config)
        if config.num_hidden_layers != 1:
            raise ValueError(
                "EAGLE3 drafts are a single fused decoder layer "
                "(reference modeling_llama.py eagle3 branch)"
            )

    @property
    def draft_vocab(self) -> Optional[int]:
        """The reduced lm-head vocab (``draft_vocab_size``, with a ``d2t``
        table); None: the target's vocab."""
        return getattr(self.config, "draft_vocab_size", None)

    def model_spec(self):
        spec = super().model_spec()
        if self.draft_vocab:
            # the lm head scores the reduced vocab; the embedding stays
            # target-vocab (draft inputs are target token ids)
            spec = dataclasses.replace(spec, vocab_size=self.draft_vocab)
        return spec

    def _padded_draft_vocab(self) -> int:
        return pad_vocab(self.draft_vocab, self.config.torch_config.tp_degree)

    def param_shapes(self) -> Dict:
        shapes = super().param_shapes()
        H = self.config.hidden_size
        D, Hq, Hkv = self.head_dim, self.num_heads, self.num_kv_heads
        sa = shapes["layers"]["self_attn"]
        # q/k/v over the 2H [embed | feature] concat
        if "qkv_proj" in sa:
            sa["qkv_proj"]["weight"] = (1, 2 * H, (Hq + 2 * Hkv) * D)
        else:
            sa["q_proj"]["weight"] = (1, 2 * H, Hq * D)
            sa["k_proj"]["weight"] = (1, 2 * H, Hkv * D)
            sa["v_proj"]["weight"] = (1, 2 * H, Hkv * D)
        shapes["layers"]["hidden_norm"] = {"weight": (1, H)}
        shapes["fc"] = {"weight": (3 * H, H)}
        if self.draft_vocab:
            shapes["lm_head"] = {"weight": (H, self._padded_draft_vocab())}
        return shapes

    def random_params(self, std: float = 0.02) -> Dict:
        params = super().random_params(std)
        if self.draft_vocab:
            params["d2t"] = {"table": torch.zeros(self.draft_vocab, dtype=torch.int32, device=self.device)}
        return params

    def convert_hf_state_dict(self, sd: Dict, dtype: Optional[torch.dtype] = None) -> Dict:
        dtype = dtype or self.dtype
        H = self.config.hidden_size
        sd = _with_final_norm(sd, H)
        params = super().convert_hf_state_dict(sd, dtype)
        params["fc"] = {"weight": _to_torch(_fc(sd), dtype, self.device)}
        name = "model.layers.0.hidden_norm.weight"
        hn = hf_array(sd, name) if name in sd else np.ones(H, np.float32)
        params["layers"]["hidden_norm"] = {"weight": _to_torch(hn[None, :], dtype, self.device)}
        if self.draft_vocab:
            if "d2t" not in sd:
                raise KeyError(
                    "draft_vocab_size set but the checkpoint has no d2t "
                    "draft->target vocab table"
                )
            d2t = np.asarray(sd["d2t"].cpu() if isinstance(sd["d2t"], torch.Tensor) else sd["d2t"])
            params["d2t"] = {"table": torch.from_numpy(d2t.astype(np.int32)).to(self.device)}
            lm = hf_array(sd, "lm_head.weight").T  # (H, draft_vocab)
            pad = self._padded_draft_vocab() - lm.shape[1]
            if pad:
                lm = np.pad(lm, ((0, 0), (0, pad)))
            params["lm_head"] = {"weight": _to_torch(lm, dtype, self.device)}
        return params
