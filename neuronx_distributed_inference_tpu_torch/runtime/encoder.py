"""Generic encoder application (counterpart of the reference's
``runtime/encoder.py``: ``register_encoder``, ``get_encoder_factory``,
``TpuEncoderApplication``).

An encoder is a plain function ``encode_fn(params, *tensors)``, a
checkpoint converter and its static keyword arguments; the application
loads the weights on the config's device and runs the function eagerly (no
graph: a tower runs once a request). Concrete towers register through
:func:`register_encoder`: ``pixtral``, ``llama4_vision`` and
``mllama_vision``, ``whisper_encoder``, and FLUX's ``flux_clip_text``,
``flux_t5`` and ``flux_vae_decoder`` (registered by ``runtime/flux.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from neuronx_distributed_inference_tpu_torch.config import resolve_device, to_dtype
from neuronx_distributed_inference_tpu_torch.runtime.model_runner import as_device_tensor

_ENCODER_REGISTRY: Dict[str, Callable] = {}


def register_encoder(name: str):
    """Register a factory: (config) -> (encode_fn, convert_fn, static
    kwargs). The registry is filled at import and only read after."""

    def deco(fn):
        _ENCODER_REGISTRY[name] = fn
        return fn

    return deco


def get_encoder_factory(name: str):
    if name not in _ENCODER_REGISTRY:
        raise KeyError(f"unknown encoder {name!r}; registered: {sorted(_ENCODER_REGISTRY)}")
    return _ENCODER_REGISTRY[name]


class EncoderApplication:
    """Encoder-only application: load -> encode (the reference's
    ``TpuEncoderApplication``).

    ``encode_fn(params, *tensors) -> tensor``; ``convert_fn(state_dict,
    dtype, device) -> params`` maps an HF checkpoint onto the params tree.
    The device is ``device`` where given (a FLUX spec carries none), else
    the config's ``torch_config.device``: the card unless the caller asks
    for the CPU."""

    def __init__(self, encode_fn: Callable, convert_fn: Optional[Callable] = None, config=None,
                 static_kwargs: Optional[dict] = None, device=None):
        self.config = config
        self.convert_fn = convert_fn
        self.encode_fn = encode_fn
        self.static_kwargs = static_kwargs or {}
        if device is None:
            tc = getattr(config, "torch_config", None)
            device = tc.device if tc is not None else "cuda"
        self.device = resolve_device(device)
        self.params = None

    @classmethod
    def from_registry(cls, name: str, config, device=None):
        encode_fn, convert_fn, static_kwargs = get_encoder_factory(name)(config)
        return cls(encode_fn, convert_fn, config=config, static_kwargs=static_kwargs, device=device)

    def load(self, state_dict=None, params=None, model_path=None, dtype=None):
        """``params`` as they are, or ``state_dict`` converted in the
        config's dtype (fp32 without a config)."""
        if params is None:
            if state_dict is None:
                raise NotImplementedError(
                    "loading a checkpoint from a path is not ported to PyTorch yet "
                    "(ROADMAP A11); pass state_dict= or params="
                )
            tc = getattr(self.config, "torch_config", None)
            dt = dtype if dtype is not None else (to_dtype(tc.dtype) if tc is not None else torch.float32)
            params = self.convert_fn(state_dict, dt, self.device)
        self.params = params
        return self

    def warmup(self, *example_arrays):
        """Run once on example inputs (the reference's compile)."""
        self(*example_arrays)
        return self

    @torch.no_grad()
    def __call__(self, *arrays):
        if self.params is None:
            raise RuntimeError("call load() first")
        return self.encode_fn(self.params, *(as_device_tensor(a, self.device) for a in arrays), **self.static_kwargs)

    encode = __call__


# ---------------------------------------------------------------------------
# the in-tree encoder factories
# ---------------------------------------------------------------------------


@register_encoder("pixtral")
def _pixtral_factory(config):
    from neuronx_distributed_inference_tpu_torch.models.pixtral import (
        convert_pixtral_vision_state_dict,
        pixtral_vision_encoder,
        pixtral_vision_spec,
    )

    spec = pixtral_vision_spec(getattr(config, "vision_config", config))

    def convert(sd, dt, device):
        return convert_pixtral_vision_state_dict(sd, spec, "model.vision_tower.", dt, device)

    return pixtral_vision_encoder, convert, {"spec": spec}


@register_encoder("llama4_vision")
def _llama4_vision_factory(config):
    from neuronx_distributed_inference_tpu_torch.models.llama4_vision import (
        convert_llama4_vision_state_dict,
        llama4_vision_encoder,
        llama4_vision_spec_from_config,
    )

    spec = llama4_vision_spec_from_config(getattr(config, "vision_config", config))

    def convert(sd, dt, device):
        return convert_llama4_vision_state_dict(sd, spec, "vision_model.", dt, device)

    return llama4_vision_encoder, convert, {"spec": spec}


@register_encoder("mllama_vision")
def _mllama_vision_factory(config):
    from neuronx_distributed_inference_tpu_torch.models.mllama import (
        convert_mllama_vision_state_dict,
        mllama_vision_encoder,
        mllama_vision_spec,
    )

    spec = mllama_vision_spec(getattr(config, "vision_config", config))

    def convert(sd, dt, device):
        return convert_mllama_vision_state_dict(sd, spec, "model.vision_model.", dt, device)

    return mllama_vision_encoder, convert, {"spec": spec}


@register_encoder("whisper_encoder")
def _whisper_encoder_factory(config):
    from neuronx_distributed_inference_tpu_torch.models.whisper import (
        convert_whisper_state_dict,
        whisper_encoder,
        whisper_spec,
    )

    spec = whisper_spec(config)

    def convert(sd, dt, device):
        return convert_whisper_state_dict(sd, spec, dt, device)["encoder"]

    return whisper_encoder, convert, {"spec": spec}
