"""HF ``model_type`` -> model builder class (counterpart of the reference's
``models/registry.py``)."""

from __future__ import annotations

from typing import Dict

MODEL_REGISTRY: Dict[str, type] = {}


def register_model(model_type: str):
    def deco(cls):
        MODEL_REGISTRY[model_type] = cls
        return cls

    return deco


def get_model_builder(model_type: str):
    if model_type not in MODEL_REGISTRY:
        raise KeyError(
            f"No model builder for model_type={model_type!r}; known: {sorted(MODEL_REGISTRY)}"
        )
    return MODEL_REGISTRY[model_type]
