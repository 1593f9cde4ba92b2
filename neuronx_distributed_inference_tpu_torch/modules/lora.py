"""Multi-adapter LoRA serving (counterpart of the reference's
``modules/lora.py``).

Adapters live STACKED beside their base weight, one row per slot::

    entry = {"weight": (in, out), "lora_A": (N, in, r_max),
             "lora_B": (N, r_max, out), "lora_scaling": (N,)}

in each layer of a loaded app's per-layer list (views of layer-stacked
``(L, N, ...)`` tensors, so one write reaches every layer).
``adapter_ids (B,)`` gathers each row's adapter; slot 0 is the zero adapter,
so base-model rows batch freely with adapter rows. The delta is two batched
products on tensors (:func:`lora_delta`), as the reference computes it
outside any kernel; only the attention projections apply it
(``modules/attention.py``).

:class:`DynamicLoraManager` serves more adapters than slots: a host cache
with LRU slot eviction. Its swaps write the slot rows IN PLACE
(:meth:`DynamicLoraManager._write_slot`), where the reference rebinds its
leaves: the tensors a captured CUDA graph reads keep their addresses, so
its next replay reads the new adapter.

The reference's ``lora_pspecs`` (adapter leaves replicated over the mesh)
has no counterpart: the port runs on one shard.
"""

from __future__ import annotations

import json
import logging
import math
import os
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

#: adapter id 0 = zero adapter (base model behavior)
BASE_ADAPTER_ID = 0


def lora_delta(entry: dict, x: torch.Tensor, adapter_ids: torch.Tensor) -> torch.Tensor:
    """Per-row LoRA delta: x (B, S, in) -> (B, S, out)."""
    A = entry["lora_A"][adapter_ids]  # (B, in, r)
    Bm = entry["lora_B"][adapter_ids]  # (B, r, out)
    scale = entry["lora_scaling"][adapter_ids]  # (B,)
    delta = torch.bmm(torch.bmm(x, A.to(x.dtype)), Bm.to(x.dtype))
    return delta * scale.to(x.dtype)[:, None, None]


def apply_lora(entry: dict, x: torch.Tensor, base_out: torch.Tensor, adapter_ids) -> torch.Tensor:
    """base_out + LoRA delta when this entry carries adapters."""
    if adapter_ids is None or "lora_A" not in entry:
        return base_out
    return base_out + lora_delta(entry, x, adapter_ids)


class LoraWeightManager:
    """Host-side adapter registry: adapter names -> slot ids (0 reserved)."""

    def __init__(self, lora_config):
        self.config = lora_config
        self.adapter_ids: Dict[str, int] = {}  # name -> id (0 reserved)

    def register(self, name: str) -> int:
        if name in self.adapter_ids:
            return self.adapter_ids[name]
        idx = len(self.adapter_ids) + 1  # 0 = zero adapter
        if idx > self.config.max_loras:
            raise RuntimeError(f"max_loras={self.config.max_loras} exceeded")
        self.adapter_ids[name] = idx
        return idx

    def resolve(self, names) -> np.ndarray:
        return np.asarray(
            [BASE_ADAPTER_ID if n is None else self.adapter_ids[n] for n in names],
            np.int32,
        )


def _host_array(x) -> np.ndarray:
    """A checkpoint tensor (numpy, or torch on any device) as fp32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def load_peft_adapter(path: str) -> Tuple[dict, dict]:
    """Load a PEFT adapter directory -> (state_dict, adapter_config).

    ``lora_alpha`` / ``use_rslora`` come from ``adapter_config.json``, not
    from the weights file. ``adapter_model.safetensors`` is read with
    ``safetensors`` (imported here: a host may lack it and still read an
    ``adapter_model.bin`` through ``torch.load``)."""
    config: dict = {}
    cfg_path = os.path.join(path, "adapter_config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            config = json.load(f)
    st = os.path.join(path, "adapter_model.safetensors")
    binp = os.path.join(path, "adapter_model.bin")
    if os.path.exists(st):
        from safetensors.numpy import load_file

        sd = dict(load_file(st))
    elif os.path.exists(binp):
        sd = {k: v.float().numpy() for k, v in torch.load(binp, map_location="cpu").items()}
    else:
        raise FileNotFoundError(f"no adapter_model.[safetensors|bin] under {path}")
    return sd, config


def _normalize_adapter(name: str, value) -> Tuple[dict, Optional[float], bool]:
    """Resolve an adapter entry to (state_dict, lora_alpha, use_rslora).

    Accepts a PEFT directory path, an explicit ``(state_dict, config)`` pair,
    ``{"state_dict": ..., "config": ...}``, or a bare state dict (in which
    case alpha may ride in the dict under ``lora_alpha``)."""
    if isinstance(value, str):
        sd, cfg = load_peft_adapter(value)
    elif isinstance(value, tuple):
        sd, cfg = value
    elif isinstance(value, dict) and "state_dict" in value:
        sd, cfg = value["state_dict"], value.get("config", {})
    else:
        sd, cfg = value, {}
    alpha = cfg.get("lora_alpha", sd.get("lora_alpha"))
    use_rslora = bool(cfg.get("use_rslora", False))
    if alpha is None:
        logger.warning(
            "LoRA adapter %r: lora_alpha not found in adapter_config.json or "
            "state dict; defaulting scaling to 1.0 (alpha=r). Pass the PEFT "
            "directory path or (state_dict, adapter_config) to fix.",
            name,
        )
    return sd, alpha, use_rslora


def _find_key(sd: dict, layer: int, module: str, piece: str):
    for pattern in (
        f"base_model.model.model.layers.{layer}.self_attn.{module}.{piece}.weight",
        f"base_model.model.model.layers.{layer}.mlp.{module}.{piece}.weight",
        f"model.layers.{layer}.self_attn.{module}.{piece}.weight",
        f"model.layers.{layer}.mlp.{module}.{piece}.weight",
    ):
        if pattern in sd:
            return sd[pattern]
    return None


def _targets(params: dict, target) -> List[Tuple[str, str, List[dict], Tuple[int, int, int]]]:
    """(group, module, every layer's entry, (L, in, out)) of each target
    projection that has a ``weight``, in the per-layer list of a loaded
    app's params. Packed int4 codes are refused: the reference builds A
    with the packed rows (in / 2) and fails."""
    layers = params["layers"]
    out = []
    for group in ("self_attn", "mlp"):
        for module, entry in layers[0].get(group, {}).items():
            if module not in target or "weight" not in entry:
                continue
            w = entry["weight"]
            if w.dtype == torch.uint8:
                raise NotImplementedError(
                    f"LoRA on packed int4 base weights ({group}.{module}): the reference "
                    "stacks A with the packed rows and fails to attach (ROADMAP C (int4 base "
                    "weights with LoRA))"
                )
            out.append((group, module, [lp[group][module] for lp in layers], (len(layers), *w.shape)))
    return out


def extract_adapter_arrays(
    params: dict,
    sd: dict,
    alpha,
    use_rslora: bool,
    num_layers: int,
    r_max: int,
    target,
    name: Optional[str] = None,
):
    """One adapter's PEFT weights -> {(group, module): (A (L, in, r_max),
    B (L, r_max, out), scaling float)}, fp32 numpy stacks in the device
    layout. ``name`` words the rank error as the static attach does."""
    out = {}
    for group, module, _, (L, d_in, d_out) in _targets(params, target):
        A = np.zeros((L, d_in, r_max), np.float32)
        B = np.zeros((L, r_max, d_out), np.float32)
        scaling = 0.0
        found = False
        for layer in range(num_layers):
            a = _find_key(sd, layer, module, "lora_A")
            b = _find_key(sd, layer, module, "lora_B")
            if a is None or b is None:
                continue
            found = True
            a, b = _host_array(a), _host_array(b)
            r = a.shape[0]
            if r > r_max:
                who = f"adapter {name}" if name is not None else "adapter"
                raise ValueError(f"{who} rank {r} > max_lora_rank {r_max}")
            A[layer, :, :r] = a.T
            B[layer, :r, :] = b.T
            denom = math.sqrt(r) if use_rslora else r
            scaling = (alpha if alpha is not None else r) / denom
        if found:
            out[(group, module)] = (A, B, float(scaling))
    return out


def _attach_zero_slots(entries: List[dict], shape: Tuple[int, int, int], n_slots: int, r_max: int, dtype) -> None:
    """Zero slots under every layer's entry: each layer takes its view of
    one layer-stacked (L, N, ...) tensor a leaf."""
    L, d_in, d_out = shape
    dev = entries[0]["weight"].device
    stacks = {
        "lora_A": torch.zeros((L, n_slots, d_in, r_max), dtype=dtype, device=dev),
        "lora_B": torch.zeros((L, n_slots, r_max, d_out), dtype=dtype, device=dev),
        "lora_scaling": torch.zeros((L, n_slots), dtype=torch.float32, device=dev),
    }
    for i, e in enumerate(entries):
        for name, stack in stacks.items():
            e[name] = stack[i]


def write_slot(params: dict, slot: int, arrays: dict) -> None:
    """Write one adapter's stacks (:func:`extract_adapter_arrays`) into slot
    ``slot`` of every target entry, in place: each leaf keeps its storage,
    so a captured graph reads the new rows on its next replay."""
    by_key = {(g, m): entries for g, m, entries, _ in _targets(params, {m for _, m in arrays})}
    for key, (A, B, scaling) in arrays.items():
        entries = by_key[key]
        dev, dt = entries[0]["lora_A"].device, entries[0]["lora_A"].dtype
        a = torch.from_numpy(A).to(device=dev, dtype=dt)
        b = torch.from_numpy(B).to(device=dev, dtype=dt)
        for i, e in enumerate(entries):
            e["lora_A"][slot].copy_(a[i])
            e["lora_B"][slot].copy_(b[i])
            e["lora_scaling"][slot].fill_(scaling)


def attach_lora_params(
    params: dict,
    adapters: Dict[str, dict],
    manager: LoraWeightManager,
    num_layers: int,
    dtype: torch.dtype = torch.float32,
    init_all: bool = False,
) -> dict:
    """Stack adapter checkpoints into the param tree (in place; returned).

    ``adapters``: {adapter_name: any :func:`_normalize_adapter` form}, with
    PEFT keys like
    ``base_model.model.model.layers.{i}.self_attn.q_proj.lora_A.weight``
    ((r, in)) / ``...lora_B.weight`` ((out, r)). A target projection takes
    ``max_loras + 1`` zero slots when some adapter has weights for it (every
    target with ``init_all``, the dynamic cache's start); each adapter is
    then written into its slot."""
    cfg = manager.config
    n_slots = cfg.max_loras + 1  # slot 0 = zeros
    r_max = cfg.max_lora_rank
    target = set(cfg.target_modules)
    # normalize once up front: directory adapters hit the filesystem here
    normalized = {name: _normalize_adapter(name, value) for name, value in adapters.items()}
    targets = _targets(params, target)
    if not targets:
        return params
    attached = set()

    def ensure(keys):
        for group, module, entries, shape in targets:
            if (group, module) in keys and (group, module) not in attached:
                _attach_zero_slots(entries, shape, n_slots, r_max, dtype)
                attached.add((group, module))

    if init_all:
        ensure({(g, m) for g, m, _, _ in targets})
    for name, (sd, alpha, use_rslora) in normalized.items():
        idx = manager.register(name)
        arrays = extract_adapter_arrays(params, sd, alpha, use_rslora, num_layers, r_max, target, name=name)
        ensure(set(arrays))
        write_slot(params, idx, arrays)
    return params


class DynamicLoraManager(LoraWeightManager):
    """Dynamic multi-adapter cache: more adapters than device slots.

    The stacked slot rows in the param tree are the device state; a host
    table maps adapter name -> slot. Adapters beyond ``max_loras`` live
    preprocessed on the host (bounded by ``max_loras_on_cpu`` beyond the
    resident set, LRU-evicted). A cache miss evicts the least-recently-used
    resident adapter the current batch does not need and writes the
    newcomer's rows into its slot in place."""

    def __init__(self, lora_config):
        super().__init__(lora_config)
        self.cpu_cache: "OrderedDict[str, dict]" = OrderedDict()
        self.slot_of: Dict[str, int] = {}
        self.name_of_slot: Dict[int, str] = {}
        self.lru: List[str] = []  # least-recent first
        self.swaps = 0  # device slot writes

    # LoraWeightManager.resolve reads adapter_ids: the slot table
    @property
    def adapter_ids(self):
        return self.slot_of

    @adapter_ids.setter
    def adapter_ids(self, value):  # the base __init__ assigns {}
        self.slot_of = dict(value)

    def register_cpu(self, name: str, value, params: dict, num_layers: int):
        """Preprocess and host-cache one adapter (any _normalize_adapter form)."""
        if name in self.cpu_cache:
            return
        sd, alpha, use_rslora = _normalize_adapter(name, value)
        arrays = extract_adapter_arrays(
            params, sd, alpha, use_rslora, num_layers,
            self.config.max_lora_rank, set(self.config.target_modules),
        )
        if not arrays:
            raise ValueError(f"adapter {name!r} matched no target modules")
        self.cpu_cache[name] = arrays
        # bound host memory: resident adapters stay materialized (their
        # arrays are the swap source); beyond them keep max_loras_on_cpu
        overflow = [n for n in self.cpu_cache if n not in self.slot_of and n != name]
        while len(overflow) > self.config.max_loras_on_cpu:
            victim = overflow.pop(0)
            del self.cpu_cache[victim]
            logger.info("LoRA CPU cache evicted %r", victim)

    def _touch(self, name: str):
        if name in self.lru:
            self.lru.remove(name)
        self.lru.append(name)

    def ensure_on_device(self, params: dict, names) -> dict:
        """Make every named adapter device-resident, swapping slots as
        needed. Returns ``params`` (written in place)."""
        needed = [n for n in dict.fromkeys(names) if n is not None]
        missing = [n for n in needed if n not in self.slot_of]
        if not missing:
            for n in needed:
                self._touch(n)
            return params
        if len(needed) > self.config.max_loras:
            raise RuntimeError(
                f"batch needs {len(needed)} distinct adapters > "
                f"max_loras={self.config.max_loras}"
            )
        for name in missing:
            if name not in self.cpu_cache:
                raise KeyError(
                    f"unknown LoRA adapter {name!r}; register it first "
                    f"(app.register_lora_adapter)"
                )
            # pick a slot: a free one, else the LRU resident not in `needed`
            free = [s for s in range(1, self.config.max_loras + 1) if s not in self.name_of_slot]
            if free:
                slot = free[0]
            else:
                victim = next(n for n in self.lru if n not in needed)
                slot = self.slot_of.pop(victim)
                del self.name_of_slot[slot]
                self.lru.remove(victim)
                logger.info("LoRA slot %d: evicted %r for %r", slot, victim, name)
            params = self._write_slot(params, slot, self.cpu_cache[name])
            self.slot_of[name] = slot
            self.name_of_slot[slot] = name
            self.swaps += 1
            self._touch(name)
        for n in needed:
            self._touch(n)
        return params

    def _write_slot(self, params: dict, slot: int, arrays: dict) -> dict:
        """The reference rebinds each leaf (``.at[:, slot].set``); here the
        rows are copied into the leaves in place (:func:`write_slot`)."""
        write_slot(params, slot, arrays)
        return params
