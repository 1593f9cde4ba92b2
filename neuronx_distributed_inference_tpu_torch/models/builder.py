"""Decoder model builder: HF config/checkpoint -> (ModelSpec, params)
(counterpart of the reference's ``models/builder.py``; one model-parallel
shard, so the reference's GQA padding/replication is the identity here).

Params are a nested dict with the reference's pytree layout: stacked layer
weights ``(L, ...)`` in (in, out) orientation, ``qkv_proj`` fused as
``[q|k|v]`` when ``fused_qkv`` is set, per-head ``q_norm``/``k_norm``
weights ``(L, D)`` for qk-norm models (Qwen3), a padded vocab, and a
materialized ``(H, Vpad)`` lm head for tied embeddings.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Union

import numpy as np
import torch

from neuronx_distributed_inference_tpu_torch.config import InferenceConfig, resolve_device, to_dtype
from neuronx_distributed_inference_tpu_torch.models.base import ModelSpec, gated_mlp
from neuronx_distributed_inference_tpu_torch.modules.attention import AttnSpec
from neuronx_distributed_inference_tpu_torch.modules.block_kvcache import (
    BlockKVCache,
    init_block_cache,
    kv_block_bytes,
)
from neuronx_distributed_inference_tpu_torch.modules.kvcache import KVCache, init_cache
from neuronx_distributed_inference_tpu_torch.modules.rope import (
    compute_inv_freq,
    rope_attention_scaling,
)


def pad_vocab(vocab_size: int, degree: int) -> int:
    return math.ceil(vocab_size / degree) * degree


def _to_torch(x, dtype: torch.dtype, device) -> torch.Tensor:
    """numpy (incl. ml_dtypes bfloat16) or torch -> torch on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    a = np.asarray(x)
    if a.dtype.kind not in "fiub":  # bfloat16 and other extension floats
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def hf_array(sd: Dict, name: str) -> np.ndarray:
    """One HF checkpoint tensor (numpy or torch) as an fp32 numpy array."""
    if name not in sd:
        raise KeyError(f"missing HF weight {name}; have e.g. {list(sd)[:5]}")
    x = sd[name]
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


#: quantized codes that cross from the JAX package as they are
_CODE_DTYPES = {
    "int8": torch.int8, "uint8": torch.uint8,
    "float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2,
}


def params_from_jax(tree: Dict, dtype: torch.dtype, device) -> Dict:
    """The JAX package's param pytree, fetched as numpy arrays, as the
    port's params: the layouts are the same, so this only converts leaves.
    Quantized entries cross unchanged: int8, uint8 (packed int4) and fp8
    codes keep their bytes and ``scale`` leaves stay fp32, as does
    ``rope.inv_freq``; every other leaf takes ``dtype``."""

    def conv(t, path):
        if isinstance(t, dict):
            return {k: conv(v, path + (k,)) for k, v in t.items()}
        a = np.asarray(t)
        code = _CODE_DTYPES.get(a.dtype.name)
        if code is not None:
            # every code dtype is one byte; fp8 has no numpy dtype torch
            # reads, so all of them cross as bytes and are viewed back
            return torch.from_numpy(np.array(a).view(np.uint8)).view(code).to(device)
        fp32 = path == ("rope", "inv_freq") or path[-1] == "scale"
        return _to_torch(a, torch.float32 if fp32 else dtype, device)

    return conv(tree, ())


#: param-tree keys of norm weights: random weights set them to ones
NORM_KEYS = ("input_layernorm", "post_attention_layernorm", "norm", "q_norm", "k_norm")


class DecoderModelBuilder:
    """Builder for llama-family decoder-only models."""

    qk_norm = False
    norm_type = "rmsnorm"
    #: True for the MoE builders (models/mixtral.py); the serving paths
    #: refuse them
    is_moe = False

    def __init__(self, config: InferenceConfig):
        self.config = config
        tc = config.torch_config
        self.head_dim = getattr(config, "head_dim", None) or config.hidden_size // config.num_attention_heads
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = getattr(config, "num_key_value_heads", config.num_attention_heads)
        self.padded_vocab = pad_vocab(config.vocab_size, tc.tp_degree)
        self.device = resolve_device(tc.device)
        self.dtype = to_dtype(tc.dtype)

    # ---- spec ------------------------------------------------------------

    def attn_spec(self) -> AttnSpec:
        tc = self.config.torch_config
        return AttnSpec(
            num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads,
            head_dim=self.head_dim,
            scale=getattr(self.config, "attention_scale", None),
            qk_norm=self.qk_norm,
            softmax_fp32=tc.attention_softmax_fp32,
            has_sink=bool(getattr(self.config, "attention_sink", False)),
            rms_norm_eps=getattr(self.config, "rms_norm_eps", 1e-6),
            use_flash_kernel=tc.attn_kernel_enabled,
            use_tkg_kernel=tc.attn_block_tkg_kernel_enabled,
            use_fused_block=tc.fused_attn_block_kernel_enabled,
        )

    def model_spec(self) -> ModelSpec:
        cfg = self.config
        tc = cfg.torch_config
        return ModelSpec(
            num_layers=cfg.num_hidden_layers,
            vocab_size=cfg.vocab_size,
            attn=self.attn_spec(),
            rms_eps=getattr(cfg, "rms_norm_eps", 1e-6),
            act=getattr(cfg, "hidden_act", "silu"),
            output_logits=tc.output_logits,
            cast_logits_fp32=tc.cast_logits_fp32,
            attention_scaling=rope_attention_scaling(cfg),
            norm_type=self.norm_type,
            use_fused_mlp=tc.fused_mlp_kernel_enabled,
            do_sample=bool(tc.on_device_sampling_config and tc.on_device_sampling_config.do_sample),
            max_topk=tc.max_topk,
        )

    def host_read_tokens(self) -> Optional[int]:
        """The fewest tokens per row at which a step of this model reads on
        the host (none for dense models): such a step cannot be captured
        as a CUDA graph and runs eagerly (``runtime/model_runner.py``)."""
        return None

    # ---- param pytree ----------------------------------------------------

    def param_shapes(self) -> Dict:
        cfg = self.config
        L, H, I = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
        D, Hq, Hkv, V = self.head_dim, self.num_heads, self.num_kv_heads, self.padded_vocab
        if cfg.torch_config.fused_qkv:
            attn = {
                "qkv_proj": {"weight": (L, H, (Hq + 2 * Hkv) * D)},
                "o_proj": {"weight": (L, Hq * D, H)},
            }
        else:
            attn = {
                "q_proj": {"weight": (L, H, Hq * D)},
                "k_proj": {"weight": (L, H, Hkv * D)},
                "v_proj": {"weight": (L, H, Hkv * D)},
                "o_proj": {"weight": (L, Hq * D, H)},
            }
        shapes = {
            "embed_tokens": {"weight": (V, H)},
            "layers": {
                "input_layernorm": {"weight": (L, H)},
                "post_attention_layernorm": {"weight": (L, H)},
                "self_attn": attn,
                "mlp": {
                    "gate_proj": {"weight": (L, H, I)},
                    "up_proj": {"weight": (L, H, I)},
                    "down_proj": {"weight": (L, I, H)},
                },
            },
            "norm": {"weight": (H,)},
        }
        if self.qk_norm:
            attn["q_norm"] = {"weight": (L, D)}
            attn["k_norm"] = {"weight": (L, D)}
        if not getattr(cfg, "tie_word_embeddings", False):
            shapes["lm_head"] = {"weight": (H, V)}
        return shapes

    # ---- weights ---------------------------------------------------------

    def random_params(self, std: float = 0.02) -> Dict:
        """Random weights generated on the target device from a
        ``torch.Generator`` seeded with the config's ``seed`` (std 0.02,
        norms 1, like the reference; the numbers differ from JAX's).

        Each leaf is allocated once in the target dtype and filled in place,
        a stacked ``(L, ...)`` leaf one layer's slice at a time, so the fp32
        transient is one layer's slice and the load's peak stays near the
        params' own bytes (Qwen3-30B-A3B's expert leaf is 19.3 GB in bf16,
        38.7 GB as a whole fp32 tensor)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.config.torch_config.seed)

        def fill(shape, key, stacked):
            if key in NORM_KEYS:
                return torch.ones(shape, dtype=self.dtype, device=self.device)
            out = torch.empty(shape, dtype=self.dtype, device=self.device)
            for part in (out if stacked else out[None]):
                x = torch.randn(part.shape, generator=gen, device=self.device, dtype=torch.float32)
                part.copy_(x.mul_(std))
                del x
            return out

        def rand(tree, key, stacked):
            if isinstance(tree, dict):
                return {k: rand(v, k if k != "weight" else key, stacked or k == "layers") for k, v in tree.items()}
            return fill(tree, key, stacked)

        params = rand(self.param_shapes(), None, False)
        params["rope"] = {"inv_freq": compute_inv_freq(self.config).to(self.device)}
        if getattr(self.config, "tie_word_embeddings", False):
            # tied models carry a materialized transposed (H, V) copy, as the
            # reference does, so no per-step transpose of the vocab matrix
            params["lm_head"] = {"weight": params["embed_tokens"]["weight"].t().contiguous()}
        return params

    HF_LAYER_PREFIX = "model.layers.{i}."
    HF_EMBED = "model.embed_tokens.weight"
    HF_NORM = "model.norm.weight"
    HF_LM_HEAD = "lm_head.weight"

    def convert_hf_state_dict(self, sd: Dict, dtype: Optional[torch.dtype] = None) -> Dict:
        """HF checkpoint (numpy or torch leaves) -> stacked params: HF
        (out, in) weights become (in, out), the vocab is padded, tied models
        get the materialized transposed lm head, and ``fused_qkv`` fuses."""
        cfg = self.config
        dtype = dtype or self.dtype
        L = cfg.num_hidden_layers

        def get(name):
            return hf_array(sd, name)

        def stack(suffix, transpose=True):
            arrs = [get(self.HF_LAYER_PREFIX.format(i=i) + suffix) for i in range(L)]
            arr = np.stack([a.T if transpose else a for a in arrs])
            return _to_torch(arr, dtype, self.device)

        embed = get(self.HF_EMBED)
        vpad = self.padded_vocab - embed.shape[0]
        if vpad:
            embed = np.pad(embed, ((0, vpad), (0, 0)))
        params = {
            "embed_tokens": {"weight": _to_torch(embed, dtype, self.device)},
            "rope": {"inv_freq": compute_inv_freq(cfg).to(self.device)},
            "layers": {
                "input_layernorm": {"weight": stack("input_layernorm.weight", False)},
                "post_attention_layernorm": {"weight": stack("post_attention_layernorm.weight", False)},
                "self_attn": {
                    p: {"weight": stack(f"self_attn.{p}.weight")}
                    for p in ("q_proj", "k_proj", "v_proj", "o_proj")
                },
                "mlp": {
                    p: {"weight": stack(f"mlp.{p}.weight")}
                    for p in ("gate_proj", "up_proj", "down_proj")
                },
            },
            "norm": {"weight": _to_torch(get(self.HF_NORM), dtype, self.device)},
        }
        if self.qk_norm:
            for p in ("q_norm", "k_norm"):
                params["layers"]["self_attn"][p] = {"weight": stack(f"self_attn.{p}.weight", False)}
        if getattr(cfg, "tie_word_embeddings", False):
            params["lm_head"] = {"weight": params["embed_tokens"]["weight"].t().contiguous()}
        else:
            lm = get(self.HF_LM_HEAD).T if self.HF_LM_HEAD in sd else get(self.HF_EMBED).T
            if vpad:
                lm = np.pad(lm, ((0, 0), (0, vpad)))
            params["lm_head"] = {"weight": _to_torch(lm, dtype, self.device)}
        if cfg.torch_config.fused_qkv:
            params = self._fuse_qkv(params)
        return params

    def _fuse_qkv(self, params: Dict) -> Dict:
        """Concat q/k/v into one projection. The reference lays the fused
        axis out rank-interleaved; with one model-parallel rank that is the
        plain ``[q|k|v]`` concatenation."""
        sa = params["layers"]["self_attn"]
        parts = [sa.pop("q_proj")["weight"], sa.pop("k_proj")["weight"], sa.pop("v_proj")["weight"]]
        sa["qkv_proj"] = {"weight": torch.cat(parts, dim=-1)}
        return params

    def mlp_fn(self):
        return gated_mlp

    def init_kv_cache(self) -> Union[KVCache, BlockKVCache]:
        """The contiguous cache, or the paged block pool when
        ``is_block_kv_layout``. A byte-budgeted pool (``pa_pool_bytes``)
        resolves ``pa_num_blocks`` here from the per-block cost in the cache
        dtype, as the reference's ``init_kv_cache`` does."""
        tc = self.config.torch_config
        if tc.is_block_kv_layout:
            if tc.pa_num_blocks is None and tc.pa_pool_bytes is not None:
                tc.pa_num_blocks = max(
                    1,
                    tc.pa_pool_bytes // kv_block_bytes(
                        self.config.num_hidden_layers, tc.pa_block_size,
                        self.num_kv_heads, self.head_dim, tc.kv_dtype,
                    ),
                )
            return init_block_cache(
                self.config.num_hidden_layers,
                tc.pa_num_blocks,
                tc.pa_block_size,
                self.num_kv_heads,
                self.head_dim,
                dtype=tc.kv_dtype,
                device=self.device,
            )
        return init_cache(
            self.config.num_hidden_layers,
            tc.max_batch_size,
            tc.seq_len,
            self.num_kv_heads,
            self.head_dim,
            dtype=tc.kv_dtype,
            device=self.device,
        )
