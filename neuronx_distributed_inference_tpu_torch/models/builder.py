"""Decoder model builder: HF config/checkpoint -> (ModelSpec, params)
(counterpart of the reference's ``models/builder.py``; one model-parallel
shard, so the reference's GQA padding/replication is the identity here).

Params are a nested dict with the reference's pytree layout: stacked layer
weights ``(L, ...)`` in (in, out) orientation, ``qkv_proj`` fused as
``[q|k|v]`` when ``fused_qkv`` is set, q/k/v ``bias`` leaves ``(L, N)``
for biased models (Qwen2, GPT-OSS), per-head ``q_norm``/``k_norm`` weights
``(L, D)`` for qk-norm models (Qwen3), a padded vocab, and a materialized
``(H, Vpad)`` lm head for tied embeddings.

A sliding window (``Config.sliding_window``, or a model's own, Mistral's)
bounds the contiguous cache to a ring of W slots when
:func:`ring_layout_ok` allows it (``ModelSpec.bounded_window``); the paged
pool and fused speculation keep full-length lines with windowed masks.
Chunked attention (``Config.attention_chunk_size``) never bounds the cache:
its layers keep full-length lines under the chunk masks, as in the
reference.
"""

from __future__ import annotations

import dataclasses
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


def ring_layout_ok(tc) -> bool:
    """Layout gate of the ring-bounded caches (slot = position mod W), the
    uniform one (``bounded_window``) and the interleaved one
    (``ring_window``): the paged pool and fused speculation assume position
    == slot and keep full-length lines (the reference's rule, less its
    context / attention / data parallel degrees, which the port refuses)."""
    return not tc.is_block_kv_layout and not tc.enable_fused_speculation


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


#: (parent, leaf) names of the fp32 tables: rope frequencies and the
#: vision towers' rope angles, cosines and sines
_FP32_TABLES = (("rope", "inv_freq"), ("rope", "table"), ("rope", "cos"), ("rope", "sin"))


def params_from_jax(tree: Dict, dtype: torch.dtype, device) -> Dict:
    """The JAX package's param pytree, fetched as numpy arrays, as the
    port's params: the layouts are the same, so this only converts leaves.
    Quantized entries cross unchanged: int8, uint8 (packed int4) and fp8
    codes keep their bytes and ``scale`` leaves stay fp32, as does
    ``rope.inv_freq``; integer tables (an EAGLE3 draft's ``d2t``) keep
    their integer type; every other leaf takes ``dtype``. The EAGLE
    drafts' ``fc``, ``input_norm``, ``hidden_norm`` and 2H-wide qkv and the
    Medusa heads (``medusa_heads``: ``res`` weight and bias, ``lm_head``,
    stacked by head) have the reference's layout too, and so do
    DeepSeek-V3's per-group stacks (``layers`` a list: the dense-first
    group, then the MoE group) with MLA's ``q_a_proj`` / ``q_a_layernorm``
    / ``q_b_proj`` (or ``q_proj``), ``kv_a_proj``, ``kv_a_layernorm``,
    ``k_absorb``, ``v_absorb``, the router's ``e_score_correction_bias``
    and the ``shared_experts`` (separate or fused ``gate_up_proj``), and
    Llama4's per-run stacks (a run of rope or NoPE layers, dense or MoE).
    A LoRA-attached tree's ``lora_A`` (L, N, in, r) and ``lora_B`` (L, N,
    r, out) take ``dtype`` and its ``lora_scaling`` (L, N) stays fp32, as
    ``modules/lora.attach_lora_params`` stores them. The multimodal trees
    carry across too: the Pixtral and Llama4 towers (``rope.table``,
    ``rope.cos`` / ``rope.sin`` stay fp32) with their projectors, and
    Mllama's whole tree (``vision``, ``projector``, the ``self_runs`` stacks
    and the ``cross_layers`` list). So do Whisper's ``encoder`` /
    ``decoder`` trees (their ``layers`` stacks; the convs keep torch's (out,
    in, 3)) and FLUX's backbone (``dual_blocks`` / ``single_blocks``
    stacks), CLIP and T5 trees; the VAE decoder's convs change layout, so
    its tree crosses through :func:`vae_params_from_jax`."""

    def conv(t, path):
        if isinstance(t, dict):
            return {k: conv(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [conv(v, path + (i,)) for i, v in enumerate(t)]
        a = np.asarray(t)
        code = _CODE_DTYPES.get(a.dtype.name)
        if code is not None:
            # every code dtype is one byte; fp8 has no numpy dtype torch
            # reads, so all of them cross as bytes and are viewed back
            return torch.from_numpy(np.array(a).view(np.uint8)).view(code).to(device)
        if a.dtype.kind in "iu":
            return torch.from_numpy(np.array(a)).to(device)
        fp32 = path[-2:] in _FP32_TABLES or path[-1] in ("scale", "lora_scaling")
        return _to_torch(a, torch.float32 if fp32 else dtype, device)

    return conv(tree, ())


def vae_params_from_jax(tree: Dict, dtype: torch.dtype, device) -> Dict:
    """The JAX package's FLUX VAE decoder tree (its ``up`` list of blocks
    included) as the port's: :func:`params_from_jax`, then every conv
    weight from the reference's HWIO to torch's OIHW (the tree's only 4-D
    leaves)."""

    def oihw(t):
        if isinstance(t, dict):
            return {k: oihw(v) for k, v in t.items()}
        if isinstance(t, list):
            return [oihw(v) for v in t]
        return t.permute(3, 2, 0, 1).contiguous() if t.dim() == 4 else t

    return oihw(params_from_jax(tree, dtype, device))


#: param-tree keys of norm weights: random weights set them to ones (the
#: EAGLE drafts' input_norm and hidden_norm, MLA's q_a / kv_a norms too)
NORM_KEYS = (
    "input_layernorm", "post_attention_layernorm", "norm", "q_norm", "k_norm", "input_norm", "hidden_norm",
    "q_a_layernorm", "kv_a_layernorm",
)


class DecoderModelBuilder:
    """Builder for llama-family decoder-only models."""

    qkv_bias = False
    o_bias = False
    qk_norm = False
    norm_type = "rmsnorm"
    #: True for the MoE builders (models/mixtral.py)
    is_moe = False
    #: True where the HF config's ``sliding_window`` is the model's window
    #: (Mistral); elsewhere only ``Config.sliding_window`` sets one
    hf_sliding_window = False

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
            qkv_bias=self.qkv_bias,
            o_bias=self.o_bias,
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
        spec = ModelSpec(
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
            sliding_window=self.sliding_window(),
            attention_chunk_size=tc.attention_chunk_size,
        )
        return self._finalize_bounded(spec)

    def sliding_window(self) -> Optional[int]:
        """``Config.sliding_window``; unset, the HF config's own for a
        model whose class sets ``hf_sliding_window`` (Mistral)."""
        window = self.config.torch_config.sliding_window
        if window is None and self.hf_sliding_window:
            window = getattr(self.config, "sliding_window", None) or None
        return window

    def _finalize_bounded(self, spec: ModelSpec) -> ModelSpec:
        """Bound the contiguous cache to a ring of W = ``sliding_window``
        slots when the layout allows it (:func:`ring_layout_ok`) and W is
        shorter than ``seq_len``; otherwise the full-length cache, masked."""
        tc = self.config.torch_config
        if (
            spec.sliding_window
            and spec.layer_groups is None
            and spec.sliding_window < tc.seq_len
            and ring_layout_ok(tc)
        ):
            return dataclasses.replace(spec, bounded_window=spec.sliding_window)
        return spec

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
        if self.qkv_bias:
            if "qkv_proj" in attn:
                attn["qkv_proj"]["bias"] = (L, (Hq + 2 * Hkv) * D)
            else:
                for p, n in (("q_proj", Hq), ("k_proj", Hkv), ("v_proj", Hkv)):
                    attn[p]["bias"] = (L, n * D)
        if self.o_bias:
            attn["o_proj"]["bias"] = (L, H)
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
        norms 1, like the reference; the numbers differ from JAX's). A
        ``layers`` list of per-group stacks (shapes that differ by group)
        is filled group by group.

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
            if isinstance(tree, list):  # per-group stacks (DeepSeek-V3)
                return [rand(t, key, stacked) for t in tree]
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
        sa = params["layers"]["self_attn"]
        for p in (("q_proj", "k_proj", "v_proj") if self.qkv_bias else ()) + (("o_proj",) if self.o_bias else ()):
            sa[p]["bias"] = stack(f"self_attn.{p}.bias", False)
        if self.qk_norm:
            for p in ("q_norm", "k_norm"):
                sa[p] = {"weight": stack(f"self_attn.{p}.weight", False)}
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
        """Concat q/k/v (and their biases) into one projection. The
        reference lays the fused axis out rank-interleaved; with one
        model-parallel rank that is the plain ``[q|k|v]`` concatenation."""
        sa = params["layers"]["self_attn"]
        parts = [sa.pop("q_proj"), sa.pop("k_proj"), sa.pop("v_proj")]
        sa["qkv_proj"] = {"weight": torch.cat([p["weight"] for p in parts], dim=-1)}
        if self.qkv_bias:
            sa["qkv_proj"]["bias"] = torch.cat([p["bias"] for p in parts], dim=-1)
        return params

    def mlp_fn(self):
        """The MLP of every layer, or a list indexed by each layer group's
        ``fn_idx`` (DeepSeek-V3: dense, then MoE)."""
        return gated_mlp

    def layer_fn(self):
        """A custom decoder layer (DeepSeek-V3's MLA layer), or a list
        indexed by ``fn_idx``; None: the shared ``models/base.decoder_layer``."""
        return None

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
        # a ring-bounded cache holds W slots a line (_finalize_bounded)
        return init_cache(
            self.config.num_hidden_layers,
            tc.max_batch_size,
            self.model_spec().bounded_window or tc.seq_len,
            self.num_kv_heads,
            self.head_dim,
            dtype=tc.kv_dtype,
            device=self.device,
        )
