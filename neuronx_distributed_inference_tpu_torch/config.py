"""Configuration of the port (the main-path subset).

Counterpart of ``neuronx_distributed_inference_tpu/config.py``:
:class:`Config` is the port's ``TpuConfig`` and :class:`InferenceConfig`
wraps it with the HF model attributes. Field names and validation follow
the reference for every field kept here. Settings the port does not run
yet raise ``NotImplementedError`` naming their ROADMAP item instead of being
silently ignored.

Two fields are new: ``device`` (default ``"cuda"``; asking for
``"cuda"`` without a card raises ``RuntimeError``, tests pass
``device="cpu"``) and ``cuda_graphs`` (default True: each runner captures
one CUDA graph per key and replays it, ``runtime/graphs.py``; False runs
the same programs eagerly, for debugging and for the eager vs graph
comparison). On the CPU the runners run eagerly whatever it says.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

_DTYPES = {
    "float32": torch.float32,
    "fp32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float16": torch.float16,
    "fp16": torch.float16,
}

#: accepted kv_cache_dtype names (reference KV_CACHE_DTYPES); the quantized
#: ones are validated as known and then refused as not yet ported
KV_CACHE_DTYPES = (
    "bfloat16", "bf16", "float16", "fp16", "float32", "fp32",
    "int8", "fp8", "float8_e4m3", "float8_e5m2",
)
KV_QUANT_DTYPE_NAMES = ("int8", "fp8", "float8_e4m3", "float8_e5m2")


def to_dtype(name_or_dtype) -> torch.dtype:
    """Resolve a dtype name (or torch dtype) to a torch dtype."""
    if isinstance(name_or_dtype, torch.dtype):
        return name_or_dtype
    key = str(name_or_dtype).replace("torch.", "")
    if key not in _DTYPES:
        raise ValueError(f"Unknown dtype name: {name_or_dtype}")
    return _DTYPES[key]


def resolve_device(device) -> torch.device:
    """The device a config names. ``cuda`` without a card raises: the port
    never carries on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} was asked for but torch sees no CUDA device; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


@dataclass
class OnDeviceSamplingConfig:
    """Sampler settings (reference OnDeviceSamplingConfig). ``do_sample``
    draws from the temperature / top-k / top-p warped distribution
    (``modules/sampling.py``) with the application's generator, seeded
    from ``Config.seed``; False decodes greedily."""

    do_sample: bool = False
    top_k: int = 1
    top_p: float = 1.0
    temperature: float = 1.0


@dataclass
class ChunkedPrefillConfig:
    """Chunked prefill settings (reference ChunkedPrefillConfig): up to
    ``max_num_seqs`` requests advance by ``kernel_q_tile_size`` prompt
    tokens per serving step."""

    max_num_seqs: int = 8
    kernel_q_tile_size: int = 128


#: settings outside the ported slice -> (inert value, ROADMAP item)
_NOT_PORTED: Dict[str, Tuple[Any, str]] = {
    "tp_degree": (1, "A10 (parallelism)"),
    "ep_degree": (1, "A10 (parallelism: expert parallelism)"),
    "quantized_checkpoints_path": (None, "A11 (quantized checkpoint artifacts)"),
    "serving_spec_ragged": (False, "A7 (speculation)"),
    "speculation_length": (0, "A7 (speculation)"),
    "enable_fused_speculation": (False, "A7 (speculation)"),
    "lora_config": (None, "A9 (LoRA and other model families)"),
    "sliding_window": (None, "A9 (sliding-window attention)"),
    "attention_chunk_size": (None, "A9 (chunked attention)"),
}


@dataclass
class Config:
    """Flat runtime config of the port (counterpart of ``TpuConfig``)."""

    # --- core shapes -----------------------------------------------------
    batch_size: int = 1
    max_batch_size: Optional[int] = None
    ctx_batch_size: Optional[int] = None
    tkg_batch_size: Optional[int] = None
    seq_len: int = 128
    max_context_length: Optional[int] = None
    max_length: Optional[int] = None

    # --- dtypes ----------------------------------------------------------
    dtype: str = "bfloat16"
    cast_logits_fp32: bool = True
    attention_softmax_fp32: bool = True

    # --- bucketing -------------------------------------------------------
    enable_bucketing: bool = True
    context_encoding_buckets: Optional[List[int]] = None
    token_generation_buckets: Optional[List[int]] = None

    # --- batching / sampling ---------------------------------------------
    padding_side: str = "right"
    on_device_sampling_config: Optional[OnDeviceSamplingConfig] = None
    max_topk: int = 256
    output_logits: bool = False

    # --- KV cache / attention ---------------------------------------------
    kv_cache_dtype: Optional[str] = None
    fused_qkv: bool = False
    # kernel tri-states: None and True both mean "the CUDA kernel on CUDA
    # tensors"; False means the plain PyTorch path. The TPU's shape guards
    # (seq % 128, kv_width >= 512, on_tpu) are Mosaic tile rules and do not
    # carry over: the Hopper kernels mask their ragged edges themselves.
    attn_kernel_enabled: Optional[bool] = None
    attn_block_tkg_kernel_enabled: Optional[bool] = None
    # fused decode-layer kernels (ops/decode_block.py): the attention block
    # B8 (rmsnorm + fused QKV + RoPE + attention + o-proj + residual; needs
    # fused_qkv) and the gated-MLP block B9. Unlike the tri-states above,
    # None means off, as in the reference: only True takes the kernels.
    fused_attn_block_kernel_enabled: Optional[bool] = None
    fused_mlp_kernel_enabled: Optional[bool] = None

    # --- quantization (reference config.py:489-505) -----------------------
    quantized: bool = False
    quantization_type: str = "per_channel_symmetric"  # or per_tensor_symmetric, blockwise
    quantization_dtype: str = "int8"  # or fp8, float8_e4m3, float8_e5m2
    modules_to_not_convert: Optional[List[str]] = None
    # input-axis block size for quantization_type="blockwise"
    blockwise_matmul_block_size: int = 128
    # decode weight-storage dtype: "bfloat16" keeps weights in the compute
    # dtype; "int8" is an alias of quantized=True (per-channel int8); "int4"
    # packs grouped codes at load, streamed by the B6 fused-dequant kernel
    weight_dtype: str = "bfloat16"

    # --- serving: paged cache, continuous batching ------------------------
    is_continuous_batching: bool = False
    is_block_kv_layout: bool = False  # paged KV cache
    pa_num_blocks: Optional[int] = None
    pa_block_size: int = 16
    # size the block pool by bytes instead of a count: the application
    # derives pa_num_blocks = pa_pool_bytes // the per-block cost in the
    # cache dtype (block_kvcache.kv_block_bytes)
    pa_pool_bytes: Optional[int] = None
    is_prefix_caching: bool = False
    is_chunked_prefill: bool = False
    chunked_prefill_config: Optional[ChunkedPrefillConfig] = None
    kv_cache_batch_size: Optional[int] = None
    # ragged mixed step: one dispatch per step() packs prefill chunks and
    # decode rows (runtime/serving.py::_ragged_step); its 1-ahead pipelining
    # follows async_mode when serving_ragged_async is None
    serving_ragged: bool = False
    serving_ragged_async: Optional[bool] = None

    # --- serving fault containment (runtime/serving.py, runtime/faults.py)
    # malformed requests get a typed terminal REJECTED verdict at admission
    admission_validation: bool = True
    # wall-clock TTL per request in seconds (None = no deadline)
    request_deadline_s: Optional[float] = None
    # transient dispatch errors retry with capped backoff this many times
    dispatch_max_retries: int = 2
    # consecutive zero-progress steps before the watchdog preempts (0 = off)
    watchdog_no_progress_steps: int = 256

    # --- not ported yet (validated, then refused) --------------------------
    tp_degree: int = 1
    ep_degree: int = 1
    quantized_checkpoints_path: Optional[str] = None
    serving_spec_ragged: bool = False
    speculation_length: int = 0
    enable_fused_speculation: bool = False
    lora_config: Optional[Any] = None
    sliding_window: Optional[int] = None
    attention_chunk_size: Optional[int] = None

    # --- misc ------------------------------------------------------------
    # seal the warmed programs after warmup(): a later graph capture raises
    # RetraceError (analysis/retrace_guard.py). Env override:
    # NXDI_TPU_RETRACE_GUARD=1.
    retrace_guard: bool = False
    # one captured CUDA graph per runner key, replayed (runtime/graphs.py);
    # False runs the same programs eagerly on a card
    cuda_graphs: bool = True
    seed: int = 0
    # True: generate() chains prefill -> decode chunks with device-resident
    # tokens and fetches once at the end; False: synchronize at every chunk
    async_mode: bool = True
    device: str = "cuda"

    def __post_init__(self):
        if self.max_batch_size is None:
            self.max_batch_size = self.batch_size
        if self.ctx_batch_size is None:
            self.ctx_batch_size = self.max_batch_size
        if self.tkg_batch_size is None:
            self.tkg_batch_size = self.max_batch_size
        if self.max_context_length is None:
            self.max_context_length = self.seq_len
        if self.max_length is None:
            self.max_length = self.seq_len
        if self.weight_dtype == "bf16":
            self.weight_dtype = "bfloat16"
        if self.weight_dtype == "int8" and not self.quantized:
            # the weight_dtype spelling of int8 is an alias of the
            # quantize-at-load path (reference config.py:573-577)
            self.quantized = True
        if isinstance(self.on_device_sampling_config, dict):
            self.on_device_sampling_config = OnDeviceSamplingConfig(
                **self.on_device_sampling_config
            )
        if isinstance(self.chunked_prefill_config, dict):
            self.chunked_prefill_config = ChunkedPrefillConfig(**self.chunked_prefill_config)
        self.validate()

    @property
    def torch_dtype(self) -> torch.dtype:
        return to_dtype(self.dtype)

    @property
    def kv_dtype(self) -> torch.dtype:
        return to_dtype(self.kv_cache_dtype) if self.kv_cache_dtype else self.torch_dtype

    @property
    def weight_int4(self) -> bool:
        """True when weights pack to grouped int4 at load (ops/quant_matmul)."""
        return self.weight_dtype == "int4"

    def validate(self):
        """The reference's checks for the kept fields, then the refusals,
        then the device (``cuda`` without a card raises RuntimeError)."""
        to_dtype(self.dtype)
        if self.kv_cache_dtype is not None and self.kv_cache_dtype not in KV_CACHE_DTYPES:
            raise ValueError(
                f"unknown kv_cache_dtype {self.kv_cache_dtype!r}; supported: "
                f"{KV_CACHE_DTYPES} (int8/fp8 build the quantized cache)"
            )
        if self.padding_side not in ("right", "left"):
            raise ValueError("padding_side must be 'right' or 'left'")
        self._validate_quantization()
        if self.batch_size < 1 or self.seq_len < 1:
            raise ValueError("batch_size and seq_len must be >= 1")
        self._validate_serving()
        for name, (inert, item) in _NOT_PORTED.items():
            if getattr(self, name) != inert:
                raise NotImplementedError(
                    f"Config.{name}={getattr(self, name)!r} is not ported to "
                    f"PyTorch yet (ROADMAP {item})"
                )
        if self.kv_cache_dtype in KV_QUANT_DTYPE_NAMES:
            raise NotImplementedError(
                f"kv_cache_dtype={self.kv_cache_dtype!r} (quantized KV cache) is "
                "not ported to PyTorch yet (ROADMAP A6 (quantization), kernel "
                "B1 int8/fp8 mode)"
            )
        resolve_device(self.device)

    def _validate_quantization(self):
        """The reference's weight-quantization checks (config.py:811-835)."""
        if self.quantization_type not in (
            "per_channel_symmetric",
            "per_tensor_symmetric",
            "blockwise",
        ):
            raise ValueError(f"unknown quantization_type {self.quantization_type}")
        if self.weight_dtype not in ("bfloat16", "int8", "int4"):
            raise ValueError(
                f"unknown weight_dtype {self.weight_dtype!r}; supported: "
                "bfloat16 (no conversion), int8 (per-channel quantize-at-"
                "load), int4 (grouped fused-dequant streaming)"
            )
        if self.weight_dtype == "int4" and self.quantized:
            raise ValueError(
                "weight_dtype='int4' and quantized=True are two different "
                "weight-conversion recipes applied to the same leaves; "
                "pick one (int8 via weight_dtype='int8' IS quantized=True)"
            )

    def _validate_serving(self):
        """The reference's serving checks (config.py:614-635, 720-759,
        789-796), in its order, then its default pool size."""
        if self.pa_pool_bytes is not None:
            if not self.is_block_kv_layout:
                raise ValueError("pa_pool_bytes requires is_block_kv_layout")
            if self.pa_num_blocks is not None:
                raise ValueError(
                    "set pa_num_blocks OR pa_pool_bytes, not both (the pool "
                    "byte budget derives the block count from the cache dtype)"
                )
        if self.request_deadline_s is not None and not self.request_deadline_s > 0:
            raise ValueError(
                "request_deadline_s must be > 0 seconds (None disables "
                "per-request deadlines)"
            )
        if self.dispatch_max_retries < 0:
            raise ValueError(
                "dispatch_max_retries must be >= 0 (0 = fail in-flight rows "
                "on the first transient dispatch error)"
            )
        if self.watchdog_no_progress_steps < 0:
            raise ValueError(
                "watchdog_no_progress_steps must be >= 0 (0 disables the "
                "no-progress watchdog)"
            )
        if self.is_chunked_prefill and not self.is_block_kv_layout:
            raise ValueError("chunked prefill requires block KV layout")
        if self.is_chunked_prefill and self.chunked_prefill_config is None:
            self.chunked_prefill_config = ChunkedPrefillConfig()
        if self.is_chunked_prefill and not self.is_continuous_batching:
            raise ValueError("chunked prefill runs through the serving session: "
                             "set is_continuous_batching=True")
        if self.is_prefix_caching and not self.is_block_kv_layout:
            raise ValueError("prefix caching requires block KV layout")
        if self.serving_ragged:
            if not self.is_block_kv_layout:
                raise ValueError(
                    "serving_ragged requires the paged cache "
                    "(is_block_kv_layout=True): the ragged kernel addresses "
                    "rows through block tables"
                )
            if not self.is_continuous_batching:
                raise ValueError(
                    "serving_ragged runs through the serving session: set "
                    "is_continuous_batching=True"
                )
            if self.sliding_window or self.attention_chunk_size:
                raise NotImplementedError(
                    "serving_ragged implements the plain causal+prefix mask "
                    "only (no sliding-window/chunked attention)"
                )
        if self.serving_ragged_async and not self.serving_ragged:
            raise ValueError(
                "serving_ragged_async=True pipelines the RAGGED mixed-step "
                "dispatch: set serving_ragged=True (the legacy split path "
                "already pipelines via async_mode)"
            )
        if (
            self.is_block_kv_layout
            and self.pa_num_blocks is None
            and self.pa_pool_bytes is None
        ):
            self.pa_num_blocks = max(
                1, (self.max_batch_size * self.seq_len + self.pa_block_size - 1) // self.pa_block_size
            )


@dataclass
class MoEConfig(Config):
    """MoE extras (counterpart of the reference's ``MoETpuConfig``,
    ``config.py:909-969``): the same names, defaults and validation, less
    its ``normalize_top_k_affinities``, which nothing reads (the models
    read ``norm_topk_prob``). ``moe_fused_kernel_enabled`` follows the
    port's tri-state: None and True send decode-sized calls to the B7
    kernel (``ops/moe_decode.py``), False to the dense all-experts route."""

    capacity_factor: Optional[float] = None  # None = dropless
    glu_mlp: bool = True
    glu_type: str = "glu"
    hidden_act_scaling_factor: float = 1.0
    hidden_act_bias: float = 0.0
    early_expert_affinity_modulation: bool = False
    fused_shared_experts: bool = False
    router_dtype: str = "float32"
    moe_fused_kernel_enabled: Optional[bool] = None
    hybrid_sharding_config: Optional[dict] = None

    def validate(self):
        super().validate()
        if not self.glu_mlp or self.glu_type != "glu":
            raise NotImplementedError(
                "non-GLU expert MLPs are not implemented (experts are "
                "gate/up/down GLU, modules/moe.py)"
            )
        to_dtype(self.router_dtype)
        if self.hybrid_sharding_config is not None:
            raise NotImplementedError(
                "hybrid_sharding_config (per-phase expert sharding) is not "
                "ported to PyTorch yet (ROADMAP A10 (parallelism))"
            )
        if self.fused_shared_experts:
            raise NotImplementedError(
                "fused_shared_experts (shared experts) is not ported to "
                "PyTorch yet (ROADMAP A9 (shared experts))"
            )


class InferenceConfig:
    """Config plus HF model attributes (counterpart of the reference's
    ``InferenceConfig``). ``load_config`` is a callable that sets the HF
    attributes on the instance, as in the reference."""

    _REQUIRED_ATTRS: Tuple[str, ...] = ()

    def __init__(self, torch_config: Config, load_config=None, **kwargs):
        self.torch_config = torch_config
        if load_config is not None:
            load_config(self)
        for k, v in kwargs.items():
            setattr(self, k, v)
        missing = [a for a in self._REQUIRED_ATTRS if not hasattr(self, a)]
        if missing:
            raise ValueError(f"Config missing required attributes: {missing}")
