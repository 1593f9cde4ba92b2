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

import dataclasses
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
    "int8": torch.int8,
    "fp8": torch.float8_e4m3fn,
    "float8_e4m3": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}

#: accepted kv_cache_dtype names (reference KV_CACHE_DTYPES); the quantized
#: ones build QuantizedKV streams of codes and per-(layer, head) scales
#: (modules/kvcache.py)
KV_CACHE_DTYPES = (
    "bfloat16", "bf16", "float16", "fp16", "float32", "fp32",
    "int8", "fp8", "float8_e4m3", "float8_e5m2",
)
KV_QUANT_DTYPE_NAMES = ("int8", "fp8", "float8_e4m3", "float8_e5m2")

#: multi-replica router placement policies (runtime/router.py consumes this
#: tuple; it lives here so validation needs no runtime import)
ROUTER_POLICIES = ("round_robin", "least_loaded", "cache_aware")


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
class FusedSpecConfig:
    """Fused speculation: draft + target in one program per phase
    (reference FusedSpecConfig); ``draft_config`` is the draft's
    :class:`InferenceConfig`, set as ``config.fused_spec_config`` on the
    target's (``runtime/fused_spec.py``)."""

    draft_config: Optional["InferenceConfig"] = None


@dataclass
class ChunkedPrefillConfig:
    """Chunked prefill settings (reference ChunkedPrefillConfig): up to
    ``max_num_seqs`` requests advance by ``kernel_q_tile_size`` prompt
    tokens per serving step."""

    max_num_seqs: int = 8
    kernel_q_tile_size: int = 128


#: the gated MLP's projections: LoRA targets the port refuses (no MLP of
#: the reference applies an adapter attached to them)
LORA_MLP_MODULES = ("gate_proj", "up_proj", "down_proj")


@dataclass
class LoraServingConfig:
    """Multi-adapter LoRA serving (reference LoraServingConfig;
    ``modules/lora.py``). ``max_loras`` device slots (slot 0 is the zero
    adapter besides them), ranks up to ``max_lora_rank``; the dynamic cache
    keeps ``max_loras_on_cpu`` adapters on the host beyond the resident
    ones. Adapters are stored in ``Config.dtype``, as in the reference,
    which reads its ``lora_dtype`` nowhere: the port keeps the name and
    refuses any value but its default or ``Config.dtype``. The reference's
    ``lora_ckpt_paths`` (read only by its demo CLI) has no counterpart:
    adapters are given to ``load_lora_adapters``."""

    max_loras: int = 1
    max_lora_rank: int = 16
    max_loras_on_cpu: int = 2
    lora_dtype: str = "bfloat16"
    target_modules: Tuple[str, ...] = ("q_proj", "k_proj", "v_proj", "o_proj")

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["target_modules"] = list(self.target_modules)
        return d

    @classmethod
    def from_dict(cls, d):
        d = dict(d)
        unknown = sorted(set(d) - {f.name for f in dataclasses.fields(cls)})
        if unknown:
            raise ValueError(f"Unknown {cls.__name__} key(s): {unknown}")
        if "target_modules" in d:
            d["target_modules"] = tuple(d["target_modules"])
        return cls(**d)


#: settings outside the ported slice -> (inert value, ROADMAP item)
_NOT_PORTED: Dict[str, Tuple[Any, str]] = {
    "tp_degree": (1, "A10 (parallelism)"),
    "ep_degree": (1, "A10 (parallelism: expert parallelism)"),
    "quantized_checkpoints_path": (None, "A11 (quantized checkpoint artifacts)"),
}

#: the reference's role flags that it accepts for API parity and refuses
#: (its ``UNIMPLEMENTED_FLAGS``) -> (inert value, its reason)
_UNIMPLEMENTED_FLAGS: Dict[str, Tuple[Any, str]] = {
    name: (
        False,
        "per-submodel role flags are internal to the reference's config "
        "specialization; use runtime/fused_spec.EagleSpecModelForCausalLM",
    )
    for name in ("is_eagle_target", "is_eagle_draft")
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
    # speculation inside the ragged mixed step (SpeculativeServingSession):
    # spec-verify rows of up to speculation_length tokens ride the mixed
    # dispatch (the mixed_step_spec family); needs serving_ragged + chunked
    # prefill + 2 <= speculation_length <= 16, greedy
    serving_spec_ragged: bool = False

    # --- speculation -----------------------------------------------------
    # draft length + 1: tokens a verify pass checks (assisted_generate, the
    # speculative session, fused speculation)
    speculation_length: int = 0
    # draft + target in one program per phase (runtime/fused_spec.py); the
    # draft's config rides as InferenceConfig.fused_spec_config
    enable_fused_speculation: bool = False
    # EAGLE: a feature-level draft chained with the target's hidden states
    # (runtime/fused_spec.EagleSpecModelForCausalLM); the draft's embedding
    # takes an rms norm first with enable_eagle_draft_input_norm
    enable_eagle_speculation: bool = False
    enable_eagle_draft_input_norm: bool = False
    # EAGLE3: the target's three-layer hidden capture and the fused 2H-qkv
    # draft layer (modules/eagle.py)
    is_eagle3: bool = False
    # the reference's role flags, refused as it refuses them
    is_eagle_target: bool = False
    is_eagle_draft: bool = False
    # Medusa (runtime/medusa.py): verify length and prediction heads
    medusa_speculation_length: int = 0
    num_medusa_heads: int = 0
    # a static token tree ({node: [children]}) or a dynamic one ({"step",
    # "branching_factor", "num_inputs"}) of EAGLE drafts (modules/token_tree.py)
    token_tree_config: Optional[dict] = None

    # --- serving fault containment (runtime/serving.py, runtime/faults.py)
    # malformed requests get a typed terminal REJECTED verdict at admission
    admission_validation: bool = True
    # wall-clock TTL per request in seconds (None = no deadline)
    request_deadline_s: Optional[float] = None
    # transient dispatch errors retry with capped backoff this many times
    dispatch_max_retries: int = 2
    # consecutive zero-progress steps before the watchdog preempts (0 = off)
    watchdog_no_progress_steps: int = 256

    # --- multi-replica serving (runtime/router.py, runtime/replica.py) -----
    # replica sessions a ServingRouter serves over (1 = no router layer) and
    # the placement policy binding requests to them (ROUTER_POLICIES)
    serving_replicas: int = 1
    router_policy: str = "least_loaded"
    # disaggregated prefill tier: this many of serving_replicas are carved
    # out as prefill-only replicas that context-encode and hand the KV line
    # over to a decode replica (runtime/disaggregated.py); contiguous cache
    router_prefill_replicas: int = 0
    # a hand-off attempt failing in transit retries this many times with
    # capped backoff; handoff_timeout_s bounds one attempt (None = no bound)
    handoff_max_retries: int = 2
    handoff_timeout_s: Optional[float] = None
    # step every replica from its own persistent worker thread behind a
    # per-step barrier (ServingRouter's thread-per-replica pool)
    router_threading: bool = False
    # disaggregated stage of this app: True warms the context-encoding
    # runner only, False the token-generation runner only, None both
    is_prefill_stage: Optional[bool] = None

    # --- attention flavor ---------------------------------------------------
    # sliding-window attention for every layer (a model's own HF
    # sliding_window, Mistral's, takes its place when this is None): the
    # contiguous cache becomes a ring of W slots where the layout allows it
    # (models/builder.ring_layout_ok), else windowed masks over full lines
    sliding_window: Optional[int] = None
    # chunked attention (Llama4's flavor): a query attends causally within
    # its own block of this many positions; the cache keeps full lines
    attention_chunk_size: Optional[int] = None

    # --- LoRA (modules/lora.py); a dict is read by LoraServingConfig.from_dict
    lora_config: Optional[LoraServingConfig] = None

    # --- not ported yet (validated, then refused) --------------------------
    tp_degree: int = 1
    ep_degree: int = 1
    quantized_checkpoints_path: Optional[str] = None

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
        if isinstance(self.lora_config, dict):
            self.lora_config = LoraServingConfig.from_dict(self.lora_config)
        self.validate()

    @property
    def torch_dtype(self) -> torch.dtype:
        return to_dtype(self.dtype)

    @property
    def kv_dtype(self) -> torch.dtype:
        return to_dtype(self.kv_cache_dtype) if self.kv_cache_dtype else self.torch_dtype

    @property
    def kv_quantized(self) -> bool:
        """True when the KV cache stores int8/fp8 codes + scales."""
        return self.kv_cache_dtype in KV_QUANT_DTYPE_NAMES

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
        self._validate_speculation()
        self._validate_lora()
        for name, (inert, item) in _NOT_PORTED.items():
            if getattr(self, name) != inert:
                raise NotImplementedError(
                    f"Config.{name}={getattr(self, name)!r} is not ported to "
                    f"PyTorch yet (ROADMAP {item})"
                )
        for name, (inert, reason) in _UNIMPLEMENTED_FLAGS.items():
            if getattr(self, name) != inert:
                raise NotImplementedError(
                    f"Config.{name} is accepted for reference API parity but not "
                    f"implemented yet ({reason}); refusing to silently ignore it"
                )
        resolve_device(self.device)

    def _validate_lora(self):
        """The reference's refusal of fused_qkv with LoRA (config.py:856-858),
        word for word, then the port's of MLP targets (the reference
        attaches them and no MLP applies them) and of a ``lora_dtype`` that
        would be ignored (adapters are stored in ``dtype``)."""
        if self.lora_config is None:
            return
        if self.fused_qkv:
            raise NotImplementedError(
                "fused_qkv with LoRA serving is not supported: adapters "
                "target q/k/v projections individually"
            )
        mlp = [m for m in self.lora_config.target_modules if m in LORA_MLP_MODULES]
        if mlp:
            raise NotImplementedError(
                f"LoRA target_modules {mlp}: no MLP applies an adapter in the reference, which "
                "attaches them and serves the base MLP; refused, not skipped (ROADMAP C (LoRA on "
                "MLP modules))"
            )
        lora_dtype = self.lora_config.lora_dtype
        default = LoraServingConfig.lora_dtype
        if to_dtype(lora_dtype) not in (to_dtype(default), to_dtype(self.dtype)):
            raise NotImplementedError(
                f"LoraServingConfig.lora_dtype={lora_dtype!r}: adapters are stored in "
                f"Config.dtype ({self.dtype!r}) as in the reference, which reads lora_dtype "
                "nowhere; refused, not ignored (ROADMAP C (LoraServingConfig.lora_dtype))"
            )

    def _validate_speculation(self):
        """The reference's cross-checks of the EAGLE, token-tree and Medusa
        fields (config.py:797-808)."""
        if self.enable_eagle_speculation and not self.enable_fused_speculation:
            raise ValueError("EAGLE speculation requires fused speculation")
        if self.is_eagle3 and not self.enable_eagle_speculation:
            raise ValueError("is_eagle3 requires enable_eagle_speculation")
        if self.token_tree_config is not None and not self.enable_eagle_speculation:
            raise ValueError(
                "token_tree_config requires enable_eagle_speculation "
                "(trees expand the EAGLE draft; reference eagle/token_tree.py)"
            )
        if self.medusa_speculation_length and self.num_medusa_heads <= 0:
            raise ValueError("medusa requires num_medusa_heads > 0")

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

    def _validate_router(self):
        """The reference's multi-replica checks (config.py:637-680), with
        its messages, in its order."""
        if self.serving_replicas < 1:
            raise ValueError(
                "serving_replicas must be >= 1 (1 = a single session, no "
                "router layer)"
            )
        if self.router_policy not in ROUTER_POLICIES:
            raise ValueError(
                f"unknown router_policy {self.router_policy!r}; known "
                f"placement policies: {ROUTER_POLICIES}"
            )
        if self.serving_replicas > 1 and not self.is_continuous_batching:
            raise ValueError(
                "serving_replicas > 1 routes over serving sessions: set "
                "is_continuous_batching=True"
            )
        if self.router_prefill_replicas < 0:
            raise ValueError(
                "router_prefill_replicas must be >= 0 (0 = no disaggregated "
                "prefill tier; every replica prefills locally)"
            )
        if self.router_prefill_replicas > 0:
            if self.router_prefill_replicas >= self.serving_replicas:
                raise ValueError(
                    "router_prefill_replicas is carved OUT OF "
                    "serving_replicas: at least one decode replica must "
                    f"remain ({self.router_prefill_replicas} prefill of "
                    f"{self.serving_replicas} total leaves none)"
                )
            if self.is_block_kv_layout:
                raise ValueError(
                    "the disaggregated prefill tier hands KV over into "
                    "contiguous cache lines: router_prefill_replicas > 0 "
                    "does not support is_block_kv_layout (decode replicas "
                    "need the plain contiguous cache)"
                )
        if self.handoff_max_retries < 0:
            raise ValueError(
                "handoff_max_retries must be >= 0 (0 = a hand-off fails its "
                "in-flight request on the first transient failure)"
            )
        if self.handoff_timeout_s is not None and not self.handoff_timeout_s > 0:
            raise ValueError(
                "handoff_timeout_s must be > 0 seconds (None disables the "
                "per-attempt hand-off timeout)"
            )

    def _validate_serving(self):
        """The reference's serving checks (config.py:614-680, 720-759,
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
        self._validate_router()
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
        if self.serving_spec_ragged:
            if not self.serving_ragged:
                raise ValueError(
                    "serving_spec_ragged packs spec-verify rows into the "
                    "ragged mixed step: set serving_ragged=True (paged "
                    "cache + continuous batching)"
                )
            if not self.is_chunked_prefill:
                raise ValueError(
                    "serving_spec_ragged requires is_chunked_prefill=True: "
                    "prompt chunks must ride the same mixed dispatch as the "
                    "spec-verify rows (one program identity per step)"
                )
            # 16 == ops/ragged_paged_attention.RAGGED_Q_TILE (kept literal:
            # config validation must not import kernel modules)
            if not 2 <= self.speculation_length <= 16:
                raise ValueError(
                    "serving_spec_ragged needs 2 <= speculation_length <= "
                    "16: a spec-verify segment (last token + drafts) must "
                    "fit one ragged q tile"
                )
            ods = self.on_device_sampling_config
            if ods is not None and getattr(ods, "do_sample", False):
                raise NotImplementedError(
                    "serving_spec_ragged is greedy-only: the packed verify "
                    "computes contiguous-match acceptance on device "
                    "(sampled accept/reject stays on the split "
                    "SpeculativeServingSession path)"
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
        # capacity_factor with ep_degree > 1 is refused earlier, with
        # ep_degree itself (ROADMAP A10)
        if self.capacity_factor is not None and self.quantized and self.quantization_type == "blockwise":
            raise NotImplementedError(
                "capacity_factor with blockwise-quantized experts is not "
                "implemented"
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
        self.add_derived_config()
        missing = [a for a in self._REQUIRED_ATTRS if not hasattr(self, a)]
        if missing:
            raise ValueError(f"Config missing required attributes: {missing}")

    def add_derived_config(self):
        """Hook for model plugins to derive attributes (DBRX flattens its
        nested configs, DeepSeek-V3 sets the rope dimension)."""
