"""Application layer: load / warmup / forward / generate (counterpart of
the reference's ``runtime/application.py``).

:class:`ModelForCausalLM` is the port's ``TpuModelForCausalLM`` for every
registered builder (the llama family, the MoE family, GPT-OSS, DBRX and
DeepSeek-V3, whose MLA layers the runners take from the builder's
``layer_fn()``): one
context-encoding runner and one token-generation runner over a KV cache on
the config's device (``"cuda"`` unless the caller asks for the CPU). The
cache is contiguous, or the paged block pool with ``is_block_kv_layout``.
With ``serving_ragged`` it also carries ``mixed_step_model``, the ragged
mixed-step runner the serving session dispatches once per step (its
speculative-verification family with ``serving_spec_ragged``).
``generate`` keeps the reference's host loop over the contiguous cache: one
prefill (in windows when the prompt is longer than ``max_context_length``
or than a ring cache's window),
then decode chunks sized by :func:`_pick_chunk`, with tokens kept on the
device and fetched once at the end when no EOS is given, and fetched once
per chunk to test for EOS otherwise. The paged cache is driven through
``runtime/serving.py::ServingSession`` or :meth:`ModelForCausalLM.forward`.

``load()`` gives the runners one :class:`~.graphs.GraphSet`: each runner
key's program is captured as a CUDA graph at first use (``warmup()``
captures every bucket) and replayed after; ``cuda_graphs=False`` runs them
eagerly. Sampling (``do_sample``) draws from the app's ``torch.Generator``,
seeded from ``Config.seed`` and advanced once per ``generate()`` call.

Multi-adapter LoRA (``lora_config``; ``modules/lora.py``):
:meth:`ModelForCausalLM.load_lora_adapters` attaches adapter slots to the
loaded params (static, or the dynamic host cache), and ``generate(...,
lora_adapter_names=[...])`` serves one adapter (or None, the base model) a
row. A step with adapter ids is a runner key of its own. Attaching changes
the programs the params define, so it drops every graph captured before
it, and refuses once the runners are sealed; a dynamic swap writes slots in
place and keeps every graph valid. The serving sessions and speculation
take no adapter ids, as in the reference: on a LoRA app they serve the base
model.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np
import torch

from neuronx_distributed_inference_tpu_torch.config import InferenceConfig, to_dtype
from neuronx_distributed_inference_tpu_torch.models import get_model_builder
from neuronx_distributed_inference_tpu_torch.models.base import (
    PHASE_CONTEXT_ENCODING,
    PHASE_TOKEN_GENERATION,
    prepare_params,
)
from neuronx_distributed_inference_tpu_torch.modules import autobucketing
from neuronx_distributed_inference_tpu_torch.analysis.retrace_guard import guard_enabled
from neuronx_distributed_inference_tpu_torch.modules.block_kvcache import BlockKVCache
from neuronx_distributed_inference_tpu_torch.modules.lora import (
    DynamicLoraManager,
    LoraWeightManager,
    attach_lora_params,
)
from neuronx_distributed_inference_tpu_torch.modules.kvcache import (
    PAD_POSITION_SENTINEL,
    KVCache,
    cache_nbytes,
    cache_streams,
    zero_stream,
)
from neuronx_distributed_inference_tpu_torch.modules.sampling import (
    prepare_sampling_params,
    validate_sampling_params,
)
from neuronx_distributed_inference_tpu_torch.ops.quant import prepare_int4_params, prepare_quantized_params
from neuronx_distributed_inference_tpu_torch.runtime.graphs import GraphSet
from neuronx_distributed_inference_tpu_torch.runtime.model_runner import (
    TAG_CONTEXT_ENCODING,
    TAG_TOKEN_GENERATION,
    MixedStepRunner,
    SubModelRunner,
)

# decode steps per host round trip when an EOS is given
_EOS_CHUNK = 8


def _pick_chunk(remaining: int, has_eos: bool, headroom: int) -> int:
    """Decode-chunk size (device steps) for the host loop (the reference's
    rule, kept so both packages run the same steps). Without an EOS the
    whole remaining budget runs as one chunk rounded up to a power of two
    (surplus steps are computed and discarded); with one, fixed
    ``_EOS_CHUNK`` chunks. Near the end of the cache window the chunk
    shrinks to the largest power of two that fits."""
    if not has_eos:
        chunk = 8
        while chunk < remaining:
            chunk *= 2
    else:
        chunk = _EOS_CHUNK
    if chunk > headroom:
        chunk = 1
        while chunk * 2 <= headroom:
            chunk *= 2
    return chunk


@dataclass
class GenerationOutput:
    sequences: np.ndarray  # (B, S_in + new)
    logits: Optional[np.ndarray] = None  # (B, new, V) when output_logits
    num_generated: int = 0


class ModelForCausalLM:
    """The causal-LM application (counterpart of ``TpuModelForCausalLM``)."""

    def __init__(self, model_path: Optional[str], config: InferenceConfig):
        self.model_path = model_path
        self.config = config
        tc = config.torch_config
        self.builder = get_model_builder(getattr(config, "model_type", "llama"))(config)
        self.spec = self.builder.model_spec()
        self.device = self.builder.device
        self.params = None
        self.kv_cache: Optional[Union[KVCache, BlockKVCache]] = None
        mlp_fn = self.builder.mlp_fn()
        layer_fn = self.builder.layer_fn()
        tkg_buckets = autobucketing.generate_token_generation_buckets(tc)
        if self.spec.bounded_window:
            # ring cache: one decode shape, the W-slot window
            tkg_buckets = [self.spec.bounded_window]
        if tc.is_block_kv_layout:
            # block-table reads need bucket % block_size == 0
            tkg_buckets = sorted(
                {autobucketing.round_up(b, tc.pa_block_size) for b in tkg_buckets}
            )
        block_kwargs = dict(
            block_kv=tc.is_block_kv_layout, block_size=tc.pa_block_size,
            host_read_tokens=self.builder.host_read_tokens(), layer_fn=layer_fn,
        )
        self.context_encoding_model = SubModelRunner(
            TAG_CONTEXT_ENCODING, PHASE_CONTEXT_ENCODING, self.spec,
            autobucketing.generate_context_encoding_buckets(tc),
            tc.ctx_batch_size, self.device, mlp_fn, **block_kwargs,
        )
        self.token_generation_model = SubModelRunner(
            TAG_TOKEN_GENERATION, PHASE_TOKEN_GENERATION, self.spec,
            tkg_buckets, tc.tkg_batch_size, self.device, mlp_fn, **block_kwargs,
        )
        self.runners = [self.context_encoding_model, self.token_generation_model]
        # ragged mixed-step family (serving_ragged): ONE dispatch per serving
        # step covers prefill chunks AND decode rows; its bucket axis is the
        # TOTAL packed query-token count, not a per-phase shape
        self.mixed_step_model = None
        if tc.serving_ragged:
            from neuronx_distributed_inference_tpu_torch.ops.ragged_paged_attention import RAGGED_Q_TILE

            cpc = tc.chunked_prefill_config
            chunk = cpc.kernel_q_tile_size if cpc else 128
            max_seqs = cpc.max_num_seqs if cpc else 8
            num_rows = tc.kv_cache_batch_size or tc.max_batch_size
            # worst-case packed step: max_seqs tile-aligned prefill chunks
            # plus every slot decoding (one q tile each)
            top = autobucketing.round_up(chunk, RAGGED_Q_TILE) * max_seqs + num_rows * RAGGED_Q_TILE
            mixed_buckets = []
            b = RAGGED_Q_TILE
            while b < top:
                mixed_buckets.append(b)
                b *= 2
            mixed_buckets.append(b)
            # serving_spec_ragged builds the spec-verify family: a spec row
            # packs up to speculation_length tokens, still one q tile
            # (validated), so the bucket ladder is the same
            self.mixed_step_model = MixedStepRunner(
                self.spec, mixed_buckets, num_rows, self.device, mlp_fn, tc.pa_block_size, tkg_buckets,
                spec_width=tc.speculation_length if tc.serving_spec_ragged else 1,
                host_read_tokens=self.builder.host_read_tokens(),
            )
        # the programs' CUDA graphs (bound at load) and the sampler's
        # generator, reseeded once per generate() call (_advance_rng)
        self.graphs: Optional[GraphSet] = None
        self._rng = torch.Generator(device=self.device)
        self._rng_calls = 0
        self.lora_manager: Optional[LoraWeightManager] = None

    # ---- weights / cache -------------------------------------------------

    def load(self, model_path: Optional[str] = None, state_dict=None, random_weights=False, params=None):
        """Put weights on the device and allocate the KV cache.

        ``state_dict``: an HF-layout state dict (numpy or torch leaves);
        ``random_weights``: seeded random weights made on the device. Both
        quantize at load, on the device, when the config asks for it
        (``quantized`` / ``weight_dtype``), as the reference's load does.
        ``params``: ready params in the port's layout, taken as they are,
        quantized or not (for example from ``models.builder.params_from_jax``
        or another app's ``params``)."""
        if params is None:
            tc = self.config.torch_config
            if random_weights:
                params = self.builder.random_params()
            elif state_dict is not None:
                params = self.builder.convert_hf_state_dict(state_dict)
            else:
                raise NotImplementedError(
                    "loading a checkpoint from a path is not ported to PyTorch yet "
                    "(ROADMAP A11); pass state_dict=, params= or random_weights=True"
                )
            if tc.quantized:
                params = prepare_quantized_params(params, tc)
            elif tc.weight_int4:
                params = prepare_int4_params(params, tc)
        self.params = prepare_params(params)
        self.kv_cache = None
        self.lora_manager = None
        self.init_kv_cache()
        self._new_graphs()
        return self

    def _new_graphs(self):
        """New params, or new programs over them: every runner takes a new
        graph set, so each program is captured anew, and the seal waits for
        the next warmup()."""
        if self.graphs is not None:
            self.graphs.close()
        self.graphs = GraphSet(self.device, self.config.torch_config.cuda_graphs)
        for runner in self._all_runners():
            runner.bind_graphs(self.graphs)

    # ---- LoRA adapters -----------------------------------------------------

    def load_lora_adapters(self, adapters=None, dynamic: bool = False):
        """Attach multi-adapter LoRA weights (the reference's
        ``load_lora_adapters``).

        ``adapters``: {adapter_name: PEFT-format state dict | directory path
        | (state dict, adapter config)}, stored in ``Config.dtype``.
        ``dynamic``: serve MORE adapters than device slots, through a host
        cache with LRU slot eviction (:class:`~..modules.lora.DynamicLoraManager`);
        register more with :meth:`register_lora_adapter` at any time.

        The attach adds leaves to the params the graphs were captured over:
        a graph captured before it would replay the program without them, so
        every graph is dropped (and captured anew at first use), and a
        sealed app refuses."""
        tc = self.config.torch_config
        if tc.lora_config is None:
            raise ValueError("lora_config must be set to serve LoRA adapters")
        if self.params is None:
            raise RuntimeError("call load() before load_lora_adapters()")
        if any(runner.sealed for runner in self._all_runners()):
            raise RuntimeError(
                "load_lora_adapters() on a sealed app: attaching adapters changes the captured "
                "programs; attach them before warmup() and the seal"
            )
        adapters = adapters or {}
        dtype = to_dtype(tc.dtype)
        if dynamic:
            self.lora_manager = DynamicLoraManager(tc.lora_config)
            attach_lora_params(self.params, {}, self.lora_manager, self.spec.num_layers, dtype=dtype, init_all=True)
        else:
            self.lora_manager = LoraWeightManager(tc.lora_config)
            attach_lora_params(self.params, adapters, self.lora_manager, self.spec.num_layers, dtype=dtype)
        self._new_graphs()
        if dynamic:
            for name, value in adapters.items():
                self.register_lora_adapter(name, value)
        return self

    def register_lora_adapter(self, name: str, value):
        """Host-register an adapter for dynamic serving (preprocessed into
        the host cache; written into a device slot on first use)."""
        if not isinstance(self.lora_manager, DynamicLoraManager):
            raise RuntimeError("register_lora_adapter needs load_lora_adapters(dynamic=True)")
        self.lora_manager.register_cpu(name, value, self.params, self.spec.num_layers)
        return self

    def resolve_adapter_ids(self, adapter_names) -> Optional[np.ndarray]:
        """Adapter names (None = the base model) -> slot ids (B,) int32; the
        dynamic cache first writes any missing adapter into a slot, in place."""
        if adapter_names is None:
            return None
        if self.lora_manager is None:
            raise RuntimeError("no LoRA adapters loaded (call load_lora_adapters)")
        if isinstance(self.lora_manager, DynamicLoraManager):
            self.params = self.lora_manager.ensure_on_device(self.params, adapter_names)
        return self.lora_manager.resolve(adapter_names)

    def _all_runners(self):
        return self.runners + ([self.mixed_step_model] if self.mixed_step_model is not None else [])

    def init_kv_cache(self):
        """A zeroed cache: contiguous, or the paged block pool. An existing
        cache is zeroed in place (a quantized one's scales too), so the
        graphs captured against it stay valid."""
        if self.kv_cache is not None:
            for stream in cache_streams(self.kv_cache):
                zero_stream(stream)
            return
        self.kv_cache = self.builder.init_kv_cache()

    @property
    def kv_cache_nbytes(self) -> int:
        """Device bytes of the KV cache: codes plus scales for an int8/fp8
        cache, both stacks of an interleaved one
        (``modules/kvcache.cache_nbytes``)."""
        return cache_nbytes(self.kv_cache)

    def warmup(self):
        """Run, and so capture, every bucket of both runners (the decode
        runner's one-step decode programs too), each chunked/prefix prefill
        pass length (or the prefill window) at the largest bucket, and every
        total-token bucket of the mixed-step runner at its largest kv width.
        Then, under ``retrace_guard`` (or ``NXDI_TPU_RETRACE_GUARD=1``), seal
        the runners: a later new key raises RetraceError. As in the
        reference, a config with multi-token passes stays unsealed (their
        smaller-width programs are built at first use), and so does the
        mixed-step runner (callers that pin zero captures warm their mix and
        seal it).

        A disaggregated stage app (``is_prefill_stage``, the reference's
        rule) warms and seals only its stage's runner: True the
        context-encoding runner, False the token-generation runner (and no
        mixed-step family); None both."""
        tc = self.config.torch_config
        chunk_q = None
        if tc.is_chunked_prefill or tc.is_prefix_caching:
            chunk_q = autobucketing.generate_chunk_q_buckets(tc)
        elif tc.max_context_length < tc.seq_len or self.spec.bounded_window or self.spec.ring_window:
            # windowed prefill passes one window length (at most a ring's W)
            chunk_q = [self._prefill_window()]
        runners = self.runners
        if tc.is_prefill_stage is True:
            runners = [self.context_encoding_model]
        elif tc.is_prefill_stage is False:
            runners = [self.token_generation_model]
        for runner in runners:
            self.kv_cache = runner.warmup(
                self.params, self.kv_cache,
                chunk_q_lens=chunk_q if runner is self.token_generation_model else None,
                generator=self._rng,
            )
        if self.mixed_step_model is not None and tc.is_prefill_stage is None:
            self.kv_cache = self.mixed_step_model.warmup(self.params, self.kv_cache)
        if guard_enabled(tc) and chunk_q is None:
            for runner in runners:
                runner.seal()
        return self

    # ---- one step ----------------------------------------------------------

    def forward(
        self,
        input_ids: np.ndarray,
        position_ids: np.ndarray,
        seq_ids: np.ndarray,
        *,
        attention_mask: Optional[np.ndarray] = None,
        sampling_params: Optional[np.ndarray] = None,
        slot_mapping: Optional[np.ndarray] = None,
        block_table: Optional[np.ndarray] = None,
        phase: Optional[str] = None,
    ):
        """One model pass with caller-provided cache placement: the entry an
        external scheduler drives when it owns the slot and block tables.

        ``seq_ids`` (B,) cache lines (-1 = inactive row). On the paged cache,
        ``slot_mapping`` (B, S) carries a prefill's flat write slots (-1
        drops the write into the garbage block), and a decode step derives
        its slots on the device from ``block_table`` (B, max_blocks); a
        chunked/prefix prefill pass carries both with ``phase="tkg"``.
        ``attention_mask`` (B, width) is the cache occupancy, by default
        everything up to the largest position. ``phase`` "cte"/"tkg" (S > 1
        means "cte" when omitted). Returns (tokens (B, K), logits (B, K, V)
        or None) as numpy; updates the cache in place."""
        input_ids = np.asarray(input_ids)
        position_ids = np.asarray(position_ids)
        seq_ids = np.asarray(seq_ids, np.int32)
        B, S = input_ids.shape
        if phase is None:
            phase = "cte" if S > 1 else "tkg"
        if phase not in ("cte", "tkg"):
            raise ValueError("phase must be 'cte' or 'tkg'")
        runner = self.context_encoding_model if phase == "cte" else self.token_generation_model
        if sampling_params is None:
            sampling_params = prepare_sampling_params(B)
        if attention_mask is None:
            if phase == "cte":
                attention_mask = np.ones_like(input_ids)
            else:
                width = self._decode_bucket(int(position_ids.max()) + 1)
                attention_mask = (
                    np.arange(width)[None, :] <= position_ids.max(axis=1)[:, None]
                ).astype(np.int32)
        inputs, _ = runner.prepare(
            input_ids, np.asarray(attention_mask), position_ids, seq_ids,
            np.asarray(sampling_params, np.float32),
            slot_mapping=slot_mapping, block_table=block_table,
        )
        out = runner(self.params, self.kv_cache, inputs)
        self.kv_cache = out.cache
        tokens = out.tokens[:B].cpu().numpy()
        logits = out.logits[:B].cpu().numpy() if out.logits is not None else None
        return tokens, logits

    def _pos_limit(self) -> int:
        """Largest writable position: a ring cache bounds slots, not
        positions; otherwise the largest decode bucket bounds it."""
        if self.spec.bounded_window:
            return self.config.torch_config.seq_len
        return min(self.config.torch_config.seq_len, self.token_generation_model.buckets[-1])

    def _decode_bucket(self, needed: int) -> int:
        if self.spec.bounded_window:
            return self.spec.bounded_window
        return autobucketing.get_target_bucket(self.token_generation_model.buckets, needed)

    def _prefill_window(self) -> int:
        """The window length of a windowed prefill: the largest context
        bucket, at most a ring's W (ring slots must stay distinct within
        one window)."""
        C = self.context_encoding_model.buckets[-1]
        ring = self.spec.bounded_window or self.spec.ring_window
        return min(C, ring) if ring else C

    def _advance_rng(self):
        """Reseed the sampler's generator for the next generate() call: the
        k-th call of an app draws from seed (Config.seed, k), so successive
        calls draw differently and an app built with the same seed repeats
        them (the reference's per-call key split)."""
        seed = np.random.SeedSequence([self.config.torch_config.seed, self._rng_calls]).generate_state(1)[0]
        self._rng.manual_seed(int(seed))
        self._rng_calls += 1

    def validate_prefill_length(self, S: int) -> bool:
        """The checks every prompt prefill shares (the reference's rule);
        returns True when the prompt prefills in windows."""
        tc = self.config.torch_config
        if S > tc.seq_len:
            raise ValueError(f"prompt length {S} exceeds seq_len {tc.seq_len}")
        ring = self.spec.bounded_window or self.spec.ring_window
        # a prompt longer than a ring's window prefills in windows of at
        # most W, so the ring slots of one window stay distinct
        windowed = S > tc.max_context_length or bool(ring and S > ring)
        if windowed and not self.spec.bounded_window and S > self.token_generation_model.buckets[-1]:
            raise ValueError(
                f"prompt length {S} exceeds the largest token-generation "
                f"bucket ({self.token_generation_model.buckets[-1]}) needed "
                f"for windowed prefill; raise token_generation_buckets/seq_len"
            )
        return windowed

    def _windowed_prefill(self, input_ids, attention_mask, seq_ids, sampling_params, adapter_ids=None):
        """Prefill a prompt LONGER than one context program in windows (the
        reference's ``_windowed_prefill``): window 0 through the context
        program, every later window as a multi-token token-generation pass
        attending the cache written so far (plain attention over the
        contiguous cache: longer than B1's 16 query tokens). Every window is
        padded to the same length C, so one program per kv bucket; padded
        tokens carry sentinel positions that drop their writes and mask
        their reads. On a ring cache the windows are at most W long and the
        width carrier of the bounded cache is its W slots. Returns (first
        tokens (B, 1) int32 on the device, first logits (B, 1, V) | None).
        ``adapter_ids`` (B,) ride every window."""
        B, S_in = input_ids.shape
        C = self._prefill_window()
        ctx_lens = attention_mask.sum(axis=1).astype(np.int64)
        first_tok = np.zeros((B,), np.int64)
        first_logits = np.zeros((B, 1, self.spec.vocab_size), np.float32) if self.spec.output_logits else None

        n0 = min(C, S_in)
        pos0 = np.tile(np.arange(n0, dtype=np.int32), (B, 1))
        inputs, _ = self.context_encoding_model.prepare(
            input_ids[:, :n0], attention_mask[:, :n0], pos0, seq_ids, sampling_params, adapter_ids=adapter_ids
        )
        out = self.context_encoding_model(self.params, self.kv_cache, inputs, self._rng)
        rows = ctx_lens <= n0
        if rows.any():
            first_tok[rows] = out.tokens[:B].cpu().numpy()[rows, -1]
            if first_logits is not None:
                first_logits[rows, 0] = out.logits[:B].float().cpu().numpy()[rows, -1]

        tkg = self.token_generation_model
        start = n0
        while start < S_in:
            end = min(start + C, S_in)
            n = end - start
            ids = np.zeros((B, C), input_ids.dtype)
            ids[:, :n] = input_ids[:, start:end]
            pos = np.full((B, C), PAD_POSITION_SENTINEL, np.int32)
            pos[:, :n] = np.arange(start, end, dtype=np.int32)
            pos = np.where(pos < ctx_lens[:, None], pos, PAD_POSITION_SENTINEL)
            # full-width carrier: the per-token causal bounds keep valid
            # queries off the junk columns
            width = self.spec.bounded_window or autobucketing.get_target_bucket(tkg.buckets, end)
            mask = np.ones((B, width), np.int32)
            inputs, _ = tkg.prepare(ids, mask, pos, seq_ids, sampling_params, adapter_ids=adapter_ids)
            out = tkg(self.params, self.kv_cache, inputs, self._rng)
            rows = (ctx_lens > start) & (ctx_lens <= end)
            if rows.any():
                toks = out.tokens[:B].cpu().numpy()
                idx = np.clip(ctx_lens - 1 - start, 0, n - 1)
                first_tok[rows] = toks[rows, idx[rows]]
                if first_logits is not None:
                    first_logits[rows, 0] = out.logits[:B].float().cpu().numpy()[rows, idx[rows]]
            start = end
        first = torch.from_numpy(first_tok[:, None].astype(np.int32)).to(self.device)
        fl = torch.from_numpy(first_logits).to(self.device) if first_logits is not None else None
        return first, fl

    # ---- generation loop -------------------------------------------------

    def generate(
        self,
        input_ids: np.ndarray,
        attention_mask: Optional[np.ndarray] = None,
        max_new_tokens: int = 32,
        eos_token_id: Optional[int] = None,
        top_k=None,
        top_p=None,
        temperature=None,
        seq_ids: Optional[np.ndarray] = None,
        lora_adapter_names=None,
        inputs_embeds=None,
    ) -> GenerationOutput:
        """Greedy or sampled generation. input_ids (B, S); attention_mask
        (B, S) 1 = valid (the prompt is read through it, right- or
        left-padded alike, as in the reference). ``lora_adapter_names`` (B,)
        names each row's adapter (None: the base model); they resolve to
        slot ids once, before the prefill, and ride every step.
        ``inputs_embeds`` (B, S, H) replaces the prompt's token embeddings at
        the prefill (a multimodal prompt, ``runtime/image_to_text.py``);
        decode goes on from the sampled token ids."""
        tc = self.config.torch_config
        if tc.is_block_kv_layout:
            raise NotImplementedError(
                "block-KV layout generation runs through ServingSession "
                "(runtime/serving.py) or the low-level forward API"
            )
        self._advance_rng()
        gen_rng = self._rng
        input_ids = np.asarray(input_ids)
        B, S_in = input_ids.shape
        attention_mask = np.ones_like(input_ids) if attention_mask is None else np.asarray(attention_mask)
        if seq_ids is None:
            seq_ids = np.arange(B, dtype=np.int32)
        sampling_params = prepare_sampling_params(B, top_k, top_p, temperature)
        validate_sampling_params(sampling_params, tc.max_topk)
        windowed = self.validate_prefill_length(S_in)
        n_new = min(tc.seq_len, S_in + max_new_tokens) - S_in
        if n_new <= 0:
            return GenerationOutput(sequences=input_ids, num_generated=0)
        adapter_ids = self.resolve_adapter_ids(lora_adapter_names)
        ctx_lens = attention_mask.sum(axis=1).astype(np.int32)

        if windowed:
            if inputs_embeds is not None:
                raise NotImplementedError(
                    "inputs_embeds with windowed prefill is not implemented; raise max_context_length "
                    "to cover the multimodal prompt (ROADMAP C (inputs_embeds with windowed prefill))"
                )
            first_tokens, first_logits = self._windowed_prefill(
                input_ids, attention_mask, seq_ids, sampling_params, adapter_ids
            )
        else:
            # prefill: positions are slot indices [0, S); padded slots write
            # into the masked tail
            position_ids = np.tile(np.arange(S_in, dtype=np.int32), (B, 1))
            inputs, _ = self.context_encoding_model.prepare(
                input_ids, attention_mask, position_ids, seq_ids, sampling_params, adapter_ids=adapter_ids,
                inputs_embeds=inputs_embeds,
            )
            out = self.context_encoding_model(self.params, self.kv_cache, inputs, gen_rng)
            first_tokens = out.tokens[:B]  # device (B, 1)
            first_logits = out.logits[:B] if self.spec.output_logits else None
        pos = ctx_lens.copy()  # next write position per row
        remaining = n_new - 1
        pos_limit = self._pos_limit()

        def next_chunk(has_eos: bool):
            headroom = pos_limit - int(pos.max())
            if headroom < 1:
                raise ValueError(
                    f"generation needs positions past the largest TKG bucket/cache "
                    f"window ({pos_limit}); raise token_generation_buckets or seq_len"
                )
            chunk = _pick_chunk(remaining, has_eos, headroom)
            return chunk, min(chunk, remaining), self._decode_bucket(int(pos.max()) + chunk)

        if eos_token_id is None:
            # tokens stay on the device; everything comes back in ONE fetch
            token_chunks = [first_tokens]
            logit_chunks = [first_logits] if self.spec.output_logits else []
            last = first_tokens[:, -1:]
            while remaining > 0:
                chunk, take, bucket = next_chunk(False)
                tokens_c, logits_c, self.kv_cache = self.token_generation_model.decode_chunk(
                    self.params, self.kv_cache, last, pos[:, None], seq_ids, sampling_params,
                    num_steps=chunk, bucket=bucket, generator=gen_rng, adapter_ids=adapter_ids,
                )
                token_chunks.append(tokens_c[:B, :take])
                if self.spec.output_logits:
                    logit_chunks.append(logits_c[:B, :take])
                last = tokens_c[:B, take - 1 : take]
                pos = pos + take
                remaining -= take
                if not tc.async_mode and self.device.type == "cuda":
                    # debugging: wait for every chunk before the next dispatch
                    torch.cuda.synchronize(self.device)
            gen = torch.cat(token_chunks, dim=1).cpu().numpy()
            logits = torch.cat(logit_chunks, dim=1).cpu().numpy() if logit_chunks else None
            sequences = np.concatenate([input_ids, gen.astype(np.int64)], axis=1)
            return GenerationOutput(sequences=sequences, logits=logits, num_generated=gen.shape[1])

        eos_arr = np.atleast_1d(np.asarray(eos_token_id)).astype(np.int64)
        eos_fill = int(eos_arr[0])
        tokens = first_tokens.cpu().numpy()
        logits_acc: List[np.ndarray] = []
        if first_logits is not None:
            logits_acc.append(first_logits.cpu().numpy())
        generated = [tokens[:, -1]]
        done = np.isin(generated[-1], eos_arr)
        last = generated[-1][:, None].astype(np.int32)
        while remaining > 0 and not done.all():
            chunk, take, bucket = next_chunk(True)
            tokens_c, logits_c, self.kv_cache = self.token_generation_model.decode_chunk(
                self.params, self.kv_cache, last, pos[:, None], seq_ids, sampling_params,
                num_steps=chunk, bucket=bucket, generator=gen_rng, adapter_ids=adapter_ids,
            )
            # one fetch per chunk: the EOS test needs the tokens on the host
            tokens_c = tokens_c[:B].cpu().numpy()
            if self.spec.output_logits:
                logits_acc.append(logits_c[:B, :take].cpu().numpy())
            for j in range(take):
                step_tokens = np.where(done, eos_fill, tokens_c[:, j])
                done |= np.isin(step_tokens, eos_arr)
                generated.append(step_tokens)
            last = tokens_c[:, take - 1 : take].astype(np.int32)
            pos = pos + take
            remaining -= take
        gen = np.stack(generated, axis=1).astype(np.int64)
        sequences = np.concatenate([input_ids, gen], axis=1)
        logits = np.concatenate(logits_acc, axis=1) if logits_acc else None
        return GenerationOutput(sequences=sequences, logits=logits, num_generated=gen.shape[1])
