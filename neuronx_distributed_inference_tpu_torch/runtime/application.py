"""Application layer: load / warmup / forward / generate (counterpart of
the reference's ``runtime/application.py``).

:class:`ModelForCausalLM` is the port's ``TpuModelForCausalLM``: one
context-encoding runner and one token-generation runner over a KV cache on
the config's device (``"cuda"`` unless the caller asks for the CPU). The
cache is contiguous, or the paged block pool with ``is_block_kv_layout``.
With ``serving_ragged`` it also carries ``mixed_step_model``, the ragged
mixed-step runner the serving session dispatches once per step.
``generate`` keeps the reference's host loop over the contiguous cache: one
prefill, then decode chunks sized by :func:`_pick_chunk`, with tokens kept
on the device and fetched once at the end when no EOS is given, and fetched
once per chunk to test for EOS otherwise. The paged cache is driven through
``runtime/serving.py::ServingSession`` or :meth:`ModelForCausalLM.forward`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np
import torch

from neuronx_distributed_inference_tpu_torch.config import InferenceConfig
from neuronx_distributed_inference_tpu_torch.models import get_model_builder
from neuronx_distributed_inference_tpu_torch.models.base import (
    PHASE_CONTEXT_ENCODING,
    PHASE_TOKEN_GENERATION,
    prepare_params,
)
from neuronx_distributed_inference_tpu_torch.modules import autobucketing
from neuronx_distributed_inference_tpu_torch.modules.block_kvcache import BlockKVCache
from neuronx_distributed_inference_tpu_torch.modules.kvcache import KVCache
from neuronx_distributed_inference_tpu_torch.modules.sampling import (
    prepare_sampling_params,
    validate_sampling_params,
)
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
        tkg_buckets = autobucketing.generate_token_generation_buckets(tc)
        if tc.is_block_kv_layout:
            # block-table reads need bucket % block_size == 0
            tkg_buckets = sorted(
                {autobucketing.round_up(b, tc.pa_block_size) for b in tkg_buckets}
            )
        block_kwargs = dict(block_kv=tc.is_block_kv_layout, block_size=tc.pa_block_size)
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
            self.mixed_step_model = MixedStepRunner(
                self.spec, mixed_buckets, num_rows, self.device, mlp_fn, tc.pa_block_size, tkg_buckets,
            )

    # ---- weights / cache -------------------------------------------------

    def load(self, model_path: Optional[str] = None, state_dict=None, random_weights=False, params=None):
        """Put weights on the device and allocate the KV cache.

        ``state_dict``: an HF-layout state dict (numpy or torch leaves);
        ``random_weights``: seeded random weights made on the device;
        ``params``: ready params in the port's layout (for example from
        ``models.builder.params_from_jax``)."""
        if params is None:
            if random_weights:
                params = self.builder.random_params()
            elif state_dict is not None:
                params = self.builder.convert_hf_state_dict(state_dict)
            else:
                raise NotImplementedError(
                    "loading a checkpoint from a path is not ported to PyTorch yet "
                    "(ROADMAP A11); pass state_dict=, params= or random_weights=True"
                )
        self.params = prepare_params(params)
        self.init_kv_cache()
        return self

    def init_kv_cache(self):
        """A fresh (zeroed) cache: contiguous, or the paged block pool."""
        self.kv_cache = self.builder.init_kv_cache()

    def warmup(self):
        """Run every bucket of both runners once, with chunked or prefix
        prefill every chunk q length, and every total-token bucket of the
        mixed-step runner (kernel builds included)."""
        tc = self.config.torch_config
        chunk_q = None
        if tc.is_chunked_prefill or tc.is_prefix_caching:
            chunk_q = autobucketing.generate_chunk_q_buckets(tc)
        for runner in self.runners:
            self.kv_cache = runner.warmup(
                self.params, self.kv_cache,
                chunk_q_lens=chunk_q if runner is self.token_generation_model else None,
            )
        if self.mixed_step_model is not None:
            self.kv_cache = self.mixed_step_model.warmup(self.params, self.kv_cache)
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
        return min(self.config.torch_config.seq_len, self.token_generation_model.buckets[-1])

    def _decode_bucket(self, needed: int) -> int:
        return autobucketing.get_target_bucket(self.token_generation_model.buckets, needed)

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
    ) -> GenerationOutput:
        """Greedy generation. input_ids (B, S) RIGHT-padded; attention_mask
        (B, S) 1 = valid."""
        tc = self.config.torch_config
        if tc.is_block_kv_layout:
            raise NotImplementedError(
                "block-KV layout generation runs through ServingSession "
                "(runtime/serving.py) or the low-level forward API"
            )
        input_ids = np.asarray(input_ids)
        B, S_in = input_ids.shape
        attention_mask = np.ones_like(input_ids) if attention_mask is None else np.asarray(attention_mask)
        if seq_ids is None:
            seq_ids = np.arange(B, dtype=np.int32)
        sampling_params = prepare_sampling_params(B, top_k, top_p, temperature)
        validate_sampling_params(sampling_params, tc.max_topk)
        if S_in > tc.seq_len:
            raise ValueError(f"prompt length {S_in} exceeds seq_len {tc.seq_len}")
        if S_in > tc.max_context_length:
            raise NotImplementedError(
                "windowed prefill (prompts longer than max_context_length) is not "
                "ported to PyTorch yet (ROADMAP A3b)"
            )
        n_new = min(tc.seq_len, S_in + max_new_tokens) - S_in
        if n_new <= 0:
            return GenerationOutput(sequences=input_ids, num_generated=0)
        ctx_lens = attention_mask.sum(axis=1).astype(np.int32)

        # prefill: positions are slot indices [0, S); padded slots write into
        # the masked tail
        position_ids = np.tile(np.arange(S_in, dtype=np.int32), (B, 1))
        inputs, _ = self.context_encoding_model.prepare(
            input_ids, attention_mask, position_ids, seq_ids, sampling_params
        )
        out = self.context_encoding_model(self.params, self.kv_cache, inputs)
        self.kv_cache = out.cache
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
                    num_steps=chunk, bucket=bucket,
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
                num_steps=chunk, bucket=bucket,
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
