"""Fused speculation: the draft and the target in one program per phase
(counterpart of the reference's ``runtime/fused_spec.py``).

:class:`FusedSpecModelForCausalLM` is the port's
``TpuFusedSpecModelForCausalLM``: a token-level draft (a small causal LM,
``config.fused_spec_config.draft_config``) beside the target, each on its
own contiguous cache. ``generate()`` runs one fused prefill
(``modules/speculation.fused_spec_context_encoding``), then fused decode
rounds (``fused_spec_token_gen``): k draft steps and one k-token verify
pass, with ONE host fetch of (tokens, counts) per round.

Each program key, (phase, batch, bucket, sampled), is captured as one CUDA
graph at first use and replayed after (``runtime/graphs.py``), under the
same seal as the runners: :meth:`seal` makes a later first use raise
``RetraceError``. Greedy verification is byte-equal to plain greedy
decoding. Sampling (``do_sample``) draws from the app's generator,
reseeded per ``generate()`` call from ``Config.seed``.

EAGLE (:class:`EagleSpecModelForCausalLM`) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from neuronx_distributed_inference_tpu_torch.config import InferenceConfig
from neuronx_distributed_inference_tpu_torch.models import get_model_builder
from neuronx_distributed_inference_tpu_torch.models.base import StepInputs, prepare_params
from neuronx_distributed_inference_tpu_torch.modules import autobucketing
from neuronx_distributed_inference_tpu_torch.modules.autobucketing import get_target_bucket
from neuronx_distributed_inference_tpu_torch.modules.kvcache import init_cache, zero_stream
from neuronx_distributed_inference_tpu_torch.modules.sampling import (
    prepare_sampling_params,
    validate_sampling_params,
)
from neuronx_distributed_inference_tpu_torch.modules.speculation import (
    fused_spec_context_encoding,
    fused_spec_token_gen,
)
from neuronx_distributed_inference_tpu_torch.ops.quant import prepare_int4_params, prepare_quantized_params
from neuronx_distributed_inference_tpu_torch.runtime.application import GenerationOutput
from neuronx_distributed_inference_tpu_torch.runtime.graphs import GraphSet, binding
from neuronx_distributed_inference_tpu_torch.runtime.model_runner import _Programs, _Statics
from neuronx_distributed_inference_tpu_torch.telemetry.tracing import default_session

TAG_FUSED_CTE = "fused_speculation:cte"
TAG_FUSED_TKG = "fused_speculation:tkg"


class FusedSpecModelForCausalLM:
    """Token-level draft + target in one program per phase (the reference's
    ``TpuFusedSpecModelForCausalLM`` on its ``_SpecAppBase``): load, seal
    and the host loop."""

    def __init__(self, model_path: Optional[str], config: InferenceConfig, draft_model_path: Optional[str] = None):
        tc = config.torch_config
        if tc.speculation_length < 2:
            raise ValueError("fused speculation needs speculation_length >= 2")
        fsc = getattr(config, "fused_spec_config", None)
        draft_config = fsc.draft_config if fsc else None
        if draft_config is None:
            raise ValueError("config.fused_spec_config.draft_config required")
        self.config = config
        self.draft_config = draft_config
        self.model_path = model_path
        self.draft_model_path = draft_model_path
        self.k = tc.speculation_length
        # cache positions a decode round may write before acceptance
        self.reserve_slots = tc.speculation_length
        ods = tc.on_device_sampling_config
        self.do_sample = bool(ods and ods.do_sample)
        self.target_builder = get_model_builder(getattr(config, "model_type", "llama"))(config)
        self.draft_builder = get_model_builder(getattr(draft_config, "model_type", "llama"))(draft_config)
        self.target_spec = self.target_builder.model_spec()
        self.draft_spec = self.draft_builder.model_spec()
        self.device = self.target_builder.device
        self.cte_buckets = autobucketing.generate_context_encoding_buckets(tc)
        self.tkg_buckets = autobucketing.generate_token_generation_buckets(tc)
        self._common = dict(
            draft_spec=self.draft_spec, target_spec=self.target_spec,
            draft_mlp_fn=self.draft_builder.mlp_fn(), target_mlp_fn=self.target_builder.mlp_fn(),
        )
        # a prefill that reaches an MoE grouped route reads group sizes on
        # the host: such programs run eagerly (model_runner._Programs)
        reads = [n for n in (self.target_builder.host_read_tokens(), self.draft_builder.host_read_tokens())
                 if n is not None]
        self._cte = _Programs(TAG_FUSED_CTE, min(reads) if reads else None)
        self._tkg = _Programs(TAG_FUSED_TKG)
        self.graphs: Optional[GraphSet] = None
        self._rng = torch.Generator(device=self.device)
        self._rng_calls = 0
        self.draft_params = self.target_params = None
        self.draft_cache = self.target_cache = None

    def seal(self):
        """Arm the retrace guard: a later first use of a new fused program
        key raises RetraceError."""
        self._cte.sealed = self._tkg.sealed = True

    def load(self, target_state_dict=None, draft_state_dict=None, random_weights: bool = False,
             target_params=None, draft_params=None):
        """Put both models' weights on the device and allocate both caches
        (the target config's batch and seq_len). ``random_weights``: each
        model seeded from its own config's ``seed``; ``*_state_dict``: HF
        state dicts; ``*_params``: ready params in the port's layout, taken
        as they are. Weights made here quantize at load as the target's
        config asks."""
        tc = self.config.torch_config
        made = []
        for builder, sd, params in (
            (self.target_builder, target_state_dict, target_params),
            (self.draft_builder, draft_state_dict, draft_params),
        ):
            if params is None:
                if random_weights:
                    params = builder.random_params()
                elif sd is not None:
                    params = builder.convert_hf_state_dict(sd)
                else:
                    raise NotImplementedError(
                        "loading a checkpoint from a path is not ported to PyTorch yet "
                        "(ROADMAP A11); pass *_state_dict=, *_params= or random_weights=True"
                    )
                if tc.quantized:
                    params = prepare_quantized_params(params, tc)
                elif tc.weight_int4:
                    params = prepare_int4_params(params, tc)
            made.append(prepare_params(params))
        self.target_params, self.draft_params = made
        kv_batch = tc.kv_cache_batch_size or tc.max_batch_size
        self.target_cache, self.draft_cache = (
            init_cache(
                s.num_layers, kv_batch, tc.seq_len, s.attn.num_kv_heads, s.attn.head_dim,
                dtype=tc.kv_dtype, device=self.device,
            )
            for s in (self.target_spec, self.draft_spec)
        )
        if self.graphs is not None:
            self.graphs.close()
        self.graphs = GraphSet(self.device, tc.cuda_graphs)
        self._cte.bind(self.graphs)
        self._tkg.bind(self.graphs)
        return self

    def init_kv_cache(self):
        """Zero both caches in place (the graphs keep their addresses)."""
        for cache in (self.target_cache, self.draft_cache):
            zero_stream(cache.k)
            zero_stream(cache.v)

    def _binding(self):
        return binding(self.target_params, self.target_cache) + binding(self.draft_params, self.draft_cache)

    def _advance_rng(self):
        """The k-th generate() call draws from seed (Config.seed, k)."""
        seed = np.random.SeedSequence([self.config.torch_config.seed, self._rng_calls]).generate_state(1)[0]
        self._rng.manual_seed(int(seed))
        self._rng_calls += 1

    def _statics(self, prog: _Programs, key: tuple, fields) -> _Statics:
        st = prog.statics.get(key)
        if st is None:
            st = prog.statics[key] = _Statics(fields, self.device)
        return st

    @torch.no_grad()
    def _call(self, prog: _Programs, phase: str, arrs: dict, bucket: int, fn):
        """Run one fused program: its statics filled from ``arrs`` ((B, S)
        host arrays), its graph replayed (or first run and captured). Returns
        the program's outputs, copied out of the graph's buffers."""
        B, S = arrs["input_ids"].shape
        sampled = self.do_sample
        fields = [
            ("input_ids", (B, S), False), ("position_ids", (B, S), False), ("seq_ids", (B,), False),
            ("sampling_params", (B, 3), True),
        ]
        if "attention_mask" in arrs:
            fields.append(("attention_mask", (B, bucket), False))
        st = self._statics(prog, (phase, B, S, bucket), fields)
        st.fill(arrs)
        t = st.t
        inputs = StepInputs(
            input_ids=t["input_ids"], attention_mask=t.get("attention_mask"), position_ids=t["position_ids"],
            seq_ids=t["seq_ids"], sampling_params=t["sampling_params"],
        )
        gen = self._rng if sampled else None

        def body():
            out = fn(
                self.draft_params, self.target_params, self.draft_cache, self.target_cache, inputs, gen,
                do_sample=sampled, max_topk=self.config.torch_config.max_topk, **self._common,
            )
            return out.tokens, out.counts

        (tokens, counts), replayed = prog.run((phase, B, S, bucket, sampled), body, self._binding(), S, gen)
        if replayed:
            tokens, counts = tokens.clone(), counts.clone()
        return tokens, counts

    # ---- host loop -------------------------------------------------------

    def generate(
        self,
        input_ids: np.ndarray,
        attention_mask: Optional[np.ndarray] = None,
        max_new_tokens: int = 32,
        eos_token_id: Optional[int] = None,
        top_k=None,
        top_p=None,
        temperature=None,
    ) -> GenerationOutput:
        """Greedy or sampled generation (right-padded rows through
        ``attention_mask``), one fused round per host fetch."""
        tc = self.config.torch_config
        input_ids = np.asarray(input_ids)
        B, S_in = input_ids.shape
        attention_mask = np.ones_like(input_ids) if attention_mask is None else np.asarray(attention_mask)
        seq_ids = np.arange(B, dtype=np.int32)
        sp = prepare_sampling_params(B, top_k, top_p, temperature)
        validate_sampling_params(sp, tc.max_topk)
        self._advance_rng()
        tel = default_session()

        bucket = get_target_bucket(self.cte_buckets, S_in)
        pad_s = bucket - S_in
        arrs = dict(
            input_ids=np.pad(input_ids, ((0, 0), (0, pad_s))),
            attention_mask=np.pad(attention_mask, ((0, 0), (0, pad_s))),
            position_ids=np.tile(np.arange(bucket, dtype=np.int32), (B, 1)),
            seq_ids=seq_ids, sampling_params=sp,
        )
        with tel.span("fused_spec.cte", tokens=S_in):
            tokens, _ = self._call(self._cte, "cte", arrs, bucket, fused_spec_context_encoding)
        tel.step("prefill")
        tel.bucket_dispatch("fused_spec_cte", bucket)
        first = tokens.cpu().numpy()[:, 0]

        collected = [[int(first[b])] for b in range(B)]
        done = np.array([len(c) >= max_new_tokens for c in collected])
        if eos_token_id is not None:
            done |= first == eos_token_id
        pos = attention_mask.sum(axis=1).astype(np.int32)  # position of `last`
        last = first.astype(np.int32)
        step = 1
        while not done.all() and int(pos.max()) + self.reserve_slots <= tc.seq_len:
            bucket = get_target_bucket(self.tkg_buckets, int(pos.max()) + self.reserve_slots)
            arrs = dict(input_ids=last[:, None], position_ids=pos[:, None], seq_ids=seq_ids, sampling_params=sp)
            with tel.span("fused_spec.tkg", round=step):
                tokens, counts = self._call(
                    self._tkg, "tkg", arrs, bucket,
                    lambda *a, **kw: fused_spec_token_gen(*a, spec_len=self.k, bucket=bucket, **kw),
                )
            tel.step("speculate")
            tel.bucket_dispatch("fused_spec_tkg", bucket)
            # one host fetch per round: tokens and counts together
            both = torch.cat([tokens, counts[:, None].to(tokens.dtype)], dim=1).cpu().numpy()
            tokens, counts = both[:, :-1], both[:, -1].astype(np.int64)
            for b in range(B):
                if done[b]:
                    continue
                accepted = tokens[b, : counts[b]].tolist()
                if eos_token_id is not None and eos_token_id in accepted:
                    accepted = accepted[: accepted.index(eos_token_id) + 1]
                    done[b] = True
                # the commit is capped at the row's budget (the device state
                # advances by counts either way)
                committed = accepted[: max_new_tokens - len(collected[b])]
                collected[b].extend(committed)
                tel.spec_accept(len(committed))
                if len(collected[b]) >= max_new_tokens:
                    done[b] = True
            last = tokens[np.arange(B), counts - 1].astype(np.int32)
            pos = pos + counts.astype(np.int32)
            step += 1

        n_new = min(max_new_tokens, max(len(c) for c in collected))
        pad_tok = eos_token_id if eos_token_id is not None else 0
        gen = np.full((B, n_new), pad_tok, np.int64)
        for b in range(B):
            row = collected[b][:n_new]
            gen[b, : len(row)] = row
        sequences = np.concatenate([input_ids, gen], axis=1)
        return GenerationOutput(sequences=sequences, logits=None, num_generated=n_new)


class EagleSpecModelForCausalLM:
    """EAGLE speculation (the reference's ``TpuEagleSpecModelForCausalLM``):
    not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "EAGLE speculation (EagleSpecModelForCausalLM) is not ported to PyTorch yet "
            "(ROADMAP A7 (EAGLE))"
        )
