"""Fused speculation: the draft and the target in one program per phase
(counterpart of the reference's ``runtime/fused_spec.py``).

Two applications share one host loop (:class:`_SpecAppBase`, also under
``runtime/medusa.py``):

- :class:`FusedSpecModelForCausalLM`, the port's
  ``TpuFusedSpecModelForCausalLM``: a token-level draft (a small causal LM,
  ``config.fused_spec_config.draft_config``) beside the target, each on its
  own contiguous cache. ``generate()`` runs one fused prefill
  (``modules/speculation.fused_spec_context_encoding``), then fused decode
  rounds (``fused_spec_token_gen``): k draft steps and one k-token verify
  pass, with ONE host fetch of (tokens, counts) per round.
- :class:`EagleSpecModelForCausalLM`, the port's
  ``TpuEagleSpecModelForCausalLM``: an EAGLE draft (``llama-eagle`` or, with
  ``is_eagle3``, ``llama-eagle3``; ``models/eagle_draft.py``) chained with
  the target's hidden states (``modules/eagle.py``), whose hidden buffer is
  app state beside the two caches; with ``token_tree_config`` each round
  expands a static or a dynamic token tree (``modules/token_tree.py``).

Each program key, (phase, batch, bucket, sampled), is captured as one CUDA
graph at first use and replayed after (``runtime/graphs.py``), under the
same seal as the runners: :meth:`_SpecAppBase.seal` makes a later first
use raise ``RetraceError``. Greedy verification is byte-equal to plain
greedy decoding. Sampling (``do_sample``) draws from the app's generator,
reseeded per ``generate()`` call from ``Config.seed``.
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
from neuronx_distributed_inference_tpu_torch.modules.eagle import (
    default_eagle_draft_fn,
    eagle3_capture_layers,
    eagle3_draft_hidden,
    eagle3_lm_hidden,
    eagle_context_encoding,
    eagle_token_gen,
    init_hidden_buffer,
)
from neuronx_distributed_inference_tpu_torch.modules.kvcache import cache_streams, init_cache, zero_stream
from neuronx_distributed_inference_tpu_torch.modules.sampling import (
    prepare_sampling_params,
    validate_sampling_params,
)
from neuronx_distributed_inference_tpu_torch.modules.speculation import (
    fused_spec_context_encoding,
    fused_spec_token_gen,
)
from neuronx_distributed_inference_tpu_torch.modules.token_tree import (
    DynamicTokenTree,
    TokenTree,
    dynamic_tree_token_gen,
    tree_token_gen,
)
from neuronx_distributed_inference_tpu_torch.ops.quant import prepare_int4_params, prepare_quantized_params
from neuronx_distributed_inference_tpu_torch.runtime.application import GenerationOutput
from neuronx_distributed_inference_tpu_torch.runtime.graphs import GraphSet, binding
from neuronx_distributed_inference_tpu_torch.runtime.model_runner import _Programs, _Statics
from neuronx_distributed_inference_tpu_torch.telemetry.tracing import default_session

TAG_FUSED_CTE = "fused_speculation:cte"
TAG_FUSED_TKG = "fused_speculation:tkg"
TAG_EAGLE_CTE = "eagle:cte"
TAG_EAGLE_TKG = "eagle:tkg"


def load_params(builder, tc, state_dict=None, random_weights=False, params=None):
    """One model's params in the port's layout: ``params`` as they are,
    else random or from an HF state dict, quantized at load as ``tc``
    asks."""
    if params is None:
        if random_weights:
            params = builder.random_params()
        elif state_dict is not None:
            params = builder.convert_hf_state_dict(state_dict)
        else:
            raise NotImplementedError(
                "loading a checkpoint from a path is not ported to PyTorch yet "
                "(ROADMAP A11); pass *_state_dict=, *_params= or random_weights=True"
            )
        if tc.quantized:
            params = prepare_quantized_params(params, tc)
        elif tc.weight_int4:
            params = prepare_int4_params(params, tc)
    return prepare_params(params)


class _SpecAppBase:
    """The shared host loop, programs, seal and generator of the
    speculation apps (the reference's ``_SpecAppBase``). A subclass sets
    ``reserve_slots`` (cache slots a round may write before acceptance),
    loads its weights and state, and runs its programs through
    :meth:`_cte_step` / :meth:`_tkg_step`, each returning an object with
    ``tokens`` and ``counts``."""

    def __init__(self, config: InferenceConfig, device, tags, host_read_tokens=None):
        tc = config.torch_config
        self.config = config
        ods = tc.on_device_sampling_config
        self.do_sample = bool(ods and ods.do_sample)
        self.device = device
        self.cte_buckets = autobucketing.generate_context_encoding_buckets(tc)
        self.tkg_buckets = autobucketing.generate_token_generation_buckets(tc)
        # a prefill that reaches an MoE grouped route reads group sizes on
        # the host: such programs run eagerly (model_runner._Programs)
        self._cte = _Programs(tags[0], host_read_tokens)
        self._tkg = _Programs(tags[1])
        self.graphs: Optional[GraphSet] = None
        self._rng = torch.Generator(device=self.device)
        self._rng_calls = 0

    def seal(self):
        """Arm the retrace guard: a later first use of a new program key
        raises RetraceError."""
        self._cte.sealed = self._tkg.sealed = True

    def _bind_graphs(self):
        if self.graphs is not None:
            self.graphs.close()
        self.graphs = GraphSet(self.device, self.config.torch_config.cuda_graphs)
        self._cte.bind(self.graphs)
        self._tkg.bind(self.graphs)

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
        """Run one fused program ``fn(inputs, generator)``: its statics
        filled from ``arrs`` ((B, S) host arrays), its graph replayed (or
        first run and captured). Returns (tokens, counts), copied out of the
        graph's buffers."""
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
            out = fn(inputs, gen)
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
            tokens, _ = self._call(self._cte, "cte", arrs, bucket, self._cte_step)
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
                    self._tkg, "tkg", arrs, bucket, lambda inputs, gen, b=bucket: self._tkg_step(inputs, gen, b)
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


class FusedSpecModelForCausalLM(_SpecAppBase):
    """Token-level draft + target in one program per phase (the reference's
    ``TpuFusedSpecModelForCausalLM``): load and the fused programs."""

    TAGS = (TAG_FUSED_CTE, TAG_FUSED_TKG)

    def __init__(self, model_path: Optional[str], config: InferenceConfig, draft_model_path: Optional[str] = None):
        tc = config.torch_config
        if tc.speculation_length < 2:
            raise ValueError("fused speculation needs speculation_length >= 2")
        fsc = getattr(config, "fused_spec_config", None)
        draft_config = fsc.draft_config if fsc else None
        if draft_config is None:
            raise ValueError("config.fused_spec_config.draft_config required")
        self.draft_config = draft_config
        self.model_path = model_path
        self.draft_model_path = draft_model_path
        self.k = tc.speculation_length
        # cache positions a decode round may write before acceptance: the
        # chain writes k; a token tree one slot per node
        self.reserve_slots = tc.speculation_length
        self.target_builder = get_model_builder(getattr(config, "model_type", "llama"))(config)
        self.draft_builder = get_model_builder(getattr(draft_config, "model_type", "llama"))(draft_config)
        if self.target_builder.layer_fn() is not None or self.draft_builder.layer_fn() is not None:
            raise NotImplementedError(
                "fused speculation with an MLA target or draft is not ported to PyTorch yet "
                "(ROADMAP A9 (MLA speculation))"
            )
        self.target_spec = self.target_builder.model_spec()
        self.draft_spec = self.draft_builder.model_spec()
        self._common = dict(
            draft_spec=self.draft_spec, target_spec=self.target_spec,
            draft_mlp_fn=self.draft_builder.mlp_fn(), target_mlp_fn=self.target_builder.mlp_fn(),
        )
        reads = [n for n in (self.target_builder.host_read_tokens(), self.draft_builder.host_read_tokens())
                 if n is not None]
        super().__init__(config, self.target_builder.device, self.TAGS, min(reads) if reads else None)
        self.draft_params = self.target_params = None
        self.draft_cache = self.target_cache = None

    def load(self, target_state_dict=None, draft_state_dict=None, random_weights: bool = False,
             target_params=None, draft_params=None):
        """Put both models' weights on the device and allocate both caches
        (the target config's batch and seq_len). ``random_weights``: each
        model seeded from its own config's ``seed``; ``*_state_dict``: HF
        state dicts; ``*_params``: ready params in the port's layout, taken
        as they are. Weights made here quantize at load as the target's
        config asks."""
        tc = self.config.torch_config
        self.target_params = load_params(self.target_builder, tc, target_state_dict, random_weights, target_params)
        self.draft_params = load_params(self.draft_builder, tc, draft_state_dict, random_weights, draft_params)
        kv_batch = tc.kv_cache_batch_size or tc.max_batch_size
        self.target_cache, self.draft_cache = (
            init_cache(
                s.num_layers, kv_batch, tc.seq_len, s.attn.num_kv_heads, s.attn.head_dim,
                dtype=tc.kv_dtype, device=self.device,
            )
            for s in (self.target_spec, self.draft_spec)
        )
        self._init_extra_state(kv_batch)
        self._bind_graphs()
        return self

    def _init_extra_state(self, kv_batch: int):
        pass

    def init_kv_cache(self):
        """Zero both caches in place (the graphs keep their addresses)."""
        for cache in (self.target_cache, self.draft_cache):
            for stream in cache_streams(cache):
                zero_stream(stream)

    def _binding(self):
        return binding(self.target_params, self.target_cache) + binding(self.draft_params, self.draft_cache)

    def _kw(self):
        return dict(do_sample=self.do_sample, max_topk=self.config.torch_config.max_topk, **self._common)

    def _cte_step(self, inputs, gen):
        return fused_spec_context_encoding(
            self.draft_params, self.target_params, self.draft_cache, self.target_cache, inputs, gen, **self._kw()
        )

    def _tkg_step(self, inputs, gen, bucket):
        return fused_spec_token_gen(
            self.draft_params, self.target_params, self.draft_cache, self.target_cache, inputs, gen,
            spec_len=self.k, bucket=bucket, **self._kw(),
        )


class EagleSpecModelForCausalLM(FusedSpecModelForCausalLM):
    """EAGLE: a feature-level draft chained with the target's hidden states
    (the reference's ``TpuEagleSpecModelForCausalLM``). The draft's
    ``model_type`` is ``llama-eagle`` (``models/eagle_draft.py``), or
    ``llama-eagle3`` with ``is_eagle3`` (the target's three-layer capture,
    a 3H hidden buffer).

    With ``token_tree_config`` a round expands a static tree
    (``{node: [children]}``) or a dynamic one (``{"step", ...}``) instead of
    a chain (``modules/token_tree.py``), and reserves one cache slot per
    node. Both verify greedily or, with ``do_sample``, by recursive
    rejection sampling. Trees need a plain-attention target: the ancestry
    mask replaces the window and chunk masks."""

    TAGS = (TAG_EAGLE_CTE, TAG_EAGLE_TKG)

    def __init__(self, model_path, config, draft_model_path=None):
        tc = config.torch_config
        if not tc.enable_eagle_speculation:
            raise ValueError("set torch_config.enable_eagle_speculation=True")
        super().__init__(model_path, config, draft_model_path)
        self.is_eagle3 = bool(tc.is_eagle3)
        self.capture_layers = eagle3_capture_layers(self.target_spec.num_layers) if self.is_eagle3 else None
        if self.is_eagle3:
            draft_spec, mlp_fn = self.draft_spec, self._common["draft_mlp_fn"]
            self.draft_fn = lambda params, tokens, prev_h, cache, inputs, phase: eagle3_draft_hidden(
                params, tokens, prev_h, cache, inputs, spec=draft_spec, phase=phase, mlp_fn=mlp_fn
            )
            self.draft_lm_hidden_fn = lambda params, h: eagle3_lm_hidden(params, h, draft_spec)
        else:
            self.draft_fn = default_eagle_draft_fn(
                self.draft_spec, self._common["draft_mlp_fn"], bool(tc.enable_eagle_draft_input_norm)
            )
            self.draft_lm_hidden_fn = None
        self.tree = None
        if tc.token_tree_config:
            ts = self.target_spec
            if any(getattr(ts, name, None) for name in (
                "layer_groups", "sliding_window", "attention_chunk_size", "ring_window", "bounded_window",
            )):
                raise NotImplementedError(
                    "token-tree speculation requires a plain-attention "
                    "target: the tree ancestry mask replaces the per-layer "
                    "window/chunk masks (StepInputs.mask_override), which "
                    "would silently widen windowed layers"
                )
            dynamic = "step" in tc.token_tree_config
            self.tree = (DynamicTokenTree if dynamic else TokenTree)(tc.token_tree_config)
            self.reserve_slots = self.tree.num_nodes
        self.hidden_buffer = None

    def _init_extra_state(self, kv_batch: int):
        # EAGLE3 chains the target's three-layer capture (3H)
        mult = 3 if self.is_eagle3 else 1
        self.hidden_buffer = init_hidden_buffer(
            kv_batch, mult * self.config.hidden_size, self.config.torch_config.torch_dtype, self.device
        )

    def init_kv_cache(self):
        """Zero both caches and the hidden buffer in place."""
        super().init_kv_cache()
        self.hidden_buffer.zero_()

    def _binding(self):
        return super()._binding() + (self.hidden_buffer.data_ptr(),)

    def _cte_step(self, inputs, gen):
        return eagle_context_encoding(
            self.draft_params, self.target_params, self.draft_cache, self.target_cache, self.hidden_buffer,
            inputs, gen, draft_fn=self.draft_fn, capture_layers=self.capture_layers, **self._kw(),
        )

    def _tkg_step(self, inputs, gen, bucket):
        args = (self.draft_params, self.target_params, self.draft_cache, self.target_cache, self.hidden_buffer,
                inputs, gen)
        if self.tree is None:
            return eagle_token_gen(
                *args, spec_len=self.k, bucket=bucket, draft_fn=self.draft_fn,
                draft_lm_hidden_fn=self.draft_lm_hidden_fn, capture_layers=self.capture_layers, **self._kw(),
            )
        tree_kw = dict(
            bucket=bucket, draft_hidden_fn=self.draft_fn, draft_spec=self.draft_spec,
            target_spec=self.target_spec, target_mlp_fn=self._common["target_mlp_fn"],
            target_capture_layers=self.capture_layers, draft_lm_hidden_fn=self.draft_lm_hidden_fn,
            do_sample=self.do_sample, max_topk=self.config.torch_config.max_topk,
        )
        if isinstance(self.tree, DynamicTokenTree):
            return dynamic_tree_token_gen(*args, dyn=self.tree, **tree_kw)
        return tree_token_gen(*args, tree=self.tree, **tree_kw)
