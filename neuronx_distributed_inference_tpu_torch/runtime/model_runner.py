"""Per-sub-model runners: bucket dispatch, host padding and one CUDA graph
per key (counterpart of the reference's ``runtime/model_runner.py``:
``SubModelRunner`` and the ragged ``MixedStepRunner``).

The reference holds one jitted program per key and compiles it at first
use; the port captures each key's program as one CUDA graph at first use
and replays it after (``runtime/graphs.py``). The keys:

- (phase, compiled batch, bucket) of a context-encoding step and of a
  one-token decode step;
- (pass length, bucket) of a multi-token pass: a chunked or prefix prefill
  pass on the paged cache, or one window of a windowed prefill (every
  window is padded to the same length);
- (bucket) of the one-step decode program that :meth:`decode_chunk`
  replays once per step;
- (bucket, steps) of a draft's chained propose
  (:meth:`SubModelRunner.draft_chain`, the spec-ragged session's draft);
- (total-token bucket, kv width) of the ragged mixed step, and of its
  speculative-verification family (``spec_width > 1``).

A program samples (a separate key) only when it is handed the app's
generator and the spec samples. Each key's inputs live in static device
buffers, filled from ONE host buffer a call; the outputs of a replay are
copied out of the graph's buffers before the call returns, since the next
replay overwrites them.

**What stays eager.** A step whose MoE layers take the grouped route reads
the experts' group sizes on the host once a layer (``modules/moe.py``), so
it cannot be captured: the programs of ``host_read_tokens`` tokens or more
per row (Qwen3-MoE's context encoding, chunked-prefill passes and long
windows) run eagerly on every call, and the runner logs that once. Their
decode steps (B7, no host read) are captured. The ragged mixed step routes
its MoE layers by the PACKED token count (its hidden state is (1, T, H),
pad slots included), so a mixed-step bucket of ``host_read_tokens`` or more
runs eagerly: with 16-slot q tiles, four decode rows already pack 64
tokens. With ``cuda_graphs=False``, and always on
the CPU, every program runs eagerly; the runners still record their keys,
so the seal behaves the same.

**The seal** (``seal()``; the application seals after ``warmup()`` when
``retrace_guard`` or ``NXDI_TPU_RETRACE_GUARD=1`` asks): once sealed, the
first use of a new step key raises ``RetraceError`` before any capture. A
decode program's first capture is still allowed, as the reference allows
one compile per multi-step key.

On the paged cache (``block_kv``) a prefill carries a host ``slot_mapping``
(padded with -1, the garbage slot), a decode step carries only a
``block_table`` (its write slots are derived on the device), and a chunked
or prefix prefill pass carries both.
"""

from __future__ import annotations

import logging
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from neuronx_distributed_inference_tpu_torch.analysis.retrace_guard import note_trace
from neuronx_distributed_inference_tpu_torch.models.base import (
    PHASE_CONTEXT_ENCODING,
    Cache,
    DecodeState,
    MixedStepInputs,
    ModelSpec,
    StepInputs,
    StepOutput,
    decode_step,
    draft_chain_propose,
    forward,
    mixed_forward,
)
from neuronx_distributed_inference_tpu_torch.modules.autobucketing import get_target_bucket
from neuronx_distributed_inference_tpu_torch.modules.sampling import prepare_sampling_params
from neuronx_distributed_inference_tpu_torch.runtime.graphs import GraphSet, binding

TAG_CONTEXT_ENCODING = "context_encoding_model"
TAG_TOKEN_GENERATION = "token_generation_model"
TAG_MIXED_STEP = "mixed_step_model"
TAG_MIXED_STEP_SPEC = "mixed_step_spec_model"
TAG_SPEC_DRAFT_CHAIN = "spec_draft_chain"

log = logging.getLogger(__name__)

#: StepInputs fields a step may carry beside the five every step has
_OPTIONAL_FIELDS = ("slot_mapping", "block_table")
#: batch rows past the caller's pad with -1 here (the garbage line / slot)
_PAD_MINUS_ONE = ("seq_ids", "slot_mapping")


class _Statics:
    """The fixed-address device inputs of one key: one int32 buffer (float
    fields ride in it as float32 bits), filled from one host buffer a call
    (pinned on a card, so the copy does not wait for the step in flight)."""

    def __init__(self, fields: List[Tuple[str, tuple, bool]], device: torch.device):
        self.spans: Dict[str, Tuple[int, tuple, bool]] = {}
        off = 0
        for name, shape, is_float in fields:
            self.spans[name] = (off, shape, is_float)
            off += int(np.prod(shape))
        self.flat = torch.zeros(off, dtype=torch.int32, device=device)
        self.t: Dict[str, torch.Tensor] = {}
        for name, (o, shape, is_float) in self.spans.items():
            v = self.flat[o : o + int(np.prod(shape))]
            self.t[name] = (v.view(torch.float32) if is_float else v).view(shape)

    def host(self) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """A zeroed host buffer laid out like :attr:`flat`, and its views."""
        buf = np.zeros(self.flat.numel(), np.int32)
        views = {}
        for name, (o, shape, is_float) in self.spans.items():
            seg = buf[o : o + int(np.prod(shape))]
            views[name] = (seg.view(np.float32) if is_float else seg).reshape(shape)
        return buf, views

    def fill(self, arrs: Dict[str, object]) -> None:
        """Write ``arrs`` (numpy arrays, or device tensors for the token
        input) into the buffers, each padded along the batch axis (-1 for
        seq_ids and slot_mapping, 0 for the rest) and along the others
        with zeros."""
        buf, views = self.host()
        dev = {}
        for name, a in arrs.items():
            v = views[name]
            if not isinstance(a, torch.Tensor):
                a = np.asarray(a)
            n = a.shape[0]
            if n > v.shape[0]:
                raise ValueError(f"input batch {n} > compiled batch {v.shape[0]}")
            if isinstance(a, torch.Tensor):
                dev[name] = a
            else:
                v[(slice(0, n),) + tuple(slice(0, s) for s in a.shape[1:])] = a
            if name in _PAD_MINUS_ONE:
                v[n:] = -1
        t = torch.from_numpy(buf)
        if self.flat.is_cuda:
            self.flat.copy_(t.pin_memory(), non_blocking=True)
        else:
            self.flat.copy_(t)
        for name, a in dev.items():
            self.t[name][: a.shape[0]].copy_(a)

    def load(self, tensors: Dict[str, torch.Tensor]) -> None:
        """Copy device tensors of the full shapes (inputs built outside
        :meth:`fill`) into the buffers."""
        for name, a in tensors.items():
            if a.data_ptr() != self.t[name].data_ptr():
                self.t[name].copy_(a)


class _Programs:
    """A runner's programs: their static inputs by shape key, their graphs
    by program key, the keys seen (the traces), and the seal."""

    def __init__(self, tag: str, host_read_tokens: Optional[int] = None):
        self.tag = tag
        self.host_read_tokens = host_read_tokens
        self.graphs: Optional[GraphSet] = None
        self.statics: Dict[tuple, object] = {}
        self.captured: Dict[tuple, object] = {}
        self.seen = set()
        self.sealed = False
        self._said_eager = False

    def bind(self, graphs: Optional[GraphSet]) -> None:
        """Take a new graph set (a new load): every program is built anew,
        and the seal waits for the next warmup()."""
        self.graphs = graphs
        self.statics.clear()
        self.captured.clear()
        self.seen.clear()
        self.sealed = False

    def eager_only(self, tokens_per_row: int) -> bool:
        return self.host_read_tokens is not None and tokens_per_row >= self.host_read_tokens

    def run(self, pkey: tuple, body: Callable, bind: tuple, tokens_per_row: int,
            generator=None, allow_sealed: bool = False):
        """Run program ``pkey``: replay its graph; or, at first use, note
        the trace (raises when sealed), run ``body`` eagerly and capture it.
        Returns (outputs, replayed): a replay's outputs are the graph's
        buffers, which the caller copies out."""
        g = self.captured.get(pkey)
        if g is not None:
            g.check_binding(bind, self.tag)
            g.replay()
            return g.outputs, True
        if pkey not in self.seen:
            note_trace(self.tag, sealed=self.sealed and not allow_sealed)
            self.seen.add(pkey)
        gs = self.graphs
        if gs is None or not gs.enabled:
            return body(), False
        if self.eager_only(tokens_per_row):
            if not self._said_eager:
                self._said_eager = True
                log.info(
                    "%s: programs of %d or more tokens per row run eagerly: the MoE grouped "
                    "route reads its group sizes on the host", self.tag, self.host_read_tokens,
                )
            return body(), False
        scope = gs.scope(self.tag, pkey)
        out = gs.eager(scope, body)
        self.captured[pkey] = gs.capture(scope, body, bind, generator)
        return out, False


class _SealMixin:
    def seal(self):
        """Arm the retrace guard: a later first use of a new step key raises
        RetraceError (decode programs may still capture once). Call after
        warmup() has run every key this runner will serve."""
        self._prog.sealed = True

    @contextmanager
    def seal_suspended(self):
        """Lift the seal while more programs are built after warmup; the
        previous state is restored even on failure."""
        was, self._prog.sealed = self._prog.sealed, False
        try:
            yield self
        finally:
            self._prog.sealed = was

    @property
    def sealed(self) -> bool:
        return self._prog.sealed

    def bind_graphs(self, graphs: Optional[GraphSet]) -> None:
        self._prog.bind(graphs)


class SubModelRunner(_SealMixin):
    def __init__(
        self,
        tag: str,
        phase: str,
        spec: ModelSpec,
        buckets: List[int],
        batch_size: int,
        device: torch.device,
        mlp_fn: Callable,
        block_kv: bool = False,
        block_size: int = 16,
        host_read_tokens: Optional[int] = None,
    ):
        self.tag = tag
        self.phase = phase
        self.spec = spec
        self.buckets = sorted(buckets)
        self.batch_size = batch_size
        self.device = device
        self.mlp_fn = mlp_fn
        self.block_kv = block_kv
        self.block_size = block_size
        # the bucket the last prepare()/decode_chunk resolved to (the serving
        # session's bucket census reads it)
        self.last_bucket: Optional[int] = None
        self._prog = _Programs(tag, host_read_tokens)
        # the chained draft proposals of a spec-ragged session's draft app:
        # first use captures even when sealed (like a decode program)
        self._chain_prog = _Programs(TAG_SPEC_DRAFT_CHAIN)

    def bind_graphs(self, graphs: Optional[GraphSet]) -> None:
        self._prog.bind(graphs)
        self._chain_prog.bind(graphs)

    # ---- static inputs ----------------------------------------------------

    def _step_statics(self, q: int, width: int, fields: Tuple[str, ...]) -> _Statics:
        skey = ("step", q, width, fields)
        st = self._prog.statics.get(skey)
        if st is None:
            B = self.batch_size
            layout = [
                ("input_ids", (B, q), False), ("attention_mask", (B, width), False),
                ("position_ids", (B, q), False), ("seq_ids", (B,), False),
                ("sampling_params", (B, 3), True),
            ]
            if "slot_mapping" in fields:
                layout.append(("slot_mapping", (B, q), False))
            if "block_table" in fields:
                layout.append(("block_table", (B, max(1, width // self.block_size)), False))
            st = self._prog.statics[skey] = _Statics(layout, self.device)
        return st

    def _decode_statics(self, bucket: int, paged: bool) -> Tuple[_Statics, DecodeState]:
        skey = ("decode", bucket, paged)
        ent = self._prog.statics.get(skey)
        if ent is None:
            B = self.batch_size
            layout = [
                ("last", (B, 1), False), ("pos", (B, 1), False), ("seq_ids", (B,), False),
                ("sampling_params", (B, 3), True),
            ]
            if paged:
                layout.append(("block_table", (B, bucket // self.block_size), False))
            st = _Statics(layout, self.device)
            state = DecodeState(
                last=st.t["last"], pos=st.t["pos"], seq_ids=st.t["seq_ids"],
                sampling_params=st.t["sampling_params"],
                cols=torch.arange(bucket, dtype=torch.int32, device=self.device)[None, :],
                block_table=st.t.get("block_table"),
            )
            ent = self._prog.statics[skey] = (st, state)
        return ent

    @staticmethod
    def _step_key(inputs: StepInputs) -> Tuple[int, int, Tuple[str, ...]]:
        fields = tuple(f for f in _OPTIONAL_FIELDS if getattr(inputs, f) is not None)
        return inputs.input_ids.shape[1], inputs.attention_mask.shape[1], fields

    def _inputs_of(self, st: _Statics) -> StepInputs:
        t = st.t
        return StepInputs(
            input_ids=t["input_ids"], attention_mask=t["attention_mask"], position_ids=t["position_ids"],
            seq_ids=t["seq_ids"], sampling_params=t["sampling_params"],
            slot_mapping=t.get("slot_mapping"), block_table=t.get("block_table"),
        )

    # ---- host-side padding ------------------------------------------------

    def prepare(
        self,
        input_ids: np.ndarray,
        attention_mask: np.ndarray,
        position_ids: np.ndarray,
        seq_ids: np.ndarray,
        sampling_params: Optional[np.ndarray] = None,
        slot_mapping: Optional[np.ndarray] = None,
        block_table: Optional[np.ndarray] = None,
    ) -> Tuple[StepInputs, int]:
        """Pad to (compiled batch, bucket) into the key's static buffers and
        return them as StepInputs. ``input_ids`` may be a device tensor (an
        async decode step chained on the previous step's tokens)."""
        B, S = input_ids.shape
        if self.phase == PHASE_CONTEXT_ENCODING:
            bucket = get_target_bucket(self.buckets, S)
            pad_s = bucket - S
            if pad_s:
                input_ids = np.pad(input_ids, ((0, 0), (0, pad_s)))
                attention_mask = np.pad(attention_mask, ((0, 0), (0, pad_s)))
                # pad positions continue the sequence so padded K/V lands in
                # the masked tail, not on real slots
                tail = position_ids[:, -1:] + 1 + np.arange(pad_s)[None, :]
                position_ids = np.concatenate([position_ids, tail], axis=1)
                if slot_mapping is not None:
                    # padded tokens write to the garbage block
                    slot_mapping = np.pad(slot_mapping, ((0, 0), (0, pad_s)), constant_values=-1)
        else:
            # token generation (one token, or a multi-token chunked/prefix
            # prefill pass or prefill window): bucket over the cache width
            bucket = get_target_bucket(self.buckets, attention_mask.shape[1])
            pad_s = bucket - attention_mask.shape[1]
            if pad_s:
                attention_mask = np.pad(attention_mask, ((0, 0), (0, pad_s)))
        self.last_bucket = bucket
        if sampling_params is None:
            sampling_params = prepare_sampling_params(B)
        fields = tuple(
            f for f, a in (("slot_mapping", slot_mapping), ("block_table", block_table)) if a is not None
        )
        st = self._step_statics(input_ids.shape[1], bucket, fields)
        arrs = {
            "input_ids": input_ids, "attention_mask": attention_mask, "position_ids": position_ids,
            "seq_ids": seq_ids, "sampling_params": sampling_params,
        }
        if slot_mapping is not None:
            arrs["slot_mapping"] = slot_mapping
        if block_table is not None:
            arrs["block_table"] = block_table
        st.fill(arrs)
        return self._inputs_of(st), B

    @torch.no_grad()
    def __call__(self, params, cache: Cache, inputs: StepInputs, generator=None) -> StepOutput:
        """Run one step (its graph's replay, or its first, eager run); the
        cache is updated in place. ``generator`` draws the tokens when the
        spec samples."""
        q, width, fields = self._step_key(inputs)
        st = self._step_statics(q, width, fields)
        st.load({
            name: getattr(inputs, name)
            for name in ("input_ids", "attention_mask", "position_ids", "seq_ids", "sampling_params", *fields)
        })
        sampled = bool(self.spec.do_sample and generator is not None)
        gen = generator if sampled else None
        step_inputs = self._inputs_of(st)

        def body():
            out = forward(params, cache, step_inputs, spec=self.spec, phase=self.phase, mlp_fn=self.mlp_fn, generator=gen)
            return out.tokens, out.logits

        pkey = (self.phase, self.batch_size, q, width, fields, sampled)
        (tokens, logits), replayed = self._prog.run(pkey, body, binding(params, cache), q, gen)
        if replayed:
            tokens = tokens.clone()
            logits = logits.clone() if logits is not None else None
        return StepOutput(tokens=tokens, logits=logits, cache=cache)

    @torch.no_grad()
    def decode_chunk(
        self,
        params,
        cache: Cache,
        last,  # (B, 1) np array or device tensor
        pos: np.ndarray,  # (B, 1)
        seq_ids: np.ndarray,
        sampling_params: np.ndarray,
        num_steps: int,
        bucket: int,
        block_table: Optional[np.ndarray] = None,
        generator=None,
    ):
        """``num_steps`` decode steps with device-resident tokens: the
        bucket's one-step program (``models.base.decode_step``), replayed
        once a step, each step's tokens (and logits) copied into the chunk's
        buffers. ``block_table`` (B, bucket // block_size) runs the chunk
        over the PAGED cache; blocks must be allocated for pos + num_steps.
        Returns (tokens (Bc, num_steps), logits | None, cache)."""
        self.last_bucket = bucket
        paged = block_table is not None
        st, state = self._decode_statics(bucket, paged)
        arrs = {"last": last, "pos": pos, "seq_ids": seq_ids, "sampling_params": sampling_params}
        if paged:
            arrs["block_table"] = block_table
        st.fill(arrs)
        sampled = bool(self.spec.do_sample and generator is not None)
        gen = generator if sampled else None

        def body():
            return decode_step(params, cache, state, spec=self.spec, mlp_fn=self.mlp_fn, generator=gen)

        B = self.batch_size
        tokens = torch.empty((B, num_steps), dtype=torch.int32, device=self.device)
        logits = None
        pkey = ("decode", B, bucket, paged, sampled)
        bind = binding(params, cache)
        for j in range(num_steps):
            (tok, lg), _ = self._prog.run(pkey, body, bind, 1, gen, allow_sealed=True)
            tokens[:, j].copy_(tok)
            if lg is not None:
                if logits is None:
                    logits = torch.empty((B, num_steps, lg.shape[-1]), dtype=lg.dtype, device=self.device)
                logits[:, j].copy_(lg)
        return tokens, logits, cache

    @torch.no_grad()
    def draft_chain(
        self,
        params,
        cache: Cache,
        prev_tokens: torch.Tensor,  # (R, spec_width + 1) device verify output
        use_chain: np.ndarray,  # (R, 1)
        p0_base: np.ndarray,  # (R, 1)
        seq_ids: np.ndarray,  # (R,) -1 = not chained (the garbage line)
        sampling_params: np.ndarray,
        num_steps: int,
        bucket: int,
        spec_width: int,
    ) -> torch.Tensor:
        """``num_steps`` greedy draft steps per row chained on a spec mixed
        step's output (``models.base.draft_chain_propose``; the speculative
        session runs k and uses the first k-1 proposals): ONE program per
        (bucket, steps), captured as one graph. The verify
        output is copied into the program's static on the device, never
        through the host; rows not chained propose from token 0 at position
        0 into the garbage line. Returns the proposals (R, num_steps),
        copied out of the graph's buffers."""
        R = self.batch_size
        skey = ("chain", bucket, spec_width)
        ent = self._chain_prog.statics.get(skey)
        if ent is None:
            st = _Statics(
                [
                    ("prev", (R, spec_width + 1), False), ("rows", (3, R, 1), False),
                    ("seq_ids", (R,), False), ("sampling_params", (R, 3), True),
                    ("decode", (2, R, 1), False),
                ],
                self.device,
            )
            state = DecodeState(
                last=st.t["decode"][0], pos=st.t["decode"][1], seq_ids=st.t["seq_ids"],
                sampling_params=st.t["sampling_params"],
                cols=torch.arange(bucket, dtype=torch.int32, device=self.device)[None, :],
            )
            ent = self._chain_prog.statics[skey] = (st, state)
        st, state = ent
        rows = np.zeros((3, R, 1), np.int32)  # fallback last and pos stay 0
        rows[1], rows[2] = use_chain, p0_base
        st.fill({"prev": prev_tokens, "rows": rows, "seq_ids": seq_ids, "sampling_params": sampling_params})
        t = st.t["rows"]

        def body():
            return draft_chain_propose(
                params, cache, state, st.t["prev"], t[0], t[0], t[1], t[2],
                spec=self.spec, num_steps=num_steps, spec_width=spec_width, mlp_fn=self.mlp_fn,
            )

        self.last_bucket = bucket
        pkey = ("chain", R, bucket, num_steps, spec_width)
        out, replayed = self._chain_prog.run(pkey, body, binding(params, cache), 1, allow_sealed=True)
        return out.clone() if replayed else out

    # ---- warmup ----------------------------------------------------------

    def example_inputs(self, bucket: int, q_len: Optional[int] = None) -> StepInputs:
        """A warmup step at one bucket. ``q_len`` builds a multi-token
        token-generation pass (a chunked/prefix prefill pass with both
        slot_mapping and block_table on the paged cache, a prefill window on
        the contiguous one). On the paged cache the warmup writes go to the
        garbage block and the table reads block 0, with the same fields a
        real serving call carries (CTE: slot mapping; decode: block table;
        chunk pass: both)."""
        B = self.batch_size
        S = bucket if self.phase == PHASE_CONTEXT_ENCODING else (q_len or 1)
        kw = {}
        if self.block_kv:
            if self.phase == PHASE_CONTEXT_ENCODING or q_len:
                kw["slot_mapping"] = np.full((B, S), -1, np.int32)
            if self.phase != PHASE_CONTEXT_ENCODING:
                kw["block_table"] = np.zeros((B, max(1, bucket // self.block_size)), np.int32)
        inputs, _ = self.prepare(
            np.zeros((B, S), np.int32), np.ones((B, bucket), np.int32),
            np.tile(np.arange(S, dtype=np.int32), (B, 1)), np.arange(B, dtype=np.int32),
            prepare_sampling_params(B), **kw,
        )
        return inputs

    def _warm_decode(self, params, cache: Cache, bucket: int, generator=None) -> None:
        """Build the bucket's one-step decode program. The reference warms
        each bucket's step only, so this program's write goes where no live
        state is: invalid seq ids send it to the contiguous cache's garbage
        line (kept out of a quantized cache's scales), a zero block table to
        the paged pool's garbage block. Warmup then ends on the reference's
        cache and scales."""
        B = self.batch_size
        table = np.zeros((B, bucket // self.block_size), np.int32) if self.block_kv else None
        self.decode_chunk(
            params, cache, np.zeros((B, 1), np.int32), np.zeros((B, 1), np.int32), np.full(B, -1, np.int32),
            prepare_sampling_params(B), num_steps=1, bucket=bucket, block_table=table, generator=generator,
        )

    def warmup(self, params, cache: Cache, chunk_q_lens: Optional[List[int]] = None, generator=None) -> Cache:
        """Run, and so capture, every bucket's step program (and, for token
        generation, its one-step decode program), then each multi-token pass
        length at the largest bucket, before the first request (the
        reference compiles here). ``generator`` (a sampling spec) also builds
        the sampling programs ``generate()`` runs."""
        gens = [None] + ([generator] if generator is not None and self.spec.do_sample else [])
        for gen in gens:
            for bucket in self.buckets:
                if gen is None or self.phase == PHASE_CONTEXT_ENCODING:
                    cache = self(params, cache, self.example_inputs(bucket), gen).cache
                if self.phase != PHASE_CONTEXT_ENCODING:
                    self._warm_decode(params, cache, bucket, gen)
        for q in chunk_q_lens or ():
            cache = self(params, cache, self.example_inputs(self.buckets[-1], q_len=q)).cache
        return cache


class MixedStepRunner(_SealMixin):
    """Runner of the ragged mixed prefill+decode serving step (the
    reference's ``MixedStepRunner``).

    Its bucket axis is the TOTAL packed query-token count of one serving
    step (prefill chunks and decode rows share it), crossed with the kv-width
    ladder the block table covers: one graph per (total-token bucket, kv
    width). One ``step()`` dispatch replaces the context/decode pair of the
    split path.

    Packing contract: row r's segment starts at ``row_start[r]``, a multiple
    of :attr:`q_tile`, and row index == serving slot == block-table row.
    :meth:`prepare` pads the packed axis to the bucket and the block table
    to the kv width and writes every descriptor into the key's static
    buffers in ONE copy (from pinned memory on a card, so the copy does not
    wait for the step in flight)."""

    def __init__(
        self,
        spec: ModelSpec,
        buckets: List[int],  # total-query-token ladder
        num_rows: int,  # serving slot count (fixed R axis)
        device: torch.device,
        mlp_fn: Callable,
        block_size: int,
        kv_buckets: List[int],  # kv-width ladder (block-aligned decode buckets)
        spec_width: int = 1,
        host_read_tokens: Optional[int] = None,
    ):
        """``spec_width`` > 1 builds the speculative-verification family
        (``mixed_step_spec``, serving_spec_ragged): spec rows pack up to
        ``spec_width`` query tokens (last committed token + drafts) in one
        segment, and the tokens come back (R, spec_width + 1) with the
        accepted count in the last column (``models.base.mixed_forward``).
        ``verify_len`` and the draft matrix are statics of the same program
        key, so a step's draft lengths change data, never the program.
        ``host_read_tokens`` (the builder's): total-token buckets of at least
        this many packed tokens run eagerly (their MoE layers read group
        sizes on the host); their keys are still recorded."""
        from neuronx_distributed_inference_tpu_torch.ops.ragged_paged_attention import RAGGED_Q_TILE

        if not 1 <= spec_width <= RAGGED_Q_TILE:
            raise ValueError(
                f"spec_width {spec_width} out of range [1, {RAGGED_Q_TILE}]: "
                "a spec-verify segment must fit one ragged q tile"
            )
        self.spec_width = spec_width
        self.tag = TAG_MIXED_STEP_SPEC if spec_width > 1 else TAG_MIXED_STEP
        self.spec = spec
        self.buckets = sorted(buckets)
        self.num_rows = num_rows
        self.device = device
        self.mlp_fn = mlp_fn
        self.block_size = block_size
        self.kv_buckets = sorted(kv_buckets)
        self.q_tile = RAGGED_Q_TILE
        self.last_bucket: Optional[int] = None
        self._prog = _Programs(self.tag, host_read_tokens)

    def _statics(self, bucket: int, mb: int) -> _Statics:
        skey = (bucket, mb)
        st = self._prog.statics.get(skey)
        if st is None:
            R = self.num_rows
            layout = [
                ("packed", (4, 1, bucket), False), ("block_table", (R, mb), False),
                ("rows", (4, R), False), ("sampling_params", (R, 3), True),
                ("chain_tokens", (R, 1), False),
            ]
            if self.spec_width > 1:
                layout.append(("draft_tokens", (R, self.spec_width - 1), False))
            st = self._prog.statics[skey] = _Statics(layout, self.device)
        return st

    def _inputs_of(self, st: _Statics) -> MixedStepInputs:
        t = st.t
        spec = self.spec_width > 1
        return MixedStepInputs(
            input_ids=t["packed"][0], position_ids=t["packed"][1], slot_mapping=t["packed"][2],
            block_table=t["block_table"], row_start=t["rows"][0], row_len=t["rows"][1], ctx_len=t["rows"][2],
            sampling_params=t["sampling_params"], chain_src=t["packed"][3], chain_tokens=t["chain_tokens"],
            verify_len=t["rows"][3] if spec else None, draft_tokens=t.get("draft_tokens"),
        )

    def prepare(
        self,
        input_ids: np.ndarray,  # (T,) packed tokens
        positions: np.ndarray,  # (T,) absolute positions; -1 = padded
        slot_mapping: np.ndarray,  # (T,) flat paged write slots; -1 = garbage block
        row_start: np.ndarray,  # (R,)
        row_len: np.ndarray,  # (R,)
        ctx_len: np.ndarray,  # (R,)
        block_table: np.ndarray,  # (R, mb) covering each row's blocks
        width: int,  # kv width bucket (block-aligned)
        sampling_params: Optional[np.ndarray] = None,
        chain_src: Optional[np.ndarray] = None,  # (T,) int32; -1 = host id
        chain_tokens: Optional[torch.Tensor] = None,  # (R, 1) device tokens of the previous step
        verify_len: Optional[np.ndarray] = None,  # (R,) spec_width > 1: window widths
        draft_tokens: Optional[torch.Tensor] = None,  # (R, spec_width - 1) device proposals
    ) -> Tuple[MixedStepInputs, int]:
        """Pad the packed axis to its total-token bucket and the block table
        to ``width // block_size`` columns, into the key's static buffers.
        Returns (inputs, T_real). Without ``chain_src`` the chain sources
        are all -1 (every id as the host wrote it), so the synchronous and
        the pipelined step run the same program. On a ``spec_width > 1``
        runner ``verify_len`` defaults to all ones and ``draft_tokens``,
        which another program wrote, is copied into its static on the
        device; ``chain_src`` then indexes the flattened draft matrix."""
        T = int(input_ids.shape[0])
        bucket = get_target_bucket(self.buckets, max(T, self.q_tile))
        R = self.num_rows
        mb = max(1, width // self.block_size)
        if block_table.shape[0] != R:
            raise ValueError(f"{self.tag}: block table has {block_table.shape[0]} rows, built for {R}")
        if block_table.shape[1] > mb:
            raise ValueError(
                f"{self.tag}: block table covers {block_table.shape[1]} blocks > width "
                f"bucket {width} ({mb} blocks)"
            )
        if chain_src is None:
            chain_src = np.full(T, -1, np.int32)
        if sampling_params is None:
            sampling_params = prepare_sampling_params(R)
        st = self._statics(bucket, mb)
        buf, v = st.host()
        packed = v["packed"][:, 0]
        packed[1:, T:] = -1
        for i, a in enumerate((input_ids, positions, slot_mapping, chain_src)):
            packed[i, :T] = a
        v["block_table"][:, : block_table.shape[1]] = block_table
        v["rows"][0], v["rows"][1], v["rows"][2] = row_start, row_len, ctx_len
        v["rows"][3] = 1 if verify_len is None else verify_len
        v["sampling_params"][:] = sampling_params
        t = torch.from_numpy(buf)
        if st.flat.is_cuda:
            st.flat.copy_(t.pin_memory(), non_blocking=True)
        else:
            st.flat.copy_(t)
        if chain_tokens is not None:
            st.t["chain_tokens"].copy_(chain_tokens)
        if draft_tokens is not None:
            st.t["draft_tokens"].copy_(draft_tokens)
        self.last_bucket = bucket
        return self._inputs_of(st), T

    @torch.no_grad()
    def __call__(self, params, cache: Cache, inputs: MixedStepInputs) -> StepOutput:
        """Run one mixed step (its graph's replay, or its first, eager run);
        the cache is updated in place."""
        bucket, mb = inputs.input_ids.shape[1], inputs.block_table.shape[1]
        st = self._statics(bucket, mb)
        if inputs.input_ids.data_ptr() != st.t["packed"].data_ptr():
            # inputs built outside prepare(): copy them into the key's buffers
            src = inputs.chain_src if inputs.chain_src is not None else torch.full_like(inputs.input_ids, -1)
            vl = inputs.verify_len if inputs.verify_len is not None else torch.ones_like(inputs.row_len)
            fields = {
                "packed": torch.stack([inputs.input_ids, inputs.position_ids, inputs.slot_mapping, src]).to(torch.int32),
                "block_table": inputs.block_table,
                "rows": torch.stack([inputs.row_start, inputs.row_len, inputs.ctx_len, vl]).to(torch.int32),
                "sampling_params": inputs.sampling_params,
            }
            if inputs.chain_tokens is not None:
                fields["chain_tokens"] = inputs.chain_tokens
            if inputs.draft_tokens is not None and self.spec_width > 1:
                fields["draft_tokens"] = inputs.draft_tokens
            st.load(fields)
        step_inputs = self._inputs_of(st)

        def body():
            out = mixed_forward(
                params, cache, step_inputs, spec=self.spec, mlp_fn=self.mlp_fn, spec_width=self.spec_width
            )
            return out.tokens, out.logits

        # the MoE route reads the packed axis as one row of `bucket` tokens
        (tokens, logits), replayed = self._prog.run(("mixed", bucket, mb), body, binding(params, cache), bucket)
        if replayed:
            tokens = tokens.clone()
            logits = logits.clone() if logits is not None else None
        return StepOutput(tokens=tokens, logits=logits, cache=cache)

    # ---- warmup ----------------------------------------------------------

    def example_inputs(self, bucket: int, width: Optional[int] = None) -> MixedStepInputs:
        """A warmup step at one total-token bucket: as many rows as fit claim
        one q-tile decode segment each, their writes going to the garbage
        block and their reads off block 0, with the fields and shapes of a
        real serving call."""
        width = width if width is not None else self.kv_buckets[-1]
        R, tq = self.num_rows, self.q_tile
        n_fit = min(R, bucket // tq)
        ids = np.zeros(bucket, np.int32)
        pos = np.full(bucket, -1, np.int32)
        sm = np.full(bucket, -1, np.int32)
        row_start = np.zeros(R, np.int32)
        row_len = np.zeros(R, np.int32)
        ctx_len = np.zeros(R, np.int32)
        row_start[:n_fit] = np.arange(n_fit) * tq
        row_len[:n_fit] = 1
        ctx_len[:n_fit] = 1
        pos[row_start[:n_fit]] = 0
        bt = np.zeros((R, max(1, width // self.block_size)), np.int32)
        inputs, _ = self.prepare(ids, pos, sm, row_start, row_len, ctx_len, bt, width)
        return inputs

    def warmup(self, params, cache: Cache) -> Cache:
        """Run, and so capture, every total-token bucket at the largest kv
        width (kernel builds included); smaller widths are captured at first
        use, as the reference compiles them."""
        for bucket in self.buckets:
            cache = self(params, cache, self.example_inputs(bucket)).cache
        return cache
