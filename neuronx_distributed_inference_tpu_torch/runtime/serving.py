"""Continuous-batching serving session (counterpart of the reference's
``runtime/serving.py::ServingSession``), on the split path and the ragged
mixed-step path.

A :class:`ServingSession` owns the KV slot table of an application built
with ``is_continuous_batching``:

- ``add_request`` validates a request, assigns a free slot and prefills it
  (the whole prompt through the context-encoding runner, only the uncached
  suffix on a prefix-cache hit, or nothing yet under chunked prefill);
- ``step`` runs one batched PREFILL-CHUNK pass for requests with prompt
  tokens pending (chunked prefill), then one decode pass for every decoding
  request — synchronously, or 1-ahead (``async_mode``): step k+1 is
  dispatched on step k's tokens still on the device before step k is
  fetched;
- ``run_to_completion`` drains the session, in multi-step device chunks
  once every live request is decoding.

With ``serving_ragged`` each ``step`` is instead ONE mixed dispatch
(:meth:`ServingSession._ragged_step`): the admitted prefill chunks and every
decoding row pack on one query axis and run one ragged paged attention
launch (B3) per layer, synchronously or 1-ahead (``serving_ragged_async``).

The split path runs over the paged cache (chunk passes through the B5 paged
flash kernel, decode through B4, admission without chunking through B2) and
over the contiguous cache (B2 and B1). Fault containment follows the reference:
typed admission verdicts, preemption on pool exhaustion with re-admission
ahead of new arrivals, deadlines, bounded dispatch retry, row quarantine
with a KV scrub, and a no-progress watchdog.

:class:`SpeculativeServingSession` serves with a draft app: on the
contiguous cache the draft proposes and the target verifies in two
dispatches per step (the split path); with ``serving_spec_ragged`` the
verification rides the one mixed dispatch as spec-verify rows and the
draft's next proposals chain on its output on the device.

The port updates the cache in place where the reference rebinds a new one.
A prompt longer than the largest context bucket is admitted on the
contiguous cache in windows (:meth:`ServingSession._windowed_admit`). A
request context-encoded on a disaggregated prefill replica is admitted
with its handed-over KV line (:meth:`ServingSession.add_prefilled_request`,
``runtime/disaggregated.py``); the router (``runtime/router.py``) serves
over several sessions.

The runners replay captured CUDA graphs (``runtime/model_runner.py``);
every step's tokens are copied out of the graph's buffers when it returns,
so a 1-ahead step's pending tokens are never overwritten by the next replay.
"""

from __future__ import annotations

import json
import time
from collections import Counter, deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from neuronx_distributed_inference_tpu_torch.modules.autobucketing import (
    get_target_bucket,
    pow2_bucket,
)
from neuronx_distributed_inference_tpu_torch.modules.kvcache import PAD_POSITION_SENTINEL
from neuronx_distributed_inference_tpu_torch.modules.sampling import prepare_sampling_params
from neuronx_distributed_inference_tpu_torch.runtime.faults import (
    RETRYABLE_DISPATCH_ERRORS,
    WatchdogError,
    fill_kv_rows,
)
from neuronx_distributed_inference_tpu_torch.telemetry.tracing import default_session

#: request lifecycle statuses. ACTIVE = holds a slot; WAITING = preempted and
#: queued for re-admission (ahead of new arrivals); the rest are terminal.
STATUS_ACTIVE = "active"
STATUS_WAITING = "waiting"
STATUS_FINISHED = "finished"
STATUS_FAILED = "failed"
STATUS_REJECTED = "rejected"

#: finish reasons that mark a request FAILED rather than FINISHED
FAILURE_REASONS = frozenset({"non_finite", "dispatch_error", "deadline_exceeded", "preempted", "handoff"})

#: capped exponential backoff for transient dispatch retries
DISPATCH_BACKOFF_BASE_S = 0.02
DISPATCH_BACKOFF_CAP_S = 0.5

#: ``session.rejected`` keeps this many recent REJECTED requests (rejection
#: volume is caller-controlled, so the record must stay bounded)
REJECTED_HISTORY_MAX = 1024


@dataclass(frozen=True)
class AdmissionResult:
    """Typed verdict from :meth:`ServingSession.add_request`; truthy when
    admitted, falsy with a ``reason`` otherwise (``no_slot`` / ``kv_blocks``
    / ``backlog`` for capacity, or a validation reason — then the request
    is terminal REJECTED and queryable via ``session.rejected``)."""

    admitted: bool
    reason: Optional[str] = None

    def __bool__(self) -> bool:
        return self.admitted


ADMITTED = AdmissionResult(True)


@dataclass(eq=False)  # identity: the readmit queue removes by identity
class Request:
    req_id: str
    input_ids: np.ndarray  # (S,) effective prompt (re-admission folds
    # previously generated tokens in; `absorbed` counts them)
    max_new_tokens: int = 64
    eos_token_id: Optional[int] = None
    slot: int = -1
    pos: int = 0  # next write position
    prefill_pos: int = 0  # prompt tokens already in the KV cache
    generated: List[int] = field(default_factory=list)
    finished: bool = False
    preempted: bool = False  # currently evicted (queued for re-admission)
    status: str = STATUS_ACTIVE
    fail_reason: Optional[str] = None  # set when status == failed/rejected
    deadline_s: Optional[float] = None  # wall-clock TTL from submission
    t_submit: float = 0.0  # session-clock submission time
    preemptions: int = 0  # pool-exhaustion evictions survived
    absorbed: int = 0  # generated tokens folded into input_ids (re-admission)
    epoch: int = 0  # bumped per eviction: stale in-flight rows are discarded
    # spec-ragged speculation (SpeculativeServingSession): draft_ready once
    # the draft's cache line holds the prompt (cleared by preemption: the
    # line is prefilled again after re-admission); draft_len the current
    # adaptive draft length, on the session's fixed ladder; accept_ewma the
    # acceptance-rate EWMA the policy steers by
    draft_ready: bool = False
    draft_len: int = 0
    accept_ewma: float = 1.0

    @property
    def prompt_len(self) -> int:
        return int(self.input_ids.shape[0])

    @property
    def prefilling(self) -> bool:
        return not self.finished and self.prefill_pos < self.prompt_len

    @property
    def last_token(self) -> int:
        return self.generated[-1] if self.generated else int(self.input_ids[-1])


class ServingSession:
    #: this session admits requests prefilled elsewhere (the router's
    #: disaggregated prefill tier reads it); the speculative session cannot
    prefilled_admission = True

    def __init__(
        self,
        app,
        telemetry=None,
        fault_injector=None,
        clock: Optional[Callable[[], float]] = None,
        sleep_fn: Optional[Callable[[float], None]] = None,
    ):
        """``telemetry``: a :class:`~..telemetry.TelemetrySession` (default:
        the inert process default). ``fault_injector``: a
        :class:`~.faults.FaultInjector` whose armed faults fire at this
        session's host boundaries (tests). ``clock``/``sleep_fn``: the
        wall-clock source for deadlines and backoff (default
        ``time.monotonic`` / ``time.sleep``)."""
        self.app = app
        self.tel = telemetry if telemetry is not None else default_session()
        tc = app.config.torch_config
        self.faults = fault_injector
        self._clock = clock if clock is not None else time.monotonic
        self._sleep = sleep_fn if sleep_fn is not None else time.sleep
        self.admission_validation = bool(tc.admission_validation)
        self.deadline_s = tc.request_deadline_s
        self.max_dispatch_retries = int(tc.dispatch_max_retries)
        self.watchdog_steps = int(tc.watchdog_no_progress_steps)
        self.rejected: Dict[str, Request] = {}  # terminal REJECTED requests
        self._readmit: deque = deque()  # preempted, aged ahead of arrivals
        self._step_index = 0
        self._no_progress = 0
        self._watchdog_fired = False
        self._prefilled_total = 0  # monotone: prompt tokens written
        self._committed_total = 0  # monotone: tokens committed to requests
        self._terminal_total = 0  # monotone: requests reaching a terminal state
        self._last_dispatch_error: Optional[str] = None
        # a router-managed session carries its replica id (set by
        # ReplicaHandle), so its step-timing and watchdog records land on
        # the replica's timeline track; a standalone session keeps None
        self._tel_replica: Optional[int] = None
        #: device passes this session ran, by kind: "prefill" (context
        #: encoding), "prefill_chunk" (chunked/prefix prefill passes),
        #: "decode_steps" (decode iterations, one per layer stack, chunked
        #: drains counted per step they ran) and "mixed_step" (ragged mixed
        #: dispatches)
        self.dispatches: Counter = Counter()
        if not tc.is_continuous_batching:
            raise ValueError("ServingSession requires is_continuous_batching=True")
        self.num_slots = tc.kv_cache_batch_size or tc.max_batch_size
        self.slots: List[Optional[Request]] = [None] * self.num_slots
        self.requests: Dict[str, Request] = {}
        self.block_mode = tc.is_block_kv_layout
        self.prefix_caching = tc.is_prefix_caching
        self.chunked = tc.is_chunked_prefill
        cpc = tc.chunked_prefill_config
        self.chunk_size = cpc.kernel_q_tile_size if cpc else 128
        self.max_prefill_seqs = cpc.max_num_seqs if cpc else 8
        self.allocator = None
        self.block_bytes = 0
        if self.block_mode:
            from neuronx_distributed_inference_tpu_torch.modules.block_kvcache import (
                BlockAllocator,
                PrefixCachingAllocator,
                kv_block_bytes,
            )

            if tc.pa_num_blocks is None:
                raise RuntimeError(
                    "pa_num_blocks is unresolved — load the application "
                    "(init_kv_cache sizes the pool from pa_pool_bytes and "
                    "the cache dtype) before creating a ServingSession"
                )
            cls = PrefixCachingAllocator if self.prefix_caching else BlockAllocator
            self.allocator = cls(tc.pa_num_blocks, tc.pa_block_size)
            self.block_bytes = kv_block_bytes(
                app.spec.num_layers, tc.pa_block_size, app.spec.attn.num_kv_heads,
                app.spec.attn.head_dim, tc.kv_dtype,
            )
        # async 1-ahead decode: the decode step dispatched last step(), not
        # yet fetched — (device tokens (B, 1), [(req, pos, slot, epoch), ...])
        self._pending = None
        self.async_decode = bool(tc.async_mode)
        self._sampling_cache: Optional[np.ndarray] = None
        # ragged mixed-step dispatch (serving_ragged): step() packs admitted
        # prefill chunks AND decoding rows into ONE dispatch of the
        # mixed-step runner. Its 1-ahead form (serving_ragged_async, default
        # async_mode) chains step k+1's decode rows on step k's tokens still
        # on the device and consumes step k one step() late
        self.ragged = bool(tc.serving_ragged)
        self.mixed_runner = None
        self.ragged_async = False
        # per-slot block-table rows ((R, MB_max) matrix + per-slot block
        # counts), refreshed on every allocator mutation: the per-step
        # descriptor build reads it instead of walking the allocator
        self._bt_matrix: Optional[np.ndarray] = None
        self._bt_count: Optional[np.ndarray] = None
        # blocking-fetch wait inside the current _ragged_step (the step's
        # wall time minus this is host time)
        self._step_fetch_wait_s = 0.0
        if self.ragged:
            self.mixed_runner = getattr(app, "mixed_step_model", None)
            if self.mixed_runner is None:
                raise ValueError(
                    "serving_ragged=True but the application carries no "
                    "mixed_step program family (build the app with the same "
                    "config that constructs this session)"
                )
            if self.mixed_runner.spec_width > 1 and not isinstance(self, SpeculativeServingSession):
                raise ValueError(
                    "this app's mixed_step family is the SPEC-VERIFY "
                    "variant (serving_spec_ragged): construct a "
                    "SpeculativeServingSession with a draft app — a plain "
                    "session would misread the (R, spec_width+1) token "
                    "layout"
                )
            # the split path's 1-ahead decode stays off: the ragged pipeline
            # has its own pending-step consume (_consume_ragged)
            self.async_decode = False
            ra = tc.serving_ragged_async
            self.ragged_async = bool(tc.async_mode) if ra is None else bool(ra)
            mb_max = max(
                1, -(-max(app.token_generation_model.buckets[-1], tc.seq_len) // tc.pa_block_size)
            )
            self._bt_matrix = np.zeros((self.num_slots, mb_max), np.int32)
            self._bt_count = np.zeros(self.num_slots, np.int64)
        self.tel.pool_gauges(0, self.kv_pool_bytes, self.kv_free_bytes)

    @property
    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    @property
    def kv_pool_bytes(self) -> int:
        """Total block-pool bytes in the cache dtype (0 off block mode)."""
        if not self.block_mode:
            return 0
        return self.allocator.num_blocks * self.block_bytes

    @property
    def kv_free_bytes(self) -> int:
        """Free pool capacity in bytes; prefix-caching pools count their
        evictable blocks too (allocation evicts them on demand)."""
        if not self.block_mode:
            return 0
        reclaimable = len(getattr(self.allocator, "evictable", ()))
        return (len(self.allocator.free) + reclaimable) * self.block_bytes

    # ---- admission -------------------------------------------------------

    def add_request(
        self,
        req_id: str,
        input_ids: np.ndarray,
        max_new_tokens: int = 64,
        eos_token_id: Optional[int] = None,
        deadline_s: Optional[float] = None,
    ) -> AdmissionResult:
        """Admit one request into a free slot. Malformed requests get a
        terminal REJECTED verdict instead of raising mid-batch;
        ``deadline_s`` overrides the config's ``request_deadline_s``."""
        req = self._new_request(req_id, input_ids, max_new_tokens, eos_token_id, deadline_s)
        bounce = self._front_door(req)
        if bounce is not None:
            return bounce
        return self._admit(req, self.free_slots[0])

    def admission_capacity(self) -> Optional[str]:
        """Capacity pre-check for callers that pay for work BEFORE admitting
        (the router's hand-off runs a whole prefill pass before
        :meth:`add_prefilled_request`): the aging and capacity legs of
        :meth:`_front_door` without a request, ``"backlog"`` / ``"no_slot"``
        / None (would admit). Advisory: the admission re-runs the gate."""
        self._readmit_preempted()
        if self._readmit:
            return "backlog"
        if not self.free_slots:
            return "no_slot"
        return None

    def add_prefilled_request(
        self,
        req_id: str,
        input_ids: np.ndarray,
        kv_payload: Dict,
        first_token: int,
        max_new_tokens: int = 64,
        eos_token_id: Optional[int] = None,
        deadline_s: Optional[float] = None,
    ) -> AdmissionResult:
        """Admit a request whose prompt was context-encoded on a
        disaggregated prefill replica: validate the handed-over KV payload,
        write it into a free cache line (:func:`~.disaggregated.
        inject_request_kv`) and commit ``first_token`` as the first
        generated token; decode then runs as after a local prefill.

        A payload that fails validation (corrupt, truncated, wrong format:
        :func:`~.disaggregated.validate_handoff_payload`) admits and then
        terminally fails ONLY this request, typed ``FAILED(handoff)``, its
        line zero-scrubbed; co-batched rows are untouched, and the truthy
        return carries a request whose verdict is readable in
        ``session.requests``. Capacity refusals and validation rejects are
        :meth:`add_request`'s."""
        from neuronx_distributed_inference_tpu_torch.runtime.disaggregated import (
            inject_request_kv,
            validate_handoff_payload,
        )

        if self.block_mode:
            raise ValueError(
                "add_prefilled_request scatters whole contiguous cache "
                "lines: the paged cache is not supported (config validation "
                "forbids router_prefill_replicas with is_block_kv_layout)"
            )
        req = self._new_request(req_id, input_ids, max_new_tokens, eos_token_id, deadline_s)
        bounce = self._front_door(req)
        if bounce is not None:
            return bounce
        slot = self.free_slots[0]
        req.slot = slot
        req.status = STATUS_ACTIVE
        self.slots[slot] = req
        self.requests[req.req_id] = req
        self.tel.request_admitted(req.req_id)
        bad = validate_handoff_payload(self.app, kv_payload, 1, req.prompt_len)
        if bad is not None:
            # ONE request dies, typed; its line (never written) is scrubbed
            # before it recycles. The validator's cause labels the failure
            # counter; the request keeps the verdict "handoff"
            self.tel.handoff_failure(req.req_id, bad)
            self._finish(req, "handoff", scrub=True)
            return ADMITTED
        inject_request_kv(self.app, np.array([slot], np.int32), kv_payload)
        req.prefill_pos = req.prompt_len
        self._note_prefill(req, req.prompt_len)
        self.tel.step("prefill")
        self.tel.pool_gauges(len(self.active), self.kv_pool_bytes, self.kv_free_bytes)
        self._finish_prefill(req, first_token)
        return ADMITTED

    def _new_request(self, req_id, input_ids, max_new_tokens, eos_token_id, deadline_s) -> Request:
        self.tel.request_submitted(req_id)
        return Request(
            req_id=req_id,
            input_ids=np.asarray(input_ids, np.int32).reshape(-1),
            max_new_tokens=max_new_tokens,
            eos_token_id=eos_token_id,
            deadline_s=deadline_s if deadline_s is not None else self.deadline_s,
            t_submit=self._clock(),
        )

    def _front_door(self, req: Request) -> Optional[AdmissionResult]:
        """Typed validation, then re-admission aging (preempted requests
        re-enter AHEAD of new arrivals), then capacity. Returns a falsy
        verdict to bounce the request, or None when a slot is free."""
        if self.admission_validation:
            reason = self._validate_request(req)
            if reason is not None:
                return self._reject(req, reason)
        self._readmit_preempted()
        if self._readmit:
            self.tel.request_dropped(req.req_id, "backlog")
            return AdmissionResult(False, "backlog")
        if not self.free_slots:
            self.tel.request_dropped(req.req_id, "no_slot")
            return AdmissionResult(False, "no_slot")
        return None

    def _validate_request(self, req: Request) -> Optional[str]:
        if req.prompt_len == 0:
            return "empty_prompt"
        if req.max_new_tokens < 1:
            return "invalid_max_new_tokens"
        ids = req.input_ids
        vocab = int(self.app.config.vocab_size)
        if int(ids.min()) < 0 or int(ids.max()) >= vocab:
            return "token_id_out_of_range"
        if req.prompt_len > self._max_admissible_prompt():
            return "prompt_too_long"
        return None

    def _max_admissible_prompt(self) -> int:
        """Longest prompt admissible without raising mid-batch: one position
        must remain for the first generated token, and a paged cache without
        chunked prefill admits through a single context program."""
        limit = self.app._pos_limit() - 1
        if self.block_mode and not self.chunked:
            limit = min(limit, self.app.context_encoding_model.buckets[-1])
        return limit

    def _reject(self, req: Request, reason: str) -> AdmissionResult:
        req.finished = True
        req.status = STATUS_REJECTED
        req.fail_reason = reason
        self.rejected[req.req_id] = req
        while len(self.rejected) > REJECTED_HISTORY_MAX:
            self.rejected.pop(next(iter(self.rejected)))
        self.tel.request_rejected(req.req_id, reason)
        return AdmissionResult(False, reason)

    def _admit(self, req: Request, slot: int, fresh: bool = True) -> AdmissionResult:
        """Bind ``req`` to ``slot`` and run its admission prefill.
        ``fresh=False`` is re-admission: a capacity failure re-queues."""
        req.slot = slot
        req.status = STATUS_ACTIVE
        req.preempted = False
        req.prefill_pos = 0
        req.pos = 0
        if self.prefix_caching:
            req.prefill_pos = self.allocator.match_prefix(slot, req.input_ids)
            req.pos = req.prefill_pos
            self._bt_sync(slot)
        self.slots[slot] = req
        self.requests[req.req_id] = req
        self.tel.request_admitted(req.req_id, cached_prefix_tokens=req.prefill_pos)

        if self.chunked:
            return ADMITTED  # the prompt runs in chunks inside step()
        if req.prefill_pos > 0:
            # prefix hit: only the uncached suffix runs (prior-KV prefill)
            ok = self._prefill_chunks([req], req.prompt_len - req.prefill_pos)
        else:
            ok = self._full_prefill(req)
        if ok:
            return ADMITTED
        self._release_slot(req)
        if fresh:
            self.requests.pop(req.req_id, None)
            self.tel.request_dropped(req.req_id, "kv_blocks")
        return AdmissionResult(False, "kv_blocks")

    # ---- containment: release/scrub, preempt/re-admit, deadlines, --------
    # ---- watchdog, bounded dispatch retry ---------------------------------

    def _release_slot(self, req: Request, scrub: bool = False):
        """Free a request's KV line/blocks and slot; ``scrub=True`` zeroes
        the released KV first (quarantine), so a poisoned row's NaN cannot
        reach a later request through recycled blocks."""
        if req.slot < 0:
            return
        if self.block_mode:
            if scrub:
                blocks = self.allocator.quarantine_seq(req.slot)
                if blocks:
                    self.app.kv_cache = fill_kv_rows(self.app.kv_cache, blocks, 0.0)
            else:
                self.allocator.free_seq(req.slot)
            self._bt_sync(req.slot)
        elif scrub:
            # one model-parallel shard: slot s owns contiguous cache line s
            self.app.kv_cache = fill_kv_rows(self.app.kv_cache, [req.slot], 0.0)
        self.slots[req.slot] = None
        req.slot = -1

    def _alloc(self, slot: int, num_tokens: int):
        """Allocator gateway: the fault injector forces pool exhaustion here
        without shrinking the real pool."""
        if self.faults is not None and self.faults.pool_exhausted(self):
            raise RuntimeError("out of KV blocks (injected fault)")
        blocks = self.allocator.alloc_seq(slot, num_tokens)
        self._bt_sync(slot)
        return blocks

    def _bt_sync(self, slot: int):
        """Refresh the cached block-table row of ``slot`` from the allocator
        (a no-op unless its block list changed: the steady-state decode step
        allocates nothing and pays one length compare). Called at every
        block-list mutation: alloc, release (free, preempt, quarantine) and
        prefix attach."""
        if self._bt_matrix is None:
            return
        blocks = self.allocator.seq_blocks.get(slot)
        n = len(blocks) if blocks else 0
        if n == int(self._bt_count[slot]):
            return
        row = self._bt_matrix[slot]
        row[:] = 0
        if n:
            m = min(n, row.shape[0])
            row[:m] = blocks[:m]
        self._bt_count[slot] = n

    def _session_sampling_params(self) -> np.ndarray:
        sp = self._sampling_cache
        if sp is None or sp.shape[0] != self.num_slots:
            sp = prepare_sampling_params(self.num_slots)
            self._sampling_cache = sp
        return sp

    def _preempt(self, req: Request):
        """Non-terminal pool-exhaustion eviction: roll back to the committed
        host state (in-flight device steps are discarded; greedy decode
        regenerates them identically), free the slot, and queue for
        re-admission ahead of new arrivals."""
        if req.finished or req.preempted:
            return
        req.preempted = True
        req.preemptions += 1
        req.epoch += 1
        req.status = STATUS_WAITING
        self._release_slot(req)
        self._readmit.append(req)
        self.tel.request_preempted(req.req_id)

    def _readmit_preempted(self) -> int:
        """Re-admit evicted requests (oldest first) into free capacity, the
        committed tokens folded into the prompt. Stops at the first request
        that still cannot fit (FIFO order is the aging guarantee)."""
        n = 0
        while self._readmit and self.free_slots:
            req = self._readmit[0]
            new = req.generated[req.absorbed:]
            if new:
                req.input_ids = np.concatenate([req.input_ids, np.asarray(new, np.int32)])
                req.absorbed += len(new)
            never_fits = req.prompt_len > self._max_admissible_prompt() or (
                self.block_mode
                and -(-req.prompt_len // self.allocator.block_size) > self.allocator.num_blocks
            )
            if never_fits or len(req.generated) >= req.max_new_tokens:
                self._readmit.popleft()
                self._finish(req, "preempted" if len(req.generated) < req.max_new_tokens else None)
                continue
            self._readmit.popleft()
            if not self._admit(req, self.free_slots[0], fresh=False):
                req.preempted = True
                req.status = STATUS_WAITING
                if not self.active:
                    # nothing live will ever free more capacity: terminal
                    self._finish(req, "preempted")
                    continue
                self._readmit.appendleft(req)
                break
            n += 1
        return n

    def _expire_deadlines(self):
        """Drop every live request past its wall-clock TTL (terminal
        ``deadline_exceeded``), checked at step boundaries."""
        now = self._clock()
        live = [r for r in self.slots if r is not None] + list(self._readmit)
        for req in live:
            if req.finished or req.deadline_s is None:
                continue
            overrun = now - (req.t_submit + req.deadline_s)
            if overrun <= 0:
                continue
            if req in self._readmit:
                self._readmit.remove(req)
            self.tel.deadline_exceeded(req.req_id, overrun)
            self._finish(req, "deadline_exceeded")

    def _progress_signature(self):
        return (len(self.requests), self._committed_total, self._terminal_total, self._prefilled_total)

    def _watchdog_tick(self, progressed: bool):
        """After ``watchdog_no_progress_steps`` zero-progress steps with
        live work, preempt the largest request; a second full window with
        still no progress raises WatchdogError with a snapshot."""
        if self.watchdog_steps <= 0:
            return
        if progressed or not (self.active or self._readmit):
            self._no_progress = 0
            self._watchdog_fired = False
            return
        self._no_progress += 1
        if self._no_progress < self.watchdog_steps:
            return
        window = self._no_progress
        self._no_progress = 0
        victim = None
        if not self._watchdog_fired:
            victim = max(self.active, key=lambda r: max(r.pos, r.prefill_pos), default=None)
        if victim is not None:
            self._watchdog_fired = True
            self.tel.watchdog_preempted(victim.req_id)
            self._preempt(victim)
            return
        self.tel.watchdog_tripped(window, replica=self._tel_replica)
        snap = self.diagnostic_snapshot()
        raise WatchdogError(
            f"serving session made no forward progress for {window} consecutive "
            f"steps (zero committed tokens, zero prefill advance, zero "
            f"admissions) after a watchdog preemption already fired. "
            f"Diagnostic snapshot: {json.dumps(snap, default=str)}",
            snapshot=snap,
        )

    def diagnostic_snapshot(self) -> dict:
        return {
            "step_index": self._step_index,
            "watchdog_window": self.watchdog_steps,
            "active": [
                {
                    "req_id": r.req_id, "slot": r.slot, "status": r.status, "pos": r.pos,
                    "prefill_pos": r.prefill_pos, "generated": len(r.generated),
                    "preemptions": r.preemptions,
                }
                for r in self.active
            ],
            "waiting": [r.req_id for r in self._readmit],
            "free_slots": self.free_slots,
            "kv_pool_bytes": self.kv_pool_bytes,
            "kv_free_bytes": self.kv_free_bytes,
            "free_blocks": len(self.allocator.free) if self.block_mode else None,
            "last_dispatch_error": self._last_dispatch_error,
        }

    def _guarded_dispatch(self, label: str, reqs: List[Request], fn, on_give_up=None):
        """Run one device dispatch with bounded-backoff retry. Transient
        errors retry up to ``dispatch_max_retries`` times; exhaustion
        terminally FAILs only the in-flight ``reqs`` and returns None.
        Anything else propagates. ``on_give_up`` runs BEFORE the in-flight
        rows fail: the pipelined ragged path consumes the already-executed
        previous step there, so a request failing at step k+1 keeps its
        step-k token (the order the synchronous path commits in)."""
        attempt = 0
        while True:
            try:
                if self.faults is not None:
                    self.faults.on_dispatch(self, label)
                return fn()
            except RETRYABLE_DISPATCH_ERRORS as e:
                attempt += 1
                if attempt > self.max_dispatch_retries:
                    self._last_dispatch_error = repr(e)
                    if self.faults is not None:
                        self.faults.dispatch_gave_up(self)
                    if on_give_up is not None:
                        on_give_up()
                    for r in reqs:
                        if not r.finished:
                            self._finish(r, "dispatch_error")
                    return None
                self.tel.dispatch_retry(label)
                self._sleep(min(DISPATCH_BACKOFF_CAP_S, DISPATCH_BACKOFF_BASE_S * (2 ** (attempt - 1))))

    def _quarantine(self, req: Request):
        """FAILED(non_finite): only this row dies, its KV scrubbed on
        release."""
        if req.finished:
            return
        self.tel.row_quarantined(req.req_id)
        self._finish(req, "non_finite", scrub=True)

    def _note_prefill(self, req: Request, n: int):
        self._prefilled_total += n
        self.tel.prefill_dispatch(req.req_id, n)

    def _commit_tokens(self, req: Request, n: int):
        self._committed_total += n
        self.tel.request_tokens(req.req_id, n)

    # ---- prefill -----------------------------------------------------------

    def _full_prefill(self, req: Request) -> bool:
        """Whole-prompt context encoding. Other live rows are untouched:
        padded rows carry seq_id -1 / slot -1 (the garbage line or block)."""
        S = req.prompt_len
        cte_max = self.app.context_encoding_model.buckets[-1]
        if S > cte_max and self.block_mode:
            raise ValueError(
                f"prompt of {S} tokens exceeds the largest context program "
                f"({cte_max}) on a paged cache: enable chunked prefill "
                "(is_chunked_prefill) to admit long prompts"
            )
        if S > cte_max:
            self.app.validate_prefill_length(S)
            return self._windowed_admit(req)
        ids = req.input_ids[None, :]
        mask = np.ones((1, S), np.int32)
        pos = np.arange(S, dtype=np.int32)[None, :]
        seq_ids = np.array([req.slot], np.int32)
        slot_mapping = None
        if self.block_mode:
            try:
                self._alloc(req.slot, S)
            except RuntimeError:
                return False  # out of KV blocks
            slot_mapping = self.allocator.slot_mapping(req.slot, np.arange(S))[None, :]
        cte = self.app.context_encoding_model

        def dispatch():
            with self.tel.span("serving.prefill", req_id=req.req_id, tokens=S):
                inputs, _ = cte.prepare(ids, mask, pos, seq_ids, slot_mapping=slot_mapping)
                return cte(self.app.params, self.app.kv_cache, inputs)

        out = self._guarded_dispatch("prefill", [req], dispatch)
        if out is None:
            return True  # terminal FAILED(dispatch_error); slot released
        self.app.kv_cache = out.cache
        self.dispatches["prefill"] += 1
        self.tel.step("prefill")
        self.tel.bucket_dispatch(cte.tag, cte.last_bucket)
        self._note_prefill(req, S)
        self.tel.pool_gauges(len(self.active), self.kv_pool_bytes, self.kv_free_bytes)
        first = int(out.tokens[0, -1].item())
        req.prefill_pos = S
        self._finish_prefill(req, first)
        return True

    def _windowed_admit(self, req: Request) -> bool:
        """Admit a prompt longer than one context program in windows, like
        the app's ``_windowed_prefill`` but SLOT-ALIGNED (the reference's
        ``_windowed_admit``): window 0 through the context program (B=1,
        writing line ``slot``), every later window as a multi-token pass at
        the session's full batch with the request in row == slot, since a
        token-generation pass reads cache line b for row b. Windows are
        padded to the same length with sentinel positions; one host fetch,
        of the last window's token."""
        app = self.app
        S = req.prompt_len
        s = req.slot
        C = app.context_encoding_model.buckets[-1]
        n0 = min(C, S)
        ids0 = req.input_ids[None, :n0]
        pos0 = np.arange(n0, dtype=np.int32)[None, :]
        cte = app.context_encoding_model

        def dispatch_cte():
            with self.tel.span("serving.prefill_windowed", req_id=req.req_id, tokens=n0):
                inputs, _ = cte.prepare(
                    ids0, np.ones((1, n0), np.int32), pos0, np.array([s], np.int32), prepare_sampling_params(1)
                )
                return cte(app.params, app.kv_cache, inputs)

        out = self._guarded_dispatch("prefill_windowed", [req], dispatch_cte)
        if out is None:
            return True  # terminal FAILED(dispatch_error); slot released
        app.kv_cache = out.cache
        self.dispatches["prefill"] += 1
        self.tel.step("prefill")
        self.tel.bucket_dispatch(cte.tag, cte.last_bucket)
        self._note_prefill(req, n0)

        B = self.num_slots
        tkg = app.token_generation_model
        start = n0
        n = 0
        while start < S:
            end = min(start + C, S)
            n = end - start
            ids = np.zeros((B, C), np.int32)
            ids[s, :n] = req.input_ids[start:end]
            pos = np.full((B, C), PAD_POSITION_SENTINEL, np.int32)
            pos[s, :n] = np.arange(start, end, dtype=np.int32)
            width = get_target_bucket(tkg.buckets, end)
            mask = np.ones((B, width), np.int32)
            seq_ids = np.full((B,), -1, np.int32)
            seq_ids[s] = s

            def dispatch_chunk(ids=ids, mask=mask, pos=pos, seq_ids=seq_ids, n=n):
                with self.tel.span("serving.prefill_windowed", req_id=req.req_id, tokens=n):
                    inputs, _ = tkg.prepare(ids, mask, pos, seq_ids, prepare_sampling_params(B))
                    return tkg(app.params, app.kv_cache, inputs)

            out = self._guarded_dispatch("prefill_windowed", [req], dispatch_chunk)
            if out is None:
                return True  # terminal FAILED(dispatch_error); slot released
            app.kv_cache = out.cache
            self.dispatches["prefill_chunk"] += 1
            self.tel.step("prefill")
            self.tel.bucket_dispatch(tkg.tag, tkg.last_bucket)
            self._note_prefill(req, n)
            start = end
        first = int(out.tokens[s, n - 1].item())
        req.prefill_pos = S
        self._finish_prefill(req, first)
        return True

    def _finish_prefill(self, req: Request, first_token: int):
        if first_token < 0:
            # the non-finite sentinel: quarantine instead of committing
            req.pos = req.prompt_len
            self._quarantine(req)
            return
        req.pos = req.prompt_len
        req.generated.append(first_token)
        self._committed_total += 1
        self.tel.request_first_token(req.req_id)
        if self.prefix_caching:
            self.allocator.commit_seq(req.slot, req.input_ids)
        if (req.eos_token_id is not None and first_token == req.eos_token_id) or (
            len(req.generated) >= req.max_new_tokens
        ):
            self._finish(req)

    def _prefill_chunks(self, reqs: List[Request], chunk_size: int, preempt: bool = False) -> bool:
        """One batched prior-KV prefill pass: each request advances by up to
        ``chunk_size`` prompt tokens. The pass runs at the session's full
        batch, row == slot; inactive rows carry slot -1 and a zero table. A
        request that cannot get KV blocks is preempted when ``preempt``
        (step()-driven chunked serving); otherwise the pass returns False
        and the caller drops the request (admission-time prefill)."""
        rows = []
        for req in reqs:
            n = min(chunk_size, req.prompt_len - req.prefill_pos)
            if n <= 0:
                continue
            try:
                self._alloc(req.slot, req.prefill_pos + n)
            except RuntimeError:
                if not preempt:
                    return False
                self._preempt(req)
                continue
            rows.append((req, n))
        if not rows:
            return True

        B = self.num_slots
        qb = pow2_bucket(max(n for _, n in rows))
        bs = self.allocator.block_size
        max_pos = max(r.prefill_pos + n for r, n in rows)
        width = get_target_bucket(self.app.token_generation_model.buckets, max_pos)
        mb = width // bs

        ids = np.zeros((B, qb), np.int32)
        positions = np.zeros((B, qb), np.int32)
        mask = np.zeros((B, width), np.int32)
        slot_mapping = np.full((B, qb), -1, np.int32)
        block_table = np.zeros((B, mb), np.int32)
        seq_ids = np.full((B,), -1, np.int32)
        for req, n in rows:
            s = req.slot
            start = req.prefill_pos
            ids[s, :n] = req.input_ids[start : start + n]
            # padded tail positions continue, so their garbage writes and
            # reads stay in the masked region
            positions[s] = start + np.arange(qb, dtype=np.int32)
            mask[s, : start + n] = 1
            slot_mapping[s, :n] = self.allocator.slot_mapping(s, np.arange(start, start + n))
            block_table[s] = self.allocator.block_table(s, mb)
            seq_ids[s] = s

        tkg = self.app.token_generation_model

        def dispatch():
            with self.tel.span("serving.prefill_chunk", rows=len(rows)):
                inputs, _ = tkg.prepare(
                    ids, mask, positions, seq_ids, self._session_sampling_params(),
                    slot_mapping=slot_mapping, block_table=block_table,
                )
                return tkg(self.app.params, self.app.kv_cache, inputs)

        out = self._guarded_dispatch("prefill_chunk", [r for r, _ in rows], dispatch)
        if out is None:
            return True  # in-flight rows terminally FAILED(dispatch_error)
        self.app.kv_cache = out.cache
        self.dispatches["prefill_chunk"] += 1
        self.tel.step("prefill")
        self.tel.bucket_dispatch(tkg.tag, tkg.last_bucket)
        for req, n in rows:
            self._note_prefill(req, n)
        self.tel.pool_gauges(len(self.active), self.kv_pool_bytes, self.kv_free_bytes)
        tokens = out.tokens.cpu().numpy()

        for req, n in rows:
            req.prefill_pos += n
            if req.prefill_pos >= req.prompt_len:
                # the last prompt token's output IS the first generated token
                self._finish_prefill(req, int(tokens[req.slot, n - 1]))
        return True

    def _finish(self, req: Request, reason: Optional[str] = None, scrub: bool = False):
        # may run twice for one request (a 1-ahead row consumed a step late
        # can hit a termination condition again): count the first only
        already_finished = req.finished
        req.finished = True
        if not already_finished:
            self._terminal_total += 1
            if reason is None:
                reason = (
                    "eos"
                    if (req.eos_token_id is not None and req.generated and req.generated[-1] == req.eos_token_id)
                    else "length"
                )
            if reason in FAILURE_REASONS:
                req.status = STATUS_FAILED
                req.fail_reason = reason
            else:
                req.status = STATUS_FINISHED
            self.tel.request_finished(req.req_id, reason)
        self._release_slot(req, scrub=scrub)

    @property
    def active(self) -> List[Request]:
        return [r for r in self.slots if r is not None]

    @property
    def decoding(self) -> List[Request]:
        return [r for r in self.slots if r is not None and not r.prefilling]

    @property
    def prefilling(self) -> List[Request]:
        return [r for r in self.slots if r is not None and r.prefilling]

    def _is_done(self, req: Request, tok: int) -> bool:
        """Request-termination predicate shared by every consume path."""
        return (
            (req.eos_token_id is not None and tok == req.eos_token_id)
            or len(req.generated) >= req.max_new_tokens
            or req.pos + 1 >= self.app.config.torch_config.seq_len
        )

    # ---- step --------------------------------------------------------------

    def step(self) -> Dict[str, int]:
        """Advance the session: one chunked-prefill pass (if pending) and one
        decode step for every decoding request. Returns {req_id: token} for
        tokens produced this step. Each step also expires deadlines,
        re-admits preempted requests, fires armed faults and feeds the
        watchdog.

        With ``async_mode`` (the default) decode results are consumed one
        step() late: a request's first decode token appears on the step()
        after the one that dispatched it, and each terminating request runs
        one extra device step whose writes land in masked slots and whose
        token is discarded."""
        self._step_index += 1
        # progress baseline BEFORE re-admission: a re-admission commits real
        # tokens, which count as progress
        before = self._progress_signature()
        if self.faults is not None:
            self.faults.on_step_begin(self)
        self._expire_deadlines()
        self._readmit_preempted()
        if self.faults is not None and self.faults.stalled(self):
            results: Dict[str, int] = {}
        else:
            results = self._step_inner()
        progressed = bool(results) or self._progress_signature() != before
        self._watchdog_tick(progressed)
        return results

    def _step_inner(self) -> Dict[str, int]:
        if self.ragged:
            return self._ragged_step()
        results: Dict[str, int] = {}
        prefill_finished: set = set()
        if self.chunked and self.prefilling:
            batch = self.prefilling[: self.max_prefill_seqs]
            before = {r.req_id: len(r.generated) for r in batch}
            self._prefill_chunks(batch, self.chunk_size, preempt=True)
            for r in batch:
                if len(r.generated) > before.get(r.req_id, 0):
                    results[r.req_id] = r.generated[-1]
                    prefill_finished.add(r.req_id)

        # requests that finished prefill THIS step start decoding next step,
        # so their first token isn't overwritten in results
        active = [r for r in self.decoding if r.req_id not in prefill_finished]

        if not self.async_decode:
            if active:
                out, snap = self._dispatch_decode([(r, r.pos) for r in active])
                if out is not None:
                    self._consume((out.tokens[:, -1:], snap), results)
            return results

        # async 1-ahead: dispatch step k+1 CHAINED on step k's tokens still
        # on the device BEFORE fetching step k
        pend = self._pending
        self._pending = None
        # chain only rows whose pending entry is still current (a row
        # preempted or quarantined since carries a stale epoch)
        pend_pos = (
            {
                id(req): p
                for req, p, _s, e in pend[1]
                if e == req.epoch and not req.finished and not req.preempted
            }
            if pend
            else {}
        )
        rows: List = []
        chained_slots: List[int] = []
        for r in active:
            if id(r) in pend_pos:
                rows.append((r, pend_pos[id(r)] + 1))
                chained_slots.append(r.slot)
            else:
                rows.append((r, r.pos))
        if rows:
            last_override = (pend[0], chained_slots) if chained_slots else None
            out2, snap2 = self._dispatch_decode(rows, last_override)
            if out2 is not None:
                self._pending = (out2.tokens[:, -1:], snap2)
        if pend is not None:
            self._consume(pend, results)
        return results

    def _dispatch_decode(self, rows, last_override=None):
        """Dispatch ONE batched decode pass for ``rows`` = [(req, pos), ...]
        without waiting for its result. ``last_override``: (device tokens
        (B, 1) of the pending step, chained slots) — those rows' input
        tokens come from the device, without a host round trip. Returns
        (StepOutput, snapshot rows); StepOutput.tokens is not fetched."""
        B = self.num_slots
        last = np.zeros((B, 1), np.int32)
        pos = np.zeros((B, 1), np.int32)
        seq_ids = np.full((B,), -1, np.int32)
        for r, p in rows:
            last[r.slot, 0] = r.last_token
            pos[r.slot, 0] = p
            seq_ids[r.slot] = r.slot
        block_table = None
        if self.block_mode:
            bs = self.allocator.block_size
            width = get_target_bucket(self.app.token_generation_model.buckets, int(pos.max()) + 1)
            mb = width // bs
            block_table = np.zeros((B, mb), np.int32)
            for r, p in list(rows):
                try:
                    self._alloc(r.slot, p + 1)
                except RuntimeError:
                    # pool exhausted mid-decode: preempt this request so the
                    # others keep running; it resumes byte-identically
                    self._preempt(r)
                    rows.remove((r, p))
                    continue
                block_table[r.slot] = self.allocator.block_table(r.slot, mb)
            if not rows:
                return None, []
        else:
            width = int(pos.max()) + 1
        mask = (np.arange(width)[None, :] <= pos).astype(np.int32)
        last_arr = last
        if last_override is not None:
            pend_tokens, chained = last_override
            ch = np.zeros((B, 1), bool)
            ch[np.asarray(chained, np.int64)] = True
            dev = pend_tokens.device
            last_arr = torch.where(
                torch.from_numpy(ch).to(dev),
                pend_tokens.to(torch.int64),
                torch.from_numpy(last).to(dev, torch.int64),
            )
        tkg = self.app.token_generation_model

        def dispatch():
            with self.tel.span("serving.decode", rows=len(rows)):
                inputs, _ = tkg.prepare(
                    last_arr, mask, pos, seq_ids, self._session_sampling_params(),
                    block_table=block_table,
                )
                return tkg(self.app.params, self.app.kv_cache, inputs)

        out = self._guarded_dispatch("decode", [r for r, _ in rows], dispatch)
        if out is None:
            return None, []  # in-flight rows terminally FAILED(dispatch_error)
        self.app.kv_cache = out.cache
        self.dispatches["decode_steps"] += 1
        self.tel.step("decode")
        self.tel.bucket_dispatch(tkg.tag, tkg.last_bucket)
        self.tel.pool_gauges(len(rows), self.kv_pool_bytes, self.kv_free_bytes)
        return out, [(r, p, r.slot, r.epoch) for r, p in rows]

    def _consume(self, pend, results: Dict[str, int]):
        """Fetch a dispatched decode step and apply termination bookkeeping.
        Rows finished or evicted since the dispatch are discarded; rows
        carrying the non-finite sentinel are quarantined."""
        tokens = pend[0].cpu().numpy()[:, -1]  # the only device sync per step
        if self.faults is not None:
            tokens = self.faults.corrupt_tokens(self, tokens)
        for req, p, slot, epoch in pend[1]:
            if req.finished or req.preempted or req.epoch != epoch:
                continue
            tok = int(tokens[slot])
            if tok < 0:
                self._quarantine(req)
                continue
            req.generated.append(tok)
            self._commit_tokens(req, 1)
            req.pos = p + 1
            results[req.req_id] = tok
            if self._is_done(req, tok):
                self._finish(req)

    # ---- ragged mixed step ---------------------------------------------------

    def _ragged_step(self) -> Dict[str, int]:
        """One RAGGED mixed dispatch: admitted prefill chunks (up to
        ``max_prefill_seqs``, ``chunk_size`` tokens each) and every decoding
        row pack into ONE call of the mixed-step runner, one ragged attention
        launch per layer. Row index == slot; segments are q-tile aligned;
        one consumed host fetch per step. Returns {req_id: token} like the
        split step().

        Pipelined (``ragged_async``): step k+1 is scheduled from each row's
        EFFECTIVE state (its in-flight step counted as done), chained decode
        rows take their input id from step k's tokens on the device, step
        k's device-to-host copy was started at its dispatch, and step k is
        consumed AFTER step k+1 is dispatched, so the host bookkeeping here
        overlaps the device running k+1. Rows preempted or quarantined since
        their dispatch carry a stale epoch: their in-flight token is
        discarded and (greedy) regenerated identically after re-admission."""
        results: Dict[str, int] = {}
        t_step0 = self.tel.clock()
        self._step_fetch_wait_s = 0.0
        pend = self._pending
        self._pending = None
        pend_map: Dict[int, tuple] = {}
        if pend is not None:
            for ent in pend[1]:
                req = ent[0]
                if ent[5] == req.epoch and not req.finished and not req.preempted:
                    pend_map[id(req)] = ent

        rows = self._schedule_mixed(pend_map)
        if not rows:
            if pend is not None:
                self._consume_ragged(pend, results)
            self._note_step_timing(t_step0)
            return results

        mr = self.mixed_runner
        d = self._build_mixed_descriptors(rows)
        chain_tokens = pend[0] if (pend is not None and d["chained"]) else None

        def dispatch():
            with self.tel.span("serving.mixed_step", rows=len(rows), tokens=d["T"]):
                inputs, _ = mr.prepare(
                    d["ids"], d["positions"], d["slot_mapping"], d["row_start"], d["row_len"],
                    d["ctx_len"], d["block_table"], d["width"], self._session_sampling_params(),
                    chain_src=d["chain_src"], chain_tokens=chain_tokens,
                )
                return mr(self.app.params, self.app.kv_cache, inputs)

        consumed = [False]

        def give_up():
            # the previous step already ran on the device: commit it BEFORE
            # the in-flight rows fail, so a request failing at step k+1 keeps
            # its step-k token (the synchronous commit order)
            if pend is not None and not consumed[0]:
                consumed[0] = True
                self._consume_ragged(pend, results)

        out = self._guarded_dispatch("mixed_step", [t[0] for t in rows], dispatch, on_give_up=give_up)
        if out is None:
            # in-flight rows terminally FAILED(dispatch_error); give_up
            # consumed the previous step
            self._note_step_timing(t_step0)
            return results
        self.app.kv_cache = out.cache
        self.dispatches["mixed_step"] += 1
        self.tel.step("mixed")
        self.tel.bucket_dispatch(mr.tag, mr.last_bucket)
        n_prefill = sum(1 for t in rows if t[1] == "prefill")
        real_tokens = int(sum(t[2] for t in rows))
        self.tel.mixed_step(
            prefill_rows=n_prefill, decode_rows=len(rows) - n_prefill,
            padded_slots=mr.last_bucket - real_tokens, query_tokens=real_tokens,
        )
        for req, kind, n, _p0, _c in rows:
            if kind == "prefill":
                self._note_prefill(req, n)
        self.tel.pool_gauges(len(self.active), self.kv_pool_bytes, self.kv_free_bytes)
        snap = [(req, kind, n, p0, req.slot, req.epoch) for req, kind, n, p0, _c in rows]
        step = (out.tokens, snap, _TokenFetch(out.tokens))
        if self.ragged_async:
            self._pending = step
            if pend is not None:
                self._consume_ragged(pend, results)
        else:
            self._consume_ragged(step, results)
        self._note_step_timing(t_step0)
        return results

    def _schedule_mixed(self, pend_map: Dict[int, tuple]) -> List[tuple]:
        """This step's rows [(req, kind, n, p0, chained), ...] from each
        row's EFFECTIVE state: a row with a current pending entry
        (``pend_map``, epoch-matched) is scheduled as if that step had
        committed: its prefill cursor advanced, its decode position + 1, its
        next input id chained from the tokens on the device. With
        pipelining off ``pend_map`` is empty and this is the synchronous
        schedule."""
        rows: List[tuple] = []
        seq_len = self.app.config.torch_config.seq_len
        if self.chunked:
            pref = []
            for r in self.slots:
                if r is None or r.finished:
                    continue
                e = pend_map.get(id(r))
                eff = e[3] + e[2] if (e is not None and e[1] == "prefill") else r.prefill_pos
                if eff < r.prompt_len:
                    pref.append((r, eff))
            for req, eff in pref[: self.max_prefill_seqs]:
                n = min(self.chunk_size, req.prompt_len - eff)
                try:
                    self._alloc(req.slot, eff + n)
                except RuntimeError:
                    # pool exhausted: preempt (re-queued ahead of arrivals)
                    self._preempt(req)
                    continue
                rows.append((req, "prefill", n, eff, False))
        scheduled = {id(t[0]) for t in rows}
        for r in list(self.slots):
            if r is None or r.finished or id(r) in scheduled:
                continue
            e = pend_map.get(id(r))
            if e is not None and e[1] == "prefill":
                eff = e[3] + e[2]
                if eff < r.prompt_len:
                    continue  # still mid-prompt (or waiting for a chunk slot)
                # completed its prompt in flight: its first generated token
                # is on the device; chained decode at position prompt_len
                p0, chained, committed_after = eff, True, len(r.generated) + 1
            elif e is not None:
                p0, chained, committed_after = e[3] + 1, True, len(r.generated) + 1
            else:
                if r.prefilling:
                    continue  # beyond max_prefill_seqs this step
                p0, chained, committed_after = r.pos, False, len(r.generated)
            if chained and (
                committed_after >= r.max_new_tokens or (e[1] == "decode" and e[3] + 2 >= seq_len)
            ):
                # the pending token predictably ends this request (budget or
                # position limit): no speculative row for it. EOS is not
                # predictable: such rows run one extra step whose token is
                # discarded, as on the split path
                continue
            try:
                self._alloc(r.slot, p0 + 1)
            except RuntimeError:
                self._preempt(r)
                continue
            rows.append((r, "decode", 1, p0, chained))
        return rows

    def _build_mixed_descriptors(self, rows: List[tuple]) -> Dict:
        """The packed arrays of one mixed step, vectorized: decode rows (the
        steady-state bulk) with whole-array numpy ops off the cached
        block-table matrix, prefill chunks (at most ``max_prefill_seqs``)
        with one slice write each. Element for element the per-row build
        (pinned by the tests)."""
        rows.sort(key=lambda t: t[0].slot)
        tq = self.mixed_runner.q_tile
        R = self.num_slots
        bs = self.allocator.block_size
        k = len(rows)
        slots = np.fromiter((t[0].slot for t in rows), np.int64, k)
        ns = np.fromiter((t[2] for t in rows), np.int64, k)
        p0s = np.fromiter((t[3] for t in rows), np.int64, k)
        dec = np.fromiter((t[1] == "decode" for t in rows), np.bool_, k)
        chain = np.fromiter((t[4] for t in rows), np.bool_, k)
        seg = -(-ns // tq) * tq  # q-tile-aligned segment sizes
        starts = np.zeros(k, np.int64)
        np.cumsum(seg[:-1], out=starts[1:])
        T = int(seg.sum())
        row_start = np.zeros(R, np.int32)
        row_len = np.zeros(R, np.int32)
        ctx_len = np.zeros(R, np.int32)
        row_start[slots] = starts
        row_len[slots] = ns
        ctx_len[slots] = p0s + ns
        ids = np.zeros(T, np.int32)
        positions = np.full(T, -1, np.int32)
        slot_mapping = np.full(T, -1, np.int32)
        chain_src = np.full(T, -1, np.int32)
        if dec.any():
            dst = starts[dec]
            dslot = slots[dec]
            dpos = p0s[dec]
            # a chained row's host id is a placeholder the device gather replaces
            ids[dst] = np.fromiter((t[0].last_token for t in rows if t[1] == "decode"), np.int64, int(dec.sum()))
            positions[dst] = dpos
            slot_mapping[dst] = self._bt_matrix[dslot, dpos // bs] * bs + dpos % bs
            dchain = chain[dec]
            chain_src[dst[dchain]] = dslot[dchain]
        verify_len = np.ones(R, np.int32)
        n_spec = 0
        spec_dw = self.mixed_runner.spec_width - 1
        for i in np.flatnonzero(~dec):
            req, kind, n, p0, _c = rows[i]
            s0 = int(starts[i])
            pr = np.arange(p0, p0 + n)
            positions[s0 : s0 + n] = pr
            slot_mapping[s0 : s0 + n] = self._bt_matrix[req.slot, pr // bs] * bs + pr % bs
            if kind == "spec":
                # spec-verify segment [last committed token, draft_1..d]: the
                # host writes the first id; the drafts are gathered on the
                # device from the draft's proposal matrix (chain_src indexes
                # its flattened (R, spec_width - 1) layout)
                n_spec += 1
                ids[s0] = req.last_token
                chain_src[s0 + 1 : s0 + n] = req.slot * spec_dw + np.arange(n - 1, dtype=np.int32)
                verify_len[req.slot] = n
            else:
                ids[s0 : s0 + n] = req.input_ids[p0 : p0 + n]
        width = get_target_bucket(self.app.token_generation_model.buckets, int((p0s + ns).max()))
        mb = max(1, width // bs)
        block_table = np.zeros((R, mb), np.int32)
        take = min(mb, self._bt_matrix.shape[1])
        block_table[:, :take] = self._bt_matrix[:, :take]
        return {
            "T": T, "ids": ids, "positions": positions, "slot_mapping": slot_mapping,
            "row_start": row_start, "row_len": row_len, "ctx_len": ctx_len,
            "block_table": block_table, "width": width, "chain_src": chain_src,
            "chained": bool(chain.any()), "verify_len": verify_len, "spec_rows": n_spec,
        }

    def _consume_ragged(self, pend, results: Dict[str, int]):
        """Fetch one dispatched mixed step (its copy started at dispatch, so
        the wait is only what the overlap did not cover) and apply the
        commit and termination bookkeeping. Rows whose request finished or
        was evicted since the dispatch (stale epoch) are discarded; rows
        carrying the non-finite sentinel are quarantined."""
        t0 = self.tel.clock()
        tokens = pend[2].wait()  # (R, 1)
        self._step_fetch_wait_s += self.tel.clock() - t0
        if self.faults is not None:
            tokens = self.faults.corrupt_tokens(self, tokens)
        for req, kind, n, p0, slot, epoch in pend[1]:
            if req.finished or req.preempted or req.epoch != epoch:
                continue
            tok = int(tokens[slot, 0])
            if kind == "prefill":
                req.prefill_pos = p0 + n
                if req.prefill_pos >= req.prompt_len:
                    # the last prompt token's output IS the first generated
                    # token (as in _prefill_chunks)
                    self._finish_prefill(req, tok)
                    if req.status != STATUS_FAILED:  # not quarantined
                        results[req.req_id] = tok
                continue
            if tok < 0:
                # non-finite sentinel: only this row dies
                self._quarantine(req)
                continue
            req.generated.append(tok)
            self._commit_tokens(req, 1)
            req.pos = p0 + 1
            results[req.req_id] = tok
            if self._is_done(req, tok):
                self._finish(req)

    def _note_step_timing(self, t_step0: float):
        """Host-vs-device split of this ragged step: everything but the
        blocking part of the token fetch is host bookkeeping (descriptor
        build, admission, commits, telemetry)."""
        if not self.tel.enabled:
            return
        total_s = self.tel.clock() - t_step0
        wait_s = min(self._step_fetch_wait_s, total_s)
        self.tel.step_timing((total_s - wait_s) * 1e3, wait_s * 1e3, replica=self._tel_replica)

    # ---- drain ---------------------------------------------------------------

    def run_to_completion(self, decode_chunk_size: int = 16) -> Dict[str, List[int]]:
        """Drain the session. When every live request is decoding, decode
        runs in MULTI-STEP device chunks (one host sync per
        ``decode_chunk_size`` tokens, or one for the whole drain when no
        request has an EOS), on the contiguous and the paged cache. Requests
        that hit EOS mid-chunk overshoot by up to a chunk of discarded
        tokens. On the ragged path every step is one mixed dispatch: the
        multi-step decode chunks would bring back the split."""
        if self.ragged:
            while self.active or self._readmit:
                self.step()
            return {rid: r.generated for rid, r in self.requests.items()}
        while self.active or self._readmit:
            self._expire_deadlines()
            if not self.active:
                self.step()  # only evicted requests remain: step() re-admits
                continue
            if self.prefilling or decode_chunk_size <= 1 or not self.decoding:
                self.step()
                continue
            if all(r.eos_token_id is None for r in self.decoding):
                self._decode_drain()
            else:
                self._decode_chunk_pass(decode_chunk_size)
        return {rid: r.generated for rid, r in self.requests.items()}

    def _chunk_block_table(self, rows, chunk: int, bucket: int):
        """Paged-cache chunk prep: allocate blocks for every row's next
        NEEDED positions (lockstep surplus steps of rows that finish early
        write to table-zero entries, the garbage block) and build the
        (B, bucket // bs) table. Returns None when the pool is exhausted
        (the per-step path preempts). ``rows`` = [(slot, pos, remaining)]."""
        mb = bucket // self.allocator.block_size  # TKG buckets are block multiples
        table = np.zeros((self.num_slots, mb), np.int32)
        for slot, pos, remaining in rows:
            try:
                self.allocator.alloc_seq(slot, pos + min(chunk, remaining))
            except RuntimeError:
                return None
            table[slot] = self.allocator.block_table(slot, mb)
        return table

    def _decode_drain(self):
        """Drain every decoding request (no EOS) in chained multi-step
        chunks with ONE host sync at the end: rows that finish early keep
        computing masked, discarded tokens."""
        if self._pending is not None:
            self._consume(self._pending, {})
            self._pending = None
        active = self.decoding
        if not active:
            return
        B = self.num_slots
        last = np.zeros((B, 1), np.int32)
        pos0 = np.zeros((B, 1), np.int32)
        seq_ids = np.full((B,), -1, np.int32)
        pos_limit = self.app._pos_limit()
        need = {}
        for r in list(active):
            n = min(r.max_new_tokens - len(r.generated), pos_limit - 1 - r.pos)
            if n < 1:
                self._finish(r)  # at the sequence/length bound already
                active.remove(r)
                continue
            last[r.slot, 0] = r.last_token
            pos0[r.slot, 0] = r.pos
            seq_ids[r.slot] = r.slot
            need[r.slot] = n
        if not active:
            return
        total = max(need.values())
        last_dev = torch.from_numpy(last).to(self.app.device)
        pos = pos0.copy()
        chunks = []
        done = 0
        runner = self.app.token_generation_model
        while done < total:
            headroom = pos_limit - 1 - int(pos.max())
            chunk = pow2_bucket(min(total - done, 32))
            if chunk > headroom:
                chunk = min(total - done, headroom)
            if chunk < 1:
                break
            bucket = self.app._decode_bucket(int(pos.max()) + chunk)
            block_table = None
            if self.block_mode:
                block_table = self._chunk_block_table(
                    [(r.slot, int(pos[r.slot, 0]), need[r.slot] - done) for r in active],
                    chunk, bucket,
                )
                if block_table is None:
                    # pool exhausted mid-drain: consume what ran; with no
                    # progress at all, one per-step pass preempts a request
                    if not chunks:
                        self.step()
                        return
                    break

            def dispatch(last_dev=last_dev, pos=pos, chunk=chunk, bucket=bucket, block_table=block_table):
                with self.tel.span("serving.decode_chunk", steps=chunk):
                    return runner.decode_chunk(
                        self.app.params, self.app.kv_cache, last_dev, pos, seq_ids,
                        self._session_sampling_params(), num_steps=chunk, bucket=bucket,
                        block_table=block_table,
                    )

            res = self._guarded_dispatch("decode_chunk", active, dispatch)
            if res is None:
                if not chunks:
                    return
                break
            tokens_c, _, cache = res
            self.app.kv_cache = cache
            self.dispatches["decode_steps"] += chunk
            self.tel.step("decode")
            self.tel.bucket_dispatch(runner.tag, bucket)
            take = min(chunk, total - done)
            chunks.append(tokens_c[:, :take])
            last_dev = tokens_c[:, take - 1 : take]
            pos = pos + take
            done += take
        toks = torch.cat(chunks, dim=1).cpu().numpy()  # ONE sync
        if self.faults is not None:
            toks = self.faults.corrupt_tokens(self, toks)
        done = toks.shape[1]
        # rows advance in lockstep, so the highest-position row's headroom
        # caps this pass; rows needing more loop back through
        # run_to_completion
        for r in active:
            if r.finished or r.preempted:
                continue
            n = min(need[r.slot], done)
            row_toks = toks[r.slot, :n]
            neg = np.flatnonzero(row_toks < 0)
            if neg.size:
                # non-finite sentinel mid-chunk: commit the finite prefix and
                # quarantine the row
                m = int(neg[0])
                r.generated.extend(int(t) for t in row_toks[:m])
                self._commit_tokens(r, m)
                r.pos += m
                self._quarantine(r)
                continue
            r.generated.extend(int(t) for t in row_toks)
            self._commit_tokens(r, n)
            r.pos += n
            if len(r.generated) >= r.max_new_tokens:
                self._finish(r)
        self.tel.pool_gauges(len(self.active), self.kv_pool_bytes, self.kv_free_bytes)

    def _decode_chunk_pass(self, chunk: int):
        """One multi-step decode dispatch for every decoding request (EOS
        observed per chunk). The pending 1-ahead step is consumed first."""
        if self._pending is not None:
            self._consume(self._pending, {})
            self._pending = None
        active = self.decoding
        if not active:
            return
        pos_limit = self.app._pos_limit()
        max_pos = max(r.pos for r in active)
        take = min(
            chunk,
            min(r.max_new_tokens - len(r.generated) for r in active),
            pos_limit - 1 - max_pos,
        )
        if take < 1:
            self.step()
            return
        # round the step count up to a power of two and discard the surplus
        # on the host (generate()'s chunk-reuse rule)
        chunk = pow2_bucket(take)
        if chunk > pos_limit - 1 - max_pos:
            chunk = take
        B = self.num_slots
        last = np.zeros((B, 1), np.int32)
        pos = np.zeros((B, 1), np.int32)
        seq_ids = np.full((B,), -1, np.int32)
        for r in active:
            last[r.slot, 0] = r.last_token
            pos[r.slot, 0] = r.pos
            seq_ids[r.slot] = r.slot
        bucket = self.app._decode_bucket(int(pos.max()) + chunk)
        block_table = None
        if self.block_mode:
            block_table = self._chunk_block_table(
                [(r.slot, r.pos, r.max_new_tokens - len(r.generated)) for r in active],
                chunk, bucket,
            )
            if block_table is None:
                self.step()  # pool exhausted: the per-step path preempts
                return
        runner = self.app.token_generation_model

        def dispatch():
            with self.tel.span("serving.decode_chunk", steps=chunk):
                return runner.decode_chunk(
                    self.app.params, self.app.kv_cache, last, pos, seq_ids,
                    self._session_sampling_params(), num_steps=chunk, bucket=bucket,
                    block_table=block_table,
                )

        res = self._guarded_dispatch("decode_chunk", active, dispatch)
        if res is None:
            return
        tokens_c, _, cache = res
        self.app.kv_cache = cache
        self.dispatches["decode_steps"] += chunk
        self.tel.step("decode")
        self.tel.bucket_dispatch(runner.tag, bucket)
        toks = tokens_c.cpu().numpy()  # ONE sync per chunk
        if self.faults is not None:
            toks = self.faults.corrupt_tokens(self, toks)
        for r in active:
            n_obs = 0
            finished = False
            quarantined = False
            for j in range(take):
                tok = int(toks[r.slot, j])
                if tok < 0:
                    quarantined = True
                    break
                r.generated.append(tok)
                n_obs += 1
                r.pos += 1
                if self._is_done(r, tok):
                    finished = True
                    break
            self._commit_tokens(r, n_obs)
            if quarantined:
                self._quarantine(r)
            elif finished:
                self._finish(r)
        self.tel.pool_gauges(len(self.active), self.kv_pool_bytes, self.kv_free_bytes)


class _TokenFetch:
    """The device-to-host copy of one mixed step's tokens, started when the
    step is dispatched: on a card a non-blocking copy into pinned host
    memory and an event after it; :meth:`wait` blocks on that event only
    (reading the pinned buffer before it completes would read stale
    tokens). CPU tokens are already on the host."""

    def __init__(self, tokens: torch.Tensor):
        self.event = None
        if tokens.is_cuda:
            self.host = torch.empty(tokens.shape, dtype=tokens.dtype, pin_memory=True)
            self.host.copy_(tokens, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = tokens

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class SpeculativeServingSession(ServingSession):
    """Draft-assisted continuous batching (the reference's
    ``SpeculativeServingSession``): every step the DRAFT app proposes
    tokens for each decoding request, the TARGET verifies them, and each
    request advances by its own accepted count. Verification is greedy, so
    the streams are byte-equal to the target's own greedy decoding; a weak
    draft costs only speed. Both apps write then attend, so a rejected
    candidate leaves a stale entry the next round writes again before
    reading it. Two dispatch modes:

    - **split path** (default): contiguous caches; the draft proposes k-1
      tokens in one decode chunk and the target verifies all k in one
      k-token pass (B1 with k queries a row); acceptance on the host.
    - **spec-ragged path** (``serving_spec_ragged``): verification rides
      the ragged mixed dispatch over the paged cache: a spec row carries
      its drafts as extra packed query positions, so ONE ``mixed_step_spec``
      dispatch per step serves prefill chunks, plain decode rows and
      spec-verify rows (one B3 launch a layer), and the accepted counts are
      computed on the device. The draft app keeps its contiguous cache; its
      next proposals chain on the verify output still on the device
      (``models/base.draft_chain_propose``, one captured program per
      bucket). Each request's draft length adapts to its acceptance EWMA on
      the fixed ladder :attr:`draft_len_choices`, so it changes data, never
      a program.
    """

    def __init__(
        self,
        app,
        draft_app,
        speculation_length: int = 4,
        telemetry=None,
        fault_injector=None,
        clock=None,
        sleep_fn=None,
    ):
        if app.builder.is_moe or draft_app.builder.is_moe:
            raise NotImplementedError(
                "speculative serving with an MoE target or draft is not ported to "
                "PyTorch yet (ROADMAP A9 (MoE speculation)); serve the MoE model "
                "through ServingSession"
            )
        tc = app.config.torch_config
        self.spec_ragged = bool(tc.serving_spec_ragged)
        super().__init__(app, telemetry=telemetry, fault_injector=fault_injector, clock=clock, sleep_fn=sleep_fn)
        tc_d = draft_app.config.torch_config
        if self.spec_ragged:
            width = self.mixed_runner.spec_width
            if speculation_length != width:
                raise ValueError(
                    f"speculation_length {speculation_length} != the app's compiled "
                    f"mixed_step_spec width {width} (Config.speculation_length sizes the "
                    "program family)"
                )
            if tc_d.is_block_kv_layout:
                raise NotImplementedError(
                    "the spec-ragged DRAFT app runs the contiguous cache (row == slot; its "
                    "proposals chain through draft_chain_propose, not the paged layout)"
                )
        elif self.block_mode or self.chunked:
            raise NotImplementedError(
                "speculative serving runs on the contiguous cache (no paged/chunked-prefill "
                "layouts) — unless serving_spec_ragged packs verification into the ragged "
                "mixed step"
            )
        if not tc_d.is_continuous_batching:
            raise ValueError("the draft app needs is_continuous_batching=True")
        if speculation_length < 2:
            raise ValueError("speculation_length must be >= 2")
        d_batch = tc_d.tkg_batch_size or tc_d.max_batch_size or tc_d.batch_size
        if d_batch < self.num_slots:
            raise ValueError(f"draft app batch ({d_batch}) smaller than the session's {self.num_slots} slots")
        if draft_app.token_generation_model.buckets[-1] < app.token_generation_model.buckets[-1]:
            raise ValueError("draft token_generation_buckets must reach at least as far as the target's")
        self.draft = draft_app
        self.k = speculation_length
        self.async_decode = False  # accept/reject is a host decision per step
        #: the draft-length ladder of the adaptive policy: powers of two up
        #: to k-1, and k-1
        self.draft_len_choices = tuple(
            sorted({d for d in (1, 2, 4, 8) if d <= speculation_length - 1} | {speculation_length - 1})
        )
        #: the draft proposals for the next verify round: (device (R, k-1)
        #: tokens, {id(req): (slot, epoch)})
        self._draft_prop = None
        #: session-wide acceptance-rate EWMA (None until the first round)
        self.acceptance_ewma: Optional[float] = None
        #: optional draft-agreement gate: callable (req_id, drafted) -> the
        #: most draft tokens to accept this round, or None for no cap.
        #: Capping changes no output (the window holds the target's own
        #: greedy tokens); only measured acceptance moves
        self.draft_accept_cap = None

    prefilled_admission = False  # see ServingSession.prefilled_admission

    def add_prefilled_request(self, *args, **kwargs) -> AdmissionResult:
        raise NotImplementedError(
            "the disaggregated prefill tier does not support speculative "
            "decode sessions: the hand-off carries TARGET KV only, and the "
            "draft app's cache needs its own prompt prefill (draft_ready) "
            "— route speculative traffic to non-tier replicas"
        )

    def _capped_accept(self, req: Request, count: int, drafted: int) -> int:
        """One round's accepted count (bonus token included, in [1,
        drafted + 1]) under the draft-agreement gate, if one is set."""
        if self.draft_accept_cap is None or drafted <= 0:
            return count
        cap = self.draft_accept_cap(req.req_id, drafted)
        if cap is None:
            return count
        return max(1, min(count, 1 + int(cap)))

    def _max_admissible_prompt(self) -> int:
        if self.spec_ragged:
            # the target prefills in chunks, the draft in one context pass
            # of prompt + first token
            return min(
                ServingSession._max_admissible_prompt(self),
                self.draft.context_encoding_model.buckets[-1] - 1,
            )
        # the split path cannot admit in windows (the draft prefill is one
        # context pass): cap at one context program of both apps
        return min(
            super()._max_admissible_prompt(),
            self.app.config.torch_config.max_context_length,
            self.draft.context_encoding_model.buckets[-1],
        )

    def _full_prefill(self, req: Request) -> bool:
        if self.spec_ragged:
            return super()._full_prefill(req)
        # fail before any state changes: the draft prefill is one context pass
        if self.app.validate_prefill_length(req.prompt_len) or (
            req.prompt_len > self.draft.context_encoding_model.buckets[-1]
        ):
            raise NotImplementedError(
                "speculative serving of prompts longer than one context program is not "
                "implemented; raise max_context_length (both apps) to cover the prompt"
            )
        ok = super()._full_prefill(req)
        if not ok or req.finished:
            return ok
        return self._draft_prefill(req)

    def _draft_prefill(self, req: Request) -> bool:
        """Prefill the draft's cache line for ``req`` in one context pass
        (its first token is discarded: proposals chain from the target's
        tokens). A dispatch failure past the retry budget fails the request
        (slot released) and the session goes on."""
        ids_row = req.input_ids
        if self.spec_ragged and req.generated:
            # the first generated token is committed when the spec-ragged
            # draft prefill runs: include it, so the first chained propose
            # writes the next frontier at prompt_len + 1 with no gap
            ids_row = np.concatenate([ids_row, np.asarray(req.generated[-1:], np.int32)])
        S = ids_row.shape[0]
        cte = self.draft.context_encoding_model

        def dispatch():
            with self.tel.span("serving.prefill_draft", req_id=req.req_id, tokens=S):
                inputs, _ = cte.prepare(
                    ids_row[None, :], np.ones((1, S), np.int32), np.arange(S, dtype=np.int32)[None, :],
                    np.array([req.slot], np.int32), prepare_sampling_params(1),
                )
                return cte(self.draft.params, self.draft.kv_cache, inputs)

        out = self._guarded_dispatch("prefill_draft", [req], dispatch)
        if out is None:
            return True  # terminal FAILED(dispatch_error); slot released
        self.draft.kv_cache = out.cache
        self.dispatches["prefill_draft"] += 1
        if self.spec_ragged:
            req.draft_ready = True
            req.draft_len = self.draft_len_choices[-1]
        return True

    # ---- the spec-ragged path ---------------------------------------------

    def _preempt(self, req: Request):
        # the draft's cache line goes with the slot: both apps prefill again
        # after re-admission
        req.draft_ready = False
        super()._preempt(req)

    def _finish_prefill(self, req: Request, first_token: int):
        super()._finish_prefill(req, first_token)
        if self.spec_ragged and not req.finished and req.status == STATUS_ACTIVE:
            # decoding starts: bring the draft's cache up to date so the row
            # joins the NEXT chained propose (this round it decodes plainly)
            self._draft_prefill(req)

    def _spec_ragged_step(self) -> Dict[str, int]:
        """One spec-ragged step: consume the pending verify (its fetch was
        started at dispatch; 1-ahead, epoch-guarded), schedule prefill
        chunks, decode rows and spec-verify rows from the COMMITTED state
        (positions follow the accepted counts, so the schedule follows the
        consume), dispatch ONE ``mixed_step_spec`` program for all of them,
        then the next round's draft propose chained on its output on the
        device."""
        results: Dict[str, int] = {}
        t_step0 = self.tel.clock()
        self._step_fetch_wait_s = 0.0
        pend = self._pending
        self._pending = None
        if pend is not None:
            self._consume_spec(pend, results)

        rows = self._schedule_spec()
        prop = self._draft_prop
        self._draft_prop = None  # this round's pack consumes it
        if not rows:
            self._note_step_timing(t_step0)
            return results
        mr = self.mixed_runner
        d = self._build_mixed_descriptors(rows)
        draft_dev = prop[0][: self.num_slots] if (prop is not None and d["spec_rows"]) else None

        def dispatch():
            with self.tel.span("serving.mixed_step_spec", rows=len(rows), tokens=d["T"]):
                inputs, _ = mr.prepare(
                    d["ids"], d["positions"], d["slot_mapping"], d["row_start"], d["row_len"], d["ctx_len"],
                    d["block_table"], d["width"], self._session_sampling_params(),
                    chain_src=d["chain_src"], verify_len=d["verify_len"], draft_tokens=draft_dev,
                )
                return mr(self.app.params, self.app.kv_cache, inputs)

        out = self._guarded_dispatch("mixed_step_spec", [t[0] for t in rows], dispatch)
        if out is None:
            # in-flight rows terminally FAILED(dispatch_error); the pending
            # step was consumed at the top
            self._note_step_timing(t_step0)
            return results
        self.app.kv_cache = out.cache
        self.dispatches["mixed_step_spec"] += 1
        self.tel.step("mixed")
        self.tel.bucket_dispatch(mr.tag, mr.last_bucket)
        n_prefill = sum(1 for t in rows if t[1] == "prefill")
        real_tokens = int(sum(t[2] for t in rows))
        self.tel.mixed_step(
            prefill_rows=n_prefill, decode_rows=len(rows) - n_prefill - d["spec_rows"],
            padded_slots=mr.last_bucket - real_tokens, query_tokens=real_tokens, spec_rows=d["spec_rows"],
        )
        for req, kind, n, _p0, _c in rows:
            if kind == "prefill":
                self._note_prefill(req, n)
        self.tel.pool_gauges(len(self.active), self.kv_pool_bytes, self.kv_free_bytes)
        snap = [(req, kind, n, p0, req.slot, req.epoch) for req, kind, n, p0, _c in rows]
        step = (out.tokens, snap, _TokenFetch(out.tokens))
        if self.ragged_async:
            self._pending = step
        else:
            self._consume_spec(step, results)
        # the next round's draft propose, chained on this verify's output on
        # the device: the device runs verify then draft back to back
        self._dispatch_chained_draft(out.tokens, snap)
        self._note_step_timing(t_step0)
        return results

    def _schedule_spec(self) -> List[tuple]:
        """The row list [(req, kind, n, p0, chained)]: prefill chunks as the
        ragged scheduler builds them, then every decoding row: a spec-verify
        segment of ``draft_len + 1`` tokens when a current proposal entry
        exists (slot and epoch match, the row's draft cache is live,
        headroom allows), else a plain one-token decode row."""
        rows: List[tuple] = []
        if self.chunked:
            pref = [r for r in self.slots if r is not None and not r.finished and r.prefill_pos < r.prompt_len]
            for req in pref[: self.max_prefill_seqs]:
                n = min(self.chunk_size, req.prompt_len - req.prefill_pos)
                try:
                    self._alloc(req.slot, req.prefill_pos + n)
                except RuntimeError:
                    self._preempt(req)
                    continue
                rows.append((req, "prefill", n, req.prefill_pos, False))
        scheduled = {id(t[0]) for t in rows}
        pos_limit = self.app._pos_limit()
        prop_map = self._draft_prop[1] if self._draft_prop is not None else {}
        for r in list(self.slots):
            if r is None or r.finished or id(r) in scheduled or r.prefilling:
                continue
            p0 = r.pos
            room = r.max_new_tokens - len(r.generated)
            v = 1
            if prop_map.get(id(r)) == (r.slot, r.epoch) and r.draft_ready and r.draft_len > 0:
                v = max(1, min(r.draft_len + 1, room, pos_limit - p0))
            try:
                self._alloc(r.slot, p0 + v)
            except RuntimeError:
                self._preempt(r)
                continue
            rows.append((r, "spec" if v > 1 else "decode", v, p0, False))
        return rows

    def _consume_spec(self, pend, results: Dict[str, int]):
        """Commit one dispatched spec-ragged step: its one host fetch ((R,
        k+1) verify tokens with the accepted counts). Per row: take the
        accepted window, cut it at EOS or the budget as the split path
        does, advance the position by the committed length (the rejected
        tail's K/V is written again next round), feed the acceptance EWMA
        and the draft-length policy, and quarantine on a sentinel inside the
        window (only that row). Stale-epoch rows are discarded."""
        t0 = self.tel.clock()
        tokens = pend[2].wait()  # (R, k + 1)
        self._step_fetch_wait_s += self.tel.clock() - t0
        if self.faults is not None:
            tokens = self.faults.corrupt_tokens(self, tokens)
        k = self.k
        for req, kind, n, p0, slot, epoch in pend[1]:
            if req.finished or req.preempted or req.epoch != epoch:
                continue
            if kind == "prefill":
                req.prefill_pos = p0 + n
                if req.prefill_pos >= req.prompt_len:
                    tok = int(tokens[slot, 0])
                    self._finish_prefill(req, tok)
                    if req.status != STATUS_FAILED:  # not quarantined
                        results[req.req_id] = tok
                continue
            v = n  # the verify-window width this row was dispatched with
            count = max(1, min(int(tokens[slot, k]), v))
            count = self._capped_accept(req, count, v - 1)
            window = tokens[slot, :count]
            if (window < 0).any():
                # a poisoned TARGET row (a poisoned draft only mis-proposes)
                self._quarantine(req)
                continue
            row = [int(t) for t in window]
            if req.eos_token_id is not None and req.eos_token_id in row:
                row = row[: row.index(req.eos_token_id) + 1]
            row = row[: req.max_new_tokens - len(req.generated)]
            req.generated.extend(row)
            # committed tokens this round (plain decode rows observe 1): the
            # observations sum to the decode tokens delivered
            self.tel.spec_accept(len(row))
            self._commit_tokens(req, len(row))
            req.pos = p0 + len(row)
            if row:
                results[req.req_id] = row[-1]
            if v > 1:
                self._note_acceptance(req, accepted=count - 1, drafted=v - 1)
            if (
                (req.eos_token_id is not None and row and row[-1] == req.eos_token_id)
                or len(req.generated) >= req.max_new_tokens
                or req.pos + 1 >= self.app.config.torch_config.seq_len
            ):
                self._finish(req)

    #: per-request acceptance-EWMA smoothing (the policy reacts within a
    #: few rounds when a request's text changes regime)
    SPEC_EWMA_ALPHA = 0.5
    #: session-level smoothing (the router's placement signal)
    SESSION_EWMA_ALPHA = 0.2
    #: grow the draft above this per-draft acceptance rate, shrink below
    #: the lower bound (hysteresis)
    SPEC_GROW_AT = 0.75
    SPEC_SHRINK_AT = 0.4

    def _note_acceptance(self, req: Request, accepted: int, drafted: int):
        """Fold one round into the request's and the session's EWMAs and
        move the request's next draft length one notch along
        :attr:`draft_len_choices`. The telemetry observes the length THIS
        round drafted, so the observations sum to the drafted tokens."""
        rate = accepted / max(1, drafted)
        a = self.SPEC_EWMA_ALPHA
        req.accept_ewma = (1 - a) * req.accept_ewma + a * rate
        b = self.SESSION_EWMA_ALPHA
        self.acceptance_ewma = rate if self.acceptance_ewma is None else (1 - b) * self.acceptance_ewma + b * rate
        choices = self.draft_len_choices
        i = choices.index(req.draft_len) if req.draft_len in choices else 0
        if req.accept_ewma >= self.SPEC_GROW_AT and i + 1 < len(choices):
            req.draft_len = choices[i + 1]
        elif req.accept_ewma < self.SPEC_SHRINK_AT and i > 0:
            req.draft_len = choices[i - 1]
        self.tel.spec_round(drafted, req.accept_ewma, req_id=req.req_id)

    def _dispatch_chained_draft(self, verify_tokens, snap):
        """Dispatch the draft propose for the NEXT round, chained on the
        (R, k+1) verify output on the device: each row's frontier (last
        accepted token, the position after it) is derived in the program,
        so no host round trip sits between verify and draft. It runs k draft
        steps for k-1 proposals: the k-th writes the last proposal's K/V,
        which a fully accepted round commits (the reference runs k-1 and
        leaves that position stale in the draft's cache). Rows that end at
        consume leave their proposals unused. A failed draft dispatch is
        not fatal: the next round runs plain decode rows."""
        R = self.num_slots
        use_chain = np.zeros((R, 1), np.int32)
        p0_base = np.zeros((R, 1), np.int32)
        seq_ids = np.full((R,), -1, np.int32)
        prop_map: Dict[int, tuple] = {}
        bases: List[int] = []
        # near the limit: the chain writes draft positions up to base + 2k -
        # 1 (a frontier up to base + k, then k steps: the k-th writes the
        # last proposal's K/V, which a fully accepted round commits, as
        # assisted.draft_propose's chunk does) and needs a bucket covering
        # base + 2k; rows past the draft's reach decode plainly until they
        # end at the bound
        draft_limit = self.draft._pos_limit()
        for req, kind, n, p0, slot, epoch in snap:
            if req.finished or req.preempted or req.epoch != epoch or not req.draft_ready:
                continue
            if kind == "prefill":
                if p0 + n < req.prompt_len:
                    continue  # still mid-prompt: no frontier yet
                base_pos = req.prompt_len - 1  # the window is the first token
            else:
                base_pos = p0
            if base_pos + 2 * self.k > draft_limit:
                continue
            use_chain[slot, 0] = 1
            p0_base[slot, 0] = base_pos
            seq_ids[slot] = slot
            prop_map[id(req)] = (slot, epoch)
            bases.append(base_pos)
        if not prop_map:
            self._draft_prop = None
            return
        # the host's upper bound for the bucket (the true positions, base +
        # accepted count, live on the device)
        bucket = self.draft._decode_bucket(max(bases) + 2 * self.k)
        runner = self.draft.token_generation_model

        def dispatch():
            with self.tel.span("serving.draft_chain", rows=len(prop_map)):
                return runner.draft_chain(
                    self.draft.params, self.draft.kv_cache, verify_tokens, use_chain, p0_base, seq_ids,
                    self._session_sampling_params(), num_steps=self.k, bucket=bucket, spec_width=self.k,
                )[:, : self.k - 1]

        proposals = self._guarded_dispatch("draft_chain", [], dispatch)
        if proposals is None:
            self._draft_prop = None
            return
        self.dispatches["draft_chain"] += 1
        self.tel.bucket_dispatch("spec_draft_chain", bucket)
        self._draft_prop = (proposals, prop_map)

    def _step_inner(self) -> Dict[str, int]:
        """One speculation round for every decoding request; returns
        {req_id: last accepted token} (the full stream is in
        ``request.generated``). Deadlines, re-admission, the watchdog and the
        fault hooks are the base class's :meth:`ServingSession.step`."""
        if self.spec_ragged:
            return self._spec_ragged_step()
        from neuronx_distributed_inference_tpu_torch.runtime.assisted import (
            draft_propose,
            greedy_accept,
            target_verify,
        )

        results: Dict[str, int] = {}
        active = self.decoding
        if not active:
            return results
        tc = self.app.config.torch_config
        k = self.k
        B = self.num_slots
        pos_limit = self.app._pos_limit()
        rows = [r for r in active if r.pos + k <= pos_limit]
        tail = [r for r in active if r not in rows]
        if tail:
            # rows within k-1 positions of the limit decode one token at a
            # time, emitting what the plain session would
            out, snap = self._dispatch_decode([(r, r.pos) for r in tail])
            if out is not None:
                self._consume((out.tokens[:, -1:], snap), results)
        if not rows:
            return results

        last = np.zeros((B, 1), np.int32)
        pos = np.zeros((B, 1), np.int32)
        seq_ids = np.full((B,), -1, np.int32)
        for r in rows:
            last[r.slot, 0] = r.last_token
            pos[r.slot, 0] = r.pos
            seq_ids[r.slot] = r.slot
        sp = prepare_sampling_params(B)

        def dispatch():
            with self.tel.span("serving.speculate", rows=len(rows)):
                proposals, _ = draft_propose(self.draft, last, pos, seq_ids, sp, k)
                cand = np.concatenate([last, proposals], axis=1).astype(np.int32)
                return cand, target_verify(self.app, cand, pos, seq_ids, sp)

        res = self._guarded_dispatch("speculate", rows, dispatch)
        if res is None:
            return results  # in-flight rows terminally FAILED(dispatch_error)
        cand, v_out = res
        self.dispatches["speculate"] += 1
        self.tel.step("speculate")
        tkg = self.app.token_generation_model
        self.tel.bucket_dispatch(tkg.tag, tkg.last_bucket)
        self.tel.pool_gauges(len(rows), self.kv_pool_bytes, self.kv_free_bytes)
        greedy = v_out.tokens[:B].cpu().numpy()  # (B, k)
        if self.faults is not None:
            greedy = self.faults.corrupt_tokens(self, greedy)

        counts = greedy_accept(cand, greedy)
        for r in rows:
            s = r.slot
            counts[s] = self._capped_accept(r, int(counts[s]), k - 1)
            if (greedy[s, : counts[s]] < 0).any():
                # a poisoned TARGET row: quarantine it (a poisoned draft only
                # mis-proposes; the target's own tokens are emitted)
                self._quarantine(r)
                continue
            row = greedy[s, : counts[s]].tolist()
            if r.eos_token_id is not None and r.eos_token_id in row:
                row = row[: row.index(r.eos_token_id) + 1]
            row = row[: r.max_new_tokens - len(r.generated)]
            r.generated.extend(row)
            self.tel.spec_accept(len(row))
            # the acceptance EWMAs on this path too (its draft length stays
            # k-1: the snap inside is inert)
            self._note_acceptance(r, accepted=int(counts[s]) - 1, drafted=k - 1)
            self._commit_tokens(r, len(row))
            r.pos += len(row)
            if row:
                results[r.req_id] = row[-1]
            if (
                (r.eos_token_id is not None and row and row[-1] == r.eos_token_id)
                or len(r.generated) >= r.max_new_tokens
                or r.pos + 1 >= tc.seq_len
            ):
                self._finish(r)
        return results

    def run_to_completion(self, decode_chunk_size: int = 16) -> Dict[str, List[int]]:
        while self.active or self._readmit:
            self.step()
        return {rid: r.generated for rid, r in self.requests.items()}
