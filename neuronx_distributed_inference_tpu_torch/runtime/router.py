"""Multi-replica serving front-end: a router over N replica sessions
(counterpart of the reference's ``runtime/router.py``).

:class:`ServingRouter` is the data-parallel layer above
:class:`~.serving.ServingSession`: it owns N :class:`~.replica.ReplicaHandle`
replicas (each a session over its own application: its own weights and KV
cache, on its own card or sharing one, see :func:`partition_devices`) and
gives them one front door:

- **Admission + placement**: ``add_request`` returns the session's typed
  :class:`~.serving.AdmissionResult`. Malformed requests (validated through
  the replica sessions' OWN admission checks, so the two doors cannot
  drift) are terminal REJECTED at the router; well-formed ones enter a
  global FIFO queue and are bound to a replica by the placement policy
  (:data:`PLACEMENT_POLICIES`): ``round_robin`` cycles the healthy set,
  ``least_loaded`` scores replicas from live signals (re-admission backlog,
  occupancy, ``kv_free_bytes`` headroom, EWMAs of step and queue-wait ms),
  ``cache_aware`` ranks replicas by prefix-cache affinity (each candidate's
  ``PrefixCachingAllocator.match_keys`` over the request's block-chain
  keys, load order breaking ties). Placement is head-of-line FIFO: a queue
  head that fits nowhere WAITS; later arrivals cannot starve it.
- **Replica health + failover**: per-replica ``HEALTHY -> DEGRADED ->
  DEAD`` (:mod:`.replica`). On replica death its live requests roll back
  to committed host state and re-queue AHEAD of new arrivals onto the
  survivors, where greedy decode resumes byte-identically. A request that
  terminally FAILED(dispatch_error) on a still-alive replica fails over
  the same way, bounded by ``max_failovers``. The router never raises for
  a replica-local failure.
- **Drain / steady state**: ``step()`` advances every alive replica and
  ``run_to_completion`` drains the global queue. With
  ``Config.router_threading`` the stepping phase dispatches every alive
  replica's ``ReplicaHandle.step()`` from a persistent one-thread-per-
  replica pool and waits on a per-step barrier: graph replays and the
  blocking token fetches release the GIL, so replicas' host work overlaps.
  ONLY ``ReplicaHandle.step()`` runs on worker threads; placement,
  admission, failover, terminal sync and every gauge stay on the router
  thread, whose phases never overlap the workers' (it blocks on the
  barrier). Every replica's device work runs on its app's own CUDA stream
  (:func:`~.replica.app_stream`).
- **The disaggregated prefill tier** (``prefill_replicas``): while a tier
  member is alive, each fresh placement context-encodes on a tier member
  and hands the KV line over to the decode replica (:meth:`_handoff`,
  retried with capped backoff on a transit fault); when the whole tier is
  dead the decode replicas prefill locally, loudly.
- **Elastic fleet**: :meth:`add_replica` joins a warm replica mid-run,
  :meth:`retire_replica` stops placement on one and finalizes it when
  drained.
- **Observability**: the ``nxdi_router_*``, ``nxdi_replica_step_ms`` and
  ``nxdi_handoff_*`` families of the telemetry session, recorded on the
  router thread.

Threads and captures: a CUDA graph capture fails while another thread
launches work, so every replica's programs must be captured (warmed, then
sealed) before the first threaded step; a capture attempted after the
seal raises ``RetraceError``.
"""

from __future__ import annotations

import threading
import time
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from neuronx_distributed_inference_tpu_torch.config import ROUTER_POLICIES
from neuronx_distributed_inference_tpu_torch.runtime.faults import (
    RETRYABLE_HANDOFF_ERRORS,
    HandoffTransitError,
)
from neuronx_distributed_inference_tpu_torch.runtime.graphs import mark_worker_thread
from neuronx_distributed_inference_tpu_torch.runtime.replica import (
    HEALTH_GAUGE,
    HEALTH_HEALTHY,
    PrefillReplicaHandle,
    ReplicaHandle,
)
from neuronx_distributed_inference_tpu_torch.runtime.serving import (
    ADMITTED,
    DISPATCH_BACKOFF_BASE_S,
    DISPATCH_BACKOFF_CAP_S,
    REJECTED_HISTORY_MAX,
    AdmissionResult,
    Request,
)
from neuronx_distributed_inference_tpu_torch.telemetry.tracing import default_session

#: pluggable placement policies (Config.router_policy; the tuple lives in
#: config.py so validation needs no runtime import)
PLACEMENT_POLICIES = ROUTER_POLICIES

#: capacity-refusal reasons a session may answer placement with — the router
#: spills to the next candidate replica (anything else is a validation
#: verdict and terminal)
_CAPACITY_REASONS = frozenset({"no_slot", "kv_blocks", "backlog"})

#: exception classes a KV hand-off attempt may fail RETRYABLY with: the
#: transit faults plus a transient prefill dispatch error on the tier
#: member, bounded by ``handoff_max_retries``
_HANDOFF_RETRYABLE = RETRYABLE_HANDOFF_ERRORS

#: router-request statuses (terminal: finished / failed / rejected)
RSTATUS_QUEUED = "queued"
RSTATUS_PLACED = "placed"
RSTATUS_FINISHED = "finished"
RSTATUS_FAILED = "failed"
RSTATUS_REJECTED = "rejected"


@dataclass
class RouterRequest:
    """One request as the router sees it, across replica incarnations.
    ``tokens`` accumulates the committed output over every placement; on
    failover the effective prompt re-placed on the next replica is
    ``input_ids + tokens`` with the remaining budget — exactly the serving
    session's own re-admission fold, one level up."""

    req_id: str
    input_ids: np.ndarray  # ORIGINAL prompt (never mutated)
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    deadline_s: Optional[float] = None
    status: str = RSTATUS_QUEUED
    fail_reason: Optional[str] = None
    tokens: List[int] = field(default_factory=list)
    replica: Optional[int] = None  # current/last placement
    placements: int = 0
    failovers: int = 0
    t_submit: float = 0.0
    # cache_aware placement: prefix-chain keys of the effective prompt,
    # keyed by (block_size, prompt_len) — the prompt only changes on
    # failover (committed tokens fold in), so a queued request retrying
    # placement hashes its prompt once, not once per candidate per step
    prefix_keys: Dict[tuple, list] = field(default_factory=dict, repr=False)

    @property
    def finished(self) -> bool:
        return self.status in (RSTATUS_FINISHED, RSTATUS_FAILED, RSTATUS_REJECTED)

    @property
    def remaining_budget(self) -> int:
        return self.max_new_tokens - len(self.tokens)

    def effective_prompt(self) -> np.ndarray:
        if not self.tokens:
            return self.input_ids
        return np.concatenate(
            [self.input_ids, np.asarray(self.tokens, np.int32)]
        )

    def session_id(self) -> str:
        """Session-side request id for the CURRENT incarnation: failover
        suffixes keep incarnations from aliasing inside one session's
        request table."""
        if self.placements <= 1:
            return self.req_id
        return f"{self.req_id}~f{self.placements - 1}"


class _ReplicaStepWorker(threading.Thread):
    """One persistent worker thread owning ONE replica's step dispatch —
    the thread-per-replica pool behind ``Config.router_threading``.

    Protocol (two events as the per-step barrier): the router thread calls
    :meth:`dispatch` (arms the job) then :meth:`join_step` (waits for the
    done event and takes the result / re-raises the worker's exception on
    the router thread). Each worker has at most ONE outstanding job, and
    the router only reads ``result``/``error`` after the done event — the
    events' internal condition variables give the writes happens-before
    visibility. The ONLY code a worker runs is ``ReplicaHandle.step()``
    (the confinement set); WatchdogError is already
    converted to replica death inside it, so an exception surfacing here is
    a programming error, re-raised where the sequential path would have
    raised it."""

    def __init__(self, handle):
        super().__init__(
            daemon=True, name=f"nxdi-replica-step-{handle.replica_id}"
        )
        self.handle = handle
        self._go = threading.Event()
        self._done = threading.Event()
        self._quit = False
        self.result: Dict[str, int] = {}
        self.error: Optional[BaseException] = None
        self.start()

    def run(self) -> None:  # the worker thread body
        mark_worker_thread()
        while True:
            self._go.wait()
            self._go.clear()
            if self._quit:
                return
            try:
                self.result = self.handle.step()
            except BaseException as e:
                self.error = e
            self._done.set()

    def dispatch(self) -> None:  # router thread
        self.result = {}
        self.error = None
        self._done.clear()
        self._go.set()

    def wait_done(self) -> None:  # router thread
        """Block until this worker parks (job finished, success OR error) —
        the barrier half of the protocol, raise-free so the router can
        complete the barrier for EVERY worker before any error re-raises."""
        self._done.wait()

    def join_step(self) -> Dict[str, int]:  # router thread
        self._done.wait()
        if self.error is not None:
            err, self.error = self.error, None
            raise err
        return self.result

    def shutdown(self) -> None:  # router thread (router.close())
        self._quit = True
        self._go.set()
        self.join()


class ServingRouter:
    def __init__(
        self,
        replicas: Sequence,
        policy: Optional[str] = None,
        telemetry=None,
        clock: Optional[Callable[[], float]] = None,
        max_failovers: int = 3,
        threaded: Optional[bool] = None,
        prefill_replicas: Optional[Sequence] = None,
        handoff_max_retries: Optional[int] = None,
        handoff_timeout_s: Optional[float] = None,
        sleep_fn: Optional[Callable[[float], None]] = None,
    ):
        """``replicas``: ReplicaHandles, or bare serving sessions (wrapped
        with sequential ids). ``policy`` defaults to the first replica's
        ``Config.router_policy``. ``max_failovers`` bounds how many times
        one request may fail over before it is terminally FAILED (a request
        that kills every replica it lands on must not cycle forever).
        ``threaded`` overrides ``Config.router_threading`` (None =
        follow the config): when on, a persistent one-thread-per-replica
        pool steps the replicas concurrently behind a per-step barrier —
        call :meth:`close` when done so the pool joins (the sequential
        router's close() is a no-op).

        ``prefill_replicas``: the disaggregated PREFILL tier
        (``Config.router_prefill_replicas``): PrefillReplicaHandles, or bare
        prefill-stage apps (wrapped with sequential tier-local ids). When
        the tier has an alive member, every fresh placement context-encodes
        on a tier member and hands the populated KV over to the chosen
        decode replica (``_handoff``); when the whole tier is DEAD, decode
        replicas fall back to LOCAL monolithic prefill (loud telemetry,
        never a wedge). Requires every decode session on the contiguous
        cache. ``handoff_max_retries`` / ``handoff_timeout_s`` override the
        ``Config`` knobs (None = follow the config); ``sleep_fn`` is the
        injectable backoff/latency sleep (tests pin hand-off timing
        deterministically)."""
        if not replicas:
            raise ValueError("ServingRouter needs at least one replica")
        self.replicas: List[ReplicaHandle] = [
            h if isinstance(h, ReplicaHandle) else ReplicaHandle(h, i)
            for i, h in enumerate(replicas)
        ]
        ids = [h.replica_id for h in self.replicas]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate replica ids: {ids}")
        tc = self.replicas[0].session.app.config.torch_config
        self.policy = policy if policy is not None else getattr(
            tc, "router_policy", "least_loaded"
        )
        if self.policy not in PLACEMENT_POLICIES:
            raise ValueError(
                f"unknown router policy {self.policy!r}; known: "
                f"{PLACEMENT_POLICIES}"
            )
        self.tel = telemetry if telemetry is not None else default_session()
        self._clock = clock if clock is not None else time.monotonic
        self._sleep = sleep_fn if sleep_fn is not None else time.sleep
        self.max_failovers = int(max_failovers)
        # --- disaggregated prefill tier -----------------------------------
        self.prefill_replicas: List[PrefillReplicaHandle] = [
            p if isinstance(p, PrefillReplicaHandle)
            else PrefillReplicaHandle(p, i)
            for i, p in enumerate(prefill_replicas or ())
        ]
        pids = [p.replica_id for p in self.prefill_replicas]
        if len(set(pids)) != len(pids):
            raise ValueError(f"duplicate prefill-tier replica ids: {pids}")
        self.handoff_max_retries = int(
            getattr(tc, "handoff_max_retries", 2)
            if handoff_max_retries is None else handoff_max_retries
        )
        self.handoff_timeout_s = (
            getattr(tc, "handoff_timeout_s", None)
            if handoff_timeout_s is None else handoff_timeout_s
        )
        self._handoff_index = 0  # monotone hand-off counter (fault arming)
        self._handoff_rr = 0  # tier round-robin cursor
        self._tier_down_warned = False
        if self.prefill_replicas:
            for h in self.replicas:
                if h.session.block_mode:
                    raise ValueError(
                        "the disaggregated prefill tier hands KV over into "
                        "contiguous cache lines: decode replica "
                        f"{h.replica_id} runs the paged cache (config "
                        "validation forbids router_prefill_replicas with "
                        "is_block_kv_layout)"
                    )
                if not h.session.prefilled_admission:
                    raise NotImplementedError(
                        "the disaggregated prefill tier does not support "
                        "speculative decode sessions (the hand-off carries "
                        "target KV only; the draft cache needs its own "
                        "prefill)"
                    )
        self.admission_validation = bool(
            getattr(tc, "admission_validation", True)
        )
        self.requests: Dict[str, RouterRequest] = {}
        self.rejected: Dict[str, RouterRequest] = {}
        self.pending: deque = deque()  # global FIFO placement queue
        self._rr_next = 0  # round-robin cursor
        self._step_index = 0
        self.threaded = bool(
            getattr(tc, "router_threading", False)
            if threaded is None else threaded
        )
        # the persistent thread-per-replica stepping pool (empty =
        # sequential stepping); workers outlive every step and are joined
        # by close()
        self._workers: Dict[int, _ReplicaStepWorker] = {}
        if self.threaded:
            for h in self.replicas:
                self._workers[h.replica_id] = _ReplicaStepWorker(h)
        # --- elastic fleet (add_replica / retire_replica) -----------------
        # retiring replicas keep stepping (draining their owned requests)
        # but stop appearing in the placement pool; once drained they are
        # finalized: worker joined, gauges zeroed, handle removed
        self._retiring: Set[int] = set()
        self._closed = False
        self._next_replica_id = max(ids) + 1
        for h in self.replicas:
            self.tel.router_replica_gauges(
                h.replica_id, h.occupancy, h.queue_depth,
                HEALTH_GAUGE[h.health],
            )
        self._publish_tier_gauges()

    # ---- admission -------------------------------------------------------

    @property
    def alive_replicas(self) -> List[ReplicaHandle]:
        return [h for h in self.replicas if h.alive]

    @property
    def placeable_replicas(self) -> List[ReplicaHandle]:
        """Alive replicas that accept NEW placements (retiring ones keep
        stepping to drain what they own but never take more work)."""
        return [
            h for h in self.replicas
            if h.alive and h.replica_id not in self._retiring
        ]

    @property
    def alive_prefill_replicas(self) -> List[PrefillReplicaHandle]:
        return [p for p in self.prefill_replicas if p.alive]

    def add_request(
        self,
        req_id: str,
        input_ids,
        max_new_tokens: int = 64,
        eos_token_id: Optional[int] = None,
        deadline_s: Optional[float] = None,
    ) -> AdmissionResult:
        """The front door. Returns a truthy AdmissionResult when the request
        was accepted (placed immediately when capacity exists, else queued —
        FIFO, aged behind earlier arrivals); falsy with a ``reason`` for
        typed rejects (malformed input, duplicate id, no alive replicas)."""
        alive = self.placeable_replicas
        if not alive:
            return AdmissionResult(False, "no_replicas")
        if req_id in self.requests or req_id in self.rejected:
            return AdmissionResult(False, "duplicate_req_id")
        rreq = RouterRequest(
            req_id=req_id,
            input_ids=np.asarray(input_ids, np.int32).reshape(-1),
            max_new_tokens=max_new_tokens,
            eos_token_id=eos_token_id,
            deadline_s=deadline_s,
            t_submit=self._clock(),
        )
        if self.admission_validation:
            # run the REPLICA SESSION's own admission checks (vocab range,
            # empty/over-long prompt, budget) so the router door and the
            # session door cannot drift
            reason = alive[0].session._validate_request(
                Request(
                    req_id=req_id,
                    input_ids=rreq.input_ids,
                    max_new_tokens=max_new_tokens,
                )
            )
            if reason is not None:
                return self._reject(rreq, reason)
        self.requests[req_id] = rreq
        self.pending.append(rreq)
        self._place_pending()
        if rreq.status == RSTATUS_FAILED and rreq.fail_reason == "never_fits":
            # permanent capacity refusal observed synchronously (every
            # alive replica refused with nothing live to free): surface it
            # like the session's kv_blocks drop — falsy and unrecorded, the
            # caller may resubmit after reconfiguring
            self.requests.pop(req_id, None)
            return AdmissionResult(False, "never_fits")
        return ADMITTED

    def _reject(self, rreq: RouterRequest, reason: str) -> AdmissionResult:
        rreq.status = RSTATUS_REJECTED
        rreq.fail_reason = reason
        self.rejected[rreq.req_id] = rreq
        while len(self.rejected) > REJECTED_HISTORY_MAX:
            self.rejected.pop(next(iter(self.rejected)))
        self.tel.router_rejected(rreq.req_id, reason)
        return AdmissionResult(False, reason)

    # ---- placement -------------------------------------------------------

    def _candidates(self, rreq: RouterRequest) -> List[ReplicaHandle]:
        """Ordered placement candidates (best first) for ``rreq`` under the
        active policy. DEAD replicas never appear (nor RETIRING ones —
        scale-in stops placement first); DEGRADED ones only when no HEALTHY
        replica exists."""
        alive = self.placeable_replicas
        healthy = [h for h in alive if h.health == HEALTH_HEALTHY]
        pool = healthy if healthy else alive
        if not pool:
            return []
        if self.policy == "round_robin":
            n = len(pool)
            start = self._rr_next % n
            self._rr_next += 1
            return [pool[(start + i) % n] for i in range(n)]
        norm = max(h.latency_signal_ms for h in pool)
        ordered = sorted(
            pool, key=lambda h: (h.load_score(norm), h.replica_id)
        )
        if self.policy == "cache_aware":
            # prefix-cache affinity:
            # query every candidate replica's prefix-cache match index for
            # the longest cached block-chain prefix of this request's
            # effective prompt and send the request where the most of its
            # prompt already lives. The chain keys are a pure function of
            # (prompt, block_size), so they are hashed ONCE per request
            # (cached on the RouterRequest; recomputed only when failover
            # grows the prompt) and each candidate answers with a
            # read-only dictionary walk (match_keys — no refcounts move).
            # The sort is stable, so replicas with equal match counts —
            # including the cold-start all-zero case — keep the load order
            # computed above; replicas without a prefix index (plain
            # BlockAllocator, contiguous caches) score 0.
            from neuronx_distributed_inference_tpu_torch.modules.block_kvcache import prefix_chain_keys

            prompt = rreq.effective_prompt()

            def cached_blocks(h: ReplicaHandle) -> int:
                alloc = h.session.allocator
                match = getattr(alloc, "match_keys", None)
                if match is None:
                    return 0
                ck = (alloc.block_size, prompt.shape[0])
                keys = rreq.prefix_keys.get(ck)
                if keys is None:
                    # bounded: prompt length changes only on failover
                    # (max_failovers) and block sizes are per-replica config
                    keys = prefix_chain_keys(prompt, alloc.block_size)
                    rreq.prefix_keys[ck] = keys
                return int(match(keys))

            ordered = sorted(ordered, key=lambda h: -cached_blocks(h))
        return ordered

    # ---- disaggregated prefill tier ---------------------------------------

    def _pick_prefill(self) -> Optional[PrefillReplicaHandle]:
        """Next prefill-tier member, round-robin over the WHOLE alive set —
        DEGRADED members included: hand-offs are a tier member's only
        recovery clock (unlike decode replicas, which accrue clean STEPS
        whether or not placement prefers them), so excluding a degraded
        member while a healthy one exists would freeze it one give-up from
        death forever. A genuinely broken member's next exhaustion kills it
        — that is the health machine doing its job. None == the tier is
        down."""
        alive = self.alive_prefill_replicas
        if not alive:
            return None
        pick = alive[self._handoff_rr % len(alive)]
        self._handoff_rr += 1
        return pick

    def _bind_replica(
        self, h: ReplicaHandle, rreq: RouterRequest, sid: str,
        deadline_left: Optional[float],
    ) -> AdmissionResult:
        """Offer one placement to decode replica ``h``: through the
        disaggregated hand-off when the prefill tier has an alive member,
        through the session's own (local, monolithic) prefill otherwise —
        the tier-wide graceful-degradation switch."""
        if not self.prefill_replicas:
            return h.session.add_request(
                sid, rreq.effective_prompt(),
                max_new_tokens=rreq.remaining_budget,
                eos_token_id=rreq.eos_token_id, deadline_s=deadline_left,
            )
        if not self.alive_prefill_replicas:
            return self._local_prefill(h, rreq, sid, deadline_left)
        return self._handoff(h, rreq, sid, deadline_left)

    def _local_prefill(
        self, h: ReplicaHandle, rreq: RouterRequest, sid: str,
        deadline_left: Optional[float],
    ) -> AdmissionResult:
        """Tier-wide degradation: every prefill replica is DEAD, so this
        placement runs the decode replica's OWN monolithic prefill — loud
        (``nxdi_handoff_local_prefill_total`` + a one-time warning) but
        never a wedge; requests keep completing, byte-identically, at
        degraded ITL isolation. A later tier recovery (a DEGRADED member is
        still alive and recovers; DEAD is terminal) resumes hand-offs on
        the next placement."""
        if rreq.deadline_s is not None:
            # this path also runs MID-hand-off (the tier died under the
            # retry loop): re-bill the TTL for whatever wall time the
            # failed attempts + backoff consumed, exactly like the
            # successful-hand-off admission does — the deadline must never
            # silently extend
            deadline_left = rreq.deadline_s - (self._clock() - rreq.t_submit)
            if deadline_left <= 0:
                self.tel.deadline_exceeded(rreq.req_id, -deadline_left)
                return AdmissionResult(False, "deadline_exceeded")
        res = h.session.add_request(
            sid, rreq.effective_prompt(),
            max_new_tokens=rreq.remaining_budget,
            eos_token_id=rreq.eos_token_id, deadline_s=deadline_left,
        )
        if res:
            self.tel.handoff_local_prefill(rreq.req_id)
            if not self._tier_down_warned:
                self._tier_down_warned = True
                warnings.warn(
                    "disaggregated prefill tier is DEAD: decode replicas "
                    "are running LOCAL monolithic prefill (degraded — long "
                    "prompts will stall co-located decode rows; "
                    "nxdi_handoff_local_prefill_total counts every such "
                    "placement)",
                    stacklevel=2,
                )
        return res

    def _handoff(
        self, h: ReplicaHandle, rreq: RouterRequest, sid: str,
        deadline_left: Optional[float],
    ) -> AdmissionResult:
        """ONE disaggregated placement: context-encode on a prefill-tier
        member, extract the populated KV line, inject into decode replica
        ``h`` and commit the first token
        (``session.add_prefilled_request``). The hand-off is a CONTAINED
        failure domain:

        - capacity is pre-checked so a full decode replica refuses BEFORE a
          prefill pass is paid for (the refusal spills like any other);
        - transit failures (payload loss, stall, timeout overrun, a
          transient prefill dispatch error) retry with capped backoff,
          rotating to the next alive tier member, bounded by
          ``handoff_max_retries`` — exhaustion terminally fails ONLY this
          request (typed ``FAILED(handoff)``) and degrades the last tier
          member like a dispatch give-up;
        - a corrupt/truncated payload that DID arrive is caught by the
          decode session's inject validation (terminal ``FAILED(handoff)``,
          destination line scrubbed, co-batched rows byte-identical);
        - the tier dying mid-hand-off (every member DEAD) falls back to
          local prefill for this placement — the victim decoded nothing, so
          nothing replays but the prompt."""
        cap = h.session.admission_capacity()
        if cap is not None:
            return AdmissionResult(False, cap)
        prompt = rreq.effective_prompt()
        idx = self._handoff_index
        self._handoff_index += 1
        t0 = self._clock()
        attempt = 0
        while True:
            ph = self._pick_prefill()
            if ph is None:
                # the tier died between/under attempts: local fallback
                return self._local_prefill(h, rreq, sid, deadline_left)
            t_attempt = self._clock()
            self.tel.handoff_attempt()
            try:
                first, payload = ph.run_prefill(prompt)
                if ph.faults is not None:
                    ph.faults.handoff_transit(idx, self._sleep)
                    payload = ph.faults.corrupt_handoff_payload(idx, payload)
                if (
                    self.handoff_timeout_s is not None
                    and self._clock() - t_attempt > self.handoff_timeout_s
                ):
                    raise HandoffTransitError(
                        f"hand-off attempt exceeded handoff_timeout_s="
                        f"{self.handoff_timeout_s} (observed "
                        f"{self._clock() - t_attempt:.3f}s)"
                    )
            except _HANDOFF_RETRYABLE:
                attempt += 1
                if attempt > self.handoff_max_retries:
                    # exhaustion fails ONLY the in-flight request; the tier
                    # member takes the give-up (degrade -> dead), exactly
                    # the decode-side dispatch-retry discipline
                    ph.note_give_up()
                    self.tel.handoff_failure(rreq.req_id, "handoff_exhausted")
                    return AdmissionResult(False, "handoff")
                self.tel.handoff_retry()
                self._sleep(
                    min(
                        DISPATCH_BACKOFF_CAP_S,
                        DISPATCH_BACKOFF_BASE_S * (2 ** (attempt - 1)),
                    )
                )
                continue
            if rreq.deadline_s is not None:
                # re-bill the TTL for the hand-off's own wall time (prefill
                # dispatch, retries, backoff): the session stamps t_submit
                # at admission, so passing the PRE-hand-off deadline_left
                # would silently extend the deadline by the whole hand-off
                # — the local path bills its prefill against the TTL and
                # the tier must too
                deadline_left = rreq.deadline_s - (
                    self._clock() - rreq.t_submit
                )
                if deadline_left <= 0:
                    self.tel.deadline_exceeded(rreq.req_id, -deadline_left)
                    return AdmissionResult(False, "deadline_exceeded")
            res = h.session.add_prefilled_request(
                sid, prompt, payload, first,
                max_new_tokens=rreq.remaining_budget,
                eos_token_id=rreq.eos_token_id, deadline_s=deadline_left,
            )
            if res:
                sreq = h.session.requests.get(sid)
                if sreq is not None and sreq.fail_reason == "handoff":
                    # delivered-but-invalid payload: the session already
                    # terminalized the ONE victim (FAILED(handoff), line
                    # scrubbed) and emitted the validator's TYPED failure
                    # reason; the tier member is not penalized — the
                    # corruption is transit's fault, not the member's
                    pass
                else:
                    ph.note_clean()
                self.tel.handoff_done(
                    (self._clock() - t0) * 1e3,
                    req_id=sid, replica=ph.replica_id,
                )
            return res

    def _publish_tier_gauges(self) -> None:
        if not self.prefill_replicas:
            return
        alive = 0
        for ph in self.prefill_replicas:
            self.tel.handoff_tier_gauges(ph.replica_id, HEALTH_GAUGE[ph.health])
            if ph.alive:
                alive += 1
        self.tel.handoff_tier_alive(alive)

    def _place_pending(self) -> int:
        """Bind queued requests to replicas, FIFO with head-of-line blocking
        (the aging/starvation-freedom guarantee: a request the pool cannot
        fit yet is never overtaken by later arrivals). Spills to the next
        candidate replica on a capacity refusal. Returns placements made."""
        placed = 0
        while self.pending:
            rreq = self.pending[0]
            if rreq.finished:
                self.pending.popleft()
                continue
            deadline_left = None
            if rreq.deadline_s is not None:
                deadline_left = rreq.deadline_s - (
                    self._clock() - rreq.t_submit
                )
                if deadline_left <= 0:
                    self.pending.popleft()
                    self._terminal(rreq, RSTATUS_FAILED, "deadline_exceeded")
                    continue
            candidates = self._candidates(rreq)
            bound = None
            spilled = False
            for h in candidates:
                rreq.placements += 1
                sid = rreq.session_id()
                with h.device_scope():  # the admission's device work
                    res = self._bind_replica(h, rreq, sid, deadline_left)
                if res:
                    bound = h
                    h.owned[sid] = rreq
                    h._placed_t[sid] = self._clock()
                    rreq.replica = h.replica_id
                    rreq.status = RSTATUS_PLACED
                    reason = (
                        "failover" if rreq.failovers
                        else "spill" if spilled
                        else "fresh"
                    )
                    self.tel.router_placement(
                        self.policy, reason,
                        req_id=sid, replica=h.replica_id,
                    )
                    break
                rreq.placements -= 1  # not bound: the id was never admitted
                if res.reason == "handoff":
                    # bounded hand-off retry exhausted: the session never
                    # admitted the id — terminal typed FAILED(handoff) at
                    # the router; co-queued requests are unaffected and the
                    # (now possibly degraded/dead) tier member's health was
                    # already noted inside _handoff
                    self.pending.popleft()
                    self._terminal(rreq, RSTATUS_FAILED, "handoff")
                    bound = rreq  # handled; fall through to the outer loop
                    break
                if res.reason == "deadline_exceeded":
                    # the hand-off itself consumed the request's TTL (the
                    # re-billed check inside _handoff): terminal typed, the
                    # same verdict the head-of-line deadline check gives
                    self.pending.popleft()
                    self._terminal(rreq, RSTATUS_FAILED, "deadline_exceeded")
                    bound = rreq
                    break
                if res.reason in _CAPACITY_REASONS:
                    spilled = True
                    continue
                # session-side validation verdict (possible with a stale
                # health set or admission_validation off at the router):
                # surface it typed, never raise
                self.pending.popleft()
                self._terminal(rreq, RSTATUS_REJECTED, res.reason)
                bound = rreq  # handled; fall through to the outer loop
                break
            if bound is None:
                # head-of-line waits for capacity (aging) — UNLESS nothing
                # can ever free any: every alive replica refused AND none
                # holds live work, so the refusal is permanent (a prompt
                # over the pool on non-chunked paged replicas) and waiting
                # would spin run_to_completion forever. The session's
                # never-fits terminalization, one level up.
                if candidates and not any(
                    h.session.active or h.session._readmit
                    for h in self.placeable_replicas
                ):
                    self.pending.popleft()
                    self._terminal(rreq, RSTATUS_FAILED, "never_fits")
                    continue
                break
            if isinstance(bound, ReplicaHandle):
                self.pending.popleft()
                placed += 1
        return placed

    # ---- terminal bookkeeping --------------------------------------------

    def _terminal(self, rreq: RouterRequest, status: str, reason: Optional[str]):
        rreq.status = status
        if status == RSTATUS_REJECTED:
            rreq.fail_reason = reason
            self.rejected[rreq.req_id] = self.requests.pop(
                rreq.req_id, rreq
            )
            # same bound as the front-door path: rejection volume is
            # attacker-controlled (this path serves session-side verdicts
            # when admission_validation is off at the router)
            while len(self.rejected) > REJECTED_HISTORY_MAX:
                self.rejected.pop(next(iter(self.rejected)))
            self.tel.router_rejected(rreq.req_id, reason or "rejected")
        elif status == RSTATUS_FAILED:
            rreq.fail_reason = reason

    # ---- steady state ----------------------------------------------------

    def step(self) -> Dict[str, int]:
        """One router tick, in phases that never overlap the worker
        threads' (the threaded pool runs ONLY the stepping phase; the
        router thread blocks on its barrier): place queued requests,
        harvest externally-killed replicas, advance every alive replica
        (concurrently under ``router_threading``), then — back on the
        router thread, replica by replica in id order — merge results, sync
        terminal outcomes (detecting dispatch give-ups), fail over dead
        replicas, and publish the per-replica gauges. Returns
        {req_id: token} for tokens produced this step across all replicas.
        Per-replica sessions are independent, so the threaded and
        sequential phase orders commit identical state (byte-identical
        tokens)."""
        self._step_index += 1
        results: Dict[str, int] = {}
        if not self.alive_replicas:
            # total outage observed at a step boundary (every replica dead):
            # surface the remaining work as typed verdicts NOW — external
            # drivers (the open-loop WorkloadDriver) step the router
            # directly and must observe the same never-a-wedge guarantee
            # run_to_completion provides. Gauges still publish: a dashboard
            # must show the dead fleet (health 0, queue drained), not the
            # last pre-outage reading
            self._fail_total_outage()
            self._publish_gauges()
            return results
        self._place_pending()
        for h in self.replicas:
            if not h.alive and h.owned:
                # killed externally (operator kill()) since last step:
                # harvest + fail its live requests over before stepping, so
                # they re-place with everyone else's below
                self._failover_replica(h, h.health_reason or "dead")
        for h, step_results in self._step_replicas(self.alive_replicas):
            if not h.alive:  # WatchdogError -> DEAD inside handle.step
                self._failover_replica(h, h.health_reason or "dead")
                continue
            for sid, tok in step_results.items():
                rreq = h.owned.get(sid)
                if rreq is not None:
                    results[rreq.req_id] = tok
            self._sync_terminals(h)
            if not h.alive:
                # a give-up observed in the sync crossed the death threshold
                self._failover_replica(h, h.health_reason or "dead")
        # requests failed over this step re-place immediately so they
        # resume on the next device step, not one router tick later
        self._place_pending()
        self._finalize_retired()
        self._publish_gauges()
        return results

    def _step_replicas(self, alive: List[ReplicaHandle]):
        """The replica-stepping phase: advance every alive replica one
        step and return [(handle, step results), ...] in replica order.
        Sequential without the pool; with ``router_threading`` each
        handle's step() runs on its own persistent worker and the loop of
        ``join_step`` calls is the per-step barrier (a worker exception
        re-raises HERE, on the router thread). Telemetry — per-replica
        step wall + the phase span feeding the overlap fraction — is
        recorded after the barrier, on the router thread, through the
        identical path in both modes."""
        t0 = self.tel.clock()
        if self._workers:
            workers = [self._workers[h.replica_id] for h in alive]
            for w in workers:
                w.dispatch()
            # complete the barrier for EVERY worker BEFORE any error can
            # re-raise: bailing on the first failed join would leave a
            # sibling's job outstanding, and the next step()'s dispatch
            # would pair step N's result with step N+1's join while the
            # worker still runs — overlapping the router phase with a live
            # worker, exactly what the barrier exists to forbid. (A worker
            # exception is a programming error — WatchdogError never
            # escapes handle.step — so the siblings' already-committed
            # session state simply waits for the next sync, like the
            # sequential path's not-yet-stepped replicas.)
            for w in workers:
                w.wait_done()
            stepped = [(h, w.join_step()) for h, w in zip(alive, workers)]
        else:
            stepped = [(h, h.step()) for h in alive]
        if alive:
            wall_ms = (self.tel.clock() - t0) * 1e3
            for h in alive:
                self.tel.replica_step(h.replica_id, h.last_step_ms)
            self.tel.router_step_timing(
                wall_ms, sum(h.last_step_ms for h in alive)
            )
        return stepped

    def close(self) -> None:
        """Join the thread-per-replica stepping pool (idempotent; no-op for
        a sequential router). After close() the router still steps — it
        falls back to sequential stepping — but the usual lifecycle is
        drain, then close. The thread-leak pin: no worker thread survives
        this call. On a card it also orders the caller's stream after every
        replica's and tier member's queued work, so what the caller does
        next to the apps (``init_kv_cache``) runs after it."""
        self._closed = True
        workers, self._workers = self._workers, {}
        for w in workers.values():
            w.shutdown()
        for h in [*self.replicas, *self.prefill_replicas]:
            h.join_stream()

    def __enter__(self) -> "ServingRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- elastic fleet ---------------------------------------------------

    def add_replica(self, replica, replica_id: Optional[int] = None) -> ReplicaHandle:
        """Graceful scale-out: join a warmed replica (a ReplicaHandle or a
        bare serving session, wrapped with the next free id) to the pool
        and to placement mid-run. The new handle is validated exactly like
        an __init__-time one (duplicate id, disaggregated-tier cache/
        admission constraints), gets its own stepping worker under
        ``router_threading`` (unless the pool is already closed — then it
        steps sequentially like everyone else), publishes its gauges, and
        immediately participates in placement — queued head-of-line work
        binds to it before this call returns."""
        h = replica if isinstance(replica, ReplicaHandle) else ReplicaHandle(
            replica,
            self._next_replica_id if replica_id is None else replica_id,
        )
        if any(h.replica_id == o.replica_id for o in self.replicas):
            raise ValueError(
                f"duplicate replica id {h.replica_id}: "
                f"{[o.replica_id for o in self.replicas]}"
            )
        if self.prefill_replicas:
            # same constraints the constructor enforces: the tier hands KV
            # into contiguous cache lines and cannot feed a draft cache
            if h.session.block_mode:
                raise ValueError(
                    "the disaggregated prefill tier hands KV over into "
                    "contiguous cache lines: added replica "
                    f"{h.replica_id} runs the paged cache"
                )
            if not h.session.prefilled_admission:
                raise NotImplementedError(
                    "the disaggregated prefill tier does not support "
                    "speculative decode sessions"
                )
        self.replicas.append(h)
        self._next_replica_id = max(self._next_replica_id, h.replica_id + 1)
        if self.threaded and not self._closed:
            self._workers[h.replica_id] = _ReplicaStepWorker(h)
        self.tel.router_replica_gauges(
            h.replica_id, h.occupancy, h.queue_depth, HEALTH_GAUGE[h.health]
        )
        self.tel.router_elastic("add", h.replica_id)
        self._place_pending()
        return h

    def retire_replica(self, replica_id: int, drain: bool = True) -> None:
        """Graceful scale-in: stop placing NEW work on ``replica_id`` and
        give its replica back. ``drain=True`` (default) lets the replica
        finish what it owns — it keeps stepping, and once its last request
        reaches a terminal outcome the handle is finalized (worker joined,
        gauges zeroed, handle removed; the caller may then free the app).
        ``drain=False`` re-queues everything it owns onto the survivors NOW
        through the standard failover machinery (committed tokens kept,
        byte-identical resume) and finalizes immediately. Retiring the last
        placeable replica is refused — the router must never place itself
        into a self-inflicted total outage. Idempotent per id."""
        h = next(
            (o for o in self.replicas if o.replica_id == replica_id), None
        )
        if h is None:
            raise KeyError(f"unknown replica id {replica_id}")
        if replica_id in self._retiring:
            return
        if not any(
            o.alive and o.replica_id != replica_id for o in self.replicas
            if o.replica_id not in self._retiring
        ):
            raise ValueError(
                f"cannot retire replica {replica_id}: it is the last "
                "placeable replica (add_replica first, or close the router)"
            )
        self._retiring.add(replica_id)
        self.tel.router_elastic("retire", replica_id)
        if not drain and h.alive:
            # immediate hand-back: mark it dead like an operator kill and
            # run the standard dead-replica path — harvest, re-queue onto
            # the survivors (oldest first), then finalize below
            h.kill("retired")
            self._failover_replica(h, "retired")
            self._place_pending()
        self._finalize_retired()

    def _finalize_retired(self) -> None:
        """Finalize every retiring replica whose drain is complete: sync
        the last terminal outcomes, fail over anything a replica that DIED
        mid-drain still owned, join its stepping worker, zero its gauges
        and remove the handle from the pool. Called after every step and
        from retire_replica; a replica still draining is left alone."""
        for h in [
            o for o in self.replicas if o.replica_id in self._retiring
        ]:
            if h.alive and (
                h.owned or h.session.active or h.session._readmit
            ):
                continue  # still draining
            if not h.alive and h.owned:
                # died mid-drain: its live requests fail over like any
                # other replica death (ownership transfers to the survivors)
                self._failover_replica(h, h.health_reason or "retired")
            self._sync_terminals(h)
            w = self._workers.pop(h.replica_id, None)
            if w is not None:
                w.shutdown()  # joins the worker thread
            h.join_stream()
            self.replicas.remove(h)
            self._retiring.discard(h.replica_id)
            self.tel.router_replica_gauges(
                h.replica_id, 0, 0, HEALTH_GAUGE[h.health]
            )
            self.tel.router_elastic("retire_done", h.replica_id)

    def _sync_terminals(self, h: ReplicaHandle) -> None:
        """Fold this replica's terminal session outcomes into the router
        records. FAILED(dispatch_error) is a health event AND (bounded) a
        failover: at router level a dispatch-retry exhaustion is
        non-terminal while other capacity survives — the request resumes
        from its committed tokens elsewhere."""
        for sid in list(h.owned):
            # sids enter `owned` only after a truthy session admission, so
            # the session record lives in `requests` (REJECTED is an
            # add_request-only transition and never lands in `owned`)
            sreq = h.session.requests.get(sid)
            if sreq is None or not sreq.finished:
                continue
            rreq = h.owned.pop(sid)
            h._placed_t.pop(sid, None)
            rreq.tokens.extend(sreq.generated)
            if sreq.status == "finished":
                rreq.status = RSTATUS_FINISHED
                continue
            # FAILED(...)
            if sreq.fail_reason == "dispatch_error":
                h.note_give_up()
                self._failover_request(rreq, "dispatch_error")
            else:
                # non_finite (quarantine — re-running poisoned input
                # elsewhere would poison another replica), deadline_exceeded,
                # terminal preempted: the session's verdict stands
                self._terminal(rreq, RSTATUS_FAILED, sreq.fail_reason)

    def _failover_request(self, rreq: RouterRequest, cause: str) -> None:
        """Re-queue one request (committed tokens kept) ahead of new
        arrivals, bounded by ``max_failovers``."""
        if rreq.remaining_budget <= 0:
            rreq.status = RSTATUS_FINISHED
            return
        if rreq.failovers >= self.max_failovers or not self.alive_replicas:
            self._terminal(rreq, RSTATUS_FAILED, cause)
            return
        rreq.failovers += 1
        rreq.status = RSTATUS_QUEUED
        rreq.replica = None
        self.pending.appendleft(rreq)
        self.tel.router_failover(rreq.req_id, cause)

    def _failover_replica(self, h: ReplicaHandle, cause: str) -> None:
        """A replica died: sync what terminally finished there, then roll
        every live request back to committed host state and re-queue it
        (oldest first, AHEAD of new arrivals) for the survivors."""
        self._sync_terminals(h)
        self.tel.router_replica_gauges(
            h.replica_id, 0, 0, HEALTH_GAUGE[h.health]
        )
        harvested = []
        for _sid, rreq, committed in h.harvest():
            rreq.tokens.extend(committed)
            harvested.append(rreq)
        # appendleft reverses, so feed it newest-first to keep FIFO order
        for rreq in reversed(harvested):
            self._failover_request(rreq, cause)

    def _publish_gauges(self) -> None:
        occs = []
        for h in self.replicas:
            # a dead replica's session is abandoned — its slot table still
            # reads occupied, but reporting that would tell an operator the
            # dead replica holds live work it does not
            occ = h.occupancy if h.alive else 0
            qd = h.queue_depth if h.alive else 0
            self.tel.router_replica_gauges(
                h.replica_id, occ, qd, HEALTH_GAUGE[h.health]
            )
            if h.alive:
                occs.append(occ)
        spread = (max(occs) - min(occs)) if occs else 0
        self.tel.router_step_gauges(len(self.pending), spread)
        self._publish_tier_gauges()

    @property
    def has_live_work(self) -> bool:
        # h.owned covers requests whose terminal SESSION outcome has not
        # been synced into the router record yet (e.g. a request finishing
        # at admission-time prefill, before any step ran) — and, on a DEAD
        # replica, requests awaiting harvest + failover
        return bool(self.pending) or any(
            bool(h.owned)
            or (h.alive and (h.session.active or h.session._readmit))
            for h in self.replicas
        )

    def run_to_completion(self) -> Dict[str, List[int]]:
        """Drain every queued and in-flight request. Replica failures along
        the way fail over; only a TOTAL outage (every replica dead) fails
        the remaining requests — as typed verdicts, never a raise. Returns
        {req_id: committed tokens} for every request ever admitted."""
        while self.has_live_work:
            if not self.alive_replicas:
                self._fail_total_outage()
                break
            self.step()
        return {rid: r.tokens for rid, r in self.requests.items()}

    def _fail_total_outage(self) -> None:
        """Every replica is dead: harvest the dead replicas' live requests
        (each terminalizes typed inside ``_failover_request`` — there is
        nowhere left to fail over to), then fail the queue as typed
        ``no_replicas`` verdicts. Never a raise, never a wedge."""
        for h in self.replicas:
            if h.owned:
                self._failover_replica(h, h.health_reason or "dead")
        for rreq in list(self.pending):
            self._terminal(rreq, RSTATUS_FAILED, "no_replicas")
        self.pending.clear()

    def diagnostic_snapshot(self) -> dict:
        """Operator view: replica healths + load signals, queue, terminal
        census."""
        by_status: Dict[str, int] = {}
        for r in self.requests.values():
            by_status[r.status] = by_status.get(r.status, 0) + 1
        return {
            "step_index": self._step_index,
            "policy": self.policy,
            "queue_depth": len(self.pending),
            "requests_by_status": by_status,
            "rejected": len(self.rejected),
            "prefill_tier": [
                {
                    "replica_id": ph.replica_id,
                    "health": ph.health,
                    "health_reason": ph.health_reason,
                    "handoffs": ph.handoffs,
                    "give_ups": ph.give_ups,
                }
                for ph in self.prefill_replicas
            ],
            "replicas": [
                {
                    "replica_id": h.replica_id,
                    "health": h.health,
                    "health_reason": h.health_reason,
                    "occupancy": h.occupancy,
                    "queue_depth": h.queue_depth,
                    "tokens_served": h.tokens_served,
                    "ewma_step_ms": round(h.ewma_step_ms, 3),
                    "ewma_queue_wait_ms": round(h.ewma_queue_wait_ms, 3),
                    "kv_free_bytes": h.session.kv_free_bytes,
                }
                for h in self.replicas
            ],
        }


def partition_devices(n_replicas: int, devices=None) -> List[List[torch.device]]:
    """Split the device set into ``n_replicas`` per-replica device lists
    (``devices`` defaults to every visible card, else the CPU): replica i
    builds its app on its own part, so N sessions run side by side with no
    shared device state. With fewer devices than replicas, replicas share
    them round-robin (correct, each session owns its cache, but the shared
    card runs their work interleaved)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(n)] or [torch.device("cpu")]
    devices = [torch.device(d) for d in devices]
    if n_replicas < 1:
        raise ValueError("n_replicas must be >= 1")
    if len(devices) >= n_replicas:
        per = len(devices) // n_replicas
        return [list(devices[i * per : (i + 1) * per]) for i in range(n_replicas)]
    return [[devices[i % len(devices)]] for i in range(n_replicas)]
