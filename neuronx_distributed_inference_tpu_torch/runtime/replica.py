"""Replica handle: one serving session behind the multi-replica router
(counterpart of the reference's ``runtime/replica.py``).

A :class:`ReplicaHandle` wraps ONE :class:`~.serving.ServingSession` (or
:class:`~.serving.SpeculativeServingSession`) over its own application: its
own weights and its own KV cache, on its own card or sharing one card with
other replicas (``router.partition_devices``). The handle owns what the
router schedules by:

- **Health** ``HEALTHY -> DEGRADED -> DEAD``: a dispatch-retry exhaustion
  observed on this replica degrades it, a second one kills it; a
  :class:`~.faults.WatchdogError` escaping ``step()`` kills it at once
  (caught here: the router never sees a raise); ``kill()`` is the operator
  switch. A DEGRADED replica recovers after ``recovery_steps`` clean steps;
  a DEAD one is never stepped or placed on again.
- **Load signals** for placement: live occupancy, the re-admission backlog,
  ``kv_free_bytes`` headroom (in the cache dtype) and two EWMAs, of the
  step wall ms and of the placement-to-first-output wait, both on the
  router's clock.
- **Harvest on death**: every non-terminal request rolls back to its
  committed host state and goes back to the router for failover (greedy
  decode regenerates the same tokens after re-placement).
- **Its stream**: on a card every piece of a replica's device work (its
  steps, its admissions, a hand-off's inject) runs on the app's own CUDA
  stream (:func:`app_stream`), so replicas sharing a card do not serialize
  on one stream when the router steps them from several threads, and each
  replica's work stays in order whichever thread issues it.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from neuronx_distributed_inference_tpu_torch.runtime.faults import WatchdogError

HEALTH_HEALTHY = "healthy"
HEALTH_DEGRADED = "degraded"
HEALTH_DEAD = "dead"

#: gauge encoding for nxdi_router_replica_health
HEALTH_GAUGE = {HEALTH_HEALTHY: 2, HEALTH_DEGRADED: 1, HEALTH_DEAD: 0}

#: EWMA smoothing for the step-time / queue-wait load signals
EWMA_ALPHA = 0.2


def app_stream(app) -> Optional[torch.cuda.Stream]:
    """The CUDA stream the router runs ``app``'s work on: one per app, made
    at first use, so a session that re-joins over a warm app runs after the
    one it replaced. Each call orders it after the work already queued on
    the caller's current stream (the load, ``init_kv_cache``): a handle
    takes it when it is made. None on the CPU."""
    if app.device.type != "cuda":
        return None
    stream = app.__dict__.get("_replica_stream")
    if stream is None:
        stream = app.__dict__["_replica_stream"] = torch.cuda.Stream(app.device)
    stream.wait_stream(torch.cuda.current_stream(app.device))
    return stream


class _HealthStateMachine:
    """The HEALTHY -> DEGRADED -> DEAD machine of decode
    :class:`ReplicaHandle` and prefill-tier :class:`PrefillReplicaHandle`
    members: a bounded-retry exhaustion against the member
    (:meth:`note_give_up`) degrades it, ``dead_after_give_ups`` of them
    kill it, ``kill()`` is the operator switch, and death is terminal.
    Subclasses set :attr:`GIVE_UP_REASON` and implement
    :meth:`_reset_clean`; each owns its recovery clock (clean STEPS for
    decode replicas, clean HAND-OFFS for tier members)."""

    GIVE_UP_REASON = "dispatch_error"

    @property
    def alive(self) -> bool:
        return self.health != HEALTH_DEAD

    def kill(self, reason: str = "killed") -> None:
        """Declare this member DEAD. A decode replica's live requests are
        harvested and failed over on the router's next step; a tier member
        owns no requests."""
        self._set_health(HEALTH_DEAD, reason)

    def _set_health(self, state: str, reason: Optional[str]) -> None:
        if self.health == HEALTH_DEAD:
            return  # death is terminal
        self.health = state
        self.health_reason = reason

    def note_give_up(self) -> None:
        """A bounded retry exhausted against this member: the first
        degrades it, ``dead_after_give_ups`` kill it."""
        self.give_ups += 1
        self._reset_clean()
        if self.give_ups >= self.dead_after_give_ups:
            self._set_health(HEALTH_DEAD, self.GIVE_UP_REASON)
        else:
            self._set_health(HEALTH_DEGRADED, self.GIVE_UP_REASON)

    def _reset_clean(self) -> None:
        raise NotImplementedError

    def device_scope(self):
        """Run the enclosed device work on this member's stream (nothing on
        the CPU)."""
        return torch.cuda.stream(self.stream) if self.stream is not None else contextlib.nullcontext()

    def join_stream(self) -> None:
        """Order the caller's current stream after this member's queued
        work (the router calls it when it lets a replica go), so what the
        caller does next to the app (``init_kv_cache``) runs after it."""
        if self.stream is not None:
            torch.cuda.current_stream(self.stream.device).wait_stream(self.stream)


class ReplicaHandle(_HealthStateMachine):
    def __init__(
        self,
        session,
        replica_id: int,
        clock: Optional[Callable[[], float]] = None,
        dead_after_give_ups: int = 2,
        recovery_steps: int = 32,
    ):
        """``session``: a serving session over this replica's app.
        ``dead_after_give_ups``: dispatch-retry exhaustions before the
        replica is DEAD (the first only degrades it); ``recovery_steps``:
        consecutive clean steps before DEGRADED recovers to HEALTHY."""
        self.session = session
        self.replica_id = int(replica_id)
        # the session's step-timing / watchdog records land on this
        # replica's timeline track
        session._tel_replica = self.replica_id
        self.stream = app_stream(session.app)
        self._clock = clock if clock is not None else time.monotonic
        self.dead_after_give_ups = int(dead_after_give_ups)
        self.recovery_steps = int(recovery_steps)
        self.health = HEALTH_HEALTHY
        self.health_reason: Optional[str] = None
        self.give_ups = 0  # dispatch-retry exhaustions observed
        self._clean_steps = 0
        self.steps = 0
        # committed tokens this replica produced since it was wrapped: the
        # session's monotone commit counter (admission-time first tokens
        # and multi-token speculation commits included)
        self._committed_base = int(getattr(session, "_committed_total", 0))
        self.tokens_served = 0
        self.watchdog_error: Optional[WatchdogError] = None
        # router-owned requests on this replica: session req id ->
        # RouterRequest (the session id carries a failover suffix, so a
        # request's incarnations never alias inside one session)
        self.owned: Dict[str, object] = {}
        # placement time per session id: the first-output wait is observed
        # when the request's first token arrives
        self._placed_t: Dict[str, float] = {}
        self.ewma_step_ms = 0.0
        self.ewma_queue_wait_ms = 0.0
        # wall of the most recent step(), read by the router thread after
        # the per-step barrier (one thread steps a handle at a time)
        self.last_step_ms = 0.0

    def _reset_clean(self) -> None:
        self._clean_steps = 0

    # ---- stepping --------------------------------------------------------

    def step(self) -> Dict[str, int]:
        """Advance the wrapped session one step, on this replica's stream.
        A WatchdogError becomes replica DEATH (never a router-wide raise);
        the step's wall time and any first-output waits feed the EWMA
        load signals."""
        if not self.alive:
            return {}
        t0 = self._clock()
        try:
            with self.device_scope():
                results = self.session.step()
        except WatchdogError as e:
            self.watchdog_error = e
            self._set_health(HEALTH_DEAD, "watchdog")
            self.last_step_ms = (self._clock() - t0) * 1e3
            return {}
        now = self._clock()
        self.steps += 1
        dt_ms = (now - t0) * 1e3
        self.last_step_ms = dt_ms
        self.ewma_step_ms = dt_ms if self.steps == 1 else EWMA_ALPHA * dt_ms + (1 - EWMA_ALPHA) * self.ewma_step_ms
        for sid in results:
            t_place = self._placed_t.pop(sid, None)
            if t_place is None:
                continue
            qw_ms = (now - t_place) * 1e3
            self.ewma_queue_wait_ms = (
                qw_ms
                if self.ewma_queue_wait_ms == 0.0
                else EWMA_ALPHA * qw_ms + (1 - EWMA_ALPHA) * self.ewma_queue_wait_ms
            )
        self.tokens_served = int(getattr(self.session, "_committed_total", 0)) - self._committed_base
        if self.health == HEALTH_DEGRADED and self.give_ups < self.dead_after_give_ups:
            self._clean_steps += 1
            if self._clean_steps >= self.recovery_steps:
                self.give_ups = 0
                self._set_health(HEALTH_HEALTHY, None)
        return results

    # ---- load signals ----------------------------------------------------

    @property
    def occupancy(self) -> int:
        return len(self.session.active)

    @property
    def queue_depth(self) -> int:
        """Live rows plus the re-admission backlog: what a new placement
        queues behind."""
        return len(self.session.active) + len(self.session._readmit)

    #: weight of the speculation acceptance-EWMA placement term: a sub-unit
    #: bonus that concentrates spec traffic where drafts are paying
    ACCEPTANCE_WEIGHT = 0.5

    @property
    def acceptance_signal(self) -> Optional[float]:
        """The wrapped session's speculation acceptance-rate EWMA (None for
        a plain session, or before any spec round ran)."""
        return getattr(self.session, "acceptance_ewma", None)

    def load_score(self, latency_norm_ms: float) -> float:
        """Load score (lower = less loaded). Terms, in dominance order: the
        re-admission backlog (each evicted request waiting outweighs a full
        batch), the occupancy fraction, the KV-pool usage fraction, the
        EWMA latency signals normalized by ``latency_norm_ms`` (the largest
        across candidates, so they stay a sub-unit tie-splitter), MINUS an
        acceptance-EWMA bonus for speculative replicas."""
        s = self.session
        occ_frac = len(s.active) / max(1, s.num_slots)
        backlog = len(s._readmit)
        pool = s.kv_pool_bytes
        kv_used_frac = (1.0 - s.kv_free_bytes / pool) if pool else occ_frac
        latency = (self.ewma_step_ms + self.ewma_queue_wait_ms) / latency_norm_ms if latency_norm_ms > 0 else 0.0
        accept = self.acceptance_signal or 0.0
        return 4.0 * backlog + occ_frac + kv_used_frac + latency - self.ACCEPTANCE_WEIGHT * accept

    @property
    def latency_signal_ms(self) -> float:
        return self.ewma_step_ms + self.ewma_queue_wait_ms

    # ---- failover --------------------------------------------------------

    def harvest(self) -> List[Tuple[str, object, List[int]]]:
        """Collect every non-terminal request off this (dead) replica as
        ``(session_id, router_request, committed_tokens)``: in-flight
        device work is dropped and the committed prefix is what the
        request resumes from. Clears this handle's ownership; the session
        is abandoned with the replica."""
        out: List[Tuple[str, object, List[int]]] = []
        sess = self.session
        for sid, rreq in list(self.owned.items()):
            sreq = sess.requests.get(sid)
            if sreq is None or sreq.finished:
                continue  # terminal outcomes were synced by the router
            sreq.finished = True  # abandoned with the replica
            out.append((sid, rreq, list(sreq.generated)))
        self.owned.clear()
        self._placed_t.clear()
        sess._readmit.clear()
        return out


class PrefillReplicaHandle(_HealthStateMachine):
    """One member of the disaggregated PREFILL tier behind the router
    (``Config.router_prefill_replicas``).

    Wraps a prefill-stage :class:`~.application.ModelForCausalLM`
    (``is_prefill_stage=True``, though a full app works too) over the
    contiguous cache. It owns no session and no requests: a hand-off is
    synchronous, on the router thread during placement — the router asks
    it to :meth:`run_prefill` a prompt (context encoding into its cache
    line 0, then the line's extract) and injects the payload into the
    chosen decode replica. A member dying mid-hand-off loses only work the
    request replays from its prompt.

    Health mirrors :class:`ReplicaHandle`: a hand-off retry exhaustion
    against this member degrades it, a second kills it; a DEGRADED member
    keeps taking hand-offs and recovers after ``recovery_handoffs`` clean
    ones; only a fully DEAD tier sends the router to local prefill."""

    GIVE_UP_REASON = "handoff"

    def __init__(
        self,
        app,
        replica_id: int,
        fault_injector=None,
        dead_after_give_ups: int = 2,
        recovery_handoffs: int = 8,
    ):
        tc = app.config.torch_config
        if tc.is_prefill_stage is False:
            raise ValueError(
                "PrefillReplicaHandle needs a prefill-capable app "
                "(is_prefill_stage=True, or a full app) — a decode-stage "
                "app compiles no context-encoding programs"
            )
        from neuronx_distributed_inference_tpu_torch.runtime.disaggregated import _plain_cache

        _plain_cache(app)  # raises NotImplementedError for a paged cache
        self.app = app
        self.replica_id = int(replica_id)
        self.faults = fault_injector
        self.stream = app_stream(app)
        self.dead_after_give_ups = int(dead_after_give_ups)
        self.recovery_handoffs = int(recovery_handoffs)
        self.health = HEALTH_HEALTHY
        self.health_reason: Optional[str] = None
        self.give_ups = 0
        self._clean_handoffs = 0
        self.handoffs = 0  # completed prefill + extract passes

    def _reset_clean(self) -> None:
        self._clean_handoffs = 0

    def note_clean(self) -> None:
        """One hand-off completed cleanly through this member; enough of
        them recover a DEGRADED member to HEALTHY."""
        if self.health == HEALTH_DEGRADED and self.give_ups < self.dead_after_give_ups:
            self._clean_handoffs += 1
            if self._clean_handoffs >= self.recovery_handoffs:
                self.give_ups = 0
                self._set_health(HEALTH_HEALTHY, None)

    def run_prefill(self, input_ids) -> Tuple[int, dict]:
        """Context-encode ``input_ids`` (1-D) into this member's cache line
        0 and extract the populated KV as a hand-off payload, on this
        member's stream. Returns ``(first_token, payload)``; the first token
        may be the non-finite sentinel (< 0), which the decode session's
        admission quarantines as after a local prefill.

        A prompt longer than one context program runs the windowed path
        (``application._windowed_prefill`` at B=1 on line 0). The payload
        is a device copy, so the line is free for the next hand-off at
        once. Transient dispatch errors propagate to the router's bounded
        hand-off retry."""
        from neuronx_distributed_inference_tpu_torch.modules.sampling import prepare_sampling_params
        from neuronx_distributed_inference_tpu_torch.runtime.disaggregated import extract_request_kv

        app = self.app
        ids = np.asarray(input_ids, np.int32).reshape(1, -1)
        S = ids.shape[1]
        mask = np.ones((1, S), np.int32)
        seq_ids = np.zeros((1,), np.int32)
        with self.device_scope():
            if app.validate_prefill_length(S):
                tokens_dev, _ = app._windowed_prefill(ids, mask, seq_ids, prepare_sampling_params(1))
            else:
                pos = np.arange(S, dtype=np.int32)[None, :]
                cte = app.context_encoding_model
                inputs, _ = cte.prepare(ids, mask, pos, seq_ids)
                out = cte(app.params, app.kv_cache, inputs)
                app.kv_cache = out.cache
                tokens_dev = out.tokens
            payload = extract_request_kv(app, seq_ids, upto=S)
            first = int(tokens_dev[0, -1].item())
        self.handoffs += 1
        return first, payload
