"""Open-loop workload driver: arrivals on a virtual clock, not a drain
(counterpart of the reference's ``workload/driver.py``).

A drain is CLOSED-loop: it feeds the next
request whenever the session has a free slot, so the server sets the pace
and can never be overloaded. Production is open-loop — requests arrive when
users send them — and the number that matters is what happens when the
arrival rate and the service rate disagree. This driver runs a
:class:`~..runtime.router.ServingRouter` (or a single serving session) under
a :class:`~.generator.WorkloadTrace`:

- **Virtual clock.** One ``step()`` == one virtual second
  (``step_dt_s``). Construct the sessions / router / telemetry with
  ``clock=VirtualClock().now`` and every wall-clock policy in the stack —
  the per-request deadline TTLs, the telemetry ``RequestTrace``
  timestamps the SLO scorer consumes, the replica load EWMAs — runs on
  deterministic virtual time, so a seeded workload drives a byte-identical
  run every time (pinned sequential AND ``router_threading``).
- **Open-loop admission.** A request is offered to the target no earlier
  than its arrival step (``admissions`` records arrival vs admitted step —
  the open-loop pin inspects them). Head-of-line FIFO: a refused arrival
  (``no_slot`` / ``kv_blocks`` / ``backlog``) waits in the driver backlog
  and retries every step — its SLO clock keeps running from ARRIVAL, so
  backlog time counts against goodput; past ``max_backlog_steps`` the
  driver gives up and records the terminal refusal as
  ``nxdi_requests_rejected_total{reason=backlog}`` (the reason the
  clean-traffic containment checks exclude). Validation verdicts
  are terminal immediately (scored ``never_served``).
- **Commit attribution.** After every step the driver folds each live
  request's committed-token delta into ``step_commits`` — the per-step
  per-request token series :mod:`.slo` buckets into the goodput series the
  chaos metrics (dip depth, recovery time) are extracted from. For a router
  target the count reads only the audited host-snapshot surface
  (``RouterRequest.tokens`` + the current incarnation's committed
  ``generated`` via ``ReplicaHandle.owned``).
- **Chaos.** A seeded :class:`ChaosPlan` kills one alive replica at a fixed
  step mid-run (the router's failover re-queues its requests); the
  driver records which replica died so the scorer can anchor the dip window.
- **Speculation profiles.** When the trace carries per-tenant
  ``spec_accept_rate`` profiles and the target session(s) are speculative,
  the driver installs :func:`~.generator.make_accept_gate` as
  ``session.draft_accept_cap`` — the CPU-harness draft-agreement model that
  makes adaptive draft lengths move per tenant without changing one output
  byte.

Everything here is host bookkeeping: no device fetches and no writes into router/session internals beyond the public
``add_request``/``step``/``kill`` surface.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from neuronx_distributed_inference_tpu_torch.telemetry.tracing import default_session
from neuronx_distributed_inference_tpu_torch.workload.generator import (
    WorkloadTrace,
    make_accept_gate,
)

#: capacity refusal reasons the backlog retries (anything else offered back
#: by the target is a terminal verdict)
RETRYABLE_REFUSALS = frozenset({"no_slot", "kv_blocks", "backlog"})


class VirtualClock:
    """A monotone host clock the driver advances one step at a time. Pass
    ``clock=vc.now`` to sessions / router handles / the telemetry session so
    deadlines, EWMAs and trace timestamps all run on virtual time."""

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        self._t += float(dt)
        return self._t


@dataclass(frozen=True)
class ChaosPlan:
    """Seeded replica-kill schedule (driver step indices).

    The base plan kills ONE alive replica at ``kill_step``; ``replica=None``
    picks the victim with a seeded draw among the members alive at that
    step — reproducible chaos. Two extensions:

    - **tier targeting**: ``tier="prefill"`` draws victims from the
      router's disaggregated prefill tier (``router.prefill_replicas``)
      instead of the decode replicas — the tier-kill scenario whose goodput
      must NOT dip like a decode kill (decode capacity survives; placements
      degrade to local prefill / surviving tier members).
    - **multi-kill**: ``kills=N`` fires N sequential kills starting at
      ``kill_step``, ``gap_steps`` apart, each drawing a fresh seeded
      victim from the tier's then-alive set (kills with nobody left alive
      are skipped, recorded as exhausted).

    Same seed + same trace => byte-identical kill schedule and outputs"""

    kill_step: int
    replica: Optional[int] = None
    seed: int = 0
    tier: str = "decode"  # or "prefill" (disaggregated prefill tier)
    kills: int = 1
    gap_steps: int = 1


@dataclass
class AdmissionEvent:
    req_id: str
    arrival_step: int
    admitted_step: int
    attempts: int  # add_request calls it took (1 == admitted on arrival)


@dataclass
class WorkloadResult:
    """One open-loop run, scorer-ready (:func:`workload.slo.score`)."""

    trace: WorkloadTrace
    outputs: Dict[str, List[int]] = field(default_factory=dict)
    statuses: Dict[str, str] = field(default_factory=dict)
    admissions: List[AdmissionEvent] = field(default_factory=list)
    #: terminal driver-level refusals: backlog give-ups + validation rejects
    never_served: Dict[str, str] = field(default_factory=dict)
    #: per driver step: {req_id: tokens committed that step}
    step_commits: List[Dict[str, int]] = field(default_factory=list)
    #: per driver step: the target still held (or could receive) live work
    live_steps: List[bool] = field(default_factory=list)
    backlog_refusals: int = 0  # refused admission attempts (retried)
    steps: int = 0
    step_dt_s: float = 1.0
    chaos: Optional[dict] = None


class WorkloadDriver:
    def __init__(
        self,
        target,
        trace: WorkloadTrace,
        *,
        clock: Optional[VirtualClock] = None,
        telemetry=None,
        step_dt_s: float = 1.0,
        max_backlog_steps: Optional[int] = None,
        chaos: Optional[ChaosPlan] = None,
        max_total_steps: int = 100_000,
    ):
        """``target``: a ServingRouter or a single serving session (detected
        by the ``replicas`` attribute). ``clock``: the virtual clock this
        driver advances — pass the SAME clock's ``now`` into the sessions,
        router handles and telemetry session for a fully deterministic run.
        ``max_backlog_steps``: give up on an arrival stuck in the backlog
        this long (None = retry until served). ``chaos``: optional seeded
        replica kill (router targets only)."""
        self.target = target
        self.trace = trace
        self.clock = clock if clock is not None else VirtualClock()
        self.tel = telemetry if telemetry is not None else default_session()
        self.step_dt_s = float(step_dt_s)
        self.max_backlog_steps = max_backlog_steps
        self.chaos = chaos
        self.max_total_steps = int(max_total_steps)
        self._is_router = hasattr(target, "replicas")
        if chaos is not None and not self._is_router:
            raise ValueError("ChaosPlan needs a router target (replica kill)")
        if chaos is not None:
            if chaos.tier not in ("decode", "prefill"):
                raise ValueError(
                    f"unknown ChaosPlan tier {chaos.tier!r} (decode/prefill)"
                )
            if chaos.tier == "prefill" and not getattr(
                target, "prefill_replicas", None
            ):
                raise ValueError(
                    "ChaosPlan(tier='prefill') needs a router with a "
                    "disaggregated prefill tier (router_prefill_replicas)"
                )
            if chaos.kills < 1 or chaos.gap_steps < 1:
                raise ValueError("ChaosPlan needs kills >= 1, gap_steps >= 1")
        self._chaos_rng = np.random.RandomState(
            chaos.seed if chaos is not None else 0
        )
        self._step = 0
        #: arrivals not yet admitted, FIFO by arrival step (the driver-side
        #: aging queue; refused heads block — later arrivals cannot overtake)
        self._pending = deque(trace.arrivals)
        self._attempts: Dict[str, int] = {}
        self._seen: Dict[str, int] = {}
        self._tracked: List[str] = []  # admitted req ids, commit attribution
        self.result = WorkloadResult(trace=trace, step_dt_s=self.step_dt_s)
        # span-timeline + live-SLO wiring: request spans land on
        # tenant tracks, and an attached SloMonitor learns every arrival's
        # clock origin and SLO terms before the drain starts
        if getattr(self.tel, "enabled", False):
            self.tel.set_tenants(trace.tenants_of)
            mon = getattr(self.tel, "slo_monitor", None)
            if mon is not None:
                mon.register_trace(trace, step_dt_s=self.step_dt_s)
        if any(a.spec_accept_rate is not None for a in trace.arrivals):
            self._install_accept_gate()

    # ---- wiring ----------------------------------------------------------

    def _sessions(self) -> List:
        if self._is_router:
            return [h.session for h in self.target.replicas]
        return [self.target]

    def _install_accept_gate(self) -> None:
        """Per-tenant spec-acceptance profiles -> the sessions' CPU-harness
        draft-agreement gate (no-op for non-speculative sessions)."""
        gate = make_accept_gate(self.trace)
        for sess in self._sessions():
            if hasattr(sess, "draft_accept_cap"):
                sess.draft_accept_cap = gate

    # ---- admission (open-loop front edge) --------------------------------

    def _backlog_depth(self) -> int:
        return sum(1 for a in self._pending if a.step <= self._step)

    def _admit_due(self) -> None:
        """Offer every due arrival, head-of-line FIFO: the oldest waiting
        arrival is offered first and a capacity refusal blocks the queue
        for this step (aging — later arrivals cannot claim the capacity an
        older one is waiting for). Terminal verdicts (validation, backlog
        give-up) drop out of the queue as never-served. The backlog
        give-up fires only AFTER a refused offer at the current step: an
        arrival that merely aged behind a blocked head is still offered —
        if capacity just freed it admits, and a give-up never precedes its
        first (or any) offer."""
        while self._pending and self._pending[0].step <= self._step:
            arr = self._pending[0]
            self._attempts[arr.req_id] = self._attempts.get(arr.req_id, 0) + 1
            verdict = self.target.add_request(
                arr.req_id,
                list(arr.input_ids),
                max_new_tokens=arr.max_new_tokens,
                deadline_s=arr.deadline_s,
            )
            if verdict:
                self._pending.popleft()
                self._tracked.append(arr.req_id)
                self.result.admissions.append(AdmissionEvent(
                    req_id=arr.req_id,
                    arrival_step=arr.step,
                    admitted_step=self._step,
                    attempts=self._attempts[arr.req_id],
                ))
                continue
            reason = verdict.reason or "refused"
            if reason in RETRYABLE_REFUSALS:
                self.result.backlog_refusals += 1
                self.tel.workload_refused(reason)
                if (
                    self.max_backlog_steps is not None
                    and self._step - arr.step > self.max_backlog_steps
                ):
                    # the open-loop give-up (this offer was refused AND the
                    # arrival is past its backlog budget): a terminal
                    # refusal the workload layer owns, recorded under the
                    # rejected counter's `backlog` reason — the one the
                    # clean-traffic containment checks exclude. The next waiting arrival gets its
                    # own offer this step.
                    self._pending.popleft()
                    self.result.never_served[arr.req_id] = "backlog"
                    self.tel.request_rejected(arr.req_id, "backlog")
                    continue
                break  # head-of-line: retry next step, keep FIFO order
            # terminal verdict (validation / never_fits / no_replicas):
            # the request is never served and scores as an SLO miss
            self._pending.popleft()
            self.result.never_served[arr.req_id] = reason

    # ---- chaos -----------------------------------------------------------

    def _maybe_kill(self) -> None:
        """Fire the chaos schedule: kill i (0-based) lands at
        ``kill_step + i * gap_steps``, each drawing a fresh seeded victim
        from the targeted tier's then-alive set. ``result.chaos`` keeps the
        first kill's fields (the scorer's dip anchor) plus the full
        ``events`` list for multi-kill schedules."""
        if self.chaos is None:
            return
        c = self.chaos
        offset = self._step - c.kill_step
        if offset < 0 or offset % c.gap_steps != 0:
            return
        if offset // c.gap_steps >= c.kills:
            return
        if c.tier == "prefill":
            pool = list(getattr(self.target, "prefill_replicas", ()))
        else:
            pool = list(self.target.replicas)
        alive = [h for h in pool if h.alive]
        event = {"step": self._step, "tier": c.tier, "alive_before": len(alive)}
        if not alive:
            event["exhausted"] = True  # schedule outlived the tier
        else:
            if c.replica is not None and offset == 0:
                victims = [h for h in alive if h.replica_id == c.replica]
            else:
                victims = [alive[int(self._chaos_rng.randint(len(alive)))]]
            if not victims:
                return
            victims[0].kill("chaos")
            event["replica"] = victims[0].replica_id
            self.tel.chaos_kill(victims[0].replica_id, c.tier, self._step)
        if self.result.chaos is None:
            self.result.chaos = {
                **event,
                # a prefill-tier kill leaves decode capacity INTACT (the
                # router degrades to local prefill / surviving members), so
                # the scorer's capacity-adjusted recovery target must not
                # assume (N-1)/N decode capacity
                "alive_frac": 1.0 if c.tier == "prefill" else None,
                "events": [],
            }
        self.result.chaos["events"].append(event)

    # ---- commit attribution ----------------------------------------------

    def _committed_of(self, rid: str) -> int:
        """This request's total committed tokens RIGHT NOW, read from the
        audited host-snapshot surface (router: folded failover tokens + the
        current incarnation's committed ``generated``)."""
        if not self._is_router:
            sreq = self.target.requests.get(rid)
            if sreq is None:
                return self._seen.get(rid, 0)
            return len(sreq.generated)
        rreq = self.target.requests.get(rid)
        if rreq is None:
            return self._seen.get(rid, 0)
        total = len(rreq.tokens)
        if not rreq.finished:
            sid = rreq.session_id()
            for h in self.target.replicas:
                if h.owned.get(sid) is rreq:
                    sreq = h.session.requests.get(sid)
                    if sreq is not None:
                        total += len(sreq.generated)
                    break
        return total

    def _record_step(self) -> None:
        commits: Dict[str, int] = {}
        for rid in self._tracked:
            cur = self._committed_of(rid)
            prev = self._seen.get(rid, 0)
            if cur > prev:
                commits[rid] = cur - prev
                self._seen[rid] = cur
        self.result.step_commits.append(commits)
        self.result.live_steps.append(self._has_live_work())
        self.tel.workload_backlog(self._backlog_depth())
        self.tel.workload_step(self._step, commits, self.step_dt_s)
        mon = getattr(self.tel, "slo_monitor", None)
        if mon is not None:
            # verdicts landed during this step fold into ITS window bucket
            mon.tick(self._step)

    def _has_live_work(self) -> bool:
        if self._is_router:
            return bool(self.target.has_live_work)
        sess = self.target
        return bool(sess.active or sess._readmit)

    # ---- stepping --------------------------------------------------------

    def step(self) -> Dict[str, int]:
        """One open-loop tick: admit every due arrival (FIFO, aged), fire
        the chaos plan if this is its step, advance the target one step,
        attribute committed tokens, then advance the virtual clock. Returns
        the target's {req_id: token} step results."""
        self._admit_due()
        self._maybe_kill()
        results = self.target.step()
        self._record_step()
        self._step += 1
        self.result.steps = self._step
        self.clock.advance(self.step_dt_s)
        return results

    def run(self) -> WorkloadResult:
        """Drive to completion: until every arrival was admitted or
        terminally refused AND the target drained. Fails loudly past
        ``max_total_steps`` (an open-loop run that cannot drain is a bug,
        not a hang)."""
        while self._pending or self._has_live_work():
            if self._step >= self.max_total_steps:
                raise RuntimeError(
                    f"workload did not drain within {self.max_total_steps} "
                    f"steps ({len(self._pending)} arrivals pending)"
                )
            self.step()
        mon = getattr(self.tel, "slo_monitor", None)
        if mon is not None:
            # judge stragglers that never reached a session terminal
            # (validation rejects, router-only failures) — the scorer's
            # failed / never_served taxonomy for the same cases
            mon.finalize(self._step)
        self._collect()
        return self.result

    def _collect(self) -> None:
        if self._is_router:
            for rid, rreq in self.target.requests.items():
                self.result.outputs[rid] = list(rreq.tokens)
                self.result.statuses[rid] = rreq.status
        else:
            for rid, sreq in self.target.requests.items():
                self.result.outputs[rid] = list(sreq.generated)
                self.result.statuses[rid] = sreq.status
        for rid, reason in self.result.never_served.items():
            self.result.statuses.setdefault(rid, f"never_served:{reason}")
