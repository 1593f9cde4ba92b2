"""Windowed SLO attainment + multi-window burn rate, live (counterpart of
the reference's ``telemetry/slo_monitor.py``).

The offline scorer (:mod:`..workload.slo`) judges a run AFTER it ends; an
autoscaler (ROADMAP "elastic fleet") needs the same verdicts as a rolling
gauge WHILE the drain runs. :class:`SloMonitor` computes them from the
exact host-side observations the scorer consumes — first-token /
token-batch / terminal records forwarded by :class:`~.tracing
.TelemetrySession` — so over a completed run the monitor's per-request
verdicts match the scorer's ``miss_kind`` exactly.

The one shared predicate is :func:`judge` — the scorer routes its
per-request miss taxonomy through it too, so the two can never drift.

Burn rate follows the classic multi-window pairing (SRE workbook): for
each window ``w`` (driver steps; default fast=5 / slow=60),

    attainment(w) = met / judged   over requests judged in the last w steps
    burn_rate(w)  = (1 - attainment(w)) / (1 - slo_target)

``burn > 1`` means the error budget burns faster than the target allows;
alerting on fast AND slow both > threshold gives speed without flap. Both
are exposed as ``nxdi_slo_attainment{window,tenant}`` /
``nxdi_slo_burn_rate{window,tenant}`` gauges (tenant ``_all`` aggregates).

Threading: note_* hooks run on replica worker threads (the
session records terminals inside ``step()``), ``tick`` runs on the driver
thread — every mutation takes ``self._lock``. Pure host bookkeeping: no
device fetch.
"""

from __future__ import annotations

import re
import threading
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

__all__ = ["judge", "SloMonitor"]

#: session-side request ids carry a ``~fN`` suffix per failover incarnation
#: (runtime/router.py); the monitor merges incarnations onto the base id
#: exactly like the scorer. Local re-implementation of
#: ``workload.generator.base_req_id`` so telemetry never imports workload
#: (the dependency runs the other way); equality is pinned by test.
_INCARNATION_RE = re.compile(r"~f\d+$")

#: session terminal reasons that mean "finished" to the SLO judge — the
#: same two the router folds into RSTATUS_FINISHED on a clean terminal
FINISHED_REASONS = ("eos", "length")


def _base_req_id(rid: str) -> str:
    return _INCARNATION_RE.sub("", rid)


def judge(
    *,
    finished: bool,
    served: bool,
    ttft_s: Optional[float],
    avg_itl_s: Optional[float],
    ttft_slo_s: Optional[float],
    itl_slo_s: Optional[float],
) -> Optional[str]:
    """THE per-request SLO verdict (None == met): the single predicate the
    offline scorer and the live monitor share. ``served`` == the request
    produced at least one token and was not terminally refused before
    service. A ``None`` SLO term always passes (generous-SLO runs pin
    attainment 1.0); a finished request with a TTFT SLO but no observed
    first token misses as ``ttft`` (the scorer's historical semantics)."""
    if not finished:
        return "failed" if served else "never_served"
    if ttft_slo_s is not None and (ttft_s is None or ttft_s > ttft_slo_s):
        return "ttft"
    if itl_slo_s is not None and avg_itl_s is not None and avg_itl_s > itl_slo_s:
        return "itl"
    return None


@dataclass
class _ReqState:
    tenant: str
    arrival_s: float
    ttft_slo_s: Optional[float] = None
    itl_slo_s: Optional[float] = None
    t_first: Optional[float] = None
    t_last: Optional[float] = None
    tokens: int = 0
    judged: bool = False
    verdict: Optional[str] = None
    finish_reason: Optional[str] = None


@dataclass
class _Judgment:
    step: int
    req_id: str
    tenant: str
    verdict: Optional[str]  # None == met


class SloMonitor:
    """Rolling TTFT/ITL attainment + burn rate over registered arrivals.

    Lifecycle: construct, :meth:`register_trace` the workload trace (the
    arrival times and per-tenant SLOs), attach via
    ``TelemetrySession.attach_slo_monitor`` (binds the gauges and routes
    the record hooks), then the driver calls :meth:`tick` once per step
    and :meth:`finalize` at drain end."""

    def __init__(
        self,
        windows: Tuple[int, ...] = (5, 60),
        slo_target: float = 0.99,
    ):
        if not windows or any(w < 1 for w in windows):
            raise ValueError("windows must be >= 1 step each")
        if not (0.0 < slo_target < 1.0):
            raise ValueError("slo_target in (0, 1)")
        self.windows = tuple(int(w) for w in sorted(windows))
        self.slo_target = float(slo_target)
        self._lock = threading.RLock()
        self._reqs: Dict[str, _ReqState] = {}
        #: verdicts landed since the last tick (judged between driver steps
        #: fold into the NEXT tick's bucket — the step the driver observes)
        self._pending: List[Tuple[str, str, Optional[str]]] = []
        #: full judgment log, step-stamped (the /slo surface + the pin
        #: test's independent recomputation input)
        self.judgments: List[_Judgment] = []
        self._window_log: deque = deque()  # (step, tenant, met) triples
        self._step = 0
        self._attain_gauge = None
        self._burn_gauge = None

    # ---- wiring ----------------------------------------------------------

    def bind(self, registry) -> None:
        """Mint the exposition gauges on ``registry`` (idempotent)."""
        with self._lock:
            self._attain_gauge = registry.gauge(
                "nxdi_slo_attainment",
                "rolling SLO attainment over the trailing window (driver "
                "steps); tenant _all aggregates",
                labels=("window", "tenant"))
            self._burn_gauge = registry.gauge(
                "nxdi_slo_burn_rate",
                "(1 - attainment) / (1 - slo_target) over the trailing "
                "window — >1 means the error budget burns faster than the "
                "SLO allows (fast+slow window pairing)",
                labels=("window", "tenant"))

    def register_trace(self, trace, step_dt_s: float = 1.0) -> None:
        """Register every arrival of a workload trace: its ARRIVAL time
        (step × dt — the scorer's TTFT origin) and its tenant SLOs."""
        with self._lock:
            for a in trace.arrivals:
                self._reqs[a.req_id] = _ReqState(
                    tenant=a.tenant,
                    arrival_s=a.step * float(step_dt_s),
                    ttft_slo_s=a.ttft_slo_s,
                    itl_slo_s=a.itl_slo_s,
                )

    # ---- record hooks (called by TelemetrySession, worker threads) -------

    def note_submitted(self, rid: str) -> None:
        """A (re)submission supersedes a premature NON-finished verdict:
        the session-level terminal it judged on (admission refusal's
        ``dropped:no_slot``, a failover harvest) was not terminal at the
        workload level — the driver/router re-submitted the request, so
        its story continues. A ``finished`` verdict (eos/length) stays:
        re-use of a finished id would be a new request, not a retry."""
        with self._lock:
            base = _base_req_id(rid)
            st = self._reqs.get(base)
            if (st is None or not st.judged
                    or st.finish_reason in FINISHED_REASONS):
                return
            st.judged = False
            st.verdict = None
            st.finish_reason = None
            self._pending = [p for p in self._pending if p[0] != base]

    def note_first_token(self, rid: str, t: float) -> None:
        """First token of one session-side incarnation observed at ``t``.
        A later incarnation's 'first' is just another token observation —
        the earliest one stays the TTFT origin (scorer: min over firsts)."""
        with self._lock:
            st = self._reqs.get(_base_req_id(rid))
            if st is None or st.judged:
                return
            if st.t_first is None:
                st.t_first = t
            st.t_last = t if st.t_last is None else max(st.t_last, t)
            st.tokens += 1

    def note_tokens(self, rid: str, n: int, t: float) -> None:
        with self._lock:
            st = self._reqs.get(_base_req_id(rid))
            if st is None or st.judged or n <= 0:
                return
            st.t_last = t if st.t_last is None else max(st.t_last, t)
            st.tokens += n

    def note_finish(self, rid: str, reason: str, t: float) -> None:
        """Terminal session record — judge NOW (the scorer judges the same
        request against the same observations after the run)."""
        with self._lock:
            st = self._reqs.get(_base_req_id(rid))
            if st is None or st.judged:
                return
            st.finish_reason = reason
            self._judge(_base_req_id(rid), st,
                        finished=reason in FINISHED_REASONS)

    # ---- judging + windows ----------------------------------------------

    def _judge(self, rid: str, st: _ReqState, *, finished: bool) -> None:
        # callers already hold self._lock; the RLock re-entry keeps the
        # write discipline visible at the write sites themselves
        with self._lock:
            ttft = None if st.t_first is None else st.t_first - st.arrival_s
            avg_itl = None
            if (st.tokens > 1 and st.t_first is not None
                    and st.t_last is not None):
                avg_itl = (st.t_last - st.t_first) / (st.tokens - 1)
            st.verdict = judge(
                finished=finished,
                served=st.t_first is not None,
                ttft_s=ttft,
                avg_itl_s=avg_itl,
                ttft_slo_s=st.ttft_slo_s,
                itl_slo_s=st.itl_slo_s,
            )
            st.judged = True
            self._pending.append((rid, st.tenant, st.verdict))

    def tick(self, step: int) -> None:
        """Fold verdicts since the last tick into the window log (stamped
        with this driver step) and refresh every gauge. Driver-thread."""
        with self._lock:
            self._step = int(step)
            for rid, tenant, verdict in self._pending:
                self.judgments.append(_Judgment(
                    step=self._step, req_id=rid, tenant=tenant,
                    verdict=verdict,
                ))
                self._window_log.append(
                    (self._step, tenant, verdict is None)
                )
            self._pending.clear()
            horizon = self._step - max(self.windows)
            while self._window_log and self._window_log[0][0] <= horizon:
                self._window_log.popleft()
            self._refresh_gauges()

    def finalize(self, step: Optional[int] = None) -> None:
        """Judge every registered request that never reached a session
        terminal (validation/front-door rejects never touch a session;
        router-level terminals — failover budget, total outage — have no
        session finish either) and run a last tick. ``failed`` iff it was
        served tokens, else ``never_served`` — the scorer's taxonomy for
        the same cases."""
        with self._lock:
            for rid, st in self._reqs.items():
                if not st.judged:
                    self._judge(rid, st, finished=False)
        self.tick(self._step if step is None else step)

    def _refresh_gauges(self) -> None:
        if self._attain_gauge is None:
            return
        tenants = sorted({t for _, t, _ in self._window_log})
        for w in self.windows:
            recent = [
                (tenant, met) for s, tenant, met in self._window_log
                if s > self._step - w
            ]
            for scope in ["_all"] + tenants:
                rows = (
                    recent if scope == "_all"
                    else [r for r in recent if r[0] == scope]
                )
                attain = (
                    sum(1 for _, met in rows if met) / len(rows)
                    if rows else 1.0
                )
                burn = (1.0 - attain) / (1.0 - self.slo_target)
                lab = (str(w), scope)
                self._attain_gauge.child(lab).set(attain)
                self._burn_gauge.child(lab).set(burn)

    # ---- reading ---------------------------------------------------------

    @property
    def verdicts(self) -> Dict[str, Optional[str]]:
        """{base req id: miss kind or None} for every judged request —
        compare against the scorer's per-request ``miss_kind``."""
        with self._lock:
            return {
                rid: st.verdict
                for rid, st in self._reqs.items() if st.judged
            }

    def attainment(self, window: int, tenant: str = "_all") -> float:
        with self._lock:
            rows = [
                (t, met) for s, t, met in self._window_log
                if s > self._step - window
                and (tenant == "_all" or t == tenant)
            ]
            if not rows:
                return 1.0
            return sum(1 for _, met in rows if met) / len(rows)

    def snapshot(self) -> dict:
        """The ``/slo`` JSON: target, windows, per-window attainment/burn
        (overall + per tenant), and the judged-miss census."""
        with self._lock:
            tenants = sorted({st.tenant for st in self._reqs.values()})
            misses: Dict[str, int] = {}
            judged = met = 0
            for st in self._reqs.values():
                if not st.judged:
                    continue
                judged += 1
                if st.verdict is None:
                    met += 1
                else:
                    misses[st.verdict] = misses.get(st.verdict, 0) + 1
            out = {
                "slo_target": self.slo_target,
                "step": self._step,
                "judged": judged,
                "met": met,
                "misses_by_kind": misses,
                "windows": {},
            }
        for w in self.windows:
            out["windows"][str(w)] = {
                "attainment": {
                    "_all": self.attainment(w),
                    **{t: self.attainment(w, t) for t in tenants},
                },
                "burn_rate": {
                    "_all": (1.0 - self.attainment(w))
                    / (1.0 - self.slo_target),
                },
            }
        return out
