"""Per-request serving telemetry on the host clock (counterpart of the
reference's ``telemetry/tracing.py``; the subset the split serving session
calls).

A :class:`TelemetrySession` records each request's lifecycle as a
:class:`RequestTrace` (submit, admit, first dispatch, first token, every
later token, finish), from which TTFT and ITL come
(:meth:`TelemetrySession.ttft_values_s`, :meth:`~TelemetrySession.itl_values_s`,
:meth:`~TelemetrySession.percentile`), and keeps plain counters: requests
submitted, admitted, dropped, rejected, preempted, quarantined and finished
(by reason), dispatch retries, deadline overruns, watchdog preemptions and
trips, model steps by kind and the bucket census, for the ragged mixed
step its composition (:meth:`TelemetrySession.mixed_step`) and the host /
fetch-wait split of each step (:meth:`~TelemetrySession.step_timing`), and
for speculation the reference's three histograms (``nxdi_spec_accept_len``,
``nxdi_spec_draft_len``, ``nxdi_spec_accept_ewma``) as plain lists of
their observations, with each request's ``spec_round`` events on its
trace. Every hook the session
calls exists here with the reference's name and semantics, so the
observation counts match the reference session's on the same traffic.

``span`` opens a ``torch.profiler.record_function`` range, so serving spans
show on a profiler trace. The reference's event log, chrome trace, metrics
registry, SLO monitor and ops server wait for ROADMAP A8.

A disabled session (``enabled=False``, what :func:`default_session`
returns) records nothing: every hook returns at once.
"""

from __future__ import annotations

import time
from collections import Counter, deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class RequestTrace:
    """One request's lifecycle on the host clock."""

    req_id: str
    t_submit: float
    t_admit: Optional[float] = None
    t_first_dispatch: Optional[float] = None
    t_first_token: Optional[float] = None
    t_last_token: Optional[float] = None
    t_finish: Optional[float] = None
    tokens: int = 0
    prefill_chunks: int = 0
    cached_prefix_tokens: int = 0
    finish_reason: Optional[str] = None
    itl_s: List[float] = field(default_factory=list)
    # the request's timeline events of the speculative session:
    # ("spec_round", t, draft_len, accept_ewma), one per verify round
    events: List[tuple] = field(default_factory=list)

    @property
    def ttft_s(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.t_first_dispatch is None:
            return None
        return self.t_first_dispatch - self.t_submit


class TelemetrySession:
    """Traces and counters for one serving session."""

    def __init__(self, enabled: bool = True, clock=time.perf_counter, max_completed: int = 10000):
        self.enabled = bool(enabled)
        self.clock = clock
        self.traces: Dict[str, RequestTrace] = {}
        # bounded: a long-lived session must not grow trace memory per request
        self.completed = deque(maxlen=max_completed)
        self.counters: Counter = Counter()
        self.dropped: Counter = Counter()  # by reason
        self.rejected: Counter = Counter()  # by reason
        self.finished: Counter = Counter()  # by reason
        self.steps: Counter = Counter()  # model dispatches by kind
        self.buckets: Counter = Counter()  # (model tag, bucket) census
        self.gauges: Dict[str, float] = {}
        # ragged mixed step: one entry per dispatch under each label
        # (prefill_rows, decode_rows, padded_slots, query_tokens)
        self.mixed_steps: Dict[str, List[int]] = {}
        # per ragged step: host ms (wall minus the blocking fetch) and the
        # fetch wait ms
        self.step_host_ms: List[float] = []
        self.step_fetch_wait_ms: List[float] = []
        # speculation, one entry per observation of the reference's
        # histogram of the same name: tokens committed per verify round
        # (nxdi_spec_accept_len; sums to the committed decode tokens), the
        # draft length of each round (nxdi_spec_draft_len) and the request's
        # acceptance EWMA after it (nxdi_spec_accept_ewma)
        self.spec_accept_len: List[int] = []
        self.spec_draft_len: List[int] = []
        self.spec_accept_ewma: List[float] = []

    # ---- spans -----------------------------------------------------------

    @contextmanager
    def span(self, name: str, **fields):
        """A named range on the profiler timeline around a host dispatch
        (dispatches return before the device finishes; no sync is forced)."""
        if not self.enabled:
            yield
            return
        import torch

        with torch.profiler.record_function(name):
            yield

    # ---- request lifecycle -------------------------------------------------

    def request_submitted(self, req_id: str) -> None:
        if not self.enabled:
            return
        self.counters["submitted"] += 1
        self.traces[req_id] = RequestTrace(req_id=req_id, t_submit=self.clock())

    def request_admitted(self, req_id: str, cached_prefix_tokens: int = 0) -> None:
        if not self.enabled:
            return
        tr = self.traces.get(req_id)
        if tr is not None and tr.t_admit is not None:
            # re-admission after a pool-exhaustion eviction keeps the first
            # admission's accounting
            self.counters["readmitted"] += 1
            return
        self.counters["admitted"] += 1
        if tr is not None:
            tr.t_admit = self.clock()
            tr.cached_prefix_tokens = cached_prefix_tokens

    def _close(self, req_id: str, reason: str) -> None:
        tr = self.traces.pop(req_id, None)
        if tr is not None:
            tr.finish_reason = reason
            tr.t_finish = self.clock()
            self.completed.append(tr)

    def request_dropped(self, req_id: str, reason: str) -> None:
        if not self.enabled:
            return
        self.dropped[reason] += 1
        self._close(req_id, "dropped")

    def request_rejected(self, req_id: str, reason: str) -> None:
        """Admission validation refused this request (terminal REJECTED)."""
        if not self.enabled:
            return
        self.rejected[reason] += 1
        self._close(req_id, "rejected")

    def request_preempted(self, req_id: str) -> None:
        """Pool-exhaustion eviction: not terminal, the trace stays open."""
        if not self.enabled:
            return
        self.counters["preempted"] += 1

    def row_quarantined(self, req_id: str) -> None:
        """A consumed row carried the non-finite sentinel; its terminal
        accounting rides request_finished("non_finite")."""
        if not self.enabled:
            return
        self.counters["quarantined"] += 1

    def dispatch_retry(self, label: str) -> None:
        if not self.enabled:
            return
        self.counters["dispatch_retries"] += 1

    def deadline_exceeded(self, req_id: str, overrun_s: float) -> None:
        if not self.enabled:
            return
        self.counters["deadline_exceeded"] += 1

    def watchdog_preempted(self, req_id: str) -> None:
        if not self.enabled:
            return
        self.counters["watchdog_preemptions"] += 1

    def watchdog_tripped(self, no_progress_steps: int) -> None:
        if not self.enabled:
            return
        self.counters["watchdog_trips"] += 1

    def prefill_dispatch(self, req_id: str, n_tokens: int) -> None:
        """One prefill pass advanced this request by ``n_tokens`` prompt
        tokens (a whole-prompt prefill counts as one chunk)."""
        if not self.enabled:
            return
        self.counters["tokens_prefilled"] += n_tokens
        tr = self.traces.get(req_id)
        if tr is not None:
            tr.prefill_chunks += 1
            if tr.t_first_dispatch is None:
                tr.t_first_dispatch = self.clock()

    def request_first_token(self, req_id: str) -> None:
        if not self.enabled:
            return
        tr = self.traces.get(req_id)
        if tr is not None and tr.t_first_token is not None:
            # the resumed prefill of a re-admitted request: a regular token
            # observation, so "TTFT count == finished requests" holds under
            # preemption
            self.request_tokens(req_id, 1)
            return
        now = self.clock()
        self.counters["tokens_generated"] += 1
        if tr is not None:
            if tr.t_first_dispatch is None:
                tr.t_first_dispatch = now
            tr.t_first_token = tr.t_last_token = now
            tr.tokens += 1

    def request_tokens(self, req_id: str, n: int) -> None:
        """``n`` decode tokens observed in one fetch; ITL is the time since
        the previous observation, amortized over n."""
        if not self.enabled or n <= 0:
            return
        now = self.clock()
        self.counters["tokens_generated"] += n
        tr = self.traces.get(req_id)
        if tr is not None and tr.t_last_token is not None:
            per_tok = (now - tr.t_last_token) / n
            tr.itl_s.extend([per_tok] * n)
            tr.t_last_token = now
            tr.tokens += n

    def request_finished(self, req_id: str, reason: str = "length") -> None:
        if not self.enabled:
            return
        self.finished[reason] += 1
        self._close(req_id, reason)

    # ---- step level --------------------------------------------------------

    def step(self, kind: str) -> None:
        if not self.enabled:
            return
        self.steps[kind] += 1

    def bucket_dispatch(self, model: str, bucket: int) -> None:
        if not self.enabled:
            return
        self.buckets[(model, int(bucket))] += 1

    def pool_gauges(self, occupancy: int, kv_pool_bytes: int, kv_free_bytes: int) -> None:
        if not self.enabled:
            return
        self.gauges.update(occupancy=occupancy, kv_pool_bytes=kv_pool_bytes, kv_free_bytes=kv_free_bytes)

    def step_timing(self, host_ms: float, fetch_wait_ms: float) -> None:
        """Host-vs-device split of ONE serving step on the host clock:
        ``host_ms`` is the step's wall time minus the blocking token fetch,
        ``fetch_wait_ms`` that wait."""
        if not self.enabled:
            return
        self.step_host_ms.append(host_ms)
        self.step_fetch_wait_ms.append(fetch_wait_ms)

    def mixed_step(
        self,
        prefill_rows: int,
        decode_rows: int,
        padded_slots: int,
        query_tokens: int,
        spec_rows: int = 0,
    ) -> None:
        """Composition of ONE ragged mixed dispatch: rows serving prefill
        chunks, decode and spec-verify segments (serving_spec_ragged),
        padded packed slots and real query tokens in the dispatched
        total-token bucket. Each label's entry count equals the number of
        mixed dispatches; padded_slots / (padded_slots + query_tokens) is
        the padded share."""
        if not self.enabled:
            return
        for label, v in (
            ("prefill_rows", prefill_rows), ("decode_rows", decode_rows), ("padded_slots", padded_slots),
            ("query_tokens", query_tokens), ("spec_rows", spec_rows),
        ):
            self.mixed_steps.setdefault(label, []).append(int(v))

    def spec_accept(self, committed: int) -> None:
        """One speculation round committed ``committed`` tokens for one
        request (after EOS/budget truncation: the observations sum to the
        decode tokens speculation delivered)."""
        if not self.enabled or committed <= 0:
            return
        self.spec_accept_len.append(int(committed))

    def spec_round(self, draft_len: int, accept_ewma: float, req_id: Optional[str] = None) -> None:
        """The adaptive-draft signals of one verify round: the length it
        drafted and the request's acceptance EWMA after it; with ``req_id``
        also a ``spec_round`` event on the request's trace."""
        if not self.enabled:
            return
        self.spec_draft_len.append(int(draft_len))
        self.spec_accept_ewma.append(float(accept_ewma))
        tr = self.traces.get(req_id) if req_id is not None else None
        if tr is not None:
            tr.events.append(("spec_round", self.clock(), int(draft_len), round(float(accept_ewma), 6)))

    # ---- summaries ---------------------------------------------------------

    def percentile(self, values: List[float], q: float) -> Optional[float]:
        """Nearest-rank percentile, ``q`` in [0, 1] (the reference's rule)."""
        if not values:
            return None
        s = sorted(values)
        k = min(len(s) - 1, int(round(q * (len(s) - 1))))
        return s[k]

    def ttft_values_s(self) -> List[float]:
        return [t.ttft_s for t in self.completed if t.ttft_s is not None]

    def itl_values_s(self) -> List[float]:
        out: List[float] = []
        for t in self.completed:
            out.extend(t.itl_s)
        return out


_DEFAULT = TelemetrySession(enabled=False)


def default_session() -> TelemetrySession:
    """The inert session a ServingSession records into when it is given
    none."""
    return _DEFAULT
