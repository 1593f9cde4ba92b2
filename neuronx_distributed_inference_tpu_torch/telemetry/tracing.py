"""Request-lifecycle tracing, step-timeline spans and the JSONL event log
(counterpart of the reference's ``telemetry/tracing.py``).

One :class:`TelemetrySession` observes one serving session, or a router
and all its replicas. Everything here is HOST-side bookkeeping:

- **Request lifecycle**: submitted -> admitted -> (prefill chunks) -> first
  token (TTFT) -> per-token decode (ITL) -> finished / preempted / dropped.
  Each request keeps an exact :class:`RequestTrace` (for percentiles) and
  feeds the fixed-bucket histograms of :mod:`.metrics` under the
  reference's family names and labels (``nxdi_*``).
- **Step timeline**: :meth:`TelemetrySession.span` wraps each dispatch in a
  ``torch.profiler.record_function`` range (visible on a profiler trace
  beside the kernels it launched) and logs a structured span event; the
  request, replica and hand-off hooks build a causal span tree
  (:mod:`.spans`) that :meth:`~TelemetrySession.export_chrome_trace`
  writes as Chrome trace-event JSON.
- **Event log**: every lifecycle and step event appends one JSON object;
  with ``jsonl_path`` they stream to disk (:func:`load_events` reads them
  back).

Timing contract: timestamps are taken on the host clock when the HOST
observes a value that an already-issued fetch returned; nothing here
synchronizes with the device. Under 1-ahead decode a token's timestamp is
its observation time (one step late), and a multi-step decode chunk
observes N tokens in one fetch, so ITL is amortized over the chunk.

The retrace-guard bridge: an enabled session registers a listener with
``analysis.retrace_guard``, so every new program (a graph capture, or the
first run of a key on the CPU) counts in ``nxdi_jit_traces_total{tag}`` and
a forbidden post-seal one in ``nxdi_sealed_retrace_total{tag}``.

The accessors earlier slices read stay as views: ``counters``,
``dropped``, ``rejected``, ``finished``, ``steps`` and ``buckets`` read the
registry; ``mixed_steps``, ``step_host_ms`` / ``step_fetch_wait_ms`` and
the three ``spec_*`` lists keep each observation of their histogram
(bounded like the event ring). The workload and SLO hooks
(``attach_slo_monitor``, ``set_tenants``, ``chaos_kill``,
``workload_step``, ``slo_missed``, ``workload_backlog``,
``workload_refused``) serve ``workload/`` and
:class:`~.slo_monitor.SloMonitor`, as the reference's do.

A disabled session (``enabled=False``, what :func:`default_session`
returns until :func:`enable_default_session`) records nothing: every hook
returns at once.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
import warnings
from collections import Counter, deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from neuronx_distributed_inference_tpu_torch.analysis import retrace_guard
from neuronx_distributed_inference_tpu_torch.telemetry import metrics as metrics_mod
from neuronx_distributed_inference_tpu_torch.telemetry import spans as spans_mod

#: env override for the in-memory event ring AND the span store bound:
#: long drains must not grow either without limit
TELEMETRY_EVENT_MAX_ENV = "TELEMETRY_EVENT_MAX"

#: session-side failover-incarnation suffix (runtime/router.py
#: RouterRequest.session_id): ``{base}~f{N}``
_INCARNATION_RE = re.compile(r"^(?P<base>.+)~f(?P<inc>\d+)$")


def _default_event_max() -> int:
    try:
        return max(1, int(os.environ.get(TELEMETRY_EVENT_MAX_ENV, "10000")))
    except ValueError:
        return 10000


def _split_incarnation(req_id: str):
    """``base~fN`` -> (base, N); bare ids are incarnation 0."""
    m = _INCARNATION_RE.match(req_id)
    if m:
        return m.group("base"), int(m.group("inc"))
    return req_id, 0

FINISH_REASONS = (
    "eos", "length", "preempted", "dropped",
    # fault-containment terminals (runtime/serving.py, runtime/faults.py):
    # rejected by admission validation, wall-clock TTL expiry, non-finite
    # quarantine, and dispatch-retry exhaustion
    "rejected", "deadline_exceeded", "non_finite", "dispatch_error",
)


@dataclass
class RequestTrace:
    """Exact per-request lifecycle record (histograms are for fleets;
    traces are for percentiles and tests)."""

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
    """Metrics + traces + events for one serving session / process.

    ``enabled=False`` builds an inert session: every record method returns
    immediately, no instruments are created, no retrace listener installs —
    the disabled path is a handful of attribute loads per call.

    Thread safety: one TelemetrySession is shared by
    every replica of a thread-per-replica router
    (``Config.router_threading``), so record methods that mutate session
    state (the trace table, the completed/event deques, the cumulative
    timing sums, the JSONL stream) take ``self._lock`` — an RLock, because
    locked methods log through :meth:`event` which locks again on the same
    thread. Instrument mutations (``inc``/``set``/``observe``) are atomic
    inside :mod:`.metrics` (per-instrument locks, acquired strictly INSIDE
    this one: the router -> replica -> telemetry-session -> instrument lock
    order). Methods that only touch instruments take no
    session lock.
    """

    def __init__(
        self,
        registry: Optional[metrics_mod.MetricsRegistry] = None,
        enabled: bool = True,
        jsonl_path: Optional[str] = None,
        clock=time.perf_counter,
        max_events: Optional[int] = None,
        max_completed: int = 10000,
    ):
        self.enabled = bool(enabled)
        self.registry = registry if registry is not None else metrics_mod.MetricsRegistry()
        self.clock = clock
        self._lock = threading.RLock()
        self.traces: Dict[str, RequestTrace] = {}
        if max_events is None:
            max_events = _default_event_max()  # TELEMETRY_EVENT_MAX
        # exact traces are for percentiles and tests; the fleet metrics live
        # in the (bounded) histograms — cap retention so a long-lived
        # serving process cannot grow trace memory linearly with requests
        self.completed = deque(maxlen=max_completed)
        self.events = deque(maxlen=max_events)
        self._jsonl_path = jsonl_path
        self._jsonl_file = None
        self._listener = None
        #: the causal span timeline; None on a disabled session
        self.spans: Optional[spans_mod.SpanStore] = None
        #: optional live SLO monitor (attach_slo_monitor)
        self.slo_monitor = None
        # span bookkeeping, all guarded by self._lock: failovers observed
        # per base request id (incarnation / flow-id numbering), last-seen
        # health per replica / tier member (transition instants), per-track
        # step-span counters, and an optional base-id -> tenant map
        self._failover_count: Dict[str, int] = {}
        self._replica_health_seen: Dict[int, int] = {}
        self._tier_health_seen: Dict[int, int] = {}
        self._replica_step_count: Dict[int, int] = {}
        self._phase_count: Dict[str, int] = {}
        self._tenant_of: Dict[str, str] = {}
        self._dropped_events = 0
        # exact observations behind the views earlier slices read (one entry
        # per observation of the histogram of the same role; bounded like
        # the event ring): ragged mixed-step composition per label, each
        # step's host / fetch-wait ms, and the three nxdi_spec_* histograms
        self.mixed_steps: Dict[str, deque] = {}
        self.step_host_ms = deque(maxlen=max_events)
        self.step_fetch_wait_ms = deque(maxlen=max_events)
        self.spec_accept_len = deque(maxlen=max_events)
        self.spec_draft_len = deque(maxlen=max_events)
        self.spec_accept_ewma = deque(maxlen=max_events)
        self._readmitted = 0
        if not self.enabled:
            return
        self.spans = spans_mod.SpanStore(max_spans=max_events)
        r = self.registry
        self._tel_dropped = r.counter(
            "nxdi_telemetry_dropped_total",
            "oldest telemetry records evicted past the in-memory bound "
            "(TELEMETRY_EVENT_MAX); the JSONL stream, when enabled, keeps "
            "everything", labels=("kind",))
        self._submitted = r.counter(
            "nxdi_requests_submitted_total", "requests offered to the session")
        self._admitted = r.counter(
            "nxdi_requests_admitted_total", "requests that got a KV line")
        self._dropped = r.counter(
            "nxdi_requests_dropped_total",
            "requests refused at admission (capacity)", labels=("reason",))
        self._rejected = r.counter(
            "nxdi_requests_rejected_total",
            "requests refused by admission validation (terminal REJECTED)",
            labels=("reason",))
        self._preempted = r.counter(
            "nxdi_requests_preempted_total",
            "pool-exhaustion evictions (requests re-queue for re-admission)")
        self._quarantined = r.counter(
            "nxdi_rows_quarantined_total",
            "rows failed and evicted on a non-finite logits/tokens "
            "observation (FAILED(non_finite); KV scrubbed on release)")
        self._retries = r.counter(
            "nxdi_dispatch_retries_total",
            "transient dispatch errors retried with capped backoff")
        self._deadline_overrun = r.histogram(
            "nxdi_deadline_overrun_ms",
            "how far past its wall-clock deadline a request was when dropped",
            buckets=metrics_mod.LATENCY_MS_BUCKETS)
        self._watchdog_preempt = r.counter(
            "nxdi_watchdog_preemptions_total",
            "largest-request preemptions forced by the no-progress watchdog")
        self._watchdog_trips = r.counter(
            "nxdi_watchdog_trips_total",
            "no-progress windows that tripped the watchdog (a second "
            "consecutive trip raises WatchdogError)")
        self._finished = r.counter(
            "nxdi_requests_finished_total", "requests completed",
            labels=("reason",))
        self._ttft = r.histogram(
            "nxdi_ttft_ms", "submit -> first token (host-observed)",
            buckets=metrics_mod.LATENCY_MS_BUCKETS)
        self._itl = r.histogram(
            "nxdi_itl_ms",
            "inter-token latency (amortized over multi-token fetches)",
            buckets=metrics_mod.LATENCY_MS_BUCKETS)
        self._queue_wait = r.histogram(
            "nxdi_queue_wait_ms", "submit -> first model dispatch",
            buckets=metrics_mod.LATENCY_MS_BUCKETS)
        self._chunks_per_req = r.histogram(
            "nxdi_prefill_chunks_per_request",
            "prefill passes a request consumed before its first token",
            buckets=metrics_mod.CHUNK_COUNT_BUCKETS)
        self._tokens = r.counter(
            "nxdi_tokens_generated_total", "tokens committed to requests")
        self._prefill_tokens = r.counter(
            "nxdi_tokens_prefilled_total", "prompt tokens written to KV")
        self._steps = r.counter(
            "nxdi_steps_total", "model dispatches", labels=("kind",))
        self._bucket = r.counter(
            "nxdi_bucket_dispatch_total",
            "compiled-program census: which (model, bucket) served",
            labels=("model", "bucket"))
        self._occupancy = r.gauge(
            "nxdi_batch_occupancy", "live rows in the last decode dispatch")
        self._kv_pool = r.gauge(
            "nxdi_kv_pool_bytes", "total paged-pool HBM (cache dtype)")
        self._kv_free = r.gauge(
            "nxdi_kv_free_bytes", "free + evictable paged-pool HBM")
        self._accept = r.histogram(
            "nxdi_spec_accept_len",
            "tokens committed per speculation round (sums to committed "
            "decode tokens)", buckets=metrics_mod.ACCEPT_LEN_BUCKETS)
        self._spec_draft_len = r.histogram(
            "nxdi_spec_draft_len",
            "adaptive draft length chosen per spec-ragged round (snapped to "
            "the session's fixed choice ladder; shrinks when acceptance "
            "drops)", buckets=metrics_mod.DRAFT_LEN_BUCKETS)
        self._spec_ewma = r.histogram(
            "nxdi_spec_accept_ewma",
            "per-request draft-acceptance-rate EWMA observed after each "
            "spec-ragged round (the adaptive-draft policy's steering "
            "signal)", buckets=metrics_mod.SPEC_EWMA_BUCKETS)
        self._step_host_ms = r.histogram(
            "nxdi_step_host_ms",
            "host-side bookkeeping per serving step (scheduling, descriptor "
            "build, commits, telemetry — everything except the blocking part "
            "of the token fetch)",
            buckets=metrics_mod.LATENCY_MS_BUCKETS)
        self._step_fetch_wait_ms = r.histogram(
            "nxdi_step_fetch_wait_ms",
            "blocking wait on the step's consumed token fetch (under "
            "pipelined dispatch this is only what the host/device overlap "
            "did not cover)",
            buckets=metrics_mod.LATENCY_MS_BUCKETS)
        self._host_frac = r.gauge(
            "nxdi_serving_host_frac",
            "cumulative host-time fraction of serving step wall time "
            "(host_ms / (host_ms + fetch_wait_ms)); ~1.0 means the host, "
            "not the chip, is the serving bottleneck")
        self._host_ms_sum = 0.0
        self._fetch_wait_ms_sum = 0.0
        self._mixed = r.histogram(
            "nxdi_mixed_step_rows",
            "ragged mixed-step dispatch composition: prefill_rows / "
            "decode_rows / padded_slots / query_tokens per dispatch (each "
            "label's observation count == mixed dispatches)",
            labels=("kind",), buckets=metrics_mod.MIXED_STEP_BUCKETS)
        # --- multi-replica router family (runtime/router.py) --------------
        # all host-side router bookkeeping: placement decisions, failovers,
        # per-replica load gauges, and the per-step occupancy-spread
        # histogram the balance contract is judged by
        self._router_placements = r.counter(
            "nxdi_router_placements_total",
            "router placement decisions by policy and reason (fresh / "
            "failover / spill = first-choice replica refused capacity)",
            labels=("policy", "reason"))
        self._router_failovers = r.counter(
            "nxdi_router_failovers_total",
            "requests re-queued off a failed replica (they resume from "
            "committed host state on a surviving replica)",
            labels=("cause",))
        self._router_rejected = r.counter(
            "nxdi_router_rejected_total",
            "requests refused by router front-door validation "
            "(terminal REJECTED, never placed on a replica)",
            labels=("reason",))
        self._router_queue = r.gauge(
            "nxdi_router_queue_depth",
            "requests waiting in the router's global placement queue")
        self._router_occ = r.gauge(
            "nxdi_router_replica_occupancy",
            "live rows on this replica", labels=("replica",))
        self._router_qd = r.gauge(
            "nxdi_router_replica_queue_depth",
            "active + re-admission-waiting requests on this replica",
            labels=("replica",))
        self._router_health = r.gauge(
            "nxdi_router_replica_health",
            "replica health state (2 = healthy, 1 = degraded, 0 = dead)",
            labels=("replica",))
        self._router_elastic = r.counter(
            "nxdi_router_elastic_total",
            "elastic fleet events: replicas added to / retired from the "
            "pool mid-run (retire = placement stopped, drain begun; "
            "retire_done = drained, worker joined, mesh freed)",
            labels=("event",))
        self._router_spread = r.histogram(
            "nxdi_router_occupancy_spread",
            "max - min live rows across alive replicas per router step "
            "(0 == perfectly balanced; the rebalance signal)",
            buckets=metrics_mod.ROUTER_SPREAD_BUCKETS)
        # --- disaggregated prefill tier (router_prefill_replicas) ----------
        # the KV hand-off as a failure domain: attempt/retry/failure census
        # (failures by typed reason — handoff_corrupt / handoff_truncated /
        # handoff_exhausted / ...), per-hand-off wall time, tier member
        # health, and the LOUD local-prefill fallback counter (every
        # placement served by a decode replica's own prefill because the
        # whole tier is dead)
        self._handoff_attempts = r.counter(
            "nxdi_handoff_attempts_total",
            "KV hand-off attempts (prefill + extract + inject; retries of "
            "one hand-off count individually)")
        self._handoff_retries = r.counter(
            "nxdi_handoff_retries_total",
            "hand-off attempts that failed in transit and were retried "
            "with capped backoff (bounded by handoff_max_retries)")
        self._handoff_failures = r.counter(
            "nxdi_handoff_failures_total",
            "hand-offs that terminally failed their ONE in-flight request "
            "(typed FAILED(handoff)), by reason",
            labels=("reason",))
        self._handoff_ms = r.histogram(
            "nxdi_handoff_ms",
            "wall time of one completed hand-off (prefill dispatch through "
            "inject, retries included)",
            buckets=metrics_mod.LATENCY_MS_BUCKETS)
        self._handoff_local = r.counter(
            "nxdi_handoff_local_prefill_total",
            "placements served by the decode replica's LOCAL monolithic "
            "prefill because no prefill-tier member was alive (tier-wide "
            "graceful degradation — loud by design)")
        self._handoff_tier_health = r.gauge(
            "nxdi_handoff_tier_health",
            "prefill-tier member health (2 = healthy, 1 = degraded, "
            "0 = dead)", labels=("replica",))
        self._handoff_tier_alive = r.gauge(
            "nxdi_handoff_tier_alive",
            "alive (healthy + degraded) prefill-tier members; 0 means "
            "every placement falls back to local monolithic prefill")
        # --- thread-per-replica stepping (Config.router_threading) --------
        # per-replica step wall time + the router's replica-stepping-phase
        # span: overlap_frac = 1 - phase_wall / sum(replica walls) is the
        # measured concurrency win (0 == host-serialized sequential
        # stepping; (N-1)/N == N replicas perfectly overlapped)
        self._replica_step_ms = r.histogram(
            "nxdi_replica_step_ms",
            "one replica's session.step() wall time (host clock; recorded "
            "by the router thread after the per-step barrier)",
            labels=("replica",), buckets=metrics_mod.LATENCY_MS_BUCKETS)
        self._router_step_ms = r.histogram(
            "nxdi_router_step_ms",
            "wall time of the router step's replica-stepping phase (all "
            "replicas dispatched, barrier waited)",
            buckets=metrics_mod.LATENCY_MS_BUCKETS)
        self._router_overlap = r.gauge(
            "nxdi_router_step_overlap_frac",
            "cumulative 1 - stepping-phase wall / sum of per-replica step "
            "walls: ~0 = sequential, (N-1)/N = N replicas fully overlapped")
        self._router_step_wall_ms_sum = 0.0
        self._replica_step_ms_sum = 0.0
        # --- workload engine (workload/driver.py + workload/slo.py) -------
        # open-loop traffic bookkeeping: the driver's arrival backlog and
        # admission refusals, and the post-hoc SLO scorer's miss census —
        # all host-side (recorded on the driver/router thread or offline
        # after the run)
        self._slo_missed = r.counter(
            "nxdi_slo_missed_total",
            "requests that missed their SLO, by miss kind (ttft / itl / "
            "failed / never_served) and tenant — recorded by the workload "
            "SLO scorer; goodput counts only tokens from requests NOT in "
            "this census",
            labels=("kind", "tenant"))
        self._wl_backlog = r.gauge(
            "nxdi_workload_backlog_depth",
            "arrivals waiting in the open-loop driver's retry backlog "
            "(arrived, offered, refused for capacity — their SLO clocks "
            "keep running)")
        self._wl_refused = r.counter(
            "nxdi_workload_refusals_total",
            "open-loop admission attempts refused for capacity (the "
            "arrival re-queues and retries; a terminal give-up records "
            "nxdi_requests_rejected_total{reason=backlog} instead)",
            labels=("reason",))
        self._jit_traces = r.counter(
            "nxdi_jit_traces_total", "jit traces observed (compiles)",
            labels=("tag",))
        self._sealed_retrace = r.counter(
            "nxdi_sealed_retrace_total",
            "forbidden post-seal retraces (steady-state recompiles)",
            labels=("tag",))
        if jsonl_path:
            self._jsonl_file = open(jsonl_path, "a")
        self._listener = self._on_trace
        retrace_guard.add_trace_listener(self._listener)

    # ---- lifecycle of the session itself ---------------------------------

    def close(self) -> None:
        with self._lock:
            if self._listener is not None:
                retrace_guard.remove_trace_listener(self._listener)
                self._listener = None
            if self._jsonl_file is not None:
                self._jsonl_file.close()
                self._jsonl_file = None

    def __enter__(self) -> "TelemetrySession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- event log -------------------------------------------------------

    def event(self, etype: str, **fields) -> None:
        if not self.enabled:
            return
        rec = {"ts": self.clock(), "type": etype, **fields}
        with self._lock:
            if (
                self.events.maxlen is not None
                and len(self.events) >= self.events.maxlen
            ):
                # the deque would evict silently — count the drop so a
                # bounded ring on a long drain is an observable condition
                self._dropped_events += 1
                self._tel_dropped.child(("events",)).inc()
            self.events.append(rec)
            if self._jsonl_file is not None:
                # under the lock so concurrent replica threads cannot
                # interleave half-written JSONL lines
                self._jsonl_file.write(json.dumps(rec) + "\n")
                self._jsonl_file.flush()

    # ---- span timeline + SLO monitor plumbing ----------------------------

    def set_tenants(self, tenant_of: Dict[str, str]) -> None:
        """Map base request ids to tenant names (WorkloadTrace.tenants_of)
        so request spans land on the right ``tenant:*`` track. Without it
        the tenant is parsed from the workload id convention
        ``{tenant}-{NNNN}`` (non-workload ids land on tenant 'default')."""
        if not self.enabled:
            return
        with self._lock:
            self._tenant_of.update(tenant_of)

    def attach_slo_monitor(self, monitor) -> "TelemetrySession":
        """Route first-token / token / terminal records into a live
        :class:`~.slo_monitor.SloMonitor` and bind its gauges to this
        session's registry."""
        if not self.enabled:
            return self
        monitor.bind(self.registry)
        with self._lock:
            self.slo_monitor = monitor
        return self

    def _tenant_track(self, base: str) -> str:
        tenant = self._tenant_of.get(base)
        if tenant is None:
            tenant = base.rsplit("-", 1)[0] if "-" in base else "default"
        return f"tenant:{tenant}"

    def _req_ids(self, req_id: str):
        """(base, incarnation, track, root span id, incarnation span id)."""
        base, inc = _split_incarnation(req_id)
        track = self._tenant_track(base)
        root = f"req:{base}"
        return base, inc, track, root, f"{root}/i{inc}"

    def _close_request_spans(self, req_id: str, now: float, reason: str) -> None:
        """Close every open span of one incarnation (phase children first),
        then the incarnation, then the request root — the terminal record's
        span-side mirror. Called with self._lock held."""
        if self.spans is None:
            return
        base, _inc, _track, root, inode = self._req_ids(req_id)
        for phase in ("queue", "prefill", "handoff", "decode"):
            self.spans.end(f"{inode}/{phase}", now)
        self.spans.end(inode, now, reason=reason)
        self.spans.end(root, now, reason=reason)

    def export_chrome_trace(self, path: Optional[str] = None) -> dict:
        """The whole run as Chrome trace-event JSON (Perfetto-loadable):
        one process track per tenant / replica / prefill-tier member /
        driver, spans as complete events, kills and health transitions as
        instants, failover continuations as flow arrows. Safe against an
        ACTIVE drain: the span state is snapshotted under the session
        RLock before any serialization (the
        family-copy pattern of the metrics exposition), so a racing
        replica thread cannot half-mutate what gets written."""
        if not self.enabled or self.spans is None:
            trace = {
                "traceEvents": [], "displayTimeUnit": "ms",
                "otherData": {"dropped_spans": 0},
            }
        else:
            with self._lock:
                now = self.clock()
                spans, instants, flows = self.spans.snapshot()
                dropped = self.spans.dropped
            trace = spans_mod.to_chrome_trace(
                spans, instants, flows, now=now, dropped=dropped
            )
        if path:
            spans_mod.dump_chrome_trace(trace, path)
        return trace

    def span_tree(self) -> Dict[str, tuple]:
        """Order-free comparable span tree (the determinism pin)."""
        if self.spans is None:
            return {}
        return self.spans.span_tree()

    @contextmanager
    def span(self, name: str, **fields):
        """Named step-timeline scope: a ``torch.profiler.record_function``
        range on the profiler timeline plus a structured span event. Bounds
        the HOST-side dispatch (dispatches return before the device
        finishes; no sync is forced)."""
        if not self.enabled:
            yield
            return
        import torch

        t0 = self.clock()
        with torch.profiler.record_function(name):
            yield
        self.event("span", name=name, dur_ms=(self.clock() - t0) * 1e3, **fields)

    # ---- request lifecycle -----------------------------------------------

    def request_submitted(self, req_id: str) -> None:
        if not self.enabled:
            return
        self._submitted.inc()
        with self._lock:
            now = self.clock()
            self.traces[req_id] = RequestTrace(
                req_id=req_id, t_submit=now
            )
            base, inc, track, root, inode = self._req_ids(req_id)
            self.spans.begin(root, f"request {base}", track, now, lane=base)
            self.spans.begin(
                inode, f"incarnation {inc}", track, now,
                parent_id=root, lane=base, incarnation=inc,
            )
            self.spans.begin(
                f"{inode}/queue", "queue", track, now,
                parent_id=inode, lane=base,
            )
            if inc > 0:
                # destination endpoint of the failover arrow the matching
                # router_failover opened (flow ids number by failover index)
                self.spans.flow(
                    f"flow:{base}:{inc - 1}", "f", track, now, lane=base
                )
            mon = self.slo_monitor
        if mon is not None:
            # a retry supersedes any premature non-finished verdict (the
            # driver re-submits after a `dropped:no_slot` admission refusal)
            mon.note_submitted(req_id)
        self.event("request_submitted", req_id=req_id)

    def request_admitted(self, req_id: str, cached_prefix_tokens: int = 0) -> None:
        if not self.enabled:
            return
        with self._lock:
            tr = self.traces.get(req_id)
            if tr is not None and tr.t_admit is not None:
                # RE-admission after a pool-exhaustion eviction: the request
                # already holds its admission accounting (t_admit, the
                # admitted counter) — re-counting would make admitted >
                # submitted and shift queue-wait/TTFT baselines. Only the
                # event log records the resumption.
                self._readmitted += 1
                base, _inc, track, _root, _inode = self._req_ids(req_id)
                self.spans.instant(
                    "readmitted", track, self.clock(), lane=base,
                    req_id=req_id,
                )
                self.event("request_readmitted", req_id=req_id,
                           cached_prefix_tokens=cached_prefix_tokens)
                return
            self._admitted.inc()
            if tr is not None:
                tr.t_admit = self.clock()
                tr.cached_prefix_tokens = cached_prefix_tokens
        self.event("request_admitted", req_id=req_id,
                   cached_prefix_tokens=cached_prefix_tokens)

    def request_dropped(self, req_id: str, reason: str) -> None:
        if not self.enabled:
            return
        self._dropped.child((reason,)).inc()
        with self._lock:
            now = self.clock()
            tr = self.traces.pop(req_id, None)
            if tr is not None:
                tr.finish_reason = "dropped"
                tr.t_finish = now
                self.completed.append(tr)
            self._close_request_spans(req_id, now, f"dropped:{reason}")
            mon = self.slo_monitor
        if mon is not None:
            mon.note_finish(req_id, "dropped", now)
        self.event("request_dropped", req_id=req_id, reason=reason)

    def request_rejected(self, req_id: str, reason: str) -> None:
        """Admission validation refused this request (terminal REJECTED):
        malformed input — out-of-vocab token ids, empty prompt, over-long
        prompt, invalid budget — never reaches a dispatch."""
        if not self.enabled:
            return
        self._rejected.child((reason,)).inc()
        with self._lock:
            now = self.clock()
            tr = self.traces.pop(req_id, None)
            if tr is not None:
                tr.finish_reason = "rejected"
                tr.t_finish = now
                self.completed.append(tr)
            self._close_request_spans(req_id, now, f"rejected:{reason}")
            mon = self.slo_monitor
        if mon is not None:
            mon.note_finish(req_id, f"rejected:{reason}", now)
        self.event("request_rejected", req_id=req_id, reason=reason)

    def request_preempted(self, req_id: str) -> None:
        """NON-terminal pool-exhaustion eviction: the request re-queues for
        re-admission (aging), so its trace stays open — only the preemption
        counter and the event log record the eviction."""
        if not self.enabled:
            return
        self._preempted.inc()
        with self._lock:
            base, _inc, track, _root, inode = self._req_ids(req_id)
            now = self.clock()
            self.spans.instant(
                "preempted", track, now, lane=base, req_id=req_id
            )
            # the eviction cuts the in-flight phase short — the preempted
            # gap reads as bare incarnation time between the instant and
            # the resumed activity
            for phase in ("prefill", "decode"):
                self.spans.end(f"{inode}/{phase}", now)
        self.event("request_preempted", req_id=req_id)

    def row_quarantined(self, req_id: str) -> None:
        """A consumed row carried the non-finite sentinel: the serving
        session fails the request and scrubs+releases its KV. The terminal
        accounting rides the matching request_finished("non_finite")."""
        if not self.enabled:
            return
        self._quarantined.inc()
        with self._lock:
            base, _inc, track, _root, _inode = self._req_ids(req_id)
            self.spans.instant(
                "quarantined", track, self.clock(), lane=base, req_id=req_id
            )
        self.event("row_quarantined", req_id=req_id)

    def dispatch_retry(self, label: str) -> None:
        if not self.enabled:
            return
        self._retries.inc()
        self.event("dispatch_retry", label=label)

    def deadline_exceeded(self, req_id: str, overrun_s: float) -> None:
        """Observed at drop time: how late past its TTL the request was when
        the session noticed (bounded by step latency — deadlines are checked
        at step boundaries). Terminal accounting rides
        request_finished("deadline_exceeded")."""
        if not self.enabled:
            return
        self._deadline_overrun.observe(max(0.0, overrun_s) * 1e3)
        self.event("deadline_exceeded", req_id=req_id, overrun_s=overrun_s)

    def watchdog_preempted(self, req_id: str) -> None:
        if not self.enabled:
            return
        self._watchdog_preempt.inc()
        self.event("watchdog_preempted", req_id=req_id)

    def watchdog_tripped(
        self, no_progress_steps: int, replica: Optional[int] = None
    ) -> None:
        if not self.enabled:
            return
        self._watchdog_trips.inc()
        if replica is not None:
            with self._lock:
                self.spans.instant(
                    "watchdog_tripped", f"replica:{int(replica)}",
                    self.clock(), no_progress_steps=no_progress_steps,
                )
        self.event("watchdog_tripped", no_progress_steps=no_progress_steps)

    def prefill_dispatch(self, req_id: str, n_tokens: int) -> None:
        """One prefill pass advanced this request by ``n_tokens`` prompt
        tokens (whole-prompt CTE counts as one chunk)."""
        if not self.enabled:
            return
        self._prefill_tokens.inc(n_tokens)
        with self._lock:
            tr = self.traces.get(req_id)
            if tr is not None:
                tr.prefill_chunks += 1
                if tr.t_first_dispatch is None:
                    tr.t_first_dispatch = self.clock()
                    self._queue_wait.observe(
                        (tr.t_first_dispatch - tr.t_submit) * 1e3
                    )
                    base, _inc, track, _root, inode = self._req_ids(req_id)
                    self.spans.end(f"{inode}/queue", tr.t_first_dispatch)
                    self.spans.begin(
                        f"{inode}/prefill", "prefill", track,
                        tr.t_first_dispatch, parent_id=inode, lane=base,
                    )

    def request_first_token(self, req_id: str) -> None:
        if not self.enabled:
            return
        with self._lock:
            tr = self.traces.get(req_id)
            if tr is not None and tr.t_first_token is not None:
                # the resumed prefill of a RE-admitted request emits a token
                # the same way a fresh admission does, but the request's
                # first token happened before its eviction: record a regular
                # token observation (its "ITL" spans the preempted gap — the
                # latency the user actually saw) and leave t_first_token/
                # TTFT alone, so "TTFT count == finished requests" holds
                # under preemption.
                self.request_tokens(req_id, 1)
                return
            now = self.clock()
            self._tokens.inc()
            if tr is not None:
                if tr.t_first_dispatch is None:
                    # non-chunked admission: prefill dispatch == first one
                    tr.t_first_dispatch = now
                    self._queue_wait.observe((now - tr.t_submit) * 1e3)
                tr.t_first_token = tr.t_last_token = now
                tr.tokens += 1
                self._ttft.observe((now - tr.t_submit) * 1e3)
                self._chunks_per_req.observe(max(1, tr.prefill_chunks))
            base, _inc, track, _root, inode = self._req_ids(req_id)
            if self.spans.is_open(f"{inode}/prefill"):
                self.spans.end(f"{inode}/prefill", now)
            else:
                self.spans.end(f"{inode}/queue", now)
            self.spans.begin(
                f"{inode}/decode", "decode", track, now,
                parent_id=inode, lane=base,
            )
            mon = self.slo_monitor
        if mon is not None:
            mon.note_first_token(req_id, now)
        self.event("first_token", req_id=req_id)

    def request_tokens(self, req_id: str, n: int) -> None:
        """``n`` decode tokens observed for this request in one fetch; ITL is
        the elapsed time since the previous observation amortized over n."""
        if not self.enabled or n <= 0:
            return
        now = self.clock()
        self._tokens.inc(n)
        mon = None
        with self._lock:
            tr = self.traces.get(req_id)
            if tr is not None and tr.t_last_token is not None:
                per_tok = (now - tr.t_last_token) / n
                for _ in range(n):
                    self._itl.observe(per_tok * 1e3)
                    tr.itl_s.append(per_tok)
                tr.t_last_token = now
                tr.tokens += n
                mon = self.slo_monitor
        if mon is not None:
            mon.note_tokens(req_id, n, now)

    def tokens_generated(self, n: int) -> None:
        """Bare token count for host loops with no request identity
        (application.generate, the fused-spec loop)."""
        if not self.enabled or n <= 0:
            return
        self._tokens.inc(n)

    def request_finished(self, req_id: str, reason: str = "length") -> None:
        # NOTE: preemption is counted at EVICTION time (request_preempted) —
        # it is no longer a terminal event (the session re-admits with
        # aging); reason="preempted" here means re-admission was impossible
        if not self.enabled:
            return
        self._finished.child((reason,)).inc()
        with self._lock:
            now = self.clock()
            tr = self.traces.pop(req_id, None)
            if tr is not None:
                tr.finish_reason = reason
                tr.t_finish = now
                self.completed.append(tr)
            self._close_request_spans(req_id, now, reason)
            mon = self.slo_monitor
        if mon is not None:
            mon.note_finish(req_id, reason, now)
        self.event("request_finished", req_id=req_id, reason=reason)

    # ---- step-level ------------------------------------------------------

    def step(self, kind: str) -> None:
        if not self.enabled:
            return
        self._steps.child((kind,)).inc()

    def bucket_dispatch(self, model: str, bucket: int) -> None:
        if not self.enabled:
            return
        self._bucket.child((model, str(int(bucket)))).inc()

    def pool_gauges(self, occupancy: int, kv_pool_bytes: int, kv_free_bytes: int) -> None:
        if not self.enabled:
            return
        self._occupancy.set(occupancy)
        self._kv_pool.set(kv_pool_bytes)
        self._kv_free.set(kv_free_bytes)

    def step_timing(
        self,
        host_ms: float,
        fetch_wait_ms: float,
        replica: Optional[int] = None,
    ) -> None:
        """Host-vs-device split of ONE serving step, both measured with the
        session clock on the host (no device syncs added — the fetch timed
        here is one the runtime already performs): ``host_ms`` is the step's
        wall time minus the blocking fetch wait. The
        ``nxdi_serving_host_frac`` gauge tracks the cumulative fraction —
        the host-gap number the async-pipelining work drives down
        (PERF.md). With ``replica`` set (router-managed sessions) the split
        also lands as host / fetch_wait phase spans on that replica's
        timeline track."""
        if not self.enabled:
            return
        self._step_host_ms.observe(host_ms)
        self._step_fetch_wait_ms.observe(fetch_wait_ms)
        with self._lock:
            self.step_host_ms.append(host_ms)
            self.step_fetch_wait_ms.append(fetch_wait_ms)
            # the cumulative sums are plain floats shared by every replica
            # step thread: += is a read-modify-write, locked like the
            # instrument internals
            self._host_ms_sum += max(0.0, host_ms)
            self._fetch_wait_ms_sum += max(0.0, fetch_wait_ms)
            denom = self._host_ms_sum + self._fetch_wait_ms_sum
            if denom > 0:
                self._host_frac.set(self._host_ms_sum / denom)
            if replica is not None:
                # one worker thread per replica steps its own session, so
                # the per-replica phase counter is deterministic across
                # sequential and threaded drains (the determinism pin)
                track = f"replica:{int(replica)}"
                pc = self._phase_count.get(track, 0) + 1
                self._phase_count[track] = pc
                now = self.clock()
                h_s = max(0.0, host_ms) / 1e3
                f_s = max(0.0, fetch_wait_ms) / 1e3
                self.spans.begin(
                    f"{track}/t{pc}/host", "host", track,
                    now - h_s - f_s, lane="phases",
                )
                self.spans.end(f"{track}/t{pc}/host", now - f_s)
                self.spans.begin(
                    f"{track}/t{pc}/fetch_wait", "fetch_wait", track,
                    now - f_s, lane="phases",
                )
                self.spans.end(f"{track}/t{pc}/fetch_wait", now)
        self.event(
            "step_timing", host_ms=host_ms, fetch_wait_ms=fetch_wait_ms
        )

    def mixed_step(
        self,
        prefill_rows: int,
        decode_rows: int,
        padded_slots: int,
        query_tokens: int,
        spec_rows: int = 0,
    ) -> None:
        """Composition of ONE ragged mixed dispatch (serving_ragged): rows
        serving prefill chunks, rows serving decode, rows serving packed
        SPEC-VERIFY segments (serving_spec_ragged), padded packed slots and
        real query tokens in the dispatched total-token bucket. Each label's
        observation COUNT equals the number of mixed dispatches (pinned by
        test); padded_slots/(padded_slots+query_tokens) is the padded-token
        fraction the split dispatch was paying per phase."""
        if not self.enabled:
            return
        for label, v in (
            ("prefill_rows", prefill_rows), ("decode_rows", decode_rows),
            ("padded_slots", padded_slots), ("query_tokens", query_tokens),
            ("spec_rows", spec_rows),
        ):
            self._mixed.child((label,)).observe(v)
            with self._lock:
                self.mixed_steps.setdefault(
                    label, deque(maxlen=self.events.maxlen)
                ).append(int(v))

    # ---- multi-replica router (runtime/router.py) ------------------------

    def router_placement(
        self,
        policy: str,
        reason: str,
        req_id: Optional[str] = None,
        replica: Optional[int] = None,
    ) -> None:
        """One placement decision: a request was bound to a replica under
        ``policy`` (``reason``: fresh / failover / spill). With identity
        attached, the decision lands as a placement instant on the request's
        timeline and stamps the replica onto its open incarnation span."""
        if not self.enabled:
            return
        self._router_placements.child((policy, reason)).inc()
        if req_id is not None:
            with self._lock:
                base, _inc, track, _root, inode = self._req_ids(req_id)
                attrs = {"policy": policy, "reason": reason}
                if replica is not None:
                    attrs["replica"] = int(replica)
                self.spans.instant(
                    "placement", track, self.clock(), lane=base, **attrs
                )
                self.spans.set_attrs(inode, **attrs)
        self.event("router_placement", policy=policy, reason=reason,
                   req_id=req_id, replica=replica)

    def router_failover(self, req_id: str, cause: str) -> None:
        """One request re-queued off a failed replica; it resumes from its
        committed host state on a surviving replica (byte-identical greedy).
        ``req_id`` is the BASE id: the failed incarnation's spans close here
        and a flow arrow opens toward the next incarnation's submit."""
        if not self.enabled:
            return
        self._router_failovers.child((cause,)).inc()
        with self._lock:
            now = self.clock()
            n = self._failover_count.get(req_id, 0)
            base, _inc, track, root, _inode = self._req_ids(req_id)
            inode = f"{root}/i{n}"
            for phase in ("queue", "prefill", "handoff", "decode"):
                self.spans.end(f"{inode}/{phase}", now)
            self.spans.end(inode, now, failover_cause=cause)
            self.spans.instant(
                "failover", track, now, lane=base, cause=cause,
                incarnation=n,
            )
            self.spans.flow(f"flow:{base}:{n}", "s", track, now, lane=base)
            self._failover_count[req_id] = n + 1
        self.event("router_failover", req_id=req_id, cause=cause)

    def router_rejected(self, req_id: str, reason: str) -> None:
        if not self.enabled:
            return
        self._router_rejected.child((reason,)).inc()
        self.event("router_rejected", req_id=req_id, reason=reason)

    def router_elastic(self, event: str, replica: int) -> None:
        """One elastic fleet event: ``add`` (warmed handle joined pool +
        placement), ``retire`` (placement stopped, drain begun) or
        ``retire_done`` (drained, worker joined, replica left the pool)."""
        if not self.enabled:
            return
        self._router_elastic.child((event,)).inc()
        self.event("router_elastic", event=event, replica=replica)

    def router_replica_gauges(
        self, replica_id: int, occupancy: int, queue_depth: int, health: int
    ) -> None:
        if not self.enabled:
            return
        lab = (str(int(replica_id)),)
        self._router_occ.child(lab).set(occupancy)
        self._router_qd.child(lab).set(queue_depth)
        self._router_health.child(lab).set(health)
        with self._lock:
            prev = self._replica_health_seen.get(int(replica_id))
            if prev is not None and prev != int(health):
                self.spans.instant(
                    "health_transition", f"replica:{int(replica_id)}",
                    self.clock(), **{"from": prev, "to": int(health)},
                )
            self._replica_health_seen[int(replica_id)] = int(health)

    def router_step_gauges(self, queue_depth: int, spread: int) -> None:
        """Once per router step: global placement-queue depth and the
        occupancy spread (max - min live rows) across alive replicas."""
        if not self.enabled:
            return
        self._router_queue.set(queue_depth)
        self._router_spread.observe(spread)

    # ---- disaggregated prefill tier (router_prefill_replicas) ------------

    def handoff_attempt(self) -> None:
        """One KV hand-off attempt started (retries count individually)."""
        if not self.enabled:
            return
        self._handoff_attempts.inc()

    def handoff_retry(self) -> None:
        """One hand-off attempt failed in transit and will retry."""
        if not self.enabled:
            return
        self._handoff_retries.inc()

    def handoff_failure(self, req_id: str, reason: str) -> None:
        """One hand-off terminally failed its in-flight request (typed
        FAILED(handoff)): corrupt/truncated payload, or retry exhaustion."""
        if not self.enabled:
            return
        self._handoff_failures.child((reason,)).inc()
        with self._lock:
            base, _inc, track, _root, _inode = self._req_ids(req_id)
            self.spans.instant(
                "handoff_failure", track, self.clock(), lane=base,
                reason=reason,
            )
        self.event("handoff_failure", req_id=req_id, reason=reason)

    def handoff_done(
        self,
        ms: float,
        req_id: Optional[str] = None,
        replica: Optional[int] = None,
    ) -> None:
        """One hand-off completed (prefill through inject), wall ms. With
        identity attached, the interval lands as a ``handoff`` span under
        the request's CURRENT incarnation (its TTFT tax, readable per
        request in the timeline)."""
        if not self.enabled:
            return
        self._handoff_ms.observe(ms)
        if req_id is not None:
            with self._lock:
                now = self.clock()
                base, _inc, track, root, _inode = self._req_ids(req_id)
                inc = self._failover_count.get(base, 0)
                sid = f"{root}/i{inc}/handoff"
                attrs = {} if replica is None else {"prefill_replica": int(replica)}
                self.spans.begin(
                    sid, "handoff", track, now - max(0.0, ms) / 1e3,
                    parent_id=f"{root}/i{inc}", lane=base, **attrs,
                )
                self.spans.end(sid, now)
        self.event("handoff_done", ms=ms, req_id=req_id, replica=replica)

    def handoff_local_prefill(self, req_id: str) -> None:
        """Tier-wide degradation: this placement ran the decode replica's
        LOCAL monolithic prefill because no prefill-tier member is alive."""
        if not self.enabled:
            return
        self._handoff_local.inc()
        with self._lock:
            base, _inc, track, _root, _inode = self._req_ids(req_id)
            self.spans.instant(
                "handoff_local_prefill", track, self.clock(), lane=base
            )
        self.event("handoff_local_prefill", req_id=req_id)

    def handoff_tier_gauges(self, replica_id: int, health: int) -> None:
        if not self.enabled:
            return
        self._handoff_tier_health.child((str(int(replica_id)),)).set(health)
        with self._lock:
            prev = self._tier_health_seen.get(int(replica_id))
            if prev is not None and prev != int(health):
                self.spans.instant(
                    "health_transition", f"prefill:{int(replica_id)}",
                    self.clock(), **{"from": prev, "to": int(health)},
                )
            self._tier_health_seen[int(replica_id)] = int(health)

    def handoff_tier_alive(self, alive: int) -> None:
        if not self.enabled:
            return
        self._handoff_tier_alive.set(alive)

    def replica_step(self, replica_id: int, step_ms: float) -> None:
        """One replica's session.step() wall time (recorded on the ROUTER
        thread after the per-step barrier, so threaded and sequential
        stepping record through the identical path — and the step-span
        counter below is router-thread-only, hence deterministic)."""
        if not self.enabled:
            return
        self._replica_step_ms.child((str(int(replica_id)),)).observe(step_ms)
        with self._lock:
            track = f"replica:{int(replica_id)}"
            k = self._replica_step_count.get(int(replica_id), 0) + 1
            self._replica_step_count[int(replica_id)] = k
            now = self.clock()
            sid = f"{track}/step{k}"
            self.spans.begin(
                sid, f"step {k}", track, now - max(0.0, step_ms) / 1e3,
                lane="steps", step_ms=step_ms,
            )
            self.spans.end(sid, now)

    def router_step_timing(self, phase_wall_ms: float, replica_ms_sum: float) -> None:
        """Wall time of one router step's replica-stepping phase beside the
        sum of its per-replica step walls. The cumulative overlap gauge is
        ``1 - wall / sum``: ~0 when replicas step host-serialized, up to
        (N-1)/N when thread-per-replica stepping overlaps them fully — the
        router rows' ``router_step_overlap_frac`` source."""
        if not self.enabled:
            return
        self._router_step_ms.observe(phase_wall_ms)
        with self._lock:
            self._router_step_wall_ms_sum += max(0.0, phase_wall_ms)
            self._replica_step_ms_sum += max(0.0, replica_ms_sum)
            if self._replica_step_ms_sum > 0:
                self._router_overlap.set(max(
                    0.0,
                    1.0 - self._router_step_wall_ms_sum
                    / self._replica_step_ms_sum,
                ))

    def spec_accept(self, committed: int) -> None:
        """One speculation round committed ``committed`` tokens for one
        request (post EOS/budget truncation — the histogram's sum is exactly
        the decode tokens speculation delivered)."""
        if not self.enabled or committed <= 0:
            return
        self._accept.observe(committed)
        with self._lock:
            self.spec_accept_len.append(int(committed))

    def spec_round(
        self,
        draft_len: int,
        accept_ewma: float,
        req_id: Optional[str] = None,
    ) -> None:
        """Adaptive-draft policy signals of one spec-ragged round: the
        request's NEXT snapped draft length and its acceptance-rate EWMA
        after the update. With ``req_id`` the round
        also lands as an instant on the request's timeline."""
        if not self.enabled:
            return
        self._spec_draft_len.observe(draft_len)
        self._spec_ewma.observe(accept_ewma)
        with self._lock:
            self.spec_draft_len.append(int(draft_len))
            self.spec_accept_ewma.append(float(accept_ewma))
            if req_id is not None:
                now = self.clock()
                base, _inc, track, _root, _inode = self._req_ids(req_id)
                self.spans.instant(
                    "spec_round", track, now, lane=base,
                    draft_len=int(draft_len),
                    accept_ewma=round(float(accept_ewma), 6),
                )
                tr = self.traces.get(req_id)
                if tr is not None:
                    tr.events.append((
                        "spec_round", now, int(draft_len),
                        round(float(accept_ewma), 6),
                    ))

    # ---- workload engine (workload/driver.py + workload/slo.py) ----------

    def chaos_kill(self, replica_id: int, tier: str, step: int) -> None:
        """The chaos plan killed a replica at driver step ``step``: the
        timeline's kill marker (the instant a recovery window anchors on)."""
        if not self.enabled:
            return
        track = (
            f"prefill:{int(replica_id)}" if tier == "prefill"
            else f"replica:{int(replica_id)}"
        )
        with self._lock:
            self.spans.instant(
                "chaos_kill", track, self.clock(), tier=tier, step=int(step)
            )
        self.event("chaos_kill", replica=int(replica_id), tier=tier,
                   step=int(step))

    def workload_step(self, step: int, commits: Dict[str, int],
                      dt_s: float) -> None:
        """One open-loop driver step: per-request decode commits observed
        this step. Lands as a ``driver`` track span carrying the commit
        total, the goodput series a trace viewer reads off the timeline."""
        if not self.enabled:
            return
        total = int(sum(commits.values()))
        with self._lock:
            now = self.clock()
            sid = f"driver/step{int(step)}"
            self.spans.begin(
                sid, f"step {int(step)}", "driver", now,
                lane="steps", commit_tokens=total,
            )
            # the virtual clock advances AFTER _record_step: stamp the
            # step's nominal width so the timeline shows contiguous steps
            self.spans.end(sid, now + max(0.0, float(dt_s)))
        self.event("workload_step", step=int(step), commit_tokens=total,
                   commits=dict(commits))

    def slo_missed(self, kind: str, tenant: str) -> None:
        """One request missed its SLO (scored post-hoc by workload/slo.py):
        ``kind`` is ttft / itl / failed / never_served."""
        if not self.enabled:
            return
        self._slo_missed.child((kind, tenant)).inc()
        self.event("slo_missed", kind=kind, tenant=tenant)

    def workload_backlog(self, depth: int) -> None:
        """Arrivals currently waiting in the open-loop driver's retry
        backlog (observed once per driver step)."""
        if not self.enabled:
            return
        self._wl_backlog.set(depth)

    def workload_refused(self, reason: str) -> None:
        """One open-loop admission attempt refused for capacity; the
        arrival stays in the backlog and retries (NON-terminal: terminal
        give-ups ride request_rejected(reason='backlog'))."""
        if not self.enabled:
            return
        self._wl_refused.child((reason,)).inc()
        self.event("workload_refused", reason=reason)

    # ---- retrace-guard bridge --------------------------------------------

    def _on_trace(self, tag: str, sealed: bool) -> None:
        self._jit_traces.child((tag,)).inc()
        if sealed:
            self._sealed_retrace.child((tag,)).inc()
            self.event("sealed_retrace", tag=tag)

    # ---- summaries -------------------------------------------------------

    def percentile(self, values: List[float], q: float) -> Optional[float]:
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


    # ---- views read by earlier slices ------------------------------------

    def _samples(self, name: str, snap: Optional[dict] = None) -> list:
        if not self.enabled:
            return []
        fam = (snap if snap is not None else self.registry.snapshot()).get(name)
        return fam["samples"] if fam else []

    def _by_label(self, name: str, label: str) -> Counter:
        return Counter({smp["labels"][label]: smp["value"] for smp in self._samples(name)})

    @property
    def counters(self) -> Counter:
        """The session's plain counts, read from the registry: submitted,
        admitted, readmitted, preempted, quarantined, dispatch_retries,
        deadline_exceeded, watchdog_preemptions, watchdog_trips,
        tokens_prefilled, tokens_generated."""
        if not self.enabled:
            return Counter()
        snap = self.registry.snapshot()
        out = Counter({
            key: sum(smp.get("value", smp.get("count", 0)) for smp in self._samples(name, snap))
            for key, name in (
                ("submitted", "nxdi_requests_submitted_total"),
                ("admitted", "nxdi_requests_admitted_total"),
                ("preempted", "nxdi_requests_preempted_total"),
                ("quarantined", "nxdi_rows_quarantined_total"),
                ("dispatch_retries", "nxdi_dispatch_retries_total"),
                ("deadline_exceeded", "nxdi_deadline_overrun_ms"),
                ("watchdog_preemptions", "nxdi_watchdog_preemptions_total"),
                ("watchdog_trips", "nxdi_watchdog_trips_total"),
                ("tokens_prefilled", "nxdi_tokens_prefilled_total"),
                ("tokens_generated", "nxdi_tokens_generated_total"),
            )
        })
        out["readmitted"] = self._readmitted
        return out

    @property
    def dropped(self) -> Counter:
        """Admission refusals by reason (``nxdi_requests_dropped_total``)."""
        return self._by_label("nxdi_requests_dropped_total", "reason")

    @property
    def rejected(self) -> Counter:
        """Validation rejects by reason (``nxdi_requests_rejected_total``)."""
        return self._by_label("nxdi_requests_rejected_total", "reason")

    @property
    def finished(self) -> Counter:
        """Terminal outcomes by reason (``nxdi_requests_finished_total``)."""
        return self._by_label("nxdi_requests_finished_total", "reason")

    @property
    def steps(self) -> Counter:
        """Model dispatches by kind (``nxdi_steps_total``)."""
        return self._by_label("nxdi_steps_total", "kind")

    @property
    def buckets(self) -> Counter:
        """The (model tag, bucket) census (``nxdi_bucket_dispatch_total``)."""
        return Counter({
            (smp["labels"]["model"], int(smp["labels"]["bucket"])): smp["value"]
            for smp in self._samples("nxdi_bucket_dispatch_total")
        })


def load_events(jsonl_path: str) -> List[dict]:
    """Read a session's JSONL event log back for offline replay.

    Tolerant of a truncated/corrupt tail: a process killed mid-write (the
    chaos drains this log exists for) leaves a half-written last line —
    skip bad lines with a warning instead of losing the whole log."""
    out = []
    with open(jsonl_path) as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                warnings.warn(
                    f"{jsonl_path}:{lineno}: skipping corrupt JSONL line "
                    f"({line[:40]!r}...)",
                    stacklevel=2,
                )
    return out


# ---- module default (sessions given none, fused speculation) ---------------

_default_session = TelemetrySession(
    registry=metrics_mod.default_registry(), enabled=False
)


def default_session() -> TelemetrySession:
    """The process-default session. Disabled (inert) until
    :func:`enable_default_session` — ServingSession and the fused-spec host
    loops record into it when no explicit session is passed."""
    return _default_session


def set_default_session(session: TelemetrySession) -> TelemetrySession:
    global _default_session
    _default_session = session
    return session


def enable_default_session(jsonl_path: Optional[str] = None) -> TelemetrySession:
    """Swap in an ENABLED default session over the process-default registry
    (idempotent: an already-enabled default is returned as-is)."""
    global _default_session
    if not _default_session.enabled:
        _default_session = TelemetrySession(
            registry=metrics_mod.default_registry(), jsonl_path=jsonl_path
        )
    return _default_session
