"""Causal span trees over the telemetry event stream (counterpart of the
reference's ``telemetry/spans.py``, copied: pure Python).

A :class:`SpanStore` holds the request- and replica-level timeline of one
run as *spans* (named intervals with a parent pointer), *instants* (point
events: kills, quarantines, health transitions) and *flow events* (the
"this failover incarnation continues that one" arrows). It is host-side
bookkeeping on the session clock; the recording sites live in
:mod:`.tracing` and never add a device fetch.

Determinism contract: span ids are CONTENT-derived (request ids,
incarnation indices, replica step counters), never allocation-order
handles, and all timestamps come from the caller's clock, so a drain
records the same span tree under sequential and ``router_threading``
stepping. Only the internal append order may differ across modes;
:func:`to_chrome_trace` sorts, so the exported JSON is comparable too.

Thread safety: one SpanStore is shared by every replica worker of a
threaded router, so every mutation happens under ``self._lock``. The
store is bounded: past ``max_spans`` the oldest COMPLETED spans evict
(open spans never do) and the drop is counted.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = [
    "Span",
    "Instant",
    "SpanStore",
    "to_chrome_trace",
]


@dataclass
class Span:
    """One named interval on a track. ``t_end is None`` == still open."""

    span_id: str
    name: str
    track: str
    t_start: float
    t_end: Optional[float] = None
    parent_id: Optional[str] = None
    #: sub-track within the track (one tid per lane in the Chrome export);
    #: request spans use their base request id so each request gets a row
    lane: str = "0"
    attrs: Dict[str, object] = field(default_factory=dict)


@dataclass
class Instant:
    """A point event (Chrome ``ph:"i"``): kills, quarantines, transitions."""

    name: str
    track: str
    ts: float
    lane: str = "0"
    attrs: Dict[str, object] = field(default_factory=dict)


@dataclass
class FlowPoint:
    """One endpoint of a flow arrow (Chrome ``ph:"s"``/``"f"`` pair).
    ``phase`` is ``"s"`` (source) or ``"f"`` (destination); arrows render
    only when both phases of a ``flow_id`` exist."""

    flow_id: str
    phase: str
    track: str
    ts: float
    lane: str = "0"


class SpanStore:
    """Bounded, lock-protected store for one session's span timeline."""

    def __init__(self, max_spans: int = 10000):
        self._lock = threading.RLock()
        self._open: Dict[str, Span] = {}
        self._done: deque = deque()
        self._instants: deque = deque()
        self._flows: List[FlowPoint] = []
        self.max_spans = int(max_spans)
        self.dropped = 0  # completed spans / instants evicted past the cap

    # ---- recording (all mutation under the store lock) -------------------

    def begin(
        self,
        span_id: str,
        name: str,
        track: str,
        t: float,
        parent_id: Optional[str] = None,
        lane: str = "0",
        **attrs,
    ) -> None:
        """Open a span. Idempotent on ``span_id`` — a duplicate begin (a
        re-admission re-entering a phase) keeps the FIRST interval."""
        with self._lock:
            if span_id in self._open:
                return
            self._open[span_id] = Span(
                span_id=span_id, name=name, track=track, t_start=float(t),
                parent_id=parent_id, lane=lane, attrs=dict(attrs),
            )

    def end(self, span_id: str, t: float, **attrs) -> None:
        """Close an open span (unknown/already-closed ids are ignored — a
        terminal record may race a failover close; first close wins)."""
        with self._lock:
            sp = self._open.pop(span_id, None)
            if sp is None:
                return
            sp.t_end = max(float(t), sp.t_start)
            if attrs:
                sp.attrs.update(attrs)
            if len(self._done) >= self.max_spans:
                self._done.popleft()
                self.dropped += 1
            self._done.append(sp)

    def is_open(self, span_id: str) -> bool:
        with self._lock:
            return span_id in self._open

    def set_attrs(self, span_id: str, **attrs) -> None:
        with self._lock:
            sp = self._open.get(span_id)
            if sp is not None:
                sp.attrs.update(attrs)

    def instant(self, name: str, track: str, ts: float, lane: str = "0",
                **attrs) -> None:
        with self._lock:
            if len(self._instants) >= self.max_spans:
                self._instants.popleft()
                self.dropped += 1
            self._instants.append(Instant(
                name=name, track=track, ts=float(ts), lane=lane,
                attrs=dict(attrs),
            ))

    def flow(self, flow_id: str, phase: str, track: str, ts: float,
             lane: str = "0") -> None:
        with self._lock:
            self._flows.append(FlowPoint(
                flow_id=flow_id, phase=phase, track=track, ts=float(ts),
                lane=lane,
            ))

    # ---- reading ---------------------------------------------------------

    def snapshot(self) -> Tuple[List[Span], List[Instant], List[FlowPoint]]:
        """Copy the whole store under the lock — completed spans first,
        then the still-open ones (shallow-copied so a racing ``end()``
        cannot mutate what the caller serializes)."""
        with self._lock:
            spans = [Span(**vars(s)) for s in self._done]
            spans += [Span(**vars(s)) for s in self._open.values()]
            instants = [Instant(**vars(i)) for i in self._instants]
            flows = list(self._flows)
        return spans, instants, flows

    def span_tree(self) -> Dict[str, tuple]:
        """The determinism pin's comparable form:
        ``{span_id: (name, parent_id, track, lane, t_start, t_end)}`` —
        order-free, so sequential and threaded drains compare equal."""
        spans, _, _ = self.snapshot()
        return {
            s.span_id: (s.name, s.parent_id, s.track, s.lane,
                        s.t_start, s.t_end)
            for s in spans
        }


def to_chrome_trace(
    spans: List[Span],
    instants: List[Instant],
    flows: List[FlowPoint],
    *,
    now: float,
    dropped: int = 0,
) -> dict:
    """Build a Chrome trace-event JSON object (Perfetto-loadable) from a
    span-store snapshot. One ``pid`` (process track) per span track —
    ``tenant:*`` tracks beside ``replica:*`` / ``prefill:*`` / ``driver``
    — and one ``tid`` per lane within a track (each request gets its own
    row inside its tenant track). Timestamps are normalized to the
    earliest observation and scaled seconds→µs; open spans close at
    ``now``. Flow arrows emit only when both endpoints of a flow id exist
    (the schema check pins every emitted flow id pairs)."""
    tracks = sorted(
        {s.track for s in spans}
        | {i.track for i in instants}
        | {f.track for f in flows}
    )
    pid_of = {tr: i + 1 for i, tr in enumerate(tracks)}
    lanes: Dict[str, set] = {tr: set() for tr in tracks}
    for s in spans:
        lanes[s.track].add(s.lane)
    for i in instants:
        lanes[i.track].add(i.lane)
    for f in flows:
        lanes[f.track].add(f.lane)
    tid_of = {
        (tr, lane): j + 1
        for tr in tracks
        for j, lane in enumerate(sorted(lanes[tr]))
    }
    all_ts = (
        [s.t_start for s in spans]
        + [i.ts for i in instants]
        + [f.ts for f in flows]
    )
    t0 = min(all_ts) if all_ts else 0.0

    def us(t: float) -> float:
        return round((t - t0) * 1e6, 3)

    events: List[dict] = []
    for tr in tracks:
        events.append({
            "ph": "M", "name": "process_name", "pid": pid_of[tr], "tid": 0,
            "ts": 0, "args": {"name": tr},
        })
    for s in spans:
        end = s.t_end if s.t_end is not None else max(now, s.t_start)
        ev = {
            "ph": "X", "name": s.name, "cat": "nxdi",
            "pid": pid_of[s.track], "tid": tid_of[(s.track, s.lane)],
            "ts": us(s.t_start), "dur": round((end - s.t_start) * 1e6, 3),
            "args": {"span_id": s.span_id, **s.attrs},
        }
        if s.parent_id:
            ev["args"]["parent"] = s.parent_id
        if s.t_end is None:
            ev["args"]["open"] = True
        events.append(ev)
    for i in instants:
        events.append({
            "ph": "i", "name": i.name, "cat": "nxdi", "s": "t",
            "pid": pid_of[i.track], "tid": tid_of[(i.track, i.lane)],
            "ts": us(i.ts), "args": dict(i.attrs),
        })
    by_flow: Dict[str, Dict[str, FlowPoint]] = {}
    for f in flows:
        by_flow.setdefault(f.flow_id, {})[f.phase] = f
    for fid in sorted(by_flow):
        pair = by_flow[fid]
        if "s" not in pair or "f" not in pair:
            continue  # an unpaired endpoint (run cut mid-failover) is mute
        for phase in ("s", "f"):
            f = pair[phase]
            events.append({
                "ph": phase, "name": "failover", "cat": "nxdi", "id": fid,
                "pid": pid_of[f.track], "tid": tid_of[(f.track, f.lane)],
                "ts": us(f.ts),
            })
            if phase == "f":
                events[-1]["bp"] = "e"
    # a deterministic serialization independent of record interleaving
    events.sort(key=lambda e: (
        e["ts"], e["ph"], e["pid"], e["tid"], e["name"],
        str(e.get("id", "")), str(e.get("args", "")),
    ))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"dropped_spans": dropped},
    }


def dump_chrome_trace(trace: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(trace, f)
