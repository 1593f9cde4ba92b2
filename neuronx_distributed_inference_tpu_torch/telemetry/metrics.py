"""Host-side serving metrics: counters, gauges, fixed-bucket histograms
(counterpart of the reference's ``telemetry/metrics.py``, copied: pure
Python, no import of the reference).

A process-local registry in the spirit of ``prometheus_client`` with zero
dependencies. **Recording never talks to the device**: every instrument is
a plain Python float/int update on the host, fed by values the runtime
already fetched, so enabling telemetry adds no host-device round trip.

Exposition:
- :meth:`MetricsRegistry.prometheus_text`: Prometheus text format 0.0.4.
- :meth:`MetricsRegistry.snapshot`: a JSON-able dict.

Histograms use FIXED bucket bounds chosen at registration (cumulative
``le`` semantics like Prometheus), so an observation is a bisect and two
adds. Exact ``sum``/``count`` are kept so tests can pin conservation laws
(the speculation acceptance histogram sums to the committed tokens).

Thread safety: with the thread-per-replica router
(``Config.router_threading``) every replica's step thread records into ONE
shared registry, so ``inc``/``set``/``observe`` take a per-instrument lock
(``+=`` on a Python float is a read-modify-write across bytecodes),
``_Family.child`` mints children under a per-family lock (two threads
asking for the same new label get the SAME child), and exposition copies
each family's child table under that lock before iterating. Call sites
never touch ``.value``/``.sum``/``.count`` or the buckets directly.
"""

from __future__ import annotations

import bisect
import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple

#: the Content-Type the Prometheus text exposition is served under
#: (the ops server's /metrics route, telemetry/ops_server.py)
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# default latency bounds (milliseconds): spans admission→TTFT on one chip to
# multi-second queue waits under overload
LATENCY_MS_BUCKETS = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0,
)
# speculation acceptance length (tokens per round, 1..k); k <= 16 in practice
ACCEPT_LEN_BUCKETS = (1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0)
# adaptive draft lengths (spec-ragged policy choices, snapped powers of two)
DRAFT_LEN_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0)
# per-request acceptance-rate EWMA (spec-ragged adaptive-draft signal, 0..1)
SPEC_EWMA_BUCKETS = (0.1, 0.25, 0.4, 0.5, 0.6, 0.75, 0.9, 1.0)
# prefill chunks consumed per request before the first token
CHUNK_COUNT_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)
# ragged mixed-step composition (rows / slots per dispatch): spans one
# decode row up to a fully-packed total-token bucket
MIXED_STEP_BUCKETS = (
    0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0, 1024.0,
)
# multi-replica router occupancy spread (max - min live rows across alive
# replicas, observed once per router step): 0 == perfectly balanced
ROUTER_SPREAD_BUCKETS = (
    0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0, 32.0, 64.0,
)


def _fmt_labels(names: Tuple[str, ...], values: Tuple[str, ...], extra: str = "") -> str:
    parts = [f'{n}="{v}"' for n, v in zip(names, values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_value(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class Counter:
    """Monotone counter. ``inc`` is the ONLY mutator — and the atomic
    section: replica step threads share instruments, and a bare ``+=``
    loses increments under interleaving."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increments must be >= 0, got {n}")
        with self._lock:
            self.value += n


class Gauge:
    """Last-value gauge (pool occupancy, bytes free, batch fill)."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)


class Histogram:
    """Fixed-bound cumulative histogram with exact sum/count.

    ``bounds`` are the finite upper bounds; an implicit +Inf bucket catches
    the tail. ``counts[i]`` is NON-cumulative per bucket (cumulated only at
    exposition) so ``observe`` stays O(log n_buckets).

    ``observe`` updates bucket + sum + count as ONE atomic section: an
    unlocked interleaving could commit a bucket increment without its sum
    (or vice versa) and break the exact-conservation pins the tests rely on.
    """

    __slots__ = ("bounds", "counts", "sum", "count", "_lock")

    def __init__(self, bounds: Sequence[float]):
        b = tuple(float(x) for x in bounds)
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(f"histogram bounds must be strictly increasing: {b}")
        self.bounds = b
        self.counts = [0] * (len(b) + 1)  # last = +Inf
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self.counts[bisect.bisect_left(self.bounds, float(v))] += 1
            self.sum += float(v)
            self.count += 1

    def cumulative(self) -> List[int]:
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out

    def quantile(self, q: float) -> Optional[float]:
        """Bucket-resolution quantile estimate (upper bound of the bucket the
        q-th observation falls in; +Inf tail reports the largest finite
        bound). None when empty. Coarse by design: exact percentiles come
        from the per-request traces, not histograms."""
        if self.count == 0:
            return None
        rank = q * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= rank and c:
                return self.bounds[i] if i < len(self.bounds) else self.bounds[-1]
        return self.bounds[-1]


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """One registered metric name: help text, kind, label names, children
    keyed by label-value tuples. Unlabelled metrics have a single child at
    the empty key."""

    __slots__ = ("name", "kind", "help", "label_names", "buckets", "children",
                 "_lock")

    def __init__(self, name, kind, help_text, label_names, buckets=None):
        self.name = name
        self.kind = kind
        self.help = help_text
        self.label_names = tuple(label_names)
        self.buckets = tuple(buckets) if buckets else None
        self.children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()

    def child(self, label_values: Tuple[str, ...]):
        # fast path: an existing child is immutable membership (children are
        # never removed), so the lock-free read is safe; the MINT must hold
        # the family lock — two replica threads asking for the same new
        # label concurrently would otherwise each construct a child and one
        # thread's observations would land in an orphan the exposition
        # never sees (a check-then-act race)
        c = self.children.get(label_values)
        if c is None:
            if len(label_values) != len(self.label_names):
                raise ValueError(
                    f"{self.name}: expected labels {self.label_names}, "
                    f"got {label_values}"
                )
            with self._lock:
                c = self.children.get(label_values)
                if c is None:
                    c = (
                        Histogram(self.buckets)
                        if self.kind == "histogram"
                        else _KINDS[self.kind]()
                    )
                    self.children[label_values] = c
        return c


class MetricsRegistry:
    """Process-local metric registry. Registration is idempotent: asking for
    an existing name returns the SAME family (kind/labels must match — a
    mismatch is a programming error, raised loudly)."""

    def __init__(self):
        self._families: Dict[str, _Family] = {}
        self._lock = threading.Lock()

    # ---- registration ----------------------------------------------------

    def _register(self, name, kind, help_text, labels, buckets=None) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.label_names != tuple(labels) or (
                    kind == "histogram" and fam.buckets != tuple(buckets)
                ):
                    raise ValueError(
                        f"metric {name!r} re-registered with a different "
                        f"kind/labels/buckets"
                    )
                return fam
            fam = _Family(name, kind, help_text, labels, buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help_text: str = "", labels: Sequence[str] = ()):
        fam = self._register(name, "counter", help_text, labels)
        return fam if labels else fam.child(())

    def gauge(self, name: str, help_text: str = "", labels: Sequence[str] = ()):
        fam = self._register(name, "gauge", help_text, labels)
        return fam if labels else fam.child(())

    def histogram(
        self,
        name: str,
        help_text: str = "",
        buckets: Sequence[float] = LATENCY_MS_BUCKETS,
        labels: Sequence[str] = (),
    ):
        fam = self._register(name, "histogram", help_text, labels, buckets)
        return fam if labels else fam.child(())

    # ---- exposition ------------------------------------------------------

    def snapshot(self) -> Dict:
        """JSON-able view of every family (the ``--metrics-out`` format)."""
        out: Dict[str, Dict] = {}
        with self._lock:
            for name, fam in sorted(self._families.items()):
                samples = []
                # copy under the FAMILY lock: minting happens there, not
                # under the registry lock — iterating the live dict while a
                # replica thread mints a new label child would raise
                # mid-scrape
                with fam._lock:
                    children = sorted(fam.children.items())
                for lv, child in children:
                    labels = dict(zip(fam.label_names, lv))
                    if fam.kind == "histogram":
                        samples.append(
                            {
                                "labels": labels,
                                "sum": child.sum,
                                "count": child.count,
                                "buckets": {
                                    ("+Inf" if i == len(child.bounds) else
                                     _fmt_value(child.bounds[i])): c
                                    for i, c in enumerate(child.cumulative())
                                },
                            }
                        )
                    else:
                        samples.append({"labels": labels, "value": child.value})
                out[name] = {
                    "type": fam.kind,
                    "help": fam.help,
                    "samples": samples,
                }
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        with self._lock:
            for name, fam in sorted(self._families.items()):
                if fam.help:
                    lines.append(f"# HELP {name} {fam.help}")
                lines.append(f"# TYPE {name} {fam.kind}")
                with fam._lock:  # same copy-before-iterate as snapshot()
                    children = sorted(fam.children.items())
                for lv, child in children:
                    if fam.kind == "histogram":
                        cum = child.cumulative()
                        for i, c in enumerate(cum):
                            le = (
                                "+Inf" if i == len(child.bounds)
                                else _fmt_value(child.bounds[i])
                            )
                            extra = 'le="%s"' % le
                            lines.append(
                                f"{name}_bucket"
                                f"{_fmt_labels(fam.label_names, lv, extra)} {c}"
                            )
                        lines.append(
                            f"{name}_sum{_fmt_labels(fam.label_names, lv)} "
                            f"{_fmt_value(child.sum)}"
                        )
                        lines.append(
                            f"{name}_count{_fmt_labels(fam.label_names, lv)} "
                            f"{child.count}"
                        )
                    else:
                        lines.append(
                            f"{name}{_fmt_labels(fam.label_names, lv)} "
                            f"{_fmt_value(child.value)}"
                        )
        return "\n".join(lines) + "\n"

    def family_names(self) -> List[str]:
        """Sorted names of every registered family (the code half of the
        metric catalog's drift check)."""
        with self._lock:
            return sorted(self._families)

    def reset(self) -> None:
        with self._lock:
            self._families.clear()


_FAMILY_NAME_RE = re.compile(r"\bnxdi_[a-z0-9_]+")

#: exposition-format suffixes: a doc mentioning ``nxdi_x_bucket`` /
#: ``_sum`` / ``_count`` refers to the ``nxdi_x`` histogram family
_EXPOSITION_SUFFIXES = ("_bucket", "_sum", "_count")


def catalog_drift(
    doc_text: str, family_names: Sequence[str]
) -> Tuple[List[str], List[str]]:
    """Two-way drift between the documented metric catalog and the
    registered families: returns ``(undocumented, unregistered)`` —
    families in ``family_names`` that ``doc_text`` never mentions, and
    ``nxdi_*`` names the doc mentions that no family registers. Both lists
    empty == the catalog is exact."""
    registered = set(family_names)
    documented = set()
    for name in _FAMILY_NAME_RE.findall(doc_text):
        for suffix in _EXPOSITION_SUFFIXES:
            if name.endswith(suffix) and name[: -len(suffix)] in registered:
                name = name[: -len(suffix)]
                break
        documented.add(name)
    undocumented = sorted(registered - documented)
    unregistered = sorted(documented - registered)
    return undocumented, unregistered


# process-default registry: the demo/bench ``--metrics-out`` target and the
# registry :func:`..tracing.default_session` records into
_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _DEFAULT
