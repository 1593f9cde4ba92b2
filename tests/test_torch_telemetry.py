"""The port's telemetry core (``telemetry/metrics.py``, ``spans.py``,
``tracing.py``) held against the JAX package's on the CPU:

- the same sequence of observations gives the same Prometheus text and
  JSON snapshot from the port's ``MetricsRegistry`` as from the JAX one
  (counters, gauges, labelled families, histograms with their buckets);
- after the same serving drain (a router drain under a fault plan, a
  disaggregated drain) every counter family and every histogram's
  observation count of the port's session equal the JAX session's
  (wall-clock values are not compared);
- the event log (JSONL round trip, a corrupt tail skipped, the bounded
  ring and its dropped counter), the chrome trace exported during a
  concurrent drain, the retrace-guard bridge, exact counts under threads, a
  disabled session that records nothing, and the workload / SLO hooks that
  raise naming ROADMAP A8.

The pins are the reference's ``tests/test_telemetry.py``'s."""

import json
import random
import threading

import pytest
import torch

from neuronx_distributed_inference_tpu.telemetry import metrics as jmetrics
from neuronx_distributed_inference_tpu_torch.analysis import retrace_guard
from neuronx_distributed_inference_tpu_torch.telemetry import metrics as tmetrics
from neuronx_distributed_inference_tpu_torch.telemetry import tracing as ttracing
from neuronx_distributed_inference_tpu_torch.telemetry import (
    TelemetrySession,
    default_session,
    enable_default_session,
    load_events,
    set_default_session,
)
from tests.torch_router_common import Apps, family_counts, make_router, ns, state_dict

pytestmark = pytest.mark.router


def _replay(mod, ops):
    r = mod.MetricsRegistry()
    for op in ops:
        kind, name, labels, value = op
        if kind == "counter":
            fam = r.counter(name, "help " + name, labels=tuple(k for k, _ in labels))
        elif kind == "gauge":
            fam = r.gauge(name, "help " + name, labels=tuple(k for k, _ in labels))
        else:
            fam = r.histogram(name, "help " + name, buckets=mod.LATENCY_MS_BUCKETS, labels=tuple(k for k, _ in labels))
        inst = fam.child(tuple(v for _, v in labels)) if labels else fam
        getattr(inst, {"counter": "inc", "gauge": "set", "histogram": "observe"}[kind])(value)
    return r


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_exposition_equals_jax(seed):
    rng = random.Random(seed)
    names = [
        ("counter", "nxdi_a_total", ()), ("counter", "nxdi_b_total", ("reason",)),
        ("gauge", "nxdi_c", ()), ("gauge", "nxdi_d", ("replica",)),
        ("histogram", "nxdi_e_ms", ()), ("histogram", "nxdi_f_ms", ("kind", "replica")),
    ]
    ops = []
    for _ in range(300):
        kind, name, label_names = rng.choice(names)
        labels = tuple((k, rng.choice(["x", "y", "0", "1"])) for k in label_names)
        value = {
            "counter": rng.choice([1, 2, 0.5, 3]),
            "gauge": rng.choice([0, 1.5, 7, -2]),
            "histogram": rng.choice([0.1, 1.0, 2.5, 33.3, 499.0, 1e5]),
        }[kind]
        ops.append((kind, name, labels, value))
    j, t = _replay(jmetrics, ops), _replay(tmetrics, ops)
    assert t.prometheus_text() == j.prometheus_text()
    assert t.snapshot() == j.snapshot()
    assert t.family_names() == j.family_names()
    json.dumps(t.snapshot())


def test_registry_instruments_and_errors():
    r = tmetrics.MetricsRegistry()
    c = r.counter("nxdi_x_total", "things")
    c.inc()
    c.inc(2)
    assert c.value == 3
    with pytest.raises(ValueError):
        c.inc(-1)
    assert r.counter("nxdi_x_total") is c
    with pytest.raises(ValueError):
        r.gauge("nxdi_x_total")
    h = r.histogram("nxdi_h_ms", "lat", buckets=(1, 10, 100))
    for v in (0.5, 5, 50, 5000):
        h.observe(v)
    assert (h.count, h.sum, h.cumulative()) == (4, 5055.5, [1, 2, 3, 4])
    assert h.quantile(0.5) == 10.0
    with pytest.raises(ValueError):
        tmetrics.Histogram((2, 1))
    assert tmetrics.default_registry() is tmetrics.default_registry()
    assert tmetrics.PROMETHEUS_CONTENT_TYPE == jmetrics.PROMETHEUS_CONTENT_TYPE


def test_catalog_drift_matches_jax():
    doc = "| `nxdi_requests_total` | `nxdi_step_ms` | `nxdi_step_ms_bucket` | `nxdi_ghost_metric_total` |"
    fams = ["nxdi_requests_total", "nxdi_step_ms", "nxdi_secret_gauge"]
    assert tmetrics.catalog_drift(doc, fams) == jmetrics.catalog_drift(doc, fams) == (
        ["nxdi_secret_gauge"], ["nxdi_ghost_metric_total"],
    )


def test_session_registers_the_reference_families():
    from neuronx_distributed_inference_tpu.telemetry import TelemetrySession as JaxTelemetry

    with JaxTelemetry() as j, TelemetrySession() as t:
        assert t.registry.family_names() == j.registry.family_names()
        assert t.registry.prometheus_text() == j.registry.prometheus_text()


@pytest.fixture(scope="module")
def apps():
    return Apps(state_dict())


#: families whose wall-clock values cannot agree, compared by count only, and
#: the trace census, which counts each framework's own programs
_SKIP = {"nxdi_jit_traces_total", "nxdi_sealed_retrace_total"}
_WALL_GAUGES = {"nxdi_serving_host_frac", "nxdi_router_step_overlap_frac"}


def _drain_families(apps, pkg, scenario):
    m = ns(pkg)
    with m.Telemetry() as tel:
        if scenario == "router_faults":
            inj = [
                m.faults.FaultInjector(seed=1).random_schedule(30, 0.3, kinds=("exhaust_pool",)),
                m.faults.FaultInjector().nan_logits(4, 0),
            ]
            router = make_router(pkg, apps.get(pkg, "paged"), telemetry=tel, injectors=inj)
            out = router.run_to_completion()
        else:
            fleet = apps.get(pkg, "contiguous", 2) + apps.get(pkg, "prefill_stage", 1)
            ph = m.replica.PrefillReplicaHandle(fleet[2], 0, fault_injector=m.faults.FaultInjector(0).handoff_corrupt(1))
            router = m.router.ServingRouter(
                [m.serving.ServingSession(a, telemetry=tel) for a in fleet[:2]], telemetry=tel,
                prefill_replicas=[ph], sleep_fn=lambda s: None,
            )
            for i, ids in enumerate(([5, 17, 92, 41], [7, 7, 7], list(range(30, 52)), [64, 2, 90])):
                router.add_request(f"h{i}", ids, max_new_tokens=5)
            out = router.run_to_completion()
        snap = tel.registry.snapshot()
    fams = family_counts(snap, skip=_SKIP)
    for name in _WALL_GAUGES:
        fams[name] = (fams[name][0], set(fams[name][1]))  # labels only
    return out, fams


@pytest.mark.parametrize("scenario", ["router_faults", "disagg"])
def test_drain_families_equal_jax(apps, scenario):
    """After the same drain, every counter family and every histogram's
    observation count of the port's registry equal the JAX session's."""
    jout, jfams = _drain_families(apps, "jax", scenario)
    tout, tfams = _drain_families(apps, "port", scenario)
    assert tout == jout
    assert set(tfams) == set(jfams)
    for name in sorted(jfams):
        assert tfams[name] == jfams[name], name


def test_event_log_jsonl_round_trip_and_corrupt_tail(tmp_path):
    path = str(tmp_path / "events.jsonl")
    with TelemetrySession(jsonl_path=path) as s:
        s.request_submitted("r")
        s.request_first_token("r")
        s.request_finished("r", "eos")
        s.event("custom", x=1)
    with open(path, "a") as f:
        f.write('{"type": "c", "ts":')  # a half-written last line
    with pytest.warns(UserWarning, match="skipping corrupt JSONL line"):
        events = load_events(path)
    assert [e["type"] for e in events] == ["request_submitted", "first_token", "request_finished", "custom"]
    assert [e["type"] for e in events] == [e["type"] for e in s.events]


def test_event_buffer_bounded_with_dropped_counter(monkeypatch):
    monkeypatch.setenv(ttracing.TELEMETRY_EVENT_MAX_ENV, "8")
    with TelemetrySession() as s:
        for i in range(20):
            s.event("tick", i=i)
        assert [e["i"] for e in s.events] == list(range(12, 20))
        drop = s.registry.snapshot()["nxdi_telemetry_dropped_total"]["samples"]
        assert drop == [{"labels": {"kind": "events"}, "value": 12.0}]
        assert s.spans.max_spans == 8


def test_export_chrome_trace_during_concurrent_recording(tmp_path):
    with TelemetrySession() as s:
        stop, errors = threading.Event(), []

        def hammer(k):
            i = 0
            try:
                while not stop.is_set():
                    rid = f"t{k}-{i:04d}"
                    s.request_submitted(rid)
                    s.request_first_token(rid)
                    s.request_tokens(rid, 2)
                    s.request_finished(rid, "eos")
                    i += 1
            except Exception as e:  # the failure signal
                errors.append(e)

        threads = [threading.Thread(target=hammer, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        try:
            docs = [s.export_chrome_trace() for _ in range(10)]
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive()
        assert errors == []
        for doc in docs:
            json.dumps(doc)
        final = s.export_chrome_trace(str(tmp_path / "trace.json"))
    assert any(ev["ph"] == "X" for ev in final["traceEvents"])
    assert json.load(open(tmp_path / "trace.json"))["traceEvents"]


def test_thread_safe_exact_counts():
    reg = tmetrics.MetricsRegistry()
    fam = reg.counter("t_ctr", "x", labels=("who",))
    hist = reg.histogram("t_hist", "x", buckets=(1.0, 10.0))
    n_threads, n_ops = 8, 1000
    barrier = threading.Barrier(n_threads)
    minted = set()

    def worker():
        barrier.wait()
        c = fam.child(("shared",))
        minted.add(id(c))
        for k in range(n_ops):
            c.inc()
            hist.observe(float(k % 20))

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert len(minted) == 1
    assert fam.child(("shared",)).value == n_threads * n_ops == hist.count
    with TelemetrySession() as tel:
        for i in range(4):
            tel.request_submitted(f"q{i}")

        def tokens(i):
            tel.request_first_token(f"q{i}")
            for _ in range(199):
                tel.request_tokens(f"q{i}", 1)
            tel.request_finished(f"q{i}", "length")

        threads = [threading.Thread(target=tokens, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert tel.counters["tokens_generated"] == 800 and not tel.traces and len(tel.completed) == 4


def test_retrace_counter_bridge():
    """Every noted trace counts in nxdi_jit_traces_total; a forbidden
    post-seal one also in nxdi_sealed_retrace_total before it raises; the
    listener goes with close()."""
    with TelemetrySession() as tel:
        retrace_guard.note_trace("toy")
        retrace_guard.note_trace("toy")
        with pytest.raises(retrace_guard.RetraceError):
            retrace_guard.note_trace("toy", sealed=True)
        snap = tel.registry.snapshot()
    assert snap["nxdi_jit_traces_total"]["samples"] == [{"labels": {"tag": "toy"}, "value": 3.0}]
    assert snap["nxdi_sealed_retrace_total"]["samples"] == [{"labels": {"tag": "toy"}, "value": 1.0}]
    assert any(e["type"] == "sealed_retrace" for e in tel.events)
    retrace_guard.note_trace("toy")
    assert tel.registry.snapshot()["nxdi_jit_traces_total"]["samples"][0]["value"] == 3.0


def test_span_opens_a_profiler_range():
    with TelemetrySession() as tel, torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tel.span("serving.decode", rows=3):
            torch.ones(2) + 1
    assert "serving.decode" in {e.key for e in prof.key_averages()}
    assert [e["name"] for e in tel.events if e["type"] == "span"] == ["serving.decode"]


def test_disabled_session_records_nothing(apps):
    tel = TelemetrySession(enabled=False)
    router = make_router("port", apps.get("port", "paged"), telemetry=tel)
    router.run_to_completion()
    assert tel.registry.family_names() == [] and not tel.events and not tel.completed
    assert tel.spans is None and tel.span_tree() == {} and tel.counters == {}
    assert tel.export_chrome_trace()["traceEvents"] == []


def test_default_session_switches():
    assert not default_session().enabled
    prev = default_session()
    try:
        on = enable_default_session()
        assert on.enabled and enable_default_session() is on
        assert on.registry is tmetrics.default_registry()
    finally:
        set_default_session(prev)
        on.close()
    assert default_session() is prev


@pytest.mark.parametrize(
    "hook,args",
    [
        ("set_tenants", ({},)), ("attach_slo_monitor", (None,)), ("chaos_kill", (0, "decode", 1)),
        ("workload_step", (1, {}, 0.1)), ("slo_missed", ("ttft", "t")), ("workload_backlog", (3,)),
        ("workload_refused", ("no_slot",)),
    ],
)
def test_workload_and_slo_hooks_raise(hook, args):
    with pytest.raises(NotImplementedError, match=r"ROADMAP A8 \(workload and SLO\)"):
        getattr(TelemetrySession(), hook)(*args)
