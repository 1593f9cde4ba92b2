"""The port's live SLO side on the CPU, mirroring tests/test_ops_server.py
and tests/test_obs_timeline.py: the ops server's three routes and its
clean shutdown, ``/slo`` following the monitor, the live monitor's
verdicts and burn-rate gauges against the offline scorer (and against the
JAX package's monitor on the same run), the chaos row's trace against the
scorer's dip, and the span tree of a seeded two-replica drain, identical
sequential and threaded (and equal to the JAX package's)."""

import json
import urllib.error
import urllib.request

import pytest

from neuronx_distributed_inference_tpu import telemetry as jtel
from neuronx_distributed_inference_tpu import workload as jw
from neuronx_distributed_inference_tpu_torch import workload as tw
from neuronx_distributed_inference_tpu_torch.telemetry import (
    PROMETHEUS_CONTENT_TYPE,
    MetricsRegistry,
    OpsServer,
    SloMonitor,
)
from neuronx_distributed_inference_tpu_torch.telemetry import slo_monitor as tmon
from tests import torch_router_common as common

WL = {"jax": jw, "port": tw}
MONITOR = {"jax": jtel.SloMonitor, "port": SloMonitor}


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read().decode()


def test_ops_server_three_routes_and_clean_shutdown():
    reg = MetricsRegistry()
    reg.counter("nxdi_ops_smoke_total", "route smoke counter").inc(3)
    mon = SloMonitor(windows=(5, 60), slo_target=0.99)
    mon.bind(reg)
    health = {"replicas": [{"replica": 0, "health": "live"}], "queue_depth": 0}
    srv = OpsServer(reg, health_fn=lambda: health, slo_fn=mon.snapshot)
    port = srv.start()
    assert port > 0 and srv.url.endswith(str(port))
    assert srv.start() == port  # idempotent

    status, ctype, body = _get(f"{srv.url}/metrics")
    assert status == 200 and ctype == PROMETHEUS_CONTENT_TYPE
    assert "nxdi_ops_smoke_total 3" in body
    status, ctype, body = _get(f"{srv.url}/health")
    assert status == 200 and ctype == "application/json"
    assert json.loads(body) == health
    status, ctype, body = _get(f"{srv.url}/slo/")  # trailing slash tolerated
    assert status == 200 and ctype == "application/json"
    slo = json.loads(body)
    assert slo["slo_target"] == 0.99 and set(slo["windows"]) == {"5", "60"}
    assert slo["windows"]["5"]["attainment"]["_all"] == 1.0
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(f"{srv.url}/nope")
    assert ei.value.code == 404

    thread = srv._thread
    assert thread is not None and thread.is_alive()
    srv.stop()
    thread.join(timeout=10)
    assert not thread.is_alive()  # stop() joins: no serve thread outlives it
    srv.stop()  # idempotent


class _Arr:
    def __init__(self, rid):
        self.req_id, self.tenant, self.step = rid, "t0", 0
        self.ttft_slo_s, self.itl_slo_s = 1.0, None


class _Trace:
    arrivals = [_Arr("t0-0000"), _Arr("t0-0001")]


def test_slo_route_follows_the_monitor():
    """A scrape mid-drain sees the monitor's windowed state: a miss judged
    inside the fast window drives burn above 1 for slo_target 0.99; the
    JAX package's monitor fed the same notes reports the same snapshot."""
    snaps = {}
    for pkg, cls in MONITOR.items():
        reg = MetricsRegistry() if pkg == "port" else jtel.MetricsRegistry()
        mon = cls(windows=(5, 60), slo_target=0.99)
        mon.bind(reg)
        mon.register_trace(_Trace(), step_dt_s=1.0)
        mon.note_first_token("t0-0000", 0.5)
        mon.note_finish("t0-0000", "eos", 1.0)  # met
        mon.note_first_token("t0-0001", 3.0)
        mon.note_finish("t0-0001", "eos", 4.0)  # ttft miss
        mon.tick(4)
        snaps[pkg] = mon.snapshot()
    assert snaps["port"] == snaps["jax"]

    reg = MetricsRegistry()
    mon = SloMonitor(windows=(5, 60))
    mon.bind(reg)
    mon.register_trace(_Trace(), step_dt_s=1.0)
    with OpsServer(reg, slo_fn=mon.snapshot) as srv:
        _, _, body = _get(f"{srv.url}/slo")
        assert json.loads(body)["judged"] == 0
        mon.note_first_token("t0-0000", 0.5)
        mon.note_finish("t0-0000", "eos", 1.0)
        mon.note_first_token("t0-0001", 3.0)
        mon.note_finish("t0-0001", "eos", 4.0)
        mon.tick(4)
        slo = json.loads(_get(f"{srv.url}/slo")[2])
        assert (slo["judged"], slo["met"], slo["misses_by_kind"]) == (2, 1, {"ttft": 1})
        assert slo["windows"]["5"]["attainment"]["_all"] == 0.5
        assert slo["windows"]["5"]["burn_rate"]["_all"] == pytest.approx(0.5 / 0.01)
        text = _get(f"{srv.url}/metrics")[2]
        line = next(ln for ln in text.splitlines() if ln.startswith('nxdi_slo_burn_rate{window="5",tenant="_all"}'))
        assert float(line.rsplit(" ", 1)[1]) == pytest.approx(0.5 / 0.01)
        assert _get(f"{srv.url}/health")[0] == 200  # no health_fn serves {}
    assert srv._thread is None or not srv._thread.is_alive()


# ---------------------------------------------------------------------------
# live drains: two paged replicas on the virtual clock
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def apps():
    return common.Apps(common.state_dict())


def _spec(pkg="port", seed=3, n=8, rate=1.5, **kw):
    base = dict(
        seed=seed, n_requests=n, vocab_size=118, rate=rate, max_prompt_len=16, min_output_len=4,
        max_output_len=8, shared_prefix_len=8, ttft_slo_s=1e4, itl_slo_s=1e3,
    )
    base.update(kw)
    return WL[pkg].standard_spec(**base)


def _run(pkg, apps, trace_json, *, threaded=False, chaos=None, monitor=False):
    m, w = common.ns(pkg), WL[pkg]
    trace = w.WorkloadTrace.loads(trace_json)
    vc = w.VirtualClock()
    with m.Telemetry(clock=vc.now) as tel:
        mon = None
        if monitor:
            mon = MONITOR[pkg]()
            tel.attach_slo_monitor(mon)
        sessions = [m.serving.ServingSession(a, telemetry=tel, clock=vc.now) for a in apps.get(pkg, "paged", 2)]
        handles = [m.replica.ReplicaHandle(s, i, clock=vc.now) for i, s in enumerate(sessions)]
        with m.router.ServingRouter(handles, policy="least_loaded", telemetry=tel, clock=vc.now,
                                    threaded=threaded) as router:
            plan = w.ChaosPlan(**chaos) if chaos else None
            result = w.WorkloadDriver(router, trace, clock=vc, telemetry=tel, chaos=plan).run()
    return result, tel, mon


def _schema_check(doc):
    """The minimal Chrome trace-event schema of the export."""
    evs = doc["traceEvents"]
    assert evs
    flows = {}
    for ev in evs:
        assert "ph" in ev and "pid" in ev and "name" in ev
        if ev["ph"] == "M":
            continue
        assert "ts" in ev and "tid" in ev and ev["ts"] >= 0
        if ev["ph"] == "X":
            assert ev["dur"] >= 0
        if ev["ph"] in ("s", "f"):
            flows.setdefault(ev["id"], set()).add(ev["ph"])
    assert all(p == {"s", "f"} for p in flows.values())


def test_span_tree_sequential_equals_threaded_and_jax(apps):
    trace_json = tw.generate(_spec(seed=5, n=12, rate=1.0, min_output_len=6, max_output_len=10)).dumps()
    res_a, tel_a, _ = _run("port", apps, trace_json)
    res_b, tel_b, _ = _run("port", apps, trace_json, threaded=True)
    res_j, tel_j, _ = _run("jax", apps, trace_json)
    assert res_a.outputs == res_b.outputs == res_j.outputs
    tree = tel_a.span_tree()
    assert any(sid.startswith("req:") for sid in tree)
    assert any(sid.startswith("replica:") for sid in tree)
    assert any(sid.startswith("driver/") for sid in tree)
    assert tree == tel_b.span_tree() == tel_j.span_tree()
    doc = tel_a.export_chrome_trace()
    _schema_check(doc)
    tracks = {ev["args"]["name"] for ev in doc["traceEvents"] if ev["ph"] == "M"}
    assert {"replica:0", "replica:1", "driver"} <= tracks
    assert any(t.startswith("tenant:") for t in tracks)


def test_chaos_trace_agrees_with_scorer_dip(apps):
    trace_json = tw.generate(_spec(seed=5, n=14, rate=1.0, min_output_len=12, max_output_len=16)).dumps()
    res, tel, _ = _run("port", apps, trace_json, chaos=dict(kill_step=8))
    rep = tw.score(res, tel, bucket_steps=4)
    assert rep.attainment == 1.0 and rep.dip is not None and rep.dip.dip_frac > 0.0
    assert rep.dip.recovery_steps is not None
    doc = tel.export_chrome_trace()
    _schema_check(doc)
    evs = doc["traceEvents"]
    kills = [ev for ev in evs if ev["ph"] == "i" and ev["name"] == "chaos_kill"]
    assert len(kills) == 1 and kills[0]["args"]["step"] == res.chaos["step"] == 8
    assert any(ev["ph"] == "X" and ev["name"].startswith("incarnation ") and ev["name"] != "incarnation 0"
               for ev in evs)
    step_commits = {
        int(ev["args"]["span_id"][len("driver/step"):]): ev["args"]["commit_tokens"]
        for ev in evs
        if ev["ph"] == "X" and ev["args"].get("span_id", "").startswith("driver/step")
    }
    b = rep.bucket_steps
    series = [sum(step_commits.get(s, 0) for s in range(i, i + b)) for i in range(0, len(rep.series) * b, b)]
    assert series[:-1] == rep.series[:-1] and series[-1] >= rep.series[-1]
    dip = tw.extract_dip(rep.series, res.chaos["step"] // b, bucket_steps=b,
                         alive_frac=res.chaos.get("alive_frac") or 0.5)
    assert (dip.dip_frac, dip.recovery_steps) == (rep.dip.dip_frac, rep.dip.recovery_steps)


def test_burn_rate_matches_offline_scorer_and_jax(apps):
    trace_json = tw.generate(_spec(seed=7, n=10, rate=2.5, min_output_len=6, max_output_len=10, ttft_slo_s=2.0,
                                   itl_slo_s=1e3)).dumps()
    res, tel, mon = _run("port", apps, trace_json, monitor=True)
    _, _, mon_j = _run("jax", apps, trace_json, monitor=True)
    rep = tw.score(res, tel, bucket_steps=4)
    assert tmon._base_req_id("t-0001~f1") == "t-0001"
    verdicts = {s.req_id: s.miss_kind for s in rep.per_request}
    assert mon.verdicts == verdicts == mon_j.verdicts
    assert mon.snapshot() == mon_j.snapshot()
    assert any(v is None for v in verdicts.values()) and any(v is not None for v in verdicts.values())
    assert 0.0 < rep.attainment < 1.0
    snap = tel.registry.snapshot()
    burn = {(s["labels"]["window"], s["labels"]["tenant"]): s["value"] for s in snap["nxdi_slo_burn_rate"]["samples"]}
    assert {w for w, _ in burn} == {"5", "60"} and "_all" in {t for _, t in burn}
    last = mon.snapshot()["step"]
    for (w, tenant), value in burn.items():
        rows = [j for j in mon.judgments if j.step > last - int(w) and (tenant == "_all" or j.tenant == tenant)]
        attain = sum(1 for j in rows if j.verdict is None) / len(rows) if rows else 1.0
        assert value == pytest.approx((1.0 - attain) / (1.0 - 0.99))
