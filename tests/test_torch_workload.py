"""The port's workload engine (``workload/``: generator, open-loop driver,
SLO scorer) held against the JAX package's on the CPU at fp32, mirroring
tests/test_workload.py.

The generator is a copy: the same spec gives the same trace JSON and
digest, and each package reads the other's dump. The driver runs on a
``VirtualClock`` over a port session or router and over JAX apps loaded
from the same state dict (``tests/torch_router_common.py``); per-request
tokens, statuses, admission events, backlog refusals, step commits, the
chaos record and the whole ``SloReport`` must be identical: the clean
open-loop row, the bursty backlog row (with and without the give-up), a
decode-replica chaos kill, a two-kill schedule and a prefill-tier kill
behind the disaggregated tier."""

import dataclasses
import json
import warnings

import pytest

from neuronx_distributed_inference_tpu import workload as jw
from neuronx_distributed_inference_tpu.workload import driver as jdriver
from neuronx_distributed_inference_tpu_torch import workload as tw
from neuronx_distributed_inference_tpu_torch.runtime.serving import AdmissionResult
from neuronx_distributed_inference_tpu_torch.workload import driver as tdriver
from neuronx_distributed_inference_tpu_torch.workload.generator import base_req_id, make_accept_gate
from tests import torch_router_common as common

WL = {"jax": jw, "port": tw}
DRIVER = {"jax": jdriver, "port": tdriver}


def _spec(pkg="port", seed=3, n=8, rate=1.5, **kw):
    base = dict(
        seed=seed, n_requests=n, vocab_size=118, rate=rate, max_prompt_len=16, min_output_len=4,
        max_output_len=8, shared_prefix_len=8, ttft_slo_s=1e4, itl_slo_s=1e3,
    )
    base.update(kw)
    return WL[pkg].standard_spec(**base)


def _custom_spec(pkg):
    """Two weighted tenants built directly: a shared prefix, a deadline,
    SLO terms and a diurnal envelope."""
    w = WL[pkg]
    tenants = (
        w.TenantProfile(name="chat", weight=3.0, shared_prefix_len=8, max_prompt_len=16, min_output_len=2,
                        max_output_len=6, ttft_slo_s=4.0, itl_slo_s=2.0, spec_accept_rate=0.7),
        w.TenantProfile(name="batch", weight=1.0, shared_prefix_len=0, max_prompt_len=12, min_output_len=4,
                        max_output_len=10, deadline_s=30.0),
    )
    arrival = w.ArrivalSpec(kind="diurnal", rate=3.0, diurnal_period=16, diurnal_floor=0.25)
    return w.WorkloadSpec(seed=11, n_requests=20, vocab_size=50, arrival=arrival, tenants=tenants)


SPECS = {
    "poisson": lambda pkg: _spec(pkg),
    "onoff": lambda pkg: _spec(pkg, seed=7, n=10, rate=4.0, arrival_kind="onoff"),
    "diurnal": lambda pkg: _spec(pkg, seed=5, n=12, rate=2.0, arrival_kind="diurnal"),
    "tenants": lambda pkg: _spec(pkg, seed=9, n=16, n_tenants=4, spec_profiles=True),
    "shared_prefix": _custom_spec,
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_trace_digest_and_json_match_jax(name):
    t_port = tw.generate(SPECS[name]("port"))
    t_jax = jw.generate(SPECS[name]("jax"))
    assert t_port.dumps() == t_jax.dumps()
    assert t_port.digest() == t_jax.digest()
    # each package reads the other's dump back byte for byte
    assert tw.WorkloadTrace.loads(t_jax.dumps()).dumps() == t_jax.dumps()
    assert jw.WorkloadTrace.loads(t_port.dumps()).digest() == t_port.digest()
    assert tw.WorkloadTrace.loads(json.loads(t_port.dumps())).digest() == t_port.digest()
    assert tw.generate(SPECS[name]("port")).digest() == t_port.digest()


def test_arrival_envelopes_and_bounds_match_jax():
    for pkg in ("port", "jax"):
        w = WL[pkg]
        onoff = w.ArrivalSpec(kind="onoff", rate=4.0, off_rate=0.0, period_on=2, period_off=3)
        assert [onoff.rate_at(s) for s in range(10)] == [4.0, 4.0, 0.0, 0.0, 0.0] * 2
        with pytest.raises(ValueError, match="unknown arrival kind"):
            w.ArrivalSpec(kind="bogus")
        with pytest.raises(ValueError, match="suffix"):
            w.TenantProfile(name="bad", shared_prefix_len=16, max_prompt_len=16)
    di = [tw.ArrivalSpec(kind="diurnal", rate=8.0, diurnal_period=16).rate_at(s) for s in range(16)]
    dj = [jw.ArrivalSpec(kind="diurnal", rate=8.0, diurnal_period=16).rate_at(s) for s in range(16)]
    assert di == dj and max(di) > min(di) >= 2.0 - 1e-9
    trace = tw.generate(_custom_spec("port"))
    prefix = [a.input_ids[:8] for a in trace.arrivals if a.tenant == "chat"]
    assert prefix and all(p == prefix[0] for p in prefix)
    assert all(0 <= t < 50 for a in trace.arrivals for t in a.input_ids)
    assert [a.step for a in trace.arrivals] == sorted(a.step for a in trace.arrivals)


def test_accept_gate_matches_jax_across_failover_suffix():
    from neuronx_distributed_inference_tpu.workload.generator import make_accept_gate as jax_gate

    assert base_req_id("prose0-0003~f1") == "prose0-0003"
    assert base_req_id("odd~fx") == "odd~fx"
    trace = tw.generate(_spec(seed=2, n=6, spec_profiles=True))
    g_port, g_jax = make_accept_gate(trace), jax_gate(jw.WorkloadTrace.loads(trace.dumps()))
    for a in trace.arrivals:
        for rid in (a.req_id, a.req_id, f"{a.req_id}~f1"):
            assert g_port(rid, 3) == g_jax(rid, 3)
    assert g_port("unknown-req", 3) is None


def _handbuilt(pkg):
    """Three requests (tests/test_workload.py::_handbuilt_result): one meets,
    one blows its TTFT, one fails server-side; and the session traces."""
    from neuronx_distributed_inference_tpu.telemetry.tracing import RequestTrace as JaxTrace
    from neuronx_distributed_inference_tpu_torch.telemetry.tracing import RequestTrace

    w = WL[pkg]
    tenants = (w.TenantProfile(name="a", ttft_slo_s=5.0, itl_slo_s=10.0, max_prompt_len=8, max_output_len=8),)
    spec = w.WorkloadSpec(seed=0, n_requests=3, vocab_size=16, tenants=tenants, arrival=w.ArrivalSpec(rate=10.0))
    arrivals = [
        w.Arrival("a-0000", 0, "a", (1, 2), 4, ttft_slo_s=5.0, itl_slo_s=10.0),
        w.Arrival("a-0001", 0, "a", (3, 4), 4, ttft_slo_s=5.0, itl_slo_s=10.0),
        w.Arrival("a-0002", 2, "a", (5, 6), 4, ttft_slo_s=5.0, itl_slo_s=10.0),
    ]
    res = DRIVER[pkg].WorkloadResult(trace=w.WorkloadTrace(spec=spec, arrivals=arrivals))
    res.outputs = {"a-0000": [7, 8, 9, 1], "a-0001": [7, 7, 7, 7], "a-0002": [2]}
    res.statuses = {"a-0000": "finished", "a-0001": "finished", "a-0002": "failed"}
    res.step_commits = [{}, {"a-0000": 2}, {"a-0000": 2, "a-0001": 4}, {"a-0002": 1}, {}]
    res.live_steps = [True, True, True, False, False]
    res.steps = 5
    tel = common.ns(pkg).Telemetry()
    rt = JaxTrace if pkg == "jax" else RequestTrace
    tel.completed.append(rt(req_id="a-0000", t_submit=0.0, t_first_token=1.0, t_last_token=3.0, tokens=4,
                            finish_reason="length"))
    tel.completed.append(rt(req_id="a-0001", t_submit=0.0, t_first_token=8.0, t_last_token=9.0, tokens=4,
                            finish_reason="length"))
    tel.completed.append(rt(req_id="a-0002", t_submit=2.0, t_first_token=3.0, t_last_token=3.0, tokens=1,
                            finish_reason="dispatch_error"))
    return res, tel


def test_score_arithmetic_matches_jax():
    reps = {}
    for pkg in ("port", "jax"):
        res, tel = _handbuilt(pkg)
        reps[pkg] = WL[pkg].score(res, tel, bucket_steps=2)
        missed = {
            (s["labels"]["kind"], s["labels"]["tenant"]): s["value"]
            for s in tel.registry.snapshot()["nxdi_slo_missed_total"]["samples"]
        }
        assert missed == {("ttft", "a"): 1, ("failed", "a"): 1}
    rep = reps["port"]
    assert dataclasses.asdict(rep) == dataclasses.asdict(reps["jax"])
    assert rep.attainment == pytest.approx(1 / 3, abs=1e-4)
    assert rep.misses_by_kind == {"ttft": 1, "failed": 1}
    assert (rep.slo_met_tokens, rep.total_tokens, rep.series) == (4, 9, [2, 2])
    assert {s.req_id: s.miss_kind for s in rep.per_request} == {"a-0000": None, "a-0001": "ttft", "a-0002": "failed"}


@pytest.mark.parametrize(
    "series, kill, kw",
    [
        ([12, 20, 20, 8, 5, 9, 11, 10], 3, dict(bucket_steps=4, alive_frac=0.5, recovery_frac=0.8)),
        ([10, 20, 2, 2, 2], 2, dict(alive_frac=0.5)),
        ([0, 0, 0, 0], 2, {}),
        ([5, 5], 7, {}),
        ([7, 16, 14, 14], 1, {}),
        ([10, 20, 18, 19, 20, 6, 2], 2, dict(dip_window_buckets=3, alive_frac=1.0)),
    ],
)
def test_extract_dip_matches_jax(series, kill, kw):
    got, want = tw.extract_dip(series, kill, **kw), jw.extract_dip(series, kill, **kw)
    assert (got is None) == (want is None)
    if got is not None:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


class _StubTarget:
    """A single-session stand-in that refuses capacity until one driver
    step, then admits: the driver's backlog policy alone."""

    def __init__(self, admit_from_step):
        self.admit_from = admit_from_step
        self.requests = {}
        self.active = []
        self._readmit = []
        self.offers = []
        self._step_no = 0

    def add_request(self, rid, ids, max_new_tokens=0, deadline_s=None):
        self.offers.append((rid, self._step_no))
        if self._step_no < self.admit_from:
            return AdmissionResult(False, "no_slot")
        self.requests[rid] = type("R", (), {"generated": [], "status": "finished"})()
        return AdmissionResult(True)

    def step(self):
        self._step_no += 1
        return {}


def test_backlog_giveup_requires_refused_offer():
    tenants = (tw.TenantProfile(name="t", max_prompt_len=8, max_output_len=2),)
    spec = tw.WorkloadSpec(seed=0, n_requests=2, vocab_size=16, tenants=tenants)
    trace = tw.WorkloadTrace(spec=spec, arrivals=[tw.Arrival("t-0000", 0, "t", (1, 2), 2),
                                                  tw.Arrival("t-0001", 0, "t", (3, 4), 2)])
    res = tw.WorkloadDriver(_StubTarget(6), trace, clock=tw.VirtualClock(), max_backlog_steps=5).run()
    assert not res.never_served
    assert sorted(e.admitted_step for e in res.admissions) == [6, 6]
    stub = _StubTarget(10**9)
    res2 = tw.WorkloadDriver(stub, trace, clock=tw.VirtualClock(), max_backlog_steps=2).run()
    assert res2.never_served == {"t-0000": "backlog", "t-0001": "backlog"}
    assert {rid for rid, _ in stub.offers} == {"t-0000", "t-0001"}
    with pytest.raises(ValueError, match="router target"):
        tw.WorkloadDriver(_StubTarget(0), trace, chaos=tw.ChaosPlan(kill_step=1))


# ---------------------------------------------------------------------------
# the driver over live sessions and routers: port == JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def apps():
    return common.Apps(common.state_dict())


def _run(pkg, apps, mode, trace_json, *, n=1, chaos=None, prefill=False, **driver_kw):
    """One open-loop run of ``pkg`` on the virtual clock: a single session
    (``n == 1``) or a router over ``n`` replicas (and, with ``prefill``, the
    prefill tier). Returns (result, telemetry, SloReport)."""
    m, w = common.ns(pkg), WL[pkg]
    trace = w.WorkloadTrace.loads(trace_json)
    vc = w.VirtualClock()
    decode = apps.get(pkg, mode, n)
    tel = m.Telemetry(clock=vc.now)
    sessions = [m.serving.ServingSession(a, telemetry=tel, clock=vc.now) for a in decode]
    if n == 1 and not prefill:
        target = sessions[0]
    else:
        handles = [m.replica.ReplicaHandle(s, i, clock=vc.now) for i, s in enumerate(sessions)]
        kw = {}
        if prefill:
            (pre,) = apps.get(pkg, "prefill_stage", 1)
            kw["prefill_replicas"] = [m.replica.PrefillReplicaHandle(pre, 0)]
        target = m.router.ServingRouter(handles, policy="least_loaded", telemetry=tel, clock=vc.now, **kw)
    plan = w.ChaosPlan(**chaos) if chaos else None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        result = w.WorkloadDriver(target, trace, clock=vc, telemetry=tel, chaos=plan, **driver_kw).run()
    if target is not sessions[0]:
        target.close()
    tel.close()
    return result, tel, w.score(result, tel, bucket_steps=4)


def _view(result, rep):
    """Everything a run and its score say, as plain data."""
    return dict(
        outputs=result.outputs, statuses=result.statuses, never_served=result.never_served,
        admissions=[dataclasses.asdict(e) for e in result.admissions], step_commits=result.step_commits,
        live_steps=result.live_steps, backlog_refusals=result.backlog_refusals, steps=result.steps,
        chaos=result.chaos, report=dataclasses.asdict(rep),
    )


def _both(apps, mode, spec, **kw):
    trace_json = tw.generate(spec).dumps()
    (rp, tp, sp), (rj, tj, sj) = (_run(pkg, apps, mode, trace_json, **kw) for pkg in ("port", "jax"))
    assert _view(rp, sp) == _view(rj, sj)
    return rp, tp, sp


def _snap_sum(tel, family, **labels):
    samples = tel.registry.snapshot()[family]["samples"]
    return sum(s["value"] for s in samples if all(s["labels"].get(k) == v for k, v in labels.items()))


def test_clean_open_loop_row_matches_jax(apps):
    res, tel, rep = _both(apps, "paged", _spec(seed=5, n=10, rate=1.0, min_output_len=4, max_output_len=8))
    assert set(res.outputs) == {a.req_id for a in res.trace.arrivals}
    assert all(ev.admitted_step >= ev.arrival_step for ev in res.admissions)
    assert rep.attainment == 1.0 and rep.slo_met_tokens == rep.total_tokens > 0


def test_burst_backlog_row_matches_jax(apps):
    res, tel, rep = _both(apps, "paged", _spec(seed=7, n=10, rate=4.0, arrival_kind="onoff"))
    waited = [ev for ev in res.admissions if ev.admitted_step > ev.arrival_step]
    assert waited and res.backlog_refusals > 0
    assert _snap_sum(tel, "nxdi_workload_refusals_total") == res.backlog_refusals
    assert rep.attainment == 1.0
    by_req = {s.req_id: s for s in rep.per_request}
    for ev in waited:
        assert by_req[ev.req_id].ttft_s >= (ev.admitted_step - ev.arrival_step) * res.step_dt_s


def test_backlog_giveup_matches_jax(apps):
    res, tel, rep = _both(
        apps, "paged", _spec(seed=7, n=12, rate=6.0, min_output_len=6, max_output_len=8), max_backlog_steps=1
    )
    gave_up = [rid for rid, why in res.never_served.items() if why == "backlog"]
    assert gave_up
    assert _snap_sum(tel, "nxdi_requests_rejected_total", reason="backlog") == len(gave_up)
    assert _snap_sum(tel, "nxdi_requests_rejected_total") == len(gave_up)
    assert rep.misses_by_kind.get("never_served") == len(gave_up) and rep.attainment < 1.0


def test_decode_chaos_kill_matches_jax(apps):
    res, tel, rep = _both(
        apps, "paged", _spec(seed=5, n=14, rate=1.0, min_output_len=12, max_output_len=16),
        n=2, chaos=dict(kill_step=8),
    )
    assert res.chaos["step"] == 8 and "replica" in res.chaos
    assert all(st == "finished" for st in res.statuses.values())
    assert rep.attainment == 1.0
    assert rep.dip is not None and rep.dip.dip_frac > 0.0 and rep.dip.recovery_steps is not None


def test_two_kill_schedule_matches_jax(apps):
    res, _, _ = _both(
        apps, "paged", _spec(seed=7, n=10, rate=1.0, min_output_len=8, max_output_len=12),
        n=2, chaos=dict(kill_step=6, kills=2, gap_steps=6, seed=11),
    )
    assert [e["step"] for e in res.chaos["events"]] == [6, 12]
    assert {e["replica"] for e in res.chaos["events"]} == {0, 1}
    assert set(res.statuses.values()) == {"finished", "failed"}


def test_prefill_tier_kill_matches_jax(apps):
    res, tel, rep = _both(
        apps, "contiguous", _spec(seed=8, n=10, rate=1.0, min_output_len=8, max_output_len=12),
        n=2, prefill=True, chaos=dict(kill_step=4, tier="prefill", seed=3),
    )
    assert res.chaos["tier"] == "prefill" and res.chaos["alive_frac"] == 1.0
    assert all(st == "finished" for st in res.statuses.values())
    assert rep.attainment == 1.0
    assert _snap_sum(tel, "nxdi_handoff_local_prefill_total") > 0
    if rep.dip is not None:
        assert rep.dip.recovery_steps is not None


def test_deadline_on_the_virtual_clock_matches_jax(apps):
    tight = tw.TenantProfile(
        name="tight", shared_prefix_len=4, max_prompt_len=12, min_output_len=10, max_output_len=12, deadline_s=2.0,
    )
    spec = tw.WorkloadSpec(seed=1, n_requests=3, vocab_size=118, arrival=tw.ArrivalSpec(rate=3.0), tenants=(tight,))
    res, _, rep = _both(apps, "paged", spec)
    assert "failed" in res.statuses.values()
    assert rep.misses_by_kind.get("failed", 0) >= 1


def test_chaos_plan_validation():
    trace = tw.generate(_spec(seed=6, n=4))

    class _Router:
        replicas = []
        prefill_replicas = []

    with pytest.raises(ValueError, match="prefill tier"):
        tw.WorkloadDriver(_Router(), trace, chaos=tw.ChaosPlan(kill_step=2, tier="prefill"))
    with pytest.raises(ValueError, match="tier"):
        tw.WorkloadDriver(_Router(), trace, chaos=tw.ChaosPlan(kill_step=2, tier="gpu"))
    with pytest.raises(ValueError, match="kills"):
        tw.WorkloadDriver(_Router(), trace, chaos=tw.ChaosPlan(kill_step=2, kills=0))
