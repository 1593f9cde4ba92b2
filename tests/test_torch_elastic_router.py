"""Elastic fleet of the port's router (``add_replica`` / ``retire_replica``)
held against the static fleet and the JAX router, on the CPU at fp32: a
replica retired mid-drain (drained, or handed back at once) and a fresh
session over the same warm app re-joining give the static fleet's tokens
and the JAX router's, sequential and threaded, also when the retiring
replica dies mid-drain; no KV block and no thread leaks, nothing new is
traced once warm, ids are never recycled, and the elastic events are
counted. The pins are the reference's ``tests/test_elastic_router.py``'s."""

import threading

import pytest

from neuronx_distributed_inference_tpu_torch.analysis import retrace_guard
from neuronx_distributed_inference_tpu_torch.runtime.router import ServingRouter
from neuronx_distributed_inference_tpu_torch.runtime.serving import ServingSession
from neuronx_distributed_inference_tpu_torch.telemetry import TelemetrySession
from tests.torch_router_common import REQS, Apps, make_router, ns, state_dict

pytestmark = pytest.mark.router


@pytest.fixture(scope="module")
def apps():
    return Apps(state_dict())


@pytest.fixture(scope="module")
def static_reference(apps):
    return make_router("port", apps.get("port", "paged")).run_to_completion()


def _elastic_drain(apps, pkg="port", threaded=False, telemetry=None, retire_after=2, kill_at=None):
    """Drain REQS, retiring the highest-id replica (drain=True) after
    ``retire_after`` steps and adding a fresh session over the same app as
    soon as the retiree finalizes; with ``kill_at`` the RETIRING replica
    dies at that step instead of draining out."""
    m = ns(pkg)
    pool = apps.get(pkg, "paged")
    sessions = [m.serving.ServingSession(a, telemetry=telemetry) for a in pool]
    kw = {} if pkg == "jax" else dict(threaded=threaded)
    router = m.router.ServingRouter(sessions, telemetry=telemetry, **kw)
    retired_id = added = retired_worker = None
    try:
        for rid, spec in REQS.items():
            assert router.add_request(rid, spec["ids"], max_new_tokens=spec["gen"])
        steps = 0
        while router.has_live_work:
            router.step()
            steps += 1
            if steps == retire_after and retired_id is None:
                victim = max(router.replicas, key=lambda h: h.replica_id)
                retired_id = victim.replica_id
                retired_worker = router._workers.get(retired_id)
                assert victim.owned
                router.retire_replica(retired_id, drain=True)
                assert all(h.replica_id != retired_id for h in router.placeable_replicas)
            if kill_at is not None and steps == kill_at:
                victim = next(h for h in router.replicas if h.replica_id == retired_id)
                assert victim.owned
                victim.kill()
            if retired_id is not None and added is None and all(h.replica_id != retired_id for h in router.replicas):
                if retired_worker is not None:
                    assert not retired_worker.is_alive()  # joined at finalize
                sess = m.serving.ServingSession(pool[-1], telemetry=telemetry)
                sessions.append(sess)
                added = router.add_replica(sess)
            assert steps < 500
        out = {rid: r.tokens for rid, r in router.requests.items()}
    finally:
        router.close()
    assert retired_id is not None and added is not None
    return out, router, retired_id, added, sessions


def _leaked_blocks(sessions):
    return sum(len(s.allocator.seq_blocks) for s in sessions)


@pytest.mark.parametrize("threaded", [False, True])
def test_retire_then_add_mid_drain_matches_static_and_jax(apps, static_reference, threaded):
    out, router, retired_id, added, sessions = _elastic_drain(apps, threaded=threaded)
    jout, jrouter, jretired, jadded, _ = _elastic_drain(apps, "jax")
    assert out == jout == static_reference
    assert (retired_id, added.replica_id) == (jretired, jadded.replica_id)
    assert all(r.status == "finished" and r.failovers == 0 for r in router.requests.values())
    assert added.replica_id not in (0, retired_id)
    assert _leaked_blocks(sessions) == 0  # the retired session's too


@pytest.mark.parametrize("threaded", [False, True])
def test_kill_retiring_replica_mid_drain(apps, static_reference, threaded):
    out, router, retired_id, _, _ = _elastic_drain(apps, threaded=threaded, kill_at=4)
    jout, jrouter, _, _, _ = _elastic_drain(apps, "jax", kill_at=4)
    assert out == jout == static_reference
    assert {r.req_id: r.failovers for r in router.requests.values()} == {
        r.req_id: r.failovers for r in jrouter.requests.values()
    }
    assert all(r.status == "finished" for r in router.requests.values())
    assert any(r.failovers for r in router.requests.values())
    assert all(h.replica_id != retired_id for h in router.replicas)


def test_retire_without_drain_requeues_immediately(apps, static_reference):
    def run(pkg):
        router = make_router(pkg, apps.get(pkg, "paged"))
        for _ in range(2):
            router.step()
        victim = router.replicas[1]
        assert victim.owned
        router.retire_replica(victim.replica_id, drain=False)
        gone = all(h.replica_id != victim.replica_id for h in router.replicas)
        out = router.run_to_completion()
        return out, gone, {r.req_id: (r.status, r.failovers) for r in router.requests.values()}

    j, t = run("jax"), run("port")
    assert t == j
    assert t[0] == static_reference and t[1]
    assert any(f for _, f in t[2].values())


def test_retire_last_placeable_replica_raises(apps):
    router = ServingRouter([ServingSession(a) for a in apps.get("port", "paged")])
    router.retire_replica(1)  # idle: finalizes at once
    assert [h.replica_id for h in router.replicas] == [0]
    with pytest.raises(ValueError, match="last placeable"):
        router.retire_replica(0)
    with pytest.raises(KeyError):
        router.retire_replica(99)


def test_add_replica_rejects_duplicate_id_and_ids_are_monotonic(apps):
    pool = apps.get("port", "paged")
    router = ServingRouter([ServingSession(a) for a in pool])
    with pytest.raises(ValueError, match="duplicate replica id"):
        router.add_replica(ServingSession(pool[0]), replica_id=0)
    h2 = router.add_replica(ServingSession(pool[0]))
    assert h2.replica_id == 2
    router.retire_replica(2)
    assert router.add_replica(ServingSession(pool[0])).replica_id == 3


def test_elastic_threaded_no_thread_leak_on_close(apps):
    baseline = threading.active_count()
    _, router, _, _, _ = _elastic_drain(apps, threaded=True)
    assert threading.active_count() == baseline and router._workers == {}
    assert all(r.status == "finished" for r in router.requests.values())


def test_elastic_zero_steady_state_traces(apps):
    """A second elastic drain traces nothing: the re-joining session reuses
    its app's programs (on a card: no graph capture, the app's cache zeroed
    in place, never reallocated)."""
    _elastic_drain(apps)  # warm
    traces = []

    def listener(tag, sealed):
        traces.append(tag)

    retrace_guard.add_trace_listener(listener)
    cache = apps.get("port", "paged")[-1].kv_cache
    try:
        out = _elastic_drain(apps, threaded=True)[0]
    finally:
        retrace_guard.remove_trace_listener(listener)
    assert traces == [] and all(len(v) > 0 for v in out.values())
    assert apps.get("port", "paged")[-1].kv_cache is cache


def test_elastic_events_recorded(apps):
    with TelemetrySession() as tel:
        _, router, _, _, _ = _elastic_drain(apps, telemetry=tel)
    snap = tel.registry.snapshot()
    events = {s["labels"]["event"]: s["value"] for s in snap["nxdi_router_elastic_total"]["samples"]}
    assert events == {"add": 1.0, "retire": 1.0, "retire_done": 1.0}
    assert all(r.failovers == 0 for r in router.requests.values())
