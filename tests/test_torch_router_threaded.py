"""Thread-per-replica stepping of the port's router
(``Config.router_threading``) held against sequential stepping and the JAX
router, on the CPU at fp32: a threaded drain gives the same tokens and
verdicts as a sequential one and as the JAX ``ServingRouter``, clean and
under each fault plan (a replica killed mid-drain, a stall that trips the
watchdog, NaN quarantine, pool-exhaustion churn, dispatch exhaustion). The
pool is persistent and joins on ``close``; a worker's exception completes
the barrier before it is raised again; nothing new is traced in a warm
threaded drain; the overlap telemetry is recorded. The pins are the
reference's ``tests/test_router_threaded.py``'s."""

import sys
import threading
import time

import pytest

from neuronx_distributed_inference_tpu_torch.analysis import retrace_guard
from neuronx_distributed_inference_tpu_torch.ops import _cuda
from neuronx_distributed_inference_tpu_torch.runtime.router import ServingRouter
from neuronx_distributed_inference_tpu_torch.runtime.serving import ServingSession
from neuronx_distributed_inference_tpu_torch.telemetry import TelemetrySession
from tests.torch_router_common import REQS, Apps, make_router, ns, single_session_drain, state_dict, verdicts

pytestmark = pytest.mark.router


@pytest.fixture(scope="module")
def apps():
    return Apps(state_dict())


@pytest.fixture(scope="module")
def reference(apps):
    return single_session_drain("port", apps.get("port", "paged", 1)[0])


def _run(apps, pkg, threaded, injectors=None, policy="least_loaded", telemetry=None, kill_at=None, watchdog=None):
    pool = apps.get(pkg, "paged")
    cfgs = [a.config.tpu_config if pkg == "jax" else a.config.torch_config for a in pool]
    if watchdog is not None:
        for c in cfgs:
            c.watchdog_no_progress_steps = watchdog
    try:
        kw = {} if pkg == "jax" else dict(threaded=threaded)
        router = make_router(
            pkg, pool, policy=policy, telemetry=telemetry,
            injectors=injectors(ns(pkg).faults) if injectors else None, **kw,
        )
        with router:
            if kill_at is not None:
                for _ in range(kill_at):
                    router.step()
                assert router.replicas[0].owned
                router.replicas[0].kill()
            out = router.run_to_completion()
    finally:
        for c in cfgs:
            c.watchdog_no_progress_steps = 256
    return out, verdicts(router), [(h.health, h.health_reason) for h in router.replicas], router


@pytest.mark.parametrize("policy", ["least_loaded", "round_robin"])
def test_threaded_drain_matches_sequential_jax_and_single_session(apps, reference, policy):
    thr = _run(apps, "port", True, policy=policy)
    seq = _run(apps, "port", False, policy=policy)
    jax = _run(apps, "jax", False, policy=policy)
    assert thr[:3] == seq[:3] == jax[:3]
    assert thr[0] == reference
    assert thr[3].threaded and not thr[3]._workers  # closed by the context manager


FAULT_PLANS = {
    "kill": dict(kill_at=3),
    "stall_watchdog": dict(injectors=lambda f: [f.FaultInjector().stall(*range(1, 40)), None], watchdog=2),
    "nan_quarantine": dict(injectors=lambda f: [f.FaultInjector().nan_logits(4, 0), None]),
    "pool_exhaustion": dict(
        injectors=lambda f: [
            f.FaultInjector(seed=1).random_schedule(30, 0.3, kinds=("exhaust_pool",)),
            f.FaultInjector(seed=2).random_schedule(30, 0.3, kinds=("exhaust_pool",)),
        ]
    ),
    "dispatch_exhaustion": dict(injectors=lambda f: [f.FaultInjector().dispatch_error(3, attempts=5), None]),
}


@pytest.mark.robustness
@pytest.mark.parametrize("plan", sorted(FAULT_PLANS))
def test_fault_plans_threaded_match_sequential_and_jax(apps, plan):
    kw = FAULT_PLANS[plan]
    thr = _run(apps, "port", True, **kw)
    seq = _run(apps, "port", False, **kw)
    jax = _run(apps, "jax", False, **kw)
    assert thr[:3] == seq[:3] == jax[:3], plan
    if plan in ("kill", "stall_watchdog"):
        assert thr[2][0][0] == "dead"


def test_config_knob_builds_pool_and_default_is_off(apps):
    pool = apps.get("port", "paged")
    router = ServingRouter([ServingSession(a) for a in pool])
    assert not router.threaded and not router._workers
    router.close()  # a no-op
    tc = pool[0].config.torch_config
    tc.router_threading = True
    try:
        router = ServingRouter([ServingSession(a) for a in pool])
        assert router.threaded and set(router._workers) == {0, 1}
        assert all(w.is_alive() for w in router._workers.values())
    finally:
        tc.router_threading = False
        router.close()


def test_thread_pool_is_persistent_and_joins_on_close(apps):
    baseline = threading.active_count()
    router = ServingRouter([ServingSession(a) for a in apps.get("port", "paged")], threaded=True)
    workers = list(router._workers.values())
    assert len(workers) == 2 and all(w.is_alive() for w in workers)
    assert all(w.name.startswith("nxdi-replica-step-") for w in workers)
    assert router.add_request("p1", [5, 6, 7], max_new_tokens=3)
    router.step()
    assert list(router._workers.values()) == workers  # the same threads
    router.run_to_completion()
    router.close()
    for w in workers:
        w.join(timeout=5)
        assert not w.is_alive()
    assert threading.active_count() == baseline
    router.close()  # idempotent
    assert router.add_request("p2", [5, 6], max_new_tokens=2)  # steps sequentially now
    router.run_to_completion()
    assert router.requests["p2"].status == "finished"


def test_worker_exception_completes_barrier_before_reraise(apps):
    """A worker's exception re-raises on the router thread only after every
    sibling worker has parked; the next step pairs no stale job and loses
    or duplicates no token."""
    router = ServingRouter([ServingSession(a) for a in apps.get("port", "paged")], threaded=True)
    try:
        for rid, spec in list(REQS.items())[:4]:
            assert router.add_request(rid, spec["ids"], max_new_tokens=spec["gen"])
        router.step()

        class Boom(RuntimeError):
            pass

        h0, h1 = router.replicas
        real0, real1 = h0.step, h1.step

        def exploding_step():
            raise Boom("injected programming error")

        def slow_step():
            time.sleep(0.05)  # worker 1 still runs when worker 0 raises
            return real1()

        h0.step, h1.step = exploding_step, slow_step
        try:
            with pytest.raises(Boom):
                router.step()
        finally:
            h0.step, h1.step = real0, real1
        for w in router._workers.values():
            assert w._done.is_set() or not w._go.is_set()
        before = sum(h.session._committed_total for h in router.replicas)
        router.step()
        assert sum(h.session._committed_total for h in router.replicas) > before
        out = router.run_to_completion()
        assert all(r.status == "finished" for r in router.requests.values())
        for rid, spec in list(REQS.items())[:4]:
            assert len(out[rid]) == spec["gen"], (rid, out[rid])
    finally:
        router.close()


def test_zero_steady_state_traces_threaded(apps):
    """After one warm drain, a threaded drain builds no new program (the
    retrace guard's listeners see no trace; on a card that is: no graph
    capture on a worker thread), with telemetry on or off."""
    _run(apps, "port", True)  # warm every program
    traces, lock = [], threading.Lock()

    def on_trace(tag, sealed):
        with lock:
            traces.append(tag)

    retrace_guard.add_trace_listener(on_trace)
    try:
        with TelemetrySession() as tel:
            out_tel = _run(apps, "port", True, telemetry=tel)[0]
        out_plain = _run(apps, "port", True)[0]
    finally:
        retrace_guard.remove_trace_listener(on_trace)
    assert traces == [] and out_tel == out_plain


def test_threaded_overlap_telemetry_recorded(apps):
    """nxdi_replica_step_ms per replica, nxdi_router_step_ms once per
    router step, and the overlap gauge in [0, 1)."""
    with TelemetrySession() as tel:
        router = _run(apps, "port", True, telemetry=tel)[3]
    snap = tel.registry.snapshot()
    assert {s["labels"]["replica"] for s in snap["nxdi_replica_step_ms"]["samples"]} == {"0", "1"}
    assert snap["nxdi_router_step_ms"]["samples"][0]["count"] == router._step_index > 0
    assert 0.0 <= snap["nxdi_router_step_overlap_frac"]["samples"][0]["value"] < 1.0


def test_threaded_span_tree_equals_sequential(apps):
    """The causal span tree (ids, names, parents, tracks) of a threaded
    drain equals the sequential drain's: every span id is content-derived."""

    def tree(threaded):
        with TelemetrySession() as tel:
            _run(apps, "port", threaded, telemetry=tel)
        return {k: v[:4] for k, v in tel.span_tree().items()}

    assert tree(True) == tree(False)


def test_launch_counts_exact_under_threads():
    """Replica threads count kernel launches (a graph replay adds its
    census) at once: with more threads than cores and a short switch
    interval, no count is lost, and a census taken meanwhile on the main
    thread records only its own."""
    n_threads, n_ops = 16, 2000
    barrier = threading.Barrier(n_threads)
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _cuda.reset_launch_counts()

        def worker():
            barrier.wait()
            for _ in range(n_ops):
                _cuda.count("paged_decode_attention")
                _cuda.add_counts({"paged_flash_attention": 1, "moe_dense": 2})

        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        counts = {**_cuda.launch_counts(), **_cuda.route_counts()}
        assert counts["paged_decode_attention"] == counts["paged_flash_attention"] == n_threads * n_ops
        assert counts["moe_dense"] == 2 * n_threads * n_ops
    finally:
        sys.setswitchinterval(prev)
        _cuda.reset_launch_counts()

