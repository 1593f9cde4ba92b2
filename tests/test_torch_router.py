"""The port's multi-replica router (``runtime/router.py``,
``runtime/replica.py``) held against the JAX package's, on the CPU at fp32:
two replica apps of each package loaded from one HF state dict, the
reference's request set, and greedy tokens that must be byte-identical to
the JAX ``ServingRouter``'s and to a single session's, for each placement
policy, through a replica killed mid-drain, a watchdog death, dispatch
exhaustion (one and two give-ups), NaN quarantine and pool-exhaustion
churn; with the same typed verdicts, FIFO head-of-line placement and
router metric family. The pins are the reference's
``tests/test_router.py``'s."""

import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.modules.block_kvcache import PrefixCachingAllocator as JaxPrefixAlloc
from neuronx_distributed_inference_tpu_torch.modules.block_kvcache import PrefixCachingAllocator
from neuronx_distributed_inference_tpu_torch.runtime.replica import (
    HEALTH_DEAD,
    HEALTH_DEGRADED,
    HEALTH_HEALTHY,
    ReplicaHandle,
)
from neuronx_distributed_inference_tpu_torch.runtime.router import (
    PLACEMENT_POLICIES,
    ServingRouter,
    partition_devices,
)
from neuronx_distributed_inference_tpu_torch.runtime.serving import AdmissionResult, ServingSession
from neuronx_distributed_inference_tpu_torch.telemetry import TelemetrySession
from tests.torch_router_common import (
    Apps,
    drain,
    family_counts,
    make_router,
    ns,
    single_session_drain,
    state_dict,
    verdicts,
)

pytestmark = pytest.mark.router


@pytest.fixture(scope="module")
def apps():
    return Apps(state_dict())


@pytest.fixture(scope="module")
def reference(apps):
    ref = single_session_drain("port", apps.get("port", "paged", 1)[0])
    assert ref == single_session_drain("jax", apps.get("jax", "paged", 1)[0])
    return ref


def _both(run):
    return run("jax"), run("port")


# ---------------------------------------------------------------------------
# byte identity: N replicas == 1 session == the JAX router
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["least_loaded", "round_robin", "cache_aware"])
def test_router_drain_matches_jax_and_single_session(apps, reference, policy):
    def run(pkg):
        router = make_router(pkg, apps.get(pkg, "paged"), policy=policy)
        out = router.run_to_completion()
        return out, [r.replica for r in router.requests.values()], [h.tokens_served for h in router.replicas]

    (j, j_place, j_served), (t, t_place, t_served) = _both(run)
    assert t == j == reference
    assert t_place == j_place and t_served == j_served
    assert all(n > 0 for n in t_served)


def test_replica_death_mid_drain_failover_byte_identical(apps, reference):
    """Kill replica 0 after three steps: its in-flight requests re-queue
    ahead of new arrivals onto the survivor and resume from their committed
    tokens, byte-identically, as in the JAX router."""

    def run(pkg):
        m = ns(pkg)
        with m.Telemetry() as tel:
            router = make_router(pkg, apps.get(pkg, "paged"), telemetry=tel)
            for _ in range(3):
                router.step()
            victim = router.replicas[0]
            assert victim.owned  # the kill interrupts real work
            victim.kill()
            out = router.run_to_completion()
        snap = tel.registry.snapshot()
        fo = sum(s["value"] for s in snap["nxdi_router_failovers_total"]["samples"])
        healths = {s["labels"]["replica"]: s["value"] for s in snap["nxdi_router_replica_health"]["samples"]}
        return out, {r.req_id: r.failovers for r in router.requests.values()}, fo, healths, victim.health

    j, t = _both(run)
    assert t == j
    out, failovers, fo, healths, health = t
    assert out == reference and health == HEALTH_DEAD
    assert fo == sum(failovers.values()) > 0
    assert healths["0"] == 0 and healths["1"] == 2


def test_watchdog_death_fails_over_not_raises(apps, reference):
    """A WatchdogError on replica 0 (every step stalled) kills only that
    replica; its requests fail over byte-identically."""

    def run(pkg):
        pool = apps.get(pkg, "paged")
        cfgs = [a.config.tpu_config if pkg == "jax" else a.config.torch_config for a in pool]
        for c in cfgs:
            c.watchdog_no_progress_steps = 2
        try:
            inj = ns(pkg).faults.FaultInjector().stall(*range(1, 40))
            router = make_router(pkg, pool, injectors=[inj, None])
            out = router.run_to_completion()
        finally:
            for c in cfgs:
                c.watchdog_no_progress_steps = 256
        h = router.replicas[0]
        return out, h.health, h.health_reason, h.watchdog_error is not None

    j, t = _both(run)
    assert t == j == (reference, HEALTH_DEAD, "watchdog", True)


@pytest.mark.parametrize(
    "plan",
    [
        # the in-flight rows' give-up may be seen twice (a prefill and a
        # decode dispatch at one step): degraded or dead, as in JAX
        ("one_give_up", lambda f: f.FaultInjector().dispatch_error(3, attempts=5), (HEALTH_DEGRADED, HEALTH_DEAD)),
        (
            "two_give_ups",
            lambda f: f.FaultInjector().dispatch_error(2, attempts=5).dispatch_error(6, attempts=5),
            (HEALTH_DEAD,),
        ),
    ],
    ids=lambda p: p[0],
)
def test_dispatch_exhaustion_degrades_then_kills(apps, reference, plan):
    """A dispatch-retry exhaustion on replica 0 fails its in-flight rows at
    the session; the router degrades the replica (a second one kills it)
    and fails the requests over, byte-identically."""
    _, make, want = plan

    def run(pkg):
        inj = make(ns(pkg).faults)
        router = make_router(pkg, apps.get(pkg, "paged"), injectors=[inj, None])
        out = router.run_to_completion()
        h = router.replicas[0]
        return out, h.health, h.health_reason, verdicts(router), {r.req_id: r.failovers for r in router.requests.values()}

    j, t = _both(run)
    assert t == j
    out, health, reason, v, failovers = t
    assert out == reference and health in want and reason == "dispatch_error"
    assert any(failovers.values()) and all(s == ("finished", None) for s in v.values())


def test_nan_quarantine_verdict_stands(apps):
    """A non-finite row fails FAILED(non_finite) at its replica and is NOT
    failed over (re-running poisoned input elsewhere would poison another
    replica); the rest drain as in the JAX router."""

    def run(pkg):
        inj = ns(pkg).faults.FaultInjector().nan_logits(4, 0)
        router = make_router(pkg, apps.get(pkg, "paged"), injectors=[inj, None])
        return router.run_to_completion(), verdicts(router)

    j, t = _both(run)
    assert t == j
    assert ("failed", "non_finite") in t[1].values()


def test_degraded_replica_recovers_after_clean_steps(apps):
    """DEGRADED -> HEALTHY after ``recovery_steps`` clean steps; a DEGRADED
    replica is placed on only when no HEALTHY one exists."""
    pool = apps.get("port", "paged")
    handles = [ReplicaHandle(ServingSession(a), i, recovery_steps=2) for i, a in enumerate(pool)]
    router = ServingRouter(handles)
    handles[0].note_give_up()
    assert handles[0].health == HEALTH_DEGRADED
    assert router.add_request("a", [5, 6, 7], max_new_tokens=3)
    assert router.requests["a"].replica == 1
    router.run_to_completion()
    assert handles[0].health == HEALTH_HEALTHY


# ---------------------------------------------------------------------------
# placement policies
# ---------------------------------------------------------------------------


def test_least_loaded_balances_skewed_mix(apps):
    def run(pkg):
        pool = apps.get(pkg, "paged")
        sessions = [ns(pkg).serving.ServingSession(a) for a in pool]
        for i in range(3):
            assert sessions[0].add_request(f"bg{i}", [9, 9, 9, 9], max_new_tokens=12)
        router = ns(pkg).router.ServingRouter(sessions, policy="least_loaded")
        for i in range(3):
            assert router.add_request(f"fresh{i}", [4 + i, 5, 6], max_new_tokens=4)
        placed = [router.requests[f"fresh{i}"].replica for i in range(3)]
        occ = [h.occupancy for h in router.replicas]
        return placed, occ, router.run_to_completion()

    j, t = _both(run)
    assert t == j
    assert t[0] == [1, 1, 1] and max(t[1]) - min(t[1]) <= 1


def test_least_loaded_acceptance_ewma_concentrates_spec_traffic(apps):
    pool = apps.get("port", "paged")
    sessions = [ServingSession(a) for a in pool]
    sessions[0].acceptance_ewma = 0.15
    sessions[1].acceptance_ewma = 0.90
    router = ServingRouter(sessions, policy="least_loaded")
    assert router.add_request("spec0", [4, 5, 6], max_new_tokens=4)
    assert router.requests["spec0"].replica == 1  # equal load: acceptance decides
    for i in range(3):
        assert sessions[1].add_request(f"busy{i}", [9, 9, 9], max_new_tokens=8)
    assert router.add_request("spec1", [7, 5, 6], max_new_tokens=4)
    assert router.requests["spec1"].replica == 0  # occupancy dominates
    router.run_to_completion()


def test_round_robin_cycles_replicas(apps):
    router = ServingRouter([ServingSession(a) for a in apps.get("port", "paged")], policy="round_robin")
    for i in range(4):
        assert router.add_request(f"p{i}", [3 + i, 4, 5], max_new_tokens=2)
    assert [router.requests[f"p{i}"].replica for i in range(4)] == [0, 1, 0, 1]
    router.run_to_completion()


def test_match_index_blocks_is_read_only():
    """cache_aware's affinity score: a longest-chain query of the prefix
    index that moves no allocator state, as the JAX allocator answers."""
    tokens = np.arange(10, dtype=np.int32)
    probes = [tokens, tokens[:4], np.asarray([9, 9, 9, 9]), np.concatenate([tokens[:8], [7, 7, 7, 7]])]
    answers = []
    for cls in (PrefixCachingAllocator, JaxPrefixAlloc):
        alloc = cls(8, 4)
        alloc.alloc_seq(0, 10)
        alloc.commit_seq(0, tokens)
        before = (list(alloc.free), dict(alloc.refcount), dict(alloc.seq_blocks))
        answers.append([alloc.match_index_blocks(p) for p in probes])
        assert (list(alloc.free), dict(alloc.refcount), dict(alloc.seq_blocks)) == before
    assert answers[0] == answers[1] == [2, 1, 0, 2]


def test_cache_aware_prefix_affinity_colocates_tenants(apps):
    """Same-tenant requests follow their cached prefix even when load order
    prefers the other replica; an unseen prefix falls back to load order.
    The same placements as the JAX router."""

    def run(pkg):
        pool = apps.get(pkg, "prefix")
        router = ns(pkg).router.ServingRouter([ns(pkg).serving.ServingSession(a) for a in pool], policy="cache_aware")
        shared = list(range(40, 72))  # two full blocks
        assert router.add_request("c1", shared + [1, 2], max_new_tokens=2)
        home = router.requests["c1"].replica
        router.run_to_completion()
        assert router.add_request("c2", shared + [3], max_new_tokens=2)
        assert router.add_request("c3", shared + [4, 5], max_new_tokens=2)
        occ = {h.replica_id: h.occupancy for h in router.replicas}
        assert router.add_request("cold", list(range(80, 112)) + [6], max_new_tokens=2)
        placed = {rid: r.replica for rid, r in router.requests.items()}
        return home, placed, occ, router.run_to_completion()

    j, t = _both(run)
    assert t == j
    home, placed, occ, _ = t
    assert placed["c2"] == placed["c3"] == home and placed["cold"] == 1 - home
    assert occ[home] > occ[1 - home]


def test_policy_registry_and_validation(apps):
    assert set(PLACEMENT_POLICIES) == {"round_robin", "least_loaded", "cache_aware"}
    with pytest.raises(ValueError, match="unknown router policy"):
        ServingRouter([ServingSession(apps.get("port", "paged", 1)[0])], policy="bogus")
    with pytest.raises(ValueError, match="at least one replica"):
        ServingRouter([])
    sess = [ServingSession(a) for a in apps.get("port", "paged")]
    with pytest.raises(ValueError, match="duplicate replica ids"):
        ServingRouter([ReplicaHandle(sess[0], 3), ReplicaHandle(sess[1], 3)])


def test_partition_devices():
    cpu = torch.device("cpu")
    assert partition_devices(2, [cpu]) == [[cpu], [cpu]]
    devs = [torch.device("cuda", i) for i in range(4)]
    assert partition_devices(2, devs) == [devs[:2], devs[2:]]
    assert partition_devices(3, devs[:2]) == [[devs[0]], [devs[1]], [devs[0]]]
    with pytest.raises(ValueError, match="n_replicas"):
        partition_devices(0, [cpu])


# ---------------------------------------------------------------------------
# starvation freedom, admission, outage
# ---------------------------------------------------------------------------


def test_starvation_freedom_under_pool_churn(apps, reference):
    """Seeded pool-exhaustion churn on both replicas: every request still
    finishes, byte-identically (preempted requests re-queue ahead of new
    arrivals), with the JAX router's fault log."""

    def run(pkg):
        f = ns(pkg).faults
        injectors = [
            f.FaultInjector(seed=1).random_schedule(30, 0.3, kinds=("exhaust_pool",)),
            f.FaultInjector(seed=2).random_schedule(30, 0.3, kinds=("exhaust_pool",)),
        ]
        router = make_router(pkg, apps.get(pkg, "paged"), injectors=injectors)
        return router.run_to_completion(), verdicts(router), [i.log for i in injectors]

    j, t = _both(run)
    assert t == j
    assert t[0] == reference and any(t[2])


def test_fifo_head_of_line_is_never_overtaken(apps):
    """A queue head that fits nowhere waits; a later, smaller arrival does
    not overtake it (aging), and both finish as in the JAX router."""

    def run(pkg):
        pool = apps.get(pkg, "paged")
        router = ns(pkg).router.ServingRouter([ns(pkg).serving.ServingSession(a) for a in pool])
        order = []
        for i in range(10):  # 4 slots a replica: the last two queue
            assert router.add_request(f"q{i}", [3 + i, 4, 5, 6], max_new_tokens=4)
        queued = [r.req_id for r in router.pending]
        while router.has_live_work:
            before = {rid for rid, r in router.requests.items() if r.replica is not None}
            router.step()
            order += sorted(rid for rid, r in router.requests.items() if r.replica is not None and rid not in before)
        return queued, order, {rid: r.tokens for rid, r in router.requests.items()}

    j, t = _both(run)
    assert t == j
    queued, order, _ = t
    assert queued and order[: len(queued)] == queued


def test_router_admission_typed_verdicts(apps):
    def run(pkg):
        pool = apps.get(pkg, "paged")
        router = ns(pkg).router.ServingRouter([ns(pkg).serving.ServingSession(a) for a in pool])
        vocab = pool[0].config.vocab_size
        res = [
            router.add_request("bad_id", [1, vocab + 5], max_new_tokens=4),
            router.add_request("empty", [], max_new_tokens=4),
            router.add_request("neg", [3], max_new_tokens=0),
            router.add_request("long", [1] * 200),
            router.add_request("ok", [5, 6], max_new_tokens=2),
            router.add_request("ok", [5, 6]),
            router.add_request("ok2", [5, 6]),
        ]
        assert all(isinstance(r, ns(pkg).serving.AdmissionResult) for r in res)
        out = router.run_to_completion()
        for h in router.replicas:
            h.kill()
        res.append(router.add_request("late", [5, 6]))
        return [(bool(r), r.reason) for r in res], sorted(router.rejected), out

    j, t = _both(run)
    assert t == j
    assert t[0] == [
        (False, "token_id_out_of_range"), (False, "empty_prompt"), (False, "invalid_max_new_tokens"),
        (False, "prompt_too_long"), (True, None), (False, "duplicate_req_id"), (True, None),
        (False, "no_replicas"),
    ]
    assert isinstance(AdmissionResult(False, "x"), AdmissionResult)


def test_never_fits_request_fails_typed_not_wedged(apps):
    """A prompt that passes validation but never gets KV blocks (no chunked
    prefill, a pool smaller than the prompt) is a typed refusal up front
    and a typed terminal when queued, never a wedge."""

    def run(pkg):
        (app,) = apps.get(pkg, "paged", 1, pa_num_blocks=3, is_chunked_prefill=False, chunked=None)
        router = ns(pkg).router.ServingRouter([ns(pkg).serving.ServingSession(app)])
        big = [1] * 50
        first = router.add_request("big", big, max_new_tokens=4)
        assert router.add_request("ok", [5, 6, 7], max_new_tokens=3)
        assert router.add_request("big2", big, max_new_tokens=4)
        out = router.run_to_completion()
        return (bool(first), first.reason), "big" in router.requests, out, verdicts(router)

    j, t = _both(run)
    assert t == j
    assert t[0] == (False, "never_fits") and not t[1]
    assert t[3]["big2"] == ("failed", "never_fits") and len(t[2]["ok"]) == 3


def test_total_outage_fails_queued_requests_typed(apps):
    def run(pkg):
        router = make_router(pkg, apps.get(pkg, "paged"))
        router.step()
        for h in router.replicas:
            h.kill()
        return router.run_to_completion(), verdicts(router)

    j, t = _both(run)
    assert t == j
    failed = [r for r in t[1].values() if r[0] == "failed"]
    assert failed and {r[1] for r in failed} <= {"no_replicas", "killed", "dispatch_error"}


# ---------------------------------------------------------------------------
# observability
# ---------------------------------------------------------------------------


def test_router_metric_family_matches_jax(apps, reference):
    """The nxdi_router_* family after a clean drain: placements by policy
    and reason, per-replica gauges, the spread histogram once per step, no
    failover; every count equal to the JAX router's."""

    def run(pkg):
        with ns(pkg).Telemetry() as tel:
            router = make_router(pkg, apps.get(pkg, "paged"), telemetry=tel)
            out = router.run_to_completion()
        snap = tel.registry.snapshot()
        fams = family_counts(snap, names={n for n in snap if n.startswith("nxdi_router_")} - {"nxdi_router_step_ms"})
        return out, fams, router._step_index, sum(r.placements for r in router.requests.values())

    j, t = _both(run)
    assert t == j
    out, fams, steps, placements = t
    assert out == reference
    assert sum(fams["nxdi_router_placements_total"][1].values()) == placements
    assert fams["nxdi_router_occupancy_spread"][1][()] == steps > 0
    assert set(fams["nxdi_router_replica_health"][1].values()) == {2}
    assert not fams["nxdi_router_failovers_total"][1]


def test_diagnostic_snapshot_shape(apps):
    router = make_router("port", apps.get("port", "paged"), {"d1": dict(ids=[5, 6, 7], gen=3)})
    router.step()
    snap = router.diagnostic_snapshot()
    assert snap["policy"] == "least_loaded" and len(snap["replicas"]) == 2
    for r in snap["replicas"]:
        assert {"replica_id", "health", "occupancy", "tokens_served", "ewma_step_ms", "kv_free_bytes"} <= set(r)
    assert snap["prefill_tier"] == [] and drain(router)["d1"]


def test_telemetry_router_session_labels(apps):
    """A router-managed session stamps its replica id on its step timeline
    (the ragged step's host / fetch-wait phase spans)."""
    tel = TelemetrySession()
    router = make_router("port", apps.get("port", "paged"), telemetry=tel)
    assert [h.session._tel_replica for h in router.replicas] == [0, 1]
    router.run_to_completion()
    tracks = {s.track for s in tel.spans.snapshot()[0]}
    assert {"replica:0", "replica:1"} <= tracks
