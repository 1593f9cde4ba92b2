"""The port's disaggregated prefill tier (``runtime/disaggregated.py``, the
router's ``_handoff``, ``ServingSession.add_prefilled_request``) held
against the JAX package's and against a single app, on the CPU at fp32:

- ``DisaggregatedPipeline``: extract on a prefill-stage app and inject into
  a decode-stage app give the monolithic app's tokens and the JAX
  pipeline's, with an fp32, a bf16, an int8 and an fp8 cache (the scales
  folded by max);
- the router with a prefill tier: every placement hands off, and the
  drain equals a single session's and the JAX router's, per policy,
  threaded, on an int8 cache; each hand-off fault (drop, latency past the
  timeout, stall, corrupt, truncate, retry exhaustion, a second exhaustion
  that kills the member) gives the JAX run's tokens, verdicts, member
  health, fault log and hand-off counters; a dead tier falls back to local
  prefill, loudly;
- the fences: config validation with the reference's messages, a paged
  decode session or a decode-stage prefill member refused, the
  speculative session's refusal, the payload validator's typed reasons.

The pins are the reference's ``tests/test_disaggregated.py``,
``test_disagg_router.py`` and the hand-off part of
``test_serving_faults.py``."""

import warnings

import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.config import TpuConfig
from neuronx_distributed_inference_tpu.models.llama import LlamaInferenceConfig as JaxLlamaConfig
from neuronx_distributed_inference_tpu.runtime import disaggregated as jdisagg
from neuronx_distributed_inference_tpu.runtime.application import TpuModelForCausalLM
from neuronx_distributed_inference_tpu_torch.config import Config
from neuronx_distributed_inference_tpu_torch.models.llama import LlamaInferenceConfig
from neuronx_distributed_inference_tpu_torch.runtime import disaggregated as tdisagg
from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM
from neuronx_distributed_inference_tpu_torch.runtime.replica import (
    HEALTH_DEAD,
    HEALTH_HEALTHY,
    PrefillReplicaHandle,
)
from neuronx_distributed_inference_tpu_torch.runtime.router import ServingRouter
from neuronx_distributed_inference_tpu_torch.runtime.serving import ServingSession, SpeculativeServingSession
from tests.torch_router_common import HF, Apps, family_counts, ns, single_session_drain, state_dict, verdicts

pytestmark = [pytest.mark.router, pytest.mark.robustness]

REQS = {
    "d1": dict(ids=[5, 17, 92, 41], gen=6),
    "d2": dict(ids=list(range(30, 52)), gen=6),
    "d3": dict(ids=[7, 7, 7], gen=5),
    "d4": dict(ids=[11, 23, 5, 99, 100, 3], gen=6),
    "d5": dict(ids=[64, 2, 90, 14], gen=5),
    "d6": dict(ids=[33, 88, 2], gen=6),
}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += float(s)


@pytest.fixture(scope="module")
def apps():
    return Apps(state_dict())


def _fleet(apps, pkg, **extra):
    """2 decode apps (full programs: local prefill needs the context
    runner) and 1 prefill-stage app, contiguous caches."""
    return apps.get(pkg, "contiguous", 2, **extra) + apps.get(pkg, "prefill_stage", 1, **extra)


@pytest.fixture(scope="module")
def reference(apps):
    return single_session_drain("port", apps.get("port", "contiguous", 1)[0], REQS)


def _drain(apps, pkg, injector=None, n_prefill=1, threaded=False, policy="least_loaded", kill_tier_after=None,
           extra=None, **router_kw):
    m = ns(pkg)
    fleet = _fleet(apps, pkg, **(extra or {}))
    clock = FakeClock()
    with m.Telemetry() as tel:
        sessions = [m.serving.ServingSession(a, telemetry=tel) for a in fleet[:2]]
        tier = [
            m.replica.PrefillReplicaHandle(fleet[2], i, fault_injector=injector(m.faults) if injector and i == 0 else None,
                                           **({"recovery_handoffs": 3} if injector else {}))
            for i in range(n_prefill)
        ]
        kw = dict(router_kw)
        if pkg == "port":
            kw["threaded"] = threaded
        with m.router.ServingRouter(
            sessions, policy=policy, telemetry=tel, prefill_replicas=tier, clock=clock, sleep_fn=clock.sleep, **kw
        ) as router:
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                for i, (rid, spec) in enumerate(REQS.items()):
                    if kill_tier_after is not None and i == kill_tier_after:
                        for ph in tier:
                            ph.kill("chaos")
                    router.add_request(rid, spec["ids"], max_new_tokens=spec["gen"])
                out = router.run_to_completion()
            snap = router.diagnostic_snapshot()
    handoff_fams = {n for n in tel.registry.snapshot() if n.startswith("nxdi_handoff_")} - {"nxdi_handoff_ms"}
    return dict(
        out=out,
        verdicts=verdicts(router),
        tier=[(p["health"], p["health_reason"], p["handoffs"], p["give_ups"]) for p in snap["prefill_tier"]],
        log=[(f.get("handoff"), f["kind"]) for f in (tier[0].faults.log if tier[0].faults else [])],
        counters=family_counts(tel.registry.snapshot(), names=handoff_fams | {"nxdi_handoff_ms"}),
        warned=sum("prefill tier is DEAD" in str(w.message) for w in rec),
        free=[len(h.session.free_slots) == h.session.num_slots for h in router.replicas],
    )


# ---------------------------------------------------------------------------
# the pipeline: one prefill stage, one decode stage
# ---------------------------------------------------------------------------

PROMPTS = np.array([[5, 17, 92, 41, 33, 88, 2, 11], [64, 3, 27, 9, 14, 0, 0, 0]])
MASK = np.array([[1] * 8, [1] * 5 + [0] * 3])


def _pipe_apps(sd, kv_dtype, pkg, dtype="float32"):
    out = {}
    for name, stage in (("mono", None), ("pre", True), ("dec", False)):
        kw = dict(batch_size=2, seq_len=64, dtype=dtype, is_prefill_stage=stage)
        if kv_dtype:
            kw["kv_cache_dtype"] = kv_dtype
        if pkg == "jax":
            cfg = JaxLlamaConfig(TpuConfig(**kw), load_config=lambda c: [setattr(c, k, v) for k, v in HF.items()])
            out[name] = TpuModelForCausalLM(None, cfg).load(state_dict=sd)
        else:
            cfg = LlamaInferenceConfig(Config(**kw, device="cpu"), load_config=lambda c: [setattr(c, k, v) for k, v in HF.items()])
            out[name] = ModelForCausalLM(None, cfg).load(state_dict=sd)
    return out


@pytest.mark.parametrize(
    "dtype,kv_dtype", [("float32", None), ("bfloat16", None), ("float32", "int8"), ("float32", "float8_e4m3")]
)
def test_pipeline_matches_monolithic_and_jax(apps, dtype, kv_dtype):
    """Byte-identical to the port's own monolithic app for every cache; to
    the JAX pipeline at fp32 compute (bf16 tokens may differ across the
    two frameworks' kernels)."""
    t = _pipe_apps(apps.sd, kv_dtype, "port", dtype)
    j = _pipe_apps(apps.sd, kv_dtype, "jax") if dtype == "float32" else None
    for eos in (None, 7):
        # fresh caches: a quantized cache's running scales outlive a call
        for a in list(t.values()) + (list(j.values()) if j else []):
            a.init_kv_cache()
        ref = t["mono"].generate(PROMPTS, MASK, max_new_tokens=12, eos_token_id=eos).sequences
        out = tdisagg.DisaggregatedPipeline(t["pre"], t["dec"]).generate(PROMPTS, MASK, max_new_tokens=12, eos_token_id=eos)
        np.testing.assert_array_equal(out.sequences, ref)
        if j is not None:
            jout = jdisagg.DisaggregatedPipeline(j["pre"], j["dec"]).generate(PROMPTS, MASK, max_new_tokens=12, eos_token_id=eos)
            np.testing.assert_array_equal(out.sequences, np.asarray(jout.sequences))
    if kv_dtype in ("int8", "float8_e4m3"):
        pre, dec = t["pre"].kv_cache.k.scale, t["dec"].kv_cache.k.scale
        assert pre.max() > 0 and bool((dec >= pre - 1e-7).all())  # folded by max, then grown
        np.testing.assert_allclose(pre.numpy(), np.asarray(j["pre"].kv_cache.k.scale), rtol=1e-5)


def test_pipeline_stage_and_format_fences(apps):
    t = _pipe_apps(apps.sd, None, "port")
    with pytest.raises(ValueError, match="prefill-stage"):
        tdisagg.DisaggregatedPipeline(t["mono"], t["dec"])
    q = _pipe_apps(apps.sd, "int8", "port")
    seq_ids = np.arange(2, dtype=np.int32)
    kv = tdisagg.extract_request_kv(q["pre"], seq_ids, upto=8)
    assert kv["quantized"] and kv["k_scale"].shape == (2, 2)
    with pytest.raises(ValueError, match="same cache format"):
        tdisagg.inject_request_kv(t["dec"], seq_ids, kv)


def test_validate_handoff_payload_reasons(apps):
    t = _pipe_apps(apps.sd, None, "port")
    tdisagg.DisaggregatedPipeline(t["pre"], t["dec"]).generate(PROMPTS, MASK, max_new_tokens=2)
    seq_ids = np.arange(2, dtype=np.int32)
    kv = tdisagg.extract_request_kv(t["pre"], seq_ids, upto=8)
    dec, v = t["dec"], tdisagg.validate_handoff_payload
    assert v(dec, kv, 2, 8) is None
    assert v(dec, {}, 2, 8) == "handoff_malformed"
    assert v(dec, kv, 1, 8) == "handoff_shape"
    assert v(dec, kv, 2, 12) == "handoff_truncated"
    assert v(dec, dict(kv, k=kv["k"][:, :, :4], v=kv["v"][:, :, :4]), 2, 8) == "handoff_truncated"
    assert v(dec, dict(kv, quantized=True), 2, 8) == "handoff_format"
    bad = kv["k"].clone()
    bad[0, 0, 0, 0, 0] = float("nan")
    assert v(dec, dict(kv, k=bad), 2, 8) == "handoff_corrupt"
    q = _pipe_apps(apps.sd, "int8", "port")
    qkv = tdisagg.extract_request_kv(q["pre"], seq_ids, upto=8)
    assert v(q["dec"], qkv, 2, 8) is None
    assert v(q["dec"], dict(qkv, k_scale=qkv["k_scale"][:1]), 2, 8) == "handoff_malformed"
    nan_scale = qkv["k_scale"].clone()
    nan_scale[0, 0] = float("nan")
    assert v(q["dec"], dict(qkv, k_scale=nan_scale), 2, 8) == "handoff_corrupt"


def test_gqa_remap_reduplicates_heads(apps):
    """A payload from a stage that replicated each KV head r times lands
    on the destination's heads (the reference's remap); scales too."""
    q = _pipe_apps(apps.sd, "int8", "port")
    seq_ids = np.arange(2, dtype=np.int32)
    tdisagg.DisaggregatedPipeline(q["pre"], q["dec"]).generate(PROMPTS, MASK, max_new_tokens=2)
    kv = tdisagg.extract_request_kv(q["pre"], seq_ids, upto=8)
    rep = dict(
        kv, gqa=tdisagg.KVLayout(kv_heads=4, kv_repeat=2), k=kv["k"].repeat_interleave(2, dim=3),
        v=kv["v"].repeat_interleave(2, dim=3), k_scale=kv["k_scale"].repeat_interleave(2, dim=1),
        v_scale=kv["v_scale"].repeat_interleave(2, dim=1),
    )
    q["dec"].init_kv_cache()
    tdisagg.inject_request_kv(q["dec"], seq_ids, rep)
    got = q["dec"].kv_cache.k.data[:, :2, :8].clone()
    q["dec"].init_kv_cache()
    tdisagg.inject_request_kv(q["dec"], seq_ids, kv)
    assert torch.equal(got, q["dec"].kv_cache.k.data[:, :2, :8])


# ---------------------------------------------------------------------------
# the router's prefill tier
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["least_loaded", "round_robin"])
def test_disagg_drain_matches_single_session_and_jax(apps, reference, policy):
    t, j = _drain(apps, "port", policy=policy), _drain(apps, "jax", policy=policy)
    assert t == j
    assert t["out"] == reference and t["tier"][0][2] == len(REQS)
    assert all(s == ("finished", None) for s in t["verdicts"].values())


def test_disagg_drain_threaded(apps, reference):
    t = _drain(apps, "port", threaded=True)
    assert t["out"] == reference and t["tier"][0][2] == len(REQS)


def test_disagg_int8_cache_matches_jax(apps):
    t, j = _drain(apps, "port", extra=dict(kv_cache_dtype="int8")), _drain(apps, "jax", extra=dict(kv_cache_dtype="int8"))
    assert t == j and t["tier"][0][2] == len(REQS)


HANDOFF_FAULTS = {
    "corrupt": dict(injector=lambda f: f.FaultInjector(0).handoff_corrupt(0)),
    "truncate": dict(injector=lambda f: f.FaultInjector(0).handoff_truncate(0)),
    "drop_recovers": dict(injector=lambda f: f.FaultInjector(0).handoff_drop(0, attempts=1), handoff_timeout_s=1.0),
    "latency_timeout": dict(injector=lambda f: f.FaultInjector(0).handoff_latency(0, 5.0), handoff_timeout_s=1.0),
    "drop_exhausts": dict(injector=lambda f: f.FaultInjector(0).handoff_drop(0, attempts=5)),
    "stall_exhausts": dict(injector=lambda f: f.FaultInjector(0).handoff_stall(0)),
    "second_exhaustion_kills": dict(injector=lambda f: f.FaultInjector(0).handoff_stall(0).handoff_stall(1)),
    "degraded_recovers": dict(injector=lambda f: f.FaultInjector(0).handoff_drop(0, attempts=5), handoff_max_retries=1),
}


@pytest.mark.parametrize("fault", sorted(HANDOFF_FAULTS))
def test_handoff_faults_match_jax(apps, reference, fault):
    kw = HANDOFF_FAULTS[fault]
    t, j = _drain(apps, "port", **kw), _drain(apps, "jax", **kw)
    assert t == j, fault
    failed = {rid: v for rid, v in t["verdicts"].items() if v[0] == "failed"}
    for rid in REQS:
        if rid not in failed:
            assert t["out"][rid] == reference[rid], (fault, rid)
    assert all(t["free"])  # every slot recycled, the victim's too
    if fault in ("drop_recovers", "latency_timeout"):
        assert not failed and t["tier"][0][0] == HEALTH_HEALTHY
    else:
        assert list(failed.values()) == [("failed", "handoff")] * len(failed) and len(failed) >= 1
    if fault == "second_exhaustion_kills":
        assert t["tier"][0][:2] == (HEALTH_DEAD, "handoff") and t["warned"] == 1
    if fault == "degraded_recovers":
        assert t["tier"][0][0] == HEALTH_HEALTHY and t["tier"][0][3] == 0


def test_handoff_failure_counter_carries_typed_reason(apps):
    for fault, reason in (("corrupt", "handoff_corrupt"), ("truncate", "handoff_truncated")):
        t = _drain(apps, "port", **HANDOFF_FAULTS[fault])
        assert t["counters"]["nxdi_handoff_failures_total"][1] == {(("reason", reason),): 1.0}


def test_prefill_tier_killed_mid_drain_falls_back_locally(apps, reference):
    t, j = _drain(apps, "port", kill_tier_after=3), _drain(apps, "jax", kill_tier_after=3)
    assert t == j
    assert t["out"] == reference and t["warned"] == 1
    assert t["counters"]["nxdi_handoff_local_prefill_total"][1][()] == 3
    assert t["counters"]["nxdi_handoff_tier_alive"][1][()] == 0


def test_handoff_metrics_recorded(apps):
    t = _drain(apps, "port")
    c = t["counters"]
    assert c["nxdi_handoff_attempts_total"][1][()] == len(REQS)
    assert c["nxdi_handoff_ms"][1][()] == len(REQS)
    assert c["nxdi_handoff_tier_health"][1] == {(("replica", "0"),): 2}
    assert c["nxdi_handoff_tier_alive"][1][()] == 1


def test_degraded_member_recovers_beside_a_healthy_one(apps):
    """A DEGRADED member keeps taking hand-offs beside a HEALTHY one (its
    only recovery clock) and recovers, as in the JAX router."""

    def run(pkg):
        m = ns(pkg)
        fleet = _fleet(apps, pkg)
        inj = m.faults.FaultInjector(0).handoff_stall(0)
        ph0 = m.replica.PrefillReplicaHandle(fleet[2], 0, fault_injector=inj, recovery_handoffs=2)
        ph1 = m.replica.PrefillReplicaHandle(fleet[2], 1)
        with m.router.ServingRouter(
            [m.serving.ServingSession(a) for a in fleet[:2]], prefill_replicas=[ph0, ph1], handoff_max_retries=0,
            sleep_fn=lambda s: None,
        ) as router:
            for rid, spec in REQS.items():
                router.add_request(rid, spec["ids"], max_new_tokens=spec["gen"])
            out = router.run_to_completion()
        return out, verdicts(router), (ph0.health, ph0.give_ups, ph0.handoffs)

    t, j = run("port"), run("jax")
    assert t == j
    assert t[2][:2] == (HEALTH_HEALTHY, 0) and t[2][2] >= 2


def test_tier_dead_fallback_rebills_deadline(apps):
    from neuronx_distributed_inference_tpu_torch.runtime.router import RouterRequest

    clock = FakeClock()
    fleet = _fleet(apps, "port")
    sessions = [ServingSession(a, clock=clock, sleep_fn=clock.sleep) for a in fleet[:2]]
    ph = PrefillReplicaHandle(fleet[2], 0)
    ph.kill()
    with ServingRouter(sessions, prefill_replicas=[ph], clock=clock, sleep_fn=clock.sleep) as router:
        rreq = RouterRequest(req_id="late", input_ids=np.asarray(REQS["d1"]["ids"], np.int32), max_new_tokens=6,
                             deadline_s=2.0, t_submit=clock())
        clock.sleep(3.0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            res = router._local_prefill(router.replicas[0], rreq, "late", 2.0)
    assert not res and res.reason == "deadline_exceeded"
    assert "late" not in router.replicas[0].session.requests


def test_disagg_snapshot_carries_tier(apps):
    t = _drain(apps, "port")
    assert t["tier"] == [(HEALTH_HEALTHY, None, len(REQS), 0)]


# ---------------------------------------------------------------------------
# fences
# ---------------------------------------------------------------------------

BAD_CONFIGS = [
    dict(serving_replicas=0),
    dict(router_policy="bogus"),
    dict(serving_replicas=2),
    dict(router_prefill_replicas=-1),
    dict(serving_replicas=2, is_continuous_batching=True, router_prefill_replicas=2),
    dict(serving_replicas=3, is_continuous_batching=True, is_block_kv_layout=True, router_prefill_replicas=1),
    dict(handoff_max_retries=-1),
    dict(handoff_timeout_s=0.0),
]


@pytest.mark.parametrize("kw", BAD_CONFIGS, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_config_validation_messages_match_reference(kw):
    with pytest.raises(ValueError) as jerr:
        TpuConfig(**kw).validate()
    with pytest.raises(ValueError) as terr:
        Config(**kw, device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_config_defaults_match_reference():
    j, t = TpuConfig(), Config(device="cpu")
    for name in ("serving_replicas", "router_policy", "router_prefill_replicas", "handoff_max_retries",
                 "handoff_timeout_s", "router_threading", "is_prefill_stage"):
        assert getattr(t, name) == getattr(j, name), name
    from neuronx_distributed_inference_tpu.config import ROUTER_POLICIES as JP
    from neuronx_distributed_inference_tpu_torch.config import ROUTER_POLICIES as TP

    assert TP == JP
    Config(serving_replicas=3, is_continuous_batching=True, router_prefill_replicas=1, handoff_max_retries=0,
           handoff_timeout_s=2.0, device="cpu")


def test_router_and_handle_fences(apps):
    paged = apps.get("port", "paged", 1)[0]
    fleet = _fleet(apps, "port")
    with pytest.raises(ValueError, match="contiguous cache lines"):
        ServingRouter([ServingSession(paged)], prefill_replicas=[PrefillReplicaHandle(fleet[2], 0)])
    dec = apps.get("port", "contiguous", 1, is_prefill_stage=False)[0]
    with pytest.raises(ValueError, match="prefill-capable"):
        PrefillReplicaHandle(dec, 0)
    with pytest.raises(NotImplementedError, match="contiguous"):
        PrefillReplicaHandle(paged, 0)
    sess = SpeculativeServingSession(fleet[0], fleet[1], speculation_length=3)
    with pytest.raises(NotImplementedError, match="speculative"):
        sess.add_prefilled_request("x", [1, 2, 3], {}, 5)
    with pytest.raises(NotImplementedError, match="speculative"):
        ServingRouter([sess], prefill_replicas=[PrefillReplicaHandle(fleet[2], 0)])
    with pytest.raises(ValueError, match="paged cache is not supported"):
        ServingSession(paged).add_prefilled_request("x", [1, 2], {}, 3)


def test_windowed_long_prompt_hands_off(apps):
    """A prompt longer than one context program hands off through the
    prefill member's windowed prefill (window 0 through the context
    program, the rest as multi-token passes on its line 0), and decodes as
    the single session's own windowed admission does, and as the JAX
    router does."""
    reqs = {"w1": dict(ids=[(7 * i + 3) % 118 for i in range(40)], gen=5), "w2": dict(ids=[5, 17, 92, 41], gen=5)}
    extra = dict(max_context_length=32, context_encoding_buckets=[32], token_generation_buckets=[64])

    def run(pkg):
        m = ns(pkg)
        fleet = apps.get(pkg, "contiguous", 2, **extra) + apps.get(pkg, "prefill_stage", 1, **extra)
        ref = single_session_drain(pkg, fleet[0], reqs)
        ph = m.replica.PrefillReplicaHandle(fleet[2], 0)
        with m.router.ServingRouter([m.serving.ServingSession(a) for a in fleet[:2]], prefill_replicas=[ph]) as router:
            for rid, spec in reqs.items():
                assert router.add_request(rid, spec["ids"], max_new_tokens=spec["gen"])
            out = router.run_to_completion()
        return ref, out, ph.handoffs

    t, j = run("port"), run("jax")
    assert t == j
    assert t[0] == t[1] and t[2] == len(reqs)
