"""The port's ``ServingSession`` (split dispatch) held against the JAX
package's, request mix by request mix: the same tiny head_dim-64 Llama (one
HF state dict loaded into both, fp32, on the CPU), the same requests, and
greedy tokens that must be byte-identical, on the paged cache with and
without chunked prefill, with prefix caching, and on the contiguous cache;
synchronously and 1-ahead; under EOS and under every injected fault the
port carries (pool exhaustion, NaN logits, a NaN garbage block, dispatch
retry and its exhaustion, deadlines, the watchdog). The telemetry of both
sessions must count the same TTFT and ITL observations.

On CPU tensors the port's kernel wrappers take their plain versions (B5:
the block gather and masked softmax; B4: the same over the decode mask),
so no kernel launches here; the JAX package runs its native paths."""

import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.config import ChunkedPrefillConfig as JaxChunked
from neuronx_distributed_inference_tpu.config import TpuConfig
from neuronx_distributed_inference_tpu.models.llama import LlamaInferenceConfig as JaxLlamaConfig
from neuronx_distributed_inference_tpu.runtime import faults as jfaults
from neuronx_distributed_inference_tpu.runtime.application import TpuModelForCausalLM
from neuronx_distributed_inference_tpu.runtime.serving import ServingSession as JaxSession
from neuronx_distributed_inference_tpu.telemetry import TelemetrySession as JaxTelemetry
from neuronx_distributed_inference_tpu_torch.config import ChunkedPrefillConfig, Config
from neuronx_distributed_inference_tpu_torch.models.llama import LlamaInferenceConfig
from neuronx_distributed_inference_tpu_torch.ops import _cuda
from neuronx_distributed_inference_tpu_torch.runtime import faults as tfaults
from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM
from neuronx_distributed_inference_tpu_torch.runtime.serving import ServingSession
from neuronx_distributed_inference_tpu_torch.telemetry import TelemetrySession
from tests.conftest import make_random_hf_state_dict

HF = dict(
    model_type="llama", hidden_size=256, intermediate_size=256, num_attention_heads=4,
    num_key_value_heads=2, num_hidden_layers=2, vocab_size=128, rms_norm_eps=1e-5,
    rope_theta=10000.0, max_position_embeddings=256, hidden_act="silu", tie_word_embeddings=False,
)
BASE = dict(is_continuous_batching=True, batch_size=4, ctx_batch_size=1, seq_len=64, dtype="float32")
PAGED = dict(is_block_kv_layout=True, pa_block_size=16, pa_num_blocks=24)
CHUNKED = dict(is_chunked_prefill=True, chunked=dict(max_num_seqs=2, kernel_q_tile_size=16))
MODES = {
    "paged_chunked": {**PAGED, **CHUNKED},
    "paged": dict(PAGED),
    "contiguous": {},
    "prefix": {**PAGED, "is_prefix_caching": True},
}
PROMPTS = {
    "r1": [5, 17, 92, 41, 8, 3, 77, 21, 60, 14, 2, 90],  # 12 tokens
    "r2": list(range(30, 52)),  # 22 tokens: prefills across chunks
    "r3": [7, 7, 7],
}


def _load(c):
    for k, v in HF.items():
        setattr(c, k, v)


def _kw(mode, **extra):
    kw = {**BASE, **MODES[mode], **extra}
    chunked = kw.pop("chunked", None)
    return kw, chunked


def _jax_app(mode, sd, **extra):
    kw, chunked = _kw(mode, **extra)
    if chunked:
        kw["chunked_prefill_config"] = JaxChunked(**chunked)
    return TpuModelForCausalLM(None, JaxLlamaConfig(TpuConfig(**kw), load_config=_load)).load(state_dict=sd)


def _port_app(mode, sd, **extra):
    kw, chunked = _kw(mode, **extra)
    if chunked:
        kw["chunked_prefill_config"] = ChunkedPrefillConfig(**chunked)
    cfg = LlamaInferenceConfig(Config(**kw, device="cpu"), load_config=_load)
    return ModelForCausalLM(None, cfg).load(state_dict=sd)


@pytest.fixture(scope="module")
def sd():
    torch.set_num_threads(1)
    return make_random_hf_state_dict(JaxLlamaConfig(TpuConfig(**BASE), load_config=_load), seed=5)


@pytest.fixture(scope="module")
def apps(sd):
    """(jax app, port app) per mode, built once per module; each call hands
    them out with fresh caches."""
    built = {}

    def get(mode, **extra):
        key = (mode, tuple(sorted(extra.items())))
        if key not in built:
            built[key] = (_jax_app(mode, sd, **extra), _port_app(mode, sd, **extra))
        jax_app, port_app = built[key]
        jax_app.init_kv_cache()
        port_app.init_kv_cache()
        return jax_app, port_app

    return get


def _drive(sess, max_steps=300):
    for _ in range(max_steps):
        if not (sess.active or sess._readmit):
            break
        sess.step()
    else:
        raise AssertionError("session failed to drain within max_steps")
    return {rid: list(r.generated) for rid, r in sess.requests.items()}


def _mix(sess, n_tokens=6, eos=None):
    for rid, prompt in PROMPTS.items():
        assert sess.add_request(rid, prompt, max_new_tokens=n_tokens, eos_token_id=eos)
    return _drive(sess)


def _both(apps, mode, run, jax_kw=None, port_kw=None, **extra):
    """``run(session)`` through a fresh JAX session and a fresh port session
    on the same mode; returns both results and sessions."""
    jax_app, port_app = apps(mode, **extra)
    js = JaxSession(jax_app, **(jax_kw or {}))
    ts = ServingSession(port_app, **(port_kw or {}))
    return run(js), run(ts), js, ts


def _statuses(sess):
    return {rid: (r.status, r.fail_reason) for rid, r in sess.requests.items()}


@pytest.mark.parametrize("mode", ["paged_chunked", "paged", "contiguous"])
def test_mix_matches_jax(apps, mode):
    _cuda.reset_launch_counts()
    j, t, js, ts = _both(apps, mode, _mix)
    assert t == j
    assert all(len(v) == 6 for v in t.values())
    assert set(_cuda.launch_counts().values()) == {0}  # CPU: plain versions only


def test_staggered_arrivals_chunked_drain_match_jax(apps):
    """The serving row's traffic shape, small: two requests up front, one
    more per step(), then run_to_completion in 4-step device chunks."""
    prompts = {f"s{i}": [(7 * i + j) % 120 + 1 for j in range(10 + 3 * i)] for i in range(6)}

    def run(sess):
        order = list(prompts)
        for rid in order[:2]:
            assert sess.add_request(rid, prompts[rid], max_new_tokens=9)
        nxt, produced = 2, set()
        while nxt < len(order) or sess.active:
            produced.update(sess.step())
            if nxt < len(order) and sess.free_slots:
                assert sess.add_request(order[nxt], prompts[order[nxt]], max_new_tokens=9)
                nxt += 1
            if nxt >= len(order) and len(produced) >= len(order):
                sess.run_to_completion(decode_chunk_size=4)
                break
        return {rid: list(r.generated) for rid, r in sess.requests.items()}

    j, t, js, ts = _both(apps, "paged_chunked", run)
    assert t == j and all(len(v) == 9 for v in t.values())
    assert ts.dispatches["prefill_chunk"] > 0 and ts.dispatches["decode_steps"] > 0


@pytest.mark.parametrize("mode", ["paged_chunked", "contiguous"])
def test_sync_matches_async_and_jax(apps, mode):
    j_async, t_async, _, _ = _both(apps, mode, _mix)
    j_sync, t_sync, _, _ = _both(apps, mode, _mix, async_mode=False)
    assert t_sync == t_async == j_sync == j_async


def _eos_mid_stream(free):
    """A (request, index, token) whose token first appears at index >= 2 of
    that request's free-running stream: an EOS there stops it mid-way."""
    for rid, toks in free.items():
        for i in range(2, len(toks)):
            if toks[i] not in toks[:i]:
                return rid, i, toks[i]
    raise AssertionError(f"no mid-stream EOS candidate in {free}")


def test_eos_matches_jax(apps):
    free, _, _, _ = _both(apps, "paged_chunked", lambda s: _mix(s, n_tokens=8))
    rid, i, eos = _eos_mid_stream(free)
    j, t, js, ts = _both(apps, "paged_chunked", lambda s: _mix(s, n_tokens=8, eos=eos))
    assert t == j
    assert t[rid] == free[rid][: i + 1]


def test_eos_chunked_drain_matches_jax(apps):
    free, _, _, _ = _both(apps, "paged", lambda s: _mix(s, n_tokens=10))
    _, _, eos = _eos_mid_stream(free)

    def run(sess):
        for rid, prompt in PROMPTS.items():
            assert sess.add_request(rid, prompt, max_new_tokens=10, eos_token_id=eos)
        return sess.run_to_completion(decode_chunk_size=4)

    j, t, _, _ = _both(apps, "paged", run)
    assert t == j


def test_prefix_cache_hit_matches_jax(apps):
    """The second request shares two full blocks with the first: its
    suffix runs as a prior-KV pass (B5's path) over the attached blocks."""
    base = [((i * 37) % 100) + 2 for i in range(40)]

    def run(sess):
        assert sess.add_request("a", base, max_new_tokens=6)
        out = _drive(sess)
        res = sess.add_request("b", base[:32] + [9, 4, 7], max_new_tokens=6)
        assert res
        out.update(_drive(sess))
        return out, sess.requests["b"].prefill_pos

    (j, j_hit), (t, t_hit), _, ts = _both(apps, "prefix", run)
    assert t == j
    assert t_hit == j_hit == 35
    # "a" ran one whole-prompt prefill; "b" attached 32 cached tokens and ran
    # only its 3-token suffix as one prior-KV pass
    assert ts.dispatches["prefill"] == 1 and ts.dispatches["prefill_chunk"] == 1
    assert ts.allocator.match_index_blocks(np.asarray(base)) == 2


def test_injected_pool_exhaustion_resumes_byte_identical(apps):
    golden, _, _, _ = _both(apps, "paged_chunked", _mix)

    j, t, js, ts = _both(
        apps, "paged_chunked", _mix,
        jax_kw=dict(fault_injector=jfaults.FaultInjector().exhaust_pool(3)),
        port_kw=dict(fault_injector=tfaults.FaultInjector().exhaust_pool(3)),
    )
    assert t == j == golden
    assert [r.preemptions for r in ts.requests.values()] == [r.preemptions for r in js.requests.values()]
    assert any(r.preemptions for r in ts.requests.values())


def test_nan_logits_quarantine_spares_cobatched_rows(apps):
    clean, _, _, _ = _both(apps, "paged_chunked", _mix)
    j, t, js, ts = _both(
        apps, "paged_chunked", _mix,
        jax_kw=dict(fault_injector=jfaults.FaultInjector().nan_logits(step=5, slot=0)),
        port_kw=dict(fault_injector=tfaults.FaultInjector().nan_logits(step=5, slot=0)),
    )
    assert t == j
    assert _statuses(ts) == _statuses(js)
    assert ts.requests["r1"].fail_reason == "non_finite"
    assert t["r1"] == clean["r1"][: len(t["r1"])] and len(t["r1"]) < 6
    assert t["r2"] == clean["r2"] and t["r3"] == clean["r3"]
    assert len(ts.allocator.free) == ts.allocator.num_blocks


@pytest.mark.parametrize("mode", ["paged_chunked", "contiguous"])
def test_poison_kv_row_quarantined_and_scrubbed(apps, mode):
    """NaN over a live row's KV: only that row fails (non-finite logits ->
    sentinel -> quarantine), its KV is zero-scrubbed, co-batched rows are
    byte-identical to a clean run, as in the JAX session."""
    clean, _, _, _ = _both(apps, mode, _mix)
    j, t, js, ts = _both(
        apps, mode, _mix,
        jax_kw=dict(fault_injector=jfaults.FaultInjector().poison_kv_row(step=4, slot=1)),
        port_kw=dict(fault_injector=tfaults.FaultInjector().poison_kv_row(step=4, slot=1)),
    )
    assert t == j
    assert _statuses(ts) == _statuses(js)
    assert ts.requests["r2"].fail_reason == "non_finite"
    assert t["r1"] == clean["r1"] and t["r3"] == clean["r3"]
    k = ts.app.kv_cache.k
    live = k[:, 1:] if mode == "paged_chunked" else k[:, :-1]
    assert not torch.isnan(live).any()


def test_poisoned_garbage_block_changes_no_row(apps):
    clean, _, _, _ = _both(apps, "paged_chunked", _mix)
    j, t, _, ts = _both(
        apps, "paged_chunked", _mix,
        jax_kw=dict(fault_injector=jfaults.FaultInjector().poison_garbage_block(step=2)),
        port_kw=dict(fault_injector=(inj := tfaults.FaultInjector().poison_garbage_block(step=2))),
    )
    assert any(f["kind"] == "poison_garbage_block" for f in inj.log)
    assert t == j == clean
    assert all(r.status == "finished" for r in ts.requests.values())


def test_dispatch_retry_recovers_and_exhaustion_fails_rows(apps):
    clean, _, _, _ = _both(apps, "contiguous", _mix)
    sleeps = ([], [])
    j, t, _, ts = _both(
        apps, "contiguous", _mix,
        jax_kw=dict(fault_injector=jfaults.FaultInjector().dispatch_error(2, attempts=2), sleep_fn=sleeps[0].append),
        port_kw=dict(fault_injector=tfaults.FaultInjector().dispatch_error(2, attempts=2), sleep_fn=sleeps[1].append),
    )
    assert t == j == clean
    assert sleeps[1] == sleeps[0] == [0.02, 0.04]

    j, t, js, ts = _both(
        apps, "contiguous", _mix,
        jax_kw=dict(fault_injector=jfaults.FaultInjector().dispatch_error(2, attempts=10), sleep_fn=lambda s: None),
        port_kw=dict(fault_injector=tfaults.FaultInjector().dispatch_error(2, attempts=10), sleep_fn=lambda s: None),
    )
    assert t == j
    assert _statuses(ts) == _statuses(js)
    assert any(r.fail_reason == "dispatch_error" for r in ts.requests.values())
    assert len(ts.free_slots) == ts.num_slots


def test_deadline_matches_jax(apps):
    class Clock:
        def __init__(self):
            self.t = 0.0

        def __call__(self):
            return self.t

    def run(sess):
        assert sess.add_request("ttl", PROMPTS["r1"], max_new_tokens=30, deadline_s=1.0)
        assert sess.add_request("free", PROMPTS["r3"], max_new_tokens=6)
        sess.step()
        sess._clock.t += 5.0
        return _drive(sess)

    j, t, js, ts = _both(
        apps, "paged_chunked", run, jax_kw=dict(clock=Clock()), port_kw=dict(clock=Clock())
    )
    assert t == j
    assert ts.requests["ttl"].fail_reason == "deadline_exceeded"
    assert len(t["free"]) == 6


def test_watchdog_preempts_then_fails_loud_like_jax(apps):
    def run(sess):
        for rid, prompt in PROMPTS.items():
            assert sess.add_request(rid, prompt, max_new_tokens=6)
        err_type = jfaults.WatchdogError if isinstance(sess, JaxSession) else tfaults.WatchdogError
        with pytest.raises(err_type) as ei:
            for _ in range(40):
                sess.step()
        snap = ei.value.snapshot
        return snap["step_index"], [a["req_id"] for a in snap["active"]], snap["waiting"]

    j, t, js, ts = _both(
        apps, "paged_chunked", run,
        jax_kw=dict(fault_injector=jfaults.FaultInjector().stall(*range(1, 40))),
        port_kw=dict(fault_injector=tfaults.FaultInjector().stall(*range(1, 40))),
        watchdog_no_progress_steps=3,
    )
    assert t == j
    assert t[0] >= 6


def test_admission_verdicts_match_jax(apps):
    def run(sess):
        bad = {"oov": [5, 500], "neg": [-3, 5], "empty": [], "long": list(range(1, 100))}
        verdicts = {rid: sess.add_request(rid, p, max_new_tokens=4).reason for rid, p in bad.items()}
        verdicts["zero"] = sess.add_request("zero", [5, 6], max_new_tokens=0).reason
        for i in range(4):
            assert sess.add_request(f"f{i}", [1 + i, 2, 3], max_new_tokens=3)
        verdicts["full"] = sess.add_request("full", [9], max_new_tokens=2).reason
        return verdicts, _drive(sess)

    j, t, _, _ = _both(apps, "paged", run)
    assert t == j
    assert t[0]["full"] == "no_slot" and t[0]["oov"] == "token_id_out_of_range"


def test_telemetry_counts_match_jax(apps):
    """TTFT and ITL observation counts (and the preemption / finish
    accounting) of the port's telemetry equal the JAX session's on the same
    traffic, faults included."""
    jt, tt = JaxTelemetry(), TelemetrySession()
    j, t, js, ts = _both(
        apps, "paged_chunked", _mix,
        jax_kw=dict(telemetry=jt, fault_injector=jfaults.FaultInjector().exhaust_pool(3)),
        port_kw=dict(telemetry=tt, fault_injector=tfaults.FaultInjector().exhaust_pool(3)),
    )
    assert t == j
    jt.close()
    snap = jt.registry.snapshot()
    assert len(tt.ttft_values_s()) == len(jt.ttft_values_s()) == 3
    assert len(tt.itl_values_s()) == len(jt.itl_values_s())
    assert tt.counters["preempted"] == snap["nxdi_requests_preempted_total"]["samples"][0]["value"]
    assert tt.counters["admitted"] == snap["nxdi_requests_admitted_total"]["samples"][0]["value"]
    fin = {s["labels"]["reason"]: s["value"] for s in snap["nxdi_requests_finished_total"]["samples"]}
    assert dict(tt.finished) == fin
    p50 = tt.percentile(tt.ttft_values_s(), 0.5)
    assert p50 is not None and p50 >= 0


def test_paged_forward_matches_jax(apps):
    """The low-level paged entry, teacher-forced: a 16-token chunk pass
    (B5's route), a 4-token pass (B4's route: q_len < 8) and single-token
    steps through ``forward(..., slot_mapping=, block_table=, phase="tkg")``,
    logits against the JAX app's within 1e-4."""
    jax_app, port_app = apps("paged_chunked", output_logits=True)
    rng = np.random.RandomState(11)
    seq = rng.randint(1, 120, size=24)
    bs, mb = 16, 4  # width 64 = the one TKG bucket
    blocks = np.array([3, 8, 5, 0])
    table = np.zeros((4, mb), np.int32)
    table[2] = blocks
    seq_ids = np.array([-1, -1, 2, -1], np.int32)
    for lo, hi in ((0, 16), (16, 20), (20, 21), (21, 22)):
        n = hi - lo
        ids = np.zeros((4, n), np.int32)
        ids[2] = seq[lo:hi]
        pos = np.tile(np.arange(lo, hi, dtype=np.int32), (4, 1))
        mask = np.zeros((4, mb * bs), np.int32)
        mask[2, :hi] = 1
        slots = np.full((4, n), -1, np.int32)
        slots[2] = blocks[np.arange(lo, hi) // bs] * bs + np.arange(lo, hi) % bs
        kw = dict(attention_mask=mask, block_table=table, phase="tkg")
        if n > 1:
            kw["slot_mapping"] = slots  # decode steps derive their slots on the device
        jt, jl = jax_app.forward(ids, pos, seq_ids, **kw)
        tt, tl = port_app.forward(ids, pos, seq_ids, **kw)
        np.testing.assert_array_equal(tt[2], np.asarray(jt)[2])
        np.testing.assert_allclose(tl[2], np.asarray(jl)[2], atol=1e-4, rtol=0)
