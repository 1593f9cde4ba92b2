"""The port's ragged mixed serving step held against the JAX package's: the
same tiny head_dim-64 Llama (one HF state dict loaded into both, fp32, on
the CPU), the same requests, and greedy tokens that must be byte-identical,
pipelined (``serving_ragged_async``, the default under ``async_mode``) and
synchronous, with and without chunked prefill, and against the split path
of both packages. The pins follow the reference's
(tests/test_ragged_serving.py and the ragged cases of
tests/test_serving_faults.py): one mixed dispatch per step, one consumed
fetch per pipelined step, tokens one step late, the vectorized descriptor
build, EOS, slot reuse, telemetry counts, config validation, and every
ragged fault pin (NaN quarantine, a poisoned garbage block, pool
exhaustion, dispatch retry and its exhaustion, a deadline mid-pipeline).

``mixed_forward`` itself is held against the JAX one on the same
``MixedStepInputs``, with the chained-id gather inert and live. On CPU
tensors B3's wrapper takes its plain version, so no kernel launches here."""

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
from neuronx_distributed_inference_tpu_torch.modules.block_kvcache import BlockKVCache
from neuronx_distributed_inference_tpu_torch.ops import _cuda
from neuronx_distributed_inference_tpu_torch.runtime import faults as tfaults
from neuronx_distributed_inference_tpu_torch.runtime import serving as tserving
from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM
from neuronx_distributed_inference_tpu_torch.runtime.model_runner import MixedStepRunner, SubModelRunner
from neuronx_distributed_inference_tpu_torch.runtime.serving import ServingSession
from neuronx_distributed_inference_tpu_torch.telemetry import TelemetrySession
from tests.conftest import make_random_hf_state_dict

HF = dict(
    model_type="llama", hidden_size=256, intermediate_size=256, num_attention_heads=4,
    num_key_value_heads=2, num_hidden_layers=2, vocab_size=128, rms_norm_eps=1e-5,
    rope_theta=10000.0, max_position_embeddings=256, hidden_act="silu", tie_word_embeddings=False,
)
BASE = dict(
    is_continuous_batching=True, batch_size=4, ctx_batch_size=1, seq_len=64, dtype="float32",
    is_block_kv_layout=True, pa_block_size=16, pa_num_blocks=24,
)
CHUNKED = dict(is_chunked_prefill=True, chunked=dict(max_num_seqs=2, kernel_q_tile_size=16))
MODES = {
    "split": dict(CHUNKED),
    "ragged": {**CHUNKED, "serving_ragged": True},
    "ragged_sync": {**CHUNKED, "serving_ragged": True, "serving_ragged_async": False},
    "ragged_nochunk": {"serving_ragged": True},
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
    return kw, kw.pop("chunked", None)


def _jax_app(mode, sd, **extra):
    kw, chunked = _kw(mode, **extra)
    if chunked:
        kw["chunked_prefill_config"] = JaxChunked(**chunked)
    return TpuModelForCausalLM(None, JaxLlamaConfig(TpuConfig(**kw), load_config=_load)).load(state_dict=sd)


def _port_app(mode, sd, **extra):
    kw, chunked = _kw(mode, **extra)
    if chunked:
        kw["chunked_prefill_config"] = ChunkedPrefillConfig(**chunked)
    return ModelForCausalLM(None, LlamaInferenceConfig(Config(**kw, device="cpu"), load_config=_load)).load(
        state_dict=sd
    )


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


def _mix(sess, n_tokens=6):
    for rid, prompt in PROMPTS.items():
        assert sess.add_request(rid, prompt, max_new_tokens=n_tokens)
    return _drive(sess)


def _standard_mix(sess):
    """The reference's standard mix: staggered arrivals, so a long prompt's
    chunks overlap live decode of earlier requests."""
    assert sess.add_request("r1", PROMPTS["r1"][:4], max_new_tokens=6)
    sess.step()
    assert sess.add_request("r2", PROMPTS["r2"], max_new_tokens=6)
    sess.step()
    assert sess.add_request("r3", PROMPTS["r3"], max_new_tokens=5)
    return sess.run_to_completion()


def _both(apps, mode, run, jax_kw=None, port_kw=None, **extra):
    """``run(session)`` through a fresh JAX session and a fresh port session
    on the same mode; returns both results and sessions."""
    jax_app, port_app = apps(mode, **extra)
    js = JaxSession(jax_app, **(jax_kw or {}))
    ts = ServingSession(port_app, **(port_kw or {}))
    return run(js), run(ts), js, ts


def _statuses(sess):
    return {rid: (r.status, r.fail_reason) for rid, r in sess.requests.items()}


# ---------------------------------------------------------------------------
# mixed_forward against the JAX one
# ---------------------------------------------------------------------------


def _mixed_case():
    """One mixed step over a populated pool: row 0 a 13-token chunk from
    position 10, rows 1 and 3 decode rows, row 2 inactive; NaN in block 0."""
    rng = np.random.RandomState(2)
    R, bs, width = 4, 16, 64
    pool = (rng.randn(2, 2, 25, 2, bs, 64) * 0.5).astype(np.float32)  # (k|v, L, NB+1, Hkv, bs, D)
    pool[:, :, 0] = np.nan
    bt = np.zeros((R, width // bs), np.int32)
    bt[0, :2] = [3, 7]
    bt[1, :2] = [1, 9]
    bt[3, :1] = [12]
    row_start = np.array([0, 16, 0, 32], np.int32)
    row_len = np.array([13, 1, 0, 1], np.int32)
    ctx_len = np.array([23, 31, 0, 6], np.int32)
    T = 48
    ids = rng.randint(1, 120, size=T).astype(np.int32)
    pos = np.full(T, -1, np.int32)
    pos[:13] = np.arange(10, 23)
    pos[16], pos[32] = 30, 5
    slots = np.full(T, -1, np.int32)
    for r in (0, 1, 3):
        s, n = row_start[r], row_len[r]
        p = pos[s : s + n]
        slots[s : s + n] = bt[r, p // bs] * bs + p % bs
    chain_src = np.full(T, -1, np.int32)
    chain_src[16], chain_src[32] = 1, 3
    # row 3's previous token is the non-finite sentinel: it clamps to 0
    chain_tokens = np.array([[5], [77], [9], [-1]], np.int32)
    return pool, (ids, pos, slots, row_start, row_len, ctx_len, bt, width), chain_src, chain_tokens


@pytest.mark.parametrize("chained", [False, True])
def test_mixed_forward_matches_jax(apps, chained):
    import jax.numpy as jnp

    jax_app, port_app = apps("ragged", output_logits=True)
    pool, args, chain_src, chain_tokens = _mixed_case()
    jax_app.kv_cache = type(jax_app.kv_cache)(k=jnp.asarray(pool[0]), v=jnp.asarray(pool[1]))
    port_app.kv_cache = BlockKVCache(k=torch.from_numpy(pool[0].copy()), v=torch.from_numpy(pool[1].copy()))
    jkw = dict(chain_src=chain_src, chain_tokens=chain_tokens) if chained else {}
    tkw = dict(chain_src=chain_src, chain_tokens=torch.from_numpy(chain_tokens)) if chained else {}
    jin, _ = jax_app.mixed_step_model.prepare(*args, **jkw)
    jout = jax_app.mixed_step_model(jax_app.params, jax_app.kv_cache, jin, None)
    tin, _ = port_app.mixed_step_model.prepare(*args, **tkw)
    _cuda.reset_launch_counts()
    tout = port_app.mixed_step_model(port_app.params, port_app.kv_cache, tin)
    assert _cuda.launch_counts()["ragged_paged_attention"] == 0
    np.testing.assert_array_equal(tout.tokens.numpy(), np.asarray(jout.tokens))
    live = [0, 1, 3]
    np.testing.assert_allclose(tout.logits.numpy()[live], np.asarray(jout.logits)[live], atol=1e-4, rtol=0)
    # the paged cache outside block 0: layer 0's writes within 1e-6; layer
    # 1's inputs went through a whole layer whose fp32 sums the two packages
    # order differently (~20 ulp at |K| ~ 1), so 1e-5 there
    for t, j in ((tout.cache.k, jout.cache.k), (tout.cache.v, jout.cache.v)):
        for layer, tol in ((0, 1e-6), (1, 1e-5)):
            np.testing.assert_allclose(t.numpy()[layer, 1:], np.asarray(j)[layer, 1:], atol=tol, rtol=0)
    if chained:
        # the gather is the host writing the previous tokens itself (the
        # sentinel clamped to 0) on an inert step over the same cache
        ids = args[0].copy()
        ids[16], ids[32] = 77, 0
        port_app.kv_cache = BlockKVCache(k=torch.from_numpy(pool[0].copy()), v=torch.from_numpy(pool[1].copy()))
        inert_in, _ = port_app.mixed_step_model.prepare(ids, *args[1:])
        inert = port_app.mixed_step_model(port_app.params, port_app.kv_cache, inert_in)
        np.testing.assert_array_equal(inert.tokens.numpy(), tout.tokens.numpy())
        np.testing.assert_array_equal(inert.logits.numpy(), tout.logits.numpy())


# ---------------------------------------------------------------------------
# sessions against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["ragged", "ragged_sync", "ragged_nochunk"])
def test_standard_mix_matches_jax_and_split(apps, mode):
    _cuda.reset_launch_counts()
    j, t, js, ts = _both(apps, mode, _standard_mix)
    js_split, ts_split, _, _ = _both(apps, "split", _standard_mix)
    assert t == j == ts_split == js_split
    assert all(len(v) > 0 for v in t.values())
    assert ts.dispatches["mixed_step"] > 0
    assert ts.dispatches["decode_steps"] == ts.dispatches["prefill_chunk"] == 0
    assert set(_cuda.launch_counts().values()) == {0}  # CPU: plain versions only


def test_async_vs_sync_vs_split_byte_identical(apps):
    """The reference's tentpole pin, on both packages: pipelined ragged,
    synchronous ragged and the split path give the same greedy streams on
    the staggered mix and on the all-at-once mix."""
    for run in (_standard_mix, _mix):
        outs = []
        for mode in ("ragged", "ragged_sync", "split"):
            j, t, _, _ = _both(apps, mode, run)
            outs += [j, t]
        assert all(o == outs[0] for o in outs), outs


def test_cte_admission_then_mixed_decode_matches_jax(apps):
    """Without chunked prefill a request is admitted through the context
    program (B2's route), then decodes in mixed steps (B3's)."""
    j, t, js, ts = _both(apps, "ragged_nochunk", _mix)
    split_j, split_t, _, _ = _both(apps, "split", _mix)
    assert t == j == split_t == split_j
    assert ts.dispatches["prefill"] == len(PROMPTS)
    assert ts.dispatches["mixed_step"] > 0 and ts.dispatches["decode_steps"] == 0


def test_decode_only_and_slot_reuse_match_jax(apps):
    def run(sess):
        for i in range(4):
            assert sess.add_request(f"x{i}", [1 + i, 2, 3], max_new_tokens=3)
        out = sess.run_to_completion()
        assert len(sess.free_slots) == 4
        assert sess.add_request("a", [42, 10, 11], max_new_tokens=4)
        out.update(sess.run_to_completion())
        return out

    j, t, _, _ = _both(apps, "ragged", run)
    _, golden, _, _ = _both(apps, "split", lambda s: (s.add_request("a", [42, 10, 11], max_new_tokens=4),
                                                     s.run_to_completion())[1])
    assert t == j
    assert t["a"] == golden["a"]


def test_eos_stops_early_like_jax(apps):
    _, free, _, _ = _both(apps, "split", lambda s: (s.add_request("e", [5, 6, 7], max_new_tokens=8),
                                                   s.run_to_completion())[1])
    eos = free["e"][2]

    def run(sess):
        assert sess.add_request("e", [5, 6, 7], max_new_tokens=8, eos_token_id=eos)
        out = sess.run_to_completion()
        assert len(sess.free_slots) == 4
        return out

    for mode in ("ragged", "ragged_sync"):
        j, t, _, ts = _both(apps, mode, run)
        assert t == j
        assert t["e"] == free["e"][: free["e"].index(eos) + 1]
        assert ts.requests["e"].status == "finished"


def test_async_default_follows_async_mode(apps):
    for mode, want in (("ragged", True), ("ragged_sync", False)):
        jax_app, port_app = apps(mode)
        assert ServingSession(port_app).ragged_async is want
        assert JaxSession(jax_app).ragged_async is want
    _, port_app = apps("ragged", async_mode=False)
    assert ServingSession(port_app).ragged_async is False


def test_tokens_consumed_one_step_late(apps):
    def run(sess):
        assert sess.add_request("solo", PROMPTS["r1"][:4], max_new_tokens=4)
        first = sess.step()  # dispatches the first chunk; nothing consumed
        second = sess.step()  # consumes step 1 while step 2 runs
        sess.run_to_completion()
        return first, sorted(second), list(sess.requests["solo"].generated)

    j, t, _, _ = _both(apps, "ragged", run)
    assert t == j
    assert t[0] == {} and t[1] == ["solo"] and len(t[2]) == 4


def test_one_mixed_dispatch_per_mixed_step(apps, monkeypatch):
    """A step with both prefilling and decoding requests runs as ONE mixed
    dispatch (the split path runs at least two)."""
    counts = {}
    n = {"n": 0}
    for cls in (MixedStepRunner, SubModelRunner):
        orig = cls.__call__

        def counting(self, *a, _orig=orig, **kw):
            n["n"] += 1
            return _orig(self, *a, **kw)

        monkeypatch.setattr(cls, "__call__", counting)
    for mode in ("ragged", "ragged_sync", "split"):
        _, port_app = apps(mode)
        sess = ServingSession(port_app)
        assert sess.add_request("r1", PROMPTS["r1"][:4], max_new_tokens=8)
        sess.step()
        assert sess.add_request("r2", PROMPTS["r2"], max_new_tokens=8)
        sess.step()  # r2 chunk 1 of 2
        assert sess.prefilling and sess.decoding  # genuinely mixed now
        n["n"] = 0
        sess.step()
        counts[mode] = n["n"]
    assert counts["ragged"] == counts["ragged_sync"] == 1, counts
    assert counts["split"] >= 2, counts


def test_exactly_one_consumed_fetch_per_pipelined_step(apps, monkeypatch):
    _, port_app = apps("ragged")
    sess = ServingSession(port_app)
    assert sess.ragged_async
    assert sess.add_request("a", PROMPTS["r1"], max_new_tokens=12)
    assert sess.add_request("b", PROMPTS["r3"], max_new_tokens=12)
    for _ in range(4):  # past prefill, into the pipelined decode regime
        sess.step()
    assert sess._pending is not None
    counts = {"fetch": 0, "dispatch": 0}
    wait, call = tserving._TokenFetch.wait, MixedStepRunner.__call__

    def counting_wait(self):
        counts["fetch"] += 1
        return wait(self)

    def counting_call(self, *a, **kw):
        counts["dispatch"] += 1
        return call(self, *a, **kw)

    monkeypatch.setattr(tserving._TokenFetch, "wait", counting_wait)
    monkeypatch.setattr(MixedStepRunner, "__call__", counting_call)
    for _ in range(3):
        before = dict(counts)
        assert sess.step(), "a steady-state step delivers tokens"
        assert counts["fetch"] == before["fetch"] + 1, "exactly one consumed fetch"
        assert counts["dispatch"] == before["dispatch"] + 1, "exactly one dispatch"
    sess.run_to_completion()


def test_vectorized_descriptor_build_matches_per_row_build(apps):
    from neuronx_distributed_inference_tpu_torch.modules.autobucketing import get_target_bucket

    _, port_app = apps("ragged")
    sess = ServingSession(port_app)
    assert sess.add_request("d1", PROMPTS["r1"][:4], max_new_tokens=8)
    sess.step()
    sess.step()
    assert sess.add_request("p1", PROMPTS["r2"], max_new_tokens=8)
    sess.step()
    rows = sess._schedule_mixed({})  # the allocations are idempotent here
    assert {t[1] for t in rows} == {"prefill", "decode"}, rows
    d = sess._build_mixed_descriptors(rows)

    tq = sess.mixed_runner.q_tile
    R = sess.num_slots
    row_start, row_len, ctx_len = (np.zeros(R, np.int32) for _ in range(3))
    cursor = 0
    for req, _kind, n, _p0, _c in rows:
        row_start[req.slot] = cursor
        row_len[req.slot] = n
        cursor += -(-n // tq) * tq
    ids = np.zeros(cursor, np.int32)
    positions = np.full(cursor, -1, np.int32)
    slot_mapping = np.full(cursor, -1, np.int32)
    max_ctx = 0
    for req, kind, n, p0, _c in rows:
        s = row_start[req.slot]
        if kind == "prefill":
            ids[s : s + n] = req.input_ids[p0 : p0 + n]
        else:
            ids[s] = req.last_token
        positions[s : s + n] = np.arange(p0, p0 + n)
        slot_mapping[s : s + n] = sess.allocator.slot_mapping(req.slot, np.arange(p0, p0 + n))
        ctx_len[req.slot] = p0 + n
        max_ctx = max(max_ctx, p0 + n)
    assert d["T"] == cursor
    assert d["width"] == get_target_bucket(port_app.token_generation_model.buckets, max_ctx)
    for name, want in (("row_start", row_start), ("row_len", row_len), ("ctx_len", ctx_len), ("ids", ids),
                       ("positions", positions), ("slot_mapping", slot_mapping)):
        np.testing.assert_array_equal(d[name], want, err_msg=name)
    mb = d["block_table"].shape[1]
    for req, *_ in rows:
        np.testing.assert_array_equal(d["block_table"][req.slot], sess.allocator.block_table(req.slot, mb))
    assert not d["chained"] and (d["chain_src"] == -1).all()
    sess.run_to_completion()


def test_mixed_step_telemetry_counts_match_dispatches_and_jax(apps):
    jt, tt = JaxTelemetry(), TelemetrySession()
    j, t, js, ts = _both(apps, "ragged", _standard_mix, jax_kw=dict(telemetry=jt), port_kw=dict(telemetry=tt))
    assert t == j
    n = ts.dispatches["mixed_step"]
    assert n > 0 and tt.steps["mixed"] == n
    labels = ("prefill_rows", "decode_rows", "padded_slots", "query_tokens")
    assert all(len(tt.mixed_steps[k]) == n for k in labels)
    jt.close()
    snap = jt.registry.snapshot()
    jhist = {s["labels"]["kind"]: s for s in snap["nxdi_mixed_step_rows"]["samples"]}
    for k in labels:
        assert jhist[k]["count"] == n and jhist[k]["sum"] == sum(tt.mixed_steps[k]), k
    assert sum(tt.mixed_steps["decode_rows"]) == sum(len(v) for v in t.values()) - len(t)
    assert snap["nxdi_step_host_ms"]["samples"][0]["count"] == len(tt.step_host_ms) > 0
    assert len(tt.step_fetch_wait_ms) == len(tt.step_host_ms)
    assert min(tt.step_fetch_wait_ms) >= 0.0
    assert {m for m, _ in tt.buckets} == {"mixed_step_model"}


def test_config_validation_matches_reference():
    bad = [
        (dict(is_continuous_batching=True, serving_ragged=True), ValueError, "paged cache"),
        (dict(is_block_kv_layout=True, serving_ragged=True), ValueError, "is_continuous_batching"),
        (dict(serving_ragged_async=True), ValueError, "serving_ragged_async"),
    ]
    for kw, exc, match in bad:
        with pytest.raises(exc, match=match):
            TpuConfig(**kw)
        with pytest.raises(exc, match=match):
            Config(device="cpu", **kw)
    ok = dict(is_continuous_batching=True, is_block_kv_layout=True, serving_ragged=True)
    assert Config(device="cpu", **ok).serving_ragged_async is TpuConfig(**ok).serving_ragged_async is None


def test_session_requires_mixed_family(apps):
    _, port_app = apps("ragged")
    runner, port_app.mixed_step_model = port_app.mixed_step_model, None
    try:
        with pytest.raises(ValueError, match="mixed_step"):
            ServingSession(port_app)
    finally:
        port_app.mixed_step_model = runner


# ---------------------------------------------------------------------------
# fault containment on the ragged path, against the JAX package
# ---------------------------------------------------------------------------


def _faulty(apps, mode, inj_fn, **kw):
    return _both(
        apps, mode, _mix,
        jax_kw=dict(fault_injector=inj_fn(jfaults), **kw), port_kw=dict(fault_injector=inj_fn(tfaults), **kw),
    )


@pytest.mark.parametrize("mode", ["ragged", "ragged_sync"])
def test_nan_row_quarantine_spares_cobatched_rows(apps, mode):
    _, golden, _, _ = _both(apps, mode, _mix)
    j, t, js, ts = _faulty(apps, mode, lambda f: f.FaultInjector(seed=0).poison_kv_row(step=4, slot=1))
    assert t == j
    assert _statuses(ts) == _statuses(js)
    assert ts.requests["r2"].fail_reason == "non_finite"
    assert t["r2"] == golden["r2"][: len(t["r2"])] and len(t["r2"]) < len(golden["r2"])
    assert t["r1"] == golden["r1"] and t["r3"] == golden["r3"]
    assert len(ts.allocator.free) == ts.allocator.num_blocks
    assert not torch.isnan(ts.app.kv_cache.k[:, 1:]).any()


@pytest.mark.parametrize("mode", ["ragged", "ragged_sync"])
def test_poisoned_garbage_block_changes_no_row(apps, mode):
    _, golden, _, _ = _both(apps, mode, _mix)
    j, t, _, ts = _faulty(apps, mode, lambda f: f.FaultInjector().poison_garbage_block(step=2))
    assert t == j == golden
    assert all(r.status == "finished" for r in ts.requests.values())


@pytest.mark.parametrize("mode", ["ragged", "ragged_sync"])
def test_pool_exhaustion_resumes_byte_identical(apps, mode):
    _, golden, _, _ = _both(apps, mode, _mix)
    j, t, js, ts = _faulty(apps, mode, lambda f: f.FaultInjector().exhaust_pool(3))
    assert t == j == golden
    assert [r.preemptions for r in ts.requests.values()] == [r.preemptions for r in js.requests.values()]
    assert any(r.preemptions for r in ts.requests.values())


def test_async_dispatch_retry_recovers_byte_identical(apps):
    _, golden, _, _ = _both(apps, "ragged", _mix)
    sleeps = ([], [])
    j, t, _, ts = _both(
        apps, "ragged", _mix,
        jax_kw=dict(fault_injector=jfaults.FaultInjector().dispatch_error(step=4, attempts=2), sleep_fn=sleeps[0].append),
        port_kw=dict(fault_injector=tfaults.FaultInjector().dispatch_error(step=4, attempts=2), sleep_fn=sleeps[1].append),
    )
    assert ts.ragged_async
    assert t == j == golden
    assert sleeps[1] == sleeps[0] == [0.02, 0.04]
    assert all(r.status == "finished" for r in ts.requests.values())


def test_async_retry_exhaustion_keeps_pending_tokens(apps):
    """Past the retry budget the already-run previous step is consumed
    BEFORE the in-flight rows fail: each failed request keeps a clean-run
    prefix including its last in-flight token, and the session serves on."""
    _, golden, _, _ = _both(apps, "ragged", _mix)

    def run(sess):
        out = _mix(sess)
        assert sess.add_request("after", [42, 10, 11], max_new_tokens=4)
        out.update(_drive(sess))
        return out

    j, t, js, ts = _both(
        apps, "ragged", run,
        jax_kw=dict(fault_injector=jfaults.FaultInjector().dispatch_error(step=5, attempts=10), sleep_fn=lambda s: None),
        port_kw=dict(fault_injector=tfaults.FaultInjector().dispatch_error(step=5, attempts=10), sleep_fn=lambda s: None),
    )
    assert t == j
    assert _statuses(ts) == _statuses(js)
    failed = [r for r in ts.requests.values() if r.status == "failed"]
    assert failed and all(r.fail_reason == "dispatch_error" for r in failed)
    for rid in PROMPTS:
        assert t[rid] == golden[rid][: len(t[rid])], rid
    assert len(t["after"]) == 4 and len(ts.free_slots) == ts.num_slots


def test_async_deadline_expiry_mid_pipeline(apps):
    class Clock:
        def __init__(self):
            self.t = 0.0

        def __call__(self):
            return self.t

        def sleep(self, s):
            self.t += s

    _, golden, _, _ = _both(apps, "ragged", lambda s: _mix(s, n_tokens=8))

    def run(sess):
        assert sess.add_request("r1", PROMPTS["r1"], max_new_tokens=8, deadline_s=1.0)
        assert sess.add_request("r2", PROMPTS["r2"], max_new_tokens=8)
        assert sess.add_request("r3", PROMPTS["r3"], max_new_tokens=8)
        for _ in range(4):
            sess.step()  # r1's next step is dispatched and unconsumed here
        sess._clock.t += 5.0
        return _drive(sess)

    jc, tc = Clock(), Clock()
    j, t, js, ts = _both(
        apps, "ragged", run, jax_kw=dict(clock=jc, sleep_fn=jc.sleep), port_kw=dict(clock=tc, sleep_fn=tc.sleep)
    )
    assert t == j
    assert ts.requests["r1"].fail_reason == "deadline_exceeded"
    assert t["r1"] == golden["r1"][: len(t["r1"])] and len(t["r1"]) < 8
    assert t["r2"] == golden["r2"] and t["r3"] == golden["r3"]
    assert len(ts.free_slots) == ts.num_slots
