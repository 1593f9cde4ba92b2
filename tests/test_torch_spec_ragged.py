"""Speculation inside the port's ragged mixed step, held against the JAX
package's: the same tiny head_dim-64 Llama (one HF state dict loaded into
both, fp32, on the CPU), the same requests, greedy tokens byte-identical.

- ``mixed_forward`` at ``spec_width`` 4: the (R, 5) tokens with the
  accepted-count column equal the JAX one's on a step of a prefill chunk,
  a plain decode row, verify rows of 2, 3 and 4 tokens whose drafts match
  fully, partly and not at all, a draft -1 sentinel, a row with non-finite
  logits, and inactive rows; logits within 1e-4.
- ``draft_chain_propose``: proposals and cache writes equal the JAX one's
  for chained rows (every accepted count, a -1 frontier), fallback rows and
  an inactive row.
- The spec-ragged ``SpeculativeServingSession``, 1-ahead and synchronous,
  with a good draft (the target's weights) and a bad one: its drained
  streams, per-request draft-length sequences and ``nxdi_spec_*``
  histograms equal the JAX session's, and its streams equal the port's
  plain ragged and split sessions. The reference's pins
  (tests/test_spec_ragged_serving.py) follow: one mixed dispatch per step,
  the adaptive policy's direction, EOS, slot reuse, the position limit,
  the construction fences, one fetch per 1-ahead step, a failed draft
  dispatch that is not fatal, and no new program after the seal.

On CPU tensors every kernel wrapper takes its plain version: no launches."""

import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.config import ChunkedPrefillConfig as JaxChunked
from neuronx_distributed_inference_tpu.config import TpuConfig
from neuronx_distributed_inference_tpu.models.llama import LlamaInferenceConfig as JaxLlamaConfig
from neuronx_distributed_inference_tpu.runtime.application import TpuModelForCausalLM
from neuronx_distributed_inference_tpu.runtime.serving import SpeculativeServingSession as JaxSpecSession
from neuronx_distributed_inference_tpu.telemetry import TelemetrySession as JaxTelemetry
from neuronx_distributed_inference_tpu.telemetry import metrics as jmetrics
from neuronx_distributed_inference_tpu_torch.analysis.retrace_guard import RetraceGuard
from neuronx_distributed_inference_tpu_torch.config import ChunkedPrefillConfig, Config
from neuronx_distributed_inference_tpu_torch.models.base import DecodeState, MixedStepInputs, draft_chain_propose
from neuronx_distributed_inference_tpu_torch.models.base import mixed_forward as port_mixed_forward
from neuronx_distributed_inference_tpu_torch.models.llama import LlamaInferenceConfig
from neuronx_distributed_inference_tpu_torch.modules.block_kvcache import BlockKVCache
from neuronx_distributed_inference_tpu_torch.modules.kvcache import KVCache
from neuronx_distributed_inference_tpu_torch.ops import _cuda
from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM
from neuronx_distributed_inference_tpu_torch.runtime.faults import TransientDispatchError
from neuronx_distributed_inference_tpu_torch.runtime.model_runner import MixedStepRunner, SubModelRunner
from neuronx_distributed_inference_tpu_torch.runtime.serving import ServingSession, SpeculativeServingSession
from neuronx_distributed_inference_tpu_torch.telemetry import TelemetrySession
from tests.conftest import make_random_hf_state_dict

K = 4
HF = dict(
    model_type="llama", hidden_size=256, intermediate_size=256, num_attention_heads=4,
    num_key_value_heads=2, num_hidden_layers=2, vocab_size=128, rms_norm_eps=1e-5,
    rope_theta=10000.0, max_position_embeddings=256, hidden_act="silu", tie_word_embeddings=False,
)
SERVE = dict(is_continuous_batching=True, batch_size=4, ctx_batch_size=1, seq_len=64, dtype="float32")
PAGED = dict(is_block_kv_layout=True, pa_block_size=16, pa_num_blocks=24, is_chunked_prefill=True, serving_ragged=True)
KINDS = {
    "spec": dict(PAGED, serving_spec_ragged=True, speculation_length=K),
    "spec_sync": dict(PAGED, serving_spec_ragged=True, speculation_length=K, serving_ragged_async=False),
    "ragged": dict(PAGED),
    "draft": {},  # the draft and the split path: the contiguous cache
    "split": {},  # the split path's target, an app apart from the draft's
}
PROMPTS = {"r1": [5, 17, 92, 41], "r2": list(range(30, 52)), "r3": [7, 7, 7]}


def _load(c):
    for k, v in HF.items():
        setattr(c, k, v)


def _jax_app(kind, sd):
    kw = {**SERVE, **KINDS[kind]}
    if kw.get("is_chunked_prefill"):
        kw["chunked_prefill_config"] = JaxChunked(max_num_seqs=2, kernel_q_tile_size=16)
    return TpuModelForCausalLM(None, JaxLlamaConfig(TpuConfig(**kw), load_config=_load)).load(state_dict=sd)


def _port_app(kind, sd):
    kw = {**SERVE, **KINDS[kind]}
    if kw.get("is_chunked_prefill"):
        kw["chunked_prefill_config"] = ChunkedPrefillConfig(max_num_seqs=2, kernel_q_tile_size=16)
    return ModelForCausalLM(None, LlamaInferenceConfig(Config(**kw, device="cpu"), load_config=_load)).load(
        state_dict=sd
    )


@pytest.fixture(scope="module")
def sds():
    torch.set_num_threads(1)
    cfg = JaxLlamaConfig(TpuConfig(**SERVE), load_config=_load)
    return {"good": make_random_hf_state_dict(cfg, seed=5), "bad": make_random_hf_state_dict(cfg, seed=7)}


@pytest.fixture(scope="module")
def apps(sds):
    """(jax app, port app) per (kind, weights), built once per module; each
    call hands them out with zeroed caches."""
    built = {}

    def get(kind, weights="good"):
        key = (kind, weights)
        if key not in built:
            built[key] = (_jax_app(kind, sds[weights]), _port_app(kind, sds[weights]))
        for a in built[key]:
            a.init_kv_cache()
        return built[key]

    return get


def _drive(sess, max_steps=300):
    for _ in range(max_steps):
        if not (sess.active or sess._readmit):
            break
        sess.step()
    else:
        raise AssertionError("session failed to drain within max_steps")
    return {rid: list(r.generated) for rid, r in sess.requests.items()}


def _standard_mix(sess):
    """The reference's staggered mix: a long prompt's chunks overlap live
    spec decode of an earlier request."""
    assert sess.add_request("r1", PROMPTS["r1"], max_new_tokens=6)
    sess.step()
    assert sess.add_request("r2", PROMPTS["r2"], max_new_tokens=6)
    sess.step()
    assert sess.add_request("r3", PROMPTS["r3"], max_new_tokens=5)
    return _drive(sess)


def _record_rounds(sess):
    """Each request's (drafted, accepted) per verify round, and the draft
    length the policy chose after it."""
    rounds = {}
    orig = sess._note_acceptance

    def note(req, accepted, drafted):
        orig(req, accepted, drafted)
        rounds.setdefault(req.req_id, []).append((drafted, accepted, req.draft_len))

    sess._note_acceptance = note
    return rounds


# ---------------------------------------------------------------------------
# mixed_forward(spec_width=4) and draft_chain_propose against the JAX ones
# ---------------------------------------------------------------------------

R_CASE, BS, WIDTH = 8, 16, 64


def _spec_case(drafts):
    """One spec step over a populated pool: row 0 a 13-token chunk from
    position 10, row 1 a plain decode row, rows 2-4 verify rows of 4, 3
    and 2 tokens, row 5 a verify row of 4 whose context is NaN (non-finite
    logits), row 6 a verify row whose draft matrix holds -1, row 7
    inactive. ``drafts`` (R, 3) is the draft matrix the verify rows read."""
    rng = np.random.RandomState(3)
    pool = (rng.randn(2, 2, 25, 2, BS, 64) * 0.5).astype(np.float32)  # (k|v, L, NB+1, Hkv, bs, D)
    pool[:, :, 0] = np.nan
    pool[:, :, 20] = np.nan  # row 5's only block
    bt = np.zeros((R_CASE, WIDTH // BS), np.int32)
    for r, blocks in {0: [3, 7], 1: [1, 9], 2: [2, 4], 3: [5, 6], 4: [8, 10], 5: [20], 6: [11, 12]}.items():
        bt[r, : len(blocks)] = blocks
    row_len = np.array([13, 1, 4, 3, 2, 4, 4, 0], np.int32)
    p0 = np.array([10, 30, 20, 25, 17, 9, 22, 0], np.int32)
    ctx_len = np.where(row_len > 0, p0 + row_len, 0).astype(np.int32)
    row_start = (np.arange(R_CASE) * 16).astype(np.int32)
    row_start[7] = 0
    T = 112
    ids = np.zeros(T, np.int32)
    pos = np.full(T, -1, np.int32)
    slots = np.full(T, -1, np.int32)
    chain_src = np.full(T, -1, np.int32)
    verify_len = np.ones(R_CASE, np.int32)
    for r in range(7):
        s, n = row_start[r], row_len[r]
        p = np.arange(p0[r], p0[r] + n)
        pos[s : s + n] = p
        slots[s : s + n] = bt[r, p // BS] * BS + p % BS
        ids[s : s + n] = rng.randint(1, 120, size=n)
        if r >= 2:
            chain_src[s + 1 : s + n] = r * (K - 1) + np.arange(n - 1)
            verify_len[r] = n
    draft = np.asarray(drafts, np.int32).copy()
    draft[6, :] = -1
    args = (ids, pos, slots, row_start, row_len, ctx_len, bt, chain_src, verify_len, draft)
    return pool, args


def _run_spec_step(jax_app, port_app, pool, args):
    import jax
    import jax.numpy as jnp

    from neuronx_distributed_inference_tpu.models.base import MixedStepInputs as JaxInputs
    from neuronx_distributed_inference_tpu.models.base import mixed_forward as jax_mixed_forward

    ids, pos, slots, row_start, row_len, ctx_len, bt, chain_src, verify_len, draft = args
    sp = np.tile(np.array([1.0, 1.0, 1.0], np.float32), (R_CASE, 1))
    jin = JaxInputs(
        input_ids=jnp.asarray(ids[None]), position_ids=jnp.asarray(pos[None]), slot_mapping=jnp.asarray(slots[None]),
        block_table=jnp.asarray(bt), row_start=jnp.asarray(row_start), row_len=jnp.asarray(row_len),
        ctx_len=jnp.asarray(ctx_len), sampling_params=jnp.asarray(sp), chain_src=jnp.asarray(chain_src[None]),
        chain_tokens=jnp.zeros((R_CASE, 1), jnp.int32), verify_len=jnp.asarray(verify_len),
        draft_tokens=jnp.asarray(draft),
    )
    jcache = type(jax_app.kv_cache)(k=jnp.asarray(pool[0]), v=jnp.asarray(pool[1]))
    fn = jax.jit(lambda p, c, i: jax_mixed_forward(p, c, i, None, spec=jax_app.spec, spec_width=K))
    jout = fn(jax_app.params, jcache, jin)
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    tin = MixedStepInputs(
        input_ids=t(ids[None]), position_ids=t(pos[None]), slot_mapping=t(slots[None]), block_table=t(bt),
        row_start=t(row_start), row_len=t(row_len), ctx_len=t(ctx_len), sampling_params=t(sp),
        chain_src=t(chain_src[None]), chain_tokens=torch.zeros((R_CASE, 1), dtype=torch.int32),
        verify_len=t(verify_len), draft_tokens=t(draft),
    )
    tcache = BlockKVCache(k=torch.from_numpy(pool[0].copy()), v=torch.from_numpy(pool[1].copy()))
    tout = port_mixed_forward(port_app.params, tcache, tin, spec=port_app.spec, spec_width=K)
    return jout, tout


def test_mixed_forward_spec_width_matches_jax(apps):
    """Drafts are set from the JAX program's own greedy tokens, one column
    at a time: row 2 matches fully (count 4), row 3 matches its first draft
    of two (count 2), row 4 not at all (count 1)."""
    jax_app, port_app = apps("spec")
    drafts = np.full((R_CASE, K - 1), 3, np.int32)
    pool, args = _spec_case(drafts)
    for j in range(K - 1):
        jout, _ = _run_spec_step(jax_app, port_app, pool, args)
        g = np.asarray(jout.tokens)
        drafts[2, j] = g[2, j]
        if j == 0:
            drafts[3, 0] = g[3, 0]
            drafts[3, 1] = (g[3, 1] + 1) % 128
            drafts[4, 0] = (g[4, 0] + 1) % 128
        pool, args = _spec_case(drafts)
    _cuda.reset_launch_counts()
    jout, tout = _run_spec_step(jax_app, port_app, pool, args)
    assert set(_cuda.launch_counts().values()) == {0}
    jt, tt = np.asarray(jout.tokens), tout.tokens.numpy()
    assert tt.shape == (R_CASE, K + 1)
    live = [0, 1, 2, 3, 4, 5, 6]
    np.testing.assert_array_equal(tt[live], jt[live])
    assert tt[2, K] == 4 and tt[3, K] == 2 and tt[4, K] == 1
    assert tt[0, K] == tt[1, K] == 1  # plain rows: verify_len 1
    assert (tt[5, :K] == -1).all() and tt[5, K] == 1  # non-finite logits stop acceptance
    # row 6's -1 drafts clamp to token 0: acceptance as if the drafts were 0
    assert tt[6, K] == 1 + int(np.cumprod(tt[6, : K - 1] == 0).sum())


def _chain_case():
    rng = np.random.RandomState(4)
    B, S = 4, 64
    cache = (rng.randn(2, 2, B + 1, S, 2, 64) * 0.5).astype(np.float32)  # (k|v, L, B+1, S, Hkv, D)
    # (R, K+1) verify output: row 0 accepted 4, row 1 accepted 2 with a -1
    # frontier (clamps to token 0), row 2 a fallback row, row 3 inactive
    prev = np.array([[11, 22, 33, 44, 4], [9, -1, 5, 6, 2], [1, 2, 3, 4, 3], [7, 8, 9, 10, 1]], np.int32)
    fallback_last = np.array([[0], [0], [57], [0]], np.int32)
    fallback_pos = np.array([[0], [0], [30], [0]], np.int32)
    use_chain = np.array([[1], [1], [0], [0]], np.int32)
    p0_base = np.array([[20], [25], [0], [0]], np.int32)
    seq_ids = np.array([0, 1, 2, -1], np.int32)
    return cache, prev, fallback_last, fallback_pos, use_chain, p0_base, seq_ids


def test_draft_chain_propose_matches_jax(apps):
    import jax.numpy as jnp

    from neuronx_distributed_inference_tpu.models.base import draft_chain_propose as jax_chain

    jax_app, port_app = apps("draft")
    cache, prev, fl, fp, uc, p0, seq_ids = _chain_case()
    bucket = 64
    sp = np.tile(np.array([1.0, 1.0, 1.0], np.float32), (4, 1))
    jtok, _, jcache = jax_chain(
        jax_app.params, type(jax_app.kv_cache)(k=jnp.asarray(cache[0]), v=jnp.asarray(cache[1])),
        jnp.asarray(prev), jnp.asarray(fl), jnp.asarray(fp), jnp.asarray(uc), jnp.asarray(p0),
        jnp.asarray(seq_ids), jnp.asarray(sp), None, spec=jax_app.spec, num_steps=K - 1, bucket=bucket, spec_width=K,
    )
    tcache = KVCache(k=torch.from_numpy(cache[0].copy()), v=torch.from_numpy(cache[1].copy()))
    t = torch.from_numpy
    st = DecodeState(
        last=torch.zeros((4, 1), dtype=torch.int32), pos=torch.zeros((4, 1), dtype=torch.int32),
        seq_ids=t(seq_ids), sampling_params=t(sp), cols=torch.arange(bucket, dtype=torch.int32)[None, :],
    )
    ttok = draft_chain_propose(
        port_app.params, tcache, st, t(prev), t(fl), t(fp), t(uc), t(p0),
        spec=port_app.spec, num_steps=K - 1, spec_width=K,
    )
    np.testing.assert_array_equal(ttok.numpy()[:3], np.asarray(jtok)[:3])
    # the chained rows wrote from base + count (row 0: 24..26, row 1: 27..29),
    # the fallback row from 30 (30..32); everything else is untouched
    for tc_, jc in ((tcache.k, jcache.k), (tcache.v, jcache.v)):
        np.testing.assert_allclose(tc_.numpy()[:, :3], np.asarray(jc)[:, :3], atol=1e-5, rtol=0)
    written = np.zeros((5, 64), bool)
    written[0, 24:27], written[1, 27:30], written[2, 30:33] = True, True, True
    changed = (tcache.k.numpy() != cache[0]).any(axis=(0, 3, 4))
    assert (changed[:3] == written[:3]).all()


# ---------------------------------------------------------------------------
# the spec-ragged session against the JAX package's
# ---------------------------------------------------------------------------


def _spec_pair(apps, kind, weights):
    (jt, tt), (jd, td) = apps(kind), apps("draft", weights)
    return (jt, jd), (tt, td)


def _hist(snap, name, bounds):
    s = snap[name]["samples"][0]
    return s["sum"], s["count"], [s["buckets"][b] for b in s["buckets"]]


def _port_hist(values, bounds):
    cum = [sum(1 for v in values if v <= b) for b in bounds] + [len(values)]
    return float(sum(values)), len(values), cum


def _assert_hists_equal(jtel, ttel):
    """The port's three nxdi_spec_* observations, bucketed as the JAX
    registry buckets them, equal the JAX histograms."""
    snap = jtel.registry.snapshot()
    for name, values, bounds in (
        ("nxdi_spec_accept_len", ttel.spec_accept_len, jmetrics.ACCEPT_LEN_BUCKETS),
        ("nxdi_spec_draft_len", ttel.spec_draft_len, jmetrics.DRAFT_LEN_BUCKETS),
        ("nxdi_spec_accept_ewma", ttel.spec_accept_ewma, jmetrics.SPEC_EWMA_BUCKETS),
    ):
        js_sum, js_count, js_cum = _hist(snap, name, bounds)
        p_sum, p_count, p_cum = _port_hist(values, bounds)
        assert (p_count, p_cum) == (js_count, js_cum), name
        assert p_sum == pytest.approx(js_sum, abs=1e-9), name


@pytest.mark.parametrize("kind", ["spec", "spec_sync"])
def test_spec_ragged_session_matches_jax_plain_and_split(apps, kind):
    """THE pin: the spec-ragged streams (good and bad draft) equal the JAX
    spec-ragged session's, the port's plain ragged session's and the port's
    split path's; the draft-length sequences and the three nxdi_spec_*
    histograms equal the JAX session's."""
    plain = _standard_mix(ServingSession(apps("ragged")[1]))
    assert all(len(v) > 0 for v in plain.values())
    split_t, split_d = apps("draft")[1], apps("draft", "bad")[1]
    split = _standard_mix(SpeculativeServingSession(split_t, split_d, speculation_length=K))
    assert split == plain
    for weights in ("good", "bad"):
        (jt, jd), (tt, td) = _spec_pair(apps, kind, weights)
        with JaxTelemetry() as jtel:
            js = JaxSpecSession(jt, jd, speculation_length=K, telemetry=jtel)
            jrounds = _record_rounds(js)
            jout = _standard_mix(js)
        ttel = TelemetrySession()
        ts = SpeculativeServingSession(tt, td, speculation_length=K, telemetry=ttel)
        trounds = _record_rounds(ts)
        tout = _standard_mix(ts)
        assert tout == jout == plain, (kind, weights)
        assert trounds == jrounds and trounds
        _assert_hists_equal(jtel, ttel)
        # the accept histogram sums to the committed decode tokens
        assert sum(ttel.spec_accept_len) == sum(len(v) for v in tout.values()) - len(tout)
        assert ttel.mixed_steps["spec_rows"] and sum(ttel.mixed_steps["spec_rows"]) > 0
        events = [e for tr in ttel.completed for e in tr.events]
        assert len(events) == len(ttel.spec_draft_len)
        if weights == "good":
            assert ts.acceptance_ewma > 0.9 and all(r.draft_len == K - 1 for r in ts.requests.values())
        else:
            assert ts.acceptance_ewma < 0.5 and min(r.draft_len for r in ts.requests.values()) < K - 1


def _long_mix(sess):
    """The staggered mix run for 24-30 tokens a request, long enough for
    rounds accepted in full to follow one another, and short of the
    position limit (the draft chain's reach stays below it)."""
    assert sess.add_request("r1", PROMPTS["r1"], max_new_tokens=30)
    sess.step()
    assert sess.add_request("r2", PROMPTS["r2"], max_new_tokens=24)
    sess.step()
    assert sess.add_request("r3", PROMPTS["r3"], max_new_tokens=30)
    return _drive(sess)


def _jax_k_step_drafts(monkeypatch):
    """Patch the JAX package, for one test, so that its draft proposes as
    the port's does: k draft steps for k-1 proposals, the k-th only
    writing the last proposal's K/V. The chained propose runs at the full
    width (seq_len), which covers the extra step's position; the split
    path's chunk already asks for a bucket covering pos + k."""
    from neuronx_distributed_inference_tpu.models import base as jbase
    from neuronx_distributed_inference_tpu.runtime import assisted as jassisted

    chain = jbase.draft_chain_propose

    def chain_k(*args, num_steps, bucket, **kw):
        tokens, logits, cache = chain(*args, num_steps=num_steps + 1, bucket=SERVE["seq_len"], **kw)
        return tokens[:, :num_steps], None if logits is None else logits[:, :num_steps], cache

    def propose_k(draft, last, pos, seq_ids, sp, k, key=None):
        bucket = draft._decode_bucket(int(np.asarray(pos).max()) + k)
        d_tokens, d_logits, d_cache = draft.token_generation_model.decode_chunk(
            draft.params, draft.kv_cache, np.asarray(last), np.asarray(pos), seq_ids, sp, key,
            num_steps=k, bucket=bucket,
        )
        draft.kv_cache = d_cache
        B = np.asarray(last).shape[0]
        return np.asarray(d_tokens)[:B, : k - 1], None if d_logits is None else d_logits[:, : k - 1]

    monkeypatch.setattr(jbase, "draft_chain_propose", chain_k)
    monkeypatch.setattr(jassisted, "draft_propose", propose_k)


@pytest.mark.parametrize("kind", ["spec", "spec_sync", "split"])
def test_k_step_draft_against_jax(apps, monkeypatch, kind):
    """The port's one deliberate departure from the JAX package: its draft
    runs k steps a round where the JAX package runs k-1, so a round
    accepted in full leaves no stale entry at its last draft's position in
    the draft's cache. On a longer mix with the target's weights as the
    draft, the JAX package's draft then reads that stale entry in the next
    round and proposes worse:
    - the streams equal the JAX package's all the same (the target's
      tokens are emitted either way);
    - the port's rounds accept more than the JAX package's, so its
      draft-length sequences and nxdi_spec_* histograms differ from JAX's;
    - the JAX package patched to k draft steps gives the port's rounds and
      histograms exactly."""

    def run(sess_cls, target, draft, tel):
        sess = sess_cls(target, draft, speculation_length=K, telemetry=tel)
        rounds = _record_rounds(sess)
        return _long_mix(sess), rounds

    (jt, jd), (tt, td) = _spec_pair(apps, kind, "good")
    jd.__dict__.pop("_spec_chain_fns", None)
    with JaxTelemetry() as jtel:
        jout, jrounds = run(JaxSpecSession, jt, jd, jtel)
    ttel = TelemetrySession()
    tout, trounds = run(SpeculativeServingSession, tt, td, ttel)
    assert tout == jout and all(len(v) >= 24 for v in tout.values())

    def accepted(rounds):
        return sum(a for req in rounds.values() for _, a, _ in req)

    # every round of the port is accepted in full; the JAX package's
    # stale entry costs it proposals
    assert all(a == d for req in trounds.values() for d, a, _ in req)
    assert accepted(trounds) > accepted(jrounds) and trounds != jrounds
    # the same tokens committed in fewer rounds: the accept histograms'
    # sums agree, their counts do not
    j_sum, j_count, _ = _hist(jtel.registry.snapshot(), "nxdi_spec_accept_len", jmetrics.ACCEPT_LEN_BUCKETS)
    assert sum(ttel.spec_accept_len) == j_sum and len(ttel.spec_accept_len) < j_count

    _jax_k_step_drafts(monkeypatch)
    jd.__dict__.pop("_spec_chain_fns", None)  # the chained programs are cached on the draft app
    for a in (jt, jd):
        a.init_kv_cache()
    try:
        with JaxTelemetry() as ktel:
            kout, krounds = run(JaxSpecSession, jt, jd, ktel)
    finally:
        jd.__dict__.pop("_spec_chain_fns", None)
    assert kout == tout
    assert krounds == trounds
    _assert_hists_equal(ktel, ttel)


def test_one_mixed_dispatch_per_step(apps):
    """A step serving prefill chunks, decode and spec-verify rows is ONE
    mixed dispatch; the target's context/decode runners never run."""
    (_, _), (tt, td) = _spec_pair(apps, "spec", "good")
    sess = SpeculativeServingSession(tt, td, speculation_length=K)
    assert sess.add_request("d1", PROMPTS["r1"], max_new_tokens=12)
    sess.step()
    sess.step()
    assert sess.add_request("p1", PROMPTS["r2"], max_new_tokens=8)
    sess.step()
    assert sess.prefilling and sess.decoding and sess._draft_prop is not None
    counts = {"mixed": 0, "target": 0}
    orig_sub, orig_mixed = SubModelRunner.__call__, MixedStepRunner.__call__

    def sub(self, *a, **kw):
        if self in (tt.context_encoding_model, tt.token_generation_model):
            counts["target"] += 1
        return orig_sub(self, *a, **kw)

    def mixed(self, *a, **kw):
        counts["mixed"] += 1
        return orig_mixed(self, *a, **kw)

    SubModelRunner.__call__, MixedStepRunner.__call__ = sub, mixed
    try:
        before = dict(sess.dispatches)
        sess.step()
    finally:
        SubModelRunner.__call__, MixedStepRunner.__call__ = orig_sub, orig_mixed
    assert counts == {"mixed": 1, "target": 0}
    assert sess.dispatches["mixed_step_spec"] == before["mixed_step_spec"] + 1
    _drive(sess)
    assert set(sess.dispatches) == {"mixed_step_spec", "draft_chain", "prefill_draft"}


def test_eos_slot_reuse_and_position_limit_match_plain(apps):
    tt, td = apps("spec")[1], apps("draft")[1]
    pa = apps("ragged")[1]
    g = ServingSession(pa)
    assert g.add_request("e", [5, 6, 7], max_new_tokens=8)
    golden = g.run_to_completion()["e"]
    eos = golden[2]
    sess = SpeculativeServingSession(tt, td, speculation_length=K)
    assert sess.add_request("e", [5, 6, 7], max_new_tokens=8, eos_token_id=eos)
    assert sess.run_to_completion()["e"] == golden[:3]
    assert len(sess.free_slots) == 4

    # freed slots take new requests; the new stream equals an isolated run
    pa.init_kv_cache()
    g = ServingSession(pa)
    assert g.add_request("probe", [42, 10, 11], max_new_tokens=4)
    probe = g.run_to_completion()["probe"]
    for i in range(4):
        assert sess.add_request(f"w{i}", [1 + i, 2, 3], max_new_tokens=3)
    sess.run_to_completion()
    assert sess.add_request("probe", [42, 10, 11], max_new_tokens=4)
    assert sess.run_to_completion()["probe"] == probe

    # up to the position bound: the chain drops out near the limit
    pa.init_kv_cache()
    g = ServingSession(pa)
    assert g.add_request("x", [5, 17, 92, 41], max_new_tokens=60)
    golden = g.run_to_completion()["x"]
    assert len(golden) == 60
    tt.init_kv_cache()
    td.init_kv_cache()
    sess = SpeculativeServingSession(tt, td, speculation_length=K)
    assert sess.add_request("x", [5, 17, 92, 41], max_new_tokens=60)
    assert sess.run_to_completion()["x"] == golden


def test_construction_fences(apps):
    tt, td = apps("spec")[1], apps("draft")[1]
    with pytest.raises(ValueError, match="SpeculativeServingSession"):
        ServingSession(tt)
    with pytest.raises(ValueError, match="mixed_step_spec width"):
        SpeculativeServingSession(tt, td, speculation_length=3)
    with pytest.raises(NotImplementedError, match="contiguous"):
        SpeculativeServingSession(tt, apps("ragged")[1], speculation_length=K)
    with pytest.raises(NotImplementedError, match="disaggregated"):
        SpeculativeServingSession(tt, td, speculation_length=K).add_prefilled_request("h", [1], {}, first_token=2)


def test_async_one_fetch_and_one_dispatch_per_step(apps):
    """1-ahead: a steady spec step makes ONE consumed fetch (the (R, k+1)
    verify output, its copy started at dispatch) and one mixed dispatch."""
    from neuronx_distributed_inference_tpu_torch.runtime import serving as tserving

    tt, td = apps("spec")[1], apps("draft")[1]
    sess = SpeculativeServingSession(tt, td, speculation_length=K)
    assert sess.ragged_async
    assert sess.add_request("a", PROMPTS["r1"], max_new_tokens=14)
    assert sess.add_request("b", PROMPTS["r3"], max_new_tokens=14)
    for _ in range(4):
        sess.step()
    assert sess._pending is not None
    fetches = {"n": 0}
    orig_wait = tserving._TokenFetch.wait

    def wait(self):
        fetches["n"] += 1
        return orig_wait(self)

    tserving._TokenFetch.wait = wait
    try:
        before = sess.dispatches["mixed_step_spec"]
        assert sess.step()
    finally:
        tserving._TokenFetch.wait = orig_wait
    assert fetches["n"] == 1 and sess.dispatches["mixed_step_spec"] == before + 1
    _drive(sess)


def test_failed_draft_dispatch_is_not_fatal(apps):
    """A draft-chain dispatch that fails past its retries leaves the next
    round without proposals: its rows decode plainly and the streams stay
    the plain session's; nothing fails."""
    plain = _standard_mix(ServingSession(apps("ragged")[1]))
    tt, td = apps("spec")[1], apps("draft")[1]
    sess = SpeculativeServingSession(tt, td, speculation_length=K, sleep_fn=lambda s: None)
    orig = td.token_generation_model.draft_chain
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] in (2, 3, 4, 6, 7, 8):  # two dispatches past the retry budget
            raise TransientDispatchError("injected draft fault")
        return orig(*a, **kw)

    td.token_generation_model.draft_chain = flaky
    try:
        out = _standard_mix(sess)
    finally:
        del td.token_generation_model.draft_chain
    assert out == plain
    assert all(r.status == "finished" for r in sess.requests.values())


def _assert_draft_line_is_committed(draft, slot, tokens, upto):
    """The draft's cache line ``slot`` holds, at every position below
    ``upto``, the K/V a fresh prefill of the committed ``tokens`` writes."""
    from neuronx_distributed_inference_tpu_torch.models import base
    from neuronx_distributed_inference_tpu_torch.modules.kvcache import init_cache

    spec = draft.spec
    cache = init_cache(spec.num_layers, 1, 64, spec.attn.num_kv_heads, spec.attn.head_dim,
                       dtype=torch.float32, device="cpu")
    S = len(tokens)
    inputs = base.StepInputs(
        input_ids=torch.tensor([tokens]), attention_mask=torch.ones((1, S), dtype=torch.int32),
        position_ids=torch.arange(S, dtype=torch.int32)[None], seq_ids=torch.zeros(1, dtype=torch.int32),
        sampling_params=torch.ones((1, 3)),
    )
    base.model_logits(draft.params, cache, inputs, spec=spec, phase=base.PHASE_CONTEXT_ENCODING)
    for got, want in ((draft.kv_cache.k, cache.k), (draft.kv_cache.v, cache.v)):
        np.testing.assert_allclose(got[:, slot, :upto].numpy(), want[:, 0, :upto].numpy(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("kind", ["spec_sync", "split"])
def test_draft_cache_holds_every_committed_position(apps, kind):
    """With the target's weights as the draft every round is accepted in
    full; after each step the draft's cache line holds the committed
    tokens' K/V at every position below the row's frontier, the last
    draft's position of a fully accepted round included (the proposals run
    k steps, the last only writing; a k-1-step propose leaves that position
    stale). ``kind``: the spec-ragged path, or the split path."""
    tt, td = apps(kind)[1], apps("draft")[1]
    tt.init_kv_cache()
    td.init_kv_cache()
    sess = SpeculativeServingSession(tt, td, speculation_length=K)
    assert sess.add_request("r", PROMPTS["r2"], max_new_tokens=30)
    checked = 0
    while sess.active:
        sess.step()
        r = sess.requests["r"]
        if not r.finished and not r.prefilling and len(r.generated) > 1:
            committed = list(r.input_ids) + r.generated
            _assert_draft_line_is_committed(td, r.slot, committed[: r.pos], r.pos)
            checked += 1
    assert checked >= 4 and sess.acceptance_ewma > 0.9


def test_no_new_program_after_the_seal_with_adaptive_drafts(apps):
    """With the mix warmed and the runners sealed, a drain whose adaptive
    draft lengths move (bad draft) builds no program: the lengths are data."""
    tt, td = apps("spec")[1], apps("draft", "bad")[1]
    golden = _standard_mix(SpeculativeServingSession(tt, td, speculation_length=K))
    tt.init_kv_cache()
    td.init_kv_cache()
    for r in (tt.mixed_step_model, *tt.runners, *td.runners):
        r.seal()
    try:
        with RetraceGuard() as guard:
            sess = SpeculativeServingSession(tt, td, speculation_length=K)
            out = _standard_mix(sess)
    finally:
        for r in (tt.mixed_step_model, *tt.runners, *td.runners):
            r._prog.sealed = False
    assert out == golden and guard.traces == []
    assert min(r.draft_len for r in sess.requests.values()) < K - 1
