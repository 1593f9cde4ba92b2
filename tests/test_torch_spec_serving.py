"""The port's split-path speculative serving and assisted decoding, held
against the JAX package's: the same tiny head_dim-64 Llama target (one HF
state dict loaded into both, fp32, on the CPU) and drafts from their own
seeds (7: a wrong draft that forces rejections; 0: the target's weights).

- ``SpeculativeServingSession`` over the contiguous cache: its streams
  equal the JAX session's and the port's plain ``generate()``'s, with
  requests arriving mid-stream; the fences and faults of the reference's
  tests/test_serving.py and tests/test_serving_faults.py (a paged target
  refused, the near-limit single-step tail, a poisoned target row
  quarantined while the co-batched row stays byte-identical, a poisoned
  draft that costs only acceptance, dispatch retry and its exhaustion, a
  deadline, an overlong prompt rejected at the door).
- ``assisted_generate``: greedy parity with the JAX one and with plain
  ``generate()``; a sampled run draws valid tokens."""

import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.config import TpuConfig
from neuronx_distributed_inference_tpu.models.llama import LlamaInferenceConfig as JaxLlamaConfig
from neuronx_distributed_inference_tpu.runtime import faults as jfaults
from neuronx_distributed_inference_tpu.runtime.application import TpuModelForCausalLM
from neuronx_distributed_inference_tpu.runtime.assisted import assisted_generate as jax_assisted
from neuronx_distributed_inference_tpu.runtime.serving import SpeculativeServingSession as JaxSpecSession
from neuronx_distributed_inference_tpu_torch.config import Config
from neuronx_distributed_inference_tpu_torch.models.llama import LlamaInferenceConfig
from neuronx_distributed_inference_tpu_torch.ops import _cuda
from neuronx_distributed_inference_tpu_torch.runtime import faults as tfaults
from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM
from neuronx_distributed_inference_tpu_torch.runtime.assisted import RingSnapshotGuard, assisted_generate
from neuronx_distributed_inference_tpu_torch.runtime.serving import ServingSession, SpeculativeServingSession
from neuronx_distributed_inference_tpu_torch.telemetry import TelemetrySession
from tests.conftest import make_random_hf_state_dict

K = 4
HF = dict(
    model_type="llama", hidden_size=256, intermediate_size=256, num_attention_heads=4,
    num_key_value_heads=2, num_hidden_layers=2, vocab_size=128, rms_norm_eps=1e-5,
    rope_theta=10000.0, max_position_embeddings=256, hidden_act="silu", tie_word_embeddings=False,
)
SERVE = dict(is_continuous_batching=True, batch_size=2, ctx_batch_size=1, seq_len=64, dtype="float32")
GEN = dict(batch_size=2, seq_len=64, dtype="float32")
PROMPTS = np.array([[5, 17, 92, 41, 33, 88, 2, 11], [64, 3, 27, 9, 14, 0, 0, 0]])
MASK = np.array([[1, 1, 1, 1, 1, 1, 1, 1], [1, 1, 1, 1, 1, 0, 0, 0]])
REQS = (("r1", [5, 17, 92, 41]), ("r2", [64, 3, 27, 9, 14, 33]), ("r3", [7, 8]))


def _load(c):
    for k, v in HF.items():
        setattr(c, k, v)


@pytest.fixture(scope="module")
def sds():
    torch.set_num_threads(1)
    cfg = JaxLlamaConfig(TpuConfig(**GEN), load_config=_load)
    return {seed: make_random_hf_state_dict(cfg, seed=seed) for seed in (0, 7)}


@pytest.fixture(scope="module")
def apps(sds):
    """(jax app, port app) per (config kind, weight seed), built once per
    module; each call hands them out with zeroed caches."""
    built = {}

    def get(kind, seed, **extra):
        key = (kind, seed, repr(sorted(extra.items())))
        if key not in built:
            kw = {**(SERVE if kind == "serve" else GEN), **extra}
            jax_kw = dict(kw)
            if "on_device_sampling_config" in jax_kw:
                from neuronx_distributed_inference_tpu.config import OnDeviceSamplingConfig

                jax_kw["on_device_sampling_config"] = OnDeviceSamplingConfig(**jax_kw["on_device_sampling_config"])
            built[key] = (
                TpuModelForCausalLM(None, JaxLlamaConfig(TpuConfig(**jax_kw), load_config=_load)).load(
                    state_dict=sds[seed]
                ),
                ModelForCausalLM(None, LlamaInferenceConfig(Config(**kw, device="cpu"), load_config=_load)).load(
                    state_dict=sds[seed]
                ),
            )
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


def _turnover(sess):
    """Two requests up front, the third when a slot frees (the reference's
    mid-stream turnover)."""
    for rid, prompt in REQS[:2]:
        assert sess.add_request(rid, prompt, max_new_tokens=8)
    while sess.active:
        sess.step()
        if "r3" not in sess.requests and sess.free_slots:
            assert sess.add_request("r3", REQS[2][1], max_new_tokens=8)
    return {rid: list(r.generated) for rid, r in sess.requests.items()}


def _golden(apps):
    plain = apps("gen", 0)[1]
    out = {}
    for rid, prompt in REQS:
        ids = np.asarray(prompt)[None, :]
        out[rid] = plain.generate(ids, np.ones_like(ids), max_new_tokens=8).sequences[0, ids.shape[1]:].tolist()
    return out


def _spec(apps, draft_seed, side, **kw):
    """A fresh speculative session of ``side`` (0 JAX, 1 port)."""
    target, draft = apps("serve", 0)[side], apps("serve", draft_seed)[side]
    cls = JaxSpecSession if side == 0 else SpeculativeServingSession
    return cls(target, draft, speculation_length=K, **kw)


def _two(sess):
    assert sess.add_request("s1", [5, 17, 92, 41], max_new_tokens=8)
    assert sess.add_request("s2", [64, 3, 27, 9, 14, 33], max_new_tokens=8)
    return sess


@pytest.mark.parametrize("draft_seed", [0, 7])
def test_split_session_matches_jax_and_plain_generate(apps, draft_seed):
    golden = _golden(apps)
    jax_out = _turnover(_spec(apps, draft_seed, 0))
    tel = TelemetrySession()
    _cuda.reset_launch_counts()
    sess = _spec(apps, draft_seed, 1, telemetry=tel)
    out = _turnover(sess)
    assert out == jax_out == golden
    assert set(_cuda.launch_counts().values()) == {0}  # CPU: plain versions only
    assert sess.dispatches["speculate"] > 0 and sess.dispatches["prefill_draft"] == len(REQS)
    # the acceptance EWMA moves on the split path too; the histogram of
    # committed tokens sums to the decode tokens
    assert sess.acceptance_ewma is not None
    assert (sess.acceptance_ewma > 0.9) == (draft_seed == 0)
    assert sum(tel.spec_accept_len) == sum(len(v) for v in out.values()) - len(out)


def test_split_session_fences_and_near_limit(apps):
    paged = ModelForCausalLM(
        None, LlamaInferenceConfig(Config(**SERVE, is_block_kv_layout=True, pa_block_size=16, pa_num_blocks=16,
                                          device="cpu"), load_config=_load),
    ).load(random_weights=True)
    with pytest.raises(NotImplementedError, match="contiguous"):
        SpeculativeServingSession(paged, paged)
    target, draft = apps("serve", 0)[1], apps("serve", 7)[1]
    with pytest.raises(ValueError, match="speculation_length"):
        SpeculativeServingSession(target, draft, speculation_length=1)
    # within k-1 positions of the limit rows decode one token at a time and
    # emit the plain session's tokens (no early truncation)
    prompt = list(range(40, 90))
    plain = ServingSession(apps("serve", 0)[1])
    assert plain.add_request("r", prompt, max_new_tokens=30)
    golden = plain.run_to_completion()["r"]
    assert len(golden) < 30  # the position bound, not the budget
    outs = []
    for side in (0, 1):  # one at a time: _spec zeroes both packages' caches
        sess = _spec(apps, 7, side)
        assert sess.add_request("r", prompt, max_new_tokens=30)
        outs.append(sess.run_to_completion()["r"])
    assert outs == [golden, golden]
    assert sess.dispatches["decode_steps"] > 0  # the single-step tail ran


def test_split_session_quarantine_and_draft_immunity(apps):
    """A poisoned TARGET row (its fetched tokens, then its cache line) is
    quarantined with the co-batched row byte-identical, as in the JAX
    session; a NaN draft line costs only acceptance."""
    golden = _drive(_two(_spec(apps, 7, 1)))
    for inj_t, inj_j, victim, other in (
        (tfaults.FaultInjector().nan_logits(step=2, slot=1), jfaults.FaultInjector().nan_logits(step=2, slot=1),
         "s2", "s1"),
        (tfaults.FaultInjector().poison_kv_row(step=2, slot=0),
         jfaults.FaultInjector().poison_kv_row(step=2, slot=0), "s1", "s2"),
    ):
        tel = TelemetrySession()
        sess = _two(_spec(apps, 7, 1, fault_injector=inj_t, telemetry=tel))
        out = _drive(sess)
        jout = _drive(_two(_spec(apps, 7, 0, fault_injector=inj_j)))
        assert out == jout
        assert sess.requests[victim].fail_reason == "non_finite"
        assert out[victim] == golden[victim][: len(out[victim])]
        assert out[other] == golden[other]
        assert tel.counters["quarantined"] == 1

    sess = _two(_spec(apps, 7, 1))
    sess.step()
    tfaults.fill_kv_rows(sess.draft.kv_cache, [0], float("nan"))
    assert _drive(sess) == golden
    assert all(r.status == "finished" for r in sess.requests.values())


def test_split_session_retry_deadline_and_overlong_prompt(apps):
    golden = _drive(_two(_spec(apps, 7, 1)))
    sleeps = []
    sess = _two(_spec(apps, 7, 1, fault_injector=tfaults.FaultInjector().dispatch_error(step=2, attempts=1),
                      sleep_fn=sleeps.append))
    assert _drive(sess) == golden and sleeps == [0.02]
    sess = _two(_spec(apps, 7, 1, fault_injector=tfaults.FaultInjector().dispatch_error(step=2, attempts=10),
                      sleep_fn=sleeps.append))
    _drive(sess)
    failed = [r for r in sess.requests.values() if r.status == "failed"]
    assert failed and all(r.fail_reason == "dispatch_error" for r in failed)

    class Clock:
        t = 0.0

        def __call__(self):
            return self.t

        def sleep(self, s):
            self.t += s

    clock = Clock()
    sess = _spec(apps, 7, 1, clock=clock, sleep_fn=clock.sleep)
    assert sess.add_request("ttl", [5, 17, 92, 41], max_new_tokens=30, deadline_s=1.0)
    sess.step()
    clock.t += 9.0
    _drive(sess)
    assert sess.requests["ttl"].fail_reason == "deadline_exceeded"

    sess = _spec(apps, 7, 1)
    res = sess.add_request("long", list(range(1, 100)), max_new_tokens=4)
    assert not res and res.reason == "prompt_too_long"
    assert sess.rejected["long"].status == "rejected"


@pytest.mark.parametrize("draft_seed", [7, 0])
def test_assisted_generate_matches_jax_and_generate(apps, draft_seed):
    ref = apps("gen", 0)[1].generate(PROMPTS, MASK, max_new_tokens=12).sequences
    (jt, tt), (jd, td) = apps("gen", 0), apps("gen", draft_seed)
    jout = jax_assisted(jt, jd, PROMPTS, MASK, max_new_tokens=12, speculation_length=K).sequences
    (jt, tt), (jd, td) = apps("gen", 0), apps("gen", draft_seed)
    _cuda.reset_launch_counts()
    out = assisted_generate(tt, td, PROMPTS, MASK, max_new_tokens=12, speculation_length=K).sequences
    np.testing.assert_array_equal(out[:, : ref.shape[1]], ref)
    np.testing.assert_array_equal(out, np.asarray(jout))
    assert set(_cuda.launch_counts().values()) == {0}
    # with an EOS: each row stops at its first EOS, padded with it
    eos = int(ref[0, 8 + 3])
    got = assisted_generate(tt, td, PROMPTS, MASK, max_new_tokens=12, eos_token_id=eos, speculation_length=K)
    (jt, tt), (jd, td) = apps("gen", 0), apps("gen", draft_seed)
    want = jax_assisted(jt, jd, PROMPTS, MASK, max_new_tokens=12, eos_token_id=eos, speculation_length=K)
    np.testing.assert_array_equal(got.sequences, np.asarray(want.sequences))


def test_assisted_generate_sampled(apps):
    """Sampled accept/reject runs end to end and draws valid tokens; its
    preconditions raise as the reference's do."""
    sampling = dict(on_device_sampling_config={"do_sample": True, "top_k": 5})
    tt, td = apps("gen", 0, output_logits=True, **sampling)[1], apps("gen", 7, output_logits=True, **sampling)[1]
    out = assisted_generate(tt, td, PROMPTS, MASK, max_new_tokens=12, speculation_length=K, top_k=5)
    gen = out.sequences[:, 8:]
    assert gen.shape == (2, 12) and gen.min() >= 0 and gen.max() < 128
    with pytest.raises(ValueError, match="output_logits"):
        assisted_generate(apps("gen", 0, **sampling)[1], td, PROMPTS, MASK, max_new_tokens=4)
    with pytest.raises(ValueError, match="do_sample"):
        assisted_generate(tt, apps("gen", 7, output_logits=True)[1], PROMPTS, MASK, max_new_tokens=4)
    # on a cache without a ring the guard is a no-op (ring caches:
    # tests/test_torch_assisted_ring.py)
    guard = RingSnapshotGuard(tt, K)
    before = tt.kv_cache.k.clone()
    guard.snapshot(np.array([3, 5]))
    tt.kv_cache.k.add_(1.0)
    guard.restore(np.array([1, 1]))
    assert guard.W is None and torch.equal(tt.kv_cache.k, before + 1.0)
