"""Speculation with MoE models in the port, held against the JAX package on
the CPU at fp32: tiny Qwen3-MoE (E 128, top-8: Qwen3-30B-A3B's ratios, so a
4-row verify of 4 tokens selects 128 > 64 experts and takes the dense
route while the draft's 4-row decode takes B7), tiny Mixtral (E 8, top-2:
the same verify fits B7) and a tiny dense Qwen3 draft, each built by
``transformers`` from a seed and loaded into both packages from one state
dict.

- ``SpeculativeServingSession`` on the split path and the spec-ragged path
  (1-ahead and synchronous), with an MoE target and a dense draft, and an
  MoE target with itself as its MoE draft: drained streams byte-identical
  to the JAX session's, and, with the JAX package patched to the port's
  k draft steps a round (``test_torch_spec_ragged._jax_k_step_drafts``, the
  one deliberate difference), the same rounds (drafted, accepted, next
  draft length) and ``nxdi_spec_*`` histograms. Every MoE call's route is
  the reference rule's (``test_torch_moe_serving._RouteRecorder``).
- ``assisted_generate`` and fused speculation with an MoE target (and an
  MoE or a dense draft): the same sequences as the JAX package's, the
  same candidates verified each round (so the same accept counts).
- The spec family's mixed runner runs buckets of the builder's
  ``host_read_tokens`` packed tokens or more eagerly and captures the rest.

On CPU tensors every kernel wrapper takes its plain version."""

import numpy as np
import pytest
import torch
import transformers

from neuronx_distributed_inference_tpu.config import ChunkedPrefillConfig as JaxChunked
from neuronx_distributed_inference_tpu.config import FusedSpecConfig as JaxFusedSpecConfig
from neuronx_distributed_inference_tpu.config import MoETpuConfig
from neuronx_distributed_inference_tpu.models.llama import LlamaInferenceConfig as JaxConfig
from neuronx_distributed_inference_tpu.runtime import assisted as jassisted
from neuronx_distributed_inference_tpu.runtime.application import TpuModelForCausalLM
from neuronx_distributed_inference_tpu.runtime.fused_spec import TpuFusedSpecModelForCausalLM
from neuronx_distributed_inference_tpu.runtime.serving import SpeculativeServingSession as JaxSpecSession
from neuronx_distributed_inference_tpu.telemetry import TelemetrySession as JaxTelemetry
from neuronx_distributed_inference_tpu_torch.config import ChunkedPrefillConfig, FusedSpecConfig, InferenceConfig
from neuronx_distributed_inference_tpu_torch.config import MoEConfig
from neuronx_distributed_inference_tpu_torch.ops import _cuda
from neuronx_distributed_inference_tpu_torch.runtime import assisted as tassisted
from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM
from neuronx_distributed_inference_tpu_torch.runtime.fused_spec import FusedSpecModelForCausalLM
from neuronx_distributed_inference_tpu_torch.runtime.serving import SpeculativeServingSession
from neuronx_distributed_inference_tpu_torch.telemetry import TelemetrySession
from tests.test_torch_moe_serving import _RecordingGraphs, _RouteRecorder
from tests.test_torch_spec_ragged import (
    SERVE,
    _assert_hists_equal,
    _jax_k_step_drafts,
    _long_mix,
    _record_rounds,
)

K = 4
COMMON = dict(
    vocab_size=128, hidden_size=128, num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
    rms_norm_eps=1e-5, max_position_embeddings=256, tie_word_embeddings=False, attn_implementation="eager",
    eos_token_id=None, bos_token_id=None, head_dim=64,
)
MODELS = {
    "qwen3_moe": (
        transformers.Qwen3MoeConfig, transformers.Qwen3MoeForCausalLM,
        dict(intermediate_size=256, moe_intermediate_size=32, num_experts=128, num_experts_per_tok=8,
             norm_topk_prob=True, decoder_sparse_step=1),
    ),
    "mixtral": (
        transformers.MixtralConfig, transformers.MixtralForCausalLM,
        dict(intermediate_size=96, num_local_experts=8, num_experts_per_tok=2),
    ),
    "qwen3": (transformers.Qwen3Config, transformers.Qwen3ForCausalLM, dict(intermediate_size=256)),
}
PAGED = dict(is_block_kv_layout=True, pa_block_size=16, pa_num_blocks=24, is_chunked_prefill=True, serving_ragged=True)
KINDS = {
    "spec": dict(PAGED, serving_spec_ragged=True, speculation_length=K),
    "spec_sync": dict(PAGED, serving_spec_ragged=True, speculation_length=K, serving_ragged_async=False),
    "split": {},  # the split path's target: the contiguous cache
    "draft": {},  # the draft: the contiguous cache
}
GEN = dict(batch_size=2, seq_len=64, dtype="float32")
PROMPTS = np.array([[5, 17, 92, 41, 33, 88, 2, 11], [64, 3, 27, 9, 14, 0, 0, 0]])
MASK = np.array([[1] * 8, [1, 1, 1, 1, 1, 0, 0, 0]])


def _attrs(name):
    cls, _, extra = MODELS[name]
    cfg = cls(**COMMON, **extra)
    attrs = dict(model_type=name, hidden_act="silu", rope_theta=getattr(cfg, "rope_theta", 10000.0))
    for k in ("hidden_size", "intermediate_size", "num_hidden_layers", "num_attention_heads",
              "num_key_value_heads", "vocab_size", "rms_norm_eps", "tie_word_embeddings", "num_local_experts",
              "num_experts", "num_experts_per_tok", "moe_intermediate_size", "norm_topk_prob", "head_dim",
              "decoder_sparse_step"):
        if getattr(cfg, k, None) is not None:
            attrs[k] = getattr(cfg, k)
    return attrs


def _load(name):
    attrs = _attrs(name)
    return lambda c: [setattr(c, k, v) for k, v in attrs.items()]


@pytest.fixture(scope="module")
def sds():
    torch.set_num_threads(1)
    out = {}
    for name, (cls, model_cls, extra) in MODELS.items():
        torch.manual_seed(0)
        hf = model_cls(cls(**COMMON, **extra)).eval().float()
        out[name] = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    return out


def _configs(name, kw):
    """(JAX config, port config) of model ``name`` with TpuConfig fields
    ``kw`` (chunked prefill at 2 rows of 16 where asked)."""
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("is_chunked_prefill"):
        jkw["chunked_prefill_config"] = JaxChunked(max_num_seqs=2, kernel_q_tile_size=16)
        tkw["chunked_prefill_config"] = ChunkedPrefillConfig(max_num_seqs=2, kernel_q_tile_size=16)
    return (JaxConfig(MoETpuConfig(**jkw), load_config=_load(name)),
            InferenceConfig(MoEConfig(**tkw, device="cpu"), load_config=_load(name)))


@pytest.fixture(scope="module")
def apps(sds):
    """(jax app, port app) per (model, kind), built once per module; each
    call hands them out with zeroed caches."""
    built = {}

    def get(name, kind, **extra):
        key = (name, kind, tuple(sorted(extra.items())))
        if key not in built:
            kw = {**(SERVE if kind in KINDS else GEN), **KINDS.get(kind, {}), **extra}
            jcfg, tcfg = _configs(name, kw)
            built[key] = (TpuModelForCausalLM(None, jcfg).load(state_dict=sds[name]),
                          ModelForCausalLM(None, tcfg).load(state_dict=sds[name]))
        for a in built[key]:
            a.init_kv_cache()
        return built[key]

    return get


#: (target model, draft model): an MoE target with a dense draft, and an
#: MoE target drafting for itself
PAIRINGS = [("qwen3_moe", "qwen3"), ("qwen3_moe", "qwen3_moe")]


def _pair(apps, target, draft, kind):
    (jt, tt), (jd, td) = apps(target, kind), apps(draft, "draft")
    jd.__dict__.pop("_spec_chain_fns", None)  # the chained programs are cached on the JAX draft app
    return (jt, jd), (tt, td)


def _run(sess_cls, target, draft, tel):
    sess = sess_cls(target, draft, speculation_length=K, telemetry=tel)
    rounds = _record_rounds(sess)
    return _long_mix(sess), rounds, sess


@pytest.mark.parametrize("kind", ["spec", "spec_sync", "split"])
@pytest.mark.parametrize("target, draft", PAIRINGS, ids=["moe-dense", "moe-moe"])
def test_moe_speculative_session_matches_jax(apps, monkeypatch, target, draft, kind):
    """The streams equal the JAX session's as it stands; with the JAX
    package drafting k steps a round, its rounds and histograms equal the
    port's too. The port's MoE calls take the reference rule's routes (the
    spec-ragged steps of 64 packed tokens or more grouped, the split
    verify dense, the draft's decode rows through B7)."""
    (jt, jd), (tt, td) = _pair(apps, target, draft, kind)
    with JaxTelemetry() as jtel:
        jout, _, _ = _run(JaxSpecSession, jt, jd, jtel)
    spec = tt.builder.moe_spec()
    rec = _RouteRecorder(monkeypatch, spec)
    ttel = TelemetrySession()
    tout, trounds, ts = _run(SpeculativeServingSession, tt, td, ttel)
    assert tout == jout and all(len(v) >= 24 for v in tout.values())
    assert rec.calls and rec.observed() == rec.expected()
    per_row = {c[1] for c in rec.calls}
    if kind == "split":
        # the verify: 4 rows x K tokens x top-8 = 128 selections > 64
        assert (4, K) in rec.calls and rec.observed()["moe_dense"] > 0
    else:
        assert max(per_row) >= 64 and rec.observed()["moe_grouped"] > 0
    if draft == "qwen3_moe":
        assert rec.observed()["b7"] > 0  # the draft's 4-row decode: 32 selections
    if draft == target:  # the target drafting for itself: every round accepted in full
        assert all(a == d for req in trounds.values() for d, a, _ in req)

    _jax_k_step_drafts(monkeypatch)
    for a in (jt, jd):
        a.init_kv_cache()
    jd.__dict__.pop("_spec_chain_fns", None)
    try:
        with JaxTelemetry() as ktel:
            kout, krounds, _ = _run(JaxSpecSession, jt, jd, ktel)
    finally:
        jd.__dict__.pop("_spec_chain_fns", None)
    assert kout == tout
    assert krounds == trounds and trounds
    _assert_hists_equal(ktel, ttel)


def test_mixtral_split_verify_takes_b7_and_matches_jax(apps, monkeypatch):
    """Mixtral's top-2: the split path's 4-row verify of K tokens selects
    32 experts, within B7's 64 rows, as the draft's decode does; the
    streams and rounds equal the k-step JAX session's."""
    (jt, jd), (tt, td) = _pair(apps, "mixtral", "mixtral", "split")
    rec = _RouteRecorder(monkeypatch, tt.builder.moe_spec())
    ttel = TelemetrySession()
    tout, trounds, _ = _run(SpeculativeServingSession, tt, td, ttel)
    assert rec.observed() == rec.expected() and (4, K) in rec.calls
    # every verify call is one of B7's (the dense calls are prefills)
    assert rec.observed()["b7"] >= rec.calls.count((4, K)) + rec.calls.count((4, 1))
    _jax_k_step_drafts(monkeypatch)
    with JaxTelemetry() as jtel:
        jout, jrounds, _ = _run(JaxSpecSession, jt, jd, jtel)
    assert tout == jout and jrounds == trounds
    _assert_hists_equal(jtel, ttel)


def _record_verify(monkeypatch, module):
    """Each round's verified candidates (B, k), from ``module``'s
    target_verify."""
    rounds = []
    orig = module.target_verify

    def verify(target, cand, *a, **kw):
        rounds.append(np.array(cand))
        return orig(target, cand, *a, **kw)

    monkeypatch.setattr(module, "target_verify", verify)
    return rounds


@pytest.mark.parametrize("draft", ["qwen3", "qwen3_moe"])
def test_moe_assisted_generate_matches_jax(apps, monkeypatch, draft):
    """assisted_generate with the MoE target: the same sequences and, with
    the JAX package drafting k steps a round, the same candidates in every
    round (so the same accept counts)."""
    (jt, tt), (jd, td) = apps("qwen3_moe", "gen"), apps(draft, "gen")
    ref = tt.generate(PROMPTS, MASK, max_new_tokens=16).sequences
    jrounds = _record_verify(monkeypatch, jassisted)
    trounds = _record_verify(monkeypatch, tassisted)
    _jax_k_step_drafts(monkeypatch)
    jout = jassisted.assisted_generate(jt, jd, PROMPTS, MASK, max_new_tokens=16, speculation_length=K)
    (jt, tt), (jd, td) = apps("qwen3_moe", "gen"), apps(draft, "gen")
    _cuda.reset_launch_counts()
    out = tassisted.assisted_generate(tt, td, PROMPTS, MASK, max_new_tokens=16, speculation_length=K)
    np.testing.assert_array_equal(out.sequences, np.asarray(jout.sequences))
    np.testing.assert_array_equal(out.sequences[:, : ref.shape[1]], ref)
    assert len(trounds) == len(jrounds) > 0
    for t, j in zip(trounds, jrounds):
        np.testing.assert_array_equal(t, j)
    assert set(_cuda.launch_counts().values()) == {0}


@pytest.mark.parametrize("draft", ["qwen3", "qwen3_moe"])
def test_moe_fused_speculation_matches_jax(sds, apps, draft):
    """Fused speculation with the MoE target: the same sequences and
    generated counts as the JAX fused app's and plain generate()'s; a
    prefill reaching the grouped route runs eagerly (its programs' host
    read)."""
    spec_kw = dict(GEN, speculation_length=K, enable_fused_speculation=True)
    jcfg, tcfg = _configs("qwen3_moe", spec_kw)
    jdraft, tdraft = _configs(draft, GEN)
    jcfg.fused_spec_config = JaxFusedSpecConfig(draft_model_name="tiny-draft", draft_config=jdraft)
    tcfg.fused_spec_config = FusedSpecConfig(draft_config=tdraft)
    japp = TpuFusedSpecModelForCausalLM(None, jcfg).load(
        target_state_dict=sds["qwen3_moe"], draft_state_dict=sds[draft]
    )
    app = FusedSpecModelForCausalLM(None, tcfg).load(target_state_dict=sds["qwen3_moe"], draft_state_dict=sds[draft])
    assert app._cte.host_read_tokens == 64
    ref = apps("qwen3_moe", "gen")[1].generate(PROMPTS, MASK, max_new_tokens=12).sequences
    for eos in (None, int(ref[0, 8 + 5])):
        jout = japp.generate(PROMPTS, MASK, max_new_tokens=12, eos_token_id=eos)
        out = app.generate(PROMPTS, MASK, max_new_tokens=12, eos_token_id=eos)
        np.testing.assert_array_equal(out.sequences, np.asarray(jout.sequences))
        assert out.num_generated == jout.num_generated
        if eos is None:
            np.testing.assert_array_equal(out.sequences[:, : ref.shape[1]], ref)


@pytest.mark.parametrize("name, eager_from", [("qwen3_moe", 64), ("mixtral", None)])
def test_spec_mixed_runner_eager_rule_by_packed_tokens(apps, name, eager_from):
    """The spec family's runner (tag mixed_step_spec) takes the builder's
    host_read_tokens: buckets of 64 packed tokens or more run eagerly on
    every call (Qwen3-MoE's grouped route), the rest are captured; every
    key is recorded."""
    _, app = apps(name, "spec")
    runner = app.mixed_step_model
    assert runner.spec_width == K and runner.tag == "mixed_step_spec_model"
    assert runner._prog.host_read_tokens == eager_from == app.builder.host_read_tokens()
    gs, graphs = _RecordingGraphs(), runner._prog.graphs
    runner.bind_graphs(gs)
    try:
        for bucket in runner.buckets:
            for _ in range(2):
                runner(app.params, app.kv_cache, runner.example_inputs(bucket))
        mb = runner.kv_buckets[-1] // runner.block_size
        eager = [b for b in runner.buckets if eager_from is not None and b >= eager_from]
        assert [k[1] for k in gs.captures] == [b for b in runner.buckets if b not in eager]
        assert set(runner._prog.captured) == {("mixed", b, mb) for b in runner.buckets if b not in eager}
        assert runner._prog.seen == {("mixed", b, mb) for b in runner.buckets}
        if eager_from is not None:
            assert eager and eager[0] == 64 > runner.buckets[0]
    finally:
        runner.bind_graphs(graphs)
