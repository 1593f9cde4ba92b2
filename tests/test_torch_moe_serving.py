"""Serving an MoE model through the port's ``ServingSession``, held against
the JAX package's on the CPU at fp32: a tiny Mixtral (E 8, top-2) and a
tiny Qwen3-MoE (E 32, top-2), 2 layers, head_dim 64, each built by
``transformers`` from a seed and loaded into both packages from one state
dict. Greedy tokens must be byte-identical on the split path (chunked
prefill on the paged cache, sync and 1-ahead decode), the ragged mixed
step (sync and 1-ahead), a CTE-admission split drain, a fault and
preemption mix, and one kv-int8 split drain.

Routes. The port chooses each MoE layer's route as the reference's
``moe_layer`` does; the test records every MoE call's (rows, tokens per
row) and derives the route independently: tokens per row >= 64 with
E >= 16 k -> grouped (counted in ``ROUTES["moe_grouped"]``); rows x
tokens x k <= 64 -> B7 (its wrapper's calls); the rest dense
(``ROUTES["moe_dense"]``). The ragged step's hidden state is the packed
(1, T, H), so its route follows the total-token bucket: Qwen3's steps of
64 packed tokens or more take the grouped route, and its runner runs
those buckets eagerly (``MixedStepRunner``'s eager rule, unit-tested with
a recording graph set). On CPU tensors B3, B4, B5 and B7 take their plain
versions."""

import pytest
import torch
import transformers

from neuronx_distributed_inference_tpu.config import ChunkedPrefillConfig as JaxChunked
from neuronx_distributed_inference_tpu.config import MoETpuConfig
from neuronx_distributed_inference_tpu.models.llama import LlamaInferenceConfig as JaxConfig
from neuronx_distributed_inference_tpu.runtime import faults as jfaults
from neuronx_distributed_inference_tpu.runtime.application import TpuModelForCausalLM
from neuronx_distributed_inference_tpu.runtime.serving import ServingSession as JaxSession
from neuronx_distributed_inference_tpu_torch.config import ChunkedPrefillConfig, InferenceConfig, MoEConfig
from neuronx_distributed_inference_tpu_torch.models import mixtral as tmixtral
from neuronx_distributed_inference_tpu_torch.modules import moe as tmoe
from neuronx_distributed_inference_tpu_torch.ops import _cuda
from neuronx_distributed_inference_tpu_torch.runtime import faults as tfaults
from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM
from neuronx_distributed_inference_tpu_torch.runtime.serving import ServingSession

COMMON = dict(
    vocab_size=128, hidden_size=128, num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
    rms_norm_eps=1e-5, max_position_embeddings=256, tie_word_embeddings=False, attn_implementation="eager",
    eos_token_id=None, bos_token_id=None,
)
MODELS = {
    "mixtral": (
        transformers.MixtralConfig, transformers.MixtralForCausalLM,
        dict(intermediate_size=96, num_local_experts=8, num_experts_per_tok=2, head_dim=64),
    ),
    "qwen3_moe": (
        transformers.Qwen3MoeConfig, transformers.Qwen3MoeForCausalLM,
        dict(intermediate_size=256, moe_intermediate_size=64, num_experts=32, num_experts_per_tok=2,
             norm_topk_prob=True, head_dim=64, decoder_sparse_step=1),
    ),
}
L = 2
BASE = dict(
    is_continuous_batching=True, batch_size=4, ctx_batch_size=1, seq_len=64, dtype="float32",
    is_block_kv_layout=True, pa_block_size=16, pa_num_blocks=24,
)
CHUNKED = dict(is_chunked_prefill=True, chunked=dict(max_num_seqs=2, kernel_q_tile_size=16))
MODES = {
    "split": {**CHUNKED, "async_mode": False},
    "split_async": {**CHUNKED, "async_mode": True},
    "split_cte": dict(context_encoding_buckets=[16, 64], async_mode=True),
    "ragged": {**CHUNKED, "serving_ragged": True},
    "ragged_sync": {**CHUNKED, "serving_ragged": True, "serving_ragged_async": False},
}
PROMPTS = {
    "r1": [5, 17, 92, 41, 8, 3, 77, 21, 60, 14, 2, 90],
    "r2": list(range(30, 52)),  # prefills across chunks
    "r3": [7, 7, 7],
    "r4": [64, 3, 27, 9, 11, 23, 5, 99, 100],
}


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


def _load(attrs):
    return lambda c: [setattr(c, k, v) for k, v in attrs.items()]


def _state_dict(name):
    torch.set_num_threads(1)
    cls, model_cls, extra = MODELS[name]
    torch.manual_seed(0)
    hf = model_cls(cls(**COMMON, **extra)).eval().float()
    return {k: v.detach().numpy() for k, v in hf.state_dict().items()}


def _kw(mode, **extra):
    kw = {**BASE, **MODES[mode], **extra}
    return kw, kw.pop("chunked", None)


@pytest.fixture(scope="module")
def apps():
    """(jax app, port app) per (model, mode, extra), built once per module
    and handed out with fresh caches."""
    sds, built = {}, {}

    def get(name, mode, **extra):
        key = (name, mode, tuple(sorted(extra.items())))
        if key not in built:
            if name not in sds:
                sds[name] = _state_dict(name)
            sd = sds[name]
            kw, chunked = _kw(mode, **extra)
            jkw, tkw = dict(kw), dict(kw)
            if chunked:
                jkw["chunked_prefill_config"] = JaxChunked(**chunked)
                tkw["chunked_prefill_config"] = ChunkedPrefillConfig(**chunked)
            load = _load(_attrs(name))
            built[key] = (
                TpuModelForCausalLM(None, JaxConfig(MoETpuConfig(**jkw), load_config=load)).load(state_dict=sd),
                ModelForCausalLM(None, InferenceConfig(MoEConfig(**tkw, device="cpu"), load_config=load)).load(
                    state_dict=sd
                ),
            )
        jax_app, port_app = built[key]
        jax_app.init_kv_cache()
        port_app.init_kv_cache()
        return jax_app, port_app

    return get


class _RouteRecorder:
    """Every MoE call's (rows, tokens per row), and B7's calls."""

    def __init__(self, monkeypatch, spec: tmoe.MoESpec):
        self.spec = spec
        self.calls = []
        self.b7 = 0
        orig_layer, orig_b7 = tmixtral.moe_layer, tmoe.fused_moe_decode

        def layer(params, hidden, mspec):
            self.calls.append(tuple(hidden.shape[:2]))
            return orig_layer(params, hidden, mspec)

        def b7(*a, **kw):
            self.b7 += 1
            return orig_b7(*a, **kw)

        monkeypatch.setattr(tmixtral, "moe_layer", layer)
        monkeypatch.setattr(tmoe, "fused_moe_decode", b7)
        _cuda.reset_launch_counts()

    def expected(self):
        """Route counts derived from the reference's rule."""
        s, out = self.spec, {"moe_grouped": 0, "moe_dense": 0, "b7": 0}
        for rows, per_row in self.calls:
            if per_row >= s.sparse_dispatch_threshold and s.num_experts >= 16 * s.top_k:
                out["moe_grouped"] += 1
            elif per_row < s.sparse_dispatch_threshold and rows * per_row * s.top_k <= 64:
                out["b7"] += 1
            else:
                out["moe_dense"] += 1
        return out

    def observed(self):
        counts = _cuda.route_counts()
        return {"moe_grouped": counts["moe_grouped"], "moe_dense": counts["moe_dense"], "b7": self.b7}


def _drive(sess, max_steps=400):
    for _ in range(max_steps):
        if not (sess.active or sess._readmit):
            break
        sess.step()
    else:
        raise AssertionError("session failed to drain")
    return {rid: list(r.generated) for rid, r in sess.requests.items()}


def _staggered(sess, n_tokens=6):
    """Staggered arrivals: a long prompt's chunks overlap live decode."""
    items = list(PROMPTS.items())
    for i, (rid, prompt) in enumerate(items):
        assert sess.add_request(rid, prompt, max_new_tokens=n_tokens + i % 2)
        sess.step()
    return _drive(sess)


def _both(apps, name, mode, run=_staggered, jax_kw=None, port_kw=None, **extra):
    jax_app, port_app = apps(name, mode, **extra)
    js = JaxSession(jax_app, **(jax_kw or {}))
    ts = ServingSession(port_app, **(port_kw or {}))
    return run(js), run(ts), js, ts


def _statuses(sess):
    return {rid: (r.status, r.fail_reason, r.preemptions) for rid, r in sess.requests.items()}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", sorted(MODELS))
def test_moe_drain_matches_jax(apps, monkeypatch, name, mode):
    rec = _RouteRecorder(monkeypatch, apps(name, mode)[1].builder.moe_spec())
    j, t, js, ts = _both(apps, name, mode)
    assert t == j
    assert all(len(v) >= 6 for v in t.values())
    assert _statuses(ts) == _statuses(js)
    assert rec.calls and rec.observed() == rec.expected()
    obs = rec.observed()
    if mode.startswith("ragged"):
        assert set(ts.dispatches) == {"mixed_step"}
        # every packed step holds at least one 16-slot q tile
        assert min(T for _, T in rec.calls) >= 16
        if name == "qwen3_moe":
            assert obs["moe_grouped"] > 0 and obs["b7"] > 0
        else:
            assert obs["moe_grouped"] == 0
    else:
        assert obs["b7"] >= L * ts.dispatches["decode_steps"]
        if name == "qwen3_moe" and mode == "split_cte":
            assert obs["moe_grouped"] > 0  # the 64-token context bucket
        if name == "mixtral":
            assert obs["moe_grouped"] == 0  # E 8 < 16 k: never grouped


@pytest.mark.parametrize("mode", ["split", "ragged", "ragged_sync"])
def test_moe_pool_exhaustion_and_preemption_match_jax(apps, mode):
    golden, _, _, _ = _both(apps, "qwen3_moe", mode)
    j, t, js, ts = _both(
        apps, "qwen3_moe", mode,
        jax_kw=dict(fault_injector=jfaults.FaultInjector().exhaust_pool(3, 5)),
        port_kw=dict(fault_injector=tfaults.FaultInjector().exhaust_pool(3, 5)),
    )
    assert t == j == golden
    assert _statuses(ts) == _statuses(js)
    assert any(r.preemptions for r in ts.requests.values())


@pytest.mark.parametrize("mode", ["split", "ragged"])
def test_moe_nan_row_quarantine_matches_jax(apps, mode):
    j, t, js, ts = _both(
        apps, "mixtral", mode,
        jax_kw=dict(fault_injector=jfaults.FaultInjector(seed=0).poison_kv_row(step=5, slot=1)),
        port_kw=dict(fault_injector=tfaults.FaultInjector(seed=0).poison_kv_row(step=5, slot=1)),
    )
    assert t == j
    assert _statuses(ts) == _statuses(js)
    assert any(r.fail_reason == "non_finite" for r in ts.requests.values())


def test_moe_kv_int8_split_drain_matches_jax(apps):
    j, t, _, ts = _both(apps, "qwen3_moe", "split_async", kv_cache_dtype="int8")
    assert t == j
    assert ts.app.kv_cache.k.data.dtype == torch.int8 and ts.app.kv_cache.k.scale.abs().sum() > 0


class _RecordingGraphs:
    """A graph set that records what the runner asks of it: eager runs and
    captures (nothing is captured for real)."""

    enabled = True

    def __init__(self):
        self.eager_runs, self.captures = [], []

    def scope(self, *key):
        return key

    def eager(self, scope, fn):
        self.eager_runs.append(scope[1])
        return fn()

    def capture(self, scope, fn, bind, generator=None):
        self.captures.append(scope[1])
        out = fn()

        class _G:
            outputs = out

            def check_binding(self, bind, tag):
                pass

            def replay(self):
                pass

        return _G()


@pytest.mark.parametrize("name, eager_from", [("qwen3_moe", 64), ("mixtral", None)])
def test_mixed_step_eager_rule_by_packed_tokens(apps, name, eager_from):
    """The ragged runner captures buckets below the builder's
    ``host_read_tokens`` and runs the rest eagerly on every call; every key
    is still recorded (the seal sees it)."""
    _, app = apps(name, "ragged")
    runner = app.mixed_step_model
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
        assert gs.eager_runs == [("mixed", b, mb) for b in runner.buckets if b not in eager]
        assert set(runner._prog.captured) == {("mixed", b, mb) for b in runner.buckets if b not in eager}
        assert runner._prog.seen == {("mixed", b, mb) for b in runner.buckets}
        runner.seal()
        runner(app.params, app.kv_cache, runner.example_inputs(runner.buckets[-1]))  # no new key
        if eager:
            assert eager[0] >= 64 > runner.buckets[0]
    finally:
        runner.bind_graphs(graphs)
