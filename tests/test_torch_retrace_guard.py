"""The port's retrace guard, runner seal, pinned kernel pools and launch
census (the CUDA-graph plumbing that runs without a card).

- ``RetraceGuard`` scopes and ``guard_enabled`` with its environment
  override, against the reference's module.
- A sealed runner raises ``RetraceError`` at the first use of a new key,
  before anything runs; ``seal_suspended`` lifts and restores the seal; a
  warmed, sealed app's steady state records no trace.
- ``ops/_cuda`` pools pinned by a graph raise on growth, and a census
  recorded around a capture is added back once per replay.
"""

import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.analysis import retrace_guard as jguard
from neuronx_distributed_inference_tpu_torch.analysis import retrace_guard as tguard
from neuronx_distributed_inference_tpu_torch.config import Config
from neuronx_distributed_inference_tpu_torch.models.llama import LlamaInferenceConfig
from neuronx_distributed_inference_tpu_torch.ops import _cuda
from neuronx_distributed_inference_tpu_torch.runtime import graphs
from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM

HF = dict(
    model_type="llama", hidden_size=128, intermediate_size=256, num_attention_heads=2,
    num_key_value_heads=1, num_hidden_layers=1, vocab_size=64, rms_norm_eps=1e-5,
    rope_theta=10000.0, max_position_embeddings=256, hidden_act="silu", tie_word_embeddings=False,
)
TC = dict(
    batch_size=1, seq_len=128, dtype="float32", context_encoding_buckets=[16, 32],
    token_generation_buckets=[64, 128], device="cpu",
)


def _app(**tc):
    cfg = LlamaInferenceConfig(Config(**{**TC, **tc}), load_config=lambda c: [setattr(c, k, v) for k, v in HF.items()])
    torch.manual_seed(0)
    return ModelForCausalLM(None, cfg).load(random_weights=True)


# ---------------------------------------------------------------------------
# the guard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mod", [jguard, tguard], ids=["jax", "port"])
def test_guard_scopes_collect_and_raise(mod):
    with mod.RetraceGuard(fail=False) as outer:
        mod.note_trace("a")
        with pytest.raises(mod.RetraceError, match=r"1 (jit )?trace"):
            with mod.RetraceGuard():
                mod.note_trace("b")
        with mod.RetraceGuard(allowed=1) as tolerant:
            mod.note_trace("c")
    assert outer.traces == ["a", "b", "c"] and tolerant.traces == ["c"]
    with pytest.raises(mod.RetraceError):
        mod.note_trace("sealed", sealed=True)


@pytest.mark.parametrize("mod", [jguard, tguard], ids=["jax", "port"])
def test_guard_listeners_see_every_trace(mod):
    seen = []

    def listener(tag, sealed):
        seen.append((tag, sealed))

    mod.add_trace_listener(listener)
    try:
        mod.note_trace("x")
        with pytest.raises(mod.RetraceError):
            mod.note_trace("y", sealed=True)
    finally:
        mod.remove_trace_listener(listener)
    mod.note_trace("z")
    assert seen == [("x", False), ("y", True)]


@pytest.mark.parametrize("env", ["", "1", "true", "0"])
@pytest.mark.parametrize("field", [False, True])
def test_guard_enabled_by_config_or_env(monkeypatch, env, field):
    monkeypatch.setenv("NXDI_TPU_RETRACE_GUARD", env)
    cfg = Config(device="cpu", retrace_guard=field)
    want = field or env in ("1", "true")
    assert tguard.guard_enabled(cfg) is want
    assert jguard.guard_enabled(cfg) is want
    assert tguard.guard_enabled(None) is (env in ("1", "true"))


# ---------------------------------------------------------------------------
# the seal
# ---------------------------------------------------------------------------


def test_warmup_notes_every_key_and_steady_state_none():
    app = _app(retrace_guard=True)
    with tguard.RetraceGuard(fail=False) as g:
        app.warmup()
    # two context buckets; per decode bucket its step and its decode program
    assert g.traces.count("context_encoding_model") == 2
    assert g.traces.count("token_generation_model") == 4
    assert app.context_encoding_model.sealed and app.token_generation_model.sealed
    ids = np.arange(1, 21)[None, :]
    with tguard.RetraceGuard():
        for n in (4, 30):
            app.generate(ids, max_new_tokens=n)
        app.forward(ids[:, :1], np.array([[20]]), np.zeros(1, np.int32))


def test_sealed_runner_raises_on_a_new_key_before_running():
    app = _app(retrace_guard=True).warmup()
    tkg = app.token_generation_model
    before = app.kv_cache.k.clone()
    # a 3-token pass is a key warmup never ran
    with pytest.raises(tguard.RetraceError, match="token_generation_model"):
        app.forward(np.array([[1, 2, 3]]), np.array([[0, 1, 2]]), np.zeros(1, np.int32), phase="tkg")
    torch.testing.assert_close(app.kv_cache.k, before, rtol=0, atol=0)
    with tkg.seal_suspended():
        assert not tkg.sealed
        app.forward(np.array([[1, 2, 3]]), np.array([[0, 1, 2]]), np.zeros(1, np.int32), phase="tkg")
    assert tkg.sealed
    # built once, the key replays under the seal
    app.forward(np.array([[1, 2, 3]]), np.array([[0, 1, 2]]), np.zeros(1, np.int32), phase="tkg")
    with pytest.raises(RuntimeError, match="boom"):
        with tkg.seal_suspended():
            raise RuntimeError("boom")
    assert tkg.sealed


def test_unsealed_without_the_guard_and_for_windowed_configs(monkeypatch):
    monkeypatch.delenv("NXDI_TPU_RETRACE_GUARD", raising=False)
    app = _app().warmup()
    assert not app.token_generation_model.sealed
    # a windowed-prefill config builds smaller-width window programs at
    # first use: the reference leaves it unsealed
    windowed = _app(retrace_guard=True, max_context_length=32).warmup()
    assert not windowed.token_generation_model.sealed


def test_reload_drops_the_programs():
    app = _app(retrace_guard=True).warmup()
    app.load(params=app.params)
    # new params: no program is left to seal until warmup() runs again
    assert not app.context_encoding_model.sealed and not app.token_generation_model.sealed
    with tguard.RetraceGuard(fail=False) as g:
        app.generate(np.arange(1, 9)[None, :], max_new_tokens=2)
    assert "context_encoding_model" in g.traces


# ---------------------------------------------------------------------------
# pinned pools and the launch census
# ---------------------------------------------------------------------------


def test_pinned_pool_raises_on_growth():
    dev = torch.device("cpu")
    scope = ("test-scope", 1)
    key = (dev.index, scope)
    try:
        with _cuda.pool_scope(scope):
            a = _cuda.scratch(100, dev, 0)
            c = _cuda.counters(10, dev, 0)
            assert a.numel() == 100 and c.numel() == 1024 and int(c.sum()) == 0
        _cuda.pin_pools(key)
        with _cuda.pool_scope(scope):
            assert _cuda.scratch(64, dev, 0) is a  # within the pinned size
            with pytest.raises(_cuda.PoolPinnedError, match="pinned"):
                _cuda.scratch(101, dev, 0)
            with pytest.raises(_cuda.PoolPinnedError):
                _cuda.counters(2048, dev, 0)
        # an unscoped call on the same stream uses the stream's own pool
        assert _cuda.scratch(101, dev, 0) is not a
        _cuda.pin_pools(key)
        _cuda.release_pools(key)
        with _cuda.pool_scope(scope), pytest.raises(_cuda.PoolPinnedError):
            _cuda.scratch(101, dev, 0)  # still pinned once
    finally:
        _cuda.release_pools(key)
        _cuda._SCRATCH.pop((dev.index, 0), None)
    with _cuda.pool_scope(scope):
        assert _cuda.scratch(101, dev, 0).numel() == 101  # released: grows again
    _cuda.release_pools(key)
    assert key not in _cuda._SCRATCH and key not in _cuda._PINNED


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_census_is_taken_out_and_added_per_replay():
    _cuda.reset_launch_counts()
    _cuda.LAUNCHES["decode_attention"] += 2  # launches made before
    with _cuda.census() as rec:
        _cuda.LAUNCHES["decode_attention"] += 16
        _cuda.LAUNCHES["flash_attention"] += 0
        _cuda.ROUTES["int4_dense"] += 3
    assert rec == {"decode_attention": 16, "int4_dense": 3}
    assert _cuda.launch_counts()["decode_attention"] == 2 and _cuda.route_counts()["int4_dense"] == 0
    g = graphs.Graph(_FakeGraph(), outputs=None, census=rec, binding=("p", 1, 2))
    for _ in range(5):
        g.replay()
    assert g.graph.replays == 5
    assert _cuda.launch_counts()["decode_attention"] == 2 + 5 * 16
    assert _cuda.route_counts()["int4_dense"] == 15
    g.check_binding(("p", 1, 2), "t")
    with pytest.raises(RuntimeError, match="not the tensors this graph was captured with"):
        g.check_binding(("p", 1, 3), "t")
    _cuda.reset_launch_counts()


def test_graph_set_is_off_on_the_cpu_and_with_the_flag():
    app = _app()
    assert app.graphs is not None and not app.graphs.enabled
    assert not graphs.GraphSet(torch.device("cpu"), True).enabled
    for on in (True, False):
        assert Config(device="cpu", cuda_graphs=on).cuda_graphs is on
