"""The fused decode layer of the port (B8 and B9, ``ops/decode_block.py``)
end to end and its routing, on the CPU at fp32.

``generate()`` on a tiny head_dim-64 Llama with fused QKV and both flags
True (``fused_attn_block_kernel_enabled``, ``fused_mlp_kernel_enabled``)
must give tokens byte-identical to the JAX package's ``generate()`` with the
same flags (its Pallas kernels in interpret mode), logits within 1e-4, and
byte-identical to the port with both flags off, logits within 2e-4 (the
reference's own pin, tests/test_decode_block.py). The routing tests count
the calls of the two wrappers: every decode layer of a qualifying step goes
through both, and nothing else does (prefill, the paged and ragged serving
steps, quantized weights, an MoE layer's MLP, qk-norm for B8, flags left at
None or False)."""

import numpy as np
import pytest
import torch

from neuronx_distributed_inference_tpu.runtime.application import TpuModelForCausalLM
from neuronx_distributed_inference_tpu_torch.config import ChunkedPrefillConfig, Config, InferenceConfig, MoEConfig
from neuronx_distributed_inference_tpu_torch.models.builder import params_from_jax
from neuronx_distributed_inference_tpu_torch.modules.attention import AttnSpec
from neuronx_distributed_inference_tpu_torch.ops import _cuda, decode_attention, decode_block, kernel_mode
from neuronx_distributed_inference_tpu_torch.runtime.application import ModelForCausalLM
from neuronx_distributed_inference_tpu_torch.runtime.serving import ServingSession
from tests.conftest import make_random_hf_state_dict, make_tiny_config

HF = dict(
    model_type="llama", hidden_size=256, intermediate_size=512, num_attention_heads=4, num_key_value_heads=2,
    num_hidden_layers=2, vocab_size=128, rms_norm_eps=1e-5, rope_theta=10000.0, max_position_embeddings=1024,
    hidden_act="silu", tie_word_embeddings=False,
)
TC = dict(batch_size=2, seq_len=1024, dtype="float32", fused_qkv=True, token_generation_buckets=[512],
          output_logits=True)
FUSED = dict(fused_attn_block_kernel_enabled=True, fused_mlp_kernel_enabled=True)
OFF = dict(fused_attn_block_kernel_enabled=False, fused_mlp_kernel_enabled=False)
IDS = np.array([[1, 2, 3, 4, 5, 6, 7, 8], [9, 10, 11, 0, 0, 0, 0, 0]])
MASK = np.array([[1] * 8, [1, 1, 1, 0, 0, 0, 0, 0]])
N_NEW = 12


def _load(attrs):
    return lambda c: [setattr(c, k, v) for k, v in attrs.items()]


def _port_app(params=None, sd=None, attrs=HF, **tc):
    app = ModelForCausalLM(None, InferenceConfig(Config(**{**TC, **tc, "device": "cpu"}), load_config=_load(attrs)))
    return app.load(params=params) if params is not None else app.load(state_dict=sd)


class Calls:
    """Counts the calls of the fused wrappers and of B1's (the layer looks
    each up at call time)."""

    def __init__(self, monkeypatch):
        self.n = {"attn": 0, "mlp": 0, "b1": 0}
        for mod, name, key in ((decode_block, "fused_attn_block", "attn"), (decode_block, "fused_mlp_block", "mlp"),
                               (decode_attention, "tkg_decode_attention", "b1")):
            monkeypatch.setattr(mod, name, self._wrap(getattr(mod, name), key))

    def _wrap(self, fn, key):
        def counted(*args, **kw):
            self.n[key] += 1
            return fn(*args, **kw)

        return counted

    def take(self):
        out, self.n = self.n, {k: 0 for k in self.n}
        return out


@pytest.fixture(scope="module")
def apps():
    """The JAX app with both fused kernels forced (interpret mode) and the
    port on its params, flags on and off."""
    torch.set_num_threads(1)
    cfg = make_tiny_config(**{k: v for k, v in HF.items() if k != "model_type"}, tpu={**TC, **FUSED})
    sd = make_random_hf_state_dict(cfg, seed=0)
    jax_app = TpuModelForCausalLM(None, cfg).load(state_dict=sd)
    import jax

    params = params_from_jax(jax.device_get(jax_app.params), torch.float32, "cpu")
    return jax_app, _port_app(params=params, **FUSED), _port_app(params=params, **OFF), sd


def test_fused_generate_matches_jax_fused_kernels(apps, monkeypatch):
    jax_app, fused, _, _ = apps
    ref = jax_app.generate(IDS, MASK, max_new_tokens=N_NEW)
    calls = Calls(monkeypatch)
    _cuda.reset_launch_counts()
    out = fused.generate(IDS, MASK, max_new_tokens=N_NEW)
    np.testing.assert_array_equal(out.sequences, ref.sequences)
    np.testing.assert_allclose(out.logits, np.asarray(ref.logits), atol=1e-4, rtol=0)
    n = calls.take()
    assert n["attn"] == n["mlp"] > 0 and n["b1"] == 0
    # CPU tensors take the plain versions: nothing launches
    assert _cuda.launch_counts() == {name: 0 for name in _cuda.KERNELS}


def test_fused_generate_matches_unfused(apps, monkeypatch):
    """Every decode layer goes through both blocks exactly where the unfused
    run goes through B1."""
    _, fused, unfused, _ = apps
    calls = Calls(monkeypatch)
    ref = unfused.generate(IDS, MASK, max_new_tokens=N_NEW)
    n_off = calls.take()
    out = fused.generate(IDS, MASK, max_new_tokens=N_NEW)
    n_on = calls.take()
    np.testing.assert_array_equal(out.sequences, ref.sequences)
    np.testing.assert_allclose(out.logits, ref.logits, atol=2e-4, rtol=2e-4)
    assert n_off == {"attn": 0, "mlp": 0, "b1": n_off["b1"]} and n_off["b1"] > 0
    assert n_on == {"attn": n_off["b1"], "mlp": n_off["b1"], "b1": 0}


@pytest.mark.parametrize("flags", [{}, OFF, dict(fused_attn_block_kernel_enabled=None, fused_mlp_kernel_enabled=None)])
def test_none_and_false_mean_off(apps, monkeypatch, flags):
    """Left at None (the default) or False, no step takes a fused block."""
    *_, sd = apps
    calls = Calls(monkeypatch)
    _port_app(sd=sd, **flags).generate(IDS, MASK, max_new_tokens=4)
    n = calls.take()
    assert n["attn"] == n["mlp"] == 0 and n["b1"] > 0


def test_config_fields_map_onto_the_specs():
    """The reference's names, on Config, AttnSpec and ModelSpec."""
    cfg = InferenceConfig(Config(**{**TC, **FUSED, "device": "cpu"}), load_config=_load(HF))
    spec = ModelForCausalLM(None, cfg).spec
    assert spec.attn.use_fused_block is True and spec.use_fused_mlp is True
    spec = ModelForCausalLM(None, InferenceConfig(Config(**{**TC, "device": "cpu"}), load_config=_load(HF))).spec
    assert spec.attn.use_fused_block is None and spec.use_fused_mlp is None


BASE_SPEC = AttnSpec(num_heads=8, num_kv_heads=2, head_dim=64, use_fused_block=True)


@pytest.mark.parametrize(
    "change, q_len, want",
    [
        ({}, 1, True),
        ({}, 16, True),
        ({}, 17, False),  # more new tokens than the kernel takes
        (dict(qk_norm=True), 1, False),
        (dict(has_sink=True), 1, False),
        (dict(use_fused_block=None), 1, False),  # None means off, as in the reference
        (dict(use_fused_block=False), 1, False),
    ],
)
def test_use_fused_attn_block_gate(change, q_len, want):
    import dataclasses

    assert kernel_mode.use_fused_attn_block(dataclasses.replace(BASE_SPEC, **change), q_len) is want


def test_quantized_weights_take_the_unfused_layer(apps, monkeypatch):
    """int8 weights carry a scale: neither block streams them."""
    *_, sd = apps
    app = _port_app(sd=sd, quantized=True, **FUSED)
    calls = Calls(monkeypatch)
    app.generate(IDS, MASK, max_new_tokens=4)
    n = calls.take()
    assert n["attn"] == n["mlp"] == 0 and n["b1"] > 0


SERVING = dict(is_continuous_batching=True, batch_size=2, ctx_batch_size=1, seq_len=64, is_block_kv_layout=True,
               pa_block_size=16, pa_num_blocks=16, token_generation_buckets=None, output_logits=False)


@pytest.mark.parametrize("ragged", [False, True])
def test_paged_and_ragged_serving_keep_their_routes(apps, monkeypatch, ragged):
    """The paged split session and the ragged mixed step never take a fused
    block, and drain to the same tokens with the flags on and off."""
    *_, sd = apps
    extra = dict(serving_ragged=True, is_chunked_prefill=True,
                 chunked_prefill_config=ChunkedPrefillConfig(max_num_seqs=2, kernel_q_tile_size=16)) if ragged else {}
    calls = Calls(monkeypatch)
    outs = []
    for flags in (FUSED, OFF):
        sess = ServingSession(_port_app(sd=sd, **SERVING, **extra, **flags))
        for rid, prompt in (("a", [5, 17, 92, 41, 8]), ("b", list(range(30, 52)))):
            assert sess.add_request(rid, prompt, max_new_tokens=5)
        for _ in range(200):
            if not (sess.active or sess._readmit):
                break
            sess.step()
        outs.append({rid: list(r.generated) for rid, r in sess.requests.items()})
    assert outs[0] == outs[1] and all(len(v) == 5 for v in outs[0].values())
    n = calls.take()
    assert n["attn"] == n["mlp"] == 0


QWEN3 = dict(HF, model_type="qwen3", head_dim=64)


def test_qk_norm_model_takes_the_mlp_block_only(monkeypatch):
    """A dense Qwen3 (qk-norm keeps B8 off) still takes B9 after its
    unfused attention, and its tokens equal the flags-off run's."""
    torch.manual_seed(0)
    cfg_on = InferenceConfig(Config(**{**TC, **FUSED, "device": "cpu"}), load_config=_load(QWEN3))
    cfg_off = InferenceConfig(Config(**{**TC, **OFF, "device": "cpu"}), load_config=_load(QWEN3))
    on = ModelForCausalLM(None, cfg_on).load(random_weights=True)
    off = ModelForCausalLM(None, cfg_off).load(params=on.params)
    calls = Calls(monkeypatch)
    ref = off.generate(IDS, MASK, max_new_tokens=6)
    n_off = calls.take()
    out = on.generate(IDS, MASK, max_new_tokens=6)
    n_on = calls.take()
    np.testing.assert_array_equal(out.sequences, ref.sequences)
    np.testing.assert_allclose(out.logits, ref.logits, atol=2e-4, rtol=2e-4)
    assert n_on == {"attn": 0, "mlp": n_off["b1"], "b1": n_off["b1"]}


MIXTRAL = dict(
    model_type="mixtral", hidden_size=128, intermediate_size=96, num_attention_heads=2, num_key_value_heads=1,
    num_hidden_layers=2, vocab_size=128, rms_norm_eps=1e-5, rope_theta=10000.0, max_position_embeddings=1024,
    hidden_act="silu", tie_word_embeddings=False, num_local_experts=4, num_experts_per_tok=2, head_dim=64,
)


def test_moe_layers_keep_their_mlp_route(monkeypatch):
    """An MoE layer's MLP is never the fused MLP block: the MoE routes count
    the same with the flags on and off, and the tokens are the same."""
    torch.manual_seed(0)
    apps_, routes, outs = [], [], []
    for flags in (FUSED, OFF):
        cfg = InferenceConfig(MoEConfig(**{**TC, **flags, "device": "cpu"}), load_config=_load(MIXTRAL))
        app = ModelForCausalLM(None, cfg)
        apps_.append(app.load(params=apps_[0].params) if apps_ else app.load(random_weights=True))
    calls = Calls(monkeypatch)
    for app in apps_:
        _cuda.reset_launch_counts()
        outs.append(app.generate(IDS, MASK, max_new_tokens=6))
        routes.append(_cuda.route_counts())
    n = calls.take()
    np.testing.assert_array_equal(outs[0].sequences, outs[1].sequences)
    assert routes[0] == routes[1] and n["mlp"] == 0
